"""Model stacks for the port (dense decoder LM)."""

"""Model blocks for the port: primitive layers, GQA attention, dense MLP."""

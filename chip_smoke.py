#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port in phases; each prints its own lines and any failure exits
non-zero (no phase catches its own failure):

  1. device   the card's name, count, torch / CUDA versions and power limit;
              TF32 off, so the float32 plain versions are true float32;
              ``repro_torch.backend.describe()`` (the feature probes, the
              card's capability, SMs and shared memory, nvcc's version).
  2. build    builds the kernels from ``src/repro_torch/kernels/csrc``;
              prints each kernel's registers / spills and the SASS count of
              HGMMA (wgmma), UTMALDG (TMA loads), UBLKCP (1-D bulk copies)
              and LDGSTS (cp.async) per kernel, and fails if the bf16
              kernel of a wrapper with a wgmma route (ag_gemm, gemm_rs,
              matmul, grouped_matmul, flash_attention) has no HGMMA or no
              UTMALDG, or spills registers, or if the SSD intra-chunk
              kernel spills or has no UBLKCP (its bulk staging path); and
              holds the fused kernels (``ag_gemm*`` / ``gemm_rs*``, both
              routes), whose flag sites call the tile primitives of
              ``tile_sync.cuh``, to the registers, spills and HGMMA /
              UTMALDG counts they were built with before (FUSED_BUILD).
  3. serve    smollm-360m at its published size with seeded weights: the
              float32 prefill through the fused kernels against the eager
              executor with plain attention; one dense layer in bfloat16 on
              the fused path against the same layer in float32 on the eager
              path from the same bf16 weights; then the main path in
              bfloat16 (prefill + greedy decode), with the kernels' launch
              counts, and its prefill logits against the float32 eager
              prefill (max|diff|, top-1 agreement: printed, not held).
  4. seam     smollm-360m's forward with fused RS -> AG seams
              (``ParallelContext(fuse_seams=True)``: each attention output
              projection's reduce-scatter hands its home segments to the
              MLP gate/up all-gather over one ring pass, on the eager
              executor; the chain's ends stay on the kernels) at its
              published size, 4 x 256 tokens: (a) float32 eager, the
              logits bitwise equal to the unfused forward's, 32 seams
              fused; (b) float32 on the fused backend (the seams eager, the
              rest on the kernels) against the unfused forward, the logits'
              bound; (c) bf16 on the fused backend: one layer with its seam
              against the unfused layer, 2e-2 of max |f32 layer| (output
              less input), and the whole forward's max|diff| and top-1
              agreement printed beside the unfused bf16 forward's against
              f32 (not held: 32 random layers carry a rounding flip to the
              size of bf16 noise); (d) the counted bf16 forward, launches
              held exactly, and both forwards' ms.
  5. moe      granite-moe-3b-a800m at its published size with seeded
              weights: (a) one MoE layer, fused against eager in float32;
              (b) the float32 prefill, fused against eager (routing flips
              between the two are counted, and the logits are then held on
              the batch rows whose routing agreed in every layer); (c) the
              main path in bfloat16 through ``serve.greedy``, with its
              launch counts held exactly.
  6. deepseek deepseek-moe-16b at its published width with seeded weights
              (a dense first layer, then MoE layers of 64 experts top-6 with
              2 shared experts): (a) one MoE layer with its shared MLP,
              fused against eager in float32 (routing identical, launches
              held); (b) the float32 prefill at DS_F32_LAYERS = 4 layers
              (the dense one + 3 MoE: float32 weights of all 28 would take
              ~66 GB), fused against eager, held before each row's first
              routing flip as in (5b); (c) at those 4 layers, one float32
              decode step with ``moe_decode_stream`` against the gathered
              decode; (d) the main path in bfloat16 at CUT["deepseek"]'s 9
              layers (the dense one + 8 MoE) through ``serve.greedy`` with
              the streamed decode, launch counts held exactly; (e) the
              engine at those 9, streamed decode in its graphs (8 requests, prompts 32-256, 16-32 new tokens, 2
              sampled, on 4 slots), held as in (9a, b).
  7. ep       deepseek-moe-16b's prefill with ``ep_axis="model"`` (the
              expert-parallel dispatch / combine all-to-all, each landed
              tile's expert GEMMs on the grouped kernel): (a) one MoE
              layer's a2a pair in float32 against ``a2a_moe_baseline`` on
              the same routing, the kept (token, k) sets equal and the
              outputs within 1e-4 of max; (b) the float32 EP prefill at
              DS_F32_LAYERS layers against the TP-MoE prefill, held before
              each row's first routing flip as in (5b); (c) the main path in
              bfloat16 at CUT["deepseek"]'s 9 layers through ``serve.greedy`` (EP prefill,
              streamed decode), launch counts held exactly (2 x W grouped
              launches per MoE layer), the EP and TP-MoE prefill ms, and one
              layer's a2a pair against its baseline in bf16 (2e-2 of max)
              with both times.
  8. ssm      mamba2-2.7b at its published size with seeded weights:
              (a) one Mamba layer, fused against eager in float32, and in
              bfloat16 fused against float32 eager from the same bf16
              weights; (b) the float32 prefill, fused against eager, every
              position's logits; (c) the main path in bfloat16 through
              ``serve.greedy``, with its launch counts held exactly.
  9. engine   the continuous-batching engine (``serving.ServeEngine``, its
              step captured in two CUDA graphs) at published widths, W = 4,
              bf16, each model cut to CUT["engine"]'s depth (smollm-360m 4
              of its 32 layers, mamba2-2.7b 8 of 64): smollm-360m with 16
              seeded requests (prompts 32-256,
              16-64 new tokens, 4 of them at temperature 0.8 / top-k 40) on
              8 slots, then mamba2-2.7b with 8 requests (prompts 16-64, 16
              new tokens, 2 sampled) on 4 slots, so slots are reused and
              reset.  Holds (a) the captured engine's tokens bitwise equal
              to the same engine with capture off, (b) host syncs == steps
              and 2 graph captures, (c) in float32, four greedy requests
              against per-token reference decoding (``lm.decode_step`` one
              token at a time, teacher-forced with the engine's tokens): a
              token may differ from the reference's argmax only where the
              two logits lie within 1e-3, and each such token is printed.
              Prints tokens/s, steps, ms per step, the LM-head launches per
              step and one decode iteration's time, captured and eager.
  10. ring    the sequence-parallel attention layer (``nn/attention.
              apply_seq_ring``, paper Fig. 6: AG-Q through the AG+GEMM
              kernel, K / V projected locally and rotated over the ring with
              flash attention consuming each tile, GEMM+RS out) at the full
              width of smollm-360m (head dim 64, GQA padded to 8 KV heads,
              the per-KV-group ring) and deepseek-moe-16b (16 / 16 heads of
              128), W = 4, seeded weights: (a) float32, fused against eager
              and against ``apply_seq``, 1e-4 of max; (b) bfloat16 fused
              against float32 eager on the same weights, 2e-2 of max;
              (c) the bf16 layer's counted run (4 x 256 tokens) with its
              launches held exactly (steps x channels flash launches per
              call), and the bf16 times of ``apply_seq_ring`` and
              ``apply_seq`` at 4 x 256 and 1 x 8192 tokens (recorded).
  11. train   smollm-360m trained at its published width, W = 4, 8 x 256
              tokens a step (``launch/train.py``: the fused kernels in both
              passes, each AG+GEMM's transpose a GEMM+RS and back):
              (a) float32, one step on the fused backend against the eager
              one from the same weights: the loss held as the prefill
              logits, every leaf's gradient to GRAD_RTOL of its max|eager|,
              every leaf's update (new - p) to UPDATE_RTOL of its
              max|eager update| where the gradient check fixes the
              gradient's sign, each leaf moved by at least lr / 2 (at full
              depth); (b) bf16, TRAIN_STEPS steps of ``train`` on
              ``SyntheticLM`` at CUT["train"]'s 8 layers: the mean ce
              of the last 5 steps more than 0.2 below the first 5's (the
              JAX package's loss test), every step's launches held exactly
              (32 AG+GEMM, 32 GEMM+RS, 8 flash, 1 LM head), the median
              step time (CUDA events), tokens/s and peak memory; with
              ``--profile`` one step's device time by kernel; (c) a
              checkpoint at step TRAIN_CKPT_AT at TRAIN_CKPT_LAYERS layers,
              resumed: the next step's loss and the parameters after it
              bitwise the uninterrupted run's.
  11b. train_seam  smollm-360m trained with fused RS -> AG seams
              (``ParallelContext(fuse_seams=True)`` through
              ``make_train_step``: each layer's seam eager, the chain's
              ends, qkv AG+GEMM and down GEMM+RS, on the kernels, each
              one's backward the other kernel), W = 4, 8 x 256 tokens:
              (a) bf16 at full depth and width, SEAM_TRAIN_STEPS AdamW
              steps seamed and unfused in turns, each on its own seeded
              state: every step's launches held exactly
              (``paper_e2e.expected_launches(..., fuse_seams=True)``: 64
              AG+GEMM, 64 GEMM+RS, 32 flash, 1 head seamed; 128 / 128 / 32
              / 1 unfused), both step times (CUDA events), losses and peak
              memory; (b) one float32 step at SEAM_F32_LAYERS layers on the
              fused backend against the eager backend, both seamed: the loss
              the logits' bound, every leaf's gradient GRAD_RTOL of its
              max|eager|, the launches held; (c) the same seamed step
              against the unfused one, the same bounds; (d) one bf16 step
              with seams under remat "dots" (each scan unit's chain
              recomputed), launches held (96 / 96 / 64 / 1); the phase's
              wall time.
  11c. examples  ``repro_torch.examples.quickstart`` (overlapped, non-
              overlapped and fused-kernel AG+GEMM at S 1024, H 512, FF
              1408, W 8, C 2, float32: outputs within 1e-3, one kernel
              launch, the ring's permutes against the baseline's gather in
              the World's counter) and ``moe_overlap_demo`` (the AG + MoE
              double ring on the grouped kernel against the dense oracle,
              E 16, top-2, 512 tokens: 1e-4, 16 grouped launches) on the
              card.
  11d. dp     ZeRO-3 data-parallel training over the data axes (run
              after train_seam): DP_REPLICAS replica processes of the W = 4
              model group on the one card (``launch/train.train(data=)``:
              spawned, joined by a gloo ``DistWorld``, the collectives'
              staging the ``GLOO_CUDA_STAGING`` table, each printed with the
              bytes it staged through host memory), each storing only its
              block of every parameter and moment the data axes split and
              gathering each layer at its use (``use_gather``).
              smollm-360m at CUT["dp"]'s 8 of its 32 layers, full width, bf16,
              a global batch of TRAIN_BATCH x TRAIN_SEQ (TRAIN_BATCH / DP_REPLICAS rows a
              replica): a DP_D1_STEPS-step run at D = 1, then DP_STEPS
              AdamW steps at D = 2 at remat "none" and DP_REMAT_STEPS at
              remat DP_REMAT, on the same batches.  (a) every step's
              launches per replica held to ``paper_e2e.expected_launches``
              at that depth (32 / 32 / 8 / 1 at "none"; under DP_REMAT each
              layer's forward twice: 48 / 48 / 16 / 1); (b) the
              ce's fall over the DP_STEPS steps held as the train phase
              holds it; (c) every bf16 step's payload on the data transport
              against ``launch/roofline.data_axis_bytes`` of the leaves the
              step gathers at the uses it makes (``launch/dryrun.data_leaves``:
              once a pass, a remat'd layer's again in the backward),
              all-gather, reduce-scatter and all-reduce each exactly; (d)
              each process's device memory after placing its parameter and
              moment blocks (the bytes its tensors requested, held;
              ``memory_allocated``, which rounds each allocator block up,
              printed) against ``launch/dryrun``'s
              arguments of one replica's model group on the (data
              DP_REPLICAS, model 4) mesh, within CAL_ARG_RTOL; (e) step ms
              (CUDA events, median after TRAIN_WARMUP) at D = 2 at both
              remats and at D = 1, the data transport's ms
              (``train(time_data=True)``: the device drained around each
              collective, in the D = 2 runs only) and each process's peak
              memory at both remats recorded; (f) float32 at DP_F32_LAYERS
              layers, full width, at both remats: the D = 2 step's loss (the
              logits' bound), each gradient (the replicas' blocks joined,
              GRAD_RTOL of the leaf's max) and each update (UPDATE_RTOL, as
              the train phase holds them) against the D = 1 step on the same
              global batch; (g) ``psum_compressed`` over the data group:
              |new_err| <= scale / 2 elementwise, its mean against an exact
              float32 all-reduce within what int8 codes at the largest
              replica's scale allow, sum_r (127 (s_max - s_r) + s_r / 2) /
              D; and a ring permute over the group (the collective the
              table stages through host memory) delivers the peer's tensor
              bitwise.
  11e. serve_dp  data-parallel serving, in the dp phase's spawn: each
              replica builds the serve CLI's context and parameters
              (``launch/serve.serve_context`` / ``serve_params``:
              ``make_dev_mesh(4, DP_REPLICAS)``, this replica's blocks,
              each layer gathered at its use) for smollm-360m at CUT["dp"]'s
              8 layers, full width.  (a) bf16: ``ServeEngine`` on SERVE_DP's seeded
              requests (8, prompts 64, 16 new tokens, 2 sampled at
              temperature 0.8 / top-k 40) on 8 slots (4 a replica), decode
              block 16, eager (no capture under data): tokens/s and ms per
              step, host syncs per step (1) and graph captures (0) held,
              launches per replica per ``lm.decode_step`` call held to the
              D = 1 eager engine's on 4 slots, the data transport's bytes
              over the drain held to ``launch/roofline.data_axis_bytes`` of
              one ``decode_step``'s gathers times the calls plus the
              token-buffer all-gathers, each replica's placed blocks
              (requested bytes) within CAL_ARG_RTOL of ``launch/dryrun``'s
              parameter arguments of one replica, and peak memory per
              process; (b) float32 at SERVE_DP_F32_LAYERS layers, full
              width: the same requests at D = 2 against the D = 1 engine,
              every sampled request equal token for token and a greedy one
              only where the per-token reference shows a near tie
              (NEAR_TIE); (c) ``serve.greedy`` at D = 2 on the serve
              phase's 4 x 256 prompts (2 rows a replica): launches per
              replica held (16 / 16 / 8 / 1 + 15 decode heads), and the
              float32 prefill logits at SERVE_DP_F32_LAYERS layers within
              the serve phase's bound of D = 1's on the same rows.
  12. train_moe  granite-moe-3b-a800m and deepseek-moe-16b trained at their
              published widths, W = 4, 8 x 256 tokens a step (the grouped
              expert GEMM in the forward and, on the transposed weights, for
              dx): (a) one MoE layer of each (deepseek's with its shared
              experts) in float32 on the TP double ring and on the EP a2a
              pair, the fused backend's dx and every leaf's gradient (router,
              w_gu, w_down, norm, shared MLP) against the eager backend's to
              GRAD_RTOL of the leaf's max|eager|, the routing bitwise equal,
              4 x W grouped launches; (b) one float32 step of granite at
              TRAIN_MOE_F32_LAYERS = 4 layers, fused against eager: the loss
              the logits' bound, every router call's expert sets recorded,
              at most TRAIN_MOE_MAX_FLIPS tokens a layer routed apart, the
              gradients held to GRAD_RTOL when no call differs (else the
              flips and the worst error printed); (c) TRAIN_STEPS bf16 steps
              of granite at CUT["train"]'s 4 of its 32 layers through
              ``train``: the ce fall, every step's launches held exactly (64
              grouped, 8 AG+GEMM, 8 GEMM+RS, 4 flash, 1 head), the median step ms, tokens/s, peak
              memory, and the resume bitwise at 2 layers as in (11c); deepseek
              TRAIN_MOE_DS_STEPS bf16 steps at CUT["train"]'s 4 layers (the
              dense one + 3 MoE), launches held.
  13. train_ssm  mamba2-2.7b trained at its published width, W = 4, 8 x 256
              tokens a step, remat policy SSM_REMAT ("dots": each layer's
              forward recomputed in the backward, as the JAX package's
              trainer): (a) one float32 step at SSM_F32_LAYERS layers, fused
              against eager: the loss the logits' bound, every leaf's
              gradient (the Mamba leaves: w_in, w_bc, conv, dt_bias, a_log,
              d_skip, w_out, ln) GRAD_RTOL of its max|eager|, the launches
              held; (b) TRAIN_STEPS bf16 steps at CUT["train"]'s 8 of its 64
              layers through ``train`` at lr SSM_LR (3e-3, the JAX package's
              loss test's): the ce fall, every step's launches held exactly
              (24 AG+GEMM, 24 GEMM+RS, 16 SSD intra-chunk, 1 head: each
              layer's forward twice), the median step ms, tokens/s, peak
              memory (held below the card's); with ``--profile`` one step's
              device time by kernel; (c) the resume bitwise at
              SSM_CKPT_LAYERS layers as in (11c).
  14. zamba2  zamba2-2.7b (54 layers: Mamba-2 mixers and one shared
              attention block of head dim 80 every 6 layers, each with its
              own GELU MLP) at its published width, cut to CUT["zamba2"]'s
              6 layers (one period, the shared block once): (a) one shared
              block in float32, fused against eager, 1e-4 of max; (b) the
              float32 prefill, fused against eager, the logits' bound;
              (c) the bf16 main path through ``serve.greedy`` (4 x 256 + 16
              greedy), launches held exactly (7 AG+GEMM, 7 GEMM+RS, 5 SSD,
              1 flash, 16 head), one bf16 Mamba layer against f32 eager;
              (d) the engine (8 requests on 4 slots, 2 sampled) held as in
              (9a, b); (e) the train_ssm phase's checks (the f32 step at 12
              layers, two uses of the shared mixer; 30 bf16 steps at
              CUT["train"]'s 6; the resume at 6).
  15. encdec  seamless-m4t-medium (12 + 12 layers, d 1024, 16 / 16 heads of
              64, ReLU MLP of 4096, vocab 256206; stub frames) at its
              published width, cut to CUT["encdec"]'s 6 + 6 layers, W = 4,
              seeded weights: (a) bf16 serve: encode 4 requests of 4096
              frames, build the cross caches, 16 greedy ``decode_step``s:
              the encoder, cross-cache and per-step ms, tokens/s, launches
              held exactly (18 AG+GEMM: the encoder's qkv and gate|up and
              each decoder layer's kv gather of the encoder stream; 12
              GEMM+RS, 6 flash, 16 head); (b) float32 on the
              same weights: the forward fused against eager (the logits'
              bound) and the cross-cache decode's logits against the
              teacher-forced forward's (3e-3, the JAX package's test);
              (c) the bf16 fused forward within 2e-2 of max |f32 eager|;
              (d) one f32 step at 2 + 2 layers fused against eager (the
              loss, each leaf's gradient GRAD_RTOL against an eager pass
              whose ReLUs take the fused pass's signs, launches held; each
              flipped sign within RELU_FLIP_REL of zero on both passes, at
              most RELU_MAX_FLIP_SHARE of a call's elements flipped; the
              unforced pass's error printed), at
              ENCDEC_F32_SEEDS weight and data seeds, 30 bf16
              AdamW steps at 6 + 6 layers through ``make_train_step`` (8 x
              256 decoder tokens with 8 x 512 frames, the JAX package's
              input rule): the ce fall, 66 / 66 / 18 / 1 launches every
              step, the median step ms, tokens/s, peak memory; the resume
              bitwise at 2 + 2 layers.
  16. vlm     paligemma-3b (18 layers, d 2048, 8 heads of 256 with one KV
              head, GELU MLP of 16384, tied embeddings scaled by
              sqrt(d_model) over the image prefix too) at its published
              width, cut to CUT["vlm"]'s 6 layers: (a) the float32 prefill
              of 256 stub patches + 256 tokens, fused against eager; (b) the
              bf16 main path through ``serve.greedy(embeds=)``, launches held
              (12 / 12 / 6 flash at head dim 256 / 16 head), one bf16 layer
              against f32 eager; (c) one f32 step at 4 layers (4 x 512
              tokens) fused against eager, the kv-copy sync at rep 4 leaving
              the copies bitwise equal; 30 bf16 steps of 8 x (256 patches +
              256 tokens), labels over the whole sequence: the ce fall, 24 /
              24 / 6 / 1 launches every step, step ms, peak memory; the
              resume bitwise at 2 layers.
  17. e2e     the paper's end-to-end figure (Fig. 11,
              ``benchmarks/paper_e2e.py``) and the three dense configs
              qwen2-72b (QKV bias), starcoder2-7b (GELU, 36 / 4 heads) and
              gemma3-27b (5:1 local / global attention, tied embeddings
              scaled by sqrt(d_model)) at their published widths, W = 4:
              (a) per row (smollm-360m at 8 of its 32 layers, qwen2-72b 2,
              starcoder2-7b 4, gemma3-27b 6, granite-moe-3b-a800m 8 of 32,
              deepseek-moe-16b 4: ``paper_e2e.DEPTH``, smollm's, starcoder2's,
              granite's and deepseek's cut further by CUT["e2e"]), one bf16 AdamW train step of
              1 x 4096 tokens in ``mode="baseline"`` (gather then GEMM, GEMM
              then reduce-scatter, on tensor cores) and in ``mode="overlap"``
              (the fused kernels in both passes), 3 warm-up steps each then
              5 pairs in turns: each mode's median step ms, the speedup,
              tokens/s, peak memory (held below the card's); (b) every step's
              launches held exactly (``paper_e2e.expected_launches``: a dense
              row's overlap 1 LM head, 4L AG+GEMM, 4L GEMM+RS, L flash; a
              MoE layer's 4 x W grouped GEMMs and its attention's 2 + 2;
              baseline: 1, 0, 0, L, no grouped); (c) both modes'
              first-step loss on the same weights, the logits' bound; (d) in
              float32 at E2E_F32_LAYERS = 2 layers and 1 x 2048 tokens, one
              step fused against eager for qwen2-72b (its bias seeded
              non-zero) and gemma3-27b (window and scale): the loss held as
              the prefill logits, every leaf's gradient to GRAD_RTOL of its
              max|eager|; (e) gemma3-27b at its 6 layers in bf16 through
              ``serve.greedy``, 4 x 2048 prompt tokens past its 1024 window
              + 16 greedy: the local layers' ring caches wrap, launches held
              exactly, two runs' tokens equal; with ``--profile`` one train
              step of gemma3-27b and of granite-moe-3b-a800m in each mode,
              device time by kernel.
  18. paper   the paper's TP-MLP (``benchmarks/paper_mlp.py``) at W = 8 in
              bf16: Fig. 8 at MLP-1 and MLP-6 and Tab. 2 (LLaMA-7B), the
              fused kernels against the tensor-core baselines (held to 2e-2
              of max |baseline|), each row's ms, speedup, comm-only ms and
              bound; and the paper's TP-MoE (``benchmarks/paper_moe.py``),
              Fig. 9 at MoE-1 and MoE-6, ``ag_moe`` on the grouped kernel
              against ``ag_moe_baseline`` on tensor-core GEMMs, the same
              way, with peak memory, row tile and grouped launches; and the
              paper's sequence-parallel attention
              (``benchmarks/paper_attn.py``), Fig. 10 at Attn-1 (32 heads of
              128) with S 16k and 32k, the fused ring against all-gather
              then the same flash kernel, with comm-only, comp-only, the
              overlap ratio and SDPA.  Its ranks share one card, so the
              numbers are not the paper's multi-GPU speedups.
  19. quant   quantized wires and weight-only int8 / int4 (``core/quant``),
              W = 4 unless said: (a) the smollm-360m MLP's 32 TP blocks
              (``nn/ffn.apply_seq``, d 960, f 2560) on the fused backend,
              chained over a 4 x 256 bf16 stream, with int8 PackedWeight
              ``w_gu`` / ``w_down`` (``pack_weight``: the kernels dequantize
              them inside), against the same blocks on the same codes
              dequantized into bf16 weights: block 0 at 2e-2 of max |ref|,
              the 32 blocks' max|diff| recorded (the dequantized weights
              round q x scale to bf16, which 32 random blocks carry to a
              few % of the stream); and with each scale rounded to a power
              of two (q x scale exact in bf16), the packed chain bitwise
              equal to the dequantized chain, exactly 32 AG+GEMM and 32
              GEMM+RS launches, all packed, both chains' ms; (b) smollm-360m's whole bf16 ``lm.prefill``
              (32 layers, 4 x 256) on the eager executor with an int8 and an
              fp8 (e4m3) per-tile wire (``ParallelContext(quant=)``) against
              the identity wire: the logits' relative error and top-1
              agreement recorded; one layer's qkv ``ag_matmul`` and o-proj
              ``matmul_rs`` held at the JAX package's rel < 0.05; the
              float32 wire's logits bitwise the identity's; an int8 wire on
              the fused backend raises NotImplementedError; (c)
              ``training/compression.psum_compressed`` on one smollm
              gradient leaf (layer 0's ``w_down``), each rank held to the
              error-feedback contract (g + err = deq(q) + new_err, |new_err|
              <= scale / 2); (d) the packed and wire kernel cases: AG+GEMM
              and GEMM+RS with int8 (symmetric) and int4 (zero point) packed
              weights, and GEMM+RS with a bf16 wire under float32
              accumulation, at smollm's gate|up / down (both routes: f32
              1e-4, bf16 2e-2 of max |plain| and bitwise over 20 launches)
              and at Tab. 2's MLP-1 (LLaMA-7B, 8192 tokens, W = 8; bf16,
              the plain version timed by its one checking call), each with
              its bound (the weight at one byte an element) and the library
              call (``torch.matmul`` on the dequantized bf16 weight, plus
              the sum over ranks for GEMM+RS).
  19b. tune   the autotuner (``repro_torch.tune``) on the fused kernels,
              bf16: for smollm-360m's four TP GEMMs at prefill (4 x 256
              tokens: qkv, attention out, gate|up, down) and at decode (B =
              4 slots, ``signature(..., decode=True)``) and for Tab. 2's
              MLP-1 pair (LLaMA-7B, W = 8), every candidate of the JOINT
              space (what the bf16 route honours: order x C, and C x accum
              dtype for GEMM+RS) launched, its output held against the f32
              product (2e-2 of max), and timed with CUDA events (median and
              iqr of 10 launches after 2 warm-up launches); the measured
              winner, the cost model's pick and its measured rank, the
              default channel's time and the tuner's own pruned sweep, each
              table with the card's name and power limit; a cache hit and a
              resolution inside a CUDA graph capture launch nothing; the
              main path, smollm-360m's bf16 prefill under
              ``ParallelContext(tune=True)`` with the cache warm, launches
              exactly the untuned counts (logits against the untuned
              prefill recorded); and a tuned engine at smollm's width (2
              layers) resolves its decode winners before the capture, its
              captured tokens held bitwise to its eager tokens.  The build
              phase also prints the register spills of the fused kernels'
              float32 route (``ag_gemm_kernel`` / ``gemm_rs_kernel``), which
              the tuner's FMA candidates run: recorded, not failed on.
  19c. dryrun the dry-run planner (``repro_torch.launch.dryrun``) held to the
              card: (a) every (arch x shape) cell of ``SHAPES`` planned on
              the production mesh (data 32, model 8: 256 H100s) with the
              costs extrapolated from 1 and 2 scan units, and on the
              multi-pod mesh (pod 2: 512) for memory only, on ``meta`` in
              half the host's cores' processes (at most DRYRUN_JOBS), started
              in the background before the first phase (it needs no card)
              and collected here; the report table printed; every cell
              ``cell_is_applicable`` accepts must be ``ok``, every other
              ``skipped`` with its reason; the phase's host seconds.  (b)
              calibration on the card's own mesh (``make_dev_mesh``: dp 1,
              model 4) for smollm-360m's bf16 train step (8 x 256, the
              train phase's) and bf16 prefill (4 x 256, the serve phase's):
              the predicted argument bytes of the W ranks (parameters, and
              for the step the AdamW state) within CAL_ARG_RTOL of
              ``torch.cuda.memory_allocated()`` after placing them; the
              predicted peak (arguments, inputs and the eager path's
              temporaries on meta) over the step's measured
              ``max_memory_allocated()``, within CAL_PEAK; the compute,
              memory and collective terms of the W ranks at the card's
              ``HW`` beside the step's measured ms (CUDA events), recorded.
  19d. tp_gpus  (four cards; on one it prints "tp_gpus: not run" and
              nothing else) the TP world over one process a card, W = 4 over
              P = 4 (``phase_tp_gpus``): serving (the fused ops bitwise the
              emulated world, smollm-360m's f32 prefill, bf16 greedy, the
              engine, Fig. 8 / Tab. 2) and training (the fused ops' backward
              on the peer route at smollm's train shapes, bitwise the
              emulated world with the gathered operands; the f32 step at 2
              layers against the emulated and the eager step; 30 bf16 AdamW
              steps of smollm-360m at 32 layers, launches a process a step
              128 / 128 / 32 / 1, the ce's fall, a resume bitwise; Fig. 11's
              dense rows at ``paper_e2e.DEPTH_PROCS``) and MoE (e: deepseek's
              f32 MoE layer on the double ring and the a2a pair at capacity
              factors 1.25 / 0.25, outputs and kept sets against the
              emulated world, its f32 prefill at 4 layers in TP and EP and
              its teacher-forced f32 decode in both MoE decode forms; f:
              deepseek-moe-16b at its 28 layers in bf16, greedy with the
              gathered and the streamed decode against the emulated one-card
              run, held up to each row's first MoE routing flip, which must
              be a near tie under rounding; the engine; g: granite's f32
              step at 2 layers against the emulated step, 30 bf16 steps at
              32 layers; h: Fig. 9 at W = 4, with the ring waited on at
              once beside the lazy one; i: Fig. 11's MoE rows; kernel #5 at
              the four-card shapes).
  20. kernels every kernel against its plain PyTorch version at the shapes
              the serve paths give it (W = 4 emulated ranks, 4 requests x
              256 tokens: smollm-360m for the dense kernels, granite-moe-
              3b-a800m and deepseek-moe-16b for the grouped expert GEMM
              (deepseek also its dense-layer and shared-expert projections,
              flash attention at D 128 and its [1024, 2048] x [2048, 102400]
              LM head), each with one random, non-monotone expert table
              with a row tile below capacity, Fig. 9's MoE-6 grouped GEMM
              (W = 8, row tile 104),
              mamba2-2.7b for the in/out projections, its LM head and the
              SSD intra-chunk kernel; the LM head at its prefill shape
              [B x S, d] and its decode shape [B, d], and for smollm-360m and
              mamba2-2.7b the engine's forward [slots x 16, d] and decode
              [slots, d], at the width the path stores), in float32 and bfloat16, and the fused kernels over
              every tile order x C in {1, 2} (float32, and bfloat16 with 20
              launches each held bitwise equal to the first, as is every
              bf16 LM-head, grouped-GEMM and flash-attention case; the bf16
              flash route is held to the f32 plain version and to its tiled
              twin); kernel, plain-version and library-call times with
              CUDA events over back-to-back calls, and the kernel's and the
              library call's device time per call (torch.profiler), in
              bfloat16, the serving dtype (and for the SSD kernel also in
              float32, the dtype its path gives it), with the route, grid G
              and work-item count of each launch (for flash attention the
              route by (dtype, head dim), CTAs and KV tiles visited; for the
              SSD kernel its staging path and persistent grid); and flash
              attention on one ring step at Fig. 10's Attn-1, 16k, W = 8
              shape (all 8 ranks in one launch at their offsets, the state of
              the step before carried in), against its plain version and
              bitwise over 20 launches; and the fused kernels at the train
              phase's backward shapes (the input gradients of smollm's qkv
              and gate/up through GEMM+RS, of its o and down projections
              through AG+GEMM), and the bf16 train path's own uses of them
              there: flash attention's forward with its statistics (o and
              the log-sum-exp) against the plain version's state, AG+GEMM's
              gathered operand bitwise against x in rank-major order, and
              the autograd Functions' gradients against float32 eager
              autograd, 2e-2 of max; and kernels #1-#4 at the e2e phase's
              shapes of qwen2-72b, starcoder2-7b and gemma3-27b (1 x 4096
              tokens, bf16: the qkv and gate/up AG+GEMM, the o and down
              GEMM+RS, and the backward's four transposes, their plain
              versions timed by the one checking call; flash attention at D
              128, causal and, for gemma3's local layers, windowed at 1024,
              against SDPA with is_causal / with a boolean mask; the LM
              head), with the same train-path checks as smollm's at those
              shapes (flash attention's o and lse and its Function at every
              window, the gathered operand, the AG+GEMM / GEMM+RS
              Functions); the same for granite-moe-3b-a800m and
              deepseek-moe-16b at the train_moe phase's 8 x 256 and at
              Fig. 11's 1 x 4096 tokens (their attention, qkv and o-proj,
              deepseek's dense first layer and shared experts; the backward
              transposes; at 1 x 4096 the forward kernels and the LM head
              too); and kernel #5 at the MoE backward shapes (dx:
              dy times w^T on the forward's table, granite's 40 groups of
              192 / 264 rows and deepseek's 64 of 64 / 128, gate|up and
              down), float32 checked, bf16 bitwise over 20 launches and
              timed against ``torch.bmm`` (with the w^T copy the backward
              makes once a layer), and the grouped GEMM's and the
              tensor-core expert GEMM's autograd Functions against float32
              autograd there; zamba2-2.7b's serve shapes (flash attention
              at head dim 80 on both routes, bf16 bitwise over 20 launches,
              timed against SDPA; its qkv, gate|up, o and down projections;
              its LM head) and train shapes (the backward transposes, flash
              attention's statistics and Function at D 80, the AG+GEMM /
              GEMM+RS Functions); and the SSD intra-chunk kernel at the
              train tile (T = 2560, Q = P = 64), timed in float32, with its
              autograd Function's output and gradients against float32
              autograd over the einsum form and the torch-ops backward
              timed; and the multimodal phases' shapes: flash attention at
              head dim 256 (paligemma's causal MQA prefill, f32 and bf16),
              at seamless-m4t's non-causal encoder (4096 frames) and its
              cross-attention (256 queries against 512 keys), each against
              SDPA, both models' LM heads and projections (the encoder
              stream's kv gather among them), and paligemma's train-path
              checks and backward transposes at 8 x 512 tokens.  Every
              case whose function ``kernels/ref`` computes (every GEMM,
              flash and grouped case, packed weights dequantized by the
              reference's formula, and the quant phase's) is also held
              against that float32 oracle, under the same TOL, and its
              error printed beside the plain version's (flash attention's
              oracle split over heads where its scores would pass
              REF_FLASH_ELEMS); so are the cases whose function only the
              port's own oracles compute: the ring step (both steps, the
              first's state carried in) against attention over the union
              of their KV tiles at the ring's rank offsets, the SSD
              intra-chunk term against the float32 einsum of its formula,
              and GEMM+RS on a bf16 wire against the oracle that rounds
              each partial once per hop in the plan's hop order (a float32
              x at the float32 TOL: the oracle rounds as the kernel does;
              a bf16 x at the bf16 TOL); ``ssd_chunked`` at
              mamba2-2.7b's serve shape is held against ``ssd_ref`` (1e-4);
              the seconds the holds add are printed.  It runs
              after the serve phases: the profiler leaves
              host overhead behind.  Its device times (torch.profiler) are
              readouts that may be missing: a session now and then records
              no device event, and after PROFILER_SESSIONS such sessions the
              case prints "device n/a" and records null; nothing that
              decides a check reads them.
  21. verify  the port's static verifier (``repro_torch.analysis``) at what
              the card launches, after every other phase: (b) each AG+GEMM /
              GEMM+RS shape the serve, train, paper and tune phases launch
              (every arch's serve path, smollm-360m's train step and its
              backward transposes, Fig. 11's forward and backward at 1 x 4096
              tokens, Tab. 2's MLP-1 pair at W = 8; smollm's serve and train
              shapes on the float32 route too) at every (order, C) the tuner
              enumerates there, C requested from {1, 2, 4}: one launch, its
              output held against the f32 product (bf16 2e-2 of max, f32
              1e-4), and ``verify_launch`` at the grid G the card reported
              (``last_launch``) and at G = 1 (the float32 route: one n-tile
              per (channel, rank)), proven in VERIFY_WORKERS processes beside
              the launches; (a) meanwhile ``verify_space`` and
              ``verify_seq_space`` over the shipped plan space, the plan
              count and host seconds; (c) a TilePlan whose ``flow_dst``
              table has one pair swapped is refused by ``build_plan`` with
              its coordinates, and ``ag_gemm`` launches nothing; (d) every
              ``build_plan`` / ``build_seq_plan`` miss of the whole run was
              verified (the poked one refused).
  22. summary the launch counts of every path, each phase's and the script's wall time,
              the per-kernel JSON line, the card's power limit, and the
              last line ``{"ok": true, "device": {...}}``.

Cuts: deepseek-moe-16b's float32 checks (deepseek and ep phases) run 4 of
its 28 layers; the train phase's resume check (c) runs 2 of smollm-360m's
32 layers at full width (two runs' checkpoints at full depth would write
~4 GB); the e2e phase runs qwen2-72b at 2 of 80 layers, starcoder2-7b at 8
of 32, gemma3-27b at 6 of 62 and deepseek-moe-16b at 9 of 28 (a bf16
weight, its gradient and two float32 moments take 12 bytes a parameter:
one 80 GB card holds no more), its float32 step at 2 layers, at the
published widths, and cuts the train_4k shape's batch of 256 to 1; the
train_moe phase's float32 step runs 4 of granite's 32 layers, its resume
check 2; the train_ssm phase's float32 step runs 4 of mamba2-2.7b's 64
layers, its resume check 2; the zamba2 phase's float32 step 12 of 54, its
resume check 6; the encdec phase's f32 step and resume check 2 + 2 of
12 + 12, the vlm phase's f32 step 4 of 18 layers at 4 rows (8 ran the
card out of memory) and its resume check 2; the dp phase's f32 check
DP_F32_LAYERS of smollm-360m's 32, the serve_dp phase's f32 checks
SERVE_DP_F32_LAYERS.  So that the whole script ends well inside its 1200 s
limit on a slow host, these earlier paths run cut in depth too, at the
published widths and loads and with the same holds (the table CUT): the
engine phase serves smollm-360m at 4 of its 32 layers and mamba2-2.7b at
8 of 64; the deepseek and ep phases' bf16 paths run deepseek-moe-16b at
9 of 28; the dp and serve_dp phases smollm-360m at 8; the bf16 steps of
the train (smollm-360m 8), train_moe (granite 4 of 32, deepseek 4) and
train_ssm (mamba2-2.7b 8 of 64) phases; the zamba2 phase 6 of 54 but its
f32 step; the encdec phase 6 + 6 of 12 + 12 but its f32 steps and
resume; the vlm phase 6 of 18; the e2e phase's smollm-360m and granite
rows 8 of 32, starcoder2-7b 4 and deepseek-moe-16b 4.  Every other path
runs at full depth
and width, the paper's MLPs and MoEs at their published shapes.

Usage: ``python3 chip_smoke.py`` (one CUDA device).  Needs the repository
(``src/``) beside this script and ``nvcc`` (PATH or /usr/local/cuda/bin).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "smollm-360m"
ARCH_MOE = "granite-moe-3b-a800m"
ARCH_DS = "deepseek-moe-16b"
ARCH_SSM = "mamba2-2.7b"
WORLD, BATCH, PROMPT, NEW_TOKENS = 4, 4, 256, 16
ITERS = 20  # timed launches per kernel case (after warm-up)
REPEATS = 20  # launches of each bf16 fused order x C case, held bitwise equal
# kernel vs plain: float32 agrees to summation order; bfloat16 outputs round
# to 8 mantissa bits (2^-8 = 3.9e-3 relative) in both versions, plus the
# plain version's bf16 pre-scale of q in attention
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# prefill logits, fused vs eager (float32): as tests/test_serving.py
LOGIT_ATOL = LOGIT_RTOL = 2e-3
# the engine phase's loads: requests, prompt and new-token ranges (uniform),
# sampled requests (temperature 0.8, top-k 40), slots and max_len
ENGINE = {
    ARCH: dict(requests=16, prompt=(32, 256), new=(16, 64), sampled=4, slots=8, max_len=320),
    ARCH_SSM: dict(requests=8, prompt=(16, 64), new=(16, 16), sampled=2, slots=4, max_len=80),
}
# deepseek-moe-16b's engine load (its phase, with the streamed MoE decode):
# 8 requests on 4 slots, 2 sampled
ENGINE_DS = dict(requests=8, prompt=(32, 256), new=(16, 32), sampled=2, slots=4, max_len=288)
# the depth of deepseek-moe-16b's float32 checks: the dense first layer and
# 3 MoE layers at full width (float32 weights of all 28 layers take ~66 GB)
DS_F32_LAYERS = 4
ENGINE_CHUNK = 16  # the engine's prefill chunk (ServeEngine's default)
NEAR_TIE = 1e-3  # (c): a token may differ from the reference argmax only within this logit gap
PAPER_WORLD = 8
PAPER_MOE_ROWS = ("MoE-1", "MoE-6")  # Fig. 9's rows in the paper phase (W = 8)
PAPER_ATTN_ROWS = (("Attn-1", 16384), ("Attn-1", 32768))  # Fig. 10's rows in the paper phase (W = 8)
RING_ARCHS = (ARCH, ARCH_DS)  # the ring phase's attention layers (head dim 64, GQA; head dim 128)
RING_TOKENS = ((BATCH, PROMPT), (1, 8192))  # (batch, tokens) of the ring phase's timed bf16 layers
# the train phase: smollm-360m, W = 4, the JAX package's default train batch x sequence
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 30
TRAIN_WARMUP = 3  # steps left out of the median step time
# the dp phase: replica processes on the one card, their bf16 steps (at 10 the ce fell 0.17, short of the train
# phase's criterion's 0.2; each step's gloo transport takes ~2 s), the steps of the D = 1 run before them, and the
# depth of the float32 check; the remat policy of its second D = 2 run and that run's steps
DP_REPLICAS, DP_STEPS, DP_D1_STEPS, DP_F32_LAYERS = 2, 20, 10, 2
DP_REMAT, DP_REMAT_STEPS = "dots", 5
# the serve_dp phase (in the dp phase's spawn): smollm-360m's engine at D = DP_REPLICAS on seeded requests (all
# prompts 64, 16 new tokens), its global slots and decode block; the depth of its float32 checks
SERVE_DP = dict(requests=8, prompt=(64, 64), new=(16, 16), sampled=2, slots=8, max_len=80, decode_block=16)
SERVE_DP_F32_LAYERS = 2
TRAIN_CKPT_LAYERS, TRAIN_CKPT_AT = 2, 3  # (c): depth of the resume check, the step it saves at
# the train_seam phase: (a) bf16 AdamW steps of each form, in turns (the first of each left out of the median);
# (b), (c) the depth of the float32 steps at smollm-360m's width
SEAM_TRAIN_STEPS, SEAM_F32_LAYERS = 4, 2
# (a): a gradient leaf's max|diff| against eager, relative to the leaf's max|eager| (the logits' rtol)
GRAD_RTOL = 2e-3
# (a): an update's (new - p) max|diff| against eager, relative to the leaf's max|eager update|: both
# sides round new to float32, 1 ulp apart at most (2.4e-7 at |p| < 4, 4e-3 of an update of lr = 6e-5)
UPDATE_RTOL = 1e-2
# the e2e phase (paper Fig. 11, ``benchmarks/paper_e2e.py``): (d) the depth and tokens of the float32
# fused-vs-eager step (2 layers: float32 weights and two gradient trees of qwen2-72b take ~51 GB; 2048
# tokens keep gemma3's 1024 window below the sequence), (e) gemma3's greedy at its e2e depth
E2E_F32_ARCHS, E2E_F32_LAYERS, E2E_F32_SEQ = ("qwen2-72b", "gemma3-27b"), 2, 2048
# the train_moe phase: (b) granite's depth in the float32 whole-step check; deepseek's bf16 steps at its
# Fig. 11 depth (``paper_e2e.DEPTH``)
TRAIN_MOE_F32_LAYERS, TRAIN_MOE_DS_STEPS = 4, 3
# (b): the routing flips (tokens whose expert set differs, fused vs eager) a float32 MoE layer may show:
# only near-ties of the router's top-k flip at float32 rounding; more means the paths diverged
TRAIN_MOE_MAX_FLIPS = 8
ARCH_G = "gemma3-27b"
ARCH_Z = "zamba2-2.7b"
# zamba2's engine load (its phase): 8 requests on 4 slots, 2 sampled
ENGINE_Z = dict(requests=8, prompt=(32, 256), new=(16, 32), sampled=2, slots=4, max_len=288)
# the train_ssm and zamba2 phases: the train step's remat policy (the JAX package's trainer runs "dots";
# mamba2-2.7b's saved activations at 64 layers and 8 x 256 tokens would take ~51 GB without it), the depth of
# the float32 fused-vs-eager step (zamba2: two periods, so the shared mixer's gradient sums two uses) and of
# the resume check (zamba2: one period, its shared block included)
SSM_REMAT = "dots"
# their bf16 steps' learning rate: the JAX package's loss test (``tests/test_training.py``: lr 3e-3 and the
# same 0.2 fall); at the train CLI's default 3e-4 neither model's ce falls 0.2 in 30 steps (their init, A = -1
# and dt_bias 0, is the reference's), in bf16 or (zamba2) in float32 alike
SSM_LR = 3e-3
SSM_F32_LAYERS = {ARCH_SSM: 4, ARCH_Z: 12}
SSM_CKPT_LAYERS = {ARCH_SSM: 2, ARCH_Z: 6}
ARCH_ED = "seamless-m4t-medium"
ARCH_V = "paligemma-3b"
MM_LR = 3e-4  # the multimodal phases' bf16 steps (the train CLI's default)
ENCDEC_F32_SEEDS = 3  # seeds of the encdec phase's f32 fused-vs-eager step: the margin to GRAD_RTOL over seeds
# a ReLU sign the fused and eager passes disagree on (:func:`hold_relu_flips`): the element's |pre-activation| on
# each backend within RELU_FLIP_REL of that call's max|pre-activation| (rounding of zero, not a wrong value), and
# at most RELU_MAX_FLIP_SHARE of the call's elements flipped (on the H100 1-9 of 8-16 M, PR 31)
RELU_FLIP_REL, RELU_MAX_FLIP_SHARE = 1e-5, 1e-5
MM_CUT_LAYERS = 2  # their f32 step (the enc-dec's, 2 + 2) and their resume check cut to this depth
# the VLM's f32 step: 4 layers of 4 x 512 tokens (at 8 rows the eager reference's float32 activations and the
# [4096, 257216] float32 logits and their gradient took the card's 80 GB)
V_F32_LAYERS, V_F32_ROWS = 4, 4
# The depth cuts.  The whole script must end within 1200 s, the kernels' build included: with every path at full
# depth it took 951 s on one H100 host and more than 1200 s on slower ones.  So these earlier paths keep their
# published widths, loads and holds at fewer layers (the serve phase's main path keeps every layer); CUT[phase][arch]
# is the depth of that phase's model (of an enc-dec's encoder and of its decoder each).
CUT = {
    "engine": {ARCH: 4, ARCH_SSM: 8},
    "deepseek": {ARCH_DS: 9},  # the deepseek and ep phases' bf16 paths: Fig. 11's depth, the dense layer + 8 MoE
    "dp": {ARCH: 8},  # the dp phase's bf16 runs at D = 1 and D = 2, and the serve_dp phase
    # the TRAIN_STEPS bf16 steps of the train, train_moe (deepseek: its TRAIN_MOE_DS_STEPS), train_ssm and zamba2
    # phases
    "train": {ARCH: 8, ARCH_MOE: 4, ARCH_DS: 4, ARCH_SSM: 8, ARCH_Z: 6},
    "zamba2": {ARCH_Z: 6},  # the zamba2 phase but its f32 step and resume: one period, the shared block once
    "encdec": {ARCH_ED: 6},
    "vlm": {ARCH_V: 6},
    "e2e": {ARCH: 8, ARCH_MOE: 8, "starcoder2-7b": 4, ARCH_DS: 4},  # Fig. 11's rows below ``paper_e2e.DEPTH``
}
DECODE_RTOL = 3e-3  # enc-dec decode vs the teacher-forced forward (the JAX package's tests/test_extended.py)
E2E_ARCHS = ("qwen2-72b", "starcoder2-7b", ARCH_G)  # the new dense configs
E2E_SERVE_BATCH, E2E_SERVE_PROMPT = 4, 2048  # prompts past the window: the local layers' ring caches wrap
# the verify phase: processes proving the launches of (b) beside the card's launches
VERIFY_WORKERS = 6
# the dryrun phase: (a) at most this many processes planning the grid on meta; (b) the calibration's bounds: predicted
# argument bytes against memory_allocated (both exact sizes: the allocator's rounding only), and the
# predicted peak over the measured one (the plan runs the eager path, the card the fused kernels)
DRYRUN_JOBS = 8
CAL_ARG_RTOL = 0.02
CAL_PEAK = (0.5, 2.0)
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:35",
    "ag_gemm": "src/repro/kernels/ag_gemm.py:145",
    "gemm_rs": "src/repro/kernels/gemm_rs.py:183",
    "flash_attention": "src/repro/kernels/flash_attention.py:101",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:28",
    "ssd_intra_chunk": "src/repro/kernels/mamba_ssd.py:123",
}
# the bf16 kernel of each wrapper with a wgmma route (SASS symbol): wgmma + TMA
BF16_KERNELS = {
    "ag_gemm": "ag_gemm_wgmma_kernel",
    "gemm_rs": "gemm_rs_wgmma_kernel",
    "matmul": "wgmma_gemm_kernel",
    "grouped_matmul": "wgmma_gemm_kernel",
    "flash_attention": "fa_wgmma_kernel",
}
SSD_KERNEL = "ssd_intra_kernel"  # no spills; its bulk staging path issues UBLKCP
FMA_KERNELS = ("ag_gemm_kernel", "gemm_rs_kernel")  # the fused kernels' float32 route (SASS symbols)
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "LDGSTS")
# the SSD intra-chunk cases' note: kernels/ref has the whole SSD only (the ssd_chunked case holds it)
# the fused kernels as built with the peer route (their flag sites through the tile primitives of
# tile_sync.cuh at either scope, the receive regions through PeerTbl, epochs and entry words on the peer
# route only; the bf16 AG+GEMM in two forms, one TMA map or one a held rank): registers, spill stores /
# loads (bytes), and for the bf16 kernels HGMMA / UTMALDG (the build phase of this script on an H100,
# nvcc 12.9), keyed by symbol or, as the phase prints them, its first 72 characters; the build phase
# fails if a rebuilt kernel differs
FUSED_BUILD = {
    "_Z14ag_gemm_kernelIf6PlainBIfEEvPKT_T0_PS2_7PeerTblPKiS9_iiiiiiiii": (128, 0, 0, None, None),
    "_Z14ag_gemm_kernelIf7PackedBEvPKT_T0_PS1_7PeerTblPKiS8_iiiiiiiii": (128, 0, 0, None, None),
    "_Z20ag_gemm_wgmma_kernelILb0ELi1EEv6AgMapsIXT0_EE14CUtensorMap_st6AgArgs": (161, 0, 0, 8, 3),
    "_Z20ag_gemm_wgmma_kernelILb0ELi16EEv6AgMapsIXT0_EE14CUtensorMap_st6AgArg": (161, 0, 0, 8, 3),
    "_Z20ag_gemm_wgmma_kernelILb1ELi1EEv6AgMapsIXT0_EE14CUtensorMap_st6AgArgs": (168, 0, 0, 4, 2),
    "_Z20ag_gemm_wgmma_kernelILb1ELi16EEv6AgMapsIXT0_EE14CUtensorMap_st6AgArg": (168, 0, 0, 4, 2),
    "_Z20gemm_rs_wgmma_kernelI13__nv_bfloat16Lb0EEv14CUtensorMap_stS1_6RsArgs": (146, 0, 0, 4, 3),
    "_Z20gemm_rs_wgmma_kernelI13__nv_bfloat16Lb1EEv14CUtensorMap_stS1_6RsArgs": (162, 0, 0, 4, 2),
    "_Z20gemm_rs_wgmma_kernelIfLb0EEv14CUtensorMap_stS0_6RsArgsIT_E": (146, 0, 0, 4, 3),
    "_Z20gemm_rs_wgmma_kernelIfLb1EEv14CUtensorMap_stS0_6RsArgsIT_E": (162, 0, 0, 4, 2),
    "_Z14gemm_rs_kernelIf13__nv_bfloat166PlainBIfEEvPKT_T1_PS3_7PeerTblPKiSA_": (128, 0, 0, None, None),
    "_Z14gemm_rs_kernelIf13__nv_bfloat167PackedBEvPKT_T1_PS2_7PeerTblPKiS9_ii": (128, 0, 0, None, None),
    "_Z14gemm_rs_kernelIff6PlainBIfEEvPKT_T1_PS2_7PeerTblPKiS9_iiiiiiiii": (126, 0, 0, None, None),
    "_Z14gemm_rs_kernelIff7PackedBEvPKT_T1_PS1_7PeerTblPKiS8_iiiiiiiii": (128, 8, 16, None, None),
}
# the numbers of a kernel case the JSON line carries for each backward shape
# (kernel #5's dx shapes also carry the w^T copy they launch on, ``wt_copy_ms``)
TIMES = ("case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
         "library_device_ms", "wt_copy_ms")  # fmt: skip
SOURCES = {
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "ag_gemm": "src/repro_torch/kernels/csrc/ag_gemm.cu",
    "gemm_rs": "src/repro_torch/kernels/csrc/gemm_rs.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
    "ssd_intra_chunk": "src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
}


# seconds the kernels phase spends computing ``kernels/ref``'s oracles (one list: _case adds to it)
REF_S = [0.0]
# host seconds ``device_ms``'s torch.profiler sessions take (their warm-up call included), over the whole run
DEVICE_S = [0.0]
# flash_attention_ref's float32 scores (and exponentials) per call are kept below this many elements by
# splitting the heads: seamless-m4t's encoder case would take 64 x 4096^2 x 4 B = 4.3 GB in one call
REF_FLASH_ELEMS = 1 << 28


def _flash_ref(q, k, v, **kw):
    """``kernels/ref.flash_attention_ref`` over blocks of whole GQA groups of
    heads (query heads h0 .. h1 read KV heads h0 / rep .. h1 / rep), in q's dtype."""
    import torch

    from repro_torch.kernels.ref import flash_attention_ref

    rep = q.shape[0] // k.shape[0]
    per = max(rep, REF_FLASH_ELEMS // (q.shape[1] * k.shape[1]) // rep * rep)
    return torch.cat([flash_attention_ref(q[h:h + per], k[h // rep:(h + per) // rep], v[h // rep:(h + per) // rep], **kw)
                      for h in range(0, q.shape[0], per)])  # fmt: skip


def _grouped_ref(x, w, table, out_dtype=None):
    """``kernels/ref.grouped_matmul_ref`` at the table's row tile."""
    from repro_torch.kernels.ref import grouped_matmul_ref

    return grouped_matmul_ref(x, w, table, x.shape[0] // table.shape[0], out_dtype)


def _dq(w):
    """A weight as ``kernels/ref`` takes it: a PackedWeight dequantized by the
    reference's formula, (q - zero) x scale in float32; a plain weight as it is."""
    from repro_torch.core.quant import PackedWeight

    if not isinstance(w, PackedWeight):
        return w
    q = w.q.float() if w.zero is None else w.q.float() - w.zero.unsqueeze(-2)
    return q * w.scale.unsqueeze(-2)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


PROFILER_SESSIONS = 3  # torch.profiler sessions device_ms tries before it reports the readout missing


def device_ms(fn, what: str, iters: int = 10):
    """Device time of one call of ``fn``: the sum of its kernels' device time
    (torch.profiler) over ``iters`` calls, per call.  Unlike ``cuda_ms`` it
    leaves out the host gaps between launches, which a wrapper whose host
    time exceeds its kernel's time opens.  A readout only: when none of
    PROFILER_SESSIONS sessions records a device event (the profiler drops
    them now and then), it prints one line naming ``what`` and returns None,
    and the case records ``null`` ("device n/a")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if total > 0:
            DEVICE_S[0] += time.perf_counter() - t0
            return total / iters / 1e3
    DEVICE_S[0] += time.perf_counter() - t0
    print(f"[kernels] {what}: torch.profiler recorded no device event in {PROFILER_SESSIONS} sessions: device n/a")
    return None


def _dev(v) -> str:
    """A device time for a printed line: ``device_ms``'s None reads "n/a"."""
    return "n/a" if v is None else f"{v:.4f}"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; count {torch.cuda.device_count()}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    from repro_torch.benchmarks.common import card_line

    smi = card_line()
    print(f"[device] nvidia-smi: {smi}")
    from repro_torch.backend import hw

    info = hw.require_hopper(torch.device("cuda", 0))
    print(f"[device] {info.sm_count} SMs, {info.smem_per_block_optin} B shared memory per block (opt-in)")
    from repro_torch.backend import describe

    print(f"[device] backend.describe(): {json.dumps(describe())}")
    return name, smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {dt:.1f} s")
    kernel, spills, fma, built = None, [], {}, {}
    for line in build.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel is not None and ("registers" in line or "spill" in line.lower()):
            print(f"[build] {kernel[:72]}: {line.strip().removeprefix('ptxas info    : ')}")
            spilled = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
            regs = re.findall(r"Used (\d+) registers", line)
            rec = built.setdefault(kernel, {})
            if spilled:
                rec["spills"] = (spilled[0], spilled[-1])
            if regs:
                rec["registers"] = int(regs[0])
            if any(spilled) and any(name in kernel for name in (*BF16_KERNELS.values(), SSD_KERNEL)):
                spills.append(kernel)
            if spilled and any(name in kernel for name in FMA_KERNELS):
                fma[kernel] = {"spill_stores_bytes": spilled[0], "spill_loads_bytes": spilled[-1]}
            if "registers" in line:
                kernel = None  # the entry's own report; later copies repeat it
    # the float32 route's fused kernels, which the tuner's FMA candidates run: spills recorded, not failed on
    for name, rec in fma.items():
        print(f"[build] FMA route {name[:72]}: spill stores {rec['spill_stores_bytes']} B, "
              f"loads {rec['spill_loads_bytes']} B")  # fmt: skip
    sass = build.sass_report(SASS_OPS)
    for fn, ops in sass.items():
        if any(ops.values()):
            print(f"[build] SASS {fn[:72]}: {ops}")
    for wrapper, name in BF16_KERNELS.items():
        found = [ops for fn, ops in sass.items() if name in fn]
        if not found or not all(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 for ops in found):
            raise SystemExit(f"chip_smoke: {wrapper}'s bf16 kernel {name} lacks HGMMA (wgmma) or UTMALDG (TMA): {found}")
    ssd = [ops for fn, ops in sass.items() if SSD_KERNEL in fn]
    if not any(ops["UBLKCP"] > 0 for ops in ssd):
        raise SystemExit(f"chip_smoke: the SSD intra-chunk kernel has no UBLKCP (bulk staging): {ssd}")
    if spills:
        raise SystemExit(f"chip_smoke: kernels spill registers: {spills}")
    # the fused kernels' flag sites call the tile primitives: the same instructions as before
    moved = {}
    for name, want in FUSED_BUILD.items():  # a key is the symbol, or its first 72 characters as printed
        rec = next((r for k, r in built.items() if k.startswith(name)), {})
        ops = next((o for k, o in sass.items() if k.startswith(name)), {})
        got = (rec.get("registers"), *rec.get("spills", (None, None)), *(
            (ops.get("HGMMA"), ops.get("UTMALDG")) if want[3] is not None else (None, None)))  # fmt: skip
        if got != want:
            moved[name] = {"built": got, "expected": want}
    print(f"[build] the fused kernels' registers, spills and HGMMA / UTMALDG against FUSED_BUILD: "
          f"{len(FUSED_BUILD) - len(moved)} of {len(FUSED_BUILD)} equal")  # fmt: skip
    if moved:
        raise SystemExit(f"chip_smoke: the fused kernels' instructions changed: {moved}")
    return dt, fma


def _case(name, dtype, kernel, plain, library, flops, nbytes, iters, check_only=False, launch=None, bitwise=False,
          plain_once=False, ref=None):  # fmt: skip
    """Run one kernel case: max error vs the plain version and vs
    ``kernels/ref``, then times.  ``ref`` returns the case's function from
    ``kernels/ref`` (float32, no schedule of any kernel), held under the same
    TOL as the plain version (its seconds add to ``REF_S``).
    ``launch`` returns the wrapper's record of its last launch (route, grid
    G, work items), printed beside the times; ``bitwise`` also launches the
    kernel REPEATS - 1 more times and fails unless every output is bitwise
    equal to the first; ``plain_once`` times the plain version by the one
    call that checks the kernel (a replay of the kernel's work items that
    takes seconds at the widest shapes)."""
    import torch

    from repro_torch.benchmarks.common import bound_ms

    out = kernel()
    info = launch() if launch is not None else None
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    base = plain()
    e1.record()
    torch.cuda.synchronize()
    err = (out.float() - base.float()).abs().max().item()
    scale = base.float().abs().max().item()
    del base
    dn = str(dtype).removeprefix("torch.")
    ok = bool(torch.isfinite(out).all().item()) and err <= TOL[dn] * max(scale, 1e-30)
    rec = {"case": name, "dtype": dn, "max_abs_err": err, "max_abs_ref": scale, "tol_rel": TOL[dn], "ok": ok}
    ref_txt, ok_ref = "", True
    if callable(ref):
        t_ref = time.perf_counter()
        oracle = ref()
        torch.cuda.synchronize()
        REF_S[0] += time.perf_counter() - t_ref
        rec["ref_max_abs_err"] = (out.float() - oracle.float()).abs().max().item()
        rec["max_abs_oracle"] = oracle.float().abs().max().item()
        ok_ref = rec["ref_max_abs_err"] <= TOL[dn] * max(rec["max_abs_oracle"], 1e-30)
        ref_txt = f"; vs kernels/ref max|err| {rec['ref_max_abs_err']:.3e} (max|oracle| {rec['max_abs_oracle']:.3e})"
        del oracle
    if info is not None:
        rec["launch"] = dict(info)
    if bitwise:
        differ = sum(not torch.equal(kernel(), out) for _ in range(REPEATS - 1))
        rec["relaunches_bitwise_equal"] = REPEATS - 1 - differ
        print(f"[kernels] {name} {dn}: {REPEATS - 1 - differ} of {REPEATS - 1} relaunches bitwise equal")
        if differ:
            raise SystemExit(f"chip_smoke: kernel {name} ({dn}) is not deterministic over {REPEATS} launches")
    times = ""
    if not check_only:
        rec["ms"] = cuda_ms(kernel, iters)
        rec["device_ms"] = device_ms(kernel, name)
        rec["plain_ms"] = e0.elapsed_time(e1) if plain_once else cuda_ms(plain, max(2, iters // 4))
        rec["library_ms"] = cuda_ms(library, iters) if library is not None else None
        rec["library_device_ms"] = device_ms(library, f"{name} library") if library is not None else None
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, dtype)
        lib = "None" if library is None else f"{rec['library_ms']:.4f} (device {_dev(rec['library_device_ms'])})"
        times = (
            f" ms {rec['ms']:.4f} (device {_dev(rec['device_ms'])}) plain {rec['plain_ms']:.4f} library {lib} "
            f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})"
        )
    where = "" if info is None else f" [{info['route']}, G {info['grid']}, items {info['items']}]"
    bound_txt = f"bound {TOL[dn]:g} x max|plain|"
    print(f"[kernels] {name} {dn}: vs plain max|err| {err:.3e} (max|plain| {scale:.3e}, {bound_txt}){ref_txt}{times}"
          f"{where}")  # fmt: skip
    if not ok:
        raise SystemExit(f"chip_smoke: kernel {name} ({dn}) disagrees with its plain version: {err} > {TOL[dn]} x {scale}")
    if not ok_ref:
        raise SystemExit(f"chip_smoke: kernel {name} ({dn}) disagrees with kernels/ref: {rec['ref_max_abs_err']} > "
                         f"{TOL[dn]} x {rec['max_abs_oracle']}")  # fmt: skip
    return rec


def head_width(cfg) -> int:
    """Columns of the LM head as ``convert.shard_params`` stores it: the
    vocab padded to the TP degree, then to a multiple of 8 (TMA)."""
    from repro_torch.convert import IN_ALIGN
    from repro_torch.models.lm import padded_vocab

    return -(-padded_vocab(cfg, WORLD) // IN_ALIGN) * IN_ALIGN


def path_shapes(arch: str) -> dict:
    """The kernels' shapes on an arch's serve path (W ranks, B x S tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.core.moe_overlap import _capacity
    from repro_torch.nn.attention import layout

    cfg = get_config(arch)
    lay = layout(cfg, WORLD)
    shp = dict(d=cfg.d_model, hd=cfg.hd, h_loc=lay.h_loc, kv_loc=lay.kv_loc, vocab=head_width(cfg),
               n_qkv=(lay.h_loc + 2 * lay.kv_loc) * cfg.hd, n_o=lay.h_loc * cfg.hd)  # fmt: skip
    if cfg.moe is None:
        shp.update(n_gu=2 * cfg.d_ff // WORLD, f_loc=cfg.d_ff // WORLD)
    else:  # one ring step's expert groups: B x cap rows per (rank, expert), C = 1
        m = cfg.moe
        e_total = -(-m.num_experts // WORLD) * WORLD
        cap = _capacity(PROMPT // WORLD, m.top_k, e_total, m.capacity_factor)
        shp.update(e_loc=e_total // WORLD, cap=cap, fe=m.d_expert)
        if m.first_k_dense:  # the dense first layers' MLP
            shp.update(n_gu=2 * m.dense_d_ff // WORLD, f_loc=m.dense_d_ff // WORLD)
        if m.num_shared:  # the shared experts' MLP
            shp.update(n_sgu=2 * m.num_shared * m.d_expert // WORLD, sf_loc=m.num_shared * m.d_expert // WORLD)
    return shp


def _mlps(shp: dict) -> list:
    """(tag infix, gate|up width, down width) per rank of each dense MLP an
    arch runs through the fused kernels: a dense model's MLP, deepseek's
    dense first layer ("") and shared experts ("shared_"); none for
    granite (every FFN routed)."""
    out = [("", shp["n_gu"], shp["f_loc"])] if "n_gu" in shp else []
    return out + ([("shared_", shp["n_sgu"], shp["sf_loc"])] if "n_sgu" in shp else [])


def ssm_shapes() -> dict:
    """The kernels' shapes on mamba2-2.7b's serve path (W ranks, B x S tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import IN_ALIGN

    cfg = get_config(ARCH_SSM)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.headdim
    n_in = -(-(2 * d_inner + heads) // WORLD // IN_ALIGN) * IN_ALIGN  # w_in's width per rank, padded
    return dict(d=cfg.d_model, di_loc=d_inner // WORLD, n_in=n_in,
                vocab=head_width(cfg), q=s.chunk, p=s.headdim, tiles=BATCH * (PROMPT // s.chunk) * heads)  # fmt: skip


def _lm_head_cases(rnd, arch: str, d: int, vocab: int, dtype, iters: int, check_only: bool, rows=None) -> dict:
    """The LM head (``matmul``) at the prefill shape [B x S, d] (``rows``
    rows, default B x S) and the decode
    shape [B, d], and for an arch of the engine phase at its captured
    forward [slots x chunk, d] and decode iteration [slots, d], against one
    head [d, vocab]; bf16 cases held bitwise over REPEATS launches."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    isz = torch.tensor([], dtype=dtype).element_size()
    w = rnd(d, vocab, dtype=dtype) * 0.02
    recs = {}
    shapes = [("lm_head", rows or BATCH * PROMPT), ("lm_head_decode", BATCH)]
    engine = {**ENGINE, ARCH_DS: ENGINE_DS, ARCH_Z: ENGINE_Z}
    if arch in engine:
        slots = engine[arch]["slots"]
        shapes += [("lm_head_engine_forward", slots * ENGINE_CHUNK), ("lm_head_engine_decode", slots)]
    for tag, rows in shapes:
        x = rnd(rows, d, dtype=dtype)
        recs[("matmul", arch, tag, dtype)] = _case(
            f"matmul[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", dtype,
            lambda: K.matmul(x, w), lambda: K.matmul_plain(x, w), lambda: torch.matmul(x, w),
            2 * rows * d * vocab, isz * (x.numel() + w.numel() + rows * vocab), iters, check_only,
            lambda: K.matmul.last_launch, bitwise=dtype == torch.bfloat16, ref=lambda: R.matmul_ref(x, w),
        )  # fmt: skip
    return recs


def _ssm_kernels(rnd, iters: int) -> dict:
    """mamba2-2.7b's kernels at its path's shapes: the in-projection AG+GEMM
    (ragged width 2584, the f32 route's n tile clamped to a divisor), the
    out-projection GEMM+RS, the LM head and the SSD intra-chunk kernel (timed
    in both dtypes: its path gives it float32)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    shp = ssm_shapes()
    W, B, S = WORLD, BATCH, PROMPT
    s_loc = S // W
    d, n_in, di_loc, vocab = shp["d"], shp["n_in"], shp["di_loc"], shp["vocab"]
    t, q, p = shp["tiles"], shp["q"], shp["p"]
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        check_only = dtype != torch.bfloat16
        it = iters if not check_only else 2
        isz = torch.tensor([], dtype=dtype).element_size()
        x, w = rnd(W, B, s_loc, d, dtype=dtype), rnd(W, d, n_in, dtype=dtype) * d**-0.5
        xg = x.permute(1, 0, 2, 3).reshape(B, S, d)
        recs[("ag_gemm", ARCH_SSM, "in_proj", dtype)] = _case(
            f"ag_gemm[{ARCH_SSM} in_proj] x{list(x.shape)} w{list(w.shape)}", dtype,
            lambda: K.ag_gemm(x, w), lambda: K.ag_gemm_plain(x, w), lambda: torch.matmul(xg[None], w[:, None]),
            2 * W * B * S * d * n_in, isz * (x.numel() + w.numel() + W * B * S * n_in), it, check_only,
            lambda: K.ag_gemm.last_launch, ref=lambda: R.ag_gemm_ref(x, w),
        )  # fmt: skip
        x, w = rnd(W, B, S, di_loc, dtype=dtype), rnd(W, di_loc, d, dtype=dtype) * (W * di_loc) ** -0.5
        recs[("gemm_rs", ARCH_SSM, "out_proj", dtype)] = _case(
            f"gemm_rs[{ARCH_SSM} out_proj] x{list(x.shape)} w{list(w.shape)}", dtype,
            lambda: K.gemm_rs(x, w), lambda: K.gemm_rs_plain(x, w), lambda: torch.matmul(x, w[:, None]).sum(0),
            2 * W * B * S * di_loc * d, isz * (x.numel() + w.numel() + W * B * s_loc * d), it, check_only,
            lambda: K.gemm_rs.last_launch, ref=lambda: R.gemm_rs_ref(x, w),
        )  # fmt: skip
        recs.update(_lm_head_cases(rnd, ARCH_SSM, d, vocab, dtype, it, check_only))
        del x, w, xg
        # SSD intra-chunk: per-step log-decays of the size the path gives
        # (dt ~ softplus(N(0, 1)), A = -1), C.B scores and dt-weighted inputs
        cum = -(rnd(t, q, dtype=torch.float32).abs() * 0.7).cumsum(1)
        cb, xdt = rnd(t, q, q, dtype=dtype) * 0.3, rnd(t, q, p, dtype=dtype) * 0.5
        cum = cum.to(dtype)
        tril = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
        c32 = cum.float()
        gmat = (torch.where(tril, torch.exp(c32[:, :, None] - c32[:, None, :]), 0.0) * cb.float()).to(dtype)
        recs[("ssd_intra_chunk", ARCH_SSM, "intra", dtype)] = _case(
            f"ssd_intra_chunk[{ARCH_SSM}] cum{list(cum.shape)} cb{list(cb.shape)} xdt{list(xdt.shape)} "
            "(library: torch.bmm(G, xdt) on a precomputed G, the product alone)", dtype,
            lambda: K.ssd_intra_chunk(cum, cb, xdt), lambda: K.ssd_intra_chunk_plain(cum, cb, xdt),
            lambda: torch.bmm(gmat, xdt),
            # flops: the [q, q] @ [q, p] product, exp and mask-multiply; bytes:
            # cum, cb, xdt read once and y written once
            t * (2 * q * q * p + 2 * q * q), isz * t * (q + q * q + 2 * q * p), iters, False,
            lambda: K.ssd_intra_chunk.last_launch, ref=lambda: R.ssd_intra_chunk_ref(cum, cb, xdt),
        )  # fmt: skip
        del cum, cb, xdt, gmat
    return recs


def _ssd_ref_case(rnd) -> dict:
    """``kernels/ref.ssd_ref`` (the sequential scan over every position)
    against ``ssd_chunked`` with the intra-chunk kernel at mamba2-2.7b's
    serve shape (B x S tokens, 80 heads of 64, one group of 128 states),
    float32 (the path's dtype), from a random initial state (the
    reference's ``d_init``): 1e-4 of max|ref|, both times recorded."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.mamba_ssd import ssd_chunked

    cfg = get_config(ARCH_SSM)
    s, f32 = cfg.ssm, torch.float32
    h = s.expand * cfg.d_model // s.headdim
    x = rnd(BATCH, PROMPT, h, s.headdim, dtype=f32)
    dt = F.softplus(rnd(BATCH, PROMPT, h, dtype=f32))
    a_log = rnd(h, dtype=f32) * 0.5
    b, c = (rnd(BATCH, PROMPT, s.n_groups, s.d_state, dtype=f32) for _ in range(2))
    h0 = rnd(BATCH, h, s.d_state, s.headdim, dtype=f32) * 0.1
    t0 = time.perf_counter()
    y = ssd_chunked(x, dt, a_log, b, c, chunk=s.chunk, h_init=h0, intra="kernel")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    oracle = R.ssd_ref(x, dt, a_log, b, c, chunk=s.chunk, d_init=h0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    REF_S[0] += t2 - t1
    err, scale = (y - oracle).abs().max().item(), oracle.abs().max().item()
    ok = bool(torch.isfinite(y).all()) and err <= TOL["float32"] * scale
    print(f"[kernels] ssd_chunked[{ARCH_SSM}, intra kernel] x{list(x.shape)} b/c{list(b.shape)} with d_init, vs "
          f"kernels/ref.ssd_ref (sequential scan): max|err| {err:.3e} (max|oracle| {scale:.3e}, bound "
          f"{TOL['float32']:g} x max|oracle|); host s {t1 - t0:.3f} chunked, {t2 - t1:.3f} ref")  # fmt: skip
    if not ok:
        raise SystemExit(f"chip_smoke: ssd_chunked disagrees with kernels/ref.ssd_ref: {err} > 1e-4 x {scale}")
    return {"case": f"ssd_chunked[{ARCH_SSM}] vs ssd_ref", "dtype": "float32", "ref_max_abs_err": err,
            "max_abs_oracle": scale, "chunked_s": t1 - t0, "ref_s": t2 - t1}  # fmt: skip


def _ssd_train_kernels(rnd, iters: int) -> dict:
    """Kernel #6 at the train path's tile (mamba2-2.7b and zamba2-2.7b at
    TRAIN_BATCH x TRAIN_SEQ tokens: T = B x chunks x 80 heads = 2560 tiles
    of Q = P = 64) in float32, the path's dtype, and bf16: the forward
    against its plain version (timed in float32), and the autograd
    Function (``_SsdIntraChunk``: the kernel's forward, the float32
    torch-ops backward) against float32 autograd over the einsum form, the
    output and each gradient 1e-4 (f32) or 2e-2 (bf16) of max; the backward
    timed (no PyTorch call computes it: library None)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks.common import bound_ms
    from repro_torch.kernels import mamba_ssd
    from repro_torch.kernels.ref import ssd_intra_chunk_ref

    shp = ssm_shapes()
    q, p = shp["q"], shp["p"]
    t = TRAIN_BATCH * (TRAIN_SEQ // q) * (shp["di_loc"] * WORLD // p)
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        isz = torch.tensor([], dtype=dtype).element_size()
        cum = (-(rnd(t, q, dtype=torch.float32).abs() * 0.7).cumsum(1)).to(dtype)
        cb, xdt, dy = rnd(t, q, q, dtype=dtype) * 0.3, rnd(t, q, p, dtype=dtype) * 0.5, rnd(t, q, p, dtype=dtype)
        tril = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
        c32 = cum.float()
        gmat = (torch.where(tril, torch.exp(c32[:, :, None] - c32[:, None, :]), 0.0) * cb.float()).to(dtype)
        rec = _case(
            f"ssd_intra_chunk[train tile] cum{list(cum.shape)} cb{list(cb.shape)} xdt{list(xdt.shape)} "
            "(library: torch.bmm(G, xdt) on a precomputed G)", dtype,
            lambda: K.ssd_intra_chunk(cum, cb, xdt), lambda: K.ssd_intra_chunk_plain(cum, cb, xdt),
            lambda: torch.bmm(gmat, xdt), t * (2 * q * q * p + 2 * q * q), isz * t * (q + q * q + 2 * q * p),
            iters, not f32, lambda: K.ssd_intra_chunk.last_launch, ref=lambda: ssd_intra_chunk_ref(cum, cb, xdt),
        )  # fmt: skip
        del gmat

        def grads(fn, args, g):
            args = [a.detach().clone().requires_grad_(True) for a in args]
            out = fn(*args)
            out.backward(g)
            return [out.detach()] + [a.grad for a in args]

        def einsum_form(c, b, x):
            decay = torch.exp(torch.where(tril, c[:, :, None] - c[:, None, :], float("-inf")))
            return torch.einsum("tij,tij,tjp->tip", b, decay, x)

        before = K.ssd_intra_chunk.launches
        got = grads(K.ssd_intra_chunk, (cum, cb, xdt), dy)
        if K.ssd_intra_chunk.launches != before + 1:
            raise SystemExit("chip_smoke: the SSD intra-chunk Function did not launch its kernel once")
        ref = grads(einsum_form, (cum.float(), cb.float(), xdt.float()), dy.float())
        errs = {}
        for name, a, b in zip(("y", "dcum", "dcb", "dxdt"), got, ref):
            err, scale = (a.float() - b).abs().max().item(), b.abs().max().item()
            errs[name] = err
            print(f"[kernels] _SsdIntraChunk {name} {str(dtype)[6:]} at the train tile: max|err| {err:.3e} (max|ref| "
                  f"{scale:.3e}, bound {TOL[str(dtype)[6:]]:g} x max|ref|)")  # fmt: skip
            if not (bool(torch.isfinite(a).all()) and err <= TOL[str(dtype)[6:]] * scale):
                raise SystemExit(f"chip_smoke: _SsdIntraChunk's {name} ({dtype}) disagrees with float32 autograd")
        rec["function_errs"] = errs
        if f32:  # the backward's time: four float32 products and the masked decay, torch ops
            rec["backward_ms"] = cuda_ms(lambda: mamba_ssd.ssd_intra_chunk_backward(cum, cb, xdt, dy), iters)
            rec["backward_bound_ms"], rec["backward_bound_by"] = bound_ms(
                t * (4 * q * q * p + 8 * q * q), isz * t * (2 * q + 2 * q * q + 4 * q * p), dtype
            )  # fmt: skip
            print(f"[kernels] _SsdIntraChunk backward (float32 torch ops) at the train tile: "
                  f"{rec['backward_ms']:.4f} ms, bound {rec['backward_bound_ms']:.4f} ({rec['backward_bound_by']}); "
                  "no PyTorch call computes it")  # fmt: skip
        recs[("ssd_intra_chunk", ARCH_SSM, "train", dtype)] = rec
        del cum, cb, xdt, dy, got, ref
    torch.cuda.empty_cache()
    return recs


def _paper_moe_kernels(rnd, iters: int) -> dict:
    """The grouped GEMM at Fig. 9's MoE-6 (W = 8, bf16, the paper phase's
    shape): one ring step's 8 x 4 groups of ``cap`` = 208 rows, row tile 104."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_moe
    from repro_torch.configs.paper import PAPER_MOE
    from repro_torch.kernels.grouped_matmul import group_tile_table

    s, h, i, e, k = PAPER_MOE["MoE-6"]
    cap, bm = paper_moe.row_tile(PAPER_WORLD, s, k, e)
    groups, dtype = e, torch.bfloat16  # W ranks x E / W experts
    table = group_tile_table(groups, cap, torch.device("cuda", 0))
    recs = {}
    for tag, kk, n, out_dt in (("gate_up", h, 2 * i, torch.float32), ("down", i, h, dtype)):
        x, w = rnd(groups * cap, kk, dtype=dtype), rnd(groups, kk, n, dtype=dtype) * kk**-0.5
        osz = torch.tensor([], dtype=out_dt).element_size()
        recs[("grouped_matmul", "paper MoE-6", tag, dtype)] = _case(
            f"grouped_matmul[paper MoE-6 W={PAPER_WORLD} {tag}, bm {bm}] x{list(x.shape)} w{list(w.shape)} -> "
            f"{str(out_dt)[6:]}", dtype,
            lambda: K.grouped_matmul(x, w, table, out_dtype=out_dt), lambda: K.grouped_matmul_plain(x, w, table, out_dt),
            lambda: torch.bmm(x.view(groups, cap, kk), w),
            2 * x.shape[0] * kk * n, 2 * (x.numel() + w.numel()) + osz * x.shape[0] * n, iters, False,
            lambda: K.grouped_matmul.last_launch, bitwise=True, ref=lambda: _grouped_ref(x, w, table, out_dt),
        )  # fmt: skip
        del x, w
    return recs


def _ring_tile_kernels(rnd, iters: int) -> dict:
    """Flash attention on one ring step at Fig. 10's Attn-1, S 16k, W = 8
    (bf16, the wgmma route): q [8, 1, 32, 2048, 128] at rank offsets r x
    2048, the KV tiles the ring plan holds at step 1, the state of step 0
    (each rank's own tile) carried in, the output normalised.  The plain
    version runs both steps in float32 from the same inputs; the bound counts
    the pairs this step's masks leave visible; the library call is SDPA over
    the same q and tile with no offsets and no state (no PyTorch call does
    the step itself)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.configs.paper import PAPER_ATTN
    from repro_torch.core.channels import BlockChannel
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels.flash_attention import flash_attention_ranked, flash_attention_ranked_plain
    from repro_torch.kernels.ref import flash_attention_union_ref

    heads, hd, seqs = PAPER_ATTN["Attn-1"]
    w, s = PAPER_WORLD, seqs[0]
    s_loc = s // w
    q, k, v = (rnd(w, 1, heads, s_loc, hd, dtype=torch.bfloat16) for _ in range(3))
    src = [build_plan("ag_attention", BlockChannel(axis="model"), w, 1).channels[0].source_table(t) for t in (0, 1)]
    idx = [torch.tensor(t, device=q.device) for t in src]
    kt, vt = [k[i] for i in idx], [v[i] for i in idx]
    q_off = tuple(r * s_loc for r in range(w))
    k_off = [tuple(x * s_loc for x in t) for t in src]
    kw = dict(q_off=q_off, causal=True)
    st = flash_attention_ranked(q, kt[0], vt[0], k_off=k_off[0], final=False, **kw)
    f32 = [t.float() for t in (q, kt[0], vt[0], kt[1], vt[1])]
    pst = flash_attention_ranked_plain(f32[0], f32[1], f32[2], k_off=k_off[0], final=False, **kw)
    # visible (query, key) pairs of step 1 under the causal mask, per rank
    pairs = sum(
        s_loc * s_loc if ko < qo else (s_loc * (s_loc + 1) // 2 if ko == qo else 0) for qo, ko in zip(q_off, k_off[1])
    )
    isz, nq = 2, q.numel()
    nbytes = isz * (2 * nq + kt[1].numel() + vt[1].numel()) + 4 * (st.o.numel() + st.m.numel() + st.l.numel())
    qs, ks, vs = (t.reshape(w, heads, s_loc, hd) for t in (q, kt[1], vt[1]))
    rec = _case(
        f"flash_attention[ring step, Attn-1 S {s} W {w}] q{list(q.shape)} kv{list(kt[1].shape)} state in", torch.bfloat16,
        lambda: flash_attention_ranked(q, kt[1], vt[1], k_off=k_off[1], state=st, **kw),
        lambda: flash_attention_ranked_plain(f32[0], f32[3], f32[4], k_off=k_off[1], state=pst, **kw),
        lambda: F.scaled_dot_product_attention(qs, ks, vs),
        4 * heads * hd * pairs, nbytes, iters, False, lambda: K.flash_attention.last_launch, bitwise=True,
        ref=lambda: flash_attention_union_ref(q, kt, vt, q_off=q_off, k_offs=k_off, causal=True),
    )  # fmt: skip
    return {("flash_attention", "paper", "ring_step", torch.bfloat16): rec}


def _mm_kernels(rnd, iters: int) -> dict:
    """The multimodal phases' kernel shapes (W = 4): kernel #4 at
    paligemma's head dim 256 (q [W B h_loc, 512, 256] against the one KV
    head's [W B, 512, 256], causal: 256 patches + 256 tokens, B = 4), at
    seamless-m4t's encoder (non-causal, [W B h_loc, 4096, 64], B = 4) and at
    its cross-attention in training (non-causal, Sq != Sk: 256 decoder
    queries against 512 encoder keys, B = 8); each checked in float32 (the
    FMA route) and bfloat16 (the wgmma route, also held against its tiled
    twin and bitwise over REPEATS launches), timed in bf16 (head dim 256 in
    float32 too) against SDPA (``is_causal`` where causal).  Kernel #1 at both LM heads (prefill and
    decode rows); kernels #2 / #3 at both models' projections in bf16:
    paligemma's qkv, gate|up, o and down at 4 x 512 tokens, seamless-m4t's
    encoder qkv, gate|up, o and down and the cross-attention's kv gather of
    the encoder stream at 4 x 4096 frames (the serve path's encoder), each
    against its plain version (timed by the one checking call) and
    ``torch.matmul``.  Then the VLM's train-path checks at 8 x 512 tokens
    (flash attention's statistics and Function at D 256, the AG+GEMM /
    GEMM+RS Functions) and its backward transposes."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_tiled
    from repro_torch.models import frontends

    W, recs = WORLD, {}
    bf16 = torch.bfloat16
    flash = []
    for arch, tag, b, sq, sk, causal in (
        (ARCH_V, "prefill", BATCH, 2 * PROMPT, 2 * PROMPT, True),
        (ARCH_ED, "encoder", BATCH, 4096, 4096, False),
        (ARCH_ED, "cross", TRAIN_BATCH, TRAIN_SEQ, 2 * TRAIN_SEQ, False),
    ):  # fmt: skip
        flash.append((arch, tag, b, sq, sk, causal))
    for dtype in (torch.float32, bf16):
        isz = torch.tensor([], dtype=dtype).element_size()
        is_bf16 = dtype == bf16
        for arch, tag, b, sq, sk, causal in flash:
            shp = path_shapes(arch)
            hd, rep = shp["hd"], shp["h_loc"] // shp["kv_loc"]
            q = rnd(W * b * shp["h_loc"], sq, hd, dtype=dtype)
            kk, vv = rnd(W * b * shp["kv_loc"], sk, hd, dtype=dtype), rnd(W * b * shp["kv_loc"], sk, hd, dtype=dtype)
            ke, ve = kk.repeat_interleave(rep, 0)[None], vv.repeat_interleave(rep, 0)[None]
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            oracle = []  # the case's kernels/ref output, shared with the tiled-twin case

            def flash_ref(q=q, kk=kk, vv=vv, causal=causal, oracle=oracle):
                if not oracle:
                    oracle.append(_flash_ref(q, kk, vv, causal=causal))
                return oracle[0]

            recs[("flash_attention", arch, tag, dtype)] = _case(
                f"flash_attention[{arch} {tag}] q{list(q.shape)} kv{list(kk.shape)} {'causal' if causal else 'non-causal'}",
                dtype, lambda: K.flash_attention(q, kk, vv, causal=causal),
                lambda: K.flash_attention_plain(q.float(), kk.float(), vv.float(), causal=causal),
                lambda: F.scaled_dot_product_attention(q[None], ke, ve, is_causal=causal),
                4 * q.shape[0] * pairs * hd, isz * (2 * q.numel() + kk.numel() + vv.numel()), iters,
                not is_bf16 and arch != ARCH_V, lambda: K.flash_attention.last_launch, bitwise=is_bf16, plain_once=True,
                ref=flash_ref,
            )  # fmt: skip
            if is_bf16:
                _case(f"flash_attention[{arch} {tag}] vs its tiled twin", dtype,
                      lambda: K.flash_attention(q, kk, vv, causal=causal),
                      lambda: flash_attention_tiled(q, kk, vv, causal=causal), None, 0, 0, 0, True,
                      lambda: K.flash_attention.last_launch, ref=flash_ref)  # fmt: skip
            del q, kk, vv, ke, ve, oracle
            torch.cuda.empty_cache()
    for arch in (ARCH_V, ARCH_ED):
        shp = path_shapes(arch)
        # the head's rows: the VLM's prefill (4 x 512), the enc-dec's train step (8 x 256: it serves by decode_step)
        rows = BATCH * 2 * PROMPT if arch == ARCH_V else TRAIN_BATCH * TRAIN_SEQ
        recs.update(_lm_head_cases(rnd, arch, shp["d"], shp["vocab"], bf16, iters, False, rows))
        d = shp["d"]
        # the projections: paligemma's at its prefill (4 x 512), seamless-m4t's encoder at 4 x 4096 frames
        b, s = (BATCH, 2 * PROMPT) if arch == ARCH_V else (BATCH, 4096)
        s_loc = s // W
        ag = [("qkv", shp["n_qkv"]), ("gate_up", shp["n_gu"])]
        if arch == ARCH_ED:
            ag.append(("cross_kv", 2 * shp["kv_loc"] * shp["hd"]))
        for tag, n in ag:
            x, w = rnd(W, b, s_loc, d, dtype=bf16), rnd(W, d, n, dtype=bf16) * d**-0.5
            xg = x.permute(1, 0, 2, 3).reshape(b, s, d)
            recs[("ag_gemm", arch, tag, bf16)] = _case(
                f"ag_gemm[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", bf16,
                lambda: K.ag_gemm(x, w), lambda: K.ag_gemm_plain(x, w), lambda: torch.matmul(xg[None], w[:, None]),
                2 * W * b * s * d * n, 2 * (x.numel() + w.numel() + W * b * s * n), iters, False,
                lambda: K.ag_gemm.last_launch, plain_once=True, ref=lambda: R.ag_gemm_ref(x, w),
            )  # fmt: skip
        for tag, k in (("o_proj", shp["n_o"]), ("down", shp["f_loc"])):
            x, w = rnd(W, b, s, k, dtype=bf16), rnd(W, k, d, dtype=bf16) * (W * k) ** -0.5
            recs[("gemm_rs", arch, tag, bf16)] = _case(
                f"gemm_rs[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", bf16,
                lambda: K.gemm_rs(x, w), lambda: K.gemm_rs_plain(x, w), lambda: torch.matmul(x, w[:, None]).sum(0),
                2 * W * b * s * k * d, 2 * (x.numel() + w.numel() + W * b * s_loc * d), iters, False,
                lambda: K.gemm_rs.last_launch, plain_once=True, ref=lambda: R.gemm_rs_ref(x, w),
            )  # fmt: skip
        del x, w
        torch.cuda.empty_cache()
    # the VLM's train path at 8 x 512 tokens (256 patches + 256 tokens): flash attention's statistics and
    # Function at D 256, the AG+GEMM / GEMM+RS Functions; the backward's transposes
    seq = frontends.vision_prefix_len(2 * TRAIN_SEQ) + TRAIN_SEQ
    recs[("train", ARCH_V, "autograd", bf16)] = _train_autograd_checks(rnd, ARCH_V, TRAIN_BATCH, seq)
    recs.update(_train_backward_kernels(rnd, iters, ARCH_V, TRAIN_BATCH, seq, (bf16,)))
    return recs


def _e2e_kernels(rnd, iters: int, archs) -> dict:
    """Kernels #1-#4 at the e2e phase's shapes of ``archs`` (W = 4, 1 x 4096
    tokens, bf16): the forward's qkv and gate/up AG+GEMM and o / down
    GEMM+RS (every dense MLP of :func:`_mlps`: none for granite, deepseek's
    dense first layer and shared experts), flash attention (causal; gemma3's
    local layers also windowed at 1024), the LM head [4096, d] x [d, vocab],
    and the backward's transposes (:func:`_train_backward_kernels`); each
    timed against its plain version and library call, flash attention, the
    head and the transposes also launched REPEATS times bitwise.  The
    library call of causal attention is SDPA with ``is_causal``; of the
    windowed one SDPA with a boolean [S, S] mask (no flag says a window)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R
    from repro_torch.benchmarks import paper_e2e

    W, B, S, dt = WORLD, paper_e2e.BATCH, paper_e2e.SEQ, torch.bfloat16
    s_loc, isz = S // W, 2
    recs = {}
    for arch in archs:
        shp = path_shapes(arch)
        d, hd = shp["d"], shp["hd"]
        for tag, n in (("e2e_qkv", shp["n_qkv"]), *((f"e2e_{m}gate_up", gu) for m, gu, _ in _mlps(shp))):
            x, w = rnd(W, B, s_loc, d, dtype=dt), rnd(W, d, n, dtype=dt) * d**-0.5
            xg = x.permute(1, 0, 2, 3).reshape(B, S, d)
            recs[("ag_gemm", arch, tag, dt)] = _case(
                f"ag_gemm[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", dt,
                lambda: K.ag_gemm(x, w), lambda: K.ag_gemm_plain(x, w), lambda: torch.matmul(xg[None], w[:, None]),
                2 * W * B * S * d * n, isz * (x.numel() + w.numel() + W * B * S * n), iters, False,
                lambda: K.ag_gemm.last_launch, plain_once=True, ref=lambda: R.ag_gemm_ref(x, w),
            )  # fmt: skip
        for tag, k in (("e2e_o_proj", shp["n_o"]), *((f"e2e_{m}down", f) for m, _, f in _mlps(shp))):
            x, w = rnd(W, B, S, k, dtype=dt), rnd(W, k, d, dtype=dt) * (W * k) ** -0.5
            recs[("gemm_rs", arch, tag, dt)] = _case(
                f"gemm_rs[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", dt,
                lambda: K.gemm_rs(x, w), lambda: K.gemm_rs_plain(x, w), lambda: torch.matmul(x, w[:, None]).sum(0),
                2 * W * B * S * k * d, isz * (x.numel() + w.numel() + W * B * s_loc * d), iters, False,
                lambda: K.gemm_rs.last_launch, plain_once=True, ref=lambda: R.gemm_rs_ref(x, w),
            )  # fmt: skip
        rep = shp["h_loc"] // shp["kv_loc"]
        q = rnd(W * B * shp["h_loc"], S, hd, dtype=dt)
        kk, vv = rnd(W * B * shp["kv_loc"], S, hd, dtype=dt), rnd(W * B * shp["kv_loc"], S, hd, dtype=dt)
        ke, ve = kk.repeat_interleave(rep, 0)[None], vv.repeat_interleave(rep, 0)[None]
        pos = torch.arange(S, device=q.device)
        for window in _windows(arch):
            if window is None:
                pairs, tag, lib = S * (S + 1) // 2, "e2e_prefill", "SDPA is_causal"
                library = lambda: F.scaled_dot_product_attention(q[None], ke, ve, is_causal=True)  # noqa: E731
            else:
                pairs, tag, lib = window * (window + 1) // 2 + (S - window) * window, f"e2e_window{window}", "SDPA mask"
                vis = (pos[:, None] >= pos[None, :]) & ((pos[:, None] - pos[None, :]) < window)
                library = lambda m_=vis: F.scaled_dot_product_attention(q[None], ke, ve, attn_mask=m_)  # noqa: E731
            recs[("flash_attention", arch, tag, dt)] = _case(
                f"flash_attention[{arch} e2e] q{list(q.shape)} kv{list(kk.shape)} causal window {window} ({lib})", dt,
                lambda w_=window: K.flash_attention(q, kk, vv, causal=True, window=w_),
                lambda w_=window: K.flash_attention_plain(q.float(), kk.float(), vv.float(), causal=True, window=w_),
                library, 4 * q.shape[0] * pairs * hd, isz * (2 * q.numel() + kk.numel() + vv.numel()), iters, False,
                lambda: K.flash_attention.last_launch, bitwise=True,
                ref=lambda w_=window: _flash_ref(q, kk, vv, causal=True, window=w_),
            )  # fmt: skip
        x, w = rnd(B * S, d, dtype=dt), rnd(d, shp["vocab"], dtype=dt) * 0.02
        recs[("matmul", arch, "e2e_lm_head", dt)] = _case(
            f"matmul[{arch} e2e lm_head] x{list(x.shape)} w{list(w.shape)}", dt,
            lambda: K.matmul(x, w), lambda: K.matmul_plain(x, w), lambda: torch.matmul(x, w),
            2 * B * S * d * shp["vocab"], isz * (x.numel() + w.numel() + B * S * shp["vocab"]), iters, False,
            lambda: K.matmul.last_launch, bitwise=True, ref=lambda: R.matmul_ref(x, w),
        )  # fmt: skip
        del q, kk, vv, ke, ve, x, w
        recs.update(_train_backward_kernels(rnd, iters, arch, B, S, (dt,), "e2e_bwd_"))
        torch.cuda.empty_cache()
    return recs


def _moe_backward_kernels(rnd, iters: int) -> dict:
    """Kernel #5 at the MoE train path's backward shapes: dx of each expert
    GEMM is row tile t of dy times w[e[t]]^T on the same table, at granite-
    moe-3b-a800m's 40 groups (4 ranks x 10 experts) and deepseek-moe-16b's
    64 (4 x 16) of ``batch x cap`` rows: the train phases' 8 x 256 tokens
    (192 / 64 rows; records ``bwd_*``) and Fig. 11's 1 x 4096 (264 / 128;
    ``e2e_bwd_*``); dx of gate|up dy [G x R, 2f] x w^T [G, 2f, d], of down
    dy [G x R, d] x w^T [G, d, f].  float32 checked; bfloat16 timed against
    ``torch.bmm`` on the same grouped operands and launched REPEATS times
    bitwise, with the time of the contiguous w^T copy the backward makes
    from the forward's w once per layer (``wt_copy_ms``)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.configs import get_config
    from repro_torch.core.moe_overlap import _capacity
    from repro_torch.kernels.grouped_matmul import group_tile_table

    recs = {}
    for arch in (ARCH_MOE, ARCH_DS):
        shp, m = path_shapes(arch), get_config(arch).moe
        groups, d, fe = WORLD * shp["e_loc"], shp["d"], shp["fe"]
        for batch, seq, prefix in ((TRAIN_BATCH, TRAIN_SEQ, "bwd_"), (paper_e2e.BATCH, paper_e2e.SEQ, "e2e_bwd_")):
            rows = batch * _capacity(seq // WORLD, m.top_k, groups, m.capacity_factor)
            table = group_tile_table(groups, rows, torch.device("cuda", 0))
            for tag, n, k in ((prefix + "gate_up", 2 * fe, d), (prefix + "down", d, fe)):
                for dtype in (torch.float32, torch.bfloat16):
                    bf16 = dtype == torch.bfloat16
                    isz = torch.tensor([], dtype=dtype).element_size()
                    dy, wt = rnd(groups * rows, n, dtype=dtype), rnd(groups, n, k, dtype=dtype) * n**-0.5
                    recs[("grouped_matmul", arch, tag, dtype)] = _case(
                        f"grouped_matmul[{arch} {tag} dx, {groups} groups x {rows} rows] dy{list(dy.shape)} "
                        f"w^T{list(wt.shape)}", dtype,
                        lambda: K.grouped_matmul(dy, wt, table), lambda: K.grouped_matmul_plain(dy, wt, table),
                        lambda: torch.bmm(dy.view(groups, rows, n), wt),
                        2 * groups * rows * n * k, isz * (dy.numel() + wt.numel() + groups * rows * k), iters,
                        not bf16, lambda: K.grouped_matmul.last_launch, bitwise=bf16,
                        ref=lambda: _grouped_ref(dy, wt, table),
                    )  # fmt: skip
                    if bf16:
                        w = wt.transpose(1, 2).contiguous()  # the forward's layout [G, k, n]
                        rec = recs[("grouped_matmul", arch, tag, dtype)]
                        rec["wt_copy_ms"] = cuda_ms(lambda: w.transpose(1, 2).contiguous(), iters)
                        print(f"[kernels] grouped_matmul[{arch} {tag} dx] its w^T copy {list(w.shape)} -> "
                              f"{list(wt.shape)}: {rec['wt_copy_ms']:.4f} ms")  # fmt: skip
                        del w
                    del dy, wt
    torch.cuda.empty_cache()
    return recs


def _moe_train_autograd_checks(rnd, arch: str) -> dict:
    """The bf16 MoE train path's autograd Functions at ``arch``'s expert
    GEMMs (both Fig. 11's and the train phases' group rows): the grouped
    kernel's ``_GroupedMatmul`` (the overlap mode: the kernel forward and
    dx, dw one tensor-core product per group) and the tensor-core
    ``_ExpertBmm`` (the baselines), each output and gradient against float32
    autograd through the plain version, 2e-2 of max; the Function's launches
    held (forward and dx).  Returns the errors by kernel."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.benchmarks.common import fp32_reductions
    from repro_torch.configs import get_config
    from repro_torch.core import moe_overlap
    from repro_torch.kernels.grouped_matmul import group_tile_table

    shp, m = path_shapes(arch), get_config(arch).moe
    e_loc, d, fe, bf16, tol = shp["e_loc"], shp["d"], shp["fe"], torch.bfloat16, TOL["bfloat16"]
    groups = WORLD * e_loc
    errs = {"grouped_matmul": {}, "expert_bmm": {}}

    def grads(fn, a, w, dy):
        a, w = a.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
        out = fn(a, w)
        out.backward(dy)
        return [out.detach(), a.grad, w.grad]

    for batch, seq in ((TRAIN_BATCH, TRAIN_SEQ), (paper_e2e.BATCH, paper_e2e.SEQ)):
        rows = batch * moe_overlap._capacity(seq // WORLD, m.top_k, groups, m.capacity_factor)
        table = group_tile_table(groups, rows, torch.device("cuda", 0))
        for tag, k, n, out_dt in (("gate_up", d, 2 * fe, torch.float32), ("down", fe, d, bf16)):
            a, w = rnd(groups * rows, k, dtype=bf16), rnd(groups, k, n, dtype=bf16) * k**-0.5
            dy = rnd(groups * rows, n, dtype=out_dt)
            K.reset_launch_counts()
            with fp32_reductions():
                got = {"grouped_matmul": grads(lambda a_, w_: K.grouped_matmul(a_, w_, table, out_dtype=out_dt,
                                                                              group_rows=rows), a, w, dy)}  # fmt: skip
                launched = K.launch_counts()["grouped_matmul"]
                got["expert_bmm"] = grads(
                    lambda a_, w_: moe_overlap._expert_gemm(a_.view(WORLD, e_loc, rows, k), w_.view(WORLD, e_loc, k, n),
                                                            out_dt, None, False).reshape(-1, n), a, w, dy)  # fmt: skip
            ref = grads(lambda a_, w_: K.grouped_matmul_plain(a_, w_, table), a.float(), w.float(), dy.float())
            if launched != 2:
                raise SystemExit(f"chip_smoke: the grouped GEMM's Function launched {launched} kernels (forward, dx)")
            for kernel, outs in got.items():
                for name, x_, r_ in zip(("y", "dx", "dw"), outs, ref):
                    err = (x_.float() - r_).abs().max().item()
                    scale = r_.abs().max().item()
                    what = f"{kernel} Function [{tag}, {groups} groups x {rows} rows] {name}"
                    print(f"[kernels] train {arch} {what} bf16: max|err| {err:.3e} (max|ref| {scale:.3e}, bound "
                          f"{tol:g} x max|ref|)")  # fmt: skip
                    if not (bool(torch.isfinite(x_).all()) and err <= tol * scale):
                        raise SystemExit(f"chip_smoke: {arch}'s {what} (bf16) disagrees with float32 autograd")
                    errs[kernel][f"{tag} {rows} {name}"] = err
            del a, w, dy, got, ref
    torch.cuda.empty_cache()
    return {"case": f"{arch} MoE train path autograd", "dtype": "bfloat16", "max_abs_err": errs}


def _windows(arch: str) -> list:
    """The attention windows of an arch's layers (None: global), None first."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    return sorted({d.window for d in lm.layer_plan(get_config(arch))}, key=lambda w: -1 if w is None else w)


def _train_backward_kernels(rnd, iters: int, arch=ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtypes=None,
                            prefix="bwd_") -> dict:  # fmt: skip
    """The fused kernels at an arch's backward shapes in training (W = 4,
    ``batch`` x ``seq`` tokens; by default smollm-360m's in the train
    phase): the input gradients of the qkv and gate/up projections through
    GEMM+RS (dy times each rank's w^T), of the o and down projections
    through AG+GEMM (every dense MLP of :func:`_mlps`); float32 checked,
    bfloat16 timed and launched REPEATS times bitwise.  Beyond smollm's
    train shapes the plain version is timed by its one checking call."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    shp = path_shapes(arch)
    W, B, S, d = WORLD, batch, seq, shp["d"]
    s_loc, once = S // W, arch != ARCH
    recs = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        isz = torch.tensor([], dtype=dtype).element_size()
        for tag, n in ((prefix + "qkv", shp["n_qkv"]), *((f"{prefix}{m}gate_up", gu) for m, gu, _ in _mlps(shp))):
            x, w = rnd(W, B, S, n, dtype=dtype), rnd(W, n, d, dtype=dtype) * (W * n) ** -0.5
            recs[("gemm_rs", arch, tag, dtype)] = _case(
                f"gemm_rs[{arch} {tag}] dy{list(x.shape)} w^T{list(w.shape)}", dtype,
                lambda: K.gemm_rs(x, w), lambda: K.gemm_rs_plain(x, w), lambda: torch.matmul(x, w[:, None]).sum(0),
                2 * W * B * S * n * d, isz * (x.numel() + w.numel() + W * B * s_loc * d), iters, not bf16,
                lambda: K.gemm_rs.last_launch, bitwise=bf16, plain_once=once, ref=lambda: R.gemm_rs_ref(x, w),
            )  # fmt: skip
        for tag, k in ((prefix + "o_proj", shp["n_o"]), *((f"{prefix}{m}down", f) for m, _, f in _mlps(shp))):
            x, w = rnd(W, B, s_loc, d, dtype=dtype), rnd(W, d, k, dtype=dtype) * d**-0.5
            xg = x.permute(1, 0, 2, 3).reshape(B, S, d)
            recs[("ag_gemm", arch, tag, dtype)] = _case(
                f"ag_gemm[{arch} {tag}] dy{list(x.shape)} w^T{list(w.shape)}", dtype,
                lambda: K.ag_gemm(x, w), lambda: K.ag_gemm_plain(x, w), lambda: torch.matmul(xg[None], w[:, None]),
                2 * W * B * S * d * k, isz * (x.numel() + w.numel() + W * B * S * k), iters, not bf16,
                lambda: K.ag_gemm.last_launch, bitwise=bf16, plain_once=once, ref=lambda: R.ag_gemm_ref(x, w),
            )  # fmt: skip
        del x, w, xg
    return recs


def _train_autograd_checks(rnd, arch=ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ) -> dict:
    """The bf16 train path's own uses of the kernels at an arch's train
    shapes (W = 4, ``batch`` x ``seq`` tokens; by default smollm-360m's in
    the train phase), each held against its plain version: flash
    attention's forward with its statistics (o, and the log-sum-exp the
    wgmma route derives from its log2-unit state) against the plain
    version's state, at every window of the arch's layers; the gathered
    operand of AG+GEMM (read from the wgmma route's gather slots, the
    weight gradient's operand) bitwise against x in rank-major row order,
    its output bitwise the call's without it; and the autograd Functions
    (AG+GEMM, GEMM+RS, flash attention at every window: the output and
    every input's gradient) against float32 autograd through the eager
    executor / the plain attention.  The projections are qkv, o-proj and
    every dense MLP of :func:`_mlps`.  Returns the errors by kernel."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.core.channels import BlockChannel
    from repro_torch.core.compiler import compile_overlap
    from repro_torch.kernels.flash_attention import flash_attention_lse

    shp = path_shapes(arch)
    W, B, S, d, hd = WORLD, batch, seq, shp["d"], shp["hd"]
    s_loc, bf16, tol = S // W, torch.bfloat16, TOL["bfloat16"]
    world = World(W, "cuda")
    errs = {"flash_attention": {}, "ag_gemm": {}, "gemm_rs": {}}

    def hold(kernel, what, got, ref, bound):
        """bound: "bitwise", "abs" (|err| <= tol) or "rel" (|err| <= tol x max|ref|)."""
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        lim = {"bitwise": 0.0, "abs": tol, "rel": tol * max(scale, 1e-30)}[bound]
        ok = got.shape == ref.shape and bool(torch.isfinite(got).all().item()) and err <= lim
        txt = {"bitwise": "bitwise", "abs": f"bound {tol:g}", "rel": f"bound {tol:g} x max|ref|"}[bound]
        print(f"[kernels] train {arch} {what} bf16: max|err| {err:.3e} (max|ref| {scale:.3e}, {txt})")
        if not ok:
            raise SystemExit(f"chip_smoke: {arch}'s train path {what} (bf16) disagrees with its plain version: "
                             f"{err} > {lim}")  # fmt: skip
        errs[kernel][what] = err

    def grads(fn, args, dy):
        args = [a.detach().clone().requires_grad_(True) for a in args]
        out = fn(*args)
        out.backward(dy)
        return [out.detach()] + [a.grad for a in args]

    q = rnd(W * B * shp["h_loc"], S, hd, dtype=bf16)
    k, v = rnd(W * B * shp["kv_loc"], S, hd, dtype=bf16), rnd(W * B * shp["kv_loc"], S, hd, dtype=bf16)
    do = rnd(*q.shape, dtype=bf16)
    for window in _windows(arch):
        # the forward with its statistics: an lse error e scales P by e^e, so lse is held absolutely
        o, lse = flash_attention_lse(q, k, v, causal=True, window=window)
        o_p, lse_p = flash_attention_lse(*(t.float().cpu() for t in (q, k, v)), causal=True, window=window)
        fa = f"flash_attention_lse q{list(q.shape)} kv{list(k.shape)} causal window {window}"
        hold("flash_attention", f"{fa} o", o, o_p.to(o.device), "rel")
        hold("flash_attention", f"{fa} lse", lse, lse_p.to(o.device), "abs")
        del o, lse, o_p, lse_p
        K.reset_launch_counts()
        got = grads(lambda *a, w_=window: K.flash_attention(*a, causal=True, window=w_), (q, k, v), do)
        if K.launch_counts()["flash_attention"] != 1:
            raise SystemExit(f"chip_smoke: the flash attention Function launched {K.launch_counts()}")
        ref = grads(lambda *a, w_=window: K.flash_attention_plain(*a, causal=True, window=w_),
                    (q.float(), k.float(), v.float()), do.float())  # fmt: skip
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
            hold("flash_attention", f"flash_attention Function q{list(q.shape)} kv{list(k.shape)} window {window} "
                 f"{name}", a, b, "rel")  # fmt: skip
        del got, ref
    # the gathered operand: the forward's x (qkv, gate/up) and the backward's dy (o, down projections)
    mlps = _mlps(shp)
    for tag, n in (("qkv", shp["n_qkv"]), *((f"{m}gate_up", gu) for m, gu, _ in mlps), ("bwd_o_proj", shp["n_o"]),
                   *((f"bwd_{m}down", f) for m, _, f in mlps)):  # fmt: skip
        x, w = rnd(W, B, s_loc, d, dtype=bf16), rnd(W, d, n, dtype=bf16) * d**-0.5
        y, gathered = K.ag_gemm(x, w, return_gathered=True)
        what = f"ag_gemm[{tag}] x{list(x.shape)} w{list(w.shape)} return_gathered"
        hold("ag_gemm", f"{what}: gathered vs x rank-major", gathered,
             x.permute(1, 0, 2, 3).reshape(B, S, d).expand(W, B, S, d), "bitwise")  # fmt: skip
        hold("ag_gemm", f"{what}: output vs the call without it", y, K.ag_gemm(x, w), "bitwise")
    del x, w, y, gathered

    for tag, kind, xs, ws in (
        ("qkv", "ag_matmul", (W, B, s_loc, d), (W, d, shp["n_qkv"])),
        *((f"{m}gate_up", "ag_matmul", (W, B, s_loc, d), (W, d, gu)) for m, gu, _ in mlps),
        ("o_proj", "matmul_rs", (W, B, S, shp["n_o"]), (W, shp["n_o"], d)),
        *((f"{m}down", "matmul_rs", (W, B, S, f), (W, f, d)) for m, _, f in mlps),
    ):  # fmt: skip
        x, w = rnd(*xs, dtype=bf16), rnd(*ws, dtype=bf16) * ws[1] ** -0.5
        fused = compile_overlap(kind, BlockChannel(axis="model"), world=world, backend="fused")
        eager = compile_overlap(kind, BlockChannel(axis="model"), world=world, backend="eager")
        dy = rnd(*(xs[:2] + (S, ws[2]) if kind == "ag_matmul" else xs[:2] + (s_loc, d)), dtype=bf16)
        K.reset_launch_counts()
        got = grads(fused, (x, w), dy)
        counts = K.launch_counts()
        if counts["ag_gemm"] != 1 or counts["gemm_rs"] != 1:  # the forward's kernel and its transpose's
            raise SystemExit(f"chip_smoke: the {kind} Function launched {counts}")
        ref = grads(eager, (x.float(), w.float()), dy.float())
        for name, a, b in zip(("y", "dx", "dw"), got, ref):
            kernel = {("ag_matmul", "dx"): "gemm_rs", ("matmul_rs", "y"): "gemm_rs"}.get((kind, name), "ag_gemm")
            hold(kernel, f"{kind} Function [{tag}] x{list(xs)} w{list(ws)} {name}", a, b, "rel")
        del x, w, dy, got, ref
    torch.cuda.empty_cache()
    return {"case": f"{arch} train path autograd and statistics", "dtype": "bfloat16", "max_abs_err": errs}


def phase_kernels(iters: int):
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.core.channels import BlockChannel, CommSpec
    from repro_torch.kernels.flash_attention import flash_attention_tiled
    from repro_torch.kernels.grouped_matmul import group_tile_table

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    W, B, S = WORLD, BATCH, PROMPT
    s_loc = S // W
    recs = {}
    ref_s0, dev_s0 = REF_S[0], DEVICE_S[0]

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        it = iters if dtype == torch.bfloat16 else 2
        check_only = dtype != torch.bfloat16  # times are taken in the serving dtype
        isz = torch.tensor([], dtype=dtype).element_size()
        for arch in (ARCH, ARCH_MOE, ARCH_DS, ARCH_Z):
            shp = path_shapes(arch)
            d, hd = shp["d"], shp["hd"]
            # --- ag_gemm: qkv (and the dense / shared-expert gate/up) projections
            for tag, n in (("qkv", shp["n_qkv"]), ("gate_up", shp.get("n_gu")), ("shared_gate_up", shp.get("n_sgu"))):
                if n is None:
                    continue
                x, w = rnd(W, B, s_loc, d, dtype=dtype), rnd(W, d, n, dtype=dtype) * d**-0.5
                xg = x.permute(1, 0, 2, 3).reshape(B, S, d)
                recs[("ag_gemm", arch, tag, dtype)] = _case(
                    f"ag_gemm[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", dtype,
                    lambda: K.ag_gemm(x, w), lambda: K.ag_gemm_plain(x, w),
                    lambda: torch.matmul(xg[None], w[:, None]),
                    2 * W * B * S * d * n, isz * (x.numel() + w.numel() + W * B * S * n), it, check_only,
                    lambda: K.ag_gemm.last_launch, ref=lambda: R.ag_gemm_ref(x, w),
                )  # fmt: skip
            # --- gemm_rs: attention out-projection (and the dense / shared-expert down projection)
            for tag, k in (("o_proj", shp["n_o"]), ("down", shp.get("f_loc")), ("shared_down", shp.get("sf_loc"))):
                if k is None:
                    continue
                x, w = rnd(W, B, S, k, dtype=dtype), rnd(W, k, d, dtype=dtype) * (W * k) ** -0.5
                recs[("gemm_rs", arch, tag, dtype)] = _case(
                    f"gemm_rs[{arch} {tag}] x{list(x.shape)} w{list(w.shape)}", dtype,
                    lambda: K.gemm_rs(x, w), lambda: K.gemm_rs_plain(x, w),
                    lambda: torch.matmul(x, w[:, None]).sum(0),
                    2 * W * B * S * k * d, isz * (x.numel() + w.numel() + W * B * s_loc * d), it, check_only,
                    lambda: K.gemm_rs.last_launch, ref=lambda: R.gemm_rs_ref(x, w),
                )  # fmt: skip
            # --- flash attention: [W*B*h_loc, S, hd] vs [W*B*kv_loc, S, hd], causal
            rep = shp["h_loc"] // shp["kv_loc"]
            q = rnd(W * B * shp["h_loc"], S, hd, dtype=dtype)
            kk, vv = rnd(W * B * shp["kv_loc"], S, hd, dtype=dtype), rnd(W * B * shp["kv_loc"], S, hd, dtype=dtype)
            ke, ve = kk.repeat_interleave(rep, 0)[None], vv.repeat_interleave(rep, 0)[None]
            pairs = S * (S + 1) // 2
            # the plain version in f32 on the same inputs (bf16: the wgmma route)
            recs[("flash_attention", arch, "prefill", dtype)] = _case(
                f"flash_attention[{arch}] q{list(q.shape)} kv{list(kk.shape)} causal", dtype,
                lambda: K.flash_attention(q, kk, vv, causal=True),
                lambda: K.flash_attention_plain(q.float(), kk.float(), vv.float(), causal=True),
                lambda: F.scaled_dot_product_attention(q[None], ke, ve, is_causal=True),
                4 * q.shape[0] * pairs * hd, isz * (2 * q.numel() + kk.numel() + vv.numel()), it, check_only,
                lambda: K.flash_attention.last_launch, bitwise=dtype == torch.bfloat16,
                ref=lambda: _flash_ref(q, kk, vv, causal=True),
            )  # fmt: skip
            if dtype == torch.bfloat16:  # and against the twin that replays its schedule
                _case(f"flash_attention[{arch}] vs its tiled twin", dtype,
                      lambda: K.flash_attention(q, kk, vv, causal=True),
                      lambda: flash_attention_tiled(q, kk, vv, causal=True), None, 0, 0, 0, True,
                      lambda: K.flash_attention.last_launch, ref=lambda: _flash_ref(q, kk, vv, causal=True))  # fmt: skip
            recs.update(_lm_head_cases(rnd, arch, d, shp["vocab"], dtype, it, check_only))
            if "e_loc" not in shp:
                continue
            # --- grouped_matmul: the expert GEMMs of one ring step, every rank and
            # batch row in one launch: groups of B x cap rows per (rank, expert)
            e_loc, cap, fe = shp["e_loc"], shp["cap"], shp["fe"]
            table = group_tile_table(W * e_loc, B * cap, dev)
            for tag, k, n, out_dt in (("gate_up", d, 2 * fe, torch.float32), ("down", fe, d, dtype)):
                x, w = rnd(W * e_loc * B * cap, k, dtype=dtype), rnd(W * e_loc, k, n, dtype=dtype) * k**-0.5
                osz = torch.tensor([], dtype=out_dt).element_size()
                recs[("grouped_matmul", arch, tag, dtype)] = _case(
                    f"grouped_matmul[{arch} {tag}] x{list(x.shape)} w{list(w.shape)} -> {str(out_dt)[6:]}", dtype,
                    lambda: K.grouped_matmul(x, w, table, out_dtype=out_dt),
                    lambda: K.grouped_matmul_plain(x, w, table, out_dt),
                    lambda: torch.bmm(x.view(W * e_loc, B * cap, k), w),
                    2 * x.shape[0] * k * n, isz * (x.numel() + w.numel()) + osz * x.shape[0] * n, it, check_only,
                    lambda: K.grouped_matmul.last_launch, bitwise=dtype == torch.bfloat16,
                    ref=lambda: _grouped_ref(x, w, table, out_dt),
                )  # fmt: skip
            # a random, non-monotone table over 8-row tiles (below the capacity),
            # with empty tiles (-1 and E) among them
            x, w = rnd(W * e_loc * B * cap, fe, dtype=dtype), rnd(W * e_loc, fe, d, dtype=dtype) * fe**-0.5
            rand_table = torch.randint(-1, W * e_loc + 1, (x.shape[0] // 8,), generator=g, device=dev, dtype=torch.int32)
            valid = rand_table[(rand_table >= 0) & (rand_table < W * e_loc)]
            rows, used = 8 * valid.numel(), valid.unique().numel()  # the rows and weights this table reads
            recs[("grouped_matmul", arch, "random", dtype)] = _case(
                f"grouped_matmul[random table, 8-row tiles] x{list(x.shape)} w{list(w.shape)}", dtype,
                lambda: K.grouped_matmul(x, w, rand_table), lambda: K.grouped_matmul_plain(x, w, rand_table), None,
                2 * rows * fe * d, isz * (rows * fe + used * fe * d + x.shape[0] * d), it, check_only,
                lambda: K.grouped_matmul.last_launch, bitwise=dtype == torch.bfloat16,
                ref=lambda: _grouped_ref(x, w, rand_table),
            )  # fmt: skip
            del x, w

    recs.update(_mm_kernels(rnd, iters))
    recs.update(_paper_moe_kernels(rnd, iters))
    recs.update(_ring_tile_kernels(rnd, iters))
    recs.update(_ssm_kernels(rnd, iters))
    recs[("ssd_chunked", ARCH_SSM, "ref", torch.float32)] = _ssd_ref_case(rnd)
    recs.update(_ssd_train_kernels(rnd, iters))
    # the train phases' shapes (8 x 256 tokens): smollm's, the MoE models' attention and dense MLPs, and
    # zamba2's shared attention block (head dim 80) and MLP
    recs[("train", ARCH, "autograd", torch.bfloat16)] = _train_autograd_checks(rnd)
    for arch in (ARCH, ARCH_MOE, ARCH_DS, ARCH_Z):
        recs.update(_train_backward_kernels(rnd, iters, arch))
    for arch in (ARCH_MOE, ARCH_DS, ARCH_Z):
        recs[("train", arch, "autograd", torch.bfloat16)] = _train_autograd_checks(rnd, arch)
    # Fig. 11's shapes (1 x 4096 tokens): every row but smollm's (its widths are the serve phase's)
    recs.update(_e2e_kernels(rnd, iters, (*E2E_ARCHS, ARCH_MOE, ARCH_DS)))
    for arch in E2E_ARCHS:
        recs[("train", arch, "autograd", torch.bfloat16)] = _train_autograd_checks(rnd, arch, paper_e2e.BATCH, paper_e2e.SEQ)
    for arch in (ARCH_MOE, ARCH_DS):
        recs[("train", arch, "e2e_autograd", torch.bfloat16)] = _train_autograd_checks(
            rnd, arch, paper_e2e.BATCH, paper_e2e.SEQ)  # fmt: skip
    # the expert GEMMs of the train_moe and e2e phases, both passes
    recs.update(_moe_backward_kernels(rnd, iters))
    for arch in (ARCH_MOE, ARCH_DS):
        recs[("train", arch, "moe_autograd", torch.bfloat16)] = _moe_train_autograd_checks(rnd, arch)
    # --- every order x C in {1, 2} through both fused kernels at the smollm
    # shapes, in float32 and in bfloat16 (the wgmma route); each bf16 case
    # launched REPEATS times, every output bitwise equal to the first (the
    # stage order is fixed and there are no atomics, so a stale tile would show)
    shp = path_shapes(ARCH)
    d, n_qkv, n_o = shp["d"], shp["n_qkv"], shp["n_o"]
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for order in ("ring", "bidir_ring", "all2all"):
            for nch in (1, 2):
                ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
                x, w = rnd(W, B, s_loc, d, dtype=dtype), rnd(W, d, n_qkv, dtype=dtype) * d**-0.5
                _case(f"ag_gemm {order} C{nch}", dtype, lambda: K.ag_gemm(x, w, channel=ch),
                      lambda: K.ag_gemm_plain(x, w, channel=ch), None, 0, 0, 0, True,
                      lambda: K.ag_gemm.last_launch, bitwise=bf16, ref=lambda: R.ag_gemm_ref(x, w))  # fmt: skip
                x, w = rnd(W, B, S, n_o, dtype=dtype), rnd(W, n_o, d, dtype=dtype) * (W * n_o) ** -0.5
                _case(f"gemm_rs {order} C{nch}", dtype, lambda: K.gemm_rs(x, w, channel=ch),
                      lambda: K.gemm_rs_plain(x, w, channel=ch), None, 0, 0, 0, True,
                      lambda: K.gemm_rs.last_launch, bitwise=bf16, ref=lambda: R.gemm_rs_ref(x, w))  # fmt: skip
    recs.update(_peer_route_cases())
    print(f"[kernels] the holds against kernels/ref added {REF_S[0] - ref_s0:.1f} s to this phase "
          f"({REF_S[0]:.1f} s in the whole run, the quant phase's cases included); the device-time readouts "
          f"(torch.profiler) {DEVICE_S[0] - dev_s0:.1f} s ({DEVICE_S[0]:.1f} s in the whole run)")  # fmt: skip
    return recs


def peer_shapes() -> dict:
    """The fused kernels' shapes the peer route is held at (W ranks): smollm's
    qkv (AG+GEMM) and o-proj (GEMM+RS) at B x S tokens, and Tab. 2's MLP-1
    pair (S = 8192, H = 4096, I = 11008), as (kind, x shape, w shape)."""
    from repro_torch.configs.paper import PAPER_MLP

    shp = path_shapes(ARCH)
    d, W = shp["d"], WORLD
    s, h, i, _ = PAPER_MLP["MLP-1"]
    return {
        "smollm qkv": ("ag_gemm", (W, BATCH, PROMPT // W, d), (W, d, shp["n_qkv"])),
        "smollm o_proj": ("gemm_rs", (W, BATCH, PROMPT, shp["n_o"]), (W, shp["n_o"], d)),
        "MLP-1 ag": ("ag_gemm", (W, s // W, h), (W, h, i // W)),
        "MLP-1 rs": ("gemm_rs", (W, s, i // W), (W, i // W, h)),
    }


def _peer_operands(xs, ws, dtype, device, seed: int = 0):
    """Seeded operands of every rank of a peer_shapes case (made on the CPU,
    so every card and process draws the same), the weight scaled by 1 /
    sqrt(its rows x ranks)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g).to(dtype)
    w = (torch.randn(ws, generator=g) * (ws[0] * ws[1]) ** -0.5).to(dtype)
    return x.to(device), w.to(device)


def _peer_route_cases() -> dict:
    """The peer route on one card: every rank's receive region its own
    cudaMalloc (``split=True``, system scope, the pool's epochs), two calls
    on one pool without zeroing, each bitwise equal to the one-allocation
    route, the second within TOL of ``kernels/ref``; bf16 and f32.  The
    AG+GEMM cases also run ``return_gathered`` on the split pool twice, on
    two operand sets: out and gathered bitwise the one-allocation route's,
    and call 1's gathered operand (copied out of the pool) unchanged after
    call 2 overwrote the slots."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    recs = {}
    for name, (kind, xs, ws) in peer_shapes().items():
        for dtype in (torch.float32, torch.bfloat16):
            x, w = _peer_operands(xs, ws, dtype, "cuda")
            fn = getattr(K, kind)
            one = fn(x, w)
            calls = [fn(x, w, split=True) for _ in range(2)]
            launch = dict(getattr(K, kind).last_launch)
            same = [torch.equal(c, one) for c in calls]
            dn = str(dtype).removeprefix("torch.")
            oracle = getattr(R, f"{kind}_ref")(x, w)
            err = (calls[1].float() - oracle.float()).abs().max().item()
            scale = oracle.float().abs().max().item()
            print(f"[kernels] peer route {kind}[{name}] {dn} x{list(xs)} w{list(ws)}: split pool "
                  f"({launch['pool']}), 2 calls bitwise equal to the one-allocation route: {same}; vs kernels/ref "
                  f"max|err| {err:.3e} (max|oracle| {scale:.3e}, bound {TOL[dn]:g} x)")  # fmt: skip
            if launch["pool"] != "split" or not all(same) or not err <= TOL[dn] * scale:
                raise SystemExit(f"chip_smoke: the peer route of {kind} [{name}] ({dn}) failed: pool "
                                 f"{launch['pool']}, bitwise {same}, err {err} vs {TOL[dn]} x {scale}")  # fmt: skip
            rec = {"case": f"peer {kind}[{name}]", "dtype": dn, "bitwise": same, "ref_max_abs_err": err,
                   "max_abs_oracle": scale, "launch": launch}  # fmt: skip
            if kind == "ag_gemm":  # the training backward's gathered operand, copied out of the pool
                xw = [(x, w), _peer_operands(xs, ws, dtype, "cuda", seed=1)]
                split = _tp_train_calls(fn, xw, True, split=True)
                one_g = _tp_train_calls(fn, xw, True)
                same_g = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                          for a, b in zip(split["outs"], one_g["outs"])]  # fmt: skip
                print(f"[kernels] peer route {kind}[{name}] {dn} return_gathered: split pool ({split['pool']}), "
                      f"2 calls on other operands, out and gathered bitwise the one-allocation route: {same_g}; "
                      f"call 1's gathered operand unchanged after call 2: {split['survived']}")  # fmt: skip
                if split["pool"] != "split" or not all(same_g) or not split["survived"]:
                    raise SystemExit(f"chip_smoke: the peer route's return_gathered of {kind} [{name}] ({dn}) "
                                     f"failed: {same_g}, survived {split['survived']}")  # fmt: skip
                rec["gathered_bitwise"], rec["gathered_survived"] = same_g, split["survived"]
                del xw, split, one_g
            recs[(kind, "peer", name, dtype)] = rec
            del x, w, one, calls, oracle
    return recs


# ---------------------------------------------------------------------------
# tp_gpus: the TP world over one process a card
# ---------------------------------------------------------------------------

TP_WORLD = 4  # W of the tp_gpus phase: P = 4 processes over four cards (2 over two)
TP_NEW = 16  # greedy decode steps
TP_ENGINE = dict(batch=BATCH, prompt_len=PROMPT, new_tokens=TP_NEW, slots=BATCH, decode_block=TP_NEW, seed=0)
# training across the cards: (b) the depth of the float32 step and its gradients' bound against the emulated step
# (each leaf's max|diff| over its max|emulated|: f32 sums over the processes in another order); (c) the bf16
# steps at full depth (the train phase's batch and criterion); (d) Fig. 11's dense rows at ``paper_e2e.DEPTH_PROCS``,
# warm-up steps and timed pairs of each mode (``paper_e2e --procs`` times the full PAIRS)
TP_TRAIN_F32_LAYERS, TP_GRAD_RTOL = 2, 1e-5
TP_E2E_WARMUP, TP_E2E_PAIRS = 1, 2


def _greedy_logits(params, cfg, pc, prompts, new: int, routes=None):
    """``serve.greedy``'s decoding with its logits kept: tokens [B, new] and
    the float32 logits each token was the argmax of, [B, new, vocab].
    ``routes`` (a list) takes each step's MoE router calls
    (:func:`_record_router_logits`), step 0 the prefill's."""
    import torch

    from repro_torch.models import lm

    calls, restore = _record_router_logits() if routes is not None else ([], lambda: None)

    def step_done():
        if routes is not None:
            routes.append(list(calls))
            calls.clear()

    try:
        with torch.no_grad():
            lg, caches = lm.prefill(params, cfg, pc, prompts, max_len=prompts.shape[1] + new)
            rows = [lg[:, -1].float()]
            toks = [rows[-1].argmax(-1)]
            step_done()
            for i in range(new - 1):
                lg, caches = lm.decode_step(params, caches, cfg, pc, toks[-1][:, None], prompts.shape[1] + i)
                rows.append(lg[:, 0].float())
                toks.append(rows[-1].argmax(-1))
                step_done()
    finally:
        restore()
    return torch.stack(toks, 1), torch.stack(rows, 1)


def _record_router_logits():
    """Record every MoE router call of ``nn/moe`` (prefill and decode): its
    float32 router logits and top-k ids, on the CPU; returns (the list, a
    function that restores the router)."""
    import torch

    from repro_torch.nn import moe as moe_block

    calls, router = [], moe_block.moe_router

    def recording(x, w_router, **kw):
        ids, wts, aux = router(x, w_router, **kw)
        calls.append((torch.matmul(x.float(), w_router.float()).cpu(), ids.cpu()))  # moe_router's own logits
        return ids, wts, aux

    moe_block.moe_router = recording
    return calls, lambda: setattr(moe_block, "moe_router", router)


def _routing_flip(b: int, routes, ref_routes, horizon: int):
    """Row ``b``'s first MoE routing difference in steps before ``horizon``
    (each step's router calls from :func:`_record_router_logits`, the prefill's
    laid out [W, B, s_loc, E] on both sides, a decode step's [B, E]): None,
    or (step, layer, the record of its first differing token: the two
    experts swapped, their router-logit gap on each side, the token's
    max|router-logit diff| and the call's max|router logit|)."""
    for t in range(horizon):
        for layer, ((lg, ids), (ref_lg, ref_ids)) in enumerate(zip(routes[t], ref_routes[t])):
            if t == 0:  # the prefill: row b's tokens of every rank, [W * s_loc, ...]
                lg, ids, ref_lg, ref_ids = (v[:, b].reshape(-1, v.shape[-1]) for v in (lg, ids, ref_lg, ref_ids))
            else:
                lg, ids, ref_lg, ref_ids = lg[b : b + 1], ids[b : b + 1], ref_lg[b : b + 1], ref_ids[b : b + 1]
            bad = (ids != ref_ids).any(-1).nonzero()
            if not len(bad):
                continue
            i = int(bad[0])
            j = int((ids[i] != ref_ids[i]).nonzero()[0])
            a, z = int(ref_ids[i, j]), int(ids[i, j])  # the one-card run's expert, the cards'
            return t, layer, {
                "experts": (a, z), "gap_one_card": float(ref_lg[i, a] - ref_lg[i, z]),
                "gap_cards": float(lg[i, z] - lg[i, a]), "router_diff": float((lg[i] - ref_lg[i]).abs().max()),
                "router_max": float(ref_lg.abs().max()),
            }  # fmt: skip
    return None


def _hold_greedy_routed(tokens, rows, routes, ref_tokens, ref_rows, ref_routes) -> dict:
    """The MoE model's greedy tokens over the cards against the one-card
    run's (:func:`_hold_greedy`), where a routing choice may flip too.  Per
    row, while both decode the same context (up to its first differing
    token): the first step whose MoE routing differs (:func:`_routing_flip`)
    must be a near tie under rounding, its router logits differing by at
    most TOL of their max and each run's expert within twice that
    difference of the other's; the logits before that step within TOL of
    their max, and a token that differs before it a near tie of the logits
    (:func:`_hold_greedy`).  From the flip on, the logits and tokens are
    recorded, not held (another expert is another sum).  Returns the
    record."""
    new = ref_tokens.shape[1]
    rec = {"rows": []}
    for b in range(ref_tokens.shape[0]):
        diff = (tokens[b] != ref_tokens[b]).nonzero()
        horizon = int(diff[0]) + 1 if len(diff) else new  # steps that decode the same context
        flip = _routing_flip(b, routes, ref_routes, horizon)
        if flip is not None:
            t, layer, at = flip
            print(f"[tp_gpus] greedy row {b}: the first MoE routing difference at step {t} (0: the prefill), MoE "
                  f"layer {layer}: one card expert {at['experts'][0]}, the cards {at['experts'][1]}; router-logit "
                  f"gaps {at['gap_one_card']:.3e} / {at['gap_cards']:.3e}, the token's max|router-logit diff| "
                  f"{at['router_diff']:.3e} (max|router logit| {at['router_max']:.3e})")  # fmt: skip
            tie = at["gap_one_card"] <= 2 * at["router_diff"] and at["gap_cards"] <= 2 * at["router_diff"]
            if not (tie and at["router_diff"] <= TOL["bfloat16"] * at["router_max"]):
                raise SystemExit(f"chip_smoke: tp_gpus greedy row {b}: the routing flip at step {t} layer {layer} is "
                                 f"not a near tie under rounding: {at}")  # fmt: skip
        held_to = new if flip is None else flip[0]
        row = {"max_abs_logit_diff_before": 0.0, "max_abs_logit": ref_rows[b].abs().max().item()}
        if held_to:
            row = _hold_greedy(tokens[b : b + 1, :held_to], rows[b : b + 1, :held_to], ref_tokens[b : b + 1, :held_to],
                               ref_rows[b : b + 1, :held_to])["rows"][0]  # fmt: skip
        first = (tokens[b] != ref_tokens[b]).nonzero()
        row.update(first_diff=int(first[0]) if len(first) else None, held_steps=held_to,
                   routing_flip=None if flip is None else {"step": flip[0], "layer": flip[1], **flip[2]},
                   max_abs_logit_diff=(rows[b] - ref_rows[b]).abs().max().item())  # fmt: skip
        rec["rows"].append(row)
    rec["equal_rows"] = sum(r["first_diff"] is None for r in rec["rows"])
    return rec


def _hold_greedy(tokens, rows, ref_tokens, ref_rows) -> dict:
    """The greedy tokens over the cards against the one-card run's.  The
    decode runs per-rank products whose cuBLAS kernels depend on how many
    ranks a card holds (the GEMM's width), so a row's bf16 logits differ by
    rounding and a near tie may flip: at a row's first differing token each
    run's pick must lie within twice the measured logit difference of the
    other's (a flip the rounding explains), and before it the logits must
    differ by at most TOL of their max.  Returns the record."""
    import torch

    rec = {"rows": []}
    for b in range(ref_tokens.shape[0]):
        diff = (tokens[b] != ref_tokens[b]).nonzero()
        t = int(diff[0]) if len(diff) else ref_tokens.shape[1]
        before = (rows[b, :t] - ref_rows[b, :t]).abs().max().item() if t else 0.0
        row = {"first_diff": None if t == ref_tokens.shape[1] else t, "max_abs_logit_diff_before": before,
               "max_abs_logit": ref_rows[b].abs().max().item()}  # fmt: skip
        if before > TOL["bfloat16"] * row["max_abs_logit"]:
            raise SystemExit(f"chip_smoke: tp_gpus greedy row {b}: logits differ by {before} before any token does")
        if row["first_diff"] is not None:
            a, z = int(ref_tokens[b, t]), int(tokens[b, t])
            noise = (rows[b, t] - ref_rows[b, t]).abs().max().item()
            gaps = (ref_rows[b, t, a] - ref_rows[b, t, z]).item(), (rows[b, t, z] - rows[b, t, a]).item()
            row.update(one_card=a, cards=z, gap_one_card=gaps[0], gap_cards=gaps[1], logit_diff=noise)
            print(f"[tp_gpus] greedy row {b} first differs at token {t}: one card {a}, the cards {z}; top-2 gaps "
                  f"{gaps[0]:.3e} / {gaps[1]:.3e}, the step's max|logit diff| {noise:.3e} (a flip allowed within "
                  f"twice it)")  # fmt: skip
            if not (gaps[0] <= 2 * noise and gaps[1] <= 2 * noise):
                raise SystemExit(f"chip_smoke: tp_gpus greedy row {b} token {t}: not a near tie, {row}")
        rec["rows"].append(row)
    rec["equal_rows"] = sum(r["first_diff"] is None for r in rec["rows"])
    return rec


def _tp_gpus_worker(tp, spec: dict) -> dict:
    """One process of the tp_gpus phase (``launch/serve.run_tp``): its held
    ranks' fused AG+GEMM / GEMM+RS outputs (two calls each), smollm-360m's
    f32 prefill (logits on process 0, the launches and the world's payload
    on each), the bf16 greedy tokens and the serve CLI's engine
    (``serve.serve_tp``), then Fig. 8 / Tab. 2 rows; the world's payload
    counted over the greedy decode (its psums: the fused kernels' pushes
    are no World collective)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_mlp
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    dev, lo, hi = tp.device, tp.rank0, tp.rank0 + tp.held
    out = {"card": torch.cuda.get_device_name(dev), "rank0": lo, "held": tp.held, "fused": {}}
    for name, (kind, xs, ws) in spec["shapes"].items():
        for dn in ("float32", "bfloat16"):
            x, w = _peer_operands(xs, ws, getattr(torch, dn), dev)
            x, w = x[lo:hi].contiguous(), w[lo:hi].contiguous()
            fn = getattr(K, kind)
            a, b = fn(x, w, world=tp), fn(x, w, world=tp)
            out["fused"][(name, dn)] = {"out": a.cpu(), "twice": torch.equal(a, b),
                                        "launch": dict(fn.last_launch)}  # fmt: skip
            del x, w, a, b
    cfg = get_config(ARCH)
    pc = ParallelContext(world=tp)
    prompts = torch.as_tensor(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, 0), device=dev)
    params = lm.init(cfg, tp, torch.Generator(device=dev).manual_seed(0), torch.float32)
    K.reset_launch_counts()
    with torch.no_grad():
        logits, _ = lm.prefill(params, cfg, pc, prompts, max_len=PROMPT + TP_NEW)
    torch.cuda.synchronize(dev)
    out["prefill_launches"] = K.launch_counts()
    out["logits"] = logits.cpu() if tp.procs.rank == 0 else None
    out["logits_sum"] = float(logits.double().sum())
    del params, logits
    params = lm.init(cfg, tp, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    with torch.no_grad(), tp.counting() as counter:
        tokens, timing = serve.greedy(params, cfg, pc, prompts, TP_NEW)
    out["greedy_s"] = timing
    out["greedy_payload"] = {k: dict(v) for k, v in counter.payload.items() if v}
    toks, rows = _greedy_logits(params, cfg, pc, prompts, TP_NEW)
    if not torch.equal(toks, tokens):
        raise SystemExit(f"chip_smoke: tp_gpus process {tp.procs.rank}: serve.greedy and its replay disagree")
    out["greedy"] = toks.cpu()
    out["greedy_logits"] = rows.cpu() if tp.procs.rank == 0 else None
    del params
    torch.cuda.empty_cache()
    out["engine"] = serve.serve_tp(tp, ARCH, dict(spec["engine"], world=TP_WORLD, dtype="bf16", reduce=False,
                                                  temperature=0.0, top_k=0, eos_id=None, moe_stream=False,
                                                  mode="overlap", ckpt_dir=None))  # fmt: skip
    torch.cuda.empty_cache()
    out["paper"] = paper_mlp.process_rows(tp, spec["paper"])
    torch.cuda.empty_cache()
    out["train"] = _tp_train_worker(tp, spec["train"])
    torch.cuda.empty_cache()
    out["moe"] = _tp_moe_worker(tp, spec["moe"])
    return out


def tp_train_cases() -> dict:
    """The fused ops of smollm's train step at its train shapes (W ranks,
    TRAIN_BATCH x TRAIN_SEQ tokens) as the peer route runs them: each
    forward AG+GEMM with the gathered operand the backward keeps (qkv), and
    the backward's transposes, dx of qkv and gate|up through GEMM+RS, of the
    o and down projections through AG+GEMM with its gathered dy; as
    (kind, x shape, w shape, return_gathered)."""
    shp = path_shapes(ARCH)
    W, B, S, d = WORLD, TRAIN_BATCH, TRAIN_SEQ, shp["d"]
    return {
        "fwd qkv": ("ag_gemm", (W, B, S // W, d), (W, d, shp["n_qkv"]), True),
        "bwd qkv": ("gemm_rs", (W, B, S, shp["n_qkv"]), (W, shp["n_qkv"], d), False),
        "bwd gate_up": ("gemm_rs", (W, B, S, shp["n_gu"]), (W, shp["n_gu"], d), False),
        "bwd o_proj": ("ag_gemm", (W, B, S // W, d), (W, d, shp["n_o"]), True),
        "bwd down": ("ag_gemm", (W, B, S // W, d), (W, d, shp["f_loc"]), True),
    }


# the backward's fused ops timed across the cards: smollm's train shapes and Fig. 11's three dense models at 1 x 4096
TP_TIME_ARCHS = ((ARCH, TRAIN_BATCH, TRAIN_SEQ), ("qwen2-72b", 1, 4096), ("starcoder2-7b", 1, 4096), (ARCH_G, 1, 4096))


def tp_time_cases() -> dict:
    """The backward transposes of the train step per model of TP_TIME_ARCHS,
    (arch, tag) -> (kind, x shape, w shape): dx of qkv and gate|up through
    GEMM+RS (dy times each rank's w^T), dx of the o and down projections
    through AG+GEMM with the gathered dy the weight gradient reads."""
    out = {}
    for arch, b, seq in TP_TIME_ARCHS:
        shp = path_shapes(arch)
        W, d = WORLD, shp["d"]
        out[(arch, "bwd qkv")] = ("gemm_rs", (W, b, seq, shp["n_qkv"]), (W, shp["n_qkv"], d))
        out[(arch, "bwd gate_up")] = ("gemm_rs", (W, b, seq, shp["n_gu"]), (W, shp["n_gu"], d))
        out[(arch, "bwd o_proj")] = ("ag_gemm", (W, b, seq // W, d), (W, d, shp["n_o"]))
        out[(arch, "bwd down")] = ("ag_gemm", (W, b, seq // W, d), (W, d, shp["f_loc"]))
    return out


def _tp_kernel_times(tp) -> dict:
    """This card's times of :func:`tp_time_cases` in bf16 (CUDA events, median
    of ITERS): the fused op on the peer route (an AG+GEMM also with
    ``return_gathered``, as the backward calls it: the difference is the
    gathered operand's copy out of the pool) and the same function as
    cuBLAS + NCCL (``core/overlap``'s baselines over the World's
    collectives), the fused output held within TOL of it; the bound of this
    card's share."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks.common import bound_ms, event_ms, fp32_reductions
    from repro_torch.core import overlap as ov

    dev, lo, hi = tp.device, tp.rank0, tp.rank0 + tp.held
    bf16, out = torch.bfloat16, {}
    with torch.no_grad(), fp32_reductions():
        for key, (kind, xs, ws) in tp_time_cases().items():
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn(xs, generator=g, device=dev).to(bf16)[lo:hi].contiguous()
            w = (torch.randn(ws, generator=g, device=dev) * (ws[0] * ws[1]) ** -0.5).to(bf16)[lo:hi].contiguous()
            fn = getattr(K, kind)
            base = ov.ag_matmul_baseline if kind == "ag_gemm" else ov.matmul_rs_baseline
            fused, ref = fn(x, w, world=tp), base(x, w, world=tp)
            err = (fused.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rec = {"ms": event_ms(lambda: fn(x, w, world=tp), ITERS)[0],
                   "nccl_ms": event_ms(lambda: base(x, w, world=tp), ITERS)[0], "max_abs_err": err,
                   "max_abs_ref": scale, "pool": fn.last_launch["pool"]}  # fmt: skip
            if kind == "ag_gemm":
                rec["gathered_ms"] = event_ms(lambda: fn(x, w, world=tp, return_gathered=True), ITERS)[0]
                rows = xs[1] * xs[2] * WORLD  # every rank's rows, gathered on each held rank
                flops, nbytes = 2 * tp.held * rows * xs[3] * ws[2], 2 * (rows * xs[3] + w.numel() + fused.numel())
            else:
                flops, nbytes = 2 * x.numel() * ws[2], 2 * (x.numel() + w.numel() + fused.numel())
            rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, bf16)
            out[key] = rec
            del x, w, fused, ref
            torch.cuda.empty_cache()
    return out


def _hold_tp_kernel_times(got: list, procs: int, fail: list) -> dict:
    """Each case's times from its slowest card, the fused output's error
    against cuBLAS + NCCL held within TOL of max."""
    out = {}
    for key in got[0]["train"]["times"]:
        recs = [g["train"]["times"][key] for g in got]
        row = {k: max(r[k] for r in recs) for k in ("ms", "nccl_ms", "max_abs_err", "max_abs_ref")}
        row.update(bound_ms=recs[0]["bound_ms"], bound_by=recs[0]["bound_by"], pools=[r["pool"] for r in recs])
        if "gathered_ms" in recs[0]:
            row["gathered_ms"] = max(r["gathered_ms"] for r in recs)
        kind, xs, ws = tp_time_cases()[key]
        gath = f", with return_gathered {row['gathered_ms']:.4f}" if "gathered_ms" in row else ""
        print(f"[tp_gpus] peer route {kind}[{key[0]} {key[1]}] x{list(xs)} w{list(ws)} bf16 over {procs} cards "
              f"(the slowest card): {row['ms']:.4f} ms{gath}, cuBLAS + NCCL {row['nccl_ms']:.4f} ms, a card's bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max|err| {row['max_abs_err']:.3e} (bound "
              f"{TOL['bfloat16']:g} x {row['max_abs_ref']:.3e})")  # fmt: skip
        if not row["max_abs_err"] <= TOL["bfloat16"] * row["max_abs_ref"] or set(row["pools"]) != {"procs"}:
            fail.append(f"peer route {kind} {key}: err {row['max_abs_err']} vs {row['max_abs_ref']}, {row['pools']}")
        out[f"{kind} {key[0]} {key[1]}"] = dict(row, x=list(xs), w=list(ws))
    return out


def _tp_train_calls(fn, xw: list, gathered: bool, world=None, lo: int = 0, hi=None, split: bool = False) -> dict:
    """Two calls of a fused wrapper on one pool (``world``'s over processes,
    the ``split`` pool on one card, else the one-allocation route), each on
    its own operands (the ranks ``lo:hi`` of each pair): both outputs (and
    gathered operands) on the CPU, and whether call 1's gathered operand was
    still what it was after call 2 overwrote the pool's slots."""
    import torch

    kw = {"world": world} if world is not None else {}
    if split:
        kw["split"] = True
    if gathered:
        kw["return_gathered"] = True
    res, kept = [], None
    for i, (x, w) in enumerate(xw):
        r = fn(x[lo:hi].contiguous(), w[lo:hi].contiguous(), **kw)
        res.append(r if gathered else (r, None))
        if i == 0 and gathered:
            kept = r[1].clone()
    outs = [(o.cpu(), None if g is None else g.cpu()) for o, g in res]
    return {"outs": outs, "survived": None if kept is None else torch.equal(res[0][1], kept),
            "pool": fn.last_launch["pool"]}  # fmt: skip


def _tp_train_worker(tp, spec: dict) -> dict:
    """The training part of a tp_gpus process: (a) the fused ops at
    smollm's train shapes on the peer route (:func:`tp_train_cases`, two
    calls a pool, both dtypes); (b) the float32 step's loss and gradients
    at TP_TRAIN_F32_LAYERS (``training.steps.tp_procs_grads``: the kv sync,
    the masks, the norms summed over the processes); (c) TRAIN_STEPS bf16
    steps of smollm-360m at full depth through ``launch/train.train_tp``
    and a checkpoint resumed.  (d), Fig. 11's dense rows, runs in a spawn
    of its own (:func:`_hold_tp_e2e`)."""
    import shutil

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import peer
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.steps import tp_procs_grads

    dev, lo, hi = tp.device, tp.rank0, tp.rank0 + tp.held
    out = {"fused": {}}

    # (a)
    for name, (kind, xs, ws, gathered) in tp_train_cases().items():
        for dn in ("float32", "bfloat16"):
            xw = [_peer_operands(xs, ws, getattr(torch, dn), dev, seed) for seed in (0, 1)]
            out["fused"][(name, dn)] = _tp_train_calls(getattr(K, kind), xw, gathered, tp, lo, hi)
            del xw
    out["times"] = _tp_kernel_times(tp)
    # (b)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TP_TRAIN_F32_LAYERS)
    pc = ParallelContext(world=tp)
    params = lm.init(cfg, tp, torch.Generator(device=dev).manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    K.reset_launch_counts()
    loss, _, _, grads, gnorm = tp_procs_grads(lm, cfg, pc, params, batch, grad_masks=lm.grad_masks(cfg, pc))
    torch.cuda.synchronize(dev)
    out["f32"] = {"loss": loss.cpu(), "gnorm": gnorm.cpu(), "grads": [g.cpu() for g in _leaves(grads)],
                  "roles": _leaves(lm.proc_roles(grads, cfg)), "launches": K.launch_counts()}  # fmt: skip
    del params, grads
    torch.cuda.empty_cache()
    # (c), its own receive pools alone on the card (the cases above made theirs at other shapes)
    peer.release(tp.procs.barrier)
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduce=False, layers=None, mode="overlap",
              remat="none", ckpt_dir=None, ckpt_every=0, lr=3e-4, dtype="bf16", world=TP_WORLD, log_every=10,
              resume=False, time_data=False)  # fmt: skip
    out["bf16"] = train_cli.train_tp(tp, ARCH, kw)
    out["bf16"]["pool_bytes"] = peer.pool_bytes(dev)  # the train step's receive pools on this card
    torch.cuda.empty_cache()
    d = spec["ckpt_dir"]
    ck = dict(kw, layers=TRAIN_CKPT_LAYERS, steps=TRAIN_CKPT_AT + 1, ckpt_dir=d, ckpt_every=TRAIN_CKPT_AT,
              log_every=100, resume=True)  # fmt: skip
    ref = train_cli.train_tp(tp, ARCH, ck)
    tp.procs.barrier()
    if tp.procs.rank == 0:  # the uninterrupted run's final checkpoint; the resume takes step TRAIN_CKPT_AT
        shutil.rmtree(Path(d) / f"step_{TRAIN_CKPT_AT + 1:08d}")
    tp.procs.barrier()
    resumed = train_cli.train_tp(tp, ARCH, dict(ck, ckpt_every=0))
    out["resume"] = {"ref": ref["history"], "resumed": resumed["history"]}
    torch.cuda.empty_cache()
    return out


def _leaves(tree) -> list:
    from repro_torch.training.optimizer import tree_leaves

    return tree_leaves(tree)


def _tp_train_refs(dev) -> dict:
    """The emulated W on card 0 for the tp_gpus training checks: (a) each
    case's two calls on the one-allocation route; (b) the float32 step's loss
    and gradients, fused (the kv sync and the masks applied) and eager."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import apply_masks, global_norm
    from repro_torch.training.steps import loss_and_grads

    refs = {"fused": {}}
    for name, (kind, xs, ws, gathered) in tp_train_cases().items():
        for dn in ("float32", "bfloat16"):
            xw = [_peer_operands(xs, ws, getattr(torch, dn), dev, seed) for seed in (0, 1)]
            refs["fused"][(name, dn)] = _tp_train_calls(getattr(K, kind), xw, gathered)
            del xw
    one = World(TP_WORLD, dev)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TP_TRAIN_F32_LAYERS)
    params = lm.init(cfg, one, torch.Generator(device=dev).manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    for backend in ("fused", "eager"):
        pc = ParallelContext(world=one, backend=backend)
        loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, batch)
        grads = apply_masks(lm.sync_grads(grads, cfg, pc), lm.grad_masks(cfg, pc))
        refs[f"f32 {backend}"] = {"loss": loss.cpu(), "gnorm": global_norm(grads).cpu(),
                                  "grads": [g.cpu() for g in _leaves(grads)]}  # fmt: skip
        del grads
    del params
    torch.cuda.empty_cache()
    return refs


def _hold_tp_train(got: list, refs: dict, procs: int, fail: list) -> dict:
    """The tp_gpus training holds (:func:`_tp_train_worker`), each failure
    appended to ``fail`` (the phase raises after printing every one)."""
    import torch

    from repro_torch.benchmarks import paper_e2e
    from repro_torch.configs import get_config

    held = TP_WORLD // procs
    out = {}
    # (a) the fused ops' backward on the peer route
    n, bad = 0, []
    for key, want in refs["fused"].items():
        for p, g in enumerate(got):
            r = g["train"]["fused"][key]
            for call, ((o, gg), (wo, wg)) in enumerate(zip(r["outs"], want["outs"])):
                n += 1
                same = torch.equal(o, wo[p * held : (p + 1) * held])
                if gg is not None:
                    same = same and torch.equal(gg, wg[p * held : (p + 1) * held])
                if not same:
                    bad.append((key, p, call))
            if r["pool"] != "procs" or r["survived"] is False:
                bad.append((key, p, r["pool"], r["survived"]))
    print(f"[tp_gpus] train shapes (smollm {TRAIN_BATCH} x {TRAIN_SEQ}): {n} (case, dtype, process, call) outputs of "
          f"the forward AG+GEMM and the backward's GEMM+RS / AG+GEMM, with the gathered operands, bitwise the "
          f"emulated W = {TP_WORLD} on card 0: {n - len(bad)} of {n}; two calls a pool, call 1's gathered operand "
          f"unchanged after call 2 on every AG+GEMM case")  # fmt: skip
    if bad:
        fail.append(f"train-shape fused ops differ from the emulated run: {bad[:6]}")
    out["fused_bitwise"] = [n - len(bad), n]
    out["times"] = _hold_tp_kernel_times(got, procs, fail)
    # (b) the float32 step against the emulated step (fused) and the eager step
    f32 = [g["train"]["f32"] for g in got]
    emu, eag = refs["f32 fused"], refs["f32 eager"]
    roles = f32[0]["roles"]
    losses = [float(r["loss"]) for r in f32]
    loss_bitwise = all(torch.equal(r["loss"], emu["loss"]) for r in f32)
    worst_emu = worst_eag = 0.0
    bitwise_leaves, grad_bad = {}, []
    for p, r in enumerate(f32):
        for i, (g, role) in enumerate(zip(r["grads"], roles)):
            e, q = emu["grads"][i], eag["grads"][i]
            if role == "held":
                e, q = e[p * held : (p + 1) * held], q[p * held : (p + 1) * held]
            rel_e = (g - e).abs().max().item() / max(e.abs().max().item(), 1e-30)
            rel_q = (g - q).abs().max().item() / max(q.abs().max().item(), 1e-30)
            worst_emu, worst_eag = max(worst_emu, rel_e), max(worst_eag, rel_q)
            bitwise_leaves.setdefault(role, []).append(bool(torch.equal(g, e)))
            if not (torch.isfinite(g).all() and rel_e <= TP_GRAD_RTOL and rel_q <= GRAD_RTOL):
                grad_bad.append((p, i, role, rel_e, rel_q))
    same_rep = all(torch.equal(a, b) for r in f32[1:] for a, b, role in zip(r["grads"], f32[0]["grads"], roles)
                   if role != "held")  # fmt: skip
    bit = {role: f"{sum(v)} of {len(v)}" for role, v in bitwise_leaves.items()}
    print(f"[tp_gpus] f32 step over {procs} cards ({TP_TRAIN_F32_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ}): loss "
          f"by process {losses}, emulated {float(emu['loss'])!r} (bitwise: {loss_bitwise}), eager "
          f"{float(eag['loss'])!r}; gradients vs the emulated step worst max|diff| / max|leaf| {worst_emu:.3e} "
          f"(bound {TP_GRAD_RTOL:g}), vs eager {worst_eag:.3e} (bound {GRAD_RTOL:g}); leaves bitwise the emulated "
          f"step's by role (process x leaf) {bit}; the replicated leaves equal on every process: {same_rep}; grad "
          f"norm {float(f32[0]['gnorm']):.6f} / emulated {float(emu['gnorm']):.6f}; launches of the step per process "
          f"{f32[0]['launches']}")  # fmt: skip
    if not loss_bitwise or grad_bad or not same_rep:
        fail.append(f"f32 step: loss bitwise {loss_bitwise}, gradients {grad_bad[:6]}, replicated equal {same_rep}")
    out["f32"] = {"losses": losses, "loss_bitwise": loss_bitwise, "grad_rel_err_emulated": worst_emu,
                  "grad_rel_err_eager": worst_eag, "bitwise_leaves": bit, "replicated_equal": same_rep}  # fmt: skip
    # (c) bf16 at full depth: launches, the ce's fall, ms, tokens/s, peak per card; the resume
    cfg = get_config(ARCH)
    expect = paper_e2e.expected_launches(cfg, "overlap")
    runs = [g["train"]["bf16"] for g in got]
    hist = runs[0]["history"]
    steps_bad = [(r["step"], r["launches"]) for r in hist if r["launches"] != expect]
    totals_bad = [p for p, r in enumerate(runs) if r["launches"] != {k: v * TRAIN_STEPS for k, v in expect.items()}]
    ce = [r["ce"] for r in hist]
    first, last = sum(ce[:5]) / 5, sum(ce[-5:]) / 5
    ms = [r["ms"] for r in hist[TRAIN_WARMUP:]]
    med = _median(ms)
    peaks = [r["peak_bytes"] for r in runs]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[tp_gpus] bf16 {ARCH} ({cfg.n_layers} layers) W = {TP_WORLD} over {procs} cards, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: launches a process a step {hist[0]['launches']} (expected {expect}; every "
          f"step of process 0, every process's total), mean ce of the first 5 steps {first:.4f}, of the last 5 "
          f"{last:.4f} (held: more than 0.2 lower); step {med:.2f} ms (median of steps {TRAIN_WARMUP}-"
          f"{TRAIN_STEPS - 1}, CUDA events on card 0), {TRAIN_BATCH * TRAIN_SEQ / (med / 1e3):.0f} tokens/s, peak "
          f"memory by card {[round(b / 2**20) for b in peaks]} MiB, of it the receive pools "
          f"{[round(r['pool_bytes'] / 2**20, 1) for r in runs]} MiB")  # fmt: skip
    if steps_bad or totals_bad or not last < first - 0.2 or not all(map(math.isfinite, ce)) or max(peaks) >= total:
        fail.append(f"bf16 train: launches {steps_bad[:3]} / processes {totals_bad}, ce {first} -> {last}, peak {peaks}")
    out["bf16"] = {"ce": ce, "step_ms": [r["ms"] for r in hist], "median_step_ms": med,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3), "peak_bytes": peaks, "per_step": expect,
                   "counts": runs[0]["launches"], "pool_bytes": [r["pool_bytes"] for r in runs]}  # fmt: skip
    res = got[0]["train"]["resume"]
    a, b = res["ref"][-1], res["resumed"]
    ok = len(b) == 1 and b[0]["step"] == a["step"] and b[0]["loss"] == a["loss"]
    print(f"[tp_gpus] checkpoint at step {TRAIN_CKPT_AT} over {procs} cards ({TRAIN_CKPT_LAYERS} layers, bf16; every "
          f"process's slices gathered, process 0 writes), resumed: step {a['step']} loss {a['loss']!r} "
          f"uninterrupted, {b[0]['loss']!r} resumed (held bitwise)")  # fmt: skip
    if not ok:
        fail.append(f"resume: {a} vs {b}")
    out["resume"] = {"loss": a["loss"], "resumed_loss": b[0]["loss"]}
    return out


# Fig. 11's rows in the tp_gpus phase's (d) (dense, smallest first, so a row that fails leaves the smaller ones read)
# and (i) (the MoE rows, last)
TP_E2E_ARCHS = (ARCH, "starcoder2-7b", ARCH_G, "qwen2-72b", ARCH_MOE, ARCH_DS)


def _hold_tp_e2e(procs: int, fail: list) -> dict:
    """(d) and (i): Fig. 11's rows at ``paper_e2e.DEPTH_PROCS`` over the cards
    (``paper_e2e.procs_rows``, a spawn of its own, TP_E2E_WARMUP warm-up
    steps and TP_E2E_PAIRS timed pairs a mode): launches a process a step
    equal to ``expected_launches``, the first-step losses within the
    logits' bound, the step losses equal on every process, peak under the
    card's memory; failures appended to ``fail``."""
    import torch

    from repro_torch.benchmarks import paper_e2e

    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for row in paper_e2e.procs_rows(procs, TP_E2E_ARCHS, pairs=TP_E2E_PAIRS, warmup=TP_E2E_WARMUP):
        arch = row["arch"]
        cfg = paper_e2e.e2e_config(arch, row["layers"])
        print(f"[tp_gpus] {paper_e2e.describe(row)}; peak by card "
              f"{[round(b / 2**30, 2) for b in row['peak_bytes_by_card']]} GiB, the receive pools by card "
              f"{[round(b / 2**20, 1) for b in row['pool_bytes_by_card']]} MiB")  # fmt: skip
        for mode in paper_e2e.MODES:
            expect = paper_e2e.expected_launches(cfg, mode)
            if any(c != expect for steps in row["launches_by_card"] for c in steps[mode]):
                fail.append(f"Fig. 11 {arch} {mode}: launches {row['launches'][mode][:2]}, expected {expect}")
        first = row["first_loss"]
        diff = abs(first["overlap"] - first["baseline"])
        if not (math.isfinite(first["overlap"]) and diff <= LOGIT_ATOL + LOGIT_RTOL * abs(first["baseline"])):
            fail.append(f"Fig. 11 {arch}: first-step losses {first}")
        if max(row["peak_bytes_by_card"]) >= total or not row["step_loss_equal"]:
            fail.append(f"Fig. 11 {arch}: peak {row['peak_bytes_by_card']}, step losses equal across processes "
                        f"{row['step_loss_equal']}")  # fmt: skip
        out[arch] = row
    return out


def phase_tp_gpus(smi: str) -> dict:
    """The TP world over one process a card (``World(..., procs=)``), W = 4
    over P = 4 cards (P = 2 on two): each rank's fused outputs bitwise equal
    to the same W emulated on card 0, in bf16 and f32; smollm-360m's f32
    prefill within the logits' bound of the emulated prefill; the bf16
    greedy tokens against the one-card run's, and the engine's
    (``launch/serve``'s per-process path, stepping eagerly) recorded against
    the one-card engine's; the launches of each
    process equal to the one-card run's; the world's payload per rank equal
    to the one-process World's; Fig. 8 / Tab. 2 rows over the cards (overlap
    against NCCL non-overlap) and ``nvidia-smi topo -m``.  The greedy tokens
    are held to the one-card run's up to near ties (:func:`_hold_greedy`).
    Then training across the cards (:func:`_tp_train_worker`, held by
    :func:`_hold_tp_train`): the fused ops at smollm's train shapes on the
    peer route, forward and backward with the gathered operands, bitwise the
    emulated run (two calls a pool, call 1's gathered operand surviving
    call 2); the float32 step at 2 layers against the emulated step (loss
    bitwise, each gradient TP_GRAD_RTOL of its leaf's max) and the eager
    step (GRAD_RTOL); 30 bf16 AdamW steps of smollm-360m at 32 layers
    (launches a process a step 128 / 128 / 32 / 1, the ce's fall, step ms,
    tokens/s, peak per card) and a checkpoint resumed bitwise; Fig. 11's
    dense rows at ``paper_e2e.DEPTH_PROCS`` (launches a process a step,
    first-step losses within the logits' bound, peak under the card's
    memory).  On one card it prints that it did not run and nothing else."""
    import subprocess
    import tempfile

    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_mlp
    from repro_torch.configs import get_config
    from repro_torch.configs.paper import PAPER_MLP
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"tp_gpus: not run: {cards} card visible")
        return {"run": False, "cards": cards}
    import chip_smoke as this  # the processes import the worker by this module's name, not __main__

    procs = 4 if cards >= 4 else 2
    # the topology as read: nvidia-smi may refuse topo in a sandbox (its output and code are recorded), and the
    # peer access the kernels' IPC mappings need is read from the driver
    res = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    topo = f"rc {res.returncode}: {(res.stdout + res.stderr).strip()}"
    peers = [[q == r or torch.cuda.can_device_access_peer(q, r) for r in range(procs)] for q in range(procs)]
    print(f"[tp_gpus] {cards} cards visible; W = {TP_WORLD} over P = {procs}; nvidia-smi topo -m: {topo}; "
          f"peer access (torch.cuda.can_device_access_peer) {peers}")  # fmt: skip
    if not all(all(row) for row in peers):
        raise SystemExit(f"chip_smoke: tp_gpus: the cards lack peer access: {peers}")
    every = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()  # fmt: skip
    print(f"[tp_gpus] nvidia-smi, every card:\n{every}")
    # the same W emulated on card 0
    dev = torch.device("cuda", 0)
    one = World(TP_WORLD, dev)
    shapes = peer_shapes()
    ref = {}
    for name, (kind, xs, ws) in shapes.items():
        for dn in ("float32", "bfloat16"):
            x, w = _peer_operands(xs, ws, getattr(torch, dn), dev)
            ref[(name, dn)] = getattr(K, kind)(x, w).cpu()
            del x, w
    cfg = get_config(ARCH)
    pc = ParallelContext(world=one)
    prompts = torch.as_tensor(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, 0), device=dev)
    params = lm.init(cfg, one, torch.Generator(device=dev).manual_seed(0), torch.float32)
    K.reset_launch_counts()
    with torch.no_grad():
        ref_logits, _ = lm.prefill(params, cfg, pc, prompts, max_len=PROMPT + TP_NEW)
    torch.cuda.synchronize(dev)
    ref_launches = K.launch_counts()
    ref_logits = ref_logits.cpu()
    del params
    params = lm.init(cfg, one, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    with torch.no_grad(), one.counting() as counter:
        _, ref_timing = serve.greedy(params, cfg, pc, prompts, TP_NEW)
    ref_payload = {k: dict(v) for k, v in counter.payload.items() if v}
    ref_tokens, ref_rows = (t.cpu() for t in _greedy_logits(params, cfg, pc, prompts, TP_NEW))
    del params
    ref_engine = serve.serve("smollm-360m", world=TP_WORLD, dtype="bf16", device=dev, **TP_ENGINE)
    torch.cuda.empty_cache()
    train_refs = _tp_train_refs(dev)
    moe_refs = _tp_moe_refs(dev)
    # the processes, one a card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp-ckpt-") as ckpt_dir:
        spec = {"shapes": shapes, "engine": TP_ENGINE, "paper": list(PAPER_MLP), "train": {"ckpt_dir": ckpt_dir},
                "moe": {"engine": TP_ENGINE}}  # fmt: skip
        got = serve.run_tp(this._tp_gpus_worker, TP_WORLD, procs, dev, args=(spec,))
    spawn_s = time.perf_counter() - t0
    held = TP_WORLD // procs
    out = {"run": True, "procs": procs, "world": TP_WORLD, "cards": [g["card"] for g in got], "topo": topo,
           "peer_access": peers, "nvidia_smi": every, "spawn_s": spawn_s}  # fmt: skip
    # (a) the fused kernels: each process's ranks bitwise the emulated run's, both calls
    fused = {}
    for key, want in ref.items():
        for p, g in enumerate(got):
            r = g["fused"][key]
            same = torch.equal(r["out"], want[p * held : (p + 1) * held])
            fused[f"{key[0]} {key[1]} process {p}"] = {"bitwise": same, "twice": r["twice"], "launch": r["launch"]}
            if not (same and r["twice"] and r["launch"]["pool"] == "procs"):
                raise SystemExit(f"chip_smoke: tp_gpus fused {key} process {p}: bitwise {same}, second call equal "
                                 f"{r['twice']}, pool {r['launch']['pool']}")  # fmt: skip
    print(f"[tp_gpus] fused AG+GEMM / GEMM+RS over {procs} cards: {len(fused)} (case, dtype, process) outputs "
          f"bitwise equal to W = {TP_WORLD} emulated on card 0, each twice on one pool")  # fmt: skip
    out["fused"] = fused
    # (b) the f32 prefill, the launches and the payload
    lg = got[0]["logits"]
    err = (lg - ref_logits).abs()
    bound = LOGIT_ATOL + LOGIT_RTOL * ref_logits.abs()
    worst = float((err - bound).max())
    sums = [g["logits_sum"] for g in got]
    print(f"[tp_gpus] f32 prefill over {procs} cards vs card 0 emulated: max|err| {float(err.max()):.3e}, "
          f"worst err - bound {worst:.3e} (bound {LOGIT_ATOL:g} + {LOGIT_RTOL:g} |ref|); logits' sums by process "
          f"{sums}")  # fmt: skip
    if not (bool(torch.isfinite(lg).all()) and worst <= 0 and len(set(sums)) == 1):
        raise SystemExit(f"chip_smoke: tp_gpus f32 prefill: worst {worst}, sums {sums}")
    for p, g in enumerate(got):
        if g["prefill_launches"] != ref_launches or g["greedy_payload"] != ref_payload or not ref_payload:
            raise SystemExit(f"chip_smoke: tp_gpus process {p}: launches {g['prefill_launches']} vs {ref_launches}, "
                             f"greedy payload {g['greedy_payload']} vs {ref_payload}")  # fmt: skip
    print(f"[tp_gpus] prefill launches per process {ref_launches} = the one-card run's; the greedy decode's "
          f"payload per rank {ref_payload} = the one-process World's")  # fmt: skip
    out.update(prefill_max_abs_err=float(err.max()), launches=ref_launches, payload=ref_payload)
    # (c) bf16 greedy tokens and the engine's: every process the same (SPMD), against the one-card run's
    for p, g in enumerate(got):
        if not (torch.equal(g["greedy"], got[0]["greedy"]) and (g["engine"]["tokens"] == got[0]["engine"]["tokens"]).all()):
            raise SystemExit(f"chip_smoke: tp_gpus process {p}: its tokens differ from process 0's")
    greedy = _hold_greedy(got[0]["greedy"], got[0]["greedy_logits"], ref_tokens, ref_rows)
    eng, eng_toks = got[0]["engine"], got[0]["engine"]["tokens"]
    eng_equal = [int((eng_toks[i] == ref_engine["tokens"][i]).all()) for i in range(len(eng_toks))]
    print(f"[tp_gpus] bf16 greedy ({BATCH} x {PROMPT} prompt, {TP_NEW} tokens): {greedy['equal_rows']} of {BATCH} rows "
          f"equal to the one-card run's, every difference a near tie; prefill {got[0]['greedy_s']['prefill_s'] * 1e3:.1f} "
          f"ms / one card {ref_timing['prefill_s'] * 1e3:.1f} ms, decode {got[0]['greedy_s']['decode_s'] * 1e3:.1f} ms "
          f"/ {ref_timing['decode_s'] * 1e3:.1f} ms; the engine's requests equal to the one-card engine's: {eng_equal} "
          f"(recorded: the same decode rounding), {eng['tokens_per_s']:.1f} tokens/s over {procs} cards (eager) vs "
          f"{ref_engine['tokens_per_s']:.1f} on one card (captured), launches {eng['launches']}")  # fmt: skip
    out.update(greedy=greedy, engine_equal=eng_equal, greedy_s=[g["greedy_s"] for g in got], greedy_s_one=ref_timing,
               engine={k: eng[k] for k in ("tokens_per_s", "steps", "host_syncs", "graph_captures", "launches",
                                           "data_bytes", "seconds")},
               engine_one={k: ref_engine[k] for k in ("tokens_per_s", "steps", "graph_captures", "seconds")})  # fmt: skip
    # (d) Fig. 8 / Tab. 2 over the cards
    rows = paper_mlp.combine_rows([g["paper"] for g in got])
    for r in rows:
        print(f"[tp_gpus] {paper_mlp.describe(r)}")
    out["paper"] = rows
    out["counts"] = {k: sum(g["engine"]["launches"][k] for g in got) for k in ref_launches}
    # (e)-(h) training across the cards; every hold printed before the phase fails on any
    fail = []
    out["train"] = _hold_tp_train(got, train_refs, procs, fail)
    out["moe"] = _hold_tp_moe(got, moe_refs, procs, fail)
    del got
    try:
        out["train"]["e2e"] = _hold_tp_e2e(procs, fail)
    except Exception as e:  # a failed row's spawn: every other hold is still printed before the phase fails
        fail.append(f"(d)/(i) Fig. 11 across the cards: {type(e).__name__}: {e}")
    if fail:
        raise SystemExit("chip_smoke: tp_gpus: " + "; ".join(fail))
    return out


# MoE across the cards (the tp_gpus phase's (e)-(h)): (e) deepseek's f32 checks at this depth, its layer checks at
# these capacity factors; (g) granite's f32 step at this depth, its gradients held to TP_GRAD_RTOL
TP_MOE_F32_LAYERS = 4
TP_MOE_CF = (1.25, 0.25)
TP_MOE_TOKENS = 512  # (e)'s layer input: tokens a rank and batch row (deepseek's capacity 64, then 16: 0.25 drops)
TP_MOE_TRAIN_F32_LAYERS = 2
TP_MOE_FORCED = 4  # (e)'s teacher-forced decode steps


def _moe_layer_outputs(world, cfg, layer, x) -> dict:
    """(e): one MoE block's routed path in float32 on the fused backend, the
    double ring (``ag_moe``) and the a2a pair, at each of TP_MOE_CF, on the
    block's normed input ``x``: the outputs and the kept (token, k) sets of
    every dispatch table built, on the CPU."""
    from repro_torch.core.channels import BlockChannel
    from repro_torch.core.compiler import A2A_SEQ, compile_overlap
    from repro_torch.core.moe_overlap import moe_router
    from repro_torch.nn.layers import ACTS, rms_norm

    h = rms_norm(x, layer["ln"], cfg.norm_eps)
    ids, wts, _ = moe_router(h, layer["router"], num_experts=layer["w_gu"].shape[1] * world.size,
                             top_k=cfg.moe.top_k, valid_experts=cfg.moe.num_experts)  # fmt: skip
    out = {}
    for cf in TP_MOE_CF:
        for kind, ops in (("ag_moe", "ag_moe"), ("a2a", list(A2A_SEQ))):
            calls, restore = _record_kept()
            try:
                y = compile_overlap(ops, BlockChannel(axis="model"), world=world, backend="fused")(
                    h, ids, wts, layer["w_gu"], layer["w_down"], capacity_factor=cf, act=ACTS[cfg.act])  # fmt: skip
            finally:
                restore()
            out[(kind, cf)] = {"out": y.cpu(), "kept": [c.cpu() for c in calls]}
    return out


def _moe_inputs(cfg, dev):
    """(e)'s operands: every rank's [W, 2, TP_MOE_TOKENS, d] input of the MoE
    block (seeded, float32) and the prompts."""
    import torch

    from repro_torch.launch import serve

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((TP_WORLD, 2, TP_MOE_TOKENS, cfg.d_model), generator=g, device=dev)
    return x, torch.as_tensor(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, 0), device=dev)


def _ds_f32(world, dev, procs_rank: int = 0) -> dict:
    """(e) on ``world``: deepseek at TP_MOE_F32_LAYERS in float32, its first
    MoE layer's outputs and kept sets (:func:`_moe_layer_outputs`), the
    prefill logits in TP and EP, and TP_MOE_FORCED teacher-forced decode
    steps' logits in both MoE decode forms (``nn/moe.apply_decode`` over
    the held ranks, gathered and streamed; process 0's on the CPU, every
    process's sum)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    cfg = dataclasses.replace(get_config(ARCH_DS), n_layers=TP_MOE_F32_LAYERS)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    x, prompts = _moe_inputs(cfg, dev)
    x = x[world.rank0 : world.rank0 + world.held].contiguous()
    i = next(i for i, d in enumerate(lm.layer_plan(cfg)) if d.ffn_kind == "moe")
    out = {"layer": _moe_layer_outputs(world, cfg, params["layers"][i]["ffn"], x), "logits": {}, "logits_sum": {},
           "decode": {}, "decode_sum": {}}  # fmt: skip
    with torch.no_grad():
        for ep in (None, "model"):
            lg, _ = lm.prefill(params, cfg, ParallelContext(world=world, ep_axis=ep), prompts, max_len=PROMPT + TP_NEW)
            out["logits"][ep] = lg.cpu() if procs_rank == 0 else None
            out["logits_sum"][ep] = float(lg.double().sum())
            del lg
        # the decode, teacher-forced (both worlds decode one context): its logits in both MoE decode forms
        forced = torch.as_tensor(serve.make_prompts(cfg.vocab_size, BATCH, TP_MOE_FORCED, 1), device=dev)
        for stream in (False, True):
            pc = ParallelContext(world=world, moe_decode_stream=stream)
            _, caches = lm.prefill(params, cfg, pc, prompts, max_len=PROMPT + TP_MOE_FORCED)
            rows = []
            for i in range(TP_MOE_FORCED):
                lg, caches = lm.decode_step(params, caches, cfg, pc, forced[:, i : i + 1], PROMPT + i)
                rows.append(lg[:, 0])
            rows = torch.stack(rows, 1)
            out["decode"][stream] = rows.cpu() if procs_rank == 0 else None
            out["decode_sum"][stream] = float(rows.double().sum())
            del caches, rows
    del params
    torch.cuda.empty_cache()
    return out


def _ds_greedy(world, dev) -> dict:
    """(f) on ``world``: deepseek-moe-16b at its published depth in bf16, 4 x
    256 prompts and TP_NEW greedy tokens with the gathered and the streamed
    MoE decode (``serve.greedy``, then its replay with the logits kept):
    tokens, logits, timings, launches and peak device memory."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks.common import event_ms
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    cfg = get_config(ARCH_DS)
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    _, prompts = _moe_inputs(cfg, dev)
    out = {"layers": cfg.n_layers}
    for stream in (False, True):
        pc = ParallelContext(world=world, moe_decode_stream=stream)
        K.reset_launch_counts()
        with torch.no_grad(), world.counting() as counter:
            tokens, timing = serve.greedy(params, cfg, pc, prompts, TP_NEW)
        torch.cuda.synchronize(dev)
        launches = K.launch_counts()
        out[f"payload_{stream}"] = {k: dict(v) for k, v in counter.payload.items() if v}
        routes = []
        toks, rows = _greedy_logits(params, cfg, pc, prompts, TP_NEW, routes)
        if not torch.equal(toks, tokens):
            raise SystemExit(f"chip_smoke: tp_gpus deepseek greedy (stream {stream}): serve.greedy and its replay "
                             "disagree")  # fmt: skip
        out["stream" if stream else "gather"] = {"tokens": toks.cpu(), "rows": rows.cpu(), "timing": timing,
                                                 "launches": launches, "routes": routes}  # fmt: skip
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # one decode psum at the decode's shape ([held, B, d], bf16): its time a call (CUDA events)
    part = torch.zeros((world.held, BATCH, cfg.d_model), dtype=torch.bfloat16, device=dev)
    out["psum_ms"] = event_ms(lambda: world.psum(part), ITERS)[0]
    out["psum_call_bytes"] = BATCH * cfg.d_model * 2
    del params
    torch.cuda.empty_cache()
    return out


def _granite_f32_step(world, dev) -> dict:
    """(g)'s float32 step on ``world``: granite at TP_MOE_TRAIN_F32_LAYERS,
    the train phase's batch, on the fused backend: loss, gradients (after
    the kv sync and the masks; over processes ``tp_procs_grads``), their
    roles and the step's launches."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import apply_masks
    from repro_torch.training.steps import loss_and_grads, tp_procs_grads

    cfg = dataclasses.replace(get_config(ARCH_MOE), n_layers=TP_MOE_TRAIN_F32_LAYERS)
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    K.reset_launch_counts()
    if world.nprocs > 1:
        loss, _, _, grads, _ = tp_procs_grads(lm, cfg, pc, params, batch, grad_masks=lm.grad_masks(cfg, pc))
    else:
        loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, batch)
        grads = apply_masks(lm.sync_grads(grads, cfg, pc), lm.grad_masks(cfg, pc))
    torch.cuda.synchronize(dev)
    out = {"loss": loss.cpu(), "grads": [g.cpu() for g in _leaves(grads)], "roles": _leaves(lm.proc_roles(grads, cfg)),
           "names": _leaf_names(grads), "launches": K.launch_counts()}  # fmt: skip
    del params, grads
    torch.cuda.empty_cache()
    return out


def _tp_grouped_cases(tp) -> dict:
    """Kernel #5 on a card of the four-card path: deepseek's expert GEMMs of
    one ring step at 4 x 256 tokens, the held ranks' groups only (held x
    E_loc groups of B x cap rows), against its plain version and
    ``kernels/ref`` (TOL), bf16 relaunches bitwise; kernel, plain and
    ``torch.bmm`` times (CUDA events), the bound of this card's work."""
    import contextlib
    import io

    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels.grouped_matmul import group_tile_table

    shp, dev, bf16 = path_shapes(ARCH_DS), tp.device, torch.bfloat16
    groups, rows = tp.held * shp["e_loc"], BATCH * shp["cap"]
    table = group_tile_table(groups, rows, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    quiet = contextlib.redirect_stdout(io.StringIO()) if tp.procs.rank else contextlib.nullcontext()
    with quiet:
        for tag, k, n, out_dt in (("gate_up", shp["d"], 2 * shp["fe"], torch.float32), ("down", shp["fe"], shp["d"], bf16)):
            x = torch.randn((groups * rows, k), generator=g, device=dev).to(bf16)
            w = (torch.randn((groups, k, n), generator=g, device=dev) * k**-0.5).to(bf16)
            osz = torch.tensor([], dtype=out_dt).element_size()
            out[tag] = _case(
                f"grouped_matmul[{ARCH_DS} {tag}, card {tp.procs.rank} of {tp.nprocs}: {groups} groups x {rows} rows] "
                f"x{list(x.shape)} w{list(w.shape)} -> {str(out_dt)[6:]}", bf16,
                lambda: K.grouped_matmul(x, w, table, out_dtype=out_dt), lambda: K.grouped_matmul_plain(x, w, table, out_dt),
                lambda: torch.bmm(x.view(groups, rows, k), w), 2 * x.shape[0] * k * n,
                2 * (x.numel() + w.numel()) + osz * x.shape[0] * n, ITERS, launch=lambda: K.grouped_matmul.last_launch,
                bitwise=True, ref=lambda: _grouped_ref(x, w, table, out_dt),
            )  # fmt: skip
            del x, w
    return out


def _tp_moe_worker(tp, spec: dict) -> dict:
    """The MoE part of a tp_gpus process: (e) deepseek's f32 layer and prefill
    (:func:`_ds_f32`); (f) deepseek-moe-16b at its 28 layers in bf16, greedy
    with both decodes (:func:`_ds_greedy`) and the serve CLI's engine
    (``serve.serve_tp``, the streamed decode); (g) granite's f32 step at 2
    layers, then TRAIN_STEPS bf16 steps at 32 layers through
    ``launch/train.train_tp``; (h) Fig. 9 at W = 4 over the cards
    (``paper_moe.process_rows``); kernel #5 at the four-card shapes, last (its
    profiler sessions slow what follows them)."""
    import torch

    from repro_torch.benchmarks import paper_moe
    from repro_torch.configs.paper import PAPER_MOE
    from repro_torch.kernels import peer
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli

    dev = tp.device
    out = {"f32": _ds_f32(tp, dev, tp.procs.rank)}
    peer.release(tp.procs.barrier)
    out["greedy"] = _ds_greedy(tp, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["engine"] = serve.serve_tp(tp, ARCH_DS, dict(spec["engine"], world=TP_WORLD, dtype="bf16", reduce=False,
                                                     temperature=0.0, top_k=0, eos_id=None, moe_stream=True,
                                                     mode="overlap", ckpt_dir=None))  # fmt: skip
    out["engine"]["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    peer.release(tp.procs.barrier)
    torch.cuda.empty_cache()
    out["train_f32"] = _granite_f32_step(tp, dev)
    peer.release(tp.procs.barrier)
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduce=False, layers=None, mode="overlap",
              remat="none", ckpt_dir=None, ckpt_every=0, lr=3e-4, dtype="bf16", world=TP_WORLD, log_every=10,
              resume=False, time_data=False)  # fmt: skip
    out["train"] = train_cli.train_tp(tp, ARCH_MOE, kw)
    out["train"]["pool_bytes"] = peer.pool_bytes(dev)
    peer.release(tp.procs.barrier)
    torch.cuda.empty_cache()
    out["paper"] = paper_moe.process_rows(tp, list(PAPER_MOE))
    torch.cuda.empty_cache()
    out["grouped"] = _tp_grouped_cases(tp)
    return out


def _tp_moe_refs(dev) -> dict:
    """The emulated W on card 0 for the MoE holds: (e) deepseek's f32 layer
    and prefill, (f) its bf16 greedy at 28 layers with both decodes, (g)
    granite's f32 step, fused and eager."""
    import torch

    from repro_torch.backend.mesh import World

    one = World(TP_WORLD, dev)
    refs = {"f32": _ds_f32(one, dev), "greedy": _ds_greedy(one, dev), "train_f32": _granite_f32_step(one, dev)}
    torch.cuda.empty_cache()
    return refs


def _hold_tp_moe(got: list, refs: dict, procs: int, fail: list) -> dict:
    """The MoE holds of the tp_gpus phase ((e)-(h) and kernel #5 across the
    cards), each failure appended to ``fail``; (i), Fig. 11's MoE rows, is in
    :func:`_hold_tp_e2e`."""
    import torch

    from repro_torch.benchmarks import paper_e2e, paper_mlp, paper_moe
    from repro_torch.configs import get_config

    held = TP_WORLD // procs
    total = torch.cuda.get_device_properties(0).total_memory
    moe = [g["moe"] for g in got]
    out = {}
    # (e) the layer: outputs and kept sets against the emulated run; the prefill logits
    layer, n_out, n_bit, kept_bad, out_bad, drops = {}, 0, 0, [], [], {}
    for key, want in refs["f32"]["layer"].items():
        errs = []
        for p, m in enumerate(moe):
            r = m["f32"]["layer"][key]
            w_out = want["out"][p * held : (p + 1) * held]
            n_out += 1
            n_bit += int(torch.equal(r["out"], w_out))
            errs.append((r["out"] - w_out).abs().max().item() / max(w_out.abs().max().item(), 1e-30))
            if len(r["kept"]) != len(want["kept"]) or not all(
                    torch.equal(a, b[p * held : (p + 1) * held]) for a, b in zip(r["kept"], want["kept"])):  # fmt: skip
                kept_bad.append((key, p))
        routed = sum(int(k.sum()) for k in want["kept"])
        drops[key] = routed
        layer[f"{key[0]} cf {key[1]}"] = {"rel_err": max(errs), "kept_pairs": routed}
        if max(errs) > TP_GRAD_RTOL:
            out_bad.append((key, max(errs)))
    kept_all = {cf: drops[("ag_moe", cf)] for cf in TP_MOE_CF}
    rel_by_case = {k: round(v["rel_err"], 12) for k, v in layer.items()}
    print(f"[tp_gpus] (e) deepseek MoE layer f32 over {procs} cards, TP (ag_moe) and EP (a2a) at capacity factors "
          f"{TP_MOE_CF}: {n_bit} of {n_out} (case, process) outputs bitwise the emulated W = {TP_WORLD} on card 0; worst "
          f"max|diff| / max|emulated| by case {rel_by_case} (bound "
          f"{TP_GRAD_RTOL:g}); kept (token, k) sets equal to the emulated run's in every dispatch table: "
          f"{not kept_bad}; kept pairs (ag_moe) by capacity factor {kept_all}")  # fmt: skip
    if kept_bad or out_bad or not kept_all[TP_MOE_CF[-1]] < kept_all[TP_MOE_CF[0]]:
        fail.append(f"(e) MoE layer: kept sets differ {kept_bad[:4]}, outputs {out_bad[:4]}, kept {kept_all}")
    logit_rec = {}
    for ep in (None, "model"):
        lg, ref = moe[0]["f32"]["logits"][ep], refs["f32"]["logits"][ep]
        err = (lg - ref).abs()
        worst = float((err - (LOGIT_ATOL + LOGIT_RTOL * ref.abs())).max())
        sums = [m["f32"]["logits_sum"][ep] for m in moe]
        logit_rec["EP" if ep else "TP"] = {"bitwise": bool(torch.equal(lg, ref)), "max_abs_err": float(err.max()),
                                           "worst_minus_bound": worst, "sums_equal": len(set(sums)) == 1}  # fmt: skip
        if not (bool(torch.isfinite(lg).all()) and worst <= 0 and len(set(sums)) == 1):
            fail.append(f"(e) deepseek f32 prefill ({'EP' if ep else 'TP'}): worst {worst}, sums {sums}")
    print(f"[tp_gpus] (e) deepseek f32 prefill ({TP_MOE_F32_LAYERS} layers, {BATCH} x {PROMPT}) over {procs} cards vs "
          f"the emulated W = {TP_WORLD}: {logit_rec} (bound {LOGIT_ATOL:g} + {LOGIT_RTOL:g} |ref|)")  # fmt: skip
    decode_rec = {}
    for stream in (False, True):
        lg, ref = moe[0]["f32"]["decode"][stream], refs["f32"]["decode"][stream]
        err = (lg - ref).abs()
        worst = float((err - (LOGIT_ATOL + LOGIT_RTOL * ref.abs())).max())
        sums = [m["f32"]["decode_sum"][stream] for m in moe]
        form = "stream" if stream else "gather"
        decode_rec[form] = {"bitwise": bool(torch.equal(lg, ref)), "max_abs_err": float(err.max()),
                            "worst_minus_bound": worst, "sums_equal": len(set(sums)) == 1}  # fmt: skip
        if not (bool(torch.isfinite(lg).all()) and worst <= 0 and len(set(sums)) == 1):
            fail.append(f"(e) deepseek f32 decode ({form}): worst {worst}, sums {sums}")
    print(f"[tp_gpus] (e) deepseek f32 decode ({TP_MOE_F32_LAYERS} layers, {TP_MOE_FORCED} teacher-forced steps after "
          f"the {BATCH} x {PROMPT} prefill) over {procs} cards vs the emulated W = {TP_WORLD}, gathered and streamed MoE "
          f"decode: {decode_rec} (bound {LOGIT_ATOL:g} + {LOGIT_RTOL:g} |ref|)")  # fmt: skip
    out["e"] = {"layer": layer, "outputs_bitwise": [n_bit, n_out], "kept_equal": not kept_bad, "kept_pairs": kept_all,
                "prefill": logit_rec, "decode": decode_rec}  # fmt: skip
    # (f) deepseek at 28 layers, bf16: greedy both decodes against the emulated run; the engine
    g0, ref = moe[0]["greedy"], refs["greedy"]
    rec = {"layers": g0["layers"], "peak_bytes": [m["greedy"]["peak_bytes"] for m in moe],
           "peak_bytes_one_card": ref["peak_bytes"]}  # fmt: skip
    for form in ("gather", "stream"):
        if any(not torch.equal(m["greedy"][form]["tokens"], g0[form]["tokens"]) for m in moe):
            fail.append(f"(f) deepseek greedy {form}: the processes' tokens differ")
        routes = list(g0[form]["routes"])  # the prefill's routing: every process's held ranks, joined in rank order
        routes[0] = [tuple(torch.cat([m["greedy"][form]["routes"][0][layer][i] for m in moe]) for i in (0, 1))
                     for layer in range(len(routes[0]))]  # fmt: skip
        try:
            held_rec = _hold_greedy_routed(g0[form]["tokens"], g0[form]["rows"], routes, ref[form]["tokens"],
                                           ref[form]["rows"], ref[form]["routes"])  # fmt: skip
        except SystemExit as e:
            fail.append(f"(f) deepseek greedy {form}: {e}")
            held_rec = {"equal_rows": None, "rows": []}
        rec[f"{form}_rows"] = held_rec["rows"]
        t, t1 = g0[form]["timing"], ref[form]["timing"]
        steps = t["decode_steps"]
        rec[form] = {"equal_rows": held_rec["equal_rows"], "prefill_ms": t["prefill_s"] * 1e3,
                     "decode_tokens_per_s": BATCH * steps / t["decode_s"], "prefill_ms_one_card": t1["prefill_s"] * 1e3,
                     "decode_tokens_per_s_one_card": BATCH * steps / t1["decode_s"], "launches": g0[form]["launches"],
                     "launches_one_card": ref[form]["launches"]}  # fmt: skip
        if any(m["greedy"][form]["launches"] != ref[form]["launches"] for m in moe):
            fail.append(f"(f) deepseek greedy {form}: launches {[m['greedy'][form]['launches'] for m in moe]} vs the "
                        f"one-card run's {ref[form]['launches']}")  # fmt: skip
    # the decode's psums over the cards: each gathers every rank's partial (W x an all-reduce's payload)
    pay = g0["payload_False"].get("psum", {})
    calls = sum(pay.values()) / g0["psum_call_bytes"] / (TP_NEW - 1)  # the decode steps' (the prefill's: aux scalars)
    rec["psum"] = {"payload": g0["payload_False"], "calls_per_token_step": calls,
                   "ms_per_call": [m["greedy"]["psum_ms"] for m in moe], "ms_per_call_one_card": ref["psum_ms"]}
    print(f"[tp_gpus] (f) the decode's psums over {procs} cards: {calls:.1f} a greedy step at [{held}, {BATCH}, "
          f"{get_config(ARCH_DS).d_model}] bf16 (a rank's psum payload {pay}), {max(rec['psum']['ms_per_call']):.4f} "
          f"ms a call on the slowest card (one card emulated {ref['psum_ms']:.4f} ms): about "
          f"{calls * max(rec['psum']['ms_per_call']):.1f} ms a decode step")  # fmt: skip
    eng = moe[0]["engine"]
    rec["engine"] = {k: eng[k] for k in ("tokens_per_s", "steps", "host_syncs", "graph_captures", "launches", "seconds")}
    rec["engine"]["peak_bytes"] = [m["engine"]["peak_bytes"] for m in moe]
    if any((m["engine"]["tokens"] != eng["tokens"]).any() for m in moe) or max(rec["peak_bytes"]) >= total:
        fail.append(f"(f) deepseek engine tokens differ across processes, or peak {rec['peak_bytes']}")
    for form in ("gather", "stream"):
        r = rec[form]
        print(f"[tp_gpus] (f) bf16 {ARCH_DS} ({rec['layers']} of {get_config(ARCH_DS).n_layers} layers) over {procs} "
              f"cards, {form} MoE decode: greedy {BATCH} x {PROMPT} + {TP_NEW}: {r['equal_rows']} of {BATCH} rows equal "
              f"to the emulated one-card run's (held up to each row's first routing flip, a near tie); prefill "
              f"{r['prefill_ms']:.1f} ms (one card {r['prefill_ms_one_card']:.1f}), decode {r['decode_tokens_per_s']:.1f} "
              f"tokens/s (one card {r['decode_tokens_per_s_one_card']:.1f}); launches a process {r['launches']}; by row "
              f"(first differing token, steps held, max|logit diff| in them, over all steps, max|logit|, the routing "
              f"flip's (step, layer)) {[(x['first_diff'], x['held_steps'], round(x['max_abs_logit_diff_before'], 4), round(x['max_abs_logit_diff'], 4), round(x['max_abs_logit'], 2), x['routing_flip'] and (x['routing_flip']['step'], x['routing_flip']['layer'])) for x in rec[f'{form}_rows']]}")  # fmt: skip
    print(f"[tp_gpus] (f) the serve CLI's engine over {procs} cards (eager, streamed MoE decode): "
          f"{rec['engine']['tokens_per_s']:.1f} tokens/s, {rec['engine']['steps']} steps, launches "
          f"{rec['engine']['launches']}; peak by card {[round(b / 2**20) for b in rec['peak_bytes']]} MiB greedy, "
          f"{[round(b / 2**20) for b in rec['engine']['peak_bytes']]} MiB engine, one card (W = {TP_WORLD} emulated) "
          f"{round(rec['peak_bytes_one_card'] / 2**20)} MiB")  # fmt: skip
    out["f"] = rec
    # (g) granite: the f32 step against the emulated step, then 30 bf16 steps at 32 layers
    f32 = [m["train_f32"] for m in moe]
    emu, roles, names = refs["train_f32"], f32[0]["roles"], f32[0]["names"]
    loss_bitwise = all(torch.equal(r["loss"], emu["loss"]) for r in f32)
    worst, worst_leaf, bit, grad_bad, bitwise_names = 0.0, None, {}, [], set()
    for p, r in enumerate(f32):
        for i, (gr, role) in enumerate(zip(r["grads"], roles)):
            e = emu["grads"][i][p * held : (p + 1) * held] if role == "held" else emu["grads"][i]
            rel = (gr - e).abs().max().item() / max(e.abs().max().item(), 1e-30)
            if rel > worst:
                worst, worst_leaf = rel, (names[i], role)
            same = bool(torch.equal(gr, e))
            bit.setdefault(role, []).append(same)
            if same:
                bitwise_names.add(names[i])
            if not (torch.isfinite(gr).all() and rel <= TP_GRAD_RTOL):
                grad_bad.append((p, names[i], rel))
    bitwise = {role: f"{sum(v)} of {len(v)}" for role, v in bit.items()}
    bitwise_names = sorted(bitwise_names)
    print(f"[tp_gpus] (g) f32 {ARCH_MOE} step over {procs} cards ({TP_MOE_TRAIN_F32_LAYERS} layers, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}): loss by process {[float(r['loss']) for r in f32]}, emulated {float(emu['loss'])!r} (bitwise: "
          f"{loss_bitwise}); gradients' worst max|diff| / max|emulated| {worst:.3e} at {worst_leaf} (bound "
          f"{TP_GRAD_RTOL:g}); bitwise by role (process x leaf) {bitwise}; the leaves bitwise on some process "
          f"{bitwise_names}; launches of the step a process {f32[0]['launches']}")  # fmt: skip
    if not loss_bitwise or grad_bad:
        fail.append(f"(g) f32 step: loss bitwise {loss_bitwise}, gradients {grad_bad[:6]}")
    cfg = get_config(ARCH_MOE)
    expect = paper_e2e.expected_launches(cfg, "overlap")
    runs = [m["train"] for m in moe]
    hist = runs[0]["history"]
    steps_bad = [(r["step"], r["launches"]) for r in hist if r["launches"] != expect]
    totals_bad = [p for p, r in enumerate(runs) if r["launches"] != {k: v * TRAIN_STEPS for k, v in expect.items()}]
    ce = [r["ce"] for r in hist]
    first, last = sum(ce[:5]) / 5, sum(ce[-5:]) / 5
    med = _median([r["ms"] for r in hist[TRAIN_WARMUP:]])
    peaks = [r["peak_bytes"] for r in runs]
    print(f"[tp_gpus] (g) bf16 {ARCH_MOE} ({cfg.n_layers} layers) W = {TP_WORLD} over {procs} cards, {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH} x {TRAIN_SEQ}: launches a process a step {hist[0]['launches']} (expected {expect}), "
          f"mean ce of the first 5 steps {first:.4f}, of the last 5 {last:.4f} (held: more than 0.2 lower); step "
          f"{med:.2f} ms (median of steps {TRAIN_WARMUP}-{TRAIN_STEPS - 1}, CUDA events on card 0), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (med / 1e3):.0f} tokens/s, peak by card {[round(b / 2**20) for b in peaks]} MiB, "
          f"receive pools {[round(r['pool_bytes'] / 2**20, 1) for r in runs]} MiB")  # fmt: skip
    if steps_bad or totals_bad or not last < first - 0.2 or not all(map(math.isfinite, ce)) or max(peaks) >= total:
        fail.append(f"(g) bf16 train: launches {steps_bad[:3]} / processes {totals_bad}, ce {first} -> {last}, "
                    f"peak {peaks}")  # fmt: skip
    out["g"] = {"f32": {"loss_bitwise": loss_bitwise, "grad_rel_err": worst, "worst_leaf": worst_leaf,
                        "bitwise_by_role": bitwise, "bitwise_leaves": bitwise_names},
                "bf16": {"ce": ce, "median_step_ms": med, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
                         "peak_bytes": peaks, "per_step": expect, "counts": runs[0]["launches"]}}  # fmt: skip
    # (h) Fig. 9 at W = 4 over the cards
    rows = paper_mlp.combine_rows([m["paper"] for m in moe])
    for r in rows:
        print(f"[tp_gpus] (h) {paper_moe.describe(r)}")
        if r["grouped_launches"] != 2 * TP_WORLD or r["peak_mib"] * 2**20 >= total:
            fail.append(f"(h) Fig. 9 {r['case']}: grouped launches {r['grouped_launches']}, peak {r['peak_mib']} MiB")
    out["h"] = rows
    # kernel #5 across the cards: each case from its slowest card
    grouped = {}
    for tag in moe[0]["grouped"]:
        recs = [m["grouped"][tag] for m in moe]
        grouped[tag] = {k: max(r[k] for r in recs) for k in ("ms", "plain_ms", "library_ms", "max_abs_err")}
        grouped[tag].update(bound_ms=recs[0]["bound_ms"], bound_by=recs[0]["bound_by"], case=recs[0]["case"])
        print(f"[tp_gpus] kernel #5 across the cards, {tag} (the slowest card): {grouped[tag]}")
    out["grouped"] = grouped
    return out


def _hold_logits(what: str, a, b, pair=("fused", "eager")):
    """Fail unless logits ``a`` agree with ``b`` (by default fused against
    eager) to the float32 bound."""
    import torch

    diff = (a.float() - b.float()).abs()
    worst = (diff - LOGIT_RTOL * b.float().abs()).max().item()
    print(
        f"{what}, {pair[0]} vs {pair[1]}: max|diff| {diff.max().item():.3e} (bound |diff| <= {LOGIT_ATOL:g} + "
        f"{LOGIT_RTOL:g} x |{pair[1]}|; max|{pair[1]}| {b.float().abs().max().item():.3e}; {a.numel()} logits)"
    )
    if not (torch.isfinite(a).all() and worst <= LOGIT_ATOL):
        raise SystemExit(f"chip_smoke: {what}: {pair[0]} disagrees with {pair[1]}")


def _f32(tree):
    """A parameter tree with every tensor in float32 (bf16 weights carried exactly)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f32(v) for v in tree]
    return tree.float()


def _bf16_vs_f32(tag: str, params, cfg, pc, pc_eager, prompts, layer: bool, embeds=None) -> dict:
    """The bf16 fused path against the f32 eager path on the same bf16
    weights: one layer held to the bf16 bound (``layer``), the prefill
    logits' max|diff| and top-1 agreement printed, not held (``embeds``: a
    stub frontend's prefix before the prompts)."""
    import torch

    from repro_torch.models import lm

    p32 = _f32(params)
    out = {}
    if layer:
        gen = torch.Generator(device=pc.device).manual_seed(2)
        x = torch.randn((WORLD, BATCH, PROMPT // WORLD, cfg.d_model), generator=gen, device=pc.device)
        d = lm.layer_plan(cfg)[0]
        y_b = d.apply_seq(params["layers"][0], x.bfloat16(), pc, cfg)[0]
        y_e = d.apply_seq(p32["layers"][0], x.bfloat16().float(), pc_eager, cfg)[0]
        err, scale = (y_b.float() - y_e).abs().max().item(), y_e.abs().max().item()
        print(
            f"[{tag}] bf16 {d.kind} layer [{WORLD}, {BATCH}, {PROMPT // WORLD}, {cfg.d_model}], fused bf16 vs eager "
            f"f32 on the same weights: max|diff| {err:.3e} (bound {TOL['bfloat16']:g} x max|ref| {scale:.3e})"
        )
        if not (torch.isfinite(y_b).all() and err <= TOL["bfloat16"] * scale):
            raise SystemExit(f"chip_smoke: the bf16 fused {d.kind} layer disagrees with the f32 eager layer")
        out["layer_err"], out["layer_ref"] = err, scale
    max_len = prompts.shape[1] + NEW_TOKENS + (0 if embeds is None else embeds.shape[1])
    lg_e, _ = lm.prefill(p32, cfg, pc_eager, prompts, embeds, max_len=max_len)
    # the bf16 eager path is the control: how far bf16 alone moves the logits
    for what, p_ in (("fused", pc), ("eager", pc_eager)):
        lg_b, _ = lm.prefill(params, cfg, p_, prompts, embeds, max_len=max_len)
        diff = (lg_b.float() - lg_e).abs().max().item()
        top1 = (lg_b.float().argmax(-1) == lg_e.argmax(-1)).float().mean().item()
        print(
            f"[{tag}] bf16 {what} prefill vs f32 eager prefill (same bf16 weights, {lg_e.numel()} logits): "
            f"max|diff| {diff:.3e} (max|ref| {lg_e.abs().max().item():.3e}), top-1 agreement {top1:.4f} "
            "(printed, not held)"
        )
        out[f"prefill_{what}_max_diff"], out[f"prefill_{what}_top1"] = diff, top1
        del lg_b
    return out


def _main_path(tag: str, cfg, pc, prompts, expect: dict, profile: bool, pc_eager=None, layer=False, params=None,
               embeds=None) -> dict:  # fmt: skip
    """The bfloat16 main path: seeded weights (or ``params``), a warm-up
    greedy run, then the run whose launch counts (set to 0 just before it)
    must equal ``expect``; then (``pc_eager``) the bf16 path against f32
    eager on the same weights.  ``embeds``: a stub frontend's prefix before
    the prompts (``serve.greedy(embeds=)``)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.launch import serve
    from repro_torch.models import lm

    n_pre = 0 if embeds is None else embeds.shape[1]
    max_len = n_pre + prompts.shape[1] + NEW_TOKENS
    if params is None:
        params = lm.init(cfg, pc.world, torch.Generator(device=pc.device).manual_seed(0), torch.bfloat16)
    warm, _ = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS, max_len, embeds)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tokens, t = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS, max_len, embeds)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = t["prefill_s"] * 1e3
    tps = BATCH * t["decode_steps"] / t["decode_s"]
    print(
        f"[{tag}] bf16 {cfg.name} W={WORLD}: {BATCH} requests x {n_pre} prefix embeddings + {PROMPT} prompt tokens "
        f"+ {NEW_TOKENS} greedy "
        f"tokens; prefill {prefill_ms:.2f} ms, decode {tps:.1f} tokens/s ({t['decode_steps']} steps), "
        f"peak memory {peak / 2**20:.0f} MiB"
    )
    print(f"[{tag}] launch counts of the main path: {counts}")
    if counts != expect:
        raise SystemExit(f"chip_smoke: {cfg.name} launch counts {counts} != expected {expect}")
    if tuple(tokens.shape) != (BATCH, NEW_TOKENS) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise SystemExit(f"chip_smoke: bad generated tokens {tokens.shape}")
    if not torch.equal(tokens, warm):
        raise SystemExit("chip_smoke: two greedy runs on the same weights gave different tokens")
    print(f"[{tag}] tokens[0]: {tokens[0].tolist()}")
    result = {"prefill_ms": prefill_ms, "decode_tokens_per_s": tps, "peak_bytes": peak, "counts": counts}
    if profile:
        result["profile"] = _profile(params, cfg, pc, prompts, max_len, embeds)
    if pc_eager is not None:
        result["bf16_vs_f32"] = _bf16_vs_f32(tag, params, cfg, pc, pc_eager, prompts, layer, embeds)
    return result


def _setup(arch: str, layers=None):
    """``arch``'s config (its depth cut to ``layers``, if given), the W = 4
    world, the fused and eager contexts and the 4 x 256 seeded prompts."""
    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.parallel.context import ParallelContext

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg
    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    assert pc.backend == "fused", pc.backend
    prompts = torch.from_numpy(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, seed=0)).to(world.device)
    return cfg, world, pc, ParallelContext(world=world, backend="eager"), prompts


def phase_serve(profile: bool = False):
    import torch

    from repro_torch.models import lm

    cfg, world, pc, pc_eager, prompts = _setup(ARCH)
    max_len = PROMPT + NEW_TOKENS

    # float32: the fused prefill against the eager executor + plain attention
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    lg_f, _ = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
    lg_e, _ = lm.prefill(params, cfg, pc_eager, prompts, max_len=max_len)
    _hold_logits("[serve] f32 prefill last-position logits", lg_f[:, -1], lg_e[:, -1])
    del params, lg_f, lg_e
    torch.cuda.empty_cache()

    # bfloat16: the main path (prefill + greedy decode) through the kernels
    expect = {"ag_gemm": 2 * cfg.n_layers, "gemm_rs": 2 * cfg.n_layers, "flash_attention": cfg.n_layers,
              "matmul": NEW_TOKENS, "grouped_matmul": 0, "ssd_intra_chunk": 0}  # fmt: skip
    return _main_path("serve", cfg, pc, prompts, expect, profile, pc_eager, layer=True)


def _record_routing():
    """Record every router call's expert sets (sorted top-k ids) in a list;
    returns (the list, a function that restores the router)."""
    from repro_torch.nn import moe

    calls, router = [], moe.moe_router

    def recording(*a, **kw):
        out = router(*a, **kw)
        calls.append(out[0].sort(-1).values)
        return out

    moe.moe_router = recording
    return calls, lambda: setattr(moe, "moe_router", router)


def _hold_prefill_before_flips(tag: str, cfg, params, pc, pc_eager, prompts, pair=("fused", "eager")) -> dict:
    """The float32 prefill, fused against eager (or ``pc`` against
    ``pc_eager`` as ``pair`` names them), with every MoE layer's routing
    recorded: a token whose expert set differs in some layer changes itself
    and the positions after it in its batch row (causal attention, capacity
    slots), so the positions before a row's first flip are held to the bound."""
    import torch

    from repro_torch.models import lm

    dev, max_len = pc.device, PROMPT + NEW_TOKENS
    calls, restore = _record_routing()
    try:
        lg_f, _ = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
        routing_f = list(calls)
        calls.clear()
        lg_e, _ = lm.prefill(params, cfg, pc_eager, prompts, max_len=max_len)
        routing_e = list(calls)
    finally:
        restore()
    first = torch.full((BATCH,), PROMPT, device=dev)
    flips = []
    for rf, re_ in zip(routing_f, routing_e):
        differ = (rf != re_).any(-1).permute(1, 0, 2).reshape(BATCH, PROMPT)  # [B, S] (rank-major positions)
        flips.append(int(differ.sum()))
        pos = torch.where(differ, torch.arange(PROMPT, device=dev), PROMPT)
        first = torch.minimum(first, pos.min(-1).values)
    decisions = len(routing_f) * BATCH * PROMPT
    print(
        f"[{tag}] f32 prefill routing, {pair[0]} vs {pair[1]}: {sum(flips)} of {decisions} token expert sets differ "
        f"(per layer: {flips}); positions held per row before the first flip: {first.tolist()}"
    )
    moe_layers = sum(d.ffn_kind == "moe" for d in lm.layer_plan(cfg))
    if len(routing_f) != moe_layers or int(first.sum()) == 0:
        raise SystemExit(f"chip_smoke: no prefill position of {cfg.name} can be held against the eager path")
    held = torch.arange(PROMPT, device=dev)[None, :] < first[:, None]
    _hold_logits(f"[{tag}] f32 prefill logits (positions before the first flip)", lg_f[held], lg_e[held], pair)
    return {"routing_flips": flips, "held_positions": first.tolist()}


def phase_moe(profile: bool = False):
    import torch

    from repro_torch import kernels as K
    from repro_torch.nn import moe
    from repro_torch.models import lm

    cfg, world, pc, pc_eager, prompts = _setup(ARCH_MOE)
    s_loc = PROMPT // WORLD
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)

    # (a) one MoE layer at full width, fused against eager on the same input:
    # the router sees the same input on both paths, so the routing is identical
    layer = params["layers"][0]["ffn"]
    gen = torch.Generator(device=world.device).manual_seed(1)
    x = torch.randn((WORLD, BATCH, s_loc, cfg.d_model), generator=gen, device=world.device)
    before = K.grouped_matmul.launches
    (y_f, aux_f), (y_e, aux_e) = (moe.apply_seq(layer, x, p, cfg) for p in (pc, pc_eager))
    if K.grouped_matmul.launches - before != 2 * WORLD:  # gate|up and down at every ring step
        raise SystemExit("chip_smoke: the fused MoE layer did not run on the grouped kernel")
    out_f, out_e = y_f - x, y_e - x
    err, scale = (out_f - out_e).abs().max().item(), out_e.abs().max().item()
    print(
        f"[moe] f32 MoE layer [{WORLD}, {BATCH}, {s_loc}, {cfg.d_model}], fused vs eager: max|diff| {err:.3e} "
        f"(bound {TOL['float32']:g} x max|eager| {scale:.3e}); aux {aux_f.item():.6f} vs {aux_e.item():.6f}"
    )
    if not (torch.isfinite(out_f).all() and err <= TOL["float32"] * scale and torch.equal(aux_f, aux_e)):
        raise SystemExit("chip_smoke: the fused MoE layer disagrees with the eager one")
    del x, y_f, y_e, out_f, out_e

    # (b) the float32 prefill, fused against eager, with the routing recorded
    result = {"layer_err": err, **_hold_prefill_before_flips("moe", cfg, params, pc, pc_eager, prompts)}
    del params, layer
    torch.cuda.empty_cache()

    # (c) bfloat16: the main path (prefill + greedy decode) through the kernels
    steps = WORLD  # ring steps per MoE layer (C = 1 on this path)
    expect = {"ag_gemm": cfg.n_layers, "gemm_rs": cfg.n_layers, "flash_attention": cfg.n_layers,
              "matmul": NEW_TOKENS, "grouped_matmul": 2 * steps * cfg.n_layers, "ssd_intra_chunk": 0}  # fmt: skip
    return {**result, **_main_path("moe", cfg, pc, prompts, expect, profile, pc_eager)}


def phase_deepseek(profile: bool = False) -> dict:
    """deepseek-moe-16b: a dense first layer, then MoE layers with 2 shared
    experts; decode and the engine with the streamed MoE decode."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.models import lm
    from repro_torch.nn import moe

    cfg, world, pc, pc_eager, prompts = _setup(ARCH_DS, CUT["deepseek"][ARCH_DS])
    pc_stream = dataclasses.replace(pc, moe_decode_stream=True)
    max_len, s_loc = PROMPT + NEW_TOKENS, PROMPT // WORLD
    cut = dataclasses.replace(cfg, n_layers=DS_F32_LAYERS)  # the dense layer + 3 MoE layers, full width
    params = lm.init(cut, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)

    # (a) one MoE layer with shared experts, fused against eager on the same
    # input (the same router input on both paths: identical routing)
    layer = params["layers"][1]["ffn"]
    gen = torch.Generator(device=world.device).manual_seed(1)
    x = torch.randn((WORLD, BATCH, s_loc, cfg.d_model), generator=gen, device=world.device)
    before = K.launch_counts()
    y_f, aux_f = moe.apply_seq(layer, x, pc, cfg)
    ran = {k: v - before[k] for k, v in K.launch_counts().items()}
    # gate|up and down at every ring step; the shared MLP on the fused pair
    if ran != {**{k: 0 for k in ran}, "grouped_matmul": 2 * WORLD, "ag_gemm": 1, "gemm_rs": 1}:
        raise SystemExit(f"chip_smoke: the fused MoE layer with shared experts launched {ran}")
    y_e, aux_e = moe.apply_seq(layer, x, pc_eager, cfg)
    out_f, out_e = y_f - x, y_e - x
    err, scale = (out_f - out_e).abs().max().item(), out_e.abs().max().item()
    print(
        f"[deepseek] f32 MoE layer with shared experts [{WORLD}, {BATCH}, {s_loc}, {cfg.d_model}], fused vs eager: "
        f"max|diff| {err:.3e} (bound {TOL['float32']:g} x max|eager| {scale:.3e}); aux {aux_f.item():.6f} vs "
        f"{aux_e.item():.6f}"
    )
    if not (torch.isfinite(out_f).all() and err <= TOL["float32"] * scale and torch.equal(aux_f, aux_e)):
        raise SystemExit("chip_smoke: the fused deepseek MoE layer disagrees with the eager one")
    del x, y_f, y_e, out_f, out_e, layer

    # (b) the float32 prefill at DS_F32_LAYERS layers, fused against eager
    result = {"layer_err": err, **_hold_prefill_before_flips("deepseek", cut, params, pc, pc_eager, prompts)}

    # (c) one float32 decode step from the same caches, streamed against gathered
    lg, caches = lm.prefill(params, cut, pc, prompts, max_len=max_len)
    tok = lg[:, -1:].argmax(-1)
    del lg
    outs = {}
    for name, p_ in (("gather", pc), ("stream", pc_stream)):
        c = [{k: t.clone() for k, t in layer_c.items()} for layer_c in caches]
        outs[name], _ = lm.decode_step(params, c, cut, p_, tok, PROMPT)
        del c
    err = (outs["stream"] - outs["gather"]).abs().max().item()
    scale = outs["gather"].abs().max().item()
    print(
        f"[deepseek] f32 decode step ({DS_F32_LAYERS} layers, B {BATCH}), streamed vs gathered MoE decode: max|diff| "
        f"{err:.3e} (bound {TOL['float32']:g} x max|gather| {scale:.3e})"
    )
    if not (torch.isfinite(outs["stream"]).all() and err <= TOL["float32"] * scale):
        raise SystemExit("chip_smoke: the streamed MoE decode disagrees with the gathered one")
    result["decode_stream_err"] = err
    del params, caches, outs
    torch.cuda.empty_cache()

    # (d) bfloat16 at the phase's depth: the main path through serve.greedy, streamed decode
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    expect = {"ag_gemm": cfg.n_layers + cfg.n_layers, "gemm_rs": cfg.n_layers + cfg.n_layers,
              "flash_attention": cfg.n_layers, "matmul": NEW_TOKENS, "grouped_matmul": 2 * WORLD * n_moe,
              "ssd_intra_chunk": 0}  # fmt: skip (qkv / o-proj per layer, plus one dense or shared MLP per layer)
    result.update(_main_path("deepseek", cfg, pc_stream, prompts, expect, profile, params=params))

    # (e) the engine, streamed decode in its captured graphs
    result["engine"], _ = _engine_bf16(cfg, pc_stream, params, ENGINE_DS, profile)
    del params
    torch.cuda.empty_cache()
    return result


def phase_seam(profile: bool = False) -> dict:
    """smollm-360m's forward with fused RS -> AG seams (``fuse_seams``) at
    full width: float32 eager bitwise against the unfused forward, the
    seams counted; float32 on the fused backend against the unfused
    forward; one bf16 layer against the unfused layer, the bf16 forwards
    compared and printed; the counted bf16 run and both forwards' times."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.core import overlap
    from repro_torch.models import lm

    cfg, world, pc, pc_eager, prompts = _setup(ARCH)
    p16 = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    p32 = _f32(p16)
    seam, seam_eager = (dataclasses.replace(p_, fuse_seams=True) for p_ in (pc, pc_eager))
    # (a) float32 eager: the seam's float ops are the unfused pair's
    overlap.matmul_rs_ag.calls = 0
    l_s, _ = lm.forward(p32, cfg, seam_eager, prompts)
    seams = overlap.matmul_rs_ag.calls
    l_u, _ = lm.forward(p32, cfg, pc_eager, prompts)
    diff, scale = (l_s - l_u).abs().max().item(), l_u.abs().max().item()
    print(
        f"[seam] f32 eager forward [{BATCH} x {PROMPT}] with fused seams vs unfused: max|diff| {diff:.3e} "
        f"(bound 0; max|unfused| {scale:.3e}); seams fused {seams} (expected {cfg.n_layers})"
    )
    if not (torch.isfinite(l_s).all() and diff == 0 and seams == cfg.n_layers):
        raise SystemExit("chip_smoke: the f32 seam forward differs from the unfused forward")
    # (b) float32 on the fused backend: the eager seams against the unfused
    # forward's GEMM+RS / AG+GEMM kernels, every layer, the logits' bound
    f_s, _ = lm.forward(p32, cfg, seam, prompts)
    f_u, _ = lm.forward(p32, cfg, pc, prompts)
    _hold_logits("[seam] f32 fused-backend forward logits", f_s, f_u, ("fused seams", "unfused"))
    diff_f = (f_s - f_u).abs().max().item()
    del f_s, f_u
    # (c) bfloat16 on the fused backend: one layer held to 2e-2 of max |f32|
    # (its output less its input); the whole forward printed beside its
    # control, the unfused bf16 forward against f32: 32 random layers carry
    # a bf16 rounding flip anywhere to the size of bf16 noise itself
    d = lm.layer_plan(cfg)[0]
    gen = torch.Generator(device=world.device).manual_seed(2)
    x = torch.randn((WORLD, BATCH, PROMPT // WORLD, cfg.d_model), generator=gen, device=world.device).bfloat16()
    y_s = d.apply_seq_fused(p16["layers"][0], x, seam, cfg)[0].float() - x.float()
    y_u = d.apply_seq(p16["layers"][0], x, pc, cfg)[0].float() - x.float()
    y_r = d.apply_seq(p32["layers"][0], x.float(), pc_eager, cfg)[0] - x.float()
    err_l, scale_l = (y_s - y_u).abs().max().item(), y_r.abs().max().item()
    print(
        f"[seam] bf16 layer [{WORLD}, {BATCH}, {PROMPT // WORLD}, {cfg.d_model}] with its fused seam vs unfused (fused "
        f"backend): max|diff| {err_l:.3e} (bound {TOL['bfloat16']:g} x max|f32 eager| {scale_l:.3e}); vs f32 eager "
        f"{(y_s - y_r).abs().max().item():.3e} (unfused: {(y_u - y_r).abs().max().item():.3e})"
    )
    if not (torch.isfinite(y_s).all() and err_l <= TOL["bfloat16"] * scale_l):
        raise SystemExit("chip_smoke: the bf16 seam layer disagrees with the unfused layer")
    del p32, x, y_s, y_u, y_r
    b_s, _ = lm.forward(p16, cfg, seam, prompts)
    b_u, _ = lm.forward(p16, cfg, pc, prompts)
    diff_b = (b_s.float() - b_u.float()).abs().max().item()
    top1 = (b_s.argmax(-1) == b_u.argmax(-1)).float().mean().item()
    ctl, ctl1 = (b_u.float() - l_u).abs().max().item(), (b_u.argmax(-1) == l_u.argmax(-1)).float().mean().item()
    print(
        f"[seam] bf16 fused-backend forward with fused seams vs unfused: max|diff| {diff_b:.3e} (max|f32| "
        f"{scale:.3e}), top-1 agreement {top1:.4f}; control, unfused bf16 vs f32 eager: {ctl:.3e}, top-1 "
        f"{ctl1:.4f} (printed, not held)"
    )
    if not torch.isfinite(b_s).all():
        raise SystemExit("chip_smoke: the bf16 seam forward is not finite")
    del b_s, b_u, l_s, l_u
    # (c) the counted bf16 run: the chain's ends on the kernels, the seams eager
    torch.cuda.synchronize()
    K.reset_launch_counts()
    overlap.matmul_rs_ag.calls = 0
    lm.forward(p16, cfg, seam, prompts)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    expect = {**{k: 0 for k in counts}, "ag_gemm": cfg.n_layers, "gemm_rs": cfg.n_layers,
              "flash_attention": cfg.n_layers, "matmul": 1}  # fmt: skip
    print(f"[seam] launch counts of one bf16 forward with fused seams: {counts}; seams {overlap.matmul_rs_ag.calls}")
    if counts != expect or overlap.matmul_rs_ag.calls != cfg.n_layers:
        raise SystemExit(f"chip_smoke: the seam forward launched {counts}, expected {expect}")
    times = {name: cuda_ms(lambda: lm.forward(p16, cfg, p_, prompts), 5)
             for name, p_ in (("seam", seam), ("unfused", pc))}  # fmt: skip
    print(f"[seam] bf16 forward ms: fused seams {times['seam']:.3f}, unfused {times['unfused']:.3f} (recorded, not bounded)")
    prof = None
    if profile:
        from repro_torch.benchmarks.common import profile_windows

        prof = profile_windows(f"{cfg.name} bf16 forward", {
            "fused seams": lambda: lm.forward(p16, cfg, seam, prompts),
            "unfused": lambda: lm.forward(p16, cfg, pc, prompts),
        })  # fmt: skip
    del p16
    torch.cuda.empty_cache()
    return {"f32_diff": diff, "f32_fused_diff": diff_f, "bf16_layer_diff": err_l, "bf16_layer_scale": scale_l,
            "bf16_diff": diff_b, "bf16_top1": top1, "bf16_control_diff": ctl, "f32_scale": scale, "seams": seams,
            "counts": counts, "ms": times, "profile": prof}  # fmt: skip


def _record_kept():
    """Record the kept (token, k) pairs of every dispatch table built
    (``core/moe_overlap._dispatch_tables``); returns (the list, a function
    that restores it)."""
    from repro_torch.core import moe_overlap

    calls, tables = [], moe_overlap._dispatch_tables

    def recording(*a, **kw):
        out = tables(*a, **kw)
        calls.append(out.sum((-2, -1)) > 0)  # [W, lead, m_sub, k]
        return out

    moe_overlap._dispatch_tables = recording
    return calls, lambda: setattr(moe_overlap, "_dispatch_tables", tables)


def _kept_sets(pc, cfg, layer, x) -> tuple:
    """One MoE layer's a2a pair in float32, overlapped (the fused backend)
    against ``a2a_moe_baseline``: the outputs, the kept pairs of each and
    the pairs routed to each rank, laid out [rank, origin, sub-chunk, lead,
    token, k]."""
    import torch

    from repro_torch.core.compiler import A2A_SEQ, compile_overlap
    from repro_torch.core.moe_overlap import moe_router
    from repro_torch.core.plan import build_seq_plan
    from repro_torch.nn.layers import ACTS, rms_norm

    m, w = cfg.moe, pc.tp
    h = rms_norm(x, layer["ln"], cfg.norm_eps)
    ids, wts, _ = moe_router(h, layer["router"], num_experts=layer["w_gu"].shape[1] * w, top_k=m.top_k,
                             valid_experts=m.num_experts)  # fmt: skip
    args = (h, ids, wts, layer["w_gu"], layer["w_down"])
    kw = dict(capacity_factor=m.capacity_factor, act=ACTS[cfg.act])
    nch = pc.channel.num_channels
    calls, restore = _record_kept()
    try:
        out = compile_overlap(list(A2A_SEQ), pc.channel, world=pc.world, backend="fused")(*args, **kw)
        n_over = len(calls)
        base = compile_overlap(list(A2A_SEQ), pc.channel, world=pc.world, overlapped=False)(*args, **kw)
    finally:
        restore()
    plan = build_seq_plan(A2A_SEQ, (pc.channel, pc.channel), w, nch).ops[0]
    lead, m_sub, k = calls[0].shape[1], calls[0].shape[2], calls[0].shape[3]
    over = torch.zeros((w, w, nch, lead, m_sub, k), dtype=torch.bool, device=x.device)
    for i, kept in enumerate(calls[:n_over]):  # step-major, then channel
        s, c = divmod(i, nch)
        for r, origin in enumerate(plan.channels[c].source_table(s)):
            over[r, origin, c] = kept[r]
    # the baseline's lead rows are (origin, batch row, sub-chunk)
    kept_b = calls[n_over].reshape(w, w, lead, nch, m_sub, k).permute(0, 1, 3, 2, 4, 5)
    e_loc = layer["w_gu"].shape[1]
    owner = (ids // e_loc).reshape(w, lead, nch, m_sub, k).permute(0, 2, 1, 3, 4)  # [origin, sub-chunk, lead, token, k]
    routed = owner[None] == torch.arange(w, device=x.device).view(w, 1, 1, 1, 1, 1)
    return out, base, over, kept_b, routed


def phase_ep(profile: bool = False) -> dict:
    """deepseek-moe-16b's prefill with ``ep_axis`` (the expert-parallel a2a
    pair, its expert GEMMs on the grouped kernel): one layer's pair against
    its baseline in float32 (kept sets equal), the float32 EP prefill at
    DS_F32_LAYERS layers against the TP-MoE prefill, then in bf16 at
    CUT["deepseek"]'s depth the main path (prefill + greedy decode) through ``serve.greedy``,
    launches held exactly, and the EP / TP prefill and the layer's times."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks.common import fp32_reductions
    from repro_torch.core.compiler import A2A_SEQ, compile_overlap
    from repro_torch.core.moe_overlap import moe_router
    from repro_torch.models import lm
    from repro_torch.nn.layers import ACTS, rms_norm

    cfg, world, pc, pc_eager, prompts = _setup(ARCH_DS, CUT["deepseek"][ARCH_DS])
    pc_ep = dataclasses.replace(pc, ep_axis="model", moe_decode_stream=True)
    pc_tp = dataclasses.replace(pc, moe_decode_stream=True)
    max_len, s_loc = PROMPT + NEW_TOKENS, PROMPT // WORLD
    cut = dataclasses.replace(cfg, n_layers=DS_F32_LAYERS)
    params = lm.init(cut, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)

    # (a) one MoE layer's a2a pair, float32: overlapped on the grouped kernel
    # against the baseline, the same routing; kept pairs compared exactly
    layer = params["layers"][1]["ffn"]
    gen = torch.Generator(device=world.device).manual_seed(1)
    x = torch.randn((WORLD, BATCH, s_loc, cfg.d_model), generator=gen, device=world.device)
    before = K.grouped_matmul.launches
    out, base, kept_o, kept_b, routed = _kept_sets(pc, cfg, layer, x)
    launched = K.grouped_matmul.launches - before
    err, scale = (out - base).abs().max().item(), base.abs().max().item()
    dropped = int(routed.sum() - kept_o.sum())
    print(
        f"[ep] f32 a2a layer [{WORLD}, {BATCH}, {s_loc}, {cfg.d_model}], overlapped (grouped kernel, {launched} "
        f"launches) vs baseline: max|diff| {err:.3e} (bound {TOL['float32']:g} x max|baseline| {scale:.3e}); kept "
        f"sets equal: {bool(torch.equal(kept_o, kept_b))} ({int(kept_o.sum())} of {int(routed.sum())} routed "
        f"(token, k) pairs kept, {dropped} dropped at capacity)"
    )
    if not (torch.isfinite(out).all() and err <= TOL["float32"] * scale and torch.equal(kept_o, kept_b)):
        raise SystemExit("chip_smoke: the a2a layer disagrees with its baseline")
    if bool((kept_o & ~routed).any()):
        raise SystemExit("chip_smoke: the a2a layer kept a pair routed to another rank")
    if launched != 2 * WORLD * pc.channel.num_channels:
        raise SystemExit(f"chip_smoke: the a2a layer launched the grouped kernel {launched} times")
    del x, out, base, layer

    # (b) the float32 EP prefill at DS_F32_LAYERS layers against the TP-MoE prefill
    result = {"layer_err": err, "layer_dropped_slots": dropped}
    result.update(_hold_prefill_before_flips("ep", cut, params, pc_ep, pc_tp, prompts, pair=("EP", "TP-MoE")))
    del params
    torch.cuda.empty_cache()

    # (c) bfloat16 at the phase's depth: the main path with the EP prefill
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    expect = {"ag_gemm": cfg.n_layers + cfg.n_layers, "gemm_rs": cfg.n_layers + cfg.n_layers,
              "flash_attention": cfg.n_layers, "matmul": NEW_TOKENS, "grouped_matmul": 2 * WORLD * n_moe,
              "ssd_intra_chunk": 0}  # fmt: skip (as the deepseek phase: the a2a's 2 launches per step)
    result.update(_main_path("ep", cfg, pc_ep, prompts, expect, profile, params=params))
    print(f"[ep] grouped launches per EP prefill: {result['counts']['grouped_matmul']} (2 x {WORLD} steps x {n_moe} MoE layers)")
    # the two prefills in turns (EP, TP, TP, EP), each reading kept
    runs = {"ep": [], "tp": []}
    for name in ("ep", "tp", "tp", "ep"):
        p_ = pc_ep if name == "ep" else pc_tp
        runs[name].append(cuda_ms(lambda: lm.prefill(params, cfg, p_, prompts, max_len=max_len), 3))
    times = {name: sum(r) / len(r) for name, r in runs.items()}
    times["runs"] = runs
    # one MoE layer's routed path in bf16: the overlapped pair against its baseline
    layer = params["layers"][1]["ffn"]
    x = torch.randn((WORLD, BATCH, s_loc, cfg.d_model), generator=gen, device=world.device).bfloat16()
    h = rms_norm(x, layer["ln"], cfg.norm_eps)
    ids, wts, _ = moe_router(h, layer["router"], num_experts=layer["w_gu"].shape[1] * WORLD, top_k=cfg.moe.top_k,
                             valid_experts=cfg.moe.num_experts)  # fmt: skip
    args = (h, ids, wts, layer["w_gu"], layer["w_down"])
    kw = dict(capacity_factor=cfg.moe.capacity_factor, act=ACTS[cfg.act])
    over = compile_overlap(list(A2A_SEQ), pc.channel, world=world, backend="fused")
    base = compile_overlap(list(A2A_SEQ), pc.channel, world=world, overlapped=False)
    with fp32_reductions():
        y_o, y_b = over(*args, **kw), base(*args, **kw)
        e_b, s_b = (y_o.float() - y_b.float()).abs().max().item(), y_b.float().abs().max().item()
        times["a2a_layer"] = cuda_ms(lambda: over(*args, **kw), 10)
        times["a2a_layer_baseline"] = cuda_ms(lambda: base(*args, **kw), 10)
    print(
        f"[ep] bf16 prefill ms (in turns EP, TP, TP, EP): EP {runs['ep']}, TP-MoE {runs['tp']}; one a2a layer [{WORLD}, {BATCH}, "
        f"{s_loc}, {cfg.d_model}]: overlapped {times['a2a_layer']:.3f} ms, baseline {times['a2a_layer_baseline']:.3f} "
        f"ms, max|diff| {e_b:.3e} (bound {TOL['bfloat16']:g} x max|baseline| {s_b:.3e}) (times recorded, not bounded)"
    )
    if not (torch.isfinite(y_o).all() and e_b <= TOL["bfloat16"] * s_b):
        raise SystemExit("chip_smoke: the bf16 a2a layer disagrees with its baseline")
    result.update(ms=times, layer_bf16_err=e_b)
    del params, layer, x, h, y_o, y_b
    torch.cuda.empty_cache()
    return result


def phase_ssm(profile: bool = False):
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import lm
    from repro_torch.nn import mamba

    cfg, world, pc, pc_eager, prompts = _setup(ARCH_SSM)
    max_len, s_loc = PROMPT + NEW_TOKENS, PROMPT // WORLD
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)

    # (a) one Mamba layer at full width, fused against eager on the same input
    layer = params["layers"][0]["mixer"]
    gen = torch.Generator(device=world.device).manual_seed(1)
    x = torch.randn((WORLD, BATCH, s_loc, cfg.d_model), generator=gen, device=world.device)
    before = K.launch_counts()
    y_f = mamba.apply_seq(layer, x, pc, cfg)
    ran = {k: v - before[k] for k, v in K.launch_counts().items()}
    if ran != {**{k: 0 for k in ran}, "ag_gemm": 1, "gemm_rs": 1, "ssd_intra_chunk": 1}:
        raise SystemExit(f"chip_smoke: the fused Mamba layer launched {ran}")
    y_e = mamba.apply_seq(layer, x, pc_eager, cfg)
    out_f, out_e = y_f - x, y_e - x
    err, scale = (out_f - out_e).abs().max().item(), out_e.abs().max().item()
    print(
        f"[ssm] f32 Mamba layer [{WORLD}, {BATCH}, {s_loc}, {cfg.d_model}], fused vs eager: max|diff| {err:.3e} "
        f"(bound {TOL['float32']:g} x max|eager| {scale:.3e})"
    )
    if not (torch.isfinite(out_f).all() and err <= TOL["float32"] * scale):
        raise SystemExit("chip_smoke: the fused Mamba layer disagrees with the eager one")
    del x, y_f, y_e, out_f, out_e

    # (b) the float32 prefill, fused against eager, every position
    lg_f, _ = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
    lg_e, _ = lm.prefill(params, cfg, pc_eager, prompts, max_len=max_len)
    _hold_logits("[ssm] f32 prefill logits (every position)", lg_f, lg_e)
    result = {"layer_err": err}
    del params, layer, lg_f, lg_e
    torch.cuda.empty_cache()

    # (c) bfloat16: the main path (prefill + greedy decode) through the kernels
    expect = {"ag_gemm": cfg.n_layers, "gemm_rs": cfg.n_layers, "ssd_intra_chunk": cfg.n_layers,
              "matmul": NEW_TOKENS, "flash_attention": 0, "grouped_matmul": 0}  # fmt: skip
    return {**result, **_main_path("ssm", cfg, pc, prompts, expect, profile, pc_eager, layer=True)}


def _engine_requests(cfg, spec: dict, seed: int = 0) -> list:
    """Seeded requests of the engine phase; every (requests / sampled)-th one
    samples at temperature 0.8 / top-k 40, the rest are greedy."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    every = spec["requests"] // spec["sampled"]
    reqs = []
    for i in range(spec["requests"]):
        n, m = (int(rng.integers(lo, hi + 1)) for lo, hi in (spec["prompt"], spec["new"]))
        sampled = i % every == 1
        reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, size=n), max_new_tokens=m,
                            temperature=0.8 if sampled else 0.0, top_k=40 if sampled else 0, seed=i))  # fmt: skip
    return reqs


def _drain(cfg, pc, params, reqs, spec: dict, capture: bool):
    """A new engine, every request submitted, drained; returns (engine,
    tokens per request, wall seconds of the drain)."""
    import torch

    from repro_torch.serving import ServeEngine

    eng = ServeEngine(cfg, pc, params, max_len=spec["max_len"], n_slots=spec["slots"], prefill_chunk=ENGINE_CHUNK,
                      decode_block=spec.get("decode_block", 32), capture=capture)
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.drain(handles)
    wall = time.perf_counter() - t0
    return eng, [outs[h].tolist() for h in handles], wall


def _near_tie_check(tag: str, cfg, pc, params, reqs, toks, max_len: int) -> int:
    """(c): teacher-force per-token reference decoding (``lm.decode_step`` one
    token at a time, the requests side by side with per-row lengths) with the
    engine's tokens; fail where an engine token is not the reference's argmax
    and lies more than NEAR_TIE below it.  Returns the count of near ties."""
    import torch

    from repro_torch.models import lm

    dev = pc.device
    seqs = [[int(t) for t in r.tokens] + t for r, t in zip(reqs, toks)]
    n, steps = len(seqs), max(map(len, seqs))
    mat = torch.zeros((n, steps), dtype=torch.int64)
    for i, sq in enumerate(seqs):
        mat[i, : len(sq)] = torch.tensor(sq)
    mat, lens = mat.to(dev), torch.tensor([len(sq) for sq in seqs], device=dev)
    caches = lm.init_caches(cfg, pc, n, max_len, torch.float32)
    gaps, preds = [], []
    for t in range(steps - 1):
        lg, _ = lm.decode_step(params, caches, cfg, pc, mat[:, t : t + 1], torch.full((n,), t, device=dev),
                               q_valid=(lens > t).long())  # fmt: skip
        row = lg[:, 0].float()
        gaps.append(row.max(-1).values - row.gather(1, mat[:, t + 1 : t + 2])[:, 0])
        preds.append(row.argmax(-1))
    gaps, preds = torch.stack(gaps, 1).cpu(), torch.stack(preds, 1).cpu()  # column t predicts token t + 1
    ties = 0
    for i, (r, tk) in enumerate(zip(reqs, toks)):
        for j, tok in enumerate(tk):
            t = len(r.tokens) + j - 1
            if int(preds[i, t]) != tok:
                ties += 1
                gap = float(gaps[i, t])
                print(f"[engine] {tag}: request {i} token {j}: engine {tok}, reference argmax {int(preds[i, t])}, "
                      f"logit gap {gap:.3e} (allowed below {NEAR_TIE:g})")  # fmt: skip
                if not gap < NEAR_TIE:
                    raise SystemExit(f"chip_smoke: {tag}: the f32 engine diverges from per-token decoding")
    return ties


def _engine_bf16(cfg, pc, params, spec: dict, profile: bool):
    """The engine on seeded requests, captured and eager (bf16 weights):
    tokens bitwise equal, host syncs == steps, 2 captures; returns (the
    record, the seeded requests)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks.common import profile_windows

    reqs = _engine_requests(cfg, spec)
    K.reset_launch_counts()  # the captured engine's path: warm-up, capture and drain
    eng, toks, wall = _drain(cfg, pc, params, reqs, spec, capture=True)
    counts = K.launch_counts()
    eager, toks_e, wall_e = _drain(cfg, pc, params, reqs, spec, capture=False)
    st, st_e = eng.stats, eager.stats
    n_tok = sum(map(len, toks))
    per_step = st["launches"]["matmul"] / st["steps"]
    dec_ms, dec_ms_e = cuda_ms(lambda: eng.run("decode"), ITERS), cuda_ms(lambda: eager.run("decode"), 5)
    print(
        f"[engine] bf16 {cfg.name} W={WORLD}: {len(reqs)} requests ({spec['sampled']} sampled), {n_tok} tokens on "
        f"{spec['slots']} slots; captured {n_tok / wall:.1f} tokens/s, {st['steps']} steps, "
        f"{wall * 1e3 / st['steps']:.2f} ms per step; eager {n_tok / wall_e:.1f} tokens/s, "
        f"{wall_e * 1e3 / st_e['steps']:.2f} ms per step"
    )
    print(
        f"[engine] {cfg.name}: one decode iteration ({spec['slots']} slots) captured {dec_ms:.3f} ms, eager "
        f"{dec_ms_e:.3f} ms (CUDA events); LM-head launches per step {per_step:.2f} (graph replays "
        f"{st['launches']['matmul']}); host syncs {st['host_syncs']}, graph captures {st['graph_captures']}, "
        f"resets {st['resets']}; wrapper launch counts of the captured run {counts}"
    )
    if toks != toks_e:
        raise SystemExit(f"chip_smoke: {cfg.name}: the captured engine's tokens differ from the eager engine's")
    if [len(t) for t in toks] != [r.max_new_tokens for r in reqs] or not all(
        0 <= x < cfg.vocab_size for t in toks for x in t
    ):
        raise SystemExit(f"chip_smoke: {cfg.name}: the engine's token counts or ids are wrong")
    if not (st["host_syncs"] == st["steps"] == st_e["steps"] and st["graph_captures"] == 2 and counts["matmul"]):
        raise SystemExit(f"chip_smoke: {cfg.name}: engine counters {st} / {st_e} break the contract")
    print(f"[engine] {cfg.name}: captured tokens bitwise equal to eager; request 0: {toks[0][:16]}")
    rec = {"tokens_per_s": n_tok / wall, "steps": st["steps"], "ms_per_step": wall * 1e3 / st["steps"],
           "eager_tokens_per_s": n_tok / wall_e, "eager_ms_per_step": wall_e * 1e3 / st_e["steps"],
           "decode_ms": dec_ms, "eager_decode_ms": dec_ms_e, "head_launches_per_step": per_step,
           "head_graph_launches": st["launches"]["matmul"], "tokens": n_tok, "counts": counts}  # fmt: skip
    if profile:  # one decode iteration of the drained engines (every slot dead: nothing a step reads changes)
        rec["profile"] = profile_windows(f"engine {cfg.name}", {
            "captured decode iteration": lambda: eng.run("decode"),
            "eager decode iteration": lambda: eager.run("decode"),
        })  # fmt: skip
    del eng, eager
    torch.cuda.empty_cache()
    return rec, reqs


def phase_engine(profile: bool = False) -> dict:
    import torch

    from repro_torch.models import lm

    out = {}
    for arch, spec in ENGINE.items():
        cfg, world, pc, _, _ = _setup(arch, CUT["engine"][arch])
        params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
        rec, reqs = _engine_bf16(cfg, pc, params, spec, profile)
        rec["layers"] = cfg.n_layers
        del params
        torch.cuda.empty_cache()
        # (c) float32: four greedy requests against per-token reference decoding
        params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
        greedy = [r for r in reqs if r.temperature == 0][:4]
        eng, toks, _ = _drain(cfg, pc, params, greedy, spec, capture=True)
        rec["near_ties"] = _near_tie_check(f"f32 {cfg.name}", cfg, pc, params, greedy, toks, spec["max_len"])
        print(f"[engine] f32 {cfg.name}: 4 greedy requests ({sum(map(len, toks))} tokens) match per-token decoding; "
              f"{rec['near_ties']} near ties")  # fmt: skip
        out[arch] = rec
        del eng, params
        torch.cuda.empty_cache()
    return out


def phase_ring() -> dict:
    """The sequence-parallel attention layer (``apply_seq_ring``) at full
    width: float32 fused vs eager vs ``apply_seq``, bf16 fused vs f32 eager,
    the bf16 layer's counted run and its times."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_attention
    from repro_torch.core.plan import build_plan
    from repro_torch.nn import attention
    from repro_torch.parallel.context import ParallelContext

    world = World(WORLD, "cuda")
    pc, pc_eager = ParallelContext(world=world), ParallelContext(world=world, backend="eager")
    plan = build_plan("ag_attention", pc.channel, WORLD, pc.channel.num_channels)
    per_call = plan.steps * plan.num_channels  # flash launches of one ring
    out, counts = {}, {}
    for arch in RING_ARCHS:
        cfg = get_config(arch)
        lay = attention.layout(cfg, WORLD)
        gen = torch.Generator(device=world.device).manual_seed(0)
        p16 = shard_attention(attention.init(cfg, WORLD, gen, torch.bfloat16, world.device), world)
        p32 = _f32(p16)
        gen = torch.Generator(device=world.device).manual_seed(1)
        x = torch.randn((WORLD, BATCH, PROMPT // WORLD, cfg.d_model), generator=gen, device=world.device)
        tag = f"[ring] {arch} (h_loc {lay.h_loc}, kv_pad {lay.kv_pad}, head dim {cfg.hd}, kv_select {lay.kv_pad > 1})"
        # (a) float32: fused against eager, and the eager ring against apply_seq
        y_f = attention.apply_seq_ring(p32, x, pc, cfg) - x
        y_e = attention.apply_seq_ring(p32, x, pc_eager, cfg) - x
        y_s = attention.apply_seq(p32, x, pc_eager, cfg) - x
        e_fe, e_es, scale = (y_f - y_e).abs().max().item(), (y_e - y_s).abs().max().item(), y_e.abs().max().item()
        print(
            f"{tag} f32 [{WORLD}, {BATCH}, {PROMPT // WORLD}, {cfg.d_model}]: fused vs eager max|diff| {e_fe:.3e}, "
            f"eager ring vs apply_seq {e_es:.3e} (bound {TOL['float32']:g} x max|eager| {scale:.3e})"
        )
        if not (torch.isfinite(y_f).all() and max(e_fe, e_es) <= TOL["float32"] * scale):
            raise SystemExit(f"chip_smoke: {arch}'s f32 ring attention layer disagrees")
        # (b) bfloat16 fused against float32 eager on the same weights
        y_b = attention.apply_seq_ring(p16, x.bfloat16(), pc, cfg).float() - x.bfloat16().float()
        y_r = attention.apply_seq_ring(p32, x.bfloat16().float(), pc_eager, cfg) - x.bfloat16().float()
        e_b, scale_b = (y_b - y_r).abs().max().item(), y_r.abs().max().item()
        print(f"{tag} bf16 fused vs f32 eager: max|diff| {e_b:.3e} (bound {TOL['bfloat16']:g} x max|ref| {scale_b:.3e})")
        if not (torch.isfinite(y_b).all() and e_b <= TOL["bfloat16"] * scale_b):
            raise SystemExit(f"chip_smoke: {arch}'s bf16 ring attention layer disagrees with f32 eager")
        # (c) the counted bf16 run, then the times
        xb = x.bfloat16()
        attention.apply_seq_ring(p16, xb, pc, cfg)  # warm-up, not counted
        torch.cuda.synchronize()
        K.reset_launch_counts()
        attention.apply_seq_ring(p16, xb, pc, cfg)
        torch.cuda.synchronize()
        counts[arch] = K.launch_counts()
        expect = {**{k: 0 for k in counts[arch]}, "ag_gemm": 1, "gemm_rs": 1, "flash_attention": per_call}
        print(f"{tag} launch counts of one bf16 layer: {counts[arch]}")
        if counts[arch] != expect:
            raise SystemExit(f"chip_smoke: {arch}'s ring layer launched {counts[arch]}, expected {expect}")
        times = {}
        for b, s in RING_TOKENS:
            xt = torch.randn((WORLD, b, s // WORLD, cfg.d_model), generator=gen, device=world.device).bfloat16()
            times[f"{b}x{s}"] = {
                "ring_ms": cuda_ms(lambda: attention.apply_seq_ring(p16, xt, pc, cfg), 10),
                "seq_ms": cuda_ms(lambda: attention.apply_seq(p16, xt, pc, cfg), 10),
            }
            print(f"{tag} bf16 {b} x {s} tokens: apply_seq_ring {times[f'{b}x{s}']['ring_ms']:.3f} ms, "
                  f"apply_seq {times[f'{b}x{s}']['seq_ms']:.3f} ms (recorded, not bounded)")  # fmt: skip
            del xt
        out[arch] = {"f32_fused_err": e_fe, "f32_seq_err": e_es, "bf16_err": e_b, "times": times}
        del p16, p32, x, y_f, y_e, y_s, y_b, y_r
        torch.cuda.empty_cache()
    return {"layers": out, "counts": counts, "flash_per_call": per_call}


def phase_train(profile: bool = False) -> dict:
    """smollm-360m trained at its published width, W = 4 (module docstring, phase 11)."""
    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = get_config(ARCH)
    world = World(WORLD, "cuda")
    pc, pc_eager = ParallelContext(world=world), ParallelContext(world=world, backend="eager")
    assert pc.backend == "fused", pc.backend
    out = {}
    # (a) float32: one step at full depth and width, fused against eager
    p32 = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=5)
    res = {}
    for name, p_ in (("fused", pc), ("eager", pc_eager)):
        loss, _, _, grads = loss_and_grads(lm, cfg, p_, p32, batch)
        step = make_train_step(lm, cfg, p_, opt_cfg, grad_masks=lm.grad_masks(cfg, p_))
        new, _, m = step(p32, init_opt_state(lm.trainable(p32, cfg)), batch)
        res[name] = (loss, grads, lm.trainable(new, cfg), m["loss"], m["lr"].item())
    (loss_f, g_f, new_f, sl_f, _), (loss_e, g_e, new_e, sl_e, _) = res["fused"], res["eager"]
    _hold_logits("[train] f32 loss, one step", torch.stack([loss_f, sl_f]), torch.stack([loss_e, sl_e]))
    worst, names = 0.0, []
    for i, (a, b) in enumerate(zip(tree_leaves(g_f), tree_leaves(g_e))):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= GRAD_RTOL):
            names.append((i, tuple(a.shape), rel))
    n_leaves = len(tree_leaves(g_f))
    print(f"[train] f32 gradients, fused vs eager: {n_leaves} leaves, worst max|diff| / max|eager leaf| "
          f"{worst:.3e} (bound {GRAD_RTOL:g} per leaf)")  # fmt: skip
    if names:
        raise SystemExit(f"chip_smoke: f32 fused gradients disagree with eager: {names[:8]}")
    # the update each side made, new - p: Adam's first step moves an element
    # by lr x g / (|g| + eps) (+ decay), so its sign is fixed only where the
    # gradient check above fixes the gradient's sign: held there, and every
    # leaf must have moved by about lr
    lr = res["fused"][4]
    worst_u, held, total, small = 0.0, 0, 0, []
    for i, (a, b, p, g) in enumerate(zip(tree_leaves(new_f), tree_leaves(new_e), tree_leaves(lm.trainable(p32, cfg)),
                                         tree_leaves(g_e))):  # fmt: skip
        u_f, u_e = a - p, b - p
        top = u_e.abs().max().item()
        sure = g.abs() > GRAD_RTOL * g.abs().max()
        rel = ((u_f - u_e).abs() * sure).max().item() / max(top, 1e-30)
        worst_u, held, total = max(worst_u, rel), held + int(sure.sum().item()), total + sure.numel()
        if not (torch.isfinite(u_f).all() and rel <= UPDATE_RTOL and top >= lr / 2):
            small.append((i, tuple(a.shape), rel, top))
    print(f"[train] f32 updates (new - p), fused vs eager: worst max|diff| / max|eager update| {worst_u:.3e} "
          f"(bound {UPDATE_RTOL:g} per leaf) on the {held} of {total} elements whose |eager grad| > {GRAD_RTOL:g} x "
          f"the leaf's max; every leaf's max|update| >= lr/2 = {lr / 2:.3e}")  # fmt: skip
    if small:
        raise SystemExit(f"chip_smoke: the f32 fused train step's updates disagree with eager: {small[:8]}")
    out["f32"] = {"loss": [loss_f.item(), loss_e.item()], "grad_rel_err": worst, "update_rel_err": worst_u,
                  "update_held_elements": [held, total], "leaves": n_leaves}  # fmt: skip
    del p32, res, g_f, g_e, new_f, new_e
    torch.cuda.empty_cache()

    # (b) bf16: TRAIN_STEPS steps of the train entry point, the launches held each step
    run = _bf16_train("train", ARCH, TRAIN_STEPS, layers=CUT["train"][ARCH])
    out["bf16"] = run["record"]
    if profile:
        from repro_torch.benchmarks.common import profile_windows

        step = make_train_step(lm, run["cfg"], pc, opt_cfg, grad_masks=lm.grad_masks(run["cfg"], pc))
        p_, o_ = run["params"], run["opt_state"]
        out["profile"] = profile_windows(f"{cfg.name} train", {"step": lambda: step(p_, o_, batch)})
    del run
    torch.cuda.empty_cache()

    # (c) checkpoint at TRAIN_CKPT_AT, resume: the next step's loss bitwise the uninterrupted run's
    out["resume"] = _resume_check("train", ARCH)
    return out


def _seam_step_f32(cfg, world, batch) -> dict:
    """(b), (c): one float32 step of ``cfg`` (SEAM_F32_LAYERS layers) with
    fused seams on the fused backend, against the same step with seams on
    the eager backend and against the unfused step on the fused backend:
    the loss the logits' bound, every leaf's gradient GRAD_RTOL of its
    max|other|, the seamed step's launches held."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    pc, pc_eager = ParallelContext(world=world), ParallelContext(world=world, backend="eager")
    seam, seam_eager = (dataclasses.replace(p_, fuse_seams=True) for p_ in (pc, pc_eager))
    p32 = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    names = _leaf_names(lm.trainable(p32, cfg))
    K.reset_launch_counts()
    loss_s, _, _, g_s = loss_and_grads(lm, cfg, seam, p32, batch)
    torch.cuda.synchronize()
    counts, expect = K.launch_counts(), paper_e2e.expected_launches(cfg, "overlap", "none", fuse_seams=True)
    print(f"[train_seam] f32 step at {cfg.n_layers} layers with fused seams, launches {counts} (held: {expect})")
    if counts != expect:
        raise SystemExit(f"chip_smoke: the f32 seamed step launched {counts}, expected {expect}")
    out = {"layers": cfg.n_layers, "counts": counts}
    for key, other in (("vs_eager_seams", seam_eager), ("vs_unfused", pc)):
        loss_o, _, _, g_o = loss_and_grads(lm, cfg, other, p32, batch)
        what = "(b) eager backend with seams" if other is seam_eager else "(c) unfused, fused backend"
        _hold_logits(f"[train_seam] f32 loss, fused seams vs {what}", loss_s[None], loss_o[None], ("seams", "other"))
        errs = _grad_errs(names, tree_leaves(g_s), tree_leaves(g_o))
        worst = max(e for _, e, _ in errs)
        bad = [(n, e) for n, e, fine in errs if not (fine and e <= GRAD_RTOL)]
        print(f"[train_seam] f32 gradients, fused seams vs {what}: {len(errs)} leaves, worst max|diff| / max|other "
              f"leaf| {worst:.3e} (bound {GRAD_RTOL:g} per leaf)")  # fmt: skip
        if bad:
            raise SystemExit(f"chip_smoke: the seamed f32 gradients disagree with {what}: {bad[:8]}")
        out[key] = {"loss": [loss_s.item(), loss_o.item()], "grad_rel_err": worst}
        del g_o
    del p32, g_s
    torch.cuda.empty_cache()
    return out


def _dp_worker(data, cfg, runs, kw: dict, layers_f32: int, batch_rows: int, seq: int, remats,
               serve_spec: dict) -> dict:
    """One replica process of the dp phase (imported by name from this
    module by ``launch/train.run_replicas``'s processes): the bf16 ZeRO-3
    runs ``runs`` ((remat, steps) pairs), each the train CLI's replica loop
    (``launch/train.train_replica``, what ``train(data=D)`` runs in each of
    its processes; ``kw`` its keywords but ``remat`` / ``steps``) with the
    data transport timed; then at each remat policy of ``remats`` the
    float32 ZeRO-3 step at ``layers_f32`` layers from this replica's blocks
    on its rows of a ``batch_rows`` x ``seq`` global batch, its gradient
    blocks and (rank 0) the parameters after it, gathered whole; then
    ``psum_compressed`` of a seeded gradient over the group and an exact
    float32 all-reduce of the same, with the transport's staging and staged
    bytes; then the serve_dp phase's replica (:func:`_serve_dp_replica` of
    ``serve_spec``)."""
    import dataclasses

    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.launch import train as train_cli
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.compression import psum_compressed
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.steps import data_blocks, data_parallel_grads, gather_blocks

    cut = dataclasses.replace(cfg, n_layers=layers_f32)
    world = World(WORLD, data.device)
    pc = ParallelContext(world=world, mesh_axes=make_dev_mesh(WORLD, data.size).axes, data=data)
    pipe = SyntheticLM(vocab_size=cut.vocab_size, seq_len=seq, global_batch=batch_rows, n_hosts=data.size,
                       host_id=data.rank)  # fmt: skip
    local = pipe.host_batch()
    masks = lm.grad_masks(cut, pc)
    host = lambda t: t.detach().cpu() if torch.is_tensor(t) else t  # noqa: E731
    out = {"staging": dict(data.staging), "f32": {}, "bf16": {}}
    for remat, steps in runs:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["bf16"][remat] = train_cli.train_replica(data, ARCH, {**kw, "remat": remat, "steps": steps},
                                                     keep_state=False)  # fmt: skip
        out["bf16"][remat]["wall"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for remat in remats:
        p32 = lm.init(cut, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
        blocks = data_blocks(lm, cut, pc, lm.trainable(p32, cut))
        del p32
        loss, _, _, grads, gnorm = data_parallel_grads(lm, cut, pc, blocks, local, remat_policy=remat,
                                                       grad_masks=masks)  # fmt: skip
        step = make_train_step(lm, cut, pc, AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=5), remat_policy=remat,
                               grad_masks=masks)  # fmt: skip
        new, _, m = step(lm.with_tied(blocks, cut), init_opt_state(blocks), local)
        whole = gather_blocks(lm, cut, pc, lm.trainable(new, cut))
        out["f32"][remat] = {"loss": loss.item(), "step_loss": m["loss"].item(), "grad_norm": gnorm.item(),
                             "lr": m["lr"].item(), "grads": tree_map(host, grads),
                             "new": tree_map(host, whole) if data.rank == 0 else None}  # fmt: skip
        del blocks, grads, new, whole
    # (g) int8 error-feedback all-reduce of a [4096, 960] gradient (a smollm leaf's size) over the group
    gen = torch.Generator(device=data.device).manual_seed(100 + data.rank)
    g = torch.randn((4096, 960), generator=gen, device=data.device)
    err = torch.randn((4096, 960), generator=gen, device=data.device) * 1e-3
    with data.counting() as c:
        mean, new_err = psum_compressed(g, err, data)
    exact = data.psum(g + err) / data.size
    # the one collective the gloo table stages through host memory: a ring permute of g, against the peer's g
    with data.counting() as cp:
        got = data.permute(g, [(r, (r + 1) % data.size) for r in range(data.size)])
    src = (data.rank - 1) % data.size
    peer = torch.randn((4096, 960), generator=torch.Generator(device=data.device).manual_seed(100 + src),
                       device=data.device)  # fmt: skip
    out["permute"] = {"bitwise": bool(torch.equal(got, peer)), "staged": dict(cp.staged),
                      "payload": {k: float(sum(v.values())) for k, v in cp.payload.items() if v}}  # fmt: skip
    scale = (g + err).abs().max() / 127.0  # this replica's int8 scale (quantize_int8's)
    out.update(compressed={"max_new_err": new_err.abs().max().item(),
                           "err_vs_exact": (mean - exact).abs().max().item(), "scale": scale.item(),
                           "scale_max": data.pmax(scale.reshape(1))[0].item(), "max_exact": exact.abs().max().item(),
                           "staged": dict(c.staged),
                           "payload": {k: float(sum(v.values())) for k, v in c.payload.items() if v}})  # fmt: skip
    del g, err, mean, new_err, exact, got, peer
    out["serve"] = _serve_dp_replica(data, serve_spec)
    return out


def _dp_expected_bytes(cfg, replicas: int, remat: str, dtype_name: str = "bfloat16") -> dict:
    """``launch/roofline.data_axis_bytes`` of a ZeRO-3 step of ``cfg`` in
    that dtype under ``remat``: the leaves the step gathers at the uses it
    makes (``launch/dryrun.data_leaves``: each once a pass, a remat'd
    layer's again in the backward), on the (pod 1, data ``replicas``, model
    1) mesh (one replica process holds its whole model group)."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as R
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_dev_mesh

    pc = make_dev_mesh(WORLD, replicas).context("meta")
    params, pspecs = S.abstract_params(cfg, pc, getattr(torch, dtype_name))
    leaves = dryrun.data_leaves(cfg, params, pspecs, train=True, remat=remat)
    mesh = {"pod": 1, "data": replicas, "model": 1}
    return R.data_axis_bytes(leaves, mesh, pc.dp_axes, train=True, recompute=remat != "none")[1]


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _dp_run(cfg, d2: dict, remat: str, steps: int, placed_pred: int) -> dict:
    """(a)-(e) of one bf16 ZeRO-3 run at D = DP_REPLICAS under ``remat``:
    launches per replica per step, bytes a step against the model, each
    replica's placed parameters and moments against the plan; the record."""
    from repro_torch.backend.mesh import CommCounter
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.launch import roofline as R

    hist = d2["history"]
    expect = paper_e2e.expected_launches(cfg, "overlap", remat)
    bad = [(r["step"], r["launches"]) for r in hist if r["launches"] != expect]
    totals = [r["launches"] for r in d2["replicas"]]
    print(f"[dp] remat {remat!r}: {DP_REPLICAS} replica processes x W={WORLD} of {ARCH} ({cfg.n_layers} layers) on "
          f"one card, bf16, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step ({TRAIN_BATCH // DP_REPLICAS} rows a replica), ZeRO-3: launches "
          f"per replica per step {hist[0]['launches']} (held exactly: {expect}, every step of rank 0; each replica's "
          f"totals over {steps} steps {totals})")  # fmt: skip
    if bad or any(t != {k: v * steps for k, v in expect.items()} for t in totals):
        raise SystemExit(f"chip_smoke: the data-parallel steps (remat {remat}) launched {bad[:3]} / {totals} "
                         f"(expected {expect})")  # fmt: skip
    want = _dp_expected_bytes(cfg, DP_REPLICAS, remat)
    got = []
    for r in hist:
        counter = CommCounter()
        for kind, nbytes in r["data_bytes"].items():
            counter.add(kind, nbytes, DP_REPLICAS)
        got.append(R.collective_bytes(counter)[1])
    print(f"[dp] remat {remat!r}: data-axis link bytes a step, counted {got[0]} against "
          f"launch/roofline.data_axis_bytes {want} at the step's uses, recompute={remat != 'none'} (held exactly, "
          f"every step; payload {hist[0]['data_bytes']})")  # fmt: skip
    if any(g != want for g in got):
        raise SystemExit(f"chip_smoke: the data transport moved {got[:2]} (remat {remat}), the specs' model says {want}")
    placed = [r["placed_bytes"]["requested"] for r in d2["replicas"]]
    alloc = [r["placed_bytes"]["allocated"] for r in d2["replicas"]]
    errs = [abs(placed_pred - p) / p for p in placed]
    print(f"[dp] remat {remat!r}: device memory each replica's parameter and moment blocks took (from before the "
          f"init to after the placement), the bytes its tensors requested {placed} B (memory_allocated {alloc} B: the caching allocator's blocks, each "
          f"rounded up) against launch/dryrun's arguments of one replica's model group on the (data {DP_REPLICAS}, "
          f"model {WORLD}) mesh {placed_pred} B (rel err {max(errs):.3e}, bound {CAL_ARG_RTOL:g}; memory_allocated "
          f"{max(abs(placed_pred - a) / a for a in alloc):.3e})")  # fmt: skip
    if max(errs) > CAL_ARG_RTOL:
        raise SystemExit(f"chip_smoke: a replica's placed state {placed} misses the plan's {placed_pred}")
    ce = [r["ce"] for r in hist]
    if not all(map(math.isfinite, ce)):
        raise SystemExit(f"chip_smoke: the data-parallel bf16 ce (remat {remat}) is not finite: {ce}")
    return {"ce": ce, "step_ms": [r["ms"] for r in hist], "data_ms": [r["data_ms"] for r in hist],
            "peak_bytes": [r["peak_bytes"] for r in d2["replicas"]], "placed_bytes": placed, "placed_allocated": alloc,
            "placed_predicted": placed_pred, "placed_rel_err": max(errs), "bytes": {"counted": got[0],
            "modelled": want, "payload": hist[0]["data_bytes"]}, "per_step": expect, "launches_by_replica": totals,
            "counts": {k: sum(t[k] for t in totals) for k in totals[0]}}  # fmt: skip


def phase_dp() -> dict:
    """Data-parallel training on the one card (module docstring, phase 11d)."""
    import dataclasses

    import torch

    import chip_smoke as this  # the replica processes import the worker by this module's name, not __main__
    from repro_torch.backend.mesh import World
    from repro_torch.configs import Shape, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import apply_masks, tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = dataclasses.replace(get_config(ARCH), n_layers=CUT["dp"][ARCH])
    out = {}
    torch.cuda.empty_cache()
    plan = dryrun.run_cell(cfg, Shape("train_8x256", TRAIN_SEQ, TRAIN_BATCH, "train"),
                           mesh=make_dev_mesh(WORLD, DP_REPLICAS), remat="none", verbose=False, extrapolate=False)
    args_world = plan["memory"]["world"]["arguments"]
    placed_pred = args_world["params"] + args_world["opt_state"]
    # (a) D = 1 (in this process), then in one spawn of DP_REPLICAS processes: D = 2 at remat "none" and at
    # DP_REMAT (each run from the same seed over the same global batches, its data transport timed), (f) and (g)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, layers=cfg.n_layers, dtype="bf16", world=WORLD, log_every=10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_cli.train(ARCH, steps=DP_D1_STEPS, device="cuda", **kw)
    d1 = {"history": run["history"], "wall": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated()}
    del run
    torch.cuda.empty_cache()
    remats = ("none", DP_REMAT)
    replica_kw = dict(kw, reduce=False, mode="overlap", ckpt_dir=None, ckpt_every=0, lr=3e-4,
                      resume=False, time_data=True)  # the train CLI's defaults but the timed transport
    t0 = time.perf_counter()
    res = train_cli.run_replicas(this._dp_worker, DP_REPLICAS, device="cuda",
                                 staging=train_cli.staging_for("gloo", "cuda"),
                                 args=(cfg, (("none", DP_STEPS), (DP_REMAT, DP_REMAT_STEPS)), replica_kw,
                                       DP_F32_LAYERS, TRAIN_BATCH, TRAIN_SEQ, remats, SERVE_DP))  # fmt: skip
    spawn_wall = time.perf_counter() - t0
    runs = {remat: {"history": res[0]["bf16"][remat]["history"], "wall": res[0]["bf16"][remat]["wall"],
                    "replicas": [r["bf16"][remat] for r in res]} for remat in remats}  # fmt: skip
    out["bf16"] = _dp_run(cfg, runs["none"], "none", DP_STEPS, placed_pred)
    out["bf16_remat"] = _dp_run(cfg, runs[DP_REMAT], DP_REMAT, DP_REMAT_STEPS, placed_pred)
    ce = out["bf16"]["ce"]
    first, last = sum(ce[:5]) / 5, sum(ce[-5:]) / 5
    hist = runs["none"]["history"]
    ms2, data_ms = (_median([r[k] for r in hist[TRAIN_WARMUP:]]) for k in ("ms", "data_ms"))
    ms1 = _median([r["ms"] for r in d1["history"][TRAIN_WARMUP:]])
    hr = runs[DP_REMAT]["history"]
    ms_r, data_r = (_median([r[k] for r in hr[TRAIN_WARMUP:]]) for k in ("ms", "data_ms"))
    mib = lambda b: round(b / 2**20)  # noqa: E731
    print(f"[dp] bf16 ce over {DP_STEPS} steps at D={DP_REPLICAS}: first 5 {first:.4f}, last 5 {last:.4f} (held: "
          f"more than 0.2 lower); step ms median D={DP_REPLICAS} {ms2:.2f} (of which the data transport "
          f"{data_ms:.2f}, host clock, device drained), remat {DP_REMAT!r} {ms_r:.2f} ({data_r:.2f}; steps "
          f"{TRAIN_WARMUP}+ of {DP_REMAT_STEPS}), D=1 {ms1:.2f} (CUDA events, steps {TRAIN_WARMUP}+); tokens/s "
          f"D={DP_REPLICAS} {TRAIN_BATCH * TRAIN_SEQ / ms2 * 1e3:.0f}, D=1 {TRAIN_BATCH * TRAIN_SEQ / ms1 * 1e3:.0f}; "
          f"peak memory per process D={DP_REPLICAS} remat 'none' {[mib(b) for b in out['bf16']['peak_bytes']]} MiB, "
          f"remat {DP_REMAT!r} {[mib(b) for b in out['bf16_remat']['peak_bytes']]} MiB, D=1 {mib(d1['peak'])} MiB; "
          f"walls D=1 {d1['wall']:.1f} s (build and init included) / D={DP_REPLICAS} {runs['none']['wall']:.1f} / "
          f"remat {runs[DP_REMAT]['wall']:.1f} s (init included); the {DP_REPLICAS} processes, from their spawn to "
          f"the end of (g), {spawn_wall:.1f} s")  # fmt: skip
    if not last < first - 0.2:
        raise SystemExit(f"chip_smoke: the data-parallel bf16 loss did not fall: {first} -> {last}")
    out["bf16"].update(median_step_ms=ms2, median_data_ms=data_ms, d1_median_step_ms=ms1, d1_peak_bytes=d1["peak"],
                       walls_s=[d1["wall"], runs["none"]["wall"], runs[DP_REMAT]["wall"], spawn_wall])  # fmt: skip
    out["bf16_remat"].update(median_step_ms=ms_r, median_data_ms=data_r)
    del runs, d1, hist, hr
    torch.cuda.empty_cache()

    # (f) float32 at DP_F32_LAYERS layers, at both remat settings: D = 2 against D = 1 on the same global batch
    cut = dataclasses.replace(cfg, n_layers=DP_F32_LAYERS)
    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    batch = SyntheticLM(vocab_size=cut.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    masks = lm.grad_masks(cut, pc)
    out["f32"] = {}
    for remat in remats:
        got = [r["f32"][remat] for r in res]
        p32 = lm.init(cut, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
        loss1, _, _, g1 = loss_and_grads(lm, cut, pc, p32, batch, remat_policy=remat)
        g1 = apply_masks(lm.sync_grads(g1, cut, pc), masks)
        step = make_train_step(lm, cut, pc, AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=5), remat_policy=remat,
                               grad_masks=masks)  # fmt: skip
        new1, _, m1 = step(p32, init_opt_state(lm.trainable(p32, cut)), batch)
        _hold_logits(f"[dp] f32 loss, one step at D={DP_REPLICAS} against D=1 ({DP_F32_LAYERS} layers, remat {remat!r})",
                     torch.tensor([got[0]["loss"], got[0]["step_loss"]]), torch.stack([loss1, m1["loss"]]).cpu(),
                     pair=(f"D={DP_REPLICAS}", "D=1"))  # fmt: skip
        g2 = this._dp_join(cut, [r["grads"] for r in got])
        worst, bad = 0.0, []
        for i, (a, b) in enumerate(zip(tree_leaves(g2), tree_leaves(g1))):
            b = b.cpu()
            rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            worst = max(worst, rel)
            if not (torch.isfinite(a).all() and rel <= GRAD_RTOL):
                bad.append((i, tuple(a.shape), rel))
        lr = m1["lr"].item()
        p0 = lm.trainable(lm.init(cut, world, torch.Generator(device=world.device).manual_seed(0), torch.float32), cut)
        worst_u, small = 0.0, []
        for i, (a, b, p, g) in enumerate(zip(tree_leaves(got[0]["new"]), tree_leaves(lm.trainable(new1, cut)),
                                             tree_leaves(p0), tree_leaves(g1))):  # fmt: skip
            p, g = p.cpu(), g.cpu()
            u2, u1 = a - p, b.cpu() - p
            top = u1.abs().max().item()
            sure = g.abs() > GRAD_RTOL * g.abs().max()
            rel = ((u2 - u1).abs() * sure).max().item() / max(top, 1e-30)
            worst_u = max(worst_u, rel)
            if not (torch.isfinite(u2).all() and rel <= UPDATE_RTOL and top >= lr / 2):
                small.append((i, tuple(a.shape), rel, top))
        print(f"[dp] f32 ZeRO-3 step at D={DP_REPLICAS} against D=1 ({DP_F32_LAYERS} layers, {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens, remat {remat!r}): worst gradient max|diff| / max|D=1 leaf| {worst:.3e} (bound "
              f"{GRAD_RTOL:g}), worst update {worst_u:.3e} (bound {UPDATE_RTOL:g}, where the gradient's sign is held); "
              f"grad_norm {got[0]['grad_norm']:.6f} against {m1['grad_norm'].item():.6f}")  # fmt: skip
        if bad or small:
            raise SystemExit(f"chip_smoke: the f32 D={DP_REPLICAS} step (remat {remat}) disagrees with D=1: "
                             f"{bad[:4]} {small[:4]}")  # fmt: skip
        out["f32"][remat] = {"grad_rel_err": worst, "update_rel_err": worst_u, "loss": [got[0]["loss"], loss1.item()]}
        del p32, p0, g1, g2, new1
        torch.cuda.empty_cache()
    # (g) psum_compressed over the data group
    comp = [r["compressed"] for r in res]
    half = max(c["max_new_err"] / (c["scale"] / 2) for c in comp)
    held = all(c["max_new_err"] <= c["scale"] / 2 + 1e-6 for c in comp)  # the quant phase's float32 slack
    # the mean is sum_r q_r x s_max / D and the exact one sum_r (q_r s_r + new_err_r) / D: they differ by at most
    # sum_r (127 (s_max - s_r) + s_r / 2) / D (|q_r| <= 127, |new_err_r| <= s_r / 2)
    err = max(c["err_vs_exact"] for c in comp)
    bound = sum(127 * (c["scale_max"] - c["scale"]) + c["scale"] / 2 for c in comp) / len(comp)
    bound += 1e-6 * comp[0]["max_exact"]  # the float32 rounding of the two means
    print(f"[dp] psum_compressed over the data group: max|new_err| / (scale / 2) {half:.7f} (held <= 1, + 1e-6 "
          f"absolute); mean vs exact "
          f"f32 all-reduce max|diff| {err:.3e} (bound sum_r (127 (s_max - s_r) + s_r / 2) / D + 1e-6 max|exact| = "
          f"{bound:.3e}; scales "
          f"{[c['scale'] for c in comp]}; max|exact| {comp[0]['max_exact']:.3e}); payload {comp[0]['payload']}; "
          f"staged through host {comp[0]['staged']}")  # fmt: skip
    print(f"[dp] collective paths: {res[0]['staging']} (gloo; 'host' copies through pinned host memory); a ring "
          f"permute of a [4096, 960] f32 tensor: the peer's tensor bitwise {[r['permute']['bitwise'] for r in res]} "
          f"(held), staged {res[0]['permute']['staged']}, payload {res[0]['permute']['payload']}")  # fmt: skip
    if not all(r["permute"]["bitwise"] for r in res):
        raise SystemExit("chip_smoke: the data group's permute did not deliver the peer's tensor")
    if not (held and err <= bound):
        raise SystemExit(f"chip_smoke: psum_compressed over the data group: {half} / {err} > {bound}")
    out["compressed"] = {"new_err_over_half_scale": half, "err_vs_exact": err, "bound": bound}
    out["staging"] = res[0]["staging"]
    out["counts"] = {k: out["bf16"]["counts"][k] + out["bf16_remat"]["counts"][k] for k in out["bf16"]["counts"]}
    out["serve"] = [r["serve"] for r in res]  # the serve_dp phase's replicas, read by phase_serve_dp
    return out


def _dp_join(cfg, blocks: list):
    """The replicas' gradient blocks of ``cfg``'s trainable tree joined along
    each leaf's data dim (a replicated leaf: the replicas' equal copies)."""
    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.parallel.sharding import data_dim, gather_data, map_specs

    pc = ParallelContext(world=World(WORLD, "meta"), mesh_axes=make_dev_mesh(WORLD, len(blocks)).axes)

    def join(spec, *bs):
        if data_dim(spec, pc.dp_axes) is None:
            if not all(torch.equal(b, bs[0]) for b in bs):
                raise SystemExit("chip_smoke: a replicated leaf's reduced gradient differs between the replicas")
            return bs[0]
        return gather_data(torch.stack(bs), spec, World(len(blocks), "cpu"), pc.dp_axes)

    return map_specs(join, lm.trainable(lm.specs(cfg, pc), cfg), *blocks)


def _serve_dp_replica(data, spec: dict) -> dict:
    """One replica of the serve_dp phase (module docstring, phase 11e), in a
    process of the dp phase's spawn: the serve CLI's context and parameters
    (``launch/serve.serve_context`` / ``serve_params``: this replica's blocks)
    for (a) the bf16 engine on ``spec``'s requests, its launch counts and
    the data transport's payload counted over the drain, the placed blocks'
    bytes and the peak; (b) the float32 engine at SERVE_DP_F32_LAYERS
    layers on the same requests; (c) ``serve.greedy`` on this replica's rows
    of the serve phase's prompts, bf16 at CUT["dp"]'s depth (counted), and the
    float32 prefill logits at SERVE_DP_F32_LAYERS layers against D = 1's on
    the same rows in this process."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import CommCounter
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.train import device_bytes
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serving import ServeEngine

    dev = data.device
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CUT["dp"][ARCH])
    cut = dataclasses.replace(cfg, n_layers=SERVE_DP_F32_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pc = serve.serve_context(WORLD, dev, data)
    reqs = _engine_requests(cfg, spec)
    kw = dict(max_len=spec["max_len"], n_slots=spec["slots"], prefill_chunk=ENGINE_CHUNK,
              decode_block=spec["decode_block"])  # fmt: skip
    out = {}
    # (a) the bf16 engine at CUT["dp"]'s depth, full width
    before = device_bytes(dev)
    params = serve.serve_params(cfg, pc, "bf16", seed=0, log=False)
    placed = {k: v - before[k] for k, v in device_bytes(dev).items()}
    eng = ServeEngine(cfg, pc, params, **kw)
    handles = [eng.submit(r) for r in reqs]
    counter = CommCounter()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with data.counting(counter):
        outs = eng.drain(handles)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    out["engine"] = {"tokens": [outs[h].tolist() for h in handles], "wall": wall, "counts": counts,
                     "stats": {k: v for k, v in eng.stats.items() if k != "launches"}, "placed": placed,
                     "payload": {k: float(sum(v.values())) for k, v in counter.payload.items() if v},
                     "n_loc": eng.pool.n_loc, "capture": eng.capture}  # fmt: skip
    del eng
    # (c) serve.greedy on this replica's rows, bf16, counted
    prompts = torch.from_numpy(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, seed=0)).to(dev)
    K.reset_launch_counts()
    with torch.no_grad():
        toks, timings = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS)
    out["greedy"] = {"counts": K.launch_counts(), "rows": toks.shape[0], "timings": timings,
                     "tokens_ok": bool(((toks >= 0) & (toks < cfg.vocab_size)).all())}  # fmt: skip
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, toks
    torch.cuda.empty_cache()
    # (b) float32 at SERVE_DP_F32_LAYERS layers: the engine's tokens (held against D = 1 by the parent)
    p32 = serve.serve_params(cut, pc, "f32", seed=0, log=False)
    eng = ServeEngine(cut, pc, p32, **kw)
    handles = [eng.submit(r) for r in reqs]
    outs = eng.drain(handles)
    out["f32_tokens"] = [outs[h].tolist() for h in handles]
    del eng
    # (c) the float32 prefill logits of this replica's rows against D = 1's in this process
    rows = data.shard(prompts, 0)
    with torch.no_grad():
        got = lm.prefill(p32, cut, pc, rows, max_len=PROMPT)[0]
        whole = lm.init(cut, pc.world, torch.Generator(device=dev).manual_seed(0), torch.float32)
        want = lm.prefill(whole, cut, ParallelContext(world=pc.world), rows, max_len=PROMPT)[0]
    diff = (got - want).abs()
    out["greedy"]["f32"] = {"max_abs": diff.max().item(), "worst": (diff - LOGIT_RTOL * want.abs()).max().item(),
                            "max_ref": want.abs().max().item(), "finite": bool(torch.isfinite(got).all()),
                            "n": got.numel()}  # fmt: skip
    del p32, whole, got, want, diff
    torch.cuda.empty_cache()
    return out


def phase_serve_dp(reps: list, smi: str) -> dict:
    """Data-parallel serving on the one card (module docstring, phase 11e):
    the replicas' records from the dp phase's spawn, held against the D = 1
    engine and the model of the data transport."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import CommCounter, World
    from repro_torch.configs import Shape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as R
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    spec, n = SERVE_DP, DP_REPLICAS
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CUT["dp"][ARCH])
    cut = dataclasses.replace(cfg, n_layers=SERVE_DP_F32_LAYERS)
    reqs = _engine_requests(cfg, spec)
    engines = [r["engine"] for r in reps]
    e0 = engines[0]
    st = e0["stats"]
    n_tok = sum(map(len, e0["tokens"]))
    if any(e["tokens"] != e0["tokens"] or e["stats"] != st for e in engines):
        raise SystemExit("chip_smoke: serve_dp: the replicas' engines returned different tokens or counters")
    if [len(t) for t in e0["tokens"]] != [r.max_new_tokens for r in reqs] or not all(
        0 <= x < cfg.vocab_size for t in e0["tokens"] for x in t
    ):
        raise SystemExit("chip_smoke: serve_dp: the engine's token counts or ids are wrong")
    if not (st["host_syncs"] == st["steps"] > 0 and st["graph_captures"] == 0 and not e0["capture"]
            and e0["n_loc"] == spec["slots"] // n):  # fmt: skip
        raise SystemExit(f"chip_smoke: serve_dp: engine counters {st} break the contract")
    # (a) launches per replica against the D = 1 eager engine on n_slots / D slots (per lm.decode_step call)
    world = World(WORLD, "cuda")
    pc1 = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    K.reset_launch_counts()
    eng1, toks1, wall1 = _drain(cfg, pc1, params, reqs, {**spec, "slots": spec["slots"] // n}, capture=False)
    c1, calls1 = K.launch_counts(), eng1.stats["decode_calls"]
    del eng1, params
    torch.cuda.empty_cache()
    calls = st["decode_calls"]
    bad = [(k, e["counts"][k], c1[k]) for e in engines for k in c1 if e["counts"][k] * calls1 != c1[k] * calls]
    per_step = {k: v / st["steps"] for k, v in e0["counts"].items() if v}
    print(f"[serve_dp] (a) bf16 {ARCH} at D={n} replica processes x W={WORLD} on one card ({smi}): {len(reqs)} requests "
          f"({spec['sampled']} sampled), {n_tok} tokens on {spec['slots']} slots ({spec['slots'] // n} a replica), "
          f"decode block {spec['decode_block']}: {n_tok / e0['wall']:.1f} tokens/s, {st['steps']} steps, "
          f"{e0['wall'] * 1e3 / st['steps']:.2f} ms per step ({e0['wall']:.2f} s, rank 0's host clock); host syncs "
          f"{st['host_syncs']}, graph captures {st['graph_captures']}, lm.decode_step calls {calls}; launches per "
          f"replica per step {per_step} ({[e['counts'] for e in engines]} over the run), the D=1 eager engine on "
          f"{spec['slots'] // n} slots {c1} over {calls1} calls (held: equal per call); D=1 {n_tok / wall1:.1f} "
          f"tokens/s")  # fmt: skip
    if bad or not e0["counts"]["matmul"]:
        raise SystemExit(f"chip_smoke: serve_dp: launches per call differ from the D=1 engine's: {bad}")
    # the data transport: data_axis_bytes of one decode_step's gathers x the calls, plus the token-buffer gathers
    pcm = make_dev_mesh(WORLD, n).context("meta")
    aparams, pspecs = S.abstract_params(cfg, pcm, torch.bfloat16)
    mesh = {"pod": 1, "data": n, "model": 1}
    per_call = R.data_axis_bytes(dryrun.data_leaves(cfg, aparams, pspecs, train=False), mesh, pcm.dp_axes,
                                 train=False, recompute=False)[1]  # fmt: skip
    sync = CommCounter()
    sync.add("all_gather", n * (spec["slots"] // n + 1) * (spec["decode_block"] + 1) * 8 * st["steps"], n)
    want = {"all-gather": per_call["all-gather"] * calls + R.collective_bytes(sync)[1]["all-gather"]}
    got = []
    for e in engines:
        counter = CommCounter()
        for kind, nbytes in e["payload"].items():
            counter.add(kind, nbytes, n)
        got.append(R.collective_bytes(counter)[1])
    print(f"[serve_dp] (a) data-axis link bytes of the drain, counted {got} against launch/roofline.data_axis_bytes "
          f"of one decode_step's gathers {per_call} x {calls} calls + {st['steps']} token-buffer all-gathers = {want} "
          f"(held exactly); {want['all-gather'] / st['steps']:.0f} B a step")  # fmt: skip
    if any(g != want for g in got):
        raise SystemExit(f"chip_smoke: serve_dp: the data transport moved {got}, the model says {want}")
    plan = dryrun.run_cell(cfg, Shape("decode_serve_dp", spec["max_len"], spec["slots"], "decode"),
                           mesh=make_dev_mesh(WORLD, n), remat="none", verbose=False, extrapolate=False)  # fmt: skip
    pred = plan["memory"]["world"]["arguments"]["params"]
    placed = [r["engine"]["placed"]["requested"] for r in reps]
    alloc = [r["engine"]["placed"]["allocated"] for r in reps]
    errs = [abs(pred - b) / b for b in placed]
    peaks = [r["peak_bytes"] for r in reps]
    print(f"[serve_dp] (a) each replica's placed parameter blocks: requested {placed} B (memory_allocated {alloc} B) "
          f"against launch/dryrun's parameter arguments of one replica's model group {pred} B (rel err "
          f"{max(errs):.3e}, bound {CAL_ARG_RTOL:g}); peak memory per process {[round(b / 2**20) for b in peaks]} "
          f"MiB")  # fmt: skip
    if max(errs) > CAL_ARG_RTOL:
        raise SystemExit(f"chip_smoke: serve_dp: a replica's placed blocks {placed} miss the plan's {pred}")
    # (b) float32 at SERVE_DP_F32_LAYERS layers: D = 2 against the D = 1 engine on the same requests
    toks2 = reps[0]["f32_tokens"]
    p32 = lm.init(cut, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    eng1, toks1, _ = _drain(cut, pc1, p32, reqs, spec, capture=False)
    del eng1
    differ = [i for i, (a, b) in enumerate(zip(toks2, toks1)) if a != b]
    if any(r["f32_tokens"] != toks2 for r in reps) or any(reqs[i].temperature > 0 for i in differ):
        raise SystemExit(f"chip_smoke: serve_dp: f32 requests {differ} differ from D=1 (sampled, or between replicas)")
    ties = _near_tie_check(f"serve_dp f32 {cut.name}", cut, pc1, p32, [reqs[i] for i in differ],
                           [toks2[i] for i in differ], spec["max_len"]) if differ else 0  # fmt: skip
    print(f"[serve_dp] (b) f32 {ARCH} at {SERVE_DP_F32_LAYERS} layers, D={n} against D=1 on the same {len(reqs)} "
          f"requests: {len(reqs) - len(differ)} equal token for token (the sampled ones all), {len(differ)} differ "
          f"within the {NEAR_TIE:g} logit gap ({ties} near ties)")  # fmt: skip
    del p32
    torch.cuda.empty_cache()
    # (c) serve.greedy at D = 2: launches per replica, f32 logits against D = 1 on the same rows
    expect = {"ag_gemm": 2 * cfg.n_layers, "gemm_rs": 2 * cfg.n_layers, "flash_attention": cfg.n_layers,
              "matmul": NEW_TOKENS}  # fmt: skip
    gr = [r["greedy"] for r in reps]
    f32 = [g["f32"] for g in gr]
    print(f"[serve_dp] (c) serve.greedy at D={n}: {BATCH} x {PROMPT} prompt tokens, {gr[0]['rows']} rows a replica, "
          f"{NEW_TOKENS} new; launches per replica {[g['counts'] for g in gr]} (held: {expect}, the prefill's and "
          f"{NEW_TOKENS - 1} decode heads); prefill {[round(g['timings']['prefill_s'] * 1e3, 2) for g in gr]} ms, "
          f"decode {[round(g['timings']['decode_s'] * 1e3, 2) for g in gr]} ms; f32 prefill logits at "
          f"{SERVE_DP_F32_LAYERS} layers against D=1 on the same rows: max|diff| {[f['max_abs'] for f in f32]} (bound "
          f"{LOGIT_ATOL:g} + {LOGIT_RTOL:g} |D=1|; max|D=1| {[round(f['max_ref'], 3) for f in f32]})")  # fmt: skip
    nonzero = [{k: v for k, v in g["counts"].items() if v} for g in gr]
    if any(c != expect for c in nonzero) or not all(g["tokens_ok"] for g in gr):
        raise SystemExit(f"chip_smoke: serve_dp: serve.greedy launched {nonzero} (expected {expect})")
    if not all(f["finite"] and f["worst"] <= LOGIT_ATOL for f in f32):
        raise SystemExit(f"chip_smoke: serve_dp: the D={n} f32 prefill logits disagree with D=1's: {f32}")
    counts = {k: sum(e["counts"][k] + g["counts"][k] for e, g in zip(engines, gr)) for k in c1}
    return {"tokens_per_s": n_tok / e0["wall"], "ms_per_step": e0["wall"] * 1e3 / st["steps"], "steps": st["steps"],
            "decode_calls": calls, "per_step": per_step, "d1_counts": c1, "d1_calls": calls1,
            "bytes": {"counted": got[0], "modelled": want, "per_call": per_call}, "placed": placed,
            "placed_predicted": pred, "placed_rel_err": max(errs), "peak_bytes": peaks, "f32_differ": differ,
            "near_ties": ties, "greedy": gr, "counts": counts, "d1_tokens_per_s": n_tok / wall1}  # fmt: skip


def phase_train_seam() -> dict:
    """smollm-360m trained with fused RS -> AG seams (module docstring, phase 11b)."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.configs import get_config
    from repro_torch.core import overlap
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    seam = dataclasses.replace(pc, fuse_seams=True)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batches = [pipe.host_batch() for _ in range(SEAM_TRAIN_STEPS)]
    opt_cfg = AdamWConfig(total_steps=SEAM_TRAIN_STEPS + 1, warmup_steps=1)
    # (a) bf16 at full depth and width: the seamed and the unfused step in turns, each on its own state
    expect = {"seams": paper_e2e.expected_launches(cfg, "overlap", "none", fuse_seams=True),
              "unfused": paper_e2e.expected_launches(cfg, "overlap", "none")}  # fmt: skip
    runs = {}
    for name, p_ in (("seams", seam), ("unfused", pc)):
        params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
        runs[name] = {"params": params, "opt": init_opt_state(lm.trainable(params, cfg)), "ms": [], "loss": [],
                      "peak": 0, "step": make_train_step(lm, cfg, p_, opt_cfg, grad_masks=lm.grad_masks(cfg, p_),
                                                         donate=True)}  # fmt: skip
    total = dict.fromkeys(K.launch_counts(), 0)
    seams = 0
    for i, batch in enumerate(batches):
        for name in ("seams", "unfused") if i % 2 == 0 else ("unfused", "seams"):
            r = runs[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            overlap.matmul_rs_ag.calls = 0
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r["params"], r["opt"], m = r["step"](r["params"], r["opt"], batch)
            e1.record()
            e1.synchronize()
            counts = K.launch_counts()
            if counts != expect[name]:
                raise SystemExit(f"chip_smoke: the bf16 {name} train step {i} launched {counts}, expected {expect[name]}")
            if name == "seams":
                total = {k: total[k] + v for k, v in counts.items()}
                seams += overlap.matmul_rs_ag.calls
            r["ms"].append(e0.elapsed_time(e1))
            r["loss"].append(m["loss"].item())
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
    out = {"per_step": expect, "seams_per_step": seams // SEAM_TRAIN_STEPS}
    for name, r in runs.items():
        med = sorted(r["ms"][1:])[(len(r["ms"]) - 1) // 2]
        print(f"[train_seam] (a) bf16 {ARCH} ({cfg.n_layers} layers) W={WORLD}, {SEAM_TRAIN_STEPS} AdamW steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {name}: launches per step {expect[name]} (held, every step); "
              f"losses {[round(v, 4) for v in r['loss']]}; step ms {[round(v, 2) for v in r['ms']]} (CUDA events; "
              f"median after the first {med:.2f}); peak memory {r['peak'] / 2**20:.0f} MiB")  # fmt: skip
        if not all(map(math.isfinite, r["loss"])):
            raise SystemExit(f"chip_smoke: the bf16 {name} train steps' loss is not finite: {r['loss']}")
        out[name] = {"ms": r["ms"], "median_ms": med, "loss": r["loss"], "peak_bytes": r["peak"]}
    print(f"[train_seam] (a) seams fused per step {out['seams_per_step']} (one a layer); seamed over unfused step "
          f"ms {out['seams']['median_ms'] / out['unfused']['median_ms']:.3f} (recorded, not bounded)")  # fmt: skip
    # (d) one bf16 step under remat "dots" with seams: each scan unit's chain recomputed in the backward
    r = runs["seams"]
    step = make_train_step(lm, cfg, seam, opt_cfg, remat_policy="dots", grad_masks=lm.grad_masks(cfg, seam),
                           donate=True)  # fmt: skip
    remat_expect = paper_e2e.expected_launches(cfg, "overlap", "dots", fuse_seams=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    r["params"], r["opt"], m = step(r["params"], r["opt"], batches[0])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    total = {k: total[k] + v for k, v in counts.items()}
    print(f"[train_seam] (d) bf16 step with seams under remat \"dots\": launches {counts} (held: {remat_expect}); "
          f"loss {m['loss'].item():.4f}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")  # fmt: skip
    if counts != remat_expect or not math.isfinite(m["loss"].item()):
        raise SystemExit(f"chip_smoke: the remat seamed step launched {counts} (expected {remat_expect}) or its loss "
                         f"is not finite")  # fmt: skip
    out["remat"] = {"counts": counts, "per_step": remat_expect, "loss": m["loss"].item(),
                    "peak_bytes": torch.cuda.max_memory_allocated()}  # fmt: skip
    del runs, r, step
    torch.cuda.empty_cache()
    # (b), (c) float32 at SEAM_F32_LAYERS layers
    out["f32"] = _seam_step_f32(dataclasses.replace(cfg, n_layers=SEAM_F32_LAYERS), world, batches[0])
    out["counts"] = total  # the main path's launches: (a)'s seamed steps and (d)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[train_seam] phase wall time {out['wall_s']:.1f} s")
    return out


def phase_examples() -> dict:
    """The examples on the card (module docstring, phase 11c)."""
    from repro_torch import kernels as K
    from repro_torch.examples import moe_overlap_demo, quickstart

    out = {}
    K.reset_launch_counts()
    q = quickstart.main([])
    counts = K.launch_counts()
    ring, gather = q["counts"]["tilelink"], q["counts"]["non-overlap"]
    print(f"[examples] quickstart: launches {counts}; transport {q['counts']}")
    if counts["ag_gemm"] != 1 or not ring.get("permute") or ring.get("all_gather") or not gather.get("all_gather"):
        raise SystemExit(f"chip_smoke: the quickstart ran {counts} with transport {q['counts']}")
    out["quickstart"] = {**q, "launches": counts}
    K.reset_launch_counts()
    moe = moe_overlap_demo.main([])
    counts = K.launch_counts()
    print(f"[examples] moe_overlap_demo: launches {counts}")
    if counts["grouped_matmul"] != 2 * 8 or moe["grouped_launches"] != counts["grouped_matmul"]:
        raise SystemExit(f"chip_smoke: the MoE demo launched {counts}, expected 2 grouped GEMMs at each of 8 steps")
    out["moe_overlap_demo"] = {**moe, "launches": counts}
    out["counts"] = {k: out["quickstart"]["launches"][k] + counts[k] for k in counts}
    return out


def _bf16_train(tag: str, arch: str, steps: int, layers=None, loss_fall: bool = True, remat: str = "none",
                lr: float = 3e-4) -> dict:  # fmt: skip
    """``steps`` bf16 steps of the train entry point (``launch/train.train``,
    TRAIN_BATCH x TRAIN_SEQ tokens, W = 4, ``remat`` its remat policy, ``lr``
    its learning rate) at
    ``layers`` (None: the full depth): every step's launches held to
    ``paper_e2e.expected_launches``, the mean ce of the last 5 steps held
    more than 0.2 below the first 5's (``loss_fall``; the JAX package's loss
    test), the peak memory below the card's, the median step ms (CUDA
    events) and tokens/s recorded.  Returns the train run with its
    ``record``."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg
    expect = paper_e2e.expected_launches(cfg, "overlap", remat)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    run = train_cli.train(arch, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, layers=layers, dtype="bf16",
                          world=WORLD, device="cuda", log_every=10, remat=remat, lr=lr)  # fmt: skip
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = run["history"]
    bad = [(r["step"], r["launches"]) for r in hist if r["launches"] != expect]
    print(f"[{tag}] {arch} launches per bf16 step, remat policy {remat!r} (held exactly, every step): "
          f"{hist[0]['launches']}; all {len(hist)} steps: {counts}")  # fmt: skip
    if bad or counts != {k: v * steps for k, v in expect.items()}:
        raise SystemExit(f"chip_smoke: {arch}'s train steps launched {bad[:3]} (expected {expect} each)")
    ce = [r["ce"] for r in hist]
    warm = min(TRAIN_WARMUP, steps - 1)
    ms = sorted(r["ms"] for r in hist[warm:])
    med = ms[len(ms) // 2] if len(ms) % 2 else (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    tps = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    first, last = sum(ce[:5]) / len(ce[:5]), sum(ce[-5:]) / len(ce[-5:])
    fall = "held: more than 0.2 lower" if loss_fall else "not held"
    print(f"[{tag}] bf16 {arch} ({cfg.n_layers} layers) W={WORLD}, {steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens at lr {lr:g}: mean ce of the first 5 steps {first:.4f}, of the last 5 {last:.4f} ({fall}); step {med:.2f} ms "
          f"(median of steps {warm}-{steps - 1}, CUDA events), {tps:.0f} tokens/s, peak memory {peak / 2**20:.0f} "
          f"MiB")  # fmt: skip
    if not all(map(math.isfinite, ce)) or (loss_fall and not last < first - 0.2):
        raise SystemExit(f"chip_smoke: {arch}'s bf16 loss did not fall: {first} -> {last}")
    if peak >= torch.cuda.get_device_properties(0).total_memory:
        raise SystemExit(f"chip_smoke: {arch}'s train step peaked at {peak} bytes, above the card's memory")
    run["record"] = {"layers": cfg.n_layers, "remat": remat, "lr": lr, "ce": ce, "step_ms": [r["ms"] for r in hist], "median_step_ms": med,
                     "tokens_per_s": tps, "peak_bytes": peak, "counts": counts, "per_step": expect}  # fmt: skip
    return run


def _resume_check(tag: str, arch: str, layers: int = TRAIN_CKPT_LAYERS, remat: str = "none") -> dict:
    """A checkpoint at step TRAIN_CKPT_AT of a ``layers``-layer bf16 run of
    ``arch`` at full width (``remat`` its remat policy), resumed: the next
    step's loss and the parameters after it bitwise the uninterrupted
    run's."""
    import tempfile

    import torch

    from repro_torch.launch import train as train_cli
    from repro_torch.training.optimizer import tree_leaves

    with tempfile.TemporaryDirectory() as d:
        kw = dict(layers=layers, steps=TRAIN_CKPT_AT + 1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype="bf16",
                  world=WORLD, device="cuda", ckpt_dir=d, log_every=100, remat=remat)  # fmt: skip
        ref = train_cli.train(arch, ckpt_every=TRAIN_CKPT_AT, **kw)
        last_ckpt = Path(d) / f"step_{TRAIN_CKPT_AT + 1:08d}"
        for f in last_ckpt.iterdir():
            f.unlink()
        last_ckpt.rmdir()  # the uninterrupted run's final checkpoint; the resume takes step TRAIN_CKPT_AT
        resumed = train_cli.train(arch, ckpt_every=0, **kw)
    a, b = ref["history"][-1], resumed["history"]
    same_params = all(torch.equal(x, y) for x, y in zip(tree_leaves(ref["params"]), tree_leaves(resumed["params"])))
    print(f"[{tag}] {arch} checkpoint at step {TRAIN_CKPT_AT} ({layers} layers, full width, bf16), "
          f"resumed: step {a['step']} loss {a['loss']!r} uninterrupted, {b[0]['loss']!r} resumed (held bitwise); "
          f"parameters after it bitwise equal: {same_params} (held: the moments and the step count)")  # fmt: skip
    if len(b) != 1 or b[0]["step"] != a["step"] or b[0]["loss"] != a["loss"] or not same_params:
        raise SystemExit(f"chip_smoke: {arch}'s resumed run's loss or parameters differ from the uninterrupted run's")
    del ref, resumed
    torch.cuda.empty_cache()
    return {"loss": a["loss"], "resumed_loss": b[0]["loss"], "params_bitwise": same_params}


def _leaf_names(tree, prefix="") -> list:
    """The dotted path of every leaf of a parameter tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _grad_errs(names, got, ref) -> list:
    """(name, max|got - ref| / max|ref|, finite and ref non-zero) per gradient leaf."""
    import torch

    out = []
    for name, a, b in zip(names, got, ref):
        top = b.abs().max().item()
        out.append((name, (a - b).abs().max().item() / max(top, 1e-30), bool(torch.isfinite(a).all()) and top > 0))
    return out


def _moe_layer_grads(arch: str) -> dict:
    """(a): one MoE layer of ``arch`` at its published width in float32 (its
    first MoE layer: deepseek's has the shared experts), TRAIN_BATCH x
    TRAIN_SEQ tokens, on the TP double ring and on the EP a2a pair: the
    fused backend's dx and every leaf's gradient (router, w_gu, w_down,
    norm, shared MLP) against the eager backend's, GRAD_RTOL of each leaf's
    max|eager|; the routing of the two bitwise equal (the same router op on
    the same input); the fused launches held (4 x W grouped: gate|up and
    down at each of the W steps, forward and dx; the shared MLP's pair both
    passes)."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn import moe
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten

    cfg = get_config(arch)
    k0 = cfg.moe.first_k_dense
    world = World(WORLD, "cuda")
    params = lm.init(dataclasses.replace(cfg, n_layers=k0 + 1), world,
                     torch.Generator(device=world.device).manual_seed(0), torch.float32)  # fmt: skip
    layer = params["layers"][k0]["ffn"]
    del params
    gen = torch.Generator(device=world.device).manual_seed(1)
    x = torch.randn((WORLD, TRAIN_BATCH, TRAIN_SEQ // WORLD, cfg.d_model), generator=gen, device=world.device)
    dy = torch.randn(x.shape, generator=gen, device=world.device)
    names = ["dx"] + _leaf_names(layer)
    shared = 2 if "shared" in layer else 0
    expect = {"matmul": 0, "ag_gemm": shared, "gemm_rs": shared, "flash_attention": 0, "grouped_matmul": 4 * WORLD,
              "ssd_intra_chunk": 0}  # fmt: skip
    out = {}
    for path, ep in (("tp", None), ("ep", "model")):
        res = {}
        for backend in ("fused", "eager"):
            pc = ParallelContext(world=world, backend=backend, ep_axis=ep)
            leaves = [t.detach().requires_grad_(True) for t in tree_leaves(layer)]
            xin = x.detach().requires_grad_(True)
            calls, restore = _record_routing()
            K.reset_launch_counts()
            try:
                y, aux = moe.apply_seq(tree_unflatten(layer, leaves), xin, pc, cfg)
                grads = torch.autograd.grad((y * dy).sum() + aux, [xin] + leaves)
            finally:
                restore()
            res[backend] = (grads, calls, K.launch_counts())
        (g_f, r_f, c_f), (g_e, r_e, _) = res["fused"], res["eager"]
        same_routing = len(r_f) == len(r_e) == 1 and torch.equal(r_f[0], r_e[0])
        errs = _grad_errs(names, g_f, g_e)
        worst = max(e for _, e, _ in errs)
        print(f"[train_moe] f32 {arch} MoE layer ({path}) [{WORLD}, {TRAIN_BATCH}, {TRAIN_SEQ // WORLD}, "
              f"{cfg.d_model}], fused vs eager: routing bitwise equal {same_routing}; {len(errs)} gradients (dx, "
              f"{', '.join(names[1:])}), worst max|diff| / max|eager| {worst:.3e} (bound {GRAD_RTOL:g} each); "
              f"launches {c_f}")  # fmt: skip
        bad = [(n, e) for n, e, ok in errs if not (ok and e <= GRAD_RTOL)]
        if bad or not same_routing or c_f != expect:
            raise SystemExit(f"chip_smoke: {arch}'s f32 MoE layer ({path}) gradients, fused vs eager: {bad}, routing "
                             f"equal {same_routing}, launches {c_f} (expected {expect})")  # fmt: skip
        out[path] = {"grad_rel_err": dict((n, e) for n, e, _ in errs), "launches": c_f}
    del layer, x, dy, res
    torch.cuda.empty_cache()
    return out


def _moe_step_f32() -> dict:
    """(b): one float32 step's loss and gradients of granite-moe-3b-a800m at
    TRAIN_MOE_F32_LAYERS layers (published width, TRAIN_BATCH x TRAIN_SEQ
    tokens), fused against eager, every router call's expert sets recorded:
    the loss held to the logits' bound; at most TRAIN_MOE_MAX_FLIPS flips
    a layer; with no flip every leaf's gradient held to GRAD_RTOL of its
    max|eager|, else the flips and the worst error printed (a flipped token
    moves its experts' gradients by O(1); the layer check (a) holds the
    gradients then)."""
    import dataclasses

    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = dataclasses.replace(get_config(ARCH_MOE), n_layers=TRAIN_MOE_F32_LAYERS)
    world = World(WORLD, "cuda")
    p32 = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    res = {}
    for backend in ("fused", "eager"):
        calls, restore = _record_routing()
        try:
            loss, _, _, grads = loss_and_grads(lm, cfg, ParallelContext(world=world, backend=backend), p32, batch)
        finally:
            restore()
        res[backend] = (loss, tree_leaves(grads), calls)
    (loss_f, g_f, r_f), (loss_e, g_e, r_e) = res["fused"], res["eager"]
    _hold_logits(f"[train_moe] {ARCH_MOE} f32 loss, one step ({cfg.n_layers} layers)", loss_f[None], loss_e[None])
    flips = [int((a != b).any(-1).sum()) for a, b in zip(r_f, r_e)]
    errs = _grad_errs(_leaf_names(lm.trainable(p32, cfg)), g_f, g_e)
    worst = max(errs, key=lambda t: t[1])
    held = sum(flips) == 0
    print(f"[train_moe] {ARCH_MOE} f32 step gradients, fused vs eager ({cfg.n_layers} layers, {len(errs)} leaves): "
          f"routing flips per MoE layer {flips} of {TRAIN_BATCH * TRAIN_SEQ} tokens (at most {TRAIN_MOE_MAX_FLIPS}); "
          f"worst max|diff| / max|eager| {worst[1]:.3e} ({worst[0]}; "
          f"{'held' if held else 'printed, not held: routing flipped'}, bound {GRAD_RTOL:g})")  # fmt: skip
    if len(r_f) != cfg.n_layers or max(flips) > TRAIN_MOE_MAX_FLIPS:
        raise SystemExit(f"chip_smoke: {ARCH_MOE}'s f32 fused step routes apart from eager: flips {flips} per layer "
                         f"(at most {TRAIN_MOE_MAX_FLIPS})")  # fmt: skip
    if held and any(not (ok and e <= GRAD_RTOL) for _, e, ok in errs):
        raise SystemExit(f"chip_smoke: {ARCH_MOE}'s f32 fused step gradients disagree with eager: {worst}")
    out = {"loss": [loss_f.item(), loss_e.item()], "flips": flips, "grad_rel_err": worst[1], "held": held}
    del p32, res, g_f, g_e
    torch.cuda.empty_cache()
    return out


def phase_train_moe(profile: bool = False) -> dict:
    """The MoE models trained at their published widths, W = 4 (module docstring, phase 12)."""
    import torch

    out = {"layer": {arch: _moe_layer_grads(arch) for arch in (ARCH_MOE, ARCH_DS)}, "f32_step": _moe_step_f32()}
    run = _bf16_train("train_moe", ARCH_MOE, TRAIN_STEPS, layers=CUT["train"][ARCH_MOE])
    out["bf16"] = run["record"]
    if profile:
        from repro_torch.backend.mesh import World
        from repro_torch.benchmarks.common import profile_windows
        from repro_torch.data import SyntheticLM
        from repro_torch.models import lm
        from repro_torch.parallel.context import ParallelContext
        from repro_torch.training import AdamWConfig, make_train_step

        cfg, pc = run["cfg"], ParallelContext(world=World(WORLD, "cuda"))
        step = make_train_step(lm, cfg, pc, AdamWConfig(), grad_masks=lm.grad_masks(cfg, pc), donate=True)
        batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
        state = {"p": run["params"], "o": run["opt_state"]}

        def one_step():
            state["p"], state["o"], _ = step(state["p"], state["o"], batch)

        out["profile"] = profile_windows(f"{cfg.name} train", {"step": one_step})
        del state
    del run
    torch.cuda.empty_cache()
    out["resume"] = _resume_check("train_moe", ARCH_MOE)
    run = _bf16_train("train_moe", ARCH_DS, TRAIN_MOE_DS_STEPS, layers=CUT["train"][ARCH_DS], loss_fall=False)
    out["bf16_ds"] = run["record"]
    del run
    return out


def _ssm_f32_step(tag: str, arch: str) -> dict:
    """One float32 step's loss and every leaf's gradient of ``arch`` at
    SSM_F32_LAYERS[arch] layers (published width, TRAIN_BATCH x TRAIN_SEQ
    tokens, remat SSM_REMAT), fused against eager: the loss the logits'
    bound, each leaf GRAD_RTOL of its max|eager| (every leaf non-zero), the
    fused step's launches ``paper_e2e.expected_launches``."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = dataclasses.replace(get_config(arch), n_layers=SSM_F32_LAYERS[arch])
    world = World(WORLD, "cuda")
    p32 = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
    res = {}
    for backend in ("fused", "eager"):
        K.reset_launch_counts()
        pc = ParallelContext(world=world, backend=backend)
        loss, _, _, grads = loss_and_grads(lm, cfg, pc, p32, batch, remat_policy=SSM_REMAT)
        res[backend] = (loss, tree_leaves(grads), K.launch_counts())
    (loss_f, g_f, counts), (loss_e, g_e, _) = res["fused"], res["eager"]
    expect = paper_e2e.expected_launches(cfg, "overlap", SSM_REMAT)
    if counts != expect:
        raise SystemExit(f"chip_smoke: {arch}'s f32 fused step launched {counts}, expected {expect}")
    _hold_logits(f"[{tag}] {arch} f32 loss, one step ({cfg.n_layers} layers, remat {SSM_REMAT!r})",
                 loss_f[None], loss_e[None])  # fmt: skip
    errs = _grad_errs(_leaf_names(lm.trainable(p32, cfg)), g_f, g_e)
    worst = max(errs, key=lambda t: t[1])
    print(f"[{tag}] {arch} f32 gradients, fused vs eager ({cfg.n_layers} layers, {len(errs)} leaves): worst max|diff| "
          f"/ max|eager leaf| {worst[1]:.3e} ({worst[0]}; bound {GRAD_RTOL:g} per leaf, every leaf non-zero); "
          f"fused launches {counts}")  # fmt: skip
    bad = [e for e in errs if not (e[2] and e[1] <= GRAD_RTOL)]
    if bad:
        raise SystemExit(f"chip_smoke: {arch}'s f32 fused gradients disagree with eager: {bad[:8]}")
    out = {"layers": cfg.n_layers, "loss": [loss_f.item(), loss_e.item()], "grad_rel_err": worst[1],
           "worst_leaf": worst[0], "leaves": len(errs), "counts": counts}  # fmt: skip
    del p32, res, g_f, g_e
    torch.cuda.empty_cache()
    return out


def _ssm_training(tag: str, arch: str, profile: bool) -> dict:
    """``arch`` trained at its published width, W = 4, remat SSM_REMAT: the
    float32 step fused against eager (:func:`_ssm_f32_step`), TRAIN_STEPS
    bf16 steps of the train entry point at CUT["train"][arch] layers and lr SSM_LR
    (:func:`_bf16_train`),
    with ``profile`` one step's device time by kernel, and the resume check
    at SSM_CKPT_LAYERS[arch] layers."""
    import torch

    out = {"f32_step": _ssm_f32_step(tag, arch)}
    run = _bf16_train(tag, arch, TRAIN_STEPS, layers=CUT["train"][arch], remat=SSM_REMAT, lr=SSM_LR)
    out["bf16"] = run["record"]
    if profile:
        from repro_torch.backend.mesh import World
        from repro_torch.benchmarks.common import profile_windows
        from repro_torch.data import SyntheticLM
        from repro_torch.models import lm
        from repro_torch.parallel.context import ParallelContext
        from repro_torch.training import AdamWConfig, make_train_step

        cfg, pc = run["cfg"], ParallelContext(world=World(WORLD, "cuda"))
        step = make_train_step(lm, cfg, pc, AdamWConfig(), remat_policy=SSM_REMAT, grad_masks=lm.grad_masks(cfg, pc),
                               donate=True)  # fmt: skip
        batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).host_batch()
        state = {"p": run["params"], "o": run["opt_state"]}

        def one_step():
            state["p"], state["o"], _ = step(state["p"], state["o"], batch)

        out["profile"] = profile_windows(f"{cfg.name} train", {"step": one_step})
        del state
    del run
    torch.cuda.empty_cache()
    out["resume"] = _resume_check(tag, arch, SSM_CKPT_LAYERS[arch], SSM_REMAT)
    return out


def phase_train_ssm(profile: bool = False) -> dict:
    """mamba2-2.7b trained at its published width (module docstring, phase 13)."""
    return _ssm_training("train_ssm", ARCH_SSM, profile)


def phase_zamba2(profile: bool = False) -> dict:
    """zamba2-2.7b at its published width, CUT["zamba2"] deep: serve, the engine, training
    (module docstring, phase 14)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import lm

    cfg, world, pc, pc_eager, prompts = _setup(ARCH_Z, CUT["zamba2"][ARCH_Z])
    max_len, s_loc = PROMPT + NEW_TOKENS, PROMPT // WORLD
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)

    # (a) one shared attention block (the shared mixer, head dim 80, its GELU MLP), fused against eager
    d = next(d_ for d_ in lm.layer_plan(cfg) if d_.shared)
    gen = torch.Generator(device=world.device).manual_seed(1)
    x = torch.randn((WORLD, BATCH, s_loc, cfg.d_model), generator=gen, device=world.device)
    layer = params["layers"][lm.layer_plan(cfg).index(d)]
    before = K.launch_counts()
    y_f, _ = d.apply_seq(layer, x, pc, cfg, params["shared_attn"])
    ran = {k: v - before[k] for k, v in K.launch_counts().items()}
    if ran != {**{k: 0 for k in ran}, "ag_gemm": 2, "gemm_rs": 2, "flash_attention": 1}:
        raise SystemExit(f"chip_smoke: the fused shared attention block launched {ran}")
    y_e, _ = d.apply_seq(layer, x, pc_eager, cfg, params["shared_attn"])
    out_f, out_e = y_f - x, y_e - x
    err, scale = (out_f - out_e).abs().max().item(), out_e.abs().max().item()
    print(f"[zamba2] f32 shared attention block (head dim {cfg.hd}) [{WORLD}, {BATCH}, {s_loc}, {cfg.d_model}], fused "
          f"vs eager: max|diff| {err:.3e} (bound {TOL['float32']:g} x max|eager| {scale:.3e})")  # fmt: skip
    if not (torch.isfinite(out_f).all() and err <= TOL["float32"] * scale):
        raise SystemExit("chip_smoke: the fused shared attention block disagrees with the eager one")
    del x, y_f, y_e, out_f, out_e

    # (b) the float32 prefill, fused against eager, every position
    lg_f, _ = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
    lg_e, _ = lm.prefill(params, cfg, pc_eager, prompts, max_len=max_len)
    _hold_logits("[zamba2] f32 prefill logits (every position)", lg_f, lg_e)
    result = {"layer_err": err}
    del params, lg_f, lg_e
    torch.cuda.empty_cache()

    # (c) bfloat16: the main path (prefill + greedy decode), then the engine
    plan = lm.layer_plan(cfg)
    ssm, attn = sum(d_.kind == "mamba" for d_ in plan), sum(d_.shared for d_ in plan)
    expect = {"ag_gemm": cfg.n_layers + attn, "gemm_rs": cfg.n_layers + attn, "ssd_intra_chunk": ssm,
              "flash_attention": attn, "matmul": NEW_TOKENS, "grouped_matmul": 0}  # fmt: skip
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    result.update(_main_path("zamba2", cfg, pc, prompts, expect, profile, pc_eager, layer=True, params=params))
    result["engine"], _ = _engine_bf16(cfg, pc, params, ENGINE_Z, profile)
    del params
    torch.cuda.empty_cache()

    # (d) training, as the train_ssm phase
    result["train"] = _ssm_training("zamba2", ARCH_Z, profile)
    return result


def _mm_batch(cfg, pipe, step: int, dtype) -> dict:
    """Train batch ``step`` of a multimodal model from ``pipe`` (a
    ``SyntheticLM``) and a seeded stub frontend on the card: an
    encoder-decoder's decoder tokens with ``frontends.encoder_frames`` frames
    (512 at 256 tokens); a vision model's ``vision_prefix_len`` patches (256
    of 512) before the rest of the sequence's text, labels over the whole
    sequence (the prefix's are the stream's, so they lie in the corpus's
    vocabulary)."""
    import torch

    from repro_torch.models import frontends

    b = pipe.host_batch()
    gen = torch.Generator(device="cuda").manual_seed(1000 + step)
    if cfg.encoder_layers:
        n = frontends.encoder_frames(cfg, pipe.seq_len)
        return {**b, "embeds": frontends.stub_frame_embeddings(gen, pipe.global_batch, n, cfg.d_model, dtype, "cuda")}
    emb = frontends.stub_patch_embeddings(gen, pipe.global_batch, pipe.seq_len, cfg.d_model, dtype, "cuda")
    return {"inputs": b["inputs"][:, emb.shape[1] :], "labels": b["labels"], "embeds": emb}


def _mm_launches(cfg) -> dict:
    """Kernel launches of one multimodal train step (no remat): an
    enc-dec's encoder layer runs 2 AG+GEMM (qkv, gate|up), 2 GEMM+RS (o,
    down) and 1 flash, a decoder layer 4 AG+GEMM (qkv, the cross-attention's
    q and its kv gather of the encoder stream, gate|up), 3 GEMM+RS (o, cross
    o, down) and 2 flash; each AG+GEMM's transpose is a GEMM+RS in the
    backward and back, the head's forward one tile GEMM; a decoder-only
    model (the VLM) as ``paper_e2e.expected_launches``."""
    from repro_torch.benchmarks import paper_e2e

    if not cfg.encoder_layers:
        return paper_e2e.expected_launches(cfg, "overlap")
    e, d = cfg.encoder_layers, cfg.n_layers
    ag, rs = 2 * e + 4 * d, 2 * e + 3 * d
    return {"matmul": 1, "ag_gemm": ag + rs, "gemm_rs": rs + ag, "flash_attention": e + 2 * d, "grouped_matmul": 0,
            "ssd_intra_chunk": 0}  # fmt: skip


def _mm_seq(cfg) -> int:
    """Tokens a train row of the multimodal phases holds: an enc-dec's 256
    decoder tokens, the VLM's 256 patches + 256 text tokens."""
    return TRAIN_SEQ if cfg.encoder_layers else 2 * TRAIN_SEQ


@contextlib.contextmanager
def relu_masks(record: list, force=None):
    """Inside, the port's ReLU (``nn.layers.ACTS["relu"]``) appends each
    call's pre-activation to ``record``; given ``force`` (pre-activations of
    another run, in call order) it keeps the elements where ``force`` is
    positive instead of where its own input is: the same values where the
    two runs' signs agree, and the derivative taken on the other run's side
    of zero where they do not (a sign that summation order flipped)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.nn import layers

    class _Masked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, g, keep):
            ctx.save_for_backward(keep)
            return g * keep

        @staticmethod
        def backward(ctx, go):
            (keep,) = ctx.saved_tensors
            return go * keep, None

    forced = None if force is None else iter(force)

    def relu(g):
        record.append(g.detach())
        if forced is None:
            return F.relu(g)
        return _Masked.apply(g, (next(forced) > 0).to(g.dtype))

    before = layers.ACTS["relu"]
    layers.ACTS["relu"] = relu
    try:
        yield record
    finally:
        layers.ACTS["relu"] = before


def relu_flips(fused: list, eager: list) -> list:
    """For each ReLU call, the two passes' pre-activations (:func:`relu_masks`
    records): (elements whose sign differs, the largest |pre-activation| of
    such an element over its own pass's max|pre-activation| on either pass,
    the call's elements)."""
    import torch

    if len(fused) != len(eager):
        raise SystemExit(f"chip_smoke: the two passes called ReLU {len(fused)} and {len(eager)} times")
    out = []
    for a, b in zip(fused, eager):
        flip = (a > 0) != (b > 0)
        n = int(flip.sum().item())
        worst = 0.0
        if n:
            worst = max((t[flip].abs().max() / t.abs().max().clamp_min(1e-30)).item() for t in (a, b))
        out.append((n, worst, a.numel()))
    return out


def hold_relu_flips(what: str, flips: list):
    """Fail unless every flipped sign of :func:`relu_flips` lies within
    RELU_FLIP_REL of zero on both passes and no call flipped more than
    RELU_MAX_FLIP_SHARE of its elements: forcing one pass's signs on the
    other may then absorb summation order only, never a wrong value."""
    bad = [(i, n, w) for i, (n, w, size) in enumerate(flips) if w > RELU_FLIP_REL or n > RELU_MAX_FLIP_SHARE * size]
    if bad:
        raise SystemExit(f"chip_smoke: {what}: ReLU signs flipped beyond rounding of zero (call, flips, worst "
                         f"|pre| / max|pre|): {bad[:8]} (bounds {RELU_FLIP_REL:g}, {RELU_MAX_FLIP_SHARE:g} of a call)")


def _mm_f32_step(tag: str, cfg, rows: int = TRAIN_BATCH, seed: int = 0) -> dict:
    """One float32 step's loss and every leaf's gradient of ``cfg`` (a cut
    depth, published widths; weights and ``rows`` rows of :func:`_mm_batch`
    from ``seed``), fused
    against eager: the loss the logits' bound, each leaf GRAD_RTOL of its
    max|eager| (every leaf non-zero), the fused launches :func:`_mm_launches`;
    with kv copies (rep > 1: the VLM's MQA) the synced gradient's copies
    bitwise equal.  A ReLU model's gradients are held against an eager pass
    whose ReLUs take the fused pass's signs (:func:`relu_masks`): the two
    backends' pre-activations differ by summation order, so an element within
    rounding of zero may sit on either side, and the ReLU's derivative jumps
    there by that token's whole term (``tests/test_torch_encdec.py``); the
    flipped signs are held to rounding of zero (:func:`hold_relu_flips`) and
    printed with the unforced eager pass's error."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import model_module
    from repro_torch.nn import attention
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    mod = model_module(cfg)
    world = World(WORLD, "cuda")
    p32 = mod.init(cfg, world, torch.Generator(device=world.device).manual_seed(seed), torch.float32)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=_mm_seq(cfg), global_batch=rows, seed=seed)
    batch = _mm_batch(cfg, pipe, seed, torch.float32)  # the frames drawn from the seed too
    res, pre = {}, {"fused": [], "eager": []}
    relu = cfg.act == "relu"
    torch.cuda.reset_peak_memory_stats()
    for backend in ("fused", "eager"):
        K.reset_launch_counts()
        pc = ParallelContext(world=world, backend=backend)
        with relu_masks(pre[backend]):
            loss, _, _, grads = loss_and_grads(mod, cfg, pc, p32, batch)
        res[backend] = (loss, grads, K.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    (loss_f, g_f, counts), (loss_e, g_e, _) = res["fused"], res["eager"]
    names = _leaf_names(mod.trainable(p32, cfg))
    if relu:  # hold the flips to rounding of zero, then the eager pass at the fused pass's ReLU signs
        found = relu_flips(pre["fused"], pre["eager"])
        flips = [n for n, _, _ in found]
        near = max(w for _, w, _ in found)
        free = max(_grad_errs(names, tree_leaves(g_f), tree_leaves(g_e)), key=lambda t: t[1])
        print(f"[{tag}] {cfg.name} ReLU signs, fused vs eager pre-activations: {flips} of "
              f"{[size for _, _, size in found]} flipped (held <= {RELU_MAX_FLIP_SHARE:g} of a call), the largest "
              f"|pre| / max|pre| of a flipped element on either backend {near:.3e} (held <= {RELU_FLIP_REL:g}: "
              f"rounding of zero); unforced eager gradients' worst max|diff| / max|eager leaf| {free[1]:.3e} "
              f"({free[0]}; printed, not held: a flipped sign moves its token's whole term); held below with the "
              f"eager ReLUs at the fused signs")  # fmt: skip
        hold_relu_flips(f"{cfg.name}'s f32 step, seed {seed}", found)
        with relu_masks([], force=pre["fused"]):
            _, _, _, g_e = loss_and_grads(mod, cfg, ParallelContext(world=world, backend="eager"), p32, batch)
    del pre
    expect = _mm_launches(cfg)
    if counts != expect:
        raise SystemExit(f"chip_smoke: {cfg.name}'s f32 fused step launched {counts}, expected {expect}")
    depth = f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.encoder_layers else f"{cfg.n_layers}"
    _hold_logits(f"[{tag}] {cfg.name} f32 loss, one step ({depth} layers, {rows} x {_mm_seq(cfg)} tokens)",
                 loss_f[None], loss_e[None])  # fmt: skip
    errs = _grad_errs(names, tree_leaves(g_f), tree_leaves(g_e))
    worst = max(errs, key=lambda t: t[1])
    print(f"[{tag}] {cfg.name} f32 gradients, fused vs eager ({depth} layers, {len(errs)} leaves, seed {seed}): "
          f"worst max|diff| / "
          f"max|eager leaf| {worst[1]:.3e} ({worst[0]}; bound {GRAD_RTOL:g} per leaf, every leaf non-zero); fused "
          f"launches {counts}; peak memory of both passes {peak / 2**20:.0f} MiB")  # fmt: skip
    bad = [e for e in errs if not (e[2] and e[1] <= GRAD_RTOL)]
    if bad:
        raise SystemExit(f"chip_smoke: {cfg.name}'s f32 fused gradients disagree with eager: {bad[:8]}")
    out = {"layers": depth, "loss": [loss_f.item(), loss_e.item()], "grad_rel_err": worst[1], "worst_leaf": worst[0],
           "leaves": len(errs), "counts": counts, "peak_bytes": peak, "relu_flips": flips if relu else None,
           "relu_flip_rel": near if relu else None, "unforced_grad_rel_err": free[1] if relu else None}  # fmt: skip
    lay = attention.layout(cfg, WORLD)
    if lay.rep > 1:  # the kv-copy sync: every stored copy of a kv column gets the same gradient
        synced = mod.sync_grads(g_f, cfg, ParallelContext(world=world))
        nq = lay.h_loc * cfg.hd
        same = all(torch.equal(layer["mixer"]["wqkv"][r, :, nq:], layer["mixer"]["wqkv"][0, :, nq:])
                   for layer in synced["layers"] for r in range(1, WORLD))  # fmt: skip
        raw = g_f["layers"][0]["mixer"]["wqkv"][..., nq:]
        spread = (raw - raw[:1]).abs().max().item()
        print(f"[{tag}] {cfg.name} kv-copy sync at rep {lay.rep}: the {WORLD} copies of each kv column bitwise equal "
              f"after sync_grads: {same} (held; before it they differ by up to {spread:.3e})")  # fmt: skip
        if not same or spread == 0.0:
            raise SystemExit(f"chip_smoke: {cfg.name}'s kv-copy gradients are not synced (or were never apart)")
        out["kv_sync_bitwise"] = same
    del p32, res, g_f, g_e
    torch.cuda.empty_cache()
    return out


def _mm_state(cfg, world, pc, steps: int):
    """Seeded bf16 parameters (seed 0), their AdamW state and the donated
    train step of ``cfg`` (lr MM_LR, ``steps`` for its schedule)."""
    import torch

    from repro_torch.launch.train import model_module
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    mod = model_module(cfg)
    params = mod.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    opt_cfg = AdamWConfig(lr=MM_LR, total_steps=steps, warmup_steps=max(5, steps // 20))
    step = make_train_step(mod, cfg, pc, opt_cfg, grad_masks=mod.grad_masks(cfg, pc), donate=True)
    return params, init_opt_state(mod.trainable(params, cfg)), step


def _mm_train(tag: str, cfg, steps: int) -> dict:
    """``steps`` bf16 AdamW steps of ``cfg`` through ``make_train_step``
    (TRAIN_BATCH rows of :func:`_mm_batch`, W = 4, donated state): every
    step's launches held to :func:`_mm_launches`, the mean ce of the last 5
    steps more than 0.2 below the first 5's, the peak memory below the
    card's; the median step ms (CUDA events) and tokens/s recorded."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.data import SyntheticLM
    from repro_torch.parallel.context import ParallelContext

    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    params, opt, step = _mm_state(cfg, world, pc, steps)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=_mm_seq(cfg), global_batch=TRAIN_BATCH)
    expect = _mm_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for i in range(steps):
        batch = _mm_batch(cfg, pipe, i, torch.bfloat16)
        before = K.launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, m = step(params, opt, batch)
        e1.record()
        ce = float(m["ce"])  # a host sync
        after = K.launch_counts()
        hist.append({"ce": ce, "ms": e0.elapsed_time(e1), "launches": {k: after[k] - before[k] for k in after}})
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, r["launches"]) for i, r in enumerate(hist) if r["launches"] != expect]
    print(f"[{tag}] {cfg.name} launches per bf16 step (held exactly, every step): {hist[0]['launches']}")
    if bad:
        raise SystemExit(f"chip_smoke: {cfg.name}'s train steps launched {bad[:3]} (expected {expect} each)")
    ce = [r["ce"] for r in hist]
    warm = min(TRAIN_WARMUP, steps - 1)
    ms = sorted(r["ms"] for r in hist[warm:])
    med = ms[len(ms) // 2] if len(ms) % 2 else (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    tokens = TRAIN_BATCH * _mm_seq(cfg)
    tps = tokens / (med / 1e3)
    first, last = sum(ce[:5]) / 5, sum(ce[-5:]) / 5
    extra = (f" + {batch['embeds'].shape[1]} encoder frames" if cfg.encoder_layers else
             f" ({batch['embeds'].shape[1]} patches + {batch['inputs'].shape[1]} text tokens)")  # fmt: skip
    depth = f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.encoder_layers else f"{cfg.n_layers}"
    print(f"[{tag}] bf16 {cfg.name} ({depth} layers) W={WORLD}, {steps} steps of "
          f"{TRAIN_BATCH} x {_mm_seq(cfg)} tokens{extra} at lr {MM_LR:g}: mean ce of the first 5 steps {first:.4f}, "
          f"of the last 5 {last:.4f} (held: more than 0.2 lower); step {med:.2f} ms (median of steps {warm}-"
          f"{steps - 1}, CUDA events), {tps:.0f} tokens/s, peak memory {peak / 2**20:.0f} MiB")  # fmt: skip
    if not all(map(math.isfinite, ce)) or not last < first - 0.2:
        raise SystemExit(f"chip_smoke: {cfg.name}'s bf16 loss did not fall: {first} -> {last}")
    if peak >= torch.cuda.get_device_properties(0).total_memory:
        raise SystemExit(f"chip_smoke: {cfg.name}'s train step peaked at {peak} bytes, above the card's memory")
    counts = {k: v * steps for k, v in expect.items()}
    del params, opt, step
    torch.cuda.empty_cache()
    return {"layers": [cfg.encoder_layers, cfg.n_layers], "lr": MM_LR, "ce": ce, "step_ms": [r["ms"] for r in hist],
            "median_step_ms": med, "tokens_per_s": tps, "peak_bytes": peak, "counts": counts, "per_step": expect}  # fmt: skip


def _mm_resume(tag: str, cfg) -> dict:
    """A bf16 run of ``cfg`` (a cut depth, published widths) checkpointed
    after step TRAIN_CKPT_AT (``CheckpointManager``: the logical arrays,
    moments and the data cursor), then one more step; the checkpoint
    restored into fresh state and the same step run: its loss and the
    parameters after it bitwise the uninterrupted run's."""
    import tempfile

    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves

    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    steps = TRAIN_CKPT_AT + 1
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        params, opt, step = _mm_state(cfg, world, pc, steps)
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=_mm_seq(cfg), global_batch=TRAIN_BATCH)
        for i in range(TRAIN_CKPT_AT):
            params, opt, _ = step(params, opt, _mm_batch(cfg, pipe, i, torch.bfloat16))
        mgr.save(TRAIN_CKPT_AT, params, opt, extra={"data": pipe.state()}, cfg=cfg, world=world)
        mgr.wait()
        params, opt, m = step(params, opt, _mm_batch(cfg, pipe, TRAIN_CKPT_AT, torch.bfloat16))
        ref_loss, ref_params = m["loss"].item(), [t.clone() for t in tree_leaves(params)]
        del params, opt
        like, like_opt, step2 = _mm_state(cfg, world, pc, steps)
        restored, meta = mgr.restore(TRAIN_CKPT_AT, {"params": like, "opt": like_opt}, cfg=cfg, world=world)
        pipe2 = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=_mm_seq(cfg), global_batch=TRAIN_BATCH)
        pipe2.restore(meta["extra"]["data"])
        params, _, m2 = step2(restored["params"], restored["opt"], _mm_batch(cfg, pipe2, TRAIN_CKPT_AT, torch.bfloat16))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params), ref_params))
    depth = f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.encoder_layers else f"{cfg.n_layers}"
    print(f"[{tag}] {cfg.name} checkpoint after step {TRAIN_CKPT_AT} ({depth} layers, full width, bf16), resumed: "
          f"step {TRAIN_CKPT_AT} loss {ref_loss!r} uninterrupted, {m2['loss'].item()!r} resumed (held bitwise); "
          f"parameters after it bitwise equal: {same} (held)")  # fmt: skip
    if m2["loss"].item() != ref_loss or not same:
        raise SystemExit(f"chip_smoke: {cfg.name}'s resumed step differs from the uninterrupted one")
    del params, like, like_opt, restored, ref_params
    torch.cuda.empty_cache()
    return {"layers": depth, "loss": ref_loss, "resumed_loss": m2["loss"].item(), "params_bitwise": same}


def _encdec_serve(cfg, pc, params, frames, start) -> tuple:
    """One enc-dec serve run: encode the frames, build the cross caches, then
    NEW_TOKENS greedy ``decode_step``s from the ``start`` tokens [B].
    Returns (tokens [B, NEW_TOKENS], encoder ms, cross-cache ms, decode step
    ms per step: CUDA events)."""
    import torch

    from repro_torch.models import encdec

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(NEW_TOKENS + 3)]
    ev[0].record()
    enc = encdec.encode(params, cfg, pc, frames)
    ev[1].record()
    cross = encdec.build_cross_caches(params, cfg, pc, enc)
    ev[2].record()
    caches = {"self": encdec.init_caches(cfg, pc, frames.shape[0], NEW_TOKENS, params["embed"].dtype)["self"],
              "cross": cross}  # fmt: skip
    tok, out = start, []
    for i in range(NEW_TOKENS):
        if i:
            ev[2 + i].record()
        lg, caches = encdec.decode_step(params, caches, cfg, pc, tok[:, None], i)
        tok = lg[:, 0].argmax(-1)
        out.append(tok)
    ev[-1].record()
    torch.cuda.synchronize()
    steps = [ev[2 + i].elapsed_time(ev[3 + i]) for i in range(1, NEW_TOKENS)]
    return torch.stack(out, 1), ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), steps


def phase_encdec(profile: bool = False) -> dict:
    """seamless-m4t-medium at its published width, CUT["encdec"] deep: serve, the f32 checks,
    training (module docstring, phase 15)."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.launch import serve
    from repro_torch.models import encdec, frontends

    cfg, world, pc, pc_eager, _ = _setup(ARCH_ED)
    cfg = dataclasses.replace(cfg, encoder_layers=CUT["encdec"][ARCH_ED], n_layers=CUT["encdec"][ARCH_ED])
    gen = torch.Generator(device=world.device).manual_seed(1)
    params = encdec.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    frames = frontends.stub_frame_embeddings(gen, BATCH, cfg.enc_len, cfg.d_model, torch.bfloat16, world.device)
    start = torch.from_numpy(serve.make_prompts(cfg.vocab_size, BATCH, 1, seed=0)[:, 0]).to(world.device)
    # (a) serve: a warm-up run, then the counted run
    warm = _encdec_serve(cfg, pc, params, frames, start)[0]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tokens, enc_ms, cross_ms, step_ms = _encdec_serve(cfg, pc, params, frames, start)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    e, d = cfg.encoder_layers, cfg.n_layers
    expect = {"ag_gemm": 2 * e + d, "gemm_rs": 2 * e, "flash_attention": e, "matmul": NEW_TOKENS, "grouped_matmul": 0,
              "ssd_intra_chunk": 0}  # fmt: skip
    tps = BATCH * len(step_ms) / (sum(step_ms) / 1e3)
    med = sorted(step_ms)[len(step_ms) // 2]
    print(f"[encdec] bf16 {cfg.name} ({e} + {d} layers) W={WORLD}: {BATCH} requests x {cfg.enc_len} stub frames, "
          f"{NEW_TOKENS} greedy tokens; encoder {enc_ms:.2f} ms, cross caches {cross_ms:.2f} ms, decode step "
          f"{med:.2f} ms (median; steps {[round(t, 2) for t in step_ms]}), {tps:.1f} tokens/s, peak memory "
          f"{peak / 2**20:.0f} MiB")  # fmt: skip
    print(f"[encdec] launch counts of the main path: {counts}")
    if counts != expect:
        raise SystemExit(f"chip_smoke: {cfg.name} launch counts {counts} != expected {expect}")
    if not torch.equal(tokens, warm) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise SystemExit("chip_smoke: two enc-dec greedy runs on the same weights gave different or bad tokens")
    print(f"[encdec] tokens[0]: {tokens[0].tolist()}")
    result = {"encode_ms": enc_ms, "cross_ms": cross_ms, "decode_step_ms": step_ms, "decode_tokens_per_s": tps,
              "peak_bytes": peak, "counts": counts}  # fmt: skip

    # (b) float32 on the same (bf16-valued) weights: the forward fused vs eager, the decode vs the forward
    p32 = _f32(params)
    toks = torch.from_numpy(serve.make_prompts(cfg.vocab_size, BATCH, NEW_TOKENS, seed=1)).to(world.device)
    lg_f, _ = encdec.forward(p32, cfg, pc, toks, frames.float())
    lg_e, _ = encdec.forward(p32, cfg, pc_eager, toks, frames.float())
    _hold_logits(f"[encdec] f32 forward logits ({BATCH} x {cfg.enc_len} frames, {NEW_TOKENS} decoder tokens)",
                 lg_f, lg_e)  # fmt: skip
    enc = encdec.encode(p32, cfg, pc, frames.float())
    caches = {"self": encdec.init_caches(cfg, pc, BATCH, NEW_TOKENS, torch.float32)["self"],
              "cross": encdec.build_cross_caches(p32, cfg, pc, enc)}  # fmt: skip
    worst = 0.0
    for i in range(NEW_TOKENS):
        lg, caches = encdec.decode_step(p32, caches, cfg, pc, toks[:, i : i + 1], i)
        diff = (lg[:, 0] - lg_f[:, i]).abs()
        worst = max(worst, (diff - DECODE_RTOL * lg_f[:, i].abs()).max().item())
    print(f"[encdec] f32 decode_step logits (cross caches, {NEW_TOKENS} steps) vs the teacher-forced forward's: "
          f"worst max(|diff| - {DECODE_RTOL:g} |forward|) {worst:.3e} (held <= {DECODE_RTOL:g})")  # fmt: skip
    if not worst <= DECODE_RTOL:
        raise SystemExit("chip_smoke: the enc-dec decode logits disagree with the teacher-forced forward's")
    # (c) the bf16 fused forward against the f32 eager one on the same weights
    lg_b, _ = encdec.forward(params, cfg, pc, toks, frames)
    err, scale = (lg_b.float() - lg_e).abs().max().item(), lg_e.abs().max().item()
    print(f"[encdec] bf16 fused forward vs f32 eager (same bf16 weights): max|diff| {err:.3e} (bound "
          f"{TOL['bfloat16']:g} x max|f32| {scale:.3e})")  # fmt: skip
    if not (torch.isfinite(lg_b).all() and err <= TOL["bfloat16"] * scale):
        raise SystemExit("chip_smoke: the bf16 enc-dec forward disagrees with the f32 eager one")
    result.update(decode_vs_forward=worst, bf16_forward_err=err, bf16_forward_ref=scale)
    del params, p32, lg_f, lg_e, lg_b, enc, caches
    torch.cuda.empty_cache()

    # (d) training: the f32 step at 2 + 2 layers, TRAIN_STEPS bf16 steps, the resume at 2 + 2
    cut = dataclasses.replace(cfg, encoder_layers=MM_CUT_LAYERS, n_layers=MM_CUT_LAYERS)
    steps = [_mm_f32_step("encdec", cut, seed=seed) for seed in range(ENCDEC_F32_SEEDS)]
    result["f32_step"], result["f32_step_seeds"] = steps[0], [r["grad_rel_err"] for r in steps]
    result["f32_step_unforced"] = [r["unforced_grad_rel_err"] for r in steps]
    print(f"[encdec] f32 fused-vs-eager worst gradient error by seed, at equal ReLU signs {result['f32_step_seeds']} "
          f"(bound {GRAD_RTOL:g}; every seed held), unforced {result['f32_step_unforced']} (printed), sign flips "
          f"{[r['relu_flips'] for r in steps]}, their largest |pre| / max|pre| {[r['relu_flip_rel'] for r in steps]} "
          f"(held <= {RELU_FLIP_REL:g})")  # fmt: skip
    result["train"] = _mm_train("encdec", cfg, TRAIN_STEPS)
    result["resume"] = _mm_resume("encdec", cut)
    return result


def phase_vlm(profile: bool = False) -> dict:
    """paligemma-3b at its published width, CUT["vlm"] deep: serve with an image prefix, the
    f32 checks, training (module docstring, phase 16)."""
    import dataclasses

    import torch

    from repro_torch.models import frontends, lm

    cfg, world, pc, pc_eager, prompts = _setup(ARCH_V, CUT["vlm"][ARCH_V])
    gen = torch.Generator(device=world.device).manual_seed(1)
    patches = frontends.stub_patch_embeddings(gen, BATCH, 2 * PROMPT, cfg.d_model, torch.float32, world.device)
    max_len = patches.shape[1] + PROMPT + NEW_TOKENS
    # (a) the float32 prefill (image prefix + prompts), fused against eager
    p32 = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    lg_f, _ = lm.prefill(p32, cfg, pc, prompts, patches, max_len=max_len)
    lg_e, _ = lm.prefill(p32, cfg, pc_eager, prompts, patches, max_len=max_len)
    _hold_logits(f"[vlm] f32 prefill logits ({patches.shape[1]} patches + {PROMPT} tokens, every position)", lg_f,
                 lg_e)  # fmt: skip
    del p32, lg_f, lg_e
    torch.cuda.empty_cache()
    # (b) the bf16 main path through serve.greedy(embeds=), launches held; a bf16 layer against f32 eager
    n = cfg.n_layers
    expect = {"ag_gemm": 2 * n, "gemm_rs": 2 * n, "flash_attention": n, "matmul": NEW_TOKENS, "grouped_matmul": 0,
              "ssd_intra_chunk": 0}  # fmt: skip
    result = _main_path("vlm", cfg, pc, prompts, expect, profile, pc_eager, layer=True,
                        embeds=patches.bfloat16())  # fmt: skip
    print(f"[vlm] max_len {max_len}: prefill of {patches.shape[1]} + {PROMPT} tokens, then {NEW_TOKENS - 1} decode steps")
    torch.cuda.empty_cache()
    # (c) training: the f32 step at V_F32_LAYERS layers and V_F32_ROWS rows (with the kv-copy sync), TRAIN_STEPS
    # bf16 steps, the resume at MM_CUT_LAYERS
    result["f32_step"] = _mm_f32_step("vlm", dataclasses.replace(cfg, n_layers=V_F32_LAYERS), V_F32_ROWS)
    result["train"] = _mm_train("vlm", cfg, TRAIN_STEPS)
    result["resume"] = _mm_resume("vlm", dataclasses.replace(cfg, n_layers=MM_CUT_LAYERS))
    return result


def _e2e_f32_step(arch: str) -> dict:
    """(d): one float32 step's loss and every leaf's gradient, fused against
    eager, at E2E_F32_LAYERS layers of ``arch`` at its published width
    (qwen2's QKV bias set to seeded non-zero values first)."""
    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = paper_e2e.e2e_config(arch, E2E_F32_LAYERS)
    world = World(WORLD, "cuda")
    gen = torch.Generator(device=world.device).manual_seed(0)
    p32 = lm.init(cfg, world, gen, torch.float32)
    for layer in p32["layers"] if cfg.qkv_bias else []:
        b = layer["mixer"]["bqkv"]
        layer["mixer"]["bqkv"] = torch.randn(b.shape, generator=gen, device=b.device) * 0.5
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=E2E_F32_SEQ, global_batch=1).host_batch()
    res = {}
    for name, backend in (("fused", "fused"), ("eager", "eager")):
        loss, _, _, grads = loss_and_grads(lm, cfg, ParallelContext(world=world, backend=backend), p32, batch)
        res[name] = (loss, grads)
    (loss_f, g_f), (loss_e, g_e) = res["fused"], res["eager"]
    _hold_logits(f"[e2e] {arch} f32 loss, one step ({cfg.n_layers} layers, 1 x {E2E_F32_SEQ} tokens)",
                 loss_f[None], loss_e[None])  # fmt: skip
    worst, bad, names = 0.0, [], []
    for i, (a, b) in enumerate(zip(tree_leaves(g_f), tree_leaves(g_e))):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= GRAD_RTOL and b.abs().max().item() > 0):
            bad.append((i, tuple(a.shape), rel))
    n_leaves = len(tree_leaves(g_f))
    windows = sorted({str(d.window) for d in lm.layer_plan(cfg)})
    extra = "the QKV bias seeded non-zero" if cfg.qkv_bias else f"windows {windows}, embedding x sqrt({cfg.d_model})"
    print(f"[e2e] {arch} f32 gradients, fused vs eager ({extra}): {n_leaves} leaves, worst max|diff| / max|eager "
          f"leaf| {worst:.3e} (bound {GRAD_RTOL:g} per leaf, every leaf non-zero)")  # fmt: skip
    if bad:
        raise SystemExit(f"chip_smoke: {arch}'s f32 fused gradients disagree with eager: {bad[:8]}")
    out = {"loss": [loss_f.item(), loss_e.item()], "grad_rel_err": worst, "leaves": n_leaves}
    del p32, res, g_f, g_e
    torch.cuda.empty_cache()
    return out


def _e2e_serve() -> dict:
    """(e): gemma3-27b at its e2e depth in bf16 through ``serve.greedy``:
    prompts past the local window, so the local layers' ring caches wrap;
    launches held exactly, two runs' tokens equal."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    cfg = paper_e2e.e2e_config(ARCH_G)
    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    prompts = torch.from_numpy(serve.make_prompts(cfg.vocab_size, E2E_SERVE_BATCH, E2E_SERVE_PROMPT, seed=0))
    prompts = prompts.to(world.device)
    max_len = E2E_SERVE_PROMPT + NEW_TOKENS
    rings = sorted({c["k"].shape[3] for c in lm.init_caches(cfg, pc, 1, max_len)})
    warm, _ = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS, max_len)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    tokens, t = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS, max_len)
    counts = K.launch_counts()
    expect = {"matmul": NEW_TOKENS, "ag_gemm": 2 * cfg.n_layers, "gemm_rs": 2 * cfg.n_layers,
              "flash_attention": cfg.n_layers, "grouped_matmul": 0, "ssd_intra_chunk": 0}  # fmt: skip
    tps = E2E_SERVE_BATCH * t["decode_steps"] / t["decode_s"]
    print(f"[e2e] bf16 {ARCH_G} ({cfg.n_layers} layers) through serve.greedy: {E2E_SERVE_BATCH} x "
          f"{E2E_SERVE_PROMPT} prompt tokens + {NEW_TOKENS} greedy; cache lengths {rings} (window "
          f"{cfg.local_window}); prefill {t['prefill_s'] * 1e3:.2f} ms, decode {tps:.1f} tokens/s; launches {counts}")  # fmt: skip
    if counts != expect:
        raise SystemExit(f"chip_smoke: {ARCH_G}'s greedy launched {counts} != {expect}")
    if rings != [cfg.local_window, max_len] or not torch.equal(tokens, warm):
        raise SystemExit(f"chip_smoke: {ARCH_G}'s windowed decode: caches {rings}, tokens reproducible "
                         f"{torch.equal(tokens, warm)}")  # fmt: skip
    if tuple(tokens.shape) != (E2E_SERVE_BATCH, NEW_TOKENS) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise SystemExit(f"chip_smoke: bad generated tokens {tokens.shape}")
    print(f"[e2e] {ARCH_G} tokens[0]: {tokens[0].tolist()}")
    del params
    torch.cuda.empty_cache()
    return {"prefill_ms": t["prefill_s"] * 1e3, "decode_tokens_per_s": tps, "counts": counts}


def phase_e2e(profile: bool = False) -> dict:
    """Paper Fig. 11 and the three dense configs (module docstring, phase 17)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_e2e

    out = {"f32": {arch: _e2e_f32_step(arch) for arch in E2E_F32_ARCHS}, "rows": [], "counts": {}}
    print(f"[e2e] {paper_e2e.CAVEAT}")
    for arch in paper_e2e.MODELS:
        cfg = paper_e2e.e2e_config(arch, CUT["e2e"].get(arch))
        K.reset_launch_counts()
        row = paper_e2e.run_row(cfg, World(paper_e2e.WORLD, "cuda"))
        out["counts"][arch] = K.launch_counts()
        print(f"[e2e] {paper_e2e.describe(row)}")
        for mode in paper_e2e.MODES:
            expect = paper_e2e.expected_launches(cfg, mode)
            steps = row["launches"][mode]
            print(f"[e2e] {arch} {mode}: launches per step (held exactly, all {len(steps)} steps) {steps[0]}")
            if any(c != expect for c in steps):
                raise SystemExit(f"chip_smoke: {arch}'s {mode} steps launched {steps[:3]} (expected {expect} each)")
        first = row["first_loss"]
        _hold_logits(f"[e2e] {arch} bf16 first-step loss", torch.tensor([first["overlap"]]),
                     torch.tensor([first["baseline"]]), pair=("overlap", "baseline"))  # fmt: skip
        if not all(map(math.isfinite, row["step_loss"]["overlap"] + row["step_loss"]["baseline"])):
            raise SystemExit(f"chip_smoke: {arch}'s step losses are not finite: {row['step_loss']}")
        if row["peak_bytes"] >= torch.cuda.get_device_properties(0).total_memory:
            raise SystemExit(f"chip_smoke: {arch}'s row peaked at {row['peak_bytes']} bytes, more than the card holds")
        out["rows"].append(row)
    out["serve"] = _e2e_serve()
    if profile:
        out["profile"] = {arch: _e2e_profile(arch) for arch in (ARCH_G, ARCH_MOE)}
    return out


def _e2e_profile(arch: str) -> dict:
    """Device time by kernel of one bf16 train step of ``arch`` at its e2e
    phase's depth, in each mode (torch.profiler)."""
    import torch

    from repro_torch.backend.mesh import World
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.benchmarks.common import fp32_reductions, profile_windows
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    cfg = paper_e2e.e2e_config(arch, CUT["e2e"].get(arch))
    world = World(WORLD, "cuda")
    state = {"p": lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)}
    state["o"] = init_opt_state(lm.trainable(state["p"], cfg))
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=paper_e2e.SEQ, global_batch=paper_e2e.BATCH).host_batch()
    windows = {}
    for mode in paper_e2e.MODES:
        pc = ParallelContext(world=world, mode=mode)
        step = make_train_step(lm, cfg, pc, AdamWConfig(), grad_masks=lm.grad_masks(cfg, pc), donate=True)

        def run(step=step):
            state["p"], state["o"], _ = step(state["p"], state["o"], batch)

        run()  # warm-up
        windows[f"{mode} step"] = run
    with fp32_reductions():
        prof = profile_windows(f"{arch} ({cfg.n_layers} layers) train, 1 x {paper_e2e.SEQ} tokens", windows)
    del state
    torch.cuda.empty_cache()
    return prof


def phase_paper() -> dict:
    from repro_torch import kernels as K
    from repro_torch.benchmarks import paper_attn, paper_mlp, paper_moe

    print(f"[paper] {paper_mlp.CAVEAT}")
    K.reset_launch_counts()
    rows = [paper_mlp.fig8_row(name, PAPER_WORLD) for name in ("MLP-1", "MLP-6")] + paper_mlp.tab2_rows(PAPER_WORLD)
    rows_moe = [paper_moe.fig9_row(name, PAPER_WORLD) for name in PAPER_MOE_ROWS]
    rows_attn = [paper_attn.fig10_row(name, s, PAPER_WORLD) for name, s in PAPER_ATTN_ROWS]
    counts = K.launch_counts()
    for r in rows:
        print(f"[paper] {paper_mlp.describe(r)}")
    for r in rows_moe:
        print(f"[paper] {paper_moe.describe(r)}")
    for r in rows_attn:
        print(f"[paper] {paper_attn.describe(r)}")
    print(f"[paper] launch counts: {counts}")
    if not (counts["ag_gemm"] and counts["gemm_rs"] and counts["grouped_matmul"] and counts["flash_attention"]):
        raise SystemExit("chip_smoke: the paper phase did not run the fused kernels")
    return {"rows": rows + rows_moe + rows_attn, "counts": counts}


QUANT_LAYERS = 32  # the quant phase's MLP chain: all of smollm-360m's layers
QUANT_REL = 0.05  # one layer's op on a quantized wire against the identity (the JAX package's tests/test_quant.py)


def _quant_kernel_cases(rnd, iters: int) -> dict:
    """The packed-weight and wire cases of the fused kernels (module docstring, 19d)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R
    from repro_torch.core.channels import BlockChannel
    from repro_torch.core.quant import QuantSpec, dequantize_weight, pack_weight
    from repro_torch.kernels.gemm_rs import launch_plan

    recs = {}
    shp = path_shapes(ARCH)
    d, n_gu, f_loc = shp["d"], shp["n_gu"], shp["f_loc"]
    s_mlp, h_mlp, i_mlp, _ = (8192, 4096, 11008, "LLaMA-7B")  # configs/paper.PAPER_MLP["MLP-1"]
    packs = {"int8": QuantSpec(weight_dtype="int8"), "int4_zp": QuantSpec(weight_dtype="int4", zero_point=True)}
    wire = BlockChannel(axis="model", quant=QuantSpec(wire_dtype="bfloat16"))
    shapes = (  # (tag, world, batch rows, m_loc / M, k, n, dtypes, plain once)
        (ARCH, WORLD, BATCH, PROMPT // WORLD, PROMPT, d, n_gu, f_loc, (torch.float32, torch.bfloat16), False),
        ("MLP-1", PAPER_WORLD, 1, s_mlp // PAPER_WORLD, s_mlp, h_mlp, i_mlp // PAPER_WORLD, i_mlp // PAPER_WORLD,
         (torch.bfloat16,), True),
    )  # fmt: skip
    for tag, W, B, m_loc, M, dm, n_ag, k_rs, dtypes, once in shapes:
        for dtype in dtypes:
            timed = dtype == torch.bfloat16
            isz = torch.tensor([], dtype=dtype).element_size()
            # AG+GEMM: x [W, B, m_loc, d] gathered times a packed [W, d, n_ag]
            x = rnd(W, B, m_loc, dm, dtype=dtype)
            xg = x.permute(1, 0, 2, 3).reshape(B, W * m_loc, dm)
            wf = rnd(W, dm, n_ag, dtype=torch.float32) * dm**-0.5
            for ptag, spec in packs.items():
                pw = pack_weight(wf, spec)
                wd = dequantize_weight(pw.q, pw.scale, pw.zero, dtype)  # the library call's operand
                recs[("ag_gemm", tag, f"packed_{ptag}", dtype)] = _case(
                    f"ag_gemm[{tag} packed {ptag}] x{list(x.shape)} q{list(pw.q.shape)}", dtype,
                    lambda: K.ag_gemm(x, pw), lambda: K.ag_gemm_plain(x, pw),
                    lambda: torch.matmul(xg[None], wd[:, None]),
                    2 * W * B * W * m_loc * dm * n_ag,
                    isz * (x.numel() + W * B * W * m_loc * n_ag) + pw.q.numel() + 8 * pw.scale.numel(),
                    iters if timed else 2, not timed, lambda: K.ag_gemm.last_launch, bitwise=timed, plain_once=once,
                    ref=lambda: R.ag_gemm_ref(x, _dq(pw)),
                )  # fmt: skip
                del pw, wd
            del x, xg, wf
            # GEMM+RS: x [W, B, M, k_rs] times a packed [W, k_rs, d]; and the bf16 wire on a plain weight
            x = rnd(W, B, M, k_rs, dtype=dtype)
            wf = rnd(W, k_rs, dm, dtype=torch.float32) * (W * k_rs) ** -0.5
            out_bytes = isz * W * B * (M // W) * dm
            for ptag, spec in packs.items():
                pw = pack_weight(wf, spec)
                wd = dequantize_weight(pw.q, pw.scale, pw.zero, dtype)
                recs[("gemm_rs", tag, f"packed_{ptag}", dtype)] = _case(
                    f"gemm_rs[{tag} packed {ptag}] x{list(x.shape)} q{list(pw.q.shape)}", dtype,
                    lambda: K.gemm_rs(x, pw), lambda: K.gemm_rs_plain(x, pw),
                    lambda: torch.matmul(x, wd[:, None]).sum(0),
                    2 * W * B * M * k_rs * dm, isz * x.numel() + out_bytes + pw.q.numel() + 8 * pw.scale.numel(),
                    iters if timed else 2, not timed, lambda: K.gemm_rs.last_launch, bitwise=timed, plain_once=once,
                    ref=lambda: R.gemm_rs_ref(x, _dq(pw)),
                )  # fmt: skip
                del pw, wd
            w = wf.to(dtype)
            recs[("gemm_rs", tag, "wire_bf16", dtype)] = _case(
                f"gemm_rs[{tag} bf16 wire, f32 accum] x{list(x.shape)} w{list(w.shape)}", dtype,
                lambda: K.gemm_rs(x, w, channel=wire), lambda: K.gemm_rs_plain(x, w, channel=wire),
                lambda: torch.matmul(x, w[:, None]).sum(0),
                2 * W * B * M * k_rs * dm, isz * (x.numel() + w.numel()) + out_bytes,
                iters if timed else 2, not timed, lambda: K.gemm_rs.last_launch, bitwise=timed, plain_once=once,
                ref=lambda: R.gemm_rs_wire_ref(x, w, launch_plan(x, w, wire)[0].rs_seg_tables(), torch.bfloat16),
            )  # fmt: skip
            if K.gemm_rs.last_launch["wire"] != "bfloat16":
                raise SystemExit(f"chip_smoke: gemm_rs kept its partials in {K.gemm_rs.last_launch['wire']}, not bf16")
            del x, w, wf
            torch.cuda.empty_cache()
    return recs


def phase_quant(iters: int) -> dict:
    import torch

    from repro_torch import kernels as K
    from repro_torch.convert import shard_mlp
    from repro_torch.core import compile_overlap
    from repro_torch.core.quant import QuantSpec, dequantize_weight, pack_weight
    from repro_torch.models import lm
    from repro_torch.nn import ffn
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.training.compression import compress_with_feedback, psum_compressed

    cfg, world, pc, pc_eager, prompts = _setup(ARCH)
    dev = world.device
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    # (a) the 32 MLP blocks on the fused kernels: packed int8 weights against the same codes dequantized.
    # With pack_weight's scales the bf16 dequantized weights round q * scale (2^-9), which 32 random bf16
    # blocks carry to a few % of the stream: one block is held at the bf16 bound, the chain recorded.  With
    # each scale rounded to a power of two, q * scale is exact in bf16 and the kernels' sums run in the same
    # order, so the packed chain must equal the dequantized chain bitwise.
    spec = QuantSpec(weight_dtype="int8")
    layers = {"packed": [], "dequant": [], "packed_pow2": [], "dequant_pow2": []}

    def deq(pq):
        return {"ln": pq["ln"], **{k: dequantize_weight(pq[k].q, pq[k].scale, None, torch.bfloat16).contiguous()
                                   for k in ("w_gu", "w_down")}}  # fmt: skip

    for _ in range(QUANT_LAYERS):
        p = shard_mlp(ffn.init(cfg, g, torch.float32, dev), world)
        pq = {"ln": p["ln"].to(torch.bfloat16), "w_gu": pack_weight(p["w_gu"], spec),
              "w_down": pack_weight(p["w_down"], spec)}  # fmt: skip
        p2 = {"ln": pq["ln"], **{k: dataclasses.replace(pq[k], scale=torch.exp2(torch.round(torch.log2(pq[k].scale))))
                                 for k in ("w_gu", "w_down")}}  # fmt: skip
        for tag, v in (("packed", pq), ("dequant", deq(pq)), ("packed_pow2", p2), ("dequant_pow2", deq(p2))):
            layers[tag].append(v)
        del p
    x0 = rnd(WORLD, BATCH, PROMPT // WORLD, cfg.d_model, dtype=torch.bfloat16)

    def chain(tag, n=QUANT_LAYERS):
        x = x0
        for p in layers[tag][:n]:
            x = ffn.apply_seq(p, x, pc, cfg)
        return x

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()

    with torch.no_grad():
        one, one_ref = diff(chain("packed", 1), chain("dequant", 1))
        err, top = diff(chain("packed"), chain("dequant"))
        chain("packed_pow2"), chain("dequant_pow2")  # warm-up
        K.reset_launch_counts()
        y_p = chain("packed_pow2")
        torch.cuda.synchronize()
        counts = K.launch_counts()
        n_packed = (K.ag_gemm.packed_launches, K.gemm_rs.packed_launches)
        y_d = chain("dequant_pow2")
        ms_p, ms_d = cuda_ms(lambda: chain("packed_pow2"), 5, 1), cuda_ms(lambda: chain("dequant_pow2"), 5, 1)
    bitwise = torch.equal(y_p, y_d)
    print(f"[quant] MLP block 0, int8 packed vs dequantized bf16 weights: max|diff| {one:.3e} (max|ref| {one_ref:.3e}, "
          f"bound {TOL['bfloat16']} x max|ref|); all {QUANT_LAYERS} blocks: max|diff| {err:.3e} (max|ref| {top:.3e}, "
          "recorded)")  # fmt: skip
    print(f"[quant] {QUANT_LAYERS} MLP blocks, power-of-two scales: packed chain bitwise equal to the dequantized "
          f"chain: {bitwise}; {ms_p:.3f} ms packed, {ms_d:.3f} ms dequantized; launches {counts}, packed {n_packed}")
    if not (torch.isfinite(y_p).all() and one <= TOL["bfloat16"] * one_ref and bitwise):
        raise SystemExit(f"chip_smoke: the packed MLP blocks disagree with the dequantized ones ({one} vs {one_ref}; "
                         f"chain bitwise {bitwise})")  # fmt: skip
    want = {"ag_gemm": QUANT_LAYERS, "gemm_rs": QUANT_LAYERS}
    if any(counts[k] != v for k, v in want.items()) or n_packed != (QUANT_LAYERS, QUANT_LAYERS):
        raise SystemExit(f"chip_smoke: the packed chain launched {counts}, packed {n_packed}; want {want}, all packed")
    out.update(counts=counts, chain={"block_max_abs_err": one, "block_max_abs_ref": one_ref, "chain_max_abs_err": err,
                                     "chain_max_abs_ref": top, "pow2_bitwise": bitwise, "packed_ms": ms_p,
                                     "dequant_ms": ms_d})  # fmt: skip
    del layers, y_p, y_d
    torch.cuda.empty_cache()

    # (b) the whole prefill on the eager executor with quantized wires
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    with torch.no_grad():
        ref, _ = lm.prefill(params, cfg, pc_eager, prompts, max_len=PROMPT)
        wires = {}
        for wire in ("int8", "float8_e4m3fn"):
            pcq = ParallelContext(world=world, backend="eager", quant=QuantSpec(wire_dtype=wire))
            lg, _ = lm.prefill(params, cfg, pcq, prompts, max_len=PROMPT)
            rel = ((lg.float() - ref.float()).norm() / ref.float().norm()).item()
            agree = (lg.argmax(-1) == ref.argmax(-1)).float().mean().item()
            wires[wire] = {"logits_rel": rel, "top1_agreement": agree}
            print(f"[quant] prefill, {wire} wire vs identity (eager, bf16): logits rel {rel:.3e}, "
                  f"top-1 agreement {agree:.4f}")
        pc32 = ParallelContext(world=world, backend="eager", quant=QuantSpec(wire_dtype="float32"))
        f32, _ = lm.prefill(params, cfg, pc32, prompts, max_len=PROMPT)
        if not torch.equal(f32, ref):
            raise SystemExit("chip_smoke: the float32 wire's prefill is not bitwise the identity wire's")
        print("[quant] prefill, float32 wire: logits bitwise equal to the identity wire's")
        attn = params["layers"][0]["mixer"]
        xa = rnd(WORLD, BATCH, PROMPT // WORLD, cfg.d_model, dtype=torch.bfloat16)
        xr = rnd(WORLD, BATCH, PROMPT, attn["wo"].shape[1], dtype=torch.bfloat16)
        for wire in ("int8", "float8_e4m3fn"):
            for kind, xx, ww in (("ag_matmul", xa, attn["wqkv"]), ("matmul_rs", xr, attn["wo"])):
                y_f = compile_overlap(kind, pc_eager.channel, world=world)(xx, ww).float()
                y_q = compile_overlap(kind, pc_eager.channel, world=world, quant=QuantSpec(wire_dtype=wire))(xx, ww)
                rel = ((y_q.float() - y_f).norm() / y_f.norm()).item()
                wires[wire][f"{kind}_rel"] = rel
                print(f"[quant] layer 0 {kind}, {wire} wire: rel {rel:.3e} (bound {QUANT_REL})")
                if not rel < QUANT_REL:
                    raise SystemExit(f"chip_smoke: {kind} with an {wire} wire is off by rel {rel} >= {QUANT_REL}")
    try:
        ParallelContext(world=world, backend="fused", quant=QuantSpec(wire_dtype="int8")).ag_matmul(xa, attn["wqkv"])
    except NotImplementedError as e:
        print(f"[quant] fused backend, int8 wire: NotImplementedError ({str(e)[:60]}...)")
    else:
        raise SystemExit("chip_smoke: an int8 wire on the fused backend did not raise")
    out["wires"] = wires

    # (c) gradient compression on one smollm gradient leaf: layer 0's w_down, float32, eager
    mlp = {k: v.float().detach().requires_grad_(k == "w_down") for k, v in params["layers"][0]["ffn"].items()}
    del params
    ffn.apply_seq(mlp, xa.float(), pc_eager, cfg).pow(2).mean().backward()
    grad = mlp["w_down"].grad
    err0 = torch.zeros_like(grad)
    mean, new_err = psum_compressed(grad, err0, world)
    worst = 0.0
    for r in range(WORLD):
        q, sc, e_r = compress_with_feedback(grad[r], err0[r])
        recon = (q.float() * sc + e_r - grad[r]).abs().max().item()
        worst = max(worst, e_r.abs().max().item() / sc.item())
        if not (torch.equal(e_r, new_err[r]) and recon <= 1e-5 * grad[r].abs().max().item()
                and e_r.abs().max().item() <= sc.item() * 0.5 + 1e-6):  # fmt: skip
            raise SystemExit(f"chip_smoke: psum_compressed breaks the error-feedback contract on rank {r}")
    exact = grad.sum(0) / WORLD
    mean_rel = ((mean[0] - exact).norm() / exact.norm()).item()
    print(f"[quant] psum_compressed on layer 0's w_down gradient {list(grad.shape)}: error feedback held on every "
          f"rank (max |new_err| / scale {worst:.4f} <= 0.5); the mean's rel error {mean_rel:.3e} (max scale, recorded)")
    out["compression"] = {"max_err_over_scale": worst, "mean_rel": mean_rel}
    torch.cuda.empty_cache()

    # (d) the packed and wire kernel cases (torch.profiler: after the paths above)
    out["recs"] = _quant_kernel_cases(rnd, iters)
    return out


TUNE_REPEATS, TUNE_WARMUP = 10, 2  # CUDA-event launches timed per candidate, after these warm-up launches
TUNE_ENGINE_LAYERS = 2  # the tuned engine's captured-vs-eager check: smollm-360m's width at this depth
TUNE_ENGINE = dict(requests=8, prompt=(16, 64), new=(8, 16), sampled=2, slots=BATCH, max_len=96)  # its load


def _tune_cases() -> list:
    """The tune phase's tables: (label, kind, per-rank signature, W) for
    smollm-360m's four TP GEMMs at prefill (4 x 256 tokens) and at decode
    (B = 4 slots), and Tab. 2's MLP-1 pair (LLaMA-7B, W = 8)."""
    from repro_torch import tune
    from repro_torch.configs import get_config
    from repro_torch.configs.paper import PAPER_MLP
    from repro_torch.nn.attention import layout
    from repro_torch.serving.engine import decode_gemm_shapes

    cfg = get_config(ARCH)
    lay = layout(cfg, WORLD)
    d, hd, f_loc, s_loc = cfg.d_model, cfg.hd, cfg.d_ff // WORLD, PROMPT // WORLD
    prefill = {
        "qkv": ("ag_matmul", ((BATCH, s_loc, d), (d, (lay.h_loc + 2 * lay.kv_loc) * hd))),
        "attn_out": ("matmul_rs", ((BATCH, PROMPT, lay.h_loc * hd), (lay.h_loc * hd, d))),
        "ffn_gu": ("ag_matmul", ((BATCH, s_loc, d), (d, 2 * f_loc))),
        "ffn_down": ("matmul_rs", ((BATCH, PROMPT, f_loc), (f_loc, d))),
    }
    cases = [(f"{ARCH} prefill {n}", k, tune.signature(k, sh), WORLD) for n, (k, sh) in prefill.items()]
    decode = decode_gemm_shapes(cfg, WORLD, BATCH)
    cases += [(f"{ARCH} decode {n}", k, tune.signature(k, sh, decode=True), WORLD) for n, (k, sh) in decode.items()]
    s, h, i, _ = PAPER_MLP["MLP-1"]
    w = 8
    cases.append(("Tab. 2 MLP-1 AG+GEMM", "ag_matmul", (1, s // w, h, i // w), w))
    cases.append(("Tab. 2 MLP-1 GEMM+RS", "matmul_rs", (1, s, i // w, h), w))
    return cases


def _tune_reference(kind: str, x, w):
    """The f32 product a fused op computes on rank-stacked operands: every
    rank's gathered rows times its own weight (AG+GEMM), or each rank's row
    segment of the sum over ranks (GEMM+RS)."""
    size = x.shape[0]
    if kind == "ag_matmul":
        xg = x.movedim(0, -3).reshape(*x.shape[1:-2], size * x.shape[-2], x.shape[-1]).float()
        return _per_rank_matmul(xg, w)
    full = sum(x[q].float() @ w[q].float() for q in range(size))
    m_loc = full.shape[-2] // size
    return full.reshape(*full.shape[:-2], size, m_loc, full.shape[-1]).movedim(-3, 0)


def _per_rank_matmul(xg, w):
    """``xg`` (shared by the ranks) times each rank's ``w[r]``, in float32: [W, *lead, rows, n]."""
    import torch

    return torch.stack([xg @ w[r].float() for r in range(w.shape[0])])


def _tune_table(label: str, kind: str, sig, size: int, smi: str) -> dict:
    """Every candidate of one shape timed on the fused kernels (bf16, CUDA
    events, exhaustive), each output held against the f32 product; the
    measured winner, the model's pick and its measured rank, the default
    channel's time, and the tuner's own pruned sweep."""
    import torch

    from repro_torch import tune
    from repro_torch.backend.mesh import World
    from repro_torch.core import BlockChannel
    from repro_torch.tune import cost, measure

    world = World(size, "cuda")
    target = tune.Target("fused", world.device, torch.bfloat16)
    cands = tune.enumerate_candidates(kind, extent=tune.chunk_extent(kind, sig), space=tune.JOINT_SPACE, sig=sig,
                                      world=size, target=target)  # fmt: skip
    case = measure.CaseTimer(kind, world, sig, backend="fused", dtype=torch.bfloat16)
    with torch.no_grad():
        ref = _tune_reference(kind, *case.args)
    scale = ref.abs().max().item()
    rows, worst = [], 0.0
    for cand in cands:
        ch = cand.channel("model")
        out = case.run(ch)
        err = (out.float() - ref).abs().max().item()
        worst = max(worst, err)
        if not (bool(torch.isfinite(out).all()) and err <= TOL["bfloat16"] * scale):
            raise SystemExit(f"chip_smoke: tune {label} {cand.label()} disagrees with the f32 product: {err} > "
                             f"{TOL['bfloat16']} x {scale}")  # fmt: skip
        med, iqr = case.time(ch, repeats=TUNE_REPEATS, warmup=TUNE_WARMUP)
        rows.append({"candidate": cand.label(), "median_ms": med / 1e3, "iqr_ms": iqr / 1e3,
                     "model_s": cost.predict_cost(kind, sig, size, cand, target)})  # fmt: skip
    del case, ref
    by_time = sorted(range(len(rows)), key=lambda j: rows[j]["median_ms"])
    win = rows[by_time[0]]
    pick = min(range(len(rows)), key=lambda j: (rows[j]["model_s"], j))  # strict: ties keep enumeration order
    default = next(r for r, c in zip(rows, cands) if c.channel("model") == BlockChannel(axis="model"))
    swept = tune.autotune(kind, signature=sig, world=world, backend="fused", dtype=torch.bfloat16,
                          space=tune.JOINT_SPACE, repeats=TUNE_REPEATS, warmup=TUNE_WARMUP)  # fmt: skip
    print(f"[tune] {label}: {kind} per-rank signature {tuple(sig)}, W = {size}, bf16, fused; {len(rows)} candidates "
          f"({smi})")  # fmt: skip
    for r in rows:
        print(f"[tune]   {r['candidate']:<28} median {r['median_ms']:.4f} ms  iqr {r['iqr_ms']:.4f} ms  "
              f"model {r['model_s'] * 1e3:.4f} ms")  # fmt: skip
    rank = by_time.index(pick) + 1
    print(f"[tune]   measured winner {win['candidate']} {win['median_ms']:.4f} ms; model's pick "
          f"{rows[pick]['candidate']} {rows[pick]['median_ms']:.4f} ms (measured rank {rank} of {len(rows)}); default "
          f"{default['candidate']} {default['median_ms']:.4f} ms (winner / default "
          f"{win['median_ms'] / default['median_ms']:.3f}); the tuner's sweep {swept.candidate.label()} "
          f"{swept.score / 1e3:.4f} ms {swept.sweep}; every output within {worst:.3e} of the f32 product "
          f"(max {scale:.3e}, bound {TOL['bfloat16']} x max)")  # fmt: skip
    return {"label": label, "kind": kind, "signature": list(sig), "world": size, "rows": rows,
            "winner": win["candidate"], "model_pick": rows[pick]["candidate"], "model_pick_rank": rank,
            "default_ms": default["median_ms"], "winner_ms": win["median_ms"], "sweep_winner": swept.candidate.label(),
            "sweep": swept.sweep, "max_abs_err": worst, "max_abs_ref": scale}  # fmt: skip


def phase_tune(smi: str) -> dict:
    """The autotuner on the card (module docstring, phase tune): the tables,
    a cache hit and a capture that launch nothing, the tuned prefill's
    launches, and the tuned engine captured against eager."""
    import os
    import tempfile

    import torch

    from repro_torch import kernels as K
    from repro_torch import tune
    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serving import ServeEngine

    out = {}
    env = os.environ.get("REPRO_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["REPRO_TUNE_CACHE"] = cache_dir
        tune.cache.clear_memo()
        try:
            cases = _tune_cases()
            t0 = time.perf_counter()
            out["tables"] = [_tune_table(*c, smi) for c in cases]
            torch.cuda.empty_cache()
            out["tables_s"] = time.perf_counter() - t0
            print(f"[tune] {len(cases)} tables in {out['tables_s']:.1f} s")

            # a cache hit, and resolution inside a CUDA graph capture, launch nothing
            K.reset_launch_counts()
            hits = [tune.autotune(k, signature=sig, world=World(w, "cuda"), backend="fused", dtype=torch.bfloat16,
                                  space=tune.JOINT_SPACE).cache_hit for _, k, sig, w in cases]  # fmt: skip
            graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
            with torch.cuda.stream(side), torch.cuda.graph(graph):
                new = tune.autotune("matmul_rs", signature=(2, 512, 640, 960), world=World(WORLD, "cuda"),
                                    backend="fused", dtype=torch.bfloat16, space=tune.JOINT_SPACE)  # fmt: skip
                again = tune.autotune(cases[0][1], signature=cases[0][2], world=World(WORLD, "cuda"), backend="fused",
                                      dtype=torch.bfloat16, space=tune.JOINT_SPACE)  # fmt: skip
            counts = K.launch_counts()
            print(f"[tune] {sum(hits)} of {len(hits)} re-resolutions hit the cache; inside a capture: a new shape "
                  f"ranked by the {new.ranker}, a cached one hit ({again.cache_hit}); launches {counts}")
            if not (all(hits) and again.cache_hit and new.ranker == "model" and not any(counts.values())):
                raise SystemExit("chip_smoke: a cache hit or a resolution inside a capture launched a kernel")
            del graph

            # the main path: smollm-360m's bf16 prefill under ParallelContext(tune=True), the cache warm
            cfg = get_config(ARCH)
            world = World(WORLD, "cuda")
            params = lm.init(cfg, world, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
            prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=torch.Generator().manual_seed(1))
            prompts = prompts.cuda()
            pc = ParallelContext(world=world, tune=True)
            with torch.no_grad():
                ref, _ = lm.prefill(params, cfg, ParallelContext(world=world), prompts, max_len=PROMPT)
                K.reset_launch_counts()
                t0 = time.perf_counter()
                logits, _ = lm.prefill(params, cfg, pc, prompts, max_len=PROMPT)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                out["counts"] = K.launch_counts()
            diff = (logits.float() - ref.float()).abs().max().item()
            agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
            want = {"matmul": 1, "ag_gemm": 2 * cfg.n_layers, "gemm_rs": 2 * cfg.n_layers,
                    "flash_attention": cfg.n_layers}  # fmt: skip
            print(f"[tune] {ARCH} prefill under ParallelContext(tune=True), bf16 {BATCH} x {PROMPT}: {ms:.2f} ms (host "
                  f"clock, the cache warm); launches {out['counts']}; logits vs the untuned prefill max|diff| "
                  f"{diff:.3e}, top-1 agreement {agree:.4f} (recorded)")  # fmt: skip
            if not bool(torch.isfinite(logits).all()) or any(out["counts"][k] != v for k, v in want.items()):
                raise SystemExit(f"chip_smoke: the tuned prefill launched {out['counts']} (want {want}) or is not "
                                 "finite")
            out["prefill"] = {"ms": ms, "max_abs_diff_vs_untuned": diff, "top1_agreement": agree}
            del params, logits, ref
            torch.cuda.empty_cache()

            # the tuned engine at smollm's width, 2 layers: decode winners before capture, captured == eager
            t0 = time.perf_counter()
            cfg2 = dataclasses.replace(cfg, n_layers=TUNE_ENGINE_LAYERS)
            params = lm.init(cfg2, world, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
            reqs = _engine_requests(cfg2, TUNE_ENGINE, seed=3)
            toks = {}
            for capture in (True, False):
                eng = ServeEngine(cfg2, pc, params, max_len=TUNE_ENGINE["max_len"], n_slots=BATCH, capture=capture)
                if set(eng.decode_channels) != {"qkv", "attn_out", "ffn_gu", "ffn_down"}:
                    raise SystemExit(f"chip_smoke: the tuned engine resolved {sorted(eng.decode_channels)}")
                handles = [eng.submit(r) for r in reqs]
                done = eng.drain()
                toks[capture] = [done[h].tolist() for h in handles]
            same = toks[True] == toks[False]
            print(f"[tune] tuned engine ({ARCH} width, {TUNE_ENGINE_LAYERS} layers, {BATCH} slots, {len(reqs)} "
                  f"requests): decode winners resolved before capture; captured tokens equal eager tokens: {same} "
                  f"({time.perf_counter() - t0:.1f} s)")
            if not same:
                raise SystemExit("chip_smoke: the tuned engine's captured tokens differ from its eager tokens")
            out["engine_bitwise"] = same
        finally:
            if env is None:
                os.environ.pop("REPRO_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TUNE_CACHE"] = env
            tune.cache.clear_memo()
    return out


# ---- the verify phase: the port's static verifier (repro_torch.analysis) on the card's launches ----


def _verify_shapes() -> list:
    """(label, kind, x shape, w shape, float32 too) of every AG+GEMM / GEMM+RS
    shape the serve, train, paper and tune phases launch: each arch's serve
    path (:func:`path_shapes`, 4 x 256 tokens; paligemma's 4 x 512,
    seamless-m4t's encoder at 4 x 4096 frames, gemma3's greedy at 4 x 2048,
    mamba2's in / out projections), smollm-360m's train step (8 x 256, the
    backward's transposes too), Fig. 11's forward and backward at 1 x 4096
    tokens of every row, and Tab. 2's MLP-1 pair (W = 8).  smollm's serve
    and train shapes also run the float32 route, as the phases' float32
    checks do."""
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.configs.paper import PAPER_MLP

    W, out = WORLD, []

    def dense(arch, b, s, tag, f32=False, bwd=False):
        shp = path_shapes(arch)
        d, s_loc = shp["d"], s // W
        ags = [("qkv", shp["n_qkv"])] + [(f"{m}gate_up", gu) for m, gu, _ in _mlps(shp)]
        rss = [("o_proj", shp["n_o"])] + [(f"{m}down", f) for m, _, f in _mlps(shp)]
        if arch == ARCH_ED:
            ags.append(("cross_kv", 2 * shp["kv_loc"] * shp["hd"]))
        out.extend((f"{arch} {tag} {t}", "ag_gemm", (W, b, s_loc, d), (W, d, n), f32) for t, n in ags)
        out.extend((f"{arch} {tag} {t}", "gemm_rs", (W, b, s, k), (W, k, d), f32) for t, k in rss)
        if bwd:  # dx of the column-parallel projections through GEMM+RS, of the row-parallel ones through AG+GEMM
            out.extend((f"{arch} {tag} bwd_{t}", "gemm_rs", (W, b, s, n), (W, n, d), f32) for t, n in ags)
            out.extend((f"{arch} {tag} bwd_{t}", "ag_gemm", (W, b, s_loc, d), (W, d, k), f32) for t, k in rss)

    for arch in (ARCH, ARCH_MOE, ARCH_DS, ARCH_Z):
        dense(arch, BATCH, PROMPT, "serve", f32=arch == ARCH)
    dense(ARCH_V, BATCH, 2 * PROMPT, "serve")
    dense(ARCH_ED, BATCH, 4096, "encode")
    dense(ARCH_G, E2E_SERVE_BATCH, E2E_SERVE_PROMPT, "serve")
    ssm = ssm_shapes()
    out.append((f"{ARCH_SSM} serve in_proj", "ag_gemm", (W, BATCH, PROMPT // W, ssm["d"]), (W, ssm["d"], ssm["n_in"]),
                False))  # fmt: skip
    out.append((f"{ARCH_SSM} serve out_proj", "gemm_rs", (W, BATCH, PROMPT, ssm["di_loc"]),
                (W, ssm["di_loc"], ssm["d"]), False))  # fmt: skip
    dense(ARCH, TRAIN_BATCH, TRAIN_SEQ, "train", f32=True, bwd=True)
    for arch in paper_e2e.MODELS:
        dense(arch, paper_e2e.BATCH, paper_e2e.SEQ, "e2e", bwd=True)
    s, h, i, _ = PAPER_MLP["MLP-1"]
    w8 = PAPER_WORLD
    out.append(("Tab. 2 MLP-1 AG+GEMM", "ag_gemm", (w8, 1, s // w8, h), (w8, h, i // w8), False))
    out.append(("Tab. 2 MLP-1 GEMM+RS", "gemm_rs", (w8, 1, s, i // w8), (w8, i // w8, h), False))
    return out


def _verify_points(kind: str, xs, ws, dtype, device) -> list:
    """The (order, C) points the tuner enumerates for this shape on the
    fused backend in ``dtype`` (C requested from {1, 2, 4}, clamped)."""
    from repro_torch import tune

    akind = "ag_matmul" if kind == "ag_gemm" else "matmul_rs"
    sig = tune.signature(akind, (xs[1:], ws[1:]))
    cands = tune.enumerate_candidates(akind, extent=tune.chunk_extent(akind, sig), sig=sig, world=xs[0],
                                      target=tune.Target("fused", device, dtype))  # fmt: skip
    return list(dict.fromkeys((c.order, c.num_channels) for c in cands))


def _prove(job) -> tuple:
    """One launch proof of (b), in a worker process: ``verify_launch`` on meta
    tensors of the launch's shapes (it reads shapes only) at its grids."""
    import torch

    from repro_torch import analysis
    from repro_torch.core import BlockChannel, CommSpec

    kind, xs, ws, dtype, order, nch, grids = job
    dt = getattr(torch, dtype)
    x, w = torch.empty(xs, dtype=dt, device="meta"), torch.empty(ws, dtype=dt, device="meta")
    ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=nch)
    t0 = time.perf_counter()
    rep = analysis.verify_launch(kind, x, w, ch, grids)
    return len(rep.passes), rep.checks, rep.events, time.perf_counter() - t0


def _verify_launches(pool) -> tuple:
    """(b): each shape of :func:`_verify_shapes` at each of its points:
    one launch, its output held against the f32 product (bf16 2e-2 of max,
    float32 1e-4), and ``verify_launch`` at the grid the card reported and
    at the route's smallest grid (G = 1; the float32 route's grid is one
    block per (n-tile, channel, rank), so its smallest is one n-tile),
    submitted to ``pool`` (host Python over up to ~33k items a launch).
    Returns (the summary, the proofs' futures)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.core import BlockChannel, CommSpec

    gen = torch.Generator(device="cuda").manual_seed(11)
    launches, worst, grids, futures = 0, {}, {}, []
    for label, kind, xs, ws, f32 in _verify_shapes():
        fn = K.ag_gemm if kind == "ag_gemm" else K.gemm_rs
        akind = "ag_matmul" if kind == "ag_gemm" else "matmul_rs"
        for dtype in (torch.bfloat16,) + ((torch.float32,) if f32 else ()):
            name = str(dtype)[6:]
            fan = xs[-1] if kind == "ag_gemm" else xs[0] * xs[-1]
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(ws, generator=gen, device="cuda") * fan**-0.5).to(dtype)
            with torch.no_grad():
                ref = _tune_reference(akind, x, w)
            scale = ref.abs().max().item()
            for order, nch in _verify_points(kind, xs, ws, dtype, x.device):
                ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=nch)
                before = fn.launches
                out = fn(x, w, channel=ch)
                if fn.launches != before + 1:
                    raise SystemExit(f"chip_smoke: verify {label} {name} {order} C={nch}: no launch counted")
                launches += 1
                ll = fn.last_launch
                err = (out.float() - ref).abs().max().item()
                if not (bool(torch.isfinite(out).all()) and err <= TOL[name] * scale):
                    raise SystemExit(f"chip_smoke: verify {label} {name} {order} C={nch}: |out - f32 product| "
                                     f"{err} > {TOL[name]} x {scale}")  # fmt: skip
                worst[(label, name)] = max(worst.get((label, name), 0.0), err / scale)
                smallest = 1 if ll["route"] == "wgmma" else xs[0] * _eff(akind, xs, ws, nch)
                job = (kind, xs, ws, name, order, nch, tuple(dict.fromkeys((ll["grid"], smallest))))
                futures.append(pool.submit(_prove, job))
                grids.setdefault((kind, ll["route"]), set()).add(ll["grid"])
            del x, w, ref, out
        torch.cuda.empty_cache()
    for (kind, route), gs in sorted(grids.items()):
        print(f"[verify] {kind} {route}: grids the card launched {sorted(gs)}")
    print(f"[verify] (b) {len(worst)} shape x dtype cases, {launches} launches, each output within its bound (worst "
          f"|out - f32 product| / max {max(worst.values()):.3e}; bf16 {TOL['bfloat16']}, f32 {TOL['float32']})")
    summary = {"cases": len(worst), "launches": launches,
               "grids": {f"{k} {r}": sorted(g) for (k, r), g in grids.items()},
               "worst_rel": {" ".join(k): v for k, v in worst.items()}}  # fmt: skip
    return summary, futures


def _eff(akind: str, xs, ws, nch: int) -> int:
    """The effective channel count of a launch (C clamped to its extent)."""
    from repro_torch.core.mapping import effective_channels

    return effective_channels(xs[-2] if akind == "ag_matmul" else ws[-1], nch, kind=akind, warn=False)


def _verify_poked() -> dict:
    """(c): a TilePlan whose flow_dst table has one pair swapped (channel 1,
    step 1, ranks 0 and 1) is refused by ``build_plan``'s verification with
    its coordinates, and ``ag_gemm`` launches nothing."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.analysis import PlanVerificationError
    from repro_torch.core import BlockChannel, CommSpec
    from repro_torch.core import plan as P

    orig = P.TilePlan.flow_dst_tables

    def poked(self):
        rows = [[list(r) for r in ch] for ch in orig(self)]
        rows[1][1][0], rows[1][1][1] = rows[1][1][1], rows[1][1][0]
        return tuple(tuple(tuple(r) for r in ch) for ch in rows)

    x = torch.randn(WORLD, BATCH, PROMPT // WORLD, 960, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(WORLD, 960, 512, device="cuda", dtype=torch.bfloat16)
    ch = BlockChannel(axis="poked", comm=CommSpec(order="ring"), num_channels=2)  # a plan no phase built
    before, err = K.ag_gemm.launches, None
    P.TilePlan.flow_dst_tables = poked
    try:
        K.ag_gemm(x, w, channel=ch)
    except PlanVerificationError as e:
        err = e
    finally:
        P.TilePlan.flow_dst_tables = orig
    if err is None or err.check != "flow_composition" or (err.channel, err.step) != (1, 1) or err.rank not in (0, 1):
        raise SystemExit(f"chip_smoke: verify (c): the poked flow_dst table was not refused at its coordinates: {err}")
    if K.ag_gemm.launches != before:
        raise SystemExit("chip_smoke: verify (c): the poked plan reached a launch")
    print(f"[verify] (c) poked flow_dst pair refused before any launch: {err}")
    return {"refused": str(err), "launches": K.ag_gemm.launches - before}


def _calibrate(tag: str, shape, smi: str) -> dict:
    """(b) one calibration cell: smollm-360m's bf16 ``shape`` planned on the
    card's mesh and run on the card (module docstring, phase 19c)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.roofline import HW
    from repro_torch.models import lm
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    mesh = make_dev_mesh(WORLD)
    plan = dryrun.run_cell(ARCH, shape, mesh=mesh, remat="none", verbose=False)
    if plan["status"] != "ok":
        raise SystemExit(f"chip_smoke: the plan of {tag} is {plan['status']}: {plan}")
    args_world = plan["memory"]["world"]["arguments"]
    placed_pred = args_world["params"] + args_world.get("opt_state", 0)
    peak_pred = sum(args_world.values()) + plan["memory"]["world"]["temp_size_in_bytes"]

    cfg = get_config(ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    pc = mesh.context()
    params = lm.init(cfg, pc.world, torch.Generator(device=pc.device).manual_seed(0), torch.bfloat16)
    opt = init_opt_state(lm.trainable(params, cfg)) if shape.kind == "train" else None
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len, global_batch=shape.global_batch).host_batch()
    state = None
    if shape.kind == "train":
        step = make_train_step(lm, cfg, pc, AdamWConfig(), remat_policy="none", grad_masks=lm.grad_masks(cfg, pc),
                               donate=True)  # fmt: skip
        state = [params, opt]

        def run():
            state[0], state[1], m = step(state[0], state[1], batch)
            return m["loss"]

    else:
        tokens = torch.as_tensor(batch["inputs"], device=pc.device)

        def run():
            with torch.no_grad():
                return lm.prefill(params, cfg, pc, tokens, max_len=shape.seq_len)[0]

    run()  # warm-up: the kernels' first launches and the allocator's pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = run()
    e1.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        raise SystemExit(f"chip_smoke: the {tag} calibration step gave non-finite values")
    ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated() - base
    arg_err = abs(placed_pred - placed) / placed
    ratio = peak_pred / peak
    # the W ranks' work on the one card: the plan's per-device terms times W, at the card's own rates
    w = mesh.shape["model"]
    flops, nbytes = plan["cost"]["flops"] * w, plan["cost"]["bytes_accessed"] * w
    coll = plan["collective_axes"]["model"] * w
    terms = {"compute_ms": flops / HW["peak_flops"] * 1e3, "memory_ms": nbytes / HW["hbm_bw"] * 1e3,
             "collective_ms": coll / HW["link_bw"] * 1e3}  # fmt: skip
    print(f"[dryrun] (b) {tag}: smollm-360m bf16 {shape.global_batch} x {shape.seq_len}, W = {w} on one card ({smi}): "
          f"arguments predicted {placed_pred} B, memory_allocated after placing them {placed} B (rel err "
          f"{arg_err:.3e}, bound {CAL_ARG_RTOL:g}); peak predicted {peak_pred:.0f} B, measured max_memory_allocated "
          f"{peak} B, ratio {ratio:.4f} (bound {CAL_PEAK[0]:g}-{CAL_PEAK[1]:g}); the plan's terms at the card's "
          f"HW (data sheet): compute {terms['compute_ms']:.4f} ms, memory {terms['memory_ms']:.4f} ms (unfused "
          f"bytes), collective {terms['collective_ms']:.4f} ms, beside the measured step {ms:.3f} ms")  # fmt: skip
    if arg_err > CAL_ARG_RTOL or not CAL_PEAK[0] <= ratio <= CAL_PEAK[1]:
        raise SystemExit(f"chip_smoke: the plan of {tag} misses the card: argument rel err {arg_err:.3e}, "
                         f"peak ratio {ratio:.4f}")  # fmt: skip
    params = opt = state = None
    torch.cuda.empty_cache()
    return {"arguments_predicted": placed_pred, "arguments_measured": placed, "argument_rel_err": arg_err,
            "peak_predicted": peak_pred, "peak_measured": peak, "peak_ratio": ratio, "terms_ms": terms,
            "step_ms": ms, "plan": plan}  # fmt: skip


def start_dryrun_grid() -> dict:
    """(a)'s grid of the dryrun phase, which plans on meta and needs no
    card, in a background thread of this process (its processes spawned
    from there), started before the first phase so that it overlaps the
    phases before the dryrun phase; half the host's cores plan it, the
    other half stay with those phases.  Returns its record for :func:`phase_dryrun`."""
    import os
    import threading

    from repro_torch.launch import dryrun

    rec = {"jobs": max(2, min(DRYRUN_JOBS, (os.cpu_count() or 2) // 2))}  # 2 at least: no plan in this process

    def run():
        t0 = time.perf_counter()
        try:
            rec["results"] = dryrun.run_grid(jobs=rec["jobs"])
        except BaseException as e:  # raised again in the dryrun phase
            rec["error"] = e
        rec["s"] = time.perf_counter() - t0

    rec["thread"] = threading.Thread(target=run, name="dryrun grid", daemon=True)
    rec["thread"].start()
    return rec


def phase_dryrun(smi: str, grid: dict) -> dict:
    """The dry-run planner held to the card (module docstring, phase 19c);
    ``grid``: :func:`start_dryrun_grid`'s record."""
    from repro_torch.configs import ARCH_NAMES, SHAPES, Shape, get_config
    from repro_torch.launch import report
    from repro_torch.launch.specs import cell_is_applicable

    t0 = time.perf_counter()
    grid["thread"].join()
    if "error" in grid:
        raise grid["error"]
    results, grid_s, jobs = grid["results"], grid["s"], grid["jobs"]
    print(f"[dryrun] (a) the grid, started in the background before the first phase, ended {grid_s:.1f} s after its start; "
          f"this phase waited {time.perf_counter() - t0:.1f} s for it")  # fmt: skip
    print(report.table(results))
    bad = []
    for r in results:
        ok, why = cell_is_applicable(get_config(r["arch"]), SHAPES[r["shape"]])
        want = {"status": "ok"} if ok else {"status": "skipped", "reason": why}
        if any(r.get(k) != v for k, v in want.items()):
            bad.append((r["arch"], r["shape"], r["multi_pod"], r["status"], r.get("error")))
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"[dryrun] (a) {len(results)} cells ({len(ARCH_NAMES)} archs x {len(SHAPES)} shapes x single / multi-pod), "
          f"{n_ok} ok, {len(results) - n_ok} skipped; {grid_s:.1f} host s in {jobs} processes; the terms are "
          "predictions at H100 SXM data-sheet rates (700 W), not measurements")  # fmt: skip
    if bad:
        raise SystemExit(f"chip_smoke: dry-run cells off the reference's rule: {bad[:8]}")
    out = {"grid_s": grid_s, "cells": {f"{r['arch']} {r['shape']} {'mp' if r['multi_pod'] else 'sp'}": r
                                       for r in results}}  # fmt: skip
    out["train"] = _calibrate("train", Shape("train_8x256", TRAIN_SEQ, TRAIN_BATCH, "train"), smi)
    out["prefill"] = _calibrate("prefill", Shape("prefill_4x256", PROMPT, BATCH, "prefill"), smi)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[dryrun] phase host seconds: {out['phase_s']:.1f} (the grid {grid_s:.1f})")
    return out


def phase_verify() -> dict:
    """The static verifier on the card (module docstring, phase verify):
    (b)'s launches first, their proofs in VERIFY_WORKERS processes, (a) in
    this process meanwhile, then (c) and (d)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.analysis import verify_seq_space, verify_space
    from repro_torch.analysis.verify import SEQ_OPS
    from repro_torch.core.plan import verify_stats

    workers = max(1, min(VERIFY_WORKERS, (os.cpu_count() or 2) - 2))
    t_wall = time.perf_counter()
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        out = {}
        out["launch"], futures = _verify_launches(pool)
        launched_s = time.perf_counter() - t_wall
        t0 = time.perf_counter()
        plans = sum(1 for _ in verify_space()) + sum(1 for k in SEQ_OPS.values() for _ in verify_seq_space(kinds=k))
        space_s = time.perf_counter() - t0
        print(f"[verify] (a) the shipped plan space: {plans} plan(s) verified in {space_s:.1f} host s")
        proofs = checks = events = 0
        host_s = 0.0
        for fut in futures:
            n, c, e, dt = fut.result()  # a refused launch raises its PlanVerificationError here
            proofs, checks, events, host_s = proofs + n, checks + c, events + e, host_s + dt
    proved_s = time.perf_counter() - t_wall
    print(f"[verify] (b) {proofs} launch proofs passed (the card's G and the smallest grid of {len(futures)} "
          f"launches): {checks} checks, {events} ops simulated, {host_s:.1f} host s in {workers} processes; "
          f"launches done at {launched_s:.1f} s, proofs at {proved_s:.1f} s")  # fmt: skip
    out.update(space_plans=plans, space_host_s=space_s, proofs=proofs, checks=checks, events=events,
               proof_host_s=host_s, workers=workers, launched_s=launched_s, proved_s=proved_s)  # fmt: skip
    out["poked"] = _verify_poked()
    stats = verify_stats()
    print(f"[verify] (d) this run: build_plan {stats['plan_misses']} misses, {stats['plans_verified']} verified, "
          f"{stats['plans_refused']} refused; build_seq_plan {stats['seq_misses']} misses, {stats['seqs_verified']} "
          f"verified, {stats['seqs_refused']} refused")  # fmt: skip
    if (stats["plan_misses"] != stats["plans_verified"] + stats["plans_refused"] or stats["plans_refused"] != 1
            or stats["seq_misses"] != stats["seqs_verified"] or stats["seqs_refused"]):  # fmt: skip
        raise SystemExit(f"chip_smoke: verify (d): a plan of this run was built unverified (or refused besides the "
                         f"poked one): {stats}")  # fmt: skip
    out["stats"] = stats
    return out


def _profile(params, cfg, pc, prompts, max_len, embeds=None):
    """Device time by kernel name for one prefill and one decode step
    (torch.profiler), with the device-busy share of each window."""
    from repro_torch.benchmarks.common import profile_windows
    from repro_torch.models import lm

    _, caches = lm.prefill(params, cfg, pc, prompts, embeds, max_len=max_len)
    tok = prompts[:, -1:]
    pos = prompts.shape[1] + (0 if embeds is None else embeds.shape[1])
    return profile_windows(cfg.name, {
        "prefill": lambda: lm.prefill(params, cfg, pc, prompts, embeds, max_len=max_len),
        "decode_step": lambda: lm.decode_step(params, caches, cfg, pc, tok, pos),
    })  # fmt: skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the PyTorch/CUDA port")
    ap.add_argument("--json", default=None, help="also write every measured record to this file")
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel for one prefill / decode step, one engine decode iteration "
                    "and one train step")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone after device and build (e.g. tp_gpus on a "
                    "four-card machine); the kernels line is printed by a whole run only")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    kind, smi = phase_device()
    build_s, fma_spills = phase_build()
    out = {"device": kind, "nvidia_smi": smi, "build_s": build_s, "fma_spills": fma_spills, "phase_s": {}}
    prof = args.profile
    background = {}  # work started with the script that needs no card (the dryrun phase's grid)
    phases = {"serve": lambda: phase_serve(prof), "seam": lambda: phase_seam(prof), "moe": lambda: phase_moe(prof),
              "deepseek": lambda: phase_deepseek(prof), "ep": lambda: phase_ep(prof), "ssm": lambda: phase_ssm(prof),
              "engine": lambda: phase_engine(prof), "ring": phase_ring, "train": lambda: phase_train(prof),
              "train_seam": phase_train_seam, "dp": phase_dp, "serve_dp": lambda: phase_serve_dp(out["dp"].pop("serve"), smi),
              "examples": phase_examples,
              "train_moe": lambda: phase_train_moe(prof), "train_ssm": lambda: phase_train_ssm(prof),
              "zamba2": lambda: phase_zamba2(prof), "encdec": lambda: phase_encdec(prof), "vlm": lambda: phase_vlm(prof),
              "e2e": lambda: phase_e2e(prof), "paper": phase_paper, "quant": lambda: phase_quant(ITERS),
              "tune": lambda: phase_tune(smi), "dryrun": lambda: phase_dryrun(smi, background["dryrun"]),
              "tp_gpus": lambda: phase_tp_gpus(smi),
              # last but one: its torch.profiler sessions (device_ms) leave host overhead behind
              # that would slow the host-bound prefill and decode of the phases above
              "kernels": lambda: phase_kernels(ITERS),
              # last: (d) counts the plans every phase built
              "verify": phase_verify}  # fmt: skip
    chosen = list(phases) if args.phases is None else [n.strip() for n in args.phases.split(",") if n.strip()]
    unknown = [n for n in chosen if n not in phases]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; one of {list(phases)}")
    if "dryrun" in chosen:
        background["dryrun"] = start_dryrun_grid()
    for name in chosen:
        t0 = time.perf_counter()
        out[name] = phases[name]()
        out["phase_s"][name] = time.perf_counter() - t0
        print(f"[summary] phase {name}: {out['phase_s'][name]:.1f} s")
    if args.phases is not None:  # some phases alone: their records, no kernels line
        out["wall_s"] = time.perf_counter() - t_start
        print(f"[summary] wall time of the script: {out['wall_s']:.1f} s (the kernels' build included)")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(out, indent=1, default=str))
        print(f"{smi}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    recs = out.pop("kernels")
    recs.update(out["quant"].pop("recs"))  # the quant phase's packed / wire kernel cases
    by_path = {ARCH: out["serve"]["counts"], ARCH_MOE: out["moe"]["counts"], ARCH_DS: out["deepseek"]["counts"],
               ARCH_SSM: out["ssm"]["counts"]}  # fmt: skip
    by_path.update({f"engine {arch}": r["counts"] for arch, r in out["engine"].items()})
    by_path[f"engine {ARCH_DS}"] = out["deepseek"]["engine"]["counts"]
    by_path.update({f"ring {arch}": c for arch, c in out["ring"]["counts"].items()})
    by_path[f"seam {ARCH}"] = out["seam"]["counts"]
    by_path[f"ep {ARCH_DS}"] = out["ep"]["counts"]
    by_path[f"train {ARCH}"] = out["train"]["bf16"]["counts"]
    by_path[f"train_seam {ARCH}"] = out["train_seam"]["counts"]
    by_path[f"dp {ARCH}"] = out["dp"]["counts"]  # both replica processes' launches
    by_path[f"serve_dp {ARCH}"] = out["serve_dp"]["counts"]  # both replicas' engine and serve.greedy
    by_path["examples"] = out["examples"]["counts"]
    by_path[f"train_moe {ARCH_MOE}"] = out["train_moe"]["bf16"]["counts"]
    by_path[f"train_moe {ARCH_DS}"] = out["train_moe"]["bf16_ds"]["counts"]
    by_path[f"train_ssm {ARCH_SSM}"] = out["train_ssm"]["bf16"]["counts"]
    by_path[ARCH_Z] = out["zamba2"]["counts"]
    by_path[f"engine {ARCH_Z}"] = out["zamba2"]["engine"]["counts"]
    by_path[f"train {ARCH_Z}"] = out["zamba2"]["train"]["bf16"]["counts"]
    by_path[f"encdec {ARCH_ED}"] = out["encdec"]["counts"]
    by_path[f"train encdec {ARCH_ED}"] = out["encdec"]["train"]["counts"]
    by_path[f"vlm {ARCH_V}"] = out["vlm"]["counts"]
    by_path[f"train vlm {ARCH_V}"] = out["vlm"]["train"]["counts"]
    by_path.update({f"e2e {arch}": c for arch, c in out["e2e"]["counts"].items()})
    by_path[f"e2e serve {ARCH_G}"] = out["e2e"]["serve"]["counts"]
    by_path["paper"] = out["paper"]["counts"]
    by_path[f"quant {ARCH}"] = out["quant"]["counts"]
    by_path[f"tune {ARCH}"] = out["tune"]["counts"]
    print("kernels: " + json.dumps(by_path))
    line = []
    engines = [*out["engine"].values(), out["deepseek"]["engine"], out["zamba2"]["engine"]]
    bf16, f32 = torch.bfloat16, torch.float32
    for name, arch, tag, dtype in (
        ("matmul", ARCH, "lm_head", bf16), ("ag_gemm", ARCH, "gate_up", bf16), ("gemm_rs", ARCH, "down", bf16),
        ("flash_attention", ARCH, "prefill", bf16), ("grouped_matmul", ARCH_MOE, "gate_up", bf16),
        ("ssd_intra_chunk", ARCH_SSM, "intra", f32),
    ):  # fmt: skip
        r = recs[(name, arch, tag, dtype)]
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"], "shape": r["case"], "dtype": r["dtype"], "launch": r.get("launch"),
            "launches_by_path": {arch: c[name] for arch, c in by_path.items()},
            # device launches by the engine's graph replays (the wrapper counts host calls only)
            "graph_launches": sum(r["head_graph_launches"] for r in engines) if name == "matmul" else 0,
            # the input gradients of the train phase's backward (bf16)
            "train_backward": {f"{a} {t}": {k: recs[(n, a, t, d)][k] for k in TIMES if k in recs[(n, a, t, d)]}
                               for n, a, t, d in recs if n == name and t.startswith("bwd_") and d == bf16},
            # the e2e phase's forward and backward shapes of every Fig. 11 row but smollm's (bf16)
            "e2e": {f"{a} {t}": {k: recs[(n, a, t, d)][k] for k in TIMES if k in recs[(n, a, t, d)]}
                    for n, a, t, d in recs if n == name and t.startswith("e2e_") and d == bf16},
            # the train paths' autograd Functions and statistics by arch: max|err| of each check
            "train_checks": {(a if t == "autograd" else f"{a} {t}"): recs[(n, a, t, d)]["max_abs_err"].get(name, {})
                             for n, a, t, d in recs if n == "train"},
        })  # fmt: skip
        if name == "grouped_matmul":  # across the cards: the tp_gpus phase's cases, each from its slowest card
            tg = out["tp_gpus"]
            line[-1]["across_cards"] = tg["moe"]["grouped"] if tg["run"] else (
                f"not run: {tg['cards']} card visible (chip_smoke.py --phases tp_gpus on four cards)")
        if name == "flash_attention":  # head dim 80 (zamba2's shared attention), bf16 on the wgmma route
            r80 = recs[(name, ARCH_Z, "prefill", bf16)]
            line[-1]["d80"] = {k: r80[k] for k in TIMES if k in r80}
            # head dim 256 (paligemma, causal MQA), bf16 on the wgmma route; seamless-m4t's non-causal encoder
            # and its cross-attention (Sq != Sk)
            r256, r256f = recs[(name, ARCH_V, "prefill", bf16)], recs[(name, ARCH_V, "prefill", f32)]
            line[-1]["d256"] = {k: r256[k] for k in TIMES if k in r256}
            line[-1]["d256_f32"] = {k: r256f[k] for k in TIMES if k in r256f}  # the FMA route
            line[-1]["encdec"] = {t: {k: recs[(name, ARCH_ED, t, bf16)][k] for k in TIMES
                                      if k in recs[(name, ARCH_ED, t, bf16)]} for t in ("encoder", "cross")}
        if name in ("matmul", "ag_gemm", "gemm_rs"):  # the multimodal models' heads and projections (bf16)
            line[-1]["multimodal"] = {f"{a} {t}": {k: recs[(n, a, t, d)][k] for k in TIMES if k in recs[(n, a, t, d)]}
                                      for n, a, t, d in recs if n == name and a in (ARCH_ED, ARCH_V) and d == bf16}
        if name in ("ag_gemm", "gemm_rs"):  # the quant phase: packed weights (both routes) and gemm_rs's bf16 wire
            for key in ("packed", "wire"):
                line[-1][key] = {f"{a} {t} {str(d)[6:]}": {k: recs[(n, a, t, d)][k] for k in TIMES
                                                            if k in recs[(n, a, t, d)]}
                                 for n, a, t, d in recs if n == name and t.startswith(key)}  # fmt: skip
        if name == "ssd_intra_chunk":  # the train tile (f32), forward and the torch-ops backward
            rt = recs[(name, ARCH_SSM, "train", f32)]
            line[-1]["train"] = {k: rt[k] for k in (*TIMES, "backward_ms", "backward_bound_ms", "function_errs")
                                 if k in rt}  # fmt: skip
    out["wall_s"] = time.perf_counter() - t_start
    print(f"[summary] wall time of the script: {out['wall_s']:.1f} s (the kernels' build included)")
    if args.json:
        out["cases"] = [r for r in recs.values()]
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1, default=str))
    print(f"{smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

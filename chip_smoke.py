#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

  1. the card's name and power limit (``nvidia-smi``); TF32 stated and
     switched off for fp32 matmuls and convolutions;
  2. the CUDA C++ kernels built from ``src/repro_torch/kernels/csrc`` by
     ``nvcc`` into ``build/cuda``, one process per source, all started
     together: K1 (``grad_accum.cu``) and K6 (``flash_attention.cu``,
     whose build goes on while phase 3 checks K1-K4);
     ptxas's register and spill lines for every instance (a spill in K1
     or in any K6 instance, or a serialized wgmma in a bf16 K6 instance,
     fails the phase), the shared memory each K6 instance asks for, from
     the library, the blocks of K6's fp32 kernel an SM holds at each head
     dim (the occupancy calculator), and the count of HGMMA instructions
     in K6's SASS (``cuobjdump``);
  3. kernels K1 (CUDA C++) and K2–K4 (Triton, built at first use, cached
     under ``build/triton``) against their plain PyTorch versions at
     ragged sizes in every dtype combination — rtol 1e-6 / atol 1e-6 in
     fp32 and 1 ulp in bf16 (the kernels round where the plain versions
     round, so this only allows for the last place), K1 bit for bit; and
     K1 over lists of (accumulator, gradient) pairs — views at unaligned
     offsets, bf16 gradients and accumulators, an empty leaf, more pairs
     than one launch takes — bit for bit, one launch per group; K2–K4's
     ``GUARD`` variants (the supervisor's finite flag) at the same sizes:
     flag 1 bit-identical to the unguarded kernel, flag 0 writes nothing
     (a NaN in the accumulator included);
  4. kernels K5 (fused cross-entropy, Triton) and K6 (flash attention)
     against their plain versions at edge shapes in fp32 and bf16, labels
     outside [0, V) among them — the per-token NLL within 1e-4, attention
     within 2e-5 in fp32 and 1 ulp + 2e-5 in bf16 (sums are taken in
     another order), each dtype through its own K6 kernel (bf16 the wgmma
     kernel, fp32 the SIMT kernel, by the per-kernel launch counts); fp32
     also at S one below and above the SIMT kernel's 64-row tile, hd 256
     at G = 2 with window and cap, and operands not 16-byte aligned
     (the wrapper launches on aligned copies);
  5. one ``flat``, one ``fused`` and one ``streaming`` step against one
     ``compiled`` step at qwen2-1.5b width, depth cut to 2 layers, bf16
     compute, same seed: params and momentum within the same tolerance,
     K1 launched once a micro-batch by ``flat`` and ``fused`` (``compiled``
     and ``streaming`` add with a plain add); then ``streaming.step`` on
     the host mini-batch against ``streaming.step_split`` on the staged
     split, bit for bit;
  6. the main path: ``repro_torch.launch.train`` for full qwen2-1.5b
     (28 layers, d 1536, vocab 151936) through the ``flat`` executor, the
     async ``Pipeline`` and the ``Trainer``, with the launch counters
     zeroed just before and read just after: every loss finite, the first
     near ln(vocab), K1 launched steps × N_Sμ × buckets times and K2
     steps × buckets times; the steady step is the mean gap between
     consecutive metric readbacks but the last (the Trainer reads step i
     back after step i+1 is queued; the last readback follows no
     dispatch and times only the card's tail behind the host), beside
     the Pipeline's input-wait fraction;
  7. the same launcher with ``--executor streaming`` at full depth (the
     counters zeroed and read around it): no initial param or momentum
     leaf alive once the first step is done (weak references: the
     launcher hands the initial state to the Trainer and keeps no name
     for it), and its peak within 0.25 GiB of the main path's plus what
     the tree update's own peak (measured from the run's final state)
     adds above it; then a ``torch.profiler`` trace of
     one ``StreamingExecutor.step`` on a host mini-batch: its pinned
     host-to-device copies must run on a stream other than the compute
     kernels'; with the copies by kind and stream, the kernels' summed
     time beside the step's, the kernels and CUDA runtime calls that take
     the most time (the trace is written under ``build/`` and removed);
  7a. calibrated admission at full qwen2-1.5b (seq 1024, mini-batch 16,
     no ``--microbatches``) for ``flat`` and ``streaming`` against a
     60 GiB budget: the analytic plan and its corrected prediction (not
     run), ``--calibrate force`` probing the real step at micro-batches
     1, 2 and 4 into ``build/tuning.json`` (the fit and the probes),
     then the launcher with ``--calibrate auto`` — which must plan what
     ``force`` planned — for 2 steps whose peak allocated bytes must stay
     within the budget; and the plans the card's whole memory would get;
  7b. the paper's workloads through ``flat`` at their published sizes,
     fp32, BN statistics per micro-batch: ResNet-50 at 224 px (102
     classes, SGD-m 0.9, lr 0.01, wd 5e-4), mini-batch 1024 = 8 × 128,
     3 steps; U-Net at 384 px (base 64, depth 4, Adam lr 0.01, wd 5e-4,
     BCE + Dice), mini-batch 128 = 8 × 16, 3 steps; each through
     Pipeline + Trainer with the counters zeroed and read around it (K1
     steps × N_Sμ × launch groups, K2 resp. K4 steps × buckets), params
     finite, the steady step and images/s beside the fp32 bound from
     ``torch.utils.flop_counter``'s count; the peak of one step at three
     micro sizes, their affine fit and its extrapolation to the whole
     mini-batch without MBS, which must exceed the card's memory (if it
     does not, the mini-batch is doubled until it does); ``flat``
     against ``compiled`` after one step, cuDNN deterministic, within
     atol 1e-5 + rtol 1e-5; U-Net's IoU; K4 bit-identical to its plain
     version at the U-Net bucket; and which convolution op ``dots``'
     policy sees on CUDA (it must be one it saves);
  8. save/resume through the launcher at full width, 2 layers, ``flat``,
     checkpoints under ``build/ckpt`` (removed after): 4 steps
     uninterrupted twice, then 2 steps with ``--ckpt-every 2`` and
     ``--resume`` to step 4 — params, momentum and losses bit-identical
     to the uninterrupted run's when the two uninterrupted runs are, else
     within their own difference; the checkpoint's bytes and the save and
     restore seconds; the port's checkpoint restored into a plain (not
     flat) template with every CRC checked;
  9. each of K1–K4 at the main path's full bucket size: held against its
     plain version once more, then timed with CUDA events (the calls
     queued behind a sleep kernel, so the device's time is measured and
     not the host's launch overhead) beside its bound, its plain version
     and the PyTorch call that computes the same function, where there is
     one (K4's, ``torch._fused_adamw_``, first checked against K4's plain
     version on copies of the same inputs, within 1e-6 + 1e-5 (|old| +
     |new − old|): the same update with its roundings in another order);
     and K2–K4's ``GUARD`` variants at that size, flag 1 bit-identical and
     flag 0 writing nothing, timed in turns beside the unguarded kernel,
     flag 0 (a skipped step) under a quarter of the unguarded time;
  10. K1 at the main path's gradient leaves (one tensor a leaf, one fp32
     bucket), bit for bit, timed beside its bound, its plain version,
     ``torch._foreach_add_`` over the same pairs and ``add_`` on a flat
     pair; step ❹ as the copy-then-add design ran it (``FlatSpec.flatten``
     and K1 on the flat pair) against ``accumulate_flat``, and the bytes
     each allocates above its inputs;
  11. the kernel-API path (``repro_torch.kernels.flash_attention`` and
     ``.cross_entropy``, forward and backward) at full width: qwen2-1.5b
     attention and LM-head loss, a gemma2-9b layer (softcap 50, window
     4096) and a gemma3-12b local layer (window 1024), with the launch
     counters zeroed just before and read just after (one K6 launch per
     attention forward, all three by the wgmma kernel, one K5 launch per
     loss forward, none in a backward); outputs and gradients held
     against autograd through the plain versions, then each case timed
     beside its bound, the bf16 design's own floor (the bound × 1.5: PV
     runs twice), its plain version and the PyTorch call that computes it
     (SDPA; for gemma2's softcap, a compiled ``flex_attention``, checked
     against the plain version within the reference tests' bf16
     tolerance, 2e-2); then K6's fp32 kernel (``simt_fp32``) at the same
     three shapes on fp32 inputs: its output within 2e-5 of the plain
     version's, timed beside its bound (the kept pairs' FLOPs at 67
     TFLOP/s, the fp32 rate outside the tensor cores), the plain version
     and the same library calls on fp32 with TF32 off (each within 1e-4
     of the plain version first);
  12. the block tuner over the main path's bucket for K1 and K2
     (``engine.autotune.tune_for_params`` into
     ``build/tuning-blocks.json``): every candidate block's median ms,
     each bit-identical to the default block, then 2 main-path steps
     under the tuned resolver with the untuned run's losses;
  13c. the supervisor's guard (``guard_phase``): at full qwen2-1.5b
     through the main path's ``flat`` executor, guarded and unguarded
     steps timed in turns, their peaks within 0.1 GiB, the guarded step's
     synchronizing calls (``torch.cuda.set_sync_debug_mode``) none beyond
     the unguarded step's, and a step poisoned by ``faults.nan_at``
     leaving every buffer and the step counter ``torch.equal``; the
     supervised launcher with that NaN retried against the unfaulted
     run (phase 8's rule), at GUARD_SUPERVISED_LAYERS = 2 layers (cut
     for the run's time limit); then the four executors at 2 layers;
  13a. a real OOM at full width (``oom_ladder_phase``): the supervised
     launcher, ``flat``, mini-batch 16 in one micro-batch, remat
     ``none``, climbs the ladder on real ``torch.OutOfMemoryError``s;
     every fault record, the allocator's peaks at each failure and the
     bytes allocated after each rebuild (no more than the state and one
     batch); the final plan unsupervised against it; ``--max-restarts
     0`` exits 41;
  13b. a calibrated miss (``calibration_miss_phase``): ``streaming``
     under ``--calibrate auto`` with 7a's cache, its entry set back to
     the fit of 7a's probes at micro 1, 2 and 4 alone (the reference's
     loop, without the planner's back-off), at a budget where that fit
     admits a micro-batch whose real peak (the line through the
     backward-bound probes) exceeds it, the allocator capped there: one
     OOM, the negative bound in the cache file, the recovered
     plan under the cap, and a second plan that no longer admits what
     failed (injected with ``faults.oom_at`` if no budget provokes it).

  14a. serving full qwen2-1.5b (28 layers; fp32 weights, bf16 compute
     and cache) through ``repro_torch.launch.serve.main`` at a 10 GiB
     budget, max_len 2048, 64 Poisson requests at 32/s, prompts
     128/512/1024, 16 to 64 new tokens, greedy (``serve_phase``): the
     plan the reference's arithmetic gives (51 slots, prefill micro 8)
     and the memory model's largest fit, every request finished with its
     clamped token count, the pool all free; prefill latency, decode
     tokens/s, ITL, TTFT, peak concurrency, the allocator's peak beside
     the modeled peak and the budget, K1–K6 launched 0 times (as in the
     reference, serving reaches no kernel); one decode step's kernel
     launches and device span (``torch.profiler``) and its synchronizing
     calls (1: the next tokens' readback);
  14b. the same for full gemma2-9b (42 layers, window 4096, soft-caps
     50 / 30) at 64 GiB, max_len 8192, 8 requests at 4/s, prompts 1024
     and 4608, 8 to 32 new tokens (the 4608-token prompts wrap the local
     rings in prefill and in decode): 8 slots, prefill micro 4;
  14c. at 2 layers of each width, fp32, TF32 off
     (``serve_correctness_phase``): prefill + teacher-forced decode
     against ``forward`` (past gemma2's window), ragged against exact
     prefill row by row, and the engine's continuous batching against one
     request at a time, each within ``SERVE_ATOL`` on the logits, with the
     count of agreeing tokens;
  15a–15c. the ssm, hybrid and MoE families trained at full width
     through ``repro_torch.launch.train.main`` (``family_train_phase``:
     ``flat``, SGD-m, bf16 over fp32 weights, seed 0, 3 steps):
     mamba2-780m (d 1536, state 128, chunk 256; depth cut to 6 of its
     48 layers) at seq 4096,
     mini-batch 16; recurrentgemma-2b (26 layers, d 2560, vocab 256,000,
     window 2048) at seq 2048, mini-batch 8; moonshot-v1-16b-a3b (d 2048,
     64 experts top-6, 2 shared, vocab 163,840; depth cut to 4 of its 48
     layers) at seq 2048, mini-batch 8 — each: the analytic plan at 60
     GiB (not run), ``--calibrate force --remat-policy auto`` (the
     planner climbs past a policy whose probe does not fit the card —
     the tuning entries' records printed — and probes an admitted size
     it never probed, stepping down while its peak is over the budget),
     the least budget up to 72 GiB when the fit admits nothing at 60, then
     ``--calibrate auto`` with the counters zeroed around it: K1 steps ×
     N_Sμ × launch groups, K2 steps × buckets, the steady step and
     tokens/s, the allocator's peak beside the budget and the calibrated prediction;
     moonshot's step-0 aux loss and the share of routed choices the
     capacity dropped;
  15d. serving the three through ``launch.serve.main`` (``serve_phase``,
     as 14a): mamba2-780m at 10 GiB and recurrentgemma-2b at 24 GiB (max
     len 2048 / 4096; 14a's traffic), moonshot-v1-16b-a3b at 4 layers and
     32 GiB (16 requests at 8/s, prompts 128/512, 16 or 32 new tokens),
     all in exact-length prefill groups;
  15e. at 2 layers of each of the three widths (the hybrid at 3, one
     (recurrent, recurrent, local) period), fp32, TF32 off: 14c's checks
     (recurrentgemma's decode crossing its 2048 window; moonshot with a
     capacity factor of E, so no token drops and per-call routing cannot
     differ) and one ``flat`` step (K1, K2) against ``compiled``
     (``family_step_check``).

  16a. data parallelism through the launcher (``dp_main_path_phase``):
     ``torchrun --standalone --nproc_per_node 2 -m
     repro_torch.launch.train`` for qwen2-1.5b at full width, depth cut
     to DP_LAYERS = 2 layers (``flat``, bf16 over fp32, seq 1024, mini-batch 16 = 8 ×
     micro 2, local micro 1, 3 steps, ``--mesh 2:1``), both ranks on ``cuda:0`` over gloo, each capped at
     0.48 of the card (``launch.mesh.init_world``); the whole command is
     killed with its ranks past DP_TIMEOUT_S. Each rank's ``--report``:
     losses finite, the first near ln(vocab), equal on both ranks;
     exactly one all-reduce a step on each (the port's census), its
     seconds with the device synchronized around it and its share of the
     steady step; K1 steps × N_Sμ and K2 steps launches a rank; the peak
     beside the per-device estimate; the backend the launcher printed;
  16b. two ranks sharing the card in a ``launch.world.LocalWorld`` (run
     with phase 19's, after phase 20), full
     width at 2 layers, fp32, TF32 off (``dp_check_phase``): 2 steps of
     ``ShardedExecutor`` over ``flat``, ``fused``, ``compiled`` and
     ``streaming`` (its host-mini-batch ``step``) against one device's
     ``compiled`` on the same global mini-batches — params and momentum
     within phase 5's rtol / atol 1e-6, the ranks bit-identical, one
     all-reduce a step; ``defer_sync=False`` N_Sμ all-reduces a step; a
     NaN in rank 0's block alone leaves both ranks' state ``torch.equal``.
  16c. a fault on one rank agreed across the ranks
     (``fault_agreement_phase``): two ranks sharing the card in a
     ``LocalWorld``, full width at 2 layers, bf16 over fp32, the supervised
     ``ShardedExecutor`` over ``flat`` (mini-batch 16 = 2 × micro 8 at
     remat ``full``, so the rung down halves the micro-batch; 2 steps);
     first an OOM injected on rank 1 alone at step 1 (``oom_at(1,
     rank=1)``), then a real one: rank 1 holds a ballast sized from both
     plans' reserved
     peaks (measured first, one step each) so that the plan's step
     overflows its share of the card and the degraded one does not. In
     both: both ranks record the fault (naming rank 1) at the same step,
     degrade to the same plan, resume from the same step and end with the
     same state (sha256), in seconds — the process group would wait 300.

  17a. seamless-m4t-medium (encoder-decoder, 12 + 12 layers, d 1024,
     vocab 256,206) at full width (``family_train_phase`` with
     ``run_executor``: the launcher's ``LMDataset`` has no frames, so
     the ``flat`` executor is driven directly on
     ``launch.steps.family_batch``'s frames and target tokens): 4096
     frames, 1024 target tokens, mini-batch 4, SGD-m, bf16 over fp32, 3
     steps, calibrated as 15a–15c (a probe OOM climbs the lattice, the
     least budget up to 72 GiB): losses finite, the first near
     ln(vocab), K1 steps × N_Sμ × launch groups and K2 steps × buckets,
     the steady step and target tokens/s, the peak beside the budget
     and the calibrated prediction, one traced micro-batch;
  17b. qwen2-vl-72b at full width, depth cut to 1 of its 80 layers,
     through ``launch.train.main`` text-only as the reference's launcher
     feeds it (seq 1024, mini-batch 8, calibrated as 15a–15c); then
     (``vlm_step_phase``) the full VLM batch — 256 patch embeddings of
     width 1280 and M-RoPE streams that differ — whose logits must
     differ from plain RoPE's and equal them when the streams are
     equal, and one ``flat`` step on it with the streams split
     (N_Sμ, 3, N_μ, S);
  17c. 2 layers of each width (the enc-dec 2 + 2), fp32, TF32 off:
     ``flat``, ``fused`` and ``streaming`` against ``compiled`` after 2
     steps within phase 5's rtol / atol 1e-6 (``family_steps_check``);
     enc-dec ``decode_step`` against ``forward`` for 8 teacher-forced
     tokens within 1e-4 (``encdec_decode_check``); the VLM served
     text-only as 14c checks (``serve_correctness_phase``).

  18a. the step builders at the reference's assigned shapes
     (``steps_train_phase``): ``launch.steps.build_step(qwen2-1.5b full
     width, depth cut to STEPS_TRAIN_LAYERS = 2 layers, SHAPES["train_4k"],
     num_microbatches=None, executor="flat",
     remat_policy="auto", calibrate="force")`` at 60 GiB, bf16 over fp32,
     SGD-m; the bundle's ``fn`` runs one step over the whole 256 × 4096
     mini-batch: the plan, probes and fit, the loss finite and near
     ln(vocab), K1 N_Sμ × launch groups and K2 once a bucket, the split
     equal to the bundle's abstract batch, the first step's seconds and
     tokens/s, the peak at or under the budget beside the calibrated
     prediction, ``max_minibatch_without_mbs`` (analytic and calibrated)
     below 256;
  18b / 18c. (``steps_serve_phase``) decode at ``long_500k`` over a full
     seeded 524,288-entry ring (14.0 GiB bf16); per device of the
     reference's 16 × 16 mesh, prefill at ``prefill_32k`` (batch 2) and
     decode at ``decode_32k`` (batch 8, a full 7.0 GiB cache): ms a step
     and a token, seconds, finite logits, each peak;
  18d. (``steps_check_phase``) 2 layers, fp32: the train bundle's step
     bit-identical to the executor built by hand, the prefill / decode
     bundles to ``transformer.prefill`` / ``decode_step``; at full width
     the abstract params, optimizer state and cache trees equal the real
     ones in paths, shapes and dtypes.

  Phases 16b, 16c, 19, 21 and 22 run in two ``LocalWorld``s
  (``world_phases``, after phase 20), each started once: two ranks for
  16b, 16c, 19a and 19c's two-rank cells, four for 19b, 19c's four-rank
  cells, 21a / 21b, 22a and 22b.
  19a. pipeline parallelism through the launcher (``pp_launcher_phase``):
     ``repro_torch.launch.train.main`` on both ranks of the world with
     ``--arch qwen2-1.5b --mesh 1:2 --dtype bfloat16 --seq 1024
     --mini-batch 16 --microbatches 8 --steps 3``: full width at
     PP_LAYERS = 2 of 28 layers (cut for the run's time limit), 1 a
     stage, SGD-m, both ranks on ``cuda:0`` over gloo, each capped at
     0.48 of the card. Each rank's ``--report``: losses
     finite, the first near ln(vocab), equal on both ranks; the census of
     the schedule's closed form (``engine.p2p_counts``: 8 sends and 8
     receives a step in each direction a stage has), one (data+model)
     all-reduce a step and no data-axis one (one rank on that axis); the
     steady step and tokens/s; the all-reduces' seconds with the device
     synchronized around each; the peak beside
     ``memory_model.estimate(..., pipeline=True)``; K1–K6 launched 0
     times (the reference's pipelined path runs no kernel);
  19b. the same with ``--mesh 2:2 --fsdp``: four ranks, each capped at
     0.24 of the card, PP_LAYERS layers (each rank's peak fits its share); the
     census adds one model-axis and two data-axis all-reduces a step and
     as many all-gathers as reduce-scatters, equal on every rank;
  19c. (``pp_check_cells``) the worlds of 2 and 4 ranks on the card,
     4 layers of full width, seq 128, fp32, TF32 off: (stages, dp) ∈ {(2, 1),
     (2, 2), (4, 1)} and FSDP at (2, 2), 2 steps of the
     ``PipelinedExecutor`` against one device's ``compiled`` on the same
     global mini-batches — params and momentum within phase 5's rtol /
     atol 1e-6, shared leaves bit-identical across the ranks.

  20a. the engine contract checker (``repro_torch.analysis``) on the card
     (``analysis_phase``): the suite over reduced qwen2-1.5b × {compiled,
     streaming, fused, flat} and ResNet-50 × flat, and the serve suite
     over qwen2-1.5b and mamba2-780m, each step recorded with the card's
     synchronizing calls counted (JX003), HLO003 / SRV002 reading
     ``max_memory_allocated``, the launch counters zeroed around them:
     zero findings, K1 and K2 launched; the port's tree lint-clean;
  20b. seeded faults on the card: ``fused`` accumulating in bf16 under an
     fp32 contract fires JX001, an undonated KV pool SRV001;
  20c. (``dryrun_phase``) the dry run (``launch.dryrun``) of 18a's step —
     full width at 18a's depth, planned from 18a's tuning cache — on fake
     CUDA tensors, allocating nothing: the plan 18a's, the predicted peak
     beside 18a's allocator peak and calibrated prediction, the FLOPs a
     step and 18a's TFLOP/s from them against the bf16 peak.
  21a. (``gspmd_train_phase``) the GSPMD mesh: the world of four
     ranks sharing the card over gloo (each capped at 0.24 of it) on a
     2 × 2 (data × model) mesh, qwen2-1.5b at full width and
     GSPMD_LAYERS = 2 of 28 layers (cut for the run's time limit), bf16,
     seq 1024, mini-batch 16 in 2 micro-batches, SGD-m, through
     ``launch.steps.build_train_step(mesh=gspmd_mesh(...), executor=
     "flat")``: every rank's losses finite and equal, the first near
     ln(vocab); its parameter blocks the spec arithmetic; K1 steps × N_Smu
     × buckets and K2 steps × buckets on every rank's blocks; the steady
     step and tokens/s (GSPMD_STEPS = 2 steps: a warm-up, then the steady
     one); the collectives of the second step by kind and axis; each
     rank's peak beside ``estimate(mesh=, fsdp_params=True)``;
  21b. the same mesh at 2 layers, fp32, TF32 off: 2 steps within phase
     5's rtol / atol 1e-6 of one device's ``compiled``; then 21a's and
     21b's twins in the same world with the params replicated over
     ``data`` (``fsdp=False``, the reference's ``--no-fsdp``): the same
     checks against ``param_specs(fsdp=False)``'s arithmetic and
     ``estimate(fsdp_params=False)``, the census all-reducing over
     ``data`` with no weight gathered there, and the first loss the FSDP
     step's;
  21c. (``gspmd_dryrun_phase``) 18a's step dry-run as rank 0 of the
     16 × 16 production mesh (a fake world of 256, fake CUDA tensors):
     the rank's parameter blocks (the spec arithmetic), peak, FLOPs and
     collectives; then with ``fsdp=False``: its parameter bytes
     ``param_specs(fsdp=False)``'s arithmetic, an all-reduce over
     ``data`` and no weight gathered there.
  22a. (``gspmd_supervised_phase``) ``--supervise`` on the GSPMD world:
     ``engine.Supervisor`` over ``GspmdExecutor(guard=True)`` at 21b's
     size for SUP_STEPS = 4 steps, a NaN in one data block at step 1
     (retried clean; the state bit-identical across the NaN step) and an
     out-of-memory error raised on rank 1 alone inside its forward at
     step 2 (``attention.attn_block`` wrapped there), agreed by every
     rank over groups started anew: equal records, losses and final
     state on every rank, the run on the degraded plan, K1 and K2's
     ``GUARD`` variant launched on every rank;
  22b. (``serve_world_phase``) the serve launcher on the same four ranks
     (its groups the re-formed ones) at 14a's traffic: a data-parallel
     plan, every request finished on one rank, the gathered report on
     every rank, each rank's allocator peak beside the modeled per-device
     peak and the budget, no kernel launched;
  21d. (``gspmd_serve_dryrun_phase``) ``prefill_32k`` and ``decode_32k``
     of full-width qwen2-1.5b at 18a's depth (STEPS_TRAIN_LAYERS) dry-run
     as rank 0 of the 16 × 16 production mesh (fake CUDA tensors, nothing
     allocated on the card): the params placed by ``param_specs``, the
     cache and tokens by ``cache_specs``; the rank's peak, FLOPs, census,
     parameter and cache blocks, and a decode step's collectives under
     one block of one layer's ring (the ring is never gathered);
  22c. (``gspmd_serve_phase``) on the four ranks of 21 (2 × 2), a GSPMD
     prefill of SERVE_PROMPTS prompts × SERVE_PROMPT_LEN tokens into a
     cache of SERVE_MAX_LEN, then SERVE_DECODE_STEPS decode steps, of
     full-width qwen2-1.5b at GSPMD_LAYERS layers in bf16: the logits of
     every step and the gathered ring within SERVE_BF16_RTOL of one
     device's ``prefill`` / ``decode_step`` on the same weights and
     tokens (rank 0 computes it), the ring's positions and the greedy
     tokens equal; the
     collectives of a decode step by kind and axis, seconds a decode step
     (the steps after the first), each rank's allocator peak; no kernel
     launched.

  23. (``examples_phase``) the port's twins of the reference's
     ``examples/`` (``repro_torch.examples``) in this process on the
     card: ``quickstart``, ``serve_decode``, ``train_classifier`` and
     ``train_segmentation`` at their defaults (each returns, its last
     loss finite); ``train_100m --full --executor flat`` at full width
     (12 × 768, vocab 32,768, seq 512, mini-batch 32) against
     EXAMPLE_BUDGET_GB, whose plan streams the mini-batch in N_Smu >= 2
     micro-batches (K1 and K2), for EXAMPLE_STEPS steps, then a second
     call that restores its checkpoint and runs 2 steps more: the plan, the
     allocator's peak at or under the budget beside the plan's estimate,
     the steady step and tokens/s, the last logged loss below the first,
     K1 and K2 launched steps × N_Smu × launch groups and steps × buckets.

Each phase's seconds are printed as it ends, and all of them with the
total before the last lines. Before the last lines come
``{"runtime": {...}}`` (phases 6–8's, 7a's, 7b's, 12's, 13's, 14's,
15's, 16's, 17's, 18's, 19's, 20's, 21's, 22's and 23's numbers)
and ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # the script's own clock, imports included

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SLEEP_CYCLES = 50_000_000  # ~27 ms at 1.83 GHz: the host queues the calls
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
RAGGED_SIZES = [1, 1000, 4097, (1 << 20) + 3]
CHUNK = 1 << 27  # elements per slice when the plain version runs in slices
GIB = 1024 ** 3
# streaming's peak against flat's plus the tree update's excess over it
STREAMING_PEAK_SLACK = 0.25 * GIB
# the calibrated qwen2-1.5b plans: budget, and the micro sizes probed
CALIBRATION_BUDGET_GB = 60
MAIN_ARGV = ["--arch", "qwen2-1.5b", "--executor", "flat",
             "--dtype", "bfloat16", "--seq", "1024", "--mini-batch", "16",
             "--microbatches", "4", "--steps", "3", "--log-every", "1"]

# torch._fused_adamw_ against K4's plain version: the same update, its
# roundings in another order, so each new value within 1e-6 plus 1e-5 of
# the magnitudes it sums, |old| + |new - old| (a large step onto a small
# result cancels: on the card the two were 3.8e-6 apart at the bucket)
ADAMW_ATOL, ADAMW_RTOL = 1e-6, 1e-5

# per kernel: route, source, the Pallas kernel it replaces, bytes and flops
# moved per fp32 element (each input read once, each output written once)
KERNELS = {
    "grad_accum": ("cuda", "src/repro_torch/kernels/csrc/grad_accum.cu",
                   "src/repro/kernels/grad_accum.py:110", 12, 2),
    "fused_sgd_mom": ("triton", "src/repro_torch/kernels/fused_update.py",
                      "src/repro/kernels/fused_update.py:53", 20, 7),
    "fused_sgd": ("triton", "src/repro_torch/kernels/fused_update.py",
                  "src/repro/kernels/fused_update.py:67", 12, 5),
    "fused_adam": ("triton", "src/repro_torch/kernels/fused_update.py",
                   "src/repro/kernels/fused_update.py:121", 28, 17),
}
# the port's CUDA C++ sources (kernels/csrc/<name>.cu), built side by side
CUDA_LIBRARIES = ("grad_accum", "flash_attention")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparison and timing
# ---------------------------------------------------------------------------

def max_violation(got, want, atol: float = 1e-6, rtol: float = 1e-6,
                  bf16_atol: float = 0.0) -> tuple:
    """(max abs error, whether every element is within tolerance):
    |a-b| <= atol + rtol|b| in fp32 (1e-6 + 1e-6|b| by default), one ulp
    (plus ``bf16_atol``) in bf16."""
    import torch
    a, b = got.float(), want.float()
    err = (a - b).abs()
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(a.abs(), b.abs())
        _, exp = torch.frexp(mag)
        ulp = torch.ldexp(torch.ones_like(mag), exp - 8)
        ulp = torch.clamp(ulp, min=2.0 ** -133)
        ok = bool(torch.all(err <= ulp + bf16_atol))
    else:
        ok = bool(torch.all(err <= atol + rtol * b.abs()))
    return float(err.max()) if err.numel() else 0.0, ok


def event_ms(fn, reps: int) -> float:
    """Device time of one call: CUDA events around ``reps`` calls queued
    behind a sleep kernel, so that a call shorter than the host's launch
    overhead is timed on the device and not on the host."""
    import torch
    fn()  # warm-up (and first-use compile)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns_ms(fns: dict, reps: int) -> dict:
    """:func:`event_ms` of each of ``fns`` (name → callable), taken in
    turns A B … B A, so that a drift of the card's clock or memory during
    the phase falls on all alike; name → [first turn, second turn]."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(event_ms(fns[name], reps))
    return times


# ---------------------------------------------------------------------------
# kernel cases: each builds inputs, runs the wrapper in place and the plain
# version on copies, and returns the buffers to compare
# ---------------------------------------------------------------------------

def _kernel_cases(n, dev, gen):
    """(kernel name, label, run) triples at ``n`` elements; ``run()``
    returns [(kernel output, plain output), ...]."""
    import torch
    from repro_torch import kernels
    ref = kernels.ref

    def rnd(dtype=torch.float32, positive=False):
        x = torch.randn(n, generator=gen, device=dev)
        return (x.abs() if positive else x).to(dtype)

    def sc(*vals):
        return [torch.tensor(v, dtype=torch.float32, device=dev)
                for v in vals]

    cases = []
    for gdt in (torch.float32, torch.bfloat16):
        def k1(gdt=gdt):
            acc, g = rnd(), rnd(gdt)
            s = torch.full((1,), 1.0 / 3.0, device=dev)
            want = ref.grad_accum_ref(acc, g, s)
            kernels.grad_accum(acc, g, s)
            return [(acc, want)]
        cases.append(("grad_accum", f"acc fp32 grad {gdt}", k1))
    for dt in (torch.float32, torch.bfloat16):
        for nesterov, wd, clip in ((False, 5e-4, 1.0), (True, 1e-2, 0.5)):
            def k2(dt=dt, nesterov=nesterov, wd=wd, clip=clip):
                p, g, m = rnd(dt), rnd(), rnd(dt)
                lr, cl = sc(0.05, clip)
                wp, wm = ref.fused_sgd_ref(p, g, m, lr, cl, momentum=0.9,
                                           weight_decay=wd,
                                           nesterov=nesterov)
                kernels.fused_sgd(p, g, m, lr, cl, momentum=0.9,
                                  weight_decay=wd, nesterov=nesterov)
                return [(p, wp), (m, wm)]
            cases.append(("fused_sgd_mom",
                          f"{dt} nesterov={nesterov} wd={wd} clip={clip}",
                          k2))
        for wd in (0.0, 5e-4):
            def k3(dt=dt, wd=wd):
                p, g = rnd(dt), rnd()
                lr, cl = sc(0.1, 0.7)
                wp, _ = ref.fused_sgd_ref(p, g, None, lr, cl,
                                          weight_decay=wd)
                kernels.fused_sgd(p, g, None, lr, cl, weight_decay=wd)
                return [(p, wp)]
            cases.append(("fused_sgd", f"{dt} wd={wd}", k3))
        for wd, decoupled, clip in ((0.0, False, 1.0), (1e-2, False, 0.7),
                                    (1e-2, True, 0.7)):
            def k4(dt=dt, wd=wd, decoupled=decoupled, clip=clip):
                p, g, m, v = rnd(dt), rnd(), rnd(dt), rnd(dt, positive=True)
                lr, cl, bc1, bc2 = sc(1e-3, clip, 1 - 0.9 ** 3,
                                      1 - 0.999 ** 3)
                want = ref.fused_adam_ref(p, g, m, v, lr, bc1, bc2, cl,
                                          weight_decay=wd,
                                          decoupled=decoupled)
                kernels.fused_adam(p, g, m, v, lr, bc1, bc2, cl,
                                   weight_decay=wd, decoupled=decoupled)
                return list(zip((p, m, v), want))
            cases.append(("fused_adam",
                          f"{dt} wd={wd} decoupled={decoupled} clip={clip}",
                          k4))
    return cases


def _k1_list_cases(dev, gen):
    """K1's lists of pairs: (label, accumulator dtype, accumulator offsets
    into one buffer, sizes, gradient dtype, gradient offsets into one
    buffer or None for separate gradient tensors)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    odd = [1, 8192 + 3, 2 * 8192 + 5]  # 4, 12 and 20 bytes past 16 in fp32
    aligned = [0, 8192, 2 * 8192]
    ragged = [1000, 4097, 8000]
    many = torch.randint(1, 5001, (300,), generator=gen,
                         device=dev).tolist()
    packed = [sum(many[:i]) for i in range(len(many))]  # a bucket's slots
    cases = []
    for gdt in (f32, bf16):
        cases += [
            (f"acc views at offsets 1, 3, 5, grad {gdt}", f32, odd, ragged,
             gdt, None),
            (f"grad {gdt} views at offsets 1, 3, 5", f32, aligned, ragged,
             gdt, odd),
            (f"acc bf16, grad {gdt}", bf16, aligned, ragged, gdt, None),
            (f"acc bf16 views at offsets 1, 3, 5, grad {gdt}", bf16, odd,
             ragged, gdt, None),
            (f"an empty leaf, grad {gdt}", f32, [0, 4096, 4096],
             [4096, 0, (1 << 20) + 3], gdt, None),
            (f"{len(many)} leaves of 1-5000 elements packed as a bucket, "
             f"grad {gdt}", f32, packed, many, gdt, None),
        ]
    return cases


def k1_list_phase(dev, errs) -> int:
    """K1 over lists of pairs (unaligned views, bf16, an empty leaf, more
    pairs than a launch takes), each bit-identical to the plain version
    pair by pair, the rest of the buffer untouched, and one launch per
    group. Returns the number of cases."""
    import torch
    from repro_torch import kernels
    ga, ref = kernels.grad_accum_kernels, kernels.ref
    gen = torch.Generator(device=dev).manual_seed(4)
    s = torch.full((1,), 1.0 / 3.0, device=dev)
    cases = _k1_list_cases(dev, gen)
    for label, adt, aoffs, sizes, gdt, goffs in cases:
        abuf = torch.randn(max(o + n for o, n in zip(aoffs, sizes)) + 3,
                           generator=gen, device=dev).to(adt)
        accs = [abuf[o:o + n] for o, n in zip(aoffs, sizes)]
        if goffs is None:
            grads = [torch.randn(n, generator=gen, device=dev).to(gdt)
                     for n in sizes]
        else:
            gbuf = torch.randn(max(o + n for o, n in zip(goffs, sizes)),
                               generator=gen, device=dev).to(gdt)
            grads = [gbuf[o:o + n] for o, n in zip(goffs, sizes)]
        want = abuf.clone()
        for o, n, g in zip(aoffs, sizes, grads):
            want[o:o + n] = ref.grad_accum_ref(want[o:o + n], g, s)
        before = kernels.launch_counts()["grad_accum"]
        ga.grad_accum_many(accs, grads, s)
        torch.cuda.synchronize()  # a fault shows here, where it happened
        took = kernels.launch_counts()["grad_accum"] - before
        groups = len(ga.launch_groups(list(zip(accs, grads))))
        err, _ = max_violation(abuf, want)
        errs["grad_accum"] = max(errs["grad_accum"], err)
        check(torch.equal(abuf, want),
              f"K1 [{label}] is not bit-identical to its plain version: max "
              f"abs err {err:.3e}")
        check(took == groups, f"K1 [{label}] took {took} launches, expected "
                              f"{groups}")
    return len(cases)


def kernel_phase(dev, errs) -> None:
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    for n in RAGGED_SIZES:
        for name, label, run in _kernel_cases(n, dev, gen):
            for got, want in run():
                err, ok = max_violation(got, want)
                errs[name] = max(errs[name], err)
                check(ok, f"{name} [{label}, n={n}] disagrees with its "
                          f"plain version: max abs err {err:.3e}")
                if name == "grad_accum":
                    check(torch.equal(got, want),
                          f"K1 [{label}, n={n}] is not bit-identical to its "
                          f"plain version")
    n_lists = k1_list_phase(dev, errs)
    torch.cuda.synchronize()
    print(f"kernels: K1-K4 match their plain versions at n={RAGGED_SIZES} "
          f"in fp32 and bf16, K1 bit for bit, and in {n_lists} lists of "
          f"pairs ({time.perf_counter() - t0:.1f}s incl. Triton builds)",
          flush=True)


# ---------------------------------------------------------------------------
# cross-check: flat and fused against compiled at full width, 2 layers
# ---------------------------------------------------------------------------

def executor_steps(dev, cfg, dtype, names) -> dict:
    """One step of each named executor from seed 0's params on one batch
    (seq 256, mini-batch 8 in 4 micro-batches, remat ``none``): name →
    (params, momentum, loss, launch counts of the step)."""
    import torch
    from repro_torch import engine, kernels, optim
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    plan = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                           device=dev)
    loss_fn = steps.make_loss_fn(cfg, dtype=dtype, remat_policy="none")
    batch = LMDataset(cfg.vocab_size, 256, seed=0).batch(8, 0)
    outs = {}
    for name in names:
        opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
        ex = engine.get_executor(name)(loss_fn, opt, plan)
        params = transformer.init_params(cfg, seed=0, device=dev)
        state = opt.init(params)
        if name == "flat":
            params, state = ex.prepare(params, state)
        kernels.reset_launch_counts()
        params, state, m = ex.step_split(params, state,
                                         plan.device_split(batch, dev))
        outs[name] = (params, state["mom"], float(m["loss"]),
                      kernels.launch_counts())
        del params, state
    torch.cuda.empty_cache()
    return outs


def against_compiled(outs, label: str) -> dict:
    """Each executor's params and momentum against ``compiled``'s within
    rtol 1e-6 / atol 1e-6, its loss within 1e-5 relative: name → the
    largest absolute difference."""
    from repro_torch import tree

    cp, cm, closs, _ = outs["compiled"]
    check(math.isfinite(closs), f"{label}: compiled loss {closs}")
    worst = {}
    for name, (fp, fm, floss, _) in outs.items():
        if name == "compiled":
            continue
        worst[name] = 0.0
        for what, a, b in (("params", fp, cp), ("momentum", fm, cm)):
            for x, y in zip(tree.leaves(a), tree.leaves(b)):
                err, ok = max_violation(x, y)
                worst[name] = max(worst[name], err)
                check(ok, f"{label}: {name} vs compiled {what} disagree: "
                          f"max abs err {err:.3e} (rtol 1e-6, atol 1e-6)")
        check(abs(closs - floss) <= 1e-5 * abs(closs),
              f"{label}: {name} loss {floss} vs compiled loss {closs}")
    return worst


def cross_check_phase(dev) -> None:
    import torch
    from repro_torch import configs, engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=2)
    names = ("compiled", "flat", "fused", "streaming")
    outs = executor_steps(dev, cfg, torch.bfloat16, names)
    for name in names:
        # fused: one K1 launch per micro-batch and gradient dtype (all
        # fp32 here); flat: one per micro-batch and bucket (one here);
        # compiled and streaming add with a plain add
        k1 = outs[name][3]["grad_accum"]
        want = 0 if name in ("compiled", "streaming") else 4
        check(k1 == want, f"{name}: K1 launched {k1} times in one step, "
                          f"expected {want}")
    worst = against_compiled(outs, "cross-check")
    for name, err in worst.items():
        print(f"cross-check: {name} == compiled after one step at qwen2-1.5b "
              f"width, 2 layers, bf16 (loss {outs[name][2]:.6f}, max abs "
              f"err {err:.3e})", flush=True)
    del outs
    plan = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                           device=dev)
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.bfloat16,
                                 remat_policy="none")
    batch = LMDataset(cfg.vocab_size, 256, seed=0).batch(8, 0)
    # streaming.step on the host mini-batch (micro-batches copied on the
    # executor's copy stream) against step_split on the staged split
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    ex = engine.StreamingExecutor(loss_fn, opt, plan)
    params = transformer.init_params(cfg, seed=0, device=dev)
    state = opt.init(params)
    got = ex.step(params, state, dict(batch))
    want = ex.step_split(params, state, plan.device_split(batch, dev))
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(got[:2]), tree.leaves(want[:2])))
    check(same, "streaming.step on the host mini-batch is not bit-identical "
                "to streaming.step_split on the staged split")
    print(f"cross-check: streaming.step(host mini-batch) == "
          f"streaming.step_split(staged split) bit for bit (params and "
          f"momentum, {len(tree.leaves(got[:2]))} tensors; loss "
          f"{float(got[2]['loss']):.6f})", flush=True)
    del got, want, params, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def main_argv(*extra, **flags) -> list:
    """MAIN_ARGV with the values of ``flags`` replaced (``executor=
    "streaming"`` sets ``--executor streaming``) and ``extra`` appended."""
    argv = list(MAIN_ARGV)
    for key, value in flags.items():
        i = argv.index("--" + key.replace("_", "-"))
        argv[i + 1] = str(value)
    return argv + list(extra)


def run_launcher(dev, argv, watch_initial: bool = False) -> dict:
    """``repro_torch.launch.train.main(argv)`` with the launch counters and
    the peak-memory statistics reset just before it and read just after:
    every loss finite, the first near ln(vocab) for a random model.

    The Trainer reads step i back after step i+1 is queued, so readback i
    (i = 1..n-2) follows one more step's dispatch than readback i-1, and
    their gap is one step's period whichever of the host and the card is
    the slower. The last readback follows no dispatch: its gap is only
    the card's tail behind the host, and is reported apart. The steady
    step is the mean of the other gaps (one at 3 steps).

    ``watch_initial``: weak references to the params and momentum leaves
    the first step receives; ``res["initial_alive"]`` is how many of them
    are still alive when the second step starts (the launcher must keep
    none of them)."""
    import gc
    import weakref
    import torch
    from repro_torch import engine, kernels, tree
    from repro_torch.launch import train

    copied = kernels.grad_accum_kernels.COPIED_BYTES
    watch = {"calls": 0, "refs": [], "alive": None}
    real_init = engine.Trainer.__init__

    def init(self, step_fn, pipeline, **kw):
        def step(params, opt_state, batch):
            if watch["calls"] == 0:
                watch["refs"] = [weakref.ref(t) for t in tree.leaves(
                    (params, opt_state["mom"]))]
            elif watch["calls"] == 1:
                watch["alive"] = sum(r() is not None for r in watch["refs"])
            watch["calls"] += 1
            return step_fn(params, opt_state, batch)
        real_init(self, step, pipeline, **kw)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    copied["grad_accum"] = 0
    if watch_initial:
        engine.Trainer.__init__ = init
    t0 = time.perf_counter()
    try:
        res = train.main(argv)
    finally:
        engine.Trainer.__init__ = real_init
    wall = time.perf_counter() - t0
    if watch_initial:
        res["initial_alive"] = watch["alive"]
        res["initial_leaves"] = len(watch["refs"])
    res["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
    res["counts"] = kernels.launch_counts()
    res["grad_copy_bytes"] = copied["grad_accum"]
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["allocated_before_bytes"] = base
    res["wall_s"] = wall
    cfg, hist = res["config"], res["history"]
    losses = [h["loss"] for h in hist]
    res["losses"] = losses
    check(bool(hist) and all(math.isfinite(x) for x in losses),
          f"{argv}: losses not finite: {losses}")
    if hist[0]["step"] == 0:
        check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
              f"first loss {losses[0]:.4f} is far from ln(vocab) "
              f"{math.log(cfg.vocab_size):.4f} for a random model")
    clocks = [h["readback_s"] for h in hist]
    gaps = [b - a for a, b in zip(clocks, clocks[1:])]
    res["readback_gaps_s"] = gaps
    steady = gaps[:-1]
    res["steady_step_s"] = (sum(steady) / len(steady) if steady
                            else float("nan"))
    return res


def _estimate(cfg, plan, fused: bool) -> int:
    from repro_torch import optim
    from repro_torch.core import memory_model
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    return memory_model.estimate(
        cfg, 1024, act_bytes=2, remat_policy=plan.remat_policy,
        **optim.memory_model_kw(opt, fused=fused)).total(
        plan.micro_batch_size)


def main_path_phase(dev) -> dict:
    import torch
    from repro_torch.engine import FlatSpec

    res = run_launcher(dev, MAIN_ARGV)
    counts, peak = res["counts"], res["peak_bytes"]
    plan, cfg, hist = res["plan"], res["config"], res["history"]
    spec = FlatSpec.for_tree(res["params"])
    n_steps, n_b = len(hist), spec.num_buckets
    check(n_steps == 3, f"main path ran {n_steps} steps, expected 3")
    for buf in spec.buffers_of(res["params"]):
        check(bool(torch.isfinite(buf).all()), "params not finite")
    want_k1 = n_steps * plan.num_micro_batches * n_b
    check(counts["grad_accum"] == want_k1,
          f"K1 launched {counts['grad_accum']} times, expected {want_k1}")
    check(counts["fused_sgd_mom"] == n_steps * n_b,
          f"K2 launched {counts['fused_sgd_mom']} times, expected "
          f"{n_steps * n_b}")
    est = _estimate(cfg, plan, fused=True)
    step_s = res["steady_step_s"]
    tokens = plan.mini_batch_size * 1024
    iwf = res["pipeline"].input_wait_fraction
    print(f"main path: {plan.describe()}", flush=True)
    print(f"main path (Pipeline + Trainer): losses {res['losses']}; gaps "
          f"between metric readbacks {res['readback_gaps_s']} s (the last "
          f"follows no dispatch); steady step {step_s:.4f}s, "
          f"{tokens / step_s:.1f} tokens/s; input-wait fraction {iwf:.4f}; "
          f"wall {res['wall_s']:.1f}s incl. init", flush=True)
    print(f"main path: peak allocated {peak} B "
          f"({peak / 2 ** 30:.2f} GiB; {res['allocated_before_bytes']} B "
          f"allocated before the run) vs memory-model estimate {est} B "
          f"({est / 2 ** 30:.2f} GiB); buckets {spec.bucket_sizes} "
          f"{[str(d) for d in spec.bucket_dtypes]}; launches {counts}; "
          f"gradient bytes K1's wrapper copied to make leaves contiguous "
          f"{res['grad_copy_bytes']}", flush=True)
    check(n_b == 1, f"the main path has {n_b} buckets; the full-size phase "
                    f"measures one")
    out = {"counts": counts, "bucket_size": spec.bucket_sizes[0],
           "spec": spec, "grad_copy_bytes": res["grad_copy_bytes"],
           "peak_bytes": peak, "estimate_bytes": est, "steady_step_s": step_s,
           "allocated_before_bytes": res["allocated_before_bytes"],
           "readback_gaps_s": res["readback_gaps_s"], "losses": res["losses"],
           "input_wait_fraction": iwf, "tokens_per_s": tokens / step_s}
    del res
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the streaming executor at full depth, and save/resume
# ---------------------------------------------------------------------------

def _trace_streams(path: str) -> dict:
    """From a ``torch.profiler`` chrome trace of one step: the copies by
    (name, stream), the kernels by stream, the kernels' summed time (they
    run one at a time on the compute stream), the span from the first to
    the last device event, and the CUDA runtime calls with the most host
    time (where the host waited)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies, kernel_streams, runtime, by_name = {}, {}, {}, {}
    kernel_us, lo, hi = 0.0, math.inf, -math.inf
    for e in events:
        cat, stream = e.get("cat"), e.get("args", {}).get("stream")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            lo, hi = min(lo, e["ts"]), max(hi, e["ts"] + e.get("dur", 0))
        if cat == "gpu_memcpy":
            key = f"{e['name']} on stream {stream}"
            copies[key] = copies.get(key, 0) + 1
        elif cat == "kernel":
            kernel_streams[stream] = kernel_streams.get(stream, 0) + 1
            kernel_us += e.get("dur", 0)
            n, us = by_name.get(e["name"][:90], (0, 0.0))
            by_name[e["name"][:90]] = (n + 1, us + e.get("dur", 0))
        elif cat == "cuda_runtime":
            n, us = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, us + e.get("dur", 0))
    def top(d, k):
        return {name: [n, us / 1e3] for name, (n, us) in
                sorted(d.items(), key=lambda kv: -kv[1][1])[:k]}
    return {"copies": copies, "kernel_streams": kernel_streams,
            "kernel_ms": kernel_us / 1e3,
            "device_span_ms": (hi - lo) / 1e3 if hi > lo else 0.0,
            "runtime_ms": top(runtime, 6), "kernels_ms": top(by_name, 10)}


def streaming_phase(dev, main: dict) -> dict:
    """Full qwen2-1.5b through the launcher with ``--executor streaming``
    (Pipeline + Trainer; the launch counters zeroed just before and read
    just after): no initial param or momentum leaf alive once the first
    step is done (weak references), and the peak within 0.25 GiB of the
    main path's (``flat``) plus what the tree update's own peak, measured
    on the run's final state, adds above it. Then a ``torch.profiler``
    trace of one ``StreamingExecutor.step`` on a host mini-batch: its
    pinned host-to-device copies must run on a stream other than the
    compute kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.engine import exec_core
    from repro_torch.launch import steps

    flat_peak = main["peak_bytes"]
    flat_rel = flat_peak - main["allocated_before_bytes"]
    res = run_launcher(dev, main_argv(executor="streaming"),
                       watch_initial=True)
    check(res["initial_alive"] == 0,
          f"streaming: {res['initial_alive']} of {res['initial_leaves']} "
          f"initial param and momentum leaves are alive after the first "
          f"step: the launcher still holds the initial state")
    plan, cfg = res["plan"], res["config"]
    check(len(res["history"]) == 3,
          f"streaming ran {len(res['history'])} steps, expected 3")
    est = _estimate(cfg, plan, fused=False)
    tokens = plan.mini_batch_size * 1024
    iwf = res["pipeline"].input_wait_fraction
    print(f"streaming (Pipeline + Trainer, full depth): losses "
          f"{res['losses']}; gaps between metric readbacks "
          f"{res['readback_gaps_s']} s (the last follows no dispatch); "
          f"steady step "
          f"{res['steady_step_s']:.4f}s, "
          f"{tokens / res['steady_step_s']:.1f} tokens/s; input-wait "
          f"fraction {iwf:.4f}; launches {res['counts']}", flush=True)
    print(f"streaming: peak allocated {res['peak_bytes']} B "
          f"({res['peak_bytes'] / 2 ** 30:.2f} GiB; "
          f"{res['allocated_before_bytes']} B allocated before the run) vs "
          f"flat's {flat_peak} B "
          f"({flat_peak / 2 ** 30:.2f} GiB) and the memory model's "
          f"fused=False estimate {est} B ({est / 2 ** 30:.2f} GiB)",
          flush=True)
    out = {k: res[k] for k in ("losses", "readback_gaps_s", "steady_step_s",
                               "peak_bytes", "allocated_before_bytes",
                               "peak_reserved_bytes", "counts",
                               "initial_alive", "initial_leaves")}
    out.update(estimate_bytes=est, input_wait_fraction=iwf,
               tokens_per_s=tokens / res["steady_step_s"])

    params, state = res.pop("params"), res.pop("opt_state")
    base = res["allocated_before_bytes"]
    stream_rel = res["peak_bytes"] - base
    del res
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    # step 5's own peak: the tree update from the run's final params and
    # momentum and an accumulator, what a step holds when it starts it
    acc = tree.map(torch.zeros_like, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    upd = exec_core.apply_update(opt, acc, state, params)
    torch.cuda.synchronize()
    upd_rel = torch.cuda.max_memory_allocated(dev) - base
    del upd, acc
    transient = max(0, upd_rel - flat_rel)
    want = flat_rel + transient
    print(f"streaming: peak {stream_rel} B above what was allocated before "
          f"the run ({stream_rel / GIB:.2f} GiB) vs flat's {flat_rel} B "
          f"({flat_rel / GIB:.2f} GiB); the tree update's own peak from the "
          f"final state {upd_rel} B ({upd_rel / GIB:.2f} GiB), so its excess "
          f"over flat's {transient} B; initial leaves alive after the first "
          f"step: 0 of {out['initial_leaves']}", flush=True)
    check(abs(stream_rel - want) <= STREAMING_PEAK_SLACK,
          f"streaming's peak {stream_rel / GIB:.3f} GiB is not within 0.25 "
          f"GiB of flat's {flat_rel / GIB:.3f} plus the update's excess "
          f"{transient / GIB:.3f}")
    out.update(peak_above_base_bytes=stream_rel,
               flat_peak_above_base_bytes=flat_rel,
               update_peak_above_base_bytes=upd_rel,
               update_excess_bytes=transient)
    ex = engine.StreamingExecutor(steps.make_loss_fn(
        cfg, dtype=torch.bfloat16, remat_policy=plan.remat_policy), opt, plan)
    batch = LMDataset(cfg.vocab_size, 1024, seed=0).batch(
        plan.mini_batch_size, 3)
    params, state, _ = ex.step(params, state, dict(batch))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = ex.step(params, state, dict(batch))
        host_s = time.perf_counter() - t0  # the host's dispatch
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    check(math.isfinite(float(m["loss"])), f"traced step loss {m['loss']}")
    trace = os.path.join(ROOT, "build", "streaming_step_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    streams = _trace_streams(trace)
    os.remove(trace)
    kernel_streams = streams["kernel_streams"]
    check(bool(kernel_streams), "the profiler trace holds no kernel")
    compute = max(kernel_streams, key=kernel_streams.get)
    pinned = {k: n for k, n in streams["copies"].items()
              if "HtoD" in k and "Pinned" in k}
    # the mask once for N_B_valid, then tokens, labels and sample_weight
    # of each micro-batch
    want = 1 + (len(batch) + 1) * plan.num_micro_batches
    check(sum(pinned.values()) == want,
          f"the traced step made {sum(pinned.values())} pinned host-to-device "
          f"copies, expected {want}: {streams['copies']}")
    check(not any(k.endswith(f"on stream {compute}") for k in pinned),
          f"the staged copies ran on the compute stream {compute}: "
          f"{streams['copies']}")
    busy = streams["kernel_ms"] / (step_s * 1e3)
    print(f"streaming: one traced step(host mini-batch): copies "
          f"{streams['copies']}; kernels by stream {kernel_streams} "
          f"(compute stream {compute}); host dispatch {host_s:.4f}s, step "
          f"{step_s:.4f}s to the last synchronize, kernels "
          f"{streams['kernel_ms']:.1f} ms (busy {busy:.3f} of the step, "
          f"device events spanning {streams['device_span_ms']:.1f} ms); "
          f"CUDA runtime calls with the most host time "
          f"{streams['runtime_ms']} (count, ms)", flush=True)
    print(f"streaming: the traced step's kernels with the most time (count, "
          f"ms): {streams['kernels_ms']}", flush=True)
    out.update(trace_copies=streams["copies"],
               trace_kernel_streams=kernel_streams, compute_stream=compute,
               trace_host_dispatch_s=host_s, trace_step_s=step_s,
               trace_kernel_ms=streams["kernel_ms"],
               trace_device_span_ms=streams["device_span_ms"],
               trace_busy_share=busy, trace_runtime_ms=streams["runtime_ms"],
               trace_kernels_ms=streams["kernels_ms"])
    del params, state, m, ex
    torch.cuda.empty_cache()
    return out


def calibration_phase(dev) -> dict:
    """Calibrated admission at full qwen2-1.5b (seq 1024, mini-batch 16,
    no ``--microbatches``) for ``flat`` and ``streaming``, against a
    60 GiB budget (headroom for the caching allocator): the analytic
    plan's micro size and modeled bytes, and the corrected prediction for
    that size (not run); ``--calibrate force`` probes the real step at
    micro-batches 1, 2 and 4 into ``build/tuning.json`` (the fit and the
    probes printed); the launcher with ``--calibrate auto`` then reads
    that entry, must plan exactly what ``force`` planned, and trains 2
    steps, whose peak allocated bytes must stay within the budget. Also
    the plans the card's whole memory would get, analytic and calibrated
    (not run)."""
    import torch
    from repro_torch import engine, optim
    from repro_torch.core import memory_model
    from repro_torch.engine import autotune
    from repro_torch.launch import train

    cache = os.path.join(ROOT, "build", "tuning.json")
    if os.path.exists(cache):
        os.remove(cache)
    autotune._caches.pop(cache, None)
    budget = CALIBRATION_BUDGET_GB * GIB
    out = {"budget_bytes": budget}
    for executor in ("flat", "streaming"):
        argv = [a for a in main_argv(executor=executor, steps=2)]
        i = argv.index("--microbatches")
        del argv[i:i + 2]
        argv += ["--hbm-budget-gb", str(CALIBRATION_BUDGET_GB),
                 "--tuning-cache", cache]
        ap = train.build_parser()
        cfg = train.build_config(ap.parse_args(argv))
        seq = ap.parse_args(argv).seq
        opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
        mm_kw = optim.memory_model_kw(opt, fused=executor == "flat")

        def plan(calibrate, budget_gb=CALIBRATION_BUDGET_GB):
            args = ap.parse_args(argv + ["--calibrate", calibrate])
            args.hbm_budget_gb = budget_gb
            return train.build_plan(cfg, args, opt, dev)

        analytic = plan("off")
        est = memory_model.estimate(cfg, seq, act_bytes=2,
                                    remat_policy=analytic.remat_policy,
                                    **mm_kw)
        t0 = time.perf_counter()
        forced = plan("force")
        probe_s = time.perf_counter() - t0
        engine.set_cache_path(None)
        entry = autotune.get_cache(cache).data["memory"][autotune.memory_key(
            cfg, seq, forced.remat_policy, None, "sgd", executor,
            autotune.backend_of(dev))]
        a, b = forced.correction
        predicted = a * est.total(analytic.micro_batch_size) + b
        res = run_launcher(dev, argv + ["--calibrate", "auto"])
        engine.set_cache_path(None)
        got = res["plan"]
        check(forced.calibrated, f"{executor}: --calibrate force did not "
                                 f"calibrate: {forced.describe()}")
        check(got == forced, f"{executor}: --calibrate auto planned "
                             f"{got.describe()}, force {forced.describe()}")
        peak = res["peak_bytes"]
        check(len(res["history"]) == 2, f"{executor}: calibrated run took "
                                        f"{len(res['history'])} steps")
        check(peak <= budget,
              f"{executor}: the calibrated plan (micro "
              f"{got.micro_batch_size}) peaked at {peak / GIB:.3f} GiB, over "
              f"its {CALIBRATION_BUDGET_GB} GiB budget")
        whole = {c: plan(c, budget_gb=None) for c in ("off", "auto")}
        engine.set_cache_path(None)
        rec = {
            "analytic_micro": analytic.micro_batch_size,
            "analytic_policy": analytic.remat_policy,
            "analytic_modeled_bytes": est.total(analytic.micro_batch_size),
            "corrected_prediction_bytes": predicted,
            "fit": [a, b], "probes": entry["probes"], "probe_s": probe_s,
            "calibrated_micro": got.micro_batch_size,
            "calibrated_prediction_bytes": a * est.total(
                got.micro_batch_size) + b,
            "plan": got.describe(), "losses": res["losses"],
            "peak_bytes": peak,
            "peak_reserved_bytes": res["peak_reserved_bytes"],
            "allocated_before_bytes": res["allocated_before_bytes"],
            "whole_card_analytic_micro": whole["off"].micro_batch_size,
            "whole_card_calibrated_micro": whole["auto"].micro_batch_size,
            "whole_card_calibrated": whole["auto"].calibrated,
            "counts": res["counts"]}
        out[executor] = rec
        print(f"calibration ({executor}, budget {CALIBRATION_BUDGET_GB} "
              f"GiB): analytic plan micro {rec['analytic_micro']} (remat "
              f"{rec['analytic_policy']}), modeled {rec['analytic_modeled_bytes']}"
              f" B ({rec['analytic_modeled_bytes'] / GIB:.2f} GiB), corrected "
              f"prediction for it {predicted:.0f} B ({predicted / GIB:.2f} "
              f"GiB, not run); fit measured = {a:.6f} x modeled + {b:.0f} B "
              f"from probes (micro, modeled B, measured B) {entry['probes']} "
              f"in {probe_s:.1f}s", flush=True)
        print(f"calibration ({executor}): {got.describe()}; predicted "
              f"{rec['calibrated_prediction_bytes'] / GIB:.3f} GiB; 2 steps, "
              f"losses {res['losses']}, peak allocated {peak} B "
              f"({peak / GIB:.3f} GiB, {res['allocated_before_bytes']} B "
              f"before), peak reserved {res['peak_reserved_bytes']} B "
              f"({res['peak_reserved_bytes'] / GIB:.3f} GiB); the card's "
              f"whole memory would get micro {rec['whole_card_analytic_micro']}"
              f" analytic, {rec['whole_card_calibrated_micro']} calibrated "
              f"(not run)", flush=True)
        del res
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the paper's own workloads: ResNet-50 (Table 4) and U-Net (Table 5)
# ---------------------------------------------------------------------------

# name: (mini-batch, micro-batch, steps, micro sizes whose peaks are fit)
CNN_RUNS = {"resnet50": (1024, 128, 3, (32, 64, 128)),
            "unet": (128, 16, 3, (4, 8, 16))}
# flat against compiled after one step, cuDNN deterministic in both: the
# same gradients (the 1/N_Smu scale is a power of two either way), K2/K4
# against the tree update, which round alike
CNN_ATOL = CNN_RTOL = 1e-5


class _Batches:
    """A dataset's batches made ahead (set-up, not step time): the
    Pipeline asks for batch ``seed``, and gets the dataset's."""

    def __init__(self, ds, batch_size: int, seeds):
        self.batch_size = batch_size
        self.batches = {i: ds.batch(batch_size, i) for i in seeds}

    def batch(self, batch_size: int, seed: int):
        check(batch_size == self.batch_size, f"asked for {batch_size}")
        return self.batches[seed]


def _cnn_setup(which: str):
    from repro_torch import optim
    from repro_torch.configs import resnet50, unet
    from repro_torch.data import ClassificationDataset, SegmentationDataset
    if which == "resnet50":  # the paper's Table 4 setup (resnet50.py:1-2)
        cfg = resnet50.config()
        return cfg, (lambda: optim.sgd(0.01, momentum=0.9,
                                       weight_decay=5e-4)), \
            ClassificationDataset(cfg.num_classes, cfg.image_size, seed=0)
    cfg = unet.config()  # Table 5 (unet.py:1-2): Adam, BCE + Dice
    return cfg, (lambda: optim.adam(0.01, weight_decay=5e-4)), \
        SegmentationDataset(cfg.image_size, seed=0)


def _cnn_state(cfg, dev, make_opt):
    """({"params", "opt_state"} from seed 0, BN state, optimizer)."""
    from repro_torch.models import cnn
    params, bn_state = cnn.init(cfg, seed=0, device=dev)
    opt = make_opt()
    return {"params": params, "opt_state": opt.init(params)}, bn_state, opt


def _cnn_step_peak(dev, cfg, make_opt, ds, micro: int) -> int:
    """Peak bytes of one ``flat`` step over two micro-batches of ``micro``
    images, above what was allocated before its params were made."""
    import gc
    import torch
    from repro_torch import engine
    from repro_torch.models import cnn
    plan = engine.plan_mbs(2 * micro, micro_batch_size=micro, device=dev,
                           remat_policy="none")
    batch = ds.batch(2 * micro, 0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    st, bn_state, opt = _cnn_state(cfg, dev, make_opt)
    ex = engine.FlatFusedExecutor(
        cnn.make_loss_fn(cfg, bn_state, plan.remat_policy), opt, plan)
    params, opt_state = ex.prepare(st.pop("params"), st.pop("opt_state"))
    out = ex.step_split(params, opt_state, plan.device_split(batch, dev))
    del params, opt_state
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del out
    return int(peak)


def _train_flops(cfg) -> tuple:
    """(forward, forward + backward) FLOPs of one image, counted by
    ``torch.utils.flop_counter`` over the port's model on meta tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import tree
    from repro_torch.models import cnn
    params, state = cnn.init(cfg, seed=0, device="cpu")
    params = tree.map(lambda t: t.to("meta").requires_grad_(), params)
    state = tree.map(lambda t: t.to("meta"), state)
    x = torch.empty(1, cfg.image_size, cfg.image_size, cfg.in_channels,
                    device="meta")
    counts = []
    for backward in (False, True):
        with FlopCounterMode(display=False) as fc:
            out, _ = cnn.forward(cfg, params, state, x)
            if backward:
                out.sum().backward()
        counts.append(fc.get_total_flops())
    return tuple(counts)


def _dots_sees_convolution(dev) -> list:
    """The ops ``dots``' policy is shown for a CUDA convolution: every
    convolution overload among them must be one it saves."""
    import torch
    import torch.nn.functional as F
    from torch.utils import checkpoint as ckpt
    from repro_torch.models import remat
    seen = []

    def record(ctx, op, *args, **kwargs):
        seen.append(op)
        return remat._save_dots(ctx, op, *args, **kwargs)

    x = torch.randn(2, 3, 9, 9, device=dev, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, device=dev, requires_grad=True)
    ckpt.checkpoint(
        lambda a, b: F.conv2d(a, b, stride=2, padding=1).relu().sum(), x, w,
        use_reentrant=False,
        context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
            record)).backward()
    convs = sorted({str(op) for op in seen if "conv" in str(op)})
    check(bool(convs) and all(op in remat._DOT_OPS for op in seen
                              if "conv" in str(op)),
          f"dots' policy sees convolution ops {convs} on CUDA that it does "
          f"not save")
    return convs


def cnn_phase(dev, which: str, errs) -> dict:
    """The paper's workload ``which`` at its published size through
    ``flat``: the peak of one step at three micro sizes and their affine
    fit, extrapolated to the whole mini-batch without MBS (which must
    exceed the card's memory: if it does not at the configured
    mini-batch, the mini-batch is doubled until it does); then the
    mini-batch's steps through Pipeline + Trainer with the launch counters
    and peaks reset just before and read just after (K1 steps × N_Smu ×
    launch groups, K2/K4 steps × buckets; params finite); then ``flat``
    against ``compiled`` after one step from the same init, cuDNN
    deterministic in both. The BN statistics are the initial state's, as
    in the reference's drivers (``make_loss_fn``); remat "none"."""
    import torch
    from repro_torch import engine, kernels, tree
    from repro_torch.core import losses
    from repro_torch.engine import autotune
    from repro_torch.models import cnn

    mini, micro, n_steps, probe_micros = CNN_RUNS[which]
    cfg, make_opt, ds = _cnn_setup(which)
    update = "fused_sgd_mom" if which == "resnet50" else "fused_adam"
    total = torch.cuda.get_device_properties(dev).total_memory
    fwd_flops, train_flops = _train_flops(cfg)
    out = {"config": dataclasses.asdict(cfg), "forward_flops": fwd_flops,
           "train_flops": train_flops}
    if which == "resnet50":
        out["dots_conv_ops_cuda"] = _dots_sees_convolution(dev)
    # peaks and the no-MBS extrapolation
    t0 = time.perf_counter()
    peaks = [(m, _cnn_step_peak(dev, cfg, make_opt, ds, m))
             for m in probe_micros]
    a, b = autotune._fit_affine(peaks)
    configured = mini
    while a * mini + b <= total:
        mini *= 2
    out.update(probe_peaks=peaks, fit=[a, b], configured_mini=configured,
               mini=mini, no_mbs_peak_bytes=a * mini + b,
               card_bytes=total, probe_s=time.perf_counter() - t0)
    print(f"{which}: peak of one flat step (2 micro-batches) by micro size "
          f"(images, B): {peaks}; fit peak = {a:.1f} B x images + {b:.0f} B;"
          f" without MBS the mini-batch of {mini} would need "
          f"{(a * mini + b) / GIB:.2f} GiB, the card has {total / GIB:.2f}"
          + ("" if mini == configured else
             f" (the configured mini-batch {configured} would have fit: "
             f"doubled to {mini})"), flush=True)
    # the mini-batch's steps through Pipeline + Trainer
    plan = engine.plan_mbs(mini, micro_batch_size=micro, device=dev,
                           remat_policy="none")
    data = _Batches(ds, mini, range(n_steps))
    st, bn_state, opt = _cnn_state(cfg, dev, make_opt)
    ex = engine.FlatFusedExecutor(
        cnn.make_loss_fn(cfg, bn_state, plan.remat_policy), opt, plan)
    st["params"], st["opt_state"] = ex.prepare(st["params"],
                                               st["opt_state"])
    spec = engine.FlatSpec.for_tree(st["params"])
    groups = len(kernels.grad_accum_kernels.launch_groups(
        [(x, x) for x in tree.leaves(st["params"])]))
    pipeline = engine.Pipeline(data, plan, prefetch=2, device=dev)
    trainer = engine.Trainer(ex.step_split, pipeline, log_every=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    params, opt_state, _ = trainer.fit(st.pop("params"), st.pop("opt_state"),
                                       n_steps)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.history
    losses_seen = [h["loss"] for h in hist]
    check(len(hist) == n_steps and all(map(math.isfinite, losses_seen)),
          f"{which}: losses {losses_seen}")
    check(all(bool(torch.isfinite(x).all()) for x in spec.buffers_of(params)),
          f"{which}: params not finite")
    want_k1 = n_steps * plan.num_micro_batches * groups
    want_upd = n_steps * spec.num_buckets
    check(counts["grad_accum"] == want_k1,
          f"{which}: K1 launched {counts['grad_accum']} times, expected "
          f"{want_k1} ({n_steps} steps x {plan.num_micro_batches} "
          f"micro-batches x {groups} launch groups)")
    check(counts[update] == want_upd,
          f"{which}: {update} launched {counts[update]} times, expected "
          f"{want_upd}")
    # as on the main path: the gaps between readbacks but the last (which
    # follows no dispatch) are one step's period each
    clocks = [h["readback_s"] for h in hist]
    gaps = [y - x for x, y in zip(clocks, clocks[1:])]
    step_s = sum(gaps[:-1]) / len(gaps[:-1])
    bound_s = train_flops * mini / FP32_FLOPS_PER_S
    out.update(plan=plan.describe(), steps=n_steps, losses=losses_seen,
               counts=counts, launch_groups=groups,
               bucket_sizes=list(spec.bucket_sizes), leaves=len(spec.slots),
               peak_bytes=peak, allocated_before_bytes=base,
               peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
               readback_gaps_s=gaps, steady_step_s=step_s,
               images_per_s=mini / step_s, step_bound_s=bound_s,
               tflops_per_s=train_flops * mini / step_s / 1e12,
               input_wait_fraction=pipeline.stats.input_wait_fraction)
    print(f"{which} ({cfg.image_size}px, {spec.bucket_sizes[0]} params in "
          f"{len(spec.slots)} leaves): {plan.describe()}; losses "
          f"{losses_seen}; gaps between metric readbacks {gaps} s; steady "
          f"step {step_s:.4f}s, {mini / step_s:.1f} images/s "
          f"({train_flops / 1e9:.2f} GFLOP an image forward and backward, "
          f"{out['tflops_per_s']:.1f} TFLOP/s; the fp32 bound {bound_s:.4f}s"
          f" at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s); input-wait "
          f"fraction {pipeline.stats.input_wait_fraction:.4f}; peak "
          f"allocated {peak} B ({peak / GIB:.2f} GiB; {base} B before), "
          f"reserved {out['peak_reserved_bytes']} B; launches {counts}",
          flush=True)
    if which == "unet":
        ev = ds.batch(16, 10 ** 6)
        x, mask = (torch.from_numpy(ev[k]).to(dev) for k in ("image", "mask"))
        with torch.no_grad():
            for mode, train in (("eval", False), ("train", True)):
                logits, _ = cnn.forward(cfg, params, bn_state, x, train=train)
                out[f"iou_{mode}"] = float(losses.iou(logits, mask))
        print(f"unet: IoU after {n_steps} steps on 16 held-out images: "
              f"{out['iou_eval']:.4f} in eval mode over the initial BN "
              f"statistics (the reference's driver evaluates so; its loss "
              f"drops the new ones), {out['iou_train']:.4f} with the "
              f"batch's statistics", flush=True)
        out["k4_bucket_bitwise"] = _k4_at(dev, spec.bucket_sizes[0], errs)
    del params, opt_state, trainer, pipeline, data, ex
    torch.cuda.empty_cache()
    # flat against compiled after one step, from the same init
    split = plan.device_split(ds.batch(mini, 0), dev)
    got = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("compiled", "flat"):
            st, bn_state, opt = _cnn_state(cfg, dev, make_opt)
            exe = engine.get_executor(name)(
                cnn.make_loss_fn(cfg, bn_state, plan.remat_policy), opt, plan)
            p, s = st.pop("params"), st.pop("opt_state")
            if name == "flat":
                p, s = exe.prepare(p, s)
            p, s, m = exe.step_split(p, s, split)
            got[name] = (tree.leaves((p, {k: v for k, v in s.items()
                                          if k != "step"})), float(m["loss"]))
            del p, s, m, exe
    finally:
        torch.backends.cudnn.deterministic = False
    worst = 0.0
    for x, y in zip(got["flat"][0], got["compiled"][0]):
        err, ok = max_violation(x, y, atol=CNN_ATOL, rtol=CNN_RTOL)
        worst = max(worst, err)
        check(ok, f"{which}: flat and compiled disagree after one step: max "
                  f"abs err {err:.3e} (atol {CNN_ATOL}, rtol {CNN_RTOL})")
    out["flat_vs_compiled_max_abs_err"] = worst
    print(f"{which}: flat == compiled after one step (cuDNN deterministic, "
          f"mini-batch {mini} in {plan.num_micro_batches}): params and "
          f"optimizer state within atol {CNN_ATOL} + rtol {CNN_RTOL}, max abs "
          f"err {worst:.3e}; losses {got['flat'][1]:.6f} / "
          f"{got['compiled'][1]:.6f}", flush=True)
    del got, split
    torch.cuda.empty_cache()
    return out


def _k4_at(dev, n: int, errs) -> bool:
    """K4 against its plain version at ``n`` elements, bit for bit."""
    import torch
    from repro_torch import kernels
    gen = torch.Generator(device=dev).manual_seed(6)
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.randn(n, generator=gen, device=dev).abs_()
    lr, bc1, bc2, clip = (torch.tensor(x, device=dev)
                          for x in (0.01, 1 - 0.9 ** 2, 1 - 0.999 ** 2, 1.0))
    want = kernels.ref.fused_adam_ref(p, g, m, v, lr, bc1, bc2, clip,
                                      weight_decay=5e-4)
    kernels.fused_adam(p, g, m, v, lr, bc1, bc2, clip, weight_decay=5e-4)
    for got, w in zip((p, m, v), want):
        err, _ = max_violation(got, w)
        errs["fused_adam"] = max(errs["fused_adam"], err)
        check(torch.equal(got, w), f"K4 at the U-Net bucket ({n}) is not "
                                   f"bit-identical to its plain version: "
                                   f"max abs err {err:.3e}")
    print(f"unet: K4 bit-identical to its plain version at the U-Net "
          f"bucket ({n} fp32 elements)", flush=True)
    return True


def tuner_phase(dev, main: dict) -> dict:
    """The block tuner over the main path's bucket (``tune_for_params`` on
    a tree of its leaves' shapes, into ``build/tuning-blocks.json``): every
    candidate block's ms, and each candidate's output bit-identical to the
    default block's; then 2 steps of the main path under the tuned
    resolver, whose losses must equal the untuned run's."""
    import torch
    from repro_torch import engine, tree
    from repro_torch.engine import autotune

    cache = os.path.join(ROOT, "build", "tuning-blocks.json")
    if os.path.exists(cache):
        os.remove(cache)
    autotune._caches.pop(cache, None)
    spec = main["spec"]
    shapes = tree.unflatten(spec.treedef, [
        torch.empty(sl.shape, dtype=sl.dtype, device="meta")
        for sl in spec.slots])
    recs = autotune.tune_for_params(shapes, iters=3, device=dev,
                                    cache_path=cache)
    out = {"records": recs, "bitwise": {}}
    n = spec.bucket_sizes[0]
    for kind in ("grad_accum", "fused_update"):
        base = autotune.sweep_operands(kind, n, device=dev)
        autotune.run_with_block(kind, base, None)
        for block in autotune.CANDIDATE_BLOCKS:
            ops = autotune.sweep_operands(kind, n, device=dev)
            autotune.run_with_block(kind, ops, block)
            same = all(torch.equal(x, y) for x, y in zip(ops, base))
            del ops
            check(same, f"tuner: {kind} at block {block} is not "
                        f"bit-identical to the default block")
        out["bitwise"][kind] = list(autotune.CANDIDATE_BLOCKS)
        del base
        torch.cuda.empty_cache()
    # the sweep times the candidates one after another, so a drift of the
    # card over the sweep falls on the later ones; timed again in turns
    # (A B ... B A, each over 10 launches queued behind a sleep kernel)
    out["turns_ms"] = {}
    for kind in ("grad_accum", "fused_update"):
        ops = autotune.sweep_operands(kind, n, device=dev)
        out["turns_ms"][kind] = turns_ms({
            str(b): (lambda b=b: autotune.run_with_block(kind, ops, b))
            for b in autotune.CANDIDATE_BLOCKS}, 10)
        del ops
        torch.cuda.empty_cache()
    for key, rec in recs.items():
        kind = key.split("|")[0]
        turns = out["turns_ms"][kind]
        print(f"tuner: {key} (n={rec['n']}): winner {rec['block']}; the "
              f"sweep's median ms by block " + ", ".join(
                  f"{b}: {t / 1e3:.4f}" for b, t in rec["timings_us"].items())
              + "; in turns (first, second) " + ", ".join(
                  f"{b}: {t[0]:.4f} / {t[1]:.4f}" for b, t in turns.items())
              + "; every block bit-identical to the default", flush=True)
    engine.set_cache_path(cache)
    try:
        res = run_launcher(dev, main_argv(steps=2))
    finally:
        engine.set_cache_path(None)
    check(res["losses"] == main["losses"][:2],
          f"tuner: the main path under the tuned blocks gave losses "
          f"{res['losses']}, untuned {main['losses'][:2]}")
    out.update(tuned_losses=res["losses"], tuned_counts=res["counts"])
    print(f"tuner: 2 main-path steps under the tuned resolver: losses "
          f"{res['losses']} == the untuned run's; launches {res['counts']}",
          flush=True)
    del res
    torch.cuda.empty_cache()
    return out


def resume_phase(dev) -> dict:
    """Save/resume through the launcher at full width, 2 layers, ``flat``:
    4 steps uninterrupted twice (bit for bit, or else the two runs' own
    largest difference is the bound), then 2 steps with ``--ckpt-every 2``
    and ``--resume`` to step 4, whose params, momentum and losses must
    match the uninterrupted run's under that rule; then the port's
    checkpoint restored into a plain (not flat) template with every CRC
    checked."""
    import shutil
    import torch
    from repro_torch import optim, tree
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.models import transformer

    ckdir = os.path.join(ROOT, "build", "ckpt", "qwen2-1.5b-2l")
    shutil.rmtree(ckdir, ignore_errors=True)
    four = main_argv("--layers", "2", steps=4)

    def state(res):
        return tree.leaves((res["params"], res["opt_state"]["mom"]))

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    runs = [run_launcher(dev, four) for _ in range(2)]
    for r in runs:
        check(r["counts"]["grad_accum"] == 16
              and r["counts"]["fused_sgd_mom"] == 4,
              f"an uninterrupted run launched {r['counts']}, expected K1 16 "
              f"and K2 4 times")
    ref, again = state(runs[0]), state(runs[1])
    bitwise = all(torch.equal(x, y) for x, y in zip(ref, again))
    bound = max_diff(ref, again)  # 0 when bit for bit
    loss_bound = [abs(a - b) for a, b in zip(runs[0]["losses"],
                                             runs[1]["losses"])]
    first = run_launcher(dev, main_argv("--layers", "2", "--ckpt-dir",
                                        ckdir, "--ckpt-every", "2", steps=2))
    resumed = run_launcher(dev, four + ["--ckpt-dir", ckdir, "--resume"])
    check(resumed["counts"]["grad_accum"] == 8
          and resumed["counts"]["fused_sgd_mom"] == 2,
          f"the resumed run launched {resumed['counts']}, expected K1 8 and "
          f"K2 2 times")
    got = state(resumed)
    err = max_diff(got, ref)
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    check(same if bitwise else err <= bound,
          f"resume differs from the uninterrupted run by {err:.3e} (the two "
          f"uninterrupted runs: {'bit for bit' if bitwise else bound})")
    losses = first["losses"] + resumed["losses"]
    check(len(losses) == 4 and all(
        abs(x - a) <= lim for x, a, lim in zip(losses, runs[0]["losses"],
                                              loss_bound)),
        f"resumed losses {losses} vs uninterrupted {runs[0]['losses']} and "
        f"{runs[1]['losses']}")
    save = [r for r in first["checkpoints"] if r["op"] == "save"][-1]
    restore = [r for r in resumed["checkpoints"] if r["op"] == "restore"][0]
    check(save["step"] == 2 and restore["step"] == 2,
          f"checkpoints {first['checkpoints']} {resumed['checkpoints']}")
    print(f"resume: uninterrupted 4-step runs at qwen2-1.5b width, 2 layers, "
          f"flat: {'bit-identical' if bitwise else f'differ by {bound:.3e}'} "
          f"(losses {runs[0]['losses']} / {runs[1]['losses']}); 2 steps + "
          f"--resume to 4: {'bit-identical' if same else f'max diff {err:.3e}'}"
          f" (losses {losses}); checkpoint {save['bytes']} B, saved in "
          f"{save['seconds']:.3f}s, restored in {restore['seconds']:.3f}s",
          flush=True)
    # the port's step-4 checkpoint into a plain template, every CRC checked
    cfg = resumed["config"]
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    params = transformer.init_params(cfg, seed=0, device=dev)
    template = {"params": params, "opt_state": opt.init(params)}
    with open(os.path.join(ckdir, "ckpt_00000004.json")) as f:
        crcs = json.load(f)["crc"]
    n_leaves = len(tree.leaves(template))
    check(len(crcs) == n_leaves,
          f"the manifest has {len(crcs)} CRCs for {n_leaves} leaves")
    plain = ckpt_lib.restore(ckdir, template, 4, device=dev, verify=True)
    check(all(torch.equal(x, y) for x, y in zip(
        tree.leaves((plain["params"], plain["opt_state"]["mom"])), got)),
        "the step-4 checkpoint restored into the plain template differs "
        "from the resumed run's state")
    print(f"resume: the step-4 checkpoint restored into a plain template, "
          f"{len(crcs)} CRCs checked, equal to the resumed state", flush=True)
    out = {"uninterrupted_bitwise": bitwise, "uninterrupted_max_diff": bound,
           "resume_bitwise": same, "resume_max_diff": err,
           "losses": losses, "ckpt_bytes": save["bytes"],
           "save_s": save["seconds"], "restore_s": restore["seconds"],
           "crcs_checked": len(crcs)}
    del runs, first, resumed, ref, again, got, plain, template, params
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# full-size compare and timing
# ---------------------------------------------------------------------------

def _plain_in_slices(fn, n: int) -> None:
    for lo in range(0, n, CHUNK):
        fn(slice(lo, min(lo + CHUNK, n)))


def full_size_phase(dev, n: int, errs) -> dict:
    """Each kernel at ``n`` fp32 elements (the main path's bucket): compare
    with the plain version (run slice by slice on copies of the inputs, to
    bound memory), then time kernel, plain version (slice by slice, the
    same work) and the PyTorch call computing the same function."""
    import torch
    from repro_torch import kernels
    ref = kernels.ref
    gen = torch.Generator(device=dev).manual_seed(1)
    reps = 10
    res = {}

    def rnd(positive=False):
        x = torch.randn(n, generator=gen, device=dev)
        return x.abs_() if positive else x

    def compare(name, pairs_of):
        """Kernel outputs against the plain version, slice by slice."""
        for lo in range(0, n, CHUNK):
            for got, want in pairs_of(slice(lo, min(lo + CHUNK, n))):
                err, ok = max_violation(got, want)
                errs[name] = max(errs[name], err)
                check(ok, f"{name} at n={n} disagrees with its plain "
                          f"version: max abs err {err:.3e}")

    lr, clip = (torch.tensor(v, device=dev) for v in (0.05, 1.0))
    # K1
    acc, g = rnd(), rnd()
    s = torch.full((1,), 0.25, device=dev)
    acc0 = acc.clone()
    kernels.grad_accum(acc, g, s)
    compare("grad_accum", lambda c: [
        (acc[c], ref.grad_accum_ref(acc0[c], g[c], s))])
    del acc0
    # K1 on one flat pair, the layout of the copy-then-add step ❹
    res["grad_accum_flat"] = (
        event_ms(lambda: kernels.grad_accum(acc, g, s), reps),
        event_ms(lambda: _plain_in_slices(
            lambda c: ref.grad_accum_ref(acc[c], g[c], s), n), reps),
        event_ms(lambda: acc.add_(g, alpha=0.25), reps))
    del acc, g
    # K2 and K3
    p, g, m = rnd(), rnd(), rnd()
    p0, m0 = p.clone(), m.clone()
    kernels.fused_sgd(p, g, m, lr, clip, momentum=0.9, weight_decay=5e-4)
    compare("fused_sgd_mom", lambda c: zip((p[c], m[c]), ref.fused_sgd_ref(
        p0[c], g[c], m0[c], lr, clip, momentum=0.9, weight_decay=5e-4)))
    p0.copy_(p)
    kernels.fused_sgd(p, g, None, lr, clip, weight_decay=5e-4)
    compare("fused_sgd", lambda c: [(p[c], ref.fused_sgd_ref(
        p0[c], g[c], None, lr, clip, weight_decay=5e-4)[0])])
    del p0, m0
    res["fused_sgd_mom"] = (
        event_ms(lambda: kernels.fused_sgd(p, g, m, lr, clip, momentum=0.9,
                                           weight_decay=5e-4), reps),
        event_ms(lambda: _plain_in_slices(lambda c: ref.fused_sgd_ref(
            p[c], g[c], m[c], lr, clip, momentum=0.9, weight_decay=5e-4),
            n), reps),
        event_ms(lambda: torch._fused_sgd_(
            [p], [g], [m], weight_decay=5e-4, momentum=0.9, lr=0.05,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), reps))
    res["fused_sgd"] = (
        event_ms(lambda: kernels.fused_sgd(p, g, None, lr, clip,
                                           weight_decay=5e-4), reps),
        event_ms(lambda: _plain_in_slices(lambda c: ref.fused_sgd_ref(
            p[c], g[c], None, lr, clip, weight_decay=5e-4), n), reps),
        event_ms(lambda: torch._fused_sgd_(
            [p], [g], [], weight_decay=5e-4, momentum=0.0, lr=0.05,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), reps))
    del m
    # K4
    v = rnd(positive=True)
    m = rnd()
    bc1, bc2 = (torch.tensor(x, device=dev) for x in (0.1, 0.001))
    lr4 = torch.tensor(1e-3, device=dev)
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    kernels.fused_adam(p, g, m, v, lr4, bc1, bc2, clip, weight_decay=1e-2,
                       decoupled=True)
    compare("fused_adam", lambda c: zip((p[c], m[c], v[c]), ref.fused_adam_ref(
        p0[c], g[c], m0[c], v0[c], lr4, bc1, bc2, clip, weight_decay=1e-2,
        decoupled=True)))
    # the yardstick: torch's fused AdamW at step 1 (bias corrections 0.1
    # and 0.001, K4's bc1 and bc2; clip 1) computes K4's decoupled update
    step = torch.ones((), device=dev)

    def adamw(p, g, m, v):
        torch._fused_adamw_([p], [g], [m], [v], [], [step], lr=1e-3,
                            beta1=0.9, beta2=0.999, weight_decay=1e-2,
                            eps=1e-8, amsgrad=False, maximize=False)
    adamw_err = 0.0
    for lo in range(0, n, CHUNK):
        c = slice(lo, min(lo + CHUNK, n))
        got = [x[c].clone() for x in (p0, m0, v0)]
        adamw(got[0], g[c], got[1], got[2])
        for x0, a, b in zip((p0[c], m0[c], v0[c]), got, ref.fused_adam_ref(
                p0[c], g[c], m0[c], v0[c], lr4, bc1, bc2, clip,
                weight_decay=1e-2, decoupled=True)):
            err = (a - b).abs()
            lim = ADAMW_ATOL + ADAMW_RTOL * (x0.abs() + (b - x0).abs())
            adamw_err = max(adamw_err, float(err.max()))
            check(bool((err <= lim).all()),
                  f"torch._fused_adamw_ does not compute K4's plain "
                  f"version's update: max abs err {float(err.max()):.3e}")
        del got
    print(f"full size: torch._fused_adamw_ matches K4's plain version: max "
          f"abs err {adamw_err:.3e} (within {ADAMW_ATOL} + {ADAMW_RTOL} "
          f"(|old| + |new - old|))", flush=True)
    del p0, m0, v0
    res["fused_adam"] = (
        event_ms(lambda: kernels.fused_adam(p, g, m, v, lr4, bc1, bc2, clip,
                                            weight_decay=1e-2,
                                            decoupled=True), reps),
        event_ms(lambda: _plain_in_slices(lambda c: ref.fused_adam_ref(
            p[c], g[c], m[c], v[c], lr4, bc1, bc2, clip, weight_decay=1e-2,
            decoupled=True), n), reps),
        event_ms(lambda: adamw(p, g, m, v), reps))
    del p, g, m, v
    torch.cuda.empty_cache()
    return res


def _peak_above(dev, fn) -> int:
    """Bytes ``fn()`` allocated above what was allocated before it, at its
    peak (its result dropped)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) - base


def k1_leaves_phase(dev, spec, errs) -> dict:
    """K1 at the main path's gradient leaves (``spec``'s slots at full
    width, each gradient a tensor of its own, one fp32 bucket): bit-identical
    to the plain version leaf by leaf, then timed beside its bound, the
    plain version, ``torch._foreach_add_`` over the same pairs and
    ``add_`` on a flat pair; step ❹ as the copy-then-add design ran it
    (``FlatSpec.flatten``, then K1 on the flat pair) against
    ``exec_core.accumulate_flat``; and the bytes each allocates above its
    inputs."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.engine import exec_core
    ref = kernels.ref
    gen = torch.Generator(device=dev).manual_seed(5)
    reps = 10
    n = spec.bucket_sizes[0]
    acc = torch.randn(n, generator=gen, device=dev)
    accs = [acc[sl.offset:sl.offset + sl.size] for sl in spec.slots]
    grads = [torch.randn(sl.shape, generator=gen, device=dev)
             for sl in spec.slots]
    s = torch.full((1,), 0.25, device=dev)
    acc0 = acc.clone()
    kernels.grad_accum_many(accs, grads, s)
    worst = 0.0
    for sl, a, g in zip(spec.slots, accs, grads):
        want = ref.grad_accum_ref(acc0[sl.offset:sl.offset + sl.size],
                                  g.view(-1), s)
        err, _ = max_violation(a, want)
        worst = max(worst, err)
        check(torch.equal(a, want), f"K1 at the leaf {sl.shape} is not "
                                    f"bit-identical to its plain version: "
                                    f"max abs err {err:.3e}")
        del want
    errs["grad_accum"] = max(errs["grad_accum"], worst)
    del acc0
    gt = tree.unflatten(spec.treedef, grads)
    gviews = [g.view(-1) for g in grads]
    gflat = torch.randn(n, generator=gen, device=dev)
    out = {"leaves": len(grads), "max_abs_err": worst}
    # each time the mean of two turns (A B … B A), both kept in "turns"
    out["turns"] = turns_ms({
        "ms": lambda: kernels.grad_accum_many(accs, grads, s),
        "foreach_add_ms": lambda: torch._foreach_add_(accs, gviews,
                                                      alpha=0.25),
        "add_flat_ms": lambda: acc.add_(gflat, alpha=0.25),
        "copy_then_add_ms": lambda: kernels.grad_accum_buckets(
            (acc,), spec.flatten(gt, dtype=acc.dtype), 0.25),
        "accumulate_flat_ms": lambda: exec_core.accumulate_flat(
            (acc,), spec, gt, scale=0.25)}, reps)
    out.update({k: sum(v) / len(v) for k, v in out["turns"].items()})
    out["plain_ms"] = event_ms(lambda: [
        ref.grad_accum_ref(a, g, s) for a, g in zip(accs, gviews)], reps)
    out["flatten_bytes"] = _peak_above(
        dev, lambda: spec.flatten(gt, dtype=acc.dtype))
    out["accumulate_flat_bytes"] = _peak_above(
        dev, lambda: exec_core.accumulate_flat((acc,), spec, gt, scale=0.25))
    print(f"full size: K1 at the main path's {len(grads)} gradient leaves "
          f"({n} fp32 elements) bit-identical to its plain version; kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"torch._foreach_add_ {out['foreach_add_ms']:.4f} ms, add_ on a "
          f"flat pair {out['add_flat_ms']:.4f} ms, bound "
          f"{n * 12 / HBM_BYTES_PER_S * 1e3:.4f} ms (12 B an element); "
          f"each the mean of two turns {out['turns']}", flush=True)
    print(f"full size: step 4 a micro-batch: FlatSpec.flatten then K1 on the "
          f"flat pair {out['copy_then_add_ms']:.4f} ms, accumulate_flat "
          f"{out['accumulate_flat_ms']:.4f} ms; allocated above the inputs: "
          f"FlatSpec.flatten {out['flatten_bytes']} B, accumulate_flat "
          f"{out['accumulate_flat_bytes']} B", flush=True)
    del acc, accs, grads, gt, gviews, gflat
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K5 and K6: build, edge shapes, the kernel-API path at full width
# ---------------------------------------------------------------------------

API_KERNELS = {
    "cross_entropy": ("triton", "src/repro_torch/kernels/cross_entropy.py",
                      "src/repro/kernels/cross_entropy.py:26"),
    "flash_attention": ("cuda",
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:29"),
}
# Attention sums in another order than the plain version: the two fp32
# results agree within ATTN_ATOL, and in bf16 each then rounds, so they
# agree within one ulp plus ATTN_ATOL (an output near 0 after cancelling
# sums has an ulp far below the fp32 sums' rounding).
ATTN_ATOL = 2e-5
ATTN_REPS = 20  # launches a K6 case is timed over
CE_ATOL = 1e-4  # per-token NLL: both sum in fp32
CE_GRAD_ATOL = 1e-6
CE_OPS_PER_ELEM = 5  # max, subtract, exp, add, gold compare
LIB_BF16_ATOL = 2e-2  # a library call rounds P to bf16: the reference
                      # tests' bf16 attention tolerance
# an fp32 library call (TF32 off) sums in its own order and tiling: its
# output within this of the plain version's (a yardstick check only; K6's
# own fp32 bound is ATTN_ATOL)
LIB_FP32_ATOL = 1e-4

# (name, source of the widths, B, H, Hkv, S, hd, options, library call)
ATTN_CASES = [
    ("qwen2-1.5b", "src/repro_torch/configs/qwen2_1_5b.py; one micro-batch "
     "of the main path", 4, 12, 2, 1024, 128, {}, "sdpa causal"),
    ("gemma2-9b layer", "src/repro/configs/gemma2_9b.py:10-14; train_4k",
     1, 16, 8, 4096, 256, {"softcap": 50.0, "window": 4096},
     "flex_attention"),
    ("gemma3-12b local layer", "src/repro/configs/gemma3_12b.py:15-17",
     1, 16, 8, 4096, 256, {"window": 1024}, "sdpa mask"),
]
LIBRARY_CALLS = {
    "sdpa causal": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
    "sdpa mask": "F.scaled_dot_product_attention(attn_mask=<causal & "
                 "window>, enable_gqa=True)",
    "flex_attention": "torch.compile(flex_attention)(score_mod=tanh cap, "
                      "block_mask=<causal & window>, enable_gqa=True)",
}
CE_CASE = ("qwen2-1.5b LM head", 4096, 151936, 0.25)


def _k6_instance(fn: str) -> str:
    """'wgmma_bf16 hd 128 tile 128 x 128' and the like, from a mangled K6
    kernel name."""
    m = re.search(r"flash_fwd_wgmmaILi(\d+)ELi(\d+)E", fn)
    if m:
        return f"wgmma_bf16 hd {m.group(1)} tile 128 x {m.group(2)}"
    m = re.search(r"flash_fwd_simtILi(\d+)E", fn)
    return f"simt_fp32 hd {m.group(1)} tile 64 x 64" if m else fn


def _sass_stats(so: str):
    """By K6 instance, the HGMMA instructions in the library's SASS and the
    highest register it names (above ptxas's launch count where setmaxnreg
    gave the consumers more); None when no cuobjdump is found (the
    toolkit's, beside nvcc, or Triton's)."""
    from repro_torch.kernels import _cuda
    tools = [os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if os.access(t, os.X_OK)), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    stats = {}
    for fn in sass.split("Function : ")[1:]:
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", fn)]
        stats[_k6_instance(fn.split()[0])] = {
            "hgmma": fn.count("HGMMA"), "max_register": max(regs, default=0)}
    return stats


def build_phase(later=()) -> dict:
    """Builds the port's CUDA C++ libraries, one ``nvcc`` for each source,
    all started together; returns the seconds each build took. The
    sources named in ``later`` go on building while the caller runs on:
    their entries are futures of the seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _cuda

    def build(name):
        t0 = time.perf_counter()
        _cuda.load(name)
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(CUDA_LIBRARIES))
    futures = {name: pool.submit(build, name) for name in CUDA_LIBRARIES}
    pool.shutdown(wait=False)
    seconds = {name: f if name in later else f.result()
               for name, f in futures.items()}
    done = ", ".join(f"{k} {v:.1f}s" for k, v in seconds.items()
                     if k not in later)
    print(f"build: {done} (nvcc, sm_90a, in parallel; "
          f"{time.perf_counter() - t0:.1f}s in all"
          + (f"; {', '.join(later)} still building" if later else "")
          + ")", flush=True)
    return seconds


def _k1_instance(fn: str) -> str:
    """'acc fp32 grad bf16' and the like, from a mangled K1 kernel name
    (a repeated type is a substitution, so anything but 'f' is bf16)."""
    m = re.search(r"grad_accum_kernelI(.*?)EEv", fn)
    if not m:
        return fn
    args = m.group(1)
    return (f"acc {'fp32' if args.startswith('f') else 'bf16'} grad "
            f"{'fp32' if args.endswith('f') else 'bf16'}")


def ptxas_report(kernel: str, lib: str, label, strict) -> dict:
    """ptxas's register and spill lines for each instance of the library
    built from ``csrc/<lib>.cu``, printed, by instance (``label`` names an
    instance from its mangled name); fails on a spill or a serialized
    wgmma in an instance that ``strict`` holds to that."""
    from repro_torch.kernels import _cuda
    instances, cur = {}, None
    for line in _cuda.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = label(m.group(1))
            instances[cur] = {}
        elif "serialized" in line:
            fn = re.search(r"function '(\S+)'", line)
            name = label(fn.group(1)) if fn else cur
            check(not strict(name), f"{kernel} [{name}]: ptxas serialized "
                                    f"its wgmma: {line.strip()}")
        elif cur and "spill stores" in line:
            st, ld = (int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            instances[cur].update(spill_stores=st, spill_loads=ld)
            check(not (strict(cur) and (st or ld)),
                  f"{kernel} [{cur}] spills: {line.strip()}")
        elif cur and "Used " in line:
            instances[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        else:
            continue
        print(f"build: ptxas: {line.strip()}", flush=True)
    for name, info in instances.items():
        print(f"build: {kernel} {name}: {info}", flush=True)
    return instances


def build_k1(seconds: float) -> dict:
    """K1's build report: ptxas's register and spill line for each
    instance (accumulator × gradient dtype); fails on a spill, or on an
    instance missing from the report."""
    report = {"build_s": seconds, "instances": ptxas_report(
        "K1", "grad_accum", _k1_instance, lambda name: True)}
    check(len(report["instances"]) == 4 and all(
        "registers" in v and "spill_stores" in v
        for v in report["instances"].values()),
        f"K1's ptxas report lacks an instance's registers or spills: "
        f"{report['instances']}")
    return report


def build_k6(seconds: float) -> dict:
    """K6's build report: ptxas's lines for each instance, the dynamic
    shared memory each head dim asks for (as the library computes it), the
    blocks of the fp32 kernel an SM holds (the occupancy calculator) and
    the HGMMA count of the SASS. Fails on a spill in any instance, on a
    serialized wgmma or a missing HGMMA in a bf16 instance, and on an
    instance missing from the report."""
    import torch
    from repro_torch.kernels import _cuda, flash_attention_kernels as fa
    report = {"build_s": seconds, "instances": ptxas_report(
        "K6", "flash_attention", _k6_instance, lambda name: True)}
    want = {f"{kind} hd {hd}" for kind in ("wgmma_bf16", "simt_fp32")
            for hd in fa.HEAD_DIMS}
    got = {" ".join(name.split()[:3]) for name, v in
           report["instances"].items()
           if "registers" in v and "spill_stores" in v}
    check(got == want, f"K6's ptxas report lacks an instance's registers or "
                       f"spills: {report['instances']}")
    report["smem_bytes"] = {
        f"{kind} hd {hd}": fa.smem_bytes(hd, dt)
        for kind, dt in (("wgmma_bf16", torch.bfloat16),
                         ("simt_fp32", torch.float32))
        for hd in fa.HEAD_DIMS}
    print(f"build: K6 dynamic shared memory a block (library's layout): "
          f"{report['smem_bytes']}", flush=True)
    report["simt_fp32"] = {}
    for hd in fa.HEAD_DIMS:
        blocks, threads = fa.simt_occupancy(hd)
        st = report["simt_fp32"][hd] = {
            "registers": report["instances"][
                f"simt_fp32 hd {hd} tile 64 x 64"]["registers"],
            "smem_bytes": report["smem_bytes"][f"simt_fp32 hd {hd}"],
            "threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}
        check(blocks >= 1, f"K6 simt_fp32 hd {hd}: no block fits an SM: "
                           f"{st}")
        print(f"build: K6 simt_fp32 hd {hd}: {threads} threads, "
              f"{st['registers']} registers, {st['smem_bytes']} bytes of "
              f"shared memory; {blocks} block(s) = {st['warps_per_sm']} "
              f"warps an SM", flush=True)
    sass = _sass_stats(_cuda._library_path("flash_attention"))
    if sass is None:
        print("build: K6 SASS HGMMA count: not available (no cuobjdump)",
              flush=True)
    else:
        print(f"build: K6 SASS HGMMA count and highest register: {sass}",
              flush=True)
        for name, st in sass.items():
            check(st["hgmma"] > 0 or not name.startswith("wgmma"),
                  f"K6 [{name}] has no HGMMA instruction in its SASS")
    report["sass"] = sass
    return report


def kept_pairs(S: int, causal: bool, window) -> int:
    """(q, k) pairs the causal and window masks keep."""
    total = 0
    for r in range(S):
        lo = max(0, r - window + 1) if window is not None else 0
        hi = r if causal else S - 1
        total += max(0, hi - lo + 1)
    return total


def _attn_inputs(gen, dev, B, H, Hkv, S, hd, dtype):
    import torch
    return [torch.randn(B, h, S, hd, generator=gen, device=dev).to(dtype)
            for h in (H, Hkv, Hkv)]


def _shifted(x, elems: int):
    """A contiguous copy of ``x`` that starts ``elems`` elements into its
    storage (not 16-byte aligned for a small odd count in fp32)."""
    import torch
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    y = buf[elems:].view(x.shape)
    y.copy_(x)
    return y


def _ce_inputs(gen, dev, T, V, dtype):
    import torch
    x = (torch.randn(T, V, generator=gen, device=dev) * 3).to(dtype)
    return x, torch.randint(0, V, (T,), generator=gen, device=dev)


def edge_phase(dev, errs) -> None:
    """K5 and K6 against their plain versions at edge shapes, each dtype
    through its own K6 kernel."""
    import torch
    from repro_torch import kernels
    ref, fa, ce = (kernels.ref, kernels.flash_attention_kernels,
                   kernels.cross_entropy_kernels)
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for T, V, outside in ((1, 1, False), (37, 777, False),
                              (4099, 151936, False), (37, 777, True)):
            x, lab = _ce_inputs(gen, dev, T, V, dt)
            if outside:  # labels below 0 and at or past V: lse · scale
                lab[::3] = torch.tensor([-1, V, V + 4096, -300] * 4,
                                        device=dev)[:len(lab[::3])]
            got = ce.cross_entropy(x, lab, scale=0.25)
            err, ok = max_violation(got, ref.cross_entropy_ref(x, lab) * 0.25,
                                    atol=CE_ATOL, rtol=0.0)
            errs["cross_entropy"] = max(errs["cross_entropy"], err)
            check(ok, f"K5 [{T}x{V} {dt} outside={outside}] disagrees with "
                      f"its plain version: max abs err {err:.3e}")
            n += 1
            del x, lab, got
        attn = [  # (B, H, Hkv, S, hd, options): the reference tests' shapes
            (2, 4, 4, 128, 64, {}), (2, 4, 2, 256, 64, {}),
            (2, 8, 1, 256, 32, {}), (2, 2, 2, 384, 64, {}),
            (1, 4, 2, 256, 64, {"window": 64}),
            (1, 4, 2, 256, 64, {"softcap": 30.0}),
            (1, 4, 2, 256, 64, {"window": 96, "softcap": 50.0}),
            (1, 2, 2, 200, 64, {}),  # unaligned S, causal
            (1, 2, 1, 128, 32, {"causal": False}),
            # hd 128 and 256 with GQA groups 1, 6 and 2
            (1, 6, 6, 256, 128, {}), (1, 12, 2, 256, 128, {}),
            (1, 4, 2, 256, 256, {}),
            # windows 64 and 1024 with softcap 50 at hd 256
            (1, 4, 2, 1536, 256, {"window": 1024, "softcap": 50.0}),
            (1, 2, 1, 333, 256, {"window": 64, "softcap": 50.0}),
            # S below one tile: boxes past S are zero-filled
            (1, 2, 1, 1, 64, {}), (1, 2, 1, 20, 128, {}),
        ]
        if dt == torch.float32:
            attn += [  # the SIMT kernel's 64-row tile: S one below, above
                (1, 2, 2, 63, 64, {}), (1, 4, 2, 65, 128, {}),
                # hd 256 at the gemma layers' G = 2, window and cap
                (1, 4, 2, 65, 256, {"window": 32, "softcap": 50.0}),
                (1, 4, 2, 700, 256, {"window": 300, "softcap": 50.0}),
                # operands 4 bytes past 16-byte alignment (aligned copies)
                (1, 4, 2, 130, 64, {"offset": 1}),
            ]
        before = kernels.variant_launch_counts()
        for B, H, Hkv, S, hd, kw in attn:
            q, k, v = _attn_inputs(gen, dev, B, H, Hkv, S, hd, dt)
            if kw.get("offset"):
                q, k, v = (_shifted(x, kw["offset"]) for x in (q, k, v))
            opts = {o: kw[o] for o in ("causal", "window", "softcap")
                    if o in kw}
            got = fa.flash_attention(q, k, v, **opts)
            torch.cuda.synchronize()  # a fault shows here, where it happened
            err, ok = max_violation(got, ref.attention_ref(q, k, v, **opts),
                                    atol=ATTN_ATOL, rtol=0.0,
                                    bf16_atol=ATTN_ATOL)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            check(ok, f"K6 [B{B} H{H}/{Hkv} S{S} hd{hd} {kw} {dt}] disagrees "
                      f"with its plain version: max abs err {err:.3e}")
            n += 1
        took = {k: v - before[k]
                for k, v in kernels.variant_launch_counts().items()}
        want = {k: 0 for k in took}
        want[fa.VARIANTS[dt]] = len(attn)
        check(took == want, f"K6 at the {dt} edge shapes launched {took}, "
                            f"expected {want}")
        print(f"kernels: K6 {dt} edge shapes launched {took}", flush=True)
    torch.cuda.synchronize()
    print(f"kernels: K5 and K6 match their plain versions at {n} edge shapes "
          f"in fp32 and bf16 ({time.perf_counter() - t0:.1f}s incl. K5's "
          f"build)", flush=True)


def _attn_mask(S, window, dev):
    import torch
    r = torch.arange(S, device=dev)[:, None]
    c = torch.arange(S, device=dev)[None, :]
    return (c <= r) & (c > r - window)


def _flex_call(q, k, v, window, softcap):
    """One compiled ``flex_attention`` call computing K6's function at
    these options (scale, then tanh cap, then causal and window masks;
    GQA). A yardstick only: the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    S = q.shape[2]

    def score_mod(score, b, h, qi, ki):
        return torch.tanh(score / softcap) * softcap if softcap else score

    def mask_mod(b, h, qi, ki):
        ok = ki <= qi
        return ok & (ki > qi - window) if window is not None else ok

    block_mask = create_block_mask(mask_mod, None, None, S, S,
                                   device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q, k, v, score_mod=score_mod, block_mask=block_mask,
                        enable_gqa=True)


def _library_call(lib: str, q, k, v, window, softcap):
    """The PyTorch call of ``LIBRARY_CALLS[lib]`` on these inputs."""
    import torch.nn.functional as F
    if lib == "sdpa causal":
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    if lib == "sdpa mask":
        mask = _attn_mask(q.shape[2], window, q.device)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    return _flex_call(q, k, v, window, softcap)


def api_phase(dev, errs) -> dict:
    """The kernel-API path at full width, forward and backward, with the
    launch counters zeroed just before and read just after; then each
    output and gradient against autograd through the plain version, and
    each case timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    ref = kernels.ref
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for name, src, B, H, Hkv, S, hd, opts, lib in ATTN_CASES:
        q, k, v = _attn_inputs(gen, dev, B, H, Hkv, S, hd, torch.bfloat16)
        gout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        cases.append([name, (q, k, v), gout, opts])
    _, T, V, scale = CE_CASE
    logits, labels = _ce_inputs(gen, dev, T, V, torch.float32)
    gce = torch.randn(T, generator=gen, device=dev)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results = []
    for name, ins, gout, opts in cases:
        ins = [x.requires_grad_() for x in ins]
        out = kernels.flash_attention(*ins, True, opts.get("window"),
                                      opts.get("softcap"))
        out.backward(gout)
        results.append((out.detach(), [x.grad for x in ins]))
    logits.requires_grad_()
    ce_out = kernels.cross_entropy(logits, labels, scale)
    ce_out.backward(gce)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    variants = kernels.variant_launch_counts()
    want = {k: 0 for k in counts}
    want.update(flash_attention=len(cases), cross_entropy=1)
    check(counts == want, f"kernel-API path launched {counts}, expected "
                          f"{want}")
    want = {"wgmma_bf16": len(cases), "simt_fp32": 0}
    check(variants == want, f"kernel-API path launched K6's kernels "
                            f"{variants}, expected {want}")

    # outputs and gradients against autograd through the plain versions
    for (name, ins, gout, opts), (out, grads) in zip(cases, results):
        plain_in = [x.detach().requires_grad_() for x in ins]
        plain = ref.attention_ref(*plain_in, window=opts.get("window"),
                                  softcap=opts.get("softcap"))
        plain.backward(gout)
        err, ok = max_violation(out, plain.detach(), atol=ATTN_ATOL,
                                rtol=0.0, bf16_atol=ATTN_ATOL)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        check(ok, f"K6 [{name}] output disagrees with its plain version: "
                  f"max abs err {err:.3e}")
        gerr = 0.0
        for g, pg in zip(grads, (x.grad for x in plain_in)):
            e, ok = max_violation(g, pg, bf16_atol=ATTN_ATOL)
            gerr = max(gerr, e)
            check(ok, f"[{name}] gradient through kernels.flash_attention "
                      f"disagrees with autograd through the plain version: "
                      f"max abs err {e:.3e}")
        print(f"api path: {name}: output max abs err {err:.3e}, gradients "
              f"{gerr:.3e}", flush=True)
        del plain, plain_in
        torch.cuda.empty_cache()
    plain_in = logits.detach().requires_grad_()
    plain = ref.cross_entropy_ref(plain_in, labels) * scale
    plain.backward(gce)
    err, ok = max_violation(ce_out.detach(), plain.detach(), atol=CE_ATOL,
                            rtol=0.0)
    errs["cross_entropy"] = max(errs["cross_entropy"], err)
    check(ok, f"K5 [{CE_CASE[0]}] output disagrees with its plain version: "
              f"max abs err {err:.3e}")
    gerr, ok = max_violation(logits.grad, plain_in.grad, atol=CE_GRAD_ATOL,
                             rtol=0.0)
    check(ok, f"gradient through kernels.cross_entropy disagrees with "
              f"autograd through the plain version: max abs err {gerr:.3e}")
    print(f"api path: {CE_CASE[0]}: output max abs err {err:.3e}, gradient "
          f"{gerr:.3e}; launches {counts}, K6 by kernel {variants}",
          flush=True)
    del plain, plain_in, results
    logits.grad = None
    torch.cuda.empty_cache()

    # timings: kernel, plain version, library call
    fa, ce = kernels.flash_attention_kernels, kernels.cross_entropy_kernels
    records = {"flash_attention": [], "cross_entropy": []}
    for (name, src, B, H, Hkv, S, hd, opts, lib), (_, ins, _, _) in zip(
            ATTN_CASES, cases):
        q, k, v = (x.detach() for x in ins)
        w, cap = opts.get("window"), opts.get("softcap")
        ms = event_ms(lambda: fa.flash_attention(q, k, v, window=w,
                                                 softcap=cap), ATTN_REPS)
        plain_ms = event_ms(lambda: ref.attention_ref(q, k, v, window=w,
                                                      softcap=cap),
                            ATTN_REPS)
        lib_fn = _library_call(lib, q, k, v, w, cap)
        t0 = time.perf_counter()
        lib_out = lib_fn()  # flex_attention compiles at its first call
        lib_first_s = time.perf_counter() - t0
        lib_err, ok = max_violation(lib_out, ref.attention_ref(
            q, k, v, window=w, softcap=cap), atol=LIB_BF16_ATOL, rtol=0.0,
            bf16_atol=LIB_BF16_ATOL)
        check(ok, f"[{name}] the library call {LIBRARY_CALLS[lib]} does not "
                  f"compute the plain version's function: max abs err "
                  f"{lib_err:.3e}")
        del lib_out
        lib_ms = event_ms(lib_fn, ATTN_REPS)
        lib_fn = None
        pairs = kept_pairs(S, True, w)
        flops = 4 * hd * pairs * B * H
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        op_ms = flops / BF16_FLOPS_PER_S * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        records["flash_attention"].append({
            "case": name, "widths_from": src,
            "shape": {"B": B, "H": H, "Hkv": Hkv, "S": S, "hd": hd},
            "options": {"causal": True, **opts}, "dtype": "bfloat16",
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": LIBRARY_CALLS[lib], "library_max_abs_err": lib_err,
            "library_first_call_s": lib_first_s,
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            # the bf16 kernel's own floor: PV runs twice (P_hi, P_lo)
            "design_floor_ms": 1.5 * max(op_ms, byte_ms),
            "fp32_bound_ms": flops / FP32_FLOPS_PER_S * 1e3,
            "flops": flops, "bytes": nbytes, "kept_pairs": pairs})
        torch.cuda.empty_cache()
    x = logits.detach()
    ms = event_ms(lambda: ce.cross_entropy(x, labels, scale=scale), 10)
    plain_ms = event_ms(lambda: ref.cross_entropy_ref(x, labels) * scale, 10)
    lib_ms = event_ms(lambda: F.cross_entropy(x, labels, reduction="none"),
                      10)
    nbytes = x.numel() * 4 + labels.numel() * labels.element_size() + T * 4
    op_ms = x.numel() * CE_OPS_PER_ELEM / FP32_FLOPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    records["cross_entropy"].append({
        "case": CE_CASE[0], "shape": {"T": T, "V": V}, "dtype": "float32",
        "scale": scale, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "F.cross_entropy(reduction='none'), unscaled",
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms > byte_ms else "bytes",
        "bytes": nbytes})
    records["flash_attention"] += _fp32_attention_timings(dev, gen, errs)
    for rec in records["flash_attention"] + records["cross_entropy"]:
        print(f"api timing: {rec['case']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
              f"({rec['library']}), bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
    del cases, logits, labels, x
    torch.cuda.empty_cache()
    return {"counts": counts, "variants": variants, "records": records}


def _fp32_attention_timings(dev, gen, errs) -> list:
    """K6's fp32 kernel (``simt_fp32``) at the kernel-API cases' shapes,
    on fp32 inputs: its output against the plain version's (ATTN_ATOL),
    then each case timed beside the plain version and the library call on
    the same fp32 inputs (TF32 off: SDPA, or the compiled
    ``flex_attention`` with the tanh cap, each first checked against the
    plain version within LIB_FP32_ATOL). The bound is the kept pairs'
    FLOPs at the fp32 rate outside the tensor cores (FP32_FLOPS_PER_S) or
    the bytes at HBM_BYTES_PER_S, the larger. The timing launches are not
    a path's: the counters were read before."""
    import torch
    from repro_torch import kernels
    fa, ref = kernels.flash_attention_kernels, kernels.ref
    check(not torch.backends.cuda.matmul.allow_tf32,
          "K6 fp32 timings need TF32 off")
    out = []
    for name, src, B, H, Hkv, S, hd, opts, lib in ATTN_CASES:
        q, k, v = _attn_inputs(gen, dev, B, H, Hkv, S, hd, torch.float32)
        w, cap = opts.get("window"), opts.get("softcap")
        before = kernels.variant_launch_counts()["simt_fp32"]
        got = fa.flash_attention(q, k, v, window=w, softcap=cap)
        torch.cuda.synchronize()
        check(kernels.variant_launch_counts()["simt_fp32"] == before + 1,
              f"K6 [{name} fp32] did not launch its fp32 kernel")
        plain = ref.attention_ref(q, k, v, window=w, softcap=cap)
        err, ok = max_violation(got, plain, atol=ATTN_ATOL, rtol=0.0)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        check(ok, f"K6 [{name} fp32] disagrees with its plain version: "
                  f"max abs err {err:.3e}")
        lib_fn = _library_call(lib, q, k, v, w, cap)
        t0 = time.perf_counter()
        lib_out = lib_fn()  # flex_attention compiles for fp32 here
        lib_first_s = time.perf_counter() - t0
        lib_err, ok = max_violation(lib_out, plain, atol=LIB_FP32_ATOL,
                                    rtol=0.0)
        check(ok, f"[{name} fp32] the library call {LIBRARY_CALLS[lib]} "
                  f"does not compute the plain version's function: max "
                  f"abs err {lib_err:.3e}")
        del got, plain, lib_out
        ms = event_ms(lambda: fa.flash_attention(q, k, v, window=w,
                                                 softcap=cap), ATTN_REPS)
        plain_ms = event_ms(lambda: ref.attention_ref(q, k, v, window=w,
                                                      softcap=cap),
                            ATTN_REPS)
        lib_ms = event_ms(lib_fn, ATTN_REPS)
        lib_fn = None
        pairs = kept_pairs(S, True, w)
        flops = 4 * hd * pairs * B * H
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        op_ms = flops / FP32_FLOPS_PER_S * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(op_ms, byte_ms)
        out.append({
            "case": f"{name} fp32", "widths_from": src,
            "shape": {"B": B, "H": H, "Hkv": Hkv, "S": S, "hd": hd},
            "options": {"causal": True, **opts}, "dtype": "float32",
            "kernel": "simt_fp32", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": LIBRARY_CALLS[lib] + ", fp32, TF32 off",
            "library_max_abs_err": lib_err,
            "library_first_call_s": lib_first_s,
            "bound_ms": bound,
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "pct_of_bound": 100.0 * bound / ms,
            "flops": flops, "bytes": nbytes, "kept_pairs": pairs})
        print(f"api fp32: {name}: K6 simt_fp32 {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({out[-1]['bound_by']}, "
              f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s fp32), "
              f"{out[-1]['pct_of_bound']:.1f} % of it; plain {plain_ms:.4f}"
              f" ms; library {lib_ms:.4f} ms (max abs err {lib_err:.3e}, "
              f"first call {lib_first_s:.1f} s); K6 max abs err {err:.3e}",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the numeric guard's kernels: K2-K4 with GUARD
# ---------------------------------------------------------------------------

GUARD_KINDS = ("fused_sgd_mom", "fused_sgd", "fused_adam")
# the buffers each kernel writes, by index into its operands (p, g, m, v)
GUARD_WRITES = {"fused_sgd_mom": (0, 2), "fused_sgd": (0,),
                "fused_adam": (0, 2, 3)}


def _guard_operands(kind, n, dtype, dev, gen) -> list:
    import torch

    def rnd(dt=dtype):
        return torch.randn(n, generator=gen, device=dev).to(dt)
    ops = [rnd(), rnd(torch.float32)]
    if kind != "fused_sgd":
        ops.append(rnd())
    if kind == "fused_adam":
        ops.append(rnd().abs())
    return ops


def _guard_call(kind, ops, ok) -> None:
    """One launch of ``kind`` over ``ops``: the unguarded kernel when ``ok``
    is None, else the GUARD variant with that device flag."""
    from repro_torch import kernels
    if kind == "fused_adam":
        kernels.fused_adam(*ops, 1e-3, 0.1, 0.001, 0.7, weight_decay=1e-2,
                           decoupled=True, ok=ok)
    elif kind == "fused_sgd_mom":
        kernels.fused_sgd(*ops, 0.05, 0.7, momentum=0.9, weight_decay=5e-4,
                          nesterov=True, ok=ok)
    else:
        kernels.fused_sgd(ops[0], ops[1], None, 0.05, 0.7,
                          weight_decay=5e-4, ok=ok)


def guard_kernel_phase(dev) -> int:
    """K2-K4's GUARD variants at the ragged sizes in fp32 and bf16: with the
    flag at 1 bit-identical to the unguarded kernel; at 0 every buffer
    unchanged, a NaN in the accumulator included. Returns the case count."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = 0
    for n in RAGGED_SIZES:
        for dt in (torch.float32, torch.bfloat16):
            for kind in GUARD_KINDS:
                ops = _guard_operands(kind, n, dt, dev, gen)
                for flag in (True, False):
                    got = [x.clone() for x in ops]
                    want = [x.clone() for x in ops]
                    if flag:
                        _guard_call(kind, want, None)
                    else:
                        got[1][n // 2] = float("nan")
                    _guard_call(kind, got, torch.tensor(flag, device=dev))
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for i, (a, b) in
                               enumerate(zip(got, want)) if i != 1)
                    check(same, f"{kind} GUARD [flag {int(flag)}, {dt}, "
                                f"n={n}]: " + ("not bit-identical to the "
                                               "unguarded kernel" if flag
                                               else "wrote a buffer"))
                    cases += 1
    print(f"kernels: K2-K4 GUARD variants at n={RAGGED_SIZES} in fp32 and "
          f"bf16: flag 1 bit-identical to the unguarded kernels, flag 0 "
          f"writes nothing ({cases} cases)", flush=True)
    return cases


def guard_full_size_phase(dev, n: int) -> dict:
    """K2-K4 at the main path's bucket (``n`` fp32 elements): the GUARD
    variant with flag 1 bit-identical to the unguarded kernel and with
    flag 0 writing nothing; then unguarded, flag 1 and flag 0 timed in
    turns (A B C C B A), each over 10 launches behind a sleep kernel. A
    skipped step (flag 0) must take under a quarter of the unguarded
    kernel's time in the same turns; K4's line sets its flag 0 beside
    K2's."""
    import torch
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(7)
    one = torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.bool, device=dev)
    res = {}
    for kind in GUARD_KINDS:
        ops = _guard_operands(kind, n, torch.float32, dev, gen)
        guarded = [x.clone() if i in GUARD_WRITES[kind] else x
                   for i, x in enumerate(ops)]
        _guard_call(kind, ops, None)
        _guard_call(kind, guarded, one)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(guarded, ops)),
              f"{kind} GUARD flag 1 at n={n} is not bit-identical to the "
              f"unguarded kernel")
        _guard_call(kind, guarded, zero)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(guarded, ops)),
              f"{kind} GUARD flag 0 at n={n} wrote a buffer")
        del guarded
        turns = turns_ms({
            "unguarded": lambda: _guard_call(kind, ops, None),
            "flag1": lambda: _guard_call(kind, ops, one),
            "flag0": lambda: _guard_call(kind, ops, zero)}, 10)
        res[kind] = {k: sum(v) / len(v) for k, v in turns.items()}
        res[kind]["turns_ms"] = turns
        beside = (f", K2's flag 0 {res['fused_sgd_mom']['flag0']:.4f} ms"
                  if kind == "fused_adam" else "")
        print(f"full size: {kind} at n={n}: unguarded "
              f"{res[kind]['unguarded']:.4f} ms, GUARD flag 1 "
              f"{res[kind]['flag1']:.4f} ms, flag 0 {res[kind]['flag0']:.4f}"
              f" ms{beside} (mean of two turns; turns {turns}; {card}); "
              f"flag 1 bit-identical, flag 0 writes nothing", flush=True)
        check(res[kind]["flag0"] < res[kind]["unguarded"] / 4,
              f"{kind} GUARD flag 0 at n={n} takes {res[kind]['flag0']:.4f}"
              f" ms, not under a quarter of the unguarded kernel's "
              f"{res[kind]['unguarded']:.4f} ms: a skipped step costs a pass")
        del ops
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 13. the supervisor: the guard (13c), the OOM ladder (13a) and the
# calibration miss (13b)
# ---------------------------------------------------------------------------

def _stage(split, dev) -> dict:
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in split.items()}


def _state_leaves(params, opt_state) -> list:
    from repro_torch import tree
    return tree.leaves((params, opt_state))


def _host(leaves) -> list:
    return [t.detach().to("cpu", copy=True) for t in leaves]


def _max_diff(host_leaves, leaves) -> float:
    """Largest |a - b| between host leaves and the leaves of another run
    (on the card or the host), one leaf moved at a time; 0 when bit for
    bit."""
    import torch
    worst = 0.0
    for h, d in zip(host_leaves, leaves):
        x = h.to(d.device)
        if not torch.equal(x, d):
            worst = max(worst, float((x.double() - d.double()).abs().max()))
        del x
    return worst


def _same_run(what, ref_host, ref_losses, got_leaves, got_losses, redo):
    """Phase 8's rule: bit for bit where two uninterrupted runs agree;
    where they do not (``redo()`` runs the reference again and returns its
    host leaves and losses), within their own difference."""
    diff = _max_diff(ref_host, got_leaves)
    if diff == 0.0 and got_losses == ref_losses:
        return {"bitwise": True, "max_diff": 0.0}
    again_host, again_losses = redo()
    bound = _max_diff(ref_host, again_host)
    loss_bound = max(abs(a - b) for a, b in zip(ref_losses, again_losses))
    loss_diff = max(abs(a - b) for a, b in zip(ref_losses, got_losses))
    check(diff <= bound and loss_diff <= loss_bound,
          f"{what}: differs from the reference run by {diff:.3e} (losses "
          f"{loss_diff:.3e}); two reference runs differ by {bound:.3e} "
          f"({loss_bound:.3e})")
    return {"bitwise": False, "max_diff": diff, "bound": bound}


# 13c's supervised runs: depth cut to 2 of 28 layers for the run's time
# limit (at 28 their two 12.3 GB host anchors a run took ~12 s)
GUARD_SUPERVISED_LAYERS = 2


def guard_phase(dev) -> dict:
    """13c. The guard on the card. At full qwen2-1.5b through the main
    path's ``flat`` executor: guarded and unguarded steps timed in turns
    on a clean batch, their peaks (within 0.1 GiB), their synchronizing
    calls under ``torch.cuda.set_sync_debug_mode`` (the guarded step may
    make none that the unguarded does not), and one guarded step on a
    batch poisoned by ``faults.nan_at``: every param and momentum buffer
    and the step counter ``torch.equal`` to copies taken before it. Then
    the supervised launcher at GUARD_SUPERVISED_LAYERS with the NaN
    injected (``nan_retries`` 1) against the unfaulted supervised run.
    Then ``compiled``, ``fused``,
    ``streaming`` and ``flat`` at 2 layers (phase 5's size): guarded equal
    to unguarded on a clean batch (phase 8's rule), state untouched on a
    poisoned one, and the guarded peak within the largest leaf + 0.1 GiB
    of the unguarded (``flat``: within 0.1 GiB)."""
    import torch
    from repro_torch import configs, engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.engine import faults
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer

    out = {}
    args = train.build_parser().parse_args(MAIN_ARGV)
    cfg = train.build_config(args)
    opt = train.default_optimizer(args)
    plan = train.build_plan(cfg, args, opt, dev)
    exs = {g: train.build_executor(cfg, plan, args, opt, guard=g)
           for g in (False, True)}
    split = plan.split(LMDataset(cfg.vocab_size, args.seq, seed=0).batch(
        args.mini_batch, 0))
    with faults.inject(faults.FaultPlan(faults.nan_at(0, micro=1))):
        bad = _stage(faults.corrupt_batch(split, 0), dev)
    clean = _stage(split, dev)
    params = transformer.init_params(cfg, seed=0, device=dev)
    state = opt.init(params)
    params, state = exs[False].prepare(params, state)

    def step(guard, batch=clean):
        return exs[guard].step_split(params, state, batch)

    for g in (False, True):  # warm-up
        params, state, _ = step(g)
    secs = {False: [], True: []}
    # one timed step each (two each, in turns, until cut for the run's
    # time limit: the times are only printed)
    for g in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = step(g)
        torch.cuda.synchronize()
        secs[g].append(time.perf_counter() - t0)
    peaks = {g: _peak_above(dev, lambda g=g: step(g)) for g in (False, True)}

    # the mode must see a readback at all, or a count of 0 says nothing
    control = sync_calls(lambda: float(clean["sample_weight"].sum()))
    check(len(control) >= 1, "guard: the sync debug mode did not report a "
                             "host readback")
    sync = {g: sync_calls(lambda g=g: step(g)) for g in (False, True)}
    check(len(sync[True]) <= len(sync[False])
          and set(sync[True]) <= set(sync[False]),
          f"guard: the guarded flat step makes synchronizing calls the "
          f"unguarded does not: {sync[True]} vs {sync[False]}")
    check(abs(peaks[True] - peaks[False]) <= 0.1 * GIB,
          f"guard: guarded flat step peaks {peaks[True]} B above its base, "
          f"unguarded {peaks[False]} B (more than 0.1 GiB apart)")
    before = [t.clone() for t in _state_leaves(params, state)]
    params, state, m = step(True, bad)
    nonfinite = float(m["nonfinite"])
    untouched = all(torch.equal(a, b) for a, b in
                    zip(before, _state_leaves(params, state)))
    check(nonfinite == 1.0 and untouched,
          f"guard: the poisoned flat step (nonfinite {nonfinite}) left the "
          f"state {'untouched' if untouched else 'CHANGED'}")
    del before, m
    mean = {g: sum(v) / len(v) for g, v in secs.items()}
    out["flat_full_width"] = {
        "step_s": {"unguarded": secs[False], "guarded": secs[True]},
        "peak_above_state_bytes": {"unguarded": peaks[False],
                                   "guarded": peaks[True]},
        "sync_calls": {"unguarded": len(sync[False]),
                       "guarded": len(sync[True]),
                       "readback_control": len(control)},
        "poisoned_step_untouched": True, "plan": plan.describe()}
    print(f"guard (flat, full qwen2-1.5b, {plan.describe()}): step "
          f"unguarded {mean[False]:.4f} s, guarded {mean[True]:.4f} s (turns "
          f"{secs[False]} / {secs[True]}); peak above the state "
          f"{peaks[False]} / {peaks[True]} B; synchronizing calls "
          f"{len(sync[False])} / {len(sync[True])} "
          f"({sorted(set(sync[False]))}; a readback reports "
          f"{len(control)}); a step poisoned by faults.nan_at: nonfinite 1, every param and "
          f"momentum buffer and the step counter torch.equal to before",
          flush=True)
    del params, state, exs, clean, bad
    gc_collect()

    # the supervised launcher: a NaN at step 1, retried, against no fault
    argv = main_argv("--supervise", "--layers",
                     str(GUARD_SUPERVISED_LAYERS))
    ref = run_launcher(dev, argv)
    ref_host = _host(_state_leaves(ref["params"], ref["opt_state"]))
    ref_losses = ref["losses"]
    ref_anchor = ref["supervisor"]["anchors"]
    del ref
    gc_collect()
    with faults.inject(faults.FaultPlan(faults.nan_at(1))) as fp:
        got = run_launcher(dev, argv)
    recs = got["supervisor"]["faults"]
    check(fp.fired_kinds() == ["nan"] and len(recs) == 1
          and recs[0]["action"] == "retried ok (attempt 1)",
          f"guard: the supervised NaN run recorded {recs}")

    def redo():
        again = run_launcher(dev, argv)
        h = _host(_state_leaves(again["params"], again["opt_state"]))
        return h, again["losses"]
    same = _same_run("guard: the supervised run with a NaN retried",
                     ref_host, ref_losses,
                     _state_leaves(got["params"], got["opt_state"]),
                     got["losses"], redo)
    out["supervised_nan_retry"] = {
        "records": recs, "losses": got["losses"], "ref_losses": ref_losses,
        "anchors": ref_anchor, **same}
    print(f"guard: supervised launcher, NaN injected at step 1: {recs[0]}; "
          f"losses {got['losses']} vs unfaulted {ref_losses}; state "
          f"{'bit-identical' if same['bitwise'] else same}; anchors (host "
          f"copies) {ref_anchor}", flush=True)
    del got, ref_host
    gc_collect()

    # the four executors at 2 layers
    cfg2 = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=2)
    plan2 = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                            device=dev)
    loss_fn = steps.make_loss_fn(cfg2, dtype=torch.bfloat16,
                                 remat_policy="none")
    split2 = plan2.split(LMDataset(cfg2.vocab_size, 256, seed=0).batch(8, 0))
    with faults.inject(faults.FaultPlan(faults.nan_at(0, micro=2))):
        bad2 = _stage(faults.corrupt_batch(split2, 0), dev)
    clean2 = _stage(split2, dev)
    out["two_layers"] = {}
    largest = max(t.numel() * t.element_size() for t in tree.leaves(
        transformer.init_params(cfg2, seed=0, device=dev)))
    for name in ("compiled", "fused", "streaming", "flat"):
        def fresh(guard):
            o = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
            ex = engine.get_executor(name)(loss_fn, o, plan2, guard=guard)
            p = transformer.init_params(cfg2, seed=0, device=dev)
            s = o.init(p)
            if name == "flat":
                p, s = ex.prepare(p, s)
            return ex, p, s

        def run(guard, batch):
            ex, p, s = fresh(guard)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            p2, s2, m = ex.step_split(p, s, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            return _host(_state_leaves(p2, s2)), m, peak

        u_host, _, u_peak = run(False, clean2)
        g_host, gm, g_peak = run(True, clean2)
        same = all(torch.equal(a, b) for a, b in zip(u_host, g_host))
        if not same:
            again, _, _ = run(False, clean2)
            bound = max(float((a.double() - b.double()).abs().max())
                        for a, b in zip(u_host, again))
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(u_host, g_host))
            check(diff <= bound, f"guard ({name}, 2 layers): guarded differs "
                                 f"from unguarded by {diff:.3e}, two "
                                 f"unguarded steps by {bound:.3e}")
        check(float(gm["nonfinite"]) == 0.0,
              f"guard ({name}): a clean batch read as non-finite")
        ex, p, s = fresh(True)
        before = _host(_state_leaves(p, s))
        p2, s2, bm = ex.step_split(p, s, bad2)
        after = _host(_state_leaves(p2, s2))
        untouched = all(torch.equal(a, b) for a, b in zip(before, after))
        check(float(bm["nonfinite"]) == 1.0 and untouched,
              f"guard ({name}, 2 layers): the poisoned step left the state "
              f"{'untouched' if untouched else 'CHANGED'}")
        allowed = (0.1 * GIB if name == "flat" else largest + 0.1 * GIB)
        check(g_peak - u_peak <= allowed,
              f"guard ({name}, 2 layers): guarded peak {g_peak} B above the "
              f"state, unguarded {u_peak} B: more than {allowed:.0f} B apart")
        out["two_layers"][name] = {"bitwise": same, "peak_unguarded": u_peak,
                                   "peak_guarded": g_peak,
                                   "largest_leaf_bytes": largest}
        print(f"guard ({name}, qwen2-1.5b width, 2 layers): guarded == "
              f"unguarded on a clean batch "
              f"{'bit for bit' if same else '(within two runs)'}; poisoned "
              f"batch: nonfinite 1, state untouched; peak above the state "
              f"{u_peak} / {g_peak} B unguarded / guarded (allowed "
              f"+{allowed:.0f} B; largest leaf {largest} B)", flush=True)
        del ex, p, s, p2, s2, before, after
        gc_collect()
    return out


def sync_calls(fn) -> list:
    """The synchronizing calls ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them
    (``engine.steptrace.sync_calls``)."""
    from repro_torch.engine import steptrace
    return steptrace.sync_calls(fn)


def gc_collect() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _exit_code(argv) -> int:
    """``train.main(argv)``'s exit status (0 when it returns)."""
    from repro_torch.launch import train
    try:
        train.main(argv)
    except SystemExit as e:
        return e.code
    finally:
        gc_collect()
    return 0


def oom_ladder_phase(dev, state_bytes: int) -> dict:
    """13a. A real OOM climbs the ladder: the supervised launcher at full
    qwen2-1.5b, ``flat``, mini-batch 16 in one micro-batch, remat
    ``none``, the card's whole memory, 3 steps: every fault record (each a
    real ``torch.OutOfMemoryError``), the allocator's peaks at each
    failure, and what was allocated once the rebuilt runtime held the
    restored state, which must be no more than that state
    (``state_bytes``) and one staged batch above what was allocated before
    the run. The final plan run unsupervised gives the same losses and
    state (phase 8's rule); the same command with ``--max-restarts 0``
    exits 41."""
    from repro_torch.launch import train

    flags = ["--supervise", "--remat-policy", "none", "--max-restarts", "6"]
    argv = main_argv(*flags, microbatches=1)
    res = run_launcher(dev, argv)
    rep = res["supervisor"]
    recs = rep["faults"]
    base = res["allocated_before_bytes"]
    batch_bytes = 16 * 1024 * 4 * 3  # tokens, labels, sample weights
    check(rep["restarts"] >= 1 and all(
        r["kind"] == "oom" and r["detail"].startswith("OutOfMemoryError")
        and "injected" not in r["detail"] for r in recs),
        f"oom ladder: expected real OutOfMemoryErrors, got {recs}")
    for r in recs:
        excess = r["allocated_bytes"] - base - state_bytes
        check(excess <= batch_bytes + 64 * 2 ** 20,
              f"oom ladder: after the rebuild at '{r['action']}' "
              f"{r['allocated_bytes']} B allocated, {excess} B above the "
              f"base ({base} B) and the state ({state_bytes} B): a failed "
              f"step's tensors are left")
        r["excess_over_state_bytes"] = excess
    check(len(res["history"]) == 3, f"oom ladder: {len(res['history'])} "
                                    f"steps completed")
    final = res["plan"]
    sup_host = _host(_state_leaves(res["params"], res["opt_state"]))
    sup_losses = res["losses"]
    out = {"records": recs, "restarts": rep["restarts"],
           "steps_lost": rep["steps_lost"], "anchors": rep["anchors"],
           "final_plan": final.describe(), "losses": sup_losses,
           "peak_bytes": res["peak_bytes"],
           "peak_reserved_bytes": res["peak_reserved_bytes"],
           "wall_s": res["wall_s"]}
    for r in recs:
        print(f"oom ladder: OOM at step {r['step']}: {r['detail']!r}; "
              f"{r['action']}; {r['steps_lost']} steps replayed; recovery "
              f"{r['recovery_s']:.2f}s; peak allocated "
              f"{r['peak_allocated_bytes']} B, reserved "
              f"{r['peak_reserved_bytes']} B at the failure; after the "
              f"rebuild allocated {r['allocated_bytes']} B ("
              f"{r['excess_over_state_bytes']} B above base + state), "
              f"reserved {r['reserved_bytes']} B", flush=True)
    print(f"oom ladder: done after {rep['restarts']} restarts, "
          f"{rep['steps_lost']} steps lost: {final.describe()}; losses "
          f"{sup_losses}; the recovered plan's peak allocated "
          f"{res['peak_bytes']} B, reserved {res['peak_reserved_bytes']} B; "
          f"anchors {rep['anchors']}; wall {res['wall_s']:.1f}s", flush=True)
    del res
    gc_collect()
    n_s = final.num_micro_batches
    plain = main_argv("--remat-policy", final.remat_policy, microbatches=n_s)

    def run_plain():
        r = run_launcher(dev, plain)
        check(r["plan"].micro_batch_size == final.micro_batch_size,
              f"oom ladder: the unsupervised rerun planned "
              f"{r['plan'].describe()}")
        h = _host(_state_leaves(r["params"], r["opt_state"]))
        return h, r["losses"], r

    plain_host, plain_losses, r = run_plain()
    del r
    gc_collect()

    def redo():
        h, losses, r = run_plain()
        del r
        return h, losses
    same = _same_run("oom ladder: the supervised run against the final "
                     "plan run unsupervised", plain_host, plain_losses,
                     sup_host, sup_losses, redo)
    del sup_host, plain_host
    gc_collect()
    out["unsupervised_losses"] = plain_losses
    out.update(same)
    code = _exit_code(main_argv("--supervise", "--remat-policy", "none",
                                "--max-restarts", "0", microbatches=1))
    check(code == 41, f"oom ladder: --max-restarts 0 exited {code}, not 41 "
                      f"(RestartBudgetExceeded)")
    out["max_restarts_0_exit"] = code
    print(f"oom ladder: the final plan unsupervised: losses {plain_losses}; "
          f"state {'bit-identical' if same['bitwise'] else same}; "
          f"--max-restarts 0 exits {code}", flush=True)
    return out


def calibration_miss_phase(dev, calibration: dict) -> dict:
    """13b. A calibration miss recovered by the supervisor: ``streaming``
    under ``--calibrate auto`` with phase 7a's cache, whose entry is set
    back to the fit the reference's loop leaves — the line through 7a's
    probes at micro 1, 2 and 4 alone, without the planner's back-off
    probes (ROADMAP queue 3 fault 1, which that back-off repairs) — the
    allocator capped at a budget worked out from those probes (the fit
    admits micro m, while the line through the two backward-bound probes
    puts m's real peak clear above the budget), 2 supervised steps. One
    OOM record, the negative bound in the cache file, the recovered
    plan's peak under the cap, and a second ``--calibrate auto`` plan
    under the same key that no longer admits the (remat, micro) that
    failed. If no budget provokes the miss, the OOM is injected with
    ``faults.oom_at`` instead, and the line says so."""
    import torch
    from repro_torch import engine, optim
    from repro_torch.core import memory_model
    from repro_torch.engine import autotune, faults
    from repro_torch.launch import train

    cache = os.path.join(ROOT, "build", "tuning.json")
    rec7a = calibration["streaming"]
    # (micro, modeled, measured) of the reference's probes, and their fit
    probes = sorted(p for p in rec7a["probes"] if p[0] in (1, 2, 4))
    a, b = autotune._fit_affine([(mod, meas) for _, mod, meas in probes])
    (m_lo, _, y_lo), (m_hi, _, y_hi) = probes[-2], probes[-1]
    slope = (y_hi - y_lo) / (m_hi - m_lo)
    argv = main_argv("--supervise", "--tuning-cache", cache, steps=2,
                     executor="streaming")
    i = argv.index("--microbatches")
    del argv[i:i + 2]
    ap = train.build_parser()
    args = ap.parse_args(argv)
    cfg = train.build_config(args)
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    est = memory_model.estimate(cfg, args.seq, act_bytes=2,
                                remat_policy=rec7a["analytic_policy"],
                                **optim.memory_model_kw(opt))

    def pred(m):
        return a * est.total(m) + b

    def real(m):
        return y_lo + (m - m_lo) * slope

    total = torch.cuda.get_device_properties(dev).total_memory
    budget = micro = None
    for m in range(2, 16):
        top = min(pred(m + 1), real(m))
        if real(m) - pred(m) >= 3 * GIB and pred(m) + 0.25 * (
                top - pred(m)) < total - 4 * GIB:
            micro, budget = m, int(pred(m) + 0.25 * (top - pred(m)))
            break
    check(budget is not None, f"calibration miss: no micro size where the "
                              f"fit under-predicts the backward line by 3 GiB"
                              f" (fit {a}, {b}; probes {probes})")
    budget_gb = budget / GIB
    argv += ["--hbm-budget-gb", repr(budget_gb)]
    autotune.get_cache(cache).put_memory(autotune.memory_key(
        cfg, args.seq, rec7a["analytic_policy"], None, "sgd", "streaming",
        autotune.backend_of(dev)), a, b, probes)
    plan0 = train.build_plan(cfg, ap.parse_args(argv), opt, dev)
    engine.set_cache_path(None)
    check(plan0.calibrated and plan0.micro_batch_size == micro,
          f"calibration miss: at {budget_gb:.3f} GiB the planner admits "
          f"{plan0.describe()}, expected calibrated micro {micro}")
    key = autotune.memory_key(cfg, args.seq, plan0.remat_policy, None, "sgd",
                              "streaming", autotune.backend_of(dev))
    print(f"calibration miss: 7a's streaming fit measured = {a:.6f} x "
          f"modeled + {b:.0f} B predicts micro {micro} at {pred(micro)} B, "
          f"the line through probes {m_lo} and {m_hi} puts it at "
          f"{real(micro):.0f} B; budget and allocator cap {budget} B "
          f"({budget_gb:.3f} GiB): {plan0.describe()}", flush=True)
    torch.cuda.set_per_process_memory_fraction(budget / total, dev)
    injected = False
    try:
        res = run_launcher(dev, argv)
        recs = res["supervisor"]["faults"]
        if not recs:
            injected = True
            print(f"calibration miss: the budget did not provoke the miss "
                  f"(no OOM at micro {micro}); injecting it with "
                  f"faults.oom_at instead", flush=True)
            del res
            gc_collect()
            with faults.inject(faults.FaultPlan(faults.oom_at(
                    0, times=99, min_micro=micro))):
                res = run_launcher(dev, argv)
            recs = res["supervisor"]["faults"]
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        engine.set_cache_path(None)
    ooms = [r for r in recs if r["kind"] == "oom"]
    with open(cache) as f:
        entry = json.load(f)["memory"][key]
    bound = entry["a"] * est.total(micro) + entry["b"]
    check(len(ooms) == 1, f"calibration miss: {len(ooms)} OOM records, "
                          f"expected one: {ooms}")
    check(bound > budget, f"calibration miss: the cache's corrected bytes "
                          f"at micro {micro} ({bound}) still fit the budget")
    peak = res["peak_bytes"]
    check(peak <= budget and len(res["history"]) == 2,
          f"calibration miss: the recovered plan peaked at {peak} B over "
          f"the {budget} B cap, or ran {len(res['history'])} steps")
    again = train.build_plan(cfg, ap.parse_args(argv), opt, dev)
    engine.set_cache_path(None)
    check((again.remat_policy, again.micro_batch_size)
          != (plan0.remat_policy, micro),
          f"calibration miss: a second --calibrate auto launch still admits "
          f"{again.describe()}")
    out = {"budget_bytes": budget, "micro": micro,
           "predicted_bytes": pred(micro), "backward_line_bytes": real(micro),
           "injected": injected, "records": recs,
           "bound": [entry["a"], entry["b"]], "corrected_bytes": bound,
           "final_plan": res["plan"].describe(), "losses": res["losses"],
           "peak_bytes": peak,
           "peak_reserved_bytes": res["peak_reserved_bytes"],
           "second_plan": again.describe()}
    for r in ooms:
        print(f"calibration miss: OOM at step {r['step']}: {r['detail']!r}; "
              f"{r['action']}; peak allocated {r['peak_allocated_bytes']} B, "
              f"reserved {r['peak_reserved_bytes']} B at the failure; after "
              f"the rebuild {r['allocated_bytes']} / {r['reserved_bytes']} B",
              flush=True)
    print(f"calibration miss: recovered to {res['plan'].describe()}; 2 "
          f"steps, losses {res['losses']}; peak allocated {peak} B, reserved "
          f"{res['peak_reserved_bytes']} B under the {budget} B cap; the "
          f"cache's bound (a, b) = ({entry['a']}, {entry['b']}) corrects "
          f"micro {micro} to {bound:.0f} B; a second --calibrate auto plan: "
          f"{again.describe()}", flush=True)
    del res
    gc_collect()
    return out


# ---------------------------------------------------------------------------
# 14. serving: KV-slot admission, prefill and decode, continuous batching
# ---------------------------------------------------------------------------

# the serve launcher's arguments per model, and what the JAX package's
# arithmetic admits for them: (slots, prefill micro, slot bytes, prefill
# bytes per sample). The new-token counts set the decode steps, which set
# the phases' seconds (14a, 14b, 15d, 22b): 16 to 64 (gemma2 8 to 32;
# moonshot 16 or 32), a quarter of the 64 to 256 they once were, cut for
# the run's time limit
SERVE_ARGV = {
    "qwen2-1.5b": ["--arch", "qwen2-1.5b", "--dtype", "bfloat16",
                   "--budget", "10", "--max-len", "2048", "--requests", "64",
                   "--rate", "32", "--prompt-lens", "128,512,1024",
                   "--new-tokens", "16,64", "--temperature", "0"],
    "gemma2-9b": ["--arch", "gemma2-9b", "--dtype", "bfloat16",
                  "--budget", "64", "--max-len", "8192", "--requests", "8",
                  "--rate", "4", "--prompt-lens", "1024,4608",
                  "--new-tokens", "8,32", "--temperature", "0"],
    # 15d: the state and MoE families, exact-length prefill groups
    "mamba2-780m": ["--arch", "mamba2-780m", "--dtype", "bfloat16",
                    "--budget", "10", "--max-len", "2048", "--requests",
                    "64", "--rate", "32", "--prompt-lens", "128,512,1024",
                    "--new-tokens", "16,64", "--temperature", "0"],
    "recurrentgemma-2b": ["--arch", "recurrentgemma-2b", "--dtype",
                          "bfloat16", "--budget", "24", "--max-len", "4096",
                          "--requests", "64", "--rate", "32",
                          "--prompt-lens", "128,512,1024", "--new-tokens",
                          "16,64", "--temperature", "0"],
    "moonshot-v1-16b-a3b": ["--arch", "moonshot-v1-16b-a3b", "--layers", "4",
                            "--dtype", "bfloat16", "--budget", "32",
                            "--max-len", "2048", "--requests", "16",
                            "--rate", "8", "--prompt-lens", "128,512",
                            "--new-tokens", "16,32", "--temperature", "0"],
}
# slots, prefill micro, kv_slot_bytes, prefill bytes a sample: the plan the
# reference's arithmetic gives (tests/test_torch_serving.py pins the
# families' too)
SERVE_PLANS = {"qwen2-1.5b": (51, 8, 58_949_632, 182_240_768),
               "gemma2-9b": (8, 4, 2_114_961_408, 3_642_712_064),
               "mamba2-780m": (84, 8, 76_455_936, 139_571_616),
               "recurrentgemma-2b": (256, 4, 17_303_552, 2_513_938_432),
               "moonshot-v1-16b-a3b": (256, 8, 67_141_632, 214_335_488)}
# 14c: fp32 logits of two computations of the same function in another
# summation order (cuBLAS picks other algorithms for other shapes)
SERVE_ATOL = 1e-3


def serve_phase(dev, arch: str) -> dict:
    """14a / 14b. ``repro_torch.launch.serve.main`` at full width with the
    launch counters and the allocator's peak reset just before it and
    read just after: the plan equal to SERVE_PLANS and to the serving
    memory model evaluated on its own (the largest slot count whose
    modeled peak fits), every request finished with exactly its clamped
    ``max_new_tokens`` (the stream regenerated from its seed), every
    token inside the vocabulary, the pool all free at the end; prefill
    latency, decode tokens/s, ITL and TTFT, the peak concurrency, the
    allocator's peak beside the modeled peak and the budget (a peak over
    the budget is reported, not hidden). Then, on the same engine with
    requests admitted, one decode step traced by ``torch.profiler`` (its
    kernels and the device's busy span) and one under the sync debug
    mode (one synchronizing call expected: the readback of the next
    tokens)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import memory_model
    from repro_torch.engine import serving
    from repro_torch.launch import serve

    argv = SERVE_ARGV[arch]
    args = serve.build_parser().parse_args(argv)
    gc_collect()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.main(argv)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    plan, cfg, rep, eng = (res["plan"], res["config"], res["report"],
                           res["engine"])
    reqs = res["requests"]
    want = SERVE_PLANS[arch]
    got = (plan.max_decode_slots, plan.prefill_micro, plan.kv_slot_bytes,
           plan.prefill_bytes_per_sample)
    check(got == want, f"serve {arch}: plan {got}, the reference's "
                       f"arithmetic gives {want}")
    est = memory_model.serve_estimate(cfg, args.max_len, cache_bytes=2)
    budget = int(args.budget * GIB)
    s, m = plan.max_decode_slots, plan.prefill_micro
    check(est.total(s, m) == plan.modeled_peak_bytes() <= budget
          and (s == 256 or budget < est.total(s + 1, m)),  # slot_cap 256
          f"serve {arch}: {s} slots at micro {m} is not the largest count "
          f"the memory model fits in {budget} B")
    stream = list(serving.synthetic_traffic(
        args.requests, rate_rps=args.rate, prompt_lens=args.prompt_lens,
        new_tokens=args.new_tokens, vocab_size=cfg.vocab_size,
        seed=args.seed + 1))
    check(len(reqs) == args.requests and all(
        r.state == serving.FINISHED
        and len(r.tokens) == min(o.max_new_tokens, args.max_len
                                 - o.prompt_len)
        and all(0 <= t < cfg.vocab_size for t in r.tokens)
        for r, o in zip(reqs, stream)),
        f"serve {arch}: a request did not finish with exactly its clamped "
        f"max_new_tokens in-vocabulary tokens")
    check(rep["requests"]["finished"] == args.requests
          and eng.pool.free_count == s and not eng._by_slot,
          f"serve {arch}: pool not all free at the end "
          f"({eng.pool.free_count} of {s})")
    check(rep["decode"]["tokens"] == sum(len(r.tokens) - 1 for r in reqs),
          f"serve {arch}: decode tokens miscounted")
    pf, dec = rep["prefill"], rep["decode"]
    card = card_line()
    print(f"serve {arch} [{card}]: {plan.describe()}", flush=True)
    print(f"serve {arch}: {args.requests} requests finished in {wall:.1f}s "
          f"(warmup {rep['warmup_s']:.2f}s excluded from the rates); "
          f"prefill {pf['batches']} micro-batches, {pf['prompt_tokens']} "
          f"prompt tokens, latency p50 {pf['latency_s']['p50'] * 1e3:.2f} "
          f"ms max {pf['latency_s']['max'] * 1e3:.2f} ms; decode "
          f"{dec['tokens']} tokens in {dec['time_s']:.3f}s over "
          f"{dec['steps']} steps = {dec['tokens_per_s']:.1f} tokens/s; ITL "
          f"p50 {dec['itl_s']['p50'] * 1e3:.2f} ms p99 "
          f"{dec['itl_s']['p99'] * 1e3:.2f} ms; TTFT p50 "
          f"{rep['ttft_s']['p50'] * 1e3:.1f} ms p99 "
          f"{rep['ttft_s']['p99'] * 1e3:.1f} ms; peak concurrency "
          f"{rep['slots']['max_concurrent']} of {s} (mean active "
          f"{rep['slots']['mean_active_per_step']:.2f}); K1-K6 launches "
          f"{counts}", flush=True)
    over = peak - budget
    modeled = plan.modeled_peak_bytes()
    print(f"serve {arch}: max_memory_allocated {peak} B ({peak / GIB:.3f} "
          f"GiB; {base} B allocated before) vs modeled peak {modeled} B "
          f"({modeled / GIB:.3f} GiB) and budget {budget} B ({args.budget} "
          f"GiB): "
          + (f"OVER the budget by {over} B" if over > 0
             else f"{-over} B under the budget")
          + f"; reserved {peak_reserved} B; pool {eng.pool.bytes()} B",
          flush=True)

    # one decode step, traced and under the sync debug mode, with the
    # first prefill micro-batch of the stream admitted
    for r in stream[:plan.prefill_micro]:
        eng.submit(r)
    eng._prefill_group(eng._next_group(), 0.0)
    eng._decode_once(0.0)  # warm
    trace = os.path.join(ROOT, "build", f"serve-{arch}-trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_s = eng._decode_once(0.0)
    prof.export_chrome_trace(trace)
    tr = _trace_streams(trace)
    os.remove(trace)
    launches = sum(tr["kernel_streams"].values())
    syncs = sync_calls(lambda: eng._decode_once(0.0))
    check(len(syncs) == 1,
          f"serve {arch}: a decode step made {len(syncs)} synchronizing "
          f"calls, expected 1 (the next tokens' readback): {syncs}")
    step_untraced = eng._decode_once(0.0)
    print(f"serve {arch}: one decode step over the {s}-slot pool: "
          f"{launches} kernel launches, kernels {tr['kernel_ms']:.3f} ms of a "
          f"{tr['device_span_ms']:.3f} ms device span (step {step_s * 1e3:.3f}"
          f" ms traced, {step_untraced * 1e3:.3f} ms untraced); "
          f"synchronizing calls {len(syncs)} ({syncs}); kernels by time "
          f"{tr['kernels_ms']}; runtime calls {tr['runtime_ms']}",
          flush=True)
    out = {
        "card": card, "plan": plan.describe(), "plan_fields": list(got),
        "budget_bytes": budget, "modeled_peak_bytes":
            plan.modeled_peak_bytes(), "peak_bytes": peak,
        "peak_reserved_bytes": peak_reserved, "allocated_before_bytes": base,
        "over_budget_bytes": max(over, 0), "pool_bytes": eng.pool.bytes(),
        "wall_s": wall, "report": rep, "counts": counts,
        "decode_step_launches": launches,
        "decode_step_kernel_ms": tr["kernel_ms"],
        "decode_step_device_span_ms": tr["device_span_ms"],
        "decode_step_traced_s": step_s, "decode_step_s": step_untraced,
        "decode_step_sync_calls": len(syncs)}
    del res, eng, reqs, prof
    gc_collect()
    return out


def _record_logits(eng) -> dict:
    """Wrap an engine's prefill and decode calls to keep, per request id,
    the logits row each of its tokens was sampled from (on the host)."""
    rows, group = {}, []
    real_group, real_prefill, real_decode = (
        eng._prefill_group, eng._prefill, eng._decode_logits)

    def prefill_group(g, now):
        group[:] = g
        return real_group(g, now)

    def prefill(toks, lengths):
        logits, cache = real_prefill(toks, lengths)
        for i, r in enumerate(group):
            rows.setdefault(r.rid, []).append(logits[i].cpu())
        return logits, cache

    def decode_logits():
        logits = real_decode()
        for slot, r in eng._by_slot.items():
            rows[r.rid].append(logits[slot].cpu())
        return logits

    eng._prefill_group, eng._prefill = prefill_group, prefill
    eng._decode_logits = decode_logits
    return rows


def _ragged_vs_exact(params, cfg, lengths, gen, dev) -> float:
    """Largest logits difference of a right-padded ragged prefill (and one
    decode step after it) from each row's exact-length prefill."""
    import torch
    from repro_torch.models import transformer

    f32 = torch.float32
    pad = 16 * math.ceil(max(lengths) / 16)
    rows = [torch.from_numpy(gen.integers(0, cfg.vocab_size, (L,))).to(dev)
            for L in lengths]
    padded = torch.zeros((len(rows), pad), dtype=torch.long, device=dev)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    L = torch.tensor(lengths, device=dev)
    nxt = torch.from_numpy(gen.integers(0, cfg.vocab_size,
                                        (len(rows), 1))).to(dev)
    last_r, cache_r = transformer.prefill(params, cfg, padded, pad + 8,
                                          dtype=f32, lengths=L)
    lg_r, _ = transformer.decode_step(params, cfg, nxt, cache_r,
                                      L.to(torch.int32), dtype=f32)
    rag = 0.0
    for i, r in enumerate(rows):
        last_e, cache_e = transformer.prefill(params, cfg, r[None], pad + 8,
                                              dtype=f32)
        lg_e, _ = transformer.decode_step(
            params, cfg, nxt[i:i + 1], cache_e, L[i:i + 1].to(torch.int32),
            dtype=f32)
        rag = max(rag, float((last_r[i] - last_e[0]).abs().max()),
                  float((lg_r[i] - lg_e[0]).abs().max()))
        del cache_e
    return rag


# 14c / 15e: correctness at 2 layers of each width (the hybrid at 3, its
# (recurrent, recurrent, local) period), fp32: config changes, the
# (prompt, end) of each prefill + decode case, the ragged rows (None: the
# family prefills exact-length groups only), the engine's prompt lengths.
# moonshot's capacity factor is E, so that no token drops: capacity is
# per call, and a prefill routes another batch than forward does.
SERVE_CHECKS = {
    "qwen2-1.5b": (dict(num_layers=2), [(1000, 1100)], [100, 1000, 517],
                   (40, 700, 1000)),
    "gemma2-9b": (dict(num_layers=2), [(4040, 4160), (4400, 4408)],
                  [700, 4500, 2000], (300, 4090, 4200)),
    "mamba2-780m": (dict(num_layers=2), [(1000, 1100)], None,
                    (40, 700, 1000)),
    "recurrentgemma-2b": (dict(num_layers=3, layer_pattern=(
        "recurrent", "recurrent", "local")), [(2000, 2100), (2400, 2408)],
        None, (300, 2040, 2200)),
    "moonshot-v1-16b-a3b": (dict(num_layers=2, capacity_factor=64.0),
                            [(1000, 1100)], None, (40, 700, 1000)),
    # 17c: the VLM served text-only, as the reference serves it
    "qwen2-vl-72b": (dict(num_layers=2), [(1000, 1100)], [100, 1000, 517],
                     (40, 700, 1000)),
}


def serve_correctness_phase(dev, arch: str) -> dict:
    """14c / 15e. At ``SERVE_CHECKS``' depth of ``arch``'s full width,
    fp32, TF32 off, random weights from seed 0, within SERVE_ATOL on the
    logits: prefill followed by teacher-forced decode against
    ``forward``'s logits at every position (gemma2-9b and
    recurrentgemma-2b: one prompt whose decode crosses the window, one
    longer than it); for the ragged families, right-padded prefill
    against exact prefill row by row, and one decode step after; the
    engine's continuous batching (4 slots, prefill micro 2; the state and
    MoE families in exact-length groups) against a one-request-at-a-time
    teacher-forced decode of each request's own tokens, with how many
    tokens agree (a token must agree wherever the single decode's top-2
    margin exceeds twice the tolerance)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.engine import serving
    from repro_torch.models import transformer

    f32 = torch.float32
    changes, cases, lengths, prompt_lens = SERVE_CHECKS[arch]
    cfg = dataclasses.replace(configs.get(arch), **changes)
    params = transformer.init_params(cfg, seed=0, device=dev)
    gen = np.random.default_rng(0)
    out = {"atol": SERVE_ATOL, "layers": cfg.num_layers}

    def head(x):
        return transformer._lm_head(params, cfg, x)

    # prefill + teacher-forced decode against forward
    errs = []
    for prompt, total in cases:
        toks = torch.from_numpy(gen.integers(0, cfg.vocab_size, (2, total))
                                ).to(dev)
        with torch.inference_mode():
            hid, _ = transformer.forward(params, cfg, toks, dtype=f32,
                                         remat=False, return_hidden=True)
            want = head(hid[:, prompt - 1:])
            del hid
        last, cache = transformer.prefill(params, cfg, toks[:, :prompt],
                                          total, dtype=f32)
        err = float((last - want[:, 0]).abs().max())
        for t in range(prompt, total):
            pos = torch.full((2,), t, dtype=torch.int32, device=dev)
            lg, cache = transformer.decode_step(params, cfg,
                                                toks[:, t:t + 1], cache, pos,
                                                dtype=f32)
            err = max(err, float((lg[:, 0] - want[:, t - prompt + 1]
                                  ).abs().max()))
        errs.append(err)
        check(err <= SERVE_ATOL,
              f"serve {arch} ({cfg.num_layers} layers): prefill {prompt} + "
              f"decode to "
              f"{total} differs from forward by {err:.3e}")
        del cache, want
    out["decode_vs_forward_max_err"] = errs

    # ragged prefill against exact prefill, row by row
    rag = None
    if lengths is not None:
        rag = _ragged_vs_exact(params, cfg, lengths, gen, dev)
        check(rag <= SERVE_ATOL, f"serve {arch}: ragged prefill differs "
                                 f"from exact by {rag:.3e}")
    out["ragged_vs_exact_max_err"] = rag

    # the engine against one request at a time
    max_len = max(prompt_lens) + 24
    plan = serving.plan_serve(cfg, budget_bytes=60 * GIB, max_len=max_len,
                              max_slots=4, prefill_micro=2, cache_bytes=4)
    eng = serving.ServingEngine(params, cfg, plan, dtype=f32,
                                cache_dtype=f32)
    rows = _record_logits(eng)
    reqs = list(serving.synthetic_traffic(
        10, rate_rps=1e4, prompt_lens=prompt_lens, new_tokens=(8, 16),
        vocab_size=cfg.vocab_size, seed=3))
    rep = eng.run(reqs, warmup_prompt_lens=prompt_lens)
    check(rep["requests"]["finished"] == len(reqs)
          and eng.pool.free_count == 4,
          f"serve {arch}: the engine left requests or slots")
    err, agree, decided, total = 0.0, 0, 0, 0
    for r in reqs:
        last, cache = transformer.prefill(
            params, cfg, torch.from_numpy(r.prompt[None]).to(dev), max_len,
            dtype=f32)
        single = [last[0]]
        for i, tok in enumerate(r.tokens[:-1]):
            lg, cache = transformer.decode_step(
                params, cfg, torch.tensor([[tok]], device=dev), cache,
                torch.tensor([r.prompt_len + i], dtype=torch.int32,
                             device=dev), dtype=f32)
            single.append(lg[0, 0])
        single = torch.stack(single).cpu()
        batched = torch.stack(rows[r.rid])
        check(batched.shape == single.shape,
              f"serve {arch}: request {r.rid} has {batched.shape[0]} engine "
              f"logits rows for {single.shape[0]} tokens")
        err = max(err, float((batched - single).abs().max()))
        top2 = single.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * SERVE_ATOL
        same = single.argmax(-1) == torch.tensor(r.tokens)
        agree += int(same.sum())
        decided += int(sure.sum())
        check(bool(same[sure].all()),
              f"serve {arch}: request {r.rid}'s engine tokens differ from "
              f"the single decode where its margin is clear")
        total += len(r.tokens)
        del cache
    check(err <= SERVE_ATOL, f"serve {arch}: the engine's logits differ "
                             f"from one request at a time by {err:.3e}")
    out.update(engine_vs_single_max_err=err, tokens=total,
               tokens_agree=agree, tokens_clear_margin=decided,
               engine_decode_steps=rep["decode"]["steps"],
               engine_prefill_batches=rep["prefill"]["batches"])
    ragged = ("exact-length groups only" if rag is None else
              f"ragged vs exact prefill (lengths {lengths}) {rag:.3e}")
    print(f"serve {arch} ({cfg.num_layers} layers, fp32, TF32 off, atol "
          f"{SERVE_ATOL}): prefill + teacher-forced decode vs forward max "
          f"err {errs} over prompts/ends {cases}; {ragged}; engine (4 slots, "
          f"micro 2, {'ragged' if plan.ragged_prefill else 'exact-length'}, "
          f"{len(reqs)} "
          f"requests, {rep['decode']['steps']} steps) vs one request at a "
          f"time {err:.3e}, tokens agreeing {agree} of {total} ({decided} "
          f"with a clear margin)", flush=True)
    del eng, params, rows
    gc_collect()
    return out


# ---------------------------------------------------------------------------
# 15a-15c, 15e: the ssm, hybrid and MoE families on the training path
# ---------------------------------------------------------------------------

# arch: the launcher's flags beyond FAMILY_ARGV (full width; moonshot's
# depth cut to 4 of its 48 layers: 48 would be ~64 GB of fp32 params)
FAMILY_TRAIN = {
    # mamba2's depth cut to 6 of its 48 layers (chip_smoke's time limit)
    "mamba2-780m": ["--seq", "4096", "--mini-batch", "16", "--layers", "6"],
    "recurrentgemma-2b": ["--seq", "2048", "--mini-batch", "8"],
    "moonshot-v1-16b-a3b": ["--seq", "2048", "--mini-batch", "8",
                            "--layers", "4"],
}
FAMILY_STEPS = 3
FAMILY_ARGV = ["--executor", "flat", "--dtype", "bfloat16", "--steps",
               str(FAMILY_STEPS), "--log-every", "1"]
# a calibrated plan that admits no micro-batch at the 60 GiB budget gets
# the least budget, in quarter GiB, up to this one that admits one
FAMILY_MAX_BUDGET_GB = 72


def _route_recorder():
    """Wrap ``moe.route`` to keep each call's (dropped, routed) counts on
    the card; returns (records, undo)."""
    from repro_torch.models import moe
    real, records = moe.route, []

    def route(p, cfg, xt, blocks=None):
        out = real(p, cfg, xt, blocks)
        keep = out[2].detach()
        records.append(((~keep).sum(), keep.numel()))
        return out

    moe.route = route

    def undo():
        moe.route = real
    return records, undo


def _k1_groups(params) -> int:
    """K1 launches a micro-batch: one per group of at most MAX_ENTRIES
    (accumulator, gradient) pairs of one dtype pair."""
    from repro_torch import kernels, tree
    return len(kernels.grad_accum_kernels.launch_groups(
        [(x, x) for x in tree.leaves(params)]))


def _trace_micro(dev, cfg, params, plan, seq: int) -> dict:
    """One micro-batch's forward and backward (the plan's micro size and
    remat policy, bf16) traced by ``torch.profiler`` after one untraced
    warm-up: the kernels' summed time against the device span and the
    host's time, the launches, the kernels and runtime calls that take
    the most time (the trace is written under ``build/`` and removed)."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps

    loss_fn = steps.make_loss_fn(cfg, dtype=torch.bfloat16,
                                 remat_policy=plan.remat_policy)
    # the family's batch: LMDataset tokens (a VLM text-only, as the
    # launcher feeds it), an enc-dec config's frames and target tokens
    mb = {k: torch.from_numpy(v).to(dev) for k, v in steps.family_batch(
        cfg, seq, plan.micro_batch_size, seed=0, vision=False).items()}
    leaves, td = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]

    def once():
        loss, _ = loss_fn(tree.unflatten(td, leaves), mb)
        # a text-only VLM batch leaves vision_proj out of the graph
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        del grads

    once()
    path = os.path.join(ROOT, "build", f"micro-{cfg.name}-trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        once()
    host_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    tr = _trace_streams(path)
    os.remove(path)
    del prof, leaves, mb
    gc_collect()
    out = {"micro": plan.micro_batch_size, "remat": plan.remat_policy,
           "launches": sum(tr["kernel_streams"].values()),
           "kernel_ms": tr["kernel_ms"],
           "device_span_ms": tr["device_span_ms"], "host_s": host_s,
           "kernels_ms": tr["kernels_ms"], "runtime_ms": tr["runtime_ms"]}
    print(f"train {cfg.name}: one micro-batch of {out['micro']} (remat "
          f"{out['remat']}) forward + backward, traced: {out['launches']} "
          f"launches, kernels {out['kernel_ms']:.1f} ms of a "
          f"{out['device_span_ms']:.1f} ms device span ({host_s:.2f}s on the "
          f"host, traced); kernels by time {out['kernels_ms']}; runtime "
          f"calls {out['runtime_ms']}", flush=True)
    return out


def probe_ooms(cache: str, cfg, seq: int, dev) -> list:
    """The policies whose calibration probe did not fit the card, as the
    planner recorded them in the tuning entries of ``cache`` (flat, SGD-m,
    one device), each printed."""
    from repro_torch.engine import autotune
    from repro_torch.models import remat

    out = []
    for pol in remat.POLICIES:
        oom = autotune.get_cache(cache).memory_oom(autotune.memory_key(
            cfg, seq, pol, None, "sgd", "flat", autotune.backend_of(dev)))
        if oom is not None:
            out.append({"policy": pol, **oom})
            print(f"train {cfg.name}: the calibration probe at micro "
                  f"{oom['micro']} under remat {pol} does not fit the card: "
                  f"{oom['error']}", flush=True)
    return out


def family_train_phase(dev, arch: str, train_flags=None, drive=None
                       ) -> dict:
    """15a-15c, 17a, 17b. ``launch.train.main`` for ``arch`` at full width
    (FAMILY_TRAIN, or ``train_flags``), ``flat``, SGD-m, bf16 over fp32
    weights, seed 0,
    against CALIBRATION_BUDGET_GB: the analytic plan (``--calibrate off``,
    not run); ``--calibrate force --remat-policy auto``, probing the real
    step at micro 1, 2 and 4 under the analytic plan's policy — a probe
    that does not fit the card rules its policy out and the planner
    climbs the lattice itself (the tuning entries' ``oom`` records are
    printed), then probes the admitted size once and steps down while its
    measured peak is over the budget;
    when the fit admits no micro-batch at the budget, the least budget up
    to FAMILY_MAX_BUDGET_GB that does; then ``--calibrate auto`` at that
    budget (which must plan what ``force`` planned) for FAMILY_STEPS steps
    with the counters zeroed around it: every loss finite, K1 launched
    steps × N_Sμ × launch groups times and K2 steps × buckets; the steady
    step and tokens/s;
    the allocator's peak beside the budget and the calibrated prediction
    (a peak over the budget is reported, not hidden); one micro-batch's
    forward and backward traced (``_trace_micro``). MoE: the aux loss of
    step 0 and the share of routed (token, expert) choices that the
    capacity dropped in step 0. ``drive(dev, argv)`` replaces the
    launcher's run (17a's ``run_executor``: the enc-dec, which the
    launcher refuses) and returns what :func:`run_launcher` does."""
    import torch
    from repro_torch import optim
    from repro_torch.core import memory_model
    from repro_torch.engine import FlatSpec, autotune
    from repro_torch.launch import train

    cache = os.path.join(ROOT, "build", f"tuning-{arch}.json")
    if os.path.exists(cache):
        os.remove(cache)
    autotune._caches.pop(cache, None)
    if train_flags is None:
        train_flags = FAMILY_TRAIN[arch]
    base = ["--arch", arch, *FAMILY_ARGV, *train_flags, "--tuning-cache",
            cache]
    ap = train.build_parser()
    args0 = ap.parse_args(base)
    cfg, seq, mini = train.build_config(args0), args0.seq, args0.mini_batch
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    mm_kw = optim.memory_model_kw(opt, fused=True)

    def flags(calibrate, policy, budget_gb):
        return base + ["--calibrate", calibrate, "--remat-policy", policy,
                       "--hbm-budget-gb", str(budget_gb)]

    def plan(calibrate, policy="auto", budget_gb=CALIBRATION_BUDGET_GB):
        return train.build_plan(cfg, ap.parse_args(
            flags(calibrate, policy, budget_gb)), opt, dev)

    def modeled(p, micro=None):
        return memory_model.estimate(
            cfg, seq, act_bytes=2, remat_policy=p.remat_policy,
            **mm_kw).total(p.micro_batch_size if micro is None else micro)

    card = card_line()
    analytic = plan("off")
    print(f"train {arch} [{card}]: analytic plan at "
          f"{CALIBRATION_BUDGET_GB} GiB: {analytic.describe()}; modeled "
          f"{modeled(analytic) / GIB:.3f} GiB (not run)", flush=True)
    out = {"card": card, "analytic_plan": analytic.describe(),
           "analytic_micro": analytic.micro_batch_size,
           "analytic_policy": analytic.remat_policy,
           "analytic_modeled_bytes": modeled(analytic), "probe_ooms": []}
    policy = "auto"
    t0 = time.perf_counter()
    forced = plan("force", policy)
    out["probe_s"] = time.perf_counter() - t0
    gc_collect()
    out["probe_ooms"] = probe_ooms(cache, cfg, seq, dev)
    key = autotune.memory_key(cfg, seq, forced.remat_policy, None, "sgd",
                              "flat", autotune.backend_of(dev))
    entry = autotune.get_cache(cache).memory_entry(key)
    a, b = autotune.get_cache(cache).memory_correction(key)
    budget_gb = CALIBRATION_BUDGET_GB
    if not forced.calibrated:  # the fit admits no micro-batch at 60 GiB
        least = a * modeled(forced, 1) + b
        budget_gb = math.ceil(least / GIB * 4) / 4
        check(budget_gb <= FAMILY_MAX_BUDGET_GB,
              f"train {arch}: micro 1 is predicted at {least / GIB:.2f} GiB, "
              f"over {FAMILY_MAX_BUDGET_GB} GiB")
        print(f"train {arch}: the calibrated fit admits no micro-batch at "
              f"{CALIBRATION_BUDGET_GB} GiB; the least budget that admits "
              f"one is {budget_gb} GiB", flush=True)
        forced = plan("auto", policy, budget_gb)
        check(forced.calibrated, f"train {arch}: no calibrated plan at "
                                 f"{budget_gb} GiB")
    predicted = a * modeled(forced) + b
    print(f"train {arch}: calibrated plan at {budget_gb} GiB: "
          f"{forced.describe()}; fit measured = {a:.6f} x modeled + {b:.0f} "
          f"B from probes (micro, modeled B, measured B) {entry['probes']}; "
          f"predicted {predicted / GIB:.3f} GiB", flush=True)
    records, undo = (_route_recorder() if cfg.is_moe else (None, None))
    try:
        res = (drive or run_launcher)(dev, flags("auto", policy, budget_gb))
    finally:
        if undo is not None:
            undo()
    got, hist, counts = res["plan"], res["history"], res["counts"]
    check(got == forced, f"train {arch}: --calibrate auto planned "
                         f"{got.describe()}, force {forced.describe()}")
    check(len(hist) == FAMILY_STEPS, f"train {arch}: ran {len(hist)} steps")
    spec = FlatSpec.for_tree(res["params"])
    n_b = spec.num_buckets
    for buf in spec.buffers_of(res["params"]):
        check(bool(torch.isfinite(buf).all()), f"train {arch}: params not "
                                               f"finite")
    groups = _k1_groups(res["params"])
    want_k1 = len(hist) * got.num_micro_batches * groups
    check(counts["grad_accum"] == want_k1 and
          counts["fused_sgd_mom"] == len(hist) * n_b,
          f"train {arch}: launches {counts}, expected K1 {want_k1} (steps x "
          f"micro-batches x {groups} launch groups) and K2 {len(hist) * n_b}")
    step_s, peak = res["steady_step_s"], res["peak_bytes"]
    budget = int(budget_gb * GIB)
    # an enc-dec config's tokens are its decoder's (frames / 4)
    tokens = mini * (seq // 4 if cfg.is_encdec else seq)
    out.update(
        plan=got.describe(), micro=got.micro_batch_size,
        num_micro_batches=got.num_micro_batches, remat=got.remat_policy,
        budget_bytes=budget, fit=[a, b], probes=entry["probes"],
        calibrated_prediction_bytes=predicted, losses=res["losses"],
        steady_step_s=step_s, tokens_per_s=tokens / step_s,
        readback_gaps_s=res["readback_gaps_s"], peak_bytes=peak,
        peak_reserved_bytes=res["peak_reserved_bytes"],
        allocated_before_bytes=res["allocated_before_bytes"],
        over_budget_bytes=max(peak - budget, 0), counts=counts,
        buckets=n_b, launch_groups=groups, params=sum(spec.bucket_sizes),
        wall_s=res["wall_s"])
    extra = ""
    if cfg.is_moe:
        # one route call a MoE layer and micro-batch forward (and again
        # in a recompute); step 0's are the first layers × N_Smu × (1, 2)
        n0 = len(records) // len(hist)
        dropped = sum(int(d) for d, _ in records[:n0])
        routed = sum(n for _, n in records[:n0])
        out.update(aux_loss_step0=float(hist[0]["aux_loss"]),
                   dropped_share_step0=dropped / routed,
                   route_calls=len(records))
        extra = (f"; step 0: aux loss {out['aux_loss_step0']:.6f}, "
                 f"{dropped} of {routed} routed (token, expert) choices "
                 f"dropped by capacity ({100 * dropped / routed:.3f} %)")
    res["opt_state"] = None  # momentum: room for one traced micro-batch
    out["micro_trace"] = _trace_micro(dev, cfg, res["params"], got, seq)
    over = peak - budget
    print(f"train {arch}: {got.describe()}; losses {res['losses']}; steady "
          f"step {step_s:.4f}s, {tokens / step_s:.1f} tokens/s (gaps "
          f"{res['readback_gaps_s']}); peak allocated {peak} B "
          f"({peak / GIB:.3f} GiB) vs budget {budget_gb} GiB ("
          + (f"OVER by {over} B" if over > 0 else f"{-over} B under")
          + f") and calibrated prediction {predicted / GIB:.3f} GiB; K1/K2 "
          f"launches {counts['grad_accum']}/{counts['fused_sgd_mom']} over "
          f"{n_b} bucket(s) of {sum(spec.bucket_sizes)} params{extra}",
          flush=True)
    del res
    gc_collect()
    return out


def family_step_check(dev, arch: str) -> dict:
    """15e. One ``flat`` step (K1, K2) against one ``compiled`` step at
    SERVE_CHECKS' depth of ``arch``'s full width, fp32, TF32 off
    (``executor_steps``, ``against_compiled``), K1 launched once a
    micro-batch and launch group, K2 once (one bucket)."""
    import torch
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get(arch), **SERVE_CHECKS[arch][0])
    outs = executor_steps(dev, cfg, torch.float32, ("compiled", "flat"))
    params, _, loss, counts = outs["flat"]
    want = 4 * _k1_groups(params)
    check(counts["grad_accum"] == want and counts["fused_sgd_mom"] == 1,
          f"{arch}: flat launched {counts}, expected K1 {want} and K2 1")
    worst = against_compiled(outs, f"{arch} ({cfg.num_layers} layers)")
    print(f"train {arch} ({cfg.num_layers} layers, fp32): flat == compiled "
          f"after one step (loss {loss:.6f}, max abs err {worst['flat']:.3e};"
          f" K1/K2 {counts['grad_accum']}/{counts['fused_sgd_mom']})",
          flush=True)
    del outs, params
    gc_collect()
    return {"loss": loss, "max_abs_err": worst["flat"], "counts": counts}


FAMILIES = tuple(FAMILY_TRAIN)


def family_phases(timed, dev) -> dict:
    """15a-15e, in order: each family's training cell, its serving cell,
    and its correctness checks."""
    out = {"train": {}, "serve": {}, "check": {}}
    for tag, arch in zip("abc", FAMILIES):
        out["train"][arch] = timed(f"15{tag} train {arch}",
                                   family_train_phase, dev, arch)
    for arch in FAMILIES:
        out["serve"][arch] = timed(f"15d serve {arch}", serve_phase, dev,
                                   arch)
    for arch in FAMILIES:
        out["check"][arch] = {
            "serve": timed(f"15e serve check {arch}",
                           serve_correctness_phase, dev, arch),
            "step": timed(f"15e step check {arch}", family_step_check, dev,
                          arch)}
    return out


# ---------------------------------------------------------------------------
# 16. data parallelism: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# 16a: the launcher under torchrun, full qwen2-1.5b, the main path's
# settings with 8 micro-batches of 2 (local micro 1 a rank)
DP_RANKS = 2
# (depth cut to 2 of 28 layers for the run's time limit: the all-reduce
# of the whole model through gloo's host ring was 94 % of the step)
DP_LAYERS = 2
DP_ARGV = ["--arch", "qwen2-1.5b", "--executor", "flat",
           "--dtype", "bfloat16", "--seq", "1024", "--mini-batch", "16",
           "--microbatches", "8", "--steps", "3", "--log-every", "1",
           "--mesh", f"{DP_RANKS}:1", "--layers", str(DP_LAYERS)]
DP_TIMEOUT_S = 600  # the whole torchrun command; the ranks' own process
# group times out a collective after launch.mesh.DEFAULT_TIMEOUT_S
# 16b: the four inners at 2 layers of full width, fp32, against one
# device's compiled step: mini-batch 8 = 4 micro-batches of 2
DP_CHECK_STEPS = 2
DP_CHECK_INNERS = ("flat", "fused", "compiled", "streaming")


def _run_group(cmd, env, timeout_s: float) -> tuple:
    """``cmd`` in a session of its own, killed whole (torchrun and its
    ranks) if it outlives ``timeout_s``: (exit code, output)."""
    import signal
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise SmokeFailure(f"{cmd[:6]}... did not finish in {timeout_s}s; "
                           f"killed with its ranks. Output:\n{out[-4000:]}")
    return proc.returncode, out


def dp_main_path_phase(dev) -> dict:
    """16a. ``torchrun --nproc_per_node 2 -m repro_torch.launch.train``
    with DP_ARGV: both ranks on ``cuda:0`` over gloo, each capped at its
    share of the card, ``ShardedExecutor`` over ``flat``. Each rank's
    ``--report``: every loss finite and the first near ln(vocab), the
    same on both ranks; exactly one all-reduce a step on each rank
    (``engine.collective_stats``), its seconds (the device synchronized
    around it) and share of the steady step; K1 steps × N_Sμ × buckets
    and K2 steps × buckets launches a rank; the peak beside the per-device
    estimate; the backend the launcher printed."""
    out_dir = os.path.join(ROOT, "build", "dp")
    os.makedirs(out_dir, exist_ok=True)
    report = os.path.join(out_dir, "run.json")
    for r in range(DP_RANKS):
        path = os.path.join(out_dir, f"run.rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    gc_collect()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DP_RANKS), "-m",
           "repro_torch.launch.train", *DP_ARGV, "--report", report]
    t0 = time.perf_counter()
    rc, log = _run_group(cmd, env, DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "launcher.log"), "w") as f:
        f.write(log)
    check(rc == 0, f"16a: torchrun exited {rc}:\n{log[-4000:]}")
    backend = re.search(r"\[mesh\] .* backend (\w+)", log)
    check(backend is not None and backend.group(1) == "gloo",
          f"16a: the launcher did not say it chose gloo:\n{log[-2000:]}")
    reps = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"run.rank{r}.json")) as f:
            reps.append(json.load(f))
    vocab = 151936
    losses = [[h["loss"] for h in rep["history"]] for rep in reps]
    steps, n_s = len(losses[0]), reps[0]["num_micro_batches"]
    check(steps == 3, f"16a: {steps} steps")
    check(losses[0] == losses[1], f"16a: the ranks' losses differ: {losses}")
    check(all(math.isfinite(x) for x in losses[0]),
          f"16a: losses not finite: {losses[0]}")
    check(abs(losses[0][0] - math.log(vocab)) < 1.0,
          f"16a: first loss {losses[0][0]} is far from ln(vocab)")
    out = {"card": card_line(), "backend": backend.group(1),
           "plan": reps[0]["plan"], "losses": losses[0], "wall_s": wall,
           "ranks": []}
    for rep in reps:
        r = rep["rank"]
        calls = rep["all_reduce"]["calls"]
        launches = rep["launches"]
        check(calls == steps, f"16a rank {r}: {calls} all-reduces in "
                              f"{steps} steps, expected exactly 1 a step")
        check(launches["grad_accum"] == steps * n_s and
              launches["fused_sgd_mom"] == steps,
              f"16a rank {r}: launches {launches}, expected K1 "
              f"{steps * n_s} and K2 {steps}")
        clocks = [h["readback_s"] for h in rep["history"]]
        gaps = [b - a for a, b in zip(clocks, clocks[1:])]
        steady = sum(gaps[:-1]) / len(gaps[:-1])
        ar_s = rep["all_reduce"]["seconds"] / calls
        out["ranks"].append({
            "rank": r, "device": rep["device"],
            "memory_fraction": rep["memory_fraction"],
            "all_reduce_calls": calls,
            "all_reduce_calls_per_step": calls / steps,
            "all_reduce_bytes": rep["all_reduce"]["bytes"],
            "all_reduce_s": ar_s, "steady_step_s": steady,
            "readback_gaps_s": gaps,
            "all_reduce_share": ar_s / steady,
            "peak_bytes": rep["peak_allocated_bytes"],
            "peak_reserved_bytes": rep["peak_reserved_bytes"],
            "estimate_bytes": rep["estimate_bytes"], "launches": launches})
        print(f"16a rank {r} [{out['card']}]: {rep['device']} "
              f"(backend {out['backend']}, memory fraction "
              f"{rep['memory_fraction']:.3f}); losses {losses[0]}; steady "
              f"step {steady:.4f}s ({16 * 1024 / steady:.1f} tokens/s for "
              f"the world; gaps {gaps}); all-reduce {calls} calls in "
              f"{steps} steps ({calls / steps:.2f} a step) of "
              f"{rep['all_reduce']['bytes'] // calls} B, {ar_s:.4f}s each, "
              f"{100 * ar_s / steady:.1f} % of the step; peak allocated "
              f"{rep['peak_allocated_bytes']} B "
              f"({rep['peak_allocated_bytes'] / GIB:.3f} GiB) vs per-device "
              f"estimate {rep['estimate_bytes']} B "
              f"({rep['estimate_bytes'] / GIB:.3f} GiB); K1/K2 launches "
              f"{launches['grad_accum']}/{launches['fused_sgd_mom']}",
              flush=True)
    print(f"16a: {reps[0]['plan']}; torchrun wall {wall:.1f}s incl. start "
          f"and init", flush=True)
    out["counts"] = {f"rank{rep['rank']}": rep["launches"] for rep in reps}
    return out


def dp_check_rank(mesh, steps: int) -> dict:
    """16b on one rank (``launch.world.LocalWorld``): the four inners'
    sharded steps against one device's ``compiled`` steps on the same
    global mini-batches (computed on this rank), the ``defer_sync=False``
    census and the guard's poisoned step. Returns errors, counts and
    fingerprints; tensors stay on the rank."""
    import torch
    from repro_torch import configs, engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=2)
    plan = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                           mesh=mesh, fsdp_params=False, device=dev)
    loss_fn = steps_lib.make_loss_fn(cfg, dtype=torch.float32,
                                     remat_policy="none")
    ds = LMDataset(cfg.vocab_size, 256, seed=0)
    batches = [ds.batch(8, i) for i in range(steps)]

    def fresh(ex):
        opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
        params = transformer.init_params(cfg, seed=0, device=dev)
        state = opt.init(params)
        if getattr(ex, "prepare", None) is not None:
            params, state = ex.prepare(params, state)
        return opt, params, state

    def make(name, **kw):
        opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
        return engine.ShardedExecutor(loss_fn, opt, plan, mesh=mesh,
                                      inner=name, **kw)

    # one device's compiled steps on the global mini-batches
    one = engine.CompiledScanExecutor(
        loss_fn, optim.sgd(0.05, momentum=0.9, weight_decay=5e-4), plan)
    _, params, state = fresh(one)
    ref_losses = []
    for b in batches:
        params, state, m = one.step_split(params, state,
                                          plan.device_split(b, dev))
        ref_losses.append(float(m["loss"]))
    ref = [t.clone() for t in tree.leaves((params, state["mom"]))]
    del params, state
    out = {"plan": plan.describe(), "ref_losses": ref_losses, "inners": {}}
    for name in DP_CHECK_INNERS:
        ex = make(name)
        _, params, state = fresh(ex)
        losses, calls = [], []
        for b in batches:
            engine.reset_collective_stats()
            if name == "streaming":  # the host mini-batch, streamed
                params, state, m = ex.step(params, state, dict(b))
            else:
                params, state, m = ex.step_split(params, state,
                                                 ex.stage(plan.split(b)))
            losses.append(float(m["loss"]))
            calls.append(engine.collective_stats()["calls"])
        worst, ok = 0.0, True
        got = tree.leaves((params, state["mom"]))
        for x, y in zip(got, ref):
            err, fine = max_violation(x, y)
            worst, ok = max(worst, err), ok and fine
        out["inners"][name] = {
            "losses": losses, "calls": calls, "max_abs_err": worst,
            "within": ok, "fingerprint": [float(t.double().sum())
                                          for t in got]}
        del ex, params, state, got
    # the per-micro baseline: N_Smu all-reduces a step
    ex = make("compiled", defer_sync=False)
    _, params, state = fresh(ex)
    engine.reset_collective_stats()
    params, state, m = ex.step_split(params, state,
                                     ex.stage(plan.split(batches[0])))
    out["baseline_calls"] = engine.collective_stats()["calls"]
    del ex, params, state
    # the guard: a NaN in rank 0's block only; every rank skips
    ex = make("flat", guard=True)
    _, params, state = fresh(ex)
    before = [t.clone() for t in tree.leaves((params, state))]
    local = ex.stage(plan.split(batches[0]))
    if mesh.rank == 0:
        local["sample_weight"][0, 0] = float("nan")
    engine.reset_collective_stats()
    params, state, m = ex.step_split(params, state, local)
    after = tree.leaves((params, state))
    out["guard"] = {
        "nonfinite": float(m["nonfinite"]),
        "unchanged": all(torch.equal(a, b) for a, b in zip(after, before)),
        "calls": engine.collective_stats()["calls"]}
    del ex, params, state, before, after
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def dp_check_phase(world) -> dict:
    """16b. Two ranks sharing the card (``world``, a ``launch.world.
    LocalWorld`` on CUDA: gloo, each capped at its share), full qwen2-1.5b
    width at 2
    layers, fp32, TF32 off (phase 5's size, in fp32: the two sides'
    GEMMs have other shapes): DP_CHECK_STEPS steps of ``ShardedExecutor``
    with each inner against one device's ``compiled`` steps on the same
    global mini-batches — params and momentum within phase 5's rtol /
    atol 1e-6, one all-reduce a step, the ranks bit-identical; the
    ``defer_sync=False`` baseline's N_Sμ all-reduces; a NaN in rank 0's
    block only leaves both ranks' state ``torch.equal`` with
    ``nonfinite`` 1 on both."""
    gc_collect()
    check(world.n == DP_RANKS, f"16b runs on {DP_RANKS} ranks, the world "
                               f"has {world.n}")
    res = world.run(dp_check_rank, DP_CHECK_STEPS)
    card = card_line()
    n_s = 4
    out = {"card": card, "plan": res[0]["plan"], "inners": {},
           "ref_losses": res[0]["ref_losses"]}
    for name in DP_CHECK_INNERS:
        a, b = res[0]["inners"][name], res[1]["inners"][name]
        check(a["fingerprint"] == b["fingerprint"] and
              a["losses"] == b["losses"],
              f"16b {name}: the ranks' states differ")
        for r in res:
            got = r["inners"][name]
            check(got["within"], f"16b {name}: params/momentum differ from "
                                 f"one device's compiled by "
                                 f"{got['max_abs_err']:.3e} (rtol 1e-6, "
                                 f"atol 1e-6)")
            check(got["calls"] == [1] * DP_CHECK_STEPS,
                  f"16b {name}: all-reduces a step {got['calls']}")
        for x, y in zip(a["losses"], res[0]["ref_losses"]):
            check(abs(x - y) <= 1e-5 * abs(y),
                  f"16b {name}: loss {x} vs one device's {y}")
        out["inners"][name] = {"max_abs_err": max(
            r["inners"][name]["max_abs_err"] for r in res),
            "losses": a["losses"], "calls": a["calls"]}
        print(f"16b [{card}]: sharded {name} x {DP_RANKS} ranks == one "
              f"device's compiled after {DP_CHECK_STEPS} steps at qwen2-1.5b "
              f"width, 2 layers, fp32 (losses {a['losses']}, max abs err "
              f"{out['inners'][name]['max_abs_err']:.3e}; all-reduces a "
              f"step {a['calls']})", flush=True)
    base = [r["baseline_calls"] for r in res]
    check(base == [n_s] * DP_RANKS, f"16b: defer_sync=False issued {base} "
                                    f"all-reduces, expected {n_s} a rank")
    guard = [r["guard"] for r in res]
    check(all(g["nonfinite"] == 1.0 and g["unchanged"] and g["calls"] == 1
              for g in guard),
          f"16b: a NaN in rank 0's block: {guard}")
    out.update(baseline_calls=base, guard=guard,
               peak_bytes=[r["peak_bytes"] for r in res])
    print(f"16b: defer_sync=False {base[0]} all-reduces a step (N_Smu "
          f"{n_s}) against 1 deferred; a NaN in rank 0's block: nonfinite "
          f"{[g['nonfinite'] for g in guard]}, state torch.equal on both "
          f"ranks, 1 all-reduce; rank peaks {out['peak_bytes']} B",
          flush=True)
    return out

# ---------------------------------------------------------------------------
# 16c. a fault on one rank, agreed across the ranks
# ---------------------------------------------------------------------------

# two ranks sharing the card at full qwen2-1.5b width, 2 layers, bf16
# over fp32, seq 1024: mini-batch 16 = 2 micro-batches of 8 (local 4) at
# remat "full", so that the supervisor's one rung down halves the
# micro-batch (to 4, local 2) and the step's activations with it
FAULT_ARGS = {"layers": 2, "seq": 1024, "mini": 16, "micro": 8, "steps": 2}


def _fault_runtime(mesh, cfg, guard=True):
    """``plan -> (executor, step_fn, pipeline)`` for the supervisor: the
    supervised ``ShardedExecutor`` over ``flat`` on this rank's block."""
    import torch
    from repro_torch import engine, optim
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps as steps_lib
    ds = LMDataset(cfg.vocab_size, FAULT_ARGS["seq"], seed=0)

    def build(plan):
        loss_fn = steps_lib.make_loss_fn(cfg, dtype=torch.bfloat16,
                                         remat_policy=plan.remat_policy)
        ex = engine.ShardedExecutor(
            loss_fn, optim.sgd(0.05, momentum=0.9, weight_decay=5e-4),
            plan, mesh=mesh, inner="flat", guard=guard)
        return ex, ex.step_split, engine.Pipeline(
            ds, plan, prefetch=0, device=mesh.device, sharding=ex.shard)
    return build


def _fault_state(ex, cfg, dev):
    from repro_torch import optim
    from repro_torch.launch import steps as steps_lib
    params = steps_lib.init_params(cfg, seed=0, device=dev)
    return ex.prepare(params, optim.sgd(0.05, momentum=0.9,
                                        weight_decay=5e-4).init(params))


def fault_agreement_rank(mesh, case: str) -> dict:
    """16c on one rank: the supervised run under ``case`` — "injected"
    (``oom_at(1, rank=1)``) or "real" (rank 1 holds a ballast that leaves
    its share of the card too small for the plan's step and large enough
    for the degraded one, sized from both steps' reserved peaks measured
    here first on every rank). Returns the records, plans, losses, a
    hash of the final state, the seconds and the peaks."""
    import hashlib
    import torch
    from repro_torch import configs, engine, tree
    from repro_torch.engine import faults
    dev = mesh.device
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=FAULT_ARGS["layers"])
    plan = engine.plan_mbs(FAULT_ARGS["mini"],
                           micro_batch_size=FAULT_ARGS["micro"],
                           remat_policy="full", mesh=mesh,
                           fsdp_params=False, device=dev)
    degraded, _ = engine.degrade_plan(plan)
    build = _fault_runtime(mesh, cfg)
    out = {"plan": plan.describe(), "degraded": degraded.describe()}
    ballast = None
    if case == "real":
        peaks = []
        for p in (plan, degraded):  # one step each, on every rank alike
            gc_collect()
            torch.cuda.reset_peak_memory_stats(dev)
            ex, step_fn, pipe = build(p)
            params, state = _fault_state(ex, cfg, dev)
            for batch in pipe.batches(1):
                params, state, m = step_fn(params, state, batch)
            float(m["loss"])
            del ex, step_fn, pipe, params, state, batch, m
            peaks.append(torch.cuda.max_memory_reserved(dev))
        gc_collect()
        cap = int(torch.cuda.get_device_properties(dev).total_memory
                  * mesh.memory_fraction)
        held = torch.cuda.memory_reserved(dev)
        size = cap - (peaks[0] + peaks[1]) // 2
        out.update(peaks_reserved=peaks, cap_bytes=cap, held_bytes=held,
                   ballast_bytes=size if mesh.rank == 1 else 0)
        if mesh.rank == 1:
            ballast = torch.empty((size,), dtype=torch.uint8, device=dev)
        specs = []
    else:
        specs = [faults.oom_at(1, rank=1)]
    torch.cuda.reset_peak_memory_stats(dev)
    sup = engine.Supervisor(build, plan, log_fn=None,
                            writer=mesh.rank == 0)
    params, state = _fault_state(sup.executor, cfg, dev)
    t0 = time.perf_counter()
    with faults.inject(faults.FaultPlan(*specs)) as fp:
        params, state, _ = sup.fit(params, state, FAULT_ARGS["steps"])
    torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0
    sha = hashlib.sha256()
    for t in tree.leaves((params, state)):
        sha.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                   .numpy().tobytes())
    out.update(
        records=[(r.kind, r.step, r.action, r.steps_lost, r.detail)
                 for r in sup.records],
        recovery_s=[r.recovery_s for r in sup.records],
        peaks_at_failure=[r.peak_allocated_bytes for r in sup.records],
        fired=list(fp.fired), final_plan=sup.plan.describe(),
        history=dict(sup.history), state_sha256=sha.hexdigest(),
        peak_allocated=torch.cuda.max_memory_allocated(dev))
    del sup, params, state, ballast
    gc_collect()
    return out


def fault_agreement_phase(world) -> dict:
    """16c. Two ranks sharing the card (``world``, on CUDA, gloo),
    full qwen2-1.5b width at 2 layers, the supervised ``ShardedExecutor``
    over ``flat`` (FAULT_ARGS): an OOM injected on rank 1 alone at step 1,
    then a real OOM of rank 1 alone (a ballast on rank 1 only). In both:
    both ranks record the fault at the same step, degrade to the same
    plan, resume from the same step and end bit-identical, every step
    agreed within seconds — the process group would time out after
    WORLD_TIMEOUT_S, and no rank waits for it."""
    gc_collect()
    card = card_line()
    out = {"card": card}
    for case in ("injected", "real"):
        t0 = time.perf_counter()
        res = world.run(fault_agreement_rank, case)
        wall = time.perf_counter() - t0
        a, b = res
        check(a["records"] and a["records"] == b["records"],
              f"16c {case}: the ranks' records differ: {a['records']} "
              f"vs {b['records']}")
        kind, step, action, lost, detail = a["records"][0]
        check(kind == "oom" and "rank(s) [1] of 2" in detail,
              f"16c {case}: {a['records']}")
        check(a["final_plan"] == b["final_plan"] == a["degraded"],
              f"16c {case}: plans {a['final_plan']} / "
              f"{b['final_plan']}, expected {a['degraded']}")
        check(a["state_sha256"] == b["state_sha256"]
              and a["history"] == b["history"],
              f"16c {case}: the ranks' final states differ")
        check(sorted(a["history"]) == list(range(FAULT_ARGS["steps"])),
              f"16c {case}: completed steps {sorted(a['history'])}")
        check(all(math.isfinite(x) for x in a["history"].values()),
              f"16c {case}: losses {a['history']}")
        check(max(a["seconds"], b["seconds"]) < 120,
              f"16c {case}: the run took {a['seconds']:.1f} / "
              f"{b['seconds']:.1f}s")
        fired = [r["fired"] for r in res]
        if case == "injected":
            check(fired == [[], [("oom", 1)]],
                  f"16c injected: fired {fired}")
        out[case] = {
            "records": a["records"], "plan": a["plan"],
            "final_plan": a["final_plan"], "losses": a["history"],
            "seconds": [r["seconds"] for r in res], "wall_s": wall,
            "recovery_s": [r["recovery_s"] for r in res],
            "peaks_at_failure": [r["peaks_at_failure"] for r in res],
            "peak_allocated": [r["peak_allocated"] for r in res],
            "state_sha256": a["state_sha256"],
            **{k: [r.get(k) for r in res]
               for k in ("peaks_reserved", "cap_bytes", "ballast_bytes")
               if case == "real"}}
        print(f"16c {case} [{card}]: {a['records'][0][:4]} on both "
              f"ranks ({detail}); {a['plan']} -> {a['final_plan']}; "
              f"losses {a['history']}; supervised run "
              f"{a['seconds']:.2f} / {b['seconds']:.2f}s, recovery "
              f"{out[case]['recovery_s']}; final state sha256 "
              f"{a['state_sha256'][:16]} on both"
              + (f"; reserved peaks {a['peaks_reserved']}, cap "
                 f"{a['cap_bytes']}, rank 1 ballast "
                 f"{b['ballast_bytes']} B" if case == "real" else ""),
              flush=True)
    out["same_final_state"] = (out["injected"]["state_sha256"]
                               == out["real"]["state_sha256"])
    return out


# ---------------------------------------------------------------------------
# 19. pipeline parallelism: stages sharing the card over gloo
# ---------------------------------------------------------------------------

# 19a: the launcher's main on the ranks of a LocalWorld, full qwen2-1.5b
# width at PP_LAYERS (1 a stage), bf16 over fp32, SGD-m, 8 micro-batches
# of 2, on a 1 x 2 mesh; 19b the same on a 2 x 2 mesh with FSDP. Depth cut
# for the run's time limit: with all 28 layers in 19a and 19b the whole
# script took 1,184 s of its 1,200 on an H100 80GB HBM3 at 700 W, and
# 1,197.7 s at 8 once phase 21 came, and 1,206.7 s at 4; rank start-up,
# not depth, was most of either phase under torchrun, so since phase 22
# came their ranks fork from the LocalWorld server (16a keeps torchrun)
PP_LAYERS = 2
PP_ARGV = ["--arch", "qwen2-1.5b", "--dtype", "bfloat16", "--seq", "1024",
           "--mini-batch", "16", "--microbatches", "8", "--steps", "3",
           "--log-every", "1", "--layers", str(PP_LAYERS)]
PP_RUNS = {"19a pipeline 1:2": (2, ["--mesh", "1:2"]),
           "19b pipeline 2:2 fsdp": (4, ["--mesh", "2:2", "--fsdp"])}
# every call of the worlds of phases 16b, 16c, 19, 21 and 22, and their
# process groups' timeout
WORLD_TIMEOUT_S = 400
# 19c: 4 layers of full width, fp32, mini-batch 8 = 4 micro-batches of 2
# of 128 tokens
PP_CHECK_STEPS = 2
PP_CHECK_SEQ = 128
PP_CHECK_CELLS = [(2, 1, False), (2, 2, False), (4, 1, False), (2, 2, True)]


def pp_launcher_rank(mesh, argv) -> dict:
    """19a / 19b on one rank: ``repro_torch.launch.train.main(argv)`` (the
    rank has joined the world; the launcher takes it), its standard
    output and its ``--report``."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train.main(argv)
    with open(res["report"]) as f:
        rep = json.load(f)
    del res
    gc_collect()
    return {"log": buf.getvalue(), "report": rep}


def pp_launcher_phase(world, label: str) -> dict:
    """19a / 19b. ``repro_torch.launch.train.main`` with PP_ARGV and the
    run's mesh on every rank of ``world`` (a ``LocalWorld`` of as many
    ranks, every rank on ``cuda:0`` over gloo, each capped at 0.96 / N of
    the card). Each rank's ``--report``: losses finite, the first near
    ln(vocab), equal on every rank; the census of every step — the
    schedule's closed form of sends and receives by direction
    (``engine.p2p_counts``), one (data+model) all-reduce, one data-axis
    all-reduce of the stage gradients where the data axis has two ranks
    (19a has one: none), and under FSDP one model-axis all-reduce of the
    shared gradients, the leaves the policy leaves whole on the data
    axis in one data-axis all-reduce each for the stage's and the shared,
    and as many all-gathers as reduce-scatters, the same every step; the
    steady step and tokens/s; the all-reduces' seconds with the device
    synchronized around each; the peak beside
    ``memory_model.estimate(..., pipeline=True)``'s per-device bytes;
    K1–K6 launched 0 times (the reference's pipelined executor
    accumulates with a plain add and updates with ``apply_update``)."""
    from repro_torch import engine
    ranks, mesh_argv = PP_RUNS[label]
    check(world.n == ranks, f"{label} runs on {ranks} ranks, the world has "
                            f"{world.n}")
    tag = label.split()[0]
    out_dir = os.path.join(ROOT, "build", "pp", tag)
    os.makedirs(out_dir, exist_ok=True)
    report = os.path.join(out_dir, "run.json")
    gc_collect()
    t0 = time.perf_counter()
    res = world.run(pp_launcher_rank, [*PP_ARGV, *mesh_argv, "--report",
                                       report])
    wall = time.perf_counter() - t0
    log = res[0]["log"]
    with open(os.path.join(out_dir, "launcher.log"), "w") as f:
        f.write(log)
    check("pipeline stages" in log and "backend gloo" in log,
          f"{tag}: the launcher did not say it pipelines over gloo:\n"
          f"{log[-2000:]}")
    reps = [r["report"] for r in res]
    vocab = 151936
    losses = [[h["loss"] for h in rep["history"]] for rep in reps]
    steps, n_s = len(losses[0]), reps[0]["num_micro_batches"]
    check(steps == 3, f"{tag}: {steps} steps")
    check(all(x == losses[0] for x in losses),
          f"{tag}: the ranks' losses differ: {losses}")
    check(all(math.isfinite(x) for x in losses[0]),
          f"{tag}: losses not finite: {losses[0]}")
    check(abs(losses[0][0] - math.log(vocab)) < 1.0,
          f"{tag}: first loss {losses[0][0]} is far from ln(vocab)")
    card = card_line()
    out = {"card": card, "plan": reps[0]["plan"], "losses": losses[0],
           "wall_s": wall, "ranks": []}
    fsdp = "--fsdp" in mesh_argv
    gathers = set()
    for rep in reps:
        r, mesh = rep["rank"], rep["mesh"]
        dp, S = mesh["data"], mesh["model"]
        # the counts since the launcher began (a world's ranks may have
        # counted collectives of other kinds before: those read 0)
        census = {k: ({a: n for a, n in v.items() if n}
                      if k in ("by_axis", "p2p") else v)
                  for k, v in rep["all_reduce"].items()}
        want_p2p = {k: steps * v for k, v in
                    engine.p2p_counts(S, n_s, r % S).items() if v}
        check(census["p2p"] == want_p2p,
              f"{tag} rank {r}: point-to-point {census['p2p']}, the "
              f"schedule's closed form {want_p2p}")
        want_axes = {"data+model": steps}
        if fsdp:
            want_axes.update(model=steps, data=2 * steps)
            check(census["all_gather"] == census["reduce_scatter"]
                  and census["all_gather"] % steps == 0,
                  f"{tag} rank {r}: all-gathers {census['all_gather']}, "
                  f"reduce-scatters {census['reduce_scatter']}")
            gathers.add(census["all_gather"])
        elif dp > 1:
            want_axes["data"] = steps
        check(census["by_axis"] == want_axes,
              f"{tag} rank {r}: all-reduces by axis {census['by_axis']}, "
              f"expected {want_axes}")
        launches = {k: v for k, v in rep["launches"].items() if v}
        check(not launches, f"{tag} rank {r}: kernel launches {launches} "
                            "on the pipelined path (expected none)")
        clocks = [h["readback_s"] for h in rep["history"]]
        gaps = [b - a for a, b in zip(clocks, clocks[1:])]
        steady = sum(gaps[:-1]) / len(gaps[:-1])
        ar_s = census["seconds"] / census["calls"]
        tokens = 16 * 1024 / steady
        out["ranks"].append({
            "rank": r, "stage": r % S, "replica": r // S,
            "memory_fraction": rep["memory_fraction"],
            "census": {k: census[k] for k in ("by_axis", "p2p",
                                              "all_gather",
                                              "reduce_scatter")},
            "all_reduce_bytes": census["bytes"],
            "all_reduce_s": ar_s, "all_reduce_s_total": census["seconds"],
            "gather_scatter_s": census["gather_seconds"],
            "steady_step_s": steady, "tokens_per_s": tokens,
            "readback_gaps_s": gaps,
            "peak_bytes": rep["peak_allocated_bytes"],
            "peak_reserved_bytes": rep["peak_reserved_bytes"],
            "estimate_bytes": rep["estimate_bytes"]})
        print(f"{tag} rank {r} (stage {r % S}, replica {r // S}) [{card}]: "
              f"losses {losses[0]}; steady step {steady:.4f}s "
              f"({tokens:.1f} tokens/s for the world; gaps {gaps}); "
              f"all-reduces {census['by_axis']} ({census['calls']} calls, "
              f"{census['bytes']} B, {ar_s:.4f}s each with the device "
              f"synchronized); point-to-point {census['p2p']}; all-gather "
              f"{census['all_gather']}, reduce-scatter "
              f"{census['reduce_scatter']} ({census['gather_seconds']:.3f}s)"
              f"; peak allocated {rep['peak_allocated_bytes']} B "
              f"({rep['peak_allocated_bytes'] / GIB:.3f} GiB) vs per-device "
              f"estimate {rep['estimate_bytes']} B "
              f"({rep['estimate_bytes'] / GIB:.3f} GiB) at memory fraction "
              f"{rep['memory_fraction']:.3f}; K1-K6 launches 0", flush=True)
    if fsdp:
        check(len(gathers) == 1, f"{tag}: the ranks' all-gathers differ: "
                                 f"{gathers}")
    print(f"{tag}: {reps[0]['plan']}; the launcher's main on the world's "
          f"ranks in {wall:.1f}s", flush=True)
    out["counts"] = {f"rank{rep['rank']}": rep["launches"] for rep in reps}
    return out


# one device's compiled steps, computed once in each rank's process and
# kept for the cells after the first: (params, optimizer state, losses)
_PP_REFERENCE: dict = {}


def _pp_reference(dev, cfg, batches):
    import torch
    from repro_torch import engine, optim
    from repro_torch.launch import steps as steps_lib
    if "ref" not in _PP_REFERENCE:
        plan = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                               device=dev)
        sgd = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
        one = engine.CompiledScanExecutor(
            steps_lib.make_loss_fn(cfg, dtype=torch.float32,
                                   remat_policy="none"), sgd, plan)
        params = steps_lib.init_params(cfg, seed=0, device=dev)
        state = sgd.init(params)
        losses = []
        for b in batches:
            params, state, m = one.step_split(params, state,
                                              plan.device_split(b, dev))
            losses.append(float(m["loss"]))
        _PP_REFERENCE["ref"] = (params, state, losses)
    return _PP_REFERENCE["ref"]


def pp_check_rank(mesh, stages: int, dp: int, fsdp: bool,
                  steps: int) -> dict:
    """19c on one rank: ``steps`` steps of the ``PipelinedExecutor`` on a
    ``(dp, stages)`` mesh of this world against one device's ``compiled``
    steps on the same global mini-batches (computed once on this rank),
    at 4 layers of full qwen2-1.5b width, fp32, TF32 off: the worst error
    of this rank's params and momentum against the same slice of the
    reference's (``prepare`` cuts it) and whether all are within rtol /
    atol 1e-6; a hash of this rank's shared leaves; the losses; the
    census of the last step."""
    import hashlib
    import torch
    from repro_torch import configs, engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    pmesh = mesh_lib.pipeline_mesh(mesh, dp, stages)
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=4)
    plan = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                           mesh=pmesh, fsdp_params=False, pipeline=True,
                           device=dev)
    ds = LMDataset(cfg.vocab_size, PP_CHECK_SEQ, seed=0)
    batches = [ds.batch(8, i) for i in range(steps)]
    ref_params, ref_state, ref_losses = _pp_reference(dev, cfg, batches)
    sgd = lambda: optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)  # noqa
    ex = engine.PipelinedExecutor(
        steps_lib.make_staged_loss(cfg, torch.float32, remat_policy="none"),
        sgd(), plan, mesh=pmesh, fsdp=fsdp)
    params = steps_lib.init_params(cfg, seed=0, device=dev)
    params, state = ex.prepare(params, sgd().init(params))
    losses = []
    for b in batches:
        engine.reset_collective_stats()
        params, state, m = ex.step_split(params, state,
                                         ex.stage(plan.split(b)))
        losses.append(float(m["loss"]))
    census = engine.collective_stats()
    want_p, want_s = ex.prepare(ref_params, ref_state)
    worst, ok = 0.0, True
    for x, y in zip(tree.leaves((params, state["mom"])),
                    tree.leaves((want_p, want_s["mom"]))):
        err, fine = max_violation(x, y)
        worst, ok = max(worst, err), ok and fine
    sha = hashlib.sha256()  # this rank's shared leaves (FSDP: its shard)
    for k in sorted(params):
        if k != "blocks":
            for t in tree.leaves(params[k]):
                sha.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                           .numpy().tobytes())
    del ex, params, state, want_p, want_s
    gc_collect()
    return {"plan": plan.describe(), "losses": losses,
            "ref_losses": ref_losses, "max_abs_err": worst, "within": ok,
            "replica": mesh.rank // stages, "shared_sha256": sha.hexdigest(),
            "census": {k: census[k] for k in ("by_axis", "p2p", "all_gather",
                                              "reduce_scatter")},
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def pp_check_cells(world) -> dict:
    """19c on ``world`` (a ``LocalWorld`` of 2 or 4 ranks sharing the card,
    gloo): the PP_CHECK_CELLS of that many ranks, 4 layers of full
    qwen2-1.5b width, fp32, TF32 off — (stages, dp) ∈ {(2, 1), (2, 2),
    (4, 1)} and FSDP at (2, 2), PP_CHECK_STEPS steps of the
    ``PipelinedExecutor`` against one device's ``compiled`` on the same
    global mini-batches — each rank's params and momentum within phase
    5's rtol / atol 1e-6 of the same slice of the reference's, the shared
    leaves bit-identical across the ranks that hold them (under FSDP,
    across the stages of a replica), the losses within 1e-5 relative.
    The ranks drop their reference state after the last cell."""
    gc_collect()
    card = card_line()
    out = {}
    cells = [c for c in PP_CHECK_CELLS if c[0] * c[1] == world.n]
    for stages, dp, fsdp in cells:
        name = f"{stages}x{dp}" + (" fsdp" if fsdp else "")
        res = world.run(pp_check_rank, stages, dp, fsdp, PP_CHECK_STEPS)
        for r in res:
            check(r["within"], f"19c {name}: params/momentum differ "
                               f"from one device's compiled by "
                               f"{r['max_abs_err']:.3e} (rtol 1e-6, "
                               "atol 1e-6)")
            for x, y in zip(r["losses"], r["ref_losses"]):
                check(abs(x - y) <= 1e-5 * abs(y),
                      f"19c {name}: loss {x} vs one device's {y}")
        # every rank holds the shared leaves whole; under FSDP the stages
        # of a replica hold the same shard of them
        groups = {}
        for r in res:
            groups.setdefault(r["replica"] if fsdp else 0,
                              set()).add(r["shared_sha256"])
        check(all(len(h) == 1 for h in groups.values()),
              f"19c {name}: the shared leaves differ across ranks")
        check(all(r["losses"] == res[0]["losses"] for r in res),
              f"19c {name}: the ranks' losses differ")
        out[name] = {
            "card": card, "plan": res[0]["plan"],
            "losses": res[0]["losses"], "ref_losses": res[0]["ref_losses"],
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "census": [r["census"] for r in res],
            "peak_bytes": [r["peak_bytes"] for r in res]}
        print(f"19c [{card}]: pipelined {name} (stages x data) == one "
              f"device's compiled after {PP_CHECK_STEPS} steps at qwen2-1.5b "
              f"width, 4 layers, fp32 (losses {res[0]['losses']}, max abs "
              f"err {out[name]['max_abs_err']:.3e}); shared leaves "
              f"bit-identical on {world.n} ranks; census of rank 0's last "
              f"step {res[0]['census']}", flush=True)
    world.run(_drop_pp_reference)
    return out


def _drop_pp_reference(mesh) -> None:
    _PP_REFERENCE.clear()
    gc_collect()


def _world(n: int):
    from repro_torch.launch.world import LocalWorld
    store = os.path.join(ROOT, "build", "worlds")
    os.makedirs(store, exist_ok=True)
    gc_collect()
    return LocalWorld(n, device="cuda", store_dir=store,
                      timeout_s=WORLD_TIMEOUT_S, threads=0)


def world_phases(timed, dev, st_train=None) -> dict:
    """Phases 16b, 16c, 19, 21 and 22 in two ``LocalWorld``s sharing the
    card, each started once (its ranks fork from the server that
    imported torch and the port): two ranks for 16b, 16c, 19a and 19c's
    two-rank cells; four for 19b, 19c's four-rank cells, 21a / 21b, 22a
    and 22b, whose groups 22a's fault starts anew. 21c (``st_train``:
    18a's numbers; None skips it) runs in this process meanwhile. Returns
    the phases' results: "dp_check", "fault", "pipeline", "gspmd"."""
    pp = {"train": {}, "check": {}}
    labels = list(PP_RUNS)
    with timed("world of 2", _world, 2) as w2:
        dp_check = timed("16b data-parallel check", dp_check_phase, w2)
        fault = timed("16c fault agreement", fault_agreement_phase, w2)
        pp["train"][labels[0]] = timed(labels[0], pp_launcher_phase, w2,
                                       labels[0])
        pp["check"].update(timed("19c pipeline check, 2 ranks",
                                 pp_check_cells, w2))
    with timed("world of 4", _world, 4) as w4:
        pp["train"][labels[1]] = timed(labels[1], pp_launcher_phase, w4,
                                       labels[1])
        pp["check"].update(timed("19c pipeline check, 4 ranks",
                                 pp_check_cells, w4))
        gspmd = {"train": timed("21a/21b GSPMD", gspmd_train_phase, w4)}
        if st_train is not None:
            gspmd["dryrun"] = timed("21c GSPMD dry run", gspmd_dryrun_phase,
                                    dev, st_train)
        gspmd["serve_dryrun"] = timed("21d GSPMD serving dry run",
                                      gspmd_serve_dryrun_phase, dev)
        gspmd["supervised"] = timed("22a GSPMD supervised",
                                    gspmd_supervised_phase, w4)
        gspmd["serve"] = timed("22b serve on 4 ranks", serve_world_phase, w4)
        gspmd["prefill_decode"] = timed("22c GSPMD prefill and decode",
                                        gspmd_serve_phase, w4)
    return {"dp_check": dp_check, "fault": fault, "pipeline": pp,
            "gspmd": gspmd}

# ---------------------------------------------------------------------------
# 17. the last two families: the encoder-decoder and the VLM backbone
# ---------------------------------------------------------------------------

# 17a: seamless-m4t-medium at full width (12 + 12 layers, d 1024, vocab
# 256,206) at the reference's train_4k: 4096 frames, 1024 target tokens;
# the mini-batch cut from 8 to 4 for the run's time limit
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_TRAIN = ["--seq", "4096", "--mini-batch", "4"]
# 17b: qwen2-vl-72b at full width (d 8192, d_ff 29,568, vocab 152,064,
# untied head), depth cut to 1 of its 80 layers: one layer is 3.37 G
# params, 50.2 GiB of flat state (params, momentum, accumulator and one
# micro-batch's gradient leaves); two would be 63.3 GiB before activations
VLM_ARCH = "qwen2-vl-72b"
VLM_TRAIN = ["--seq", "1024", "--mini-batch", "8", "--layers", "1"]
# 17c: 2 steps at 2 layers of each width (the enc-dec 2 + 2), fp32; the
# VLM's batch is 256 patches and 128 text tokens
FAMILY_CHECK_STEPS = 2
FAMILY_CHECK_SEQ = {ENCDEC_ARCH: 256, VLM_ARCH: 384}
ENCDEC_DECODE_ATOL = 1e-4  # tests/test_decode_consistency.py's bound


def run_executor(dev, argv) -> dict:
    """17a's runner: what ``launch.train.main(argv)`` would run, with the
    executor driven directly on the family's batches
    (``steps.family_batch``, seed = step; the launcher's ``LMDataset`` has
    no frames, so it refuses an enc-dec arch): the plan
    (``train.build_plan``: the tuning cache's correction under
    ``--calibrate auto``), ``train.build_executor``, fp32 params from seed
    0, the counters zeroed just before the steps and read just after.
    Each step's batch is staged before its clock starts, and its clock
    stops at its loss's readback; the steady step is the mean of the
    steps but the first. Returns :func:`run_launcher`'s keys and checks
    what it checks: every loss finite, the first near ln(vocab)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import steps, train

    args = train.build_parser().parse_args(argv)
    cfg = train.build_config(args)
    opt = train.default_optimizer(args)
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    batches = [steps.family_batch(cfg, args.seq, args.mini_batch, seed=i)
               for i in range(args.steps)]
    gc_collect()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    plan = train.build_plan(cfg, args, opt, dev)
    print(plan.describe(), flush=True)
    ex = train.build_executor(cfg, plan, args, opt)
    params = steps.init_params(cfg, seed=0, device=dev)
    opt_state = opt.init(params)
    params, opt_state = ex.prepare(params, opt_state)
    kernels.reset_launch_counts()
    hist, times = [], []
    for i, b in enumerate(batches):
        split = steps.device_split(plan, b, dev, dtype)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt_state, m = ex.step_split(params, opt_state, split)
        loss = float(m["loss"])
        times.append(time.perf_counter() - t)
        hist.append({"step": i, "loss": loss})
        print(f"step {i}: loss {loss:.4f} ({times[-1]:.4f}s)", flush=True)
        del split, m
    counts = kernels.launch_counts()
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses),
          f"{argv}: losses not finite: {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]:.4f} is far from ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f} for a random model")
    return {"plan": plan, "config": cfg, "history": hist, "params": params,
            "opt_state": opt_state, "counts": counts, "losses": losses,
            "readback_gaps_s": times,
            "steady_step_s": sum(times[1:]) / max(len(times) - 1, 1),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
            "allocated_before_bytes": base,
            "wall_s": time.perf_counter() - t0}


def vlm_step_phase(dev) -> dict:
    """17b (ii). qwen2-vl-72b at full width, 1 layer, bf16 over fp32
    weights, on the full VLM batch (``steps.family_batch``: 256 patch
    embeddings of width 1280 in the prefix, then text; the M-RoPE
    streams of a 16 x 16 patch grid, t/h/w different over the image):
    the logits of one sample under M-RoPE must differ from plain RoPE's
    (no streams) and equal them when the three streams are equal (the
    twin of ``test_mrope_equals_rope_when_positions_equal``); then one
    ``flat`` step of 4 samples in 2 micro-batches, the streams split
    (N_Smu, 3, N_mu, S) by ``steps.device_split``: loss finite, K1
    launched once a micro-batch and launch group, K2 once a bucket."""
    import torch
    from repro_torch import configs, engine, kernels, optim
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    bf16 = torch.bfloat16
    cfg = dataclasses.replace(configs.get(VLM_ARCH), num_layers=1)
    seq = 1024
    params = transformer.init_params(cfg, seed=0, device=dev)
    one = {k: torch.from_numpy(v).to(dev) for k, v in steps.family_batch(
        cfg, seq, 1, seed=0).items()}
    equal = torch.arange(seq, device=dev).expand(3, 1, seq)
    with torch.inference_mode():
        def logits(pos):
            return transformer.forward(
                params, cfg, one["tokens"], dtype=bf16, remat=False,
                vision_embeds=one["vision_embeds"], mrope_positions=pos)[0]
        plain = logits(None)
        mrope_diff = float((logits(one["mrope_positions"]) - plain
                            ).abs().max())
        same = logits(equal)
        equal_err = float((same - plain).abs().max())
        bitwise = bool(torch.equal(same, plain))
        del plain, same
    check(mrope_diff > 1e-3, f"{VLM_ARCH}: M-RoPE over differing streams "
                             f"moved the logits by only {mrope_diff:.3e}")
    check(equal_err <= 1e-6, f"{VLM_ARCH}: M-RoPE over equal streams "
                             f"differs from plain RoPE by {equal_err:.3e}")
    plan = engine.plan_mbs(4, micro_batch_size=2, remat_policy="none",
                           device=dev)
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    ex = engine.get_executor("flat")(steps.make_loss_fn(
        cfg, dtype=bf16, remat_policy="none"), opt, plan)
    split = steps.device_split(plan, steps.family_batch(cfg, seq, 4, seed=1),
                               dev, bf16)
    shapes = {k: tuple(v.shape) for k, v in split.items()}
    state = opt.init(params)
    params, state = ex.prepare(params, state)
    groups = _k1_groups(params)
    gc_collect()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, m = ex.step_split(params, state, split)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(math.isfinite(loss), f"{VLM_ARCH}: the VLM step's loss is {loss}")
    check(counts["grad_accum"] == 2 * groups and
          counts["fused_sgd_mom"] == 1,
          f"{VLM_ARCH}: the VLM step launched {counts}, expected K1 "
          f"{2 * groups} and K2 1")
    out = {"layers": 1, "seq": seq, "batch_shapes": shapes,
           "mrope_vs_rope_max_diff": mrope_diff,
           "equal_streams_vs_rope_max_err": equal_err,
           "equal_streams_bitwise": bitwise, "loss": loss, "step_s": step_s,
           "counts": counts, "peak_bytes": peak}
    print(f"train {VLM_ARCH} (1 layer, bf16 over fp32) on the VLM batch "
          f"{shapes}: M-RoPE vs plain RoPE logits differ by up to "
          f"{mrope_diff:.4f}; equal streams vs plain RoPE {equal_err:.3e} "
          f"(bit for bit: {bitwise}); one flat step of 2 x 2: loss "
          f"{loss:.6f} in {step_s:.3f}s, K1/K2 {counts['grad_accum']}/"
          f"{counts['fused_sgd_mom']}, peak {peak / GIB:.3f} GiB", flush=True)
    del params, state, split, ex
    gc_collect()
    return out


def family_steps_check(dev, arch: str) -> dict:
    """17c. FAMILY_CHECK_STEPS steps of each executor at 2 layers of
    ``arch``'s full width (the enc-dec 2 + 2), fp32, TF32 off, from seed
    0's params on the family's batches (mini-batch 8 in 4 micro-batches,
    remat ``none``; the VLM's with 256 patches and M-RoPE streams):
    ``flat``, ``fused`` and ``streaming`` against ``compiled`` — every
    param and optimizer-state leaf within phase 5's rtol / atol 1e-6,
    each step's loss within 1e-5 relative. The enc-dec trains with SGD-m;
    the VLM with plain SGD, because ``compiled``'s SGD-m update holds six
    copies of its 17 GB of params (102 GB), plain SGD's four. The
    reference state waits on the host while the others run."""
    import torch
    from repro_torch import configs, engine, kernels, optim, tree
    from repro_torch.launch import steps

    cfg = configs.get(arch)
    cfg = dataclasses.replace(cfg, num_layers=2, **(
        {"encoder_layers": 2} if cfg.is_encdec else {}))
    momentum = 0.9 if cfg.is_encdec else 0.0
    seq = FAMILY_CHECK_SEQ[arch]
    plan = engine.plan_mbs(8, num_microbatches=4, remat_policy="none",
                           device=dev)
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32,
                                 remat_policy="none")
    batches = [steps.family_batch(cfg, seq, 8, seed=i)
               for i in range(FAMILY_CHECK_STEPS)]
    ref, out = None, {"layers": cfg.num_layers, "seq": seq,
                      "momentum": momentum, "losses": {}, "counts": {},
                      "max_abs_err": {}, "peak_bytes": {}}
    for name in ("compiled", "flat", "fused", "streaming"):
        opt = optim.sgd(0.05, momentum=momentum, weight_decay=5e-4)
        ex = engine.get_executor(name)(loss_fn, opt, plan)
        gc_collect()
        torch.cuda.reset_peak_memory_stats(dev)
        params = steps.init_params(cfg, seed=0, device=dev)
        state = opt.init(params)
        if name == "flat":
            params, state = ex.prepare(params, state)
        kernels.reset_launch_counts()
        losses = []
        for b in batches:
            params, state, m = ex.step_split(
                params, state, steps.device_split(plan, b, dev))
            losses.append(float(m["loss"]))
        out["losses"][name], out["counts"][name] = losses, \
            kernels.launch_counts()
        out["peak_bytes"][name] = torch.cuda.max_memory_allocated(dev)
        leaves = tree.leaves((params, state))
        del params, state, m, ex
        if ref is None:
            check(all(math.isfinite(x) for x in losses),
                  f"{arch}: compiled losses {losses}")
            ref = [x.detach().cpu() for x in leaves]
            del leaves
            continue
        check(len(leaves) == len(ref), f"{arch}: {name} has {len(leaves)} "
                                       f"state leaves, compiled {len(ref)}")
        worst = 0.0
        for x, y in zip(leaves, ref):
            err, ok = max_violation(x, y.to(dev))
            worst = max(worst, err)
            check(ok, f"{arch} (2 layers): {name} vs compiled disagree: max "
                      f"abs err {err:.3e} (rtol 1e-6, atol 1e-6)")
        for a, b in zip(losses, out["losses"]["compiled"]):
            check(abs(a - b) <= 1e-5 * abs(b),
                  f"{arch}: {name} losses {losses} vs compiled "
                  f"{out['losses']['compiled']}")
        out["max_abs_err"][name] = worst
        del leaves
    del ref
    gc_collect()
    print(f"train {arch} (2 layers, fp32, TF32 off, SGD momentum "
          f"{momentum}): {FAMILY_CHECK_STEPS} steps of flat / fused / "
          f"streaming vs compiled, max abs err {out['max_abs_err']}; losses "
          f"{out['losses']['compiled']}; peaks "
          + ", ".join(f"{k} {v / GIB:.2f}" for k, v in
                      out["peak_bytes"].items()) + " GiB", flush=True)
    return out


def encdec_decode_check(dev) -> dict:
    """17c. ``tests/test_decode_consistency.py``'s enc-dec case at 2 + 2
    layers of seamless-m4t-medium's full width, fp32, TF32 off: the
    encoder over 512 frames once, the cross K/V projected once
    (``encdec.init_decode_cache``), then 8 teacher-forced tokens through
    ``encdec.decode_step``, each step's logits within ENCDEC_DECODE_ATOL
    of the teacher-forced ``forward``'s."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec

    f32 = torch.float32
    cfg = dataclasses.replace(configs.get(ENCDEC_ARCH), num_layers=2,
                              encoder_layers=2)
    params = encdec.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 512, cfg.d_model), np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9))).to(dev)
    with torch.inference_mode():
        full, _ = encdec.forward(params, cfg, frames, toks, dtype=f32,
                                 remat=False)
    cache = encdec.init_decode_cache(params, cfg, frames, 16, f32)
    errs = []
    for t in range(8):
        pos = torch.full((2,), t, dtype=torch.int32, device=dev)
        lg, cache = encdec.decode_step(params, cfg, toks[:, t:t + 1], cache,
                                       pos, dtype=f32)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    worst = max(errs)
    check(worst < ENCDEC_DECODE_ATOL,
          f"{ENCDEC_ARCH} (2 + 2 layers): decode vs forward {errs}")
    print(f"serve {ENCDEC_ARCH} (2 + 2 layers, fp32, TF32 off): 512 frames "
          f"encoded once, 8 teacher-forced decode steps vs forward, max "
          f"abs err {worst:.3e} (bound {ENCDEC_DECODE_ATOL})", flush=True)
    del params, cache, full
    gc_collect()
    return {"layers": 2, "frames": 512, "steps": 8, "max_abs_err": worst,
            "errs": errs}


def encdec_vlm_phases(timed, dev) -> dict:
    """17a-17c, in order: the enc-dec's training cell (the executor
    driven directly), the VLM's (the launcher, text-only), the VLM batch
    step, then the 2-layer checks of both."""
    out = {"train": {
        ENCDEC_ARCH: timed(f"17a train {ENCDEC_ARCH}", family_train_phase,
                           dev, ENCDEC_ARCH, ENCDEC_TRAIN, run_executor),
        VLM_ARCH: timed(f"17b train {VLM_ARCH}", family_train_phase, dev,
                        VLM_ARCH, VLM_TRAIN)}}
    out["vlm_batch"] = timed("17b VLM batch", vlm_step_phase, dev)
    out["check"] = {
        ENCDEC_ARCH: {
            "steps": timed(f"17c step check {ENCDEC_ARCH}",
                           family_steps_check, dev, ENCDEC_ARCH),
            "decode": timed(f"17c decode check {ENCDEC_ARCH}",
                            encdec_decode_check, dev)},
        VLM_ARCH: {
            "steps": timed(f"17c step check {VLM_ARCH}", family_steps_check,
                           dev, VLM_ARCH),
            "serve": timed(f"17c serve check {VLM_ARCH}",
                           serve_correctness_phase, dev, VLM_ARCH)}}
    return out


# ---------------------------------------------------------------------------
# 18. the step builders at the reference's assigned shapes
# ---------------------------------------------------------------------------

STEPS_ARCH = "qwen2-1.5b"
# 18a's depth, cut to 2 of qwen2-1.5b's 28 layers for the run's time
# limit (4 until phase 21 came: the whole run took 1,197.7 s of command
# on an H100 80GB HBM3 at 700 W): the width, the 256 x 4096 mini-batch
# and the calibration stay
STEPS_TRAIN_LAYERS = 2
# 18c: one card runs the data shard of the 16 x 16 mesh the reference
# compiles prefill_32k and decode_32k for
STEPS_DATA_SHARDS = 16
STEPS_DECODE_STEPS = 4  # 18b / 18c decode steps, the first a warm-up


def _tree_layout(t) -> list:
    """(path, shape, dtype) of every leaf of a tree of dicts and tuples."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (str(k),))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        elif x is not None:
            out.append(("/".join(path), tuple(x.shape), x.dtype))
    walk(t, ())
    return out


def _filled_cache(abstract, dev, seed: int, start: int = 0) -> dict:
    """A decode cache shaped as ``abstract`` (a meta tree) on the card:
    keys and values seeded normals, and every ring slot j holding
    position ``start + j`` — a full ring, so a decode step attends over
    all of it."""
    import torch
    from repro_torch import tree

    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(x):
        if x.dtype == torch.int32:  # pos: (L, B, W)
            w = x.shape[-1]
            return (torch.arange(start, start + w, dtype=torch.int32,
                                 device=dev).expand(x.shape).contiguous())
        return torch.randn(x.shape, generator=gen, device=dev,
                           dtype=torch.float32).to(x.dtype)
    return tree.map(leaf, abstract)


def _decode_run(dev, cfg, bundle, params, label: str) -> dict:
    """``bundle``'s decode step STEPS_DECODE_STEPS times over a full
    seeded cache, the positions going on past the ring; ms a step (the
    steps after the first), logits finite, the allocator's peak."""
    import torch
    from repro_torch import tree

    _, tok, abstract, _ = bundle.arg_shapes
    b, w = tok.shape[0], abstract[0]["pos"].shape[-1]
    cache = _filled_cache(abstract, dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(2)
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in tree.leaves(cache))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(STEPS_DECODE_STEPS):
        token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                              device=dev, dtype=torch.int32)
        cur = torch.full((b,), w + i, dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = bundle.fn(params, token, cache, cur)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        check(tuple(logits.shape) == (b, 1, cfg.vocab_size) and
              bool(torch.isfinite(logits).all()),
              f"{label}: decode logits {tuple(logits.shape)} not finite")
    peak = torch.cuda.max_memory_allocated(dev)
    ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    del cache, logits
    gc_collect()
    return {"batch": b, "cache_len": w, "cache_bytes": cache_bytes,
            "step_ms": ms, "first_step_ms": 1e3 * times[0],
            "ms_per_token": ms / b, "peak_bytes": peak}


def steps_train_phase(dev) -> dict:
    """18a. ``steps.build_step(qwen2-1.5b full width at STEPS_TRAIN_LAYERS
    layers, SHAPES["train_4k"],
    num_microbatches=None, executor="flat", remat_policy="auto",
    calibrate="force")`` against CALIBRATION_BUDGET_GB, bf16 over fp32
    weights, SGD-m (``steps.make_optimizer``): the planner probes the
    real step, climbs past a policy whose probe does not fit, and backs
    off an admitted size whose measured peak is over the budget; then the
    bundle's ``fn`` runs one step over the whole 256 x 4096 mini-batch
    (1,048,576 tokens) with the counters zeroed just before it and read
    just after: the loss finite, K1 launched N_Smu x launch groups
    times, K2 once a bucket; the split equal to the bundle's abstract
    batch in shapes and dtypes; the step's seconds and tokens/s (a first
    step); the allocator's peak beside the budget and the calibrated
    prediction; ``memory_model.max_minibatch_without_mbs`` at the same
    budget, analytic and as the fit corrects it (both below 256)."""
    import torch
    from repro_torch import configs, kernels, optim
    from repro_torch.core import memory_model
    from repro_torch.engine import FlatSpec, autotune
    from repro_torch.launch import steps

    card = card_line()
    cfg = dataclasses.replace(configs.get(STEPS_ARCH),
                              num_layers=STEPS_TRAIN_LAYERS)
    shape = configs.SHAPES["train_4k"]
    seq, mini = shape.seq_len, shape.global_batch
    cache = os.path.join(ROOT, "build", "tuning-steps.json")
    if os.path.exists(cache):
        os.remove(cache)
    autotune._caches.pop(cache, None)
    budget = CALIBRATION_BUDGET_GB * GIB
    gc_collect()
    t0 = time.perf_counter()
    bundle = steps.build_step(
        cfg, shape, num_microbatches=None, executor="flat",
        remat_policy="auto", calibrate="force", budget_bytes=budget,
        tuning_cache=cache, device=dev)
    probe_s = time.perf_counter() - t0
    plan, opt = bundle.plan, bundle.optimizer
    ooms = probe_ooms(cache, cfg, seq, dev)
    key = autotune.memory_key(cfg, seq, plan.remat_policy, None, "sgd",
                              "flat", autotune.backend_of(dev))
    entry = autotune.get_cache(cache).memory_entry(key)
    check(plan.calibrated, f"18a: no calibrated plan at "
                           f"{CALIBRATION_BUDGET_GB} GiB: {plan.describe()}")
    a, b = plan.correction
    mm_kw = dict(act_bytes=2, remat_policy=plan.remat_policy,
                 **optim.memory_model_kw(opt, fused=True))
    est = memory_model.estimate(cfg, seq, **mm_kw)
    predicted = a * est.total(plan.micro_batch_size) + b
    print(f"18a train_4k {STEPS_ARCH} [{card}]: {plan.describe()}; fit "
          f"measured = {a:.6f} x modeled + {b:.0f} B from probes (micro, "
          f"modeled B, measured B) {entry['probes']}"
          + (f", out of memory at micro {entry['oom_micros']}"
             if entry.get("oom_micros") else "")
          + f" in {probe_s:.1f}s; predicted {predicted / GIB:.3f} GiB",
          flush=True)
    nomb = memory_model.max_minibatch_without_mbs(cfg, seq,
                                                  budget_bytes=budget,
                                                  **mm_kw)
    nomb_cal = autotune.corrected_micro_search(
        cfg, seq, 1 << 20, budget, (a, b), **mm_kw) or 0
    params = steps.init_params(cfg, seed=0, device=dev)
    state = opt.init(params)
    ex = bundle.runner  # the bundle's executor: its flat layout
    params, state = ex.prepare(params, state)
    split = steps.device_split(plan, steps.family_batch(cfg, seq, mini),
                               dev, torch.bfloat16)
    check(_tree_layout(split) == _tree_layout(bundle.arg_shapes[2]),
          f"18a: the split {_tree_layout(split)} is not the bundle's "
          f"abstract batch {_tree_layout(bundle.arg_shapes[2])}")
    groups = _k1_groups(params)
    n_b = FlatSpec.for_tree(params).num_buckets
    gc_collect()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, m = bundle.fn(params, state, split)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(math.isfinite(loss), f"18a: loss {loss}")
    check(abs(loss - math.log(cfg.vocab_size)) < 1.0,
          f"18a: first loss {loss:.4f} is far from ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f} for a random model")
    want_k1 = plan.num_micro_batches * groups
    check(counts["grad_accum"] == want_k1 and counts["fused_sgd_mom"] == n_b,
          f"18a: launches {counts}, expected K1 {want_k1} (N_Smu x {groups} "
          f"launch groups) and K2 {n_b}")
    check(nomb < mini and nomb_cal < mini,
          f"18a: without MBS {nomb} (analytic) / {nomb_cal} (calibrated) "
          f"samples fit {CALIBRATION_BUDGET_GB} GiB, not fewer than {mini}")
    check(peak <= budget, f"18a: the step peaked at {peak / GIB:.3f} GiB, "
                          f"over its {CALIBRATION_BUDGET_GB} GiB budget")
    tokens = mini * seq
    out = {"card": card, "plan": plan.describe(),
           "micro": plan.micro_batch_size,
           "num_micro_batches": plan.num_micro_batches, "pad": plan.pad,
           "remat": plan.remat_policy, "fit": [a, b],
           "probes": entry["probes"],
           "oom_micros": entry.get("oom_micros", []), "probe_ooms": ooms,
           "probe_s": probe_s, "budget_bytes": budget,
           "calibrated_prediction_bytes": predicted,
           "modeled_bytes": est.total(plan.micro_batch_size),
           "loss": loss, "first_step_s": step_s,
           "first_step_tokens_per_s": tokens / step_s, "peak_bytes": peak,
           "counts": counts, "launch_groups": groups, "buckets": n_b,
           "max_minibatch_without_mbs": nomb,
           "max_minibatch_without_mbs_calibrated": nomb_cal}
    print(f"18a train_4k {STEPS_ARCH}: one step over {mini} x {seq} = "
          f"{tokens} tokens through the bundle: loss {loss:.6f}; first step "
          f"{step_s:.3f}s, {tokens / step_s:.1f} tokens/s; peak allocated "
          f"{peak} B ({peak / GIB:.3f} GiB) vs budget "
          f"{CALIBRATION_BUDGET_GB} GiB and calibrated prediction "
          f"{predicted / GIB:.3f} GiB; K1 {counts['grad_accum']} (= "
          f"{plan.num_micro_batches} x {groups}), K2 "
          f"{counts['fused_sgd_mom']} (buckets {n_b}); without MBS the "
          f"budget holds {nomb} samples (analytic) / {nomb_cal} (calibrated"
          f"), against {mini}", flush=True)
    del params, state, split, m, ex, bundle
    gc_collect()
    return out


def steps_serve_phase(dev) -> dict:
    """18b / 18c. Decode at ``long_500k`` (its batch of 1, a 524,288-entry
    ring: 14.0 GiB bf16) and, per device of the reference's 16 x 16 mesh,
    prefill at ``prefill_32k`` (batch 32 / 16 = 2) and decode at
    ``decode_32k`` (batch 128 / 16 = 8, a 7.0 GiB cache), each through
    ``steps.build_step`` at full qwen2-1.5b width, fp32 weights from seed
    0, bf16 compute and cache: the cache seeded and full
    (``_filled_cache``), STEPS_DECODE_STEPS decode steps, ms a step and a
    token; the prefill's seconds and finite logits; each allocator peak."""
    import torch
    from repro_torch import configs
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps

    card = card_line()
    cfg = configs.get(STEPS_ARCH)
    params = steps.init_params(cfg, seed=0, device=dev)
    out = {"card": card}
    long = steps.build_step(cfg, configs.SHAPES["long_500k"])
    out["long_500k"] = _decode_run(dev, cfg, long, params, "18b long_500k")
    r = out["long_500k"]
    print(f"18b long_500k {STEPS_ARCH} [{card}]: decode at batch "
          f"{r['batch']} over a full {r['cache_len']}-entry cache "
          f"({r['cache_bytes'] / GIB:.3f} GiB bf16): {r['step_ms']:.3f} ms a "
          f"step and token (first {r['first_step_ms']:.1f} ms); peak "
          f"{r['peak_bytes'] / GIB:.3f} GiB", flush=True)
    del long
    pre = dataclasses.replace(configs.SHAPES["prefill_32k"],
                              global_batch=32 // STEPS_DATA_SHARDS)
    bundle = steps.build_step(cfg, pre)
    tokens = torch.from_numpy(LMDataset(cfg.vocab_size, pre.seq_len,
                                        seed=3).batch(pre.global_batch, 0)
                              ["tokens"]).to(dev)
    gc_collect()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, cache = bundle.fn(params, tokens)
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (pre.global_batch, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), "18c prefill_32k: logits")
    out["prefill_32k"] = {"batch": pre.global_batch, "seq": pre.seq_len,
                          "seconds": prefill_s,
                          "tokens_per_s": pre.global_batch * pre.seq_len
                          / prefill_s,
                          "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del logits, cache, tokens, bundle
    gc_collect()
    dec = dataclasses.replace(configs.SHAPES["decode_32k"],
                              global_batch=128 // STEPS_DATA_SHARDS)
    out["decode_32k"] = _decode_run(dev, cfg, steps.build_step(cfg, dec),
                                    params, "18c decode_32k")
    p, d = out["prefill_32k"], out["decode_32k"]
    print(f"18c {STEPS_ARCH} per device of the reference's 16 x 16 mesh "
          f"(reduced: global batch / {STEPS_DATA_SHARDS}): prefill_32k batch "
          f"{p['batch']} x {p['seq']} in {p['seconds']:.3f}s "
          f"({p['tokens_per_s']:.1f} tokens/s), peak "
          f"{p['peak_bytes'] / GIB:.3f} GiB; decode_32k batch {d['batch']} "
          f"over a full {d['cache_bytes'] / GIB:.3f} GiB cache: "
          f"{d['step_ms']:.3f} ms a step, {d['ms_per_token']:.3f} ms a token, "
          f"peak {d['peak_bytes'] / GIB:.3f} GiB", flush=True)
    del params
    gc_collect()
    return out


def steps_check_phase(dev) -> dict:
    """18d. 2 layers of qwen2-1.5b's full width, fp32: the train bundle's
    step (``flat``, mini-batch 8 in 4 micro-batches, seq 256) bit-identical
    to the executor built by hand (``make_loss_fn`` + ``get_executor``
    under the bundle's plan) on the same split; the prefill and decode
    bundles bit-identical to ``transformer.prefill`` / ``decode_step``;
    and at full width the abstract trees (``abstract_params``,
    ``abstract_opt_state``, ``abstract_cache``) equal the real
    ``init_params`` / ``opt.init`` / ``init_cache`` trees in paths,
    shapes and dtypes."""
    import torch
    from repro_torch import configs, engine, tree
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    f32 = torch.float32
    full = configs.get(STEPS_ARCH)
    cfg = dataclasses.replace(full, num_layers=2)
    shape = InputShape("train_check", "train", 256, 8)
    bundle = steps.build_step(cfg, shape, num_microbatches=4, dtype=f32,
                              executor="flat", remat_policy="period",
                              budget_bytes=CALIBRATION_BUDGET_GB * GIB,
                              device=dev)
    plan = bundle.plan
    hand = engine.get_executor("flat")(steps.make_loss_fn(
        cfg, f32, remat_policy=plan.remat_policy), steps.make_optimizer(cfg),
        plan)
    batch = LMDataset(cfg.vocab_size, 256, seed=4).batch(8, 0)
    res = {}
    for name, fn, ex in (("bundle", bundle.fn, bundle.runner),
                         ("hand", hand.step_split, hand)):
        params = steps.init_params(cfg, seed=0, device=dev)
        params, state = ex.prepare(params, ex.optimizer.init(params))
        p, s, m = fn(params, state, plan.device_split(batch, dev))
        res[name] = (tree.leaves((p, s)), m["loss"])
    train_equal = (torch.equal(res["bundle"][1], res["hand"][1]) and all(
        torch.equal(x, y) for x, y in zip(res["bundle"][0], res["hand"][0])))
    check(train_equal, "18d: the train bundle's step differs from the "
                       "executor built by hand")
    del res
    params = steps.init_params(cfg, seed=0, device=dev)
    pre = InputShape("prefill_check", "prefill", 256, 2)
    tokens = torch.from_numpy(LMDataset(cfg.vocab_size, 256, seed=5).batch(
        2, 0)["tokens"]).to(dev)
    got = steps.build_step(cfg, pre, dtype=f32).fn(params, tokens)
    want = transformer.prefill(params, cfg, tokens, max_len=256, dtype=f32)
    prefill_equal = all(torch.equal(x, y) for x, y in zip(
        tree.leaves(got), tree.leaves(want)))
    check(prefill_equal, "18d: the prefill bundle differs from "
                         "transformer.prefill")
    dec = InputShape("decode_check", "decode", 256, 2)
    cache_a = got[1]
    cache_b = tree.map(lambda x: x.clone(), cache_a)
    tok = tokens[:, -1:]
    cur = torch.full((2,), 256, dtype=torch.int32, device=dev)
    la, ca = steps.build_step(cfg, dec, dtype=f32).fn(params, tok, cache_a,
                                                       cur)
    lb, cb = transformer.decode_step(params, cfg, tok, cache_b, cur,
                                     dtype=f32)
    decode_equal = torch.equal(la, lb) and all(
        torch.equal(x, y) for x, y in zip(tree.leaves(ca), tree.leaves(cb)))
    check(decode_equal, "18d: the decode bundle differs from "
                        "transformer.decode_step")
    del params, got, want, cache_a, cache_b, la, lb, ca, cb
    gc_collect()
    # the abstract trees at full width against the real ones
    real = steps.init_params(full, seed=0, device=dev)
    opt = steps.make_optimizer(full)
    ab_p = steps.abstract_params(full)
    trees = {"params": (_tree_layout(ab_p), _tree_layout(real)),
             "opt_state": (_tree_layout(steps.abstract_opt_state(opt, ab_p)),
                           _tree_layout(opt.init(real)))}
    del real
    gc_collect()
    shape = dataclasses.replace(configs.SHAPES["decode_32k"], global_batch=1)
    trees["cache"] = (
        _tree_layout(steps.abstract_cache(full, shape)),
        _tree_layout(transformer.init_cache(full, 1, shape.seq_len,
                                            device=dev)))
    for what, (abstract, concrete) in trees.items():
        check(abstract == concrete, f"18d: the abstract {what} tree differs "
                                    f"from the real one")
    out = {"train_bitwise": train_equal, "prefill_bitwise": prefill_equal,
           "decode_bitwise": decode_equal,
           "abstract_leaves": {k: len(v[0]) for k, v in trees.items()}}
    print(f"18d {STEPS_ARCH} (2 layers, fp32): the train bundle equals the "
          f"hand-built flat executor bit for bit ({plan.describe()}); "
          f"prefill and decode bundles equal transformer.prefill / "
          f"decode_step bit for bit; at full width the abstract params, "
          f"optimizer state and decode_32k cache equal the real trees "
          f"({out['abstract_leaves']} leaves)", flush=True)
    gc_collect()
    return out


def steps_phases(timed, dev) -> dict:
    return {"train": timed("18a train_4k", steps_train_phase, dev),
            "serve": timed("18b/18c long_500k, prefill_32k, decode_32k",
                           steps_serve_phase, dev),
            "check": timed("18d step checks", steps_check_phase, dev)}


# ---------------------------------------------------------------------------
# 20. the engine contract checker and the dry run
# ---------------------------------------------------------------------------

# 20a: the suite's targets on the card (reduced configs at the reference's
# analysis geometry: seq 32, mini-batch 32 in 4 micro-batches)
ANALYSIS_RUNS = [("qwen2_reduced", "compiled"), ("qwen2_reduced", "streaming"),
                 ("qwen2_reduced", "fused"), ("qwen2_reduced", "flat"),
                 ("resnet50", "flat")]


def analysis_phase(dev) -> dict:
    """20a / 20b. ``repro_torch.analysis`` on the card: the suite over
    ANALYSIS_RUNS and the serve suite over both serve targets, each step
    recorded under ``torch.cuda.set_sync_debug_mode`` (JX003 counts every
    synchronizing call), HLO003 / SRV002 reading ``max_memory_allocated``,
    with the launch counters zeroed just before and read just after: zero
    findings, K1 launched by ``fused`` and ``flat`` and K2 by ``flat``
    (20a). Then the seeded faults (20b): ``fused`` accumulating in bf16
    under an fp32 contract (its K1 calls carry the bf16 accumulator)
    fires JX001, and an undonated pool fires SRV001."""
    import torch
    from repro_torch import analysis, engine, kernels
    from repro_torch.analysis import suite

    card = card_line()
    gc_collect()
    reports = {}
    kernels.reset_launch_counts()
    for target, ex_name in ANALYSIS_RUNS:
        rep = analysis.run_suite(target, executor=ex_name, lint=False,
                                 device=dev)
        reports[f"{target}/{ex_name}"] = rep
    for arch in analysis.SERVE_TARGETS:
        reports[f"serve {arch}"] = analysis.run_serve_suite(arch, device=dev)
    counts = kernels.launch_counts()
    lint = analysis.lint_repo()
    out = {"card": card, "counts": counts, "lint_findings": len(lint),
           "runs": {}}
    for name, rep in reports.items():
        check(rep.ok, f"20a {name}: {rep.format()}")
        out["runs"][name] = {k: rep.context.get(k) for k in
                             ("peak_bytes", "peak_source",
                              "kernel_launches")}
        out["runs"][name]["checks"] = list(rep.checks_run)
        print(f"20a {name} [{card}]: zero findings over "
              f"{', '.join(rep.checks_run)}; peak "
              f"{rep.context.get('peak_bytes')} B "
              f"({rep.context.get('peak_source')}), kernel launches "
              f"{rep.context.get('kernel_launches', 0)}", flush=True)
    check(not lint, f"20a: the lint found {[f.format() for f in lint]}")
    n_micro = suite.ANALYSIS_MICROS
    # fused and flat over qwen2 and flat over ResNet-50: K1 once a micro-
    # batch and launch group; flat's K2 once a bucket
    check(counts["grad_accum"] >= 3 * n_micro
          and counts["fused_sgd_mom"] >= 2,
          f"20a: launches {counts}, expected K1 from fused and flat and K2 "
          f"from flat")
    print(f"20a launches (counters zeroed before, read after): {counts}",
          flush=True)

    # 20b: the seeded faults fire on the card
    built = suite.TARGETS["qwen2_reduced"].build("fused", None, "period",
                                                 dev)
    fp32_plan = built["plan"]
    built["plan"] = dataclasses.replace(fp32_plan,
                                        accum_dtype=torch.bfloat16)
    ex = suite.make_executor(built, "fused", None)
    params, state, split = suite._state(ex, built, dev)
    trace = ex.trace_step(params, state, split)
    jx001 = analysis.check_accum_dtype(trace, fp32_plan, params)
    check({f.rule for f in jx001} == {"JX001"},
          f"20b: a bf16 accumulator gave {[f.format() for f in jx001]}")
    bf16_k1 = sum(1 for c in trace.kernels if c.name == "grad_accum"
                  and c.launched and "bfloat16" in c.write_dtypes)
    srv = analysis.run_serve_suite("qwen2-1.5b", donate=False, device=dev)
    check({f.rule for f in srv.findings} == {"SRV001"},
          f"20b: an undonated pool gave {srv.format()}")
    out["seeded"] = {"bf16_accumulator": sorted({f.rule for f in jx001}),
                     "bf16_k1_calls": bf16_k1,
                     "undonated_pool": sorted({f.rule
                                               for f in srv.findings})}
    print(f"20b [{card}]: a bf16 accumulator fired {len(jx001)} JX001 "
          f"finding(s) ({bf16_k1} K1 calls into bf16 accumulators); an "
          f"undonated pool fired {[f.rule for f in srv.findings]}",
          flush=True)
    del ex, params, state, split, trace, built
    gc_collect()
    return out


def dryrun_phase(dev, st_train: dict) -> dict:
    """20c. ``launch.dryrun.run_dryrun`` of full-width qwen2-1.5b
    ``train_4k`` at 18a's cut (STEPS_TRAIN_LAYERS layers), the ``flat``
    executor, at 18a's plan (its N_Smu and remat policy pinned, so the
    planner gives its micro size), its step run under a
    ``FakeTensorMode`` on fake CUDA tensors (nothing allocated): its
    predicted peak beside 18a's allocator peak and
    calibrated prediction; its FLOPs per step (FlopCounterMode), and
    18a's TFLOP/s from them against the bf16 peak."""
    import torch
    from repro_torch.launch import dryrun

    card = card_line()
    gc_collect()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    res = dryrun.run_dryrun(
        STEPS_ARCH, "train_4k", executor="flat",
        num_microbatches=st_train["num_micro_batches"],
        remat_policy=st_train["remat"],
        cfg_overrides={"num_layers": STEPS_TRAIN_LAYERS},
        plan_budget_bytes=CALIBRATION_BUDGET_GB * GIB, device=dev,
        probe=False, verbose=False)
    wall = time.perf_counter() - t0
    check(torch.cuda.memory_allocated(dev) == before,
          "20c: the dry run allocated on the card")
    got = (res["num_microbatches"], res["per_device"]["local_micro"],
           res["remat_policy"])
    want = (st_train["num_micro_batches"], st_train["micro"],
            st_train["remat"])
    check(got == want, f"20c: the dry run's plan (N_Smu, micro, remat) "
                       f"{got} is not 18a's {want}")
    peak = res["memory"]["peak_bytes_est"]
    flops = res["raw_cost_analysis"]["flops"]
    tflops = flops / st_train["first_step_s"] / 1e12
    out = {"card": card, "plan": res["per_device"]["plan"],
           "predicted_peak_bytes": peak,
           "allocator_peak_bytes_18a": st_train["peak_bytes"],
           "calibrated_prediction_bytes_18a":
               st_train["calibrated_prediction_bytes"],
           "modeled_bytes": res["oracle"]["modeled_bytes"],
           "flops_per_step": flops,
           "bytes_accessed": res["raw_cost_analysis"]["bytes accessed"],
           "ops": res["ops"], "kernel_calls": res["kernel_calls"],
           "first_step_s_18a": st_train["first_step_s"],
           "tflops_18a": tflops, "bf16_peak_share": tflops * 1e12
           / BF16_FLOPS_PER_S, "dryrun_s": wall, "step_s": res["step_s"]}
    print(f"20c dry run of {STEPS_ARCH} train_4k at {STEPS_TRAIN_LAYERS} "
          f"layers [{card}]: {out['plan']}; predicted peak {peak} B "
          f"({peak / GIB:.3f} GiB) beside 18a's allocator peak "
          f"{st_train['peak_bytes'] / GIB:.3f} GiB and calibrated "
          f"prediction {st_train['calibrated_prediction_bytes'] / GIB:.3f}"
          f" GiB (memory model {res['oracle']['modeled_bytes'] / GIB:.3f} "
          f"GiB); {flops:.6e} FLOPs a step, so 18a's first step of "
          f"{st_train['first_step_s']:.3f} s ran {tflops:.2f} TFLOP/s, "
          f"{100 * out['bf16_peak_share']:.2f} % of the "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; "
          f"{res['ops']} ops, kernel calls {res['kernel_calls']}; "
          f"{wall:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 21: the GSPMD mesh (tensor and FSDP sharding by the reference's
# param_specs) on four ranks sharing the card
# ---------------------------------------------------------------------------

# 21a: full-width qwen2-1.5b cut in depth only. Every collective of a rank
# sharing the card goes through the host over gloo (launch.mesh.
# host_staged_collectives: 0.29 GB/s for a 256 MB all-gather of two ranks
# in the probe), and the step re-gathers the weights each micro-batch, so
# the depth, the micro-batch count and the steps are what the run's time
# allows
GSPMD_DIMS = (2, 2)
GSPMD_LAYERS = 2
GSPMD_SEQ = 1024
GSPMD_MINI = 16  # the main path's mini-batch
GSPMD_MICROBATCHES = 2
# the first a warm-up (DTensor's propagation cache), the second the steady
# one, under the census (cut from 3 for the run's time limit)
GSPMD_STEPS = 2
GSPMD_CHECK_LAYERS = 2
GSPMD_CHECK_STEPS = 2
GSPMD_CHECK_SEQ = 128


def _gspmd_spec_bytes(cfg, dims, fsdp: bool = True) -> int:
    """Σ numel / shard_factor × 4 over the leaves of ``cfg``'s params under
    the reference's ``param_specs(fsdp=fsdp)`` on ``dims``."""
    from repro_torch import tree
    from repro_torch.core import memory_model
    from repro_torch.launch import sharding
    shapes = memory_model.param_shapes(cfg)
    specs = sharding.spec_leaves(sharding.param_specs(shapes, dims,
                                                      fsdp=fsdp))
    return sum(x.numel() // sharding.shard_factor(sp, dims) * 4
               for x, sp in zip(tree.leaves(shapes), specs))


def gspmd_main_rank(mesh, layers: int, steps: int, fsdp: bool = True
                    ) -> dict:
    """21a on one rank: full-width qwen2-1.5b at ``layers`` layers, bf16,
    seq 1024, mini-batch 16 in GSPMD_MICROBATCHES micro-batches, SGD-m,
    through ``launch.steps.build_train_step(mesh=gspmd_mesh(2, 2),
    executor="flat", fsdp=fsdp)`` — the ``GspmdExecutor`` over ``flat``,
    K1 and K2 on this rank's blocks (``fsdp=False``: the params replicated
    over ``data``, 21a's twin). The launch counters are zeroed before the
    first step and read after the last; the first step is a warm-up (it
    fills DTensor's propagation cache), the steps after it are the steady
    ones, and the second runs under the collective census; the peak beside
    ``memory_model.estimate(mesh=, fsdp_params=fsdp)``."""
    import numpy as np
    import torch
    from repro_torch import configs, engine, kernels, optim
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import memory_model
    from repro_torch.data import LMDataset
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib

    dev = mesh.device
    gm = mesh_lib.gspmd_mesh(mesh, *GSPMD_DIMS)
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=layers)
    budget = int(memory_model.device_memory_bytes(dev)
                 * mesh.memory_fraction)
    bundle = steps_lib.build_train_step(
        cfg, InputShape("21a", "train", GSPMD_SEQ, GSPMD_MINI),
        num_microbatches=GSPMD_MICROBATCHES, executor="flat", mesh=gm,
        fsdp=fsdp, budget_bytes=budget, device=dev)
    ex, plan, opt = bundle.runner, bundle.plan, bundle.optimizer
    t0 = time.perf_counter()
    params = steps_lib.init_params(cfg, seed=0, device=dev)
    p, s = ex.prepare(params, opt.init(params))
    del params
    prepare_s = time.perf_counter() - t0
    local_bytes = ex.local_param_bytes(p)
    ds = LMDataset(cfg.vocab_size, GSPMD_SEQ, seed=0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    losses, step_s, census = [], [], None
    for i in range(steps):
        split = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in ex.shard(plan.split(
                     ds.batch(GSPMD_MINI, i))).items()}
        t0 = time.perf_counter()
        if i == 1:
            with engine.CollectiveCensus(gm) as cc:
                p, s, m = bundle.fn(p, s, split)
            census = cc.summary()
        else:
            p, s, m = bundle.fn(p, s, split)
        losses.append(float(m["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    est = memory_model.estimate(
        cfg, GSPMD_SEQ, mesh=dict(gm), fsdp_params=fsdp, act_bytes=2,
        remat_policy=plan.remat_policy,
        **optim.memory_model_kw(opt, fused=True)).total(plan.local_micro)
    n_b = engine.FlatSpec.for_tree(p).num_buckets
    finite = all(bool(torch.isfinite(t).all()) for t in
                 engine.FlatSpec.for_tree(p).buffers_of(p))
    return {"rank": mesh.rank, "coords": gm.coords(), "plan": plan.describe(),
            "num_micro_batches": plan.num_micro_batches,
            "local_micro": plan.local_micro, "losses": losses,
            "step_s": step_s, "prepare_s": prepare_s, "census": census,
            "counts": counts, "buckets": n_b, "params_finite": finite,
            "local_param_bytes": local_bytes, "peak_bytes": peak,
            "estimate_bytes": est, "memory_fraction": mesh.memory_fraction}


def gspmd_check_rank(mesh, layers: int, steps: int, fsdp: bool = True
                     ) -> dict:
    """21b on one rank: ``steps`` steps of the 2 × 2 GSPMD step (``flat``;
    ``fsdp=False``: the params replicated over ``data``, 21b's twin) at
    ``layers`` layers of full qwen2-1.5b width, fp32, TF32 off, against
    one device's ``compiled`` steps on the same global mini-batches
    (computed on this rank's device): this rank's params and momentum
    blocks against the same blocks of the reference's (``prepare`` cuts
    them), within phase 5's rtol / atol 1e-6."""
    import numpy as np
    import torch
    from repro_torch import configs, engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    gm = mesh_lib.gspmd_mesh(mesh, *GSPMD_DIMS)
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=layers)
    sgd = lambda: optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)  # noqa
    ds = LMDataset(cfg.vocab_size, GSPMD_CHECK_SEQ, seed=0)
    batches = [ds.batch(8, i) for i in range(steps)]
    loss_fn = steps_lib.make_loss_fn(cfg, dtype=torch.float32,
                                     remat_policy="none")
    one_plan = engine.plan_mbs(8, num_microbatches=2, remat_policy="none",
                               device=dev)
    one = engine.CompiledScanExecutor(loss_fn, sgd(), one_plan)
    ref_p = steps_lib.init_params(cfg, seed=0, device=dev)
    ref_s = sgd().init(ref_p)
    ref_losses = []
    for b in batches:
        ref_p, ref_s, m = one.step_split(ref_p, ref_s,
                                         one_plan.device_split(b, dev))
        ref_losses.append(float(m["loss"]))
    plan = engine.plan_mbs(8, num_microbatches=2, remat_policy="none",
                           mesh=gm, fsdp_params=fsdp, device=dev)
    ex = engine.GspmdExecutor(loss_fn, sgd(), plan, mesh=gm, inner="flat",
                              fsdp=fsdp)
    params = steps_lib.init_params(cfg, seed=0, device=dev)
    p, s = ex.prepare(params, sgd().init(params))
    del params
    losses = []
    for b in batches:
        split = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in ex.shard(plan.split(b)).items()}
        p, s, m = ex.step_split(p, s, split)
        losses.append(float(m["loss"]))
    want_p, want_s = ex.prepare(ref_p, ref_s)
    worst, ok = 0.0, True
    for x, y in zip(tree.leaves((p, s["mom"])),
                    tree.leaves((want_p, want_s["mom"]))):
        err, fine = max_violation(x, y)
        worst, ok = max(worst, err), ok and fine
    del ex, p, s, want_p, want_s, ref_p, ref_s, one
    gc_collect()
    return {"plan": plan.describe(), "losses": losses,
            "ref_losses": ref_losses, "max_abs_err": worst, "within": ok}


def _gspmd_train_run(world, fsdp: bool) -> dict:
    """21a (``fsdp``) or its twin without FSDP, then 21b or its twin, on
    ``world``: every rank's losses finite and equal, the first near
    ln(vocab); its parameter bytes the spec arithmetic of the placement;
    K1 launched steps × N_Smu × buckets and K2 steps × buckets on every
    rank; 21b's params and momentum within its tolerance of one device.
    Returns the results and prints them."""
    from repro_torch import configs

    card = card_line()
    n = GSPMD_DIMS[0] * GSPMD_DIMS[1]
    label = ("21a", "21b") if fsdp else ("21a without FSDP",
                                          "21b without FSDP")
    t0 = time.perf_counter()
    res = world.run(gspmd_main_rank, GSPMD_LAYERS, GSPMD_STEPS, fsdp)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chk = world.run(gspmd_check_rank, GSPMD_CHECK_LAYERS, GSPMD_CHECK_STEPS,
                    fsdp)
    check_s = time.perf_counter() - t0
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=GSPMD_LAYERS)
    want_bytes = _gspmd_spec_bytes(cfg, dict(zip(("data", "model"),
                                                 GSPMD_DIMS)), fsdp)
    r0 = res[0]
    for r in res:
        check(all(math.isfinite(x) for x in r["losses"]) and
              r["params_finite"], f"{label[0]} rank {r['rank']}: losses "
                                  f"{r['losses']} or params not finite")
        check(r["losses"] == r0["losses"],
              f"{label[0]}: rank {r['rank']}'s losses {r['losses']} differ "
              f"from rank 0's {r0['losses']}")
        check(r["local_param_bytes"] == want_bytes,
              f"{label[0]} rank {r['rank']}: {r['local_param_bytes']} B of "
              f"parameter blocks, the spec arithmetic says {want_bytes}")
        k1 = GSPMD_STEPS * r["num_micro_batches"] * r["buckets"]
        k2 = GSPMD_STEPS * r["buckets"]
        check(r["counts"]["grad_accum"] == k1,
              f"{label[0]} rank {r['rank']}: K1 launched "
              f"{r['counts']['grad_accum']} times, expected {k1}")
        check(r["counts"]["fused_sgd_mom"] == k2,
              f"{label[0]} rank {r['rank']}: K2 launched "
              f"{r['counts']['fused_sgd_mom']} times, expected {k2}")
    check(abs(r0["losses"][0] - math.log(cfg.vocab_size)) < 1.0,
          f"{label[0]}: first loss {r0['losses'][0]:.4f} is far from "
          f"ln(vocab) {math.log(cfg.vocab_size):.4f}")
    if not fsdp:  # the gradients all-reduced over data, no weight gathered
        by = r0["census"]["by_kind_and_axis"]
        check(by.get("all_reduce", {}).get("data", 0) > 0,
              f"{label[0]}: no all-reduce over data in {by}")
        check("data" not in r0["census"]["params_by_kind_and_axis"].get(
            "all_gather", {}) and "data" not in by.get("reduce_scatter", {}),
              f"{label[0]}: a weight gathered or a gradient scattered over "
              f"data: {r0['census']}")
    steady = r0["step_s"][1:]
    step_s = sum(steady) / len(steady)
    tokens = GSPMD_MINI * GSPMD_SEQ
    for c in chk:
        check(c["within"], f"{label[1]}: a rank's params/momentum differ "
                           f"from one device's compiled by "
                           f"{c['max_abs_err']:.3e} (rtol 1e-6, atol 1e-6)")
        for x, y in zip(c["losses"], c["ref_losses"]):
            check(abs(x - y) <= 1e-5 * abs(y),
                  f"{label[1]}: loss {x} vs one device's {y}")
    out = {"card": card, "fsdp": fsdp, "plan": r0["plan"],
           "losses": r0["losses"], "step_s": r0["step_s"],
           "steady_step_s": step_s, "tokens_per_s": tokens / step_s,
           "census": r0["census"],
           "counts": {f"rank{r['rank']}": r["counts"] for r in res},
           "local_param_bytes": want_bytes,
           "peak_bytes": [r["peak_bytes"] for r in res],
           "estimate_bytes": r0["estimate_bytes"],
           "prepare_s": [r["prepare_s"] for r in res],
           "train_s": train_s, "check_s": check_s,
           "check": {"plan": chk[0]["plan"], "losses": chk[0]["losses"],
                     "ref_losses": chk[0]["ref_losses"],
                     "max_abs_err": max(c["max_abs_err"] for c in chk)}}
    print(f"{label[0]} [{card}]: GSPMD {GSPMD_DIMS[0]}x{GSPMD_DIMS[1]} "
          f"(data x model, params "
          f"{'FSDP over data' if fsdp else 'replicated over data'}) on {n} "
          f"ranks sharing the card over gloo, qwen2-1.5b at "
          f"{GSPMD_LAYERS} of 28 layers, full width, bf16, seq "
          f"{GSPMD_SEQ}: {r0['plan']}; losses {r0['losses']} on every rank;"
          f" step seconds {r0['step_s']} (the first a warm-up, the second "
          f"under the census), steady {step_s:.3f} s, "
          f"{tokens / step_s:.1f} tokens/s; parameter blocks {want_bytes} B"
          f" a rank (the spec arithmetic); peaks "
          f"{[r['peak_bytes'] for r in res]} B beside the memory model's "
          f"{r0['estimate_bytes']} B (fsdp_params={fsdp}); collectives of "
          f"the second step {r0['census']}; launches "
          f"{[r['counts'] for r in res]} by rank; {train_s:.1f} s",
          flush=True)
    print(f"{label[1]} [{card}]: GSPMD {GSPMD_DIMS[0]}x{GSPMD_DIMS[1]} flat "
          f"== one device's compiled after {GSPMD_CHECK_STEPS} steps at "
          f"qwen2-1.5b width, {GSPMD_CHECK_LAYERS} layers, fp32, TF32 off "
          f"(losses {chk[0]['losses']} vs {chk[0]['ref_losses']}, max abs "
          f"err {out['check']['max_abs_err']:.3e}); {check_s:.1f} s",
          flush=True)
    return out


def gspmd_train_phase(world) -> dict:
    """21a and 21b on ``world``, a ``LocalWorld`` of four ranks sharing
    the card (gloo, each capped at 0.24 of its memory), with the params
    FSDP over ``data`` and then replicated over it (the twins; see
    :func:`_gspmd_train_run`, :func:`gspmd_main_rank` and
    :func:`gspmd_check_rank`). The twin's first loss is the FSDP step's
    (the same forward on the same weights)."""
    gc_collect()
    n = GSPMD_DIMS[0] * GSPMD_DIMS[1]
    check(world.n == n, f"21 runs on {n} ranks, the world has {world.n}")
    out = _gspmd_train_run(world, True)
    out["no_fsdp"] = twin = _gspmd_train_run(world, False)
    check(abs(twin["losses"][0] - out["losses"][0])
          <= 1e-3 * abs(out["losses"][0]),
          f"21a without FSDP: first loss {twin['losses'][0]} vs the FSDP "
          f"step's {out['losses'][0]}")
    return out


def gspmd_dryrun_phase(dev, st_train: dict) -> dict:
    """21c. The dry run of 18a's step (``train_4k`` at STEPS_TRAIN_LAYERS
    layers, ``flat``, its N_Smu and remat policy pinned) as one rank of
    the 16 × 16 production mesh: a fake world of 256 ranks in this
    process, fake CUDA tensors (nothing allocated on the card): the
    rank's peak, parameter bytes (the spec arithmetic) and FLOPs, and its
    collectives by kind and axis; then the same with ``--no-fsdp``
    (``run_dryrun(fsdp=False)``), whose parameter bytes are
    ``param_specs(fsdp=False)``'s arithmetic and whose census all-reduces
    over ``data`` and gathers no weight there."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun

    card = card_line()
    cfg = dataclasses.replace(configs.get(STEPS_ARCH),
                              num_layers=STEPS_TRAIN_LAYERS)
    out = {"card": card}
    for fsdp in (True, False):
        gc_collect()
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        res = dryrun.run_dryrun(
            STEPS_ARCH, "train_4k", executor="flat",
            num_microbatches=st_train["num_micro_batches"],
            remat_policy=st_train["remat"],
            cfg_overrides={"num_layers": STEPS_TRAIN_LAYERS},
            plan_budget_bytes=CALIBRATION_BUDGET_GB * GIB, device=dev,
            mesh_spec="production", probe=False, verbose=False, fsdp=fsdp)
        wall = time.perf_counter() - t0
        label = "21c" if fsdp else "21c without FSDP"
        check(torch.cuda.memory_allocated(dev) == before,
              f"{label}: the dry run allocated on the card")
        g = res["gspmd"]
        want = _gspmd_spec_bytes(cfg, g["mesh"], fsdp)
        check(g["local_param_bytes"] == want,
              f"{label}: {g['local_param_bytes']} B of parameter blocks, "
              f"the spec arithmetic says {want}")
        check(g["collectives"]["calls"] > 0, f"{label}: no collective "
                                             "counted")
        by = g["collectives"]["by_kind_and_axis"]
        gathered = g["collectives"]["params_by_kind_and_axis"].get(
            "all_gather", {})
        if fsdp:
            check("data" in gathered, f"{label}: no weight gathered over "
                                      f"data: {g['collectives']}")
        else:
            check(by.get("all_reduce", {}).get("data", 0) > 0
                  and "data" not in gathered,
                  f"{label}: want an all-reduce over data and no weight "
                  f"gathered there: {g['collectives']}")
        rec = {"plan": g["plan"], "world": g["world"],
               "local_param_bytes": g["local_param_bytes"],
               "peak_bytes": g["peak_bytes"], "flops": g["flops"],
               "modeled_bytes": res["oracle"]["modeled_bytes"],
               "collectives": g["collectives"], "dryrun_s": wall}
        if fsdp:
            out.update(rec)
        else:
            out["no_fsdp"] = rec
        print(f"{label} dry run of {STEPS_ARCH} train_4k at "
              f"{STEPS_TRAIN_LAYERS} layers as rank 0 of the {g['world']}-"
              f"rank production mesh {g['mesh']} [{card}]: {g['plan']}; "
              f"parameter blocks {g['local_param_bytes']} B; peak "
              f"{g['peak_bytes']} B ({g['peak_bytes'] / GIB:.3f} GiB) "
              f"beside the memory model's {res['oracle']['modeled_bytes']} B"
              f" (fsdp_params={fsdp}); {g['flops']:.6e} FLOPs a step; "
              f"collectives {g['collectives']}; {wall:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 22: the runtime on the GSPMD world: --supervise and the serve launcher
# ---------------------------------------------------------------------------

# 22a: 21b's size (full qwen2-1.5b width, GSPMD_CHECK_LAYERS layers, fp32,
# seq GSPMD_CHECK_SEQ, mini-batch 8 in 2 micro-batches, `flat`) under the
# supervisor for SUP_STEPS steps: a NaN in one data block at step
# SUP_NAN_STEP (retried clean), and an out-of-memory error raised on rank
# SUP_OOM_RANK alone inside its forward at step SUP_OOM_STEP, before its
# second layer's attention: after the first layer's collectives, before
# the second's. No checkpoint is written, so every rank anchors its own
# blocks (a host copy, no collective) every SUP_ANCHOR_EVERY steps, and the
# recovery resumes from the anchor at SUP_OOM_STEP
SUP_STEPS = 4
SUP_ANCHOR_EVERY = 2
SUP_NAN_STEP = 1
SUP_OOM_STEP = 2
SUP_OOM_RANK = 1
# step_fn calls (the NaN step is retried once): the NaN step's, the OOM's
SUP_NAN_CALL = SUP_NAN_STEP + 1
SUP_OOM_CALL = SUP_OOM_STEP + 2
# 22b: phase 14a's traffic through the serve launcher on the four ranks
SERVE_WORLD_ARGV = SERVE_ARGV["qwen2-1.5b"]


def gspmd_supervised_rank(mesh, layers: int, steps: int) -> dict:
    """22a on one rank: ``engine.Supervisor`` over ``GspmdExecutor(
    guard=True)`` (``flat``) on the 2 × 2 mesh, ``fit`` of ``steps`` steps
    under ``faults.nan_at(SUP_NAN_STEP)``, anchoring the rank's blocks
    every SUP_ANCHOR_EVERY steps, with ``attention.attn_block`` wrapped on
    this rank to raise the OOM on SUP_OOM_RANK (the degrade has no plan
    context: remat one rung up). The records, recovery seconds, losses,
    final plan, whether the NaN step left the rank's blocks
    bit-identical, K1 / K2 launches and K2's guarded calls, the anchors,
    and a CRC32 of each block of the final state (params and momentum)
    keyed by the leaf and the block's place in the whole tensor: the
    phase puts the whole state's hash together from every rank's, with
    no gather."""
    import torch
    from repro_torch import configs, engine, kernels, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.engine import exec_core, faults
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    gm = mesh_lib.gspmd_mesh(mesh, *GSPMD_DIMS)
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=layers)
    sgd = lambda: optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)  # noqa
    ds = LMDataset(cfg.vocab_size, GSPMD_CHECK_SEQ, seed=0)
    seen = {"step": 0, "attn": 0, "guarded": 0, "nan_kept": None}
    attn_block, fused_sgd = attention.attn_block, exec_core.fused_sgd

    def attn_in_forward(*a, **kw):
        seen["attn"] += 1
        if (mesh.rank == SUP_OOM_RANK and seen["step"] == SUP_OOM_CALL
                and seen["attn"] == 2):
            raise faults.injected_oom("inside the forward, before the "
                                      "second layer's attention")
        return attn_block(*a, **kw)

    def counted_sgd(*a, ok=None, **kw):
        seen["guarded"] += ok is not None
        return fused_sgd(*a, ok=ok, **kw)

    def build(plan):
        loss_fn = steps_lib.make_loss_fn(cfg, dtype=torch.float32,
                                         remat_policy=plan.remat_policy)
        ex = engine.GspmdExecutor(loss_fn, sgd(), plan, mesh=gm,
                                  inner="flat", guard=True)

        def step_fn(p, s, batch):
            seen["step"] += 1
            seen["attn"] = 0
            before = None
            if seen["step"] == SUP_NAN_CALL:
                before = [t.clone() for t in tree.leaves((p, s))]
            p, s, m = ex.step_split(p, s, batch)
            if before is not None:
                seen["nan_kept"] = all(torch.equal(x, y) for x, y in zip(
                    before, tree.leaves((p, s))))
            return p, s, m
        return ex, step_fn, engine.Pipeline(ds, plan, prefetch=0, device=dev,
                                            sharding=ex.shard)

    attention.attn_block, exec_core.fused_sgd = attn_in_forward, counted_sgd
    try:
        plan = engine.plan_mbs(8, num_microbatches=2, remat_policy="none",
                               mesh=gm, device=dev)
        sup = engine.Supervisor(build, plan, log_fn=None,
                                writer=mesh.rank == 0,
                                ckpt_every=SUP_ANCHOR_EVERY)
        params = steps_lib.init_params(cfg, seed=0, device=dev)
        p, s = sup.executor.prepare(params, sgd().init(params))
        del params
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with faults.inject(faults.FaultPlan(faults.nan_at(SUP_NAN_STEP))
                           ) as fp:
            p, s, _ = sup.fit(p, s, steps)
        torch.cuda.synchronize(dev)
        fit_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        attention.attn_block, exec_core.fused_sgd = attn_block, fused_sgd
    buckets = engine.FlatSpec.for_tree(p).num_buckets
    (bp, bs), (full_p, full_s) = sup.executor.local_state(p, s)
    specs = sharding.spec_leaves(sup.executor.param_specs(full_p))
    blocks = {}
    for part, (blk, full) in enumerate(((bp, full_p),
                                        (bs["mom"], full_s["mom"]))):
        for i, (b, f, spec) in enumerate(zip(tree.leaves(blk),
                                             tree.leaves(full), specs)):
            where = sharding.local_slices(tuple(f.shape), spec, gm,
                                          gm.coords())
            key = (part, i, tuple(sl.indices(n)[:2]
                                  for sl, n in zip(where, f.shape)))
            blocks[key] = zlib.crc32(b.contiguous().reshape(-1)
                                     .view(torch.uint8).numpy())
    out = {"rank": mesh.rank,
           "records": [(r.kind, r.step, r.action, r.steps_lost, r.detail)
                       for r in sup.records],
           "recovery_s": [r.recovery_s for r in sup.records],
           "fired": list(fp.fired), "plan": plan.describe(),
           "final_plan": sup.plan.describe(),
           "history": dict(sup.history), "nan_kept": seen["nan_kept"],
           "counts": counts, "guarded_k2": seen["guarded"],
           "buckets": buckets, "blocks_crc32": blocks,
           "anchors": sup.report()["anchors"], "fit_s": fit_s,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del sup, p, s, bp, bs
    gc_collect()
    return out


def gspmd_supervised_phase(world) -> dict:
    """22a. ``--supervise`` on the GSPMD world (:func:`gspmd_supervised_rank`
    on every rank of 21's world): every rank's records equal — the NaN
    step retried clean, the OOM agreed at SUP_OOM_STEP naming rank
    SUP_OOM_RANK, the groups started anew — the run finished on the
    degraded plan with every rank's losses equal, every block of the final
    state equal on the ranks that hold it (the whole state's CRC32 put
    together from them), the NaN step's state bit-identical to the state
    before it, and K1 and
    K2's ``GUARD`` variant launched on every rank (K2 once a bucket for
    each step run to its update, and only guarded)."""
    card = card_line()
    gc_collect()
    t0 = time.perf_counter()
    res = world.run(gspmd_supervised_rank, GSPMD_CHECK_LAYERS, SUP_STEPS)
    wall = time.perf_counter() - t0
    r0 = res[0]
    kinds = [(k, st, act, lost) for k, st, act, lost, _ in r0["records"]]
    check(kinds == [("nonfinite", SUP_NAN_STEP, "retried ok (attempt 1)",
                     0),
                    ("oom", SUP_OOM_STEP, "remat none->dots",
                     SUP_OOM_STEP % SUP_ANCHOR_EVERY)],
          f"22a: records {r0['records']}")
    check(f"rank(s) [{SUP_OOM_RANK}] of {world.n}" in r0["records"][1][4]
          and "started anew" in r0["records"][1][4],
          f"22a: the OOM record does not name rank {SUP_OOM_RANK}'s fault "
          f"agreed over new groups: {r0['records'][1][4]}")
    check("remat dots" in r0["final_plan"],
          f"22a: final plan {r0['final_plan']}")
    check(sorted(r0["history"]) == list(range(SUP_STEPS)) and all(
        math.isfinite(x) for x in r0["history"].values()),
        f"22a: losses {r0['history']}")
    # steps run to their update: those before the OOM step, the NaN step's
    # retry, then from the anchor before the OOM step to the end
    resume = SUP_OOM_STEP - SUP_OOM_STEP % SUP_ANCHOR_EVERY
    updates = SUP_OOM_STEP + 1 + SUP_STEPS - resume
    blocks = {}
    for r in res:
        for key, crc in r["blocks_crc32"].items():
            check(blocks.setdefault(key, crc) == crc,
                  f"22a rank {r['rank']}: block {key} differs from another "
                  "rank's copy of it")
    state_crc = zlib.crc32(repr(sorted(blocks.items())).encode())
    for r in res:
        for key in ("records", "final_plan", "history"):
            check(r[key] == r0[key], f"22a rank {r['rank']}: {key} "
                                     f"{r[key]} differs from rank 0's "
                                     f"{r0[key]}")
        check(r["nan_kept"] is True, f"22a rank {r['rank']}: the NaN step "
                                     "changed the rank's blocks")
        k2 = updates * r["buckets"]
        check(r["counts"]["fused_sgd_mom"] == r["guarded_k2"] == k2,
              f"22a rank {r['rank']}: K2 launched "
              f"{r['counts']['fused_sgd_mom']} times, {r['guarded_k2']} "
              f"guarded, expected {k2}")
        check(r["counts"]["grad_accum"] >= updates * 2 * r["buckets"],
              f"22a rank {r['rank']}: K1 launched "
              f"{r['counts']['grad_accum']} times")
    out = {"card": card, "plan": r0["plan"], "final_plan": r0["final_plan"],
           "records": r0["records"],
           "recovery_s": {f"rank{r['rank']}": r["recovery_s"] for r in res},
           "losses": r0["history"], "state_crc32": state_crc,
           "blocks": len(blocks),
           "counts": {f"rank{r['rank']}": r["counts"] for r in res},
           "fit_s": [r["fit_s"] for r in res], "anchors": r0["anchors"],
           "peak_bytes": [r["peak_bytes"] for r in res], "wall_s": wall}
    print(f"22a [{card}]: --supervise on the GSPMD {GSPMD_DIMS[0]}x"
          f"{GSPMD_DIMS[1]} world, qwen2-1.5b at {GSPMD_CHECK_LAYERS} layers, "
          f"full width, fp32, seq {GSPMD_CHECK_SEQ}: {r0['plan']} -> "
          f"{r0['final_plan']}; records {r0['records']} on every rank; "
          f"recovery seconds {out['recovery_s']}; losses {r0['history']}; "
          f"final state CRC32 {state_crc:#010x} over its {len(blocks)} "
          f"distinct blocks, each equal on every rank holding it; the NaN "
          f"step left every rank's blocks bit-identical; launches "
          f"{out['counts']['rank0']} a rank (K2 guarded {r0['guarded_k2']});"
          f" anchors (rank 0's blocks) {r0['anchors']}; fit {out['fit_s']} "
          f"s; peaks "
          f"{out['peak_bytes']} B; {wall:.1f} s", flush=True)
    return out


def serve_world_rank(mesh, argv) -> dict:
    """22b on one rank: ``repro_torch.launch.serve.main(argv)`` (the rank
    has joined the world; the launcher serves every rank's share of the
    stream and gathers the report), with the launch counters zeroed
    before and read after; what this rank served and its allocator's
    peak beside what was allocated before."""
    import torch
    from repro_torch import kernels
    from repro_torch.engine import serving
    from repro_torch.launch import serve
    gc_collect()
    before = torch.cuda.memory_allocated(mesh.device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    plan, cfg, eng = out["plan"], out["config"], out["engine"]
    res = {"rank": mesh.rank, "plan": plan.describe(),
           "modeled_peak_bytes": plan.modeled_peak_bytes(),
           "budget_bytes": plan.budget_bytes, "report": out["report"],
           "ranks": out["ranks"],
           "allocated_before": before, "counts": counts, "wall_s": wall,
           "pool_free": (eng.pool.free_count == plan.local_slots
                         and not eng._by_slot),
           "tokens_in_vocab": all(0 <= t < cfg.vocab_size
                                  for r in out["requests"]
                                  for t in r.tokens),
           "all_finished": all(r.state == serving.FINISHED
                               for r in out["requests"])}
    del out, eng
    gc_collect()
    return res


def serve_world_phase(world) -> dict:
    """22b. The serve launcher on the four ranks of 21's world (its groups
    started anew by 22a), at phase 14a's traffic (SERVE_ARGV): the plan
    data-parallel (``local_slots`` a rank at the per-device budget),
    every request of the stream finished on exactly one rank, its tokens
    inside the vocabulary, every rank's pool free at the end and the
    gathered report equal on every rank; each rank's allocator peak (above
    what it held before) beside the plan's modeled per-device peak and
    the budget; no kernel launched (serving runs none, as in the
    reference)."""
    from repro_torch.launch import serve
    card = card_line()
    args = serve.build_parser().parse_args(SERVE_WORLD_ARGV)
    t0 = time.perf_counter()
    res = world.run(serve_world_rank, SERVE_WORLD_ARGV)
    wall = time.perf_counter() - t0
    r0 = res[0]
    ids = sorted(i for r in r0["ranks"] for i in r["finished"])
    check(ids == list(range(args.requests)),
          f"22b: finished request ids {ids}, expected each of "
          f"0..{args.requests - 1} once")
    rep = r0["report"]
    check(rep["requests"]["finished"] == args.requests,
          f"22b: {rep['requests']} of {args.requests}")
    peaks = {}
    for r in res:
        check(r["report"] == rep and r["ranks"] == r0["ranks"],
              f"22b rank {r['rank']}: the gathered report differs")
        check(r["all_finished"] and r["pool_free"] and r["tokens_in_vocab"],
              f"22b rank {r['rank']}: a request unfinished, a slot held or "
              "a token outside the vocabulary")
        check(not any(r["counts"].values()),
              f"22b rank {r['rank']}: kernel launches {r['counts']}")
        peak = next(x["peak_allocated_bytes"] for x in r0["ranks"]
                    if x["rank"] == r["rank"])
        peaks[r["rank"]] = peak - r["allocated_before"]
        check(peaks[r["rank"]] <= r["budget_bytes"],
              f"22b rank {r['rank']}: allocator peak {peaks[r['rank']]} B "
              f"above what it held, over the {r['budget_bytes']} B budget")
    dec = rep["decode"]
    out = {"card": card, "plan": r0["plan"], "report": rep,
           "ranks": r0["ranks"], "peak_above_before_bytes": peaks,
           "modeled_peak_bytes": r0["modeled_peak_bytes"],
           "budget_bytes": r0["budget_bytes"],
           "counts": {f"rank{r['rank']}": r["counts"] for r in res},
           "wall_s": wall}
    print(f"22b [{card}]: the serve launcher on {world.n} ranks sharing the "
          f"card (groups started anew by 22a): {r0['plan']}; "
          f"{rep['requests']['finished']} of {args.requests} requests "
          f"finished, each on one rank; decode {dec['tokens']} tokens, "
          f"{dec['tokens_per_s']:.1f} tokens/s summed over the ranks; ITL "
          f"p50 {dec['itl_s']['p50'] * 1e3:.2f} ms p99 "
          f"{dec['itl_s']['p99'] * 1e3:.2f} ms; TTFT p50 "
          f"{rep['ttft_s']['p50'] * 1e3:.1f} ms p99 "
          f"{rep['ttft_s']['p99'] * 1e3:.1f} ms; peak concurrency "
          f"{rep['slots']['max_concurrent']} of "
          f"{rep['slots']['planned']} planned; allocator peaks above what "
          f"each rank held {peaks} B beside the modeled "
          f"{r0['modeled_peak_bytes']} B and budget {r0['budget_bytes']} B "
          f"a device; K1-K6 launches 0; {wall:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 21d / 22c: prefill and decode on the GSPMD mesh
# ---------------------------------------------------------------------------

# 22c: full-width qwen2-1.5b at GSPMD_LAYERS layers, bf16, on 21's 2 x 2
# world: a prefill of SERVE_PROMPTS x SERVE_PROMPT_LEN tokens into a cache
# of SERVE_MAX_LEN slots (its rings split over ``model`` on the slots, 128
# a rank), then SERVE_DECODE_STEPS decode steps. Each step gathers the
# tied table's blocks over ``data`` (0.47 GB a rank in fp32) through the
# host, which sets the steps' seconds, so the steps are few
SERVE_PROMPTS = 4
SERVE_PROMPT_LEN = 128
SERVE_MAX_LEN = 256
SERVE_DECODE_STEPS = 8
# bf16: the mesh's split products and split softmax round in other orders
# than one device's, so logits and ring entries agree to this share of
# the largest magnitude (about four bf16 steps at the top of the range)
SERVE_BF16_RTOL = 3e-2


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 for two zero tensors)."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    return float((got - want).abs().max()) / top if top else float(
        (got - want).abs().max())


def gspmd_serve_dryrun_phase(dev) -> dict:
    """21d. ``prefill_32k`` and ``decode_32k`` of full-width qwen2-1.5b at
    STEPS_TRAIN_LAYERS layers dry-run as rank 0 of the 16 × 16 production
    mesh (a fake world of 256, fake CUDA tensors, nothing allocated on
    the card): the params placed by ``param_specs`` (their blocks the
    spec arithmetic), the cache and the tokens by ``cache_specs``; the
    rank's peak, FLOPs, collectives and cache blocks; no collective of a
    decode step as large as one block of one layer's keys (the ring is
    never gathered)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun

    card = card_line()
    gc_collect()
    cfg = dataclasses.replace(configs.get(STEPS_ARCH),
                              num_layers=STEPS_TRAIN_LAYERS)
    before = torch.cuda.memory_allocated(dev)
    out = {"card": card}
    for shape in ("prefill_32k", "decode_32k"):
        t0 = time.perf_counter()
        res = dryrun.run_dryrun(
            STEPS_ARCH, shape, mesh_spec="production", device=dev,
            cfg_overrides={"num_layers": STEPS_TRAIN_LAYERS}, probe=False,
            verbose=False)
        wall = time.perf_counter() - t0
        check(torch.cuda.memory_allocated(dev) == before,
              f"21d {shape}: the dry run allocated on the card")
        g = res["gspmd"]
        want = _gspmd_spec_bytes(cfg, g["mesh"])
        check(res["num_devices"] == 256 and g["kind"] == shape[:-4],
              f"21d {shape}: {res['num_devices']} ranks, kind {g['kind']}")
        check(g["local_param_bytes"] == want,
              f"21d {shape}: {g['local_param_bytes']} B of parameter "
              f"blocks, the spec arithmetic says {want}")
        check(g["flops"] > 0 and g["collectives"]["calls"] > 0,
              f"21d {shape}: no FLOPs or no collective counted")
        # one layer's key block: 128 / 16 rows, 32768 / 16 slots, bf16
        block = (128 // 16) * (32768 // 16) * cfg.num_kv_heads \
            * cfg.head_dim * 2
        largest = max(g["collectives"]["largest_by_kind"].values())
        if shape == "decode_32k":
            check(largest < block,
                  f"21d decode: a collective of {largest} B, a key block "
                  f"is {block} B: the ring was gathered")
        out[shape] = {"peak_bytes": g["peak_bytes"], "flops": g["flops"],
                      "local_param_bytes": g["local_param_bytes"],
                      "local_cache_bytes": g["local_cache_bytes"],
                      "logits_local_shape": g["logits_local_shape"],
                      "collectives": g["collectives"], "dryrun_s": wall}
        print(f"21d dry run of {STEPS_ARCH} {shape} at {STEPS_TRAIN_LAYERS} "
              f"layers as rank 0 of the {g['world']}-rank production mesh "
              f"{g['mesh']} [{card}]: parameter blocks "
              f"{g['local_param_bytes']} B, cache blocks "
              f"{g['local_cache_bytes']} B, logits block "
              f"{g['logits_local_shape']}; peak {g['peak_bytes']} B "
              f"({g['peak_bytes'] / GIB:.3f} GiB); {g['flops']:.6e} FLOPs; "
              f"collectives {g['collectives']} (a key block {block} B); "
              f"{wall:.1f} s", flush=True)
    return out


def gspmd_serve_rank(mesh, layers: int) -> dict:
    """22c on one rank: the prefill and decode steps of full-width
    qwen2-1.5b at ``layers`` layers, bf16, on the 2 × 2 GSPMD mesh
    (``launch.steps.GspmdServe``: params by ``param_specs``, the cache
    and tokens by ``cache_specs``), the launch counters zeroed before the
    prefill and read after the last step; the gathered logits of every
    step and the gathered ring; a decode step's collectives (the last,
    under the census), each step's seconds and the allocator's peak
    above what the rank held. Rank 0 then runs one device's ``prefill``
    / ``decode_step`` on the same weights and tokens and compares."""
    import numpy as np
    import torch
    from repro_torch import configs, engine, kernels
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer

    dev = mesh.device
    gm = mesh_lib.gspmd_mesh(mesh, *GSPMD_DIMS)
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=layers)
    bf16 = torch.bfloat16
    P, B, n = SERVE_PROMPT_LEN, SERVE_PROMPTS, SERVE_DECODE_STEPS
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P + n)).astype(np.int32)).to(dev)
    pre = steps_lib.GspmdServe("prefill", lambda p, t: transformer.prefill(
        p, cfg, t, SERVE_MAX_LEN, dtype=bf16), gm)
    dec = steps_lib.GspmdServe(
        "decode", lambda p, t, c, pos: transformer.decode_step(
            p, cfg, t, c, pos, dtype=bf16), gm)
    params = steps_lib.init_params(cfg, seed=0, device=dev)
    placed = pre.place_params(params)
    if mesh.rank != 0:
        del params
    gc_collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = pre.step(placed, pre.place(toks[:, :P]))
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    got = [pre.gather(logits).cpu()]
    step_s, census = [], None
    for j in range(n):
        tok = dec.place(toks[:, P + j:P + j + 1])
        pos = dec.place(torch.full((B,), P + j, dtype=torch.int32,
                                   device=dev))
        t0 = time.perf_counter()
        if j == n - 1:
            with engine.CollectiveCensus(gm) as cc:
                logits, cache = dec.step(placed, tok, cache, pos)
            census = cc.summary()
        else:
            logits, cache = dec.step(placed, tok, cache, pos)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        got.append(dec.gather(logits).cpu())
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    layout = {k: (str(v.placements), list(v.to_local().shape))
              for k, v in cache[0].items()}
    cache_bytes = sharding.local_bytes(cache)
    ring = {k: v.cpu() for k, v in dec.gather(cache)[0].items()}
    del cache, placed, logits, tok, pos
    gc_collect()
    res = {"rank": mesh.rank, "coords": gm.coords(), "prefill_s": prefill_s,
           "step_s": step_s, "census": census, "counts": counts,
           "peak_bytes": peak, "layout": layout, "cache_bytes": cache_bytes}
    if mesh.rank == 0:  # one device, on the same weights and tokens
        want_logits, want_cache = transformer.prefill(
            params, cfg, toks[:, :P], SERVE_MAX_LEN, dtype=bf16)
        want = [want_logits.cpu()]
        for j in range(n):
            lg, want_cache = transformer.decode_step(
                params, cfg, toks[:, P + j:P + j + 1], want_cache,
                torch.full((B,), P + j, dtype=torch.int32, device=dev),
                dtype=bf16)
            want.append(lg.cpu())
        res["logits_rel_err"] = [_rel_err(g, w) for g, w in zip(got, want)]
        res["ring_rel_err"] = {k: _rel_err(ring[k], want_cache[0][k].cpu())
                               for k in ("k", "v")}
        res["ring_pos_equal"] = bool(torch.equal(
            ring["pos"], want_cache[0]["pos"].cpu()))
        res["greedy_equal"] = [bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                               for g, w in zip(got, want)]
        del params, want_cache
        gc_collect()
    return res


def gspmd_serve_phase(world) -> dict:
    """22c. Prefill and decode on the GSPMD world (:func:`gspmd_serve_rank`
    on every rank): rank 0's comparison with one device within
    SERVE_BF16_RTOL, the ring's positions and every step's greedy tokens
    equal; the ring split over
    ``model`` on its slots; no kernel launched on any rank (serving runs
    none, as in the reference)."""
    card = card_line()
    gc_collect()
    t0 = time.perf_counter()
    res = world.run(gspmd_serve_rank, GSPMD_LAYERS)
    wall = time.perf_counter() - t0
    r0 = res[0]
    worst = max(r0["logits_rel_err"])
    check(worst <= SERVE_BF16_RTOL,
          f"22c: logits {r0['logits_rel_err']} of the largest apart from one "
          f"device's (at most {SERVE_BF16_RTOL})")
    check(all(r0["greedy_equal"]),
          f"22c: the greedy tokens differ from one device's at the steps "
          f"{[i for i, e in enumerate(r0['greedy_equal']) if not e]} "
          f"(0 the prefill)")
    check(max(r0["ring_rel_err"].values()) <= SERVE_BF16_RTOL
          and r0["ring_pos_equal"],
          f"22c: the gathered ring differs from one device's "
          f"{r0['ring_rel_err']}, positions equal {r0['ring_pos_equal']}")
    for r in res:
        check(not any(r["counts"].values()),
              f"22c rank {r['rank']}: kernel launches {r['counts']}")
        check(r["layout"]["k"][1][2] == SERVE_MAX_LEN // GSPMD_DIMS[1],
              f"22c rank {r['rank']}: ring block {r['layout']['k']}")
    steady = r0["step_s"][1:-1]
    step_s = sum(steady) / len(steady)
    out = {"card": card, "prefill_s": r0["prefill_s"],
           "step_s": r0["step_s"], "steady_step_s": step_s,
           "census": r0["census"], "logits_rel_err": r0["logits_rel_err"],
           "ring_rel_err": r0["ring_rel_err"],
           "greedy_equal": r0["greedy_equal"],
           "layout": r0["layout"], "cache_bytes": r0["cache_bytes"],
           "peak_bytes": [r["peak_bytes"] for r in res],
           "counts": {f"rank{r['rank']}": r["counts"] for r in res},
           "wall_s": wall}
    print(f"22c [{card}]: GSPMD {GSPMD_DIMS[0]}x{GSPMD_DIMS[1]} prefill of "
          f"{SERVE_PROMPTS} x {SERVE_PROMPT_LEN} tokens into "
          f"{SERVE_MAX_LEN} slots, then {SERVE_DECODE_STEPS} decode steps, "
          f"qwen2-1.5b at {GSPMD_LAYERS} of 28 layers, full width, bf16, "
          f"on {world.n} ranks sharing the card: prefill "
          f"{r0['prefill_s']:.3f} s (the first, DTensor's propagation "
          f"included), decode step seconds {r0['step_s']} (steady "
          f"{step_s:.3f} s, the last under the census); logits within "
          f"{worst:.3e} of the largest of one device's (greedy equal "
          f"{r0['greedy_equal']}), ring k/v {r0['ring_rel_err']}, "
          f"positions equal; ring block {r0['layout']['k']} a rank, cache "
          f"blocks {r0['cache_bytes']} B; collectives of a decode step "
          f"{r0['census']}; allocator peaks above what each rank held "
          f"{out['peak_bytes']} B; K1-K6 launches 0; {wall:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# 23. the five examples (repro_torch.examples) on the card
# ---------------------------------------------------------------------------

# train_100m --full plans mini-batch 32 at seq 512 against this budget:
# the memory model admits micro-batch 2 (its estimate at micro 2 is 2.159
# GiB, at micro 4 2.204 GiB), so the step streams 16 micro-batches, and
# the allocator's peak must stay under it (on an H100 80GB HBM3 it was
# 1.963 GiB at micro 2 and 2.631 GiB at micro 4)
EXAMPLE_BUDGET_GB = 2.18
# then a second call resumes to EXAMPLE_STEPS + 2; the loss, in the LR's
# warm-up, falls below the first step's for good from about step 10 on
EXAMPLE_STEPS = 10


class _Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self):
        self.out, self.parts = sys.stdout, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def examples_phase(dev) -> dict:
    """23. The port's twins of the reference's ``examples/`` in this
    process on the card: ``quickstart``, ``serve_decode``,
    ``train_classifier`` and ``train_segmentation`` at their defaults
    (each returns, its last loss finite); then ``train_100m --full
    --executor flat`` at full width (12 × 768, vocab 32,768, seq 512,
    mini-batch 32) planned against EXAMPLE_BUDGET_GB, so the mini-batch
    streams in N_Smu >= 2 micro-batches, for EXAMPLE_STEPS steps into
    ``build/train_100m_ckpt``, and a second call that restores from it and
    runs 2 steps more: the plan, the allocator's peak beside the plan's
    estimate and the budget (at or under it), the steady step and
    tokens/s, the last logged loss below the first; the launch counters
    zeroed before the first call and read after the second (K1 steps ×
    N_Smu × launch groups, K2 steps × buckets)."""
    import contextlib
    import shutil
    import torch
    from repro_torch import kernels
    from repro_torch.core import memory_model
    from repro_torch.engine import FlatSpec
    from repro_torch.examples import (quickstart, serve_decode, train_100m,
                                      train_classifier, train_segmentation)
    from repro_torch.launch import steps

    out = {}
    t0 = time.perf_counter()
    q = quickstart.main([])
    check(all(math.isfinite(x) for v in q.values() for x in v),
          f"examples: quickstart not finite: {q}")
    out["quickstart"] = {"printed": q, "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    gen = serve_decode.main([])
    check(tuple(gen.shape) == (4, 16), f"examples: serve_decode generated "
                                       f"{tuple(gen.shape)}")
    out["serve_decode"] = {"first": gen[0].tolist(),
                           "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cls = train_classifier.main([])
    check(all(math.isfinite(r["loss"]) for r in cls.values()),
          f"examples: train_classifier not finite: {cls}")
    out["train_classifier"] = {"results": cls, "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    seg = train_segmentation.main([])
    check(all(math.isfinite(x) for x in seg["losses"].values())
          and math.isfinite(seg["iou"]),
          f"examples: train_segmentation not finite: {seg}")
    out["train_segmentation"] = {**seg, "s": time.perf_counter() - t0}

    ckpt = os.path.join(ROOT, "build", "train_100m_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--full", "--executor", "flat", "--hbm-budget-gb",
            str(EXAMPLE_BUDGET_GB), "--ckpt-dir", ckpt]
    budget = int(EXAMPLE_BUDGET_GB * GIB)
    gc_collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_100m.main(argv + ["--steps", str(EXAMPLE_STEPS)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    tee = _Tee()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        second = train_100m.main(argv + ["--steps",
                                         str(EXAMPLE_STEPS + 2)])
    resume_wall = time.perf_counter() - t1
    counts = kernels.launch_counts()
    shutil.rmtree(ckpt, ignore_errors=True)
    plan, cfg = first["plan"], first["config"]
    hist = first["history"] + second["history"]
    losses = [h["loss"] for h in hist]
    # what the Trainer printed: every 10th step and each call's last
    logged = [h["loss"] for h in hist if h["step"] % 10 == 0
              or h["step"] in (EXAMPLE_STEPS - 1, EXAMPLE_STEPS + 1)]
    clocks = [h["readback_s"] for h in first["history"]]
    gaps = [b - a for a, b in zip(clocks, clocks[1:])][:-1]
    step_s = sum(gaps) / len(gaps)
    seq = 512
    estimate = memory_model.estimate(
        cfg, seq, remat_policy=plan.remat_policy).total(
            plan.micro_batch_size)
    abstract = steps.abstract_params(cfg)
    groups = _k1_groups(abstract)
    n_b = FlatSpec.for_tree(abstract).num_buckets
    want = (len(hist) * plan.num_micro_batches * groups, len(hist) * n_b)
    card = card_line()
    print(f"examples [{card}]: train_100m --full --executor flat: "
          f"{plan.describe()}; peak allocated {peak} B ({peak / GIB:.3f} "
          f"GiB; {base} B before) vs the plan's estimate {estimate} B "
          f"({estimate / GIB:.3f} GiB) and the budget {budget} B "
          f"({EXAMPLE_BUDGET_GB} GiB); losses {losses} (logged {logged}); "
          f"steady step {step_s:.4f}s, {32 * seq / step_s:.1f} tokens/s; "
          f"{EXAMPLE_STEPS} steps in {wall:.1f}s, resumed at step "
          f"{second['start']} to {EXAMPLE_STEPS + 2} in {resume_wall:.1f}s; "
          f"K1/K2 launches {counts['grad_accum']}/{counts['fused_sgd_mom']}"
          f" (expected {want[0]}/{want[1]}); quickstart "
          f"{out['quickstart']['s']:.1f}s, serve_decode "
          f"{out['serve_decode']['s']:.1f}s, train_classifier "
          f"{out['train_classifier']['s']:.1f}s, train_segmentation "
          f"{out['train_segmentation']['s']:.1f}s", flush=True)
    check(plan.num_micro_batches >= 2,
          f"examples: train_100m planned {plan.describe()} at "
          f"{EXAMPLE_BUDGET_GB} GiB: the mini-batch is not split")
    check(f"restored checkpoint at step {EXAMPLE_STEPS}" in tee.text()
          and second["start"] == EXAMPLE_STEPS,
          f"examples: the second train_100m did not restore step "
          f"{EXAMPLE_STEPS}")
    check([h["step"] for h in hist] == list(range(EXAMPLE_STEPS + 2)),
          f"examples: train_100m ran steps {[h['step'] for h in hist]}")
    check(all(math.isfinite(x) for x in losses),
          f"examples: train_100m losses not finite: {losses}")
    check(logged[-1] < logged[0], f"examples: train_100m's last logged loss "
                                  f"{logged[-1]} is not below the first "
                                  f"{logged[0]}")
    check(peak <= budget, f"examples: train_100m peaked at {peak} B, over "
                          f"its {budget} B budget")
    check((counts["grad_accum"], counts["fused_sgd_mom"]) == want,
          f"examples: train_100m launched {counts}, expected K1 {want[0]} "
          f"(steps x micro-batches x {groups} launch groups) and K2 "
          f"{want[1]}")
    out["train_100m"] = {
        "card": card, "plan": plan.describe(),
        "num_micro_batches": plan.num_micro_batches,
        "micro": plan.micro_batch_size, "budget_bytes": budget,
        "peak_bytes": peak, "allocated_before_bytes": base,
        "estimate_bytes": estimate, "losses": losses,
        "steady_step_s": step_s, "tokens_per_s": 32 * seq / step_s,
        "wall_s": wall, "resume_wall_s": resume_wall, "counts": counts}
    return out


def run() -> dict:
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(ROOT, "build", "inductor"))
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script "
                           "drives the port on a GPU and has no CPU mode")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    # the LocalWorld ranks of 16b, 16c and 19-22 fork from a server that
    # imports torch once; started now, its imports overlap phase 2's builds
    import multiprocessing.forkserver
    from repro_torch.launch import world as world_lib
    world_lib.context()
    multiprocessing.forkserver.ensure_running()
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)
    errs = {k: 0.0 for k in list(KERNELS) + list(API_KERNELS)}

    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = time.perf_counter() - t0
            print(f"phase {name}: {phase_s[name]:.1f}s", flush=True)

    # K6's library (the longer build) builds on while phase 3 checks K1-K4
    build_s = timed("2 build", build_phase, ("flash_attention",))
    k1_build = build_k1(build_s["grad_accum"])
    timed("3 kernels", kernel_phase, dev, errs)
    guard_cases = timed("3 GUARD kernels", guard_kernel_phase, dev)
    build_s["flash_attention"] = timed("2 build flash_attention (the rest)",
                                       build_s["flash_attention"].result)
    k6_build = build_k6(build_s["flash_attention"])
    timed("4 edges", edge_phase, dev, errs)
    timed("5 cross-check", cross_check_phase, dev)
    main = timed("6 main path", main_path_phase, dev)
    streaming = timed("7 streaming", streaming_phase, dev, main)
    calibration = timed("7a calibration", calibration_phase, dev)
    cnns = {w: timed(f"7b {w}", cnn_phase, dev, w, errs) for w in CNN_RUNS}
    resume = timed("8 resume", resume_phase, dev)
    n = main["bucket_size"]
    times = timed("9 full size", full_size_phase, dev, n, errs)
    guard_times = timed("9 GUARD full size", guard_full_size_phase, dev, n)
    k1 = timed("10 K1 leaves", k1_leaves_phase, dev, main["spec"], errs)
    # K1 on the main path adds the gradient leaves: its line is the
    # leaves' time, with the library call over the same pairs
    times["grad_accum"] = (k1["ms"], k1["plain_ms"], k1["foreach_add_ms"])
    api = timed("11 kernel API", api_phase, dev, errs)
    tuner = timed("12 tuner", tuner_phase, dev, main)
    guard = timed("13c guard", guard_phase, dev)
    # the main path's flat state: fp32 params and momentum, and the step
    state_bytes = 2 * 4 * sum(main["spec"].bucket_sizes) + 4
    ladder = timed("13a OOM ladder", oom_ladder_phase, dev, state_bytes)
    miss = timed("13b calibration miss", calibration_miss_phase, dev,
                 calibration)
    serve = {"qwen2-1.5b": timed("14a serve qwen2-1.5b", serve_phase, dev,
                                 "qwen2-1.5b"),
             "gemma2-9b": timed("14b serve gemma2-9b", serve_phase, dev,
                                "gemma2-9b")}
    serve_check = {a: timed(f"14c serve check {a}", serve_correctness_phase,
                            dev, a) for a in ("qwen2-1.5b", "gemma2-9b")}
    fam = family_phases(timed, dev)
    dp = {"train": timed("16a data parallel", dp_main_path_phase, dev)}
    fam17 = encdec_vlm_phases(timed, dev)
    st = steps_phases(timed, dev)
    checker = {"analysis": timed("20a/20b analysis", analysis_phase, dev),
               "dryrun": timed("20c dry run", dryrun_phase, dev,
                               st["train"])}
    worlds = world_phases(timed, dev, st["train"])
    dp["check"], fault = worlds["dp_check"], worlds["fault"]
    pp, gspmd = worlds["pipeline"], worlds["gspmd"]
    examples = timed("23 examples", examples_phase, dev)
    # launches of the comparisons above do not count: the counts are the
    # paths' — qwen2-1.5b's main path, ResNet-50's, U-Net's, the
    # families' training paths (15a-15c, 17a, 17b), the data-parallel
    # path's ranks, the kernel-API path's, the five serving paths' and the
    # train_100m example's — each read right after it ran (a rank's in its
    # own process)
    serve_paths = {f"serve {a}": r["counts"]
                   for a, r in [*serve.items(), *fam["serve"].items()]}
    paths = {"qwen2-1.5b": main["counts"],
             **{w: r["counts"] for w, r in cnns.items()},
             **{f"train {a}": r["counts"] for a, r in fam["train"].items()},
             **{f"train {a}": r["counts"]
                for a, r in fam17["train"].items()},
             **{f"dp qwen2-1.5b {k}": c
                for k, c in dp["train"]["counts"].items()},
             f"train_4k {STEPS_ARCH}": st["train"]["counts"],
             **{f"{label.split()[0]} qwen2-1.5b {k}": c
                for label, r in pp["train"].items()
                for k, c in r["counts"].items()},
             "analysis 20a": checker["analysis"]["counts"],
             **{f"gspmd qwen2-1.5b {k}": c
                for k, c in gspmd["train"]["counts"].items()},
             **{f"gspmd no-fsdp qwen2-1.5b {k}": c
                for k, c in gspmd["train"]["no_fsdp"]["counts"].items()},
             **{f"gspmd supervised qwen2-1.5b {k}": c
                for k, c in gspmd["supervised"]["counts"].items()},
             **{f"serve world qwen2-1.5b {k}": c
                for k, c in gspmd["serve"]["counts"].items()},
             **{f"gspmd serve qwen2-1.5b {k}": c
                for k, c in gspmd["prefill_decode"]["counts"].items()},
             "example train_100m": examples["train_100m"]["counts"],
             **serve_paths}
    records = []
    for name, (route, src, replaces, bytes_per, flops_per) in \
            KERNELS.items():
        ms, plain_ms, lib_ms = times[name]
        byte_ms = n * bytes_per / HBM_BYTES_PER_S * 1e3
        op_ms = n * flops_per / FP32_FLOPS_PER_S * 1e3
        records.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms, "n": n})
        if name in guard_times:
            g = guard_times[name]
            records[-1].update(
                guard_ms=g["flag1"], guard_skip_ms=g["flag0"],
                guard_unguarded_ms=g["unguarded"],
                guard_turns_ms=g["turns_ms"], guard_bitwise=True,
                guard_ragged_cases=guard_cases)
        if name == "grad_accum":
            flat_ms, flat_plain_ms, _ = times["grad_accum_flat"]
            records[-1].update(
                library="torch._foreach_add_ over the same pairs",
                leaves=k1["leaves"], add_flat_ms=k1["add_flat_ms"],
                flat_pair_ms=flat_ms, flat_pair_plain_ms=flat_plain_ms,
                step4_copy_then_add_ms=k1["copy_then_add_ms"],
                step4_accumulate_flat_ms=k1["accumulate_flat_ms"],
                turns_ms=k1["turns"],
                flatten_bytes=k1["flatten_bytes"],
                accumulate_flat_bytes=k1["accumulate_flat_bytes"],
                main_path_grad_copy_bytes=main["grad_copy_bytes"],
                build=k1_build)
    for name, (route, src, replaces) in API_KERNELS.items():
        # the top-level numbers are the first case's (qwen2-1.5b, the
        # main path's model); "cases" holds every full-width case
        cases = api["records"][name]
        records.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": api["counts"][name],
            "launches_by_path": {"kernel API": api["counts"][name],
                                 **{p: c[name]
                                    for p, c in serve_paths.items()}},
            "max_abs_err": errs[name],
            **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "cases": cases})
        if name == "flash_attention":
            records[-1].update(variant_launches=api["variants"],
                               build=k6_build)
    print(json.dumps({"runtime": {
        "main_path": {k: v for k, v in main.items()
                      if k not in ("spec", "counts")},
        "streaming": streaming, "resume": resume,
        "calibration": calibration, "cnn": cnns, "tuner": tuner,
        "guard": guard, "oom_ladder": ladder, "calibration_miss": miss,
        "serve": serve, "serve_check": serve_check, "families": fam,
        "encdec_vlm": fam17, "steps": st,
        "data_parallel": {"train": {k: v for k, v in dp["train"].items()
                                    if k != "counts"},
                          "check": dp["check"]},
        "fault_agreement": fault,
        "checker": {"analysis": {k: v for k, v in
                                 checker["analysis"].items()
                                 if k != "counts"},
                    "dryrun": checker["dryrun"]},
        "pipeline": {"train": {label: {k: v for k, v in r.items()
                                       if k != "counts"}
                               for label, r in pp["train"].items()},
                     "check": pp["check"]},
        "gspmd": {"train": {
                      **{k: v for k, v in gspmd["train"].items()
                         if k not in ("counts", "no_fsdp")},
                      "no_fsdp": {k: v for k, v in
                                  gspmd["train"]["no_fsdp"].items()
                                  if k != "counts"}},
                  "dryrun": gspmd["dryrun"],
                  "supervised": {k: v for k, v in
                                 gspmd["supervised"].items()
                                 if k != "counts"},
                  "serve": {k: v for k, v in gspmd["serve"].items()
                            if k != "counts"},
                  "serve_dryrun": gspmd["serve_dryrun"],
                  "prefill_decode": {k: v for k, v in
                                     gspmd["prefill_decode"].items()
                                     if k != "counts"}},
        "examples": {k: ({x: y for x, y in v.items() if x != "counts"}
                         if k == "train_100m" else v)
                     for k, v in examples.items()},
        "phase_s": phase_s,
        "total_s": sum(phase_s.values())}}),
        flush=True)
    print(f"phases: {sum(phase_s.values()):.1f}s in all, "
          f"{time.perf_counter() - T_START:.1f}s since the script started: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in phase_s.items()),
          flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(f"card: {card_line()}", flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except (SmokeFailure, ImportError, subprocess.SubprocessError,
            OSError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

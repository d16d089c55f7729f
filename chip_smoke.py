"""Drive the PyTorch port (mpi4dl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile out.txt  # also profile one step of each
                                             # slice, tables to out.txt

Phases; any failure ends the run with a non-zero exit and nothing is caught:

1. Build: compile the port's CUDA kernels from ``mpi4dl_tpu_torch/csrc``
   with nvcc (one process per source, all at once); print the build
   seconds and the card's name and power limit; check with ``cuobjdump
   -sass`` that every bf16 halo-conv kernel and every bf16 block-flash
   kernel (K3's forward, its backward's dK/dV and dQ passes) issues
   tensor-core MMAs (HMMA) and, where its copies are 8 or 16 bytes,
   cp.async (LDGSTS).
1b. Analysis (``phase_analysis``, after phase 3 and the dry runs): (a)
   the port's source-level gate, ``python -m mpi4dl_tpu_torch.analysis
   --json``, in a subprocess on this tree: exit 0 and zero findings; the
   files scanned, the rules and the seconds printed.  (b) Every row of the
   kernel registry (``ops/kernel_registry.py``) on the card: its kernel
   launched at least once and held against its plain version with phase
   2's and phase 4's tolerances (conv fp32 within 8 scaled ULP, bf16 one bf16
   rounding of the output and of the statistics; K3 m and o/l within
   1e-5·max(1, max|ref|), l rtol 1e-5, masked rows exact; K3's backward
   rtol 1e-4 / atol 1e-5·max|ref|).  (c) At the end of the run, every
   kernel that launched in it (``TALLY`` of ``ops/halo_conv.py`` and
   ``ops/flash_attention.py``) is enrolled by a registry row.  (d) The
   artifact gates: the recorded-collective contracts (``python -m
   mpi4dl_tpu_torch.analysis contracts``, the eight families raw and
   ``--quant int8``, every rank role on real CPU tensors on the ``fake``
   group, the cross-rank verifier's counts riding in each contract) run
   as CPU subprocesses from the end of phase 13 and are collected before
   phase 28: exit 0 against the committed goldens, no drift, every gated int8
   class at or under 0.55 of the raw bytes.
1c. Kernel certification (``phase_kernelcheck``, after (c)): every kernel
   symbol of both libraries printed with its registers, static and dynamic
   shared memory, stack and spill bytes, threads, minimum blocks and the
   blocks an SM holds at its launch's request (ptxas's report kept by the
   build, the libraries' launch tables); ``contracts --engines kernels``
   against ``goldens/kernels.json`` (no drift); and ``pallascheck`` over
   every registry row (the resources of the kernels each row launches, as
   the libraries' launch logs name them, and the NaN canary of its
   outputs), whose findings must be exactly
   ``KNOWN_KERNEL_FINDINGS`` (ROADMAP C5: a new finding, or one repaired,
   fails the phase).
2. Kernels: hold K1 (halo conv), K2 (fused relu→conv→BN-stats) and K1 as
   the dx of K2's backward against their plain PyTorch versions on the card,
   at the eight shapes of the main path (bf16) and at one fp32 ragged-tail
   shape; two K2 launches must be bitwise equal.  Time kernel, plain
   version and (K1) ``F.conv2d`` on the device: 20 calls in a CUDA graph,
   the median of 5 replays (an eager loop of such calls measures the
   host's launch rate instead; the wrappers' and ``F.conv2d``'s eager
   time per call, median of 5 windows of 20, is printed beside it).  Print
   the kernel/``F.conv2d`` ratio of device times.  TF32 is off.
   Tolerances: fp32 ≤ 8 scaled ULP (the JAX test's metric,
   tests/test_pallas_conv.py:401-453).  bf16: both sides accumulate in fp32
   and round once, so an output may differ by one bf16 ULP where the two
   fp32 sums straddle a rounding boundary: |Δy| ≤ 2^-7·max|y|, and for the
   fp32 statistics of the cast y |Δsum| ≤ 2^-7·Σ|y|, |Δsumsq| ≤ 2^-6·Σy².
3. Slice: full-width AmoebaNet-D(18 layers, 416 filters), 1024², batch 1,
   bf16 compute, fp32 params, SGD lr 1e-3, fused kernels on, remat off:
   1 warm-up and 3 timed steps with finite losses and exactly 80 K2 and 80
   K1 launches per step; img/s and peak memory.  Then AmoebaNet-D(3, 416)
   at 256² from one seed: one step through the kernels and one through the
   plain (unfused, library-conv) path; the losses agree within rtol 1e-2
   (bf16 keeps 8 bits, and the two paths round conv outputs after
   different fp32 summation orders, so one-ULP flips compound over cells).
4. K3 kernels: hold the block-flash kernel against its plain version at
   the kernel registry's two cases, at ``flash_attention_local``'s shapes
   of the long-context slice (B1 H8 D128, T 4096 and 16384, causal, bf16
   q/k/v) and at three ring hops of 4096 (diagonal, past, wholly future)
   in fp32 and in bf16.  bf16 q, k and v take the tensor-core kernel,
   fp32 the CUDA-core one; both are held to m (unmasked rows) and o_hat/l
   within 1e-5·max(1, max|ref|), l within rtol 1e-5, masked rows exactly
   (0, -1e30, 0) (TF32 off for the plain side).  At every bf16 shape K3's
   backward kernel is held against ``block_flash_bwd_plain`` (fp32
   gradients within rtol 1e-4 / atol 1e-5·max|ref|, the JAX gradient
   test's tolerance; zero gradients exactly where every key is masked),
   and two launches of the forward and of the backward are bitwise equal.
   Time kernel, plain version and, at the local shapes,
   ``F.scaled_dot_product_attention`` in fp32 and in bf16 (forward, and
   its backward alone) with CUDA events (median of 5 windows of 10 calls;
   3 of 3 at T 16384).
5. Ring: the one-process emulation of a 4-rank ring (per-hop offsets, K3,
   ``mlo_merge``) at B1 H8 D128 T 16384, causal and not, against plain
   single-device attention (rtol/atol 2e-5, tests/flash_ring_check.py);
   and the same in bf16 (both sides round the output to bf16 once after
   fp32 work in another order: |Δ| ≤ 2^-7·max|ref|, one bf16 ULP of the
   largest output); then the port's ``benchmark_ring_attention`` tool at
   T 16384, whose JSON line must read ``"validation": "pass"``.
6. Long-context slice: four ``SeqBlock(1024, 8 heads, mlp 4, causal)``,
   B1 T 16384, bf16 activations and targets, fp32 params, SGD lr 1e-3,
   through ``make_seq_cp_train_step(group=None)``: 1 warm-up and 3 timed
   steps with finite losses and exactly 4 K3 and 4 K3-backward launches
   per step; tokens/s and peak memory.  Then one block at T 2048, one step
   through K3 and one through the einsum path: in fp32 the losses agree
   within rtol 1e-4; in bf16 within rtol 1e-3, a quarter of one bf16 ULP
   (the two attention paths round their bf16 outputs after different fp32
   summation orders, so some elements differ by one ULP, 2^-8 relative,
   and the loss, a mean over 2M outputs of the block's bf16 layers,
   averages those flips).
7. SP kernels: the spatial-parallel paths' K1/K2 calls, found by a dry run
   of each step on the meta device (``halo_conv.count_dispatches``: the
   port's dispatch at full size, no memory): every distinct shape and
   statistics window held against the plain version (phase 2's bf16
   tolerances, the statistics over the call's window), two launches
   bitwise equal, device time of kernel, plain version and (K1)
   ``F.conv2d``, and the bound; per path, the per-step sums.
8. SP slice: AmoebaNet-D(18, 416), 2048², batch 1, 1000 classes, a 2x2
   square grid of 1024² tiles, halo-D2, fused kernels on, bf16 over fp32
   params, SGD lr 1e-3, remat off, through ``make_spatial_train_step`` on
   the one-process tile grid: 1 warm-up and 3 timed steps with finite
   losses and, each step, exactly the K1/K2 launches of its dry run; img/s,
   peak memory, and the first step's loss (the four-card NCCL runner's
   first step from the same seed is held to it).  Then ResNet-110 v2 at
   1024², same grid and settings: 1 warm-up and 2 timed steps, likewise.
9. SP checks at reduced depth, AmoebaNet-D(3, 416) at 512² on the 2x2
   grid: D2 through the kernels against D2 through the plain path, losses
   within rtol 1e-2 in bf16 (the reason of phase 3) and 1e-5 in fp32
   (tests/test_d2.py); D1 against the single-device step in fp32 over two
   steps, losses within rtol 1e-4 and parameters and running statistics
   within rtol 1e-3 / atol 1e-4 (tests/test_spatial.py).
10. Pipeline slice: AmoebaNet-D(6, 416) (``ENGINE_DEPTH``, as phases 14,
   15's GEMS steps and 19: the full depth runs in phases 3, 8 and 20-28),
   1024², batch 4 in 4
   micro-batches over 4 stages (``--split-size 4 --parts 4``), bf16 over
   fp32 params, SGD lr 1e-3, kernels on, remat off, on the one-process
   stage chain (``parallel/stages.StageChain``): GPipe, then 1F1B, 1
   warm-up and 3 timed steps each with finite losses and, each step,
   exactly the K1/K2 launches of its dry run (1F1B's recompute adds K2
   launches); img/s and peak memory, and 1F1B's peak below GPipe's.
11. Pipeline checks at reduced depth, AmoebaNet-D(3, 416) at 256², fp32,
   kernels on: GPipe against the single-card step accumulated over the 4
   micro-batches (losses rtol 1e-4, parameters rtol 2e-3 / atol 5e-5,
   tests/test_pipeline.py:55-65), 1F1B against GPipe (losses rtol 1e-5,
   parameters tests/test_1f1b.py:54's TOL), two steps.
12. Local-DP slice: ResNet-110 v2, 1024², batch 4, 2x2 grid, D2, kernels
   on, the ``batch_split`` junction at degree 4 (``--local-DP 4``, the
   all_to_all arm; on the one-process grid the tail normalises each shard
   with its own statistics): 1 warm-up and 2 timed steps with the dry
   run's launches; img/s and peak memory.
13. Card against CPU (tests/test_torch_cuda.py, ``utils/devcheck.py``):
   ResNet v1 and v2, fp32, with and without the kernels, gradients within
   1e-4 (norm-relative); the reduced-depth SP D1 and D2 steps on the 2x2
   grid and D2 with ``--local-DP`` 2 (gather and slice) and 4
   (all_to_all): in float64 with the kernels off, the whole step's
   gradient within 1e-8; in fp32 with the kernels on, each layer call's
   and K2 window's output and VJP within 1e-4.
14. Kernels on against off: step ms of the single-card AmoebaNet-D(6,
   416) 1024² bs1 step and of the GPipe step of phase 10, on, off, on.
15. GEMS, SP x PP and SP + GEMS slices: AmoebaNet-D(6, 416) for GEMS,
   (18, 416) for the others, 1024², batch 4, bf16 over fp32 params, SGD lr
   1e-3, kernels on, remat off.
   GEMS on the one-process stage chain, 4 stages, times 1 x 2 streams x
   parts 2 x 1 image, GPipe then 1F1B; SP x PP (parts 2 of 2 images) and
   SP + GEMS (times 1 x 2 x parts 1 x 2 images) on the 2x2 grid with
   halo-D2, the gather junction after cell 12, the tail over 2 stages of
   the chain.  1 warm-up and 3 timed steps each, finite losses and each
   step's K1/K2 launches equal to its dry run's; img/s, ms a step, peak.
16. Engine checks at reduced depth (``utils/devcheck.engine_run``): GEMS
   over 4 and 3 stages and SP x PP / SP + GEMS on the 1x2 grid, GPipe and
   1F1B, against the single-card step accumulated over the same
   micro-batches, two steps: ResNet-11 v2 32² in fp32 with the kernels on
   (losses rtol 1e-4, parameters rtol 2e-3 / atol 1e-5, the JAX tests');
   AmoebaNet-D(3, 32) 128² in float64 with the kernels off (losses rtol
   1e-10, updates within 1e-8 norm-relative).  The striped ResNet branch
   (C3; ``utils/devcheck.hstripe_run`` with its gates lowered), card
   against CPU, per-stripe and exact statistics: loss rtol 1e-5,
   gradients and running statistics within 1e-4.
17. Multi-level SP slices: AmoebaNet-D(18, 416), bf16 over fp32 params,
   SGD lr 1e-3, halo-D2, kernels on, remat off, the levels of the runners'
   rule at ``--num-spatial-parts 4,2 --split-size 3 --spatial-size 2``
   (cells [0, 8) on the 2x2 grid, [8, 16) on its (1, 2) level, the gather
   junction at cell 16): the SP step at 2048² bs1 and SP x PP at 1024² bs6
   (2 micro-batches, the tail over 3 stages of the chain, GPipe), 1 warm-up
   and 3 timed steps each with finite losses and each step's K1/K2
   launches equal to its dry run's; img/s, ms a step, peak.
18. Multi-level checks at reduced depth (``utils/devcheck.engine_run``):
   the step with square 4,2 and degenerate vertical 2,1 levels and SP x PP
   with square 4,2, against the single-card step at
   ``tests/test_multilevel.py``'s bounds (losses rtol 1e-4, parameters
   rtol 2e-3 / atol 1e-5): ResNet-11 v2 in fp32 with the kernels on (the
   single card taking the library conv from the first degenerate level's
   cells on) and AmoebaNet-D(3, 32) in float64 with them off; in float64
   the card against the CPU (losses rtol 1e-10, updates within 1e-8).  The
   single card's own kernels-on against kernels-off gap, and the square
   chain against a single card with the kernels on the same cells, are
   printed beside them.
19. Memory levers, each A/B inside this call: the remat levels (none,
   cell, sqrt, fine) of AmoebaNet-D(6, 416) 2048² on one card; the SP
   2048² grid at that depth with ``MPI4DL_STRIPE_BWD`` 0 / 1 / 0 / 1; and the JAX
   package's two TPU conv routes, which no layer of the port dispatches,
   against the library conv: ``hstripe_conv2d`` forward and backward at
   the convs of ResNet-110 v2 2048² that JAX's gate would stripe, the
   phase dx's backward at AmoebaNet-D(6, 416)'s 1024² strided convs (device ms and
   the memory each allocates).  Recorded, not asserted.
20. Data and checkpoints, through the ``lp`` runner (``benchmarks/common.run``)
   at phase 3's model and settings (AmoebaNet-D(18, 416), 1024², bs1,
   bf16 over fp32 params, kernels on, remat off, 1000 classes): ``--app 1``
   on a folder of 2 x 4 random 1024² PPM images written here from a seed,
   ``--num-workers 2``, ``--checkpoint-dir`` in a temporary directory,
   ``--steps-per-epoch 4``.  The native loader must have built and decoded
   every image the run fed; 80 K2 and 80 K1 launches a step (the counts,
   the decodes' too, at 0 just before this run); finite losses; ``ckpt_0`` and ``ckpt_4`` pass
   ``cheap_validate``.  A second call with ``--num-epochs 2`` prints
   ``resuming from checkpoint step 4``, its restored state is bitwise the
   saved one, and its losses for steps 4-7 equal an uninterrupted 2-epoch
   call's within rtol 1e-5 (printed: bitwise or the largest difference).
   Then ``--app 1`` with 0 workers and ``--app 3``, 8 steps each, beside
   the uninterrupted 2-worker call: each one's step img/s (timed from the
   batch in hand, as the JAX runner's), its wait for each batch, and its
   fed img/s over both; each save's ms and bytes and the restore's ms.
21. The halo tools at the JAX tools' documented shapes:
   ``benchmark_pallas_conv`` (512², 256 -> 256, 3x3, bf16),
   ``benchmark_d2_step`` (tile 512, 208 channels, 3 fused ops; 3 K2 and 3
   K1 launches a step) and ``benchmark_sp_halo_exchange --with-compute``
   on the one-process grid (1024², 4 vertical parts, halo 3): each JSON
   line reads ``"validation": "pass"`` (the D2 step's: the kernels-on
   arm's output, input gradient and weight gradients within 2^-7 of the
   kernels-off arm's in relative L2 norm), the exchange tool prints PASSED
   twice.
22. Resilience: the ``lp`` runner under the supervised loop at phase 20's
   model and flags (``--app 1``, 2 workers, ``--pallas-conv``), each run
   with its launches counted from 0 and held to 80 K2 + 80 K1 a step it
   executed.  (a) 12 steps with ``--checkpoint-dir``: the baseline save
   before step 0 is written in the background at the default 1 GiB
   budget while the steps run (each save's wait on the training thread,
   time to disk and peak pending bytes; the ms of the steps that overlap
   a write against the others); then the final checkpoint, restored, is
   saved synchronously (its wait), and the two manifests are equal, the
   CRC32 of every shard included.  (b) ``MPI4DL_FAULT=sigterm@2`` with a 2
   GiB budget: the run stops after step 2 with ``ckpt_3`` saved and
   returns; the resume's losses for steps 3-7 equal phase 20's
   uninterrupted run's within rtol 1e-5 (printed: bitwise or the largest
   difference).  (c) ``nan_batch@5``: exactly one ``anomaly`` and one
   ``recovery`` record (back to ``ckpt_4``, batch 5 skipped), finite
   losses.  (d) ``--watchdog-secs 5`` with ``stall_data@2:8`` and no
   worker: exactly one stack dump, with the card's memory line.
23. Quantized collectives (``--quant``, ``quant/``): (a) encode and decode
   on the card at the SP AmoebaNet 2048² junction activation's folded
   shape (bf16; the largest leaf entering the junction on the 2x2 grid)
   and at a flat fp32 gradient of AmoebaNet-D(18, 416)'s size, in int8,
   fp8 and int4: payload, scales and decode bitwise the CPU's, and the
   round trip's device ms (a CUDA graph, as phase 2) beside a ``copy_``.
   (b) phase 8's SP AmoebaNet-D(18, 416) 2048² bs1 step (2x2 grid, D2, the
   kernels on, bf16) 4 steps with ``--quant int8`` and 4 off from one
   seed; (c) phase 15's SP x PP AmoebaNet 1024² bs4 step (grid + 2 tail
   stages) with ``junction=int8,handoff=int8,grad=int8`` against off.
   Each step's K1/K2 launches equal the dry run's (80 + 80 on the SP
   AmoebaNet step), losses finite, the quantized run's last below its
   first and each within 5% of the exact one (``tests/test_quant.py:
   494-514``); the first step's gradients against the exact run's, over
   all parameters and over the first cell's, by relative L2 and norm
   ratio (``QUANT_GRAD``), and each quantized class at most 0.55 of its
   raw bytes; step ms, peak memory and the wire/raw bytes per class (what
   the grid's ranks would send) are printed for both, and beside them the
   exact run on an input moved by 2^-8 (its loss gap and first-gradient
   gap: how far the exact step itself moves).
24. Run telemetry (``obs/``): the ``lp`` runner at phase 20's model and
   flags (synthetic data) with ``--telemetry-dir``, 6 steps, twice.  Each
   run's ``cost`` record (its warm-up step counted under
   ``obs.costs.counting``) holds exactly the FLOPs of the same step on the
   meta device through the plain versions (``count_dispatches``, counted in
   a worker beside phases 1-3); its K1 and K2 tallies are phase 2's FLOPs
   of the same 80 + 80 calls; ``peak_source`` "table" at 989e12 FLOP/s;
   0 < MFU <= 1; the ``.prom`` snapshot exists.  Printed: FLOPs, bytes,
   arithmetic intensity and MFU a step with the card line, and the counted
   warm-up's ms beside phase 22's uncounted one.  Then the port's CLI in
   this process: ``report`` renders the cost model and MFU lines of both
   RunLogs, ``report --compare`` names every compared metric, ``report
   --trend`` finds one series of two runs, ``metrics`` over the directory
   gives each run's step count and step-ms sum, and ``trace --runlog``
   writes 6 step spans (and 7 spans with ``anomaly`` and ``recovery``
   instants for phase 22's ``nan_batch@5`` RunLog).  K3 (off this path):
   one forward and one backward launch at (8, 4096, 128) bf16 causal
   under ``counting``, each tallied once and equal to its plain version's
   count of the same call.
25. The memory probe and the elastic supervisor (``benchmarks/mem_probe.py``,
   ``resilience/{planner,supervisor}.py``), at phase 20's model and flags,
   ``--steps-per-epoch 2 --num-epochs 2``.  (a) The probe's estimate of the
   ``lp`` runner's step (fake tensors on the CPU, no CUDA context; run as a
   subprocess from the end of phase 3) within 15% of the same step's
   ``torch.cuda.max_memory_allocated`` on the card (the unsupervised runner
   in a process of its own).
   (b) ``python -m mpi4dl_tpu_torch.resilience supervise`` as a
   subprocess, its legs processes of their own, beside that run: a clean
   job is one leg with no incident, its losses bitwise the unsupervised
   run's and 80 + 80 K1/K2 launches a step; with ``MPI4DL_FAULT=io_error@2``
   one ``transient_io`` incident answered by a backoff ``retry`` with no
   config delta, the relaunch restoring step 2 and ending on the
   unsupervised run's final loss, bit for bit.  (c) At 4096², where the
   probe puts the step above the card's memory: the leg dies in its first
   step with the card's own ``CUDA out of memory``, the supervisor
   classifies it ``oom_compile`` from the crash marker, the policy is
   ``degrade``, the ladder has no rung for ``lp`` at one stage and one
   part, so it fails with exit 1 and the typed reason, after one leg.
26. The step instruments (``obs/{scopes,comm_stats,hbm,timeline,overlap,
   kineto,trace}.py``, ``benchmarks/profile_step.py``).  (a)
   ``profile_step.py`` on phase 3's step, ``INSTRUMENT_STEPS`` profiled
   steps: exactly 80 K2 and 80 K1 kernels a step in the trace (told apart
   by where they launched: forward or an autograd node), each attributed to
   a ``cellNN`` scope; named scopes hold at least ``COVERAGE`` of the device
   time; the per-scope device times add up to the trace's own total within
   1%; K1's and K2's profiled ms a step are printed beside phase 2's
   CUDA-graph ms.  (b) ``mem_probe --attribute`` of phase 25's ``lp`` step
   on fake tensors (a subprocess from the end of phase 3) and the same
   attribution of one step on the card with real tensors
   (``mem_probe.card_attribution``): coverage at least ``COVERAGE`` on both,
   the card tracker's peak within ``PROBE_TOLERANCE`` of
   ``torch.cuda.max_memory_allocated``, the same top scope group on both.
   (c) That step's analytical timeline at the card's rates, serialized ≥
   perfect overlap; the one-process step moves no collective, so its
   ledger reads 0 bytes and ``hidden_frac`` None (not a failure).  (d)
   ``python -m mpi4dl_tpu_torch.obs overlap --profile`` and ``trace
   --profile`` on the saved trace, and ``report`` rendering the ``hbm``,
   ``timeline`` (measured and analytical), ``overlap`` and ``xprof_ops``
   records.
27. The multi-tenant fleet (``resilience/{allocator,fleet}.py``) on a pool
   of one card, at phase 20's model and flags (the ``lp`` runner,
   AmoebaNet-D(18, 416) 1024² bs1, bf16, the kernels on, remat off,
   2-step epochs): one ``run_fleet_scenario`` (``FLEET_SCENARIO``) through
   the real leg launcher.  ``lo`` (priority 0, 4 epochs) checkpoints at
   step 2; then ``hi`` (priority 10, 2 epochs) and ``poison`` (priority 5,
   the same flags at 4096²) arrive.  ``hi`` preempts ``lo``, which drains
   at a step boundary and requeues; ``hi`` runs to ``done``; ``poison``
   dies twice of the card's own ``CUDA out of memory`` (``oom_compile`` ->
   ``degrade`` -> no rung -> a failed run) and is ``quarantined``; then
   ``lo`` resumes from its own checkpoint and is ``done``.  The verdict
   must be ``verified_recovery``; ``lo``'s losses, before the drain and
   after the resume, equal its solo control's bitwise (the control leg
   runs beside ``lo``'s resumed leg, ``EarlyControl``); every leg of
   ``lo`` and ``hi`` launches 80 + 80 K1/K2 a step.  Printed: the fleet
   timeline (``obs report``), the seconds from the drain request to
   ``lo``'s exit and to ``poison``'s quarantine.
28. The measuring tools.  (a) The 8192² readiness probe
   (``benchmarks/readiness_8k.py``, fake tensors on the CPU, no CUDA
   context; started at the end of phase 3) at the JAX tool's defaults,
   AmoebaNet-D(18, 416) SP 4x4 x PP 2, gpipe, ``--spatial-until 9``, with
   ``--parts 2``: at the JAX default of one part neither package builds
   the step (the SP x PP step hands each stage an equal chunk of the
   batch).  Checked: both stage roles built, and the step's collectives
   hold halo exchanges and the stage handoff.  Printed: the collectives a
   step, each role's GiB, ``fits_h100_80gb``, the seconds, and the card's
   own memory beside the tool's 80 GB constant (within 1%).  (b) The bench's
   headline rung as a subprocess (``python -m mpi4dl_tpu_torch.bench
   --inner``): AmoebaNet-D(18, 416) 1024² bs1, no remat, bf16,
   ``MPI4DL_PALLAS_CONV=1``, ``BENCH_ITERS`` timed steps.  Checked: its line
   reads ``platform`` "gpu" and ``0 < mfu <= 1``; its ``flops_per_step``
   equals the meta-device count of the same step (phase 24's); its stderr
   reads 80 K1 and 80 K2 launches a step; its ms a step lies within
   ``BENCH_TOLERANCE`` of phase 3's median step.
29. Phase 1b (c) and phase 1c, then the kernels' JSON line, the card line, and last
   the result line.  K1's
   and K2's ``launches``, ``ms``, ``plain_ms``, ``library_ms`` and
   ``bound_ms`` are those of the SP AmoebaNet path (phase 8's run, per
   step for the times); ``by_path`` gives per-step launches and times of
   each path (single-card AmoebaNet, SP AmoebaNet, SP ResNet, the GPipe
   and 1F1B steps, the local-DP ResNet step, the GEMS, SP x PP and SP +
   GEMS steps, the multi-level SP and SP x PP steps).

Phases 7-19 run between phases 3 and 4, phases 20-28 after phase 6, each
printing its seconds.  The
dry runs (meta device, CPU only; phase 24's count too) run in worker
processes from the start, beside phases 1-3; the probes of phases 25 and
26 and phase 28's readiness probe from the end of phase 3 (phase 28 (b)
holds the bench's host-bound step to phase 3's); phase 1b (d)'s contract
gates from the end of phase 13 to phase 28.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores (same)
HBM_BYTES_PER_S = 3.35e12

# The main path's K2 / K1-dx calls per training step: (H = W, m = Cin =
# Cout, kernel, calls) at AmoebaNet-D(18, 416), 1024², batch 1.
MAIN_PATH = [
    (256, 52, (1, 7), 1), (256, 52, (7, 1), 1),
    (128, 104, (1, 7), 13), (128, 104, (7, 1), 13),
    (64, 208, (1, 7), 13), (64, 208, (7, 1), 13),
    (32, 416, (1, 7), 13), (32, 416, (7, 1), 13),
]
K1_SRC = "mpi4dl_tpu/ops/pallas_conv.py:41"
K2_SRC = "mpi4dl_tpu/ops/pallas_conv.py:106"
K3_SRC = "mpi4dl_tpu/ops/pallas_attention.py:76"
K3_BWD_SRC = "mpi4dl_tpu/ops/pallas_attention.py:243"
SOURCE = "mpi4dl_tpu_torch/csrc/halo_conv.cu"
K3_SOURCE = "mpi4dl_tpu_torch/csrc/block_flash.cu"

# The long-context slice: SeqBlock(1024, 8 heads) x 4, B1, T 16384 — the JAX
# ring tool's width (benchmarks/communication/ring/benchmark_ring_attention.py
# :38-40).  Each block's forward makes one K3 call at (BH 8, T, T, D 128).
SEQ_T, SEQ_D, SEQ_HEADS, SEQ_BLOCKS = 16384, 1024, 8, 4
# K3 checks: (label, BH, Tq, Tk, D, q/k/v dtype, causal, q_off, k_off,
# library yardstick?).  The first two are the kernel registry's cases
# (mpi4dl_tpu/ops/kernel_registry.py:76-106, scale 0.125).
K3_SHAPES = [
    ("registry fp32", 2, 48, 300, 64, "float32", False, 0, 0, False),
    ("registry bf16 causal", 2, 48, 300, 64, "bfloat16", True, 0, 0, False),
    ("local T=4096", 8, 4096, 4096, 128, "bfloat16", True, 0, 0, True),
    ("local T=16384", 8, SEQ_T, SEQ_T, 128, "bfloat16", True, 0, 0, True),
    ("hop diagonal", 8, 4096, 4096, 128, "float32", True, 4096, 4096, False),
    ("hop past", 8, 4096, 4096, 128, "float32", True, 8192, 0, False),
    ("hop future", 8, 4096, 4096, 128, "float32", True, 0, 4096, False),
    ("hop diagonal bf16", 8, 4096, 4096, 128, "bfloat16", True, 4096, 4096, False),
    ("hop past bf16", 8, 4096, 4096, 128, "bfloat16", True, 8192, 0, False),
    ("hop future bf16", 8, 4096, 4096, 128, "bfloat16", True, 0, 4096, False),
]
K3_MAIN = "local T=16384"   # the slice's K3 call, SEQ_BLOCKS times a step


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` windows of the mean time of ``iters`` calls,
    after two warm-up calls (CUDA events)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    (after three warm-up calls), the median over ``windows`` replays.  The
    graph leaves out the host's time to launch each call, which bounds an
    eager loop of calls that take tens of microseconds on the card."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def sass_counts(lib) -> dict:
    """Tensor-core (HMMA, HGMMA) and cp.async (LDGSTS) instructions in each
    kernel of a built library, from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(lib)], check=True, capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "LDGSTS": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "LDGSTS"):
                if op + "." in line or op + " " in line:
                    counts[fn][op] += 1
                    break
    return counts


def check_flash_sass(lib) -> None:
    """Every bf16 kernel of block_flash.cu (forward, dK/dV and dQ passes)
    issues HMMA, and every one whose copies are 8 or 16 bytes wide issues
    cp.async (LDGSTS)."""
    counts = sass_counts(lib)
    tc = {}
    for name, c in counts.items():
        # template <KD, VEC>
        m = re.search(r"2tc\d+block_flash_(fwd|bwd_kv|bwd_q)_kernelILi\d+ELi(\d+)E", name)
        if m:
            tc[name] = c
            assert c["HMMA"] + c["HGMMA"] > 0, (name, c)
            assert c["LDGSTS"] > 0 or m.group(2) == "1", (name, c)
    assert len(tc) == 18, f"{len(tc)} bf16 block-flash kernels in {lib}"
    hmma = [c["HMMA"] for c in tc.values()]
    print(f"build: block_flash.cu SASS: {len(tc)} bf16 kernels, HMMA {sum(hmma)} "
          f"({min(hmma)}-{max(hmma)} a kernel), LDGSTS "
          f"{sum(c['LDGSTS'] for c in tc.values())}; fp32 kernels HMMA "
          f"{sum(c['HMMA'] for k, c in counts.items() if k not in tc)}", flush=True)


def check_sass(lib) -> None:
    """Every bf16 kernel of halo_conv.cu issues HMMA, and every one whose
    copies are 8 or 16 bytes wide issues cp.async (LDGSTS)."""
    counts = sass_counts(lib)
    tc = {}
    for name, c in counts.items():
        # template <WARPS_M, WARPS_N, MI, NI, KS, VEC, Tout>
        m = re.search(r"2tc16halo_conv_kernelI(?:Li\d+E){5}Li(\d+)E", name)
        if m:
            tc[name] = c
            assert c["HMMA"] + c["HGMMA"] > 0, (name, c)
            assert c["LDGSTS"] > 0 or m.group(1) == "1", (name, c)
    assert tc, f"no tensor-core kernel in {lib}"
    hmma = [c["HMMA"] for c in tc.values()]
    print(f"build: halo_conv.cu SASS: {len(tc)} bf16 kernels, HMMA {sum(hmma)} "
          f"({min(hmma)}-{max(hmma)} a kernel), HGMMA "
          f"{sum(c['HGMMA'] for c in tc.values())}, LDGSTS "
          f"{sum(c['LDGSTS'] for c in tc.values())}; fp32 kernels HMMA "
          f"{sum(c['HMMA'] for k, c in counts.items() if k not in tc)}", flush=True)


def scaled_ulp(got, ref) -> float:
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    assert scale > 0
    return float((got - ref).abs().max()) / (2.0 ** -23 * scale)


def check_bf16(name, got, ref) -> float:
    err = float((got.float() - ref.float()).abs().max())
    bound = 2.0 ** -7 * float(ref.float().abs().max())
    assert err <= bound, f"{name}: |err| {err} > {bound}"
    return err


def check_stats_bf16(name, s, ss, s_ref, ss_ref, y_ref) -> None:
    yw = y_ref.float()
    es = float((s - s_ref).abs().max())
    ess = float((ss - ss_ref).abs().max())
    bs = 2.0 ** -7 * float(yw.abs().sum(dim=(0, 1, 2)).max())
    bss = 2.0 ** -6 * float((yw * yw).sum(dim=(0, 1, 2)).max())
    assert es <= bs, f"{name} sum: {es} > {bs}"
    assert ess <= bss, f"{name} sumsq: {ess} > {bss}"


def reset_all_counts() -> None:
    from mpi4dl_tpu_torch.ops import flash_attention as fa
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    hc.reset_launch_counts()
    fa.reset_launch_counts()


def call_cost(x, w, y_shape, stats: bool):
    """(bytes, flops) of one call: each input read once, each output written
    once; 2 flops per multiply-add."""
    n, h, wd, cout = y_shape
    kh, kw, cin, _ = w.shape
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + n * h * wd * cout * x.element_size() + (8 * cout if stats else 0))
    return nbytes, 2 * n * h * wd * cin * cout * kh * kw


def phase_analysis():
    """(a) The source-level gate in a subprocess; (b) every kernel registry
    row on the card against its plain version.  Returns the seconds."""
    import torch

    from mpi4dl_tpu_torch.ops import flash_attention as fa
    from mpi4dl_tpu_torch.ops import halo_conv as hc
    from mpi4dl_tpu_torch.ops import kernel_registry as kr

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi4dl_tpu_torch.analysis", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    gate_s = time.perf_counter() - t0
    assert proc.returncode == 0, f"analysis gate exit {proc.returncode}:\n{proc.stdout}{proc.stderr}"
    report = json.loads(proc.stdout)
    assert report["violations"] == [] and report["stale_baseline"] == [], report
    print(f"analysis: gate {report['files']} files, {len(report['rules'])} rules "
          f"({', '.join(report['rules'])}), 0 findings, {gate_s:.2f} s", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t1 = time.perf_counter()
    counts = {**hc.LAUNCHES, **fa.LAUNCHES}
    for case in kr.REGISTRY:
        before = counts[case.kernel]
        err = case.run("cuda")
        torch.cuda.synchronize()
        counts = {**hc.LAUNCHES, **fa.LAUNCHES}
        assert counts[case.kernel] > before, f"registry {case.name}: no {case.kernel} launch"
        print(f"analysis: registry {case.name}: {case.kernel} x{counts[case.kernel] - before} "
              f"max|err| {err:.3g}", flush=True)
    rows_s = time.perf_counter() - t1
    secs = time.perf_counter() - t0
    print(f"analysis: {len(kr.REGISTRY)} registry rows {rows_s:.2f} s; phase {secs:.2f} s",
          flush=True)
    return secs


# The artifact gates' phase.  ROADMAP C5: the fp32 rows of K1 and K2 launch
# the CUDA-core conv kernel, whose 8-byte stack frame (8 B of spill stores,
# 24 B of loads at 80 registers) the certifier's register-spill finds.
KNOWN_KERNEL_FINDINGS = {
    "{anon}::simt::halo_conv_kernel<float>:halo_conv2d:float32:register-spill",
    "{anon}::simt::halo_conv_kernel<float>:halo_conv2d:fused_stats:float32:register-spill",
}
CONTRACT_JOBS = 1  # family processes of each contract gate at once (two gates at once)


def contracts_start():
    """(d) The contract gates, raw and int8, as CPU subprocesses:
    ``[(label, process, JSON path)]`` and the start time."""
    import tempfile

    started = []
    for label, extra in (("raw", []), ("int8", ["--quant", "int8"])):
        fd, path = tempfile.mkstemp(prefix=f"chip_smoke_contracts_{label}_", suffix=".json")
        os.close(fd)
        cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.analysis", "contracts", *extra,
               "--jobs", str(CONTRACT_JOBS), "--out", path]
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        started.append((label, proc, path))
    return started, time.time()


def contracts_result(started) -> None:
    """(d) Both contract gates exit 0 with no drift and no ratio breach;
    each gate's seconds from its start to its report (the file's time)."""
    gates, t0 = started
    for label, proc, path in gates:
        out, _ = proc.communicate()
        secs = os.path.getmtime(path) - t0
        with open(path) as f:
            report = json.load(f)
        os.unlink(path)
        assert proc.returncode == 0, f"contracts {label} exit {proc.returncode}:\n{out[-4000:]}"
        drift = report["drift"]
        assert drift and all(d == [] for d in drift.values()), drift
        ratios = report.get("quant_ratio", {})
        assert all(not r["breaches"] for r in ratios.values()), ratios
        worst = {}
        for r in ratios.values():
            for row in r["rows"]:
                if row["gated"] and row["ratio"] is not None:
                    worst[row["class"]] = max(worst.get(row["class"], 0), row["ratio"])
        print(f"analysis: contracts {label}: {len(drift)} families clean (ircheck counts "
              f"in each), its report {secs:.1f} s after the gates started"
              + (f"; worst gated int8/raw byte ratio {worst}" if worst else ""), flush=True)


def phase_kernelcheck():
    """Phase 1c (module docstring): the kernels' resources, their golden and
    the certifier over the registry rows, each gate a fresh process as a
    user runs it."""
    import tempfile

    from mpi4dl_tpu_torch.analysis.contracts.__main__ import default_contracts_dir
    from mpi4dl_tpu_torch.analysis.contracts.diff import diff_kernels_contract

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernels_") as tmp:
        gates = {}
        # The kernels contract is extracted into tmp and diffed here against
        # the golden, as `contracts --engines kernels` diffs it.
        for name, argv in (
                ("pallascheck", ["pallascheck", "--json"]),
                ("contracts kernels", ["contracts", "--engines", "kernels", "--update",
                                       "--dir", tmp])):
            gates[name] = subprocess.Popen(
                [sys.executable, "-m", "mpi4dl_tpu_torch.analysis", *argv], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        outs = {name: p.communicate(timeout=600) for name, p in gates.items()}
        assert gates["contracts kernels"].returncode == 0, outs["contracts kernels"]
        with open(os.path.join(tmp, "kernels.json")) as f:
            current = json.load(f)
    for name, sym in sorted(current["symbols"].items()):
        print(f"kernelcheck: {name} ({sym['lib']}): {sym['regs']} registers, "
              f"{sym['smem_static']} B static + {sym['smem_dynamic']} B dynamic shared, "
              f"stack {sym['stack']} B, spill {sym['spill_stores']} B stores / "
              f"{sym['spill_loads']} B loads, {sym['threads']} threads, launch bounds "
              f"min {sym['min_blocks']} blocks, {sym['blocks_per_sm']} blocks an SM",
              flush=True)
    for case, names in current["cases"].items():
        print(f"kernelcheck: registry {case} launches {names}", flush=True)
    with open(os.path.join(default_contracts_dir(), "kernels.json")) as f:
        drifts = diff_kernels_contract(json.load(f), current)
    assert drifts == [], drifts
    out, err = outs["pallascheck"]
    assert gates["pallascheck"].returncode in (0, 1), err[-3000:]
    found = json.loads(out)["findings"]
    keys = {f"{f['kernel']}:{f['case']}:{f['kind']}" for f in found}
    for f in found:
        print(f"kernelcheck: finding {f['kernel']}:{f['case']}:{f['kind']}: {f['message']}",
              flush=True)
    assert keys == KNOWN_KERNEL_FINDINGS, (sorted(keys), sorted(KNOWN_KERNEL_FINDINGS))
    assert gates["pallascheck"].returncode == (1 if keys else 0)
    print(f"kernelcheck: {len(current['symbols'])} symbols, kernels.json no drift; "
          f"pallascheck {len(current['cases'])} rows: {len(found)} findings, exactly the "
          f"known {len(KNOWN_KERNEL_FINDINGS)} (ROADMAP C5); {err.strip().splitlines()[-1]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def check_enrolled() -> None:
    """(c) Every kernel that launched in this run is enrolled by a row."""
    from mpi4dl_tpu_torch.ops import flash_attention as fa
    from mpi4dl_tpu_torch.ops import halo_conv as hc
    from mpi4dl_tpu_torch.ops import kernel_registry as kr

    launched = {name: t["launches"] for mod in (hc, fa) for name, t in mod.TALLY.items()
                if t["launches"]}
    launched.update({name: n for mod in (hc, fa) for name, n in mod.LAUNCHES.items()
                     if n and name not in launched})
    missing = sorted(set(launched) - set(kr.enrolled_kernels()))
    assert not missing, f"kernels launched but enrolled by no registry row: {missing}"
    print(f"analysis: launched in this run {launched}, every one enrolled", flush=True)


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16

    # fp32 ragged tails: the kernel registry's conv case.
    x = torch.randn((1, 130, 258, 8), generator=gen, device=dev)
    w = torch.randn((3, 3, 8, 300), generator=gen, device=dev) / 9
    win = (1, 127, 2, 254)
    got = hc.halo_conv2d(x, w, fuse_relu=True, stat_window=win)
    ref = hc.halo_conv2d_plain(x, w, fuse_relu=True, stat_window=win)
    for name, g, r in zip(("y", "sum", "sumsq"), got, ref):
        u = scaled_ulp(g, r)
        assert u <= 8.0, f"K2 fp32 ragged {name}: {u} scaled ULP"
    u = scaled_ulp(hc.halo_conv2d(x, w), hc.halo_conv2d_plain(x, w))
    assert u <= 8.0, f"K1 fp32 ragged: {u} scaled ULP"
    torch.cuda.synchronize()
    print("kernels: fp32 ragged (1,130,258,8) x (3,3,8,300): K1, K2 within 8 scaled ULP",
          flush=True)

    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0, err=0.0)
           for k in ("K1", "K2")}
    for hw, m, (kh, kw), calls in MAIN_PATH:
        tag = f"{hw}x{hw} m={m} {kh}x{kw}"
        bound = 1.0 / math.sqrt(m * kh * kw)
        xp = torch.randn((1, hw + kh - 1, hw + kw - 1, m), generator=gen, device=dev).to(bf)
        wk = ((torch.rand((kh, kw, m, m), generator=gen, device=dev) * 2 - 1) * bound).to(bf)
        full = (0, hw, 0, hw)
        # K2 as the forward of a fused window.
        y, s, ss = hc.halo_conv2d(xp, wk, fuse_relu=True, stat_window=full)
        yr, sr, ssr = hc.halo_conv2d_plain(xp, wk, fuse_relu=True, stat_window=full)
        e2 = check_bf16(f"K2 {tag} y", y, yr)
        check_stats_bf16(f"K2 {tag}", s, ss, sr, ssr, yr)
        again = hc.halo_conv2d(xp, wk, fuse_relu=True, stat_window=full)
        assert all(torch.equal(a, b) for a, b in zip((y, s, ss), again)), \
            f"K2 {tag}: two launches differ"
        # K1 as the forward conv, and as K2's dx: the padded cotangent with
        # the flipped, io-swapped kernel.
        e1 = check_bf16(f"K1 {tag} fwd", hc.halo_conv2d(xp, wk), hc.halo_conv2d_plain(xp, wk))
        ct = torch.randn((1, hw, hw, m), generator=gen, device=dev).to(bf)
        ctp = hc.pad_hw(ct, kh - 1, kw - 1)
        wt = hc._flip_swap(wk)
        dx = hc.halo_conv2d(ctp, wt)
        e1 = max(e1, check_bf16(f"K1 {tag} dx", dx, hc.halo_conv2d_plain(ctp, wt)))
        torch.cuda.synchronize()
        def k2_fn():
            return hc.halo_conv2d(xp, wk, fuse_relu=True, stat_window=full)

        def k1_fn():
            return hc.halo_conv2d(ctp, wt)

        ctp_nchw, wt_oihw = ctp.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        k2 = graph_ms(k2_fn)
        p2 = graph_ms(lambda: hc.halo_conv2d_plain(xp, wk, fuse_relu=True, stat_window=full))
        k1 = graph_ms(k1_fn)
        l1 = graph_ms(lambda: F.conv2d(ctp_nchw, wt_oihw))
        p1 = graph_ms(lambda: hc.halo_conv2d_plain(ctp, wt))
        eager = {"K2": time_ms(k2_fn), "K1": time_ms(k1_fn),
                 "F.conv2d": time_ms(lambda: F.conv2d(ctp_nchw, wt_oihw))}
        b2, f2 = call_cost(xp, wk, y.shape, True)
        b1, f1 = call_cost(ctp, wt, dx.shape, False)
        for key, ms, pms, lms, nb, fl, err in (("K2", k2, p2, 0.0, b2, f2, e2),
                                               ("K1", k1, p1, l1, b1, f1, e1)):
            t = tot[key]
            t["ms"] += calls * ms
            t["plain_ms"] += calls * pms
            t["library_ms"] += calls * lms
            t["bytes"] += calls * nb
            t["flops"] += calls * fl
            t["err"] = max(t["err"], err)
            bound_us = 1e6 * max(nb / HBM_BYTES_PER_S, fl / PEAK_BF16_FLOPS)
            lib = (f" F.conv2d {lms:.4f} ms (eager {eager['F.conv2d']:.4f}; "
                   f"kernel/F.conv2d {ms / lms:.2f})" if key == "K1" else "")
            print(f"kernels: {key} {tag} x{calls}/step: kernel {ms:.4f} ms (eager "
                  f"{eager[key]:.4f})  plain {pms:.4f} ms{lib}  bound {bound_us:.2f} us  "
                  f"{fl / ms / 1e9:.1f} TFLOP/s  max|err| {err:.3g}", flush=True)
    return tot


SLICE = {}  # phase 3's median ms a step, for phase 28


def phase_slice():
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.ops import halo_conv as hc
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    dev = torch.device("cuda")
    shape = (1, 1024, 1024, 3)
    model = amoebanetd(shape, num_classes=1000, num_layers=18, num_filters=416,
                       device=dev, seed=0)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, remat=False,
                           pallas_conv=True)
    state = TrainState.create(model, opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(shape, generator=gen, device=dev)
    y = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    times = []
    for i in range(4):
        before = dict(hc.LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        d2 = hc.LAUNCHES["halo_conv2d_stats"] - before["halo_conv2d_stats"]
        d1 = hc.LAUNCHES["halo_conv2d"] - before["halo_conv2d"]
        print(f"slice: step {i} loss {loss:.6f} {times[-1] * 1e3:.1f} ms "
              f"K2 {d2} K1 {d1} launches", flush=True)
        assert math.isfinite(loss), f"step {i}: loss {loss}"
        assert d2 == 80 and d1 == 80, f"step {i}: K2 {d2}, K1 {d1} launches (want 80, 80)"
    launches = dict(hc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ips = 3 / sum(times[1:])
    SLICE["ms"] = 1e3 * statistics.median(times[1:])
    print(f"slice: AmoebaNet-D(18,416) 1024^2 bs1 bf16: {ips:.3f} img/s "
          f"({1e3 * sum(times[1:]) / 3:.1f} ms/step), peak {peak / 2**30:.2f} GiB",
          flush=True)
    del model, state, step, opt
    torch.cuda.empty_cache()

    # Reduced depth: the kernels against the plain (unfused) path.
    small = (1, 256, 256, 3)
    xs = torch.randn(small, generator=gen, device=dev)
    ys = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    losses = []
    for fused in (True, False):
        mdl = amoebanetd(small, num_classes=1000, num_layers=3, num_filters=416,
                         device=dev, seed=0)
        o = Optimizer("sgd", lr=1e-3)
        st = make_train_step(mdl, o, compute_dtype=torch.bfloat16, pallas_conv=fused)
        _, mm = st(TrainState.create(mdl, o), xs, ys)
        losses.append(float(mm["loss"]))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"slice: AmoebaNet-D(3,416) 256^2 bf16 loss kernels {losses[0]:.6f} "
          f"plain {losses[1]:.6f} rel {rel:.2e}", flush=True)
    assert all(math.isfinite(v) for v in losses), losses
    assert rel <= 1e-2, f"fused vs plain loss rel {rel}"
    return launches


# The spatial-parallel slice: the reference's best published run, "SP square
# + halo-D2" (README "Measured"), at full width on the one-process 2x2 tile
# grid, and ResNet-110 v2 (bench.py:153-163) beside it.
SP_AMOEBA = dict(arch="amoebanet", image=2048, depth=18)
SP_RESNET = dict(arch="resnet", image=1024, depth=110)
SP_PATHS = {"amoebanet_2048_sp_d2": SP_AMOEBA, "resnet110_1024_sp_d2": SP_RESNET}


def sp_parts(dev, arch, image, depth, d2=True, pallas=True, dtype=None, batch=1,
             local_dp=None, quant=None, opt=None):
    """(model, step, state) of an SP training step on a 2x2 square grid of
    tiles in this process: 416 filters (AmoebaNet), 1000 classes, batch 1,
    SGD lr 1e-3 (or ``opt``), remat off, bf16 compute unless ``dtype`` says
    otherwise, weights from seed 0 (the SP runners' ``--seed`` default);
    ``local_dp`` takes the ``batch_split`` junction of that degree;
    ``quant`` a ``QuantPolicy`` spec."""
    import torch

    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

    shape = (batch, image, image, 3)
    if arch == "amoebanet":
        model = amoebanetd(shape, num_classes=1000, num_layers=depth,
                           num_filters=416, device=dev, seed=0)
    else:
        model = get_resnet_v2(shape, depth, 1000, device=dev, seed=0)
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=d2,
                         use_pallas_conv=pallas)
    opt = opt or Optimizer("sgd", lr=1e-3)
    from mpi4dl_tpu_torch.quant import QuantPolicy

    step = make_spatial_train_step(
        model, opt, sp, compute_dtype=dtype or torch.bfloat16,
        junction="batch_split" if local_dp else "gather", local_dp=local_dp,
        quant=QuantPolicy.parse(quant))
    return model, step, TrainState.create(model, opt)


def sp_batch(dev, image, batch=1):
    """The runners' synthetic batch for --seed 0 (seed 1, image then label)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((batch, image, image, 3), generator=gen, device=dev)
    return x, torch.randint(0, 1000, (batch,), generator=gen, device=dev)


def dry_run(parts_fn, x_shape, **kw):
    """The K1/K2 calls of one step as the port dispatches them: the step of
    ``parts_fn(meta, **kw) -> (model, step, state)`` on the meta device on a
    batch of ``x_shape`` (shapes only), each call recorded
    (``halo_conv.count_dispatches``)."""
    import warnings

    import torch

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    meta = torch.device("meta")
    _, step, state = parts_fn(meta, **kw)
    with warnings.catch_warnings(), hc.count_dispatches() as seen:
        warnings.simplefilter("ignore")
        step(state, torch.zeros(x_shape, device=meta),
             torch.zeros(x_shape[:1], dtype=torch.long, device=meta))
    return seen


def sp_dry_run(arch, image, depth, batch=1, **kw):
    """The dry run of an SP step (:func:`sp_parts`)."""
    return dry_run(sp_parts, (batch, image, image, 3), arch=arch, image=image,
                   depth=depth, batch=batch, **kw)


def phase_sp_kernels(paths):
    """K1 and K2 at every distinct shape that the SP paths' dry runs
    record (``paths``: name -> Dispatches): held against the plain version
    (bf16 tolerances of phase 2, statistics over the call's window), two
    launches bitwise equal, and device time of kernel, plain version and
    (K1) ``F.conv2d``.  Returns per path the per-step sums."""
    import collections

    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf = torch.bfloat16
    uses = collections.defaultdict(collections.Counter)
    for name, seen in paths.items():
        for call in seen.calls:
            kernel, phase, xs, ws, _, relu, win = call
            uses[(kernel, xs, ws, relu, win)][(name, phase)] += 1
    per = {}
    for key, by_path in uses.items():
        kernel, xs, ws, relu, win = key
        kh, kw, cin, cout = ws
        x = torch.randn(xs, generator=gen, device=dev).to(bf)
        w = ((torch.rand(ws, generator=gen, device=dev) * 2 - 1)
             / math.sqrt(cin * kh * kw)).to(bf)
        got = hc.halo_conv2d(x, w, fuse_relu=relu, stat_window=win)
        ref = hc.halo_conv2d_plain(x, w, fuse_relu=relu, stat_window=win)
        tag = f"{kernel} x{tuple(xs)} w{tuple(ws)} win {win}"
        if win is None:
            y, yr = got, ref
        else:
            (y, s, ss), (yr, sr, ssr) = got, ref
            h0, h1, w0, w1 = win
            check_stats_bf16(tag, s, ss, sr, ssr, yr[:, h0:h1, w0:w1])
        err = check_bf16(tag, y, yr)
        again = hc.halo_conv2d(x, w, fuse_relu=relu, stat_window=win)
        same = (torch.equal(y, again) if win is None
                else all(torch.equal(a, b) for a, b in zip(got, again)))
        assert same, f"{tag}: two launches differ"
        torch.cuda.synchronize()
        del got, ref, again
        iters = 20 if x.numel() * 4 <= (64 << 20) else 5
        k_ms = graph_ms(lambda: hc.halo_conv2d(x, w, fuse_relu=relu, stat_window=win), iters)
        p_ms = graph_ms(lambda: hc.halo_conv2d_plain(x, w, fuse_relu=relu,
                                                     stat_window=win), iters)
        l_ms = None
        if win is None and not relu:
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
            l_ms = graph_ms(lambda: F.conv2d(x_nchw, w_oihw), iters)
        nb, fl = call_cost(x, w, y.shape, win is not None)
        per[key] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bytes=nb, flops=fl, err=err)
        bound_us = 1e6 * max(nb / HBM_BYTES_PER_S, fl / PEAK_BF16_FLOPS)
        lib = f"  F.conv2d {l_ms:.4f} ms" if l_ms is not None else ""
        print(f"sp kernels: {tag} {dict(by_path)}: kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms{lib}  bound {bound_us:.2f} us  "
              f"{fl / k_ms / 1e9:.1f} TFLOP/s  max|err| {err:.3g}", flush=True)
        del x, w, y, yr
        torch.cuda.empty_cache()
    sums = {}
    for name, seen in paths.items():
        sums[name] = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0,
                              err=0.0, launches=0) for k in ("K1", "K2")}
        for key, by_path in uses.items():
            n = sum(c for (pth, _), c in by_path.items() if pth == name)
            if not n:
                continue
            t = sums[name]["K1" if key[0] == "halo_conv2d" else "K2"]
            m = per[key]
            for f in ("ms", "plain_ms", "bytes", "flops"):
                t[f] += n * m[f]
            t["library_ms"] = (None if t["library_ms"] is None or m["library_ms"] is None
                               else t["library_ms"] + n * m["library_ms"])
            t["err"] = max(t["err"], m["err"])
            t["launches"] += n
        for k, t in sums[name].items():
            print(f"sp kernels: {name} {k}: {t['launches']} launches a step, kernel "
                  f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, F.conv2d "
                  f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 3)}"
                  f" ms, bound {bound_of(t['bytes'], t['flops'], PEAK_BF16_FLOPS)[0]:.3f}"
                  " ms a step", flush=True)
    return sums


def sp_train(dev, parts, pred, steps, label, batch=1):
    """Drive a step ``steps`` times (the first a warm-up) from the counts'
    zero, holding each step's K1/K2 launches to the dry run's ``pred``;
    returns (losses, seconds per timed step, peak bytes, launches)."""
    import torch

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    model, step, state = parts
    x, y = sp_batch(dev, model.in_shape[1], batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    losses, times = [], []
    for i in range(steps):
        before = dict(hc.LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {k: hc.LAUNCHES[k] - before[k] for k in hc.LAUNCHES}
        print(f"{label}: step {i} loss {losses[-1]:.6f} {times[-1] * 1e3:.1f} ms "
              f"K2 {got['halo_conv2d_stats']} K1 {got['halo_conv2d']} launches", flush=True)
        assert math.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}"
        assert got == pred.counts, f"step {i}: launches {got}, dispatch predicts {pred.counts}"
    return losses, times[1:], torch.cuda.max_memory_allocated(), dict(hc.LAUNCHES)


def phase_sp_slice(preds):
    """The full-width SP AmoebaNet-D step and the ResNet-110 v2 SP step."""
    import torch

    dev = torch.device("cuda")
    out = {}
    for name, cfg, steps in (("amoebanet_2048_sp_d2", SP_AMOEBA, 4),
                             ("resnet110_1024_sp_d2", SP_RESNET, 3)):
        parts = sp_parts(dev, cfg["arch"], cfg["image"], cfg["depth"])
        losses, times, peak, launches = sp_train(dev, parts, preds[name], steps, name)
        ips = len(times) / sum(times)
        print(f"sp slice: {name} bs1 bf16 2x2 D2: {ips:.3f} img/s "
              f"({1e3 * sum(times) / len(times):.1f} ms/step), peak {peak / 2**30:.2f} GiB, "
              f"first-step loss {losses[0]:.6f}", flush=True)
        out[name] = launches
        del parts
        torch.cuda.empty_cache()
    return out


def phase_sp_checks():
    """Reduced depth on the card: SP D2 through the kernels against SP D2
    through the plain path (bf16 rtol 1e-2, fp32 rtol 1e-5); SP D1 against
    the single-device step in fp32 (tests/test_spatial.py's tolerances)."""
    import warnings

    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    warnings.simplefilter("ignore")  # the pad-once pool notice
    dev = torch.device("cuda")
    x, y = sp_batch(dev, 512)
    for dtype, rtol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        losses = []
        for pallas in (True, False):
            _, step, state = sp_parts(dev, "amoebanet", 512, 3, pallas=pallas, dtype=dtype)
            losses.append(float(step(state, x, y)[1]["loss"]))
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"sp checks: AmoebaNet-D(3,416) 512^2 2x2 D2 {dtype}: loss kernels "
              f"{losses[0]:.6f} plain {losses[1]:.6f} rel {rel:.2e}", flush=True)
        assert all(math.isfinite(v) for v in losses) and rel <= rtol, (losses, rtol)
    models, steps, states = [], [], []
    for sp in (False, True):
        if sp:
            mdl, st, state = sp_parts(dev, "amoebanet", 512, 3, d2=False,
                                      dtype=torch.float32)
        else:
            mdl = amoebanetd((1, 512, 512, 3), num_classes=1000, num_layers=3,
                             num_filters=416, device=dev, seed=0)
            opt = Optimizer("sgd", lr=1e-3)
            st = make_train_step(mdl, opt, pallas_conv=True)
            state = TrainState.create(mdl, opt)
        models.append(mdl)
        steps.append(st)
        states.append(state)
    for i in range(2):
        l = [float(steps[j](states[j], x, y)[1]["loss"]) for j in range(2)]
        print(f"sp checks: AmoebaNet-D(3,416) 512^2 fp32 step {i}: one card {l[0]:.7f}, "
              f"SP D1 2x2 {l[1]:.7f}", flush=True)
        assert abs(l[1] - l[0]) <= 1e-4 * abs(l[0]), l
    worst = 0.0
    for a, b in zip(models[0].state_dict().values(), models[1].state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-4)
        worst = max(worst, float((b - a).abs().max()))
    print(f"sp checks: SP D1 vs one card after 2 steps: max|Δ| {worst:.3g} over "
          "parameters and running statistics (rtol 1e-3, atol 1e-4)", flush=True)
    del models, steps, states
    torch.cuda.empty_cache()


def flash_pairs(t_q: int, t_k: int, q_off: int, k_off: int, causal: bool) -> int:
    """The (query, key) pairs a block's mask leaves visible: the work this
    call's data needs."""
    if not causal:
        return t_q * t_k
    return sum(min(t_k, max(0, q_off + i - k_off + 1)) for i in range(t_q))


def flash_cost(bh, t_q, t_k, d, q_bytes, kv_bytes, q_off, k_off, causal):
    """(bytes, flops) of one K3 call: q (bf16 on the tensor-core path, fp32
    scaled on the CUDA-core one) and k, v read once, o_hat, m, l written
    once; 2 matmuls x 2 flops per visible pair and D."""
    nbytes = bh * t_q * d * q_bytes + 2 * bh * t_k * d * kv_bytes + bh * t_q * (d + 2) * 4
    return nbytes, 4 * bh * d * flash_pairs(t_q, t_k, q_off, k_off, causal)


def flash_bwd_cost(bh, t_q, t_k, d, q_off, k_off, causal):
    """(bytes, flops) of one K3 backward call (bf16 q, k, v): q, k, v, dô
    (fp32), m and dl read once, dq, dk, dv (fp32) written once; 5 matmuls
    (s, dP, dv, dk, dq) x 2 flops per visible pair and D."""
    nbytes = (bh * t_q * d * (2 + 4 + 4) + 2 * bh * t_k * d * (2 + 4)
              + 2 * bh * t_q * 4)
    return nbytes, 10 * bh * d * flash_pairs(t_q, t_k, q_off, k_off, causal)


def bound_of(nbytes, flops, peak):
    """(ms, 'bytes' or 'operations'): the larger of bytes over the memory
    rate and flops over ``peak``."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def check_flash_bwd(name, got, ref):
    """fp32 gradients within rtol 1e-4 / atol 1e-5·max|ref| (the JAX
    gradient test's tolerance, tests/test_pallas_attention.py:92-108); a
    zero reference exactly.  Returns max|Δ| and the largest share of its
    allowance that an element uses."""
    err = share = 0.0
    for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
        big = float(r.abs().max())
        if big == 0.0:
            assert bool((g == 0).all()), f"{name} {g_name}: not zero"
            continue
        diff = (g - r).abs()
        used = float((diff / (1e-5 * big + 1e-4 * r.abs())).max())
        assert used <= 1.0, f"{name} {g_name}: {used:.3g} of the allowance"
        err, share = max(err, float(diff.max())), max(share, used)
    return err, share


def check_flash(name, got, ref, bound: float = 1e-5) -> float:
    """m (unmasked rows) and o_hat/l within bound·max(1, max|ref|), l within
    rtol bound, masked rows exactly (0, -1e30, 0); returns max|Δ(o_hat/l)|."""
    import torch

    from mpi4dl_tpu_torch.ops.flash_attention import NEG_INF

    (o, m, l), (ro, rm, rl) = got, ref
    live = rm > NEG_INF * 0.5
    assert torch.equal(live, m > NEG_INF * 0.5), f"{name}: masked rows differ"
    dead = ~live
    assert bool(torch.all(m[dead] == NEG_INF) and torch.all(l[dead] == 0)
                and torch.all(o[dead] == 0)), f"{name}: masked rows not (0, -1e30, 0)"
    if not bool(live.any()):
        return 0.0
    dm = float((m[live] - rm[live]).abs().max())
    assert dm <= bound * max(1.0, float(rm[live].abs().max())), f"{name}: |dm| {dm}"
    dl = float(((l - rl).abs() / rl)[live].max())
    assert dl <= bound, f"{name}: l rel {dl}"
    on = o / l.clamp_min(1e-30)[..., None]
    ron = ro / rl.clamp_min(1e-30)[..., None]
    do = float((on - ron).abs().max())
    assert do <= bound * max(1.0, float(ron.abs().max())), f"{name}: |d(o/l)| {do}"
    return do


def sdpa_ms(q, k, v, causal, dtype, iters, windows):
    """``F.scaled_dot_product_attention`` in ``dtype`` on the block's
    ``[BH, T, D]`` tensors: (forward ms, backward-alone ms).  The backward
    is timed as ``torch.autograd.grad`` of one retained forward."""
    import torch
    import torch.nn.functional as F

    bh, _, d = q.shape
    q4, k4, v4 = (x.to(dtype).reshape(1, bh, -1, d).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                      iters, windows)
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    g = torch.randn_like(out)
    bwd = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), g, retain_graph=True),
                  iters, windows)
    return fwd, bwd


def phase_flash_kernels():
    import torch

    from mpi4dl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    main, main_bwd = {}, {}
    err = err_bwd = 0.0
    for label, bh, tq, tk, d, dt, causal, q_off, k_off, lib in K3_SHAPES:
        dtype = getattr(torch, dt)
        tensor_cores = dtype == torch.bfloat16
        q = torch.randn((bh, tq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((bh, tk, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        scale = 0.125 if label.startswith("registry") else d ** -0.5
        args = (q_off, k_off, causal, scale)
        got = fa.block_flash(q, k, v, *args)
        e = check_flash(f"K3 {label}", got, fa.block_flash_plain(q, k, v, *args))
        assert all(torch.equal(a, b) for a, b in zip(got, fa.block_flash(q, k, v, *args))), \
            f"K3 {label}: two launches differ"
        err = max(err, e)
        iters, windows = (3, 3) if tq > 4096 else (10, 5)
        eb = None
        if tensor_cores:
            do = torch.randn((bh, tq, d), generator=gen, device=dev)
            dl = torch.randn((bh, tq), generator=gen, device=dev)
            bargs = (q, k, v, got[1], do, dl, *args)
            grads = fa.block_flash_bwd(*bargs)
            eb, share = check_flash_bwd(f"K3 bwd {label}", grads,
                                        fa.block_flash_bwd_plain(*bargs))
            assert all(torch.equal(a, b) for a, b in zip(grads, fa.block_flash_bwd(*bargs))), \
                f"K3 bwd {label}: two launches differ"
            err_bwd = max(err_bwd, eb)
            del grads
        del got
        torch.cuda.synchronize()
        ms = time_ms(lambda: fa.block_flash(q, k, v, *args), iters, windows)
        pms = time_ms(lambda: fa.block_flash_plain(q, k, v, *args), iters, windows)
        nb, fl = flash_cost(bh, tq, tk, d, 2 if tensor_cores else 4, k.element_size(),
                            q_off, k_off, causal)
        peak = PEAK_BF16_FLOPS if tensor_cores else PEAK_FP32_FLOPS
        bound_ms, bound_by = bound_of(nb, fl, peak)
        lib_txt, sdpa = "", {}
        if lib:
            for name, ldt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                sdpa[name] = sdpa_ms(q, k, v, causal, ldt, iters, windows)
            lib_txt = "".join(f"  SDPA {n} fwd {f:.4f} bwd {b:.4f} ms"
                              for n, (f, b) in sdpa.items())
        tflops = f"{fl / ms / 1e9:.2f} TFLOP/s" if fl else "no visible pair"
        print(f"kernels: K3 {label} q{(bh, tq, d)} k{(bh, tk, d)} {dt} causal={causal} "
              f"offs=({q_off},{k_off}) {'tensor cores' if tensor_cores else 'CUDA cores'}: "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms{lib_txt}  bound {bound_ms:.4f} ms "
              f"({bound_by}, {peak / 1e12:.0f} TFLOP/s)  {tflops}  max|d(o/l)| {e:.3g}",
              flush=True)
        if label == K3_MAIN:
            main = dict(ms=SEQ_BLOCKS * ms, plain_ms=SEQ_BLOCKS * pms,
                        library_ms=SEQ_BLOCKS * sdpa["bf16"][0], bytes=SEQ_BLOCKS * nb,
                        flops=SEQ_BLOCKS * fl)
        if tensor_cores:
            bms = time_ms(lambda: fa.block_flash_bwd(*bargs), iters, windows)
            bpms = time_ms(lambda: fa.block_flash_bwd_plain(*bargs), iters, windows)
            nbb, flb = flash_bwd_cost(bh, tq, tk, d, q_off, k_off, causal)
            bbound, bby = bound_of(nbb, flb, PEAK_BF16_FLOPS)
            blib = (f"  SDPA bf16 bwd {sdpa['bf16'][1]:.4f} ms  fp32 bwd "
                    f"{sdpa['fp32'][1]:.4f} ms" if lib else "")
            btf = f"{flb / bms / 1e9:.2f} TFLOP/s" if flb else "no visible pair"
            print(f"kernels: K3 bwd {label}: kernel {bms:.4f} ms  plain {bpms:.4f} ms{blib}"
                  f"  bound {bbound:.4f} ms ({bby}, 989 TFLOP/s)  {btf}  max|d grad| "
                  f"{eb:.3g} ({share:.2f} of the allowance)", flush=True)
            if label == K3_MAIN:
                main_bwd = dict(ms=SEQ_BLOCKS * bms, plain_ms=SEQ_BLOCKS * bpms,
                                library_ms=SEQ_BLOCKS * sdpa["bf16"][1],
                                bytes=SEQ_BLOCKS * nbb, flops=SEQ_BLOCKS * flb)
            del bargs, do, dl
        del q, k, v
        torch.cuda.empty_cache()
    main["err"], main_bwd["err"] = err, err_bwd
    return main, main_bwd


def phase_ring():
    import torch

    from mpi4dl_tpu_torch.benchmarks.communication.ring import (
        benchmark_ring_attention as tool,
    )
    from mpi4dl_tpu_torch.ops.ring import emulated_ring, ring_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    q, k, v = (torch.randn((1, SEQ_T, SEQ_HEADS, 128), generator=gen, device=dev)
               for _ in range(3))
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            for causal in (False, True):
                got = emulated_ring(qd, kd, vd, 4, causal)
                want = ring_attention(qd, kd, vd, None, 1, causal=causal, use_flash=False)
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
                else:   # one bf16 ULP of the largest output
                    assert err <= 2.0 ** -7 * float(want.float().abs().max()), err
                print(f"ring: emulated 4-rank ring through K3, B1 H8 D128 T {SEQ_T} "
                      f"{dtype} causal={causal}: max|err| {err:.3g} vs plain attention",
                      flush=True)
                del got, want
            del qd, kd, vd
    del q, k, v
    torch.cuda.empty_cache()
    out = tool.measure(tool.get_parser().parse_args(
        ["--seq-len", str(SEQ_T), "--iterations", "3"]))
    print(json.dumps(out), flush=True)
    assert out["validation"] == "pass", out


def seq_blocks(n: int, dev):
    import torch

    from mpi4dl_tpu_torch.models.seqblock import SeqBlock

    return torch.nn.ModuleList(SeqBlock(SEQ_D, SEQ_HEADS, mlp_ratio=4, causal=True,
                                        device=dev, seed=i) for i in range(n))


def phase_seq_slice():
    import torch

    from mpi4dl_tpu_torch.models.seqblock import make_seq_cp_train_step
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    blocks = seq_blocks(SEQ_BLOCKS, dev)
    step = make_seq_cp_train_step(blocks, None, 1, 1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x, y = (torch.randn((1, SEQ_T, SEQ_D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    times = []
    for i in range(4):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        loss = float(step(x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        d3 = fa.LAUNCHES["block_flash"] - before["block_flash"]
        d3b = fa.LAUNCHES["block_flash_bwd"] - before["block_flash_bwd"]
        print(f"seq slice: step {i} loss {loss:.6f} {times[-1] * 1e3:.1f} ms "
              f"K3 {d3} K3-backward {d3b} launches", flush=True)
        assert math.isfinite(loss), f"step {i}: loss {loss}"
        assert d3 == d3b == SEQ_BLOCKS, \
            f"step {i}: {d3} K3, {d3b} K3-backward launches (want {SEQ_BLOCKS})"
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times[1:]) / 3
    print(f"seq slice: SeqBlock(1024, 8) x{SEQ_BLOCKS} T {SEQ_T} bs1 bf16: "
          f"{SEQ_T / step_s:.1f} tokens/s ({1e3 * step_s:.1f} ms/step), "
          f"peak {peak / 2**30:.2f} GiB", flush=True)
    del blocks, step, x, y
    torch.cuda.empty_cache()

    # Reduced depth: one block at T 2048, K3 against the einsum path, in
    # fp32 (K3 on the CUDA cores, PyTorch-op backward) and in bf16 (K3 and
    # its backward kernel).
    xs, ys = (torch.randn((1, 2048, SEQ_D), generator=gen, device=dev) for _ in range(2))
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        losses = []
        for flash in (True, False):
            st = make_seq_cp_train_step(seq_blocks(1, dev), None, 1, 1e-3, use_flash=flash)
            before = dict(fa.LAUNCHES)
            losses.append(float(st(xs.to(dtype), ys.to(dtype))))
            assert fa.LAUNCHES["block_flash"] - before["block_flash"] == int(flash), "K3"
            want_bwd = int(flash and dtype == torch.bfloat16)
            assert fa.LAUNCHES["block_flash_bwd"] - before["block_flash_bwd"] == want_bwd
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"seq slice: SeqBlock(1024, 8) x1 T 2048 {dtype} loss K3 {losses[0]:.8f} "
              f"einsum {losses[1]:.8f} rel {rel:.2e} (rtol {rtol:g})", flush=True)
        assert all(math.isfinite(v) for v in losses), losses
        assert rel <= rtol, f"K3 vs einsum loss rel {rel}"
    return launches


def _profile(path: str, title: str, step, kernel_keys) -> None:
    """Profile one call of ``step`` (after two warm-ups): device time by
    kernel name, appended to ``path``, and the share of the kernels whose
    names hold each of ``kernel_keys``."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    # Kernel time only, as the table's own total counts it: CUDA events
    # that are not annotation ranges.
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"== {title}\n{table}\n")
    print(table, flush=True)
    shares = []
    for key in kernel_keys:
        key_us = sum(e.self_device_time_total for e in kernels if key in e.key)
        shares.append(f"{key} {key_us / 1e3:.1f} ms "
                      f"({100 * key_us / max(busy_us, 1e-9):.1f}% of busy)")
    print(f"profile: {title}: step {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          + ", ".join(shares), flush=True)


def profile_steps(path: str) -> None:
    """One profiled full-width step of each slice."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.seqblock import make_seq_cp_train_step
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    dev = torch.device("cuda")
    open(path, "w").close()
    shape = (1, 1024, 1024, 3)
    model = amoebanetd(shape, num_classes=1000, num_layers=18, num_filters=416,
                       device=dev, seed=0)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, pallas_conv=True)
    state = TrainState.create(model, opt)
    x = torch.randn(shape, device=dev)
    y = torch.zeros((1,), dtype=torch.long, device=dev)
    _profile(path, "AmoebaNet-D(18,416) 1024^2 bs1 bf16", lambda: step(state, x, y),
             ("halo_conv",))
    del model, state, step, opt
    torch.cuda.empty_cache()
    for name, cfg in SP_PATHS.items():
        model, step, state = sp_parts(dev, cfg["arch"], cfg["image"], cfg["depth"])
        x, y = sp_batch(dev, cfg["image"])
        _profile(path, f"{name} bs1 bf16, one-process 2x2 grid",
                 lambda: step(state, x, y), ("halo_conv",))
        del model, step, state
        torch.cuda.empty_cache()
    seq_step = make_seq_cp_train_step(seq_blocks(SEQ_BLOCKS, dev), None, 1, 1e-3)
    xs, ys = (torch.randn((1, SEQ_T, SEQ_D), device=dev).to(torch.bfloat16)
              for _ in range(2))
    _profile(path, f"SeqBlock(1024,8)x{SEQ_BLOCKS} T {SEQ_T} bs1 bf16",
             lambda: seq_step(xs, ys),
             ("block_flash_fwd", "block_flash_bwd", "block_flash_split"))


# The pipeline slice: AmoebaNet-D(18, 416) at 1024², batch 4 in 4 micro-batches
# over 4 stages (the JAX runner's `--split-size 4 --parts 4`), all stages on
# the one-process stage chain; and ResNet-110 v2 at 1024² on the 2x2 grid with
# the batch_split junction at degree 4 (`--local-DP 4`).
PP_PATHS = {"amoebanet_1024_pp_gpipe": "gpipe", "amoebanet_1024_pp_1f1b": "1f1b"}
PP_BATCH, PP_PARTS, PP_SPLIT = 4, 4, 4
LDP_PATH = "resnet110_1024_sp_localdp4"
LDP_BATCH = 4


# The depth of the engine slices (phases 10, 14, 15's GEMS steps, 19):
# AmoebaNet-D(6, 416), to keep the script inside its time; the full depth
# runs in phases 3, 7-8 and 20-27.
ENGINE_DEPTH = 6


def pp_parts(dev, schedule, depth=ENGINE_DEPTH, image=1024, dtype=None, pallas=True,
             filters=416):
    """(model, step, state) of a pipeline step on the one-process stage
    chain: AmoebaNet-D(depth, filters), 1000 classes, batch 4 in 4
    micro-batches over 4 stages, SGD lr 1e-3, remat off, bf16 compute
    unless ``dtype`` says otherwise, weights from seed 0."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.partition import StagePartition
    from mpi4dl_tpu_torch.parallel.pipeline import (
        init_pipeline_state, make_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.train import Optimizer

    model = amoebanetd((PP_BATCH, image, image, 3), num_classes=1000, num_layers=depth,
                       num_filters=filters, device=dev, seed=0)
    part = StagePartition.build(model, PP_SPLIT, (PP_BATCH // PP_PARTS, image, image, 3))
    stages = StageChain(PP_SPLIT)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_pipeline_train_step(part, opt, stages, PP_PARTS,
                                    compute_dtype=dtype or torch.bfloat16, remat=False,
                                    schedule=schedule, pallas_conv=pallas)
    return model, step, init_pipeline_state(part, opt, stages)


def all_dry_runs():
    """Every path's dry run (name -> Dispatches): run in a worker process
    while the card works, since the meta device runs each op in Python."""
    out = {name: sp_dry_run(cfg["arch"], cfg["image"], cfg["depth"])
           for name, cfg in SP_PATHS.items()}
    for name, schedule in PP_PATHS.items():
        out[name] = dry_run(pp_parts, (PP_BATCH, 1024, 1024, 3), schedule=schedule)
    out[LDP_PATH] = sp_dry_run("resnet", 1024, 110, batch=LDP_BATCH, local_dp=LDP_BATCH)
    return out


def engine_dry_runs():
    """The GEMS and SP x PP paths' dry runs, in a second worker."""
    out = {}
    for name, schedule in GEMS_PATHS.items():
        out[name] = dry_run(gems_parts, (GEMS_BATCH, GEMS_IMAGE, GEMS_IMAGE, 3),
                            schedule=schedule)
    for name, engine in SPPP_PATHS.items():
        out[name] = dry_run(sppp_parts, (SPPP_BATCH, GEMS_IMAGE, GEMS_IMAGE, 3),
                            engine=engine)
    return out


def phase_pp_slice(preds):
    """The full-width pipeline steps: GPipe, then 1F1B, 1 warm-up and 3
    timed steps each, launches equal to the dry run's; 1F1B's peak below
    GPipe's."""
    import torch

    dev = torch.device("cuda")
    out, peaks = {}, {}
    for name, schedule in PP_PATHS.items():
        t0 = time.perf_counter()
        parts = pp_parts(dev, schedule)
        losses, times, peak, launches = sp_train(dev, parts, preds[name], 4, name,
                                                 batch=PP_BATCH)
        ips = PP_BATCH * len(times) / sum(times)
        print(f"pp slice: {name} bs{PP_BATCH} parts {PP_PARTS} stages {PP_SPLIT} bf16: "
              f"{ips:.3f} img/s ({1e3 * sum(times) / len(times):.1f} ms/step), peak "
              f"{peak / 2**30:.2f} GiB, first-step loss {losses[0]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        out[name], peaks[schedule] = launches, peak
        del parts
        torch.cuda.empty_cache()
    assert peaks["1f1b"] < peaks["gpipe"], f"1F1B peak {peaks['1f1b']} >= GPipe {peaks['gpipe']}"
    return out


def phase_pp_checks():
    """Reduced depth in fp32, AmoebaNet-D(3, 416) at 256², kernels on:
    GPipe against the single-card step accumulated over the 4 micro-batches
    (losses rtol 1e-4, parameters rtol 2e-3 / atol 5e-5,
    tests/test_pipeline.py:55-65), then 1F1B against GPipe (losses rtol
    1e-5, parameters tests/test_1f1b.py:54's TOL), two steps each."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    x, y = sp_batch(dev, 256, PP_BATCH)
    ref = amoebanetd((PP_BATCH, 256, 256, 3), num_classes=1000, num_layers=3,
                     num_filters=416, device=dev, seed=0)
    opt = Optimizer("sgd", lr=1e-3)
    ref_step = make_train_step(ref, opt, parts=PP_PARTS, pallas_conv=True)
    ref_state = TrainState.create(ref, opt)
    runs = [(ref, ref_step, ref_state)]
    runs += [pp_parts(dev, sched, depth=3, image=256, dtype=torch.float32)
             for sched in ("gpipe", "1f1b")]
    for i in range(2):
        l = [float(st(state, x, y)[1]["loss"]) for _, st, state in runs]
        print(f"pp checks: AmoebaNet-D(3,416) 256^2 fp32 step {i}: one card "
              f"{l[0]:.7f}, GPipe {l[1]:.7f}, 1F1B {l[2]:.7f}", flush=True)
        assert abs(l[1] - l[0]) <= 1e-4 * abs(l[0]), l
        assert abs(l[2] - l[1]) <= 1e-5 * abs(l[1]), l
    worst = [0.0, 0.0]
    for a, g, f in zip(*(list(m.state_dict().values()) for m, _, _ in runs)):
        torch.testing.assert_close(g, a, rtol=2e-3, atol=5e-5)
        torch.testing.assert_close(f, g, rtol=2e-3, atol=5e-5)
        worst = [max(worst[0], float((g - a).abs().max())),
                 max(worst[1], float((f - g).abs().max()))]
    print(f"pp checks: after 2 steps max|Δ| GPipe vs one card {worst[0]:.3g}, 1F1B vs "
          f"GPipe {worst[1]:.3g} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del runs, ref, ref_step, ref_state
    torch.cuda.empty_cache()


def phase_ldp_slice(preds):
    """Full-width ResNet-110 v2 1024², 2x2 grid, D2, batch 4, the
    batch_split junction at degree 4, kernels on: 1 warm-up and 2 timed
    steps with the dry run's launches."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    parts = sp_parts(dev, "resnet", 1024, 110, batch=LDP_BATCH, local_dp=LDP_BATCH)
    losses, times, peak, launches = sp_train(dev, parts, preds[LDP_PATH], 3, LDP_PATH,
                                             batch=LDP_BATCH)
    print(f"ldp slice: {LDP_PATH} bs{LDP_BATCH} bf16 2x2 D2 --local-DP {LDP_BATCH}: "
          f"{LDP_BATCH * len(times) / sum(times):.3f} img/s "
          f"({1e3 * sum(times) / len(times):.1f} ms/step), peak {peak / 2**30:.2f} GiB, "
          f"first-step loss {losses[0]:.6f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del parts
    torch.cuda.empty_cache()
    return launches


def phase_card_vs_cpu():
    """The card against the CPU (tests/test_torch_cuda.py).  fp32: ResNet
    v1 (depth 8) and v2 (depth 11) at 64² batch 2, whole-model gradients
    within 1e-4 (norm-relative), with and without the kernels.  The
    reduced-depth SP D1 and D2 steps on the 2x2 grid, and D2 with the
    batch_split junction at degree 2 (gather and slice) and 4
    (all_to_all), each twice.  In float64 with the kernels off, the whole
    step: loss within rtol 1e-10, gradient within 1e-8 (norm-relative;
    the CPU's own change under a 1e-12 relative perturbation of the input
    is printed beside it), also for D1 at batch 2.  In fp32 with the
    kernels on: the loss within rtol 1e-5, and every layer call and K2
    window of the step replayed on its recorded input, outputs and VJPs
    within 1e-4.  The fp32 whole step's gradient is printed beside the
    CPU's own change under a 1e-6 perturbation: AmoebaNet's ReLU →
    BatchNorm → max-pool chains route gradients by ties that fp32 rounding
    flips, so that gradient is not continuous at fp32 rounding scale and
    is not held to 1e-4."""
    import warnings

    import torch

    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
    from mpi4dl_tpu_torch.models import get_resnet_v1, get_resnet_v2
    from mpi4dl_tpu_torch.train import cross_entropy
    from mpi4dl_tpu_torch.utils.devcheck import norm_rel, replay_units, sp_step_run

    warnings.simplefilter("ignore")  # the pad-once pool notice
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    shape = (2, 64, 64, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([3, 7])
    for version, build, depth in ((1, get_resnet_v1, 8), (2, get_resnet_v2, 11)):
        ref_model = build(shape, depth, 10, device="cpu", seed=0)

        def grads(d, knob):
            model = build(shape, depth, 10, device=d, seed=0)
            model.load_state_dict(ref_model.state_dict())
            ctx = ApplyCtx(train=True,
                           spatial=SpatialCtx(use_pallas_conv=True) if knob else None)
            loss = cross_entropy(model(x.to(d), ctx), y.to(d))
            return torch.autograd.grad(loss, list(model.parameters()))

        ref = grads("cpu", False)
        for knob in (False, True):
            rel = norm_rel(grads(dev, knob), ref)
            print(f"card vs cpu: ResNet v{version} depth {depth} 64^2 bs2 kernels "
                  f"{'on' if knob else 'off'}: gradient rel {rel:.2e}", flush=True)
            assert rel <= 1e-4, (version, knob, rel)
    f64 = torch.float64
    for label, d2, local_dp, batch in (("SP D1", False, None, 2), ("SP D1", False, None, 4),
                                       ("SP D2", True, None, 4),
                                       ("SP D2 --local-DP 2", True, 2, 4),
                                       ("SP D2 --local-DP 4", True, 4, 4)):
        loss, ref, model = sp_step_run("cpu", None, d2, local_dp, dtype=f64, batch=batch)
        state = model.state_dict()
        _, ref_p, _ = sp_step_run("cpu", state, d2, local_dp, eps=1e-12, dtype=f64,
                                  batch=batch)
        loss_d, got, _ = sp_step_run(dev, state, d2, local_dp, dtype=f64, batch=batch)
        rel = norm_rel(got, ref)
        print(f"card vs cpu: {label} AmoebaNet-D(3,32) 256^2 bs{batch} 2x2 float64 kernels "
              f"off: loss {loss_d!r} vs {loss!r}; whole-step gradient rel {rel:.2e} (the "
              f"CPU's own under a 1e-12 input perturbation: {norm_rel(ref_p, ref):.2e})",
              flush=True)
        assert abs(loss_d - loss) <= 1e-10 * abs(loss), (label, batch, loss_d, loss)
        assert rel <= 1e-8, (label, batch, rel)
        if batch != 4:
            continue
        loss, ref, model = sp_step_run("cpu", None, d2, local_dp)
        state = model.state_dict()
        _, ref_p, _ = sp_step_run("cpu", state, d2, local_dp, eps=1e-6)
        loss_d, got, _ = sp_step_run(dev, state, d2, local_dp)
        units, err_y, err_g = replay_units(
            model, lambda: sp_step_run("cpu", None, d2, local_dp, model=model), dev)
        print(f"card vs cpu: {label} AmoebaNet-D(3,32) 256^2 bs4 2x2 fp32 kernels on: loss "
              f"{loss_d:.7f} vs {loss:.7f}; {units} units replayed, worst output rel "
              f"{err_y:.2e}, VJP rel {err_g:.2e}; whole-step gradient rel "
              f"{norm_rel(got, ref):.2e} (the CPU's own under a 1e-6 input perturbation: "
              f"{norm_rel(ref_p, ref):.2e})", flush=True)
        assert abs(loss_d - loss) <= 1e-5 * abs(loss), (label, loss_d, loss)
        assert err_y <= 1e-4 and err_g <= 1e-4, (label, err_y, err_g)
    print(f"card vs cpu: {time.perf_counter() - t0:.1f} s", flush=True)


def step_ms(parts, x, y, steps=3):
    """Median host time of ``steps`` steps after one warm-up, each ending
    in a read of the loss."""
    import torch

    _, step, state = parts
    step(state, x, y)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(state, x, y)[1]["loss"])
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_kernels_ab():
    """Step ms with the kernels on and off (``--pallas-conv``): the
    single-card AmoebaNet-D(``ENGINE_DEPTH``, 416) 1024² bs1 step and the
    GPipe pipeline step of phase 10, on then off then on.  Recorded, not
    asserted."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def single(pallas):
        model = amoebanetd((1, 1024, 1024, 3), num_classes=1000, num_layers=ENGINE_DEPTH,
                           num_filters=416, device=dev, seed=0)
        opt = Optimizer("sgd", lr=1e-3)
        return model, make_train_step(model, opt, compute_dtype=torch.bfloat16,
                                      pallas_conv=pallas), TrainState.create(model, opt)

    for label, build, batch in (
            (f"AmoebaNet-D({ENGINE_DEPTH},416) 1024^2 bs1 one card", single, 1),
            (f"AmoebaNet-D({ENGINE_DEPTH},416) 1024^2 bs4 GPipe 4x4",
             lambda pallas: pp_parts(dev, "gpipe", pallas=pallas),
             PP_BATCH)):
        x, y = sp_batch(dev, 1024, batch)
        ms = {}
        for pallas in (True, False, True):
            parts = build(pallas)
            ms.setdefault(pallas, []).append(step_ms(parts, x, y))
            del parts
            torch.cuda.empty_cache()
        print(f"kernels a/b: {label}: kernels on {ms[True][0]:.1f} / {ms[True][1]:.1f} ms, "
              f"off {ms[False][0]:.1f} ms a step", flush=True)
    print(f"kernels a/b: {time.perf_counter() - t0:.1f} s", flush=True)


# The GEMS and SP x PP slices: AmoebaNet-D(18, 416) at 1024², batch 4, bf16,
# kernels on, remat off.  GEMS: 4 stages on the one-process chain, times 1 x 2
# streams x parts 2 x 1 image (the pipeline slice's batch as two streams).
# SP x PP and SP + GEMS: the 2x2 grid, halo-D2, the gather junction after cell
# 12 (the first of two even splits of the 24 cells, where the runner puts it),
# the tail over 2 stages of the chain; SP x PP in 2 micro-batches of 2, SP +
# GEMS times 1 x 2 streams x parts 1 x 2 images (2·times·parts == stages).
GEMS_PATHS = {"amoebanet_1024_gems_chain_gpipe": "gpipe",
              "amoebanet_1024_gems_chain_1f1b": "1f1b"}
GEMS_BATCH, GEMS_PARTS, GEMS_SPLIT, GEMS_IMAGE = 4, 2, 4, 1024
SPPP_PATHS = {"amoebanet_1024_sp_pp_grid": "sp_pp", "amoebanet_1024_sp_gems_grid": "sp_gems"}
SPPP_BATCH, SPPP_SPLIT, SPPP_UNTIL = 4, 2, 12


def gems_parts(dev, schedule):
    """(model, step, state) of the GEMS step on the one-process chain."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.gems import make_gems_train_step
    from mpi4dl_tpu_torch.parallel.partition import StagePartition
    from mpi4dl_tpu_torch.parallel.pipeline import init_pipeline_state
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.train import Optimizer

    model = amoebanetd((GEMS_BATCH, GEMS_IMAGE, GEMS_IMAGE, 3), num_classes=1000,
                       num_layers=ENGINE_DEPTH, num_filters=416, device=dev, seed=0)
    part = StagePartition.build(model, GEMS_SPLIT,
                                (GEMS_BATCH // (2 * GEMS_PARTS), GEMS_IMAGE, GEMS_IMAGE, 3))
    opt = Optimizer("sgd", lr=1e-3)
    step = make_gems_train_step(part, opt, StageChain(GEMS_SPLIT), GEMS_PARTS,
                                compute_dtype=torch.bfloat16, remat=False,
                                schedule=schedule, pallas_conv=True)
    return model, step, init_pipeline_state(part, opt, StageChain(GEMS_SPLIT))


def sppp_parts(dev, engine, quant=None, opt=None):
    """(model, step, state) of the SP x PP (``engine`` "sp_pp") or SP +
    GEMS ("sp_gems") step on the one-process 2x2 grid and stage chain;
    ``quant`` a ``QuantPolicy`` spec, ``opt`` the optimizer (SGD lr 1e-3)."""
    import torch

    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_gems_train_step,
        make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer

    model = amoebanetd((SPPP_BATCH, GEMS_IMAGE, GEMS_IMAGE, 3), num_classes=1000, num_layers=18,
                       num_filters=416, device=dev, seed=0)
    model.spatial_until = SPPP_UNTIL
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=True,
                         use_pallas_conv=True)
    gems = engine == "sp_gems"
    parts = 1 if gems else 2
    spp = SPPipeline.build(model, SPPP_SPLIT, sp, SPPP_BATCH // (2 * parts if gems else parts),
                           junction="gather")
    opt = opt or Optimizer("sgd", lr=1e-3)
    chain = StageChain(SPPP_SPLIT)
    from mpi4dl_tpu_torch.quant import QuantPolicy

    kw = dict(compute_dtype=torch.bfloat16, remat=False, quant=QuantPolicy.parse(quant))
    step = (make_sp_gems_train_step(spp, opt, chain, parts, times=1, **kw) if gems
            else make_sp_pipeline_train_step(spp, opt, chain, parts, **kw))
    return model, step, init_sp_pipeline_state(spp, opt, chain)


def phase_gems_sppp_slices(preds):
    """The full-width GEMS (GPipe, 1F1B), SP x PP and SP + GEMS steps: 1
    warm-up and 3 timed steps each, launches equal to the dry runs'."""
    import torch

    dev = torch.device("cuda")
    out = {}
    runs = ([(name, lambda s=s: gems_parts(dev, s), GEMS_BATCH, f"bs{GEMS_BATCH} "
              f"times 1 x 2 x parts {GEMS_PARTS} stages {GEMS_SPLIT} chain")
             for name, s in GEMS_PATHS.items()]
            + [(name, lambda e=e: sppp_parts(dev, e), SPPP_BATCH,
                f"bs{SPPP_BATCH} 2x2 D2 + {SPPP_SPLIT} stages, junction after cell "
                f"{SPPP_UNTIL}") for name, e in SPPP_PATHS.items()])
    for name, build, batch, what in runs:
        t0 = time.perf_counter()
        parts = build()
        losses, times, peak, launches = sp_train(dev, parts, preds[name], 4, name,
                                                 batch=batch)
        print(f"gems/sp-pp slice: {name} {what} bf16: {batch * len(times) / sum(times):.3f} "
              f"img/s ({1e3 * sum(times) / len(times):.1f} ms/step), peak "
              f"{peak / 2**30:.2f} GiB, first-step loss {losses[0]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        out[name] = launches
        del parts
        torch.cuda.empty_cache()
    return out


def phase_engine_checks():
    """Reduced depth on the card, each engine against the single-card step
    accumulated over the same micro-batches (utils/devcheck.engine_run,
    two steps): ResNet-11 v2 32² in fp32 with the kernels on, GEMS over 4
    and 3 stages and SP x PP / SP + GEMS (1x2 grid, 2 stages), GPipe and
    1F1B, within the JAX tests' bounds (losses rtol 1e-4, parameters rtol
    2e-3 / atol 1e-5); AmoebaNet-D(3, 32) 128² in float64 with the kernels
    off, where rounding flips no max-pool tie: losses rtol 1e-10, the
    parameters' updates within 1e-8 (norm-relative).  Then the striped
    ResNet branch (C3), card against CPU with its gates lowered, per-stripe
    and exact statistics: loss rtol 1e-5, gradients and running statistics
    within 1e-4 (norm-relative)."""
    import torch

    from mpi4dl_tpu_torch.utils.devcheck import (
        engine_run, hstripe_gates, hstripe_run, norm_rel,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cases = [(e, dict(split=sp, parts=2, schedule=s), 1)
             for e, sp in (("gems", 4), ("gems", 3)) for s in ("gpipe", "1f1b")]
    cases += [(e, dict(parts=p, schedule=s), 2) for e, p in (("sp_pp", 2), ("sp_gems", 1))
              for s in ("gpipe", "1f1b")]
    for arch, dtype in (("resnet", torch.float32), ("amoebanet", torch.float64)):
        f64 = dtype == torch.float64
        kw = dict(arch=arch, dtype=dtype, pallas=not f64)
        if f64:
            kw.update(image=128, spatial_until=5)
        init = engine_run("cpu", "single", steps=0, **kw)[1]
        refs = {m: engine_run(dev, "single", micro=m, **kw) for m in (1, 2)}
        for engine, extra, micro in cases:
            losses, got = engine_run(dev, engine, micro=micro, **extra, **kw)
            want_losses, want = refs[micro]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
            keys = [k for k in init if init[k].is_floating_point()]
            upd = norm_rel([got[k] - init[k] for k in keys], [want[k] - init[k] for k in keys])
            print(f"engine checks: {arch} {dtype} {engine} {extra}: losses {losses} vs "
                  f"{want_losses} (rel {rel:.2e}), update rel {upd:.2e}", flush=True)
            if f64:
                assert rel <= 1e-10 and upd <= 1e-8, (arch, engine, extra, rel, upd)
            else:
                assert rel <= 1e-4, (engine, extra, rel)
                for k in keys:
                    torch.testing.assert_close(got[k], want[k], rtol=2e-3, atol=1e-5)
    striped = []
    for exact in ("0", "1"):
        os.environ["MPI4DL_HSTRIPE_EXACT"] = exact
        with hstripe_gates():
            loss, grads, stats, model = hstripe_run("cpu")
            loss_d, grads_d, stats_d, _ = hstripe_run(dev, model.state_dict())
        del os.environ["MPI4DL_HSTRIPE_EXACT"]
        rg, rs = norm_rel(grads_d, grads), norm_rel(stats_d, stats)
        print(f"engine checks: striped ResNet branch (C3), MPI4DL_HSTRIPE_EXACT={exact}: "
              f"loss {loss_d:.7f} vs CPU {loss:.7f}, gradient rel {rg:.2e}, running "
              f"statistics rel {rs:.2e}", flush=True)
        assert abs(loss_d - loss) <= 1e-5 * abs(loss) and rg <= 1e-4 and rs <= 1e-4
        striped.append(loss)
    assert striped[0] != striped[1], "the branch was not striped"
    print(f"engine checks: {time.perf_counter() - t0:.1f} s", flush=True)


# Multi-level SP: AmoebaNet-D(18, 416), the levels of the runners' rule at
# `--num-spatial-parts 4,2 --split-size 3 --spatial-size 2` (cells [0, 8) on the
# 2x2 grid, [8, 16) on the (1, 2) level of rep (2, 1), the tail from cell 16):
# the SP step at 2048² bs1, and SP x PP at 1024² with the tail over 3 stages of
# the chain, bs6 in 2 micro-batches (the batch must divide over the 3 stage
# chunks in both packages, so the issue's bs4 cannot run).
ML_PATH, MLPP_PATH = "amoebanet_2048_sp_multilevel", "amoebanet_1024_sp_pp_multilevel"
ML_SPLIT, MLPP_BATCH, MLPP_PARTS = 3, 6, 2


def ml_levels(n_cells, tiles, pallas=True):
    """The runners' level chain (``benchmarks/common.spatial_levels``) at
    ``--num-spatial-parts 4,2 --split-size 3 --spatial-size 2``, square,
    halo-D2."""
    from mpi4dl_tpu_torch.benchmarks.common import spatial_levels
    from mpi4dl_tpu_torch.config import ParallelConfig

    cfg = ParallelConfig(model="amoebanet", split_size=ML_SPLIT, spatial_size=2,
                         num_spatial_parts=(4, 2), slice_method="square", halo_d2=True,
                         pallas_conv=pallas)
    return spatial_levels(cfg, n_cells, None, tiles, say=lambda *a, **k: None)


def ml_parts(dev, image=2048, depth=18, batch=1, dtype=None, pallas=True):
    """(model, step, state) of the multi-level SP step on the one-process
    2x2 grid: 1000 classes, SGD lr 1e-3, remat off, bf16 unless ``dtype``."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

    model = amoebanetd((batch, image, image, 3), num_classes=1000, num_layers=depth,
                       num_filters=416, device=dev, seed=0)
    levels = ml_levels(len(model.cells), TileGrid(2, 2), pallas)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_spatial_train_step(model, opt, levels[0][1], levels=levels,
                                   compute_dtype=dtype or torch.bfloat16)
    return model, step, TrainState.create(model, opt)


def mlpp_parts(dev):
    """(model, step, state) of multi-level SP x PP, GPipe, on the grid and
    a chain of ``ML_SPLIT`` tail stages."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer

    model = amoebanetd((MLPP_BATCH, 1024, 1024, 3), num_classes=1000, num_layers=18,
                       num_filters=416, device=dev, seed=0)
    levels = ml_levels(len(model.cells), TileGrid(2, 2))
    model.spatial_until = levels[-1][0]
    spp = SPPipeline.build(model, ML_SPLIT, levels[0][1], MLPP_BATCH // MLPP_PARTS,
                           junction="gather", levels=levels)
    opt = Optimizer("sgd", lr=1e-3)
    chain = StageChain(ML_SPLIT)
    step = make_sp_pipeline_train_step(spp, opt, chain, MLPP_PARTS,
                                       compute_dtype=torch.bfloat16, remat=False)
    return model, step, init_sp_pipeline_state(spp, opt, chain)


def ml_dry_runs():
    """The multi-level paths' dry runs, in a third worker."""
    return {ML_PATH: dry_run(ml_parts, (1, 2048, 2048, 3)),
            MLPP_PATH: dry_run(mlpp_parts, (MLPP_BATCH, 1024, 1024, 3))}


def phase_ml_slices(preds):
    """The multi-level SP step (2048² bs1) and multi-level SP x PP (1024²
    bs6, GPipe): 1 warm-up and 3 timed steps each, launches equal to the
    dry runs'."""
    import torch

    dev = torch.device("cuda")
    out = {}
    for name, build, batch in ((ML_PATH, lambda: ml_parts(dev), 1),
                               (MLPP_PATH, lambda: mlpp_parts(dev), MLPP_BATCH)):
        t0 = time.perf_counter()
        parts = build()
        losses, times, peak, launches = sp_train(dev, parts, preds[name], 4, name,
                                                 batch=batch)
        print(f"multilevel slice: {name} bs{batch} bf16 levels 2x2 -> 1x2: "
              f"{batch * len(times) / sum(times):.3f} img/s "
              f"({1e3 * sum(times) / len(times):.1f} ms/step), peak {peak / 2**30:.2f} GiB, "
              f"K2 {preds[name].counts['halo_conv2d_stats']} K1 "
              f"{preds[name].counts['halo_conv2d']} launches a step, first-step loss "
              f"{losses[0]:.6f} ({time.perf_counter() - t0:.1f} s)", flush=True)
        out[name] = launches
        del parts
        torch.cuda.empty_cache()
    return out


def phase_ml_checks():
    """Multi-level SP (square 4,2 and the degenerate vertical 2,1) and
    multi-level SP x PP at reduced depth (``utils/devcheck.engine_run``,
    two steps): against the single-card step over the same micro-batches at
    ``tests/test_multilevel.py``'s bounds (losses rtol 1e-4, parameters and
    running statistics rtol 2e-3 / atol 1e-5) — ResNet-11 v2 32² in fp32
    with the kernels on, AmoebaNet-D(3, 32) 128² in float64 with them off;
    and in float64 the card against the CPU: losses rtol 1e-10, updates
    within 1e-8 (norm-relative).  In fp32 the single card takes the library
    conv from the first degenerate level's cells on (``kernel_cells``), as
    the chain does there, and the kernels elsewhere.  Printed, not
    asserted: the single card's own gap between the kernels on and off over
    the same two steps, and the square chain against a single card that
    takes the kernels on exactly the chain's cells (its tail takes none).
    Two fp32 steps of this BatchNorm'd ResNet fall in one of two outcomes
    6e-5 apart on the stem's weights, by summation order (PERF.md §6), so
    those two readings show the size of what the bound cannot tell from
    rounding."""
    import torch

    from mpi4dl_tpu_torch.utils.devcheck import engine_run, norm_rel

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    for arch, dtype in (("resnet", torch.float32), ("amoebanet", torch.float64)):
        f64 = dtype == torch.float64
        kw = dict(arch=arch, dtype=dtype, pallas=not f64)
        stops = [1, 3]
        if f64:
            kw.update(image=128)
            stops = [3, 6]
        init = engine_run("cpu", "single", steps=0, **kw)[1]
        keys = [k for k in init if init[k].is_floating_point()]

        def gap(a, b, note):
            d = {k: float((a[k] - b[k]).abs().max()) for k in keys}
            worst = max(d, key=d.get)
            stem = next(k for k in keys if k.endswith("kernel"))
            over = int(((a[stem] - b[stem]).abs() > 1e-5).sum())
            print(f"multilevel checks: {arch} {dtype} {note}, two steps: max |d| "
                  f"{d[worst]:.2e} ({worst}); stem {stem}: max |d| {d[stem]:.2e}, {over} "
                  f"of {a[stem].numel()} above 1e-5", flush=True)

        if not f64:
            gap(engine_run(dev, "single", micro=4, **kw)[1],
                engine_run(dev, "single", micro=4, **dict(kw, pallas=False))[1],
                "one card, kernels on vs off")
        for engine, method, counts, micro, extra in (
                ("sp", "square", [4, 2], 4, {}), ("sp", "vertical", [2, 1], 4, {}),
                ("sp_pp", "square", [4, 2], 2, dict(parts=2))):
            lv = (method, counts, stops)
            kcells = next((stops[i - 1] for i, c in enumerate(counts) if c == 1), None)
            want_losses, want = engine_run(dev, "single", micro=micro, kernel_cells=kcells,
                                           **kw)
            losses, got = engine_run(dev, engine, micro=micro, levels=lv, **extra, **kw)
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
            dmax = max(float((got[k] - want[k]).abs().max()) for k in keys)
            print(f"multilevel checks: {arch} {dtype} {engine} {method} {counts} stops "
                  f"{stops} kernels {'on' if kw['pallas'] else 'off'} (one card: on "
                  f"{'every cell' if kcells is None else f'cells [0, {kcells})'}): losses "
                  f"{losses} vs one card {want_losses} (rel {rel:.2e}), parameters max |d| "
                  f"{dmax:.2e}", flush=True)
            assert rel <= 1e-4, (arch, engine, counts, rel)
            for k in keys:
                torch.testing.assert_close(got[k], want[k], rtol=2e-3, atol=1e-5)
            if not f64 and engine == "sp" and kcells is None:
                gap(got, engine_run(dev, "single", micro=micro, kernel_cells=stops[-1],
                                    **kw)[1],
                    f"{engine} {method} {counts} vs one card on cells [0, {stops[-1]})")
            if not f64:
                continue
            cpu_losses, cpu = engine_run("cpu", engine, micro=micro, levels=lv, **extra, **kw)
            crel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
            upd = norm_rel([got[k] - init[k] for k in keys], [cpu[k] - init[k] for k in keys])
            print(f"multilevel checks: card vs cpu {engine} {method} {counts}: losses rel "
                  f"{crel:.2e}, update rel {upd:.2e}", flush=True)
            assert crel <= 1e-10 and upd <= 1e-8, (engine, counts, crel, upd)
    print(f"multilevel checks: {time.perf_counter() - t0:.1f} s", flush=True)


def _peak_step(build, x, y, steps=2):
    """(median step ms of ``steps`` after a warm-up, peak GiB) of the step
    that ``build()`` returns, from a reset of the peak."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    parts = build()
    ms = step_ms(parts, x, y, steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del parts
    torch.cuda.empty_cache()
    return ms, peak


def _env_ab(build, x, y, name, values, steps=2):
    """One step built once, timed (median ms of ``steps`` after a warm-up)
    and its peak GiB read under each value of the environment hatch
    ``name`` in turn (the hatches are read at dispatch): [(value, ms,
    peak)]."""
    import torch

    torch.cuda.empty_cache()
    parts = build()
    out = []
    for v in values:
        os.environ[name] = v
        torch.cuda.reset_peak_memory_stats()
        ms = step_ms(parts, x, y, steps)
        out.append((v, ms, torch.cuda.max_memory_allocated() / 2**30))
    del os.environ[name]
    del parts
    torch.cuda.empty_cache()
    return out


def conv_calls(build, image, keep):
    """The convs of one forward of ``build(meta)`` at ``image``² bs1 (meta
    device, the kernels' knob carrier as in the timed steps) that ``keep(x
    shape, kh, kw, sh, sw, groups)`` admits: (x shape, kernel shape,
    strides, padding) -> calls."""
    import collections

    import torch

    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
    from mpi4dl_tpu_torch.layers import Conv2d
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    model = build(torch.device("meta"))
    seen = collections.Counter()

    def hook(mod, args):
        kh, kw, sh, sw, ph, pw = mod._geometry()
        xs = tuple(args[0].shape)
        if keep(xs, kh, kw, sh, sw, mod.feature_group_count):
            seen[(xs, tuple(mod.kernel.shape), (sh, sw), ((ph, ph), (pw, pw)))] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, Conv2d)]
    with torch.no_grad(), hc.count_dispatches():
        model(torch.zeros((1, image, image, 3), device="meta"),
              ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True)))
    for h in hooks:
        h.remove()
    return seen


def conv_route_ab(label, calls, routes):
    """Each conv of ``calls`` (bf16, seeded) through each of ``routes``
    ({name: fn(x, w, strides, padding)}): the device ms of its backward
    (``backward``) or of its forward and backward (``both``), CUDA events
    over 10 calls, median of 5, and the memory that one forward and
    backward allocates above its inputs; per conv and summed over a step's
    calls."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    tot = {name: [0.0, 0.0] for name in routes}
    for (xs, ws, strides, pad), n in sorted(calls.items()):
        xt = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
        wt = (torch.randn(ws, generator=gen, device=dev) / math.sqrt(ws[0] * ws[1] * ws[2])
              ).to(torch.bfloat16).requires_grad_(True)
        ct = None
        row = {}
        for name, (fn, what) in routes.items():
            if ct is None:
                ct = torch.randn(fn(xt, wt, strides, pad).shape, generator=gen,
                                 device=dev).to(torch.bfloat16)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.autograd.grad(fn(xt, wt, strides, pad), (xt, wt), ct)
            extra = (torch.cuda.max_memory_allocated() - base) / 2**20
            if what == "backward":
                yt = fn(xt, wt, strides, pad)
                ms = time_ms(lambda: torch.autograd.grad(yt, (xt, wt), ct,
                                                         retain_graph=True), 10)
                del yt
            else:
                ms = time_ms(lambda: torch.autograd.grad(fn(xt, wt, strides, pad), (xt, wt),
                                                         ct), 10)
            row[name] = (ms, extra)
            tot[name][0] += n * ms
            tot[name][1] = max(tot[name][1], extra)
        print(f"memory levers: {label} x{xs} w{ws} s{strides} x{n} a step: "
              + ", ".join(f"{name} {ms:.4f} ms {extra:.1f} MiB"
                          for name, (ms, extra) in row.items()), flush=True)
        del xt, wt, ct
    print(f"memory levers: {label}, a step's calls: "
          + ", ".join(f"{name} {t:.3f} ms (largest {m:.1f} MiB)"
                      for name, (t, m) in tot.items()), flush=True)


def phase_memory_levers():
    """The memory levers, each A/B inside this call (median step ms of 2
    after a warm-up, peak): AmoebaNet-D(``ENGINE_DEPTH``, 416) 2048² bs1 on
    one card, bf16, kernels on, remat none / cell / sqrt / fine; the SP
    grid at that model with ``MPI4DL_STRIPE_BWD`` 0, 1, 0, 1 (one built step, the
    hatch set between measurements).  The JAX package's two TPU conv
    routes, which no layer of the port dispatches, each against the
    library conv on the card (:func:`conv_route_ab`): ``hstripe_conv2d``
    forward and backward at every conv of ResNet-110 v2 2048² that JAX's
    gate would stripe (stride 1, ungrouped, at most 64 channels over at
    least 2^20 pixels, ``layers.py:182-200``), and the phase dx's backward
    at every strided ungrouped conv of AmoebaNet-D(``ENGINE_DEPTH``, 416)
    1024².  Recorded, not asserted."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
    from mpi4dl_tpu_torch.ops import conv_phase as cp
    from mpi4dl_tpu_torch.ops import hstripe_conv as hs
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")

    def single(image, remat):
        def build():
            model = amoebanetd((1, image, image, 3), num_classes=1000,
                               num_layers=ENGINE_DEPTH, num_filters=416, device=dev, seed=0)
            opt = Optimizer("sgd", lr=1e-3)
            return model, make_train_step(model, opt, compute_dtype=torch.bfloat16,
                                          remat=remat, pallas_conv=True), \
                TrainState.create(model, opt)
        return build

    x, y = sp_batch(dev, 2048)
    for remat in (False, "cell", "sqrt", "fine"):
        ms, peak = _peak_step(single(2048, remat), x, y)
        print(f"memory levers: AmoebaNet-D({ENGINE_DEPTH},416) 2048^2 bs1 one card remat "
              f"{remat or 'none'}: "
              f"{ms:.1f} ms a step, peak {peak:.2f} GiB", flush=True)
    for mode, ms, peak in _env_ab(lambda: sp_parts(dev, "amoebanet", 2048, ENGINE_DEPTH), x, y,
                                  "MPI4DL_STRIPE_BWD", ("0", "1", "0", "1")):
        print(f"memory levers: SP AmoebaNet-D({ENGINE_DEPTH},416) 2048^2 2x2 grid "
              f"MPI4DL_STRIPE_BWD={mode}: "
              f"{ms:.1f} ms a step, peak {peak:.2f} GiB", flush=True)
    del x, y
    torch.cuda.empty_cache()
    striped = conv_calls(
        lambda meta: get_resnet_v2((1, 2048, 2048, 3), 110, 1000, device=meta),
        2048, lambda xs, kh, kw, sh, sw, g: (sh, sw) == (1, 1) and g == 1 and xs[3] <= 64
        and xs[1] * xs[2] >= 1 << 20)
    conv_route_ab("ResNet-110 v2 2048^2 gated convs, forward + backward", striped, {
        "hstripe_conv2d": (lambda x, w, s, p: hs.hstripe_conv2d(x, w, *p), "both"),
        "library": (cp._conv_nhwc, "both")})
    strided = conv_calls(
        lambda meta: amoebanetd((1, 1024, 1024, 3), num_classes=1000,
                                num_layers=ENGINE_DEPTH, num_filters=416, device=meta),
        1024, lambda xs, kh, kw, sh, sw, g: (sh, sw) != (1, 1) and g == 1)
    conv_route_ab(f"AmoebaNet-D({ENGINE_DEPTH},416) 1024^2 strided convs, backward", strided, {
        "phase dx": (cp.conv2d_strided_t, "backward"),
        "library": (cp._conv_nhwc, "backward")})
    print(f"memory levers: {time.perf_counter() - t0:.1f} s", flush=True)


# The data + checkpoint slice: the lp runner at full width (phase 3's model
# and settings) on an image folder written here, with checkpoints.
DATA_FLAGS = ["--split-size", "1", "--model", "amoebanet", "--image-size", "1024",
              "--num-layers", "18", "--num-filters", "416", "--num-classes", "1000",
              "--batch-size", "1", "--precision", "bf_16", "--pallas-conv", "--no-remat",
              "--lr", "0.001", "--steps-per-epoch", "4"]
DATA_IMAGE, DATA_CLASSES, DATA_PER_CLASS = 1024, 2, 4


def write_image_folder(root: str, size: int = DATA_IMAGE, seed: int = 0) -> None:
    """``DATA_CLASSES`` classes of ``DATA_PER_CLASS`` random ``size``² PPM
    images (also the four-card runs' data: ``python -c "import chip_smoke;
    chip_smoke.write_image_folder('imgs', 2048)"``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for c in range(DATA_CLASSES):
        os.makedirs(os.path.join(root, f"class{c}"))
        for i in range(DATA_PER_CLASS):
            img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
            with open(os.path.join(root, f"class{c}", f"{i}.ppm"), "wb") as f:
                f.write(f"P6\n{size} {size}\n255\n".encode() + img.tobytes())


class _Tee:
    """Standard output, also kept in a buffer (to read a runner's notes)."""

    def __init__(self, out):
        import io

        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def runner(argv, on_restore=None):
    """The lp runner in this process; returns (summary, what it printed)."""
    import contextlib

    from mpi4dl_tpu_torch.benchmarks.common import run

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = run("lp", "amoebanet", argv, on_restore=on_restore)
    return out, tee.buf.getvalue()


def phase_data_checkpoint():
    """The data + checkpoint slice (module docstring, phase 20)."""
    import tempfile

    import torch

    from mpi4dl_tpu_torch import checkpoint as ck
    from mpi4dl_tpu_torch import data_native
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    assert data_native.available(), "the native image loader did not build"
    print(f"data: native loader {data_native.library_path().name}, codecs "
          f"{data_native.codecs()}", flush=True)
    decoded = {"native": 0}
    real_load = data_native.load_image

    def counting_load(path, size):
        out = real_load(path, size)
        decoded["native"] += out is not None
        return out

    data_native.load_image = counting_load
    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        folder = os.path.join(work, "images")
        t0 = time.perf_counter()
        write_image_folder(folder)
        print(f"data: wrote {DATA_CLASSES * DATA_PER_CLASS} {DATA_IMAGE}^2 PPM images in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        from mpi4dl_tpu_torch.data import ImageFolderDataset

        ds = ImageFolderDataset(folder, DATA_IMAGE)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.batch(i, 1)
        print(f"data: decode {1e3 * (time.perf_counter() - t0) / len(ds):.2f} ms an image "
              f"(host clock, {len(ds)} images, one thread)", flush=True)
        app1 = DATA_FLAGS + ["--app", "1", "--datapath", folder]
        ckdir = os.path.join(work, "ckpt")

        # The main path of this slice: counts at 0 just before, read after.
        reset_all_counts()
        decoded["native"] = 0
        first, _ = runner(app1 + ["--num-workers", "2", "--checkpoint-dir", ckdir])
        launches = dict(hc.LAUNCHES)
        steps = len(first["losses"])
        # Every image the runner fed (steps x batch 1) came through the native loader.
        assert decoded["native"] == steps, (decoded, steps)
        print(f"data: app 1, 2 workers: K2 {launches['halo_conv2d_stats']} K1 "
              f"{launches['halo_conv2d']} launches over {steps} steps", flush=True)
        assert steps == 4 and all(math.isfinite(v) for v in first["losses"]), first["losses"]
        assert launches["halo_conv2d_stats"] == 80 * steps, launches
        assert launches["halo_conv2d"] == 80 * steps, launches
        for sid in (0, 4):
            path = os.path.join(ckdir, f"ckpt_{sid}")
            manifest, _ = ck.cheap_validate(path)
            print(f"data: ckpt_{sid} valid: {len(manifest['leaves'])} leaves, "
                  f"{sum(sh['nbytes'] for l in manifest['leaves'] for sh in l['shards'])} "
                  "bytes", flush=True)

        checked = {}

        def on_restore(state, mgr):
            saved, _ = ck.load_arrays(mgr.last_restore.path)
            leaves = ck.state_leaves(state)
            assert len(leaves) == len(saved)
            for i, leaf in enumerate(leaves):
                assert torch.equal(leaf.full(), saved[f"leaf_{i}"]), f"leaf {i} differs"
            checked["leaves"] = len(leaves)

        resumed, printed = runner(app1 + ["--num-workers", "2", "--checkpoint-dir", ckdir,
                                          "--num-epochs", "2"], on_restore)
        assert "resuming from checkpoint step 4" in printed
        assert checked["leaves"] > 0 and resumed["start_step"] == 4
        whole, _ = runner(app1 + ["--num-workers", "2", "--num-epochs", "2"])
        got, want = resumed["losses"], whole["losses"][4:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"data: resumed at step 4, {checked['leaves']} leaves bitwise equal to "
              f"ckpt_4; losses 4-7 {got} vs uninterrupted {want}: "
              f"{'bitwise equal' if got == want else f'max rel {rel:.3e}'}", flush=True)
        assert len(got) == 4 and rel <= 1e-5, (got, want)

        decoded["native"] = 0
        w0, _ = runner(app1 + ["--num-workers", "0", "--num-epochs", "2"])
        assert decoded["native"] == len(w0["losses"]), decoded
        app3, _ = runner(DATA_FLAGS + ["--num-epochs", "2"])
        saves = first["checkpoint"]["saves"] + resumed["checkpoint"]["saves"]
        # The step meter starts with the batch in hand; the loop's wait for
        # each batch (fetch ms) is the input pipeline's cost, fed img/s both.
        for label, r in (("app 1 workers 0", w0), ("app 1 workers 2", whole),
                         ("app 3 workers 0", app3)):
            print(f"data: {label}: step img/s {r['images_per_sec']:.3f}, fed img/s "
                  f"{r['fed_images_per_sec']:.3f}, wait for the batch (ms, steps 1-) "
                  f"{[round(v, 2) for v in r['fetch_ms'][1:]]}", flush=True)
        print("data: checkpoint saves " + ", ".join(
            f"step {s['step']} waited {s['stall_ms']:.0f} ms, durable after "
            f"{s['durable_ms']:.0f} ms ({s['gather_ms']:.0f} device-to-host, "
            f"{s['write_ms']:.0f} CRC32 + write + fsync) {s['bytes']} bytes" for s in saves)
            + f"; restore {resumed['checkpoint']['restore_ms']:.0f} ms", flush=True)
        return launches, whole["losses"]
    finally:
        data_native.load_image = real_load
        shutil.rmtree(work, ignore_errors=True)


def _tool(module, argv):
    """Run one halo tool's ``main`` here; returns (rc, printed lines)."""
    import contextlib
    import importlib

    tee = _Tee(sys.stdout)
    mod = importlib.import_module(f"mpi4dl_tpu_torch.benchmarks.communication.halo.{module}")
    with contextlib.redirect_stdout(tee):
        rc = mod.main(argv)
    return rc, tee.buf.getvalue().strip().splitlines()


def phase_halo_tools():
    """The three halo tools at the JAX tools' documented shapes (phase 21)."""
    rc, lines = _tool("benchmark_pallas_conv", [
        "--height", "512", "--width", "512", "--cin", "256", "--cout", "256",
        "--kernel", "3", "--dtype", "bf16"])
    assert rc == 0 and json.loads(lines[-1])["validation"] == "pass", lines[-1]
    rc, lines = _tool("benchmark_d2_step", ["--tile", "512", "--channels", "208",
                                            "--fused", "3"])
    out = json.loads(lines[-1])
    assert rc == 0 and out["validation"] == "pass", lines[-1]
    assert out["launches_per_step"] == {"halo_conv2d": 3, "halo_conv2d_stats": 3}, out
    rc, lines = _tool("benchmark_sp_halo_exchange", [
        "--image-size", "1024", "--num-spatial-parts", "4", "--slice-method", "vertical",
        "--halo-len", "3", "--with-compute"])
    assert rc == 0 and json.loads(lines[-1])["validation"] == "pass", lines[-1]
    assert sum("PASSED" in line for line in lines) == 2, lines


def _runs_main_path(out, steps_executed) -> None:
    """80 K2 and 80 K1 launches a step the run executed (a rolled-back step
    executes too), as the single-card slice."""
    got = out["launches"]
    assert got["halo_conv2d_stats"] == 80 * steps_executed, (got, steps_executed)
    assert got["halo_conv2d"] == 80 * steps_executed, (got, steps_executed)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _with_fault(spec, fn, *a, **k):
    """``fn`` under ``MPI4DL_FAULT=spec`` (and nothing else changed)."""
    os.environ["MPI4DL_FAULT"] = spec
    try:
        return fn(*a, **k)
    finally:
        del os.environ["MPI4DL_FAULT"]


def phase_resilience(whole_losses):
    """The supervised loop on the main path (module docstring, phase 22)."""
    import contextlib
    import tempfile

    from mpi4dl_tpu_torch import checkpoint as ck
    from mpi4dl_tpu_torch.obs import read_runlog

    work = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        folder = os.path.join(work, "images")
        write_image_folder(folder)
        app1 = DATA_FLAGS + ["--app", "1", "--datapath", folder, "--num-workers", "2"]
        runs = {}

        # (a) Background saves at the default budget: the baseline before
        # step 0 is written while steps 0-11 run; then the same state (the
        # final checkpoint, restored) saved synchronously.
        a_dir = os.path.join(work, "a")
        reset_all_counts()
        a, _ = runner(app1 + ["--steps-per-epoch", "12", "--checkpoint-dir", a_dir])
        runs["async"] = a["launches"]
        _runs_main_path(a, len(a["losses"]))
        assert len(a["losses"]) == 12 and all(math.isfinite(v) for v in a["losses"])
        for sv in a["checkpoint"]["saves"]:
            print(f"resilience: async save, 1 GiB budget, step {sv['step']}: the "
                  f"training thread waited {sv['stall_ms']:.1f} ms, durable after "
                  f"{sv['durable_ms']:.1f} ms (device-to-host {sv['gather_ms']:.1f} ms, "
                  f"CRC32 + write + fsync {sv['write_ms']:.1f} ms), peak pending "
                  f"{sv['peak_pending_bytes']} bytes of {sv['bytes']}", flush=True)
        pairs = list(zip(a["step_ms"], a["write_overlap"]))[1:]  # after the warm-up
        busy = [ms for ms, o in pairs if o]
        clear = [ms for ms, o in pairs if not o]
        print(f"resilience: steps 1-11 ms {[round(v, 1) for v in a['step_ms'][1:]]}, "
              f"overlapping a background write {a['write_overlap'][1:]}", flush=True)
        if busy and clear:
            print(f"resilience: steps overlapping a write: median "
                  f"{statistics.median(busy):.1f} ms ({len(busy)}), the others "
                  f"{statistics.median(clear):.1f} ms ({len(clear)}): "
                  f"{statistics.median(busy) / statistics.median(clear):.3f}x", flush=True)
        sync_dir = os.path.join(work, "sync")
        synced = {}

        def sync_save(state, mgr):
            twin = ck.CheckpointManager(sync_dir, fingerprint=mgr.fingerprint,
                                        identity=mgr.identity, layout=mgr.layout,
                                        layout_desc=mgr.layout_desc)
            t0 = time.perf_counter()
            twin.save(state, mgr.last_restore.step_id)
            synced.update(ms=(time.perf_counter() - t0) * 1e3, stats=twin.last_save_stats)

        again, _ = runner(app1 + ["--steps-per-epoch", "12", "--checkpoint-dir", a_dir],
                          sync_save)
        assert again["start_step"] == 12 and again["losses"] == []
        st = synced["stats"]
        print(f"resilience: sync save of the same state (step 12): the training thread "
              f"waited {synced['ms']:.1f} ms (device-to-host {st.gather_ms:.1f} ms, CRC32 "
              f"+ write + fsync {st.write_ms:.1f} ms)", flush=True)
        got = _manifest(os.path.join(a_dir, "ckpt_12"))["leaves"]
        want = _manifest(os.path.join(sync_dir, "ckpt_12"))["leaves"]
        assert [[sh["crc32"] for sh in l["shards"]] for l in got] == \
            [[sh["crc32"] for sh in l["shards"]] for l in want]
        assert got == want
        print(f"resilience: async and sync manifests equal: {len(got)} leaves, CRC32 "
              "of every shard", flush=True)

        # (b) sigterm@2 with a 2 GiB budget (the baseline save is then the
        # copy alone), and the resume against phase 20's uninterrupted run.
        b_dir = os.path.join(work, "b")
        b_flags = app1 + ["--num-epochs", "2", "--checkpoint-dir", b_dir]
        os.environ["MPI4DL_CKPT_HOST_BYTES"] = str(2 << 30)
        try:
            reset_all_counts()
            killed, _ = _with_fault("sigterm@2", runner, b_flags)
        finally:
            del os.environ["MPI4DL_CKPT_HOST_BYTES"]
        runs["sigterm"] = killed["launches"]
        _runs_main_path(killed, 3)
        assert killed["preempted"] and killed["final_step"] == 3, killed["final_step"]
        ck.cheap_validate(os.path.join(b_dir, "ckpt_3"))
        for sv in killed["checkpoint"]["saves"]:
            print(f"resilience: async save, 2 GiB budget, step {sv['step']}: waited "
                  f"{sv['stall_ms']:.1f} ms, durable after {sv['durable_ms']:.1f} ms "
                  f"(device-to-host {sv['gather_ms']:.1f} ms), peak pending "
                  f"{sv['peak_pending_bytes']} bytes", flush=True)
        resumed, printed = runner(b_flags)
        assert "resuming from checkpoint step 3" in printed and resumed["start_step"] == 3
        got, want = resumed["losses"], whole_losses[3:8]
        rel = max(abs(x - w) / abs(w) for x, w in zip(got, want))
        print(f"resilience: sigterm@2: preempted after step 2, ckpt_3 saved, exit 0; "
              f"resumed losses 3-7 {got} vs uninterrupted {want}: "
              f"{'bitwise equal' if got == want else f'max rel {rel:.3e}'}", flush=True)
        assert len(got) == 5 and rel <= 1e-5, (got, want)

        # (c) nan_batch@5: one rollback to ckpt_4, batch 5 skipped.
        c_dir, tele = os.path.join(work, "c"), os.path.join(work, "tele")
        reset_all_counts()
        c, _ = _with_fault("nan_batch@5", runner, app1 + [
            "--num-epochs", "2", "--checkpoint-dir", c_dir, "--telemetry-dir", tele])
        runs["nan_batch"] = c["launches"]
        _runs_main_path(c, len(c["losses"]) + c["anomalies"])
        recs = read_runlog(c["telemetry_path"])
        with open(c["telemetry_path"]) as f:
            nan_runlog = f.read()
        anomalies = [r for r in recs if r["kind"] == "anomaly"]
        recoveries = [r for r in recs if r["kind"] == "recovery"]
        print(f"resilience: nan_batch@5: anomalies {anomalies}, recoveries {recoveries}, "
              f"losses {c['losses']}", flush=True)
        assert c["anomalies"] == 1 and len(anomalies) == 1 and len(recoveries) == 1
        assert anomalies[0]["gstep"] == 5 and recoveries[0]["resumed_from"] == 4
        assert recoveries[0]["skipped_step"] == 5 and c["final_step"] == 8
        assert len(c["losses"]) == 7 and all(math.isfinite(v) for v in c["losses"])
        assert [r["gstep"] for r in recs if r["kind"] == "step"] == [0, 1, 2, 3, 4, 6, 7]

        # (d) A data stall past the watchdog's budget: one dump with the
        # card's memory lines.  No worker, so the fetch itself stalls.
        err = _Tee(sys.stderr)
        reset_all_counts()
        with contextlib.redirect_stderr(err):
            d, _ = _with_fault("stall_data@2:8", runner, DATA_FLAGS + [
                "--app", "1", "--datapath", folder, "--num-workers", "0",
                "--watchdog-secs", "5"])
        runs["watchdog"] = d["launches"]
        _runs_main_path(d, 4)
        text = err.buf.getvalue()
        dumps = text.count("watchdog: step 2 exceeded the 5.0s")
        mem = [line for line in text.splitlines() if line.startswith("memory: device cuda")]
        print(f"resilience: watchdog: {dumps} dump(s) at step 2; {mem}", flush=True)
        assert dumps == 1 and text.count("watchdog:") == 1 and len(mem) == 1, text[-3000:]
        assert d["final_step"] == 4 and all(math.isfinite(v) for v in d["losses"])
        return runs, {"nan_runlog": nan_runlog, "warmup_ms": d["step_ms"][0]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The quantization phase: the per-class policy of --quant (quant/) on the
# SP AmoebaNet 2048² step and the SP x PP 1024² step, each against its
# exact run from the same seed.
QUANT_SP = "int8"
QUANT_SPPP = "junction=int8,handoff=int8,grad=int8"
QUANT_GAP = 0.05  # tests/test_quant.py:494-514: |quantized - exact| <= 5%
# The first step's gradients, quantized against exact, over all parameters
# and over the first cell's: relative L2 of the difference above a floor
# (the policy changed something; its encode skipped reads 0) and below a
# reversed gradient's 2; norm ratio about 1 (a dropped cotangent reads 0).
# Sound readings on the H100: relative L2 0.072 (SP), 1.39 (SP x PP, as
# the exact step's own under QUANT_PROBE), norm ratio 0.995-1.000.
QUANT_GRAD = {"rel": (1e-3, 1.6), "ratio": (0.8, 1.25)}
QUANT_PROBE = 2.0 ** -8  # relative input perturbation of the exact step
QUANT_BYTES = 0.55  # wire / raw bytes of each int8 class that moved bytes


def quant_codec_check(name, x, iters):
    """Encode + decode of ``x`` on the card in every mode: payload and
    scales bitwise those of the CPU, and device ms of the round trip (a
    CUDA graph of ``iters`` calls, the median of 5 replays) beside a plain
    ``copy_`` of ``x``."""
    import torch

    from mpi4dl_tpu_torch.quant import collectives as qc
    from mpi4dl_tpu_torch.quant.kernels import MODES, roundtrip

    cpu = x.cpu()
    out = torch.empty_like(x)
    copy_ms = graph_ms(lambda: out.copy_(x), iters)
    for mode in MODES:
        q, s = qc.encode(x, mode, 256)
        qh, sh = qc.encode(cpu, mode, 256)
        assert q.is_cuda and torch.equal(q.cpu(), qh), f"{name} {mode}: payload differs"
        assert torch.equal(s.cpu().view(torch.int32), sh.view(torch.int32)), \
            f"{name} {mode}: scales differ"
        y = qc.decode(q, s, mode, 256, x.shape[-1], x.dtype)
        yh = qc.decode(qh, sh, mode, 256, x.shape[-1], x.dtype)
        assert torch.equal(y.cpu().view(torch.uint8), yh.contiguous().view(torch.uint8)), \
            f"{name} {mode}: decode differs"
        del q, s, y, qh, sh, yh
        ms = graph_ms(lambda: roundtrip(x, mode, 256), iters)
        wire = qc.encoded_nbytes(tuple(x.shape), mode, 256)
        print(f"quant: {name} {tuple(x.shape)} {x.dtype} {mode}: encode + decode "
              f"bitwise the CPU's; {ms:.4f} ms on the card (copy_ {copy_ms:.4f} ms), "
              f"wire {wire} bytes vs raw {x.numel() * x.element_size()}", flush=True)
        torch.cuda.empty_cache()


def quant_ab(dev, label, build, pred, spec, batch):
    """``build(quant, opt)``'s step trained 4 steps with ``spec`` and 4 with
    the policy off, from one seed: launches held to the dry run each step,
    losses finite, the quantized run's last below its first and each
    within 5% of the exact one's; the first step's gradients held to the
    exact run's (``QUANT_GRAD``), over all parameters and over the first
    cell's, which sit behind every quantized wire of the backward; each
    class of ``spec`` that moved bytes at most ``QUANT_BYTES`` of its raw
    bytes.  Beside them, the exact run again on an input moved by
    ``QUANT_PROBE`` of itself: its loss gap and how far its first
    gradients move.  Prints step ms, peak memory and the bytes per
    class."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.quant_sensitivity import (
        FirstGrads, first_cell_positions, grad_gap,
    )
    from mpi4dl_tpu_torch.quant import QuantPolicy
    from mpi4dl_tpu_torch.quant import collectives as qc

    runs, grads, ratios = {}, {}, {}
    for name in (spec, None):
        opt = FirstGrads("sgd", lr=1e-3)
        parts = build(name, opt)
        qc.reset_wire_bytes()
        losses, times, peak, _ = sp_train(dev, parts, pred, 4, f"{label} quant {name or 'off'}",
                                          batch=batch)
        runs[name] = losses
        grads[name] = [g for _, g in opt.grads]
        cell0 = first_cell_positions(parts[0], opt)
        by = {c: f"{qc.WIRE_BYTES[c]}/{qc.RAW_BYTES[c]}" for c in qc.CLASSES}
        if name:
            ratios = {c: qc.WIRE_BYTES[c] / qc.RAW_BYTES[c] for c in qc.CLASSES
                      if QuantPolicy.parse(name).mode(c) and qc.RAW_BYTES[c]}
        print(f"quant: {label} --quant {name or 'off'}: {1e3 * sum(times) / len(times):.1f} "
              f"ms/step over {len(times)} steps, peak {peak / 2**30:.2f} GiB, losses "
              f"{[round(v, 6) for v in losses]}, wire/raw bytes over 4 steps {by}",
              flush=True)
        del parts, opt
        torch.cuda.empty_cache()
    opt = FirstGrads("sgd", lr=1e-3)
    model, step, state = build(None, opt)
    x, y = sp_batch(dev, model.in_shape[1], batch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = x * (1 + QUANT_PROBE * torch.randn(x.shape, generator=gen, device=dev))
    probe_losses = [float(step(state, x, y)[1]["loss"]) for _ in range(4)]
    probe = [g for _, g in opt.grads]
    del model, step, state, opt
    torch.cuda.empty_cache()
    q, exact = grads[spec], grads[None]
    got = {"all": grad_gap(q, exact), "cell0": grad_gap(q, exact, cell0)}
    moved = {"all": grad_gap(probe, exact), "cell0": grad_gap(probe, exact, cell0)}
    del grads, probe, q, exact
    torch.cuda.empty_cache()
    gaps = [abs(a - b) / abs(b) for a, b in zip(runs[spec], runs[None])]
    probe_gap = max(abs(a - b) / abs(b) for a, b in zip(probe_losses, runs[None]))
    print(f"quant: {label}: largest relative loss gap {max(gaps):.5f} (gate {QUANT_GAP}); "
          f"wire / raw bytes {({c: round(v, 4) for c, v in ratios.items()})} "
          f"(gate {QUANT_BYTES}); "
          f"first-step gradient against the exact run's: relative L2 all "
          f"{got['all'][0]:.4e}, first cell {got['cell0'][0]:.4e}; norm ratio all "
          f"{got['all'][1]:.4f}, first cell {got['cell0'][1]:.4f} (gate {QUANT_GRAD}); "
          f"the exact step, input moved by {QUANT_PROBE:.4g}: losses "
          f"{[round(v, 6) for v in probe_losses]}, gap {probe_gap:.5f}, relative L2 all "
          f"{moved['all'][0]:.4e}, first cell {moved['cell0'][0]:.4e}; norm ratio all "
          f"{moved['all'][1]:.4f}, first cell {moved['cell0'][1]:.4f}", flush=True)
    assert max(gaps) <= QUANT_GAP, f"{label}: loss gaps {gaps}"
    assert runs[spec][-1] < runs[spec][0], f"{label}: quantized run did not descend"
    assert ratios and max(ratios.values()) <= QUANT_BYTES, f"{label}: bytes {ratios}"
    for part, (rel, ratio) in got.items():
        assert QUANT_GRAD["rel"][0] < rel <= QUANT_GRAD["rel"][1], (label, part, rel)
        assert QUANT_GRAD["ratio"][0] <= ratio <= QUANT_GRAD["ratio"][1], (label, part, ratio)


def phase_quant(preds):
    """Quantized collectives (module docstring, phase 23)."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.spatial import cell_output_shapes

    dev = torch.device("cuda")
    meta = amoebanetd((1, 2048, 2048, 3), num_classes=1000, num_layers=18,
                      num_filters=416, device="meta", seed=0)
    su = len(meta.cells) - 1
    shapes = cell_output_shapes(meta, (1, 2048, 2048, 3))[su - 1]
    shapes = shapes if isinstance(shapes[0], (tuple, list)) else (shapes,)
    junction = max(shapes, key=lambda sh: math.prod(sh))
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    x = torch.randn(junction, generator=gen, device=dev).to(torch.bfloat16)
    quant_codec_check("SP AmoebaNet 2048^2 junction activation", x, 20)
    n = sum(p.numel() for p in meta.parameters())
    del x, meta
    g = torch.randn((n,), generator=gen, device=dev) * 1e-3
    quant_codec_check("AmoebaNet-D(18, 416) fp32 gradient", g, 10)
    del g
    torch.cuda.empty_cache()
    quant_ab(dev, "amoebanet_2048_sp_d2",
             lambda q, opt: sp_parts(dev, "amoebanet", 2048, 18, quant=q, opt=opt),
             preds["amoebanet_2048_sp_d2"], QUANT_SP, 1)
    quant_ab(dev, "amoebanet_1024_sp_pp_grid",
             lambda q, opt: sppp_parts(dev, "sp_pp", q, opt),
             preds["amoebanet_1024_sp_pp_grid"], QUANT_SPPP, SPPP_BATCH)


# The telemetry phase: the lp runner at phase 20's model with
# --telemetry-dir, its cost record against the meta-device count, and the
# port's obs CLI on its RunLogs.
TELEMETRY_STEPS = 6  # 1 warm-up (the counted step) and 5 measured


def runner_parts(dev):
    """``(None, step, state)`` of the ``lp`` runner at ``DATA_FLAGS`` on
    ``dev``, built as the runner builds it."""
    from mpi4dl_tpu_torch.benchmarks.common import _build
    from mpi4dl_tpu_torch.config import config_from_args, get_parser

    cfg = config_from_args(get_parser().parse_known_args(DATA_FLAGS)[0])
    step, state, _, _ = _build(cfg, "lp", dev, None, print)
    return None, step, state


def runner_dry_cost():
    """The dry run of the ``lp`` runner's step at ``DATA_FLAGS``, counted
    through the plain versions (``obs.costs.counting``: ``.flops`` and
    ``.bytes``, the aten ops' bytes, of the step; the build is not
    counted)."""
    import torch

    from mpi4dl_tpu_torch.obs.costs import counting

    flag = DATA_FLAGS.index
    image = int(DATA_FLAGS[flag("--image-size") + 1])
    built = runner_parts(torch.device("meta"))
    with counting() as cost:
        seen = dry_run(lambda dev: built,
                       (int(DATA_FLAGS[flag("--batch-size") + 1]), image, image, 3))
    assert cost["error"] is None, cost["error"]
    seen.flops, seen.bytes = cost["flops"], cost["bytes_accessed"]
    return seen


def _obs_cli(argv):
    """``python -m mpi4dl_tpu_torch.obs <argv>`` in this process: (exit
    code, standard output)."""
    import contextlib
    import io

    from mpi4dl_tpu_torch.obs.__main__ import main as obs_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(argv)
    print(buf.getvalue(), end="", flush=True)
    return rc, buf.getvalue()


def phase_telemetry(tot, pred, resilience_info):
    """Run telemetry (module docstring, phase 24)."""
    import tempfile

    import torch

    from mpi4dl_tpu_torch.obs import read_runlog
    from mpi4dl_tpu_torch.obs.costs import mfu
    from mpi4dl_tpu_torch.obs.report import _COMPARE_METRICS
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    card = card_line()
    work = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        tele = os.path.join(work, "tele")
        flags = DATA_FLAGS + ["--steps-per-epoch", str(TELEMETRY_STEPS), "--telemetry-dir", tele]
        paths = []
        for run in range(2):
            reset_all_counts()
            out, _ = runner(flags)
            _runs_main_path(out, TELEMETRY_STEPS)
            assert len(out["losses"]) == TELEMETRY_STEPS
            assert all(math.isfinite(v) for v in out["losses"]), out["losses"]
            path = out["telemetry_path"]
            paths.append(path)
            recs = read_runlog(path)
            assert not [r for r in recs if r["kind"] == "cost_error"], recs
            cost = next(r for r in recs if r["kind"] == "cost")
            ms = sorted(r["ms"] for r in recs if r["kind"] == "step" and r["measured"])
            assert len(ms) == TELEMETRY_STEPS - 1, ms
            util = mfu(cost["flops"], statistics.median(ms), cost["peak_flops"])
            k1 = cost["kernels"]["halo_conv2d"]
            k2 = cost["kernels"]["halo_conv2d_stats"]
            print(f"telemetry: run {run}: flops/step {cost['flops']} bytes/step "
                  f"{cost['bytes_accessed']} arithmetic intensity "
                  f"{cost['arithmetic_intensity']:.3f} FLOP/byte, median step "
                  f"{statistics.median(ms):.1f} ms, MFU {util:.6f} (peak "
                  f"{cost['peak_flops']:.4g} FLOP/s, {cost['peak_source']}); K1 "
                  f"{k1['launches']} launches {k1['flops']} FLOP {k1['bytes']} B, K2 "
                  f"{k2['launches']} launches {k2['flops']} FLOP {k2['bytes']} B "
                  f"(+{k2['vector_flops']} elementwise); counted warm-up "
                  f"{out['step_ms'][0]:.1f} ms against an uncounted one "
                  f"{resilience_info['warmup_ms']:.1f} ms (phase 22); {card}", flush=True)
            # The card's count is the meta device's count of the same step
            # through the plain versions, exactly; the kernels' tallies are
            # phase 2's reckoning of the same 80 + 80 calls.
            assert cost["flops"] == pred.flops, (cost["flops"], pred.flops)
            assert k1["launches"] == k2["launches"] == 80, cost["kernels"]
            assert k1["flops"] == tot["K1"]["flops"], (k1, tot["K1"]["flops"])
            assert k2["flops"] == tot["K2"]["flops"], (k2, tot["K2"]["flops"])
            assert sum(hc.flops(c[2], c[3]) for c in pred.calls
                       if c[0] == "halo_conv2d") == k1["flops"]
            assert cost["peak_source"] == "table" and cost["peak_flops"] == 989e12, cost
            assert cost["device_count"] == 1 and cost["tick_scopes"] == [], cost
            assert util is not None and 0 < util <= 1, util
            assert os.path.exists(os.path.splitext(path)[0] + ".prom"), path
        print(f"telemetry: meta-device count of the same step through the plain "
              f"versions: {pred.flops} FLOP, {pred.bytes} B (aten ops only)",
              flush=True)

        rc, text = _obs_cli(["report"] + paths)
        assert rc == 0 and text.count("cost model: flops/step") == 2, text
        assert text.count("mfu estimate: 0.") == 2, text
        rc, text = _obs_cli(["report", "--compare"] + paths)
        assert rc in (0, 1) and all(name in text for name, _, _ in _COMPARE_METRICS), text
        rc, text = _obs_cli(["report", "--trend", tele])
        assert rc in (0, 1) and "series lp-amoebanet: 2 run(s)" in text, text
        rc, text = _obs_cli(["metrics", tele])
        assert rc == 0 and text.endswith("# EOF\n"), text
        for path in paths:
            job = os.path.splitext(os.path.basename(path))[0]
            ms = [r["ms"] for r in read_runlog(path) if r["kind"] == "step" and r["measured"]]
            want = {f'mpi4dl_steps_total{{job="{job}"}}': len(ms),
                    f'mpi4dl_step_latency_ms_count{{job="{job}"}}': len(ms),
                    f'mpi4dl_step_latency_ms_sum{{job="{job}"}}': sum(ms)}
            got = dict(line.rsplit(" ", 1) for line in text.splitlines()
                       if not line.startswith("#"))
            for key, value in want.items():
                assert math.isclose(float(got[key]), value, rel_tol=1e-12), (key, got)
        # K3 is off this path; its tallies at the slice's head shape (T 4096),
        # against the plain versions' count of the same calls.
        from mpi4dl_tpu_torch.obs.costs import counting, step_cost
        from mpi4dl_tpu_torch.ops import flash_attention as fa

        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        q, k, v = (torch.randn((8, 4096, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        do = torch.randn((8, 4096, 128), generator=gen, device="cuda")
        for name, fn, plain, args in (
                ("block_flash", fa.block_flash, fa.block_flash_plain,
                 (q, k, v, 0, 0, True, 128 ** -0.5)),
                ("block_flash_bwd", fa.block_flash_bwd, fa.block_flash_bwd_plain,
                 (q, k, v, fa.block_flash_plain(q, k, v, 0, 0, True)[1], do,
                  torch.zeros((8, 4096), device="cuda"), 0, 0, True, 128 ** -0.5))):
            with counting() as got:
                fn(*args)
            want = step_cost(plain, *args)["flops"]
            print(f"telemetry: {name} at (8, 4096, 128) bf16 causal: tally "
                  f"{got['kernels'][name]}, the step's {got['flops']} FLOP, the plain "
                  f"version's {want}", flush=True)
            assert got["kernels"][name]["launches"] == 1
            assert got["kernels"][name]["flops"] == got["flops"] == want, (got, want)
        del q, k, v, do

        nan_path = os.path.join(work, "nan_batch.jsonl")
        with open(nan_path, "w") as f:
            f.write(resilience_info["nan_runlog"])
        for path, spans in ((paths[0], TELEMETRY_STEPS), (nan_path, 7)):
            trace = os.path.join(work, "trace.json")
            rc, _ = _obs_cli(["trace", "--runlog", path, "--out", trace])
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            steps = [e for e in events if e["ph"] == "X" and e.get("cat") == "step"]
            instants = sorted(e["name"].split()[0] for e in events if e["ph"] == "i")
            print(f"telemetry: trace of {os.path.basename(path)}: {len(events)} events, "
                  f"{len(steps)} step spans, instants {instants}", flush=True)
            assert rc == 0 and len(steps) == spans, (rc, len(steps))
            if path == nan_path:
                assert instants == ["anomaly", "recovery"], instants
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# The supervisor slice: phase 20's model and flags, 2 epochs of 2 steps.
SUP_FLAGS = DATA_FLAGS[:-2] + ["--steps-per-epoch", "2", "--num-epochs", "2"]
SUP_OOM_IMAGE = 4096  # ~16x the 1024^2 step's activations: above the card
PROBE_TOLERANCE = 0.15  # the probe's estimate against the card's peak


def probe_start(image: int, extra=()):
    """Phase 25's memory probe of the ``lp`` runner's step at phase 20's
    flags and ``image``² (``benchmarks.mem_probe``: fake tensors, on the
    CPU, no CUDA context), started as a subprocess at the end of phase 3;
    ``(process, JSON path)``.  ``extra``: more probe flags (phase 26's
    ``--attribute``)."""
    import tempfile

    flags = list(DATA_FLAGS[:-2])
    flags[flags.index("--image-size") + 1] = str(image)
    fd, path = tempfile.mkstemp(prefix="chip_smoke_probe_", suffix=".json")
    os.close(fd)
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.mem_probe", "--family", "lp",
           "--schedule", "gpipe", "--out", path, *extra, *flags]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def probe_result(started) -> dict:
    """The probe's gpipe row (``peak_bytes``, per role) and its seconds."""
    proc, path = started
    _, err = proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    with open(path) as f:
        data = json.load(f)
    os.unlink(path)
    row = data["schedules"]["gpipe"]
    row["probe_s"] = data["probe_s"]
    return row


def _control_run(flags):
    """The unsupervised ``lp`` runner in a process of its own: its summary
    (the last line)."""
    proc = subprocess.run([sys.executable, "-m",
                           "mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_amoebanet_lp",
                           *flags], capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _supervise(out_dir, flags, env=None, budget_gb=None):
    """``python -m mpi4dl_tpu_torch.resilience supervise`` (the ``lp``
    family) as a subprocess: (exit code, its ``supervisor`` incident
    records, its summary record, the last leg's result, seconds)."""
    from mpi4dl_tpu_torch.obs import read_runlog

    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.resilience", "supervise", "--family", "lp",
           "--model", "amoebanet", "--out", out_dir]
    if budget_gb is not None:
        cmd += ["--budget-gb", str(budget_gb)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + ["--", *flags], capture_output=True, text=True,
                          env={**os.environ, **(env or {})},
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    log = next(f for f in sorted(os.listdir(out_dir)) if f.endswith(".jsonl"))
    recs = read_runlog(os.path.join(out_dir, log))
    legs = os.path.join(out_dir, "legs")
    attempts = sorted(os.listdir(legs))
    final = None
    path = os.path.join(legs, attempts[-1], "leg_result.json")
    if os.path.exists(path):
        with open(path) as f:
            final = json.load(f)
    return (proc.returncode, [r for r in recs if r["kind"] == "supervisor"],
            next(r for r in recs if r["kind"] == "supervisor_summary"), final, secs,
            attempts, proc)


def phase_supervisor(probes):
    """The memory probe and the elastic supervisor (module docstring,
    phase 25)."""
    import tempfile

    import torch

    from mpi4dl_tpu_torch.resilience import POLICIES

    card = card_line()
    torch.cuda.empty_cache()  # the legs below are processes of their own
    work = tempfile.mkdtemp(prefix="chip_smoke_supervisor_")
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            control_f = ex.submit(_control_run, SUP_FLAGS)
            clean_f = ex.submit(_supervise, os.path.join(work, "clean"), SUP_FLAGS)
            io_f = ex.submit(_supervise, os.path.join(work, "io"), SUP_FLAGS,
                             {"MPI4DL_FAULT": "io_error@2"})
            control, clean, io = control_f.result(), clean_f.result(), io_f.result()
        # (a) the probe against the card's peak of the same step.
        probe = probe_result(probes[0])
        peak = control["peak_bytes"]
        gap = (probe["peak_bytes"] - peak) / peak
        print(f"supervisor (a): probe {probe['peak_bytes']} B ({probe['peak_bytes'] / 2**30:.3f} "
              f"GiB, {probe['probe_s']:.1f} s on the CPU) against the card's "
              f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB): {100 * gap:+.2f}% "
              f"on {card}", flush=True)
        assert abs(gap) <= PROBE_TOLERANCE, gap
        # (b) supervised legs at full width against the unsupervised run.
        total = 4
        rc, incidents, summary, final, secs, attempts, proc = clean
        assert rc == 0 and not incidents and summary["ok"], proc.stderr[-3000:]
        assert summary["attempts"] == 1 and attempts == ["attempt1"], attempts
        assert final["losses"] == control["losses"], (final["losses"], control["losses"])
        assert final["launches"] == {"halo_conv2d": 80 * total,
                                     "halo_conv2d_stats": 80 * total}, final["launches"]
        print(f"supervisor (b) clean: 1 leg, 0 incidents in {secs:.1f} s; losses "
              f"{final['losses']} bitwise the unsupervised run's; 80 + 80 K1/K2 a step; "
              f"peak {final['peak_bytes']} B", flush=True)
        rc, incidents, summary, final, secs, attempts, proc = io
        assert rc == 0 and summary["ok"] and summary["attempts"] == 2, proc.stderr[-3000:]
        assert len(incidents) == 1, incidents
        inc = incidents[0]
        assert (inc["failure_class"], inc["policy"]) == ("transient_io", "retry"), inc
        assert inc["backoff_s"] > 0 and "config_delta" not in inc, inc
        assert summary["final_env"] == {}, summary
        assert final["start_step"] == 2 and final["loss"] == control["loss"], (final, control)
        assert final["launches"] == {"halo_conv2d": 160, "halo_conv2d_stats": 160}
        print(f"supervisor (b) io_error@2: {inc['failure_class']} -> {inc['policy']} "
              f"(backoff {inc['backoff_s']} s, {inc['evidence']['source']}), no config "
              f"delta, resumed at step {final['start_step']}; final loss {final['loss']} "
              f"bitwise the unsupervised run's; {secs:.1f} s", flush=True)
        # (c) one real allocator OOM: typed, no rung, no relaunch.
        probe_c = probe_result(probes[1])
        total_mem = torch.cuda.get_device_properties(0).total_memory
        assert probe_c["peak_bytes"] > total_mem, (probe_c, total_mem)
        flags = list(SUP_FLAGS)
        flags[flags.index("--image-size") + 1] = str(SUP_OOM_IMAGE)
        rc, incidents, summary, final, secs, attempts, proc = _supervise(
            os.path.join(work, "oom"), flags, budget_gb=total_mem / 2**30)
        assert rc == 1 and not summary["ok"] and attempts == ["attempt1"], proc.stderr[-3000:]
        assert len(incidents) == 1, incidents
        inc = incidents[0]
        ev = inc["evidence"]
        assert (inc["failure_class"], inc["policy"]) == ("oom_compile", "fail"), inc
        assert POLICIES["oom_compile"].action == "degrade"
        assert ev["source"] == "marker:oom_pattern" and ev["marker_phase"] == "compile", ev
        assert "CUDA out of memory" in ev["marker_error"], ev
        assert "ladder exhausted" in summary["reason"], summary
        print(f"supervisor (c) {SUP_OOM_IMAGE}^2: probe {probe_c['peak_bytes'] / 2**30:.1f} GiB "
              f"> the card's {total_mem / 2**30:.2f} GiB; the leg died in its first step "
              f"({ev['marker_error'][:60]}...), {inc['failure_class']} from the marker -> "
              f"degrade -> {inc['policy']}: {summary['reason']}; exit {rc} after "
              f"{len(attempts)} leg in {secs:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The instruments phase: phase 3's step profiled scope by scope, and phase
# 25's lp step attributed on fake tensors and on the card.
INSTRUMENT_STEPS = 2  # profiled steps of phase 26 (a)
COVERAGE = 0.9  # named scopes' share of the device time and of the peak bytes
_CELL = re.compile(r"(^|/)cell\d\d(/|$)")


def phase_instruments(tot, probe):
    """The step instruments (module docstring, phase 26)."""
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_instruments_")
    try:
        trace, tele = instruments_profile(tot, work)
        instruments_attribution(probe, work, trace, tele)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def instruments_profile(tot, work):
    """Phase 26 (a): phase 3's step, profiled; (trace path, telemetry dir)."""
    from mpi4dl_tpu_torch.benchmarks import profile_step as ps
    from mpi4dl_tpu_torch.obs import kineto

    card = card_line()
    out, tele = os.path.join(work, "profile"), os.path.join(work, "tele")
    assert ps.main(["--steps", str(INSTRUMENT_STEPS), "--out", out,
                    "--telemetry-dir", tele]) == 0
    with open(os.path.join(out, ps.SUMMARY_NAME)) as f:
        summary = json.load(f)
    tl, kern = summary["timeline"], summary["kernels"]
    trace = os.path.join(out, ps.TRACE_NAME)
    raw = kineto.load(trace)
    total_ms = sum(e["dur"] for e in raw["traceEvents"] if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    rows_ms = sum(r["device_ms"] for r in tl["rows"])
    print(f"instruments (a): {INSTRUMENT_STEPS} profiled steps of AmoebaNet-D(18,416) "
          f"1024^2 bs1: {tl['ops']} device ops, {tl['total_ms']:.1f} ms, "
          f"{100 * tl['coverage']:.2f}% in named scopes, per-scope sum {rows_ms:.3f} "
          f"of the trace's {total_ms:.3f} ms; {tl['by_neighbour']} ops by stream "
          f"neighbour; {card}", flush=True)
    for r in tl["rows"][:12]:
        print(f"instruments (a):   {r['device_ms'] / INSTRUMENT_STEPS:9.3f} ms/step "
              f"{100 * r['share']:5.1f}%  {r['scope']}", flush=True)
    print("instruments (a): device ms a step by family: "
          + ", ".join(f"{k} {v:.3f}" for k, v in summary["families"].items()), flush=True)
    for name, key in (("halo_conv2d_stats", "K2"), ("halo_conv2d", "K1")):
        k = kern[name]
        print(f"instruments (a): {key} ({name}): {k['launches_per_step']} launches, "
              f"{k['ms_per_step']:.3f} ms a step profiled, {tot[key]['ms']:.3f} ms a step "
              f"in phase 2's CUDA graphs; {len(k['scopes'])} scopes, "
              f"{k['unlinked']} unlinked", flush=True)
        assert k["launches_per_step"] == 80, (name, k)
        assert k["scopes"] and all(_CELL.search(sc) for sc in k["scopes"]), k["scopes"]
    assert tl["coverage"] >= COVERAGE, tl["coverage"]
    assert abs(rows_ms - total_ms) <= 0.01 * total_ms, (rows_ms, total_ms)
    return trace, tele


def instruments_attribution(probe, work, trace, tele):
    """Phase 26 (b)-(d): phase 25's lp step attributed on fake tensors (the
    probe) and on the card, its analytical timeline, the CLI."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.mem_probe import card_attribution
    from mpi4dl_tpu_torch.config import config_from_args, get_parser
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.obs.comm_stats import scope_collectives
    from mpi4dl_tpu_torch.obs.costs import ici_bytes_per_s, peak_flops
    from mpi4dl_tpu_torch.obs.hbm import top_group
    from mpi4dl_tpu_torch.obs.overlap import ledger_from_records
    from mpi4dl_tpu_torch.obs.timeline import analytical_timeline

    card = card_line()
    dev = torch.device("cuda")
    # (b) phase 25's lp step attributed: fake tensors (the probe) and the card.
    fake = probe_result(probe)["hbm"]
    cfg = config_from_args(get_parser().parse_known_args(DATA_FLAGS)[0])
    torch.cuda.empty_cache()
    got = card_attribution(cfg, "lp", dev)
    hbm, cost = got["hbm"], got["cost"]
    ratio = hbm["reconcile"]["ratio_est_over_actual"]
    print(f"instruments (b): lp step at phase 20's flags: probe peak "
          f"{fake['peak_bytes_est']} B, coverage {fake['coverage']}, top group "
          f"{top_group(fake)!r}; card tracker peak {hbm['peak_bytes_est']} B against "
          f"max_memory_allocated {hbm['reconcile']['memory_analysis_peak_bytes']} B "
          f"(ratio {ratio}), coverage {hbm['coverage']}, top group {top_group(hbm)!r}; "
          f"{card}", flush=True)
    for k, v in list(hbm["by_scope"].items())[:8]:
        print(f"instruments (b):   {v / 2**20:10.1f} MiB  {k}", flush=True)
    assert fake["coverage"] >= COVERAGE and hbm["coverage"] >= COVERAGE, (fake, hbm)
    assert abs(ratio - 1) <= PROBE_TOLERANCE, ratio
    assert top_group(hbm) == top_group(fake), (top_group(hbm), top_group(fake))

    # (c) its analytical timeline at the card's rates; no collective moves.
    peak, psrc = peak_flops(dev)
    ici, isrc = ici_bytes_per_s(dev)
    records = cost["collective_records"]
    ledger = ledger_from_records(records, compute_ms=cost["flops"] / peak * 1e3,
                                 ici_bw=ici, ici_source=isrc, peak=peak, peak_source=psrc)
    timeline = analytical_timeline(cost["by_scope"], scope_collectives(records),
                                   peak=peak, peak_source=psrc, ici_bw=ici,
                                   ici_source=isrc, ledger=ledger)
    print(f"instruments (c): analytical timeline: serialized {timeline['serialized_ms']} "
          f"ms, perfect overlap {timeline['overlapped_ms']} ms, {timeline['total_flops']:.6g}"
          f" FLOP; the one-process step moves no collective: {ledger['totals']['bytes']} "
          f"bytes, hidden_frac {ledger['hidden_frac']} (not a failure)", flush=True)
    assert timeline["serialized_ms"] >= timeline["overlapped_ms"], timeline
    assert timeline["total_flops"] > 0, timeline
    assert ledger["totals"]["bytes"] == 0 and ledger["hidden_frac"] is None, ledger

    # (d) the CLI on the saved trace and the records.
    log = next(os.path.join(tele, f) for f in os.listdir(tele) if f.endswith(".jsonl"))
    with RunLog(log) as runlog:
        runlog.write("hbm", label="lp", breakdown=hbm)
        runlog.write("timeline", label="lp", **timeline)
        runlog.write("overlap", label="lp", **ledger)
    rc, text = _obs_cli(["overlap", "--profile", trace])
    assert rc == 0 and "exposed-wire ledger" in text, text
    path = os.path.join(work, "trace.json")
    rc, text = _obs_cli(["trace", "--profile", trace, "--out", path])
    with open(path) as f:
        lanes = {e["args"]["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
    assert rc == 0 and {"wire", "device stalls"} <= lanes, lanes
    rc, text = _obs_cli(["report", log])
    for line in ("hbm attribution [lp]", "analytical timeline:", "wire [lp]:",
                 "measured timeline [profile_step]:", "device ops: total self time"):
        assert line in text, (line, text)
    assert rc == 0


# The fleet phase: phase 20's model and flags on a pool of one card.
FLEET_DEADLINE = 280.0  # seconds the scheduler may take (phase 27 < 300 s)


def fleet_scenario():
    """Phase 27's scenario: ``lo`` preempted by ``hi``, ``poison``
    quarantined, ``lo`` resumed (module docstring)."""
    from mpi4dl_tpu_torch.resilience import FleetJob, FleetScenario
    from mpi4dl_tpu_torch.resilience.__main__ import _flags_from_argv

    flags = _flags_from_argv(SUP_FLAGS)
    flags.pop("model")
    poison = {**flags, "image-size": SUP_OOM_IMAGE}

    def arrive(sched):
        sched.submit(FleetJob("hi", "lp", dict(flags), model="amoebanet", priority=10))
        sched.submit(FleetJob("poison", "lp", poison, model="amoebanet", priority=5))

    return FleetScenario(
        "chip_smoke_fleet", pool=1,
        jobs=(FleetJob("lo", "lp", {**flags, "num-epochs": 4}, model="amoebanet"),),
        trigger=arrive, trigger_after="lo", trigger_min_step=2,
        deadline_s=FLEET_DEADLINE,
        expect_done=("lo", "hi"), expect_quarantined=("poison",),
        expect_displaced=("lo",), expect_resumed=("lo",), expect_untouched=("hi",),
        verify_loss=("lo",),
    )


class EarlyControl:
    """Phase 27's launcher factory: the real rank-set launcher, except that
    ``lo``'s solo control, which ``run_fleet_scenario`` asks for once the
    fleet is done, starts beside ``lo``'s last leg (its second launch), at
    that leg's flags and slice with its own checkpoint dir.  Nothing else
    is on the card by then, and legs sharing the card train bitwise as they
    do alone (phase 25 (b) runs three at once); it saves the control's
    ~45 s of start-up and steps.  The control's request must name the same
    flags and environment, and gets that leg's outcome."""

    def __init__(self, wd):
        self.wd, self.lo_launches, self.started = wd, 0, None

    def __call__(self, family, model, workdir, *, job, on_spawn):
        import threading

        from mpi4dl_tpu_torch.resilience.supervisor import subprocess_leg_launcher

        if job == "control-lo":
            def control(flags, env, attempt):
                thread, out, asked = self.started
                assert (dict(flags), dict(env)) == asked, ((flags, env), asked)
                thread.join()
                return out["leg"]
            return control
        inner = subprocess_leg_launcher(family, model, workdir, job=job, on_spawn=on_spawn)
        if job == "lo":
            self.lo_launches += 1
        if job != "lo" or self.lo_launches != 2:
            return inner

        def launch(flags, env, attempt):
            if self.started is None:
                asked = ({**flags, "checkpoint-dir": os.path.join(self.wd, "ck_control_lo")},
                         dict(env))
                out = {}
                ctl = subprocess_leg_launcher(family, model, os.path.join(self.wd, "control_lo"),
                                              job="control-lo")
                thread = threading.Thread(target=lambda: out.update(leg=ctl(*asked, 1)))
                thread.start()
                self.started = (thread, out, asked)
            return inner(flags, env, attempt)
        return launch

    def join(self):
        if self.started is not None:
            self.started[0].join()


def _leg_results(fleet, job):
    """Each leg's result of ``job`` in launch order (attempts within), from
    the ``fleet`` records' launch workdirs."""
    out = []
    for rec in fleet:
        if rec.get("event") == "launch" and rec.get("job") == job:
            jobdir = os.path.join(rec["workdir"], job)
            for a in sorted(os.listdir(jobdir), key=lambda n: int(n[len("attempt"):])):
                path = os.path.join(jobdir, a, "leg_result.json")
                if os.path.exists(path):
                    with open(path) as f:
                        out.append(json.load(f))
    return out


def phase_fleet():
    """The multi-tenant fleet on one card (module docstring, phase 27)."""
    import tempfile

    import torch

    from mpi4dl_tpu_torch.benchmarks.fleet_check import drains
    from mpi4dl_tpu_torch.obs import read_runlog
    from mpi4dl_tpu_torch.resilience import run_fleet_scenario

    card = card_line()
    torch.cuda.empty_cache()  # the legs below are processes of their own
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    sc = fleet_scenario()
    wd = os.path.join(work, sc.name)
    early = EarlyControl(wd)
    try:
        v = run_fleet_scenario(sc, work, log=lambda s: print(s, flush=True),
                               launcher_factory=early)
        assert v.passed and v.kind == "verified_recovery", (v.kind, v.details)
        rc, _ = _obs_cli(["report", os.path.join(wd, "fleet.jsonl")])
        assert rc == 0
        fleet = [r for r in read_runlog(os.path.join(wd, "fleet.jsonl")) if r["kind"] == "fleet"]
        at = {(r["event"], r.get("job")): r["t"] for r in reversed(fleet)}
        (drain,) = drains(wd, fleet)
        assert drain["job"] == "lo" and drain["ended"] == "drained", drain
        jobs = v.details["jobs_final"]
        assert {j: x["launches"] for j, x in jobs.items()} == {"lo": 2, "hi": 1, "poison": 2}
        # Both of poison's runs died of the card's own OOM in their first step.
        incidents = [r for name in ("supervisor01.jsonl", "supervisor02.jsonl")
                     for r in read_runlog(os.path.join(wd, "jobs", "poison", name))
                     if r["kind"] == "supervisor"]
        assert len(incidents) == 2, incidents
        for inc in incidents:
            ev = inc["evidence"]
            assert (inc["failure_class"], inc["policy"]) == ("oom_compile", "fail"), inc
            assert ev["source"] == "marker:oom_pattern" and ev["marker_phase"] == "compile", ev
            assert "CUDA out of memory" in ev["marker_error"], ev
        # lo: drained, resumed, its losses bitwise its solo control's.
        lo_legs = _leg_results(fleet, "lo")
        with open(os.path.join(wd, "control_lo", "control-lo", "attempt1",
                               "leg_result.json")) as f:
            control = json.load(f)
        assert len(lo_legs) == 2 and lo_legs[0]["preempted"], lo_legs
        first, resumed = lo_legs
        assert resumed["start_step"] == first["final_step"] >= 3, (first, resumed)
        assert control["start_step"] == 0 and control["final_step"] == 8, control
        assert first["losses"] == control["losses"][:first["final_step"]], (first, control)
        assert resumed["losses"] == control["losses"][resumed["start_step"]:], (resumed, control)
        assert resumed["loss"] == control["loss"] == v.details["final_loss_lo"]
        for leg in lo_legs + _leg_results(fleet, "hi") + [control]:
            steps = leg["final_step"] - leg["start_step"]
            assert leg["launches"] == {"halo_conv2d": 80 * steps,
                                       "halo_conv2d_stats": 80 * steps}, leg
        quarantine_s = at[("quarantine", "poison")] - at[("submit", "poison")]
        print(f"fleet: {v.kind}: lo drained at step {first['final_step']}, its exit "
              f"{drain['s']:.3f} s after the drain request (checkpoint durable after "
              f"{drain.get('to_saved_s')} s, then {drain.get('saved_to_exit_s')} s to the "
              f"ranks' exit), resumed there with its losses "
              f"{resumed['losses']} bitwise its solo control's; hi done in 1 leg; poison "
              f"quarantined {quarantine_s:.3f} s after it arrived, after 2 runs that died of "
              f"the card's own OOM ({incidents[0]['evidence']['marker_error'][:60]}...); "
              f"80 + 80 K1/K2 a step in every leg of lo and hi; {card}", flush=True)
    finally:
        early.join()
        shutil.rmtree(work, ignore_errors=True)


# The measuring tools' phase.
READINESS_ARGS = ["--parts", "2"]  # the JAX defaults but for the parts (docstring)
H100_MEMORY_TOLERANCE = 0.01  # readiness_8k.H100_HBM_GB against the card's own
BENCH_ITERS = 6  # timed steps of the bench's headline rung
BENCH_TOLERANCE = 0.25  # its ms a step against phase 3's


def readiness_start():
    """Phase 28 (a): ``readiness_8k`` as a subprocess; ``(process, JSON
    path, start)``."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="chip_smoke_readiness_", suffix=".json")
    os.close(fd)
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.readiness_8k",
           *READINESS_ARGS, "--out", path]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path, time.perf_counter()


def phase_tools(readiness, cost_pred):
    """The 8192² readiness probe and the bench's headline rung (module
    docstring, phase 28)."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.readiness_8k import H100_HBM_GB

    card = card_line()
    proc, path, t0 = readiness
    _, err = proc.communicate()
    secs = time.perf_counter() - t0
    with open(path) as f:
        data = json.load(f)
    os.unlink(path)
    assert proc.returncode == 0 and data["builds"], (data.get("error"), err[-2000:])
    roles = data["memory_analysis"]["roles"]
    assert [r["stage"] for r in roles] == [0, 1], roles
    scopes = data["collective_scopes"]
    halos = sum(v["count"] for k, v in scopes.items() if k.startswith("halo_exchange"))
    assert halos > 0 and scopes.get("stage_handoff", {}).get("count"), scopes
    own = torch.cuda.get_device_properties(0).total_memory / 2**30
    assert abs(own / H100_HBM_GB - 1) <= H100_MEMORY_TOLERANCE, (own, H100_HBM_GB)
    print(f"tools: readiness_8k {' '.join(READINESS_ARGS)}: built in "
          f"{data['build_seconds']} s ({secs:.1f} s after its start); collectives a step "
          f"{json.dumps(data['collectives_per_step'])} ({data['collective_total_gb']} GB; "
          f"halo exchanges {halos}, stage handoffs {scopes['stage_handoff']['count']}); "
          f"per-role peak {[(r['rank'], r['peak_gb']) for r in roles]} GiB, largest "
          f"{data['value']} GiB, fits_h100_80gb {data['fits_h100_80gb']} (headroom "
          f"{data['headroom_h100_gb']} GiB; the card's own {own:.3f} GiB, the tool's "
          f"{H100_HBM_GB:.3f}); {card}", flush=True)

    torch.cuda.empty_cache()  # the rung is a process of its own
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi4dl_tpu_torch.bench", "--inner", "gpu", "1024", "18",
         "416", "1", str(BENCH_ITERS), "1", "none", "1", "amoeba"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        env=dict(os.environ, MPI4DL_PALLAS_CONV="1"), timeout=600)
    secs = time.perf_counter() - t
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    m = re.search(r"K1/K2 launches a step: K1 (\S+) K2 (\S+)", proc.stderr)
    assert m and float(m.group(1)) == 80 and float(m.group(2)) == 80, proc.stderr[-2000:]
    assert line["platform"] == "gpu" and 0 < line["mfu"] <= 1, line
    assert line["flops_per_step"] == cost_pred.flops, (line["flops_per_step"], cost_pred.flops)
    ratio = line["ms_per_step"] / SLICE["ms"]
    print(f"tools: bench headline rung: {line['value']} img/s, {line['ms_per_step']} ms a "
          f"step ({line['timing_mode']}, {line['iters']} steps; phase 3 "
          f"{SLICE['ms']:.1f} ms, ratio {ratio:.3f}), mfu {line['mfu']}, "
          f"{line['flops_per_step']:.0f} FLOP a step (the dry run's), K1 {m.group(1)} K2 "
          f"{m.group(2)} launches a step, vs_baseline {line['vs_baseline']}, peak "
          f"{line['peak_memory_gib']} GiB; the rung's process {secs:.1f} s; "
          f"{line['device_kind']}", flush=True)
    assert abs(ratio - 1) <= BENCH_TOLERANCE, ratio


def kernel_entry(name, source, replaces, launches, t, library_ms, peak_flops):
    t_bytes = t["bytes"] / HBM_BYTES_PER_S
    t_ops = t["flops"] / peak_flops
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": t["err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }


def path_entry(t):
    """One path's per-step sums of a halo-conv kernel, for ``by_path``."""
    b_ms, b_by = bound_of(t["bytes"], t["flops"], PEAK_BF16_FLOPS)
    return {"launches_per_step": t["launches"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"] or None, "bound_ms": b_ms, "bound_by": b_by}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="profile one full-width step of each slice; write the "
                         "tables to PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpi4dl_tpu_torch.ops import _build

    # The dry runs (meta device, CPU only) in a worker process, meanwhile.
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        dry = [pool.submit(all_dry_runs), pool.submit(engine_dry_runs),
               pool.submit(ml_dry_runs)]
        cost_dry = pool.submit(runner_dry_cost)
        secs = _build.build_kernels(verbose=True)
        card = card_line()
        print(f"build: {secs:.1f} s on {card}", flush=True)
        check_sass(_build.library_path("halo_conv"))
        check_flash_sass(_build.library_path("block_flash"))
        tot = phase_kernels()
        launches = phase_slice()
        # After phase 3: its host-bound step is phase 28 (b)'s reference,
        # and these processes slow what they run beside.
        probes = [probe_start(DATA_IMAGE), probe_start(SUP_OOM_IMAGE)]
        attributed = probe_start(DATA_IMAGE, ["--attribute"])
        readiness = readiness_start()
        preds = {k: v for d in dry for k, v in d.result().items()}
        cost_pred = cost_dry.result()
        print(f"dry runs: ready {time.perf_counter() - t0:.1f} s after the start",
              flush=True)
    finally:
        pool.shutdown()
    # After the dry-run workers: the gate's subprocess then shares the
    # host's cores with the probes only (it imports torch).
    t = time.perf_counter()
    phase_analysis()
    print(f"phase phase_analysis: {time.perf_counter() - t:.1f} s", flush=True)
    for name, seen in preds.items():
        print(f"dry run: {name}: K2 {seen.counts['halo_conv2d_stats']} K1 "
              f"{seen.counts['halo_conv2d']} launches a step", flush=True)

    def timed(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    sp_tot = timed(phase_sp_kernels, preds)
    sp_launches = timed(phase_sp_slice, preds)
    timed(phase_sp_checks)
    pp_launches = timed(phase_pp_slice, preds)
    timed(phase_pp_checks)
    ldp_launches = timed(phase_ldp_slice, preds)
    timed(phase_card_vs_cpu)
    # From here to phase 28: phase 3's and phase 28 (b)'s host-bound steps are
    # compared, and the gates' processes slow what they run beside (phase 3
    # and 13's CPU references most), even at nice 19.
    contracts = contracts_start()
    timed(phase_kernels_ab)
    gems_launches = timed(phase_gems_sppp_slices, preds)
    timed(phase_engine_checks)
    ml_launches = timed(phase_ml_slices, preds)
    timed(phase_ml_checks)
    timed(phase_memory_levers)
    k3, k3_bwd = timed(phase_flash_kernels)
    timed(phase_ring)
    k3_launches = timed(phase_seq_slice)
    data_launches, whole_losses = timed(phase_data_checkpoint)
    timed(phase_halo_tools)
    resilience_launches, resilience_info = timed(phase_resilience, whole_losses)
    timed(phase_quant, preds)
    timed(phase_telemetry, tot, cost_pred, resilience_info)
    timed(phase_supervisor, probes)
    timed(phase_instruments, tot, attributed)
    timed(phase_fleet)
    contracts_result(contracts)
    timed(phase_tools, readiness, cost_pred)
    if args.profile:
        profile_steps(args.profile)
    check_enrolled()
    timed(phase_kernelcheck)
    main_sp = "amoebanet_2048_sp_d2"
    tot["K1"]["launches"] = tot["K2"]["launches"] = 80

    def by_path(key):
        out = {"amoebanet_1024_one_card": path_entry(tot[key])}
        out.update({name: path_entry(t[key]) for name, t in sp_tot.items()
                    if t[key]["launches"]})
        return out

    print(f"launches: pipeline runs {pp_launches}, local-DP run {ldp_launches}, "
          f"GEMS / SP x PP runs {gems_launches}, multi-level runs {ml_launches}, "
          f"data + checkpoint run {data_launches}, resilience runs "
          f"{resilience_launches}", flush=True)

    entries = [
        dict(kernel_entry("halo_conv2d", SOURCE, K1_SRC,
                          sp_launches[main_sp]["halo_conv2d"], sp_tot[main_sp]["K1"],
                          sp_tot[main_sp]["K1"]["library_ms"], PEAK_BF16_FLOPS),
             by_path=by_path("K1")),
        dict(kernel_entry("halo_conv2d_stats", SOURCE, K2_SRC,
                          sp_launches[main_sp]["halo_conv2d_stats"], sp_tot[main_sp]["K2"],
                          None, PEAK_BF16_FLOPS),
             by_path=by_path("K2")),
        kernel_entry("block_flash", K3_SOURCE, K3_SRC, k3_launches["block_flash"], k3,
                     k3["library_ms"], PEAK_BF16_FLOPS),
        kernel_entry("block_flash_bwd", K3_SOURCE, K3_BWD_SRC,
                     k3_launches["block_flash_bwd"], k3_bwd, k3_bwd["library_ms"],
                     PEAK_BF16_FLOPS),
    ]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (a failed check is reported and the run goes on; any failure exits
non-zero at the end, before any result line is printed):

1. Device and build: the card's name and power limit, then the five CUDA
   kernels built from ``src/repro_torch/csrc`` (nvcc, ``sm_90a``, all
   sources at once), with ptxas's registers and spills for each kernel of
   the SSD scan, each flash kernel (forward and backward) and the decode
   kernels at hd 160; ``cuobjdump -sass`` of the flash forward and
   backward libraries must show tensor-core (``HGMMA``) and TMA
   (``UTMALDG``) instructions in each of their bfloat16 kernels at every
   hd (the backward's dq and dkdv kernels), their float32 (``simt::``)
   kernels ``cp.async`` copies (``LDGSTS``) and no spills at every hd,
   and that of the SSD-scan library ``HGMMA`` in each of its tensor-core
   passes.
2. Every kernel against its plain PyTorch version on the card:
   ``fused_sgd`` bit for bit over the sweep of the JAX package's kernel
   tests, with the gradient as one (C, P) tensor and as leaf lists in each
   class of alignment against p (sharing 16, 8, 4 bytes; the paper MLP's
   layout; the paper CNN's at 1, 5 and 20 lanes; odd sizes at odd
   offsets) at the kernel's span a block and at forced spans, in float32
   and again in bfloat16 (its own entry point, rounding after every
   operation as the reference's kernel does at ``p.dtype``);
   ``flash_attention`` and ``decode_attention`` within 1e-5
   (float32) / 2e-2 (bfloat16) over that sweep plus ragged S and T, G = 8
   over two batch rows, non-causal T > S, MQA, mixed bf16-q/f32-cache
   decode, lengths 1 and T, the paths' own shapes (hd 160 included), and decode shapes that
   the split rule cuts into 7 to 66 splits (windows crossing splits,
   empty splits, B=1 over a 32k cache); each bfloat16
   flash row also within 2^-7 of its own largest value, and a probe of
   ROADMAP C3 (P kept in float32 for the PV product) at hd 32, 64, 128
   and 160; the flash forward with its ``lse`` output bit-equal to the
   serving call without it at yi-9b's and stablelm-12b's prefill shapes,
   and ``lse`` within 1e-5 of the plain one; the flash backward
   (``flash_attention_bwd``) against the plain backward in float64 at
   every hd, both types, G = 1, 4, 8, causal and windowed, S = 100, 257,
   1024, 4096 (``BWD_TOL``), a rerun bit-equal;
   float32 decode attention at yi-9b's score scale, kernel and plain
   version each against float64 (the kernel within 1e-4);
   ``ssd_scan`` within 1e-5 (float32) / 1e-2 (bfloat16) of the output
   scale over that sweep plus ragged L (L < Q, L = k Q + 1), two batch
   rows of two groups across 34 chunks, chunks of 16 to 128 on both
   routes, strided views (the model's layout), the mamba2 path's shape,
   and jamba's N = 16 at chunk 128 (the tensor-core route in bfloat16,
   ragged with two groups and at its path's shape, plain and strided);
   each of its three passes against its plain pass at both paths'
   shapes; and a probe of each float32 operand that the bfloat16 route
   splits into bfloat16 hi + lo (the decayed scores, the chunk state's
   w x, and S_{c-1}) at chunks 64 and 128.
3. The FedSR path: ``repro_torch`` ``run_experiment`` runs FedSR on the
   paper MLP at full width (199,210 parameters, ``mnist_like`` at its
   default 2,000/400 images, K=20, M=5, R=5, E=1, batch 32,
   ``engine="fused"``, ``use_fused_sgd=True``) for 10 rounds with an eval
   every 5, from seeded random weights — on the GPU, then on the CPU from
   the same weights, where the plain versions run. The kernel must have
   launched once per SGD step the plans imply, one dispatch per block;
   plans, comm meters and H2D bytes identical between the two runs, every
   eval's accuracy within 0.02 of the CPU run's, and the final accuracy
   well above chance. Then ``fused_sgd``'s times at the path's shape and
   with the paper MLP's six leaves (the path's call): events and the
   profiler's kernel time with the L2 flushed, and the profiler's time
   warm; the plain version and ``torch._fused_sgd_``. Last a profiler
   pass over one round, with the update's device time and the device
   kernels a SGD step; the round must run no ``torch.cat`` (the kernel
   reads the gradient leaves in place).
3b. The paper CNN (319,178 parameters, ten gradient leaves) on
   ``cifar10_like`` (2,000/400 images), FedSR as in phase 3 for 4 rounds
   with an eval every 2, at ``CNN_LR`` (see there), cuDNN deterministic:
   GPU then CPU with phase 3's checks (80 launches a round; accuracy
   within ``CNN_ACC_TOL``), the round-1 model GPU against CPU within
   ``CNN_ROUND1_TOL`` (and the same round with TF32 on outside it), a
   stop after round 2 and a resume to round 4 on the
   GPU that must equal the uninterrupted GPU run bit for bit; FedAvg's
   cohort of all 20 clients (20 lanes, one hop a round) for 2 rounds, GPU
   then CPU. Then ``fused_sgd``'s times with the CNN's leaves at
   (5, 319,178) and (20, 319,178), one CNN round timed without the
   profiler (cuDNN's default algorithms and deterministic ones) and a
   profiler pass over one round: kernels a step, busy share against the
   unprofiled round, the convolutions' share, the update's device time a
   step and the conv-weight gradients' dense copies (three a step).
3c. The per-round engines on phase 3's path (the paper MLP at full width,
   ``use_fused_sgd=True``, TF32 off), two rounds each: FedSR and FedAvg
   (20 lanes, one hop a round) through ``engine="sequential"`` (one client
   visit at a time, ``fused_sgd`` at (1, 199,210) once per real step) and
   ``engine="batched"`` (one call a hop over host-built batch stacks,
   ``fused_sgd`` once per padded step of each hop), GPU then CPU with
   phase 3's checks under each engine's own launch and dispatch counts;
   each round-1 model GPU against CPU within ``ENGINE_ROUND1_TOL``, and
   the GPU's round-1 FedSR models of the sequential, batched and fused
   engines within it of each other. Then ``fused_sgd``'s times at
   (1, 199,210), and one steady FedSR round of each new engine timed
   without the profiler and profiled, beside phase 3's fused round. Then
   the paper's literal ring loop (ROADMAP A12,
   ``core/ring.py::ring_optimization``): one ring of 5 of phase 3's
   clients, R = 2 laps, E = 1, ``use_fused_sgd``, GPU then CPU: the model
   within ``RING_TOL`` (1e-4) of the CPU's with the 1.03x learning rate
   outside, ``p2p`` equal to ``ring_lap_hops(5, 2)`` = 9, one
   ``fused_sgd`` launch a step, each bit-equal to its plain version.
3d. Table III's new rows on the card: FedProx (E=5, R=1, ``mu`` 0.01) and
   HierFAVG (E=1, R=5) as ``benchmarks/fl_tables.py::_fl`` sets them, on
   phase 3's path (the paper MLP at full width, K=20, M=5, batch 32,
   ``use_fused_sgd=True``, TF32 off), two rounds each on the fused engine,
   GPU then CPU with phase 3's checks; ``fused_sgd`` launches and
   dispatches from the plans against the literals (20 launches a round of
   each: FedProx's cohort of 20 lanes x 20 steps, HierFAVG's 20 (edge,
   device) lanes x 5 iterations x 4 steps), the comm meters (HierFAVG's
   ``edge_up`` and ``edge_down`` too) against their literals; each
   round-1 model GPU against CPU within ``ENGINE_ROUND1_TOL``, and the same
   round at a 3% larger learning rate (the control) outside it. HierFAVG,
   the first seeded plan, also runs its first round through the
   sequential and batched engines on the card, under their own literal
   counts, and its three round-1 models must agree within the bound.
   Then ``fused_sgd``'s times at (20, 199,210) with the MLP's six leaves,
   and one steady round of each algorithm on the fused engine timed
   without the profiler and profiled.
3e. Table II's MOON, SCAFFOLD and Centralized rows on the card
   (``benchmarks/fl_tables.py::table2_accuracy``: ``fashionmnist_like`` at
   200/40 images a class, the star settings E=5, R=1, ``mu`` 0.01), on
   phase 3's path (the paper MLP at full width, K=20, batch 32,
   ``use_fused_sgd=True``, TF32 off, cuDNN deterministic), two rounds
   each, GPU then CPU with phase 3's checks: MOON and SCAFFOLD under the
   fused, batched and sequential engines, Centralized (which ignores the
   engine) once. ``fused_sgd`` launches and dispatches from the plans
   against the literals (``TABLE2_COUNTS``: MOON 20 a round at 20 lanes
   fused and batched, 400 at one lane sequential; SCAFFOLD none under any
   engine, its update being momentum-free; Centralized 315 at one lane),
   cloud transfers and ``peak_device_bytes`` (the state stacks) against
   theirs; each 2-round MOON and SCAFFOLD model GPU against CPU and engine
   against engine within ``ENGINE_ROUND1_TOL``, with the 3%-larger
   learning rate outside (Centralized's 630-step chain is logged, and its
   first epoch held at the bound, ``CENTRALIZED_EPOCH``); SCAFFOLD's saved
   variates ``c`` and ``c_i`` GPU against CPU within ``TABLE2_STATE_TOL``,
   the control again outside; a MOON and a SCAFFOLD run on the fused
   engine stopped after
   round 1 and resumed from their checkpoint (state included), bit-equal
   to the uninterrupted GPU run. Then one steady round of each on the
   fused engine timed without the profiler and profiled.
3f. Table IV's K=100 fleet under the staged stores and the prefetch
   pipeline (``benchmarks/fl_tables.py::table4_scalability`` at
   participation 0.2: a cohort of 20 clients; ``mnist_like`` at
   2,000/400, the paper MLP at full width, ``num_edges=25``, pathological
   xi=2, fused, ``use_fused_sgd=True``, an eval every round, so every round
   is a block staged again): FedSR (E=1, R=5) and MOON (E=5, R=1), three
   rounds each under ``store`` and ``prefetch`` (device, 0), (host, 0),
   (host, 1), (stream, 0) and (stream, 1) on the GPU, (host, 1) also on
   the CPU with phase 3's checks. Every GPU run bit-equal to the (device,
   0) run (final model, accuracies, comm); ``fused_sgd`` launches and
   dispatches as the plans imply and as the literals say;
   ``peak_device_bytes`` and ``h2d_bytes`` equal to the literals that the
   JAX package and the port give on a CPU (``TABLE4_PEAK``,
   ``TABLE4_H2D``), the host store's below the device store's, the
   pipeline's at most twice the serial one; staging measured, and part of
   it hidden under ``prefetch=1``; the (host, 1) model GPU against CPU
   within ``ENGINE_ROUND1_TOL`` with the 1.03x learning rate outside. Then
   the allocator hazard of the side stream, through the store's API: an
   arena dropped while a spin holds the current stream must keep the
   values a queued read sees while the next prefetch stages (the same
   sequence without ``record_stream`` is logged as a control). Logged:
   each run's steady rounds, staging wall and ``overlap_fraction``, the
   H2D rate of one cohort arena and of MOON's staged carry from
   page-locked and from pageable memory, and the host time of a staged
   block's pieces (the cohort arena's build, ``stage_rows`` and
   ``unstage_rows`` of MOON's carry).
3g. The scenario and adversary axes (``benchmarks/fl_tables.py``:
   ``scenario_curves`` under ``drop30``, ``straggle`` and ``stale`` for
   FedSR, FedAvg and HierFAVG at ``num_edges=5``; the ``weighted_mean``
   column of ``attack_defense_grid`` at ``num_edges=10``, FedSR and FedAvg
   under ``signflip20``, ``scale20`` and ``labelflip20``, HierFAVG under
   ``scale20``) on phase 3's path (the paper MLP at full width, K=20,
   pathological xi=2, fused, ``use_fused_sgd=True``), 3 rounds in one
   block against the tables' 12 and 20: each run GPU then CPU with phase
   3's checks (no accuracy floor), its block literal (each round's real
   SGD steps, the comm records, the meter's simulated seconds and the
   ``fused_sgd`` launches, ``SCENARIO_LITERALS`` from
   ``scripts/scenario_literals.py``) on both devices, one call a block;
   every ``fused_sgd`` launch of the GPU runs held against its plain
   version on its own inputs (dropped lanes all-invalid for a round,
   train-slow lanes valid for part of each visit), bit for bit; the
   3-round model GPU against CPU within ``ENGINE_ROUND1_TOL``, with the
   1.03x learning rate outside, where a CPU reading shows a bound can
   tell rounding from the control (``SCENARIO_BOUNDED``; the round-1
   model for ``SCENARIO_ROUND1``), logged otherwise (ROADMAP C7); FedSR
   under ``drop30`` and ``signflip20`` also on the batched engine,
   bit-equal to the fused run on the card. Logged: one steady round of
   each run beside the same algorithm's synchronous round. The CPU runs
   of phases 3g and 3h go to one spawned worker pool while the GPU runs
   go on.
3h. The robust defense columns of ``attack_defense_grid`` (``median``,
   ``trimmed_mean`` and ``krum`` with ``krum_f=4``) on phase 3g's attack
   runs: FedSR (rings of 2) and FedAvg under ``signflip20``, ``scale20``
   and ``labelflip20`` with each reducer on the fused engine, FedSR under
   ``signflip20`` with the median on the batched engine (bit-equal to its
   fused run), HierFAVG under ``scale20`` with the trimmed mean (the
   per-edge robust reduce): each fused run GPU then CPU with phase 3's
   checks (no accuracy floor); each run's literal (``fused_sgd`` launches,
   dispatches, comm, H2D bytes and robust reduces, ``ROBUST_LITERALS``
   from ``scripts/robust_literals.py``) on both devices; every
   ``fused_sgd`` launch against its plain version, bit for bit; every
   robust reduce on the card against ``robust_agg`` on a CPU copy of its
   inputs (the median bit-equal, the trimmed mean within
   ``ROBUST_TRIM_TOL`` of the lanes' largest value, Krum the same lane
   where the CPU's two lowest scores lie more than ``KRUM_MARGIN`` times
   the rounding apart, logged otherwise); the 3-round model GPU against
   CPU within ``ENGINE_ROUND1_TOL`` with the 1.03x learning rate outside
   for ``ROBUST_BOUNDED``, logged for the others (ROADMAP C7); the
   accuracies logged, not held at 0.02, for ``ROBUST_ACC_LOGGED`` and for
   a Krum run whose GPU run picked other lanes than its CPU run. Logged:
   one steady round of each run beside the ``weighted_mean`` round of
   phase 3g under the same attack.
3i. The DP-SGD row of ``attack_defense_grid`` (``dp_clip=1.0``,
   ``dp_noise_mult=1.1``, the honest fleet at ``num_edges=10``) on phase
   3g's path: FedSR (rings of 2) and FedAvg on the fused engine, and each
   one's clip-only twin (``dp_noise_mult=0``), FedSR's also on the batched
   and sequential engines. Each fused run GPU then CPU (in phase 3g's
   pool) with phase 3's checks (no accuracy floor); each run's literal
   (``fused_sgd`` launches, dispatches, comm, ``dp_epsilon``,
   ``dp_delta``; ``DP_LITERALS`` from ``scripts/dp_literals.py``) on both
   devices; one DP transform a SGD step; every ``fused_sgd`` launch
   against its plain version, bit for bit. The noised runs' accuracies
   and models GPU against CPU are logged, not held (the two devices'
   generators draw other noise); each clip-only fused model GPU against
   CPU within ``ENGINE_ROUND1_TOL`` with the 1.03x clip outside
   (``DP_BOUNDED``); the batched clip-only run bit-equal to the fused one.
   The transform with a CUDA generator on a fixed (20, 199,210) stack:
   the standardized noise's mean, std and lane correlations within their
   bounds, a rerun at the same seed bit-equal. Logged: the share of
   lane-steps the clip bound, each run's steady rounds beside phase 3g's
   honest ``weighted_mean`` rounds, the transform's time, and a profiled
   FedSR round with and without DP-SGD (the kernels it adds a step).
3j. Personalization and classifier fleet serving (ROADMAP A8): (a)
   ``personalize_table``'s alpha=0.1 rows (FedAvg and FedSR at ``_fl``'s
   defaults, dirichlet, full and head mode, ``PersonalizeConfig(epochs=3,
   lr=0.02)``) at 2 global rounds, GPU then CPU (in phase 3g's pool): the
   stage's plans, per-client eval labels and comm equal; the whole runs'
   fleets GPU against CPU logged (a round's outcome carries into them,
   C8), the stage alone from the GPU run's global model within
   ``PERS_STAGE_TOL`` of the CPU's stage with the 1.03x fine-tune learning
   rate outside; head mode's body rows the global model's bit for bit on
   the card; (b) Table IV's K=100 FedSR run
   with a one-epoch stage under the device store (one block of 100) and
   the host store with prefetch 0 and 1 (blocks of 64 and 36): the three
   fleets against each other, ``peak_device_bytes``, the staging wall and
   its overlap; (c) ``FleetClassifier`` on (b)'s fleet (256 requests
   drawn with replacement: host- and device-resident logits bit-equal,
   stacked against ``loop_classify`` and each request's solo forward
   within ``SERVE_TOL``, a misrouted batch outside it, one dispatch a
   batch) and on a K=1,024 full-width stand-in fleet (256 distinct
   clients: stacked against loop, device- and host-resident, timed); (d)
   all eight rows of the table on the GPU, its 12 rounds cut to 3
   (``PERS_TABLE_ROUNDS``), accuracies and lift logged. Every
   ``fused_sgd`` launch of the phase's GPU runs (rounds and stage: one a
   stage step) against its plain version, bit for bit; then
   ``fused_sgd``'s times at (100, 199,210) and (64, 199,210).
3k. ``engine="sharded"`` and ``mesh_data_axis`` (ROADMAP A5) on phase 3's
   path, 2 rounds in one block: FedSR on the fused engine with
   ``mesh_data_axis="data"`` and FedAvg (E=5) on the sharded engine, (a)
   on the card's own mesh (one entry: the padding is the identity, the
   plane takes the mesh layout) and (b) on a sim mesh of 8 entries of the
   one card (``launch.mesh.visible_devices`` replaced), where FedSR's 5 ring
   lanes pad to 8 and FedAvg's 20 to 24; GPU then CPU (in phase 3g's
   pool) with phase 3's checks. ``N_max`` of the shards and each run's
   ``h2d_bytes``, ``peak_device_bytes`` and dispatches on both devices
   against ``MESH_LITERALS`` (``scripts/mesh_literals.py``, from the
   reference); every stack padded as the plans imply and every ghost
   lane's returned row its seed bit for bit; on (a) each model the
   unmeshed run's bit for bit on the card; on (a) and (b) each model
   within ``MESH_TOL`` of the CPU's run on the same mesh, with the 1.03x
   learning rate outside (on (b) the gap to the unpadded card run
   logged). Every ``fused_sgd`` launch of the phase
   (the unmeshed runs' too) against its plain version, bit for bit; then
   ``fused_sgd``'s times at (8, 199,210) and (24, 199,210).
4. The yi-9b serving path at full width and 2 layers, GPU against CPU
   from the same CPU-drawn weights, in float32 and in bfloat16 (the CPU
   runs of phases 4, 4b, 4c, 4d, 4e and 6 go to a pool of spawned workers,
   each drawing the weights from the same seed, while the card goes on:
   every 2-layer path runs on the card right after phase 2, the weights
   of the next drawn in a thread meanwhile, so the CPU references use the
   cores that phases 3-3f leave idle; the GPU-against-CPU checks read the
   pool's results after phase 9):
   ``prefill_step`` at B=1, S=256 and ``prefill_and_decode`` at B=4,
   prompt 16, 8 new tokens; logits within stated bounds of the logit
   scale, every greedy token a near-maximum of the CPU's logits, and the
   launch counts: ``num_layers`` flash launches per ``prefill_step`` and
   ``num_layers * (S0 + N)`` decode launches per ``prefill_and_decode``.
   The same GPU path with the plain versions at the two attention call
   sites must agree with the kernels' run within tighter bounds: both
   share every projection bit for bit.
5. The yi-9b serving path at full width and full depth (48 layers, 35.3 GB
   of float32 weights drawn on the card from a CUDA ``torch.Generator``):
   ``prefill_step`` at B=1, S=4096 and ``prefill_and_decode`` at the CLI
   defaults (B=4, 16 + 32), timed, with their launch counts — the counts
   the result line reports; the prefill logits against the plain versions'
   on the card; each launch against its plain version on its own inputs;
   a profiler pass over one prefill and one decode step (with the decode
   kernels' share of the step).
4b. stablelm-12b (hd 160), granite-8b (vocab 49,152) and deepseek-7b
   (MHA, G = 1) at full width and 2 layers, as phase 4, each model freed
   before the next; beside each GPU-against-CPU bound a control: the GPU
   run with every layer's wq scaled by 1.03 (every attention score moved
   by 3%) must land outside it.
5b. stablelm-12b at full width and full depth (40 layers, 48.6 GB of
   float32 weights drawn on the card), as phase 5: its attention runs the
   kernels' hd-160 case, 40 flash launches per ``prefill_step`` and
   40 x 48 = 1,920 decode launches per ``prefill_and_decode``, which the
   result line adds to phase 5's.
4c. The audio and vlm families (ROADMAP A10.4a) at full width and 2
   layers, as phase 4b, each with its wq x1.03 control: musicgen-large
   (MHA at hd 64, vocab 2,048) through ``prefill_step`` (B=1, S=256) and
   ``prefill_and_decode`` (B=4, 16 + 8); llava-next-mistral-7b, which
   reads embeds (the generation loops refuse it), through ``prefill_step``
   on numpy-drawn embeds 0.1 N(0, 1) (B=1, S=256) and ``make_serve_step``
   fed B=4 x 24 embeds positions. Then llava's rolling cache against its
   full cache in float32 at 2 layers, the window cut from 4096 to 64 over
   96 positions, within 1e-4, the decode without a window outside.
4d. The moe family (ROADMAP A10.4b) at full width and 2 layers, as
   phase 4b, each with its wq x1.03 control: qwen3-moe-30b-a3b (128
   experts top-8, GQA 32/4, vocab 151,936) and phi3.5-moe-42b-a6.6b (16
   experts top-2, GQA 32/8); the router's (token, slot) picks of the GPU
   and the CPU compared layer by layer (logged).
4e. The hybrid family (ROADMAP A10.4c): jamba-v0.1-52b at its published
   widths (GQA 32/8 at hd 128, d_ff 14,336, 16 experts top-2, Mamba2
   with N = 16, P = 64, chunk 128, vocab 65,536) cut to the reduced
   config's pattern, [ssm + dense, attn + moe] (3,675,001,376 parameters,
   14.70 GB float32), as phase 4d: one flash and one ``ssd_scan`` launch
   per ``prefill_step``, 24 decode launches per ``prefill_and_decode``
   and none of the scan; float32 at phase 4's bounds, bfloat16 at
   ``HYBRID_GPU_VS_CPU`` and ``HYBRID_KERNEL_VS_PLAIN`` (the last layer's
   router flips, ROADMAP C14); beside each bound two controls, every wq
   x1.03 (the attention's side; held in float32, logged in bfloat16,
   where its move lies below the rounding) and every Mamba2 ``in_proj``
   x1.03 (the scan's side); the router's picks logged layer by layer.
   Before it, on the CPU at the reduced config: the bfloat16 runs from
   ``cast_matrices``' copy (the Mamba2 leaves read through ``.float()``
   left float32) bit-equal to the float32 weights' runs.
5d. qwen3-moe-30b-a3b at full width, depth cut to 24 of its 48 layers
   (62.3 GB of float32 weights drawn on the card), as phase 5: 24 flash
   launches per ``prefill_step`` at B=1, S=4096 (a capacity of 320 an
   expert) and 24 x 48 = 1,152 decode launches per ``prefill_and_decode``
   (B=4, 16 + 32), which the result line adds.
5e. jamba-v0.1-52b at full width, one period of its pattern (8 of its 32
   layers: 7 Mamba2 and the attention layer at position 4, experts at the
   odd positions; 13,267,656,416 parameters, 53.07 GB of float32 weights
   drawn on the card), as phase 5: 7 ``ssd_scan`` and 1 flash launch per
   ``prefill_step`` at B=1, S=4096, 48 decode launches and no scan per
   ``prefill_and_decode`` (B=4, 16 + 32), which the result line adds; its
   bfloat16 scans all on the tensor-core route.
5c. Both at full width and depth, weights drawn on the card, bfloat16
   activations, as phase 5: musicgen-large (48 layers, 12.92 GB)
   ``prefill_step`` at B=1, S=4096 and ``prefill_and_decode`` at 16 + 32
   (48 flash launches, 48 x 48 = 2,304 decode launches); llava (32 layers,
   28.44 GB) ``prefill_step`` on embeds at B=1, S=8192 (prefill_32k cut to
   one card), so the 4096-key window drops keys for half the rows, and
   ``make_serve_step`` over B=4 x 16 + 32 embeds positions (32 flash
   launches, 32 x 48 = 1,536 decode launches); the result line adds them.
6. The mamba2-2.7b serving path at full width and 2 layers, GPU against
   CPU from the same CPU-drawn weights, in float32 and bfloat16, as in
   phase 4; also ``prefill_step`` (the chunked scan) against
   ``decode_step`` fed the same tokens (the recurrence), and the plain scan
   in place of the kernel. ``ssd_scan`` launches ``num_layers`` times per
   ``prefill_step`` and never in ``prefill_and_decode``: the reference
   serves a prompt through ``decode_step``, whose Mamba2 branch is the
   O(1) recurrence.
7. The mamba2-2.7b path at full width and depth (64 layers, 11.3 GB of
   float32 weights drawn on the card): ``prefill_step`` at B=1, S=4096 and
   ``prefill_and_decode`` at the CLI defaults, timed, with launch counts
   and peak memory; each launch against the plain scan on its own inputs;
   the 64-layer logits against the plain scan's, bounded in float32 and
   logged in bfloat16; a profiler pass over one prefill and one decode
   step. The bfloat16 path's shape must take the tensor-core route, and
   the scan's launches of phases 6-7 are logged by route.
7b. LM fleet serving (ROADMAP A10.2): yi-9b at full width and 2 layers,
   K = 8 client models (the base model plus 0.01 N(0, 1) each, drawn on
   the card as one (8, P) arena, 27.85 GB) behind ``FleetParams.from_arena``
   without a host copy; one batch of 8 requests over six clients (lanes
   3, 0, 5, 3, 1, 7, 0, 2), 16 + 32 tokens: one dispatch for prefill and
   one a decode step, 2 x 48 = 96 ``decode_attention`` launches (which the
   result line adds), each against its plain version on its own inputs;
   every fleet token a near-maximum of the per-model loop's logits, and in
   float32 each request's teacher-forced logits within a bound of the
   loop's, with client 3's wq x1.03 inside the fleet moving requests 0 and
   3 (and no other) outside it; a seeded temperature run repeated; a
   host-resident copy serving two batches bit-equal to the resident fleet,
   the second prefetched; timed against the loop, with a profiled decode
   step. Then mamba2-2.7b (K = 4, B = 4, 2 layers) against its loop, and
   the reduced yi-9b fleet (K = 5, B = 6) GPU against CPU in both dtypes.
8. Kernel times with the L2 cache flushed, against the bound, the plain
   version and one library call where PyTorch has one
   (``scaled_dot_product_attention``; none computes the SSD scan) at the
   paths' shapes (yi-9b's, then stablelm-12b's at hd 160, then the
   fleet's batch of 8 at yi-9b's, then phase 5c's: musicgen-large's
   (1, 4096, 32, 32, 64) flash and (4, 32, 32, 48, 64) decode, llava's
   (1, 8192, 32, 8, 128) flash under its 4096-key window, against SDPA
   with a boolean mask of the band (its kernels logged), and (4, 32, 8, 48,
   128) decode, then phase 5e's: jamba's scan at (1, 4096, 128, 1, 64, 16,
   128) and flash at (1, 4096, 32, 8, 128)) and at one layer of
   decode_32k, at its batch of 128 and at batch 1; flash attention's
   rate in TFLOP/s of the causal products
   the function needs; decode attention's split count, its split and
   combine kernels each from a profiler run, and its time at split counts
   the rule does not pick; the SSD scan's three passes each from a
   profiler run.
9. LM training (ROADMAP A10.3): (a) ``launch/train.py::train_loop`` on
   fedsr-lm-100m at full width and depth (120,602,240 parameters), the
   reference's 4-lane layout (a host mesh of 8 entries of the card), batch
   4, seq 256, 30 steps, a cloud sync every 5, ``fused_sgd``, as ``main``
   sets it (lr 0.3): the loss must fall; launches counted from 0 (one
   ``fused_sgd`` a step, 12 x 4 flash forwards and backwards a step); the
   first step's 48 flash forwards (and ``lse``), 48 backwards and its
   ``fused_sgd`` launch each against its plain version on its own inputs;
   fused against unfused on the same 3 steps within 1e-6; the ms a step
   unprofiled, a profiled step's busy share, peak memory. (b) the same
   model at 2 layers, 4 lanes, batch 2, seq 128, 3 steps across one cloud
   sync, GPU against CPU (the CPU run in phase 3g's pool): step 1's params
   and step 2's loss within bounds that the 1.03x learning rate lands
   outside (``TRAIN_GAP``), step 3 logged. (c) yi-9b at full width, 2
   layers, one lane, B=1, S=4096, bfloat16: the step's gradient against
   autograd of the plain route on the card (``YI_GRAD_TOL``, with wq and wk
   scaled to O(1) scores; the reference's scale logged beside a float64
   control), two steps with every flash launch held against its plain
   version, the step's time and peak memory. Then the backward's time at
   the main path's lane and at yi-9b's and stablelm-12b's shapes in
   bfloat16 (its tensor-core route) against its bound, the plain backward
   and SDPA's backward; the forward with and without ``lse`` against its
   bound and SDPA's forward;
   ``fused_sgd`` at (4, 120,602,240) and (1, 870,338,560) with the
   models' 12 leaves. (d) bfloat16 parameters through ``fused_sgd``'s
   bfloat16 case (ROADMAP A10.6): yi-9b as (c), three steps with every
   launch held against its plain version (each ``fused_sgd`` launch bit
   for bit), the same steps counted from 0 and timed (the result line's
   bfloat16 row), the fused against the unfused state after one step
   (logged); (b)'s model in bfloat16 GPU against CPU after one step (the
   CPU run in phase 4's pool), its control outside; the bfloat16 case's
   time at (1, 870,338,560) beside ``torch._fused_sgd_`` on bfloat16
   tensors.

The last lines of standard output are one JSON line describing every
kernel, the card's ``nvidia-smi`` name and power limit, and the result
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
from collections import Counter
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12     # H100 SXM datasheet memory rate
H100_F32_FLOPS = 67e12         # H100 SXM datasheet float32 (non-tensor) rate
H100_BF16_FLOPS = 989e12       # H100 SXM datasheet dense bf16 tensor-core rate
MAIN_SHAPE = (5, 199_210)      # M=5 ring lanes x the paper MLP's parameters
LANE_SHAPE = (1, 199_210)      # the sequential engine's one-lane visit
SWEEP_N = (1, 255, 257, 1023, 4097, 199_210)


FAILURES = []    # every failed check of this run, in order


def check(cond: bool, what: str) -> None:
    if not cond:
        FAILURES.append(what)
        print(f"[FAIL] {what}", flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_report(name: str, log_text) -> str:
    """One line on a kernel library: the registers and spills ptxas
    reported when this process compiled it, or, when ``kernels.build``
    found it already built in ``build/`` (no log in this process), that it
    was reused."""
    if log_text is None:
        return f"[build] {name}: reused from build/ (no ptxas log)"
    lines = log_text.splitlines()
    regs = [int(line.split("Used ")[1].split()[0]) for line in lines
            if "Used " in line and " registers" in line]
    spills = [line.strip() for line in lines
              if "spill" in line and " 0 bytes spill" not in line]
    return (f"[build] {name}: {len(regs)} entry points, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}"
            + (f"; spills: {spills[:3]}" if spills else ", no spills"))


SSD_KERNELS = ("chunk_states", "state_passing", "chunk_outputs")
DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")


BWD_TC_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
BWD_SIMT_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_grad_kernel")
ATTN_KERNELS = (("flash_attention_kernel",) + BWD_TC_KERNELS
                + BWD_SIMT_KERNELS + ("sum_group_heads",) + DECODE_KERNELS)


def kernel_label(mangled: str) -> str:
    """A short name for a mangled kernel of the SSD-scan or attention
    libraries, its template arguments in order, e.g.
    ``tc::chunk_outputs<128,2>``, ``simt::chunk_states<bf16>`` or
    ``decode_split_kernel<bf16,f32,160,4>`` (no ``<>`` for a kernel that
    is no template, ``tc::sum_group_heads``)."""
    base = next((k for k in SSD_KERNELS + ATTN_KERNELS if k in mangled),
                mangled)
    ns = ("tc::" if f"2tc{len(base)}{base}" in mangled else
          "simt::" if f"4simt{len(base)}{base}" in mangled else "")
    if not mangled.split(base, 1)[-1].startswith("I"):
        return f"{ns}{base}"
    targs, last = [], ""
    tail = mangled.split(base, 1)[-1][1:].split("EEv")[0] + "E"
    for m in re.finditer(r"13__nv_bfloat16|S\d*_|Li(\d+)E|f", tail):
        if m.group(1):
            targs.append(m.group(1))
            continue
        last = {"f": "f32", "13__nv_bfloat16": "bf16"}.get(m.group(0), last)
        targs.append(last)           # a substitution repeats the last type
    return f"{ns}{base}<{','.join(targs)}>"


def ptxas_by_kernel(log_text: str) -> dict:
    """{kernel label: "N registers, spill stores/loads, wgmma waits and
    fences that ptxas injected"} from ptxas -v."""
    out, name, spill, injected = {}, None, "", {}
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used " in line and " registers" in line and name:
            regs = line.split("Used ")[1].split(",")[0]
            out[name] = f"{regs}, {spill.split('frame, ')[-1]}"
        elif "is injected" in line and "in function '" in line:
            what = "waits" if "warpgroup.wait" in line else "fences"
            fn = kernel_label(line.split("in function '")[1].split("'")[0])
            injected.setdefault(fn, Counter())[what] += 1
    return {k: v + "; injected wgmma " + (", ".join(
        f"{n} {w}" for w, n in sorted(injected[k].items()))
        if k in injected else "none") for k, v in out.items()}


def sass_sections(build, name: str) -> dict:
    """{mangled kernel name: SASS body} of one library (cuobjdump)."""
    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass",
         str(build.library_path(name))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    sections = {}
    for section in sass.split("Function : ")[1:]:
        fn, _, body = section.partition("\n")
        sections[fn.strip()] = body
    return sections


def check_flash_bwd_sass(build) -> None:
    """The flash backward's bfloat16 kernels (``tc::``, dq and dkdv) show
    ``HGMMA`` and ``UTMALDG`` at every hd."""
    bwd = {}        # label -> instruction counts of the backward's tc kernels
    for name, body in sass_sections(build, "flash_attention_bwd").items():
        label = kernel_label(name)
        if label.split("<")[0] in {f"tc::{k}" for k in BWD_TC_KERNELS}:
            bwd[label] = {op: body.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[build] flash_attention_bwd bfloat16 kernels' SASS: {bwd}")
    want = {f"tc::{k}<{hd}>" for k in BWD_TC_KERNELS
            for hd in (32, 64, 128, 160)}
    check(set(bwd) == want
          and all(n > 0 for c in bwd.values() for n in c.values()),
          f"flash_attention_bwd's bfloat16 kernels lack HGMMA or UTMALDG: "
          f"{bwd}")


SIMT_KERNELS = {"flash_attention": ("flash_attention_kernel",),
                "flash_attention_bwd": BWD_SIMT_KERNELS}


def check_simt_sass(build) -> None:
    """The flash forward's and backward's float32 kernels (``simt::``)
    load through ``cp.async`` (SASS ``LDGSTS``) at every hd, and ptxas
    reported no spills for them when this process built the libraries."""
    found = {}      # label -> LDGSTS count
    for lib, kernels in SIMT_KERNELS.items():
        for name, body in sass_sections(build, lib).items():
            label = kernel_label(name)
            if label.split("<")[0] in {f"simt::{k}" for k in kernels}:
                found[label] = body.count("LDGSTS")
    log(f"[build] flash float32 kernels' LDGSTS counts: {found}")
    want = {f"simt::{k}<{hd}>" for ks in SIMT_KERNELS.values() for k in ks
            for hd in (32, 64, 128, 160)}
    check(set(found) == want and all(n > 0 for n in found.values()),
          f"the flash float32 kernels lack LDGSTS: {found}")
    for lib in SIMT_KERNELS:
        text = build.BUILD_LOGS.get(lib)
        if text is None:
            log(f"[build] {lib}: reused from build/, spills not checked")
            continue
        spills = {k: r for k, r in ptxas_by_kernel(text).items()
                  if k.startswith("simt::")
                  and "0 bytes spill stores, 0 bytes spill loads" not in r}
        check(not spills, f"{lib}'s float32 kernels spill: {spills}")


def check_tensor_core_sass(build) -> None:
    """Phase 1: each bfloat16 kernel of the flash forward and backward
    libraries (``tc::``: the forward, the backward's dq and dkdv kernels)
    multiplies on the tensor cores (wgmma, SASS ``HGMMA``) and loads
    through TMA (``UTMALDG``) at every hd, and each tensor-core pass of the
    SSD scan (``tc::``, its bfloat16 route) shows ``HGMMA``, as
    ``cuobjdump -sass`` of the libraries shows."""
    counts = {}     # hd -> instruction counts of tc::flash_attention_kernel<hd>
    for name, body in sass_sections(build, "flash_attention").items():
        if "tc22flash_attention_kernel" in name:
            hd = int(name.split("kernelILi")[1].split("E")[0])
            counts[hd] = {op: body.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[build] flash_attention bfloat16 kernels' SASS by hd: {counts}")
    check(sorted(counts) == [32, 64, 128, 160]
          and all(n > 0 for c in counts.values() for n in c.values()),
          f"flash_attention's bfloat16 kernels lack HGMMA or UTMALDG: "
          f"{counts}")
    check_flash_bwd_sass(build)
    check_simt_sass(build)
    ssd = {kernel_label(name): body.count("HGMMA")
           for name, body in sass_sections(build, "ssd_scan").items()}
    log(f"[build] ssd_scan kernels' HGMMA counts: {ssd}")
    tc = {k: n for k, n in ssd.items() if k.startswith("tc::")}
    check(len(tc) == 6 and all(n > 0 for n in tc.values()),
          f"ssd_scan's tensor-core passes lack HGMMA: {ssd}")


# gradient leaf layouts of the sweep, by how each leaf's rows sit against
# p's 16-byte grid: sharing 16 bytes, 8 bytes, 4 bytes; the paper MLP's
# sorted layout (its w0 alternates 16 and 8 bytes by lane); odd sizes at odd
# offsets
MLP_LEAVES = [(200,), (200,), (10,), (784, 200), (200, 200), (200, 10)]
# the paper CNN's sorted layout, 319,178 parameters: its lanes alternate 16
# and 8 bytes from fc1_b (10 floats) on
CNN_LEAVES = [(32,), (3, 3, 3, 32), (64,), (3, 3, 32, 64), (64,),
              (3, 3, 64, 64), (64,), (4096, 64), (10,), (64, 10)]
CNN_SHAPE = (5, 319_178)       # the CNN's FedSR rings
FEDAVG_SHAPE = (20, 319_178)   # the CNN's FedAvg cohort of K=20 clients
SGD_LAYOUTS = {"share16": [(64,), (16, 40), (8,)],
               "share8": [(2,), (16, 40), (6,)],
               "share4": [(1,), (16, 40), (3,)],
               "mlp": MLP_LEAVES,
               "cnn": CNN_LEAVES,
               "odd": [(3,), (1,), (7, 5), (2,), (13,), (1,), (33,)]}
SGD_LANES = {"cnn": (1, 5, 20), "mlp": (1, 5, 20)}    # others: (1, 5)
SGD_SPANS = (4, 12, 4096)      # forced spans a block: one slot, three, 1,024
SGD_MASK = (True, False, True, True, False)     # repeated over the lanes


def split_leaves(g, shapes):
    """Contiguous leaves holding g's columns in order (fresh allocations,
    as autograd's are)."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(g[:, off:off + n].clone(
            memory_format=torch.contiguous_format).view(g.shape[0], *shape))
        off += n
    return out


def kernel_sweep(fused_sgd_lanes, sgd_lanes_reference,
                 dtype=torch.float32) -> float:
    """Phase 2: the kernel equals its plain version bit for bit, with the
    gradient as one (C, P) tensor and as leaf lists in every alignment
    class, at the kernel's own span a block and at forced spans, in
    ``dtype`` (float32, or the bfloat16 case's own entry point, whose
    spans round up to 8 elements). Returns the largest absolute
    difference seen (0.0 when it passes)."""
    from repro_torch.kernels.fused_sgd import kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n in SWEEP_N:
        for nesterov in (False, True):
            cases.append(((5, n), None, 0.9, nesterov, 0))
    cases += [((5, 199_210), None, 0.0, False, 0), ((1, 64), None, 0.0, False, 0),
              ((3, 300), None, 0.5, True, 0), (MAIN_SHAPE, None, 0.5, False, 0)]
    for name, shapes in SGD_LAYOUTS.items():
        P = sum(int(np.prod(s)) for s in shapes)
        for C in SGD_LANES.get(name, (1, 5)):
            for span in (0,) + SGD_SPANS:
                cases.append(((C, P), name, 0.9, C == 5, span))
    n_masks = 3
    worst = 0.0
    for shape, layout, momentum, nesterov, span in cases:
        C = shape[0]
        p, g, m = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        grads = g if layout is None else split_leaves(g, SGD_LAYOUTS[layout])
        lr = torch.tensor([0.02], device="cuda").to(dtype)
        for mask in ([True] * C, [SGD_MASK[i % 5] for i in range(C)],
                     [False] * C):
            ok = torch.tensor(mask, device="cuda")
            for reset in (False, True):
                want_p, want_m = sgd_lanes_reference(
                    p, grads, m, ok, lr, reset=reset, momentum=momentum,
                    nesterov=nesterov)
                got_p, got_m = p.clone(), m.clone()
                if span:
                    kernel.launch(got_p, grads, got_m, ok, lr, reset=reset,
                                  momentum=momentum, nesterov=nesterov,
                                  span=span)
                else:
                    fused_sgd_lanes(got_p, grads, got_m, ok, lr, reset=reset,
                                    momentum=momentum, nesterov=nesterov)
                torch.cuda.synchronize()
                err = max((got_p - want_p).abs().max().item(),
                          (got_m - want_m).abs().max().item())
                worst = max(worst, err)
                check(torch.equal(got_p, want_p) and torch.equal(got_m, want_m),
                      f"fused_sgd {dtype} != plain version at shape={shape} "
                      f"leaves={layout} span={span} momentum={momentum} "
                      f"nesterov={nesterov} ok={mask} reset={reset} "
                      f"(max |diff| {err})")
    log(f"[kernel] fused_sgd {str(dtype)[6:]} equals its plain version bit "
        f"for bit over {len(cases) * n_masks * 2} cases (one (C, P) gradient "
        f"and leaf "
        f"lists {sorted(SGD_LAYOUTS)}, lanes {SGD_LANES} else (1, 5), spans "
        f"default and {SGD_SPANS})")
    return worst


def main_path(run_experiment, fused_sgd_lanes, cfg, fl, init,
              task="mnist_like", eval_every=5, tag="main", ckdir=None,
              devices=("cuda", "cpu"), **run_kw):
    """Phases 3 and 3b: the GPU run with launch counting, then the CPU run
    of one FL path (of ``devices``). With ``ckdir`` each run checkpoints
    its last round into ``<ckdir>/<device>`` (phase 3e reads SCAFFOLD's
    state there); ``run_kw`` goes to ``run_experiment`` (a task's
    ``train``/``test``)."""
    runs = {}
    for device in devices:
        blocks = []
        fused_sgd_lanes.launches = 0
        t0 = time.perf_counter()
        ck = ({} if ckdir is None else
              {"checkpoint_dir": f"{ckdir}/{device}",
               "checkpoint_every": fl.rounds})
        res = run_experiment(task=task, model_cfg=cfg, fl=fl,
                             eval_every=eval_every, init_params=init,
                             device=device,
                             on_block=lambda t, s, b=blocks: b.append((t, s)),
                             **ck, **run_kw)
        wall = time.perf_counter() - t0
        runs[device] = (res, blocks, fused_sgd_lanes.launches, wall)
        log(f"[{tag}] {device}: accuracies "
            f"{[round(r.accuracy, 4) for r in res.history]} "
            f"launches={fused_sgd_lanes.launches} "
            f"dispatches={res.dispatches} h2d_bytes={res.h2d_bytes} "
            f"wall={wall:.3f}s")
    return runs


def engine_counts(blocks, engine: str):
    """(``fused_sgd`` launches, dispatches) that the blocks' plans imply
    under ``engine``. Fused: visit groups (one a round, HierFAVG's R a
    round) x hops x the block's longest visit (shorter visits and ring
    tails run masked steps), one dispatch a block.
    Batched: each hop's longest visit (a hop of ring tails alone still
    takes one masked step), one call a hop. Sequential: each real visit's
    own steps, one dispatch a step. SCAFFOLD's momentum-free update never
    launches the kernel; its dispatches count as any other's."""
    launches = dispatches = 0
    for _, sched in blocks:
        groups = [g for p in sched.plans for g in p.groups]
        hops = [h for g in groups for h in g.hops]
        if engine == "fused":
            H = max(len(g.hops) for g in groups)
            S = max(p.shape[0] for h in hops for p in h.plans if p is not None)
            steps, calls = len(groups) * H * S, 1
        elif engine == "batched":
            steps = sum(max(1 if p is None else p.shape[0]
                            for p in h.plans) for h in hops)
            calls = len(hops)
        else:
            steps = calls = sum(p.shape[0] for h in hops for p in h.plans
                                if p is not None)
        momentum_free = all(g.variant == "scaffold" for g in groups)
        launches += 0 if momentum_free else steps
        dispatches += calls
    return launches, dispatches


def check_main_path(runs, n_params, acc_tol=0.02, min_final_acc=0.5,
                    tag="main", engine="fused", counts=None) -> None:
    """The checks of one FL path's GPU run against its CPU run: launches
    and dispatches as ``engine_counts`` implies for ``engine`` (or as
    ``counts`` gives them for a path without plans), identical plans,
    meters, H2D bytes and ``peak_device_bytes``, every eval's accuracy
    within ``acc_tol`` of the CPU's, the final accuracy above
    ``min_final_acc`` (None: not checked), finite weights and the model's
    parameter count, ``n_params``."""
    gpu, gblocks, glaunch, _ = runs["cuda"]
    cpu, cblocks, claunch, _ = runs["cpu"]
    steps, calls = counts or engine_counts(gblocks, engine)
    log(f"[{tag}] under the {engine} engine the plans imply {steps} "
        f"fused_sgd launches and {calls} dispatches over {len(gblocks)} "
        f"blocks")
    check(glaunch == steps, f"{tag}: fused_sgd launched {glaunch} times, "
          f"the plans imply {steps} steps")
    check(claunch == 0, f"{tag}: the CPU run launched the CUDA kernel")
    check(gpu.dispatches == calls == cpu.dispatches,
          f"{tag}: dispatches {gpu.dispatches}/{cpu.dispatches}, the plans "
          f"imply {calls}")
    check(len(gblocks) == len(cblocks), "block counts differ")
    for (ta, sa), (tb, sb) in zip(gblocks, cblocks):
        if sa is None or sb is None:        # an algorithm without plans
            check(ta == tb and sa is sb, "block plans differ")
            continue
        check(ta == tb and sa.comm == sb.comm, "block comm differs")
        for pa, pb in zip(sa.plans, sb.plans):
            check(pa.comm == pb.comm and pa.sim_seconds == pb.sim_seconds,
                  "round comm differs")
            for ga, gb in zip(pa.groups, pb.groups):
                check(ga.agg == gb.agg, "aggregation weights differ")
                check(ga.lane_scale == gb.lane_scale, "lane scales differ")
                for ha, hb in zip(ga.hops, gb.hops):
                    check(ha.ids == hb.ids, "ring orders differ")
                    for a, b in zip(ha.plans, hb.plans):
                        check((a is None) == (b is None) and (
                            a is None or np.array_equal(a, b)),
                            "batch plans differ")
    check(gpu.h2d_bytes == cpu.h2d_bytes, f"{tag}: h2d_bytes differ")
    check(gpu.peak_device_bytes == cpu.peak_device_bytes,
          f"{tag}: peak_device_bytes {gpu.peak_device_bytes} on the GPU, "
          f"{cpu.peak_device_bytes} on the CPU")
    check([r.round for r in gpu.history] == [r.round for r in cpu.history],
          "eval rounds differ")
    for a, b in zip(gpu.history, cpu.history):
        check(a.comm == b.comm, f"comm meters differ at round {a.round}")
        check(abs(a.accuracy - b.accuracy) <= acc_tol,
              f"{tag} round {a.round}: GPU accuracy {a.accuracy} vs CPU "
              f"{b.accuracy}")
    check(min_final_acc is None or gpu.final_accuracy > min_final_acc,
          f"{tag}: final accuracy {gpu.final_accuracy} is not above "
          f"{min_final_acc}")
    for k, v in gpu.final_model.items():
        check(bool(torch.isfinite(v).all()), f"non-finite weights in {k}")
    have = sum(v.numel() for v in gpu.final_model.values())
    check(have == n_params, f"{tag}: {have} parameters, expected "
          f"{n_params:,}")


# Phase 3b, the paper CNN (319,178 parameters) on cifar10_like. The
# reference's fan_in rule reads shape[-2] (Cin) of an HWIO conv kernel, not
# its 3 x 3 x Cin inputs, so the CNN starts with losses of 10 to 21, and at
# the default init_lr of 0.01 the first FedSR round diverges from each of
# four torch-drawn initial models; at 1e-3 each trains (ROADMAP C5; CPU
# runs of scripts/cnn_sensitivity.py).
CNN_LR = 1e-3
# GPU against CPU: the conv and product kernels sum in other orders, and a
# ReLU or max-pool kink that an element crosses in one run and not the
# other moves one step's update at one position by about lr / B. A 1e-7
# relative change of the initial weights moves the CPU's own round-1 model
# by 1.4e-6 to 3.3e-5 (three draws, scripts/cnn_sensitivity.py), so round 1
# is held at 1e-4, three times the largest of those; the same round with
# TF32 on for matmul and cuDNN is the control that must land outside it.
# Accuracies: within 0.0125 (5 of 400 test images) of the CPU's at every
# eval, and above 0.3 at round 4 (the CPU run reaches 0.4475).
CNN_ROUND1_TOL = 1e-4
CNN_ACC_TOL = 0.0125
CNN_MIN_ACC = 0.3


def max_abs_diff(a, b) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def diff_spread(a, b, over: float = 1e-6) -> str:
    """Where two models differ by more than ``over``: per leaf the count of
    such elements and of the last-axis units they lie in. A ReLU that one
    run sees on the other side of its kink moves one hidden unit's weights
    (a column of the layer before it); an update that differs everywhere
    moves every unit."""
    out = []
    for k in sorted(a):
        big = (a[k].cpu() - b[k].cpu()).abs() > over
        if big.any():
            units = int(big.reshape(-1, big.shape[-1]).any(0).sum())
            out.append(f"{k}: {int(big.sum())} of {big.numel()} in {units} "
                       f"of {big.shape[-1]} units")
    return "; ".join(out) or "none"


def cnn_path(run_experiment, fused_sgd_lanes, cfg, fl, init) -> dict:
    """Phase 3b: FedSR on the paper CNN, GPU then CPU, as phase 3 checks
    the MLP; the round-1 model on the GPU against the CPU's; a stop after
    round 2 and a resume to round 4 on the GPU against the uninterrupted
    GPU run; FedAvg's cohort of 20 lanes for two rounds, GPU then CPU.
    cuDNN runs deterministic algorithms for the FedSR runs, so the GPU's
    resumed run can be held bit for bit. Returns each path's launches."""
    import tempfile

    run = dict(task="cifar10_like", model_cfg=cfg, init_params=init)
    torch.backends.cudnn.deterministic = True
    try:
        runs = main_path(run_experiment, fused_sgd_lanes, cfg, fl, init,
                         task="cifar10_like", eval_every=2, tag="cnn")
        check_main_path(runs, 319_178, acc_tol=CNN_ACC_TOL,
                        min_final_acc=CNN_MIN_ACC, tag="cnn")
        launches = {"cnn": runs["cuda"][2]}
        check(launches["cnn"] == 80 * fl.rounds,
              f"cnn: fused_sgd launched {launches['cnn']} times, not 80 a "
              f"round")
        first = {dev: run_experiment(fl=fl, eval_every=2, device=dev,
                                     stop_after=1, **run).final_model
                 for dev in ("cuda", "cpu")}
        err = max_abs_diff(first["cuda"], first["cpu"])
        flat = {dev: torch.cat([v.cpu().reshape(-1) for _, v in
                                sorted(w.items())])
                for dev, w in first.items()}
        rel = float((flat["cuda"] - flat["cpu"]).norm() / flat["cpu"].norm())
        log(f"[cnn] the global model after round 1, GPU against CPU: max "
            f"|diff| {err:.3e}, relative L2 {rel:.3e} (bound {CNN_ROUND1_TOL})")
        check(err <= CNN_ROUND1_TOL,
              f"cnn round 1: GPU model {err} from the CPU's")
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            control = run_experiment(fl=fl, eval_every=2, device="cuda",
                                     stop_after=1, **run).final_model
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        err = max_abs_diff(control, first["cpu"])
        log(f"[cnn] control: the round-1 model with TF32 on, GPU against "
            f"CPU: max |diff| {err:.3e} (must exceed {CNN_ROUND1_TOL})")
        check(err > CNN_ROUND1_TOL, "cnn round 1: the bound does not tell "
              "a TF32 run from the CPU's")

        full = runs["cuda"][0]
        with tempfile.TemporaryDirectory() as ckdir:
            run_experiment(fl=fl, eval_every=2, device="cuda",
                           checkpoint_dir=ckdir, checkpoint_every=2,
                           stop_after=2, **run)
            resumed = run_experiment(fl=fl, eval_every=2, device="cuda",
                                     checkpoint_dir=ckdir, resume=True,
                                     **run)
        same = all(torch.equal(full.final_model[k], resumed.final_model[k])
                   for k in full.final_model)
        log(f"[cnn] stop after round 2 and resume to round 4 on the GPU: "
            f"history {[(r.round, r.accuracy) for r in resumed.history]}, "
            f"final weights {'bit-equal to' if same else 'differ from'} the "
            f"uninterrupted run's (max |diff| "
            f"{max_abs_diff(full.final_model, resumed.final_model):.3e})")
        check(same and [(r.round, r.accuracy, r.comm) for r in full.history]
              == [(r.round, r.accuracy, r.comm) for r in resumed.history],
              "cnn: the resumed GPU run is not the uninterrupted one")
    finally:
        torch.backends.cudnn.deterministic = False

    avg_fl = dataclasses.replace(fl, algorithm="fedavg", rounds=2)
    avg = main_path(run_experiment, fused_sgd_lanes, cfg, avg_fl, init,
                    task="cifar10_like", eval_every=2, tag="fedavg")
    check_main_path(avg, 319_178, acc_tol=CNN_ACC_TOL, min_final_acc=None,
                    tag="fedavg")
    launches["fedavg"] = avg["cuda"][2]
    lanes = {len(g.hops[0].ids) for _, sched in avg["cuda"][1]
             for p in sched.plans for g in p.groups}
    check(lanes == {fl.num_devices},
          f"fedavg: cohorts of {lanes} lanes, not all {fl.num_devices}")
    for tag, res, mode in (("cnn", runs, "deterministic"),
                           ("fedavg", avg, "default")):
        for rec in res["cuda"][0].history:
            log(f"[{tag}] cuda block ending round {rec.round}: "
                f"{rec.seconds * 1e3 / rec.rounds:.2f} ms/round, cuDNN "
                f"{mode} (acc {rec.accuracy:.4f})")
    return launches


# Phase 3c, the per-round engines. GPU against CPU after one round of the
# paper MLP: the products sum in other orders on the two devices (TF32 is
# off), as in the CNN's round 1, so the round-1 models are held at the
# CNN's 1e-4, and so are the GPU's three engines against each other (the
# CPU tests hold batched bit-equal to fused and sequential within 1e-6 of
# it: tests/test_torch_engines.py).
ENGINE_ROUND1_TOL = 1e-4


def engines_path(run_experiment, fused_sgd_lanes, cfg, fl, init) -> int:
    """Phase 3c: FedSR and FedAvg through the sequential and the batched
    engine, two rounds each, GPU then CPU, with phase 3's checks under each
    engine's own launch and dispatch counts; the round-1 model of each on
    the GPU against the CPU's, and the GPU's round-1 FedSR models of the
    sequential, batched and fused engines against each other. Returns the
    ``fused_sgd`` launches of the four GPU runs."""
    launches = 0
    round1 = {}
    for algorithm in ("fedsr", "fedavg"):
        for engine in ("sequential", "batched"):
            tag = f"{algorithm}/{engine}"
            efl = dataclasses.replace(fl, algorithm=algorithm, engine=engine,
                                      rounds=2)
            runs = main_path(run_experiment, fused_sgd_lanes, cfg, efl, init,
                             eval_every=1, tag=tag)
            check_main_path(runs, 199_210, min_final_acc=None, tag=tag,
                            engine=engine)
            gpu, blocks, n, _ = runs["cuda"]
            launches += n
            lanes = {len(g.hops[0].ids) for _, sched in blocks
                     for p in sched.plans for g in p.groups}
            log(f"[{tag}] lanes a group {sorted(lanes)}; GPU launches {n}, "
                f"dispatches {gpu.dispatches}, h2d_bytes {gpu.h2d_bytes}")
            first = {dev: run_experiment(task="mnist_like", model_cfg=cfg,
                                         fl=efl, init_params=init,
                                         device=dev, stop_after=1).final_model
                     for dev in ("cuda", "cpu")}
            err = max_abs_diff(first["cuda"], first["cpu"])
            log(f"[{tag}] the global model after round 1, GPU against CPU: "
                f"max |diff| {err:.3e} (bound {ENGINE_ROUND1_TOL})")
            check(err <= ENGINE_ROUND1_TOL,
                  f"{tag} round 1: GPU model {err} from the CPU's")
            if algorithm == "fedsr":
                round1[engine] = first["cuda"]
    round1["fused"] = run_experiment(
        task="mnist_like", model_cfg=cfg, fl=dataclasses.replace(fl, rounds=2),
        init_params=init, device="cuda", stop_after=1).final_model
    for a, b in (("sequential", "batched"), ("sequential", "fused"),
                 ("batched", "fused")):
        err = max_abs_diff(round1[a], round1[b])
        log(f"[engines] the GPU's round-1 FedSR model, {a} against {b}: max "
            f"|diff| {err:.3e} (bound {ENGINE_ROUND1_TOL})")
        check(err <= ENGINE_ROUND1_TOL,
              f"round-1 FedSR models of the {a} and {b} engines {err} apart "
              f"on the GPU")
    return launches


# Phase 3c's ring loop (ROADMAP A12): core/ring.py::ring_optimization, the
# paper's Algorithm 1 inner loop as written, on phase 3's path: one ring of
# the first 5 of phase 3's 20 pathological clients (100 images each, 4
# steps of 32 a visit), R = 2 laps, E = 1, from phase 3's weights. On the
# CPU a relative 1e-7 change of the initial weights moves the ring's model
# by at most 6.0e-8 and the 1.03x learning rate by 3.3e-3, so the GPU is
# held within RING_TOL of the CPU and the control must land outside.
RING_K, RING_LAPS = 5, 2
RING_TOL = 1e-4


def ring_path(fused_sgd_lanes, sgd_lanes_reference, cfg, fl, init) -> int:
    """Phase 3c's ring loop: ``ring_optimization`` on the card with
    ``use_fused_sgd``, then on the CPU from the same weights and generator
    seed; the model GPU against CPU within ``RING_TOL``, the 1.03x
    learning rate outside it, the ``p2p`` meter equal to
    ``ring_lap_hops(5, 2)`` = 9, one ``fused_sgd`` launch a step, each held
    against its plain version bit for bit. Returns the GPU run's
    launches."""
    from repro_torch.core.comm import CommMeter
    from repro_torch.core.local import LocalTrainer
    from repro_torch.core.ring import ring_lap_hops, ring_optimization
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    train, _ = make_task("mnist_like", seed=fl.seed)
    ring = make_clients(train, scheme=fl.partition,
                        num_devices=fl.num_devices,
                        rng=np.random.default_rng(fl.seed))[:RING_K]
    rfl = dataclasses.replace(fl, use_fused_sgd=True, local_epochs=1)

    def run(device, lr):
        trainer = LocalTrainer(cfg, rfl, device)
        meter = CommMeter()
        w0 = ravel_params(params_from_numpy(init, torch.device(device)))
        t0 = time.perf_counter()
        w = ring_optimization(trainer, w0, ring, lr=lr, laps=RING_LAPS,
                              local_epochs=1,
                              rng=np.random.default_rng(fl.seed), meter=meter)
        w = w.cpu()
        return w, meter, trainer.dispatches, time.perf_counter() - t0

    t_phase = time.perf_counter()
    fused_sgd_lanes.launches = 0
    with checked_sgd(fused_sgd_lanes, sgd_lanes_reference) as sgd:
        gpu, meter, steps, wall = run("cuda", fl.init_lr)
    n = fused_sgd_lanes.launches
    worst = 0.0 if sgd.worst is None else sgd.worst.item()
    cpu, cpu_meter, cpu_steps, cpu_wall = run("cpu", fl.init_lr)
    control = run("cuda", fl.init_lr * LR_CONTROL)[0]
    hops = ring_lap_hops(RING_K, RING_LAPS)
    err, err_c = (gpu - cpu).abs().max().item(), (control - cpu).abs().max(
        ).item()
    log(f"[ring] ring_optimization, {RING_K} clients x {RING_LAPS} laps, "
        f"E=1: GPU {wall * 1e3:.1f} ms, CPU {cpu_wall * 1e3:.1f} ms; {steps} "
        f"steps (CPU {cpu_steps}), fused_sgd launches {n}, each against its "
        f"plain version: max |diff| {worst:.3e} ({sgd.calls} checked); p2p "
        f"{meter.p2p} (CPU {cpu_meter.p2p}, ring_lap_hops {hops}); the model "
        f"GPU against CPU: max |diff| {err:.3e} (bound {RING_TOL}); control, "
        f"{LR_CONTROL}x the learning rate: {err_c:.3e}")
    check(n == steps == cpu_steps == sgd.calls and n > 0,
          f"ring loop: {n} fused_sgd launches, {sgd.calls} checked, for "
          f"{steps} steps (CPU {cpu_steps})")
    check(worst == 0.0, f"ring loop: a fused_sgd launch {worst} from its "
          "plain version")
    check(meter.p2p == cpu_meter.p2p == hops == meter.total_transfers,
          f"ring loop: p2p {meter.p2p} (CPU {cpu_meter.p2p}), expected "
          f"{hops}")
    check(err <= RING_TOL, f"ring loop: the GPU model {err} from the CPU's")
    check(err_c > RING_TOL, "ring loop: the bound does not tell the 1.03x "
          "learning rate from the CPU's run")
    log(f"[ring] phase 3c's ring loop in {time.perf_counter() - t_phase:.1f}s")
    return n


# Phase 3d, Table III's FedProx and HierFAVG rows (fl_tables.py::_fl:
# star baselines at E=5 and R=1, HierFAVG at E=1 and R=5). Each client
# holds 100 images, 4 batches of 32, so both take 20 SGD steps a round on
# the fused engine over 20 lanes: FedProx's cohort of all K clients for
# E=5, HierFAVG's (edge, device) pairs for 5 iterations of one epoch.
TABLE3 = {"fedprox": {"local_epochs": 5, "ring_rounds": 1, "mu": 0.01},
          "hieravg": {"local_epochs": 1, "ring_rounds": 5}}
TABLE3_SHAPE = (20, 199_210)
TABLE3_STEPS = 20               # fused_sgd launches a round of each
# the comm records of one round: FedProx's cohort both ways; HierFAVG's
# cloud exchange with each of the 5 edges and each edge's 5 iterations
# with its 4 devices both ways
TABLE3_COMM = {"fedprox": {"cloud_down": 20, "cloud_up": 20},
               "hieravg": {"cloud_down": 5, "edge_down": 100,
                           "edge_up": 100, "cloud_up": 5}}
# HierFAVG's first round, (fused_sgd launches, dispatches) under the
# per-round engines: sequential 20 lanes x 5 iterations x 4 steps, one
# dispatch a step; batched one call a hop (5) of 4 steps
HIER_ROUND1_COUNTS = {"sequential": (400, 400), "batched": (20, 5)}
# The control of ENGINE_ROUND1_TOL: the same round at a learning rate 3%
# larger moves the round-1 model by 1.6e-4 (FedProx) and 3.8e-4 (HierFAVG)
# on the CPU at full width, outside the bound; GPU against CPU and engine
# against engine must stay inside it.
LR_CONTROL = 1.03


def table3_path(run_experiment, fused_sgd_lanes, cfg, fl, init) -> int:
    """Phase 3d: FedProx and HierFAVG as Table III sets them, two rounds
    each on the fused engine, GPU then CPU, with phase 3's checks and the
    literal launch, dispatch and comm counts; each round-1 model on the GPU
    against the CPU's, and the learning-rate control outside the bound;
    HierFAVG's first round through the sequential and batched engines on
    the GPU against the fused engine's. Returns the ``fused_sgd`` launches
    of its GPU runs."""
    launches = 0
    round1 = {}
    hfl = dataclasses.replace(fl, algorithm="hieravg", rounds=2,
                              **TABLE3["hieravg"])
    for algorithm, kw in TABLE3.items():
        tfl = dataclasses.replace(fl, algorithm=algorithm, rounds=2, **kw)
        runs = main_path(run_experiment, fused_sgd_lanes, cfg, tfl, init,
                         eval_every=1, tag=algorithm)
        check_main_path(runs, 199_210, min_final_acc=None, tag=algorithm)
        gpu, blocks, n, _ = runs["cuda"]
        launches += n
        want = (TABLE3_STEPS * tfl.rounds, tfl.rounds)
        log(f"[{algorithm}] fused_sgd launches {n}, dispatches "
            f"{gpu.dispatches}; the literals {want} ({TABLE3_STEPS} launches "
            f"a round, one dispatch a block of one round)")
        check((n, gpu.dispatches) == want,
              f"{algorithm}: launches and dispatches {(n, gpu.dispatches)}, "
              f"expected {want}")
        lanes = {len(g.hops[0].ids) for _, sched in blocks
                 for p in sched.plans for g in p.groups}
        check(lanes == {TABLE3_SHAPE[0]},
              f"{algorithm}: groups of {lanes} lanes, not {TABLE3_SHAPE[0]}")
        per_round = TABLE3_COMM[algorithm]
        for _, sched in blocks:
            got = dict(sched.comm)
            want = {c: k * len(sched.plans) for c, k in per_round.items()}
            check(got == want, f"{algorithm}: block comm {got}, expected "
                  f"{want}")
        edge = per_round.get("edge_up", 0) + per_round.get("edge_down", 0)
        meters = [(r.comm["cloud_transfers"], r.comm["edge_transfers"])
                  for r in gpu.history]
        want = [(r * (per_round["cloud_down"] + per_round["cloud_up"]),
                 r * edge) for r in range(1, tfl.rounds + 1)]
        log(f"[{algorithm}] (cloud, edge) transfers at each eval {meters}, "
            f"expected {want}")
        check(meters == want, f"{algorithm}: comm meters {meters}, expected "
              f"{want}")
        first = {dev: run_experiment(task="mnist_like", model_cfg=cfg,
                                     fl=tfl, init_params=init, device=dev,
                                     stop_after=1).final_model
                 for dev in ("cuda", "cpu")}
        err = max_abs_diff(first["cuda"], first["cpu"])
        control = run_experiment(
            task="mnist_like", model_cfg=cfg, init_params=init,
            fl=dataclasses.replace(tfl, init_lr=tfl.init_lr * LR_CONTROL),
            device="cuda", stop_after=1).final_model
        err_c = max_abs_diff(control, first["cpu"])
        log(f"[{algorithm}] the global model after round 1, GPU against "
            f"CPU: max |diff| {err:.3e} (bound {ENGINE_ROUND1_TOL}; above "
            f"1e-6: {diff_spread(first['cuda'], first['cpu'])}); control, "
            f"the GPU round at {LR_CONTROL}x the learning rate: "
            f"{err_c:.3e} (must exceed the bound)")
        check(err <= ENGINE_ROUND1_TOL,
              f"{algorithm} round 1: GPU model {err} from the CPU's")
        check(err_c > ENGINE_ROUND1_TOL,
              f"{algorithm} round 1: the bound does not tell a "
              f"{LR_CONTROL}x learning rate from the CPU's round")
        if algorithm == "hieravg":
            round1["fused"] = first["cuda"]

    for engine in ("sequential", "batched"):
        blocks = []
        fused_sgd_lanes.launches = 0
        res = run_experiment(task="mnist_like", model_cfg=cfg,
                             fl=dataclasses.replace(hfl, engine=engine),
                             init_params=init, device="cuda", stop_after=1,
                             on_block=lambda t, s, b=blocks: b.append((t, s)))
        n = fused_sgd_lanes.launches
        launches += n
        derived = engine_counts(blocks, engine)
        want = HIER_ROUND1_COUNTS[engine]
        log(f"[hieravg/{engine}] round 1 on the GPU: fused_sgd launches {n}, "
            f"dispatches {res.dispatches}; the plans imply {derived}, the "
            f"literals {want}")
        check((n, res.dispatches) == derived == want,
              f"hieravg/{engine}: launches and dispatches "
              f"{(n, res.dispatches)}, plans {derived}, literals {want}")
        round1[engine] = res.final_model
    for a, b in (("sequential", "batched"), ("sequential", "fused"),
                 ("batched", "fused")):
        err = max_abs_diff(round1[a], round1[b])
        log(f"[table3] the GPU's round-1 HierFAVG model, {a} against {b}: "
            f"max |diff| {err:.3e} (bound {ENGINE_ROUND1_TOL}; above 1e-6: "
            f"{diff_spread(round1[a], round1[b])})")
        check(err <= ENGINE_ROUND1_TOL,
              f"round-1 HierFAVG models of the {a} and {b} engines {err} "
              f"apart on the GPU")
    return launches


# Phase 3e, Table II's MOON, SCAFFOLD and Centralized rows
# (fl_tables.py::table2_accuracy and _fl: the star settings E=5 and R=1 on
# fashionmnist_like at its default 200/40 images a class). Each client
# holds 100 images, 4 batches of 32, so a round is 20 SGD steps over the
# cohort of 20 lanes; Centralized pools the 2,000 images, 63 batches x 5
# epochs = 315 steps of one lane a round.
TABLE2_TASK = "fashionmnist_like"
TABLE2_KW = {"local_epochs": 5, "ring_rounds": 1}
TABLE2_ENGINES = {"moon": ("fused", "batched", "sequential"),
                  "scaffold": ("fused", "batched", "sequential"),
                  "centralized": ("fused",)}     # it ignores the engine
TABLE2_STEPS = 20        # SGD steps a round of a star cohort
# (fused_sgd launches, dispatches) a round: MOON's 20 steps at 20 lanes
# fused (one dispatch a block of one round) and batched (one call a hop),
# 400 one-lane steps sequential; SCAFFOLD's momentum-free update never
# launches the kernel, whatever use_fused_sgd says; Centralized one
# launch and one dispatch a step
TABLE2_COUNTS = {("moon", "fused"): (20, 1), ("moon", "batched"): (20, 1),
                 ("moon", "sequential"): (400, 400),
                 ("scaffold", "fused"): (0, 1),
                 ("scaffold", "batched"): (0, 1),
                 ("scaffold", "sequential"): (0, 400),
                 ("centralized", "fused"): (315, 315)}
# The 2-round models, GPU against CPU and engine against engine, are held
# at ENGINE_ROUND1_TOL; the same run at LR_CONTROL times the learning rate
# must land outside. At full width (scripts/engine_gap.py, seeds 0-2, on
# a CPU and on the card) a relative 1e-7 change of the initial
# weights moves MOON's model by up to 1.2e-5 and SCAFFOLD's by up to
# 7.7e-6, the control by 2.5e-4 to 3.2e-4 and 2.3e-4 to 2.4e-4.
# Centralized's one lane runs 630 steps in a chain: there the same change
# moves the 2-round model by up to 1.3e-3 (8 of 40 draws above 1e-4,
# seeds 0-4), the card's model lay 8.1e-3 from the CPU's at seed 2, and
# the control moves it by 1.6e-2 to 5.0e-2, so no bound on it tells a
# fault from rounding: it is logged. The Centralized model held at the
# bound is the first epoch of the pooled shard (63 steps, a run at E=1),
# where the same change moves it by up to 1.9e-5 (0 of 40 draws above
# 1e-4) and the control by 1.9e-3 to 4.9e-3. It holds for this path's
# seed 0 (3.0e-8 on the card), not for every seed: at seed 2 the card's
# first epoch lies 1.03e-3 from the CPU's, bit-close through step 8, then
# one ReLU of the second layer crosses its kink for one sample at step 9
# (5.6e-5, one unit of w1 and the sample's 59 active units of w0) and the
# chain grows it (scripts/step_gap.py).
CENTRALIZED_EPOCH = {"local_epochs": 1, "rounds": 1}
# SCAFFOLD's saved variates after round 2, GPU against CPU. c_i divides a
# lane's local difference by K_i * lr = 20 x 0.01, and one lane's local
# model moves more than the averaged global: a relative 1e-7 change of the
# initial weights moves the live c_i rows by up to 1.05e-3 and c by up to
# 7.7e-5, the 1.03x learning rate by 1.4e-2 to 1.6e-2 and 6.8e-4 to
# 1.1e-3 (same runs). The bounds sit between, about four times the one and
# a third of the other.
TABLE2_STATE_TOL = {"c": 3e-4, "ci": 5e-3}
# cloud transfers a round: the cohort both ways, SCAFFOLD's variate too
TABLE2_CLOUD = {"moon": 40, "scaffold": 80, "centralized": 0}
# device-resident state (K + 1 = 21 rows of 199,210 float32 a client
# stack, SCAFFOLD's server variate besides), plus the fused engine's
# fashionmnist_like data plane (6,280,080 bytes)
TABLE2_PEAK = {("moon", "fused"): 23_013_720,
               ("moon", "batched"): 16_733_640,
               ("moon", "sequential"): 16_733_640,
               ("scaffold", "fused"): 23_810_560,
               ("scaffold", "batched"): 17_530_480,
               ("scaffold", "sequential"): 17_530_480,
               ("centralized", "fused"): 0}


def saved_state(ckdir: str) -> dict:
    """The algorithm state in the checkpoint of ``ckdir`` as flat float32
    arrays: an unstacked model (SCAFFOLD's ``c``) as (P,), a client
    stack's saved rows as (n, P) in client order, its ids under
    ``"<field> ids"``."""
    from repro_torch.checkpoint.io import restore
    from repro_torch.core.executor import _unpack_state

    def flat(tree):
        return np.concatenate([np.asarray(tree[k], np.float32).reshape(-1)
                               for k in sorted(tree)])

    out = {}
    ck = _unpack_state(restore(f"{ckdir}/algo_state.msgpack"))
    for field, value in ck.items():
        if value and all(isinstance(k, int) for k in value):
            ids = sorted(value)
            out[field] = np.stack([flat(value[i]) for i in ids])
            out[f"{field} ids"] = ids
        else:
            out[field] = flat(value)
    return out


def state_diff(a: dict, b: dict) -> dict:
    """Largest |difference| of each state field of two ``saved_state``
    readings (their clients must match); inf where they do not."""
    out = {}
    for field in a:
        if field.endswith(" ids"):
            continue
        same = a.get(f"{field} ids") == b.get(f"{field} ids")
        out[field] = (float(np.abs(a[field] - b[field]).max()) if same
                      else float("inf"))
    return out


def table2_path(run_experiment, fused_sgd_lanes, cfg, fl, init) -> int:
    """Phase 3e: Table II's MOON and SCAFFOLD under the fused, batched and
    sequential engines and Centralized, two rounds each, GPU then CPU,
    with phase 3's checks and the literal launch, dispatch, comm and
    ``peak_device_bytes`` counts; each 2-round model on the GPU against
    the CPU's and, on the card, engine against engine, with the
    learning-rate control outside the bound; SCAFFOLD's saved variates on
    the GPU against the CPU's, with their own control; a MOON and a
    SCAFFOLD run on the fused engine checkpointed after round 1 and
    resumed, against the uninterrupted GPU run bit for bit (cuDNN
    deterministic, as phase 3b). Returns the ``fused_sgd`` launches of
    its checked GPU runs."""
    import tempfile

    launches = 0
    finals = {}
    run = dict(task=TABLE2_TASK, model_cfg=cfg, init_params=init,
               eval_every=1)
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for algorithm, engines in TABLE2_ENGINES.items():
                for engine in engines:
                    tag = f"{algorithm}/{engine}"
                    tfl = dataclasses.replace(fl, algorithm=algorithm,
                                              engine=engine, rounds=2,
                                              **TABLE2_KW)
                    state_dir = f"{tmp}/{algorithm}-{engine}"
                    runs = main_path(run_experiment, fused_sgd_lanes, cfg,
                                     tfl, init, task=TABLE2_TASK,
                                     eval_every=1, tag=tag,
                                     ckdir=state_dir)
                    per_round = TABLE2_COUNTS[algorithm, engine]
                    want = tuple(k * tfl.rounds for k in per_round)
                    check_main_path(
                        runs, 199_210, min_final_acc=None, tag=tag,
                        engine=engine,
                        counts=want if algorithm == "centralized" else None)
                    gpu, blocks, n, _ = runs["cuda"]
                    cpu = runs["cpu"][0]
                    launches += n
                    log(f"[{tag}] fused_sgd launches {n}, dispatches "
                        f"{gpu.dispatches}; the literals {want} "
                        f"({per_round} a round)")
                    check((n, gpu.dispatches) == want,
                          f"{tag}: launches and dispatches "
                          f"{(n, gpu.dispatches)}, expected {want}")
                    meters = [r.comm["cloud_transfers"] for r in gpu.history]
                    want = [TABLE2_CLOUD[algorithm] * r
                            for r in range(1, tfl.rounds + 1)]
                    peak = TABLE2_PEAK[algorithm, engine]
                    log(f"[{tag}] cloud transfers at each eval {meters}, "
                        f"expected {want}; peak_device_bytes GPU "
                        f"{gpu.peak_device_bytes}, CPU "
                        f"{cpu.peak_device_bytes}, expected {peak}; "
                        f"accuracies GPU "
                        f"{[round(r.accuracy, 4) for r in gpu.history]}, "
                        f"CPU {[round(r.accuracy, 4) for r in cpu.history]}")
                    check(meters == want, f"{tag}: cloud transfers {meters}, "
                          f"expected {want}")
                    check(gpu.peak_device_bytes == peak,
                          f"{tag}: peak_device_bytes {gpu.peak_device_bytes},"
                          f" expected {peak}")
                    err = max_abs_diff(gpu.final_model, cpu.final_model)
                    spread = diff_spread(gpu.final_model, cpu.final_model)
                    finals[algorithm, engine] = gpu.final_model
                    if algorithm == "centralized":
                        log(f"[{tag}] the 2-round model, GPU against CPU: "
                            f"max |diff| {err:.3e} (not bounded: a chain of "
                            f"630 steps; above 1e-6: {spread})")
                        first_epoch_check(run_experiment, tfl, run, tag)
                        continue
                    log(f"[{tag}] the 2-round model, GPU against CPU: max "
                        f"|diff| {err:.3e} (bound {ENGINE_ROUND1_TOL}; above "
                        f"1e-6: {spread})")
                    check(err <= ENGINE_ROUND1_TOL,
                          f"{tag}: 2-round GPU model {err} from the CPU's")
                    if engine != "fused":
                        continue
                    control = run_experiment(fl=dataclasses.replace(
                        tfl, init_lr=tfl.init_lr * LR_CONTROL),
                        device="cuda", checkpoint_dir=f"{tmp}/control",
                        checkpoint_every=tfl.rounds, **run)
                    err_c = max_abs_diff(control.final_model,
                                         cpu.final_model)
                    log(f"[{tag}] control, the GPU run at {LR_CONTROL}x the "
                        f"learning rate against the CPU's: max |diff| "
                        f"{err_c:.3e} (must exceed {ENGINE_ROUND1_TOL})")
                    check(err_c > ENGINE_ROUND1_TOL,
                          f"{tag}: the bound does not tell a {LR_CONTROL}x "
                          f"learning rate from the CPU's run")
                    if algorithm == "scaffold":
                        variates = {d: saved_state(f"{state_dir}/{d}")
                                    for d in ("cuda", "cpu")}
                        variates["control"] = saved_state(f"{tmp}/control")
                    resume_check(run_experiment, tfl, run, gpu,
                                 f"{tmp}/{tag}-resume", tag)
            for field, tol in TABLE2_STATE_TOL.items():
                got = state_diff(variates["cuda"], variates["cpu"])[field]
                ctl = state_diff(variates["control"], variates["cpu"])[field]
                rows = variates["cpu"].get(f"{field} ids")
                log(f"[scaffold] the saved {field!r} after round 2"
                    f"{'' if rows is None else f' ({len(rows)} live rows)'}"
                    f", GPU against CPU: max |diff| {got:.3e} (bound {tol}); "
                    f"control, the {LR_CONTROL}x learning rate's: {ctl:.3e} "
                    f"(must exceed the bound)")
                check(got <= tol, f"scaffold: {field} {got} from the CPU's")
                check(ctl > tol, f"scaffold: the bound does not tell a "
                      f"{LR_CONTROL}x learning rate's {field} from the CPU's")
    finally:
        torch.backends.cudnn.deterministic = False
    for algorithm in ("moon", "scaffold"):
        for a, b in (("sequential", "batched"), ("sequential", "fused"),
                     ("batched", "fused")):
            err = max_abs_diff(finals[algorithm, a], finals[algorithm, b])
            log(f"[table2] the GPU's 2-round {algorithm} model, {a} against "
                f"{b}: max |diff| {err:.3e} (bound {ENGINE_ROUND1_TOL}; above "
                f"1e-6: {diff_spread(finals[algorithm, a], finals[algorithm, b])})")
            check(err <= ENGINE_ROUND1_TOL,
                  f"2-round {algorithm} models of the {a} and {b} engines "
                  f"{err} apart on the GPU")
    return launches


def first_epoch_check(run_experiment, fl, run, tag) -> None:
    """Centralized's model after the first epoch of the pooled shard (one
    round at E=1), GPU against CPU within ``ENGINE_ROUND1_TOL``, and the
    same round at ``LR_CONTROL`` times the learning rate outside it."""
    efl = dataclasses.replace(fl, **CENTRALIZED_EPOCH)
    first = {dev: run_experiment(fl=efl, device=dev, **run).final_model
             for dev in ("cuda", "cpu")}
    control = run_experiment(fl=dataclasses.replace(
        efl, init_lr=efl.init_lr * LR_CONTROL), device="cuda",
        **run).final_model
    err = max_abs_diff(first["cuda"], first["cpu"])
    err_c = max_abs_diff(control, first["cpu"])
    spread = diff_spread(first["cuda"], first["cpu"])
    log(f"[{tag}] the model after the first epoch (63 steps), GPU against "
        f"CPU: max |diff| {err:.3e} (bound {ENGINE_ROUND1_TOL}; above 1e-6: "
        f"{spread}); control, the GPU "
        f"epoch at {LR_CONTROL}x the learning rate: {err_c:.3e} (must "
        f"exceed the bound)")
    check(err <= ENGINE_ROUND1_TOL,
          f"{tag}: first-epoch GPU model {err} from the CPU's")
    check(err_c > ENGINE_ROUND1_TOL, f"{tag}: the bound does not tell a "
          f"{LR_CONTROL}x learning rate from the CPU's epoch")


def resume_check(run_experiment, fl, run, full, ckdir, tag) -> None:
    """A GPU run checkpointed after round 1 and resumed to the end must be
    the uninterrupted GPU run ``full`` bit for bit: weights, eval rounds,
    accuracies and comm (the state rides the checkpoint)."""
    run_experiment(fl=fl, device="cuda", checkpoint_dir=ckdir,
                   checkpoint_every=1, stop_after=1, **run)
    resumed = run_experiment(fl=fl, device="cuda", checkpoint_dir=ckdir,
                             resume=True, **run)
    same = all(torch.equal(full.final_model[k], resumed.final_model[k])
               for k in full.final_model)
    log(f"[{tag}] stop after round 1 and resume to round {fl.rounds} on the "
        f"GPU: final weights {'bit-equal to' if same else 'differ from'} the "
        f"uninterrupted run's (max |diff| "
        f"{max_abs_diff(full.final_model, resumed.final_model):.3e})")
    check(same and [(r.round, r.accuracy, r.comm) for r in full.history]
          == [(r.round, r.accuracy, r.comm) for r in resumed.history],
          f"{tag}: the resumed GPU run is not the uninterrupted one")


# Phase 3f, Table IV's K=100 fleet (fl_tables.py::table4_scalability at
# participation 0.2: a cohort of 20 clients a round) under the staged
# stores and the prefetch pipeline, on the fused engine with an eval every
# round, so every round is its own block and is staged again. Each client
# holds 20 images, one batch of 32: FedSR (E=1, R=5) runs rings of four,
# 20 hops of one step at 5 lanes a round; MOON (E=5, R=1) 5 steps at 20
# lanes, its (K + 1, P) state stack 80.5 MB resident against a (V + 1, P)
# staged carry of 16.7 MB.
TABLE4_KW = {"num_devices": 100, "num_edges": 25, "partition": "pathological",
             "xi": 2, "participation": 0.2, "rounds": 3}
TABLE4 = {"fedsr": {"local_epochs": 1, "ring_rounds": 5},
          "moon": {"local_epochs": 5, "ring_rounds": 1}}
TABLE4_RUNS = (("device", 0), ("host", 0), ("host", 1), ("stream", 0),
               ("stream", 1))
# fused_sgd launches of a 3-round run (one dispatch a round), and each
# run's peak_device_bytes and the trainer's h2d_bytes: the JAX package's
# and the port's on a CPU (scripts/table4_literals.py, which checks that
# the two agree). Device store: the fleet plane (6,280,400 bytes) and
# MOON's 101-row stack; host and stream: a 20-client cohort arena
# (1,256,400) and MOON's 21-row carry, two arenas at a prefetch's
# hand-over; their h2d_bytes add the three staged cohorts.
TABLE4_STEPS = {"fedsr": 60, "moon": 15}
TABLE4_PEAK = {("fedsr", "device", 0): 6_280_400,
               ("fedsr", "host", 0): 1_256_400,
               ("fedsr", "host", 1): 2_512_800,
               ("fedsr", "stream", 0): 1_256_400,
               ("fedsr", "stream", 1): 2_512_800,
               ("moon", "device", 0): 86_761_240,
               ("moon", "host", 0): 17_990_040,
               ("moon", "host", 1): 19_246_440,
               ("moon", "stream", 0): 17_990_040,
               ("moon", "stream", 1): 19_246_440}
TABLE4_H2D = {("fedsr", "device"): 39_972, ("fedsr", "host"): 3_809_172,
              ("fedsr", "stream"): 3_809_172, ("moon", "device"): 39_492,
              ("moon", "host"): 3_808_692, ("moon", "stream"): 3_808_692}
# The (host, 1) run's 3-round model GPU against CPU is held at
# ENGINE_ROUND1_TOL. On a CPU (scripts/table4_literals.py --gaps, initial
# seeds 0 and 1, three draws each) a relative 1e-7 change of the initial
# weights moves it by 8.9e-8 to 1.7e-5 (FedSR: two draws of seed 1 land on
# another of a round's few outcomes, ROADMAP C8) and 1.5e-7 to 1.2e-6
# (MOON), the 1.03x learning rate by 3.2e-4 to 5.6e-4 and 1.8e-4 to
# 2.9e-4.
# The allocator check's spin holds the current stream for about 0.5 s
# while the side stream stages two cohorts.
HAZARD_SPIN_CYCLES = 1_000_000_000


def table4_path(run_experiment, fused_sgd_lanes, cfg, fl, init) -> int:
    """Phase 3f: FedSR and MOON at Table IV's K=100 on the fused engine
    under each (store, prefetch) of ``TABLE4_RUNS``, three rounds each on
    the GPU; the (host, 1) run also on the CPU with phase 3's checks.
    Every GPU run must equal the (device, 0) run bit for bit (final model,
    accuracies, comm), launch ``fused_sgd`` ``TABLE4_STEPS`` times, as its
    plans imply, and meter the literal ``peak_device_bytes`` and
    ``h2d_bytes``; the staged runs must have staged, and the pipelined ones
    hidden some of it. The (host, 1) model GPU against CPU within
    ``ENGINE_ROUND1_TOL``, the 1.03x learning rate outside. Logs each run's
    steady rounds (rounds 2 and 3 of its history) and its staging wall.
    Returns the ``fused_sgd`` launches of its GPU runs."""
    launches = 0
    for algorithm, kw in TABLE4.items():
        base = None
        for store, prefetch in TABLE4_RUNS:
            tag = f"{algorithm}/{store}/{prefetch}"
            tfl = dataclasses.replace(fl, algorithm=algorithm, store=store,
                                      prefetch=prefetch, **TABLE4_KW, **kw)
            if (store, prefetch) == ("host", 1):
                runs = main_path(run_experiment, fused_sgd_lanes, cfg, tfl,
                                 init, eval_every=1, tag=tag)
                check_main_path(runs, 199_210, min_final_acc=None, tag=tag)
                gpu, blocks, n, _ = runs["cuda"]
                cpu = runs["cpu"][0]
            else:
                blocks = []
                fused_sgd_lanes.launches = 0
                gpu = run_experiment(
                    task="mnist_like", model_cfg=cfg, fl=tfl, eval_every=1,
                    init_params=init, device="cuda",
                    on_block=lambda t, s, b=blocks: b.append((t, s)))
                n = fused_sgd_lanes.launches
            launches += n
            derived = engine_counts(blocks, "fused")
            want = (TABLE4_STEPS[algorithm], tfl.rounds)
            peak = TABLE4_PEAK[algorithm, store, prefetch]
            h2d = TABLE4_H2D[algorithm, store]
            log(f"[{tag}] fused_sgd launches {n}, dispatches "
                f"{gpu.dispatches}; the plans imply {derived}, the literals "
                f"{want}; peak_device_bytes {gpu.peak_device_bytes} "
                f"(literal {peak}), h2d_bytes {gpu.h2d_bytes} (literal "
                f"{h2d}); accuracies "
                f"{[round(r.accuracy, 4) for r in gpu.history]}")
            check((n, gpu.dispatches) == derived == want,
                  f"{tag}: launches and dispatches {(n, gpu.dispatches)}, "
                  f"plans {derived}, literals {want}")
            check(gpu.peak_device_bytes == peak,
                  f"{tag}: peak_device_bytes {gpu.peak_device_bytes}, "
                  f"expected {peak}")
            check(gpu.h2d_bytes == h2d,
                  f"{tag}: h2d_bytes {gpu.h2d_bytes}, expected {h2d}")
            steady = [r.seconds * 1e3 / r.rounds for r in gpu.history[1:]]
            log(f"[{tag}] steady rounds (2 and 3) "
                + ", ".join(f"{ms:.2f}" for ms in steady) + " ms; staging "
                f"{gpu.stage_seconds * 1e3:.3f} ms, of it hidden by a "
                f"prefetch {gpu.overlapped_stage_seconds * 1e3:.3f} ms "
                f"(overlap_fraction {gpu.overlap_fraction:.3f}); dispatch "
                f"to fence {gpu.dispatch_seconds * 1e3:.2f} ms")
            check(gpu.stage_seconds > 0, f"{tag}: nothing was staged")
            check((gpu.overlapped_stage_seconds > 0)
                  == (prefetch == 1 and store != "device"),
                  f"{tag}: overlapped_stage_seconds "
                  f"{gpu.overlapped_stage_seconds} under prefetch={prefetch}")
            if base is None:
                base = gpu
                continue
            same = all(torch.equal(gpu.final_model[k], base.final_model[k])
                       for k in base.final_model)
            log(f"[{tag}] against (device, 0) on the GPU: final model "
                f"{'bit-equal' if same else 'differs'} (max |diff| "
                f"{max_abs_diff(gpu.final_model, base.final_model):.3e})")
            check(same and [(r.round, r.accuracy, r.comm)
                            for r in gpu.history]
                  == [(r.round, r.accuracy, r.comm) for r in base.history],
                  f"{tag}: the run is not the (device, 0) run bit for bit")
            if (store, prefetch) != ("host", 1):
                continue
            check(gpu.peak_device_bytes <= 2 * TABLE4_PEAK[
                algorithm, store, 0], f"{tag}: the prefetch peak is more "
                f"than twice the serial one")
            err = max_abs_diff(gpu.final_model, cpu.final_model)
            control = run_experiment(
                task="mnist_like", model_cfg=cfg, init_params=init,
                eval_every=1, device="cuda",
                fl=dataclasses.replace(tfl, init_lr=tfl.init_lr * LR_CONTROL))
            err_c = max_abs_diff(control.final_model, cpu.final_model)
            log(f"[{tag}] the 3-round model, GPU against CPU: max |diff| "
                f"{err:.3e} (bound {ENGINE_ROUND1_TOL}; above 1e-6: "
                f"{diff_spread(gpu.final_model, cpu.final_model)}); "
                f"control, the GPU run at {LR_CONTROL}x the learning rate: "
                f"{err_c:.3e} (must exceed the bound)")
            check(err <= ENGINE_ROUND1_TOL,
                  f"{tag}: 3-round GPU model {err} from the CPU's")
            check(err_c > ENGINE_ROUND1_TOL,
                  f"{tag}: the bound does not tell a {LR_CONTROL}x learning "
                  f"rate from the CPU's run")
    allocator_hazard_check()
    h2d_rates()
    staging_times()
    return launches


def _hazard_clients():
    """100 clients of 20 images of the paper MLP's 784 inputs, every pixel
    of client i equal to i + 1: cohorts of equal size and unlike sums."""
    from repro_torch.data.pipeline import ClientData

    return [ClientData(i, np.full((20, 28, 28, 1), i + 1.0, np.float32),
                       np.full(20, i % 10, np.int64)) for i in range(100)]


def hazard_sequence(st, a_ids, b_ids, c_ids):
    """Stage cohort A, hold the current stream with a spin, queue a read
    of A (its sum), then prefetch and take cohort B (which drops A) and
    prefetch cohort C of A's size. Returns A's sum read after the spin,
    its host sum, whether C landed at A's old address, and whether the
    spin still held the stream when C's staging was done (else the
    sequence proves nothing)."""
    plane = st.arena(a_ids)
    a_ptr = plane.images.data_ptr()
    want = float(sum(20 * 784 * (i + 1.0) for i in a_ids))
    torch.cuda.synchronize()
    torch.cuda._sleep(HAZARD_SPIN_CYCLES)
    got = plane.images.double().sum()
    held = torch.cuda.Event()
    held.record()
    del plane
    st.prefetch(b_ids)
    st.arena(b_ids)                     # drops A's arena
    st.prefetch(c_ids)
    c_plane = st._stager._pending[1].result()[0]
    live = not held.query()
    reused = c_plane.images.data_ptr() == a_ptr
    del c_plane
    got = float(got)                    # waits for the spin and the sum
    torch.cuda.synchronize()
    return got, want, reused, live


def hazard_run(record_stream: bool = True):
    """``hazard_sequence`` on a host store of ``_hazard_clients``, once to
    warm the allocators (a first cudaMalloc or cudaHostAlloc may wait for
    the device, and so for the spin) and once measured; returns both
    readings. ``record_stream=False`` replaces the hand-over's
    ``record_stream`` with nothing, as a control."""
    from repro_torch.data import store as store_mod

    st = store_mod.HostStore(_hazard_clients(), "cuda")
    orig = store_mod.Stager._hand_over

    def no_record(self, plane, event):
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    if not record_stream:
        store_mod.Stager._hand_over = no_record
    try:
        warm = hazard_sequence(st, *(np.arange(k, k + 20)
                                     for k in (0, 20, 40)))
        measured = hazard_sequence(st, *(np.arange(k, k + 20)
                                         for k in (60, 80, 0)))
    finally:
        store_mod.Stager._hand_over = orig
        st.close()
    return warm, measured


def allocator_hazard_check() -> None:
    """Phase 3f's direct check of ``record_stream`` at the hand-over: A's
    sum, read after the spin, must equal its host sum, with the spin still
    holding the stream when C was staged. The same sequence without
    ``record_stream`` is logged, not checked (whether the allocator reuses
    A's block at once is its own choice)."""
    for record_stream in (True, False):
        what = ("with record_stream" if record_stream else
                "control, the hand-over without record_stream")
        for name, (got, want, reused, live) in zip(
                ("warm-up", "measured"), hazard_run(record_stream)):
            log(f"[table4] allocator hazard, {what}, {name}: cohort A's "
                f"sum read after the spin {got:.1f}, its host sum "
                f"{want:.1f} ({'intact' if got == want else 'corrupted'}); "
                f"the spin {'still held' if live else 'no longer held'} "
                f"the stream when C was staged; C "
                f"{'took' if reused else 'did not take'} A's old address")
        if record_stream:
            check(live, "the allocator check's spin ended before the "
                  "prefetch staged C: the check proves nothing")
            check(got == want, f"the sum of a dropped arena, read on the "
                  f"current stream, changed under a prefetch: {got} "
                  f"against {want}")


def staging_times(reps: int = 10) -> None:
    """What one staged block costs the host, piece by piece, at phase 3f's
    sizes (medians of ``reps`` calls, each fenced): a 20-client cohort
    arena built by the host store (gather into page-locked buffers, copy
    on the side stream), and MOON's (V + 1, P) state carry staged from a
    (100, 199,210) host arena (``stage_rows``) and written back
    (``unstage_rows``: the readback and the host scatter)."""
    from repro_torch.core.state import stage_rows, unstage_rows
    from repro_torch.data.store import HostStore

    st = HostStore(_hazard_clients(), "cuda")
    arena = np.random.default_rng(0).standard_normal((100, 199_210),
                                                     dtype=np.float32)
    visited = np.arange(0, 100, 5)
    times = {"cohort arena": [], "stage_rows": [], "unstage_rows": []}
    try:
        for i in range(reps + 2):
            times["cohort arena"].append(st._stager._build(visited)[2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = stage_rows(arena, visited, "cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            unstage_rows(arena, visited, staged)
            t2 = time.perf_counter()
            times["stage_rows"].append(t1 - t0)
            times["unstage_rows"].append(t2 - t1)
    finally:
        st.close()
    log("[time] one staged block's pieces (medians of "
        f"{reps}, after 2 warm-up calls): "
        + ", ".join(f"{k} {1e3 * float(np.median(v[2:])):.3f} ms"
                    for k, v in times.items()))


def h2d_rates(reps: int = 20) -> None:
    """The H2D rate of one 20-client cohort arena (1,256,400 bytes) and of
    MOON's staged state carry (21 x 199,210 float32, 16,733,640 bytes),
    from page-locked and from pageable memory, by CUDA events: the median
    of ``reps`` copies."""
    for what, nbytes in (("one cohort arena", 1_256_400),
                         ("MOON's staged carry", 21 * 199_210 * 4)):
        rates = {}
        for kind in ("pinned", "pageable"):
            host = torch.empty(nbytes // 4, dtype=torch.float32,
                               pin_memory=kind == "pinned")
            dev = torch.empty_like(host, device="cuda")
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dev.copy_(host, non_blocking=kind == "pinned")
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = float(np.median(times))
            rates[kind] = (ms, nbytes / ms / 1e6)
        log(f"[time] H2D of {what} ({nbytes:,} bytes): "
            + ", ".join(f"{k} {ms:.4f} ms ({gbs:.2f} GB/s)"
                        for k, (ms, gbs) in rates.items()))


# Phase 3g, the scenario curves (fl_tables.py::scenario_curves: drop30,
# straggle, stale) and the weighted_mean column of the attack grid
# (fl_tables.py::attack_defense_grid: signflip20, scale20, labelflip20;
# num_edges=10, so FedSR runs rings of 2) on the paper MLP at full width,
# K=20, pathological xi=2, fused, use_fused_sgd=True: 3 rounds in one block
# (eval_every=3) against the tables' 12 and 20 rounds. FedSR and HierFAVG
# at E=1, R=5, FedAvg at E=5, R=1 (fl_tables.py::_fl).
SCENARIOS_3G = {
    "drop30": dict(drop_rate=0.3),
    "straggle": dict(train_slow_frac=0.3, slow_step_factor=0.5,
                     rate_min=0.5, rate_max=2.0, transfer_seconds=0.05),
    "stale": dict(send_slow_frac=0.3, staleness_horizon=4,
                  staleness_decay=0.5, rate_min=0.5, rate_max=2.0,
                  transfer_seconds=0.05),
}
ATTACKS_3G = {
    "signflip20": dict(frac=0.2, kind="sign_flip"),
    "scale20": dict(frac=0.2, kind="scale", scale=10.0),
    "labelflip20": dict(frac=0.2, kind="label_flip"),
}
# Each run's (real SGD steps of each round's plans, the block's comm, the
# meter's simulated seconds, fused_sgd launches under the fused engine),
# from the JAX package's planners on a CPU (scripts/scenario_literals.py,
# which also holds the port's planners to them); and the batched engine's
# (launches, dispatches) of the two runs the phase also runs batched.
SCENARIO_LITERALS = {
    ("fedsr", "drop30"): (
        (280, 280, 280), {"cloud_down": 15, "cloud_up": 15,
         "p2p": 191}, 240.0, 240),
    ("fedavg", "drop30"): (
        (280, 280, 280), {"cloud_down": 60,
         "cloud_up": 42}, 60.0, 60),
    ("hieravg", "drop30"): (
        (280, 280, 280), {"cloud_down": 15, "cloud_up": 15,
         "edge_down": 210, "edge_up": 210}, 60.0, 60),
    ("fedsr", "straggle"): (
        (340, 340, 340), {"cloud_down": 15, "cloud_up": 15,
         "p2p": 285}, 285.814604977718, 240),
    ("fedavg", "straggle"): (
        (340, 340, 340), {"cloud_down": 60,
         "cloud_up": 60}, 111.05325644922218, 60),
    ("hieravg", "straggle"): (
        (340, 340, 340), {"cloud_down": 15, "cloud_up": 15,
         "edge_down": 300, "edge_up": 300}, 111.65325644922217, 60),
    ("fedsr", "stale"): (
        (400, 400, 400), {"cloud_down": 15, "cloud_up": 15,
         "p2p": 285}, 317.40792445292254, 240),
    ("fedavg", "stale"): (
        (400, 400, 400), {"cloud_down": 60,
         "cloud_up": 60}, 119.47217327470744, 60),
    ("hieravg", "stale"): (
        (400, 400, 400), {"cloud_down": 15, "cloud_up": 15,
         "edge_down": 300, "edge_up": 300}, 120.07217327470747, 60),
    ("fedsr", "signflip20"): (
        (400, 400, 400), {"cloud_down": 30, "cloud_up": 30,
         "p2p": 270}, 120.0, 120),
    ("fedavg", "signflip20"): (
        (400, 400, 400), {"cloud_down": 60,
         "cloud_up": 60}, 60.0, 60),
    ("fedsr", "scale20"): (
        (400, 400, 400), {"cloud_down": 30, "cloud_up": 30,
         "p2p": 270}, 120.0, 120),
    ("fedavg", "scale20"): (
        (400, 400, 400), {"cloud_down": 60,
         "cloud_up": 60}, 60.0, 60),
    ("fedsr", "labelflip20"): (
        (400, 400, 400), {"cloud_down": 30, "cloud_up": 30,
         "p2p": 270}, 120.0, 120),
    ("fedavg", "labelflip20"): (
        (400, 400, 400), {"cloud_down": 60,
         "cloud_up": 60}, 60.0, 60),
    ("hieravg", "scale20"): (
        (400, 400, 400), {"cloud_down": 30, "cloud_up": 30,
         "edge_down": 300, "edge_up": 300}, 60.0, 60),
}
SCENARIO_BATCHED = {("fedsr", "drop30"): (240, 60),
                    ("fedsr", "signflip20"): (120, 30)}
# The runs whose 3-round model GPU against CPU is held at
# ENGINE_ROUND1_TOL, the 1.03x learning rate landing outside, and those
# whose round-1 model is held so instead; the others' gap is logged, not
# checked (ROADMAP C7): no bound tells rounding there from the control.
# A run is held where, on a CPU (scripts/scenario_literals.py --gaps
# [--stop-after 1], initial seeds 0 and 1, three draws each), a relative
# 1e-7 change of the initial weights moves the model by at most half the
# bound and the 1.03x learning rate by at least 1.5 times it: the held
# 3-round models moved by up to 3.6e-5 (controls 3.3e-4 and more), the
# held round-1 models by up to 4.6e-5 (controls 1.6e-4 and more). Logged:
# FedSR under drop30 (5.5e-4 after 3 rounds, 2.2e-4 after round 1),
# signflip20 (1.2e-4, 9.7e-5) and labelflip20 (1.2e-4, 7.4e-5), and the
# scale attacks (1.3e-3 to 1.1e-2, 4.6e-4 to 2.9e-3): a round has a few
# discrete outcomes (ROADMAP C8), and a longer ring chain or a 10x delta
# reaches another of them from a rounding-size change.
SCENARIO_BOUNDED = {("hieravg", "drop30"), ("fedsr", "straggle"),
                    ("hieravg", "straggle"), ("fedavg", "stale"),
                    ("hieravg", "stale"), ("fedavg", "labelflip20")}
SCENARIO_ROUND1 = {("fedavg", "drop30"), ("fedavg", "straggle"),
                   ("fedsr", "stale"), ("fedavg", "signflip20")}


# Phase 3h, the robust defense columns of the attack grid
# (fl_tables.py::attack_defense_grid: DEFENSES median, trimmed_mean and krum
# with krum_f=4, trim_frac at its default 0.2) on phase 3g's attack runs:
# FedSR and FedAvg under each attack and reducer on the fused engine, FedSR
# under signflip20 with the median also on the batched engine, and
# HierFAVG under scale20 with the trimmed mean (its per-edge reduce).
REDUCERS_3H = ("median", "trimmed_mean", "krum")
ROBUST_RUNS = ([(a, k, r, "fused") for k in ATTACKS_3G for r in REDUCERS_3H
                for a in ("fedsr", "fedavg")]
               + [("fedsr", "signflip20", "median", "batched"),
                  ("hieravg", "scale20", "trimmed_mean", "fused")])
# Each run's (fused_sgd launches, dispatches, comm, H2D bytes, robust
# reduces), from the JAX package's planners and stacking code on a CPU
# (scripts/robust_literals.py, which also holds the port's to them).
ROBUST_LITERALS = {
    ('fedsr', 'signflip20', 'median', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156264, 3),
    ('fedavg', 'signflip20', 'median', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155544, 3),
    ('fedsr', 'signflip20', 'trimmed_mean', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156264, 3),
    ('fedavg', 'signflip20', 'trimmed_mean', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155544, 3),
    ('fedsr', 'signflip20', 'krum', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156264, 3),
    ('fedavg', 'signflip20', 'krum', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155544, 3),
    ('fedsr', 'scale20', 'median', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156264, 3),
    ('fedavg', 'scale20', 'median', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155544, 3),
    ('fedsr', 'scale20', 'trimmed_mean', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156264, 3),
    ('fedavg', 'scale20', 'trimmed_mean', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155544, 3),
    ('fedsr', 'scale20', 'krum', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156264, 3),
    ('fedavg', 'scale20', 'krum', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155544, 3),
    ('fedsr', 'labelflip20', 'median', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156144, 3),
    ('fedavg', 'labelflip20', 'median', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155304, 3),
    ('fedsr', 'labelflip20', 'trimmed_mean', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156144, 3),
    ('fedavg', 'labelflip20', 'trimmed_mean', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155304, 3),
    ('fedsr', 'labelflip20', 'krum', 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 156144, 3),
    ('fedavg', 'labelflip20', 'krum', 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60}, 155304, 3),
    ('fedsr', 'signflip20', 'median', 'batched'): (
        120, 30, {"cloud_down": 30, "cloud_up": 30, "p2p": 270}, 120577200, 3),
    ('hieravg', 'scale20', 'trimmed_mean', 'fused'): (
        60, 1, {"cloud_down": 30, "cloud_up": 30,
         "edge_down": 300, "edge_up": 300}, 159012, 15),
}


def robust_fl(fl, algorithm: str, attack: str, reducer: str,
              engine: str = "fused"):
    """Phase 3h's FLConfig of one run of ``ROBUST_RUNS``, from phase 3's
    ``fl``: phase 3g's attack run with the grid's reducer."""
    return dataclasses.replace(scenario_fl(fl, algorithm, attack),
                               reducer=reducer, krum_f=4, engine=engine)


def scenario_fl(fl, algorithm: str, name: str):
    """Phase 3g's FLConfig of one run, from phase 3's ``fl``: ``name`` is a
    scenario of ``SCENARIOS_3G``, an attack of ``ATTACKS_3G``, or ``sync``
    and ``sync10`` (neither, at the scenario and the attack runs' edges)."""
    from repro_torch.configs.base import AdversaryConfig, ScenarioConfig

    star = algorithm == "fedavg"
    kw = {}
    if name in SCENARIOS_3G:
        kw["scenario"] = ScenarioConfig(**SCENARIOS_3G[name])
    elif name in ATTACKS_3G:
        kw["adversary"] = AdversaryConfig(**ATTACKS_3G[name])
    edges = 10 if name in ATTACKS_3G or name == "sync10" else 5
    return dataclasses.replace(
        fl, algorithm=algorithm, rounds=3, num_edges=edges,
        local_epochs=5 if star else 1, ring_rounds=1 if star else 5, **kw)


def scenario_literal(sched) -> tuple:
    """A block's ``SCENARIO_LITERALS`` entry (``scenario_literals.py``'s
    ``literal``)."""
    steps = tuple(sum(sum(g.lane_steps()) for g in p.groups)
                  for p in sched.plans)
    sim = 0.0
    for p in sched.plans:
        sim += p.sim_seconds
    return (steps, dict(sched.comm), sim,
            engine_counts([(0, sched)], "fused")[0])


class checked_sgd:
    """Within the block, every ``fused_sgd`` launch on the card (the local
    trainer's call site) also runs the plain version on the same inputs
    first; the largest |difference| of the updated ``p`` and ``m`` stays
    on the device (``worst``) and the launches are counted (``calls``). The
    kernel's output goes on."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain = kernel, plain
        self.calls, self.worst = 0, None

    def __enter__(self):
        import repro_torch.core.local as local

        self.local, self.saved = local, local.fused_sgd_lanes

        def fn(p, grads, m, ok, lr, *, reset, momentum, nesterov=False):
            kw = dict(reset=reset, momentum=momentum, nesterov=nesterov)
            if p.device.type != "cuda":
                return self.kernel(p, grads, m, ok, lr, **kw)
            want_p, want_m = self.plain(p, grads, m, ok, lr, **kw)
            self.kernel(p, grads, m, ok, lr, **kw)
            d = torch.maximum((p - want_p).abs().max(),
                              (m - want_m).abs().max())
            self.worst = d if self.worst is None else torch.maximum(
                self.worst, d)
            self.calls += 1
        local.fused_sgd_lanes = fn
        return self

    def __exit__(self, *exc):
        self.local.fused_sgd_lanes = self.saved


# Phase 3g's CPU runs go to a pool of spawned workers while the GPU runs
# proceed: one after another the 16 full-width CPU runs took 54.8 s of the
# phase's 77.8 s on an eight-core H100 host. The workers leave the parent
# two of its eight cores.
CPU_WORKERS, CPU_WORKER_THREADS = 2, 3
_CPU_TASK = {}      # a worker's shared inputs, set by _cpu_worker_init


def _cpu_worker_init(threads, cfg, init, train, test) -> None:
    torch.set_num_threads(threads)
    _CPU_TASK.update(task="mnist_like", model_cfg=cfg, init_params=init,
                     train=train, test=test)


def _cpu_run(fl, stop_after):
    """One phase 3g run on the CPU, in a worker: ``(result, blocks,
    launches, wall)`` as ``main_path`` records a run (a CPU run launches
    no kernel), the final model as numpy arrays for the trip back."""
    from repro_torch.core.executor import run_experiment

    blocks = []
    t0 = time.perf_counter()
    res = run_experiment(fl=fl, eval_every=3, device="cpu",
                         stop_after=stop_after,
                         on_block=lambda t, s: blocks.append((t, s)),
                         **_CPU_TASK)
    res.final_model = {k: v.numpy() for k, v in res.final_model.items()}
    return res, blocks, 0, time.perf_counter() - t0


def steady_ms(res):
    """A run's steady rounds: every eval block's ms a round but the
    first's."""
    return [r.seconds * 1e3 / r.rounds for r in res.history[1:]]


def model_gap(run_experiment, task, tag, tfl, gpu_model, cpu_model,
              stop_after, bounded, control_fl=None,
              control_what=f"{LR_CONTROL}x the learning rate",
              tol=ENGINE_ROUND1_TOL):
    """The model GPU against CPU and the control's GPU model (the 1.03x
    learning rate, or ``control_fl``) against the CPU's, checked against
    ``tol`` (the control outside it) or logged. Returns the control run,
    an eval a round."""
    control = run_experiment(
        eval_every=1, device="cuda", stop_after=stop_after,
        fl=control_fl or dataclasses.replace(
            tfl, init_lr=tfl.init_lr * LR_CONTROL),
        **task)
    err = max_abs_diff(gpu_model, cpu_model)
    err_c = max_abs_diff(control.final_model, cpu_model)
    log(f"[{tag}] the model after round {stop_after}, GPU against CPU: "
        f"max |diff| {err:.3e} (bound {tol}, "
        f"{'checked' if bounded else 'logged, not checked (C7)'}; "
        f"above 1e-6: {diff_spread(gpu_model, cpu_model)}); control, "
        f"the GPU run at {control_what}: {err_c:.3e}")
    if bounded:
        check(err <= tol, f"{tag}: the GPU model after "
              f"round {stop_after} {err} from the CPU's")
        check(err_c > tol,
              f"{tag}: the bound does not tell {control_what} from the "
              f"CPU's run")
    return control


@contextlib.contextmanager
def cpu_pool(cfg, init, train, test):
    """The worker pool of phases 3g-3j's CPU runs, spawned, each worker
    with ``CPU_WORKER_THREADS`` threads and the phases' shared inputs. A
    worker that dies breaks the pool and raises at ``result()``, where a
    ``multiprocessing.Pool`` would start another and wait forever."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init,
            initargs=(CPU_WORKER_THREADS, cfg, init, train, test)) as pool:
        yield pool


def scenario_jobs(pool, fl) -> dict:
    """Phase 3g's CPU runs, submitted to ``pool``: ``{(key, stop_after):
    future}``."""
    return {(key, stop): pool.submit(_cpu_run, scenario_fl(fl, *key), stop)
            for key in SCENARIO_LITERALS
            for stop in ((None, 1) if key in SCENARIO_ROUND1 else (None,))}


def scenario_path(run_experiment, fused_sgd_lanes, cfg, fl, init, jobs,
                  train, test):
    """Phase 3g: every run of ``SCENARIO_LITERALS`` on the fused engine,
    GPU then CPU (the CPU runs in a worker pool meanwhile), with phase 3's
    checks (no accuracy floor) and each ``fused_sgd`` launch of the GPU
    runs held against its plain version; each run's block literal (step
    counts, comm, simulated seconds, launches) on both devices, one call a
    block; the 3-round model GPU against CPU within ``ENGINE_ROUND1_TOL``
    with the 1.03x learning rate outside for ``SCENARIO_BOUNDED``, the
    round-1 model for ``SCENARIO_ROUND1``, logged for the others; FedSR
    under drop30 and under signflip20 also on the batched engine,
    bit-equal to the fused run. Logs one steady round of each run (from
    its control run, an eval a round, once the pool is done) beside the
    same algorithm's synchronous round. ``jobs`` are its CPU runs in the
    pool (``scenario_jobs``), ``train``/``test`` the task every run shares
    (``run_experiment`` makes the same from the seed). Returns the
    ``fused_sgd`` launches of its checked GPU runs and the steady rounds
    by (algorithm, scenario or attack)."""
    from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference

    checked = checked_sgd(fused_sgd_lanes, sgd_lanes_reference)
    launches = 0
    steady = {}
    task = dict(task="mnist_like", model_cfg=cfg, init_params=init,
                train=train, test=test)
    runs = {key: scenario_fl(fl, *key) for key in SCENARIO_LITERALS}

    def gpu_vs_cpu(tag, tfl, gpu_model, cpu_model, stop_after, bounded):
        return model_gap(run_experiment, task, tag, tfl, gpu_model,
                         cpu_model, stop_after, bounded)

    gpu_runs, batched, first = {}, {}, {}
    t_pool = time.perf_counter()
    for key, tfl in runs.items():
        with checked:
            gpu_runs[key] = main_path(
                run_experiment, fused_sgd_lanes, cfg, tfl, init,
                eval_every=3, tag=f"3g {'/'.join(key)}",
                devices=("cuda",), train=train, test=test)["cuda"]
            if key in SCENARIO_BATCHED:
                bl = []
                fused_sgd_lanes.launches = 0
                res = run_experiment(
                    fl=dataclasses.replace(tfl, engine="batched"),
                    eval_every=3, device="cuda",
                    on_block=lambda t, s, b=bl: b.append((t, s)), **task)
                batched[key] = (res, bl, fused_sgd_lanes.launches)
        if key in SCENARIO_ROUND1:
            first[key] = run_experiment(fl=tfl, device="cuda",
                                        stop_after=1, **task)
    cpu_runs = {}
    for (key, stop), job in jobs.items():
        res, blocks, n, wall = job.result(timeout=600)
        res.final_model = {k: torch.from_numpy(v)
                           for k, v in res.final_model.items()}
        cpu_runs[key, stop] = (res, blocks, n, wall)
    log(f"[3g] GPU runs and the CPU pool ({CPU_WORKERS} workers x "
        f"{CPU_WORKER_THREADS} threads): {time.perf_counter() - t_pool:.1f}s; "
        f"CPU walls {sum(r[3] for r in cpu_runs.values()):.1f}s in all")

    for key, lit in SCENARIO_LITERALS.items():
        tag = f"3g {'/'.join(key)}"
        tfl = runs[key]
        gpu, blocks, n, _ = gpu_runs[key]
        cpu, cblocks, _, wall = cpu_runs[key, None]
        log(f"[{tag}] cpu: accuracies "
            f"{[round(r.accuracy, 4) for r in cpu.history]} "
            f"dispatches={cpu.dispatches} h2d_bytes={cpu.h2d_bytes} "
            f"wall={wall:.3f}s")
        check_main_path({"cuda": gpu_runs[key], "cpu": cpu_runs[key, None]},
                        199_210, min_final_acc=None, tag=tag)
        launches += n
        got = [scenario_literal(s) for _, s in blocks]
        log(f"[{tag}] steps a round {got[0][0]}, comm {got[0][1]}, "
            f"sim_seconds {got[0][2]!r}, fused_sgd launches {n}, dispatches "
            f"{gpu.dispatches}; accuracies GPU "
            f"{[round(r.accuracy, 4) for r in gpu.history]}, CPU "
            f"{[round(r.accuracy, 4) for r in cpu.history]}")
        check(got == [lit] == [scenario_literal(s) for _, s in cblocks],
              f"{tag}: blocks {got}, expected the literal {lit}")
        check((n, gpu.dispatches) == (lit[3], 1),
              f"{tag}: launches and dispatches {(n, gpu.dispatches)}")
        check(gpu.history[-1].comm["sim_seconds"] == lit[2]
              == cpu.history[-1].comm["sim_seconds"],
              f"{tag}: the meter's sim_seconds differ from {lit[2]}")
        if key in SCENARIO_BATCHED:
            bat, bl, nb = batched[key]
            launches += nb
            same = all(torch.equal(bat.final_model[k], gpu.final_model[k])
                       for k in gpu.final_model)
            want = SCENARIO_BATCHED[key]
            log(f"[{tag}/batched] fused_sgd launches {nb}, dispatches "
                f"{bat.dispatches}; the plans imply "
                f"{engine_counts(bl, 'batched')}, the literals {want}; final "
                f"model against the fused engine's on the GPU "
                f"{'bit-equal' if same else 'differs'} (max |diff| "
                f"{max_abs_diff(bat.final_model, gpu.final_model):.3e})")
            check((nb, bat.dispatches) == engine_counts(bl, "batched")
                  == want, f"{tag}/batched: launches and dispatches "
                  f"{(nb, bat.dispatches)}, expected {want}")
            check(same, f"{tag}: batched is not the fused run bit for bit "
                  f"on the GPU")
        # the control runs an eval a round, so it also times the rounds
        control = gpu_vs_cpu(tag, tfl, gpu.final_model, cpu.final_model, 3,
                             key in SCENARIO_BOUNDED)
        steady[key] = steady_ms(control)
        if key in SCENARIO_ROUND1:
            gpu_vs_cpu(tag, tfl, first[key].final_model,
                       cpu_runs[key, 1][0].final_model, 1, True)
        for k, v in cpu.final_model.items():
            check(bool(torch.isfinite(v).all()),
                  f"{tag}: non-finite CPU weights in {k}")
    worst = float(checked.worst) if checked.worst is not None else None
    log(f"[3g] fused_sgd against its plain version on each launch's inputs: "
        f"{checked.calls} launches, max |diff| {worst}")
    check(checked.calls == launches and worst == 0.0,
          f"3g: {checked.calls} checked launches of {launches}, max |diff| "
          f"{worst} from the plain version")
    want = (sum(lit[3] for lit in SCENARIO_LITERALS.values())
            + sum(n for n, _ in SCENARIO_BATCHED.values()))
    check(launches == want, f"3g: {launches} fused_sgd launches, the "
          f"literals sum to {want}")
    for algorithm in ("fedsr", "fedavg", "hieravg"):
        for edges in ("sync", "sync10"):
            steady[algorithm, edges] = steady_ms(run_experiment(
                eval_every=1, device="cuda",
                fl=scenario_fl(fl, algorithm, edges), **task))
    for (algorithm, name), ms in steady.items():
        if name.startswith("sync"):
            continue
        sync = steady[algorithm, "sync10" if name in ATTACKS_3G else "sync"]
        log(f"[3g/time] {algorithm}/{name}: steady rounds (2 and 3) "
            + ", ".join(f"{v:.2f}" for v in ms) + " ms; synchronous "
            + ", ".join(f"{v:.2f}" for v in sync) + " ms (same call)")
    return launches, steady


# Phase 3h's checks of each robust reduce on the card against robust_agg on
# a CPU copy of its inputs: the median bit-equal (its position weights are
# 0.5 and 1, so its contraction rounds once whatever the order); the
# trimmed mean within ROBUST_TRIM_TOL of the valid lanes' largest |value|
# (its 1/(m - 2k) weights sum in each device's order); Krum the same lane
# where the CPU's two lowest scores lie more than KRUM_MARGIN times the
# rounding apart (the largest |difference| of the two sides' scores on the
# same lanes), and logged where they lie closer (ROADMAP C1, C7).
ROBUST_TRIM_TOL = 1e-6
KRUM_MARGIN = 2.0
# The runs whose 3-round model GPU against CPU is held at
# ENGINE_ROUND1_TOL, the 1.03x learning rate landing outside; the others'
# gap is logged (ROADMAP C7). Chosen as phase 3g's are: on a CPU
# (scripts/robust_literals.py --gaps, initial seeds 0 and 1, three draws
# each) a relative 1e-7 change of the initial weights moves a held run's
# model by at most half the bound and the 1.03x learning rate by at least
# 1.5 times it. The held Krum runs moved by at most 1.3e-7 (controls
# 5.6e-4 and more), the held FedAvg trimmed means by up to 3.9e-5
# (controls 3.7e-4 and more); the medians, FedSR's trimmed means and its
# label-flip Krum run (another lane picked in one draw: 9.0e-4) moved by
# 1.2e-5 to 4.1e-3. HierFAVG's scale20 trimmed mean moved its accuracy by
# 0.1475 and 0.055 (every other run by 0.0075 at most), so its accuracy
# is logged, not held at 0.02.
ROBUST_BOUNDED = {
    ("fedsr", "signflip20", "krum", "fused"),
    ("fedavg", "signflip20", "krum", "fused"),
    ("fedsr", "scale20", "krum", "fused"),
    ("fedavg", "scale20", "krum", "fused"),
    ("fedavg", "labelflip20", "krum", "fused"),
    ("fedavg", "signflip20", "trimmed_mean", "fused"),
    ("fedavg", "labelflip20", "trimmed_mean", "fused"),
}
ROBUST_ACC_LOGGED = {("hieravg", "scale20", "trimmed_mean", "fused")}


def robust_check(agg, lanes, wm, gw, reducer, trim_frac, krum_f, out):
    """One robust reduce on the card against ``agg`` (``robust_agg``) on a
    CPU copy of its inputs: a dict with ``ok``, the largest |difference|
    ``err``, the valid lanes' largest |value| ``scale`` and, for Krum,
    each group's selected lane on both sides (``picks``, ``cpu_picks``),
    the CPU's smallest margin between two lowest scores and the
    rounding."""
    from repro_torch.core.robust import krum_scores

    c = lanes.cpu()
    cwm = torch.as_tensor(wm).cpu()
    want = agg(c, cwm, None if gw is None else torch.as_tensor(gw).cpu(),
               reducer, trim_frac, krum_f)
    got = out.cpu()
    mask = cwm > 0
    scale = (float(c[mask.any(0)].abs().max()) if bool(mask.any())
             else 0.0)
    rec = {"reducer": reducer, "err": float((got - want).abs().max()),
           "scale": scale, "picks": ()}
    if reducer == "median":
        rec["ok"] = torch.equal(got, want)
    elif reducer == "trimmed_mean":
        rec["ok"] = rec["err"] <= ROBUST_TRIM_TOL * scale
    else:
        s_cpu = krum_scores(c, mask, krum_f)
        s_gpu = krum_scores(lanes, mask.to(lanes.device), krum_f).cpu()
        fin = torch.isfinite(s_cpu)
        rounding = (float((s_gpu - s_cpu)[fin].abs().max())
                    if bool(fin.any()) else 0.0)
        top = torch.sort(s_cpu, dim=1).values
        m = mask.sum(dim=1)
        margin = min((float(top[g, 1] - top[g, 0])
                      for g in range(len(m)) if m[g] >= 2),
                     default=float("inf"))
        rec.update(picks=tuple(s_gpu.argmin(1).tolist()),
                   cpu_picks=tuple(s_cpu.argmin(1).tolist()),
                   margin=margin, rounding=rounding,
                   held=margin > KRUM_MARGIN * rounding)
        rec["ok"] = (torch.equal(got, want)
                     if rec["picks"] == rec["cpu_picks"] else not rec["held"])
    return rec


class checked_robust:
    """Within the block, every robust reduce on the card (the local
    trainer's call site) is also held against ``robust_agg`` on a CPU copy
    of its inputs (``robust_check``); the records (``records``) and the
    card's reduces (``calls``) are kept. The card's output goes on."""

    def __init__(self):
        self.calls, self.records = 0, []

    def __enter__(self):
        import repro_torch.core.local as local

        self.local, self.saved = local, local.robust_agg

        def fn(lanes, wm, gw, reducer, trim_frac=0.0, krum_f=0):
            out = self.saved(lanes, wm, gw, reducer, trim_frac, krum_f)
            if lanes.device.type == "cuda":
                self.calls += 1
                self.records.append(robust_check(
                    self.saved, lanes, wm, gw, reducer, trim_frac, krum_f,
                    out))
            return out
        local.robust_agg = fn
        return self

    def __exit__(self, *exc):
        self.local.robust_agg = self.saved


def _cpu_run_robust(fl):
    """One phase 3h run on the CPU, in a worker: ``_cpu_run``'s tuple and
    each robust reduce's Krum picks (a tuple of selected lanes a reduce,
    empty for the order statistics), as ``robust_check`` reads them."""
    import repro_torch.core.local as local
    from repro_torch.core.robust import krum_scores

    saved, picks = local.robust_agg, []

    def fn(lanes, wm, gw, reducer, trim_frac=0.0, krum_f=0):
        if reducer == "krum":
            mask = torch.as_tensor(wm) > 0
            picks.append(tuple(krum_scores(lanes, mask, krum_f)
                               .argmin(1).tolist()))
        else:
            picks.append(())
        return saved(lanes, wm, gw, reducer, trim_frac, krum_f)
    local.robust_agg = fn
    try:
        return _cpu_run(fl, None) + (picks,)
    finally:
        local.robust_agg = saved


def robust_jobs(pool, fl) -> dict:
    """Phase 3h's CPU runs (the fused ones), submitted to ``pool``."""
    return {run: pool.submit(_cpu_run_robust, robust_fl(fl, *run))
            for run in ROBUST_RUNS if run[3] == "fused"}


def robust_path(run_experiment, fused_sgd_lanes, cfg, fl, init, jobs,
                train, test, wmean_steady) -> int:
    """Phase 3h: every run of ``ROBUST_RUNS`` on the card, each fused run
    also on the CPU (``jobs``, in the pool), with phase 3's checks (no
    accuracy floor); each run's literal (``fused_sgd`` launches,
    dispatches, comm, H2D bytes, robust reduces; ``ROBUST_LITERALS``) on
    both devices; every ``fused_sgd`` launch of the GPU runs against its
    plain version and every robust reduce against ``robust_agg`` on a CPU
    copy of its inputs (``robust_check``); the 3-round model GPU against
    CPU within ``ENGINE_ROUND1_TOL`` with the 1.03x learning rate outside
    for ``ROBUST_BOUNDED``, logged for the others and for a Krum run whose
    GPU run picked other lanes than its CPU run (then its accuracy is
    logged too, as for ``ROBUST_ACC_LOGGED``); the batched run bit-equal
    to its fused run. Logs one
    steady round of each run (from its control run) beside the
    ``weighted_mean`` round under the same attack (``wmean_steady``, phase
    3g's, same call). Returns the ``fused_sgd`` launches of its GPU
    runs."""
    from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference

    checked = checked_sgd(fused_sgd_lanes, sgd_lanes_reference)
    robust = checked_robust()
    task = dict(task="mnist_like", model_cfg=cfg, init_params=init,
                train=train, test=test)
    gpu_runs, records = {}, {}
    t0 = time.perf_counter()
    for run in ROBUST_RUNS:
        n0 = len(robust.records)
        with checked, robust:
            gpu_runs[run] = main_path(
                run_experiment, fused_sgd_lanes, cfg, robust_fl(fl, *run),
                init, eval_every=3, tag=f"3h {'/'.join(run)}",
                devices=("cuda",), train=train, test=test)["cuda"]
        records[run] = robust.records[n0:]
    cpu_runs = {run: job.result(timeout=600) for run, job in jobs.items()}
    log(f"[3h] GPU runs and the CPU runs left in the pool: "
        f"{time.perf_counter() - t0:.1f}s; CPU walls "
        f"{sum(r[3] for r in cpu_runs.values()):.1f}s in all")

    def literal(res, blocks, n, n_reduces):
        comm = Counter()
        for _, sched in blocks:
            comm.update(dict(sched.comm))
        return (n, res.dispatches, dict(comm), res.h2d_bytes, n_reduces)

    launches, krum = 0, []
    for run, lit in ROBUST_LITERALS.items():
        tag = f"3h {'/'.join(run)}"
        tfl = robust_fl(fl, *run)
        gpu, blocks, n, _ = gpu_runs[run]
        recs = records[run]
        launches += n
        got = literal(gpu, blocks, n, len(recs))
        check(got == lit, f"{tag}: (launches, dispatches, comm, h2d_bytes, "
              f"reduces) {got}, the literal {lit}")
        bad = [r for r in recs if not r["ok"]]
        check(not bad, f"{tag}: {len(bad)} robust reduces disagree with "
              f"robust_agg on the CPU: {bad}")
        errs = ", ".join(
            f"{r['err']:.3e}" if r["reducer"] != "krum" else
            f"lanes {r['picks']} (CPU {r['cpu_picks']}, margin "
            f"{r['margin']:.4e}, rounding {r['rounding']:.4e})"
            for r in recs)
        log(f"[{tag}] literal {got}; the robust reduces against robust_agg "
            f"on a CPU copy (max |value| {max(r['scale'] for r in recs):.4f}"
            f"): {errs}; accuracies "
            f"{[round(r.accuracy, 4) for r in gpu.history]}")
        krum += [r for r in recs if r["reducer"] == "krum"]
        if run[3] == "batched":
            fused = gpu_runs[run[:3] + ("fused",)][0]
            same = all(torch.equal(gpu.final_model[k], fused.final_model[k])
                       for k in fused.final_model)
            log(f"[{tag}] final model against the fused engine's on the GPU "
                f"{'bit-equal' if same else 'differs'} (max |diff| "
                f"{max_abs_diff(gpu.final_model, fused.final_model):.3e})")
            check(same, f"{tag}: batched is not the fused run bit for bit")
            control = run_experiment(
                eval_every=1, device="cuda",
                fl=dataclasses.replace(tfl, init_lr=tfl.init_lr * LR_CONTROL),
                **task)
        else:
            cpu, cblocks, _, wall, cpicks = cpu_runs[run]
            cpu.final_model = {k: torch.from_numpy(v)
                               for k, v in cpu.final_model.items()}
            check(literal(cpu, cblocks, 0, len(cpicks))[1:] == lit[1:],
                  f"{tag}: the CPU run's literal differs from {lit}")
            flipped = [r["picks"] for r in recs] != cpicks
            if flipped:
                log(f"[{tag}] Krum picked other lanes on the GPU than on "
                    f"the CPU: GPU {[r['picks'] for r in recs]}, CPU "
                    f"{cpicks}; the model and the accuracies are logged, "
                    f"not checked (C7)")
            acc_logged = flipped or run in ROBUST_ACC_LOGGED
            if acc_logged:
                log(f"[{tag}] accuracy GPU against CPU logged, not checked "
                    f"(C7): {gpu.final_accuracy:.4f} against "
                    f"{cpu.final_accuracy:.4f}")
            log(f"[{tag}] cpu: accuracies "
                f"{[round(r.accuracy, 4) for r in cpu.history]} "
                f"dispatches={cpu.dispatches} h2d_bytes={cpu.h2d_bytes} "
                f"wall={wall:.3f}s")
            check_main_path({"cuda": gpu_runs[run],
                             "cpu": (cpu, cblocks, 0, wall)}, 199_210,
                            acc_tol=1.0 if acc_logged else 0.02,
                            min_final_acc=None, tag=tag)
            control = model_gap(run_experiment, task, tag, tfl,
                                gpu.final_model, cpu.final_model, 3,
                                run in ROBUST_BOUNDED and not flipped)
            for k, v in cpu.final_model.items():
                check(bool(torch.isfinite(v).all()),
                      f"{tag}: non-finite CPU weights in {k}")
        wm = wmean_steady.get(run[:2], [])
        log(f"[3h/time] {'/'.join(run)}: steady rounds (2 and 3) "
            + ", ".join(f"{v:.2f}" for v in steady_ms(control))
            + " ms; weighted_mean under the same attack (phase 3g, fused) "
            + ", ".join(f"{v:.2f}" for v in wm) + " ms (same call)")
    worst = float(checked.worst) if checked.worst is not None else None
    log(f"[3h] fused_sgd against its plain version on each launch's inputs: "
        f"{checked.calls} launches, max |diff| {worst}; robust reduces held "
        f"against robust_agg on the CPU: {robust.calls}")
    check(checked.calls == launches and worst == 0.0,
          f"3h: {checked.calls} checked launches of {launches}, max |diff| "
          f"{worst} from the plain version")
    want = sum(lit[0] for lit in ROBUST_LITERALS.values())
    check(launches == want, f"3h: {launches} fused_sgd launches, the "
          f"literals sum to {want}")
    reduces = sum(lit[4] for lit in ROBUST_LITERALS.values())
    check(robust.calls == reduces, f"3h: {robust.calls} robust reduces on "
          f"the card, the literals sum to {reduces}")
    if krum:
        ratio = min(r["margin"] / max(r["rounding"], 1e-30) for r in krum)
        log(f"[3h] Krum: {len(krum)} reduces, "
            f"{sum(r['picks'] != r['cpu_picks'] for r in krum)} picked "
            f"another lane on the same inputs; CPU score margins "
            f"{min(r['margin'] for r in krum):.4e} to "
            f"{max(r['margin'] for r in krum):.4e}, rounding up to "
            f"{max(r['rounding'] for r in krum):.4e}; the smallest margin "
            f"is {ratio:.1f}x its rounding")
    return launches


# Phase 3i, the DP-SGD row of the attack grid (fl_tables.py::
# attack_defense_grid: clip 1.0 and noise multiplier 1.1 on the honest
# fleet, num_edges=10, so FedSR runs rings of 2) on phase 3g's path, 3
# rounds in one block against the grid's 20: FedSR and FedAvg with the
# noise on, and each one's clip-only twin (dp_noise_mult=0), which alone
# can be held against the CPU run; FedSR's twin also on the batched and
# sequential engines.
DP_CLIP, DP_NOISE = 1.0, 1.1
DP_RUNS = (("fedsr", DP_NOISE, "fused"), ("fedavg", DP_NOISE, "fused"),
           ("fedsr", 0.0, "fused"), ("fedavg", 0.0, "fused"),
           ("fedsr", 0.0, "batched"), ("fedsr", 0.0, "sequential"))
# Each run's (fused_sgd launches, dispatches, comm, dp_epsilon, dp_delta),
# from the JAX package's planners and ledger on a CPU
# (scripts/dp_literals.py, which also holds the port's to them).
DP_LITERALS = {
    ('fedsr', 1.1, 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270},
        58.73899703869308, 1e-05),
    ('fedavg', 1.1, 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60},
        58.73899703869308, 1e-05),
    ('fedsr', 0.0, 'fused'): (
        120, 1, {"cloud_down": 30, "cloud_up": 30, "p2p": 270},
        float("inf"), 1e-05),
    ('fedavg', 0.0, 'fused'): (
        60, 1, {"cloud_down": 60, "cloud_up": 60},
        float("inf"), 1e-05),
    ('fedsr', 0.0, 'batched'): (
        120, 30, {"cloud_down": 30, "cloud_up": 30, "p2p": 270},
        float("inf"), 1e-05),
    ('fedsr', 0.0, 'sequential'): (
        1200, 1200, {"cloud_down": 30, "cloud_up": 30, "p2p": 270},
        float("inf"), 1e-05),
}
# The clip-only runs whose 3-round model GPU against CPU is held at
# ENGINE_ROUND1_TOL, the 1.03x clip landing outside. Chosen as phase 3g's
# are: on a CPU (scripts/dp_literals.py --gaps, initial seeds 0 and 1,
# three draws each) a relative 1e-7 change of the initial weights moved
# FedSR's model by at most 9.0e-6 and FedAvg's by at most 2.4e-6, the
# 1.03x clip by 2.9e-4 to 3.4e-4: the clip bound every lane-step of both,
# so a larger clip is a larger step.
DP_BOUNDED = {("fedsr", 0.0, "fused"), ("fedavg", 0.0, "fused")}
DP_CLIP_CONTROL = 1.03
DP_NOISE_SHAPE = (20, 199_210)      # FedAvg's 20 lanes of the paper MLP
DP_STD_TOL = 0.01


def dp_fl(fl, algorithm: str, noise: float, engine: str = "fused"):
    """Phase 3i's FLConfig of one run of ``DP_RUNS``, from phase 3's
    ``fl``: phase 3g's honest run at the attack runs' edges (``sync10``)
    with the grid's DP-SGD."""
    return dataclasses.replace(scenario_fl(fl, algorithm, "sync10"),
                               dp_clip=DP_CLIP, dp_noise_mult=noise,
                               engine=engine)


def dp_tag(run) -> str:
    algorithm, noise, engine = run
    return f"{algorithm}/{'noise' if noise else 'clip'}/{engine}"


class checked_dp:
    """Within the block, every DP transform on the card (the local
    trainer's call site) is counted (``calls``), with the lane-steps it
    saw (``lanes``, masked ones included) and those the clip bound
    (``clipped``, kept on the device until ``share`` reads it)."""

    def __init__(self):
        self.calls, self.lanes, self.clipped = 0, 0, None

    def __enter__(self):
        import repro_torch.core.local as local

        self.local, self.saved = local, local.dp_clip_noise_

        def fn(grads, clip, sigma, gen):
            fac = self.saved(grads, clip, sigma, gen)
            if fac.device.type == "cuda":
                self.calls += 1
                self.lanes += fac.numel()
                n = (fac < 1).sum()
                self.clipped = n if self.clipped is None else self.clipped + n
            return fac
        local.dp_clip_noise_ = fn
        return self

    def __exit__(self, *exc):
        self.local.dp_clip_noise_ = self.saved

    def share(self) -> float:
        return int(self.clipped) / self.lanes if self.lanes else 0.0


def dp_jobs(pool, fl) -> dict:
    """Phase 3i's CPU runs (the fused ones), submitted to ``pool``."""
    return {run: pool.submit(_cpu_run, dp_fl(fl, *run), None)
            for run in DP_RUNS if run[2] == "fused"}


def dp_noise_check() -> None:
    """The transform with a CUDA generator on a fixed (20, 199,210) stack
    of the paper MLP's six leaves (lane c scaled by (c + 1) / 20, so the
    clip binds some lanes and not others): the noise ``(out - clip(g)) /
    sigma`` over its n elements has |mean| < 5/sqrt(n), a std within
    ``DP_STD_TOL`` of 1 and a largest |correlation| between two lanes
    below 5/sqrt(P); the same seed draws the same noise bit for bit,
    another seed other noise. Logs the transform's time at this shape,
    noised and clip-only."""
    from repro_torch.core.local import dp_clip_noise_

    C, P = DP_NOISE_SHAPE
    base = torch.randn(DP_NOISE_SHAPE,
                       generator=torch.Generator().manual_seed(3)) * 0.01
    base *= torch.arange(1, C + 1).view(C, 1) / C
    base = base.cuda()
    sigma = DP_NOISE * DP_CLIP

    def run(seed, s):
        leaves = split_leaves(base, MLP_LEAVES)
        fac = dp_clip_noise_(leaves, DP_CLIP, s, torch.Generator(
            device="cuda").manual_seed(seed))
        return torch.cat([v.flatten(1) for v in leaves], 1), fac

    clipped, fac = run(0, 0.0)
    out, _ = run(0, sigma)
    again, _ = run(0, sigma)
    other, _ = run(1, sigma)
    z = (out.double() - clipped.double()) / sigma
    n = z.numel()
    mean, std = float(z.mean()), float(z.std())
    zc = z - z.mean(1, keepdim=True)
    cov = zc @ zc.T
    d = cov.diagonal().sqrt()
    corr = (cov / (d[:, None] * d[None, :])).cpu()
    off = float(corr[~torch.eye(C, dtype=torch.bool)].abs().max())
    bound = int((fac < 1).sum())
    log(f"[3i/noise] the transform with a CUDA generator on a fixed "
        f"{DP_NOISE_SHAPE} stack ({bound} of {C} lanes clipped): the "
        f"standardized noise over {n} elements has mean {mean:.3e} (bound "
        f"{5 / n ** 0.5:.3e}), std {std:.6f} (bound 1 +- {DP_STD_TOL}), "
        f"largest |correlation| between lanes {off:.3e} (bound "
        f"{5 / P ** 0.5:.3e}); the same seed again "
        f"{'bit-equal' if torch.equal(out, again) else 'DIFFERS'}")
    check(0 < bound < C, f"3i: the clip bound {bound} of {C} lanes")
    check(abs(mean) < 5 / n ** 0.5 and abs(std - 1) < DP_STD_TOL
          and off < 5 / P ** 0.5,
          f"3i: the CUDA noise's mean {mean}, std {std}, correlation {off}")
    check(torch.equal(out, again), "3i: the same seed drew other noise")
    check(not torch.equal(out, other), "3i: another seed drew the same "
          "noise")
    leaves = split_leaves(base, MLP_LEAVES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    noised = time_launch(lambda: dp_clip_noise_(leaves, DP_CLIP, sigma, gen))
    clip_only = time_launch(lambda: dp_clip_noise_(leaves, DP_CLIP, 0.0,
                                                   gen))
    log(f"[3i/time] the DP transform at {DP_NOISE_SHAPE} with the MLP's six "
        f"leaves (CUDA events, L2 flushed, median): {noised:.4f} ms noised, "
        f"{clip_only:.4f} ms clip-only")


def dp_path(run_experiment, fused_sgd_lanes, cfg, fl, init, jobs, train,
            test, wmean_steady) -> int:
    """Phase 3i: every run of ``DP_RUNS`` on the card, each fused run also
    on the CPU (``jobs``, in the pool), with phase 3's checks (no accuracy
    floor; the noised runs' accuracies logged, not held, since the two
    devices draw other noise); each run's literal (``fused_sgd``
    launches, dispatches, comm, ``dp_epsilon``, ``dp_delta``;
    ``DP_LITERALS``) on both devices; one DP transform a SGD step; every
    ``fused_sgd`` launch of the GPU runs against its plain version; each
    clip-only fused model GPU against CPU within ``ENGINE_ROUND1_TOL`` with
    the 1.03x clip outside for ``DP_BOUNDED``, logged for the others; the
    batched clip-only run bit-equal to its fused run (the sequential one's
    gap logged). Then ``dp_noise_check`` and a profiled round of FedSR
    with and without DP-SGD: the kernels the transform adds a step. Logs
    the share of lane-steps the clip bound and one steady round of each
    run beside phase 3g's ``weighted_mean`` round of the same honest
    fleet (``wmean_steady``, same call). Returns the ``fused_sgd``
    launches of its GPU runs."""
    from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference

    checked = checked_sgd(fused_sgd_lanes, sgd_lanes_reference)
    task = dict(task="mnist_like", model_cfg=cfg, init_params=init,
                train=train, test=test)
    gpu_runs, transforms = {}, {}
    t0 = time.perf_counter()
    for run in DP_RUNS:
        with checked, checked_dp() as dp:
            gpu_runs[run] = main_path(
                run_experiment, fused_sgd_lanes, cfg, dp_fl(fl, *run), init,
                eval_every=3, tag=f"3i {dp_tag(run)}", devices=("cuda",),
                train=train, test=test)["cuda"]
        transforms[run] = (dp.calls, dp.lanes, dp.share())
    cpu_runs = {run: job.result(timeout=600) for run, job in jobs.items()}
    log(f"[3i] GPU runs and the CPU runs left in the pool: "
        f"{time.perf_counter() - t0:.1f}s; CPU walls "
        f"{sum(r[3] for r in cpu_runs.values()):.1f}s in all")

    def literal(res, blocks, n):
        comm = Counter()
        for _, sched in blocks:
            comm.update(dict(sched.comm))
        return (n, res.dispatches, dict(comm), res.dp_epsilon, res.dp_delta)

    launches = 0
    for run, lit in DP_LITERALS.items():
        tag = f"3i {dp_tag(run)}"
        tfl = dp_fl(fl, *run)
        gpu, blocks, n, _ = gpu_runs[run]
        launches += n
        got = literal(gpu, blocks, n)
        check(got == lit, f"{tag}: (launches, dispatches, comm, dp_epsilon, "
              f"dp_delta) {got}, the literal {lit}")
        calls, lanes, share = transforms[run]
        log(f"[{tag}] literal {got}; {calls} DP transforms on the card over "
            f"{lanes} lane-steps, the clip bound {share:.4f} of them (masked "
            f"lane-steps included); accuracies "
            f"{[round(r.accuracy, 4) for r in gpu.history]}")
        check(calls == n, f"{tag}: {calls} DP transforms, {n} SGD steps")
        if run[2] != "fused":
            fused = gpu_runs[run[:2] + ("fused",)][0]
            same = all(torch.equal(gpu.final_model[k], fused.final_model[k])
                       for k in fused.final_model)
            log(f"[{tag}] final model against the fused engine's on the GPU "
                f"{'bit-equal' if same else 'differs'} (max |diff| "
                f"{max_abs_diff(gpu.final_model, fused.final_model):.3e})")
            if run[2] == "batched":
                check(same, f"{tag}: batched is not the fused run bit for "
                      f"bit")
            continue
        cpu, cblocks, _, wall = cpu_runs[run]
        cpu.final_model = {k: torch.from_numpy(v)
                           for k, v in cpu.final_model.items()}
        check(literal(cpu, cblocks, 0)[1:] == lit[1:],
              f"{tag}: the CPU run's literal differs from {lit}")
        log(f"[{tag}] cpu: accuracies "
            f"{[round(r.accuracy, 4) for r in cpu.history]} "
            f"dispatches={cpu.dispatches} h2d_bytes={cpu.h2d_bytes} "
            f"dp_epsilon={cpu.dp_epsilon!r} wall={wall:.3f}s")
        noised = run[1] > 0
        check_main_path({"cuda": gpu_runs[run], "cpu": cpu_runs[run]},
                        199_210, acc_tol=1.0 if noised else 0.02,
                        min_final_acc=None, tag=tag)
        if noised:
            log(f"[{tag}] GPU against CPU, logged, not checked (the two "
                f"devices' generators draw other noise): final accuracy "
                f"{gpu.final_accuracy:.4f} against "
                f"{cpu.final_accuracy:.4f}, model max |diff| "
                f"{max_abs_diff(gpu.final_model, cpu.final_model):.3e}")
            timed = run_experiment(eval_every=1, device="cuda", fl=tfl,
                                   **task)
        else:
            timed = model_gap(
                run_experiment, task, tag, tfl, gpu.final_model,
                cpu.final_model, 3, run in DP_BOUNDED,
                control_fl=dataclasses.replace(
                    tfl, dp_clip=DP_CLIP * DP_CLIP_CONTROL),
                control_what=f"{DP_CLIP_CONTROL}x the clip")
        wm = wmean_steady.get((run[0], "sync10"), [])
        log(f"[3i/time] {dp_tag(run)}: steady rounds (2 and 3) "
            + ", ".join(f"{v:.2f}" for v in steady_ms(timed))
            + " ms; weighted_mean without DP (phase 3g, sync10) "
            + ", ".join(f"{v:.2f}" for v in wm) + " ms (same call)")
    worst = float(checked.worst) if checked.worst is not None else None
    log(f"[3i] fused_sgd against its plain version on each launch's inputs: "
        f"{checked.calls} launches, max |diff| {worst}")
    check(checked.calls == launches and worst == 0.0,
          f"3i: {checked.calls} checked launches of {launches}, max |diff| "
          f"{worst} from the plain version")
    want = sum(lit[0] for lit in DP_LITERALS.values())
    check(launches == want, f"3i: {launches} fused_sgd launches, the "
          f"literals sum to {want}")
    dp_noise_check()
    rounds = {what: profile_round(cfg, tfl, init, fused_sgd_lanes,
                                  what=f"FedSR {what}")
              for what, tfl in (("DP-SGD", dp_fl(fl, "fedsr", DP_NOISE)),
                                ("without DP", scenario_fl(fl, "fedsr",
                                                           "sync10")))}
    a, b = rounds["DP-SGD"], rounds["without DP"]
    added = (a["kernels"] / max(a["steps"], 1)
             - b["kernels"] / max(b["steps"], 1))
    log(f"[3i/profile] one FedSR round (rings of 2): {a['kernels']} device "
        f"kernels over {a['steps']} SGD steps with DP-SGD, "
        f"{b['kernels']} over {b['steps']} without: the transform adds "
        f"{added:.2f} kernels a step; device busy {a['busy_ms']:.3f} against "
        f"{b['busy_ms']:.3f} ms; unprofiled {a['wall_ms']:.2f} against "
        f"{b['wall_ms']:.2f} ms")
    return launches


# ---------------------------------------------------------------------------
# Phase 3j, personalization and classifier fleet serving (ROADMAP A8).
# (a) personalize_table's alpha=0.1 rows (fl_tables.py::personalize_table
# at _fl's defaults: dirichlet, K=20, 5 edges, FedAvg E=5 R=1, FedSR E=1
# R=5, batch 32; the paper MLP at full width on mnist_like, fused,
# use_fused_sgd; PersonalizeConfig(epochs=3, lr=0.02) in full and head
# mode) at 2 global rounds against the table's 12, GPU then CPU (in phase
# 3g's pool). (b) Table IV's K=100 fleet (phase 3f's FedSR run) with
# PersonalizeConfig(epochs=1) under the device store (one block of 100)
# and the host store with prefetch 0 and 1 (blocks of 64 and 36). (c) The
# classifier fleet serving on (b)'s fleet and on a K=1,024 full-width
# stand-in fleet. (d) All eight rows of the table on the GPU alone, its 12
# rounds cut to 3: the rows' accuracies and lift are logged, not held, and
# at 12 rounds (d) took 82.8-104.4 s of the whole run, the longest part of
# the FL phases (each of its 11,628 fused_sgd launches is held against its
# plain version; at 3 rounds, a quarter of them).
PERS_ALGOS = ("fedavg", "fedsr")
PERS_MODES = ("full", "head")
PERS_ROUNDS, PERS_TABLE_ROUNDS = 2, 3
PERS_EPOCHS, PERS_LR = 3, 0.02
# The personalized fleet GPU against CPU. On a CPU
# (scripts/personalize_gaps.py, initial seeds 0 and 1, three draws each) a
# relative 1e-7 change of the initial weights moves the four rows' whole
# runs' fleets by up to 4.582e-3, and the fine-tune at 1.03x its learning
# rate by 2.030e-3 to 3.311e-3: the 2-round global model lands on another
# of a round's few outcomes (ROADMAP C8) and the fine-tune carries it, so
# no bound on the whole run tells the control from rounding, and it is
# logged. The stage alone, from one global model: a relative 1e-7 change
# of that model moves the fleet by 4.470e-8 to 1.192e-7 and the 1.03x
# fine-tune by 2.030e-3 to 7.913e-3, so the GPU's stage is held against
# the CPU's stage from the GPU run's global model. Its gap is rounding
# plus, now and then, a ReLU kink that flips over the 39 steps: moving
# every step's trained parameters by a relative 1e-7 (a rounding-sized
# change in each product) flips one in FedAvg's full-mode row of seed 0
# on a CPU (1.445e-5 and 1.448e-5 in two of three draws, seeds 0-2), and
# on an H100 (NVIDIA H100 80GB HBM3, 700 W; seeds 0 and 1, four draws)
# both that and the 1e-7 move of the global model land on 6.428e-5 there
# and on 1.138e-4 in FedSR's full-mode row of seed 1, the very gaps the
# card's stage reads against the CPU's (6.427e-5, 1.138e-4; the other
# rows 4.470e-8 to 7.451e-8). The bound sits between the largest of
# those, 1.138e-4, and the least control, 2.031e-3, with room 4.4x and
# 4.1x on the two sides.
PERS_LR_CONTROL = 1.03
PERS_STAGE_TOL = 5e-4
PERS_FLEET_EPOCHS = 1               # (b): one step a client (20 images)
PERS_FLEET_RUNS = (("device", 0), ("host", 0), ("host", 1))
# The three (b) fleets against each other on the card: the same global
# model fine-tuned in one block of 100 lanes or in blocks of 64 and 36,
# held bit for bit (the lane-stacked products gave each lane the same
# bits at 100, 64 and 36 lanes on an H100).
PERS_BLOCK_TOL = 0.0
SERVE_REQUESTS = 256
SERVE_FLEET = 1024                  # (c): the stand-in fleet, 816 MB
SERVE_TOL = 1e-5


def pers_fl(fl, algorithm: str, mode: str, alpha: float = 0.1,
            rounds: int = PERS_ROUNDS, lr: float = PERS_LR):
    """One row of ``personalize_table`` (its ``_fl`` call), from phase 3's
    ``fl`` (the paper MLP's batch 32, fused, ``use_fused_sgd``)."""
    from repro_torch.configs.base import PersonalizeConfig

    star = algorithm == "fedavg"
    return dataclasses.replace(
        fl, algorithm=algorithm, partition="dirichlet", alpha=alpha,
        num_devices=20, num_edges=5, local_epochs=5 if star else 1,
        ring_rounds=1 if star else 5, rounds=rounds,
        personalize=PersonalizeConfig(epochs=PERS_EPOCHS, lr=lr, mode=mode))


class recorded_stage:
    """Within the block, every personalization block's host arrays are
    recorded: the ``(rows, plans, valid)`` of each ``train_many_fused``
    call (``calls``) and the labels of each per-client eval draw
    (``labels``)."""

    def __enter__(self):
        import repro_torch.core.local as local
        import repro_torch.core.personalize as pers

        self.calls, self.labels = [], []
        self.cls, self.pers = local.LocalTrainer, pers
        self.saved = (self.cls.train_many_fused, pers.per_client_test_sets)
        train, sets = self.saved

        def rec_train(trainer, params, plane, rows, plans, valid, **kw):
            self.calls.append(tuple(np.array(a) for a in (rows, plans,
                                                          valid)))
            return train(trainer, params, plane, rows, plans, valid, **kw)

        def rec_sets(*a, **kw):
            images, labels = sets(*a, **kw)
            self.labels.append(labels.copy())
            return images, labels
        self.cls.train_many_fused = rec_train
        self.pers.per_client_test_sets = rec_sets
        return self

    def __exit__(self, *exc):
        self.cls.train_many_fused, self.pers.per_client_test_sets = self.saved

    def steps(self) -> int:
        """The recorded blocks' SGD steps: one ``fused_sgd`` launch each."""
        return sum(valid.shape[-1] for _, _, valid in self.calls)


def _cpu_run_pers(fl):
    """One phase 3j run on the CPU, in a worker: ``(result, blocks, calls,
    labels, wall)``, the models as numpy arrays for the trip back."""
    from repro_torch.core.executor import run_experiment

    blocks = []
    t0 = time.perf_counter()
    with recorded_stage() as rec:
        res = run_experiment(fl=fl, eval_every=fl.rounds, device="cpu",
                             on_block=lambda t, s: blocks.append((t, s)),
                             **_CPU_TASK)
    res.final_model = {k: v.numpy() for k, v in res.final_model.items()}
    res.personalized_fleet = {k: np.array(v)
                              for k, v in res.personalized_fleet.items()}
    return res, blocks, rec.calls, rec.labels, time.perf_counter() - t0


def pers_jobs(pool, fl) -> dict:
    """Phase 3j's CPU runs of (a), submitted to ``pool``."""
    return {(a, m): pool.submit(_cpu_run_pers, pers_fl(fl, a, m))
            for a in PERS_ALGOS for m in PERS_MODES}


def fleet_gap(a, b) -> float:
    """max |a - b| over two ``{leaf: (K, ...)}`` numpy fleets."""
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def body_frozen(res, cfg) -> bool:
    """Every body leaf of every personalized row is the global model's,
    bit for bit (head mode)."""
    from repro_torch.models.small import head_param_names

    head = head_param_names(cfg)
    return all(np.array_equal(v, np.broadcast_to(
        res.final_model[k].cpu().numpy(), v.shape))
        for k, v in res.personalized_fleet.items() if k not in head)


def pers_summary(res) -> str:
    return (f"acc_global {res.global_client_accuracy:.4f}, acc_personalized "
            f"{res.personalized_accuracy:.4f}, lift "
            f"{res.personalized_accuracy - res.global_client_accuracy:+.4f}")


def pers_run(run_experiment, fused_sgd_lanes, sgd_ref, tfl, tag, **kw):
    """One GPU run of phase 3j with each ``fused_sgd`` launch held against
    its plain version: ``(result, blocks, recorded_stage, launches)``; the
    launches must be the round blocks' (``engine_counts``) plus one a
    stage step, and every launch bit-equal."""
    blocks = []
    fused_sgd_lanes.launches = 0
    with recorded_stage() as rec, checked_sgd(fused_sgd_lanes,
                                              sgd_ref) as chk:
        res = run_experiment(fl=tfl, device="cuda",
                             on_block=lambda t, s: blocks.append((t, s)),
                             **kw)
    n = fused_sgd_lanes.launches
    want = engine_counts(blocks, "fused")[0] + rec.steps()
    worst = 0.0 if chk.worst is None else float(chk.worst)
    check(n == want == chk.calls, f"{tag}: {n} fused_sgd launches "
          f"({chk.calls} held), the plans imply {want}")
    check(worst == 0.0, f"{tag}: a fused_sgd launch is {worst} from the "
          f"plain version")
    check(res.personalized_fleet is not None and all(
        np.isfinite(v).all() for v in res.personalized_fleet.values()),
        f"{tag}: no finite personalized fleet")
    return res, blocks, rec, n


def pers_clients(fl, train):
    """The run's client shards, as ``run_experiment`` partitions them."""
    from repro_torch.data.pipeline import make_clients

    return make_clients(train, scheme=fl.partition,
                        num_devices=fl.num_devices,
                        rng=np.random.default_rng(fl.seed), xi=fl.xi,
                        alpha=fl.alpha)


def _cpu_stage(fl, w):
    """The stage alone on the CPU, in a worker, from the global model ``w``
    (numpy): the personalized fleet as numpy arrays."""
    from repro_torch.core.personalize import personalize_fleet

    report = personalize_fleet(_CPU_TASK["model_cfg"], fl,
                               pers_clients(fl, _CPU_TASK["train"]), w,
                               _CPU_TASK["test"], device="cpu")
    return {k: np.array(v) for k, v in report.fleet.items()}


def pers_table_path(run_experiment, fused_sgd_lanes, sgd_ref, cfg, fl, init,
                    pool, jobs, train, test) -> int:
    """Phase 3j (a): the table's alpha=0.1 rows, GPU then CPU (``jobs``,
    the whole runs; the stage alone from the GPU run's global model,
    submitted to ``pool``): plans, per-client eval labels and comm exactly
    equal; the whole runs' fleets GPU against CPU logged (C8); the stage
    alone GPU against CPU within ``PERS_STAGE_TOL``, the stage at
    ``PERS_LR_CONTROL`` times its learning rate on the GPU outside; head
    mode's body rows the global model's bit for bit on the card. Returns
    the ``fused_sgd`` launches of its GPU runs."""
    from repro_torch.core.personalize import personalize_fleet

    task = dict(task="mnist_like", model_cfg=cfg, init_params=init,
                train=train, test=test)
    launches, runs = 0, {}
    for algorithm in PERS_ALGOS:
        for mode in PERS_MODES:
            tag = f"3j/table {algorithm}/{mode}"
            tfl = pers_fl(fl, algorithm, mode)
            gpu, _, rec, n = pers_run(
                run_experiment, fused_sgd_lanes, sgd_ref, tfl, tag,
                eval_every=tfl.rounds, **task)
            launches += n
            w = {k: v.cpu().numpy() for k, v in gpu.final_model.items()}
            stage = pool.submit(_cpu_stage, tfl, w)
            control = personalize_fleet(
                cfg, dataclasses.replace(tfl, personalize=dataclasses.replace(
                    tfl.personalize, lr=PERS_LR * PERS_LR_CONTROL)),
                pers_clients(tfl, train), w, test, device="cuda").fleet
            runs[algorithm, mode] = (tag, tfl, gpu, rec, n, stage, control)
    for key, (tag, tfl, gpu, rec, n, stage, control) in runs.items():
        cpu, _, calls, labels, wall = jobs[key].result()
        same_plans = len(calls) == len(rec.calls) and all(
            np.array_equal(x, y) and x.dtype == y.dtype
            for a, b in zip(calls, rec.calls) for x, y in zip(a, b))
        same_labels = len(labels) == len(rec.labels) and all(
            np.array_equal(a, b) for a, b in zip(labels, rec.labels))
        same_comm = ([(r.round, r.comm) for r in gpu.history]
                     == [(r.round, r.comm) for r in cpu.history])
        blk = [v.shape[1:] for _, _, v in rec.calls]
        log(f"[{tag}] fused_sgd launches {n} ({rec.steps()} of them the "
            f"stage's, blocks (lanes, steps) {blk}); stage plans "
            f"{'equal' if same_plans else 'DIFFER'}, eval labels "
            f"{'equal' if same_labels else 'DIFFER'}, comm "
            f"{'equal' if same_comm else 'DIFFERS'} GPU against CPU; GPU "
            f"{pers_summary(gpu)}; CPU {pers_summary(cpu)} ({wall:.1f}s in "
            f"the pool)")
        check(same_plans and same_labels and same_comm,
              f"{tag}: plans, eval labels or comm differ GPU against CPU")
        check((gpu.h2d_bytes, gpu.dispatches)
              == (cpu.h2d_bytes, cpu.dispatches),
              f"{tag}: h2d_bytes/dispatches differ GPU against CPU")
        err_w = max_abs_diff(gpu.final_model, {
            k: torch.from_numpy(v) for k, v in cpu.final_model.items()})
        err_run = fleet_gap(gpu.personalized_fleet, cpu.personalized_fleet)
        cpu_stage = stage.result()
        err = fleet_gap(gpu.personalized_fleet, cpu_stage)
        err_c = fleet_gap(control, cpu_stage)
        log(f"[{tag}] whole runs GPU against CPU: the global model after "
            f"round {tfl.rounds} {err_w:.3e}, the personalized fleet "
            f"{err_run:.3e} (logged, C8); the stage alone from the GPU's "
            f"global model, GPU against CPU: {err:.3e} (bound "
            f"{PERS_STAGE_TOL}); control, the stage at {PERS_LR_CONTROL}x "
            f"its learning rate: {err_c:.3e} (must exceed the bound)")
        check(err <= PERS_STAGE_TOL, f"{tag}: the stage's fleet on the GPU "
              f"{err} from the CPU's")
        check(err_c > PERS_STAGE_TOL, f"{tag}: the bound does not tell a "
              f"{PERS_LR_CONTROL}x fine-tune learning rate from the CPU's "
              f"stage")
        if key[1] == "head":
            frozen = body_frozen(gpu, cfg)
            log(f"[{tag}] head mode: the body rows "
                f"{'equal' if frozen else 'DIFFER from'} the global model bit "
                f"for bit on the card")
            check(frozen, f"{tag}: head mode moved a body leaf")
    return launches


def pers_fleet_path(run_experiment, fused_sgd_lanes, sgd_ref, cfg, fl,
                    init) -> tuple:
    """Phase 3j (b): Table IV's K=100 FedSR run with a one-epoch stage
    under each of ``PERS_FLEET_RUNS``: launches, meters and staging logged;
    the three fleets against each other. Returns the launches and the
    device store's personalized fleet."""
    from repro_torch.configs.base import PersonalizeConfig

    launches, fleets = 0, {}
    for store, prefetch in PERS_FLEET_RUNS:
        tag = f"3j/fleet {store}/{prefetch}"
        tfl = dataclasses.replace(
            fl, algorithm="fedsr", store=store, prefetch=prefetch,
            **TABLE4_KW, **TABLE4["fedsr"],
            personalize=PersonalizeConfig(epochs=PERS_FLEET_EPOCHS))
        t0 = time.perf_counter()
        res, _, rec, n = pers_run(
            run_experiment, fused_sgd_lanes, sgd_ref, tfl, tag,
            task="mnist_like", model_cfg=cfg, eval_every=1,
            init_params=init)
        wall = time.perf_counter() - t0
        launches += n
        fleets[store, prefetch] = res
        blk = [v.shape[1:] for _, _, v in rec.calls]
        want_blocks = [(100, 1)] if store == "device" else [(64, 1), (36, 1)]
        log(f"[{tag}] fused_sgd launches {n}, stage blocks (lanes, steps) "
            f"{blk}; peak_device_bytes {res.peak_device_bytes}; staging "
            f"{res.stage_seconds * 1e3:.3f} ms, of it hidden by a prefetch "
            f"{res.overlapped_stage_seconds * 1e3:.3f} ms (overlap_fraction "
            f"{res.overlap_fraction:.3f}); {pers_summary(res)}; the run "
            f"{wall:.2f}s")
        check(blk == want_blocks, f"{tag}: stage blocks {blk}, expected "
              f"{want_blocks}")
        check(res.peak_device_bytes == TABLE4_PEAK["fedsr", store, prefetch],
              f"{tag}: peak_device_bytes {res.peak_device_bytes}")
    base = fleets["device", 0]
    for key in PERS_FLEET_RUNS[1:]:
        res = fleets[key]
        same_w = all(torch.equal(res.final_model[k], base.final_model[k])
                     for k in base.final_model)
        gap = fleet_gap(res.personalized_fleet, base.personalized_fleet)
        log(f"[3j/fleet {key[0]}/{key[1]}] against (device, 0) on the GPU: "
            f"global model {'bit-equal' if same_w else 'differs'}; "
            f"personalized fleet max |diff| {gap:.3e} ("
            f"{'bit-equal' if gap == 0 else 'blocks of 64 + 36 lanes against 100'}"
            f"); per-client accuracies "
            f"{'equal' if np.array_equal(res.personalized_accuracy, base.personalized_accuracy) else 'differ'}")
        check(same_w, f"3j/fleet {key}: the global model is not the "
              f"(device, 0) run's")
        check(gap <= PERS_BLOCK_TOL, f"3j/fleet {key}: the personalized "
              f"fleet {gap} from the (device, 0) run's")
    return launches, base.personalized_fleet


def serve_check(cfg, fleet_dict, test) -> None:
    """Phase 3j (c), first half: (b)'s K=100 personalized fleet serving
    ``SERVE_REQUESTS`` requests drawn with replacement from the test set,
    two batches: device- and host-resident logits bit-equal (the second
    batch's cohort prefetched while the first is served), the stacked
    forward against ``loop_classify`` within ``SERVE_TOL``, each request
    against its own model's solo forward within ``SERVE_TOL`` and against
    a misrouted batch outside it, one dispatch a batch."""
    from repro_torch.models.small import small_model_apply
    from repro_torch.serve.fleet import (
        FleetClassifier, FleetParams, loop_classify,
    )

    k = len(next(iter(fleet_dict.values())))
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, k, SERVE_REQUESTS),
                test.images[rng.integers(0, len(test.labels),
                                         SERVE_REQUESTS)])
               for _ in range(2)]
    dev = FleetParams(fleet_dict, device="cuda")
    host = FleetParams(fleet_dict, resident=False, device="cuda")
    clf = FleetClassifier(cfg)
    try:
        for i, (lanes, images) in enumerate(batches):
            got_h = clf(host, lanes, images)
            if i == 0:
                host.prefetch(batches[1][0])
            got = clf(dev, lanes, images)
            same = torch.equal(got, got_h)
            loop = loop_classify(cfg, dev, lanes, images)
            x = torch.from_numpy(images).cuda()
            solo = torch.cat([small_model_apply(dev.model(int(lane)),
                                                x[b:b + 1], cfg)
                              for b, lane in enumerate(lanes)])
            wrong = clf(dev, (lanes + 1) % k, images)
            e_loop = float((got - loop).abs().max())
            e_solo = float((got - solo).abs().max())
            e_wrong = float((got - wrong).abs().max())
            log(f"[3j/serve] K={k} fleet, batch {i}: {SERVE_REQUESTS} "
                f"requests over {len(np.unique(lanes))} clients; host- "
                f"against device-resident logits "
                f"{'bit-equal' if same else 'DIFFER'}; stacked against "
                f"loop_classify {e_loop:.3e}, against each request's solo "
                f"forward {e_solo:.3e} ({int((got == solo).all(1).sum())} "
                f"of {SERVE_REQUESTS} rows bit-equal), against a misrouted "
                f"batch {e_wrong:.3e} (bound {SERVE_TOL})")
            check(same, f"3j/serve batch {i}: host-resident logits differ "
                  f"from device-resident ones")
            check(e_loop <= SERVE_TOL and e_solo <= SERVE_TOL,
                  f"3j/serve batch {i}: stacked logits {e_loop}, {e_solo} "
                  f"from the loop's and the solo forwards")
            check(e_wrong > SERVE_TOL, f"3j/serve batch {i}: a misrouted "
                  f"batch is within the bound")
        log(f"[3j/serve] host-resident staging {host.stage_seconds * 1e3:.3f}"
            f" ms, of it prefetched {host.overlapped_stage_seconds * 1e3:.3f}"
            f" ms")
        check(host.overlapped_stage_seconds > 0, "3j/serve: the prefetched "
              "cohort was not consumed")
    finally:
        host.close()
    check(clf.dispatches == 6, f"3j/serve: {clf.dispatches} dispatches "
          f"for six batches")


def _wall_ms(fn, reps: int) -> list:
    """Wall ms of each of ``reps`` calls of ``fn``, each fenced by a
    synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serve_times(cfg, init, test, reps: int = 10) -> None:
    """Phase 3j (c), second half: a ``SERVE_FLEET``-client full-width MLP
    fleet (the seeded global model plus 0.01 N(0, 1) a client from a CUDA
    ``torch.Generator``, the reference's stand-in) serving batches of
    ``SERVE_REQUESTS`` distinct clients: the stacked forward against
    ``loop_classify``, device- and host-resident, timed by the host's
    clock (fenced); the host-resident fleet alternates two lane sets, so
    every batch stages its cohort, with and without a prefetch of the
    next. The logits of the four ways agree (host = device bit for bit,
    stacked against loop within ``SERVE_TOL``)."""
    from repro_torch.models.small import params_from_numpy
    from repro_torch.serve.fleet import (
        FleetClassifier, FleetParams, loop_classify,
    )
    from repro_torch.utils.tree import layout_of, ravel_params

    params = params_from_numpy(init, torch.device("cuda"))
    layout = layout_of(params)
    w = ravel_params(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    arena = w.unsqueeze(0) + 0.01 * torch.randn(
        (SERVE_FLEET, w.numel()), generator=gen, device="cuda")
    dev = FleetParams.from_arena(arena, layout, device="cuda")
    host_arena = arena.cpu().numpy()
    host = FleetParams.from_arena(host_arena, layout, resident=False,
                                  device="cuda")
    rng = np.random.default_rng(1)
    sets = [rng.choice(SERVE_FLEET, SERVE_REQUESTS, replace=False)
            for _ in range(2)]
    images = torch.from_numpy(test.images[rng.integers(
        0, len(test.labels), SERVE_REQUESTS)]).cuda()
    clf = FleetClassifier(cfg)
    try:
        got = clf(dev, sets[0], images)
        e_loop = float((got - loop_classify(cfg, dev, sets[0], images))
                       .abs().max())
        same = torch.equal(got, clf(host, sets[0], images))
        check(same and e_loop <= SERVE_TOL, f"3j/serve K={SERVE_FLEET}: "
              f"host = device {same}, stacked against loop {e_loop}")
        stacked = _wall_ms(lambda: clf(dev, sets[0], images), reps)
        loop = _wall_ms(lambda: loop_classify(cfg, dev, sets[0], images),
                        max(reps // 2, 2))
        turn = [0]

        def staged(prefetch: bool):
            turn[0] ^= 1
            clf(host, sets[turn[0]], images)
            if prefetch:
                host.prefetch(sets[turn[0] ^ 1])
        host_sync = _wall_ms(lambda: staged(False), reps)
        s0, o0 = host.stage_seconds, host.overlapped_stage_seconds
        host_pre = _wall_ms(lambda: staged(True), reps)
        med = {k: float(np.median(v)) for k, v in (
            ("stacked", stacked), ("loop", loop), ("host", host_sync),
            ("host_prefetch", host_pre))}
        log(f"[3j/serve] K={SERVE_FLEET} full-width MLP fleet "
            f"({arena.numel() * 4 / 1e6:.1f} MB on the card; a batch of "
            f"{SERVE_REQUESTS} distinct clients gathers "
            f"{SERVE_REQUESTS * w.numel() * 4 / 1e6:.1f} MB): stacked "
            f"against loop {e_loop:.3e}, host = device "
            f"{'bit for bit' if same else 'DIFFERS'}; median ms a batch: "
            f"stacked {med['stacked']:.3f} ({SERVE_REQUESTS / med['stacked'] * 1e3:.0f} "
            f"requests/s), loop {med['loop']:.3f} "
            f"({SERVE_REQUESTS / med['loop'] * 1e3:.0f} requests/s; "
            f"{med['loop'] / med['stacked']:.1f}x the stacked), "
            f"host-resident {med['host']:.3f}, with a prefetch "
            f"{med['host_prefetch']:.3f}; the prefetched batches' staging "
            f"{(host.stage_seconds - s0) * 1e3 / reps:.3f} ms a batch, "
            f"{(host.overlapped_stage_seconds - o0) * 1e3 / reps:.3f} of it "
            f"ahead of its batch")
        # a cohort's staging piece by piece: the host gather into
        # page-locked memory (the fleet's torch gather, and np.take with
        # out=, as the client stores gather), then the copy
        ids = np.sort(sets[0])
        pinned = torch.empty((len(ids), w.numel()), dtype=torch.float32,
                             pin_memory=True)
        gather = float(np.median(_wall_ms(lambda: torch.index_select(
            torch.from_numpy(host_arena), 0, torch.from_numpy(ids),
            out=pinned), reps)))
        take = float(np.median(_wall_ms(lambda: np.take(
            host_arena, ids, axis=0, out=pinned.numpy()), reps)))
        copy = float(np.median(_wall_ms(lambda: pinned.to(
            "cuda", non_blocking=True), reps)))
        nbytes = pinned.numel() * 4
        log(f"[3j/serve] a cohort's staging piece by piece (median of "
            f"{reps}): the host gather into page-locked memory "
            f"{gather:.3f} ms ({nbytes / gather / 1e6:.2f} GB/s; np.take "
            f"with out= {take:.3f} ms, {nbytes / take / 1e6:.2f} GB/s), the "
            f"H2D copy {copy:.3f} ms ({nbytes / copy / 1e6:.2f} GB/s)")
    finally:
        host.close()
    del dev, host, arena
    torch.cuda.empty_cache()


def pers_rows(run_experiment, fused_sgd_lanes, sgd_ref, cfg, fl, init,
              train, test) -> int:
    """Phase 3j (d): all eight rows of ``personalize_table`` at
    ``PERS_TABLE_ROUNDS`` rounds on the GPU, each ``fused_sgd`` launch held
    against its plain version; each row's accuracies and lift logged.
    Returns the launches."""
    task = dict(task="mnist_like", model_cfg=cfg, init_params=init,
                train=train, test=test)
    launches = 0
    for alpha in (0.5, 0.1):
        for mode in PERS_MODES:
            for algorithm in PERS_ALGOS:
                tag = f"3j/rows alpha={alpha} {mode} {algorithm}"
                tfl = pers_fl(fl, algorithm, mode, alpha, PERS_TABLE_ROUNDS)
                t0 = time.perf_counter()
                res, _, _, n = pers_run(run_experiment, fused_sgd_lanes,
                                        sgd_ref, tfl, tag,
                                        eval_every=tfl.rounds, **task)
                launches += n
                log(f"[{tag}] {pers_summary(res)}; global accuracy "
                    f"{res.final_accuracy:.4f}; {n} fused_sgd launches; "
                    f"{time.perf_counter() - t0:.2f}s")
    return launches


def pers_path(run_experiment, fused_sgd_lanes, sgd_ref, cfg, fl, init, pool,
              jobs, train, test) -> int:
    """Phase 3j: (a) to (d), then ``fused_sgd``'s times at the stage's two
    lane counts of (b). Returns the phase's ``fused_sgd`` launches."""
    t0 = time.perf_counter()
    launches = pers_table_path(run_experiment, fused_sgd_lanes, sgd_ref,
                               cfg, fl, init, pool, jobs, train, test)
    log(f"[3j] (a) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    n, fleet = pers_fleet_path(run_experiment, fused_sgd_lanes, sgd_ref, cfg,
                               fl, init)
    launches += n
    log(f"[3j] (b) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve_check(cfg, fleet, test)
    serve_times(cfg, init, test)
    log(f"[3j] (c) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches += pers_rows(run_experiment, fused_sgd_lanes, sgd_ref, cfg, fl,
                          init, train, test)
    log(f"[3j] (d) in {time.perf_counter() - t0:.1f}s")
    for lanes in (100, 64):
        time_kernels(fused_sgd_lanes, sgd_ref, (lanes, 199_210), MLP_LEAVES,
                     f"MLP leaves (a personalization block of {lanes})")
    return launches


# Phase 3k, engine="sharded" and mesh_data_axis (ROADMAP A5) on phase 3's
# path (the paper MLP at full width, K=20, M=5, R=5, batch 32; E=1 for
# FedSR, 5 for FedAvg), 2 rounds in one block: FedSR on the fused engine
# with mesh_data_axis="data" and FedAvg on the sharded engine, on (a) the
# card's own mesh (its one entry) and (b) a sim mesh of 8 entries of the
# one card (visible_devices patched), where FedSR's 5 ring lanes pad to 8
# and FedAvg's 20 to 24.
# MESH_LITERALS holds (N_max, h2d_bytes, peak_device_bytes, dispatches) of
# each run, keyed (algorithm, engine, mesh_data_axis, mesh size), from the
# reference's runs on the CPU (scripts/mesh_literals.py): under the mesh
# the fused engine's plane pads every shard to N_max and its 20 shards to
# a mesh multiple, so its bytes are round_up(20) * N_max * (3,136 + 4) plus
# 20 * 4.
MESH_RUNS = (("fedsr", "fused", "data"), ("fedavg", "sharded", None))
MESH_SIZES = (1, 8)
MESH_LITERALS = {
    ('fedavg', 'sharded', None, 1): (100, 80384800, 0, 2),
    ('fedsr', 'fused', 'data', 1): (100, 104048, 6280080, 1),
    ('fedavg', 'sharded', None, 8): (100, 96461760, 0, 2),
    ('fedsr', 'fused', 'data', 8): (100, 166472, 7536080, 1),
}
MESH_PLAIN = {"fused": "fused", "sharded": "batched"}
# The bound of each run's model GPU against CPU, on both meshes, between
# the largest rounding-sized reading of scripts/mesh_gaps.py (the run moved
# by a relative 1e-7 in its initial weights or in every step's trained
# parameters, 3 draws each, on the card, both meshes) and the least
# control (the 1.03x learning rate). FedAvg over initial-weight seeds 0-4:
# readings up to 4.666e-5, controls from 2.749e-4. FedSR's ring chain lands
# on other outcomes from a rounding-size change (ROADMAP C8): over seeds
# 0-4 its readings reach 7.808e-4 and its controls fall to 1.252e-3, so
# its bound holds for the phase's seed 0 alone (readings up to 9.678e-5,
# control 1.739e-3), 4e-4 about midway on a log scale.
MESH_TOL = {"fedsr": 4e-4, "fedavg": ENGINE_ROUND1_TOL}


def mesh_fl(fl, algorithm: str, engine: str, axis):
    """Phase 3k's FLConfig of one run, from phase 3's ``fl``: FedAvg at
    E=5, as phase 3g's star runs (at E=1 its 2-round model moves too little
    for the 1.03x learning rate to land outside the bound)."""
    return dataclasses.replace(
        fl, algorithm=algorithm, engine=engine, mesh_data_axis=axis,
        rounds=2, local_epochs=5 if algorithm == "fedavg" else 1)


@contextlib.contextmanager
def sim_mesh(n: int, device: str):
    """The sim mesh as ``n`` entries of ``device`` (``launch.mesh``'s one
    device list, replaced for the block)."""
    import repro_torch.launch.mesh as mesh

    saved = mesh.visible_devices
    mesh.visible_devices = lambda dev=None: [torch.device(device)] * n
    try:
        yield
    finally:
        mesh.visible_devices = saved


def _cpu_run_mesh(fl, size):
    """One phase 3k run on the CPU, in a worker, on a sim mesh of ``size``
    CPU entries: ``_cpu_run``'s tuple."""
    with sim_mesh(size, "cpu"):
        return _cpu_run(fl, None)


def mesh_jobs(pool, fl) -> dict:
    """Phase 3k's CPU runs, submitted to ``pool``: ``{(algorithm, size):
    future}``."""
    return {(run[0], size): pool.submit(_cpu_run_mesh, mesh_fl(fl, *run),
                                        size)
            for run in MESH_RUNS for size in MESH_SIZES}


class idle_lanes:
    """Within the block, every lane-stacked step loop
    (``LocalTrainer._sgd_steps``) records the lanes it gives no valid step
    (the ghost lanes of a padded stack) and how far each one's returned row
    moved from its seed row (``worst``, on the device; it must be 0), and
    the lane counts of the stacks it trains (``widths``)."""

    def __init__(self):
        self.lanes, self.worst, self.widths = 0, None, Counter()

    def __enter__(self):
        from repro_torch.core.local import LocalTrainer

        self.cls, self.saved = LocalTrainer, LocalTrainer._sgd_steps
        rec = self

        def steps(tr, params, batch_at, ok, lr, S, extras):
            idle = ~ok.any(0)
            seeds = params[idle].clone()
            out = rec.saved(tr, params, batch_at, ok, lr, S, extras)
            rec.widths[params.shape[0]] += 1
            if seeds.shape[0]:
                d = (out[idle] - seeds).abs().max()
                rec.worst = d if rec.worst is None else torch.maximum(
                    rec.worst, d)
                rec.lanes += seeds.shape[0]
            return out
        LocalTrainer._sgd_steps = steps
        return self

    def __exit__(self, *exc):
        self.cls._sgd_steps = self.saved


def mesh_ghosts(blocks, engine: str, size: int) -> tuple:
    """(ghost lanes, stack widths) the plans imply on a mesh of ``size``:
    each group's lanes padded to a multiple of ``size``, one step loop a
    group under the fused engine, one a hop under the sharded one."""
    ghosts, widths = 0, Counter()
    for _, sched in blocks:
        for plan in sched.plans:
            for g in plan.groups:
                padded = -(-g.lanes // size) * size
                calls = 1 if engine == "fused" else len(g.hops)
                ghosts += (padded - g.lanes) * calls
                widths[padded] += calls
    return ghosts, widths


def mesh_path(run_experiment, fused_sgd_lanes, cfg, fl, init, jobs, train,
              test):
    """Phase 3k: each run of ``MESH_RUNS`` on the card's own mesh and on
    an 8-entry sim mesh of the card, GPU then CPU (``jobs``, in the pool),
    with phase 3's checks (no accuracy floor) and each ``fused_sgd`` launch
    of the GPU runs held against its plain version; ``N_max`` of the CPU's
    shards and each run's ``h2d_bytes``, ``peak_device_bytes`` and
    dispatches on both devices against ``MESH_LITERALS``; the lanes padded
    as the plans imply, every ghost lane's returned row its seed bit for
    bit; on the card's own mesh each model bit-equal to the same run
    without the mesh on the card; on both meshes the model within
    ``MESH_TOL`` of the CPU's run on the same mesh, the 1.03x learning
    rate outside it; on the 8-entry mesh its gap to the unpadded card run
    logged. Returns the ``fused_sgd`` launches of its checked GPU runs."""
    from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference

    t_phase = time.perf_counter()
    log(f"[3k] torch.cuda.device_count() = {torch.cuda.device_count()}")
    checked = checked_sgd(fused_sgd_lanes, sgd_lanes_reference)
    task = dict(task="mnist_like", model_cfg=cfg, init_params=init,
                train=train, test=test)
    n_max = max(len(c) for c in pers_clients(fl, train))
    launches = 0
    plain = {}
    for algorithm, engine, _ in MESH_RUNS:
        tfl = mesh_fl(fl, algorithm, MESH_PLAIN[engine], None)
        with checked:
            plain[algorithm] = main_path(
                run_experiment, fused_sgd_lanes, cfg, tfl, init,
                eval_every=3, tag=f"3k {algorithm}/{tfl.engine}",
                devices=("cuda",), train=train, test=test)["cuda"]
        launches += plain[algorithm][2]
    for algorithm, engine, axis in MESH_RUNS:
        tfl = mesh_fl(fl, algorithm, engine, axis)
        for size in MESH_SIZES:
            tag = f"3k {algorithm}/{engine}/mesh {size}"
            lit = MESH_LITERALS[algorithm, engine, axis, size]
            idle = idle_lanes()
            with checked, idle, (sim_mesh(size, "cuda") if size > 1
                                 else contextlib.nullcontext()):
                gpu = main_path(run_experiment, fused_sgd_lanes, cfg, tfl,
                                init, eval_every=3, tag=tag,
                                devices=("cuda",), train=train,
                                test=test)["cuda"]
            res, blocks, n, _ = gpu
            launches += n
            cpu = jobs[algorithm, size].result(timeout=600)
            cpu[0].final_model = {k: torch.from_numpy(v)
                                  for k, v in cpu[0].final_model.items()}
            log(f"[{tag}] cpu: accuracies "
                f"{[round(r.accuracy, 4) for r in cpu[0].history]} "
                f"dispatches={cpu[0].dispatches} h2d_bytes={cpu[0].h2d_bytes}"
                f" wall={cpu[3]:.3f}s")
            check_main_path({"cuda": gpu, "cpu": cpu}, 199_210,
                            min_final_acc=None, tag=tag,
                            engine="fused" if engine == "fused"
                            else "batched")
            for dev, r in (("GPU", res), ("CPU", cpu[0])):
                got = (n_max, r.h2d_bytes, r.peak_device_bytes, r.dispatches)
                log(f"[{tag}] {dev}: N_max {n_max} (from the CPU's shards), "
                    f"h2d_bytes {r.h2d_bytes}, peak_device_bytes "
                    f"{r.peak_device_bytes}, dispatches {r.dispatches}; the "
                    f"literal {lit}")
                check(got == lit, f"{tag}: {dev} meters {got}, the literal "
                      f"{lit}")
            ghosts, widths = mesh_ghosts(blocks, engine, size)
            worst = None if idle.worst is None else float(idle.worst)
            log(f"[{tag}] lane stacks {dict(idle.widths)} (the plans imply "
                f"{dict(widths)}); ghost lanes {idle.lanes} (implied "
                f"{ghosts}), max |returned row - seed| {worst}")
            check(idle.widths == widths and idle.lanes == ghosts,
                  f"{tag}: lane stacks {dict(idle.widths)} and {idle.lanes} "
                  f"idle lanes, the plans imply {dict(widths)} and {ghosts}")
            check(ghosts == 0 or worst == 0.0,
                  f"{tag}: a ghost lane's row moved {worst} from its seed")
            gap = max_abs_diff(res.final_model, plain[algorithm][0]
                               .final_model)
            if size == 1:
                log(f"[{tag}] the model against the same run without the "
                    f"mesh on the card: max |diff| {gap:.3e}")
                check(gap == 0.0, f"{tag}: the model is not the unmeshed "
                      f"run's bit for bit on the card ({gap})")
            else:
                log(f"[{tag}] the model against the unpadded run on the "
                    f"card: max |diff| {gap:.3e} (logged)")
            with (sim_mesh(size, "cuda") if size > 1
                  else contextlib.nullcontext()):
                model_gap(run_experiment, task, tag, tfl, res.final_model,
                          cpu[0].final_model, 2, True,
                          tol=MESH_TOL[algorithm])
    worst = float(checked.worst) if checked.worst is not None else None
    log(f"[3k] fused_sgd against its plain version on each launch's inputs: "
        f"{checked.calls} launches, max |diff| {worst}")
    check(checked.calls == launches and worst == 0.0,
          f"3k: {checked.calls} checked launches of {launches}, max |diff| "
          f"{worst} from the plain version")
    log(f"[3k] the phase's runs in {time.perf_counter() - t_phase:.1f}s")
    return launches


def time_launch(fn, reps: int = 50) -> float:
    """Median ms of one call of ``fn``, timed alone with CUDA events. Before
    every call a 256 MB write flushes the 50 MB L2 cache, and a spin kernel
    then holds the card while the host enqueues the call, so host launch
    gaps stay out of the measured interval."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    times = []
    for i in range(reps + 5):
        flush.fill_(float(i))
        torch.cuda._sleep(1_000_000)        # ~0.5 ms of device time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_kernels(fused_sgd_lanes, sgd_lanes_reference, shape=MAIN_SHAPE,
                 shapes=MLP_LEAVES, what="MLP leaves", dtype=torch.float32):
    """``fused_sgd`` at a path's shape with the gradient as the model's
    leaves (the path's own call), in ``dtype``: the event time and the
    profiler's kernel time with the L2 flushed by a write, and the
    profiler's time warm (launches back to back, the operands in L2, as on
    the path); then the plain version and ``torch._fused_sgd_`` on tensors
    of the same dtype. Returns the row of the kernels line."""
    C, P = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    p, g, m = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    leaves = split_leaves(g, shapes)
    ok = torch.ones(C, dtype=torch.bool, device="cuda")
    lr = torch.tensor([1e-4], device="cuda").to(dtype)
    kw = {"reset": False, "momentum": 0.5}
    bf16 = dtype == torch.bfloat16
    kname = "fused_sgd_bf16_kernel" if bf16 else "fused_sgd_kernel"

    def call():
        fused_sgd_lanes(p, leaves, m, ok, lr, **kw)
    before = fused_sgd_lanes.launches, fused_sgd_lanes.bf16_launches
    ms = time_launch(call)
    cold = kernel_times(call, [kname], 30)[kname][0]
    warm = kernel_times(call, [kname], 30, warm=True)[kname][0]
    # timing launches are not the path's
    fused_sgd_lanes.launches, fused_sgd_lanes.bf16_launches = before
    plain_ms = time_launch(lambda: sgd_lanes_reference(p, leaves, m, ok, lr,
                                                       **kw))
    ps, gs, ms_ = [p.view(-1)], [g.view(-1)], [m.view(-1)]
    library_ms = time_launch(lambda: torch._fused_sgd_(
        ps, gs, ms_, weight_decay=0.0, momentum=0.5, lr=1e-4, dampening=0.0,
        nesterov=False, maximize=False, is_first_step=False))
    # read p, g, m, ok, lr; write p, m
    esize = p.element_size()
    nbytes = 5 * esize * C * P + C + esize
    # four float32 operations an element, in either dtype
    bound_ms, bound_by = _bound(nbytes, 4 * C * P, H100_F32_FLOPS)
    what = f"{what}, {str(dtype)[6:]}"
    log(f"[time] fused_sgd at {shape}, {what}: events {ms:.5f} ms; "
        f"profiler {cold:.5f} ms ({100 * bound_ms / cold:.1f}% of the bound) "
        f"with the L2 flushed, {warm:.5f} ms warm")
    log(f"[time] fused_sgd at {shape} {str(dtype)[6:]}: plain "
        f"{plain_ms:.5f} ms, "
        f"torch._fused_sgd_ {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def device_rows(prof):
    """(device time us, count, name) of each kernel of a profiled window,
    largest first. Device-side events only: an aten op's row repeats the
    time of the kernels it launched, so summing every row would count it
    twice."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)


def profile_report(prof, wall_us: float, what: str, focus=()) -> float:
    """Prints the wall, the device-busy share and the kernels by device
    time of one profiled window, and the time and busy share of the
    kernels whose names hold one of ``focus``; returns the busy share."""
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    check(busy > 0, f"the profiler saw no device time over {what}")
    log(f"[profile] {what} (profiler on): wall {wall_us / 1e3:.3f} ms, "
        f"{launches} device kernels, busy {busy / 1e3:.3f} ms "
        f"({100 * busy / wall_us:.1f}%), idle {100 * (1 - busy / wall_us):.1f}%")
    for dev, count, key in rows[:10]:
        log(f"[profile]   {dev / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    if focus:
        mine = [r for r in rows if any(f in r[2] for f in focus)]
        dev = sum(r[0] for r in mine)
        log(f"[profile]   {' + '.join(focus)}: {dev / 1e3:.3f} ms in "
            f"{sum(r[1] for r in mine)} launches, {100 * dev / busy:.1f}% "
            f"of the busy time")
    return busy / wall_us


def op_rows(prof, names):
    """(device time us including the kernels it launched, calls) of each
    profiled aten op in ``names``."""
    return {e.key: (e.device_time_total, e.count) for e in prof.key_averages()
            if e.key in names}


def grad_copies(prof):
    """(device time us, calls) of the dense copies of the conv-weight
    gradients: ``aten::contiguous`` on a (C, 3, 3, Cin, Cout) tensor (the
    profile must record shapes)."""
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::contiguous" and e.input_shapes
            and len(e.input_shapes[0]) == 5
            and tuple(e.input_shapes[0][1:3]) == (3, 3)]
    return (sum(e.device_time_total for e in rows),
            sum(e.count for e in rows))


def profile_round(cfg, fl, init, fused_sgd_lanes, task="mnist_like",
                  what="FedSR", sgd_steps=None) -> dict:
    """Where one steady-state round of an FL path spends its time. After a
    warm-up round, one round is timed without the profiler (cuDNN's default
    algorithms, as a user runs it; for the CNN also one with
    ``cudnn.deterministic``, as phase 3b runs it), and one round runs under
    ``torch.profiler``: the busy share is its device time over the
    unprofiled round's wall. Also what the momentum update costs a SGD step:
    its device time and the kernels of a step. The fused path concatenates
    no gradient, so the round must run no ``torch.cat`` kernel. For the CNN
    also the convolutions' share of the busy time (forward and backward, by
    their aten ops) and, from one more profiled round that records shapes,
    the dense copies of the conv-weight gradients (``aten::contiguous``:
    three a step in ``lane_grads``, one a round for the lane broadcast).
    The algorithm's state (MOON's, SCAFFOLD's) carries from round to
    round. A round's SGD steps are its ``fused_sgd`` launches, or
    ``sgd_steps`` where the update launches none (SCAFFOLD's). Returns the
    unprofiled round's wall (ms), the device busy time (ms) and the SGD
    steps of the profiled round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    rng = np.random.default_rng(fl.seed)
    train, _ = make_task(task, seed=fl.seed)
    clients = make_clients(train, scheme=fl.partition,
                           num_devices=fl.num_devices, rng=rng)
    algo = make_algorithm(fl.algorithm, LocalTrainer(cfg, fl, "cuda"),
                          clients, fl)
    w = ravel_params(params_from_numpy(init, torch.device("cuda")))
    lr = np.asarray([fl.init_lr])
    t = 0
    state = {}

    def one_round(prof_kw=None):
        nonlocal w, t
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA], **prof_kw)
              if prof_kw is not None else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            w, _ = algo.run_schedule(w, t, lr, rng, None, state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t += 1
        return wall_ms, prof

    before = fused_sgd_lanes.launches
    one_round()                                         # warm-up
    walls = {"default": one_round()[0]}
    if cfg.family == "cnn":
        torch.backends.cudnn.deterministic = True
        try:
            walls["deterministic"] = one_round()[0]
        finally:
            torch.backends.cudnn.deterministic = False
    log(f"[profile] one {what} round without the profiler: "
        + ", ".join(f"{v:.2f} ms (cuDNN {k})" for k, v in walls.items()))
    mark = fused_sgd_lanes.launches
    prof_wall, prof = one_round({})
    steps = sgd_steps or fused_sgd_lanes.launches - mark
    busy_share = profile_report(prof, prof_wall * 1e3, f"one {what} round")
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    kernels = sum(r[1] for r in rows)
    update = [r for r in rows if "fused_sgd" in r[2] or "Cat" in r[2]]
    cats = sum(r[1] for r in rows if "Cat" in r[2])
    log(f"[profile] one {what} round: device busy {busy / 1e3:.3f} ms, "
        f"{100 * busy / (1e3 * walls['default']):.1f}% of the unprofiled "
        f"round's {walls['default']:.2f} ms ({100 * busy_share:.1f}% of the "
        f"profiled wall)")
    if cfg.family == "cnn":
        ops = op_rows(prof, ("aten::convolution",
                             "aten::convolution_backward"))
        conv = sum(d for d, _ in ops.values())
        mark = fused_sgd_lanes.launches
        _, shaped = one_round({"record_shapes": True})
        shaped_steps = fused_sgd_lanes.launches - mark
        copy_us, copies = grad_copies(shaped)
        log(f"[profile] one {what} round: convolutions (forward + backward) "
            f"{conv / 1e3:.3f} ms in {sum(n for _, n in ops.values())} calls, "
            f"{100 * conv / max(busy, 1e-9):.1f}% of the busy time; the "
            f"conv-weight gradients' dense copies (a round with shapes "
            f"recorded) {copies} calls, {copies / max(shaped_steps, 1):.2f} a "
            f"step, {copy_us / max(shaped_steps, 1):.3f} us of device time a "
            f"step")
        check(copies == 3 * shaped_steps,
              f"{what}: {copies} dense copies of conv-weight gradients over "
              f"{shaped_steps} steps, expected three a step")
    fused_sgd_lanes.launches = before    # the path's count is its phase's
    log(f"[profile] one {what} round: {steps} SGD steps, {kernels} device "
        f"kernels, {kernels / max(steps, 1):.2f} a step; the update "
        f"{sum(r[0] for r in update) / max(steps, 1):.3f} us of device time "
        f"a step in {sum(r[1] for r in update)} kernels ("
        + ", ".join(f"{r[2][:40]} {r[0] / max(r[1], 1):.3f} us x {r[1]}"
                    for r in update) + ")")
    check(steps > 0 and cats == 0,
          f"the fused {what} round ran {cats} torch.cat kernels over {steps} "
          f"steps: the update must read the gradient leaves in place")
    return {"wall_ms": walls["default"], "busy_ms": busy / 1e3,
            "steps": steps, "kernels": kernels}


# ---------------------------------------------------------------------------
# attention kernels

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# ATTN_TOL's 2e-2 in bfloat16 is as large as a typical output at S = 4096
# (|out| ~ 0.03), so beside it each bfloat16 flash row (b, s, h) is held
# relative to its own largest |plain| value: kernel and plain version
# round float32 rows that differ only in summation order once each, so
# they differ by at most one bfloat16 ulp of an element, at most 2^-7 of
# the row's largest value.
FLASH_ROW_TOL = 2.0 ** -7
# ROADMAP C3: P reaches the PV product in float32 (bfloat16 hi + lo), never
# rounded to bfloat16 alone. c3_probe's p values lie 0.4 and 0.6 of a
# bfloat16 ulp above 0.75, so they round in opposite directions; v is +1
# on one and -1 on the other, and the exact output (about -5.0e-4) is a
# fifth of what bfloat16 P makes of it. Held relative to the exact output:
# the hi/lo split leaves at most 0.4% (the rounding of its lo part, the
# same on every key) and the output's one rounding 0.2%; bfloat16 P is
# 400% off, float16 or TF32 P 25%.
C3_P = (0.75 + 0.4 * 2.0 ** -8, 0.75 + 0.6 * 2.0 ** -8)
C3_TOL = 2e-2
# (b, s, t, h, kv, hd, window, causal): tests/test_kernels.py's shapes and
# windows, ragged S, non-causal, the yi-9b prefill shapes of phases 4-5;
# then what the bfloat16 kernel's 128-row, TMA-fed tiles meet: ragged S at
# hd 128, G = 8 over two batch rows (kept apart by the 4-D tensor maps), a
# window edge inside a tile, non-causal T > S with a ragged T tile; then
# the same at hd 160 (five 32-column boxes a tile, an n160 PV product),
# with stablelm-12b's heads and its prefill shape (phase 5b)
FLASH_SWEEP = [
    (2, 64, 64, 4, 2, 32, 0, True), (1, 128, 128, 8, 8, 64, 0, True),
    (2, 64, 64, 4, 1, 32, 0, True), (1, 256, 256, 4, 2, 128, 0, True),
    (1, 128, 128, 4, 2, 32, 16, True), (1, 128, 128, 4, 2, 32, 48, True),
    (1, 128, 128, 4, 2, 32, 100, True), (1, 1000, 1000, 8, 2, 64, 0, True),
    (1, 1000, 1000, 8, 2, 64, 300, True), (2, 64, 64, 4, 2, 32, 0, False),
    (1, 256, 256, 32, 4, 128, 0, True), (1, 4096, 4096, 32, 4, 128, 0, True),
    (1, 200, 200, 8, 2, 128, 0, True), (1, 1000, 1000, 8, 2, 128, 0, True),
    (2, 384, 384, 32, 4, 128, 0, True), (1, 1000, 1000, 8, 2, 128, 200, True),
    (2, 64, 320, 4, 2, 128, 0, False),
    (1, 512, 512, 32, 8, 160, 0, True), (1, 1000, 1000, 8, 2, 160, 0, True),
    (1, 1000, 1000, 8, 2, 160, 200, True), (2, 64, 320, 4, 2, 160, 0, False),
    (1, 4096, 4096, 32, 8, 160, 0, True),
    # phase 5c's prefills: musicgen-large's MHA at hd 64, llava's GQA at
    # S = 8192 under its 4096-key window (the window drops keys for half
    # the rows)
    (1, 4096, 4096, 32, 32, 64, 0, True),
    (1, 8192, 8192, 32, 8, 128, 4096, True),
]
# (b, h, kv, t, hd, window): tests/test_kernels.py's shapes and windows
# (MQA included), G = 16, and the yi-9b decode shapes of phases 4-5; then
# shapes the split rule cuts into several splits (ops.num_splits), with
# windows whose start falls inside a split and, with random lengths,
# splits left empty: 7, 16, 66 and (G = 16 over one kv head) 6 splits;
# then the decode shapes of phase 4b's archs (stablelm-12b at hd 160,
# granite-8b, deepseek-7b's G = 1) and hd 160 cut into 7 and 6 splits
DECODE_SWEEP = [
    (2, 8, 2, 256, 32, 0), (2, 8, 2, 256, 32, 100), (1, 4, 4, 512, 64, 0),
    (1, 4, 4, 512, 64, 100), (3, 8, 1, 128, 128, 0), (3, 8, 1, 128, 128, 100),
    (2, 32, 2, 300, 128, 0), (4, 32, 4, 24, 128, 0), (4, 32, 4, 48, 128, 0),
    (2, 8, 2, 1000, 64, 300), (2, 32, 4, 2048, 128, 700),
    (1, 32, 4, 8448, 128, 0), (2, 16, 1, 777, 32, 0),
    (4, 32, 8, 48, 160, 0), (4, 32, 8, 48, 128, 0), (4, 32, 32, 48, 128, 0),
    (2, 32, 8, 2048, 160, 700), (2, 16, 1, 777, 160, 0),
    # phase 5c's decodes (musicgen-large at G = 1, hd 64; llava at G = 4),
    # and llava's window binding in decode (8448 positions, window 4096)
    (4, 32, 32, 48, 64, 0), (2, 32, 8, 8448, 128, 4096),
]
DECODE_DTYPES = [(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32)]
FLASH_PATH = (1, 4096, 32, 4, 128)          # yi-9b prefill_step, phase 5
DECODE_PATH = (4, 32, 4, 48, 128)           # yi-9b CLI defaults, phase 5
FLEET_DECODE = (8, 32, 4, 48, 128)          # yi-9b's fleet, phase 7b
FLASH_PATH_160 = (1, 4096, 32, 8, 160)      # stablelm-12b, phase 5b
DECODE_PATH_160 = (4, 32, 8, 48, 160)
FLASH_MUSICGEN = (1, 4096, 32, 32, 64)      # musicgen-large, phase 5c
FLASH_LLAVA = (1, 8192, 32, 8, 128)         # llava's prefill, phase 5c,
LLAVA_WINDOW = 4096                         # under its sliding window
DECODE_MUSICGEN = (4, 32, 32, 48, 64)
DECODE_LLAVA = (4, 32, 8, 48, 128)
FLASH_JAMBA = (1, 4096, 32, 8, 128)         # jamba-v0.1-52b, phase 5e
DECODE_32K = (128, 32, 4, 32768, 128)       # one layer of decode_32k
DECODE_32K_B1 = (1, 32, 4, 32768, 128)      # its cache at batch 1


def _randn(gen, shape, dtype):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def row_err(out, want) -> float:
    """Largest max |out - want| over a row (the last axis) relative to the
    row's max |want|."""
    want = want.float()
    diff = (out.float() - want).abs().amax(-1)
    return (diff / want.abs().amax(-1).clamp(min=1e-30)).max().item()


def c3_probe(hd, device, b=1, s=128, t=1024, h=4, kv=2):
    """Non-causal bfloat16 flash-attention inputs (q, k, v) on ``device``
    on which P rounded to bfloat16 before the PV product moves the output
    by four times its size, with the exact output (float64; every element
    is the same) and the output bfloat16 P gives.

    Keys 64 j and 64 j + 1 score 0, the max of every key tile, and have
    v = 0. Every other even key scores ln C3_P[0] with v = +1, every
    other odd key ln C3_P[1] with v = -1. A score is the sum of three
    bfloat16 parts of k against q = 1, so q . k carries it to float32
    precision."""
    key = torch.arange(t)
    anchor, odd = key % 64 < 2, key % 2 == 1
    p = torch.tensor(C3_P, dtype=torch.float64)[odd.long()]
    score = torch.where(anchor, 0.0, p.log()) * hd ** 0.5
    parts = []
    for _ in range(3):
        parts.append(score.to(torch.bfloat16))
        score = score - parts[-1].double()
    k = torch.zeros(b, t, kv, hd, dtype=torch.bfloat16)
    k[..., :3] = torch.stack(parts, -1)[None, :, None]
    q = torch.zeros(b, s, h, hd, dtype=torch.bfloat16)
    q[..., :3] = 1
    sign = torch.where(anchor, 0.0, 1.0 - 2.0 * odd.double())
    v = sign[None, :, None, None].expand(b, t, kv, hd).to(torch.bfloat16)
    e = (k[0, :, 0, :3].double().sum(-1) / hd ** 0.5).exp()
    exact = (e @ sign / e.sum()).item()
    rounded = (e.float().bfloat16().double() @ sign / e.sum()).item()
    return (q.to(device), k.to(device), v.contiguous().to(device),
            exact, rounded)


def c3_err(out, exact) -> float:
    """max |out - exact| relative to |exact|."""
    return ((out.double() - exact).abs().max() / abs(exact)).item()


def c3_probe_check(flash, flash_plain) -> None:
    """Phase 2: the bfloat16 flash kernel, through its wrapper, keeps P in
    float32 for the PV product (ROADMAP C3) at each head dim."""
    for hd in (32, 64, 128, 160):
        q, k, v, exact, rounded = c3_probe(hd, "cuda")
        errs = {"kernel": c3_err(flash(q, k, v, causal=False), exact),
                "plain": c3_err(flash_plain(q, k, v, causal=False), exact),
                "bfloat16 P": abs(rounded - exact) / abs(exact)}
        log(f"[sweep] flash C3 probe hd={hd}: exact output {exact:.6e}, "
            f"error relative to it: " + ", ".join(
                f"{name} {e:.3e}" for name, e in errs.items())
            + f" (bound {C3_TOL:g})")
        check(errs["kernel"] <= C3_TOL and errs["plain"] <= C3_TOL,
              f"flash_attention at hd={hd} does not keep P in float32 for "
              f"PV (ROADMAP C3): {errs}")
        check(errs["bfloat16 P"] > C3_TOL,
              f"the C3 probe at hd={hd} cannot tell bfloat16 P: {errs}")


def decode_score_scale_check(decode, decode_plain, trials=20) -> None:
    """Phase 2: float32 decode attention at the path's shape with scores
    of yi-9b's scale (std 350, see LAUNCH_TOL), kernel and plain version
    each against a float64 computation of the same inputs. A score of
    several hundred keeps ~2e-5 of rounding, so two float32 versions that
    sum q . k in other orders differ by up to ~1e-4 of the output; this
    says how much of that is the kernel's. Held to LAUNCH_TOL's float32
    bound, relative to max(1, max |exact|)."""
    b, h, kv, t, hd = DECODE_PATH
    gen = torch.Generator(device="cuda").manual_seed(5)
    arange = torch.arange(t, device="cuda")
    errs = {"kernel": [], "plain": []}
    for _ in range(trials):
        q = torch.randn((b, 1, h, hd), device="cuda", generator=gen) * 350 ** 0.5
        k = torch.randn((b, t, kv, hd), device="cuda", generator=gen) * 350 ** 0.5
        v = torch.randn((b, t, kv, hd), device="cuda", generator=gen)
        lengths = torch.randint(1, t + 1, (b,), device="cuda",
                                generator=gen).to(torch.int32)
        s = torch.einsum("bkgd,bktd->bkgt",
                         q.double()[:, 0].reshape(b, kv, h // kv, hd),
                         k.double().transpose(1, 2)) / hd ** 0.5
        s = torch.where((arange < lengths[:, None])[:, None, None], s,
                        -torch.inf)
        exact = torch.einsum("bkgt,bktd->bkgd", torch.softmax(s, -1),
                             v.double().transpose(1, 2)).reshape(q.shape)
        scale = exact.abs().max().clamp(min=1.0)
        for name, fn in (("kernel", decode), ("plain", decode_plain)):
            errs[name].append(((fn(q, k, v, lengths).double() - exact)
                               .abs().max() / scale).item())
    worst = {name: max(e) for name, e in errs.items()}
    log(f"[sweep] decode {DECODE_PATH} float32 at yi-9b's score scale "
        f"(std 350), against float64 over {trials} draws: max relative "
        f"|diff| kernel {worst['kernel']:.3e} (median "
        f"{np.median(errs['kernel']):.3e}), plain version {worst['plain']:.3e}"
        f" (median {np.median(errs['plain']):.3e}); bound "
        f"{LAUNCH_TOL[torch.float32]:g}")
    check(worst["kernel"] <= LAUNCH_TOL[torch.float32],
          f"decode_attention at yi-9b's score scale is {worst['kernel']:.3e}"
          f" from float64")


def attention_sweep(flash, flash_plain, decode, decode_plain):
    """Phase 2 for the attention kernels: each against its plain version.
    Returns the largest |diff| of each kernel over its sweep."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    worst_row = 0.0
    for b, s, t, h, kv, hd, window, causal in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, s, h, hd), dtype)
            k, v = (_randn(gen, (b, t, kv, hd), dtype) for _ in range(2))
            out = flash(q, k, v, causal=causal, window=window)
            want = flash_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            worst["flash_attention"] = max(worst["flash_attention"], err)
            row = row_err(out, want)
            log(f"[sweep] flash  b={b} s={s} t={t} h={h} kv={kv} hd={hd} "
                f"window={window} causal={causal} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e}, per row {row:.3e}")
            check(err <= ATTN_TOL[dtype] and out.dtype == dtype,
                  f"flash_attention != plain version at {(b, s, t, h, kv, hd)} "
                  f"window={window} {dtype}: {err}")
            if dtype == torch.bfloat16:
                worst_row = max(worst_row, row)
                check(row <= FLASH_ROW_TOL,
                      f"flash_attention != plain version at "
                      f"{(b, s, t, h, kv, hd)} window={window} {dtype}: a "
                      f"row differs by {row:.3e} of its largest value")
    log(f"[sweep] flash bfloat16 rows: worst max |diff| relative to the "
        f"row's max |plain| {worst_row:.3e} (bound {FLASH_ROW_TOL:g})")
    c3_probe_check(flash, flash_plain)
    cases = [(c, d, e) for c in DECODE_SWEEP for d in DECODE_DTYPES
             for e in ("random", "one", "full")]
    cases.append((DECODE_32K + (0,), DECODE_DTYPES[2], "full"))
    cases += [(DECODE_32K_B1 + (w,), DECODE_DTYPES[2], e)
              for w, e in ((0, "full"), (0, "random"), (5000, "full"))]
    for (b, h, kv, t, hd, window), (qd, cd), edge in cases:
        q = _randn(gen, (b, 1, h, hd), qd)
        k, v = (_randn(gen, (b, t, kv, hd), cd) for _ in range(2))
        lengths = {"random": torch.randint(1, t + 1, (b,), generator=gen,
                                           device="cuda"),
                   "one": torch.ones(b, device="cuda"),
                   "full": torch.full((b,), t, device="cuda")}[edge]
        lengths = lengths.to(torch.int32)
        out = decode(q, k, v, lengths, window=window)
        want = decode_plain(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        worst["decode_attention"] = max(worst["decode_attention"], err)
        log(f"[sweep] decode b={b} h={h} kv={kv} t={t} hd={hd} "
            f"window={window} q={str(qd)[6:]} cache={str(cd)[6:]} "
            f"lengths={edge}: max_abs_err {err:.3e}")
        check(err <= ATTN_TOL[qd] and out.dtype == qd,
              f"decode_attention != plain version at {(b, h, kv, t, hd)} "
              f"window={window} {qd}/{cd} lengths={edge}: {err}")
        del q, k, v
    decode_score_scale_check(decode, decode_plain)
    log(f"[sweep] {len(FLASH_SWEEP) * 2} flash and {len(cases)} decode "
        f"cases; worst |diff| {worst}")
    return worst


# ---------------------------------------------------------------------------
# the yi-9b serving path

# How closely the yi-9b path must agree, and why. The reference's fan_in
# rule gives wq/wk a std of 1/sqrt(heads), so attention scores have a std
# near 350 at full width and most softmax rows are nearly one-hot; a row
# whose top two scores nearly tie passes any small difference in its
# scores on to its output.
#
# LAUNCH_TOL: each kernel launch against its plain version on that
# launch's own inputs, max |diff| relative to max(1, max |plain|): the
# sweep's bound in bfloat16; 1e-4 in float32, where a score of several
# hundred keeps about 2e-5 of rounding, the relative error of its softmax
# weight.
#
# Logits: (median over positions, every position, least top-1 agreement)
# of each position's max |diff| relative to max(1, max |logit|).
# GPU_VS_CPU: the 4096- and 11008-long projections sum in another order
#   (float32) or round to another bfloat16 (bfloat16), and nearly every
#   position has a near-tied row in one of its 64 heads and layers.
# KERNEL_VS_PLAIN: the same GPU path with the plain versions at the two
#   attention call sites shares every projection bit for bit, but a few
#   layers amplify the attention's one-ulp differences; over 48 layers two
#   such runs decorrelate, which is why each launch is checked on its own
#   inputs as well.
LAUNCH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GPU_VS_CPU = {"float32": (1e-4, 1e-2, 0.99), "bfloat16": (3e-2, 0.5, 0.90)}
KERNEL_VS_PLAIN = {"float32": (1e-5, 1e-3, 1.0),
                   "bfloat16": (1e-2, 1e-1, 0.95)}
# a greedy GPU token must be within this share of the logit scale of the
# CPU's largest logit, given the same prefix
GREEDY_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
# Phase 4b holds stablelm-12b, granite-8b and deepseek-7b to phase 4's
# bounds where their readings allow, each beside a control that must land
# outside (the GPU run with every wq scaled by 1.03: in the chip runs of
# this phase its medians read 9.8e-4 to 2.1e-1, outside every bound
# here). stablelm-12b's 100,352-word vocabulary holds near-tied top
# logits: in float32 one of 256 prefill positions flips its top-1 between
# the kernels' and the plain versions' runs where the plain run's top two
# lie 1.7e-6 of the scale apart (a 1.0 agreement cannot hold), and in
# bfloat16 its GPU-vs-CPU prefill agreement read 0.9023, one position
# above phase 4's 0.90. So its float32 kernels-vs-plain top-1 bound is
# 0.99 and its bfloat16 GPU-vs-CPU one 0.85; each control still lands
# outside both, in its own dtype's median.
STABLELM_GPU_VS_CPU = {**GPU_VS_CPU, "bfloat16": (3e-2, 0.5, 0.85)}
STABLELM_KERNEL_VS_PLAIN = {**KERNEL_VS_PLAIN, "float32": (1e-5, 1e-3, 0.99)}
# phase 5d: qwen3-moe at full width, 24 of its 48 layers (15.58 B
# parameters, 62.3 GB of float32 weights: the card's 80 GB less a layer's
# bfloat16 expert cast, the prefill's logits and their comparison)
MOE_DEEP_LAYERS = 24
# phases 4e and 5e: jamba-v0.1-52b at its published widths. 4e runs the
# reduced config's pattern, [ssm + dense, attn + moe] (3,675,001,376
# parameters, 14.70 GB of float32 weights); 5e one whole period of the real
# pattern, 8 of its 32 layers (7 Mamba2 and one attention layer, 4 moe and 4
# dense FFNs; 13,267,656,416 parameters, 53.07 GB), cut from its 4 periods
# (205.84 GB) to fit the card with a moe layer's 5.64 GB bfloat16 expert cast
HYBRID_TWO = {"num_layers": 2, "attn_every": 2, "attn_offset": 1,
              "moe_every": 2, "moe_offset": 1}
HYBRID_DEEP_LAYERS = 8
# Phase 4e's logits bounds. Float32: phase 4's, each control outside (on
# the H100 the GPU-against-CPU medians read 2.0e-5 and 2.6e-6 of the logit
# scale; wq x1.03 moved them to 1.0e-3 and 4.8e-4, in_proj x1.03 to 0.33 and
# 0.22). Bfloat16: the model's one moe layer is its last, with 16 experts
# top-2, so a router pick flipped by a one-ulp change of its logits (ROADMAP
# C14; GPU and CPU agreed on 0.918 of the 512 (token, slot) picks) swaps
# half of that token's FFN output into its logits: the prefill's top-1
# agreement read 0.875 GPU against CPU and 0.926 kernels against plain (the
# kernels' and the plain versions' outputs differ by their bfloat16
# rounding), below phase 4's 0.90 and 0.95, with medians 2.3e-2 and 1.3e-2.
# So both bfloat16 comparisons take stablelm-12b's bfloat16 bound (3e-2,
# 0.5, 0.85), which the in_proj control crosses tenfold (medians 0.24-0.33).
# The wq x1.03 control is held in float32 only: with one attention layer,
# the last, it moves the float32 logits by 1.0e-3 of the scale (median),
# below the 7e-3 that bfloat16 rounding alone moves them GPU against CPU,
# so no bfloat16 bound can tell it from rounding; it is logged there.
HYBRID_GPU_VS_CPU = {**GPU_VS_CPU, "bfloat16": (3e-2, 0.5, 0.85)}
HYBRID_KERNEL_VS_PLAIN = {**KERNEL_VS_PLAIN, "bfloat16": (3e-2, 0.5, 0.85)}


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def logit_gap(got, want, what: str):
    """Per-position max |diff| of ``got`` from ``want`` logits, relative
    to ``want``'s logit scale: (median, max, top-1 agreement), logged."""
    got = got.float().reshape(-1, got.shape[-1]).cpu()
    want = want.float().reshape(-1, want.shape[-1]).cpu()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    scale = max(1.0, want.abs().max().item())
    err = ((got - want).abs().max(-1).values / scale).numpy()
    pick, best = got.argmax(-1), want.argmax(-1)
    top1 = (pick == best).float().mean().item()
    # where the top-1 differs, how far below want's largest logit got's
    # choice lies in want (relative to the scale): a near-tie reads about
    # the position's |diff| or less
    flips = (pick != best).nonzero()[:, 0]
    margin = ((want[flips, best[flips]] - want[flips, pick[flips]]) / scale
              ).max().item() if flips.numel() else 0.0
    log(f"[serve] {what}: relative |diff| median {np.median(err):.3e}, "
        f"p99 {np.quantile(err, 0.99):.3e}, max {err.max():.3e} over "
        f"{err.size} positions; top-1 agreement {top1:.4f}"
        + (f" ({flips.numel()} flips, want's margin over got's choice at "
           f"most {margin:.3e})" if flips.numel() else ""))
    return float(np.median(err)), float(err.max()), top1


def compare_logits(got, want, bounds, what: str) -> None:
    """``got``'s logits within ``bounds`` (median, every position, least
    top-1 agreement) of ``want``'s, as ``logit_gap`` reads them."""
    median, every, top1 = logit_gap(got, want, what)
    check(median <= bounds[0] and every <= bounds[1] and top1 >= bounds[2],
          f"{what}: median {median:.3e} (bound {bounds[0]:g}), max "
          f"{every:.3e} (bound {bounds[1]:g}), top-1 {top1:.4f} (least "
          f"{bounds[2]})")


def control_outside(got, want, bounds, what: str, held: bool = True) -> None:
    """A control's logits must land outside ``bounds`` of ``want``'s: at
    least one of median, max and top-1 agreement crosses its bound. A
    control not ``held`` (one whose move lies below the dtype's rounding)
    is logged only."""
    median, every, top1 = logit_gap(got, want, what)
    outside = median > bounds[0] or every > bounds[1] or top1 < bounds[2]
    log(f"[serve] {what}: the control lands "
        f"{'outside' if outside else 'inside'} the bounds {bounds}"
        + ("" if held else " (logged, not held in this dtype)"))
    check(outside or not held,
          f"{what}: the control lands inside the bounds {bounds}: median "
          f"{median:.3e}, max {every:.3e}, top-1 {top1:.4f}")


def scaled_leaf(params, mixer: str, leaf: str, factor: float = LR_CONTROL):
    """``params`` with leaf ``leaf`` of every ``mixer`` layer scaled by
    ``factor``; the other leaves are shared, not copied."""
    blocks = {pos: ({**blk, mixer: {**blk[mixer],
                                    leaf: blk[mixer][leaf] * factor}}
                    if mixer in blk else blk)
              for pos, blk in params["blocks"].items()}
    return {**params, "blocks": blocks}


def scaled_queries(params, factor: float = LR_CONTROL):
    """``params`` with every attention layer's query projection scaled by
    ``factor``, so every attention score moves by that factor: the dense
    serving paths' control, as a 1.03x learning rate is the FL paths'."""
    return scaled_leaf(params, "attn", "wq", factor)


def scaled_in_proj(params, factor: float = LR_CONTROL):
    """``params`` with every Mamba2 layer's input projection scaled by
    ``factor`` (z, x, B, C and dt alike): the hybrid path's control on the
    scan's side, beside ``scaled_queries`` on the attention's."""
    return scaled_leaf(params, "ssm", "in_proj", factor)


# ---------------------------------------------------------------------------
# the SSD scan and the mamba2-2.7b serving path

SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# each hybrid (phases 4e, 5e) launch against its plain version: the
# attention kernels at phase 4's bound, the scan at phase 6's
HYBRID_LAUNCH_TOL = {
    dtype: {"flash_attention": LAUNCH_TOL[dtype],
            "decode_attention": LAUNCH_TOL[dtype], "ssd_scan": SSD_TOL[dtype]}
    for dtype in (torch.float32, torch.bfloat16)}
# The chunk states and the states before each chunk are float32 in both
# routes (in bfloat16 the state's w x reaches the product as hi + lo, a
# residual near 2^-17): each pass's states within this share of their
# scale of its plain pass's.
SSD_STATE_TOL = 1e-5
# (b, l, h, g, p, n, chunk): tests/test_kernels.py's sweep (a ragged L and
# groups == heads included), a ragged L with G=2, and mamba2-2.7b's head
# shape (G=1, P=64, N=Q=128) up to the path's prefill length; then what
# the three passes and the tensor-core tiles meet: L < Q, two batch rows
# of two groups across 34 chunks with L = 33 Q + 1 (the state passing
# across many chunks, a one-step last chunk), chunk 64 with N = 64 (one
# 64-column box; the tensor-core route at Q = 64), and jamba-v0.1-52b's
# N = 16 at chunk 128 (one 64-column box, 48 of its columns zero fill:
# the tensor-core route in bfloat16), ragged with two groups and at the
# path's prefill shape (H = 128, G = 1, P = 64)
SSD_SWEEP = [
    (2, 64, 4, 1, 16, 8, 16), (1, 96, 8, 2, 32, 16, 32),
    (2, 50, 4, 1, 16, 8, 16), (1, 128, 4, 4, 64, 32, 64),
    (1, 100, 4, 2, 16, 8, 32), (1, 32, 2, 1, 8, 4, 16),
    (2, 300, 8, 8, 64, 128, 128), (1, 4000, 80, 1, 64, 128, 128),
    (1, 100, 8, 1, 64, 128, 128), (2, 4225, 8, 2, 64, 128, 128),
    (2, 1000, 8, 2, 64, 64, 64), (2, 300, 8, 2, 64, 16, 128),
]
SSD_STRIDED = [(2, 1000, 80, 1, 64, 128, 128), (2, 300, 8, 2, 64, 16, 128)]
SSD_PATH = (1, 4096, 80, 1, 64, 128, 128)     # mamba2-2.7b prefill_step
SSD_JAMBA = (1, 4096, 128, 1, 64, 16, 128)    # jamba-v0.1-52b prefill_step


def ssd_inputs(gen, shape, dtype, strided, dt_kind):
    """x, dt, a, B, C for one scan. ``strided``: x, B and C are column
    slices of one (b, l, h*p + 2*g*n) buffer, as the model's conv output
    hands them to the kernel. ``dt_kind``: "small" as in the JAX package's
    tests (|N(0, 0.5)| + 0.01), or "path" as the model draws it with its
    zero ``dt_bias`` (softplus of a small projection, about 0.69)."""
    b, l, h, g, p, n, _ = shape
    if strided:
        xbc = _randn(gen, (b, l, h * p + 2 * g * n), dtype)
        xbc[..., h * p:] *= 0.3
        x = xbc[..., :h * p].reshape(b, l, h, p)
        bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
        cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    else:
        x = _randn(gen, (b, l, h, p), dtype)
        bm, cm = (_randn(gen, (b, l, g, n), dtype) * 0.3 for _ in range(2))
    raw = torch.randn((b, l, h), device="cuda", generator=gen)
    dt = (raw.abs() * 0.5 + 0.01 if dt_kind == "small"
          else torch.nn.functional.softplus(raw * 0.05))
    a = -torch.rand(h, device="cuda", generator=gen) - 0.1
    return x, dt, a, bm, cm


def ssd_sweep(ssd, ssd_plain, kernel_route) -> float:
    """Phase 2 for the SSD scan: the kernel against its plain version.
    Returns the largest |diff|."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(c, False) for c in SSD_SWEEP + [SSD_PATH, SSD_JAMBA]]
    cases += [(c, True) for c in SSD_STRIDED + [SSD_PATH, SSD_JAMBA]]
    worst = worst_rel = 0.0
    for shape, strided in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for dt_kind in ("small", "path"):
                args = ssd_inputs(gen, shape, dtype, strided, dt_kind)
                out = ssd(*args, chunk=shape[-1])
                want = ssd_plain(*args, chunk=shape[-1]).float()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                scale = max(want.abs().max().item(), 1e-6)
                worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
                route = kernel_route(dtype, shape[6], shape[5], shape[4])
                log(f"[sweep] ssd b,l,h,g,p,n,chunk={shape} {str(dtype)[6:]} "
                    f"dt={dt_kind}{' strided' if strided else ''} {route}: "
                    f"max_abs_err {err:.3e} (scale {scale:.3e}, relative "
                    f"{err / scale:.3e})")
                check(err <= SSD_TOL[dtype] * scale and out.dtype == dtype
                      and out.shape == want.shape,
                      f"ssd_scan != plain version at {shape} {dtype} "
                      f"dt={dt_kind} strided={strided}: {err / scale:.3e} "
                      "of the output scale")
                del args, out, want
    log(f"[sweep] {len(cases) * 4} ssd cases; worst |diff| {worst:.3e}, "
        f"worst relative to the output scale {worst_rel:.3e}")
    return worst


def rel_err(got, want) -> float:
    """max |got - want| relative to max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def ssd_pass_check(kernel_passes, plain_passes) -> None:
    """Phase 2: each of the scan kernel's three passes against its plain
    pass at the paths' shapes (mamba2-2.7b's and jamba-v0.1-52b's), fed
    the plain previous pass's output, so that a wrong pass names itself:
    chunk states and decays, the states before each chunk, and the
    outputs."""
    (k_states, k_passing, k_outputs) = kernel_passes
    (p_states, p_passing, p_outputs) = plain_passes
    gen = torch.Generator(device="cuda").manual_seed(7)
    for shape, dtype in itertools.product(
            (SSD_PATH, SSD_JAMBA), (torch.float32, torch.bfloat16)):
        q = shape[-1]
        x, dt, a, bm, cm = ssd_inputs(gen, shape, dtype, True, "path")
        states, decay = p_states(x, dt, a, bm, q)
        got_states, got_decay = k_states(x, dt, a, bm, chunk=q)
        before = p_passing(states, decay)
        errs = {"chunk states": rel_err(got_states, states),
                "chunk decays": rel_err(got_decay, decay),
                "state passing": rel_err(k_passing(states, decay), before)}
        y = k_outputs(x, dt, a, bm, cm, before, chunk=q)
        errs["chunk outputs"] = rel_err(y, p_outputs(x, dt, a, bm, cm,
                                                     before, q))
        torch.cuda.synchronize()
        log(f"[sweep] ssd passes at {shape} {str(dtype)[6:]}, each fed "
            f"the plain previous pass, relative to the plain pass's scale: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (bounds {SSD_STATE_TOL:g}, outputs {SSD_TOL[dtype]:g})")
        for what, e in errs.items():
            bound = SSD_TOL[dtype] if what == "chunk outputs" else SSD_STATE_TOL
            check(e <= bound, f"ssd_scan's {what} pass at {shape} {dtype} "
                  f"differs from its plain pass by {e:.3e} of the scale")
        del x, dt, a, bm, cm, states, decay, got_states, before, y


# The bfloat16 route's float32 operands (ROADMAP C4's contract on the
# tensor cores): pass C's decayed scores, pass A's w-scaled x of the chunk
# state and pass C's S_{c-1} each reach wgmma as bfloat16 hi + lo, never
# rounded alone. SSD_TOL cannot see that (one rounding of such an operand
# moves y by about one bfloat16 rounding). ssd_probe makes one operand take
# the values C3_P, 0.4 and 0.6 of a bfloat16 ulp above 0.75, against
# x = +1 / -1, with a = 0 (no decay): the exact output is a fifth of what
# that operand rounded to bfloat16 makes of it. Held relative to the exact
# output: each hi/lo split leaves at most 0.4% (its lo part's rounding),
# the output's one rounding 0.2%; the operand rounded alone is 400% off.
SSD_SPLIT_PROBES = ("scores", "states", "s_before")
SSD_SPLIT_TOL = 2e-2


def ssd_probe(kind, chunk, device, h=2, p=64, n=128):
    """bfloat16 scan inputs (x, dt, a, b_mat, c_mat) of two chunks on
    ``device`` for the split probe of ``kind``, with the rows (L,) whose
    outputs it checks, their exact values (L,) float64 (every head and
    column alike) and the values the operand rounded to bfloat16 gives.

    scores: chunk 0, dt_j alternating C3_P, x_j = +1 / -1, C_i . B_j = 1
      for odd i (0 for even i): y_i = sum_{j <= i} dt_j x_j.
    states: chunk 0 as above writes dS[0] = sum_j dt_j x_j (w_j = dt_j);
      chunk 1 reads it with no input of its own (B = 0) and C_i = e_0.
    s_before: chunk 0's keys 0 and 1 write S[0] = C3_P[0], S[1] = C3_P[1]
      (x = 1); chunk 1 reads y_i = S[0] - S[1] (C_i = e_0 - e_1, B = 0)."""
    length = 2 * chunk
    p0, p1 = torch.tensor(C3_P, dtype=torch.float32)
    odd = torch.arange(chunk) % 2 == 1
    dtv = torch.where(odd, p1, p0)
    sign = 1.0 - 2.0 * odd.float()
    x, bm, cm = (torch.zeros(1, length, *s) for s in ((h, p), (1, n), (1, n)))
    dt = torch.zeros(1, length, h)
    rows = torch.zeros(length, dtype=torch.bool)
    exact, rounded = (torch.zeros(length, dtype=torch.float64)
                      for _ in range(2))
    terms = dtv.double() * sign.double()
    terms_bf16 = dtv.bfloat16().double() * sign.double()
    if kind in ("scores", "states"):
        dt[0, :chunk] = dtv[:, None]
        x[0, :chunk] = sign[:, None, None]
        bm[0, :chunk, 0, 0] = 1
    if kind == "scores":
        cm[0, 1:chunk:2, 0, 0] = 1
        rows[1:chunk:2] = True
        exact[:chunk], rounded[:chunk] = terms.cumsum(0), terms_bf16.cumsum(0)
    elif kind == "states":
        cm[0, chunk:, 0, 0] = 1
        rows[chunk:] = True
        exact[chunk:], rounded[chunk:] = terms.sum(), terms_bf16.sum()
    elif kind == "s_before":
        dt[0, 0], dt[0, 1] = p0, p1
        x[0, :2] = 1
        bm[0, 0, 0, 0] = bm[0, 1, 0, 1] = 1
        cm[0, chunk:, 0, 0], cm[0, chunk:, 0, 1] = 1, -1
        rows[chunk:] = True
        exact[chunk:] = p0.double() - p1.double()
        rounded[chunk:] = p0.bfloat16().double() - p1.bfloat16().double()
    else:
        raise ValueError(f"no split probe {kind!r}")
    args = (x.bfloat16(), dt, torch.zeros(h), bm.bfloat16(), cm.bfloat16())
    return tuple(t.to(device) for t in args), rows, exact, rounded


def ssd_split_err(y, rows, exact) -> float:
    """max |y - exact| relative to |exact| over the probe's rows (every
    head and column)."""
    got = y.double().cpu()[0, rows]                     # (rows, H, P)
    want = exact[rows][:, None, None]
    return ((got - want).abs() / want.abs()).max().item()


def ssd_split_check(ssd, ssd_plain, kernel_route) -> None:
    """Phase 2: the bfloat16 SSD kernel, through its wrapper, splits each
    float32 operand into bfloat16 hi + lo (ROADMAP C4) at both
    tensor-core chunk sizes."""
    for kind in SSD_SPLIT_PROBES:
        for chunk in (64, 128):
            args, rows, exact, rounded = ssd_probe(kind, chunk, "cuda")
            route = kernel_route(torch.bfloat16, chunk, 128, 64)
            errs = {"kernel": ssd_split_err(ssd(*args, chunk=chunk), rows,
                                            exact),
                    "plain": ssd_split_err(ssd_plain(*args, chunk=chunk),
                                           rows, exact),
                    "bfloat16 operand": ((rounded - exact)[rows].abs()
                                         / exact[rows].abs()).max().item()}
            log(f"[sweep] ssd split probe {kind} chunk={chunk} ({route}): "
                f"exact outputs {exact[rows].min():.4e} .. "
                f"{exact[rows].max():.4e}, error relative to them: "
                + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (bound {SSD_SPLIT_TOL:g})")
            check(route == "tensor_cores" and errs["kernel"] <= SSD_SPLIT_TOL
                  and errs["plain"] <= SSD_SPLIT_TOL,
                  f"ssd_scan does not keep the {kind} operand in float32 "
                  f"(hi + lo) at chunk {chunk}: {errs}, route {route}")
            check(errs["bfloat16 operand"] > SSD_SPLIT_TOL,
                  f"the {kind} split probe cannot tell a bfloat16 operand: "
                  f"{errs}")


# How closely the mamba2 path must agree, and why. It has no attention:
# nothing near one-hot passes a rounding difference on whole, so the
# bounds are those of plain float32 and bfloat16 arithmetic.
# SSD_TOL also bounds each launch against its plain version on that
#   launch's inputs, relative to max(1, max |plain|).
# SSM_GPU_VS_CPU: the 2560-, 5120- and 10576-wide projections sum in
#   another order (float32) or round to another bfloat16 (bfloat16).
# SSM_KERNEL_VS_PLAIN: the same GPU path with the plain scan shares every
#   projection bit for bit; what differs is the scan's summation order,
#   and in bfloat16 the one-ulp flips of y that it causes.
# SSM_CHUNKED_VS_RECURRENT: prefill_step (the chunked scan, the kernel)
#   against decode_step fed the same tokens (the O(1) recurrence): the
#   same function, summed in another order, with one more bfloat16
#   rounding of the conv output on each side.
# SSM_DEEP_F32: 64 layers, kernel vs plain, float32: a difference of
#   ~1e-7 of the scale at each launch, carried through 64 residual blocks.
#   The bfloat16 twin of this comparison is logged and not bounded: there
#   each one-ulp flip of a layer's bfloat16 output is a 2**-8 relative
#   step that the next 63 layers carry on, so the two runs drift apart by
#   rounding alone (a few % of the logit scale), not by a fault.
SSM_GPU_VS_CPU = {"float32": (1e-4, 1e-3, 0.99),
                  "bfloat16": (3e-2, 1e-1, 0.90)}
SSM_KERNEL_VS_PLAIN = {"float32": (1e-5, 1e-4, 0.99),
                       "bfloat16": (1e-2, 5e-2, 0.95)}
SSM_CHUNKED_VS_RECURRENT = SSM_KERNEL_VS_PLAIN
SSM_DEEP_F32 = (1e-4, 1e-3, 0.99)


# ---------------------------------------------------------------------------
# the serving paths: yi-9b (phases 4-5), the other dense, audio and vlm
# models (phases 4b-5c) and mamba2-2.7b (phases 6-7)

def path_inputs(rng, cfg, shape) -> torch.Tensor:
    """A serving path's inputs of ``shape`` (B, S) drawn from numpy's
    ``rng`` on the host: token ids, or for an ``input_mode="embeds"``
    model (llava, whose vision tower and projector are stubbed) float32
    embeds (B, S, d) drawn 0.1 N(0, 1)."""
    if cfg.input_mode == "tokens":
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32))
    return torch.from_numpy((0.1 * rng.standard_normal(
        shape + (cfg.d_model,))).astype(np.float32))


@dataclasses.dataclass
class ServePath:
    """One serving path as phases 4-7 drive it: its full-width config, the
    model module whose kernel call sites a comparison swaps (or, for a
    model whose kernels sit in two modules, the hybrid's, a module a
    kernel), its kernels and their plain versions, the launch counts it
    must show and the bounds it is held to. A token model serves through
    ``prefill_and_decode``; an embeds model through ``make_serve_step``
    fed its embeds position by position (``serve_positions``), as the
    generation loops refuse it."""
    name: str
    cfg: object
    module: object
    kernels: dict
    plain: dict
    prefill_launches: object      # cfg -> {kernel: launches per prefill_step}
    serve_launches: object        # (cfg, positions) -> per prefill_and_decode
    launch_tol: dict              # torch dtype -> bound of each launch
                                  # (or {kernel name: bound})
    gpu_vs_cpu: dict              # dtype name -> compare_logits bounds
    kernel_vs_plain: dict
    deep_note: str                # why the full-depth bfloat16 logits are
                                  # logged against the plain versions' only
    prefill_vs_decode: dict = None  # prefill_step vs decode_step, same tokens
    deep_f32: tuple = None        # full-depth float32 kernels-vs-plain bound
    serve_note: str = ""          # logged beside the full-depth counts
    device_kernels: tuple = ()    # its kernels' names on the card, whose
                                  # share of a profiled prefill is logged
    decode_kernels: tuple = ()    # the same for a profiled decode step
    control: object = None        # params -> perturbed params whose logits
                                  # must land outside both comparisons (or
                                  # {label: such a function}, one a control)
    prefill_seq: int = 4096       # S of the full-depth prefill_step


class swap_calls:
    """Within the block, the named kernel call sites of the model module
    ``module`` (or of ``module[name]``, a dict of modules by name) run
    ``fns`` (a comparison harness: the port itself never falls back)."""

    def __init__(self, fns, module):
        self.fns = fns
        self.mods = (module if isinstance(module, dict)
                     else dict.fromkeys(fns, module))

    def __enter__(self):
        self.saved = {k: getattr(self.mods[k], k) for k in self.fns}
        for k, fn in self.fns.items():
            setattr(self.mods[k], k, fn)

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.mods[k], k, fn)


def path_controls(path, dtype: str = "float32") -> list:
    """(label, params -> perturbed params, held) of each of ``path``'s
    controls in ``dtype``: a control given as (function, dtypes) is held
    outside the bounds in those dtypes only, and logged in the others."""
    if path.control is None:
        return []
    controls = (path.control if isinstance(path.control, dict)
                else {"wq x1.03": path.control})
    out = []
    for label, control in controls.items():
        fn, dtypes = (control if isinstance(control, tuple)
                      else (control, (dtype,)))
        out.append((label, fn, dtype in dtypes))
    return out


def checked_calls(path: ServePath, errs):
    """Every kernel launch of ``path`` also runs its plain version on the
    same inputs and records max |diff| / max(1, max |plain|) in
    ``errs[name]``; the kernel's output goes on."""
    def wrap(name):
        def fn(*args, **kw):
            out = path.kernels[name](*args, **kw)
            want = path.plain[name](*args, **kw).float()
            errs[name].append(((out.float() - want).abs().max()
                               / want.abs().max().clamp(min=1.0)).item())
            return out
        return fn
    return swap_calls({k: wrap(k) for k in path.kernels}, path.module)


def check_launch_errs(errs, tol, what):
    """Each kernel's launches within ``tol`` (a bound, or a bound a kernel
    name) of their plain versions."""
    for name, e in errs.items():
        tol_k = tol[name] if isinstance(tol, dict) else tol
        log(f"[serve] {what}: {name} against its plain version on each "
            f"launch's inputs, {len(e)} launches: relative max |diff| "
            f"{max(e, default=0.0):.3e} (bound {tol_k:g})")
        check(len(e) > 0 and max(e) <= tol_k,
              f"{what}: {name} launch differs from its plain version by "
              f"{max(e, default=float('nan')):.3e} of the output scale")


def reset_launches(path: ServePath) -> None:
    for k in path.kernels.values():
        k.launches = 0


def read_launches(path: ServePath) -> dict:
    return {name: k.launches for name, k in path.kernels.items()}


def check_launches(path, cfg, positions, n_prefill, n_serve, what):
    want_prefill = path.prefill_launches(cfg)
    want_serve = path.serve_launches(cfg, positions)
    check(n_prefill == want_prefill and n_serve == want_serve,
          f"{what}: launches {n_prefill} per prefill_step and {n_serve} per "
          f"prefill_and_decode, expected {want_prefill} and {want_serve}")


def serve_positions(cfg, params, inputs, device, s0: int = 0):
    """``make_serve_step`` fed ``inputs`` (B, S) ids or (B, S, d) embeds one
    position at a time from a fresh cache: what ``prefill_and_decode``
    does with a prompt and its tokens, and how an embeds model serves.
    Returns (logits (B, S, V) on ``device``, stats): the first ``s0``
    positions count as the prefill, the rest as decode steps, each span
    fenced."""
    from repro_torch.launch.serve import fence
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import init_cache

    b, seq = inputs.shape[:2]
    device = torch.device(device)
    inputs = inputs.to(device)
    step = make_serve_step(cfg)
    cache = init_cache(cfg, b, seq, dtype=torch.float32, device=device)
    out = []
    t0 = t1 = fence(device)
    for i in range(seq):
        if i == s0:
            t1 = fence(device)
        logits, cache = step(params, cache, inputs[:, i:i + 1], i)
        out.append(logits)
    t2 = fence(device)
    return torch.cat(out, dim=1), {
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "decode_tok_s": b * (seq - s0) / max(t2 - t1, 1e-9)}


def teacher_forced_logits(cfg, params, toks, device):
    """Per-position logits (B, S, V) of ``decode_step`` fed ``toks`` (ids,
    or an embeds model's embeds), as float32 on the host."""
    return serve_positions(cfg, params, toks, device)[0].float().cpu()



def greedy_near_max(want_tf, toks, other, s0, dtype, what, got_name,
                    want_name) -> None:
    """Every generated token of ``toks`` (B, S0 + N) must lie within
    ``GREEDY_TOL`` of the logit scale of the largest of ``want_tf``, the
    per-position logits (B, S, V) of another run fed the same tokens; the
    share equal to ``other``'s tokens is logged (``other`` None: to
    ``want_tf``'s own greedy picks given the same prefixes)."""
    n = toks.shape[1] - s0
    tol = GREEDY_TOL[dtype] * max(1.0, want_tf.abs().max().item())
    prev = want_tf[:, s0 - 1:s0 + n - 1].float()            # (B, N, V)
    chosen = prev.gather(-1, toks[:, s0:].long().unsqueeze(-1))[..., 0]
    near = (chosen >= prev.max(-1).values - tol).float().mean().item()
    picks = prev.argmax(-1) if other is None else other[:, s0:].cpu()
    same = (toks[:, s0:].cpu() == picks).float().mean().item()
    log(f"[serve] {what}: {got_name} tokens equal to the {want_name}'s"
        + (" greedy picks given the same prefixes" if other is None else "")
        + f": {same:.4f}; {got_name} tokens within {tol:.3e} of the "
        f"{want_name}'s max logit: {near:.4f}")
    check(near == 1.0, f"{what}: a {got_name} token is not a near-max of "
          f"the {want_name}'s logits")


# The 2-layer CPU references of phases 4-4e and 6 run in a pool of spawned
# workers while the card goes on with the next paths (one after another
# in the main process, phase 4b's took most of its 187.7 s). Each
# worker draws the path's weights from the same CPU generator as the main
# process does for the GPU's copy, so both start from the same bits.
SERVE_WORKERS, SERVE_WORKER_THREADS = 2, 3
# The workers run at the lowest scheduling priority: their results are
# read only after phase 9, while the FL phases' main process and phase
# 3g's CPU pool are waited on as they run. At the default priority, with
# jamba's reference in the pool (~215 s of worker time), phases 3g and 3h
# took 53.3 and 60.2 s against the parent tree's 27.3 and 36.3 on the same
# H100 host, their CPU pool's runs 1.9x slower.
SERVE_WORKER_NICE = 19
SERVE_S0, SERVE_N = 16, 8       # the 2-layer serving run's prompt + tokens


@contextlib.contextmanager
def serve_pool():
    """The worker pool of the 2-layer serving paths' CPU runs (and phase
    9 (d)'s), spawned, ``SERVE_WORKER_THREADS`` threads a worker, each at
    ``SERVE_WORKER_NICE``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            SERVE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_serve_worker,
            initargs=(SERVE_WORKER_THREADS,)) as pool:
        yield pool


def _serve_worker(threads: int) -> None:
    os.nice(SERVE_WORKER_NICE)
    torch.set_num_threads(threads)


def two_layer_cfg(path: ServePath):
    return dataclasses.replace(path.cfg, num_layers=2)


def prefetched_weights(phases):
    """Each (phase, path) of ``phases`` with its 2-layer weights drawn on
    the CPU (``draw_two_layers``); the next path's are drawn in a thread
    while the card serves the current one. The first path's draw starts at
    the call, so that it runs under whatever the caller does before it
    iterates."""
    from concurrent.futures import ThreadPoolExecutor

    drawer = ThreadPoolExecutor(1)
    first = drawer.submit(draw_two_layers, two_layer_cfg(phases[0][1]))
    return _prefetched(drawer, first, phases)


def _prefetched(drawer, ahead, phases):
    with drawer:
        for i, (phase, path) in enumerate(phases):
            t0 = time.perf_counter()
            params = ahead.result()
            log(f"[serve] 2-layer {path.name} weights drawn on the CPU "
                f"(waited {time.perf_counter() - t0:.1f}s)")
            if i + 1 < len(phases):
                ahead = drawer.submit(draw_two_layers,
                                      two_layer_cfg(phases[i + 1][1]))
            yield phase, path, params
            del params


def draw_two_layers(cfg):
    """A 2-layer path's weights, drawn on the CPU from seed 0."""
    from repro_torch.models.transformer import init_model

    return init_model(torch.Generator().manual_seed(0), cfg,
                      torch.device("cpu"))


class recorded_routes:
    """Within the block, every ``router_topk`` call of the moe block
    appends its (N, k) expert indices, on the host, to ``self.layers``:
    one entry a moe layer of a prefill. A no-op for a model without a moe
    layer (the moe family's are all moe; the hybrid's every other)."""

    def __init__(self, cfg):
        from repro_torch.models.transformer import block_pattern

        self.moe = any(ffn == "moe" for _, ffn in block_pattern(cfg))
        self.layers = []

    def __enter__(self):
        if self.moe:
            from repro_torch.models import moe

            route = moe.router_topk

            def record(logits, k):
                out = route(logits, k)
                self.layers.append(out[1].cpu())
                return out
            self.swap = swap_calls({"router_topk": record}, moe)
            self.swap.__enter__()
        return self

    def __exit__(self, *exc):
        if self.moe:
            self.swap.__exit__(*exc)


def _kernel_counts() -> int:
    """Every kernel wrapper's launches in this process."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return (flash_attention.launches + decode_attention.launches
            + ssd_scan.launches)


# the leaves the models read through ``.float()``, which a cast copy would
# change: the norms' scales (``*norm``) and the Mamba2 mixer's conv weights
# and bias, decay, skip and step-size bias (models/mamba2.py)
FLOAT_LEAVES = ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias")


def cast_matrices(params, dtype):
    """``params`` with every weight matrix cast to ``dtype``, the norm
    scales and the Mamba2 leaves of ``FLOAT_LEAVES`` left float32. Every
    model reads each matrix (the projections, the experts, the embedding
    table) through ``.to(<activation dtype>)``, a no-op on a cast copy, so
    a run in ``dtype`` computes the same bits from it without casting
    every weight at every call (the CPU's bfloat16 references took 1.5 to
    2.6 times their float32 runs' time on the H100's host);
    ``cast_bit_check`` holds that on the CPU."""
    return {k: (cast_matrices(v, dtype) if isinstance(v, dict)
                else v if k.endswith("norm") or k in FLOAT_LEAVES
                else v.to(dtype))
            for k, v in params.items()}


def cast_bit_check(cfg) -> None:
    """On the CPU at ``cfg`` (a reduced config), bfloat16: the prefill
    logits and the greedy serving run from ``cast_matrices``' copy equal
    those of the float32 weights bit for bit."""
    from repro_torch.launch.serve import prefill_and_decode
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_model(torch.Generator().manual_seed(0), cfg,
                        torch.device("cpu"))
    cast = cast_matrices(params, torch.bfloat16)
    rng = np.random.default_rng(0)
    tokens = path_inputs(rng, cfg, (2, 40))
    prompts = path_inputs(rng, cfg, (2, 8))
    same = torch.equal(make_prefill_step(cfg)(params, tokens),
                       make_prefill_step(cfg)(cast, tokens))
    runs = [prefill_and_decode(cfg, p, prompts, max_len=16, new_tokens=8)[0]
            for p in (params, cast)]
    same_toks = torch.equal(*runs)
    log(f"[serve] {cfg.name} reduced, bfloat16 on the CPU: cast_matrices' "
        f"copy gives the float32 weights' prefill logits bit for bit: "
        f"{same}; the same greedy tokens: {same_toks}")
    check(same and same_toks, f"{cfg.name}: cast_matrices' copy changes "
          "the bfloat16 run's bits")


def _cpu_serve(base, tokens, prompts, gpu_tokens):
    """A 2-layer path's CPU runs, in a worker: its weights drawn as the
    main process draws them, then per dtype the prefill_step logits (and
    the moe router's picks) and the decode logits teacher-forced along the
    GPU's tokens ``gpu_tokens[dtype]`` (an embeds model: its served
    logits). Returns {dtype: {...}} and the kernels this process launched
    (none may be). A bfloat16 run reads ``cast_matrices``' copy: the same
    bits. The CPU generates no tokens of its own: every check reads the
    teacher-forced logits, and its greedy picks given the GPU's prefixes
    are their argmax (a greedy run of its own, which only a logged share
    read, doubled the decode steps, the larger part of each reference's
    time)."""
    from repro_torch.launch.steps import make_prefill_step

    t0 = time.perf_counter()
    params = draw_two_layers(base)
    out = {"drawn_s": time.perf_counter() - t0}
    embeds = base.input_mode != "tokens"
    for dtype, gt in gpu_tokens.items():
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        run = params
        if dtype == "bfloat16":
            run = cast_matrices(params, torch.bfloat16)
        with recorded_routes(cfg) as routes:
            logits = make_prefill_step(cfg)(run, tokens)
        if embeds:
            tf = serve_positions(cfg, run, prompts, "cpu",
                                 SERVE_S0)[0].float()
        else:
            tf = teacher_forced_logits(cfg, run, gt, "cpu")
        del run
        out[dtype] = {"logits": logits.float(), "tf": tf,
                      "routes": routes.layers,
                      "seconds": time.perf_counter() - t0}
    out["launches"] = _kernel_counts()
    return out


def route_agreement(what, got, want) -> None:
    """Log, layer by layer, the share of (token, slot) routings two runs
    agree on, and the share of tokens routed to the same expert set."""
    rows = []
    for i, (g, w) in enumerate(zip(got, want)):
        same = (g == w).float().mean().item()
        sets = (g.sort(-1).values == w.sort(-1).values).all(-1)
        rows.append(f"layer {i}: {same:.4f} of {g.numel()} (token, slot) "
                    f"routings, {sets.float().mean().item():.4f} of tokens' "
                    "expert sets")
    log(f"[serve] {what}: routings agreeing, " + "; ".join(rows))


def serve_two_layers(path: ServePath, cpu_params, pool):
    """Phases 4, 4b, 4c, 4d, 4e and 6: ``path`` at full width and 2
    layers on the GPU from ``cpu_params`` (CPU-drawn,
    ``draw_two_layers``), in float32 and bfloat16, and on the GPU with the
    plain versions in place of the kernels; the same on the CPU in
    ``pool`` (``_cpu_serve``). A token model generates 16 + 8 tokens; an
    embeds model serves 24 embeds positions through ``make_serve_step``
    (``serve_positions``). The card's checks run now; returns
    ``finish()``, which waits for the CPU run and holds the GPU against
    it."""
    from repro_torch.launch.serve import prefill_and_decode
    from repro_torch.launch.steps import make_prefill_step

    base = two_layer_cfg(path)
    gpu_params = _tree(cpu_params, lambda x: x.cuda())
    del cpu_params
    embeds = base.input_mode != "tokens"
    rng = np.random.default_rng(0)
    s0, n = SERVE_S0, SERVE_N
    tokens = path_inputs(rng, base, (1, 256))
    prompts = path_inputs(rng, base, (4, s0 + n if embeds else s0))
    gpu = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        prefill = make_prefill_step(cfg)
        what = f"{path.name} 2 layers {dtype}"
        t0 = time.perf_counter()
        reset_launches(path)
        with recorded_routes(cfg) as routes:
            logits = prefill(gpu_params, tokens.cuda())
        n_prefill = read_launches(path)
        reset_launches(path)
        if embeds:
            served, _ = serve_positions(cfg, gpu_params, prompts, "cuda", s0)
            gt, g_tf = prompts, served.float().cpu()
            serve_what = (f"served {tuple(served.shape)} through "
                          "make_serve_step")
        else:
            gt, _ = prefill_and_decode(cfg, gpu_params, prompts.cuda(),
                                       max_len=s0 + n, new_tokens=n)
            gt, g_tf = gt.cpu(), None
            serve_what = f"generated {tuple(gt.shape)}"
        n_serve = read_launches(path)
        log(f"[serve] {what} cuda: prefill_step {tuple(logits.shape)}, "
            f"{serve_what}; launches {n_prefill} per prefill_step, {n_serve} "
            f"per serving run; {time.perf_counter() - t0:.1f}s")
        check_launches(path, cfg, s0 + n, n_prefill, n_serve, what)
        gl = logits.float().cpu()
        # decode logits compared along the GPU's own tokens (an embeds
        # model's serving run is that path already)
        if not embeds:
            g_tf = teacher_forced_logits(cfg, gpu_params, gt, "cuda")
        # each control's GPU run with the kernels: (label, prefill logits,
        # teacher-forced logits), held against the CPU in finish()
        ctls = []
        for label, control, held in path_controls(path, dtype):
            ctl = control(gpu_params)
            ctls.append((label, held,
                         prefill(ctl, tokens.cuda()).float().cpu(),
                         teacher_forced_logits(cfg, ctl, gt, "cuda")))
            del ctl
        if path.prefill_vs_decode is not None:
            compare_logits(prefill(gpu_params, gt.cuda()), g_tf,
                           path.prefill_vs_decode[dtype],
                           f"{what} prefill_step vs decode_step fed the same "
                           "tokens on the card")
        with swap_calls(path.plain, path.module):
            pl = prefill(gpu_params, tokens.cuda())
            p_tf = teacher_forced_logits(cfg, gpu_params, gt, "cuda")
            ctl_plain = []
            for label, control, held in path_controls(path, dtype):
                ctl = control(gpu_params)
                ctl_plain.append((label, held, prefill(ctl, tokens.cuda()),
                                  teacher_forced_logits(cfg, ctl, gt,
                                                        "cuda")))
                del ctl
        compare_logits(gl, pl, path.kernel_vs_plain[dtype],
                       f"{what} prefill_step, kernels vs plain on the card")
        compare_logits(g_tf, p_tf, path.kernel_vs_plain[dtype],
                       f"{what} decode_step, kernels vs plain on the card")
        for label, held, ctl_ppl, ctl_ptf in ctl_plain:
            control_outside(gl, ctl_ppl, path.kernel_vs_plain[dtype],
                            f"{what} prefill_step, kernels vs plain with "
                            f"{label} (control) on the card", held)
            control_outside(g_tf, ctl_ptf, path.kernel_vs_plain[dtype],
                            f"{what} decode_step, kernels vs plain with "
                            f"{label} (control) on the card", held)
        del ctl_plain
        errs = {k: [] for k in path.kernels}
        with checked_calls(path, errs):
            prefill(gpu_params, tokens.cuda())
            teacher_forced_logits(cfg, gpu_params, gt, "cuda")
        check_launch_errs(errs, path.launch_tol[getattr(torch, dtype)], what)
        gpu[dtype] = (gl, gt, g_tf, ctls, routes.layers)
    del gpu_params
    torch.cuda.empty_cache()
    job = pool.submit(_cpu_serve, base, tokens, prompts,
                      {dtype: v[1] for dtype, v in gpu.items()})

    def finish() -> None:
        cpu = job.result()
        log(f"[serve] {path.name} 2 layers: the CPU run's weights drawn in "
            f"its worker in {cpu['drawn_s']:.1f}s")
        check(cpu["launches"] == 0,
              f"{path.name}: the CPU run launched {cpu['launches']} kernels")
        for dtype, (gl, gt, g_tf, ctls, g_routes) in gpu.items():
            what = f"{path.name} 2 layers {dtype}"
            c = cpu[dtype]
            cl, c_tf = c["logits"], c["tf"]
            log(f"[serve] {what} cpu: prefill_step {tuple(cl.shape)}, "
                f"decode logits {tuple(c_tf.shape)} along the GPU's "
                f"positions; {c['seconds']:.1f}s in its worker")
            bounds = path.gpu_vs_cpu[dtype]
            if g_routes:
                route_agreement(f"{what} prefill_step B=1 S=256, GPU vs CPU",
                                g_routes, c["routes"])
            compare_logits(gl, cl, bounds,
                           f"{what} prefill_step B=1 S=256, GPU vs CPU")
            compare_logits(g_tf, c_tf, bounds, f"{what} decode_step B=4 "
                           "(teacher forced), GPU vs CPU")
            for label, held, ctl_pl, ctl_tf in ctls:
                control_outside(ctl_pl, cl, bounds, f"{what} prefill_step "
                                f"B=1 S=256, control ({label}) GPU vs CPU",
                                held)
                control_outside(ctl_tf, c_tf, bounds, f"{what} decode_step "
                                f"B=4, control ({label}) GPU vs CPU", held)
            if not embeds:
                # every GPU token, given the same prefix, is a near-maximum
                # of the CPU's logits
                greedy_near_max(c_tf, gt, None, s0, dtype,
                                f"{what} greedy", "GPU", "CPU")

    return finish


def hybrid_path(cfg) -> ServePath:
    """The hybrid family's serving path (ROADMAP A10.4c; phases 4e and 5e)
    at ``cfg``: jamba-v0.1-52b's attention layers on the flash and decode
    kernels (``models/layers.py``), its Mamba2 layers on the scan
    (``models/mamba2.py``), with a control on each side (wq x1.03 on the
    attention's, in_proj x1.03 on the scan's)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    from repro_torch.models import layers, mamba2
    from repro_torch.models.transformer import block_pattern, num_repeats

    def mixers(cfg, kind):
        return num_repeats(cfg) * sum(m == kind for m, _ in block_pattern(cfg))

    return ServePath(
        name=cfg.name, cfg=cfg,
        module={"flash_attention": layers, "decode_attention": layers,
                "ssd_scan": mamba2},
        kernels={"flash_attention": flash_attention,
                 "decode_attention": decode_attention, "ssd_scan": ssd_scan},
        plain={"flash_attention": flash_attention_plain,
               "decode_attention": decode_attention_plain,
               "ssd_scan": ssd_scan_plain},
        prefill_launches=lambda cfg: {
            "flash_attention": mixers(cfg, "attn"), "decode_attention": 0,
            "ssd_scan": mixers(cfg, "ssm")},
        serve_launches=lambda cfg, positions: {
            "flash_attention": 0,
            "decode_attention": mixers(cfg, "attn") * positions,
            "ssd_scan": 0},
        launch_tol=HYBRID_LAUNCH_TOL, gpu_vs_cpu=HYBRID_GPU_VS_CPU,
        kernel_vs_plain=HYBRID_KERNEL_VS_PLAIN,
        device_kernels=("flash_attention_kernel",) + SSD_KERNELS,
        decode_kernels=DECODE_KERNELS,
        control={"wq x1.03": (scaled_queries, ("float32",)),
                 "ssm in_proj x1.03": scaled_in_proj},
        deep_note="one-ulp bfloat16 flips carried through 7 Mamba2 layers "
        "into near-one-hot attention rows, and a router pick flipped by a "
        "rounding moves its token's whole expert output",
        serve_note="prefill_and_decode launches no ssd_scan, as in the "
        "reference: its _prefill feeds the prompt through decode_step, "
        "whose Mamba2 layers run the O(1) recurrence and whose attention "
        "layer runs decode_attention at every position")


def profiled(fn, what: str, focus=()) -> None:
    """``fn(1)`` under the profiler, after a warm-up call ``fn(0)``."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    profile_report(prof, wall_us, what, focus)


def serve_full_depth(path: ServePath) -> dict:
    """Phases 5, 5b, 5c, 5d, 5e and 7: ``path`` at full width and depth
    (5d and 5e cut in depth to fit the card), weights drawn on the card
    from a CUDA generator. Returns the launch counts of
    the timed ``prefill_step`` (at ``path.prefill_seq``) and serving run
    (``prefill_and_decode``, or an embeds model's ``serve_positions``, over
    16 + 32 positions) together."""
    from repro_torch.launch.serve import prefill_and_decode
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import (
        init_cache, init_model, model_specs,
    )
    from repro_torch.nn.module import param_count

    cfg, cuda, seq = path.cfg, torch.device("cuda"), path.prefill_seq
    embeds = cfg.input_mode != "tokens"
    what = f"{path.name} {cfg.num_layers} layers"
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        cuda)
    torch.cuda.synchronize()
    n_params = param_count(model_specs(cfg))
    log(f"[serve] {what}: {n_params:,} parameters ({4 * n_params / 1e9:.2f}"
        f" GB float32) drawn on the card in {time.perf_counter() - t0:.2f}s;"
        f" {cfg.dtype} activations")
    rng = np.random.default_rng(1)
    tokens = path_inputs(rng, cfg, (1, seq)).to(cuda)
    prompts = path_inputs(rng, cfg, (4, 48 if embeds else 16)).to(cuda)
    prefill = make_prefill_step(cfg)

    def serve(positions):
        """The serving run over ``positions`` = 16 + N: (tokens or the
        embeds served (B, 16 + N, V) logits, stats)."""
        if embeds:
            return serve_positions(cfg, params, prompts[:, :positions],
                                   cuda, 16)
        return prefill_and_decode(cfg, params, prompts, max_len=positions,
                                  new_tokens=positions - 16)

    # warm-up at small shapes (library handles, first launches): not timed
    prefill(params, tokens[:, :256])
    serve(18)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_launches(path)
    t0 = time.perf_counter()
    logits = prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = read_launches(path)
    reset_launches(path)
    toks, stats = serve(48)
    n_serve = read_launches(path)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the caching allocator's cudaMalloc retries (each frees cached blocks
    # and synchronises) during the two timed runs
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    log(f"[serve] {what}: prefill_step B=1 S={seq}: {prefill_s * 1e3:.3f} ms"
        f" ({seq / prefill_s:.1f} tokens/s); "
        + ("make_serve_step B=4 over 16 + 32 embeds positions" if embeds
           else "prefill_and_decode B=4 16+32")
        + f": prefill {stats['prefill_s'] * 1e3:.3f} ms, decode "
        f"{stats['decode_s'] * 1e3:.3f} ms ({stats['decode_s'] * 1e3 / 32:.3f}"
        f" ms/step, {stats['decode_tok_s']:.2f} tokens/s); launches "
        f"{n_prefill} in prefill_step, {n_serve} in prefill_and_decode; peak "
        f"device memory {peak:.2f} GB, allocator retries {retries}")
    if path.serve_note:
        log(f"[serve] {path.name}: {path.serve_note}")
    check_launches(path, cfg, 48, n_prefill, n_serve, f"{what} full depth")
    check(tuple(logits.shape) == (1, seq, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{what}: prefill logits are not finite (1, S, V)")
    if embeds:
        check(tuple(toks.shape) == (4, 48, cfg.vocab_size)
              and bool(torch.isfinite(toks).all()),
              f"{what}: the served logits are not finite (4, 48, V)")
    else:
        check(tuple(toks.shape) == (4, 48) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size,
              f"{what}: generated tokens out of shape or range")
    with swap_calls(path.plain, path.module):
        plain_logits = prefill(params, tokens)
    # position by position in float32, a chunk at a time: the whole (S, V)
    # in float32 is 2.5 GB at qwen3-moe's vocabulary
    scale = max(1.0, plain_logits.abs().max().float().item())
    err = torch.cat([(logits[0, i:i + 512].float()
                      - plain_logits[0, i:i + 512].float()).abs().amax(-1)
                     for i in range(0, seq, 512)]) / scale
    top1 = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()
    log(f"[serve] {what} {cfg.dtype} prefill_step S={seq}, kernels vs plain "
        f"on the card (not bounded: {path.deep_note}): relative |diff| "
        f"median {err.median().item():.3e}, max {err.max().item():.3e}; "
        f"top-1 agreement {top1.item():.4f}")
    del logits, plain_logits
    # every launch of a prefill and a decode step against the plain
    # version on that launch's inputs (outside the counted, timed run)
    errs = {k: [] for k in path.kernels}
    with checked_calls(path, errs):
        prefill(params, tokens)
        serve(18)
    check_launch_errs(errs, path.launch_tol[getattr(torch, cfg.dtype)], what)
    if path.deep_f32 is not None:
        prefill32 = make_prefill_step(dataclasses.replace(cfg,
                                                          dtype="float32"))
        reset_launches(path)
        k32 = prefill32(params, tokens)
        check(read_launches(path) == path.prefill_launches(cfg),
              f"{what} float32: launches {read_launches(path)} per "
              f"prefill_step, expected {path.prefill_launches(cfg)}")
        with swap_calls(path.plain, path.module):
            p32 = prefill32(params, tokens)
        compare_logits(k32, p32, path.deep_f32, f"{what} float32 "
                       f"prefill_step S={seq}, kernels vs plain on the card")
        del k32, p32
        torch.cuda.empty_cache()

    profiled(lambda i: prefill(params, tokens),
             f"one {path.name} prefill_step, B=1, S={seq}, "
             f"{cfg.num_layers} layers", path.device_kernels)
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 4, 48, dtype=torch.float32, device=cuda)
    fed = prompts if embeds else toks
    profiled(lambda i: step(params, cache, fed[:, 15 + i:16 + i], 15 + i),
             f"one {path.name} decode step, B=4, {cfg.num_layers} layers",
             path.decode_kernels)
    del params, cache
    torch.cuda.empty_cache()
    return {k: n_prefill[k] + n_serve[k] for k in path.kernels}


# Phase 4c's rolling cache on llava (layers._attend_cached's window-sized
# ring buffer): 2 layers at full width, float32, its 4096-key window cut
# to 64 over 96 positions so that the ring wraps (the reference's own
# test, tests/test_perf_variants.py, cuts it to 8 over 24), held against
# the full cache within ROLLING_TOL of the full cache's largest logit, as
# that test holds it; the same decode without a window must land outside
# (the window binds).
ROLLING = {"layers": 2, "window": 64, "positions": 96, "batch": 4}
ROLLING_TOL = 1e-4


def rolling_cache_check(llava_cfg) -> None:
    from repro_torch.models.transformer import cache_specs, init_model

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llava_cfg, num_layers=ROLLING["layers"],
                              dtype="float32",
                              sliding_window=ROLLING["window"])
    roll = dataclasses.replace(cfg, rolling_cache=True)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        torch.device("cuda"))
    x = path_inputs(np.random.default_rng(2), cfg,
                    (ROLLING["batch"], ROLLING["positions"]))
    full, rolled, wide = (teacher_forced_logits(c, params, x, "cuda") for c in
                          (cfg, roll, dataclasses.replace(
                              cfg, sliding_window=0)))
    width = cache_specs(roll, ROLLING["batch"], ROLLING["positions"])[
        "pos0"]["attn"]["k"].shape[2]
    scale = full.abs().max().item()
    err = (full - rolled).abs().max().item() / scale
    err_w = (full - wide).abs().max().item() / scale
    log(f"[serve] {llava_cfg.name} 2 layers float32, window cut from "
        f"{llava_cfg.sliding_window} to {ROLLING['window']} over "
        f"{ROLLING['positions']} positions (B={ROLLING['batch']}): the rolling"
        f" cache ({width} slots) against the full cache, max |diff| / max "
        f"|logit| {err:.3e} (bound {ROLLING_TOL}); control, the full cache "
        f"without the window: {err_w:.3e}; {time.perf_counter() - t0:.1f}s")
    check(width == ROLLING["window"], f"the rolling cache holds {width} "
          f"slots, not the window's {ROLLING['window']}")
    check(err <= ROLLING_TOL, f"llava's rolling cache {err} from the full "
          "cache")
    check(err_w > ROLLING_TOL, "llava's window does not bind: the decode "
          "without it is within the rolling cache's bound")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7b: LM fleet serving (ROADMAP A10.2)

# yi-9b at full width and 2 layers: K = 8 client models (the base model
# plus 0.01 N(0, 1) each, the CLI's draw) in one (8, P) arena on the card,
# and a batch of 8 requests over six distinct clients, two of them shared.
FLEET_K = 8
FLEET_LANES = (3, 0, 5, 3, 1, 7, 0, 2)
FLEET_S0, FLEET_N = 16, 32
FLEET_CONTROL = 3                   # the routing control's client
# The host-resident fleet serves two batches of 4 over rows 0-3 (so a
# fleet of the first 4 rows serves them too): 3 distinct clients each.
FLEET_HOST_LANES = ((3, 0, 1, 3), (2, 1, 2, 0))
FLEET_HOST_MEM = 64e9               # MemAvailable under which the host
                                    # fleet holds 4 rows, not 8
# FLEET_VS_LOOP: a request's teacher-forced float32 logits through the
# fleet against the per-model loop's on the card (median, every position,
# least top-1 agreement over its 48 positions, as compare_logits reads
# them). Both run the same weights and the same kernels on the same card:
# only the batched projections' summation order differs from the single
# model's, so phase 4's float32 GPU-against-CPU bound holds with room, and
# the top-1 bound leaves one near-tie flip in 48. The routing control
# (client 3's wq x1.03, every score of its requests moved by 3%) reads
# medians near 1e-3 at full width (phase 4b), outside it.
FLEET_VS_LOOP = (1e-4, 1e-2, 0.95)
# mamba2-2.7b at full width and 2 layers: K = 4, B = 4
MAMBA_FLEET_LANES = (2, 0, 3, 2)
# the reduced yi-9b config at the reference test's sizes (K = 5, B = 6,
# prompts of 8, 6 new tokens), GPU against CPU
SMOKE_FLEET = (5, 6, 8, 6)


def mem_available() -> float:
    """The host's MemAvailable in bytes (from /proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return float(line.split()[1]) * 1024
    return float("nan")


def fleet_teacher_forced(cfg, fleet, lanes, toks):
    """Per-position logits (B, S, V) of the fleet's decode step fed
    ``toks``, on the host."""
    from repro_torch.serve.fleet import FleetDecoder

    dec = FleetDecoder(cfg)
    stack, local = fleet.rows(lanes)
    tree = fleet.tree(stack)
    cache = dec.new_cache(len(lanes), toks.shape[1], device=fleet.device)
    toks = toks.to(fleet.device)
    out = []
    for i in range(toks.shape[1]):
        logits, cache = dec.decode_step(tree, local, toks[:, i], cache, i)
        out.append(logits.float().cpu())
    return torch.stack(out, 1)


def loop_teacher_forced(cfg, fleet, lanes, toks):
    """The same through each request's own model alone (``decode_step`` of
    ``fleet.model(lane)``, one distinct client at a time)."""
    lanes = np.asarray(lanes)
    out = torch.empty(tuple(toks.shape) + (cfg.vocab_size,))
    for lane in np.unique(lanes):
        sel = torch.from_numpy(np.flatnonzero(lanes == lane))
        out[sel] = teacher_forced_logits(cfg, fleet.model(int(lane)),
                                         toks.cpu()[sel], fleet.device)
    return out


def fleet_vs_loop(fleet_tf, loop_tf, lanes, outside, what) -> None:
    """Each request's fleet logits within ``FLEET_VS_LOOP`` of the loop's,
    except the requests of the clients in ``outside``, which must land
    outside it."""
    for b, lane in enumerate(lanes):
        tag = f"{what}, request {b} (client {lane})"
        if lane in outside:
            control_outside(fleet_tf[b], loop_tf[b], FLEET_VS_LOOP, tag)
        else:
            compare_logits(fleet_tf[b], loop_tf[b], FLEET_VS_LOOP, tag)


def fleet_stats_line(stats, n: int) -> str:
    return (f"prefill {stats['prefill_s'] * 1e3:.3f} ms, decode "
            f"{stats['decode_s'] * 1e3:.3f} ms ({stats['decode_s'] * 1e3 / n:.3f}"
            f" ms a step, {stats['decode_tok_s']:.2f} tokens/s), "
            f"{stats['requests_s']:.3f} requests/s, dispatches "
            f"{stats['prefill_dispatches']} + "
            f"{stats['decode_dispatches_per_step']} a step over "
            f"{stats['distinct_models']} models")


def yi_fleet(path: ServePath) -> int:
    """(a)-(d) of phase 7b: yi-9b's K = 8 fleet at full width and 2 layers.
    Returns the timed run's decode_attention launches."""
    from repro_torch.launch.serve import draw_fleet
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve.fleet import (
        FleetDecoder, FleetParams, fleet_prefill_and_decode,
        loop_prefill_and_decode,
    )

    cuda = torch.device("cuda")
    cfg = dataclasses.replace(path.cfg, num_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    s0, n, lanes = FLEET_S0, FLEET_N, np.array(FLEET_LANES)
    what = f"yi-9b fleet K={FLEET_K} 2 layers"
    # the CLI at full depth: K = 8 models of 35.3 GB cannot fit, and it
    # must say so before drawing any
    t0, held = time.perf_counter(), torch.cuda.memory_allocated()
    try:
        serve_main(["--fleet", str(FLEET_K)])
        refused = None
    except RuntimeError as err:
        refused = str(err)
    log(f"[7b] serve --fleet {FLEET_K} (yi-9b, 48 layers) in "
        f"{time.perf_counter() - t0:.2f}s: {refused}")
    check(refused is not None and "does not fit" in refused
          and torch.cuda.memory_allocated() == held,
          f"serve --fleet {FLEET_K} at full depth did not refuse before "
          "drawing")
    t0 = time.perf_counter()
    arena, layout = draw_fleet(cfg, FLEET_K, cuda)
    fleet = FleetParams.from_arena(arena, layout, device=cuda)
    torch.cuda.synchronize()
    log(f"[7b] {what}: {arena.shape[1]:,} parameters a model, the arena "
        f"{tuple(arena.shape)} {arena.numel() * 4 / 1e9:.2f} GB float32 drawn "
        f"on the card in {time.perf_counter() - t0:.2f}s; {cfg.dtype} "
        "activations")
    check(fleet.rows([0])[0].data_ptr() == arena.data_ptr(),
          f"{what}: from_arena copied the card's arena")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, s0))
                               .astype(np.int32)).to(cuda)
    decoder = FleetDecoder(cfg)
    # warm-up (library handles, first launches): not timed or counted
    fleet_prefill_and_decode(cfg, fleet, lanes, prompts[:, :2], max_len=4,
                             new_tokens=2, decoder=decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d0 = decoder.dispatches
    reset_launches(path)
    toks, stats = fleet_prefill_and_decode(cfg, fleet, lanes, prompts,
                                           max_len=s0 + n, new_tokens=n,
                                           decoder=decoder)
    launches = read_launches(path)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[7b] {what}, B=8 {s0}+{n}: {fleet_stats_line(stats, n)}; launches "
        f"{launches}; peak device memory {peak:.2f} GB; gathered "
        f"{decoder.gathered_bytes / 1e9:.3f} GB a decode step")
    check(stats["prefill_dispatches"] == 1
          and stats["decode_dispatches_per_step"] == 1.0
          and decoder.dispatches - d0 == 1 + n
          and stats["distinct_models"] == 6,
          f"{what}: dispatches {stats}")
    want = {"flash_attention": 0,
            "decode_attention": cfg.num_layers * (s0 + n)}
    check(launches == want, f"{what}: launches {launches}, expected {want}")
    check(tuple(toks.shape) == (8, s0 + n) and torch.equal(toks[:, :s0],
                                                           prompts)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{what}: tokens out of shape or range, or the prompts not echoed")

    # the per-model loop: its wall, and routing: every fleet token a
    # near-maximum of its own model's logits along the fleet's tokens
    loop_toks, loop_stats = loop_prefill_and_decode(
        cfg, fleet, lanes, prompts, max_len=s0 + n, new_tokens=n)
    log(f"[7b] {what}: the per-model loop over the same batch "
        f"{loop_stats['total_s'] * 1e3:.3f} ms ({loop_stats['requests_s']:.3f}"
        f" requests/s, {loop_stats['distinct_models']} models) against the "
        f"fleet's {(stats['prefill_s'] + stats['decode_s']) * 1e3:.3f} ms")
    loop_tf = loop_teacher_forced(cfg, fleet, lanes, toks)
    greedy_near_max(loop_tf, toks.cpu(), loop_toks, s0, cfg.dtype,
                    f"{what} {cfg.dtype} greedy", "fleet", "per-model loop")
    del loop_tf
    # every launch against its plain version on its own inputs; the rerun
    # gives the same tokens
    errs = {k: [] for k in path.kernels}
    with checked_calls(path, errs):
        again, _ = fleet_prefill_and_decode(cfg, fleet, lanes, prompts,
                                            max_len=s0 + n, new_tokens=n)
    check_launch_errs({"decode_attention": errs["decode_attention"]},
                      path.launch_tol[torch.bfloat16], what)
    check(len(errs["decode_attention"]) == want["decode_attention"]
          and torch.equal(again, toks),
          f"{what}: the checked rerun launched "
          f"{len(errs['decode_attention'])} times or gave other tokens")

    # float32: the fleet's teacher-forced logits against the loop's, each
    # request within FLEET_VS_LOOP; then client 3's wq x1.03 inside the
    # fleet must move requests 0 and 3 outside it and no other
    loop32 = loop_teacher_forced(cfg32, fleet, lanes, toks)
    fleet32 = fleet_teacher_forced(cfg32, fleet, lanes, toks)
    fleet_vs_loop(fleet32, loop32, FLEET_LANES, (),
                  f"{what} float32 teacher forced, fleet vs loop")
    wq = fleet.tree(arena)["blocks"]["pos0"]["attn"]["wq"][FLEET_CONTROL]
    saved = wq.clone()
    wq.mul_(LR_CONTROL)
    ctl32 = fleet_teacher_forced(cfg32, fleet, lanes, toks)
    wq.copy_(saved)
    del saved
    fleet_vs_loop(ctl32, loop32, FLEET_LANES, (FLEET_CONTROL,),
                  f"{what} float32, client {FLEET_CONTROL}'s wq x1.03 in the "
                  "fleet (control) vs loop")
    del loop32, fleet32, ctl32

    # seeded temperature sampling repeats
    hot = [fleet_prefill_and_decode(cfg, fleet, lanes, prompts,
                                    max_len=s0 + n, new_tokens=n,
                                    temperature=0.8, seed=3)[0]
           for _ in range(2)]
    log(f"[7b] {what}: temperature 0.8, seed 3, twice: equal "
        f"{torch.equal(*hot)}; tokens equal to the greedy run's "
        f"{(hot[0][:, s0:] == toks[:, s0:]).float().mean().item():.4f}")
    check(torch.equal(*hot) and torch.equal(hot[0][:, :s0], prompts),
          f"{what}: seeded temperature runs differ or lose the prompts")

    # the host-resident fleet: two batches staged, the second prefetched
    avail = mem_available()
    rows = FLEET_K if avail >= FLEET_HOST_MEM else 4
    t0 = time.perf_counter()
    host = FleetParams.from_arena(arena[:rows], layout, resident=False,
                                  device=cuda)
    log(f"[7b] {what}: host MemAvailable {avail / 1e9:.1f} GB, so the "
        f"host-resident fleet holds {rows} of the {FLEET_K} rows "
        f"({rows * arena.shape[1] * 4 / 1e9:.2f} GB), copied in "
        f"{time.perf_counter() - t0:.2f}s")
    try:
        for i, batch in enumerate(FLEET_HOST_LANES):
            hl = np.array(batch)
            hp = prompts[4 * i:4 * i + 4]
            if i:
                host.prefetch(hl)       # staged while the resident run goes
            want_t, _ = fleet_prefill_and_decode(
                cfg, fleet, hl, hp, max_len=s0 + n, new_tokens=n)
            staged = host.stage_seconds
            got_t, hstats = fleet_prefill_and_decode(
                cfg, host, hl, hp, max_len=s0 + n, new_tokens=n)
            log(f"[7b] {what}, host-resident batch {i} lanes {batch}"
                f"{' (prefetched)' if i else ''}: "
                f"{fleet_stats_line(hstats, n)}; staged "
                f"{host.stage_seconds - staged:.3f}s "
                f"({len(np.unique(hl))} x {arena.shape[1] * 4 / 1e9:.2f} GB),"
                f" overlapped {host.overlapped_stage_seconds:.3f}s in all; "
                f"bit-equal to the resident fleet {torch.equal(want_t, got_t)}")
            check(torch.equal(want_t, got_t), f"{what}: host-resident batch "
                  f"{i} differs from the resident fleet's tokens")
        check(host.overlapped_stage_seconds > 0,
              f"{what}: the prefetched cohort was not staged ahead")
    finally:
        host.close()
        del host
    torch.cuda.empty_cache()

    stack, local = fleet.rows(lanes)
    tree = fleet.tree(stack)
    cache = decoder.new_cache(8, s0 + n, device=cuda)
    profiled(lambda i: decoder.decode_step(tree, local, toks[:, s0 + i],
                                           cache, s0 + i),
             f"one {what} decode step, B=8", path.decode_kernels)
    del arena, fleet, tree, stack, cache
    torch.cuda.empty_cache()
    return launches["decode_attention"]


def mamba_fleet(path: ServePath) -> None:
    """(e) of phase 7b: mamba2-2.7b's K = 4 fleet at full width and 2
    layers, B = 4: tokens near-maxima of the per-model loop's logits, the
    float32 logits against the loop's, no kernel launched."""
    from repro_torch.launch.serve import draw_fleet
    from repro_torch.serve.fleet import (
        FleetParams, fleet_prefill_and_decode, loop_prefill_and_decode,
    )

    cuda = torch.device("cuda")
    cfg = dataclasses.replace(path.cfg, num_layers=2)
    s0, n, lanes = FLEET_S0, FLEET_N, np.array(MAMBA_FLEET_LANES)
    what = "mamba2-2.7b fleet K=4 2 layers"
    arena, layout = draw_fleet(cfg, 4, cuda)
    fleet = FleetParams.from_arena(arena, layout, device=cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, s0)).astype(np.int32)).to(cuda)
    fleet_prefill_and_decode(cfg, fleet, lanes, prompts[:, :2], max_len=4,
                             new_tokens=2)
    reset_launches(path)
    toks, stats = fleet_prefill_and_decode(cfg, fleet, lanes, prompts,
                                           max_len=s0 + n, new_tokens=n)
    launches = read_launches(path)
    log(f"[7b] {what}, B=4 {s0}+{n}: {fleet_stats_line(stats, n)}; launches "
        f"{launches}")
    check(stats["prefill_dispatches"] == 1
          and stats["decode_dispatches_per_step"] == 1.0
          and not any(launches.values()),
          f"{what}: dispatches {stats}, launches {launches}")
    loop_toks, loop_stats = loop_prefill_and_decode(
        cfg, fleet, lanes, prompts, max_len=s0 + n, new_tokens=n)
    log(f"[7b] {what}: the per-model loop {loop_stats['total_s'] * 1e3:.3f} "
        f"ms")
    greedy_near_max(loop_teacher_forced(cfg, fleet, lanes, toks), toks.cpu(),
                    loop_toks, s0, cfg.dtype, f"{what} {cfg.dtype} greedy",
                    "fleet", "per-model loop")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fleet_vs_loop(fleet_teacher_forced(cfg32, fleet, lanes, toks),
                  loop_teacher_forced(cfg32, fleet, lanes, toks),
                  MAMBA_FLEET_LANES, (),
                  f"{what} float32 teacher forced, fleet vs loop")
    del arena, fleet
    torch.cuda.empty_cache()


def smoke_fleet(path: ServePath, smoke_cfg) -> None:
    """(e) of phase 7b: the reduced yi-9b config at the reference test's
    sizes, GPU against CPU from one CPU-drawn arena, in both dtypes."""
    from repro_torch.launch.serve import draw_fleet
    from repro_torch.serve.fleet import FleetParams, fleet_prefill_and_decode

    k, b, s0, n = SMOKE_FLEET
    arena, layout = draw_fleet(smoke_cfg, k, torch.device("cpu"))
    rng = np.random.default_rng(0)
    lanes = rng.integers(0, k, size=b)
    prompts = torch.from_numpy(rng.integers(0, smoke_cfg.vocab_size, (b, s0))
                               .astype(np.int32))
    fleets = {"cuda": FleetParams.from_arena(arena.cuda(), layout,
                                             device="cuda"),
              "cpu": FleetParams.from_arena(arena, layout, device="cpu")}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke_cfg, dtype=dtype)
        what = f"yi-9b reduced fleet K={k} B={b} {dtype}"
        toks = {}
        for device, fleet in fleets.items():
            reset_launches(path)
            toks[device], _ = fleet_prefill_and_decode(
                cfg, fleet, lanes, prompts, max_len=s0 + n, new_tokens=n)
            got = read_launches(path)["decode_attention"]
            want = cfg.num_layers * (s0 + n) if device == "cuda" else 0
            check(got == want, f"{what} {device}: {got} decode_attention "
                  f"launches, expected {want}")
        g = toks["cuda"].cpu()
        cpu_tf = fleet_teacher_forced(cfg, fleets["cpu"], lanes, g)
        logit_gap(fleet_teacher_forced(cfg, fleets["cuda"], lanes, g), cpu_tf,
                  f"{what}, teacher forced, GPU vs CPU (logged)")
        greedy_near_max(cpu_tf, g, toks["cpu"], s0, dtype, f"{what} greedy",
                        "GPU", "CPU")


def fleet_path(yi: ServePath, mamba: ServePath, smoke_cfg) -> int:
    """Phase 7b. Returns the decode_attention launches of yi-9b's timed
    fleet run, which the kernels line adds."""
    t0 = time.perf_counter()
    launches = yi_fleet(yi)
    t1 = time.perf_counter()
    mamba_fleet(mamba)
    t2 = time.perf_counter()
    smoke_fleet(yi, smoke_cfg)
    log(f"[7b] phase 7b in {time.perf_counter() - t0:.1f}s (yi-9b "
        f"{t1 - t0:.1f}s, mamba2-2.7b {t2 - t1:.1f}s, reduced "
        f"{time.perf_counter() - t2:.1f}s)")
    return launches


def _bound(nbytes: float, flops: float, peak: float):
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def sdpa_kernels(fn) -> str:
    """The device kernels of one call of ``fn`` (a profiler window after a
    warm call), largest first: their names say which SDPA backend ran. As
    in ``kernel_times``, a spin kernel opens the window and a window that
    saw none of the call's kernels is taken again (three tries): late in a
    whole run the profiler has missed every kernel of a first window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    rows = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)        # ~0.5 ms of device time
            fn()
            torch.cuda.synchronize()
        rows = [r for r in device_rows(prof) if "spin_kernel" not in r[2]]
        if rows:
            break
    return ("; ".join(f"{name[:60]} {us / 1e3:.3f} ms"
                      for us, _, name in rows[:3])
            or "none seen in three profiler windows")


def visible_pairs(s: int, window: int) -> int:
    """(row, key) pairs of a causal S x S attention, each row seeing its
    last ``window`` keys (all of them when ``window`` is 0)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def time_flash(flash, flash_plain, shape, dtype, reps, window=0):
    """The kernel's cold-L2 time at ``shape`` (causal, under ``window``)
    against its bound, the plain version and SDPA: ``is_causal`` with
    ``enable_gqa``, or with a window (which SDPA does not take) a boolean
    mask of the causal band, K and V repeated over each kv head's query
    heads before the timed call; the SDPA kernels that ran are logged."""
    import torch.nn.functional as F

    b, s, h, kv, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = _randn(gen, (b, s, h, hd), dtype)
    k, v = (_randn(gen, (b, s, kv, hd), dtype) for _ in range(2))
    before = flash.launches
    ms = time_launch(lambda: flash(q, k, v, window=window), reps)
    flash.launches = before          # timing launches are not the path's
    plain_ms = time_launch(lambda: flash_plain(q, k, v, window=window), reps)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        rows = torch.arange(s, device="cuda")
        band = rows[:, None] - rows[None, :]
        mask = (band >= 0) & (band < window)
        kt, vt = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    else:
        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    library_ms = time_launch(sdpa, reps)
    library_kernels = sdpa_kernels(sdpa)
    esize = q.element_size()
    nbytes = esize * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    flops = 4 * b * h * hd * visible_pairs(s, window)   # visible pairs only
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    log(f"[time] flash_attention {shape} {str(dtype)[6:]}"
        + (f" window {window}" if window else "")
        + f": kernel {ms:.5f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / ms:.2f}% of the bound), plain {plain_ms:.5f} ms, "
        f"SDPA {library_ms:.5f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s; "
        f"its kernels: {library_kernels}), bound {bound_ms:.5f} ms "
        f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_decode(decode, decode_plain, shape, reps, forced=()):
    """The kernels' cold-L2 time at ``shape`` (full lengths) with the
    wrapper's split count, against the bound, the plain version and SDPA;
    the split and combine kernels' times from a profiler run; and the
    kernels' time with each split count of ``forced`` (through
    ``kernel.launch``), which the wrapper does not pick here."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel, ops

    b, h, kv, t, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = _randn(gen, (b, 1, h, hd), torch.bfloat16)
    k, v = (_randn(gen, (b, t, kv, hd), torch.float32) for _ in range(2))
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")
    splits = ops.num_splits(b, kv, t, torch.cuda.get_device_properties(0)
                            .multi_processor_count)
    before = decode.launches
    ms = time_launch(lambda: decode(q, k, v, lengths), reps)
    parts = kernel_times(lambda: decode(q, k, v, lengths),
                         DECODE_KERNELS[:1 + (splits > 1)])
    decode.launches = before
    others = {}
    for s in forced:
        out, scratch = torch.empty_like(q), ops.split_scratch(q, k, s)
        others[s] = time_launch(
            lambda s=s, out=out, scratch=scratch: kernel.launch(
                q, k, v, lengths, out, scratch, window=0, splits=s), reps)
    plain_ms = time_launch(lambda: decode_plain(q, k, v, lengths), reps)
    # SDPA over the (B, KV, G, hd) layout: a kv head's G query heads are
    # SDPA's query rows, so no K/V copy per query head (enable_gqa makes
    # one). SDPA takes one dtype: the bf16 query is cast outside the call.
    qf = q.float().reshape(b, kv, h // kv, hd)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    library_ms = time_launch(lambda: F.scaled_dot_product_attention(
        qf, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask), reps)
    keys = int(lengths.sum().item())
    nbytes = 2 * keys * kv * hd * 4 + 2 * b * h * hd * 2 + 4 * b
    flops = 4 * keys * h * hd
    bound_ms, bound_by = _bound(nbytes, flops, H100_F32_FLOPS)
    log(f"[time] decode_attention {shape} bf16 q / f32 cache, lengths T, "
        f"{splits} split(s): kernel {ms:.5f} ms ({100 * bound_ms / ms:.1f}% "
        f"of the bound), plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e9:.4f} GB); "
        f"kernels (profiler): " + ", ".join(
            f"{k} {t_:.5f} ms ({n} of 10 calls seen)"
            for k, (t_, n) in parts.items())
        + "".join(f"; forced to {s} split(s): {t_:.5f} ms"
                  for s, t_ in others.items()))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_times(fn, names, reps=10, warm=False) -> dict:
    """Each named kernel's median device time (ms) over ``reps`` calls of
    ``fn`` from a profiler run, and how many of the calls the profiler saw
    it in. Before each call the L2 is flushed by writing a 256 MB buffer;
    ``warm`` leaves it as the calls before left it (after a few calls to
    warm up), as a kernel finds its operands on a path that launches it
    back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    if warm:
        for _ in range(3):
            fn()
    # the profiler may miss the first kernels of a window (it missed one
    # to three of 30 on the H100, and once all 30 warm calls, which run
    # back to back in under a millisecond), so a spin kernel opens the
    # window, a window that misses a kernel is taken again (three tries),
    # and each kernel must be seen, not seen in every call; the log says
    # in how many
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)        # ~0.5 ms of device time
            for i in range(reps):
                if not warm:
                    flush.fill_(float(i))
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            name = next((k for k in names if k in e.name), None)
            if name and e.device_type == DeviceType.CUDA:
                times.setdefault(name, []).append(
                    e.self_device_time_total / 1e3)
        if sorted(times) == sorted(names):
            break
        log(f"[time] the profiler missed one of {names} in window "
            f"{attempt + 1}: { {k: len(t) for k, t in times.items()} } of "
            f"{reps} calls")
    check(sorted(times) == sorted(names),
          f"the profiler did not see each of {names}: "
          f"{ {k: len(t) for k, t in times.items()} } of {reps} calls")
    # a kernel never seen reads NaN: the run goes on to report its failure
    return {k: (float(np.median(times[k])), len(times[k])) if k in times
            else (float("nan"), 0) for k in names}


def time_ssd(ssd, ssd_plain, shape, dtype, reps):
    """The scan's cold-L2 time at ``shape`` on strided views with path-like
    dt, against its plain version and its bound, and its three passes'
    times. PyTorch has no call that computes the SSD scan, so there is no
    library time."""
    b, l, h, g, p, n, q = shape
    gen = torch.Generator(device="cuda").manual_seed(6)
    args = ssd_inputs(gen, shape, dtype, True, "path")
    before = ssd.launches
    ms = time_launch(lambda: ssd(*args, chunk=q), reps)
    passes = kernel_times(lambda: ssd(*args, chunk=q), SSD_KERNELS)
    ssd.launches = before            # timing launches are not the path's
    plain_ms = time_launch(lambda: ssd_plain(*args, chunk=q), reps)
    # what the function needs, per (b, h) and chunk of c steps: the causal
    # triangle j <= i of C Bᵀ (N c(c+1)) and of the scores times x
    # (P c(c+1)), as the kernel skips the tiles above the diagonal; C S and
    # Bᵀ x (4 c N P)
    flops = b * h * sum((n + p) * c * (c + 1) + 4 * c * n * p
                        for c in (min(q, l - s) for s in range(0, l, q)))
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * b * l * h * p + 2 * b * l * g * n)   # x, y; B, C
              + 4 * b * l * h + 4 * h)                          # dt, a
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    log(f"[time] ssd_scan {shape} {str(dtype)[6:]} (strided views, path "
        f"dt): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, no library "
        f"call; bound {bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.2f} "
        f"GFLOP, {nbytes / 1e6:.1f} MB); passes (profiler): "
        + ", ".join(f"{k} {t:.5f} ms ({n} of 10 scans seen)"
                    for k, (t, n) in passes.items()))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# phase 9: LM training (ROADMAP A10.3)

# The backward kernel against the plain backward computed in float64 from
# the same inputs, max |diff| relative to the largest |value| of each
# gradient: float32 sums over up to S keys in another order (1e-4);
# bfloat16 adds one rounding of each output (2**-8) and P rebuilt from the
# tensor-core forward's lse (2e-2). lse within 1e-5 of the plain one,
# relative to max(1, max |lse|): scores of a thousand (yi-9b's at full
# width) summed in another order differ by a few 1e-3.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5
BWD_SWEEP_H = 8
BWD_SWEEP = [(s, g, hd, window) for hd in (32, 64, 128, 160)
             for g in (1, 4, 8) for window in (0, 48)
             for s in (100, 257, 1024, 4096)]
BWD_PATH = (4, 256, 10, 10, 64)         # a fedsr-lm-100m lane, float32
TRAIN_LANES = 4          # the reference's layout on 8 host devices
TRAIN_HOST_MESH = 8      # _host_mesh_shape(8) = (4, 2): 4 client lanes
TRAIN_RUN = {"steps": 30, "batch_per_client": 4, "seq_len": 256}
TRAIN_SYNC = 5
# fused against unfused on the same steps: the reference's own bound
# (tests/test_serial_ring.py:48-52)
FUSED_VS_UNFUSED_TOL = 1e-6
# (b): full width, 2 layers, 4 lanes, batch 2, seq 128, 3 steps across one
# cloud sync (after step 2), GPU against CPU from one CPU-drawn state. At
# the reference's initial scale the gradient is ill-conditioned: most
# attention rows are one-hot and a near-tie turns a rounding-size change
# into a large one (yi-9b: another rounding of the same float32 attention
# moves the step's gradient by 0.86% in norm, PR 34), and lr 0.3 makes
# the embedding's update 1e5 times its initial scale. So what is held is
# what one step's rounding can move: after step 1 (from the same state)
# the params' gap over the step's update, ||p_gpu - p_cpu|| / ||p_cpu -
# p_0||, where the 1.03x learning rate moves it by 0.03; and the loss of
# step 2 (computed from step 1's params), where the control moves it by
# ~1e-3. Step 3 (after the cloud sync) is logged.
TRAIN_GAP = {"layers": 2, "lanes": 4, "batch": 2, "seq": 128, "steps": 3,
             "sync": 2}
TRAIN_STEP1_TOL = 1e-2   # step 1's params: ||diff|| / ||update||
TRAIN_LOSS2_TOL = 1e-4   # step 2's loss, absolute (losses near 10.9)
# (c): yi-9b's training step at full width, 2 layers, one lane, B=1, S=4096.
# Its gradient at the reference's scale is as far from the plain route's
# as the plain route is from itself with the attention computed in
# float64 (both ~0.35 in norm, bfloat16); so the bound is held with wq and
# wk scaled by YI_QK_SCALE (scores O(1), rows no longer one-hot), and the
# reference's scale is logged beside that control.
YI_TRAIN = {"layers": 2, "batch": 1, "seq": 4096, "steps": 2}
YI_QK_SCALE = 0.03
YI_GRAD_TOL = 2e-2       # each leaf's ||diff|| / ||grad||, bfloat16
# (d): yi-9b's step with bfloat16 parameters through fused_sgd's bfloat16
# case (ROADMAP A10.6), at (c)'s shape, three steps; and (b)'s reduced
# fedsr-lm-100m in bfloat16, GPU against CPU after one step, at (b)'s
# step-1 bound. The bfloat16 update rounds p' = bf16(p - bf16(lr d)) to
# an ulp of p, so gradients that differ at bfloat16 rounding move a share
# of the elements by one ulp: the gap read 1.391e-3 of the update on the
# H100 and the 1.03x learning rate's 2.673e-2, either side of 1e-2.
YI_BF16 = {"layers": 2, "batch": 1, "seq": 4096, "steps": 3}


def train_tcfg(**kw):
    """``launch/train.py::main``'s TrainConfig (lr 0.3, momentum 0.5)."""
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(**{"param_dtype": "float32", "learning_rate": 0.3,
                          "momentum": 0.5, "cloud_sync_every": TRAIN_SYNC,
                          "fused_sgd": True, **kw})


def _lse_err(lse, want) -> float:
    """max |diff| of two lse tensors over max(1, max |want|)."""
    return float((lse - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _grad_err(got, want) -> float:
    """max |diff| over max |want|, the largest over a gradient tuple."""
    return max(float((g.double() - w.double()).abs().max()
                     / w.double().abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def flash_bwd_sweep(flash_bwd) -> float:
    """Phase 2 for the flash backward: every hd the kernels take, both
    types, G = 1, 4, 8 over H = 8 query heads, causal and with a 48-key
    window, S = 100, 257, 1024, 4096, against the plain backward in
    float64; lse against the plain one; a rerun bit-equal. Returns the
    largest |diff|."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_plain, flash_attention_bwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst_abs, worst = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    t0 = time.perf_counter()
    for s, g, hd, window in BWD_SWEEP:
        kv = BWD_SWEEP_H // g
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (_randn(gen, (1, s, BWD_SWEEP_H, hd), dtype)
                     for _ in range(2))
            k, v = (_randn(gen, (1, s, kv, hd), dtype) for _ in range(2))
            _, lse = flash_attention_lse(q, k, v, causal=True, window=window)
            got = flash_bwd(q, k, v, do, lse, causal=True, window=window)
            exact = flash_attention_bwd_plain(q, k, v, do, causal=True,
                                              window=window,
                                              dtype=torch.float64)
            lse_err = _lse_err(lse, attention_lse_plain(
                q, k, causal=True, window=window))
            rel = _grad_err(got, exact)
            err = max(float((a.double() - e).abs().max())
                      for a, e in zip(got, exact))
            worst[dtype] = max(worst[dtype], rel)
            worst_abs = max(worst_abs, err)
            log(f"[sweep] flash_bwd s={s} h={BWD_SWEEP_H} kv={kv} hd={hd} "
                f"window={window} {str(dtype)[6:]}: max_abs_err {err:.3e}, "
                f"relative {rel:.3e}, lse {lse_err:.3e}")
            check(rel <= BWD_TOL[dtype] and lse_err <= LSE_TOL
                  and all(a.dtype == dtype for a in got),
                  f"flash_attention_bwd != plain version at s={s} kv={kv} "
                  f"hd={hd} window={window} {dtype}: {rel}, lse {lse_err}")
            if (s, hd) == (1024, 128):
                again = flash_bwd(q, k, v, do, lse, causal=True,
                                  window=window)
                check(all(torch.equal(a, b) for a, b in zip(again, got)),
                      f"flash_attention_bwd is not deterministic at s={s} "
                      f"hd={hd} {dtype}")
            del q, k, v, do, lse, got, exact
    log(f"[sweep] {2 * len(BWD_SWEEP)} flash_bwd cases in "
        f"{time.perf_counter() - t0:.1f}s; worst relative "
        f"{ {str(d)[6:]: f'{e:.3e}' for d, e in worst.items()} }, worst "
        f"|diff| {worst_abs:.3e}")
    return worst_abs


def lse_bit_check(flash) -> None:
    """The forward with its lse output against the serving call without it
    at the serving shapes (yi-9b's and stablelm-12b's prefill, bfloat16,
    and a float32 one): the output bit for bit; lse against the plain."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    from repro_torch.kernels.flash_attention.ref import attention_lse_plain

    gen = torch.Generator(device="cuda").manual_seed(9)
    for shape, dtype in ((FLASH_PATH, torch.bfloat16),
                         (FLASH_PATH_160, torch.bfloat16),
                         (BWD_PATH, torch.float32)):
        b, s, h, kv, hd = shape
        q = _randn(gen, (b, s, h, hd), dtype)
        k, v = (_randn(gen, (b, s, kv, hd), dtype) for _ in range(2))
        before = flash.launches
        with torch.no_grad():
            serve = flash(q, k, v)
        out, lse = flash_attention_lse(q, k, v, causal=True, window=0)
        flash.launches = before
        lse_err = _lse_err(lse, attention_lse_plain(q, k))
        same = torch.equal(out, serve)
        log(f"[sweep] flash forward {shape} {str(dtype)[6:]} with lse: "
            f"output bit-equal to the serving call {same}, lse against the "
            f"plain {lse_err:.3e}")
        check(same and lse_err <= LSE_TOL,
              f"flash forward with lse at {shape} {dtype}: bit-equal {same}, "
              f"lse {lse_err}")


class checked_train_launches:
    """Within the block, each launch of the training route's kernels — the
    flash forward with lse, the flash backward, ``fused_sgd`` — also runs
    its plain version on the same inputs, while ``active``: throughout, or
    (``first_step``) until the first ``fused_sgd`` call ends the first
    step. Records each kernel's worst error (relative to max(1, max |plain|)
    for the forward and lse, to max |plain| per gradient for the backward,
    max |diff| for ``fused_sgd``, which must be 0) and the calls checked.
    The kernels' own outputs go on."""

    def __init__(self, first_step: bool = True):
        self.first_step, self.active = first_step, True
        self.worst = {"flash_attention": 0.0, "lse": 0.0,
                      "flash_attention_bwd": 0.0, "fused_sgd": 0.0}
        self.calls = Counter()

    def _note(self, name, err):
        self.worst[name] = max(self.worst[name], err)

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.kernels.flash_attention.ref import (
            attention_lse_plain, flash_attention_bwd_plain,
        )
        from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference
        from repro_torch.launch import steps

        self.ops, self.steps = ops, steps
        self.saved = fwd0, bwd0, sgd0 = (ops.flash_attention_lse,
                                         ops.flash_attention_bwd,
                                         steps.fused_sgd_lanes)

        def fwd(q, k, v, *, causal, window):
            out, lse = fwd0(q, k, v, causal=causal, window=window)
            if self.active:
                want = ops.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
                scale = max(1.0, float(want.abs().max()))
                self._note("flash_attention", float(
                    (out.float() - want.float()).abs().max()) / scale)
                self._note("lse", _lse_err(lse, attention_lse_plain(
                    q, k, causal=causal, window=window)))
                self.calls["flash_attention"] += 1
            return out, lse

        def bwd(q, k, v, dout, lse, *, causal, window):
            got = bwd0(q, k, v, dout, lse, causal=causal, window=window)
            if self.active:
                want = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                                 window=window)
                self._note("flash_attention_bwd", _grad_err(got, want))
                self.calls["flash_attention_bwd"] += 1
            return got

        def sgd(p, grads, m, ok, lr, *, reset, momentum, nesterov=False):
            kw = dict(reset=reset, momentum=momentum, nesterov=nesterov)
            if not self.active:
                return sgd0(p, grads, m, ok, lr, **kw)
            want_p, want_m = sgd_lanes_reference(p, grads, m, ok, lr, **kw)
            sgd0(p, grads, m, ok, lr, **kw)
            self._note("fused_sgd", float(torch.maximum(
                (p - want_p).abs().max(), (m - want_m).abs().max())))
            self.calls["fused_sgd"] += 1
            del want_p, want_m
            self.active = not self.first_step

        ops.flash_attention_lse, ops.flash_attention_bwd = fwd, bwd
        steps.fused_sgd_lanes = sgd
        return self

    def __exit__(self, *exc):
        (self.ops.flash_attention_lse, self.ops.flash_attention_bwd,
         self.steps.fused_sgd_lanes) = self.saved

    def check(self, dtype, what: str) -> None:
        w = self.worst
        log(f"[train] {what}: launches held against their plain versions "
            f"{dict(self.calls)}; worst: forward {w['flash_attention']:.3e}, "
            f"lse {w['lse']:.3e}, backward {w['flash_attention_bwd']:.3e} "
            f"(bounds {LAUNCH_TOL[dtype]:g}, {LSE_TOL:g}, {BWD_TOL[dtype]:g}),"
            f" fused_sgd {w['fused_sgd']:.3e} (bit for bit)")
        check(w["flash_attention"] <= LAUNCH_TOL[dtype]
              and w["lse"] <= LSE_TOL
              and w["flash_attention_bwd"] <= BWD_TOL[dtype]
              and w["fused_sgd"] == 0.0,
              f"{what}: a training launch differs from its plain version: "
              f"{w}")


def train_state(cfg, tcfg, lanes: int, device, seed: int = 0, gen=None):
    """A fresh (lanes, P) state of ``cfg``'s weights drawn from a torch
    generator seeded ``seed`` (a CPU one unless ``gen`` is given, so the
    GPU and the CPU start from the same weights), every lane alike."""
    from repro_torch.launch.steps import train_layout
    from repro_torch.models.transformer import init_model
    from repro_torch.utils.tree import flatten_tree

    gen = gen or torch.Generator().manual_seed(seed)
    leaves = flatten_tree(init_model(gen, cfg, torch.device(device)))
    flat = torch.cat([leaves.pop(k).reshape(-1)
                      for k, _ in train_layout(cfg)]).to(
        getattr(torch, tcfg.param_dtype))
    params = flat.expand(lanes, -1).clone()
    return {"params": params, "mom": torch.zeros_like(params), "step": 0}


def train_steps(cfg, tcfg, state, batches, device, timed=False, keep=()):
    """``make_train_step``'s steps over ``batches`` ((C, B, S + 1) token
    arrays), with the cloud sync every ``cloud_sync_every`` steps: (state,
    losses, ms of each step when ``timed``); ``keep``: steps after which a
    CPU copy of the params goes into ``state["kept"]``."""
    from repro_torch.launch.steps import make_train_step

    step, sync = make_train_step(cfg, tcfg)
    losses, ms, kept = [], [], {}
    for t, toks in enumerate(batches):
        toks = torch.from_numpy(toks).to(device)
        t0 = time.perf_counter()
        state, loss = step(state, {"inputs": toks[..., :-1],
                                   "labels": toks[..., 1:]})
        if (t + 1) % tcfg.cloud_sync_every == 0:
            state = sync(state)
        losses.append(float(loss))
        if timed:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if t + 1 in keep:     # a copy: the next step updates in place
            kept[t + 1] = state["params"].to("cpu", copy=True)
    return {**state, "kept": kept}, losses, ms


def token_batches(cfg, lanes, batch, seq, steps, seed=0):
    from repro_torch.launch.train import ClientTokenStore

    store = ClientTokenStore(cfg, lanes, batch, seq, steps, seed)
    return [store.step_batch(t) for t in range(steps)]


def _cpu_train_gap(cfg, tcfg):
    """Phase 9 (b)'s (or, in bfloat16, (d)'s) CPU run, in a worker:
    (losses, {step: params as float32 numpy} after steps 1 and 3)."""
    g = TRAIN_GAP
    state = train_state(cfg, tcfg, g["lanes"], "cpu")
    state, losses, _ = train_steps(
        cfg, tcfg, state, token_batches(cfg, g["lanes"], g["batch"],
                                        g["seq"], g["steps"]), "cpu",
        keep=(1, g["steps"]))
    return losses, {t: p.float().numpy() for t, p in state["kept"].items()}


def gap_cfgs(lm_cfg, dtype="float32"):
    g = TRAIN_GAP
    return (dataclasses.replace(lm_cfg, num_layers=g["layers"]),
            train_tcfg(cloud_sync_every=g["sync"], param_dtype=dtype))


def train_jobs(pool, lm_cfg) -> dict:
    """Phase 9 (b)'s CPU run, submitted to phase 3g's pool."""
    return {"gap": pool.submit(_cpu_train_gap, *gap_cfgs(lm_cfg))}


def train_gap(lm_cfg, job, dtype="float32") -> None:
    """(b): fedsr-lm-100m at full width and 2 layers, GPU against the CPU
    run of the pool, and the 1.03x learning rate's GPU run against the
    CPU's (the control): step 1's params and step 2's loss held, step 3
    logged (see ``TRAIN_GAP``). (d) runs it with bfloat16 parameters:
    step 1's params held at the same bound, the rest logged."""
    cfg, tcfg = gap_cfgs(lm_cfg, dtype)
    step1_tol = TRAIN_STEP1_TOL
    loss2_tol = TRAIN_LOSS2_TOL if dtype == "float32" else None
    tag = "(b)" if dtype == "float32" else "(d) bfloat16"
    g = TRAIN_GAP
    batches = token_batches(cfg, g["lanes"], g["batch"], g["seq"],
                            g["steps"])
    p0 = train_state(cfg, tcfg, g["lanes"], "cpu")["params"].float()
    runs = {}
    for name, t in (("gpu", tcfg), ("control", dataclasses.replace(
            tcfg, learning_rate=tcfg.learning_rate * LR_CONTROL))):
        state, losses, _ = train_steps(
            cfg, t, train_state(cfg, t, g["lanes"], "cuda"), batches, "cuda",
            keep=(1, g["steps"]))
        runs[name] = (losses, state["kept"])
        del state
    cpu_losses, cpu_kept = job.result()
    gaps = {}
    for name, (losses, kept) in runs.items():
        rel = {}
        for t, p in kept.items():
            p, want = p.float(), torch.from_numpy(cpu_kept[t])
            rel[t] = (float((p - want).norm() / (want - p0).norm()),
                      float((p - want).abs().max() / want.abs().max()))
        gaps[name] = (rel[1][0], abs(losses[1] - cpu_losses[1]))
        log(f"[train] {tag} 2 layers, {g['lanes']} lanes, {name} against the "
            f"CPU: params after step 1 ||diff|| / ||update|| {rel[1][0]:.3e}"
            f" (max |diff| / max |param| {rel[1][1]:.3e}), after step "
            f"{g['steps']} (past the cloud sync; logged) {rel[g['steps']][0]:.3e}"
            f" ({rel[g['steps']][1]:.3e}); losses "
            f"{[round(x, 6) for x in losses]} against "
            f"{[round(x, 6) for x in cpu_losses]}")
    log(f"[train] {tag} bounds: step 1's params {step1_tol:g}, step 2's "
        f"loss {loss2_tol if loss2_tol is not None else 'logged'}; GPU "
        f"{gaps['gpu'][0]:.3e}, {gaps['gpu'][1]:.3e}; control "
        f"{gaps['control'][0]:.3e}, {gaps['control'][1]:.3e}")
    loss2_tol = float("inf") if loss2_tol is None else loss2_tol
    check(gaps["gpu"][0] <= step1_tol and gaps["gpu"][1] <= loss2_tol,
          f"{tag} GPU against CPU: {gaps['gpu']}")
    check(gaps["control"][0] > step1_tol
          and (loss2_tol == float("inf") or gaps["control"][1] > loss2_tol),
          f"{tag} the bounds do not tell {LR_CONTROL}x the learning rate "
          f"from the CPU's run: {gaps['control']}")


def train_main_path(lm_cfg, kernels) -> dict:
    """(a): ``train_loop`` on fedsr-lm-100m at full width and depth, the
    reference's 4-lane layout (a host mesh of 8 entries of the card),
    30 steps, fused_sgd; the first step's launches against their plain
    versions; the counts from 0. Returns the launches."""
    from repro_torch.launch.train import train_loop
    from repro_torch.utils.logging import MetricLogger

    tcfg = train_tcfg()
    reps = lm_cfg.num_layers * TRAIN_LANES * TRAIN_RUN["steps"]
    with sim_mesh(TRAIN_HOST_MESH, "cuda"), checked_train_launches() as chk:
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = train_loop(lm_cfg, tcfg, log=MetricLogger(), device="cuda",
                         **TRAIN_RUN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"fused_sgd": TRAIN_RUN["steps"], "flash_attention": reps,
            "flash_attention_bwd": reps}
    log(f"[train] (a) fedsr-lm-100m ({out['params_m']:.3f} M params, "
        f"{TRAIN_LANES} lanes, batch {TRAIN_RUN['batch_per_client']}, seq "
        f"{TRAIN_RUN['seq_len']}, {TRAIN_RUN['steps']} steps, sync every "
        f"{TRAIN_SYNC}, fused_sgd): loss {out['first_loss']:.4f} -> "
        f"{out['final_loss']:.4f}; {wall:.2f} s ({out['seconds']:.2f} s in "
        f"train_loop's steps); peak {peak:.2f} GB; launches {counts} "
        f"(expected {want})")
    check(counts == want, f"(a) launches {counts}, expected {want}")
    check(np.isfinite(out["final_loss"])
          and out["final_loss"] < out["first_loss"],
          f"(a) training did not reduce the loss: {out}")
    chk.check(torch.float32, "(a) the first step")
    check(chk.calls == Counter({"flash_attention": reps // TRAIN_RUN["steps"],
                                "flash_attention_bwd":
                                    reps // TRAIN_RUN["steps"],
                                "fused_sgd": 1}),
          f"(a) the first step's checked launches: {dict(chk.calls)}")
    return counts


def train_fused_and_times(lm_cfg) -> None:
    """(a) continued: fused against unfused on the same 3 steps; the ms a
    step unprofiled; a profiled step's device-busy share."""
    from torch.profiler import ProfilerActivity, profile

    batches = token_batches(lm_cfg, TRAIN_LANES,
                            TRAIN_RUN["batch_per_client"],
                            TRAIN_RUN["seq_len"], 8)
    finals = {}
    for fused in (True, False):
        tcfg = train_tcfg(fused_sgd=fused)
        state = train_state(lm_cfg, tcfg, TRAIN_LANES, "cuda")
        state, losses, _ = train_steps(lm_cfg, tcfg, state, batches[:3],
                                       "cuda")
        finals[fused] = (state, losses)
    err = float((finals[True][0]["params"] - finals[False][0]["params"])
                .abs().max())
    loss_gap = max(abs(a - b) for a, b in zip(finals[True][1],
                                              finals[False][1]))
    log(f"[train] (a) fused against unfused, 3 steps: params max |diff| "
        f"{err:.3e}, losses max gap {loss_gap:.3e} (bound "
        f"{FUSED_VS_UNFUSED_TOL:g})")
    check(err <= FUSED_VS_UNFUSED_TOL and loss_gap <= FUSED_VS_UNFUSED_TOL,
          f"(a) fused against unfused: {err}, {loss_gap}")
    state = finals[True][0]
    del finals
    tcfg = train_tcfg()
    state, _, ms = train_steps(lm_cfg, tcfg, state, batches[3:7], "cuda",
                               timed=True)
    from repro_torch.launch.steps import make_train_step

    step, _ = make_train_step(lm_cfg, tcfg)
    toks = torch.from_numpy(batches[7]).cuda()
    batch = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log(f"[train] (a) ms a step unprofiled (4 steady steps, synchronised): "
        f"{[round(x, 3) for x in ms]}, median {float(np.median(ms)):.3f}")
    busy = profile_report(prof, wall_us, "one fedsr-lm-100m training step",
                          ("flash_attention_kernel", "flash_bwd",
                           "fused_sgd_kernel", "gemm", "Gemm"))
    log(f"[train] (a) a profiled step: busy {100 * busy:.1f}% of its wall "
        f"({100 * busy * wall_us / 1e3 / float(np.median(ms)):.1f}% of the "
        f"unprofiled median)")
    flash = [(dev, count, key.replace("(anonymous namespace)::", "")
              .replace("void ", "").split("(")[0])
             for dev, count, key in device_rows(prof)
             if "flash_attention_kernel" in key or "flash_bwd" in key]
    log("[train] (a) the profiled step's flash kernels: " + ", ".join(
        f"{name} {dev / 1e3:.3f} ms in {count}" for dev, count, name in flash)
        + f"; together {sum(r[0] for r in flash) / 1e3:.3f} ms")


def attention_plain64(q, k, v, *, causal=True, window=0):
    """The plain attention computed in float64 and rounded to q's dtype
    once: another rounding of the same function (phase 9 (c)'s control)."""
    from repro_torch.kernels.flash_attention.ref import attention_reference

    t = (0, 2, 1, 3)
    return attention_reference(q.permute(t), k.permute(t), v.permute(t),
                               causal=causal, window=window,
                               dtype=torch.float64).permute(t)


def route_grads(cfg, route, params, batch):
    """One lane's loss and gradient leaves with ``route`` at the layers'
    attention call site."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import lane_grads, train_layout
    from repro_torch.models import layers

    layers.flash_attention = route
    try:
        loss, grads = lane_grads(params, batch, cfg, train_layout(cfg), False)
    finally:
        layers.flash_attention = flash_attention
    return float(loss[0]), grads


def _norm_gaps(a, b, layout) -> dict:
    return {name: float((x - y).norm() / y.norm().clamp_min(1e-30))
            for (name, _), x, y in zip(layout, a, b)}


def yi_train_check(yi_cfg) -> None:
    """(c): yi-9b at full width, 2 layers, one lane, B=1, S=4096, bfloat16
    activations: the step's gradient against autograd of the plain route
    on the card (bounded with wq, wk scaled by ``YI_QK_SCALE``; at the
    reference's scale logged beside the float64-attention control); two
    steps, each flash launch held against its plain version; the step's
    time and peak memory."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.launch.steps import state_tree, train_layout

    y = YI_TRAIN
    cfg = dataclasses.replace(yi_cfg, num_layers=y["layers"])
    tcfg = train_tcfg()
    layout = train_layout(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_state(cfg, tcfg, 1, "cuda",
                        gen=torch.Generator(device="cuda").manual_seed(0))
    n_params = state["params"].shape[1]
    batches = token_batches(cfg, 1, y["batch"], y["seq"], y["steps"])
    toks = torch.from_numpy(batches[0]).cuda()
    batch = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    tempered = state["params"].clone()
    attn = state_tree(tempered, layout)["blocks"]["pos0"]["attn"]
    attn["wq"].mul_(YI_QK_SCALE)
    attn["wk"].mul_(YI_QK_SCALE)
    lk, gk = route_grads(cfg, flash_attention, tempered, batch)
    lp, gp = route_grads(cfg, flash_attention_plain, tempered, batch)
    gaps = _norm_gaps(gk, gp, layout)
    worst = max(gaps.values())
    del tempered, gk, gp
    log(f"[train] (c) yi-9b, {y['layers']} layers ({n_params:,} params), "
        f"B={y['batch']} S={y['seq']} bfloat16, wq and wk x{YI_QK_SCALE}: "
        f"loss kernels {lk:.6f}, plain {lp:.6f}; gradient kernels against "
        f"the plain route, each leaf's ||diff|| / ||grad||: worst "
        f"{worst:.3e} (bound {YI_GRAD_TOL:g}); "
        + ", ".join(f"{k.split('/')[-1]} {v:.2e}" for k, v in gaps.items()))
    check(worst <= YI_GRAD_TOL, f"(c) yi-9b gradient: {gaps}")
    lk, gk = route_grads(cfg, flash_attention, state["params"], batch)
    lp, gp = route_grads(cfg, flash_attention_plain, state["params"], batch)
    kernel_gap = max(_norm_gaps(gk, gp, layout).values())
    del gk
    l6, g6 = route_grads(cfg, attention_plain64, state["params"], batch)
    control_gap = max(_norm_gaps(g6, gp, layout).values())
    del gp, g6
    log(f"[train] (c) at the reference's scale (logged): losses kernels "
        f"{lk:.6f}, plain {lp:.6f}, plain in float64 {l6:.6f}; gradient "
        f"kernels against plain {kernel_gap:.3e}, plain in float64 against "
        f"plain {control_gap:.3e} (worst leaf, ||diff|| / ||grad||): one-hot "
        f"rows and near-ties make any rounding move it this far")
    with checked_train_launches(first_step=False) as chk:
        state, losses, ms = train_steps(cfg, tcfg, state, batches, "cuda",
                                        timed=True)
    chk.check(torch.bfloat16, "(c) yi-9b's two steps")
    check(all(np.isfinite(losses)), f"(c) yi-9b losses {losses}")
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_state(cfg, tcfg, 1, "cuda",
                        gen=torch.Generator(device="cuda").manual_seed(0))
    _, losses, ms = train_steps(cfg, tcfg, state, batches, "cuda",
                                timed=True)
    log(f"[train] (c) yi-9b's two steps, unchecked: "
        f"{[round(x, 1) for x in ms]} ms, losses "
        f"{[round(x, 4) for x in losses]}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state
    torch.cuda.empty_cache()


def yi_bf16_fused_check(yi_cfg, kernels) -> dict:
    """(d): yi-9b at full width, 2 layers, one lane, B=1, S=4096, with
    bfloat16 parameters and ``fused_sgd`` (its bfloat16 case): three steps
    with every launch held against its plain version (every ``fused_sgd``
    launch bit for bit); the same steps from the same state unchecked,
    timed and counted from 0 (the main path's run); then the fused state
    against the unfused one after one step, logged (the two round
    differently by design, ROADMAP C2). Returns the counted launches."""
    y = YI_BF16
    cfg = dataclasses.replace(yi_cfg, num_layers=y["layers"])
    tcfg = train_tcfg(param_dtype="bfloat16")
    batches = token_batches(cfg, 1, y["batch"], y["seq"], y["steps"])

    def fresh(t=tcfg):
        return train_state(cfg, t, 1, "cuda",
                           gen=torch.Generator(device="cuda").manual_seed(0))

    torch.cuda.empty_cache()
    with checked_train_launches(first_step=False) as chk:
        state, losses, _ = train_steps(cfg, tcfg, fresh(), batches, "cuda")
    chk.check(torch.bfloat16, "(d) yi-9b's bfloat16 fused steps")
    check(chk.calls["fused_sgd"] == y["steps"]
          and state["params"].dtype == torch.bfloat16,
          f"(d) checked fused_sgd launches {dict(chk.calls)}, params "
          f"{state['params'].dtype}")
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    for k in kernels.values():
        k.launches = 0
    kernels["fused_sgd"].bf16_launches = 0
    state, losses, ms = train_steps(cfg, tcfg, state, batches, "cuda",
                                    timed=True)
    counts = {"fused_sgd_bf16": kernels["fused_sgd"].bf16_launches,
              "flash_attention": kernels["flash_attention"].launches,
              "flash_attention_bwd": kernels["flash_attention_bwd"].launches}
    want = {"fused_sgd_bf16": y["steps"],
            "flash_attention": y["layers"] * y["steps"],
            "flash_attention_bwd": y["layers"] * y["steps"]}
    log(f"[train] (d) yi-9b, {y['layers']} layers "
        f"({state['params'].shape[1]:,} bfloat16 params), B={y['batch']} "
        f"S={y['seq']}, fused_sgd bfloat16: {y['steps']} steps "
        f"{[round(x, 1) for x in ms]} ms, losses "
        f"{[round(x, 4) for x in losses]}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}"
        f" (expected {want})")
    check(counts == want, f"(d) launches {counts}, expected {want}")
    check(all(np.isfinite(losses)), f"(d) yi-9b losses {losses}")
    del state
    torch.cuda.empty_cache()
    p0 = fresh()["params"].float()
    fused, _, _ = train_steps(cfg, tcfg, fresh(), batches[:1], "cuda")
    plain_tcfg = train_tcfg(param_dtype="bfloat16", fused_sgd=False)
    unfused, _, _ = train_steps(cfg, plain_tcfg, fresh(plain_tcfg),
                                batches[:1], "cuda")
    pf, pu = fused["params"].float(), unfused["params"].float()
    del fused, unfused
    log(f"[train] (d) yi-9b after one step, the fused bfloat16 state "
        f"against the unfused one (logged: the fused update rounds after "
        f"every operation and reads lr and mu at bfloat16, the unfused one "
        f"rounds p - lr m' once): ||diff|| / ||update|| "
        f"{float((pf - pu).norm() / (pu - p0).norm()):.3e}, max |diff| "
        f"{float((pf - pu).abs().max()):.3e}, elements differing "
        f"{float((pf != pu).float().mean()):.4f}")
    del p0, pf, pu
    torch.cuda.empty_cache()
    return counts


def time_flash_bwd(flash_bwd, shape, dtype, reps):
    """The backward's cold-L2 time at ``shape`` against its bound, the
    plain backward and SDPA's backward (autograd of
    ``scaled_dot_product_attention``, causal, GQA); the forward's time with
    and without lse against its bound, the plain forward and SDPA's forward
    (causal, GQA, the same dtype)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_lse, flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain,
    )

    b, s, h, kv, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, do = (_randn(gen, (b, s, h, hd), dtype) for _ in range(2))
    k, v = (_randn(gen, (b, s, kv, hd), dtype) for _ in range(2))
    f0, b0 = flash_attention.launches, flash_bwd.launches
    _, lse = flash_attention_lse(q, k, v, causal=True, window=0)
    ms = time_launch(lambda: flash_bwd(q, k, v, do, lse), reps)
    # each of the call's kernels by the profiler: float32 runs D, then the
    # dq and dkdv blocks in one launch; bfloat16 dq, dkdv and, when H > KV,
    # the sum over a kv head's query heads
    names = (list(BWD_SIMT_KERNELS) if dtype == torch.float32 else
             list(BWD_TC_KERNELS)
             + (["sum_group_heads"] if h > kv else []))
    split = kernel_times(lambda: flash_bwd(q, k, v, do, lse), names)
    fwd_ms = time_launch(lambda: flash_attention(q, k, v), reps)
    fwd_lse_ms = time_launch(lambda: flash_attention_lse(
        q, k, v, causal=True, window=0), reps)
    flash_attention.launches, flash_bwd.launches = f0, b0
    sdpa_fwd_ms = time_launch(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True), reps)
    plain_ms = time_launch(lambda: flash_attention_bwd_plain(q, k, v, do),
                           max(3, reps // 5))
    plain_fwd_ms = time_launch(lambda: flash_attention_plain(q, k, v),
                               max(3, reps // 5))
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    library_ms = time_launch(lambda: torch.autograd.grad(
        out, leaves, dot, retain_graph=True), reps)
    esize = q.element_size()
    nbytes = esize * (3 * b * s * h * hd + 4 * b * s * kv * hd) + 4 * b * h * s
    flops = 2.5 * 4 * b * h * hd * s * (s + 1) // 2
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    fwd_bytes = esize * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    fwd_flops = 4 * b * h * hd * s * (s + 1) // 2
    fwd_bound, fwd_by = _bound(fwd_bytes, fwd_flops, peak)
    log(f"[time] flash_attention_bwd {shape} {str(dtype)[6:]}: kernel "
        f"{ms:.5f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / ms:.2f}% of the bound), plain {plain_ms:.5f} ms, "
        f"SDPA backward {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}: {flops / 1e9:.1f} GFLOP, 2.5x the forward's causal "
        f"products, {nbytes / 1e6:.1f} MB); its kernels by the profiler "
        + ", ".join(f"{n} {t:.5f} ms" for n, (t, _) in split.items())
        + f"; the forward {fwd_ms:.5f} ms, with lse {fwd_lse_ms:.5f} ms")
    log(f"[time] flash_attention forward {shape} {str(dtype)[6:]}: kernel "
        f"{fwd_ms:.5f} ms ({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * fwd_bound / fwd_ms:.2f}% of the bound), with lse "
        f"{fwd_lse_ms:.5f} ms, plain {plain_fwd_ms:.5f} ms, SDPA forward "
        f"{sdpa_fwd_ms:.5f} ms, bound "
        f"{fwd_bound:.5f} ms ({fwd_by}: {fwd_flops / 1e9:.3f} GFLOP, "
        f"causal, {fwd_bytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_train_sgd(fused_sgd_lanes, sgd_lanes_reference, cfg, lanes, what,
                   dtype=torch.float32):
    """``fused_sgd`` at a training state's shape with its model's leaves."""
    from repro_torch.launch.steps import train_layout

    shapes = [shape for _, shape in train_layout(cfg)]
    P = sum(int(np.prod(s)) for s in shapes)
    row = time_kernels(fused_sgd_lanes, sgd_lanes_reference, (lanes, P),
                       shapes, what, dtype)
    torch.cuda.empty_cache()
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the serving paths' CPU references and phase 9 (d)'s CPU run go to one
    # pool of spawned workers for the whole run
    with serve_pool() as spool:
        return run_phases(spool)


def run_phases(spool) -> int:
    """Every phase after the CUDA check (see the module's docstring), the
    CPU runs of phases 4-4e, 6 and 9 (d) in ``spool``."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK
    from repro_torch.configs.fedsr_cnn import CONFIG as CNN
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.configs.granite_8b import CONFIG as GRANITE
    from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
    from repro_torch.configs.jamba_v0_1_52b import SMOKE as JAMBA_SMOKE
    from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA
    from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA
    from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN
    from repro_torch.configs.phi35_moe_42b import CONFIG as PHI
    from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN
    from repro_torch.configs.stablelm_12b import CONFIG as STABLELM
    from repro_torch.configs.yi_9b import CONFIG as YI
    from repro_torch.configs.yi_9b import SMOKE as YI_SMOKE
    from repro_torch.core.executor import run_experiment
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_plain,
    )
    from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
    from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.ops import (
        kernel_route, ssd_scan, ssd_scan_plain,
    )
    from repro_torch.launch.train import lm_100m_config
    from repro_torch.models import layers, mamba2
    from repro_torch.models.small import init_small_model, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    # phases 4-7 and 4b-5e: the serving paths (yi-9b; stablelm-12b,
    # granite-8b and deepseek-7b; musicgen-large and llava; qwen3-moe and
    # phi3.5-moe; jamba-v0.1-52b; mamba2-2.7b). Their 2-layer runs come
    # first, right after phase 2, so that their CPU references use the
    # cores phases 3-3f leave idle; the full-depth runs come after phase 3k
    def dense_path(cfg, control=None, gpu_vs_cpu=GPU_VS_CPU,
                   kernel_vs_plain=KERNEL_VS_PLAIN, prefill_seq=4096):
        return ServePath(
            name=cfg.name, cfg=cfg, module=layers,
            kernels={"flash_attention": flash_attention,
                     "decode_attention": decode_attention},
            plain={"flash_attention": flash_attention_plain,
                   "decode_attention": decode_attention_plain},
            prefill_launches=lambda cfg: {"flash_attention": cfg.num_layers,
                                          "decode_attention": 0},
            serve_launches=lambda cfg, positions: {
                "flash_attention": 0,
                "decode_attention": cfg.num_layers * positions},
            launch_tol=LAUNCH_TOL, gpu_vs_cpu=gpu_vs_cpu,
            kernel_vs_plain=kernel_vs_plain,
            device_kernels=("flash_attention_kernel",),
            decode_kernels=DECODE_KERNELS, control=control,
            deep_note=f"over {cfg.num_layers} layers the near-one-hot "
            "attention rows decorrelate two runs that differ only in the "
            "attention's rounding, which is why each launch is held on its "
            "own inputs", prefill_seq=prefill_seq)

    yi = dense_path(YI)
    stablelm = dense_path(STABLELM, scaled_queries, STABLELM_GPU_VS_CPU,
                          STABLELM_KERNEL_VS_PLAIN)
    granite, deepseek = (dense_path(cfg, scaled_queries)
                         for cfg in (GRANITE, DEEPSEEK))
    # the audio and vlm families (ROADMAP A10.4a); llava's prefill at
    # S = 8192 (prefill_32k cut to one card), so its 4096-key window binds
    musicgen = dense_path(MUSICGEN, scaled_queries)
    llava = dense_path(LLAVA, scaled_queries, prefill_seq=8192)
    # the moe family (ROADMAP A10.4b) at phase 4's bounds, each beside its
    # wq x1.03 control (on the H100 the bfloat16 GPU-against-CPU medians
    # read 1.0e-2 and 1.2e-2, the controls' 0.19 and 0.20); qwen3-moe's
    # full depth (~122 GB of float32 weights) cut to fit the card
    qwen, phi = (dense_path(cfg, scaled_queries) for cfg in (QWEN, PHI))
    qwen_deep = dataclasses.replace(
        qwen, cfg=dataclasses.replace(QWEN, num_layers=MOE_DEEP_LAYERS),
        deep_note=qwen.deep_note + "; and a router pick flipped by a "
        "rounding moves its token's whole expert output")
    mamba = ServePath(
        name="mamba2-2.7b", cfg=MAMBA, module=mamba2,
        kernels={"ssd_scan": ssd_scan}, plain={"ssd_scan": ssd_scan_plain},
        prefill_launches=lambda cfg: {"ssd_scan": cfg.num_layers},
        serve_launches=lambda cfg, positions: {"ssd_scan": 0},
        launch_tol=SSD_TOL, gpu_vs_cpu=SSM_GPU_VS_CPU,
        kernel_vs_plain=SSM_KERNEL_VS_PLAIN,
        prefill_vs_decode=SSM_CHUNKED_VS_RECURRENT, deep_f32=SSM_DEEP_F32,
        device_kernels=SSD_KERNELS,
        deep_note="one-ulp bfloat16 flips carried through 64 layers; "
        "bounded in float32 below",
        serve_note="prefill_and_decode launches no ssd_scan, as in the "
        "reference: its _prefill feeds the prompt through decode_step one "
        "position at a time, and a Mamba2 decode_step runs the O(1) "
        "recurrence (ssd_decode_step); the chunked scan runs only in "
        "forward, i.e. make_prefill_step")
    # the hybrid family (ROADMAP A10.4c): jamba-v0.1-52b at full width
    jamba = hybrid_path(dataclasses.replace(JAMBA, **HYBRID_TWO))
    jamba_deep = dataclasses.replace(jamba, cfg=dataclasses.replace(
        JAMBA, num_layers=HYBRID_DEEP_LAYERS))
    # the 2-layer weights, drawn on the CPU one path ahead of the card; the
    # first path's draw runs under phases 1 and 2. The paths whose CPU
    # references take longest come first, but for qwen3-moe ahead of
    # phi3.5-moe: its draw (~13 s) fits under jamba's card runs (~9 s) and
    # phi3.5's (~21 s) under its own (~37 s)
    two_layer_paths = prefetched_weights([
        ("4e", jamba), ("4d", qwen), ("4d", phi), ("4b", stablelm),
        ("4b", deepseek), ("4b", granite), ("4", yi),
        ("4c", llava), ("4c", musicgen), ("6", mamba)])

    # phase 1: build every kernel, one nvcc per source, all at once
    names = ["fused_sgd", "flash_attention", "flash_attention_bwd",
             "decode_attention", "ssd_scan"]
    t0 = time.perf_counter()
    build.build(names)
    log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.1f}s")
    for name in names:
        log(build_report(name, build.BUILD_LOGS.get(name)))
    for kernel, report in ptxas_by_kernel(
            build.BUILD_LOGS.get("ssd_scan") or "").items():
        log(f"[build] ssd_scan {kernel}: {report}")
    # every flash kernel, forward and backward, and the decode kernels at
    # stablelm-12b's hd 160
    for name in ("flash_attention", "flash_attention_bwd",
                 "decode_attention"):
        for kernel, report in ptxas_by_kernel(
                build.BUILD_LOGS.get(name) or "").items():
            if name != "decode_attention" or re.search(r"\b160\b", kernel):
                log(f"[build] {name} {kernel}: {report}")
    check_tensor_core_sass(build)

    # phase 2: every kernel against its plain version
    t0 = time.perf_counter()
    max_abs_err = {"fused_sgd": kernel_sweep(fused_sgd_lanes,
                                             sgd_lanes_reference),
                   "fused_sgd_bf16": kernel_sweep(
                       fused_sgd_lanes, sgd_lanes_reference, torch.bfloat16)}
    max_abs_err.update(attention_sweep(flash_attention, flash_attention_plain,
                                       decode_attention,
                                       decode_attention_plain))
    lse_bit_check(flash_attention)
    max_abs_err["flash_attention_bwd"] = flash_bwd_sweep(flash_attention_bwd)
    max_abs_err["ssd_scan"] = ssd_sweep(ssd_scan, ssd_scan_plain,
                                        kernel_route)
    ssd_pass_check(
        (ssd_ops.chunk_states, ssd_ops.state_passing, ssd_ops.chunk_outputs),
        (ssd_ref.ssd_chunk_states, ssd_ref.ssd_state_passing,
         ssd_ref.ssd_chunk_outputs))
    ssd_split_check(ssd_scan, ssd_scan_plain, kernel_route)
    log(f"[sweep] phase 2 in {time.perf_counter() - t0:.1f}s")

    cast_bit_check(JAMBA_SMOKE)
    ssd_scan.routes.clear()
    lm = lm_100m_config()
    gap_bf16 = spool.submit(_cpu_train_gap, *gap_cfgs(lm, "bfloat16"))
    # phases 4, 4b, 4c, 4d, 4e and 6: every serving path at 2 layers on
    # the card, its CPU reference in the pool (held against at the end)
    t0 = time.perf_counter()
    finishes = []
    for phase, path, cpu_params in two_layer_paths:
        t1 = time.perf_counter()
        finishes.append(serve_two_layers(path, cpu_params, spool))
        del cpu_params
        log(f"[serve] phase {phase}: {path.name} at 2 layers on the card "
            f"in {time.perf_counter() - t1:.1f}s")
    rolling_cache_check(LLAVA)
    log(f"[serve] phases 4-4e and 6 on the card in "
        f"{time.perf_counter() - t0:.1f}s")

    # phase 3: the FedSR path
    t0 = time.perf_counter()
    fl = FLConfig(algorithm="fedsr", partition="pathological",
                  num_devices=20, num_edges=5, ring_rounds=5,
                  local_epochs=1, batch_size=32, rounds=10,
                  engine="fused", use_fused_sgd=True, seed=0)
    init = params_to_numpy(init_small_model(
        torch.Generator().manual_seed(0), CONFIG, torch.device("cpu")))
    runs = main_path(run_experiment, fused_sgd_lanes, CONFIG, fl, init)
    launches = {"fused_sgd": runs["cuda"][2]}
    check_main_path(runs, 199_210)
    log("[main] checks done: launches per step, one dispatch per block, "
        "identical plans/meters/h2d, accuracy within 0.02 of the CPU run")
    gpu_hist = runs["cuda"][0].history
    for rec in gpu_hist:
        log(f"[main] cuda block ending round {rec.round}: "
            f"{rec.seconds * 1e3 / rec.rounds:.2f} ms/round "
            f"(acc {rec.accuracy:.4f})")
    cpu_hist = runs["cpu"][0].history
    log(f"[main] cpu: {sum(r.seconds for r in cpu_hist) * 1e3 / fl.rounds:.2f}"
        f" ms/round")
    times = {"fused_sgd": time_kernels(fused_sgd_lanes, sgd_lanes_reference)}
    engine_rounds = {"fused": profile_round(CONFIG, fl, init,
                                            fused_sgd_lanes)}
    log(f"[main] phase 3 in {time.perf_counter() - t0:.1f}s")

    # phase 3b: the paper CNN through FedSR (with a stop and a resume) and
    # FedAvg
    cnn_fl = dataclasses.replace(fl, rounds=4, init_lr=CNN_LR)
    cnn_init = params_to_numpy(init_small_model(
        torch.Generator().manual_seed(0), CNN, torch.device("cpu")))
    t0 = time.perf_counter()
    cnn_launches = cnn_path(run_experiment, fused_sgd_lanes, CNN, cnn_fl,
                            cnn_init)
    log(f"[cnn] fused_sgd launches: FedSR {cnn_launches['cnn']}, FedAvg "
        f"{cnn_launches['fedavg']}; phase 3b's runs in "
        f"{time.perf_counter() - t0:.1f}s")
    launches["fused_sgd"] += sum(cnn_launches.values())
    for shape, what in ((CNN_SHAPE, "CNN leaves (FedSR rings)"),
                        (FEDAVG_SHAPE, "CNN leaves (FedAvg cohort)")):
        time_kernels(fused_sgd_lanes, sgd_lanes_reference, shape, CNN_LEAVES,
                     what)
    profile_round(CNN, cnn_fl, cnn_init, fused_sgd_lanes, "cifar10_like",
                  "CNN FedSR")

    # phase 3c: the sequential and batched engines on the paper MLP
    t0 = time.perf_counter()
    engine_launches = engines_path(run_experiment, fused_sgd_lanes, CONFIG,
                                   fl, init)
    log(f"[engines] fused_sgd launches of phase 3c's GPU runs: "
        f"{engine_launches}; its runs in {time.perf_counter() - t0:.1f}s")
    launches["fused_sgd"] += engine_launches
    # phase 3c's ring loop (ROADMAP A12): ring_optimization on the card
    launches["fused_sgd"] += ring_path(fused_sgd_lanes, sgd_lanes_reference,
                                       CONFIG, fl, init)
    time_kernels(fused_sgd_lanes, sgd_lanes_reference, LANE_SHAPE, MLP_LEAVES,
                 "MLP leaves (one sequential lane)")
    for engine in ("batched", "sequential"):
        engine_rounds[engine] = profile_round(
            CONFIG, dataclasses.replace(fl, engine=engine), init,
            fused_sgd_lanes, what=f"FedSR {engine}")
    for engine, r in engine_rounds.items():
        log(f"[engines] one steady FedSR round, {engine} engine: "
            f"{r['wall_ms']:.2f} ms unprofiled, {r['steps']} fused_sgd "
            f"launches ({1e3 * r['wall_ms'] / max(r['steps'], 1):.1f} us of wall "
            f"each), device busy {r['busy_ms']:.3f} ms "
            f"({100 * r['busy_ms'] / r['wall_ms']:.1f}% of the unprofiled "
            f"round)")

    # phase 3d: Table III's FedProx and HierFAVG rows on the paper MLP
    t0 = time.perf_counter()
    table3_launches = table3_path(run_experiment, fused_sgd_lanes, CONFIG,
                                  fl, init)
    log(f"[table3] fused_sgd launches of phase 3d's GPU runs: "
        f"{table3_launches}; its runs in {time.perf_counter() - t0:.1f}s")
    launches["fused_sgd"] += table3_launches
    time_kernels(fused_sgd_lanes, sgd_lanes_reference, TABLE3_SHAPE,
                 MLP_LEAVES, "MLP leaves (Table III's 20 lanes)")
    for algorithm, kw in TABLE3.items():
        r = profile_round(CONFIG, dataclasses.replace(
            fl, algorithm=algorithm, **kw), init, fused_sgd_lanes,
            what=algorithm)
        log(f"[table3] one steady {algorithm} round, fused engine: "
            f"{r['wall_ms']:.2f} ms unprofiled, {r['steps']} fused_sgd "
            f"launches, device busy {r['busy_ms']:.3f} ms "
            f"({100 * r['busy_ms'] / r['wall_ms']:.1f}% of the unprofiled "
            f"round)")

    # phase 3e: Table II's MOON, SCAFFOLD and Centralized rows on the paper
    # MLP
    t0 = time.perf_counter()
    table2_launches = table2_path(run_experiment, fused_sgd_lanes, CONFIG,
                                  fl, init)
    log(f"[table2] fused_sgd launches of phase 3e's GPU runs: "
        f"{table2_launches}; its runs in {time.perf_counter() - t0:.1f}s")
    launches["fused_sgd"] += table2_launches
    for algorithm in TABLE2_ENGINES:
        steps = TABLE2_COUNTS[algorithm, "fused"][0]
        r = profile_round(CONFIG, dataclasses.replace(
            fl, algorithm=algorithm, **TABLE2_KW), init, fused_sgd_lanes,
            TABLE2_TASK, algorithm,
            sgd_steps=None if steps else TABLE2_STEPS)
        log(f"[table2] one steady {algorithm} round, fused engine: "
            f"{r['wall_ms']:.2f} ms unprofiled, {r['steps']} SGD steps, "
            f"device busy {r['busy_ms']:.3f} ms "
            f"({100 * r['busy_ms'] / r['wall_ms']:.1f}% of the unprofiled "
            f"round)")

    # phase 3f: Table IV's K=100 fleet under the host and stream stores and
    # the prefetch pipeline
    t0 = time.perf_counter()
    table4_launches = table4_path(run_experiment, fused_sgd_lanes, CONFIG,
                                  fl, init)
    log(f"[table4] fused_sgd launches of phase 3f's GPU runs: "
        f"{table4_launches}; its runs in {time.perf_counter() - t0:.1f}s")
    launches["fused_sgd"] += table4_launches

    # phase 3g: the scenario curves and the attack column under drops,
    # stragglers, stale uploads and Byzantine or poisoned clients; phase
    # 3h: the attack grid's robust defense columns; phase 3i: its DP-SGD
    # row; phase 3j: personalization and classifier fleet serving; phase
    # 3k: the sharded engine and mesh_data_axis. The five phases' CPU runs
    # go to one worker pool while their GPU runs go on; every run shares
    # one task (run_experiment makes the same from the seed).
    from repro_torch.data.synthetic import make_task

    train, test = make_task("mnist_like", seed=fl.seed)
    with cpu_pool(CONFIG, init, train, test) as pool:
        jobs_3g = scenario_jobs(pool, fl)
        jobs_3h = robust_jobs(pool, fl)
        jobs_3i = dp_jobs(pool, fl)
        jobs_3j = pers_jobs(pool, fl)
        jobs_3k = mesh_jobs(pool, fl)
        jobs_9 = train_jobs(pool, lm_100m_config())
        t0 = time.perf_counter()
        scenario_launches, steady = scenario_path(
            run_experiment, fused_sgd_lanes, CONFIG, fl, init, jobs_3g,
            train, test)
        log(f"[3g] fused_sgd launches of phase 3g's GPU runs: "
            f"{scenario_launches}; its runs in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        robust_launches = robust_path(
            run_experiment, fused_sgd_lanes, CONFIG, fl, init, jobs_3h,
            train, test, steady)
        log(f"[3h] fused_sgd launches of phase 3h's GPU runs: "
            f"{robust_launches}; its runs in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        dp_launches = dp_path(run_experiment, fused_sgd_lanes, CONFIG, fl,
                              init, jobs_3i, train, test, steady)
        log(f"[3i] fused_sgd launches of phase 3i's GPU runs: "
            f"{dp_launches}; the phase in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        pers_launches = pers_path(run_experiment, fused_sgd_lanes,
                                  sgd_lanes_reference, CONFIG, fl, init,
                                  pool, jobs_3j, train, test)
        log(f"[3j] fused_sgd launches of phase 3j's GPU runs: "
            f"{pers_launches}; the phase in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        mesh_launches = mesh_path(run_experiment, fused_sgd_lanes, CONFIG,
                                  fl, init, jobs_3k, train, test)
        log(f"[3k] fused_sgd launches of phase 3k's GPU runs: "
            f"{mesh_launches}; the phase in "
            f"{time.perf_counter() - t0:.1f}s")
    launches["fused_sgd"] += (scenario_launches + robust_launches
                              + dp_launches + pers_launches + mesh_launches)
    for shape, what in (((8, 199_210), "MLP leaves (FedSR's rings on an "
                         "8-entry mesh)"),
                        ((24, 199_210), "MLP leaves (FedAvg's cohort on an "
                         "8-entry mesh)")):
        time_kernels(fused_sgd_lanes, sgd_lanes_reference, shape, MLP_LEAVES,
                     what)

    # phase 5: yi-9b at full depth
    t0 = time.perf_counter()
    launches.update(serve_full_depth(yi))
    log(f"[serve] phase 5 in {time.perf_counter() - t0:.1f}s")
    # phase 5b: stablelm-12b at full depth, its attention at hd 160
    t0 = time.perf_counter()
    for name, n in serve_full_depth(stablelm).items():
        launches[name] += n
    log(f"[serve] phase 5b in {time.perf_counter() - t0:.1f}s; the dense "
        f"paths' launches (yi-9b and stablelm-12b at full depth): "
        f"{launches}")
    # phase 5c: musicgen-large and llava at full depth
    t0 = time.perf_counter()
    for path in (musicgen, llava):
        for name, n in serve_full_depth(path).items():
            launches[name] += n
    log(f"[serve] phase 5c in {time.perf_counter() - t0:.1f}s; the dense, "
        f"audio and vlm paths' launches at full depth: {launches}")
    # phase 5d: qwen3-moe-30b-a3b at full width, depth cut to fit the card
    t0 = time.perf_counter()
    for name, n in serve_full_depth(qwen_deep).items():
        launches[name] += n
    log(f"[serve] phase 5d in {time.perf_counter() - t0:.1f}s; the "
        f"serving paths' launches at full depth: {launches}")
    # phase 5e: jamba-v0.1-52b at full width, one period of its pattern;
    # its bfloat16 scans (N = 16, chunk 128) all on the tensor cores
    t0 = time.perf_counter()
    routes = ssd_scan.routes.copy()
    for name, n in serve_full_depth(jamba_deep).items():
        launches[name] = launches.get(name, 0) + n
    routes = {r: ssd_scan.routes[r] - routes[r]
              for r in ("tensor_cores", "cuda_cores")}
    jamba_route = kernel_route(torch.bfloat16, JAMBA.ssm_chunk,
                               JAMBA.ssm_state, JAMBA.ssm_headdim)
    log(f"[serve] phase 5e in {time.perf_counter() - t0:.1f}s; jamba's "
        f"ssd_scan launches by route {routes} (its bfloat16 shape takes "
        f"{jamba_route}); the serving paths' launches at full depth: "
        f"{launches}")
    check(jamba_route == "tensor_cores" and routes["tensor_cores"] > 0
          and routes["cuda_cores"] == 0,
          f"jamba's bfloat16 scan at N = 16, chunk 128 left the tensor "
          f"cores: {jamba_route}, {routes}")
    t0 = time.perf_counter()
    for name, n in serve_full_depth(mamba).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[serve] phase 7 in {time.perf_counter() - t0:.1f}s")
    path_route = kernel_route(torch.bfloat16, MAMBA.ssm_chunk,
                              MAMBA.ssm_state, MAMBA.ssm_headdim)
    log(f"[serve] mamba2-2.7b: ssd_scan launches of phases 6-7 by route "
        f"{dict(ssd_scan.routes)}; the bfloat16 path's shape takes "
        f"{path_route}")
    check(path_route == "tensor_cores"
          and ssd_scan.routes["tensor_cores"] > 0,
          f"the mamba2 path's bfloat16 scan does not run on the tensor "
          f"cores: {path_route}, {dict(ssd_scan.routes)}")

    # phase 7b: LM fleet serving, yi-9b's K = 8 fleet at full width
    launches["decode_attention"] += fleet_path(yi, mamba, YI_SMOKE)

    # phase 8: kernel times
    t8 = time.perf_counter()
    time_flash(flash_attention, flash_attention_plain,
               (1, 256, 32, 4, 128), torch.bfloat16, 50)
    times["flash_attention"] = time_flash(
        flash_attention, flash_attention_plain, FLASH_PATH,
        torch.bfloat16, 20)
    times["decode_attention"] = time_decode(
        decode_attention, decode_attention_plain, DECODE_PATH, 50, (3,))
    time_decode(decode_attention, decode_attention_plain, DECODE_32K_B1,
                20, (16, 132))
    time_decode(decode_attention, decode_attention_plain, DECODE_32K, 10,
                (2,))
    time_flash(flash_attention, flash_attention_plain, FLASH_PATH_160,
               torch.bfloat16, 20)
    time_decode(decode_attention, decode_attention_plain,
                DECODE_PATH_160, 50, (3,))
    time_decode(decode_attention, decode_attention_plain, FLEET_DECODE,
                50, (3,))
    t0 = time.perf_counter()
    time_flash(flash_attention, flash_attention_plain, FLASH_MUSICGEN,
               torch.bfloat16, 20)
    time_flash(flash_attention, flash_attention_plain, FLASH_LLAVA,
               torch.bfloat16, 10, window=LLAVA_WINDOW)
    for shape in (DECODE_MUSICGEN, DECODE_LLAVA):
        time_decode(decode_attention, decode_attention_plain, shape, 50,
                    (3,))
    log(f"[time] phase 5c's kernel rows in "
        f"{time.perf_counter() - t0:.1f}s")
    times["ssd_scan"] = time_ssd(ssd_scan, ssd_scan_plain, SSD_PATH,
                                 torch.bfloat16, 20)
    time_ssd(ssd_scan, ssd_scan_plain, SSD_PATH, torch.float32, 10)
    # phase 5e's: jamba's scan (N = 16) and its unwindowed GQA 32/8 flash
    t0 = time.perf_counter()
    time_ssd(ssd_scan, ssd_scan_plain, SSD_JAMBA, torch.bfloat16, 20)
    time_flash(flash_attention, flash_attention_plain, FLASH_JAMBA,
               torch.bfloat16, 20)
    log(f"[time] phase 5e's kernel rows in {time.perf_counter() - t0:.1f}s; "
        f"phase 8 in {time.perf_counter() - t8:.1f}s")

    # phase 9: LM training, fedsr-lm-100m's main path, (b) GPU against
    # CPU, (c) yi-9b's bfloat16 step, (d) bfloat16 parameters through
    # fused_sgd; then the training kernels' times
    t0 = time.perf_counter()
    train_kernels = {"fused_sgd": fused_sgd_lanes,
                     "flash_attention": flash_attention,
                     "flash_attention_bwd": flash_attention_bwd}
    train_launches = train_main_path(lm, train_kernels)
    launches["fused_sgd"] += train_launches["fused_sgd"]
    launches["flash_attention"] += train_launches["flash_attention"]
    launches["flash_attention_bwd"] = train_launches[
        "flash_attention_bwd"]
    train_fused_and_times(lm)
    train_gap(lm, jobs_9["gap"])
    yi_train_check(YI)
    d_launches = yi_bf16_fused_check(YI, train_kernels)
    launches["fused_sgd_bf16"] = d_launches["fused_sgd_bf16"]
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] += d_launches[name]
    train_gap(lm, gap_bf16, "bfloat16")
    times["flash_attention_bwd"] = time_flash_bwd(
        flash_attention_bwd, BWD_PATH, torch.float32, 20)
    time_flash_bwd(flash_attention_bwd, FLASH_PATH, torch.bfloat16, 20)
    time_flash_bwd(flash_attention_bwd, FLASH_PATH_160, torch.bfloat16,
                   20)
    time_train_sgd(fused_sgd_lanes, sgd_lanes_reference, lm, TRAIN_LANES,
                   "fedsr-lm-100m's 12 leaves (4 lanes)")
    time_train_sgd(fused_sgd_lanes, sgd_lanes_reference,
                   dataclasses.replace(YI, num_layers=YI_TRAIN["layers"]),
                   1, "yi-9b's 12 leaves (2 layers)")
    times["fused_sgd_bf16"] = time_train_sgd(
        fused_sgd_lanes, sgd_lanes_reference,
        dataclasses.replace(YI, num_layers=YI_BF16["layers"]), 1,
        "yi-9b's 12 leaves (2 layers)", torch.bfloat16)
    log(f"[train] phase 9 in {time.perf_counter() - t0:.1f}s")
    # the 2-layer paths' GPU-against-CPU checks, on the pool's results
    t0 = time.perf_counter()
    for finish in finishes:
        finish()
    log(f"[serve] the 2-layer paths held against their CPU references in "
        f"{time.perf_counter() - t0:.1f}s (the pool's runs waited for)")
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f}s")

    if FAILURES:
        print(f"chip_smoke: FAILED {len(FAILURES)} check(s):", file=sys.stderr)
        for what in FAILURES:
            print(f"  {what}", file=sys.stderr)
        return 1
    # the backward has no Pallas twin: the reference differentiates its jnp
    # attention (models/layers.py::causal_attention)
    # (the bfloat16 case of fused_sgd is the reference's kernel at
    # p.dtype = bfloat16, an entry point of its own in fused_sgd.cu)
    sources = {"fused_sgd": "src/repro/kernels/fused_sgd/kernel.py:33",
               "fused_sgd_bf16": "src/repro/kernels/fused_sgd/kernel.py:33",
               "flash_attention": "src/repro/kernels/flash_attention/kernel.py:96",
               "flash_attention_bwd": "src/repro/models/layers.py:85",
               "decode_attention":
                   "src/repro/kernels/decode_attention/kernel.py:80",
               "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:77"}
    rows = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name.removesuffix('_bf16')}.cu",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max_abs_err[name], **times[name]}
        for name, replaces in sources.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())


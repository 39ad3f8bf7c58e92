#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA card and check it.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each printing its own lines, its wall seconds as it ends, and
raising on failure:

1. card: name, power limit and maximum SM clock as nvidia-smi reports
   them, and the SM count;
2. build: compiles the sixteen kernels of ``csrc/`` (six intersectors,
   the first-block keys, the null kernel, the KD walk and its triangle
   table, the brute force, the sampler, the two shading kernels of
   ``shade_bounce.cu`` and their backward's two, ``shade_backward.cu``) with
   nvcc, one process per source, all started together, and prints each
   one's ptxas register and spill lines;
3. kernel flat: the flat intersector against its plain PyTorch version
   (exact) and against the brute-force oracle (the bench.py gate: hit masks
   equal, relative t error <= 1e-3, ids differ only at ties), on random
   rays in the demo scene and in a random triangle soup, with partial
   active masks, NEE-style t_max windows and an all-inactive batch, at 2048
   and 777 rays and (demo) at every ray count the 512x512 main path gives
   the kernel; then both timed at 262,144 random rays, in turns; then the
   kernel on the demo's own camera, bounce and NEE wavefronts at 512x512,
   Morton-ordered as the render calls it: equal to its plain version and
   to its staged walk (``flat_staged_plain``), timed in turns with the
   plain version, with the pairs that reach each stage of the kernel's
   test; and the rays of tests/test_torch_flat.py's card test (the
   exactness argument's edge cases);
4. kernel flat_mxu: the flat intersector over MXU tile pairs (flat's
   staged walk, csrc/flat_walk.cuh), checked in phase 3 on the same rays as
   the flat kernel (equal to its plain version and to the flat kernel bit
   for bit, so the oracle gate holds for both); timed against its plain
   version at 262,144 rays, and beside the flat kernel in turns; equal there
   to its staged walk (``flat_staged_plain`` over the unpacked pairs, whose
   pairs per stage must equal the tiles') with the pairs per stage (its
   bound); then the demo's camera, bounce and NEE wavefronts at 512x512 in
   the caller's order (the render does not sort flat_mxu's rays): equal to
   its plain version and its staged walk, with the pairs per stage, timed in
   turns with flat; and the card test of tests/test_torch_flat.py for
   flat_mxu;
5. kernel queue: the queue intersector on the 20k hero scene and on a
   triangle soup of about 700 clusters (near the 6 MB table bound), against
   its plain version (exact), its plain walk (``queue_walk_plain``: exact
   in (t, id) and the per-ray visits and clusters) and the oracle at 2048
   and 777 rays in the same four activity cases; kernel and plain timed at
   262,144 soup rays in turns, the kernel held to its plain walk there,
   with the integer sums of its visits and clusters and the pairs of its
   cluster tests that reach each flat stage (its bound), then queue and hbm
   timed in turns on those rays; the kernel alone on the 20k hero's
   camera, bounce and NEE wavefronts at 512x512 (Morton order), each held
   to the plain walk, with its sums; the main path's row: ``render`` of
   the 20k hero at 512x512x8 in one pass, 4 samples (the queue kernel
   alone ran), then two timed samples after a warm-up and one profiled
   sample with the queue kernel's device time and share;
6. kernel blk: the blocked intersector on the full 2M-triangle hero scene
   with camera rays of the bench camera, bounce rays that start on the
   surfaces those hit, and NEE rays toward the lights with t_max windows.
   Against its plain version: exact at 2048 and 777 rays; against the
   plain walk (``blk_walk_plain``, the kernel's own pruning) exact in
   (t, id) and in the per-ray visits and clusters at the same rays; at
   65,536 rays of
   each kind, rays that differ (near-ties: a cluster's entry rounded past a
   hit inside it) may be at most 0.001% of the rays, each within
   1e-5 * max(t, 1) of the plain t and inside the oracle gate. Against the
   oracle at 256 rays of each kind (bench.py's count at this scale), with
   the surface origins lifted 1e-3 (see LIFT). Kernel
   and plain timed in turns at the 230,400 camera rays of one 640x360
   wavefront, the kernel held to its plain walk there, with the pairs of
   its cluster tests that reach each flat stage (its bound); the kernel
   alone, with its per-ray visit counts, at each
   wavefront, with the integer sums of its group visits and clusters
   intersected;
7. kernel hbm: the oct intersector, checked in phase 5 on the same rays as
   the queue kernel (equal to its plain version and to the queue kernel
   bit for bit); its per-ray cluster counts on a soup whose cluster count
   is padded; then every check and timing of phase 6 on the hero;
8. kernel blk_mxu: the blocked intersector over MXU blocks of the hero's
   branch, every check and timing of phase 6, each wavefront equal to the
   blocked kernel's bit for bit, both kernels timed in turns;
9. kernel first_blocks: the first-block key kernel on the same hero camera,
   bounce and NEE rays against its plain version (key for key) at 2048,
   777 and the whole wavefront, in the four activity cases; the key's
   leading factor against a numpy slab oracle at 256 rays; kernel and
   plain timed in turns at 230,400 camera rays, the argsort of the keys
   on its own; the kernel alone at each wavefront beside its bound from
   the valid boxes; the card test of tests/test_torch_ordering.py (ray
   counts around the kernel's block of rays, tables with invalid boxes
   between valid ones, the widest table the wrapper admits); and one
   profiled hero sample in one pass under ISAKLM_BLK_SORT=block: the keys'
   launches and device time;
10. fixed cost: the counterpart of scripts/fixed_cost_probe.py on the hero
   with 65,536 rays that miss everything, per call and per 128-ray block,
   by CUDA events and by the host clock: the whole blocked call in Morton
   and in caller order, prep_rays + ray_order alone, and the null kernel
   in the walk's launch shape with the blocked kernel's shared memory and
   without it;
11. ordering: the blocked path on each hero wavefront in caller order,
   Morton order and block order, each bit-equal to caller order; the
   kernel alone on the sorted rays, the key + argsort, and the whole call,
   in turns; s/sample of the demo (flat) and hero (blk) in one pass under
   each order; the blocked kernel alone on the rays of every intersector
   call of one hero sample, in caller and Morton order;
12. goldens: cornell_64 and demo_textured_64 (flat) and hero_small_32
   (queue) on the card, against tests/golden/*.npz (the tolerance of
   tests/test_torch_render.py: every value within 1e-4 but at most 8 of
   the image, which stay within 3e-4 -- the goldens carry XLA's fused FMA
   and approximate-rsqrt rounding, and the JAX package's own ops run one
   by one miss them by as much) and against the port on the CPU. The
   hero_small_32 render goes through the queue kernel alone;
13. main path: the CLI renders the demo at 512x512 with 8 bounces and the
   default Cornell box at 512x512 with 8 bounces (the flat kernel's path),
   the demo again under ISAKLM_INTERSECTOR=flat_mxu, then the hero scene
   at 640x360 with 6 bounces (the blocked kernel's path) and again under
   ISAKLM_INTERSECTOR=hbm, and ``render`` draws two samples of the hero
   with MXU blocks under ISAKLM_INTERSECTOR=blk_mxu and under the default
   rule. For each path the launch counts are zeroed just before and read
   just after, and the path runs under torch.profiler, whose CUPTI records
   count the kernels the card ran, a CUDA graph's replays included
   (``device_launches``): they must equal the wrappers' eager launches
   plus what the replays issued; the path's kernel must have run, no
   other intersector, and no plain version may have run on CUDA; each
   override's image must equal the default intersector's bit for bit.
   Every later path that renders through ``render`` or the CLI is counted
   the same way;
14. assets: the user's path through files, each file written under a
   temporary directory: (a) the full 2M-triangle hero exported with the
   port's save_obj/save_mat and rendered again through a one-entry JSON
   manifest (load_offset) by the CLI with the hero's argv: export, g++
   build, native parse, assembly and prepare_scene seconds and the OBJ
   size; the native parser ran; vertices and normals within 1e-5 of the
   procedural arrays; the blocked kernel alone launched; the image within
   the aggregate gate of scripts/hero_obj_roundtrip.py (mean |d| < 2e-3 on
   [0, 1], pixels with a channel off by more than 0.05 under 1%: the
   loader's re-centering rounds vertices by ~2e-7, which flips knife-edge
   hits) of the main path's procedural hero; (b) the demo with its checker
   written as a PNG and named by a ``texture`` line of its .mat: the atlas
   equal to the procedural one exactly, the flat kernel alone, the same
   gate against the main path's demo image at the demo's argv (in one
   pass, ``--ray-chunk 0``), and the card
   test of tests/test_torch_assets.py; (c) a two-mesh manifest (the 20k
   hero and the Cornell box, each with a yaw, a scale and an offset, one
   shared .mat) at 512x512x8: the queue kernel alone, the triangle count
   the sum of both meshes, the G-buffer finite (read from its checkpoint),
   the image's mean above 1;
15. resume: the demo at 512x512x8 through the CLI with ``--checkpoint``
   (in one pass, ``--ray-chunk 0``): 8 samples straight, and 4 then a
   second CLI call resuming to 8 on the same file, with ``--no-adaptive``
   and with the adaptive gate; the resumed PNG and G-buffer must equal the
   straight run's bit for bit; then 8 samples in batches of 2 with the
   second batch failing (an injected exception, as
   tests/test_io_cli.py does): the CLI reloads the checkpoint, retries,
   exits 0 and writes the straight run's PNG; the flat kernel alone;
16. interactive: ``InteractiveSession`` on the demo at 512x512x8 without
   the adaptive gate: two steps, the ``w`` key for 0.1 s, two steps; the
   image equals ``render`` of two samples from the moved camera bit for
   bit, through the flat kernel alone; then ``run_preview`` headless to 4
   samples writes ANSI frames and returns a finite image;
17. sharded: ``dist.sharding`` on the card, two ranks on this one card
   over gloo (``dist.launch`` with device cuda:0; NCCL refuses two ranks on
   one card). A rank's steps replay CUDA graphs after their eager call and
   their capture, and every rank's run is counted by the profiler
   (``device_launches``): ``render_sharded`` on a (2, 1) mesh of the demo
   (flat) and hero20k (queue) at 512x512x8 with 4 adaptive samples and of
   the hero (blk) at 640x360x6 with 2, in one pass, each G-buffer bit-equal
   to the single-process ``render`` on the card, each rank launching the
   path's kernel, with each rank's seconds of a full step's eager call and
   capturing call and s/sample of two replayed full steps (both ranks at
   once) beside one process's (two replays of ``render``'s graph, after its
   eager call and its capture), and the graph's capture record; the tail
   mode at the demo's width from a 95%-converged G-buffer (tail steps
   counted on each rank, the bucket's graph replayed), bit-equal;
   ``sharded_value_and_grad_fn`` of the demo on a (1, 2) mesh with the
   decorrelated gradient, three calls on one key (eager, capture, replay):
   each replay's loss bit-equal to the eager call's and its grads within
   rtol 1e-4, atol 1e-6 of them, every call within the same of the
   single-process hand-built estimator, grads bit-identical on both ranks,
   each call's seconds and the graphs' capture record; three
   ``sharded_train_step_fn`` steps (replays of the same graphs; finite
   params, s a step), both shading through the kernels and the backward's
   two; the CLI with the demo, checkpointed, under the two ranks' group:
   both PNGs byte-equal to one process's; the ms of the G-buffer all_gather
   and of the grad all_reduce. Then NCCL at world size 1 in this process:
   ``render_sharded`` of the demo on a (1, 1) mesh bit-equal to ``render``,
   ``unshard_gbuffer`` and the grad all_reduce through NCCL, and their ms;
   ``sharded_value_and_grad_fn`` of the demo at 512x512x8 and of the hero
   at 640x360x6 (``ray_chunk`` 0), five calls on one key: the eager call's,
   the capturing call's and the replays' seconds, the capture,
   instantiation and pool of the forward and backward graphs, each replay
   held to the eager call (the demo's also to the hand-built estimator),
   and one profiled replay: the path's intersector, the sampler, both
   shading kernels and both backward kernels, the backward's two once a
   bounce, no plain version on CUDA, its records and busy share. The
   collectives' times on one card are no multi-card scaling numbers;
18. kd: the KD tree's walk kernel (csrc/kd_intersect.cu, both layouts)
   and the brute-force kernel (csrc/brute_intersect.cu). The demo, the 20k
   hero and ``hero_scene(300_000)`` (KD_BUILD_LIMIT; its cluster path is
   blk), each prepared with its KD tree (``prepare_scene(build_kd=True)``;
   it builds none by default) and its seconds: the native KD build's and
   ``build_wavefront_kd``'s seconds, nodes, chunk rows and table bytes; on
   each scene's camera, bounce and NEE wavefronts at 512x512 and on 16,384
   random rays with 30% inactive, the walk kernel over the chunk rows and
   over the tree's lists equal to its plain version (``wavefront_plain``,
   ``kd_plain``) in (t, id, per-ray stats), with the SHA-256 of each (t, id,
   hit); on every ray of those wavefronts the walk against the scene's
   cluster kernel under the bench gate (origins lifted LIFT; the
   disagreements at exact surface origins counted), and on 4,096 rays of
   each against the brute oracle; both layouts timed at each wavefront
   beside their bounds (node steps and triangle tests from the kernel's
   own per-ray counts, which equal the plain version's), and the chunk-row
   kernel in turns with its plain version on the 20k hero's camera
   wavefront; the card tests of tests/test_torch_kdtree.py (random and edge
   rays: origins on a splitting plane, rays lying in it, origins on the
   padded box's faces, axis-aligned rays, active masks). The brute-force
   kernel equal to ``nearest_hit_brute`` on the Cornell box's and the
   demo's wavefronts, timed in turns with it on the demo's camera
   wavefront. Then the demo and the 20k hero rendered at 512x512x8 in one
   pass with the cluster tables dropped, through the KD walk kernel alone,
   and with every table dropped, through the brute kernel alone (16
   launches a sample each), in turns with their cluster path: the
   s/sample, the pixels that differ and the aggregate gate of each image
   against the cluster path's; and the CLI's ``--scene demo --no-kd``
   (the brute kernel alone) at 512x512, 4 samples: its PNG byte-equal to
   the same run with ``nearest_hit_brute`` in the kernel's place, and
   beside the flat path's PNG (``--no-kd`` keeps the scene's own light
   order, so its samples differ by noise); the same run with the moved
   scene's lights put in ``prepare_scene``'s order (the CLI's
   ``load_scene`` wrapped) under the aggregate gate of the flat path's PNG.
   The phase also builds each scene's triangle tables (the
   records of csrc/tri_consts.cu, once a tree: ``WavefrontKD.tri_table``,
   ``KDTreeArrays.tri_table``) and logs their bytes and seconds (time to
   the first sample), each equal to ``tri_consts_plain`` bit for bit, the
   table kernel timed with it on the 20k and the 300k hero's corners (CUDA
   graphs of 20 calls in turns, its own duration by torch.profiler, beside
   its bound);
   holds every wavefront's SHA-256 of (t, id, hit) to the parent's
   (PARENT_KD_DIGESTS, those of the first KD kernels); runs the card tests of
   tests/test_torch_tri_consts.py (the table, the walk at depths 21, 32
   and 64 with full and overflowed stacks, the brute force at ragged
   tile and block counts, empty masks and ties); logs the SASS opcodes of
   the walk's and the brute force's inner loops (``cuobjdump -sass``);
   renders through the walk with a fresh copy of its chunk rows, so that
   the run builds the table (its launches are the kernels line's); and
   holds the replayed KD and brute steps of the demo and the 20k hero to
   eager ones by SHA-256 (``steps_against_replays``).
   The kernels line takes the KD walk's launches from one render through
   it, and each kernel's max_abs_err over its kernel-vs-plain comparisons;
19. graphs: the step factories of ``integrator/render.py``, which capture
   a step in a CUDA graph and replay it, on the demo (flat), the 20k hero
   (queue) and the 2M-triangle hero (blk) at full width, in one pass:
   ``make_step_fn`` over 4 steps (eager, capture, replays) against the
   eager ``render_step`` loop, with the adaptive gate off and on: the
   G-buffers' SHA-256 equal and the kernels the card ran equal (counted by
   torch.profiler), of the path's kernel alone; ``make_compact_step_fn`` against ``compact_step``
   on the demo; the demo rendered adaptively to convergence
   through ``render`` against the eager loop of ``render_step``,
   ``candidates`` and ``tail_step`` it stands for, bit for bit, through at
   least two buckets of the ladder, with the graphs it captured and the
   wall seconds of both in turns (the first ``render`` with its captures);
   eager against replayed s/sample of full steps, demo and hero, at
   ray_chunk 0 and 16384, in turns, with each graph's capture and
   instantiation seconds and its pool's memory; one profiled replayed
   sample of each in one pass: the device's busy share within the trace,
   the path's kernel records equal to what the capture recorded, and the
   two shading kernels' records one each a bounce of each pass; ``entry()``'s
   ``fn`` captured in a graph and replayed with two keys against ``fn`` run
   eagerly, bit for bit; ``dryrun_multichip(1)`` over NCCL and
   ``dryrun_multichip(2, "cuda:0")``, two ranks on this card over gloo;
20. perf: seconds per sample and rays/s (pixels x bounces x 2) of full
   steps, demo 512x512x8 and hero 640x360x6, at the CLI's ray_chunk (16384,
   one timed sample) and in one pass (0, two), in turns, each after two
   warm-up steps (the eager call and the capture: ``render`` replays its
   steps' graphs), and one torch.profiler sample at each:
   CUDA records per sample, summed device kernel time, the busy share
   within the trace's device span and the intersector's share, the two
   shading kernels' records (one each a bounce of each pass) and time, and
   in one pass the records by kernel name; then in one pass each override beside its default
   (demo: flat, flat_mxu; hero: blk, blk_mxu, hbm), in turns, with one
   profiled sample each;
21. grad: bench.py's fwd and fwd+bwd (loss = mean(render_sample), leaf =
   the material albedo) through the entry points: demo 512x512x8 and hero
   640x360x6 at ray_chunk 0 (two timed samples each) and 16384 (one), the
   hero again in one pass under
   ISAKLM_BLK_SORT=block (the first-block key kernel's main-path run);
   s/sample, rays/s, peak memory, launches per kernel (no plain version
   on CUDA; the two shading kernels and the backward's two kernels once
   each a bounce of each pass; first_blocks and blk both launch under block
   ordering), grads finite and nonzero; one fwd+bwd sample of the demo and
   of the hero under torch.profiler, the kernels the card ran held to the
   wrappers' launches (``device_launches``, ``check_only`` with grad), the
   backward kernel's records and device time, the forward's and the
   backward's device time and top kernels; grad-vs-FD on the card
   (``grad_vs_fd``; Cornell albedo at 16x16 and at BASELINE config 0,
   64x64 @ 16 spp with 4 bounces and no roulette, the silhouette-free
   camera view) with tests/test_estimator.py's tolerances: the autodiff
   side eager through the shading kernels and the backward's two, the
   finite differences through one CUDA graph of f (an eager call, a
   capture, 2n - 1 replays), run again under torch.profiler, where the
   kernels the card ran are the eager launches plus the replays' (the
   intersector, the sampler and both shading kernels 2n times one
   evaluation's launches, no backward kernel, no plain version), and each
   replayed quotient equal bit for bit to the eager loop's (the harness
   with no graph); config 0's finite differences timed in turns, eager loop
   against the graph (3 pairs: wall and per-evaluation seconds, the
   capture's seconds, instantiation and pool), and its autodiff side; the
   autodiff side under torch.profiler, the card's gradient against the
   port's on the CPU, and the card test of tests/test_torch_fd.py;
22. sampler: the Threefry-2x32 sampler kernel (csrc/threefry_uniforms.cu,
   ``rng.uniforms`` on CUDA ids) against its plain version
   (``rng.uniforms_plain``) by SHA-256 at the main path's shapes: the
   demo's 262,144 and the hero's 230,400 int32 pixel ids, a demo tail
   bucket of 131,072 with its clamped ids, and 262,144 int64 ids across
   2**32; streams 0-7 at n = 9 and the camera's at n = 4, keys as ints and
   as a key tensor; the card test of tests/test_torch_rng.py (edge ids,
   every n, a draw captured in a CUDA graph and replayed with new keys);
   the SASS opcodes of the kernel's instantiations beside the ALU slots
   its bound counts; kernel and plain timed in turns (demo n = 9 and 4,
   hero n = 9) by CUDA events around the replay of a CUDA graph of 20
   calls (the device's time; the kernels line takes it), the kernel's own
   duration in one replay by torch.profiler, beside the bound; the demo
   n = 9 draw also by calls one after another (the host's cost); the demo and the hero rendered in one pass, 3 samples each
   (eager, capture, replay), with ``rng.uniforms`` patched to the plain
   version: the G-buffer's SHA-256 equal to the kernel's;
23. shade: the two shading kernels of a bounce (csrc/shade_bounce.cu,
   ``shade_bounce`` and ``finish_bounce`` of kernels/shade.py) against
   their plain versions by SHA-256 of every output: the card test of
   tests/test_torch_shade.py (an edge scene with 0, 1 and 2 lights and the
   demo, both scene layouts, both lobe-ratio modes, with and without
   roulette, 2,001 rays and one); every bounce's real wavefront of one
   sample in one pass through ``render_sample`` (``integrator.path_trace.
   shading`` replaced by a stand-in that runs both and goes on with the
   kernels'): the demo at 512x512x8 (flat), the hero at 640x360x6 (blk),
   the 20k hero at 512x512x8 (queue) and the demo without cluster or
   shading tables (the brute force, the per-triangle arrays), each render
   equal to the render; each kernel timed in turns with its plain version
   at the first bounce of the hero and of the demo (the kernels line takes
   the demo's) by CUDA events around the replay of a CUDA graph of 20 calls
   (the device's time), its own duration by torch.profiler, and its
   wrapper by calls one after another (the host's cost), beside its bound
   (bytes over the HBM rate against issue slots over the FP32 lanes,
   SHADE_*_SLOTS and SHADE_*_BYTES).
24. shade_grad: the backward of a bounce's shading (csrc/shade_backward.cu:
   ``bounce_bin``, which sorts the live rays by class into a ray list, from
   the class bytes the forward kernels write where autograd records the
   bounce, and zeroes the sums, and ``bounce_backward``, the reverse over
   that list; ``bounce_backward`` of kernels/shade.py launches both)
   against its plain version
   (``bounce_backward_plain``: autograd of the plain versions recomputed)
   at tests/test_torch_shade_grad.py's tolerances (per-ray gradients
   within rtol 1e-4 plus 1e-6 x the largest, the material and texel sums
   within rtol 1e-4 plus atol 1e-6, non-finite values at the same places):
   first the kernels' registers, local bytes and resident warps as the
   card reports them; that module's card tests (the edge scenes and the
   demo, both layouts, both lobe-ratio modes, with and without roulette,
   2,001 rays and one, the binning against its plain version, and a
   grazing miss whose plain gradient is NaN and the kernel's finite; the
   forward's class bytes against ``ray_classes_plain``, every other output
   bit-equal without them, and a call on no ray); every bounce of one
   fwd+bwd sample (each call's class bytes held to ``ray_classes_plain``)
   through
   ``render_sample`` with every material field, the texels and the camera
   position as leaves (``shade.bounce_backward`` replaced by a stand-in
   that runs both and goes on with the kernel's, and recomputes in float64
   each ray with a value beyond the strict tolerance: the kernel no
   farther from it than RECHECK_FACTOR times the float32 plain version):
   the demo at 512x512x8 (flat), the hero at 640x360x6 (blk), the 20k hero
   at 512x512x8 (queue) and the demo without cluster or shading tables
   (the brute force), each checked sample's loss equal to the sample's
   and no more values beyond the tolerance than run BO's
   (SHADE_GRAD_BEYOND); on the demo's bounce 0 the reverse with its
   material sums in device memory (a table of more materials than the
   shared one holds, ``many_materials``), then with the shared table (the
   profiler names the instantiation), a call where every lane is dead and
   one for each class alone; the binning against ``bounce_bin_plain`` (each
   class's rays as sets, the counts, the dead lanes' pass-through;
   also with every lane dead); a call timed
   in turns with its plain version at the first bounce of the hero and of
   the demo (the kernels line takes the demo's) by CUDA events around the
   replay of a CUDA graph (20 calls of the kernels, 3 of the plain
   version), the reverse's own duration by torch.profiler, beside its
   bound (SHADE_BACKWARD_* bytes and slots); the binning alone likewise
   (a call in the graph and its kernel's own duration; also on no ray,
   one block: the launch and the zeroing alone), beside its bound
   (``shade_bin_bound``) and the parent tree's numbers of run CE
   (PARENT_BIN_MS; tools/compare_kernel_times.py times the two in turns).
25. telemetry: the program's spans (``telemetry``) on the profiler's
   clock: a span around ``torch.cuda._sleep(SLEEP_CYCLES)`` and a sync,
   inside ``perfbench.trace.cuda_profile``, SLEEP_TRIES times, must hold
   the spin's launch (its host-side record, on the host's clock) every
   time; the offsets at both ends logged, and those of the spin kernel's
   record as kineto maps it onto the host's clock (with an error that
   drifts);
   a span site's cost with no profiler and under one; then each one-card
   cell of BENCHMARK.json (TELEMETRY_CELLS, seed TELEMETRY_SEED) through
   its perfbench driver: windows of the mix's ``trace_seconds``,
   untraced, traced, traced, untraced, each one's ms a step (the traced
   windows' cost), and of each traced window the device's idle time a
   step split by the innermost span open when the host launched the work
   that ended each gap (``tools.profiling.idle_by_span``; "none": the
   caller's loop), the drift of kineto's device clock, the counts its
   spans took, summed by span name, and the cell's per-layer metrics as
   the benchmark's readers read them.

Every path that check_only holds (main path, assets, resume, interactive,
sharded, kd, graphs, grad) must also have launched the sampler kernel and
no plain sampler on CUDA, the two shading kernels as often as each other
and no plain shading on CUDA; a path that differentiates (the grad
phase's fwd+bwd and autodiff side, the sharded value_and_grad and train
step) also the backward's two kernels once each a shading launch, the
others never; ``device_launches`` holds the sampler's and the shading's profiler
records to their eager plus replayed launches like every kernel's, and the
kernels line's sampler and shading rows count their launches over the
main path's runs, the backward kernel's over the grad phase's fwd+bwd
runs.

Every kernel's ``bound_ms`` is the larger of its bytes over the HBM rate
and its issue slots over the card's FP32 lanes (see the note on issue
slots below), the sampler's over the lanes of its slowest pipe (ALU, all
pipes together, or XU; see SAMPLER_PAIR_ALU), counted from the run's own
inputs and, where the work depends on the data, from the kernel's own
per-ray counts.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA card or the port is missing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import itertools
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import weakref
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "renders")
# Golden tolerance, as tests/test_torch_render.py (see the module docstring)
GOLDEN_ATOL, GOLDEN_OUTLIERS, GOLDEN_MAX = 1e-4, 8, 3e-4
# The bench.py oracle gate holds in full at its own ray counts. Among
# hundreds of thousands of random rays some start within 5e-3 of a surface
# and graze it (|cos| ~ 0.05): there the flat contract's plane equation,
# shared with the TPU kernel, rounds t by a few 1e-6 (the brute oracle's
# normalized form lands nearer the float64 value), which the relative gate
# with its 1e-3 floor on t reads as up to 2e-3. Such a hit must still be on
# the oracle's triangle and within this absolute distance.
BENCH_RAYS = (2048, 777)
NEAR_SURFACE_ATOL = 1e-5
# Bounce and NEE rays of the main path start exactly on a surface. Whether
# such a ray hits its own triangle at t ~ t_eps depends on the last bits of
# the plane equation, which the cluster contract (the TPU kernel's and the
# port's) and the brute oracle's normalized form round differently. The
# oracle gate therefore runs on the same rays with their origins lifted
# LIFT along the surface normal, as the repo's own oracle tests start
# bounce rays 1e-3 off a vertex; the disagreements at exact surface origins
# are counted and printed.
LIFT = 1e-3
# Kernel vs plain where pruning may differ (near-ties): at most this share
# of the rays checked, each within NEAR_TIE_TOL * max(t, 1).
NEAR_TIE_SHARE, NEAR_TIE_TOL = 1e-5, 1e-5
HERO_W, HERO_H, HERO_BOUNCES = 640, 360, 6
_BIG_ID = 2**31 - 1
# Card vs CPU gradients of one render: the CUDA backward of the material
# gathers adds with atomics in an order of its own, and sin/cos/exp round
# their last bit differently from the CPU's, so the two agree to float32
# accumulation error, not bit for bit.
CARD_VS_CPU_RTOL, CARD_VS_CPU_ATOL = 1e-4, 1e-6
# The least time the card could take (bound_ms): the larger of the bytes a
# call must move over the HBM rate (3.35 TB/s, the H100 SXM data sheet) and
# its issue slots over the card's FP32 lanes (the SM count x 128 lanes x
# the SM clock nvidia-smi reports as clocks.max.sm; set in main). Issue
# slots per unit of work, counted off the kernels' code: a multiply-add
# pair is one slot; every other product, sum, subtraction, comparison,
# select and min/max is one, and an IEEE division ten (the reciprocal, its
# range check and eight refinement steps). Per (ray, triangle slot):
#   TRI_HIT_SLOTS, `tri_hit` with the update of the best: six dot products
#     18, the plane subtraction 1, the division 10, two d20/d21 sums 4, the
#     barycentrics 6, six inside and two validity comparisons 8, the
#     select 1, the update's comparison and two selects 3;
#   the flat kernel's stages: PLANE_SLOTS (two dot products, the
#     subtraction, three comparisons), WINDOW_SLOTS (the division, two
#     comparisons), EDGE_SLOTS (four dot products, the two sums, the
#     barycentrics, six comparisons, two selects).
# A bound charges the stages, not the full test: the plane stage on each
# real slot tested, the window and edge stages on the pairs that reach
# them (``flat_slots``; for the walks, each cluster test against the best
# at its start; for the brute force, which divides on every pair, the
# plane and window stages on every pair and the edge stage where the plane
# distance can win, ``brute_stage_counts``). TRI_HIT_SLOTS gives the full
# test's bound beside it.
# Per (ray, box): SLAB_SLOTS, the slab test (six subtractions, six
# products, six NaN tests, ten min/max, two comparisons, the clamp at 0 and
# the validity test); KEY_SLOTS, that and the first-block key's two
# comparisons against its running pair.
HBM_BYTES_PER_S, FP32_LANES_PER_SM = 3.35e12, 128
# Phase telemetry: spans around a spin of SLEEP_CYCLES (about 5 ms), and
# the one-card cells whose windows it traces
SLEEP_TRIES, SLEEP_CYCLES, SPAN_CALLS = 20, 10_000_000, 100_000
TELEMETRY_CELLS = ("demo-adaptive", "demo-train", "hero1080-viewer")
TELEMETRY_SEED = 2147493001
# The sampler (csrc/threefry_uniforms.cu) issues 32-bit integer work,
# counted by the pipe of an SM of compute capability 9.0 that issues it
# (lanes an SM a clock from the CUDA C++ Programming Guide's table of
# arithmetic throughput):
#   ALU, 64 lanes: the shifts and logic no other pipe issues, per counter
#     pair 20 funnel-shift rotations and 20 xors (SAMPLER_PAIR_ALU), and a
#     shift a word written;
#   all pipes together, 128 lanes (one warp instruction a clock on each of
#     the four sub-partitions, ALU and FMA pipes alike): those, the adds
#     (SAMPLER_PAIR_ADDS: 20 rounds', the second word's five key
#     injections, the first word's last one, whose other four fold into a
#     round's three-input add, and the counter's), and a word's conversion
#     and product by 2**-24; nvcc may send an add to the FMA pipe (IMAD);
#   XU, 16 lanes (XU_LANES_PER_SM): a word's conversion to float.
# Where n is odd the last pair's second word is dropped, and with it its
# last rotation, xor and key injection. Work done once a ray (the first
# word's first add, the key schedule) is not counted. The bound takes the
# slowest pipe; phase sampler logs the SASS opcodes beside this count.
INT32_LANES_PER_SM, XU_LANES_PER_SM = 64, 16
SAMPLER_PAIR_ALU, SAMPLER_PAIR_ADDS = 40, 27
TRI_HIT_SLOTS, PLANE_SLOTS, WINDOW_SLOTS, EDGE_SLOTS = 51, 10, 12, 30
# The shading kernels (csrc/shade_bounce.cu), counted off the code by the
# rule above, with a square root ten slots like a division and a sine or a
# cosine 25 (range reduction and polynomial), per lane by what it runs:
#   SHADE_GEOMETRY_SLOTS, hit_geometry on every lane: the geometric normal's
#     cross product and normalisation 45, the plane hit 30, the point 6, the
#     barycentrics 57, the position 15, the shading normal, tangent and
#     bitangent 123, the back-face flip 9, the uv 10;
#   SHADE_LIVE_SLOTS, a live lane's material and two texture lookups 40, the
#     GGX half vector 111 (two square roots, a division, a sine and a
#     cosine), the emission and the state 20;
#   SHADE_DIELECTRIC_SLOTS, a live non-metal lane's Fresnel term 74 and lobe
#     ratios 26;
#   SHADE_LOBE_SLOTS, the selected lobe: metal (conductor Fresnel, reflect,
#     the specular weight's two Smith terms), specular, transmission
#     (refract and the specular weight), diffuse (the cosine hemisphere);
#   SHADE_SHADOW_SLOTS, every lane of a scene with lights: the light pick,
#     the point on the light, the window and the direction;
#   FINISH_LANE_SLOTS, every lane of finish_bounce: the direct light's sum
#     and Russian roulette (three divisions);
#   FINISH_DIRECT_SLOTS, a visible shadow hit: hit_geometry, the material,
#     the light's area, the two cosines and the weight.
SHADE_GEOMETRY_SLOTS, SHADE_LIVE_SLOTS, SHADE_DIELECTRIC_SLOTS = 295, 171, 100
SHADE_LOBE_SLOTS = {"metal": 196, "specular": 120, "transmission": 169, "diffuse": 92}
SHADE_SHADOW_SLOTS, FINISH_LANE_SLOTS, FINISH_DIRECT_SLOTS = 80, 45, 410
SLAB_SLOTS, KEY_SLOTS = 32, 34
LANE_SLOTS_PER_S = 0.0  # SMs x FP32_LANES_PER_SM x clocks.max.sm, once read
TILE_BYTES = 16 * 128 * 4


CARD = ""  # nvidia-smi's "name, power.limit" of the card, once read


def log(msg: str, name_card: bool = True) -> None:
    """Print a line; once the card is known, every line names it (the
    JSON result lines pass name_card=False)."""
    if name_card and CARD and CARD not in msg:
        msg = f"{msg} [{CARD}]"
    print(msg, flush=True)


class Phase:
    """Prints the wall seconds of a phase as it ends."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s wall")
        return False


def nvidia_smi(query: str, *fmt: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=query``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format=csv,noheader{''.join(fmt)}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def cuda_ms(fn, reps: int = 20, warmup: int = 2):
    """Mean milliseconds of fn() on the card, after ``warmup`` calls, and the
    result of the last call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def bound(slots: float, nbytes: float, lanes_per_sm: int = FP32_LANES_PER_SM) -> dict:
    """bound_ms = max(issue slots / the card's lane rate, bytes / HBM rate),
    and which; the lanes are the FP32 lanes unless ``lanes_per_sm`` says
    otherwise (the sampler's slowest pipe: ``sampler_bound``)."""
    lane_rate = LANE_SLOTS_PER_S * lanes_per_sm / FP32_LANES_PER_SM
    t_ops, t_bytes = slots / lane_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": slots, "bytes": nbytes}


def flat_slots(counts) -> int:
    """Issue slots of the triangle tests on a ray set, from the per-ray
    (slots visited, pairs reaching the division, pairs reaching the edge
    test) of ``flat_staged_plain`` or of a plain walk's ``stages``: the
    plane stage on every slot a ray visits (its real slots), the window and
    edge stages where they run."""
    c0, c1, c2 = counts.sum(dim=0).tolist()
    return c0 * PLANE_SLOTS + c1 * WINDOW_SLOTS + c2 * EDGE_SLOTS


def walk_stage_counts(walk_plain, rays, chunk: int = 65536):
    """A walk kernel's plain walk ``walk_plain(rays, stages=True)`` on
    ``rays`` in chunks (each ray walks alone): its (t, id, stats) and its
    flat stages' count of the cluster tests (``flat_slots`` takes it)."""
    outs = [walk_plain(rays[i:i + chunk], stages=True) for i in range(0, rays.shape[0], chunk)]
    out = [torch.cat(x) for x in zip(*outs)]
    return tuple(out[:3]), out[3]


def stage_log(label: str, pairs, b: dict, full: dict) -> None:
    """Log the pairs of a ray set that reach each flat stage, its bound and
    the bound with the full test on every slot tested."""
    c = pairs.sum(dim=0).tolist()
    log(f"stages {label}: slots tested {c[0]}, pairs reaching the division {c[1]} "
        f"({c[1] / max(c[0], 1):.1%}), the edge test {c[2]} ({c[2] / max(c[0], 1):.1%}); "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), the full test on every slot tested "
        f"{full['bound_ms']:.4f} ms")


def main_path_shapes(num_pixels: int, floor: int, ray_chunks) -> list:
    """Every ray count the render hands the intersector: each bucket of the
    ceil-halving ladder {num_pixels, ..., floor}, cut into ``ray_chunk``
    passes (0 = one pass), remainders included."""
    from isaklm_raytracer_tpu_torch.integrator.render import compact_bucket

    buckets, n = set(), num_pixels
    while True:
        buckets.add(compact_bucket(n, num_pixels, floor))
        if n <= 1:
            break
        n = -(-n // 2)
    shapes = set()
    for bucket in buckets:
        for chunk in ray_chunks:
            step = chunk or bucket
            shapes.update(min(step, bucket - s) for s in range(0, bucket, step))
    return sorted(shapes)


def random_rays(rng, n, lo, hi, device):
    o = (rng.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o, device=device), torch.tensor(d, device=device)


def brute(o, d, vertices, rays_per_call: int = 256):
    """nearest_hit_brute in slices of rays, so a 2M-triangle scene keeps
    its (rays, triangles) temporaries small."""
    from isaklm_raytracer_tpu_torch.accel import nearest_hit_brute

    parts = [nearest_hit_brute(o[s:s + rays_per_call], d[s:s + rays_per_call], vertices)
             for s in range(0, o.shape[0], rays_per_call)]
    return tuple(torch.cat(p) for p in zip(*parts))


def brute_stage_counts(o, d, vertices, t_eps: float = 1e-5, rays_per_call: int = 16384):
    """Per ray, the brute-force kernel's (pairs, pairs reaching the
    division, pairs reaching the edge test), for ``flat_slots``: every
    pair forms its plane distance s with the division (the plane and window
    stages), and only a pair whose s >= t_eps and s < the nearest hit
    before it in id order goes on to the barycentrics (the edge stage)."""
    from isaklm_raytracer_tpu_torch.accel.wavefront import tri_hits
    from isaklm_raytracer_tpu_torch.math import transforms

    p1 = vertices[:, 0]
    e1, e2 = vertices[:, 1] - p1, vertices[:, 2] - p1
    n = transforms.normalize(transforms.cross(e1, e2))
    counts = []
    for s0 in range(0, o.shape[0], rays_per_call):
        oc, dc = o[s0:s0 + rays_per_call, None], d[s0:s0 + rays_per_call, None]
        s = (transforms.dot(n, p1) - transforms.dot(oc, n)) / transforms.dot(dc, n)
        t = tri_hits(oc, dc, p1, e1, e2, t_eps)
        best = torch.cat([torch.full_like(t[:, :1], float("inf")),
                          torch.cummin(t, dim=1).values[:, :-1]], dim=1)
        edge = ((s >= t_eps) & (s < best)).sum(dim=1)
        every = torch.full_like(edge, vertices.shape[0])
        counts.append(torch.stack([every, every, edge], dim=1))
    return torch.cat(counts)


def oracle_gate(label, t_k, i_k, h_k, oracle, act, t_max, bench_gate) -> int:
    """The bench.py gate against the brute oracle (hit masks equal,
    relative t error <= 1e-3 with a 1e-3 floor on t, ids differ only at
    ties). Beyond the bench's ray counts a hit over the relative gate passes
    only on the oracle's own triangle within NEAR_SURFACE_ATOL. Returns the
    hits."""
    t_b, i_b, h_b = oracle
    want = h_b.clone()
    if act is not None:
        want &= act
    if t_max is not None:
        want &= t_b < t_max
    hit_mism = int((h_k != want).sum())
    both = h_k & want
    dt = torch.where(both, (t_k - t_b).abs(), 0.0)
    rel_all = dt / t_b.clamp_min(1e-3)
    id_mism = int((i_k != i_b)[both].sum())
    over = rel_all > 1e-3
    excused = over & (i_k == i_b) & (dt <= NEAR_SURFACE_ATOL)
    log(f"{label}: hits={int(h_k.sum())} hit mismatches={hit_mism} "
        f"max rel dt={float(rel_all.max()):.2e} id mismatches={id_mism}"
        + (f" near-surface hits over the rel gate={int(over.sum())} "
           f"(max dt {float(dt[over].max()):.2e})" if over.any() else ""))
    bad = (h_k != want) | (over if bench_gate else over & ~excused)
    if bad.any():
        for r in torch.nonzero(bad).flatten()[:8].tolist():
            log(f"  ray {r}: kernel t={float(t_k[r]):.9g} id={int(i_k[r])} hit={bool(h_k[r])}; "
                f"oracle t={float(t_b[r]):.9g} id={int(i_b[r])} hit={bool(want[r])}")
        raise RuntimeError(f"{label}: fails the oracle gate")
    return int(h_k.sum())


def origin_disagreements(t_k, i_k, h_k, oracle, t_max) -> list:
    """Rays on which the kernel and the oracle disagree (hit mask or id),
    as (kernel t, oracle t) pairs: counted, not gated, for rays whose
    origin lies exactly on a surface (see LIFT)."""
    t_b, i_b, h_b = oracle
    want = h_b if t_max is None else h_b & (t_b < t_max)
    differ = (h_k != want) | ((i_k != i_b) & h_k & want)
    return [(float(t_k[r]), float(t_b[r])) for r in torch.nonzero(differ).flatten().tolist()]


def exact(label, kernel_out, plain_out) -> float:
    """Kernel == plain version bit for bit, every output ((t, id) of an
    intersector, (keys,) of first_block_keys); returns max |first output's
    difference|."""
    kernel_out, plain_out = kernel_out[:2], plain_out[:2]
    if not all(torch.equal(k, p) for k, p in zip(kernel_out, plain_out)):
        raise RuntimeError(f"{label}: kernel != plain version")
    k, p = kernel_out[0], plain_out[0]
    return float((k.double() - p.double()).abs().max()) if k.numel() else 0.0


def test_module(name: str):
    """tests/<name>.py, loaded from its file, outside pytest
    (tests/conftest.py imports JAX, which a machine with the card need not
    have)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    threads = torch.get_num_threads()
    spec.loader.exec_module(mod)
    torch.set_num_threads(threads)  # the test modules cap torch's threads
    return mod


def card_test(module: str, name: str, *args) -> None:
    """Run the ``cuda``-marked test ``name`` of tests/<module>.py on the card
    (``test_module``)."""
    getattr(test_module(module), name)(*args)
    log(f"card test tests/{module}.py::{name}{list(args) if args else ''}: passed")


def exact_walk(label, kernel_out, walk_out) -> None:
    """A walk kernel's (t, id, stats) == its plain walk's, bit for bit."""
    if not all(torch.equal(k, w) for k, w in zip(kernel_out, walk_out)):
        raise RuntimeError(f"{label}: kernel != plain walk (t, id or per-ray stats)")


ACTIVITY_CASES = ("all active", "partial active", "partial + t_max", "none active")


def activity(rng, n, device):
    partial = torch.tensor(rng.random(n) > 0.3, device=device)
    window = torch.tensor(rng.random(n).astype(np.float32) * 4.0, device=device)
    none = torch.zeros(n, dtype=torch.bool, device=device)
    return dict(zip(ACTIVITY_CASES, (
        (None, None), (partial, None), (partial, window), (none, None),
    )))


def check_kernel(name, kernel, plain, tables, scene, rng, device, sizes,
                 strict=BENCH_RAYS, variants=(), walk=None) -> dict:
    """Kernel vs plain (exact) and vs brute (bench.py gate) on one scene, at
    each ray count of ``sizes``, in the four activity cases; the gate is
    strict at the counts of ``strict``. Each of ``variants`` (label,
    kernel, plain, tables), another intersector of the same scene, runs on
    the same rays and must equal both its plain version and ``kernel`` bit
    for bit, so the gate holds for it as for ``kernel``. With ``walk`` (the
    kernel's plain walk), ``kernel(..., stats=True)`` must equal it in (t,
    id, per-ray stats). Returns {name and each label: the largest |t_kernel
    - t_plain|}."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    verts = scene.vertices.reshape(-1, 3).cpu().numpy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    worst = dict.fromkeys([name, *(v[0] for v in variants)], 0.0)
    for n in sizes:
        o, d = random_rays(rng, n, lo, hi, device)
        oracle = brute(o, d, scene.vertices, rays_per_call=n)
        for case, (act, t_max) in activity(rng, n, device).items():
            rays = ki.prep_rays(o, d, act, t_max)
            kout = kernel(*tables, rays, 1e-5)
            pout = plain(*tables, rays, 1e-5)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], exact(f"{name} {n} {case}", kout, pout))
            if walk is not None:
                exact_walk(f"{name} {n} {case}", kernel(*tables, rays, 1e-5, stats=True),
                           walk(*tables, rays, 1e-5))
            for label, v_kernel, v_plain, v_tables in variants:
                vout = v_kernel(*v_tables, rays, 1e-5)
                worst[label] = max(worst[label], exact(f"{label} {n} {case}", vout,
                                                       v_plain(*v_tables, rays, 1e-5)))
                exact(f"{label} {n} {case} == {name}", vout, kout)
            t_k, i_k, h_k = ki.unpack(*kout)
            oracle_gate(f"kernel {name} rays={n} {case}", t_k, i_k, h_k, oracle, act,
                        t_max, n in strict)
            if case == "none active" and (h_k.any() or (i_k != -1).any()):
                raise RuntimeError("all-inactive batch reported hits")
    for label in worst:
        log(f"kernel {label}: equal to its plain version"
            + (f" and to {name}" if label != name else "")
            + (" and, with its per-ray stats, to its plain walk"
               if walk is not None and label == name else "")
            + f" at {list(sizes)} rays in the cases {ACTIVITY_CASES}")
    return worst


def time_in_turns(label, kernel_fn, plain_fn, plain_reps=5, plain_warmup=2):
    """plain, kernel, kernel, plain within one call; outputs must be equal.
    Returns (mean kernel ms, mean plain ms, kernel output)."""
    p1, plain_out = cuda_ms(plain_fn, reps=plain_reps, warmup=plain_warmup)
    k1, kernel_out = cuda_ms(kernel_fn)
    k2, _ = cuda_ms(kernel_fn)
    p2, _ = cuda_ms(plain_fn, reps=plain_reps, warmup=plain_warmup)
    exact(f"timed {label}", kernel_out, plain_out)
    log(f"time {label}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, "
        f"outputs equal")
    return (k1 + k2) / 2, (p1 + p2) / 2, kernel_out


def kernels_in_turns(label, fns: dict, reps: int = 20) -> dict:
    """Two kernels on the same inputs, in turns a, b, b, a, outputs equal
    bit for bit. Returns {name: [ms, ms]}."""
    (a, fa), (b, fb) = fns.items()
    times, outs = {}, {}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        ms, outs[name] = cuda_ms(fn, reps=reps)
        times.setdefault(name, []).append(ms)
    exact(f"{label}: {b} == {a}", outs[b], outs[a])
    log(f"time {label}: " + "; ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ms" for n, t in times.items())
        + ", outputs equal")
    return times


BENCH_EYE, BENCH_PITCH = (0.0, 1.2, -1.8), 0.15  # bench.py's camera
GOLDEN_EYE = (0.0, 2.0, -6.0)  # hero_small_32's camera (tests/golden_cases.py)


def main_path_rays(scene, rng, device, nearest=None, width=HERO_W, height=HERO_H,
                  eye=BENCH_EYE, pitch=BENCH_PITCH):
    """Rays of a scene's main path: camera rays (by default the bench
    camera at 640x360), bounce rays from the surfaces they hit (origin on
    the surface, as path_trace makes them) into the normal's hemisphere,
    and NEE rays from there toward a random point of a random light
    triangle with the window nee.sample_direct_light gives them; the hits
    come from ``nearest`` (default ``nearest_hit_blk``). Returns those, and
    the same rays with the surface origins lifted LIFT along the normal."""
    from isaklm_raytracer_tpu_torch.accel import hit_attributes
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.camera.camera import generate_rays
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    n = width * height
    camera = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
    ids = torch.arange(n, device=device)
    cam_u = torch.tensor(rng.random((n, 4)), dtype=torch.float32, device=device)
    o_cam, d_cam = generate_rays(camera, width, height, ids % width, ids // width, cam_u)

    t, idx, hit = (nearest or ki.nearest_hit_blk)(scene.cbvh, o_cam, d_cam)
    attrs = hit_attributes(scene, o_cam, d_cam, idx, hit)
    pos, nrm = attrs.position[hit], attrs.normal[hit]
    m = pos.shape[0]
    rand = torch.tensor(rng.standard_normal((m, 3)), dtype=torch.float32, device=device)
    rand = rand / rand.norm(dim=1, keepdim=True)
    d_bounce = torch.where((rand * nrm).sum(dim=1, keepdim=True) < 0, -rand, rand)

    lights = scene.light_indices[torch.tensor(
        rng.integers(0, scene.num_lights, m), device=device)].long()
    tri = scene.vertices[lights]
    u = torch.tensor(rng.random((m, 2)), dtype=torch.float32, device=device)
    su = torch.sqrt(u[:, 0:1])
    point = (1.0 - su) * tri[:, 0] + u[:, 1:2] * su * tri[:, 1] + (
        1.0 - (1.0 - su) - u[:, 1:2] * su) * tri[:, 2]
    def nee(origin):
        to_light = point - origin
        dist = to_light.norm(dim=1)
        return origin, to_light / dist[:, None], dist * 1.001 + 1e-3

    lifted = pos + LIFT * nrm
    on_surface = {
        "camera": (o_cam, d_cam, None),
        "bounce": (pos, d_bounce, None),
        "nee": nee(pos),
    }
    return on_surface, {
        "camera": on_surface["camera"],
        "bounce": (lifted, d_bounce, None),
        "nee": nee(lifted),
    }


def morton(rays):
    """The rays in the order a ``nearest_hit_*`` call sorts them (Morton)."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    perm = ki.ray_order(rays, True, ki.DEFAULT_PACKET)
    return rays if perm is None else rays[perm].contiguous()


def check_walk_hero(name, walk, plain, walk_plain, nearest, scene, sets, lifted, box_t,
                    group_size, cluster_bytes, group_bytes, wavefront_reps=20):
    """Phases kernel blk, hbm and blk_mxu on the full hero, through
    walk(rays, stats=False), its plain(rays), its plain walk walk_plain(rays,
    stages=False) -> (t, id, stats) and, with ``stages``, the stages' count
    too, and nearest(o, d, t_max=...) (the ``nearest_hit_*``
    wrapper), over the group boxes ``box_t`` of
    ``group_size`` clusters. ``cluster_bytes`` and ``group_bytes`` are the
    table bytes the walk reads for a winning cluster and for its group.
    Returns (worst |dt|, ms, plain_ms, ray count timed, {kind: kernel ms at
    the wavefront}, the bound of the timed call)."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    worst, checked, near_ties = 0.0, 0, []
    for kind, (o, d, t_max) in sets.items():
        for n in BENCH_RAYS:
            rays = ki.prep_rays(o[:n], d[:n], None, None if t_max is None else t_max[:n])
            kout = walk(rays, stats=True)
            worst = max(worst, exact(f"{name} hero {kind} {n}", kout, plain(rays)))
            exact_walk(f"{name} hero {kind} {n}", kout, walk_plain(rays))
        log(f"kernel {name} hero {kind}: (t, id) and per-ray visits and clusters equal to the "
            f"plain walk at {BENCH_RAYS} rays")
        n = min(65536, o.shape[0])
        rays = ki.prep_rays(o[:n], d[:n], None, None if t_max is None else t_max[:n])
        kt, kid = walk(rays)
        pt, pid = plain(rays)
        torch.cuda.synchronize()
        differ = torch.nonzero((kt != pt) | (kid != pid)).flatten()
        checked += n
        if differ.numel():
            dt = (kt[differ] - pt[differ]).abs()
            if (dt > NEAR_TIE_TOL * torch.clamp_min(pt[differ], 1.0)).any():
                raise RuntimeError(f"{name} hero {kind}: a near-tie beyond {NEAR_TIE_TOL}")
            worst = max(worst, float(dt.max()))
            sub = (o[:n][differ], d[:n][differ], None if t_max is None else t_max[:n][differ])
            t_k, i_k, h_k = ki.unpack(kt[differ], kid[differ])
            oracle_gate(f"{name} hero {kind} near-ties", t_k, i_k, h_k,
                        brute(sub[0], sub[1], scene.vertices), None, sub[2], False)
            near_ties.append((kind, int(differ.numel()), float(dt.max())))
        log(f"kernel {name} hero {kind}: {n} rays vs plain, {int((kid != _BIG_ID).sum())} hits, "
            f"{int(differ.numel())} near-ties")
        # the oracle at bench.py's hero count: the gate on lifted origins,
        # the disagreements at exact surface origins counted
        m = 256
        variants = [("", sets[kind])] + ([(" lifted", lifted[kind])] if kind != "camera" else [])
        for label, (o_s, d_s, tm) in variants:
            o_s, d_s = o_s[:m], d_s[:m]
            tm = None if tm is None else tm[:m]
            t_k, i_k, h_k = nearest(o_s, d_s, t_max=tm)
            oracle = brute(o_s, d_s, scene.vertices)
            if label or kind == "camera":
                oracle_gate(f"kernel {name} hero {kind}{label} rays={m}", t_k, i_k, h_k,
                            oracle, None, tm, True)
            else:
                pairs = origin_disagreements(t_k, i_k, h_k, oracle, tm)
                log(f"kernel {name} hero {kind} rays={m}, origins exactly on a surface: "
                    f"{len(pairs)} disagree with the oracle (kernel t, oracle t): {pairs}")
    allowed = int(NEAR_TIE_SHARE * checked)
    total = sum(c for _, c, _ in near_ties)
    log(f"kernel {name} hero: {checked} rays vs plain, near-ties {total} "
        f"(allowed {allowed}: {NEAR_TIE_SHARE:.3%}) {near_ties}")
    if total > allowed:
        raise RuntimeError(f"{name} hero: more near-ties than allowed")

    # timing: kernel and plain in turns at the camera wavefront
    o, d, _ = sets["camera"]
    count = o.shape[0]
    rays = ki.prep_rays(o, d)
    valid = int((box_t[6] > 0).sum())
    ms, plain_ms, kout = time_in_turns(
        f"{name}_intersect hero {count} camera rays x {valid} groups of {group_size} clusters",
        lambda: walk(rays), lambda: plain(rays), plain_reps=2, plain_warmup=1,
    )
    # the bound of that call: the flat stages' count of the cluster tests
    # the walk makes (its plain walk, equal to the kernel in (t, id, stats)
    # on these rays) and the cluster boxes of the groups it visited, one
    # slab test per ray and valid group; the rays, results, group boxes and
    # the table bytes of the winning clusters and their groups
    kstats = walk(rays, stats=True)
    plain_walk, pairs = walk_stage_counts(walk_plain, rays)
    exact_walk(f"{name} hero {count} camera rays", kstats, plain_walk)
    stats = kstats[2].long()
    won = kout[1][kout[1] != _BIG_ID].long() // 128
    boxes = int(stats[:, 0].sum()) * group_size * SLAB_SLOTS + count * valid * SLAB_SLOTS
    nbytes = (count * 40 + box_t.numel() * 4 + torch.unique(won).numel() * cluster_bytes
              + torch.unique(won // group_size).numel() * group_bytes)
    walk_bound = bound(flat_slots(pairs) + boxes, nbytes)
    stage_log(f"{name} hero {count} camera rays", pairs, walk_bound,
              bound(int(stats[:, 1].sum()) * 128 * TRI_HIT_SLOTS + boxes, nbytes))
    wavefront = {}
    for kind, (o, d, t_max) in sets.items():
        rays = ki.prep_rays(o, d, None, t_max)
        k_ms, (_, _, stats) = cuda_ms(lambda: walk(rays, stats=True), reps=wavefront_reps)
        wavefront[kind] = k_ms
        sums = stats.long().sum(dim=0).tolist()
        log(f"time {name}_intersect hero {kind} rays, kernel alone, {rays.shape[0]} rays: "
            f"{k_ms:.3f} ms; per ray: mean group visits {float(stats[:, 0].float().mean()):.3f}, "
            f"mean clusters intersected {float(stats[:, 1].float().mean()):.3f}; sums: group "
            f"visits {sums[0]}, clusters intersected {sums[1]}")
    return worst, ms, plain_ms, count, wavefront, walk_bound


def slab_oracle_first(bbox_t, o, d):
    """The block a numpy slab test says each ray enters first, and whether
    it pierces any (tests/test_cluster_kernel.py's oracle)."""
    bb, o, d = bbox_t.cpu().numpy(), o.cpu().numpy(), d.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = 1.0 / d
        t1 = (bb[0:3].T[None] - o[:, None]) * inv[:, None]
        t2 = (bb[3:6].T[None] - o[:, None]) * inv[:, None]
    near = np.minimum(t1, t2).max(axis=2)
    far = np.maximum(t1, t2).min(axis=2)
    pierce = (near <= far) & (far >= 1e-5) & (bb[6] > 0)[None]
    return np.where(pierce, np.maximum(near, 0.0), np.inf).argmin(axis=1), pierce.any(axis=1)


def check_first_blocks(scene, sets, rng, device):
    """Phase kernel first_blocks. Returns (worst, ms, plain_ms, argsort_ms,
    bound of the timed call)."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    bbox_t = scene.cbvh.blk_bbox_t
    n = bbox_t.shape[1]

    def keys(fn, rays):
        return (fn(bbox_t, rays, 1e-5),)

    for kind, (o, d, _) in sets.items():
        for count in sorted({min(c, o.shape[0]) for c in (*BENCH_RAYS, o.shape[0])}):
            for case, (act, t_max) in activity(rng, count, device).items():
                rays = ki.prep_rays(o[:count], d[:count], act, t_max)
                exact(f"first_blocks hero {kind} {count} {case}",
                      keys(ki.first_block_keys, rays), keys(ki.first_block_keys_plain, rays))
        log(f"kernel first_blocks hero {kind}: keys == plain at {BENCH_RAYS} and "
            f"{o.shape[0]} rays in the cases {ACTIVITY_CASES}")
        m = 256
        lead = ki.first_block_keys(bbox_t, ki.prep_rays(o[:m], d[:m]), 1e-5).cpu().numpy()
        first, pierced = slab_oracle_first(bbox_t, o[:m], d[:m])
        bad = int((lead[pierced] // (8 * (n + 1)) != first[pierced]).sum()
                  + (lead[~pierced] != _BIG_ID - 1).sum())
        log(f"kernel first_blocks hero {kind} rays={m}: {int(pierced.sum())} pierce a block; "
            f"leading factor vs the numpy slab oracle: {bad} disagree")
        if bad:
            raise RuntimeError(f"first_blocks hero {kind}: the key does not lead with the "
                               "block entered first")

    # the bound: one key test per ray and VALID box (the kernel stages only
    # those); the rays, the keys and the table
    valid = int((bbox_t[6] > 0).sum())
    for kind, (o, d, _) in sets.items():
        rays = ki.prep_rays(o, d)
        b = bound(rays.shape[0] * valid * KEY_SLOTS, rays.shape[0] * (32 + 4) + bbox_t.numel() * 4)
        if kind == "camera":
            ms, plain_ms, (k,) = time_in_turns(
                f"first_block_keys hero {rays.shape[0]} camera rays x {valid} valid of {n} "
                "block columns",
                lambda: keys(ki.first_block_keys, rays), lambda: keys(ki.first_block_keys_plain, rays),
            )
            camera_bound = b
            argsort_ms, _ = cuda_ms(lambda: torch.argsort(k, stable=True))
            log(f"time argsort(stable) of {k.numel()} first-block keys: {argsort_ms:.4f} ms")
        k_ms, _ = cuda_ms(lambda: keys(ki.first_block_keys, rays), reps=50)
        log(f"time first_block_keys hero {kind} rays, kernel alone, {rays.shape[0]} rays x "
            f"{valid} valid blocks: {k_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"bound / time {b['bound_ms'] / k_ms:.1%}")
    card_test("test_torch_ordering", "test_cuda_first_block_keys_match_plain_version")
    return 0.0, ms, plain_ms, argsort_ms, camera_bound


ORDERINGS = (False, True, "block")


def order_name(mode) -> str:
    return {False: "caller", True: "morton", "block": "block"}[mode]


def check_ordering(scene, sets, card):
    """Phase ordering: the blk path on each hero wavefront in caller order,
    Morton and block order; results equal to caller order bit for bit; the
    kernel alone on the sorted rays and the whole call, in turns. Returns
    {(kind, order): [(kernel ms, key+argsort ms, whole call ms), ...]}."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    cbvh = scene.cbvh
    tables = (cbvh.blk_bbox_t, cbvh.blk_const)
    times = {}
    for kind, (o, d, t_max) in sets.items():
        want = ki.nearest_hit_blk(cbvh, o, d, t_max=t_max, sort_rays=False)
        for mode in ORDERINGS[1:]:
            got = ki.nearest_hit_blk(cbvh, o, d, t_max=t_max, sort_rays=mode)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"ordering {order_name(mode)} changed the {kind} hits")
        rays = ki.prep_rays(o, d, None, t_max)
        for mode in ORDERINGS + ORDERINGS[::-1]:
            perm = ki.ray_order(rays, mode, ki.BLK_PACKET, cbvh.blk_bbox_t)
            in_order = rays if perm is None else rays[perm].contiguous()
            k_ms, _ = cuda_ms(lambda: ki.blk_intersect(*tables, in_order, 1e-5), reps=5, warmup=1)
            o_ms, _ = cuda_ms(lambda: ki.ray_order(rays, mode, ki.BLK_PACKET, cbvh.blk_bbox_t),
                              reps=5, warmup=1)
            w_ms, _ = cuda_ms(lambda: ki.nearest_hit_blk(cbvh, o, d, t_max=t_max, sort_rays=mode),
                              reps=5, warmup=1)
            times.setdefault((kind, mode), []).append((k_ms, o_ms, w_ms))
        for mode in ORDERINGS:
            runs = times[(kind, mode)]
            log(f"ordering hero {kind} {rays.shape[0]} rays, {order_name(mode)}: blk kernel "
                f"{runs[0][0]:.3f}/{runs[1][0]:.3f} ms; key + argsort {runs[0][1]:.3f}/"
                f"{runs[1][1]:.3f} ms; whole call {runs[0][2]:.3f}/{runs[1][2]:.3f} ms, of which "
                f"outside the kernel {runs[0][2] - runs[0][0]:.3f}/{runs[1][2] - runs[1][0]:.3f} ms; "
                f"(t, idx, hit) == caller order; on {card}")
    return times


def render_calls_by_order(scene, camera, config, card):
    """The blocked kernel alone on the rays of each intersector call of one
    hero sample (extension and NEE rays of every bounce, as the render
    makes them), in caller and Morton order, in turns."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.math import rng as prng

    cbvh = scene.cbvh
    calls = []

    def trace(o, d, active=None, t_max=None):
        calls.append(ki.prep_rays(o, d, active, t_max))
        return ki.nearest_hit_blk(cbvh, o, d, config.t_epsilon, active, t_max, sort_rays=False)

    with torch.no_grad():
        render_sample(scene, camera, prng.sample_key_words(0, 0), config, trace_fn=trace)
    totals = {}
    for i, rays in enumerate(calls):
        kind = f"bounce {i // 2} {'NEE' if i % 2 else 'extension'}"
        times = {}
        for mode in (False, True, True, False):
            perm = ki.ray_order(rays, mode, ki.BLK_PACKET)
            in_order = rays if perm is None else rays[perm].contiguous()
            ms, _ = cuda_ms(lambda: ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, in_order,
                                                     config.t_epsilon), reps=5, warmup=1)
            times.setdefault(mode, []).append(ms)
            totals[mode] = totals.get(mode, 0.0) + ms / 2
        log(f"ordering hero render call {i} ({kind}, {int((rays[:, 6] > 0).sum())} of "
            f"{rays.shape[0]} rays active): blk kernel caller {times[False][0]:.3f}/"
            f"{times[False][1]:.3f} ms, morton {times[True][0]:.3f}/{times[True][1]:.3f} ms")
    log(f"ordering hero render, blk kernel summed over the {len(calls)} calls of a sample: "
        f"caller {totals[False]:.2f} ms, morton {totals[True]:.2f} ms on {card}")


def ordered_step_seconds(scene, camera, config, trace, samples: int = 2) -> float:
    """Seconds of one render_sample (a full step's radiance) with ``trace``,
    after one warm-up sample."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng

    with torch.no_grad():
        render_sample(scene, camera, prng.sample_key_words(0, 0), config, trace_fn=trace)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(samples):
            out = render_sample(scene, camera, prng.sample_key_words(0, 1 + i), config,
                                trace_fn=trace)
        torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("non-finite radiance in the timed render")
    return (time.perf_counter() - t0) / samples


def fwd_and_fwd_bwd(label, scene, camera, config, counts, card, samples: int = 2):
    """bench.py's fwd and fwd+bwd (loss = mean(render_sample), leaf = the
    material albedo): s/sample of each, ``samples`` timed samples after a
    warm-up, rays/s by the bench's count, the peak device memory of
    fwd+bwd, and the launches of each kernel in the fwd+bwd samples.
    Returns those."""
    from isaklm_raytracer_tpu_torch.integrator.render import GraphStep, render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng

    albedo = scene.materials.albedo

    def fwd(i):
        with torch.no_grad():
            return render_sample(scene, camera, prng.sample_key_words(0, i), config).mean()

    def fwd_bwd(i):
        leaf = albedo.detach().clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=leaf))
        loss = render_sample(s, camera, prng.sample_key_words(0, i), config).mean()
        return torch.autograd.grad(loss, leaf)[0]

    fwd_bwd(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, samples + 1):
        fwd(i)
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / samples
    zero_counts(counts)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads = [fwd_bwd(i) for i in range(1, samples + 1)]
    torch.cuda.synchronize()
    bwd_s = (time.perf_counter() - t0) / samples
    peak = torch.cuda.max_memory_allocated() / 2**30
    if GraphStep.recorded or GraphStep.replayed:
        raise RuntimeError(f"grad {label}: a step went through a CUDA graph")
    launches = {k: getattr(counts, f"{k}_kernel") for k in counts.KERNELS}  # all eager
    plain = counts.plain_cuda()
    rays = config.num_pixels * config.max_bounces * 2
    log(f"grad {label} {config.width}x{config.height}x{config.max_bounces} ray_chunk "
        f"{config.ray_chunk}: fwd {fwd_s:.4f} s/sample ({rays / fwd_s / 1e6:.3f} M rays/s), "
        f"fwd+bwd {bwd_s:.4f} s/sample ({rays / bwd_s / 1e6:.3f} M rays/s), ratio "
        f"{bwd_s / fwd_s:.2f}; peak memory {peak:.3f} GiB; launches in {samples} fwd+bwd samples "
        f"{launches}, plain calls on CUDA {plain}; on {card}")
    for g in grads:
        if not torch.isfinite(g).all() or not g.abs().max() > 0:
            raise RuntimeError(f"grad {label}: the albedo gradient is not finite and nonzero")
    if plain:
        raise RuntimeError(f"grad {label}: a plain version ran on CUDA")
    # the shading kernels forward, the backward kernel backward: once each a bounce
    passes = -(-config.num_pixels // (config.ray_chunk or config.num_pixels))
    want = samples * passes * config.max_bounces
    shading = {k: launches[k] for k in GRAD_SHADE_KERNELS}
    if any(n != want for n in shading.values()):
        raise RuntimeError(f"grad {label}: the shading launched {shading}; {want} of each "
                           "expected (one a bounce of each pass)")
    return {"fwd_s": fwd_s, "fwd_bwd_s": bwd_s, "peak_gib": peak, "launches": launches}


def profile_fwd_bwd(label, kernel, scene, camera, config, counts, card) -> dict:
    """One fwd+bwd sample (bench.py's, leaf = the albedo) under
    torch.profiler with the kernels the card ran held to the wrappers'
    launches (``device_launches``, ``check_only`` with grad); then the
    forward (autograd recording) and, apart, the backward of another
    sample: the device time of each, the intersector's share of the
    forward, the backward kernel's records (one a bounce of each pass) and
    device time, the backward's top kernels. Returns the backward kernel's
    records and ms."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng

    def sample(i):
        leaf = scene.materials.albedo.detach().clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=leaf))
        return leaf, render_sample(s, camera, prng.sample_key_words(0, i), config).mean()

    with device_launches(counts) as ran:
        leaf, loss = sample(8)
        torch.autograd.grad(loss, leaf)
        torch.cuda.synchronize()
    check_only(counts, kernel, f"fwd+bwd of the {label} under torch.profiler", ran, grad=True)
    with cuda_profile() as pf:
        leaf, loss = sample(9)
        torch.cuda.synchronize()
    with cuda_profile() as pb:
        torch.autograd.grad(loss, leaf)
        torch.cuda.synchronize()
    f, b = device_records(pf), device_records(pb)
    f_ns, b_ns = sum(d for _, _, d in f), sum(d for _, _, d in b)
    walk_ns = sum(d for name, _, d in f if kernel_symbol(kernel) in name)
    bwd = [d for name, _, d in b if kernel_symbol("shade_backward") in name]
    binned = [d for name, _, d in b if kernel_symbol("shade_bin") in name]
    passes = -(-config.num_pixels // (config.ray_chunk or config.num_pixels))
    top = collections.Counter()
    for name, _, d in b:
        top[name] += d
    log(f"profile {label} fwd+bwd ray_chunk {config.ray_chunk}: fwd device time "
        f"{f_ns / 1e6:.2f} ms in {len(f)} records ({kernel} {walk_ns / 1e6:.2f} ms = "
        f"{walk_ns / max(f_ns, 1):.1%}), bwd device time {b_ns / 1e6:.2f} ms in {len(b)} records; "
        f"bounce_backward {len(bwd)} records, {sum(bwd) / 1e6:.4f} ms "
        f"({sum(bwd) / max(b_ns, 1):.1%} of the backward), bounce_bin {len(binned)} records, "
        f"{sum(binned) / 1e6:.4f} ms ({sum(binned) / max(b_ns, 1):.1%}); on {card}")
    for name, ns in top.most_common(6):
        log(f"  {label} bwd top kernel {ns / 1e6:.3f} ms ({ns / max(b_ns, 1):.1%}): {name[:110]}")
    if len(bwd) != passes * config.max_bounces or len(binned) != len(bwd):
        raise RuntimeError(f"profile {label} fwd+bwd: {len(bwd)} backward kernels and "
                           f"{len(binned)} binnings, {passes * config.max_bounces} expected")
    return {"records": len(bwd), "ms": sum(bwd) / 1e6, "bwd_ms": b_ns / 1e6, "fwd_ms": f_ns / 1e6}


def floor_view():
    """TestGradVsFDCamera's scene (tests/test_estimator.py): one large
    diffuse floor lit by a panel outside every camera ray's frustum."""
    from isaklm_raytracer_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emittance=(6.0, 6.0, 6.0), ior=1.0)
    floor = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7, ior=1.0)
    s = 60.0
    b.add_quad((-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s), floor)
    b.add_quad((-2, 6, -9), (2, 6, -9), (2, 6, -5), (-2, 6, -5), light)
    return b.build()


@contextlib.contextmanager
def fd_steps():
    """The graph steps ``diff.fd.central_difference`` makes in the block, in
    a list (its ``GraphStep`` replaced by a subclass that appends each);
    the list is emptied on exit, so the steps' graphs and pools die then."""
    from isaklm_raytracer_tpu_torch.diff import fd

    made = []
    base = fd.GraphStep

    class Kept(base):
        def __init__(self, device):
            super().__init__(device)
            made.append(self)

    fd.GraphStep = Kept
    try:
        yield made
    finally:
        fd.GraphStep = base
        made.clear()


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Two float32 arrays equal bit for bit."""
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@functools.cache
def eager_fd():
    """The harness with no graph, ``f`` called eagerly twice a coordinate
    (tests/test_torch_fd.py's ``eager_central_difference``)."""
    return test_module("test_torch_fd").eager_central_difference


def grad_vs_fd(label, kernel, f, x, h, rtol, atol, counts, backward) -> dict:
    """``check_grad_vs_fd(f, x)`` on the card with its tolerances: the
    autodiff side eager, through the backward kernel (``backward``
    launches of it and of the binning); the finite differences through one
    CUDA graph of ``f``: its step called 2n times, replayed 2n - 1 (the
    capturing call replays too). Then the finite differences again under
    torch.profiler (``device_launches``: the kernels the card ran are the
    wrappers' eager launches plus the replays'), where ``kernel``, the
    sampler and both shading kernels ran 2n times the capture's launches
    (one evaluation's, so every replay ran them), neither backward kernel
    ran and no plain version ran on CUDA; and once more as the eager loop,
    whose quotient both replayed ones equal bit for bit. Returns the
    autodiff and FD gradients, the eager loop's quotient and its seconds."""
    from isaklm_raytracer_tpu_torch.diff import central_difference, check_grad_vs_fd
    from isaklm_raytracer_tpu_torch.integrator.render import GraphStep

    evaluations = 2 * x.numel()
    zero_counts(counts)
    with fd_steps() as steps:
        auto, fd = check_grad_vs_fd(f, x, h=h, rtol=rtol, atol=atol)
        (step,) = steps
        calls, replays = step.calls, step.replays
    n = {k: getattr(counts, f"{k}_kernel") for k in (kernel, *GRAD_SHADE_KERNELS)}
    log(f"grad vs FD on the card, {label} {tuple(auto.shape)}: max |auto - fd| "
        f"{np.abs(auto - fd).max():.3e} (rtol {rtol:g}, atol {atol:g}); auto "
        f"{np.round(auto, 5).reshape(-1).tolist()} fd {np.round(fd, 5).reshape(-1).tolist()}; "
        f"the FD step called {calls} times, replayed {replays}; launches {n} (the wrappers': "
        f"the autodiff side, the FD side's eager call and capture), plain calls on CUDA "
        f"{counts.plain_cuda()}")
    if not np.abs(auto).max() > 0:
        raise RuntimeError(f"grad vs FD {label}: the gradient is zero")
    if (not n[kernel] or counts.plain_cuda() or n["shade"] != n["shade_finish"]
            or n["shade_backward"] != backward or n["shade_bin"] != backward):
        raise RuntimeError(f"grad vs FD {label} did not go through the kernels alone, or its "
                           f"autodiff side not through the backward kernel {backward} times")
    if (calls, replays) != (evaluations, evaluations - 1):
        raise RuntimeError(f"grad vs FD {label}: the FD step was called {calls} times and "
                           f"replayed {replays}; {evaluations} and {evaluations - 1} expected")

    t0 = time.perf_counter()
    with device_launches(counts) as ran:
        with fd_steps() as steps:
            replayed = central_difference(f, x, h)
            (step,) = steps
            one = {k: step.launches.get(f"{k}_kernel", 0) for k in (kernel, *FD_KERNELS)}
        torch.cuda.synchronize()
    ran_fd = {k: ran[k] for k in (kernel, *FD_KERNELS, "shade_bin", "shade_backward")}
    busy_ns = sum(d for _, _, d in ran.records)
    log(f"grad vs FD {label}, the finite differences under torch.profiler: the card ran "
        f"{ran_fd} (= the eager launches plus GraphStep.replayed); one evaluation launches {one}, "
        f"{evaluations} evaluations; {len(ran.records)} CUDA records, "
        f"{len(ran.records) / evaluations:.0f} and {busy_ns / evaluations / 1e6:.3f} ms of device "
        f"time an evaluation; {time.perf_counter() - t0:.1f} s with the profiler's processing; "
        f"plain calls on CUDA {counts.plain_cuda()}")
    if (any(not one[k] or ran[k] != evaluations * one[k] for k in one)
            or ran["shade_bin"] or ran["shade_backward"] or counts.plain_cuda()):
        raise RuntimeError(f"grad vs FD {label}: the finite differences' replays did not each "
                           "run the intersector, the sampler and both shading kernels, or a "
                           "backward kernel or a plain version ran")

    zero_counts(counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = eager_fd()(f, x, h)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if GraphStep.recorded or GraphStep.replayed:
        raise RuntimeError(f"grad vs FD {label}: the eager loop went through a CUDA graph")
    equal = {"check_grad_vs_fd": same_bits(fd, eager), "profiled": same_bits(replayed, eager)}
    log(f"grad vs FD {label}: the replayed quotients equal the eager loop's bit for bit: {equal}")
    if not all(equal.values()):
        raise RuntimeError(f"grad vs FD {label}: a replayed quotient differs from the eager "
                           f"loop's: {equal}; max |diff| {np.abs(fd - eager).max():.3e}")
    return {"auto": auto, "fd": fd, "eager": eager, "eager_s": eager_s}


def fd_turns(label, f, x, h, card, reference, eager_s, pairs: int = 3) -> None:
    """The finite differences of ``f`` at ``x`` timed in turns (eager,
    graph, graph, eager, ...: ``pairs`` pairs), the first the eager loop
    just run (``eager_s`` seconds; its quotient ``reference``): the eager
    loop and ``central_difference`` (one CUDA graph: eager call, capture,
    replays), wall seconds and seconds an evaluation, the capture's
    seconds, instantiation and pool; each quotient equal to ``reference``
    bit for bit. Then the autodiff side (one eager fwd+bwd), ``pairs``
    times."""
    from isaklm_raytracer_tpu_torch.diff import central_difference

    evaluations = 2 * x.numel()
    order = [("eager", "graph")[(i + i // 2) % 2] for i in range(2 * pairs)]
    log(f"FD turns {label}, eager (the loop above): {eager_s:.4f} s, "
        f"{eager_s / evaluations:.5f} s an evaluation ({evaluations}); on {card}")
    for kind in order[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "eager":
            q = eager_fd()(f, x, h)
            extra = ""
        else:
            with fd_steps() as steps:
                q = central_difference(f, x, h)
                (step,) = steps
                extra = (f"; capture {step.capture_s:.4f} s, instantiate "
                         f"{step.instantiate_s:.4f} s, pool {step.pool_bytes / 2**20:.1f} MiB")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"FD turns {label}, {kind}: {seconds:.4f} s, {seconds / evaluations:.5f} s an "
            f"evaluation ({evaluations}){extra}; on {card}")
        if not same_bits(q, reference):
            raise RuntimeError(f"FD turns {label}: the {kind} quotient differs from the first "
                               "eager loop's")
    for _ in range(pairs):
        leaf = x.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.autograd.grad(f(leaf), leaf)
        torch.cuda.synchronize()
        log(f"FD turns {label}, the autodiff side (eager fwd+bwd): "
            f"{time.perf_counter() - t0:.4f} s; on {card}")


# BASELINE.json's config 0: the Cornell box, diffuse only, 64x64 @ 16 spp
CONFIG0_SIZE, CONFIG0_SPP = 64, 16


def grad_checks_on_card(device, counts, card):
    """Grad-vs-FD on the card through the kernels (``grad_vs_fd``):
    TestGradVsFD's Cornell albedo at 16x16 and at BASELINE config 0 (64x64
    @ 16 spp, the mean of 16 one-pass samples), and TestGradVsFDCamera's
    pose, with their tolerances; config 0's finite differences timed in
    turns, eager against one CUDA graph (``fd_turns``); then the card's
    autodiff gradient against the port's on the CPU."""
    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng
    from isaklm_raytracer_tpu_torch.scene import procedural

    kw = (0, 11)  # the JAX package's PRNGKey(11)
    no_rr = RenderConfig(width=16, height=16, max_bounces=4, rr_start_bounce=4)
    config0 = RenderConfig(width=CONFIG0_SIZE, height=CONFIG0_SIZE, max_bounces=4,
                           rr_start_bounce=4, ray_chunk=0)
    keys0 = [prng.sample_key_words(11, i) for i in range(CONFIG0_SPP)]

    def cornell_loss(scene, camera):
        def loss(albedo):
            s = scene.replace(materials=scene.materials.replace(albedo=albedo))
            return render_sample(s, camera, kw, no_rr).mean()
        return loss

    def config0_loss(scene, camera):
        def loss(albedo):
            s = scene.replace(materials=scene.materials.replace(albedo=albedo))
            return torch.stack([render_sample(s, camera, k, config0).mean() for k in keys0]).mean()
        return loss

    cornell = procedural.cornell_box(include_blockers=False)
    scene = prepare_scene(cornell, device)
    camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device=device)
    albedo = scene.materials.albedo
    grad_vs_fd("Cornell albedo 16x16", "flat", cornell_loss(scene, camera), albedo, 2e-3,
               0.05, 2e-4, counts, no_rr.max_bounces)
    with device_launches(counts) as ran:
        leaf = albedo.clone().requires_grad_(True)
        torch.autograd.grad(cornell_loss(scene, camera)(leaf), leaf)
        torch.cuda.synchronize()
    check_only(counts, "flat", "grad vs FD's autodiff side (Cornell albedo)", ran, grad=True)

    out = grad_vs_fd(f"BASELINE config 0, Cornell albedo {CONFIG0_SIZE}x{CONFIG0_SIZE} @ "
                     f"{CONFIG0_SPP} spp", "flat", config0_loss(scene, camera), albedo, 2e-3,
                     0.05, 2e-4, counts, CONFIG0_SPP * config0.max_bounces)
    fd_turns("BASELINE config 0", config0_loss(scene, camera), albedo, 2e-3, card, out["eager"],
             out["eager_s"])

    floor = prepare_scene(floor_view(), device)
    config = RenderConfig(width=12, height=12, max_bounces=1, rr_start_bounce=1,
                          lobe_ratio_grad=False)
    cam = Camera.create((0.0, 3.0, 0.0), yaw=0.0, pitch=0.9, fov=0.9, device=device)
    fkw = (0, 23)
    for label, leaf, make in (
        ("position", cam.position, lambda x: cam.replace(position=x)),
        ("yaw/pitch", torch.stack([cam.yaw, cam.pitch]),
         lambda x: cam.replace(yaw=x[0], pitch=x[1])),
    ):
        grad_vs_fd(f"floor camera {label}", "flat",
                   lambda x: render_sample(floor, make(x), fkw, config).mean(), leaf, 1e-3,
                   0.05, 5e-4, counts, config.max_bounces)

    cpu_scene = prepare_scene(cornell, "cpu")
    grads = []
    for s, c in ((scene, camera), (cpu_scene, camera.to("cpu"))):
        leaf = s.materials.albedo.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(cornell_loss(s, c)(leaf), leaf)[0].cpu())
    diff = (grads[0] - grads[1]).abs()
    log(f"grad card (kernels) vs CPU (plain versions), Cornell albedo: max |diff| "
        f"{float(diff.max()):.3e}, max rel "
        f"{float((diff / grads[1].abs().clamp_min(1e-12)).max()):.3e} (rtol "
        f"{CARD_VS_CPU_RTOL:g}, atol {CARD_VS_CPU_ATOL:g})")
    torch.testing.assert_close(grads[0], grads[1], rtol=CARD_VS_CPU_RTOL, atol=CARD_VS_CPU_ATOL)
    card_test("test_torch_fd", "test_cuda_central_difference_replays_equal_the_eager_loop")
    zero_counts(counts)


def sample_seconds(render, scene, camera, config, samples: int = 2) -> float:
    """Wall seconds per full step after two warm-up steps (``render``'s step
    runs eagerly at its first call and captures its CUDA graph at the
    second, so the timed steps are replays)."""
    gb = render(scene, camera, config, num_samples=2, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gb = render(scene, camera, config, num_samples=samples, seed=0, gbuffer=gb,
                sample_offset=2)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / samples
    if not torch.isfinite(gb.frame).all():
        raise RuntimeError("non-finite radiance in the timed render")
    return seconds


INTERSECTORS = ("flat", "flat_mxu", "queue", "hbm", "blk", "blk_mxu", "kd", "brute")


@contextlib.contextmanager
def intersector_env(name):
    """ISAKLM_INTERSECTOR=name inside the block (None: the auto rule)."""
    if name is not None:
        os.environ["ISAKLM_INTERSECTOR"] = name
    try:
        yield
    finally:
        os.environ.pop("ISAKLM_INTERSECTOR", None)


def zero_counts(counts) -> None:
    """Every launch count to 0: the wrappers' and GraphStep's tallies of the
    launches captures recorded and replays issued."""
    from isaklm_raytracer_tpu_torch.integrator.render import GraphStep

    counts.reset()
    GraphStep.reset_tallies()


def kernel_symbol(name: str) -> str:
    """A part of the name torch.profiler gives kernel ``name``'s CUDA
    kernel: flat and flat_mxu are the template ``flat_kernel`` over their
    layouts (csrc/flat_walk.cuh), every other is ``<name>_intersect_kernel``,
    ``first_block_keys_kernel``, the sampler's ``threefry_uniforms_kernel``,
    the KD walk's table kernel ``tri_consts_kernel`` or the shading kernels
    ``shade_bounce_kernel`` and ``finish_bounce_kernel`` and their backward,
    ``bounce_bin_kernel`` and ``bounce_backward_kernel`` (the template over
    where its material sums go)."""
    return {"flat": "TileLayout", "flat_mxu": "PairLayout",
            "first_blocks": "first_block_keys_kernel",
            "sampler": "threefry_uniforms_kernel",
            "tri_consts": "tri_consts_kernel",
            "shade": "shade_bounce_kernel",
            "shade_finish": "finish_bounce_kernel",
            "shade_bin": "bounce_bin_kernel",
            "shade_backward": "bounce_backward_kernel"}.get(name, f"{name}_intersect_kernel")


def cuda_profile():
    """torch.profiler over a block with idle pads and filler kernels ahead
    of it (``tools/profiling.py``, which says why); logs the fillers it
    dropped and raises if it kept none."""
    from isaklm_raytracer_tpu_torch.tools import profiling

    return profiling.cuda_profile(log)


def device_records(prof):
    """The CUDA records of a ``cuda_profile`` window but its fillers:
    [(name, start ns, duration ns)]."""
    from isaklm_raytracer_tpu_torch.tools import profiling

    return profiling.device_records(prof)


class Ran(dict):
    """``device_launches``'s measurement: the kernels the card ran by name,
    and ``records``, the profile's CUDA records (``device_records``)."""

    records = ()


@contextlib.contextmanager
def device_launches(counts):
    """The kernels the card ran in the block, measured: the counts are
    zeroed, the block runs under torch.profiler, whose CUPTI records hold
    every kernel the card ran, those of a CUDA graph's replays among them;
    on exit the yielded dict holds the records of each kernel of
    ``counts.KERNELS`` (by ``kernel_symbol``), and its ``records`` the
    profile's CUDA records. Raises unless each equals
    what the wrappers launched eagerly plus what the replays issued
    (``COUNTS - GraphStep.recorded + GraphStep.replayed``): so a replay ran
    the kernels its capture recorded."""
    from isaklm_raytracer_tpu_torch.integrator.render import GraphStep

    zero_counts(counts)
    ran = Ran()
    with cuda_profile() as prof:
        yield ran
    ran.records = device_records(prof)
    names = collections.Counter(name for name, _, _ in ran.records)
    for k in counts.KERNELS:
        ran[k] = sum(n for name, n in names.items() if kernel_symbol(k) in name)
    attr = {k: f"{k}_kernel" for k in counts.KERNELS}
    want = {k: getattr(counts, attr[k]) - GraphStep.recorded[attr[k]]
            + GraphStep.replayed[attr[k]] for k in counts.KERNELS}
    if ran != want:
        raise RuntimeError(f"the kernels the card ran {ran} differ from the eager launches "
                           f"plus the replays' {want}")


# (label, then the kernels the card ran and their wrappers' launches of the
# sampler, shade_bounce and finish_bounce) of every path that check_only held
SAMPLER_RUNS = []
SHADE_KERNELS = ("shade", "shade_finish")
# the shading of a path that differentiates: both halves forward, the
# backward's two kernels (the binning and the reverse) backward
GRAD_SHADE_KERNELS = ("shade", "shade_finish", "shade_bin", "shade_backward")
# what every finite-difference evaluation runs besides its intersector
FD_KERNELS = ("sampler", "shade", "shade_finish")


def check_only(counts, kernel: str, label: str, ran=None, grad: bool = False):
    """The launches of ``kernel`` since the counts were zeroed: (the
    kernels the card ran, the wrappers' count). ``ran`` is
    ``device_launches``'s measurement; without it the run must have
    replayed no graph, and the wrappers' counts are what ran. Raises unless
    ``kernel`` ran, no other intersector did and no plain version ran on
    CUDA; then unless the sampler kernel ran too (every render draws its
    variates there; its plain version is among the plain calls counted),
    and the two shading kernels as often as each other (one launch each a
    bounce; their launches go with the sampler's to SAMPLER_RUNS). With
    ``grad`` (a path that differentiates, each differentiated bounce once)
    the backward kernel must have run as often as the shading kernels,
    without it never."""
    from isaklm_raytracer_tpu_torch.integrator.render import GraphStep

    if ran is None:
        if GraphStep.recorded or GraphStep.replayed:
            raise RuntimeError(f"{label}: the run went through CUDA graphs unmeasured")
        ran = {k: getattr(counts, f"{k}_kernel") for k in counts.KERNELS}
    wrapped = getattr(counts, f"{kernel}_kernel")
    others = {k: ran[k] for k in INTERSECTORS if k != kernel}
    plain = counts.plain_cuda()
    log(f"main path {label}: {kernel}_kernel ran {ran[kernel]} times on the card ({wrapped} "
        f"launched by its wrapper, eagerly or into a graph), other intersectors {others}, "
        f"plain versions' calls on CUDA (the sampler and the shading among them) {plain}")
    if ran[kernel] == 0 or any(others.values()) or plain:
        raise RuntimeError(f"the {label} path did not go through its kernel alone")
    log(f"main path {label}: the sampler kernel ran {ran['sampler']} times on the card "
        f"({counts.sampler_kernel} launched by its wrapper), the plain sampler on CUDA "
        f"{counts.sampler_plain_cuda} times")
    if ran["sampler"] == 0 or counts.sampler_plain_cuda:
        raise RuntimeError(f"the {label} path did not draw its variates through the sampler "
                           "kernel alone")
    shading = {k: (ran[k], getattr(counts, f"{k}_kernel"), getattr(counts, f"{k}_plain_cuda"))
               for k in GRAD_SHADE_KERNELS}
    log(f"main path {label}: shading (kernels the card ran, wrapper launches, plain calls on "
        f"CUDA) shade_bounce {shading['shade']}, finish_bounce {shading['shade_finish']}, "
        f"bounce_bin {shading['shade_bin']}, bounce_backward {shading['shade_backward']}")
    if shading["shade"][0] == 0 or shading["shade"][:2] != shading["shade_finish"][:2]:
        raise RuntimeError(f"the {label} path did not shade through the two kernels, one "
                           "launch each a bounce")
    backward = shading["shade_backward"][:2]
    if shading["shade_bin"][:2] != backward:
        raise RuntimeError(f"the {label} path ran the backward's binning and its reverse "
                           "unequally often")
    if grad and backward != shading["shade"][:2]:
        raise RuntimeError(f"the {label} path differentiates but did not run the backward "
                           "kernel once each a differentiated bounce")
    if not grad and any(backward):
        raise RuntimeError(f"the {label} path does not differentiate but ran the backward "
                           "kernel")
    SAMPLER_RUNS.append((label, ran["sampler"], counts.sampler_kernel,
                         *(x for k in SHADE_KERNELS for x in shading[k][:2])))
    return ran[kernel], wrapped


def trace_share(records):
    """(CUDA records, kernel seconds, device span seconds) of one trace: the
    span runs from its first CUDA record's start to its last one's end, so
    kernel seconds / span is the device's busy share within the trace."""
    start = min(t for _, t, _ in records)
    end = max(t + d for _, t, d in records)
    return len(records), sum(d for _, _, d in records) / 1e9, (end - start) / 1e9


def shade_records(label, records, config) -> None:
    """The shading kernels' records in a profile of one full step: each of
    the two must have run once a bounce of each of the step's passes;
    logs their count and device time."""
    passes = -(-config.num_pixels // (config.ray_chunk or config.num_pixels))
    want = passes * config.max_bounces
    got = {k: [d for name, _, d in records if kernel_symbol(k) in name] for k in SHADE_KERNELS}
    busy = sum(d for _, _, d in records)
    log(f"  {label}: shade_bounce {len(got['shade'])} records, {sum(got['shade']) / 1e6:.4f} ms; "
        f"finish_bounce {len(got['shade_finish'])}, {sum(got['shade_finish']) / 1e6:.4f} ms "
        f"({(sum(got['shade']) + sum(got['shade_finish'])) / busy:.2%} of the kernel time); "
        f"{want} of each expected ({passes} passes x {config.max_bounces} bounces)")
    if any(len(v) != want for v in got.values()):
        raise RuntimeError(f"{label}: the shading kernels did not run once each a bounce")


def records_by_name(label, records, config, top: int = 12) -> None:
    """The records of one full step in one pass by kernel name, the most
    frequent first, per bounce."""
    names = collections.Counter(name for name, _, _ in records)
    time_of = collections.Counter()
    for name, _, d in records:
        time_of[name] += d
    log(f"  {label}: {len(records)} records, {len(records) / config.max_bounces:.1f} a bounce, "
        f"{len(names)} kernel names; the most frequent (records a bounce, ms a step): " + "; ".join(
            f"{n / config.max_bounces:g} x {name[:70]} ({time_of[name] / 1e6:.3f} ms)"
            for name, n in names.most_common(top)))


def profile_sample(render, scene, camera, config, kernel_name):
    """torch.profiler over one full step: (CUDA records, their summed device
    seconds, the device span of the trace, launches of ``kernel_name``, its
    device seconds)."""
    with cuda_profile() as prof:
        render(scene, camera, config, num_samples=1, seed=0)
    records = device_records(prof)
    if not records:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    mine = [d for name, _, d in records if kernel_name in name]
    if not mine:
        raise RuntimeError(f"no kernel named like {kernel_name} in the profile")
    n, busy_s, span_s = trace_share(records)
    drawn = [d for name, _, d in records if kernel_symbol("sampler") in name]
    log(f"  the profiled sample's sampler kernels: {len(drawn)} launches, "
        f"{sum(drawn) / 1e6:.4f} ms = {sum(drawn) / 1e9 / busy_s:.2%} of its {busy_s * 1e3:.2f} ms "
        f"of device kernel time ({n} CUDA records)")
    shade_records("the profiled sample's shading", records, config)
    if not config.ray_chunk:
        records_by_name("the profiled sample's kernels", records, config)
    return n, busy_s, span_s, len(mine), sum(mine) / 1e9


def perf(name, render, scene, camera, width, height, bounces, counts, kernel_name, card):
    """Seconds per full step at ray_chunk 16384 and 0, in turns (one timed
    step at 16384, two in one pass, each after a warm-up), then one
    profiled step at each: its kernels, their device time and the device's
    busy share within the trace."""
    from isaklm_raytracer_tpu_torch.config import RenderConfig

    chunk_default = RenderConfig().ray_chunk
    per_chunk = {}
    for chunk in (chunk_default, 0, 0, chunk_default):
        config = RenderConfig(width=width, height=height, max_bounces=bounces, ray_chunk=chunk)
        s = sample_seconds(render, scene, camera, config, samples=1 if chunk else 2)
        per_chunk.setdefault(chunk, []).append(s)
        rays = config.num_pixels * config.max_bounces * 2
        log(f"{name} {width}x{height}x{bounces} ray_chunk {chunk}: {s:.4f} s/sample, "
            f"{rays / s / 1e6:.3f} M rays/s (pixels x bounces x 2) on {card}")
    for chunk in (chunk_default, 0):
        config = RenderConfig(width=width, height=height, max_bounces=bounces, ray_chunk=chunk)
        n, busy_s, span_s, mine_n, mine_s = profile_sample(render, scene, camera, config,
                                                           kernel_name)
        log(f"profile {name} ray_chunk {chunk}, one replayed sample: {n} CUDA records, device "
            f"kernel time {busy_s:.4f} s in a device span of {span_s:.4f} s (busy "
            f"{busy_s / span_s:.1%}); {kernel_name} {mine_n} launches, {mine_s * 1e3:.2f} ms = "
            f"{mine_s / busy_s:.1%} of device kernel time, on {card}")
    return per_chunk


def perf_overrides(label, scene, camera, width, height, bounces, names, counts, card):
    """Seconds per full step in one pass under ISAKLM_INTERSECTOR = each of
    ``names`` (the default first), in turns, then one profiled step each:
    the intersector's share of device kernel time. Returns {name: [s, s]}."""
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render

    config = RenderConfig(width=width, height=height, max_bounces=bounces, ray_chunk=0)
    per = {}
    for name in names + names[::-1]:
        with intersector_env(name):
            s = sample_seconds(render, scene, camera, config)
        per.setdefault(name, []).append(s)
    rays = config.num_pixels * config.max_bounces * 2
    log(f"perf overrides {label} {width}x{height}x{bounces} ray_chunk 0, s/sample in turns: "
        + "; ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ({rays / min(t) / 1e6:.3f} M rays/s)"
                    for n, t in per.items()) + f" on {card}")
    for name in names:
        with intersector_env(name):
            n, busy_s, span_s, mine_n, mine_s = profile_sample(render, scene, camera, config,
                                                               kernel_symbol(name))
        log(f"profile {label} under {name} ray_chunk 0, one replayed sample: {n} CUDA records, "
            f"device kernel time {busy_s:.4f} s in a device span of {span_s:.4f} s (busy "
            f"{busy_s / span_s:.1%}); {name}_intersect {mine_n} launches, "
            f"{mine_s * 1e3:.2f} ms = {mine_s / busy_s:.1%} of device kernel time, on {card}")
    return per


def both_clocks(fn, reps: int = 20):
    """Mean milliseconds of fn() by CUDA events and by the host clock (both
    around the same ``reps`` calls, ending in a synchronize), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return start.elapsed_time(stop) / reps, wall, out


def fixed_cost(scene, counts, card):
    """The counterpart of scripts/fixed_cost_probe.py on the hero: 65,536
    rays from beyond the scene's box heading away from it (miss everything,
    as the probe's), so every blocked call is its fixed cost. Per call and
    per 128-ray block, by CUDA events and by the host clock: the whole
    ``nearest_hit_blk`` in Morton and in caller order, ``prep_rays`` +
    ``ray_order`` alone, the null kernel in the walk's launch shape with
    the blocked kernel's shared memory (its warps' key lists) and without.
    Returns the null kernel's
    results (max_abs_err, ms, plain_ms, bound, shape) and launches."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    cbvh = scene.cbvh
    verts = scene.vertices.reshape(-1, 3)
    lo, hi = verts.min(dim=0).values, verts.max(dim=0).values
    n = 65536
    rng = np.random.default_rng(1)
    o = (hi + (hi - lo)).expand(n, 3).contiguous()
    d_np = rng.standard_normal((n, 3)).astype(np.float32) * 0.05 + np.float32([0, 1, 0])
    d = torch.tensor(d_np / np.linalg.norm(d_np, axis=1, keepdims=True), device=o.device)
    if ki.nearest_hit_blk(cbvh, o, d)[2].any():
        raise RuntimeError("fixed cost: a probe ray hit the scene")
    rays = ki.prep_rays(o, d)
    shared = cbvh.blk_const.shape[0]  # the walk's lists for its blocks
    shared_bytes = ki.walk_shared_bytes(shared)
    err = exact("null kernel vs plain", ki.null_intersect(rays, shared),
                ki.null_intersect_plain(rays))
    zero_counts(counts)  # the probe's own launches from here on
    blocks = n // ki.BLK_PACKET
    results = {}
    for label, fn in (
        ("nearest_hit_blk, Morton order", lambda: ki.nearest_hit_blk(cbvh, o, d)),
        ("nearest_hit_blk, caller order", lambda: ki.nearest_hit_blk(cbvh, o, d, sort_rays=False)),
        ("prep_rays + ray_order (Morton)",
         lambda: ki.ray_order(ki.prep_rays(o, d), True, ki.BLK_PACKET)),
        (f"null kernel, {shared_bytes} B shared (the blocked kernel's)",
         lambda: ki.null_intersect(rays, shared)),
        ("null kernel, no shared memory", lambda: ki.null_intersect(rays, 0)),
        ("null plain version (two torch.zeros)", lambda: ki.null_intersect_plain(rays)),
    ):
        ev, wall, _ = both_clocks(fn)
        results[label] = ev
        log(f"fixed cost hero {n} rays ({blocks} blocks of {ki.BLK_PACKET}), {label}: "
            f"{ev:.4f} ms a call by CUDA events, {wall:.4f} ms by the host clock; "
            f"{ev / blocks * 1e3:.3f} / {wall / blocks * 1e3:.3f} us a block, on {card}")
    launches = counts.null_kernel
    if launches == 0:
        raise RuntimeError("fixed cost: the null kernel did not launch")
    return {"max_abs_err": err,
            "ms": results[f"null kernel, {shared_bytes} B shared (the blocked kernel's)"],
            "plain_ms": results["null plain version (two torch.zeros)"],
            **bound(0, n * 8),  # its outputs
            "shape": f"{n} rays, {shared_bytes} B of shared memory (hero)"}, launches


def read_png(path):
    """Decode the filter-0 RGB PNGs that io/png.save_png writes."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise RuntimeError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


def cli_path(name, counts, runs, kernel, cli, override=None):
    """One main path through the CLI, under ISAKLM_INTERSECTOR=override
    (None: the auto rule): the kernels the card ran, measured from counts
    zeroed just before (``device_launches``, ``check_only``), and the CUDA
    graphs each run captured. Returns (the kernel's launches on the card,
    its wrapper's count) and {label: PNG image}."""
    from isaklm_raytracer_tpu_torch.integrator.render import GraphStep

    images = {}
    with device_launches(counts) as ran:
        for label, argv in runs:
            out = os.path.join(OUT_DIR, f"chip_smoke_{label}.png")
            shape = (int(argv[argv.index("--height") + 1]),
                     int(argv[argv.index("--width") + 1]), 3)
            captures = GraphStep.captures
            t0 = time.perf_counter()
            with intersector_env(override):
                if cli.main([*argv, "--out", out]) != 0:
                    raise RuntimeError(f"CLI {label} failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            img = images[label] = read_png(out)
            log(f"cli {label}: {wall:.2f} s wall under torch.profiler "
                f"({GraphStep.captures - captures} CUDA graphs captured), png {img.shape}, "
                f"mean {img.mean():.2f}")
            if img.shape != shape or img.mean() < 1.0:
                raise RuntimeError(f"CLI {label}: bad image {img.shape} mean {img.mean()}")
    return check_only(counts, kernel, name, ran), images


def same_image(label, got, want) -> None:
    """An override's image equals the default intersector's bit for bit."""
    if got.shape != want.shape or not np.array_equal(got, want):
        raise RuntimeError(f"{label}: the image differs from the default intersector's "
                           f"(shapes {got.shape}, {want.shape})")
    log(f"{label}: image equal to the default intersector's bit for bit")


# scripts/hero_obj_roundtrip.py's aggregate gate of a scene loaded from files
# against its procedural original: mean |d| on [0, 1] and the share of
# pixels with a channel off by more than AGG_PIXEL.
AGG_MEAN, AGG_PIXEL, AGG_SHARE = 2e-3, 0.05, 0.01


def aggregate_gate(label, got, want) -> None:
    a, b = got.astype(np.float64) / 255.0, want.astype(np.float64) / 255.0
    if a.shape != b.shape:
        raise RuntimeError(f"{label}: image shapes {a.shape} and {b.shape}")
    dev = np.abs(a - b)
    share = float((dev.max(axis=-1) > AGG_PIXEL).mean())
    log(f"{label}: against the procedural scene's image mean |d| {dev.mean():.3e} "
        f"(gate {AGG_MEAN:g}), max {dev.max():.3e}, pixels off by more than {AGG_PIXEL:g} "
        f"{share:.3%} (gate {AGG_SHARE:.0%})")
    if dev.mean() >= AGG_MEAN or share >= AGG_SHARE:
        raise RuntimeError(f"{label}: outside the aggregate gate")


def run_cli(label, cli, argv, out):
    """``cli.main(argv + --out out)``; its stderr lines are printed and
    returned with the PNG image."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(buf):
            rc = cli.main([*argv, "--out", out])
        torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  cli {label}: {line}")
    if rc != 0:
        raise RuntimeError(f"CLI {label} exited {rc}")
    img = read_png(out)
    log(f"cli {label}: {time.perf_counter() - t0:.2f} s wall, png {img.shape}, "
        f"mean {img.mean():.2f}")
    return img, buf.getvalue()


def with_scene(argv, scene):
    """``argv`` with ``--scene`` set to ``scene``."""
    argv = list(argv)
    argv[argv.index("--scene") + 1] = scene
    return argv


def export_scene(tmp, name, scene, names, texture_paths=None, uvs=False):
    """Write ``scene`` as <tmp>/<name>.obj + .mat; returns the paths and
    the export's seconds."""
    from isaklm_raytracer_tpu_torch.scene.export import material_rows, save_mat, save_obj

    obj, mat = os.path.join(tmp, f"{name}.obj"), os.path.join(tmp, f"{name}.mat")
    t0 = time.perf_counter()
    save_mat(mat, names, material_rows(scene.materials, texture_paths))
    save_obj(obj, scene.vertices, scene.normals, scene.mat_id, names,
             uvs=scene.uvs if uvs else None)
    return obj, mat, time.perf_counter() - t0


def write_manifest(tmp, name, entries) -> str:
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(entries, f)
    return path


def phase_assets(cli, counts, demo_argv, hero_argv, demo_png, hero_png, tmp) -> None:
    """Phase assets (the module docstring, 14)."""
    from isaklm_raytracer_tpu_torch import native
    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.integrator.render import intersector_name
    from isaklm_raytracer_tpu_torch.io.checkpoint import load_checkpoint
    from isaklm_raytracer_tpu_torch.io.png import save_png
    from isaklm_raytracer_tpu_torch.scene import procedural
    from isaklm_raytracer_tpu_torch.scene.export import load_offset, material_rows, save_mat
    from isaklm_raytracer_tpu_torch.scene.obj import Transformation, create_scene_from_files

    eye3 = np.eye(3, dtype=np.float32)
    # (a) the full hero through OBJ + .mat and the CLI
    t0 = time.perf_counter()
    hero = procedural.hero_scene()
    gen_s = time.perf_counter() - t0
    obj, mat, export_s = export_scene(tmp, "hero", hero, ["white", "gold", "glass", "light"])
    size = os.path.getsize(obj)
    t0 = time.perf_counter()
    native._load("objload")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = native.obj_parse_native(obj)
    parse_s = time.perf_counter() - t0
    del parsed
    offset = load_offset(hero.vertices)
    meshes = [(obj, mat, Transformation(offset, eye3), False)]
    t0 = time.perf_counter()
    loaded = create_scene_from_files(meshes, prepare=False)
    load_s = time.perf_counter() - t0
    dv = float(np.abs(loaded.vertices - hero.vertices).max())
    dn = float(np.abs(loaded.normals - hero.normals).max())
    t0 = time.perf_counter()
    prepared = prepare_scene(loaded, torch.device("cuda", 0))
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    picked = intersector_name(prepared.cbvh)
    log(f"assets hero: {hero.num_triangles} triangles (procedural build {gen_s:.2f} s); "
        f"export (save_mat + save_obj) {export_s:.2f} s, OBJ {size} bytes "
        f"({size / 2**20:.1f} MiB); g++ build of the parser {build_s:.2f} s; native parse "
        f"{parse_s:.2f} s; assembly {load_s - parse_s:.2f} s (create_scene_from_files "
        f"{load_s:.2f} s less the parse); prepare_scene onto the card {prepare_s:.2f} s; "
        f"max deviation from the procedural arrays: vertices {dv:.2e}, normals {dn:.2e}; "
        f"intersector {picked}")
    if loaded.num_triangles != hero.num_triangles or dv >= 1e-5 or dn >= 1e-5:
        raise RuntimeError("assets hero: the OBJ round trip changed the triangle soup")
    if picked != "blk":
        raise RuntimeError(f"assets hero: the rule picked {picked}, not blk")
    del loaded, prepared
    manifest = write_manifest(tmp, "hero", [{"obj": obj, "mat": mat, "offset": offset.tolist()}])
    parses = []
    real_parse = native.obj_parse_native

    def counted_parse(path):
        parses.append(path)
        return real_parse(path)

    native.obj_parse_native = counted_parse
    zero_counts(counts)
    try:
        img, err = run_cli("hero_obj", cli, with_scene(hero_argv, manifest),
                           os.path.join(tmp, "hero_obj.png"))
    finally:
        native.obj_parse_native = real_parse
    if parses != [obj] or f"triangle count: {hero.num_triangles}" not in err:
        raise RuntimeError(f"assets hero: the native parser ran on {parses}, not on {obj}")
    log(f"assets hero: the CLI parsed {obj} with the native parser")
    check_only(counts, "blk", "hero through OBJ + .mat")
    aggregate_gate("assets hero_obj", img, hero_png)
    del hero

    # (b) the textured demo through OBJ + .mat + PNG
    demo = procedural.material_demo_scene()
    png = os.path.join(tmp, "checker.png")
    if " " in png:
        raise RuntimeError(f"{png}: a .mat texture path must not hold spaces")
    save_png(png, procedural.checker_texture(), flip_vertical=False)
    textured = {i: png for i, t in enumerate(np.asarray(demo.materials.tex_id)) if t >= 0}
    obj, mat, _ = export_scene(tmp, "demo", demo, ["floor", "white", "gold", "glass", "light"],
                               textured, uvs=True)
    offset = load_offset(demo.vertices)
    loaded = create_scene_from_files([(obj, mat, Transformation(offset, eye3), False)],
                                     prepare=False)
    for k in ("buffer", "offset", "width", "height"):
        if not np.array_equal(getattr(loaded.textures, k), getattr(demo.textures, k)):
            raise RuntimeError(f"assets demo: atlas {k} differs from the procedural one")
    log(f"assets demo: atlas of {loaded.textures.buffer.shape[0]} texels from {png} equal to "
        "the procedural checker's")
    manifest = write_manifest(tmp, "demo", [{"obj": obj, "mat": mat, "offset": offset.tolist()}])
    # in one pass: every ray's result is its own, so the image is the one
    # the main path drew in chunks of 16384 rays
    with device_launches(counts) as ran:
        img, _ = run_cli("demo_obj", cli, [*with_scene(demo_argv, manifest), "--ray-chunk", "0"],
                         os.path.join(tmp, "demo_obj.png"))
    check_only(counts, "flat", "demo through OBJ + .mat + PNG", ran)
    aggregate_gate("assets demo_obj", img, demo_png)
    card = Path(tmp) / "card_test"
    card.mkdir()
    card_test("test_torch_assets", "test_cuda_loaded_demo_through_flat", card)

    # (c) two meshes, one .mat: the 20k hero and the Cornell box
    h20, box = procedural.hero_scene(20_000), procedural.cornell_box(glossy=True)
    h_names = [f"hero_{n}" for n in ("white", "gold", "glass", "light")]
    c_names = [f"cornell_{n}" for n in ("white", "red", "green", "light")]
    h_obj, _, _ = export_scene(tmp, "hero20k", h20, h_names)
    c_obj, _, _ = export_scene(tmp, "cornell", box, c_names)
    mat = os.path.join(tmp, "shared.mat")
    save_mat(mat, h_names + c_names, material_rows(h20.materials) + material_rows(box.materials))
    manifest = write_manifest(tmp, "two_meshes", [
        {"obj": h_obj, "mat": mat, "offset": load_offset(h20.vertices).tolist(), "yaw": 0.15,
         "scale": 0.9},
        {"obj": c_obj, "mat": mat, "offset": [0.4, 1.5, 0.5], "yaw": 0.5, "scale": 1.5},
    ])
    ck = os.path.join(tmp, "two_meshes.npz")
    with device_launches(counts) as ran:
        img, err = run_cli("two_meshes", cli, [
            "--scene", manifest, "--width", "512", "--height", "512", "--max-bounces", "8",
            "--min-samples", "1", "--max-samples", "2", "--ray-chunk", "0",
            "--camera", "0", "2", "-6", "0", "0", "--checkpoint", ck,
        ], os.path.join(tmp, "two_meshes.png"))
    check_only(counts, "queue", "two-mesh manifest", ran)
    want = h20.num_triangles + box.num_triangles
    gb = load_checkpoint(ck)[0]
    finite = bool(torch.isfinite(gb.frame).all())
    log(f"assets two_meshes: triangle count {want} = {h20.num_triangles} + {box.num_triangles}: "
        f"{f'triangle count: {want}' in err}; G-buffer finite: {finite}")
    if f"triangle count: {want}\n" not in err or not finite or img.mean() <= 1.0:
        raise RuntimeError("assets two_meshes: wrong triangle count, non-finite or dark image")


def phase_resume(cli, counts, demo_argv, tmp) -> None:
    """Phase resume (the module docstring, 15)."""
    from isaklm_raytracer_tpu_torch.integrator import render as integ_render
    from isaklm_raytracer_tpu_torch.io.checkpoint import load_checkpoint

    argv = [*demo_argv, "--ray-chunk", "0"]
    straight = {}
    for mode, flags in (("no_adaptive", ["--no-adaptive"]), ("adaptive", [])):
        cks = [os.path.join(tmp, f"resume_{mode}_{k}.npz") for k in ("straight", "split")]
        pngs = {}
        pngs["straight"], _ = run_cli(f"resume {mode} straight", cli, [
            *argv, *flags, "--max-samples", "8", "--checkpoint", cks[0]],
            os.path.join(tmp, f"resume_{mode}_straight.png"))
        run_cli(f"resume {mode} first 4", cli, [
            *argv, *flags, "--max-samples", "4", "--checkpoint", cks[1]],
            os.path.join(tmp, f"resume_{mode}_half.png"))
        pngs["split"], err = run_cli(f"resume {mode} resumed to 8", cli, [
            *argv, *flags, "--max-samples", "8", "--checkpoint", cks[1]],
            os.path.join(tmp, f"resume_{mode}_split.png"))
        if "resumed at sample 4" not in err:
            raise RuntimeError(f"resume {mode}: the second call did not resume")
        gbs = [load_checkpoint(ck)[0] for ck in cks]
        counts_min = int(gbs[0].count.min())
        same = all(torch.equal(getattr(gbs[0], k), getattr(gbs[1], k))
                   for k in ("frame", "sq_luminance", "count"))
        log(f"resume {mode}: PNG {'equal' if np.array_equal(*pngs.values()) else 'DIFFERENT'}, "
            f"G-buffer {'equal' if same else 'DIFFERENT'} bit for bit; counts "
            f"{counts_min}-{int(gbs[0].count.max())}")
        if not same or not np.array_equal(*pngs.values()):
            raise RuntimeError(f"resume {mode}: the resumed render differs from the straight one")
        if mode == "adaptive" and counts_min == int(gbs[0].count.max()):
            log("resume adaptive: the gate stopped no pixel early (counts all equal)")
        straight[mode] = pngs["straight"]

    real_render = integ_render.render
    calls = {"n": 0}

    def flaky_render(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the second batch dies mid-flight
            raise RuntimeError("injected device fault")
        return real_render(*a, **kw)

    integ_render.render = flaky_render
    try:
        img, err = run_cli("resume retry", cli, [
            *argv, "--no-adaptive", "--max-samples", "8", "--checkpoint-every", "2",
            "--checkpoint", os.path.join(tmp, "resume_retry.npz")],
            os.path.join(tmp, "resume_retry.png"))
    finally:
        integ_render.render = real_render
    log(f"resume retry: {calls['n']} render calls (4 batches + the failed one); PNG "
        f"{'equal' if np.array_equal(img, straight['no_adaptive']) else 'DIFFERENT'} to the "
        "straight run's")
    if calls["n"] != 5 or "injected device fault" not in err or not np.array_equal(
            img, straight["no_adaptive"]):
        raise RuntimeError("resume retry: the CLI did not recover to the straight run's image")


def phase_interactive(demo, counts, device) -> None:
    """Phase interactive (the module docstring, 16)."""
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.cli.preview import run_preview
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render, resolve_image
    from isaklm_raytracer_tpu_torch.viewer import InteractiveSession

    config = RenderConfig(width=512, height=512, max_bounces=8, ray_chunk=0)
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
    t0 = time.perf_counter()
    session = InteractiveSession(demo, camera, config, adaptive=False)
    session.step()
    session.step()
    moved = session.handle_input(["w"], 0.1)
    session.step()
    session.step()
    image = session.image()
    steps_s = time.perf_counter() - t0
    gb = render(demo, session.camera, config, num_samples=2, adaptive=False)
    want = resolve_image(gb, config).cpu().numpy()
    pos = session.camera.position.tolist()
    log(f"interactive: 2 steps, w for 0.1 s (moved {moved}, camera now {pos}), 2 steps in "
        f"{steps_s:.2f} s; sample_count {session.sample_count}; image "
        f"{'equal' if np.array_equal(image, want) else 'DIFFERENT'} to render of 2 samples "
        "from the moved camera bit for bit")
    if not moved or session.sample_count != 2 or not np.array_equal(image, want):
        raise RuntimeError("interactive: the session after the move differs from render")
    out = io.StringIO()
    t0 = time.perf_counter()
    final = run_preview(session, 4, out=out, interactive=False)
    text = out.getvalue()
    log(f"interactive: run_preview to 4 samples in {time.perf_counter() - t0:.2f} s, "
        f"{len(text)} characters of ANSI frames, image {final.shape} finite "
        f"{bool(np.isfinite(final).all())}")
    if session.sample_count != 4 or "\u2580" not in text or "sample 4/4" not in text \
            or not np.isfinite(final).all():
        raise RuntimeError("interactive: the headless preview did not draw its frames")


# The sharded phase's paths: label, kernel, (width, height, bounces), adaptive
# samples, camera eye, pitch (the main path's presets, in one pass)
SHARDED_PATHS = (
    ("demo", "flat", (512, 512, 8), 4, BENCH_EYE, BENCH_PITCH),
    ("hero20k", "queue", (512, 512, 8), 4, GOLDEN_EYE, 0.0),
    ("hero", "blk", (HERO_W, HERO_H, HERO_BOUNCES), 2, BENCH_EYE, BENCH_PITCH),
)
SHARDED_KEY = (0, 13)  # the train step's key words (the JAX package's PRNGKey(13))


def sharded_scene(label, device, hero_triangles):
    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.scene import procedural

    build = {"demo": procedural.material_demo_scene,
             "hero20k": lambda: procedural.hero_scene(20_000),
             "hero": lambda: procedural.hero_scene(hero_triangles)}[label]
    return prepare_scene(build(), device)


def gbuffer_arrays(gb) -> dict:
    return {k: getattr(gb, k).cpu().numpy() for k in ("frame", "sq_luminance", "count")}


def digest(arrays: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def collective_ms(fn, sync, reps: int = 10) -> float:
    """ms a call of the collective ``fn`` (every rank calls it in step),
    after one warm-up, by the host clock around a synchronise."""
    import torch.distributed as dist

    dist.barrier()
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def hand_built_grads(scene, camera, config, params, target, key, streams: int):
    """The single-process objective of ``sharded_value_and_grad_fn``: the
    mean over ``streams`` streams of the image MSE (the loss) and of the
    dual-buffer estimator in which stream s takes the detached residual of
    stream (s - 1) mod n (the gradient; the MSE's own at one stream), with
    grads of the six material fields and the pose."""
    from isaklm_raytracer_tpu_torch.dist import sharding
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng

    floats = [getattr(params, f).detach().clone().requires_grad_()
              for f in sharding.FLOAT_FIELDS]
    pose = [x.detach().clone().requires_grad_()
            for x in (camera.position, camera.yaw, camera.pitch)]
    s = scene.replace(materials=params.replace(**dict(zip(sharding.FLOAT_FIELDS, floats))))
    cam = camera.replace(position=pose[0], yaw=pose[1], pitch=pose[2])
    rad = [render_sample(s, cam, rng.fold_in(key, i), config) for i in range(streams)]
    norm = 3.0 * config.num_pixels
    loss = sum(torch.sum((r - target) ** 2) for r in rad) / norm / streams
    pseudo = sum(2.0 * torch.sum((rad[(i - 1) % streams] - target).detach() * rad[i])
                 for i in range(streams)) / norm / streams
    grads = torch.autograd.grad(pseudo, floats + pose, allow_unused=True)
    names = sharding.FLOAT_FIELDS + sharding.POSE_FIELDS
    return float(loss.detach()), {
        name: (torch.zeros_like(x) if g is None else g).cpu().numpy()
        for name, g, x in zip(names, grads, floats + pose)}


def graph_stats(step) -> dict:
    """A graph step's capture record (``graph_record``'s numbers)."""
    return {"capture_s": step.capture_s, "instantiate_s": step.instantiate_s,
            "pool_bytes": step.pool_bytes, "replays": step.replays}


def vg_calls(vg, params, camera, target, key, calls: int = 3) -> dict:
    """``calls`` calls of a ``sharded_value_and_grad_fn`` on the same inputs
    (on a fresh key: its eager call, its capture, then replays), each
    timed by the host clock around a synchronise: their seconds, losses and
    grads (numpy), and the gradient graph step's capture record."""
    seconds, losses, grads = [], [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = vg(params, camera, target, key)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        grads.append({k: v.cpu().numpy() for k, v in g.items()})
    return {"seconds": seconds, "losses": losses, "grads": grads,
            "graph": graph_stats(vg.graphs.last)}


def replays_against_eager(label, out: dict) -> float:
    """Raises unless every replayed call of ``vg_calls`` has its eager
    call's loss bit for bit and its grads within CARD_VS_CPU_RTOL and
    CARD_VS_CPU_ATOL (the backward's float64 atomics add in another order
    each call); returns the largest grad difference."""
    worst = 0.0
    for loss, grads in zip(out["losses"][1:], out["grads"][1:]):
        if loss != out["losses"][0]:
            raise RuntimeError(f"{label}: a replayed loss {loss!r} against the eager call's "
                               f"{out['losses'][0]!r}")
        for f, g in out["grads"][0].items():
            worst = max(worst, float(np.abs(grads[f] - g).max()))
            if not np.allclose(grads[f], g, rtol=CARD_VS_CPU_RTOL, atol=CARD_VS_CPU_ATOL):
                raise RuntimeError(f"{label}: replayed {f} grads {grads[f]} against the eager "
                                   f"call's {g}")
    return worst


def sharded_rank(rank: int, world: int, spec: dict) -> dict:
    """One of the ranks of phase sharded (the module docstring, 17), all on
    the parent's card over gloo: each path through render_sharded, the
    tail mode, value_and_grad and the train step on a (1, 2) mesh, the
    collectives' times and the CLI under this group. A rank's steps replay
    CUDA graphs, so every run is counted by the profiler
    (``device_launches``)."""
    global CARD
    CARD = spec["card"]
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.cli import render as cli
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.dist import sharding
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    device = torch.device(spec["device"])
    sync = torch.cuda.synchronize
    counts = ki.COUNTS

    @contextlib.contextmanager
    def launched(kernel, label, grad=False):
        """The block's kernels the card ran, eager and replayed, held by
        ``check_only``; yields a dict that holds the launches after it."""
        got = {}
        with device_launches(counts) as ran:
            yield got
        got["launches"] = check_only(counts, kernel, f"rank {rank} {label}", ran, grad=grad)[0]

    tile = sharding.make_render_mesh(world, 1, device=device)
    streams = sharding.make_render_mesh(1, world, device=device)
    out = {"paths": {}}
    for label, kernel, (w, h, b), samples, eye, pitch in spec["paths"]:
        scene = sharded_scene(label, device, spec["hero_triangles"])
        camera = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
        config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
        dist.barrier()
        with launched(kernel, f"sharded {label}") as got:
            t0 = time.perf_counter()
            gb = sharding.render_sharded(scene, camera, config, samples, tile, adaptive=True)
            sync()
            wall = time.perf_counter() - t0
        arrays = gbuffer_arrays(sharding.unshard_gbuffer(gb, config, tile))
        # full steps: the eager call and the capture, then two timed replays,
        # every rank at once
        first = []
        for offset in (samples, samples + 1):
            dist.barrier()
            t0 = time.perf_counter()
            sharding.render_sharded(scene, camera, config, 1, tile, sample_offset=offset)
            sync()
            first.append(time.perf_counter() - t0)
        dist.barrier()
        t0 = time.perf_counter()
        sharding.render_sharded(scene, camera, config, 2, tile, sample_offset=samples + 2)
        sync()
        out["paths"][label] = {
            "launches": got["launches"], "wall": wall, "eager_s": first[0],
            "capture_call_s": first[1], "s_per_sample": (time.perf_counter() - t0) / 2,
            "graph": graph_stats(sharding._rank_steps(config).step.graphs.last),
            "digest": digest(arrays), "arrays": arrays if rank == 0 else None}
        if label == "demo":
            demo, demo_camera, demo_config = scene, camera, config
        del scene, gb

    # the tail mode at the demo's width from a 95%-converged G-buffer
    n = demo_config.num_pixels
    gb0 = GBuffer(torch.zeros((n, 3), device=device), torch.zeros(n, device=device),
                  torch.from_numpy(spec["tail_counts"]).to(device))
    calls = {"n": 0}
    real_tail = sharding._sharded_tail_step

    def counting_tail(*a, **kw):
        calls["n"] += 1
        return real_tail(*a, **kw)

    sharding._sharded_tail_step = counting_tail
    try:
        with launched("flat", "sharded tail") as got:
            gb = sharding.render_sharded(demo, demo_camera, demo_config, 4, tile, seed=7,
                                         adaptive=True, gbuffer=gb0)
    finally:
        sharding._sharded_tail_step = real_tail
    arrays = gbuffer_arrays(sharding.unshard_gbuffer(gb, demo_config, tile))
    tail = sharding._rank_steps(demo_config).tail.graphs.last
    out["tail"] = {"calls": calls["n"], "launches": got["launches"], "replays": tail.replays,
                   "digest": digest(arrays), "arrays": arrays if rank == 0 else None}

    # value_and_grad and the train step on a (1, world) mesh: every rank
    # renders the whole image; its eager call, its capture, a replay
    target = torch.from_numpy(spec["target"]).to(device)
    params = demo.materials.replace(albedo=demo.materials.albedo * 0.6)
    vg = sharding.sharded_value_and_grad_fn(demo, demo_config, streams, decorrelate=True)
    dist.barrier()
    with launched("flat", "sharded value_and_grad", grad=True) as got:
        out["vg"] = vg_calls(vg, params, demo_camera, target, SHARDED_KEY)
    out["vg"]["launches"] = got["launches"]
    out["vg"]["worst"] = replays_against_eager(f"rank {rank} sharded value_and_grad", out["vg"])
    step = sharding.sharded_train_step_fn(demo, demo_config, streams)
    p, losses = params, []
    dist.barrier()
    with launched("flat", "sharded train step", grad=True) as got:
        t0 = time.perf_counter()
        for i in range(3):
            p, loss = step(p, demo_camera, target, rng.fold_in(SHARDED_KEY, 10 + i))
            losses.append(float(loss))
        sync()
        seconds = (time.perf_counter() - t0) / 3
    out["train"] = {"s_per_step": seconds, "losses": losses, "launches": got["launches"],
                    "replays": step.graphs.last.replays,
                    "finite": all(bool(torch.isfinite(getattr(p, f)).all())
                                  for f in sharding.FLOAT_FIELDS)}

    # the collectives alone
    shard = sharding.shard_gbuffer(GBuffer.create(n, device), demo_config, tile)
    flat = torch.zeros(1 + sum(g.size for g in out["vg"]["grads"][0].values()),
                       device=device)
    out["all_gather_ms"] = collective_ms(
        lambda: sharding.unshard_gbuffer(shard, demo_config, tile), sync)
    out["all_reduce_ms"] = collective_ms(lambda: dist.all_reduce(flat), sync)
    out["grad_floats"] = flat.numel() - 1

    # the CLI under this group, checkpointed
    png = os.path.join(spec["tmp"], f"sharded_cli_r{rank}.png")
    with launched("flat", "sharded CLI") as got:
        rc = cli.main([*spec["cli_argv"], "--checkpoint",
                       os.path.join(spec["tmp"], "sharded_cli.npz"), "--out", png])
    with open(png, "rb") as f:
        out["cli"] = {"rc": rc, "png": f.read(), "launches": got["launches"]}
    return out


def phase_sharded(cli, counts, scenes, device, tmp, paths=SHARDED_PATHS,
                  hero_triangles=2_000_000) -> None:
    """Phase sharded (the module docstring, 17)."""
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.dist import sharding
    from isaklm_raytracer_tpu_torch.dist.launch import free_port, launch
    from isaklm_raytracer_tpu_torch.integrator.render import render, render_sample
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    sync = torch.cuda.synchronize
    launched = functools.partial(check_only, counts)

    # single-process references on this card
    refs = {}
    for label, kernel, (w, h, b), samples, eye, pitch in paths:
        camera = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
        config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
        with device_launches(counts) as ran:
            gb = render(scenes[label], camera, config, samples, adaptive=True)
        launched(kernel, f"single-process render of {label}", ran)
        # the full step's eager call and its capture, then two timed replays
        render(scenes[label], camera, config, 2, sample_offset=samples)
        sync()
        t0 = time.perf_counter()
        render(scenes[label], camera, config, 2, sample_offset=samples + 2)
        sync()
        refs[label] = (gbuffer_arrays(gb), (time.perf_counter() - t0) / 2)
        if label == "demo":
            demo_camera, demo_config = camera, config
    demo = scenes["demo"]
    n = demo_config.num_pixels
    conv = np.random.default_rng(0).random(n) < 0.95
    tail_counts = np.where(conv, demo_config.max_samples, 0).astype(np.int32)
    gb0 = GBuffer(torch.zeros((n, 3), device=device), torch.zeros(n, device=device),
                  torch.from_numpy(tail_counts).to(device))
    tail_ref = gbuffer_arrays(render(demo, demo_camera, demo_config, 4, seed=7, adaptive=True,
                                     gbuffer=gb0))
    with torch.no_grad():
        target = render_sample(demo, demo_camera, rng.fold_in(SHARDED_KEY, 0), demo_config)
    params = demo.materials.replace(albedo=demo.materials.albedo * 0.6)
    vg_ref = hand_built_grads(demo, demo_camera, demo_config, params, target, SHARDED_KEY, 2)
    cli_argv = ["--scene", "demo", "--width", str(demo_config.width), "--height",
                str(demo_config.height), "--max-bounces", str(demo_config.max_bounces),
                "--min-samples", "4", "--max-samples", "8", "--checkpoint-every", "4",
                "--ray-chunk", "0", "--camera", "0", "1.2", "-1.8", "0", "0.15"]
    run_cli("sharded reference, one process", cli, [
        *cli_argv, "--checkpoint", os.path.join(tmp, "sharded_ref.npz")],
        os.path.join(tmp, "sharded_ref.png"))
    with open(os.path.join(tmp, "sharded_ref.png"), "rb") as f:
        cli_ref = f.read()

    spec = {"device": str(device), "card": CARD, "tmp": tmp, "paths": paths,
            "hero_triangles": hero_triangles, "tail_counts": tail_counts,
            "target": target.cpu().numpy(), "cli_argv": cli_argv}
    t0 = time.perf_counter()
    ranks = launch(sharded_rank, 2, spec, device=str(device), timeout=900)
    log(f"sharded: two ranks on {device} over gloo in {time.perf_counter() - t0:.1f} s "
        "wall (spawn, scene builds and every check below)")

    def same(label, got_rank0, want):
        err = max(float(np.abs(got_rank0[k].astype(np.float64) - want[k]).max())
                  for k in want)
        equal = all(np.array_equal(got_rank0[k], want[k]) for k in want)
        if not equal:
            raise RuntimeError(f"sharded {label}: differs from one process (max |d| {err:.3e})")
        return err

    def graph_line(g) -> str:
        return (f"capture {g['capture_s']:.3f} s, instantiation {g['instantiate_s']:.3f} s, "
                f"graph pool {g['pool_bytes'] / 2**20:.1f} MiB, {g['replays']} replays")

    for label, kernel, (w, h, b), samples, *_ in paths:
        want, one_s = refs[label]
        r = [out["paths"][label] for out in ranks]
        same(label, r[0]["arrays"], want)
        if r[1]["digest"] != r[0]["digest"]:
            raise RuntimeError(f"sharded {label}: the ranks gathered different G-buffers")
        if min(x["graph"]["replays"] for x in r) < 3:
            raise RuntimeError(f"sharded {label}: a rank's full step did not replay its graph")
        log(f"sharded {label} {w}x{h}x{b} ray_chunk 0, (2, 1) mesh, {samples} adaptive "
            f"samples: G-buffer bit-equal to one process's render on both ranks; {kernel} "
            f"kernels the card ran {r[0]['launches']}/{r[1]['launches']} (rank 0/1), "
            f"{r[0]['wall']:.3f}/{r[1]['wall']:.3f} s with the first calls; a full step's "
            f"eager call {r[0]['eager_s']:.4f}/{r[1]['eager_s']:.4f} s, its capturing call "
            f"{r[0]['capture_call_s']:.4f}/{r[1]['capture_call_s']:.4f} s, replays "
            f"{r[0]['s_per_sample']:.4f}/{r[1]['s_per_sample']:.4f} s/sample a rank, both "
            f"ranks at once, against {one_s:.4f} for one process (replays); rank 0's graph: "
            f"{graph_line(r[0]['graph'])}")
    t = [out["tail"] for out in ranks]
    same("tail", t[0]["arrays"], tail_ref)
    log(f"sharded tail mode, demo from a 95%-converged G-buffer, (2, 1) mesh: "
        f"{t[0]['calls']}/{t[1]['calls']} tail steps (rank 0/1), the last bucket's graph "
        f"replayed {t[0]['replays']}/{t[1]['replays']} times, flat kernels the card ran "
        f"{t[0]['launches']}/{t[1]['launches']}, bit-equal to one process")
    if min(x["calls"] for x in t) == 0 or t[1]["digest"] != t[0]["digest"]:
        raise RuntimeError("sharded tail mode did not engage on every rank, or ranks differ")
    if min(x["replays"] for x in t) == 0:
        raise RuntimeError("sharded tail mode: a rank's tail step did not replay its graph")

    v = [out["vg"] for out in ranks]
    for k, grads in enumerate(v[0]["grads"]):
        for f, g in grads.items():
            if not np.array_equal(v[1]["grads"][k][f], g):
                raise RuntimeError(f"sharded value_and_grad: the {f} grads of call {k} differ "
                                   "across ranks")
    loss_ref, grads_ref = vg_ref
    worst = 0.0
    for k, (loss, grads) in enumerate(zip(v[0]["losses"], v[0]["grads"])):
        for f, g in grads_ref.items():
            worst = max(worst, float(np.abs(grads[f] - g).max()))
            if not np.allclose(grads[f], g, rtol=CARD_VS_CPU_RTOL, atol=CARD_VS_CPU_ATOL):
                raise RuntimeError(f"sharded value_and_grad call {k} {f}: {grads[f]} against "
                                   f"one process's {g}")
        if not np.isclose(loss, loss_ref, rtol=CARD_VS_CPU_RTOL, atol=0.0):
            raise RuntimeError(f"sharded loss {loss} against one process's {loss_ref}")
    if v[0]["graph"]["replays"] != 2 or min(x["replays"] for x in [out["train"] for out in
                                                                   ranks]) != 5:
        raise RuntimeError("sharded value_and_grad: the calls after the eager one did not "
                           "replay its graphs, or the train step did not replay them")
    tr = [out["train"] for out in ranks]
    log(f"sharded value_and_grad, demo, (1, 2) mesh, decorrelated, three calls (eager, "
        f"capture, replay): losses {v[0]['losses']} (one process {loss_ref:.6f}), bit-equal "
        f"to the eager call's, grads within rtol {CARD_VS_CPU_RTOL:g} atol "
        f"{CARD_VS_CPU_ATOL:g} of it (max |d| {max(x['worst'] for x in v):.3e}) and of one "
        f"process's hand-built estimator (max |d| {worst:.3e}), bit-identical on both "
        f"ranks; seconds a call rank 0 {[round(x, 4) for x in v[0]['seconds']]}, rank 1 "
        f"{[round(x, 4) for x in v[1]['seconds']]}; rank 0's graphs: "
        f"{graph_line(v[0]['graph'])}; flat kernels the card ran "
        f"{v[0]['launches']}/{v[1]['launches']}; three train steps (replays) "
        f"{tr[0]['s_per_step']:.4f}/{tr[1]['s_per_step']:.4f} s a step (fwd+bwd of one "
        f"sample a rank), losses {tr[0]['losses']}, params finite {tr[0]['finite']}")
    if not all(x["finite"] for x in tr) or not np.isfinite(tr[0]["losses"]).all():
        raise RuntimeError("sharded train step: non-finite params or loss")

    c = [out["cli"] for out in ranks]
    log(f"sharded CLI, demo {demo_config.width}x{demo_config.height}x"
        f"{demo_config.max_bounces} checkpointed, two ranks under the caller's gloo group: "
        f"PNG {'byte-equal' if all(x['png'] == cli_ref for x in c) else 'DIFFERENT'} to one "
        f"process's on both ranks; flat kernels the card ran {c[0]['launches']}/"
        f"{c[1]['launches']}")
    if any(x["rc"] != 0 or x["png"] != cli_ref for x in c):
        raise RuntimeError("sharded CLI: a rank's PNG differs from one process's")
    log(f"collectives, gloo, 2 ranks on one card (not multi-card scaling): G-buffer "
        f"all_gather ({n} pixels) {ranks[0]['all_gather_ms']:.3f}/"
        f"{ranks[1]['all_gather_ms']:.3f} ms, grad all_reduce ({ranks[0]['grad_floats']} "
        f"floats + the loss) {ranks[0]['all_reduce_ms']:.3f}/{ranks[1]['all_reduce_ms']:.3f} ms")

    # NCCL at world size 1, in this process
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=device)
    try:
        mesh = sharding.make_render_mesh(1, 1, device=device)
        with device_launches(counts) as ran:
            gb = sharding.render_sharded(demo, demo_camera, demo_config, 4, mesh, adaptive=True)
        launches = launched("flat", "render_sharded (1, 1) over NCCL", ran)[0]
        same("NCCL (1, 1)", gbuffer_arrays(sharding.unshard_gbuffer(gb, demo_config, mesh)),
             refs["demo"][0])
        vg = sharding.sharded_value_and_grad_fn(demo, demo_config, mesh)
        with device_launches(counts) as ran:
            demo_vg = vg_calls(vg, params, demo_camera, target, SHARDED_KEY, calls=5)
        launched("flat", "value_and_grad (1, 1) over NCCL", ran, grad=True)
        loss_1, grads_1 = hand_built_grads(demo, demo_camera, demo_config, params, target,
                                           SHARDED_KEY, 1)
        for k, grads in enumerate(demo_vg["grads"]):
            for f, g in grads_1.items():
                if not np.allclose(grads[f], g, rtol=CARD_VS_CPU_RTOL, atol=CARD_VS_CPU_ATOL):
                    raise RuntimeError(f"NCCL (1, 1) value_and_grad call {k} {f} differs from "
                                       "the hand-built estimator's")
        demo_worst = replays_against_eager("NCCL (1, 1) value_and_grad, demo", demo_vg)
        flat = torch.zeros(1 + sum(g.size for g in demo_vg["grads"][0].values()),
                           device=device)
        shard = sharding.shard_gbuffer(GBuffer.create(n, device), demo_config, mesh)
        gather_ms = collective_ms(lambda: sharding.unshard_gbuffer(shard, demo_config, mesh),
                                  sync)
        reduce_ms = collective_ms(lambda: dist.all_reduce(flat), sync)
        profiled = {"demo": profile_replayed_vg("demo", "flat", vg, params, demo_camera, target,
                                                demo_config, counts)}
        # the hero at full width: its eager call, its capture, replays
        _, kernel, (w, h, b), _, eye, pitch = next(x for x in paths if x[0] == "hero")
        hero, hero_camera = scenes["hero"], Camera.create(eye, pitch=pitch, fov=np.pi / 2,
                                                          device=device)
        hero_config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
        with torch.no_grad():
            hero_target = render_sample(hero, hero_camera, rng.fold_in(SHARDED_KEY, 0),
                                        hero_config)
        hero_params = hero.materials.replace(albedo=hero.materials.albedo * 0.6)
        vg = sharding.sharded_value_and_grad_fn(hero, hero_config, mesh)
        with device_launches(counts) as ran:
            hero_vg = vg_calls(vg, hero_params, hero_camera, hero_target, SHARDED_KEY, calls=5)
        launched(kernel, "value_and_grad (1, 1) over NCCL, hero", ran, grad=True)
        hero_worst = replays_against_eager("NCCL (1, 1) value_and_grad, hero", hero_vg)
        profiled["hero"] = profile_replayed_vg("hero", kernel, vg, hero_params, hero_camera,
                                               hero_target, hero_config, counts)
        del vg
    finally:
        dist.destroy_process_group()
    log(f"sharded NCCL world 1: render_sharded of the demo on a (1, 1) mesh bit-equal to "
        f"one process's render (flat kernels the card ran {launches}); unshard_gbuffer "
        f"through NCCL; collectives (world 1, not scaling): G-buffer all_gather "
        f"{gather_ms:.3f} ms, grad all_reduce {reduce_ms:.3f} ms")
    for label, config, out, worst in (("demo", demo_config, demo_vg, demo_worst),
                                      ("hero", hero_config, hero_vg, hero_worst)):
        log(f"sharded NCCL world 1 value_and_grad {label} {config.width}x{config.height}x"
            f"{config.max_bounces} ray_chunk 0, (1, 1) mesh, five calls on one key: seconds "
            f"eager {out['seconds'][0]:.4f}, capturing call {out['seconds'][1]:.4f}, replays "
            f"{', '.join(f'{x:.4f}' for x in out['seconds'][2:])}; {graph_line(out['graph'])}; "
            f"losses bit-equal to the eager call's ({out['losses'][0]!r}), grads within rtol "
            f"{CARD_VS_CPU_RTOL:g} atol {CARD_VS_CPU_ATOL:g} (max |d| {worst:.3e})"
            + (f", and of the hand-built estimator (its loss {loss_1:.6f})"
               if label == "demo" else "") + f"; a profiled replay: {profiled[label]}")


def profile_replayed_vg(label, kernel, vg, params, camera, target, config, counts) -> str:
    """One replayed call of ``vg`` under ``device_launches``: the path's
    intersector, the sampler, both shading kernels and both backward
    kernels must have run, the backward's two once a bounce, and no plain
    version on CUDA (``check_only``); returns the records, kernel time and
    busy share of the profile as a line."""
    with device_launches(counts) as ran:
        vg(params, camera, target, SHARDED_KEY)
    launched = check_only(counts, kernel, f"a profiled replayed value_and_grad, {label}", ran,
                          grad=True)[0]
    if vg.graphs.last.replays < 2 or counts.shade_backward_kernel:
        raise RuntimeError(f"value_and_grad {label}: the profiled call did not replay")
    for k in ("shade", "shade_finish", "shade_bin", "shade_backward"):
        if ran[k] != config.max_bounces:
            raise RuntimeError(f"value_and_grad {label}: {ran[k]} {k} kernels in a replay of "
                               f"{config.max_bounces} bounces")
    records = ran.records
    n, busy_s, span_s = trace_share(records)
    backward = sum(d for name, _, d in records
                   if kernel_symbol("shade_backward") in name or kernel_symbol("shade_bin") in name)
    return (f"{n} CUDA records, device kernel time {busy_s * 1e3:.3f} ms in a device span of "
            f"{span_s * 1e3:.3f} ms (busy {busy_s / span_s:.1%}); {kernel} {ran[kernel]} "
            f"(wrapper launches {launched}), sampler {ran['sampler']}, shade_bounce "
            f"{ran['shade']}, finish_bounce {ran['shade_finish']}, bounce_bin {ran['shade_bin']}"
            f", bounce_backward {ran['shade_backward']} ({backward / 1e6:.3f} ms), one each a "
            f"bounce")


# Phase kd: the KD tree's walk kernel and the brute-force kernel. Issue
# slots per unit of work (see the note on issue slots above):
#   KD_NODE_SLOTS, one inner-node step: the plane subtraction and division
#     11, the side tests 4, the near/far/push classification 5, the child
#     and exit selects 4;
#   KD_ROOT_SLOTS, the root box's slab test once a ray: six subtractions and
#     six divisions 66, ten min/max and the comparison 11;
#   each triangle test of a walk: TRI_HIT_SLOTS, the cluster test's (the
#     normal and Cramer terms a KD test forms from the triangle's corners
#     count as free: the bound is what the least work could take); the
#     brute force's by its stages (``brute_stage_counts``).
KD_NODE_SLOTS, KD_ROOT_SLOTS = 24, 77
KD_SIZE = (512, 512, 8)  # the phase's wavefronts and renders: width, height, bounces
KD_ORACLE_RAYS = 4096
# a triangle of the table kernel: the bytes it must move (its corners in,
# the 80-byte record out) and its issue slots (make_tri: the
# cross product 9, the squared norm 5, its floor, square root and
# reciprocal 3, the scaled normal 3, n.p1 5, three dot products 15, the
# determinant 3 and its reciprocal 1)
TRI_TABLE_BYTES, TRI_CONSTS_SLOTS = 9 * 4 + 80, 44
# a write that evicts the 50 MB L2 cache between timed calls
L2_FLUSH_BYTES = 128 << 20
# the SHA-256 of (t, id, hit) of every wavefront of this phase, as the
# first KD walk and brute-force kernels gave them (PERF.md section 6): a
# redesigned kernel must give them again. (scene, rays, layout or None for
# the brute force)
PARENT_KD_DIGESTS = {
    ("demo", "camera"): "1afd75ca99701d64", ("demo", "bounce"): "9f741f526fdd1fd5",
    ("demo", "nee"): "4344628a379f2017", ("demo", "random, 70% active"): "3fbc2455bb7e310b",
    ("hero20k", "camera"): "b30ff32f47886fbc", ("hero20k", "bounce"): "fb89faf790a5b8a7",
    ("hero20k", "nee"): "67ef4f0d530e3ddf",
    ("hero20k", "random, 70% active"): "571b2c6f5d0f885e",
    ("hero300k", "camera"): "c8b02101f7a4e7f0", ("hero300k", "bounce"): "07bb38887d7c620f",
    ("hero300k", "nee"): "3e0e5c550afb4c4e",
    ("hero300k", "random, 70% active"): "a8ea869e6a3267cc",
    ("cornell", "camera"): "a17112c560172844", ("cornell", "bounce"): "b585071210d51564",
    ("cornell", "nee"): "cdca04e2b5db260e",
}


def same_digest(label, scene, kind, digest) -> None:
    """Raise unless ``digest`` is the parent's for (scene, kind)."""
    want = PARENT_KD_DIGESTS[(scene, kind)]
    if digest != want:
        raise RuntimeError(f"{label}: SHA-256 {digest}, the parent's {want}")


def kd_tables_bytes(tree, vertices=None) -> int:
    """The bytes of the tables a walk reads: the packed nodes, the chunk
    rows' links and ids or the tree's lists, and the triangle records
    (``tri_table``, built here if it was not)."""
    if vertices is None:
        leaves = (tree.leaf_first, tree.chunk_next, tree.chunk_tri, tree.tri_table)
    else:
        leaves = (tree.tri_indices, tree.tri_table(vertices))
    return tree.nodes.numel() * 4 + sum(t.numel() * t.element_size() for t in leaves)


def kd_bound(stats, num_rays: int, table_bytes: int) -> dict:
    """The bound of a KD walk call from its per-ray (steps, rows, tests):
    the node steps, the triangle tests and the root test in issue slots, the
    rays (32 bytes in, 8 out) and the tables in bytes."""
    steps, _, tests = stats.sum(dim=0).tolist()
    return bound(steps * KD_NODE_SLOTS + tests * TRI_HIT_SLOTS + num_rays * KD_ROOT_SLOTS,
                 num_rays * 40 + table_bytes)


def sha(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# the camera of each scene's wavefronts and renders: the bench camera, and
# hero_small_32's for the 20k hero (as phase sharded)
KD_EYES = {"demo": (BENCH_EYE, BENCH_PITCH), "hero20k": (GOLDEN_EYE, 0.0),
           "hero300k": (BENCH_EYE, BENCH_PITCH), "cornell": ((0.0, 0.0, -0.9), 0.0)}


def kd_wavefronts(label, scene, device):
    """The scene's camera, bounce and NEE wavefronts at KD_SIZE through its
    cluster kernel (main_path_rays), on the surfaces and lifted."""
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import make_trace_fn

    w, h, b = KD_SIZE
    trace = make_trace_fn(scene, RenderConfig(width=w, height=h, max_bounces=b))
    sets, lifted = main_path_rays(scene, np.random.default_rng(10), device,
                                  lambda cbvh, o, d: trace(o, d), w, h, *KD_EYES[label])
    log(f"kd {label}: wavefronts " + ", ".join(f"{k} {v[0].shape[0]}" for k, v in sets.items()))
    return trace, sets, lifted


def kd_against_cluster(label, kd_out, cluster_out, o, d, t_max, vertices) -> None:
    """The KD walk's (t, id) against a cluster kernel's (t, id, hit) on every
    ray, under the bench gate (the walk ignores t_max; its hit counts
    inside the window). The two exact structures test triangles by two
    formulas: the walk by the brute oracle's (the unit normal), the cluster
    kernels by the cluster contract's (precomputed Cramer terms), which
    round apart for rays that graze or lie in a triangle's plane and at
    knife-edge hits. So on every ray where they disagree the brute oracle
    decides: the walk must equal it there bit for bit, or the check fails;
    the rays where the cluster kernel alone parts from the oracle are
    counted."""
    t_k, i_k = kd_out
    t_c, i_c, h_c = cluster_out
    h_k = i_k >= 0
    want = h_k if t_max is None else h_k & (t_k < t_max)
    both = h_c & want
    rel = torch.where(both, (t_c - t_k).abs() / t_k.clamp_min(1e-3), 0.0)
    differ = (h_c != want) | (rel > 1e-3)
    rows = torch.nonzero(differ).flatten()
    ties = int(((i_c != i_k) & both & ~differ).sum())
    walk_wrong = 0
    if rows.numel():
        t_b, i_b, _ = brute(o[rows], d[rows], vertices, rays_per_call=1024)
        wrong = (i_k[rows] != i_b) | (t_k[rows] != t_b)
        walk_wrong = int(wrong.sum())
        for r in rows[wrong][:8].tolist():
            log(f"  ray {r}: KD walk t={float(t_k[r]):.9g} id={int(i_k[r])}; cluster "
                f"t={float(t_c[r]):.9g} id={int(i_c[r])} hit={bool(h_c[r])}")
    log(f"{label}, {o.shape[0]} rays: hits {int(want.sum())}; within the bench gate on "
        f"{o.shape[0] - rows.numel()} (max rel dt {float(torch.where(differ, 0.0, rel).max()):.2e}, "
        f"ids differing at ties {ties}); on {rows.numel()} the cluster kernel parts from the "
        f"brute oracle and the walk equals it bit for bit"
        + (f", except {walk_wrong}" if walk_wrong else ""))
    if walk_wrong:
        raise RuntimeError(f"{label}: the KD walk differs from the cluster kernel and the oracle")


def kernel_err(got, want) -> tuple:
    """max |kernel t - plain t| over the rays where both are finite, and the
    count of differing ids."""
    fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
    dt = (got[0][fin].double() - want[0][fin].double()).abs()
    return (float(dt.max()) if dt.numel() else 0.0), int((got[1] != want[1]).sum())


def in_prepared_light_order(scene):
    """``scene`` (unprepared) with its light list in the order
    ``prepare_scene`` gives it: sorted by the triangles' cluster order."""
    from isaklm_raytracer_tpu_torch.accel.cluster import cluster_order

    order = cluster_order(scene.vertices.cpu().numpy())
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    lights = scene.light_indices.cpu().numpy()
    return scene.replace(light_indices=torch.as_tensor(
        lights[np.argsort(inv[lights])], device=scene.light_indices.device))


def phase_kd(cli, counts, device, demo_argv, results) -> None:
    """Phase kd (the module docstring, 18)."""
    from isaklm_raytracer_tpu_torch.accel import (
        build_kd_tree,
        build_wavefront_kd,
        nearest_hit_brute,
        prepare_scene,
    )
    from isaklm_raytracer_tpu_torch.accel.kd_traverse import kd_plain
    from isaklm_raytracer_tpu_torch.accel.wavefront import wavefront_plain
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import (
        intersector_name,
        render,
        resolve_image,
    )
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.scene import procedural

    # 1. builds: prepare_scene asked for the KD tree (it builds none by
    # default), then the native KD build and the chunk rows of each scene
    scenes = {}
    for label, build in (("demo", procedural.material_demo_scene),
                         ("hero20k", lambda: procedural.hero_scene(20_000)),
                         ("hero300k", lambda: procedural.hero_scene(300_000))):
        raw = build()
        t0 = time.perf_counter()
        scene = scenes[label] = prepare_scene(raw, device, build_kd=True)
        torch.cuda.synchronize()
        log(f"kd {label}: prepare_scene(build_kd=True) {time.perf_counter() - t0:.2f} s "
            f"(cluster tables, KD tree and chunk rows, moved); cluster path "
            f"{intersector_name(scene.cbvh)}")
    tri_row = phase_kd_tables(scenes)
    for label, scene in scenes.items():
        verts = scene.vertices.cpu().numpy()
        t0 = time.perf_counter()
        kd = build_kd_tree(verts)
        t1 = time.perf_counter()
        wkd = build_wavefront_kd(kd, verts)
        t2 = time.perf_counter()
        if not (np.array_equal(kd.child_b, scene.kd.child_b.cpu().numpy())
                and np.array_equal(wkd.chunk_tri, scene.wkd.chunk_tri.cpu().numpy())):
            raise RuntimeError(f"kd {label}: the prepared tree differs from a rebuild")
        log(f"kd {label}: {scene.num_triangles} triangles; native KD build {t1 - t0:.3f} s, "
            f"build_wavefront_kd {t2 - t1:.3f} s; {kd.child_a.shape[0]} nodes, "
            f"{kd.tri_indices.shape[0]} leaf entries, {wkd.chunk_tri.shape[0]} chunk rows of "
            f"{wkd.leaf_width}; tables {kd_tables_bytes(scene.wkd) / 2**20:.2f} MiB (chunk "
            f"rows), {kd_tables_bytes(scene.kd, scene.vertices) / 2**20:.2f} MiB (tree lists)")

    # 2.-3. the walk kernel against its plain version (both layouts), and
    # against the scene's cluster kernel and the brute oracle
    rng = np.random.default_rng(18)
    row = None
    kd_err, kd_ids = 0.0, 0
    for label, scene in scenes.items():
        trace, sets, lifted = kd_wavefronts(label, scene, device)
        cluster = intersector_name(scene.cbvh)
        verts = scene.vertices
        lo, hi = verts.reshape(-1, 3).min(0).values.cpu().numpy(), \
            verts.reshape(-1, 3).max(0).values.cpu().numpy()
        o_r, d_r = random_rays(rng, 16384, lo, hi, device)
        act_r = torch.tensor(rng.random(16384) > 0.3, device=device)
        checks = {**{k: (o, d, None) for k, (o, d, _) in sets.items()},
                  "random, 70% active": (o_r, d_r, act_r)}
        for kind, (o, d, act) in checks.items():
            for layout, kernel, plain in (
                ("chunk rows", lambda: ki.kd_intersect(scene.wkd, o, d, 1e-5, act, stats=True),
                 lambda: wavefront_plain(scene.wkd, o, d, 1e-5, act, stats=True)),
                ("tree lists",
                 lambda: ki.kd_intersect(scene.kd, o, d, 1e-5, act, vertices=verts, stats=True),
                 lambda: kd_plain(scene.kd, verts, o, d, 1e-5, act, stats=True)),
            ):
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err, ids = kernel_err(got, want)
                kd_err, kd_ids = max(kd_err, err), kd_ids + ids
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"kd {label} {kind} ({layout}): kernel != plain version "
                                       f"(max |dt| {err:.3e}, {ids} ids differ)")
                digest = sha(got[0], got[1], got[1] >= 0)
                same_digest(f"kd {label} {kind} ({layout})", label, kind, digest)
                log(f"kd {label} {kind} ({layout}): {o.shape[0]} rays, kernel == plain version "
                    f"in (t, id, stats); sha256 (t, id, hit) {digest}, the parent's; sha256 "
                    f"stats {sha(got[2])}; steps/rows/tests {got[2].sum(dim=0).tolist()}")
        # two exact structures: the walk against the cluster kernel on every
        # ray, on the surfaces and lifted; the brute oracle on the rays where
        # they disagree, and on a sample
        for kind in sets:
            for origin, rays in (("lifted", lifted), ("on the surface", sets)):
                o, d, t_max = rays[kind]
                kd_against_cluster(f"kd {label} {kind} ({origin}): the KD walk against "
                                   f"{cluster}", ki.kd_intersect(scene.wkd, o, d),
                                   trace(o, d, t_max=t_max), o, d, t_max, verts)
            o, d, t_max = lifted[kind]
            pick = torch.tensor(rng.choice(o.shape[0], min(KD_ORACLE_RAYS, o.shape[0]),
                                           replace=False), device=device)
            o, d = o[pick], d[pick]
            t_max = None if t_max is None else t_max[pick]
            t_k, i_k = ki.kd_intersect(scene.wkd, o, d)
            oracle_gate(f"kd {label} {kind} (lifted): the KD walk against the brute oracle, "
                        f"{o.shape[0]} rays", t_k, i_k, i_k >= 0,
                        brute(o, d, verts, rays_per_call=1024), None, None, True)
        if label == "hero20k":  # the kernels line's row
            o, d, _ = sets["camera"]
            nbytes = kd_tables_bytes(scene.wkd)
            k_ms, p_ms, out = time_in_turns(
                f"kd_intersect (chunk rows) hero20k camera wavefront, {o.shape[0]} rays",
                lambda: ki.kd_intersect(scene.wkd, o, d, stats=True),
                lambda: wavefront_plain(scene.wkd, o, d, stats=True), plain_reps=1,
                plain_warmup=0)
            row = {"ms": k_ms, "plain_ms": p_ms, **kd_bound(out[2], o.shape[0], nbytes),
                   "shape": f"{o.shape[0]} camera rays x {scene.wkd.nodes.shape[0]} nodes, "
                            f"{scene.wkd.chunk_tri.shape[0]} chunk rows (hero20k)"}
        for kind, (o, d, _) in sets.items():
            for layout, tree, v in (("chunk rows", scene.wkd, None), ("tree lists", scene.kd, verts)):
                ms, out = cuda_ms(lambda: ki.kd_intersect(tree, o, d, vertices=v, stats=True),
                                  reps=5)
                b = kd_bound(out[2], o.shape[0], kd_tables_bytes(tree, v))
                log(f"time kd_intersect ({layout}) {label} {kind} wavefront, {o.shape[0]} rays: "
                    f"{ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
                    f"{b['ops']:.4g} issue slots, {b['bytes']:.4g} bytes)")
    card_test("test_torch_kdtree", "test_cuda_kd_kernel_matches_plain_version", "wavefront")
    card_test("test_torch_kdtree", "test_cuda_kd_kernel_matches_plain_version", "kd")
    for scene in ("cornell", "demo", "straddler", "soup", "degenerate"):
        card_test("test_torch_tri_consts", "test_cuda_tri_consts_kernel_matches_plain_version",
                  scene)
    card_test("test_torch_tri_consts", "test_cuda_tri_consts_kernel_at_block_edges")
    for inner, max_depth in ((20, 19), (40, 30), (63, 62), (70, 62)):
        card_test("test_torch_tri_consts", "test_cuda_kd_kernel_at_its_stack_depths", inner,
                  max_depth)
    log_walk_sass()

    # 4. the brute-force kernel against nearest_hit_brute
    cornell = prepare_scene(procedural.cornell_box(glossy=True), device)
    brute_row = None
    brute_err, brute_ids = 0.0, 0
    for label, scene in (("cornell", cornell), ("demo", scenes["demo"])):
        _, sets, _ = kd_wavefronts(label, scene, device)
        v = scene.vertices
        for kind, (o, d, _) in sets.items():
            got = ki.brute_intersect(v, o, d)
            want = brute(o, d, v, rays_per_call=16384)
            torch.cuda.synchronize()
            err, ids = kernel_err(got, want)
            brute_err, brute_ids = max(brute_err, err), brute_ids + ids
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"brute {label} {kind}: kernel != nearest_hit_brute "
                                   f"(max |dt| {err:.3e}, {ids} ids differ)")
            same_digest(f"brute {label} {kind}", label, kind, sha(*got))
            log(f"brute {label} {kind}: {o.shape[0]} rays x {v.shape[0]} triangles, kernel == "
                f"nearest_hit_brute; sha256 (t, id, hit) {sha(*got)}, the parent's")
        if label == "demo":
            o, d, _ = sets["camera"]
            k_ms, p_ms, _ = time_in_turns(
                f"brute_intersect demo camera wavefront, {o.shape[0]} rays x {v.shape[0]} "
                "triangles", lambda: ki.brute_intersect(v, o, d)[:2],
                lambda: brute(o, d, v, rays_per_call=16384)[:2], plain_reps=1, plain_warmup=0)
            shape = f"{o.shape[0]} camera rays x {v.shape[0]} triangles (demo)"
            pairs = brute_stage_counts(o, d, v)
            nbytes = o.shape[0] * 40 + v.numel() * 4
            b = bound(flat_slots(pairs), nbytes)
            stage_log(f"brute {shape}", pairs, b,
                      bound(o.shape[0] * v.shape[0] * TRI_HIT_SLOTS, nbytes))
            brute_row = {"ms": k_ms, "plain_ms": p_ms, **b, "shape": shape}
    card_test("test_torch_kdtree", "test_cuda_brute_kernel_matches_nearest_hit_brute")
    for num_tris in (1, 127, 128, 129, 1601):
        card_test("test_torch_tri_consts", "test_cuda_brute_kernel_edges", num_tris)

    # 5. renders through the KD walk kernel and the brute-force kernel, in
    # turns with the cluster path, on the prepared scene (the same triangle
    # and light order, so the same random numbers: the images differ only
    # where the two formulas part); then the --no-kd CLI
    w, h, b = KD_SIZE
    config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
    kd_launches = tri_launches = None
    for label in ("demo", "hero20k"):
        scene = scenes[label]
        eye, pitch = KD_EYES[label]
        camera = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
        cluster = intersector_name(scene.cbvh)
        # the walk's path takes a fresh copy of the chunk rows, whose table
        # its first (eager) step builds: the table kernel's main-path run
        paths = {cluster: scene, "kd": scene.replace(cbvh=None,
                                                     wkd=dataclasses.replace(scene.wkd)),
                 "brute": scene.replace(cbvh=None, wkd=None, kd=None)}
        images, per = {}, {}
        for name in (*paths, *reversed(paths)):
            with device_launches(counts) as ran:
                t0 = time.perf_counter()
                gb = render(paths[name], camera, config, num_samples=2, seed=0)
                torch.cuda.synchronize()
                per.setdefault(name, []).append((time.perf_counter() - t0) / 2)
            images[name] = resolve_image(gb, config).cpu().numpy()
            if name != cluster:
                launches = check_only(counts, name, f"kd render {label} through {name}, 2 "
                                      "samples", ran)
                if launches[0] != 2 * 2 * b:
                    raise RuntimeError(f"kd render {label}: {launches[0]} {name} kernels ran "
                                       f"in 2 samples, not {2 * 2 * b}")
                if name == "kd" and kd_launches is None:  # the kernels line's: the first
                    kd_launches = launches
                    tri_launches = (ran["tri_consts"], counts.tri_consts_kernel)
                    log(f"kd render {label} through kd: the triangle table kernel ran "
                        f"{tri_launches[0]} times on the card ({tri_launches[1]} launched by "
                        "its wrapper), building the fresh chunk rows' table")
                    if tri_launches != (1, 1):
                        raise RuntimeError("kd render: the walk's first step did not build "
                                           "its triangle table once")
        log(f"kd render {label} {w}x{h}x{b}, s/sample in turns under torch.profiler (2 samples "
            "each, the first pass with its warm-up): " + "; ".join(
                f"{n} {s[0]:.4f}/{s[1]:.4f}" for n, s in per.items()))
        clear_step_caches()
        for name in ("kd", "brute"):  # replayed steps against eager ones
            steps_against_replays(f"kd {label} through {name}", name, paths[name], camera,
                                  config, False, counts)
        clear_step_caches()
        for name in ("kd", "brute"):
            a, c = images[name], images[cluster]
            log(f"kd render {label} through {name}: {int((a != c).any(axis=-1).sum())} of "
                f"{w * h} pixels differ from the {cluster} path's")
            aggregate_gate(f"kd render {label} through {name} (against the {cluster} path)",
                           a * 255.0, c * 255.0)
    # --no-kd renders the scene as built, in its own triangle and light
    # order: its NEE picks another light with the same random numbers, so
    # its PNG differs from the prepared scene's by the noise of 4 samples
    # (logged). It is held to the same CLI run with nearest_hit_brute, the
    # kernel's plain version, in its place, byte for byte; and the same run
    # with the moved scene's lights in prepare_scene's order is held to the
    # cluster path's PNG under the aggregate gate, which shows that the
    # light order is the whole difference.
    import isaklm_raytracer_tpu_torch.integrator.render as render_module

    argv = [*demo_argv, "--no-adaptive", "--min-samples", "4", "--max-samples", "4",
            "--ray-chunk", "0", "--no-kd"]
    brute_launches, nokd = cli_path("brute", counts, (("demo_no_kd", argv),), "brute", cli)
    kernel_wrapper = render_module.brute_intersect
    render_module.brute_intersect = (
        lambda v, o, d, t_eps, active=None, t_max=None: nearest_hit_brute(o, d, v, t_eps,
                                                                          active=active))
    try:
        zero_counts(counts)
        plain = run_cli("demo --no-kd, nearest_hit_brute in place of the kernel", cli, argv,
                        os.path.join(OUT_DIR, "chip_smoke_demo_no_kd_plain.png"))[0]
    finally:
        render_module.brute_intersect = kernel_wrapper
    if counts.brute_kernel or not np.array_equal(plain, nokd["demo_no_kd"]):
        raise RuntimeError("CLI demo --no-kd: the brute kernel's PNG differs from its plain "
                           "version's")
    log("CLI demo --no-kd: PNG byte-equal to the same run through nearest_hit_brute")
    flat_png = cli_path("flat", counts, (("demo_4spp", argv[:-1]),), "flat", cli)[1]
    dev = np.abs(nokd["demo_no_kd"].astype(np.float64) - flat_png["demo_4spp"]) / 255.0
    log(f"CLI demo --no-kd against the prepared scene's flat path at 4 samples (other light "
        f"order, not gated): mean |d| {dev.mean():.3e}, pixels off by more than {AGG_PIXEL:g} "
        f"{float((dev.max(axis=-1) > AGG_PIXEL).mean()):.3%}, image means "
        f"{nokd['demo_no_kd'].mean():.3f} and {flat_png['demo_4spp'].mean():.3f}")
    real_load = cli.load_scene
    cli.load_scene = lambda args, dev: in_prepared_light_order(real_load(args, dev))
    try:
        ordered = cli_path("brute", counts, (("demo_no_kd_light_order", argv),), "brute", cli)[1]
    finally:
        cli.load_scene = real_load
    aggregate_gate("CLI demo --no-kd with its lights in prepare_scene's order, against the "
                   "flat path's PNG", ordered["demo_no_kd_light_order"], flat_png["demo_4spp"])
    log(f"kernels line, kd: max |dt| {kd_err:.3e} and {kd_ids} differing ids over every "
        f"kernel-vs-plain comparison; brute: {brute_err:.3e} and {brute_ids}")
    results["kd"] = {"max_abs_err": kd_err, "launches": kd_launches, **row}
    results["brute"] = {"max_abs_err": brute_err, "launches": brute_launches, **brute_row}
    results["tri_consts"] = {"launches": tri_launches, **tri_row}


def phase_kd_tables(scenes) -> dict:
    """The triangle tables of phase kd's scenes (csrc/tri_consts.cu, once
    a tree): each built and timed (host clock around the build and a
    synchronize: time to the first sample), its bytes, and equal to
    ``tri_consts_plain`` of the scene's corners bit for bit; then the kernel
    and its plain version timed by ``graph_device_ms`` (CUDA graphs of 20
    calls in turns, outputs equal by SHA-256, the kernel's own duration by
    torch.profiler) on the corners of the 20k and the 300k hero, each
    beside its bound. Returns the kernels line's row (the 20k hero's)."""
    from isaklm_raytracer_tpu_torch.accel.wavefront import tri_consts_plain
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    for label, scene in scenes.items():
        wkd, verts = scene.wkd, scene.vertices
        want = tri_consts_plain(verts.reshape(-1, 9))
        for layout, table_of in (("chunk rows", lambda: wkd.tri_table),
                                 ("tree lists", lambda: scene.kd.tri_table(verts))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = table_of()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if not torch.equal(table.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"kd {label} triangle table ({layout}) != tri_consts_plain")
            log(f"kd {label} triangle table ({layout}): {tuple(table.shape)} float32, "
                f"{table.numel() * 4 / 2**20:.2f} MiB, built in {seconds * 1e3:.2f} ms (time to "
                "the first sample), == tri_consts_plain of the scene's corners bit for bit")
    rows = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=scenes["hero20k"].device)
    for label in ("hero300k", "hero20k"):  # the kernels line takes the 20k hero's
        src = scenes[label].vertices.reshape(-1, 9)
        out = torch.empty((src.shape[0], ki.TRI_RECORD), dtype=torch.float32, device=src.device)

        def kernel(src=src, out=out):
            # the wrapper's launch into a table allocated outside the graph
            # (the wrapper itself refuses a capture: a graph would own its table)
            ki._launch("tri_consts", src, src.data_ptr(), src.shape[0], out.data_ptr())
            return out.view(torch.int32)

        def cold(fn):
            def call():
                flush.fill_(1)  # out of the L2 cache: the corners, the last table
                return fn()
            return call

        k_ms, p_ms, own_ms = graph_device_ms(
            f"tri_consts {label}, {src.shape[0]} triangles", kernel_symbol("tri_consts"), kernel,
            lambda src=src: tri_consts_plain(src).view(torch.int32))
        _, _, cold_ms = graph_device_ms(
            f"tri_consts {label}, {src.shape[0]} triangles, each call after a write of "
            f"{L2_FLUSH_BYTES >> 20} MiB (the L2 cache cold; the graph's times include the write)",
            kernel_symbol("tri_consts"), cold(kernel),
            cold(lambda src=src: tri_consts_plain(src).view(torch.int32)))
        b = bound(src.shape[0] * TRI_CONSTS_SLOTS, src.shape[0] * TRI_TABLE_BYTES)
        log(f"tri_consts bound {label}: {b['bound_ms']:.5f} ms ({b['bound_by']}; {b['bytes']:.4g} "
            f"bytes) = {b['bound_ms'] / k_ms:.1%} of its time a call in the graph, "
            f"{b['bound_ms'] / own_ms:.1%} of its own duration (L2 warm: the 20 calls read and "
            f"write the same {b['bytes'] / 2**20:.1f} MiB), {b['bound_ms'] / cold_ms:.1%} of its "
            f"own duration with the L2 cache cold ({cold_ms:.5f} ms)")
        rows[label] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, **b,
                       "shape": f"{src.shape[0]} triangles ({label})"}
    return rows["hero20k"]


def sass_loops(library) -> dict:
    """{kernel symbol: [(first address, last address, Counter of opcodes)]}
    of each loop of a built library's SASS: the instructions from a
    backward branch's target to the branch (``cuobjdump -sass``); {}
    without cuobjdump."""
    from isaklm_raytracer_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    dump = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    listing, current = {}, None
    for line in dump.splitlines():
        if "Function : " in line:
            current = listing.setdefault(line.split("Function : ")[1].strip(), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and current is not None:
            target = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
            current.append((int(m.group(1), 16), m.group(2).split(".")[0],
                            int(target.group(1), 16) if target else None))
    out = {}
    for name, ins in listing.items():
        loops = []
        for addr, _, target in ins:
            if target is not None and target <= addr:
                ops = collections.Counter(op for a, op, _ in ins if target <= a <= addr)
                loops.append((target, addr, ops))
        out[name] = loops
    return out


def innermost(loops, opcode: str):
    """The shortest loop of ``sass_loops``' list that holds ``opcode``."""
    holding = [lp for lp in loops if lp[2][opcode]]
    return min(holding, key=lambda lp: lp[1] - lp[0]) if holding else None


def log_walk_sass() -> None:
    """Logs the SASS opcodes of the KD walk's and the brute force's inner
    loops: the walk's leaf loop (the innermost loop with the test's FMULs:
    a chunk row's width-8 slots unrolled, or one slot of a list; its node
    steps have none) and the brute force's loop over a staged tile (the
    one that holds its LDS: five 16-byte shared loads a test)."""
    from isaklm_raytracer_tpu_torch.kernels import build

    for source, opcode, what in (("kd_intersect.cu", "FMUL", "leaf loop"),
                                 ("brute_intersect.cu", "LDS", "tile loop")):
        functions = sass_loops(build.library_path(source))
        if not functions:
            log(f"SASS of {source}: no cuobjdump beside nvcc")
            return
        for name, loops in sorted(functions.items()):
            loop = innermost(loops, opcode)
            if loop is None:
                continue
            ops = loop[2]
            log(f"SASS {what} of {name}: {sum(ops.values())} instructions "
                f"[{loop[0]:#x}, {loop[1]:#x}]: " + ", ".join(f"{op} {c}" for op, c in
                                                           ops.most_common()))


# The graphs phase's paths: label, kernel, (width, height, bounces), camera
# eye, pitch (the main path's presets, full width)
GRAPH_PATHS = (
    ("demo", "flat", (512, 512, 8), BENCH_EYE, BENCH_PITCH),
    ("hero20k", "queue", (512, 512, 8), GOLDEN_EYE, 0.0),
    ("hero", "blk", (HERO_W, HERO_H, HERO_BOUNCES), BENCH_EYE, BENCH_PITCH),
)
GRAPH_STEPS = 4  # steps of each eager-against-replay comparison


def clear_step_caches() -> None:
    """Drop every cached step factory, so that the next call of each step
    runs eagerly and captures afresh, and with them their graphs' pools."""
    from isaklm_raytracer_tpu_torch.integrator import render as R

    for factory in (R.make_step_fn, R.make_compact_step_fn, R.make_tail_step_fn,
                    R.make_candidates_fn, R.make_active_count_fn):
        factory.cache_clear()


def graph_record(graph) -> str:
    return (f"capture {graph.capture_s:.3f} s, instantiation {graph.instantiate_s:.3f} s, "
            f"graph pool {graph.pool_bytes / 2**20:.1f} MiB")


def steps_against_replays(label, kernel, scene, camera, config, adaptive, counts) -> dict:
    """GRAPH_STEPS steps of ``render_step`` and of ``make_step_fn`` (eager,
    capture, then replays) from zero G-buffers, each loop under
    ``device_launches``: both SHA-256s must be equal, and the kernels the
    card ran the same in both, of ``kernel`` alone; the graph's capture
    recorded one eager step's launches."""
    from isaklm_raytracer_tpu_torch.integrator.render import make_step_fn, render_step
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    step = make_step_fn(config)
    out = {}
    for how in ("eager", "graph"):
        gb = GBuffer.create(config.num_pixels, scene.device)
        with device_launches(counts) as ran:
            for i in range(GRAPH_STEPS):
                words = rng.sample_key_words(0, i)
                if how == "eager":
                    gb = render_step(scene, camera, gb, words, config, adaptive)
                else:
                    gb = step(scene, camera, gb, words, adaptive)
        launches = check_only(counts, kernel, f"graphs {label} adaptive={adaptive} {how}", ran)
        out[how] = (sha(gb.frame, gb.sq_luminance, gb.count), launches, ran["sampler"])
    graph = step.graphs.last
    recorded = graph.launches.get(f"{kernel}_kernel", 0)
    same = out["eager"][0] == out["graph"][0]
    log(f"graphs {label} adaptive={adaptive}: {GRAPH_STEPS} steps, G-buffer SHA-256 eager "
        f"{out['eager'][0]}, make_step_fn {out['graph'][0]} "
        f"({'equal' if same else 'DIFFERENT'}); {kernel} kernels the card ran (wrapper "
        f"launches) eager {out['eager'][1]}, graph (eager, capture, replays) "
        f"{out['graph'][1]}; the capture recorded {recorded}, replayed {graph.replays} times; "
        f"sampler kernels the card ran eager {out['eager'][2]}, graph {out['graph'][2]}; "
        f"{graph_record(graph)}")
    if not same or out["graph"][1][0] != out["eager"][1][0] \
            or recorded * GRAPH_STEPS != out["eager"][1][0] or out["graph"][2] != out["eager"][2]:
        raise RuntimeError(f"graphs {label}: replayed steps differ from the eager steps")
    return out


def compact_against_replays(label, scene, camera, config) -> None:
    """``make_compact_step_fn`` (eager, capture, replay) against
    ``compact_step`` on the G-buffer of two full steps, three keys: each
    result's SHA-256 equal."""
    from isaklm_raytracer_tpu_torch.integrator import render as R
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    gb = GBuffer.create(config.num_pixels, scene.device)
    for i in range(2):
        gb = R.render_step(scene, camera, gb, rng.sample_key_words(0, i), config, False)
    n = int(R.make_active_count_fn(config)(gb))
    bucket = R.compact_bucket(n, config.num_pixels,
                              min(config.min_wavefront, config.num_pixels))
    step = R.make_compact_step_fn(config, bucket)
    got, want = [], []
    for i in range(2, 5):
        words = rng.sample_key_words(0, i)
        got.append(sha(*vars(step(scene, camera, gb, words)).values()))
        want.append(sha(*vars(R.compact_step(scene, camera, gb, words, config,
                                             bucket)).values()))
    log(f"graphs {label} make_compact_step_fn: {n} active pixels into a bucket of {bucket}, "
        f"3 steps (eager, capture, replay) {got}, compact_step {want} "
        f"({'equal' if got == want else 'DIFFERENT'}); {graph_record(step.graphs.last)}")
    if got != want:
        raise RuntimeError(f"graphs {label}: the replayed compact step differs from eager")


def eager_and_replay_seconds(label, scene, camera, config, samples: int):
    """s/sample of full steps, eager (``render_step``) and replayed
    (``make_step_fn``, after its eager call and its capture), in turns:
    eager, replay, replay, eager. Returns ({how: [s, s]}, the graph)."""
    from isaklm_raytracer_tpu_torch.integrator.render import make_step_fn, render_step
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    step = make_step_fn(config)
    runs = {"eager": lambda gb, w: render_step(scene, camera, gb, w, config, False),
            "replay": lambda gb, w: step(scene, camera, gb, w, False)}
    per = {}
    for how in ("eager", "replay", "replay", "eager"):
        gb = GBuffer.create(config.num_pixels, scene.device)
        warm = 2 if how == "replay" and step.graphs.last is None else 1
        for i in range(warm):
            gb = runs[how](gb, rng.sample_key_words(0, i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(samples):
            gb = runs[how](gb, rng.sample_key_words(0, warm + i))
        torch.cuda.synchronize()
        per.setdefault(how, []).append((time.perf_counter() - t0) / samples)
        if not torch.isfinite(gb.frame).all():
            raise RuntimeError(f"graphs {label}: non-finite radiance in the timed steps")
    graph = step.graphs.last
    log(f"graphs {label} ray_chunk {config.ray_chunk}: s/sample in turns, eager "
        f"{per['eager'][0]:.4f}/{per['eager'][1]:.4f}, replayed {per['replay'][0]:.4f}/"
        f"{per['replay'][1]:.4f} ({min(per['eager']) / min(per['replay']):.2f}x); "
        f"{graph_record(graph)}")
    return per, graph


def profile_replay(label, kernel, scene, camera, config) -> float:
    """torch.profiler over one replayed step: its CUDA records, the kernel
    time within the device span of the trace (the busy share) and within
    the profiled step's wall; the records of ``kernel`` must equal the
    launches the graph's capture recorded."""
    from isaklm_raytracer_tpu_torch.integrator.render import make_step_fn
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    step = make_step_fn(config)
    gb = GBuffer.create(config.num_pixels, scene.device)
    with cuda_profile() as prof:
        t0 = time.perf_counter()
        step(scene, camera, gb, rng.sample_key_words(0, 9), False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graph = step.graphs.last
    records = device_records(prof)
    if not records or graph.replays == 0:
        raise RuntimeError(f"graphs {label}: no replay, or no kernel of it in the profile")
    n, busy_s, span_s = trace_share(records)
    mine = sum(kernel_symbol(kernel) in name for name, _, _ in records)
    recorded = graph.launches.get(f"{kernel}_kernel", 0)
    drawn = [d for name, _, d in records if kernel_symbol("sampler") in name]
    drawn_recorded = graph.launches.get("sampler_kernel", 0)
    log(f"profile graphs {label} ray_chunk {config.ray_chunk}, one replayed step: {n} CUDA "
        f"records, device kernel time {busy_s:.4f} s in a device span of {span_s:.4f} s (busy "
        f"{busy_s / span_s:.1%}; {busy_s / wall:.1%} of the profiled step's {wall:.4f} s wall); "
        f"{kernel} kernels {mine}, the capture recorded {recorded}; sampler kernels "
        f"{len(drawn)} ({sum(drawn) / 1e6:.4f} ms = {sum(drawn) / 1e9 / busy_s:.2%} of the "
        f"kernel time), the capture recorded {drawn_recorded}")
    if mine != recorded or recorded == 0:
        raise RuntimeError(f"graphs {label}: the replay ran {mine} {kernel} kernels, its "
                           f"capture recorded {recorded}")
    if len(drawn) != drawn_recorded or drawn_recorded == 0:
        raise RuntimeError(f"graphs {label}: the replay ran {len(drawn)} sampler kernels, its "
                           f"capture recorded {drawn_recorded}")
    shade_records(f"graphs {label} ray_chunk {config.ray_chunk}, the replay's shading", records,
                  config)
    return busy_s / span_s


def converge_through_render(scene, camera, config, counts):
    """``render`` to convergence (adaptive) against the eager loop of
    ``render_step``/``candidates``/``tail_step`` it stands for, in turns
    (eager, render with every cache cleared, render again, eager): the
    G-buffers' SHA-256 equal, the buckets of the ladder it went through
    (at least two) and the graphs it captured."""
    from isaklm_raytracer_tpu_torch.integrator import render as R
    from isaklm_raytracer_tpu_torch.math import rng
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    floor = min(config.min_wavefront, config.num_pixels)

    def eager():
        gb = GBuffer.create(config.num_pixels, scene.device)
        cand, bucket, buckets = None, config.num_pixels, []
        for i in range(config.max_samples):
            words = rng.sample_key_words(0, i)
            if cand is None:
                n = int(R.needs_sample(gb, config).sum())
                if n == 0:
                    break
                bucket = R.compact_bucket(n, config.num_pixels, floor)
                if bucket < config.num_pixels:
                    cand, _ = R.candidates(gb, config, bucket)
            if cand is not None:
                buckets.append(bucket)
                gb, cand, n = R.tail_step(scene, camera, gb, cand, words, config)
                if int(n) == 0:
                    break
                nb = R.compact_bucket(int(n), config.num_pixels, floor)
                if nb < bucket:
                    cand, bucket = cand[:nb], nb
                continue
            gb = R.render_step(scene, camera, gb, words, config, adaptive=True)
        return gb, sorted(set(buckets), reverse=True)

    def graphs():
        return R.render(scene, camera, config, config.max_samples, adaptive=True), None

    clear_step_caches()
    shas, walls, captures = {}, {}, []
    for how, fn in (("eager", eager), ("render", graphs), ("render", graphs),
                    ("eager", eager)):
        zero_counts(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gb, buckets = fn()
        torch.cuda.synchronize()
        walls.setdefault(how, []).append(time.perf_counter() - t0)
        shas.setdefault(how, set()).add(sha(gb.frame, gb.sq_luminance, gb.count))
        if buckets is not None:
            ladder = buckets
        else:
            steps = [R.make_step_fn(config).graphs]
            steps += [R.make_tail_step_fn(config, b).graphs for b in ladder]
            captures.append(sum(g.graph is not None for graphs_ in steps
                                for _, g in graphs_.entries.values()))
    same = len(shas["eager"]) == 1 and shas["eager"] == shas["render"]
    log(f"graphs demo to convergence ({config.width}x{config.height}x{config.max_bounces}, "
        f"min {config.min_samples} max {config.max_samples} spp, tolerance "
        f"{config.max_tolerance}): render's G-buffer SHA-256 {sorted(shas['render'])}, the "
        f"eager loop's {sorted(shas['eager'])} ({'equal' if same else 'DIFFERENT'}); tail "
        f"buckets {ladder}; graphs captured {captures[0]} (then {captures[1]} in all); wall "
        f"s in turns: eager {walls['eager'][0]:.3f}, render (captures included) "
        f"{walls['render'][0]:.3f}, render (replays only) {walls['render'][1]:.3f}, eager "
        f"{walls['eager'][1]:.3f}")
    if not same or len(ladder) < 2:
        raise RuntimeError("graphs: render to convergence differs from the eager loop, or "
                           "went through fewer than two buckets")


def phase_graphs(counts, device, scenes) -> None:
    """Phase graphs (the module docstring, 19)."""
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.entry import dryrun_multichip, entry
    from isaklm_raytracer_tpu_torch.math import rng

    clear_step_caches()
    cameras = {}
    for label, kernel, (w, h, b), eye, pitch in GRAPH_PATHS:
        cameras[label] = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
        for adaptive in (False, True):
            config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0, min_samples=2)
            steps_against_replays(label, kernel, scenes[label], cameras[label], config,
                                  adaptive, counts)
        clear_step_caches()

    adaptive = RenderConfig(width=512, height=512, max_bounces=8, ray_chunk=0, min_samples=2,
                            max_samples=32, max_tolerance=0.25)
    compact_against_replays("demo", scenes["demo"], cameras["demo"], adaptive)
    converge_through_render(scenes["demo"], cameras["demo"], adaptive, counts)
    clear_step_caches()

    chunk_default = RenderConfig().ray_chunk
    for label in ("demo", "hero"):
        _, kernel, (w, h, b), _, _ = next(p for p in GRAPH_PATHS if p[0] == label)
        for chunk in (0, chunk_default):
            config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=chunk)
            eager_and_replay_seconds(label, scenes[label], cameras[label], config,
                                     samples=1 if chunk else 3)
            if not chunk:  # at 16384 the profiler's own cost a record stretches the replay
                profile_replay(label, kernel, scenes[label], cameras[label], config)
            clear_step_caches()

    # entry(): fn captured and replayed against fn run eagerly
    fn, (camera, key) = entry(device)
    keys = [rng.key_tensor(words, device) for words in ((0, 0), rng.sample_key_words(0, 5))]
    want = [sha(fn(camera, k)) for k in keys]
    static_key = key.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(camera, static_key)
    got = []
    for k in keys:
        static_key.copy_(k)
        graph.replay()
        got.append(sha(out))
    log(f"graphs entry(): fn eager {want}, captured and replayed {got} "
        f"({'equal' if got == want else 'DIFFERENT'})")
    if got != want:
        raise RuntimeError("graphs: entry()'s fn replayed differs from fn run eagerly")
    del graph, out

    # dryrun_multichip over NCCL on this card, and two ranks on it over gloo
    for n, dev in ((1, "cuda"), (2, "cuda:0")):
        t0 = time.perf_counter()
        res = dryrun_multichip(n, dev)
        log(f"graphs dryrun_multichip({n}, {dev!r}): mesh {res['mesh']}, loss "
            f"{res['loss']:.6f}, frame {res['frame'].shape} finite, in "
            f"{time.perf_counter() - t0:.1f} s")


# the renders phase sampler draws with either sampler: scene, (width,
# height, bounces)
SAMPLER_RENDERS = (("demo", (512, 512, 8)), ("hero", (HERO_W, HERO_H, HERO_BOUNCES)))


def sampler_draws(device, rng):
    """The sampler's ids at the main path's shapes: {label: ids}: the
    demo's 262,144 and the hero's 230,400 int32 pixel ids (``render_sample``'s
    arange), a demo tail bucket of 131,072 with its ids clamped as
    ``tail_step`` passes them (the active pixels ascending, then zeros),
    and int64 ids (a sharded rank's may be) across the counter word's wrap
    at 2**32."""
    from isaklm_raytracer_tpu_torch.integrator.render import _first_ids

    bucket = 131_072
    active = torch.from_numpy(rng.random(512 * 512) < 0.3).to(device)
    first, n_active = _first_ids(active, bucket)
    cand = torch.where(torch.arange(bucket, device=device) < n_active, first, -1)
    return {
        "demo 262144 int32": torch.arange(512 * 512, dtype=torch.int32, device=device),
        f"hero {HERO_W * HERO_H} int32": torch.arange(HERO_W * HERO_H, dtype=torch.int32,
                                                     device=device),
        f"demo tail bucket {bucket} int32 (clamped)": torch.clamp_min(cand, 0),
        "262144 int64 from 2**32 - 1000": torch.arange(512 * 512, dtype=torch.int64,
                                                       device=device) + (2**32 - 1000),
    }


def sampler_bound(num_rays: int, n: int, id_bytes: int) -> dict:
    """The sampler's bound: its slots on each pipe (SAMPLER_PAIR_ALU) over
    that pipe's lanes, the slowest pipe against the bytes (the output
    written, the ids and the key read). The result holds each pipe's
    slots a ray and microseconds under "pipes"."""
    pairs, dropped = -(-n // 2), n % 2
    alu = pairs * SAMPLER_PAIR_ALU + n - 2 * dropped
    issue = alu + pairs * SAMPLER_PAIR_ADDS - dropped + 2 * n
    pipes = {"ALU": (alu, INT32_LANES_PER_SM), "all": (issue, FP32_LANES_PER_SM),
             "XU": (n, XU_LANES_PER_SM)}
    us = {k: slots * num_rays / (LANE_SLOTS_PER_S * lanes / FP32_LANES_PER_SM) * 1e6
          for k, (slots, lanes) in pipes.items()}
    slowest = max(us, key=us.get)
    slots, lanes = pipes[slowest]
    b = bound(slots * num_rays, n * num_rays * 4 + num_rays * id_bytes + 16, lanes)
    b["pipes"] = {k: {"slots_a_ray": pipes[k][0], "lanes_per_sm": pipes[k][1], "us": us[k]}
                  for k in pipes}
    b["pipe"] = slowest
    return b


def sass_opcodes(library) -> dict:
    """{kernel symbol: Counter of SASS opcodes (without modifiers)} of a
    built library, from ``cuobjdump -sass``; {} without cuobjdump."""
    from isaklm_raytracer_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    dump = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out, current = {}, None
    for line in dump.splitlines():
        if "Function : " in line:
            current = out.setdefault(line.split("Function : ")[1].strip(), collections.Counter())
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and current is not None:
            current[op.group(1).split(".")[0]] += 1
    return out


def log_sampler_sass() -> None:
    """Logs the SASS opcodes of the sampler kernel's instantiations beside
    the ALU slots a ray that its bound counts (n = 9 and 4 unroll, so
    their static counts are a ray's)."""
    from isaklm_raytracer_tpu_torch.kernels import build

    functions = sass_opcodes(build.library_path("threefry_uniforms.cu"))
    if not functions:
        log("sampler SASS: no cuobjdump beside nvcc")
        return
    for name, ops in sorted(functions.items()):
        n = re.search(r"ILi(\d+)E", name)
        n = int(n.group(1)) if n else 0
        counted = sampler_bound(1, n, 4)["pipes"] if n else None
        top = ", ".join(f"{op} {c}" for op, c in ops.most_common())
        log(f"sampler SASS of threefry_uniforms_kernel<{n}>: {sum(ops.values())} instructions: "
            f"{top}" + (f"; the bound counts {counted['ALU']['slots_a_ray']} ALU slots a ray "
                        f"(SHF + LOP3 here {ops['SHF'] + ops['LOP3']}) and "
                        f"{counted['all']['slots_a_ray']} in all" if counted else ""))


def graph_device_ms(label, symbol, kernel_fn, plain_fn, reps: int = 20, plain_reps=None,
                    same: bool = True, others: Optional[dict] = None) -> tuple:
    """Device ms a call of a kernel and of its plain version: each captured
    ``reps`` times (the plain version ``plain_reps``, by default as many)
    into a CUDA graph, which is replayed between CUDA events (a call one
    after another is bound by the host's launch rate, not by the kernel).
    In turns plain, kernel, kernel, plain; with ``same`` the outputs (a
    tensor or a sequence of them) must be equal by SHA-256. Then one
    replay of the kernel's graph under torch.profiler: the kernel's own
    duration (its records named like ``symbol``), without the gaps between
    graph nodes. Returns the means of the two turns (ms) and the
    profiler's mean kernel duration (ms). ``others`` ({symbol: None})
    receives the mean own duration (ms) of each other kernel named in it,
    from the same replay."""
    graphs, outs = {}, {}
    calls = {"kernel": reps, "plain": plain_reps or reps}
    for name, fn in (("kernel", kernel_fn), ("plain", plain_fn)):
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(calls[name]):
                outs[name] = fn()
    times = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms, _ = cuda_ms(graphs[name].replay, reps=3, warmup=1)
        times.setdefault(name, []).append(ms / calls[name])
    digests = [sha(*(o if isinstance(o, (list, tuple)) else (o,))) for o in outs.values()]
    if same and digests[0] != digests[1]:
        raise RuntimeError(f"{label}: the captured kernel's outputs differ from the plain "
                           "version's")
    with cuda_profile() as prof:
        graphs["kernel"].replay()
    own = [d for name, _, d in device_records(prof) if symbol in name]
    if len(own) != reps:
        raise RuntimeError(f"{label}: the profiler saw {len(own)} kernels of a replay of {reps}")
    own_ms = sum(own) / len(own) / 1e6
    for other in others or {}:
        durations = [d for name, _, d in device_records(prof) if other in name]
        others[other] = sum(durations) / max(len(durations), 1) / 1e6
    log(f"time {label} device, from CUDA graphs of {calls['kernel']} and {calls['plain']} "
        f"calls: kernel {times['kernel'][0]:.5f}/{times['kernel'][1]:.5f} ms, plain "
        f"{times['plain'][0]:.4f}/{times['plain'][1]:.4f} ms"
        f"{', outputs equal by SHA-256' if same else ''}; the "
        f"kernel's own duration (torch.profiler, one replay) {own_ms:.5f} ms, "
        f"{min(own) / 1e6:.5f}-{max(own) / 1e6:.5f}"
        + "".join(f"; {k}'s own {v:.5f} ms" for k, v in (others or {}).items()))
    del graphs
    return sum(times["kernel"]) / 2, sum(times["plain"]) / 2, own_ms


def phase_sampler(counts, device, scenes, results) -> None:
    """Phase sampler (the module docstring, 22)."""
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render
    from isaklm_raytracer_tpu_torch.math import rng

    draws = sampler_draws(device, np.random.default_rng(22))
    draws_per_sample = [(b, 9) for b in range(8)] + [(rng.CAMERA_STREAM, 4)]
    for label, ids in draws.items():
        digests = []
        for i in (0, 1):
            words = rng.sample_key_words(0, i)
            for key in (words, rng.key_tensor(words, device)):
                for stream, n in draws_per_sample:
                    zero_counts(counts)
                    got = rng.uniforms(key, ids, stream, n)
                    if counts.sampler_kernel != 1 or counts.sampler_plain_cuda:
                        raise RuntimeError(f"sampler {label}: uniforms did not launch the kernel")
                    want = rng.uniforms_plain(key, ids, stream, n)
                    if got.shape != (n, ids.shape[0]) or sha(got) != sha(want) \
                            or not torch.equal(got, want):
                        raise RuntimeError(f"sampler {label} stream {stream} n {n}: kernel != "
                                           "plain version")
                    digests.append(sha(got))
        log(f"sampler {label}: kernel == uniforms_plain by SHA-256 for samples 0 and 1, keys "
            f"as ints and as a key tensor, streams 0-7 at n = 9 and {rng.CAMERA_STREAM} at n "
            f"= 4 ({len(digests)} draws; first {digests[0]}, last {digests[-1]})")
    card_test("test_torch_rng", "test_cuda_sampler_kernel_equals_plain")

    log_sampler_sass()
    key_t = rng.key_tensor(rng.sample_key_words(0, 3), device)
    demo = draws["demo 262144 int32"]
    k_ms, _, _ = time_in_turns(
        "threefry_uniforms demo 262144 int32 stream 3 n 9, calls one after another (the "
        "host's launch rate bounds the kernel's)",
        lambda: (rng.uniforms(key_t, demo, 3, 9),), lambda: (rng.uniforms_plain(key_t, demo, 3, 9),))
    timed = {}
    for label, stream, n in (("demo 262144 int32", 3, 9),
                             ("demo 262144 int32", rng.CAMERA_STREAM, 4),
                             (f"hero {HERO_W * HERO_H} int32", 3, 9)):
        ids = draws[label]
        k_dev, p_dev, own = graph_device_ms(
            f"threefry_uniforms {label} n {n}", kernel_symbol("sampler"),
            lambda: rng.uniforms(key_t, ids, stream, n),
            lambda: rng.uniforms_plain(key_t, ids, stream, n))
        b = sampler_bound(ids.shape[0], n, ids.element_size())
        pipes = ", ".join(f"{k} {v['slots_a_ray']} slots a ray on {v['lanes_per_sm']} lanes an "
                          f"SM {v['us']:.3f} us" for k, v in b["pipes"].items())
        log(f"bound threefry_uniforms {label} n {n}: {b['bound_ms'] * 1e3:.3f} us "
            f"({b['bound_by']}; {pipes}; {b['bytes']:.4g} bytes "
            f"{b['bytes'] / HBM_BYTES_PER_S * 1e6:.3f} us); the kernel's device time "
            f"{k_dev * 1e3:.3f} us = {b['bound_ms'] / k_dev:.1%} of the bound's rate, its own "
            f"duration {own * 1e3:.3f} us = {b['bound_ms'] / own:.1%}; the plain version's "
            f"{p_dev:.4f} ms")
        timed[(label, n)] = (k_dev, p_dev, b)
    log(f"threefry_uniforms demo n 9: {k_ms * 1e3:.3f} us a call one after another against "
        f"{timed[('demo 262144 int32', 9)][0] * 1e3:.3f} us of device time")
    k_ms, p_ms, b = timed[("demo 262144 int32", 9)]
    results["sampler"] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, **b,
                          "shape": "262144 int32 ids x 9 variates (the demo's bounce draw)"}

    # one-pass renders with the plain sampler in the kernel's place: the
    # same G-buffer (eager call, capture and a replay of each)
    camera = Camera.create(BENCH_EYE, pitch=BENCH_PITCH, fov=np.pi / 2, device=device)
    for label, (w, h, bounces) in SAMPLER_RENDERS:
        config = RenderConfig(width=w, height=h, max_bounces=bounces, ray_chunk=0)
        digests = {}
        for how in ("kernel", "plain"):
            clear_step_caches()
            zero_counts(counts)
            real = rng.uniforms
            if how == "plain":
                rng.uniforms = rng.uniforms_plain
            try:
                gb = render(scenes[label], camera, config, num_samples=3, seed=0, adaptive=False)
                torch.cuda.synchronize()
            finally:
                rng.uniforms = real
            digests[how] = sha(gb.frame, gb.sq_luminance, gb.count)
            drawn = (counts.sampler_kernel, counts.sampler_plain_cuda)
            if (how == "kernel") != (drawn[0] > 0 and drawn[1] == 0) or sum(drawn) == 0:
                raise RuntimeError(f"sampler render {label} ({how}): sampler kernel launches "
                                   f"and plain calls {drawn}")
            log(f"sampler render {label} {w}x{h}x{bounces} ray_chunk 0, 3 samples (eager, capture, "
                f"replay) through the {how} sampler: G-buffer SHA-256 {digests[how]}; sampler "
                f"kernel launches {drawn[0]}, plain calls on CUDA {drawn[1]}")
        if digests["kernel"] != digests["plain"]:
            raise RuntimeError(f"sampler render {label}: the plain sampler's G-buffer differs")
    clear_step_caches()

# --- phase shade -------------------------------------------------------------

# The bytes a shading kernel must move, each input read once and each
# output written once (kernels/shade.py's Pending): a ray's state in (its
# origin, direction, throughput and radiance, its hit id and four flags,
# eight uniforms) and the pending state out (without lights, with them);
# the hit rows (a shading row, or the vertices, normals, uvs and material
# id), each distinct row once.
SHADE_IN_BYTES, SHADE_OUT_BYTES = 88, (51, 88)
SHADE_ROW_BYTES = {True: 128, False: 100}


def shade_tables_bytes(scene) -> int:
    """The material table (44 B a material), the texture atlas and the
    light list, read once."""
    m, tex = scene.materials, scene.textures
    return (m.albedo.shape[0] * 44 + tex.buffer.numel() * 4 + tex.offset.numel() * 12
            + scene.light_indices.numel() * 4)


def shade_bound(args, pending) -> dict:
    """shade_bounce's bound on one call's inputs ``args`` and its outputs
    ``pending``: the lanes counted by what they run (live lanes by the lobe
    they selected: metal from the hit material, diffuse from the new
    prev_diffuse, transmission from the flipped inside flag)."""
    scene, _, _, idx, _, _, _, _, inside, _, _, _ = args
    num = idx.shape[0]
    table = scene.shade_table is not None
    safe = idx.clamp_min(0).long()
    mat = scene.shade_table[safe, 24].long() if table else scene.mat_id[safe].long()
    live = pending.live
    metal = live & (scene.materials.extinction[mat] > 0)
    diffuse = live & pending.prev_diffuse
    trans = live & (pending.inside != inside)
    spec = live & ~metal & ~diffuse & ~trans
    kinds = {"metal": metal, "specular": spec, "transmission": trans, "diffuse": diffuse}
    lanes = {k: int(v.sum()) for k, v in kinds.items()}
    lit = bool(scene.has_lights)
    slots = (num * (SHADE_GEOMETRY_SLOTS + (SHADE_SHADOW_SLOTS if lit else 0))
             + int(live.sum()) * SHADE_LIVE_SLOTS + int((live & ~metal).sum()) * SHADE_DIELECTRIC_SLOTS
             + sum(n * SHADE_LOBE_SLOTS[k] for k, n in lanes.items()))
    nbytes = (num * (SHADE_IN_BYTES + SHADE_OUT_BYTES[lit])
              + torch.unique(safe).numel() * SHADE_ROW_BYTES[table] + shade_tables_bytes(scene)
              + (torch.unique(pending.light_idx).numel() * 36 if lit else 0))
    return {**bound(slots, nbytes), "lanes": lanes}


def finish_bound(args) -> dict:
    """finish_bounce's bound on one call's inputs: every lane reads its
    throughput, radiance and live flag (and its uniform, with roulette)
    and writes 25 B; a NEE lane reads its shadow hit and light (9 B more);
    a visible one its origin, direction, normal and distance (40 B), and
    each distinct light's row and vertices once."""
    scene, pending, idx, hit, _, roulette = args
    num = pending.live.shape[0]
    nbytes = num * (25 + 12 + 12 + 1 + (4 if roulette else 0))
    visible_n = 0
    if pending.nee_mask is not None:
        nee = pending.nee_mask
        visible = nee & hit & (idx == pending.light_idx)
        visible_n = int(visible.sum())
        rows = torch.unique(pending.light_idx[visible]).numel()
        nbytes += (num + int(nee.sum()) * 9 + visible_n * 40
                   + rows * (SHADE_ROW_BYTES[scene.shade_table is not None] + 36)
                   + shade_tables_bytes(scene))
    return {**bound(num * FINISH_LANE_SLOTS + visible_n * FINISH_DIRECT_SLOTS, nbytes),
            "visible": visible_n}


class ShadeCheck:
    """A stand-in for ``integrator.path_trace.shading`` in phase shade: each
    bounce runs both kernels and both plain versions on the same inputs,
    holds every output of each kernel to its plain version's by SHA-256
    and goes on with the kernels'; keeps the first bounce's inputs."""

    def __init__(self, label: str):
        self.label, self.calls, self.first = label, {"shade": 0, "finish": 0}, {}

    def __call__(self, route):
        return self.shade, self.finish

    def _same(self, which, kernel, plain, args) -> None:
        got, want = sha(*kernel), sha(*plain)
        if got != want:
            bits = [(k.view(torch.int32) if k.dtype == torch.float32 else k,
                     p.view(torch.int32) if p.dtype == torch.float32 else p)
                    for k, p in zip(kernel, plain)]
            rays = [int((k != p).reshape(k.shape[0], -1).any(dim=1).sum()) for k, p in bits]
            raise RuntimeError(f"shade {self.label} {which} bounce {self.calls[which]}: the "
                               f"kernel's outputs differ from the plain version's in "
                               f"{rays} rays (by output)")
        self.calls[which] += 1
        self.first.setdefault(which, args)

    def shade(self, *args):
        from isaklm_raytracer_tpu_torch.kernels import shade

        kernel = shade.shade_bounce(*args)
        self._same("shade", kernel.tensors(), shade.shade_bounce_plain(*args).tensors(), args)
        return kernel

    def finish(self, *args):
        from isaklm_raytracer_tpu_torch.kernels import shade

        kernel = shade.finish_bounce(*args)
        self._same("finish", kernel, shade.finish_bounce_plain(*args), args)
        return kernel


def phase_shade(device, scenes, results) -> None:
    """Phase shade (the module docstring, 23)."""
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator import path_trace
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample, trace_name
    from isaklm_raytracer_tpu_torch.kernels import shade

    card_test("test_torch_shade", "test_cuda_shade_kernels_equal_plain")
    demo = scenes["demo"]
    paths = (
        ("demo", demo, (512, 512, 8), BENCH_EYE, BENCH_PITCH),
        ("hero", scenes["hero"], (HERO_W, HERO_H, HERO_BOUNCES), BENCH_EYE, BENCH_PITCH),
        ("hero20k", scenes["hero20k"], (512, 512, 8), GOLDEN_EYE, 0.0),
        ("demo without tables", demo.replace(cbvh=None, wkd=None, kd=None, shade_table=None),
         (512, 512, 8), BENCH_EYE, BENCH_PITCH),
    )
    firsts = {}
    real_shading = path_trace.shading
    for label, scene, (w, h, b), eye, pitch in paths:
        camera = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
        config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
        check = ShadeCheck(label)
        path_trace.shading = check
        try:
            with torch.no_grad():
                checked = render_sample(scene, camera, (3, 4), config)
        finally:
            path_trace.shading = real_shading
        with torch.no_grad():
            straight = render_sample(scene, camera, (3, 4), config)
        if check.calls != {"shade": b, "finish": b} or sha(checked) != sha(straight):
            raise RuntimeError(f"shade {label}: {check.calls} bounces checked, or the checked "
                               "render differs from the render")
        log(f"shade {label} {w}x{h}x{b} ({trace_name(scene)}): every bounce's wavefront of "
            f"{config.num_pixels} rays through shade_bounce and finish_bounce equal to the plain "
            f"versions by SHA-256 of every output ({b} bounces each); the render through them "
            f"equal to the render by SHA-256")
        firsts[label] = check.first

    def timed(label, first):
        s_args, f_args = first["shade"], first["finish"]
        rays = s_args[1].shape[0]
        k_ms, p_ms, _ = graph_device_ms(
            f"shade_bounce {label} bounce 0, {rays} rays", kernel_symbol("shade"),
            lambda: shade.shade_bounce(*s_args).tensors(),
            lambda: shade.shade_bounce_plain(*s_args).tensors())
        fk_ms, fp_ms, _ = graph_device_ms(
            f"finish_bounce {label} bounce 0, {rays} rays", kernel_symbol("shade_finish"),
            lambda: shade.finish_bounce(*f_args), lambda: shade.finish_bounce_plain(*f_args))
        host = [cuda_ms(fn)[0] for fn in (lambda: shade.shade_bounce(*s_args),
                                          lambda: shade.finish_bounce(*f_args))]
        log(f"time shade_bounce and finish_bounce {label} bounce 0, {rays} rays, calls one after "
            f"another (the host's rate): {host[0]:.4f} and {host[1]:.4f} ms a call")
        sb = shade_bound(s_args, f_args[1])
        fb = finish_bound(f_args)
        log(f"shade bounds {label} bounce 0: shade_bounce {sb['bound_ms']:.4f} ms "
            f"({sb['bound_by']}; {sb['ops']:.4g} slots, {sb['bytes']:.4g} bytes; live lanes by "
            f"lobe {sb['lanes']}) = {sb['bound_ms'] / k_ms:.1%} of its time; finish_bounce "
            f"{fb['bound_ms']:.4f} ms ({fb['bound_by']}; {fb['ops']:.4g} slots, "
            f"{fb['bytes']:.4g} bytes; {fb['visible']} visible shadow hits) = "
            f"{fb['bound_ms'] / fk_ms:.1%} of its time")
        return (k_ms, p_ms, sb), (fk_ms, fp_ms, fb)

    for label in ("hero", "demo"):  # the kernels line takes the demo's
        (k_ms, p_ms, sb), (fk_ms, fp_ms, fb) = timed(label, firsts[label])
    rays = firsts["demo"]["shade"][1].shape[0]
    for key, (ms, plain_ms, b_) in (("shade", (k_ms, p_ms, sb)),
                                    ("shade_finish", (fk_ms, fp_ms, fb))):
        results[key] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        **{k: v for k, v in b_.items() if k not in ("lanes", "visible")},
                        "shape": f"{rays} rays, the demo's first bounce at 512x512"}


# --- phase shade_grad --------------------------------------------------------

# The backward kernel (csrc/shade_backward.cu), counted off its code by the
# rule above; a live lane recomputes its forward (SHADE_GEOMETRY_SLOTS,
# SHADE_LIVE_SLOTS, the dielectric's SHADE_DIELECTRIC_SLOTS, its lobe's
# SHADE_LOBE_SLOTS and Russian roulette), then runs:
#   SHADE_BACKWARD_LIVE_SLOTS, every live lane: the geometry's forward
#     intermediates 187 and reverse with the shading frame 350 (three
#     normalisations' reverses, 56 each), the half vector's reverse 87, the
#     state, the emission and the two texture lookups' reverse 78;
#   SHADE_BACKWARD_LOBE_SLOTS, the selected lobe's reverse: metal (the
#     specular weight's 358 with its two Smith terms, the conductor Fresnel
#     205, reflect 27), specular outside a medium (the specular weight,
#     reflect, the lobe ratio), specular inside (reflect and the ratio),
#     transmission (the specular weight, refract 109, the ratio), diffuse
#     (the cosine hemisphere's frame, the ratio);
#   SHADE_BACKWARD_FRESNEL_SLOTS, a non-metal lane with lobe_ratio_grad: the
#     dielectric Fresnel's recomputation and reverse;
#   SHADE_BACKWARD_NEE_SLOTS, a visible shadow hit: the shadow ray and the
#     direct light again (SHADE_SHADOW_SLOTS + FINISH_DIRECT_SLOTS) and their
#     reverse (the light's geometry without its frame 342, the direction's
#     normalisation 56, the weight, the texture);
#   SHADE_BACKWARD_LANE_SLOTS, every lane: the flags and the pass-through.
# The warp's shuffles and the atomics of the sums are not counted.
SHADE_BACKWARD_LIVE_SLOTS = 702
SHADE_BACKWARD_LOBE_SLOTS = {"metal": 620, "specular": 411, "specular inside": 53,
                             "transmission": 506, "diffuse": 106}
SHADE_BACKWARD_FRESNEL_SLOTS, SHADE_BACKWARD_NEE_SLOTS, SHADE_BACKWARD_LANE_SLOTS = 189, 515, 3
# The binning (bounce_bin_kernel), a lane: the class byte's test 2, the
# warp's match, the popcounts and the list's address 8.
SHADE_BIN_SLOTS = 10


def backward_classes(saved, pending) -> dict:
    """The live lanes of a backward call's ``saved`` inputs by class
    (kernels/shade.py RAY_CLASSES: {name: mask}), from the forward's
    ``pending`` state on them (its lobes, its shadow rays): a metal
    material; a diffuse lobe (``prev_diffuse``), its shadow ray visible
    (it hit the light it picked) or dark; a transmission (``inside``
    flipped); else a specular reflection, from outside or inside."""
    scene, live = saved.scene, saved.active & saved.hit
    safe = saved.idx.clamp_min(0).long()
    table = scene.shade_table is not None
    mat = scene.shade_table[safe, 24].long() if table else scene.mat_id[safe].long()
    metal = live & (scene.materials.extinction[mat] > 0)
    diffuse = live & pending.prev_diffuse
    trans = live & (pending.inside != saved.inside)
    spec = live & ~metal & ~diffuse & ~trans
    lit = bool(scene.has_lights)
    nee = diffuse & saved.shadow_hit if lit else torch.zeros_like(live)
    visible = nee & (saved.shadow_idx == pending.light_idx) if lit else nee
    return {"diffuse visible": visible, "transmission": trans, "specular": spec & ~saved.inside,
            "metal": metal, "specular inside": spec & saved.inside,
            "diffuse dark": diffuse & ~visible}


def shade_backward_bound(saved, pending) -> dict:
    """bounce_backward's bound on one call's ``saved`` inputs, with the
    forward's ``pending`` state on them (``backward_classes``). The
    bytes: every lane reads its hit and active flags and three output
    gradients (38 B) and writes three input gradients (36 B); a live lane
    its origin, direction, throughput, hit id and two flags (42 B), the
    uniforms it reads (the half vector's two, the lobe's, roulette's, the
    diffuse direction's two, the light's three) and, where it emits or its
    shadow ray is visible, the radiance's gradient (12 B); a diffuse lane
    of a lit scene its shadow hit (5 B); each distinct hit row and visible
    light row once, the material table, the atlas and the light list once,
    and the material and texel sums once. The kernel's binning and its
    ray list are not the function's work: bounce_bin has its own bound
    (``shade_bin_bound``)."""
    scene, live = saved.scene, saved.active & saved.hit
    num = live.shape[0]
    table = scene.shade_table is not None
    safe = saved.idx.clamp_min(0).long()
    classes = backward_classes(saved, pending)
    visible = classes["diffuse visible"]
    diffuse = visible | classes["diffuse dark"]
    nee = diffuse & saved.shadow_hit if scene.has_lights else torch.zeros_like(live)
    lit = bool(scene.has_lights)
    emit = live & ~saved.prev_diffuse
    kinds = {"metal": classes["metal"], "specular": classes["specular"],
             "specular inside": classes["specular inside"],
             "transmission": classes["transmission"], "diffuse": diffuse}
    lanes = {k: int(v.sum()) for k, v in kinds.items()}
    n_live, n_visible = int(live.sum()), int(visible.sum())
    dielectric = n_live - lanes["metal"]
    slots = (num * SHADE_BACKWARD_LANE_SLOTS
             + n_live * (SHADE_GEOMETRY_SLOTS + SHADE_LIVE_SLOTS + SHADE_BACKWARD_LIVE_SLOTS
                         + (FINISH_LANE_SLOTS if saved.roulette else 0))
             + dielectric * (SHADE_DIELECTRIC_SLOTS
                             + (SHADE_BACKWARD_FRESNEL_SLOTS if saved.lobe_ratio_grad else 0))
             + sum(n * (SHADE_LOBE_SLOTS[k.split()[0]] + SHADE_BACKWARD_LOBE_SLOTS[k])
                   for k, n in lanes.items())
             + n_visible * (SHADE_SHADOW_SLOTS + FINISH_DIRECT_SLOTS + SHADE_BACKWARD_NEE_SLOTS))
    uniforms = (n_live * 2 + dielectric + (n_live if saved.roulette else 0)
                + lanes["diffuse"] * 2 + int(nee.sum()) + n_visible * 2)
    rows = torch.unique(safe[live]).numel() * SHADE_ROW_BYTES[table]
    if lit:
        rows += torch.unique(pending.light_idx[visible]).numel() * (SHADE_ROW_BYTES[table] + 36)
    nbytes = (num * (38 + 36) + n_live * 42 + uniforms * 4 + int((emit | visible).sum()) * 12
              + int(diffuse.sum()) * (5 if lit else 0) + rows + shade_tables_bytes(scene)
              + scene.materials.albedo.shape[0] * 36 + scene.textures.buffer.numel() * 4)
    return {**bound(slots, nbytes), "lanes": lanes, "visible": n_visible}


class BackwardCheck:
    """A stand-in for ``kernels.shade.bounce_backward`` in phase shade_grad:
    each bounce's backward runs the kernel and the plain version on the
    same saved inputs and output gradients (``plain_in_slices`` of
    tests/test_torch_shade_grad.py: slices of 4,096 rays, their table
    gradients summed in float64), holds the kernel's to the plain version's
    (that module's ``check_backward``, with its allowance for
    ill-conditioned rays), recomputes in float64 each ray with a value
    beyond the strict tolerance (``float64_recheck``: the kernel no farther
    from it than RECHECK_FACTOR times the plain version) and goes on with
    the kernel's; keeps the last call's (bounce 0's) inputs, the largest
    differences, the per-ray values beyond the tolerances and the float64
    distances."""

    def __init__(self, label: str, real, tests):
        self.label, self.real, self.tests = label, real, tests
        self.calls, self.last, self.errs = 0, None, {}
        self.recheck = {"rays": 0, "kernel": 0.0, "plain": 0.0}

    def __call__(self, saved, grad_outputs, needs=None):
        from isaklm_raytracer_tpu_torch.kernels import shade

        if not torch.equal(saved.ray_class, shade.ray_classes_plain(saved)):
            raise RuntimeError(f"shade_grad {self.label} backward call {self.calls}: the "
                               "forward's class bytes differ from ray_classes_plain")
        got = self.real(saved, grad_outputs)
        want = self.tests.plain_in_slices(saved, grad_outputs)
        torch.cuda.synchronize()
        label = f"shade_grad {self.label} backward call {self.calls}"
        errs = self.tests.check_backward(label, got, want, self.tests.ILL_CONDITIONED_SHARE)
        self.errs["beyond"] = self.errs.get("beyond", 0) + errs.pop("beyond")
        for k, v in errs.items():
            self.errs[k] = max(self.errs.get(k, 0.0), v)
        rays = self.tests.beyond_rays(got, want)
        if rays.numel():
            r = self.tests.float64_recheck(label, saved, grad_outputs, got, want, rays)
            self.recheck = {"rays": self.recheck["rays"] + r["rays"],
                            **{k: max(self.recheck[k], r[k]) for k in ("kernel", "plain")}}
        self.calls += 1
        self.last = (saved, grad_outputs)
        return got


# Per-ray values beyond the strict tolerance in run BO (PR 15) over each
# path's fwd+bwd sample: the kernel's per-ray bits are that kernel's, so the
# counts cannot grow.
SHADE_GRAD_BEYOND = {"demo": 0, "hero": 5, "hero20k": 0, "demo without tables": 0}


def many_materials(scene, copies: int):
    """``scene`` with its material table repeated ``copies`` times and
    triangle i given copy i % copies of its material: the same shading,
    ``copies`` times the materials."""
    m = scene.materials
    n_mat = m.albedo.shape[0]

    def shift(rows):
        return (torch.arange(rows, device=scene.device) % copies) * n_mat

    tables = {}
    if scene.shade_table is not None:
        table = scene.shade_table.detach().clone()
        table[:, 24] += shift(table.shape[0]).to(table.dtype)
        tables["shade_table"] = table
    with torch.no_grad():
        fields = {f.name: getattr(m, f.name).detach().repeat(
            copies, *([1] * (getattr(m, f.name).dim() - 1))) for f in dataclasses.fields(m)}
    return scene.replace(materials=m.replace(**fields), **tables,
                         mat_id=scene.mat_id + shift(scene.mat_id.shape[0]).to(scene.mat_id.dtype))


def shade_bin_bound(saved, zero_bytes: int = 0) -> dict:
    """bounce_bin's bound on one call's ``saved`` inputs: SHADE_BIN_SLOTS a
    lane, and the bytes: every lane's class byte (the forward's, 1 B), a
    live lane's list entry (4 B), a dead lane its three gradients in and
    out (72 B), the six class counts, and the ``zero_bytes`` of sums it
    zeroes (a call of ``bounce_bin`` alone: transparent's zeros)."""
    live = saved.active & saved.hit
    n_live, n_dead = int(live.sum()), live.numel() - int(live.sum())
    nbytes = live.numel() * 1 + n_live * 4 + n_dead * 72 + 4 * 6 + zero_bytes
    return bound(live.numel() * SHADE_BIN_SLOTS, nbytes)


# bounce_bin of the parent tree (82bfff2: the class derived from the flags,
# one global atomic a block and class, a zero fill of its own) at bounce 0
# in run CE (NVIDIA H100 80GB HBM3, 700.00 W): ms a call in a CUDA graph of
# 20 with its fill, and its kernel's own duration. Logged beside this tree's
# as a reference from another call; tools/compare_kernel_times.py times the
# two in turns in one.
PARENT_BIN_MS = {"demo": (0.00533, 0.00421), "hero": (0.00545, 0.00431)}


def phase_shade_grad(device, scenes, results) -> None:
    """Phase shade_grad (the module docstring, 24)."""
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample, trace_name
    from isaklm_raytracer_tpu_torch.kernels import shade

    attrs = shade.backward_attributes(device)
    log("shade_grad: the backward's kernels as the card reports them (registers a thread, local "
        "bytes a thread, resident warps an SM, threads a block): " + "; ".join(
            f"{k} {v['registers']}, {v['local_bytes']} B, {v['resident_warps']} warps, "
            f"{v['threads']}" for k, v in attrs.items()))
    card_test("test_torch_shade_grad", "test_cuda_bounce_backward_equals_plain")
    card_test("test_torch_shade_grad", "test_cuda_forward_writes_the_ray_classes")
    tests = test_module("test_torch_shade_grad")
    demo = scenes["demo"]
    paths = (
        ("demo", demo, (512, 512, 8), BENCH_EYE, BENCH_PITCH),
        ("hero", scenes["hero"], (HERO_W, HERO_H, HERO_BOUNCES), BENCH_EYE, BENCH_PITCH),
        ("hero20k", scenes["hero20k"], (512, 512, 8), GOLDEN_EYE, 0.0),
        ("demo without tables", demo.replace(cbvh=None, wkd=None, kd=None, shade_table=None),
         (512, 512, 8), BENCH_EYE, BENCH_PITCH),
    )

    def fwd_bwd(scene, camera, config):
        m = scene.materials
        leaves = [getattr(m, f).detach().clone().requires_grad_(True)
                  for f in shade.MATERIAL_FIELDS]
        texels = scene.textures.buffer.detach().clone().requires_grad_(True)
        position = camera.position.detach().clone().requires_grad_(True)
        s = scene.replace(materials=m.replace(**dict(zip(shade.MATERIAL_FIELDS, leaves))),
                          textures=dataclasses.replace(scene.textures, buffer=texels))
        loss = render_sample(s, camera.replace(position=position), (3, 4), config).mean()
        grads = torch.autograd.grad(loss, [*leaves, texels, position])
        return loss.detach(), grads

    checks, real = {}, shade.bounce_backward
    for label, scene, (w, h, b), eye, pitch in paths:
        camera = Camera.create(eye, pitch=pitch, fov=np.pi / 2, device=device)
        config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
        check = BackwardCheck(label, real, tests)
        shade.bounce_backward = check
        try:
            loss, grads = fwd_bwd(scene, camera, config)
        finally:
            shade.bounce_backward = real
        straight, _ = fwd_bwd(scene, camera, config)
        if check.calls != b or sha(loss) != sha(straight):
            raise RuntimeError(f"shade_grad {label}: {check.calls} bounces checked, or the "
                               "checked sample's loss differs from the sample's")
        if not all(torch.isfinite(g).all() for g in grads):
            raise RuntimeError(f"shade_grad {label}: a non-finite gradient")
        beyond = check.errs.pop("beyond")
        rc = check.recheck
        log(f"shade_grad {label} {w}x{h}x{b} ({trace_name(scene)}): every bounce's backward of "
            f"{config.num_pixels} rays through bounce_backward within the test tolerances of "
            f"bounce_backward_plain ({b} bounces; {beyond} per-ray values beyond them, within "
            f"{tests.ILL_CONDITIONED_RTOL:g}, at most {SHADE_GRAD_BEYOND[label]} in run BO; their "
            f"{rc['rays']} rays recomputed in float64: the kernel at most {rc['kernel']:.3e} from "
            f"it, the float32 plain version {rc['plain']:.3e}; largest |kernel - plain| "
            + ", ".join(f"{k} {v:.3e}" for k, v in check.errs.items())
            + f"); loss {float(loss):.6f} equal to the straight sample's")
        if beyond > SHADE_GRAD_BEYOND[label]:
            raise RuntimeError(f"shade_grad {label}: {beyond} per-ray values beyond the "
                               f"tolerance, more than run BO's {SHADE_GRAD_BEYOND[label]}")
        checks[label] = check

    @torch.no_grad()  # as in a backward: the saved rays require grad
    def kernel_symbols(label, fn, want):
        """The backward kernel records of one call under torch.profiler:
        the reverse's instantiation must be ``want``."""
        with cuda_profile() as prof:
            fn()
            torch.cuda.synchronize()
        names = [name for name, _, _ in device_records(prof)
                 if kernel_symbol("shade_backward") in name]
        if len(names) != 1 or want not in names[0]:
            raise RuntimeError(f"shade_grad {label}: the reverse ran as {names}, {want} expected")

    @torch.no_grad()
    def held(label, saved, gouts, want_symbol=None):
        """The kernel against the plain version on one call's inputs."""
        got = shade.bounce_backward(saved, gouts)
        want = tests.plain_in_slices(saved, gouts)
        torch.cuda.synchronize()
        errs = tests.check_backward(f"shade_grad {label}", got, want)
        if want_symbol:
            kernel_symbols(label, lambda: shade.bounce_backward(saved, gouts), want_symbol)
        return errs

    def dead_state(saved):
        """``saved`` with every lane inactive, its classes derived again."""
        dead = dataclasses.replace(saved, active=torch.zeros_like(saved.active))
        dead.ray_class = shade.ray_classes_plain(dead)
        return dead

    def rays_of(saved, gouts, rays):
        """The saved inputs and output gradients of ``rays`` alone."""
        cut = {f: ((v[:, rays] if f == "u" else v[rays]).contiguous()
                   if isinstance(v, torch.Tensor) else v) for f, v in vars(saved).items()}
        return shade.BounceSaved(**cut), [g[rays].contiguous() for g in gouts]

    saved, gouts = checks["demo"].last
    n_mat = saved.scene.materials.albedo.shape[0]
    copies = 256 // n_mat + 1
    wide = dataclasses.replace(saved, scene=many_materials(saved.scene, copies))
    errs = held(f"demo bounce 0 with {copies * n_mat} materials", wide, gouts,
                "bounce_backward_kernel<false>")
    held("demo bounce 0", saved, gouts, "bounce_backward_kernel<true>")
    log(f"shade_grad demo bounce 0 with its material table repeated {copies} times "
        f"({copies * n_mat} materials, above the shared table's 256): the reverse with device "
        f"sums (bounce_backward_kernel<false>) within the test tolerances of the plain version, "
        f"largest |kernel - plain| albedo {errs['albedo']:.3e}, emittance {errs['emittance']:.3e};"
        f" the demo's own {n_mat} ran bounce_backward_kernel<true>")
    dead = dead_state(saved)
    errs = held("demo bounce 0, every lane dead", dead, gouts)
    lists = shade.bounce_bin_plain(saved)
    for name, rays in zip(shade.RAY_CLASSES, lists):
        if rays.numel():
            sub, sub_g = rays_of(saved, gouts, rays)
            held(f"demo bounce 0, its {rays.numel()} {name} rays alone", sub, sub_g)
    log(f"shade_grad demo bounce 0: every lane dead (the pass-through alone, largest "
        f"|kernel - plain| ray_d {errs['ray_d']:.3e}) and each class alone ("
        + ", ".join(f"{n} {r.numel()}" for n, r in zip(shade.RAY_CLASSES, lists))
        + " rays) within the test tolerances of the plain version")

    @torch.no_grad()
    def bin_check(label, saved, gouts):
        """bounce_bin against bounce_bin_plain: each segment's rays (as a
        set), the counts, the dead lanes' gradients bit for bit, from the
        forward's class bytes; and with every lane dead."""
        for case, sv in ((label, saved), (f"{label}, every lane dead", dead_state(saved))):
            counts = tests.check_binning(f"bounce_bin {case}", shade.bounce_bin(sv, gouts), sv,
                                         gouts)
            want = [r.numel() for r in shade.bounce_bin_plain(sv)]
            if counts != want:
                raise RuntimeError(f"bounce_bin {case}: counts {counts}, {want} expected")
            if sv is saved:
                kept = counts
        log(f"bounce_bin {label}: each class's segment == bounce_bin_plain's as a set (counts "
            f"{kept}), the dead lanes' gradients passed through bit for bit, from the forward's "
            "class bytes; the same with every lane dead")
        return kept

    @torch.no_grad()  # as in a backward: the saved rays require grad
    def timed(label, check):
        saved, gouts = check.last
        rays = saved.ray_o.shape[0]
        counts = bin_check(label, saved, gouts)
        inside = {kernel_symbol("shade_bin"): None}
        k_ms, p_ms, own_ms = graph_device_ms(
            f"bounce_backward {label} bounce 0, {rays} rays (the binning, which zeroes the sums, "
            "the reverse and the sums' rounding)", kernel_symbol("shade_backward"),
            lambda: shade.bounce_backward(saved, gouts),
            lambda: shade.bounce_backward_plain(saved, gouts), plain_reps=3, same=False,
            others=inside)
        in_call_ms = inside[kernel_symbol("shade_bin")]
        host_ms, _ = cuda_ms(lambda: shade.bounce_backward(saved, gouts))
        log(f"time bounce_backward {label} bounce 0, {rays} rays, calls one after another (the "
            f"host's rate): {host_ms:.4f} ms a call")
        bin_ms, _, bin_own_ms = graph_device_ms(
            f"bounce_bin {label} bounce 0, {rays} rays (the binning alone, on new zero counters: "
            "their fill, then the kernel; its plain stand-in: itself, once)",
            kernel_symbol("shade_bin"), lambda: shade.bounce_bin(saved, gouts).class_counts,
            lambda: shade.bounce_bin(saved, gouts).class_counts, plain_reps=1, same=False)
        empty = rays_of(saved, gouts, torch.arange(0, device=saved.ray_o.device))
        empty_ms, _, empty_own_ms = graph_device_ms(
            f"bounce_bin {label} on no ray (one block: the launch and the zeroing alone)",
            kernel_symbol("shade_bin"), lambda: shade.bounce_bin(*empty).class_counts,
            lambda: shade.bounce_bin(*empty).class_counts, plain_reps=1, same=False)
        parent_ms, parent_own_ms = PARENT_BIN_MS[label]
        log(f"time bounce_bin {label} bounce 0: alone {bin_ms:.5f} ms a call in a CUDA graph "
            f"(with the counters' fill), the kernel's own {bin_own_ms:.5f} ms; inside "
            f"bounce_backward (no fill: the reverse leaves the counters at zero) its own "
            f"{in_call_ms:.5f} ms; on no ray {empty_ms:.5f} and {empty_own_ms:.5f} ms; the parent "
            f"tree in run CE {parent_ms:.5f} ms with its zero fill, its kernel's own "
            f"{parent_own_ms:.5f} ms (another call; in turns: tools/compare_kernel_times.py)")
        if shade.device_counters(saved.ray_o.device).any():
            raise RuntimeError(f"bounce_backward {label}: the counters are not zero after it")
        bin_plain_ms, _ = cuda_ms(lambda: shade.bounce_bin_plain(saved), reps=5)
        log(f"time bounce_bin_plain {label} bounce 0 (eager, CUDA events; it syncs): "
            f"{bin_plain_ms:.4f} ms; class counts "
            + ", ".join(f"{n} {c}" for n, c in zip(shade.RAY_CLASSES, counts)))
        pending = shade.shade_bounce(saved.scene, saved.ray_o, saved.ray_d, saved.idx, saved.hit,
                                     saved.active, saved.throughput, saved.radiance,
                                     saved.inside, saved.prev_diffuse, saved.u,
                                     saved.lobe_ratio_grad)
        bb = shade_backward_bound(saved, pending)
        log(f"bounce_backward bound {label} bounce 0: {bb['bound_ms']:.4f} ms ({bb['bound_by']}; "
            f"{bb['ops']:.4g} slots, {bb['bytes']:.4g} bytes; live lanes by lobe {bb['lanes']}, "
            f"{bb['visible']} visible shadow hits) = {bb['bound_ms'] / k_ms:.1%} of its time")
        nb = shade_bin_bound(saved, 4 * saved.scene.materials.albedo.shape[0])
        log(f"bounce_bin bound {label} bounce 0: {nb['bound_ms']:.5f} ms ({nb['bound_by']}; "
            f"{nb['bytes']:.4g} bytes) = {nb['bound_ms'] / bin_ms:.1%} of its time a call alone, "
            f"{nb['bound_ms'] / bin_own_ms:.1%} of its own duration")
        return k_ms, p_ms, bb, bin_ms, bin_plain_ms, nb

    for label in ("hero", "demo"):  # the kernels line takes the demo's
        k_ms, p_ms, bb, bin_ms, bin_plain_ms, nb = timed(label, checks[label])
    rays = checks["demo"].last[0].ray_o.shape[0]
    results["shade_backward"] = {
        "max_abs_err": max(max(c.errs.values()) for c in checks.values()), "ms": k_ms,
        "plain_ms": p_ms, **{k: v for k, v in bb.items() if k not in ("lanes", "visible")},
        "shape": f"{rays} rays, the demo's bounce 0 at 512x512 (both kernels of a call)"}
    results["shade_bin"] = {"max_abs_err": 0.0, "ms": bin_ms, "plain_ms": bin_plain_ms, **nb,
                            "shape": f"{rays} rays, the demo's bounce 0 at 512x512"}


def phase_telemetry(device, seeds=(TELEMETRY_SEED,)) -> None:
    """Phase telemetry (the module docstring, 25), each cell on each of
    ``seeds``."""
    from isaklm_raytracer_tpu_torch import telemetry
    from isaklm_raytracer_tpu_torch.tools import profiling
    from perfbench import core as bench
    from perfbench import trace as bench_trace

    spin = bench_trace.filler_name()
    offsets = {"device": [], "launch": []}
    for _ in range(SLEEP_TRIES):
        telemetry.clear()
        with bench_trace.cuda_profile() as prof:
            with telemetry.span("spin") as s:
                torch.cuda._sleep(SLEEP_CYCLES)
                torch.cuda.synchronize()
        rec = max((e for e in bench_trace.cuda_events(prof) if e.name() == spin),
                  key=lambda e: e.duration_ns())
        launch = next(e for e in prof.profiler.kineto_results.events()
                      if e.correlation_id() == rec.correlation_id()
                      and e.device_type() != rec.device_type() and e.name().startswith("cuda"))
        for key, e in (("device", rec), ("launch", launch)):
            offsets[key].append(((e.start_ns() - s.start_ns) / 1e3,
                                 (s.end_ns - e.start_ns() - e.duration_ns()) / 1e3))
    inside = {k: sum(h >= 0 and t >= 0 for h, t in v) for k, v in offsets.items()}
    for key, what in (("launch", "its launch's host record"),
                      ("device", "the spin's record as kineto maps it")):
        heads, tails = zip(*offsets[key])
        log(f"telemetry: {what} inside its span in {inside[key]} of {SLEEP_TRIES}; us from the "
            f"span's start to the record's {sorted(heads)}; from the record's end to the "
            f"span's {sorted(tails)}")
    # kineto maps the device's times onto the host's clock with an error
    # that drifts and jitters by tens of us to ms (PERF.md): the spans are
    # held to the host's records, and the device's are logged
    if inside["launch"] < SLEEP_TRIES:
        raise RuntimeError("a span did not hold the launch made inside it")

    def site_ns() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(SPAN_CALLS):
            with telemetry.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / SPAN_CALLS

    off = site_ns()
    with bench_trace.cuda_profile():
        on = site_ns()
    telemetry.clear()
    log(f"telemetry: a span site {off:.0f} ns with no profiler, {on:.0f} ns under one")

    spec = bench.load_benchmark()
    for name, seed in itertools.product(TELEMETRY_CELLS, seeds):
        cell, config, traffic = bench.load_cell(spec, name)
        seconds = float(traffic["trace_seconds"])
        driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
        c = driver.Cell(bench.Context(cell, config, traffic, seed, seconds, False, device))
        name = f"{name} seed {seed}"
        ms = {False: [], True: []}
        for traced in (False, True, True, False):
            telemetry.clear()
            with bench_trace.cuda_profile() if traced else contextlib.nullcontext() as prof:
                w = c.window(seconds, time.perf_counter())
            ms[traced].append(1e3 * w.seconds / w.steps)
            if traced:
                telemetry_window(name, cell["name"], spec, traffic, w, prof,
                                 telemetry.spans())
        c.release()
        del c
        gc.collect()
        torch.cuda.empty_cache()
        log(f"telemetry {name}: ms a step untraced {ms[False]}, traced {ms[True]}: tracing "
            f"costs {100 * (sum(ms[True]) / sum(ms[False]) - 1):+.2f}%")


def telemetry_window(name, cell, spec, traffic, w, prof, spans) -> None:
    """Logs a traced window of phase telemetry: the device's idle time a
    step, split by the innermost span open at the launch that ended each
    gap (``tools.profiling.idle_gaps``, ``idle_by_span``), and the least
    delay, a second, from such a launch to its record's start as kineto
    maps it (the mapping's drift); the counts of the spans by name; the
    cell's per-layer metrics as the benchmark's readers read them."""
    from isaklm_raytracer_tpu_torch.tools import profiling
    from perfbench import core as bench
    from perfbench import trace as bench_trace

    records = bench_trace.device_records(prof)
    summary = bench_trace.summarize(records, w.steps, w.rays, traffic["kind"], w.units)
    gaps = profiling.idle_gaps(prof)
    split = profiling.idle_by_span(gaps, spans)
    least = {}
    for _, launch, start in gaps:
        if launch is not None:
            b = (start - records[0][1]) // 10**9
            least[b] = min(least.get(b, float("inf")), (start - launch) / 1e3)
    counts = collections.defaultdict(collections.Counter)
    for s in spans:
        counts[s.name]["spans"] += 1
        counts[s.name].update(s.counts)
    read = {m["name"]: bench.load_reader(m["name"])(summary)
            for m in bench.cell_metrics(spec, cell, "per_layer")}
    idle = summary.window_s - summary.busy_s
    log(f"telemetry {name}: {w.steps} steps in {summary.window_s:.3f} s traced, idle "
        f"{1e3 * idle / w.steps:.4f} ms a step ({1e3 * sum(g[0] for g in gaps) * 1e-9 / w.steps:.4f} "
        f"in {len(gaps)} gaps); by the innermost span at the launch that ended a gap, ms a step: "
        + ", ".join(f"{k or 'none'} {ns * 1e-6 / w.steps:.4f}"
                    for k, ns in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; the least launch-to-record delay a second, us "
        f"{[round(v, 1) for _, v in sorted(least.items())]}")
    log(f"telemetry {name}: counts {dict((k, dict(v)) for k, v in counts.items())}; "
        f"metrics {read}")


def main() -> int:
    global CARD, LANE_SLOTS_PER_S
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)

    from isaklm_raytracer_tpu_torch.accel import prepare_scene, with_mxu_blocks
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.cli import render as cli
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import (
        intersector_name,
        render,
        resolve_image,
    )
    from isaklm_raytracer_tpu_torch.kernels import build
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.scene import procedural
    from isaklm_raytracer_tpu_torch.scene.types import build_scene, MaterialTable

    start = time.perf_counter()
    with Phase("card"):
        card = CARD = card_line()
        clock_mhz = float(nvidia_smi("clocks.max.sm", ",nounits"))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        LANE_SLOTS_PER_S = sms * FP32_LANES_PER_SM * clock_mhz * 1e6
        log(f"card: {card}; {sms} SMs, max SM clock {clock_mhz:g} MHz: "
            f"{LANE_SLOTS_PER_S / 1e12:.2f}e12 FP32 issue slots a second")

    with Phase("build"):
        for source, (path, seconds, build_log) in build.build_all(ki.SOURCES, rebuild=True).items():
            ptxas = [ln.strip() for ln in build_log.splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"build: {source} -> {os.path.relpath(path, REPO)} in {seconds:.2f} s; "
                + "; ".join(ptxas))

    results = {}
    counts = ki.COUNTS
    rng = np.random.default_rng(42)
    defaults = RenderConfig()
    with Phase("kernel flat"):
        demo = prepare_scene(procedural.material_demo_scene(), device)
        soup_n = 6000  # 47 clusters, under the 64-cluster limit
        centers = rng.uniform(-4.0, 4.0, (soup_n, 1, 3)).astype(np.float32)
        soup_v = (centers + rng.uniform(-0.4, 0.4, (soup_n, 3, 3))).astype(np.float32)
        soup_b = procedural.SceneBuilder()
        soup_b.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.4, ior=1.0001)
        soup = prepare_scene(build_scene(
            soup_v, np.repeat(np.cross(soup_v[:, 1] - soup_v[:, 0],
                                       soup_v[:, 2] - soup_v[:, 0])[:, None], 3, axis=1),
            np.ones((soup_n, 3, 2), np.float32), np.zeros(soup_n, np.int32),
            MaterialTable.stack(soup_b.materials)), device)
        # the bench's 2048 rays, an odd count, and every ray count the
        # 512x512 main path gives the kernel, at the CLI's ray_chunk and in
        # one pass
        shapes = main_path_shapes(512 * 512, defaults.min_wavefront, (defaults.ray_chunk, 0))
        log(f"kernel flat: main path ray counts {shapes}")

        def flat_tables(scene):
            return (scene.cbvh.tri_const[: scene.cbvh.real_clusters],)

        def pair_tables(scene):
            return (scene.cbvh.mxu_tiles[: scene.cbvh.real_clusters],)

        # flat_mxu on the same rays: equal to its plain version and to flat
        errs = {}
        for label, scene, sizes in (("demo", demo, sorted({2048, 777, *shapes})),
                                    (f"soup{soup.cbvh.real_clusters}", soup, BENCH_RAYS)):
            errs.update(check_kernel(
                f"flat {label}", ki.flat_intersect, ki.flat_intersect_plain, flat_tables(scene),
                scene, rng, device, sizes,
                variants=[(f"flat_mxu {label}", ki.flat_mxu_intersect,
                           ki.flat_mxu_intersect_plain, pair_tables(scene))]))
        max_err = max(v for k, v in errs.items() if k.startswith("flat "))
        tri = flat_tables(demo)[0]
        verts = demo.vertices.reshape(-1, 3).cpu().numpy()
        o, d = random_rays(rng, 512 * 512, verts.min(axis=0), verts.max(axis=0), device)
        window = torch.tensor(rng.random(512 * 512).astype(np.float32) * 4.0, device=device)
        timing = {}
        for label, t_max in (("no t_max", None), ("t_max windows", window)):
            rays = ki.prep_rays(o, d, None, t_max)
            k_ms, p_ms, kout = time_in_turns(
                f"flat_intersect 262144 rays x {demo.cbvh.real_clusters} clusters, {label}",
                lambda: ki.flat_intersect(tri, rays, 1e-5),
                lambda: ki.flat_intersect_plain(tri, rays, 1e-5),
            )
            timing[label] = (k_ms, p_ms)
        flat_rays = ki.prep_rays(o, d)
        slots = demo.cbvh.real_clusters * 128

        def stage_line(label, rays, nbytes):
            """flat's staged walk on ``rays``, which must give the kernel's
            result; logs the pairs that reach each stage and returns the
            bound of the flat function on them."""
            staged = ki.flat_staged_plain(tri, rays, 1e-5)
            exact(f"flat {label}: kernel == its staged walk", ki.flat_intersect(tri, rays, 1e-5),
                  staged)
            b = bound(flat_slots(staged[2]), nbytes)
            stage_log(f"flat {label}, {rays.shape[0]} rays, kernel == its staged walk", staged[2],
                      b, bound(rays.shape[0] * slots * TRI_HIT_SLOTS, nbytes))
            return b

        flat_bound = stage_line("262144 random rays", flat_rays, 512 * 512 * 40 + tri.numel() * 4)
        results["flat"] = {"max_abs_err": max_err, "ms": timing["no t_max"][0],
                           "plain_ms": timing["no t_max"][1], **flat_bound,
                           "shape": f"262144 rays x {demo.cbvh.real_clusters} clusters (demo)"}
        # the demo's own wavefronts, in the order the render calls flat
        demo_sets, _ = main_path_rays(demo, np.random.default_rng(6), device, ki.nearest_hit_flat,
                                     512, 512)
        for kind, (o_w, d_w, t_w) in demo_sets.items():
            rays_w = morton(ki.prep_rays(o_w, d_w, None, t_w))
            time_in_turns(
                f"flat_intersect demo {kind} wavefront (Morton order), {rays_w.shape[0]} rays",
                lambda: ki.flat_intersect(tri, rays_w, 1e-5),
                lambda: ki.flat_intersect_plain(tri, rays_w, 1e-5), plain_reps=2, plain_warmup=1)
            stage_line(f"demo {kind} wavefront", rays_w, rays_w.shape[0] * 40 + tri.numel() * 4)
        card_test("test_torch_flat", "test_cuda_flat_kernel_on_coherent_and_edge_rays", "flat")

    with Phase("kernel flat_mxu"):
        tiles = pair_tables(demo)[0]
        unpacked = ki._mxu_unpack(tiles)
        m_ms, m_plain_ms, _ = time_in_turns(
            f"flat_mxu_intersect 262144 rays x {demo.cbvh.real_clusters} clusters",
            lambda: ki.flat_mxu_intersect(tiles, flat_rays, 1e-5),
            lambda: ki.flat_mxu_intersect_plain(tiles, flat_rays, 1e-5),
        )
        kernels_in_turns("flat and flat_mxu kernels, 262144 rays (demo)", {
            "flat": lambda: ki.flat_intersect(tri, flat_rays, 1e-5),
            "flat_mxu": lambda: ki.flat_mxu_intersect(tiles, flat_rays, 1e-5),
        })

        def mxu_stage_line(label, rays):
            """flat_mxu's staged walk (flat's, over the unpacked pairs) on
            ``rays``: the kernel's result and the flat tiles' stage counts;
            logs the pairs that reach each stage and returns the bound of
            the function on them (the pairs' bytes are twice the tiles')."""
            staged = ki.flat_staged_plain(unpacked, rays, 1e-5)
            exact(f"flat_mxu {label}: kernel == its staged walk",
                  ki.flat_mxu_intersect(tiles, rays, 1e-5), staged)
            if not torch.equal(staged[2], ki.flat_staged_plain(tri, rays, 1e-5)[2]):
                raise RuntimeError(f"flat_mxu {label}: stage counts differ from the tiles'")
            nbytes = rays.shape[0] * 40 + tiles.numel() * 4
            b = bound(flat_slots(staged[2]), nbytes)
            stage_log(f"flat_mxu {label}, {rays.shape[0]} rays, kernel == its staged walk",
                      staged[2], b, bound(rays.shape[0] * slots * TRI_HIT_SLOTS, nbytes))
            return b

        mxu_bound = mxu_stage_line("262144 random rays", flat_rays)
        # the demo's own wavefronts in the order the render calls flat_mxu
        # (the caller's: nearest_hit_flat_mxu does not sort)
        for kind, (o_w, d_w, t_w) in demo_sets.items():
            rays_w = ki.prep_rays(o_w, d_w, None, t_w)
            exact(f"flat_mxu demo {kind} wavefront (caller order)",
                  ki.flat_mxu_intersect(tiles, rays_w, 1e-5),
                  ki.flat_mxu_intersect_plain(tiles, rays_w, 1e-5))
            mxu_stage_line(f"demo {kind} wavefront (caller order)", rays_w)
            kernels_in_turns(
                f"flat and flat_mxu kernels, demo {kind} wavefront (caller order), "
                f"{rays_w.shape[0]} rays", {
                    "flat": lambda: ki.flat_intersect(tri, rays_w, 1e-5),
                    "flat_mxu": lambda: ki.flat_mxu_intersect(tiles, rays_w, 1e-5)})
        card_test("test_torch_flat", "test_cuda_flat_kernel_on_coherent_and_edge_rays",
                  "flat_mxu")
        mxu_err = max(v for k, v in errs.items() if k.startswith("flat_mxu"))
        results["flat_mxu"] = {"max_abs_err": mxu_err, "ms": m_ms, "plain_ms": m_plain_ms,
                               **mxu_bound,
                               "shape": f"262144 rays x {demo.cbvh.real_clusters} tile pairs "
                                        "(demo)"}

    with Phase("kernel queue"):
        hero20k = prepare_scene(procedural.hero_scene(20_000), device)
        soup700 = prepare_scene(procedural.triangle_soup(89_000, seed=3), device)
        for scene in (hero20k, soup700):
            if intersector_name(scene.cbvh) != "queue":
                raise RuntimeError(f"{scene.cbvh.num_clusters} clusters: not a queue scene")
        # The soup's 89k triangles fill a 20-unit cube densely, so some random
        # rays start within 1e-3 of a triangle: the strict gate holds on the
        # bench's scene, the soup gets the near-surface rule.
        queue_scenes = (("hero20k", hero20k, BENCH_RAYS),
                        (f"soup{soup700.cbvh.real_clusters}", soup700, ()))
        # hbm on the same rays: equal to its plain version and to queue
        q_errs = {}
        for label, scene, strict in queue_scenes:
            cb = scene.cbvh
            log(f"kernel queue {label}: {scene.num_triangles} triangles, "
                f"{cb.real_clusters} real clusters, table {cb.vmem_bytes / 2**20:.2f} MiB, "
                f"{cb.oct_bbox.shape[0]} octs of {cb.oct_branch}")
            q_errs.update(check_kernel(
                f"queue {label}", ki.queue_intersect, ki.queue_intersect_plain,
                (cb.clu_bbox_t, cb.tri_const), scene, rng, device, BENCH_RAYS, strict,
                variants=[(f"hbm {label}",
                           functools.partial(ki.hbm_intersect, oct_branch=cb.oct_branch),
                           functools.partial(ki.hbm_intersect_plain, oct_branch=cb.oct_branch),
                           (cb.oct_bbox_t, cb.tri_const))],
                walk=ki.queue_walk_plain))
        card_test("test_torch_walk", "test_cuda_walk_kernels_equal_walk_plain", "queue")
        worst = max(v for k, v in q_errs.items() if k.startswith("queue"))
        verts = soup700.vertices.reshape(-1, 3).cpu().numpy()
        o, d = random_rays(rng, 512 * 512, verts.min(axis=0), verts.max(axis=0), device)
        rays = ki.prep_rays(o, d)
        tables = (soup700.cbvh.clu_bbox_t, soup700.cbvh.tri_const)
        q_ms, q_plain_ms, qout = time_in_turns(
            f"queue_intersect 262144 rays x {soup700.cbvh.num_clusters} clusters",
            lambda: ki.queue_intersect(*tables, rays, 1e-5),
            lambda: ki.queue_intersect_plain(*tables, rays, 1e-5),
            plain_reps=2, plain_warmup=1,
        )
        num_c = soup700.cbvh.num_clusters

        def queue_walk(r, stages=False):
            return ki.queue_walk_plain(*tables, r, 1e-5, stages)

        qstats = ki.queue_intersect(*tables, rays, 1e-5, stats=True)
        plain_walk, pairs = walk_stage_counts(queue_walk, rays)
        exact_walk("queue soup 262144 rays", qstats, plain_walk)
        sums = qstats[2].long().sum(dim=0).tolist()
        log(f"kernel queue soup: 262144 rays equal to the plain walk in (t, id, stats); sums: "
            f"clusters visited {sums[0]}, clusters intersected {sums[1]}")
        oct_tables = (soup700.cbvh.oct_bbox_t, soup700.cbvh.tri_const)
        kernels_in_turns("queue and hbm kernels, 262144 soup rays", {
            "queue": lambda: ki.queue_intersect(*tables, rays, 1e-5),
            "hbm": lambda: ki.hbm_intersect(*oct_tables, rays, 1e-5, soup700.cbvh.oct_branch)})
        # the bound: one slab test per ray and valid cluster (the entry
        # pass) and the flat stages' count of the clusters the walk
        # intersected; the rays, results, boxes and the winners' tiles
        valid = int((tables[0][6, :num_c] > 0).sum())
        won = qout[1][qout[1] != _BIG_ID]
        nbytes = rays.shape[0] * 40 + 7 * num_c * 4 + torch.unique(won // 128).numel() * TILE_BYTES
        boxes = rays.shape[0] * valid * SLAB_SLOTS
        q_bound = bound(flat_slots(pairs) + boxes, nbytes)
        stage_log("queue soup 262144 rays", pairs, q_bound,
                  bound(sums[1] * 128 * TRI_HIT_SLOTS + boxes, nbytes))
        results["queue"] = {"max_abs_err": worst, "ms": q_ms, "plain_ms": q_plain_ms, **q_bound,
                            "shape": f"262144 rays x {num_c} clusters (soup near 6 MB), "
                                     f"{sums[1] / rays.shape[0]:.2f} clusters intersected a ray"}
        del soup700, queue_scenes, tables, oct_tables, rays, qstats, plain_walk

        # the 20k hero's own wavefronts, in the order the render calls queue
        h_tables = (hero20k.cbvh.clu_bbox_t, hero20k.cbvh.tri_const)
        h_sets, _ = main_path_rays(hero20k, np.random.default_rng(7), device, ki.nearest_hit_queue,
                                  512, 512, eye=GOLDEN_EYE, pitch=0.0)
        for kind, (o_w, d_w, t_w) in h_sets.items():
            rays_w = morton(ki.prep_rays(o_w, d_w, None, t_w))
            k_ms, kout = cuda_ms(lambda: ki.queue_intersect(*h_tables, rays_w, 1e-5, stats=True))
            exact_walk(f"queue hero20k {kind} wavefront", kout,
                       ki.queue_walk_plain(*h_tables, rays_w, 1e-5))
            sums = kout[2].long().sum(dim=0).tolist()
            log(f"time queue_intersect hero20k {kind} wavefront (Morton order), kernel alone, "
                f"{rays_w.shape[0]} rays: {k_ms:.3f} ms; equal to the plain walk in (t, id, "
                f"stats); sums: clusters visited {sums[0]}, clusters intersected {sums[1]}")

        # the main path: render of the 20k hero at 512x512x8 in one pass
        camera20k = Camera.create(GOLDEN_EYE, fov=np.pi / 2, device=device)
        config = RenderConfig(width=512, height=512, max_bounces=8, ray_chunk=0)
        with device_launches(counts) as ran:
            render(hero20k, camera20k, config, num_samples=4, seed=0)
        queue_launches = check_only(counts, "queue", "render of hero20k 512x512x8 ray_chunk 0 "
                                    "(4 samples)", ran)
        sec = sample_seconds(render, hero20k, camera20k, config)
        n, busy_s, span_s, mine_n, mine_s = profile_sample(render, hero20k, camera20k, config,
                                                           kernel_symbol("queue"))
        rays_n = config.num_pixels * config.max_bounces * 2
        log(f"main path queue, render of hero20k 512x512x8 ray_chunk 0: {sec:.4f} s/sample "
            f"(two after a warm-up; {rays_n / sec / 1e6:.3f} M rays/s); one profiled sample: "
            f"{n} CUDA records, device kernel time {busy_s:.4f} s in a device span of "
            f"{span_s:.4f} s (busy {busy_s / span_s:.1%}); queue_intersect {mine_n} launches, "
            f"{mine_s * 1e3:.2f} ms = {mine_s / busy_s:.1%} of device kernel time")

    with Phase("kernel blk"):
        t0 = time.perf_counter()
        hero = prepare_scene(procedural.hero_scene(), device)
        torch.cuda.synchronize()
        cbvh = hero.cbvh
        log(f"hero: {hero.num_triangles} triangles, {cbvh.real_clusters} real clusters, "
            f"blk_const {tuple(cbvh.blk_const.shape)} = {cbvh.blk_const.numel() * 4 / 2**20:.1f} "
            f"MiB, blk_bbox_t {tuple(cbvh.blk_bbox_t.shape)}, oct_bbox_t "
            f"{tuple(cbvh.oct_bbox_t.shape)} ({cbvh.oct_bbox.shape[0]} octs), intersector "
            f"{intersector_name(cbvh)}, built and moved in {time.perf_counter() - t0:.1f} s")
        if intersector_name(cbvh) != "blk":
            raise RuntimeError("the hero scene does not pick the blk intersector")
        sets, lifted = main_path_rays(hero, rng, device)

        def blk_walk(r, stats=False):
            return ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, r, 1e-5, stats)

        worst, b_ms, b_plain_ms, b_count, _, b_bound = check_walk_hero(
            "blk", blk_walk, lambda r: ki.blk_intersect_plain(cbvh.blk_bbox_t, cbvh.blk_const, r,
                                                              1e-5),
            lambda r, stages=False: ki.blk_walk_plain(cbvh.blk_bbox_t, cbvh.blk_const, r, 1e-5,
                                                      stages),
            functools.partial(ki.nearest_hit_blk, cbvh), hero, sets, lifted, cbvh.blk_bbox_t,
            cbvh.blk_branch, TILE_BYTES, TILE_BYTES)
        results["blk"] = {"max_abs_err": worst, "ms": b_ms, "plain_ms": b_plain_ms, **b_bound,
                          "shape": f"{b_count} camera rays x {cbvh.blk_const.shape[0]} blocks "
                                   "(hero 2M)"}

    with Phase("kernel hbm"):
        # a padded table: the row-15 boxes of its pad clusters are inverted
        # and pierced by every ray; the kernel skips them, so no ray counts
        # more clusters intersected than the real ones it pierces
        padded = prepare_scene(procedural.triangle_soup(1200, seed=5), device)
        pc = padded.cbvh
        verts = padded.vertices.reshape(-1, 3).cpu().numpy()
        o, d = random_rays(np.random.default_rng(5), 2048, verts.min(axis=0), verts.max(axis=0),
                           device)
        rays = ki.prep_rays(o, d)
        _, _, pstats = ki.hbm_intersect(pc.oct_bbox_t, pc.tri_const, rays, 1e-5, pc.oct_branch,
                                        stats=True)
        pierced = ki._pierce(pc.clu_bbox_t[:, :pc.num_clusters], rays, 1e-5).sum(dim=1)
        log(f"kernel hbm soup{pc.real_clusters} of {pc.num_clusters} clusters, 2048 rays: clusters "
            f"intersected per ray max {int(pstats[:, 1].max())}, mean "
            f"{float(pstats[:, 1].float().mean()):.3f}; real clusters pierced per ray max "
            f"{int(pierced.max())}")
        if (pstats[:, 1] > pierced).any():
            raise RuntimeError("hbm counted a pad cluster")

        def hbm_walk(r, stats=False):
            return ki.hbm_intersect(cbvh.oct_bbox_t, cbvh.tri_const, r, 1e-5, cbvh.oct_branch,
                                    stats)

        worst_h, h_ms, h_plain_ms, h_count, _, h_bound = check_walk_hero(
            "hbm", hbm_walk,
            lambda r: ki.hbm_intersect_plain(cbvh.oct_bbox_t, cbvh.tri_const, r, 1e-5,
                                             cbvh.oct_branch),
            lambda r, stages=False: ki.hbm_walk_plain(cbvh.oct_bbox_t, cbvh.tri_const, r, 1e-5,
                                                      cbvh.oct_branch, stages),
            functools.partial(ki.nearest_hit_hbm, cbvh), hero, sets, lifted, cbvh.oct_bbox_t,
            cbvh.oct_branch, TILE_BYTES, 0, wavefront_reps=5)
        results["hbm"] = {"max_abs_err": max(worst_h, *(v for k, v in q_errs.items()
                                                        if k.startswith("hbm"))), "ms": h_ms, "plain_ms": h_plain_ms,
                          **h_bound, "shape": f"{h_count} camera rays x "
                                              f"{cbvh.oct_bbox.shape[0]} octs of "
                                              f"{cbvh.oct_branch} (hero 2M)"}

    with Phase("kernel blk_mxu"):
        t0 = time.perf_counter()
        hero_mxu = hero.replace(cbvh=with_mxu_blocks(cbvh, cbvh.blk_branch))
        mcb = hero_mxu.cbvh
        torch.cuda.synchronize()
        log(f"hero MXU blocks: mxu_const {tuple(mcb.mxu_const.shape)} = "
            f"{mcb.mxu_const.numel() * 4 / 2**20:.1f} MiB, built and moved in "
            f"{time.perf_counter() - t0:.1f} s")

        def mxu_walk(r, stats=False):
            return ki.blk_mxu_intersect(mcb.blk_bbox_t, mcb.mxu_const, r, 1e-5, stats)

        worst, x_ms, x_plain_ms, x_count, _, x_bound = check_walk_hero(
            "blk_mxu", mxu_walk,
            lambda r: ki.blk_mxu_intersect_plain(mcb.blk_bbox_t, mcb.mxu_const, r, 1e-5),
            lambda r, stages=False: ki.blk_mxu_walk_plain(mcb.blk_bbox_t, mcb.mxu_const, r,
                                                          1e-5, stages),
            functools.partial(ki.nearest_hit_blk_mxu, mcb), hero_mxu, sets, lifted,
            mcb.blk_bbox_t, mcb.mxu_branch, 2 * TILE_BYTES, TILE_BYTES)
        for kind, (o, d, t_max) in sets.items():
            rays = ki.prep_rays(o, d, None, t_max)
            exact(f"blk_mxu == blk, hero {kind}", mxu_walk(rays), blk_walk(rays))
            log(f"kernel blk_mxu hero {kind}: {rays.shape[0]} rays equal to the blk kernel's "
                "bit for bit")
        rays = ki.prep_rays(*sets["camera"][:2])
        kernels_in_turns(f"blk and blk_mxu kernels, hero {rays.shape[0]} camera rays", {
            "blk": lambda: blk_walk(rays), "blk_mxu": lambda: mxu_walk(rays)})
        results["blk_mxu"] = {"max_abs_err": worst, "ms": x_ms, "plain_ms": x_plain_ms,
                              **x_bound, "shape": f"{x_count} camera rays x "
                                                  f"{mcb.mxu_const.shape[0]} MXU blocks (hero 2M)"}

    with Phase("kernel first_blocks"):
        k_err, k_ms, k_plain_ms, argsort_ms, k_bound = check_first_blocks(hero, sets, rng, device)
        # the keys' device time in one profiled hero sample under block order
        os.environ["ISAKLM_BLK_SORT"] = "block"
        n, busy_s, _, mine_n, mine_s = profile_sample(
            render, hero, Camera.create(BENCH_EYE, pitch=BENCH_PITCH, fov=np.pi / 2,
                                        device=device),
            RenderConfig(width=HERO_W, height=HERO_H, max_bounces=HERO_BOUNCES, ray_chunk=0),
            "first_block_keys_kernel")
        os.environ["ISAKLM_BLK_SORT"] = "morton"
        log(f"profile hero {HERO_W}x{HERO_H}x{HERO_BOUNCES} ray_chunk 0 under "
            f"ISAKLM_BLK_SORT=block: first_block_keys {mine_n} launches, {mine_s * 1e3:.4f} ms "
            f"a sample = {mine_s / busy_s:.2%} of {busy_s * 1e3:.2f} ms of device kernel time "
            f"({n} CUDA records)")
        results["first_blocks"] = {
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain_ms, **k_bound,
            "shape": f"{HERO_W * HERO_H} camera rays x {cbvh.blk_bbox_t.shape[1]} block columns "
                     f"(hero; the stable argsort of the keys {argsort_ms:.4f} ms)"}

    with Phase("fixed cost"):
        results["null"], null_launches = fixed_cost(hero, counts, card)

    with Phase("ordering"):
        check_ordering(hero, sets, card)
        camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
        for label, scene, fn, modes, (w, h, b) in (
            ("demo", demo, ki.nearest_hit_flat, ORDERINGS[:2], (512, 512, 8)),
            ("hero", hero, ki.nearest_hit_blk, ORDERINGS, (HERO_W, HERO_H, HERO_BOUNCES)),
        ):
            config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
            per = {}
            for mode in modes + modes[::-1]:
                trace = functools.partial(fn, scene.cbvh, t_eps=config.t_epsilon, sort_rays=mode)
                per.setdefault(mode, []).append(ordered_step_seconds(scene, camera, config, trace))
            log(f"ordering {label} {w}x{h}x{b} ray_chunk 0, s/sample: " + "; ".join(
                f"{order_name(m)} {per[m][0]:.4f}/{per[m][1]:.4f}" for m in modes)
                + f" on {card}")
        render_calls_by_order(hero, camera, RenderConfig(
            width=HERO_W, height=HERO_H, max_bounces=HERO_BOUNCES, ray_chunk=0), card)

    with Phase("goldens"):
        for name, scene_fn, cam, spp, res, bounces in (
            ("cornell_64", lambda: procedural.cornell_box(glossy=True),
             Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device=device), 4, 64, 4),
            ("demo_textured_64", lambda: procedural.material_demo_scene(textured=True),
             Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device), 2, 64, 4),
            ("hero_small_32", lambda: procedural.hero_scene(20_000),
             Camera.create((0.0, 2.0, -6.0), fov=np.pi / 2, device=device), 2, 32, 3),
        ):
            config = RenderConfig(width=res, height=res, max_bounces=bounces, ray_chunk=0,
                                  min_samples=1)
            images = []  # the card's, then the port's on the CPU
            for dev in (device, torch.device("cpu")):
                scene = prepare_scene(scene_fn(), dev)
                meter = device_launches(counts) if dev is device else contextlib.nullcontext()
                with meter as ran:
                    gb = render(scene, cam.to(dev), config, num_samples=spp, seed=11)
                images.append(resolve_image(gb, config).cpu().numpy())
                if dev is device and name == "hero_small_32":
                    check_only(counts, "queue", "queue (render of hero_small_32)", ran)
            got = images[0]
            with np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz")) as f:
                want = f["image"]
            err = np.abs(got - want)
            over = int((err > GOLDEN_ATOL).sum())
            vs_cpu = np.abs(got - images[1])
            log(f"golden {name}: max abs err {err.max():.3e}, values over {GOLDEN_ATOL:g}: "
                f"{over} of {err.size}, mean abs err {err.mean():.3e}; card vs the port on "
                f"the CPU: max {vs_cpu.max():.3e}, values over {GOLDEN_ATOL:g}: "
                f"{int((vs_cpu > GOLDEN_ATOL).sum())}")
            if not np.isfinite(got).all() or over > GOLDEN_OUTLIERS or err.max() > GOLDEN_MAX:
                raise RuntimeError(f"golden {name} drifted beyond its tolerance")

    with Phase("main path"):
        main_path_runs = len(SAMPLER_RUNS)
        os.makedirs(OUT_DIR, exist_ok=True)
        demo_argv = ["--scene", "demo", "--width", "512", "--height", "512",
                     "--max-bounces", "8", "--min-samples", "4", "--max-samples", "8",
                     "--camera", "0", "1.2", "-1.8", "0", "0.15"]
        hero_argv = ["--scene", "hero", "--width", str(HERO_W), "--height", str(HERO_H),
                     "--max-bounces", str(HERO_BOUNCES), "--min-samples", "1",
                     "--max-samples", "1", "--camera", "0", "1.2", "-1.8", "0", "0.15"]
        flat_launches, flat_png = cli_path("flat", counts, (
            ("demo", demo_argv),
            # the CLI's default 24 bounces cut to 8: the profiler that
            # counts the kernels run holds every kernel record of the run
            ("cornell", ["--scene", "cornell", "--width", "512", "--height", "512",
                         "--max-bounces", "8", "--min-samples", "1", "--max-samples", "2"]),
        ), "flat", cli)
        flat_mxu_launches, png = cli_path("flat_mxu", counts, (("demo_flat_mxu", demo_argv),),
                                          "flat_mxu", cli, override="flat_mxu")
        same_image("CLI demo under ISAKLM_INTERSECTOR=flat_mxu", png["demo_flat_mxu"],
                   flat_png["demo"])
        blk_launches, blk_png = cli_path("blk", counts, (("hero", hero_argv),), "blk", cli)
        hbm_launches, png = cli_path("hbm", counts, (("hero_hbm", hero_argv),), "hbm", cli,
                                     override="hbm")
        same_image("CLI hero under ISAKLM_INTERSECTOR=hbm", png["hero_hbm"], blk_png["hero"])
        # render() of the hero with MXU blocks, under blk_mxu and the auto rule (blk)
        camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
        config = RenderConfig(width=HERO_W, height=HERO_H, max_bounces=HERO_BOUNCES, ray_chunk=0)
        images = {}
        for name, kernel in (("blk_mxu", "blk_mxu"), (None, "blk")):
            with device_launches(counts) as ran:
                t0 = time.perf_counter()
                with intersector_env(name):
                    gb = render(hero_mxu, camera, config, num_samples=2, seed=0)
                torch.cuda.synchronize()
                log(f"render hero with MXU blocks under {name or 'the auto rule'}: 2 samples in "
                    f"{time.perf_counter() - t0:.2f} s under torch.profiler")
            launches = check_only(counts, kernel, f"render of the hero under {name or 'auto'}",
                                  ran)
            images[name] = resolve_image(gb, config).cpu().numpy()
            if name is not None:
                blk_mxu_launches = launches
        same_image("render of the hero under ISAKLM_INTERSECTOR=blk_mxu", images["blk_mxu"],
                   images[None])
        # the sampler runs on every path: its launches over the main path's runs
        sampler_launches = tuple(sum(run[i] for run in SAMPLER_RUNS[main_path_runs:])
                                 for i in (1, 2))
        log(f"main path: the sampler kernel ran {sampler_launches[0]} times on the card over its "
            f"{len(SAMPLER_RUNS) - main_path_runs} paths ({sampler_launches[1]} launched by its "
            "wrapper)")
        # and the shading kernels, one launch each a bounce on every path
        shade_launches = {k: tuple(sum(run[i] for run in SAMPLER_RUNS[main_path_runs:])
                                   for i in (j, j + 1))
                          for k, j in zip(SHADE_KERNELS, (3, 5))}
        log(f"main path: the shading kernels ran {shade_launches['shade'][0]} (shade_bounce) and "
            f"{shade_launches['shade_finish'][0]} (finish_bounce) times on the card over its paths "
            f"({shade_launches['shade'][1]}, {shade_launches['shade_finish'][1]} launched by "
            "their wrappers)")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        with Phase("assets"):
            phase_assets(cli, counts, demo_argv, hero_argv, flat_png["demo"], blk_png["hero"],
                         tmp)
        with Phase("resume"):
            with device_launches(counts) as ran:
                phase_resume(cli, counts, demo_argv, tmp)
            check_only(counts, "flat", "resume and retry of the demo", ran)
        with Phase("interactive"):
            with device_launches(counts) as ran:
                phase_interactive(demo, counts, device)
            check_only(counts, "flat", "interactive session on the demo", ran)
        with Phase("sharded"):
            phase_sharded(cli, counts, {"demo": demo, "hero20k": hero20k, "hero": hero}, device,
                          tmp)

    with Phase("kd"):
        phase_kd(cli, counts, device, demo_argv, results)

    with Phase("graphs"):
        phase_graphs(counts, device, {"demo": demo, "hero20k": hero20k, "hero": hero})

    with Phase("perf"):
        camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
        perf("demo", render, demo, camera, 512, 512, 8, counts, kernel_symbol("flat"), card)
        hero_s = perf("hero", render, hero, camera, HERO_W, HERO_H, HERO_BOUNCES, counts,
                      kernel_symbol("blk"), card)
        log(f"hero s/sample: ray_chunk 0 {hero_s[0]}, ray_chunk {defaults.ray_chunk} "
            f"{hero_s[defaults.ray_chunk]} on {card}")
        perf_overrides("demo", demo, camera, 512, 512, 8, ["flat", "flat_mxu"], counts, card)
        perf_overrides("hero", hero_mxu, camera, HERO_W, HERO_H, HERO_BOUNCES,
                       ["blk", "blk_mxu", "hbm"], counts, card)
        hero_mxu_ref = weakref.ref(hero_mxu)
        del hero_mxu, mcb

    with Phase("grad"):
        # bench.py's fwd+bwd (loss = mean(render_sample), leaf = albedo)
        # through the entry points, counts zeroed just before each run
        gc.collect()
        log(f"grad: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated and "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved before the runs (the demo's "
            f"and the hero's graphs cached); the hero with MXU blocks "
            f"{'freed with its graphs' if hero_mxu_ref() is None else 'still alive'}")
        bwd_launches = bin_launches = 0  # the backward's kernels, over the fwd+bwd runs (eager)
        for label, scene, (w, h, b), chunks, sort in (
            ("demo", demo, (512, 512, 8), (0, defaults.ray_chunk), "morton"),
            ("hero", hero, (HERO_W, HERO_H, HERO_BOUNCES), (0, defaults.ray_chunk), "morton"),
            ("hero ISAKLM_BLK_SORT=block", hero, (HERO_W, HERO_H, HERO_BOUNCES), (0,), "block"),
        ):
            os.environ["ISAKLM_BLK_SORT"] = sort
            for chunk in chunks:
                config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=chunk)
                out = fwd_and_fwd_bwd(label, scene, camera, config, counts, card,
                                      samples=1 if chunk else 2)
                kernel = "flat" if label == "demo" else "blk"
                if out["launches"][kernel] == 0:
                    raise RuntimeError(f"grad {label}: the {kernel} kernel did not launch")
                bwd_launches += out["launches"]["shade_backward"]
                bin_launches += out["launches"]["shade_bin"]
                if sort == "block":
                    first_blocks_launches = (out["launches"]["first_blocks"],) * 2  # eager
                    if first_blocks_launches[0] == 0:
                        raise RuntimeError("block ordering did not launch first_block_keys")
        os.environ["ISAKLM_BLK_SORT"] = "morton"
        for label, kernel, scene, (w, h, b) in (
                ("demo", "flat", demo, (512, 512, 8)),
                ("hero", "blk", hero, (HERO_W, HERO_H, HERO_BOUNCES))):
            profile_fwd_bwd(label, kernel, scene, camera,
                            RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0), counts,
                            card)
        grad_checks_on_card(device, counts, card)

    with Phase("sampler"):
        phase_sampler(counts, device, {"demo": demo, "hero": hero}, results)

    with Phase("shade"):
        phase_shade(device, {"demo": demo, "hero": hero, "hero20k": hero20k}, results)

    with Phase("shade_grad"):
        phase_shade_grad(device, {"demo": demo, "hero": hero, "hero20k": hero20k}, results)

    with Phase("telemetry"):
        phase_telemetry(device)

    log(f"chip_smoke: {time.perf_counter() - start:.1f} s wall in all")
    launches = {"flat": flat_launches, "queue": queue_launches, "blk": blk_launches,
                "first_blocks": first_blocks_launches, "hbm": hbm_launches,
                "flat_mxu": flat_mxu_launches, "blk_mxu": blk_mxu_launches,
                "null": (null_launches,) * 2, "kd": results["kd"]["launches"],
                "brute": results["brute"]["launches"], "sampler": sampler_launches,
                "tri_consts": results["tri_consts"]["launches"], **shade_launches,
                "shade_backward": (bwd_launches,) * 2,  # the grad phase's fwd+bwd, eager
                "shade_bin": (bin_launches,) * 2}
    # the CUDA kernel of each entry and the TPU kernel it replaces
    pallas = "isaklm_raytracer_tpu/kernels/intersect.py:"
    kernels = {
        "flat": ("flat_intersect", pallas + "521"),  # _flat_kernel
        "queue": ("queue_intersect", pallas + "349"),  # _vmem_kernel
        "blk": ("blk_intersect", pallas + "592"),  # _blk_kernel
        "first_blocks": ("first_block_keys", pallas + "949"),  # _first_blocks_kernel
        "hbm": ("hbm_intersect", pallas + "390"),  # _hbm_kernel
        "flat_mxu": ("flat_mxu_intersect", pallas + "557"),  # _flat_mxu_kernel
        "blk_mxu": ("blk_mxu_intersect", pallas + "643"),  # _blk_kernel's mxu branches
        # null_kernel; null_small's lambda (:143) is the same kernel without scratch
        "null": ("null_intersect", "scripts/fixed_cost_probe.py:99"),
        # no Pallas kernel: the jnp functions they compute
        "kd": ("kd_intersect", "isaklm_raytracer_tpu/accel/wavefront.py:165"),
        "brute": ("brute_intersect", "isaklm_raytracer_tpu/accel/traverse.py:73"),
        "sampler": ("threefry_uniforms", "isaklm_raytracer_tpu/math/rng.py:72"),
        # the KD walk's triangle terms (_intersect_chunk), formed once a scene
        "tri_consts": ("tri_consts", "isaklm_raytracer_tpu/accel/wavefront.py:121"),
        # the bounce body of the lax.scan (bounce_step): its shading up to
        # the NEE call, and after it
        "shade": ("shade_bounce", "isaklm_raytracer_tpu/integrator/path_trace.py:61"),
        "shade_finish": ("finish_bounce", "isaklm_raytracer_tpu/integrator/path_trace.py:61"),
        # the reverse of that body (jax.grad through the lax.scan)
        "shade_backward": ("bounce_backward",
                           "isaklm_raytracer_tpu/integrator/path_trace.py:61"),
        # its binning pass, which sorts the rays by lobe for that reverse
        "shade_bin": ("bounce_bin", "isaklm_raytracer_tpu/integrator/path_trace.py:61"),
    }
    # the source of each kernel that is not csrc/<name>.cu
    sources = {"finish_bounce": "shade_bounce", "bounce_backward": "shade_backward",
               "bounce_bin": "shade_backward"}
    for k, r in results.items():
        log(f"kernels line, {kernels[k][0]}: ms and plain_ms at {r['shape']}; launches: the "
            f"kernels the card ran in its main-path run, measured by torch.profiler where the "
            f"run replays CUDA graphs ({launches[k][0]}), wrapper_launches: its wrapper's count "
            f"there, eager launches and those recorded into a graph ({launches[k][1]}); "
            f"max_abs_err over every kernel-vs-plain comparison; bound {r['ops']:.4g} "
            f"operations, {r['bytes']:.4g} bytes")
        if launches[k][1] == 0:
            raise RuntimeError(f"{kernels[k][0]}: its wrapper launched nothing on its main path")
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"isaklm_raytracer_tpu_torch/csrc/{sources.get(name, name)}.cu",
        "replaces": replaces,
        "launches": launches[k][0],
        "wrapper_launches": launches[k][1],
        "max_abs_err": results[k]["max_abs_err"],
        "ms": results[k]["ms"],
        "plain_ms": results[k]["plain_ms"],
        "bound_ms": results[k]["bound_ms"],
        "bound_by": results[k]["bound_by"],
        # no PyTorch call computes a nearest hit, a block key, Threefry-2x32
        # (torch's generators are Philox) or a bounce's shading
        "library_ms": None,
    } for k, (name, replaces) in kernels.items()]}), name_card=False)
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), name_card=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())

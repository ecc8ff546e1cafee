#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tinynerf_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It

1. prints the card (name, count, and ``nvidia-smi``'s name and power limit);
2. builds every CUDA kernel from ``tinynerf_torch/csrc`` (one ``nvcc`` per
   source, all at once) and prints each build's time and ``ptxas``'
   register/shared-memory report, and each kernel's count of tensor-core
   instructions (``HMMA``/``HGMMA``) in its SASS (``cuobjdump -sass``):
   above 0 in every bf16 form of the field kernels (1-4, 9, 10), the grid
   kernels (5, 6) and the proposal MLP's (7, 8), whose products run on the
   tensor cores, and 0 in their fp32 forms; it also builds kernels 6, 8 and
   9 with their phase clocks (``GRID_PHASE_CLOCKS``, ``PROP_PHASE_CLOCKS``,
   ``RENDER_PHASE_CLOCKS``, libraries of their own that only phase 4 reads),
   kernel 9 with its weight probe (``FIELD_TC_WEIGHT_PROBE``, phase 4) and
   kernel 8 without its
   fix-up (``PROP_NO_FIXUP``, whose errors phase 3 prints for the record);
3. holds each kernel form against its plain PyTorch version on the card, on
   dyadic inputs at the main paths' shapes (tolerances below): the field
   forward (kernel 1) at the render chunk's B=4096, and the field's
   recompute backward (kernel 2) at the training step's B=400 and at
   B=4096, N=64 and 128, every gradient within 1e-4 of max|plain|; the flat
   field forward (kernel 3) at fp32 and bf16 at one grid refresh's R=32,768
   probes, at R=65,536 and at a ragged R; kernels 1 and 2 in their bf16 form
   at B=4096, N=64 and 128, and at B=1001, N=37, whose rows are no multiple
   of 16 or of the 64-row tile (bf16 bounds below; there the backward's rows
   within 2e-6 of a kink in the bf16 form take no cotangent, as kernel 4's);
4. times each kernel form and its plain version with CUDA events, beside
   the kernel's bound (the least time the card could take for the same
   work: float32 FLOPs at the FMA rate, bf16 ones at the tensor cores'
   rate; the f32 FMA bound is printed for the bf16 forms too); beside kernel
   1 bf16 also ``gemm_chain_ms``, ``torch.matmul`` in bf16 over the same
   twelve layer products at M = 524,288 rows (a yardstick, not the same
   function, never called by the port), and beside kernel 2 fp32
   ``bwd_gemm_chain_ms_fp32``, ``torch.matmul`` in float32 over the
   backward's 36 layer products at M = 51,200 rows (a yardstick likewise);
   prints kernel 2 fp32's time by launch at B=400 and B=4096, N=128
   (``launch_split``: the transpose, the recompute + input gradients, the
   per-ray sums, the weight gradients, the reduce); profiles one call each
   of kernels 2 and 4 in bf16 (the recompute / weight-gradient split);
5. drives the training path: ``conf/lego.ini`` at full width from fresh
   seeded weights on an in-memory Blender-style scene of 4 views of
   800x800 (lego has 100 training views: cut to 4), ``Runner.train()`` for
   200 steps (below ``STEP``, so that no preview JPG is written and
   imageio is not needed). Checks 2 forward and 2 backward kernel launches
   per step, a finite loss on every step and a falling loss; times steps
   at ``BATCH_RAY`` 400 and 4096 (s/step, rays/s, the kernels' share);
   traces five steps at 400 with ``torch.profiler`` (device time by
   kernel, the device's busy share of the steps' wall time); holds one
   step's gradient through the kernels against the plain field's on a
   field with content (cosine >= 0.9999); saves the trained state with
   ``ckpt.save_checkpoint``;
6. drives the render path from that checkpoint: ``Runner`` resumes it and
   renders two 800x800 views at 64 + 128 samples through
   ``eval.render_test_set``; checks the forward kernel's launch count, that
   the frames are finite and in [0, 1], and that a chunk rendered through
   the kernel agrees with the same chunk through the plain field;
7. drives the ``conf/lego_occ.ini`` training path (bf16, 4096 rays, the
   occupancy grid with a partial refresh every 256 steps, white
   background) on the same kind of scene: ``Runner.train()`` for 300 steps
   (two calls, 256 + 44, so that the grid after each refresh is read).
   Checks exactly 2 flat-kernel launches (the refreshes at 0 and 256), 2
   forward and 2 backward field launches per step, a finite falling loss;
   prints the share of cells probed and occupied after each refresh,
   s/step and rays/s, the refresh's own time, a ``torch.profiler``
   breakdown of five steps; holds one step's gradient through the bf16
   kernels against the bf16 plain field's (cosine >= 0.999); saves the
   trained state with its grid;
8. drives the ``lego_occ`` render path from that checkpoint: ``Runner``
   resumes params and grid and renders two 800x800 views with the grid;
   checks the launch counts, the frames, and a real chunk rendered through
   the bf16 kernels against the bf16 plain field; times the grid's march
   (``tighten_bounds``) on one chunk;
9. drives ``conf/lego_occ.ini`` at ``PRECISION=fp32``, cut to 10 steps
   (one refresh, at iteration 0): the fp32 form of kernel 3 on a training
   path; checks the launch counts and a finite loss;
10. drives ``conf/lego_grid.ini`` with ``GRID_PALLAS`` (the CP grid field at
   R = 256, 64 + 64 components, decoder width 128; the proposal grid at R =
   64, 16 + 16, width 16; bf16, 4096 rays, 64 + 128 samples, the occupancy
   grid, WHITE_BKGD, GRID_LR_MULT 20, GRID_TV 0.1) from fresh seeded
   weights on the same kind of scene: ``Runner.train()`` for 300 steps (256
   + 44). Checks exactly 600 forward and 600 backward grid-kernel launches
   (one of each per grid per step), no MLP kernel launch (the refreshes at
   0 and 256 run the plain point field, as in the JAX package), a finite
   falling loss; prints s/step, rays/s and a profile of five steps; holds
   one step's gradient through kernels 5 and 6 against the plain versions
   (``grid_rays_reference``) on a grid with content, cosine >= 0.999 for
   each of the net's and the proposal's lines and decoder; saves the state;
11. renders two 800x800 views from that checkpoint with the grid: exactly
   2 x 157 x 2 forward launches, finite frames in [0, 1], a chunk through
   the kernels against the plain versions (1e-3 per pixel), s/frame and a
   profile of rendered chunks;
12. drives ``lego_grid`` at ``PRECISION=fp32`` for 10 steps (the fp32 forms
   of kernels 5 and 6 on a path) and ``conf/lego_fast.ini`` with
   ``GRID_PALLAS`` for 10 steps (the MLP fine field through kernels 1-2,
   the proposal grid through kernels 5-6, the refresh at 0 through kernel
   3), checking the launch counts and finite losses;
12b. drives the flagship, ``conf/lego_hybrid.ini`` (the fine grid at R =
   384, 64 + 64 components, decoder width 128 and the sigma net
   (``GRID_HYBRID``); the proposal grid with its own (``PROP_GRID_HYBRID``);
   bf16, 4096 rays, 64 + 128 samples, the occupancy grid), in plain PyTorch,
   since the JAX package runs it in XLA: ``Runner.train()`` for 300 steps
   (256 + 44, across the refresh at 256) from fresh seeded weights; checks
   184,069 + 7,397 params, no launch of any kernel wrapper, a finite falling
   loss; prints s/step, rays/s, the peak device memory of six steps and a
   profile of five (the device's busy share); holds one step's gradient on
   the card against the same step on the CPU (cosine >= 0.999 for each
   grid's lines, decoder and sigma net); renders one 800x800 view from the
   saved checkpoint (no launch, s/frame, a profile of five chunks) and
   holds a chunk on the card against the same chunk on the CPU: at fp32
   every pixel within 1e-3; at bf16, where a rounding that the two
   devices' float32 sums decide differently moves a sample's color by one
   bf16 ulp (2^-8 on [0.5, 1)), the mean within 1e-4 and every pixel within
   four such ulps;
   then ``conf/lego_levels.ini`` (384 + 192) and ``conf/lego_fold.ini``
   (385 + 193, folded) for 10 steps each (257,797 and 258,565 + 7,397
   params, no launch), each resumed from its checkpoint with its level
   tables back;
12c. drives ``conf/lego_grid.ini`` with ``GRID_PALLAS``, ``GRID_RES = 64``,
   ``GRID_UPSAMPLE = 100:128,200:256`` and ``VAL_METRICS`` (the validated
   2000/4000 schedule cut to 300 steps) in three segments of 100: the fine
   tables and both Adam moments at R = 64, 128 and 256 in turn; kernels 5
   and 6 launched 600 times each and nothing else; at each R one call of
   kernels 5 and 6 on the trained tables held against their plain versions
   at phase 3's bounds; a finite val PSNR after each segment; ms/step of
   each segment; a falling loss. A checkpoint at 199 (the milestone at 200
   pending) resumes at R = 128 in a second Runner, which reaches R = 256
   before its first step and trains to 300 with finite losses;
12d. drives ``conf/fern_ndc.ini`` with ``HOST_FEED``, ``PROFILE_STEPS = 5``,
   ``VAL_METRICS`` and ``FUSED_RENDER`` for 20 steps on 4 views of a
   full-resolution 4032x3024 capture: the pixels stay on the host; the
   Runner's store is the native ``HostRayStore`` (closed after), its batch
   0 bit-identical to ``NumpyRayStore``'s; kernels 1 and 2 in bf16
   launched 40 times each and nothing else; the trace under
   ``LOG_DIR/trace/`` names kernel 1's and kernel 2's entry points; the
   val PSNR through kernel 9 (one launch) within 0.01 dB of the unfused
   renderer's; s/step of steady host-fed steps (phase 21 prints it beside
   the device table's), each batch uploaded asynchronously and its host
   arrays dropped at once, every upload equal to a host copy of its batch
   bit for bit once the card has run the steps;
13. drives ``conf/lego_prop.ini`` with ``PROP_FIELD = mlp`` and
   ``PROP_PALLAS`` (the 8x256 MLP at bf16 with ``USE_PALLAS``; the proposal
   MLP, 128 x 4 at ``PROPOSAL_ENC_L`` 10, 57,932 params; 4096 rays, 64 + 128
   samples, no occupancy grid) from fresh seeded weights: ``Runner.train()``
   for 100 steps. Checks one launch of each of kernels 1, 2, 7 and 8 a step
   (and none of 3, 5, 6), a finite falling loss; prints s/step, rays/s and
   a profile of five steps; holds one step's gradient through the kernels
   against the plain versions (``field_flat_plain``, ``prop_rays_reference``)
   on fields with content, cosine >= 0.999 for the net and for the proposal;
   saves the state;
14. renders two 800x800 views from that checkpoint: one launch of kernel 7
   and one of kernel 1 a chunk, finite frames in [0, 1], a chunk through the
   kernels against the plain versions (1e-3 per pixel), s/frame and a
   profile of rendered chunks;
15. drives ``lego_prop`` at ``PRECISION=fp32`` for 10 steps (the fp32 forms
   of kernels 7 and 8 on a path), checking the launch counts and finite
   losses, and prints its s/step (6 steps after 2 more) and rays/s;
16. drives unbounded360-mlp: ``conf/unbounded360.ini`` with ``FINE_FIELD =
   mlp`` (CONTRACT, LINDISP, STRATIFIED, the proposal grid at R = 64, 16 +
   16, width 16, DIST_LOSS 0.003, PROP_INTERLEVEL 0.01; the 8x256 MLP at
   bf16, 4096 rays, 64 + 128 samples) from fresh seeded weights on an
   in-memory outward-facing 360 ring (4 views of 1008x756, a 4032x3024
   capture at LOW_RES 4; bounds about 0.5 / 100): ``Runner.train()`` for
   50 steps. Under CONTRACT the MLP runs its point interface, so checks
   exactly one launch of kernel 3 (``csrc/field_flat_fwd.cu``) and one of
   kernel 4 (``csrc/field_flat_bwd.cu``) a step and nothing else, a finite
   falling loss; prints s/step, rays/s and a profile of five steps; holds
   one step's gradient through kernels 3 and 4 against the plain field
   under the contraction on fields with content (cosine >= 0.999 for the
   net and for the proposal grid); saves the state;
17. renders one 1008x756 view from that checkpoint: one launch of kernel 3
   a chunk and nothing else, a finite frame in [0, 1], s/frame, a chunk
   through kernel 3 against the plain field (1e-3 per pixel) and a profile
   of rendered chunks;
18. drives unbounded360-mlp with the contracted occupancy grid (OCC_GRID,
   OCC_RES 64, OCC_MARCH_RES 16, OCC_MARCH_STEPS 32, OCC_UPDATE_EVERY 256,
   OCC_SUBSET 0.125, conf/synthetic360.ini's block) for 10 steps: the
   refresh at 0 probes through kernel 3 (11 launches of it, 10 of kernel
   4), the extent forced to 2;
19. drives unbounded360-mlp with ``PROP_FIELD = mlp`` and ``PROP_PALLAS``
   for 10 steps: the proposal MLP through ``prop_flat`` (kernels 7 and 8 at
   one sample a ray, t = 0), one launch each of kernels 3, 4, 7, 8 a step;
20. drives unbounded360-mlp at ``PRECISION=fp32`` for 10 steps (the fp32
   forms of kernels 3 and 4 on a path);
21. drives ``conf/fern_ndc.ini`` (NDC, bf16, u8 pixels, 4096 rays) on an
   in-memory forward-facing capture (4 views of 1008x756) for 20 steps:
   the Runner recentres the poses and sets ``ndc_params``; two launches
   each of kernels 1 and 2 a step and nothing else, a finite falling loss,
   s/step; saves the state;
22. renders one view of that checkpoint unfused (two kernel-1 launches a
   chunk) and with ``FUSED_RENDER`` (one kernel-9 launch a chunk, nothing
   else), both finite in [0, 1], the two within 1e-3 per pixel;
23. drives ``conf/lego_coarse.ini`` unchanged (bf16, 4096 rays, 64 coarse
   samples, ``N_FINE = 0``: the coarse pass alone) from fresh seeded
   weights on 4 views of 800x800 for 50 steps: exactly one launch each of
   kernels 1 and 2 a step and nothing else, a finite falling loss, s/step;
   then renders one 800x800 view from its checkpoint: kernel 1 once a chunk
   and nothing else, a real chunk through kernel 1 against the bf16 plain
   field (1e-3 per pixel), s/frame;
24. drives ``conf/unbounded360.ini`` as shipped (the grid fine field at R =
   256 under CONTRACT, LINDISP, the proposal grid, DIST_LOSS,
   PROP_INTERLEVEL; bf16, 4096 rays) on phase 16's outward ring (4 views of
   1008x756) for 30 steps. The JAX package runs these grids in XLA, so no
   kernel: every wrapper at 0 launches; a finite falling loss; s/step and
   the peak device memory of 6 steps, a profile of five; on the trained
   state, one step's gradient on the card against the same step on the CPU
   for each grid's lines and decoder: at fp32 cosine >= 0.9999, and at
   bf16 cosine >= 0.999 or, failing that, no worse than the CPU's own
   conditioning (three one-ulp perturbations of every param, with the
   margin ``grad_vs_cpu`` states), the printout naming which decided; one
   1008x756 view from its checkpoint (s/frame, no launch, finite, in [0,
   1]);
25. the same for ``conf/synthetic360.ini`` unchanged (the hybrid grids at
   R = 384 under CONTRACT and LINDISP, NEAR/FAR 1/80, bf16, 1024 rays) on
   the same ring for 20 steps, the sigma nets' gradients checked too;
26. the legacy field (``core/legacy.py``, plain PyTorch as the JAX package
   runs it in XLA) from seeded params with content (the sigma bias +1), at
   full width (543,052 params, checked): one 64x64 view of
   ``tools/render_shipped_ckpt.py``'s orbit, one 4096-ray chunk through
   ``eval.make_frame_fn`` at 16 + 32 samples, on the card against the CPU
   within 1e-4 per pixel, no launch, its time;
27. the render service (``tools/serve_render.py``) on phase 7's
   ``lego_occ`` checkpoint: ``render_u8`` at scales 0.25 and 1, the first
   frame at each scale (its frame function made) and 3 more timed, kernel 1
   twice a chunk and nothing else; ``render_u8`` at one ``free_pose``
   equal bit for bit to ``eval.make_frame_fn``'s frame at that pose;
   ``GET /info`` over HTTP on ``127.0.0.1:0`` (a thread, shut down after),
   its JSON checked against the checkpoint, and one ``GET /frame`` at scale
   0.25: a JPEG (the port's encoder) with its SOI and EOI markers, its SOF0
   size the frame's, kernel 1 twice a chunk;
28. trains ``conf/lego_occ.ini`` with ``MESH_SHAPE = 2`` (``parallel/``:
   two ranks, started with ``parallel.distributed.spawn``, on the one card
   under gloo, ``backend="gloo"`` passed; where the machine has two cards
   or more, a second job on two cards under NCCL) for 20 steps of 4096
   rays, 2048 a rank, from fresh seeded weights through ``Runner.train``
   one step a call (the eager mesh step; phase 31 takes chunks), each rank
   with its own CKPT_PATH, LOG_DIR and RESULTS_PATH: on each rank
   and step kernels 1 and 2 twice at B = 2048, kernel 3 once in the
   refresh at 0 (half the probes a rank) and nothing else; the two ranks'
   params digests equal after every step; the grid after the refresh at 0
   equal bit for bit to the one-rank refresh's; the first step's loss on
   fixed indices within 1e-5 relative of the one-rank step's, its gradient
   at cosine >= 0.999 per part; a finite falling loss; the checkpoints
   (9, 19) and the log written by rank 0 alone (the preview canvas saved
   as ``.npy``: no imageio on the card's machine); s/step, not a speed
   figure where two ranks share one card; the gradient all-reduce's and
   the refresh gather's ms. Then one 800x800 view of rank 0's checkpoint,
   its chunks split over the ranks (kernel 1 twice a chunk on each rank),
   against the one-rank view within 1e-3;
28b. ``conf/lego.ini`` with ``MESH_SHAPE = 2`` and ``SAMPLE_SHARD = 2``
   (data 1 x sample 2, fp32) on phase 5's checkpoint: one 800x800 view,
   64 coarse + 64 fine samples a rank (kernel 1 twice a chunk on each
   rank), against phase 6's view 0 within 1e-4; one 4096-ray chunk at
   ``N_FINE = 512`` (256 fine samples a rank) against the one-rank chunk
   within 1e-4;
29. in a fresh temporary directory, the validate protocol from files on
   disk, needing neither Pillow nor imageio (``validate_phase``): the
   port's scene maker writes a 100x100 sync capture of 30 views, the port's
   validate tool runs the ``full`` family (the 8x256 MLP at bf16 through
   kernels 1-3, the proposal grid, the 64^3 occupancy grid, white
   background; 1024 rays, 64 + 128 samples) for 2000 steps through the
   CLI; its row's PSNR at least 5 dB above predicting each test view's
   mean colour, its JPGs and ``.gif`` on disk; on its checkpoint one step,
   one refresh and one view launch kernels 1-3; ``tools.profile_step``'s
   table;
30. the CUDA graphs (``graph_phases``, ``tinynerf_torch/graphs.py``): on
   each graphed training path (lego fp32 at 400 rays; lego_occ, its grid
   refreshed every 4 steps; lego_grid + GRID_PALLAS; lego_prop with the
   proposal MLP; unbounded360-mlp; the flagship lego_hybrid), 20 eager
   steps twice from one state and two graphed chunks of 10 from the same
   state: the same launches by kernel; the two eager runs bit-identical
   (the resampler's and the grid's gathers sum their backward in a fixed
   order, ``sampling._BinGather``, ``gridfield._TapRows``) and the graphed
   chunks bit-identical to them; ms/step eager and graphed, host API launches
   a step, device idle, capture seconds and pool bytes; view 0 of
   lego_occ (unfused and fused), lego_grid, unbounded360-mlp and the
   flagship through one graph a view and a graph a chunk, every frame
   bit-identical to the eager host loop's, with s/frame of each; lego_grid
   across a ``GRID_UPSAMPLE`` milestone in chunks, its step graphs captured
   again on the new shapes; then ``python -m tinynerf_torch --mode all`` on
   a tiny scene across refreshes and STEP boundaries;
31. phase 30 under a mesh (``mesh_phases``): where the machine has two
   cards or more, ``MESH_SHAPE = N`` over N NCCL ranks, one card each (N =
   4 with four cards, else 2), through ``parallel.distributed.spawn``:
   lego_occ (its grid refreshed every 4 steps) and the flagship, 20 eager
   mesh steps twice from one state and two graphed chunks of 10 whose
   graphs hold the all-reduce (and the refresh's gather): the eager runs
   and the graphed chunks bit-identical (where the eager runs differ, one
   replayed step's gradient at the step bound, the deciding check
   printed), the params digests after each chunk equal on every rank, the
   graphed steps' kernel launches equal to the eager steps' on every rank;
   ms/step eager and graphed, host API launches a step, capture seconds
   and pool MiB, the all-reduce's ms; the lego_occ view through one graph a
   view and 8 chunks a graph, and lego with ``SAMPLE_SHARD = 2`` (kernel 1
   fp32) through one graph a view, each equal to its eager host loop and
   across the ranks bit for bit; then ``python -m tinynerf_torch --mode
   train`` with ``MESH_SHAPE = N`` in graphed chunks, every rank's digest
   equal. With one card it prints that there is no NCCL job;
32. the gather lookup and the reference state-dict bridge (``gather_phases``):
   ``conf/lego_grid.ini`` with ``GRID_PALLAS`` and ``GRID_LOOKUP = gather``
   at bf16 and at fp32, and the flagship (``conf/lego_hybrid.ini``) with the
   gather, at full width: 8 eager steps twice from one state (the occupancy
   grid refreshed at 0 and 4) bit-identical, a graphed chunk of 8
   bit-identical to them with the same launches, every lookup of the point
   field the gather (lego_grid: the refresh's probes alone, the rays
   through kernels 5 and 6), one step's gradient card vs CPU per part (fp32
   cosine >= 0.9999 and norm within 1%, bf16 cosine >= 0.999), ms/step
   eager and graphed beside the onehot lookup's, in turns; the flagship's
   800x800 view through the whole-frame graph; then a seeded reference
   state dict through ``tinynerf_torch.tools.import_torch_ckpt``, the
   Runner on ``conf/lego.ini`` (fp32) resuming it and rendering one 800x800
   view through kernel 1, bit-identical to the view from the same weights
   by ``params_from_numpy``, and ``export_torch_state_dict`` giving the
   state dict back bit for bit;
33. prints one ``{"kernels": [...]}`` line (every kernel form, with its
   launches under the graphed paths, phase 31's a rank,
   ``graphed_launches``; phase 32's among ``launches_by_path``) and, last,
   one ``{"ok": true, "device": {...}}`` line.

Kernel 4 (``csrc/field_flat_bwd.cu``) is held against its plain version in
phase 3h (fp32 and bf16, at an unbounded360-mlp step's R = 524,288 fine
rows and at a ragged R = 1001, on points in the contracted ball; fp32 every
gradient within 1e-4 of max|plain|, bf16 within 3e-2 and cosine >= 0.999;
rows whose smallest |pre-activation| in the compared form is under 2e-6
given no cotangent; two launches bit-identical) and timed in phase 4 at R =
524,288 beside both bounds, with kernel 3 at that R.

Phases 6b and 8b (render-lego-fused-800, render-lego_occ-fused-800) render
the two views of phases 6 and 8 again from the same checkpoints with
``FUSED_RENDER``: exactly one launch of kernel 9 (``csrc/render_fused_fwd.cu``)
a chunk and none of kernels 1-3, frames finite in [0, 1], their max and mean
difference from the unfused frames, s/frame, a real chunk (with the grid in
8b) through kernel 9 against ``render_fused_plain`` (1e-4; 1e-3 at bf16), a
profile of three chunks, and one gradient of that chunk's loss through the
fused branch of ``render_rays`` (one launch each of kernels 9 and 10,
``csrc/render_fused_bwd.cu``) held against the plain backward as in phase
3. Kernels 9 and 10 are held against their plain versions in phase 3 (fp32
and bf16, white background off and on, B = 4096 and a ragged B = 1001 whose
last 7 rays are empty, 64 + 128 samples, rays from ``pixels_to_rays`` on a
field with content: colors within 1e-4 / 1e-3, the same bit for bit where
kernel 9 also writes its residuals; kernel 10 from those residuals, every
gradient tensor at cosine >= 0.9999 and norm within 1% at fp32, cosine >=
0.999 at bf16, against the plain backward taken at kernel 9's own fine t's
(``render_kernel.grads_agree``), since one ulp of a fine t moves the top
encoding frequency by 2^9 ulps; two backward launches and the call without
residuals bit-identical; its merge launch alone (``merge_bwd``) against
the float64 evaluation of ``merge_bwd_plain``, each hand-off plane within
1e-5 of its max more than the float32 plain version
(``render_kernel.merge_agreement``), its C_fine equal to kernel 9's bit
for bit; no gradient to the rays) and timed
in phase 4 at B = 4096 beside their FLOP bounds (kernel 10 as autograd
calls it, from the residuals; also without them, ``standalone_ms``, and
one chunk's forward and backward through autograd, ``chunk_fwd_bwd_ms``,
which no user path of the port runs yet; its merge launch's device time
alone), kernel 9 also beside the unfused path's device
time on the same rays (kernel 1 at the coarse and the fine t's and the
PyTorch tail between, ``unfused_chunk``), with its phase split
(``render_kernel.fwd_phase_split``: the coarse field, the coarse weights,
the resample, the fine field, the merge, and the share of the warps that
wait through the tail), the bare launch of bf16 kernel 9 beside its weight
probe build's (whose products read 176,128 of the 593,920 packed weight
values a pass: the time the products wait on the weights' L2 reads), the
L2 weight bytes a call as arithmetic from the shapes (``fused_weight_bytes``:
this tree's tiles and the earlier 64-row ones; printed, not measured), and
kernel 10's time by launch from the residuals (``launch_split``).

Kernels 5 and 6 (``csrc/grid_rays_fwd.cu``, ``csrc/grid_rays_bwd.cu``) are
held against their plain versions in phase 3 (fp32 and bf16, at B = 4096
with the fine grid at N = 128 and the proposal grid at N = 64, at ragged
shapes and on grid nodes and the clip boundary; the backward bit-identical
across two launches) and timed in phase 4 (kernel 5 as the wrapper's call,
as every kernel is, and as its bare launch, ``launch_ms``) beside both
bounds (the gather form's FLOPs, in the bf16 forms the decoder's product at
the tensor cores' rate and the rest at the f32 FMA rate; the bytes) and the
TPU kernel's own hat-form FLOP count, with kernel 6's phase split
(``grid_kernel.bwd_phase_split``).
Kernels 7 and 8 (``csrc/prop_rays_fwd.cu``, ``csrc/prop_rays_bwd.cu``) are
held against their plain versions in phase 3 (fp32 and bf16, at 128 x 4 with
B = 4096, N = 64, at a ragged B = 1001 and at 64 x 3; fp32 forward within
1e-5, backward within 1e-4 of max|plain| with rows near a kink given no
cotangent; bf16 within 1e-2 and 3e-2 of max|plain| and cosine >= 0.999;
the backward bit-identical across two launches, and its weight gradients
bit-identical to those of a call asked for no ray gradient, the main
paths' call) and timed in phase 4 at 128 x 4, B = 4096, N = 64 beside both
bounds: each as the wrapper's call (``ms``) and as its bare launch
(``launch_ms``), kernel 8 also without the ray gradients
(``ray_grads_off_ms``, the main paths' call), with kernel 8's time by
launch (``launch_split``) and, in both forms, the recompute kernel's
phase split (``proposal_kernel.bwd_phase_split``: recompute, the fix-up
(bf16) or the heads (fp32), input gradients, weight gradients, ray sums).

Any failure raises, and the script exits non-zero without the last line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. It
imports nothing of JAX or of the ``tinynerf`` package.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet; at the 700 W limit)
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12        # HBM3
COLOR_ATOL = 1e-5
SIGMA_ATOL = 1e-4
SIGMA_RTOL = 1e-4
CHUNK_ATOL = 1e-4           # rendered pixels, kernel field vs plain field
BWD_RTOL = 1e-4             # kernel 2: every gradient, error / max|plain|
MARGIN = 2e-6               # rows this close to a ReLU's kink get no cotangent
GRAD_COS = 0.9999           # a training step's gradient, kernels vs plain field
# bf16 forms: kernel and plain version round at the same points and sum in
# other orders, which can move a rounded activation by one bf16 ulp (2^-8)
BF16_FWD_RTOL = 1e-2        # each output, error / max|plain|
BF16_BWD_RTOL = 3e-2        # each gradient, error / max|plain|
BF16_COS = 0.999            # each gradient tensor; and a bf16 step's gradient
COND_TRIALS = 3             # phases 24-25: one-ulp trials of a bf16 step's conditioning
COND_ULP = 2e-7             # each param times (1 + COND_ULP N(0, 1)) in a trial
COND_MARGIN = 2.0           # the card may sit (1 + COND_MARGIN) times the worst trial's 1 - cos
COND_FLOOR = 0.99           # the conditioning route's floor never goes below this cosine
BF16_CHUNK_ATOL = 1e-3      # rendered pixels, bf16 kernels vs bf16 plain field
DEVICE_CHUNK_ATOL = 1e-3    # rendered pixels, the plain path, card vs CPU at fp32
BF16_COLOR_ATOL = 2 ** -6   # the same at bf16, every pixel: four bf16 ulps of a color on [0.5, 1)
TRAIN_STEPS = 200
TRAIN_VIEWS = 4
STEP_SHAPES = ((400, 64), (400, 128))    # the field calls of a lego step
OCC_STEPS = 300             # lego_occ: refreshes at iterations 0 and 256
OCC_FP32_STEPS = 10         # lego_occ at fp32: one refresh, at iteration 0
OCC_SHAPES = ((4096, 64), (4096, 128))   # the field calls of a lego_occ step
VALIDATE_SHAPE = (1024, 128)             # the fine field call of a validate `full` step
FLAT_ROWS = (32768, 65536, 32768 + 37)   # one refresh's probes; a chunk; ragged
GRID = {"fine": (256, 64, 64, 128),      # lego_grid's fine grid: R, Fd, Fa, width
        "prop": (64, 16, 16, 16)}        # its proposal grid (the config defaults)
GRID_SHAPES = (("fine", 4096, 128), ("prop", 4096, 64))   # a lego_grid step's calls
GRID_CHECKS = GRID_SHAPES + (("fine", 1001, 128), ("prop", 37, 5), ("fine", "nodes", 8))
GRID_MARGIN = 1e-5          # rows this close to a ReLU kink or sigma = 0: no cotangent
GRID_STEPS = 300            # lego_grid: refreshes at iterations 0 and 256
GRID_FP32_STEPS = 10        # lego_grid at fp32
FAST_STEPS = 10             # lego_fast with GRID_PALLAS
HYBRID_STEPS = 300          # conf/lego_hybrid.ini: refreshes at iterations 0 and 256
LEVELS_STEPS = 10           # conf/lego_levels.ini, conf/lego_fold.ini
# the flagship configs' fine grid and proposal grid params, as the JAX
# package's init_state gives them
HYBRID_COUNTS = {"lego_hybrid": (184_069, 7_397), "lego_levels": (257_797, 7_397),
                 "lego_fold": (258_565, 7_397)}
PROP_NETS = {"128x4": (128, 4),          # lego_prop's proposal MLP: width, depth
             "64x3": (64, 3)}            # a narrower one (the kernels take any such)
PROP_SHAPE = (4096, 64)                  # a lego_prop step's proposal call
PROP_CHECKS = (("128x4", 4096, 64), ("128x4", 1001, 64), ("64x3", 4096, 64))
PROP_STEPS = 100            # lego_prop with PROP_FIELD = mlp and PROP_PALLAS
PROP_FP32_STEPS = 10        # the same at fp32
FUSED_SAMPLES = (64, 128)   # the fused renderer at lego's N_COARSE + N_FINE
# kernels 9 and 10: (precision, B, white_bkgd); B = 1001 with 7 empty rays
FUSED_CHECKS = tuple((p, B, w) for p in ("fp32", "bf16") for B in (4096, 1001)
                     for w in (False, True))
FUSED_ATOL = {"fp32": CHUNK_ATOL, "bf16": BF16_CHUNK_ATOL}   # kernel 9: each color
FLAT_BWD_ROWS = (4096 * 128, 1001)       # an unbounded360-mlp step's fine rows; ragged
U360_STEPS = 50             # unbounded360-mlp (conf/unbounded360.ini, FINE_FIELD = mlp)
U360_SHORT_STEPS = 10       # the same with the contracted grid, the proposal MLP, at fp32
U360_VIEWS = 4
CAPTURE_HW = (756, 1008)    # a 4032x3024 capture at LOW_RES 4: height, width
FERN_STEPS = 20             # conf/fern_ndc.ini
# the field kernels' sources, whose bf16 forms run their products on the tensor cores
FIELD_SOURCES = ("field_rays_fwd.cu", "field_rays_bwd.cu", "field_flat_fwd.cu",
                 "field_flat_bwd.cu", "render_fused_fwd.cu", "render_fused_bwd.cu")
# the grid kernels' sources: their bf16 forms run the decoder's products on the tensor cores
GRID_SOURCES = ("grid_rays_fwd.cu", "grid_rays_bwd.cu")
# the proposal MLP's sources: their bf16 forms run the trunk's products on the tensor cores
PROP_SOURCES = ("prop_rays_fwd.cu", "prop_rays_bwd.cu")
BF16_EDGE = (1001, 37)      # rows no multiple of 16 or of the 64-row tile
# ... and rays of more samples than a tile: kernel 1's 64-row tiles of the
# flat index are not kernel 2's at these
BF16_EDGES = (BF16_EDGE, (37, 129))
GEMM_CHAIN_ROWS = 4096 * 128
BWD_CHAIN_ROWS = 400 * 128  # a lego step's fine call
FERN_VIEWS = 4
# phase 12c: lego_grid with GRID_UPSAMPLE, VALIDATION.md's 2000/4000 schedule cut
# to 100/200 (iteration at each segment's end, R through it)
UPSAMPLE_SCHEDULE = "100:128,200:256"
UPSAMPLE_SEGMENTS = ((100, 64), (200, 128), (300, 256))
UPSAMPLE_STEPS = UPSAMPLE_SEGMENTS[-1][0]
UPSAMPLE_RESUME_AT = 200    # a checkpoint at 199, the milestone at 200 pending
# phase 12d: fern_ndc with HOST_FEED on a full-resolution capture (height, width)
HOSTFEED_HW = (3024, 4032)
HOSTFEED_PROFILE = 5        # PROFILE_STEPS
HOSTFEED_PSNR_DB = 0.01     # the val PSNR through kernel 9 vs the unfused renderer
# kernel 1's and kernel 2's bf16 entry points, as the trace names them
HOSTFEED_TRACE_NAMES = ("field_rays_fwd_kernel", "field_bwd_tc_kernel")
# phases 23-27: the shipped configs that ran on no earlier phase, the legacy
# field and the render service
COARSE_STEPS = 50           # conf/lego_coarse.ini
U360_GRID_STEPS = 30        # conf/unbounded360.ini as shipped (the grid fine field)
S360_STEPS = 20             # conf/synthetic360.ini
LEGACY_HW = 64              # one 64x64 view of the legacy field: one 4096-ray chunk
LEGACY_ATOL = 1e-4          # its pixels, card vs CPU
SERVE_SCALES = (0.25, 1.0)  # the service's frames, timed at each
SERVE_FRAMES = 3            # steady frames timed at each scale after the first
SERVE_VIEW = dict(theta=30.0, elev=25.0, radius=1.0)
# phases 28 and 28b: two ranks (parallel/)
DP_RANKS = 2
DP_STEPS = 20               # conf/lego_occ.ini with MESH_SHAPE = 2: the refresh at 0
DP_STEP = 10                # checkpoints at 9 and 19, by rank 0
DEEP_FINE = 512             # the sample-sharded deep march's N_FINE
DP_LOSS_RTOL = 1e-5         # the first step's loss, two ranks vs one
DP_TRAIN = "lego_occ data-parallel train (2 ranks)"
# phase 29: the validate protocol (tools/validate.py's full family) cut to size
VALIDATE_HW = 100           # the protocol's capture resolution
VALIDATE_VIEWS = 30         # training views (the protocol's 100 cut)
VALIDATE_ITERS = 2000       # steps (the protocol's 20,000 cut)
VALIDATE_MARGIN_DB = 5.0    # the test PSNR above predicting each view's mean colour
# phase 30: the graphed chunks and frames (CUDA graphs)
GRAPH_K = 10                # steps a chunk; each path takes two, against 2 GRAPH_K eager steps
GRAPH_REFRESH_EVERY = 4     # OCC_UPDATE_EVERY on those paths: the refresh graph is replayed
GRAPH_PATHS = (("lego", "lego", {}),                       # fp32, 400 rays: kernels 1, 2
               ("lego_occ", "lego_occ", {}),               # bf16, 4096 rays: kernels 1-3
               ("lego_grid", "lego_grid", {"grid_pallas": True}),      # kernels 5, 6
               ("lego_prop", "lego_prop", {"prop_field": "mlp", "prop_pallas": True}),
               ("unbounded360_mlp", "unbounded360", {"fine_field": "mlp"}),   # kernels 3, 4
               ("lego_hybrid", "lego_hybrid", {}))         # the flagship: no kernel
GRAPH_FRAME_PATHS = ("lego_occ", "lego_grid", "unbounded360_mlp", "lego_hybrid")
GRAPH_UPSAMPLE = "20:128"   # lego_grid + GRID_PALLAS from R = 64, STEP 10: graphs recaptured at 20
GRAPH_UPSAMPLE_ITERS = 40
GRAPH_CLI_ITERS = 25        # the CLI's run: chunks of GRAPH_CLI_STEP, then single steps
GRAPH_CLI_STEP = 10
GRAPH_CLI_REFRESH = 8
IMAGE_FILE_HW = 800         # the view whose PNG decode and JPEG encode are timed
# phase 31: phase 30's chunks and frames under a mesh of NCCL ranks
MESH_PATHS = (("lego_occ", "lego_occ", {}),               # bf16 4096 rays: kernels 1-3
              ("lego_hybrid", "lego_hybrid", {}))         # the flagship: no kernel
MESH_FRAME_PATHS = ("lego_occ",)
MESH_CLI_ITERS = 20         # the CLI under the mesh: two chunks of MESH_CLI_STEP
MESH_CLI_STEP = 10
# phase 32: the gather lookup (GRID_LOOKUP = gather) and the reference state-dict bridge
GATHER_K = 8                # eager steps a run and steps a chunk; refreshes at 0 and 4
GATHER_PATHS = (("lego_grid_gather", "lego_grid", {"grid_pallas": True}),  # bf16: kernels 5, 6
                ("lego_grid_gather_fp32", "lego_grid",
                 {"grid_pallas": True, "precision": "fp32"}),             # kernels 5, 6 fp32
                ("lego_hybrid_gather", "lego_hybrid", {}))                # the flagship: none
GATHER_NORM = 1e-2          # fp32: a step's gradient norm, card vs CPU, per part
GATHER_TIMING_TURNS = 2     # gather, onehot, in turns: ms/step of each
BRIDGE_ITER = 19999         # the imported checkpoint's iteration
BRIDGE_PARAMS = 593_924     # the reference Network's params


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dyadic_rays(rng, n_rays: int, n_samples: int):
    """Coordinates quantized to 1/16, so o + t*d is exact in float32."""
    import numpy as np
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (n_rays, 3))).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(2.0, 6.0, (n_rays, n_samples))), axis=1)
    return origins, dirs, ts.astype(np.float32)


def field_errors(kernel_out, plain_out):
    """(max |color err|, max |sigma err|, sigma within atol + rtol|ref|,
    all |color err| and |sigma err| flattened)."""
    import torch
    (r, g, b), s = kernel_out
    (rp, gp, bp), sp = plain_out
    ce = torch.stack([r - rp, g - gp, b - bp]).abs().flatten()
    se = (s - sp).abs().flatten()
    sigma_ok = bool(torch.all(se <= SIGMA_ATOL + SIGMA_RTOL * sp.abs().flatten()))
    return float(ce.max()), float(se.max()), sigma_ok, ce, se


def bwd_errors(kernel, plain):
    """{output: (max |err|, max |err| / max |plain|)} over every output of
    field_rays_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    out = {}
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        out[name] = (err, err / max(float(b.abs().max()), 1e-30))
    return out


def bwd_cosines(kernel, plain):
    """The smallest cosine, over every output of field_rays_bwd, between the
    kernel's tensor and the plain version's."""
    import torch
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")] + list(zip(k_rest, p_rest))
    return min(float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0)) for a, b in pairs)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def flat_grads(grads):
    import torch
    return torch.cat([grads[n][k].flatten() for n in grads for k in ("w", "b")])


def least_ms(flops: float, n_bytes: float, precision: str, tc_flops: float = None):
    """(bound ms, bound_by): the least time for ``flops`` at the peak rate of
    their type and ``n_bytes`` at the memory rate. With ``tc_flops`` (the
    part a bf16 form can run on the tensor cores) the bf16 operations take
    tc_flops at the tensor cores' rate plus the rest at the f32 FMA rate."""
    if precision != "bf16":
        ops_ms = 1e3 * flops / PEAK_F32_FLOPS
    elif tc_flops is None:
        ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
    else:
        ops_ms = 1e3 * (tc_flops / PEAK_BF16_FLOPS + (flops - tc_flops) / PEAK_F32_FLOPS)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def short_kernel(name: str) -> str:
    """A SASS function name without its return type, namespace and parameter
    list."""
    for noise in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(noise, "")
    name, depth = name.removeprefix("void "), 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def kernel_form(name: str):
    """"bf16" for a bf16 form of the field kernels (a template on true, or
    a tensor-core kernel), "fp32" for an fp32 form, else None (the packing,
    reducing and resampling kernels, which compute no product)."""
    import re
    if re.search(r"<\(bool\)1>|<true>|ILb1E|_tc_kernel", name):
        return "bf16"
    if re.search(r"<\(bool\)0>|<false>|ILb0E", name) or re.search(
            r"field_bwd_kernel|wgrad_kernel|transpose_kernel|prop_rays_(fwd|bwd)_kernel", name):
        return "fp32"
    return None


def exact_sum_bwd(mk, params, args):
    """``field_rays_bwd_plain`` at bf16 with every matmul's products summed in
    float64 and rounded to float32 once: the same function summed exactly,
    for the record of how far a correct implementation that sums in another
    order than cuBLAS (k ascending, one float32 FMA a term) lands from the
    plain version."""
    import torch

    class Exact(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            out = torch.matmul(x.reshape(-1, x.shape[-1]).double(), w.double())
            return out.float().reshape(*x.shape[:-1], w.shape[-1])

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            x2, g2 = x.reshape(-1, x.shape[-1]).double(), g.reshape(-1, g.shape[-1]).double()
            return (torch.matmul(g2, w.double().T).float().reshape(x.shape),
                    torch.matmul(x2.T, g2).float())

    matmul = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda a, b: Exact.apply(a, b)
    try:
        return mk.field_rays_bwd_plain(params, *args, precision="bf16")
    finally:
        torch.Tensor.__matmul__ = matmul


def sum_order_record(params, pts, dirs):
    """For the record behind the bf16 backward's fix-up bound
    (``csrc/field_tc.cuh``, FIX_TOL = 2^-22): over the plain bf16 field's
    trunk at these rows, max |cuBLAS's float32 sum - the exact sum| in units
    of 2^-24 |x_r| |w_c|, and the share of outputs that bound flags."""
    import torch
    from tinynerf_torch.core import encoding, mlp
    r16 = lambda x: x.to(torch.bfloat16).float()
    pe = r16(encoding.encode_points(pts))
    h, worst, flagged = pe, 0.0, []
    for i in range(mlp.DEPTH):
        x = torch.cat([h, pe], -1) if i in mlp.SKIP_LAYERS else h
        w, b = r16(params[f"trunk_{i}"]["w"]), params[f"trunk_{i}"]["b"]
        s32 = x @ w
        unit = 2.0 ** -24 * x.norm(dim=-1, keepdim=True) * w.norm(dim=0, keepdim=True)
        worst = max(worst, float(((s32.double() - x.double() @ w.double()).abs()
                                  / unit.double()).max()))
        v, e = s32 + b, 4.0 * unit
        lo, hi = r16(torch.relu(v - e)), r16(torch.relu(v + e))
        flagged.append(float((lo != hi).float().mean()))
        h = r16(torch.relu(v))
    return worst, min(flagged), max(flagged)


def grid_probes(rng, rows: int):
    """Points in the occupancy grid's cube [-1.5, 1.5]^3 with direction +z,
    as the grid refresh probes the field."""
    import numpy as np
    pts = rng.uniform(-1.5, 1.5, (rows, 3)).astype(np.float32)
    return pts, np.broadcast_to(np.float32([0, 0, 1]), (rows, 3)).copy()


def grid_shares(grid):
    """(share of cells probed at least once, share of cells occupied)."""
    import torch
    return (float(torch.isfinite(grid.raw).float().mean()),
            float((grid.density > grid.threshold).float().mean()))


def profile_steps(step, state, n: int = 5):
    """Trace ``n`` training steps with torch.profiler; print the device time
    by kernel (top 12) and the device's busy share of the steps' wall time,
    and return ``profile_calls``' numbers."""
    def run():
        nonlocal state
        state, _ = step(state)
    return profile_calls(run, n, "steps")


def launch_split(fn, what: str, n: int = 3) -> dict:
    """Print and return {kernel: device ms per call} over ``n`` traced calls
    of ``fn``: one call's time by launch."""
    from tinynerf_torch import profiling
    _, rows, _ = profiling.device_rows(fn, n)
    split = {short_kernel(name): ms / n for name, _, ms in sorted(rows, key=lambda r: -r[2])}
    print(f"  {what} by launch (torch.profiler, device events, ms a call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; sum {sum(split.values()):.3f}")
    return split


def profile_calls(fn, n: int, what: str):
    """Trace ``n`` calls of ``fn`` with torch.profiler (after three more to
    warm up); print the device time by kernel (top 12) and the device's busy
    share of the calls' wall time (``profiling.print_profile``). Returns
    ``{"wall_ms", "device_ms", "busy_share", "launches"}`` per call, or None
    where the profiler recorded no device time."""
    from tinynerf_torch import profiling
    wall_ms, rows, busy_ms = profiling.device_rows(fn, n)
    return profiling.print_profile(wall_ms, rows, n, what, busy_ms=busy_ms)


def grid_with_content(geometry: str, device, seed: int):
    """A grid field at ``GRID[geometry]`` from a seed, its density columns
    scaled by 3 (sigma by 27: a field with content)."""
    import torch
    from tinynerf_torch.core import gridfield
    res, nd, na, width = GRID[geometry]
    params = gridfield.init_grid_field(torch.Generator().manual_seed(seed), res=res,
                                       n_density=nd, n_app=na, decoder_width=width,
                                       device=device)
    return scale_density(params, nd)


def scale_density(params, n_density: int):
    """A copy of a grid field with its density columns scaled by 3."""
    import torch
    out = {"lines": {ax: t.clone() for ax, t in params["lines"].items()},
           "decoder": params["decoder"], "extent": params["extent"]}
    with torch.no_grad():
        for t in out["lines"].values():
            t[:, :n_density] *= 3.0
    return out


def grid_rays_at(rng, B, N):
    """Dyadic rays through the grid's cube [-1.5, 1.5]^3 and out of it
    (clipped points); ``B = "nodes"``: axis-aligned rays whose samples sit on
    the fine grid's nodes 85 and 170 (+-0.5), on the clip boundary and
    outside it."""
    import numpy as np
    if B == "nodes":
        o = np.float32([[-2.0, 0.5, 0.5], [0.5, -2.0, -0.5], [-0.5, 0.5, -2.0],
                        [-2.0, 1.5, -1.5]])
        d = np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]])
        t = np.float32([0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.5, 3.75])[:N]
        return o, d, np.tile(t, (len(o), 1))
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(0.0, 2.5, (B, N))), axis=1)
    return origins, dirs, ts.astype(np.float32)


def grid_bwd_errors(kernel, plain):
    """{output: (max |err|, max |err| / max |plain|, cosine)} over every
    output of grid_rays_bwd."""
    import torch
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"lines.{ax}", kg["lines"][ax], pg["lines"][ax]) for ax in "xyz"]
    pairs += [(f"{n}.{k}", kg["decoder"][n][k], pg["decoder"][n][k])
              for n in ("hidden", "color") for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts", "d_de"), k_rest, p_rest))
    out = {}
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        out[name] = (err, err / max(float(b.abs().max()), 1e-30), cos)
    return out


def grid_kernels_check(gk, params, nd: int, o, d, ts, precision: str, rng) -> dict:
    """One call each of kernels 5 and 6 (``grid_rays``, ``grid_rays_bwd``) on
    ``params`` and the rays (o, d, ts) against their plain versions, at
    phase 3's bounds: the forward's colors within COLOR_ATOL and sigma
    within SIGMA_ATOL / SIGMA_RTOL at fp32, each output within BF16_FWD_RTOL
    of max|plain| at bf16; every backward output within BWD_RTOL of
    max|plain| (BF16_BWD_RTOL and cosine >= BF16_COS at bf16), rows within
    GRID_MARGIN of a kink given no cotangent; two backward launches
    bit-identical. Returns {"ok", "line", "ce", "se", "errs", "worst_rel",
    "de", "cots"}."""
    import numpy as np
    import torch
    de = gk.encoding.encode_dirs(d)
    with torch.no_grad():
        k_out = gk.grid_rays(params, o, d, ts, nd, precision)
        torch.cuda.synchronize()
        p_out = gk.grid_rays_plain(params, o, d, ts, de, nd, precision)
    ce, se, sigma_ok, _, _ = field_errors(k_out, p_out)
    if precision == "fp32":
        fwd_ok = ce <= COLOR_ATOL and sigma_ok
        fwd_note = f"color atol {COLOR_ATOL}, sigma atol {SIGMA_ATOL} rtol {SIGMA_RTOL}"
    else:
        rel = max(rel_err(a, b) for a, b in zip((*k_out[0], k_out[1]), (*p_out[0], p_out[1])))
        fwd_ok = rel <= BF16_FWD_RTOL
        fwd_note = f"error / max|plain| {rel:.3e}, limit {BF16_FWD_RTOL}"
    keep = (gk.preactivation_margin(params, o, d, ts, nd, precision) > GRID_MARGIN).float()
    cots = [torch.from_numpy(rng.normal(size=tuple(ts.shape)).astype(np.float32)).to(ts.device)
            * keep for _ in range(4)]
    kernel = gk.grid_rays_bwd(params, o, d, ts, de, *cots, n_density=nd, precision=precision)
    again = gk.grid_rays_bwd(params, o, d, ts, de, *cots, n_density=nd, precision=precision)
    torch.cuda.synchronize()
    plain = gk.grid_rays_bwd_plain(params, o, d, ts, de, *cots, n_density=nd,
                                   precision=precision)
    errs = grid_bwd_errors(kernel, plain)
    worst = max(errs, key=lambda k: errs[k][1])
    cos = min(e[2] for e in errs.values())
    same = all(e[0] == 0 for e in grid_bwd_errors(kernel, again).values())
    limit = BWD_RTOL if precision == "fp32" else BF16_BWD_RTOL
    bwd_ok = errs[worst][1] <= limit and (precision == "fp32" or cos >= BF16_COS)
    line = (f"forward max |color err| {ce:.3e}, max |sigma err| {se:.3e} ({fwd_note}); "
            f"backward ({100 * (1 - float(keep.mean())):.3f}% of rows within {GRID_MARGIN} of "
            f"a kink, zero cotangent) worst {worst} {errs[worst][1]:.3e} of max|plain| (limit "
            f"{limit}), d_ts {errs['d_ts'][1]:.3e}, lines.x {errs['lines.x'][1]:.3e}, smallest "
            f"cosine {cos:.7f}; two launches bit-identical: {same}")
    return {"ok": fwd_ok and bwd_ok and same, "line": line, "ce": ce, "se": se, "errs": errs,
            "worst_rel": errs[worst][1], "de": de, "cots": cots}


def grid_part_cosines(grads_a, grads_b, keys=("lines", "decoder")):
    """{part: cosine} for the ``keys`` (the lines and decoder) of the net and
    the proposal, on the CPU in float64 (the two may lie on two devices)."""
    import torch
    from tinynerf_torch import optim
    flat = lambda tree: torch.cat([t.flatten().double().cpu() for t in optim.leaves(tree)])
    out = {}
    for part in ("net", "prop"):
        for key in keys:
            a, b = flat(grads_a[part][key]), flat(grads_b[part][key])
            out[f"{part}.{key}"] = float(a @ b / (a.norm() * b.norm()))
    return out


def prop_bwd_errors(kernel, plain):
    """{output: (max |err|, max |err| / max |plain|, cosine)} over every
    output of prop_rays_bwd."""
    import torch
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    out = {}
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        out[name] = (err, err / max(float(b.abs().max()), 1e-30), cos)
    return out


def part_cosines(grads_a, grads_b):
    """{part: cosine} of the flattened gradients of the net and the proposal."""
    import torch
    from tinynerf_torch import optim
    flat = lambda tree: torch.cat([t.flatten().double() for t in optim.leaves(tree)])
    out = {}
    for part in ("net", "prop"):
        a, b = flat(grads_a[part]), flat(grads_b[part])
        out[part] = float(a @ b / (a.norm() * b.norm()))
    return out


def reference_prop_field(precision: str):
    """A proposal field whose ``eval_rays`` is ``prop_rays_reference`` (the
    plain versions both ways): what a step or a chunk through kernels 7 and
    8 is held against. The renderer calls only ``eval_rays``."""
    from tinynerf_torch.kernels import proposal_kernel as pk
    fn = functools.partial(pk.prop_flat, precision=precision)
    fn.eval_rays = functools.partial(pk.prop_rays_reference, precision=precision)
    return fn


def reference_grid_fields(cfg):
    """The net's and the proposal's grid fields with the plain versions
    (``grid_rays_reference``) as ``eval_rays``: what a step or a chunk
    through kernels 5 and 6 is held against."""
    from tinynerf_torch.core import gridfield
    from tinynerf_torch.kernels import grid_kernel as gk
    fields = []
    for nd in (cfg.grid_comp_density, cfg.prop_grid_comp_density):
        fn = functools.partial(gridfield.apply_grid_field, n_density=nd,
                               precision=cfg.precision)
        fn.eval_rays = functools.partial(gk.grid_rays_reference, n_density=nd,
                                         precision=cfg.precision)
        fields.append(fn)
    return fields


def run_config(conf: str, tmp: str, tag: str, steps: int, **overrides):
    """A Config from ``conf/<conf>.ini`` writing under ``tmp``, trained to
    ``steps`` below STEP (no preview JPG), with ``overrides``."""
    from tinynerf_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "conf", f"{conf}.ini"))
    cfg.ckpt_path = os.path.join(tmp, f"{tag}_ckpt")
    cfg.results_path = os.path.join(tmp, f"{tag}_results")
    cfg.log_dir = os.path.join(tmp, f"{tag}_runs")
    cfg.continue_ = False
    cfg.total_iter = steps
    cfg.step = 10 * steps
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def logged_losses(runner):
    with open(runner.logger.path) as f:
        return [json.loads(line)["loss/train"] for line in f]


def blender_scene(n_views: int, hw: int, seed: int):
    """An in-memory Blender-style scene: cameras on a radius-4 circle looking
    at the origin, lego's field of view, near/far 2/6, smooth random images."""
    import numpy as np
    from tinynerf_torch.data.poses import SceneData
    rng = np.random.default_rng(seed)
    focal = 0.5 * hw / np.tan(0.5 * 0.6911112070083618)
    rows = np.zeros((n_views, 17))
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views + 0.3
        pos = 4.0 * np.array([np.sin(theta), 0.5, np.cos(theta)])
        back = pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, pos], axis=1)
        hwf = np.array([[hw], [hw], [focal]])
        rows[i] = np.concatenate([np.concatenate([c2w, hwf], 1).ravel(), [2.0, 6.0]])
    base = rng.uniform(0.0, 1.0, (n_views, 8, 8, 3))
    images = np.kron(base, np.ones((1, hw // 8, hw // 8, 1))).astype(np.float32)
    return SceneData(images=images, poses_bounds=rows, height=hw, width=hw,
                     focal=float(focal))


def contracted_rows(rng, rows: int):
    """Rows as the renderer hands them to the field under CONTRACT: points in
    the contracted radius-2 ball, unit directions."""
    import numpy as np
    d = rng.normal(size=(rows, 3))
    radius = rng.uniform(0.0, 2.0, (rows, 1))
    pts = (d / np.linalg.norm(d, axis=-1, keepdims=True) * radius).astype(np.float32)
    v = rng.normal(size=(rows, 3))
    return pts, (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def llff_capture(n_views: int, seed: int, outward: bool, hw=None):
    """An in-memory LLFF-style capture at ``hw`` (height, width), by default
    ``CAPTURE_HW`` (a 4032x3024 capture at LOW_RES 4), seeded smooth images. ``outward``: an unbounded 360 ring,
    cameras on a radius-0.3 circle looking outward, per-image bounds about
    0.5 / 100 (conf/unbounded360.ini's capture); else a forward-facing one,
    cameras a few units apart all looking down -z at bounds about 2 / 25
    (conf/fern_ndc.ini's)."""
    import numpy as np
    from tinynerf_torch.data.poses import SceneData, view_matrix
    rng = np.random.default_rng(seed)
    height, width = hw or CAPTURE_HW
    focal = 0.8 * width
    rows = np.zeros((n_views, 17))
    for i in range(n_views):
        if outward:
            theta = 2 * np.pi * i / n_views
            out = np.array([np.sin(theta), 0.0, np.cos(theta)])
            c2w = view_matrix(-out, np.array([0.0, 1.0, 0.0]), 0.3 * out)
            bounds = (0.5 * rng.uniform(1.0, 1.2), 100.0 * rng.uniform(0.9, 1.0))
        else:
            back = np.array([0.0, 0.0, 1.0]) + rng.normal(scale=0.03, size=3)
            c2w = view_matrix(back, np.array([0.0, 1.0, 0.0]),
                              np.array([0.4 * (i % 2), 0.3 * (i // 2), 0.0]))
            bounds = (2.0 * rng.uniform(1.0, 1.1), 25.0 * rng.uniform(0.9, 1.0))
        rows[i, :15] = np.concatenate([c2w, [[height], [width], [focal]]], axis=1).ravel()
        rows[i, 15:] = bounds
    base = rng.uniform(0.0, 1.0, (n_views, 9, 12, 3))
    images = np.kron(base, np.ones((1, height // 9, width // 12, 1))).astype(np.float32)
    return SceneData(images=images, poses_bounds=rows, height=height, width=width,
                     focal=float(focal))


def fused_rays(device, n_rays: int, seed: int, empty: int = 0):
    """(origins, dirs, t_co, near, far) of ``n_rays`` rays from
    pixels_to_rays through random pixels of an 800x800 view of
    ``blender_scene`` (lego's field of view, near/far 2/6), t_co at
    FUSED_SAMPLES[0] samples; the last ``empty`` rays get near == far, as
    rays the occupancy grid empties."""
    import numpy as np
    import torch
    from tinynerf_torch.core import rays as raylib, sampling
    scene = blender_scene(1, 800, seed)
    rng = np.random.default_rng(seed)
    rows, cols = (torch.from_numpy(rng.uniform(0, 800, n_rays).astype(np.float32)).to(device)
                  for _ in range(2))
    pose = torch.from_numpy(scene.poses_bounds[0].astype(np.float32)).to(device)
    k_inv = raylib.make_k_inv(800, 800, scene.focal).to(device)
    o, d, near, far = raylib.pixels_to_rays(rows, cols, pose.expand(n_rays, 17), k_inv)
    near, far = near.contiguous(), far.contiguous().clone()
    if empty:
        far[-empty:] = near[-empty:]
    return o, d.contiguous(), sampling.coarse_ts(near, far, FUSED_SAMPLES[0]), near, far


def unfused_chunk(mk, params, origins, dirs, t_co, near, far, n_fine, white, precision):
    """The unfused path's work on kernel 9's rays, a yardstick for it:
    kernel 1 at the coarse t's, the PyTorch density, composite and resample,
    kernel 1 at the fine t's, the merged composite (``render_kernel._plain``
    with the kernel for the plain field) -> (C_coarse, C_fine)."""
    from tinynerf_torch.core import render, sampling
    n_coarse = t_co.shape[1]
    color_co, sigma_co = mk.field_rays(params, origins, dirs, t_co, precision)
    dense_co = render.get_density(((far - near) / n_coarse)[:, None].expand(t_co.shape),
                                  sigma_co)
    c_co = render.composite(dense_co, color_co)
    if white:
        c_co = c_co + (1.0 - dense_co.sum(dim=1))[:, None]
    t_fi = sampling.resample(t_co, dense_co, (far - near) / (n_coarse - 1), n_fine)
    color_fi, sigma_fi = mk.field_rays(params, origins, dirs, t_fi, precision)
    return c_co, render.merged_composite(t_co, t_fi, sigma_co, sigma_fi, color_co, color_fi,
                                         white_bkgd=white)


def fused_weight_bytes(rk, n_rays: int, n_coarse: int, n_fine: int, precision: str,
                       parent: bool = False) -> int:
    """Bytes of weights that kernel 9's field tiles read from L2 in one call,
    as arithmetic from the shapes, not a measurement: every tile streams the
    products' weights once (bf16: the packed 593,920 values; fp32: the
    590,848 float32 weights of the eleven products); a block's coarse rows,
    then its fine rows, in the library's tiles and rays per block, or with
    ``parent``, the earlier design's rule: 64-row tiles, max(1, 64 / N_c)
    rays a block, at shapes whose state fits."""
    lib = rk._library(rk.FWD_SOURCE)
    bf16 = precision == "bf16"
    if parent:
        rows, rpb = 64, max(1, 64 // n_coarse)
    else:
        rows = lib.render_fused_tile_rows(int(bf16))
        rpb = lib.render_fused_fwd_rays_per_block(n_coarse, n_fine, int(bf16))
    per_tile = 2 * lib.field_packed_weights_elems() if bf16 else 4 * 590_848
    tiles = 0
    for ray0 in range(0, n_rays, rpb):
        nr = min(rpb, n_rays - ray0)
        tiles += -(-nr * n_coarse // rows) - (-nr * n_fine // rows)
    return tiles * per_tile


def bwd_gemm_chain_ms_fp32(dev) -> float:
    """A yardstick beside kernel 2 fp32, not the same function (no encoding,
    biases, activations, heads or ray chain rule) and never called by the
    port: torch.matmul in float32, TF32 off, over the backward's 36 products
    at M = BWD_CHAIN_ROWS rows (each layer's forward X W, input gradient G
    W^T and weight gradient X^T G)."""
    import torch
    from tinynerf_torch.core import mlp
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    dims = [(fan_in, fan_out) for _, fan_in, fan_out in mlp.layer_dims()]
    xs = {k: rand(BWD_CHAIN_ROWS, k) for k in {k for k, _ in dims}}
    gs = {n: rand(BWD_CHAIN_ROWS, n) for n in {n for _, n in dims}}
    ws = [rand(k, n) for k, n in dims]

    def chain():
        for (k, n), w in zip(dims, ws):
            torch.matmul(xs[k], w)
            torch.matmul(gs[n], w.T)
            torch.matmul(xs[k].T, gs[n])
    return cuda_ms(chain, iters=10)


def kernel_wrappers() -> dict:
    """{name: wrapper} of every kernel wrapper, each with its ``launches``."""
    from tinynerf_torch.kernels import wrappers
    return wrappers()


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launched(**launches) -> dict:
    """``launch_counts()``'s form with the given counts and every other 0."""
    return {**{k: 0 for k in kernel_wrappers()}, **launches}


def check_no_launches(what: str) -> None:
    launches = launch_counts()
    print(f"{what}: kernel launches {launches} (expected none)")
    if any(launches.values()):
        raise AssertionError(f"{what} launched a kernel")


def flagship_phases(tmp: str, device: str) -> dict:
    """Phase 12b: ``conf/lego_hybrid.ini`` trained and rendered, and
    ``conf/lego_levels.ini`` and ``conf/lego_fold.ini`` trained and resumed,
    on ``device`` (the card; the CPU only to rehearse). The JAX package runs
    these grids in XLA (``GRID_PALLAS`` refuses the sigma net and the
    pyramid), so no TPU kernel lies on this path: the port runs the plain
    point field, and every kernel wrapper must stay at 0 launches. Returns
    the numbers of the summary line."""
    import numpy as np
    import torch
    from tinynerf_torch import ckpt, eval as evallib, optim, train
    from tinynerf_torch.core import gridfield, render
    from tinynerf_torch.runner import Runner
    dev = torch.device(device)

    def grid_counts(params, conf):
        counts = tuple(gridfield.num_params(params[k]) for k in ("net", "prop"))
        if counts != HYBRID_COUNTS[conf]:
            raise AssertionError(f"{conf}: {counts[0]:,} + {counts[1]:,} params, not the "
                                 f"full width's {HYBRID_COUNTS[conf]}")
        return counts

    def to_cpu(tree):
        return optim.tree_map(lambda t: t.cpu(), tree)

    phase("train-lego_hybrid-4096 (conf/lego_hybrid.ini: GRID_HYBRID and PROP_GRID_HYBRID, "
          "R = 384, bf16, occupancy grid; the plain point field, no kernel)")
    hcfg = run_config("lego_hybrid", tmp, "hybrid", HYBRID_STEPS)
    runner = Runner(hcfg, device=device,
                    scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=hcfg.seed))
    n_net, n_prop = grid_counts(runner.params, "lego_hybrid")
    sw = hcfg.grid_sigma_width or hcfg.grid_decoder_width
    print(f"{hcfg.precision}, BATCH_RAY {hcfg.batch_ray}, {hcfg.n_coarse}+{hcfg.n_fine} "
          f"samples; fine grid R={hcfg.grid_res}, {hcfg.grid_comp_density}+"
          f"{hcfg.grid_comp_app} components, decoder width {hcfg.grid_decoder_width}, "
          f"sigma net {hcfg.grid_comp_density}->{sw}->1 ({n_net:,} params); proposal grid "
          f"R={hcfg.prop_grid_res}, {hcfg.prop_grid_comp_density}+"
          f"{hcfg.prop_grid_comp_app}, width {hcfg.prop_grid_decoder_width}, sigma net "
          f"({n_prop:,} params); GRID_LR_MULT {hcfg.grid_lr_mult}, GRID_TV {hcfg.grid_tv}; "
          f"OCC_RES {hcfg.occ_res}, OCC_MARCH_STEPS {hcfg.occ_march_steps} (derived)")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hybrid_shares = []
    for end in (hcfg.occ_update_every, HYBRID_STEPS):  # read the grid after each refresh
        hcfg.total_iter = end
        runner.train()
        hybrid_shares.append(grid_shares(runner.state.occ))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"Runner.train(): {HYBRID_STEPS} steps of {hcfg.batch_ray} rays in {seconds:.2f} s "
          f"({seconds / HYBRID_STEPS * 1e3:.2f} ms/step, first steps included)")
    check_no_launches(f"lego_hybrid, {HYBRID_STEPS} steps")
    for it, (probed, occupied) in zip((0, hcfg.occ_update_every), hybrid_shares):
        print(f"grid after the refresh at iteration {it}: {100 * probed:.2f}% of cells "
              f"probed, {100 * occupied:.2f}% occupied")
    losses = logged_losses(runner)
    if len(losses) != HYBRID_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{len(losses)} logged losses, not all finite")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
          f"(step 0 {losses[0]:.4f}, step {HYBRID_STEPS - 1} {losses[-1]:.4f})")
    if not last < first:
        raise AssertionError("the lego_hybrid loss did not fall")

    step = train.make_train_step(hcfg, runner.train_table, runner.k_inv)
    state = runner.state
    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(6):
        state, _ = step(state)
    torch.cuda.synchronize()
    hybrid_ms = (time.perf_counter() - t0) / 6 * 1e3
    hybrid_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"BATCH_RAY {hcfg.batch_ray}: {hybrid_ms / 1e3:.5f} s/step, "
          f"{hcfg.batch_ray / hybrid_ms * 1e3:,.0f} rays/s; peak device memory "
          f"{hybrid_peak:.2f} GiB (torch.cuda.max_memory_allocated over 6 steps)")
    hybrid_profile = profile_steps(step, state)
    del step, state

    # one step's gradient on the card against the same step on the CPU
    batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(3),
                                      hcfg.batch_ray)
    occ = runner.state.occ
    _, _, g_card = train.loss_and_grads(train.make_loss_fn(hcfg, runner.k_inv),
                                        runner.params, batch, None, occ)
    t0 = time.perf_counter()
    _, _, g_cpu = train.loss_and_grads(
        train.make_loss_fn(hcfg, runner.k_inv.cpu()), to_cpu(runner.params),
        type(batch)(*(t.cpu() for t in batch)), None, type(occ)(*(t.cpu() for t in occ)))
    hybrid_cos = grid_part_cosines(g_card, g_cpu, ("lines", "decoder", "sigma_net"))
    print(f"one bf16 step, card vs CPU (the same params and batch; CPU "
          f"{time.perf_counter() - t0:.1f} s): gradient cosines "
          + ", ".join(f"{k} {v:.7f}" for k, v in hybrid_cos.items())
          + f" (limit {BF16_COS})")
    if min(hybrid_cos.values()) < BF16_COS:
        raise AssertionError("the lego_hybrid gradient on the card disagrees with the CPU's")
    hybrid_iter = runner.state.iteration - 1
    ckpt.save_checkpoint(hcfg.ckpt_path, "smoke", hybrid_iter, runner.params,
                         runner.state.opt, generator=runner.state.generator,
                         occ=runner.state.occ)
    trained_hybrid_occ = runner.state.occ
    del runner, g_card, g_cpu, batch, occ

    phase("render-lego_hybrid-800 (from that checkpoint: one 800x800 view, the occupancy "
          "grid; no kernel)")
    hcfg.continue_ = True
    scene = blender_scene(n_views=1, hw=800, seed=hcfg.seed)
    runner = Runner(hcfg, device=device, scene=scene)
    if runner.last_iter != hybrid_iter or not torch.equal(runner.state.occ.raw,
                                                         trained_hybrid_occ.raw):
        raise AssertionError("Runner did not resume the lego_hybrid checkpoint and its grid")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = evallib.render_test_set(
        hcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
        runner.last_iter, save=False, occ_grid=runner.state.occ)
    torch.cuda.synchronize()
    hybrid_frame_s = (time.perf_counter() - t0) / frames.shape[0]
    print(f"rendered {frames.shape[0]} view of {scene.height}x{scene.width} from the "
          f"iteration-{hybrid_iter} checkpoint: {hybrid_frame_s:.3f} s/frame "
          f"({math.ceil(scene.height * scene.width / hcfg.render_chunk)} chunks of "
          f"{hcfg.render_chunk} rays)")
    check_no_launches("the lego_hybrid render")
    if not (frames.shape == (1, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
            and frames.min() >= 0 and frames.max() <= 1):
        raise AssertionError("the lego_hybrid frame is not finite values in [0, 1]")
    print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
    with torch.no_grad():
        hw = scene.height * scene.width
        n_h_chunks = math.ceil(hw / hcfg.render_chunk)
        idx = torch.arange(hw, device=dev)[(n_h_chunks // 2) * hcfg.render_chunk:
                                           (n_h_chunks // 2 + 1) * hcfg.render_chunk]
        rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
        pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
        def chunk(on, cfg=hcfg):
            occ = runner.state.occ
            params = to_cpu(runner.params) if on == "cpu" else runner.params
            return render.render_rays(
                params["net"], *(t.to(on) for t in (rows, cols, pose, runner.k_inv)),
                cfg.n_coarse, cfg.n_fine, field_fn=evallib.make_field_fn(cfg),
                prop_field_fn=evallib.make_prop_field_fn(cfg), white_bkgd=True,
                occ_grid=type(occ)(*(t.to(on) for t in occ)), occ_march=cfg.occ_march_steps,
                prop_params=params["prop"], merge_impl="twolist")[1]

        # the same chunk on the card and on the CPU. fp32: every value within
        # 1e-3 (the two devices' float32 sums and exp differ in the last ulp,
        # which the resampler's slopes amplify in the fine t's). bf16: such a
        # difference can flip a rounding, which moves a sample's color by one
        # bf16 ulp (2^-8 on [0.5, 1)) and its weight with it, in a few
        # samples of a chunk; so the mean within the fp32 pixel bound, 1e-4,
        # and every value within four such ulps
        hybrid_pix_err = {}
        for precision in ("fp32", "bf16"):
            cfg = dataclasses.replace(hcfg, precision=precision)
            err = (chunk(dev, cfg).cpu() - chunk("cpu", cfg)).abs()
            hybrid_pix_err[precision] = {"max": float(err.max()), "mean": float(err.mean()),
                                         "above_1e-3": int((err > 1e-3).sum())}
            if precision == "fp32":
                bounds, ok = f"max {DEVICE_CHUNK_ATOL}", err.max() <= DEVICE_CHUNK_ATOL
            else:
                bounds = f"mean {CHUNK_ATOL}, max {BF16_COLOR_ATOL}"
                ok = err.mean() <= CHUNK_ATOL and err.max() <= BF16_COLOR_ATOL
            print(f"one {hcfg.render_chunk}-ray chunk, card vs CPU ({precision}): max |pixel "
                  f"err| {err.max():.3e}, mean {err.mean():.3e}, {int((err > 1e-3).sum())} of "
                  f"{err.numel()} values above 1e-3 (limits: {bounds})")
            if not ok:
                raise AssertionError(f"the lego_hybrid chunk on the card disagrees with the "
                                     f"CPU's at {precision}")
        hybrid_chunk_profile = profile_calls(lambda: chunk(dev), 5, "chunks")
    del runner

    levels = {}
    for conf in ("lego_levels", "lego_fold"):
        phase(f"train-{conf}-4096 (conf/{conf}.ini, {LEVELS_STEPS} steps; resumed from its "
              "checkpoint; no kernel)")
        lcfg = run_config(conf, tmp, conf, LEVELS_STEPS)
        runner = Runner(lcfg, device=device,
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=lcfg.seed))
        counts = grid_counts(runner.params, conf)
        tables = {k: tuple(t.shape) for k, t in runner.params["net"]["lines"].items()}
        print(f"GRID_RES {lcfg.grid_res}, GRID_LEVELS {lcfg.grid_levels}, GRID_LEVEL_FOLD "
              f"{lcfg.grid_level_fold}: tables {tables}; {counts[0]:,} + {counts[1]:,} params")
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        level_s = time.perf_counter() - t0
        check_no_launches(f"{conf}, {LEVELS_STEPS} steps")
        losses = logged_losses(runner)
        if len(losses) != LEVELS_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{conf}: not every loss is finite")
        it = runner.state.iteration - 1
        ckpt.save_checkpoint(lcfg.ckpt_path, "smoke", it, runner.params, runner.state.opt,
                             generator=runner.state.generator, occ=runner.state.occ)
        saved = {k: t.clone() for k, t in runner.params["net"]["lines"].items()}
        del runner
        lcfg.continue_ = True
        runner = Runner(lcfg, device=device,
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=lcfg.seed))
        back = runner.params["net"]["lines"]
        if runner.last_iter != it or set(back) != set(saved) or not all(
                torch.equal(back[k], saved[k]) for k in saved):
            raise AssertionError(f"{conf}: the resumed level tables are not the saved ones")
        print(f"{LEVELS_STEPS} steps in {level_s:.2f} s (first steps included); losses "
              f"{losses[0]:.4f} .. {losses[-1]:.4f}; resumed at iteration {it}: level "
              f"tables {sorted(back)} back, equal to the saved ones")
        levels[conf] = {"seconds_10_steps": level_s, "params": counts, "tables": tables}
        del runner

    return {"lego_hybrid": {"step_ms": hybrid_ms, "rays_per_s": hcfg.batch_ray / hybrid_ms * 1e3,
                            "peak_memory_gib": hybrid_peak, "step_profile": hybrid_profile,
                            "frame_s": hybrid_frame_s, "chunk_profile": hybrid_chunk_profile,
                            "grid_shares": hybrid_shares,
                            "grad_cosines_card_vs_cpu": hybrid_cos,
                            "chunk_pix_err_card_vs_cpu": hybrid_pix_err},
            **levels}


def option_phases(tmp: str, device: str) -> dict:
    """Phases 12c-12d: the Runner's one-device options on the card.

    12c, train-lego_grid-upsample-4096: ``conf/lego_grid.ini`` with
    ``GRID_PALLAS``, ``GRID_RES = 64``, ``GRID_UPSAMPLE = 100:128,200:256``
    and ``VAL_METRICS`` (the repo's validated schedule, cut to 300 steps) in
    three segments of 100; a checkpoint at 199 resumed across the milestone
    at 200. 12d, train-fern_ndc-hostfeed-4096: ``conf/fern_ndc.ini`` with
    ``HOST_FEED``, ``PROFILE_STEPS = 5``, ``VAL_METRICS`` and
    ``FUSED_RENDER`` on 4 views of a full-resolution 4032x3024 capture.
    Returns the numbers of the summary line and the launches by path of the
    kernels line."""
    import contextlib
    import io
    import numpy as np
    import torch
    from tinynerf_torch import ckpt, train
    from tinynerf_torch.data import native
    from tinynerf_torch.kernels import grid_kernel as gk
    from tinynerf_torch.runner import Runner
    dev = torch.device(device)
    rng = np.random.default_rng(15)
    paths, phase_s = {}, {}
    t_phase = time.perf_counter()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def finite_losses(runner, n, what):
        losses = logged_losses(runner)
        if len(losses) != n or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: {len(losses)} logged losses, not all finite")
        return losses

    # ---- 12c. GRID_UPSAMPLE: kernels 5 and 6 at R = 64, 128 and 256 ----
    phase("train-lego_grid-upsample-4096 (conf/lego_grid.ini, GRID_PALLAS, GRID_RES 64, "
          f"GRID_UPSAMPLE {UPSAMPLE_SCHEDULE}, VAL_METRICS; {UPSAMPLE_STEPS} steps in "
          f"{len(UPSAMPLE_SEGMENTS)} segments)")
    ucfg = run_config("lego_grid", tmp, "upsample", UPSAMPLE_STEPS, grid_pallas=True,
                      grid_res=UPSAMPLE_SEGMENTS[0][1], grid_upsample=UPSAMPLE_SCHEDULE,
                      val_metrics=True)
    scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=ucfg.seed)
    runner = Runner(ucfg, device=device, scene=scene)
    nd = ucfg.grid_comp_density
    print(f"{ucfg.precision}, BATCH_RAY {ucfg.batch_ray}, {ucfg.n_coarse}+{ucfg.n_fine} "
          f"samples; fine grid from R={ucfg.grid_res}, {nd}+{ucfg.grid_comp_app} components, "
          f"decoder width {ucfg.grid_decoder_width}; proposal grid R={ucfg.prop_grid_res}")
    segments, train_launches, val_launches = [], launched(), launched()
    for end, want_res in UPSAMPLE_SEGMENTS:
        ucfg.total_iter = end
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        runner.train()
        sync()
        seconds = time.perf_counter() - t0
        after = launch_counts()
        for k in after:
            train_launches[k] += after[k] - before[k]
        trees = {"params": runner.params, "mu": runner.state.opt.mu, "nu": runner.state.opt.nu}
        res = {name: sorted({t["net"]["lines"][ax].shape[0] for ax in "xyz"})
               for name, t in trees.items()}
        if any(r != [want_res] for r in res.values()):
            raise AssertionError(f"after iteration {end - 1} the fine tables and moments are "
                                 f"at R {res}, not {want_res}")
        before = launch_counts()
        val_db = runner.val_psnr()
        after = launch_counts()
        for k in after:
            val_launches[k] += after[k] - before[k]
        if not math.isfinite(val_db):
            raise AssertionError(f"the val PSNR at R={want_res} is not finite")
        o, d, ts = (torch.from_numpy(a).to(dev) for a in grid_rays_at(rng, *GRID_SHAPES[0][1:]))
        chk = grid_kernels_check(gk, runner.params["net"], nd, o, d, ts, ucfg.precision, rng)
        n_steps = end - (segments[-1]["end"] if segments else 0)
        print(f"iterations {end - n_steps}-{end - 1} at R={want_res} (tables, mu and nu): "
              f"{seconds:.2f} s, {seconds / n_steps * 1e3:.2f} ms/step (first steps and the "
              f"milestone included); val PSNR {val_db:.3f} dB; kernels 5 and 6 on the trained "
              f"tables at B={GRID_SHAPES[0][1]} N={GRID_SHAPES[0][2]}: {chk['line']}")
        if not chk["ok"]:
            raise AssertionError(f"kernels 5/6 disagree with their plain versions on the "
                                 f"trained R={want_res} tables: {chk['errs']}")
        segments.append({"end": end, "res": want_res, "ms_per_step": seconds / n_steps * 1e3,
                         "val_psnr_db": val_db, "bwd_worst_rel": chk["worst_rel"]})
        if end == UPSAMPLE_RESUME_AT:
            ckpt.save_checkpoint(ucfg.ckpt_path, "smoke", end - 1, runner.params,
                                 runner.state.opt, generator=runner.state.generator,
                                 occ=runner.state.occ)
    want = launched(grid_rays=2 * UPSAMPLE_STEPS, grid_rays_bwd=2 * UPSAMPLE_STEPS)
    print(f"launches in {UPSAMPLE_STEPS} steps: {train_launches} (expected kernels 5 and 6 "
          f"{2 * UPSAMPLE_STEPS} each, nothing else); the val passes: {val_launches}")
    if train_launches != want:
        raise AssertionError("the upsample path did not run kernels 5 and 6 (and only them) "
                             "on every grid call")
    losses = finite_losses(runner, UPSAMPLE_STEPS, "lego_grid upsample")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f}")
    if not last < first:
        raise AssertionError("the lego_grid upsample loss did not fall")
    del runner

    rcfg = dataclasses.replace(ucfg, continue_=True, total_iter=UPSAMPLE_STEPS)
    resumed = Runner(rcfg, device=device, scene=scene)
    res0 = resumed.params["net"]["lines"]["x"].shape[0]
    if resumed.last_iter != UPSAMPLE_RESUME_AT - 1 or res0 != UPSAMPLE_SEGMENTS[1][1]:
        raise AssertionError(f"the resume read iteration {resumed.last_iter} at R={res0}")
    before = launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed.train()
    print(out.getvalue(), end="")
    resumed_launches = {k: v - before[k] for k, v in launch_counts().items()}
    lines = out.getvalue().splitlines()
    milestone = (f"[GRID] upsampled line tables to R={UPSAMPLE_SEGMENTS[2][1]} before iter "
                 f"{UPSAMPLE_RESUME_AT}")
    resumed_losses = finite_losses(resumed, UPSAMPLE_STEPS - UPSAMPLE_RESUME_AT,
                                   "the resumed upsample run")
    res1 = resumed.params["net"]["lines"]["x"].shape[0]
    print(f"resumed from iteration {UPSAMPLE_RESUME_AT - 1} at R={res0}; the loop's first "
          f"lines {lines[:2]}; R={res1} after {UPSAMPLE_STEPS - UPSAMPLE_RESUME_AT} steps, "
          f"losses {resumed_losses[0]:.4f} .. {resumed_losses[-1]:.4f}; launches "
          f"{resumed_launches}")
    if lines[1:2] != [milestone] or res1 != UPSAMPLE_SEGMENTS[2][1]:
        raise AssertionError("the resumed run did not reach R=256 before its first step")
    del resumed, scene
    paths["upsample"] = {"train": train_launches, "val": val_launches,
                         "resumed": resumed_launches}
    phase_s["upsample"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 12d. HOST_FEED with the native store, PROFILE_STEPS, VAL_METRICS + FUSED_RENDER ----
    phase(f"train-fern_ndc-hostfeed-4096 (conf/fern_ndc.ini, HOST_FEED, PROFILE_STEPS "
          f"{HOSTFEED_PROFILE}, VAL_METRICS, FUSED_RENDER; {FERN_STEPS} steps on "
          f"{FERN_VIEWS} views of {HOSTFEED_HW[1]}x{HOSTFEED_HW[0]})")
    hcfg = run_config("fern_ndc", tmp, "hostfeed", FERN_STEPS, host_feed=True,
                      profile_steps=HOSTFEED_PROFILE, val_metrics=True, fused_render=True)
    t0 = time.perf_counter()
    h_scene = llff_capture(FERN_VIEWS, hcfg.seed, outward=False, hw=HOSTFEED_HW)
    capture_s = time.perf_counter() - t0
    runner = Runner(hcfg, device=device, scene=h_scene)
    table = runner.train_table
    host_bytes = table.host_pixels.nbytes
    print(f"capture made in {capture_s:.2f} s; host table {table.num_pix:,} pixels, "
          f"{host_bytes / 2 ** 20:.1f} MiB ({hcfg.pixel_dtype}); device pixels: "
          f"{table.pixels is not None}")
    if table.pixels is not None:
        raise AssertionError("HOST_FEED put the pixel table on the device")
    stores, first_batch = [], []
    make_feeder = runner._make_feeder

    def spy(tbl):
        store = make_feeder(tbl)
        take = store.next

        def next_batch():
            batch = take()
            if not first_batch:
                first_batch.append([a.copy() for a in batch])
            return batch

        store.next = next_batch
        stores.append(store)
        return store

    runner._make_feeder = spy
    zero_launches()
    sync()
    t0 = time.perf_counter()
    runner.train()
    sync()
    hostfeed_s = time.perf_counter() - t0
    feed_launches = launch_counts()
    print(f"Runner.train(): {FERN_STEPS} steps in {hostfeed_s:.2f} s (the traced steps and "
          f"the first steps included); launches {feed_launches}")
    if not (len(stores) == 1 and type(stores[0]) is native.HostRayStore):
        raise AssertionError(f"the Runner's store is {stores}, not one native HostRayStore")
    if stores[0]._handle is not None:
        raise AssertionError("the Runner did not close its store")
    if feed_launches != launched(field_rays=2 * FERN_STEPS, field_rays_bwd=2 * FERN_STEPS):
        raise AssertionError("the host-fed path did not run kernels 1 and 2 twice a step")
    finite_losses(runner, FERN_STEPS, "fern_ndc host-fed")
    plain_store = native.NumpyRayStore(table.host_pixels, table.poses.cpu().numpy(),
                                       table.height, table.width, seed=hcfg.seed)
    ref = plain_store.sample(0, hcfg.batch_ray)
    same = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(first_batch[0], ref))
    print(f"batch 0 of the Runner's store against NumpyRayStore's batch 0 (seed "
          f"{hcfg.seed}): bit-identical {same}")
    if not same:
        raise AssertionError("the native store's batch 0 differs from NumpyRayStore's")
    traces = glob.glob(os.path.join(hcfg.log_dir, "trace", "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} trace files under LOG_DIR/trace")
    with open(traces[0]) as f:
        text = f.read()
    names = {n: text.count(n) for n in HOSTFEED_TRACE_NAMES}
    print(f"trace {os.path.basename(traces[0])} ({len(text) / 2 ** 20:.1f} MiB): "
          f"occurrences {names}")
    if not all(names.values()):
        raise AssertionError("the trace does not name kernel 1's and kernel 2's entry points")
    zero_launches()
    fused_db = runner.val_psnr()
    fused_val = launch_counts()
    runner.cfg.fused_render = False
    plain_db = runner.val_psnr()
    runner.cfg.fused_render = True
    print(f"val PSNR through kernel 9: {fused_db:.4f} dB (launches {fused_val}); through the "
          f"unfused renderer: {plain_db:.4f} dB; |diff| {abs(fused_db - plain_db):.2e} dB "
          f"(limit {HOSTFEED_PSNR_DB})")
    if fused_val != launched(render_fused=1):
        raise AssertionError("the fused val pass did not launch kernel 9 once")
    if not (math.isfinite(fused_db) and abs(fused_db - plain_db) <= HOSTFEED_PSNR_DB):
        raise AssertionError("the fused val PSNR disagrees with the unfused one")
    # steady host-fed steps, each batch from the store and uploaded as the
    # Runner's loop does it: an asynchronous copy, the host arrays dropped at
    # once. Each upload is held against a host copy of its batch once the
    # card has run the steps: a copy that read a freed or refilled host
    # buffer would differ
    step = train.make_host_fed_train_step(hcfg, runner.k_inv, ndc_params=runner.ndc_params)
    store = runner._make_feeder(table)
    copies, uploads = [], []

    def upload_next():
        host = store.next()
        copies.append([a.copy() for a in host])
        uploads.append(table.upload(host))
        return uploads[-1]

    try:
        state = runner.state
        for _ in range(2):
            state, _ = step(state, upload_next())
        sync()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state, upload_next())
        sync()
        hostfeed_ms = (time.perf_counter() - t0) / 6 * 1e3
    finally:
        store.close()
    uploads_same = all(torch.equal(t.cpu(), torch.from_numpy(c))
                       for up, cs in zip(uploads, copies) for t, c in zip(up, cs))
    print(f"BATCH_RAY {hcfg.batch_ray}: {hostfeed_ms / 1e3:.5f} s/step host-fed, "
          f"{hcfg.batch_ray / hostfeed_ms * 1e3:,.0f} rays/s (phase 21 prints the device "
          f"table's); {len(uploads)} uploads equal to their host batches bit for bit: "
          f"{uploads_same}")
    if not uploads_same:
        raise AssertionError("an asynchronous upload differs from its host batch")
    paths["hostfeed"] = {"train": feed_launches, "val": fused_val}
    phase_s["hostfeed"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    del runner, h_scene, table, plain_store, state, step, uploads
    print("phases 12c-12d took " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

    return {"option_phase_seconds": phase_s,
            "lego_grid_upsample": {"segments": segments, "loss_first10": float(first),
                                   "loss_last10": float(last)},
            "fern_ndc_hostfeed": {"step_ms": hostfeed_ms, "train_s": hostfeed_s,
                                  "host_table_bytes": host_bytes, "capture_s": capture_s,
                                  "val_psnr_fused_db": fused_db, "val_psnr_unfused_db": plain_db,
                                  "trace_names": names},
            "launches": paths}


def falling_losses(runner, n: int, what: str):
    """The ``n`` logged losses: every one finite, the mean of the last 10
    below that of the first 10. Returns (first 10's mean, last 10's)."""
    import numpy as np
    losses = logged_losses(runner)
    if len(losses) != n or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: {len(losses)} logged losses, not all finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
          f"(step 0 {losses[0]:.4f}, step {n - 1} {losses[-1]:.4f})")
    if not last < first:
        raise AssertionError(f"the {what} loss did not fall")
    return first, last


def contracted_grid_phase(name: str, cfg, scene, device: str, keys) -> dict:
    """A shipped config whose fields are grids under ``CONTRACT`` (the JAX
    package runs them in XLA: no kernel on the path), trained and rendered
    on ``device`` from fresh seeded weights: every kernel wrapper at 0
    launches, a finite falling loss, s/step and the peak device memory of 6
    steps, a profile of five, one step's gradient on the card against the
    same step on the CPU on the trained state (``grad_vs_cpu``, for each
    grid's ``keys``), and one view rendered from the saved checkpoint
    (s/frame, finite, in [0, 1])."""
    import numpy as np
    import torch
    from tinynerf_torch import ckpt, eval as evallib, optim, train
    from tinynerf_torch.core import gridfield
    from tinynerf_torch.runner import Runner
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    steps = cfg.total_iter
    runner = Runner(cfg, device=device, scene=scene)
    counts = tuple(gridfield.num_params(runner.params[k]) for k in ("net", "prop"))
    print(f"{cfg.precision}, BATCH_RAY {cfg.batch_ray}, {cfg.n_coarse}+{cfg.n_fine} samples, "
          f"CONTRACT {cfg.contract}, LINDISP {cfg.lindisp}, STRATIFIED {cfg.stratified}, "
          f"DIST_LOSS {cfg.dist_loss}, PROP_INTERLEVEL {cfg.prop_interlevel}; fine grid "
          f"R={cfg.grid_res} {cfg.grid_comp_density}+{cfg.grid_comp_app}, width "
          f"{cfg.grid_decoder_width}, GRID_HYBRID {cfg.grid_hybrid} ({counts[0]:,} params); "
          f"proposal grid R={cfg.prop_grid_res} {cfg.prop_grid_comp_density}+"
          f"{cfg.prop_grid_comp_app}, width {cfg.prop_grid_decoder_width}, PROP_GRID_HYBRID "
          f"{cfg.prop_grid_hybrid} ({counts[1]:,} params); {scene.images.shape[0]} views of "
          f"{scene.height}x{scene.width}, bounds {runner.train_table.poses[:, 15].min():.2f} / "
          f"{runner.train_table.poses[:, 16].max():.1f}")
    zero_launches()
    sync()
    t0 = time.perf_counter()
    runner.train()
    sync()
    seconds = time.perf_counter() - t0
    print(f"Runner.train(): {steps} steps of {cfg.batch_ray} rays in {seconds:.2f} s "
          f"({seconds / steps * 1e3:.2f} ms/step, first steps included)")
    check_no_launches(f"{name}, {steps} steps")
    first, last = falling_losses(runner, steps, name)

    step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
    state = runner.state
    for _ in range(2):
        state, _ = step(state)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(6):
        state, _ = step(state)
    sync()
    step_ms = (time.perf_counter() - t0) / 6 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    print(f"BATCH_RAY {cfg.batch_ray}: {step_ms / 1e3:.5f} s/step, "
          f"{cfg.batch_ray / step_ms * 1e3:,.0f} rays/s; peak device memory "
          + (f"{peak:.2f} GiB (torch.cuda.max_memory_allocated over 6 steps)" if cuda
             else "not measured (CPU)"))
    profile = profile_steps(step, state) if cuda else None
    del step, state

    grad_check = grad_vs_cpu(name, cfg, runner, dev, keys)
    it = runner.state.iteration - 1
    ckpt.save_checkpoint(cfg.ckpt_path, "smoke", it, runner.params, runner.state.opt,
                         generator=runner.state.generator)
    del runner

    phase(f"render-{name} (from that checkpoint: one {scene.height}x{scene.width} view; "
          "no kernel)")
    cfg.continue_ = True
    runner = Runner(cfg, device=device, scene=scene)
    if runner.last_iter != it:
        raise AssertionError(f"Runner did not resume the {name} checkpoint")
    zero_launches()
    sync()
    t0 = time.perf_counter()
    frames = evallib.render_test_set(cfg, runner.params, runner.test_table, runner.k_inv,
                                     runner.start_time, runner.last_iter, save=False,
                                     max_views=1)
    sync()
    frame_s = time.perf_counter() - t0
    print(f"rendered 1 view of {scene.height}x{scene.width} from the iteration-{it} "
          f"checkpoint: {frame_s:.3f} s/frame ({math.ceil(scene.height * scene.width / cfg.render_chunk)}"
          f" chunks of {cfg.render_chunk} rays); frame mean {frames.mean():.4f}")
    check_no_launches(f"the {name} render")
    if not (frames.shape == (1, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
            and frames.min() >= 0 and frames.max() <= 1):
        raise AssertionError(f"the {name} frame is not finite values in [0, 1]")
    del runner
    return {"step_ms": step_ms, "rays_per_s": cfg.batch_ray / step_ms * 1e3,
            "train_s": seconds, "peak_memory_gib": peak, "step_profile": profile,
            "frame_s": frame_s, "grad_card_vs_cpu": grad_check, "params": counts,
            "loss_first10": first, "loss_last10": last}


def grad_vs_cpu(name: str, cfg, runner, dev, keys) -> dict:
    """One step's gradient on the card against the same step on the CPU, on
    the Runner's trained params and one batch, per part (``keys`` of each
    grid, ``grid_part_cosines``), in two checks.

    - fp32: the step at ``PRECISION = fp32``, cosine >= GRAD_COS (0.9999)
      per part. That function's gradient moves by 1 - cos ~ 1e-5 under a
      one-ulp change of every param (0.999992+ in
      ``tests/grad_conditioning.py``), so this is the check that the card
      computes the function the CPU does.
    - bf16 (the config's precision): per part, the card-vs-CPU cosine must
      reach BF16_COS, or else be no worse than the worst of COND_TRIALS
      trials on the CPU of the same step with every param times ``1 +
      COND_ULP N(0, 1)`` (about one float32 ulp, as
      ``tests/grad_conditioning.py``) against the unmoved step, less a
      margin of COND_MARGIN times that worst trial's own distance from 1:
      ``1 - cos_card <= (1 + COND_MARGIN) (1 - cos_worst)``. The bf16
      roundings turn last-ulp differences into whole bf16 ulps, so the
      gradient is conditioned no better than the trials show, and the
      trained state's conditioning varies from call to call (the training's
      ``index_add_`` atomics sum in another order each call). Three draws
      sample that spread thinly: on ``conf/unbounded360.ini``'s states
      trained 30 steps on an H100, ``net.lines``' three trials spread up to
      fourfold in ``1 - cos`` within one state, and their worst read
      0.99859-0.99918 across three states, so a fourth draw can land a few
      times further out than the worst of three; hence the margin of twice
      that distance. The floor never goes below COND_FLOOR (0.99, seven
      times further from 1 than the worst trial seen), so that a bf16
      function turned chaotic on the CPU, whose trials would drag the floor
      down with it, fails loudly. The card's own cosine read 0.99966-0.99997 on those
      states, inside the worst trial every time. A card that computed
      another function stays far outside the margin (and fails the fp32
      check).
    The printout says, per part, which of the two decided the bf16 check.
    """
    import dataclasses
    import torch
    from tinynerf_torch import optim, train
    to_cpu = lambda tree: optim.tree_map(lambda t: t.cpu(), tree)
    batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(3), cfg.batch_ray)
    batch_cpu = type(batch)(*(t.cpu() for t in batch))
    params_cpu = to_cpu(runner.params)
    k_cpu = runner.k_inv.cpu()
    grads = lambda c, k, p, b: train.loss_and_grads(train.make_loss_fn(c, k), p, b)[2]

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, precision="fp32")
    cos32 = grid_part_cosines(grads(cfg32, runner.k_inv, runner.params, batch),
                              grads(cfg32, k_cpu, params_cpu, batch_cpu), keys)
    g_card = grads(cfg, runner.k_inv, runner.params, batch)
    g_cpu = grads(cfg, k_cpu, params_cpu, batch_cpu)
    cos = grid_part_cosines(g_card, g_cpu, keys)
    nudge = lambda seed: (lambda t: t * (1 + COND_ULP * torch.randn(
        t.shape, generator=torch.Generator().manual_seed(seed))))
    trials = [grid_part_cosines(g_cpu, grads(cfg, k_cpu, optim.tree_map(nudge(100 + i), params_cpu),
                                             batch_cpu), keys)
              for i in range(COND_TRIALS)]
    worst = {k: min(t[k] for t in trials) for k in cos}
    floor = {k: max(COND_FLOOR, 1 - (1 + COND_MARGIN) * (1 - worst[k])) for k in cos}
    decided = {k: ("BF16_COS" if cos[k] >= BF16_COS else
                   "conditioning" if cos[k] >= floor[k] else "failed") for k in cos}
    fmt = lambda d: ", ".join(f"{k} {v:.7f}" for k, v in d.items())
    print(f"one step, card vs CPU on the trained state (the same params and batch; "
          f"{time.perf_counter() - t0:.1f} s with the CPU's {2 + COND_TRIALS} steps):")
    print(f"  fp32 gradient cosines: {fmt(cos32)} (limit GRAD_COS {GRAD_COS})")
    print(f"  {cfg.precision} gradient cosines: {fmt(cos)} (limit BF16_COS {BF16_COS}, or the "
          "conditioning)")
    print(f"  {cfg.precision} conditioning on the CPU, the worst of {COND_TRIALS} trials of every "
          f"param x (1 + {COND_ULP} N(0, 1)): {fmt(worst)}; the floor, the larger of {COND_FLOOR} "
          f"and 1 - {1 + COND_MARGIN:g} (1 - worst): {fmt(floor)}")
    print(f"  the {cfg.precision} check decided by: "
          + ", ".join(f"{k} {v}" for k, v in decided.items()))
    if min(cos32.values()) < GRAD_COS:
        raise AssertionError(f"the {name} fp32 gradient on the card disagrees with the CPU's")
    if "failed" in decided.values():
        raise AssertionError(f"the {name} {cfg.precision} gradient on the card disagrees with "
                             "the CPU's beyond its conditioning")
    return {"fp32_cosines": cos32, "cosines": cos, "conditioning_worst": worst,
            "conditioning_trials": trials, "floor": floor, "decided_by": decided}


def shipped_phases(tmp: str, device: str, occ_cfg) -> dict:
    """Phases 23-27 on ``device`` (the card; the CPU only to rehearse):
    ``conf/lego_coarse.ini``, ``conf/unbounded360.ini`` as shipped and
    ``conf/synthetic360.ini`` trained and rendered, the legacy field
    (``core/legacy.py``) card vs CPU, and the render service
    (``tools/serve_render.py``) on ``occ_cfg``'s checkpoint (phase 7's
    ``lego_occ``). Returns the numbers of the summary line and the launches
    by path of the kernels line."""
    import threading
    import urllib.request
    import numpy as np
    import torch
    from tinynerf_torch import ckpt, eval as evallib, optim, train
    from tinynerf_torch.config import Config
    from tinynerf_torch.core import legacy, render
    from tinynerf_torch.core.rays import make_k_inv
    from tinynerf_torch.data import paths
    from tinynerf_torch.kernels import mlp_kernel as mk
    from tinynerf_torch.runner import Runner
    from tinynerf_torch.tools import render_shipped_ckpt, serve_render
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    launches, phase_s = {}, {}

    # ---- 23. conf/lego_coarse.ini: the coarse pass alone, kernels 1 and 2 ----
    t_phase = time.perf_counter()
    phase("train-lego_coarse-4096 (conf/lego_coarse.ini: bf16, 64 coarse samples, N_FINE = 0; "
          "kernels 1 and 2 once a step)")
    ccfg = run_config("lego_coarse", tmp, "coarse", COARSE_STEPS)
    if ccfg.n_fine != 0 or ccfg.proposal or ccfg.precision != "bf16":
        raise AssertionError("conf/lego_coarse.ini is not the bf16 coarse-only config")
    scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=ccfg.seed)
    runner = Runner(ccfg, device=device, scene=scene)
    print(f"{ccfg.precision}, BATCH_RAY {ccfg.batch_ray}, N_COARSE {ccfg.n_coarse}, N_FINE "
          f"{ccfg.n_fine}; {TRAIN_VIEWS} views of 800x800")
    zero_launches()
    sync()
    t0 = time.perf_counter()
    runner.train()
    sync()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    print(f"Runner.train(): {COARSE_STEPS} steps of {ccfg.batch_ray} rays in {seconds:.2f} s "
          f"({seconds / COARSE_STEPS * 1e3:.2f} ms/step, first steps included); launches {got}")
    if got != launched(field_rays=COARSE_STEPS, field_rays_bwd=COARSE_STEPS):
        raise AssertionError("lego_coarse did not run kernels 1 and 2 (and only them) once "
                             "a step")
    launches["lego_coarse train"] = got
    coarse_losses = falling_losses(runner, COARSE_STEPS, "lego_coarse")
    step = train.make_train_step(ccfg, runner.train_table, runner.k_inv)
    state = runner.state
    for _ in range(2):
        state, _ = step(state)
    sync()
    t0 = time.perf_counter()
    for _ in range(6):
        state, _ = step(state)
    sync()
    coarse_ms = (time.perf_counter() - t0) / 6 * 1e3
    print(f"BATCH_RAY {ccfg.batch_ray}: {coarse_ms / 1e3:.5f} s/step, "
          f"{ccfg.batch_ray / coarse_ms * 1e3:,.0f} rays/s")
    coarse_iter = runner.state.iteration - 1
    ckpt.save_checkpoint(ccfg.ckpt_path, "smoke", coarse_iter, runner.params, runner.state.opt,
                         generator=runner.state.generator)
    del runner, state, step

    phase("render-lego_coarse-800 (from that checkpoint: one 800x800 view, kernel 1 once a "
          "chunk)")
    ccfg.continue_ = True
    scene = blender_scene(n_views=1, hw=800, seed=ccfg.seed)
    runner = Runner(ccfg, device=device, scene=scene)
    if runner.last_iter != coarse_iter:
        raise AssertionError("Runner did not resume the lego_coarse checkpoint")
    n_pix = scene.height * scene.width
    chunks = math.ceil(n_pix / ccfg.render_chunk)
    zero_launches()
    sync()
    t0 = time.perf_counter()
    frames = evallib.render_test_set(ccfg, runner.params, runner.test_table, runner.k_inv,
                                     runner.start_time, runner.last_iter, save=False)
    sync()
    coarse_frame_s = time.perf_counter() - t0
    got = launch_counts()
    print(f"rendered 1 view of 800x800: {coarse_frame_s:.3f} s/frame; launches {got} "
          f"(expected kernel 1 once a chunk, {chunks})")
    if got != launched(field_rays=chunks):
        raise AssertionError("the lego_coarse render did not run kernel 1 (and only it) once "
                             "a chunk")
    launches["lego_coarse render"] = got
    if not (np.all(np.isfinite(frames)) and frames.min() >= 0 and frames.max() <= 1):
        raise AssertionError("the lego_coarse frame is not finite values in [0, 1]")
    with torch.no_grad():
        idx = torch.arange(n_pix, device=dev)[(chunks // 2) * ccfg.render_chunk:
                                              (chunks // 2 + 1) * ccfg.render_chunk]
        args = ((idx // scene.width).float(), (idx % scene.width).float(),
                runner.test_table.poses[0].expand(idx.shape[0], 17), runner.k_inv,
                ccfg.n_coarse, ccfg.n_fine)
        c_kernel = render.render_rays(runner.params, *args, field_fn=evallib.make_field_fn(ccfg))[1]
        c_plain = render.render_rays(runner.params, *args, field_fn=functools.partial(
            mk.field_flat_plain, precision=ccfg.precision))[1]
        coarse_err = float((c_kernel - c_plain).abs().max())
    print(f"a real chunk, kernel 1 (bf16) vs the bf16 plain field: max |pixel err| "
          f"{coarse_err:.3e} (atol {BF16_CHUNK_ATOL})")
    if not coarse_err <= BF16_CHUNK_ATOL:
        raise AssertionError("the lego_coarse chunk through kernel 1 disagrees with the plain "
                             "field's")
    del runner
    phase_s["lego_coarse"] = time.perf_counter() - t_phase

    # ---- 24-25. the contracted grids, as shipped: no kernel ----
    t_phase = time.perf_counter()
    phase("train-unbounded360-4096 (conf/unbounded360.ini as shipped: the grid fine field at "
          "R = 256 under CONTRACT, LINDISP, the proposal grid, DIST_LOSS, PROP_INTERLEVEL, bf16; "
          "no kernel)")
    ucfg = run_config("unbounded360", tmp, "u360_grid", U360_GRID_STEPS)
    if not (ucfg.fine_field == "grid" and ucfg.contract and ucfg.proposal):
        raise AssertionError("conf/unbounded360.ini is not the contracted grid config")
    u360 = contracted_grid_phase("unbounded360", ucfg,
                                 llff_capture(U360_VIEWS, ucfg.seed, outward=True), device,
                                 ("lines", "decoder"))
    phase_s["unbounded360"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    phase("train-synthetic360-1024 (conf/synthetic360.ini: the hybrid grids at R = 384 under "
          "CONTRACT, LINDISP, bf16; no kernel)")
    scfg = run_config("synthetic360", tmp, "s360", S360_STEPS)
    if not (scfg.grid_hybrid and scfg.prop_grid_hybrid and scfg.contract):
        raise AssertionError("conf/synthetic360.ini is not the contracted hybrid config")
    s360 = contracted_grid_phase("synthetic360", scfg,
                                 llff_capture(U360_VIEWS, scfg.seed, outward=True), device,
                                 ("lines", "decoder", "sigma_net"))
    phase_s["synthetic360"] = time.perf_counter() - t_phase

    # ---- 26. the legacy field: plain PyTorch, as the JAX package runs it in XLA ----
    t_phase = time.perf_counter()
    phase(f"legacy (core/legacy.py: the retired field from seeded params; one "
          f"{LEGACY_HW}x{LEGACY_HW} view = one {LEGACY_HW ** 2}-ray chunk, card vs CPU; no kernel)")
    params = legacy.init_legacy(torch.Generator().manual_seed(17))
    params["sigma"]["b"] += 1.0   # a field with content
    n_legacy = legacy.n_params(params)
    if n_legacy != legacy.N_PARAMS:
        raise AssertionError(f"the legacy field has {n_legacy:,} params, not 543,052")
    focal = 0.5 * LEGACY_HW / np.tan(render_shipped_ckpt.LEGO_FOV / 2)
    row = render_shipped_ckpt.orbit_rows(1, LEGACY_HW, focal, 4.03)[0]
    lcfg = Config(n_coarse=16, n_fine=32, use_pallas=False, render_chunk=LEGACY_HW ** 2,
                  white_bkgd=True)
    legacy_frames, legacy_s = {}, None
    for on in (dev, torch.device("cpu")):
        frame_fn = evallib.make_frame_fn(lcfg, make_k_inv(LEGACY_HW, LEGACY_HW, focal, on),
                                         LEGACY_HW, LEGACY_HW, field_fn=legacy.field_legacy)
        p = optim.tree_map(lambda t: t.to(on), params)
        zero_launches()
        legacy_frames[on.type] = frame_fn(p, row)
        check_no_launches(f"the legacy frame on {on.type}")
        if legacy_s is None:
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                frame_fn(p, row)
            sync()
            legacy_s = (time.perf_counter() - t0) / 5
    legacy_err = float(np.abs(legacy_frames[dev.type] - legacy_frames["cpu"]).max())
    print(f"{n_legacy:,} params; {lcfg.n_coarse}+{lcfg.n_fine} samples; one chunk on the "
          f"card in {legacy_s * 1e3:.2f} ms; card vs CPU: max |pixel err| {legacy_err:.3e} "
          f"(atol {LEGACY_ATOL}); frame mean {legacy_frames[dev.type].mean():.4f}")
    if not (np.isfinite(legacy_frames[dev.type]).all() and legacy_err <= LEGACY_ATOL):
        raise AssertionError("the legacy chunk on the card disagrees with the CPU's")
    phase_s["legacy"] = time.perf_counter() - t_phase

    # ---- 27. the render service on phase 7's lego_occ checkpoint ----
    t_phase = time.perf_counter()
    phase("serve (tools/serve_render.py on phase 7's lego_occ checkpoint: render_u8 at scales "
          f"{SERVE_SCALES}, kernel 1 twice a chunk; GET /info over HTTP)")
    occ_cfg.continue_ = True
    runner = Runner(occ_cfg, device=device,
                    scene=blender_scene(n_views=2, hw=800, seed=occ_cfg.seed))
    if runner.last_iter < 0:
        raise AssertionError("the service found no lego_occ checkpoint")
    svc = serve_render.Service(occ_cfg, runner)
    serve = {}
    zero_launches()
    for scale in SERVE_SCALES:
        row = svc.pose(scale=scale, **SERVE_VIEW)
        h, w = (int(v) for v in row[:15].reshape(3, 5)[:2, 4])
        chunks = rendered_chunks(h * w, occ_cfg.render_chunk, serve_render.HOST_CHUNKS)
        before = launch_counts()["field_rays"]
        sync()
        t0 = time.perf_counter()
        u8 = svc.render_u8(scale=scale, **SERVE_VIEW)
        sync()
        first_s = time.perf_counter() - t0
        first_launches = launch_counts()["field_rays"] - before
        t0 = time.perf_counter()
        for _ in range(SERVE_FRAMES):
            svc.render_u8(scale=scale, **SERVE_VIEW)
        sync()
        frame_s = (time.perf_counter() - t0) / SERVE_FRAMES
        print(f"scale {scale}: {h}x{w} frame, {chunks} chunks rendered (graphs of "
              f"{serve_render.HOST_CHUNKS}, the last group padded with the last chunk); the first (its frame function "
              f"made) in {first_s:.3f} s, then {frame_s:.3f} s/frame over {SERVE_FRAMES}; kernel "
              f"1 launches {first_launches} a frame ({first_launches / chunks:g} a chunk, "
              "expected 2); frame mean "
              f"{u8.mean() / 255:.4f}")
        if first_launches != 2 * chunks or u8.shape != (h, w, 3) or u8.dtype != np.uint8:
            raise AssertionError(f"the service's frame at scale {scale} did not run kernel 1 "
                                 "twice a chunk, or is not (H, W, 3) uint8")
        serve[f"scale_{scale}"] = {"hw": (h, w), "first_frame_s": first_s, "frame_s": frame_s,
                                   "field_rays_per_chunk": first_launches / chunks}
    got = launch_counts()
    n_frames = len(SERVE_SCALES) * (1 + SERVE_FRAMES)
    expected = sum(2 * rendered_chunks(v["hw"][0] * v["hw"][1], occ_cfg.render_chunk,
                                       serve_render.HOST_CHUNKS)
                   for v in serve.values()) * (1 + SERVE_FRAMES)
    if got != launched(field_rays=expected):
        raise AssertionError(f"the service's {n_frames} frames launched {got}, not kernel 1 "
                             f"{expected} times alone")
    launches["serve render"] = got
    # render_u8 against the port's frame function at the same free_pose, bit for bit
    row = paths.free_pose(svc.pose_rows, SERVE_VIEW["theta"], elev_deg=SERVE_VIEW["elev"],
                          radius_scale=SERVE_VIEW["radius"], res_scale=1.0)
    hwf = row[:15].reshape(3, 5)[:, 4]
    frame_fn = evallib.make_frame_fn(occ_cfg, make_k_inv(*(float(v) for v in hwf), dev),
                                     int(hwf[0]), int(hwf[1]), occ_grid=runner.state.occ,
                                     ndc_params=runner.ndc_params)
    want = (np.clip(frame_fn(runner.params, row), 0.0, 1.0) * 255.0).astype(np.uint8)
    same = bool(np.array_equal(svc.render_u8(scale=1.0, **SERVE_VIEW), want))
    print(f"render_u8 at free_pose{tuple(SERVE_VIEW.values())} against eval.make_frame_fn at "
          f"the same pose: equal bit for bit {same}")
    if not same:
        raise AssertionError("the service's frame differs from the port's frame function's")
    server = serve_render.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    query = "theta={theta}&elev={elev}&radius={radius}".format(**SERVE_VIEW)
    try:
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=60).read())
        zero_launches()
        jpeg = urllib.request.urlopen(f"{base}/frame?{query}&scale={SERVE_SCALES[0]}",
                                      timeout=120).read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    got = launch_counts()
    want_hw = serve[f"scale_{SERVE_SCALES[0]}"]["hw"]
    frame_hw = jpeg_size(jpeg)
    print(f"GET /frame?{query}&scale={SERVE_SCALES[0]}: {len(jpeg)} bytes, SOI "
          f"{jpeg[:2].hex()}, EOI {jpeg[-2:].hex()}, SOF0 {frame_hw[0]}x{frame_hw[1]} (the "
          f"frame {want_hw[0]}x{want_hw[1]}); kernel 1 launches {got['field_rays']}")
    chunks = rendered_chunks(want_hw[0] * want_hw[1], occ_cfg.render_chunk, serve_render.HOST_CHUNKS)
    if not (jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9" and frame_hw == want_hw
            and len(jpeg) > 1000 and got == launched(field_rays=2 * chunks)):
        raise AssertionError("GET /frame did not answer with the frame's JPEG")
    launches["serve GET /frame"] = got
    print(f"GET /info: {info}")
    if (info["iteration"] != runner.last_iter or info["backend"] != dev.type
            or (info["height"], info["width"]) != (runner.train_table.height,
                                                   runner.train_table.width)
            or not info["occ_grid"]):
        raise AssertionError("/info does not describe the served lego_occ checkpoint")
    serve["info"] = info
    del runner, svc
    phase_s["serve"] = time.perf_counter() - t_phase
    print("phases 23-27 took " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

    return {"shipped_phase_seconds": phase_s,
            "lego_coarse": {"step_ms": coarse_ms, "rays_per_s": ccfg.batch_ray / coarse_ms * 1e3,
                            "train_s": seconds, "frame_s": coarse_frame_s,
                            "chunk_pix_err": coarse_err, "losses": coarse_losses},
            "unbounded360": u360, "synthetic360": s360,
            "legacy": {"params": n_legacy, "chunk_ms": legacy_s * 1e3,
                       "chunk_pix_err_card_vs_cpu": legacy_err},
            "serve": {**serve, "frame_jpeg_bytes": len(jpeg)}, "launches": launches}


def jpeg_size(data: bytes):
    """(height, width) from a baseline JPEG's SOF0 segment."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xC0:
            return struct.unpack(">HH", data[pos + 5:pos + 9])
        pos += 2 + length
    raise AssertionError("no SOF0 segment in the JPEG")


def image_file_times(root: str) -> dict:
    """The port's image files on this host (``data/imagefile.py``): ms to
    decode an 800x800 RGBA view of the scene maker (written by
    ``write_png``, whose rows take Sub, Up, Average and Paeth filters) and
    to encode its RGB as a JPEG at quality 75, the best of three each; the
    decode bit-equal to the written pixels. Beside them, where Pillow
    imports, the library calls they stand in for, timed alike: Pillow's
    decode of the same file and its 4:4:4 JPEG of the same pixels (no path
    of the port calls Pillow for these)."""
    import io
    import timeit
    import numpy as np
    from tinynerf_torch.data import imagefile
    from tinynerf_torch.tools import make_synthetic_scene as maker
    rgba = maker.render_view(maker.look_at(np.array([1.5, 1.2, 3.5])), IMAGE_FILE_HW)
    rgb = np.ascontiguousarray(rgba[..., :3])
    path = os.path.join(root, "view800.png")
    imagefile.write_png(path, rgba)
    imagefile.read_png(path)   # builds the unfilter where it is not built yet
    best = lambda fn: min(timeit.repeat(fn, number=1, repeat=3)) * 1e3
    decode_ms = best(lambda: imagefile.read_png(path))
    jpeg_ms = best(lambda: imagefile.write_jpeg(None, rgb, 75))
    same = bool(np.array_equal(imagefile.read_png(path), rgba))
    try:
        from PIL import Image
    except ImportError:
        Image = None
    pil_decode_ms = pil_jpeg_ms = None
    if Image is not None:
        pil_decode_ms = best(lambda: np.asarray(Image.open(path)))
        pil_jpeg_ms = best(lambda: Image.fromarray(rgb).save(io.BytesIO(), "JPEG", quality=75,
                                                             subsampling=0))
    pil = ("Pillow not importable: its times not measured" if Image is None else
           f"Pillow: decode {pil_decode_ms:.1f} ms, JPEG {pil_jpeg_ms:.1f} ms")
    print(f"image files: an {IMAGE_FILE_HW}x{IMAGE_FILE_HW} RGBA view decodes in "
          f"{decode_ms:.1f} ms (bit-equal {same}; 100 views {decode_ms / 10:.2f} s), encodes as "
          f"a JPEG at quality 75 in {jpeg_ms:.1f} ms (the best of three each, host clock); {pil}")
    if not same:
        raise AssertionError("read_png did not return the pixels write_png wrote")
    return {"decode_800_rgba_ms": decode_ms, "jpeg_800_q75_ms": jpeg_ms,
            "pillow_decode_800_rgba_ms": pil_decode_ms, "pillow_jpeg_800_q75_ms": pil_jpeg_ms}


def validate_phase(tmp: str, device: str) -> dict:
    """Phase 29: the validate protocol from files on disk, needing neither
    Pillow nor imageio (it prints whether each imports here). In a fresh directory under ``tmp``: the port's scene
    maker writes the sync capture (VALIDATE_HW, VALIDATE_VIEWS views); the
    port's validate tool runs the ``full`` family on it for
    VALIDATE_ITERS steps (the CLI in a subprocess, which must exit 0) and
    its JSON row must parse with a finite PSNR, SSIM and rays/s, the PSNR
    VALIDATE_MARGIN_DB above that of predicting each test view's mean
    colour (the test PNGs read back through ``imagefile.read_png``); the
    preview JPG, the per-view JPGs and the ``.gif`` must exist with their
    signatures. Then, in this process, a Runner on the same ``val.ini``
    resumes the last checkpoint and takes one training step (kernels 1 and
    2 once), one occupancy refresh (kernel 3 once) and one test view
    (kernel 1 once a chunk), nothing else launched. Last,
    ``tools.profile_step --occ --steps 5`` prints its table."""
    import numpy as np
    import torch
    from tinynerf_torch import eval as evallib, train
    from tinynerf_torch.config import load_config
    from tinynerf_torch.data.poses import load_scene
    from tinynerf_torch.runner import Runner
    t_phase = time.perf_counter()
    phase(f"validate-full-{VALIDATE_HW} (tinynerf_torch.tools.validate --family full --iters "
          f"{VALIDATE_ITERS} on the scene maker's {VALIDATE_VIEWS}-view {VALIDATE_HW}x"
          f"{VALIDATE_HW} capture; kernels 1-3 on its checkpoint; profile_step)")
    root = tempfile.mkdtemp(prefix="validate_", dir=tmp)
    scene, out = os.path.join(root, "scene"), os.path.join(root, "out")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    run = lambda args, timeout: subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                               capture_output=True, text=True, timeout=timeout)
    for name in ("PIL", "imageio"):
        found = subprocess.run([sys.executable, "-c", f"import {name}"], capture_output=True).returncode == 0
        print(f"{name} importable on this machine: {found}")
    t0 = time.perf_counter()
    made = run(["tinynerf_torch.tools.make_synthetic_scene", scene, "--hw", str(VALIDATE_HW),
                "--views", str(VALIDATE_VIEWS)], 300)
    scene_s = time.perf_counter() - t0
    print(f"scene maker: {made.stdout.strip()} ({scene_s:.1f} s, rc {made.returncode})")
    if made.returncode != 0:
        print(made.stderr[-3000:])
        raise AssertionError("the scene maker failed")
    io_ms = image_file_times(root)
    t0 = time.perf_counter()
    val = run(["tinynerf_torch.tools.validate", "--family", "full", "--iters",
               str(VALIDATE_ITERS), "--scene", scene, "--out", out], 900)
    validate_s = time.perf_counter() - t0
    log = [ln for ln in val.stderr.splitlines() if ln.startswith(("[ITER]", "Test PSNR"))]
    print("\n".join(log[-6:]))
    if val.returncode != 0:
        print(val.stderr[-3000:])
        raise AssertionError(f"the validate tool failed (rc {val.returncode})")
    row = json.loads(val.stdout.strip().splitlines()[-1])
    print(f"validate row: {json.dumps(row)} ({validate_s:.1f} s)")
    test = load_scene(scene, "sync", "test")
    baseline = float(np.mean([evallib.psnr(np.broadcast_to(img.mean(axis=(0, 1)), img.shape), img)
                              for img in test.images]))
    print(f"test PSNR {row['psnr_db']} dB, SSIM {row['ssim']}; predicting each of the "
          f"{test.num_pics} test views' mean colour: {baseline:.2f} dB (the row must be "
          f"{VALIDATE_MARGIN_DB} dB above); sustained {row['sustained_rays_per_sec']} rays/s")
    numbers = [row[k] for k in ("psnr_db", "ssim", "sustained_rays_per_sec")]
    if not all(isinstance(v, (int, float)) and math.isfinite(v) for v in numbers):
        raise AssertionError("the validate row has a missing or non-finite number")
    if not row["psnr_db"] >= baseline + VALIDATE_MARGIN_DB:
        raise AssertionError("the validate run's PSNR is not above the mean-colour baseline")
    results = os.path.join(out, "results")
    previews = glob.glob(os.path.join(results, "*.jpg"))
    views = glob.glob(os.path.join(results, "*", "*.jpg"))
    gifs = glob.glob(os.path.join(results, "*.gif"))
    heads = {p: open(p, "rb").read(6) for p in previews + views + gifs}
    print(f"files: {len(previews)} preview JPG, {len(views)} per-view JPGs, {len(gifs)} .gif, "
          f"{len(glob.glob(os.path.join(results, '*.mp4')))} .mp4")
    if not (previews and len(views) == test.num_pics and len(gifs) == 1
            and all(heads[p][:3] == b"\xff\xd8\xff" for p in previews + views)
            and heads[gifs[0]] == b"GIF89a"):
        raise AssertionError("the validate run did not write its JPGs and .gif")

    # kernels 1-3 on the run's trained state
    cfg = load_config(row["ini"])
    cfg.continue_ = True
    runner = Runner(cfg, device=device)
    if runner.last_iter != VALIDATE_ITERS - 1:
        raise AssertionError("the Runner did not resume the validate run's last checkpoint")
    sync = torch.cuda.synchronize
    step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
    zero_launches()
    state, _ = step(runner.state)
    sync()
    step_launches = launch_counts()
    zero_launches()
    every = cfg.occ_update_every
    refreshed = train.refresh_occ(cfg, dataclasses.replace(
        state, iteration=-(-state.iteration // every) * every), evallib.make_field_fn(cfg))
    sync()
    refresh_launches = launch_counts()
    frame = lambda: evallib.render_test_set(cfg, state.params, runner.test_table, runner.k_inv,
                                            runner.start_time, runner.last_iter, save=False,
                                            max_views=1, occ_grid=refreshed)
    zero_launches()
    frame()
    sync()
    frame_launches = launch_counts()
    t0 = time.perf_counter()
    frames = frame()
    sync()
    frame_s = time.perf_counter() - t0
    chunks = math.ceil(VALIDATE_HW ** 2 / cfg.render_chunk)
    print(f"on the iteration-{runner.last_iter} checkpoint: one step {step_launches}; one "
          f"refresh {refresh_launches}; one {VALIDATE_HW}x{VALIDATE_HW} view ({chunks} chunks) "
          f"{frame_launches}, {frame_s:.3f} s/frame, mean {frames.mean():.4f}")
    if (step_launches != launched(field_rays=1, field_rays_bwd=1)
            or refresh_launches != launched(field_flat=1)
            or frame_launches != launched(field_rays=chunks)):
        raise AssertionError("kernels 1-3 did not run (alone) on the validate checkpoint")
    del runner, state, refreshed, step

    t0 = time.perf_counter()
    prof = run(["tinynerf_torch.tools.profile_step", "--occ", "--steps", "5", "--out",
                os.path.join(root, "trace")], 300)
    print(prof.stdout.rstrip())
    if prof.returncode != 0 or not glob.glob(os.path.join(root, "trace", "*.pt.trace.json")):
        print(prof.stderr[-3000:])
        raise AssertionError("tools.profile_step failed")
    total = time.perf_counter() - t_phase
    step_s = cfg.batch_ray / row["sustained_rays_per_sec"]
    print(f"validate-full-{VALIDATE_HW}: {step_s:.5f} s/step (the row's rays/s), {frame_s:.3f} "
          f"s/frame at {VALIDATE_HW}x{VALIDATE_HW}; the tool's wall time {row['wall_s']} s; "
          f"profile_step {time.perf_counter() - t0:.1f} s; the phase {total:.1f} s")
    return {"validate_full": {"row": row, "mean_colour_psnr_db": baseline, "step_s": step_s,
                              "frame_s": frame_s, "scene_s": scene_s, "phase_s": total},
            "image_files_ms": io_ms,
            "launches": {"validate full checkpoint step": step_launches,
                         "validate full refresh": refresh_launches,
                         "validate full view": frame_launches}}


def _dp_record(store: dict, sync):
    """``train.make_train_step`` wrapped to record each step of a Runner's
    loop: its start and end (synchronised), then the params' digest, the
    launch counts, the loss and the rank's rows, and the occupancy grid
    after the first step."""
    from tinynerf_torch import train
    from tinynerf_torch.parallel import distributed as dist
    real = train.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def recorded(state):
            sync()
            start = time.perf_counter()
            state, m = step(state)
            sync()
            store["steps"].append((start, time.perf_counter()))
            store["digests"].append(dist.params_digest(state.params))
            store["launches"].append(launch_counts())
            store["losses"].append(float(m["loss"]))
            store["rows"].append(int(m["rows"].shape[0]))
            if "occ_after_0" not in store:
                store["occ_after_0"] = [state.occ.raw.cpu(), state.occ.density.cpu()]
            return state, m
        return recorded

    return real, make


def _timed(sync, fn):
    """``fn()``'s result and its seconds, synchronised on both sides."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def dp_rank(work: str, lego_ckpt: str, tag: str, device: str = "cuda") -> None:
    """Phases 28 and 28b on one rank of a job of ``DP_RANKS`` (started by
    ``parallel.distributed.spawn``; ``tag`` names the backend). Trains
    ``conf/lego_occ.ini`` with ``MESH_SHAPE = 2`` for ``DP_STEPS`` steps
    from fresh seeded weights through ``Runner.train``, one step a call
    (each rank its own CKPT_PATH, LOG_DIR, RESULTS_PATH: only rank 0's may
    fill), recording every step (``_dp_record``); before that, one
    gradient on fixed indices through ``mesh.make_grad_fn`` and the times
    of the gradient all-reduce and of the refresh's gather. Then one
    800x800 view from rank 0's
    checkpoint, data-parallel; then phase 28b, ``conf/lego.ini`` with
    ``SAMPLE_SHARD = 2`` on phase 5's checkpoint (``lego_ckpt``): one view
    and one 4096-ray chunk at ``N_FINE = DEEP_FINE``. Writes
    ``<tag>_rank<r>.json`` (and rank 0 its tensors) under ``work``. The
    preview canvas is saved as ``.npy`` beside its JPG's name: the card's
    machine has no imageio. ``device``: the card (the CPU only to
    rehearse)."""
    import numpy as np
    import torch
    from tinynerf_torch import eval as evallib, logging as tlog, optim, train
    from tinynerf_torch.config import load_config
    from tinynerf_torch.parallel import distributed as dist, mesh as meshlib, sample_shard
    from tinynerf_torch.runner import Runner
    rank = dist.rank()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mine = os.path.join(work, f"{tag}_rank{rank}")
    rec = {"rank": rank, "card": torch.cuda.current_device() if cuda else None, "backend": tag,
           "steps": [], "digests": [], "launches": [], "losses": [], "rows": []}
    tensors = {}

    def save_preview(canvas, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path + ".npy", canvas.canvas)

    tlog.PreviewCanvas.save = save_preview
    cfg = run_config("lego_occ", mine, "dp", DP_STEPS, mesh_shape=DP_RANKS, step=DP_STEP)
    runner = Runner(cfg, device=device, scene=blender_scene(TRAIN_VIEWS, 800, cfg.seed))
    mesh = runner.mesh
    idx = np.random.default_rng(28).integers(0, runner.train_table.num_pix, cfg.batch_ray)
    batch = runner.train_table.gather(torch.from_numpy(idx))
    grad_fn = meshlib.make_grad_fn(train.make_loss_fn(cfg, runner.k_inv), mesh)
    loss, _, grads = grad_fn(runner.params, batch, None, runner.state.occ)
    tensors["grad"] = (float(loss), optim.tree_map(lambda t: t.cpu(), grads))
    flat = optim.leaves(grads)
    probes = torch.zeros(int(cfg.occ_res ** 3 * cfg.occ_subset) // DP_RANKS, device=device)
    for what, fn in (("allreduce_ms", lambda: meshlib.reduce_grads(mesh, loss, flat)),
                     ("refresh_gather_ms", lambda: mesh.gather_rows(probes, 2 * probes.shape[0]))):
        fn()
        rec[what] = _timed(sync, lambda: [fn() for _ in range(10)])[1] / 10 * 1e3
    rec["grad_numel"] = sum(g.numel() for g in flat)

    real, recording = _dp_record(rec, sync)
    train.make_train_step = recording
    # the eager mesh step, one a call, each recorded (phase 31 takes chunks)
    chunk_size = Runner.__dict__["_chunk_size"]
    Runner._chunk_size = staticmethod(lambda step: 1)
    zero_launches()
    try:
        rec["train_s"] = _timed(sync, runner.train)[1]
    finally:
        train.make_train_step = real
        Runner._chunk_size = chunk_size
    rec["train_launches"] = launch_counts()
    tensors["occ_after_0"] = rec.pop("occ_after_0")
    rec["files"] = sorted(os.path.relpath(os.path.join(r, f), mine)
                          for r, _, fs in os.walk(mine) for f in fs)
    del runner, batch, grads, flat

    # one view from rank 0's checkpoint, its chunks split over the ranks
    rcfg = dataclasses.replace(cfg, continue_=True,
                               ckpt_path=os.path.join(work, f"{tag}_rank0", "dp_ckpt"))
    runner = Runner(rcfg, device=device, scene=blender_scene(2, 800, rcfg.seed))
    rec["render_iter"] = runner.last_iter
    zero_launches()
    frames, rec["frame_s"] = _timed(sync, lambda: evallib.render_test_set(
        rcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
        runner.last_iter, save=False, max_views=1, occ_grid=runner.state.occ,
        mesh=runner.mesh))
    rec["frame_launches"] = launch_counts()
    tensors["frame"] = frames[0]
    del runner

    # 28b: lego (fp32) with SAMPLE_SHARD = 2 on phase 5's checkpoint
    lcfg = load_config(os.path.join(ROOT, "conf", "lego.ini"))
    lcfg.ckpt_path, lcfg.continue_ = lego_ckpt, True
    lcfg.results_path = os.path.join(mine, "lego_results")
    lcfg.log_dir = os.path.join(mine, "lego_runs")
    lcfg.mesh_shape, lcfg.sample_shard = DP_RANKS, DP_RANKS
    runner = Runner(lcfg, device=device, scene=blender_scene(2, 800, lcfg.seed))
    rec["ss_mesh"] = (runner.mesh.n_data, runner.mesh.n_sample)
    zero_launches()
    frames, rec["ss_frame_s"] = _timed(sync, lambda: evallib.render_test_set(
        lcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
        runner.last_iter, save=False, max_views=1, mesh=runner.mesh))
    rec["ss_frame_launches"] = launch_counts()
    tensors["ss_frame"] = frames[0]
    # one chunk of the deep march: the frame's middle chunk of view 0
    rows, cols, pose = deep_chunk(runner, lcfg)
    fn = sample_shard.make_sample_sharded_render(
        runner.mesh, runner.k_inv, lcfg.n_coarse, DEEP_FINE,
        field_fn=evallib.make_field_fn(lcfg), white_bkgd=lcfg.white_bkgd)
    fn(runner.params, rows, cols, pose)
    zero_launches()
    (c_co, c_fi), seconds = _timed(sync, lambda: fn(runner.params, rows, cols, pose))
    rec["deep_ms"] = seconds * 1e3
    rec["deep_launches"] = launch_counts()
    tensors["deep"] = (c_co.cpu(), c_fi.cpu())
    del runner
    with open(os.path.join(work, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    if rank == 0:
        torch.save(tensors, os.path.join(work, f"{tag}_tensors.pt"))


def deep_chunk(runner, cfg):
    """The rows, columns and pose rows of the middle ``RENDER_CHUNK``-ray
    chunk of the test split's view 0."""
    import torch
    height, width = runner.test_table.height, runner.test_table.width
    start = (height * width // cfg.render_chunk // 2) * cfg.render_chunk
    idx = torch.arange(start, start + cfg.render_chunk, device=runner.k_inv.device)
    rows, cols = (idx // width).float(), (idx % width).float()
    return rows, cols, runner.test_table.poses[0].expand(rows.shape[0], 17)


def _dp_train_checks(tag: str, pair, batch_ray: int, first1: float) -> dict:
    """Phase 28's checks of one job's training: launches per rank and step,
    the rank's rows, the digests after every step, the losses, rank 0
    alone writing, the first loss against the one-rank step's."""
    import numpy as np
    for r in pair:
        per_step = [{k: b[k] - a[k] for k in b} for a, b in
                    zip([launched()] + r["launches"][:-1], r["launches"])]
        want = [launched(field_rays=2, field_rays_bwd=2, field_flat=int(i == 0))
                for i in range(DP_STEPS)]
        ms = [(b - a) * 1e3 for a, b in r["steps"]]
        print(f"[{tag}] rank {r['rank']} on card {r['card']}: launches per step "
              f"{per_step[0]} (step 0, with the refresh), {per_step[1]} (step 1); rows a "
              f"rank {sorted(set(r['rows']))}; ms/step {ms[0]:.2f} (step 0), "
              f"{np.mean(ms[2:]):.2f} (steps 2-{DP_STEPS - 1}, mean; {min(ms[2:]):.2f}-"
              f"{max(ms[2:]):.2f}); gradient all-reduce of {r['grad_numel']:,} floats "
              f"{r['allreduce_ms']:.3f} ms, the refresh's gather {r['refresh_gather_ms']:.3f} ms")
        if per_step != want:
            raise AssertionError(f"[{tag}] rank {r['rank']} did not launch kernels 1 and 2 "
                                 "twice a step and kernel 3 once in the refresh")
        if set(r["rows"]) != {batch_ray // DP_RANKS}:
            raise AssertionError(f"[{tag}] rank {r['rank']} did not take half the batch")
    r0, r1 = pair
    if r0["digests"] != r1["digests"] or len(r0["digests"]) != DP_STEPS:
        raise AssertionError(f"[{tag}] the ranks' params differ after some step")
    losses = r0["losses"]
    if r1["losses"] != losses:
        raise AssertionError(f"[{tag}] the ranks' losses differ")
    if not all(math.isfinite(x) for x in losses) or not np.mean(losses[-5:]) < np.mean(
            losses[:5]):
        raise AssertionError(f"[{tag}] the loss is not finite and falling: {losses}")
    ckpts = [f for f in r0["files"] if f.endswith(".npz")]
    logs = [f for f in r0["files"] if f.endswith("metrics.jsonl")]
    rel = abs(losses[0] / first1 - 1)
    print(f"[{tag}] params digests equal on both ranks after each of {DP_STEPS} steps; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (one rank's first step {first1:.4f}, rel "
          f"{rel:.2e}, limit {DP_LOSS_RTOL}); rank 0 wrote {len(r0['files'])} files "
          f"({len(ckpts)} checkpoints, {len(logs)} log), rank 1 {len(r1['files'])}")
    if len(ckpts) != DP_STEPS // DP_STEP or len(logs) != 1 or r1["files"]:
        raise AssertionError(f"[{tag}] artifacts were not written by rank 0 alone")
    if not rel <= DP_LOSS_RTOL:
        raise AssertionError(f"[{tag}] the first step's loss is not the one-rank step's")
    ms = [(b - a) * 1e3 for a, b in r0["steps"]]
    return {"ms_per_step": float(np.mean(ms[2:])), "ms_per_step_range": [min(ms[2:]),
                                                                          max(ms[2:])],
            "first_step_ms": ms[0], "train_s": r0["train_s"], "losses": losses,
            "allreduce_ms": [r["allreduce_ms"] for r in pair],
            "refresh_gather_ms": [r["refresh_gather_ms"] for r in pair],
            "first_loss_rel_err": rel}


def parallel_phases(tmp: str, lego_ckpt: str, lego_view0, device: str = "cuda") -> dict:
    """Phases 28 and 28b (``parallel/``): ``dp_rank`` on two ranks of the
    one card under gloo (``backend="gloo"`` passed) and, where the machine
    has two cards or more, on two cards under NCCL, held against one rank
    in this process: launches per rank and step, the ranks' digests after
    every step, the grid of the refresh at 0 against the one-rank refresh,
    the first step's loss and gradient against the one-rank step on the
    same indices, a falling loss, rank 0 alone writing; the data-parallel
    view against the one-rank view; the sample-sharded view against phase
    6's view 0 and its deep chunk against the one-rank chunk. Returns the
    summary line's numbers and the launches by path (the gloo job's).
    ``device``: the card (the CPU only to rehearse)."""
    import numpy as np
    import torch
    from tinynerf_torch import eval as evallib, train
    from tinynerf_torch.config import load_config
    from tinynerf_torch.core import render
    from tinynerf_torch.parallel import distributed as dist
    from tinynerf_torch.runner import Runner
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
           if cuda else "the CPU")
    work = os.path.join(tmp, "dp")
    os.makedirs(work, exist_ok=True)
    if cuda:
        torch.cuda.empty_cache()
    phase(f"train-lego_occ-dp2-4096 (conf/lego_occ.ini with MESH_SHAPE = {DP_RANKS}, "
          f"{DP_STEPS} steps of 4096 rays, 2048 a rank; a view split over the ranks) and 28b, "
          f"render-lego-ss2-800 (conf/lego.ini with SAMPLE_SHARD = {DP_RANKS}): {DP_RANKS} ranks "
          "on the one card under gloo, and on two cards under NCCL where there are two")
    jobs = {"gloo": dict(backend="gloo", device_index=0 if cuda else None)}
    if cuda and torch.cuda.device_count() >= DP_RANKS:
        jobs["nccl"] = {}
    job_s = {}
    for tag, kw in jobs.items():
        t0 = time.perf_counter()
        dist.spawn("chip_smoke:dp_rank", DP_RANKS, device, (work, lego_ckpt, tag, device), **kw)
        job_s[tag] = time.perf_counter() - t0
    recs = {tag: [json.load(open(os.path.join(work, f"{tag}_rank{r}.json")))
                  for r in range(DP_RANKS)] for tag in jobs}
    tensors = {tag: torch.load(os.path.join(work, f"{tag}_tensors.pt"), weights_only=False)
               for tag in jobs}
    print(f"{smi}; each job of {DP_RANKS} ranks (process start, kernels loaded from the build, "
          f"scenes, {DP_STEPS} steps, two views, the deep chunk): "
          + ", ".join(f"{tag} {s:.1f} s" for tag, s in job_s.items())
          + ("" if "nccl" in jobs else "; one card: no NCCL job"))

    # the one-rank references, in this process
    one = os.path.join(tmp, "dp_one")
    cfg = run_config("lego_occ", one, "one", 1)
    runner = Runner(cfg, device=device, scene=blender_scene(TRAIN_VIEWS, 800, cfg.seed))
    idx = np.random.default_rng(28).integers(0, runner.train_table.num_pix, cfg.batch_ray)
    loss1, _, grads1 = train.loss_and_grads(train.make_loss_fn(cfg, runner.k_inv), runner.params,
                                            runner.train_table.gather(torch.from_numpy(idx)),
                                            None, runner.state.occ)
    runner.train()   # one step: the refresh at 0
    occ1 = (runner.state.occ.raw.cpu(), runner.state.occ.density.cpu())
    first1 = logged_losses(runner)[0]
    del runner
    lcfg = load_config(os.path.join(ROOT, "conf", "lego.ini"))
    lcfg.ckpt_path, lcfg.continue_ = lego_ckpt, True
    lcfg.results_path, lcfg.log_dir = os.path.join(one, "lego_res"), os.path.join(one, "lego_runs")
    runner = Runner(lcfg, device=device, scene=blender_scene(2, 800, lcfg.seed))
    rows, cols, pose = deep_chunk(runner, lcfg)
    field_fn = evallib.make_field_fn(lcfg)
    args = (runner.params, rows, cols, pose, runner.k_inv, lcfg.n_coarse, DEEP_FINE)
    with torch.no_grad():
        render.render_rays(*args, field_fn=field_fn, merge_impl="twolist")
        (c_co1, c_fi1), seconds = _timed(sync, lambda: render.render_rays(
            *args, field_fn=field_fn, merge_impl="twolist"))
    deep1 = (c_co1.cpu(), c_fi1.cpu(), seconds * 1e3)
    del runner
    n_chunks = math.ceil(800 * 800 / lcfg.render_chunk)

    out = {"card": smi, "job_s": job_s}
    for tag in jobs:
        pair, ten = recs[tag], tensors[tag]
        res = _dp_train_checks(tag, pair, cfg.batch_ray, first1)
        if tag == "gloo":
            print(f"s/step with {DP_RANKS} ranks on one card under gloo: "
                  f"{res['ms_per_step'] / 1e3:.5f} (two processes share the card and the "
                  "gradient goes through the host: not a speed figure)")
        # the first step's gradient, and the refresh's grid
        loss2, grads2 = ten["grad"]
        worst = min(_tree_cosines(grads2, grads1).values())
        rel = abs(loss2 / float(loss1) - 1)
        occ_equal = all(torch.equal(a, b) for a, b in zip(ten["occ_after_0"], occ1))
        occ_diff = float(torch.nan_to_num((ten["occ_after_0"][0] - occ1[0]).abs(), nan=0.0).max())
        print(f"[{tag}] the first step on fixed indices, {DP_RANKS} ranks vs one: loss rel "
              f"{rel:.2e} (limit {DP_LOSS_RTOL}); gradient cosine per part, smallest {worst:.7f} "
              f"(limit {BF16_COS}); the grid after the refresh at 0 (half the "
              f"{int(cfg.occ_res ** 3 * cfg.occ_subset)} probes through kernel 3 on each rank) "
              f"equal to the one-rank grid bit for bit: {occ_equal} (max |diff| {occ_diff:.3e})")
        if not (rel <= DP_LOSS_RTOL and worst >= BF16_COS and occ_equal):
            raise AssertionError(f"[{tag}] the data-parallel step disagrees with one rank's")
        res.update(grad_loss_rel_err=rel, grad_min_cosine=worst, occ_bit_equal=occ_equal)

        # the data-parallel view against the one-rank view of this job's
        # checkpoint (each job trains its own, and two jobs' need not agree)
        g0 = pair[0]
        rcfg = dataclasses.replace(cfg, continue_=True,
                                   ckpt_path=os.path.join(work, f"{tag}_rank0", "dp_ckpt"))
        runner = Runner(rcfg, device=device, scene=blender_scene(2, 800, rcfg.seed))
        frame1 = evallib.render_test_set(
            rcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False, max_views=1, occ_grid=runner.state.occ)[0]
        del runner
        dp_err = float(np.abs(ten["frame"] - frame1).max())
        ss_err = float(np.abs(ten["ss_frame"] - lego_view0).max())
        deep_err = max(float((ten["deep"][0] - deep1[0]).abs().max()),
                       float((ten["deep"][1] - deep1[1]).abs().max()))
        launches = lambda key: [r[key]["field_rays"] for r in pair]
        print(f"[{tag}] render-lego_occ-dp2-800: the view from iteration {g0['render_iter']}, "
              f"its chunks split over the ranks, {g0['frame_s']:.3f} s; kernel 1 launches a "
              f"rank {launches('frame_launches')} (expected {2 * n_chunks}); against the "
              f"one-rank view: max |diff| {dp_err:.3e} (limit {BF16_CHUNK_ATOL})")
        print(f"[{tag}] render-lego-ss2-800: data {g0['ss_mesh'][0]} x sample "
              f"{g0['ss_mesh'][1]}, {lcfg.n_coarse} coarse + {lcfg.n_fine // DP_RANKS} fine "
              f"samples a rank, {g0['ss_frame_s']:.3f} s; kernel 1 launches a rank "
              f"{launches('ss_frame_launches')} (expected {2 * n_chunks}); against phase 6's "
              f"view 0 (one rank): max |diff| {ss_err:.3e} (limit {CHUNK_ATOL})")
        print(f"[{tag}] one {lcfg.render_chunk}-ray chunk at {lcfg.n_coarse} + {DEEP_FINE} "
              f"samples, {DEEP_FINE // DP_RANKS} fine a rank: {g0['deep_ms']:.2f} ms (one rank "
              f"{deep1[2]:.2f} ms); kernel 1 launches a rank {launches('deep_launches')} "
              f"(expected 2); against the one-rank chunk: max |diff| {deep_err:.3e} (limit "
              f"{CHUNK_ATOL})")
        for r in pair:
            if (r["frame_launches"] != launched(field_rays=2 * n_chunks)
                    or r["ss_frame_launches"] != launched(field_rays=2 * n_chunks)
                    or r["deep_launches"] != launched(field_rays=2)):
                raise AssertionError(f"[{tag}] a view or the deep chunk did not run kernel 1 "
                                     "twice a chunk on each rank, and nothing else")
        if not (dp_err <= BF16_CHUNK_ATOL and ss_err <= CHUNK_ATOL and deep_err <= CHUNK_ATOL):
            raise AssertionError(f"[{tag}] a data-parallel or sample-sharded render disagrees "
                                 "with the one-rank render")
        res.update(frame_s=g0["frame_s"], frame_err=dp_err, ss_frame_s=g0["ss_frame_s"],
                   ss_frame_err=ss_err, deep_ms=g0["deep_ms"], deep_one_rank_ms=deep1[2],
                   deep_err=deep_err)
        out[tag] = res

    both = lambda key: {k: sum(r[key][k] for r in recs["gloo"]) for k in launch_counts()}
    out["launches"] = {DP_TRAIN: both("train_launches"),
                       "lego_occ data-parallel render (2 ranks)": both("frame_launches"),
                       "lego sample-sharded render (2 ranks)": both("ss_frame_launches"),
                       "lego sample-sharded deep chunk (2 ranks)": both("deep_launches")}
    return out


def _tree_cosines(a, b) -> dict:
    """Per leaf (keys joined by /), the cosine of two gradient trees."""
    import torch
    out = {}

    def walk(x, y, name):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{name}/{k}" if name else k)
        else:
            u, v = x.double().flatten().cpu(), y.double().flatten().cpu()
            norm = float(u.norm() * v.norm())
            out[name] = float(u @ v) / norm if norm > 0 else float(torch.equal(u, v))

    walk(a, b, "")
    return out


def rendered_chunks(n_pix: int, chunk: int, group: int) -> int:
    """The chunks a frame of ``n_pix`` pixels renders in graphs of ``group``
    chunks (``eval.make_frame_fn``'s ``host_chunks``; 0 is the whole view):
    the last group padded with repeats of the last chunk, as the JAX
    package pads it."""
    n = math.ceil(n_pix / chunk)
    group = n if not group else max(1, min(group, n))
    return math.ceil(n / group) * group


def clone_state(state):
    """A copy of a train state that shares no tensor with it, its generator's
    state included (a chunk on the card spends the state it is given)."""
    import torch
    from tinynerf_torch import optim, train
    c = lambda t: t.clone()
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    occ = None if state.occ is None else type(state.occ)(*[t.clone() for t in state.occ])
    return train.TrainState(params=optim.tree_map(c, state.params),
                            opt=optim.AdamState(state.opt.count, optim.tree_map(c, state.opt.mu),
                                                optim.tree_map(c, state.opt.nu)),
                            iteration=state.iteration, generator=gen, occ=occ)


def state_tensors(state) -> list:
    from tinynerf_torch import optim
    return (optim.leaves(state.params) + optim.leaves(state.opt.mu)
            + optim.leaves(state.opt.nu) + ([] if state.occ is None else list(state.occ)))


def moment_cosines(a, b) -> dict:
    """{part: cosine} of two trees of one structure (Adam's first moments),
    per top-level part of the params (an MLP's layers; the net and the
    proposal field), in float64; a part that is 0 in both (a grid's frozen
    extent) is left out."""
    import torch
    from tinynerf_torch import optim
    out = {}
    for part in a:
        flat = lambda tree: torch.cat([t.flatten().double() for t in optim.leaves(
            tree[part] if isinstance(tree[part], dict) else {"_": tree[part]})])
        x, y = flat(a), flat(b)
        if float(x.norm()) == 0.0 and float(y.norm()) == 0.0:
            continue
        out[part] = float(x @ y / (x.norm() * y.norm()))
    return out


def api_launches(fn, n: int) -> float:
    """Host API calls that queue work on the card (kernel and graph launches,
    asynchronous copies and fills) per call of ``fn``, from torch.profiler's
    CUDA API events over ``n`` calls (after one untraced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync", "LaunchCooperative")
    calls = sum(e.count for e in prof.key_averages()
                if e.key.startswith("cu") and any(k in e.key for k in names))
    return calls / n


def graph_paths(tmp: str):
    """(name, cfg, scene) of phase 30's graphed training paths, each at its
    config's full width; an occupancy grid refreshes every
    GRAPH_REFRESH_EVERY steps, so that its refresh graph is replayed."""
    paths = []
    for name, conf, kw in GRAPH_PATHS:
        cfg = run_config(conf, tmp, f"graph_{name}", 3 * GRAPH_K, **kw)
        if cfg.occ_grid:
            cfg.occ_update_every = GRAPH_REFRESH_EVERY
        scene = (llff_capture(U360_VIEWS, cfg.seed, outward=True) if conf == "unbounded360"
                 else blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=cfg.seed))
        paths.append((name, cfg, scene))
    return paths


def graph_train_path(name: str, cfg, scene, dev) -> dict:
    """One path of phase 30: ``2 GRAPH_K`` eager steps twice from one state
    (the tensor-rate step, as a chunk takes it), then two graphed chunks of
    ``GRAPH_K`` from the same state. The two eager runs bit-identical, and
    the graphed chunks bit-identical to them (losses and state); Adam's
    first moments' cosines printed for the record. The same launches by
    kernel. Then ms/step of the eager
    step as a user's loop takes it and of a graphed chunk (host clock around
    synchronised calls), the host API launches a step, each one's device
    busy share and the captures' seconds and pool bytes."""
    import torch
    from tinynerf_torch import profiling, train
    from tinynerf_torch.runner import Runner
    runner = Runner(cfg, device="cuda", scene=scene)
    step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
    s0 = clone_state(runner.state)
    del runner
    n = 2 * GRAPH_K

    def eager():
        st = clone_state(s0)
        rates = train.chunk_rates(cfg, st, n)[0].to(dev)
        losses = []
        for k in range(n):
            st, m = step(st, rates=rates[k])
            losses.append(m["loss"])
        return st, torch.stack(losses)

    zero_launches()
    e1, l1 = eager()
    torch.cuda.synchronize()
    eager_launches = launch_counts()
    e2, l2 = eager()
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))
    deterministic = bool(torch.equal(l1, l2)) and same(e1, e2)
    chunk = train.make_chunked_step(step, GRAPH_K)
    zero_launches()
    g = clone_state(s0)
    g, m1 = chunk(g)
    g, m2 = chunk(g)
    torch.cuda.synchronize()
    graph_launches = launch_counts()
    lg = torch.cat([m1["loss"], m2["loss"]])
    bit = bool(torch.equal(lg, l1)) and same(g, e1)
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())
    # Adam's first moment: an average of the steps' gradients, per part
    mu_cos = {"eager": moment_cosines(e2.opt.mu, e1.opt.mu),
              "graphed": moment_cosines(g.opt.mu, e1.opt.mu)}
    loss_rel = {"eager": rel(l2, l1), "graphed": rel(lg, l1)}
    stats = dict(chunk.graphs.stats)
    print(f"{name}: {n} eager steps twice from one state: "
          f"{'bit-identical' if deterministic else 'not bit-identical'}; {n} graphed steps "
          f"({stats['captures']} captures in {stats['capture_s']:.2f} s, "
          f"{stats['warm_steps']} warm-up steps, {stats['replays']} replays, pool "
          f"{stats['pool_bytes'] / 2 ** 20:.1f} MiB) against the first: "
          f"{'bit-identical' if bit else 'not bit-identical'}; losses max rel eager "
          f"{loss_rel['eager']:.3e}, graphed {loss_rel['graphed']:.3e}; Adam first-moment "
          f"cosines min eager {min(mu_cos['eager'].values()):.7f}, graphed "
          f"{min(mu_cos['graphed'].values()):.7f}; "
          f"launches eager {dict((k, v) for k, v in eager_launches.items() if v)}, graphed "
          f"{dict((k, v) for k, v in graph_launches.items() if v)}")
    if graph_launches != eager_launches:
        raise AssertionError(f"{name}: the graphed steps launched other kernels than the eager")
    if not deterministic:
        raise AssertionError(f"{name}: two eager runs from one state differ")
    if not bit:
        raise AssertionError(f"{name}: the graphed steps differ from the eager ones, "
                             "which repeat bit for bit")
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{name}: a graphed loss is not finite")

    # time the eager step as a user's loop takes it, then a graphed chunk
    state = e1

    def eager_steps():
        nonlocal state
        for _ in range(GRAPH_K):
            state, _ = step(state)

    def graphed_chunk():
        nonlocal g
        g, _ = chunk(g)

    times = {}
    for what, fn in (("eager", eager_steps), ("graphed", graphed_chunk)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[what] = (time.perf_counter() - t0) * 1e3 / GRAPH_K
    prof = {}
    for what, fn in (("eager", eager_steps), ("graphed", graphed_chunk)):
        wall_ms, rows, busy_ms = profiling.device_rows(fn, 1)
        prof[what] = profiling.print_profile(wall_ms, rows, GRAPH_K, "steps", top=6,
                                             busy_ms=busy_ms)
        prof[what]["api_launches"] = api_launches(fn, 1) / GRAPH_K
    # the graphed step's idle share from the eager profile's device time (the
    # same launches), beside the graphed trace's own
    prof["graphed"]["idle_from_eager_device"] = 1 - prof["eager"]["device_ms"] / times["graphed"]
    print(f"{name}: ms/step eager {times['eager']:.3f}, graphed {times['graphed']:.3f}; host "
          f"API launches a step eager {prof['eager']['api_launches']:.1f}, graphed "
          f"{prof['graphed']['api_launches']:.2f}; device idle eager "
          f"{100 * (1 - prof['eager']['busy_share']):.1f}%, graphed "
          f"{100 * (1 - prof['graphed']['busy_share']):.1f}% (from the eager profile's device "
          f"time {100 * prof['graphed']['idle_from_eager_device']:.1f}%)")
    return {"eager_deterministic": deterministic, "graph_bit_identical": bit,
            "moment_cosines": mu_cos,
            "loss_max_rel": loss_rel, "ms_per_step": times,
            "profile": prof, "captures": stats, "launches": graph_launches,
            "state": g}


def graph_frames(name: str, cfg, scene, state, dev, forms=(0, 1)) -> dict:
    """Phase 30's frames of one path: view 0 of the scene through
    ``eval.make_frame_fn`` with one graph a view (``host_chunks = 0``) and
    with a graph a chunk along the view (``host_chunks = 1``, the host
    loop), or the ``forms`` given: the first call renders eagerly and
    captures, the second replays. Every frame bit-identical to the first call's (the eager host
    loop's), the same launches each call. s/frame (host clock): the eager
    host loop (the warm-up), each form's replay."""
    import numpy as np
    import torch
    from tinynerf_torch import eval as evallib
    from tinynerf_torch.core.rays import make_k_inv
    h, w = scene.height, scene.width
    k_inv = make_k_inv(h, w, scene.focal, dev)
    ndc = ((float(h), float(w), float(scene.focal)) if cfg.ndc and cfg.data_type == "llff"
           else None)
    pose = np.asarray(scene.poses_bounds[0], np.float32)
    out, ref, total = {}, None, {}
    for host_chunks in forms:
        fn = evallib.make_frame_fn(cfg, k_inv, h, w, occ_grid=state.occ, ndc_params=ndc,
                                   host_chunks=host_chunks)
        seconds, imgs, launches = [], [], []
        for _ in range(2):
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs.append(fn(state.params, pose))
            seconds.append(time.perf_counter() - t0)
            launches.append(launch_counts())
        held = fn.graph
        ref = imgs[0] if ref is None else ref
        if not (np.array_equal(imgs[0], ref) and np.array_equal(imgs[1], ref)):
            raise AssertionError(f"{name}: a graphed frame (host_chunks {host_chunks}) is "
                                 "not the eager host loop's bit for bit")
        if launches[0] != launches[1]:
            raise AssertionError(f"{name}: the frame's replay launched other kernels")
        if not (np.all(np.isfinite(ref)) and ref.min() >= 0.0 and ref.max() <= 1.0 + 1e-6):
            raise AssertionError(f"{name}: the frame is not finite values in [0, 1]")
        for counted in launches:
            for k, v in counted.items():
                total[k] = total.get(k, 0) + v
        out[host_chunks] = {"first_s": seconds[0], "eager_s": held["warm_s"],
                            "capture_s": held["graph"].seconds,
                            "pool_bytes": held["graph"].pool_bytes,
                            "replay_s": seconds[1],
                            "launches": {k: v for k, v in launches[1].items() if v}}
    print(f"{name} frame {h}x{w}: eager host loop {out[0]['eager_s']:.3f} s (the first call's "
          f"warm-up; capture {out[0]['capture_s']:.2f} s, pool "
          f"{out[0]['pool_bytes'] / 2 ** 20:.1f} MiB); whole-frame graph "
          f"{out[0]['replay_s']:.3f} s"
          + (f"; graph a chunk (host_chunks 1) {out[1]['replay_s']:.3f} s (capture "
             f"{out[1]['capture_s']:.2f} s)" if 1 in out else "")
          + f"; every frame bit-identical; launches a frame {out[0]['launches']}")
    return {**out, "launches": total}


def graph_cli_run(tmp: str) -> dict:
    """Phase 30b: ``python -m tinynerf_torch --mode all`` on a tiny sync scene
    (the scene maker's) across occupancy refreshes and STEP boundaries:
    chunks of GRAPH_CLI_STEP steps, the refresh graph replayed, a tail of
    single steps; [ITER] lines and checkpoints at each boundary, one logged
    loss an iteration, and the test PSNR printed."""
    import json as _json
    import glob
    root = os.path.join(tmp, "graph_cli")
    scene = os.path.join(root, "scene")
    subprocess.run([sys.executable, "-m", "tinynerf_torch.tools.make_synthetic_scene", scene,
                    "--hw", "32", "--views", "4"], check=True, cwd=ROOT, timeout=300,
                   capture_output=True)
    ini = os.path.join(root, "cli.ini")
    with open(ini, "w") as f:
        f.write("[cli]\n" + "\n".join(f"{k} = {v}" for k, v in {
            "IMG_DIR": scene + "/", "RESULTS_PATH": os.path.join(root, "results") + "/",
            "CKPT_PATH": os.path.join(root, "ckpt") + "/",
            "LOG_DIR": os.path.join(root, "runs") + "/", "DATA_TYPE": "sync",
            "TOTAL_ITER": GRAPH_CLI_ITERS, "STEP": GRAPH_CLI_STEP, "BATCH_RAY": 1024,
            "N_COARSE": 32, "N_FINE": 64, "PRECISION": "bf16", "OCC_GRID": True,
            "WHITE_BKGD": True, "OCC_RES": 16, "OCC_UPDATE_EVERY": GRAPH_CLI_REFRESH,
            "LEARNING": "5e-4", "CONTINUE": False, "RENDER_CHUNK": 512}.items()) + "\n")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "tinynerf_torch", "--conf", ini,
                          "--mode", "all"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:])
        raise AssertionError("python -m tinynerf_torch --mode all failed")
    lines = run.stdout.splitlines()
    iters = [int(line.split()[1]) for line in lines if line.startswith("[ITER]")]
    want = [i - 1 for i in range(GRAPH_CLI_STEP, GRAPH_CLI_ITERS + 1, GRAPH_CLI_STEP)]
    ckpts = sorted(int(os.path.basename(p).rsplit("_", 1)[1].split(".")[0])
                   for p in glob.glob(os.path.join(root, "ckpt", "*.npz")))
    logged = [_json.loads(line) for path in glob.glob(os.path.join(root, "runs", "*",
                                                                   "metrics.jsonl"))
              for line in open(path)]
    losses = [(r["iter"], r["loss/train"]) for r in logged if "loss/train" in r]
    psnr = [line for line in lines if line.startswith("Test PSNR")]
    print(f"python -m tinynerf_torch --mode all: {GRAPH_CLI_ITERS} steps (STEP "
          f"{GRAPH_CLI_STEP}, refresh every {GRAPH_CLI_REFRESH}) in {seconds:.1f} s; [ITER] at "
          f"{iters}, checkpoints at {ckpts}; {len(losses)} logged losses, "
          f"{len({l for _, l in losses})} distinct; {psnr[-1] if psnr else 'no PSNR line'}")
    if (iters != want or ckpts != want or [i for i, _ in losses] != list(range(GRAPH_CLI_ITERS))
            or len({l for _, l in losses}) != GRAPH_CLI_ITERS
            or not all(math.isfinite(l) for _, l in losses) or not psnr):
        raise AssertionError("the CLI's chunked run did not log, checkpoint or render as "
                             "expected")
    return {"seconds": seconds, "iter_lines": iters, "checkpoints": ckpts}


# a kernel wrapper's name -> its kernel form's name in the kernels line (fp32;
# "_bf16" follows at bf16)
FORM_OF = {"field_rays": "field_rays_fwd", "field_rays_bwd": "field_rays_bwd",
           "field_flat": "field_flat_fwd", "field_flat_bwd": "field_flat_bwd",
           "grid_rays": "grid_rays_fwd", "grid_rays_bwd": "grid_rays_bwd",
           "prop_rays": "prop_rays_fwd", "prop_rays_bwd": "prop_rays_bwd",
           "render_fused": "render_fused_fwd", "render_fused_bwd": "render_fused_bwd"}


def add_launches(table: dict, counted: dict, precision: str, path: str) -> None:
    """``counted`` (launches by wrapper) into ``table`` by kernel form, under
    ``path``."""
    for kernel, count in counted.items():
        if count and kernel in FORM_OF:
            form_ = FORM_OF[kernel] + ("_bf16" if precision == "bf16" else "")
            table.setdefault(form_, {})[path] = table.get(form_, {}).get(path, 0) + count


def graph_upsample_run(tmp: str) -> dict:
    """Phase 30a: ``Runner.train`` on lego_grid + GRID_PALLAS from R = 64
    with ``GRID_UPSAMPLE`` 20:128 and STEP 10: chunks of 10 graphed steps,
    the milestone resizing the tables before iteration 20 and the step
    graphs captured again on the new shapes (``graphs.capture`` counted:
    the refresh and plain graphs at R = 64, the plain one at R = 128); the
    [ITER] lines on every STEP, kernels 5 and 6 twice a step, every loss
    finite, the tables and moments at R = 128 at the end."""
    import contextlib as _cl
    import io as _io
    from tinynerf_torch import graphs
    from tinynerf_torch.runner import Runner
    cfg = run_config("lego_grid", tmp, "graph_upsample", GRAPH_UPSAMPLE_ITERS, grid_pallas=True,
                     grid_res=64, grid_upsample=GRAPH_UPSAMPLE, step=10)
    runner = Runner(cfg, device="cuda", scene=blender_scene(TRAIN_VIEWS, 800, cfg.seed))
    real, captured = graphs.capture, []

    def counting(*a, **kw):
        captured.append(runner.state.iteration)
        return real(*a, **kw)

    graphs.capture = counting
    zero_launches()
    out = _io.StringIO()
    try:
        with _cl.redirect_stdout(out):
            runner.train()
    finally:
        graphs.capture = real
    lines = out.getvalue().splitlines()
    got = launch_counts()
    iters = [int(line.split()[1]) for line in lines if line.startswith("[ITER]")]
    resize = [line for line in lines if line.startswith("[GRID]")]
    res = {name: sorted({t["net"]["lines"][ax].shape[0] for ax in "xyz"})
           for name, t in (("params", runner.params), ("mu", runner.state.opt.mu),
                           ("nu", runner.state.opt.nu))}
    losses = logged_losses(runner)
    print(f"lego_grid GRID_UPSAMPLE {GRAPH_UPSAMPLE}, STEP 10: {resize}; captures at the "
          f"chunks from iterations {captured}; [ITER] at {iters}; R after {res}; launches "
          f"{dict((k, v) for k, v in got.items() if v)}; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}")
    if (resize != ["[GRID] upsampled line tables to R=128 before iter 20"]
            or captured != [0, 0, 20] or iters != list(range(9, GRAPH_UPSAMPLE_ITERS, 10))
            or any(r != [128] for r in res.values())
            or got != launched(grid_rays=2 * GRAPH_UPSAMPLE_ITERS,
                               grid_rays_bwd=2 * GRAPH_UPSAMPLE_ITERS)
            or len(losses) != GRAPH_UPSAMPLE_ITERS
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError("the graphed lego_grid run did not capture again at its "
                             "milestone as expected")
    return {"captured_at": captured, "iter_lines": iters, "launches": got,
            "precision": cfg.precision}


def graph_phases(tmp: str) -> dict:
    """Phase 30: each graphed training path (``graph_train_path``) and its
    frames (``graph_frames``: lego_occ unfused and fused, lego_grid,
    unbounded360-mlp, the flagship), then a graphed run across a
    ``GRID_UPSAMPLE`` milestone (``graph_upsample_run``) and the CLI's
    chunked run (``graph_cli_run``). Returns ``{"paths", "frames", "cli",
    "launches"}``, ``launches`` by kernel form and path: the graphed steps'
    launches (the warm-up steps' among them)."""
    import dataclasses as _dc
    import torch
    dev = torch.device("cuda:0")
    t_phase = time.perf_counter()
    results, frames, launches = {}, {}, {}
    for name, cfg, scene in graph_paths(tmp):
        phase(f"graphs-{name} ({cfg.precision}, BATCH_RAY {cfg.batch_ray}; "
              f"{2 * GRAPH_K} eager steps vs two chunks of {GRAPH_K} graphed)")
        res = graph_train_path(name, cfg, scene, dev)
        state = res.pop("state")
        add_launches(launches, res["launches"], cfg.precision, f"{name} graphed train")
        results[name] = res
        if name in GRAPH_FRAME_PATHS:
            phase(f"graphs-{name} frames (whole-frame graph, graph a chunk, eager host loop)")
            forms = [(name, cfg)]
            if name == "lego_occ":
                forms.append(("lego_occ_fused", _dc.replace(cfg, fused_render=True)))
            for tag, fcfg in forms:
                frames[tag] = graph_frames(tag, fcfg, scene, state, dev)
                add_launches(launches, frames[tag]["launches"], cfg.precision,
                             f"{tag} graphed frames")
        del state
        torch.cuda.empty_cache()
    phase(f"graphs-upsample (lego_grid + GRID_PALLAS, GRID_UPSAMPLE {GRAPH_UPSAMPLE}, STEP 10)")
    upsample = graph_upsample_run(tmp)
    add_launches(launches, upsample.pop("launches"), upsample.pop("precision"),
                 "lego_grid upsample graphed train")
    phase("graphs-cli (python -m tinynerf_torch --mode all, chunked, across refreshes)")
    cli = graph_cli_run(tmp)
    print(f"phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return {"paths": results, "frames": frames, "upsample": upsample, "cli": cli,
            "launches": launches}


def mesh_train_path(name: str, cfg, runner, dev) -> dict:
    """Phase 31's training path on this rank: phase 30's checks
    (``graph_train_path``) of the data-parallel step under the Runner's
    mesh. Two runs of ``2 GRAPH_K`` eager mesh steps from one state, then two
    graphed chunks of ``GRAPH_K`` from it, whose graphs hold the gradient's
    all-reduce (and the refresh graph the refresh's gather); where the
    eager runs differ, one replayed step's gradient against an eager step's
    (Adam's first moment after one step, per part). Every rank runs this in
    step; nothing here raises on a mismatch, the parent checks the ranks'
    records (a rank that raised alone would leave the others waiting in a
    collective)."""
    import torch
    from tinynerf_torch import optim, train
    from tinynerf_torch.parallel import distributed as dist
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step = train.make_train_step(cfg, runner.train_table, runner.k_inv, mesh=runner.mesh)
    s0 = clone_state(runner.state)
    n = 2 * GRAPH_K

    def eager():
        st = clone_state(s0)
        rates = train.chunk_rates(cfg, st, n)[0].to(dev)
        losses = []
        for k in range(n):
            st, m = step(st, rates=rates[k])
            losses.append(m["loss"])
        return st, torch.stack(losses)

    zero_launches()
    e1, l1 = eager()
    sync()
    eager_launches = launch_counts()
    e2, l2 = eager()
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))
    deterministic = bool(torch.equal(l1, l2)) and same(e1, e2)
    chunk = train.make_chunked_step(step, GRAPH_K)
    zero_launches()
    g, m1 = chunk(clone_state(s0))
    digests = [dist.params_digest(g.params)]
    g, m2 = chunk(g)
    digests.append(dist.params_digest(g.params))
    sync()
    graph_launches = launch_counts()
    lg = torch.cat([m1["loss"], m2["loss"]])
    bit = bool(torch.equal(lg, l1)) and same(g, e1)
    rec = {"eager_deterministic": deterministic, "graph_bit_identical": bit,
           "losses_finite": bool(torch.isfinite(lg).all()), "digests": digests,
           "eager_digest": dist.params_digest(e1.params),
           "loss_max_rel": float(((lg - l1).abs() / l1.abs()).max()),
           "eager_launches": eager_launches, "graph_launches": graph_launches,
           "captures": dict(chunk.graphs.stats), "step_cosines": None,
           "bound": 0.9999 if cfg.precision == "fp32" else 0.999}
    if not deterministic:
        one = train.make_chunked_step(step, 1)
        one(clone_state(s0))
        replayed, _ = one(clone_state(s0))
        row = train.chunk_rates(cfg, s0, 1)[0][0].to(dev)
        eager_a, _ = step(clone_state(s0), rates=row)
        rec["step_cosines"] = moment_cosines(replayed.opt.mu, eager_a.opt.mu)

    state = e1

    def eager_steps():
        nonlocal state
        for _ in range(GRAPH_K):
            state, _ = step(state)

    def graphed_chunk():
        nonlocal g
        g, _ = chunk(g)

    times = {}
    for what, fn in (("eager", eager_steps), ("graphed", graphed_chunk)):
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times[what] = (time.perf_counter() - t0) * 1e3 / GRAPH_K
    rec["ms_per_step"] = times
    rec["api_launches"] = {what: api_launches(fn, 1) / GRAPH_K
                           for what, fn in (("eager", eager_steps), ("graphed", graphed_chunk))}
    flat = torch.zeros(1 + sum(t.numel() for t in optim.leaves(s0.params)), device=dev)
    runner.mesh.sum_over_data(flat)
    rec["allreduce_ms"] = _timed(sync, lambda: [
        runner.mesh.sum_over_data(flat) for _ in range(10)])[1] / 10 * 1e3
    rec["allreduce_floats"] = flat.numel()
    rec["state"] = g
    return rec


def mesh_frames(cfg, scene, state, mesh, dev, forms=(0, 8)) -> dict:
    """Phase 31's frames of one config on this rank: view 0 through
    ``eval.make_frame_fn`` under the mesh, for each ``host_chunks`` in
    ``forms`` (0: one graph a view): the first call renders eagerly (the
    warm-up: with one graph a view, the eager host loop) and captures, the
    second replays. Whether every frame equals the first call's of the
    first form bit for bit, the frame's sha256 (the ranks must agree), the
    launches of each call, s/frame."""
    import hashlib
    import numpy as np
    import torch
    from tinynerf_torch import eval as evallib
    from tinynerf_torch.core.rays import make_k_inv
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    h, w = scene.height, scene.width
    k_inv = make_k_inv(h, w, scene.focal, dev)
    pose = np.asarray(scene.poses_bounds[0], np.float32)
    out, ref, equal = {}, None, True
    for host_chunks in forms:
        fn = evallib.make_frame_fn(cfg, k_inv, h, w, occ_grid=state.occ, mesh=mesh,
                                   host_chunks=host_chunks)
        seconds, imgs, launches = [], [], []
        for _ in range(2):
            zero_launches()
            sync()
            t0 = time.perf_counter()
            imgs.append(fn(state.params, pose))
            seconds.append(time.perf_counter() - t0)
            launches.append(launch_counts())
        ref = imgs[0] if ref is None else ref
        equal = equal and all(np.array_equal(i, ref) for i in imgs)
        held = getattr(fn, "graph", None)
        out[str(host_chunks)] = {
            "graphed": held is not None, "first_s": seconds[0], "replay_s": seconds[1],
            "eager_s": None if held is None else held["warm_s"],
            "capture_s": None if held is None else held["graph"].seconds,
            "launches": launches, "launches_equal": launches[0] == launches[1]}
    out["bit_identical"] = bool(equal)
    out["finite_in_range"] = bool(np.all(np.isfinite(ref)) and ref.min() >= 0.0
                                  and ref.max() <= 1.0 + 1e-6)
    out["sha256"] = hashlib.sha256(np.ascontiguousarray(ref).tobytes()).hexdigest()
    return out


def mesh_rank(work: str, n: int, device: str = "cuda") -> None:
    """Phase 31 on one rank of a job of ``n`` NCCL ranks, one card each
    (started by ``parallel.distributed.spawn``): ``mesh_train_path`` on
    ``MESH_PATHS`` with ``MESH_SHAPE = n`` (lego_occ's grid refreshed every
    GRAPH_REFRESH_EVERY steps, so that both step graphs are captured), the
    lego_occ view after its chunks (``mesh_frames``: one graph a view and
    ``MESH_HOST_CHUNKS`` chunks a graph), and lego with ``SAMPLE_SHARD = 2``
    (kernel 1 fp32; fresh seeded weights), one graph a view. Writes
    ``mesh_rank<r>.json`` under ``work``. ``device``: the card (the CPU
    only to rehearse)."""
    import torch
    from tinynerf_torch.parallel import distributed as dist
    from tinynerf_torch.runner import Runner
    rank = dist.rank()
    cuda = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mine = os.path.join(work, f"rank{rank}")
    rec = {"rank": rank, "card": dev.index, "paths": {}, "frames": {}}
    for name, conf, kw in MESH_PATHS:
        t0 = time.perf_counter()
        cfg = run_config(conf, mine, f"mesh_{name}", 3 * GRAPH_K, mesh_shape=n, **kw)
        if cfg.occ_grid:
            cfg.occ_update_every = GRAPH_REFRESH_EVERY
        scene = blender_scene(TRAIN_VIEWS, 800, cfg.seed)
        runner = Runner(cfg, device=device, scene=scene)
        res = mesh_train_path(name, cfg, runner, dev)
        state = res.pop("state")
        res["precision"] = cfg.precision
        if name in MESH_FRAME_PATHS:
            rec["frames"][name] = mesh_frames(cfg, scene, state, runner.mesh, dev)
            rec["frames"][name]["precision"] = cfg.precision
        res["seconds"] = time.perf_counter() - t0
        rec["paths"][name] = res
        del runner, state
        torch.cuda.empty_cache()
    lcfg = run_config("lego", mine, "mesh_lego_ss", 1, mesh_shape=n, sample_shard=2)
    scene = blender_scene(2, 800, lcfg.seed)
    runner = Runner(lcfg, device=device, scene=scene)
    rec["ss_mesh"] = [runner.mesh.n_data, runner.mesh.n_sample]
    rec["frames"]["lego_ss2"] = mesh_frames(lcfg, scene, runner.state, runner.mesh, dev,
                                            forms=(0,))
    rec["frames"]["lego_ss2"]["precision"] = lcfg.precision
    with open(os.path.join(work, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def mesh_gpu_rank(work: str) -> None:
    """``tests/test_torch_mesh_gpu.py``'s rank body, on one of two NCCL
    ranks: ``mesh_train_path`` and ``mesh_frames`` (one graph a view) at a
    small size, lego_occ at 1024 rays with ``MESH_SHAPE = 2`` and its grid
    refreshed every two steps, on a 64x64 scene. Writes ``rank<r>.json``
    under ``work``."""
    import torch
    from tinynerf_torch.parallel import distributed as dist
    from tinynerf_torch.runner import Runner
    rank = dist.rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = run_config("lego_occ", os.path.join(work, f"r{rank}"), "gpu", 3 * GRAPH_K,
                     mesh_shape=2, batch_ray=1024, occ_update_every=2)
    scene = blender_scene(4, 64, cfg.seed)
    runner = Runner(cfg, device="cuda", scene=scene)
    rec = mesh_train_path("lego_occ", cfg, runner, dev)
    rec["frame"] = mesh_frames(cfg, scene, rec.pop("state"), runner.mesh, dev, forms=(0,))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def mesh_cli_run(tmp: str, n: int) -> dict:
    """Phase 31's CLI run: ``python -m tinynerf_torch --mode train`` with
    ``MESH_SHAPE = n`` on the scene maker's tiny capture (the CLI starts the
    n NCCL ranks itself), in chunks of MESH_CLI_STEP across refreshes: the
    [CHUNKS] line naming CUDA graphs over NCCL, the [ITER] lines on each
    STEP, and every rank's params digest, equal."""
    root = os.path.join(tmp, "mesh_cli")
    scene = os.path.join(root, "scene")
    subprocess.run([sys.executable, "-m", "tinynerf_torch.tools.make_synthetic_scene", scene,
                    "--hw", "32", "--views", "4"], check=True, cwd=ROOT, timeout=300,
                   capture_output=True)
    ini = os.path.join(root, "cli.ini")
    with open(ini, "w") as f:
        f.write("[cli]\n" + "\n".join(f"{k} = {v}" for k, v in {
            "IMG_DIR": scene + "/", "RESULTS_PATH": os.path.join(root, "results") + "/",
            "CKPT_PATH": os.path.join(root, "ckpt") + "/",
            "LOG_DIR": os.path.join(root, "runs") + "/", "DATA_TYPE": "sync",
            "TOTAL_ITER": MESH_CLI_ITERS, "STEP": MESH_CLI_STEP, "BATCH_RAY": 1024,
            "N_COARSE": 32, "N_FINE": 64, "PRECISION": "bf16", "OCC_GRID": True,
            "WHITE_BKGD": True, "OCC_RES": 16, "OCC_UPDATE_EVERY": GRAPH_CLI_REFRESH,
            "LEARNING": "5e-4", "CONTINUE": False, "RENDER_CHUNK": 512,
            "MESH_SHAPE": n}.items()) + "\n")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "tinynerf_torch", "--conf", ini,
                          "--mode", "train"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    seconds = time.perf_counter() - t0
    # the ranks share the pipe: a rank's line may land inside another's
    chunks = re.findall(r"\[CHUNKS\][^\n\[]*", run.stdout)
    iters = [int(i) for i in re.findall(r"\[ITER\] (\d+)", run.stdout)]
    digests = sorted(re.findall(r"\[RANK (\d+)/\d+\] params sha256 ([0-9a-f]{64})",
                                run.stdout), key=lambda rd: int(rd[0]))
    print(f"python -m tinynerf_torch --mode train, MESH_SHAPE = {n}: rc {run.returncode} in "
          f"{seconds:.1f} s; {chunks}; [ITER] at {iters}; digests {digests}")
    if (run.returncode != 0 or len(chunks) != 1 or "CUDA graphs" not in chunks[0]
            or "nccl" not in chunks[0] or [int(r) for r, _ in digests] != list(range(n))
            or len({d for _, d in digests}) != 1
            or iters != [i - 1 for i in range(MESH_CLI_STEP, MESH_CLI_ITERS + 1,
                                              MESH_CLI_STEP)]):
        print(run.stdout[-3000:], run.stderr[-3000:])
        raise AssertionError("the CLI under a mesh did not train in graphed chunks with "
                             "equal digests on every rank")
    return {"seconds": seconds, "chunks_line": chunks[0], "iter_lines": iters,
            "digests": digests}


def mesh_phases(tmp: str) -> dict:
    """Phase 31: phase 30's graphed chunks and frames under a mesh of NCCL
    ranks, one card each: four where the machine has four cards, else two,
    else none (one card: it prints that there is no NCCL job). ``mesh_rank``
    on every rank, then the checks of their records: on each path and rank
    the two eager runs bit-identical and the graphed chunks bit-identical
    to them (where the eager runs differ: one replayed step's gradient at
    the step bound, and the check that decided printed), the digests after
    each chunk equal on every rank, the kernel launches of the graphed
    steps equal to the eager steps' on every rank; every frame equal to its
    eager host loop bit for bit and to every rank's; then the CLI
    (``mesh_cli_run``). Returns the numbers and ``launches`` (rank 0's, by
    kernel form and path)."""
    import torch
    from tinynerf_torch.parallel import distributed as dist
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    n = 4 if cards >= 4 else 2 if cards >= 2 else 0
    phase(f"mesh-graphs (phase 30's chunks and frames under MESH_SHAPE = N over NCCL, one rank "
          f"a card: lego_occ and the flagship, {2 * GRAPH_K} eager mesh steps twice vs two "
          f"graphed chunks of {GRAPH_K}; the lego_occ view and lego SAMPLE_SHARD = 2; the CLI)")
    if not n:
        print(f"{cards} card: no NCCL job (phase 31 needs two cards or more)")
        return {"ranks": 0, "launches": {}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    work = os.path.join(tmp, "mesh")
    os.makedirs(work, exist_ok=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist.spawn("chip_smoke:mesh_rank", n, "cuda", (work, n))
    job_s = time.perf_counter() - t0
    recs = [json.load(open(os.path.join(work, f"mesh_rank{r}.json"))) for r in range(n)]
    print(f"{smi.splitlines()[0]} x {cards}; {n} NCCL ranks; the job {job_s:.1f} s")
    out = {"ranks": n, "card": smi, "job_s": job_s, "paths": {}, "frames": {}, "launches": {}}
    failures = []
    for name in recs[0]["paths"]:
        rs = [r["paths"][name] for r in recs]
        r0 = rs[0]
        if all(r["eager_deterministic"] for r in rs):
            decided = "bit for bit"
            ok = all(r["graph_bit_identical"] for r in rs)
        else:
            decided = "step gradient cosine"
            ok = all(min(r["step_cosines"].values()) >= r["bound"] for r in rs)
        digests_equal = all(r["digests"] == r0["digests"] for r in rs)
        launches_equal = all(r["graph_launches"] == r["eager_launches"] for r in rs)
        print(f"{name} ({r0['precision']}, MESH_SHAPE {n}): two eager runs "
              f"{'bit-identical' if decided == 'bit for bit' else 'differ'} on every rank; "
              f"graphed chunks vs eager decided {decided}: {'pass' if ok else 'FAIL'} (losses "
              f"max rel {max(r['loss_max_rel'] for r in rs):.3e}"
              + ("" if r0["step_cosines"] is None else
                 f"; step cosines min {min(min(r['step_cosines'].values()) for r in rs):.7f}, "
                 f"bound {r0['bound']}") + f"); digests after each chunk equal on all ranks: "
              f"{digests_equal}; kernel launches a rank, eager "
              f"{ {k: v for k, v in r0['eager_launches'].items() if v} } -> "
              f"graphed equal: {launches_equal}")
        print(f"{name}: ms/step eager -> graphed, by rank: "
              + ", ".join(f"{r['ms_per_step']['eager']:.3f} -> {r['ms_per_step']['graphed']:.3f}"
                          for r in rs)
              + f"; host API launches a step {r0['api_launches']['eager']:.1f} -> "
              f"{r0['api_launches']['graphed']:.2f}; captures {r0['captures']['captures']} in "
              f"{r0['captures']['capture_s']:.2f} s, pool {r0['captures']['pool_bytes'] / 2 ** 20:.1f}"
              f" MiB; the all-reduce of {r0['allreduce_floats']:,} floats "
              + ", ".join(f"{r['allreduce_ms']:.3f}" for r in rs) + " ms")
        if not (ok and digests_equal and launches_equal and all(r["losses_finite"] for r in rs)):
            failures.append(name)
        out["paths"][name] = {"decided": decided, "ok": ok,
                              "ms_per_step": [r["ms_per_step"] for r in rs],
                              "api_launches": r0["api_launches"], "captures": r0["captures"],
                              "allreduce_ms": [r["allreduce_ms"] for r in rs],
                              "loss_max_rel": max(r["loss_max_rel"] for r in rs),
                              "step_cosines": r0["step_cosines"]}
        add_launches(out["launches"], r0["graph_launches"], r0["precision"],
                     f"{name} mesh {n} graphed train (a rank)")
    for name in recs[0]["frames"]:
        fs = [r["frames"][name] for r in recs]
        f0 = fs[0]
        forms = [k for k in f0 if k.isdigit()]
        same_all = len({f["sha256"] for f in fs}) == 1
        ok = (all(f["bit_identical"] and f["finite_in_range"] for f in fs) and same_all
              and all(f[k]["graphed"] and f[k]["launches_equal"] for f in fs for k in forms))
        eager_s = f0["0"]["eager_s"] if f0["0"]["graphed"] else f0["0"]["first_s"]
        print(f"{name} frame under the mesh: eager host loop {eager_s:.3f} s -> one graph a "
              f"view {f0['0']['replay_s']:.3f} s (capture {f0['0']['capture_s'] or 0.0:.2f} s)"
              + "".join(f"; host_chunks {k} {f0[k]['replay_s']:.3f} s" for k in forms if k != "0")
              + f"; every frame bit-identical to the eager host loop on every rank and the "
              f"same on all ranks: {ok}; launches a rank a frame "
              f"{ {k: v for k, v in f0['0']['launches'][1].items() if v} }")
        if not ok:
            failures.append(f"{name} frame")
        out["frames"][name] = {k: {kk: f0[k][kk] for kk in ("eager_s", "replay_s", "capture_s")}
                               for k in forms}
        for k in forms:
            add_launches(out["launches"], f0[k]["launches"][1], f0["precision"],
                         f"{name} mesh {n} graphed frame (a rank)")
    out["cli"] = mesh_cli_run(tmp, n)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 31 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError(f"phase 31 failed on {failures}")
    return out


def gather_grad_vs_cpu(name: str, cfg, runner, dev) -> dict:
    """One step's gradient on the card against the same step on the CPU, at
    the Runner's params and one batch, per part (each grid's lines, decoder
    and sigma net, in float64): at fp32 (the config at ``PRECISION = fp32``)
    cosine >= GRAD_COS and the norm within GATHER_NORM; at bf16 (the
    config's own precision, where it is bf16) cosine >= BF16_COS. With the
    gather, the table gradients sum in the same fixed order on both devices
    (``gridfield._TapRows``). Returns the cosines, norm ratios and ``ok``."""
    import dataclasses
    import torch
    from tinynerf_torch import optim, train
    batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(3), cfg.batch_ray)
    batch_cpu = type(batch)(*(t.cpu() for t in batch))
    params_cpu = optim.tree_map(lambda t: t.cpu(), runner.params)
    k_cpu = runner.k_inv.cpu()
    grads = lambda c, k, p, b: train.loss_and_grads(train.make_loss_fn(c, k), p, b)[2]
    flat = lambda tree: torch.cat([t.flatten().double().cpu() for t in optim.leaves(tree)])

    def parts(a, b):
        out = {}
        for part in ("net", "prop"):
            for key in a[part]:
                if key == "extent":
                    continue
                x, y = flat(a[part][key]), flat(b[part][key])
                out[f"{part}.{key}"] = (float(x @ y / (x.norm() * y.norm())),
                                        float(x.norm() / y.norm()))
        return out

    t0 = time.perf_counter()
    forms = ["fp32"] + (["bf16"] if cfg.precision == "bf16" else [])
    result, ok = {}, True
    for precision in forms:
        c = dataclasses.replace(cfg, precision=precision)
        got = parts(grads(c, runner.k_inv, runner.params, batch),
                    grads(c, k_cpu, params_cpu, batch_cpu))
        bound = GRAD_COS if precision == "fp32" else BF16_COS
        passed = all(cos >= bound and (precision == "bf16" or abs(ratio - 1) <= GATHER_NORM)
                     for cos, ratio in got.values())
        ok = ok and passed
        print(f"  {name}: one step's {precision} gradient, card vs CPU (the same params and "
              f"batch of {cfg.batch_ray}): "
              + ", ".join(f"{k} cos {cos:.7f} norm {ratio:.5f}" for k, (cos, ratio) in got.items())
              + f" (cosine >= {bound}" + (f", norm within {GATHER_NORM}" if precision == "fp32"
                                          else "") + f"): {'pass' if passed else 'FAIL'}")
        result[precision] = {k: {"cosine": cos, "norm_ratio": ratio}
                             for k, (cos, ratio) in got.items()}
    print(f"  ({time.perf_counter() - t0:.1f} s with the CPU's {len(forms)} steps)")
    return {**result, "ok": ok}


def gather_timing(cfg, runner, state, dev) -> dict:
    """ms/step of the gather and of the onehot lookup on one state, in turns
    (GATHER_TIMING_TURNS each): GATHER_K eager steps, and a graphed chunk
    of GATHER_K after its capture (host clock around synchronised calls)."""
    import dataclasses
    import torch
    from tinynerf_torch import train
    runs = {}
    for lookup in ("gather", "onehot"):
        c = dataclasses.replace(cfg, grid_lookup=lookup)
        step = train.make_train_step(c, runner.train_table, runner.k_inv)
        chunk = train.make_chunked_step(step, GATHER_K)
        st = clone_state(state)
        st, _ = chunk(st)          # the warm-up steps and the captures
        st, _ = step(st)
        runs[lookup] = [step, chunk, st]
    times = {"gather": {"eager": [], "graphed": []}, "onehot": {"eager": [], "graphed": []}}
    for _ in range(GATHER_TIMING_TURNS):
        for lookup, run in runs.items():
            step, chunk, st = run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GATHER_K):
                st, _ = step(st)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, _ = chunk(st)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            run[2] = st
            times[lookup]["eager"].append((t1 - t0) * 1e3 / GATHER_K)
            times[lookup]["graphed"].append((t2 - t1) * 1e3 / GATHER_K)
    return times


def gather_path(name: str, cfg, scene, device: str) -> dict:
    """Phase 32a, one path with ``GRID_LOOKUP = gather``: GATHER_K eager
    steps twice from one state (the occupancy grid refreshed at 0 and 4),
    bit-identical, and a graphed chunk of GATHER_K from the same state,
    bit-identical to them, with the same kernel launches; every lookup of
    the point field the gather (counted around ``gridfield._interp``: with
    ``GRID_PALLAS`` the refresh's probes alone, three tables a refresh, the
    rays through kernels 5 and 6); one step's gradient card vs CPU
    (``gather_grad_vs_cpu``); ms/step eager and graphed beside the onehot
    lookup's (``gather_timing``). Returns the numbers, the launches by kernel
    form and the state after the chunk."""
    import torch
    from tinynerf_torch import train
    from tinynerf_torch.core import gridfield
    from tinynerf_torch.runner import Runner
    dev = torch.device(device)
    runner = Runner(cfg, device=device, scene=scene)
    step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
    s0 = clone_state(runner.state)
    lookups = {}
    real = gridfield._interp

    def counting(table, coord, rnd, lookup="onehot"):
        lookups[lookup] = lookups.get(lookup, 0) + 1
        return real(table, coord, rnd, lookup)

    def eager():
        st = clone_state(s0)
        rates = train.chunk_rates(cfg, st, GATHER_K)[0].to(dev)
        losses = []
        for k in range(GATHER_K):
            st, m = step(st, rates=rates[k])
            losses.append(m["loss"])
        return st, torch.stack(losses)

    zero_launches()
    gridfield._interp = counting
    try:
        e1, l1 = eager()
    finally:
        gridfield._interp = real
    torch.cuda.synchronize()
    eager_launches = launch_counts()
    e2, l2 = eager()
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))
    deterministic = bool(torch.equal(l1, l2)) and same(e1, e2)
    chunk = train.make_chunked_step(step, GATHER_K)
    zero_launches()
    g, m = chunk(clone_state(s0))
    torch.cuda.synchronize()
    graph_launches = launch_counts()
    bit = bool(torch.equal(m["loss"], l1)) and same(g, e1)
    refreshes = len(range(0, GATHER_K, cfg.occ_update_every))
    # three tables a call of the point field, each by the gather
    lookups_ok = set(lookups) == {"gather"} and lookups["gather"] % 3 == 0
    want_launches = (launched(grid_rays=2 * GATHER_K, grid_rays_bwd=2 * GATHER_K)
                     if cfg.grid_pallas else launched())
    print(f"{name} ({cfg.precision}, GRID_LOOKUP {cfg.grid_lookup}): {GATHER_K} eager steps "
          f"twice from one state: {'bit-identical' if deterministic else 'not bit-identical'}; "
          f"a graphed chunk of {GATHER_K} against them: "
          f"{'bit-identical' if bit else 'not bit-identical'}; point-field lookups in the first "
          f"run {lookups} ({refreshes} refreshes); launches eager "
          f"{ {k: v for k, v in eager_launches.items() if v} }, graphed "
          f"{ {k: v for k, v in graph_launches.items() if v} }; losses {float(l1[0]):.4f} .. "
          f"{float(l1[-1]):.4f}")
    if not deterministic:
        raise AssertionError(f"{name}: two eager runs from one state differ")
    if not bit:
        raise AssertionError(f"{name}: the graphed chunk differs from the eager steps")
    if not lookups_ok:
        raise AssertionError(f"{name}: the point field's lookups were not the gather's")
    if eager_launches != want_launches or graph_launches != eager_launches:
        raise AssertionError(f"{name}: the steps did not launch the expected kernels")
    if not torch.isfinite(l1).all():
        raise AssertionError(f"{name}: a loss is not finite")
    runner.state = g
    grad = gather_grad_vs_cpu(name, cfg, runner, dev)
    if not grad["ok"]:
        raise AssertionError(f"{name}: the step's gradient on the card disagrees with the CPU's")
    times = gather_timing(cfg, runner, g, dev)
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    print(f"{name}: ms/step in turns, gather eager {fmt(times['gather']['eager'])}, graphed "
          f"{fmt(times['gather']['graphed'])}; onehot eager {fmt(times['onehot']['eager'])}, "
          f"graphed {fmt(times['onehot']['graphed'])}")
    launches = {}
    add_launches(launches, eager_launches, cfg.precision, f"{name} train (eager)")
    add_launches(launches, graph_launches, cfg.precision, f"{name} graphed train")
    return {"eager_deterministic": deterministic, "graph_bit_identical": bit,
            "lookups": lookups, "grad_vs_cpu": grad, "ms_per_step": times,
            "launches": launches, "state": g}


def bridge_phase(tmp: str, device: str) -> dict:
    """Phase 32b, the reference state-dict bridge: a seeded state dict under
    the reference ``Network``'s names (``nn.Linear``'s uniform, the sigma
    bias raised by 1), ``torch.save``d; ``python -m
    tinynerf_torch.tools.import_torch_ckpt`` (its ``main``) turns it into
    ``imported_<BRIDGE_ITER>.npz``; the Runner on ``conf/lego.ini`` (fp32,
    ``USE_PALLAS``) resumes it and renders view 0 (800x800) through kernel 1
    alone, equal bit for bit to the view rendered from the same weights
    carried by ``ckpt.params_from_numpy``; ``export_torch_state_dict`` of
    the loaded tree equals the state dict bit for bit."""
    import contextlib
    import io
    import numpy as np
    import torch
    from tinynerf_torch import ckpt, eval as evallib
    from tinynerf_torch.core import mlp
    from tinynerf_torch.runner import Runner
    from tinynerf_torch.tools import import_torch_ckpt
    root = os.path.join(tmp, "bridge")
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator().manual_seed(7)
    sd = {}
    for name, fan_in, fan_out in mlp.layer_dims():
        ref, bound = ckpt.REFERENCE_LAYERS[name], 1.0 / math.sqrt(fan_in)
        sd[f"{ref}.weight"] = (torch.rand((fan_out, fan_in), generator=gen) * 2 - 1) * bound
        sd[f"{ref}.bias"] = (torch.rand(fan_out, generator=gen) * 2 - 1) * bound
    sd["sigma_layer.0.bias"] += 1.0
    src = os.path.join(root, "reference_state_dict.pkl")
    torch.save(sd, src)
    out_dir = os.path.join(root, "ckpt")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        import_torch_ckpt.main([src, out_dir, "--iter", str(BRIDGE_ITER)])
    path = os.path.join(out_dir, f"imported_{BRIDGE_ITER}.npz")
    line = printed.getvalue().strip()
    print(f"import tool: {line}")
    if line != f"imported {BRIDGE_PARAMS:,} params -> {path}":
        raise AssertionError("the import tool did not write the checkpoint it should")
    cfg = run_config("lego", tmp, "bridge", 1)
    cfg.ckpt_path, cfg.continue_ = out_dir, True
    runner = Runner(cfg, device=device, scene=blender_scene(TRAIN_VIEWS, 800, cfg.seed))
    if runner.last_iter != BRIDGE_ITER:
        raise AssertionError(f"the Runner resumed iteration {runner.last_iter}")
    direct = ckpt.params_from_numpy(
        {name: {"w": sd[f"{ref}.weight"].numpy().T, "b": sd[f"{ref}.bias"].numpy()}
         for name, ref in ckpt.REFERENCE_LAYERS.items()}, torch.device(device))
    frames, seconds, launches = {}, {}, {}
    for tag, params in (("imported", runner.params), ("params_from_numpy", direct)):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames[tag] = evallib.render_test_set(cfg, params, runner.test_table, runner.k_inv,
                                              runner.start_time, runner.last_iter, save=False,
                                              max_views=1)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        launches[tag] = launch_counts()
    frame = frames["imported"]
    equal = bool(np.array_equal(frame, frames["params_from_numpy"]))
    back = ckpt.export_torch_state_dict(runner.params)
    exported = list(back) == list(sd) and all(np.array_equal(back[k], v.numpy())
                                              for k, v in sd.items())
    counted = launches["imported"]
    print(f"lego (fp32, USE_PALLAS) from the imported checkpoint: view 0 {frame.shape[1]}x"
          f"{frame.shape[2]} in {seconds['imported']:.3f} s (from params_from_numpy "
          f"{seconds['params_from_numpy']:.3f} s); launches "
          f"{ {k: v for k, v in counted.items() if v} }; "
          f"the two views bit-identical: {equal}; frame mean {frame.mean():.4f}, range "
          f"{frame.min():.4f} .. {frame.max():.4f}; export_torch_state_dict equals the state "
          f"dict bit for bit: {exported}")
    if not equal:
        raise AssertionError("the imported weights' view differs from params_from_numpy's")
    if not (counted["field_rays"] > 0 and counted == launches["params_from_numpy"]
            and counted == launched(field_rays=counted["field_rays"])):
        raise AssertionError("the bridge's views did not run through kernel 1 alone")
    if not (np.all(np.isfinite(frame)) and frame.min() >= 0 and frame.max() <= 1
            and frame.max() - frame.min() > 0.01):
        raise AssertionError("the bridge's view is not finite values in [0, 1] with content")
    if not exported:
        raise AssertionError("export_torch_state_dict did not give the state dict back")
    table = {}
    for tag in frames:
        add_launches(table, launches[tag], cfg.precision, f"lego view from the bridge ({tag})")
    return {"frame_s": seconds, "bit_identical": equal, "exported_equal": exported,
            "launches": table}


def gather_phases(tmp: str, device: str = "cuda") -> dict:
    """Phase 32: ``GRID_LOOKUP = gather`` on ``conf/lego_grid.ini`` with
    ``GRID_PALLAS`` at bf16 and fp32 and on the flagship
    (``conf/lego_hybrid.ini``) (``gather_path``), the flagship's 800x800 view
    through the whole-frame graph (``graph_frames``), then the reference
    state-dict bridge (``bridge_phase``), on ``device`` (the card; the CPU
    only to rehearse, at the sizes the caller sets). Returns the numbers and
    ``launches`` by kernel form and path."""
    import torch
    dev = torch.device(device)
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": smi, "paths": {}, "launches": {}}
    for name, conf, kw in GATHER_PATHS:
        cfg = run_config(conf, tmp, f"gather_{name}", 2 * GATHER_K, grid_lookup="gather", **kw)
        cfg.occ_update_every = GRAPH_REFRESH_EVERY
        phase(f"gather-{name} ({cfg.precision}, GRID_LOOKUP = gather, BATCH_RAY {cfg.batch_ray}"
              f"{', GRID_PALLAS' if cfg.grid_pallas else ''}; {GATHER_K} eager steps twice vs a "
              f"graphed chunk; card vs CPU; ms/step beside onehot)")
        scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=cfg.seed)
        res = gather_path(name, cfg, scene, device)
        state = res.pop("state")
        for form, paths in res.pop("launches").items():
            for path, count in paths.items():
                out["launches"].setdefault(form, {})[path] = count
        if not cfg.grid_pallas:
            phase(f"gather-{name} frame (one 800x800 view through the whole-frame graph)")
            res["frame"] = graph_frames(name, cfg, scene, state, dev, forms=(0,))
            res["frame"].pop("launches")
        out["paths"][name] = res
        del state, scene
        torch.cuda.empty_cache()
    phase("bridge (a reference state dict -> tools.import_torch_ckpt -> the Runner on "
          "conf/lego.ini, one 800x800 view through kernel 1; export_torch_state_dict)")
    bridge = bridge_phase(tmp, device)
    for form, paths in bridge.pop("launches").items():
        out["launches"].setdefault(form, {}).update(paths)
    out["bridge"] = bridge
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{smi}; phase 32 took {out['seconds']:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from tinynerf_torch import ckpt, eval as evallib, optim, profiling, train
    from tinynerf_torch.config import load_config
    from tinynerf_torch.core import gridfield, mlp, occupancy, rays as raylib, render, sampling
    from tinynerf_torch.kernels import build
    from tinynerf_torch.core import proposal
    from tinynerf_torch.kernels import grid_kernel as gk
    from tinynerf_torch.kernels import mlp_kernel as mk
    from tinynerf_torch.kernels import proposal_kernel as pk
    from tinynerf_torch.kernels import render_kernel as rk
    from tinynerf_torch.runner import Runner

    # ---- 1. device ----
    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {kind}; count {count}")
    print(smi)  # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mlp.check_no_tf32()
    dev = torch.device("cuda:0")

    # ---- 2. build ----
    phase("build")
    t0 = time.perf_counter()
    build.build_all(variants=[(gk.BWD_SOURCE, gk.PHASE_DEFINES),
                              (pk.BWD_SOURCE, pk.PHASE_DEFINES),
                              (pk.BWD_SOURCE, pk.NO_FIXUP_DEFINES),
                              (rk.FWD_SOURCE, rk.PHASE_DEFINES),
                              (rk.FWD_SOURCE, rk.WEIGHT_PROBE_DEFINES)])
    print(f"built {', '.join(sorted(build.build_log))} in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    smem = {mk.FWD_SOURCE: mk._library(mk.FWD_SOURCE).field_rays_fwd_smem_bytes(),
            mk.BWD_SOURCE: mk._library(mk.BWD_SOURCE).field_rays_bwd_smem_bytes(),
            mk.FLAT_SOURCE: mk._library(mk.FLAT_SOURCE).field_flat_fwd_smem_bytes(),
            mk.FLAT_BWD_SOURCE: mk._library(mk.FLAT_BWD_SOURCE).field_flat_bwd_smem_bytes()}
    grid_smem = ((gk.FWD_SOURCE, gk._library(gk.FWD_SOURCE).grid_rays_fwd_smem_bytes),
                 (gk.BWD_SOURCE, gk._library(gk.BWD_SOURCE).grid_rays_bwd_smem_bytes))
    for geometry, dims in GRID.items():
        for bf, form_ in enumerate(("fp32", "bf16")):
            for source, fn in grid_smem:
                smem[f"{source} {geometry}_{form_}"] = fn(*dims, bf)
    for net, (width, depth) in PROP_NETS.items():
        smem[f"{pk.FWD_SOURCE} {net}_fp32"] = (
            pk._library(pk.FWD_SOURCE).prop_rays_fwd_smem_bytes(width))
        smem[f"{pk.BWD_SOURCE} {net}_fp32"] = (
            pk._library(pk.BWD_SOURCE).prop_rays_bwd_smem_bytes(width, depth))
    for bf, form_ in enumerate(("fp32", "bf16")):
        smem[f"{rk.FWD_SOURCE} {form_}"] = (
            rk._library(rk.FWD_SOURCE).render_fused_fwd_smem_bytes(*FUSED_SAMPLES, bf))
    smem[f"{rk.BWD_SOURCE} merge_launch"] = (
        rk._library(rk.BWD_SOURCE).render_fused_bwd_smem_bytes(*FUSED_SAMPLES))
    for source in (mk.FWD_SOURCE, mk.BWD_SOURCE, mk.FLAT_SOURCE, mk.FLAT_BWD_SOURCE,
                   gk.FWD_SOURCE, gk.BWD_SOURCE, pk.FWD_SOURCE, pk.BWD_SOURCE, rk.FWD_SOURCE,
                   rk.BWD_SOURCE):
        info = build.build_log[source]
        sizes = ", ".join(f"{k.split()[-1] if ' ' in k else 'main kernel'} {v} B"
                          for k, v in smem.items() if k.split()[0] == source)
        print(f"{source}: nvcc {info['seconds']:.1f} s; dynamic smem per block: {sizes}")
        for line in info["ptxas"]:
            print(f"  ptxas: {line}")
    # the tensor cores at work: HMMA/HGMMA instructions per kernel in the SASS
    for source in sorted(build.build_log):
        counts = build.mma_counts(source)
        print(f"{source}: HMMA/HGMMA per kernel: " + "; ".join(
            f"{short_kernel(name)} {n}" for name, n in counts.items()))
        if source.split()[0] not in FIELD_SOURCES + GRID_SOURCES + PROP_SOURCES:
            continue
        for name, n in counts.items():
            form_ = kernel_form(name)
            if (form_ == "bf16" and n == 0) or (form_ == "fp32" and n > 0):
                raise AssertionError(f"{source}: {short_kernel(name)} ({form_} form) has {n} "
                                     "tensor-core instructions")

    params = mlp.init_network(torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    rays = lambda B, N: tuple(torch.from_numpy(a).to(dev) for a in dyadic_rays(rng, B, N))

    # ---- 3a. kernel 1 vs plain version ----
    phase("kernel 1 (field forward) vs plain")
    fwd_shapes = [(4096, 64), (4096, 128), *STEP_SHAPES]
    fwd_inputs, fwd_err = {}, 0.0
    with torch.no_grad():
        for B, N in fwd_shapes:
            o, d, ts = fwd_inputs[B, N] = rays(B, N)
            k_out = mk.field_rays(params, o, d, ts)
            torch.cuda.synchronize()
            ce, se, sigma_ok, _, _ = field_errors(
                k_out, mk.field_rays_plain(params, o, d, ts))
            print(f"B={B} N={N}: max |color err| {ce:.3e} (atol {COLOR_ATOL}), "
                  f"max |sigma err| {se:.3e} (atol {SIGMA_ATOL} rtol {SIGMA_RTOL})")
            if not (ce <= COLOR_ATOL and sigma_ok):
                raise AssertionError(f"kernel 1 disagrees with field_rays_plain at B={B} N={N}")
            fwd_err = max(fwd_err, ce, se)

    # ---- 3b. kernel 2 vs plain version ----
    phase("kernel 2 (field recompute backward) vs plain")
    bwd_shapes = [*STEP_SHAPES, (4096, 64), (4096, 128)]
    bwd_inputs, bwd_abs, bwd_rel = {}, 0.0, 0.0
    for B, N in bwd_shapes:
        o, d, ts = rays(B, N)
        keep = (mk.preactivation_margin(params, o, d, ts) > MARGIN).float()
        cots = [torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32)).to(dev) * keep
                for _ in range(4)]
        bwd_inputs[B, N] = (o, d, ts, *cots)
        kernel = mk.field_rays_bwd(params, *bwd_inputs[B, N])
        torch.cuda.synchronize()
        errs = bwd_errors(kernel, mk.field_rays_bwd_plain(params, *bwd_inputs[B, N]))
        worst = max(errs, key=lambda k: errs[k][1])
        print(f"B={B} N={N} ({100 * (1 - float(keep.mean())):.2f}% of rows within "
              f"{MARGIN} of a kink, zero cotangent): worst {worst} error / max|plain| "
              f"{errs[worst][1]:.3e} (limit {BWD_RTOL}); d_ts {errs['d_ts'][1]:.3e}, "
              f"d_origins {errs['d_origins'][1]:.3e}, d_dirs {errs['d_dirs'][1]:.3e}, "
              f"trunk_4.w {errs['trunk_4.w'][1]:.3e}, color.w {errs['color.w'][1]:.3e}")
        if errs[worst][1] > BWD_RTOL:
            raise AssertionError(f"kernel 2 disagrees with field_rays_bwd_plain at "
                                 f"B={B} N={N}: {errs}")
        bwd_abs = max(bwd_abs, max(e[0] for e in errs.values()))
        bwd_rel = max(bwd_rel, errs[worst][1])
        del kernel, errs
    torch.cuda.empty_cache()

    # ---- 3c. kernel 3 vs plain version, fp32 and bf16 ----
    phase("kernel 3 (flat field forward) vs plain, fp32 and bf16")
    flat_inputs, flat_err = {}, {"fp32": 0.0, "bf16": 0.0}
    with torch.no_grad():
        for R in FLAT_ROWS:
            pts, dirs = flat_inputs[R] = tuple(
                torch.from_numpy(a).to(dev) for a in grid_probes(rng, R))
            for precision in ("fp32", "bf16"):
                color, sigma = mk.field_flat(params, pts, dirs, precision)
                torch.cuda.synchronize()
                p_color, p_sigma = mk.field_flat_plain(params, pts, dirs, precision)
                ce = float((color - p_color).abs().max())
                se = float((sigma - p_sigma).abs().max())
                if precision == "fp32":
                    ok = ce <= COLOR_ATOL and bool(torch.all(
                        (sigma - p_sigma).abs() <= SIGMA_ATOL + SIGMA_RTOL * p_sigma.abs()))
                    limits = f"color atol {COLOR_ATOL}, sigma atol {SIGMA_ATOL} rtol {SIGMA_RTOL}"
                else:
                    rel = max(rel_err(color, p_color), rel_err(sigma, p_sigma))
                    ok = rel <= BF16_FWD_RTOL
                    limits = f"error / max|plain| {rel:.3e}, limit {BF16_FWD_RTOL}"
                print(f"R={R} {precision}: max |color err| {ce:.3e}, max |sigma err| "
                      f"{se:.3e} ({limits})")
                if not ok:
                    raise AssertionError(f"kernel 3 disagrees with field_flat_plain at "
                                         f"R={R} {precision}")
                flat_err[precision] = max(flat_err[precision], ce, se)

    # ---- 3d. kernels 1 and 2 in their bf16 form vs their bf16 plain versions ----
    phase("kernels 1 and 2, bf16 form, vs their bf16 plain versions")
    bf16_inputs, bf16_fwd_err, bf16_bwd_abs, bf16_bwd_rel = {}, 0.0, 0.0, 0.0
    for B, N in (*OCC_SHAPES, VALIDATE_SHAPE, *BF16_EDGES):
        o, d, ts = rays(B, N)
        # at the ragged shape, rows this close to a kink in the bf16 form get
        # no cotangent (few rows: one ReLU taking the other side moves a bias
        # gradient by percents, as kernel 4's check found at R = 1001)
        keep = ((mk.preactivation_margin(params, o, d, ts, "bf16") > MARGIN).float()
                if (B, N) in BF16_EDGES else 1.0)
        cots = [torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32)).to(dev) * keep
                for _ in range(4)]
        bf16_inputs[B, N] = (o, d, ts, *cots)
        with torch.no_grad():
            (r, g, b), sigma = mk.field_rays(params, o, d, ts, "bf16")
            torch.cuda.synchronize()
            (pr, pg, pb), p_sigma = mk.field_rays_plain(params, o, d, ts, "bf16")
        fwd_rel = max(rel_err(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma)))
        kernel = mk.field_rays_bwd(params, *bf16_inputs[B, N], precision="bf16")
        again = mk.field_rays_bwd(params, *bf16_inputs[B, N], precision="bf16")
        torch.cuda.synchronize()
        plain = mk.field_rays_bwd_plain(params, *bf16_inputs[B, N], precision="bf16")
        errs = bwd_errors(kernel, plain)
        worst = max(errs, key=lambda k: errs[k][1])
        cos = bwd_cosines(kernel, plain)
        same = all(v[0] == 0 for v in bwd_errors(kernel, again).values())
        print(f"B={B} N={N}: kernel 1 bf16 error / max|plain| {fwd_rel:.3e} (limit "
              f"{BF16_FWD_RTOL}); kernel 2 bf16 worst {worst} {errs[worst][1]:.3e} (limit "
              f"{BF16_BWD_RTOL}), d_ts {errs['d_ts'][1]:.3e}, smallest cosine {cos:.7f} "
              f"(limit {BF16_COS}); two launches bit-identical: {same}")
        if fwd_rel > BF16_FWD_RTOL:
            raise AssertionError(f"kernel 1 bf16 disagrees with its plain version at B={B} N={N}")
        if errs[worst][1] > BF16_BWD_RTOL or cos < BF16_COS or not same:
            raise AssertionError(f"kernel 2 bf16 disagrees with its plain version at "
                                 f"B={B} N={N}: {errs}")
        # the training step's forms: equal to the recompute, as no tile holds
        # FIX_CAP ambiguous outputs, also where kernel 1's tiles are not kernel 2's
        with torch.no_grad():
            (sr, sg, sb), s_sigma, res = mk._launch(params, o, d, ts, "bf16", save=True)
        save_rel = max(rel_err(x, y) for x, y in
                       ((sr, pr), (sg, pg), (sb, pb), (s_sigma, p_sigma)))
        from_res = mk.field_rays_bwd(params, *bf16_inputs[B, N], precision="bf16",
                                     residuals=res)
        res_same = all(v[0] == 0 for v in bwd_errors(from_res, kernel).values())
        res_errs = bwd_errors(from_res, plain)
        res_worst = max(res_errs, key=lambda k: res_errs[k][1])
        res_cos = bwd_cosines(from_res, plain)
        print(f"  kernel 1's saving form error / max|plain| {save_rel:.3e} (limit "
              f"{BF16_FWD_RTOL}); kernel 2 from its residuals worst {res_worst} "
              f"{res_errs[res_worst][1]:.3e}, smallest cosine {res_cos:.7f}, bit-identical "
              f"to the recompute: {res_same}")
        if (save_rel > BF16_FWD_RTOL or res_errs[res_worst][1] > BF16_BWD_RTOL
                or res_cos < BF16_COS or not res_same):
            raise AssertionError(f"kernel 1's saving form or kernel 2 from its residuals "
                                 f"is off at B={B} N={N}")
        del res, from_res, res_errs
        if (B, N) == OCC_SHAPES[0]:
            sum_err, flag_lo, flag_hi = sum_order_record(
                params, *(torch.from_numpy(a).to(dev) for a in grid_probes(rng, 262144)))
            print(f"  for the record, cuBLAS's float32 trunk sums vs exact sums at 262,144 "
                  f"rows: max |error| {sum_err:.3f} x 2^-24 |x_r| |w_c| (the fix-up's bound: "
                  f"4); outputs it flags: {100 * flag_lo:.3f}-{100 * flag_hi:.3f}% a layer")
            exact = bwd_errors(exact_sum_bwd(mk, params, bf16_inputs[B, N]), plain)
            print(f"  for the record, the plain version summed exactly (float64 products "
                  f"and sums): d_ts {exact['d_ts'][1]:.3e}, d_origins "
                  f"{exact['d_origins'][1]:.3e} of max|plain| (the kernel's backward "
                  f"re-sums its ambiguous forward roundings in the plain version's order)")
        bf16_fwd_err = max(bf16_fwd_err, max(float((x - y).abs().max()) for x, y in
                                             ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))))
        bf16_bwd_abs = max(bf16_bwd_abs, max(e[0] for e in errs.values()))
        bf16_bwd_rel = max(bf16_bwd_rel, errs[worst][1])
        del kernel, again, plain, errs
    for shape in BF16_EDGES:
        del bf16_inputs[shape]
    torch.cuda.empty_cache()

    # ---- 3e. kernels 5 and 6 (the grid field), fp32 and bf16, vs plain ----
    phase("kernels 5 and 6 (grid field forward and recompute backward) vs plain, "
          "fp32 and bf16")
    grid_params = {g: grid_with_content(g, dev, seed=i) for i, g in enumerate(GRID)}
    grid_inputs = {}
    grid_err = {f: 0.0 for f in ("fwd fp32", "fwd bf16", "bwd fp32", "bwd bf16")}
    grid_rel = {"bwd fp32": 0.0, "bwd bf16": 0.0}
    for geometry, B, N in GRID_CHECKS:
        params_g, nd = grid_params[geometry], GRID[geometry][1]
        o, d, ts = (torch.from_numpy(a).to(dev) for a in grid_rays_at(rng, B, N))
        for precision in ("fp32", "bf16"):
            chk = grid_kernels_check(gk, params_g, nd, o, d, ts, precision, rng)
            print(f"{geometry} B={B} N={N} {precision}: {chk['line']}")
            if not chk["ok"]:
                raise AssertionError(f"kernels 5/6 disagree with their plain versions at "
                                     f"{geometry} B={B} N={N} {precision}: {chk['errs']}")
            grid_err[f"fwd {precision}"] = max(grid_err[f"fwd {precision}"], chk["ce"], chk["se"])
            grid_err[f"bwd {precision}"] = max(grid_err[f"bwd {precision}"],
                                               max(e[0] for e in chk["errs"].values()))
            grid_rel[f"bwd {precision}"] = max(grid_rel[f"bwd {precision}"], chk["worst_rel"])
            de, cots = chk["de"], chk["cots"]
        if (geometry, B, N) in GRID_SHAPES:
            grid_inputs[B, N] = (geometry, o, d, ts, de, cots)
    torch.cuda.empty_cache()

    # ---- 3f. kernels 7 and 8 (the proposal MLP), fp32 and bf16, vs plain ----
    phase("kernels 7 and 8 (proposal MLP forward and recompute backward) vs plain, "
          "fp32 and bf16")
    prop_params = {net: proposal.init_proposal(torch.Generator().manual_seed(i), width, depth,
                                               device=dev)
                   for i, (net, (width, depth)) in enumerate(PROP_NETS.items())}
    prop_inputs = {}
    prop_err = {f: 0.0 for f in ("fwd fp32", "fwd bf16", "bwd fp32", "bwd bf16")}
    prop_rel = {"bwd fp32": 0.0, "bwd bf16": 0.0}
    for net, B, N in PROP_CHECKS:
        params_p = prop_params[net]
        o, d, ts = rays(B, N)
        keep = (mk.preactivation_margin(params_p, o, d, ts) > MARGIN).float()
        cots = [torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32)).to(dev) * keep
                for _ in range(4)]
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                (r, g, b), sigma = pk.prop_rays(params_p, o, d, ts, precision)
                torch.cuda.synchronize()
                (pr, pg, pb), p_sigma = pk.prop_rays_plain(params_p, o, d, ts, precision)
            pairs = ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))
            fwd_abs = max(float((x - y).abs().max()) for x, y in pairs)
            fwd_rel = max(rel_err(x, y) for x, y in pairs)
            fwd_ok = fwd_abs <= COLOR_ATOL if precision == "fp32" else fwd_rel <= BF16_FWD_RTOL
            kernel = pk.prop_rays_bwd(params_p, o, d, ts, *cots, precision=precision)
            again = pk.prop_rays_bwd(params_p, o, d, ts, *cots, precision=precision)
            # the main paths' call: no ray gradient asked for
            no_rays = pk.prop_rays_bwd(params_p, o, d, ts, *cots, precision=precision,
                                       ray_grads=False)
            torch.cuda.synchronize()
            plain = pk.prop_rays_bwd_plain(params_p, o, d, ts, *cots, precision=precision)
            errs = prop_bwd_errors(kernel, plain)
            worst = max(errs, key=lambda k: errs[k][1])
            cos = min(e[2] for e in errs.values())
            same = all(e[0] == 0 for e in prop_bwd_errors(kernel, again).values())
            skip_same = no_rays[1:] == (None, None, None) and all(
                torch.equal(no_rays[0][n][k], kernel[0][n][k])
                for n in kernel[0] for k in ("w", "b"))
            limit = BWD_RTOL if precision == "fp32" else BF16_BWD_RTOL
            bwd_ok = errs[worst][1] <= limit and (precision == "fp32" or cos >= BF16_COS)
            print(f"{net} B={B} N={N} {precision}: forward max |err| {fwd_abs:.3e}, error / "
                  f"max|plain| {fwd_rel:.3e} (limit {COLOR_ATOL if precision == 'fp32' else BF16_FWD_RTOL}"
                  f"{' abs' if precision == 'fp32' else ''}); backward ({100 * (1 - float(keep.mean())):.3f}% "
                  f"of rows within {MARGIN} of a kink, zero cotangent) worst {worst} "
                  f"{errs[worst][1]:.3e} of max|plain| (limit {limit}), d_ts "
                  f"{errs['d_ts'][1]:.3e}, trunk_0.w {errs['trunk_0.w'][1]:.3e}, smallest cosine "
                  f"{cos:.7f}; two launches bit-identical: {same}; without the ray "
                  f"gradients, the weight gradients bit-identical: {skip_same}")
            if not (fwd_ok and bwd_ok and same and skip_same):
                raise AssertionError(f"kernels 7/8 disagree with their plain versions at "
                                     f"{net} B={B} N={N} {precision}: {errs}")
            if precision == "bf16" and B == PROP_SHAPE[0]:
                raw = prop_bwd_errors(pk._launch_bwd(params_p, o, d, ts, *cots, precision,
                                                     defines=pk.NO_FIXUP_DEFINES), plain)
                print(f"  for the record, the bf16 backward without its fix-up (the "
                      f"PROP_NO_FIXUP build: tensor-core sums rounded as they come): worst "
                      f"{max(raw, key=lambda k: raw[k][1])} {max(e[1] for e in raw.values()):.3e}"
                      f" of max|plain|, d_ts {raw['d_ts'][1]:.3e}, d_origins "
                      f"{raw['d_origins'][1]:.3e} (the limit {BF16_BWD_RTOL})")
            prop_err[f"fwd {precision}"] = max(prop_err[f"fwd {precision}"], fwd_abs)
            prop_err[f"bwd {precision}"] = max(prop_err[f"bwd {precision}"],
                                               max(e[0] for e in errs.values()))
            prop_rel[f"bwd {precision}"] = max(prop_rel[f"bwd {precision}"], errs[worst][1])
            del kernel, again, no_rays, plain
        if (net, B, N) == ("128x4", *PROP_SHAPE):
            prop_inputs[B, N] = (o, d, ts, *cots)
    torch.cuda.empty_cache()

    # ---- 3g. kernels 9 and 10 (the fused renderer), fp32 and bf16, vs plain ----
    phase("kernels 9 and 10 (fused renderer forward, and its backward from kernel 9's "
          "residuals) vs plain, fp32 and bf16")
    content = optim.tree_map(lambda t: t.clone(), params)
    content["sigma"]["b"] += 1.0   # a field with content (ROADMAP, tolerances)
    n_c, n_f = FUSED_SAMPLES
    fused_inputs = {}
    fused_err = {f: 0.0 for f in ("fwd fp32", "fwd bf16", "bwd fp32", "bwd bf16")}
    fused_cos = {"fp32": 1.0, "bf16": 1.0}
    merge_err = {"fp32": 0.0, "bf16": 0.0}   # kernel 10's merge launch vs float64, of max
    fused_ratio = {"fp32": [1.0, 1.0], "bf16": [1.0, 1.0]}
    for precision, B, white in FUSED_CHECKS:
        args = fused_rays(dev, B, seed=B, empty=7 if B == 1001 else 0)
        with torch.no_grad():
            k_out = rk.render_fused(content, *args, n_f, white, precision)
            torch.cuda.synchronize()
            p_out = rk._plain(content, *args, n_f, white, precision)
        errs = [float((a - b).abs().max()) for a, b in zip(k_out, p_out)]
        finite = all(bool(torch.isfinite(x).all()) for x in k_out)
        g = [torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)).to(dev)
             for _ in range(2)]
        r_co, r_fi, res = rk.render_fused_residuals(content, *args, n_f, white, precision)
        same_colors = torch.equal(r_co, k_out[0]) and torch.equal(r_fi, k_out[1])
        kernel = rk.render_fused_bwd(content, *args, *g, n_f, white, precision, residuals=res)
        again = rk.render_fused_bwd(content, *args, *g, n_f, white, precision, residuals=res)
        standalone = rk.render_fused_bwd(content, *args, *g, n_f, white, precision)
        views = rk.split_residuals(res, B, n_c, n_f)
        fine_ts = views.t_fi
        merge_in = (args[2], fine_ts, views.sig_co, views.sig_fi, views.col_co, views.col_fi,
                    *args[3:], *g, white)
        merge = rk.merge_bwd(*merge_in)
        torch.cuda.synchronize()
        merge_ok, merge_rows = rk.merge_agreement(merge, *merge_in)
        same_c_fi = torch.equal(merge.c_fi, k_out[1])
        plain = rk.render_fused_bwd_plain(content, *args, *g, n_f, white, precision, fine_ts)
        ok, worst, rows = rk.grads_agree(kernel, plain, precision)
        # for the record: at the plain version's own fine t's
        own = rk.grad_agreement(kernel, rk.render_fused_bwd_plain(content, *args, *g, n_f,
                                                                  white, precision))
        ratios = [v[1] for v in rows.values()]
        same = all(torch.equal(kernel[n][k], again[n][k])
                   and torch.equal(kernel[n][k], standalone[n][k])
                   for n in kernel for k in ("w", "b"))
        t_diff = (fine_ts - p_out[2]).abs()
        print(f"{precision} B={B} white_bkgd={white}: kernel 9 max |C_coarse err| {errs[0]:.3e}, "
              f"|C_fine err| {errs[1]:.3e} (atol {FUSED_ATOL[precision]}), finite {finite}; "
              f"the same colors where it writes its residuals: {same_colors}; "
              f"its fine t's vs the plain's: {int((t_diff > 0).sum())} of {t_diff.numel()} "
              f"differ, max {float(t_diff.max()):.3e}; kernel 10 from the residuals vs the "
              f"plain backward at kernel 9's fine t's: smallest cosine {rows[worst][0]:.8f} "
              f"({worst}; bound {rk.GRAD_COS[precision]}), norm ratios "
              f"{min(ratios):.6f}..{max(ratios):.6f} (bound at fp32 1 +- {rk.GRAD_NORM}); at "
              f"the plain's own fine t's (no bound): smallest cosine "
              f"{min(v[0] for v in own.values()):.8f}, norm ratios "
              f"{min(v[1] for v in own.values()):.6f}..{max(v[1] for v in own.values()):.6f}; "
              f"two launches and the call without residuals bit-identical: {same}; the merge "
              f"launch, and in brackets merge_bwd_plain, against the float64 evaluation, of "
              f"its max (bound {rk.MERGE_RTOL} more than the plain's), then the launch against "
              f"the plain: " + ", ".join(f"{k} {v[0]:.2e} ({v[1]:.2e}) {v[2]:.2e}"
                                          for k, v in merge_rows.items())
              + f"; its C_fine equal to kernel 9's bit for bit: {same_c_fi}")
        if not (finite and max(errs) <= FUSED_ATOL[precision] and same and ok and same_colors
                and same_c_fi and merge_ok):
            raise AssertionError(f"kernels 9/10 disagree with their plain versions at "
                                 f"{precision} B={B} white_bkgd={white}: {errs} {rows} "
                                 f"{merge_rows}")
        fused_err[f"fwd {precision}"] = max(fused_err[f"fwd {precision}"], *errs)
        fused_err[f"bwd {precision}"] = max(fused_err[f"bwd {precision}"],
                                            max(v[2] for v in rows.values()))
        merge_err[precision] = max(merge_err[precision], *(v[0] for v in
                                                            list(merge_rows.values())[:4]))
        fused_cos[precision] = min(fused_cos[precision], rows[worst][0])
        fused_ratio[precision] = [min(fused_ratio[precision][0], min(ratios)),
                                  max(fused_ratio[precision][1], max(ratios))]
        # timed at the render paths' forms: lego fp32 black, lego_occ bf16 white
        if B == 4096 and white == (precision == "bf16"):
            fused_inputs[precision] = (args, g, white)
        del kernel, again, standalone, plain, own, fine_ts, res, views, merge
    # through autograd the params get kernel 10's gradient, the rays none
    o, d, t_co, near, far = fused_rays(dev, 1001, seed=1)
    o_leaf = o.clone().requires_grad_(True)
    leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), content)
    c_co, c_fi = rk.render_fused(leaves, o_leaf, d, t_co, near, far, n_f)
    (c_co.sum() + c_fi.sum()).backward()
    if o_leaf.grad is not None or leaves["trunk_0"]["w"].grad is None:
        raise AssertionError("render_fused gave the rays a gradient, or the params none")
    print("through autograd: the params get a gradient, the origins none")
    del leaves, o_leaf
    torch.cuda.empty_cache()

    # ---- 3h. kernel 4 (the flat field's recompute backward), fp32 and bf16, vs plain ----
    phase("kernel 4 (flat field recompute backward) vs plain, fp32 and bf16")
    flat_bwd_inputs, flat_bwd_err, flat_bwd_rel, flat_bwd_cos = {}, {}, {}, {}
    for R in FLAT_BWD_ROWS:
        pts, dirs = (torch.from_numpy(a).to(dev) for a in contracted_rows(rng, R))
        g_rows = torch.from_numpy(rng.normal(size=(R, 4)).astype(np.float32)).to(dev)
        for precision in ("fp32", "bf16"):
            # rows this close to a kink (in the form compared) get no cotangent
            keep = mk.preactivation_margin(params, pts, dirs, pts.new_zeros(R, 1),
                                           precision) > MARGIN
            g = g_rows * keep.float()
            kernel = mk.field_flat_bwd(params, pts, dirs, g, precision)
            again = mk.field_flat_bwd(params, pts, dirs, g, precision)
            plain = mk.field_flat_bwd_plain(params, pts, dirs, g, precision)
            torch.cuda.synchronize()
            errs = bwd_errors(kernel, plain)
            errs["d_points"], errs["d_dirs"] = errs.pop("d_origins"), errs.pop("d_dirs")
            cos = bwd_cosines(kernel, plain)
            same = all(v[0] == 0 for v in bwd_errors(kernel, again).values())
            worst = max(errs, key=lambda k: errs[k][1])
            limit = BWD_RTOL if precision == "fp32" else BF16_BWD_RTOL
            print(f"R={R} {precision} ({100 * (1 - float(keep.float().mean())):.3f}% of rows "
                  f"within {MARGIN} of a kink, zero cotangent): worst {worst} error / "
                  f"max|plain| {errs[worst][1]:.3e} (limit {limit}); d_points "
                  f"{errs['d_points'][1]:.3e}, d_dirs {errs['d_dirs'][1]:.3e}, trunk_4.w "
                  f"{errs['trunk_4.w'][1]:.3e}, sigma.w {errs['sigma.w'][1]:.3e}; smallest "
                  f"cosine {cos:.7f}{'' if precision == 'fp32' else f' (limit {BF16_COS})'}; "
                  f"two launches bit-identical: {same}")
            if not (errs[worst][1] <= limit and same
                    and (precision == "fp32" or cos >= BF16_COS)):
                raise AssertionError(f"kernel 4 disagrees with field_flat_bwd_plain at R={R} "
                                     f"{precision}: {errs}")
            flat_bwd_err[precision] = max(flat_bwd_err.get(precision, 0.0),
                                          max(e[0] for e in errs.values()))
            flat_bwd_rel[precision] = max(flat_bwd_rel.get(precision, 0.0), errs[worst][1])
            flat_bwd_cos[precision] = min(flat_bwd_cos.get(precision, 1.0), cos)
            if R == FLAT_BWD_ROWS[0]:
                flat_bwd_inputs[precision] = (pts, dirs, g)
            del kernel, again, plain
    torch.cuda.empty_cache()

    # ---- 4. timing ----
    phase("timing (per launch, CUDA events)")
    fwd_time, bwd_time, bwd_split = {}, {}, {}
    n_params = mlp.num_params(params)
    with torch.no_grad():
        for (B, N), (o, d, ts) in fwd_inputs.items():
            k_ms = cuda_ms(lambda: mk.field_rays(params, o, d, ts), iters=20)
            p_ms = cuda_ms(lambda: mk.field_rays_plain(params, o, d, ts), iters=5)
            flops = mk.flops_per_row() * B * N
            n_bytes = 4 * (2 * 3 * B + 5 * B * N + n_params)
            bound = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
            fwd_time[B, N] = (k_ms, p_ms, bound)
            print(f"kernel 1 B={B} N={N}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} "
                  f"bound_ms {bound:.3f} (f32 FLOP bound, {flops / 1e9:.1f} GFLOP); "
                  f"{flops / k_ms / 1e9:.2f} TFLOP/s = {100 * bound / k_ms:.1f}% of peak")
    for (B, N), args in bwd_inputs.items():
        k_ms = cuda_ms(lambda: mk.field_rays_bwd(params, *args), iters=10)
        p_ms = cuda_ms(lambda: mk.field_rays_bwd_plain(params, *args), iters=3)
        flops = 3 * mk.flops_per_row() * B * N
        # in: rays, ts, 4 cotangents, params; out: d_o, d_d, d_ts, grads
        n_bytes = 4 * (2 * 3 * B + 5 * B * N + n_params + 2 * 3 * B + B * N + n_params)
        bound = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
        bwd_time[B, N] = (k_ms, p_ms, bound)
        print(f"kernel 2 B={B} N={N}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} "
              f"bound_ms {bound:.3f} (f32 FLOP bound, {flops / 1e9:.1f} GFLOP); "
              f"{flops / k_ms / 1e9:.2f} TFLOP/s = {100 * bound / k_ms:.1f}% of peak")
        if N == 128:
            bwd_split[B, N] = launch_split(lambda: mk.field_rays_bwd(params, *args),
                                           f"kernel 2 fp32 B={B} N={N}")
    del bwd_inputs
    bwd_chain_ms = bwd_gemm_chain_ms_fp32(dev)
    print(f"bwd_gemm_chain_ms_fp32 {bwd_chain_ms:.3f}: torch.matmul in float32 (TF32 off) over "
          f"the backward's 36 layer products at M = {BWD_CHAIN_ROWS} (kernel 2 fp32 at B=400 "
          f"N=128: {bwd_time[STEP_SHAPES[-1]][0]:.3f} ms)")
    torch.cuda.empty_cache()

    # the new forms: (ms, plain ms, bound ms, bound_by, f32 FMA bound ms); a
    # bf16 training step's forms (kernel 1's saving form, kernel 2 from its
    # residuals): (forward ms, backward ms)
    flat_time, bf16_fwd_time, bf16_bwd_time, bf16_train_time = {}, {}, {}, {}

    def report(what, k_ms, p_ms, flops, n_bytes, precision, tc_flops=None):
        b_ms, b_by = least_ms(flops, n_bytes, precision, tc_flops)
        f32_ms = least_ms(flops, n_bytes, "fp32")[0]
        print(f"{what}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} bound_ms {b_ms:.4f} "
              f"({precision} {b_by} bound, {flops / 1e9:.1f} GFLOP; {100 * b_ms / k_ms:.2f}%); "
              f"f32 FMA bound {f32_ms:.3f} ms ({100 * f32_ms / k_ms:.1f}%); "
              f"{flops / k_ms / 1e9:.2f} TFLOP/s")
        return k_ms, p_ms, b_ms, b_by, f32_ms

    with torch.no_grad():
        flat_inputs[FLAT_BWD_ROWS[0]] = flat_bwd_inputs["fp32"][:2]
        for R in (*FLAT_ROWS[:2], FLAT_BWD_ROWS[0]):
            pts, dirs = flat_inputs[R]
            for precision in ("fp32", "bf16"):
                k_ms = cuda_ms(lambda: mk.field_flat(params, pts, dirs, precision), iters=20)
                p_ms = cuda_ms(lambda: mk.field_flat_plain(params, pts, dirs, precision), iters=5)
                # in: points, dirs, params; out: (R, 4)
                flat_time[R, precision] = report(
                    f"kernel 3 {precision} R={R}", k_ms, p_ms, mk.flops_per_row() * R,
                    4 * (6 * R + n_params + 4 * R), precision)
        for (B, N), (o, d, ts, *_) in bf16_inputs.items():
            k_ms = cuda_ms(lambda: mk.field_rays(params, o, d, ts, "bf16"), iters=20)
            p_ms = cuda_ms(lambda: mk.field_rays_plain(params, o, d, ts, "bf16"), iters=5)
            bf16_fwd_time[B, N] = report(
                f"kernel 1 bf16 B={B} N={N}", k_ms, p_ms, mk.flops_per_row() * B * N,
                4 * (2 * 3 * B + 5 * B * N + n_params), "bf16")
    for (B, N), args in bf16_inputs.items():
        k_ms = cuda_ms(lambda: mk.field_rays_bwd(params, *args, precision="bf16"), iters=10)
        p_ms = cuda_ms(lambda: mk.field_rays_bwd_plain(params, *args, precision="bf16"), iters=3)
        bf16_bwd_time[B, N] = report(
            f"kernel 2 bf16 B={B} N={N}", k_ms, p_ms, 3 * mk.flops_per_row() * B * N,
            4 * (2 * 3 * B + 5 * B * N + n_params + 2 * 3 * B + B * N + n_params), "bf16")
        o, d, ts = args[:3]
        with torch.no_grad():
            s_ms = cuda_ms(lambda: mk._launch(params, o, d, ts, "bf16", save=True), iters=10)
            res = mk._launch(params, o, d, ts, "bf16", save=True)[2]
        r_ms = cuda_ms(lambda: mk.field_rays_bwd(params, *args, precision="bf16",
                                                 residuals=res), iters=10)
        row_bytes = 2 * res.a.shape[1] + 4   # A and the sign, kept a row
        report(f"kernel 1 bf16 saving form B={B} N={N}", s_ms, bf16_fwd_time[B, N][1],
               mk.flops_per_row() * B * N,
               4 * (2 * 3 * B + 5 * B * N + n_params) + row_bytes * B * N, "bf16")
        report(f"kernel 2 bf16 from residuals B={B} N={N}", r_ms, p_ms,
               2 * mk.flops_per_row() * B * N,
               4 * (2 * 3 * B + 8 * B * N + n_params + 2 * 3 * B + B * N + n_params)
               + row_bytes * B * N,
               "bf16")
        bf16_train_time[B, N] = (s_ms, r_ms)
        del res
    # kernel 2 bf16's launches: recompute + input gradients, weight
    # gradients, reduce (and the weights' packing)
    args = bf16_inputs[OCC_SHAPES[-1]]
    profile_calls(lambda: mk.field_rays_bwd(params, *args, precision="bf16"), 3, "calls")
    del bf16_inputs, flat_inputs, args
    torch.cuda.empty_cache()

    # a yardstick beside kernel 1 bf16, not the same function (no encoding,
    # biases, activations or heads) and never called by the port: torch.matmul
    # in bf16 over the same twelve layer products at M = 524,288 rows
    dims = [(fan_in, fan_out) for _, fan_in, fan_out in mlp.layer_dims()]
    xs = {k: torch.randn(GEMM_CHAIN_ROWS, k, device=dev, dtype=torch.bfloat16)
          for k in {k for k, _ in dims}}
    ws = [torch.randn(k, n, device=dev, dtype=torch.bfloat16) for k, n in dims]
    gemm_chain_ms = cuda_ms(lambda: [torch.matmul(xs[k], w) for (k, _), w in zip(dims, ws)],
                            iters=10)
    print(f"gemm_chain_ms {gemm_chain_ms:.3f}: torch.matmul bf16 over the twelve layer "
          f"products at M = {GEMM_CHAIN_ROWS} (kernel 1 bf16 at B=4096 N=128: "
          f"{bf16_fwd_time[OCC_SHAPES[-1]][0]:.3f} ms)")
    del xs, ws
    torch.cuda.empty_cache()

    # kernel 4 at an unbounded360-mlp step's fine rows: (ms, plain ms, bound
    # ms, bound_by, f32 FMA bound ms) per precision
    flat_bwd_time = {}
    for precision, (pts, dirs, g) in flat_bwd_inputs.items():
        R = pts.shape[0]
        k_ms = cuda_ms(lambda: mk.field_flat_bwd(params, pts, dirs, g, precision), iters=3,
                       warmup=1)
        p_ms = cuda_ms(lambda: mk.field_flat_bwd_plain(params, pts, dirs, g, precision),
                       iters=2, warmup=1)
        # in: points, dirs, the (R, 4) cotangent, params; out: d_points, d_dirs, grads
        flat_bwd_time[R, precision] = report(
            f"kernel 4 {precision} R={R}", k_ms, p_ms, 3 * mk.flops_per_row() * R,
            4 * (6 * R + 4 * R + n_params + 6 * R + n_params), precision)
        if precision == "bf16":
            profile_calls(lambda: mk.field_flat_bwd(params, pts, dirs, g, precision), 2,
                          "calls")
    del flat_bwd_inputs
    torch.cuda.empty_cache()

    # kernels 5 and 6: (ms, plain ms, bound ms, bound_by, f32 FMA bound ms)
    # per (precision, (B, N)); the bound counts the gather form's FLOPs, in
    # the bf16 forms the decoder's product at the tensor cores' rate and the
    # rest at the f32 FMA rate. Kernel 5's ms is the wrapper's call
    # (gk.grid_rays, the encoding included), as every row is timed;
    # grid_launch_ms times its bare launch (gk._launch, the encoding given).
    # grid_split: kernel 6's phase split (the clock64 variant build).
    grid_fwd_time = {"fp32": {}, "bf16": {}}
    grid_bwd_time = {"fp32": {}, "bf16": {}}
    grid_launch_ms = {"fp32": {}, "bf16": {}}
    grid_split = {"fp32": {}, "bf16": {}}
    for (B, N), (geometry, o, d, ts, de, cots) in grid_inputs.items():
        params_g, dims = grid_params[geometry], GRID[geometry]
        nd = dims[1]
        n_grid = gridfield.num_params(params_g)
        flops = gk.flops_per_row(*dims) * B * N
        tc_flops = gk.flops_split_per_row(*dims)[0] * B * N
        hat = gk.hat_flops_per_row(*dims) * B * N
        # in: origins, dirs, ts, the encoding, params; out: four planes
        fwd_bytes = 4 * (6 * B + B * N + 24 * B + n_grid + 4 * B * N)
        # in: the same and four cotangent planes; out: d_o, d_d, d_ts, d_de, grads
        bwd_bytes = 4 * (6 * B + B * N + 24 * B + n_grid + 4 * B * N
                         + 6 * B + B * N + 24 * B + n_grid)
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                k_ms = cuda_ms(lambda: gk.grid_rays(params_g, o, d, ts, nd, precision), iters=20)
                launch_ms = cuda_ms(lambda: gk._launch(params_g, o, d, ts, de, nd, precision),
                                    iters=20)
                p_ms = cuda_ms(lambda: gk.grid_rays_plain(params_g, o, d, ts, de, nd, precision),
                               iters=5)
            grid_launch_ms[precision][B, N] = launch_ms
            grid_fwd_time[precision][B, N] = report(
                f"kernel 5 {precision} {geometry} B={B} N={N}", k_ms, p_ms, flops, fwd_bytes,
                precision, tc_flops)
            print(f"  the bare launch (grid_kernel._launch, the encoding given): "
                  f"{launch_ms:.3f} ms")
            k_ms = cuda_ms(lambda: gk.grid_rays_bwd(params_g, o, d, ts, de, *cots,
                                                     n_density=nd, precision=precision), iters=10)
            p_ms = cuda_ms(lambda: gk.grid_rays_bwd_plain(params_g, o, d, ts, de, *cots,
                                                          n_density=nd, precision=precision),
                           iters=3)
            grid_bwd_time[precision][B, N] = report(
                f"kernel 6 {precision} {geometry} B={B} N={N}", k_ms, p_ms, 3 * flops,
                bwd_bytes, precision, 3 * tc_flops)
            split = grid_split[precision][B, N] = gk.bwd_phase_split(
                params_g, o, d, ts, de, *cots, n_density=nd, precision=precision)
            print("  kernel 6 phase split (clock64 variant, shares of the blocks' cycles): "
                  + ", ".join(f"{k} {100 * v:.1f}% ({v * k_ms:.3f} ms)" for k, v in split.items()))
        print(f"  {geometry}: the TPU kernel's own hat-form count {hat / 1e9:.2f} GFLOP "
              f"forward ({gk.hat_flops_per_row(*dims):,} a row) against the gather form's "
              f"{flops / 1e9:.3f} ({gk.flops_per_row(*dims):,} a row, "
              f"{gk.flops_split_per_row(*dims)[0]:,} of it the decoder's product); bytes "
              f"{fwd_bytes / 1e6:.2f} MB forward, {bwd_bytes / 1e6:.2f} MB backward, bytes bound "
              f"{1e3 * fwd_bytes / PEAK_BYTES:.4f} / {1e3 * bwd_bytes / PEAK_BYTES:.4f} ms")
    del grid_inputs
    torch.cuda.empty_cache()

    # kernels 7 and 8 at lego_prop's proposal call: (ms, plain ms, bound ms,
    # bound_by, f32 FMA bound ms) per (precision, (B, N)); the FLOPs are the
    # TPU kernel's count (the encoding's sines and cosines not in it). ms is
    # the wrapper's call, as every row's (kernel 8's with the ray gradients,
    # as the parent's row); prop_extra: the bare launch (launch_ms: the
    # wrapper's checks and autograd left out), kernel 8 without the ray
    # gradients (the main paths' call), kernel 8's time by launch and its
    # recompute kernel's phase split in both forms (the clock64 variant build)
    prop_fwd_time = {"fp32": {}, "bf16": {}}
    prop_bwd_time = {"fp32": {}, "bf16": {}}
    prop_extra = {f"{k} {p}": {} for k in ("fwd", "bwd") for p in ("fp32", "bf16")}
    params_p = prop_params["128x4"]
    n_prop = sum(t.numel() for layer in params_p.values() for t in layer.values())
    for (B, N), (o, d, ts, *cots) in prop_inputs.items():
        flops = pk.flops_per_row(*PROP_NETS["128x4"]) * B * N
        # in: origins, dirs, ts, params; out: four planes
        fwd_bytes = 4 * (6 * B + B * N + n_prop + 4 * B * N)
        # in: the same and four cotangent planes; out: d_o, d_d, d_ts, grads
        bwd_bytes = 4 * (6 * B + 5 * B * N + n_prop + 6 * B + B * N + n_prop)
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                k_ms = cuda_ms(lambda: pk.prop_rays(params_p, o, d, ts, precision), iters=20)
                launch_ms = cuda_ms(lambda: pk._launch(params_p, o, d, ts, precision), iters=20)
                p_ms = cuda_ms(lambda: pk.prop_rays_plain(params_p, o, d, ts, precision), iters=5)
            prop_fwd_time[precision][B, N] = report(
                f"kernel 7 {precision} 128x4 B={B} N={N}", k_ms, p_ms, flops, fwd_bytes,
                precision)
            print(f"  the bare launch (proposal_kernel._launch): {launch_ms:.3f} ms")
            prop_extra[f"fwd {precision}"] = {"launch_ms": launch_ms}
            bwd = lambda **kw: pk.prop_rays_bwd(params_p, o, d, ts, *cots, precision=precision,
                                                **kw)
            k_ms = cuda_ms(bwd, iters=10)
            launch_ms = cuda_ms(lambda: pk._launch_bwd(params_p, o, d, ts, *cots, precision),
                                iters=10)
            off_ms = cuda_ms(lambda: bwd(ray_grads=False), iters=10)
            p_ms = cuda_ms(lambda: pk.prop_rays_bwd_plain(params_p, o, d, ts, *cots,
                                                          precision=precision), iters=3)
            prop_bwd_time[precision][B, N] = report(
                f"kernel 8 {precision} 128x4 B={B} N={N}", k_ms, p_ms, 3 * flops, bwd_bytes,
                precision)
            print(f"  the bare launch (proposal_kernel._launch_bwd): {launch_ms:.3f} ms; "
                  f"without the ray gradients (the main paths' call): {off_ms:.3f} ms")
            extra = prop_extra[f"bwd {precision}"] = {
                "launch_ms": launch_ms, "ray_grads_off_ms": off_ms,
                "launch_split": launch_split(bwd, f"kernel 8 {precision}"),
                "launch_split_ray_grads_off": launch_split(
                    lambda: bwd(ray_grads=False),
                    f"kernel 8 {precision} without the ray gradients")}
            for rays_on in (True, False):
                split = pk.bwd_phase_split(params_p, o, d, ts, *cots, precision=precision,
                                           ray_grads=rays_on)
                ref_ms = k_ms if rays_on else off_ms
                print(f"  kernel 8 {precision} {'with' if rays_on else 'without'} the ray "
                      f"gradients, the recompute kernel's phase split (clock64 variant, "
                      f"shares of the blocks' cycles; ms of the call): "
                      + ", ".join(f"{k} {100 * v:.1f}% ({v * ref_ms:.3f})"
                                  for k, v in split.items()))
                extra["phase_split" if rays_on else "phase_split_ray_grads_off"] = split
        print(f"  128x4: {pk.flops_per_row(*PROP_NETS['128x4']):,} FLOP a row, "
              f"{flops / 1e9:.2f} GFLOP forward; bytes {fwd_bytes / 1e6:.2f} MB forward, "
              f"{bwd_bytes / 1e6:.2f} MB backward")
    del prop_inputs
    torch.cuda.empty_cache()

    # kernels 9 and 10 at a render chunk (B = 4096, 64 + 128 samples): (ms,
    # plain ms, bound ms, bound_by, f32 FMA bound ms) per (precision, shape);
    # the FLOPs are the field's at every sample (the tail's few not counted);
    # fused_extra: kernel 9's yardstick (the unfused path's device time on the
    # same rays), phase split and, at bf16, its bare launch beside the weight
    # probe build's; kernel 10's launch split
    fused_fwd_time = {"fp32": {}, "bf16": {}}
    fused_bwd_time = {"fp32": {}, "bf16": {}}
    fused_extra = {"fwd fp32": {}, "fwd bf16": {}, "bwd fp32": {}, "bwd bf16": {}}
    for precision, (args, g, white) in fused_inputs.items():
        B = args[0].shape[0]
        flops = rk.flops_per_ray(n_c, n_f) * B
        # in: origins, dirs, t_co, near, far, params; out: two (B, 3) colors
        fwd_bytes = 4 * (B * (3 + 3 + n_c + 2) + n_params + 6 * B)
        # in: the same, two (B, 3) cotangents and kernel 9's residuals; out:
        # every weight gradient
        bwd_bytes = 4 * (B * (3 + 3 + n_c + 2) + n_params + 6 * B + B * (4 * n_c + 5 * n_f)
                         + n_params)
        with torch.no_grad():
            k_ms = cuda_ms(lambda: rk.render_fused(content, *args, n_f, white, precision),
                           iters=5, warmup=1)
            p_ms = cuda_ms(lambda: rk.render_fused_plain(content, *args, n_f, white, precision),
                           iters=3, warmup=1)
        fused_fwd_time[precision][B, n_c, n_f] = report(
            f"kernel 9 {precision} B={B} {n_c}+{n_f}", k_ms, p_ms, flops, fwd_bytes, precision)
        # kernel 10 as autograd calls it, from kernel 9's residuals; without
        # them (kernel 9, then kernel 10); one chunk's forward and backward
        # through autograd (no path of the port trains through the fused
        # renderer: a measurement of the autograd pair, not of a user path)
        res = rk.render_fused_residuals(content, *args, n_f, white, precision)[2]
        bwd = lambda: rk.render_fused_bwd(content, *args, *g, n_f, white, precision,
                                          residuals=res)
        k_ms = cuda_ms(bwd, iters=3, warmup=1)
        standalone_ms = cuda_ms(lambda: rk.render_fused_bwd(content, *args, *g, n_f, white,
                                                            precision), iters=3, warmup=1)
        leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), content)
        flat_leaves = [leaves[name][k] for name, k in mk._PARAM_KEYS]

        def chunk():
            outs = rk.render_fused(leaves, *args, n_f, white, precision)
            torch.autograd.grad(outs, flat_leaves, g)

        chunk_ms = cuda_ms(chunk, iters=3, warmup=1)
        p_ms = cuda_ms(lambda: rk.render_fused_bwd_plain(content, *args, *g, n_f, white,
                                                         precision), iters=2, warmup=1)
        fused_bwd_time[precision][B, n_c, n_f] = report(
            f"kernel 10 {precision} B={B} {n_c}+{n_f}", k_ms, p_ms, 3 * flops, bwd_bytes,
            precision)
        # the merge launch alone, its device time a launch (torch.profiler):
        # the wrapper's call is host-bound
        views = rk.split_residuals(res, B, n_c, n_f)
        merge_in = (args[2], views.t_fi, views.sig_co, views.sig_fi, views.col_co, views.col_fi,
                    *args[3:], *g, white)
        merge_ms = sum(r[2] for r in profiling.device_rows(
            lambda: rk._launch_merge(*merge_in), 20)[1]) / 20
        print(f"  kernel 10 {precision}: without residuals (kernel 9, then kernel 10) "
              f"{standalone_ms:.3f} ms; one chunk's forward and backward through autograd "
              f"{chunk_ms:.3f} ms; the merge launch alone, device ms (torch.profiler) "
              f"{merge_ms:.4f}")
        fused_extra[f"bwd {precision}"] = {
            "standalone_ms": standalone_ms, "chunk_fwd_bwd_ms": chunk_ms,
            "merge_launch_device_ms": merge_ms}
        del leaves, flat_leaves, res, views, merge_in
        with torch.no_grad():
            unfused = lambda: unfused_chunk(mk, content, *args, n_f, white, precision)
            u_ms = cuda_ms(unfused, iters=5, warmup=1)
            _, rows, _ = profiling.device_rows(unfused, 3)
        u_dev = sum(r[2] for r in rows) / 3
        split = rk.fwd_phase_split(content, *args, n_f, white, precision)
        print(f"  kernel 9 {precision}: the unfused path on the same rays (kernel 1 twice and "
              f"the PyTorch tail) {u_ms:.3f} ms (CUDA events), {u_dev:.3f} ms of device time "
              f"(torch.profiler); kernel 9 {fused_fwd_time[precision][B, n_c, n_f][0]:.3f} ms")
        print(f"  kernel 9 {precision} phase split (clock64 variant, shares of the blocks' "
              f"cycles): " + ", ".join(f"{k} {100 * v:.1f}%" for k, v in split.items()))
        print(f"  kernel 9 {precision} L2 -> SM weight bytes a call, arithmetic from the "
              f"shapes (not measured): this tree's tiles "
              f"{fused_weight_bytes(rk, B, n_c, n_f, precision) / 1e9:.2f} GB; the earlier "
              f"design's (64-row tiles, max(1, 64 / N_c) rays a block) "
              f"{fused_weight_bytes(rk, B, n_c, n_f, precision, parent=True) / 1e9:.2f} GB")
        fused_extra[f"fwd {precision}"] = {"unfused_chunk_ms": u_ms,
                                           "unfused_chunk_device_ms": u_dev,
                                           "phase_split": split}
        if precision == "bf16":
            with torch.no_grad():
                launch = lambda defines=(): rk._launch(content, *args, n_f, white, precision,
                                                       defines=defines)
                launch_ms = cuda_ms(launch, iters=5, warmup=1)
                probe_ms = cuda_ms(lambda: launch(rk.WEIGHT_PROBE_DEFINES), iters=5, warmup=1)
                launch_ms2 = cuda_ms(launch, iters=5, warmup=1)
            print(f"  kernel 9 bf16's bare launch {launch_ms:.3f}, {launch_ms2:.3f} ms; its "
                  f"weight probe build (FIELD_TC_WEIGHT_PROBE: the products read 176,128 of "
                  f"the 593,920 packed weight values a pass, wrong colors, the same "
                  f"instructions) {probe_ms:.3f} ms")
            fused_extra["fwd bf16"].update(launch_ms=[launch_ms, launch_ms2],
                                           weight_probe_ms=probe_ms)
        res = rk.render_fused_residuals(content, *args, n_f, white, precision)[2]
        fused_extra[f"bwd {precision}"]["split"] = launch_split(
            lambda: rk.render_fused_bwd(content, *args, *g, n_f, white, precision,
                                        residuals=res),
            f"kernel 10 {precision} B={B} {n_c}+{n_f} from kernel 9's residuals")
        del res
    del fused_inputs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(os.path.join(ROOT, "conf", "lego.ini"))
        cfg.ckpt_path = os.path.join(tmp, "ckpt")
        cfg.results_path = os.path.join(tmp, "results")
        cfg.log_dir = os.path.join(tmp, "runs")
        cfg.continue_ = False
        cfg.total_iter = TRAIN_STEPS
        cfg.step = 10 * TRAIN_STEPS  # no preview JPG: imageio is not needed

        def fused_render_phase(fcfg, scene, unfused, unfused_s, atol):
            """Render ``scene``'s test views from ``fcfg``'s checkpoint with
            FUSED_RENDER (and its grid, with OCC_GRID) through
            ``eval.render_test_set``; check one kernel-9 launch a chunk and
            none of kernels 1-3, frames finite in [0, 1], a real chunk through
            kernel 9 against ``render_fused_plain`` (``atol``) and one
            gradient of that chunk's loss through ``render_rays``' fused
            branch (one launch each of kernels 9 and 10) held against the
            plain backward at kernel 9's fine t's (``render_kernel.grads_agree``).
            Returns (render launches, s/frame,
            chunk error, (gradient launches), smallest gradient cosine)."""
            runner = Runner(fcfg, device="cuda", scene=scene)
            occ = runner.state.occ if fcfg.occ_grid else None
            num_pix = scene.height * scene.width
            n_chunks = math.ceil(num_pix / fcfg.render_chunk)
            expected = n_chunks * scene.images.shape[0]
            counts = lambda: (rk.render_fused.launches, rk.render_fused_bwd.launches,
                              mk.field_rays.launches, mk.field_rays_bwd.launches,
                              mk.field_flat.launches)
            rk.render_fused.launches = rk.render_fused_bwd.launches = 0
            mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = evallib.render_test_set(
                fcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
                runner.last_iter, save=False, occ_grid=occ)
            torch.cuda.synchronize()
            frame_s = (time.perf_counter() - t0) / frames.shape[0]
            launches = counts()
            print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} "
                  f"({fcfg.precision}, OCC_GRID {fcfg.occ_grid}, WHITE_BKGD {fcfg.white_bkgd}) "
                  f"from the iteration-{runner.last_iter} checkpoint with FUSED_RENDER: "
                  f"{frame_s:.3f} s/frame (unfused {unfused_s:.3f}); launches kernel 9 "
                  f"{launches[0]} (expected {expected} = {n_chunks} chunks x "
                  f"{frames.shape[0]} views), kernel 10 {launches[1]}, kernels 1, 2, 3 "
                  f"{launches[2:]} (expected none)")
            if launches != (expected, 0, 0, 0, 0):
                raise AssertionError("the fused render path did not run kernel 9 (and only "
                                     "it) once a chunk")
            if not (frames.shape == unfused.shape and np.all(np.isfinite(frames))
                    and frames.min() >= 0 and frames.max() <= 1):
                raise AssertionError("the fused frames are not finite values in [0, 1]")
            diff = np.abs(frames - unfused)
            print(f"frame mean {frames.mean():.4f}; against the unfused frames of the same "
                  f"checkpoint: max |diff| {diff.max():.3e}, mean {diff.mean():.3e}")

            span = slice((n_chunks // 2) * fcfg.render_chunk,
                         (n_chunks // 2 + 1) * fcfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            o, d, near, far = raylib.pixels_to_rays(rows, cols, pose, runner.k_inv)
            if occ is not None:
                near, far = occupancy.tighten_bounds(occ, o, d, near, far,
                                                     n_steps=fcfg.occ_march_steps)
            rays_in = (o, d, sampling.coarse_ts(near, far, fcfg.n_coarse), near, far)
            form = (fcfg.n_fine, fcfg.white_bkgd, fcfg.precision)
            with torch.no_grad():
                k_out = rk.render_fused(runner.params, *rays_in, *form)
                p_out = rk.render_fused_plain(runner.params, *rays_in, *form)
            err = max(float((a - b).abs().max()) for a, b in zip(k_out, p_out))
            print(f"real chunk (view 0, {int((near == far).sum())} of {rows.shape[0]} rays "
                  f"empty), kernel 9 vs render_fused_plain: max |err| {err:.3e} (atol {atol})")
            if not err <= atol:
                raise AssertionError("kernel 9 disagrees with its plain version on a real chunk")
            field_fn = evallib.make_field_fn(fcfg)
            args = (rows, cols, pose, runner.k_inv, fcfg.n_coarse, fcfg.n_fine)
            kw = dict(field_fn=field_fn, merge_impl="twolist", white_bkgd=fcfg.white_bkgd,
                      occ_grid=occ, occ_march=fcfg.occ_march_steps)
            with torch.no_grad():
                profile_calls(lambda: render.render_rays(runner.params, *args, **kw), 3, "chunks")

            # one gradient of the chunk's loss through the fused branch (the
            # JAX package's test_gradients_match_autodiff path): kernel 10
            leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), runner.params)
            target = torch.full((rows.shape[0], 3), 0.5, device=dev)
            rk.render_fused.launches = rk.render_fused_bwd.launches = 0
            mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
            c_co, c_fi = render.render_rays(leaves, *args, **kw)
            render.ray_loss(c_co, c_fi, target).backward()
            torch.cuda.synchronize()
            grad_launches = counts()
            g_out = (2 * (c_co.detach() - target), 2 * (c_fi.detach() - target))
            fine_ts = rk.render_fused_ts(runner.params, *rays_in, *form)[2]
            plain = rk.render_fused_bwd_plain(runner.params, *rays_in, *g_out, *form, fine_ts)
            got = optim.tree_map(lambda t: t.grad, leaves)
            ok, worst, rows = rk.grads_agree(got, plain, fcfg.precision)
            cos, ratios = rows[worst][0], [v[1] for v in rows.values()]
            print(f"one gradient of the chunk's loss through render_rays' fused branch: "
                  f"launches kernel 9, 10, 1, 2, 3 {grad_launches} (expected (1, 1, 0, 0, 0)); "
                  f"against the plain backward at kernel 9's fine t's: smallest cosine "
                  f"{cos:.8f} ({worst}), norm ratios {min(ratios):.6f}..{max(ratios):.6f}")
            if grad_launches != (1, 1, 0, 0, 0) or not ok:
                raise AssertionError("the fused branch's gradient did not run kernel 10 or "
                                     "disagrees with the plain version")
            del runner, leaves, got, plain, fine_ts
            return launches[0], frame_s, err, grad_launches[:2], cos

        # ---- 5. the training path ----
        phase("training path")
        scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=cfg.seed)
        runner = Runner(cfg, device="cuda", scene=scene)
        mk.field_rays.launches = mk.field_rays_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        train_launches = (mk.field_rays.launches, mk.field_rays_bwd.launches)
        print(f"Runner.train(): {TRAIN_STEPS} steps of {cfg.batch_ray} rays at "
              f"{cfg.n_coarse}+{cfg.n_fine} samples in {seconds:.2f} s "
              f"({seconds / TRAIN_STEPS * 1e3:.2f} ms/step, first steps included); "
              f"launches: forward {train_launches[0]}, backward {train_launches[1]} "
              f"(expected {2 * TRAIN_STEPS} each)")
        if train_launches != (2 * TRAIN_STEPS, 2 * TRAIN_STEPS):
            raise AssertionError("a training step did not run both kernels on both field calls")
        with open(runner.logger.path) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 "
              f"{last:.4f} (step 0 {losses[0]:.4f}, step {TRAIN_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the loss did not fall")

        # seconds per step and rays/s at BATCH_RAY 400 (lego) and 4096
        step_time = {}
        for batch, iters in ((cfg.batch_ray, 20), (4096, 6)):
            scfg = dataclasses.replace(cfg, batch_ray=batch)
            step = train.make_train_step(scfg, runner.train_table, runner.k_inv)
            state = runner.state
            for _ in range(2):
                state, _ = step(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                state, _ = step(state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / iters * 1e3
            shapes = ((batch, cfg.n_coarse), (batch, cfg.n_fine))
            kern = sum(fwd_time[s][0] + bwd_time[s][0] for s in shapes)
            step_time[batch] = (ms, kern)
            print(f"BATCH_RAY {batch}: {ms / 1e3:.5f} s/step, {batch / ms * 1e3:,.0f} rays/s; "
                  f"kernels {kern:.3f} ms of it ({100 * kern / ms:.1f}%: 2 forward + 2 "
                  "backward launches at their timed per-launch ms)")

        print(f"train-lego-{cfg.batch_ray} (fp32):")
        profile_steps(train.make_train_step(cfg, runner.train_table, runner.k_inv),
                      runner.state)

        # one step on a field with content: the kernels vs the plain field
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["sigma"]["b"] += 1.0
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(1),
                                          cfg.batch_ray)
        _, _, g_k = train.loss_and_grads(
            train.make_loss_fn(cfg, runner.k_inv), content, batch)
        _, _, g_p = train.loss_and_grads(
            train.make_loss_fn(cfg, runner.k_inv, render.field_plain), content, batch)
        a, b = flat_grads(g_k).double(), flat_grads(g_p).double()
        cos = float(a @ b / (a.norm() * b.norm()))
        print(f"one step, kernels vs plain field (sigma bias +1): gradient cosine "
              f"{cos:.7f} (limit {GRAD_COS}), norm ratio {float(a.norm() / b.norm()):.6f}")
        if not cos >= GRAD_COS:
            raise AssertionError("the kernels' training gradient disagrees with the plain field's")

        trained_iter = runner.state.iteration - 1
        path = ckpt.save_checkpoint(cfg.ckpt_path, "smoke", trained_iter, runner.params,
                                    runner.state.opt, generator=runner.state.generator)
        trained = runner.params
        print(f"saved the trained state (params, Adam moments, count "
              f"{runner.state.opt.count}) to {os.path.basename(path)}")
        del runner

        # ---- 6. the render path, from the trained checkpoint ----
        phase("render path")
        cfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=cfg.seed)
        runner = Runner(cfg, device="cuda", scene=scene)
        if runner.last_iter != trained_iter or not torch.equal(
                runner.params["trunk_3"]["w"], trained["trunk_3"]["w"]):
            raise AssertionError("Runner did not resume the trained checkpoint")
        num_pix = scene.height * scene.width
        n_chunks = math.ceil(num_pix / cfg.render_chunk)
        expected = 2 * n_chunks * scene.images.shape[0]

        mk.field_rays.launches = mk.field_rays_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            cfg, runner.params, runner.test_table, runner.k_inv,
            runner.start_time, runner.last_iter, save=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        render_launches = mk.field_rays.launches
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} "
              f"at {cfg.n_coarse}+{cfg.n_fine} samples from the iteration-{trained_iter} "
              f"checkpoint: {seconds / frames.shape[0]:.3f} s/frame; field_rays launches "
              f"{render_launches} (expected {expected} = 2 x {n_chunks} chunks x "
              f"{frames.shape[0]} views)")
        if render_launches != expected or mk.field_rays_bwd.launches != 0:
            raise AssertionError("the render path did not run the forward kernel (and "
                                 "only it) on every field call")
        if frames.shape != (2, scene.height, scene.width, 3):
            raise AssertionError(f"frames have shape {frames.shape}")
        if not (np.all(np.isfinite(frames)) and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("frames are not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        lego_view0 = frames[0].copy()   # phase 28b's one-rank view

        # one real chunk (the frame's middle), kernel field vs plain field
        with torch.no_grad():
            span = slice((n_chunks // 2) * cfg.render_chunk,
                         (n_chunks // 2 + 1) * cfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows = (idx // scene.width).float()
            cols = (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            o, d, near, far = raylib.pixels_to_rays(rows, cols, pose, runner.k_inv)
            ts = sampling.coarse_ts(near, far, cfg.n_coarse)
            _, _, _, ce, se = field_errors(mk.field_rays(runner.params, o, d, ts),
                                           mk.field_rays_plain(runner.params, o, d, ts))
            q = lambda e: float(torch.quantile(e, 0.999))
            print(f"real chunk (view 0, N={cfg.n_coarse}): |color err| max "
                  f"{float(ce.max()):.3e} p99.9 {q(ce):.3e}; |sigma err| max "
                  f"{float(se.max()):.3e} p99.9 {q(se):.3e}")
            args = (rows, cols, pose, runner.k_inv, cfg.n_coarse, cfg.n_fine)
            _, c_kernel = render.render_rays(runner.params, *args,
                                             field_fn=evallib.make_field_fn(cfg))
            _, c_plain = render.render_rays(runner.params, *args,
                                            field_fn=render.field_plain)
            pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk rendered through the kernel vs the plain field: "
                  f"max |pixel err| {pix_err:.3e} (atol {CHUNK_ATOL})")
            if not pix_err <= CHUNK_ATOL:
                raise AssertionError("kernel render disagrees with the plain render")
        del runner

        # ---- 6b. render-lego-fused-800: the same checkpoint with FUSED_RENDER ----
        phase("render-lego-fused-800 (FUSED_RENDER, kernel 9; one gradient through kernel 10)")
        fused_lego = fused_render_phase(dataclasses.replace(cfg, fused_render=True), scene,
                                        frames, seconds / frames.shape[0], CHUNK_ATOL)

        # ---- 7. the lego_occ training path ----
        phase("lego_occ training path (bf16, occupancy grid)")
        ocfg = load_config(os.path.join(ROOT, "conf", "lego_occ.ini"))
        ocfg.ckpt_path = os.path.join(tmp, "occ_ckpt")
        ocfg.results_path = os.path.join(tmp, "occ_results")
        ocfg.log_dir = os.path.join(tmp, "occ_runs")
        ocfg.continue_ = False
        ocfg.step = 10 * OCC_STEPS  # no preview JPG: imageio is not needed
        scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=ocfg.seed)
        runner = Runner(ocfg, device="cuda", scene=scene)
        subset = int(ocfg.occ_res ** 3 * ocfg.occ_subset)
        print(f"{ocfg.precision}, BATCH_RAY {ocfg.batch_ray}, {ocfg.n_coarse}+{ocfg.n_fine} "
              f"samples, OCC_RES {ocfg.occ_res} (refresh every {ocfg.occ_update_every} steps, "
              f"{subset} cells), OCC_MARCH_STEPS {ocfg.occ_march_steps} (derived), WHITE_BKGD "
              f"{ocfg.white_bkgd}")
        mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shares = []
        for end in (ocfg.occ_update_every, OCC_STEPS):  # read the grid after each refresh
            ocfg.total_iter = end
            runner.train()
            shares.append(grid_shares(runner.state.occ))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        occ_launches = (mk.field_rays.launches, mk.field_rays_bwd.launches,
                        mk.field_flat.launches)
        print(f"Runner.train(): {OCC_STEPS} steps of {ocfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / OCC_STEPS * 1e3:.2f} ms/step, first steps included); launches: "
              f"forward {occ_launches[0]}, backward {occ_launches[1]} (expected "
              f"{2 * OCC_STEPS} each), flat {occ_launches[2]} (expected 2)")
        if occ_launches != (2 * OCC_STEPS, 2 * OCC_STEPS, 2):
            raise AssertionError("the lego_occ path did not run the kernels as expected")
        for it, (probed, occupied) in zip((0, ocfg.occ_update_every), shares):
            print(f"grid after the refresh at iteration {it}: {100 * probed:.2f}% of cells "
                  f"probed, {100 * occupied:.2f}% occupied")
        with open(runner.logger.path) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        if len(losses) != OCC_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {OCC_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the lego_occ loss did not fall")

        # s/step and rays/s (no refresh in these iterations), and the refresh alone
        step = train.make_train_step(ocfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        occ_ms = (time.perf_counter() - t0) / 6 * 1e3
        occ_kern = sum(sum(bf16_train_time[s]) for s in OCC_SHAPES)
        print(f"BATCH_RAY {ocfg.batch_ray}: {occ_ms / 1e3:.5f} s/step, "
              f"{ocfg.batch_ray / occ_ms * 1e3:,.0f} rays/s; kernels {occ_kern:.3f} ms of it "
              f"({100 * occ_kern / occ_ms:.1f}%: 2 forward + 2 backward bf16 launches, the "
              "saving form and the backward from its residuals, at their timed per-launch ms)")
        field_fn = evallib.make_field_fn(ocfg)
        refresh = lambda: train.refresh_occ(ocfg, dataclasses.replace(state, iteration=0),
                                            field_fn)
        refresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            refresh()
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"one grid refresh ({subset} probes through kernel 3, the EMA, the dilation): "
              f"{refresh_ms:.3f} ms, {refresh_ms / ocfg.occ_update_every:.4f} ms per step "
              f"averaged over {ocfg.occ_update_every} steps")
        profile_steps(step, state)

        # one step on a field with content: the bf16 kernels vs the bf16 plain field
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["sigma"]["b"] += 1.0
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(2),
                                          ocfg.batch_ray)
        plain_bf16 = functools.partial(mk.field_flat_plain, precision="bf16")
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(ocfg, runner.k_inv), content,
                                         batch, None, runner.state.occ)
        _, _, g_p = train.loss_and_grads(train.make_loss_fn(ocfg, runner.k_inv, plain_bf16),
                                         content, batch, None, runner.state.occ)
        a, b = flat_grads(g_k).double(), flat_grads(g_p).double()
        cos = float(a @ b / (a.norm() * b.norm()))
        print(f"one bf16 step, kernels vs bf16 plain field (sigma bias +1): gradient cosine "
              f"{cos:.7f} (limit {BF16_COS}), norm ratio {float(a.norm() / b.norm()):.6f}")
        if not cos >= BF16_COS:
            raise AssertionError("the bf16 kernels' training gradient disagrees with the "
                                 "bf16 plain field's")
        occ_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(ocfg.ckpt_path, "smoke", occ_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator,
                             occ=runner.state.occ)
        trained_occ = runner.state.occ
        del runner, state, step

        # ---- 8. the lego_occ render path, from that checkpoint ----
        phase("lego_occ render path (bf16, occupancy grid)")
        ocfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=ocfg.seed)
        runner = Runner(ocfg, device="cuda", scene=scene)
        if runner.last_iter != occ_iter or not torch.equal(runner.state.occ.raw,
                                                          trained_occ.raw):
            raise AssertionError("Runner did not resume the lego_occ checkpoint and its grid")
        expected = 2 * n_chunks * scene.images.shape[0]
        mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            ocfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False, occ_grid=runner.state.occ)
        torch.cuda.synchronize()
        occ_frame_s = (time.perf_counter() - t0) / frames.shape[0]
        occ_render_launches = mk.field_rays.launches
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} with the grid "
              f"from the iteration-{occ_iter} checkpoint: {occ_frame_s:.3f} s/frame; field_rays "
              f"launches {occ_render_launches} (expected {expected}), flat "
              f"{mk.field_flat.launches}, backward {mk.field_rays_bwd.launches}")
        if (occ_render_launches, mk.field_flat.launches,
                mk.field_rays_bwd.launches) != (expected, 0, 0):
            raise AssertionError("the lego_occ render path did not run the bf16 forward "
                                 "kernel (and only it) on every field call")
        if not (frames.shape == (2, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
                and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the lego_occ frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((n_chunks // 2) * ocfg.render_chunk,
                         (n_chunks // 2 + 1) * ocfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (rows, cols, pose, runner.k_inv, ocfg.n_coarse, ocfg.n_fine)
            occ_kw = dict(white_bkgd=True, occ_grid=runner.state.occ,
                          occ_march=ocfg.occ_march_steps)
            _, c_kernel = render.render_rays(runner.params, *args,
                                             field_fn=evallib.make_field_fn(ocfg), **occ_kw)
            _, c_plain = render.render_rays(runner.params, *args, field_fn=plain_bf16, **occ_kw)
            occ_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk with the grid, bf16 kernels vs bf16 plain field: max |pixel "
                  f"err| {occ_pix_err:.3e}, mean {float((c_kernel - c_plain).abs().mean()):.3e} "
                  f"(atol {BF16_CHUNK_ATOL})")
            if not occ_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the bf16 kernel render disagrees with the bf16 plain render")
            o, d, near, far = raylib.pixels_to_rays(rows, cols, pose, runner.k_inv)
            march_ms = cuda_ms(lambda: occupancy.tighten_bounds(
                runner.state.occ, o, d, near, far, n_steps=ocfg.occ_march_steps), iters=20)
            n_near, n_far = occupancy.tighten_bounds(runner.state.occ, o, d, near, far,
                                                     n_steps=ocfg.occ_march_steps)
            print(f"the grid's march on one chunk ({ocfg.render_chunk} rays x "
                  f"{ocfg.occ_march_steps} probes): {march_ms:.3f} ms; mean ray span "
                  f"{float((n_far - n_near).mean()):.3f} of {float((far - near).mean()):.3f}")
            kernel_field = evallib.make_field_fn(ocfg)
            profile_calls(lambda: render.render_rays(runner.params, *args, field_fn=kernel_field,
                                                     merge_impl="twolist", **occ_kw),
                          5, "chunks")
        del runner

        # ---- 8b. render-lego_occ-fused-800: that checkpoint with FUSED_RENDER ----
        phase("render-lego_occ-fused-800 (FUSED_RENDER, bf16, occupancy grid, kernel 9; one "
              "gradient through kernel 10)")
        fused_occ = fused_render_phase(dataclasses.replace(ocfg, fused_render=True), scene,
                                       frames, occ_frame_s, BF16_CHUNK_ATOL)

        # ---- 9. lego_occ at fp32, cut to 10 steps ----
        phase("lego_occ at PRECISION=fp32, 10 steps (the fp32 form of kernel 3)")
        fcfg = load_config(os.path.join(ROOT, "conf", "lego_occ.ini"))
        fcfg.precision = "fp32"
        fcfg.ckpt_path = os.path.join(tmp, "fp32_ckpt")
        fcfg.results_path = os.path.join(tmp, "fp32_results")
        fcfg.log_dir = os.path.join(tmp, "fp32_runs")
        fcfg.continue_ = False
        fcfg.total_iter = OCC_FP32_STEPS
        fcfg.step = 10 * OCC_FP32_STEPS
        runner = Runner(fcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fcfg.seed))
        mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
        runner.train()
        torch.cuda.synchronize()
        fp32_launches = (mk.field_rays.launches, mk.field_rays_bwd.launches,
                         mk.field_flat.launches)
        with open(runner.logger.path) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        print(f"{OCC_FP32_STEPS} steps: launches forward {fp32_launches[0]}, backward "
              f"{fp32_launches[1]} (expected {2 * OCC_FP32_STEPS} each), flat "
              f"{fp32_launches[2]} (expected 1); losses {losses[0]:.2f} .. {losses[-1]:.2f}")
        if fp32_launches != (2 * OCC_FP32_STEPS, 2 * OCC_FP32_STEPS, 1):
            raise AssertionError("lego_occ at fp32 did not run the fp32 kernels as expected")
        if len(losses) != OCC_FP32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_occ at fp32: not every loss is finite")
        del runner

        def reset_counts():
            mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
            gk.grid_rays.launches = gk.grid_rays_bwd.launches = 0

        mlp_counts = lambda: (mk.field_rays.launches, mk.field_rays_bwd.launches,
                              mk.field_flat.launches)

        # ---- 10. the lego_grid training path, GRID_PALLAS ----
        phase("lego_grid training path (GRID_PALLAS: grid field and proposal grid, bf16, "
              "occupancy grid)")
        gcfg = run_config("lego_grid", tmp, "grid", GRID_STEPS, grid_pallas=True)
        runner = Runner(gcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=gcfg.seed))
        n_net, n_prop = (gridfield.num_params(runner.params[k]) for k in ("net", "prop"))
        print(f"{gcfg.precision}, BATCH_RAY {gcfg.batch_ray}, {gcfg.n_coarse}+{gcfg.n_fine} "
              f"samples; fine grid R={gcfg.grid_res}, {gcfg.grid_comp_density}+"
              f"{gcfg.grid_comp_app} components, decoder width {gcfg.grid_decoder_width} "
              f"({n_net:,} params); proposal grid R={gcfg.prop_grid_res}, "
              f"{gcfg.prop_grid_comp_density}+{gcfg.prop_grid_comp_app}, width "
              f"{gcfg.prop_grid_decoder_width} ({n_prop:,} params); GRID_LR_MULT "
              f"{gcfg.grid_lr_mult}, GRID_TV {gcfg.grid_tv}; OCC_RES {gcfg.occ_res}, "
              f"OCC_MARCH_STEPS {gcfg.occ_march_steps} (derived)")
        if (n_net, n_prop) != (110_084, 6_852):
            raise AssertionError("lego_grid's grids are not at full width")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid_shares_after = []
        for end in (gcfg.occ_update_every, GRID_STEPS):  # read the grid after each refresh
            gcfg.total_iter = end
            runner.train()
            grid_shares_after.append(grid_shares(runner.state.occ))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        grid_launches = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
        print(f"Runner.train(): {GRID_STEPS} steps of {gcfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / GRID_STEPS * 1e3:.2f} ms/step, first steps included); launches: "
              f"grid forward {grid_launches[0]}, backward {grid_launches[1]} (expected "
              f"{2 * GRID_STEPS} each); MLP kernels (forward, backward, flat) {mlp_counts()} "
              "(expected none: the refreshes run the plain point field)")
        if grid_launches != (2 * GRID_STEPS, 2 * GRID_STEPS) or any(mlp_counts()):
            raise AssertionError("the lego_grid path did not run kernels 5 and 6 as expected")
        for it, (probed, occupied) in zip((0, gcfg.occ_update_every), grid_shares_after):
            print(f"grid after the refresh at iteration {it}: {100 * probed:.2f}% of cells "
                  f"probed, {100 * occupied:.2f}% occupied")
        losses = logged_losses(runner)
        if len(losses) != GRID_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {GRID_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the lego_grid loss did not fall")

        step = train.make_train_step(gcfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        grid_ms = (time.perf_counter() - t0) / 6 * 1e3
        grid_kern = sum(grid_fwd_time["bf16"][s][0] + grid_bwd_time["bf16"][s][0]
                        for s in ((4096, 64), (4096, 128)))
        print(f"BATCH_RAY {gcfg.batch_ray}: {grid_ms / 1e3:.5f} s/step, "
              f"{gcfg.batch_ray / grid_ms * 1e3:,.0f} rays/s; kernels 5 and 6 {grid_kern:.3f} ms "
              f"of it ({100 * grid_kern / grid_ms:.1f}%: 2 forward + 2 backward bf16 launches at "
              "their timed per-launch ms)")
        profile_steps(step, state)

        # one step on grids with content: kernels 5 and 6 vs their plain versions
        content = {"net": scale_density(runner.params["net"], gcfg.grid_comp_density),
                   "prop": scale_density(runner.params["prop"], gcfg.prop_grid_comp_density)}
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(3),
                                          gcfg.batch_ray)
        ref_net, ref_prop = reference_grid_fields(gcfg)
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(gcfg, runner.k_inv), content,
                                         batch, None, runner.state.occ)
        _, _, g_p = train.loss_and_grads(train.make_loss_fn(gcfg, runner.k_inv, ref_net,
                                                            ref_prop),
                                         content, batch, None, runner.state.occ)
        grid_cos = grid_part_cosines(g_k, g_p)
        print("one bf16 step, kernels 5 and 6 vs their plain versions (density x3): gradient "
              "cosines " + ", ".join(f"{k} {v:.7f}" for k, v in grid_cos.items())
              + f" (limit {BF16_COS})")
        if min(grid_cos.values()) < BF16_COS:
            raise AssertionError("the grid kernels' training gradient disagrees with the "
                                 "plain versions'")
        grid_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(gcfg.ckpt_path, "smoke", grid_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator,
                             occ=runner.state.occ)
        trained_grid_occ = runner.state.occ
        del runner, state, step, g_k, g_p, content

        # ---- 11. the lego_grid render path, from that checkpoint ----
        phase("lego_grid render path (GRID_PALLAS, occupancy grid)")
        gcfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=gcfg.seed)
        runner = Runner(gcfg, device="cuda", scene=scene)
        if runner.last_iter != grid_iter or not torch.equal(runner.state.occ.raw,
                                                           trained_grid_occ.raw):
            raise AssertionError("Runner did not resume the lego_grid checkpoint and its grid")
        expected = 2 * n_chunks * scene.images.shape[0]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            gcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False, occ_grid=runner.state.occ)
        torch.cuda.synchronize()
        grid_frame_s = (time.perf_counter() - t0) / frames.shape[0]
        grid_render_launches = gk.grid_rays.launches
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} with the grid "
              f"from the iteration-{grid_iter} checkpoint: {grid_frame_s:.3f} s/frame; grid "
              f"forward launches {grid_render_launches} (expected {expected} = 2 x {n_chunks} "
              f"chunks x {frames.shape[0]} views), backward {gk.grid_rays_bwd.launches}, MLP "
              f"{mlp_counts()}")
        if (grid_render_launches, gk.grid_rays_bwd.launches, *mlp_counts()) != (expected, 0, 0, 0, 0):
            raise AssertionError("the lego_grid render path did not run kernel 5 (and only it) "
                                 "on every field call")
        if not (frames.shape == (2, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
                and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the lego_grid frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((n_chunks // 2) * gcfg.render_chunk,
                         (n_chunks // 2 + 1) * gcfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (rows, cols, pose, runner.k_inv, gcfg.n_coarse, gcfg.n_fine)
            kw = dict(white_bkgd=True, occ_grid=runner.state.occ,
                      occ_march=gcfg.occ_march_steps, prop_params=runner.params["prop"])
            kern_net, kern_prop = evallib.make_field_fn(gcfg), evallib.make_prop_field_fn(gcfg)
            _, c_kernel = render.render_rays(runner.params["net"], *args, field_fn=kern_net,
                                             prop_field_fn=kern_prop, **kw)
            _, c_plain = render.render_rays(runner.params["net"], *args, field_fn=ref_net,
                                            prop_field_fn=ref_prop, **kw)
            grid_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk with the grid, kernels 5 and 6 vs their plain versions (bf16): "
                  f"max |pixel err| {grid_pix_err:.3e}, mean "
                  f"{float((c_kernel - c_plain).abs().mean()):.3e} (atol {BF16_CHUNK_ATOL})")
            if not grid_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the grid kernels' render disagrees with the plain render")
            profile_calls(lambda: render.render_rays(runner.params["net"], *args,
                                                     field_fn=kern_net, prop_field_fn=kern_prop,
                                                     merge_impl="twolist", **kw),
                          5, "chunks")
        del runner

        # ---- 12. lego_grid at fp32, and lego_fast with GRID_PALLAS ----
        phase("lego_grid at PRECISION=fp32, 10 steps (the fp32 forms of kernels 5 and 6)")
        fgcfg = run_config("lego_grid", tmp, "grid_fp32", GRID_FP32_STEPS, grid_pallas=True,
                           precision="fp32")
        runner = Runner(fgcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fgcfg.seed))
        reset_counts()
        runner.train()
        torch.cuda.synchronize()
        grid_fp32_launches = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
        losses = logged_losses(runner)
        print(f"{GRID_FP32_STEPS} steps: grid launches forward {grid_fp32_launches[0]}, backward "
              f"{grid_fp32_launches[1]} (expected {2 * GRID_FP32_STEPS} each), MLP "
              f"{mlp_counts()}; losses {losses[0]:.2f} .. {losses[-1]:.2f}")
        if grid_fp32_launches != (2 * GRID_FP32_STEPS,) * 2 or any(mlp_counts()):
            raise AssertionError("lego_grid at fp32 did not run the fp32 grid kernels as expected")
        if len(losses) != GRID_FP32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_grid at fp32: not every loss is finite")
        del runner

        phase("lego_fast with GRID_PALLAS, 10 steps (MLP fine field, proposal grid)")
        fast = run_config("lego_fast", tmp, "fast", FAST_STEPS, grid_pallas=True)
        runner = Runner(fast, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fast.seed))
        reset_counts()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        fast_launches = (*mlp_counts(), gk.grid_rays.launches, gk.grid_rays_bwd.launches)
        losses = logged_losses(runner)
        print(f"{fast.precision}, {fast.n_coarse}+{fast.n_fine} samples, {FAST_STEPS} steps in "
              f"{fast_s:.2f} s: launches MLP forward {fast_launches[0]}, backward "
              f"{fast_launches[1]}, flat {fast_launches[2]}; grid forward {fast_launches[3]}, "
              f"backward {fast_launches[4]} (expected {FAST_STEPS} each, 1 flat for the refresh "
              f"at 0); losses {losses[0]:.2f} .. {losses[-1]:.2f}")
        if fast_launches != (FAST_STEPS, FAST_STEPS, 1, FAST_STEPS, FAST_STEPS):
            raise AssertionError("lego_fast did not run kernels 1-3, 5 and 6 as expected")
        if len(losses) != FAST_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_fast: not every loss is finite")
        del runner

        # ---- 12b. the flagship, conf/lego_hybrid.ini, and its pyramids ----
        flagship = flagship_phases(tmp, "cuda")

        # ---- 12c-12d. GRID_UPSAMPLE, HOST_FEED, VAL_METRICS, PROFILE_STEPS ----
        options = option_phases(tmp, "cuda")
        opt_paths = options.pop("launches")
        up, feed = opt_paths["upsample"], opt_paths["hostfeed"]

        prop_counts = lambda: (pk.prop_rays.launches, pk.prop_rays_bwd.launches)

        def reset_all():
            reset_counts()
            pk.prop_rays.launches = pk.prop_rays_bwd.launches = 0

        # ---- 13. the lego_prop training path, PROP_FIELD = mlp and PROP_PALLAS ----
        phase("lego_prop training path (PROP_FIELD = mlp, PROP_PALLAS, bf16)")
        pcfg = run_config("lego_prop", tmp, "prop", PROP_STEPS, prop_field="mlp",
                          prop_pallas=True)
        runner = Runner(pcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=pcfg.seed))
        n_net = mlp.num_params(runner.params["net"])
        n_prop_net = mlp.num_params(runner.params["prop"])
        print(f"{pcfg.precision}, BATCH_RAY {pcfg.batch_ray}, {pcfg.n_coarse}+{pcfg.n_fine} "
              f"samples, USE_PALLAS {pcfg.use_pallas}; net 8x256 ({n_net:,} params); proposal "
              f"MLP {pcfg.proposal_width}x{pcfg.proposal_depth}, PROPOSAL_ENC_L "
              f"{pcfg.proposal_enc_l} ({n_prop_net:,} params); OCC_GRID {pcfg.occ_grid}, "
              f"WHITE_BKGD {pcfg.white_bkgd}")
        if (n_net, n_prop_net) != (593_924, 57_932):
            raise AssertionError("lego_prop's fields are not at full width")
        reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prop_launches = prop_counts()
        prop_mlp_launches = mlp_counts()
        print(f"Runner.train(): {PROP_STEPS} steps of {pcfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / PROP_STEPS * 1e3:.2f} ms/step, first steps included); launches: "
              f"proposal forward {prop_launches[0]}, backward {prop_launches[1]}; field forward "
              f"{prop_mlp_launches[0]}, backward {prop_mlp_launches[1]}, flat "
              f"{prop_mlp_launches[2]} (expected {PROP_STEPS} of each but flat, 0 flat); grid "
              f"{(gk.grid_rays.launches, gk.grid_rays_bwd.launches)}")
        if (prop_launches + prop_mlp_launches != (PROP_STEPS,) * 4 + (0,)
                or gk.grid_rays.launches or gk.grid_rays_bwd.launches):
            raise AssertionError("the lego_prop path did not run kernels 1, 2, 7 and 8 "
                                 "once each a step")
        losses = logged_losses(runner)
        if len(losses) != PROP_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {PROP_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the lego_prop loss did not fall")

        step = train.make_train_step(pcfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        prop_ms = (time.perf_counter() - t0) / 6 * 1e3
        prop_kern = (sum(bf16_train_time[4096, pcfg.n_fine])
                     + prop_fwd_time["bf16"][PROP_SHAPE][0] + prop_bwd_time["bf16"][PROP_SHAPE][0])
        print(f"BATCH_RAY {pcfg.batch_ray}: {prop_ms / 1e3:.5f} s/step, "
              f"{pcfg.batch_ray / prop_ms * 1e3:,.0f} rays/s; kernels 1, 2, 7 and 8 "
              f"{prop_kern:.3f} ms of it ({100 * prop_kern / prop_ms:.1f}%: one launch of each "
              "at its timed bf16 per-launch ms)")
        profile_steps(step, state)

        # one step on fields with content: kernels 1, 2, 7, 8 vs their plain versions
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["net"]["sigma"]["b"] += 1.0
        content["prop"]["sigma"]["b"] += 1.0
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(4),
                                          pcfg.batch_ray)
        plain_bf16 = functools.partial(mk.field_flat_plain, precision=pcfg.precision)
        ref_prop = reference_prop_field(pcfg.precision)
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(pcfg, runner.k_inv), content, batch)
        _, _, g_p = train.loss_and_grads(train.make_loss_fn(pcfg, runner.k_inv, plain_bf16,
                                                            ref_prop), content, batch)
        prop_cos = part_cosines(g_k, g_p)
        print("one bf16 step, kernels 1, 2, 7 and 8 vs their plain versions (sigma biases +1): "
              "gradient cosines " + ", ".join(f"{k} {v:.7f}" for k, v in prop_cos.items())
              + f" (limit {BF16_COS})")
        if min(prop_cos.values()) < BF16_COS:
            raise AssertionError("the lego_prop kernels' training gradient disagrees with the "
                                 "plain versions'")
        prop_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(pcfg.ckpt_path, "smoke", prop_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator)
        trained_prop = runner.params["prop"]["trunk_1"]["w"]
        del runner, state, step, g_k, g_p, content

        # ---- 14. the lego_prop render path, from that checkpoint ----
        phase("lego_prop render path (PROP_FIELD = mlp, PROP_PALLAS)")
        pcfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=pcfg.seed)
        runner = Runner(pcfg, device="cuda", scene=scene)
        if runner.last_iter != prop_iter or not torch.equal(
                runner.params["prop"]["trunk_1"]["w"], trained_prop):
            raise AssertionError("Runner did not resume the lego_prop checkpoint")
        expected = n_chunks * scene.images.shape[0]
        reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            pcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False)
        torch.cuda.synchronize()
        prop_frame_s = (time.perf_counter() - t0) / frames.shape[0]
        prop_render_launches = prop_counts()[0]
        prop_render_field = mlp_counts()[0]
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} from the "
              f"iteration-{prop_iter} checkpoint: {prop_frame_s:.3f} s/frame; proposal forward "
              f"launches {prop_render_launches}, field forward {prop_render_field} (expected "
              f"{expected} each = {n_chunks} chunks x {frames.shape[0]} views); backward "
              f"{prop_counts()[1]}, {mlp_counts()[1]}")
        if (prop_counts(), mlp_counts()) != ((expected, 0), (expected, 0, 0)):
            raise AssertionError("the lego_prop render path did not run kernels 7 and 1 (and "
                                 "only them) on every chunk")
        if not (frames.shape == (2, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
                and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the lego_prop frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((n_chunks // 2) * pcfg.render_chunk,
                         (n_chunks // 2 + 1) * pcfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (rows, cols, pose, runner.k_inv, pcfg.n_coarse, pcfg.n_fine)
            kw = dict(prop_params=runner.params["prop"])
            kern_net, kern_prop = evallib.make_field_fn(pcfg), evallib.make_prop_field_fn(pcfg)
            _, c_kernel = render.render_rays(runner.params["net"], *args, field_fn=kern_net,
                                             prop_field_fn=kern_prop, **kw)
            _, c_plain = render.render_rays(runner.params["net"], *args, field_fn=plain_bf16,
                                            prop_field_fn=ref_prop, **kw)
            prop_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk, kernels 1 and 7 vs their plain versions (bf16): max |pixel err| "
                  f"{prop_pix_err:.3e}, mean {float((c_kernel - c_plain).abs().mean()):.3e} "
                  f"(atol {BF16_CHUNK_ATOL})")
            if not prop_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the lego_prop kernels' render disagrees with the plain "
                                     "render")
            profile_calls(lambda: render.render_rays(runner.params["net"], *args,
                                                     field_fn=kern_net, prop_field_fn=kern_prop,
                                                     **kw), 5, "chunks")
        del runner

        # ---- 15. lego_prop at fp32, 10 steps ----
        phase("lego_prop at PRECISION=fp32, 10 steps (the fp32 forms of kernels 7 and 8)")
        fpcfg = run_config("lego_prop", tmp, "prop_fp32", PROP_FP32_STEPS, prop_field="mlp",
                           prop_pallas=True, precision="fp32")
        runner = Runner(fpcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fpcfg.seed))
        reset_all()
        runner.train()
        torch.cuda.synchronize()
        prop_fp32_launches = prop_counts()
        prop_fp32_field = mlp_counts()
        losses = logged_losses(runner)
        print(f"{PROP_FP32_STEPS} steps: proposal launches forward {prop_fp32_launches[0]}, "
              f"backward {prop_fp32_launches[1]}; field forward {prop_fp32_field[0]}, backward "
              f"{prop_fp32_field[1]} (expected {PROP_FP32_STEPS} each); losses {losses[0]:.2f} "
              f".. {losses[-1]:.2f}")
        if prop_fp32_launches + prop_fp32_field != (PROP_FP32_STEPS,) * 4 + (0,):
            raise AssertionError("lego_prop at fp32 did not run the fp32 kernels as expected")
        if len(losses) != PROP_FP32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_prop at fp32: not every loss is finite")
        step = train.make_train_step(fpcfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        prop_fp32_ms = (time.perf_counter() - t0) / 6 * 1e3
        prop_fp32_kern = (fwd_time[4096, fpcfg.n_fine][0] + bwd_time[4096, fpcfg.n_fine][0]
                          + prop_fwd_time["fp32"][PROP_SHAPE][0]
                          + prop_bwd_time["fp32"][PROP_SHAPE][0])
        print(f"BATCH_RAY {fpcfg.batch_ray}: {prop_fp32_ms / 1e3:.5f} s/step, "
              f"{fpcfg.batch_ray / prop_fp32_ms * 1e3:,.0f} rays/s; kernels 1, 2, 7 and 8 "
              f"{prop_fp32_kern:.3f} ms of it ({100 * prop_fp32_kern / prop_fp32_ms:.1f}%: one "
              "launch of each at its timed fp32 per-launch ms)")
        del runner, state, step

        # ---- 16. unbounded360-mlp: conf/unbounded360.ini with FINE_FIELD = mlp ----
        phase("unbounded360-mlp training path (CONTRACT, LINDISP, the proposal grid, "
              "DIST_LOSS, PROP_INTERLEVEL, bf16: kernels 3 and 4)")
        from tinynerf_torch.core import contract

        def reset_slice7():
            reset_all()
            mk.field_flat_bwd.launches = 0
            rk.render_fused.launches = rk.render_fused_bwd.launches = 0

        def counts7():
            return {"flat": mk.field_flat.launches, "flat_bwd": mk.field_flat_bwd.launches,
                    "rays": mk.field_rays.launches, "rays_bwd": mk.field_rays_bwd.launches,
                    "grid": gk.grid_rays.launches + gk.grid_rays_bwd.launches,
                    "prop": pk.prop_rays.launches, "prop_bwd": pk.prop_rays_bwd.launches,
                    "fused": rk.render_fused.launches, "fused_bwd": rk.render_fused_bwd.launches}

        def only(**launches):
            return {**{k: 0 for k in counts7()}, **launches}

        def plain_contracted(precision):
            """The MLP's plain field under the contraction: what a step or a
            chunk through kernels 3 and 4 is held against."""
            return contract.wrap_field_contract(
                functools.partial(mk.field_flat_plain, precision=precision))

        ucfg = run_config("unbounded360", tmp, "u360", U360_STEPS, fine_field="mlp")
        u_scene = llff_capture(U360_VIEWS, ucfg.seed, outward=True)
        runner = Runner(ucfg, device="cuda", scene=u_scene)
        n_net = mlp.num_params(runner.params["net"])
        print(f"{ucfg.precision}, BATCH_RAY {ucfg.batch_ray}, {ucfg.n_coarse}+{ucfg.n_fine} "
              f"samples, CONTRACT {ucfg.contract}, LINDISP {ucfg.lindisp}, STRATIFIED "
              f"{ucfg.stratified}, DIST_LOSS {ucfg.dist_loss}, PROP_INTERLEVEL "
              f"{ucfg.prop_interlevel}; net 8x256 ({n_net:,} params), proposal grid R="
              f"{ucfg.prop_grid_res} {ucfg.prop_grid_comp_density}+{ucfg.prop_grid_comp_app} "
              f"width {ucfg.prop_grid_decoder_width}; {U360_VIEWS} views of "
              f"{u_scene.height}x{u_scene.width}, bounds {u_scene.poses_bounds[:, 15].min():.2f}"
              f" / {u_scene.poses_bounds[:, 16].max():.1f}")
        if n_net != 593_924 or not (ucfg.contract and ucfg.lindisp and ucfg.dist_loss > 0
                                    and ucfg.prop_interlevel > 0):
            raise AssertionError("unbounded360-mlp is not at full width with its stack")
        reset_slice7()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        u_launches = counts7()
        print(f"Runner.train(): {U360_STEPS} steps of {ucfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / U360_STEPS * 1e3:.2f} ms/step, first steps included); launches "
              f"{u_launches} (expected kernels 3 and 4 once a step, nothing else)")
        if u_launches != only(flat=U360_STEPS, flat_bwd=U360_STEPS):
            raise AssertionError("the unbounded360-mlp path did not run kernels 3 and 4 (and "
                                 "only them) once a step")
        losses = logged_losses(runner)
        if len(losses) != U360_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {U360_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the unbounded360-mlp loss did not fall")

        step = train.make_train_step(ucfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        u360_ms = (time.perf_counter() - t0) / 6 * 1e3
        rows_u = ucfg.batch_ray * ucfg.n_fine  # FLAT_BWD_ROWS[0], where both were timed
        u360_kern = flat_time[rows_u, "bf16"][0] + flat_bwd_time[rows_u, "bf16"][0]
        print(f"BATCH_RAY {ucfg.batch_ray}: {u360_ms / 1e3:.5f} s/step, "
              f"{ucfg.batch_ray / u360_ms * 1e3:,.0f} rays/s; kernels 3 and 4 {u360_kern:.3f} "
              f"ms of it ({100 * u360_kern / u360_ms:.1f}%: one launch of each at its timed "
              f"bf16 per-launch ms at R={rows_u})")
        profile_steps(step, state)

        # one step on fields with content: kernels 3 and 4 vs the plain field
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["net"]["sigma"]["b"] += 1.0
        content["prop"] = scale_density(content["prop"], ucfg.prop_grid_comp_density)
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(5),
                                          ucfg.batch_ray)
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(ucfg, runner.k_inv), content, batch)
        _, _, g_p = train.loss_and_grads(
            train.make_loss_fn(ucfg, runner.k_inv, plain_contracted(ucfg.precision)), content,
            batch)
        u360_cos = part_cosines(g_k, g_p)
        print("one bf16 step, kernels 3 and 4 vs the plain field (sigma bias +1, the proposal "
              "grid's density x3): gradient cosines "
              + ", ".join(f"{k} {v:.7f}" for k, v in u360_cos.items()) + f" (limit {BF16_COS})")
        if min(u360_cos.values()) < BF16_COS:
            raise AssertionError("the unbounded360-mlp kernels' training gradient disagrees "
                                 "with the plain field's")
        u360_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(ucfg.ckpt_path, "smoke", u360_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator)
        trained_u360 = runner.params["net"]["trunk_1"]["w"]
        del runner, state, step, g_k, g_p, content

        # ---- 17. the unbounded360-mlp render path, from that checkpoint ----
        phase("unbounded360-mlp render path (kernel 3)")
        ucfg.continue_ = True
        runner = Runner(ucfg, device="cuda", scene=u_scene)
        if runner.last_iter != u360_iter or not torch.equal(
                runner.params["net"]["trunk_1"]["w"], trained_u360):
            raise AssertionError("Runner did not resume the unbounded360-mlp checkpoint")
        u_pix = u_scene.height * u_scene.width
        u_chunks = math.ceil(u_pix / ucfg.render_chunk)
        reset_slice7()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(ucfg, runner.params, runner.test_table, runner.k_inv,
                                         runner.start_time, runner.last_iter, save=False,
                                         max_views=1)
        torch.cuda.synchronize()
        u360_frame_s = time.perf_counter() - t0
        u_render = counts7()
        print(f"rendered 1 view of {u_scene.height}x{u_scene.width} from the iteration-"
              f"{u360_iter} checkpoint: {u360_frame_s:.3f} s/frame; launches {u_render} "
              f"(expected kernel 3 once a chunk, {u_chunks} chunks)")
        if u_render != only(flat=u_chunks):
            raise AssertionError("the unbounded360-mlp render path did not run kernel 3 (and "
                                 "only it) once a chunk")
        if not (frames.shape == (1, u_scene.height, u_scene.width, 3)
                and np.all(np.isfinite(frames)) and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the unbounded360-mlp frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((u_chunks // 2) * ucfg.render_chunk,
                         (u_chunks // 2 + 1) * ucfg.render_chunk)
            idx = torch.arange(u_pix, device=dev)[span]
            rows, cols = (idx // u_scene.width).float(), (idx % u_scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (runner.params["net"], rows, cols, pose, runner.k_inv, ucfg.n_coarse,
                    ucfg.n_fine)
            kw = dict(prop_params=runner.params["prop"],
                      prop_field_fn=evallib.make_prop_field_fn(ucfg), lindisp=ucfg.lindisp)
            kern_u = evallib.make_field_fn(ucfg)
            _, c_kernel = render.render_rays(*args, field_fn=kern_u, **kw)
            _, c_plain = render.render_rays(*args, field_fn=plain_contracted(ucfg.precision),
                                            **kw)
            u360_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk, kernel 3 vs the plain field (bf16): max |pixel err| "
                  f"{u360_pix_err:.3e}, mean {float((c_kernel - c_plain).abs().mean()):.3e} "
                  f"(atol {BF16_CHUNK_ATOL})")
            if not u360_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the unbounded360-mlp render disagrees with the plain "
                                     "render")
            profile_calls(lambda: render.render_rays(*args, field_fn=kern_u, **kw), 5, "chunks")
        del runner

        # ---- 18. unbounded360-mlp with the contracted occupancy grid, 10 steps ----
        phase("unbounded360-mlp with the contracted occupancy grid (conf/synthetic360.ini's "
              "block), 10 steps")
        gcfg7 = run_config("unbounded360", tmp, "u360_occ", U360_SHORT_STEPS, fine_field="mlp",
                           occ_grid=True, occ_res=64, occ_march_res=16, occ_march_steps=32,
                           occ_update_every=256, occ_subset=0.125)
        runner = Runner(gcfg7, device="cuda", scene=u_scene)
        reset_slice7()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        u_occ_s = time.perf_counter() - t0
        u_occ = counts7()
        probes = int(gcfg7.occ_res ** 3 * gcfg7.occ_subset)
        u_occ_shares = grid_shares(runner.state.occ)
        losses = logged_losses(runner)
        print(f"OCC_EXTENT {gcfg7.occ_extent}, OCC_RES {gcfg7.occ_res}, OCC_MARCH_RES "
              f"{gcfg7.occ_march_res}, OCC_MARCH_STEPS {gcfg7.occ_march_steps}; "
              f"{U360_SHORT_STEPS} steps in {u_occ_s:.2f} s; launches {u_occ} (expected kernel 3 "
              f"{U360_SHORT_STEPS} + 1, the refresh at 0 through it with {probes} probes; kernel "
              f"4 {U360_SHORT_STEPS}); grid after the refresh: {100 * u_occ_shares[0]:.2f}% of "
              f"cells probed, {100 * u_occ_shares[1]:.2f}% occupied; losses {losses[0]:.2f} .. "
              f"{losses[-1]:.2f}")
        if (gcfg7.occ_extent != 2.0
                or u_occ != only(flat=U360_SHORT_STEPS + 1, flat_bwd=U360_SHORT_STEPS)):
            raise AssertionError("the contracted grid did not run as expected")
        if len(losses) != U360_SHORT_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("unbounded360-mlp with the grid: not every loss is finite")
        del runner

        # ---- 19. unbounded360-mlp with PROP_FIELD = mlp and PROP_PALLAS, 10 steps ----
        phase("unbounded360-mlp with PROP_FIELD = mlp and PROP_PALLAS, 10 steps (prop_flat: "
              "kernels 7 and 8 at N = 1)")
        pcfg7 = run_config("unbounded360", tmp, "u360_prop", U360_SHORT_STEPS, fine_field="mlp",
                           prop_field="mlp", prop_pallas=True)
        runner = Runner(pcfg7, device="cuda", scene=u_scene)
        reset_slice7()
        runner.train()
        torch.cuda.synchronize()
        u_prop = counts7()
        losses = logged_losses(runner)
        print(f"proposal MLP {pcfg7.proposal_width}x{pcfg7.proposal_depth}; launches {u_prop} "
              f"(expected kernels 3, 4, 7 and 8 {U360_SHORT_STEPS} each); losses "
              f"{losses[0]:.2f} .. {losses[-1]:.2f}")
        if u_prop != only(flat=U360_SHORT_STEPS, flat_bwd=U360_SHORT_STEPS,
                          prop=U360_SHORT_STEPS, prop_bwd=U360_SHORT_STEPS):
            raise AssertionError("unbounded360-mlp with the proposal MLP did not run prop_flat")
        if len(losses) != U360_SHORT_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("unbounded360-mlp with the proposal MLP: not every loss is "
                                 "finite")
        del runner

        # ---- 20. unbounded360-mlp at fp32, 10 steps ----
        phase("unbounded360-mlp at PRECISION=fp32, 10 steps (the fp32 forms of kernels 3 and 4)")
        fcfg7 = run_config("unbounded360", tmp, "u360_fp32", U360_SHORT_STEPS, fine_field="mlp",
                           precision="fp32")
        runner = Runner(fcfg7, device="cuda", scene=u_scene)
        reset_slice7()
        runner.train()
        torch.cuda.synchronize()
        u_fp32 = counts7()
        losses = logged_losses(runner)
        print(f"launches {u_fp32} (expected kernels 3 and 4 {U360_SHORT_STEPS} each); losses "
              f"{losses[0]:.2f} .. {losses[-1]:.2f}")
        if u_fp32 != only(flat=U360_SHORT_STEPS, flat_bwd=U360_SHORT_STEPS):
            raise AssertionError("unbounded360-mlp at fp32 did not run kernels 3 and 4")
        if len(losses) != U360_SHORT_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("unbounded360-mlp at fp32: not every loss is finite")
        del runner, u_scene

        # ---- 21. conf/fern_ndc.ini: NDC, bf16, u8 pixels ----
        phase("fern_ndc training path (NDC, bf16: kernels 1 and 2)")
        ncfg = run_config("fern_ndc", tmp, "fern", FERN_STEPS)
        f_scene = llff_capture(FERN_VIEWS, ncfg.seed, outward=False)
        runner = Runner(ncfg, device="cuda", scene=f_scene)
        print(f"{ncfg.precision}, BATCH_RAY {ncfg.batch_ray}, {ncfg.n_coarse}+{ncfg.n_fine} "
              f"samples, PIXEL_DTYPE {ncfg.pixel_dtype}; ndc_params {runner.ndc_params}; "
              f"{FERN_VIEWS} views of {f_scene.height}x{f_scene.width}; recentred bounds "
              f"{float(runner.train_table.poses[:, 15].min()):.3f} / "
              f"{float(runner.train_table.poses[:, 16].max()):.3f}")
        if runner.ndc_params is None:
            raise AssertionError("the fern_ndc Runner did not set ndc_params")
        reset_slice7()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fern_launches = counts7()
        print(f"Runner.train(): {FERN_STEPS} steps in {seconds:.2f} s; launches {fern_launches} "
              f"(expected kernels 1 and 2 twice a step)")
        if fern_launches != only(rays=2 * FERN_STEPS, rays_bwd=2 * FERN_STEPS):
            raise AssertionError("the fern_ndc path did not run kernels 1 and 2 twice a step")
        losses = logged_losses(runner)
        if len(losses) != FERN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss: mean of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
        if not last < first:
            raise AssertionError("the fern_ndc loss did not fall")
        step = train.make_train_step(ncfg, runner.train_table, runner.k_inv,
                                     ndc_params=runner.ndc_params)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        fern_ms = (time.perf_counter() - t0) / 6 * 1e3
        print(f"BATCH_RAY {ncfg.batch_ray}: {fern_ms / 1e3:.5f} s/step, "
              f"{ncfg.batch_ray / fern_ms * 1e3:,.0f} rays/s (the device table); host-fed "
              f"(phase 12d, {options['fern_ndc_hostfeed']['host_table_bytes'] / 2 ** 20:.1f} "
              f"MiB host table): {options['fern_ndc_hostfeed']['step_ms'] / 1e3:.5f} s/step")
        fern_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(ncfg.ckpt_path, "smoke", fern_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator)
        del runner, state, step

        # ---- 22. the fern_ndc render path: unfused, then FUSED_RENDER (kernel 9) ----
        phase("fern_ndc render path (NDC; unfused: kernel 1; FUSED_RENDER: kernel 9)")
        ncfg.continue_ = True
        runner = Runner(ncfg, device="cuda", scene=f_scene)
        if runner.last_iter != fern_iter:
            raise AssertionError("Runner did not resume the fern_ndc checkpoint")
        f_chunks = math.ceil(f_scene.height * f_scene.width / ncfg.render_chunk)
        fern_frames, fern_frame_s, fern_render = {}, {}, {}
        for fused in (False, True):
            rcfg = dataclasses.replace(ncfg, fused_render=fused)
            reset_slice7()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fern_frames[fused] = evallib.render_test_set(
                rcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
                runner.last_iter, save=False, max_views=1, ndc_params=runner.ndc_params)
            torch.cuda.synchronize()
            fern_frame_s[fused] = time.perf_counter() - t0
            fern_render[fused] = counts7()
            frames = fern_frames[fused]
            print(f"FUSED_RENDER {fused}: 1 view of {f_scene.height}x{f_scene.width} in "
                  f"{fern_frame_s[fused]:.3f} s; launches {fern_render[fused]}; frame mean "
                  f"{frames.mean():.4f}")
            want = only(fused=f_chunks) if fused else only(rays=2 * f_chunks)
            if fern_render[fused] != want:
                raise AssertionError(f"the fern_ndc render (FUSED_RENDER {fused}) did not run "
                                     "its kernel once a chunk")
            if not (np.all(np.isfinite(frames)) and frames.min() >= 0 and frames.max() <= 1):
                raise AssertionError("the fern_ndc frame is not finite values in [0, 1]")
        fern_diff = float(np.abs(fern_frames[True] - fern_frames[False]).max())
        print(f"fused against unfused frame: max |diff| {fern_diff:.3e} (limit "
              f"{BF16_CHUNK_ATOL})")
        if not fern_diff <= BF16_CHUNK_ATOL:
            raise AssertionError("the fused NDC frame disagrees with the unfused one")
        del runner, f_scene

        # ---- 23-27. lego_coarse, unbounded360 as shipped, synthetic360, the
        # legacy field, the render service ----
        shipped = shipped_phases(tmp, "cuda", ocfg)

        # ---- 28, 28b. two ranks: lego_occ data-parallel, lego sample-sharded ----
        parallel = parallel_phases(tmp, cfg.ckpt_path, lego_view0, "cuda")

        # ---- 29. the validate protocol from files on disk ----
        validate = validate_phase(tmp, "cuda")

        # ---- 30. the CUDA graphs: chunks of steps, frames, the CLI ----
        graphed = graph_phases(tmp)

        # ---- 31. phase 30 under a mesh of NCCL ranks (two cards or more) ----
        meshed = mesh_phases(tmp)

        # ---- 32. the gather lookup and the reference state-dict bridge ----
        gathered = gather_phases(tmp)

    # ---- 33. results ----
    mean = lambda table, shapes, i: sum(table[s][i] for s in shapes) / len(shapes)
    shape_key = lambda s: (f"B={s[0]},N={s[1]}" if len(s) == 2 else f"R={s[0]}" if len(s) == 1
                           else f"B={s[0]},N_c={s[1]},N_f={s[2]}")
    render_shapes = [(4096, 64), (4096, 128)]
    times = lambda table: {shape_key(s): dict(zip(("ms", "plain_ms", "bound_ms"), t[:3]))
                           for s, t in table.items()}

    def form(name, source, replaces, launches, by_path, err, table, shapes, extra=None):
        """One kernel form's entry: ms, plain_ms and bound_ms per launch,
        averaged over the main path's shapes, which it launches equally often."""
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "launches_by_path": by_path, "max_abs_err": err,
                 "ms": mean(table, shapes, 0), "plain_ms": mean(table, shapes, 1),
                 "bound_ms": mean(table, shapes, 2),
                 "bound_by": table[shapes[0]][3] if len(table[shapes[0]]) > 3 else "operations",
                 "library_ms": None}
        if len(table[shapes[0]]) > 4:
            entry["bound_f32_fma_ms"] = mean(table, shapes, 4)
        entry.update(extra or {})
        entry["shapes"] = times(table)
        return entry

    fwd_src, bwd_src = "tinynerf_torch/csrc/field_rays_fwd.cu", "tinynerf_torch/csrc/field_rays_bwd.cu"
    flat_src = "tinynerf_torch/csrc/field_flat_fwd.cu"
    flat_bwd_src = "tinynerf_torch/csrc/field_flat_bwd.cu"
    flat = lambda precision: {(R,): flat_time[R, precision]
                              for R in (*FLAT_ROWS[:2], FLAT_BWD_ROWS[0])}
    flat_bwd = lambda precision: {(R,): flat_bwd_time[R, precision] for R in FLAT_BWD_ROWS[:1]}
    # the unbounded360-mlp paths' launches per form (bf16 unless fp32)
    u_fwd_bf16 = {"unbounded360-mlp train": u_launches["flat"],
                  "unbounded360-mlp render": u_render["flat"],
                  "unbounded360-mlp contracted grid train": u_occ["flat"],
                  "unbounded360-mlp proposal MLP train": u_prop["flat"]}
    u_bwd_bf16 = {"unbounded360-mlp train": u_launches["flat_bwd"],
                  "unbounded360-mlp contracted grid train": u_occ["flat_bwd"],
                  "unbounded360-mlp proposal MLP train": u_prop["flat_bwd"]}
    # no single PyTorch call computes any of these fused functions: library_ms is null
    kernels = [
        form("field_rays_fwd", fwd_src, "tinynerf/kernels/mlp_kernel.py:720",
             train_launches[0] + render_launches + fp32_launches[0] + prop_fp32_field[0]
             + sum(v["field_rays"] for k, v in parallel["launches"].items()
                   if "sample-sharded" in k),
             {"lego train": train_launches[0], "lego render": render_launches,
              "lego_occ fp32 train": fp32_launches[0],
              "lego_prop fp32 train": prop_fp32_field[0],
              **{k: v["field_rays"] for k, v in parallel["launches"].items()
                 if "sample-sharded" in k}},
             fwd_err, fwd_time, render_shapes),
        form("field_rays_fwd_bf16", fwd_src, "tinynerf/kernels/mlp_kernel.py:720",
             occ_launches[0] + occ_render_launches + fast_launches[0] + prop_mlp_launches[0]
             + prop_render_field + fern_launches["rays"] + fern_render[False]["rays"]
             + feed["train"]["field_rays"]
             + sum(v["field_rays"] for v in shipped["launches"].values())
             + sum(v["field_rays"] for k, v in parallel["launches"].items() if "lego_occ" in k)
             + sum(v["field_rays"] for v in validate["launches"].values()),
             {"lego_occ train": occ_launches[0], "lego_occ render": occ_render_launches,
              "lego_fast train": fast_launches[0], "lego_prop train": prop_mlp_launches[0],
              "lego_prop render": prop_render_field, "fern_ndc train": fern_launches["rays"],
              "fern_ndc render": fern_render[False]["rays"],
              "fern_ndc host-fed train": feed["train"]["field_rays"],
              **{k: v["field_rays"] for k, v in shipped["launches"].items()},
              **{k: v["field_rays"] for k, v in parallel["launches"].items() if "lego_occ" in k},
              **{k: v["field_rays"] for k, v in validate["launches"].items() if v["field_rays"]}},
             bf16_fwd_err, bf16_fwd_time, list(OCC_SHAPES), {"gemm_chain_ms": gemm_chain_ms}),
        form("field_rays_bwd", bwd_src, "tinynerf/kernels/mlp_kernel.py:751",
             train_launches[1] + fp32_launches[1] + prop_fp32_field[1],
             {"lego train": train_launches[1], "lego_occ fp32 train": fp32_launches[1],
              "lego_prop fp32 train": prop_fp32_field[1]},
             bwd_abs, bwd_time, STEP_SHAPES,
             {"max_rel_err": bwd_rel, "bwd_gemm_chain_ms_fp32": bwd_chain_ms,
              "split": {shape_key(k): v for k, v in bwd_split.items()}}),
        form("field_rays_bwd_bf16", bwd_src, "tinynerf/kernels/mlp_kernel.py:751",
             occ_launches[1] + fast_launches[1] + prop_mlp_launches[1]
             + fern_launches["rays_bwd"] + feed["train"]["field_rays_bwd"]
             + shipped["launches"]["lego_coarse train"]["field_rays_bwd"]
             + parallel["launches"][DP_TRAIN]["field_rays_bwd"]
             + validate["launches"]["validate full checkpoint step"]["field_rays_bwd"],
             {"lego_occ train": occ_launches[1], "lego_fast train": fast_launches[1],
              "lego_prop train": prop_mlp_launches[1],
              "fern_ndc train": fern_launches["rays_bwd"],
              "fern_ndc host-fed train": feed["train"]["field_rays_bwd"],
              "lego_coarse train": shipped["launches"]["lego_coarse train"]["field_rays_bwd"],
              DP_TRAIN: parallel["launches"][DP_TRAIN]["field_rays_bwd"],
              "validate full checkpoint step":
                  validate["launches"]["validate full checkpoint step"]["field_rays_bwd"]},
             bf16_bwd_abs, bf16_bwd_time, list(OCC_SHAPES), {"max_rel_err": bf16_bwd_rel}),
        form("field_flat_fwd", flat_src, "tinynerf/kernels/mlp_kernel.py:269",
             fp32_launches[2] + u_fp32["flat"],
             {"lego_occ fp32 train": fp32_launches[2],
              "unbounded360-mlp fp32 train": u_fp32["flat"]},
             flat_err["fp32"], flat("fp32"), [(FLAT_BWD_ROWS[0],)]),
        form("field_flat_fwd_bf16", flat_src, "tinynerf/kernels/mlp_kernel.py:269",
             occ_launches[2] + fast_launches[2] + sum(u_fwd_bf16.values())
             + parallel["launches"][DP_TRAIN]["field_flat"]
             + validate["launches"]["validate full refresh"]["field_flat"],
             {"lego_occ train": occ_launches[2], "lego_fast train": fast_launches[2],
              **u_fwd_bf16, DP_TRAIN: parallel["launches"][DP_TRAIN]["field_flat"],
              "validate full refresh": validate["launches"]["validate full refresh"]["field_flat"]},
             flat_err["bf16"], flat("bf16"), [(FLAT_BWD_ROWS[0],)]),
        form("field_flat_bwd", flat_bwd_src, "tinynerf/kernels/mlp_kernel.py:566",
             u_fp32["flat_bwd"], {"unbounded360-mlp fp32 train": u_fp32["flat_bwd"]},
             flat_bwd_err["fp32"], flat_bwd("fp32"), [(FLAT_BWD_ROWS[0],)],
             {"max_rel_err": flat_bwd_rel["fp32"], "min_cosine_vs_plain": flat_bwd_cos["fp32"]}),
        form("field_flat_bwd_bf16", flat_bwd_src, "tinynerf/kernels/mlp_kernel.py:566",
             sum(u_bwd_bf16.values()), u_bwd_bf16,
             flat_bwd_err["bf16"], flat_bwd("bf16"), [(FLAT_BWD_ROWS[0],)],
             {"max_rel_err": flat_bwd_rel["bf16"], "min_cosine_vs_plain": flat_bwd_cos["bf16"]}),
    ]
    gfwd_src, gbwd_src = ("tinynerf_torch/csrc/grid_rays_fwd.cu",
                          "tinynerf_torch/csrc/grid_rays_bwd.cu")
    grid_shapes = [(B, N) for _, B, N in GRID_SHAPES]
    rows = {"flops_per_row": {g: gk.flops_per_row(*dims) for g, dims in GRID.items()},
            "flops_split_per_row": {g: gk.flops_split_per_row(*dims) for g, dims in GRID.items()},
            "hat_flops_per_row": {g: gk.hat_flops_per_row(*dims) for g, dims in GRID.items()}}
    launch = lambda precision: {"launch_ms": {shape_key(k): v for k, v in
                                              grid_launch_ms[precision].items()}}
    split = lambda precision: {"phase_split": {shape_key(k): v for k, v in
                                               grid_split[precision].items()}}
    kernels += [
        form("grid_rays_fwd", gfwd_src, "tinynerf/kernels/grid_kernel.py:309",
             grid_fp32_launches[0], {"lego_grid fp32 train": grid_fp32_launches[0]},
             grid_err["fwd fp32"], grid_fwd_time["fp32"], grid_shapes, {**rows, **launch("fp32")}),
        form("grid_rays_fwd_bf16", gfwd_src, "tinynerf/kernels/grid_kernel.py:309",
             grid_launches[0] + grid_render_launches + fast_launches[3]
             + sum(up[k]["grid_rays"] for k in ("train", "val", "resumed")),
             {"lego_grid train": grid_launches[0], "lego_grid render": grid_render_launches,
              "lego_fast train": fast_launches[3],
              "lego_grid upsample train (R 64, 128, 256)": up["train"]["grid_rays"],
              "lego_grid upsample val PSNR": up["val"]["grid_rays"],
              "lego_grid upsample resumed train": up["resumed"]["grid_rays"]},
             grid_err["fwd bf16"], grid_fwd_time["bf16"], grid_shapes, {**rows, **launch("bf16")}),
        form("grid_rays_bwd", gbwd_src, "tinynerf/kernels/grid_kernel.py:344",
             grid_fp32_launches[1], {"lego_grid fp32 train": grid_fp32_launches[1]},
             grid_err["bwd fp32"], grid_bwd_time["fp32"], grid_shapes,
             {"max_rel_err": grid_rel["bwd fp32"], **split("fp32")}),
        form("grid_rays_bwd_bf16", gbwd_src, "tinynerf/kernels/grid_kernel.py:344",
             grid_launches[1] + fast_launches[4]
             + up["train"]["grid_rays_bwd"] + up["resumed"]["grid_rays_bwd"],
             {"lego_grid train": grid_launches[1], "lego_fast train": fast_launches[4],
              "lego_grid upsample train (R 64, 128, 256)": up["train"]["grid_rays_bwd"],
              "lego_grid upsample resumed train": up["resumed"]["grid_rays_bwd"]},
             grid_err["bwd bf16"], grid_bwd_time["bf16"], grid_shapes,
             {"max_rel_err": grid_rel["bwd bf16"], **split("bf16")}),
    ]
    pfwd_src, pbwd_src = ("tinynerf_torch/csrc/prop_rays_fwd.cu",
                          "tinynerf_torch/csrc/prop_rays_bwd.cu")
    prop_rows = {"flops_per_row": pk.flops_per_row(*PROP_NETS["128x4"])}
    kernels += [
        form("prop_rays_fwd", pfwd_src, "tinynerf/kernels/proposal_kernel.py:255",
             prop_fp32_launches[0], {"lego_prop fp32 train": prop_fp32_launches[0]},
             prop_err["fwd fp32"], prop_fwd_time["fp32"], [PROP_SHAPE],
             {**prop_rows, **prop_extra["fwd fp32"]}),
        form("prop_rays_fwd_bf16", pfwd_src, "tinynerf/kernels/proposal_kernel.py:255",
             prop_launches[0] + prop_render_launches + u_prop["prop"],
             {"lego_prop train": prop_launches[0], "lego_prop render": prop_render_launches,
              "unbounded360-mlp proposal MLP train (prop_flat)": u_prop["prop"]},
             prop_err["fwd bf16"], prop_fwd_time["bf16"], [PROP_SHAPE],
             {**prop_rows, **prop_extra["fwd bf16"]}),
        form("prop_rays_bwd", pbwd_src, "tinynerf/kernels/proposal_kernel.py:285",
             prop_fp32_launches[1], {"lego_prop fp32 train": prop_fp32_launches[1]},
             prop_err["bwd fp32"], prop_bwd_time["fp32"], [PROP_SHAPE],
             {**prop_rows, "max_rel_err": prop_rel["bwd fp32"], **prop_extra["bwd fp32"]}),
        form("prop_rays_bwd_bf16", pbwd_src, "tinynerf/kernels/proposal_kernel.py:285",
             prop_launches[1] + u_prop["prop_bwd"],
             {"lego_prop train": prop_launches[1],
              "unbounded360-mlp proposal MLP train (prop_flat)": u_prop["prop_bwd"]},
             prop_err["bwd bf16"], prop_bwd_time["bf16"], [PROP_SHAPE],
             {**prop_rows, "max_rel_err": prop_rel["bwd bf16"], **prop_extra["bwd bf16"]}),
    ]
    rfwd_src, rbwd_src = ("tinynerf_torch/csrc/render_fused_fwd.cu",
                          "tinynerf_torch/csrc/render_fused_bwd.cu")
    fused_shape = [(4096, *FUSED_SAMPLES)]
    fused_rows = {"flops_per_ray": rk.flops_per_ray(*FUSED_SAMPLES)}
    # launches: the fused render paths (one a chunk) and the one gradient of
    # a chunk through each path's fused branch
    kernels += [
        form("render_fused_fwd", rfwd_src, "tinynerf/kernels/render_kernel.py:615",
             fused_lego[0] + fused_lego[3][0],
             {"lego render fused": fused_lego[0], "lego fused chunk gradient": fused_lego[3][0]},
             fused_err["fwd fp32"], fused_fwd_time["fp32"], fused_shape,
             {**fused_rows, **fused_extra["fwd fp32"]}),
        form("render_fused_fwd_bf16", rfwd_src, "tinynerf/kernels/render_kernel.py:615",
             fused_occ[0] + fused_occ[3][0] + fern_render[True]["fused"]
             + feed["val"]["render_fused"],
             {"lego_occ render fused": fused_occ[0],
              "lego_occ fused chunk gradient": fused_occ[3][0],
              "fern_ndc render fused": fern_render[True]["fused"],
              "fern_ndc host-fed val PSNR": feed["val"]["render_fused"]},
             fused_err["fwd bf16"], fused_fwd_time["bf16"], fused_shape,
             {**fused_rows, **fused_extra["fwd bf16"]}),
        form("render_fused_bwd", rbwd_src, "tinynerf/kernels/render_kernel.py:651",
             fused_lego[3][1], {"lego fused chunk gradient": fused_lego[3][1]},
             fused_err["bwd fp32"], fused_bwd_time["fp32"], fused_shape,
             {**fused_rows, "min_cosine_vs_plain": fused_cos["fp32"],
              "norm_ratio_vs_plain": fused_ratio["fp32"],
              "merge_max_rel_err": merge_err["fp32"], **fused_extra["bwd fp32"]}),
        form("render_fused_bwd_bf16", rbwd_src, "tinynerf/kernels/render_kernel.py:651",
             fused_occ[3][1], {"lego_occ fused chunk gradient": fused_occ[3][1]},
             fused_err["bwd bf16"], fused_bwd_time["bf16"], fused_shape,
             {**fused_rows, "min_cosine_vs_plain": fused_cos["bf16"],
              "norm_ratio_vs_plain": fused_ratio["bf16"],
              "merge_max_rel_err": merge_err["bf16"], **fused_extra["bwd bf16"]}),
    ]
    # the graphed paths' launches of each form (phase 30; phase 31's a rank)
    for entry in kernels:
        entry["graphed_launches"] = {**graphed["launches"].get(entry["name"], {}),
                                     **meshed["launches"].get(entry["name"], {})}
    # phase 32's paths: the gather's steps and chunks, the bridge's views
    for entry in kernels:
        extra = gathered["launches"].get(entry["name"], {})
        entry["launches_by_path"].update(extra)
        entry["launches"] += sum(extra.values())
    print(json.dumps({"train_step": {str(b): {"ms": t[0], "kernel_ms": t[1]}
                                     for b, t in step_time.items()},
                      "lego_occ": {"step_ms": occ_ms, "kernel_ms": occ_kern,
                                   "refresh_ms": refresh_ms, "frame_s": occ_frame_s,
                                   "march_ms_per_chunk": march_ms,
                                   "grid_shares": shares},
                      "lego_grid": {"step_ms": grid_ms, "kernel_ms": grid_kern,
                                    "frame_s": grid_frame_s, "grid_shares": grid_shares_after,
                                    "grad_cosines": grid_cos, "chunk_pix_err": grid_pix_err},
                      "lego_fast": {"seconds_10_steps": fast_s},
                      **flagship,
                      **options,
                      **{k: v for k, v in shipped.items() if k != "launches"},
                      "lego_prop": {"step_ms": prop_ms, "kernel_ms": prop_kern,
                                    "frame_s": prop_frame_s, "grad_cosines": prop_cos,
                                    "chunk_pix_err": prop_pix_err,
                                    "fp32_step_ms": prop_fp32_ms},
                      "lego_fused": {"frame_s": fused_lego[1], "chunk_err": fused_lego[2],
                                     "grad_cosine_vs_plain": fused_lego[4]},
                      "lego_occ_fused": {"frame_s": fused_occ[1], "chunk_err": fused_occ[2],
                                         "grad_cosine_vs_plain": fused_occ[4]},
                      "unbounded360_mlp": {"step_ms": u360_ms, "kernel_ms": u360_kern,
                                           "frame_s": u360_frame_s, "grad_cosines": u360_cos,
                                           "chunk_pix_err": u360_pix_err,
                                           "contracted_grid_seconds_10_steps": u_occ_s,
                                           "contracted_grid_shares": u_occ_shares},
                      "fern_ndc": {"step_ms": fern_ms, "frame_s": fern_frame_s[False],
                                   "fused_frame_s": fern_frame_s[True],
                                   "fused_vs_unfused_max_diff": fern_diff},
                      "parallel": {k: v for k, v in parallel.items() if k != "launches"},
                      "graphs": {k: v for k, v in graphed.items() if k != "launches"},
                      "mesh_graphs": {k: v for k, v in meshed.items() if k != "launches"},
                      "gather_bridge": {k: v for k, v in gathered.items() if k != "launches"},
                      **{k: v for k, v in validate.items() if k != "launches"}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

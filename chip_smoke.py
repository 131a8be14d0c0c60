#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the eight kernel sources of pointnerf_tpu_torch/csrc (one nvcc
     per source, in parallel) and print the build time and ptxas summary:
     K1 (knn_select.cu: its run, warp and wide paths, the wide one for
     rows of more than 512 candidates), K2, and K3 and K4 on two routes
     each — bf16 on the tensor-core kernels (fused_decode_tc.cu,
     fused_decode_bwd_tc.cu), f32 on the CUDA-core ones (fused_decode.cu,
     fused_decode_bwd.cu) — and the general K3 / K4
     (fused_decode_any.cu, fused_decode_bwd_any.cu: tensor cores for bf16,
     the CUDA cores for f32, both on the live-group list);
  3. the scene of both main paths — a 65,536-point sphere_scene (seed 0),
     its grid with the prebuilt neighbor tables, random aggregator weights
     from a seed — at bench_config with knn_select="pallas",
     fused_decode=True and fused_march=True. The requests are rendered once
     to record each kernel's real inputs; then each kernel is held against
     its plain PyTorch version on the card on those inputs (K1 at C = 36,352
     slots x QP = 243 candidates, bit-equal, with its run statistics, and K2
     at R = 3600 x SR = 80 within K2_TOL, on the first request; K3 at
     M = 290,816 rows in bf16 and in f32 on every request), with its time,
     the plain version's time and the bound — K1 and K2, a few µs each, on
     the device's clock (graph_ms: a CUDA graph of 50 launches, so the
     wrapper's host time is not in the reading) with the wrapper's host µs
     per call beside it, the longer kernels by back-to-back calls between
     two events (cuda_ms); beside K3 and
     K4, as a printed yardstick only, the same layer products as a chain of
     bf16 torch.matmul calls (gemm_chain_ms), which the port never calls;
  4. the serving path: the launch counts are set to 0, eval_step serves 4
     requests of 3,600 rays (4 views), every kernel's count must grow with
     every request, every decode launch must take the tensor-core route and
     every K1 launch its run path (K = 8), colors must be finite;
  5. one 512-ray request on the card and the same on the CPU through the
     plain versions: integers equal, colors of the rays that hit within the
     bf16 bar;
  6. one training step records K4's real inputs (M = 290,816 rows and the
     upstream gradients); K4 is held against its plain version on them, in
     bf16 and in f32, on the row gradients and every dW/db, with its time,
     the plain version's time and the bound (the bytes of the tensor-core
     K4's second phase, a cost of its design, are printed apart); two bf16
     calls must give the same bits;
  7. the training path: the launch counts are set to 0, train_step takes 3
     warm-up and 20 timed steps of 3,600 rays on one batch, as bench.py
     does; each step must launch K1, K3 and K4 once each, K1 on its run
     path, K3 and K4 on the tensor-core route (training takes the plain
     march, as the JAX package does, so K2 is not launched); the loss must
     be finite at every step and the mean of the last 5 below the mean of
     the first 5; prints the train rays/s;
  8. the gradients of one 512-ray training step on the card and on the CPU
     (the same jitter draw) from the state the timed steps left: integers
     equal, the loss, the MLP gradients and the point-payload gradients
     within their bf16 bars;
  9. the maintenance path: the launch counts are set to 0 and
     train_scene runs 40 steps of 3,600 rays on the same sphere with the
     points within 25 degrees of view 0's silhouette cut (grazing rays
     miss: a hole) and every 8th point's conf below prune_thresh, with
     prunes at 10/20/30/40, probe-hole growth over view 0 at 15/30 (dense
     prob-mode chunks of 2,304 rays), splits at 20/40, an eval of view 4
     at 35 and checkpoints at 25 and 40; then train_scene resumes from the
     last checkpoint to step 44. Checks: each prune keeps exactly the
     points with conf > prune_thresh; the first probe finds missed rays and
     grows; every grown point lies within the KNN radius of the cloud
     before it (the first grow's also of the sphere); a split adds points;
     the grid is rebuilt after every change of the point set with the
     carried max_d; every train step launches K1, K3 and K4 once, every
     probe or eval chunk K1, K3 and K2 once, on their main routes; losses
     and PSNR are finite; the resumed state equals the saved one bit for
     bit. Prints the seconds per prune, probe frame, grow, split, grid
     rebuild, eval frame, checkpoint save and load, and the loop's train
     rays/s. Then K1 (bit-equal), K2 (within K2_TOL) and K3 (bf16 and
     f32, as in phase 3) are held against their plain versions on one
     recorded dense probe chunk (C = 184,320 slots, M = 1,474,560 rows,
     R = 2,304) and one recorded eval chunk (C = 92,160, M = 737,280,
     R = 9,216), and a 16 x 16 window of the first probe frame around a
     hole's edge is rendered with the probe outputs on the card and on the
     CPU from the state that probe saw: masks and neighbor ids equal, the
     argmax sample equal on every ray outside a fixed near-tie margin (at
     most MAX_TIE_SHARE of the hit rays inside it), the opacities (per
     sample and the peak) on their mean error and the other probe outputs
     on their largest, each beside a control;
 10. the dataset path: a NeRF-Synthetic-format scene of the procedural
     cluster is written under build/nerf_synth (6 train and 1 test views
     of 800 x 800 from the analytic ground truth, blender poses at
     distance 4.0, points.ply of 200,000 surface samples), and the launch
     counts are set to 0; train_dataset_scene runs 16 steps of 3,600 rays
     at scene_config() as it builds it (K=8, SR=80, D=400, H=256, f32,
     dense decode, bucket + shell-layered KNN, both fused flags off) with
     only the schedule cut (a prune at 10, an eval of the test view and a
     checkpoint at 16), then test_dataset_scene from that checkpoint.
     Checks: each step launches K3 and K4 once on the CUDA-core (f32)
     route, each eval chunk (9,216 rays) K3 and K2 once, K1 never; the
     prune keeps the points with conf > prune_thresh; the loaded state
     equals the saved one; the two PSNRs agree within 0.01 dB. K3 f32 and
     K4 f32 are then held against their plain versions (2e-4 of scale) on
     a recorded train step (M = 2,304,000 rows) and K3 f32 on a recorded
     eval chunk (M = 5,898,240), with times, bounds and shares of the
     bound; two K4 f32 calls must give the same bits; the kernels'
     live-group list must equal its plain version, and the rows with
     weight, the live groups x K (the rows the f32 kernels decode) and the
     rows of 64-row tiles with a weighted row (what a test per tile would
     decode) are printed for the step and the chunk, and the f32 times
     beside the first f32 kernels' readings (FIRST_F32_MS);
 11. the query branches: 512 rays of the test view through every ray
     generator (and the jittered ones from one shared draw) and every KNN
     branch (bucket rows or prebuilt tables; K nearest, shell-layered, the
     NN=0 random subset) on the card and on the CPU: slot masks, ray masks
     and neighbor ids equal;
 12. construct_vox_points_closest on a 2,500,000-point cluster cloud on
     the card and on the CPU: ids and centroids equal;
 13. the flags-off path: the JAX package's recorded quality configuration
     (runs/quality_cluster_full_r5/opt.json, loaded as it is: prebuilt
     tables, compacted decode at 0.4, bf16, fused_decode and fused_march
     off) on a 200,000-point cluster cloud, launch counts set to 0: a
     512-ray request on the card against the CPU with the flags set (the
     kernels' plain versions) at random weights, under phase 5's bars;
     3 + 10 train steps of 3,600 rays (K1 on its run path, K3 and K4 on
     the tensor cores, once each a step) and 2 serving requests (K1, K3
     and K2 once each); the parity request again from the trained state,
     integers equal and colors within COLOR_TRAINED_BF16_TOL. Then K3 and
     K4 bf16 are held against their plain versions on the first train
     step's recorded inputs (921,600 rows), and K1, K3 and K2 on the first
     request's, at the bars of phases 3-5;
 14. the hybrid path: the recorded hybrid configuration
     (runs/quality_cluster_hole_nerf_r5/opt.json, loaded as it is:
     nerf_importance 8 from 64 coarse field samples, a 128-wide 4-layer
     field, bf16, compacted at 0.4, both fused flags off) on the cluster
     with prims 1 and 4 left out of a 200,000-point cloud (coverage holes),
     random weights (the field's too): a 512-ray request card vs CPU (CPU
     with the flags set; its merged march is the plain march) — masks and
     neighbor ids equal, the merge order idx_s equal to the CPU's merge of
     the card's samples (it differs from the CPU's own only where a field
     sample lies within its card-vs-CPU difference of a point sample: the
     field's f32 sums differ by ~1e-6), the merged colors of the
     rays that hit within HYBRID_COLOR_BF16_TOL, the field's coarse color
     within the f32 bar; 3 + 10 train steps of 3,600 rays (K1, K3, K4 once
     each, K2 never) and 2 requests (K1, K3 once, K2 twice: the points
     alone, then the z-merged sequence of 80 + 8 samples), train rays/s
     and rays/s; the request again from the trained state within
     HYBRID_COLOR_TRAINED_BF16_TOL, and a 512-ray train step's loss and
     gradients (the field's in the MLP group) card vs CPU with the same
     draws, under phase 8's bars;
 15. the fine pass: the same configuration with fine_sample_num 80 and
     fine_raycolor in the color loss (as the reference registers it): the
     same checks — fine_raycolor too, and fine_neighbor_pidx equal on every
     fine shading point that is bit-equal card vs CPU (the points come from
     the coarse blend weights, which carry the bf16 decode) —, 1 + 3 train
     steps (K1, K3, K4 twice each) and 1 request (K1, K3 twice, K2 three
     times: the coarse 80, the fine 160, the merged 88);
 16. NeRF-driven creation: train_scene at the recorded creation
     configuration (runs/quality_cluster_hole_create_r5/opt.json) with the
     schedule cut to 24 steps, one probe of one 800 x 800 frame at step 16
     and prob_thresh CREATE_PROB_THRESH (the field is at its random init),
     an eval and a checkpoint at 24, then a resume to step 26: every train
     step launches K1, K3, K4 once, every probe or eval chunk K1, K3 once
     and K2 twice; the grow adds exactly the candidates the host derives
     from the probe maps, with points created on missed rays at the field's
     expected location; the grid is rebuilt with them; the resumed state
     (params["nerf"] included) equals the saved one bit for bit;
 17. each kernel at the new shapes, on the inputs the first request and
     train step of phases 14 and 15 gave it: K2 on the merged sequence and
     on the fine one (within K2_TOL), K1 on the fine pass (bit-equal), K3
     bf16 on the fine pass and K4 bf16 on the fine pass's decode of a step
     (their bars), with times and bounds;
 18. the loaders: the cluster (its 200,000-point cloud) written as an NSVF
     scene (tt_ft: 5 + 1 views of 96 x 96, RGBA PNGs, a 4x4 intrinsics
     file, a bbox) and as a waymo_ft bundle through the port's
     frames_to_npz (the cloud voxel-downsampled per frame on the card);
     train_dataset_scene for 4 steps on each at scene_config() (K3 and K4
     f32 once a step, K1 never) with one 9,216-ray eval chunk (K3 f32
     once, K2 once) and a checkpoint;
 19. a DTU-format scene of the cluster under build/mvs: 16 views of
     640 x 512 on a ring around it, written once and laid out twice —
     dtu_ft (cam files in millimetres, quarter-resolution intrinsics, the
     finetune init pairs: 8 groups of a view and its ring neighbours) and
     dtu (scene units, for the feed-forward loader) —, the ranked pair
     file;
 20. MVS init: mvs_init_cloud on dtu_ft, 8 groups of 3 views, 64 depth
     planes, the port's seeded weights, no confidence threshold and one
     consistent view (random weights leave a flat depth softmax): seconds
     per group, depth pixels before the filter and points after it, peak
     memory; group 0 card vs CPU: MVSNet's depth, conf, prob and features
     (TF32 off) within MVS_TOL with the TF32 forward as the control above
     the features' bar (random weights leave the depth softmax flat: TF32
     barely moves depth), the filter of the card's depth maps on the card and on the CPU
     (survivors equal), the embedding within MVS_EMBED_TOL;
 21. dtu_ft per-scene training: train_dataset_scene with no cloud on disk
     (it builds one with mvs_init_cloud) for 8 steps at scene_config() of
     the cloud — a prune at step 4 (prune_thresh cut to the cloud's median
     conf), an eval of both test views and a checkpoint at 8 —, then
     test_dataset_scene (PSNR equal within 0.01 dB) and a resume to step
     10: K3 f32 and K4 f32 once a step, K3 f32 and K2 once per 9,216-ray
     eval chunk, K1 never; each loaded state equal to the saved one bit for
     bit;
 22. feed-forward training: train_feedforward_dataset on the dtu layout
     (nsrc 2, 48 planes, 1,024 rays a step, 640 x 512, the driver's own
     scene_config), 3 + 10 steps: K3 f32 and K4 f32 once a step, K1 and K2
     never, the loss finite, MVSNet's and the aggregator's weights moved,
     s/step and rays/s, peak memory; one step card vs CPU from the trained
     state at 320 x 256 (widths kept), split at its cloud, at bars from
     readings, each beside its control — the cloud and the running stats
     (control: eval-mode BatchNorm), the render of the card's cloud on
     both sides (the loss, the MLPs' and the cloud's gradients; control: a
     bf16 decode), MVSNet's backward of one cotangent (control: eval-mode
     BatchNorm) —, the whole step's loss and gradients printed, and
     infer_cloud's num_active and xyz card vs CPU; then K3 f32 and K4 f32
     (the dists gradient included) against their plain versions on the
     first timed step's inputs, and K3 f32 and K2 on a recorded dtu_ft
     eval chunk;
 23. the 2D heads: bench_config with the kernel flags on at the fork's
     128 feature channels on the 65,536-point sphere, patches of 48 x 48
     rays at the centre of ring views, the heads at the fork's widths
     with random weights from seeds (the CNN: NeuralRenderer at JAX's
     defaults, input 128; the one-layer StyleGAN2 Generator(128) with a
     StyleVectorizer of 512 x 8 and 8 style codes; Discriminator(48)).
     (a) K2 at C = 128 against its plain version, bit for bit, on a
     recorded feature request (R = 2,304, SR = 80: the wide kernel) and
     on the fine pass's sequence (SR' = 160), with times and the bytes
     bound; (b)-(d) the launch counts set to 0, then 3 + 10 steps each of
     the CNN neural2d step, the StyleGAN2 step and the GAN step (K1, K3,
     K4 once a neural2d step; K1 and K3 twice and K4 once a GAN step; K2
     never; the penalty on its cadence; the losses finite and falling, the
     GAN's reconstruction), s/step, rays/s and peak memory each, and 4
     feature requests through eval_step from the trained state (K1, K3,
     K2 once each, K2 on its wide kernel), each decoded to RGB by the
     trained CNN head; (b) a 512-ray feature request card vs CPU at
     a bar from readings; (e) one CNN step and one GAN step (its penalty
     on) from the states the timed steps left, card vs CPU with the same
     draws: the losses and each group's gradients (from the Adam moments)
     at bars from readings beside their control (the CPU with an f32
     decode, or the card with TF32 convolutions); the GAN step is split
     where the roundings enter: the aggregator's and the points'
     gradients on the whole step (control: an f32 decode), and every loss
     and every gradient of the generator and of D on the step with the
     card's feature images and the card's leaky-ReLU branches fed to
     both sides, the adversarial term and the penalty on (control: the
     card with TF32 convolutions; gan_fixed_parity); (f) K3 and K4 bf16
     on the recorded inputs of a CNN step, at
     their bars, K4's largest errors per tile of TC_ROWS_BWD rows beside a
     live tile left out (hold_k4_tc_tiles);
 24. import: phase 3's scene and weights as a reference-format
     `net_ray_marching.pth` built by hand (the "module." prefix, [1, N, *]
     point tensors, Linear pairs at even Sequential indices), saved under
     build/import and imported on the card: the cloud and the parameters
     bit-equal to the source, the export round trip bit-equal; the launch
     counts set to 0, 4 requests of 3,600 rays served from the imported
     scene (K1, K3, K2 once each, on the main routes), colors bit-equal to
     the source scene's on the same requests; a composite's export (its
     per-point Rw2c) imports to compose_parts' state; the CUDA generator
     state that scripts/orbax_to_port.py writes from its layout equals
     manual_seed's and draws the same; K1 and K2 bit-equal and K3 bf16 at
     its bars on a recorded import request;
 25. edit: phase 3's sphere composed with edit.compose_parts — part 1
     cropped by an AABB to x <= EDIT_CROP_X, part 2 turned 90 degrees
     about z and moved by EDIT_T —, per-point Rw2c [cap, 3, 3]; the counts
     set to 0, 4 requests of 3,600 rays (K1, K3, K2 once each); K1 and K2
     bit-equal and K3 bf16 at its bars on two recorded requests (rotated
     dists and extras); a 512-ray request card vs CPU (phase 5's bars);
     one part at R = I against the global-Rw2c path (integers equal,
     colors at EDIT_IDENTITY_TOL, control: the per-point rotations turned
     EDIT_CONTROL_DEG about z); frame invariance — the sphere turned 90
     degrees about y and seen by the camera turned with it against the
     unturned render (mean color difference at EDIT_FRAME_TOL, control:
     the turned composite with its per-point rotations set to I);
 26. scannet: the procedural cluster written in ScanNet's layout under
     build/scannet (5 frames: color 1296 x 968 PNG, depth 640 x 480 16-bit
     PNG in millimetres, rows cycling through the five PNG filters,
     intrinsic_color.txt, poses); a train item's time on a frame's first
     touch (the decode) and on the kept frame; load_init_points
     against the written depth (its count and each point's camera-axis
     depth, so the nearest resize ran); train_dataset_scene at
     scene_preset("scannet/scene241") (P = 26, SR = 24, the bucket KNN: K1
     never; the dense bf16 decode) for SCANNET_STEPS steps of 3,136 rays
     and one eval frame (137 chunks of 9,216 rays): K3 and K4 once a step,
     K3 and K2 once a chunk, on the tensor-core and tiled routes; the
     first batch's loss (no jitter) falls from the first state to the
     last; K3 and K4 bf16 at their bars on a recorded step, K3 bf16 and K2
     (bit-equal) on a recorded eval chunk;
 27. llff: the cluster as an LLFF scene under build/llff
     (poses_bounds.npy, 9 views of 252 x 189 in images_4/); the loader's
     items (both splits) equal the written views' poses, intrinsics, rays
     and pixels; train_scene on the loader's training items with the
     cluster's 200,000-point cloud at scene_config() (the f32 route) for
     LLFF_STEPS steps and one test frame: K3 f32 and K4 f32 once a step,
     K3 f32 and K2 once a chunk;
 28. video: render_video_from_checkpoint on the dataset phase's run
     directory, VIDEO_FRAMES spiral frames of 800 x 800 as PNG (K3 f32 and
     K2 once a chunk); frame 0 equal to render_full_frame at its pose; the
     image and video libraries of the host printed (this script installs
     none); K3
     f32 at the llff step's, eval chunk's and a video chunk's shapes and
     K4 f32 at the llff step's against their plain versions, K2 bit-equal
     on the llff eval chunk and the video chunk;
 29. profiling: a device_trace (torch.profiler, a Chrome trace under
     build/trace) of one serving request, which must name K1's, K3's and
     K2's kernels; a StepTimer's sections of another request sum to within
     its host clock;
 30. the whole aggregator, on phase 3's scene at bench_config width:
     (a) each of the ten distance-kernel settings (quadric, numlinear,
     numquadric, avg, trilinear, sh_intrp, feat_intrp, meta_intrp,
     gau_intrp, and linear with axis weight (1, 2, 1)) serves one
     3,600-ray request and takes one train step, each launching K3 (and
     K4) once on the tensor-core route (trilinear with the KNN radius cut
     to one voxel, AGG_QUERY); (b) each layout outside the fused envelope
     (agg_intrp_order 0 and 1, block2, block2 with the feat xyz hook, the
     alpha and color xyz hooks, a 2-layer alpha head, block3 absent) the
     same, launching K1 and K2 and no decode kernel; for each of (a) and
     (b) a 512-ray request card vs CPU, integers equal and the colors of
     the rays that hit held on their mean error: at most AGG_COLOR_SHARE
     of the control's (the CPU with an f32 decode), the largest printed
     beside phase 5's bar; (c) bench_config with H = 512 and with K = 6, past
     the tuned kernels' limits: 4 requests and 3 + 5 train steps, each
     launching the general K3 (and K4) once, the general K3 held against
     its plain version on a recorded request and the general K4 on a
     recorded step from the fresh and from the trained state, in bf16 and
     in f32 (f32 within 2e-4 of scale; K3 bf16 as phase 3 holds K3; K4
     bf16 on its mean, control the f32 plain version, and on its largest
     errors split where its roundings enter, each beside a live tile left
     out (hold_general_k4): its phase-A scratch at every rounding point
     within bf16's rounding of f64 from the scratch's previous values, row
     gradients per tile at GENERAL_K4_BF16_TILE_TOL and dW / db / dwa / dba
     at GENERAL_K4_BF16_DW_TOL against their f64 values from the scratch),
     two K4 calls
     bit-equal in each rounding, with times and bounds; the kernels' plans
     printed (tensor cores in bf16, CUDA cores in f32, the tile in shared
     memory, no workspace), each time beside its plain version's, its
     bound, its share of the bound and the first general kernels'
     (FIRST_GENERAL_MS), failing
     unless each time of that table is below its plain version's and the
     bf16 ones at H = 512 are GENERAL_SPEEDUP times below those; and the
     general K3 / K4 in f32 at H = GENERAL_DENSE_H (seeded weights) on the
     dataset path's recorded train step (M = 2,304,000 dense rows, ~1%
     live): within 2e-4 of scale of the plain versions run on the live
     groups' rows, dead groups exactly 0, their live lists equal to the
     plain version's, two K4 calls bit-equal, time beside bound. The counts are
     set to 0 just before each setting's counted serve and steps and read
     just after; the card-vs-CPU requests and the captures of the kernel
     checks' inputs run outside those windows;
 31. scannet_tables: phase 26's ScanNet scene with its color frames
     re-encoded as JPEG (Pillow) under build/scannet_tables, read by the
     loader through Pillow (a train item's first-touch and kept-frame
     times printed), trained at scene_preset("scannet/scene241") with the
     JAX package's production query — prebuild_neighbors, no shell cut,
     knn_select "pallas", widths kept (P = 26: QP = 702, SR = 24, K = 8,
     H = 256, bf16), the tables sized by refresh_grid from num_dil (first
     max_d TABLES_MAX_D) — through train_dataset_scene (TABLES_STEPS steps
     and an eval frame) and test_dataset_scene: every step launches K1 (on
     its wide path), K3 and K4 once, every eval chunk K1, K3 and K2 once;
     the first batch's loss falls, the two PSNRs agree; the tables' bytes
     (and what JAX's default max_d = 4 max_o would need), s/step, s per
     eval frame and peak memory printed; K1 bit-equal to its plain version
     at K = 8 and 24 on a train step's and an eval chunk's inputs (QP =
     702), K3 / K4 bf16 at their bars and K2 bit-equal there; a 512-ray
     request of the test frame card vs CPU, the trained density scaled
     by TABLES_DENSITY_SCALE so that the colors move with the decode
     (integers equal; colors within phase 5's bar beside two controls
     that pass it, the CPU with an f32 decode and with K - 1 neighbors,
     and their mean error at most AGG_COLOR_SHARE of the f32 decode's;
     tables_parity); then tables of
     the same cloud at P = 30, 32 and 40 (QP 810, 864, 1,080) and K1
     bit-equal at K = 8 and 24 on a 9,216-ray request's inputs at each,
     with times, plain times and bounds;
 32. mvsnerf: a seeded random cost volume at MVSNeRF's widths (128
     planes, 8 channels, 1/4 of 640 x 512) and 3 views, ReferenceMVSNeRF
     v2 at the JAX defaults (D = 8, W = 256) with weights from a seed; the
     counts set to 0, 4 requests of 3,600 rays at 128 samples through
     render_mvsnerf (K2 once a request, on its tiled kernel, no other
     kernel; rays/s); K2 bit-equal to the plain march on the
     [3600, 128, 4] input recorded from a request served outside
     torch.no_grad (K2 all the same: the card's rule); a 512-ray request card vs CPU (the plain march
     there) within MVSNERF_TOL;
 33. the kernels JSON line (one row per kernel of a source: K1 has a row
     for its run and warp paths and one for its wide path, K2 a row
     for its tiled kernel and one for its wide kernel, K3 and K4 a
     tensor-core row, a CUDA-core row and a general row, counted by route
     on every path, where each path's K2 launches all take one kernel, the
     tiled one at C = 3 and the wide one at C = 128; launches per
     path: serve, train, maintenance, dataset, flags_off, hybrid (phases
     14-16), loaders, mvs (phases 21-22), n2d (phase 23), import, edit,
     scannet, llff, video (phases 24-28), whole_agg (phase 30),
     scannet_tables (phase 31), mvsnerf (phase 32); each kernel's numbers on the maintenance path's probe and eval chunks, on
     the flags-off path's train step and request, at the hybrid's and the
     fine pass's shapes, on the feed-forward step and the dtu_ft eval
     chunk, on the neural2d step and the feature requests, and on the
     import and edit requests, the scannet step and eval chunk, the llff
     step and eval chunk and the video chunk, the scannet_tables step,
     eval chunk and wider tables, and the MVSNeRF request; the general rows
     at H = 512 and beside them K = 6 and f32), the card line, and the
     final status line.

Each bf16 bar is also held against a control: the same comparison with the
f32 plain version in place of the bf16 one, which must land above the bar,
so a kernel that skipped a bf16 rounding point would fail. K3 and K4 in
bf16 are held there on the mean error (mean |kernel - plain| / mean
|plain|): any change of summation order moves a few elements by a bf16 step,
so the largest error of a sound kernel is of the control's order. Their
largest error is held apart, tensor by tensor, which catches a fault in a
few rows: K3's at fixed bars set from readings over many chunks, with a
control (a live tile zeroed) above them (hold_k3_max), the tuned K4's
against that of the plain version summed in f64 (hold_max) except on the
neural2d step, where it and the general K4's are held per tile at fixed
bars from readings with a control (a live tile left out).

Any failure exits non-zero before the status line. Without a CUDA device,
or without the pointnerf_tpu_torch package beside it, it exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

# tolerances of the kernel-vs-plain comparisons on the card
K2_TOL = 1e-5          # march: the PERF.md parity bar
K3_F32_TOL = 2e-4      # decode in f32: the parity bar, relative to max|plain|
# bf16 bars sit between the error of a sound run and the control, as read
# on an H100 80GB HBM3 at 700 W (PERF.md): colors 2.3e-6 vs 9.8e-5
# (absolute). K3 and K4 in bf16 are held on mean |kernel - plain| /
# mean |plain| (worst output or gradient): a bf16 rounding that lands on the
# other side of a tie when a sum runs in another order (the tensor cores'
# order, or f64's) moves one element by a bf16 step, so the largest error of
# any other summation order is that of the control's order of size (PERF.md
# §6); the mean tells them apart. Readings: K3 2.2e-5 vs control 3.9e-3,
# K4 4.1e-4 vs control 8.4e-2.
K3_BF16_TOL = 1e-4     # decode in bf16, mean relative error
COLOR_BF16_TOL = 1e-5  # card vs CPU colors of the rays that hit, bf16 decode
# the same, from the flags-off path's trained state: the colors there also
# carry the bf16 color head's roundings (cuBLAS and the CPU sum in other
# orders), which weigh more as the opacities grow. Readings on an H100 80GB
# HBM3 at 700 W (PERF.md §6): 5.7e-05 to 1.06e-04, control 5.2e-04 to
# 6.1e-04
COLOR_TRAINED_BF16_TOL = 2.5e-4
# card vs CPU colors of a hybrid request (the merged march of the
# bf16-decoded points and the f32 field, and the fine pass's colors) on the
# rays that hit, held on mean |card - CPU| / mean |CPU| as K3 is: their
# largest error reads up to 1.0x the control's in the trained state (a bf16
# rounding at a tie moves a ray by the control's order), so the points-only
# largest-error bars do not fit. Readings on an H100 80GB HBM3 at 700 W
# (PERF.md §6), merged / fine: random weights up to 1.6e-06 / 3.7e-07
# (control from 2.0e-05 / 5.5e-06), trained up to 4.2e-05 / 1.4e-06
# (control from 3.2e-04 / 6.0e-05)
HYBRID_COLOR_BF16_TOL = {"coarse_raycolor": 5e-6, "fine_raycolor": 1.5e-6}
HYBRID_COLOR_TRAINED_BF16_TOL = {"coarse_raycolor": 1e-4,
                                 "fine_raycolor": 1.5e-5}
K4_F32_TOL = 2e-4      # decode backward in f32, per gradient, of max|plain|
K4_BF16_TOL = 5e-3     # decode backward in bf16, mean relative error
# K4 in bf16 is also held on its largest error, gradient by gradient
# (hold_max): at most MAX_FACTOR times the largest distance of the
# f64-summed plain version from the f32 one, plus the f32 route's bar for a
# sum in another order. A fault confined to a few rows (a live tile taken
# for dead, or left out of dW) shows there, not in the mean.
MAX_FACTOR = 2.0
# K3 bf16's largest error, output by output, of max|plain| (hold_k3_max).
# Read by scripts/hold_max_survey.py on 52 probe and eval chunks of the
# maintenance path, both probes, two chip runs (H100 80GB HBM3, 700 W;
# PERF.md §6): fagg up to 7.403e-03, alpha up to 8.230e-04 (an earlier
# run once read 8.442e-04); the control — a live 64-row tile zeroed, the
# median tile — at least 0.915. Where a reading passes MAX_FACTOR x the
# f64-summed plain version's, one bf16 rounding at a tie, taken the other
# way, gives the kernel's output exactly; so K3 is held to fixed bars from
# the readings, above the highest and more than 3x under the least
# control.
K3_BF16_MAX_TOL = {"fagg": 3e-2, "alpha": 1e-2}
# card vs CPU probe outputs of the maintenance path's probe window. The
# outputs read at the argmax sample from the neighbor weights and payloads,
# which no decode touches: max |card - CPU| / max |CPU| on the rays
# compared (control: each ray's neighbor's value; read <= 2.3e-07 against
# ~1 on an H100 80GB HBM3 at 700 W, PERF.md §6).
PROBE_TOL = {"ray_max_sample_loc_w": 1e-5, "ray_max_far_dist": 1e-5,
             "shading_avg_color": 1e-5, "shading_avg_dir": 1e-5,
             "shading_avg_conf": 1e-5, "shading_avg_embedding": 1e-5}
# The opacities come out of the bf16 decode: each sample's of the hit rays
# and each compared ray's peak, held on mean |card - CPU| / mean |CPU|
# (control: the CPU with an f32 decode). Like K3's outputs, their largest
# bf16 error wanders toward the control's order as a rounding tie falls on
# either side (per sample 6.7e-05 to 4.2e-04 of max|CPU|, the peak 2.3e-05
# to 2.4e-04), so they are held on the mean, as K3 is. Readings on an H100
# 80GB HBM3 at 700 W (PERF.md §6): per sample 2.5e-06 to 3.2e-06, control
# 5.8e-04; the peak 5.3e-06, control 8.0e-04.
OPACITY_BF16_TOL = 1e-4
# a ray whose two largest CPU opacities lie within this share of max|CPU|
# is a near tie, and its argmax is not compared: twice the largest
# per-sample opacity error read, rounded up (2 x 5e-4); at most
# MAX_TIE_SHARE of the window's hit rays may be near ties
TIE_MARGIN = 1e-3
MAX_TIE_SHARE = 0.25
# card vs CPU training step (bf16 decode), relative: the loss (read 1.1e-6
# vs control 8.3e-4), and each group of gradients, sum |card - CPU| /
# sum |CPU| over its leaves, on the state the timed steps leave (PERF.md
# §6, step 23: MLP read 2.1e-3 to 4.4e-3, control 6.2e-2 to 7.8e-2; points
# 9.0e-4 to 9.6e-4, control 7.4e-3 to 8.6e-3). No bar fits 10x under the
# control with room above the readings; these sit >= 2.3x over the highest
# reading and >= 3x under the least control.
LOSS_BF16_TOL = 1e-4
# the hybrid's loss: its field term (f32 on both sides) and the missed rays
# dilute the decode's share, so the control sits lower too (hybrid path,
# step 13: read 1.9e-06 to 5.3e-06, control 7.5e-05 to 1.5e-04; PERF.md §6)
HYBRID_LOSS_BF16_TOL = 2e-5
GRAD_BF16_TOL = {"mlp": 1e-2, "points": 2.5e-3}
# the hybrid paths (PERF.md §6; readings / controls at the trained state):
# the field's gradients ("nerf") carry the bf16 decode only through the
# merged march's transmission, so readings (up to 2.7e-04) and controls
# (from 5.7e-04) sit close: the bar between them is thin; with the fine
# pass the aggregator's ("mlp") control falls to 9.9e-03 (read 2.8e-04)
HYBRID_GRAD_BF16_TOL = {"mlp": 1e-2, "points": 2.5e-3, "nerf": 4e-4}
FINE_GRAD_BF16_TOL = {"mlp": 3e-3, "points": 2.5e-3, "nerf": 4e-4}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_BF16 = 989e12             # dense bf16 tensor-core rate
PEAK_F32 = 67e12               # f32 outside the tensor cores

N_POINTS = 65536
N_RAYS = 3600
N_REQUESTS = 4
N_TRAIN_WARMUP = 3     # bench.py's step loop
N_TRAIN_STEPS = 20
TRAIN_KERNELS = ("knn_select", "fused_decode", "fused_decode_bwd")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """ms per call of back-to-back calls between two CUDA events: the
    device time of calls that outlast their host-side dispatch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def graph_ms(fn, launches: int = 50, replays: int = 5) -> float:
    """Device ms per call of a short kernel: `launches` calls of `fn` are
    captured in one CUDA graph and its replays timed with CUDA events, so
    the wrapper's host time (checks, allocation, the ctypes call) is not in
    the reading. The wrappers launch on torch.cuda.current_stream(), which
    is the capture stream inside torch.cuda.graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (replays * launches)


def host_us(fn, calls: int = 50) -> float:
    """Host µs per call of `fn` (enqueue only; the device catches up
    after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def hold_bf16(what: str, err: float, control: float, bar: float,
              control_is: str = "f32 in place of bf16") -> None:
    """Fail unless the comparison is under its bar and the control (by
    default the f32 version in place of the bf16 one) is above it."""
    log(f"{what}: {err:.3e}, control ({control_is}) {control:.3e}, bar "
        f"{bar:.3e}")
    if not err <= bar:
        fail(f"{what} beyond its bar")
    if not control > bar:
        fail(f"{what}: the bar does not tell the control apart")


def hold_max(what: str, names, kern, plain, ref, f32_tol: float) -> None:
    """Fail unless each tensor's largest |kernel - plain| / max|plain| is
    within MAX_FACTOR x that of `ref` (the plain version summed in f64)
    + f32_tol."""
    rows = []
    for name, k, p, r in zip(names, kern, plain, ref):
        s = float(p.abs().max())
        ek = float((k - p).abs().max())
        er = float((r - p).abs().max())
        ek, er = ((ek / s, er / s) if s > 0
                  else (0.0 if ek == 0 else float("inf"), 0.0))
        rows.append((name, ek, er, MAX_FACTOR * er + f32_tol))
    log(f"{what}: largest |err| / max|plain| per tensor, kernel vs the "
        f"f64-summed plain version [bar]: " + ", ".join(
            f"{n} {ek:.3e} vs {er:.3e} [{bar:.3e}]" for n, ek, er, bar in rows))
    bad = [n for n, ek, _er, bar in rows if not ek <= bar]
    if bad:
        fail(f"{what}: the largest error of {bad} is beyond its bar")


def k3_max_readings(out, plain, ref, w, K: int):
    """K3 bf16's largest error per output (fagg, alpha), relative to
    max|plain|: {name: (kernel's, the f64-summed plain version's, control)}.
    The control models a live tile taken for dead: the kernel's output with
    one live TC_ROWS-row tile zeroed, read for every live tile and taken at
    the median (a typical live tile; its groups' largest |plain|). None
    when the plain output is all zero (no row carries weight)."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import TC_ROWS
    gpt = TC_ROWS // K                       # groups per tile
    row_live = (w.reshape(-1) != 0)
    pad = -row_live.numel() % TC_ROWS
    tile_live = torch.nn.functional.pad(row_live, (0, pad)).view(
        -1, TC_ROWS).any(1)
    res = {}
    for name, k, p, r in zip(("fagg", "alpha"), out, plain, ref):
        s = float(p.abs().max())
        if not s > 0:
            return None                       # nothing decoded: no reading
        gmax = p.abs().amax(-1)
        gmax = torch.nn.functional.pad(gmax, (0, -gmax.numel() % gpt))
        tiles = gmax.view(-1, gpt).amax(1)[:tile_live.numel()]
        live = tiles[tile_live[:tiles.numel()]]
        ctl = float(live.median()) / s if live.numel() else 0.0
        res[name] = (float((k - p).abs().max()) / s,
                     float((r - p).abs().max()) / s, ctl)
    return res


def hold_k3_max(what: str, out, plain, ref, w, K: int) -> None:
    """Fail unless each K3 bf16 output's largest |kernel - plain| /
    max|plain| is within K3_BF16_MAX_TOL and its control (a live tile
    zeroed, `k3_max_readings`) lies above that bar."""
    rd = k3_max_readings(out, plain, ref, w, K)
    if rd is None:
        fail(f"{what}: the plain decode is all zero")
    log(f"{what}: largest |err| / max|plain| per output [bar], beside the "
        f"f64-summed plain version's and the control (a live tile zeroed): "
        + ", ".join(f"{n} {a:.3e} [{K3_BF16_MAX_TOL[n]:.1e}] (f64 {b:.3e}, "
                    f"control {c:.3e})" for n, (a, b, c) in rd.items()))
    for n, (a, _b, c) in rd.items():
        if not a <= K3_BF16_MAX_TOL[n]:
            fail(f"{what}: the largest error of {n} is beyond its bar")
        if not c > K3_BF16_MAX_TOL[n]:
            fail(f"{what}: the bar of {n} does not tell the control apart")


def live_tiles(row_live, rows: int) -> str:
    """'n of N' tiles of `rows` rows that hold a live row."""
    import torch
    pad = -row_live.numel() % rows
    t = torch.nn.functional.pad(row_live.reshape(-1), (0, pad)).view(-1, rows)
    return f"{int(t.any(1).sum())} of {t.shape[0]}"


def mean_rel(a, b) -> float:
    """mean |a - b| / mean |b| (0 where b is all zero and a equals it)."""
    den = float(b.abs().mean())
    num = float((a - b).abs().mean())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def bound_ms(nbytes: float, flops: float, peak: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def decode_bound(w, params, spec, backward: bool = False):
    """(rows, bytes, bound ms, bound_by) of one K3 call, or with `backward`
    of one K4 call, on these inputs. Rows: those this run's data needs,
    the ones with a nonzero weight (a row without weight has all-zero
    gradients), each read once, with the weights and the outputs written
    once; K4 also reads the upstream gradients and writes all M gradient
    rows and every dW/db, and does 3x K3's operations (the forward again,
    dW, and the input gradients)."""
    from pointnerf_tpu_torch.ops.fused_decode import flops, param_count
    M = w.shape[0]
    rows = int((w != 0).sum())
    wbytes = sum(p.numel() * 4 for n in ("block1", "block3", "alpha")
                 for layer in params[n] for p in layer.values())
    width = spec.Fi + spec.Dd + spec.E + 1
    nbytes = rows * width * 4 + wbytes + (M // spec.K) * (spec.H + 1) * 4
    ops = flops(rows, spec)
    if backward:
        nbytes += M * 4 + M * width * 4 + param_count(spec) * 4
        ops *= 3
    b, by = bound_ms(nbytes, ops, PEAK_BF16 if spec.bf16 else PEAK_F32)
    return rows, nbytes, b, by


def slice_config():
    from pointnerf_tpu_torch.config import bench_config
    cfg = bench_config()
    return cfg.replace(
        query=dataclasses.replace(cfg.query, knn_select="pallas"),
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))


def make_scene(cfg, device):
    import torch
    from pointnerf_tpu_torch.data.synthetic import sphere_scene
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.step import refresh_grid
    xyz, color, normals = sphere_scene(n_pts=N_POINTS, seed=0)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device=device)
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                    device=device)
    grid, _max_d = refresh_grid(pc, st, cfg)
    return pc, st, params, grid


def batches(cfg, n_rays, n_views, device, seed0=1):
    from pointnerf_tpu_torch.data.synthetic import ring_cameras, view_ray_batch
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    out = []
    for i, (campos, camrot, K) in enumerate(
            ring_cameras(n_views=n_views, wh=(256, 256))):
        item = view_ray_batch(campos, camrot, K, (256, 256), n_rays=n_rays,
                              seed=seed0 + i)
        out.append(ray_batch_from_numpy(item, cfg, device=device))
    return out


# the kernels every render launches once (eval_step, not training)
RENDER_KERNELS = ("knn_select", "fused_decode", "fused_march")


@contextlib.contextmanager
def recording_kernels():
    """Recording wrappers around the three kernel entry points as the
    render path calls them; yields {name: (args, kwargs)} of each one's
    last call, and under "all" {name: [(args, kwargs), ...]} of every call
    in order."""
    from pointnerf_tpu_torch.models import aggregator, renderer
    from pointnerf_tpu_torch.ops import query
    seen = {"all": {}}
    spots = [(query, "knn_select"), (aggregator, "fused_decode"),
             (renderer, "fused_march")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr in spots]
    for mod, attr, real in originals:
        def rec(*a, _name=attr, _real=real, **k):
            seen[_name] = (a, k)
            seen["all"].setdefault(_name, []).append((a, k))
            return _real(*a, **k)
        setattr(mod, attr, rec)
    try:
        yield seen
    finally:
        for mod, attr, real in originals:
            setattr(mod, attr, real)


def all_recorded(seen, what: str, kernels=RENDER_KERNELS):
    missing = [n for n in kernels if n not in seen]
    if missing:
        fail(f"{what} did not reach {missing}")
    return seen


def capture_kernel_inputs(params, pc, st, grid, batch, cfg):
    """Render one request with recording wrappers around the three kernel
    entry points; returns {name: (args, kwargs)} as the path called them."""
    from pointnerf_tpu_torch.train.step import eval_step
    with recording_kernels() as seen:
        eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
    return all_recorded(seen, "the main path")


def k1_run_stats(nbr_xyz, dslot, ok, centers, r2: float, block: int):
    """What decides whether sharing a table row across a run of slots pays:
    the slots that select (ok and a row), the distinct rows they read, the
    runs of equal row among consecutive selecting slots (invalid slots in
    between do not end a run) and the runs a kernel that stages one row per
    run in each block of `block` slots reads; and what a row holds: its
    live candidates (x < 1e7) per row and per selecting slot, and those
    within r2 per slot."""
    import torch
    from pointnerf_tpu_torch.ops.knn_select import DEAD
    C, QP = dslot.shape[0], nbr_xyz.shape[1] // 3
    sel = ok & (dslot >= 0)
    idx = sel.nonzero()[:, 0]
    rows = dslot[idx].long()
    n = int(idx.numel())
    if n == 0:
        return {"slots": C, "selecting": 0}
    new_run = torch.ones_like(rows, dtype=torch.bool)
    new_run[1:] = rows[1:] != rows[:-1]
    # a run is cut where a block of slots ends
    blk = idx // block
    staged = new_run.clone()
    staged[1:] |= blk[1:] != blk[:-1]
    distinct = torch.unique(rows)
    live = (nbr_xyz[:, :QP] < DEAD).sum(1)              # per table row
    xyz = nbr_xyz[rows].view(n, 3, QP)
    d2 = ((xyz - centers[idx][:, :, None]) ** 2).sum(1)
    in_r = nbr_xyz[rows][:, :QP] < DEAD
    if r2 > 0:
        in_r &= d2 <= r2
    return {"slots": C, "selecting": n, "distinct_rows": int(distinct.numel()),
            "runs": int(new_run.sum()),
            "mean_run": n / int(new_run.sum()),
            "staged_runs": int(staged.sum()),
            "live_per_row": float(live[distinct].float().mean()),
            "live_per_slot": float(live[rows].float().mean()),
            "in_r2_per_slot": float(in_r.sum(1).float().mean())}


def check_k1(args, kw):
    import torch
    from pointnerf_tpu_torch.ops.knn_select import (SLOTS_PER_BLOCK,
                                                    knn_select,
                                                    knn_select_plain,
                                                    path_for)
    nbr_xyz, nbr_pid, dslot, centers, ok = args
    K, r2 = kw["K"], kw["r2"]
    C, QP = centers.shape[0], nbr_pid.shape[1]
    st = k1_run_stats(nbr_xyz, dslot, ok, centers, r2, SLOTS_PER_BLOCK)
    log(f"K1 run statistics: {json.dumps(st)}")
    pid_k, d2_k = knn_select(*args, **kw)
    pid_p, d2_p = knn_select_plain(*args, K, r2)
    torch.cuda.synchronize()
    n_bad = int((pid_k != pid_p).sum())
    fin = torch.isfinite(d2_p)
    if not torch.equal(fin, torch.isfinite(d2_k)):
        fail("K1: kernel and plain disagree on which winners are valid")
    err = float((d2_k[fin] - d2_p[fin]).abs().max()) if fin.any() else 0.0
    log(f"K1 knn_select C={C} QP={QP} K={K} ({path_for(K, QP)} path): pid "
        f"mismatches {n_bad} (must be 0), max |d2 err| {err:.3e} (must be "
        f"0)")
    if n_bad or err != 0.0:
        fail("K1 disagrees with its plain version")
    ms = graph_ms(lambda: knn_select(*args, **kw))
    host = host_us(lambda: knn_select(*args, **kw))
    plain = cuda_ms(lambda: knn_select_plain(*args, K, r2), iters=10)
    # bytes this run's data needs: each distinct table row read once
    # (coordinates + ids), the slots' centers/dslot/ok, the [C, K] outputs
    rows = st.get("distinct_rows", 0)
    nbytes = rows * QP * 16 + C * (12 + 4 + 1) + C * K * 8
    flops = st["selecting"] * QP * 8
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    log(f"K1 device time {ms:.4f} ms (CUDA graph of 50 launches), wrapper "
        f"host time {host:.1f} us per call, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({by}: {rows} distinct rows), library: none (no single "
        f"PyTorch call computes distance + masked K-selection)")
    return {"max_abs_err": err, "ms": ms, "host_us": host, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "run_stats": st}


def check_k2(args, kw, tol: float = K2_TOL):
    """K2 against its plain version within `tol` (0: the same bits), with
    its time, the plain version's and the bound."""
    import torch
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain,
                                                     route)
    dist, valid, feats, bg = args
    R, SR = dist.shape
    outs_k = fused_march(*args)
    outs_p = fused_march_plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs_k, outs_p))
    err = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
    log(f"K2 fused_march ({route(SR, feats.shape[-1] - 1)} kernel) R={R} "
        f"SR={SR} C={feats.shape[-1] - 1}: max abs err {err:.3e}, the same "
        f"bits {same} (tolerance {tol})")
    if not (same if tol == 0 else err <= tol):
        fail("K2 disagrees with its plain version")
    ms = graph_ms(lambda: fused_march(*args))
    host = host_us(lambda: fused_march(*args))
    plain = cuda_ms(lambda: fused_march_plain(*args), iters=5)
    C = feats.shape[-1] - 1
    nbytes = R * SR * (4 + 1 + 4 * (C + 1)) + 4 * C \
        + R * C * 4 + R * SR * 4 + R * 4
    flops = R * SR * (6 + 3 * C)
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    log(f"K2 device time {ms:.4f} ms (CUDA graph of 50 launches), wrapper "
        f"host time {host:.1f} us per call, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({by}), library: none (no single PyTorch call "
        f"composites)")
    return {"max_abs_err": err, "ms": ms, "host_us": host, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def check_k3(captured, what: str = "request"):
    """K3 against its plain version on the decode inputs of every captured
    `what` (a request, a probe chunk or an eval chunk), in bf16 and in f32;
    times and bound on the first one's."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (TC_ROWS, fused_decode,
                                                      fused_decode_plain,
                                                      route)

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def worst_mean(a, b):
        return max(mean_rel(x, y) for x, y in zip(a, b))
    errs = {"bf16": 0.0, "f32": 0.0}
    rel, control = 0.0, float("inf")
    for i, (args, _kw) in enumerate(captured):
        feat, dists, extras, w, params, spec = args
        plain = {label: fused_decode_plain(feat, dists, extras, w, params,
                                           spec._replace(bf16=label == "bf16"))
                 for label in errs}
        for label, tol in (("bf16", K3_BF16_TOL), ("f32", K3_F32_TOL)):
            sp = spec._replace(bf16=label == "bf16")
            out = fused_decode(feat, dists, extras, w, params, sp)
            torch.cuda.synchronize()
            scale = max(float(t.abs().max()) for t in plain[label])
            if not scale > 0:
                fail(f"K3 ({label}): the plain decode is all zero")
            err = diff(out, plain[label])
            errs[label] = max(errs[label], err)
            if label == "bf16":
                m = worst_mean(out, plain[label])
                log(f"K3 fused_decode bf16, {what} {i}, M={feat.shape[0]} "
                    f"H={sp.H}: mean |err| / mean |plain| {m:.3e} (worst "
                    f"output), max abs err {err:.3e}")
                # the order-independent reference: the plain version with
                # its sums in f64, the same rounding points
                hold_k3_max(f"K3 bf16, {what} {i}", out, plain[label],
                            fused_decode_plain(feat, dists, extras, w,
                                               params, sp,
                                               dtype=torch.float64),
                            w, sp.K)
                rel = max(rel, m)
                control = min(control, worst_mean(plain["f32"],
                                                  plain["bf16"]))
            else:
                log(f"K3 fused_decode f32, {what} {i}, M={feat.shape[0]} "
                    f"H={sp.H}: max abs err {err:.3e}, scale max|plain| "
                    f"{scale:.3e} (tolerance {tol} x scale)")
                if not err <= tol * scale:
                    fail(f"K3 ({label}) disagrees with its plain version")
    hold_bf16(f"K3 bf16 vs plain over {len(captured)} {what}s, mean |err| / "
              f"mean |plain|, worst output", rel, control, K3_BF16_TOL)

    feat, dists, extras, w, params, spec = captured[0][0]
    M = feat.shape[0]
    res = {}
    for label in errs:
        sp = spec._replace(bf16=label == "bf16")
        ms = cuda_ms(lambda: fused_decode(feat, dists, extras, w, params, sp),
                     iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: fused_decode_plain(feat, dists, extras, w,
                                                      params, sp),
                           iters=3, warmup=1)
        rows, _nbytes, b, by = decode_bound(w, params, sp)
        log(f"K3 {label} ({route(sp)} kernel) time {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by}: {rows} of {M} rows "
            f"carry weight; tiles of {TC_ROWS} rows with weight: "
            f"{live_tiles(w != 0, TC_ROWS)}), library: none (no single "
            f"PyTorch call computes the decode)")
        res[label] = {"max_abs_err": errs[label], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": None}
    chain = gemm_chain_ms(spec, rows, backward=False)
    log(f"K3 yardstick (printed only, never called by the port): the same "
        f"layer products over {rows} rows as a bf16 torch.matmul chain "
        f"{chain:.4f} ms")
    res["bf16"]["gemm_chain_ms"] = chain
    return res


def gemm_chain_ms(spec, rows: int, backward: bool) -> float:
    """Time of the decode's layer products for `rows` rows as a chain of
    bf16 torch.matmul calls (cuBLAS): the forward's h = x W per layer, and
    with `backward` also g_h = g_z W^T and dW = act^T g_z per layer. A
    yardstick for K3 and K4 only: the port never calls it."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import layer_inputs
    g = torch.Generator(device="cuda").manual_seed(0)
    ins = layer_inputs(spec)
    Ws = [torch.randn((n, spec.H), generator=g, device="cuda",
                      dtype=torch.bfloat16) for n in ins]
    x = torch.randn((rows, max(ins)), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    gz = torch.randn((rows, spec.H), generator=g, device="cuda",
                     dtype=torch.bfloat16)

    def run():
        for n, W in zip(ins, Ws):
            torch.matmul(x[:, :n], W)
        if backward:
            for n, W in zip(ins, Ws):
                torch.matmul(gz, W.t())
                torch.matmul(x[:, :n].t(), gz)
    return cuda_ms(run, iters=5, warmup=2)


def kernel_wrappers():
    """{name: wrapper}; each wrapper counts its kernel launches in
    `.launches`."""
    from pointnerf_tpu_torch.ops.fused_decode import (fused_decode,
                                                      fused_decode_bwd)
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    from pointnerf_tpu_torch.ops.knn_select import knn_select
    return {"knn_select": knn_select, "fused_decode": fused_decode,
            "fused_march": fused_march, "fused_decode_bwd": fused_decode_bwd}


def main_path(params, pc, st, grid, reqs, cfg):
    import torch
    from pointnerf_tpu_torch.train.step import eval_step
    kernels = kernel_wrappers()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for i, batch in enumerate(reqs):
        before = {n: k.launches for n, k in kernels.items()}
        out = eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
        outs.append(out)
        for n, k in kernels.items():
            if n != "fused_decode_bwd" and k.launches <= before[n]:
                fail(f"request {i}: {n} was not launched")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    for i, out in enumerate(outs):
        col = out.coarse_raycolor
        if col.shape != (N_RAYS, 3) or not bool(torch.isfinite(col).all()):
            fail(f"request {i}: colors not finite or of shape {col.shape}")
        log(f"request {i}: rays hit {int(out.ray_mask.sum())}/{N_RAYS}, "
            f"decode_dropped {int(out.decode_dropped)}")
    n = len(reqs) * N_RAYS
    routes = kernel_routes(kernels, "serving")
    log(f"serving path: {len(reqs)} requests x {N_RAYS} rays in {dt:.4f} s = "
        f"{n / dt:.1f} rays/s (host clock, synchronized), launches {counts}, "
        f"routes {routes}")
    return counts, routes


def reset_counts(kernels):
    from pointnerf_tpu_torch.ops.fused_decode import reset_launches
    for k in kernels.values():
        k.launches = 0
    reset_launches()
    for name in ("knn_select", "fused_march"):
        routes = kernels[name].launches_by_route
        routes.update(dict.fromkeys(routes, 0))


# the route every launch of a main path takes: the decode kernels on the
# tensor cores (the main paths decode in bf16), K1 on its run path (K = 8)
MAIN_ROUTES = {"knn_select": "runs", "fused_decode": "tensor_core",
               "fused_decode_bwd": "tensor_core"}


def kernel_routes(kernels, path: str, march: str = "tiled",
                  k1: str = "runs"):
    """The launches of a main-path run by route; fails unless every one
    went to the route of MAIN_ROUTES, K1's to `k1` (the wide path on the
    tables of the reference ScanNet scenes) and K2's to `march`."""
    want = {**MAIN_ROUTES, "knn_select": k1}
    routes = {n: dict(kernels[n].launches_by_route) for n in MAIN_ROUTES}
    for n, r in routes.items():
        if r[want[n]] != kernels[n].launches \
                or sum(r.values()) != kernels[n].launches:
            fail(f"{path} path: {n} launches went to another route than "
                 f"{want[n]}: {r}")
    routes["fused_march"] = march_routes(kernels, path, march)
    return routes


def march_routes(kernels, path: str, want: str = "tiled"):
    """K2's launches of a main-path run by kernel; fails unless every one
    went to `want` (the tiled kernel at C <= 8, the wide one at C = 128)."""
    k = kernels["fused_march"]
    r = dict(k.launches_by_route)
    if r[want] != k.launches or sum(r.values()) != k.launches:
        fail(f"{path} path: fused_march launches went to another kernel "
             f"than the {want} one: {r}")
    return r


def same_integers(o_card, o_cpu):
    """Fail unless two renders agree on every integer output."""
    import torch
    for f in ("ray_valid", "ray_mask", "decode_dropped"):
        a, b = getattr(o_card, f), getattr(o_cpu, f)
        if a is None and b is None:       # the dense decode drops nothing
            continue
        if a is None or b is None or not torch.equal(a.cpu(), b):
            fail(f"{f} differs between the card and the CPU")
    pk, pc_ = o_card.neighbor_pidx.cpu(), o_cpu.neighbor_pidx
    bad_rows = (pk != pc_).any(-1).nonzero()[:, 0].tolist()
    if bad_rows:
        # an equal id set in another order can only come from a d2 tie
        for r in bad_rows[:20]:
            tie = sorted(pk[r].tolist()) == sorted(pc_[r].tolist())
            log(f"  slot {r}: card {pk[r].tolist()} cpu {pc_[r].tolist()} "
                f"({'same set: a d2 tie' if tie else 'different sets'})")
        fail(f"neighbor ids differ between the card and the CPU in "
             f"{len(bad_rows)} slots")


def cpu_parity(params, pc, st, grid, cfg, cfg_cpu=None, b_card=None,
               bar=COLOR_BF16_TOL):
    """One 512-ray request on the card and on the CPU (plain versions); the
    control renders it on the CPU with an f32 decode. `cfg_cpu` (default
    `cfg`) is the CPU side's config: with the fused flags set it runs the
    kernels' plain versions, which the card's kernels follow whatever the
    flags say. `b_card` (default a ring view's 512 rays) is the request.
    Integers must be equal and the colors of the rays that hit within
    `bar`."""
    err, ctl, _m, _mctl, n_hit = request_parity(
        params, pc, st, grid, cfg, cpu_scene(pc, st, grid, cfg),
        "the parity request", cfg_cpu=cfg_cpu, b_card=b_card)
    log(f"card vs CPU, 512 rays: integers equal, neighbor-id mismatches 0, "
        f"{n_hit} rays hit")
    hold_bf16("card vs CPU colors of the rays that hit", err, ctl, bar)


def cpu_scene(pc, st, grid, cfg):
    """A scene on the CPU, its grid rebuilt there and its tables checked
    against the card's."""
    import torch
    from pointnerf_tpu_torch.ops.grid import build_grid
    mv = lambda t: t.cpu()  # noqa: E731
    pc_c, st_c = type(pc)(*[mv(t) for t in pc]), type(st)(*[mv(t) for t in st])
    q = dataclasses.replace(cfg.query, max_d=grid.nbr_pid.shape[0])
    grid_c = build_grid(pc_c.xyz, st_c.num_active, q)
    for f in ("vox_dslot", "nbr_pid", "nbr_xyz", "vox_occ"):
        if not torch.equal(getattr(grid_c, f), mv(getattr(grid, f))):
            fail(f"grid table {f} differs between the card and the CPU")
    return pc_c, st_c, grid_c


def request_parity(params, pc, st, grid, cfg, scene_c, what: str,
                   cfg_cpu=None, b_card=None):
    """A request (default a ring view's 512 rays) on the card and on the
    CPU (`scene_c`, from `cpu_scene`; `cfg_cpu`, default `cfg`), and the
    control, the CPU with an f32 decode: integers equal. Returns (max
    |err|, its control, mean |err| / mean |CPU|, its control, rays hit)
    over the colors of the rays that hit."""
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import eval_step
    cfg_cpu = cfg_cpu or cfg
    pc_c, st_c, grid_c = scene_c
    params_c = tree_map(lambda t: t.cpu(), params)
    if b_card is None:
        b_card = batches(cfg, 512, 1, "cuda", seed0=7)[0]
    b_cpu = type(b_card)(*[None if t is None else t.cpu() for t in b_card])
    o_card = eval_step({"mlp": params, "points": pc}, st, grid, b_card, cfg)
    o_cpu = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg_cpu)
    same_integers(o_card, o_cpu)
    o_ctl = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg_cpu.replace(train=dataclasses.replace(
                          cfg_cpu.train, compute_dtype="f32")))
    hit = o_cpu.ray_mask
    if not bool(hit.any()):
        fail(f"{what}: no ray hits the scene")
    col, ref = o_card.coarse_raycolor.cpu()[hit], o_cpu.coarse_raycolor[hit]
    ctl = o_ctl.coarse_raycolor[hit]
    return (float((col - ref).abs().max()), float((col - ctl).abs().max()),
            mean_rel(col, ref), mean_rel(col, ctl), int(hit.sum()))


def capture_k4_inputs(state, st, grid, batch, cfg):
    """Take one training step with a recording wrapper around K4's entry
    point; returns its arguments as the step's backward called it."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.step import train_step
    real, seen = fd.fused_decode_bwd, []

    def rec(*a, **k):
        seen.append(a)
        fd.fused_decode_bwd = real      # the wrapper counts on its own name
        return real(*a, **k)
    fd.fused_decode_bwd = rec
    try:
        train_step(state, st, grid, batch, cfg)
    finally:
        fd.fused_decode_bwd = real
    if len(seen) != 1:
        fail(f"a training step called the decode backward {len(seen)} times")
    return seen[0]


@contextlib.contextmanager
def recording_decode():
    """Recording wrappers around K3's entry point (as the aggregator calls
    it) and K4's (as the autograd Function's backward calls it); yields
    {"fused_decode": args, "fused_decode_bwd": args} of the last calls,
    and under "all" {name: [args, ...]} of every call in order."""
    from pointnerf_tpu_torch.models import aggregator
    from pointnerf_tpu_torch.ops import fused_decode as fd
    seen = {"all": {}}
    real_fwd, real_bwd = aggregator.fused_decode, fd.fused_decode_bwd

    def fwd(*a, **k):
        seen["fused_decode"] = a
        seen["all"].setdefault("fused_decode", []).append(a)
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        seen["fused_decode_bwd"] = a
        seen["all"].setdefault("fused_decode_bwd", []).append(a)
        fd.fused_decode_bwd = real_bwd  # the wrapper counts on its own name
        try:
            return real_bwd(*a, **k)
        finally:
            fd.fused_decode_bwd = bwd
    aggregator.fused_decode, fd.fused_decode_bwd = fwd, bwd
    try:
        yield seen
    finally:
        aggregator.fused_decode, fd.fused_decode_bwd = real_fwd, real_bwd


def decode_grad_leaves(out):
    """(names, tensors) of a decode backward's result: the row gradients,
    then every dW/db in parameter order."""
    g_feat, g_dists, g_extras, g_w, gp = out
    names = ["g_feat", "g_dists", "g_extras", "g_w"]
    leaves = [g_feat, g_dists, g_extras, g_w]
    for blk in ("block1", "block3", "alpha"):
        for i, layer in enumerate(gp[blk]):
            for n in ("w", "b"):
                names.append(f"d{blk}[{i}].{n}")
                leaves.append(layer[n])
    return names, leaves


def check_k4(args, what: str = "train step", hold_largest=None):
    """K4 against its plain version on the inputs of a real training step,
    in bf16 and in f32, on the row gradients and every dW/db (each relative
    to its own max|plain|): f32 within K4_F32_TOL; bf16 on the worst mean
    error (K4_BF16_TOL, control the f32 plain version) and on each
    gradient's largest error, held by `hold_largest(what, args, spec,
    names, kernel, plain)` (by default `hold_max`, against the plain
    version summed in f64), whose return goes under "largest"; two calls
    the same bits in each rounding; times and bound in each precision."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (TC_ROWS_BWD,
                                                      fused_decode_bwd,
                                                      fused_decode_bwd_plain,
                                                      layer_inputs, route)
    feat, dists, extras, w, params, spec, g_fagg, g_alpha = args
    M = feat.shape[0]

    def run(fn, sp, **kw):
        return decode_grad_leaves(fn(feat, dists, extras, w, params, sp,
                                     g_fagg, g_alpha, **kw))

    specs = {label: spec._replace(bf16=label == "bf16")
             for label in ("bf16", "f32")}
    res = {}
    with torch.no_grad():
        names, plain32 = run(fused_decode_bwd_plain, specs["f32"])
        _, plain16 = run(fused_decode_bwd_plain, specs["bf16"])
        control = max(mean_rel(a, b) for a, b in zip(plain32, plain16))
        for label, plain in (("bf16", plain16), ("f32", plain32)):
            sp = specs[label]
            _, out = run(fused_decode_bwd, sp)
            _, again = run(fused_decode_bwd, sp)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            del again
            rel = []
            for a, b in zip(out, plain):
                scale = float(b.abs().max())
                if not scale > 0:
                    fail(f"K4 ({what}): a gradient of the plain backward is "
                         f"all zero")
                rel.append(float((a - b).abs().max()) / scale)
            i = max(range(len(rel)), key=rel.__getitem__)
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(out, plain))
            log(f"K4 fused_decode_bwd {label} ({route(sp, backward=True)} "
                f"kernel), {what}, M={M} H={sp.H} K={sp.K}: max abs err "
                f"{abs_err:.3e}, {rel[i]:.3e} of its gradient's max|plain| "
                f"({names[i]}); two calls on the same inputs give the same "
                f"bits in every gradient: {same}")
            if not same:
                fail(f"K4 ({label}, {what}) is not deterministic run to run")
            res[label] = {"max_abs_err": abs_err, "max_rel_err": rel[i],
                          "two_calls_same_bits": same}
            if label == "f32":
                if not rel[i] <= K4_F32_TOL:
                    fail(f"K4 (f32, {what}) disagrees with its plain version")
                continue
            means = [mean_rel(a, b) for a, b in zip(out, plain)]
            j = max(range(len(means)), key=means.__getitem__)
            hold_bf16(f"K4 bf16 vs plain, {what}, mean |err| / mean |plain|, "
                      f"worst gradient ({names[j]})", means[j], control,
                      K4_BF16_TOL)
            if hold_largest is None:
                _, plain64 = run(fused_decode_bwd_plain, sp,
                                 dtype=torch.float64)
                hold_max(f"K4 bf16, {what}", names, out, plain, plain64,
                         K4_F32_TOL)
                del plain64
            else:
                res[label]["largest"] = hold_largest(
                    f"K4 bf16, {what}", args, sp, names, out, plain)
            del out
        del plain32, plain16

        # K4's tiles that are computed: a live row, or a live upstream
        # gradient on the tile's groups
        tuned_tc = route(specs["bf16"], backward=True) == "tensor_core"
        if tuned_tc:
            live = ((w != 0).view(-1)
                    | ((g_fagg != 0).any(1) | (g_alpha != 0).view(-1))
                    .repeat_interleave(spec.K))
            log(f"K4 tiles of {TC_ROWS_BWD} rows computed (not dead): "
                f"{live_tiles(live, TC_ROWS_BWD)}")
        for label, sp in specs.items():
            ms = cuda_ms(lambda: fused_decode_bwd(feat, dists, extras, w,
                                                  params, sp, g_fagg,
                                                  g_alpha),
                         iters=3, warmup=1)
            plain_ms = cuda_ms(lambda: fused_decode_bwd_plain(
                feat, dists, extras, w, params, sp, g_fagg, g_alpha),
                iters=3, warmup=1)
            rows, nbytes, b, by = decode_bound(w, params, sp, backward=True)
            log(f"K4 {label} ({route(sp, backward=True)} kernel), {what}, "
                f"time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} "
                f"ms ({by}: {rows} of {M} rows carry weight; bytes alone "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), library: none "
                f"(no single PyTorch call computes the decode backward)")
            if sp.bf16 and tuned_tc:
                # a cost of the tensor-core K4's design, not of its function
                # (so not in the bound): its second phase takes dW from
                # every live row's layer inputs and g_z (bf16), written to
                # device memory once and read once
                phase_b = rows * 2 * 2 * (sum(layer_inputs(spec))
                                          + (spec.L1 + spec.L3) * spec.H)
                log(f"K4 bf16 design cost, outside the bound: phase B moves "
                    f"{phase_b / 1e9:.3f} GB of bf16 layer inputs and g_z "
                    f"through device memory, "
                    f"{phase_b / HBM_BYTES_PER_S * 1e3:.4f} ms at "
                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
            res[label].update({"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b, "bound_by": by,
                               "library_ms": None})
    chain = gemm_chain_ms(spec, rows, backward=True)
    log(f"K4 yardstick (printed only, never called by the port): the same "
        f"layer products (forward, g_z W^T, act^T g_z) over {rows} rows as a "
        f"bf16 torch.matmul chain {chain:.4f} ms")
    res["bf16"]["gemm_chain_ms"] = chain
    return res


def train_path(state, st, grid, batch, cfg):
    """bench.py's loop: 3 warm-up and 20 timed train steps on one batch.
    Every step must launch K1, K3 and K4 once each; the loss must be finite
    and fall. Returns (launch counts, final state)."""
    import torch
    from pointnerf_tpu_torch.train.step import train_step
    kernels = kernel_wrappers()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, dropped = [], []
    for i in range(N_TRAIN_WARMUP + N_TRAIN_STEPS):
        if i == N_TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = {n: kernels[n].launches for n in TRAIN_KERNELS}
        state, items = train_step(state, st, grid, batch, cfg)
        for n in TRAIN_KERNELS:
            if kernels[n].launches != before[n] + 1:
                fail(f"train step {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not once")
        losses.append(items["loss_total"])
        dropped.append(items["n_decode_dropped"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "training")
    if counts["fused_march"]:
        fail("training launched the fused march (JAX trains through the "
             "plain march)")
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        fail(f"a training loss is not finite: {losses.tolist()}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    log(f"train losses {[round(float(v), 6) for v in losses]}")
    log(f"train: mean loss of the first 5 steps {first:.6f}, of the last 5 "
        f"{last:.6f}; decode_dropped per step "
        f"{sorted(set(int(d) for d in dropped))}")
    if not last < first:
        fail("the training loss did not fall")
    rate = N_TRAIN_STEPS * N_RAYS / dt
    log(f"train path: {N_TRAIN_STEPS} steps x {N_RAYS} rays after "
        f"{N_TRAIN_WARMUP} warm-up steps in {dt:.4f} s = {rate:.1f} train "
        f"rays/s (fwd + bwd + Adam, host clock, synchronized), launches "
        f"{counts}, routes {routes}")
    return counts, routes, state


def named_leaves(tree, name=""):
    """(path, leaf) of a gradient tree in tree_leaves order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in named_leaves(tree[k], f"{name}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{name}[{i}]")]
    return [(name, tree)]


def train_grads(state, st, grid, cfg, seed0: int = 11, b_card=None,
                draws=None):
    """The loss and gradients of one 512-ray training step from `state` on
    the card and on the CPU (plain versions), with the same jitter draw (and
    the same fine / hybrid `draws`, CPU tensors, when given), and the
    control: the CPU with an f32 decode. `b_card` (default a ring view's
    512 rays) is the batch. Fails unless the card and the CPU agree on
    every integer. The CPU runs with the fused flags set (the kernels'
    plain versions, which the card's kernels follow whatever the flags
    say). Returns {"card" | "cpu" | "control": (loss, grads)}."""
    import torch
    from pointnerf_tpu_torch.models.renderer import render_rays
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import loss_and_grads
    cpu = torch.device("cpu")
    params_c = tree_map(lambda t: t.to(cpu), state.params)
    st_c = type(st)(*[t.to(cpu) for t in st])
    grid_c = type(grid)(*[None if t is None else t.to(cpu) for t in grid])
    dev = state.step.device
    flags = cfg.replace(
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))
    if b_card is None:
        b_card = batches(cfg, 512, 1, dev, seed0=seed0)[0]
    b_cpu = type(b_card)(*[None if t is None else t.to(cpu) for t in b_card])
    R = b_card.raydir.shape[0]
    u = torch.rand((R, cfg.query.z_depth_dim),
                   generator=torch.Generator().manual_seed(3))
    d_cpu = draws
    d_card = None if draws is None else {k: v.to(dev)
                                         for k, v in draws.items()}
    with torch.no_grad():
        o_card = render_rays(state.params["mlp"], state.params["points"], st,
                             grid, b_card, cfg, train=True, u=u.to(dev),
                             draws=d_card)
        o_cpu = render_rays(params_c["mlp"], params_c["points"], st_c, grid_c,
                            b_cpu, flags, train=True, u=u, draws=d_cpu)
    same_integers(o_card, o_cpu)
    t_card, i_card, g_card = loss_and_grads(state.params, st, grid, b_card,
                                            cfg, u=u.to(dev), draws=d_card)
    t_cpu, i_cpu, g_cpu = loss_and_grads(params_c, st_c, grid_c, b_cpu,
                                         flags, u=u, draws=d_cpu)
    cfg32 = flags.replace(train=dataclasses.replace(flags.train,
                                                    compute_dtype="f32"))
    t_ctl, _i, g_ctl = loss_and_grads(params_c, st_c, grid_c, b_cpu, cfg32,
                                      u=u, draws=d_cpu)
    for k in ("n_miss", "n_decode_dropped"):
        if int(i_card[k]) != int(i_cpu[k]):
            fail(f"train step: {k} differs between the card and the CPU")
    dcol = (o_card.coarse_raycolor.cpu() - o_cpu.coarse_raycolor).abs().amax(-1)
    r = int(dcol.argmax())
    log(f"card vs CPU train render (printed): largest color difference "
        f"{float(dcol[r]):.3e} on ray {r} (hit {bool(o_cpu.ray_mask[r])}); "
        + ", ".join(f"{k} {float(i_card[k]):.6e} vs {float(i_cpu[k]):.6e}"
                    for k in i_cpu if k.startswith("loss_")))
    log(f"card vs CPU train step, {R} rays: integers equal, "
        f"{int(o_cpu.ray_mask.sum())} rays hit, loss {float(t_cpu):.6f}")
    return {"card": (t_card, g_card), "cpu": (t_cpu, g_cpu),
            "control": (t_ctl, g_ctl)}


def grad_groups(grads):
    """The gradient groups held apart: the aggregator's MLPs ("mlp"), the
    point payloads ("points") and, with the hybrid, the radiance field
    ("nerf", which shares the "mlp" optimizer group)."""
    mlp = grads["mlp"]
    out = {"mlp": {k: v for k, v in mlp.items() if k != "nerf"},
           "points": grads["points"]}
    if "nerf" in mlp:
        out["nerf"] = mlp["nerf"]
    return out


def grad_readings(grads, ref):
    """Per group of a gradient tree (`grad_groups`) against `ref`'s: the
    group's sum |g - ref| / sum |ref| over all its leaves, and its worst
    leaf's mean |g - ref| / mean |ref| and max |g - ref| / max |ref|, each
    as (value, leaf name)."""
    from pointnerf_tpu_torch.train.optim import tree_leaves
    out = {}
    grads, ref = grad_groups(grads), grad_groups(ref)
    for grp in ref:
        num = den = 0.0
        worst_mean, worst_max = (0.0, ""), (0.0, "")
        for a, (name, b) in zip(tree_leaves(grads[grp]),
                                named_leaves(ref[grp])):
            a = a.to(b.device)
            num += float((a - b).abs().sum())
            den += float(b.abs().sum())
            scale = float(b.abs().max())
            if scale == 0:
                if float(a.abs().max()) != 0:
                    fail(f"train step: gradient {grp}{name} is zero on the "
                         f"CPU only")
                continue
            worst_mean = max(worst_mean, (mean_rel(a, b), grp + name))
            worst_max = max(worst_max,
                            (float((a - b).abs().max()) / scale, grp + name))
        out[grp] = (num / den, worst_mean, worst_max)
    return out


def train_cpu_parity(state, st, grid, cfg, b_card=None, draws=None,
                     loss_bar=LOSS_BF16_TOL, grad_bars=None):
    """The loss and gradients of one 512-ray training step on the card
    against the CPU's, each beside its control (the CPU with an f32
    decode); `b_card` and `draws` as for `train_grads`, the loss within
    `loss_bar`, each gradient group within `grad_bars` (default
    GRAD_BF16_TOL)."""
    grad_bars = grad_bars or GRAD_BF16_TOL
    r = train_grads(state, st, grid, cfg, b_card=b_card, draws=draws)
    (t_card, g_card), (t_cpu, g_cpu), (t_ctl, g_ctl) = (
        r["card"], r["cpu"], r["control"])
    hold_bf16("card vs CPU train loss, relative",
              abs(float(t_card) - float(t_cpu)) / abs(float(t_cpu)),
              abs(float(t_ctl) - float(t_cpu)) / abs(float(t_cpu)),
              loss_bar)
    card, ctl = grad_readings(g_card, g_cpu), grad_readings(g_ctl, g_cpu)
    for grp in card:
        (l1, (m, m_leaf), (mx, mx_leaf)), (c_l1, (cm, _), (cmx, _)) = (
            card[grp], ctl[grp])
        log(f"card vs CPU {grp} gradients (printed only): sum |err| / sum "
            f"|CPU| {l1:.3e} (control {c_l1:.3e}), worst leaf's mean |err| / "
            f"mean |CPU| {m:.3e} ({m_leaf}; control {cm:.3e}), worst leaf's "
            f"max |err| / max|CPU| {mx:.3e} ({mx_leaf}; control {cmx:.3e})")
    for grp in card:
        hold_bf16(f"card vs CPU {grp} gradients, sum |err| / sum |CPU| over "
                  f"the group's leaves", card[grp][0], ctl[grp][0],
                  grad_bars[grp])


# ---- the maintenance path: train_scene with prune, grow, split, eval and
# a checkpoint, then a resume -------------------------------------------
MAINT_STEPS = 40
MAINT_RESUME_TO = 44
MAINT_WH = (256, 256)
MAINT_VIEWS = 8
# the points within this angle of the probe view's silhouette are cut: a
# grazing ray then passes r (1 - cos 25 deg) = 0.047 from the nearest point
# left, beyond the KNN radius (4 voxels of 0.008), so it misses
SILHOUETTE_BAND_DEG = 25.0


def maintenance_config(cfg):
    """slice_config with a schedule that fires every maintenance event
    within MAINT_STEPS steps of 3,600 rays: prunes at 10/20/30/40, probes at
    15/30, splits at 20/40, an eval at 35, a checkpoint at 25 (and the final
    one at 40)."""
    # the weights are random, so the probe's peak opacities are not on a
    # trained scene's scale (the run prints them) and the reference's 0.7
    # would decide nothing: with prob_thresh 0 every hit ray next to a hole
    # grows (the threshold test itself is held against JAX on the CPU,
    # tests/test_torch_driver.py)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=MAINT_STEPS, prune_iter=10,
        prune_max_iter=MAINT_STEPS, prune_thresh=0.1, prob_freq=15,
        prob_num_step=1, prob_thresh=0.0, split_iter=20, split_top=1024,
        test_freq=35, save_iter_freq=25, print_freq=5,
        random_sample_size=60))


def maintenance_scene():
    """The 65,536-point sphere_scene (seed 0) with a band around the probe
    view's silhouette cut away, every 8th remaining point's conf below
    prune_thresh (0.05; the rest 0.5), and the ring of MAINT_VIEWS views:
    training batches of 3,600 rays from every view, the probe frame is view
    0, the test frame view 4."""
    import numpy as np
    from pointnerf_tpu_torch.data.synthetic import (ring_cameras, sphere_scene,
                                                    view_ray_batch)
    xyz, color, normals = sphere_scene(n_pts=N_POINTS, seed=0)
    views = ring_cameras(n_views=MAINT_VIEWS, wh=MAINT_WH)
    d = float(np.linalg.norm(views[0][0]))
    ang = np.arccos(np.clip(normals @ (views[0][0] / d), -1.0, 1.0))
    keep = np.abs(ang - np.arccos(0.5 / d)) > np.radians(SILHOUETTE_BAND_DEG)
    xyz, color, normals = xyz[keep], color[keep], normals[keep]
    conf = np.full((xyz.shape[0], 1), 0.5, np.float32)
    conf[::8] = 0.05

    def train_item(step):
        v = step % MAINT_VIEWS
        return view_ray_batch(*views[v], MAINT_WH, n_rays=N_RAYS, seed=step,
                              view_id=v)
    probe = [view_ray_batch(*views[0], MAINT_WH, view_id=0)]
    test = [view_ray_batch(*views[4], MAINT_WH, view_id=4)]
    return (xyz, color, normals), conf, train_item, probe, test


class MaintRecorder:
    """Wraps the driver's and grow module's entry points for one run of
    train_scene: times each event on the device's clock (synchronized),
    checks what each event did against the state just before it, counts
    each train step's and each rendered chunk's kernel launches, and
    records the K1, K3 and K2 inputs of one dense probe chunk and of one
    eval chunk."""

    def __init__(self, cfg, kernels, train_kernels=TRAIN_KERNELS,
                 render_kernels=RENDER_KERNELS, record_step=None,
                 chunk_launches=None):
        import torch
        from pointnerf_tpu_torch.train import driver as td, grow as tg
        self.torch, self.td, self.tg = torch, td, tg
        self.cfg, self.kernels = cfg, kernels
        # the kernels each train step and each rendered chunk launch once
        self.train_kernels, self.render_kernels = train_kernels, render_kernels
        # the launches each rendered chunk makes per kernel (default once)
        self.chunk_launches = dict(dict.fromkeys(render_kernels, 1),
                                   **(chunk_launches or {}))
        # the train step (1-based) whose K3 and K4 inputs are recorded
        self.record_step = record_step
        self.step_inputs = None   # {"fused_decode": args, "fused_decode_bwd": args}
        self.times = {k: [] for k in ("prune", "probe_frame", "grow", "split",
                                      "grid_refresh", "eval_frame",
                                      "checkpoint_save", "checkpoint_load",
                                      "train_step")}
        self.log = []            # (event, detail) in order
        self.maps = None         # the first probe frame's maps
        self.last_maps = None    # the latest probe frame's maps
        self.probe_item = None
        self.first_probe = None  # (params, st, grid) the first probe saw
        # {"probe_chunk" | "eval_chunk": {kernel: (args, kwargs)}}
        self.captured = {}
        self.saved = None        # the state the last checkpoint holds
        self.losses = []
        self._orig = []
        self._chunk = self._chunks = 0   # the chunk of the frame rendering

    def _patch(self, mod, name, fn):
        self._orig.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def restore(self):
        for mod, name, real in reversed(self._orig):
            setattr(mod, name, real)
        self._orig.clear()

    def _timed(self, key, fn, *a, **k):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        self.times[key].append(time.perf_counter() - t0)
        return out

    def install(self):
        td, tg = self.td, self.tg
        for name in ("apply_prune", "probe_hole", "apply_grow",
                     "split_high_grad", "refresh_grid", "train_step",
                     "save_checkpoint", "load_checkpoint",
                     "render_full_frame"):
            self._patch(td, name, getattr(self, name)(getattr(td, name)))
        self._patch(tg, "render_full_frame",
                    self.probe_frame(tg.render_full_frame))
        self._patch(tg, "eval_step", self.chunk(tg.eval_step))

    # -- events ---------------------------------------------------------
    def apply_prune(self, real):
        def run(state, st, cfg):
            n = int(st.num_active)
            conf = state.params["points"].conf[:n, 0]
            expect = int((conf > cfg.train.prune_thresh).sum())
            state, st, kept = self._timed("prune", real, state, st, cfg)
            if kept != expect or int(st.num_active) != expect:
                fail(f"prune kept {kept} of {n} points; {expect} had conf > "
                     f"{cfg.train.prune_thresh}")
            self.log.append(("prune", (n, kept)))
            return state, st, kept
        return run

    def probe_hole(self, real):
        def run(params, st, grid, *a, **k):
            if self.first_probe is None:
                self.first_probe = (params, st, grid)
            cand = real(params, st, grid, *a, **k)
            self.log.append(("probe", cand.xyz.shape[0]))
            return cand
        return run

    def probe_frame(self, real):
        def run(params, st, grid, cfg, item, wh, chunk=2304, prob=True):
            self._chunk = 0
            self._chunks = -(-len(item["raydir"]) // chunk)
            maps = self._timed("probe_frame", real, params, st, grid, cfg,
                               item, wh, chunk, prob)
            import numpy as np
            W, H = wh
            gt = np.zeros((H, W, 3), np.float32)
            pix = np.asarray(item["pixel_idx"], np.int64)
            gt[pix[:, 1], pix[:, 0]] = item["gt_image"]
            bg = np.asarray(cfg.render.bg_color, np.float32)
            miss = (~maps["ray_mask"][..., 0]
                    & (np.linalg.norm(gt - bg, axis=-1) > 0.002))
            self.log.append(("probe_frame", int(miss.sum())))
            peak = maps["ray_max_shading_opacity"][maps["ray_mask"][..., 0]]
            log(f"probe frame: {int(miss.sum())} rays miss where the ground "
                f"truth is the sphere; peak opacity of the hit rays: max "
                f"{float(peak.max()):.4f}, median "
                f"{float(np.median(peak)):.4f}")
            self.last_maps = maps
            if self.maps is None:
                self.maps, self.probe_item = maps, item
                if not miss.any():
                    fail("the first probe frame has no hole: no ray misses "
                         "the cloud where the ground truth is the sphere")
            return maps
        return run

    def render_full_frame(self, real):
        def run(params, st, grid, cfg, item, wh, chunk=2304, prob=True):
            self._chunk = 0
            self._chunks = -(-len(item["raydir"]) // chunk)
            return self._timed("eval_frame", real, params, st, grid, cfg,
                               item, wh, chunk, prob)
        return run

    def chunk(self, real):
        """Every rendered chunk (probe or eval) launches K1, K3 and K2 as
        often as `chunk_launches` says (once each by default); the middle
        chunk of the first probe frame and of the first
        eval frame records the three kernels' inputs."""
        def run(params, st, grid, batch, cfg, prob=False):
            kind = "probe_chunk" if prob else "eval_chunk"
            before = {n: self.kernels[n].launches
                      for n in self.render_kernels}
            record = (kind not in self.captured
                      and self._chunk == self._chunks // 2)
            with (recording_kernels() if record
                  else contextlib.nullcontext()) as seen:
                out = real(params, st, grid, batch, cfg, prob=prob)
            if record:
                self.captured[kind] = all_recorded(seen, f"a {kind}",
                                                   self.render_kernels)
            self._chunk += 1
            for n in self.render_kernels:
                want = self.chunk_launches[n]
                if self.kernels[n].launches != before[n] + want:
                    fail(f"a {'probe' if prob else 'eval'} chunk launched {n} "
                         f"{self.kernels[n].launches - before[n]} times, not "
                         f"{want}")
            return out
        return run

    def apply_grow(self, real):
        """A grown point sits at a hit ray's max-opacity sample, which has a
        neighbor within the KNN radius: each lies within that radius of the
        cloud before the grow, and the first grow's (before any split, from
        points on the sphere) within it of the sphere's radius."""
        def run(state, st, cand, cfg):
            torch = self.torch
            n = int(st.num_active)
            old = state.params["points"].xyz[:n]
            state, st, added = self._timed("grow", real, state, st, cand, cfg)
            self.log.append(("grow", (n, added)))
            if added:
                new = state.params["points"].xyz[n:n + added]
                near = float(torch.cdist(
                    new, old, compute_mode="donot_use_mm_for_euclid_dist")
                    .amin(1).max())
                shell = float((torch.linalg.norm(new, dim=-1) - 0.5).abs()
                              .max())
                r = cfg.query.radius_limit
                first = not any(e == "grow_shell" for e, _d in self.log)
                self.log.append(("grow_shell", (near, shell)))
                log(f"grow: {added} points, the farthest {near:.5f} from the "
                    f"cloud before it and {shell:.5f} from the sphere's "
                    f"radius (KNN radius {r})")
                if not near <= r * (1 + 1e-5):
                    fail(f"a grown point lies {near:.5f} from the cloud, "
                         f"beyond the KNN radius {r}")
                if first and not shell <= r * (1 + 1e-5):
                    fail(f"a point of the first grow lies {shell:.5f} from the "
                         f"sphere, beyond the KNN radius {r}")
            return state, st, added
        return run

    def split_high_grad(self, real):
        def run(state, st, cfg):
            n = int(st.num_active)
            state, st, added = self._timed("split", real, state, st, cfg)
            self.log.append(("split", (n, added)))
            return state, st, added
        return run

    def refresh_grid(self, real):
        def run(pc, st, cfg, max_d=None):
            grid, used = self._timed("grid_refresh", real, pc, st, cfg,
                                     max_d=max_d)
            self.log.append(("grid", (max_d, used, int(st.num_active))))
            return grid, used
        return run

    def train_step(self, real):
        def run(state, st, grid, batch, cfg):
            before = {n: self.kernels[n].launches
                      for n in self.train_kernels}
            record = len(self.times["train_step"]) + 1 == self.record_step
            with (recording_decode() if record
                  else contextlib.nullcontext()) as seen:
                state, items = self._timed("train_step", real, state, st,
                                           grid, batch, cfg)
            if record:
                self.step_inputs = seen
            for n in self.train_kernels:
                if self.kernels[n].launches != before[n] + 1:
                    fail(f"a maintenance-path train step launched {n} "
                         f"{self.kernels[n].launches - before[n]} times")
            self.losses.append(items["loss_total"])
            return state, items
        return run

    def save_checkpoint(self, real):
        def run(root, state, meta=None):
            path = self._timed("checkpoint_save", real, root, state, meta)
            self.saved = (path, state, self.torch.clone(state.key.get_state()))
            self.log.append(("save", path))
            return path
        return run

    def load_checkpoint(self, real):
        def run(path, template):
            state, meta = self._timed("checkpoint_load", real, path, template)
            self.log.append(("load", path))
            if self.saved is None or self.saved[0] != path:
                fail(f"resumed from {path}, not the last checkpoint written")
            same_state(state, self.saved[1], self.saved[2])
            return state, meta
        return run


def same_state(a, b, key_state):
    """Fail unless two TrainStates are equal bit for bit: parameters,
    moments and counts, hit counters, step, and the generator state."""
    import torch
    from pointnerf_tpu_torch.train.optim import tree_leaves
    la = tree_leaves([a.params, a.opt_state, a.step, a.hits])
    lb = tree_leaves([b.params, b.opt_state, b.step, b.hits])
    if len(la) != len(lb):
        fail("the loaded state has another structure than the saved one")
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if x.shape != y.shape or x.dtype != y.dtype
           or not torch.equal(x.reshape(-1).view(torch.uint8),
                              y.reshape(-1).view(torch.uint8))]
    if bad or not torch.equal(a.key.get_state(), key_state):
        fail(f"the loaded state differs from the saved one (leaves {bad}, "
             f"generator {torch.equal(a.key.get_state(), key_state)})")
    log(f"checkpoint: the loaded state equals the saved one bit for bit "
        f"({len(la)} tensors, step {int(a.step)}, the generator state)")


def check_maintenance_log(rec: MaintRecorder):
    """Every point-set change is followed by a grid rebuild with the table
    size the previous build settled on and the new point count; each event
    kind fired."""
    last_max_d, pending = None, None
    kinds = {}
    for ev, detail in rec.log:
        kinds[ev] = kinds.get(ev, 0) + 1
        if ev == "grid":
            max_d, used, n = detail
            if last_max_d is not None and max_d != last_max_d:
                fail(f"a grid rebuild took max_d={max_d}, not the carried "
                     f"{last_max_d}")
            if pending is not None and n != pending:
                fail(f"the grid was rebuilt at {n} points, not {pending}")
            last_max_d, pending = used, None
        elif ev == "load":
            last_max_d = None       # a new run builds from the config
        elif ev in ("prune", "grow", "split"):
            if pending is not None:
                fail(f"a {ev} came before the grid was rebuilt")
            n, after = detail
            if ev == "prune" or after:
                pending = after if ev == "prune" else n + after
    if pending is not None:
        fail("the last point-set change was not followed by a grid rebuild")
    grows = [d for e, d in rec.log if e == "grow"]
    splits = [d for e, d in rec.log if e == "split"]
    if not grows or not grows[0][1] > 0:
        fail(f"the first probe grew no point: {grows}")
    if not any(a > 0 for _n, a in splits):
        fail(f"no split added a point: {splits}")
    for ev in ("prune", "probe", "grow", "split", "save", "load"):
        if not kinds.get(ev):
            fail(f"the maintenance path never ran a {ev}")
    if not rec.times["eval_frame"]:
        fail("the maintenance path never evaluated a frame")
    return kinds


def window_parity(cfg, rec: MaintRecorder):
    """A 16 x 16 window of the first probe frame around a hole's edge,
    rendered with the probe outputs from the state that probe saw, on the
    card and on the CPU (plain versions):
    neighbor ids and masks equal, the argmax sample equal on every hit ray
    whose CPU top-two opacity gap exceeds TIE_MARGIN of max|CPU| (a closer
    pair may swap; such rays are counted, and fail the run when more than
    MAX_TIE_SHARE of the hit rays), the decoded opacities (per sample and
    the peak) on their mean error, and the other probe outputs on their
    largest, each beside its control."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.models.renderer import RayBatch
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import eval_step
    item = rec.probe_item
    W, H = MAINT_WH
    hit = rec.maps["ray_mask"][..., 0]
    gt = np.zeros((H, W, 3), np.float32)
    pix = np.asarray(item["pixel_idx"], np.int64)
    gt[pix[:, 1], pix[:, 0]] = item["gt_image"]
    bg = np.asarray(cfg.render.bg_color, np.float32)
    hole = ~hit & (np.linalg.norm(gt - bg, axis=-1) > 0.002)
    from pointnerf_tpu_torch.train.grow import _dilate3
    ys, xs = np.nonzero(hole & _dilate3(hit))
    if ys.size == 0:
        fail("the first probe frame has no hole next to a hit ray")
    params, st, grid = rec.first_probe
    y0 = int(np.clip(ys[0] - 8, 0, H - 16))
    x0 = int(np.clip(xs[0] - 8, 0, W - 16))
    sel = ((pix[:, 1] >= y0) & (pix[:, 1] < y0 + 16)
           & (pix[:, 0] >= x0) & (pix[:, 0] < x0 + 16))
    cpu = torch.device("cpu")

    def batch(dev):
        t = lambda a, dt=torch.float32: torch.tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev)
        return RayBatch(campos=t(item["campos"]),
                        camrotc2w=t(item["camrotc2w"]),
                        raydir=t(item["raydir"][sel]),
                        pixel_idx=t(pix[sel], torch.int32),
                        near=t(cfg.render.near_plane),
                        far=t(cfg.render.far_plane))
    params_c = tree_map(lambda x: x.to(cpu), params)
    st_c = type(st)(*[x.to(cpu) for x in st])
    q = dataclasses.replace(cfg.query, max_d=grid.nbr_pid.shape[0])
    grid_c = build_grid(params_c["points"].xyz, st_c.num_active, q)
    o_card = eval_step(params, st, grid, batch(st.num_active.device), cfg,
                       prob=True)
    o_cpu = eval_step(params_c, st_c, grid_c, batch(cpu), cfg, prob=True)
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  compute_dtype="f32"))
    o_ctl = eval_step(params_c, st_c, grid_c, batch(cpu), cfg32, prob=True)
    for f in ("ray_mask", "ray_valid", "neighbor_pidx"):
        if not torch.equal(getattr(o_card, f).cpu(), getattr(o_cpu, f)):
            fail(f"probe window: {f} differs between the card and the CPU")
    rmask = o_cpu.ray_mask
    if not (bool(rmask.any()) and not bool(rmask.all())):
        fail("the probe window holds no hole edge (all rays hit or miss)")
    op_k, op_c = o_card.coarse_point_opacity.cpu(), o_cpu.coarse_point_opacity
    op_scale = float(op_c.abs().max())
    # two samples whose CPU opacities lie within the margin may swap
    margin = TIE_MARGIN * op_scale
    top2 = op_c.topk(2, dim=-1).values
    clear = rmask & (top2[:, 0] - top2[:, 1] > margin)
    n_hit, n_tie = int(rmask.sum()), int((rmask & ~clear).sum())
    am_k, am_c = op_k.argmax(-1), op_c.argmax(-1)
    log(f"probe window {x0}..{x0 + 15} x {y0}..{y0 + 15}: ray_mask, ray_valid "
        f"and neighbor ids equal; {n_hit} of 256 rays hit; the argmax sample "
        f"compared on {int(clear.sum())} rays, {n_tie} near ties (top-two "
        f"gap within {margin:.3e}, {int((am_k != am_c)[rmask].sum())} of them "
        f"swapped)")
    if n_tie > n_hit * MAX_TIE_SHARE:
        fail(f"probe window: {n_tie} of {n_hit} hit rays are near ties, more "
             f"than {MAX_TIE_SHARE} of them")
    if not torch.equal(am_k[clear], am_c[clear]):
        fail("probe window: the argmax sample differs between the card and "
             "the CPU on a ray without a near tie")
    for f, which, rays in (("coarse_point_opacity", "hit", rmask),
                           ("ray_max_shading_opacity", "compared", clear)):
        a, b = getattr(o_card, f).cpu()[rays], getattr(o_cpu, f)[rays]
        log(f"probe window {f}: largest |err| / max|CPU| "
            f"{float((a - b).abs().max()) / float(b.abs().max()):.3e} "
            f"(printed only)")
        hold_bf16(f"card vs CPU probe window, {f} of the {which} rays, mean "
                  f"|err| / mean |CPU|", mean_rel(a, b),
                  mean_rel(getattr(o_ctl, f)[rays], b), OPACITY_BF16_TOL)
    for f, bar in PROBE_TOL.items():
        b = getattr(o_cpu, f)
        a = getattr(o_card, f).cpu()[clear]
        c = b.roll(1, 0)[clear]
        b = b[clear]
        s = float(b.abs().max())
        if not s > 0:
            fail(f"probe window: {f} is all zero on the compared rays")
        err, ctl = (float((x - b).abs().max()) / s for x in (a, c))
        hold_bf16(f"card vs CPU probe window, {f}, max |err| / max |CPU|",
                  err, ctl, bar, "the next ray's value")


def maintenance_path(cfg, kernels, device="cuda"):
    """train_scene at bench width with every maintenance event, then a
    resume from its last checkpoint for a few more steps. Returns the
    recorder, the launch counts and routes of both runs, the seconds per
    event and the train rays/s of the steps."""
    import tempfile
    import numpy as np
    import torch
    from pointnerf_tpu_torch.train import driver as td
    mcfg = maintenance_config(cfg)
    pts, conf, train_item, probe, test = maintenance_scene()
    rec = MaintRecorder(mcfg, kernels)
    log(f"maintenance scene: {pts[0].shape[0]} of {N_POINTS} points left "
        f"after the silhouette band ({SILHOUETTE_BAND_DEG} deg) of view 0 is "
        f"cut, {int((conf < mcfg.train.prune_thresh).sum())} below "
        f"prune_thresh")
    reset_counts(kernels)
    rec.install()
    try:
        build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as run_dir:
            t0 = time.perf_counter()
            _state, _st, hist = td.train_scene(
                mcfg, pts, train_item, test, probe, MAINT_WH, run_dir=run_dir,
                conf=conf, device=device)
            t1 = time.perf_counter()
            state2, _st2, hist2 = td.train_scene(
                mcfg, pts, train_item, test, probe, MAINT_WH, run_dir=run_dir,
                max_steps=MAINT_RESUME_TO, resume=True, conf=conf,
                device=device)
            t2 = time.perf_counter()
    finally:
        rec.restore()
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "maintenance")
    if int(state2.step) != MAINT_RESUME_TO:
        fail(f"the resumed run ended at step {int(state2.step)}")
    kinds = check_maintenance_log(rec)
    losses = torch.stack(rec.losses).cpu()
    psnrs = [m["psnr"] for m in hist["eval"] + hist2["eval"]]
    if not bool(torch.isfinite(losses).all()) or not psnrs \
            or not all(np.isfinite(psnrs)):
        fail(f"maintenance path: losses or PSNR not finite: "
             f"{losses.tolist()}, {psnrs}")
    n_steps = len(rec.times["train_step"])
    if n_steps != MAINT_RESUME_TO:
        fail(f"the maintenance path took {n_steps} train steps")
    rate = n_steps * N_RAYS / sum(rec.times["train_step"])
    log(f"maintenance events: {[e for e in rec.log if e[0] != 'grid']}")
    log(f"maintenance grid rebuilds (max_d passed, used, points): "
        f"{[d for e, d in rec.log if e == 'grid']}")
    log(f"maintenance path: {MAINT_STEPS} steps then a resume to "
        f"{MAINT_RESUME_TO}: {t1 - t0:.2f} s + {t2 - t1:.2f} s (host clock); "
        f"losses finite, eval PSNR {psnrs}, event counts {kinds}")
    log(f"maintenance path: {n_steps} train steps of {N_RAYS} rays at "
        f"{rate:.1f} train rays/s (the steps alone, each synchronized)")
    secs = {k: (sum(v) / len(v) if v else None, len(v))
            for k, v in rec.times.items()}
    log("maintenance seconds per event (mean, count): " + ", ".join(
        f"{k} {m:.4f} x{c}" for k, (m, c) in secs.items() if m is not None))
    log(f"maintenance launches {counts}, routes {routes}")
    return rec, counts, routes, secs, rate


# ---- the dataset path: scene_config() as train_dataset_scene builds it ----
DS_WH = (800, 800)
DS_TRAIN_VIEWS = 6          # NeRF-Synthetic has 100 (cut)
DS_TEST_VIEWS = 1           # and 200 (cut)
DS_POINTS = 200_000
DS_STEPS = 16
DS_CAMERA_DIST = 4.0        # NeRF-Synthetic's camera distance
DS_CAMERA_ANGLE_X = 0.6911112070083618
DS_SCAN = "cluster"
VOX_POINTS = 2_500_000      # above train_dataset_scene's 2M downsample line
QUERY_RAYS = 512


def blender_pose(azim_deg: float, elev_deg: float, dist: float):
    """Camera-to-world [4, 4] in the blender convention (x right, y up, z
    back), at `dist` from the origin and looking at it."""
    import numpy as np
    a, e = np.radians(azim_deg), np.radians(elev_deg)
    pos = dist * np.array([np.cos(e) * np.sin(a), np.sin(e),
                           np.cos(e) * np.cos(a)])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, back, pos
    return pose


def write_nerf_synth_scene(root: str):
    """The procedural `cluster` scene in the NeRF-Synthetic layout under
    `root`: 800 x 800 RGB PNGs of its analytic ground truth (the port's
    write_png), transforms_{train,test}.json with blender poses at distance
    DS_CAMERA_DIST, and points.ply of DS_POINTS surface samples."""
    import numpy as np
    from pointnerf_tpu_torch.camera import BLENDER2OPENCV, get_dtu_raydir
    from pointnerf_tpu_torch.data.ply import save_ply
    from pointnerf_tpu_torch.data.procedural import (SCENES, gt_render,
                                                      sample_cloud)
    from pointnerf_tpu_torch.utils.visualizer import to8b, write_png
    prims = SCENES[DS_SCAN]()
    W, H = DS_WH
    focal = 0.5 * W / np.tan(0.5 * DS_CAMERA_ANGLE_X)
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    views = {"train": [(60.0 * i, 25.0 if i % 2 else -10.0)
                       for i in range(DS_TRAIN_VIEWS)],
             "test": [(30.0 + 90.0 * i, 15.0) for i in range(DS_TEST_VIEWS)]}
    for split, angles in views.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, (az, el) in enumerate(angles):
            pose = blender_pose(az, el, DS_CAMERA_DIST)
            cv = (pose.astype(np.float32) @ BLENDER2OPENCV)
            rd = get_dtu_raydir(pix, K, cv[:3, :3]).astype(np.float32)
            img = gt_render(prims, cv[:3, 3].astype(np.float32), rd)
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      to8b(img.reshape(H, W, 3)))
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": DS_CAMERA_ANGLE_X,
                       "frames": frames}, f)
    xyz, color, _normals = sample_cloud(prims, DS_POINTS, seed=0)
    save_ply(os.path.join(root, "points.ply"), xyz, color)


def dataset_config(xyz):
    """scene_config() of the cloud as train_dataset_scene builds it (K=8,
    SR=80, D=400, H=256, f32, dense decode, bucket + shell-layered KNN, the
    fused flags off), with only the schedule cut to DS_STEPS steps: one
    prune (step 10), one eval of the test view and one checkpoint (step
    16)."""
    from pointnerf_tpu_torch.config import scene_config
    cfg = scene_config(xyz, near=2.0, far=6.0)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=DS_STEPS, prune_iter=10, test_freq=DS_STEPS,
        save_iter_freq=DS_STEPS, print_freq=4))


def dataset_path(kernels, data_root: str, run_dir: str, device="cuda"):
    """train_dataset_scene for DS_STEPS steps on the nerf_synth scene, then
    test_dataset_scene from its checkpoint. Every train step launches K3
    and K4 once on the CUDA-core (f32) route, every eval chunk K3 and K2
    once, K1 never (the bucket branch is torch code, as it is XLA code in
    JAX); the two PSNRs of the test view agree. The run writes into
    `run_dir` (emptied first), which the video phase reads. Returns the
    recorder, the launch counts and routes, the seconds per event and the
    PSNR."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.data.ply import load_ply
    from pointnerf_tpu_torch.train import driver as td
    xyz = load_ply(os.path.join(data_root, DS_SCAN, "points.ply"))["xyz"]
    cfg = dataset_config(xyz)
    q = cfg.query
    log(f"dataset config: vsize {q.vsize[0]:.6f}, ranges "
        f"{tuple(round(r, 4) for r in q.ranges)}, K={q.K} SR={q.SR} "
        f"D={q.z_depth_dim} P={q.P} max_o={q.max_o}, shell_layered "
        f"{q.shell_layered}, prebuild_neighbors {q.prebuild_neighbors}, "
        f"decode_capacity {q.decode_capacity}, compute "
        f"{cfg.train.compute_dtype}, fused_decode {cfg.agg.fused_decode}, "
        f"fused_march {cfg.render.fused_march}")
    rec = MaintRecorder(cfg, kernels, ("fused_decode", "fused_decode_bwd"),
                        ("fused_decode", "fused_march"),
                        record_step=DS_STEPS // 2)
    reset_counts(kernels)
    rec.install()
    shutil.rmtree(run_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        state, _st, hist = td.train_dataset_scene(
            "nerf_synth360_ft", data_root, DS_SCAN, run_dir,
            max_steps=DS_STEPS, cfg=cfg, resume=False, device=device)
        t1 = time.perf_counter()
        m = td.test_dataset_scene("nerf_synth360_ft", data_root, DS_SCAN,
                                  run_dir, cfg=cfg, save_images=False,
                                  device=device)
        t2 = time.perf_counter()
    finally:
        rec.restore()
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("fused_decode", "fused_decode_bwd")}
    n_steps = len(rec.times["train_step"])
    n_chunks = -(-DS_WH[0] * DS_WH[1] // 9216)
    frames = len(rec.times["eval_frame"])
    if int(state.step) != DS_STEPS or n_steps != DS_STEPS:
        fail(f"the dataset path took {n_steps} steps")
    if frames != 2:
        fail(f"the dataset path rendered {frames} eval frames, not 2")
    want = {"knn_select": 0, "fused_decode": DS_STEPS + frames * n_chunks,
            "fused_decode_bwd": DS_STEPS, "fused_march": frames * n_chunks}
    if counts != want:
        fail(f"dataset path launches {counts}, expected {want}")
    for n in routes:
        if routes[n]["tensor_core"]:
            fail(f"the f32 dataset path launched {n} on the tensor cores")
    routes["fused_march"] = march_routes(kernels, "dataset")
    kinds = [e for e, _d in rec.log if e not in ("grid",)]
    if kinds.count("prune") != 1 or "save" not in kinds \
            or "load" not in kinds:
        fail(f"dataset path events {kinds}: expected one prune, a "
             f"checkpoint and its load")
    losses = torch.stack(rec.losses).cpu()
    p_train = hist["eval"][-1]["psnr"] if hist["eval"] else float("nan")
    if not bool(torch.isfinite(losses).all()) \
            or not np.isfinite([p_train, m["psnr"]]).all():
        fail(f"dataset path: losses or PSNR not finite: {losses.tolist()}, "
             f"{p_train}, {m['psnr']}")
    if not abs(p_train - m["psnr"]) <= 1e-2:
        fail(f"test_dataset_scene PSNR {m['psnr']} differs from the "
             f"training run's eval {p_train} by more than 0.01 dB")
    secs = {k: (sum(v) / len(v) if v else None, len(v))
            for k, v in rec.times.items()}
    log(f"dataset path: losses {[round(float(v), 6) for v in losses]}")
    log(f"dataset path: {DS_STEPS} steps of {N_RAYS} rays, a prune "
        f"({[d for e, d in rec.log if e == 'prune']}), an eval and a "
        f"checkpoint, then test_dataset_scene: {t1 - t0:.2f} s + "
        f"{t2 - t1:.2f} s (host clock); eval PSNR {p_train:.4f} dB, "
        f"test_dataset_scene {m['psnr']:.4f} dB (SSIM {m['ssim']:.4f}); "
        f"launches {counts}, routes {routes}")
    log("dataset seconds per event (mean, count): " + ", ".join(
        f"{k} {v:.4f} x{c}" for k, (v, c) in secs.items() if v is not None))
    return rec, counts, routes, secs, m["psnr"]


@contextlib.contextmanager
def tempfile_dir(parent: str):
    import tempfile
    os.makedirs(parent, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=parent) as d:
        yield d


def live_counts(w, K: int, g_fagg=None, g_alpha=None):
    """The f32 kernels' live-group list (the list pass alone, K3's rule or,
    given the upstream gradients, K4's) held against live_groups_plain bit
    for bit; returns (rows with weight, live groups x K, 64-row tiles with a
    weighted row): the rows a kernel must compute, the rows the f32 kernels
    compute, and the rows a test per tile would compute."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (F32_ROWS, live_groups,
                                                      live_groups_plain)
    got = live_groups(w, K, g_fagg, g_alpha)
    want = live_groups_plain(w, K, g_fagg, g_alpha)
    if not torch.equal(got, want):
        fail(f"the live-group list ({got.numel()} groups) differs from its "
             f"plain version ({want.numel()})")
    row = (w != 0).view(-1)
    pad = (-row.numel()) % F32_ROWS
    tiles = int(torch.nn.functional.pad(row, (0, pad)).view(-1, F32_ROWS)
                .any(1).sum())
    return int(row.sum()), got.numel() * K, tiles * F32_ROWS


# readings of the first f32 kernels (no live list) on the dataset path, on
# an H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this run's
FIRST_F32_MS = {"K3 f32, train step": 94.1594, "K3 f32, eval chunk": 242.2127,
                "K4 f32, train step": 295.6045}


def check_f32_decode(fwd_cases, bwd_args):
    """K3 f32 on each (label, args) of `fwd_cases` and K4 f32 on `bwd_args`
    against their plain versions (K3 within K3_F32_TOL of max|plain|, K4
    each gradient within K4_F32_TOL of its max|plain|, and the same bits in
    two K4 calls), with times, the plain versions' times and the bounds, and
    the live rows, groups and tiles of each input. Returns {label: numbers}
    for K3 and the numbers of K4."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (flops, fused_decode,
                                                      fused_decode_bwd,
                                                      fused_decode_bwd_plain,
                                                      fused_decode_plain)

    def live_log(what, M, counts):
        rows, grouped, tiled = counts
        log(f"{what}, M={M}: {rows} rows carry weight; live groups x K = "
            f"{grouped} rows decoded ({grouped / M:.4%}); 64-row tiles with "
            f"a weighted row = {tiled} rows ({tiled / M:.4%})")

    k3 = {}
    for label, args in fwd_cases:
        feat, dists, extras, w, params, spec = args
        if spec.bf16:
            fail(f"the recorded {label} decode is not on the f32 route")
        M = feat.shape[0]
        counts = live_counts(w, spec.K)
        live_log(f"K3 f32 live list, {label}", M, counts)
        with torch.no_grad():
            out = fused_decode(feat, dists, extras, w, params, spec)
            plain = fused_decode_plain(feat, dists, extras, w, params, spec)
            torch.cuda.synchronize()
            scale = max(float(t.abs().max()) for t in plain)
            err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
            del out, plain
            ms = cuda_ms(lambda: fused_decode(feat, dists, extras, w, params,
                                              spec), iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: fused_decode_plain(
                feat, dists, extras, w, params, spec), iters=2, warmup=1)
        rows, _nbytes, b, by = decode_bound(w, params, spec)
        log(f"K3 f32 (cuda_core kernel), {label}, M={M} H={spec.H}: max abs "
            f"err {err:.3e}, scale {scale:.3e} (tolerance {K3_F32_TOL} x "
            f"scale); time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}: {rows} of {M} rows carry weight), "
            f"{b / ms:.2%} of the bound; "
            f"{flops(counts[1], spec) / ms / 1e9:.2f} TFLOP/s on the "
            f"{counts[1]} rows it computes")
        if not err <= K3_F32_TOL * scale:
            fail(f"K3 (f32) disagrees with its plain version on the {label}")
        k3[label] = {"M": M, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None, "live_rows": counts[0],
                     "live_group_rows": counts[1],
                     "live_tile_rows": counts[2]}

    feat, dists, extras, w, params, spec, g_fagg, g_alpha = bwd_args
    M = feat.shape[0]
    counts = live_counts(w, spec.K, g_fagg, g_alpha)
    live_log("K4 f32 live list, train step", M, counts)
    with torch.no_grad():
        names, out = decode_grad_leaves(fused_decode_bwd(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha))
        _, plain = decode_grad_leaves(fused_decode_bwd_plain(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha))
        _, again = decode_grad_leaves(fused_decode_bwd(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        rel, abs_err = [], 0.0
        for a, p in zip(out, plain):
            s = float(p.abs().max())
            e = float((a - p).abs().max())
            abs_err = max(abs_err, e)
            rel.append(e / s if s > 0 else (0.0 if e == 0 else float("inf")))
        del out, plain, again
        worst = max(range(len(rel)), key=rel.__getitem__)
        ms = cuda_ms(lambda: fused_decode_bwd(feat, dists, extras, w, params,
                                              spec, g_fagg, g_alpha),
                     iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: fused_decode_bwd_plain(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha),
            iters=2, warmup=1)
    rows, _nbytes, b, by = decode_bound(w, params, spec, backward=True)
    log(f"K4 f32 (cuda_core kernel), train step, M={M} H={spec.H}: max abs "
        f"err {abs_err:.3e}, worst relative {rel[worst]:.3e} ({names[worst]}, "
        f"tolerance {K4_F32_TOL}); time {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b:.4f} ms ({by}: {rows} of {M} rows carry weight), "
        f"{b / ms:.2%} of the bound; "
        f"{3 * flops(counts[1], spec) / ms / 1e9:.2f} TFLOP/s on the "
        f"{counts[1]} rows it computes")
    log(f"K4 f32: two calls on the same inputs give the same bits in every "
        f"gradient: {same}")
    if not rel[worst] <= K4_F32_TOL:
        fail("K4 (f32) disagrees with its plain version on the train step")
    if not same:
        fail("K4 (f32) is not deterministic run to run")
    k4 = {"M": M, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": b, "bound_by": by, "library_ms": None,
          "live_rows": counts[0], "live_group_rows": counts[1],
          "live_tile_rows": counts[2]}
    return k3, k4


def query_branches(data_root: str, cfg_ds, device="cuda"):
    """QUERY_RAYS rays of the dataset scene's test view through every ray
    generator (un-jittered, and jittered from one shared draw) and every KNN
    branch — bucket rows or prebuilt tables; K nearest, shell-layered, or
    the NN=0 random subset — on the card and on the CPU: slot masks and
    neighbor ids equal."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig, generator_kwargs
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.data.ply import load_ply
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.ops.query import RAY_GENERATORS, query_points
    cpu, dev = torch.device("cpu"), torch.device(device)
    ds = find_dataset_class_by_name("nerf_synth360_ft")(
        DataConfig(data_root=data_root, scan=DS_SCAN), split="test")
    item = ds.get_item(0)
    rng = np.random.RandomState(3)
    sel = rng.choice(len(item["raydir"]), QUERY_RAYS, replace=False)
    xyz = load_ply(os.path.join(data_root, DS_SCAN, "points.ply"))["xyz"]
    n = xyz.shape[0]
    t = {d: (torch.tensor(xyz, device=d), torch.tensor(item["campos"],
                                                         device=d),
             torch.tensor(item["raydir"][sel], device=d)) for d in (cpu, dev)}
    branches = {
        "bucket, shell-layered": dict(),
        "bucket": dict(shell_layered=False),
        "bucket, NN=0": dict(NN=0),
        "tables, shell-layered": dict(prebuild_neighbors=True),
        "tables, NN=0": dict(prebuild_neighbors=True, NN=0),
        "tables (K1)": dict(prebuild_neighbors=True, shell_layered=False)}
    cfg_ds = cfg_ds.replace(render=dataclasses.replace(cfg_ds.render,
                                                        ray_middle=4.0))
    D = cfg_ds.query.z_depth_dim
    n_slots = n_hits = 0
    t0 = time.perf_counter()
    for bname, kw in branches.items():
        q = dataclasses.replace(cfg_ds.query, **kw)
        if q.prebuild_neighbors:
            q = dataclasses.replace(q, max_d=262144)
        grid_d = build_grid(t[dev][0], torch.tensor(n, device=dev), q)
        need = int(grid_d.num_dil)
        if q.prebuild_neighbors and need > q.max_d:
            q = dataclasses.replace(q, max_d=-(-int(need * 1.25) // 4096)
                                    * 4096)
            grid_d = build_grid(t[dev][0], torch.tensor(n, device=dev), q)
        grid_c = build_grid(t[cpu][0], torch.tensor(n), q)
        for name in RAY_GENERATORS:
            cg = cfg_ds.replace(render=dataclasses.replace(
                cfg_ds.render, which_ray_generation=name))
            jitters = [0.0] + ([0.3] if bname == "bucket, shell-layered"
                               else [])
            for jit in jitters:
                u = None
                if jit:
                    cols = {"near_far_disparity_linear": D + 1,
                            "near_middle_far": int(D * 0.6) + int(D * 0.4)
                            + 2}.get(name, D)
                    u = torch.rand((QUERY_RAYS, cols),
                                   generator=torch.Generator().manual_seed(5))
                outs = {}
                for d, g in ((dev, grid_d), (cpu, grid_c)):
                    x, c, r = t[d]
                    outs[d.type] = query_points(
                        x, g, c, r, 2.0, 6.0, q, jitter=jit,
                        u=None if u is None else u.to(d), gen_name=name,
                        gen_kwargs=generator_kwargs(cg))
                a, b = outs[dev.type], outs["cpu"]
                for f in ("sample_mask", "ray_mask", "sample_pidx"):
                    if not torch.equal(getattr(a, f).cpu(), getattr(b, f)):
                        fail(f"query {bname}, {name}, jitter {jit}: {f} "
                             f"differs between the card and the CPU")
                n_slots += int(b.sample_mask.sum())
                n_hits += int(b.ray_mask.sum())
    log(f"query branches, card vs CPU: {len(branches)} KNN branches x "
        f"{len(RAY_GENERATORS)} generators (+ the jittered generators on the "
        f"default branch) on {QUERY_RAYS} rays of the test view: slot masks, "
        f"ray masks and neighbor ids equal ({n_slots} shading slots, "
        f"{n_hits} rays with a neighbor over all runs), "
        f"{time.perf_counter() - t0:.2f} s")


def voxel_parity():
    """construct_vox_points_closest on the card and on the CPU over a
    VOX_POINTS-point cluster cloud: the same kept ids and centroids."""
    import numpy as np
    from pointnerf_tpu_torch.data.procedural import SCENES, sample_cloud
    from pointnerf_tpu_torch.ops.voxel import construct_vox_points_closest
    xyz, _c, _n = sample_cloud(SCENES[DS_SCAN](), VOX_POINTS, seed=1)
    t0 = time.perf_counter()
    ic, cc = construct_vox_points_closest(xyz, 320, device="cuda")
    t1 = time.perf_counter()
    ih, ch = construct_vox_points_closest(xyz, 320, device="cpu")
    t2 = time.perf_counter()
    if not (np.array_equal(ic, ih) and np.array_equal(cc, ch)):
        fail(f"construct_vox_points_closest: {int((ic != ih).sum())} ids "
             f"differ between the card and the CPU")
    log(f"voxel downsample of {VOX_POINTS} points at 320^3: {len(ic)} kept, "
        f"ids and centroids equal on the card and the CPU; card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")


# ---- the flags-off path: the recorded quality configuration ----
QUALITY_OPT = "runs/quality_cluster_full_r5/opt.json"
QUALITY_POINTS = 200_000
FLAGS_OFF_WARMUP, FLAGS_OFF_STEPS, FLAGS_OFF_REQUESTS = 3, 10, 2


def quality_config():
    """The recorded quality configuration of the JAX package: prebuilt
    tables, no shell cut, compacted decode at capacity 0.4, bf16, and both
    fused flags off."""
    from pointnerf_tpu_torch.config import PointNeRFConfig
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           QUALITY_OPT)) as f:
        return PointNeRFConfig.from_json(f.read())


def flags_off_path(kernels, device="cuda"):
    """The quality configuration on the QUALITY_POINTS-point cluster cloud
    with random weights: a 512-ray request on the card against the CPU run
    with the flags set (held to phase 5's bars); FLAGS_OFF_WARMUP +
    FLAGS_OFF_STEPS train steps of 3,600 rays on one batch (K1 on its run
    path, K3 and K4 on the tensor cores once each per step) and
    FLAGS_OFF_REQUESTS serving requests (K1, K3 and K2 once each), although
    both fused flags are off; then the same request from the trained state,
    held to COLOR_TRAINED_BF16_TOL. Each kernel is then held against its
    plain version on the inputs the path gave it: K3 and K4 on a recorded
    train step's, K1, K3 and K2 on a recorded request's. Returns the
    launches, the routes and {"flags_off_step"|"flags_off_request":
    {kernel: numbers}}."""
    import torch
    from pointnerf_tpu_torch.data.procedural import (SCENES, sample_cloud,
                                                      sphere_cameras,
                                                      view_item)
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, refresh_grid,
                                                train_step)
    cfg = quality_config()
    if cfg.agg.fused_decode or cfg.render.fused_march:
        fail("the quality configuration has a fused flag on")
    dev = torch.device(device)
    prims = SCENES[DS_SCAN]()
    xyz, color, normals = sample_cloud(prims, QUALITY_POINTS, seed=0)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device=dev)
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                    device=dev)
    grid, _ = refresh_grid(pc, st, cfg)
    views = sphere_cameras(8, radius=2.4, focal=875.0, wh=DS_WH, seed=0)
    items = [view_item(prims, *v, DS_WH, n_rays=N_RAYS, seed=i, view_id=i)
             for i, v in enumerate(views)]
    # card vs CPU, the CPU with the flags set (the kernels' plain versions),
    # at random weights from a seed, as phase 5
    flags_on = cfg.replace(
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))
    parity_batch = ray_batch_from_numpy(view_item(
        prims, *views[5], DS_WH, n_rays=512, seed=7, view_id=5), cfg,
        device=dev)
    cpu_parity(params, pc, st, grid, cfg, cfg_cpu=flags_on,
               b_card=parity_batch)
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    tbatch = ray_batch_from_numpy(items[0], cfg, device=dev)
    reset_counts(kernels)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FLAGS_OFF_WARMUP + FLAGS_OFF_STEPS):
        if i == FLAGS_OFF_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = {n: kernels[n].launches for n in TRAIN_KERNELS}
        if i == 0:
            with recording_decode() as step_inputs:
                state, it = train_step(state, st, grid, tbatch, cfg)
        else:
            state, it = train_step(state, st, grid, tbatch, cfg)
        for n in TRAIN_KERNELS:
            if kernels[n].launches != before[n] + 1:
                fail(f"flags-off train step {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not once")
        losses.append(it["loss_total"])
    torch.cuda.synchronize()
    dt_train = time.perf_counter() - t0
    if kernels["fused_march"].launches:
        fail("flags-off training launched K2 (training takes the plain "
             "march)")
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        fail(f"a flags-off training loss is not finite: {losses.tolist()}")
    t1 = time.perf_counter()
    for i in range(FLAGS_OFF_REQUESTS):
        before = {n: kernels[n].launches for n in RENDER_KERNELS}
        b = ray_batch_from_numpy(items[1 + i], cfg, device=dev)
        if i == 0:
            with recording_kernels() as request_inputs:
                out = eval_step(state.params, st, grid, b, cfg)
        else:
            out = eval_step(state.params, st, grid, b, cfg)
        for n in RENDER_KERNELS:
            if kernels[n].launches != before[n] + 1:
                fail(f"flags-off request {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not once")
        if not bool(torch.isfinite(out.coarse_raycolor).all()):
            fail(f"flags-off request {i}: colors not finite")
    torch.cuda.synchronize()
    dt_serve = time.perf_counter() - t1
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "flags-off")
    log(f"flags-off path (quality configuration, fused_decode "
        f"{cfg.agg.fused_decode}, fused_march {cfg.render.fused_march}): "
        f"{FLAGS_OFF_STEPS} steps x {N_RAYS} rays after {FLAGS_OFF_WARMUP} "
        f"warm-up steps, {FLAGS_OFF_STEPS * N_RAYS / dt_train:.1f} train "
        f"rays/s; {FLAGS_OFF_REQUESTS} requests in {dt_serve:.4f} s; losses "
        f"{[round(float(v), 6) for v in losses]}; launches {counts}, routes "
        f"{routes}")
    # the same request from the trained state, at its own bar
    cpu_parity(state.params["mlp"], state.params["points"], st, grid, cfg,
               cfg_cpu=flags_on, b_card=parity_batch,
               bar=COLOR_TRAINED_BF16_TOL)
    del state
    all_recorded(step_inputs, "the recorded flags-off train step",
                 ("fused_decode", "fused_decode_bwd"))
    all_recorded(request_inputs, "the recorded flags-off request")
    with torch.no_grad():
        step = {"fused_decode": check_k3(
                    [(step_inputs["fused_decode"], {})],
                    what="flags-off train step")["bf16"],
                "fused_decode_bwd": check_k4(
                    step_inputs["fused_decode_bwd"])["bf16"]}
        del step_inputs
        request = {"knn_select": check_k1(*request_inputs["knn_select"]),
                   "fused_decode": check_k3(
                       [request_inputs["fused_decode"]],
                       what="flags-off request")["bf16"],
                   "fused_march": check_k2(*request_inputs["fused_march"])}
    return counts, routes, {"flags_off_step": step,
                            "flags_off_request": request}


# ---- the hybrid paths: the proposal-NeRF hybrid, the fine pass and
# NeRF-driven point creation at the recorded hole-scene configurations ----
HYBRID_OPT = "runs/quality_cluster_hole_nerf_r5/opt.json"
CREATE_OPT = "runs/quality_cluster_hole_create_r5/opt.json"
HOLE_PRIMS = (1, 4)          # left out of the cloud (quality_bench --drop-prims)
HYBRID_WARMUP, HYBRID_STEPS, HYBRID_REQUESTS = 3, 10, 2
FINE_SAMPLES = 80            # as many fine samples as the coarse pass's SR
FINE_WARMUP, FINE_STEPS, FINE_REQUESTS = 1, 3, 1
CREATE_STEPS, CREATE_PROBE_AT, CREATE_RESUME_TO = 24, 16, 26
# the field is at its random init after CREATE_PROBE_AT steps: a fresh
# field's blend mass over a ray is ~1 - exp(-softplus(-3) x depth) ~ 0.08,
# so the recorded 0.7 would create nothing; at this threshold the probe
# creates points, and the same count is derived from its maps
CREATE_PROB_THRESH = 0.05
# the launches each path makes per train step and per request or chunk
HYBRID_STEP = {"knn_select": 1, "fused_decode": 1, "fused_decode_bwd": 1,
               "fused_march": 0}
HYBRID_REQUEST = {"knn_select": 1, "fused_decode": 1, "fused_march": 2}
FINE_STEP = {"knn_select": 2, "fused_decode": 2, "fused_decode_bwd": 2,
             "fused_march": 0}
FINE_REQUEST = {"knn_select": 2, "fused_decode": 2, "fused_march": 3}


def opt_config(rel: str):
    """A recorded configuration of the JAX package, loaded as it is."""
    from pointnerf_tpu_torch.config import PointNeRFConfig
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           rel)) as f:
        return PointNeRFConfig.from_json(f.read())


def fine_config(cfg):
    """The hybrid configuration with the fine pass (FINE_SAMPLES), its
    color supervised as the reference registers it when fine_sample_num >
    0 (else no gradient reaches the fine decode)."""
    return cfg.replace(
        render=dataclasses.replace(cfg.render, fine_sample_num=FINE_SAMPLES),
        loss=dataclasses.replace(
            cfg.loss,
            color_loss_items=tuple(cfg.loss.color_loss_items)
            + ("fine_raycolor",),
            color_loss_weights=tuple(cfg.loss.color_loss_weights) + (1.0,)))


def hole_scene(cfg, device):
    """The procedural cluster with prims HOLE_PRIMS left out of a
    QUALITY_POINTS-point cloud (their geometry stays in the ground truth:
    coverage holes), random weights from a seed (the field's under "nerf"),
    its grid, and the 8 sphere views of the flags-off path. Returns (prims,
    pc, st, params, grid, views)."""
    import torch
    from pointnerf_tpu_torch.data.procedural import (SCENES, sample_cloud,
                                                      sphere_cameras)
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.driver import init_mlp_params
    from pointnerf_tpu_torch.train.step import refresh_grid
    prims = SCENES[DS_SCAN]()
    cloud = [p for i, p in enumerate(prims) if i not in HOLE_PRIMS]
    xyz, color, normals = sample_cloud(cloud, QUALITY_POINTS, seed=0)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device=device)
    params = init_mlp_params(torch.Generator().manual_seed(1), cfg,
                             device=device)
    grid, _ = refresh_grid(pc, st, cfg)
    views = sphere_cameras(8, radius=2.4, focal=875.0, wh=DS_WH, seed=0)
    return prims, pc, st, params, grid, views


@contextlib.contextmanager
def recording_merge():
    """A recording wrapper around the hybrid's z-merge; yields a list of
    (t_pts, idx_s, z_i) per call."""
    from pointnerf_tpu_torch.models import renderer
    seen, real = [], renderer.merge_samples

    def rec(t_pts, valid, feats_p, z_i, feats_n):
        res = real(t_pts, valid, feats_p, z_i, feats_n)
        seen.append((t_pts, res[1], z_i))
        return res
    renderer.merge_samples = rec
    try:
        yield seen
    finally:
        renderer.merge_samples = real


def hybrid_draws(cfg, R: int, seed: int):
    """CPU draws of a training render's fine pass and hybrid, shared by the
    card and the CPU run of a parity step."""
    import torch
    g = torch.Generator().manual_seed(seed)
    r = cfg.render
    d = {}
    if r.fine_sample_num > 0:
        d["fine"] = torch.rand((R, r.fine_sample_num + 1), generator=g)
    if r.nerf_importance > 0:
        d["nerf_march"] = torch.rand((R, r.nerf_coarse_samples), generator=g)
        d["nerf_importance"] = torch.rand((R, r.nerf_importance), generator=g)
    return d


def hybrid_parity(params, pc, st, grid, cfg, b_card, bars=None):
    """One request of the hybrid (and fine pass, when configured) on the
    card and on the CPU with the fused flags set (the kernels' plain
    versions; the CPU's merged march is the plain march, as in JAX), and
    the control: the CPU with an f32 decode. Integers equal — masks,
    neighbor ids (the fine pass's too) and the merge order idx_s; the
    merged colors and the fine colors of the rays that hit within `bars`
    (by output; default HYBRID_COLOR_BF16_TOL) on their mean error, with
    the control above it; the field's coarse color within the f32 bar; the
    creation signals printed."""
    bars = bars or HYBRID_COLOR_BF16_TOL
    import torch
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import eval_step
    cpu = torch.device("cpu")
    flags = cfg.replace(
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))
    mv = lambda t: t.to(cpu)  # noqa: E731
    pc_c, st_c = type(pc)(*[mv(t) for t in pc]), type(st)(*[mv(t) for t in st])
    params_c = tree_map(mv, params)
    q = dataclasses.replace(cfg.query, max_d=grid.nbr_pid.shape[0])
    grid_c = build_grid(pc_c.xyz, st_c.num_active, q)
    b_cpu = type(b_card)(*[None if t is None else mv(t) for t in b_card])
    with recording_merge() as m_card, recording_kernels() as k_card:
        o_card = eval_step({"mlp": params, "points": pc}, st, grid, b_card,
                           cfg)
    with recording_merge() as m_cpu, recording_kernels() as k_cpu:
        o_cpu = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c,
                          b_cpu, flags)
    same_integers(o_card, o_cpu)
    # the merge order: equal, except where a field sample lies within its
    # card-vs-CPU difference (the field's f32 sums) of a point sample;
    # everywhere the card's order must be the CPU's merge of the card's
    # own samples
    (tk, ik, zk), (tc, ic, zc) = [[t.cpu() for t in m[0]] for m in (m_card,
                                                                     m_cpu)]
    bad = (ik != ic).any(-1)
    own = torch.sort(torch.cat([tk, zk], -1), dim=-1, stable=True).indices
    unexplained = (own != ik).any(-1)
    zerr = float(((zk - zc).abs() / zc.abs()).max())
    terr = float(((tk - tc).abs() / tc.abs()).max())
    log(f"hybrid card vs CPU, {b_card.raydir.shape[0]} rays: the field's "
        f"importance z within {zerr:.3e}, the points' t within {terr:.3e} "
        f"(relative); merge order idx_s differs on {int(bad.sum())} rays (a "
        f"field sample within that of a point sample); the card's order is "
        f"not the CPU merge of the card's samples on "
        f"{int(unexplained.sum())} rays (must be 0)")
    if bool(unexplained.any()):
        r = int(unexplained.nonzero()[0, 0])
        fail(f"the hybrid's merge differs between the card and the CPU "
             f"(ray {r}: card {ik[r].tolist()}, CPU {own[r].tolist()})")
    if cfg.render.fine_sample_num > 0:
        # the fine pass's shading points come from the coarse blend
        # weights, which carry the bf16 decode's roundings: its KNN must
        # agree wherever its inputs (the points, K1's centers) agree
        fk, fc = o_card.fine_neighbor_pidx.cpu(), o_cpu.fine_neighbor_pidx
        ck = k_card["all"]["knn_select"][-1][0][3].cpu()
        cc = k_cpu["all"]["knn_select"][-1][0][3]
        same = (ck == cc).all(-1)
        bad = (fk != fc).any(-1)
        moved = float((ck - cc).abs().max())
        log(f"fine pass card vs CPU: {int(same.sum())} of {same.numel()} "
            f"fine shading points bit-equal (the others within {moved:.3e}); "
            f"neighbor ids differ on {int(bad.sum())} slots, of which on "
            f"bit-equal points {int((bad & same).sum())} (must be 0)")
        if bool((bad & same).any()):
            fail("the fine pass's neighbor ids differ between the card and "
                 "the CPU on the same shading points")
    cfg32 = flags.replace(train=dataclasses.replace(flags.train,
                                                    compute_dtype="f32"))
    o_ctl = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg32)
    hit = o_cpu.ray_mask
    if not bool(hit.any()):
        fail("no ray of the hybrid parity request hits the cloud")
    fields = ["coarse_raycolor"] + (["fine_raycolor"]
                                    if cfg.render.fine_sample_num > 0 else [])
    for f in fields:
        col = mv(getattr(o_card, f))[hit]
        ref, ctl = getattr(o_cpu, f)[hit], getattr(o_ctl, f)[hit]
        log(f"hybrid card vs CPU {f} of the rays that hit, largest |err| "
            f"(printed) {float((col - ref).abs().max()):.3e} (control "
            f"{float((col - ctl).abs().max()):.3e})")
        hold_bf16(f"hybrid card vs CPU {f} of the {int(hit.sum())} rays that "
                  f"hit, mean |err| / mean |CPU|", mean_rel(col, ref),
                  mean_rel(col, ctl), bars[f])
    nc = o_cpu.nerf_coarse_raycolor
    err = float((mv(o_card.nerf_coarse_raycolor) - nc).abs().max())
    log(f"hybrid card vs CPU nerf_coarse_raycolor (the f32 field alone): max "
        f"abs err {err:.3e} (tolerance {K3_F32_TOL} x scale "
        f"{float(nc.abs().max()):.3e})")
    if not err <= K3_F32_TOL * float(nc.abs().max()):
        fail("the field's coarse color differs between the card and the CPU")
    sig = o_cpu.nerf_mass[:, 0] > 1e-2
    errs = {f: float((mv(getattr(o_card, f)) - getattr(o_cpu, f))[sig].abs()
                     .max()) for f in ("nerf_mass", "nerf_loc_w", "nerf_color")}
    log("hybrid card vs CPU creation signals (printed): max abs err "
        + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
        + f" over the {int(sig.sum())} rays with field mass > 1e-2; the "
          f"field mass {float(o_cpu.nerf_mass.min()):.4f} to "
          f"{float(o_cpu.nerf_mass.max()):.4f}, misses "
          f"{int((~hit).sum())}")


def hybrid_run(cfg, kernels, name, warmup, steps, n_requests, step_launch,
               request_launch, device="cuda"):
    """A hybrid configuration on the hole scene: a 512-ray request card vs
    CPU at random weights; `warmup` + `steps` train steps of 3,600 rays on
    one batch (each launching `step_launch`; the first and, for the fine
    pass, a middle one record K3/K4's inputs) and `n_requests` requests of
    3,600 rays (each launching `request_launch`; the first records the
    kernels' inputs), with the train rays/s and rays/s; then the same
    request card vs CPU from the trained state, and a 512-ray train step's
    loss and gradients (the field's included) card vs CPU with the same
    draws. Returns (launch counts, routes, recorded step and request
    inputs, rates)."""
    import torch
    from pointnerf_tpu_torch.data.procedural import view_item
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, train_step)
    dev = torch.device(device)
    prims, pc, st, params, grid, views = hole_scene(cfg, dev)
    items = [view_item(prims, *v, DS_WH, n_rays=N_RAYS, seed=i, view_id=i)
             for i, v in enumerate(views)]
    # the parity request: 512 rays of view 5 that hit the cloud (the hole
    # scene fills a few percent of a frame: the decode's share of the
    # colors, the loss and the gradients would be a few rays' otherwise)
    pool = ray_batch_from_numpy(view_item(prims, *views[5], DS_WH,
                                          n_rays=16384, seed=7, view_id=5),
                                cfg, device=dev)
    hit = eval_step({"mlp": params, "points": pc}, st, grid, pool,
                    cfg).ray_mask.nonzero()[:512, 0]
    if hit.numel() < 512:
        fail(f"{name}: only {hit.numel()} of 16,384 rays of view 5 hit")
    parity_batch = pool._replace(raydir=pool.raydir[hit],
                                 pixel_idx=pool.pixel_idx[hit],
                                 gt_image=pool.gt_image[hit])
    hybrid_parity(params, pc, st, grid, cfg, parity_batch)
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    tbatch = ray_batch_from_numpy(items[0], cfg, device=dev)
    reset_counts(kernels)
    losses, step_inputs = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = {n: k.launches for n, k in kernels.items()}
        if i == 0:
            with recording_decode() as step_inputs:
                state, it = train_step(state, st, grid, tbatch, cfg)
        else:
            state, it = train_step(state, st, grid, tbatch, cfg)
        for n, want in step_launch.items():
            if kernels[n].launches != before[n] + want:
                fail(f"{name} train step {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not {want}")
        losses.append(it["loss_total"])
    torch.cuda.synchronize()
    dt_train = time.perf_counter() - t0
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        fail(f"a {name} training loss is not finite: {losses.tolist()}")
    t1 = time.perf_counter()
    request_inputs = None
    for i in range(n_requests):
        before = {n: k.launches for n, k in kernels.items()}
        b = ray_batch_from_numpy(items[1 + i], cfg, device=dev)
        if i == 0:
            with recording_kernels() as request_inputs:
                out = eval_step(state.params, st, grid, b, cfg)
        else:
            out = eval_step(state.params, st, grid, b, cfg)
        for n, want in request_launch.items():
            if kernels[n].launches != before[n] + want:
                fail(f"{name} request {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not {want}")
        for f in ("coarse_raycolor", "nerf_coarse_raycolor", "fine_raycolor"):
            v = getattr(out, f)
            if v is not None and not bool(torch.isfinite(v).all()):
                fail(f"{name} request {i}: {f} not finite")
    torch.cuda.synchronize()
    dt_serve = time.perf_counter() - t1
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, name)
    rates = {"train_rays_per_s": steps * N_RAYS / dt_train,
             "rays_per_s": n_requests * N_RAYS / dt_serve}
    log(f"{name} path: {steps} steps x {N_RAYS} rays after {warmup} warm-up "
        f"steps, {rates['train_rays_per_s']:.1f} train rays/s; "
        f"{n_requests} requests x {N_RAYS} rays in {dt_serve:.4f} s, "
        f"{rates['rays_per_s']:.1f} rays/s (host clock, synchronized); losses "
        f"{[round(float(v), 6) for v in losses]}; launches {counts}, routes "
        f"{routes}")
    hybrid_parity(state.params["mlp"], state.params["points"], st, grid, cfg,
                  parity_batch, bars=HYBRID_COLOR_TRAINED_BF16_TOL)
    train_cpu_parity(state, st, grid, cfg, b_card=parity_batch._replace(
        gt_image=torch.rand((512, 3), generator=torch.Generator().manual_seed(
            5)).to(dev)), draws=hybrid_draws(cfg, 512, seed=6),
        loss_bar=HYBRID_LOSS_BF16_TOL,
        grad_bars=(FINE_GRAD_BF16_TOL if cfg.render.fine_sample_num
                   else HYBRID_GRAD_BF16_TOL))
    del state
    return counts, routes, step_inputs, request_inputs, rates


def hybrid_kernel_checks(name, step_inputs, request_inputs, fine: bool):
    """Each kernel against its plain version at the shapes the path gave
    it: K2 on the request's merged sequence (and, with the fine pass, on
    the fine sequence); K1 and K3 bf16 on the request's last pass (the fine
    one with the fine pass); K4 bf16 on the recorded step's largest decode
    (the fine pass's). Returns {kernel: numbers}."""
    import torch
    all_recorded(request_inputs, f"the recorded {name} request")
    marches = request_inputs["all"]["fused_march"]
    out = {}
    with torch.no_grad():
        log(f"{name} request: K2 on the merged sequence")
        out["fused_march"] = check_k2(*marches[-1])
        if fine:
            log(f"{name} request: K2 on the fine sequence")
            out["fused_march_fine"] = check_k2(*marches[1])
        out["knn_select"] = check_k1(*request_inputs["knn_select"])
        out["fused_decode"] = check_k3([request_inputs["fused_decode"]],
                                       what=f"{name} request")["bf16"]
        bwd = step_inputs["all"].get("fused_decode_bwd", [])
        if not bwd:
            fail(f"the recorded {name} train step ran no decode backward")
        out["fused_decode_bwd"] = check_k4(
            max(bwd, key=lambda a: a[0].shape[0]))["bf16"]
    return out


class CreateRecorder(MaintRecorder):
    """MaintRecorder for NeRF-driven creation: the hybrid's chunks launch K2
    twice; a grow is checked against the probe maps instead of the sphere:
    its count equals the candidates the host derives from the maps (hit rays
    next to a miss above prob_thresh, and missed rays whose field mass is
    above it), and the created points sit at the field's expected location
    on those missed rays."""

    def apply_grow(self, real):
        def run(state, st, cand, cfg):
            import numpy as np
            import torch
            from pointnerf_tpu_torch.train.grow import _dilate3
            n = int(st.num_active)
            state, st, added = self._timed("grow", real, state, st, cand, cfg)
            self.log.append(("grow", (n, added)))
            maps, item = self.last_maps, self.probe_item
            W, H = DS_WH
            gt = np.zeros((H, W, 3), np.float32)
            pix = np.asarray(item["pixel_idx"], np.int64)
            gt[pix[:, 1], pix[:, 0]] = item["gt_image"]
            bg = np.asarray(cfg.render.bg_color, np.float32)
            hit = maps["ray_mask"][..., 0] > 0
            miss = ~hit & (np.linalg.norm(gt - bg, axis=-1) > 0.002)
            thr = cfg.train.prob_thresh
            n_hole = int((hit & _dilate3(miss)
                          & (maps["ray_max_shading_opacity"][..., 0] > thr))
                         .sum())
            seln = miss & (maps["nerf_mass"][..., 0] > thr)
            n_field = int(seln.sum())
            made = state.params["points"].xyz[n + n_hole:n + added].cpu()
            want = torch.from_numpy(maps["nerf_loc_w"][seln])
            log(f"creation: the probe frame has {int(miss.sum())} missed rays "
                f"on the scene, {n_field} with field mass > {thr}; the host "
                f"derives {n_hole} hole + {n_field} field candidates from the "
                f"maps; the grow added {added}")
            if not n_field:
                fail("NeRF-driven creation found no missed ray with field "
                     "mass above prob_thresh")
            if added != n_hole + n_field:
                fail(f"the grow added {added} points, the maps give "
                     f"{n_hole + n_field}")
            if not torch.equal(made, want):
                fail("the created points are not at the field's expected "
                     "locations")
            return state, st, added
        return run


def creation_path(kernels, device="cuda"):
    """train_scene at the recorded creation configuration (the hybrid with
    nerf_create_points) on the hole scene, the schedule cut to
    CREATE_STEPS steps with one probe of one 800 x 800 frame at
    CREATE_PROBE_AT and prob_thresh CREATE_PROB_THRESH, an eval and a
    checkpoint at the end; then a resume to CREATE_RESUME_TO. Checks the
    launches per step (K1, K3, K4 once) and per chunk (K1, K3 once, K2
    twice), the creation against the probe maps (CreateRecorder), the grid
    rebuild after the grow, and the resumed state bit for bit. Returns
    (launch counts, routes)."""
    import tempfile
    import numpy as np
    import torch
    from pointnerf_tpu_torch.data.procedural import (SCENES, sample_cloud,
                                                      sphere_cameras,
                                                      view_item)
    from pointnerf_tpu_torch.train import driver as td
    cfg = opt_config(CREATE_OPT)
    if not cfg.train.nerf_create_points or cfg.render.nerf_importance <= 0:
        fail("the creation configuration does not create points with the "
             "hybrid")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=CREATE_STEPS, prob_freq=CREATE_PROBE_AT,
        prob_thresh=CREATE_PROB_THRESH, test_freq=CREATE_STEPS,
        save_iter_freq=CREATE_STEPS, print_freq=6))
    prims = SCENES[DS_SCAN]()
    cloud = [p for i, p in enumerate(prims) if i not in HOLE_PRIMS]
    pts = sample_cloud(cloud, QUALITY_POINTS, seed=0)
    views = sphere_cameras(8, radius=2.4, focal=875.0, wh=DS_WH, seed=0)

    def train_item(step):
        v = step % 6
        return view_item(prims, *views[v], DS_WH, n_rays=N_RAYS, seed=step,
                         view_id=v)
    probe = [view_item(prims, *views[6], DS_WH, view_id=6)]
    test = [view_item(prims, *views[7], DS_WH, view_id=7)]
    rec = CreateRecorder(cfg, kernels,
                         chunk_launches={"fused_march": 2})
    reset_counts(kernels)
    rec.install()
    try:
        build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as run_dir:
            t0 = time.perf_counter()
            _s, _st, hist = td.train_scene(cfg, pts, train_item, test, probe,
                                           DS_WH, run_dir=run_dir,
                                           device=device)
            s2, _st2, _h2 = td.train_scene(
                cfg, pts, train_item, test, probe, DS_WH, run_dir=run_dir,
                max_steps=CREATE_RESUME_TO, resume=True, device=device)
            dt = time.perf_counter() - t0
    finally:
        rec.restore()
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "creation")
    if int(s2.step) != CREATE_RESUME_TO:
        fail(f"the resumed creation run ended at step {int(s2.step)}")
    if "nerf" not in s2.params["mlp"]:
        fail("the resumed creation run has no field parameters")
    kinds = {}
    pending = None
    for ev, detail in rec.log:
        kinds[ev] = kinds.get(ev, 0) + 1
        if ev == "grow" and detail[1]:
            pending = detail[0] + detail[1]
        elif ev == "grid" and pending is not None:
            if detail[2] != pending:
                fail(f"the grid after the grow holds {detail[2]} points, not "
                     f"{pending}")
            pending = None
    if pending is not None:
        fail("the grow was not followed by a grid rebuild")
    for ev in ("probe", "grow", "save", "load"):
        if not kinds.get(ev):
            fail(f"the creation path never ran a {ev}")
    losses = torch.stack(rec.losses).cpu()
    psnrs = [m["psnr"] for m in hist["eval"]]
    if not bool(torch.isfinite(losses).all()) or not psnrs \
            or not np.all(np.isfinite(psnrs)):
        fail(f"creation path: losses or PSNR not finite: {psnrs}")
    secs = {k: round(sum(v) / len(v), 4) for k, v in rec.times.items() if v}
    log(f"creation path: {CREATE_STEPS} steps, a resume to "
        f"{CREATE_RESUME_TO} in {dt:.2f} s; events "
        f"{[e for e in rec.log if e[0] != 'grid']}; eval PSNR {psnrs}; "
        f"seconds per event {secs}; launches {counts}, routes {routes}")
    return counts, routes


# ---- the loaders: tt_ft (NSVF layout) and waymo_ft on generated scenes ----
LOADER_WH = (96, 96)          # one 9,216-ray eval chunk per test frame
LOADER_TRAIN_VIEWS = 5
LOADER_STEPS = 4


def write_loader_scenes(root: str):
    """The procedural cluster (its whole DS_POINTS-point cloud) as an NSVF
    scene under root/tt/cluster (LOADER_TRAIN_VIEWS train views and one test
    view of LOADER_WH, RGBA PNGs of the analytic ground truth with an
    all-opaque alpha, 4x4 intrinsics, bbox.txt) and as a waymo_ft bundle
    root/waymo/cluster.npz through the port's frames_to_npz (frame 0 is the
    test frame; the cloud split over the others, voxel-downsampled per frame
    on the card at the points config's vox_res)."""
    import numpy as np
    from pointnerf_tpu_torch.data.ply import save_ply
    from pointnerf_tpu_torch.data.procedural import (SCENES, gt_render,
                                                      sample_cloud,
                                                      sphere_cameras)
    from pointnerf_tpu_torch.data.waymo_export import frames_to_npz
    from pointnerf_tpu_torch.utils.visualizer import to8b, write_png
    prims = SCENES[DS_SCAN]()
    xyz, color, _n = sample_cloud(prims, DS_POINTS, seed=0)
    W, H = LOADER_WH
    n = LOADER_TRAIN_VIEWS + 1
    views = sphere_cameras(n, radius=2.4, focal=105.0, wh=LOADER_WH, seed=1)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    tt = os.path.join(root, "tt", DS_SCAN)
    for d in ("rgb", "pose"):
        os.makedirs(os.path.join(tt, d), exist_ok=True)
    frames = []
    for i, (campos, rot, K) in enumerate(views):
        rd = get_dtu_raydir(pix, K, rot).astype(np.float32)
        img = gt_render(prims, campos.astype(np.float32), rd).reshape(H, W, 3)
        stem = (f"2_{0:04d}" if i == 0 else f"0_{i - 1:04d}")
        rgba = np.concatenate([to8b(img), np.full((H, W, 1), 255, np.uint8)],
                              -1)
        write_png(os.path.join(tt, "rgb", stem + ".png"), rgba)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = rot, campos
        np.savetxt(os.path.join(tt, "pose", stem + ".txt"), c2w)
        # frames_to_npz remaps columns to [-y, z, -x]: hand it the camera
        # whose remap is this one; full resolution is twice the bundle's
        big = np.repeat(np.repeat(img, 2, 0), 2, 1)
        pre = np.stack([-c2w[:, 2], -c2w[:, 0], c2w[:, 1], c2w[:, 3]], 1)
        k_full = K.copy()
        k_full[:2] *= 2.0
        part = None if i == 0 else xyz[(i - 1)::LOADER_TRAIN_VIEWS]
        frames.append({"image": big, "c2w": pre.astype(np.float32),
                       "K": k_full.astype(np.float32), "points_world": part})
    K4 = np.eye(4)
    K4[:3, :3] = views[0][2]
    np.savetxt(os.path.join(tt, "intrinsics.txt"), K4)
    with open(os.path.join(tt, "bbox.txt"), "w") as f:
        f.write(" ".join(f"{v:.4f}" for v in
                         list(xyz.min(0)) + list(xyz.max(0))) + " 0.01\n")
    save_ply(os.path.join(tt, "points.ply"), xyz, color)
    os.makedirs(os.path.join(root, "waymo"), exist_ok=True)
    from pointnerf_tpu_torch.config import PointsConfig
    frames_to_npz(frames, os.path.join(root, "waymo", DS_SCAN + ".npz"),
                  step=10, scale_factor=4.0, target_upscale=2,
                  vox_res=PointsConfig().vox_res, device="cuda")


def loaders_path(kernels, root: str, device="cuda"):
    """train_dataset_scene for LOADER_STEPS steps on each generated scene
    (tt_ft, waymo_ft) at scene_config() of its cloud (dense f32 decode:
    K3 and K4 f32 once a step, K1 never) with an eval of one 9,216-ray chunk
    (K3 f32 once, K2 once) and a checkpoint at the end. Returns (launch
    counts, routes) summed over both."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig, scene_config
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.train import driver as td
    total, routes_all = {}, {}
    for name, scan_root in (("tt_ft", os.path.join(root, "tt")),
                            ("waymo_ft", os.path.join(root, "waymo"))):
        ds = find_dataset_class_by_name(name)(DataConfig(
            dataset_name=name, data_root=scan_root, scan=DS_SCAN),
            split="train")
        xyz = ds.load_init_points()["xyz"]
        cfg = scene_config(xyz, near=float(ds.near), far=float(ds.far))
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, maximum_step=LOADER_STEPS, prune_iter=0, prob_freq=0,
            test_freq=LOADER_STEPS, save_iter_freq=LOADER_STEPS,
            print_freq=LOADER_STEPS, random_sample_size=60))
        rec = MaintRecorder(cfg, kernels,
                            train_kernels=("fused_decode", "fused_decode_bwd"),
                            render_kernels=("fused_decode", "fused_march"))
        reset_counts(kernels)
        rec.install()
        try:
            import tempfile
            with tempfile.TemporaryDirectory(
                    dir=os.path.join(os.path.dirname(root))) as run_dir:
                t0 = time.perf_counter()
                state, st, hist = td.train_dataset_scene(
                    name, scan_root, DS_SCAN, run_dir=run_dir,
                    max_steps=LOADER_STEPS, cfg=cfg, resume=False,
                    device=device)
                dt = time.perf_counter() - t0
        finally:
            rec.restore()
        counts = {n: k.launches for n, k in kernels.items()}
        from pointnerf_tpu_torch.ops.fused_decode import (fused_decode,
                                                          fused_decode_bwd)
        routes = {"fused_decode": dict(fused_decode.launches_by_route),
                  "fused_decode_bwd": dict(fused_decode_bwd.launches_by_route)}
        if counts["knn_select"]:
            fail(f"{name}: K1 ran on the bucket query")
        for n in ("fused_decode", "fused_decode_bwd"):
            if routes[n]["cuda_core"] != counts[n]:
                fail(f"{name}: {n} launches left the CUDA-core (f32) route: "
                     f"{routes[n]}")
        routes["fused_march"] = march_routes(kernels, name)
        losses = torch.stack(rec.losses).cpu()
        psnrs = [m["psnr"] for m in hist["eval"]]
        if int(state.step) != LOADER_STEPS or len(rec.losses) != LOADER_STEPS \
                or not bool(torch.isfinite(losses).all()) or len(psnrs) != 1 \
                or not np.isfinite(psnrs[0]):
            fail(f"{name}: {len(rec.losses)} steps, losses "
                 f"{losses.tolist()}, eval PSNR {psnrs}")
        log(f"loader {name}: {ds.width} x {ds.height} views ({len(ds)} train), "
            f"{xyz.shape[0]} points, near {ds.near:.4f} far {ds.far:.4f}; "
            f"{LOADER_STEPS} steps and one eval chunk in {dt:.2f} s, losses "
            f"{[round(float(v), 6) for v in losses]}, eval PSNR "
            f"{psnrs[0]:.3f}; launches {counts}, routes {routes}")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        for n, r in routes.items():
            for k, v in r.items():
                routes_all.setdefault(n, {}).setdefault(k, 0)
                routes_all[n][k] += v
        del state, st
    return total, routes_all


def hybrid_paths(kernels):
    """The hybrid (phase 1), the fine pass (phase 2), NeRF-driven creation
    (phase 3) and each kernel at the shapes the first two gave it (phase 4).
    Returns (launch counts, routes, kernel checks, rates)."""
    cfg = opt_config(HYBRID_OPT)
    if cfg.render.nerf_importance <= 0 or cfg.render.fine_sample_num:
        fail("the hybrid configuration is not the hybrid without the fine "
             "pass")
    if cfg.agg.fused_decode or cfg.render.fused_march:
        fail("the hybrid configuration has a fused flag on")
    counts, routes, rates, checks = {}, {}, {}, {}

    def add(c, r):
        for n, v in c.items():
            counts[n] = counts.get(n, 0) + v
        for n, rr in r.items():
            for k, v in rr.items():
                routes.setdefault(n, {}).setdefault(k, 0)
                routes[n][k] += v
    c, r, si, ri, rates["hybrid"] = hybrid_run(
        cfg, kernels, "hybrid", HYBRID_WARMUP, HYBRID_STEPS, HYBRID_REQUESTS,
        HYBRID_STEP, HYBRID_REQUEST)
    add(c, r)
    checks["hybrid"] = hybrid_kernel_checks("hybrid", si, ri, fine=False)
    del si, ri
    fcfg = fine_config(cfg)
    c, r, si, ri, rates["fine"] = hybrid_run(
        fcfg, kernels, "fine", FINE_WARMUP, FINE_STEPS, FINE_REQUESTS,
        FINE_STEP, FINE_REQUEST)
    add(c, r)
    checks["fine"] = hybrid_kernel_checks("fine", si, ri, fine=True)
    del si, ri
    c, r = creation_path(kernels)
    add(c, r)
    return counts, routes, checks, rates


# ---- the MVS paths: a DTU-format scene, MVS point initialization, dtu_ft
# per-scene training from the MVS cloud, feed-forward training -------------
MVS_WH = (640, 512)           # DTU's rectified views at MVSNet's resolution
MVS_VIEWS = 16                # DTU scans have 49 (cut)
MVS_GROUPS = 8                # mvs_init_cloud's default n_groups
MVS_RING = dict(radius=3.0, height=0.8, focal=900.0)
MVS_NEAR, MVS_FAR = 2.0, 4.4  # the depth range the cam files give
DTU_SCAN = "scan1"
DTU_MM = 200.0                # dtu_ft's cam files are in millimetres (x 1/200)
# random MVSNet weights give a flat depth softmax (conf about 4/64): the
# filter runs with no confidence threshold and one consistent view, as the
# JAX package's own test runs it (tests/test_dataset_driver.py)
MVS_INIT_KW = dict(depth_conf_thresh=0.0, geo_cnsst_num=1)
FT_STEPS = 8
FT_RESUME_TO = 10
FF_WARMUP, FF_STEPS = 3, 10
FF_RAYS = 1024
FF_DEPTHS = 48
FF_PARITY_WH = (320, 256)     # the card-vs-CPU step's views (widths kept)
# card vs CPU, MVSNet in f32 (TF32 off): the bars the JAX package held
# against the reference's torch MVSNet (tests/test_mvs_import.py): depth
# max |err| / max |depth|, conf and prob max |err|; the embedding of the
# same points within 2e-4 of scale
MVS_TOL = 1e-4
MVS_EMBED_TOL = 2e-4
# card vs CPU feed-forward step (train-mode BatchNorm, cuDNN's f32
# convolutions against oneDNN's, conv3d's backward with atomics), split at
# its cloud. Train-mode BatchNorm lets the convolutions' rounding move the
# cloud far more than eval mode does, and the render turns that into a few
# rays' colors, so the whole step's loss card vs CPU swings by decades
# from one trained state to the next (past 1e-4 in some runs): it is
# printed, and each part is held on the same inputs. The running stats'
# worst max |err| / max |CPU| and the cloud's sum |err| / sum |CPU|,
# control the CPU with eval-mode BatchNorm (a wrong mode is the fault
# these catch); the render of one cloud, the card's, its loss relative and
# its MLP and cloud gradients sum |err| / sum |CPU|, control the CPU with
# a bf16 decode; MVSNet's backward of one cotangent, sum |err| / sum
# |CPU|, control eval-mode BatchNorm. A pixel whose depth index rounds the
# other way differs far beyond rounding in its confidence; the points
# beyond FF_FLIP_TOL of a tensor's scale (at most FF_FLIP_MAX) carry no
# cotangent into that backward. The bars sit between the readings of
# scripts/parity_readings.py --phase ff and the controls (PERF.md §6)
FF_TOL = {"stats": 1e-5, "cloud": 2e-4, "loss": 1e-5, "mlp": 1e-3,
          "dcloud": 5e-4, "mvs": 5e-2}
FF_FLIP_TOL = 1e-3
FF_FLIP_MAX = 8
FF_XYZ_TOL = 1e-4


def write_dtu_scenes(root: str):
    """The procedural cluster in DTU's layout, twice: root/dtu_ft (cam files
    in millimetres with quarter-resolution intrinsics, as dtu_ft reads
    them; the finetune init pairs: MVS_GROUPS groups of a view and its two
    ring neighbours) and root/dtu (scene units, full-resolution intrinsics,
    for the feed-forward loader), MVS_VIEWS views of MVS_WH on a ring around
    the cluster, the ranked pair file; the PNGs written once, under dtu_ft,
    and linked from dtu."""
    import numpy as np
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    from pointnerf_tpu_torch.data.procedural import SCENES, gt_render
    from pointnerf_tpu_torch.data.synthetic import ring_cameras
    from pointnerf_tpu_torch.utils.visualizer import to8b, write_png
    prims = SCENES[DS_SCAN]()
    W, H = MVS_WH
    views = ring_cameras(n_views=MVS_VIEWS, wh=MVS_WH, **MVS_RING)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    ft, ff = os.path.join(root, "dtu_ft"), os.path.join(root, "dtu")
    rect = os.path.join(ft, "Rectified", f"{DTU_SCAN}_train")
    for d in (rect, os.path.join(ft, "Cameras", "train"),
              os.path.join(ft, "dtu_configs"),
              os.path.join(ff, "Cameras", "train")):
        os.makedirs(d, exist_ok=True)
    link = os.path.join(ff, "Rectified")
    if not os.path.lexists(link):
        os.symlink(os.path.join("..", "dtu_ft", "Rectified"), link)
    n_ft = 192                               # DtuFtDataset's n_depths
    d_int_ft = (MVS_FAR - MVS_NEAR) / (n_ft - 1)
    d_int_ff = (MVS_FAR - MVS_NEAR) / FF_DEPTHS

    def cam_text(w2c, K, depth_line):
        return ("extrinsic\n" + "\n".join(" ".join(f"{x:.9g}" for x in row)
                                          for row in w2c)
                + "\n\nintrinsic\n" + "\n".join(
                    " ".join(f"{x:.9g}" for x in row) for row in K)
                + f"\n\n{depth_line}\n")
    for i, (campos, rot, K) in enumerate(views):
        rd = get_dtu_raydir(pix, K, rot).astype(np.float32)
        img = gt_render(prims, campos.astype(np.float32), rd)
        write_png(os.path.join(rect, f"rect_{i + 1:03d}_3_r5000.png"),
                  to8b(img.reshape(H, W, 3)))
        w2c = np.eye(4)
        w2c[:3, :3] = rot.T
        w2c[:3, 3] = -rot.T @ campos
        mm = w2c.copy()
        mm[:3, 3] *= DTU_MM
        Kq = K.astype(np.float64).copy()
        Kq[:2] /= 4.0
        with open(os.path.join(ft, "Cameras", "train", f"{i:08d}_cam.txt"),
                  "w") as f:
            f.write(cam_text(mm, Kq, f"{MVS_NEAR * DTU_MM:.9g} "
                                     f"{d_int_ft * DTU_MM:.9g}"))
        with open(os.path.join(ff, "Cameras", "train", f"{i:08d}_cam.txt"),
                  "w") as f:
            f.write(cam_text(w2c, K, f"{MVS_NEAR:.9g} {d_int_ff:.9g}"))
    lines = [str(MVS_VIEWS)]
    for i in range(MVS_VIEWS):
        srcs = [(i + s * k) % MVS_VIEWS for k in range(1, 6) for s in (1, -1)]
        lines += [str(i), f"{len(srcs)} " + " ".join(
            f"{v} {100.0 - 10 * j:.1f}" for j, v in enumerate(srcs))]
    for d in (ft, ff):
        with open(os.path.join(d, "Cameras", "pair.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    step = MVS_VIEWS // MVS_GROUPS
    refs = list(range(0, MVS_VIEWS, step))[:MVS_GROUPS]
    with open(os.path.join(ft, "dtu_configs",
                           "dtu_finetune_init_pairs.txt"), "w") as f:
        f.write(f"{len(refs)}\n" + "".join(
            f"{r}\n{(r - 1) % MVS_VIEWS},{(r + 1) % MVS_VIEWS}\n"
            for r in refs))
    return ft, ff


def _rel(a, b) -> float:
    """max |a - b| / max |b| over two tensors (a on any device)."""
    b = b.float().cpu()
    return float((a.float().cpu() - b).abs().max()) / max(
        float(b.abs().max()), 1e-30)


def _sum_rel(grads, ref) -> float:
    """sum |g - ref| / sum |ref| over every leaf of two trees."""
    from pointnerf_tpu_torch.train.optim import tree_leaves
    num = den = 0.0
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        num += float((a.cpu() - b.cpu()).abs().sum())
        den += float(b.abs().sum())
    return num / den


def mvs_group_parity(ds, model, variables):
    """Group 0 of the init at full size, card vs CPU: MVSNet's depth, conf
    and prob of its reference view and the features (TF32 off) within
    MVS_TOL, with the TF32 forward as the control on the features; the
    filter of the card's depth maps of all
    three reference views run on the card and on the CPU, masks equal; the
    embedding of the card's surviving points within MVS_EMBED_TOL."""
    import copy
    import numpy as np
    import torch
    from pointnerf_tpu_torch.mvs import mvsnet, points_init
    from pointnerf_tpu_torch.mvs.filter import filter_by_masks
    from pointnerf_tpu_torch.mvs.points_init import (gen_scene_points,
                                                     images_nchw, mvs_apply,
                                                     view_proj_mats)
    g = ds.get_mvs_item(0)
    V, H, W, _ = g["images"].shape
    D = min(64, len(g["depth_values"]))
    dv = np.linspace(g["depth_values"][0], g["depth_values"][-1], D,
                     dtype=np.float32)
    cpu = torch.device("cpu")
    m_cpu = copy.deepcopy(model).to(cpu)
    v_cpu = {k: {n: t.to(cpu) for n, t in v.items()}
             for k, v in variables.items()}
    args = (images_nchw(g["images"], cpu),
            torch.tensor(view_proj_mats(g["Ks"], g["w2cs"], 0)),
            torch.tensor(dv))
    cd = torch.backends.cudnn
    with torch.no_grad():
        ref = mvs_apply(m_cpu, v_cpu, *args)
        card = mvs_apply(model, variables, *[a.cuda() for a in args])
        real_precision = mvsnet.mvs_precision
        mvsnet.mvs_precision = lambda: cd.flags(
            enabled=cd.enabled, benchmark=cd.benchmark,
            deterministic=cd.deterministic, allow_tf32=True)
        try:
            tf32 = mvs_apply(model, variables, *[a.cuda() for a in args])
        finally:
            mvsnet.mvs_precision = real_precision
    torch.cuda.synchronize()

    def readings(out):
        return (_rel(out[0], ref[0]),
                float((out[1].cpu() - ref[1]).abs().max()),
                float((out[3].cpu() - ref[3]).abs().max()),
                _rel(out[2], ref[2]))
    (d, c, p, f), (cd, cc, cp, cf) = readings(card), readings(tf32)
    log(f"MVSNet card vs CPU, group 0's reference view ({W} x {H}, V={V}, "
        f"D={D}, TF32 off): depth max|err|/max|depth| {d:.3e}, conf max|err| "
        f"{c:.3e}, prob max|err| {p:.3e}, features max|err|/scale {f:.3e} "
        f"(bars {MVS_TOL}); control, the card with TF32: {cd:.3e}, {cc:.3e}, "
        f"{cp:.3e}, {cf:.3e}")
    for what, err in (("depth", d), ("conf", c), ("prob", p),
                      ("features", f)):
        if not err <= MVS_TOL:
            fail(f"MVSNet's {what} card vs CPU beyond its bar")
    # random weights leave the depth softmax flat, so TF32's roundings
    # barely move depth, conf and prob (PERF.md §6): the control is held
    # on the features, which the embedding samples
    if not cf > MVS_TOL:
        fail("the TF32 control does not land above the features' bar")
    # the filter of the group's (card) depth maps, on the card as
    # gen_scene_points runs it and again on the CPU
    seen = []

    def filt(*a, **k):
        seen.append((a, k))
        return filter_by_masks(*a, **k)
    points_init.filter_by_masks = filt
    try:
        out = gen_scene_points(variables["params"], model, g["images"],
                               g["Ks"], g["w2cs"], (float(dv[0]),
                                                    float(dv[-1])),
                               n_depths=D,
                               batch_stats=variables["batch_stats"],
                               **MVS_INIT_KW)
    finally:
        points_init.filter_by_masks = filter_by_masks
    (depths, confs, Kq, w2cs), kw = seen[0]
    kw = dict(kw, device="cuda")
    xc, cc_ = filter_by_masks(depths, confs, Kq, w2cs, **kw)
    xp, cp_ = filter_by_masks(depths, confs, Kq, w2cs, **dict(kw,
                                                              device="cpu"))
    counts = [a.shape[0] for a in xc]
    if counts != [a.shape[0] for a in xp] or not all(
            np.array_equal(a, b) for a, b in zip(cc_, cp_)):
        fail(f"the filter's survivors differ card vs CPU: {counts} vs "
             f"{[a.shape[0] for a in xp]}")
    xerr = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
               for a, b in zip(xc, xp) if len(b))
    log(f"filter card vs CPU on the card's depth maps: survivors per view "
        f"{counts} of {depths[0].numel()} equal, their points "
        f"max|err|/scale {xerr:.3e}")
    # the embedding of the card's points, card vs CPU
    with torch.no_grad():
        feats = mvs_apply(model, variables, images_nchw(g["images"], "cuda"),
                          method="features_only")
        campos = np.linalg.inv(g["w2cs"][0])[:3, 3]
        ins = [torch.as_tensor(np.asarray(a, np.float32)) for a in (
            out["xyz"], g["Ks"], g["w2cs"], campos, out["conf"])]
        e_card = mvs_apply(model, variables, ins[0].cuda(),
                           images_nchw(g["images"], "cuda"), feats,
                           *[t.cuda() for t in ins[1:]],
                           method="embed_points")
        e_cpu = mvs_apply(m_cpu, v_cpu, ins[0], images_nchw(g["images"], cpu),
                          feats.cpu(), *ins[1:], method="embed_points")
    errs = [_rel(a, b) for a, b in zip(e_card[:3], e_cpu[:3])]
    log(f"embedding card vs CPU on {ins[0].shape[0]} points: embedding, "
        f"color, dirs max|err|/scale {', '.join(f'{e:.3e}' for e in errs)} "
        f"(bar {MVS_EMBED_TOL}; scales "
        f"{', '.join(f'{float(t.abs().max()):.3e}' for t in e_cpu[:3])})")
    if not max(errs) <= MVS_EMBED_TOL:
        fail("the point embedding card vs CPU beyond its bar")
    return {"depth": d, "conf": c, "prob": p, "features": f,
            "tf32": [cd, cc, cp, cf], "embed": max(errs)}


def mvs_init_phase(ft_root: str):
    """mvs_init_cloud on the dtu_ft scene (MVS_GROUPS groups of 3 views at
    MVS_WH, 64 depth planes, the port's seeded weights), with seconds per
    group, points before and after the filter and peak memory; then group
    0 card vs CPU (mvs_group_parity). Returns (cloud, mvs_init_kwargs)."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.mvs.points_init import (init_mvs_points,
                                                     new_mvs_model)
    from pointnerf_tpu_torch.train import driver as td
    ds = find_dataset_class_by_name("dtu_ft")(DataConfig(
        dataset_name="dtu_ft", data_root=ft_root, scan=DTU_SCAN),
        split="train")
    model = new_mvs_model(32, n_views=3, device="cuda")
    variables = init_mvs_points(model, torch.Generator().manual_seed(0))
    kw = dict(MVS_INIT_KW, mvs_variables=variables, n_groups=MVS_GROUPS)
    td.mvs_init_cloud(ds, device="cuda", n_groups=1, **{
        k: v for k, v in kw.items() if k != "n_groups"})      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cloud = td.mvs_init_cloud(ds, device="cuda", **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    W, H = MVS_WH
    before = MVS_GROUPS * 3 * (H // 4) * (W // 4)
    n = cloud["xyz"].shape[0]
    log(f"MVS init (dtu_ft, {MVS_GROUPS} groups of 3 views of {W} x {H}, 64 "
        f"depth planes, random weights): {dt / MVS_GROUPS:.4f} s per group "
        f"(host clock, synchronized), {before} depth pixels before the "
        f"filter, {n} points after; peak memory {peak:.2f} GiB")
    if n == 0 or not all(np.isfinite(v).all() for v in cloud.values()):
        fail(f"MVS init gave {n} points or non-finite payloads")
    parity = mvs_group_parity(ds, model, variables)
    return cloud, kw, {"s_per_group": dt / MVS_GROUPS, "points_before":
                       before, "points_after": n, "peak_gib": peak,
                       **parity}


def dtu_ft_path(kernels, ft_root: str, cloud, mvs_kw):
    """train_dataset_scene("dtu_ft") with no cloud on disk (it builds one
    with mvs_init_cloud) for FT_STEPS steps at scene_config() of the MVS
    cloud with the schedule cut (a prune at FT_STEPS / 2 with prune_thresh
    at the cloud's median conf, an eval of the test views and a checkpoint
    at FT_STEPS), then test_dataset_scene (the two PSNRs equal), then a
    resume to FT_RESUME_TO: every step launches K3 and K4 f32 once, every
    eval chunk K3 f32 and K2 once, K1 never; the loaded states equal the
    saved ones bit for bit. Returns (recorder, counts, routes, numbers)."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig, scene_config
    from pointnerf_tpu_torch.data.dtu_ft import DtuFtDataset
    from pointnerf_tpu_torch.train import driver as td
    ds = DtuFtDataset(DataConfig(dataset_name="dtu_ft", data_root=ft_root,
                                 scan=DTU_SCAN), split="test")
    cfg = scene_config(cloud["xyz"], near=float(ds.near), far=float(ds.far))
    thresh = float(np.median(cloud["conf"]))
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=FT_STEPS, prune_iter=FT_STEPS // 2,
        prune_max_iter=FT_STEPS // 2, prune_thresh=thresh, prob_freq=0, test_freq=FT_STEPS,
        save_iter_freq=FT_STEPS, print_freq=FT_STEPS // 2))
    rec = MaintRecorder(cfg, kernels, ("fused_decode", "fused_decode_bwd"),
                        ("fused_decode", "fused_march"),
                        record_step=FT_STEPS // 2)
    reset_counts(kernels)
    rec.install()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    try:
        with tempfile_dir(build) as run_dir:
            t0 = time.perf_counter()
            state, st, hist = td.train_dataset_scene(
                "dtu_ft", ft_root, DTU_SCAN, run_dir, max_steps=FT_STEPS,
                cfg=cfg, resume=False, mvs_init_kwargs=mvs_kw, device="cuda")
            t1 = time.perf_counter()
            m = td.test_dataset_scene("dtu_ft", ft_root, DTU_SCAN, run_dir,
                                      cfg=cfg, save_images=False,
                                      mvs_init_kwargs=mvs_kw, device="cuda")
            t2 = time.perf_counter()
            state2, _st2, _h2 = td.train_dataset_scene(
                "dtu_ft", ft_root, DTU_SCAN, run_dir, max_steps=FT_RESUME_TO,
                cfg=cfg, resume=True, mvs_init_kwargs=mvs_kw, device="cuda")
    finally:
        rec.restore()
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("fused_decode", "fused_decode_bwd")}
    steps = len(rec.times["train_step"])
    frames = len(rec.times["eval_frame"])
    chunks = -(-MVS_WH[0] * MVS_WH[1] // 9216)
    if int(state.step) != FT_STEPS or int(state2.step) != FT_RESUME_TO \
            or steps != FT_RESUME_TO:
        fail(f"the dtu_ft path took {steps} steps")
    if frames != 2 * len(ds):
        fail(f"the dtu_ft path rendered {frames} eval frames, not "
             f"{2 * len(ds)}")
    want = {"knn_select": 0, "fused_decode": steps + frames * chunks,
            "fused_decode_bwd": steps, "fused_march": frames * chunks}
    if counts != want:
        fail(f"dtu_ft path launches {counts}, expected {want}")
    for n in routes:
        if routes[n]["tensor_core"]:
            fail(f"the dtu_ft path launched {n} on the tensor cores")
    routes["fused_march"] = march_routes(kernels, "dtu_ft")
    kinds = [e for e, _d in rec.log if e != "grid"]
    if kinds.count("prune") != 1 or kinds.count("load") != 2:
        fail(f"dtu_ft path events {kinds}: expected one prune and two loads")
    losses = torch.stack(rec.losses).cpu()
    p_train = hist["eval"][-1]["psnr"] if hist["eval"] else float("nan")
    if not bool(torch.isfinite(losses).all()) \
            or not np.isfinite([p_train, m["psnr"]]).all():
        fail(f"dtu_ft path: losses or PSNR not finite: {losses.tolist()}")
    if not abs(p_train - m["psnr"]) <= 1e-2:
        fail(f"test_dataset_scene PSNR {m['psnr']} differs from the training "
             f"run's eval {p_train} by more than 0.01 dB")
    secs = {k: (sum(v) / len(v) if v else None, len(v))
            for k, v in rec.times.items()}
    log(f"dtu_ft path: {cloud['xyz'].shape[0]} MVS points (prune_thresh "
        f"{thresh:.5f}, the median conf: prune "
        f"{[d for e, d in rec.log if e == 'prune']}), {FT_STEPS} steps of "
        f"{cfg.train.random_sample_size ** 2} rays, an eval of "
        f"{len(ds)} test views of {MVS_WH[0]} x {MVS_WH[1]} ({chunks} chunks "
        f"each), a checkpoint; test_dataset_scene; a resume to "
        f"{FT_RESUME_TO}: {t1 - t0:.2f} + {t2 - t1:.2f} s (each with its MVS "
        f"init); eval PSNR {p_train:.4f} dB, test {m['psnr']:.4f} dB; "
        f"losses {[round(float(v), 6) for v in losses]}; launches {counts}")
    log("dtu_ft seconds per event (mean, count): " + ", ".join(
        f"{k} {v:.4f} x{c}" for k, (v, c) in secs.items() if v is not None))
    return rec, counts, routes, {"step_s": secs["train_step"][0],
                                 "eval_frame_s": secs["eval_frame"][0],
                                 "psnr": m["psnr"]}


def ff_batch(g, item, cfg, device, half: bool = False):
    """An MVSBatch from a dtu view group and a ray item; `half` takes the
    views at half resolution (2 x 2 block means, intrinsics halved) and
    the rays' pixels halved."""
    import numpy as np
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train import driver as td
    images, Ks = g["images"], g["Ks"]
    if half:
        V, H, W, _ = images.shape
        images = images.reshape(V, H // 2, 2, W // 2, 2, 3).mean((2, 4))
        Ks = Ks.copy()
        Ks[:, :2] *= 0.5
    return td._mvs_batch(images.astype(np.float32), Ks, g["w2cs"],
                         g["depth_values"], ray_batch_from_numpy(
                             item, cfg, device=device), device)


def ff_path(kernels, ff_root: str):
    """train_feedforward_dataset on the dtu scene (nsrc 2, FF_DEPTHS
    planes, FF_RAYS rays a step, MVS_WH, the driver's own config) for
    FF_WARMUP + FF_STEPS steps: each step launches K3 f32 and K4 f32 once,
    K2 and K1 never; the loss stays finite; MVSNet's and the aggregator's
    weights move. Records the K3/K4 inputs of the first timed step.
    Returns (counts, routes, step inputs, the last state, cfg, model,
    numbers)."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.train import driver as td
    from pointnerf_tpu_torch.train import feedforward as tff
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    real_make, real_create = tff.make_feedforward_step, tff.create_ff_state
    got = {"times": [], "losses": [], "inputs": None}

    def create(*a, **k):
        s = real_create(*a, **k)
        got["init"] = tree_map(lambda t: t.clone(), s.params)
        return s

    def make(cfg, model, capacity):
        step, infer = real_make(cfg, model, capacity)
        got.update(cfg=cfg, model=model, capacity=capacity)

        def timed(state, batch, u=None):
            i = len(got["times"])
            before = {n: kernels[n].launches for n in kernels}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (recording_decode() if i == FF_WARMUP
                  else contextlib.nullcontext()) as seen:
                state, items = step(state, batch, u=u)
            torch.cuda.synchronize()
            got["times"].append(time.perf_counter() - t0)
            if i == FF_WARMUP:
                got["inputs"] = seen
            d = {n: kernels[n].launches - before[n] for n in kernels}
            if d != {"knn_select": 0, "fused_decode": 1,
                     "fused_decode_bwd": 1, "fused_march": 0}:
                fail(f"feed-forward step {i} launched {d}")
            got["losses"].append(items["loss_total"])
            got["state"] = state
            return state, items
        return timed, infer
    reset_counts(kernels)
    tff.make_feedforward_step, tff.create_ff_state = make, create
    torch.cuda.reset_peak_memory_stats()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    try:
        with tempfile_dir(build) as run_dir:
            state, _infer = td.train_feedforward_dataset(
                ff_root, DTU_SCAN, run_dir, max_steps=FF_WARMUP + FF_STEPS,
                nsrc=2, n_depths=FF_DEPTHS, n_rays=FF_RAYS,
                log_every=FF_WARMUP + FF_STEPS, device="cuda")
    finally:
        tff.make_feedforward_step, tff.create_ff_state = real_make, real_create
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("fused_decode", "fused_decode_bwd")}
    for n in routes:
        if routes[n]["tensor_core"]:
            fail(f"the feed-forward path launched {n} on the tensor cores")
    routes["fused_march"] = march_routes(kernels, "feed-forward")
    losses = torch.stack(got["losses"]).cpu()
    if len(losses) != FF_WARMUP + FF_STEPS \
            or not bool(torch.isfinite(losses).all()):
        fail(f"feed-forward losses {losses.tolist()}")
    moved = {g: sum(int(not torch.equal(a, b)) for a, b in zip(
        tree_leaves(state.params[g]), tree_leaves(got["init"][g])))
        for g in ("mvs", "mlp")}
    if not moved["mvs"] or not moved["mlp"]:
        fail(f"feed-forward training moved no weight of a group: {moved}")
    s = float(np.mean(got["times"][FF_WARMUP:]))
    cfg = got["cfg"]
    log(f"feed-forward path (dtu, nsrc 2, {FF_DEPTHS} planes, {FF_RAYS} "
        f"rays a step, {MVS_WH[0]} x {MVS_WH[1]}, capacity "
        f"{got['capacity']} points; agg H={cfg.agg.shading_feature_num}, "
        f"K={cfg.query.K}, SR={cfg.query.SR}, "
        f"{cfg.train.compute_dtype}): {FF_STEPS} steps after {FF_WARMUP}, "
        f"{s:.4f} s/step = {FF_RAYS / s:.1f} rays/s (host clock, "
        f"synchronized, the loader's PNG reads outside); weights moved "
        f"{moved}; losses {[round(float(v), 6) for v in losses]}; peak "
        f"memory {peak:.2f} GiB; launches {counts}")
    return counts, routes, got["inputs"], got["state"], cfg, got["model"], {
        "s_per_step": s, "rays_per_s": FF_RAYS / s, "peak_gib": peak}


def ff_cloud(model, cap, mvs, stats, batch, train: bool = True):
    """gen_cloud on the device of `batch` with the MVS weights as leaves:
    (leaves, cloud, static, new running stats)."""
    import torch
    from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision
    from pointnerf_tpu_torch.train import feedforward as tff
    from pointnerf_tpu_torch.train.optim import tree_map
    dev = batch.rays.raydir.device
    mvs = tree_map(lambda t: t.detach().to(dev).requires_grad_(), mvs)
    with torch.enable_grad(), mvs_precision():
        pc, st, new_stats = tff.gen_cloud(model, cap, mvs, stats, batch,
                                          train)
    return mvs, pc, st, new_stats


def ff_render(cfg, mlp, pc, st, batch, u):
    """The step's training render and loss on a fixed cloud, on the device
    of `batch`: (loss, the MLPs' gradients, the cloud's gradients), on the
    CPU."""
    import torch
    from pointnerf_tpu_torch.models.losses import compute_losses
    from pointnerf_tpu_torch.models.points import PointCloud
    from pointnerf_tpu_torch.models.renderer import render_rays
    from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    dev = batch.rays.raydir.device
    mlp = tree_map(lambda t: t.detach().to(dev).requires_grad_(), mlp)
    pc = PointCloud(*[t.detach().to(dev).requires_grad_() for t in pc])
    st = type(st)(*[t.to(dev) for t in st])
    wrt = tree_leaves(mlp) + list(pc)
    with torch.enable_grad(), mvs_precision():
        grid = build_grid(pc.xyz.detach(), st.num_active, cfg.query)
        out = render_rays(mlp, pc, st, grid, batch.rays, cfg, train=True,
                          u=u.to(dev))
        total, _ = compute_losses(out, batch.rays.gt_image, cfg.loss)
        g = torch.autograd.grad(total, wrt, allow_unused=True)
    g = [(torch.zeros_like(w) if x is None else x).cpu()
         for w, x in zip(wrt, g)]
    n = len(tree_leaves(mlp))
    return float(total.detach()), g[:n], g[n:]


def ff_mvs_grads(mvs, pc, cot):
    """MVSNet's (and the embedding's) backward of the cotangent `cot` on
    the cloud `pc` that ff_cloud made: the MVS leaves' gradients, on the
    CPU."""
    import torch
    from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision
    from pointnerf_tpu_torch.train.optim import tree_leaves
    dev = pc.xyz.device
    outs = [(o, c.to(dev)) for o, c in zip(pc, cot) if o.requires_grad]
    wrt = tree_leaves(mvs)
    with mvs_precision():
        g = torch.autograd.grad([o for o, _ in outs], wrt,
                                [c for _, c in outs], allow_unused=True)
    return [(torch.zeros_like(w) if x is None else x).cpu()
            for w, x in zip(wrt, g)]


def ff_parity(state, cfg, model, ff_root: str):
    """One feed-forward step card vs CPU from the same state at
    FF_PARITY_WH (the dtu scene's group 0 at half resolution; widths and
    depth planes kept), split at its cloud. The cloud (train-mode MVSNet
    and the embedding) and the new running stats, beside the CPU with
    eval-mode BatchNorm. The render of one cloud, the card's, on each side
    (the loss, the MLPs' and the cloud's gradients), beside the CPU with a
    bf16 decode. MVSNet's backward of one cotangent on each side, beside
    eval-mode BatchNorm: the CPU render's cloud gradients, zero on the few
    points (at most FF_FLIP_MAX) where the two clouds differ by more than
    FF_FLIP_TOL of a tensor's scale. The whole step's loss and gradients
    card vs CPU are printed. Then infer_cloud card vs CPU: num_active
    equal, xyz within FF_XYZ_TOL."""
    import copy
    import torch
    from pointnerf_tpu_torch.config import DataConfig
    from pointnerf_tpu_torch.data.dtu import DtuDataset
    from pointnerf_tpu_torch.train import feedforward as tff
    from pointnerf_tpu_torch.train.optim import tree_map
    ds = DtuDataset(DataConfig(dataset_name="dtu", data_root=ff_root,
                               scan=DTU_SCAN), split="train", nsrc=2,
                    n_depths=FF_DEPTHS)
    g = ds.get_mvs_item(0)
    item = ds.get_item(0, random_sample="random", random_sample_size=32,
                       seed=0)
    cpu = torch.device("cpu")
    b_card = ff_batch(g, item, cfg, "cuda", half=True)
    b_cpu = ff_batch(g, item, cfg, cpu, half=True)
    W, H = FF_PARITY_WH
    cap = (W // 4) * (H // 4)
    u = torch.rand((b_cpu.rays.raydir.shape[0], cfg.query.z_depth_dim),
                   generator=torch.Generator().manual_seed(3))
    m_cpu = copy.deepcopy(model).to(cpu)
    p_cpu = tree_map(lambda t: t.to(cpu), state.params)
    s_cpu = {k: v.to(cpu) for k, v in state.mvs_stats.items()}
    # the whole step, printed
    whole = {"card": tff.ff_loss_and_grads(cfg, model, cap, state.params,
                                           state.mvs_stats, b_card,
                                           u=u.cuda()),
             "cpu": tff.ff_loss_and_grads(cfg, m_cpu, cap, p_cpu, s_cpu,
                                          b_cpu, u=u)}
    t_cpu = float(whole["cpu"][0])
    log(f"feed-forward step card vs CPU ({W} x {H} views, "
        f"{b_cpu.rays.raydir.shape[0]} rays, capacity {cap}), the whole "
        f"step, printed (train-mode BatchNorm's rounding moves the cloud, "
        f"and the render turns that into a few rays' colors): loss "
        f"{abs(float(whole['card'][0]) - t_cpu) / abs(t_cpu):.3e}, " +
        ", ".join(f"{grp} gradients " + format(_sum_rel(
            whole["card"][2][grp], whole["cpu"][2][grp]), ".3e")
            for grp in ("mlp", "mvs")))
    # the step split at its cloud: the clouds
    clouds = {"card": ff_cloud(model, cap, state.params["mvs"],
                               state.mvs_stats, b_card),
              "cpu": ff_cloud(m_cpu, cap, p_cpu["mvs"], s_cpu, b_cpu),
              "eval": ff_cloud(m_cpu, cap, p_cpu["mvs"], s_cpu, b_cpu,
                               train=False)}
    ref = clouds["cpu"]
    err = {k: {"cloud": _sum_rel([t.detach() for t in clouds[k][1]],
                                 [t.detach() for t in ref[1]]),
               "stats": max(_rel(clouds[k][3][n], ref[3][n])
                            for n in ref[3])} for k in ("card", "eval")}
    # the render of the card's cloud, on each side
    pc_g, st_g = clouds["card"][1], clouds["card"][2]
    ren = {"card": ff_render(cfg, state.params["mlp"], pc_g, st_g, b_card,
                             u),
           "cpu": ff_render(cfg, p_cpu["mlp"], pc_g, st_g, b_cpu, u),
           "bf16": ff_render(cfg.replace(train=dataclasses.replace(
               cfg.train, compute_dtype="bf16")), p_cpu["mlp"], pc_g, st_g,
               b_cpu, u)}
    L_x = ren["cpu"][0]
    for k in ("card", "bf16"):
        err.setdefault(k, {}).update(loss=abs(ren[k][0] - L_x) / abs(L_x),
                      mlp=_sum_rel(ren[k][1], ren["cpu"][1]),
                      dcloud=_sum_rel(ren[k][2], ren["cpu"][2]))
    # MVSNet's backward of one cotangent, on each side
    per_point = torch.stack([
        (a.detach().cpu() - b.detach()).abs().reshape(a.shape[0], -1)
        .max(1).values / max(float(b.detach().abs().max()), 1e-30)
        for a, b in zip(pc_g, ref[1])], 1).max(1).values
    keep = (per_point <= FF_FLIP_TOL).float()
    flips = int(keep.numel() - keep.sum())
    cot = [c * keep.reshape(-1, *([1] * (c.dim() - 1)))
           for c in ren["cpu"][2]]
    mvs_g = {k: ff_mvs_grads(clouds[k][0], clouds[k][1], cot)
             for k in clouds}
    for k in ("card", "eval"):
        err[k]["mvs"] = _sum_rel(mvs_g[k], mvs_g["cpu"])
    log("feed-forward step card vs CPU split at the cloud: the cloud per "
        "tensor, max |err| / max |CPU|, " + ", ".join(
            f"{n} {_rel(a.detach(), b.detach()):.3e}" for n, a, b in zip(
                ("xyz", "features", "conf", "color", "dirs"), pc_g, ref[1]))
        + f"; {flips} of {keep.numel()} points beyond {FF_FLIP_TOL:.0e} of "
        f"a tensor's scale (at most {FF_FLIP_MAX}) carry no cotangent into "
        f"MVSNet's backward")
    if flips > FF_FLIP_MAX:
        fail(f"the feed-forward clouds card vs CPU differ beyond rounding at "
             f"{flips} points")
    for name, key, ctl, ctl_is in (
            ("the running stats, worst max |err| / max |CPU|", "stats",
             "eval", "eval-mode BatchNorm"),
            ("the cloud (train-mode MVSNet and the embedding), sum |err| / "
             "sum |CPU|", "cloud", "eval", "eval-mode BatchNorm"),
            ("MVSNet's backward of one cotangent, sum |err| / sum |CPU|",
             "mvs", "eval", "eval-mode BatchNorm"),
            ("the render of the card's cloud, loss relative", "loss", "bf16",
             "a bf16 decode"),
            ("the render of the card's cloud, the MLPs' gradients, sum "
             "|err| / sum |CPU|", "mlp", "bf16", "a bf16 decode"),
            ("the render of the card's cloud, the cloud's gradients, sum "
             "|err| / sum |CPU|", "dcloud", "bf16", "a bf16 decode")):
        hold_bf16(f"feed-forward {name}, card vs CPU", err["card"][key],
                  err[ctl][key], FF_TOL[key], ctl_is)
    out = dict(err, flips=flips)
    step, infer = tff.make_feedforward_step(cfg, model, cap)
    _s, infer_cpu = tff.make_feedforward_step(cfg, m_cpu, cap)
    pc_card, st_card = infer(state.params, state.mvs_stats, b_card)
    pc_cpu, st_cpu = infer_cpu(p_cpu, s_cpu, b_cpu)
    n = int(st_cpu.num_active)
    xyz_err = _rel(pc_card.xyz[:n], pc_cpu.xyz[:n])
    log(f"infer_cloud card vs CPU: num_active {int(st_card.num_active)} / "
        f"{n}, xyz max|err|/scale {xyz_err:.3e} (bar {FF_XYZ_TOL})")
    if int(st_card.num_active) != n or not xyz_err <= FF_XYZ_TOL:
        fail("infer_cloud card vs CPU beyond its bar")
    out["xyz"] = xyz_err
    return out


def mvs_paths(kernels, root: str):
    """The MVS phases on a DTU-format cluster scene written under `root`:
    MVS init (mvs_init_phase), dtu_ft per-scene training from its cloud
    (dtu_ft_path), feed-forward training (ff_path) and its card-vs-CPU step
    (ff_parity), then K3 f32 and K4 f32 on the first timed feed-forward
    step's inputs and K3 f32 and K2 on a dtu_ft eval chunk's, against their
    plain versions. Returns (launch counts, routes, kernel checks,
    numbers)."""
    t0 = time.perf_counter()
    ft_root, ff_root = write_dtu_scenes(root)
    log(f"DTU-format scenes written under {root}: {MVS_VIEWS} views of "
        f"{MVS_WH[0]} x {MVS_WH[1]} in {time.perf_counter() - t0:.2f} s")
    cloud, mvs_kw, nums = mvs_init_phase(ft_root)
    rec, c_ft, r_ft, nums["dtu_ft"] = dtu_ft_path(kernels, ft_root, cloud,
                                                   mvs_kw)
    chunk = rec.captured.get("eval_chunk")
    if chunk is None:
        fail("no dtu_ft eval chunk's kernel inputs were recorded")
    del rec
    c_ff, r_ff, inputs, state, cfg, model, nums["ff"] = ff_path(kernels,
                                                                ff_root)
    nums["ff_parity"] = ff_parity(state, cfg, model, ff_root)
    if inputs is None or "fused_decode_bwd" not in inputs:
        fail("the feed-forward step's decode inputs were not recorded")
    k3, k4 = check_f32_decode(
        [("feed-forward step", inputs["fused_decode"]),
         ("dtu_ft eval chunk", chunk["fused_decode"][0])],
        inputs["fused_decode_bwd"])
    checks = {"mvs_ff_step": {"fused_decode_f32": k3["feed-forward step"],
                              "fused_decode_bwd_f32": k4},
              "mvs_dtu_ft_eval_chunk": {
                  "fused_decode_f32": k3["dtu_ft eval chunk"],
                  "fused_march": check_k2(*chunk["fused_march"])}}
    counts = {n: c_ft[n] + c_ff[n] for n in c_ft}
    routes = {n: {k: r_ft[n][k] + r_ff[n][k] for k in r_ft[n]} for n in r_ft}
    return counts, routes, checks, nums


# ---- the 2D neural-render heads: the feature render at C = 128 decoded by
# the CNN or the StyleGAN2 head, and the adversarial step ------------------
N2D_C = 128                  # the fork's shading_color_channel_num
N2D_PATCH = 48               # the fork's largest training chunk, 48 x 48 rays
N2D_WH = (256, 256)          # the views the patches are cut from
N2D_REQUESTS = 4
N2D_WARMUP = 3
N2D_STEPS = 10
N2D_FRAMES = 8               # per-frame style codes
N2D_Z = 512                  # StyleGAN2's latent_dim and emb (its defaults)
N2D_MAP_DEPTH = 8            # StyleVectorizer depth (StyleGAN2's default)
N2D_GP_EVERY = 4             # make_gan_step's default cadence
N2D_FINE = 80                # the fine pass at C = 128: SR' = 80 + 80
# the launches of each kernel per step or request
N2D_STEP = {"knn_select": 1, "fused_decode": 1, "fused_decode_bwd": 1,
            "fused_march": 0}
N2D_GAN_STEP = {"knn_select": 2, "fused_decode": 2, "fused_decode_bwd": 1,
                "fused_march": 0}
N2D_REQUEST = {"knn_select": 1, "fused_decode": 1, "fused_decode_bwd": 0,
               "fused_march": 1}
# card vs CPU. The features of the rays that hit of a 512-ray request at
# C = 128 (sigmoid colors, absolute; control: the CPU with an f32 decode).
# Readings on an H100 80GB HBM3 at 700 W (PERF.md §6): 8.035e-06, control
# 1.484e-04
N2D_FEAT_TOL = 3e-5
# One step from the state the timed steps left, the losses (relative) and
# each group's gradients (sum |err| / sum |CPU|), each with the control
# that moves it: the CPU with an f32 decode where the decode's roundings
# lead (the aggregator's and the points' gradients, the CNN's loss and
# head), the card with cuDNN's convolutions in TF32 where the StyleGAN2
# generator's and the discriminator's convolutions lead (the GAN's losses,
# D, and the style side; an f32 decode moves those less than the card does).
# Readings on an H100 80GB HBM3 at 700 W over 31 trained states
# (chip_smoke.py runs, and scripts/parity_readings.py --phase n2d over 6,
# then 20 states; PERF.md §6), highest reading / lowest control: CNN loss
# 2.3e-07 / 7.7e-05, mlp 2.3e-04 / 1.5e-02, points 2.9e-04 / 4.4e-03, head
# 3.9e-04 / 3.7e-03; GAN loss_total 3.9e-06 / 2.2e-05, recon 9.6e-07 / 3.5e-06, adversarial
# 3.5e-06 / 2.9e-05, D 9.3e-07 / 7.7e-06, penalty 7.2e-06 / 7.6e-04, mlp
# 1.8e-03 / 1.0e-02, points 9.7e-04 / 1.6e-02, head 3.0e-05 / 1.1e-04,
# style 2.1e-05 / 7.3e-05, stylevec 2.0e-05 / 9.6e-05, d 4.7e-05 / 8.5e-04.
# The states differ run to run (the payload gather's backward adds with
# atomics), so where the two lie within a decade the bar sits near their
# geometric mean, at least 1.8x from each (the CNN head). The GAN step's
# losses, head, style, stylevec and D are held on the split below
N2D_TOL = {"cnn": {"loss_total": (1e-5, "f32"), "mlp": (2e-3, "f32"),
                   "points": (1.5e-3, "f32"), "head": (1.2e-3, "f32")},
           "gan": {"mlp": (4e-3, "f32"), "points": (4e-3, "f32")}}
# The GAN step is held in parts split where the roundings enter, each part
# beside the control it fails (PERF.md §6; readings on an H100 80GB
# HBM3 at 700 W through scripts/parity_readings.py --phase n2d). On the
# whole step the decode's roundings reach the generator through the two
# feature images: the head gradient read up to 3.8e-05 against an
# f32-decode control down to 1.2e-05 (an earlier run: 8.7e-05 against
# 9.5e-05), and the TF32 controls of loss_recon (down to 9.6e-07) and
# loss_gp (4.6e-05) fell below their bars. In bf16 the card's and the
# CPU's feature images differ as much as an f32 decode moves them (2.4e-03
# to 4.7e-03 of sum |CPU| both), so the images are printed and the
# decode's side is held by the aggregator's and the points' gradients of
# the whole step (N2D_TOL). The rest is held on the step with the card's
# feature images fed to both sides (gan_fixed_parity). There D's leaky
# ReLUs took another branch on the card than on the CPU in about 1 state
# of 20 — a pre-activation rounded across 0, in the penalty's double
# backward (loss_gp 9.9e-04) or in D's forward —, which moved D's update
# and the generator's adversarial gradient by 20x (head 3.4e-05, style
# 5.0e-05, stylevec 5.6e-05, TF32 controls down to 7.3e-05). So the card's
# branches are fed to the other sides too (`lrelu_branches`: each leaky
# ReLU of the heads takes the card's x >= 0 mask, in call order), and a
# branch then moves nothing but by its own rounding. Held there, relative
# (losses) or sum |err| / sum |CPU| (gradients), beside the card with TF32
# convolutions on the same images and branches, over 40 trained states
# (20 with the branches fed, 20 before, in which no branch flipped), the
# highest reading / the lowest control: loss_total 1.08e-06 / 2.95e-05,
# loss_recon 4.4e-07 / 1.39e-06, loss_g_adv 9.1e-07 / 2.85e-05, loss_gp
# 7.8e-06 / 6.9e-05, loss_d 7.0e-07 / 1.59e-05, head 1.37e-06 / 1.04e-04,
# style 1.02e-06 / 3.44e-05, stylevec 1.11e-06 / 4.36e-05, d 1.27e-06 /
# 2.76e-04; each bar near their geometric mean
N2D_GAN_FIXED_TOL = {"loss_total": 5.5e-6, "loss_recon": 8e-7,
                     "loss_g_adv": 5e-6, "loss_gp": 2.3e-5, "loss_d": 3.3e-6,
                     "head": 1.2e-5, "style": 6e-6, "stylevec": 7e-6,
                     "d": 1.9e-5}
# the tensor-core K4 in bf16 on a neural2d step, its largest errors
# (hold_k4_tc_tiles): row gradients per tile of TC_ROWS_BWD rows, max
# |kernel - plain| / max |plain| over the tile's rows, that max floored at
# TC_K4_BF16_TILE_FLOOR of the tensor's; the control, the tile that holds
# the tensor's max |plain| left out, reads 1. dW / db relative to
# max|plain|, the control the median live tile left out. Readings on an
# H100 80GB HBM3 at 700 W (n2d_path per trained state, as
# scripts/parity_readings.py --phase n2d drives it; PERF.md §6): unfloored
# over 80 states g_feat up to 0.300, g_dists 0.311, g_extras 0.373, g_w
# 0.024; floored over 20 more g_feat 0.273, g_dists 0.191, g_extras 0.333
# — their largest errors sit in tiles of large gradients, so their bar
# stays near the geometric mean of 0.373 and 1 — and g_w 0.0026, held at
# 0.05; dW / db up to 9.2e-05 (dblock3) over 80 states, controls from
# 5.55e-04
TC_K4_BF16_TILE_FLOOR = 0.1
TC_K4_BF16_TILE_TOL = {None: 0.6, "g_w": 0.05}
TC_K4_BF16_DW_TOL = 2.2e-4


def n2d_config():
    """bench_config with the kernel flags on, at the fork's 128 feature
    channels."""
    cfg = slice_config()
    return cfg.replace(agg=dataclasses.replace(
        cfg.agg, shading_color_channel_num=N2D_C))


def n2d_patch(cfg, view: int, device):
    """The rays of the N2D_PATCH x N2D_PATCH window at the centre of ring
    view `view` (row-major, as the feature image lays them out) and its
    analytic ground truth [N2D_PATCH, N2D_PATCH, 3]."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    from pointnerf_tpu_torch.data.synthetic import (ring_cameras,
                                                    sphere_gt_render)
    from pointnerf_tpu_torch.models.renderer import RayBatch
    campos, rot, K = ring_cameras(n_views=N2D_REQUESTS, wh=N2D_WH)[view]
    patch = N2D_PATCH
    x0, y0 = N2D_WH[0] // 2 - patch // 2, N2D_WH[1] // 2 - patch // 2
    gx, gy = np.meshgrid(np.arange(x0, x0 + patch),
                         np.arange(y0, y0 + patch))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    raydir = get_dtu_raydir(pix, K, rot, True).astype(np.float32)
    gt = sphere_gt_render(campos, raydir).reshape(patch, patch, 3)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)
    return RayBatch(campos=t(campos), camrotc2w=t(rot), raydir=t(raydir),
                    pixel_idx=t(pix, torch.int32),
                    near=t(cfg.render.near_plane),
                    far=t(cfg.render.far_plane), gt_image=None), t(gt)


def n2d_heads(device):
    """The heads at the fork's widths, random weights from seeds: the CNN
    (NeuralRenderer at JAX's defaults, input 128), the one-layer StyleGAN2
    generator and its StyleVectorizer, N2D_FRAMES style codes, the
    discriminator of the patch."""
    import torch
    from pointnerf_tpu_torch.models import neural_render as nr
    mods = {"cnn": nr.NeuralRenderer(n_feat=128, input_dim=N2D_C,
                                     img_size=64, min_feat=32),
            "gen": nr.Generator(image_size=128, latent_dim=N2D_Z,
                                network_capacity=16, fmap_max=512,
                                init_channels=N2D_C),
            "vec": nr.StyleVectorizer(N2D_Z, N2D_MAP_DEPTH),
            "disc": nr.Discriminator(N2D_PATCH, network_capacity=16)}
    params = {k: nr.init_neural_render(
        m, torch.Generator().manual_seed(20 + i), device)
        for i, (k, m) in enumerate(mods.items())}
    params["styles"] = torch.randn(
        (N2D_FRAMES, N2D_Z), generator=torch.Generator().manual_seed(30)).to(
        device)
    return mods, params


def n2d_states(kind, hp, params, pc, device, seed=2):
    """A fresh state of `kind` ("cnn", "stylegan" or "gan") on `device`."""
    import torch
    from pointnerf_tpu_torch.train import neural2d as n2
    from pointnerf_tpu_torch.train.optim import tree_map
    cp = lambda t: t.clone()  # noqa: E731
    g = torch.Generator(device=device).manual_seed(seed)
    args = (g, tree_map(cp, params), type(pc)(*[cp(t) for t in pc]))
    style = dict(style_codes=hp["styles"].clone(),
                 stylevec_params=tree_map(cp, hp["vec"]))
    if kind == "cnn":
        return n2.create_neural2d_state(*args, tree_map(cp, hp["cnn"]))
    if kind == "stylegan":
        return n2.create_neural2d_state(*args, tree_map(cp, hp["gen"]),
                                        **style)
    return n2.create_gan_state(*args, tree_map(cp, hp["gen"]),
                               tree_map(cp, hp["disc"]), **style)


def n2d_steps(cfg, heads):
    """{kind: step function} at the fork's widths."""
    from pointnerf_tpu_torch.train import neural2d as n2
    gen = dict(generator=heads["gen"], vectorizer=heads["vec"])
    return {"cnn": n2.make_neural2d_step(cfg, heads["cnn"], N2D_PATCH),
            "stylegan": n2.make_neural2d_step(cfg, None, N2D_PATCH, **gen),
            "gan": n2.make_gan_step(cfg, None, N2D_PATCH, heads["disc"],
                                    gp_every=N2D_GP_EVERY, **gen)}


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def n2d_train(kind, step, state, st, grid, batch, gt, kernels, device,
              record: bool = False):
    """N2D_WARMUP + N2D_STEPS steps of `kind` on one patch: each step's
    launches (N2D_STEP, the GAN step N2D_GAN_STEP: two renders, one
    backward through the decode), the GAN's penalty on its cadence, the
    losses finite and falling (the GAN's reconstruction). With `record`,
    the decode inputs of the first timed step. Returns (state, numbers,
    recorded)."""
    import numpy as np
    import torch
    want = N2D_GAN_STEP if kind == "gan" else N2D_STEP
    frame = 0 if kind == "cnn" else 1
    times, losses, seen = [], [], None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
    for i in range(N2D_WARMUP + N2D_STEPS):
        before = {n: k.launches for n, k in kernels.items()}
        sync(device)
        t0 = time.perf_counter()
        with (recording_decode() if record and i == N2D_WARMUP
              else contextlib.nullcontext()) as rec:
            state, items = step(state, st, grid, batch, gt, frame)
        sync(device)
        times.append(time.perf_counter() - t0)
        if rec is not None:
            seen = rec
        d = {n: k.launches - before[n] for n, k in kernels.items()}
        if d != want:
            fail(f"{kind} step {i} launched {d}, not {want}")
        if kind == "gan":
            gp = float(items["loss_gp"])
            if (gp > 0) != (i % N2D_GP_EVERY == 0):
                fail(f"GAN step {i}: gradient penalty {gp} off its cadence "
                     f"(every {N2D_GP_EVERY})")
        losses.append(float(items["loss_recon" if kind == "gan"
                                  else "loss_total"]))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"{kind} losses not finite or not falling: {losses}")
    s = float(np.mean(times[N2D_WARMUP:]))
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
            else float("nan"))
    own = peak - base if on_card else float("nan")
    nums = {"s_per_step": s, "rays_per_s": N2D_PATCH ** 2 / s,
            "peak_gib": peak, "peak_above_start_gib": own, "losses": losses}
    log(f"n2d {kind} path: {N2D_STEPS} steps of {N2D_PATCH} x {N2D_PATCH} "
        f"rays after {N2D_WARMUP}, {s:.4f} s/step = {N2D_PATCH ** 2 / s:.1f} "
        f"rays/s (host clock, synchronized), peak memory {peak:.2f} GiB "
        f"({own:.2f} GiB above the allocation the run started from); "
        f"losses {[round(v, 6) for v in losses]}")
    return state, nums, seen


def n2d_serve(params, pc, st, grid, cfg, cnn, cnn_params, kernels, device):
    """N2D_REQUESTS feature requests through eval_step (K1, K3, K2 once
    each: K2 on its wide kernel at C = 128), each decoded to RGB by the
    trained CNN head. Returns numbers."""
    import torch
    from pointnerf_tpu_torch.models.neural_render import apply_head
    from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision
    from pointnerf_tpu_torch.train.step import eval_step
    reqs = [n2d_patch(cfg, v, device)[0] for v in range(N2D_REQUESTS)]
    sync(device)
    t0 = time.perf_counter()
    outs = []
    for i, b in enumerate(reqs):
        before = {n: k.launches for n, k in kernels.items()}
        outs.append(eval_step({"mlp": params, "points": pc}, st, grid, b,
                              cfg))
        d = {n: k.launches - before[n] for n, k in kernels.items()}
        if d != N2D_REQUEST:
            fail(f"feature request {i} launched {d}, not {N2D_REQUEST}")
    sync(device)
    dt = time.perf_counter() - t0
    with torch.no_grad(), mvs_precision():
        for i, o in enumerate(outs):
            f = o.coarse_raycolor
            if f.shape != (N2D_PATCH ** 2, N2D_C) \
                    or not bool(torch.isfinite(f).all()):
                fail(f"feature request {i}: not finite or of shape "
                     f"{tuple(f.shape)}")
            img = f.reshape(1, N2D_PATCH, N2D_PATCH, N2D_C).permute(0, 3, 1, 2)
            rgb = apply_head(cnn, cnn_params, img)
            if rgb.shape != (1, 3, N2D_PATCH, N2D_PATCH) \
                    or not bool(torch.isfinite(rgb).all()):
                fail(f"feature request {i}: the CNN head's RGB is not finite")
            log(f"feature request {i}: {int(o.ray_mask.sum())} of "
                f"{N2D_PATCH ** 2} rays hit, decoded to RGB in "
                f"[{float(rgb.min()):.4f}, {float(rgb.max()):.4f}]")
    rate = N2D_REQUESTS * N2D_PATCH ** 2 / dt
    log(f"n2d serving: {N2D_REQUESTS} feature requests of {N2D_PATCH ** 2} "
        f"rays x {N2D_C} channels in {dt:.4f} s = {rate:.1f} rays/s (host "
        f"clock, synchronized; the head's decode outside)")
    return {"rays_per_s": rate}


def state_to(state, device):
    """A neural2d or GAN state with every tensor on `device` (a fresh
    generator there: the parity steps take their draws as arguments)."""
    import torch
    from pointnerf_tpu_torch.train.optim import tree_map
    f = {k: (v if isinstance(v, torch.Generator)
             else tree_map(lambda t: t.to(device), v))
         for k, v in state._asdict().items()}
    f["key"] = torch.Generator(device=device).manual_seed(0)
    return type(state)(**f)


def step_grads(old, new):
    """Each group's gradient of one step, from its Adam first moments:
    g = (mu_new - b1 mu_old) / (1 - b1) (D's b1 is 0.5)."""
    from pointnerf_tpu_torch.train.neural2d import D_B1
    from pointnerf_tpu_torch.train.optim import B1, tree_map
    if hasattr(new, "g_opt_state"):
        pairs = {k: (old.g_opt_state[k].mu, v.mu, B1)
                 for k, v in new.g_opt_state.items()}
        pairs["d"] = (old.d_opt_state.mu, new.d_opt_state.mu, D_B1)
    else:
        pairs = {k: (old.opt_state[k].mu, v.mu, B1)
                 for k, v in new.opt_state.items()}
    return {k: tree_map(lambda a, b, b1=b1: (b - b1 * a) / (1 - b1), o, n)
            for k, (o, n, b1) in pairs.items()}


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN's convolutions in TF32 inside the block, the heads' float32
    guard (mvs_precision) taken out: the control of the quantities no
    decode reaches."""
    import torch
    from pointnerf_tpu_torch.train import neural2d as n2
    real, flag = n2.mvs_precision, torch.backends.cudnn.allow_tf32
    n2.mvs_precision = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        n2.mvs_precision, torch.backends.cudnn.allow_tf32 = real, flag


def n2d_step_parity(kind, heads, state, st, grid, cfg):
    """One step of `kind` ("cnn" or "gan") from `state` (the state the
    timed steps left) on the card and on the CPU (plain versions) with the
    same draws; the GAN step with the penalty on (gp_every 1). The losses
    and each group's gradients (from the moments, `step_grads`) are
    printed, and held at their bars beside a control (N2D_TOL): where the
    decode's roundings lead, the CPU with an f32 decode; where the
    convolutions' lead, the card with them in TF32 (`tf32_convolutions`).
    On the GAN step the convolution-led ones are held with the card's
    feature images and leaky-ReLU branches on both sides
    (`gan_fixed_parity`)."""
    import torch
    from pointnerf_tpu_torch.train import neural2d as n2
    from pointnerf_tpu_torch.train.neural2d import augment_draws
    cpu, card = torch.device("cpu"), torch.device("cuda")
    b_card, gt = n2d_patch(cfg, 0, card)
    b_cpu = type(b_card)(*[None if t is None else t.cpu() for t in b_card])
    g = torch.Generator().manual_seed(3)
    R = N2D_PATCH ** 2
    draws = {"render": torch.rand((R, cfg.query.z_depth_dim), generator=g),
             "render2": torch.rand((R, cfg.query.z_depth_dim), generator=g),
             "aug_d": augment_draws(g, N2D_PATCH, N2D_PATCH, 1.0),
             "aug_g": augment_draws(g, N2D_PATCH, N2D_PATCH, 1.0)}
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  compute_dtype="f32"))
    grid_c = type(grid)(*[None if t is None else t.cpu() for t in grid])
    st_c = type(st)(*[t.cpu() for t in st])
    res, images = {}, {}
    real_render = n2.render_rays
    # the heads run through functional_call with the state's parameters, so
    # one module serves both devices; the "_fixed" sides (GAN only) render
    # nothing and take the card's feature images instead, and the leaky
    # ReLUs' branches of "card_fixed" (`lrelu_branches`)
    sides = [("card", cfg, card), ("cpu", cfg, cpu), ("f32", cfg32, cpu),
             ("tf32", cfg, card)]
    if kind == "gan":
        sides += [(f"{s}_fixed", cfg, dev) for s, dev in (
            ("card", card), ("cpu", cpu), ("tf32", card))]
    branches = []
    for side, c, dev in sides:
        on_card = dev == card
        if kind == "gan":
            step = n2.make_gan_step(
                c, None, N2D_PATCH, heads["disc"], generator=heads["gen"],
                vectorizer=heads["vec"], gp_every=1)
        else:
            step = n2.make_neural2d_step(c, heads["cnn"], N2D_PATCH)
        s0 = state if on_card else state_to(state, cpu)
        args = (s0, st if on_card else st_c, grid if on_card else grid_c,
                b_card if on_card else b_cpu, gt.to(dev),
                0 if kind == "cnn" else 1)
        seen = images.setdefault(side, [])

        def render(*a, _seen=seen, _dev=dev, _side=side, **k):
            if "_fixed" in _side:
                img = images["card"][len(_seen)].to(_dev)
                _seen.append(img)
                return types.SimpleNamespace(coarse_raycolor=img)
            out = real_render(*a, **k)
            _seen.append(out.coarse_raycolor.detach())
            return out
        n2.render_rays = render
        try:
            with (tf32_convolutions() if side.startswith("tf32")
                  else contextlib.nullcontext()), (
                    lrelu_branches(branches, side == "card_fixed")
                    if "_fixed" in side else contextlib.nullcontext()):
                if kind == "gan":
                    new, items = step(*args, draws={
                        k: (v.to(dev) if torch.is_tensor(v) else v)
                        for k, v in draws.items()})
                else:
                    new, items = step(*args, u=draws["render"].to(dev))
        finally:
            n2.render_rays = real_render
        res[side] = ({k: float(v) for k, v in items.items()},
                     step_grads(s0, new))
    out = {}
    quantities = [k for k in res["cpu"][0] if k.startswith("loss_")] + list(
        res["cpu"][1])
    for k in quantities:
        r = {s: step_rel(res, s, "cpu", k) for s in ("card", "f32", "tf32")}
        what = f"n2d {kind} step card vs CPU {quantity_name(k)}"
        log(f"{what} (printed): {r['card']:.3e}; the CPU with an f32 decode "
            f"{r['f32']:.3e}, the card with TF32 convolutions "
            f"{r['tf32']:.3e}")
        out[k] = r
        if k not in N2D_TOL[kind]:
            continue
        bar, ctl_side = N2D_TOL[kind][k]
        hold_bf16(what, r["card"], r[ctl_side], bar,
                  "the CPU with an f32 decode" if ctl_side == "f32"
                  else "the card with TF32 convolutions")
    if kind == "gan":
        out["fixed"] = gan_fixed_parity(res, images)
    return out


def step_rel(res, side, ref_side, k):
    """A quantity of one parity step against another's: a loss relative,
    a group's gradients sum |err| / sum |ref|."""
    if k.startswith("loss_"):
        ref = res[ref_side][0][k]
        if ref == 0:
            fail(f"n2d step: the reference side's {k} is 0")
        return abs(res[side][0][k] - ref) / abs(ref)
    return _sum_rel(res[side][1][k], res[ref_side][1][k])


def quantity_name(k):
    return (f"{k}, relative" if k.startswith("loss_")
            else f"{k} gradients, sum |err| / sum |CPU|")


@contextlib.contextmanager
def lrelu_branches(masks: list, record: bool):
    """The heads' leaky ReLUs (`neural_render._lrelu`) inside the block
    append each call's branch mask x >= 0 to `masks` (record) or take the
    recorded ones in call order instead of their own: the card's branches
    on another side, so that a pre-activation rounded across 0 moves
    nothing but by its rounding."""
    import torch
    from pointnerf_tpu_torch.models import neural_render as nr
    real, it = nr._lrelu, iter(list(masks))

    def lrelu(x):
        if record:
            m = x >= 0
            masks.append(m.detach())
        else:
            m = next(it, None)
            if m is None or m.shape != x.shape:
                fail("lrelu_branches: the leaky ReLUs ran in another order "
                     "than on the recorded side")
            m = m.to(x.device)
        return torch.where(m, x, 0.2 * x)
    nr._lrelu = lrelu
    try:
        yield
    finally:
        nr._lrelu = real
    if not record and next(it, None) is not None:
        fail("lrelu_branches: recorded branches were left unused")


def gan_fixed_parity(res, images):
    """The GAN step with the card's feature images and leaky-ReLU branches
    fed to both sides, card vs CPU: the losses and the generator's and D's
    gradients at N2D_GAN_FIXED_TOL, each beside the card with TF32
    convolutions on the same images and branches; the feature images card
    vs CPU printed (the comment above N2D_GAN_FIXED_TOL)."""
    import torch
    if not all(torch.equal(a, b)
               for a, b in zip(images["card_fixed"], images["card"])):
        fail("n2d gan step: the fixed-image step did not take the card's "
             "feature images")
    img = (sum(float((a.cpu() - b).abs().sum())
               for a, b in zip(images["card"], images["cpu"]))
           / sum(float(b.abs().sum()) for b in images["cpu"]))
    f32 = (sum(float((a - b).abs().sum())
               for a, b in zip(images["f32"], images["cpu"]))
           / sum(float(b.abs().sum()) for b in images["cpu"]))
    log(f"n2d gan step feature images card vs CPU, sum |err| / sum |CPU| "
        f"(printed): {img:.3e}; the CPU with an f32 decode {f32:.3e}")
    what = "the card's feature images and branches on both sides"
    out = {}
    for k, bar in N2D_GAN_FIXED_TOL.items():
        r = {s: step_rel(res, f"{s}_fixed", "cpu_fixed", k)
             for s in ("card", "tf32")}
        hold_bf16(f"n2d gan step card vs CPU {quantity_name(k)}, {what}",
                  r["card"], r["tf32"], bar,
                  "the card with TF32 convolutions")
        out[k] = r
    return out


def n2d_path(kernels):
    """Phase 23 (module docstring). Returns (launch counts, routes, kernel
    checks, numbers)."""
    import torch
    from pointnerf_tpu_torch.train.step import eval_step
    dev = torch.device("cuda")
    cfg = n2d_config()
    pc, st, params, grid = make_scene(cfg, dev)
    heads, hp = n2d_heads(dev)
    batch, gt = n2d_patch(cfg, 0, dev)
    checks, nums = {}, {}

    # (a) K2 at C = 128 on a recorded feature request, SR 80 and the fine
    # pass's 160
    with recording_kernels() as seen:
        eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
    all_recorded(seen, "a feature request")
    log(f"feature request: K2 at C = {N2D_C}, SR = {cfg.query.SR}")
    checks["n2d_request"] = {
        "fused_march_wide": check_k2(*seen["fused_march"], tol=0.0)}
    fine = cfg.replace(render=dataclasses.replace(
        cfg.render, fine_sample_num=N2D_FINE))
    with recording_kernels() as seen:
        eval_step({"mlp": params, "points": pc}, st, grid, batch, fine)
    marches = seen["all"].get("fused_march", [])
    if len(marches) != 2:
        fail(f"the fine feature request launched K2 {len(marches)} times")
    log(f"feature request with the fine pass: K2 at C = {N2D_C}, SR' = "
        f"{marches[1][0][0].shape[1]}")
    checks["n2d_request_fine_sequence"] = {
        "fused_march_wide": check_k2(*marches[1], tol=0.0)}
    del seen, marches

    # the driven runs: the counts from 0, read at the end
    steps = n2d_steps(cfg, heads)
    reset_counts(kernels)
    states, recorded = {}, None
    for kind in ("cnn", "stylegan", "gan"):
        state = n2d_states(kind, hp, params, pc, dev)
        states[kind], nums[kind], rec = n2d_train(
            kind, steps[kind], state, st, grid, batch, gt, kernels, dev,
            record=kind == "cnn")
        recorded = recorded or rec
    trained = states["cnn"].params
    nums["serve"] = n2d_serve(trained["mlp"], trained["points"], st, grid,
                              cfg, heads["cnn"], trained["head"], kernels,
                              dev)
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "n2d", march="wide")
    log(f"n2d path launches {counts}, routes {routes}")

    # (b) a 512-ray feature request card vs CPU, (e) a CNN and a GAN step
    # from the states the timed steps left
    cpu_parity(params, pc, st, grid, cfg, bar=N2D_FEAT_TOL)
    nums["parity"] = {k: n2d_step_parity(k, heads, states[k], st, grid, cfg)
                      for k in ("cnn", "gan")}
    del states
    # (f) K3 and K4 bf16 on the recorded CNN step's inputs
    if recorded is None or "fused_decode_bwd" not in recorded:
        fail("the neural2d step's decode inputs were not recorded")
    with torch.no_grad():
        checks["n2d_step"] = {
            "fused_decode": check_k3([(recorded["fused_decode"], {})],
                                     what="neural2d step")["bf16"],
            "fused_decode_bwd": check_k4(
                recorded["fused_decode_bwd"],
                hold_largest=hold_k4_tc_tiles)["bf16"]}
    return counts, routes, checks, nums


# ---- slice 11: scenes in and out of the port (phases 24-29) ---------------

IO_SCAN = "cluster"
IO_DEVICE = "cuda"             # phases 24-29 run on the card
IO_BLOCKS = (("block1", "aggregator.block1"), ("block3", "aggregator.block3"),
             ("alpha", "aggregator.alpha_branch"),
             ("color", "aggregator.color_branch"))
# the edit composite: part 1 the sphere cropped to x <= EDIT_CROP_X, part 2
# the whole sphere turned 90 degrees about z and moved by EDIT_T (both stay
# inside bench_config's +-0.8 box)
EDIT_CROP_X = -0.1
EDIT_T = (0.25, 0.0, 0.0)
RZ90 = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))
RY90 = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0))
# the identity composite (one part, R = I, t = 0) against the global-Rw2c
# path, max |color| difference on the rays that hit (control: the per-point
# rotations turned by EDIT_CONTROL_DEG about z); and frame invariance (the
# part and the camera turned by RY90 against the unturned render), mean
# |color| difference on the rays both hit (control: the turned composite
# with its per-point rotations set to I). Bars from readings on an H100
# 80GB HBM3 at 700 W (PERF.md §6): identity 4.8e-05 (the bf16 color head
# rounds the normalized-weight sum of the view PE otherwise), control
# 5.3e-04; frame invariance 4.9e-06, control 1.9e-03.
EDIT_IDENTITY_TOL = 1.5e-4
EDIT_CONTROL_DEG = 1.0
EDIT_FRAME_TOL = 1e-4
SCANNET_SCAN = "scene0241_01"
SCANNET_PRESET = "scannet/scene241"
SCANNET_WH = (1296, 968)         # ScanNet's color frames
SCANNET_DEPTH_WH = (640, 480)    # and its depth frames
SCANNET_FRAMES = 5               # one test frame (1 in 5), four train frames
SCANNET_STEPS = 10
SCANNET_FOCAL = 1170.0           # ScanNet's color intrinsics are ~1170 px
PNG_FILTERS = (0, 1, 2, 3, 4)    # row r of a written frame: filter r % 5
LLFF_WH = (252, 189)             # images_4 of LLFF's 1008 x 756 captures
LLFF_FRAMES = 9                  # every 8th a test frame: 7 train, 2 test
LLFF_FOCAL = 200.0               # at images_4's size
LLFF_STEPS = 6
VIDEO_FRAMES = 4


def io_reference_dict(pc, n: int, params):
    """A reference-format `net_ray_marching` state dict of the first `n`
    points of `pc` and the aggregator `params`, built by hand (not by the
    exporter): the DataParallel "module." prefix, [1, N, *] point tensors,
    Linear pairs at even Sequential indices with [out, in] weights."""
    import torch

    def t(x):
        return x.detach().to("cpu", torch.float32).contiguous()
    sd = {"neural_points.xyz": t(pc.xyz[:n]),
          "neural_points.points_embeding": t(pc.features[:n])[None],
          "neural_points.points_conf": t(pc.conf[:n])[None],
          "neural_points.points_dir": t(pc.dirs[:n])[None],
          "neural_points.points_color": t(pc.color[:n])[None],
          "neural_points.Rw2c": torch.eye(3)}
    for ours, prefix in IO_BLOCKS:
        for i, layer in enumerate(params[ours]):
            sd[f"{prefix}.{2 * i}.weight"] = t(layer["w"]).T.contiguous()
            sd[f"{prefix}.{2 * i}.bias"] = t(layer["b"])
    return {"module." + k: v for k, v in sd.items()}


def edit_parts(pc, n: int):
    """The two parts of the edit composite from the bench scene's points."""
    import numpy as np
    from pointnerf_tpu_torch.edit import ScenePart
    arrays = {f: getattr(pc, f)[:n].cpu().numpy()
              for f in ("xyz", "features", "conf", "color", "dirs")}
    return [ScenePart(**arrays, crop_aabb=(-1.0, -1.0, -1.0, EDIT_CROP_X,
                                           1.0, 1.0)),
            ScenePart(**arrays, R=np.asarray(RZ90, np.float32),
                      t=np.asarray(EDIT_T, np.float32))]


def serve_requests(params, pc, st, grid, reqs, cfg, kernels, what: str,
                   want=None):
    """eval_step over `reqs`; each request must launch K1, K3 and K2 once
    (or as `want` says). Returns (outputs, seconds)."""
    import torch
    from pointnerf_tpu_torch.train.step import eval_step
    want = want or {"knn_select": 1, "fused_decode": 1, "fused_march": 1,
                    "fused_decode_bwd": 0}
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, b in enumerate(reqs):
        before = {n: k.launches for n, k in kernels.items()}
        outs.append(eval_step({"mlp": params, "points": pc}, st, grid, b,
                              cfg))
        got = {n: k.launches - before[n] for n, k in kernels.items()}
        if got != want:
            fail(f"{what} request {i} launched {got}, not {want}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        if not bool(torch.isfinite(o.coarse_raycolor).all()):
            fail(f"{what} request {i}: colors not finite")
    return outs, dt


def same_render_integers(a, b, what: str):
    import torch
    for f in ("ray_valid", "ray_mask", "decode_dropped", "neighbor_pidx"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            fail(f"{what}: {f} differs")


def render_kernel_checks(params, pc, st, grid, reqs, cfg, what: str):
    """K1 and K2 bit-equal to their plain versions and K3 bf16 at its bars
    on the recorded inputs of `reqs` (K1 and K2 on the first)."""
    seen = [capture_kernel_inputs(params, pc, st, grid, b, cfg)
            for b in reqs]
    out = {"knn_select": check_k1(*seen[0]["knn_select"]),
           "fused_march": check_k2(*seen[0]["fused_march"], tol=0.0),
           "fused_decode": check_k3([s["fused_decode"] for s in seen],
                                    what=what)["bf16"]}
    return out


def import_path(kernels, params, pc, st, grid, reqs, cfg, root: str):
    """Phase 24 (module docstring). Returns (counts, routes, checks)."""
    import importlib.util

    import torch
    from pointnerf_tpu_torch.edit import compose_parts
    from pointnerf_tpu_torch.train.step import eval_step, refresh_grid
    from pointnerf_tpu_torch.train.torch_import import (
        export_reference_scene, import_reference_scene)
    n = int(st.num_active)
    os.makedirs(root, exist_ok=True)
    sd = io_reference_dict(pc, n, params)
    path = os.path.join(root, "100000_net_ray_marching.pth")
    t0 = time.perf_counter()
    torch.save(sd, path)
    pc2, st2, params2 = import_reference_scene(path, cfg, device=IO_DEVICE)
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t0
    for f in pc._fields:
        if not torch.equal(getattr(pc2, f), getattr(pc, f)):
            fail(f"import: the cloud's {f} differs from the source")
    if int(st2.num_active) != n or not torch.equal(st2.Rw2c, st.Rw2c):
        fail("import: num_active or Rw2c differs from the source")
    for k, layers in params.items():
        for i, layer in enumerate(layers):
            for leaf in ("w", "b"):
                if not torch.equal(params2[k][i][leaf], layer[leaf]):
                    fail(f"import: {k}.{i}.{leaf} differs from the source")
    if set(params2) != set(params):
        fail(f"import: parameter groups {sorted(params2)}")
    exp = export_reference_scene(pc2, st2, params2)
    if set(exp) != {k[len("module."):] for k in sd} or not all(
            torch.equal(v, sd["module." + k]) for k, v in exp.items()):
        fail("import: the export round trip is not bit-equal")
    grid2, _ = refresh_grid(pc2, st2, cfg)
    src = [eval_step({"mlp": params, "points": pc}, st, grid, b, cfg)
           for b in reqs]
    reset_counts(kernels)
    outs, dt = serve_requests(params2, pc2, st2, grid2, reqs, cfg, kernels,
                              "import")
    counts = {k: w.launches for k, w in kernels.items()}
    routes = kernel_routes(kernels, "import")
    for i, (a, b) in enumerate(zip(outs, src)):
        same_render_integers(a, b, f"import request {i}")
        if not torch.equal(a.coarse_raycolor, b.coarse_raycolor):
            fail(f"import request {i}: colors are not bit-equal to the "
                 f"source scene's")
    log(f"import: {n} points and {sum(len(v) for v in params.values())} "
        f"layers from {os.path.basename(path)} in {t_import:.3f} s, bit-equal "
        f"to the source, export round trip bit-equal; {len(reqs)} requests x "
        f"{N_RAYS} rays in {dt:.4f} s = {len(reqs) * N_RAYS / dt:.1f} rays/s "
        f"(host clock), colors bit-equal to the source scene's; launches "
        f"{counts}")
    # a composite's per-point Rw2c through the reference format
    cpc, cst = compose_parts(edit_parts(pc, n), device=IO_DEVICE)
    cpath = os.path.join(root, "composite_net_ray_marching.pth")
    torch.save(export_reference_scene(cpc, cst, params), cpath)
    ipc, ist, _ip = import_reference_scene(cpath, cfg, device=IO_DEVICE)
    if not (all(torch.equal(a, b) for a, b in zip(ipc, cpc))
            and torch.equal(ist.Rw2c, cst.Rw2c)
            and int(ist.num_active) == int(cst.num_active)):
        fail("import: the composite's checkpoint does not give "
             "compose_parts' state")
    # scripts/orbax_to_port.py (run where JAX is, without CUDA) writes the
    # CUDA generator state of cfg.train.seed + 2 from its layout
    spec = importlib.util.spec_from_file_location(
        "orbax_to_port", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "orbax_to_port.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    for seed in (cfg.train.seed + 2, 2 ** 40 + 3):
        g = torch.Generator(device="cuda")
        g.set_state(conv.seeded_generator_state(seed, "cuda"))
        want = torch.Generator(device="cuda").manual_seed(seed)
        if not (torch.equal(g.get_state(), want.get_state()) and torch.equal(
                torch.rand(64, generator=g, device="cuda"),
                torch.rand(64, generator=want, device="cuda"))):
            fail(f"import: the converter's CUDA generator state of seed "
                 f"{seed} is not manual_seed's")
    log("import: the converter's CUDA generator states equal manual_seed's "
        "and draw the same")
    log(f"import: a composite of {int(cst.num_active)} points with per-point "
        f"Rw2c {tuple(ist.Rw2c.shape)} imports to compose_parts' state, bit "
        f"for bit")
    checks = render_kernel_checks(params2, pc2, st2, grid2, reqs[:1], cfg,
                                  "import request")
    return counts, routes, {"import_request": checks}


def rotated_batch(b, R):
    """The request seen by the camera turned by R about the origin."""
    import torch
    Rt = torch.tensor(R, dtype=torch.float32, device=b.raydir.device)
    return b._replace(campos=Rt @ b.campos, camrotc2w=Rt @ b.camrotc2w,
                      raydir=b.raydir @ Rt.T)


def edit_path(kernels, params, pc, st, grid, reqs, cfg):
    """Phase 25 (module docstring). Returns (counts, routes, checks)."""
    import math
    import numpy as np
    import torch
    from pointnerf_tpu_torch.edit import ScenePart, compose_parts
    from pointnerf_tpu_torch.models.points import PointCloudStatic
    from pointnerf_tpu_torch.train.step import eval_step, refresh_grid
    n = int(st.num_active)
    t0 = time.perf_counter()
    epc, est = compose_parts(edit_parts(pc, n), device=IO_DEVICE)
    egrid, _ = refresh_grid(epc, est, cfg)
    torch.cuda.synchronize()
    log(f"edit: composite of {int(est.num_active)} points (capacity "
        f"{epc.capacity}; part 1 cropped to x <= {EDIT_CROP_X}, part 2 turned "
        f"90 degrees about z and moved by {EDIT_T}), per-point Rw2c "
        f"{tuple(est.Rw2c.shape)}, {int(egrid.num_dil)} dilated cells, "
        f"set-up {time.perf_counter() - t0:.3f} s")
    reset_counts(kernels)
    outs, dt = serve_requests(params, epc, est, egrid, reqs, cfg, kernels,
                              "edit")
    counts = {k: w.launches for k, w in kernels.items()}
    routes = kernel_routes(kernels, "edit")
    log(f"edit: {len(reqs)} requests x {N_RAYS} rays in {dt:.4f} s = "
        f"{len(reqs) * N_RAYS / dt:.1f} rays/s (host clock), rays hit "
        f"{[int(o.ray_mask.sum()) for o in outs]}; launches {counts}")
    checks = render_kernel_checks(params, epc, est, egrid, reqs[:2], cfg,
                                  "edit request")
    cpu_parity(params, epc, est, egrid, cfg)

    # one part at R = I, t = 0 against the global-Rw2c path
    arrays = {f: getattr(pc, f)[:n].cpu().numpy()
              for f in ("xyz", "features", "conf", "color", "dirs")}
    ipc, ist = compose_parts([ScenePart(**arrays)], device=IO_DEVICE)
    igrid, _ = refresh_grid(ipc, ist, cfg)
    glob = PointCloudStatic(ist.num_active,
                            torch.eye(3, device=ist.Rw2c.device))
    b = reqs[0]
    o_pp = eval_step({"mlp": params, "points": ipc}, ist, igrid, b, cfg)
    o_gl = eval_step({"mlp": params, "points": ipc}, glob, igrid, b, cfg)
    same_render_integers(o_pp, o_gl, "edit identity vs the global path")
    a = math.radians(EDIT_CONTROL_DEG)
    turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                         [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]],
                        device=ist.Rw2c.device)
    o_ct = eval_step({"mlp": params, "points": ipc},
                     ist._replace(Rw2c=(ist.Rw2c @ turn).contiguous()),
                     igrid, b, cfg)
    hit = o_gl.ray_mask
    d_pp = (o_pp.coarse_raycolor - o_gl.coarse_raycolor)[hit].abs()
    d_ct = (o_ct.coarse_raycolor - o_gl.coarse_raycolor)[hit].abs()
    err, ctl = float(d_pp.max()), float(d_ct.max())
    log(f"edit identity: {int(hit.sum())} rays hit; mean |color diff| "
        f"{float(d_pp.mean()):.3e}, control {float(d_ct.mean()):.3e}")
    hold_bf16("edit: one part at R = I vs the global-Rw2c path, max |color "
              "diff| of the rays that hit", err, ctl, EDIT_IDENTITY_TOL,
              control_is=f"per-point rotations turned {EDIT_CONTROL_DEG} "
              f"degree(s) about z")

    # frame invariance: the part and the camera turned by RY90
    R = np.asarray(RY90, np.float32)
    rpc, rst = compose_parts([ScenePart(**arrays, R=R)], device=IO_DEVICE)
    rgrid, _ = refresh_grid(rpc, rst, cfg)
    br = rotated_batch(b, RY90)
    o_rot = eval_step({"mlp": params, "points": rpc}, rst, rgrid, br, cfg)
    o_flat = eval_step({"mlp": params, "points": rpc},
                       rst._replace(Rw2c=torch.eye(3, device=rst.Rw2c.device)
                                    .expand_as(rst.Rw2c).contiguous()),
                       rgrid, br, cfg)
    both = o_gl.ray_mask & o_rot.ray_mask
    if int(both.sum()) < N_RAYS // 10:
        fail(f"edit frame invariance: only {int(both.sum())} rays hit both")
    ref = o_gl.coarse_raycolor[both]
    diff = (o_rot.coarse_raycolor[both] - ref).abs()
    err = float(diff.mean())
    ctl = float((o_flat.coarse_raycolor[both] - ref).abs().mean())
    log(f"edit frame invariance: {int(both.sum())} rays hit both renders, "
        f"ray masks differ on {int((o_gl.ray_mask != o_rot.ray_mask).sum())}, "
        f"max |color diff| {float(diff.max()):.3e}")
    hold_bf16("edit frame invariance: part and camera turned 90 degrees "
              "about y vs the unturned render, mean |color diff| of the rays "
              "both hit", err, ctl, EDIT_FRAME_TOL,
              control_is="per-point rotations set to I")
    return counts, routes, {"edit_request": checks}


def write_scannet_scene(root: str):
    """The procedural cluster in ScanNet's exported layout under `root`:
    SCANNET_FRAMES color frames of SCANNET_WH (8-bit PNG of the analytic
    ground truth), depth frames of SCANNET_DEPTH_WH (16-bit PNG, the
    analytic depth in millimetres, 0 where a ray misses), both with every
    row filter (PNG_FILTERS, as libpng's encoders mix them), intrinsic_color
    and c2w poses on a ring. Returns the depth maps (millimetres)."""
    import numpy as np
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    from pointnerf_tpu_torch.data.procedural import SCENES, gt_render
    from pointnerf_tpu_torch.data.synthetic import look_at
    from pointnerf_tpu_torch.utils.visualizer import to8b, write_png
    prims = SCENES[IO_SCAN]()
    for d in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    W, H = SCANNET_WH
    K = np.array([[SCANNET_FOCAL, 0, W / 2.0], [0, SCANNET_FOCAL, H / 2.0],
                  [0, 0, 1]], np.float32)
    K4 = np.eye(4)
    K4[:3, :3] = K
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"), K4)
    dw, dh = SCANNET_DEPTH_WH
    Kd = K.copy()
    Kd[0] *= dw / W
    Kd[1] *= dh / H
    depths = []
    for i in range(SCANNET_FRAMES):
        th = 2.0 * np.pi * i / SCANNET_FRAMES
        campos = np.array([2.6 * np.cos(th), 0.9, 2.6 * np.sin(th)],
                          np.float32)
        rot = look_at(campos, np.zeros(3, np.float32))
        gx, gy = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        img = gt_render(prims, campos, get_dtu_raydir(pix, K, rot))
        write_png(os.path.join(root, "color", f"{i}.png"),
                  to8b(img.reshape(H, W, 3)), filters=PNG_FILTERS)
        gx, gy = np.meshgrid(np.arange(dw), np.arange(dh))
        pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        rd = get_dtu_raydir(pix, Kd, rot)            # camera z = 1
        dn = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        o = np.broadcast_to(campos, dn.shape).astype(np.float32)
        best = np.full(dn.shape[0], np.inf, np.float32)
        for prim in prims:
            t, _n, hit = prim.intersect(o, dn)
            best = np.where(hit & (t < best), t, best)
        z = best / np.linalg.norm(rd, axis=-1)       # depth along the axis
        mm = np.where(np.isfinite(z), np.round(z * 1000.0), 0).astype(
            np.uint16).reshape(dh, dw)
        write_png(os.path.join(root, "depth", f"{i}.png"), mm,
                  filters=PNG_FILTERS)
        depths.append(mm)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = rot, campos
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"), c2w)
    return depths


class FirstBatchRecorder(MaintRecorder):
    """MaintRecorder that also keeps the first train step's batch and
    state and the last step's state."""
    first = last = None

    def train_step(self, real):
        inner = super().train_step(real)

        def run(state, st, grid, batch, cfg):
            if self.first is None:
                self.first = (state, st, grid, batch, cfg)
            state, items = inner(state, st, grid, batch, cfg)
            self.last = state
            return state, items
        return run

    def first_batch_losses(self):
        """The first batch's loss without jitter from the first and from
        the last state."""
        from pointnerf_tpu_torch.train.step import loss_fn
        state, st, grid, batch, cfg = self.first
        with self.torch.no_grad():
            return tuple(float(loss_fn(s.params, st, grid, batch, cfg)[0])
                         for s in (state, self.last))


def scannet_path(kernels, root: str):
    """Phase 26 (module docstring). Returns (counts, routes, checks)."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig
    from pointnerf_tpu_torch.data.scannet import ScannetDataset, resize_nearest
    from pointnerf_tpu_torch.presets import scene_preset
    from pointnerf_tpu_torch.train import driver as td
    t0 = time.perf_counter()
    depths = write_scannet_scene(os.path.join(root, SCANNET_SCAN))
    log(f"scannet scene written under {root}: {SCANNET_FRAMES} frames, color "
        f"{SCANNET_WH[0]} x {SCANNET_WH[1]}, 16-bit depth "
        f"{SCANNET_DEPTH_WH[0]} x {SCANNET_DEPTH_WH[1]}, "
        f"{time.perf_counter() - t0:.2f} s")
    ds = ScannetDataset(DataConfig(dataset_name="scannet_ft", data_root=root,
                                   scan=SCANNET_SCAN), split="train")
    t0 = time.perf_counter()
    cloud = ds.load_init_points()
    t_init = time.perf_counter() - t0
    # the loader's points against the written depth: frame id_list[0] (the
    # only one of step 10), its depth resized to the color size, each valid
    # pixel unprojected: count, and each point's depth along the camera axis
    d0 = resize_nearest(depths[ds.id_list[0]].astype(np.float32) / 1000.0,
                        SCANNET_WH)
    valid = (d0 > 0) & (d0 < 10.0)
    c2w = np.loadtxt(os.path.join(root, SCANNET_SCAN, "pose",
                                  f"{ds.id_list[0]}.txt"))
    cam_z = (cloud["xyz"] - c2w[:3, 3]) @ c2w[:3, 2]
    z_err = float(np.abs(cam_z - d0[valid]).max())
    log(f"scannet load_init_points: {cloud['xyz'].shape[0]} points from "
        f"frame {ds.id_list[0]} in {t_init:.3f} s; valid resized depth "
        f"pixels {int(valid.sum())}; max |camera-axis depth - resized depth| "
        f"{z_err:.3e} m")
    if cloud["xyz"].shape[0] != int(valid.sum()) or not z_err <= 1e-5 * 4:
        fail("scannet: load_init_points does not unproject the resized depth")
    # the loader's cost on the card host's CPU: a train item's first touch
    # of a frame decodes the filtered PNG, later ones take the kept frame
    fresh = ScannetDataset(ds.cfg, split="train")
    t_get = []
    for _ in range(2):
        t0 = time.perf_counter()
        fresh.get_item(1, random_sample="random", random_sample_size=56)
        t_get.append(time.perf_counter() - t0)
    log(f"scannet get_item (a {SCANNET_WH[0]} x {SCANNET_WH[1]} frame, rows "
        f"filtered {PNG_FILTERS}): first touch {t_get[0]:.4f} s, kept frame "
        f"{t_get[1]:.4f} s (host clock)")
    cfg = scene_preset(SCANNET_PRESET)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=SCANNET_STEPS, test_freq=SCANNET_STEPS,
        save_iter_freq=SCANNET_STEPS, print_freq=SCANNET_STEPS))
    q = cfg.query
    log(f"scannet config ({SCANNET_PRESET}): vsize {q.vsize}, ranges "
        f"{q.ranges}, P={q.P} SR={q.SR} K={q.K} D={q.z_depth_dim}, max_o "
        f"{q.max_o}, shell_layered {q.shell_layered}, prebuild_neighbors "
        f"{q.prebuild_neighbors}, decode_capacity {q.decode_capacity}, "
        f"{cfg.train.random_sample_size ** 2} rays a step, compute "
        f"{cfg.train.compute_dtype}")
    rec = FirstBatchRecorder(cfg, kernels,
                             ("fused_decode", "fused_decode_bwd"),
                             ("fused_decode", "fused_march"),
                             record_step=SCANNET_STEPS // 2)
    reset_counts(kernels)
    rec.install()
    build = os.path.dirname(os.path.abspath(root))
    try:
        with tempfile_dir(build) as run_dir:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, _st, hist = td.train_dataset_scene(
                "scannet_ft", root, SCANNET_SCAN, run_dir,
                max_steps=SCANNET_STEPS, cfg=cfg, resume=False,
                device=IO_DEVICE)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        rec.restore()
    counts = {k: w.launches for k, w in kernels.items()}
    routes = kernel_routes(kernels, "scannet")
    n_chunks = -(-SCANNET_WH[0] * SCANNET_WH[1] // 9216)
    want = {"knn_select": 0, "fused_decode": SCANNET_STEPS + n_chunks,
            "fused_decode_bwd": SCANNET_STEPS, "fused_march": n_chunks}
    if counts != want:
        fail(f"scannet launches {counts}, expected {want}")
    losses = torch.stack(rec.losses).float().cpu()
    # the loss of the first step's batch (no jitter) from the first and
    # the last state: each step draws a batch of another view
    first, last = rec.first_batch_losses()
    psnr = hist["eval"][-1]["psnr"] if hist["eval"] else float("nan")
    steps = rec.times["train_step"]
    log(f"scannet: {SCANNET_STEPS} steps of "
        f"{cfg.train.random_sample_size ** 2} rays and an eval frame of "
        f"{n_chunks} chunks in {dt:.2f} s (host clock); s/step mean "
        f"{sum(steps) / len(steps):.4f}, eval frame "
        f"{rec.times['eval_frame'][0]:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; losses "
        f"{[round(float(v), 6) for v in losses]}, the first batch's "
        f"{first:.6f} -> {last:.6f}; eval PSNR {psnr:.3f}; launches {counts}")
    if not bool(torch.isfinite(losses).all()) or not last < first \
            or not np.isfinite(psnr):
        fail(f"scannet: the loss is not finite and falling ({first} -> "
             f"{last}) or the PSNR is not finite")
    if rec.step_inputs is None or "eval_chunk" not in rec.captured:
        fail("scannet: the step's or the eval chunk's inputs were not "
             "recorded")
    with torch.no_grad():
        checks = {"scannet_step": {
            "fused_decode": check_k3([(rec.step_inputs["fused_decode"], {})],
                                     what="scannet step")["bf16"],
            "fused_decode_bwd": check_k4(
                rec.step_inputs["fused_decode_bwd"])["bf16"]},
            "scannet_eval_chunk": {
                "fused_decode": check_k3(
                    [rec.captured["eval_chunk"]["fused_decode"]],
                    what="scannet eval chunk")["bf16"],
                "fused_march": check_k2(
                    *rec.captured["eval_chunk"]["fused_march"], tol=0.0)}}
    return counts, routes, checks


def write_llff_scene(root: str):
    """The procedural cluster as an LLFF scene under `root`: LLFF_FRAMES
    views of LLFF_WH in images_4/ (8-bit PNG) and poses_bounds.npy (LLFF's
    [down, right, back] 3x5 poses with the full-size h, w, focal, and each
    view's near/far bounds). Returns [(campos, c2w rotation, K)] and the
    written images."""
    import numpy as np
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    from pointnerf_tpu_torch.data.procedural import (SCENES, gt_render,
                                                      sphere_cameras)
    from pointnerf_tpu_torch.utils.visualizer import to8b, write_png
    prims = SCENES[IO_SCAN]()
    W, H = LLFF_WH
    views = sphere_cameras(LLFF_FRAMES, radius=2.4, focal=LLFF_FOCAL,
                           wh=LLFF_WH, seed=3, hemisphere=True)
    d = os.path.join(root, "images_4")
    os.makedirs(d, exist_ok=True)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    rows, images = [], []
    for i, (campos, rot, K) in enumerate(views):
        img = to8b(gt_render(prims, campos, get_dtu_raydir(pix, K, rot))
                   .reshape(H, W, 3))
        write_png(os.path.join(d, f"IMG_{i:04d}.png"), img,
                  filters=PNG_FILTERS)
        images.append(img)
        llff = np.stack([rot[:, 1], rot[:, 0], -rot[:, 2]], 1)
        hwf = np.array([[4 * H], [4 * W], [4 * LLFF_FOCAL]])
        pose = np.concatenate([llff, campos[:, None], hwf], 1)
        dist = float(np.linalg.norm(campos))
        rows.append(np.concatenate([pose.ravel(), [dist - 1.4, dist + 1.4]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return views, images


def llff_path(kernels, root: str):
    """Phase 27 (module docstring). Returns (counts, routes, checks)."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    from pointnerf_tpu_torch.config import DataConfig, scene_config
    from pointnerf_tpu_torch.data.llff import LlffDataset
    from pointnerf_tpu_torch.data.procedural import SCENES, sample_cloud
    from pointnerf_tpu_torch.train import driver as td
    t0 = time.perf_counter()
    views, images = write_llff_scene(os.path.join(root, IO_SCAN))
    log(f"llff scene written under {root}: {LLFF_FRAMES} views of "
        f"{LLFF_WH[0]} x {LLFF_WH[1]} in images_4/, "
        f"{time.perf_counter() - t0:.2f} s")
    dcfg = DataConfig(dataset_name="llff_ft", data_root=root, scan=IO_SCAN)
    train_ds = LlffDataset(dcfg, split="train", factor=4)
    test_ds = LlffDataset(dcfg, split="test", factor=4)
    # the loader's items against the views as written: frame f is train
    # item f - 1 - f // 8 and test item f // 8
    for ds, frames in ((train_ds, [f for f in range(LLFF_FRAMES) if f % 8]),
                       (test_ds, list(range(0, LLFF_FRAMES, 8)))):
        if len(ds) != len(frames):
            fail(f"llff: {len(ds)} {ds.split} items, expected {len(frames)}")
        for i, f in enumerate(frames):
            it = ds.get_item(i)
            campos, rot, K = views[f]
            pix = np.asarray(it["pixel_idx"], np.int64)
            ok = (np.array_equal(it["campos"], campos)
                  and np.array_equal(it["camrotc2w"], rot)
                  and np.array_equal(ds.intrinsic, K)
                  and np.array_equal(it["raydir"], get_dtu_raydir(
                      pix.astype(np.float32), K, rot).astype(np.float32))
                  and np.array_equal(it["gt_image"], images[f][
                      pix[:, 1], pix[:, 0]].astype(np.float32) / 255.0))
            if not ok:
                fail(f"llff: {ds.split} item {i} differs from frame {f} as "
                     f"written")
    log(f"llff: {len(train_ds)} train and {len(test_ds)} test items equal "
        f"the written views (poses, intrinsics, rays, pixels); near "
        f"{train_ds.near:.4f} far {train_ds.far:.4f}")
    xyz, color, normals = sample_cloud(SCENES[IO_SCAN](), DS_POINTS, seed=0)
    cfg = scene_config(xyz, near=train_ds.near, far=train_ds.far)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=LLFF_STEPS, prune_iter=0, prob_freq=0,
        test_freq=LLFF_STEPS, save_iter_freq=LLFF_STEPS,
        print_freq=LLFF_STEPS))
    rng = np.random.RandomState(cfg.train.seed)

    def train_item(step):
        return train_ds.get_item(
            rng.randint(0, len(train_ds)), random_sample="random",
            random_sample_size=cfg.train.random_sample_size, seed=step)
    rec = MaintRecorder(cfg, kernels, ("fused_decode", "fused_decode_bwd"),
                        ("fused_decode", "fused_march"),
                        record_step=LLFF_STEPS // 2)
    reset_counts(kernels)
    rec.install()
    try:
        with tempfile_dir(os.path.dirname(os.path.abspath(root))) as run_dir:
            t0 = time.perf_counter()
            state, _st, hist = td.train_scene(
                cfg, (xyz, color, normals), train_item,
                [test_ds.get_item(0)], [], (train_ds.width, train_ds.height),
                run_dir=run_dir, max_steps=LLFF_STEPS, device=IO_DEVICE)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        rec.restore()
    counts = {k: w.launches for k, w in kernels.items()}
    n_chunks = -(-LLFF_WH[0] * LLFF_WH[1] // 9216)
    want = {"knn_select": 0, "fused_decode": LLFF_STEPS + n_chunks,
            "fused_decode_bwd": LLFF_STEPS, "fused_march": n_chunks}
    if counts != want:
        fail(f"llff launches {counts}, expected {want}")
    routes = f32_routes(kernels, "llff")
    losses = torch.stack(rec.losses).float().cpu()
    psnr = hist["eval"][-1]["psnr"] if hist["eval"] else float("nan")
    if not bool(torch.isfinite(losses).all()) or not np.isfinite(psnr):
        fail(f"llff: losses {losses.tolist()} or PSNR {psnr} not finite")
    log(f"llff: train_scene {LLFF_STEPS} steps of "
        f"{cfg.train.random_sample_size ** 2} rays and one test frame "
        f"({n_chunks} chunks) in {dt:.2f} s (host clock), losses "
        f"{[round(float(v), 6) for v in losses]}, test PSNR {psnr:.3f}; "
        f"launches {counts}, routes {routes}")
    if rec.step_inputs is None or "eval_chunk" not in rec.captured:
        fail("llff: the step's or the eval chunk's inputs were not recorded")
    return counts, routes, rec


def f32_routes(kernels, path: str):
    """The decode launches of a path on the f32 route, all on the CUDA-core
    kernels, and K2's all on the tiled kernel."""
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("fused_decode", "fused_decode_bwd")}
    for n, r in routes.items():
        if r["cuda_core"] != kernels[n].launches:
            fail(f"{path}: {n} launches left the CUDA-core (f32) route: {r}")
    routes["fused_march"] = march_routes(kernels, path)
    return routes


def video_path(kernels, data_root: str, run_dir: str, cfg):
    """Phase 28 (module docstring). Returns (counts, routes, the recorded
    chunk of frame 0)."""
    import importlib
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.train import driver as td
    from pointnerf_tpu_torch.train import grow as tg
    from pointnerf_tpu_torch.utils.visualizer import read_png, to8b
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = td.render_video_from_checkpoint(
        "nerf_synth360_ft", data_root, DS_SCAN, run_dir, cfg=cfg,
        n_frames=VIDEO_FRAMES, device=IO_DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: w.launches for k, w in kernels.items()}
    n_chunks = -(-DS_WH[0] * DS_WH[1] // 9216)
    want = {"knn_select": 0, "fused_decode": VIDEO_FRAMES * n_chunks,
            "fused_decode_bwd": 0, "fused_march": VIDEO_FRAMES * n_chunks}
    if counts != want:
        fail(f"video launches {counts}, expected {want}")
    routes = f32_routes(kernels, "video")
    frames = sorted(os.listdir(out))
    if frames != [f"frame_{i:05d}.png" for i in range(VIDEO_FRAMES)]:
        fail(f"video: frames {frames}")
    ds = find_dataset_class_by_name("nerf_synth360_ft")(DataConfig(
        dataset_name="nerf_synth360_ft", data_root=data_root, scan=DS_SCAN),
        split="train")
    state, st, grid, _c = td._restore_latest(ds, run_dir, cfg, None,
                                             torch.device(IO_DEVICE))
    # frame 0 again, recording K3's and K2's inputs of its middle chunk
    real, calls, mid = tg.eval_step, [0], {}

    def chunk(*a, **k):
        calls[0] += 1
        if calls[0] - 1 != n_chunks // 2:
            return real(*a, **k)
        with recording_kernels() as seen:
            out = real(*a, **k)
        mid.update({n: seen[n] for n in ("fused_decode", "fused_march")})
        return out
    tg.eval_step = chunk
    try:
        maps = tg.render_full_frame(state.params, st, grid, cfg,
                                    ds.get_dummyrot_item(0, VIDEO_FRAMES),
                                    DS_WH, chunk=9216, prob=False)
    finally:
        tg.eval_step = real
    want0 = to8b(np.clip(maps["coarse_raycolor"][..., :3], 0, 1))
    got0 = read_png(os.path.join(out, frames[0]))
    if not np.array_equal(got0, want0):
        fail(f"video: frame 0 differs from render_full_frame at its pose in "
             f"{int((got0 != want0).any(-1).sum())} pixels")
    log(f"video: {VIDEO_FRAMES} frames of {DS_WH[0]} x {DS_WH[1]} "
        f"({n_chunks} chunks each) from the dataset phase's checkpoint in "
        f"{dt:.2f} s (host clock) as PNG under {os.path.relpath(out)}; frame "
        f"0 equal to render_full_frame at its pose; launches {counts}, "
        f"routes {routes}")
    have = {}
    for m in ("PIL", "cv2", "imageio", "torchvision"):
        try:
            importlib.import_module(m)
            have[m] = True
        except Exception:
            have[m] = False
    log(f"video: image and video libraries on this host (this script "
        f"installs none): {have}")
    return counts, routes, mid


def profiling_phase(params, pc, st, grid, batch, cfg, root: str):
    """Phase 29 (module docstring)."""
    import torch
    from pointnerf_tpu_torch.train.step import eval_step
    from pointnerf_tpu_torch.utils.profiling import (StepTimer, annotate,
                                                     device_trace)
    dev = torch.device(IO_DEVICE)
    eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)  # warm
    with device_trace(root, name="request") as prof:
        with annotate("request"):
            out = eval_step({"mlp": params, "points": pc}, st, grid, batch,
                            cfg)
    names = {e.key for e in prof.key_averages()}
    trace = os.path.join(root, "request.pt.trace.json")
    with open(trace) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    found = {}
    for k, keys in (("K1", ("knn_select_runs_kernel",
                            "knn_select_warp_kernel")),
                    ("K3", ("fused_decode_tc_fwd",)),
                    ("K2", ("fused_march_kernel",))):
        found[k] = sorted(n for n in names | events
                          if n and any(key in n for key in keys))
        if not found[k]:
            fail(f"profiling: the trace names no {k} kernel ({keys})")
    del out
    timer = StepTimer(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.section("render"):
        out = eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
    with timer.section("readback"):
        out.coarse_raycolor.cpu()
    host = time.perf_counter() - t0
    rep = timer.report()
    total = sum(v["total_s"] for v in rep.values())
    log(f"profiling: device_trace of a request names {found}; trace "
        f"{os.path.relpath(trace)} ({os.path.getsize(trace)} bytes); "
        f"StepTimer sections {json.dumps(rep)} sum {total * 1e3:.3f} ms, "
        f"host clock of the request {host * 1e3:.3f} ms")
    if not 0 < total <= host:
        fail("profiling: StepTimer's sections do not sum to within the host "
             "clock of the request")


def scene_io_paths(kernels, params, pc, st, grid, reqs, cfg, ds_root: str,
                   ds_run: str, ds_cfg):
    """Phases 24-29. Returns ({path: (counts, routes)}, kernel checks)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    paths, checks, secs = {}, {}, {}
    t0 = time.perf_counter()
    c, r, k = import_path(kernels, params, pc, st, grid, reqs, cfg,
                          os.path.join(build, "import"))
    paths["import"], checks = (c, r), {**checks, **k}
    secs["import"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, r, k = edit_path(kernels, params, pc, st, grid, reqs, cfg)
    paths["edit"], checks = (c, r), {**checks, **k}
    secs["edit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, r, k = scannet_path(kernels, os.path.join(build, "scannet"))
    paths["scannet"], checks = (c, r), {**checks, **k}
    secs["scannet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, r, llff = llff_path(kernels, os.path.join(build, "llff"))
    paths["llff"] = (c, r)
    secs["llff"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, r, vid = video_path(kernels, ds_root, ds_run, ds_cfg)
    paths["video"] = (c, r)
    secs["video"] = time.perf_counter() - t0
    # the f32 route at the llff step's and eval chunk's shapes and at the
    # video's chunk; K2 on the llff eval chunk and the video chunk
    f32_k3, f32_k4 = check_f32_decode(
        [("llff step", llff.step_inputs["fused_decode"]),
         ("llff eval chunk", llff.captured["eval_chunk"]["fused_decode"][0]),
         ("video chunk", vid["fused_decode"][0])],
        llff.step_inputs["fused_decode_bwd"])
    checks["llff_step"] = {"fused_decode_f32": f32_k3["llff step"],
                           "fused_decode_bwd_f32": f32_k4}
    checks["llff_eval_chunk"] = {
        "fused_decode_f32": f32_k3["llff eval chunk"],
        "fused_march": check_k2(*llff.captured["eval_chunk"]["fused_march"],
                                tol=0.0)}
    checks["video_chunk"] = {"fused_decode_f32": f32_k3["video chunk"],
                             "fused_march": check_k2(*vid["fused_march"],
                                                     tol=0.0)}
    del llff, vid
    t0 = time.perf_counter()
    profiling_phase(params, pc, st, grid, reqs[0], cfg,
                    os.path.join(build, "trace"))
    secs["profiling"] = time.perf_counter() - t0
    log("phases 24-29 wall seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    return paths, checks


# ---- phase 30: the whole aggregator — every distance kernel on K3 / K4,
# every layout outside the fused envelope on the unfused decode, and the
# general K3 / K4 at full width ---------------------------------------------
# (a) the distance kernels on the fused envelope: the nine besides linear,
# and linear with a non-uniform axis weight
AGG_KERNELS = {
    "quadric": dict(agg_distance_kernel="quadric"),
    "numlinear": dict(agg_distance_kernel="numlinear"),
    "numquadric": dict(agg_distance_kernel="numquadric"),
    "avg": dict(agg_distance_kernel="avg"),
    "trilinear": dict(agg_distance_kernel="trilinear"),
    "sh_intrp": dict(agg_distance_kernel="sh_intrp"),
    "feat_intrp": dict(agg_distance_kernel="feat_intrp"),
    "meta_intrp": dict(agg_distance_kernel="meta_intrp"),
    "gau_intrp": dict(agg_distance_kernel="gau_intrp"),
    "linear_axis_121": dict(agg_axis_weight=(1.0, 2.0, 1.0)),
}
# (b) the layouts outside the envelope (JAX's XLA decode)
AGG_LAYOUTS = {
    "order0": dict(agg_intrp_order=0),
    "order1": dict(agg_intrp_order=1),
    "block2": dict(shading_feature_mlp_layer2=1),
    "block2_feat_xyz": dict(shading_feature_mlp_layer2=1,
                            agg_feat_xyz_mode="world"),
    "alpha_color_xyz": dict(agg_alpha_xyz_mode="world",
                            agg_color_xyz_mode="world"),
    "alpha2": dict(shading_alpha_mlp_layer=2),
    "no_block3": dict(shading_feature_mlp_layer3=0),
}
# (c) bench_config past the tuned kernels' limits: (aggregator, query)
# overrides
AGG_GENERAL = {"h512": (dict(shading_feature_num=512), {}),
               "k6": ({}, dict(K=6))}
AGG_GENERAL_STEPS = (3, 5)     # warm-up and timed train steps
# trilinear takes 1 - |d| / vsize per axis: past one voxel a weight turns
# negative and the normalized weights blow up (JAX's function; NaN colors
# at bench_config's four-voxel radius), so its setting cuts the KNN radius
# to one voxel
AGG_QUERY = {"trilinear": dict(radius_limit_scale=1.0)}
# card vs CPU colors of a 512-ray request in phase 30: the share mean
# |card - CPU| / mean |CPU| over the rays that hit, divided by the same
# for the control (the CPU with an f32 decode), is held at most this. The
# weights and layouts move the colors' scale by decades (numlinear's
# weights are not normalized; no block3 leaves little to round), so no
# absolute bar fits them all; the share does not depend on that scale. A
# card decode that skips its bf16 rounding reads as the control, a share
# near 1; one that adds a rounding moves the colors by a bf16 step, of
# the control's order again. Readings on an H100 80GB HBM3 at 700 W
# (PERF.md §6): at most 0.12 over the distance kernels (sh_intrp), 0.26
# with block3 absent
AGG_COLOR_SHARE = 0.5
# the general K4 in bf16, its largest errors (hold_general_k4), each
# beside its control, a live tile of the kernel left out, against their
# f64 values from the kernel's own phase-A scratch: row gradients per tile
# of the kernel (T live rows), max |kernel - reference| / max |reference|
# in the tile (a tile left out reads 1); dW / db / dwa / dba of max
# |reference|. Readings on an H100 80GB HBM3 at 700 W (PERF.md §6), H =
# 512 and K = 6: the first general kernel (CUDA cores, against the f32
# plain version) rows up to 1.07e-02, dW / db up to 1.8e-06, controls from
# 4.6e-05; the tensor-core one from the fresh and the trained state rows
# up to 1.9e-06, dW / db / dwa / dba up to 3.1e-07, controls from 3.0e-04
# (and over 2 x 3 more trained states, scripts/parity_readings.py --phase
# general, dW / db up to 2.2e-07, controls from 3.7e-04)
GENERAL_K4_BF16_TILE_TOL = 0.05
GENERAL_K4_BF16_DW_TOL = 1.5e-5
# the general K4's rounding points in bf16 (hold_general_k4): each layer
# output and each rounded g_z of its scratch against its value in f64 from
# the scratch's previous ones, |kernel - f64| / (2^-8 |f64| + the f32 sum's
# error bound), where 2^-8 is bf16's unit roundoff and the bound is
# GENERAL_SUM_SLACK x (n + 2) 2^-24 x the sum of the terms' magnitudes (n
# terms; the factor covers a tensor core's accumulation, which need not
# round to nearest): a correct kernel reads at most 1, a value off by a
# share of itself reads ~2^8 (the control, a live tile's values zeroed).
# Read up to 0.9946 (the last layer's g_z), controls from 218
GENERAL_SUM_SLACK = 4.0
# the first general kernels (the CUDA cores, tile state in a global
# workspace, no live list) on the same phase-30 inputs, ms on an H100 80GB
# HBM3 at 700 W (PERF.md §6): printed beside this run's; every time listed
# must be below its plain version's, and the bf16 ones at H = 512 at most
# 1 / GENERAL_SPEEDUP of theirs
FIRST_GENERAL_MS = {("h512", "K3", "bf16"): 72.9627,
                    ("h512", "K3", "f32"): 72.9288,
                    ("k6", "K3", "bf16"): 20.6236,
                    ("h512", "K4", "bf16"): 426.4606,
                    ("h512", "K4", "f32"): 426.5757,
                    ("k6", "K4", "bf16"): 88.7805}
GENERAL_SPEEDUP = 10.0
GENERAL_DENSE_H = 512     # the dataset step's width for the general f32 check


def agg_config(cfg, agg_kw=None, query_kw=None):
    return cfg.replace(
        agg=dataclasses.replace(cfg.agg, **(agg_kw or {})),
        query=dataclasses.replace(cfg.query, **(query_kw or {})))


def agg_params(cfg):
    import torch
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    return init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                  device="cuda")


def agg_color_hold(name, serve_s, losses, parity):
    """Print a phase-30 setting's request and step, and hold its card vs
    CPU colors (`request_parity`): mean |err| / mean |CPU| at most
    AGG_COLOR_SHARE of the control's; the largest error is printed beside
    phase 5's bar."""
    err, ctl, m, mctl, _n_hit = parity
    share = m / mctl if mctl > 0 else float("inf")
    log(f"phase 30 {name}: 1 request {serve_s:.4f} s, 1 train step (loss "
        f"{losses[-1]:.6f}); card vs CPU colors max |err| {err:.3e} (control "
        f"{ctl:.3e}; phase 5's bar {COLOR_BF16_TOL:.0e}), mean |err| / mean "
        f"|CPU| {m:.3e}, control {mctl:.3e}: a share of {share:.3e} "
        f"[bar {AGG_COLOR_SHARE}]")
    if not share <= AGG_COLOR_SHARE:
        fail(f"phase 30 {name}: the card's colors are {share:.3e} of the "
             f"control's distance from the CPU's, past {AGG_COLOR_SHARE}")


def decode_routes_now(kernels):
    return {n: dict(kernels[n].launches_by_route)
            for n in ("fused_decode", "fused_decode_bwd")}


def add_counts(total, kernels):
    """Add the wrappers' launches and launches by route, read now, to
    `total` = (counts, routes)."""
    counts, routes = total
    for n, k in kernels.items():
        counts[n] = counts.get(n, 0) + k.launches
        for r, v in getattr(k, "launches_by_route", {}).items():
            routes.setdefault(n, {})[r] = routes.get(n, {}).get(r, 0) + v


def agg_serve_and_step(params, pc, st, grid, cfg, kernels, reqs, tbatch,
                       what: str, decode_route, total, steps=(0, 1)):
    """Serve `reqs` and take warm-up + timed train steps from a fresh state
    (`steps`); each request launches K1 and K2 once and K3 once on
    `decode_route` (None: no decode kernel), each step K1 once and K3 and
    K4 once on `decode_route`. The counts are set to 0 just before and
    added to `total` (`add_counts`) just after. Returns (serve seconds,
    step seconds per timed step, last losses, the trained state)."""
    import torch
    from pointnerf_tpu_torch.train.step import create_train_state, train_step
    k3 = int(decode_route is not None)
    state = create_train_state(torch.Generator(device="cuda").manual_seed(2),
                               params, pc, cfg)
    reset_counts(kernels)
    _outs, serve_s = serve_requests(
        params, pc, st, grid, reqs, cfg, kernels, what,
        want={"knn_select": 1, "fused_decode": k3, "fused_march": 1,
              "fused_decode_bwd": 0})
    losses = []
    t0 = time.perf_counter()
    for i in range(sum(steps)):
        if i == steps[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        b = {n: kernels[n].launches for n in TRAIN_KERNELS}
        state, items = train_step(state, st, grid, tbatch, cfg)
        got = {n: kernels[n].launches - b[n] for n in TRAIN_KERNELS}
        want = {"knn_select": 1, "fused_decode": k3, "fused_decode_bwd": k3}
        if got != want:
            fail(f"{what} train step {i} launched {got}, not {want}")
        losses.append(float(items["loss_total"]))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / max(steps[1], 1)
    march_routes(kernels, what)
    add_counts(total, kernels)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: a training loss is not finite: {losses}")
    for n, r in decode_routes_now(kernels).items():
        n_all = sum(r.values())
        if decode_route is None and n_all:
            fail(f"{what}: {n} launched outside the fused envelope: {r}")
        if decode_route is not None and r[decode_route] != n_all:
            fail(f"{what}: {n} launches left the {decode_route} route: {r}")
    return serve_s, step_s, losses, state


def general_tile(w, K: int, T=None):
    """(rows per tile — by default 64 // K whole groups of the layout, 60
    rows at K = 6 —, the median live tile)."""
    import torch
    T = T or max(1, 64 // K) * K
    live = torch.nn.functional.pad((w.reshape(-1) != 0),
                                   (0, -w.shape[0] % T)).view(-1, T).any(1)
    idx = live.nonzero().reshape(-1)
    return T, int(idx[idx.numel() // 2])


def tile_rel_max(a, b, T: int, floor: float = 0.0) -> float:
    """The largest, over tiles of T rows, of max |a - b| / max |b| in the
    tile, that max taken at least `floor` (inf where it is zero and a - b
    is not)."""
    import torch
    pad = -a.shape[0] % T
    e = torch.nn.functional.pad((a - b).abs().reshape(a.shape[0], -1),
                                (0, 0, 0, pad)).view(-1, T * a[0].numel())
    s = torch.nn.functional.pad(b.abs().reshape(b.shape[0], -1),
                                (0, 0, 0, pad)).view(-1, T * b[0].numel())
    e, s = e.amax(1), s.amax(1).clamp(min=floor)
    r = torch.where(s > 0, e / s.clamp(min=1e-30),
                    torch.where(e > 0, float("inf"), 0.0))
    return float(r.max()) if r.numel() else 0.0


def widest_tile(b, T: int) -> int:
    """The tile of T rows that holds max |b|."""
    return int(b.abs().reshape(b.shape[0], -1).amax(1).argmax()) // T


def k4_tile_control(args, sp, names, plain, out, T=None, floor_share=0.0):
    """The controls of K4's largest errors: a live tile (of T rows, by
    default `general_tile`'s) left out. Row gradients: `tile_rel_max`
    of the kernel's output with that tile's rows zeroed — the median live
    tile's, or with a `floor_share` (each tile's max|plain| floored at
    that share of the tensor's) the tile that holds the tensor's max|plain|
    (`widest_tile`), which a floored tile under the median's could not
    stand for. dW / db: the largest |plain backward of the median tile
    alone| / max|plain|, the share the tile would leave out."""
    from pointnerf_tpu_torch.ops.fused_decode import fused_decode_bwd_plain
    feat, dists, extras, w, params, _spec, g_fagg, g_alpha = args
    K = sp.K
    T, t = general_tile(w, K, T)
    r0, r1 = t * T, min((t + 1) * T, w.shape[0])
    _, tile = decode_grad_leaves(fused_decode_bwd_plain(
        feat[r0:r1], dists[r0:r1], extras[r0:r1], w[r0:r1], params, sp,
        g_fagg[r0 // K:r1 // K], g_alpha[r0 // K:r1 // K]))
    ctl = {}
    for i, (n, a, b) in enumerate(zip(names, tile, plain)):
        if i < 4:
            z0, z1 = r0, r1
            if floor_share > 0:
                tw = widest_tile(b, T)
                z0, z1 = tw * T, min((tw + 1) * T, b.shape[0])
            z = out[i].clone()
            z[z0:z1] = 0
            ctl[n] = tile_rel_max(z, b, T,
                                  floor_share * float(b.abs().max()))
        else:
            ctl[n] = float(a.abs().max()) / max(float(b.abs().max()), 1e-30)
    return ctl


def hold_k4_tiles(what: str, args, sp, names, out, plain, tile_tol, dw_tol,
                  T=None, floor_share=0.0):
    """K4's largest-error rule in bf16 (for `check_k4`): each row
    gradient's largest error per tile of T rows (`tile_rel_max`; by default
    `general_tile`'s; each tile's max|plain| floored at
    `floor_share` of the tensor's) within `tile_tol` (or its entry for the
    tensor in a dict, None the default), each dW / db's of its
    max|plain| within `dw_tol` (the same), and each control
    (`k4_tile_control`: a live tile left out) above its bar. The general K4 through
    `hold_general_k4`, the tuned one through `hold_k4_tc_tiles`. Returns
    {name: (reading, control)}."""
    T = general_tile(args[3], sp.K, T)[0]
    got = {n: (tile_rel_max(x, p, T, floor_share * float(p.abs().max()))
               if i < 4 else
               float((x - p).abs().max()) / max(float(p.abs().max()), 1e-30))
           for i, (n, x, p) in enumerate(zip(names, out, plain))}
    ctl = k4_tile_control(args, sp, names, plain, out, T, floor_share)
    def bar(tol, n):
        return tol.get(n, tol[None]) if isinstance(tol, dict) else tol
    bars = {n: bar(tile_tol if i < 4 else dw_tol, n)
            for i, n in enumerate(names)}
    floor = (f", floored at {floor_share:g} of the tensor's max |plain|"
             if floor_share else "")
    log(f"{what}: largest errors [bar] (control: a live tile left out) — "
        f"rows per tile of {T}, max |err| / max |plain| in the tile{floor}; "
        f"dW / db of max|plain|: " + ", ".join(
            f"{n} {got[n]:.3e} [{bars[n]:.0e}] ({ctl[n]:.3e})" for n in names))
    bad = [n for n in names if not got[n] <= bars[n]]
    if bad:
        fail(f"{what}: the largest error of {bad} is beyond its bar")
    bad = [n for n in names if not ctl[n] > bars[n]]
    if bad:
        fail(f"{what}: the bar of {bad} does not tell the control apart")
    return {n: (got[n], ctl[n]) for n in names}


def general_k4_chain(sp, args, rows, acts, gzs):
    """Phase A's roundings and every output in f64 from the general K4's
    own scratch (`general_bwd_scratch`: rows, acts, gzs): the forward layer
    by layer from each scratch input, the backward from each scratch g_zr
    with the kernel's branches (the signs of its layer outputs). Returns
    ({rounding point: (kernel, f64 value, slack)}, {row gradient name: its
    f64 value on the live rows}, {dW / db / dwa / dba name: (f64 value, its
    per-row terms' sum over a row range as a function)}), names as
    `decode_grad_leaves`'."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (build_x, layer_inputs,
                                                      prep_weights)
    feat, dists, extras, w, params, _sp, g_fagg, g_alpha = args
    d64 = torch.float64
    L, H, K, E, slope = sp.L1 + sp.L3, sp.H, sp.K, sp.E, sp.neg_slope
    u = 2.0 ** -24

    def r16(t):
        return t.float().to(torch.bfloat16).to(d64)

    def slack(n, terms):
        return GENERAL_SUM_SLACK * (n + 2) * u * terms

    Ws, bs, wa, ba = [[t.to(d64) for t in x] if isinstance(x, list)
                      else x.to(d64) for x in prep_weights(params, sp)]
    A = [a.to(d64) for a in acts]
    Gz = [g.to(d64) for g in gzs]
    ins = layer_inputs(sp)
    x1 = ins[0]
    pts = {}
    x0 = build_x(r16(feat[rows]), r16(dists[rows]), sp)
    pe = torch.zeros_like(x0)       # sinf / cosf: 2 ulp of a value <= 1
    pe[:, sp.Fi:] = 8 * u
    pe[:, sp.Fi + 2 * sp.Ff * sp.Fi:] = 0 if sp.Fd == 0 else 8 * u
    pts["layer 0 input (the PE)"] = (A[0][:, :x1], x0, pe)
    for l in range(L):
        x, n = A[l][:, :ins[l]], ins[l]
        z = x @ Ws[l] + bs[l]
        s = slack(n, x.abs() @ Ws[l].abs() + bs[l].abs())
        pts[f"layer {l} output"] = (A[l + 1][:, :H],
                                    torch.where(z > 0, z, z * slope),
                                    (1 + 2.0 ** -8) * s)
        if l + 1 == sp.L1 and E:
            pts[f"layer {l + 1} input's extras"] = (
                A[l + 1][:, H:H + E], r16(extras[rows]),
                torch.zeros_like(A[l + 1][:, H:H + E]))
    pads = [a[:, (ins[l] if l < L else H):] for l, a in enumerate(A)] \
        + [g[:, H:] for g in Gz]
    if any(bool(p.any()) for p in pads):
        fail("the general K4's scratch holds a nonzero pad")
    # the heads, from the kernel's last output h
    h = A[L][:, :H]
    grp = torch.div(rows, K, rounding_mode="floor")
    gf, ga, wr = g_fagg[grp].to(d64), g_alpha[grp].to(d64), r16(w[rows])
    za = h @ wa.reshape(-1, 1) + ba
    sig = torch.sigmoid(za - 1.0)
    g_za = ga * wr * sig
    dza = 2 * slack(H, h.abs() @ wa.abs().reshape(-1, 1) + ba.abs()) \
        + 2 * u * (za - 1.0).abs()
    e_za = (ga * wr).abs() * (0.25 * dza + 8 * u * sig)
    g_h = gf * wr + g_za * wa
    e_h = e_za * wa.abs() + 8 * u * ((gf * wr).abs() + (g_za * wa).abs())
    row_ref = {"g_w": (h * gf).sum(1, keepdim=True)
               + torch.nn.functional.softplus(za - 1.0) * ga}
    grads = {}
    for l in reversed(range(L)):
        g_z = g_h * torch.where(A[l + 1][:, :H] > 0, 1.0, slope)
        pts[f"layer {l} g_z"] = (Gz[l][:, :H], g_z,
                                 (1 + 2.0 ** -8) * (e_h + 2 * u * g_z.abs()))
        x, gzr = A[l][:, :ins[l]], Gz[l][:, :H]
        grads[l] = (x, gzr, g_z)
        gx = gzr @ Ws[l].t()
        e_h = slack(H, gzr.abs() @ Ws[l].abs().t())
        if l == sp.L1:
            row_ref["g_extras"] = gx[:, H:H + E]
        g_h, e_h = gx[:, :H], e_h[:, :H]
    # the PE backward of the layer-0 input gradient gx
    fr, dr = (r16(t[rows]).requires_grad_() for t in (feat, dists))
    with torch.enable_grad():
        row_ref["g_feat"], row_ref["g_dists"] = torch.autograd.grad(
            build_x(fr, dr, sp), (fr, dr), gx)
    leaves = {}
    for i, name in enumerate(("block1", "block3")):
        for j in range(sp.L1 if i == 0 else sp.L3):
            x, gzr, g_z = grads[j + (sp.L1 if i else 0)]
            leaves[f"d{name}[{j}].w"] = (
                x.t() @ gzr, lambda a, b, x=x, gzr=gzr: x[a:b].t() @ gzr[a:b])
            leaves[f"d{name}[{j}].b"] = (
                g_z.sum(0), lambda a, b, g_z=g_z: g_z[a:b].sum(0))
    hz = h * g_za
    leaves["dalpha[0].w"] = (hz.sum(0).reshape(H, 1),
                             lambda a, b: hz[a:b].sum(0).reshape(H, 1))
    leaves["dalpha[0].b"] = (g_za.sum(0), lambda a, b: g_za[a:b].sum(0))
    return pts, row_ref, leaves


def hold_general_k4(what: str, args, sp, names, out, plain):
    """The general K4's largest-error rule in bf16 (for `check_k4`), split
    where its roundings enter, each reading beside its control (a live tile
    of the kernel — T live rows, the median one — left out): its scratch
    (`general_bwd_scratch`, all live rows in one batch; its row gradients
    the same bits as `out`'s) within
    GENERAL_SUM_SLACK's rounding bound of `general_k4_chain`'s f64 values at
    every rounding point; the row gradients per tile at
    GENERAL_K4_BF16_TILE_TOL against their f64 values from that scratch,
    on the live rows (every other row exactly 0; the distance from the
    plain version summed in f64 fed the kernel's leaky-ReLU branches
    printed beside it); `out`'s dW / db / dwa / dba at
    GENERAL_K4_BF16_DW_TOL of max|f64| against phases B and C's function in
    f64 on that scratch (batches move only their f32 sums). Returns
    {name: (reading, control)}."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (any_plan,
                                                      fused_decode_bwd_plain,
                                                      general_bwd_scratch)
    feat, dists, extras, w, params, _sp, g_fagg, g_alpha = args
    M, K, H = feat.shape[0], sp.K, sp.H
    T = any_plan(sp, M, backward=True).T
    res, rows, acts, gzs = general_bwd_scratch(feat, dists, extras, w,
                                               params, sp, g_fagg, g_alpha)
    _, kern = decode_grad_leaves(res)
    if not all(torch.equal(a, b) for a, b in zip(kern[:4], out[:4])):
        fail(f"{what}: the scratch's call gives other row gradients than "
             f"the kernel's")
    kern = kern[:4] + list(out[4:])
    n = rows.numel()
    t = (n // T) // 2 * T                 # the median live tile's rows
    t1 = min(t + T, n)
    got = {}

    def held(name, reading, control, bar):
        log(f"{what}, {name}: {reading:.3e} [bar {bar:.3g}], control "
            f"{control:.3e}")
        if not reading <= bar:
            fail(f"{what}: {name} is past its bar")
        if not control > bar:
            fail(f"{what}: {name}'s bar does not tell the control apart")
        got[name] = (reading, control)

    with torch.no_grad():
        pts, row_ref, leaves = general_k4_chain(sp, args, rows, acts, gzs)
        for name, (k, ref, sl) in pts.items():
            bound = 2.0 ** -8 * ref.abs() + sl
            ratio = (k - ref).abs() / bound
            ratio = torch.where(bound > 0, ratio, (k != ref).double() * 1e30)
            ctl = (ref[t:t1].abs() / bound[t:t1]).nan_to_num(0.0)
            held(f"rounding point {name}, |err| / bound", float(ratio.max()),
                 float(ctl.max()), 1.0)
        # the row gradients, on the live rows (whole groups)
        groups = torch.div(rows[::K], K, rounding_mode="floor")
        masks = [(a[:, :H] > 0) for a in acts[1:]]
        sub = [x[rows] for x in (feat, dists, extras, w)]
        _, p64 = decode_grad_leaves(fused_decode_bwd_plain(
            *sub, params, sp, g_fagg[groups], g_alpha[groups],
            dtype=torch.float64, masks=masks))
        off = torch.ones(M, dtype=torch.bool, device=rows.device)
        off[rows] = False
        for i, name in enumerate(names[:4]):
            if bool(kern[i][off].any()):
                fail(f"{what}: {name} is nonzero on a row off the live list")
            k = kern[i][rows].double()
            if not k.numel():
                continue                # no extras
            log(f"{what}, {name} per tile of {T} live rows vs the f64 plain "
                f"version fed the kernel's branches (printed): "
                f"{tile_rel_max(k, p64[i], T):.3e}")
            z = k.clone()
            z[t:t1] = 0
            held(f"{name} per tile of {T} live rows, vs f64 on the scratch",
                 tile_rel_max(k, row_ref[name], T),
                 tile_rel_max(z, row_ref[name], T), GENERAL_K4_BF16_TILE_TOL)
        del p64
        for name, k in zip(names[4:], kern[4:]):
            ref, part = leaves[name]
            s = max(float(ref.abs().max()), 1e-300)
            held(f"{name} of max |f64 on the scratch|",
                 float((k.double() - ref).abs().max()) / s,
                 float(part(t, t1).abs().max()) / s, GENERAL_K4_BF16_DW_TOL)
    return got


def hold_k4_tc_tiles(what: str, args, sp, names, out, plain):
    """The tensor-core K4's largest-error rule in bf16 on a neural2d step:
    `hold_k4_tiles` over its own tiles (TC_ROWS_BWD rows), each tile's
    max|plain| floored at TC_K4_BF16_TILE_FLOOR of the tensor's, at the
    TC_K4_BF16_* bars."""
    from pointnerf_tpu_torch.ops.fused_decode import TC_ROWS_BWD
    return hold_k4_tiles(what, args, sp, names, out, plain,
                         TC_K4_BF16_TILE_TOL, TC_K4_BF16_DW_TOL,
                         T=TC_ROWS_BWD, floor_share=TC_K4_BF16_TILE_FLOOR)


def hold_general_times(checks):
    """Print each general kernel's time at the phase-30 shapes beside its
    plain version's, its bound, its share of the bound and the first
    general kernels'
    (FIRST_GENERAL_MS); fail where a time that table lists is not below its
    plain version's, or a bf16 one at H = 512 not GENERAL_SPEEDUP times
    below theirs."""
    for name, res in checks.items():
        for kern, row in (("K3", "fused_decode_any"),
                          ("K4", "fused_decode_bwd_any")):
            for label in ("bf16", "f32"):
                r = res[row] if label == "bf16" else res[row]["f32"]
                ms, plain, b = r["ms"], r["plain_ms"], r["bound_ms"]
                first = FIRST_GENERAL_MS.get((name, kern, label))
                log(f"phase 30 {name}: {kern} general {label} {ms:.4f} ms, "
                    f"plain {plain:.4f} ms ({plain / ms:.2f}x), bound "
                    f"{b:.4f} ms ({r['bound_by']}; {b / ms:.2%} of it), "
                    + (f"the first general kernel {first:.4f} ms "
                       f"({first / ms:.1f}x faster)" if first
                       else "the first general kernel not recorded"))
                if first is None:
                    continue
                if not ms < plain:
                    fail(f"phase 30 {name}: the general {kern} ({label}) is "
                         f"not faster than its plain version")
                if label == "bf16" and name == "h512" \
                        and not ms * GENERAL_SPEEDUP <= first:
                    fail(f"phase 30 {name}: the general {kern} (bf16) is not "
                         f"{GENERAL_SPEEDUP:g}x faster than the first one")


def general_dense_step(bwd_args):
    """Phase 30 (c) on the dataset path's recorded train step (f32, dense
    [R, SR, K] rows, ~1% live): the general K3 and K4 at H =
    GENERAL_DENSE_H with seeded weights (its g_fagg the recorded one's
    columns repeated), their plans (no workspace) and live lists (equal to
    the plain version's: only the live groups are decoded), held against
    the plain versions on the live groups' rows (within K3_F32_TOL and
    K4_F32_TOL of each output's and gradient's scale; a dead group's
    outputs are exactly 0 in both, and the kernels' are checked to be), two
    K4 calls the same bits, times beside the bounds. The plain versions run
    on the live rows alone: on all 2.3 M rows at H = 512 the f32 backward
    would hold some 50 GB of activations. Returns the numbers."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (
        any_plan, fused_decode, fused_decode_bwd, fused_decode_bwd_plain,
        fused_decode_plain, layer_inputs, live_groups_plain, route)
    feat, dists, extras, w, _p, spec, g_fagg, g_alpha = bwd_args
    sp = spec._replace(H=GENERAL_DENSE_H)
    M, H, K = feat.shape[0], sp.H, sp.K
    if spec.bf16 or route(sp) != "general" \
            or route(sp, backward=True) != "general":
        fail(f"the dense step at H = {H} is not on the general f32 route")
    g = torch.Generator(device="cuda").manual_seed(3)

    def dense(n):
        return {"w": torch.randn((n, H), generator=g, device="cuda")
                * (2.0 / n) ** 0.5,
                "b": torch.randn((H,), generator=g, device="cuda") * 0.1}
    dims = layer_inputs(sp)
    params = {"block1": [dense(n) for n in dims[:sp.L1]],
              "block3": [dense(n) for n in dims[sp.L1:]],
              "alpha": [{"w": torch.randn((H, 1), generator=g,
                                          device="cuda") * 0.1,
                         "b": torch.zeros((1,), device="cuda")}]}
    gf = g_fagg.repeat(1, -(-H // g_fagg.shape[1]))[:, :H].contiguous()
    plans = (any_plan(sp, M), any_plan(sp, M, backward=True))
    log(f"general dense step: {sp}, M={M}; K3 plan {plans[0]}; K4 plan "
        f"{plans[1]}")
    if any(p.ws for p in plans):
        fail("the general kernels' dense-step plan keeps a workspace")
    live3, live4 = live_counts(w, K), live_counts(w, K, gf, g_alpha)
    log(f"general dense step: {live3[0]} rows carry weight; live groups x K "
        f"= {live3[1]} rows decoded by K3 ({live3[1] / M:.4%}), {live4[1]} "
        f"by K4 ({live4[1] / M:.4%}); 64-row tiles with a weighted row = "
        f"{live3[2]} rows")
    groups = live_groups_plain(w, K, gf, g_alpha).long()
    rows = (groups[:, None] * K + torch.arange(K, device="cuda")).reshape(-1)
    dead = torch.ones(M, dtype=torch.bool, device="cuda")
    dead[rows] = False
    sub = [t[rows].contiguous() for t in (feat, dists, extras, w)]
    gsub = (gf[groups].contiguous(), g_alpha[groups].contiguous())
    out = {"M": M, "H": H, "live_rows": live3[0],
           "live_group_rows": live3[1]}
    with torch.no_grad():
        k3 = fused_decode(feat, dists, extras, w, params, sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p3 = fused_decode_plain(*sub, params, sp)
        torch.cuda.synchronize()
        plain3 = (time.perf_counter() - t0) * 1e3
        e3 = max(float((a[groups] - b).abs().max())
                 / max(float(b.abs().max()), 1e-30) for a, b in zip(k3, p3))
        dead_g = torch.ones(M // K, dtype=torch.bool, device="cuda")
        dead_g[groups] = False
        zero3 = all(not bool(a[dead_g].any()) for a in k3)
        del k3, p3
        ms3 = cuda_ms(lambda: fused_decode(feat, dists, extras, w, params,
                                           sp), iters=3, warmup=1)
        names, k4 = decode_grad_leaves(fused_decode_bwd(
            feat, dists, extras, w, params, sp, gf, g_alpha))
        _, again = decode_grad_leaves(fused_decode_bwd(
            feat, dists, extras, w, params, sp, gf, g_alpha))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k4, again))
        del again
        zero4 = all(not bool(a[dead].any()) for a in k4[:4])
        t0 = time.perf_counter()
        _, p4 = decode_grad_leaves(fused_decode_bwd_plain(
            *sub, params, sp, *gsub))
        torch.cuda.synchronize()
        plain4 = (time.perf_counter() - t0) * 1e3
        rel = [float(((a[rows] if i < 4 else a) - b).abs().max())
               / max(float(b.abs().max()), 1e-30)
               for i, (a, b) in enumerate(zip(k4, p4))]
        del k4, p4
        torch.cuda.empty_cache()
        ms4 = cuda_ms(lambda: fused_decode_bwd(feat, dists, extras, w,
                                               params, sp, gf, g_alpha),
                      iters=3, warmup=1)
    i = max(range(len(rel)), key=rel.__getitem__)
    for kern, ms, plain, err, tol, bwd in (
            ("K3", ms3, plain3, e3, K3_F32_TOL, False),
            ("K4", ms4, plain4, rel[i], K4_F32_TOL, True)):
        nrow, _nb, b, by = decode_bound(w, params, sp, backward=bwd)
        log(f"general dense step {kern} f32: largest |err| / max|plain| "
            f"{err:.3e}" + (f" ({names[i]})" if bwd else "")
            + f" [bar {tol:.0e}]; {ms:.4f} ms, plain on the {rows.numel()} "
            f"live rows {plain:.4f} ms (one call, host clock), bound "
            f"{b:.4f} ms ({by}: {nrow} of {M} rows carry weight; "
            f"{b / ms:.2%} of it)")
        if not err <= tol:
            fail(f"the general {kern} (f32) disagrees with its plain version "
                 f"on the dense step")
        out[kern] = {"max_rel_err": err, "ms": ms,
                     "plain_live_rows_ms": plain, "bound_ms": b,
                     "bound_by": by}
    log(f"general dense step: dead groups exactly 0 in K3 {zero3}, K4 "
        f"{zero4}; two K4 calls give the same bits: {same}")
    if not (zero3 and zero4):
        fail("the general kernels wrote nonzero outputs for a dead group")
    if not same:
        fail("the general K4 (f32) is not deterministic on the dense step")
    return out


def whole_aggregator_path(kernels, params, pc, st, grid, reqs, cfg):
    """Phase 30 (module docstring). The launches are those of the counted
    serves and steps alone (`agg_serve_and_step`); the card-vs-CPU
    requests and the recorded inputs of the kernel checks are taken
    outside them. Returns ((counts, routes), checks)."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import any_plan, route
    from pointnerf_tpu_torch.train.step import create_train_state
    t_all = time.perf_counter()
    total = ({}, {})
    scene_c = cpu_scene(pc, st, grid, cfg)
    tbatch = batches(cfg, N_RAYS, 1, "cuda")[0]
    secs = {}
    # (a) every distance kernel on K3 / K4's tensor-core route
    t0 = time.perf_counter()
    for name, kw in AGG_KERNELS.items():
        c = agg_config(cfg, kw, AGG_QUERY.get(name))
        p = agg_params(c)
        serve_s, _step_s, losses, _st = agg_serve_and_step(
            p, pc, st, grid, c, kernels, reqs[:1], tbatch, name,
            "tensor_core", total)
        agg_color_hold(name, serve_s, losses,
                       request_parity(p, pc, st, grid, c, scene_c, name))
        del p
    secs["kernels"] = time.perf_counter() - t0
    # (b) every layout outside the envelope on the unfused decode
    t0 = time.perf_counter()
    for name, kw in AGG_LAYOUTS.items():
        c = agg_config(cfg, kw)
        p = agg_params(c)
        serve_s, _step_s, losses, _st = agg_serve_and_step(
            p, pc, st, grid, c, kernels, reqs[:1], tbatch, name, None, total)
        agg_color_hold(name, serve_s, losses,
                       request_parity(p, pc, st, grid, c, scene_c, name))
        del p
    secs["layouts"] = time.perf_counter() - t0
    # (c) the general K3 / K4 at full width; their inputs are recorded
    # here, outside the counted runs, and held against the plain versions
    # once the path's launches are read
    recorded = {}
    for name, (akw, qkw) in AGG_GENERAL.items():
        t0 = time.perf_counter()
        c = agg_config(cfg, akw, qkw)
        p = agg_params(c)
        seen = capture_kernel_inputs(p, pc, st, grid, reqs[0], c)
        args3 = seen["fused_decode"][0]
        spec, M = args3[5], args3[0].shape[0]
        for bf16 in (True, False):
            sp = spec._replace(bf16=bf16)
            if {route(sp), route(sp, backward=True)} != {"general"}:
                fail(f"phase 30 {name}: K3 / K4 ({sp}) is not on the "
                     f"general route")
        for bf16 in (True, False):
            sp = spec._replace(bf16=bf16)
            plans = (any_plan(sp, M), any_plan(sp, M, backward=True))
            log(f"phase 30 {name}: {sp}, K3 plan {plans[0]}, K4 plan "
                f"{plans[1]}")
            if any(p.ws for p in plans):
                fail(f"phase 30 {name}: a general kernel's tile state is "
                     f"planned in a global workspace")
        k4_fresh = capture_k4_inputs(
            create_train_state(torch.Generator(device="cuda").manual_seed(2),
                               p, pc, c), st, grid, tbatch, c)
        serve_s, step_s, losses, state = agg_serve_and_step(
            p, pc, st, grid, c, kernels, reqs, tbatch, name, "general",
            total, steps=AGG_GENERAL_STEPS)
        log(f"phase 30 {name}: {len(reqs)} requests x {N_RAYS} rays in "
            f"{serve_s:.4f} s = {len(reqs) * N_RAYS / serve_s:.1f} rays/s; "
            f"{AGG_GENERAL_STEPS[1]} train steps after "
            f"{AGG_GENERAL_STEPS[0]} warm-up: {step_s:.4f} s/step = "
            f"{N_RAYS / step_s:.1f} train rays/s, losses "
            f"{[round(v, 6) for v in losses]} (host clock, synchronized)")
        recorded[name] = (seen["fused_decode"], k4_fresh,
                          capture_k4_inputs(state, st, grid, tbatch, c))
        del p, seen, state
        secs[name] = time.perf_counter() - t0
    counts, routes = total
    t0 = time.perf_counter()
    checks = {}
    for name, (cap3, k4_fresh, k4_trained) in recorded.items():
        k3 = check_k3([cap3], what=f"{name} request")
        k4 = {st_name: check_k4(args, f"{name}, {st_name} state",
                                hold_largest=hold_general_k4)
              for st_name, args in (("fresh", k4_fresh),
                                    ("trained", k4_trained))}
        checks[name] = {"fused_decode_any": {**k3["bf16"], "f32": k3["f32"]},
                        "fused_decode_bwd_any": {
                            **k4["trained"]["bf16"],
                            "f32": k4["trained"]["f32"],
                            "fresh_state": k4["fresh"]}}
    del recorded
    hold_general_times(checks)
    secs["general kernel checks"] = time.perf_counter() - t0
    log(f"phase 30 wall seconds {time.perf_counter() - t_all:.2f} ("
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"); launches of the counted serves and steps {counts}, routes "
        f"{routes}")
    return (counts, routes), checks


# ---- phase 31: the reference ScanNet scene on prebuilt tables (K1's wide
# path) with JPEG frames; phase 32: the MVSNeRF volume renderer ------------
TABLES_DIR = "scannet_tables"
TABLES_STEPS = 8
TABLES_MAX_D = 4096      # the first build; refresh_grid sizes it from num_dil
TABLES_WIDE_P = (30, 32, 40)   # QP 810 (scene101), 864 (tt/family), 1,080
TABLES_WIDE_K = (8, 24)        # K as the presets, and one past the run path
JPEG_QUALITY = 95
MVSNERF_PLANES = 128           # MVSNeRF's depth planes
MVSNERF_C = 8                  # its volume's channels
MVSNERF_WH = (640, 512)        # the views; the volume at 1/4 of them
MVSNERF_VIEWS = 3
MVSNERF_SAMPLES = 128
MVSNERF_NEAR_FAR = (2.2, 3.8)  # around MVS_RING's radius
MVSNERF_TOL = 1e-5             # card vs CPU colors: the march's bar
# the scannet_tables request card vs CPU: the trained density scaled by
# this (tables_parity). Readings on an H100 80GB HBM3 at 700 W (PERF.md
# §6), card / f32 decode / K - 1 neighbors, the colors' max |err|: as
# trained 2.98e-07 / 1.43e-06 / 1.19e-07 (the rays' opacity ~1e-4, the
# colors the background's), x 1000 8.3e-07 / 1.13e-03 / 6.07e-05 (opacity
# 0.108)
TABLES_DENSITY_SCALE = 1000.0


def tables_config():
    """scene_preset("scannet/scene241") with the JAX package's production
    query: prebuilt tables, no shell cut, knn_select="pallas" (P = 26:
    QP = 702), at most TABLES_STEPS steps with one eval at the end."""
    from pointnerf_tpu_torch.presets import scene_preset
    cfg = scene_preset(SCANNET_PRESET)
    return cfg.replace(
        query=dataclasses.replace(cfg.query, prebuild_neighbors=True,
                                  shell_layered=False, knn_select="pallas",
                                  max_d=TABLES_MAX_D),
        train=dataclasses.replace(cfg.train, maximum_step=TABLES_STEPS,
                                  test_freq=TABLES_STEPS,
                                  save_iter_freq=TABLES_STEPS,
                                  print_freq=TABLES_STEPS))


def jpeg_scannet_scene(src: str, dst: str):
    """Phase 26's ScanNet scene (written first where it is missing) with its
    color frames re-encoded as JPEG (Pillow, quality JPEG_QUALITY), as
    ScanNet ships them; depth, poses and intrinsics copied."""
    from PIL import Image
    if not os.path.isdir(os.path.join(src, "color")):
        write_scannet_scene(src)
    shutil.rmtree(dst, ignore_errors=True)
    for d in ("depth", "pose", "intrinsic"):
        shutil.copytree(os.path.join(src, d), os.path.join(dst, d))
    os.makedirs(os.path.join(dst, "color"))
    for f in sorted(os.listdir(os.path.join(src, "color"))):
        with Image.open(os.path.join(src, "color", f)) as im:
            im.convert("RGB").save(os.path.join(
                dst, "color", os.path.splitext(f)[0] + ".jpg"),
                quality=JPEG_QUALITY)


def check_k1_at(args, kw, what: str, Ks=TABLES_WIDE_K):
    """check_k1 at each K of `Ks` on one recorded K1 input; the first K's
    numbers, with the others' under "K<k>"."""
    out = {}
    for K in Ks:
        log(f"K1 on the {what}, K = {K}")
        out[K] = check_k1(args, {**kw, "K": K})
    res = dict(out[Ks[0]])
    res.update({f"K{k}": {n: v for n, v in out[k].items()
                          if n != "run_stats"} for k in Ks[1:]})
    return res


def scannet_tables_path(kernels, build: str):
    """Phase 31 (module docstring). Returns (counts, routes, checks)."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.data.scannet import ScannetDataset
    from pointnerf_tpu_torch.config import DataConfig
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.ops.knn_select import path_for
    from pointnerf_tpu_torch.train import driver as td
    from pointnerf_tpu_torch.train.step import eval_step, refresh_grid
    from pointnerf_tpu_torch.train.step import train_step
    root = os.path.join(build, TABLES_DIR)
    t0 = time.perf_counter()
    jpeg_scannet_scene(os.path.join(build, "scannet", SCANNET_SCAN),
                       os.path.join(root, SCANNET_SCAN))
    ds = ScannetDataset(DataConfig(dataset_name="scannet_ft", data_root=root,
                                   scan=SCANNET_SCAN), split="train")
    t_get = []
    for _ in range(2):
        t1 = time.perf_counter()
        ds.get_item(1, random_sample="random", random_sample_size=56)
        t_get.append(time.perf_counter() - t1)
    log(f"scannet_tables scene: {SCANNET_FRAMES} JPEG color frames of "
        f"{SCANNET_WH[0]} x {SCANNET_WH[1]} (quality {JPEG_QUALITY}) under "
        f"{root} in {time.perf_counter() - t0:.2f} s; get_item first touch "
        f"{t_get[0]:.4f} s (Pillow's decode), kept frame {t_get[1]:.4f} s")
    cfg = tables_config()
    q = cfg.query
    QP = int(np.prod(q.kernel_size)) * q.P
    log(f"scannet_tables config ({SCANNET_PRESET}, the production query): "
        f"P={q.P} (QP {QP}, K1 path {path_for(q.K, QP)}) SR={q.SR} K={q.K} "
        f"H={cfg.agg.shading_feature_num}, prebuild_neighbors "
        f"{q.prebuild_neighbors}, shell_layered {q.shell_layered}, knn_select "
        f"{q.knn_select}, first max_d {q.max_d}, compute "
        f"{cfg.train.compute_dtype}; JAX's default max_d = 4 x max_o = "
        f"{4 * q.max_o} rows would hold {4 * q.max_o * QP * 16 / 1e9:.2f} GB "
        f"of tables (scene101's P = 30 at its max_o "
        f"{4 * 2000000 * 27 * 30 * 16 / 1e9:.2f} GB)")
    rec = FirstBatchRecorder(cfg, kernels, TRAIN_KERNELS, RENDER_KERNELS,
                             record_step=TABLES_STEPS // 2)
    reset_counts(kernels)
    rec.install()
    try:
        with tempfile_dir(build) as run_dir:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _state, _st, hist = td.train_dataset_scene(
                "scannet_ft", root, SCANNET_SCAN, run_dir,
                max_steps=TABLES_STEPS, cfg=cfg, resume=False,
                device=IO_DEVICE)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            t0 = time.perf_counter()
            m = td.test_dataset_scene("scannet_ft", root, SCANNET_SCAN,
                                      run_dir, cfg=cfg, save_images=False,
                                      device=IO_DEVICE)
            torch.cuda.synchronize()
            t_test = time.perf_counter() - t0
    finally:
        rec.restore()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: w.launches for k, w in kernels.items()}
    routes = kernel_routes(kernels, "scannet_tables", k1="wide")
    n_chunks = -(-SCANNET_WH[0] * SCANNET_WH[1] // 9216)
    want = {"knn_select": TABLES_STEPS + 2 * n_chunks,
            "fused_decode": TABLES_STEPS + 2 * n_chunks,
            "fused_decode_bwd": TABLES_STEPS, "fused_march": 2 * n_chunks}
    if counts != want:
        fail(f"scannet_tables launches {counts}, expected {want} (each step "
             f"K1, K3, K4 once; each of two eval frames' {n_chunks} chunks "
             f"K1, K3, K2 once)")
    grids = [d for e, d in rec.log if e == "grid"]
    state0, st, grid, batch, _cfg = rec.first
    max_d = grid.nbr_pid.shape[0]
    tables = max_d * QP * 16
    losses = torch.stack(rec.losses).float().cpu()
    first, last = rec.first_batch_losses()
    psnr = hist["eval"][-1]["psnr"] if hist["eval"] else float("nan")
    steps = rec.times["train_step"]
    log(f"scannet_tables: grid builds (max_d asked, used, points) {grids}; "
        f"{int(grid.num_dil)} dilated cells, tables of {max_d} rows x {QP} "
        f"candidates = {tables / 1e9:.3f} GB; {TABLES_STEPS} steps of "
        f"{cfg.train.random_sample_size ** 2} rays and an eval frame in "
        f"{t_train:.2f} s, test_dataset_scene {t_test:.2f} s (host clock); "
        f"s/step mean {sum(steps) / len(steps):.4f} (first "
        f"{steps[0]:.4f}), eval frame {rec.times['eval_frame'][0]:.2f} s; "
        f"peak memory {peak:.2f} GiB; losses "
        f"{[round(float(v), 6) for v in losses]}, the first batch's "
        f"{first:.6f} -> {last:.6f}; PSNR train eval {psnr:.4f}, "
        f"test_dataset_scene {m['psnr']:.4f}; launches {counts}, routes "
        f"{routes}")
    if not bool(torch.isfinite(losses).all()) or not last < first:
        fail(f"scannet_tables: the loss is not finite and falling ({first} "
             f"-> {last})")
    if not abs(m["psnr"] - psnr) <= 0.01:
        fail(f"scannet_tables: test_dataset_scene PSNR {m['psnr']} differs "
             f"from the training eval's {psnr}")
    if rec.step_inputs is None or "eval_chunk" not in rec.captured:
        fail("scannet_tables: the step's or the eval chunk's inputs were not "
             "recorded")
    params = rec.last.params
    # a train step's K1 inputs (outside the counted window), and a 512-ray
    # request of the test frame card vs CPU at phase 5's bars
    with recording_kernels() as seen:
        train_step(rec.last, st, grid, batch, cfg)
    all_recorded(seen, "a scannet_tables train step", ("knn_select",))
    step_k1 = seen["knn_select"]
    del seen
    item = ScannetDataset(ds.cfg, split="test").get_item(
        0, random_sample="random", random_sample_size=96, seed=3)
    chunk = ray_batch_from_numpy(item, cfg, device=IO_DEVICE)
    b512 = type(chunk)(*[None if t is None else t[:512] if t.dim() and
                         t.shape[0] == 96 * 96 else t for t in chunk])
    with torch.no_grad():
        checks = {"scannet_tables_step": {
            "knn_select_wide": check_k1_at(*step_k1, "scannet_tables train "
                                           "step (QP 702)"),
            "fused_decode": check_k3([(rec.step_inputs["fused_decode"], {})],
                                     what="scannet_tables step")["bf16"],
            "fused_decode_bwd": check_k4(
                rec.step_inputs["fused_decode_bwd"])["bf16"]},
            "scannet_tables_eval_chunk": {
                "knn_select_wide": check_k1_at(
                    *rec.captured["eval_chunk"]["knn_select"],
                    "scannet_tables eval chunk (QP 702)"),
                "fused_decode": check_k3(
                    [rec.captured["eval_chunk"]["fused_decode"]],
                    what="scannet_tables eval chunk")["bf16"],
                "fused_march": check_k2(
                    *rec.captured["eval_chunk"]["fused_march"], tol=0.0)}}
    del rec, step_k1, state0
    torch.cuda.empty_cache()
    tables_parity(params, st, grid, cfg, b512)
    del grid
    torch.cuda.empty_cache()
    # K1 at the other reference scenes' widths and past 1,024: tables of the
    # same cloud at P = 30, 32 and 40, the inputs of a 9,216-ray request
    for P in TABLES_WIDE_P:
        cp = cfg.replace(query=dataclasses.replace(cfg.query, P=P))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gp, _ = refresh_grid(params["points"], st, cp, max_d=max_d)
        torch.cuda.synchronize()
        t_grid = time.perf_counter() - t0
        with recording_kernels() as seen:
            eval_step({"mlp": params["mlp"], "points": params["points"]}, st,
                      gp, chunk, cp)
        all_recorded(seen, f"a request at P = {P}", ("knn_select",))
        qp = 27 * P
        log(f"scannet_tables tables at P = {P}: QP {qp}, {max_d} rows = "
            f"{max_d * qp * 16 / 1e9:.3f} GB, built in {t_grid:.2f} s, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        with torch.no_grad():
            checks[f"scannet_tables_qp{qp}"] = {
                "knn_select_wide": check_k1_at(
                    *seen["knn_select"], f"request at P = {P} (QP {qp})")}
        del gp, seen
        torch.cuda.empty_cache()
    return counts, routes, checks


def tables_parity(params, st, grid, cfg, b_card):
    """A request card vs CPU on the scannet_tables scene, the trained
    weights' density (the alpha branch's last layer) scaled by
    TABLES_DENSITY_SCALE: at the scene's voxel size (0.008) the trained
    density leaves the rays nearly clear, so their colors sit at the
    background and no decode fault would show (both controls under phase
    5's bar at scale 1). Integers equal (K1's wide path on the card and
    its plain version choose the same neighbors); the colors of the rays
    that hit within phase 5's bar, beside two controls that must pass it,
    the CPU with an f32 decode and with one neighbor fewer (K - 1, a fault
    of K1); and, as phase 30 holds them, their mean |card - CPU| at most
    AGG_COLOR_SHARE of mean |card - f32 decode| (the control, the f32
    decode's own distance from the CPU, a share near 1). Returns the
    readings."""
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import eval_step
    mlp = dict(params["mlp"])
    mlp["alpha"] = [dict(layer) for layer in mlp["alpha"]]
    mlp["alpha"][-1] = {k: v * TABLES_DENSITY_SCALE
                        for k, v in mlp["alpha"][-1].items()}
    pc_c, st_c, grid_c = cpu_scene(params["points"], st, grid, cfg)
    mlp_c = tree_map(lambda t: t.cpu(), mlp)
    b_cpu = type(b_card)(*[None if t is None else t.cpu() for t in b_card])
    o_card = eval_step({"mlp": mlp, "points": params["points"]}, st, grid,
                       b_card, cfg)

    def cpu(c):
        return eval_step({"mlp": mlp_c, "points": pc_c}, st_c, grid_c, b_cpu,
                         c)
    o_cpu = cpu(cfg)
    same_integers(o_card, o_cpu)
    hit = o_cpu.ray_mask
    if not bool(hit.any()):
        fail("scannet_tables: no ray of the parity request hits the scene")
    o_less = cpu(cfg.replace(query=dataclasses.replace(cfg.query,
                                                       K=cfg.query.K - 1)))
    o_f32 = cpu(cfg.replace(train=dataclasses.replace(cfg.train,
                                                      compute_dtype="f32")))
    col, ref = o_card.coarse_raycolor.cpu()[hit], o_cpu.coarse_raycolor[hit]
    c32, cless = o_f32.coarse_raycolor[hit], o_less.coarse_raycolor[hit]
    err, ctl, ctl_less = (float((a - ref).abs().max())
                          for a in (col, c32, cless))
    den = mean_rel(col, c32)
    share, share_ctl = (mean_rel(a, ref) / den if den > 0 else float("inf")
                        for a in (col, c32))
    opacity = 1.0 - o_cpu.coarse_is_background[hit]
    log(f"scannet_tables card vs CPU, {b_card.raydir.shape[0]} rays of the "
        f"test frame, density x {TABLES_DENSITY_SCALE:g}: integers equal, "
        f"{int(hit.sum())} rays hit, their opacity mean "
        f"{float(opacity.mean()):.4f} (min {float(opacity.min()):.4f})")
    hold_bf16("scannet_tables card vs CPU colors of the rays that hit, max "
              "|err|", err, ctl, COLOR_BF16_TOL)
    hold_bf16("scannet_tables card vs CPU colors of the rays that hit, max "
              "|err|", err, ctl_less, COLOR_BF16_TOL,
              "the CPU with K - 1 neighbors")
    hold_bf16("scannet_tables card vs CPU colors, mean |err| over mean "
              "|card - f32 decode|", share, share_ctl, AGG_COLOR_SHARE,
              "the f32 decode's")
    return {"max_abs_err": err, "f32_control": ctl, "k_minus_1": ctl_less,
            "share": share, "opacity": float(opacity.mean())}


def mvsnerf_scene(device):
    """A seeded random cost volume at MVSNeRF's widths, MVSNERF_VIEWS views
    of the cluster's ring (random images), and ReferenceMVSNeRF v2 at the
    JAX defaults (D = 8, W = 256) with weights from a seed."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.mvs.mvsnerf import ReferenceMVSNeRF
    g = torch.Generator().manual_seed(0)
    W, H = MVSNERF_WH
    vol = torch.randn((MVSNERF_PLANES, H // 4, W // 4, MVSNERF_C),
                      generator=g)
    imgs = torch.rand((MVSNERF_VIEWS, H, W, 3), generator=g)
    Ks, w2cs = [], []
    for v in range(MVSNERF_VIEWS):
        th = 0.35 * (v - 1)
        c = np.array([MVS_RING["radius"] * np.sin(th), MVS_RING["height"],
                      -MVS_RING["radius"] * np.cos(th)])
        fwd = -c / np.linalg.norm(c)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd])
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = rot, -rot @ c
        w2cs.append(w2c)
        f = MVS_RING["focal"]
        Ks.append([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]])
    Ks = torch.tensor(np.asarray(Ks), dtype=torch.float32)
    w2cs = torch.tensor(np.asarray(w2cs), dtype=torch.float32)
    torch.manual_seed(1)
    dec = ReferenceMVSNeRF(net_type="v2", D=8, W=256,
                           n_views=MVSNERF_VIEWS).eval()
    mv = lambda t: t.to(device)  # noqa: E731
    return (dec.to(device), mv(vol), mv(imgs), mv(Ks), mv(w2cs))


def mvsnerf_rays(w2cs, Ks, n: int, seed: int):
    """`n` rays through random pixels of the reference view (view 0)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    W, H = MVSNERF_WH
    dev = w2cs.device
    pix = torch.stack([torch.rand(n, generator=g) * W,
                       torch.rand(n, generator=g) * H, torch.ones(n)], -1)
    c2w = torch.linalg.inv(w2cs[0].cpu().double())
    d = (pix.double() @ torch.linalg.inv(Ks[0].cpu().double()).T) \
        @ c2w[:3, :3].T
    return c2w[:3, 3].float().to(dev), d.float().to(dev)


def mvsnerf_path(kernels):
    """Phase 32 (module docstring). Returns (counts, routes, checks)."""
    import torch
    from pointnerf_tpu_torch.mvs import mvsnerf as mn
    dec, vol, imgs, Ks, w2cs = mvsnerf_scene("cuda")
    near, far = MVSNERF_NEAR_FAR
    reqs = [mvsnerf_rays(w2cs, Ks, N_RAYS, seed=i) for i in range(N_REQUESTS)]
    # the march's inputs of the first request, for K2's check; served
    # outside torch.no_grad (the decoder's parameters require grad), where
    # the card's rule still takes K2
    real, seen = mn.fused_march, []

    def rec(*a):
        seen.append(a)
        return real(*a)
    mn.fused_march = rec
    try:
        mn.render_mvsnerf(dec, vol, imgs, Ks, w2cs, *reqs[0], near, far,
                          n_samples=MVSNERF_SAMPLES)
    finally:
        mn.fused_march = real
    if len(seen) != 1:
        fail(f"an MVSNeRF request outside torch.no_grad called K2 "
             f"{len(seen)} times")
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    with torch.no_grad():
        for i, (campos, raydir) in enumerate(reqs):
            before = kernels["fused_march"].launches
            outs.append(mn.render_mvsnerf(dec, vol, imgs, Ks, w2cs, campos,
                                          raydir, near, far,
                                          n_samples=MVSNERF_SAMPLES))
            if kernels["fused_march"].launches != before + 1:
                fail(f"MVSNeRF request {i} launched K2 "
                     f"{kernels['fused_march'].launches - before} times")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("knn_select", "fused_decode", "fused_decode_bwd")}
    routes["fused_march"] = march_routes(kernels, "mvsnerf")
    if any(counts[n] for n in ("knn_select", "fused_decode",
                               "fused_decode_bwd")):
        fail(f"an MVSNeRF request launched another kernel than K2: {counts}")
    for i, (rgb, depth, w) in enumerate(outs):
        if rgb.shape != (N_RAYS, 3) or w.shape != (N_RAYS, MVSNERF_SAMPLES) \
                or not all(bool(torch.isfinite(t).all())
                           for t in (rgb, depth, w)):
            fail(f"MVSNeRF request {i}: outputs not finite or misshapen")
    n = N_REQUESTS * N_RAYS
    log(f"mvsnerf: {N_REQUESTS} requests x {N_RAYS} rays x {MVSNERF_SAMPLES} "
        f"samples (ReferenceMVSNeRF v2, D = 8, W = 256; volume "
        f"{tuple(vol.shape)}, {MVSNERF_VIEWS} views of {MVSNERF_WH[0]} x "
        f"{MVSNERF_WH[1]}) in {dt:.4f} s = {n / dt:.1f} rays/s (host clock, "
        f"synchronized); opacity of the rays: mean "
        f"{float(outs[0][2].sum(-1).mean()):.4f}; launches {counts}, routes "
        f"{routes}")
    dist, valid, feats, _bg = seen[0]
    log(f"mvsnerf K2 at [{dist.shape[0]}, {dist.shape[1]}, "
        f"{feats.shape[-1]}]")
    checks = {"mvsnerf_request": {"fused_march": check_k2(seen[0], {},
                                                          tol=0.0)}}
    # a 512-ray request card vs CPU (the plain march there, as JAX marches)
    campos, raydir = mvsnerf_rays(w2cs, Ks, 512, seed=99)
    cpu = torch.device("cpu")
    with torch.no_grad():
        o_card = mn.render_mvsnerf(dec, vol, imgs, Ks, w2cs, campos, raydir,
                                   near, far, n_samples=MVSNERF_SAMPLES)
        dec_c = mvsnerf_scene(cpu)[0]
        o_cpu = mn.render_mvsnerf(dec_c, vol.cpu(), imgs.cpu(), Ks.cpu(),
                                  w2cs.cpu(), campos.cpu(), raydir.cpu(),
                                  near, far, n_samples=MVSNERF_SAMPLES)
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(o_card, o_cpu)]
    log(f"mvsnerf card vs CPU, 512 rays: max |err| rgb {errs[0]:.3e}, depth "
        f"{errs[1]:.3e}, weights {errs[2]:.3e} (bar {MVSNERF_TOL} on rgb and "
        f"weights; depth printed)")
    if not (errs[0] <= MVSNERF_TOL and errs[2] <= MVSNERF_TOL):
        fail("mvsnerf: the card's request disagrees with the CPU's")
    return counts, routes, checks


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from pointnerf_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the pointnerf_tpu_torch package is not beside this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    info = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(info)}")
    for name, d in info.items():
        lines = [ln for ln in d["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        log(f"  {name}: {d['seconds']:.2f} s" + "".join(
            f"\n    {ln.strip()}" for ln in lines))

    cfg = slice_config()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pc, st, params, grid = make_scene(cfg, dev)
    torch.cuda.synchronize()
    log(f"scene: {N_POINTS} points, {int(grid.num_dil)} dilated cells "
        f"(table rows {grid.nbr_pid.shape[0]}), set-up "
        f"{time.perf_counter() - t0:.2f} s")
    reqs = batches(cfg, N_RAYS, N_REQUESTS, dev)
    seen = [capture_kernel_inputs(params, pc, st, grid, b, cfg) for b in reqs]

    results = {"knn_select": check_k1(*seen[0]["knn_select"]),
               "fused_march": check_k2(*seen[0]["fused_march"])}
    k3 = check_k3([s["fused_decode"] for s in seen])
    results["fused_decode"] = k3["bf16"]     # the main path decodes in bf16

    serve_counts, serve_routes = main_path(params, pc, st, grid, reqs, cfg)
    cpu_parity(params, pc, st, grid, cfg)

    from pointnerf_tpu_torch.train.step import create_train_state
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    tbatch = batches(cfg, N_RAYS, 1, dev)[0]      # bench.py's one batch
    k4 = check_k4(capture_k4_inputs(state, st, grid, tbatch, cfg))
    results["fused_decode_bwd"] = k4["bf16"]  # the training path is bf16
    train_counts, train_routes, state = train_path(state, st, grid, tbatch,
                                                   cfg)
    train_cpu_parity(state, st, grid, cfg)
    del state, seen

    maint, maint_counts, maint_routes, _secs, _rate = maintenance_path(
        cfg, kernel_wrappers())
    # each render kernel against its plain version at the shapes the
    # maintenance path gives it: a dense probe chunk and a compacted eval
    # chunk
    chunks = {}
    for kind in ("probe_chunk", "eval_chunk"):
        cap = maint.captured.get(kind)
        if cap is None:
            fail(f"no {kind}'s kernel inputs were recorded")
        chunks[kind] = {
            "knn_select": check_k1(*cap["knn_select"]),
            "fused_march": check_k2(*cap["fused_march"]),
            "fused_decode": check_k3([cap["fused_decode"]],
                                     what=kind.replace("_", " "))["bf16"]}
    maint.captured.clear()
    window_parity(maintenance_config(cfg), maint)
    del maint

    # the dataset path: a generated nerf_synth scene through
    # train_dataset_scene / test_dataset_scene at scene_config()
    data_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "nerf_synth")
    t0 = time.perf_counter()
    write_nerf_synth_scene(os.path.join(data_root, DS_SCAN))
    log(f"nerf_synth scene written under {data_root}: {DS_TRAIN_VIEWS} train "
        f"and {DS_TEST_VIEWS} test views of {DS_WH[0]} x {DS_WH[1]}, "
        f"{DS_POINTS} points, {time.perf_counter() - t0:.2f} s")
    ds_run = os.path.join(os.path.dirname(data_root), "nerf_synth_run")
    ds, ds_counts, ds_routes, _ds_secs, _psnr = dataset_path(
        kernel_wrappers(), data_root, ds_run)
    if ds.step_inputs is None or "eval_chunk" not in ds.captured:
        fail("the dataset path's decode inputs were not recorded")
    f32_k3, f32_k4 = check_f32_decode(
        [("train step", ds.step_inputs["fused_decode"]),
         ("eval chunk", ds.captured["eval_chunk"]["fused_decode"][0])],
        ds.step_inputs["fused_decode_bwd"])
    ds_cfg = ds.cfg
    dense_args = ds.step_inputs["fused_decode_bwd"]
    del ds
    # phase 30 (c)'s general f32 check on this recorded step
    torch.cuda.empty_cache()
    general_dense = general_dense_step(dense_args)
    del dense_args
    torch.cuda.empty_cache()
    query_branches(data_root, ds_cfg)
    voxel_parity()
    fo_counts, fo_routes, fo_checks = flags_off_path(kernel_wrappers())
    hy_counts, hy_routes, hy_checks, _hy_rates = hybrid_paths(
        kernel_wrappers())
    loader_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "loaders")
    t0 = time.perf_counter()
    write_loader_scenes(loader_root)
    log(f"loader scenes written under {loader_root} in "
        f"{time.perf_counter() - t0:.2f} s")
    ld_counts, ld_routes = loaders_path(kernel_wrappers(), loader_root)
    mv_counts, mv_routes, mv_checks, _mv_nums = mvs_paths(
        kernel_wrappers(), os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "build", "mvs"))
    n2_counts, n2_routes, n2_checks, _n2_nums = n2d_path(kernel_wrappers())
    # phases 24-29: import, edit, scannet, llff, video (the dataset path's
    # run directory), profiling
    io_paths, io_checks = scene_io_paths(kernel_wrappers(), params, pc, st,
                                         grid, reqs, cfg, data_root, ds_run,
                                         ds_cfg)
    shutil.rmtree(ds_run, ignore_errors=True)
    # phase 30: the whole aggregator
    whole_agg, agg_checks = whole_aggregator_path(kernel_wrappers(), params,
                                                  pc, st, grid, reqs, cfg)
    # phases 31-32: the reference ScanNet scene on prebuilt tables (K1's
    # wide path) with JPEG frames, and the MVSNeRF volume renderer
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    t0 = time.perf_counter()
    st_counts, st_routes, st_checks = scannet_tables_path(kernel_wrappers(),
                                                          build)
    t1 = time.perf_counter()
    mn_counts, mn_routes, mn_checks = mvsnerf_path(kernel_wrappers())
    log(f"phases 31-32 wall seconds: scannet_tables {t1 - t0:.2f}, mvsnerf "
        f"{time.perf_counter() - t1:.2f}")

    csrc = "pointnerf_tpu_torch/csrc/"
    # one row per kernel source: K3 and K4 have two, the tensor-core
    # kernels (bf16) and the CUDA-core kernels (f32), counted by route
    meta = {"knn_select": ("knn_select", "narrow", "knn_select.cu",
                           "pointnerf_tpu/ops/pallas_knn.py:89"),
            "knn_select_wide": ("knn_select", "wide", "knn_select.cu",
                                "pointnerf_tpu/ops/pallas_knn.py:89"),
            "fused_decode": ("fused_decode", "tensor_core",
                             "fused_decode_tc.cu",
                             "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_decode_f32": ("fused_decode", "cuda_core",
                                 "fused_decode.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_march": ("fused_march", "tiled", "fused_march.cu",
                            "pointnerf_tpu/ops/pallas_march.py:69"),
            "fused_march_wide": ("fused_march", "wide", "fused_march.cu",
                                 "pointnerf_tpu/ops/pallas_march.py:69"),
            "fused_decode_bwd": ("fused_decode_bwd", "tensor_core",
                                 "fused_decode_bwd_tc.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:467"),
            "fused_decode_bwd_f32": ("fused_decode_bwd", "cuda_core",
                                     "fused_decode_bwd.cu",
                                     "pointnerf_tpu/ops/pallas_decode.py:467"),
            "fused_decode_any": ("fused_decode", "general",
                                 "fused_decode_any.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_decode_bwd_any": ("fused_decode_bwd", "general",
                                     "fused_decode_bwd_any.cu",
                                     "pointnerf_tpu/ops/pallas_decode.py:467")}
    # the numbers of each row: at the main paths' shapes for K1, K2 and the
    # tensor-core kernels; the CUDA-core kernels at the dataset path's train
    # step, the shapes they run at on a path
    results["fused_decode_f32"] = {**f32_k3["train step"],
                                   "eval_chunk": f32_k3["eval chunk"],
                                   "bench_request": k3["f32"]}
    results["fused_decode_bwd_f32"] = {**f32_k4, "bench_step": k4["f32"]}
    # the general kernels at bench_config with H = 512 (bf16, the main
    # numbers; f32 beside them) and with K = 6
    for row_name, kern in (("fused_decode_any", "K3"),
                           ("fused_decode_bwd_any", "K4")):
        results[row_name] = {**agg_checks["h512"][row_name],
                             "k6": agg_checks["k6"][row_name],
                             "dense_step_f32": general_dense[kern]}
    # K1's wide path at the scannet_tables eval chunk (QP = 702)
    results["knn_select_wide"] = st_checks["scannet_tables_eval_chunk"][
        "knn_select_wide"]
    # K2's wide kernel at the shapes it runs at: a feature request, C = 128
    results["fused_march_wide"] = n2_checks.pop("n2d_request")[
        "fused_march_wide"]
    now = {"K3 f32, train step": f32_k3["train step"]["ms"],
           "K3 f32, eval chunk": f32_k3["eval chunk"]["ms"],
           "K4 f32, train step": f32_k4["ms"]}
    log("f32 route on the dataset path, this run vs the first f32 kernels "
        "(PERF.md §6): " + "; ".join(
            f"{k} {now[k]:.4f} ms vs {v:.4f} ms ({v / now[k]:.1f}x)"
            for k, v in FIRST_F32_MS.items()))
    paths = {"serve": (serve_counts, serve_routes),
             "train": (train_counts, train_routes),
             "maintenance": (maint_counts, maint_routes),
             "dataset": (ds_counts, ds_routes),
             "flags_off": (fo_counts, fo_routes),
             "hybrid": (hy_counts, hy_routes),
             "loaders": (ld_counts, ld_routes),
             "mvs": (mv_counts, mv_routes),
             "n2d": (n2_counts, n2_routes), **io_paths,
             "whole_agg": whole_agg,
             "scannet_tables": (st_counts, st_routes),
             "mvsnerf": (mn_counts, mn_routes)}
    rows = []
    for row_name, (wrapper, route_name, src, rep) in meta.items():
        r = results[row_name]
        # launches over the main paths' runs, of this source's route; K1's
        # run and warp paths together ("narrow"), its wide path apart (only
        # the scannet_tables path's rows are wider than 512)
        by_path = {p: (c[wrapper] - rts.get(wrapper, {}).get("wide", 0)
                       if route_name == "narrow"
                       else rts.get(wrapper, {}).get(route_name, 0))
                   for p, (c, rts) in paths.items()}
        row = {"name": row_name, "route": "cuda", "source": csrc + src,
               "replaces": rep, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k in ("host_us", "run_stats", "gemm_chain_ms", "M", "live_rows",
                  "live_group_rows", "live_tile_rows", "eval_chunk",
                  "bench_request", "bench_step", "f32", "k6",
                  "fresh_state", "K24", "dense_step_f32"):
            if k in r:
                row[k] = r[k]
        # the same comparison and timing on the maintenance path's dense
        # probe chunk and its eval chunk, on the flags-off path's train
        # step and request, and at the hybrid's and the fine pass's shapes
        # (K2 on the merged sequence, and on the fine one)
        hy = {}
        for p, res in hy_checks.items():
            for n, v in res.items():
                kind = (p + ("_step" if n == "fused_decode_bwd"
                             else "_request")
                        + ("_fine_sequence" if n == "fused_march_fine"
                           else ""))
                hy.setdefault(kind, {})[n.replace("_fine", "")] = v
        for kind, res in ({"maintenance_" + k: v for k, v in chunks.items()}
                          | fo_checks | hy | mv_checks | n2_checks
                          | io_checks | st_checks | mn_checks).items():
            if row_name in res:
                row[kind] = {k: v for k, v in res[row_name].items()
                             if k not in ("gemm_chain_ms", "run_stats")}
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

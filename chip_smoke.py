"""Drive tracklab_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  0. report whether pandas, yaml, cv2, scipy, tqdm and rich import, and
     their versions (no branch depends on it);
  1. build the CUDA kernels from tracklab_torch/csrc (one nvcc per source,
     all started together), and check with cuobjdump -sass that K3's and
     K4's kernels run on the tensor cores: each lists HMMA instructions,
     and the f32 ones (3xTF32: csp_staged_mma_kernel for float,
     vit_attention_tf32_kernel) HMMA on TF32 operands; and that
     every JV warp kernel (jv, jv_rect) lists REDUX (the argmin's
     redux.sync) and no BAR.SYNC;
  2. K1 (square JV assignment) against its plain version: identical col2row
     on random and tie-heavy costs, at S = 1, on a forced-matching square
     at S = 128, on -0.0 beside +0.0 and on rows all equal, and a batched
     launch with mixed k_eff/active; then timed at S = 64 (a
     forced-matching square and random costs), with ns per path step;
  3. K2 (batched rectangular JV assignment) against its plain version:
     identical col2row on random problems at (8, 64, 128) and at V = 5
     over (4, 9), (8, 16), (16, 16), (13, 40), on tie-heavy costs, on a
     batch with mixed active flags, at C = 33 (ragged lane runs), at
     C = 256 in shared memory (128 rows) and from device memory (256
     rows), at C = 300 (RT-DETR HF's transposed set matching, 64 rows) in
     shared memory and from device memory (256 rows), at C = 512 (16
     columns a lane), on -0.0 beside +0.0 and on rows all equal; then
     timed on random (8, 64, 128) costs, with ns per step of the longest
     problem (phase 8 times it on the path's own problems), and on random
     (8, 64, 300) costs;
  4. K3 (fused CSPLayer) against the plain layer at the seven YOLOX-s 640
     shapes and at two YOLOX-tiny 416 layers whose sizes do not divide into
     whole tiles (dark3 52x52, dark5 13x13), batch 8: f32 (3xTF32, the
     staged route at every layer) rel <= 1e-4 of the plain layer (TF32
     off); bf16 rel <= 3e-2 and no farther from f32 than the plain bf16
     layer (x1.5), with the planner's tile, with the compact ring and with
     the staged route; the planner's shared memory equal to the bf16
     kernel's with both rings; at two layers only the compact ring fits
     (YOLOX-l dark3, YOLOX-x dark5 at 640) and three no tile fits
     (YOLOX-l dark4, YOLOX-x dark3 and dark4), batch 2, bf16 no farther from f32 than the plain
     bf16 layer and f32 (the staged route) rel <= 1e-4, each timed by the
     planner's route, the staged route and plain; then the seven YOLOX-s
     layers timed at batch 128, also with the largest tile that fits
     instead of the planner's;
  5. OC-SORT on the card (through K1) against OC-SORT on the CPU on a
     200-frame, 20-object stream, id for id;
  6. multi-video trackers at 128 tracks / 64 dets: OC-SORT over V = 8
     60-frame streams in both batched modes, and ByteTrack in batched mode,
     each equal to the 8 single-video runs on the card id for id (boxes
     within 1e-4); one ByteTrack stream equal to the CPU's;
  7. the main path: YOLOX-s 640 bf16 (seeded random weights) -> NMS ->
     OC-SORT over 4 chunks of 128 quasi-static uint8 frames, with the
     kernels' launch counters read around it and 0 host syncs per frame
     required (the ORU replay runs as a kernel); 8 tracker steps profiled,
     with K1's own device time and launches on the path read from the
     profile; then an untimed pass over the first chunk that records the
     path's K1 and ORU replay inputs: the share of launches that solve,
     their path steps, the last 48 solving launches checked against the
     plain version and timed (ns per step);
  8. the multi-video path: 8 videos x 128 frames -> YOLOX-s 640 bf16 -> NMS
     (~20 detections per frame, 64 slots, min_confidence 0.4 as a mask) ->
     OC-SORT with batched=True stepping the 8 videos at once (K2), with
     the launch counters read around it, 0 host syncs per step required
     and 8 tracker steps profiled; then an untimed pass that records the
     ORU replay's inputs and trips per step and K2's last 4 inputs, on which
     K2 is checked against its plain version and timed (ns per step of
     each launch's longest problem).

Phases 9-11 and 14 run before 7 and 8; 12, 13, 15, 17 and 16 after them:
  9. K4 (ViT attention) against its plain version at (384, 193, 12, 64),
     (8, 256, 12, 64) with n_valid 193, (5, 37, 3, 64) and (2, 193, 12, 64)
     with n_valid 100, in f32 (1e-5 abs) and bf16
     (2e-2 of the output's scale, and no farther from the f32 plain result
     than the plain bf16 version, x1.5), on q, k, v views of one packed
     qkv tensor, in both softmax modes (f32, and the compute dtype's
     against vit_attention_compute_plain); then timed in bf16 at B = 384
     in both modes beside the plain version and SDPA (a yardstick only:
     the port never calls it), and in f32 (3xTF32) at (512, 193, 12, 64),
     the command line's KPR shape, beside the plain version and SDPA in
     f32 (TF32 off), with its bound (3xTF32's operations or the bytes)
     and the kernel required faster than the plain version;
 10. the ViT-B KPR (bf16, erfpoly GELU, seeded weights) at batch 64 once
     per attn_impl name, through K4 in that name's softmax mode and
     through the same mode's plain version on the card: embeddings within
     5e-2 of their scale, flipped binary visibility bits counted;
 11. BPBReID-StrongSORT (64 tracks, 32 dets, 6 x 512 part features) on the
     card against the CPU on one 40-frame synthetic stream (IoU and OKS
     motion, and the bot_sort strategy), and V = 8
     streams over the video axis in both batched modes (K1, then K2)
     against 8 single-video runs on the card, id for id;
 12. the parts path: 8 chunks of 16 quasi-static uint8 640 frames ->
     YOLOX-s bf16 -> NMS (~20 detections per frame, 32 slots) -> device
     crops -> KPR ViT-B bf16 part features over every slot ->
     BPBReID-StrongSORT (min_confidence 0.4), with the launch counters read
     around it and 0 host syncs required in one warmed chunk; then the
     first chunk split into detector, KPR (at full width and with the
     buckets 24, 32, which read the live count on the host; K4 and the top
     kernels within it, from the profiler) and 8 profiled tracker steps,
     and K4 checked and timed on the path's own layer-0 q, k, v;
 13. the ORU replay kernel against its plain version on the main path's
     and the multi-video path's recorded replay inputs (x within rtol 1e-5
     and atol 1e-4, P within rtol 1e-4 and atol 1e-3: cuBLAS sums the
     plain version's small products in its own order), timed on the
     multi-video inputs;
 14. YOLOX-l and YOLOX-x at 640, batch 2, bf16 (seeded weights): K3 runs
     every dense layer of 80x80 or less (its launches counted, each layer
     printed with its route: wide or compact ring, or staged), each model
     held against its own plain forward and both against the f32 plain
     forward;
 15. the ReID path: 8 chunks of 16 quasi-static uint8 640 frames ->
     YOLOX-s bf16 -> NMS (~20 detections per frame, 32 slots) -> device
     crops -> OSNet x1_0 f32 at 256 x 128 over every slot -> StrongSORT
     (strong_sort.yaml: 128 tracks, nn_budget 100, 512-d, max_age 40,
     min_confidence 0.4), with the launch counters read around it and 0
     host syncs required in one warmed chunk (OSNet also timed with the
     buckets 8, 16, 32 on the first chunk); the tracker stage
     rerun with the plain JV solvers (on host copies of their inputs) on
     its first 16 recorded frames, id for id;
     the detector rerun with the plain CSPLayers, its detections
     matched by IoU and compared; the first chunk split into detector,
     OSNet and 8 profiled tracker steps; then the tracker stage alone
     over V = 4 videos (32 frames each) with batched=True (K2, its
     launches reported apart from the path's) against 4 single-video runs
     in that mode, id for id, K2 identical to its plain version on the
     last 4 of the stage's inputs, and the stage's first 16 frames with
     the plain rectangular solver id for id (the default mode, K1,
     compared: NaN gating costs of free slots empty its appearance stage,
     a reference fault kept for parity, so the two modes part, in the JAX
     package as here);
 16. the ORU-NKF replay kernel (Deep-OC-SORT's "new KF") against its plain
     version on seeded random (8, 128) slots with gaps 1-50 and mixed need
     and on phase 17's recorded replay inputs (x within rtol 1e-5 / atol
     1e-4, P within rtol 1e-4 / atol 1e-3, slots that do not replay
     unchanged), timed on the random slots beside its bound and the plain
     loop, with ptxas's register and spill count;
 17. the camera-motion ReID path: 8 chunks of 16 uint8 640 frames cut from
     one seeded smooth texture panning by (+2, -1) px per frame -> LK
     camera warps on the card (gmc_warps, levels 3, iters 10, batched over
     each chunk's frame pairs) -> YOLOX-s bf16 -> NMS (~20 detections per
     frame, 64 slots) -> device crops -> OSNet x1_0 f32 at 256 x 128 over
     all 1024 crops of a chunk -> Deep-OC-SORT (deep_oc_sort.yaml), then
     BoT-SORT (bot_sort.yaml), min_confidence 0.4 as a mask: 0 host syncs
     in one warmed chunk of LK and each tracker's path; the warps within
     0.25 px of the pan and 0.01 of the identity, two pairs within 1e-3 of
     the LK on the CPU; launches of K1, K2, K3 and ORU-NKF counted around
     each run; 8 tracker steps profiled; the first 8 frames of each
     tracker stage equal to the stage on the CPU and to the stage with the
     plain JV solvers (on host copies of their inputs) and the plain
     ORU-NKF, id for id; the stage over V = 4 videos x 16 frames (the
     first half of the frames) in both batched modes equal to its own
     single-video runs, and K2 identical to its plain version on the last
     2 of its batched inputs.

Then K3's f32 route per layer and the command line:
 18. K3 f32 per dense CSPLayer of YOLOX-s at 640, batch 8 (the command
     line's detector): the planner's route (the staged one) timed against
     the plain layer (cuDNN convolutions) on the layer's own input and
     held within rel 1e-4 of it; the seven layers' sum beside their bound
     (3xTF32's operations or the bytes);
 19. phase cli: ``tracklab_torch.main.main`` in this process, (a) the
     quick start (synthetic.yaml, GT -> oc_sort.yaml) on the card, HOTA,
     MOTA and IDF1 100.0 and IDSW 0, equal to the same run with device=cpu
     id for id, K1 and ORU launched; (b) 2 synthetic 1920 x 1080 videos x
     200 frames x 24 objects -> YOLOX-s 640 f32 (yolox.yaml, seeded
     weights, thresholds calibrated to leave 10-40 detections per frame)
     -> OC-SORT, with engine.fused true and false: fused equals staged,
     K3, K1 and ORU launched and 0 host syncs inside the fused program,
     each run's frames/s and its split into loader, device programs, host
     DataFrame work and evaluation printed;
 20. phase cli_reid: ``tracklab_torch.main.main`` in this process, (a) 2
     synthetic 640 x 640 videos x 100 frames x 24 objects -> YOLOX-s 640
     f32 (yolox.yaml, calibrated thresholds) -> OSNet x1_0 on the card
     (osnet_batched.yaml, work size 640 x 640, 64 slots) -> StrongSORT
     (strong_sort.yaml), with engine.fused true and false: fused equals
     staged (rows, boxes, embeddings within rel 1e-3 of their scale, track
     ids), K3 and K1 launched, 0 host syncs inside the fused program;
     (b) +experiment=dancetrack_strongsort on a DanceTrack-layout tree
     written to a temporary directory (64 PNG frames of 1920 x 1080, the
     texture of phase 17 panning by (+2, -1) px per frame), staged with
     OSNetReId on host crops, once as typed with no other override, then
     with calibrated thresholds: K3 and K1 launched, HOTA printed (random
     weights), its first 8 frames equal to a device=cpu run on the rows
     matched by IoU; (c) the same tree through camera motion
     (sparse_opt_flow.yaml, method lk_jax: LK on the card) before
     Deep-OC-SORT and then BoT-SORT: every warp within 0.5 px of the pan,
     K1 launched, ORU-NKF in the Deep-OC-SORT run. Each run's frames/s and
     its split (loader, device, camera motion, host, evaluation) printed.

 21. phase engines: ``tracklab_torch.main.main`` in this process, (a)
     BASELINE config 5 (+experiment=batched_8videos, 8 videos of GT) on
     the batched engine, HOTA 100.0 and rows equal to the offline engine;
     then 8 synthetic 640 x 640 videos x 150 frames -> YOLOX-s f32 ->
     OC-SORT through the batched engine (one V = 8 scan) and the offline
     engine (8 per-video scans), rows equal, 0 host syncs in the scans,
     the tracker stages' seconds, K1 held to its plain version on the
     V-axis scan's own inputs, 8 of its steps profiled beside 8 steps
     of one video; (b) the online engine (engine=video,
     dataset=external_video) on mp4 files of 1920 x 1080 the script
     writes: YOLOX-s (batch 1) -> OC-SORT over 150 frames and YOLOX-s ->
     OSNet on host crops -> StrongSORT over 100, tracks equal to the
     tracker's process() over the run's own detections, detections within
     IoU 0.999 of the staged offline run on the same file, host syncs per
     frame of each module (the tracker's <= 1); (c) the pipelined engine
     on phase cli's (b) and phase cli_reid's (a) configurations, rows equal
     to their staged runs; (d) one video of (a) cut to 50 frames with
     visualization=save_videos and TorchProfiler: an mp4 of 50 frames, a
     trace that names K1's and K3's kernels. Frames/s of every run. Depth
     here: config 5's videos 40 frames, (a)'s detector runs 16, (b)'s
     clips 20, (d)'s video 25, K1's plain check on the last 2 solving
     launches.
 22. phase baseline: ``tracklab_torch.main.main`` in this process, (a)
     BASELINE config 1, +experiment=mot17_ocsort on a MOT17-layout tree of
     2 x 100 PNG frames of 1920 x 1080 the script writes, YOLOv8n 640 f32
     (seeded) -> OC-SORT with calibrated thresholds, staged and fused:
     rows equal, 0 host syncs in the fused program, K1 and ORU launched,
     the first 8 frames equal to device=cpu (IoU >= 0.999, track ids);
     then YOLO11m (modules/bbox_detector=yolo11) staged, against the CPU
     the same way; (b) BASELINE config 4 as typed,
     +experiment=soccernet_gamestate on a SoccerNetGS-layout tree (40
     frames and Labels-GameState.json): GS-HOTA printed, K3 and K1
     launched, what calibration emitted reported (nothing: no pitch
     lines); (c) the calibrated game-state chain on the synthetic
     game-state set (50 frames x 4 objects at 1920 x 1080): pitch
     segmenter (K3) -> OSNet -> StrongSORT (K1) -> OCR -> vote -> TVCalib
     (300 steps) -> projection: GS-HOTA > 80, every reprojection < 0.01,
     TVCalibration seconds per 16 frames, PitchSegNet ms per 8 frames,
     the cameras on the card against the CPU's.

 23. phase pose, the pose-tracking slice with seeded weights: (a) BASELINE
     config 3 as typed, +experiment=sportsmot_pose on a SportsMOT-layout
     tree of 2 x 40 PNG frames of 1280 x 720 the script writes (depth cut;
     the pose model's threshold calibrated to ~15 detections a frame):
     YOLOXPose-s 640 (K3) -> OSNet x1_0 with keypoint prompts (8 input
     channels) -> BPBReID-StrongSORT with OKS motion (K1): frames/s and
     its split, syncs in the tracker scans per frame, the first 8 frames
     equal to device=cpu (IoU >= 0.999, track ids), K1 on the stage's own
     inputs against its plain solver; (b) bottom-up -> OC-SORT on the tree,
     fused (run_fused_bottomup_video) equal to staged (boxes, keypoints
     within 1e-3, ids), 0 syncs in the fused program; (c) 2 x 40 synthetic
     640 frames -> YOLOX-s -> TopDownPoseBatched (TopDownPose-s 256 x 192)
     -> OC-SORT fused (run_fused_pose_video) equal to staged, 0 syncs in
     the fused program; YOLOX-s -> ViTPose-small on host crops -> OC-SORT
     staged, and ViTPose-small's heatmaps on the card within 1e-4 of the
     CPU's; (d) K3 at YOLOXPose-s's and TopDownPose-s's CSPLayers within
     1e-5 of the plain layers' scale and rel 1e-4 element by element (both
     within 1e-4 of f64), each model's maps within 1e-4 of its all-plain
     forward.

 24. phase posetrack, KPR part-based pose tracking with seeded weights on
     PoseTrack21-layout trees the script writes (the synthetic set's
     renders with keypoints in JPEG frames, 2 x 40 at 1280 x 720 and 2 x 60
     at 640 x 640; depth cut): (a) ``dataset=posetrack21 eval=posetrack21
     pipeline=[bbox_detector,pose_estimator,reid,track]`` with YOLOX-s
     (K3, threshold calibrated to ~11 detections a frame, at most 32),
     TopDownPose-s (K3), kpr.yaml (KPR ViT-B/16 f32 on host crops and
     prompts, K4 f32) and BPBReID-StrongSORT with OKS motion (K1), staged
     and fused (run_fused_gsr_video, 0 host syncs inside): frames/s split
     per module, the PoseTrack results, the staged run's first 4 frames of
     the first video against device=cpu (detections, the pose model's
     heatmaps, then KPR and the tracker from the card's rows: ids equal);
     on the 640 tree with KPReIdBatched,
     fused equal to staged; (b) YOLOX-s -> bpbreid.yaml (promptless KPR)
     -> BPBReID fused (run_fused_parts_video) equal to the prefix staged
     with KPReIdBatched; (c) K4 on the 12 attention layers of the fused
     run's first chunk (512 crops) within 1e-5 of its plain version, and
     its f32 time there beside the plain version, SDPA and its bound.

 25. phase zoo, the detector zoo and DeepLabV3 with seeded weights, f32:
     on a MOT17-layout tree of 2 x 40 PNG frames of 1920 x 1080 the script
     writes, (a) modules/bbox_detector=rtdetr_hf (RT-DETR r50vd 640, one
     class, deformable decoder) -> OC-SORT (K1, ORU), thresholds
     calibrated to ~25 detections a frame, staged and fused (fused equal
     to staged, 0 host syncs inside), the first 4 frames against
     device=cpu, one forward of 8 frames split into backbone, encoder and
     decoder (the deformable sampling's kernels apart), the encoder's
     top-300 equal to the CPU's; (b) modules/bbox_detector=rtmdet
     (RTMDet-nano 320) the same way; (c) modules/bbox_detector=rtdetr (the
     lightweight RT-DETR-s 640) staged, against the CPU, and K3 at its
     CSPDarknet's dense layers within rel 1e-4 of the plain layers;
     (d) PitchLineDetector(variant="deeplabv3") (ResNet-101, output
     stride 8) at 288 x 512 over 8 frames: ms per batch, logits within
     1e-4 of their scale from the CPU's, the argmax equal but at
     near-ties, the pitch lines equal.

 26. phase reid_zoo, the ReID backbone zoo with seeded weights, f32: (a)
     ``pipeline=[bbox_detector,reid,track] +modules/bbox_detector=yolox
     +modules/reid=backbone_zoo modules/track=strong_sort`` (resnet50_ibn_a
     at 256 x 128 on host crops, batch 32, 2048-d; StrongSORT at embed_dim
     2048) staged on 2 synthetic 640 x 640 videos x 40 frames x 24 objects,
     thresholds calibrated: K3 and K1 launched, 0 host syncs in the tracker
     scans, frames/s and its split (loader, detect, embed, scan, eval); the
     first 8 frames rerun with device=cpu, rows matched by IoU, track ids
     equal and embeddings within 1e-4 of their scale; (b) one key per zoo
     family at full width (HACNN 160 x 64, the rest 256 x 128): a batch of 4
     on the card within 1e-4 of the output's scale from the CPU's, and a
     batch of 32 timed with CUDA events.
 27. phase train, YOLOX training, f32 with TF32 off: (a) YOLOX-s 640
     (seeded, one class) on one fixed batch of 8 synthetic frames, AdamW
     1e-4: the first step against the same step on the CPU (loss 1e-4
     relative, gradients 5e-3 of their scale, BN statistics 1e-3), 20
     steps timed (ms per step, images/s, peak memory) and one more under
     torch.profiler (the card's busy share, launches), the loss falling,
     0 K3 launches in training, 7 in the inference after it; (b)
     ``train_tracking=true +experiment=mot17_ocsort
     modules/bbox_detector=yolox +modules/reid=osnet
     modules/track=strong_sort`` (1 epoch, asked of ``train_reid`` by the
     phase's spy around ``OSNetReId.train``) on a MOT17-layout tree of
     2 x 20 1080p PNG frames: OSNet x1_0 trains (weights move, 0 K3
     launches), the detector does not (as in the JAX package), then the
     run detects through K3 and tracks through K1; seconds in training,
     frames/s after. Phase baseline (c)
     also runs the SoccerNet baseline's cameras as TVCalib's start on the
     chain's 16 frames against the default start.

  28. phase train_zoo, the other families' training, f32 with TF32 off, on
     seeded weights and one fixed synthetic batch each: (a) OSNet x1_0
     256 x 128, batch 32, 8 identities (cross-entropy + batch-hard
     triplet, Adam); (b) KPR ViT-B/16 384 x 128 (kpr.yaml), batch 16 (K4
     forward under autograd, 12 launches a forward; K4's dq, dk, dv
     through its Function against autograd through the plain attention
     at the same shape); (c) YOLOv8n 640, batch 8 (TAL + CIoU + DFL,
     AdamW); (d) RT-DETR-s 640, 100 queries, batch 8 (set matching: one
     K2 launch a step, the matching of one step's cost stack equal to
     K2's plain version); (e) RTMDet-nano 320, batch 8: ``train`` raises
     as the JAX wrapper's does, the train-mode forward against the CPU's;
     (f) TopDownPose-s 256 x 192, batch 16 (heatmap MSE, Adam). Each
     family's first step against the same step on the CPU (loss 1e-4
     relative, BN statistics 1e-3, gradients 5e-3 of their scale and the
     median leaf 1e-3 or, where the family's loss makes the CPU's own
     gradients part by more when the batch is permuted (and, but for
     OSNet, whose depthwise layers crawl without it, oneDNN is off:
     batch-hard triplet mining, BN backward's cancellations), twice that
     spread; where the card's set matching of the first step differs from
     the CPU's, a near-tie, only the median's bound), then
     steps timed with CUDA events (ms per step, images/s, peak memory),
     the loss falling, 0 K3 launches in training.

  29. phase int8, post-training int8 (models/quantize.py) on YOLOX-s 640
     (seeded, scales calibrated on 8 frames): (a) every s8 x s8 -> s32
     product of one forward at batch 8 through the device route
     (torch._int_mm over an int8 im2col) equal to the plain version (an
     f64 convolution of the same codes on the card), max |delta| 0; (b) ms
     per forward, int8 against f32 and bf16 (with K3, and cuDNN alone) at
     batch 8 and 32, peak memory, _int_mm's share of the int8 forward's
     device time; (c) YOLOXDetector(quant="int8") calibrated on the first
     chunk, then int8 YOLOX-s -> NMS -> OC-SORT over 4 x 32 frames: frames/s
     beside the float path's, 0 host syncs in a warm chunk, K1 and the
     int8 route launched and no K3, the share of int8 detections at IoU
     >= 0.5 of a float one, and the first 2 frames against the same int8
     model on the CPU (the stem's codes equal, the predictions within
     int8's own error of f32: an ulp of BN or SiLU moves a code on a
     rounding boundary, and that grows with depth); (d)
     +modules.bbox_detector.quant=int8 (YOLOv8n) staged on the command
     line, calibrated on its first batch, K1 launched.
  30. phase mesh, the multi-device layer (parallel/) at world size 1 on
     NCCL: a one-rank process group and its video mesh (one all-reduce on
     the card), tracker_videos_sharded (8 x 60 frames), fused_videos_sharded
     (YOLOX-s bf16 -> OC-SORT, 2 x 16 frames), gmc_warps_time_sharded (32
     panning frames) each equal to its unsharded run, and
     +experiment=batched_8videos with engine.use_mesh true against false
     on the command line; the group destroyed at the end.
  31. phase orbax, the JAX package's orbax checkpoints (models/orbax_io.py):
     (a) the committed fixture (tests/data/torch_orbax, written by the JAX
     package in the OCDBT and use_ocdbt=false layouts) read on the card's
     host, every leaf equal to expected.npz bit for bit, the zstd route and
     the ms to read printed; (b) YOLOX-s (seeded) -> yolox_to_flax ->
     save_checkpoint -> YOLOXDetector(checkpoint_path=...) on the card, its
     weights equal to the seeded model's; the fused main path (YOLOX-s 640
     bf16, K3 -> NMS -> OC-SORT, K1 and ORU) over 2 x 32 frames with the
     loaded and the seeded model: tracks id for id and detections bit for
     bit equal, 0 host syncs and K3, K1 and ORU launched in the loaded
     model's run; the seconds to write and to read printed.

The last three lines are the card's name and power limit, a JSON line with
each kernel's check and times (K1-K4, the ORU replay and ORU-NKF; its
launches on its own path, and per run of phases cli_reid, engines,
baseline, pose, posetrack, zoo, reid_zoo, train and train_zoo under
``launches_by_path``; K4's
f32 figures
at the KPR command line's shape under ``f32_kpr_cli``), and {"ok": true,
"device": ...}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from functools import partial
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK = {"bf16": 989e12, "f32": 67e12, "tf32": 494.7e12}
# tracker steps per torch.profiler window (32 on the main path and 16
# elsewhere before phase zoo: the profiler's post-processing of each window
# took 10-37 s, and the room went to that phase)
PROFILED_STEPS = 8


_T0 = time.perf_counter()


def log(*a):
    """A line of the run's log, after the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound_ms(nbytes, ops, peak):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def bound_ms_f32(nbytes, ops):
    """The bound of f32 work that a kernel may run on CUDA cores or in
    3xTF32 on the tensor cores (three TF32 products for each f32 one):
    max(bytes, min(ops / f32 peak, 3 ops / TF32 peak)). Returns (ms,
    "bytes" or "operations", the term that set the operations' time)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_cuda, t_tf32 = (ops / PEAK["f32"] * 1e3, 3 * ops / PEAK["tf32"] * 1e3)
    t_o = min(t_cuda, t_tf32)
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            "3xTF32 tensor cores" if t_tf32 <= t_cuda else "f32 CUDA cores")


def check_sass(torch):
    """Every tensor-core kernel of csp and vit_attention (``*_mma_kernel``
    in both types, ``*_tf32_kernel``) lists HMMA instructions in its SASS,
    and every f32 one (K3's staged float instantiations, K4's tf32 kernel)
    lists HMMA on TF32 operands (3xTF32); every JV kernel of jv and jv_rect
    (one warp per problem) lists REDUX (the argmin's redux.sync) and no
    BAR.SYNC (no block barrier anywhere, so none in the step loop).
    Returns the counts."""
    from pathlib import Path

    from tracklab_torch.kernels import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")

    def functions(name):
        sass = subprocess.run([str(tool), "-sass", str(_build.library(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        return [(f.split(None, 1)[0], f)
                for f in sass.split("Function : ")[1:]]

    counts, f32_kernels = {}, []
    for name in ("csp", "vit_attention"):
        for fname, f in functions(name):
            if "mma_kernel" in fname or "tf32_kernel" in fname:
                hmma = [ln for ln in f.splitlines() if "HMMA" in ln]
                counts[fname] = dict(HMMA=len(hmma), TF32=sum(
                    ".TF32" in ln for ln in hmma))
                # the float instantiations (mangled "...kernelIf...")
                if "tf32_kernel" in fname or "mma_kernelIf" in fname:
                    f32_kernels.append(fname)
        check(any(name in f for f in counts),
              f"{name}: no mma kernel in the SASS")
    log(f"SASS: HMMA and TF32 HMMA count per tensor-core kernel {counts}")
    for fname, c in counts.items():
        check(c["HMMA"] > 0, f"{fname}: no HMMA in its SASS")
    # K3: the staged route's three stage kinds; K4: two widths
    check(len(f32_kernels) == 5, f"f32 tensor-core kernels {f32_kernels}")
    for fname in f32_kernels:
        check(counts[fname]["TF32"] > 0, f"{fname}: no TF32 HMMA")
    jv_counts = {}
    for name in ("jv", "jv_rect"):
        funcs = [(n, f) for n, f in functions(name) if "warp_kernel" in n]
        check(funcs, f"{name}: no warp kernel in the SASS")
        for fname, f in funcs:
            jv_counts[fname] = dict(REDUX=f.count("REDUX"),
                                    BAR_SYNC=f.count("BAR.SYNC"))
    log(f"SASS: REDUX and BAR.SYNC per JV kernel {jv_counts}")
    for fname, c in jv_counts.items():
        check(c["REDUX"] > 0, f"{fname}: no REDUX in its SASS")
        check(c["BAR_SYNC"] == 0, f"{fname}: {c['BAR_SYNC']} BAR.SYNC")
    return counts, jv_counts


# ---------------------------------------------------------------- phase 2: K1
def phase_k1(torch, dev):
    from tracklab_torch.kernels import jv
    from tracklab_torch.ops.assignment import _forced_prep

    g = torch.Generator(device="cpu").manual_seed(0)
    cases = [(f"random K={k}", torch.randn(k, k, generator=g))
             for k in (32, 64, 128) for _ in range(2)]
    tie = torch.zeros(64, 64)
    tie[:5, :4] = -2.0
    cases += [("tie blocks K=64", tie),
              ("integer ties K=48", torch.randint(0, 3, (48, 48),
                                                  generator=g).float())]
    # the warp kernel's edge cases: one column per lane run (S = 1), full
    # runs of 4 (S = 128, a forced-matching square with its ties), ragged
    # runs with -0.0 beside +0.0, and rows all equal (drawn from their own
    # generator, so the older cases keep their draws)
    g2 = torch.Generator(device="cpu").manual_seed(10)
    sq128, _ = _forced_prep(-torch.rand(1, 96, 128, generator=g2),
                            torch.rand(1, 96, generator=g2) < 0.8,
                            torch.rand(1, 128, generator=g2) < 0.7)
    cases += [("S=1", torch.randn(1, 1, generator=g2)),
              ("forced square S=128", sq128[0]),
              ("signed zeros K=40", _signed_zeros(torch, g2, 40, 40)),
              ("all-equal rows K=64",
               torch.randn(1, 64, generator=g2).expand(64, 64).contiguous())]
    one = lambda k: torch.tensor([k], dtype=torch.int32, device=dev)  # noqa
    on = torch.ones(1, dtype=torch.bool, device=dev)
    for name, c in cases:
        got = jv.solve_square_batched(c.to(dev)[None], one(c.shape[0]), on)[0]
        want = jv._solve_square_plain(c)
        check(torch.equal(got.cpu(), want), f"K1 {name}: col2row differs")
    log(f"K1: {len(cases)} problems identical to the plain version")

    S = 64
    c = torch.randn(6, S, S, generator=g).to(dev)
    k_eff = torch.tensor([64, 32, 17, 64, 1, 40], dtype=torch.int32,
                         device=dev)
    act = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool, device=dev)
    got = jv.solve_square_batched(c, k_eff, act)
    want = jv.solve_square_batched_plain(c, k_eff.cpu(), act.cpu()).to(dev)
    check(torch.equal(got, want), "K1 batched mixed k_eff/active differs")
    log("K1: batched launch with mixed k_eff/active identical")

    # a main-path problem: 32 detection rows x 64 track columns,
    # forced-matching square (matching_forced's full branch)
    cost = -torch.rand(32, 64, generator=g)
    rm = torch.rand(32, generator=g) < 0.75
    cm = torch.rand(64, generator=g) < 0.65
    sq, _ = _forced_prep(cost[None], rm[None], cm[None])
    sq = sq[0].to(dev)
    stats = {}
    want = jv._solve_square_plain(sq, stats)
    kk = one(S)
    got = jv.solve_square_batched(sq[None], kk, on)[0]
    check(torch.equal(got, want), "K1 main-path problem differs")
    ms = cuda_ms(lambda: jv.solve_square_batched(sq[None], kk, on), 200)
    plain_ms = cuda_ms(lambda: jv._solve_square_plain(sq), 2, warmup=1)
    # each shortest-path step: ~6 f32 ops per column (2 sub, cmp, select,
    # argmin, dual update)
    ops = stats["steps"] * 6 * S
    b_ms, b_by = bound_ms(S * S * 4 + S * 4 + 5, ops, PEAK["f32"])
    rnd = torch.randn(S, S, generator=g)
    r_stats = {}
    jv._solve_square_plain(rnd, r_stats)
    rnd = rnd.to(dev)[None]
    r_ms = cuda_ms(lambda: jv.solve_square_batched(rnd, kk, on), 200)
    log(f"K1 timing at S=64: forced-matching square {ms:.4f} ms, "
        f"{stats['steps']} path steps, {ms * 1e6 / stats['steps']:.1f} ns "
        f"per step; random costs {r_ms:.4f} ms, {r_stats['steps']} path "
        f"steps, {r_ms * 1e6 / r_stats['steps']:.1f} ns per step; plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(name="K1 jv_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:146",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), dict(
                    forced_s64=dict(ms=ms, steps=stats["steps"],
                                    ns_per_step=ms * 1e6 / stats["steps"]),
                    random_s64=dict(ms=r_ms, steps=r_stats["steps"],
                                    ns_per_step=r_ms * 1e6
                                    / r_stats["steps"]))


def _plain_on_host(solver):
    """A plain JV solver run on host copies of its tensor arguments, its
    col2row moved back to the arguments' device: the same plain code on
    the same values (compares and f32 adds, so the device does not change
    the result), without the host sync that each path step of a plain
    solve costs on the card (~1 s per solving call at 128 tracks). For the
    tracker-stage reruns that swap the plain solvers in for K1 and K2."""
    def run(cost, *rest):
        out = solver(cost.cpu(), *(None if a is None else a.cpu()
                                   for a in rest))
        return out.to(cost.device)

    return run


def _signed_zeros(torch, g, R, C):
    """An (R, C) cost of -1, -0.0, +0.0 and 1 with -0.0 and +0.0 in every
    row: their ties must break to the lowest column, as f32 compares them."""
    c = torch.randint(-1, 2, (R, C), generator=g).float()
    c = torch.where((c == 0) & (torch.rand(R, C, generator=g) < 0.5), -0.0,
                    c)
    c[:, 0], c[:, 1] = -0.0, 0.0
    return c


# ---------------------------------------------------------------- phase 3: K2
def phase_k2(torch, dev):
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)

    g = torch.Generator(device="cpu").manual_seed(2)
    cases = [("random (8, 64, 128)", torch.randn(8, 64, 128, generator=g),
              None)]
    cases += [(f"random (5, {r}, {c})", torch.randn(5, r, c, generator=g),
               None) for r, c in ((4, 9), (8, 16), (16, 16), (13, 40))]
    tie = torch.zeros(2, 6, 20)
    tie[0, :4, :3] = -2.0          # absorbing block with ties
    tie[1] = 1.0                   # fully degenerate
    cases.append(("tie-heavy (2, 6, 20)", tie, None))
    cases.append(("mixed active (6, 64, 128)",
                  torch.randn(6, 64, 128, generator=g),
                  torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool)))
    # the warp kernel's edge cases (the plain version on the CPU): ragged
    # runs (C = 33), full runs of 8 in shared memory (128 x 256) and from
    # device memory (256 x 256, above the shared-memory cap), -0.0 beside
    # +0.0, rows all equal
    row = torch.randn(2, 1, 40, generator=g)
    cases += [("ragged C=33 (4, 20, 33)", torch.randn(4, 20, 33, generator=g),
               None),
              ("C=256 in shared memory (2, 128, 256)",
               torch.randn(2, 128, 256, generator=g), None),
              ("C=256 from device memory (2, 256, 256)",
               torch.randn(2, 256, 256, generator=g), None),
              ("C=300 in shared memory (2, 64, 300)",
               torch.randn(2, 64, 300, generator=g), None),
              ("C=300 from device memory (2, 256, 300)",
               torch.randn(2, 256, 300, generator=g), None),
              ("C=512, 16 columns a lane (2, 40, 512)",
               torch.randn(2, 40, 512, generator=g), None),
              ("signed zeros (3, 17, 33)",
               torch.stack([_signed_zeros(torch, g, 17, 33)
                            for _ in range(3)]), None),
              ("all-equal rows (2, 8, 40)",
               row.expand(2, 8, 40).contiguous(), None)]
    for name, c, act in cases:
        got = solve_rect_batched(c.to(dev), None if act is None
                                 else act.to(dev))
        want = solve_rect_batched_plain(c, act)
        check(torch.equal(got.cpu(), want), f"K2 {name}: col2row differs")
    log(f"K2: {len(cases)} batches identical to the plain version")

    c = cases[0][1].to(dev)
    V, R, C = c.shape
    per = _steps_per_problem(torch, c)
    ms = cuda_ms(lambda: solve_rect_batched(c), 200)
    plain_ms = cuda_ms(lambda: solve_rect_batched_plain(c), 1, warmup=1)
    # each shortest-path step: ~6 f32 ops per column (2 sub, cmp, select,
    # argmin, dual update)
    ops = sum(per) * 6 * C
    b_ms, b_by = bound_ms(V * R * C * 4 + V * C * 4, ops, PEAK["f32"])
    log(f"K2 timing at (8, 64, 128): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}), {sum(per)} path "
        f"steps, {max(per)} in the longest problem: "
        f"{ms * 1e6 / max(per):.1f} ns per step")
    # C = 300: RT-DETR HF's set matching, (64 ground-truth slots, 300
    # queries) after the transposition, 10 columns a lane
    c3 = torch.randn(8, 64, 300, generator=g).to(dev)
    per3 = _steps_per_problem(torch, c3)
    ms3 = cuda_ms(lambda: solve_rect_batched(c3), 100)
    plain3 = cuda_ms(lambda: solve_rect_batched_plain(c3), 1, warmup=1)
    b3, b3_by = bound_ms(8 * 64 * 300 * 4 + 8 * 300 * 4,
                         sum(per3) * 6 * 300, PEAK["f32"])
    log(f"K2 timing at (8, 64, 300): kernel {ms3:.4f} ms, plain "
        f"{plain3:.3f} ms, bound {b3:.6f} ms ({b3_by}), {max(per3)} steps "
        f"in the longest problem: {ms3 * 1e6 / max(per3):.1f} ns per step")
    return dict(name="K2 jv_rect_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv_rect.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:302",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                steps=sum(per), longest_problem_steps=max(per),
                ns_per_step=ms * 1e6 / max(per),
                c300=dict(shape=[8, 64, 300], ms=ms3, plain_ms=plain3,
                          bound_ms=b3, bound_by=b3_by,
                          longest_problem_steps=max(per3),
                          ns_per_step=ms3 * 1e6 / max(per3)))


def _steps_per_problem(torch, cost, active=None):
    """Path steps of each active problem of a (V, R, C) K2 input, from the
    plain version on the CPU. The problems of a launch run side by side,
    one warp each, so the longest one sets the launch's chain of steps."""
    from tracklab_torch.kernels.jv_rect import _solve_rect_plain

    cost = cost.cpu()
    act = [True] * cost.shape[0] if active is None else active.tolist()
    out = []
    for b, a in enumerate(act):
        if a:
            stats = {}
            _solve_rect_plain(cost[b], stats)
            out.append(stats["steps"])
    return out


# ---------------------------------------------------------------- phase 4: K3
# (name, H=W, cin, cout, n, shortcut) of YOLOX-s at 640x640
CSP_SHAPES = [("dark3__1", 80, 128, 128, 3, True),
              ("dark4__1", 40, 256, 256, 3, True),
              ("dark5__2", 20, 512, 512, 1, False),
              ("C3_p4", 40, 512, 256, 1, False),
              ("C3_p3", 80, 256, 128, 1, False),
              ("C3_n3", 40, 256, 256, 1, False),
              ("C3_n4", 20, 512, 512, 1, False)]
# two YOLOX-tiny 416 layers: ragged tiles, ch = 48 (a K tail of 48 in a
# 64-wide chunk, a partial 64-channel block) and ch = 192
CSP_RAGGED = [("tiny416 dark3__1", 52, 96, 96, 3, True),
              ("tiny416 dark5__2", 13, 384, 384, 1, False)]
# two layers only bf16's compact ring fits (f32 takes the staged route
# everywhere): YOLOX-l dark3 at 640 (ch 128, n 9) and YOLOX-x dark5 at 640
# (ch 640, n 4), checked at batch 2
CSP_COMPACT = [("l640 dark3__1", 80, 256, 256, 9, True),
               ("x640 dark5__2", 20, 1280, 1280, 4, False)]
# the three layers no bf16 tile fits (the staged route): YOLOX-l
# dark4 (ch 256, n 9), YOLOX-x dark3 (ch 160, n 12) and dark4 (ch 320, n 12)
# at 640, checked at batch 2
CSP_STAGED = [("l640 dark4__1", 40, 512, 512, 9, True),
              ("x640 dark3__1", 80, 320, 320, 12, True),
              ("x640 dark4__1", 40, 640, 640, 12, True)]


def _seeded_csp(torch, cin, cout, n, shortcut, dtype, dev, seed, realistic):
    """A CSPLayer with seeded weights. ``realistic``: gain-1.5 convs and
    positive random BN statistics (the regime of trained checkpoints);
    otherwise the main path's initialisation (YOLOX.randomize_: lecun-normal
    convs, identity BN)."""
    from tracklab_torch.models.yolox import CSPLayer

    layer = CSPLayer(cin, cout, n, shortcut, dtype=dtype).eval()
    g = torch.Generator().manual_seed(seed)
    gain = 1.5 if realistic else 1.0
    with torch.no_grad():
        for name, t in layer.state_dict().items():
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        * (gain / math.sqrt(t[0].numel())))
            elif realistic:
                t.copy_(torch.randn(t.shape, generator=g).abs() * 0.3 + 0.5)
            elif name.endswith(("running_var", "bn.weight")):
                t.fill_(1.0)
            else:
                t.zero_()
    return layer.to(dev)


def _plain_f64(torch, layer, x):
    """``layer``'s plain form in f64 throughout (convs, unfolded BN, SiLU,
    residuals): the truth the deep layers' f32 results are held to."""
    import torch.nn.functional as F

    from tracklab_torch.models.yolox import BN_EPS

    def cba(m, x):
        y = F.conv2d(x, m.conv.weight.double(), None, m.conv.stride,
                     m.conv.padding, groups=m.conv.groups)
        bn, sh = m.bn, (1, -1, 1, 1)
        mul = (torch.rsqrt(bn.running_var.double() + BN_EPS)
               * bn.weight.double())
        return F.silu((y - bn.running_mean.double().view(sh)) * mul.view(sh)
                      + bn.bias.double().view(sh))

    x = x.double()
    a = cba(layer.conv1, x)
    for blk in layer.m:
        y = cba(blk.conv2, cba(blk.conv1, a))
        a = y + a if blk.use_add else y
    return cba(layer.conv3, torch.cat([a, cba(layer.conv2, x)], dim=1))


def _rel(got, want):
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


def _largest_tile(H, W, n, ch, ring):
    """The bf16 output tile with the most pixels (squarest on a tie) that
    fits with ``ring``: the simpler rule that choose_tile's cost model is
    timed against."""
    from tracklab_torch.kernels.csp import SMEM_LIMIT, smem_bytes

    best = None
    for th in range(1, H + 1):
        for tw in range(1, W + 1):
            if smem_bytes(th, tw, n, ch, ring) > SMEM_LIMIT:
                break
            key = (th * tw, -abs(th - tw))
            if best is None or key > best[0]:
                best = (key, (th, tw, ring))
    return best[1]


def phase_k3(torch, dev, time_batch):
    """f32: realistic weights, rel <= 1e-4 against the plain layer; at the
    CSP_COMPACT and CSP_STAGED layers (n = 9 and 12) f32 rounding compounds
    through the chain (BN folded in the kernel, not in the plain layer), so
    there the kernel is held to the f64 plain layer, no farther from it than
    the plain f32 layer is (x1.5). bf16:
    the main path's weights, rel <= 3e-2 against the plain bf16 layer, and
    no farther from the f32 plain layer than the plain bf16 layer is (x1.5).
    bf16 rounding compounds through the bottleneck chain, so how far two
    bf16 orders of rounding drift apart depends on the weights' gain and on
    the depth: the CSP_COMPACT and CSP_STAGED layers (n = 9 and 12, ch up
    to 640) are held to the f32 comparison only, and the compact ring (with
    the largest tile it fits) and the staged route to both checks at the
    nine other shapes. f32 (3xTF32) takes the staged route at every
    shape."""
    import ctypes

    from tracklab_torch.kernels import _build
    from tracklab_torch.kernels import csp as k3_mod
    from tracklab_torch.kernels.csp import (STAGED, choose_tile,
                                            fused_csplayer, smem_bytes)

    def with_plan(plan, fn):
        """fn() with fused_csplayer held to ``plan`` (th, tw, ring)."""
        k3_mod.choose_tile = lambda *a: plan
        try:
            return fn()
        finally:
            k3_mod.choose_tile = choose_tile

    cu_smem = _build.load("csp").tl_csp_smem_bytes
    cu_smem.argtypes = [ctypes.c_int] * 5
    cu_smem.restype = ctypes.c_longlong
    worst = {"f32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    rule_ms = {"cost model": [0.0, 0.0], "largest tile": [0.0, 0.0]}
    deep_ms = {}
    n_fit = len(CSP_SHAPES + CSP_RAGGED)
    for i, (name, hw, cin, cout, n, sc) in enumerate(
            CSP_SHAPES + CSP_RAGGED + CSP_COMPACT + CSP_STAGED):
        for th, tw, ring in ((5, 7, 0), (5, 7, 1)):
            check(cu_smem(th, tw, n, cout // 2, ring)
                  == smem_bytes(th, tw, n, cout // 2, ring),
                  f"K3 {name}: the kernel's shared memory differs from the "
                  "planner's")
        plans = {str(dt)[6:]: choose_tile(hw, hw, n, cin, cout // 2, cout, dt)
                 for dt in (torch.bfloat16, torch.float32)}
        staged = (hw, hw, STAGED)
        check(plans["float32"] == staged,
              f"K3 {name} f32: plan {plans['float32']}, not the staged route")
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(8 if i < n_fit else 2, cin, hw, hw, generator=g).to(
            dev).contiguous(memory_format=torch.channels_last)
        mk = partial(_seeded_csp, torch, cin, cout, n, sc, dev=dev, seed=i)
        l32 = mk(torch.float32, realistic=True)
        m32 = mk(torch.float32, realistic=False)
        m16 = mk(torch.bfloat16, realistic=False)
        with torch.no_grad():
            want32 = l32.forward_plain(x)
            got32 = fused_csplayer(l32, x)
            r32 = _rel(got32, want32)
            f32_note = f"f32 rel {r32:.3e} (tol 1e-4)"
            if i >= n_fit:
                want64 = _plain_f64(torch, l32, x)
                k64, p64 = _rel(got32, want64), _rel(want32, want64)
                f32_note = (f"f32 rel {r32:.3e}; to f64: kernel {k64:.3e}, "
                            f"plain f32 {p64:.3e} (tol x1.5)")
                del want64
            x16 = x.to(torch.bfloat16)
            got16, want16 = fused_csplayer(m16, x16), m16.forward_plain(x16)
            truth = m32.forward_plain(x)
            outs = {plans["bfloat16"]: got16}
            if i < n_fit:
                small = _largest_tile(hw, hw, n, cout // 2, 1)
                for plan in (small, staged):
                    outs[plan] = with_plan(plan,
                                           lambda: fused_csplayer(m16, x16))
        torch.cuda.synchronize()
        check(r32 <= 1e-4 if i < n_fit else k64 <= 1.5 * p64,
              f"K3 {name} f32: {f32_note}")
        worst["f32"] = max(worst["f32"], r32)
        p_truth = _rel(want16, truth)
        for plan, got in outs.items():
            check(got.shape == want16.shape == truth.shape,
                  f"K3 {name}: shape")
            r16, k_truth = _rel(got, want16), _rel(got, truth)
            err = (got.float() - want16.float()).abs()
            log(f"K3 {name} plans {plans if got is got16 else plan}: "
                f"{f32_note}; bf16 rel {r16:.3e} "
                f"(tol {'3e-2' if i < n_fit else 'none'}), max abs "
                f"{err.max().item():.3e}, mean abs {err.mean().item():.3e}; "
                f"vs f32: kernel {k_truth:.3e}, plain bf16 {p_truth:.3e}")
            check(i >= n_fit or r16 <= 3e-2,
                  f"K3 {name} {plan} bf16: rel {r16} > 3e-2")
            check(k_truth <= 1.5 * p_truth, f"K3 {name} {plan} bf16: "
                  f"{k_truth} from f32, plain bf16 {p_truth}")
            worst["bf16"] = max(worst["bf16"], r16)
            max_abs = max(max_abs, err.max().item())
        if i >= n_fit:   # the planner's route, the staged one and plain
            with torch.no_grad():
                k_ms = cuda_ms(lambda: fused_csplayer(m16, x16), 2, warmup=1)
                s_ms = with_plan(staged, lambda: cuda_ms(
                    lambda: fused_csplayer(m16, x16), 2, warmup=1))
                p_ms = cuda_ms(lambda: m16.forward_plain(x16), 2, warmup=1)
            route = ("staged" if plans["bfloat16"][2] == STAGED
                     else "compact ring")
            deep_ms[name] = dict(plan=route, ms=k_ms, staged_ms=s_ms,
                                 plain_ms=p_ms)
            log(f"K3 {name} bf16 batch 2: planner's route ({route}) "
                f"{k_ms:.3f} ms, staged route {s_ms:.3f} ms, plain "
                f"{p_ms:.3f} ms")
        if i >= len(CSP_SHAPES):
            continue

        # time at the main path's batch
        xb = torch.randn(time_batch, cin, hw, hw, generator=g).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            k_ms = cuda_ms(lambda: fused_csplayer(m16, xb), 3)
            p_ms = cuda_ms(lambda: m16.forward_plain(xb), 3)
        ch = cout // 2
        flops = 2 * hw * hw * ch * (2 * cin + 10 * n * ch + 2 * cout)
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["flops"] += flops * time_batch
        tot["bytes"] += time_batch * hw * hw * (cin + cout) * 2
        log(f"K3 {name} bf16 batch {time_batch}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, "
            f"{flops * time_batch / k_ms / 1e9:.1f} TFLOP/s")
        # the planner's cost model against the largest tile that fits, timed
        # cost, largest, largest, cost
        big = _largest_tile(hw, hw, n, ch, 0)
        order = [("cost model", plans["bfloat16"]), ("largest tile", big)]
        with torch.no_grad():
            for j, (rule, plan) in enumerate(order + order[::-1]):
                rule_ms[rule][j // 2] += with_plan(plan, lambda: cuda_ms(
                    lambda: fused_csplayer(m16, xb), 3))
        log(f"K3 {name} tiles: cost model {plans['bfloat16']}, largest "
            f"{big}")
    log(f"K3 tile rule, seven layers bf16 batch {time_batch} (two passes, "
        f"ms): {rule_ms}")
    b_ms, b_by = bound_ms(tot["bytes"], tot["flops"], PEAK["bf16"])
    log(f"K3 all seven layers, bf16 batch {time_batch}: kernel "
        f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); worst rel f32 {worst['f32']:.3e}, "
        f"bf16 {worst['bf16']:.3e}")
    return dict(name="K3 csp_fused", route="cuda",
                source="tracklab_torch/csrc/csp.cu",
                replaces="tracklab_tpu/ops/csp_pallas.py:130",
                max_abs_err=max_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                yolox_l_x_layers_batch2=deep_ms)


# ----------------------------------------------------------- phase 5: tracker
def synth_stream(seed, n_frames=200, n_obj=20, drop=0.15, fp_rate=0.5,
                 img=(1920, 1080)):
    """Linear-motion objects with noisy detections, dropouts and false
    positives; per frame an (N, 7) array [ltrb, conf, cls, ref]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([100, 100], [img[0] - 300, img[1] - 300], (n_obj, 2))
    vel = rng.uniform(-8, 8, (n_obj, 2))
    size = rng.uniform(40, 160, (n_obj, 2))
    frames, ref = [], 0
    for _ in range(n_frames):
        rows = []
        pos = pos + vel
        for k in range(n_obj):
            if rng.uniform() < drop:
                continue
            c = pos[k] + rng.normal(0, 2, 2)
            s = size[k] * rng.uniform(0.95, 1.05, 2)
            rows.append([c[0], c[1], c[0] + s[0], c[1] + s[1],
                         rng.uniform(0.2, 1.0), 1.0, ref])
            ref += 1
        for _ in range(rng.poisson(fp_rate)):
            c = rng.uniform([0, 0], [img[0] - 200, img[1] - 200])
            s = rng.uniform(30, 120, 2)
            rows.append([c[0], c[1], c[0] + s[0], c[1] + s[1],
                         rng.uniform(0.15, 0.9), 1.0, ref])
            ref += 1
        frames.append(np.array(rows, np.float64).reshape(-1, 7))
    return frames


def phase_tracker(torch, dev):
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.trackers.common import Detections, pad_detections
    from tracklab_torch.trackers.ocsort import OCSortConfig, ocsort_scan

    cfg = OCSortConfig(max_tracks=64, max_dets=32, det_thresh=0.45,
                       max_age=12, min_hits=2, iou_threshold=0.25)
    frames = synth_stream(0)
    per = [pad_detections(f[:, :4], f[:, 4], f[:, 5], f[:, 6].astype(int),
                          capacity=32, device="cpu") for f in frames]
    dets = Detections(*(torch.stack(x) for x in zip(*per)))
    before = solve_square_batched.launches
    t0 = time.perf_counter()
    _, out_g = ocsort_scan(cfg, Detections(*(x.to(dev) for x in dets)))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out_c = ocsort_scan(cfg, dets)
    t_cpu = time.perf_counter() - t0
    check(solve_square_batched.launches > before, "tracker never ran K1")
    check(torch.equal(out_g.valid.cpu(), out_c.valid),
          "tracker valid differs between cuda and cpu")
    v = out_c.valid
    check(torch.equal(out_g.track_id.cpu()[v], out_c.track_id[v]),
          "tracker ids differ between cuda and cpu")
    d = (out_g.ltrb.cpu()[v] - out_c.ltrb[v]).abs().max().item()
    check(d < 1e-3, f"tracker boxes differ by {d}")
    log(f"tracker: {len(frames)} frames, {int(v.sum())} emitted boxes, ids "
        f"identical cuda vs cpu (max box diff {d:.2e}); "
        f"{solve_square_batched.launches - before} K1 launches; "
        f"{t_gpu / len(frames) * 1e3:.2f} ms/frame on cuda, "
        f"{t_cpu / len(frames) * 1e3:.2f} ms/frame on cpu")


def _pad_videos(torch, streams, capacity, dev):
    """Per-video padded detections stacked to (V, F, D) on ``dev``."""
    from tracklab_torch.trackers.common import Detections, pad_detections

    vids = []
    for frames in streams:
        per = [pad_detections(f[:, :4], f[:, 4], f[:, 5],
                              f[:, 6].astype(int), capacity=capacity,
                              device="cpu") for f in frames]
        vids.append(Detections(*(torch.stack(x) for x in zip(*per))))
    return Detections(*(torch.stack(x).to(dev) for x in zip(*vids)))


def _same_tracks(torch, got, want, what):
    """valid and track ids equal, boxes within 1e-4; returns the largest
    box difference."""
    got = type(got)(*(None if x is None else x.cpu() for x in got))
    want = type(want)(*(None if x is None else x.cpu() for x in want))
    check(torch.equal(got.valid, want.valid), f"{what}: valid differs")
    v = want.valid
    check(torch.equal(got.track_id[v], want.track_id[v]),
          f"{what}: track ids differ")
    d = (got.ltrb[v] - want.ltrb[v]).abs().max().item() if v.any() else 0.0
    check(d <= 1e-4, f"{what}: boxes differ by {d}")
    return d


# ------------------------------------------------ phase 6: batched trackers
def phase_batched_trackers(torch, dev, n_videos=8, n_frames=60):
    """OC-SORT (both modes) and ByteTrack (batched) over a video axis on the
    card against each stream run alone through the single-video tracker on
    the card; one ByteTrack stream against the CPU."""
    from dataclasses import replace

    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.trackers.bytetrack import (ByteTrackConfig,
                                                   bytetrack_scan,
                                                   bytetrack_scan_videos)
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_scan,
                                                ocsort_scan_videos)

    streams = [synth_stream(10 + v, n_frames=n_frames, n_obj=20)
               for v in range(n_videos)]
    dets = _pad_videos(torch, streams, 64, dev)
    one = [Detections(*(x[v] for x in dets)) for v in range(n_videos)]
    runs = [("OC-SORT", OCSortConfig(max_tracks=128, max_dets=64),
             ocsort_scan, ocsort_scan_videos),
            ("ByteTrack", ByteTrackConfig(max_tracks=128, max_dets=64),
             bytetrack_scan, bytetrack_scan_videos)]
    for name, cfg, scan, scan_videos in runs:
        t0 = time.perf_counter()
        singles = [scan(cfg, d)[1] for d in one]
        torch.cuda.synchronize()
        log(f"{name} single video, default mode: "
            f"{(time.perf_counter() - t0) / n_videos / n_frames * 1e3:.2f} "
            "ms per frame step")
        modes = (True, False) if name == "OC-SORT" else (True,)
        for batched in modes:
            k1, k2 = solve_square_batched.launches, solve_rect_batched.launches
            t0 = time.perf_counter()
            _, out = scan_videos(replace(cfg, batched=batched), dets)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            k1 = solve_square_batched.launches - k1
            k2 = solve_rect_batched.launches - k2
            check(k2 > 0 if batched else k1 > 0,
                  f"{name} batched={batched}: no solve launched")
            d = max(_same_tracks(torch, type(out)(*(x[v] for x in out)),
                                 singles[v],
                                 f"{name} batched={batched} video {v}")
                    for v in range(n_videos))
            n_box = int(out.valid.sum())
            log(f"{name} batched={batched} over V={n_videos}: {n_box} boxes "
                f"equal {n_videos} single-video runs id for id (max box "
                f"diff {d:.2e}); K1 {k1}, K2 {k2} launches; "
                f"{dt / n_frames * 1e3:.2f} ms per frame step")
    cpu = bytetrack_scan(runs[1][1], Detections(*(x.cpu() for x in one[0])))
    _same_tracks(torch, singles[0], cpu[1], "ByteTrack cuda vs cpu")
    log("ByteTrack video 0: cuda equals cpu id for id")


# -------------------------------------------------------- phase 7: main path
def profile_window(torch, fn, n_frames, kernel=None):
    """Run ``fn`` under torch.profiler: host ms, device-busy ms (sum of
    kernel times) and kernel launches, each per frame, and the device's
    idle share of the window; with ``kernel``, also the device ms and
    launches per frame of the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    out = dict(host_ms_per_frame=wall_ms / n_frames,
               device_ms_per_frame=busy_us / 1e3 / n_frames,
               launches_per_frame=launches / n_frames,
               device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
               top_kernels_ms_per_frame=[
                   (e.key[:72], e.self_device_time_total / 1e3 / n_frames)
                   for e in kernels[:4]])
    if kernel is not None:
        mine = [e for e in kernels if kernel in e.key]
        n = sum(e.count for e in mine)
        us = sum(e.self_device_time_total for e in mine)
        out[kernel] = dict(ms_per_frame=us / 1e3 / n_frames,
                           launches_per_frame=n / n_frames,
                           ms_per_launch=us / 1e3 / n if n else 0.0)
    return out


def phase_main(torch, dev, n_chunks=4, chunk=128, size=640, oru=None):
    from tracklab_torch.engine.fused import (fused_detect_track,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.oru_replay import oru_replay
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_step)

    cfg = OCSortConfig(max_tracks=64, max_dets=32, min_hits=1)
    model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev).randomize_(0)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    noise = torch.randint(0, 20, (F, size, size, 3), generator=g,
                          device=dev, dtype=torch.uint8)
    video = base + noise
    del noise

    # calibrate the score threshold to ~20 detections on frame 0
    cal = make_yolox_detect_fn(model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"main path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(model, conf_threshold=conf, max_dets=32,
                                  compute_dtype=torch.bfloat16)
    step = partial(ocsort_step, cfg)

    # warm-up on one chunk, counting host syncs
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                           video[:chunk], chunk, return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    syncs_per_frame = syncs / chunk

    solve_square_batched.launches = 0
    fused_csplayer.launches = 0
    oru_replay.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, out = fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                                   video, chunk, return_detections=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K3": fused_csplayer.launches, "ORU": oru_replay.launches}
    fps = F / dt
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"main path: {F} frames in {dt:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.3f} host syncs/frame (warm-up chunk)")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the main path")
    check(launches["ORU"] == F, f"ORU replay launches {launches['ORU']} != "
          "one per frame")
    check(syncs == 0, f"main path: {syncs} host syncs in the warm-up chunk")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")

    # where the time goes: the detector on one chunk, then PROFILED_STEPS
    # tracker steps on its detections under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = detect(video[:chunk])
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3
    frames = [Detections(*(x[f] for x in dets))
              for f in range(min(PROFILED_STEPS, chunk))]
    init = ocsort_init(cfg, device=dev)

    def track():
        st = init
        for d in frames:
            st, _ = step(st, d)

    track()
    k1 = solve_square_batched.launches
    trk = profile_window(torch, track, len(frames), kernel="jv_warp")
    k1 = (solve_square_batched.launches - k1) / len(frames)
    mine = trk["jv_warp"]
    check(mine["launches_per_frame"] == k1,
          f"profiled K1 launches {mine['launches_per_frame']} per frame != "
          f"the wrapper's {k1}")
    log(f"main path split: detector {det_ms:.1f} ms per chunk of {chunk} "
        f"({det_ms / chunk:.3f} ms/frame); tracker {trk}; K1 on the path: "
        f"{mine['ms_per_launch']:.4f} ms per launch, "
        f"{mine['launches_per_frame']:.2f} launches and "
        f"{mine['ms_per_frame']:.4f} ms per frame")
    k1_path = _k1_on_path(torch, step, init,
                          [Detections(*(x[f] for x in dets))
                           for f in range(chunk)], oru=oru)
    return launches, dict(fps=fps, syncs_per_frame=syncs_per_frame,
                          tracks_per_frame=per_frame,
                          detector_ms_per_frame=det_ms / chunk,
                          tracker=trk, k1_path=k1_path)


def _keep_oru(store, args, n_keep=32):
    """Keep a copy of one ORU replay call's inputs in ``store`` when a slot
    replays (the last ``n_keep``), or in ``store["idle"]`` (the last 4)."""
    ins = tuple(t.clone() for t in args)
    key = "replay" if bool(ins[5].any()) else "idle"
    store.setdefault(key, []).append(ins)
    del store[key][:-(n_keep if key == "replay" else 4)]


def _k1_on_path(torch, step, init, frames, n_keep=48, oru=None,
                what="the main path"):
    """A second, untimed pass of the main path's tracker over ``frames``
    that records every K1 input (cost, k_eff, active). Reports the share
    of launches that solve (a problem active with k_eff > 0; the others
    leave at once behind the fast paths) and their mean path steps, checks
    the last ``n_keep`` solving launches and ten that do not solve against
    the plain version, and times the kept solving launches. ``oru``, a
    dict, receives the pass's ORU replay inputs (:func:`_keep_oru`)."""
    import tracklab_torch.ops.assignment as A
    from tracklab_torch.kernels.jv import (_solve_square_plain,
                                           solve_square_batched)
    from tracklab_torch.ops.kalman import XYSRFilter

    inputs = []
    replay = XYSRFilter.oru_replay_batch

    def record_k1(cost, k_eff, active):
        inputs.append((cost.clone(), k_eff.clone(), active.clone()))
        return solve_square_batched(cost, k_eff, active)

    def record_oru(*args):
        if oru is not None:
            _keep_oru(oru, args)
        return replay(*args)

    A.solve_square_batched = record_k1
    XYSRFilter.oru_replay_batch = staticmethod(record_oru)
    try:
        st = init
        for d in frames:
            st, _ = step(st, d)
    finally:
        A.solve_square_batched = solve_square_batched
        XYSRFilter.oru_replay_batch = staticmethod(replay)
    torch.cuda.synchronize()
    solves = [bool((a & (k > 0)).any()) for _, k, a in inputs]
    solving = [x for x, s in zip(inputs, solves) if s]
    idle = [x for x, s in zip(inputs, solves) if not s][-10:]
    kept = solving[-n_keep:]
    steps = []
    for c, k, a in kept + idle:
        want = torch.full((c.shape[0], c.shape[1]), -1, dtype=torch.int32)
        stats = {}
        for b, (kb, ab) in enumerate(zip(k.tolist(), a.tolist())):
            if ab and kb > 0:
                want[b, :kb] = _solve_square_plain(c[b, :kb, :kb].cpu(),
                                                   stats)
        check(torch.equal(solve_square_batched(c, k, a).cpu(), want),
              f"K1 differs from its plain version on an input of {what}")
        steps.append(stats.get("steps", 0))
    n_steps = sum(steps[:len(kept)])

    def run_kept():
        for c, k, a in kept:
            solve_square_batched(c, k, a)

    ms = cuda_ms(run_kept, 20) / max(len(kept), 1)
    out = dict(launches=len(inputs), solving_share=len(solving)
               / max(len(inputs), 1),
               steps_per_solving_launch=n_steps / max(len(kept), 1),
               ms_per_solving_launch=ms,
               ns_per_step=ms * len(kept) * 1e6 / max(n_steps, 1),
               shape=list(inputs[-1][0].shape) if inputs else None)
    log(f"K1 on {what}'s own inputs ({len(frames)} tracker steps): "
        f"{len(inputs)} launches, {len(solving)} solve "
        f"({out['solving_share']:.3f}); the last {len(kept)} solving and "
        f"{len(idle)} idle launches identical to the plain version; "
        f"{out['steps_per_solving_launch']:.1f} path steps and "
        f"{ms:.4f} ms per solving launch, {out['ns_per_step']:.1f} ns per "
        f"step")
    return out


# ---------------------------------------------------- phase 8: multi-video
def phase_videos(torch, dev, n_videos=8, n_frames=128, size=640,
                 max_dets=64, min_confidence=0.4, oru=None):
    """The multi-video path: V videos of uint8 frames -> YOLOX-s 640 bf16
    -> NMS -> per-video padded Detections (V, F, D) -> OC-SORT with
    ``batched=True`` stepping all V videos at once (one K2 launch per
    association stage)."""
    from tracklab_torch.engine.fused import make_yolox_detect_fn
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.kernels.oru_replay import oru_replay
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.common import Detections, repeat_state
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_scan_videos,
                                                ocsort_step)

    cfg = OCSortConfig(batched=True, max_tracks=128, max_dets=max_dets)
    model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev).randomize_(0)
    videos = []
    for v in range(n_videos):
        g = torch.Generator(device=dev).manual_seed(100 + v)
        base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                             device=dev, dtype=torch.uint8)
        videos.append(base + torch.randint(0, 20, (n_frames, size, size, 3),
                                           generator=g, device=dev,
                                           dtype=torch.uint8))

    cal = make_yolox_detect_fn(model, conf_threshold=0.3, max_dets=max_dets,
                               compute_dtype=torch.bfloat16)(videos[0])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    detect = make_yolox_detect_fn(model, conf_threshold=conf,
                                  max_dets=max_dets,
                                  compute_dtype=torch.bfloat16)
    log(f"multi-video: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")

    def detect_all():
        per = [detect(video) for video in videos]      # one chunk each
        d = Detections(*(torch.stack(x) for x in zip(*per)))
        # the tracker wrapper's min_confidence pre-filter, as a mask
        return d._replace(valid=d.valid & (d.conf > min_confidence))

    # warm-up on 16 frames, counting host syncs per frame step
    n_prof = min(16, n_frames)
    warm = Detections(*(x[:, :n_prof] for x in detect_all()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ocsort_scan_videos(cfg, warm)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught) / n_prof

    solve_square_batched.launches = 0
    solve_rect_batched.launches = 0
    fused_csplayer.launches = 0
    oru_replay.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = detect_all()
    torch.cuda.synchronize()
    t_det = time.perf_counter() - t0
    _, out = ocsort_scan_videos(cfg, dets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K2": solve_rect_batched.launches,
                "K3": fused_csplayer.launches, "ORU": oru_replay.launches}
    F = n_frames
    fps = n_videos * F / wall
    trk_ms = (wall - t_det) / F * 1e3
    per_frame = out.valid.sum(-1).float().mean().item()
    log(f"multi-video: {n_videos} videos x {F} frames in {wall:.3f} s = "
        f"{fps:.2f} frames/s; detector {t_det * 1e3:.1f} ms; tracker "
        f"{trk_ms:.2f} ms per frame step ({n_videos} videos); launches "
        f"{launches} ({launches['K2'] / F:.2f} K2 per step); {syncs:.3f} "
        f"host syncs per step; {per_frame:.2f} tracks per frame")
    check(launches["K2"] > 0, "K2 never launched on the multi-video path")
    check(launches["ORU"] == F, f"ORU replay launches {launches['ORU']} != "
          "one per step")
    check(syncs == 0, f"multi-video path: {syncs} host syncs per step")
    check(launches["K3"] == 7 * n_videos,
          f"K3 launches {launches['K3']} != 7 per video chunk")
    check(out.valid.shape == (n_videos, F, cfg.max_tracks), "output shape")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")

    # device idle share of PROFILED_STEPS tracker steps under the profiler
    frames = [Detections(*(x[:, f] for x in dets))
              for f in range(min(PROFILED_STEPS, n_prof))]
    init = repeat_state(ocsort_init(cfg, device=dev), n_videos)

    def track():
        st = init
        for d in frames:
            st, _ = ocsort_step(cfg, st, d)

    track()
    trk = profile_window(torch, track, len(frames))
    log(f"multi-video tracker steps (V={n_videos}): {trk}")
    # K2 checked and timed on the path's last 4 launches (8 until the depth
    # cut for the room of phase posetrack)
    k2, trips, k2_steps = _k2_on_path(torch, cfg, dets, n_keep=4, oru=oru)
    return launches, k2, dict(fps=fps, videos=n_videos, frames_per_video=F,
                          k2_path=k2_steps,
                          detector_ms_per_video_chunk=t_det * 1e3
                          / n_videos,
                          tracker_ms_per_step=trk_ms,
                          k2_launches_per_step=launches["K2"] / F,
                          syncs_per_step=syncs,
                          tracks_per_frame=per_frame, tracker=trk,
                          oru_replay_trips_per_step=dict(
                              mean=sum(trips) / len(trips), max=max(trips)))


def _k2_on_path(torch, cfg, dets, n_keep=8, oru=None):
    """A second, untimed pass of the multi-video tracker that records the
    ORU replay's trip count per step (its largest gap) and inputs (into the
    dict ``oru``, :func:`_keep_oru`) and keeps the last ``n_keep`` K2
    inputs; K2 is then checked against its plain version and timed on
    those inputs, the problems the path gives it."""
    import tracklab_torch.ops.assignment as A
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)
    from tracklab_torch.ops.kalman import XYSRFilter
    from tracklab_torch.trackers.ocsort import ocsort_scan_videos

    replay = XYSRFilter.oru_replay_batch
    trips, inputs = [], []

    def record_replay(x, P, z_prev, z_new, gap, need):
        trips.append(int(torch.where(need, gap, 0).max()))
        if oru is not None:
            _keep_oru(oru, (x, P, z_prev, z_new, gap, need))
        return replay(x, P, z_prev, z_new, gap, need)

    def record_k2(cost, active=None):
        inputs.append((cost, active))
        del inputs[:-n_keep]
        return solve_rect_batched(cost, active)

    XYSRFilter.oru_replay_batch = staticmethod(record_replay)
    A.solve_rect_batched = record_k2
    try:
        ocsort_scan_videos(cfg, dets)
    finally:
        XYSRFilter.oru_replay_batch = staticmethod(replay)
        A.solve_rect_batched = solve_rect_batched
    torch.cuda.synchronize()
    for c, a in inputs:
        check(torch.equal(solve_rect_batched(c, a),
                          solve_rect_batched_plain(c, a)),
              "K2 differs from its plain version on a path input")

    def run_all():
        for c, a in inputs:
            solve_rect_batched(c, a)

    ms = cuda_ms(run_all, 20) / len(inputs)
    t_plain = 0.0
    for c, a in inputs[-2:]:          # the last step's two stages
        t_plain += cuda_ms(lambda: solve_rect_batched_plain(c, a), 1,
                           warmup=0)
    per = [_steps_per_problem(torch, c, a) for c, a in inputs]
    steps = sum(map(sum, per)) / len(inputs)
    longest = sum(max(s, default=0) for s in per) / len(inputs)
    V, R, C = inputs[-1][0].shape
    b_ms, b_by = bound_ms(V * R * C * 4 + V * C * 4, steps * 6 * C,
                          PEAK["f32"])
    log(f"K2 on the multi-video path's own problems ({len(inputs)} launches "
        f"of {(V, R, C)}, identical to the plain version): kernel {ms:.4f} ms"
        f" per launch, plain {t_plain / 2:.3f} ms, bound {b_ms:.6f} ms "
        f"({b_by}), {steps:.1f} path steps per launch, {longest:.1f} in its "
        f"longest problem: {ms * 1e6 / longest:.1f} ns per step; ORU replay "
        f"trips per step: mean {sum(trips) / len(trips):.2f}, max "
        f"{max(trips)}")
    return dict(name="K2 jv_rect_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv_rect.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:302",
                max_abs_err=0.0, ms=ms, plain_ms=t_plain / 2, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), trips, dict(
                    steps_per_launch=steps,
                    longest_problem_steps_per_launch=longest,
                    ns_per_step=ms * 1e6 / longest)


# ---------------------------------------------------------------- phase 9: K4
K4_SHAPES = [((384, 193, 12, 64), None), ((8, 256, 12, 64), 193),
             ((5, 37, 3, 64), None), ((2, 193, 12, 64), 100)]
# the attention of the command line's f32 KPR as phase posetrack (c)
# records it
K4_F32_SHAPE = (512, 193, 12, 64)


def _packed_qkv(torch, shape, dtype, dev, seed):
    """q, k, v as the (B, N, H, Dh) views of one packed (B, N, 3, H, Dh)
    tensor, as the ViT's qkv projection gives them."""
    B, N, H, Dh = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g).to(dev, dtype)
    return qkv.unbind(2)


def _check_k4(torch, q, k, v, n_valid, what, softmax="f32"):
    """K4 in the ``softmax`` mode against that mode's plain version on the
    same inputs: f32 within 1e-5 abs; bf16 within 2e-2 of the output's
    scale and no farther from the f32 plain result than the plain bf16
    version is (x1.5). Returns the largest absolute difference from the
    plain version."""
    from tracklab_torch.kernels.vit_attention import (
        vit_attention, vit_attention_compute_plain, vit_attention_plain)

    plain = (vit_attention_compute_plain if softmax == "compute"
             else vit_attention_plain)
    got = vit_attention(q, k, v, n_valid, softmax=softmax)
    want = plain(q, k, v, n_valid)
    what = f"{what} softmax={softmax}"
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"K4 {what}: shape or dtype")
    err = (got.float() - want.float()).abs().max().item()
    if q.dtype == torch.float32:
        log(f"K4 {what} f32: max abs err {err:.3e} (tol 1e-5)")
        check(err <= 1e-5, f"K4 {what} f32: max abs err {err} > 1e-5")
        return err
    scale = want.float().abs().max().item()
    truth = vit_attention_plain(q.float(), k.float(), v.float(), n_valid)
    k_truth = (got.float() - truth).abs().max().item()
    p_truth = (want.float() - truth).abs().max().item()
    log(f"K4 {what} bf16: max abs err {err:.3e} = {err / scale:.3e} of "
        f"the output's scale (tol 2e-2); vs f32: kernel {k_truth:.3e}, "
        f"plain bf16 {p_truth:.3e}")
    check(err <= 2e-2 * scale, f"K4 {what} bf16: err {err} > 2e-2 * {scale}")
    check(k_truth <= 1.5 * p_truth,
          f"K4 {what} bf16: {k_truth} from f32, plain bf16 {p_truth}")
    return err


def _k4_bound(torch, q):
    B, N, H, Dh = q.shape
    return bound_ms(4 * B * N * H * Dh * q.element_size(),
                    4 * B * H * N * N * Dh, PEAK["bf16"])


def phase_k4(torch, dev):
    import ctypes

    from tracklab_torch.kernels import _build
    from tracklab_torch.kernels.vit_attention import (
        MAX_HEAD_DIM, f32_smem_bytes, vit_attention,
        vit_attention_compute_plain, vit_attention_plain)

    # route()'s plan of the f32 kernel's shared memory against the kernel's
    # own, at every Dh and at N of K4_SHAPES and the route's edge (N = 256,
    # where Dh > 112 does not fit); 0 on the C side where route() raises
    cu_smem = _build.load("vit_attention").tl_vit_attention_f32_smem_bytes
    cu_smem.argtypes = [ctypes.c_int] * 2
    cu_smem.restype = ctypes.c_longlong
    for N in sorted({s[0][1] for s in K4_SHAPES} | {256}):
        for Dh in range(1, MAX_HEAD_DIM + 1):
            check(cu_smem(N, Dh) == (f32_smem_bytes(N, Dh) or 0),
                  f"K4 f32 at N={N}, Dh={Dh}: the kernel's shared memory "
                  f"{cu_smem(N, Dh)}, route()'s {f32_smem_bytes(N, Dh)}")
    check(f32_smem_bytes(256, 112) and not f32_smem_bytes(256, 120),
          "K4 f32: the route's edge moved from N = 256, Dh = 112")
    log("K4 f32 shared memory: route()'s plan equals the kernel's at N in "
        f"{sorted({s[0][1] for s in K4_SHAPES} | {256})}, Dh 1.."
        f"{MAX_HEAD_DIM}")

    max_abs = 0.0
    for i, (shape, n_valid) in enumerate(K4_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _packed_qkv(torch, shape, dtype, dev, seed=40 + i)
            for softmax in ("f32", "compute"):
                err = _check_k4(torch, q, k, v, n_valid,
                                f"{shape} n_valid={n_valid}", softmax)
                if dtype == torch.bfloat16:
                    max_abs = max(max_abs, err)
    q, k, v = _packed_qkv(torch, K4_SHAPES[0][0], torch.bfloat16, dev, 40)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    with torch.no_grad():
        ms = cuda_ms(lambda: vit_attention(q, k, v), 20)
        cd_ms = cuda_ms(lambda: vit_attention(q, k, v, softmax="compute"),
                        20)
        plain_ms = cuda_ms(lambda: vit_attention_plain(q, k, v), 5)
        cd_plain_ms = cuda_ms(lambda: vit_attention_compute_plain(q, k, v),
                              5)
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt), 20)
    b_ms, b_by = _k4_bound(torch, q)
    log(f"K4 timing at {tuple(q.shape)} bf16: kernel {ms:.4f} ms (f32 "
        f"softmax), {cd_ms:.4f} ms (compute-dtype softmax); plain "
        f"{plain_ms:.4f} / {cd_plain_ms:.4f} ms, SDPA (yardstick) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # f32 (3xTF32) at the command line's KPR shape, beside its plain version
    # and SDPA in f32 (TF32 off, as main() sets it)
    q, k, v = _packed_qkv(torch, K4_F32_SHAPE, torch.float32, dev, 41)
    f_err = _check_k4(torch, q, k, v, None, f"{K4_F32_SHAPE} n_valid=None")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    with torch.no_grad():
        f_ms = cuda_ms(lambda: vit_attention(q, k, v), 10)
        f_plain = cuda_ms(lambda: vit_attention_plain(q, k, v), 3)
        f_lib = cuda_ms(lambda: sdpa(qt, kt, vt), 10)
    B, N, H, Dh = q.shape
    fb_ms, fb_by, fb_term = bound_ms_f32(4 * B * N * H * Dh * 4,
                                         4 * B * H * N * N * Dh)
    log(f"K4 timing at {K4_F32_SHAPE} f32 (3xTF32): kernel {f_ms:.4f} ms, "
        f"plain {f_plain:.4f} ms, SDPA f32 (TF32 off, yardstick) "
        f"{f_lib:.4f} ms, bound {fb_ms:.4f} ms ({fb_by}; operations at the "
        f"{fb_term} rate)")
    check(f_ms < f_plain, f"K4 f32: kernel {f_ms} ms, plain {f_plain} ms")
    return dict(name="K4 vit_attention", route="cuda",
                source="tracklab_torch/csrc/vit_attention.cu",
                replaces="tracklab_tpu/ops/vit_attention_pallas.py:91",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                compute_softmax=dict(ms=cd_ms, plain_ms=cd_plain_ms),
                f32=dict(shape=list(K4_F32_SHAPE), max_abs_err=f_err,
                         ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                         bound_ms=fb_ms, bound_by=fb_by,
                         bound_term=fb_term))


# ------------------------------------------------------ phase 10: KPR model
def _plain_attention():
    """K4's plain version by softmax mode, with the wrapper's signature."""
    from tracklab_torch.kernels.vit_attention import (
        vit_attention_compute_plain, vit_attention_plain)

    def attention(q, k, v, n_valid=None, softmax="f32"):
        plain = (vit_attention_compute_plain if softmax == "compute"
                 else vit_attention_plain)
        return plain(q, k, v, n_valid)

    return attention


def phase_kpr(torch, dev, batch=64):
    """The ViT-B KPR (bf16, erfpoly GELU, seeded weights) at batch 64 on the
    card once per attn_impl name, through K4 in the name's softmax mode and
    through that mode's plain version (the CPU form, on the card):
    embeddings within 5e-2 of their scale (bf16 rounding compounds over 12
    layers), and the flipped binary visibility bits counted."""
    import tracklab_torch.models.kpr as kpr_mod
    from tracklab_torch.kernels.vit_attention import vit_attention
    from tracklab_torch.models.kpr import (ATTN_IMPLS, KPR,
                                           extract_test_embeddings)

    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((batch, 384, 128, 3), generator=g).to(dev, torch.bfloat16)
    prompts = torch.zeros((batch, 384, 128, 7), dtype=torch.bfloat16,
                          device=dev)
    stats = {}
    for impl in ATTN_IMPLS:
        model = KPR(dtype=torch.bfloat16, gelu="erfpoly", attn_impl=impl,
                    device=dev).randomize_(3)
        before = vit_attention.launches
        out_k = model(x, prompts)
        check(vit_attention.launches - before == 12,
              f"KPR {impl} did not launch K4 once per layer")
        kpr_mod.vit_attention = _plain_attention()
        try:
            out_p = model(x, prompts)
        finally:
            kpr_mod.vit_attention = vit_attention
        torch.cuda.synchronize()
        (ek, vk), (ep, vp) = (extract_test_embeddings(o)
                              for o in (out_k, out_p))
        check(ek.shape == (batch, 6, 512) and torch.isfinite(ek.float())
              .all().item(), f"KPR {impl} embeddings: shape or non-finite")
        scale = ep.float().abs().max().item()
        err = (ek.float() - ep.float()).abs().max().item()
        flips = int((vk != vp).sum())
        mode = model.backbone.blocks[0].attn.softmax
        log(f"KPR ViT-B bf16 attn_impl={impl} ({mode} softmax) at batch "
            f"{batch}: embeddings K4 vs plain max abs {err:.3e} = "
            f"{err / scale:.3e} of scale (tol 5e-2); {flips} of "
            f"{vk.numel()} binary visibility bits flipped; visible share "
            f"{vk.float().mean().item():.3f}")
        check(err <= 5e-2 * scale, f"KPR {impl} embeddings differ by {err} "
              f"(scale {scale})")
        stats[impl] = dict(softmax=mode, max_abs=err, scale=scale,
                           flipped_visibility=flips,
                           visibility_bits=vk.numel())
        del model, out_k, out_p
    return stats


# ------------------------------------------------- phase 11: BPBReID tracker
def synth_parts_stream(seed, n_frames=40, n_obj=20, D=32, P=6, E=512,
                       K=17, img=(1920, 1080)):
    """Objects in linear motion with part features (a base per object plus
    noise), visibilities, keypoints and 15 % dropouts, as
    tests/test_bpbreid_oks.py builds them, in (F, D) padded numpy arrays."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_obj, P, E))
    pos = rng.uniform([100, 100], [img[0] - 300, img[1] - 300], (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    size = rng.uniform(40, 160, (n_obj, 2))
    ltrb = np.zeros((n_frames, D, 4), np.float32)
    conf = np.zeros((n_frames, D), np.float32)
    valid = np.zeros((n_frames, D), bool)
    feat = np.zeros((n_frames, D, P, E), np.float32)
    vis = np.zeros((n_frames, D, P), np.float32)
    kps = np.zeros((n_frames, D, K, 3), np.float32)
    for f in range(n_frames):
        pos = pos + vel
        slot = 0
        for k in range(n_obj):
            if rng.uniform() < 0.15 or slot == D:
                continue
            c = pos[k] + rng.normal(0, 2, 2)
            ltrb[f, slot] = [c[0], c[1], c[0] + size[k, 0],
                             c[1] + size[k, 1]]
            conf[f, slot] = rng.uniform(0.5, 1.0)
            valid[f, slot] = True
            feat[f, slot] = base[k] + rng.normal(0, 0.05, (P, E))
            vis[f, slot] = rng.uniform(size=P) < 0.8
            kps[f, slot, :, 0] = c[0] + np.linspace(5, size[k, 0] - 5, K)
            kps[f, slot, :, 1] = c[1] + np.linspace(10, size[k, 1] - 10, K)
            kps[f, slot, :, 2] = 1.0
            slot += 1
    return ltrb, conf, valid, feat, vis, kps


def _parts_inputs(torch, arrays, dev):
    from tracklab_torch.trackers.common import Detections

    ltrb, conf, valid, feat, vis, kps = (torch.from_numpy(a).to(dev)
                                         for a in arrays)
    lead = conf.shape
    D = lead[-1]
    dets = Detections(ltrb, conf, torch.ones_like(conf),
                      torch.arange(D, dtype=torch.int32,
                                   device=dev).expand(lead).contiguous(),
                      valid)
    return dets, feat, vis, kps


def phase_bpbreid(torch, dev, n_videos=8, n_frames=40):
    """BPBReID-StrongSORT (64 tracks, 32 dets, 6 parts x 512) on the card
    against the CPU for one stream, id for id, with IoU and OKS motion and
    the bot_sort strategy; then V = 8 streams over the video axis in both
    modes against 8 single-video runs on the card."""
    from dataclasses import replace

    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.trackers.bpbreid_strongsort import (
        BPBReIDStrongSortConfig, bpbreid_scan, bpbreid_scan_videos)
    from tracklab_torch.trackers.common import Detections

    cfg = BPBReIDStrongSortConfig(n_parts=6, embed_dim=512, n_init=1,
                                  max_tracks=64, max_dets=32)
    streams = [synth_parts_stream(60 + v, n_frames) for v in range(n_videos)]
    one = [_parts_inputs(torch, s, dev) for s in streams]
    k1 = solve_square_batched.launches
    t0 = time.perf_counter()
    singles = [bpbreid_scan(cfg, *x)[1] for x in one]
    torch.cuda.synchronize()
    t_single = (time.perf_counter() - t0) / n_videos / n_frames
    k1 = solve_square_batched.launches - k1
    check(k1 > 0, "BPBReID never launched K1")
    log(f"BPBReID single video: {t_single * 1e3:.2f} ms per frame step on "
        f"cuda; {k1} K1 launches over {n_videos} x {n_frames} steps")
    cpu_in = _parts_inputs(torch, streams[0], "cpu")
    for kw in ({}, {"motion_criterium": "oks"},
               {"matching_strategy": "bot_sort"}):
        c = replace(cfg, **kw)
        got = singles[0] if not kw else bpbreid_scan(c, *one[0])[1]
        cpu = bpbreid_scan(c, *cpu_in)[1]
        d = _same_tracks(torch, got, cpu, f"BPBReID {kw} cuda vs cpu")
        log(f"BPBReID {kw or 'iou, strong_sort'} video 0: cuda equals cpu "
            f"id for id ({int(cpu.valid.sum())} boxes, max box diff "
            f"{d:.2e})")
    dets = Detections(*(torch.stack(x) for x in zip(*(o[0] for o in one))))
    feats = [torch.stack(x) for x in list(zip(*one))[1:]]
    for batched in (False, True):
        k2 = solve_rect_batched.launches
        t0 = time.perf_counter()
        _, out = bpbreid_scan_videos(replace(cfg, batched=batched), dets,
                                     *feats)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_frames
        k2 = solve_rect_batched.launches - k2
        check(not batched or k2 > 0, "batched mode never ran K2")
        d = max(_same_tracks(torch, type(out)(*(None if x is None else x[v]
                                                for x in out)),
                             singles[v], f"BPBReID batched={batched} "
                             f"video {v}") for v in range(n_videos))
        log(f"BPBReID batched={batched} over V={n_videos}: "
            f"{int(out.valid.sum())} boxes equal {n_videos} single-video "
            f"runs id for id (max box diff {d:.2e}); {k2} K2 launches; "
            f"{dt * 1e3:.2f} ms per frame step")


def _embed_both_ways(torch, detect, embed, video, chunk, buckets, timed):
    """The live count of every chunk's detections and the bucket it would
    take; then the embed stage timed at full width and bucketed on the
    chunk with the fewest live slots (where the buckets save the most)."""
    from tracklab_torch.engine.fused import _bucketed_embed

    dets = [detect(video[b:b + chunk])
            for b in range(0, video.shape[0], chunk)]
    lives = [int(d.valid.sum(1).max()) for d in dets]
    i = min(range(len(lives)), key=lives.__getitem__)
    frames, d = video[i * chunk:(i + 1) * chunk], dets[i]
    embed(frames, d.ltrb)
    _, full_ms = timed(lambda: embed(frames, d.ltrb))
    _, bucket_ms = timed(lambda: _bucketed_embed(embed, frames, d.ltrb,
                                                 d.valid, buckets))
    return dict(live_per_chunk=lives,
                bucket_per_chunk=[next(b for b in buckets if b >= n)
                                  for n in lives],
                fewest_live_chunk=i, full_ms=full_ms, bucketed_ms=bucket_ms)


# -------------------------------------------------- phase 12: the parts path
def phase_parts(torch, dev, n_chunks=8, chunk=16, size=640):
    """uint8 frames -> YOLOX-s 640 bf16 -> NMS (~20 detections per frame,
    32 slots) -> device crops -> KPR ViT-B bf16 part features over every
    slot (full width: no host sync) -> BPBReID-StrongSORT (min_confidence
    0.4), as bench.py's detect_parts_track; KPR also timed with the buckets
    (24, 32), which read the live count on the host."""
    import tracklab_torch.models.kpr as kpr_mod
    from tracklab_torch.engine.fused import (_bucketed_embed,
                                             fused_detect_parts_track,
                                             make_kpr_embed_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.kernels.vit_attention import vit_attention
    from tracklab_torch.models.kpr import KPR
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.bpbreid_strongsort import (
        BPBReIDStrongSortConfig, bpbreid_init, bpbreid_step)

    cfg = BPBReIDStrongSortConfig(motion_criterium="iou", n_parts=6,
                                  embed_dim=512, n_init=1, max_tracks=64,
                                  max_dets=32)
    det_model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                      device=dev).randomize_(0)
    kpr = KPR(dtype=torch.bfloat16, gelu="erfpoly", device=dev).randomize_(3)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    video = base + torch.randint(0, 20, (F, size, size, 3), generator=g,
                                 device=dev, dtype=torch.uint8)

    cal = make_yolox_detect_fn(det_model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"parts path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(det_model, conf_threshold=conf,
                                  max_dets=32, compute_dtype=torch.bfloat16)
    embed = make_kpr_embed_fn(kpr, crop_size=(384, 128), n_prompt_ch=7,
                              compute_dtype=torch.bfloat16)
    step = partial(bpbreid_step, cfg)
    run = partial(fused_detect_parts_track, detect, embed, chunk=chunk,
                  min_confidence=0.4, n_parts=6, embed_dim=512,
                  n_keypoints=17, return_detections=False)

    # warm-up on the first chunk, which records its tracker inputs, then
    # the second chunk with its host syncs counted
    inputs = []

    def rec_step(st, x):
        inputs.append(x)
        return step(st, x)

    run(step_fn=rec_step, init_state=bpbreid_init(cfg, device=dev),
        frames=video[:chunk])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(step_fn=step, init_state=bpbreid_init(cfg, device=dev),
            frames=video[chunk:2 * chunk])
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs_per_frame = sum("synchroniz" in str(w.message)
                          for w in caught) / chunk

    for fn in (solve_square_batched, solve_rect_batched, fused_csplayer,
               vit_attention):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, _, out = run(step_fn=step,
                          init_state=bpbreid_init(cfg, device=dev),
                          frames=video)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K2": solve_rect_batched.launches,
                "K3": fused_csplayer.launches, "K4": vit_attention.launches}
    fps = F / wall
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"parts path: {F} frames in {wall:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.3f} host syncs/frame (second chunk)")
    check(syncs_per_frame == 0,
          f"parts path: {syncs_per_frame} host syncs per frame")
    check(launches["K4"] == 12 * n_chunks,
          f"K4 launches {launches['K4']} != 12 per chunk")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the parts path")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")

    # where the time goes, on the first chunk: detector, KPR (K4 inside it
    # from the profiler), then the 16 recorded tracker steps
    frames = video[:chunk]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    dets, det_ms = timed(lambda: detect(frames))
    kpr_call = partial(embed, frames, dets.ltrb)
    _, kpr_ms = timed(kpr_call)
    _, kpr_bucket_ms = timed(partial(_bucketed_embed, embed, frames,
                                     dets.ltrb, dets.valid, (24, 32)))
    k4_ms, kpr_top = _kernel_ms_in(torch, kpr_call, "vit_attention")
    both = _embed_both_ways(torch, detect, embed, video, chunk, (24, 32),
                            timed)
    log(f"parts path KPR per chunk, full width against the buckets (24, "
        f"32): {both}")
    init = bpbreid_init(cfg, device=dev)

    def track(frames=inputs):
        st = init
        for x in frames:
            st, _ = step(st, x)

    track()
    _, trk_ms = timed(track)
    prof = inputs[:PROFILED_STEPS]
    trk = profile_window(torch, lambda: track(prof), len(prof))
    log(f"parts path split (chunk of {chunk}): detector {det_ms:.1f} ms, "
        f"KPR {kpr_ms:.1f} ms at full width (K4 {k4_ms:.2f} ms of it; "
        f"{kpr_bucket_ms:.1f} ms with the buckets (24, 32), "
        f"{int(dets.valid.sum(1).max())} live slots), tracker "
        f"{trk_ms / len(inputs):.2f} ms per frame; KPR's top kernels "
        f"(ms per chunk) {kpr_top}; tracker under the profiler {trk}")

    # K4 on the path's own inputs: layer 0 of the first chunk
    path_qkv = []

    def record(q, k, v, n_valid=None, softmax="f32"):
        if not path_qkv:
            path_qkv.append((q.clone(), k.clone(), v.clone(), n_valid,
                             softmax))
        return vit_attention(q, k, v, n_valid, softmax=softmax)

    kpr_mod.vit_attention = record
    try:
        kpr_call()
    finally:
        kpr_mod.vit_attention = vit_attention
    q, k, v, n_valid, softmax = path_qkv[0]
    err = _check_k4(torch, q, k, v, n_valid, f"path layer 0 {tuple(q.shape)}",
                    softmax)
    with torch.no_grad():
        k4_path_ms = cuda_ms(lambda: vit_attention(q, k, v, n_valid,
                                                   softmax=softmax), 10)
    b_ms, b_by = _k4_bound(torch, q)
    log(f"K4 on the path's layer-0 inputs {tuple(q.shape)} ({softmax} "
        f"softmax): kernel {k4_path_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return launches, dict(
        fps=fps, frames=F, chunk=chunk, syncs_per_frame=syncs_per_frame,
        tracks_per_frame=per_frame, detector_ms_per_chunk=det_ms,
        kpr_ms_per_chunk=kpr_ms, kpr_bucketed_ms_per_chunk=kpr_bucket_ms,
        live_slots_first_chunk=int(dets.valid.sum(1).max()),
        kpr_both_ways=both,
        k4_ms_per_chunk=k4_ms,
        kpr_top_kernels_ms_per_chunk=kpr_top,
        tracker_ms_per_frame=trk_ms / len(inputs), tracker=trk,
        k4_path=dict(shape=list(q.shape), softmax=softmax, ms=k4_path_ms,
                     bound_ms=b_ms, max_abs_err=err))


# ----------------------------------------------- phase 13: the ORU replay
def phase_oru(torch, recorded):
    """The ORU replay kernel against oru_replay_plain on each path's
    recorded replay inputs ({path: {"replay": [...], "idle": [...]}}): x
    within rtol 1e-5 and atol 1e-4, P within rtol 1e-4 and atol 1e-3 (the
    plain version's batched products sum in cuBLAS's order), the frozen
    state returned unchanged where no slot replays. Timed on the
    multi-video path's inputs that replay."""
    from tracklab_torch.kernels.oru_replay import oru_replay, oru_replay_plain

    max_abs, n_checked = 0.0, 0
    for path, store in recorded.items():
        for kind in ("replay", "idle"):
            for ins in store.get(kind, []):
                gx, gP = oru_replay(*ins)
                wx, wP = oru_replay_plain(*ins)
                torch.cuda.synchronize()
                torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-4)
                torch.testing.assert_close(gP, wP, rtol=1e-4, atol=1e-3)
                if kind == "idle":
                    check(torch.equal(gx, ins[0]) and torch.equal(gP, ins[1]),
                          f"ORU {path}: an idle launch changed the state")
                max_abs = max(max_abs, (gx - wx).abs().max().item())
                n_checked += 1
        log(f"ORU replay {path}: {len(store.get('replay', []))} launches "
            f"with a replay and {len(store.get('idle', []))} idle ones "
            "within tolerance of the plain version")
    timed = recorded["multi_video_path"].get("replay") or \
        recorded["main_path"].get("replay")
    check(timed, "no ORU replay input with a replay was recorded")
    ins = timed[-1]

    def run_all():
        for a in timed:
            oru_replay(*a)

    ms = cuda_ms(run_all, 20) / len(timed)
    plain_ms = cuda_ms(lambda: oru_replay_plain(*ins), 3, warmup=1)
    n = ins[5].numel()
    # each slot reads x, P, z_prev, z_new (64 f32), gap (i32) and need (u8)
    # and writes x and P (56 f32); the replay's ~1000 f32 operations per
    # step of each replaying slot's gap
    steps = int(torch.where(ins[5], ins[4], 0).sum())
    b_ms, b_by = bound_ms(n * (64 * 4 + 5 + 56 * 4), steps * 1000,
                          PEAK["f32"])
    trips = int(torch.where(ins[5], ins[4], 0).max())
    log(f"ORU replay: {n_checked} launches checked (max abs err x "
        f"{max_abs:.3e}); timed on {len(timed)} multi-video launches of "
        f"{tuple(ins[5].shape)} slots: kernel {ms:.4f} ms per launch, plain "
        f"{plain_ms:.4f} ms ({trips} trips, the largest gap), bound "
        f"{b_ms:.6f} ms ({b_by})")
    return dict(name="ORU oru_replay (port-only)", route="cuda",
                source="tracklab_torch/csrc/oru_replay.cu",
                replaces="tracklab_tpu/ops/kalman.py:242 (XYSRFilter."
                "oru_replay_batch, a lax.while_loop: no Pallas kernel)",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ------------------------------------------------ phase 14: YOLOX-l and -x
def _plain_csp():
    """A context in which every CSPLayer runs its unfused modules."""
    from contextlib import contextmanager

    from tracklab_torch.models.yolox import CSPLayer

    @contextmanager
    def ctx():
        fwd = CSPLayer.forward
        CSPLayer.forward = CSPLayer.forward_plain
        try:
            yield
        finally:
            CSPLayer.forward = fwd

    return ctx()


def phase_yolox_lx(torch, dev, batch=2, size=640):
    """YOLOX-l and YOLOX-x at 640 in bf16 with seeded weights: K3 takes
    every dense layer of at most CSP_MAX_PIXELS pixels (the JAX kernel's
    rule), by the planner's route; each model against its own plain forward
    (all layers unfused) and both against the f32 plain forward: the mean
    |diff| over the mean |f32| of the kernel's outputs no more than 1.5x
    the plain bf16 forward's."""
    from tracklab_torch.kernels.csp import choose_tile, fused_csplayer
    from tracklab_torch.models.yolox import CSP_MAX_PIXELS, YOLOX, CSPLayer

    def route(mod, H, W):
        if mod.depthwise or H * W > CSP_MAX_PIXELS:
            return None
        ring = choose_tile(H, W, len(mod.m), mod.conv1.conv.weight.shape[1],
                           mod.conv1.conv.weight.shape[0],
                           mod.conv3.conv.weight.shape[0], mod.dtype)[2]
        return ("wide ring", "compact ring", "staged")[ring]

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(0, 256, (batch, size, size, 3), generator=g,
                      device=dev).float()
    flat = lambda outs: torch.cat([o.float().reshape(batch, -1)   # noqa
                                   for o in outs], dim=1)
    rel = lambda a, b: ((a - b).abs().mean() / b.abs().mean()).item()  # noqa
    stats = {}
    for variant in ("l", "x"):
        m16 = YOLOX(num_classes=1, variant=variant, dtype=torch.bfloat16,
                    device=dev).randomize_(0)
        routes = []
        hooks = [mod.register_forward_pre_hook(
            lambda mod, inp, name=name: routes.append(
                (name, tuple(inp[0].shape[2:]),
                 route(mod, *inp[0].shape[2:]))))
            for name, mod in m16.named_modules() if isinstance(mod, CSPLayer)]
        before = fused_csplayer.launches
        with torch.no_grad():
            got = flat(m16(x))
        torch.cuda.synchronize()
        launched = fused_csplayer.launches - before
        for h in hooks:
            h.remove()
        with torch.no_grad(), _plain_csp():
            want = flat(m16(x))
            m32 = YOLOX(num_classes=1, variant=variant, dtype=torch.float32,
                        device=dev).randomize_(0)
            truth = flat(m32(x))
        torch.cuda.synchronize()
        del m16, m32
        took = [f"{n} {hw[0]}x{hw[1]} {k}" for n, hw, k in routes if k]
        plain = [f"{n} {hw[0]}x{hw[1]}" for n, hw, k in routes if not k]
        n_staged = sum(k == "staged" for _, _, k in routes)
        check(launched == len(took), f"YOLOX-{variant}: {launched} K3 "
              f"launches for {len(took)} dense layers of <= 80x80")
        check(n_staged == {"l": 1, "x": 2}[variant],
              f"YOLOX-{variant}: {n_staged} layers by the staged route")
        check(bool(torch.isfinite(got).all()), f"YOLOX-{variant}: non-finite")
        k_pl, k_tr, p_tr = rel(got, want), rel(got, truth), rel(want, truth)
        log(f"YOLOX-{variant} 640 bf16 batch {batch}: K3 took {took}; the "
            f"unfused modules ran {plain} (over K3's 80x80 rule); outputs "
            f"vs its plain forward {k_pl:.3e} (mean |diff| / mean |plain|), vs f32: kernel "
            f"{k_tr:.3e}, plain bf16 {p_tr:.3e}")
        check(k_tr <= 1.5 * p_tr, f"YOLOX-{variant}: {k_tr} from f32, plain "
              f"bf16 {p_tr}")
        stats[variant] = dict(k3_layers=took, plain_layers=plain,
                              vs_plain=k_pl, vs_f32=k_tr,
                              plain_bf16_vs_f32=p_tr)
    return stats


# ---------------------------------------------------- phase 15: ReID path
def phase_reid(torch, dev, n_chunks=8, chunk=16, size=640, n_videos=4,
               n_plain=32):
    """uint8 frames -> YOLOX-s 640 bf16 -> NMS (~20 detections per frame,
    32 slots) -> device crops -> OSNet x1_0 f32 at 256 x 128 over every
    slot (full width: no host sync) -> StrongSORT with strong_sort.yaml's
    values, the reference's BASELINE config-2 pipeline
    (fused_detect_reid_track); OSNet also timed with the buckets (8, 16,
    32), which read the live count on the host."""
    from dataclasses import replace

    import tracklab_torch.ops.assignment as A
    from tracklab_torch.engine.fused import (_bucketed_embed,
                                             fused_detect_reid_track,
                                             make_osnet_embed_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import (solve_square_batched,
                                           solve_square_batched_plain)
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)
    from tracklab_torch.kernels.oru_replay import oru_replay
    from tracklab_torch.models.osnet import OSNet
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.ops import boxes as B
    from tracklab_torch.trackers.common import Detections, stack_frames
    from tracklab_torch.trackers.strongsort import (StrongSortConfig,
                                                    strongsort_init,
                                                    strongsort_scan,
                                                    strongsort_scan_videos,
                                                    strongsort_step)

    # configs/modules/track/strong_sort.yaml, 32 detection slots
    cfg = StrongSortConfig(max_dist=0.1594374041012136,
                           max_iou_dist=0.5431835667667874, max_age=40,
                           n_init=3, nn_budget=100, mc_lambda=0.995,
                           ema_alpha=0.8962157769329083, embed_dim=512,
                           max_tracks=128, max_dets=32)
    det_model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                      device=dev).randomize_(0)
    osnet = OSNet("x1_0", feat_dim=512, n_parts=6, dtype=torch.float32,
                  device=dev).randomize_(1)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    video = base + torch.randint(0, 20, (F, size, size, 3), generator=g,
                                 device=dev, dtype=torch.uint8)
    cal = make_yolox_detect_fn(det_model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"ReID path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(det_model, conf_threshold=conf,
                                  max_dets=32, compute_dtype=torch.bfloat16)
    embed = make_osnet_embed_fn(osnet, crop_size=(256, 128),
                                compute_dtype=torch.float32)
    step = partial(strongsort_step, cfg)
    run = partial(fused_detect_reid_track, detect, embed, chunk=chunk,
                  min_confidence=0.4, embed_dim=512)

    # warm-up on the first chunk, then the second with its syncs counted
    run(step_fn=step, init_state=strongsort_init(cfg, device=dev),
        frames=video[:chunk], return_detections=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(step_fn=step, init_state=strongsort_init(cfg, device=dev),
            frames=video[chunk:2 * chunk], return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs_per_frame = sum("synchroniz" in str(w.message)
                          for w in caught) / chunk

    inputs = []

    def rec_step(st, x):
        inputs.append(x)
        return step(st, x)

    for fn in (solve_square_batched, solve_rect_batched, fused_csplayer,
               oru_replay):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dets, reid, out = run(step_fn=rec_step,
                             init_state=strongsort_init(cfg, device=dev),
                             frames=video, return_embeddings=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K2": solve_rect_batched.launches,
                "K3": fused_csplayer.launches, "ORU": oru_replay.launches}
    fps = F / wall
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"ReID path: {F} frames in {wall:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.4f} host syncs/frame (second chunk)")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the ReID path")
    check(syncs_per_frame == 0,
          f"ReID path: {syncs_per_frame} host syncs per frame")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")
    check(reid["embeddings"].shape == (F, 32, 512) and
          bool(torch.isfinite(reid["embeddings"]).all()),
          "ReID embeddings: shape or non-finite")

    # the tracker stage again with the plain JV solvers, id for id, over the
    # first n_plain frames
    solves = {"K1": 0}
    plain_sq = _plain_on_host(solve_square_batched_plain)

    def plain_k1(cost, k_eff, active):
        solves["K1"] += 1
        return plain_sq(cost, k_eff, active)

    A.solve_square_batched, A.solve_rect_batched = (
        plain_k1, _plain_on_host(solve_rect_batched_plain))
    try:
        t0 = time.perf_counter()
        st, outs = strongsort_init(cfg, device=dev), []
        for x in inputs[:n_plain]:
            st, o = step(st, x)
            outs.append(o)
        plain_out = stack_frames(outs)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        A.solve_square_batched = solve_square_batched
        A.solve_rect_batched = solve_rect_batched
    head = type(out)(*(x[:n_plain] for x in out))
    d = _same_tracks(torch, head, plain_out, "ReID path vs plain JV solvers")
    log(f"ReID path tracker stage with the plain JV solvers over its first "
        f"{n_plain} frames ({solves['K1']} calls, {t_plain:.1f} s): "
        f"{int(head.valid.sum())} boxes equal id for id (max box diff "
        f"{d:.2e})")

    # the detector again with the plain CSPLayers: bf16 rounding moves
    # scores across the threshold and reorders slots, so each frame's
    # detections are matched by IoU and compared, not required equal
    with torch.no_grad(), _plain_csp():
        pd = [detect(video[b:b + chunk]) for b in range(0, F, chunk)]
    pd = Detections(*(torch.cat(f) for f in zip(*pd)))
    iou = B.iou_matrix(dets.ltrb, pd.ltrb)                 # (F, D, D)
    iou = torch.where(dets.valid[:, :, None] & pd.valid[:, None, :], iou,
                      torch.zeros_like(iou))
    best = iou.amax(dim=2)[dets.valid]
    det_cmp = dict(
        detections=int(dets.valid.sum()), plain_detections=int(
            pd.valid.sum()),
        frames_with_other_counts=int((dets.valid.sum(1)
                                      != pd.valid.sum(1)).sum()),
        unmatched_at_iou_0_9=int((best < 0.9).sum()),
        median_best_iou=best.median().item())
    log(f"ReID path detector with the plain CSPLayers: {det_cmp}")

    # where the time goes, on the first chunk
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    frames = video[:chunk]
    d0, det_ms = timed(lambda: detect(frames))
    _, osnet_ms = timed(lambda: embed(frames, d0.ltrb))
    _, osnet_bucket_ms = timed(lambda: _bucketed_embed(
        embed, frames, d0.ltrb, d0.valid, (8, 16, 32)))
    both = _embed_both_ways(torch, detect, embed, video, chunk, (8, 16, 32),
                            timed)
    log(f"ReID path OSNet per chunk, full width against the buckets (8, "
        f"16, 32): {both}")
    first = inputs[:chunk]
    init = strongsort_init(cfg, device=dev)

    def track(frames=first):
        st = init
        for x in frames:
            st, _ = step(st, x)

    track()
    _, trk_ms = timed(track)
    prof = first[:PROFILED_STEPS]
    trk = profile_window(torch, lambda: track(prof), len(prof))
    log(f"ReID path split (chunk of {chunk}): detector {det_ms:.1f} ms, "
        f"OSNet {osnet_ms:.1f} ms at full width, {osnet_bucket_ms:.1f} ms "
        f"with the buckets (8, 16, 32) ({int(d0.valid.sum(1).max())} live "
        "slots), "
        f"tracker {trk_ms / len(first):.2f} ms per frame; tracker under the "
        f"profiler {trk}")

    # the tracker stage alone over V videos at once with batched=True (K2)
    # against each video run alone in the same mode. The default mode is
    # compared, not required equal: free slots (zero covariance) and padded
    # detections give NaN gating costs, and the default mode's one-hot
    # column permutation spreads a NaN over its whole row, which then goes
    # unmatched (the reference fault kept for parity, ROADMAP.md §3); the
    # rectangular batched mode does not, so the modes part, in the JAX
    # package as here
    Fv = F // n_videos
    vdets = Detections(*(torch.stack(f).reshape((n_videos, Fv)
                                                + f[0].shape)
                         for f in zip(*(x[0] for x in inputs))))
    vemb = torch.stack([x[1] for x in inputs]).reshape(
        (n_videos, Fv) + inputs[0][1].shape)
    vwarp = torch.stack([x[2] for x in inputs]).reshape(n_videos, Fv, 2, 3)
    bcfg = replace(cfg, batched=True)
    one = [(Detections(*(f[v] for f in vdets)), vemb[v], vwarp[v])
           for v in range(n_videos)]
    singles = [strongsort_scan(bcfg, *x)[1] for x in one]
    default = [strongsort_scan(cfg, *x)[1] for x in one]
    solve_rect_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, vout = strongsort_scan_videos(bcfg, vdets, vemb, vwarp)
    torch.cuda.synchronize()
    v_ms = (time.perf_counter() - t0) / Fv * 1e3
    k2 = solve_rect_batched.launches
    check(k2 > 0, "batched StrongSORT never launched K2")
    dv = max(_same_tracks(torch, type(vout)(*(x[v] for x in vout)),
                          singles[v], f"StrongSORT batched video {v}")
             for v in range(n_videos))
    other = sum(int((a.valid != b.valid).sum()
                    + (a.track_id != b.track_id)[a.valid & b.valid].sum())
                for a, b in zip(singles, default))
    log(f"StrongSORT batched=True over V={n_videos} x {Fv} frames of the "
        f"path's own inputs: {int(vout.valid.sum())} boxes equal the "
        f"batched single-video runs id for id (max box diff {dv:.2e}); {k2} "
        f"K2 launches; {v_ms:.2f} ms per step for {n_videos} videos; the "
        f"default mode (K1) differs in {other} slot-frames")

    # K2 against its plain version on this stage's problems: the stage again
    # with K2's inputs recorded, the last n_keep checked; and the stage over
    # its first Fp frames with the plain solver in K2's place, id for id
    n_keep, Fp = 4, Fv // 2   # 8 until the depth cut for phase posetrack
    rect_in = []

    def record_k2(cost, active=None):
        rect_in.append((cost, active))
        del rect_in[:-n_keep]
        return solve_rect_batched(cost, active)

    A.solve_rect_batched = record_k2
    try:
        _, vrec = strongsort_scan_videos(bcfg, vdets, vemb, vwarp)
    finally:
        A.solve_rect_batched = solve_rect_batched
    torch.cuda.synchronize()
    _same_tracks(torch, vrec, vout, "batched StrongSORT rerun")
    for c, a in rect_in:
        check(torch.equal(solve_rect_batched(c, a),
                          solve_rect_batched_plain(c, a)),
              "K2 differs from its plain version on a batched StrongSORT "
              "input")
    A.solve_rect_batched = _plain_on_host(solve_rect_batched_plain)
    try:
        t0 = time.perf_counter()
        _, vplain = strongsort_scan_videos(
            bcfg, Detections(*(f[:, :Fp] for f in vdets)), vemb[:, :Fp],
            vwarp[:, :Fp])
        torch.cuda.synchronize()
        t_vplain = time.perf_counter() - t0
    finally:
        A.solve_rect_batched = solve_rect_batched
    _same_tracks(torch, type(vout)(*(x[:, :Fp] for x in vout)), vplain,
                 "batched StrongSORT vs the plain rectangular solver")
    log(f"batched StrongSORT: K2 identical to its plain version on the last "
        f"{len(rect_in)} of its inputs {tuple(rect_in[-1][0].shape)}; the "
        f"stage over the first {Fp} frames with the plain solver "
        f"({t_vplain:.1f} s) equal id for id")
    return launches, {"K2": k2}, dict(
        fps=fps, frames=F, chunk=chunk, syncs_per_frame=syncs_per_frame,
        tracks_per_frame=per_frame, detector_ms_per_chunk=det_ms,
        osnet_ms_per_chunk=osnet_ms,
        osnet_bucketed_ms_per_chunk=osnet_bucket_ms,
        live_slots_first_chunk=int(d0.valid.sum(1).max()),
        osnet_both_ways=both,
        tracker_ms_per_frame=trk_ms / len(first), tracker=trk,
        plain_detector=det_cmp, plain_jv_frames=n_plain,
        plain_jv_calls=solves["K1"],
        batched_videos=dict(videos=n_videos, frames=Fv,
                            ms_per_step=v_ms, k2_launches=k2,
                            default_mode_slot_frames_differing=other))


# ------------------------------------- phase 16: the ORU-NKF replay kernel
def _ptxas_usage(name, kernel):
    """Registers and spills of ``kernel`` in ``csrc/<name>.cu``, as
    ``nvcc -Xptxas -v`` reports them for the build's flags."""
    import tempfile
    from pathlib import Path

    from tracklab_torch.kernels import _build

    flags = [f for f in _build._FLAGS if f not in ("-shared",)]
    with tempfile.TemporaryDirectory(dir=_build._BUILD.parent) as tmp:
        res = subprocess.run(
            [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "o.o"), str(_build._CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
    for part in res.stderr.split("Compiling entry function")[1:]:
        if kernel in part.split("\n", 1)[0]:
            lines = [ln.split(":", 1)[-1].strip()
                     for ln in part.splitlines()
                     if "registers" in ln or "spill" in ln]
            return "; ".join(lines)
    raise AssertionError(f"{kernel}: not in ptxas's report")


def _nkf_slots(torch, dev, shape, seed=0, max_gap=50):
    """Random ORU-NKF inputs over ``shape`` slots on ``dev``: states after
    birth and three filter steps, gaps 1..max_gap (some 0), need mixed."""
    from tracklab_torch.trackers.deepocsort import (_nkf_initiate,
                                                    _nkf_predict,
                                                    _nkf_update)

    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*s):
        return torch.rand(shape + s, generator=g)

    z0 = torch.cat([rand(2) * 800 + 100, rand(2) * 180 + 20], dim=-1)
    x, P = _nkf_initiate(z0)
    no = torch.zeros(shape, dtype=torch.bool)
    for _ in range(3):
        x, P = _nkf_predict(x, P, no)
        x, P = _nkf_update(x, P, z0 + (rand(4) - 0.5) * 6)
    zp = z0 + (rand(4) - 0.5) * 10
    zn = z0 + (rand(4) - 0.5) * 60
    gap = torch.randint(1, max_gap + 1, shape, generator=g,
                        dtype=torch.int32)
    gap[..., :2] = torch.tensor([0, max_gap], dtype=torch.int32)
    need = rand() < 0.7
    return tuple(t.to(dev) for t in (x, P, zp, zn, gap, need))


def phase_oru_nkf(torch, dev, recorded):
    """The ORU-NKF kernel against oru_replay_nkf_plain on the card: seeded
    random (8, 128) slots with gaps 1..50 and mixed need, then the camera
    path's recorded Deep-OC-SORT replay inputs (``recorded``: {"replay":
    [...], "idle": [...]}); x within rtol 1e-5 / atol 1e-4, P within rtol
    1e-4 / atol 1e-3, the frozen state unchanged where a slot does not
    replay. Timed on the random (8, 128) slots, with its bound and the plain
    loop's time; ptxas's registers and spills for the kernel."""
    from tracklab_torch.kernels.oru_replay import (oru_replay_nkf,
                                                   oru_replay_nkf_plain)

    usage = _ptxas_usage("oru_replay", "oru_replay_nkf_kernel")
    log(f"ORU-NKF kernel, ptxas: {usage}")
    rand_in = _nkf_slots(torch, dev, (8, 128))
    cases = [("random (8, 128)", rand_in, False)]
    cases += [("path replay", ins, False) for ins in recorded.get("replay",
                                                                 [])]
    cases += [("path idle", ins, True) for ins in recorded.get("idle", [])]
    check(recorded.get("replay"), "no ORU-NKF path input with a replay")
    max_abs = 0.0
    for what, ins, idle in cases:
        gx, gP = oru_replay_nkf(*ins)
        wx, wP = oru_replay_nkf_plain(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(gP, wP, rtol=1e-4, atol=1e-3)
        keep = ~(ins[5] & (ins[4] > 0))
        check(torch.equal(gx[keep], ins[0][keep])
              and torch.equal(gP[keep], ins[1][keep]),
              f"ORU-NKF {what}: a slot that does not replay changed")
        if idle:
            check(not bool(keep.logical_not().any()), "idle input replays")
        max_abs = max(max_abs, (gx - wx).abs().max().item())
    n_path = len(cases) - 1
    ms = cuda_ms(lambda: oru_replay_nkf(*rand_in), 50)
    plain_ms = cuda_ms(lambda: oru_replay_nkf_plain(*rand_in), 3, warmup=1)
    x, P, zp, zn, gap, need = rand_in
    n = need.numel()
    steps = int(torch.where(need, gap, 0).sum())
    trips = int(torch.where(need, gap, 0).max())
    # each slot reads x, P, z_prev, z_new (80 f32), gap (i32) and need (u8)
    # and writes x and P (72 f32); each step of a replaying slot's gap is
    # ~1100 multiply-adds (the update's K, A and P products) and ~100 other
    # operations: ~2300 f32 operations
    b_ms, b_by = bound_ms(n * (80 * 4 + 5 + 72 * 4), steps * 2300,
                          PEAK["f32"])
    log(f"ORU-NKF: the random (8, 128) slots and {n_path} path launches "
        f"within tolerance of the plain version (max abs err x "
        f"{max_abs:.3e}); kernel {ms:.4f} ms per launch on (8, 128) slots "
        f"({steps} replay steps, {trips} trips), plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    return dict(name="ORU-NKF oru_replay_nkf (port-only)", route="cuda",
                source="tracklab_torch/csrc/oru_replay.cu",
                replaces="tracklab_tpu/trackers/deepocsort.py:117 "
                "(_nkf_oru_replay_batch, a lax.while_loop: no Pallas kernel)",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), dict(
                    ptxas=usage, path_launches_checked=n_path,
                    random_steps=steps, random_trips=trips)


# ------------------------------------ phase 17: the camera-motion ReID path
# configs/modules/track/deep_oc_sort.yaml and bot_sort.yaml (min_confidence
# 0.4 is the fused path's mask)
DEEPOCSORT_YAML = dict(det_thresh=0.0, max_age=50, min_hits=1,
                       iou_threshold=0.22136877277096445, delta_t=1,
                       asso_func="giou", inertia=0.3941737016672115,
                       w_association_emb=0.75, alpha_fixed_emb=0.95,
                       aw_param=0.5, embedding_off=False, aw_off=False,
                       embed_dim=512, max_tracks=128, max_dets=64)
BOTSORT_YAML = dict(track_high_thresh=0.33824964456239337,
                    new_track_thresh=0.21144301345190655, track_buffer=60,
                    match_thresh=0.22734550911325851,
                    proximity_thresh=0.5945380911899254,
                    appearance_thresh=0.4818211117541298,
                    lambda_=0.9896143462366406, frame_rate=30, embed_dim=512,
                    max_tracks=128, max_dets=64)


def panning_video(torch, dev, n_frames, size, drift=(2, -1), seed=5):
    """``n_frames`` uint8 (h, w, 3) frames, ``size`` an int (square) or (h,
    w), cut from one seeded smooth texture (uniform noise, Gaussian blur of
    sigma 3 px, stretched to 0..255) whose content moves by ``drift`` (x,
    y) whole pixels per frame, so the camera warp from each frame to the
    next translates by ``drift``."""
    import torch.nn.functional as nnF

    dx, dy = drift
    h, w = (size, size) if isinstance(size, int) else size
    H = h + abs(dy) * (n_frames - 1) + 32
    W = w + abs(dx) * (n_frames - 1) + 32
    g = torch.Generator(device=dev).manual_seed(seed)
    tex = torch.rand((3, 1, H, W), generator=g, device=dev)
    r = torch.arange(-12, 13, dtype=torch.float32, device=dev)
    k = torch.exp(-0.5 * (r / 3.0) ** 2)
    k = k / k.sum()
    tex = nnF.conv2d(tex, k.view(1, 1, 1, -1), padding=(0, 12))
    tex = nnF.conv2d(tex, k.view(1, 1, -1, 1), padding=(12, 0))[:, 0]
    tex = (tex - tex.amin()) / (tex.amax() - tex.amin()) * 255.0
    tex = tex.round().to(torch.uint8).permute(1, 2, 0)
    ox = 16 + max(dx, 0) * (n_frames - 1)
    oy = 16 + max(dy, 0) * (n_frames - 1)
    return torch.stack([tex[oy - dy * t:oy - dy * t + h,
                            ox - dx * t:ox - dx * t + w]
                        for t in range(n_frames)])


def _run_stage(step, init, inputs):
    """A tracker stage over recorded per-frame inputs; stacked outputs."""
    from tracklab_torch.trackers.common import stack_frames

    st, outs = init, []
    for x in inputs:
        st, o = step(st, x)
        outs.append(o)
    return stack_frames(outs)


def _inputs_to(inputs, dev):
    from tracklab_torch.trackers.common import Detections

    return [(Detections(*(t.to(dev) for t in d)), e.to(dev), w.to(dev))
            for d, e, w in inputs]


def phase_motion(torch, dev, n_chunks=8, chunk=16, size=640, n_videos=4,
                 drift=(2, -1), oru=None):
    """uint8 frames panning by ``drift`` px per frame -> on-card LK camera
    warps (gmc_warps, levels 3, iters 10, batched over each chunk's frame
    pairs) -> YOLOX-s 640 bf16 -> NMS (~20 detections per frame, 64 slots)
    -> device crops -> OSNet x1_0 f32 at 256 x 128 over every slot ->
    Deep-OC-SORT (deep_oc_sort.yaml) and, in a second run, BoT-SORT
    (bot_sort.yaml), min_confidence 0.4 as a mask, through
    fused_detect_reid_track. ``oru``, a dict, receives Deep-OC-SORT's
    ORU-NKF replay inputs (:func:`_keep_oru`)."""
    from dataclasses import replace

    import tracklab_torch.ops.assignment as A
    import tracklab_torch.trackers.deepocsort as DO
    from tracklab_torch.engine.fused import (fused_detect_reid_track,
                                             make_osnet_embed_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import (solve_square_batched,
                                           solve_square_batched_plain)
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)
    from tracklab_torch.kernels.oru_replay import (oru_replay_nkf,
                                                   oru_replay_nkf_plain)
    from tracklab_torch.models.osnet import OSNet
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.motion.lk import estimate_affine_lk, gmc_warps
    from tracklab_torch.trackers import botsort as BS
    from tracklab_torch.trackers.common import Detections

    F = n_chunks * chunk
    video = panning_video(torch, dev, F, size, drift)
    det_model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                      device=dev).randomize_(0)
    osnet = OSNet("x1_0", feat_dim=512, n_parts=6, dtype=torch.float32,
                  device=dev).randomize_(1)
    cal = make_yolox_detect_fn(det_model, conf_threshold=0.3, max_dets=64,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"camera path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(det_model, conf_threshold=conf,
                                  max_dets=64, compute_dtype=torch.bfloat16)
    embed = make_osnet_embed_fn(osnet, crop_size=(256, 128),
                                compute_dtype=torch.float32)
    run = partial(fused_detect_reid_track, detect, embed, chunk=chunk,
                  min_confidence=0.4, embed_dim=512)
    trackers = {
        "deepocsort": (DO.DeepOCSortConfig(**DEEPOCSORT_YAML),
                       DO.deepocsort_init, DO.deepocsort_step,
                       DO.deepocsort_scan, DO.deepocsort_scan_videos),
        "botsort": (BS.BotSortConfig(**BOTSORT_YAML), BS.botsort_init,
                    BS.botsort_step, BS.botsort_scan,
                    BS.botsort_scan_videos)}

    def warps_of(sl):
        prev = None if sl.start == 0 else video[sl.start - 1]
        return gmc_warps(video[sl], 3, 10, prev=prev)

    # warm-up on the first chunk, then the second chunk (LK and the whole
    # path) with its host syncs counted, for each tracker
    c0, c1 = slice(0, chunk), slice(chunk, 2 * chunk)
    for cfg, init_fn, step_fn, _, _ in trackers.values():
        run(step_fn=partial(step_fn, cfg), init_state=init_fn(cfg, device=dev),
            frames=video[c0], warps=warps_of(c0), return_detections=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for cfg, init_fn, step_fn, _, _ in trackers.values():
            run(step_fn=partial(step_fn, cfg),
                init_state=init_fn(cfg, device=dev), frames=video[c1],
                warps=warps_of(c1), return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    check(syncs == 0, f"camera path: {syncs} host syncs in one chunk of "
          "LK and each tracker's path")

    # the camera warps of the whole video, chunk by chunk, against the pan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warps = torch.cat([warps_of(slice(b, b + chunk))
                       for b in range(0, F, chunk)])
    torch.cuda.synchronize()
    lk_ms = (time.perf_counter() - t0) * 1e3 / n_chunks
    check(warps.shape == (F, 2, 3), "warps shape")
    check(torch.equal(warps[0].cpu(), torch.eye(2, 3)), "warp 0 != identity")
    w = warps[1:].cpu()
    t_err = (w[:, :, 2] - torch.tensor(drift, dtype=torch.float32)).abs()
    l_err = (w[:, :, :2] - torch.eye(2)).abs()
    check(t_err.max().item() <= 0.25,
          f"LK translation {t_err.max().item():.4f} px off the drift")
    check(l_err.max().item() <= 0.01,
          f"LK linear part {l_err.max().item():.5f} off the identity")
    cpu_err = 0.0
    for t in (1, chunk):           # inside a chunk, and across chunks
        wc = estimate_affine_lk(video[t - 1].cpu(), video[t].cpu())
        cpu_err = max(cpu_err, (wc - warps[t].cpu()).abs().max().item())
    check(cpu_err <= 1e-3, f"LK on the card vs the CPU: {cpu_err}")
    log(f"camera path LK: {lk_ms:.2f} ms per chunk of {chunk} frame pairs; "
        f"translation within {t_err.max().item():.4f} px of the drift "
        f"{drift}, linear part within {l_err.max().item():.2e} of the "
        f"identity; two pairs within {cpu_err:.2e} of the LK on the CPU")

    # where the time goes outside the tracker, on the first chunk
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    d0, det_ms = timed(lambda: detect(video[:chunk]))
    _, osnet_ms = timed(lambda: embed(video[:chunk], d0.ltrb))
    stats = dict(frames=F, chunk=chunk, drift=list(drift),
                 syncs_per_chunk=syncs, lk_ms_per_chunk=lk_ms,
                 lk_translation_max_err_px=t_err.max().item(),
                 lk_linear_max_err=l_err.max().item(),
                 lk_cpu_max_abs_diff=cpu_err, detector_ms_per_chunk=det_ms,
                 osnet_ms_per_chunk=osnet_ms,
                 live_slots_first_chunk=int(d0.valid.sum(1).max()))
    all_launches = {}
    # depth cut for the room of phase posetrack: the CPU and plain-kernel
    # reruns over 8 frames (32 until then), the video-axis checks over the
    # first half of the frames (V = 4 x 16, 4 x 32 until then), K2's plain
    # check on the last 2 of its batched inputs (8 until then)
    n_plain = chunk // 2
    for name, (cfg, init_fn, step_fn, scan, scan_videos) in trackers.items():
        step = partial(step_fn, cfg)
        inputs = []

        def rec_step(st, x):
            inputs.append(x)
            return step(st, x)

        for fn in (solve_square_batched, solve_rect_batched, fused_csplayer,
                   oru_replay_nkf):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, out = run(step_fn=rec_step,
                           init_state=init_fn(cfg, device=dev), frames=video,
                           warps=warps, return_detections=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": solve_square_batched.launches,
                    "K2": solve_rect_batched.launches,
                    "K3": fused_csplayer.launches,
                    "ORU-NKF": oru_replay_nkf.launches}
        fps = F / (wall + lk_ms * n_chunks / 1e3)
        per_frame = out.valid.sum(1).float().mean().item()
        log(f"camera path, {name}: {F} frames in {wall:.3f} s + LK "
            f"{lk_ms * n_chunks / 1e3:.3f} s = {fps:.2f} frames/s, "
            f"{per_frame:.2f} tracks/frame, launches {launches}")
        check(launches["K3"] == 7 * n_chunks,
              f"{name}: K3 launches {launches['K3']} != 7 per chunk")
        check(launches["K1"] > 0, f"{name}: K1 never launched")
        if name == "deepocsort":
            check(launches["ORU-NKF"] == F,
                  f"ORU-NKF launches {launches['ORU-NKF']} != one per frame")
        check(out.valid.shape == (F, cfg.max_tracks), "output shape")
        check(out.valid.any().item(), f"{name} emitted no tracks")
        check(torch.isfinite(out.ltrb[out.valid]).all().item(),
              f"{name}: non-finite track boxes")

        # PROFILED_STEPS tracker steps under the profiler
        first = inputs[:chunk]
        init = init_fn(cfg, device=dev)
        _run_stage(step, init, first)
        _, trk_ms = timed(lambda: _run_stage(step, init, first))
        prof = first[:PROFILED_STEPS]
        trk = profile_window(torch, lambda: _run_stage(step, init, prof),
                             len(prof))
        log(f"camera path, {name}: tracker {trk_ms / len(first):.2f} ms per "
            f"frame; under the profiler {trk}")

        # the first n_plain recorded frames: (a) the same stage on the CPU,
        # (b) on the card with the plain JV solvers (on host copies of their
        # inputs) and the plain ORU-NKF
        head = type(out)(*(x[:n_plain] for x in out))
        cpu_out = _run_stage(step, init_fn(cfg, device="cpu"),
                             _inputs_to(inputs[:n_plain], "cpu"))
        d_cpu = _same_tracks(torch, head, cpu_out,
                             f"camera path {name}: card vs CPU")
        A.solve_square_batched, A.solve_rect_batched = (
            _plain_on_host(solve_square_batched_plain),
            _plain_on_host(solve_rect_batched_plain))
        DO.oru_replay_nkf = oru_replay_nkf_plain
        try:
            t0 = time.perf_counter()
            plain_out = _run_stage(step, init_fn(cfg, device=dev),
                                   inputs[:n_plain])
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        finally:
            A.solve_square_batched = solve_square_batched
            A.solve_rect_batched = solve_rect_batched
            DO.oru_replay_nkf = oru_replay_nkf
        d_plain = _same_tracks(torch, head, plain_out,
                               f"camera path {name}: plain kernels")
        log(f"camera path, {name}: the first {n_plain} frames equal the CPU "
            f"stage (max box diff {d_cpu:.2e}) and the stage with the plain "
            f"JV solvers and ORU-NKF ({t_plain:.1f} s; {d_plain:.2e}) id for "
            f"id, {int(head.valid.sum())} boxes")

        if name == "deepocsort" and oru is not None:
            def record_oru(*args):
                _keep_oru(oru, args)
                return oru_replay_nkf(*args)

            DO.oru_replay_nkf = record_oru
            try:
                rerun = _run_stage(step, init_fn(cfg, device=dev), inputs)
            finally:
                DO.oru_replay_nkf = oru_replay_nkf
            _same_tracks(torch, rerun, out, "Deep-OC-SORT rerun")

        # the tracker stage alone over V videos in both modes, each against
        # its own single-video runs in that mode; K2 against its plain
        # version on the batched stage's last inputs
        half = inputs[:F // 2]
        Fv = len(half) // n_videos
        vdets = Detections(*(torch.stack(f).reshape((n_videos, Fv)
                                                    + f[0].shape)
                             for f in zip(*(x[0] for x in half))))
        vemb = torch.stack([x[1] for x in half]).reshape(
            (n_videos, Fv) + half[0][1].shape)
        vwarp = torch.stack([x[2] for x in half]).reshape(n_videos, Fv, 2, 3)
        modes = {}
        for batched in (False, True):
            mcfg = replace(cfg, batched=batched)
            singles = [scan(mcfg, Detections(*(f[v] for f in vdets)),
                            vemb[v], vwarp[v])[1] for v in range(n_videos)]
            rect_in = []

            def record_k2(cost, active=None):
                rect_in.append((cost, active))
                del rect_in[:-2]
                return solve_rect_batched(cost, active)

            k1, k2 = solve_square_batched.launches, solve_rect_batched.launches
            A.solve_rect_batched = record_k2
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, vout = scan_videos(mcfg, vdets, vemb, vwarp)
                torch.cuda.synchronize()
                v_ms = (time.perf_counter() - t0) / Fv * 1e3
            finally:
                A.solve_rect_batched = solve_rect_batched
            k1 = solve_square_batched.launches - k1
            k2 = solve_rect_batched.launches - k2
            check(k2 > 0 if batched else k1 > 0,
                  f"{name} batched={batched}: no solve launched")
            dv = max(_same_tracks(torch, type(vout)(*(x[v] for x in vout)),
                                  singles[v],
                                  f"{name} batched={batched} video {v}")
                     for v in range(n_videos))
            if batched:
                for c, a in rect_in:
                    check(torch.equal(solve_rect_batched(c, a),
                                      solve_rect_batched_plain(c, a)),
                          f"K2 differs from its plain version on a {name} "
                          "input")
            modes[f"batched={batched}"] = dict(ms_per_step=v_ms, k1=k1,
                                               k2=k2, boxes=int(
                                                   vout.valid.sum()))
            log(f"camera path, {name} batched={batched} over V={n_videos} x "
                f"{Fv} frames: {int(vout.valid.sum())} boxes equal the "
                f"single-video runs id for id (max box diff {dv:.2e}); K1 "
                f"{k1}, K2 {k2} launches"
                + (f", K2 identical to its plain version on the last "
                   f"{len(rect_in)} inputs" if batched else "")
                + f"; {v_ms:.2f} ms per step for {n_videos} videos")
        all_launches[name] = launches
        stats[name] = dict(fps=fps, tracks_per_frame=per_frame,
                           path_s=wall, tracker_ms_per_frame=trk_ms
                           / len(first), tracker=trk,
                           plain_frames=n_plain, plain_s=t_plain,
                           video_axis=modes)
    return all_launches, stats


# ------------------------------------------------------------ phase cli
GT_OVERRIDE = ("state.load_from_groundtruth="
               "{detection: [bbox_ltwh, bbox_conf, category_id]}")


def _timed_sync_count(torch, fn, *a, **kw):
    """``fn(*a, **kw)`` synchronised before and after: (its result, its
    seconds, the host syncs inside it, counted in sync debug mode)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            sum("synchroniz" in str(w.message) for w in caught))


class _CliSplit:
    """Where a CLI run's host wall time goes: seconds blocked on the
    loader (decode, letterbox and crops on its threads), in device programs
    (the fused program, or the staged detector, ReID (OSNet, KPR, and the
    zoo's backbones under "embed"), pose and tracker scan
    calls, each synchronised and also kept per stage in ``s_by``; the
    scans, single-video or over the batched engine's video axis, also
    apart), in camera-motion estimates
    (GMC.apply), in the calibration modules (PitchLineDetector.process and
    TVCalibration.process, each synchronised, TVCalibration's calls kept as
    (frames, seconds)), and in evaluation (HOTA or GS-HOTA); host syncs
    counted inside the fused program and inside the tracker scans (sync
    debug mode); frames through the fused program. ``fired`` counts the calls each patch timed,
    so that a run can check that every patch it relies on saw its work (a
    patch that a refactor bypasses would move its time into "DataFrames and
    host" silently). A timed call inside another (OSNet inside the staged
    batched ReID) is not timed again."""

    def __init__(self, torch):
        import tracklab_torch.engine.fused as TF
        from tracklab_torch.datastruct.datapipe import PrefetchLoader
        from tracklab_torch.eval.evaluator import TrackEvalEvaluator
        from tracklab_torch.eval.gs_evaluator import GameStateEvaluator
        from tracklab_torch.eval.pose_evaluator import PoseTrackEvaluator
        from tracklab_torch.models.kpr import KPR
        from tracklab_torch.models.osnet import OSNet, ReidBackbone
        from tracklab_torch.models.rtdetr import RTDETR
        from tracklab_torch.motion.gmc import GMC
        from tracklab_torch.wrappers.calibration_api import (
            PitchLineDetector, TVCalibration)
        from tracklab_torch.wrappers.pose_estimator import \
            TopDownPoseEstimator
        from tracklab_torch.wrappers.track.scan_tracker import \
            _ScanTrackerBase

        self.torch = torch
        self.t = dict(loader=0.0, device=0.0, camera=0.0, segmenter=0.0,
                      calibration=0.0, eval=0.0)
        self.syncs, self.program_frames = 0, 0
        self.scan_s, self.scan_syncs = 0.0, 0
        self.calibration_calls = []
        self.inside = self.busy = False
        self.fired = dict.fromkeys(("loader", "program", "detect", "embed",
                                    "reid", "pose", "scan", "camera",
                                    "segmenter", "calibration", "eval"), 0)
        # seconds of the synchronised calls per patch key (detect, embed,
        # reid, pose, ...): the device split by stage
        self.s_by = dict.fromkeys(self.fired, 0.0)
        self.patches = [
            (PrefetchLoader, "__iter__", self._loader),
            (TF, "fused_detect_track", partial(self._program, frames_at=3)),
            (TF, "fused_detect_reid_track",
             partial(self._program, frames_at=4)),
            (TF, "fused_bottomup_track", partial(self._program, frames_at=3)),
            (TF, "fused_detect_pose_track",
             partial(self._program, frames_at=4)),
            (TF, "fused_detect_parts_track",
             partial(self._program, frames_at=4)),
            (TF, "make_yolox_detect_fn", partial(self._staged_fn, "detect")),
            (TF, "make_bottomup_detect_fn",
             partial(self._staged_fn, "detect")),
            (TF, "make_osnet_embed_fn", partial(self._staged_fn, "embed")),
            (TF, "make_kpr_embed_fn", partial(self._staged_fn, "embed")),
            (TF, "make_topdown_pose_fn", partial(self._staged_fn, "pose")),
            (TF, "make_rtdetr_detect_fn",
             partial(self._staged_fn, "detect")),
            (RTDETR, "predict", partial(self._forward, key="detect")),
            (TopDownPoseEstimator, "process", self._pose),
            (OSNet, "forward", self._forward),
            (ReidBackbone, "forward", partial(self._forward, key="embed")),
            (KPR, "forward", self._forward),
            (_ScanTrackerBase, "process_video_batch", self._tracker),
            (GMC, "apply", self._camera),
            (PitchLineDetector, "process", self._segmenter),
            (TVCalibration, "process", self._calibration),
            (TrackEvalEvaluator, "run", self._eval),
            (GameStateEvaluator, "run", self._eval),
            (PoseTrackEvaluator, "run", self._eval)]

    def __enter__(self):
        self.saved = [(o, n, getattr(o, n)) for o, n, _ in self.patches]
        for (o, n, wrap), (_, _, orig) in zip(self.patches, self.saved):
            setattr(o, n, wrap(orig))
        return self

    def __exit__(self, *exc):
        for o, n, orig in reversed(self.saved):
            setattr(o, n, orig)
        return False

    def _timed(self, key, fired, fn, *a, **kw):
        if self.inside or self.busy:
            return fn(*a, **kw)
        self.fired[fired] += 1
        self.busy = True
        try:
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
        finally:
            self.busy = False
        self.t[key] += time.perf_counter() - t0
        self.s_by[fired] += time.perf_counter() - t0
        return out

    def _loader(self, orig):
        split = self

        def it(loader):
            gen = orig(loader)
            while True:
                t0 = time.perf_counter()
                item = next(gen, None)
                split.t["loader"] += time.perf_counter() - t0
                if item is None:
                    return
                split.fired["loader"] += 1
                yield item
        return it

    def _program(self, orig, frames_at):
        def run(*a, **kw):
            self.inside = True
            try:
                out, dt, syncs = _timed_sync_count(self.torch, orig, *a, **kw)
            finally:
                self.inside = False
            self.t["device"] += dt
            self.syncs += syncs
            self.fired["program"] += 1
            self.program_frames += a[frames_at].shape[0]
            return out
        return run

    def _staged_fn(self, key, orig):
        """A ``make_*_fn`` whose functions are timed as device work."""
        def make(*a, **kw):
            fn = orig(*a, **kw)
            return lambda *x, **y: self._timed("device", key, fn, *x, **y)
        return make

    def _forward(self, orig, key="reid"):
        def forward(model, *a, **kw):
            return self._timed("device", key, orig, model, *a, **kw)
        return forward

    def _pose(self, orig):
        def process(module, *a, **kw):
            return self._timed("device", "pose", orig, module, *a, **kw)
        return process

    def _scan(self, fn, *a, **kw):
        """A tracker scan, synchronised and timed as device work, with the
        host syncs inside it counted."""
        self.fired["scan"] += 1
        out, dt, syncs = _timed_sync_count(self.torch, fn, *a, **kw)
        self.t["device"] += dt
        self.s_by["scan"] += dt
        self.scan_s += dt
        self.scan_syncs += syncs
        return out

    def _tracker(self, orig):
        """A tracker wrapper's ``process_video_batch`` (``process`` is its
        V = 1 case) with its scan (``_scan_videos_fn``) timed."""
        def run(module, *a, **kw):
            getter = module._scan_videos_fn

            def timed_getter():
                fn = getter()
                return lambda *x, **y: self._scan(fn, *x, **y)
            module._scan_videos_fn = timed_getter
            try:
                return orig(module, *a, **kw)
            finally:
                del module._scan_videos_fn
        return run

    def _camera(self, orig):
        def apply(gmc, *a, **kw):
            return self._timed("camera", "camera", orig, gmc, *a, **kw)
        return apply

    def _segmenter(self, orig):
        def process(module, *a, **kw):
            return self._timed("segmenter", "segmenter", orig, module, *a,
                               **kw)
        return process

    def _calibration(self, orig):
        def process(module, batch, dets, metas):
            before = self.t["calibration"]
            out = self._timed("calibration", "calibration", orig, module,
                              batch, dets, metas)
            self.calibration_calls.append(
                (len(metas), self.t["calibration"] - before))
            return out
        return process

    def _eval(self, orig):
        def run(evaluator, state):
            t0 = time.perf_counter()
            out = orig(evaluator, state)
            self.t["eval"] += time.perf_counter() - t0
            self.fired["eval"] += 1
            return out
        return run


_CLI_COUNTERS = ("K1", "K2", "K3", "K4", "ORU", "ORU-NKF")


def _launch_counters():
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.kernels.oru_replay import oru_replay, oru_replay_nkf
    from tracklab_torch.kernels.vit_attention import vit_attention

    return dict(zip(_CLI_COUNTERS, (solve_square_batched, solve_rect_batched,
                                    fused_csplayer, vit_attention,
                                    oru_replay, oru_replay_nkf)))


def _cli_run(torch, args, timed, split=True):
    """``tracklab_torch.main.main(args)`` in this process with the kernels'
    launch counters set to 0 just before and read just after; checks that
    each of ``timed`` (keys of ``_CliSplit.fired``) timed some work in the
    run; returns (parts, results, launches, split stats). With
    ``split=False`` nothing is patched or synchronised (the pipelined
    engine's stages overlap on threads): the stats hold frames/s only."""
    import contextlib

    from tracklab_torch import main as TM
    from tracklab_torch.callbacks.timer import Timer

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    with (_CliSplit(torch) if split else contextlib.nullcontext()) as sp:
        t0 = time.perf_counter()
        parts, results = TM.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    timer = next(c for c in parts["callbacks"] if isinstance(c, Timer))
    track_s = timer.dataset_seconds
    frames = timer.total_frames
    if not split:
        return parts, results, launches, dict(
            frames=frames, track_dataset_s=track_s, fps=frames / track_s,
            main_wall_s=wall)
    split = sp
    for key in timed:
        check(split.fired[key] > 0, f"cli {args}: the split's {key} patch "
              "timed nothing, so its time would count as host time")
    host = track_s - sum(v for k, v in split.t.items() if k != "eval")
    stats = dict(frames=frames, track_dataset_s=track_s,
                 fps=frames / track_s, loader_s=split.t["loader"],
                 device_s=split.t["device"], camera_s=split.t["camera"],
                 segmenter_s=split.t["segmenter"],
                 calibration_s=split.t["calibration"],
                 calibration_calls=split.calibration_calls,
                 dataframes_and_host_s=host,
                 eval_s=split.t["eval"], main_wall_s=wall,
                 tracker_scan_s=split.scan_s,
                 host_syncs_in_scans=split.scan_syncs,
                 host_syncs_in_fused_program=split.syncs,
                 fused_program_frames=split.program_frames,
                 patch_calls=dict(split.fired),
                 device_s_by_stage={k: v for k, v in split.s_by.items()
                                    if v})
    return parts, results, launches, stats


def _same_rows(a, b, what, box_col="bbox_ltwh"):
    """tests/test_fused_engine.py's assertions: the same rows, ids and
    categories, boxes within rtol 1e-4 / atol 1e-3, the same track ids."""
    check(len(a) > 0, f"{what}: no detections")
    check(a.index.equals(b.index), f"{what}: row ids differ")
    for col in ("image_id", "video_id", "category_id"):
        check(np.array_equal(a[col].to_numpy(float), b[col].to_numpy(float)),
              f"{what}: {col} differs")
    check(np.allclose(np.stack(a[box_col].to_numpy()),
                      np.stack(b[box_col].to_numpy()), rtol=1e-4, atol=1e-3),
          f"{what}: {box_col} differs")
    av, bv = a["track_id"].notna(), b["track_id"].notna()
    check(bool(bv.any()), f"{what}: the tracker emitted nothing")
    check(np.array_equal(av.to_numpy(), bv.to_numpy()),
          f"{what}: tracked rows differ")
    check(np.array_equal(a.loc[av, "track_id"].to_numpy(float),
                         b.loc[bv, "track_id"].to_numpy(float)),
          f"{what}: track ids differ")
    check(np.allclose(np.stack(a.loc[av, "track_bbox_ltwh"].to_numpy()),
                      np.stack(b.loc[bv, "track_bbox_ltwh"].to_numpy()),
                      rtol=1e-4, atol=1e-3), f"{what}: track boxes differ")


def _calibrate_cli(torch, dev, n_objects, per_frame=25, born=15,
                   img_wh=(1920, 1080), frames=None, detector=None,
                   own_input=False):
    """The score thresholds that leave ~``per_frame`` detections per frame
    (detector and tracker pre-filter) and ~``born`` above the tracker's
    birth threshold, from ``detector`` (built with min_confidence 0; by
    default the seeded YOLOX-s of yolox.yaml, or a bottom-up pose module)
    on ``frames`` (RGB uint8), by
    default the first 8 frames of the CLI's validation video at
    ``img_wh``. The frames are letterboxed to 640 x 640 and go through the
    fused closure, or with ``own_input`` through the detector's own
    ``preprocess`` and the staged closure (the detector zoo: RTMDet at
    320, the HF RT-DETR's stretch resize, the lightweight RT-DETR, which
    has no fused closure)."""
    from tracklab_torch.utils.cv2 import cv2_load_image
    from tracklab_torch.wrappers.bbox_detector.yolox_api import (
        YOLOXDetector, letterbox)
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    if frames is None:
        s = make_synthetic_set(n_videos=1, n_frames=8, n_objects=n_objects,
                               seed=1, id_offset=2, img_w=img_wh[0],
                               img_h=img_wh[1])
        frames = [cv2_load_image(p) for p in s.image_metadatas["file_path"]]
    det = detector or YOLOXDetector(min_confidence=0.0, device=dev)
    if own_input:
        boxes = [det.preprocess(f, None, None) for f in frames]
        det._build()
        fn = det._staged_detect_fn()
    else:
        boxes = [letterbox(f, (640, 640)) for f in frames]
        fn = det.device_detect_fn()
    out = fn(
        torch.from_numpy(np.stack([b["image"] for b in boxes])).to(dev),
        {k: torch.from_numpy(np.stack([b[k] for b in boxes])).to(dev)
         for k in ("scale", "pad", "shape")})
    if not hasattr(out, "conf"):          # a bottom-up pose detector's
        out = out[0]                        # (Detections, keypoints)
    scores = [np.sort(c[v].cpu().numpy())[::-1]
              for c, v in zip(out.conf, out.valid)]
    check(min(len(x) for x in scores) > per_frame + 1,
          f"calibration: only {[len(x) for x in scores]} NMS survivors")

    def at(k):
        return float(round(np.mean([(x[k - 1] + x[k]) / 2 for x in scores]),
                           6))
    return at(per_frame), at(born)


def phase_cli(torch, dev, card, n_frames=300, n_objects=24, keep=None):
    """The port's command line in this process, twice.

    (a) The quick start at its own size (synthetic.yaml: 2 videos x 100
    frames x 8 objects at 1920 x 1080; oc_sort.yaml): GT -> OC-SORT on the
    card; COMBINED_SEQ HOTA, MOTA and IDF1 100.0 and IDSW 0; the track
    table equal to the same run with device=cpu id for id; K1 and the ORU
    replay launched.
    (b) The detector CLI at full width: synthetic 2 videos x ``n_frames``
    x ``n_objects`` at 1920 x 1080 (the MOT17 frame size; its sequences
    run 600-1050 frames with ~20-40 people) -> yolox.yaml (YOLOX-s 640
    f32, max_dets 64, batch 8, seeded weights) -> oc_sort.yaml, with the
    score thresholds calibrated to leave 10-40 detections per frame; once
    with engine.fused=true and once false: fused equals staged
    (tests/test_fused_engine.py's assertions), K3, K1 and ORU launched in
    the fused run, 0 host syncs inside the fused device program (the
    per-video upload and readback are outside it). Each run's frames/s of
    track_dataset and its split into loader, device programs, host
    DataFrame work and evaluation are printed with ``card`` (the card's
    name and power limit). ``keep``, a dict, receives (b)'s arguments and
    its staged run's rows under "cli_staged"."""
    stats = {}
    base = ["use_rich=false", GT_OVERRIDE]
    gpu_parts, res, launches, split = _cli_run(
        torch, base + [f"device={dev.type}"], ("scan", "eval"))
    c = res["COMBINED_SEQ"]
    log(f"cli (a) quick start on {card}: HOTA {c['HOTA']}, MOTA "
        f"{c['MOTA']}, IDF1 {c['IDF1']}, IDSW {c['IDSW']}; launches "
        f"{launches}; {split}")
    for k in ("HOTA", "MOTA", "IDF1"):
        check(c[k] == 100.0, f"cli quick start: {k} {c[k]} != 100.0")
    check(c["IDSW"] == 0, f"cli quick start: IDSW {c['IDSW']}")
    check(launches["K1"] > 0, "cli quick start: K1 never launched")
    check(launches["ORU"] > 0, "cli quick start: ORU never launched")
    cpu_parts, cpu_res, _, cpu_split = _cli_run(
        torch, base + ["device=cpu"], ("scan", "eval"))
    a = gpu_parts["tracker_state"].detections_pred
    b = cpu_parts["tracker_state"].detections_pred
    check(a.index.equals(b.index), "cli quick start: card and CPU rows differ")
    check(np.array_equal(a["track_id"].to_numpy(float),
                         b["track_id"].to_numpy(float)),
          "cli quick start: card and CPU track ids differ")
    tv = a["track_id"].notna().to_numpy()
    d = float(np.abs(np.stack(a["track_bbox_ltwh"].to_numpy()[tv])
                     - np.stack(b["track_bbox_ltwh"].to_numpy()[tv])).max())
    check(d <= 1e-3, f"cli quick start: card vs CPU boxes {d}")
    log(f"cli (a): card equals the CPU run id for id ({int(tv.sum())} "
        f"tracked rows, max box diff {d:.2e}); CPU {cpu_split['fps']:.2f} "
        "frames/s")
    stats["quick_start"] = dict(
        HOTA=c["HOTA"], MOTA=c["MOTA"], IDF1=c["IDF1"], IDSW=c["IDSW"],
        launches=launches, split=split, cpu_fps=cpu_split["fps"],
        max_box_diff_vs_cpu=d)

    det_thr, birth_thr = _calibrate_cli(torch, dev, n_objects)
    log(f"cli (b): calibrated detector/tracker min_confidence {det_thr}, "
        f"tracker det_thresh {birth_thr}")
    args = ["use_rich=false", f"device={dev.type}",
            "pipeline=[bbox_detector,track]",
            "+modules/bbox_detector=yolox",
            f"modules.bbox_detector.min_confidence={det_thr}",
            f"modules.track.min_confidence={det_thr}",
            f"modules.track.det_thresh={birth_thr}",
            "dataset.n_videos=2", f"dataset.n_frames={n_frames}",
            f"dataset.n_objects={n_objects}"]
    runs = {}
    for fused in (True, False):
        parts, res, launches, split = _cli_run(
            torch, args + [f"engine.fused={str(fused).lower()}"],
            ("loader", "program", "eval") if fused
            else ("loader", "detect", "scan", "eval"))
        pred = parts["tracker_state"].detections_pred
        mean_dets = len(pred) / split["frames"]
        runs[fused] = pred
        name = "fused" if fused else "staged"
        log(f"cli (b) {name} on {card}: {split['frames']} frames, "
            f"{mean_dets:.2f} "
            f"detections/frame, {split['fps']:.2f} frames/s of "
            f"track_dataset ({split['track_dataset_s']:.2f} s: loader "
            f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
            f"DataFrames and host {split['dataframes_and_host_s']:.2f}; "
            f"eval {split['eval_s']:.2f}); HOTA "
            f"{res['COMBINED_SEQ']['HOTA']:.3f}; launches {launches}; host "
            f"syncs in the fused program {split['host_syncs_in_fused_program']}")
        check(10 <= mean_dets <= 40,
              f"cli (b): {mean_dets:.2f} detections per frame")
        if fused:
            for k in ("K3", "K1", "ORU"):
                check(launches[k] > 0, f"cli (b) fused: {k} never launched")
            check(split["fused_program_frames"] >= split["frames"],
                  "cli (b): the fused program did not run")
            check(split["host_syncs_in_fused_program"] == 0,
                  f"cli (b): {split['host_syncs_in_fused_program']} host "
                  "syncs inside the fused program")
        stats[name] = dict(split, detections_per_frame=mean_dets,
                           launches=launches,
                           HOTA=res["COMBINED_SEQ"]["HOTA"])
    _same_rows(runs[True], runs[False], "cli (b) fused vs staged")
    log("cli (b): fused equals staged (rows, ids, categories, boxes, track "
        "ids)")
    if keep is not None:
        keep["cli_staged"] = (args, runs[False], stats["staged"]["fps"])
    stats["thresholds"] = dict(min_confidence=det_thr, det_thresh=birth_thr)
    return stats


# ------------------------------------------------------- phase cli_reid
def _same_embeddings(a, b, what, rel=1e-3):
    """The rows' embeddings (and visibility) within ``rel`` of their scale;
    returns the largest difference over that scale."""
    ea = np.stack(a["embeddings"].to_numpy())
    eb = np.stack(b["embeddings"].to_numpy())
    check(ea.shape == eb.shape, f"{what}: embedding shapes {ea.shape} "
          f"and {eb.shape}")
    scale = float(np.abs(eb).max())
    d = float(np.abs(ea - eb).max()) / scale
    check(d <= rel, f"{what}: embeddings {d:.2e} of their scale apart")
    va = np.stack(a["visibility_scores"].to_numpy())
    vb = np.stack(b["visibility_scores"].to_numpy())
    check(np.abs(va - vb).max() <= rel, f"{what}: visibility differs")
    return d


def _dancetrack_tree(torch, dev, root, n_frames, wh=(1920, 1080),
                     n_objects=24):
    """A DanceTrack-layout validation split under ``root``: one sequence of
    ``n_frames`` lossless PNG frames of ``wh`` (phase 17's smooth texture
    panning by (+2, -1) px per frame), its seqinfo.ini (imExt .png) and a
    gt.txt of the synthetic set's boxes at that size. Returns the frames
    (RGB uint8, on the host)."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    w, h = wh
    seq = root / "DanceTrack" / "val" / "dancetrack0001"
    (seq / "img1").mkdir(parents=True)
    (seq / "gt").mkdir()
    (seq / "seqinfo.ini").write_text(
        f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=20\n"
        f"seqLength={n_frames}\nimWidth={w}\nimHeight={h}\nimExt=.png\n")
    video = panning_video(torch, dev, n_frames, (h, w)).cpu().numpy()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda f: cv2.imwrite(
            str(seq / "img1" / f"{f + 1:06d}.png"), video[f][..., ::-1],
            [cv2.IMWRITE_PNG_COMPRESSION, 1]), range(n_frames)))
    gt = make_synthetic_set(n_videos=1, n_frames=n_frames,
                            n_objects=n_objects, seed=3, img_w=w,
                            img_h=h).detections_gt
    (seq / "gt" / "gt.txt").write_text("".join(
        f"{f},{t},{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},{b[3]:.3f},1,1,1.0\n"
        for f, t, b in zip(gt["frame"], gt["track_id"], gt["bbox_ltwh"])))
    return video


def _iou_ltwh(a, b):
    """(n, 4) x (m, 4) ltwh boxes -> (n, m) IoU; two boxes of zero area (a
    pose box whose keypoints lie beyond the frame's edge, clipped to it)
    have IoU 1 where they lie within 1e-3 of each other, else 0."""
    a_lo, a_hi = a[:, None, :2], a[:, None, :2] + a[:, None, 2:]
    b_lo, b_hi = b[None, :, :2], b[None, :, :2] + b[None, :, 2:]
    inter = np.clip(np.minimum(a_hi, b_hi) - np.maximum(a_lo, b_lo), 0,
                    None).prod(-1)
    area = a[:, None, 2:].prod(-1) + b[None, :, 2:].prod(-1) - inter
    same = np.abs(a[:, None, :] - b[None, :, :]).max(-1) <= 1e-3
    return np.where(area > 1e-9, inter / np.maximum(area, 1e-9),
                    same.astype(float))


def _match_prefix(card, cpu, image_ids):
    """The detection rows of ``image_ids`` of two runs matched frame by
    frame by IoU (Hungarian on 1 - IoU, pairs of IoU >= 0.5 kept): counts of
    rows, matched rows and of matched rows tracked in both, the smallest
    IoU of a match, and the matched rows whose track ids differ."""
    from scipy.optimize import linear_sum_assignment

    out = dict(card_rows=0, cpu_rows=0, matched=0, tracked_in_both=0,
               tracked_in_one=0, other_track_ids=0, min_iou=1.0)
    for iid in image_ids:
        a = card[card["image_id"] == iid]
        b = cpu[cpu["image_id"] == iid]
        out["card_rows"] += len(a)
        out["cpu_rows"] += len(b)
        if not len(a) or not len(b):
            continue
        iou = _iou_ltwh(np.stack(a["bbox_ltwh"].to_numpy()),
                        np.stack(b["bbox_ltwh"].to_numpy()))
        r, c = linear_sum_assignment(-iou)
        keep = iou[r, c] >= 0.5
        r, c = r[keep], c[keep]
        out["matched"] += len(r)
        if len(r):
            out["min_iou"] = min(out["min_iou"], float(iou[r, c].min()))
        ta = a["track_id"].to_numpy(float)[r]
        tb = b["track_id"].to_numpy(float)[c]
        both = ~np.isnan(ta) & ~np.isnan(tb)
        out["tracked_in_both"] += int(both.sum())
        out["tracked_in_one"] += int((np.isnan(ta) != np.isnan(tb)).sum())
        out["other_track_ids"] += int((ta[both] != tb[both]).sum())
    return out


def _pan_error(warps, wh, drift=(2, -1)):
    """The largest distance, over the frame's four corners, between where
    each warp after the first maps a corner and where the pan moves it; and
    whether the first warp is the identity."""
    w, h = wh
    corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]],
                       np.float64)
    want = corners[:, :2] + np.asarray(drift, np.float64)
    err = max(float(np.linalg.norm(corners @ np.asarray(W, np.float64).T
                                   - want, axis=1).max()) for W in warps[1:])
    return err, bool(np.array_equal(warps[0], np.eye(2, 3)))


def phase_cli_reid(torch, dev, card, n_frames=150, n_objects=24,
                   tree_frames=96, prefix_frames=16, keep=None):
    """The port's ReID configurations through ``tracklab_torch.main.main``
    in this process.

    (a) Fused against staged at full width: synthetic 2 videos x
    ``n_frames`` x ``n_objects`` rendered at 640 x 640 (the letterbox is the
    identity) -> yolox.yaml (YOLOX-s 640 f32, batch 8, max_dets 64,
    thresholds calibrated by ``_calibrate_cli``) -> osnet_batched.yaml
    (OSNet x1_0, 512-d, 6 parts, 256 x 128; work_size 640 x 640, 64 slots,
    batch 8 as the detector's) -> strong_sort.yaml, with engine.fused true
    and false: the same rows, boxes, embeddings (within rel 1e-3 of their
    scale) and track ids; K3 and K1 launched; 0 host syncs inside the fused
    program; each run's frames/s and its split printed.
    (b) ``+experiment=dancetrack_strongsort`` on a DanceTrack-layout tree
    written to a temporary directory (1 sequence x ``tree_frames`` lossless
    PNG frames at 1920 x 1080, phase 17's texture panning by (+2, -1) px
    per frame, gt.txt from the synthetic boxes), first as typed with no
    other override (it must run on the card), then with the thresholds
    calibrated, staged with the
    detection-level OSNetReId (host crops): K3 and K1 launched, HOTA
    printed (random weights: no tracking result); the first
    ``prefix_frames`` frames rerun with device=cpu, detections matched by
    IoU, track ids equal on the matched rows.
    (c) The same tree with pipeline [bbox_detector, reid, cmc, track],
    sparse_opt_flow.yaml with method lk_jax (the LK of motion/lk.py on the
    card, downscale 2), first deep_oc_sort.yaml, then bot_sort.yaml: every
    gmc_warp within 0.5 px of the pan at the frame's corners, K1 launched
    in both runs and ORU-NKF in Deep-OC-SORT's. ``keep``, a dict, receives
    (a)'s arguments and its staged run's rows under "cli_reid_staged"."""
    import shutil
    import tempfile
    from pathlib import Path

    stats = {}
    det_thr, _ = _calibrate_cli(torch, dev, n_objects, img_wh=(640, 640))
    log(f"cli_reid (a): calibrated min_confidence {det_thr}")
    args = ["use_rich=false", f"device={dev.type}",
            "pipeline=[bbox_detector,reid,track]",
            "+modules/bbox_detector=yolox", "+modules/reid=osnet_batched",
            "modules.reid.work_size=[640,640]", "modules.reid.max_dets=64",
            "modules.reid.batch_size=8", "modules/track=strong_sort",
            f"modules.bbox_detector.min_confidence={det_thr}",
            f"modules.track.min_confidence={det_thr}",
            "dataset.n_videos=2", f"dataset.n_frames={n_frames}",
            f"dataset.n_objects={n_objects}", "dataset.img_w=640",
            "dataset.img_h=640"]
    runs = {}
    for fused in (True, False):
        name = "fused" if fused else "staged"
        parts, res, launches, split = _cli_run(
            torch, args + [f"engine.fused={str(fused).lower()}"],
            ("loader", "program", "eval") if fused
            else ("loader", "detect", "embed", "scan", "eval"))
        pred = parts["tracker_state"].detections_pred
        runs[fused] = pred
        mean_dets = len(pred) / split["frames"]
        log(f"cli_reid (a) {name} on {card}: {split['frames']} frames, "
            f"{mean_dets:.2f} detections/frame, {split['fps']:.2f} frames/s "
            f"of track_dataset ({split['track_dataset_s']:.2f} s: loader "
            f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
            f"DataFrames and host {split['dataframes_and_host_s']:.2f}; "
            f"eval {split['eval_s']:.2f}); launches {launches}; host syncs "
            f"in the fused program {split['host_syncs_in_fused_program']}")
        check(10 <= mean_dets <= 64,
              f"cli_reid (a): {mean_dets:.2f} detections per frame")
        for k in ("K3", "K1"):
            check(launches[k] > 0, f"cli_reid (a) {name}: {k} never "
                  "launched")
        if fused:
            check(split["fused_program_frames"] >= split["frames"],
                  "cli_reid (a): the fused program did not run")
            check(split["host_syncs_in_fused_program"] == 0,
                  f"cli_reid (a): {split['host_syncs_in_fused_program']} "
                  "host syncs inside the fused program")
        stats[name] = dict(split, detections_per_frame=mean_dets,
                           launches=launches,
                           HOTA=res["COMBINED_SEQ"]["HOTA"])
    _same_rows(runs[True], runs[False], "cli_reid (a) fused vs staged")
    d = _same_embeddings(runs[True], runs[False],
                         "cli_reid (a) fused vs staged")
    tracked = int(runs[True]["track_id"].notna().sum())
    log(f"cli_reid (a): fused equals staged ({len(runs[True])} rows, "
        f"{tracked} tracked, embeddings within {d:.2e} of their scale)")
    stats["fused_vs_staged"] = dict(rows=len(runs[True]), tracked=tracked,
                                    embedding_rel_diff=d)
    if keep is not None:
        keep["cli_reid_staged"] = (args, runs[False], stats["staged"]["fps"])

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dancetrack_"))
    try:
        t0 = time.perf_counter()
        video = _dancetrack_tree(torch, dev, tmp, tree_frames)
        log(f"cli_reid (b): wrote {tree_frames} PNG frames of 1920 x 1080 "
            f"in {time.perf_counter() - t0:.1f} s")
        # the command as a user types it, with no other override
        bare = ["+experiment=dancetrack_strongsort", f"data_dir={tmp}"]
        parts, res, launches, split = _cli_run(
            torch, bare, ("loader", "detect", "reid", "scan", "eval"))
        rows = len(parts["tracker_state"].detections_pred)
        log(f"cli_reid (b) {' '.join(bare)} on {card}: {split['frames']} "
            f"frames, {rows / split['frames']:.2f} detections/frame, "
            f"{split['fps']:.2f} frames/s; launches {launches}")
        check(rows > 0 and launches["K3"] > 0 and launches["K1"] > 0,
              "cli_reid (b): the bare experiment command did not run its "
              "detector and tracker on the card")
        stats["experiment_bare"] = dict(split, launches=launches,
                                        detections=rows)
        det_thr, birth_thr = _calibrate_cli(torch, dev, n_objects,
                                            frames=list(video[:8]))
        exp = ["use_rich=false", "+experiment=dancetrack_strongsort",
               f"data_dir={tmp}",
               f"modules.bbox_detector.min_confidence={det_thr}",
               f"modules.track.min_confidence={det_thr}"]
        parts, res, launches, split = _cli_run(
            torch, exp + [f"device={dev.type}"],
            ("loader", "detect", "reid", "scan", "eval"))
        card_pred = parts["tracker_state"].detections_pred
        c = res["COMBINED_SEQ"]
        log(f"cli_reid (b) +experiment=dancetrack_strongsort on {card}: "
            f"{split['frames']} frames, {len(card_pred) / split['frames']:.2f}"
            f" detections/frame, {split['fps']:.2f} frames/s of "
            f"track_dataset ({split['track_dataset_s']:.2f} s: loader "
            f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
            f"DataFrames and host {split['dataframes_and_host_s']:.2f}; eval "
            f"{split['eval_s']:.2f}); HOTA {c['HOTA']:.3f} with random "
            f"weights (not a tracking result); launches {launches}")
        for k in ("K3", "K1"):
            check(launches[k] > 0, f"cli_reid (b): {k} never launched")
        stats["experiment"] = dict(split, launches=launches, HOTA=c["HOTA"],
                                   min_confidence=det_thr)
        cpu_parts, _, _, cpu_split = _cli_run(
            torch, exp + ["device=cpu", f"dataset.nframes={prefix_frames}"],
            ("loader", "detect", "reid", "scan", "eval"))
        cpu_pred = cpu_parts["tracker_state"].detections_pred
        m = _match_prefix(card_pred, cpu_pred,
                          cpu_parts["tracker_state"].image_metadatas.index)
        log(f"cli_reid (b): the first {prefix_frames} frames on the card "
            f"against device=cpu ({cpu_split['fps']:.2f} frames/s): {m}")
        check(m["matched"] > 0 and m["tracked_in_both"] > 0,
              "cli_reid (b): no tracked detection matched the CPU run's")
        check(m["other_track_ids"] == 0 and m["tracked_in_one"] == 0,
              f"cli_reid (b): card and CPU tracks differ on matched rows: "
              f"{m}")
        stats["experiment"]["cpu_prefix"] = dict(m, cpu_fps=cpu_split["fps"])

        for tracker in ("deep_oc_sort", "bot_sort"):
            extra = ([f"modules.track.track_high_thresh={birth_thr}",
                      f"modules.track.new_track_thresh={birth_thr}"]
                     if tracker == "bot_sort" else [])
            parts, res, launches, split = _cli_run(
                torch, exp + [f"device={dev.type}",
                              "pipeline=[bbox_detector,reid,cmc,track]",
                              "+modules/cmc=sparse_opt_flow",
                              "modules.cmc.method=lk_jax",
                              f"modules/track={tracker}"] + extra,
                ("loader", "detect", "reid", "camera", "scan", "eval"))
            st = parts["tracker_state"]
            warps = np.stack(st.image_pred.sort_values("frame")["gmc_warp"]
                             .to_numpy())
            err, first_identity = _pan_error(warps, (1920, 1080))
            tracked = int(st.detections_pred["track_id"].notna().sum())
            log(f"cli_reid (c) {tracker} with camera motion (LK on the "
                f"card, downscale 2) on {card}: {split['fps']:.2f} frames/s "
                f"({split['track_dataset_s']:.2f} s: loader "
                f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
                f"camera motion {split['camera_s']:.2f}, DataFrames and host "
                f"{split['dataframes_and_host_s']:.2f}); {tracked} tracked "
                f"rows; warps within {err:.4f} px of the pan at the "
                f"corners; launches {launches}")
            check(first_identity, "cli_reid (c): the first warp is not the "
                  "identity")
            check(err <= 0.5, f"cli_reid (c) {tracker}: a warp {err:.4f} px "
                  "off the pan")
            check(tracked > 0, f"cli_reid (c) {tracker}: nothing tracked")
            check(launches["K1"] > 0, f"cli_reid (c) {tracker}: K1 never "
                  "launched")
            if tracker == "deep_oc_sort":
                check(launches["ORU-NKF"] > 0, "cli_reid (c): ORU-NKF "
                      "never launched")
            stats[tracker] = dict(split, launches=launches,
                                  pan_error_px=err, tracked_rows=tracked)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return stats


# -------------------------------------------------------- phase engines
class _ModuleCalls:
    """Calls, seconds (synchronised around each call) and host syncs (sync
    debug mode) of some modules' methods during a run: ``methods`` maps a
    name to (the class that defines the method, its name)."""

    def __init__(self, torch, methods):
        self.torch = torch
        self.methods = methods
        self.stats = {n: dict(calls=0, s=0.0, syncs=0, max_syncs=0)
                      for n in methods}

    def __enter__(self):
        self.saved = {n: getattr(c, a) for n, (c, a) in self.methods.items()}
        for n, (c, a) in self.methods.items():
            setattr(c, a, self._wrap(self.stats[n], self.saved[n]))
        return self

    def __exit__(self, *exc):
        for n, (c, a) in self.methods.items():
            setattr(c, a, self.saved[n])
        return False

    def _wrap(self, st, orig):
        torch = self.torch

        def call(*a, **kw):
            out, dt, n = _timed_sync_count(torch, orig, *a, **kw)
            st["calls"] += 1
            st["s"] += dt
            st["syncs"] += n
            st["max_syncs"] = max(st["max_syncs"], n)
            return out
        return call


def _write_mp4(torch, dev, path, n_frames, n_objects, wh=(1920, 1080)):
    """An mp4 (cv2.VideoWriter, mp4v, 30 fps) of ``n_frames`` frames of
    ``wh``: phase 17's smooth texture panning by (+2, -1) px per frame with
    the ``n_objects`` moving boxes of a synthetic set painted on it, each
    track in its own colour."""
    import cv2

    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    w, h = wh
    video = panning_video(torch, dev, n_frames, (h, w)).cpu().numpy()
    gt = make_synthetic_set(n_videos=1, n_frames=n_frames,
                            n_objects=n_objects, seed=4, img_w=w,
                            img_h=h).detections_gt
    for f, t, b in zip(gt["frame"], gt["track_id"], gt["bbox_ltwh"]):
        x1, y1 = max(int(b[0]), 0), max(int(b[1]), 0)
        x2, y2 = min(int(b[0] + b[2]), w), min(int(b[1] + b[3]), h)
        if x2 > x1 and y2 > y1:
            video[f - 1, y1:y2, x1:x2] = (40 + (t * 53) % 200,
                                          40 + (t * 101) % 200,
                                          240 - (t * 37) % 200)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
    try:
        for frame in video:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
    finally:
        writer.release()
    return video


def _frames_of(parts):
    """A run's detection rows and each row's frame number."""
    st = parts["tracker_state"]
    pred = st.detections_pred
    return pred, st.image_pred["frame"].reindex(pred["image_id"]).to_numpy()


def _same_detections(a, b, what, min_iou=0.999):
    """Two runs' detections frame by frame (each ``_frames_of``): the same
    number in every frame, matched one to one (Hungarian on IoU) with IoU
    >= ``min_iou``. Returns (rows, the smallest IoU of a match)."""
    from scipy.optimize import linear_sum_assignment

    (pa, fa), (pb, fb) = a, b
    rows, lo = 0, 1.0
    for f in np.union1d(fa, fb):
        ba = pa["bbox_ltwh"].to_numpy()[fa == f]
        bb = pb["bbox_ltwh"].to_numpy()[fb == f]
        check(len(ba) == len(bb), f"{what}: frame {f} has {len(ba)} and "
              f"{len(bb)} detections")
        if not len(ba):
            continue
        iou = _iou_ltwh(np.stack(ba), np.stack(bb))
        r, c = linear_sum_assignment(-iou)
        rows += len(r)
        lo = min(lo, float(iou[r, c].min()))
    check(rows > 0, f"{what}: no detections")
    check(lo >= min_iou, f"{what}: a detection matched at IoU {lo:.6f}")
    return rows, lo


def _tracks_equal_process(parts, what):
    """A run's track columns against its tracker's ``process`` over the
    run's own detections (track columns dropped), id for id; returns the
    tracked rows."""
    st = parts["tracker_state"]
    pred = st.detections_pred
    want = parts["modules"][-1].process(
        pred.drop(columns=["track_id", "track_bbox_ltwh",
                           "track_bbox_conf"]), st.image_pred).sort_index()
    got = pred[pred["track_id"].notna()].sort_index()
    check(len(want) > 0, f"{what}: process() tracked nothing")
    check(got.index.equals(want.index), f"{what}: {len(got)} tracked rows "
          f"against process()'s {len(want)}")
    check(np.array_equal(got["track_id"].to_numpy(float),
                         want["track_id"].to_numpy(float)),
          f"{what}: track ids differ from process()'s")
    d = float(np.abs(np.stack(got["track_bbox_ltwh"].to_numpy())
                     - np.stack(want["track_bbox_ltwh"].to_numpy())).max())
    check(d <= 1e-3, f"{what}: track boxes {d} from process()'s")
    return len(want)


def phase_engines(torch, dev, card, keep, n_videos=8, n_frames=100,
                  n_objects=24, file_frames=100, reid_frames=100,
                  vis_frames=50, k1_keep=16, cfg5_frames=100):
    """The batched, online and pipelined engines through
    ``tracklab_torch.main.main`` in this process.

    (a) BASELINE config 5, ``+experiment=batched_8videos`` with
    ``dataset.n_videos`` 8, ``cfg5_frames`` frames a video (synthetic.yaml
    has 100) and the quick start's ground truth: HOTA 100.0,
    rows equal to the offline engine's; then with ``pipeline=[bbox_detector,
    track]`` and yolox.yaml on ``n_videos`` x ``n_frames`` synthetic frames
    of 640 x 640 (thresholds calibrated by ``_calibrate_cli``): rows and
    track ids equal to the offline engine's staged run; each run's frames/s
    and tracker-stage seconds (one V-axis scan against V per-video scans),
    0 host syncs inside the scans; the V-axis scan's K1 inputs recorded and
    the last ``k1_keep`` solving launches held to the plain solver
    (``_k1_on_path``); 16 steps over its recorded frames profiled, over
    the V videos and over one.
    (b) ``engine=video`` with ``dataset=external_video`` on an mp4 of 1920
    x 1080 the script writes (``_write_mp4``): YOLOX-s (batch 1) ->
    OC-SORT over ``file_frames`` frames, then YOLOX-s -> OSNet (osnet.yaml,
    host crops) -> StrongSORT over the first ``reid_frames``: tracks equal
    to the tracker's ``process`` over the run's own detections, detections
    within IoU 0.999 of the offline engine's staged run on the same file;
    frames/s of a plain run, after an instrumented run (``_ModuleCalls``)
    for each module's ms and host syncs per frame (the tracker's <= 1).
    (c) ``engine=pipelined`` on phase cli's (b) and phase cli_reid's (a)
    configurations (``keep``, from those phases): rows equal to their
    staged runs; frames/s beside the staged runs'.
    (d) (a)'s detector configuration on one video cut to ``vis_frames``,
    with ``visualization=save_videos`` and TorchProfiler enabled: the mp4
    has ``vis_frames`` frames; the trace names K1's and K3's kernels.
    Returns (stats, launches per run)."""
    import json
    import shutil
    import tempfile
    from pathlib import Path

    import cv2

    import tracklab_torch.trackers.ocsort as OC
    from tracklab_torch.trackers.common import Detections, repeat_state
    from tracklab_torch.wrappers.bbox_detector.yolox_api import YOLOXDetector
    from tracklab_torch.wrappers.reid.osnet_api import OSNetReId
    from tracklab_torch.wrappers.track.scan_tracker import _ScanTrackerBase

    stats, runs_launches = {}, {}

    def run(name, args, timed, split=True):
        parts, res, launches, sp = _cli_run(torch, args, timed, split)
        runs_launches[f"engines_{name}"] = launches
        stats[name] = dict(sp, launches=launches)
        return parts, res, launches, sp

    # (a) BASELINE config 5 as typed
    cfg5 = ["use_rich=false", f"device={dev.type}",
            "+experiment=batched_8videos", f"dataset.n_videos={n_videos}",
            f"dataset.n_frames={cfg5_frames}", GT_OVERRIDE]
    preds = {}
    for name, args in (("config5_batched", cfg5),
                       ("config5_offline", [a for a in cfg5 if a !=
                                            "+experiment=batched_8videos"])):
        parts, res, launches, sp = run(name, args, ("scan", "eval"))
        preds[name] = parts["tracker_state"].detections_pred
        c = res["COMBINED_SEQ"]
        stats[name]["HOTA"] = c["HOTA"]
        log(f"engines (a) {name} on {card}: {sp['frames']} frames, "
            f"{sp['fps']:.2f} frames/s of track_dataset "
            f"({sp['track_dataset_s']:.2f} s; tracker scans "
            f"{sp['tracker_scan_s']:.2f} s, {sp['host_syncs_in_scans']} host "
            f"syncs in them); HOTA {c['HOTA']}; launches {launches}")
        check(c["HOTA"] == 100.0, f"engines (a) {name}: HOTA {c['HOTA']}")
        check(sp["host_syncs_in_scans"] == 0, f"engines (a) {name}: "
              f"{sp['host_syncs_in_scans']} host syncs in the scans")
        for k in ("K1", "ORU"):
            check(launches[k] > 0, f"engines (a) {name}: {k} never launched")
    _same_rows(preds["config5_batched"], preds["config5_offline"],
               "engines (a) config 5, batched vs offline")
    keep["config5_batched"] = (cfg5, preds["config5_batched"])
    log("engines (a): config 5 as typed equals the offline engine")

    # (a) config 5 with the detector
    det_thr, birth_thr = _calibrate_cli(torch, dev, n_objects,
                                        img_wh=(640, 640))
    det = ["use_rich=false", f"device={dev.type}",
           "pipeline=[bbox_detector,track]", "+modules/bbox_detector=yolox",
           f"modules.bbox_detector.min_confidence={det_thr}",
           f"modules.track.min_confidence={det_thr}",
           f"modules.track.det_thresh={birth_thr}",
           f"dataset.n_videos={n_videos}", f"dataset.n_frames={n_frames}",
           f"dataset.n_objects={n_objects}", "dataset.img_w=640",
           "dataset.img_h=640"]
    recorded, scans = {}, {}
    scan_videos = OC.ocsort_scan_videos

    def recording(cfg, dets):
        # each run's scans by their number of videos; the V-axis scan's
        # inputs kept for K1
        scans[name].append(dets.ltrb.shape[0])
        if dets.ltrb.shape[0] == n_videos:
            recorded["cfg"] = cfg
            recorded["dets"] = Detections(*(x.clone() for x in dets))
        return scan_videos(cfg, dets)

    OC.ocsort_scan_videos = recording
    try:
        for name, args in (("detector_batched",
                            det + ["+experiment=batched_8videos"]),
                           ("detector_offline", det)):
            scans[name] = []
            parts, res, launches, sp = run(
                name, args, ("loader", "detect", "scan", "eval"))
            preds[name] = parts["tracker_state"].detections_pred
            per_frame = len(preds[name]) / sp["frames"]
            log(f"engines (a) {name} on {card}: {sp['frames']} frames, "
                f"{per_frame:.2f} detections/frame, {sp['fps']:.2f} "
                f"frames/s of track_dataset ({sp['track_dataset_s']:.2f} s: "
                f"loader {sp['loader_s']:.2f}, device {sp['device_s']:.2f} "
                f"of which tracker scans {sp['tracker_scan_s']:.2f} with "
                f"{sp['host_syncs_in_scans']} host syncs, DataFrames and "
                f"host {sp['dataframes_and_host_s']:.2f}); launches "
                f"{launches}")
            stats[name]["detections_per_frame"] = per_frame
            check(10 <= per_frame <= 64, f"engines (a) {name}: "
                  f"{per_frame:.2f} detections per frame")
            check(sp["host_syncs_in_scans"] == 0, f"engines (a) {name}: "
                  f"{sp['host_syncs_in_scans']} host syncs in the scans")
            for k in ("K3", "K1", "ORU"):
                check(launches[k] > 0, f"engines (a) {name}: {k} never "
                      "launched")
    finally:
        OC.ocsort_scan_videos = scan_videos
    check(scans == {"detector_batched": [n_videos],
                    "detector_offline": [1] * n_videos},
          f"engines (a): videos per scan {scans}, not one scan of "
          f"{n_videos} batched and {n_videos} of 1 offline")
    _same_rows(preds["detector_batched"], preds["detector_offline"],
               "engines (a) detector, batched vs offline")
    cfg, dets = recorded["cfg"], recorded["dets"]
    frames = [Detections(*(x[:, f] for x in dets))
              for f in range(dets.ltrb.shape[1])]
    stats["k1_on_the_v_axis_scan"] = _k1_on_path(
        torch, partial(OC.ocsort_step, cfg),
        repeat_state(OC.ocsort_init(cfg, device=dev), n_videos), frames,
        n_keep=k1_keep, what="the batched engine's V-axis scan")
    # the default mode's step over the video axis (stacked K1) against one
    # video's, on the same recorded frames: up to 64 steps unprofiled,
    # PROFILED_STEPS profiled
    profiles = {}
    lo = max(min(64, n_frames - PROFILED_STEPS), 0)
    for v in (n_videos, 1):
        fr = [Detections(*(x[:v] for x in d))
              for d in frames[:lo + PROFILED_STEPS]]
        st = repeat_state(OC.ocsort_init(cfg, device=dev), v)
        for d in fr[:lo]:
            st, _ = OC.ocsort_step(cfg, st, d)

        def steps(st=st, fr=fr):
            for d in fr[lo:]:
                st, _ = OC.ocsort_step(cfg, st, d)
        profiles[f"V={v}"] = profile_window(torch, steps, len(fr) - lo,
                                            kernel="jv_warp")
        p = profiles[f"V={v}"]
        log(f"engines (a): the OC-SORT step over V = {v} (frames {lo}-"
            f"{len(fr) - 1} of the batched run's inputs) on {card}: host "
            f"{p['host_ms_per_frame']:.2f} ms, device "
            f"{p['device_ms_per_frame']:.3f} ms, "
            f"{p['launches_per_frame']:.1f} launches and "
            f"{p['jv_warp']['launches_per_frame']:.1f} K1 launches per step, "
            f"device idle {p['device_idle_share']:.3f}")
    stats["v_axis_step_profile"] = profiles
    log(f"engines (a): config 5 with YOLOX-s equals the offline engine's "
        f"staged run ({len(preds['detector_batched'])} rows); tracker stage "
        f"{stats['detector_batched']['tracker_scan_s']:.2f} s for one V = "
        f"{n_videos} scan against "
        f"{stats['detector_offline']['tracker_scan_s']:.2f} s for "
        f"{n_videos} per-video scans")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_engines_"))
    try:
        # (b) the online engine on a file
        t0 = time.perf_counter()
        clips = {}
        for n in sorted({file_frames, reid_frames}):
            (tmp / f"clip{n}").mkdir()
            clips[n] = tmp / f"clip{n}" / "scene.mp4"
            video = _write_mp4(torch, dev, clips[n], n, n_objects)
        log(f"engines (b): wrote {len(clips)} mp4 files of 1920 x 1080 in "
            f"{time.perf_counter() - t0:.1f} s")
        f_thr, f_birth = _calibrate_cli(torch, dev, n_objects,
                                        frames=list(video[:8]))
        for name, n, extra in (
                ("online_ocsort", file_frames, []),
                ("online_strongsort", reid_frames,
                 ["pipeline=[bbox_detector,reid,track]",
                  "+modules/reid=osnet", "modules/track=strong_sort"])):
            base = (["use_rich=false", f"device={dev.type}",
                     "dataset=external_video",
                     f"dataset.video_path={clips[n]}",
                     "pipeline=[bbox_detector,track]",
                     "+modules/bbox_detector=yolox",
                     f"modules.bbox_detector.min_confidence={f_thr}",
                     f"modules.track.min_confidence={f_thr}"] + extra
                    + ([] if extra else
                       [f"modules.track.det_thresh={f_birth}"]))
            online_args = base + ["engine=video",
                                  "modules.bbox_detector.batch_size=1"]
            # first a run with each module synchronised around its calls
            # and its host syncs counted (its frames/s is not the engine's;
            # it also takes the detector's first calls at batch 1), then
            # the engine's own run
            methods = {"detector": (YOLOXDetector, "process"),
                       "tracker": (_ScanTrackerBase, "process_online")}
            if extra:
                methods["reid"] = (OSNetReId, "process")
            with _ModuleCalls(torch, methods) as calls:
                _, _, _, i_sp = _cli_run(torch, online_args, (), split=False)
            per = {k: dict(v, syncs_per_frame=v["syncs"] / i_sp["frames"],
                           ms_per_frame=v["s"] * 1e3 / i_sp["frames"])
                   for k, v in calls.stats.items()}
            parts, _, launches, sp = run(name, online_args, (), split=False)
            stats[name].update(modules=per, instrumented_fps=i_sp["fps"])
            tracked = _tracks_equal_process(parts, f"engines (b) {name}")
            online = _frames_of(parts)
            staged, _, s_launches, s_sp = run(
                f"{name}_staged", base, ("loader", "detect", "scan"))
            rows, lo = _same_detections(online, _frames_of(staged),
                                        f"engines (b) {name}, online vs "
                                        "staged")
            stats[name].update(tracked_rows=tracked, rows=rows,
                               min_iou_vs_staged=lo,
                               staged_fps=s_sp["fps"])
            log(f"engines (b) {name} on {card}: {sp['frames']} frames, "
                f"{rows / sp['frames']:.2f} detections/frame, "
                f"{sp['fps']:.2f} frames/s online (staged offline "
                f"{s_sp['fps']:.2f}); tracks equal process() on the run's "
                f"own detections ({tracked} rows); detections within IoU "
                f"{lo:.6f} of the staged run's; instrumented run "
                f"{i_sp['fps']:.2f} frames/s, per module "
                + "; ".join(f"{k} {v['ms_per_frame']:.2f} ms and "
                            f"{v['syncs_per_frame']:.2f} host syncs per "
                            f"frame (max {v['max_syncs']} in a call)"
                            for k, v in per.items())
                + f"; launches {launches}")
            check(per["tracker"]["syncs_per_frame"] <= 1, f"engines (b) "
                  f"{name}: {per['tracker']['syncs_per_frame']:.3f} host "
                  "syncs per frame in the tracker")
            for k in ("K3", "K1"):
                check(launches[k] > 0, f"engines (b) {name}: {k} never "
                      "launched")

        # (c) the pipelined engine on phase cli's and cli_reid's runs
        for name, key, timed in (("pipelined_cli", "cli_staged", ()),
                                 ("pipelined_cli_reid", "cli_reid_staged",
                                  ())):
            args, staged, staged_fps = keep[key]
            parts, _, launches, sp = run(name, args + ["engine=pipelined"],
                                         timed, split=False)
            _same_rows(parts["tracker_state"].detections_pred, staged,
                       f"engines (c) {name} vs staged")
            stats[name]["staged_fps"] = staged_fps
            log(f"engines (c) {name} on {card}: {sp['frames']} frames, "
                f"{sp['fps']:.2f} frames/s of track_dataset against the "
                f"staged run's {staged_fps:.2f}; rows equal to the staged "
                f"run's; launches {launches}")
            for k in ("K3", "K1"):
                check(launches[k] > 0, f"engines (c) {name}: {k} never "
                      "launched")

        # (d) visualization and the profiler
        vis = [a for a in det + ["+experiment=batched_8videos"]
               if not a.startswith(("dataset.n_videos", "dataset.n_frames"))]
        parts, _, launches, sp = run("visualization_profiler", vis + [
            "dataset.n_videos=1", f"dataset.n_frames={vis_frames}",
            "visualization=save_videos",
            f"visualization.save_folder={tmp / 'visuals'}",
            "+callbacks.profiler={_target_: tracklab_torch.callbacks."
            f"TorchProfiler, enabled: true, trace_dir: {tmp / 'trace'}}}"],
            ("loader", "detect", "scan"))
        mp4 = next((tmp / "visuals").glob("*.mp4"))
        cap = cv2.VideoCapture(str(mp4))
        n_rendered = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        prof = next(c for c in parts["callbacks"]
                    if type(c).__name__ == "TorchProfiler")
        names = {str(e.get("name", "")) for e in json.loads(
            prof.trace_path.read_text())["traceEvents"]
            if e.get("cat") == "kernel"}
        k1 = sorted(n for n in names if "jv_warp" in n)
        k3 = sorted(n for n in names if "csp" in n)
        stats["visualization_profiler"].update(
            rendered_frames=n_rendered, k1_kernels=k1[:3], k3_kernels=k3[:3],
            trace_mb=prof.trace_path.stat().st_size / 2**20,
            kernel_names=len(names))
        log(f"engines (d) on {card}: {mp4.name} with {n_rendered} frames; "
            f"the trace ({stats['visualization_profiler']['trace_mb']:.1f} "
            f"MB, {len(names)} kernel names) names K1 {k1[:1]} and K3 "
            f"{k3[:1]}")
        check(n_rendered == vis_frames, f"engines (d): the mp4 has "
              f"{n_rendered} frames, not {vis_frames}")
        check(k1 and k3, "engines (d): the trace does not name K1's and "
              "K3's kernels")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return stats, runs_launches


# ------------------------------------------------------- phase baseline
GS_BOOTSTRAP = ("state.load_from_groundtruth={detection: [bbox_ltwh, "
                "bbox_conf, category_id, team_detection, team_confidence, "
                "role_detection, role_confidence, jersey_number_detection, "
                "jersey_number_confidence]}")


def _write_pngs(frames, folder):
    """RGB uint8 frames as lossless PNGs 000001.png .. in ``folder``."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    folder.mkdir(parents=True)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda f: cv2.imwrite(
            str(folder / f"{f + 1:06d}.png"), frames[f][..., ::-1],
            [cv2.IMWRITE_PNG_COMPRESSION, 1]), range(len(frames))))


def _mot17_tree(torch, dev, root, n_videos, n_frames, n_objects,
                wh=(1920, 1080)):
    """A MOT17-layout validation split under ``root``: ``n_videos``
    sequences of ``n_frames`` PNG frames of ``wh`` (phase 17's texture
    panning by (+2, -1) px per frame, a seed per sequence), their
    seqinfo.ini and a gt.txt of the synthetic set's boxes at that size.
    Returns the first sequence's first 8 frames."""
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    w, h = wh
    first = None
    for v in range(n_videos):
        seq = root / "MOT17" / "val" / f"MOT17-{2 * v + 2:02d}-FRCNN"
        video = panning_video(torch, dev, n_frames, (h, w),
                              seed=5 + v).cpu().numpy()
        _write_pngs(video, seq / "img1")
        (seq / "gt").mkdir()
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=30\n"
            f"seqLength={n_frames}\nimWidth={w}\nimHeight={h}\nimExt=.png\n")
        gt = make_synthetic_set(n_videos=1, n_frames=n_frames,
                                n_objects=n_objects, seed=3 + v, img_w=w,
                                img_h=h).detections_gt
        (seq / "gt" / "gt.txt").write_text("".join(
            f"{f},{t},{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},{b[3]:.3f},1,1,1.0\n"
            for f, t, b in zip(gt["frame"], gt["track_id"],
                               gt["bbox_ltwh"])))
        first = video[:8] if first is None else first
    return list(first)


def _gamestate_tree(torch, dev, root, n_frames, n_objects, wh=(1920, 1080)):
    """A SoccerNetGS-layout validation split under ``root``: one video of
    ``n_frames`` PNG frames of ``wh`` (the panning texture) and its
    Labels-GameState.json: image records, and object annotations from the
    synthetic game-state set (boxes, bbox_pitch through its camera, role,
    team and jersey)."""
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    w, h = wh
    vdir = root / "SoccerNetGS" / "valid" / "SNGS-0001"
    _write_pngs(panning_video(torch, dev, n_frames, (h, w),
                              seed=11).cpu().numpy(), vdir / "img1")
    gt = make_synthetic_set(n_videos=1, n_frames=n_frames,
                            n_objects=n_objects, seed=4, img_w=w, img_h=h,
                            game_state=True).detections_gt
    images = [{"image_id": f"1{f:06d}", "file_name": f"{f:06d}.png",
               "width": w, "height": h, "is_labeled": True}
              for f in range(1, n_frames + 1)]
    anns = [{"id": f"a{i}", "image_id": f"1{f:06d}", "track_id": int(t),
             "supercategory": "object", "category_id": 1,
             "bbox_image": {"x": float(b[0]), "y": float(b[1]),
                            "w": float(b[2]), "h": float(b[3])},
             "bbox_pitch": bp,
             "attributes": {"role": r, "team": tm, "jersey": str(j)}}
            for i, (f, t, b, bp, r, tm, j) in enumerate(zip(
                gt["frame"], gt["track_id"], gt["bbox_ltwh"],
                gt["bbox_pitch"], gt["role"], gt["team"],
                gt["jersey_number"]))]
    (vdir / "Labels-GameState.json").write_text(
        json.dumps({"images": images, "annotations": anns}))


class _SegmenterBeside:
    """``PitchLineDetector.process`` with its ``pitch_lines`` emitted as
    ``pitch_lines_seg``, so that TVCalibration reads the dataset's true
    lines while the segmenter still runs; counts the lines it found."""

    def __init__(self):
        from tracklab_torch.wrappers.calibration_api import PitchLineDetector
        self.cls, self.lines = PitchLineDetector, 0

    def __enter__(self):
        cls, orig = self.cls, self.cls.process
        self.saved = (orig, cls.output_columns)

        def process(module, batch, dets, metas):
            import pandas as pd
            out, rows = orig(module, batch, dets, metas)
            self.lines += sum(len(r["pitch_lines"]) for r in rows)
            return out, [pd.Series({"pitch_lines_seg": r["pitch_lines"]},
                                   name=r.name) for r in rows]
        cls.process = process
        cls.output_columns = {"image": ["pitch_lines_seg"], "detection": []}
        return self

    def __exit__(self, *exc):
        self.cls.process, self.cls.output_columns = self.saved
        return False


def _pitchseg_vs_plain(torch, dev, n_frames=8):
    """PitchLineDetector's segmenter (PitchSegNet-s at 288 x 512, seeded)
    on ``n_frames`` textured frames (the panning texture at 1920 x 1080,
    resized as the module does) on the card, routed as on the path and
    with every CSPLayer plain (``_plain_csp``): each layer K3 takes (dark3
    at 36 x 64, dark4 at 18 x 32) within phase_k3's f32 rel 1e-4 of its
    plain layer on the same input; the logits within the same rel; the
    class maps equal wherever the plain logits' top two are further apart
    than twice the largest logit gap, and ``extract_segment_points`` equal
    for every (frame, class) whose pixels agree; ms per batch; the outputs'
    shapes against the CPU port."""
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.models.segmentation import extract_segment_points
    from tracklab_torch.models.yolox import CSP_MAX_PIXELS, CSPLayer
    from tracklab_torch.wrappers.calibration_api import PitchLineDetector

    det = PitchLineDetector(device=dev)
    video = panning_video(torch, dev, n_frames, (1080, 1920),
                          seed=13).cpu().numpy()
    frames = np.stack([det.preprocess(f, None, None)["image"]
                       for f in video])
    x = torch.from_numpy(frames).to(dev)
    det._build()
    model, C = det._model, det.num_classes
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: seen.append((name, mod, inp[0], out)))
        for name, m in model.named_modules() if isinstance(m, CSPLayer)]
    before = fused_csplayer.launches
    try:
        with torch.no_grad():
            logits = model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    launched = fused_csplayer.launches - before
    k3 = [(f"{name} {inp.shape[2]}x{inp.shape[3]}", mod, inp, out)
          for name, mod, inp, out in seen
          if not mod.depthwise and inp.shape[2] * inp.shape[3]
          <= CSP_MAX_PIXELS]
    check(launched == len(k3) > 0, f"PitchSegNet: {launched} K3 launches "
          f"for {len(k3)} layers of <= {CSP_MAX_PIXELS} px")
    with torch.no_grad():
        layer_rel = {name: _rel(out, mod.forward_plain(inp))
                     for name, mod, inp, out in k3}
        with _plain_csp():
            plain = model(x)
    torch.cuda.synchronize()
    logit_rel = _rel(logits, plain)
    gap = (logits - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    cm = logits.argmax(-1).to(torch.int32)
    cm_plain = plain.argmax(-1).to(torch.int32)
    differ = cm != cm_plain
    unexplained = int((differ & (margin > 2 * gap)).sum())
    xy, valid = extract_segment_points(cm, C, det.points_per_line)
    xy_p, valid_p = extract_segment_points(cm_plain, C,
                                           det.points_per_line)
    classes = torch.arange(1, C, device=dev, dtype=torch.int32)
    same_px = ((cm[:, None] == classes[:, None, None])
               == (cm_plain[:, None] == classes[:, None, None])).flatten(
                   2).all(-1)                                 # (B, C-1)
    points_equal = bool(
        (xy[same_px] == xy_p[same_px]).all()
        and (valid[same_px] == valid_p[same_px]).all())
    seg_ms = cuda_ms(lambda: det.infer(x), reps=10)
    got = det.infer(x)
    want = PitchLineDetector(device="cpu").infer(torch.from_numpy(
        frames[:2]))
    shapes = [tuple(t.shape[1:]) for t in got]
    stats = dict(k3_launches=launched, layer_rel=layer_rel,
                 logit_rel=logit_rel, logit_max_abs_gap=gap,
                 class_pixels_differ=int(differ.sum()),
                 class_pixels_differ_unexplained=unexplained,
                 class_pixels=int(cm.numel()),
                 frame_classes_same_pixels=int(same_px.sum()),
                 frame_classes=int(same_px.numel()),
                 points_equal=points_equal, ms_per_batch=seg_ms,
                 batch=n_frames, shapes=shapes)
    log(f"PitchSegNet-s 288 x 512 on the card, {n_frames} textured frames, "
        f"routed vs all CSPLayers plain: {stats}")
    for name, r in layer_rel.items():
        check(r <= 1e-4, f"PitchSegNet {name}: K3 rel {r} to its plain "
              "layer (tol 1e-4)")
    check(logit_rel <= 1e-4, f"PitchSegNet: logits rel {logit_rel} to the "
          "plain forward (tol 1e-4)")
    check(unexplained == 0, f"PitchSegNet: {unexplained} pixels change "
          "class where the plain logits' top two are further apart than "
          f"twice the largest gap {gap}")
    check(points_equal, "PitchSegNet: extract_segment_points differs from "
          "the plain forward's on a (frame, class) whose pixels agree")
    check(shapes == [tuple(t.shape[1:]) for t in want], "PitchSegNet: "
          "outputs differ in shape from the CPU port's")
    return stats


def _ridge(got, want):
    """How far two lists of camera dicts part along the focal-distance
    ridge: the correlation, over frames, of the relative focal gap with the
    relative gap in the camera's distance from the pitch centre (a camera
    that moves back along its view as its focal grows sees the pitch
    nearly the same), and the largest of each."""
    df = np.array([g["x_focal_length"] / w["x_focal_length"] - 1
                   for g, w in zip(got, want)])
    dd = np.array([np.linalg.norm(g["position_meters"])
                   / np.linalg.norm(w["position_meters"]) - 1
                   for g, w in zip(got, want)])
    return dict(corr=float(np.corrcoef(df, dd)[0, 1]),
                max_rel_focal=float(np.abs(df).max()),
                max_rel_distance=float(np.abs(dd).max()))


# the calibration test's bounds (tests/test_torch_calibration.py, 30 steps:
# twice the spread a change of 1e-4 px in the observations gives)
CAM_TOL = dict(pan_degrees=0.3, tilt_degrees=0.05, roll_degrees=0.6,
               x_focal_length=0.5, y_focal_length=0.5)


def _test_observations():
    """tests/test_torch_calibration.py's observations: the synthetic
    game-state camera at 640 x 360 panned by 0.05 rad per frame, 4 frames
    of pitch lines with 0.5 px of noise from ``default_rng(0)``."""
    from tracklab_torch.wrappers.dataset.synthetic import (_gs_camera,
                                                           _gs_pitch_lines)
    rng = np.random.default_rng(0)
    return [_gs_pitch_lines(_gs_camera(640, 360, pan=0.05 * v), 640, 360,
                            rng) for v in range(4)]


def _cameras_apart(got, want):
    """The largest gaps between two lists of camera dicts, per field, and
    whether they keep the calibration test's bounds (the same hypothesis,
    ``CAM_TOL``, position 0.4 m, errors 1e-2 relative)."""
    gap = {k: max(abs(g[k] - w[k]) for g, w in zip(got, want))
           for k in CAM_TOL}
    gap["position_meters"] = max(float(np.abs(np.subtract(
        g["position_meters"], w["position_meters"])).max())
        for g, w in zip(got, want))
    gap["loss_rel"] = max(abs(g["hypothesis_losses"][k]
                              / w["hypothesis_losses"][k] - 1)
                          for g, w in zip(got, want)
                          for k in w["hypothesis_losses"])
    same_type = all(g["camera_type"] == w["camera_type"]
                    for g, w in zip(got, want))
    ok = (same_type and all(gap[k] <= t for k, t in CAM_TOL.items())
          and gap["position_meters"] <= 0.4 and gap["loss_rel"] <= 1e-2)
    return gap, ok


def _sn_baseline_chain(torch, dev, lines, wh=(1920, 1080), threshold=5.0):
    """The SoccerNet baseline's cameras (``calibration/sn_baseline.py``:
    line DLT homography, its camera, TVCalib's latent under each camera
    type's priors) as ``optimize_cameras``' start, against its default
    start, 300 steps on ``dev`` over ``lines`` (per frame: segment -> image
    points): the relative mean reprojection error TVCalib reports, the
    cameras' accuracy and mean reprojection in px at ``threshold`` px
    (``evaluate_camera_prediction`` of the projected segments), seconds.
    A frame without 4 straight markings starts from 0."""
    from tracklab_torch.calibration import sn_baseline as SB
    from tracklab_torch.calibration.cam_distr import priors_array
    from tracklab_torch.calibration.camera import project_points
    from tracklab_torch.calibration.pitch import pitch_segments
    from tracklab_torch.calibration.tvcalib import (TVCalibConfig,
                                                    optimize_cameras)

    cfg = TVCalibConfig(image_width=wh[0], image_height=wh[1])
    priors = priors_array(cfg.camera_types)
    init = np.zeros((len(cfg.camera_types), len(lines), 9), np.float32)
    found = 0
    for b, obs in enumerate(lines):
        hmat = SB.estimate_homography_from_markings(obs)
        cam = None if hmat is None else SB.camera_from_homography(hmat, wh)
        if cam is None:
            continue
        found += 1
        for h in range(len(cfg.camera_types)):
            init[h, b] = SB.camera_to_latent(cam, priors[h], cfg)
    segs = {k: torch.tensor(v, dtype=torch.float32)
            for k, v in pitch_segments().items()}
    out = {"frames": len(lines), "baseline_cameras": found}
    for start, z in (("default_start", None), ("sn_baseline_start", init)):
        t0 = time.perf_counter()
        cams, err = optimize_cameras(lines, cfg, init_latents=z, device=dev)
        secs = time.perf_counter() - t0
        conf, errors = np.zeros((2, 2)), {}
        for c, obs in zip(cams, lines):
            proj = {}
            for name in obs:
                px, front = project_points(c["camera"], segs[name])
                px = px.numpy()[front.numpy()]
                if len(px):
                    proj[name] = px
            g, _, e = SB.evaluate_camera_prediction(proj, obs, threshold)
            conf += g
            for k, v in e.items():
                errors.setdefault(k, []).extend(v)
        summary = SB.summarize_camera_eval(conf, errors)
        out[start] = dict(
            relative_mean_reproj_max=float(np.max(err)),
            relative_mean_reproj_mean=float(np.mean(err)),
            accuracy=summary["accuracy"],
            mean_reprojection_px=summary["mean_reprojection_error"],
            seconds=secs)
    return out


def phase_baseline(torch, dev, card, mot_videos=2, mot_frames=100,
                   n_objects=24, gs_frames=100, chain_frames=50,
                   prefix_frames=8):
    """BASELINE configs 1 and 4 through ``tracklab_torch.main.main`` in this
    process.

    (a) Config 1, ``+experiment=mot17_ocsort data_dir=<tree>`` on a
    MOT17-layout tree the script writes (``mot_videos`` x ``mot_frames``
    PNG frames of 1920 x 1080, 24 objects in gt.txt): yolov8.yaml (YOLOv8n
    640 f32, seeded weights) -> oc_sort.yaml, with the detector's and
    tracker's thresholds calibrated as ``_calibrate_cli`` does; fused and
    staged, rows equal, K1 and ORU launched and 0 host syncs inside the
    fused program; the first ``prefix_frames`` frames on the card against
    a device=cpu run, detections matched at IoU >= 0.999 and track ids
    equal. Then the same tree staged with ``modules/bbox_detector=yolo11``
    (YOLO11m, 80 classes), checked the same way against the CPU.
    (b) Config 4 as a user types it, ``+experiment=soccernet_gamestate
    data_dir=<tree>`` on a SoccerNetGS-layout tree (one video of
    ``gs_frames`` PNG frames of 1920 x 1080 and its Labels-GameState.json):
    YOLOX-s (K3) -> OSNet x1_0 on host crops -> sparse optical flow ->
    StrongSORT (K1) -> TVCalibration -> PitchProjection -> jersey OCR ->
    vote -> GS-HOTA. The run ends with GS-HOTA; what calibration emitted is
    reported (nothing: no step of the pipeline fills ``pitch_lines``, a
    reference fault kept, ROADMAP section 3).
    (c) The calibrated game-state chain: the synthetic ``game_state`` set,
    1 video x ``chain_frames`` x 4 objects at 1920 x 1080 (the object count
    of tests/test_gsr_pipeline.py; with 8, boxes reach the far field, where
    a calibration error of a few pixels moves a pitch position by metres,
    and GS-HOTA fell to 78.3), bootstrapped from its ground truth
    (tests/test_gsr_pipeline.py's columns without keypoints)
    -> PitchLineDetector (PitchSegNet-s at 288 x 512, seeded, on the card
    with K3; its output set beside the dataset's true pitch lines, which
    TVCalibration reads) -> OSNetReIdBatched (osnet_batched.yaml) ->
    StrongSORT -> jersey OCR -> vote (team, role, jersey) -> TVCalibration
    (tvcalib.yaml: 300 steps, batches of 16) -> PitchProjection -> GS-HOTA
    without jerseys: GS-HOTA > 80 and every frame's
    relative_mean_reproj < 0.01 (tests/test_gsr_pipeline.py's bounds), K1
    and K3 launched; TVCalibration's seconds per batch of 16 (``_CliSplit``
    times both calibration modules). Then the segmenter's K3 layers against
    their plain versions on textured frames (``_pitchseg_vs_plain``); and
    the card's cameras against the CPU port's: the calibration test's case
    (tests/test_torch_calibration.py: 4 frames at 640 x 360, 3 hypotheses,
    30 steps) and the chain's first 16 frames at 30 steps within the test's
    bounds, beside the card's own spread when 1e-4 px of noise is added to
    the observations; the chain's own 300-step cameras with the same camera
    types, the CPU's within 1 % of reprojection error too, pan and roll
    within the test's bounds, and their gap along the focal-distance ridge
    (``_ridge``) reported beside the card's own 300-step spread."""
    import shutil
    import tempfile
    from pathlib import Path

    from tracklab_torch.calibration.tvcalib import (TVCalibConfig,
                                                    optimize_cameras)
    from tracklab_torch.wrappers.bbox_detector import YOLOv8Detector

    stats = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_baseline_"))
    try:
        # (a) config 1
        t0 = time.perf_counter()
        frames8 = _mot17_tree(torch, dev, tmp, mot_videos, mot_frames,
                              n_objects)
        log(f"baseline (a): wrote {mot_videos} x {mot_frames} PNG frames of "
            f"1920 x 1080 in {time.perf_counter() - t0:.1f} s")
        for name, group, kw in (
                ("yolov8n", [], dict(variant="n", num_classes=1)),
                ("yolo11m", ["modules/bbox_detector=yolo11"],
                 dict(variant="11m", num_classes=80))):
            det_thr, birth_thr = _calibrate_cli(
                torch, dev, n_objects, frames=frames8,
                detector=YOLOv8Detector(min_confidence=0.0, device=dev,
                                        **kw))
            args = ["use_rich=false", "+experiment=mot17_ocsort",
                    f"data_dir={tmp}"] + group + [
                f"modules.bbox_detector.min_confidence={det_thr}",
                f"modules.track.min_confidence={det_thr}",
                f"modules.track.det_thresh={birth_thr}"]
            runs = {}
            # staged first: a fresh process's first tracker scans sync
            # (5 host syncs, then 0 once warm)
            for fused in ((False, True) if name == "yolov8n" else (False,)):
                run = f"{name}_{'fused' if fused else 'staged'}"
                parts, res, launches, split = _cli_run(
                    torch, args + [f"device={dev.type}",
                                   f"engine.fused={str(fused).lower()}"],
                    ("loader", "program", "eval") if fused
                    else ("loader", "detect", "scan", "eval"))
                pred = parts["tracker_state"].detections_pred
                runs[fused] = pred
                per_frame = len(pred) / split["frames"]
                log(f"baseline (a) {run} on {card}: {split['frames']} "
                    f"frames, {per_frame:.2f} detections/frame, "
                    f"{split['fps']:.2f} frames/s of track_dataset "
                    f"({split['track_dataset_s']:.2f} s: loader "
                    f"{split['loader_s']:.2f}, device "
                    f"{split['device_s']:.2f}, DataFrames and host "
                    f"{split['dataframes_and_host_s']:.2f}; eval "
                    f"{split['eval_s']:.2f}); HOTA "
                    f"{res['COMBINED_SEQ']['HOTA']:.3f} with random weights;"
                    f" launches {launches}; host syncs in the fused program "
                    f"{split['host_syncs_in_fused_program']}")
                check(5 <= per_frame <= 64,
                      f"baseline (a) {run}: {per_frame:.2f} detections/frame")
                for k in ("K1", "ORU"):
                    check(launches[k] > 0, f"baseline (a) {run}: {k} never "
                          "launched")
                if fused:
                    check(split["fused_program_frames"] >= split["frames"],
                          "baseline (a): the fused program did not run")
                    check(split["host_syncs_in_fused_program"] == 0,
                          f"baseline (a): "
                          f"{split['host_syncs_in_fused_program']} host "
                          "syncs inside the fused program")
                stats[run] = dict(split, launches=launches,
                                  detections_per_frame=per_frame,
                                  HOTA=res["COMBINED_SEQ"]["HOTA"],
                                  min_confidence=det_thr,
                                  det_thresh=birth_thr)
            if name == "yolov8n":
                _same_rows(runs[True], runs[False],
                           "baseline (a) yolov8n fused vs staged")
                log("baseline (a): YOLOv8n fused equals staged")
            cpu_parts, _, _, cpu_split = _cli_run(
                torch, args + ["device=cpu", f"dataset.nframes={prefix_frames}"],
                ("loader", "detect", "scan", "eval"))
            cpu_pred = cpu_parts["tracker_state"].detections_pred
            m = _match_prefix(runs[False], cpu_pred,
                              cpu_parts["tracker_state"].image_metadatas.index)
            log(f"baseline (a) {name}: the first {prefix_frames} frames on "
                f"the card against device=cpu ({cpu_split['fps']:.2f} "
                f"frames/s): {m}")
            check(m["matched"] == m["card_rows"] == m["cpu_rows"] > 0,
                  f"baseline (a) {name}: detections differ from the CPU's: "
                  f"{m}")
            check(m["min_iou"] >= 0.999, f"baseline (a) {name}: a detection "
                  f"matched the CPU's at IoU {m['min_iou']:.6f}")
            check(m["other_track_ids"] == 0 and m["tracked_in_one"] == 0
                  and m["tracked_in_both"] > 0,
                  f"baseline (a) {name}: card and CPU tracks differ: {m}")
            stats[f"{name}_cpu_prefix"] = dict(m, cpu_fps=cpu_split["fps"])

        # (b) config 4 as typed
        t0 = time.perf_counter()
        _gamestate_tree(torch, dev, tmp, gs_frames, n_objects)
        log(f"baseline (b): wrote {gs_frames} PNG frames of 1920 x 1080 and "
            f"Labels-GameState.json in {time.perf_counter() - t0:.1f} s")
        bare = ["+experiment=soccernet_gamestate", f"data_dir={tmp}"]
        # as typed on the card; a rehearsal on the CPU names its device
        parts, res, launches, split = _cli_run(
            torch, bare + ([] if dev.type == "cuda" else ["device=cpu"]),
            ("loader", "detect", "reid", "camera", "scan", "calibration",
             "eval"))
        st = parts["tracker_state"]
        pred, images = st.detections_pred, st.image_pred
        params = (int(images["parameters"].notna().sum())
                  if "parameters" in images else 0)
        pitched = (int(pred["bbox_pitch"].notna().sum())
                   if "bbox_pitch" in pred else 0)
        c = res["COMBINED_SEQ"]
        log(f"baseline (b) {' '.join(bare)} on {card}: {split['frames']} "
            f"frames, {len(pred) / split['frames']:.2f} detections/frame, "
            f"{split['fps']:.2f} frames/s of track_dataset "
            f"({split['track_dataset_s']:.2f} s: loader "
            f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
            f"camera motion {split['camera_s']:.2f}, calibration "
            f"{split['calibration_s']:.2f}, DataFrames and host "
            f"{split['dataframes_and_host_s']:.2f}; eval "
            f"{split['eval_s']:.2f}); GS-HOTA {c['GS-HOTA']:.3f}; "
            f"calibration emitted {params} camera rows in "
            f"{len(split['calibration_calls'])} calls, {pitched} of "
            f"{len(pred)} detections got bbox_pitch; launches {launches}")
        check(len(pred) > 0 and launches["K3"] > 0 and launches["K1"] > 0,
              "baseline (b): the experiment did not run its detector and "
              "tracker on the card")
        stats["gamestate_as_typed"] = dict(
            split, launches=launches, GS_HOTA=c["GS-HOTA"],
            calibrated_frames=params, detections_with_bbox_pitch=pitched,
            detections=len(pred))

        # (c) the calibrated game-state chain
        chain = [
            "use_rich=false", f"device={dev.type}", "dataset.n_videos=1",
            f"dataset.n_frames={chain_frames}", "dataset.n_objects=4",
            "+dataset.game_state=true",
            "pipeline=[pitch_seg, reid, track, jersey, vote, calibration, "
            "projection]",
            "+modules.pitch_seg._target_=tracklab_torch.wrappers."
            "calibration_api.PitchLineDetector",
            "+modules/reid=osnet_batched", "modules/track=strong_sort",
            "+modules.jersey._target_=tracklab_torch.wrappers.jersey."
            "JerseyNumberOCR",
            "+modules.vote._target_=tracklab_torch.wrappers.tracklet_agg."
            "MajorityVoteTracklet",
            "+modules.vote.attributes=[team, role, jersey_number]",
            "+modules/calibration=tvcalib",
            "+modules.projection._target_=tracklab_torch.wrappers."
            "calibration_api.PitchProjection",
            "eval=gs_hota", "eval.use_jerseys=false", GS_BOOTSTRAP]
        with _SegmenterBeside() as seg:
            parts, res, launches, split = _cli_run(
                torch, chain, ("loader", "embed", "scan", "segmenter",
                               "calibration", "eval"))
        st = parts["tracker_state"]
        pred, images = st.detections_pred, st.image_pred
        c = res["COMBINED_SEQ"]
        reproj = [p["relative_mean_reproj"] for p in images["parameters"]]
        full = [t for n, t in split["calibration_calls"] if n == 16]
        per16 = float(np.mean(full)) if full else float("nan")
        seg_batches = split["patch_calls"]["segmenter"]
        log(f"baseline (c) the game-state chain on {card}: "
            f"{split['frames']} frames, {split['fps']:.2f} frames/s of "
            f"track_dataset ({split['track_dataset_s']:.2f} s: loader "
            f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
            f"segmenter {split['segmenter_s']:.2f}, calibration "
            f"{split['calibration_s']:.2f}, DataFrames and host "
            f"{split['dataframes_and_host_s']:.2f}; eval "
            f"{split['eval_s']:.2f}); GS-HOTA {c['GS-HOTA']:.3f}, "
            f"CLR_FN {c['CLR_FN']}, IDSW {c['IDSW']}; relative_mean_reproj "
            f"max {max(reproj):.5f}; TVCalibration {per16:.3f} s per batch "
            f"of 16 frames (calls {split['calibration_calls']}); "
            f"PitchLineDetector {split['segmenter_s']:.3f} s over "
            f"{seg_batches} batches ({seg.lines} lines found by the seeded "
            f"segmenter); launches {launches}")
        check(len(reproj) == chain_frames, f"baseline (c): {len(reproj)} "
              "calibrated frames")
        check(c["GS-HOTA"] > 80.0, f"baseline (c): GS-HOTA {c['GS-HOTA']}")
        check(max(reproj) < 0.01, f"baseline (c): relative_mean_reproj "
              f"{max(reproj)}")
        check(int(pred["bbox_pitch"].notna().sum()) > 0,
              "baseline (c): no detection projected onto the pitch")
        for k in ("K1", "K3"):
            check(launches[k] > 0, f"baseline (c): {k} never launched")

        # the segmenter's K3 layers at the path's shapes against their
        # plain versions, on textured frames
        seg_check = _pitchseg_vs_plain(torch, dev)

        # cameras on the card against the CPU: the calibration test's case
        # (4 frames at 640 x 360, 3 hypotheses, 30 steps) and the chain's
        # first 16 frames at 30 steps within the test's bounds; at 300
        # steps (the chain's own cameras) the same camera types and both
        # within 1 % of reprojection error, pan and roll within the test's
        # bounds, and how far they part along the focal-distance ridge
        # beside the card's own spread there under 1e-4 px of noise
        test_obs = _test_observations()
        cfg = TVCalibConfig(steps=30, image_width=640, image_height=360,
                            camera_types=("main_center", "main_left",
                                          "main_behind"))
        card_test = optimize_cameras(test_obs, cfg, device=dev)[0]
        gap_test, ok_test = _cameras_apart(
            card_test, optimize_cameras(test_obs, cfg, device="cpu")[0])
        # the descent's own spread on the card: 1e-4 px of noise added to
        # the observations, three draws, against the unperturbed run
        rng = np.random.default_rng(0)

        def noisy(obs):
            return [{k: (v + rng.normal(0, 1e-4, v.shape)).astype(np.float32)
                     for k, v in o.items()} for o in obs]
        spread = [_cameras_apart(optimize_cameras(
            noisy(test_obs), cfg, device=dev)[0], card_test)[0]
            for _ in range(3)]
        spread = {k: max(g[k] for g in spread) for k in spread[0]}
        gt_lines = list(images.sort_values("frame")["pitch_lines"][:16])
        cfg30 = TVCalibConfig(steps=30)
        gap30, ok30 = _cameras_apart(
            optimize_cameras(gt_lines, cfg30, device=dev)[0],
            optimize_cameras(gt_lines, cfg30, device="cpu")[0])
        cpu300, cpu_err = optimize_cameras(gt_lines, TVCalibConfig(),
                                           device="cpu")
        card300 = list(images.sort_values("frame")["parameters"][:16])
        gap300, _ = _cameras_apart(card300, cpu300)
        spread300 = optimize_cameras(noisy(gt_lines), TVCalibConfig(),
                                     device=dev)[0]
        ridge300 = _ridge(card300, cpu300)
        own300 = dict(_cameras_apart(spread300, card300)[0],
                      **_ridge(spread300, card300))
        log(f"baseline (c): cameras, card vs CPU: the calibration test's "
            f"case {gap_test} (the card's own spread under 1e-4 px of "
            f"noise: {spread}); the chain's 16 frames at 30 steps {gap30} "
            f"(within the test's bounds: {ok30}); at 300 steps {gap300}, "
            f"along the focal-distance ridge {ridge300}, CPU "
            f"relative_mean_reproj max {float(np.max(cpu_err)):.5f} (the "
            f"card's own 300-step spread under 1e-4 px of noise: {own300})")
        check(ok_test, f"baseline (c): card and CPU cameras part on the "
              f"calibration test's case: {gap_test}")
        check(ok30, f"baseline (c): card and CPU cameras part on the "
              f"chain's 16 frames at 30 steps: {gap30}")
        check(all(g["camera_type"] == w["camera_type"]
                  for g, w in zip(card300, cpu300))
              and float(np.max(cpu_err)) < 0.01
              and all(gap300[k] <= CAM_TOL[k]
                      for k in ("pan_degrees", "roll_degrees")),
              f"baseline (c): at 300 steps the card's and the CPU's cameras "
              f"differ off the focal-distance ridge: {gap300}, CPU error "
              f"{float(np.max(cpu_err))}")
        sn = _sn_baseline_chain(torch, dev, gt_lines)
        log(f"baseline (c): the SoccerNet baseline's cameras as TVCalib's "
            f"start on the chain's 16 frames on {card} ({sn['baseline_cameras']}"
            f" found), against the default start: {sn}")
        check(sn["baseline_cameras"] > 0
              and all(math.isfinite(sn[k]["relative_mean_reproj_max"])
                      for k in ("default_start", "sn_baseline_start")),
              f"baseline (c): the SoccerNet baseline chain failed: {sn}")
        stats["gamestate_chain"] = dict(
            split, launches=launches, GS_HOTA=c["GS-HOTA"], sn_baseline=sn,
            CLR_FN=c["CLR_FN"], IDSW=c["IDSW"],
            max_relative_mean_reproj=max(reproj),
            tvcalib_s_per_16_frames=per16,
            pitch_seg_batches=seg_batches, pitch_seg_vs_plain=seg_check,
            cameras_card_vs_cpu_test_case=gap_test,
            cameras_card_spread_under_1e_4_px=spread,
            cameras_card_vs_cpu_30_steps=gap30,
            cameras_card_vs_cpu_300_steps=gap300,
            cameras_300_ridge=ridge300,
            cameras_card_spread_300_steps=own300,
            cpu_max_relative_mean_reproj_300=float(np.max(cpu_err)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return stats


# ------------------------------------------------------------ phase pose
def _sportsmot_tree(root, n_videos, n_frames, n_objects, wh=(1280, 720)):
    """A SportsMOT-layout validation split under ``root``: ``n_videos``
    sequences of ``n_frames`` PNG frames of ``wh``, the synthetic set's
    renders (``n_objects`` players as coloured blocks on a dark field, a
    seed per sequence), their seqinfo.ini and gt.txt. Returns the first
    sequence's first 8 frames. (On the panning texture of the MOT17 tree
    the seeded YOLOXPose-s scores highest on the letterbox's grey bands,
    whose keypoints map outside the frame: boxes of zero height.)"""
    from tracklab_torch.utils.cv2 import cv2_load_image
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    w, h = wh
    first = None
    for v in range(n_videos):
        seq = root / "SportsMOT" / "val" / f"v_{v:02d}_c001"
        s = make_synthetic_set(n_videos=1, n_frames=n_frames,
                               n_objects=n_objects, seed=3 + v, img_w=w,
                               img_h=h)
        frames = [cv2_load_image(p) for p in s.image_metadatas["file_path"]]
        _write_pngs(frames, seq / "img1")
        (seq / "gt").mkdir()
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=25\n"
            f"seqLength={n_frames}\nimWidth={w}\nimHeight={h}\n"
            "imExt=.png\n")
        gt = s.detections_gt
        (seq / "gt" / "gt.txt").write_text("".join(
            f"{f},{t},{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},{b[3]:.3f},1,1,1.0\n"
            for f, t, b in zip(gt["frame"], gt["track_id"],
                               gt["bbox_ltwh"])))
        first = frames[:8] if first is None else first
    return first


def _split_line(split):
    return (f"{split['frames']} frames, {split['fps']:.2f} frames/s of "
            f"track_dataset ({split['track_dataset_s']:.2f} s: loader "
            f"{split['loader_s']:.2f}, device {split['device_s']:.2f}, "
            f"DataFrames and host {split['dataframes_and_host_s']:.2f}; eval "
            f"{split['eval_s']:.2f})")


def _same_keypoints(a, b, what, atol=1e-3):
    """The rows' keypoints (K, 3) within ``atol`` (px and confidence);
    returns the largest difference."""
    ka = np.stack(a["keypoints_xyc"].to_numpy())
    kb = np.stack(b["keypoints_xyc"].to_numpy())
    check(ka.shape == kb.shape, f"{what}: keypoint shapes {ka.shape} and "
          f"{kb.shape}")
    d = float(np.abs(ka - kb).max())
    check(d <= atol, f"{what}: keypoints {d:.2e} apart")
    return d


def _csp_vs_plain(torch, model, x, what, fwd=None):
    """Every CSPLayer of ``model`` that K3 takes (dense, <= 80 x 80 on the
    card) against its plain layer on the layer's own input from one forward
    of ``x``: K3 within 1e-5 of the plain layer's scale (its largest
    magnitude) and within phase 4's f32 rel 1e-4 element by element
    (``_rel``), and each of the two within rel 1e-4 of the layer in f64
    (``_plain_f64``), their distances reported; and the whole forward
    against the all-plain one (each output map within 1e-4 of its scale).
    Returns the layers (name, H x W, gap over the scale, rel to plain, K3's
    and plain's rel to f64) and the maps' largest gap over their scale."""
    from tracklab_torch.models.yolox import CSP_MAX_PIXELS, CSPLayer

    fwd = fwd or model
    taken = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, inp, name=name: taken.append((name, mod, inp[0].clone())))
        for name, mod in model.named_modules() if isinstance(mod, CSPLayer)]
    with torch.no_grad():
        try:
            routed = fwd(x)
        finally:
            for h in hooks:
                h.remove()
        with _plain_csp():
            plain = fwd(x)
        layers = []
        for name, mod, inp in taken:
            H, W = inp.shape[2:]
            if mod.depthwise or H * W > CSP_MAX_PIXELS:
                continue
            got, plain_l = mod(inp), mod.forward_plain(inp)
            f64 = _plain_f64(torch, mod, inp)
            rs = float((got.float() - plain_l.float()).abs().max()
                       / plain_l.float().abs().max())
            r, rk, rp = (_rel(got, plain_l), _rel(got, f64),
                         _rel(plain_l, f64))
            check(rs <= 1e-5 and r <= 1e-4 and rk <= 1e-4 and rp <= 1e-4,
                  f"{what}: K3 at {name} ({H}x{W}) {rs:.2e} of the plain "
                  f"layer's scale, rel {r:.2e}, {rk:.2e} (plain {rp:.2e}) "
                  "from f64")
            layers.append((name, f"{H}x{W}", rs, r, rk, rp))
    maps = 0.0
    for g, w in zip(routed if isinstance(routed, (list, tuple))
                    else [routed], plain if isinstance(plain, (list, tuple))
                    else [plain]):
        maps = max(maps, float((g.float() - w.float()).abs().max()
                               / w.float().abs().max()))
    check(maps <= 1e-4, f"{what}: the routed maps {maps:.2e} of their scale "
          "from the all-plain forward")
    check(len(layers) > 0, f"{what}: no CSPLayer for K3")
    log(f"{what}: K3 at {len(layers)} layers, gap over the plain layer's "
        f"scale / rel to it / K3 to f64 / plain to f64: " + "; ".join(
            f"{n} {hw} {rs:.2e} / {r:.2e} / {rk:.2e} / {rp:.2e}"
            for n, hw, rs, r, rk, rp in layers)
        + f"; the maps {maps:.2e} of their scale from the all-plain forward")
    return dict(layers=layers, maps_rel=maps)


def phase_pose(torch, dev, card, n_videos=2, n_frames=60, n_objects=24,
               prefix_frames=8, topdown_frames=60):
    """The pose-tracking slice through ``tracklab_torch.main.main`` in this
    process, with seeded weights.

    (a) BASELINE config 3 as typed, ``+experiment=sportsmot_pose
    data_dir=<tree>``, on a SportsMOT-layout tree the script writes
    (``n_videos`` x ``n_frames`` PNG frames of 1280 x 720, the synthetic
    set's renders of ``n_objects`` players; real sequences run several
    hundred frames: a depth cut):
    bottomup.yaml (YOLOXPose-s 640, 17 keypoints, K3) -> osnet.yaml with
    use_keypoints (OSNet x1_0, 8 input channels, 6 parts, 512-d, host
    crops and prompts) -> bpbreid_strong_sort.yaml with OKS motion (128
    tracks, 64 dets, K1); the pose model's threshold calibrated to ~15
    detections a frame. frames/s and its split, host syncs in the tracker
    scans per frame; the first ``prefix_frames`` frames against a
    device=cpu run (detections at IoU >= 0.999, the same track ids); K1 on
    the run's own tracker inputs against its plain solver.
    (b) Bottom-up -> OC-SORT on the same tree, engine.fused true
    (``run_fused_bottomup_video``) and false: the same rows, boxes within
    rtol 1e-4 / atol 1e-3, keypoints within 1e-3, track ids equal; 0 host
    syncs inside the fused program.
    (c) Top-down: 2 synthetic 640 x 640 videos x ``topdown_frames`` ->
    YOLOX-s (calibrated) -> topdown_batched.yaml (TopDownPose-s 256 x 192,
    work size 640 x 640, 64 slots, batch 8 as the detector's) -> OC-SORT,
    fused (``run_fused_pose_video``) and staged with cuDNN deterministic,
    the same checks; then the
    detector -> vitpose.yaml (ViTPose-small on host crops through
    TopDownPoseEstimator) -> OC-SORT staged, and ViTPose-small's heatmaps
    on the card against the CPU's on 8 crops (f32, within 1e-4 of their
    scale).
    (d) K3 at YOLOXPose-s's CSPLayers (8 letterboxed frames of the tree)
    and at TopDownPose-s's (8 crops of 256 x 192) against the plain layers,
    each model's maps against its all-plain forward (``_csp_vs_plain``).

    Returns the stats; each run's kernel launches under its name."""
    import shutil
    import tempfile
    from pathlib import Path

    from tracklab_torch.trackers.bpbreid_strongsort import (bpbreid_init,
                                                            bpbreid_step)
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.wrappers.bbox_detector.yolox_api import letterbox
    from tracklab_torch.wrappers.pose_estimator import BottomUpPoseEstimator

    stats = {}
    cpu_dev = ["device=cpu"] if dev.type == "cpu" else []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pose_"))
    try:
        t0 = time.perf_counter()
        frames8 = _sportsmot_tree(tmp, n_videos, n_frames, n_objects)
        log(f"pose: wrote {n_videos} x {n_frames} PNG frames of 1280 x 720 "
            f"in {time.perf_counter() - t0:.1f} s")
        pose_thr, pose_born = _calibrate_cli(
            torch, dev, n_objects, per_frame=15, born=10, frames=frames8,
            detector=BottomUpPoseEstimator(min_confidence=0.0, device=dev))
        log(f"pose: calibrated YOLOXPose-s min_confidence {pose_thr}, "
            f"birth {pose_born}")

        # (a) config 3 as typed, its threshold calibrated
        args = ["use_rich=false", "+experiment=sportsmot_pose",
                f"data_dir={tmp}",
                f"modules.pose_estimator.min_confidence={pose_thr}"]
        parts, res, launches, split = _cli_run(
            torch, args + cpu_dev, ("loader", "detect", "reid", "scan",
                                    "eval"))
        pred = parts["tracker_state"].detections_pred
        per_frame = len(pred) / split["frames"]
        syncs = split["host_syncs_in_scans"] / split["frames"]
        log(f"pose (a) config 3 on {card}: {_split_line(split)}; "
            f"tracker scans {split['tracker_scan_s']:.2f} s, device by "
            f"stage {split['device_s_by_stage']}; "
            f"{per_frame:.2f} detections/frame, {pred['track_id'].nunique()} "
            f"tracks, HOTA {res['COMBINED_SEQ']['HOTA']:.3f} with random "
            f"weights; host syncs in the tracker scans {syncs:.3f} per "
            f"frame; launches {launches}")
        check(5 <= per_frame <= 64, f"pose (a): {per_frame:.2f} "
              "detections/frame")
        check(np.stack(pred["embeddings"].to_numpy()).shape[1:] == (7, 512),
              "pose (a): the part embeddings are not (7, 512)")
        for k in ("K3", "K1"):
            check(launches[k] > 0, f"pose (a): {k} never launched")
        stats["config3"] = dict(split, launches=launches,
                                detections_per_frame=per_frame,
                                scan_syncs_per_frame=syncs,
                                HOTA=res["COMBINED_SEQ"]["HOTA"],
                                min_confidence=pose_thr)
        cpu_parts, _, _, cpu_split = _cli_run(
            torch, args + ["device=cpu", f"dataset.nframes={prefix_frames}"],
            ("loader", "detect", "reid", "scan", "eval"))
        m = _match_prefix(pred, cpu_parts["tracker_state"].detections_pred,
                          cpu_parts["tracker_state"].image_metadatas.index)
        log(f"pose (a): the first {prefix_frames} frames on the card against "
            f"device=cpu ({cpu_split['fps']:.2f} frames/s): {m}")
        check(m["matched"] == m["card_rows"] == m["cpu_rows"] > 0,
              f"pose (a): detections differ from the CPU's: {m}")
        check(m["min_iou"] >= 0.999, f"pose (a): a detection matched the "
              f"CPU's at IoU {m['min_iou']:.6f}")
        check(m["other_track_ids"] == 0 and m["tracked_in_one"] == 0
              and m["tracked_in_both"] > 0,
              f"pose (a): card and CPU tracks differ: {m}")
        stats["config3_cpu_prefix"] = dict(m, cpu_fps=cpu_split["fps"])
        # K1 on the run's own tracker inputs (the first video), untimed
        trk = parts["modules"][2]
        images = parts["tracker_state"].image_metadatas
        v0 = images[images["video_id"] == images["video_id"].iloc[0]]
        ins, n, _ = trk._video_inputs(pred[pred["image_id"].isin(v0.index)],
                                      v0, trk.n_frame_bucket)
        dets, *rest = ins
        dets = Detections(*(x.to(dev) for x in dets))
        rest = [x.to(dev) for x in rest]
        cfg = trk._make_config()
        stats["k1_on_bpbreid_path"] = _k1_on_path(
            torch, partial(bpbreid_step, cfg), bpbreid_init(cfg, device=dev),
            [(Detections(*(x[f] for x in dets)),) + tuple(x[f] for x in rest)
             for f in range(n)], n_keep=16, what="config 3's BPBReID stage")

        # (b) bottom-up -> OC-SORT, fused against staged
        bu = ["use_rich=false", f"device={dev.type}", "dataset=sportsmot",
              f"data_dir={tmp}", "pipeline=[pose_estimator,track]",
              "+modules/pose_estimator=bottomup", "modules/track=oc_sort",
              f"modules.pose_estimator.min_confidence={pose_thr}",
              f"modules.track.min_confidence={pose_thr}",
              f"modules.track.det_thresh={pose_born}"]
        runs = {}
        for fused in (False, True):         # staged first: warm scans
            name = f"bottomup_{'fused' if fused else 'staged'}"
            parts, res, launches, split = _cli_run(
                torch, bu + [f"engine.fused={str(fused).lower()}"],
                ("loader", "program", "eval") if fused
                else ("loader", "detect", "scan", "eval"))
            runs[fused] = parts["tracker_state"].detections_pred
            log(f"pose (b) {name} on {card}: {_split_line(split)}; launches "
                f"{launches}; host syncs in the fused program "
                f"{split['host_syncs_in_fused_program']}")
            for k in ("K3", "K1"):
                check(launches[k] > 0, f"pose (b) {name}: {k} never "
                      "launched")
            if fused:
                check(split["fused_program_frames"] >= split["frames"],
                      "pose (b): the fused program did not run")
                check(split["host_syncs_in_fused_program"] == 0,
                      f"pose (b): {split['host_syncs_in_fused_program']} "
                      "host syncs inside the fused program")
            stats[name] = dict(split, launches=launches)
        _same_rows(runs[True], runs[False], "pose (b) fused vs staged")
        stats["bottomup_keypoints_max_diff"] = _same_keypoints(
            runs[True], runs[False], "pose (b) fused vs staged")
        log("pose (b): bottom-up fused equals staged (keypoints within "
            f"{stats['bottomup_keypoints_max_diff']:.2e})")

        # (d) K3 at YOLOXPose-s's layers, on the tree's letterboxed frames
        bu_model = parts["modules"][0]._model
        x = torch.from_numpy(np.stack([letterbox(f, (640, 640))["image"]
                                       for f in frames8])).to(dev).float()
        stats["k3_yoloxpose_s"] = _csp_vs_plain(torch, bu_model, x,
                                                "pose (d) YOLOXPose-s 640")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) top-down, fused against staged, then ViTPose-small staged
    det_thr, det_born = _calibrate_cli(torch, dev, n_objects,
                                       img_wh=(640, 640))
    td = ["use_rich=false", f"device={dev.type}",
          "pipeline=[bbox_detector,pose_estimator,track]",
          "+modules/bbox_detector=yolox", "modules/track=oc_sort",
          f"modules.bbox_detector.min_confidence={det_thr}",
          f"modules.track.min_confidence={det_thr}",
          f"modules.track.det_thresh={det_born}", "dataset.n_videos=2",
          f"dataset.n_frames={topdown_frames}",
          f"dataset.n_objects={n_objects}", "dataset.img_w=640",
          "dataset.img_h=640"]
    batched = ["+modules/pose_estimator=topdown_batched",
               "modules.pose_estimator.work_size=[640,640]",
               "modules.pose_estimator.max_dets=64",
               "modules.pose_estimator.batch_size=8"]
    runs = {}
    # deterministic cuDNN for the two runs: TopDownPose's deconvs are
    # cuDNN backward-data convolutions, some of whose algorithms add with
    # atomics, and a heatmap's near-tie argmax can then move a keypoint by
    # a stride (4.71 px between the two runs once on the card)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fused in (False, True):
            name = f"topdown_{'fused' if fused else 'staged'}"
            parts, res, launches, split = _cli_run(
                torch, td + batched + [f"engine.fused={str(fused).lower()}"],
                ("loader", "program", "eval") if fused
                else ("loader", "detect", "pose", "scan", "eval"))
            runs[fused] = parts["tracker_state"].detections_pred
            log(f"pose (c) {name} on {card}: {_split_line(split)}; launches "
                f"{launches}; host syncs in the fused program "
                f"{split['host_syncs_in_fused_program']}")
            for k in ("K3", "K1"):
                check(launches[k] > 0, f"pose (c) {name}: {k} never launched")
            if fused:
                check(split["fused_program_frames"] >= split["frames"],
                      "pose (c): the fused program did not run")
                check(split["host_syncs_in_fused_program"] == 0,
                      f"pose (c): {split['host_syncs_in_fused_program']} host "
                      "syncs inside the fused program")
            stats[name] = dict(split, launches=launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _same_rows(runs[True], runs[False], "pose (c) fused vs staged")
    stats["topdown_keypoints_max_diff"] = _same_keypoints(
        runs[True], runs[False], "pose (c) fused vs staged")
    log("pose (c): top-down fused equals staged (keypoints within "
        f"{stats['topdown_keypoints_max_diff']:.2e})")
    td_model = parts["modules"][1]._model
    g = torch.Generator(device=dev).manual_seed(7)
    crops = torch.randint(0, 256, (8, 256, 192, 3), generator=g,
                          device=dev).float() / 255.0
    stats["k3_topdownpose_s"] = _csp_vs_plain(
        torch, td_model.backbone, td_model._nchw(crops),
        "pose (d) TopDownPose-s 256 x 192", fwd=lambda _: td_model(crops))

    parts, res, launches, split = _cli_run(
        torch, td + ["+modules/pose_estimator=vitpose",
                     "engine.fused=false"],
        ("loader", "detect", "pose", "scan", "eval"))
    pred = parts["tracker_state"].detections_pred
    kp = np.stack(pred["keypoints_xyc"].to_numpy())
    log(f"pose (c) ViTPose-small staged on {card}: {_split_line(split)}; "
        f"{len(pred)} rows with keypoints {kp.shape[1:]}; launches "
        f"{launches}")
    check(np.isfinite(kp).all() and kp.shape[1:] == (17, 3),
          "pose (c): ViTPose-small keypoints")
    stats["vitpose_staged"] = dict(split, launches=launches)
    vit = parts["modules"][1]._model
    with torch.no_grad():
        want = vit(crops).float()
        got = vit.to("cpu")(crops.cpu()).float()
    vit.to(dev)
    d = float((got - want.cpu()).abs().max() / want.abs().max())
    log(f"pose (c): ViTPose-small heatmaps on {card} {d:.2e} of their scale "
        "from the CPU's")
    check(d <= 1e-4, f"pose (c): ViTPose-small on the card {d:.2e} from the "
          "CPU")
    stats["vitpose_card_vs_cpu"] = d
    return stats


def _posetrack_tree(root, n_videos, n_frames, n_objects, wh=(1280, 720)):
    """A PoseTrack21-layout validation split under ``root/PoseTrack21``:
    ``n_videos`` sequences of ``n_frames`` JPEG frames of ``wh``
    (``images/val/<seq>/``), the synthetic set's renders of ``n_objects``
    people with 17 keypoints each (``with_keypoints``), and
    ``posetrack_data/val/<seq>.json``: ``images`` (every third frame with
    an ignore region in its top-left corner), ``annotations`` (box, 17 x 3
    keypoints, ``track_id`` and a ``person_id`` unique over the videos).
    Returns the first sequence's first 8 frames."""
    import json
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from tracklab_torch.utils.cv2 import cv2_load_image
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    w, h = wh
    base = root / "PoseTrack21"
    first = None
    for v in range(n_videos):
        name = f"{v + 1:06d}_mpii_test"
        s = make_synthetic_set(n_videos=1, n_frames=n_frames,
                               n_objects=n_objects, seed=3 + v, img_w=w,
                               img_h=h, with_keypoints=True)
        frames = [cv2_load_image(p) for p in s.image_metadatas["file_path"]]
        (base / "images" / "val" / name).mkdir(parents=True)
        files = [f"images/val/{name}/{f:06d}.jpg" for f in range(n_frames)]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda f: cv2.imwrite(
                str(base / files[f]), frames[f][..., ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, 95]), range(n_frames)))
        ids = {iid: 10000 * (v + 1) + f
               for f, iid in enumerate(s.image_metadatas.index)}
        images = []
        for f, iid in enumerate(s.image_metadatas.index):
            img = {"id": ids[iid], "file_name": files[f], "is_labeled": True,
                   "frame_id": ids[iid], "nframes": n_frames}
            if f % 3 == 0:
                img["ignore_regions_x"] = [[0, 60, 60, 0]]
                img["ignore_regions_y"] = [[0, 0, 40, 40]]
            images.append(img)
        gt = s.detections_gt
        anns = [{"image_id": ids[iid], "track_id": int(t) - 1,
                 "person_id": 1000 * v + int(t), "category_id": 1,
                 "bbox": [float(x) for x in b],
                 "keypoints": np.asarray(k, float).reshape(-1).tolist()}
                for iid, t, b, k in zip(gt["image_id"], gt["track_id"],
                                        gt["bbox_ltwh"], gt["keypoints_xyc"])]
        ann_dir = base / "posetrack_data" / "val"
        ann_dir.mkdir(parents=True, exist_ok=True)
        (ann_dir / f"{name}.json").write_text(json.dumps(
            {"images": images, "annotations": anns,
             "categories": [{"id": 1, "name": "person"}]}))
        first = frames[:8] if first is None else first
    return first


def _posetrack_results(res):
    """The PoseTrackEvaluator's headline figures."""
    return dict(box_HOTA=res["COMBINED_SEQ"]["HOTA"],
                box_MOTA=res["COMBINED_SEQ"]["MOTA"],
                box_IDF1=res["COMBINED_SEQ"]["IDF1"],
                bbox_mAP=res.get("bbox_mAP"),
                pose_HOTA=res.get("POSE_COMBINED", {}).get("HOTA"),
                kp_mAP=res.get("kp_mAP"),
                reid_pose_HOTA0=(res["REID_POSE"]["HOTA(0)"]
                                 if "REID_POSE" in res else None),
                kp_AP_total=res.get("kp_AP_per_joint", {}).get("total_AP"),
                kp_AP_per_joint=[round(float(x), 3) for x in res.get(
                    "kp_AP_per_joint", {}).get("per_joint_AP", [])],
                kp_MOTA_total=res.get("kp_MOTA_per_joint", {}).get(
                    "total_MOTA"),
                kp_MOTA_per_joint=[round(float(x), 3) for x in res.get(
                    "kp_MOTA_per_joint", {}).get("per_joint_MOTA", [])])


def _k4_recorder(store, n_keep):
    """A stand-in for ``models.kpr.vit_attention`` that keeps the inputs of
    its first ``n_keep`` calls in ``store`` (the chunk's layers) and calls
    the wrapper."""
    import tracklab_torch.models.kpr as KM

    wrapper = KM.vit_attention

    def record(q, k, v, n_valid=None, softmax="f32"):
        if len(store) < n_keep:
            store.append((q, k, v, n_valid, softmax))
        return wrapper(q, k, v, n_valid, softmax=softmax)
    return wrapper, record


def phase_posetrack(torch, dev, card, n_videos=2, n_frames=60, n_objects=14,
                    prefix_frames=4, prefix_slots=16, hd_frames=None):
    """The KPR pose-tracking slice through ``tracklab_torch.main.main`` in
    this process, with seeded weights, on PoseTrack21-layout trees the
    script writes (``n_videos`` x ``n_frames`` JPEG frames, ``hd_frames``
    on the 1280 x 720 tree where given, the synthetic set's renders of
    ``n_objects`` people with keypoints; PoseTrack's labelled sequences run
    longer: a depth cut).

    (a) The main path as typed on a 1280 x 720 tree: ``dataset=posetrack21
    eval=posetrack21 pipeline=[bbox_detector,pose_estimator,reid,track]``
    with yolox.yaml (YOLOX-s 640, K3; its threshold calibrated to ~12
    detections a frame), topdown_batched.yaml (TopDownPose-s 256 x 192, K3),
    kpr.yaml (KPR ViT-B/16 384 x 128 f32 on host crops and host prompts,
    K4 in f32) and bpbreid_strong_sort.yaml with OKS motion (K1; its OKS
    gate opened to 0.99 for the seeded pose model's keypoints), staged
    and with engine.fused=true (``run_fused_gsr_video``, KPR on device
    crops and device prompts: not bit-equal to the staged run); no frame
    over 32 detections (TopDownPoseBatched's slots); 0 host syncs inside
    the fused program; the first ``prefix_frames`` frames of the first
    video of the staged run against device=cpu, stage by stage: the
    detector and pose model from the frames (detections at IoU >= 0.999,
    keypoint gaps reported: the seeded heatmaps' near-ties move many),
    then the pose model, KPR and BPBReID from the card's own detection
    rows, the CPU decoding the card's heatmaps (TopDownPose-s's own
    heatmaps within 1e-4 of the card's scale, the keypoints within 1e-3,
    embeddings within 1e-4 of their scale, the same track ids); the fused
    program's first chunk of ``prefix_frames`` frames with
    ``prefix_slots`` slots on the card against device=cpu
    (:func:`_fused_card_vs_cpu`); frames/s split per module; the
    PoseTrackEvaluator's results. The KPR attention inputs of the fused
    run's first chunk are kept for (c).
    Then the same on a 640 x 640 tree of ``n_frames`` frames a video (the
    letterbox the identity, the threshold calibrated on it) with
    KPReIdBatched and work sizes 640 x 640, 32 slots in the detector, the
    pose model, KPR and the tracker, staged and fused under cuDNN
    deterministic: at least half the frames with a free slot; fused equal
    to staged (rows, boxes, keypoints within 1e-3, embeddings within 1e-3
    of their scale, visibility, ids), the first frame where they part
    logged with its free slots.
    (b) The 3-module parts prefix on the 640 tree: YOLOX-s -> bpbreid.yaml
    (promptless KPReId) -> BPBReID with IoU motion fused
    (``run_fused_parts_video``) against the same prefix staged with
    KPReIdBatched (whose device embed function the fused program runs):
    the same checks.
    (c) K4 on the path: each of the 12 recorded layers of the typed fused
    run's first chunk (B * D = 8 x 64 crops, 193 tokens, 12 heads, 64)
    against the plain version of its softmax mode (f32, within 1e-5); K4's
    f32 time at that shape beside the plain version, SDPA in f32 (TF32 off)
    and its bound.

    Returns the stats, each run's kernel launches under its name, and K4's
    f32 figures."""
    import contextlib
    import shutil
    import tempfile
    from pathlib import Path

    import tracklab_torch.models.kpr as KM
    from tracklab_torch.kernels.vit_attention import (
        vit_attention, vit_attention_compute_plain, vit_attention_plain)

    stats = {}
    cpu_dev = ["device=cpu"] if dev.type == "cpu" else []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_posetrack_"))
    state = tmp / "typed_staged.pklz"
    recorded = []
    try:
        t0 = time.perf_counter()
        hd_frames = hd_frames or n_frames
        frames8 = _posetrack_tree(tmp / "hd", n_videos, hd_frames, n_objects)
        sq8 = _posetrack_tree(tmp / "sq", n_videos, n_frames, n_objects,
                              wh=(640, 640))
        log(f"posetrack: wrote {n_videos} x {hd_frames} JPEG frames of 1280 "
            f"x 720 and {n_videos} x {n_frames} of 640 x 640 in "
            f"{time.perf_counter() - t0:.1f} s")
        # each tree's own threshold, so that its frames have free slots
        thr, _ = _calibrate_cli(torch, dev, n_objects, per_frame=18,
                                born=8, frames=frames8)
        thr_sq, _ = _calibrate_cli(torch, dev, n_objects, per_frame=18,
                                   born=8, frames=sq8)
        log(f"posetrack: calibrated YOLOX-s min_confidence {thr} (1280 x "
            f"720), {thr_sq} (640 x 640)")
        base = ["use_rich=false", "dataset=posetrack21", "eval=posetrack21"]
        pose_mod = "+modules/pose_estimator=topdown_batched"
        conf = f"modules.bbox_detector.min_confidence={thr}"
        det_pose = ["+modules/bbox_detector=yolox", pose_mod, conf]
        reid_track = ["+modules/reid=kpr", "modules/track=bpbreid_strong_sort",
                      "modules.track.motion_criterium=oks",
                      # the seeded TopDownPose-s puts a box's keypoints
                      # within ~15 px of each other, where OKS falls off over
                      # a few px, so between frames it stays below the
                      # yaml's 0.3 and no track forms: the gate is opened to
                      # OKS >= 0.01
                      "modules.track.max_oks_distance=0.99"]
        typed = base + ["pipeline=[bbox_detector,pose_estimator,reid,track]"
                        ] + det_pose + reid_track

        # (a) as typed, staged then fused, on the 1280 x 720 tree
        runs = {}
        for fused in (False, True):
            name = f"typed_{'fused' if fused else 'staged'}"
            if fused:
                wrapper, record = _k4_recorder(recorded, 12)
                KM.vit_attention = record
            try:
                with (contextlib.nullcontext({}) if fused else
                      _model_tape(torch)) as tape:
                    parts, res, launches, split = _cli_run(
                        torch, typed + cpu_dev + [
                            f"data_dir={tmp / 'hd'}",
                            f"engine.fused={str(fused).lower()}"]
                        + ([] if fused else [f"state.save_file={state}"]),
                        ("loader", "program", "eval") if fused else
                        ("loader", "detect", "pose", "reid", "scan", "eval"))
            finally:
                if fused:
                    KM.vit_attention = wrapper
            pred = parts["tracker_state"].detections_pred
            runs[fused] = pred
            if not fused:
                staged_tape = tape
            most = int(pred.groupby("image_id").size().max())
            per_frame = len(pred) / split["frames"]
            syncs = (split["host_syncs_in_fused_program"] if fused else
                     split["host_syncs_in_scans"] / split["frames"])
            ev = _posetrack_results(res)
            log(f"posetrack (a) {name} on {card}: {_split_line(split)}; "
                f"device by stage {split['device_s_by_stage']}; "
                f"{per_frame:.2f} detections a frame (at most {most}), "
                f"{pred['track_id'].nunique()} tracks; host syncs "
                + (f"in the fused program {syncs}" if fused else
                   f"in the tracker scans {syncs:.3f} per frame")
                + f"; launches {launches}; PoseTrack results with random "
                f"weights {ev}")
            check(5 <= per_frame and most <= 32, f"posetrack (a) {name}: "
                  f"{per_frame:.2f} detections a frame, at most {most}")
            check(np.stack(pred["embeddings"].to_numpy()).shape[1:]
                  == (6, 512), "posetrack (a): the part embeddings are not "
                  "(6, 512)")
            check(np.isfinite(np.stack(pred["keypoints_xyc"].to_numpy())
                              ).all(), "posetrack (a): keypoints not finite")
            for k in ("K3", "K1", "K4"):
                check(launches[k] > 0, f"posetrack (a) {name}: {k} never "
                      "launched")
            if fused:
                check(split["fused_program_frames"] >= split["frames"],
                      "posetrack (a): the fused program did not run")
                check(syncs == 0, f"posetrack (a): {syncs} host syncs "
                      "inside the fused program")
            stats[name] = dict(split, launches=launches, results=ev,
                               detections_per_frame=per_frame,
                               most_per_frame=most, min_confidence=thr)
        stats["typed_fused_vs_staged"] = _typed_apart(runs[True], runs[False])
        log(f"posetrack (a): as typed, fused against staged (host crops and "
            f"prompts against device ones): {stats['typed_fused_vs_staged']}")
        # the first frames against the CPU, stage by stage: the detector and
        # the pose model from the frames, then the pose model, KPR and the
        # tracker from the card's own detection rows, the pose model's
        # heatmaps the card's (OKS over the seeded keypoints, clustered
        # within ~15 px, turns the detector's 1e-3 px card-vs-CPU box
        # differences into other associations; the seeded heatmaps' top two
        # values lie a few 1e-5 apart, so the card's and the CPU's own
        # heatmaps put many keypoints on other maxima)
        cpu = ["device=cpu", f"data_dir={tmp / 'hd'}", "engine.fused=false",
               "dataset.nvid=1", f"dataset.nframes={prefix_frames}"]
        head, _, _, cpu_split = _cli_run(
            torch, base + ["pipeline=[bbox_detector,pose_estimator]"]
            + det_pose + cpu,
            ("loader", "detect", "pose", "eval"))
        head = head["tracker_state"]
        m = _match_prefix(runs[False].assign(track_id=np.nan),
                          head.detections_pred.assign(track_id=np.nan),
                          head.image_metadatas.index)
        check(m["matched"] == m["card_rows"] == m["cpu_rows"] > 0,
              f"posetrack (a): detections differ from the CPU's: {m}")
        check(m["min_iou"] >= 0.999, f"posetrack (a): a detection matched "
              f"the CPU's at IoU {m['min_iou']:.6f}")
        card8 = runs[False][runs[False]["image_id"].isin(
            head.image_metadatas.index)]
        kp_gap, kp_apart = _matched_keypoint_gap(card8, head.detections_pred)
        with _model_tape(torch, replay=staged_tape) as cpu_tape:
            tail, _, _, tail_split = _cli_run(
                torch, base + ["pipeline=[pose_estimator,reid,track]"]
                + [pose_mod] + reid_track + cpu
                + [f"state.load_file={state}"],
                ("pose", "reid", "scan", "eval"))
        tail = tail["tracker_state"].detections_pred
        check(tail.index.equals(card8.index), "posetrack (a): the CPU's "
              "pose, KPR and tracker rows are not the card's")
        hm_rel = _maps_rel(cpu_tape["TopDownPose"],
                           staged_tape["TopDownPose"])
        check(hm_rel <= 1e-4, f"posetrack (a): TopDownPose-s heatmaps "
              f"{hm_rel:.2e} of their scale from the CPU's")
        d_kp = _same_keypoints(tail, card8, "posetrack (a) the card's "
                               "heatmaps decoded on the CPU")
        d_emb = _same_embeddings(tail, card8, "posetrack (a) KPR on the CPU "
                                 "from the card's rows", rel=1e-4)
        _same_rows(tail, card8, "posetrack (a) KPR and BPBReID on the CPU "
                   "from the card's rows")
        log(f"posetrack (a): the first {prefix_frames} frames of the first "
            f"video against device=cpu: detector and pose model from the "
            f"frames ({cpu_split['track_dataset_s']:.2f} s) {m}, keypoints "
            f"within {kp_gap:.2f} px ({kp_apart} of {17 * len(card8)} over 1 "
            f"px: near-ties); from the card's rows "
            f"({tail_split['track_dataset_s']:.2f} s): TopDownPose-s "
            f"heatmaps within {hm_rel:.2e} of their scale, the card's "
            f"heatmaps decoded to its keypoints "
            f"within {d_kp:.2e}, KPR's embeddings within {d_emb:.2e} of "
            f"their scale, {len(tail)} rows, "
            f"{int(tail['track_id'].notna().sum())} tracked rows, track ids "
            "equal")
        stats["cpu_prefix"] = dict(m, frames=prefix_frames,
                                   keypoints_max_px=kp_gap,
                                   keypoints_over_1px=kp_apart,
                                   heatmaps_rel=hm_rel,
                                   decoded_keypoints_max_diff=d_kp,
                                   embeddings_rel=d_emb,
                                   tracked_rows=int(
                                       tail["track_id"].notna().sum()),
                                   cpu_s=cpu_split["track_dataset_s"],
                                   cpu_pose_reid_track_s=tail_split[
                                       "track_dataset_s"])
        stats["fused_cpu_prefix"] = _fused_card_vs_cpu(
            torch, typed + cpu_dev + [
                f"data_dir={tmp / 'hd'}", "engine.fused=true",
                "dataset.nvid=1", f"dataset.nframes={prefix_frames}",
                f"modules.bbox_detector.batch_size={prefix_frames}"],
            prefix_slots)

        # (a) with KPReIdBatched, and (b) the parts prefix, on the 640 tree:
        # the detector's, the pose model's, KPR's and the tracker's slots
        # set equal (32), since the fused program embeds and tracks the
        # detector's slots and the staged modules their own. Where the
        # runs part, the first frame that differs is logged with its free
        # slots: StrongSORT's default-mode appearance stage matches nothing
        # while a detection slot is free (ROADMAP section 3)
        slots = ["modules.bbox_detector.max_dets=32",
                 "modules.track.max_dets=32",
                 f"modules.bbox_detector.min_confidence={thr_sq}"]
        batched = ["modules.reid._target_=tracklab_torch.wrappers.reid."
                   "KPReIdBatched", "+modules.reid.work_size=[640,640]",
                   "+modules.reid.max_dets=32", "modules.reid.batch_size=8"]
        pose64 = ["modules.pose_estimator.work_size=[640,640]",
                  "modules.pose_estimator.max_dets=32",
                  "modules.pose_estimator.batch_size=8"]
        parts3 = ["use_rich=false", "dataset=posetrack21",
                  "eval=posetrack21", "pipeline=[bbox_detector,reid,track]",
                  "+modules/bbox_detector=yolox", "+modules/reid=bpbreid",
                  "modules/track=bpbreid_strong_sort"]
        typed_sq = [a for a in typed if a != conf]
        cases = {
            "batched_staged": (typed_sq + slots + pose64 + batched, False),
            "batched_fused": (typed_sq + slots + pose64 + batched, True),
            "parts_staged": (parts3 + slots + batched, False),
            "parts_fused": (parts3 + slots, True)}
        eq = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for name, (args, fused) in cases.items():
                timed = ("loader", "program", "eval") if fused else (
                    ("loader", "detect", "embed", "scan", "eval")
                    if name.startswith("parts") else
                    ("loader", "detect", "pose", "embed", "scan", "eval"))
                parts, res, launches, split = _cli_run(
                    torch, args + cpu_dev + [
                        f"data_dir={tmp / 'sq'}",
                        f"engine.fused={str(fused).lower()}"], timed)
                pred = parts["tracker_state"].detections_pred
                eq[name] = pred
                per_image = pred.groupby("image_id").size()
                free = int((per_image < 32).sum())
                log(f"posetrack ({'b' if name.startswith('parts') else 'a'})"
                    f" {name} on {card}: {_split_line(split)}; device by "
                    f"stage {split['device_s_by_stage']}; "
                    f"{len(pred) / split['frames']:.2f} detections a frame "
                    f"(at most {int(per_image.max())}), {free} of "
                    f"{split['frames']} frames with a free slot; launches "
                    f"{launches}; host syncs in the fused program "
                    f"{split['host_syncs_in_fused_program']}; PoseTrack "
                    f"results {_posetrack_results(res)}")
                for k in ("K3", "K1", "K4"):
                    check(launches[k] > 0, f"posetrack {name}: {k} never "
                          "launched")
                check(2 * free >= split["frames"], f"posetrack {name}: "
                      f"{free} of {split['frames']} frames with a free slot")
                if fused:
                    check(split["fused_program_frames"] >= split["frames"],
                          f"posetrack {name}: the fused program did not run")
                    check(split["host_syncs_in_fused_program"] == 0,
                          f"posetrack {name}: "
                          f"{split['host_syncs_in_fused_program']} host "
                          "syncs inside the fused program")
                stats[name] = dict(split, launches=launches,
                                   results=_posetrack_results(res),
                                   detections_per_frame=len(pred)
                                   / split["frames"],
                                   frames_with_a_free_slot=free)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        for what, f, s in (("(a) KPReIdBatched", "batched_fused",
                            "batched_staged"),
                           ("(b) the parts prefix", "parts_fused",
                            "parts_staged")):
            parting = _first_parting(eq[f], eq[s], 32)
            if parting is not None:
                log(f"posetrack {what}: fused and staged part first on "
                    f"{parting} (fused, staged)")
            stats[f"{f}_first_parting"] = parting
            _same_rows(eq[f], eq[s], f"posetrack {what} fused vs staged")
            d_emb = _same_embeddings(eq[f], eq[s],
                                     f"posetrack {what} fused vs staged")
            d_kp = (_same_keypoints(eq[f], eq[s], f"posetrack {what} fused "
                                    "vs staged")
                    if "keypoints_xyc" in eq[s] else None)
            stats[f"{f}_vs_staged"] = dict(embeddings_rel=d_emb,
                                           keypoints_max_diff=d_kp,
                                           rows=len(eq[s]))
            log(f"posetrack {what}: fused equals staged ({len(eq[s])} rows, "
                f"embeddings within {d_emb:.2e} of their scale, keypoints "
                f"within {d_kp})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) K4 on the recorded layers of the fused run's first chunk
    check(len(recorded) == 12, f"posetrack (c): {len(recorded)} attention "
          "calls recorded")
    errs = []
    for i, (q, k, v, n_valid, softmax) in enumerate(recorded):
        check(q.dtype == torch.float32, "posetrack (c): KPR's attention is "
              f"not f32 ({q.dtype})")
        errs.append(_check_k4(torch, q, k, v, n_valid,
                              f"posetrack path layer {i} {tuple(q.shape)}",
                              softmax))
    q, k, v, n_valid, softmax = recorded[0]
    plain = (vit_attention_compute_plain if softmax == "compute"
             else vit_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    with torch.no_grad():
        ms = cuda_ms(lambda: vit_attention(q, k, v, n_valid,
                                           softmax=softmax), 10)
        plain_ms = cuda_ms(lambda: plain(q, k, v, n_valid), 3)
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt), 10)
    B, N, H, Dh = q.shape
    b_ms, b_by, b_term = bound_ms_f32(4 * B * N * H * Dh * q.element_size(),
                                      4 * B * H * N * N * Dh)
    k4_f32 = dict(shape=[B, N, H, Dh], dtype="f32", softmax=softmax,
                  layers_checked=len(errs), max_abs_err=max(errs), ms=ms,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                  bound_by=b_by, bound_term=b_term)
    log(f"posetrack (c): K4 f32 ({softmax} softmax) on the path's "
        f"{len(errs)} layers within {max(errs):.2e} of its plain version; at "
        f"{tuple(q.shape)}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA f32 (yardstick) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; operations at the "
        f"{b_term} rate)")
    recorded.clear()
    stats["k4_f32_on_path"] = k4_f32
    return stats, k4_f32


def _matched_keypoint_gap(a, b):
    """The largest keypoint coordinate gap (px) between the rows of two runs
    matched frame by frame by IoU (as :func:`_match_prefix`), and the
    number of keypoints more than 1 px apart."""
    from scipy.optimize import linear_sum_assignment

    gap, apart = 0.0, 0
    for iid in a["image_id"].unique():
        x, y = a[a["image_id"] == iid], b[b["image_id"] == iid]
        if not len(x) or not len(y):
            continue
        iou = _iou_ltwh(np.stack(x["bbox_ltwh"].to_numpy()),
                        np.stack(y["bbox_ltwh"].to_numpy()))
        r, c = linear_sum_assignment(-iou)
        kx = np.stack(x["keypoints_xyc"].to_numpy())[r, :, :2]
        ky = np.stack(y["keypoints_xyc"].to_numpy())[c, :, :2]
        d = np.abs(kx - ky).max(-1)
        gap, apart = max(gap, float(d.max())), apart + int((d > 1).sum())
    return gap, apart


def _model_tape(torch, replay=None):
    """A context in which the first forward of the YOLOX and TopDownPose
    models and the first call of ``models.pose.decode_heatmaps`` (the
    heatmaps after the sigmoid) are kept, as copies on their device (no
    host sync), in the dict it yields under "YOLOX", "TopDownPose" and
    "decode". Given ``replay`` (another run's dict), each of those calls
    then goes on with the replay's tensors, moved to the call's device: the
    rest of the program runs on the other run's model outputs and decodes
    its heatmaps, while each model's own output is kept for comparing the
    models apart."""
    from contextlib import contextmanager

    import tracklab_torch.models.pose as PM
    from tracklab_torch.models.yolox import YOLOX

    def like(src, ref):
        if isinstance(ref, (list, tuple)):
            return type(ref)(like(x, r) for x, r in zip(src, ref))
        check(src.shape == ref.shape, f"replay: shape {tuple(src.shape)} "
              f"for a call of shape {tuple(ref.shape)}")
        return src.to(ref.device, ref.dtype)

    def keep(x):
        if isinstance(x, (list, tuple)):
            return type(x)(keep(t) for t in x)
        return x.detach().clone()

    @contextmanager
    def ctx():
        tape, decode = {}, PM.decode_heatmaps

        def hook(mod, inp, out):
            key = type(mod).__name__
            if type(mod) not in (YOLOX, PM.TopDownPose) or key in tape:
                return None
            tape[key] = keep(out)
            return like(replay[key], out) if replay and key in replay \
                else None

        def taped_decode(heatmaps):
            if "decode" not in tape:
                tape["decode"] = keep(heatmaps)
                if replay and "decode" in replay:
                    heatmaps = like(replay["decode"], heatmaps)
            return decode(heatmaps)

        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        PM.decode_heatmaps = taped_decode
        try:
            yield tape
        finally:
            handle.remove()
            PM.decode_heatmaps = decode

    return ctx()


def _maps_rel(a, b):
    """The largest gap between two lists of maps over ``b``'s largest
    magnitude."""
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    return max(float((x.float().cpu() - y.float().cpu()).abs().max()
                     / y.float().abs().max()) for x, y in zip(a, b))


def _first_parting(a, b, slots):
    """The first frame (in ``image_id`` order) on which two runs' rows or
    track ids differ: its image id, each run's detections on it and the
    free detection slots of ``slots``; None when they never part."""
    for iid in sorted(set(a["image_id"]) | set(b["image_id"])):
        x, y = a[a["image_id"] == iid], b[b["image_id"] == iid]
        if not x.index.equals(y.index) or not np.array_equal(
                x["track_id"].to_numpy(float), y["track_id"].to_numpy(float),
                equal_nan=True):
            return dict(image_id=int(iid), detections=(len(x), len(y)),
                        free_slots=(slots - len(x), slots - len(y)))
    return None


def _fused_card_vs_cpu(torch, args, slots):
    """The fused program as typed (``args``: the first chunk of one video)
    on the card and with device=cpu, the detector and the tracker at
    ``slots`` slots. The CPU run goes on from the card's YOLOX maps and
    decodes the card's heatmaps (:func:`_model_tape`), each model's own
    output held to the card's within 1e-4 of its scale; then the rows,
    boxes, track ids and track boxes (:func:`_same_rows`), the keypoints
    within 1e-3 px and the embeddings within 1e-4 of their scale. Returns
    the figures."""
    args = args + [f"modules.bbox_detector.max_dets={slots}",
                   f"modules.track.max_dets={slots}"]
    timed = ("loader", "program", "eval")
    with _model_tape(torch) as card_tape:
        card, _, _, _ = _cli_run(torch, args, timed)
    with _model_tape(torch, replay=card_tape) as cpu_tape:
        cpu, _, _, cpu_split = _cli_run(
            torch, [a for a in args if a != "device=cpu"] + ["device=cpu"],
            timed)
    frames = len(card["tracker_state"].image_pred)
    card, cpu = (x["tracker_state"].detections_pred for x in (card, cpu))
    what = "posetrack (a) the fused program on the CPU"
    det_rel = _maps_rel(cpu_tape["YOLOX"], card_tape["YOLOX"])
    hm_rel = _maps_rel(cpu_tape["TopDownPose"], card_tape["TopDownPose"])
    check(det_rel <= 1e-4, f"{what}: YOLOX-s maps {det_rel:.2e} of their "
          "scale from the card's")
    check(hm_rel <= 1e-4, f"{what}: TopDownPose-s heatmaps {hm_rel:.2e} of "
          "their scale from the card's")
    _same_rows(cpu, card, what)
    d_kp = _same_keypoints(cpu, card, what)
    d_emb = _same_embeddings(cpu, card, what, rel=1e-4)
    out = dict(rows=len(card), slots=slots, frames=frames,
               tracked_rows=int(card["track_id"].notna().sum()),
               yolox_maps_rel=det_rel, heatmaps_rel=hm_rel,
               keypoints_max_diff=d_kp, embeddings_rel=d_emb,
               cpu_s=cpu_split["track_dataset_s"])
    log(f"posetrack (a): the fused program's first chunk ({frames} "
        f"frames of 1280 x 720, {slots} slots) on the card against "
        f"device=cpu, the CPU on the card's YOLOX-s maps and heatmaps: "
        f"YOLOX-s maps within {det_rel:.2e} and TopDownPose-s heatmaps "
        f"within {hm_rel:.2e} of their scale; {len(card)} rows, "
        f"{out['tracked_rows']} tracked, boxes and track ids equal, "
        f"keypoints within {d_kp:.2e}, embeddings within {d_emb:.2e} of "
        f"their scale ({cpu_split['track_dataset_s']:.2f} s on the CPU)")
    return out


def _typed_apart(fused, staged):
    """How far the as-typed fused run (device crops and prompts) lies from
    the staged one (host crops and prompts): rows, tracked rows and equal
    track ids, keypoint and embedding gaps."""
    same_rows = fused.index.equals(staged.index)
    out = dict(same_rows=bool(same_rows), rows=len(staged))
    if same_rows:
        kf = np.stack(fused["keypoints_xyc"].to_numpy())
        ks = np.stack(staged["keypoints_xyc"].to_numpy())
        ef = np.stack(fused["embeddings"].to_numpy())
        es = np.stack(staged["embeddings"].to_numpy())
        tf, ts = (x["track_id"].to_numpy(float) for x in (fused, staged))
        both = ~np.isnan(tf) & ~np.isnan(ts)
        out.update(keypoints_max_px=float(np.abs(kf - ks)[..., :2].max()),
                   embeddings_rel=float(np.abs(ef - es).max()
                                        / np.abs(es).max()),
                   tracked_in_both=int(both.sum()),
                   equal_track_ids=int((tf[both] == ts[both]).sum()))
    return out


def phase_k3_routes_f32(torch, dev, batch=8, size=640):
    """K3's f32 route (3xTF32, the staged one) for each dense CSPLayer of
    YOLOX-s at ``size``, batch ``batch`` (the CLI detector's shapes), on
    the layer's own input from one seeded forward: timed beside the plain
    layer (cuDNN convolutions, TF32 off) and held within rel 1e-4 of it;
    the seven layers' sum beside their bound."""
    from tracklab_torch.kernels.csp import STAGED, choose_tile
    from tracklab_torch.models.yolox import CSP_MAX_PIXELS, YOLOX, CSPLayer

    model = YOLOX(num_classes=1, variant="s", device=dev).randomize_(0)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(0, 256, (batch, size, size, 3), generator=g,
                      device=dev).float()
    taken = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, inp, name=name: taken.append((name, mod,
                                                  inp[0].clone())))
        for name, mod in model.named_modules() if isinstance(mod, CSPLayer)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    rows, tot = [], dict(k3_ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    for name, mod, inp in taken:
        H, W = inp.shape[2:]
        if mod.depthwise or H * W > CSP_MAX_PIXELS:
            continue
        w1, w3 = mod.conv1.conv.weight, mod.conv3.conv.weight
        cin, ch, cout, n = w1.shape[1], w1.shape[0], w3.shape[0], len(mod.m)
        plan = choose_tile(H, W, n, cin, ch, cout, mod.dtype)
        check(plan == (H, W, STAGED),
              f"K3 f32 {name}: plan {plan}, not the staged route")
        with torch.no_grad():
            want = mod.forward_plain(inp)
            plain = cuda_ms(lambda: mod.forward_plain(inp), 10)
            r = _rel(mod(inp), want)
            ms = cuda_ms(lambda: mod(inp), 10)
        check(r <= 1e-4, f"K3 f32 {name}: rel {r:.2e} from the plain layer")
        rows.append(dict(layer=name, hw=[H, W], cin=cin, n=n, route="staged",
                         k3_ms=ms, plain_ms=plain, rel=r))
        tot["k3_ms"] += ms
        tot["plain_ms"] += plain
        tot["bytes"] += batch * H * W * (cin + cout) * 4
        tot["flops"] += batch * 2 * H * W * ch * (2 * cin + 10 * n * ch
                                                  + 2 * cout)
    for r in rows:
        log(f"K3 f32 YOLOX-s {size} batch {batch} {r['layer']} "
            f"{r['hw'][0]}x{r['hw'][1]} cin {r['cin']} n {r['n']}: "
            f"{r['route']} route, K3 {r['k3_ms']:.3f} ms, plain (cuDNN) "
            f"{r['plain_ms']:.3f} ms, rel {r['rel']:.1e}")
    b_ms, b_by, b_term = bound_ms_f32(tot["bytes"], tot["flops"])
    log(f"K3 f32 YOLOX-s {size} batch {batch}: {len(rows)} layers, K3 "
        f"{tot['k3_ms']:.3f} ms against plain {tot['plain_ms']:.3f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}; operations at the {b_term} rate)")
    return dict(layers=rows, k3_ms=tot["k3_ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, bound_term=b_term)


def _kernel_ms_in(torch, fn, name, top=8):
    """Device time of the kernels whose name contains ``name`` during one
    call of ``fn``, and the ``top`` kernels by device time (name, ms), from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ms = sum(e.self_device_time_total for e in kernels if name in e.key)
    return ms / 1e3, [(e.key[:72], e.self_device_time_total / 1e3)
                      for e in kernels[:top]]



def _zoo_detector_runs(torch, dev, card, what, group, det, tree, frames8,
                       n_objects, fused, prefix_frames, cpu_dev):
    """One detector of the zoo -> OC-SORT through the command line on the
    MOT17-layout ``tree``: thresholds calibrated on ``frames8`` through the
    detector's own input (``_calibrate_cli``), staged and (with ``fused``)
    fused runs, fused equal to staged with 0 host syncs inside the fused
    program, K1 and ORU launched, and the first ``prefix_frames`` frames of
    the staged run against a device=cpu run (detections at IoU >= 0.999,
    the same track ids). Returns (stats by run, the staged run's parts)."""
    thr, born = _calibrate_cli(torch, dev, n_objects, frames=frames8,
                               detector=det, own_input=True)
    args = ["use_rich=false", "+experiment=mot17_ocsort",
            f"data_dir={tree}"] + group + [
        f"modules.bbox_detector.min_confidence={thr}",
        f"modules.track.min_confidence={thr}",
        f"modules.track.det_thresh={born}"]
    stats, runs, staged_parts = {}, {}, None
    # staged first: a fresh process's first tracker scans sync
    for f in (False, True) if fused else (False,):
        run = "fused" if f else "staged"
        parts, res, launches, split = _cli_run(
            torch, args + cpu_dev + [f"engine.fused={str(f).lower()}"],
            ("loader", "program", "eval") if f
            else ("loader", "detect", "scan", "eval"))
        pred = parts["tracker_state"].detections_pred
        runs[f] = pred
        staged_parts = staged_parts or parts
        per_frame = len(pred) / split["frames"]
        log(f"zoo {what} {run} on {card}: {_split_line(split)}; device by "
            f"stage {split['device_s_by_stage']}; {per_frame:.2f} "
            f"detections/frame, {pred['track_id'].nunique()} tracks; "
            f"launches {launches}; host syncs in the fused program "
            f"{split['host_syncs_in_fused_program']}, in the scans "
            f"{split['host_syncs_in_scans']}")
        check(5 <= per_frame <= 64,
              f"zoo {what} {run}: {per_frame:.2f} detections/frame")
        for k in ("K1", "ORU"):
            check(launches[k] > 0, f"zoo {what} {run}: {k} never launched")
        if f:
            check(split["fused_program_frames"] >= split["frames"],
                  f"zoo {what}: the fused program did not run")
            check(split["host_syncs_in_fused_program"] == 0,
                  f"zoo {what}: {split['host_syncs_in_fused_program']} host "
                  "syncs inside the fused program")
        stats[run] = dict(split, launches=launches,
                          detections_per_frame=per_frame, min_confidence=thr,
                          det_thresh=born)
    if fused:
        _same_rows(runs[True], runs[False], f"zoo {what} fused vs staged")
        log(f"zoo {what}: fused equals staged ({len(runs[True])} rows)")
    # the CPU's batch is the prefix, not padded to the card's 8
    cpu_parts, _, _, cpu_split = _cli_run(
        torch, args + ["device=cpu", f"dataset.nframes={prefix_frames}",
                       f"modules.bbox_detector.batch_size={prefix_frames}"],
        ("loader", "detect", "scan", "eval"))
    m = _match_prefix(runs[False], cpu_parts["tracker_state"].detections_pred,
                      cpu_parts["tracker_state"].image_metadatas.index)
    log(f"zoo {what}: the first {prefix_frames} frames on the card against "
        f"device=cpu ({cpu_split['track_dataset_s']:.2f} s): {m}")
    check(m["matched"] == m["card_rows"] == m["cpu_rows"] > 0,
          f"zoo {what}: detections differ from the CPU's: {m}")
    check(m["min_iou"] >= 0.999, f"zoo {what}: a detection matched the "
          f"CPU's at IoU {m['min_iou']:.6f}")
    check(m["other_track_ids"] == 0 and m["tracked_in_one"] == 0
          and m["tracked_in_both"] > 0,
          f"zoo {what}: card and CPU tracks differ: {m}")
    stats["cpu_prefix"] = dict(m, cpu_s=cpu_split["track_dataset_s"])
    return stats, staged_parts


def _stretch_batch(torch, dev, det, frames):
    """``frames`` through the detector's own ``preprocess``, stacked on
    ``dev`` as the model's input (pixels / 255)."""
    imgs = np.stack([det.preprocess(f, None, None)["image"] for f in frames])
    return torch.from_numpy(imgs).to(dev).float() / 255.0


def _rtdetr_hf_split(torch, model, x):
    """CUDA-event ms of one RT-DETR HF forward on ``x`` and of its
    backbone and its encoder (input projections + hybrid encoder) alone;
    the decoder's share is the rest (decoder projections, anchors, query
    selection, the decoder layers and heads); the deformable sampling's
    own kernels (``grid_sampler``) from torch.profiler over one forward."""
    core = model.model
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        feats = core.backbone(xc)
        total = cuda_ms(lambda: model(x), 5)
        backbone = cuda_ms(lambda: core.backbone(xc), 5)
        encoder = cuda_ms(lambda: core.encoder(
            [p(f) for p, f in zip(core.encoder_input_proj, feats)]), 5)
        grid, top = _kernel_ms_in(torch, lambda: model(x), "grid_sampler")
    decoder = total - backbone - encoder
    return dict(batch=int(x.shape[0]), forward_ms=total, backbone_ms=backbone,
                encoder_ms=encoder, decoder_ms=decoder,
                shares={k: v / total for k, v in (
                    ("backbone", backbone), ("encoder", encoder),
                    ("decoder", decoder))},
                grid_sample_ms=grid, grid_sample_share=grid / total,
                top_kernels=top)


def _encoder_topk_gap(torch, model, x, cpu_model):
    """The encoder's top-``num_queries`` selection on the card and on the
    CPU for the same input: whether the selected sets agree per frame, and
    the card's score gap between the last selected and the first left out
    (its smallest over the frames)."""
    scores = []
    hook = model.model.enc_score_head.register_forward_hook(
        lambda mod, inp, out: scores.append(out.amax(-1)))
    try:
        with torch.no_grad():
            _, _, topk = model(x, return_topk=True)
    finally:
        hook.remove()
    with torch.no_grad():
        _, _, topk_cpu = cpu_model(x.cpu(), return_topk=True)
    q = topk.shape[1]
    srt = torch.sort(scores[0], dim=-1, descending=True).values
    gaps = (srt[:, q - 1] - srt[:, q]).cpu().numpy()
    same = [set(a.tolist()) == set(b.tolist())
            for a, b in zip(topk.cpu(), topk_cpu)]
    return dict(queries=q, same_sets=same, min_gap_at_rank=float(gaps.min()),
                score_scale=float(srt.abs().max()))


def phase_zoo(torch, dev, card, n_videos=2, n_frames=40, n_objects=24,
              prefix_frames=4, topk_frames=2, seg_frames=8,
              seg_cpu_frames=2):
    """The detector zoo and DeepLabV3 through ``tracklab_torch.main.main``
    and their modules, with seeded weights, in f32.

    On a MOT17-layout tree the script writes (``n_videos`` x ``n_frames``
    PNG frames of 1920 x 1080; ``_mot17_tree``), each detector -> OC-SORT
    (K1, ORU) with its thresholds calibrated to ~25 detections a frame
    (``_zoo_detector_runs``: fused equal to staged, 0 host syncs in the
    fused program, the first ``prefix_frames`` frames against the CPU):
    (a) ``modules/bbox_detector=rtdetr_hf`` (RT-DETR r50vd at 640, one
    class), staged and fused; one forward of 8 frames split into backbone,
    encoder and decoder (``_rtdetr_hf_split``: CUDA events; the deformable
    sampling's own kernels by torch.profiler), and the encoder's top-300
    on ``topk_frames`` frames against the CPU's with its score gap at rank
    300;
    (b) ``modules/bbox_detector=rtmdet`` (nano at 320), staged and fused;
    (c) ``modules/bbox_detector=rtdetr`` (the lightweight RT-DETR-s at 640,
    100 queries), staged (it has no fused closure), and K3 at its
    CSPDarknet's dense layers against the plain layers (``_csp_vs_plain``).
    (d) ``PitchLineDetector(variant="deeplabv3")`` (ResNet-101, output
    stride 8) at 288 x 512 over ``seg_frames`` frames of the tree: ms per
    batch, logits of the first ``seg_cpu_frames`` against the CPU (within
    1e-4 of their scale), the argmax equal wherever the top two are
    1e-5 of the scale apart or more, and the pitch lines of those frames
    equal to the CPU's where the class maps agree.

    Returns the stats; each run's kernel launches under its name."""
    import copy
    import shutil
    import tempfile
    from pathlib import Path

    from tracklab_torch.models.segmentation import extract_segment_points
    from tracklab_torch.wrappers.bbox_detector import (RTDETRDetector,
                                                       RTMDetDetector)
    from tracklab_torch.wrappers.calibration_api import PitchLineDetector

    stats = {}
    cpu_dev = ["device=cpu"] if dev.type == "cpu" else []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_zoo_"))
    try:
        t0 = time.perf_counter()
        frames8 = _mot17_tree(torch, dev, tmp, n_videos, n_frames, n_objects)
        log(f"zoo: wrote {n_videos} x {n_frames} PNG frames of 1920 x 1080 "
            f"in {time.perf_counter() - t0:.1f} s")

        # (a) the HF RT-DETR
        hf = RTDETRDetector(variant="r50vd", num_classes=1,
                            min_confidence=0.0, device=dev)
        runs, parts = _zoo_detector_runs(
            torch, dev, card, "(a) RT-DETR r50vd", [
                "modules/bbox_detector=rtdetr_hf",
                "modules.bbox_detector.num_classes=1"], hf, tmp, frames8,
            n_objects, True, prefix_frames, cpu_dev)
        stats.update({f"rtdetr_hf_{k}": v for k, v in runs.items()})
        model = parts["modules"][0]._model
        x = _stretch_batch(torch, dev, hf, frames8)
        split = _rtdetr_hf_split(torch, model, x) if dev.type == "cuda" \
            else {}
        cpu_model = copy.deepcopy(model).cpu()
        gap = _encoder_topk_gap(torch, model, x[:topk_frames], cpu_model)
        del cpu_model
        log(f"zoo (a) RT-DETR r50vd 640 f32 on {card}, one forward of "
            f"{len(x)} frames: {split}; the encoder's top-{gap['queries']} "
            f"on the card and the CPU: the same sets {gap['same_sets']}, the "
            f"card's gap at rank {gap['queries']} "
            f"{gap['min_gap_at_rank']:.3e} "
            f"(scores up to {gap['score_scale']:.3e})")
        check(all(gap["same_sets"]), f"zoo (a): the encoder's top-k parts "
              f"from the CPU's: {gap}")
        stats["rtdetr_hf_forward"] = dict(split, encoder_topk=gap)

        # (b) RTMDet
        runs, _ = _zoo_detector_runs(
            torch, dev, card, "(b) RTMDet-nano",
            ["modules/bbox_detector=rtmdet"],
            RTMDetDetector(min_confidence=0.0, device=dev), tmp, frames8,
            n_objects, True, prefix_frames, cpu_dev)
        stats.update({f"rtmdet_{k}": v for k, v in runs.items()})

        # (c) the lightweight RT-DETR, staged
        light = RTDETRDetector(variant="s", num_classes=1,
                               min_confidence=0.0, device=dev)
        runs, parts = _zoo_detector_runs(
            torch, dev, card, "(c) RT-DETR-s", [
                "modules/bbox_detector=rtdetr"], light, tmp, frames8,
            n_objects, False, prefix_frames, cpu_dev)
        check(runs["staged"]["launches"]["K3"] > 0 or dev.type == "cpu",
              "zoo (c): K3 never launched")
        stats.update({f"rtdetr_s_{k}": v for k, v in runs.items()})
        model = parts["modules"][0]._model
        x = _stretch_batch(torch, dev, parts["modules"][0], frames8)
        stats["rtdetr_s_k3"] = _csp_vs_plain(
            torch, model, x, "zoo (c) RT-DETR-s 640 f32") \
            if dev.type == "cuda" else {}

        # (d) DeepLabV3 in PitchLineDetector
        seg = PitchLineDetector(variant="deeplabv3", device=dev)
        imgs = np.stack([seg.preprocess(f, None, None)["image"]
                         for f in (frames8 * seg_frames)[:seg_frames]])
        images = torch.from_numpy(imgs).to(dev)
        seg._build()
        if dev.type == "cuda":
            ms = cuda_ms(lambda: seg.infer(images), 5)
            fwd_ms = cuda_ms(lambda: seg._model(images.float()), 5)
        else:
            ms = fwd_ms = float("nan")
        # the same seeded weights on the CPU
        cpu_seg = PitchLineDetector(variant="deeplabv3", device="cpu")
        cpu_seg._build()
        n = seg_cpu_frames
        norm = (images[:n].float() - torch.tensor(
            [0.485, 0.456, 0.406], device=dev) * 255.0) / (torch.tensor(
                [0.229, 0.224, 0.225], device=dev) * 255.0)
        with torch.no_grad():
            card_logits = seg._model(norm)["out"].cpu()
            cpu_logits = cpu_seg._model(norm.cpu())["out"]
        scale = float(cpu_logits.abs().max())
        rel = float((card_logits - cpu_logits).abs().max()) / scale
        top2 = torch.sort(cpu_logits, dim=-1).values[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) >= 1e-5 * scale
        apart = int(((card_logits.argmax(-1) != cpu_logits.argmax(-1))
                     & clear).sum())
        cmap_card = seg._class_map(images[:n]).cpu()
        cmap_cpu = cpu_seg._class_map(images[:n].cpu())
        map_apart = int((cmap_card != cmap_cpu).sum())
        xy_card, v_card = (t.cpu() for t in seg.infer(images[:n]))
        # where the maps agree the CPU's own lines must be the card's; where
        # a near-tie moved a pixel, the CPU extracts from the card's map
        xy_cpu, v_cpu = (cpu_seg.infer(images[:n].cpu()) if map_apart == 0
                         else extract_segment_points(
                             cmap_card, seg.num_classes,
                             seg.points_per_line))
        lines_equal = bool(torch.equal(v_card, v_cpu)
                           and torch.equal(xy_card[v_card], xy_cpu[v_cpu]))
        counts = np.bincount(cmap_card.flatten().numpy(),
                             minlength=seg.num_classes)
        log(f"zoo (d) DeepLabV3-ResNet101 288x512 f32 on {card}: "
            f"{ms:.3f} ms per batch of {seg_frames} (class map, LUT and "
            f"points; the forward alone {fwd_ms:.3f}); logits of {n} frames "
            f"{rel:.2e} of their scale ({scale:.3e}) from the CPU's; argmax "
            f"apart at {apart} clear pixels, {int((~clear).sum())} near-tie "
            f"pixels; segment maps apart at {map_apart} pixels; segment "
            f"classes present {int((counts[1:] > 0).sum())}, valid points "
            f"{int(v_card.sum())}; pitch lines "
            f"{'equal' if lines_equal else 'apart'} (the CPU's own"
            f"{'' if map_apart == 0 else ' extraction from the card map'})")
        check(rel <= 1e-4, f"zoo (d): DeepLabV3 logits {rel:.2e} of their "
              "scale from the CPU's")
        check(apart == 0, f"zoo (d): the argmax parts from the CPU's at "
              f"{apart} pixels that are no near-tie")
        check(lines_equal, "zoo (d): pitch lines differ between devices")
        stats["deeplabv3"] = dict(
            batch=seg_frames, ms_per_batch=ms, forward_ms=fwd_ms,
            logits_rel=rel, argmax_apart=apart,
            near_tie_pixels=int((~clear).sum()), map_apart=map_apart,
            valid_points=int(v_card.sum()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return stats


ZOO_KEYS = ("resnet50", "resnext50_32x4d", "resnet50_ibn_a", "resnet50_ibn_b",
            "mobilenetv2_x1_0", "shufflenet_v2_x1_0", "osnet_ain_x1_0",
            "se_resnet50", "resnet50mid", "pcb_p6", "densenet121",
            "squeezenet1_0", "mlfn", "xception", "hacnn", "mudeep",
            "inceptionv4", "inceptionresnetv2", "nasnetamobile")


def _crop_windows(rows):
    """``crop_bbox``'s integer windows (x1, y1, x2, y2) of ltwh rows,
    before the clamp to the image."""
    b = np.stack(rows["bbox_ltwh"].to_numpy()).astype(float)
    return np.stack([b[:, 0], b[:, 1], b[:, 0] + b[:, 2],
                     b[:, 1] + b[:, 3]], 1).astype(int)


def _matched_embedding_gap(card, cpu, image_ids):
    """The rows of ``image_ids`` of two runs matched frame by frame by IoU
    (as ``_match_prefix``): the largest embedding difference over the CPU
    embeddings' scale on the matched rows whose crop windows are equal
    (a box that rounds to another window crops other pixels), and the
    counts of compared rows and of rows left out for their windows."""
    from scipy.optimize import linear_sum_assignment

    pairs, other_window = [], 0
    for iid in image_ids:
        a = card[card["image_id"] == iid]
        b = cpu[cpu["image_id"] == iid]
        if not len(a) or not len(b):
            continue
        iou = _iou_ltwh(np.stack(a["bbox_ltwh"].to_numpy()),
                        np.stack(b["bbox_ltwh"].to_numpy()))
        r, c = linear_sum_assignment(-iou)
        keep = iou[r, c] >= 0.5
        r, c = r[keep], c[keep]
        same = (_crop_windows(a.iloc[r]) == _crop_windows(b.iloc[c])).all(1)
        other_window += int((~same).sum())
        ea = np.stack(a["embeddings"].to_numpy())[r[same]]
        eb = np.stack(b["embeddings"].to_numpy())[c[same]]
        pairs += list(zip(ea, eb))
    if not pairs:
        return dict(compared=0, other_window=other_window, rel=float("nan"))
    ea, eb = (np.stack(x) for x in zip(*pairs))
    return dict(compared=len(pairs), other_window=other_window,
                rel=float(np.abs(ea - eb).max() / np.abs(eb).max()))


def phase_reid_zoo(torch, dev, card, n_videos=2, n_frames=40, n_objects=24,
                   prefix_frames=8, check_batch=4, time_batch=32,
                   keys=ZOO_KEYS):
    """The ReID backbone zoo, seeded weights, f32 with TF32 off.

    (a) ``modules/reid=backbone_zoo`` as the command line runs it:
    ``tracklab_torch.main.main`` with pipeline [bbox_detector, reid, track],
    yolox.yaml (YOLOX-s 640, K3) -> backbone_zoo.yaml (resnet50_ibn_a at
    256 x 128 on host crops, batch 32, 2048-d) -> strong_sort.yaml (K1) at
    embed_dim 2048, staged, on the synthetic set (``n_videos`` x
    ``n_frames`` x ``n_objects`` at 640 x 640) with thresholds calibrated
    by ``_calibrate_cli``: K3 and K1 launched, 0 host syncs in the (warm)
    tracker scans, frames/s and the split printed; the first
    ``prefix_frames`` frames of the first video rerun with device=cpu, the
    rows matched by IoU, track ids equal on the matched rows and the
    embeddings within 1e-4 of their scale where the crop windows agree.
    (b) One key per family (``keys``) at full width (HACNN at its 160 x 64,
    the rest at 256 x 128): a batch of ``check_batch`` seeded crops on the
    card against the same model on the CPU, within 1e-4 of the output's
    scale; then a batch of ``time_batch`` (the config's ``batch_size``, a
    frame's detections) timed with CUDA events.

    Returns the stats; (a)'s launches under "staged"."""
    import copy

    from tracklab_torch.wrappers.reid.osnet_api import select_backbone_model

    stats = {}
    det_thr, _ = _calibrate_cli(torch, dev, n_objects, img_wh=(640, 640))
    args = ["use_rich=false", "pipeline=[bbox_detector,reid,track]",
            "+modules/bbox_detector=yolox", "+modules/reid=backbone_zoo",
            "modules/track=strong_sort", "modules.track.embed_dim=2048",
            "engine.fused=false",
            f"modules.bbox_detector.min_confidence={det_thr}",
            f"modules.track.min_confidence={det_thr}",
            f"dataset.n_videos={n_videos}", f"dataset.n_frames={n_frames}",
            f"dataset.n_objects={n_objects}", "dataset.img_w=640",
            "dataset.img_h=640"]
    parts, res, launches, split = _cli_run(
        torch, args + [f"device={dev.type}"],
        ("loader", "detect", "embed", "scan", "eval"))
    pred = parts["tracker_state"].detections_pred
    per_frame = len(pred) / split["frames"]
    emb_dim = np.stack(pred["embeddings"].to_numpy()).shape[1]
    log(f"reid_zoo (a) backbone_zoo (resnet50_ibn_a) staged on {card}: "
        f"{_split_line(split)}; device by stage "
        f"{split['device_s_by_stage']}; {per_frame:.2f} detections/frame, "
        f"{pred['track_id'].nunique()} tracks, {emb_dim}-d embeddings; "
        f"launches {launches}; host syncs in the scans "
        f"{split['host_syncs_in_scans']}")
    check(10 <= per_frame <= 64,
          f"reid_zoo (a): {per_frame:.2f} detections per frame")
    check(emb_dim == 2048, f"reid_zoo (a): {emb_dim}-d embeddings")
    for k in ("K3", "K1"):
        check(launches[k] > 0 or dev.type == "cpu",
              f"reid_zoo (a): {k} never launched")
    check(split["host_syncs_in_scans"] == 0,
          f"reid_zoo (a): {split['host_syncs_in_scans']} host syncs in the "
          "tracker scans")
    stats["staged"] = dict(split, launches=launches,
                           detections_per_frame=per_frame,
                           min_confidence=det_thr,
                           HOTA=res["COMBINED_SEQ"]["HOTA"])
    cpu_parts, _, _, cpu_split = _cli_run(
        torch, args + ["device=cpu", "dataset.nvid=1",
                       f"dataset.nframes={prefix_frames}"],
        ("loader", "detect", "embed", "scan", "eval"))
    cpu_pred = cpu_parts["tracker_state"].detections_pred
    ids = cpu_parts["tracker_state"].image_metadatas.index
    m = _match_prefix(pred, cpu_pred, ids)
    e = _matched_embedding_gap(pred, cpu_pred, ids)
    log(f"reid_zoo (a): the first {prefix_frames} frames on the card against "
        f"device=cpu ({cpu_split['track_dataset_s']:.2f} s): {m}; "
        f"embeddings {e}")
    check(m["matched"] == m["card_rows"] == m["cpu_rows"] > 0,
          f"reid_zoo (a): detections differ from the CPU's: {m}")
    check(m["min_iou"] >= 0.999, f"reid_zoo (a): a detection matched the "
          f"CPU's at IoU {m['min_iou']:.6f}")
    check(m["other_track_ids"] == 0 and m["tracked_in_one"] == 0
          and m["tracked_in_both"] > 0,
          f"reid_zoo (a): card and CPU tracks differ: {m}")
    check(e["compared"] >= 0.9 * m["matched"] and e["rel"] <= 1e-4,
          f"reid_zoo (a): embeddings differ from the CPU's: {e}")
    stats["cpu_prefix"] = dict(m, embeddings=e,
                               cpu_s=cpu_split["track_dataset_s"])

    g = torch.Generator().manual_seed(11)
    stats["families"] = {}
    for key in keys:
        crop = (160, 64) if key == "hacnn" else (256, 128)
        t0 = time.perf_counter()
        model = select_backbone_model(key, crop_size=crop, device=dev)
        cpu_model = copy.deepcopy(model).cpu()
        x = torch.randn((check_batch,) + crop + (3,), generator=g)
        with torch.no_grad():
            got = model(x.to(dev)).cpu()
            want = cpu_model(x)
        rel = float((got - want).abs().max() / want.abs().max())
        xb = torch.randn((time_batch,) + crop + (3,), generator=g).to(dev)
        ms = (cuda_ms(lambda: model(xb), 5) if dev.type == "cuda"
              else float("nan"))
        n_params = sum(p.numel() for p in model.parameters())
        log(f"reid_zoo (b) {key} f32 {crop[0]} x {crop[1]} on {card}: "
            f"{ms:.3f} ms per batch of {time_batch}; {tuple(got.shape[1:])} "
            f"features, {n_params / 1e6:.2f} M parameters; batch "
            f"{check_batch} {rel:.2e} of its scale from the CPU's "
            f"({time.perf_counter() - t0:.1f} s)")
        check(bool(torch.isfinite(got).all()) and rel <= 1e-4,
              f"reid_zoo (b) {key}: {rel:.2e} of its scale from the CPU's")
        stats["families"][key] = dict(crop=crop, ms_per_batch=ms,
                                      batch=time_batch, rel_vs_cpu=rel,
                                      dim=int(got.shape[1]),
                                      params=n_params)
        del model, cpu_model, xb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------ phase train

def _train_batch(n, size, n_objects, seed=21):
    """``n`` synthetic frames of ``size`` x ``size`` (RGB uint8) and their
    ground truth as the trainer takes it: (n, 64, 5) [cx, cy, w, h, 0] in
    pixels and (n, 64) valid."""
    from tracklab_torch.utils.cv2 import cv2_load_image
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

    s = make_synthetic_set(n_videos=1, n_frames=n, n_objects=n_objects,
                           seed=seed, img_w=size, img_h=size)
    imgs = np.stack([cv2_load_image(p) for p in s.image_metadatas["file_path"]])
    boxes = np.zeros((n, 64, 5), np.float32)
    valid = np.zeros((n, 64), bool)
    gt = s.detections_gt
    for i, image_id in enumerate(s.image_metadatas.index):
        b = np.stack(gt.loc[gt.image_id == image_id, "bbox_ltwh"]
                     .to_numpy())[:64]
        boxes[i, :len(b), :2] = b[:, :2] + b[:, 2:] / 2
        boxes[i, :len(b), 2:4] = b[:, 2:]
        valid[i, :len(b)] = True
    return imgs, boxes, valid


def _grads_apart(card, cpu):
    """Per parameter, the largest gap between the card's and the CPU's
    gradients over the CPU's largest magnitude; returns the worst and the
    median."""
    cpu_named = dict(cpu.named_parameters())
    rel = []
    for k, p in card.named_parameters():
        want = cpu_named[k].grad
        scale = float(want.abs().max())
        if scale > 0:
            rel.append(float((p.grad.cpu() - want).abs().max()) / scale)
    return max(rel), float(np.median(rel))


def phase_train(torch, dev, card, batch=8, size=640, steps=20,
                n_objects=24, cli_videos=2, cli_frames=20):
    """YOLOX training on the card (``models/train.py``), f32 with TF32 off.

    (a) YOLOX-s at ``size`` x ``size`` (seeded weights, one class) on one
    fixed batch of ``batch`` synthetic frames with ~``n_objects`` boxes
    each, AdamW(1e-4, weight decay 1e-4): the first ``make_train_step``
    against the same step of a copy on the CPU (loss within 1e-4 relative,
    every gradient within 5e-3 of its largest magnitude, the BN running
    statistics within 1e-3 of theirs); then ``steps`` steps in all, timed
    with CUDA events (ms per step, images/s, peak memory), and one more
    under torch.profiler (the card's busy ms and the kernel launches of a
    step, on CUDA): the loss finite
    and lower at the end than at the start, 0 K3 launches in the steps
    (no CSPLayer takes the kernel in training); then the trained model's
    inference under no_grad launches K3 once per dense CSPLayer (7).
    (b) ``train_tracking=true`` on the command line, as the JAX package
    runs it: ``+experiment=mot17_ocsort modules/bbox_detector=yolox``
    (YOLOX-s 640) -> ``+modules/reid=osnet`` (OSNet x1_0, 256 x 128, host
    crops) -> ``modules/track=strong_sort`` on a MOT17-layout tree of
    ``cli_videos`` x ``cli_frames`` 1080p PNG frames written here, 1 epoch
    (the spy around ``OSNetReId.train`` that times it asks ``train_reid``
    for one): the ReID trains (its weights move, 0 K3 launches while it
    does), the detector does not (``training_enabled`` is False, as in
    JAX: its ``train`` is never called), then the run detects through K3
    and tracks through K1 (0 host syncs in the scans); seconds in training
    and frames/s of the tracking after it.

    Returns the stats; (a)'s launches under "steps" and "inference", (b)'s
    under "cli"."""
    import copy
    import shutil
    import tempfile
    from pathlib import Path

    from tracklab_torch.models.train import create_train_state, make_train_step
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.wrappers.bbox_detector.yolox_api import YOLOXDetector
    from tracklab_torch.wrappers.reid.osnet_api import OSNetReId

    stats = {}
    counters = _launch_counters()
    imgs, boxes, valid = _train_batch(batch, size, n_objects)
    model = YOLOX(num_classes=1, variant="s", device="cpu").randomize_(0)
    cpu_model = copy.deepcopy(model)
    model = model.to(dev)
    adamw = partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)
    step = make_train_step((size, size))

    def on(d):
        return {"images": torch.from_numpy(imgs).to(d),
                "gt_boxes": torch.from_numpy(boxes).to(d),
                "gt_valid": torch.from_numpy(valid).to(d)}

    data = on(dev)
    state = create_train_state(model, adamw)
    for c in counters.values():
        c.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, loss0 = step(state, data)
    t0 = time.perf_counter()
    cpu_state, cpu_loss = step(create_train_state(cpu_model, adamw), on("cpu"))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(loss0) / float(cpu_loss) - 1)
    g_max, g_median = _grads_apart(model, cpu_model)
    own, cpu_own = model.state_dict(), cpu_model.state_dict()
    bn = max(float((own[k].cpu() - v).abs().max() / v.abs().max())
             for k, v in cpu_own.items() if "running" in k)
    log(f"train (a) first step of YOLOX-s {size} batch {batch} on {card} "
        f"against the CPU ({cpu_s:.1f} s there): loss {float(loss0):.6f} vs "
        f"{float(cpu_loss):.6f} ({loss_rel:.2e} relative); gradients "
        f"{g_max:.2e} of their scale at worst, median {g_median:.2e}; BN "
        f"running statistics {bn:.2e} of theirs")
    check(loss_rel <= 1e-4, f"train (a): first loss {loss_rel:.2e} from "
          "the CPU's")
    check(g_max <= 5e-3, f"train (a): gradients {g_max:.2e} of their scale "
          "from the CPU's")
    check(bn <= 1e-3, f"train (a): BN statistics {bn:.2e} from the CPU's")
    del cpu_model, cpu_state
    losses = [loss0]
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, loss = step(state, data)
        losses.append(loss)
    if dev.type == "cuda":
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / (steps - 1)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
    else:
        ms, peak = (time.perf_counter() - t0) * 1e3 / (steps - 1), 0.0
    prof = None
    if dev.type == "cuda":
        # one more step under torch.profiler: the card's busy time in a
        # step against the step's time above, and the launches it takes
        def one_step():
            nonlocal state
            state, _ = step(state, data)

        prof = profile_window(torch, one_step, 1)
        log(f"train (a) one step under torch.profiler on {card}: host "
            f"{prof['host_ms_per_frame']:.2f} ms (profiled), device busy "
            f"{prof['device_ms_per_frame']:.2f} ms = "
            f"{prof['device_ms_per_frame'] / ms:.3f} of the unprofiled "
            f"{ms:.2f} ms step, {prof['launches_per_frame']:.0f} kernel "
            f"launches; top kernels {prof['top_kernels_ms_per_frame']}")
    losses = [float(x) for x in losses]
    step_launches = {k: c.launches for k, c in counters.items()}
    model.eval()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        dec = model.predict(data["images"].float())
    infer_launches = {k: c.launches for k, c in counters.items()}
    log(f"train (a) {steps} steps on {card}: {ms:.2f} ms per step, "
        f"{batch * 1e3 / ms:.1f} images/s, peak memory {peak:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({losses}); launches in the "
        f"steps {step_launches}, in the inference after {infer_launches}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train (a): the loss does not fall: {losses}")
    check(step_launches["K3"] == 0, f"train (a): K3 launched "
          f"{step_launches['K3']} times in training")
    check(bool(torch.isfinite(dec).all()), "train (a): inference after "
          "training is not finite")
    check(infer_launches["K3"] == 7 or dev.type == "cpu",
          f"train (a): {infer_launches['K3']} K3 launches in the inference "
          "after training (7 dense CSPLayers)")
    stats["steps"] = dict(ms_per_step=ms, images_per_s=batch * 1e3 / ms,
                          peak_memory_gib=peak, losses=losses,
                          first_step_vs_cpu=dict(
                              loss_rel=loss_rel, grad_rel_max=g_max,
                              grad_rel_median=g_median, bn_rel=bn,
                              cpu_s=cpu_s),
                          launches=step_launches, profiled_step=prof)
    stats["inference"] = dict(launches=infer_launches)
    del model, state, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    trained = {}
    real_train = OSNetReId.train
    real_det_train = YOLOXDetector.train
    det_trained = []

    def timed_train(self, *a, **kw):
        self._build()
        before = {k: v.clone() for k, v in self._model.state_dict().items()}
        k3 = counters["K3"].launches
        t0 = time.perf_counter()
        out = real_train(self, *a, **dict(kw, epochs=1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        trained.update(
            seconds=time.perf_counter() - t0, loss=out.get("loss"),
            k3_in_training=counters["K3"].launches - k3,
            moved=any(not torch.equal(before[k], v)
                      for k, v in self._trained.state_dict().items()))
        return out

    try:
        _mot17_tree(torch, dev, tmp, cli_videos, cli_frames, n_objects)
        OSNetReId.train = timed_train
        YOLOXDetector.train = lambda self, *a, **kw: det_trained.append(1)
        args = ["use_rich=false", "+experiment=mot17_ocsort",
                f"data_dir={tmp}", "modules/bbox_detector=yolox",
                "pipeline=[bbox_detector,reid,track]",
                "+modules/reid=osnet", "modules/track=strong_sort",
                "train_tracking=true",
                "modules.bbox_detector.min_confidence=0.01",
                "modules.track.min_confidence=0.01", "engine.fused=false",
                f"device={dev.type}"]
        parts, res, launches, split = _cli_run(
            torch, args, ("loader", "detect", "reid", "scan", "eval"))
    finally:
        OSNetReId.train = real_train
        YOLOXDetector.train = real_det_train
        shutil.rmtree(tmp, ignore_errors=True)
    pred = parts["tracker_state"].detections_pred
    tracked = int(pred["track_id"].notna().sum()) if len(pred) else 0
    log(f"train (b) train_tracking=true on {card}: OSNet x1_0 training "
        f"{trained.get('seconds', float('nan')):.2f} s (losses "
        f"{trained.get('loss')}, K3 launches in it "
        f"{trained.get('k3_in_training')}), detector trained "
        f"{len(det_trained)} times, then {_split_line(split)}; "
        f"{len(pred)} rows, {tracked} tracked; launches {launches}; host "
        f"syncs in the scans {split['host_syncs_in_scans']}")
    check(trained.get("moved") and trained.get("loss")
          and all(math.isfinite(x) for x in trained["loss"]),
          f"train (b): the command line did not train the ReID: {trained}")
    check(not det_trained, "train (b): the detector trained under "
          "train_tracking=true (the JAX package never trains it)")
    check(trained["k3_in_training"] == 0, "train (b): K3 launched in "
          "training")
    check(tracked > 0, "train (b): nothing tracked after training")
    for k in ("K3", "K1"):
        check(launches[k] > 0 or dev.type == "cpu",
              f"train (b): {k} never launched")
    check(split["host_syncs_in_scans"] == 0, "train (b): host syncs in the "
          "tracker scans")
    stats["cli"] = dict(split, launches=launches, rows=len(pred),
                        tracked=tracked, training_s=trained["seconds"],
                        training_losses=trained["loss"],
                        k3_in_training=trained["k3_in_training"],
                        HOTA=res["COMBINED_SEQ"]["HOTA"] if res else None)
    return stats


# a key projection's bias shifts every logit of a query's row alike, so
# softmax cancels it: its gradient is zero but for rounding
_ROUNDING_ONLY = ("attn.key.bias", "self_attn.k_proj.bias")


def _zoo_grads_apart(card, cpu):
    """Per parameter with a gradient, the largest gap between the card's
    and the CPU's over the CPU's largest magnitude; a gradient that is zero
    but for rounding (below 1e-5 of the largest, or a key bias) is held to
    that floor instead. Returns (worst, median, worst parameter)."""
    cpu_named = dict(cpu.named_parameters())
    grads = {k: p.grad for k, p in cpu_named.items() if p.grad is not None}
    floor = 1e-5 * max(float(g.abs().max()) for g in grads.values())
    rel, worst_k = {}, None
    for k, p in card.named_parameters():
        want = grads.get(k)
        if want is None:
            check(p.grad is None or float(p.grad.abs().max()) == 0,
                  f"train_zoo: {k} has a gradient on the card only")
            continue
        got = p.grad.cpu()
        scale = float(want.abs().max())
        if scale <= floor or k.endswith(_ROUNDING_ONLY):
            check(float((got - want).abs().max()) <= max(floor, 1e-3 * scale)
                  or k.endswith(_ROUNDING_ONLY),
                  f"train_zoo: {k}'s rounding-level gradient parts")
            continue
        rel[k] = float((got - want).abs().max()) / scale
    worst_k = max(rel, key=rel.get)
    return rel[worst_k], float(np.median(list(rel.values()))), worst_k


def _loss_step(loss_of):
    """``train_step(state, batch) -> (state, loss)`` around ``loss_of(model,
    batch)``: the ReID trainers' step (``models/reid_train.py:fit``)."""

    def step(state, batch):
        model, opt = state.model, state.optimizer
        model.train()
        loss = loss_of(model, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return state._replace(step=state.step + 1), loss.detach()

    return step


def _permuted(batch, seed=5):
    """The same batch with its images (and their labels, boxes or
    keypoints) in another order: every loss here is invariant to it, so
    the gradients part only by rounding."""
    n = len(next(iter(batch.values())))
    order = np.random.default_rng(seed).permutation(n)
    return {k: v[order] for k, v in batch.items()}


def _zoo_part(torch, dev, card, name, model, tx, step, batch, n_images,
              steps, counters, record=None, onednn_off=True):
    """One family: ``model`` (seeded, on the CPU) and two copies go to the
    card and stay on the CPU; the first ``step`` on the card and on the CPU
    (loss, gradients, BN statistics compared), and, where the gradients
    miss the fixed bounds below, once more on the CPU with the batch
    permuted and, with ``onednn_off``, oneDNN off (another summation order
    in every reduction and convolution: the CPU's own rounding spread);
    then
    ``steps - 1`` more on the card timed with CUDA events. The gradients
    must lie within 5e-3 of each leaf's largest magnitude (1e-3 for the
    median leaf), or, where the family's loss makes that spread larger,
    within twice it. ``record``, when given, is a dict whose "card" and
    "cpu" entries the first steps fill (``_matching_recorder``). Returns
    the stats, the model and its state."""
    import copy

    from tracklab_torch.models.train import create_train_state

    cpu_model = copy.deepcopy(model)
    perm_model = copy.deepcopy(model)
    model = model.to(dev)
    data = {k: v.to(dev) for k, v in batch.items()}
    for c in counters.values():
        c.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if record is not None:
        record["now"] = "card"
    state, loss0 = step(create_train_state(model, tx), data)
    first = {k: c.launches for k, c in counters.items()}
    if record is not None:
        record["now"] = "cpu"
    t0 = time.perf_counter()
    _, cpu_loss = step(create_train_state(cpu_model, tx), batch)
    cpu_s = time.perf_counter() - t0
    if record is not None:
        record["now"] = None
    loss_rel = abs(float(loss0) / float(cpu_loss) - 1)
    g_max, g_median, g_key = _zoo_grads_apart(model, cpu_model)
    s_max = s_median = 0.0
    s_key = None
    if g_max > 5e-3 or g_median > 1e-3:
        # only where the fixed bounds are missed: the spread run
        with torch.backends.mkldnn.flags(enabled=not onednn_off):
            step(create_train_state(perm_model, tx), _permuted(batch))
        s_max, s_median, s_key = _zoo_grads_apart(perm_model, cpu_model)
    g_bound = max(5e-3, 2 * s_max)
    m_bound = max(1e-3, 2 * s_median)
    own, cpu_own = model.state_dict(), cpu_model.state_dict()
    bn = max([float((own[k].cpu() - v).abs().max() / v.abs().max())
              for k, v in cpu_own.items() if "running" in k] or [0.0])
    del cpu_model, perm_model
    losses = [loss0]
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, loss = step(state, data)
        losses.append(loss)
    if dev.type == "cuda":
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / (steps - 1)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
    else:
        ms, peak = (time.perf_counter() - t0) * 1e3 / (steps - 1), 0.0
    losses = [float(x) for x in losses]
    launches = {k: c.launches for k, c in counters.items()}
    log(f"train_zoo ({name}) on {card}: first step against the CPU "
        f"({cpu_s:.1f} s there): loss {losses[0]:.6f} vs "
        f"{float(cpu_loss):.6f} ({loss_rel:.2e} relative), gradients "
        f"{g_max:.2e} of their scale at worst ({g_key}), median "
        f"{g_median:.2e} (the CPU against itself, batch permuted"
        f"{', oneDNN off' if onednn_off else ''}: "
        f"{s_max:.2e} ({s_key}), median {s_median:.2e}), BN statistics "
        f"{bn:.2e}; {steps} steps: {ms:.2f} ms per step, "
        f"{n_images * 1e3 / ms:.1f} images/s, peak memory {peak:.2f} GiB; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches in the first "
        f"step {first}, in all {launches}")
    check(loss_rel <= 1e-4, f"train_zoo ({name}): first loss {loss_rel:.2e} "
          "from the CPU's")
    flipped = record is not None and not all(
        torch.equal(a.cpu(), b) for a, b in zip(record["card"],
                                                record["cpu"]))
    if flipped:
        log(f"train_zoo ({name}): the card's first-step matching differs "
            "from the CPU's (a near-tie of the costs): the worst-leaf bound "
            "is not applied, the median's is")
    check((g_max <= g_bound or flipped) and g_median <= m_bound,
          f"train_zoo ({name}): gradients {g_max:.2e} (median "
          f"{g_median:.2e}) of their scale from the CPU's ({g_key}), bound "
          f"{g_bound:.2e} ({m_bound:.2e})")
    check(bn <= 1e-3, f"train_zoo ({name}): BN statistics {bn:.2e} from "
          "the CPU's")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train_zoo ({name}): the loss does not fall: {losses}")
    check(launches["K3"] == 0, f"train_zoo ({name}): K3 launched "
          f"{launches['K3']} times in training")
    return dict(ms_per_step=ms, images_per_s=n_images * 1e3 / ms,
                peak_memory_gib=peak, losses=losses, steps=steps,
                first_step_vs_cpu=dict(
                    loss_rel=loss_rel, grad_rel_max=g_max,
                    grad_rel_median=g_median, grad_worst_param=g_key,
                    cpu_spread_max=s_max, cpu_spread_median=s_median,
                    cpu_spread_param=s_key, grad_bound=g_bound,
                    grad_median_bound=m_bound, bn_rel=bn, cpu_s=cpu_s,
                    matching_differs=flipped if record is not None
                    else None),
                launches_first_step=first, launches=launches), model, state


def _identity_crops(n, hw, n_ids, seed=31):
    """``n`` uint8 RGB crops of ``hw``, identity ``i % n_ids``: each identity
    a colour block pattern of its own under per-crop noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    looks = rng.integers(30, 226, (n_ids, 4, 2, 3))
    labels = np.arange(n) % n_ids
    crops = np.repeat(np.repeat(looks[labels], h // 4, 1), w // 2, 2)
    crops = crops + rng.integers(-30, 31, crops.shape)
    return np.clip(crops, 0, 255).astype(np.uint8), labels


def _k4_backward_vs_plain(torch, dev, shape, softmax):
    """dq, dk, dv of K4's autograd Function (the kernel forward) against
    autograd through the plain attention of the same softmax mode, on the
    card, at ``shape``: the largest gap over each gradient's scale."""
    from tracklab_torch.kernels.vit_attention import (
        vit_attention, vit_attention_compute_plain, vit_attention_plain)

    g = torch.Generator(device="cpu").manual_seed(41)
    q, k, v, d_out = (torch.randn(shape, generator=g).to(dev)
                      for _ in range(4))
    plain = (vit_attention_compute_plain if softmax == "compute"
             else vit_attention_plain)
    grads = []
    for fn in (partial(vit_attention, softmax=softmax), plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad((fn(*leaves) * d_out).sum(),
                                         leaves))
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(*grads))


def _matching_recorder(record):
    """A stand-in for ``models/rtdetr_train.py``'s ``matching_forced`` that
    keeps its result under ``record[record["now"]]`` while "now" is set."""
    from tracklab_torch.models import rtdetr_train

    real = rtdetr_train.matching_forced

    def recording(*a, **kw):
        out = real(*a, **kw)
        if record.get("now"):
            record.setdefault(record["now"], []).append(out)
        return out

    return recording


# phase train_zoo's sizes: the full widths, and the cut ones its CPU
# rehearsal takes (tiny=True)
_ZOO_FULL = dict(osnet=("x1_0", (256, 128), 32), kpr=(768, 12, 12, 16),
                 kpr_crop=(384, 128), det=(640, 8), rtmdet=320,
                 pose=("s", (256, 192), 16))
_ZOO_TINY = dict(osnet=("x0_25", (64, 32), 8), kpr=(64, 2, 2, 4),
                 kpr_crop=(64, 32), det=(128, 2), rtmdet=64,
                 pose=("nano", (64, 48), 4))


def phase_train_zoo(torch, dev, card, steps=10, n_objects=24, tiny=False):
    """The training of every family the JAX package trains besides YOLOX
    (phase ``train``), f32 with TF32 off, seeded weights, one fixed
    synthetic batch each, ``steps`` steps (see the module note, phase 28;
    ``tiny`` cuts every size for a rehearsal on the CPU). Returns the
    stats; each part's launches over its steps under "launches"."""
    from types import SimpleNamespace

    from tracklab_torch.models import kpr_train, pose_train, reid_train
    from tracklab_torch.models.pose import TopDownPose
    from tracklab_torch.models.rtdetr import RTDETR
    from tracklab_torch.models.rtdetr_train import matching_costs
    from tracklab_torch.models.rtmdet import RTMDet
    from tracklab_torch.models.train import make_train_step
    from tracklab_torch.models.yolov8 import YOLOv8
    from tracklab_torch.ops.assignment import matching_forced
    from tracklab_torch.wrappers.bbox_detector import (RTDETRDetector,
                                                       RTMDetDetector,
                                                       YOLOv8Detector)

    counters = _launch_counters()
    stats = {}
    sz = _ZOO_TINY if tiny else _ZOO_FULL
    adam = partial(torch.optim.Adam, lr=3e-4)

    # (a) OSNet x1_0, train_reid's model and loss
    variant, hw, b = sz["osnet"]
    crops, labels = _identity_crops(b, hw, 8)
    osnet = reid_train.initial_model(SimpleNamespace(
        variant=variant, feat_dim=512, n_parts=6), 8, seed=0)
    stats["osnet"], _, _ = _zoo_part(
        torch, dev, card, f"a: OSNet {variant} {hw} b{b}", osnet, adam,
        _loss_step(lambda m, b: reid_train.reid_loss(m, b["x"], b["y"])),
        {"x": torch.from_numpy(crops), "y": torch.from_numpy(labels)}, b,
        steps, counters, onednn_off=False)

    # (b) KPR ViT-B/16 at kpr.yaml's 384 x 128, train_kpr's model and loss
    dim, depth, heads, b = sz["kpr"]
    hw = sz["kpr_crop"]
    arch = dict(num_parts=5, dim_reduce_output=512, img_size=hw,
                patch_size=16, stride=16, embed_dim=dim, depth=depth,
                num_heads=heads)
    kpr = kpr_train.initial_model(SimpleNamespace(
        _model=None, _trained=None, n_prompt_ch=7, arch=arch, device="cpu"),
        8, seed=0)
    crops, labels = _identity_crops(b, hw, 8)
    stats["kpr"], _, _ = _zoo_part(
        torch, dev, card, f"b: KPR ViT {dim}x{depth} {hw} b{b}", kpr,
        partial(torch.optim.Adam, lr=1e-4),
        _loss_step(lambda m, b: kpr_train.kpr_loss(m, b["x"], b["y"], 7)),
        {"x": torch.from_numpy(crops), "y": torch.from_numpy(labels)}, b,
        steps, counters)
    k4_per = stats["kpr"]["launches_first_step"]["K4"]
    check(k4_per == depth or dev.type == "cpu", f"train_zoo (b): {k4_per} "
          f"K4 launches in a step's forward ({depth} attention layers)")
    shape = (b, 1 + (hw[0] // 16) * (hw[1] // 16), heads, dim // heads)
    bw = {m: _k4_backward_vs_plain(torch, dev, shape, m)
          for m in ("compute", "f32")}
    log(f"train_zoo (b): K4's dq, dk, dv through its Function against "
        f"autograd through the plain attention at {shape} f32: {bw}")
    check(max(bw.values()) <= 1e-5, f"train_zoo (b): K4's backward parts "
          f"from the plain version's: {bw}")
    stats["kpr"]["k4_backward_vs_plain"] = bw

    # (c) YOLOv8n 640 and (d) RT-DETR-s 640, through the wrappers' hooks
    size, b = sz["det"]
    imgs, boxes, valid = _train_batch(b, size, n_objects)
    det_batch = {"images": torch.from_numpy(imgs),
                 "gt_boxes": torch.from_numpy(boxes),
                 "gt_valid": torch.from_numpy(valid)}
    adamw = partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)
    v8 = YOLOv8Detector(variant="n", num_classes=1, device=dev)
    v8._model = YOLOv8(num_classes=1, variant="n",
                       device="cpu").randomize_(0)
    stats["yolov8n"], _, _ = _zoo_part(
        torch, dev, card, f"c: YOLOv8n {size} b{b}", v8._model, adamw,
        make_train_step((size, size), v8.detection_loss_fn, v8._preproc),
        det_batch, b, steps, counters)
    detr = RTDETRDetector(variant="s", num_classes=1, num_queries=100,
                          device=dev)
    model = RTDETR(num_classes=1, num_queries=100, variant="s",
                   input_size=(size, size), device="cpu").randomize_(0)
    from tracklab_torch.models import rtdetr_train
    record = {}
    real_matching = rtdetr_train.matching_forced
    rtdetr_train.matching_forced = _matching_recorder(record)
    try:
        stats["rtdetr_s"], model, _ = _zoo_part(
            torch, dev, card, f"d: RT-DETR-s {size} Q100 b{b}", model, adamw,
            make_train_step((size, size), detr.detection_loss_fn,
                            detr._preproc),
            det_batch, b, steps, counters, record=record)
    finally:
        rtdetr_train.matching_forced = real_matching
    k2 = stats["rtdetr_s"]["launches"]["K2"]
    check(k2 == steps or dev.type == "cpu", f"train_zoo (d): {k2} K2 "
          f"launches in {steps} steps (one set matching a step)")
    model.eval()
    with torch.no_grad():
        logits, pred = model(det_batch["images"].to(dev).float() / 255.0)
    cost = matching_costs(logits, pred, det_batch["gt_boxes"].to(dev),
                          (size, size))
    rows = torch.ones(cost.shape[:2], dtype=torch.bool)
    got = matching_forced(cost, rows.to(dev), det_batch["gt_valid"].to(dev),
                          batched=True)
    want = matching_forced(cost.cpu(), rows, det_batch["gt_valid"],
                           batched=True)
    same = bool(torch.equal(got.cpu(), want))
    log(f"train_zoo (d): a step's set matching on K2 (the problem "
        f"transposed to ({b}, 64, 100)) equals K2's plain version: {same}; "
        f"{int((want >= 0).sum())} queries matched")
    check(same, "train_zoo (d): K2's set matching differs from the plain "
          "version's")
    stats["rtdetr_s"]["matching_equals_plain"] = same
    del model, cost

    # (e) RTMDet-nano 320: train raises as JAX's; the train-mode forward
    det = RTMDetDetector(device=dev)
    try:
        det.train(None)
        raised = None
    except TypeError as e:
        raised = str(e)
    check(raised is not None, "train_zoo (e): RTMDetDetector.train did not "
          "raise (the JAX wrapper's fails)")
    import copy
    rtm = RTMDet(num_classes=1, variant="nano", device="cpu").randomize_(0)
    cpu_rtm = copy.deepcopy(rtm).train()
    rtm = rtm.to(dev).train()
    r = sz["rtmdet"]
    x = torch.from_numpy(imgs[:, :r, :r]).float()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        maps = rtm(x.to(dev))
        ms = cuda_ms(lambda: rtm(x.to(dev)), 5) if dev.type == "cuda" else 0
        cpu_maps = cpu_rtm(x)
    rtm_launches = {k: c.launches for k, c in counters.items()}
    gap = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for pair, cpu_pair in zip(maps, cpu_maps)
              for a, b in zip(pair, cpu_pair))
    log(f"train_zoo (e) RTMDet-nano {r} b{b} on {card}: train raises "
        f"({raised}); the train-mode forward {ms:.2f} ms, maps {gap:.2e} of "
        f"their scale from the CPU's; launches {rtm_launches}")
    check(gap <= 1e-3, f"train_zoo (e): train-mode maps {gap:.2e} from the "
          "CPU's")
    stats["rtmdet_nano"] = dict(train_raises=raised, forward_ms=ms,
                                maps_rel=gap, launches=rtm_launches)
    del rtm, cpu_rtm

    # (f) TopDownPose-s 256 x 192, make_pose_train_step
    variant, hw, b = sz["pose"]
    rng = np.random.default_rng(43)
    pose_crops = rng.uniform(0, 1, (b,) + hw + (3,)).astype(np.float32)
    kps = np.concatenate([rng.uniform(8, hw[1] - 8, (b, 17, 1)),
                          rng.uniform(8, hw[0] - 8, (b, 17, 1)),
                          (rng.uniform(0, 1, (b, 17, 1)) > 0.2)], -1)
    pose = TopDownPose(num_keypoints=17, variant=variant,
                       device="cpu").randomize_(0)
    stats["topdown_s"], _, _ = _zoo_part(
        torch, dev, card, f"f: TopDownPose-{variant} {hw} b{b}", pose,
        partial(torch.optim.Adam, lr=1e-3),
        pose_train.make_pose_train_step(hw),
        {"crops": torch.from_numpy(pose_crops),
         "keypoints": torch.from_numpy(kps.astype(np.float32))}, b, steps,
        counters)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stats["launches"] = {k: sum(v["launches"][k] for v in stats.values()
                                if isinstance(v, dict) and "launches" in v)
                         for k in _CLI_COUNTERS}
    return stats


# ------------------------------------------------------------ phase int8
def _iou_matched_share(torch, a, b, min_iou):
    """Share of the valid boxes of ``a`` (Detections, one frame) that
    match a valid box of ``b`` at IoU >= ``min_iou`` (greedy, best first),
    and the largest score gap of the matched pairs."""
    from tracklab_torch.ops.boxes import iou_matrix

    ba, bb = (d.ltrb[d.valid].double().cpu() for d in (a, b))
    sa, sb = (d.conf[d.valid].double().cpu().numpy() for d in (a, b))
    if not len(ba) or not len(bb):
        return float(len(ba) == len(bb)), 0.0
    iou = iou_matrix(ba, bb).numpy()
    hit, gap, free = 0, 0.0, np.ones(len(bb), bool)
    for i in np.argsort(-iou.max(1)):
        row = np.where(free, iou[i], -1.0)
        j = int(row.argmax())
        if row[j] >= min_iou:
            free[j] = False
            hit += 1
            gap = max(gap, abs(float(sa[i] - sb[j])))
    return hit / len(ba), gap


def _int8_vs_plain(torch, model, x):
    """One forward of an int8 model on the card with every s8 x s8 -> s32
    product of the device route (``_int_mm_conv``, under the counting
    wrapper) held against the plain version (an f64 convolution of the
    same codes on the card), as it happens: (convs, max |delta| over them,
    the largest product's (M, K, N))."""
    from tracklab_torch.models import quantize as Q

    orig = Q._int_mm_conv
    seen = {"convs": 0, "max_abs_delta": 0, "largest_mkn": (0, 0, 0)}

    def checked(xq, wq, stride, padding):
        acc = orig(xq, wq, stride, padding)
        want = Q.int8_conv_accumulators_plain(xq, wq, stride, padding)
        d = int((acc.long() - want.long()).abs().max().item())
        seen["convs"] += 1
        seen["max_abs_delta"] = max(seen["max_abs_delta"], d)
        B, O, Ho, Wo = acc.shape
        mkn = (B * Ho * Wo, wq[0].numel(), O)
        if mkn[0] * mkn[1] * mkn[2] > np.prod(seen["largest_mkn"]):
            seen["largest_mkn"] = mkn
        return acc

    Q._int_mm_conv = checked
    try:
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()
    finally:
        Q._int_mm_conv = orig
    return seen


def _int8_codes(torch, model, x):
    """``model.predict(x)`` on the CPU tensor it gives, and the int8 input
    codes of each of its quantized convolutions in the order they ran (the
    Focus stem's first), on the CPU."""
    from tracklab_torch.models.quantize import quantize_input

    codes, hooks = [], []
    for m in model.modules():
        conv = m.conv if type(m).__name__ == "Focus" else m
        if type(m).__name__ == "Focus" or (
                getattr(m, "quant", None) == "int8"
                and hasattr(m, "ascale") and hasattr(m, "bn")):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, c=conv: codes.append(
                    quantize_input(a[0], c.ascale).cpu())))
    try:
        with torch.no_grad():
            pred = model.predict(x).cpu()
    finally:
        for h in hooks:
            h.remove()
    return pred, codes


def _forward_stats(torch, model, x, reps, k3=True):
    """ms per forward of ``model`` on ``x`` (CUDA events, ``reps`` after a
    warm-up) and its peak device memory in GiB above the resident weights;
    with ``k3=False`` every CSPLayer runs its plain modules (cuDNN only)."""
    from tracklab_torch.models.yolox import CSPLayer

    orig = CSPLayer.k3_admits
    if not k3:
        CSPLayer.k3_admits = lambda self, x: False
    try:
        with torch.no_grad():
            ms = cuda_ms(lambda: model(x), reps)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            model(x)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    finally:
        CSPLayer.k3_admits = orig
    return dict(ms=ms, peak_gib=peak)


def _int_mm_share(torch, model, x):
    """Device time of one int8 forward under torch.profiler: the share of
    the kernels launched by ``aten::_int_mm``, and the busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA)
    mm = sum(e.device_time_total for e in events if e.key == "aten::_int_mm")
    return dict(int_mm_share=mm / busy if busy else 0.0,
                int_mm_ms=mm / 1e3, busy_ms=busy / 1e3)


def phase_int8(torch, dev, card, batch=8, chunk=32, n_chunks=4, size=640,
               cpu_frames=2, cli_frames=24, n_objects=24, reps=3):
    """Int8 post-training quantization on the card (``models/
    quantize.py``): YOLOX-s 640 (seeded, one class), its activation scales
    calibrated on a batch of 8 quasi-static frames.

    (a) Every int8 convolution of one forward at batch ``batch``: the
    device route (``torch._int_mm`` over an int8 im2col) gives the plain
    version's int32 accumulators (an f64 convolution of the same codes),
    max |delta| 0.
    (b) ms per forward, int8 against f32 and bf16 (each with K3 on its
    CSPLayers and with cuDNN alone) at batch ``batch`` and at the fused
    chunk ``chunk``, peak memory above the weights, and the share of the
    int8 forward's device time in ``_int_mm``.
    (c) The fused main path with ``YOLOXDetector(quant="int8")``:
    ``calibrate`` on the first chunk, then int8 YOLOX-s -> NMS -> OC-SORT
    over ``n_chunks`` x ``chunk`` frames (``fused_detect_track``): frames/s,
    0 host syncs in a warmed chunk, K1 and the int8 route launched, no K3;
    the detections against the port's float path on the same frames (the
    share of int8 boxes at IoU >= 0.5 of a float box); the first
    ``cpu_frames`` frames against the same int8 model on the CPU.
    (d) ``+modules/bbox_detector=yolov8 +modules.bbox_detector.quant=int8``
    (YOLOv8n) staged on one synthetic 640 x 640 video of ``cli_frames``
    frames: the wrapper calibrates on its first batch and runs int8, K1
    launched."""
    from tracklab_torch.engine.fused import (fused_detect_track,
                                             make_yolox_detect_fn)
    from tracklab_torch.models import quantize as Q
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_step)
    from tracklab_torch.wrappers.bbox_detector import (YOLOv8Detector,
                                                       YOLOXDetector)

    stats = {}
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(11)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    video = base + torch.randint(0, 20, (F, size, size, 3), generator=g,
                                 device=dev, dtype=torch.uint8)
    det = YOLOXDetector(variant="s", num_classes=1, max_dets=32,
                        batch_size=chunk, quant="int8", device=dev)
    det._build()                     # seeded: YOLOX.randomize_(0)
    f32 = det._model
    t0 = time.perf_counter()
    det.calibrate(video[:batch])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    int8 = det._int8_model
    n_q = len(Q.quant_modules(int8, "int8"))
    log(f"int8: YOLOX-s {size} calibrated in {calib_s:.2f} s on {batch} "
        f"frames ({n_q} int8 convolutions; ascale "
        f"{min(v.item() for v in det._scales.values()):.4g}.."
        f"{max(v.item() for v in det._scales.values()):.4g})")

    # (a)
    x8 = video[:batch].float()
    t0 = time.perf_counter()
    a = _int8_vs_plain(torch, int8, x8)
    a["seconds"] = time.perf_counter() - t0
    log(f"int8 (a) on {card}: {a['convs']} s8 x s8 -> s32 products of one "
        f"forward at batch {batch} against the plain version (f64 "
        f"convolutions on the card): max |delta| {a['max_abs_delta']}; "
        f"largest (M, K, N) {a['largest_mkn']}; {a['seconds']:.1f} s")
    check(a["convs"] == n_q, f"int8 (a): {a['convs']} products, {n_q} int8 "
          "convolutions")
    check(a["max_abs_delta"] == 0, f"int8 (a): the device route's "
          f"accumulators part from the plain version's by "
          f"{a['max_abs_delta']}")
    stats["accumulators"] = a

    # (b)
    bf16 = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                 device=dev)
    bf16.load_state_dict(f32.state_dict())
    forwards = {}
    for b in (batch, chunk):
        x = video[:b].float()
        row = {"int8": _forward_stats(torch, int8, x, reps)}
        for name, m in (("f32", f32), ("bf16", bf16)):
            row[name] = _forward_stats(torch, m, x, reps)
            row[f"{name}_cudnn_only"] = _forward_stats(torch, m, x, reps,
                                                       k3=False)
        row["int8_profile"] = _int_mm_share(torch, int8, x)
        forwards[f"batch_{b}"] = row
        log(f"int8 (b) YOLOX-s {size} at batch {b} on {card}: ms per "
            "forward (peak GiB above the weights) "
            + ", ".join(f"{k} {v['ms']:.3f} ({v['peak_gib']:.2f})"
                        for k, v in row.items() if "ms" in v)
            + f"; _int_mm {row['int8_profile']['int_mm_share'] * 100:.1f} % "
            f"of the int8 forward's {row['int8_profile']['busy_ms']:.3f} "
            "busy ms")
    stats["forwards"] = forwards

    # (c) the fused main path, int8 detector
    cfg = OCSortConfig(max_tracks=64, max_dets=32, min_hits=1)
    step = partial(ocsort_step, cfg)
    cal = make_yolox_detect_fn(f32, conf_threshold=0.3,
                               max_dets=32)(video[:1])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    det.min_confidence = conf
    det.calibrate(video[:chunk])     # the first chunk, as process would
    int8 = det._int8_model
    detect = det.device_detect_fn()
    float_detect = make_yolox_detect_fn(f32, conf_threshold=conf,
                                        max_dets=32)
    # one chunk to warm up (a fresh process's first tracker scans sync),
    # then the host syncs of the next one
    fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                       video[:chunk], chunk, return_detections=False)
    _, _, syncs = _timed_sync_count(
        torch, fused_detect_track, detect, step, ocsort_init(cfg, device=dev),
        video[chunk:2 * chunk], chunk, return_detections=False)
    counters = _launch_counters()
    for c in list(counters.values()) + [Q.int8_conv_accumulators]:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dets, out = fused_detect_track(detect, step,
                                      ocsort_init(cfg, device=dev), video,
                                      chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    launches["int8_products"] = Q.int8_conv_accumulators.launches
    t0 = time.perf_counter()
    _, fdets, fout = fused_detect_track(float_detect, step,
                                        ocsort_init(cfg, device=dev), video,
                                        chunk)
    torch.cuda.synchronize()
    float_dt = time.perf_counter() - t0
    shares = [_iou_matched_share(torch, Detections(*(x[f] for x in dets)),
                                 Detections(*(x[f] for x in fdets)), 0.5)[0]
              for f in range(F)]
    per_frame = dets.valid.sum(1).float().mean().item()
    fused = dict(frames=F, chunk=chunk, conf=conf, fps=F / dt,
                 float_fps=F / float_dt, syncs_in_warm_chunk=syncs,
                 launches=launches, detections_per_frame=per_frame,
                 float_detections_per_frame=fdets.valid.sum(1).float()
                 .mean().item(),
                 matched_share_vs_float=float(np.mean(shares)),
                 tracks_per_frame=out.valid.sum(1).float().mean().item(),
                 float_tracks_per_frame=fout.valid.sum(1).float().mean()
                 .item())
    check(syncs == 0, f"int8 (c): {syncs} host syncs in the warm chunk")
    check(launches["K1"] > 0, "int8 (c): K1 never launched")
    check(launches["K3"] == 0, f"int8 (c): {launches['K3']} K3 launches in "
          "an int8 model")
    check(launches["int8_products"] == n_q * n_chunks,
          f"int8 (c): {launches['int8_products']} int8 products, "
          f"{n_q} a chunk")
    check(out.valid.any().item() and torch.isfinite(
        out.ltrb[out.valid]).all().item(), "int8 (c): no finite tracks")
    # seeded weights leave many boxes within a rounding of the threshold,
    # so int8's error moves which ones pass: a sanity bound, the PTQ error
    # itself reported beside it
    fused["ptq_error_first_chunk"] = Q.quant_error_report(
        f32, int8, video[:chunk].float())
    check(fused["matched_share_vs_float"] >= 0.5,
          f"int8 (c): only {fused['matched_share_vs_float']:.3f} of the int8 "
          "detections lie at IoU >= 0.5 of a float detection")
    # the first frames against the same int8 model on the CPU: the stem's
    # codes are the same (one input, one scale, an exact division); after
    # it, the float BN and SiLU of the two devices part by an ulp here and
    # there, a value on a rounding boundary takes the next code, and that
    # grows layer by layer, so the card's int8 predictions stand within
    # int8's own error of the CPU's, not bit for bit
    cpu8 = YOLOX(num_classes=1, variant="s", device="cpu", quant="int8")
    cpu8.load_state_dict({k: v.cpu() for k, v in f32.state_dict().items()})
    Q.load_quant_state_dict(cpu8, {k: v.cpu()
                                   for k, v in det._scales.items()})
    xc = video[:cpu_frames].float()
    t0 = time.perf_counter()
    want, want_codes = _int8_codes(torch, cpu8, xc.cpu())
    cpu_s = time.perf_counter() - t0
    got, got_codes = _int8_codes(torch, int8, xc)
    differ = [int((a != b).sum()) for a, b in zip(got_codes, want_codes)]
    rel = (np.abs(got.numpy() - want.numpy())
           / np.maximum(np.abs(want.numpy()), 1e-3))
    ptq = Q.quant_error_report(f32, int8, xc)
    fused["vs_cpu"] = dict(
        frames=cpu_frames, cpu_seconds=cpu_s,
        stem_codes_differing=differ[0],
        first_layer_differing=next((i for i, d in enumerate(differ) if d),
                                   None),
        codes_differing=sum(differ),
        codes=sum(int(c.numel()) for c in want_codes),
        median_rel=float(np.median(rel)),
        p99_rel=float(np.quantile(rel, 0.99)),
        ptq_error_same_frames=ptq)
    log(f"int8 (c) the fused main path on {card}: {F} frames of {size}, "
        f"int8 YOLOX-s (conf {conf}) -> NMS -> OC-SORT {fused['fps']:.2f} "
        f"frames/s (float f32 {fused['float_fps']:.2f}), {syncs} host syncs "
        f"in a warm chunk, launches {launches}; "
        f"{per_frame:.2f} detections/frame (float "
        f"{fused['float_detections_per_frame']:.2f}), "
        f"{fused['matched_share_vs_float']:.4f} of them at IoU >= 0.5 of a "
        f"float one (decoded predictions against f32 on the first chunk: "
        f"{fused['ptq_error_first_chunk']}); the first {cpu_frames} frames "
        f"against the CPU's int8: {fused['vs_cpu']}")
    check(differ[0] == 0, f"int8 (c): {differ[0]} stem codes differ "
          "between the card and the CPU")
    check(fused["vs_cpu"]["median_rel"] <= ptq["median_rel"],
          f"int8 (c): card and CPU int8 predictions part by more than int8 "
          f"parts from f32: {fused['vs_cpu']}")
    stats["fused_main_path"] = fused

    # (d) YOLOv8n int8 on the command line, staged
    det_thr, birth_thr = _calibrate_cli(
        torch, dev, n_objects, img_wh=(size, size),
        detector=YOLOv8Detector(variant="n", num_classes=1,
                                min_confidence=0.0, device=dev))
    args = ["use_rich=false", f"device={dev.type}",
            "pipeline=[bbox_detector,track]",
            "+modules/bbox_detector=yolov8",
            "+modules.bbox_detector.quant=int8",
            f"modules.bbox_detector.min_confidence={det_thr}",
            f"modules.track.min_confidence={det_thr}",
            f"modules.track.det_thresh={birth_thr}", "engine.fused=false",
            "dataset.n_videos=1", f"dataset.n_frames={cli_frames}",
            f"dataset.n_objects={n_objects}", f"dataset.img_w={size}",
            f"dataset.img_h={size}"]
    Q.int8_conv_accumulators.launches = 0
    parts, res, launches, split = _cli_run(
        torch, args, ("loader", "detect", "scan", "eval"))
    launches["int8_products"] = Q.int8_conv_accumulators.launches
    mod = parts["modules"][0]
    pred = parts["tracker_state"].detections_pred
    cli = dict(split, launches=launches, thresholds=[det_thr, birth_thr],
               detections_per_frame=len(pred) / split["frames"],
               HOTA=res["COMBINED_SEQ"]["HOTA"],
               int8_convolutions=len(Q.quant_modules(mod._int8_model,
                                                     "int8")))
    log(f"int8 (d) +modules.bbox_detector.quant=int8 (YOLOv8n) staged on "
        f"{card}: {split['frames']} frames, "
        f"{cli['detections_per_frame']:.2f} detections/frame, "
        f"{split['fps']:.2f} frames/s of track_dataset; HOTA "
        f"{cli['HOTA']:.3f} with random weights; launches {launches}")
    check(mod.quant == "int8" and mod._scales is not None,
          "int8 (d): the wrapper did not calibrate")
    check(launches["int8_products"] > 0, "int8 (d): no int8 product ran")
    check(launches["K1"] > 0, "int8 (d): K1 never launched")
    check(cli["detections_per_frame"] >= 1, "int8 (d): no detections")
    stats["cli_yolov8n"] = cli
    return stats, launches, fused["launches"]


# ------------------------------------------------------------ phase mesh
def phase_mesh(torch, dev, card, n_videos=8, n_frames=60, fused_videos=2,
               fused_frames=16, size=640, warp_frames=32, cfg5_frames=24,
               keep=None):
    """The multi-device layer (``parallel/``) at world size 1 on NCCL: a
    one-rank process group made by ``make_mesh`` (an in-process store),
    its ``video`` mesh, one all-reduce through it on the card; then, each
    against its unsharded run on the card: ``tracker_videos_sharded`` over
    ``ocsort_scan_videos`` (``n_videos`` synthetic streams of ``n_frames``,
    id for id), ``fused_videos_sharded`` (YOLOX-s 640 bf16 -> NMS ->
    OC-SORT over ``fused_videos`` x ``fused_frames`` frames, against
    per-video ``fused_detect_track``), ``gmc_warps_time_sharded`` against
    ``gmc_warps`` on ``warp_frames`` panning frames, and
    ``+experiment=batched_8videos`` with ``engine.use_mesh=true`` against
    ``false`` on the command line (8 videos of ground truth, rows and track
    ids, HOTA 100; the ``false`` run is phase engines' config 5 run where
    ``keep`` holds it with the same arguments); the process group
    destroyed at the end."""
    import torch.distributed as dist

    from tracklab_torch.engine.fused import (fused_detect_track,
                                             make_yolox_detect_fn)
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.motion.lk import gmc_warps
    from tracklab_torch.parallel import mesh as PM
    from tracklab_torch.parallel.fused_mesh import fused_videos_sharded
    from tracklab_torch.parallel.time_shard import gmc_warps_time_sharded
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_scan_videos,
                                                ocsort_step)

    stats = {}
    vm = PM.make_mesh(1, ("video", "unused"), tp_size=1, device=dev)
    backend, world = dist.get_backend(), dist.get_world_size()
    t = torch.arange(4.0, device=dev)
    dist.all_reduce(t, group=vm.get_group("video"))
    torch.cuda.synchronize()
    check(backend == "nccl" and world == 1, f"mesh: {backend} at world "
          f"{world}")
    check(torch.equal(t, torch.arange(4.0, device=dev)),
          "mesh: the one-rank all-reduce changed its input")

    # (a) the trackers
    streams = [synth_stream(200 + v, n_frames=n_frames)
               for v in range(n_videos)]
    dets = _pad_videos(torch, streams, 64, dev)
    cfg = OCSortConfig(max_tracks=128, max_dets=64, det_thresh=0.45,
                       max_age=12, min_hits=2, iou_threshold=0.25)
    _, want = ocsort_scan_videos(cfg, dets)
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, got = PM.tracker_videos_sharded(ocsort_scan_videos, cfg, vm,
                                       axis="video")(dets)
    torch.cuda.synchronize()
    trk_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    d = _same_tracks(torch, got, want, "mesh (a) tracker_videos_sharded")
    check(launches["K1"] > 0, "mesh (a): K1 never launched")
    stats["trackers"] = dict(videos=n_videos, frames=n_frames,
                             seconds=trk_s, max_box_diff=d,
                             launches=dict(launches))

    # (b) the fused program over the video axis
    model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev).randomize_(0)
    g = torch.Generator(device=dev).manual_seed(13)
    base = torch.randint(0, 235, (fused_videos, 1, size, size, 3),
                         generator=g, device=dev, dtype=torch.uint8)
    videos = base + torch.randint(0, 20, (fused_videos, fused_frames, size,
                                          size, 3), generator=g, device=dev,
                                  dtype=torch.uint8)
    detect = make_yolox_detect_fn(model, conf_threshold=0.5, max_dets=32,
                                  compute_dtype=torch.bfloat16)
    fcfg = OCSortConfig(max_tracks=64, max_dets=32, min_hits=1)
    step, init = partial(ocsort_step, fcfg), ocsort_init(fcfg, device=dev)
    run = fused_videos_sharded(detect, step, init, vm, chunk=8,
                               axis="video", return_detections=True)
    t0 = time.perf_counter()
    _, fdets, fouts = run(videos)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    for v in range(fused_videos):
        _, d1, o1 = fused_detect_track(detect, step, init, videos[v], 8)
        _same_tracks(torch, type(fouts)(*(x[v] for x in fouts)), o1,
                     f"mesh (b) fused video {v}")
        check(all(torch.equal(a[v], b) for a, b in zip(fdets, d1)),
              f"mesh (b) fused video {v}: detections differ")
    stats["fused"] = dict(videos=fused_videos, frames=fused_frames,
                          seconds=fused_s,
                          detections_per_frame=fdets.valid.sum(-1).float()
                          .mean().item())

    # (c) the time-sharded camera warps
    frames = panning_video(torch, dev, warp_frames, size)
    w1 = gmc_warps_time_sharded(vm, axis="video")(frames)
    w0 = gmc_warps(frames)
    check(torch.equal(w1, w0), "mesh (c): time-sharded warps differ from "
          "gmc_warps")
    err, first_identity = _pan_error(w1.cpu().numpy(), (size, size))
    check(first_identity and err <= 0.25, f"mesh (c): warps {err:.3f} px "
          "from the pan at the corners")
    stats["warps"] = dict(frames=warp_frames, pan_error_px=err)

    # (d) the batched engine's use_mesh on the command line
    base_args = ["use_rich=false", f"device={dev.type}",
                 "+experiment=batched_8videos", "dataset.n_videos=8",
                 f"dataset.n_frames={cfg5_frames}", GT_OVERRIDE]
    runs = {}
    kept = (keep or {}).get("config5_batched")
    if kept is not None and kept[0] == base_args:
        runs[False] = kept[1]
    for use_mesh in (True,) if False in runs else (False, True):
        parts, res, cl, split = _cli_run(
            torch, base_args + [f"engine.use_mesh={str(use_mesh).lower()}"],
            ("scan", "eval"))
        runs[use_mesh] = parts["tracker_state"].detections_pred
        check((parts["engine"]._mesh is not None) == use_mesh,
              f"mesh (d): use_mesh={use_mesh} built no mesh")
        check(res["COMBINED_SEQ"]["HOTA"] == 100.0,
              f"mesh (d) use_mesh={use_mesh}: HOTA "
              f"{res['COMBINED_SEQ']['HOTA']}")
        stats[f"cli_use_mesh_{str(use_mesh).lower()}"] = dict(
            split, launches=cl, HOTA=res["COMBINED_SEQ"]["HOTA"])
    _same_rows(runs[True], runs[False], "mesh (d) use_mesh true vs false")
    PM.release_process_group()
    check(not dist.is_initialized(), "mesh: the process group outlived the "
          "phase")
    off = stats.get("cli_use_mesh_false", {}).get(
        "fps", "phase engines' run")
    log(f"mesh on {card}: world {world} on {backend}; (a) "
        f"tracker_videos_sharded over {n_videos} x {n_frames} frames equals "
        f"ocsort_scan_videos id for id ({trk_s:.2f} s, K1 "
        f"{launches['K1']}); (b) fused_videos_sharded over {fused_videos} x "
        f"{fused_frames} frames of {size} equals per-video "
        f"fused_detect_track ({fused_s:.2f} s); (c) the time-sharded warps "
        f"equal gmc_warps (pan error {stats['warps']['pan_error_px']:.3f} "
        f"px); (d) batched_8videos with use_mesh true equals false, 8 x "
        f"{cfg5_frames} frames, "
        f"{stats['cli_use_mesh_true']['fps']:.2f} frames/s against {off}; "
        "the process group destroyed")
    return stats, stats["cli_use_mesh_true"]["launches"]


# ----------------------------------------------------------- phase orbax

FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "torch_orbax"


def _orbax_leaves(tree, prefix=()):
    """(key path joined with '/', leaf) of read_orbax's tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _orbax_leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _orbax_leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def phase_orbax(torch, dev, card, chunk=32, n_chunks=2, size=640):
    """The JAX package's orbax checkpoints in the port (``models/
    orbax_io.py``), on the card's host and the card.

    (a) The committed fixture (``tests/data/torch_orbax``: a seeded tree
    the JAX package's ``save_checkpoint`` wrote in the OCDBT layout and in
    the ``use_ocdbt=False`` layout) read by ``read_orbax``: every leaf
    equal to ``expected.npz`` in dtype, shape and bits (bf16 as its uint16
    view); the zstd route (the system libzstd through ctypes) and the ms
    to read each layout printed.
    (b) YOLOX-s (seeded, one class) exported by ``yolox_to_flax`` and
    written by ``save_checkpoint``, then loaded back through
    ``YOLOXDetector(checkpoint_path=...)`` onto the card (its weights equal
    to the seeded model's bit for bit); the fused main path, YOLOX-s 640
    bf16 (K3) -> NMS -> OC-SORT (K1, ORU), over ``n_chunks`` x ``chunk``
    quasi-static frames with each model: the tracks id for id and the
    detections bit for bit equal, 0 host syncs in the loaded model's run
    (after the seeded model's warmed the path), and K3, K1 and ORU launched
    in it; the seconds to write and to read printed."""
    import tempfile

    from tracklab_torch.engine.fused import (fused_detect_track,
                                             make_yolox_detect_fn)
    from tracklab_torch.models import orbax_io as IO
    from tracklab_torch.models.convert import save_checkpoint, yolox_to_flax
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_step)
    from tracklab_torch.wrappers.bbox_detector import YOLOXDetector

    stats = {}
    # (a) the fixture on the card's host
    lib = IO.zstd_library()
    v = lib.ZSTD_versionNumber()
    route = (f"system libzstd {v // 10000}.{v // 100 % 100}.{v % 100} "
             f"({lib._name}) through ctypes")
    with np.load(FIXTURE / "expected.npz") as z:
        bf16 = set(z["__bfloat16__"].tolist())
        want = {k: z[k] for k in z.files if k != "__bfloat16__"}
    for layout in ("ocdbt", "plain"):
        t0 = time.perf_counter()
        tree = IO.read_orbax(FIXTURE / layout)
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(_orbax_leaves(tree))
        check(set(got) == set(want), f"orbax (a) {layout}: keys "
              f"{sorted(set(got) ^ set(want))} differ")
        for k, w in want.items():
            t = got[k]
            if k in bf16:
                check(t.dtype == torch.bfloat16, f"orbax (a) {layout} {k}: "
                      f"{t.dtype}, bfloat16 expected")
                g = t.view(torch.int16).numpy().view(np.uint16)
            else:
                g = t.numpy()
            check(g.dtype == w.dtype and g.shape == w.shape
                  and np.array_equal(g, w), f"orbax (a) {layout} {k}: "
                  f"{g.dtype} {g.shape} differs from {w.dtype} {w.shape}")
        stats[f"fixture_{layout}"] = dict(leaves=len(got), read_ms=ms)
    stats["zstd_route"] = route
    log(f"orbax (a) on the card's host: the fixture's {len(want)} leaves "
        f"bit for bit in both layouts (OCDBT read in "
        f"{stats['fixture_ocdbt']['read_ms']:.1f} ms, use_ocdbt=false in "
        f"{stats['fixture_plain']['read_ms']:.1f} ms); zstd: {route}")

    # (b) YOLOX-s through an orbax directory onto the card
    seeded = YOLOX(num_classes=1, variant="s", device=dev).randomize_(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as tmp:
        path = Path(tmp) / "yolox_s"
        t0 = time.perf_counter()
        save_checkpoint(path, yolox_to_flax(seeded))
        write_s = time.perf_counter() - t0
        mib = sum(f.stat().st_size for f in path.rglob("*")
                  if f.is_file()) / 2 ** 20
        det = YOLOXDetector(variant="s", num_classes=1, max_dets=32,
                            checkpoint_path=str(path), device=dev)
        t0 = time.perf_counter()
        det._build()
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    loaded = det._model
    for k, t in seeded.state_dict().items():
        check(torch.equal(loaded.state_dict()[k], t),
              f"orbax (b): {k} differs from the seeded model's")
    models = {}
    for name, src in (("seeded", seeded), ("loaded", loaded)):
        m = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev)
        m.load_state_dict(src.state_dict())
        models[name] = m
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(17)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    video = base + torch.randint(0, 20, (F, size, size, 3), generator=g,
                                 device=dev, dtype=torch.uint8)
    cal = make_yolox_detect_fn(models["seeded"], conf_threshold=0.3,
                               max_dets=32, compute_dtype=torch.bfloat16)(
        video[:1])
    sc = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = round(float(sc[19] + sc[20]) / 2, 6) if sc.size >= 21 else 0.3
    cfg = OCSortConfig(max_tracks=64, max_dets=32, min_hits=1)
    step = partial(ocsort_step, cfg)
    runs = {}
    counters = _launch_counters()
    for name in ("seeded", "loaded"):
        detect = make_yolox_detect_fn(models[name], conf_threshold=conf,
                                      max_dets=32,
                                      compute_dtype=torch.bfloat16)
        for c in counters.values():
            c.launches = 0
        (_, dets, out), secs, syncs = _timed_sync_count(
            torch, fused_detect_track, detect, step,
            ocsort_init(cfg, device=dev), video, chunk)
        runs[name] = dict(dets=dets, out=out, seconds=secs, syncs=syncs,
                          launches={k: c.launches
                                    for k, c in counters.items()})
    a, b = runs["loaded"], runs["seeded"]
    _same_tracks(torch, a["out"], b["out"], "orbax (b) loaded vs seeded")
    v = b["out"].valid
    check(torch.equal(a["out"].ltrb[v], b["out"].ltrb[v]),
          "orbax (b): track boxes differ from the seeded run's")
    check(all(torch.equal(x, y) for x, y in zip(a["dets"], b["dets"])),
          "orbax (b): detections differ from the seeded run's")
    launches = a["launches"]
    check(a["syncs"] == 0, f"orbax (b): {a['syncs']} host syncs in the "
          "loaded model's run")
    check(launches["K3"] == 7 * n_chunks,
          f"orbax (b): K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "orbax (b): K1 never launched")
    check(launches["ORU"] == F, f"orbax (b): ORU launches {launches['ORU']} "
          "!= one per frame")
    check(a["out"].valid.any().item(), "orbax (b): no tracks")
    stats["yolox_s"] = dict(
        checkpoint_mib=mib, write_s=write_s, read_s=read_s, frames=F,
        conf=conf, fps=F / a["seconds"], seeded_fps=F / b["seconds"],
        syncs=a["syncs"], launches=launches,
        tracks_per_frame=a["out"].valid.sum(1).float().mean().item())
    log(f"orbax (b) on {card}: YOLOX-s written as an orbax directory "
        f"({mib:.1f} MiB, use_ocdbt=false) in {write_s:.2f} s, read through "
        f"YOLOXDetector(checkpoint_path=...) onto the card in {read_s:.2f} s; "
        f"the fused main path (bf16, conf {conf}) over {F} frames equals the "
        f"seeded model's id for id and bit for bit "
        f"({stats['yolox_s']['tracks_per_frame']:.2f} tracks/frame), "
        f"{a['syncs']} host syncs, launches {launches}")
    return stats


def _host_packages():
    """Whether pandas, yaml, cv2, scipy, tqdm and rich import here, with
    their versions."""
    from importlib.metadata import version

    out = {}
    for name in ("pandas", "yaml", "cv2", "scipy", "tqdm", "rich"):
        try:
            out[name] = getattr(__import__(name), "__version__", None) \
                or version(name)
        except ImportError as e:
            out[name] = f"not importable ({e})"
    return out


class _Tee:
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from tracklab_torch.kernels import _build

    # a copy of the whole output, its long stats line included, in the
    # checkout's chiprun_out/ (listed in .gitignore)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sys.stdout = _Tee(sys.__stdout__, open(out_dir / "chip_smoke.log", "w"))
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log(f"host packages: {_host_packages()}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    check_sass(torch)

    k1, k1_steps = phase_k1(torch, dev)
    k2_random = phase_k2(torch, dev)
    k3 = phase_k3(torch, dev, time_batch=128)
    phase_tracker(torch, dev)
    # for the room of phase zoo (as the cuts below): 60 -> 40 frames
    phase_batched_trackers(torch, dev, n_frames=40)
    k4 = phase_k4(torch, dev)
    # for the room of phases int8 and mesh: KPR's batch 64 -> 32 crops
    kpr_stats = phase_kpr(torch, dev, batch=32)
    phase_bpbreid(torch, dev)
    lx_stats = phase_yolox_lx(torch, dev)
    oru_in = {"main_path": {}, "multi_video_path": {}}
    # for the room of phases int8 and mesh: 4 -> 2 chunks of 128 frames
    launches, main_stats = phase_main(torch, dev, n_chunks=2,
                                      oru=oru_in["main_path"])
    # for the room of phase zoo: 8 videos x 128 -> 64 frames
    v_launches, k2, videos_stats = phase_videos(
        torch, dev, n_frames=64, oru=oru_in["multi_video_path"])
    # for the room of phases int8 and mesh: 8 -> 4 chunks of 16 frames
    p_launches, parts_stats = phase_parts(torch, dev, n_chunks=4)
    oru = phase_oru(torch, oru_in)
    # depth cut for the room of phase posetrack's checks: the ReID path's
    # plain-solver rerun 32 -> 16 frames; for the room of phases int8 and
    # mesh: 8 -> 4 chunks of 16 frames (the V = 4 stage 4 x 16 frames)
    r_launches, rb_launches, reid_stats = phase_reid(torch, dev, n_chunks=4,
                                                     n_plain=16)
    nkf_in = {}
    # for the room of phase zoo: 8 -> 4 chunks of 16 frames; for the room of
    # phases int8 and mesh: 4 -> 2 (the V = 4 stage over 4 x 4 frames)
    m_launches, motion_stats = phase_motion(torch, dev, n_chunks=2,
                                            oru=nkf_in)
    oru_nkf, motion_stats["oru_nkf"] = phase_oru_nkf(torch, dev, nkf_in)
    k3_f32 = phase_k3_routes_f32(torch, dev)
    keep = {}
    # depth cut for the room of phase posetrack: cli (b) 300 -> 200 -> 150
    # frames a video, cli_reid (a) 150 -> 100 -> 80, its (b) and (c) tree
    # 96 -> 64 and its (b) CPU prefix 16 -> 8 frames (and phase 17's
    # reruns and the K2 checks of phases 8, 15 and 17)
    # for the room of phase zoo: cli (b) 150 -> 100 frames a video,
    # cli_reid (a) 80 -> 60, its (b) and (c) tree 64 -> 48
    # for the room of phase train_zoo: cli (b) 100 -> 60 frames a video,
    # cli_reid (a) 60 -> 40, its (b) and (c) tree 48 -> 32
    # for the room of phases int8 and mesh: cli (b) 60 -> 30 frames a video,
    # cli_reid (a) 40 -> 24, its (b) and (c) tree 32 -> 24, its (b) CPU
    # prefix 8 -> 4
    cli_stats = phase_cli(torch, dev, smi, n_frames=30, keep=keep)
    reid_cli = phase_cli_reid(torch, dev, smi, n_frames=24, tree_frames=24,
                              prefix_frames=4, keep=keep)
    # depth cut for the room of phase pose: engines (a)'s detector runs
    # and (b)'s clips 60 -> 40 frames, K1's plain check 4 -> 2 solving
    # launches; config 4 as typed 100 -> 60 frames. Config 1's tree keeps
    # its 100 frames: the panning texture depends on the length, and on
    # the 60-frame one YOLO11m's card and CPU tracks parted on 16 of 575
    # rows (detections within IoU 0.9999985: an association near-tie).
    # For the room of phase posetrack: (b)'s clips 40 -> 30 frames, config
    # 4 as typed 60 -> 40, pose (c)'s top-down videos 60 -> 40; then
    # config 5's videos 100 -> 50 frames and (a)'s detector runs 40 -> 32.
    # For the room of phase zoo: config 5's videos 50 -> 40, (a)'s
    # detector runs 32 -> 16, (b)'s clips 30 -> 20, (d)'s rendered video
    # 50 -> 25; pose (a)'s config 3 tree 60 -> 40 frames a video;
    # posetrack (a)'s 1280 x 720 tree 60 -> 40 (its 640 tree keeps 60: most
    # of its frames have a free slot, PERF.md section 7)
    # For the room of phases int8 and mesh: config 5's videos 40 -> 16,
    # (b)'s clips 20 -> 12, (d)'s rendered video 25 -> 16 ((a)'s detector
    # runs keep 16: its profile reads frames 8-15); config 4 as typed 40 ->
    # 24, config 1's CPU prefix 8 -> 4 frames; pose (a)'s and (c)'s videos
    # 40 -> 24 frames, (a)'s CPU prefix 8 -> 4
    engines, engine_runs = phase_engines(torch, dev, smi, keep,
                                         n_frames=16, file_frames=12,
                                         reid_frames=12, vis_frames=16,
                                         k1_keep=2, cfg5_frames=16)
    baseline = phase_baseline(torch, dev, smi, gs_frames=24, prefix_frames=4)
    pose = phase_pose(torch, dev, smi, n_frames=24, topdown_frames=24,
                      prefix_frames=4)
    # for the room of phase train_zoo: posetrack (a)'s 1280 x 720 tree
    # 40 -> 30 frames a video. (Zoo's tree at 24 frames instead of 40 put
    # one RT-DETR r50vd detection at IoU 0.9986 from the CPU's, below its
    # 0.999 check: the trees keep their 40 frames.)
    # for the room of phases int8 and mesh: posetrack (a)'s 1280 x 720 tree
    # 30 -> 16 frames a video (its CPU prefix keeps 4 frames: at 2 the
    # replayed heatmap tape and the CPU's run part); the zoo's CPU prefix
    # 4 -> 2 frames (its trees keep their 40); the ReID zoo's 2 x 40 -> 24
    # frames and its CPU prefix 8 -> 4
    posetrack, k4["f32_kpr_cli"] = phase_posetrack(torch, dev, smi,
                                                   hd_frames=16)
    zoo = phase_zoo(torch, dev, smi, prefix_frames=2)
    t0 = time.perf_counter()
    reid_zoo = phase_reid_zoo(torch, dev, smi, n_frames=24, prefix_frames=4)
    log(f"phase reid_zoo: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train = phase_train(torch, dev, smi)
    log(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_zoo = phase_train_zoo(torch, dev, smi)
    log(f"phase train_zoo: {time.perf_counter() - t0:.1f} s")
    k4["train_backward_vs_plain"] = train_zoo["kpr"]["k4_backward_vs_plain"]
    t0 = time.perf_counter()
    int8, int8_cli, int8_fused = phase_int8(torch, dev, smi)
    log(f"phase int8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh, mesh_cli = phase_mesh(torch, dev, smi, cfg5_frames=16, keep=keep)
    log(f"phase mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    orbax = phase_orbax(torch, dev, smi)
    log(f"phase orbax: {time.perf_counter() - t0:.1f} s")
    # each kernel's launches on the path that carries it: K1 and K3 on the
    # single-video main path, K2 on the multi-video path (timed there on the
    # path's own problems; the random-cost timing is kept beside it), K4 on
    # the parts path
    k1["launches"], k3["launches"] = launches["K1"], launches["K3"]
    k3["f32_yolox_s_640_b8"] = {k: v for k, v in k3_f32.items()
                                if k != "layers"}
    k2["launches"] = v_launches["K2"]
    k4["launches"] = p_launches["K4"]
    oru["launches"] = launches["ORU"]
    oru_nkf["launches"] = m_launches["deepocsort"]["ORU-NKF"]
    videos_stats["k2_random_costs"] = {
        k: k2_random[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "steps", "longest_problem_steps",
                                  "ns_per_step")}
    # RT-DETR HF's set matching width (C = 300), in the kernels line
    k2["c300"] = k2_random["c300"]
    main_stats["k1_s64"] = k1_steps
    # the command line's ReID runs (phase cli_reid) and the engines' runs
    # (phase engines), each counted apart
    cli_reid_runs = {f"cli_reid_{k}": reid_cli[k]["launches"]
                     for k in ("fused", "staged", "experiment_bare",
                               "experiment",
                               "deep_oc_sort", "bot_sort")}
    baseline_runs = {f"baseline_{k}": baseline[k]["launches"]
                     for k in ("yolov8n_fused", "yolov8n_staged",
                               "yolo11m_staged", "gamestate_as_typed",
                               "gamestate_chain")}
    pose_runs = {f"pose_{k}": pose[k]["launches"]
                 for k in ("config3", "bottomup_staged", "bottomup_fused",
                           "topdown_staged", "topdown_fused",
                           "vitpose_staged")}
    posetrack_runs = {f"posetrack_{k}": posetrack[k]["launches"]
                      for k in ("typed_staged", "typed_fused",
                                "batched_staged", "batched_fused",
                                "parts_staged", "parts_fused")}
    zoo_runs = {f"zoo_{k}": zoo[k]["launches"]
                for k in ("rtdetr_hf_staged", "rtdetr_hf_fused",
                          "rtmdet_staged", "rtmdet_fused",
                          "rtdetr_s_staged")}
    zoo_runs["zoo_reid_staged"] = reid_zoo["staged"]["launches"]
    train_runs = {f"train_{k}": train[k]["launches"]
                  for k in ("steps", "inference", "cli")}
    train_runs.update({f"train_zoo_{k}": train_zoo[k]["launches"]
                       for k in ("osnet", "kpr", "yolov8n", "rtdetr_s",
                                 "rtmdet_nano", "topdown_s")})
    int8_runs = {"int8_fused": int8_fused, "int8_cli": int8_cli,
                 "mesh_trackers": mesh["trackers"]["launches"],
                 "mesh_cli": mesh_cli}
    by_path = dict(cli_reid_runs, **engine_runs, **baseline_runs,
                   **pose_runs, **posetrack_runs, **zoo_runs, **train_runs,
                   **int8_runs)
    for entry, key in zip((k1, k2, k3, k4, oru, oru_nkf), _CLI_COUNTERS):
        entry["launches_by_path"] = {run: n[key]
                                     for run, n in by_path.items()}

    print(json.dumps({"main_path": main_stats,
                      "multi_video_path": videos_stats,
                      "parts_path": parts_stats, "reid_path": reid_stats,
                      "camera_path": motion_stats,
                      "kpr_check": kpr_stats, "yolox_l_x": lx_stats,
                      "k3_f32_yolox_s_640_b8": k3_f32, "cli": cli_stats,
                      "cli_reid": reid_cli, "engines": engines,
                      "baseline": baseline, "pose": pose,
                      "posetrack": posetrack, "zoo": zoo,
                      "reid_zoo": reid_zoo, "train": train,
                      "train_zoo": train_zoo, "int8": int8, "mesh": mesh,
                      "orbax": orbax,
                      "launches": {"main_path": launches,
                                   "multi_video_path": v_launches,
                                   "parts_path": p_launches,
                                   "reid_path": r_launches,
                                   "reid_batched_tracker": rb_launches,
                                   "camera_path": m_launches,
                                   "cli_quick_start":
                                       cli_stats["quick_start"]["launches"],
                                   "cli_fused": cli_stats["fused"]["launches"],
                                   "cli_staged":
                                       cli_stats["staged"]["launches"],
                                   "orbax_yolox_s":
                                       orbax["yolox_s"]["launches"],
                                   **by_path}}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4, oru, oru_nkf]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

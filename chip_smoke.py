#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (univtg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc), g++ and this checkout; imports
nothing of JAX or of the JAX package. Phases, each raising on failure and
printing its seconds:

  1. device   -- the card's name and power limit; TF32 off for comparisons.
  2. build    -- nvcc builds every kernel source from csrc/, one process
                 per source, all started together, and beside them, at
                 FAULT_NICE, the planted-fault copies of flash_bwd.cu,
                 flash_fwd.cu, ring_attention.cu, flash_f32.cuh and
                 int8_matmul.cu (phase 3b, which waits for them after 3d);
                 ptxas lines printed; fails if ptxas reports a spill for
                 an f32 (CUDA-core) kernel of F32_KERNELS.
                 cuobjdump -sass of
                 the flash_bwd, flash_fwd, ring_attention and int8_matmul
                 libraries:
                 HGMMA (and HMMA) instructions per kernel beside its
                 registers and spill bytes; fails unless every bf16
                 (wgmma) kernel, SASS_KERNELS, issues HGMMA.
  3. kernels  -- each kernel against its plain twin: flash_fwd at the
                 serving shapes and GROUND_SHAPE (one ground_video
                 dispatch); flash_fwd, flash_bwd_dq and flash_bwd_dkv
                 at the two training shapes, f32 and bf16, dropout 0 and
                 0.1; kernel, twin and library times, the bound, TFLOP/s
                 and the share of the bound.
  3b. faults  -- (after 3d) each planted fault must fail the limit that phases 3
                 and 3d hold the real kernels to, at each shape it runs:
                 FAULTS, of flash_bwd.cu's bf16 kernels (a cast to bf16
                 truncated instead of rounded, or the dropout keep left
                 out), and F32_FAULTS, of its f32 kernels (the keep left
                 out of dV, dQ's last key tile skipped), at the training
                 shapes with dropout 0.1;
                 FORWARD_FAULTS, of the bf16 forward (dropout keep left
                 out, acc not rescaled) at the training shapes with
                 dropout 0.1, and of the bf16 ring block (P . V on p_hi
                 alone) at 2 x 160 and 8 x 2080, P = 4; F32_FORWARD_FAULTS,
                 of the f32 loop that the forward and ring block share
                 (flash_f32.cuh: acc not rescaled, the keep left out, every
                 ring launch taking the `first` branch), at the same shapes;
                 INT8_FAULTS, of the f32 int8_matmul (the last chunk of K of
                 each split skipped), held to INT8_TOL at every f32 shape of
                 INT8_SHAPES.
  3c. int8    -- int8_matmul against its twin at K=2818, N=1024 (the first
                 video projection): M=128, 2400 (one eval batch of 32 x 75
                 clips), 4096 (one qvhighlights_bf16 dispatch) and 16384
                 (one long_video_bf16 dispatch), bf16 and f32; two calls on one input give
                 the same bits; kernel, twin and cuBLAS (F.linear on the
                 dequantized weight) times, eager and replayed from a CUDA
                 graph, and the bound; at M=128 also the kernel and cuBLAS
                 with the weight cold in L2 (each call on the next of
                 INT8_COLD_COPIES copies).
  3d. ring    -- ring_attention (the ring_block and ring_finish kernels of
                 csrc/ring_attention.cu and their transport) against its
                 twin on one card at (2 x 160, P = 1, 2, 4), (8 x 2080,
                 P = 1, 4, 8) and (2 x 8224, P = 4), f32 and bf16, with one
                 fully masked batch row; P = 1 also against flash_fwd; the
                 P = 8 ring repeated 20 times bit for bit (a race check of
                 the credit and recv edges); the whole ring's time, the
                 twin's, SDPA's, flash_fwd's, the bound, TFLOP/s, the share
                 of the bound and the share of copy time that overlaps a
                 block kernel; with two cards visible,
                 the ring at P = 2 across cards 0 and 1.
  4. pipeline -- the flagship (hidden 1024, 4 layers, 8 heads) at full
                 width with seeded random weights, attention_impl="pallas":
                 bf16, one 2048-clip video x 8 queries, held against the
                 same pipeline with attention_impl="xla"; f32, two 75-clip
                 videos, held against "xla" too.
  5. server   -- GroundingServer on 127.0.0.1: two videos, 8 concurrent
                 /ground requests, answers equal to direct pipeline calls.
  6. profile  -- where the time of one bf16 dispatch goes, per serving cell
                 (torch.profiler): host ms, device-busy ms, idle share, the
                 flash kernel's share and the top kernels.
  6b. ring serving -- GroundingPipeline with attention_impl="ring_pallas"
                 inside use_ring(RingGroup(4)): one 2048-clip video x 8
                 queries in bf16 and two 75-clip videos in f32, 4 x (16 + 4)
                 ring launches per dispatch and no "xla" dispatch, held
                 against the "xla" pipelines at phase 4's limits; then two
                 bf16 dispatches under torch.profiler (the
                 ring_long_video_bf16 [profile] line).
  7. train    -- `cli train-mr` trains the flagship at full width on a
                 synthetic corpus (96 train items, 2816-d video, 512-d
                 text, 75 clips: 3 steps of 32 per epoch, 2 epochs; 64 val
                 items), bf16, attention_impl="pallas", dropouts at their
                 defaults, evaluating the val split after each epoch, so
                 model_best.ckpt is chosen by MR-full-mAP: 4 launches of
                 each kernel per step and 4 flash_fwd per eval batch;
                 with profile_dir and tensorboard_dir=auto, so the run also
                 leaves opt.json (read back by config_io), code.zip, one
                 torch.profiler trace of its first PROFILE_STEPS steps that
                 must name each flash kernel, and TensorBoard events where
                 the tensorboard package is importable (printed). Then
                 the f32 "pallas" step held against the f32 "xla" step
                 (same weights, same 3 batches, dropouts 0), one seeded
                 step with attention dropout 0.1 through the kernels, and
                 the written checkpoint served.
  7b. eval    -- `cli infer-mr` on model_best.ckpt, "pallas", bf16 (the
                 eval main path: 4 flash_fwd launches per eval batch) and
                 f32; submission and metrics finite; f32 "pallas" held
                 against f32 "xla" (metrics equal; windows within PIPE_TOL
                 as decoded, in a second pair of runs with
                 round_multiple=0, before they are rounded to the 2 s clip
                 grid).
  7c. quantize -- `cli quantize` on model_best.ckpt (the int8 tier): the
                 file's size against the float one; the int8 file served
                 as `cli serve` builds it answers /ground (in this process:
                 7r runs the entry point in a subprocess); `cli infer-mr` on the dequantized
                 int8 weights, its metrics printed beside the f32 ones
                 (random weights: printed, not held). No entry point
                 launches int8_matmul, as in the JAX package; the smoke
                 calls it once itself on the int8 file's input_vid_proj.0
                 weight over the LayerNorm'ed video of the first eval batch
                 (M = 32 x 75), held against its twin and against F.linear
                 with the weight as served; the call launches the product
                 once and, where the plan splits K (in f32 at M = 2400),
                 the split sum once.
  7d. evalsize -- evaluation at the size of QVHighlights' val split
                 (N_VAL_FULL queries of 75 clips, synthetic), bf16 (its
                 f32 pass cut to pay for phases 7u-7x),
                 as train-mr pays it every eval_epoch: seconds of the
                 driver's inference (_run_eval_shard) and scoring
                 (_finish_eval, on the native AP kernel, g++-built from
                 native/src) per evaluation and per batch; the native APs
                 held against the numpy twin's (AP_TOL), whose scoring is
                 timed too; one pass on the native npz reader, its features
                 held against numpy's on every EVAL_SUBSET-th file
                 (FEAT_TOL) with none
                 rejected; the loader's own ms per batch on either reader (once:
                 it reads the same files for both dtypes);
                 where h5py is importable, cli pack-h5 and one pass on the
                 h5 cache with lazy metadata (else printed and not run);
                 and one inference under torch.profiler (the eval cells).
  7y. reproduce -- the released-run path: a released run at the flagship's
                 width (the port's state dict under `module.` in upstream's
                 container, opt.json in upstream's flag names, REPRO_OPT) and
                 the first N_REPRO queries of 7d's split;
                 tools/reproduce_model_md.main, f32, "pallas" and "xla",
                 each under device_trace inside an annotate region (named in
                 the trace): 4 flash_fwd per eval batch under "pallas" by the
                 counter and in the trace, none under "xla"; the submissions
                 at PIPE_TOL before the 2 s rounding, the metrics equal after
                 it; temporal_nms_torch on the card equal to the host NMS on
                 every row, eager and replayed from a CUDA graph.
  7e. scan    -- scan_steps on CUDA graphs: `cli train-mr` on phase 7's
                 corpus with scan_steps=2, "pallas", bf16, SCAN_EPOCHS
                 epochs (the group of epoch 0 runs eagerly, epoch 1's is
                 captured and replayed, epoch 2's replayed): 4 launches of
                 each kernel per step, replays counted; then
                 make_scan_train_step at B=32, 75 + 32 tokens, bf16 and f32,
                 K in SCAN_KS (1: the eager make_train_step): wall and
                 CUDA-event ms per step over SCAN_TIMED_STEPS steps, peak
                 memory, one call under torch.profiler (host ms, busy ms,
                 idle share; the trace must name each flash kernel 4 K
                 times); at dropouts 0 three groups (eager, captured,
                 replayed) against six eager single steps, bit for bit or
                 within TRAIN_TOL; at attention dropout 0.1 and rate 0,
                 fresh losses per replay and the kernels' keep share over
                 one step's 4 calls within KEEP_SIGMAS sigma of 0.9.
  7f. hl      -- highlight detection: a TVSum-shaped corpus at full width
                 (2816-d video, 512-d text, 20 annotators, up to 512
                 clips; HL_DOMAINS domains of 4 train + 1 val), `cli
                 train-hl --preset tvsum_hl` on "pallas", f32, HL_EPOCHS
                 epochs evaluated each epoch (4 launches of each kernel per
                 step, 4 flash_fwd per eval batch; best_tvsum_metrics.json
                 with both domains and AVG); `cli infer-hl` on "pallas" and
                 "xla": mAP equal, f32 fused scores within HL_SCORE_TOL;
                 make_train_step ms per HL step (B=4, 512 + 32), "pallas"
                 vs "xla", f32 and bf16. Phase 3 checks the kernels at
                 HL_SHAPE too.
  7g. qfvs    -- query-focused summarization: a UT-Egocentric-shaped tree
                 at full width (QFVS_VIDEOS videos of 20 segments x 200
                 frames, 512-d features + 2 TEF, 4 concepts of 3 tokens),
                 its grids kept in memory (data/qfvs.load_video_grid, the
                 one h5 read, replaced, so that no h5py is needed),
                 `cli train-qfvs --preset qfvs` on "pallas", f32,
                 QFVS_SPLITS of the 4 leave-one-out splits x QFVS_EPOCHS
                 epochs evaluated each epoch (12 launches of each kernel per
                 step: three forwards into one backward; 4 flash_fwd per eval
                 forward; qfvs_metrics.json with each split's F/R/P and
                 AVG_F); `cli infer-qfvs` on "pallas" and "xla": F/R/P equal
                 to training's best and across impls (near-ties at the top-2%
                 cut excepted), per-shot scores within QFVS_SCORE_TOL;
                 make_qfvs_train_step ms and one profiled step, "pallas" vs
                 "xla", f32 and bf16. Phase 3 checks QFVS_SHAPES too.
  7h. vlp     -- one-process pretraining: train_vlp on the vlp_pretrain
                 preset (bsz 64) over three full-width synthetic corpora
                 (point, interval, curve; VLP_PER_TYPE items each) with a
                 VLP_VAL-query zero-shot val split, "pallas", f32,
                 VLP_EPOCHS epochs (4 launches of each kernel per step, 4
                 flash_fwd per eval batch; MR-full-mAP-key in the brief
                 metrics); 3 gated f32 steps at dropouts 0, the third on an
                 all-curve batch, "pallas" vs "xla" at TRAIN_TOL; the step's
                 ms at B = 64, f32 and bf16. Phase 3 checks VLP_SHAPE too.
  7k. dist    -- training across processes (parallel/dist.py), after 7h,
                 whose kernels and corpora it reuses: (i) a NCCL gang of
                 one on the card: train_vlp one epoch with the group and
                 without, the logged losses and the final parameters bit
                 for bit; make_scan_train_step (K = 2) under the group, the
                 all-gather and all-reduce captured in its CUDA graph, bit
                 for bit against its eager steps; the gated step's ms with
                 and without the group. (ii) two ranks sharing the card
                 over gloo (the backend rule: NCCL refuses two ranks on one
                 GPU), the "vlp_main" case of 7u's gang, held after 7u:
                 train_vlp on vlp_pretrain at full width, B = 64 per rank,
                 "pallas", f32, dropouts 0, DIST_EPOCHS epochs, each
                 evaluated by sharded_eval; the curve held against one
                 process on the assembled B = 128 batches at TRAIN_TOL, the
                 ranks' parameter digests equal, the sharded evaluation
                 equal to a full one of rank 0's latest checkpoint; each
                 rank's step ms, host ms inside the collectives and idle
                 share; the elastic restart at DIST_ELASTIC's smaller
                 depth, each gang of it `chip_smoke.py --dist-worker`
                 subprocesses (rank 1 exits 3 after DIST_FAULT_EPOCH, the
                 gang resumes from rank 0's model_latest.ckpt, its processes
                 started beside the faulted gang and joining once it has
                 ended, epoch for epoch equal to an uninterrupted gang run
                 beside it). (iii) the CLIP teacher's
                 similarity sweep on the card against the CPU at 512 dims.
                 Each rank writes its launch counts to a file; cuDNN is held
                 deterministic through the phase.
  7i. md      -- Moment-DETR: train_mr with model_id="moment_detr" at
                 MomentDETRConfig()'s defaults (the flagship's widths: hidden
                 1024, 4 encoder layers, 8 heads, FFN 1024, 2818-d video,
                 512-d text; 10 queries, 2 decoder layers, aux_loss) on
                 phase 7's corpus, B = 32: "l1" for MD_EPOCHS epochs
                 evaluated each epoch, then "ce" for one epoch (its windows,
                 unrounded, on the 2 s clip grid); no launch of any kernel
                 and only "xla" attention dispatches, as in the JAX package,
                 where Moment-DETR ignores attention_impl; model_best.ckpt
                 reloaded through load_torch_checkpoint gives its
                 evaluation's metrics, model_latest.ckpt the last
                 evaluation's rows (model_best.ckpt's too, when it is the
                 last epoch's); "exhaustive" matching equal to scipy's on the
                 step's own costs (near-ties within MATCH_TIE_REL); the f32
                 step's ms by CUDA events over MD_TIMED_STEPS steps, then
                 one step under torch.profiler (busy ms, idle share, the
                 matcher's ms, the largest device items).
  7j. ground  -- raw-video grounding at the upstream demo's configuration:
                 CLIP ViT-B/32 (vit_b32(), random weights from seed 0,
                 written with torch.save and read back by
                 load_clip_checkpoint) in front of the flagship at vid_dim
                 514 (512 CLIP + 2 TEF) and txt_dim 512 (the port's .ckpt),
                 "pallas", f32; a GROUND_CLIPS x 2 s video written and
                 decoded by ffmpeg or cv2, or, where the machine has
                 neither, extract/video.decode_frames replaced by seeded
                 uint8 frames (printed). `cli ground` on it (the answer and
                 its JSON), `cli extract-text` on GROUND_TEXT_ROWS queries
                 (one npz each, equal to txt2clip), the demo app's callbacks
                 through a stub gradio module, and a GroundingServer with
                 the encoder: a raw-video PUT and GROUND_QUERIES concurrent
                 text POSTs, answers equal to ground_features. Held:
                 "pallas" vs "xla" on the same features at PIPE_TOL's f32
                 limits; the card's f32 encoder vs the same encoder on the
                 CPU (CLIP_DEVICE_TOL); uint8 frames vs host-normalized f32
                 (CLIP_U8_TOL); bf16 vs f32 (CLIP_BF16_TOL). Timed by CUDA
                 events: the image tower's frames/s at image_batch 64 over
                 GROUND_TIMED_FRAMES frames and the text tower's ms a query,
                 f32 and bf16, beside PEAK_FLOPS; ground_video's host ms
                 and its split, each step through its entry (decode,
                 encode_images with the uint8 copy inside it, txt2clip,
                 ground_features; the copy also alone); one ground_video
                 under torch.profiler.
  7q. tf32   -- phases 4's, 7's and 7j's f32 comparisons again with TF32
                 as phase 1 found it (cudnn.allow_tf32 True), "pallas" vs
                 "xla" and TF32 as found vs off, at those phases' limits:
                 the port holds its f32 convolutions to f32 itself
                 (device.exact_f32).
  7l. resume  -- resume_all from the JAX package's checkpoint of a small
                 UniVTG (RESUME_FIXTURE, written by
                 tests/torch_golden/make_jax_resume.py): AdamW's step on the
                 card, 2 f32 "pallas" steps against JAX's recorded metrics
                 at TRAIN_TOL.
  7m. async ckpt -- `cli train-mr` (bf16, "pallas", ASYNC_EPOCHS epochs,
                 evaluated and checkpointed each) with async_checkpoint on
                 and off, cuDNN deterministic: the checkpoints bit-equal;
                 the host ms each save blocks the loop, and the writer's.
  7o. hl gang -- (right after 7u, a case of its gang) train_hl in a gang
                 of two gloo ranks sharing the card on 7f's corpus, HL_GANG_BSZ
                 items a rank a step, f32, "pallas", dropouts 0: each step
                 against one process on the assembled batches at
                 TRAIN_TOL, the ranks equal; per rank step ms, collective
                 host ms, idle share.
  7p. learning -- tools/validate_synthetic.py's planted-signal check at
                 hidden LEARN_HIDDEN, LEARN_HEADS heads, "pallas", the
                 script's dropouts, LEARN_EPOCHS epochs, f32 and bf16:
                 R1@0.5 > 50 and mIoU > 50, the metrics beside the JAX
                 package's (JAX_LEARNING).
  7r. moe     -- the flagship with the JAX package's MoE configuration
                 (MOE_OVERRIDES: 4 experts, top-2, scan_layers) on
                 "pallas": `cli train-mr` on phase 7's corpus, bf16 and
                 f32, MOE_EPOCHS epochs each evaluated (4 launches of each
                 kernel per step, 4 flash_fwd per eval batch; loss_moe_aux
                 finite and in (0, E]); `cli infer-mr`, `cli quantize` and
                 `cli serve --config` from the int8 file answering
                 MOE_SERVE_QUERIES concurrent requests; 3 f32 steps at
                 dropouts 0, "pallas" vs "xla" at TRAIN_TOL, tokens routed
                 otherwise counted and allowed only within MOE_TIE_REL;
                 scan_steps=2 replays against eager steps by 7e's rule; ms
                 per step eager and captured, bf16 and f32, and the peak
                 memory, beside the dense flagship's.
  7s. remat   -- make_train_step at 8 x (2048 + 32), bf16 and f32,
                 dropouts at the flagship's defaults, remat on against off
                 from one generator seed: loss, grad norm and params after
                 2 steps bit-equal (cuDNN deterministic); ms per step, peak
                 memory and flash launches a step (8 flash_fwd under
                 remat: the recompute); the remat step's scan_steps=2
                 replays against its eager steps by 7e's rule.
  7t. resume moe -- phase 7l on MOE_FIXTURE (the JAX package's small MoE
                 model in the scan layout, tests/torch_golden/make_jax_moe.py):
                 resume_all, then 2 f32 "pallas" steps against every
                 metric JAX recorded (loss_moe_aux among them) at TRAIN_TOL.
  7u. mesh tp -- model parallelism across processes (parallel/mesh.py) in
                 one gang of MESH_TP gloo ranks sharing the card
                 (`--dist-worker` mode "mesh"): train_mr at tp = 2 on phase
                 7's corpus (full width, B = 32, f32, "pallas", dropouts 0,
                 one epoch of 3 steps, evaluated by rank 0 over the gathered
                 parameters), each step against one process on the same
                 batches at TRAIN_TOL, the ranks equal, the canonical
                 model_best.ckpt through one-process `cli infer-mr` with the
                 gang's metrics; make_train_step at 8 x (2048 + 32),
                 seq_shard off and on, bf16 at the flagship's dropouts and
                 f32 at dropouts 0: ms, peak memory, flash launches a step
                 (4, each over B x 4 head rows), host ms in the collectives,
                 per rank; the f32 step's first step from the seed against
                 one process at TRAIN_TOL;
                 the flash kernels over heads 4-7
                 of 8 (head_span) with dropout 0.1 against the twin with the
                 same offset.
  7w. mesh moe -- in the same gang: the MoE flagship (MOE_OVERRIDES, f32,
                 "pallas", dropouts 0, B = 32 global) on dp = 2 and on ep =
                 2, 3 steps each against one process on the global batches
                 at TRAIN_TOL, tokens routed otherwise only within
                 MOE_TIE_REL; ms a step per rank.
  7x. mesh pp -- pipelines across processes (parallel/pipeline.py,
                 parallel/pipeline_1f1b.py, train/steps_1f1b.py), right
                 after 7w: (a) train_mr at dp = 2 x pp = 2 (GPipe, 2
                 microbatches) on phase 7's corpus, B = 32 global, f32,
                 "pallas", dropouts 0, one epoch of 3 steps evaluated by
                 rank 0 on a local non-pipeline copy, each step against one
                 process on the same global batches at TRAIN_TOL, the ranks
                 equal, model_best.ckpt through one-process `cli infer-mr`
                 with the gang's metrics; (b) 1F1B (PP_CASES: pp = 4 and M =
                 8; dp = 2 x pp = 2 x interleave 2, M = 4; 7r's MoE at pp =
                 2 x ep = 2, M = 4), each step against one process's
                 microbatched loss (the mean of the M x dp block losses) at
                 TRAIN_TOL, MoE tokens routed otherwise only within
                 MOE_TIE_REL; (a) and (b) in one gang of MESH_PP gloo ranks
                 sharing the card, several meshes in turn; in 7u's gang of
                 two (pp = 2 at dp = 1): (c) GPipe at the flagship's
                 dropouts against the one-process step from the same seed
                 at TRAIN_TOL; (d) the step at 8 x (2048 + 32), pp = 2,
                 bf16 and f32, GPipe and 1F1B at PP_LONG_MICRO
                 microbatches: per rank ms a step, peak memory, host ms in
                 the stage hops, idle tick share, saved inputs. Every part
                 shows each rank's ticks, hops, the layers and parameters it
                 holds and no fallback warning; the flash launches are held
                 to GPipe's L M of each kernel a step and pipeline, and
                 1F1B's (L - L / (pp v)) M + L M forwards and L M of each
                 backward kernel. (e) in (a)'s gang: a ring inside a stage,
                 dp 1 x pp 2 x tp 2 (each stage's tp ranks its ring), the
                 flagship's make_train_step with "ring_pallas" at 8 x (2048
                 + 32), M = PP_RING_M, dropouts 0: PP_STEPS f32 GPipe steps
                 against one process's "xla" steps and one f32 1F1B step
                 against one process's microbatched loss, at TRAIN_TOL; then
                 bf16 GPipe: ms a step per rank, peak memory, host ms in the
                 ring's hops and in the stage hops. Every rank launches
                 PP_RING_TP ring_block + 1 ring_finish per ring call (one per
                 layer it holds and microbatch forward, and per 1F1B
                 recompute), no flash kernel, and dispatches nothing but
                 "ring_pallas".
  8. long     -- the train step at B=8, 2048 clips + 32 tokens, bf16 and
                 f32, "pallas" vs "xla": CUDA-event ms per step, peak
                 memory, 20 launches of each flash kernel over 5 steps.
  9. profile  -- where the time of one bf16 train step goes, per training
                 cell (torch.profiler).
  9b. ring train -- make_train_step on 8 x (2048 + 32) with "ring_pallas"
                 inside use_ring(RingGroup(4)): 3 f32 steps held against
                 "xla" at phase 7's limits, then bf16 ms per step and peak
                 memory beside phase 8's.
  9c. ring scan -- make_scan_train_step, K = RING_SCAN_K, under
                 use_ring(RingGroup(4)) at 8 x (2048 + 32), "ring_pallas",
                 bf16 and f32, dropouts 0: RING_SCAN_GROUPS groups (eager,
                 captured, replayed) against eager ring steps bit for bit by
                 7e's rule; ms per step captured and eager.
  7v. mesh ring -- (right after 7x, in its gang) the ring across processes:
                 MESH_RING_P gloo ranks sharing
                 the card, their tp axis the ring (parallel/ring.ProcessRing):
                 ring_attention_pallas at 8 x 2080, f32 and bf16, each
                 process its block, the gathered output against the
                 one-process RingGroup(P) (bit for bit, else the largest
                 difference), P ring_block + 1 ring_finish a call in every
                 process, ms a call and host ms in the hops; 2 f32 train
                 steps at 8 x (2048 + 32) with "ring_pallas" on the tp mesh
                 against "xla" in one process at TRAIN_TOL, 4 x (P + 1)
                 launches a forward in every process.

Each main path is driven with the launch counters set to 0 just before it
and read just after: serving is phases 4-5, training phase 7's train-mr
run (its evaluations included), eval phase 7b's bf16 infer-mr run, the
released-run path phase 7y's "pallas" reproduce_model_md run,
quantize phase 7c's entry points, ring serving phase 6b's ring dispatches,
ring training phase 9b's ring_pallas steps, scan training phase 7e's
train-mr run, HL training phase 7f's train-hl run (its evaluations
included) and HL inference its "pallas" infer-hl run, QFVS training and
inference phase 7g's train-qfvs (evaluations included) and "pallas"
infer-qfvs runs, VLP training phase 7h's train_vlp run (evaluations
included), VLP training across processes phase 7k(ii)'s train_vlp runs in
7u's gloo gang (each rank counts its own, evaluations included; summed) and the NCCL
gang of one its train_vlp run, Moment-DETR training phase 7i's two train_mr runs (evaluations
included) and Moment-DETR inference its reloaded checkpoint's evaluation,
where no kernel may run, raw-video grounding phase 7j's `cli ground`, `cli
extract-text` and demo-app runs (4 flash_fwd per grounding dispatch, none
from the CLIP towers or extract-text) and the grounding server its raw-video
PUT and text POSTs (4 flash_fwd per batch), the resumed training phase
7l's two steps, the writer's training phase 7m's train-mr run with
async_checkpoint on, HL training across processes phase 7o's gloo gang's
train_hl runs (each rank counts its own; summed), the learning check phase
7p's f32 train_mr run, MoE training phase 7r's two train-mr runs
(evaluations included), MoE inference its infer-mr and quantize runs (its
`cli serve` counts in its own process), remat training phase 7s's remat
steps, MoE training resumed from JAX phase 7t's two steps, ring training on
CUDA graphs phase 9c's bf16 scan and eager ring steps, tp training across
processes phase 7u's train_mr gang (each rank counts its own; summed), MoE
training across processes phase 7w's dp = 2 and ep = 2 steps (summed), ring
training across processes phase 7v's ring_pallas steps (summed), pipelined
training phase 7x's train_mr at dp = 2 x pp = 2 (GPipe, rank 0's evaluation
included), its 1F1B steps, its GPipe steps at the dropouts and its ring
inside a stage's steps (each summed over the ranks); the smoke's own
int8_matmul call and 7e's keep-rate check are counted apart. Every kernel
of the other paths must have run there. The last lines
are the card line of nvidia-smi, one JSON line of per-kernel numbers, and
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from types import SimpleNamespace

# tolerances of kernel vs twin (same inputs, same dtype, on the card)
TOL = {
    # only the summation order differs
    "float32": {"out": 1e-4, "lse": 1e-4},
    # out is bf16 and p is rounded to bf16 relative to a running max in the
    # kernel, to the final max in the twin: readings on an H100 were out
    # 2.0e-3 (L=2080), 3.9e-3 (L=160) and, with dropout 0.1 (out scaled by
    # 1/0.9), 7.8e-3 (L=107): one bf16 step at magnitude 1-2. The limit is
    # one step at magnitude 2-4, where the dropped-out outputs reach; lse is
    # f32 on both sides (9.5e-7)
    "bfloat16": {"out": 1.6e-2, "lse": 1e-4},
}
# the backward kernels vs their twins: each of dq, dk and dv on its own, at
# each shape, by max |kernel - twin| / max |twin| ("rel") and, in bf16, by
# the share of elements that differ at all ("share"). Readings on an H100
# (700 W): f32 rel <= 2.3e-7 (summation order). bf16: the wgmma kernels sum
# s and dp in another order than the twin's f32 matmul, so a rare p or ds
# rounds the other way: rel <= 3.1e-3, share <= 3.0e-3 at dropout 0 and
# 0.1. A one-step flip of the largest value reads up to 2**-7 = 7.8e-3 rel,
# so rel alone cannot tell a rare flip from a missing cast; the share can.
# The planted faults (FAULTS, phase 3b) read: a truncated cast rel
# 4.1e-3-8.6e-3 with share 0.39-0.67, keep left out of dV rel 0.34-0.62
# with share 0.60-0.67.
BWD_TOL = {"float32": {"rel": 2e-6, "share": None},
           "bfloat16": {"rel": 8e-3, "share": 1e-2}}
# planted faults of csrc/flash_bwd.cu's bf16 (wgmma) kernels: name -> (the
# output it corrupts, the line as written, the line with the fault). A cast
# fault truncates the f32 pair to bf16 (the top 16 bits, round toward zero)
# where the kernel rounds to nearest even: a bf16 wgmma operand cannot stay
# f32. Each is built from a copy in a temporary directory; phase 3b requires
# that the bf16 limits catch each. tests/test_torch_flash_bwd.py checks on
# every run that each line is in flash_bwd.cu exactly once.
_TRUNC = "(__float_as_uint({0}[2 * i]) >> 16) | (__float_as_uint({0}[2 * i + 1]) & 0xFFFF0000u)"
FAULTS = {
    "dq_ds_truncated": (
        "dq", "dsf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);",
        f"dsf[i] = {_TRUNC.format('s')};"),
    "dk_ds_truncated": (
        "dk", "dstf[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);",
        f"dstf[i] = {_TRUNC.format('dp')};"),
    "dv_p_truncated": (
        "dv", "ptf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);",
        f"ptf[i] = {_TRUNC.format('s')};"),
    "dv_keep_dropped": ("dv", "p_keep = p * keep;", "p_keep = p;"),
}
# planted faults of csrc/flash_bwd.cu's f32 (CUDA-core) kernels, as FAULTS:
# name -> (the output it corrupts, the line as written, the line with the
# fault). dv_keep_dropped_f32 leaves the dropout keep out of p * keep;
# dq_last_tile_skipped leaves the last key tile out of the dQ product (a
# ragged tile at both training shapes: keys 2048-2079 of 2080, all 107 of
# 107). Phase 3b requires that the f32 limit, BWD_TOL["float32"], catches
# each; tests/test_torch_flash_bwd.py checks on every run that each line is
# in flash_bwd.cu exactly once, in the f32 kernels.
F32_FAULTS = {
    "dv_keep_dropped_f32": ("dv", "pk[e] = p * keep;", "pk[e] = p;"),
    "dq_last_tile_skipped": (
        "dq", "    accumulate<DH, 4, DQ_UNROLL_A>(acc, Ps, ry, Ks + st * TF, cx);",
        "    if (t + 1 < n_tiles)\n"
        "      accumulate<DH, 4, DQ_UNROLL_A>(acc, Ps, ry, Ks + st * TF, cx);"),
}
# planted faults of the bf16 (wgmma) forward and ring block kernels: name ->
# (source in csrc/, the output it corrupts, the line as written, the line
# with the fault). fwd_keep_dropped leaves the dropout keep out of p;
# fwd_alpha_dropped leaves acc unrescaled when a row's max moves on;
# ring_p_lo_dropped takes P . V on p_hi = bf16(p) alone, which rounds p where
# the JAX ring keeps it f32 (only the share of elements that differ,
# RING_TOL, can see that). Built and required to fail as FAULTS are;
# tests/test_torch_flash.py checks on every run that each line is in its
# source exactly once.
FORWARD_FAULTS = {
    "fwd_keep_dropped": (
        "flash_fwd", "out",
        "p[i] *= flash::dropout_keep(drop, hx[(i >> 1) & 1] + frag_col(i));",
        "p[i] *= 1.f;"),
    "fwd_alpha_dropped": (
        "flash_fwd", "out",
        "for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < 32; ++i) acc[n][i] *= 1.f;"),
    "ring_p_lo_dropped": (
        "ring_attention", "out",
        "plo[i] = pack_bf16(p[2 * i] - bf16_lo(phi[i]), p[2 * i + 1] - bf16_hi(phi[i]));",
        "plo[i] = 0u;"),
}
# planted faults of the f32 online-softmax loop (attend in csrc/flash_f32.cuh,
# F32_LOOP_SOURCE), which flash_fwd.cu's f32 forward and ring_attention.cu's
# f32 block instantiate: name -> (the library built with the fault, the
# output it corrupts, the line as written, the line with the fault).
# fwd_alpha_dropped_f32 leaves acc unrescaled when a row's max moves on;
# fwd_keep_dropped_f32 leaves the dropout keep out of p * keep (both held
# to TOL["float32"] at the training shapes, dropout 0.1);
# ring_state_ignored_f32 makes every ring launch take the `first` branch
# (held to RING_TOL["float32"] at RING_FAULT_SHAPES, P = RING_FAULT_P).
# Built and required to fail as FAULTS are; tests/test_torch_flash.py checks
# on every run that each line is in the header exactly once, inside attend.
F32_LOOP_SOURCE = "flash_f32.cuh"
F32_FORWARD_FAULTS = {
    "fwd_alpha_dropped_f32": (
        "flash_fwd", "out",
        "for (int c = 0; c < DH / 16; ++c) acc[i][c] *= alpha;",
        "for (int c = 0; c < DH / 16; ++c) acc[i][c] *= 1.f;"),
    "fwd_keep_dropped_f32": (
        "flash_fwd", "out",
        "if (drop) p *= flash::dropout_keep(a.drop, hx + rk + 8 * j);",
        "if (drop) p *= 1.f;"),
    "ring_state_ignored_f32": (
        "ring_attention", "out",
        "const bool resume = RING && !a.first;",
        "const bool resume = false;"),
}
# the ring shapes (RING_SHAPES names) and ring size of ring_p_lo_dropped and
# ring_state_ignored_f32
RING_FAULT_SHAPES, RING_FAULT_P = ("serving_160", "long_video_2080"), 4
# planted fault of csrc/int8_matmul.cu's f32 (CUDA-core) kernel, as
# FORWARD_FAULTS: each split's last chunk of K left out of the product (at
# M = 4096 and 16384, one split, that is K's last 2 of 2818; at M = 128 and
# 2400, 6 and 15 chunks of 32 a split, every split's last). Built and
# required to fail INT8_TOL["float32"] at each f32 shape of INT8_SHAPES;
# tests/test_torch_int8.py checks on every run that the line is in
# int8_matmul.cu exactly once, in the f32 kernel.
INT8_FAULTS = {
    "int8_last_chunk_skipped_f32": (
        "int8_matmul", "out",
        "    product(acc, Xs + (t % STAGES) * X_TILE, Ws + (t & 1) * W_TILE, ty, tx);",
        "    if (t + 1 < nk)\n"
        "      product(acc, Xs + (t % STAGES) * X_TILE, Ws + (t & 1) * W_TILE, ty, tx);"),
}
# the bf16 backward kernels, by their names in the SASS and the profiler
BF16_BWD_KERNELS = ("flash_bwd_dq_kernel_sm90", "flash_bwd_dkv_kernel_sm90")
# every bf16 (wgmma) kernel, by library: each instantiation must issue HGMMA
# the planted faults' nvcc runs beside phases 3-3d at this added niceness,
# so that the timed phases' host threads keep their cores
FAULT_NICE = 10
SASS_KERNELS = {"flash_bwd": BF16_BWD_KERNELS,
                "flash_fwd": ("flash_fwd_kernel_sm90",),
                "ring_attention": ("ring_block_kernel_sm90",),
                "int8_matmul": ("int8_matmul_kernel_sm90",)}
# the f32 (CUDA-core) kernels, by library: the attention kernels and the
# int8 dequant-matmul's; ptxas must report no spill for any instantiation
# (their register tiles are sized to fit)
F32_KERNELS = {"flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
               "flash_fwd": ("flash_fwd_kernel",),
               "ring_attention": ("ring_block_kernel",),
               "int8_matmul": ("int8_matmul_f32_kernel",)}
# the f32 train step on the flash kernels vs on plain attention (same
# weights, same batches, dropouts 0): per-step loss and grad norm
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
# the pipeline with the flash kernel vs the same pipeline with plain attention
# (windows in seconds)
PIPE_TOL = {
    "float32": {"saliency": 2e-3, "scores": 1e-3, "windows": 1e-3},
    # bf16 on the 2048-clip video (4096 s). Plain bf16 attention scales q
    # before the dot and rounds the normalised p, the kernel scales after the
    # dot and rounds the unnormalised p. Readings on an H100: saliency
    # 5.9e-3, ranked scores 3.9e-3 (one bf16 step); window ends 8-16 s, one
    # or two bf16 steps of a span times 4096 s; the limit is four steps
    "bfloat16": {"saliency": 2e-2, "scores": 1e-2, "windows": 32.0},
}
# int8_matmul vs its twin, by max |kernel - twin| / max |twin| and, in bf16,
# the share of elements that differ, as BWD_TOL reasons: both sum in f32
# (in another order) and round once at the store, so in bf16 only a rare
# f32 sum on the far side of a rounding boundary flips, one bf16 step
INT8_TOL = {"float32": {"rel": 1e-5, "share": None},
            "bfloat16": {"rel": 8e-3, "share": 1e-2}}
INT8_K, INT8_N = 2818, 1024  # input_vid_proj.0: 2818 -> 1024
# the kernels an int8_matmul call launches: the product, and the sum of the
# splits where the plan splits K (each counted in int8_matmul.launches)
INT8_KERNELS = ("int8_matmul", "int8_matmul_split_sum")
# copies of the weight that the cold-L2 timing at M=128 goes through, one a
# call: 32 x 2.9 MB of int8 (x 5.8 MB of bf16 for cuBLAS) > the 50 MB L2
INT8_COLD_M, INT8_COLD_COPIES = 128, 32
INT8_SHAPES = {  # name -> (M, dtypes)
    "serving_128": (128, ("bfloat16", "float32")),
    "eval_batch": (32 * 75, ("bfloat16", "float32")),
    "qvhighlights_dispatch": (32 * 128, ("bfloat16", "float32")),
    "long_video_dispatch": (8 * 2048, ("bfloat16", "float32")),
}
N_VAL = 64  # val items of the training corpus: 2 eval batches of 32
# QVHighlights' val split (upstream data/highlight_val_release.jsonl): 1550
# queries, 49 eval batches of 32; phase 7d evaluates one of that size
N_VAL_FULL = 1550
# the released-run path (phase 7y): a released run's opt.json in upstream's
# flag names at the flagship's width (its v_feat_dim after the TEF bump),
# scored on the first N_REPRO queries of phase 7d's split, 8 eval batches of 32
REPRO_OPT = {"dset_name": "qvhighlights", "model_id": "univtg", "v_feat_dim": 2818,
             "t_feat_dim": 512, "hidden_dim": 1024, "enc_layers": 4, "nheads": 8,
             "dim_feedforward": 1024, "dropout": 0.1, "droppath": 0.1,
             "input_dropout": 0.5, "n_input_proj": 2, "span_loss_type": "l1",
             "max_v_l": 75, "max_q_l": 32, "use_txt_pos": False, "ctx_mode": "video_tef",
             "clip_length": 2.0, "eval_mode": "add"}
N_REPRO = 256
# 7d times its loader, profiles and holds the native reader against numpy
# over every 5th query (its one native pass reads every file)
EVAL_SUBSET = 5
# the train-mr profiler window of phase 7 (profile_steps): 2 of epoch 0's 3 steps
PROFILE_STEPS = 2
# the native AP against its numpy twin (both f64; the same operations, in
# the same order) and the native npz reader against np.load + l2_normalize
# (an f64 sum of squares on both sides; the norm's last ulp may differ)
AP_TOL, FEAT_TOL = 1e-12, 1e-6
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SHAPES = {  # (B, L, H, dh): L = video bucket + text bucket 32
    "long_video_2048": (8, 2048 + 32, 8, 128),
    "qvhighlights_128": (32, 128 + 32, 8, 128),
}
TRAIN_SHAPES = {  # (B, L, H, dh): L = clips + text tokens, no bucket
    "train_qvhighlights": (32, 75 + 32, 8, 128),
    "train_long_video": (8, 2048 + 32, 8, 128),
}
# the ring kernels vs their twin: absolute limits as the flash forward's; in
# bf16 also the share of elements that differ, as BWD_TOL reasons (both sum
# in f32, the kernel over 64-key tiles, the twin over whole blocks, and
# round once at the store). Readings of the bf16 wgmma kernel on an H100
# (700 W): max abs <= 2.0e-3, share <= 4.7e-3; ring_p_lo_dropped (p rounded
# to bf16 before P . V, FORWARD_FAULTS) reads the same max abs but a share of
# 0.19-0.35: only the share tells the two apart
RING_TOL = {"float32": {"abs": 1e-4, "share": None},
            "bfloat16": {"abs": 1.6e-2, "share": 1e-2}}
RING_SHAPES = {  # name -> (B, L, H, dh, ring sizes): L = video + text bucket
    "serving_160": (2, 128 + 32, 8, 128, (1, 2, 4)),
    "long_video_2080": (8, 2048 + 32, 8, 128, (1, 4, 8)),
    # the JAX package's long-context shape: 2 x (8192 clips + 32 tokens)
    "long_context_8224": (2, 8192 + 32, 8, 128, (4,)),
}
RING_P = 4  # ranks of the ring on the serving and training paths
RING_REPEATS = 20  # the P = 8 ring, run again: bit for bit its first output
KERNEL_NOTES = {  # name -> (source, the Pallas kernel it replaces)
    "flash_fwd": ("univtg_tpu_torch/csrc/flash_fwd.cu",
                  "univtg_tpu/ops/pallas_attention.py:98"),
    "flash_bwd_dq": ("univtg_tpu_torch/csrc/flash_bwd.cu",
                     "univtg_tpu/ops/pallas_attention.py:210"),
    "flash_bwd_dkv": ("univtg_tpu_torch/csrc/flash_bwd.cu",
                      "univtg_tpu/ops/pallas_attention.py:254"),
    "int8_matmul": ("univtg_tpu_torch/csrc/int8_matmul.cu",
                    "univtg_tpu/ops/pallas_int8.py:19"),
    "ring_attention": ("univtg_tpu_torch/csrc/ring_attention.cu",
                       "univtg_tpu/ops/ring_attention_pallas.py:56"),
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# scan_steps on CUDA graphs (phase 7e): K = 1 is the eager make_train_step;
# each K is timed over SCAN_TIMED_STEPS steps after its warm-up; train-mr
# runs SCAN_EPOCHS epochs of 3 steps at K = 2, so epoch 0's group runs
# eagerly, epoch 1's is captured and replayed, epoch 2's replayed
SCAN_KS = (1, 2, 8)  # K = 4 dropped (it read as K = 2 and 8 do)
SCAN_TIMED_STEPS = 16
SCAN_EPOCHS = 3
KEEP_SIGMAS = 4.0  # the kernels' keep rate over a step, against 1 - rate
# highlight detection (phase 7f): a TVSum-shaped corpus of HL_DOMAINS
# domains of HL_TRAIN + HL_VAL videos (configs/hl_splits/tvsum.json: 10 of
# 4 + 1), trained HL_EPOCHS epochs; fused scores "pallas" vs "xla" in f32
# at phase 4's f32 saliency limit; HL_SHAPE, its attention (B=4, 512 clips
# + 32 tokens), joins phase 3's kernel checks
HL_DOMAINS, HL_TRAIN, HL_VAL, HL_EPOCHS = 2, 4, 1, 2
HL_SCORE_TOL = 2e-3
HL_SHAPE = {"train_hl": (4, 512 + 32, 8, 128)}
# QFVS (phase 7g): a UT-Egocentric-shaped tree (QFVS_VIDEOS videos of 20
# segments x 200 frames of 512-d CLIP features, 4 concepts of 3 tokens each,
# the synthetic generator's own; the released query.pkl's token counts are
# not in the repo), `cli train-qfvs --preset qfvs` over QFVS_SPLITS of the 4
# leave-one-out splits for QFVS_EPOCHS of 20 epochs; per-shot scores
# "pallas" vs "xla" at phase 4's f32 saliency limit. QFVS_SHAPES, its
# attention (the segments are the batch: 20 x (200 + 3) for a concept,
# 20 x (200 + 6) for the oracle's pair), join phase 3's kernel checks
QFVS_VIDEOS, QFVS_SPLITS, QFVS_EPOCHS = 4, 1, 1
QFVS_SCORE_TOL = 2e-3
QFVS_SHAPES = {"train_qfvs_concept": (20, 200 + 3, 8, 128),
               "train_qfvs_oracle": (20, 200 + 6, 8, 128)}
# VLP (phase 7h): three synthetic MR corpora at full width (2816-d video,
# 512-d text, up to 75 clips), one per supervision type, VLP_PER_TYPE train
# items each, and a VLP_VAL-query QVHighlights-shaped val split;
# train_vlp on the vlp_pretrain preset (bsz 64) for VLP_EPOCHS of 10 epochs;
# VLP_SHAPE, its attention (B = 64, 75 clips + 32 tokens), joins phase 3
VLP_PER_TYPE, VLP_VAL, VLP_EPOCHS = 64, 64, 2
# phase 7k: the gang's epochs, its timed steps, the elastic restart's
# smaller depth, each gang's time limit and the teacher's sweep
DIST_EPOCHS, DIST_TIMED_STEPS, DIST_GANG_TIMEOUT_S = 1, 3, 300
DIST_ELASTIC = {"n_epoch": 2, "bsz": 64, "model.num_layers": 1}
DIST_FAULT_EPOCH = 0  # rank 1 of the elastic gang exits after this epoch
TEACHER_CLIPS, TEACHER_CONCEPTS, TEACHER_TOL = 150, 1000, 1e-5
VLP_SHAPE = {"train_vlp": (64, 75 + 32, 8, 128)}
# Moment-DETR (phase 7i): train_mr "l1" for MD_EPOCHS epochs on phase 7's
# corpus; the f32 step timed over MD_TIMED_STEPS steps; "exhaustive"
# matching may differ from scipy's only where its total cost is within
# MATCH_TIE_REL of scipy's (f32 sums of 5 costs in another order)
MD_EPOCHS, MD_TIMED_STEPS = 2, 10
MATCH_TIE_REL = 1e-5
# raw-video grounding (phase 7j), at the upstream demo's configuration
# (main_gradio.py:19-53): CLIP ViT-B/32 in front of the flagship, whose video
# input is 512 CLIP dims + 2 TEF (GROUND_OVERRIDES); a video of GROUND_CLIPS
# clips of 2 s (150 s); GROUND_QUERIES concurrent text POSTs; `cli
# extract-text` on GROUND_TEXT_ROWS queries; the image tower timed over
# GROUND_TIMED_FRAMES frames (a 68-minute video at 2 s clips). GROUND_SHAPE,
# the attention of one ground_video dispatch (B = 1, bucket 128 + 32
# tokens), joins phase 3
GROUND_OVERRIDES = ("model.vid_dim=514", "model.txt_dim=512", "model.attention_impl=pallas")
GROUND_CLIPS, GROUND_QUERIES, GROUND_TEXT_ROWS, GROUND_TIMED_FRAMES = 75, 8, 64, 2048
GROUND_SHAPE = {"ground_160": (1, 128 + 32, 8, 128)}
# phase 7j's limits. extract-text's files against txt2clip: both pad to one
# text batch on the same card, so only a fault can differ. The card's f32
# CLIP against the same CLIP on the CPU, max |d| / max |cpu|: only the
# summation order differs over 12 layers (TF32 off). uint8 frames normalized
# on the card against f32 frames normalized on the host: the JAX package's
# test limit. bf16 against f32, max |d| / max |f32|: 2.8x the larger reading
# on the H100 (image 4.7e-3, text 8.8e-3, with the attention projections and
# the residual stream in f32 as JAX promotes them)
GROUND_TEXT_TOL = 1e-5
CLIP_DEVICE_TOL = 1e-4
# torch's TF32 switches as the process found them (phase_device turns both
# off for the comparison phases; phase_tf32 runs its comparisons with these)
TF32_AS_FOUND = {}
# phase 7n: scan_steps = RING_SCAN_K under use_ring(RingGroup(RING_P)) at
# 8 x (2048 + 32), RING_SCAN_GROUPS groups (eager, captured, replayed) against
# as many eager ring steps; RING_SCAN_TIMED groups timed a dtype
RING_SCAN_K, RING_SCAN_GROUPS, RING_SCAN_TIMED = 2, 3, 2
# phase 7l: the JAX package's checkpoint of a small UniVTG after 2 steps, the
# next 2 batches and JAX's metrics of them (tests/torch_golden/make_jax_resume.py)
RESUME_FIXTURE = os.path.join("tests", "torch_golden", "jax_resume")
# phase 7m: `cli train-mr` with the background checkpoint writer on and off
ASYNC_EPOCHS = 1  # one evaluation: two saves (latest, best) a run
# phase 7o: HL in a gang of two gloo ranks sharing the card, per-rank bsz
HL_GANG_BSZ = 2
# phase 7p: the planted-signal learning check (tools/validate_synthetic.py) at
# the flagship's width and heads, LEARN_EPOCHS epochs (below the script's
# default 30, to pay for phases 7u-7x), f32 and bf16; beside it the JAX
# package's readings (docs/PERF.md, "End-to-end learning validation":
# hidden 1024 at 20 and 50 epochs)
LEARN_EPOCHS, LEARN_HIDDEN, LEARN_HEADS = 10, 1024, 8
JAX_LEARNING = {
    "cpu, hidden 96, 25 epochs": {"R1@0.5": 78.1, "mIoU": 58.8, "mAP": 43.2,
                                  "HL-VeryGood-mAP": 62.2},
    "tpu, hidden 1024, 20 epochs": {"mIoU": 72.0, "mAP": 58.8, "HL-VeryGood-mAP": 66.2},
    "tpu, hidden 1024, 50 epochs": {"R1@0.5": 93.8, "R1@0.7": 60.9, "mIoU": 74.4,
                                    "mAP": 63.0, "HL-VeryGood-mAP": 66.7},
}
CLIP_U8_TOL = 1e-4
CLIP_BF16_TOL = 2.5e-2
# phase 7r: the flagship with the JAX package's MoE configuration (4 experts,
# top-2, the scan layout: tests/test_moe.py's _moe_cfg), `cli train-mr`
# MOE_EPOCHS epochs a dtype; make_scan_train_step timed over MOE_TIMED_STEPS
MOE_OVERRIDES = ("model.moe_experts=4", "model.moe_top_k=2", "model.scan_layers=true")
MOE_EPOCHS, MOE_TIMED_STEPS, MOE_SERVE_QUERIES = 1, 4, 8
# a token whose top-2 choice differs between the f32 "pallas" and "xla" steps
# is allowed only where the "xla" run's probabilities of the two experts
# differ by at most this share of the larger: near-ties, as MATCH_TIE_REL for
# the matcher (the two runs' router inputs differ by the flash kernel's f32
# summation order, ~1e-6 rel, and after the first step by their params')
MOE_TIE_REL = 1e-4
# phase 7t: the JAX package's checkpoint of a small MoE model in the scan
# layout after 2 steps (tests/torch_golden/make_jax_moe.py)
MOE_FIXTURE = os.path.join("tests", "torch_golden", "jax_moe")
# phases 7u-7w: model parallelism across processes, gloo ranks sharing the
# card (parallel/mesh.py). 7u and 7w: one gang of MESH_TP ranks (tp = 2 for
# train_mr and the long step; then the MoE flagship on dp = 2 and on ep = 2);
# 7v: a gang of MESH_RING_P ranks whose tp axis is the ring. The long step
# and the ring at MESH_RING_SHAPE (B, L, H, dh), MESH_TIMED_STEPS timed steps
# or calls after one warm, MESH_RING_STEPS f32 ring steps against "xla"
MESH_TP, MESH_RING_P = 2, 4
MESH_TIMED_STEPS, MESH_RING_STEPS, MESH_GANG_TIMEOUT_S = 1, 2, 600
MESH_RING_SHAPE = (8, 2048 + 32, 8, 128)
# phase 7x: pipelines across processes (parallel/pipeline.py,
# parallel/pipeline_1f1b.py). (a) train_mr at dp = 2 x pp = 2 (GPipe) and
# (b) the 1F1B steps in one gang of MESH_PP gloo ranks, several meshes in
# turn; (c) GPipe at the flagship's dropouts and (d) the long shape at pp =
# 2, dp = 1, in 7u's gang of MESH_TP ranks. PP_STEPS steps a held case; (d)
# at PP_LONG_MICRO microbatches, PP_TIMED_STEPS timed steps after one warm
MESH_PP = MESH_RING_P  # 7v's ring cases run in 7x's gang
PP_STEPS, PP_TIMED_STEPS, PP_LONG_MICRO = 3, 1, (2, 8)
PP_CASES = (  # (b): (name, [dp, tp, ep, 1, pp] mesh, M, interleave, MoE)
    ("f1b_pp4_m8", [1, 1, 1, 1, 4], 8, 1, False),
    ("f1b_dp2pp2_v2_m4", [2, 1, 1, 1, 2], 4, 2, False),
    ("f1b_moe_pp2ep2_m4", [1, 1, 2, 1, 2], 4, 1, True),
)
# (e): a ring inside a pipeline stage, in the same gang: dp 1 x pp 2 x tp 2,
# each stage's tp ranks its ring, "ring_pallas" at MESH_RING_SHAPE's 8 x (2048
# + 32) tokens (2080 tiles over tp = 2; the flagship's 107 would not), M =
# PP_RING_M microbatches
PP_RING_MESH, PP_RING_M, PP_RING_TP = [1, 2, 1, 1, 2], 2, 2


T_START = time.perf_counter()
PHASE_SECONDS: list = []  # (phase, seconds) in the order run


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the process started."""
    print(f"{time.perf_counter() - T_START:7.1f} {msg}", flush=True)


def timed(name, fn, *args):
    """fn(*args), its seconds logged and kept in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS.append((name, round(time.perf_counter() - t0, 1)))
    log(f"[{name}] phase done in {PHASE_SECONDS[-1][1]:.1f} s")
    return out


def _launches() -> dict:
    """Every kernel's launch count."""
    from univtg_tpu_torch.ops import flash_attention as fa, int8_matmul as im
    from univtg_tpu_torch.ops import ring_attention_pallas as rap

    return {**fa.launches, **im.launches, **rap.launches}


def _reset_launches() -> None:
    """Every kernel's launch count, and the attention dispatch counts, to 0."""
    from univtg_tpu_torch.ops import attention as attn, flash_attention as fa
    from univtg_tpu_torch.ops import int8_matmul as im, ring_attention_pallas as rap

    for counts in (fa.launches, im.launches, rap.launches, attn.dispatches):
        for name in counts:
            counts[name] = 0


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, calls=20, reps=10):
    """ms per call of fn, replayed from one CUDA graph of `calls` calls:
    the device's time without the host's cost per call. fn runs once
    outside the graph first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * calls)


def cold_ms(torch, fn, copies):
    """(eager ms, graph ms) per call of fn(copy), each call on the next of
    `copies` in turn, so that no copy is in L2 when it is read."""
    import itertools

    ring = itertools.cycle(copies)
    eager = cuda_ms(lambda: fn(next(ring)), 2 * len(copies))
    return eager, graph_ms(torch, lambda: fn(next(ring)), calls=len(copies))


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[device] TF32 as found: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; both set to False for the "
        f"comparison phases")
    TF32_AS_FOUND.update(matmul=torch.backends.cuda.matmul.allow_tf32,
                         cudnn=torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _fault(name):
    """(library, output, line as written, line with the fault) of a planted
    fault of FAULTS or F32_FAULTS (flash_bwd.cu), FORWARD_FAULTS,
    F32_FORWARD_FAULTS or INT8_FAULTS."""
    if name in FAULTS or name in F32_FAULTS:
        return ("flash_bwd", *{**FAULTS, **F32_FAULTS}[name])
    return {**FORWARD_FAULTS, **F32_FORWARD_FAULTS, **INT8_FAULTS}[name]


def _fault_file(name):
    """The csrc/ file that holds the line a planted fault edits."""
    return F32_LOOP_SOURCE if name in F32_FORWARD_FAULTS else f"{_fault(name)[0]}.cu"


def stage_edits(library, file, edits, out_dir):
    """Copy csrc/<library>.cu into out_dir, with csrc/<file> (the source or
    one of its headers) edited there: each line of `edits` replaced by its
    value, each required once. A quoted include finds the copy in out_dir
    first, the other headers in csrc/ (-I). Returns the staged .cu path."""
    import shutil
    from pathlib import Path

    from univtg_tpu_torch.ops import cuda_build

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC_DIR / file).read_text()
    for line, new in edits.items():
        if text.count(line) != 1:
            raise AssertionError(f"{line!r} is not in {file} once")
        text = text.replace(line, new)
    (out_dir / file).write_text(text)
    src = out_dir / f"{library}.cu"
    if src.name != file:
        shutil.copyfile(cuda_build.CSRC_DIR / src.name, src)
    return src


def nvcc_staged(src, nice=0):
    """nvcc of a staged source (stage_edits) into a library beside it, at
    ``nice`` (added to this process's niceness) when given."""
    from univtg_tpu_torch.ops import cuda_build

    import shutil

    so = src.with_suffix(".so")
    prefix = ["nice", "-n", str(nice)] if nice and shutil.which("nice") else []
    subprocess.run([*prefix, cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                    "-I", str(cuda_build.CSRC_DIR), "-o", str(so), str(src)],
                   capture_output=True, text=True, check=True)
    return so


def _build_fault(name, out_dir, nice=0):
    """nvcc of csrc/<library>.cu with the planted fault `name`, in
    out_dir/name."""
    library, _, line, fault = _fault(name)
    return nvcc_staged(stage_edits(library, _fault_file(name), {line: fault},
                                   os.path.join(out_dir, name)), nice)


def _cuobjdump():
    """cuobjdump, from the toolkit that holds nvcc."""
    from pathlib import Path

    from univtg_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise AssertionError(f"no cuobjdump beside nvcc: {tool}")
    return str(tool)


def _ptxas_stats(text):
    """{function: [registers, spill store bytes, spill load bytes]} from the
    -Xptxas -v lines of a build log."""
    stats, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$.]+)", line)
        if m:
            fn = m.group(1)
            stats.setdefault(fn, [None, None, None])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            stats[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            stats[fn][0] = int(m.group(1))
    return stats


def _sass_counts(name):
    """HGMMA and HMMA instructions per kernel of the built library (cuobjdump
    -sass), printed beside ptxas's registers and spill bytes. Fails unless
    every instantiation of each of its bf16 kernels (SASS_KERNELS[name])
    issues HGMMA. Returns {kernel: [{function, HGMMA, HMMA, registers,
    spill_stores, spill_loads}]}."""
    from univtg_tpu_torch.ops import cuda_build

    so = cuda_build.library_path(name)
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
    stats = _ptxas_stats(cuda_build.build_log(name))
    found = {k: [] for k in SASS_KERNELS[name]}
    for fn, c in counts.items():
        reg, st, ld = stats.get(fn, (None, None, None))
        log(f"[build] sass {name} {fn[:90]}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}, "
            f"{reg} registers, spill stores {st} B, spill loads {ld} B")
        for k in SASS_KERNELS[name]:
            if k in fn:
                found[k].append({"function": fn, **c, "registers": reg,
                                 "spill_stores": st, "spill_loads": ld})
    for k, fns in found.items():
        if not fns or not all(f["HGMMA"] for f in fns):
            raise AssertionError(f"{k}: no HGMMA in the SASS of {so.name}: {fns}")
    return found


def phase_build(fault_dir):
    """One nvcc per source, all started together, and one per planted
    fault, started with them at FAULT_NICE and left to finish beside phases
    3-3d (``_fault_builds`` waits for them). Returns ({fault name: its
    build's future}, the bf16 kernels' SASS counts)."""
    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa, int8_matmul as im
    from univtg_tpu_torch.ops import ring_attention_pallas as rap

    def build(name):
        t0 = time.perf_counter()
        cuda_build.build(name)
        return time.perf_counter() - t0

    sources = fa.KERNEL_SOURCES + im.KERNEL_SOURCES + rap.KERNEL_SOURCES
    names = [*FAULTS, *F32_FAULTS, *FORWARD_FAULTS, *F32_FORWARD_FAULTS, *INT8_FAULTS]
    pool = concurrent.futures.ThreadPoolExecutor(len(names))
    faults = {n: pool.submit(_build_fault, n, fault_dir, FAULT_NICE) for n in names}
    pool.shutdown(wait=False)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as sources_pool:
        seconds = dict(zip(sources, sources_pool.map(build, sources)))
    for name in sources:
        if name in im.KERNEL_SOURCES:
            im._library()
        elif name in rap.KERNEL_SOURCES:
            rap._library()
        else:
            fa._library(name)
        log(f"[build] {name}: {seconds[name]:.2f} s")
        for line in cuda_build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "arning",
                                       "(C75")):
                log(f"[build]   {line.strip()}")
    sass = {}
    for name in SASS_KERNELS:
        sass.update(_sass_counts(name))
    for name, kernels in F32_KERNELS.items():
        stats = _ptxas_stats(cuda_build.build_log(name))
        f32_fns = {fn: s for fn, s in stats.items()
                   if any(k in fn for k in kernels) and "_sm90" not in fn}
        if len(f32_fns) < 2 * len(kernels) or any(s[1] or s[2] for s in f32_fns.values()):
            raise AssertionError(f"{name}: an f32 kernel spills or is missing "
                                 f"(registers, spill stores, spill loads): {f32_fns}")
    return faults, sass


def _fault_builds(pending):
    """The planted faults' libraries by name, once the builds that
    phase_build started have ended."""
    faults = {n: f.result() for n, f in pending.items()}
    log(f"[build] planted faults: {', '.join(f'{n} ({_fault_file(n)})' for n in faults)}")
    return faults


def _attention_inputs(torch, B, L, H, dh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = [torch.randn(B, L, H * dh, device="cuda", generator=g).to(dtype)
               for _ in range(3)]
    lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
    lens[0] = L
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).float()
    return q, k, v, mask


def phase_kernels(torch):
    """flash_fwd vs its twin; returns one record per (shape, dtype)."""
    import torch.nn.functional as F

    from univtg_tpu_torch.ops import flash_attention as fa

    records = []
    for shape_name, (B, L, H, dh) in {**SHAPES, **GROUND_SHAPE}.items():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, k, v, mask = _attention_inputs(torch, B, L, H, dh, dtype, seed=len(records))
            D, BH = H * dh, B * H
            sm_scale = dh**-0.5

            def split(x):
                return x.reshape(B, L, H, dh).transpose(1, 2).reshape(BH, L, dh).contiguous()

            qh, kh, vh = split(q), split(k), split(v)
            maskh = mask.repeat_interleave(H, dim=0)
            with torch.no_grad():
                out = fa.flash_attention(q, k, v, mask, num_heads=H)
            out_h, lse = fa.flash_attention_impl(qh, kh, vh, maskh, sm_scale=sm_scale)
            want, want_lse = fa.flash_attention_reference(qh, kh, vh, maskh, sm_scale=sm_scale)
            torch.cuda.synchronize()
            err_out = (split(out).float() - want.float()).abs().max().item()
            err_out_h = (out_h.float() - want.float()).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            ok = (torch.isfinite(out).all().item() and torch.isfinite(lse).all().item()
                  and max(err_out, err_out_h) <= TOL[dname]["out"]
                  and err_lse <= TOL[dname]["lse"])

            iters = 10 if L > 1000 else 50
            ms = cuda_ms(lambda: fa.flash_attention_impl(qh, kh, vh, maskh,
                                                         sm_scale=sm_scale), iters)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(qh, kh, vh, maskh, sm_scale=sm_scale),
                iters)
            q4, k4, v4 = (x.reshape(B, H, L, dh) for x in (qh, kh, vh))
            bool_mask = mask.bool()[:, None, None, :]
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask),
                iters)

            flops = 4 * BH * L * L * dh
            nbytes = (4 * B * L * D * q.element_size()  # q, k, v read; out written
                      + 4 * B * L + 4 * BH * L)  # mask read; lse written
            t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            rec = {
                "kernel": "flash_fwd", "shape": shape_name, "B": B, "L": L, "H": H,
                "dh": dh, "dtype": dname, "dropout": 0.0,
                "err_out": max(err_out, err_out_h), "err_lse": err_lse,
                "tol_out": TOL[dname]["out"], "tol_lse": TOL[dname]["lse"],
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "flops": flops, "bytes": nbytes,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "tflops": flops / ms / 1e9,
                "bound_share": max(t_ops, t_bytes) * 1e3 / ms,
            }
            records.append(rec)
            log(f"[kernels] flash_fwd {json.dumps(rec)}")
            if not ok:
                raise AssertionError(f"flash_fwd disagrees with its twin: {rec}")
            del q, k, v, qh, kh, vh, q4, k4, v4, out, out_h, want
            torch.cuda.empty_cache()
    return records


def _unambiguous_ranks_agree(np, got, want, score_atol, window_atol):
    """Ranked scores agree at score_atol, and so do the windows (at
    window_atol) of every rank whose score is more than score_atol away from
    both neighbours: near-ties may swap."""
    g, w = np.asarray(got["topk_windows"]), np.asarray(want["topk_windows"])
    if g.shape != w.shape or abs(g[:, 2] - w[:, 2]).max() > score_atol:
        return False
    s = w[:, 2]
    for i in range(len(s)):
        alone = ((i == 0 or s[i - 1] - s[i] > score_atol)
                 and (i == len(s) - 1 or s[i] - s[i + 1] > score_atol))
        if alone and abs(g[i, :2] - w[i, :2]).max() > window_atol:
            return False
    return True


def _check_result(np, res, ctx_l, clip_len=2.0):
    sal = np.asarray(res["saliency"])
    win = np.asarray(res["topk_windows"])
    if sal.shape != (ctx_l,) or not np.isfinite(sal).all() or not np.isfinite(win).all():
        raise AssertionError(f"bad grounding result: saliency {sal.shape}, windows {win}")
    if (win[:, :2] < 0).any() or (win[:, :2] > ctx_l * clip_len + 1e-6).any():
        raise AssertionError(f"windows outside the video: {win}")


def _hold_against_xla(np, name, got_all, want_all, ctx_l, tol):
    for got, want in zip(got_all, want_all, strict=True):
        _check_result(np, got, ctx_l)
        sal_err = float(np.abs(np.asarray(got["saliency"]) - want["saliency"]).max())
        g, w = np.asarray(got["topk_windows"]), np.asarray(want["topk_windows"])
        log(f"[pipeline] {name} pallas vs xla: saliency max err {sal_err:.3g}, "
            f"ranked scores {np.abs(g[:, 2] - w[:, 2]).max():.3g}, window ends "
            f"{np.abs(g[:, :2] - w[:, :2]).max():.3g} s, ties included (limits {tol})")
        if sal_err > tol["saliency"] or not _unambiguous_ranks_agree(
                np, got, want, tol["scores"], tol["windows"]):
            raise AssertionError(f"{name} flash pipeline disagrees with the xla pipeline: "
                                 f"got {g.tolist()}, want {w.tolist()}")


def phase_pipeline(np, fa, card):
    from univtg_tpu_torch.cli import flagship_config
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.serve import GroundingPipeline

    cfg_bf16 = flagship_config(compute_dtype="bfloat16")
    cfg_f32 = flagship_config(compute_dtype="float32")
    t0 = time.perf_counter()
    sd = UniVTG(cfg_f32, device="cpu", seed=0).state_dict()  # seeded Generator
    log(f"[pipeline] flagship weights from seed 0: "
        f"{sum(v.numel() for v in sd.values()) / 1e6:.2f} M params "
        f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(0)
    d_vid = cfg_f32.vid_dim - 2  # prepare_video appends 2 TEF dims

    def queries(n):
        return [rng.standard_normal((int(rng.integers(4, 33)), cfg_f32.txt_dim))
                .astype(np.float32) for _ in range(n)]

    def dispatch(name, fn, expect_launches):
        """One forward through the pipeline (its numpy results mean the card
        has finished); checks the flash launches it made."""
        before = fa.launches["flash_fwd"]
        t = time.perf_counter()
        res = fn()
        ms = (time.perf_counter() - t) * 1e3
        got = fa.launches["flash_fwd"] - before
        log(f"[pipeline] {name}: {ms:.2f} ms host clock ({card}), flash launches {got}")
        if got != expect_launches:
            raise AssertionError(f"{name}: {got} flash launches, expected {expect_launches}")
        return res, ms

    layers = cfg_f32.num_layers
    pipe_bf16 = GroundingPipeline(cfg_bf16, sd, eval_mode="add", device="cuda")
    long_vid = rng.standard_normal((2048, d_vid)).astype(np.float32)
    long_q = queries(8)
    pv_long = pipe_bf16.prepare_video(long_vid)
    assert pv_long.bucket == 2048
    bf16_ms = []
    for i in range(3):  # the first dispatch also warms cuBLAS and the allocator
        res_long, ms = dispatch(f"bf16 B=8 L=2048+32 dispatch {i}",
                                lambda: pipe_bf16.ground_prepared_many(
                                    [(pv_long, q) for q in long_q]),
                                layers)
        bf16_ms.append(ms)
    pipe_xla_bf16 = GroundingPipeline(
        flagship_config(compute_dtype="bfloat16", attention_impl="xla"), sd,
        eval_mode="add", device="cuda")
    ref_long, _ = dispatch("bf16 xla reference", lambda: pipe_xla_bf16.ground_prepared_many(
        [(pipe_xla_bf16.prepare_video(long_vid), q) for q in long_q]), 0)
    _hold_against_xla(np, "bf16 B=8 L=2048+32", res_long, ref_long, 2048,
                      PIPE_TOL["bfloat16"])
    del pipe_xla_bf16

    pipe_f32 = GroundingPipeline(cfg_f32, sd, eval_mode="add", device="cuda")
    pipe_xla = GroundingPipeline(flagship_config(attention_impl="xla"), sd,
                                 eval_mode="add", device="cuda")
    vids = [rng.standard_normal((75, d_vid)).astype(np.float32) for _ in range(2)]
    short_q = queries(2)
    items = [(pipe_f32.prepare_video(v), q) for v, q in zip(vids, short_q)]
    f32_ms = []
    for i in range(3):
        res_f32, ms = dispatch(f"f32 B=2 L=128+32 dispatch {i}",
                               lambda: pipe_f32.ground_prepared_many(items, top_k=10),
                               layers)
        f32_ms.append(ms)
    res_xla, _ = dispatch("f32 xla reference", lambda: pipe_xla.ground_prepared_many(
        [(pipe_xla.prepare_video(v), q) for v, q in zip(vids, short_q)], top_k=10), 0)
    _hold_against_xla(np, "f32 B=2 L=128+32", res_f32, res_xla, 75, PIPE_TOL["float32"])
    timings = {"bf16_long_ms": bf16_ms, "f32_short_ms": f32_ms}
    return pipe_f32, pipe_bf16, [(pv_long, q) for q in long_q], timings


def phase_server(np, pipe, fa):
    import io

    from univtg_tpu_torch.serve import GroundingServer

    rng = np.random.default_rng(1)
    d_vid = pipe.cfg.vid_dim - 2
    videos = {"short": rng.standard_normal((75, d_vid)).astype(np.float32),
              "long": rng.standard_normal((300, d_vid)).astype(np.float32)}
    server = GroundingServer(pipe, host="127.0.0.1", port=0, max_batch=16,
                             max_wait_ms=50.0).start()
    base = f"http://127.0.0.1:{server.port}"

    def call(path, data=None, method=None):
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        status, health = call("/healthz")
        if status != 200 or health["platform"] != "cuda":
            raise AssertionError(f"/healthz: {status} {health}")
        for vid_id, feats in videos.items():
            buf = io.BytesIO()
            np.savez(buf, features=feats)
            status, body = call(f"/videos/{vid_id}", data=buf.getvalue(), method="PUT")
            if status != 200:
                raise AssertionError(f"PUT /videos/{vid_id}: {status} {body}")
        reqs = [("short" if i % 2 else "long",
                 rng.standard_normal((int(rng.integers(4, 33)), pipe.cfg.txt_dim))
                 .astype(np.float32)) for i in range(8)]
        results = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))
        before = fa.launches["flash_fwd"]

        def fire(i):
            barrier.wait()
            results[i] = call("/ground", method="POST", data=json.dumps(
                {"video": reqs[i][0], "query_feats": reqs[i][1].tolist()}).encode())

        t = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall_ms = (time.perf_counter() - t) * 1e3
        if any(th.is_alive() for th in threads):
            raise AssertionError("a /ground request did not finish")
        launches = fa.launches["flash_fwd"] - before
        for (vid_id, q), (status, got) in zip(reqs, results):
            want = pipe.ground_features(videos[vid_id], q)
            if status != 200 or not (
                    np.allclose(got["topk_windows"], want["topk_windows"], atol=1e-4)
                    and np.allclose(got["saliency"], want["saliency"], atol=1e-4)):
                raise AssertionError(f"/ground answer differs from the pipeline ({vid_id})")
        _, stats = call("/stats")
        log(f"[server] 8 concurrent /ground: {wall_ms:.1f} ms wall, {stats['batches']} "
            f"batches, max batch {stats['max_batch_size']}, flash launches {launches}, "
            f"p50 {stats.get('latency_p50_ms')} ms")
        if stats["max_batch_size"] < 2 or stats["batches"] >= stats["requests"]:
            raise AssertionError(f"/stats shows no batching: {stats}")
        if launches == 0 or launches % pipe.cfg.num_layers:
            raise AssertionError(f"server forwards made {launches} flash launches")
    finally:
        server.close()


def _profile_window(torch, fn, n):
    """fn() n times under torch.profiler after a synchronize; returns
    (kernel device us by name, wall us of the window)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = defaultdict(float)
    for evt in prof.events():
        # device kernels and copies; a user annotation mirrored onto the
        # device timeline (the optimizer's "Optimizer.step#AdamW.step")
        # spans other kernels and would count their time twice
        if evt.device_type == DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            kernels[evt.name] += evt.time_range.elapsed_us()
    return kernels, wall_us


def _profile_record(cell, card, n, unit, kernels, wall_us, flash_names, label="flash",
                    **extra):
    busy_us = sum(kernels.values())
    flash = {name: sum(t for k, t in kernels.items() if f"{name}_kernel" in k)
             for name in flash_names}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    plural = {"dispatch": "dispatches", "step": "steps", "batch": "batches"}[unit]
    rec = {
        "cell": cell, "device": card, plural: n, **extra,
        f"host_ms_per_{unit}": wall_us / 1e3 / n,
        f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
        "idle_share": 1.0 - busy_us / wall_us if busy_us else None,
        f"{label}_share_of_busy": sum(flash.values()) / busy_us if busy_us else None,
        f"{label}_ms_per_{unit}": {k: t / 1e3 / n for k, t in flash.items()},
        f"top_kernels_ms_per_{unit}": [[k[:90], t / 1e3 / n] for k, t in top],
    }
    if not busy_us:
        rec["note"] = "torch.profiler recorded no device activity: not measured"
    log(f"[profile] {json.dumps(rec)}")


def phase_profile(torch, np, pipe, long_items, fa, card):
    """Per serving cell, after two warm dispatches, three more under
    torch.profiler: one JSON line each with host ms per dispatch, device-busy
    ms (sum of kernel durations), the idle share of the window, the flash
    kernel's share of busy time and the top kernels by time."""
    dispatches = 3
    rng = np.random.default_rng(2)
    d_vid = pipe.cfg.vid_dim - 2
    short = [(pipe.prepare_video(rng.standard_normal((75, d_vid)).astype(np.float32)),
              rng.standard_normal((int(rng.integers(4, 33)), pipe.cfg.txt_dim))
              .astype(np.float32)) for _ in range(32)]
    # qvhighlights_bf16: 32 distinct videos, one query each (no row shared)
    cells = {"long_video_bf16": long_items, "qvhighlights_bf16": short}
    for name, items in cells.items():
        for _ in range(2):
            pipe.ground_prepared_many(items)
        launches = fa.launches["flash_fwd"]
        kernels, wall_us = _profile_window(
            torch, lambda: pipe.ground_prepared_many(items), dispatches)
        _profile_record(name, card, dispatches, "dispatch", kernels, wall_us,
                        ["flash_fwd"], B=len(items),
                        flash_launches=fa.launches["flash_fwd"] - launches)


def _bound(flops, nbytes, dname):
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _errs(a, b):
    """(max |a - b|, that over max |b|, the share of elements that differ)."""
    diff = (a.float() - b.float()).abs().max().item()
    return (diff, diff / max(b.float().abs().max().item(), 1e-30),
            (a != b).float().mean().item())


def _train_kernel_inputs(torch, fa, B, L, H, dh, dtype, rate, seed):
    """Head-split q, k, v, mask, dO, the dropout seed and the kernel's own
    forward (out, lse) at one training shape."""
    q, k, v, mask = _attention_inputs(torch, B, L, H, dh, dtype, seed=seed)
    do = torch.randn(B, L, H * dh, device="cuda").to(dtype)

    def split(x):
        return x.reshape(B, L, H, dh).transpose(1, 2).reshape(B * H, L, dh).contiguous()

    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    maskh = mask.repeat_interleave(H, dim=0)
    dseed = torch.tensor([4221 + seed], dtype=torch.int32, device="cuda")
    kw = dict(sm_scale=dh**-0.5, dropout_rate=rate)
    out, lse = fa.flash_attention_impl(qh, kh, vh, maskh, dropout_seed=dseed, **kw)
    return (qh, kh, vh, maskh, out, lse, doh), mask, dseed, kw


def _bwd_within(err, dname):
    """One gradient's (max abs, rel, share) within BWD_TOL[dname]."""
    tol = BWD_TOL[dname]
    return err[1] <= tol["rel"] and (tol["share"] is None or err[2] <= tol["share"])


def _train_kernel_times(torch, fa, args, mask, seed, kw, B, L, H, dh, dname, rate):
    """Each kernel's ms, its twin's, SDPA's, the work and the bound at one
    training shape, by kernel name."""
    import torch.nn.functional as F

    qh, kh, vh, maskh, out, lse, doh = args
    D, BH, es = H * dh, B * H, torch.finfo(getattr(torch, dname)).bits // 8
    iters = 5 if L > 1000 else 20
    fwd_ms = cuda_ms(lambda: fa.flash_attention_impl(
        qh, kh, vh, maskh, dropout_seed=seed, **kw), iters)
    plain = {
        "flash_fwd": cuda_ms(lambda: fa.flash_attention_reference(
            qh, kh, vh, maskh, seed=seed, **kw), iters),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_reference(
            *args, seed=seed, **kw), iters),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_reference(
            *args, seed=seed, **kw), iters),
    }
    kernels, _ = _profile_window(torch, lambda: fa.flash_attention_backward_impl(
        *args, dropout_seed=seed, **kw), iters)
    ms = {name: sum(t for kname, t in kernels.items()
                    if f"{name}_kernel" in kname) / 1e3 / iters
          for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    ms["flash_fwd"] = fwd_ms

    q4, k4, v4 = (x.reshape(B, H, L, dh).detach().requires_grad_() for x in (qh, kh, vh))
    do4 = doh.reshape(B, H, L, dh)
    bool_mask = mask.bool()[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask, dropout_p=rate)

    lib_fwd = cuda_ms(sdpa, iters)
    lib_both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4), iters)

    n2 = BH * L * L * dh
    side = 4 * B * L + 8 * BH * L  # mask read; lse (+ delta) read or written
    work = {
        "flash_fwd": (4 * n2, 4 * B * L * D * es + 4 * B * L + 4 * BH * L),
        "flash_bwd_dq": (6 * n2, 5 * B * L * D * es + side),
        "flash_bwd_dkv": (8 * n2, 6 * B * L * D * es + side),
    }
    out = {}
    for name in FLASH_KERNELS:
        bound_ms, bound_by = _bound(*work[name], dname)
        out[name] = {"ms": ms[name], "plain_ms": plain[name],
                     "library_ms": lib_fwd if name == "flash_fwd" else None,
                     "flops": work[name][0], "bytes": work[name][1],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "tflops": work[name][0] / ms[name] / 1e9,
                     "bound_share": bound_ms / ms[name]}
        if name != "flash_fwd":
            out[name].update(pair_ms=ms["flash_bwd_dq"] + ms["flash_bwd_dkv"],
                             pair_library_ms=lib_both - lib_fwd)
    return out


def phase_train_kernels(torch):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their twins at the
    two training shapes and HL's, QFVS's two and VLP's, f32 and bf16, dropout
    0 and 0.1: each output on its own, relative to the twin's largest value.
    At dropout 0 also the times (``_train_kernel_times``): kernel times of
    the backward pair come from torch.profiler (one call launches both);
    each backward kernel is timed against its own twin. SDPA has no call
    for dQ or dK/dV alone, so their library_ms is null and pair_library_ms
    is the pair's yardstick: SDPA forward + backward through autograd minus
    SDPA forward, beside pair_ms, the two kernels' times summed."""
    from univtg_tpu_torch.ops import flash_attention as fa

    records = []
    for shape_name, (B, L, H, dh) in {**TRAIN_SHAPES, **HL_SHAPE, **QFVS_SHAPES,
                                       **VLP_SHAPE}.items():
        for dname in ("float32", "bfloat16"):
            for rate in (0.0, 0.1):
                dtype = getattr(torch, dname)
                args, mask, seed, kw = _train_kernel_inputs(
                    torch, fa, B, L, H, dh, dtype, rate, 100 + len(records))
                qh, kh, vh, maskh, out, lse, doh = args
                grads = fa.flash_attention_backward_impl(*args, dropout_seed=seed, **kw)
                r_out, r_lse = fa.flash_attention_reference(qh, kh, vh, maskh, seed=seed, **kw)
                r_dq = fa.flash_bwd_dq_reference(*args, seed=seed, **kw)
                r_dk, r_dv = fa.flash_bwd_dkv_reference(*args, seed=seed, **kw)
                torch.cuda.synchronize()
                err = {n: _errs(a, b) for n, a, b in zip(
                    ("out", "dq", "dk", "dv"), (out, *grads), (r_out, r_dq, r_dk, r_dv))}
                err_lse = (lse - r_lse).abs().max().item()
                finite = all(torch.isfinite(t).all().item() for t in (out, lse, *grads))
                del r_out, r_lse, r_dq, r_dk, r_dv
                times = None if rate else _train_kernel_times(
                    torch, fa, args, mask, seed, kw, B, L, H, dh, dname, rate)
                outputs = {"flash_fwd": ("out",), "flash_bwd_dq": ("dq",),
                           "flash_bwd_dkv": ("dk", "dv")}
                for name in FLASH_KERNELS:
                    rec = {"kernel": name, "shape": shape_name, "B": B, "L": L, "H": H,
                           "dh": dh, "dtype": dname, "dropout": rate,
                           "err": max(err[o][0] for o in outputs[name]),
                           **{f"rel_err_{o}": err[o][1] for o in outputs[name]},
                           **{f"differ_{o}": err[o][2] for o in outputs[name]},
                           **(times[name] if times else {})}
                    if name == "flash_fwd":
                        ok = err["out"][0] <= TOL[dname]["out"]
                        rec["tol"] = TOL[dname]["out"]
                    else:
                        ok = all(_bwd_within(err[o], dname) for o in outputs[name])
                        rec["tol"] = BWD_TOL[dname]
                    records.append(rec)
                    log(f"[kernels] {json.dumps(rec)}")
                    if not finite or not ok:
                        raise AssertionError(f"{name} disagrees with its twin: {rec}")
                if err_lse > TOL[dname]["lse"]:
                    raise AssertionError(f"flash_fwd lse disagrees with its twin: {err_lse}")
                del args, qh, kh, vh, doh, out, lse, grads
                torch.cuda.empty_cache()
    return records


def phase_faults(torch, faults):
    """Each planted fault, swapped in for its built library, must fail the
    limit its kernel is held to at each shape it runs: FAULTS (the bf16
    backward kernels, BWD_TOL), F32_FAULTS (the f32 backward kernels,
    BWD_TOL["float32"]) and the forward's FORWARD_FAULTS and
    F32_FORWARD_FAULTS (TOL) at the two training shapes with dropout 0.1,
    the ring's (RING_TOL, bf16 and f32) at RING_FAULT_SHAPES with P =
    RING_FAULT_P, and INT8_FAULTS (INT8_TOL["float32"]) at each f32 shape
    of INT8_SHAPES."""
    import ctypes

    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa, int8_matmul as im
    from univtg_tpu_torch.ops import ring_attention_pallas as rap
    from univtg_tpu_torch.parallel import RingGroup

    def run_with(name, fn):
        source = _fault(name)[0]
        real = cuda_build._libraries[source]
        cuda_build._libraries[source] = ctypes.CDLL(str(faults[name]))
        try:
            out = fn()
            torch.cuda.synchronize()
            return out
        finally:
            cuda_build._libraries[source] = real

    caught = {}
    for shape_name, (B, L, H, dh) in TRAIN_SHAPES.items():
        args, _, seed, kw = _train_kernel_inputs(
            torch, fa, B, L, H, dh, torch.bfloat16, 0.1, 900)
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_backward_reference(
            *args, seed=seed, **kw)))
        want_out, want_lse = fa.flash_attention_reference(*args[:4], seed=seed, **kw)
        for name in FAULTS:
            got = dict(zip(("dq", "dk", "dv"), run_with(
                name, lambda: fa.flash_attention_backward_impl(
                    *args, dropout_seed=seed, **kw))))
            output = FAULTS[name][0]
            err = _errs(got[output], want[output])
            caught[(name, shape_name)] = not _bwd_within(err, "bfloat16")
            log(f"[faults] {name} at {shape_name} bf16 dropout 0.1: {output} "
                f"max abs err {err[0]:.3g}, rel {err[1]:.3g}, share that differs "
                f"{err[2]:.3g} (limits {BWD_TOL['bfloat16']})")
        for name in (n for n in FORWARD_FAULTS if _fault(n)[0] == "flash_fwd"):
            out, lse = run_with(name, lambda: fa.flash_attention_impl(
                *args[:4], dropout_seed=seed, **kw))
            err, err_lse = _errs(out, want_out), (lse - want_lse).abs().max().item()
            tol = TOL["bfloat16"]
            caught[(name, shape_name)] = err[0] > tol["out"] or err_lse > tol["lse"]
            log(f"[faults] {name} at {shape_name} bf16 dropout 0.1: out max abs err "
                f"{err[0]:.3g}, share that differs {err[2]:.3g}, lse max abs err "
                f"{err_lse:.3g} (limits {tol})")
        del args, want, want_out, want_lse
        args, _, seed, kw = _train_kernel_inputs(
            torch, fa, B, L, H, dh, torch.float32, 0.1, 901)
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_backward_reference(
            *args, seed=seed, **kw)))
        for name, (output, _, _) in F32_FAULTS.items():
            got = dict(zip(("dq", "dk", "dv"), run_with(
                name, lambda: fa.flash_attention_backward_impl(
                    *args, dropout_seed=seed, **kw))))
            err = _errs(got[output], want[output])
            caught[(name, shape_name)] = not _bwd_within(err, "float32")
            log(f"[faults] {name} at {shape_name} f32 dropout 0.1: {output} "
                f"max abs err {err[0]:.3g}, rel {err[1]:.3g} (limit "
                f"{BWD_TOL['float32']})")
        want_out, want_lse = fa.flash_attention_reference(*args[:4], seed=seed, **kw)
        for name in (n for n in F32_FORWARD_FAULTS if _fault(n)[0] == "flash_fwd"):
            out, lse = run_with(name, lambda: fa.flash_attention_impl(
                *args[:4], dropout_seed=seed, **kw))
            err, err_lse = _errs(out, want_out), (lse - want_lse).abs().max().item()
            tol = TOL["float32"]
            caught[(name, shape_name)] = err[0] > tol["out"] or err_lse > tol["lse"]
            log(f"[faults] {name} at {shape_name} f32 dropout 0.1: out max abs err "
                f"{err[0]:.3g}, lse max abs err {err_lse:.3g} (limits {tol})")
        del args, want, got, want_out, want_lse, out, lse
        torch.cuda.empty_cache()
    ring_faults = {"bfloat16": [n for n in FORWARD_FAULTS if _fault(n)[0] == "ring_attention"],
                   "float32": [n for n in F32_FORWARD_FAULTS
                               if _fault(n)[0] == "ring_attention"]}
    for shape_name in RING_FAULT_SHAPES:
        B, L, H, dh, _ = RING_SHAPES[shape_name]
        for dname, names in ring_faults.items():
            q, k, v, mask = _attention_inputs(torch, B, L, H, dh, getattr(torch, dname),
                                              seed=950)
            mask[-1] = 0
            ring = RingGroup(RING_FAULT_P)
            want = rap.ring_attention_pallas_reference(q, k, v, mask, num_heads=H, ring=ring)
            for name in names:
                got = run_with(name, lambda: rap.ring_attention_pallas(
                    q, k, v, mask, num_heads=H, ring=ring))
                err = _errs(got, want)
                caught[(name, shape_name)] = not _ring_within(err, dname)
                log(f"[faults] {name} at {shape_name} P={RING_FAULT_P} {dname}: out max "
                    f"abs err {err[0]:.3g}, share that differs {err[2]:.3g} "
                    f"(limits {RING_TOL[dname]})")
            del q, k, v, mask, want, got
            torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(960)
    w_q = torch.randint(-127, 128, (INT8_K, INT8_N), device="cuda", generator=g,
                        dtype=torch.int8)
    scale = torch.rand(INT8_N, device="cuda", generator=g) * 1e-3 + 1e-4
    for shape_name, (M, dnames) in INT8_SHAPES.items():
        if "float32" not in dnames:
            continue
        x = torch.randn(M, INT8_K, device="cuda", generator=g)
        want = im.int8_matmul_reference(x, w_q, scale)
        for name in INT8_FAULTS:
            err = _errs(run_with(name, lambda: im.int8_matmul(x, w_q, scale)), want)
            caught[(name, shape_name)] = not _int8_within(err, "float32")
            log(f"[faults] {name} at {shape_name} (M={M}) f32: out max abs err "
                f"{err[0]:.3g}, rel {err[1]:.3g} (limit {INT8_TOL['float32']})")
        del x, want
    torch.cuda.empty_cache()
    missed = [k for k, hit in caught.items() if not hit]
    if missed:
        raise AssertionError(f"planted faults within their limits: {missed}")


def _int8_within(err, dname):
    """One output's (max abs, rel, share) within INT8_TOL[dname]."""
    tol = INT8_TOL[dname]
    return err[1] <= tol["rel"] and (tol["share"] is None or err[2] <= tol["share"])


def _int8_record(torch, shape_name, x, w_q, scale, w_lib, iters):
    """int8_matmul on (x, w_q, scale) against its twin, and a second call on
    the same input bit for bit: errors, kernel, twin and cuBLAS times
    (F.linear on w_lib, the dequantized weight in x's dtype, as a Linear
    holds it), eager and from a CUDA graph, at INT8_COLD_M also with the
    weight cold in L2, and the bound; raises past INT8_TOL or on a repeat
    that differs."""
    import torch.nn.functional as F

    from univtg_tpu_torch.ops import int8_matmul as im

    dname = str(x.dtype).removeprefix("torch.")
    got = im.int8_matmul(x, w_q, scale)
    again = im.int8_matmul(x, w_q, scale)
    want = im.int8_matmul_reference(x, w_q, scale)
    torch.cuda.synchronize()
    err = _errs(got, want)
    repeat = torch.equal(got, again)
    finite = torch.isfinite(got).all().item() and want.abs().max().item() > 0
    M, K = x.shape
    N = w_q.shape[1]
    es = x.element_size()
    flops, nbytes = 2 * M * K * N, M * K * es + K * N + 4 * N + M * N * es
    bound_ms, bound_by = _bound(flops, nbytes, dname)
    kernel = lambda: im.int8_matmul(x, w_q, scale)  # noqa: E731
    library = lambda: F.linear(x, w_lib)  # noqa: E731
    rec = {"kernel": "int8_matmul", "shape": shape_name, "M": M, "K": K, "N": N,
           "dtype": dname, "err": err[0], "rel_err": err[1], "differ": err[2],
           "twin_max_abs": want.float().abs().max().item(), "tol": INT8_TOL[dname],
           "bit_equal_repeat": repeat,
           "ms": cuda_ms(kernel, iters), "graph_ms": graph_ms(torch, kernel),
           "plain_ms": cuda_ms(lambda: im.int8_matmul_reference(x, w_q, scale), iters),
           "library_ms": cuda_ms(library, iters), "library_graph_ms": graph_ms(torch, library),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
    if M == INT8_COLD_M:
        copies = [w_q.clone() for _ in range(INT8_COLD_COPIES)]
        rec["cold_ms"], rec["cold_graph_ms"] = cold_ms(
            torch, lambda w: im.int8_matmul(x, w, scale), copies)
        copies = [w_lib.clone() for _ in range(INT8_COLD_COPIES)]
        rec["library_cold_ms"], rec["library_cold_graph_ms"] = cold_ms(
            torch, lambda w: F.linear(x, w), copies)
        del copies
    log(f"[kernels] {json.dumps(rec)}")
    if not finite or not _int8_within(err, dname):
        raise AssertionError(f"int8_matmul disagrees with its twin: {rec}")
    if not repeat:
        raise AssertionError(f"int8_matmul gave other bits on the same input: {rec}")
    return rec, got


def phase_int8_kernels(torch):
    """int8_matmul against its twin at INT8_SHAPES on a random weight,
    quantized per output column as serve/quantize.py quantizes it."""
    g = torch.Generator(device="cuda").manual_seed(8)
    w = torch.randn(INT8_K, INT8_N, device="cuda", generator=g) * 0.02
    scale = w.abs().amax(0, keepdim=True) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    w_deq = (w_q.float() * scale).t().contiguous()  # (N, K), as a Linear holds it
    records = []
    for shape_name, (M, dnames) in INT8_SHAPES.items():
        for dname in dnames:
            dtype = getattr(torch, dname)
            x = torch.randn(M, INT8_K, device="cuda", generator=g).to(dtype)
            rec, _ = _int8_record(torch, shape_name, x, w_q, scale, w_deq.to(dtype),
                                  10 if M > 8192 else 50)
            records.append(rec)
    return records


def _overlap_share(torch, fn):
    """From one torch.profiler window over fn(): the share of the ring's
    device-to-device copy time that overlaps a ring_block kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies, blocks = [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        if "ring_block_kernel" in evt.name:
            blocks.append(span)
        elif "memcpy" in evt.name.lower():
            copies.append(span)
    if not copies or not blocks:
        return None, 0.0
    blocks.sort()
    merged = [list(blocks[0])]
    for a, b in blocks[1:]:  # the union of the block kernels' intervals
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = sum(b - a for a, b in copies)
    under = sum(max(0, min(b, y) - max(a, x)) for a, b in copies for x, y in merged)
    return (under / total if total else None), total / 1e3


def _ring_within(err, dname):
    tol = RING_TOL[dname]
    return err[0] <= tol["abs"] and (tol["share"] is None or err[2] <= tol["share"])


def _ring_check(torch, B, L, H, dh, dtype, P, devices=None, seed=0):
    """The ring kernels against their twin on inputs with one fully masked
    batch row; returns (inputs, ring, kernel output, (abs, rel, share))."""
    from univtg_tpu_torch.ops import ring_attention_pallas as rap
    from univtg_tpu_torch.parallel import RingGroup

    q, k, v, mask = _attention_inputs(torch, B, L, H, dh, dtype, seed=seed)
    mask[-1] = 0  # a fully masked row: the mean of V over the L real keys
    ring = RingGroup(P, devices)
    before = dict(rap.launches)
    got = rap.ring_attention_pallas(q, k, v, mask, num_heads=H, ring=ring)
    made = {n: rap.launches[n] - before[n] for n in before}
    want = rap.ring_attention_pallas_reference(q, k, v, mask, num_heads=H, ring=ring)
    torch.cuda.synchronize()
    if made != {"ring_block": P * P, "ring_finish": P}:
        raise AssertionError(f"ring of {P}: launches {made}, not {P * P} + {P}")
    row_err = (got[-1].float() - v[-1].float().mean(0)).abs().max().item()
    if not torch.isfinite(got).all().item() or row_err > RING_TOL[str(dtype)[6:]]["abs"]:
        raise AssertionError(f"ring of {P}: the masked row is not the mean of V ({row_err})")
    return (q, k, v, mask), ring, got, _errs(got, want)


def phase_ring_kernels(torch):
    """ring_attention (ring_block + ring_finish and the transport) against its
    twin at RING_SHAPES, f32 and bf16, each ring size of the shape on one
    card; P = 1 also against flash_fwd; the P = 8 ring repeated RING_REPEATS
    times, bit for bit; times of the whole ring (CUDA events), the twin,
    SDPA over the whole sequence, flash_fwd, the bound, and the share of copy
    time that overlaps a block kernel; then the ring across two cards where
    the process sees two."""
    import torch.nn.functional as F

    from univtg_tpu_torch.ops import flash_attention as fa
    from univtg_tpu_torch.ops import ring_attention_pallas as rap

    records = []
    for shape_name, (B, L, H, dh, sizes) in RING_SHAPES.items():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for P in sizes:
                (q, k, v, mask), ring, got, err = _ring_check(
                    torch, B, L, H, dh, dtype, P, seed=300 + len(records))
                ok = _ring_within(err, dname)
                extra = {}
                if P == 1:
                    flash = fa.flash_attention(q, k, v, mask, num_heads=H)
                    extra["err_vs_flash_fwd"] = _errs(got, flash)[0]
                    ok = ok and extra["err_vs_flash_fwd"] <= TOL[dname]["out"]
                if P == 8:
                    same = [torch.equal(got, rap.ring_attention_pallas(
                        q, k, v, mask, num_heads=H, ring=ring)) for _ in range(RING_REPEATS)]
                    extra["repeats_bit_equal"] = f"{sum(same)}/{RING_REPEATS}"
                    ok = ok and all(same)

                iters = 5 if L > 4000 else (10 if L > 1000 else 50)
                ms = cuda_ms(lambda: rap.ring_attention_pallas(q, k, v, mask, num_heads=H,
                                                               ring=ring), iters)
                plain_ms = cuda_ms(lambda: rap.ring_attention_pallas_reference(
                    q, k, v, mask, num_heads=H, ring=ring), iters)
                q4, k4, v4 = (x.view(B, L, H, dh).transpose(1, 2) for x in (q, k, v))
                bool_mask = mask.bool()[:, None, None, :]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=bool_mask), iters)
                flash_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, num_heads=H),
                                   iters)
                overlap, copy_ms = (None, 0.0) if P == 1 else _overlap_share(
                    torch, lambda: rap.ring_attention_pallas(q, k, v, mask, num_heads=H,
                                                             ring=ring))
                es, D, BH = q.element_size(), H * dh, B * H
                flops = 4 * BH * L * L * dh
                block = 2 * B * (L // P) * D * es + 4 * B * (L // P)  # k, v and mask
                nbytes = 4 * B * L * D * es + 4 * B * L + (P - 1) * P * 2 * block
                bound_ms, bound_by = _bound(flops, nbytes, dname)
                rec = {"kernel": "ring_attention", "shape": shape_name, "B": B, "L": L,
                       "H": H, "dh": dh, "P": P, "dtype": dname, "err": err[0],
                       "rel_err": err[1], "differ": err[2], "tol": RING_TOL[dname], **extra,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "flash_fwd_ms": flash_ms, "flops": flops, "bytes": nbytes,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
                       "copy_overlap_share": overlap, "copy_ms": copy_ms}
                records.append(rec)
                log(f"[ring] {json.dumps(rec)}")
                if not ok:
                    raise AssertionError(f"ring_attention disagrees with its twin: {rec}")
                del q, k, v, mask, got, q4, k4, v4
                torch.cuda.empty_cache()

    if torch.cuda.device_count() >= 2:
        B, L, H, dh, _ = RING_SHAPES["long_video_2080"]
        for dname in ("float32", "bfloat16"):
            _, _, _, err = _ring_check(torch, B, L, H, dh, getattr(torch, dname), 2,
                                       devices=["cuda:0", "cuda:1"], seed=400)
            log(f"[ring] two cards, P=2, {B}x{L} {dname}: max abs {err[0]:.3g}, share "
                f"that differs {err[2]:.3g} (limits {RING_TOL[dname]})")
            if not _ring_within(err, dname):
                raise AssertionError(f"the ring across two cards disagrees: {err}")
    else:
        log(f"[ring] the two-card leg did not run: this process sees "
            f"{torch.cuda.device_count()} card")
    return records


def _train_batches(np, corpus, n, bsz=32):
    """The first n collated batches of the corpus, as the driver's Loader
    gives them in epoch 0."""
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.loader import Loader
    from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset

    ds = MRDataset(MRDataConfig(
        data_path=corpus["train_path"], v_feat_dirs=corpus["v_feat_dirs"],
        q_feat_dir=corpus["q_feat_dir"], v_feat_dim=corpus["v_dim"],
        q_feat_dim=corpus["q_dim"], max_q_l=32, max_v_l=75))
    loader = Loader(ds, bsz, lambda items, pad_batch_to: collate_mr(
        items, 32, 75, pad_batch_to), shuffle=True, seed=2018, num_threads=4)
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    return out


def _run_steps(torch, cfg, state_dict, cpu_batches, seed=0, on_model=None):
    """A fresh model holding state_dict (handed to ``on_model`` first, where
    given), stepped over the batches by make_train_step; returns (state,
    per-step metrics as floats)."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    model = UniVTG(cfg, device="meta")
    model.load_state_dict({k: v.cuda() for k, v in state_dict.items()}, assign=True)
    if on_model is not None:
        on_model(model)
    state = TrainState(model, make_optimizer(
        model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 3), 1e-4, 0.1))
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    history = []
    for batch in cpu_batches:
        mi, tg = (to_device(t, "cuda") for t in strip_meta(batch))
        state, m = step(state, mi, tg, seed)
        history.append({k: float(v) for k, v in m.items()})
    return state, history


def _eval_overrides(corpus):
    """Overrides pointing the preset's eval split at the synthetic val split."""
    return [f"eval_data.data_path={corpus['val_path']}",
            f"eval_data.v_feat_dirs={corpus['v_feat_dirs']}",
            f"eval_data.q_feat_dir={corpus['q_feat_dir']}", "eval_data.v_feat_dim=2816"]


def _eval_cfg(corpus, *overrides):
    """The qvhighlights_mr preset with its eval split on the corpus, as
    `cli infer-mr` builds it."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.presets import PRESETS

    return cli.apply_overrides(PRESETS["qvhighlights_mr"](),
                               [*_eval_overrides(corpus), *overrides])


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_train(torch, np, fa, card, tmp):
    """The training main path: `cli train-mr` at full width, bf16, on the
    flash kernels, evaluating the val split after each epoch. Returns
    (corpus, run dir, seeded weights, kernel launches)."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
    from univtg_tpu_torch.interop import load_torch_checkpoint, read_checkpoint
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.serve import GroundingPipeline

    t0 = time.perf_counter()
    corpus = create_synthetic_mr_corpus(os.path.join(tmp, "corpus"), n_train=96,
                                        n_val=N_VAL, v_dim=2816, q_dim=512, max_clips=75,
                                        seed=0)
    log(f"[train] synthetic corpus: 96 train and {N_VAL} val items, 2816-d video, "
        f"512-d text ({time.perf_counter() - t0:.1f} s)")
    run_dir = os.path.join(tmp, "run")
    profile_dir = os.path.join(tmp, "profile")
    epochs, eval_batches = 2, -(-N_VAL // 32)
    argv = ["train-mr", "--preset", "qvhighlights_mr",
            f"train_data.data_path={corpus['train_path']}",
            f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
            f"train_data.q_feat_dir={corpus['q_feat_dir']}",
            "train_data.v_feat_dim=2816", *_eval_overrides(corpus), "eval_epoch=1",
            f"n_epoch={epochs}", "bsz=32", "eval_bsz=32",
            "model.attention_impl=pallas", "model.compute_dtype=bfloat16",
            f"results_dir={run_dir}", f"profile_dir={profile_dir}",
            f"profile_steps={PROFILE_STEPS}", "tensorboard_dir=auto"]
    _reset_launches()  # the training main path starts here
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # ... and ends here
    lines = _jsonl(os.path.join(run_dir, "train_log.jsonl"))
    evals = _jsonl(os.path.join(run_dir, "eval_log.jsonl"))
    steps = sum(line["steps"] for line in lines)
    line = lines[0]
    log(f"[train] cli train-mr: {steps} steps in {len(lines)} epochs, epoch 0 "
        f"{line['time']:.2f} s ({card}), {wall:.2f} s with model build, "
        f"{len(evals)} evaluations and checkpoints; loss {line['loss_overall']:.4f}, "
        f"grad norm {line['grad_norm']:.4f}; MR-full-mAP by epoch "
        f"{[e['MR-full-mAP-key'] for e in evals]}; launches {launches}")
    if steps != 3 * epochs or not all(np.isfinite(x["loss_overall"]) for x in lines):
        raise AssertionError(f"train-mr did not take 3 finite steps per epoch: {lines}")
    want = {name: 4 * steps for name in FLASH_KERNELS}
    want["flash_fwd"] += 4 * eval_batches * epochs
    if {k: launches[k] for k in FLASH_KERNELS} != want:
        raise AssertionError(f"expected 4 launches of each kernel per step and 4 "
                             f"flash_fwd per eval batch: {launches}, not {want}")
    best_epoch = max(evals, key=lambda e: (e["MR-full-mAP-key"], -e["epoch"]))["epoch"]
    blob = read_checkpoint(os.path.join(run_dir, "model_best.ckpt"))
    latest = read_checkpoint(os.path.join(run_dir, "model_latest.ckpt"))
    made = [n for n in ("latest_val_preds.jsonl", "metrics_e0000.json", "metrics_e0001.json")
            if os.path.exists(os.path.join(run_dir, n))]
    log(f"[train] model_best.ckpt from epoch {blob['epoch']} (best MR-full-mAP at "
        f"{best_epoch}), model_latest.ckpt from epoch {latest['epoch']}; wrote {made}")
    if ([e["epoch"] for e in evals] != list(range(epochs)) or blob["epoch"] != best_epoch
            or latest["epoch"] != epochs - 1 or len(made) != 3):
        raise AssertionError("in-training evaluation did not keep the best/latest pair")
    del blob, latest
    _check_run_records(run_dir, profile_dir)

    # f32 on the flash kernels vs f32 on plain attention
    sd = UniVTG(flagship_model(), device="cpu", seed=0).state_dict()
    batches = _train_batches(np, corpus, 3)
    quiet = dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    runs = {impl: _run_steps(torch, flagship_model(attention_impl=impl, **quiet), sd,
                             batches)[1] for impl in ("pallas", "xla")}
    for i, (got, want) in enumerate(zip(runs["pallas"], runs["xla"], strict=True)):
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
        log(f"[train] f32 step {i}: pallas loss {got['loss_overall']:.6f} grad norm "
            f"{got['grad_norm']:.6f}; xla {want['loss_overall']:.6f} "
            f"{want['grad_norm']:.6f}; rel err loss {rel['loss_overall']:.2e} "
            f"grad norm {rel['grad_norm']:.2e} (limits {TRAIN_TOL})")
        if rel["loss_overall"] > TRAIN_TOL["loss"] or rel["grad_norm"] > TRAIN_TOL["grad_norm"]:
            raise AssertionError(f"f32 pallas train step {i} disagrees with xla: {rel}")

    # one seeded step with attention dropout 0.1 through the kernels
    before = dict(fa.launches)
    drop_cfg = flagship_model(attention_impl="pallas", dropout=0.1)
    a = _run_steps(torch, drop_cfg, sd, batches[:1], seed=7)[1][0]
    b = _run_steps(torch, drop_cfg, sd, batches[:1], seed=7)[1][0]
    c = _run_steps(torch, drop_cfg, sd, batches[:1], seed=8)[1][0]
    made = {n: fa.launches[n] - before[n] for n in before}
    log(f"[train] dropout 0.1 step: loss {a['loss_overall']:.6f} (seed 7, twice: "
        f"{b['loss_overall']:.6f}), seed 8 {c['loss_overall']:.6f}; launches {made}")
    # the losses come from the forward alone, which is deterministic here
    if (made != {n: 12 for n in before} or a["loss_overall"] != b["loss_overall"]
            or a["loss_overall"] == c["loss_overall"]):
        raise AssertionError("the seeded dropout step did not reach the kernels "
                             "deterministically")

    # the written checkpoint serves
    model_cfg = flagship_model(attention_impl="pallas", compute_dtype="bfloat16")
    best = os.path.join(run_dir, "model_best.ckpt")
    trained = load_torch_checkpoint(best, model_cfg)
    init = UniVTG(flagship_model(), device="cpu", seed=2018).state_dict()  # train-mr's
    moved = max((trained[k].float() - init[k]).abs().max().item() for k in init)
    if not moved > 0:
        raise AssertionError("the checkpoint holds the initial weights")
    pipe = GroundingPipeline(model_cfg, trained, eval_mode="add", device="cuda")
    rng = np.random.default_rng(3)
    res = pipe.ground_features(rng.standard_normal((75, 2816)).astype(np.float32),
                               rng.standard_normal((12, 512)).astype(np.float32))
    _check_result(np, res, 75)
    log(f"[train] served {best}: top-1 window {res['top1_window']}; largest weight "
        f"change from the initial weights {moved:.3g}")
    return corpus, run_dir, sd, launches


def _check_run_records(run_dir, profile_dir):
    """What train-mr writes beside its logs: opt.json, code.zip with the
    kernel sources, one torch.profiler trace of its first PROFILE_STEPS steps
    that names each flash kernel, and TensorBoard events where the
    tensorboard package is importable (TBWriter is a no-op without it)."""
    import zipfile

    from univtg_tpu_torch.train.config_io import load_config
    from univtg_tpu_torch.train.driver_mr import TrainConfig

    cfg = load_config(TrainConfig, run_dir)
    with zipfile.ZipFile(os.path.join(run_dir, "code.zip")) as z:
        zipped = [n for n in z.namelist() if n.endswith((".cu", ".cuh", ".cpp"))]
    traces = [f for f in os.listdir(profile_dir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"train-mr wrote {traces} into profile_dir, not one trace")
    path = os.path.join(profile_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {k: sorted(n for n in kernels if f"{k}_kernel" in n) for k in FLASH_KERNELS}
    tb_dir = os.path.join(run_dir, "tb")
    tb_files = sorted(os.listdir(tb_dir)) if os.path.isdir(tb_dir) else []
    log(f"[train] opt.json restores profile_steps={cfg.profile_steps}, "
        f"tensorboard_dir={cfg.tensorboard_dir!r}; code.zip holds {len(zipped)} kernel "
        f"sources; trace {traces[0]} ({os.path.getsize(path) / 1e6:.1f} MB, "
        f"{len(kernels)} kernel names) names {named}; TBWriter "
        f"{'active: ' + str(tb_files) if tb_files else 'inactive (no tensorboard package)'}")
    if cfg.profile_steps != PROFILE_STEPS or not any(n.endswith("flash_fwd.cu") for n in zipped):
        raise AssertionError("opt.json or code.zip does not hold the run")
    if not all(named.values()):
        raise AssertionError(f"the train-mr trace does not name every flash kernel: {named}")


def _infer_mr(torch, np, tmp, ckpt, corpus, name, impl, dtype, *overrides):
    """`cli infer-mr` on ckpt over the val split (with any further
    key=value overrides); returns (brief metrics, submission rows, flash_fwd
    launches, wall seconds). The submission and the printed metrics must be
    there and finite."""
    import contextlib
    import io

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.ops import flash_attention as fa

    out = os.path.join(tmp, f"preds_{name}.jsonl")
    before = fa.launches["flash_fwd"]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli.main(["infer-mr", "--preset", "qvhighlights_mr", "--resume", ckpt,
                  "--out", out, *_eval_overrides(corpus), f"model.attention_impl={impl}",
                  f"model.compute_dtype={dtype}", *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    brief = json.loads(printed.getvalue())
    rows = _jsonl(out)
    launches = fa.launches["flash_fwd"] - before
    log(f"[eval] cli infer-mr {name}: {len(rows)} rows, {wall:.2f} s with model build, "
        f"flash_fwd launches {launches}; MR-full-mAP {brief['MR-full-mAP-key']}, "
        f"R1@0.5 {brief['MR-full-R1@0.5-key']}, HL-VeryGood-mAP "
        f"{brief['HL-min-VeryGood-mAP-key']}")
    windows = np.asarray([w for r in rows for w in r["pred_relevant_windows"]])
    saliency = np.asarray([v for r in rows for v in r["pred_saliency_scores"]])
    if (len(rows) != N_VAL or windows.shape[1:] != (3,) or not np.isfinite(windows).all()
            or not np.isfinite(saliency).all()
            or not all(np.isfinite(v) for v in brief.values())):
        raise AssertionError(f"infer-mr {name}: a bad submission or metrics: {brief}")
    return brief, rows, launches, wall


def phase_eval(torch, np, tmp, corpus, run_dir):
    """The eval main path: `cli infer-mr` on model_best.ckpt, bf16 and f32,
    on the flash kernels; f32 "pallas" held against f32 "xla": the metrics
    equal, and the windows within PIPE_TOL as the decode gives them, before
    the post-processor rounds each end to a multiple of the clip length (2
    s), where an f32 difference at a rounding boundary moves an end by a
    whole clip (a start of 2.9999 s against 3.0 s rounds to 2 against 4 s).
    Returns (the eval path's launches, f32 brief metrics)."""
    best = os.path.join(run_dir, "model_best.ckpt")
    batches = -(-N_VAL // 32)
    _reset_launches()  # the eval main path starts here
    _, _, launches, _ = _infer_mr(torch, np, tmp, best, corpus, "bf16", "pallas", "bfloat16")
    path_launches = _launches()  # ... and ends here
    if launches != 4 * batches:
        raise AssertionError(f"infer-mr made {launches} flash_fwd launches for "
                             f"{batches} eval batches, not 4 per batch")
    f32, rows, launches, _ = _infer_mr(torch, np, tmp, best, corpus, "f32", "pallas", "float32")
    xla, xla_rows, xla_launches, _ = _infer_mr(torch, np, tmp, best, corpus, "f32_xla", "xla",
                                               "float32")
    if launches != 4 * batches or xla_launches != 0:
        raise AssertionError(f"f32 flash_fwd launches {launches}, xla {xla_launches}")
    raw = {impl: _infer_mr(torch, np, tmp, best, corpus, f"f32_{impl}_unrounded", impl,
                           "float32", "round_multiple=0")
           for impl in ("pallas", "xla")}
    tol = PIPE_TOL["float32"]

    def worst(a, b):
        return max(np.abs(np.asarray(g["pred_relevant_windows"])
                          - np.asarray(w["pred_relevant_windows"])).max()
                   for g, w in zip(a, b, strict=True))

    raw_rows, raw_xla_rows = raw["pallas"][1], raw["xla"][1]
    log(f"[eval] f32 pallas vs xla: metrics equal {f32 == xla}, unrounded "
        f"{raw['pallas'][0] == raw['xla'][0]}; windows and scores differ by at most "
        f"{worst(raw_rows, raw_xla_rows):.3g} before rounding, "
        f"{worst(rows, xla_rows):.3g} after, near-ties included (limits {tol})")
    if f32 != xla or not all(
            _unambiguous_ranks_agree(np, {"topk_windows": g["pred_relevant_windows"]},
                                     {"topk_windows": w["pred_relevant_windows"]},
                                     tol["scores"], tol["windows"])
            for g, w in zip(raw_rows, raw_xla_rows)):
        raise AssertionError(f"f32 infer-mr on the flash kernels disagrees with xla: "
                             f"{f32} vs {xla}")
    return path_launches, f32


def _released_run(torch, tmp, val_corpus):
    """A released upstream run at the flagship's full width (REPRO_OPT,
    random weights from seed 0): the port's UniVTG state dict under DDP's
    ``module.`` prefixes in upstream's container, opt.json beside it; and a
    QVHighlights val split of its first N_REPRO queries from phase 7d's
    synthetic one (2816-d video, 512-d text, up to 75 clips). Returns (ckpt
    path, corpus)."""
    from univtg_tpu_torch.interop import config_from_reference_opt
    from univtg_tpu_torch.models import UniVTG

    run_dir = os.path.join(tmp, "released")
    os.makedirs(run_dir)
    sd = UniVTG(config_from_reference_opt(REPRO_OPT), device="cuda", seed=0).state_dict()
    ckpt = os.path.join(run_dir, "model_best.ckpt")
    torch.save({"model": {f"module.{k}": v.cpu() for k, v in sd.items()}, "optimizer": {},
                "lr_scheduler": {}, "epoch": 99, "opt": REPRO_OPT}, ckpt)
    with open(os.path.join(run_dir, "opt.json"), "w") as f:
        json.dump(REPRO_OPT, f)
    if (val_corpus["v_dim"] + 2, val_corpus["q_dim"], val_corpus["max_clips"]) != (
            REPRO_OPT["v_feat_dim"], REPRO_OPT["t_feat_dim"], REPRO_OPT["max_v_l"]):
        raise AssertionError(f"phase 7d's split is not the flagship's shape: {val_corpus}")
    val_path = os.path.join(run_dir, "highlight_val_release.jsonl")
    with open(val_path, "w") as f:
        f.writelines(json.dumps(row) + "\n"
                     for row in _jsonl(val_corpus["val_path"])[:N_REPRO])
    return ckpt, {**val_corpus, "val_path": val_path}


def _reproduce(torch, tmp, ckpt, corpus, impl):
    """tools/reproduce_model_md.main on the released run, f32 ``impl``,
    under device_trace with the run inside an annotate region: (metrics,
    submission, seconds, flash_fwd launches by the counter, flash_fwd
    kernels in the trace, whether the trace names the region)."""
    import glob

    from univtg_tpu_torch.ops import flash_attention as fa
    from univtg_tpu_torch.tools import reproduce_model_md
    from univtg_tpu_torch.utils.profiling import annotate, device_trace

    trace_dir = tempfile.mkdtemp(prefix=f"trace_{impl}_", dir=tmp)
    region = f"reproduce_model_md_{impl}"
    before = fa.launches["flash_fwd"]
    t0 = time.perf_counter()
    with device_trace(trace_dir), annotate(region):
        metrics, sub = reproduce_model_md.main([
            f"model.attention_impl={impl}", "model.compute_dtype=float32",
            "--resume", ckpt, "--eval-path", corpus["val_path"],
            "--v-feat-dirs", *corpus["v_feat_dirs"], "--q-feat-dir", corpus["q_feat_dir"],
            "--out", os.path.join(tmp, f"repro_{impl}.json")])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launches["flash_fwd"] - before
    (trace,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" and "flash_fwd_kernel" in e.get("name", "")
                  for e in events)
    named = any(e.get("name") == region for e in events)
    return metrics, sub, seconds, launches, kernels, named


def _device_nms_agrees(torch, rows):
    """temporal_nms_torch on the card against the host temporal_nms on each
    row's first 10 windows at 0.7 (apply_nms's call), in f64 as the host
    computes: eager, and replayed from one CUDA graph captured on static
    buffers. Returns (rows checked, rows that disagree eager, from the
    graph)."""
    from univtg_tpu_torch.core.nms import temporal_nms, temporal_nms_torch

    def kept(idx, mask, windows):
        return [list(map(float, windows[i])) for i in idx[mask].tolist()]

    n = 10
    sp = torch.zeros(n, 2, dtype=torch.float64, device="cuda")
    sc = torch.zeros(n, dtype=torch.float64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        temporal_nms_torch(sp, sc, 0.7, n)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_idx, g_mask = temporal_nms_torch(sp, sc, 0.7, n)
    bad_eager = bad_graph = 0
    for row in rows:
        windows = row["pred_relevant_windows"][:n]
        want = temporal_nms(windows, nms_thd=0.7, max_after_nms=n)
        w = torch.tensor(windows, dtype=torch.float64, device="cuda")
        idx, mask = temporal_nms_torch(w[:, :2], w[:, 2], 0.7, n)
        bad_eager += kept(idx.cpu(), mask.cpu(), windows) != want
        sp.copy_(w[:, :2])
        sc.copy_(w[:, 2])
        graph.replay()
        bad_graph += kept(g_idx.cpu(), g_mask.cpu(), windows) != want
    return len(rows), bad_eager, bad_graph


def phase_reproduce(torch, np, card, tmp, val_corpus):
    """Phase 7y: the released-run path. tools/reproduce_model_md.main on a
    released run at the flagship's width over the first N_REPRO queries of
    phase 7d's split (``_released_run``), f32, with
    ``model.attention_impl=pallas`` (the path: 4 flash_fwd launches per eval
    batch, by the counter and in a device_trace, whose annotate region must
    appear by name) and with "xla" (none); the submissions agree at
    PIPE_TOL (windows as decoded, near-ties by ``_unambiguous_ranks_agree``)
    and the metrics are equal after the 2 s clip-grid rounding (phase 7b's
    rule: before it, an f32 difference moves a 4-decimal end by 1e-4 s);
    the device NMS equals the host's on every row, eager and from a graph.
    Returns (the path's launches, seconds of the pallas run)."""
    from univtg_tpu_torch.evals.postprocessing import WindowPostProcessor
    from univtg_tpu_torch.interop import load_reference_run
    from univtg_tpu_torch.train.infer_mr import evaluate_submission

    ckpt, corpus = _released_run(torch, tmp, val_corpus)
    cfg, _ = load_reference_run(ckpt)
    if (cfg.vid_dim, cfg.hidden_dim, cfg.num_layers, cfg.num_heads) != (2818, 1024, 4, 8):
        raise AssertionError(f"the released run's opt.json rebuilt {cfg}")
    batches = -(-N_REPRO // 32)
    runs = {}
    for impl in ("pallas", "xla"):
        for attempt in range(2):  # the profiler has dropped a kernel's record once
            if impl == "pallas":
                _reset_launches()  # the released-run path starts here
            runs[impl] = _reproduce(torch, tmp, ckpt, corpus, impl)
            if impl == "pallas":
                path_launches = _launches()  # ... and ends here
            want = 4 * batches if impl == "pallas" else 0
            if runs[impl][4] == want or attempt:
                break
            log(f"[reproduce] the {impl} trace names flash_fwd {runs[impl][4]} times, not "
                f"{want}: traced once more")
        metrics, sub, seconds, launches, traced, named = runs[impl]
        log(f"[reproduce] {impl} f32: {len(sub)} queries in {seconds:.2f} s with the model "
            f"build and the trace; flash_fwd launches {launches}, in the trace {traced}; "
            f"region named {named}; MR-full-mAP {metrics['brief']['MR-full-mAP-key']}, HL "
            f"Hit1 {metrics['brief']['HL-min-VeryGood-Hit1-key']}, after NMS "
            f"{metrics['metrics_nms']['MR-full-mAP-key']}")
        if launches != want or traced != want or not named:
            raise AssertionError(f"reproduce {impl}: flash_fwd {launches} launches, {traced} "
                                 f"in the trace, not {want}; region named {named}")
        if len(sub) != N_REPRO or not all(np.isfinite(v) for v in metrics["brief"].values()):
            raise AssertionError(f"reproduce {impl}: a bad submission or metrics")
    (p_metrics, p_sub, p_s, *_), (x_metrics, x_sub, *_) = runs["pallas"], runs["xla"]
    tol = PIPE_TOL["float32"]
    worst = max(np.abs(np.asarray(g["pred_relevant_windows"])
                       - np.asarray(w["pred_relevant_windows"])).max()
                for g, w in zip(p_sub, x_sub, strict=True))
    post = WindowPostProcessor(clip_length=corpus["clip_len"],
                               process_func_names=("round_multiple",))
    rounded = [evaluate_submission(post([dict(r) for r in s]), _jsonl(corpus["val_path"]))
               for s in (p_sub, x_sub)]
    log(f"[reproduce] pallas vs xla: windows and scores differ by at most {worst:.3g} "
        f"(limits {tol}); metrics equal as the tool scores them (no rounding) "
        f"{p_metrics['brief'] == x_metrics['brief']}, after the 2 s rounding "
        f"{rounded[0]['brief'] == rounded[1]['brief']}")
    if [r["qid"] for r in p_sub] != [r["qid"] for r in x_sub] or not all(
            _unambiguous_ranks_agree(np, {"topk_windows": g["pred_relevant_windows"]},
                                     {"topk_windows": w["pred_relevant_windows"]},
                                     tol["scores"], tol["windows"])
            for g, w in zip(p_sub, x_sub)):
        raise AssertionError("reproduce: the flash submission disagrees with xla's")
    if rounded[0]["brief"] != rounded[1]["brief"]:
        raise AssertionError(f"reproduce: metrics differ: {rounded[0]['brief']} vs "
                             f"{rounded[1]['brief']}")
    n, bad_eager, bad_graph = _device_nms_agrees(torch, p_sub)
    log(f"[reproduce] temporal_nms_torch on the card vs the host's on {n} rows: "
        f"{bad_eager} differ eager, {bad_graph} from the CUDA graph")
    if bad_eager or bad_graph:
        raise AssertionError("reproduce: the device NMS disagrees with the host's")
    return path_launches, p_s


def _ask_server(np, base, queries):
    """One 75-clip video PUT to the server at ``base``, then ``queries``
    concurrent /ground requests; their answers."""
    import io

    rng = np.random.default_rng(6)
    buf = io.BytesIO()
    np.savez(buf, features=rng.standard_normal((75, 2816)).astype(np.float32))
    req = urllib.request.Request(f"{base}/videos/v", data=buf.getvalue(), method="PUT")
    with urllib.request.urlopen(req, timeout=120) as r:
        r.read()
    bodies = [json.dumps({"video": "v", "query_feats": rng.standard_normal(
        (9, 512)).astype(np.float32).tolist()}).encode() for _ in range(queries)]

    def ask(body):
        req = urllib.request.Request(f"{base}/ground", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with concurrent.futures.ThreadPoolExecutor(queries) as pool:
        return list(pool.map(ask, bodies))


def _start_serve(ckpt, tmp, config=None):
    """`cli serve --resume ckpt` (with ``--config``, a ModelConfig JSON, when
    given) started in a subprocess on the card; ``_finish_serve`` asks it."""
    extra = ["--config", config] if config else []
    err_log = open(os.path.join(tmp, "serve.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "univtg_tpu_torch.cli", "serve", "--resume", ckpt,
         "--port", "0", *extra], stdout=subprocess.PIPE, stderr=err_log, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    err_log.close()  # the child holds its own descriptor
    return proc


def _finish_serve(np, proc, queries=1):
    """Once the server that ``_start_serve`` started says where it serves:
    one video, ``queries`` concurrent /ground requests, then SIGTERM; the
    answer, or the list of answers when queries > 1. The process does not
    outlive the call."""
    import select
    import signal

    try:
        ready, _, _ = select.select([proc.stdout], [], [], 300)  # model build
        line = proc.stdout.readline() if ready else ""
        if not line.startswith("serving on http://127.0.0.1:"):
            raise AssertionError(f"cli serve did not start: {line!r}")
        answers = _ask_server(np, f"http://127.0.0.1:{int(line.split(':')[2].split()[0])}",
                              queries)
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=60) != 0:
            raise AssertionError("cli serve did not drain and exit 0 on SIGTERM")
        return answers[0] if queries == 1 else answers
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def _serve_in_process(np, ckpt):
    """What `cli serve --resume ckpt` builds (the flagship's config, the
    file through restore_serving_params, eval_mode "add", a GroundingServer
    on a free port), in this process: one video, one /ground request; the
    answer. Phase 7r runs the entry point itself in a subprocess."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.serve import GroundingPipeline, GroundingServer
    from univtg_tpu_torch.serve.quantize import restore_serving_params

    cfg = cli.flagship_config()
    pipe = GroundingPipeline(cfg, restore_serving_params(ckpt, cfg), eval_mode="add",
                             device="cuda")
    server = GroundingServer(pipe, host="127.0.0.1", port=0).start()
    try:
        return _ask_server(np, f"http://127.0.0.1:{server.port}", 1)[0]
    finally:
        server.close()


def _first_eval_batch(cfg):
    """The first batch of the eval loader that train-mr and infer-mr use."""
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.train.driver_mr import _eval_loader

    batches = iter(_eval_loader(cfg, MRDataset(cfg.eval_data)))
    try:
        return next(batches)
    finally:
        batches.close()


def phase_quantize(torch, np, tmp, corpus, run_dir, f32_brief):
    """The int8 tier's entry points: `cli quantize`, the int8 file served as
    `cli serve` builds it (its pipeline and server, in this process: phase
    7r runs the entry point in a subprocess), and `cli infer-mr` on its
    dequantized weights; none of them launches int8_matmul, as in the JAX
    package. Then the smoke's own call
    of int8_matmul on the file's first video projection over the first eval
    batch, counted apart. Returns (the entry points' launches, the smoke
    call's launches, the served-layer records)."""
    import contextlib
    import io

    import torch.nn.functional as F

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.interop import read_checkpoint
    from univtg_tpu_torch.ops import int8_matmul as im
    from univtg_tpu_torch.serve.quantize import load_quantized, restore_serving_params

    best = os.path.join(run_dir, "model_best.ckpt")
    int8_path = os.path.join(tmp, "model_int8.ckpt")
    _reset_launches()  # the int8 tier's entry points start here
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["quantize", "--preset", "qvhighlights_mr", "--resume", best,
                  "--out", int8_path])
    f32_path = os.path.join(tmp, "model_f32.ckpt")  # the float weights alone
    torch.save({"model": read_checkpoint(best)["model"]}, f32_path)
    sizes = {p: os.path.getsize(p) / 1e6 for p in (int8_path, f32_path, best)}
    ratio = sizes[int8_path] / sizes[f32_path]
    log(f"[quantize] {printed.getvalue().strip()}; float weights {sizes[f32_path]:.1f} MB "
        f"(the training checkpoint with its optimizer state {sizes[best]:.1f} MB): "
        f"{ratio:.3f} of the float weights")
    if not ratio < 0.45:
        raise AssertionError(f"the int8 file is {ratio:.3f} of the float one")

    answer = _serve_in_process(np, int8_path)
    _check_result(np, answer, 75)
    log(f"[quantize] the int8 file served as cli serve builds it (in this process; 7r "
        f"runs cli serve in its own): /ground top-1 window {answer['top1_window']}")

    deq_path = os.path.join(tmp, "model_int8_dequantized.ckpt")
    torch.save({"model": load_quantized(int8_path)}, deq_path)
    int8_brief, _, _, _ = _infer_mr(torch, np, tmp, deq_path, corpus, "int8_f32", "pallas",
                                    "float32")
    launches = _launches()  # ... and end here
    keys = ("MR-full-mAP-key", "MR-full-R1@0.5-key", "MR-full-mIoU-key",
            "HL-min-VeryGood-mAP-key", "HL-min-VeryGood-Hit1-key")
    log(f"[quantize] metrics, f32 weights vs dequantized int8 weights (random "
        f"weights, printed only): {json.dumps({k: [f32_brief[k], int8_brief[k]] for k in keys})}")
    log(f"[quantize] launches of the int8 tier's entry points in this process: {launches}")
    if launches["flash_fwd"] == 0:
        raise AssertionError("infer-mr on the dequantized weights never launched flash_fwd")

    # the smoke's own call: the int8 file's first video projection, laid out
    # as the kernel takes it, over the first eval batch
    name = "input_vid_proj.0.net.1.weight"
    blob = read_checkpoint(int8_path)
    w_q = blob["q"][name].cuda().t().contiguous()  # (N, K) -> (K, N)
    scale = blob["scales"][name].cuda().reshape(-1)  # one per output row
    served = restore_serving_params(int8_path, cli.flagship_config())  # as cli serve loads
    ln = [served[f"input_vid_proj.0.LayerNorm.{p}"].cuda() for p in ("weight", "bias")]
    batch = _first_eval_batch(_eval_cfg(corpus))
    vid = torch.from_numpy(batch["model_inputs"]["src_vid"]).cuda()
    x = F.layer_norm(vid, (vid.shape[-1],), *ln, 1e-5).reshape(-1, vid.shape[-1]).contiguous()
    weight = served[name].cuda()
    _reset_launches()
    got = im.int8_matmul(x, w_q, scale)
    call_launches = _launches()
    as_served = F.linear(x, weight)
    torch.cuda.synchronize()
    err = _errs(got, as_served)
    log(f"[quantize] the smoke's int8_matmul call on {name} over one eval batch "
        f"(M={x.shape[0]}): against F.linear with the weight as served, max abs "
        f"{err[0]:.3g}, rel {err[1]:.3g} (limit {INT8_TOL['float32']['rel']}); launches "
        f"{call_launches}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = im._plan(x.shape[0], w_q.shape[1], x.shape[1], sms, torch.float32).splits > 1
    want = {k: 0 for k in call_launches}
    want.update(int8_matmul=1, int8_matmul_split_sum=int(split))
    if call_launches != want:
        raise AssertionError(f"the int8_matmul call launched {call_launches}, not the "
                             f"product once and {'the split sum once' if split else 'no split sum'}")
    if not _int8_within(err, "float32") or not got.abs().max() > 0:
        raise AssertionError("int8_matmul disagrees with the layer as served")
    # the same layer against its twin and timed, off the call's count
    records = [_int8_record(torch, "served_eval_batch", x.to(dtype), w_q, scale,
                            weight.to(dtype), 50)[0]
               for dtype in (torch.float32, torch.bfloat16)]
    return launches, call_launches, records


def _native_dataset(MRDataset, data_cfg):
    """MRDataset(data_cfg) with its FeatureSources on the native npz reader,
    as UNIVTG_NATIVE_IO=1 selects it."""
    saved = os.environ.get("UNIVTG_NATIVE_IO")
    os.environ["UNIVTG_NATIVE_IO"] = "1"
    try:
        ds = MRDataset(data_cfg)
    finally:
        if saved is None:
            del os.environ["UNIVTG_NATIVE_IO"]
        else:
            os.environ["UNIVTG_NATIVE_IO"] = saved
    if not all(src.native for src in (*ds.v_sources, ds.q_source)):
        raise AssertionError("UNIVTG_NATIVE_IO=1 did not select the native reader")
    return ds


def _feature_err(np, ds, ref, ref_query=None, every=1):
    """Largest |difference| of every ``every``-th video and query feature ds
    reads from ref's (the query's passed through ref_query first, if given),
    and the count of files compared."""
    vids = sorted({m["vid"] for m in ref.data})[::every]
    qids = sorted({m["qid"] for m in ref.data})[::every]
    pairs = [(a, b, vids) for a, b in zip(ds.v_sources, ref.v_sources, strict=True)]
    pairs.append((ds.q_source, ref.q_source, qids))
    err, n = 0.0, 0
    for a, b, ids in pairs:
        for fid in ids:
            x, y = a.get(fid), b.get(fid)
            if b is ref.q_source and ref_query is not None and y is not None:
                y = ref_query(y)
            if x is None or y is None or x.shape != y.shape:
                raise AssertionError(f"feature {fid} read as {x} and {y}")
            err = max(err, float(np.abs(x - y).max()))
            n += 1
    return err, n


def _score(driver_mr, mr_metrics, cfg, sub, eval_ds, ap_fn):
    """driver_mr._finish_eval (the driver's scoring) with the evaluator's
    batched AP run by ap_fn; returns (brief metrics, seconds, the AP array
    of each call)."""
    aps = []

    def run(*args, **kw):
        aps.append(ap_fn(*args, **kw))
        return aps[-1]

    saved = mr_metrics.detection_ap_batch
    mr_metrics.detection_ap_batch = run
    try:
        t0 = time.perf_counter()
        brief = driver_mr._finish_eval(cfg, sub, eval_ds, 0)["brief"]
        return brief, time.perf_counter() - t0, aps
    finally:
        mr_metrics.detection_ap_batch = saved


def _load_ms(driver_mr, cfg, ds, n_batches):
    """ms per batch of the driver's eval loader alone (reading, collating)."""
    t0 = time.perf_counter()
    for _ in driver_mr._eval_loader(cfg, ds):
        pass
    return 1e3 * (time.perf_counter() - t0) / n_batches


def phase_eval_size(torch, np, fa, card, tmp, run_dir, passes=2):
    """Evaluation of model_best.ckpt over a synthetic val split of
    QVHighlights' size (N_VAL_FULL queries, up to 75 clips, 2816-d video,
    512-d text), bf16 on the flash kernels, as train-mr pays it
    every eval_epoch: after one warm pass, the seconds of the driver's
    inference (_run_eval_shard: its eval loader, the eval step, host decode)
    and of its scoring (_finish_eval: the predictions written, the
    evaluator on the native AP kernel), per evaluation and per batch; the
    native APs of the last pass held against the numpy twin's on the same
    submission (AP_TOL), whose scoring is timed too; one inference pass on
    the native npz reader (UNIVTG_NATIVE_IO=1), whose features are held
    against numpy's on every EVAL_SUBSET-th file (FEAT_TOL), with no file
    rejected; the
    loader's own ms per batch on either reader; where h5py is importable,
    `cli pack-h5` of the split and one pass on its h5 cache with lazy
    metadata; then one inference under torch.profiler (the eval_qvhighlights
    cells' [profile] lines). Returns the timings and the split's corpus."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.data.features import l2_normalize
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
    from univtg_tpu_torch.evals import ap, mr_metrics
    from univtg_tpu_torch.native import reader
    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.steps import make_eval_step

    t0 = time.perf_counter()
    corpus = create_synthetic_mr_corpus(os.path.join(tmp, "val_corpus"), n_train=0,
                                        n_val=N_VAL_FULL, v_dim=2816, q_dim=512,
                                        max_clips=75, seed=1)
    log(f"[evalsize] synthetic val split: {N_VAL_FULL} queries, 2816-d video, 512-d "
        f"text, written in {time.perf_counter() - t0:.1f} s")
    best = os.path.join(run_dir, "model_best.ckpt")
    results = os.path.join(tmp, "evalsize")
    os.makedirs(results, exist_ok=True)

    reader.rejections = 0
    data_cfg = _eval_cfg(corpus).eval_data
    eval_ds = MRDataset(data_cfg)
    native_ds = _native_dataset(MRDataset, data_cfg)
    t0 = time.perf_counter()
    feat_err, n_files = _feature_err(np, native_ds, eval_ds, every=EVAL_SUBSET)
    log(f"[evalsize] native npz reader vs np.load + l2_normalize: {n_files} files, "
        f"max |diff| {feat_err:.3g} (limit {FEAT_TOL}), {reader.rejections} rejected "
        f"({time.perf_counter() - t0:.1f} s)")
    if feat_err > FEAT_TOL or reader.rejections:
        raise AssertionError("the native reader disagrees with numpy or rejected a file")
    try:
        import h5py  # noqa: F401
    except ImportError:
        h5_ds = None
        log("[evalsize] h5py is not importable here: the h5 cache path (cli pack-h5, "
            "h5_cache_dir, lazy_metadata) is not run")
    else:
        h5_dir = os.path.join(tmp, "val_h5py")
        t0 = time.perf_counter()
        cli.main(["pack-h5", "--metadata", corpus["val_path"], "--v-feat-dirs",
                  *corpus["v_feat_dirs"], "--q-feat-dir", corpus["q_feat_dir"],
                  "--out-dir", h5_dir])
        t1 = time.perf_counter()
        h5_ds = MRDataset(_eval_cfg(corpus, f"eval_data.h5_cache_dir={h5_dir}",
                                    "eval_data.lazy_metadata=True").eval_data)
        t2 = time.perf_counter()
        # pack-h5 stores every feature L2-normalized, the text's too, which
        # MRDataset normalizes on use (normalize_t)
        h5_err, n_h5 = _feature_err(np, h5_ds, eval_ds, ref_query=l2_normalize)
        log(f"[evalsize] cli pack-h5 {t1 - t0:.1f} s, h5 cache preloaded in {t2 - t1:.1f} "
            f"s; {n_h5} cached features vs npz max |diff| {h5_err:.3g} (limit {FEAT_TOL})")
        if h5_err > FEAT_TOL:
            raise AssertionError("the h5 cache disagrees with the npz files")

    def numpy_ap(gt, pred, score, thds, n_threads=None):
        return ap.detection_ap_batch_numpy(gt, pred, score, thds)

    timings = {}
    for dtype in ("bfloat16",):
        # the host's own measurements (numpy scoring, the native and h5
        # readers, the loader, the profile) read the same files and the same
        # kind of submission whatever the dtype: bf16 takes them all (the
        # f32 pass went to pay for phases 7u-7x)
        full = True
        cfg = _eval_cfg(corpus, "model.attention_impl=pallas",
                        f"model.compute_dtype={dtype}", f"results_dir={results}")
        model = cli.restored_model(cfg, best, "cuda")
        step = make_eval_step(cfg.eval_mode)
        n_batches = len(driver_mr._eval_loader(cfg, eval_ds))
        # no warm pass: the kernels ran at this shape in 7b, and the files
        # were written just before (read from the page cache)
        before = fa.launches["flash_fwd"]
        infer_s, score_s = [], []
        for _ in range(passes):
            t0 = time.perf_counter()
            sub = driver_mr._run_eval_shard(cfg, model, eval_ds, step)  # ends on the host
            infer_s.append(time.perf_counter() - t0)
            brief, dt, native_aps = _score(driver_mr, mr_metrics, cfg, sub, eval_ds,
                                           ap.detection_ap_batch)
            score_s.append(dt)
        launches = fa.launches["flash_fwd"] - before
        if (len(sub) != N_VAL_FULL or launches != 4 * n_batches * passes
                or not all(np.isfinite(v) for v in brief.values())):
            raise AssertionError(f"evaluation of {N_VAL_FULL} queries, {dtype}: "
                                 f"{len(sub)} rows, {launches} flash_fwd launches, {brief}")
        cell = f"eval_qvhighlights_{'bf16' if dtype == 'bfloat16' else 'f32'}"
        timings[cell] = {
            "items": N_VAL_FULL, "batches": n_batches, "passes": passes,
            "s_per_eval": [i + s for i, s in zip(infer_s, score_s)],
            "infer_s": infer_s, "infer_ms_per_batch": [1e3 * t / n_batches for t in infer_s],
            "score_s": score_s, "flash_fwd_launches_per_pass": launches // passes}
        if not full:
            del model
            torch.cuda.empty_cache()
            continue
        numpy_brief, score_numpy_s, numpy_aps = _score(driver_mr, mr_metrics, cfg, sub,
                                                       eval_ds, numpy_ap)
        ap_err = max(float(np.abs(a - b).max()) for a, b in
                     zip(native_aps, numpy_aps, strict=True))
        if (ap_err > AP_TOL or numpy_brief != brief
                or (N_VAL_FULL, 10) not in [a.shape for a in native_aps]):
            raise AssertionError(f"native AP vs numpy, {dtype}: max |diff| {ap_err} "
                                 f"over {[a.shape for a in native_aps]}")
        t0 = time.perf_counter()
        native_sub = driver_mr._run_eval_shard(cfg, model, native_ds, step)
        infer_native_s = time.perf_counter() - t0
        if len(native_sub) != N_VAL_FULL:
            raise AssertionError(f"the native reader's pass scored {len(native_sub)} rows")
        h5 = None
        if h5_ds is not None:
            t0 = time.perf_counter()
            h5_sub = driver_mr._run_eval_shard(cfg, model, h5_ds, step)
            h5 = {"infer_s": time.perf_counter() - t0,
                  "load_ms_per_batch": _load_ms(driver_mr, cfg, h5_ds, n_batches)}
            if len(h5_sub) != N_VAL_FULL:
                raise AssertionError(f"the h5 pass scored {len(h5_sub)} rows")
        # the loader's ms and the profile over every EVAL_SUBSET-th item
        sub_ds, sub_native = (driver_mr._EvalShard(d, 0, EVAL_SUBSET)
                              for d in (eval_ds, native_ds))
        n_sub = len(driver_mr._eval_loader(cfg, sub_ds))
        load_ms = _load_ms(driver_mr, cfg, sub_ds, n_sub)
        load_native_ms = _load_ms(driver_mr, cfg, sub_native, n_sub)
        kernels, wall_us = _profile_window(
            torch, lambda: driver_mr._run_eval_shard(cfg, model, sub_ds, step), 1)
        _profile_record(cell, card, n_sub, "batch", kernels, wall_us, ["flash_fwd"],
                        items=len(sub_ds), B=cfg.eval_bsz, L="75+32")
        timings[cell].update({
            "load_ms_per_batch": load_ms,
            "score_numpy_s": score_numpy_s, "ap_max_abs_err": ap_err,
            "infer_native_reader_s": infer_native_s,
            "load_native_reader_ms_per_batch": load_native_ms,
            "s_per_eval_all_native": infer_native_s + score_s[-1],
            "s_per_eval_all_numpy": infer_s[-1] + score_numpy_s, "h5": h5})
        del model
        torch.cuda.empty_cache()
    if reader.rejections:
        raise AssertionError(f"the native reader rejected {reader.rejections} files")
    log(f"[evalsize] ({card}) {json.dumps(timings)}")
    return timings, corpus


def _long_batch(torch, np, B=8, Lv=2048, Lt=32, d_vid=2818, d_txt=512, seed=5):
    """One random B x (Lv clips + Lt tokens) batch on the card, with the
    dense targets the losses read."""
    rng = np.random.default_rng(seed)
    ts = ((np.arange(Lv, dtype=np.float32) + 1.0) / Lv)[None, :, None].repeat(2, -1)
    ts = np.broadcast_to(ts, (B, Lv, 2)).copy()
    window = np.zeros((B, Lv), np.float32)
    starts = rng.integers(0, Lv - 64, B)
    for b, s0 in enumerate(starts):
        window[b, s0: s0 + 48] = 1
    mi = {"src_txt": rng.standard_normal((B, Lt, d_txt)).astype(np.float32),
          "src_txt_mask": np.ones((B, Lt), np.float32),
          "src_vid": rng.standard_normal((B, Lv, d_vid)).astype(np.float32),
          "src_vid_mask": np.ones((B, Lv), np.float32)}
    tg = {"timestamp": ts, "timestamp_mask": np.ones((B, Lv), np.float32),
          "timestamp_window": window,
          "span_labels_nn": np.stack([ts[..., 0] - 0.01, ts[..., 1] + 0.01], -1),
          "saliency_scores": window * 3.0,
          "saliency_pos_labels": (starts + 10)[:, None].astype(np.int32)}
    to = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()  # noqa: E731
                    for k, v in d.items()}
    return to(mi), to(tg)


def _long_step(torch, fa, sd, batch, impl, dname):
    """5 make_train_steps (2 warm, 3 timed) on the long batch with the
    flagship at max_v_l 2048, dropouts at their defaults: (the last state,
    {ms per step by CUDA events, peak GiB, last loss, flash launches})."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    mi, tg = batch
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    cfg = flagship_model(attention_impl=impl, compute_dtype=dname, max_v_l=2048)
    model = UniVTG(cfg, device="meta")
    model.load_state_dict({k: v.cuda() for k, v in sd.items()}, assign=True)
    holder = {"state": TrainState(model, make_optimizer(
        model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 100), 1e-4, 0.1))}

    def one():
        holder["state"], holder["m"] = step(holder["state"], mi, tg, 0)

    before = dict(fa.launches)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(one, iters=3, warmup=2)
    return holder["state"], {
        "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "loss": float(holder["m"]["loss_overall"]),
        "launches": {n: fa.launches[n] - before[n] for n in before}}


def phase_long_train(torch, np, fa, sd, card):
    """make_train_step at B=8, 2048 clips + 32 tokens, dropouts at their
    defaults, bf16 and then f32: CUDA-event ms per step, peak memory and
    flash launches (20 of each kernel over 5 "pallas" steps), "pallas" vs
    "xla". Returns the bf16 "pallas" state, the batch and the bf16 stats by
    impl (phase 9b prints its ring beside them)."""
    batch = _long_batch(torch, np)
    kept, stats = None, {}
    for dname in ("bfloat16", "float32"):
        stats[dname] = {}
        for impl in ("pallas", "xla"):
            state, rec = _long_step(torch, fa, sd, batch, impl, dname)
            stats[dname][impl] = rec
            log(f"[long] {dname} B=8 L=2048+32 {impl}: {rec['ms']:.2f} ms per train step "
                f"({card}), loss {rec['loss']:.4f}, launches over 5 steps "
                f"{rec['launches']}, peak memory {rec['peak_gib']:.1f} GiB")
            if not np.isfinite(rec["loss"]):
                raise AssertionError(f"long-video {dname} {impl} step is not finite")
            if impl == "pallas" and rec["launches"] != {n: 20 for n in rec["launches"]}:
                raise AssertionError(f"long-video {dname} pallas step launches: "
                                     f"{rec['launches']}")
            if impl == "pallas" and dname == "bfloat16":
                kept = state
            del state
            torch.cuda.empty_cache()
    log(f"[long] ({card}) {json.dumps(stats)}")
    return kept, batch, stats["bfloat16"]


def phase_train_profile(torch, np, fa, card, corpus, sd, long_state, long_batch):
    """Per training cell, after two warm steps, three more under
    torch.profiler: host ms per step, device-busy ms, idle share, the flash
    kernels' share of busy time and the top kernels.

    train_qvhighlights_bf16: the driver's step (run_train_epoch: batch cast
    and copy in the prefetch thread, then make_train_step), B=32, 75 clips
    + 32 tokens, dropouts at their defaults. train_long_video_bf16:
    make_train_step on a device-resident B=8, 2048 + 32 batch."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.epoch_runner import run_train_epoch
    from univtg_tpu_torch.train.steps import make_train_step

    batches = _train_batches(np, corpus, 3)
    cfg = flagship_model(attention_impl="pallas", compute_dtype="bfloat16")
    state, _ = _run_steps(torch, cfg, sd, batches[:2])  # the two warm steps
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    holder = {"state": state}

    def driver_epoch():
        holder["state"], _ = run_train_epoch(batches, step, holder["state"], 0, "cuda",
                                             prefetch_depth=2)

    names = list(FLASH_KERNELS)
    kernels, wall_us = _profile_window(torch, driver_epoch, 1)
    _profile_record("train_qvhighlights_bf16", card, len(batches), "step", kernels,
                    wall_us, names, B=32, L="75+32")

    mi, tg = long_batch
    holder = {"state": long_state}

    def long_step():
        holder["state"], _ = step(holder["state"], mi, tg, 0)

    for _ in range(2):
        long_step()
    kernels, wall_us = _profile_window(torch, long_step, 3)
    _profile_record("train_long_video_bf16", card, 3, "step", kernels, wall_us, names,
                    B=8, L="2048+32")


def phase_ring_serving(torch, np, card):
    """The ring serving path: GroundingPipeline with attention_impl="ring_pallas"
    inside use_ring(RingGroup(RING_P)), bf16 on one 2048-clip video x 8
    queries (long_video_bf16) and f32 on two 75-clip videos; each dispatch
    makes exactly 4 layers x (P^2 + P) ring launches and no "xla" dispatch.
    Held against the same pipelines with "xla" at PIPE_TOL, after two
    profiled bf16 dispatches (off the path's count). Returns the path's
    launches."""
    from univtg_tpu_torch.cli import flagship_config
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.ops import attention as attn
    from univtg_tpu_torch.parallel import RingGroup, use_ring
    from univtg_tpu_torch.serve import GroundingPipeline

    sd = UniVTG(flagship_config(), device="cpu", seed=0).state_dict()  # phase 4's

    def pipe(impl, dtype):
        return GroundingPipeline(flagship_config(compute_dtype=dtype, attention_impl=impl),
                                 sd, eval_mode="add", device="cuda")

    def prepare(p, items):
        """Each video prepared once, as a server holds it: the queries on one
        video share it, which is the pipeline's single-video fast path."""
        once = {}
        for v, _ in items:
            if id(v) not in once:
                once[id(v)] = p.prepare_video(v)
        return [(once[id(v)], q) for v, q in items]

    rng = np.random.default_rng(9)
    d_vid, d_txt = 2816, 512
    long_vid = rng.standard_normal((2048, d_vid)).astype(np.float32)
    vids = [rng.standard_normal((75, d_vid)).astype(np.float32) for _ in range(2)]
    queries = [rng.standard_normal((int(rng.integers(4, 33)), d_txt)).astype(np.float32)
               for _ in range(10)]
    cells = {  # name -> (dtype, [(video, query)], clips)
        "bf16 B=8 L=2048+32": ("bfloat16", [(long_vid, q) for q in queries[:8]], 2048),
        "f32 B=2 L=128+32": ("float32", list(zip(vids, queries[8:])), 75),
    }
    layers, per = 4, RING_P * RING_P + RING_P
    ring = RingGroup(RING_P)
    ring_pipes = {name: pipe("ring_pallas", dt) for name, (dt, _, _) in cells.items()}
    results, prepared = {}, {}
    _reset_launches()  # the ring serving path starts here
    with use_ring(ring):
        for name, (dtype, items, _) in cells.items():
            p = ring_pipes[name]
            prepared[name] = prepare(p, items)
            for i in range(3):  # the first dispatch also warms the allocator
                before, d_before = _launches(), dict(attn.dispatches)
                t = time.perf_counter()
                results[name] = p.ground_prepared_many(prepared[name], top_k=10)
                ms = (time.perf_counter() - t) * 1e3
                got = {n: _launches()[n] - before[n] for n in ("ring_block", "ring_finish")}
                ran = {n: attn.dispatches[n] - d_before[n] for n in attn.dispatches}
                log(f"[ring serving] {name} ring_pallas P={RING_P} dispatch {i}: {ms:.2f} ms "
                    f"host clock ({card}), launches {got}, dispatches {ran}")
                if got != {"ring_block": layers * RING_P * RING_P,
                           "ring_finish": layers * RING_P} or ran["ring_pallas"] != layers \
                        or sum(ran.values()) != layers:
                    raise AssertionError(f"{name}: {got} ring launches and dispatches {ran}, "
                                         f"expected {layers} x ({per}) and no fallback")
    launches = _launches()  # ... and ends here
    # where the time of a ring dispatch goes, as phase 6 reads the flash one
    name = "bf16 B=8 L=2048+32"
    with use_ring(ring):
        kernels, wall_us = _profile_window(
            torch, lambda: ring_pipes[name].ground_prepared_many(prepared[name]), 2)
    _profile_record("ring_long_video_bf16", card, 2, "dispatch", kernels, wall_us,
                    ["ring_block", "ring_finish"], label="ring", B=8, P=RING_P)
    del ring_pipes
    for name, (dtype, items, clips) in cells.items():
        p = pipe("xla", dtype)
        want = p.ground_prepared_many(prepare(p, items), top_k=10)
        tol = PIPE_TOL[dtype]
        for got, ref in zip(results[name], want, strict=True):
            _check_result(np, got, clips)
            sal = float(np.abs(np.asarray(got["saliency"]) - ref["saliency"]).max())
            g, w = np.asarray(got["topk_windows"]), np.asarray(ref["topk_windows"])
            log(f"[ring serving] {name} ring_pallas vs xla: saliency {sal:.3g}, ranked "
                f"scores {np.abs(g[:, 2] - w[:, 2]).max():.3g}, window ends "
                f"{np.abs(g[:, :2] - w[:, :2]).max():.3g} s, ties included (limits {tol})")
            if sal > tol["saliency"] or not _unambiguous_ranks_agree(
                    np, got, ref, tol["scores"], tol["windows"]):
                raise AssertionError(f"{name}: the ring pipeline disagrees with xla")
        del p
        torch.cuda.empty_cache()
    return launches


def phase_ring_train(torch, np, sd, card, long_stats):
    """The ring training path: make_train_step on the long batch (8 x 2048
    clips + 32 tokens) with attention_impl="ring_pallas" inside
    use_ring(RingGroup(RING_P)), dropouts at the flagship's settings
    (attention 0): 3 f32 steps (4 x (P^2 + P) ring launches per forward, no
    "xla" dispatch) held against 3 f32 "xla" steps at TRAIN_TOL; then bf16 ms
    per step and peak memory beside phase 8's "pallas" and "xla". Returns the
    path's launches."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.ops import attention as attn
    from univtg_tpu_torch.parallel import RingGroup, use_ring
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    mi, tg = _long_batch(torch, np)
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    ring = RingGroup(RING_P)

    def state(impl, dtype):
        model = UniVTG(flagship_model(attention_impl=impl, compute_dtype=dtype,
                                      max_v_l=2048), device="meta")
        model.load_state_dict({k: v.cuda() for k, v in sd.items()}, assign=True)
        return TrainState(model, make_optimizer(
            model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 100), 1e-4, 0.1))

    def run(impl, n):
        st, history = state(impl, "float32"), []
        for _ in range(n):
            st, m = step(st, mi, tg, 0)
            history.append({k: float(v) for k, v in m.items()})
        return history

    _reset_launches()  # the ring training path starts here
    with use_ring(ring):
        got = run("ring_pallas", 3)
    torch.cuda.synchronize()
    launches = _launches()  # ... and ends here
    ran = dict(attn.dispatches)
    want_launches = {"ring_block": 3 * 4 * RING_P * RING_P, "ring_finish": 3 * 4 * RING_P}
    log(f"[ring train] 3 f32 steps, ring_pallas P={RING_P}: launches {launches}, "
        f"dispatches {ran}")
    if {n: launches[n] for n in want_launches} != want_launches or ran["xla"] \
            or ran["ring_pallas"] != 12 or any(launches[n] for n in FLASH_KERNELS):
        raise AssertionError(f"ring training: launches {launches} and dispatches {ran}, "
                             f"expected {want_launches}, 12 ring_pallas and no fallback")
    want = run("xla", 3)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        rel = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w}
        log(f"[ring train] f32 step {i}: ring_pallas loss {g['loss_overall']:.6f} grad norm "
            f"{g['grad_norm']:.6f}; xla {w['loss_overall']:.6f} {w['grad_norm']:.6f}; rel err "
            f"loss {rel['loss_overall']:.2e} grad norm {rel['grad_norm']:.2e} "
            f"(limits {TRAIN_TOL})")
        if not np.isfinite(g["loss_overall"]) or rel["loss_overall"] > TRAIN_TOL["loss"] \
                or rel["grad_norm"] > TRAIN_TOL["grad_norm"]:
            raise AssertionError(f"f32 ring_pallas train step {i} disagrees with xla: {rel}")

    holder = {"state": state("ring_pallas", "bfloat16")}

    def one():
        holder["state"], holder["m"] = step(holder["state"], mi, tg, 0)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with use_ring(ring):
        ms = cuda_ms(one, iters=3, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(holder["m"]["loss_overall"])
    stats = {**long_stats, "ring_pallas": {"ms": ms, "peak_gib": peak}}
    log(f"[ring train] bf16 B=8 L=2048+32 train step ({card}): "
        + ", ".join(f"{k} {v['ms']:.2f} ms, peak {v['peak_gib']:.1f} GiB"
                    for k, v in stats.items())
        + f"; ring_pallas loss {loss:.4f}. One card holds every rank, so the ring's "
        f"memory is still O(L^2) in total: the saving exists only across cards")
    if not np.isfinite(loss):
        raise AssertionError("the bf16 ring train step is not finite")
    return launches


def _scan_state(torch, cfg, sd, schedule=None):
    """A TrainState of a fresh model (cfg) holding state_dict sd on the card,
    AdamW on phase 7's schedule (or the one given)."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer

    model = UniVTG(cfg, device="meta")
    model.load_state_dict({k: v.cuda() for k, v in sd.items()}, assign=True)
    return TrainState(model, make_optimizer(
        model.parameters(), schedule or build_schedule(1e-4, 10, 200, 0.1, 3), 1e-4, 0.1))


def _count_replays(torch):
    """Wraps CUDAGraph.replay to count its calls; returns (counts, undo)."""
    graph_cls, orig = torch.cuda.CUDAGraph, torch.cuda.CUDAGraph.replay
    counts = {"replay": 0}

    def replay(self):
        counts["replay"] += 1
        return orig(self)

    graph_cls.replay = replay
    return counts, lambda: setattr(graph_cls, "replay", orig)


def _flash_counts(n):
    return {k: sum(c for name, c in n.items() if f"{k}_kernel" in name)
            for k in FLASH_KERNELS}


def _profile_counts(torch, fn, want=None):
    """fn() once under torch.profiler after a synchronize: (kernel device
    us by name, launches by name, wall us). With ``want`` ({flash kernel:
    launches fn makes}), a trace that names the flash kernels otherwise is
    logged and fn profiled once more: torch.profiler has left a kernel's
    record out of a trace (11 of 12 flash_fwd in one QFVS step whose
    launch counter read 12). The caller still holds the trace it gets to
    ``want``."""
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(1 if want is None else 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        us, n = defaultdict(float), Counter()
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA and not getattr(
                    evt, "is_user_annotation", False):
                us[evt.name] += evt.time_range.elapsed_us()
                n[evt.name] += 1
        if want is None or _flash_counts(n) == want:
            break
        log(f"[profile] the trace names the flash kernels {_flash_counts(n)}, not "
            f"{want}: profiled once more")
    return us, n, wall_us


def phase_scan_train(torch, np, tmp, corpus):
    """7e(i), the scan training main path: `cli train-mr` on phase 7's
    corpus with scan_steps=2, "pallas", bf16, SCAN_EPOCHS epochs (no
    evaluation): 4 launches of each flash kernel per step, replays
    included, and at least two groups replayed from a graph. Returns the
    launches."""
    from univtg_tpu_torch import cli

    run_dir = os.path.join(tmp, "scan_run")
    argv = ["train-mr", "--preset", "qvhighlights_mr",
            f"train_data.data_path={corpus['train_path']}",
            f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
            f"train_data.q_feat_dir={corpus['q_feat_dir']}", "train_data.v_feat_dim=2816",
            "eval_data=None", f"n_epoch={SCAN_EPOCHS}", "bsz=32", "scan_steps=2",
            "model.attention_impl=pallas", "model.compute_dtype=bfloat16",
            f"results_dir={run_dir}"]
    replays, undo = _count_replays(torch)
    _reset_launches()  # the scan training main path starts here
    t0 = time.perf_counter()
    try:
        cli.main(argv)
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = _launches()  # ... and ends here
    lines = _jsonl(os.path.join(run_dir, "train_log.jsonl"))
    steps = sum(line["steps"] for line in lines)
    log(f"[scan] cli train-mr scan_steps=2: {steps} steps in {len(lines)} epochs, "
        f"{replays['replay']} graph replays, {wall:.2f} s with model build; losses "
        f"{[round(line['loss_overall'], 4) for line in lines]}; launches {launches}")
    if steps != 3 * SCAN_EPOCHS or not all(np.isfinite(x["loss_overall"]) for x in lines):
        raise AssertionError(f"scan train-mr did not take 3 finite steps an epoch: {lines}")
    if replays["replay"] < 2:
        raise AssertionError(f"fewer than two groups replayed from a graph: {replays}")
    want = {name: 4 * steps for name in FLASH_KERNELS}
    if {k: launches[k] for k in FLASH_KERNELS} != want:
        raise AssertionError(f"expected 4 launches of each kernel per step: {launches}")
    return launches


def _scan_groups(batches, K, n):
    """n groups of K batches, taken from the batches in turn (3 batches:
    the groups repeat every 3)."""
    return [[batches[(g * K + i) % len(batches)] for i in range(K)] for g in range(n)]


def _time_scan(torch, cfg, sd, batches, K, timed_steps=SCAN_TIMED_STEPS):
    """ms per step of K = 1 (the eager make_train_step) or of
    make_scan_train_step at K, each call's inputs cast (K = 1), or stacked
    (K > 1), and pinned ahead, as the driver's prefetch thread hands them
    over; over ``timed_steps`` steps after the warm-up (two steps, or two
    groups: eager, then captured): wall and CUDA-event ms, peak GiB, and
    one call for the profiler."""
    from univtg_tpu_torch.data.prefetch import to_pinned
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.steps import (
        make_scan_train_step,
        make_train_step,
        stack_batches,
    )

    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = _scan_state(torch, cfg, sd)
    n = timed_steps // K
    # the groups repeat with the period of the batches: pin each once
    groups = _scan_groups(batches, K, len(batches))
    if K == 1:
        step = make_train_step(weights)
        ready = [tuple(to_pinned(t, "cuda") for t in strip_meta(g[0])) for g in groups]

        def call(i):
            mi, tg = ({k: v.to("cuda", non_blocking=True) for k, v in t.items()}
                      for t in ready[i % len(ready)])
            step(state, mi, tg, 0)
    else:
        step = make_scan_train_step(weights)
        ready = [tuple(to_pinned(t, "cuda") for t in stack_batches(g)) for g in groups]

        def call(i):
            step(state, *ready[i % len(ready)], 0)

    for i in range(2):
        call(i)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for i in range(2, n + 2):
        call(i)
    stop.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (n * K)
    return {"wall_ms": wall, "cuda_ms": start.elapsed_time(stop) / (n * K),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "steps": n * K}, (lambda: call(0))


def _compare_runs(torch, got, want, a, b):
    """Per-step loss equality, max |diff| and rel of losses and grad norms,
    max |diff| of params, and whether each is bit-equal, between two runs
    (metrics with a leading K axis, or per step) and their states."""
    def flat(ms):
        return {k: torch.cat([m[k].reshape(-1) for m in ms]) for k in ("loss_overall",
                                                                        "grad_norm")}

    g, w = flat(got), flat(want)
    diff = {"steps_equal": (g["loss_overall"] == w["loss_overall"]).tolist()}
    for key in g:
        d = (g[key] - w[key]).abs()
        diff[key] = d.max().item()
        diff[f"{key}_rel"] = (d / w[key].abs().clamp_min(1e-12)).max().item()
        diff[f"{key}_equal"] = torch.equal(g[key], w[key])
    pa, pb = list(a.model.parameters()), list(b.model.parameters())
    diff["params"] = max((p - q).abs().max().item() for p, q in zip(pa, pb))
    diff["params_equal"] = all(torch.equal(p, q) for p, q in zip(pa, pb))
    diff["equal"] = all(diff[f"{k}_equal"] for k in ("loss_overall", "grad_norm", "params"))
    return diff


def _replay_vs_eager(torch, cfg, sd, batches):
    """Dropouts 0: three groups of K = 2 (eager, captured, replayed) from
    one state against six single steps from another, both from sd, and
    those six against six more from a third (is the eager step itself
    deterministic?): _compare_runs of each pair."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.steps import (
        make_scan_train_step,
        make_train_step,
        stack_batches,
    )

    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    a, b, c = (_scan_state(torch, cfg, sd) for _ in range(3))
    scan, single = make_scan_train_step(weights), make_train_step(weights)
    got, want, again = [], [], []
    for group in _scan_groups(batches, 2, 3):
        got.append(scan(a, *stack_batches(group), 0)[1])
        for batch in group:
            mi, tg = (to_device(t, "cuda") for t in strip_meta(batch))
            want.append(single(b, mi, tg, 0)[1])
            again.append(single(c, mi, tg, 0)[1])
    return _compare_runs(torch, got, want, a, b), _compare_runs(torch, again, want, c, b)


def _hold_replay(torch, label, cfg, sd, batches):
    """_replay_vs_eager of cfg (dropouts 0) held by 7e's rule: the replay
    equals the eager step bit for bit, unless the eager step does not equal
    itself: then within phase 7's limits, and again with cuDNN held to its
    deterministic algorithms, bit for bit. Returns the last diff."""
    dname = cfg.compute_dtype
    diff, repeat = _replay_vs_eager(torch, cfg, sd, batches)
    log(f"[{label}] {dname} dropouts 0, 3 groups of 2 (eager, captured, replayed) vs 6 "
        f"eager single steps: {'bit-equal' if diff['equal'] else 'NOT bit-equal'} "
        f"{diff}; the eager steps run twice: "
        f"{'bit-equal' if repeat['equal'] else 'NOT bit-equal'} {repeat}")
    if not diff["equal"] and (repeat["equal"]
                              or diff["loss_overall_rel"] > TRAIN_TOL["loss"]
                              or diff["grad_norm_rel"] > TRAIN_TOL["grad_norm"]):
        raise AssertionError(f"{label} {dname} graph replay disagrees with eager steps: "
                             f"{diff}")
    if not diff["equal"]:
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            diff, repeat = _replay_vs_eager(torch, cfg, sd, batches)
        finally:
            torch.backends.cudnn.deterministic = was
        log(f"[{label}] {dname} again with torch.backends.cudnn.deterministic: replay vs "
            f"eager {'bit-equal' if diff['equal'] else 'NOT bit-equal'} {diff}; eager "
            f"twice {'bit-equal' if repeat['equal'] else 'NOT bit-equal'}")
        if repeat["equal"] and not diff["equal"]:
            raise AssertionError(f"{label} {dname} graph replay disagrees with "
                                 f"deterministic eager steps: {diff}")
    return diff


def _keep_rate(torch, fa, seeds, B, L, H, dh, rate):
    """The flash_fwd kernel's keep share at the step's shape for each
    recorded dropout seed: q = k = 0 (every probability 1/L) and V = one-hot
    per key (L <= dh), so out[b, i, h*dh + j] > 0 exactly where key j is
    kept for (b, h, i). Returns (kept, elements)."""
    D = H * dh
    q = torch.zeros(B, L, D, device="cuda")
    eye = torch.zeros(L, dh, device="cuda")
    eye[torch.arange(L), torch.arange(L)] = 1.0
    v = eye.repeat(1, H)[None].expand(B, L, D).contiguous()
    mask = torch.ones(B, L, device="cuda")
    kept = 0
    for seed in seeds:
        out = fa.flash_attention(q, q, v, mask, num_heads=H, dropout_rate=rate,
                                 dropout_seed=seed)
        kept += (out.reshape(B, L, H, dh)[..., :L] > 0).sum().item()
    return kept, len(seeds) * B * H * L * L


def phase_scan(torch, np, fa, card, corpus, sd):
    """7e(ii)-(iv): make_scan_train_step at B=32, 75 + 32 tokens, "pallas",
    dropouts at the preset's defaults, bf16 and f32, K in SCAN_KS (1: the
    eager single step): ms per step (wall and CUDA events) and peak memory,
    and one group under torch.profiler (host ms, busy ms, idle share, each
    flash kernel named 4 K times in the trace); at dropouts 0, replays
    against eager single steps; at attention dropout 0.1 and rate 0, fresh
    losses per replay and the kernels' keep rate over one step."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.ops import attention as attn
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.steps import make_scan_train_step, stack_batches

    batches = _train_batches(np, corpus, 3)
    stats = {}
    for dname in ("bfloat16", "float32"):
        cfg = flagship_model(attention_impl="pallas", compute_dtype=dname)
        stats[dname] = {}
        for K in SCAN_KS:
            rec, one_call = _time_scan(torch, cfg, sd, batches, K)
            us, n, wall_us = _profile_counts(torch, one_call,
                                             {k: 4 * K for k in FLASH_KERNELS})
            busy = sum(us.values())
            named = _flash_counts(n)
            rec.update(profiled_host_ms=wall_us / 1e3, profiled_busy_ms=busy / 1e3,
                       idle_share=1.0 - busy / wall_us if busy else None,
                       trace_launches=named)
            stats[dname][K] = rec
            log(f"[scan] {dname} K={K}: {rec['wall_ms']:.2f} ms per step wall, "
                f"{rec['cuda_ms']:.2f} by CUDA events over {rec['steps']} steps, peak "
                f"{rec['peak_gib']:.2f} GiB ({card}); one {'step' if K == 1 else 'group'} "
                f"profiled: host {wall_us / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms, idle "
                f"{rec['idle_share']}; flash kernels in the trace {named}")
            if named != {k: 4 * K for k in FLASH_KERNELS}:
                raise AssertionError(f"the trace of one K={K} call names the flash kernels "
                                     f"{named}, not 4 K = {4 * K} times each")
            torch.cuda.empty_cache()
    log(f"[scan] ({card}) {json.dumps(stats)}")

    quiet = dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    for dname in ("float32", "bfloat16"):
        _hold_replay(torch, "scan", flagship_model(
            attention_impl="pallas", compute_dtype=dname, **quiet), sd, batches)
        torch.cuda.empty_cache()

    # attention dropout 0.1 at rate 0: the losses move only with the masks
    rate = 0.1
    cfg = flagship_model(attention_impl="pallas", compute_dtype="bfloat16",
                         dropout=rate, droppath=0.0, input_dropout=0.0)
    state = _scan_state(torch, cfg, sd, schedule=lambda count: 0.0)
    scan = make_scan_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    stacked = stack_batches([batches[0], batches[0]])
    seeds, orig = [], attn.flash_attention

    def recording(q, k, v, mask, **kw):
        if not torch.cuda.is_current_stream_capturing():
            seeds.append(kw["dropout_seed"].clone())
        return orig(q, k, v, mask, **kw)

    attn.flash_attention = recording
    try:
        losses = [scan(state, *stacked, 0)[1]["loss_overall"].tolist() for _ in range(3)]
    finally:
        attn.flash_attention = orig
    before = dict(fa.launches)
    kept, total = _keep_rate(torch, fa, seeds[:4], 32, 75 + 32, 8, 128, rate)
    for k in before:  # the check's own launches are not the main path's
        fa.launches[k] = before[k]
    share, sigma = kept / total, (rate * (1 - rate) / total) ** 0.5
    log(f"[scan] attention dropout {rate}, rate 0, one batch twice a group: losses "
        f"{losses} (eager, captured, replayed); the kernels' keep share over one step's "
        f"4 calls {share:.6f} of {total} ({(share - (1 - rate)) / sigma:+.2f} sigma)")
    if losses[1] == losses[2] or losses[1][0] == losses[1][1]:
        raise AssertionError("graph replays did not draw fresh attention-dropout masks")
    if len(seeds) < 4 or abs(share - (1 - rate)) > KEEP_SIGMAS * sigma:
        raise AssertionError(f"keep share {share} is not within {KEEP_SIGMAS} sigma of "
                             f"{1 - rate}")
    return stats


def _hl_corpus(tmp):
    """A TVSum-shaped corpus at full width: HL_DOMAINS domains named as the
    first of configs/hl_splits/tvsum.json, HL_TRAIN + HL_VAL videos each,
    2816-d video (+2 TEF), 512-d text, 20 annotators, 256-512 clips.
    Returns (corpus, splits path, domains)."""
    from univtg_tpu_torch.data.hl import load_hl_splits
    from univtg_tpu_torch.data.synthetic import create_synthetic_hl_corpus

    n_train, n_val = HL_DOMAINS * HL_TRAIN, HL_DOMAINS * HL_VAL
    corpus = create_synthetic_hl_corpus(os.path.join(tmp, "hl"), "tvsum", n_train=n_train,
                                        n_val=n_val, v_dim=2816, q_dim=512,
                                        max_clips=512, seed=0)
    domains = list(load_hl_splits("tvsum"))[:HL_DOMAINS]
    splits = {d: {"train": [f"hlv_{i * HL_TRAIN + j}" for j in range(HL_TRAIN)],
                  "val": [f"hlv_{n_train + i * HL_VAL + j}" for j in range(HL_VAL)]}
              for i, d in enumerate(domains)}
    path = os.path.join(tmp, "hl", "tvsum_two_domains.json")
    with open(path, "w") as f:
        json.dump(splits, f)
    return corpus, path, domains


def _hl_overrides(corpus, splits_path):
    return [f"data.anno_path={corpus['anno_path']}", f"data.splits_path={splits_path}",
            f"data.v_feat_dirs={tuple(corpus['v_feat_dirs'])}",
            f"data.q_feat_dir={corpus['q_feat_dir']}"]


def _infer_hl(torch, run_dir, overrides, impl):
    """`cli infer-hl` on run_dir: (printed mAPs, flash_fwd launches)."""
    import contextlib
    import io

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.ops import flash_attention as fa

    before = fa.launches["flash_fwd"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["infer-hl", "--preset", "tvsum_hl", "--ckpt-dir", run_dir, *overrides,
                  f"model.attention_impl={impl}"])
    torch.cuda.synchronize()
    return json.loads(printed.getvalue()), fa.launches["flash_fwd"] - before


def _time_step(torch, fn, iters=5, want=None):
    """fn() timed by CUDA events over iters calls after 2 warm ones, then
    once under torch.profiler (``want`` as _profile_counts takes it): {ms,
    profiled host ms, busy ms, idle share, flash ms, flash share, flash
    launches in the trace, peak GiB allocated from the first call on}."""
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(fn, iters=iters, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    us, n, wall_us = _profile_counts(torch, fn, want)
    busy = sum(us.values())
    flash = sum(t for name, t in us.items()
                if any(f"{k}_kernel" in name for k in FLASH_KERNELS))
    return {"ms": ms, "profiled_host_ms": wall_us / 1e3, "profiled_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if busy else None,
            "flash_kernels_ms": flash / 1e3,
            "flash_share_of_busy": flash / busy if busy else None,
            "trace_launches": _flash_counts(n), "peak_gib": peak}


def phase_hl(torch, np, fa, card, tmp):
    """7f, the highlight-detection paths: `cli train-hl --preset tvsum_hl`
    at full width, f32 (the preset's dtype), "pallas", HL_EPOCHS epochs
    evaluated each epoch (4 launches of each flash kernel per step, 4
    flash_fwd per eval batch; best_tvsum_metrics.json with both domains and
    AVG); `cli infer-hl` on its checkpoints, "pallas" (4 flash_fwd per
    batch) and "xla": mAP equal, fused scores within HL_SCORE_TOL; then
    make_train_step ms per HL step (CUDA events) and one profiled step
    (host, device-busy and flash kernel ms), "pallas" vs "xla", f32 and
    bf16. Returns (training launches, inference launches, step ms)."""
    import contextlib
    import dataclasses
    import io

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.data.hl import HLDataset, collate_hl
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.presets import PRESETS
    from univtg_tpu_torch.train import checkpoint as ckpt
    from univtg_tpu_torch.train.driver_hl import domain_scores
    from univtg_tpu_torch.train.steps import make_train_step

    t0 = time.perf_counter()
    corpus, splits_path, domains = _hl_corpus(tmp)
    overrides = _hl_overrides(corpus, splits_path)
    log(f"[hl] synthetic TVSum-shaped corpus: domains {domains}, {HL_TRAIN} train + "
        f"{HL_VAL} val videos each, 2816-d video, 512-d text, 256-512 clips "
        f"({time.perf_counter() - t0:.1f} s)")
    run_dir = os.path.join(tmp, "hl_run")
    printed = io.StringIO()
    _reset_launches()  # the HL training main path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli.main(["train-hl", "--preset", "tvsum_hl", *overrides,
                  "model.attention_impl=pallas", f"n_epoch={HL_EPOCHS}", "eval_epoch=1",
                  f"results_dir={run_dir}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = _launches()  # ... and ends here
    scores = json.loads(printed.getvalue())
    with open(os.path.join(run_dir, "best_tvsum_metrics.json")) as f:
        written = json.load(f)
    steps = HL_DOMAINS * HL_EPOCHS * (-(-HL_TRAIN // 4))
    eval_batches = HL_DOMAINS * HL_EPOCHS * (-(-HL_VAL // 4))
    want = {name: 4 * steps for name in FLASH_KERNELS}
    want["flash_fwd"] += 4 * eval_batches
    log(f"[hl] cli train-hl: {steps} steps and {eval_batches} eval batches over "
        f"{HL_DOMAINS} domains in {wall:.2f} s with model builds ({card}); best mAP "
        f"{scores}; launches {train_launches}")
    if written != scores or set(scores) != {*domains, "AVG"}:
        raise AssertionError(f"best_tvsum_metrics.json {written} vs printed {scores}")
    if {k: train_launches[k] for k in FLASH_KERNELS} != want:
        raise AssertionError(f"expected 4 launches of each kernel per HL step and 4 "
                             f"flash_fwd per eval batch: {train_launches}, not {want}")

    _reset_launches()  # the HL inference main path starts here
    inferred, fwd = _infer_hl(torch, run_dir, overrides, "pallas")
    infer_launches = _launches()  # ... and ends here
    plain, _ = _infer_hl(torch, run_dir, overrides, "xla")
    log(f"[hl] cli infer-hl: pallas {inferred} ({fwd} flash_fwd launches), xla {plain}")
    if inferred != scores or plain != inferred or fwd != 4 * HL_DOMAINS * (-(-HL_VAL // 4)):
        raise AssertionError("infer-hl disagrees with train-hl, across impls or in launches")

    base = PRESETS["tvsum_hl"]()
    cfg = cli.apply_overrides(base, overrides)
    worst = 0.0
    for domain in domains:
        ds = HLDataset(dataclasses.replace(cfg.data, domain=domain))
        fused = {}
        for impl in ("pallas", "xla"):
            model_cfg = dataclasses.replace(cfg.model, attention_impl=impl)
            model = UniVTG(model_cfg, device="cuda")
            path = os.path.join(run_dir, f"model_{domain}_best.ckpt")
            model.load_state_dict(ckpt.restore_params(path, model.state_dict()))
            fused[impl] = domain_scores(dataclasses.replace(cfg, model=model_cfg), model,
                                        ds)[0]
        worst = max(worst, max(float(np.abs(a - b).max())
                               for a, b in zip(fused["pallas"], fused["xla"], strict=True)))
    log(f"[hl] f32 fused scores, pallas vs xla: max |diff| {worst:.3g} (limit "
        f"{HL_SCORE_TOL})")
    if not worst <= HL_SCORE_TOL:
        raise AssertionError(f"HL fused scores disagree across impls: {worst}")

    ds = HLDataset(dataclasses.replace(cfg.data, domain=domains[0]))
    batch = collate_hl([ds[i] for i in range(4)], cfg.data.max_q_l, cfg.data.max_v_l)
    mi = to_device({k: torch.from_numpy(v) for k, v in batch["model_inputs"].items()}, "cuda")
    tg = to_device({k: torch.from_numpy(v) for k, v in batch["targets"].items()}, "cuda")
    sd = UniVTG(cfg.model, device="cpu", seed=0).state_dict()
    step = make_train_step(cfg.weights, tuple(cfg.losses))
    step_ms = {}
    for dname in ("float32", "bfloat16"):
        for impl in ("pallas", "xla"):
            state = _scan_state(torch, dataclasses.replace(
                cfg.model, attention_impl=impl, compute_dtype=dname), sd)
            holder = {}

            def one():
                holder["m"] = step(state, mi, tg, 0)[1]

            step_ms[f"{dname}_{impl}"] = _time_step(torch, one, iters=10)
            if not np.isfinite(float(holder["m"]["loss_overall"])):
                raise AssertionError(f"HL {dname} {impl} step is not finite")
            del state
            torch.cuda.empty_cache()
    log(f"[hl] make_train_step per HL step (B=4, 512 + 32; ms by CUDA events over 10 "
        f"steps, then one step under torch.profiler: host, device-busy and flash "
        f"kernel ms; {card}): {json.dumps(step_ms)}")
    return train_launches, infer_launches, step_ms


def _has_h5py() -> bool:
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def _qfvs_tree(np, tmp):
    """The UT-Egocentric-shaped tree at full width, its grids held in
    memory: (corpus, {h5 path: (features, seg_len)}). The smoke needs no
    h5py: write_video_grid, the generator's one h5 write, keeps the grids
    instead; tags, oracle summaries, query.pkl and Tags.mat go to disk."""
    from univtg_tpu_torch.data import synthetic

    grids = {}

    def keep(path, features, seg_len):
        grids[path] = (features, np.asarray(seg_len, np.int64))

    write = synthetic.write_video_grid
    synthetic.write_video_grid = keep
    try:
        corpus = synthetic.create_synthetic_qfvs_corpus(
            os.path.join(tmp, "qfvs"), videos=tuple(range(1, QFVS_VIDEOS + 1)),
            max_segment_num=20, max_frame_num=200, v_dim=512, q_dim=512, seed=0)
    finally:
        synthetic.write_video_grid = write
    return corpus, grids


def _qfvs_cli(torch, cmd, *args):
    """`cli train-qfvs` / `infer-qfvs` in-process on the qfvs preset, its
    options before its key=value pairs: (printed results, seconds)."""
    import contextlib
    import io

    from univtg_tpu_torch import cli

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli.main([cmd, "--preset", "qfvs", *args])
    torch.cuda.synchronize()
    return json.loads(printed.getvalue()), time.perf_counter() - t0


def _qfvs_tops_agree(np, a, b, k, tol):
    """The top-k shots of scores a and b are the same set, but for shots
    whose b score lies within tol of b's k-th score (near-ties may swap)."""
    ta = set(np.argsort(-a, kind="stable")[:k].tolist())
    tb = set(np.argsort(-b, kind="stable")[:k].tolist())
    kth = np.sort(b)[::-1][k - 1]
    return all(abs(b[i] - kth) <= tol for i in ta ^ tb)


def phase_qfvs(torch, np, card, tmp):
    """7g, the QFVS paths: `cli train-qfvs --preset qfvs` at full width, f32
    (the preset's dtype), "pallas", QFVS_SPLITS splits x QFVS_EPOCHS epochs
    evaluated each epoch (12 launches of each flash kernel per step: three
    forwards of 4 layers into one backward; 4 flash_fwd per eval forward;
    qfvs_metrics.json with each split's F/R/P and AVG_F); `cli infer-qfvs`
    on its checkpoints, "pallas" and "xla": F/R/P equal to training's best
    and to each other, per-shot scores within QFVS_SCORE_TOL; then
    make_qfvs_train_step ms per step (CUDA events) and one profiled step,
    "pallas" vs "xla", f32 and bf16. Returns (training launches, inference
    launches, step stats)."""
    from univtg_tpu_torch.data import qfvs as qfvs_data

    t0 = time.perf_counter()
    corpus, grids = _qfvs_tree(np, tmp)
    read = qfvs_data.load_video_grid
    qfvs_data.load_video_grid = lambda cfg, vid: grids[qfvs_data._h5_path(cfg, vid)]
    seg = [int(g[1].sum()) for g in grids.values()]
    log(f"[qfvs] synthetic UT-Egocentric-shaped tree: {QFVS_VIDEOS} videos of 20 x 200 "
        f"frames of 512-d features ({seg} valid shots), concepts {corpus['concepts']} of "
        f"3 tokens ({time.perf_counter() - t0:.1f} s); data/qfvs.load_video_grid, the "
        f"port's one grid read (h5, and h5py importable here: {_has_h5py()}), is replaced "
        f"by a read of the grids kept in memory; every other file of the tree is on disk")
    try:
        return _qfvs_paths(torch, np, card, tmp, corpus)
    finally:
        qfvs_data.load_video_grid = read


def _qfvs_paths(torch, np, card, tmp, corpus):
    """phase_qfvs's runs, with the grids read from memory."""
    import dataclasses

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.data import qfvs as qfvs_data
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import compact_to_grid
    from univtg_tpu_torch.presets import PRESETS
    from univtg_tpu_torch.train import checkpoint as ckpt
    from univtg_tpu_torch.train.driver_qfvs import (
        _test_videos,
        make_qfvs_train_step,
        split_scores,
    )

    base = PRESETS["qfvs"]()
    splits = tuple(base.splits[:QFVS_SPLITS])
    run_dir = os.path.join(tmp, "qfvs_run")
    overrides = [f"data.root={corpus['root']}", f"tags_mat_path={corpus['tags_mat_path']}",
                 f"splits={splits}"]
    _reset_launches()  # the QFVS training main path starts here
    scores, wall = _qfvs_cli(torch, "train-qfvs", *overrides, "model.attention_impl=pallas",
                             f"n_epoch={QFVS_EPOCHS}", f"results_dir={run_dir}")
    train_launches = _launches()  # ... and ends here
    cfg = cli.apply_overrides(base, overrides)
    tests = [f"V{v}" for v in _test_videos(cfg)]
    with open(os.path.join(run_dir, "qfvs_metrics.json")) as f:
        written = json.load(f)
    items = len(qfvs_data.QFVSDataset(dataclasses.replace(
        cfg.data, train_videos=tuple(splits[0]))))
    steps = QFVS_SPLITS * QFVS_EPOCHS * items
    oracles = len(qfvs_data.QFVSDataset(dataclasses.replace(cfg.data, train_videos=(1,))))
    eval_fwds = QFVS_SPLITS * QFVS_EPOCHS * oracles
    want = {name: 12 * steps for name in FLASH_KERNELS}
    want["flash_fwd"] += 4 * eval_fwds
    log(f"[qfvs] cli train-qfvs: {steps} steps ({items} items a split) and {eval_fwds} "
        f"eval forwards over {QFVS_SPLITS} splits in {wall:.2f} s with model builds "
        f"({card}); best {scores}; launches {train_launches}")
    if written != scores or set(scores) != {*tests, "AVG_F"} or any(
            set(scores[t]) != {"F", "R", "P"} for t in tests):
        raise AssertionError(f"qfvs_metrics.json {written} vs printed {scores}")
    if {k: train_launches[k] for k in FLASH_KERNELS} != want:
        raise AssertionError(f"expected 12 launches of each kernel per QFVS step and 4 "
                             f"flash_fwd per eval forward: {train_launches}, not {want}")

    ckpt_dir = ["--ckpt-dir", run_dir]
    _reset_launches()  # the QFVS inference main path starts here
    inferred, _ = _qfvs_cli(torch, "infer-qfvs", *ckpt_dir, *overrides,
                            "model.attention_impl=pallas")
    infer_launches = _launches()  # ... and ends here
    plain, _ = _qfvs_cli(torch, "infer-qfvs", *ckpt_dir, *overrides,
                         "model.attention_impl=xla")
    log(f"[qfvs] cli infer-qfvs: pallas {inferred} ({infer_launches['flash_fwd']} "
        f"flash_fwd launches), xla {plain}")
    if inferred != scores or infer_launches["flash_fwd"] != 4 * QFVS_SPLITS * oracles:
        raise AssertionError("infer-qfvs disagrees with train-qfvs or in launches")

    worst, swapped = 0.0, 0
    for t in tests:
        video = int(t[1:])
        by_impl = {}
        for impl in ("pallas", "xla"):
            mcfg = dataclasses.replace(cfg.model, attention_impl=impl)
            model = UniVTG(mcfg, device="cuda")
            model.load_state_dict(ckpt.restore_params(
                os.path.join(run_dir, f"model_{t}_best.ckpt"), model.state_dict()))
            by_impl[impl] = split_scores(dataclasses.replace(cfg, model=mcfg), model, video)
        tags = len(corpus["videos_tag"][video - 1])
        for (_, a), (_, b) in zip(by_impl["pallas"], by_impl["xla"], strict=True):
            worst = max(worst, float(np.abs(a - b).max()))
            a, b = a[:tags], b[:tags]
            k = max(int(len(b) * cfg.data.top_percent), 1)
            if not _qfvs_tops_agree(np, a, b, k, QFVS_SCORE_TOL):
                raise AssertionError(f"{t}: pallas and xla pick other top-{k} shots")
            top_a = set(np.argsort(-a, kind="stable")[:k].tolist())
            swapped += len(top_a ^ set(np.argsort(-b, kind="stable")[:k].tolist()))
    log(f"[qfvs] f32 per-shot scores, pallas vs xla: max |diff| {worst:.3g} (limit "
        f"{QFVS_SCORE_TOL}); top-2% shots swapped at near-ties: {swapped}")
    if not worst <= QFVS_SCORE_TOL:
        raise AssertionError(f"QFVS scores disagree across impls: {worst}")
    if plain != inferred and not swapped:
        raise AssertionError(f"infer-qfvs F/R/P differ across impls: {plain} vs {inferred}")

    ds = qfvs_data.QFVSDataset(dataclasses.replace(cfg.data, train_videos=(splits[0][0],)))
    item = ds[0]
    in1, in2, ino, mask_flat = qfvs_data.prepare_qfvs_batch(item, cfg.max_q_l)
    n = int(item["seg_len"].sum())
    gts = [compact_to_grid(item[k][:n], item["seg_len"], 20, 200)
           for k in ("concept1_GT", "concept2_GT", "oracle_summary")]

    def dev(x):
        if isinstance(x, dict):
            return {k: torch.from_numpy(v).cuda() for k, v in x.items()}
        return torch.from_numpy(x).cuda()

    args = [dev(x) for x in (in1, in2, ino, *gts, mask_flat)]
    sd = UniVTG(cfg.model, device="cpu", seed=0).state_dict()
    step = make_qfvs_train_step(cfg.weights)
    step_ms = {}
    for dname in ("float32", "bfloat16"):
        for impl in ("pallas", "xla"):
            state = _scan_state(torch, dataclasses.replace(
                cfg.model, attention_impl=impl, compute_dtype=dname), sd)
            holder = {}

            def one():
                holder["m"] = step(state, *args, 0)[1]

            full = {k: 12 for k in FLASH_KERNELS} if impl == "pallas" else None
            rec = _time_step(torch, one, want=full)
            step_ms[f"{dname}_{impl}"] = rec
            if not np.isfinite(float(holder["m"]["loss_overall"])):
                raise AssertionError(f"QFVS {dname} {impl} step is not finite")
            if full is not None and rec["trace_launches"] != full:
                raise AssertionError(f"one QFVS step's trace: {rec['trace_launches']}")
            del state
            torch.cuda.empty_cache()
    log(f"[qfvs] make_qfvs_train_step per step (3 forwards at 20 x (200 + 3, 3, 6) into "
        f"one backward; ms by CUDA events over 5 steps, then one step under "
        f"torch.profiler; {card}): {json.dumps(step_ms)}")
    return train_launches, infer_launches, step_ms


def _vlp_corpora(tmp):
    """Three MR corpora at full width, one per supervision type, and the
    64-query val split of the curve corpus (QVHighlights-shaped): the
    VLPCorpusSpec tuple and the val corpus."""
    from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
    from univtg_tpu_torch.data.vlp import VLPCorpusSpec

    specs, val = [], None
    for i, (kind, dset) in enumerate((("point", "ego4d"), ("interval", "videocc"),
                                      ("curve", "videocc"))):
        c = create_synthetic_mr_corpus(os.path.join(tmp, f"vlp_{kind}"),
                                       n_train=VLP_PER_TYPE,
                                       n_val=VLP_VAL if kind == "curve" else 1,
                                       v_dim=2816, q_dim=512, max_clips=75, seed=20 + i)
        specs.append(VLPCorpusSpec(data_path=c["train_path"], dset_name=dset,
                                   v_feat_dirs=tuple(c["v_feat_dirs"]),
                                   q_feat_dir=c["q_feat_dir"], type=kind))
        val = c
    return tuple(specs), val


def phase_vlp(torch, np, card, tmp):
    """7h, one-process VLP: train_vlp on the vlp_pretrain preset (bsz 64)
    over three full-width corpora (point, interval, curve), called
    directly (the CLI's key=value overrides cannot build a tuple of
    VLPCorpusSpec), "pallas", f32 (the preset's dtype), VLP_EPOCHS epochs
    with a zero-shot evaluation each (4 launches of each flash kernel per
    step, 4 flash_fwd per eval batch; brief metrics with MR-full-mAP-key);
    then 3 gated f32 steps at dropouts 0 (the third on an all-curve batch),
    "pallas" against "xla" at TRAIN_TOL; the step's ms at B = 64, f32 and
    bf16. Returns (training launches, step stats)."""
    import dataclasses

    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.data.vlp import VLPDataset
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.presets import PRESETS
    from univtg_tpu_torch.train.driver_vlp import train_vlp
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.steps import make_train_step

    t0 = time.perf_counter()
    specs, val = _vlp_corpora(tmp)
    log(f"[vlp] synthetic corpora: point, interval, curve x {VLP_PER_TYPE} items, "
        f"2816-d video, 512-d text, 37-75 clips; {VLP_VAL} val queries "
        f"({time.perf_counter() - t0:.1f} s)")
    run_dir = os.path.join(tmp, "vlp_run")
    cfg = PRESETS["vlp_pretrain"](**{
        "vlp_data.corpora": specs, "eval_data.data_path": val["val_path"],
        "eval_data.v_feat_dirs": tuple(val["v_feat_dirs"]),
        "eval_data.q_feat_dir": val["q_feat_dir"], "model.attention_impl": "pallas",
        "n_epoch": VLP_EPOCHS, "eval_epoch": 1, "results_dir": run_dir})
    _reset_launches()  # the VLP training main path starts here
    t0 = time.perf_counter()
    metrics, best = train_vlp(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = _launches()  # ... and ends here
    steps = VLP_EPOCHS * (3 * VLP_PER_TYPE // cfg.bsz)
    eval_batches = VLP_EPOCHS * (-(-VLP_VAL // cfg.eval_bsz))
    want = {name: 4 * steps for name in FLASH_KERNELS}
    want["flash_fwd"] += 4 * eval_batches
    brief = metrics.get("brief", {})
    log(f"[vlp] train_vlp: {steps} steps of {cfg.bsz} and {eval_batches} eval batches in "
        f"{wall:.2f} s with the model build ({card}); best brief {json.dumps(brief)}; "
        f"launches {train_launches}")
    if "MR-full-mAP-key" not in brief or not os.path.exists(best):
        raise AssertionError(f"train_vlp gave no zero-shot MR-full-mAP-key: {brief}")
    if {k: train_launches[k] for k in FLASH_KERNELS} != want:
        raise AssertionError(f"expected 4 launches of each kernel per VLP step and 4 "
                             f"flash_fwd per eval batch: {train_launches}, not {want}")
    with open(os.path.join(run_dir, "opt.json")) as f:
        if json.load(f)["use_gates"] is not True:
            raise AssertionError("train_vlp's opt.json does not say use_gates")

    ds = VLPDataset(cfg.vlp_data)
    curve = np.flatnonzero(ds.part_ids == 2)
    order = np.random.default_rng(0).permutation(len(ds))
    picks = [order[:64], order[64:128], curve[:64]]
    batches = [collate_mr([ds[int(i)] for i in idx], cfg.model.max_q_l, cfg.model.max_v_l)
               for idx in picks]
    gated = [(to_device(mi, "cuda"), to_device(tg, "cuda"))
             for mi, tg in (strip_meta(b) for b in batches)]
    quiet = dataclasses.replace(cfg.model, dropout=0.0, droppath=0.0, input_dropout=0.0)
    sd = UniVTG(quiet, device="cpu", seed=0).state_dict()
    step = make_train_step(cfg.weights, tuple(cfg.losses), use_gates=True)
    runs = {}
    for impl in ("pallas", "xla"):
        state = _scan_state(torch, dataclasses.replace(quiet, attention_impl=impl), sd)
        runs[impl] = [{k: float(v) for k, v in step(state, mi, tg, 0)[1].items()}
                      for mi, tg in gated]
        del state
    for i, (a, b) in enumerate(zip(runs["pallas"], runs["xla"], strict=True)):
        lrel = abs(a["loss_overall"] - b["loss_overall"]) / abs(b["loss_overall"])
        grel = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
        log(f"[vlp] gated f32 step {i}{' (all curve)' if i == 2 else ''}: loss "
            f"{a['loss_overall']:.7g} vs xla {b['loss_overall']:.7g} (rel {lrel:.3g}), "
            f"grad norm {a['grad_norm']:.7g} vs {b['grad_norm']:.7g} (rel {grel:.3g}); "
            f"span losses {a['loss_b']:.4g}, {a['loss_g']:.4g}")
        if not (lrel <= TRAIN_TOL["loss"] and grel <= TRAIN_TOL["grad_norm"]
                and all(np.isfinite(v) for v in a.values())):
            raise AssertionError(f"gated VLP step {i}: pallas {a} vs xla {b}")
    if runs["pallas"][2]["loss_b"] != 0.0 or runs["pallas"][2]["loss_g"] != 0.0:
        raise AssertionError("the all-curve batch's span losses are not gated to 0")

    mi, tg = gated[0]
    sd = UniVTG(cfg.model, device="cpu", seed=0).state_dict()
    step_ms = {}
    for dname in ("float32", "bfloat16"):
        for impl in ("pallas", "xla"):
            state = _scan_state(torch, dataclasses.replace(
                cfg.model, attention_impl=impl, compute_dtype=dname), sd)
            holder = {}

            def one():
                holder["m"] = step(state, mi, tg, 0)[1]

            rec = _time_step(torch, one, iters=10)
            step_ms[f"{dname}_{impl}"] = rec
            if not np.isfinite(float(holder["m"]["loss_overall"])):
                raise AssertionError(f"VLP {dname} {impl} step is not finite")
            del state
            torch.cuda.empty_cache()
    log(f"[vlp] make_train_step per gated step (B = 64, 75 + 32; ms by CUDA events over "
        f"10 steps, then one step under torch.profiler; {card}): {json.dumps(step_ms)}")
    return train_launches, step_ms, specs, val


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_cfg(job, results_dir):
    """The vlp_pretrain run of a phase-7k gang (job: the corpora, the mode
    and its knobs), dropouts 0, "pallas", f32."""
    from univtg_tpu_torch.data.vlp import VLPCorpusSpec
    from univtg_tpu_torch.presets import PRESETS

    val = job["val"]
    kw = {"vlp_data.corpora": tuple(VLPCorpusSpec(**c) for c in job["specs"]),
          "eval_data.data_path": val["val_path"],
          "eval_data.v_feat_dirs": tuple(val["v_feat_dirs"]),
          "eval_data.q_feat_dir": val["q_feat_dir"], "model.attention_impl": "pallas",
          "model.dropout": 0.0, "model.droppath": 0.0, "model.input_dropout": 0.0,
          "results_dir": results_dir, **job["overrides"]}
    if job.get("no_eval"):
        kw["eval_data"] = None
    return PRESETS["vlp_pretrain"](**kw)


def _timed_collectives(torch, dist):
    """Wrap the gang's collectives with host timers (after a synchronize,
    so the queued step is not counted); returns (seconds by name, undo)."""
    spent = {}
    orig = {name: getattr(dist, name) for name in ("gather_batch", "all_reduce_grads",
                                                   "check_same")}

    def wrap(name, fn):
        def timed_fn(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed_fn

    for name, fn in orig.items():
        setattr(dist, name, wrap(name, fn))
    return spent, lambda: [setattr(dist, n, f) for n, f in orig.items()]


def _gang_step_stats(torch, np, cfg, batches, seed, use_gates=True):
    """The global-batch step of this rank at cfg's width on its own
    ``batches``: ms per step by CUDA events over DIST_TIMED_STEPS steps,
    the host seconds inside the collectives per step, and one profiled
    step (busy ms, idle share, NCCL kernels' ms, flash kernels' ms)."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train.steps import make_train_step

    sd = UniVTG(cfg.model, device="cpu", seed=cfg.seed).state_dict()
    state = _scan_state(torch, cfg.model, sd)
    step = make_train_step(cfg.weights, tuple(cfg.losses), use_gates=use_gates)
    it = iter(range(10 ** 6))

    def one():
        mi, tg = batches[next(it) % len(batches)]
        step(state, mi, tg, seed)

    ms = cuda_ms(one, iters=DIST_TIMED_STEPS)
    spent, undo = _timed_collectives(torch, dist)
    try:
        for _ in range(DIST_TIMED_STEPS):
            one()
    finally:
        undo()
    us, _, wall_us = _profile_counts(torch, one)
    busy = sum(us.values())
    return {"ms": ms,
            "collective_host_ms": {k: v * 1e3 / DIST_TIMED_STEPS for k, v in spent.items()},
            "profiled_host_ms": wall_us / 1e3, "profiled_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if busy else None,
            "nccl_ms": sum(t for k, t in us.items() if "nccl" in k.lower()) / 1e3,
            "memcpy_ms": sum(t for k, t in us.items() if "memcpy" in k.lower()) / 1e3,
            "flash_kernels_ms": sum(t for k, t in us.items() if any(
                f"{f}_kernel" in k for f in FLASH_KERNELS)) / 1e3}


def _rank_batches(torch, cfg, n):
    """The first n batches of this rank's shard of the VLP data, on its card."""
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.loader import Loader
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.data.vlp import VLPDataset
    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train.epoch_runner import strip_meta

    loader = Loader(VLPDataset(cfg.vlp_data), cfg.bsz, lambda items, pad_batch_to: collate_mr(
        items, cfg.vlp_data.max_q_l, cfg.vlp_data.max_v_l, pad_batch_to), shuffle=True,
        seed=cfg.seed, num_threads=4, shard_index=dist.rank(), num_shards=dist.world())
    out = []
    for batch in loader:
        out.append(tuple(to_device(t, "cuda") for t in strip_meta(batch)))
        if len(out) == n:
            break
    return out


def dist_worker(job_path, rank, world, port) -> int:
    """One rank of a phase-7k gang (``chip_smoke.py --dist-worker``): joins
    the gang on this host's card (two ranks, one card: gloo, by the
    backend rule), runs train_vlp on the job's config with the launch
    counters at 0 just before and read just after, and writes its launches,
    its parameters' digest, and in the job's "main" mode its step timings,
    to ``r{rank}.json`` in the job's results directory."""
    import numpy as np
    import torch

    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train.driver_vlp import init_distributed

    with open(job_path) as f:
        job = json.load(f)
    if job.get("start_after"):  # started early: reach the card, then wait for the file
        torch.zeros(1, device="cuda")
        while not os.path.exists(job["start_after"]):
            time.sleep(0.1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    assert init_distributed(f"127.0.0.1:{port}", world, rank) == (rank, world)
    base = job["results"]
    if job["mode"] == "mesh":
        out = mesh_worker(job, rank, world, torch, np)
        with open(os.path.join(base, f"r{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.shutdown()
        return 0
    out = _vlp_rank(job, rank, torch, np)
    with open(os.path.join(base, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()
    return 0


def _vlp_rank(job, rank, torch, np):
    """One rank of a gang's train_vlp on ``job``'s config (_dist_cfg; its
    logs in job["results"]/p{rank}), with the launch counters at 0 just
    before and read just after: its backend, device, seconds, launches and
    parameters' digest, and in the job's "main" mode its step timings."""
    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.driver_vlp import train_vlp

    gang = dist.active()
    base = job["results"]
    cfg = _dist_cfg(job, os.path.join(base, f"p{rank}"))
    built = []
    build_model = driver_mr.build_model
    driver_mr.build_model = lambda *a, **k: built.append(build_model(*a, **k)) or built[-1]
    resume, resume_all = None, False
    if job["mode"] == "resume":  # every rank restarts from rank 0's latest checkpoint
        resume, resume_all = os.path.join(base, "p0", "model_latest.ckpt"), True
    try:
        _reset_launches()  # this rank's share of the main path starts here
        t0 = time.perf_counter()
        train_vlp(cfg, resume=resume, resume_all=resume_all)
        torch.cuda.synchronize()
        out = {"rank": rank, "backend": gang.backend, "device": str(gang.device),
               "train_vlp_s": time.perf_counter() - t0, "launches": _launches(),
               "digest": dist.tensor_digest(built[0].state_dict().values())}
    finally:
        driver_mr.build_model = build_model
    if job["mode"] == "main":
        out["step"] = _gang_step_stats(torch, np, cfg, _rank_batches(torch, cfg, 2),
                                       cfg.seed + 1)
    return out


def _gang(job, base, world=2, job_dir=None):
    """Start a gang of ``world`` dist_worker processes for ``job``, its
    results in ``base`` and its job file in ``job_dir`` (default ``base``)."""
    os.makedirs(base, exist_ok=True)
    job = {**job, "results": base}
    os.makedirs(job_dir or base, exist_ok=True)
    path = os.path.join(job_dir or base, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", path, str(r),
         str(world), str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _kill_gang(procs):
    """Kill whatever of ``procs`` still runs, and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _wait_gang(procs, rcs=None, timeout=DIST_GANG_TIMEOUT_S):
    """Each rank's output, after its exit code was checked (0 unless
    ``rcs`` names another, None: any); every rank is killed on the way
    out, so no process outlives the phase."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        _kill_gang(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        want = 0 if rcs is None else rcs[r]
        if want is not None and p.returncode != want:
            raise AssertionError(f"gang rank {r} exited {p.returncode}, not {want}:\n"
                                 f"{out[-4000:]}")
    return outs


def _train_log(run_dir):
    return _jsonl(os.path.join(run_dir, "train_log.jsonl"))


def _nccl_of_one(torch, np, card, job, tmp):
    """7k(i): a NCCL gang of one on the card. train_vlp one epoch with the
    group, then without: the logged losses, grad norms and the final
    parameters bit-equal; scan_steps=2 under the group (the all-gather and
    all-reduce captured in the graph) bit-equal to its eager steps; the
    step's ms with and without the group. cuDNN held deterministic."""
    import dataclasses

    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.vlp import VLPDataset
    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train.driver_vlp import train_vlp

    out = {}
    gang = dist.init_gang(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        if gang.backend != "nccl":
            raise AssertionError(f"a gang of one on a card chose {gang.backend}, not nccl")
        cfg = _dist_cfg({**job, "no_eval": True, "overrides": {"n_epoch": 1}},
                        os.path.join(tmp, "nccl1_group"))
        _reset_launches()  # the NCCL-of-one training path starts here
        train_vlp(cfg)
        torch.cuda.synchronize()
        out["launches"] = _launches()  # ... and ends here
        ds = VLPDataset(cfg.vlp_data)
        order = np.random.default_rng(1).permutation(len(ds))
        batches = [collate_mr([ds[int(i)] for i in order[k * 32:(k + 1) * 32]],
                              cfg.model.max_q_l, cfg.model.max_v_l) for k in range(6)]
        sd = {k: v for k, v in torch.load(os.path.join(cfg.results_dir, "model_best.ckpt"),
                                          map_location="cpu", weights_only=True)["model"]
              .items()}
        scan_vs_eager, eager_vs_eager = _replay_vs_eager(torch, cfg.model, sd, batches)
        out["scan_vs_eager"], out["eager_vs_eager"] = scan_vs_eager, eager_vs_eager
        gated = _rank_batches(torch, cfg, 2)
        out["step_group"] = _gang_step_stats(torch, np, cfg, gated, cfg.seed + 1)
    finally:
        dist.shutdown()
    alone = dataclasses.replace(cfg, results_dir=os.path.join(tmp, "nccl1_alone"))
    train_vlp(alone)
    out["step_alone"] = _gang_step_stats(torch, np, cfg, gated, cfg.seed + 1)
    a, b = _train_log(cfg.results_dir), _train_log(alone.results_dir)
    keys = [k for k in b[0] if k.startswith("loss_") or k == "grad_norm"]
    out["log_equal"] = all(x[k] == y[k] for x, y in zip(a, b, strict=True) for k in keys)
    sa, sb = (torch.load(os.path.join(d, "model_best.ckpt"), map_location="cpu",
                         weights_only=True)["model"] for d in (cfg.results_dir,
                                                               alone.results_dir))
    out["params_equal"] = all(torch.equal(sa[k], sb[k]) for k in sb)
    log(f"[dist] (i) NCCL gang of one ({card}): train_vlp log equal to the run without a "
        f"group {out['log_equal']}, final params equal {out['params_equal']}; scan_steps=2 "
        f"with the collectives captured vs eager {json.dumps(scan_vs_eager)}; eager vs "
        f"eager {json.dumps(eager_vs_eager)}; launches {out['launches']}")
    log(f"[dist] (i) gated f32 step at B = 64 with the NCCL group of one "
        f"{json.dumps(out['step_group'])}; without {json.dumps(out['step_alone'])}")
    if not (out["log_equal"] and out["params_equal"] and scan_vs_eager["equal"]):
        raise AssertionError("the NCCL gang of one did not give the no-group run's bits")
    if any(out["launches"][k] == 0 for k in FLASH_KERNELS):
        raise AssertionError(f"train_vlp under the NCCL group skipped a kernel: "
                             f"{out['launches']}")
    return out


def _one_process_curve(torch, np, cfg):
    """The one-process global-batch run the gang must equal: per epoch, the
    two shards' batches of cfg.bsz concatenated into one batch of 2 x bsz,
    make_train_step (gated) from the same init; per-epoch means of the
    losses and the grad norm."""
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.loader import Loader
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.data.vlp import VLPDataset
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import make_train_step

    ds = VLPDataset(cfg.vlp_data)
    loaders = [Loader(ds, cfg.bsz, lambda items, pad_batch_to: collate_mr(
        items, cfg.vlp_data.max_q_l, cfg.vlp_data.max_v_l, pad_batch_to), shuffle=True,
        seed=cfg.seed, num_threads=4, shard_index=s, num_shards=2) for s in range(2)]
    sd = UniVTG(cfg.model, device="cpu", seed=cfg.seed).state_dict()
    state = _scan_state(torch, cfg.model, sd, build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, len(loaders[0])))
    step = make_train_step(cfg.weights, tuple(cfg.losses), use_gates=True)
    curve = []
    for epoch in range(cfg.n_epoch):
        per = []
        for ld in loaders:
            ld.set_epoch(epoch)
        for b0, b1 in zip(*loaders):
            mi, tg = ({k: np.concatenate([b0[part][k], b1[part][k]]) for k in b0[part]}
                      for part in ("model_inputs", "targets"))
            mi, tg = strip_meta({"model_inputs": mi, "targets": tg})
            per.append({k: float(v) for k, v in step(state, to_device(mi, "cuda"),
                                                      to_device(tg, "cuda"),
                                                      cfg.seed + 1)[1].items()})
        curve.append({k: float(np.mean([p[k] for p in per])) for k in per[0]})
    return curve, dist_digest(state)


def dist_digest(state):
    from univtg_tpu_torch.parallel import dist

    return dist.tensor_digest(state.model.state_dict().values())


def _vlp_gang_case(job, base):
    """7k(ii) as a case of 7u's gang: train_vlp at B = 64 per rank,
    DIST_EPOCHS epochs each evaluated by sharded_eval, then the step timings
    (mode "main"), its logs under ``base``."""
    return {"kind": "vlp", "name": "vlp_main", "job": {
        **job, "mode": "main", "results": base,
        "overrides": {"n_epoch": DIST_EPOCHS, "eval_epoch": 1, "sharded_eval": True}}}


def phase_dist_gang(torch, np, card, tmp, tp_gang):
    """7k(ii), the "vlp_main" case of 7u's gang (``tp_gang``): two ranks
    sharing the card over gloo, train_vlp on vlp_pretrain at full width, B =
    64 per rank, "pallas", f32, dropouts 0, DIST_EPOCHS epochs, each
    evaluated by sharded_eval; the loss curve held against one process on
    the assembled B = 128 batches at TRAIN_TOL, the ranks' parameter digests
    equal, the sharded evaluation equal to a full one of rank 0's latest
    checkpoint; each rank's step ms, collective ms and idle share. Returns
    (the launches summed over the ranks, stats)."""
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train import checkpoint as ckpt
    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.steps import make_eval_step

    case = next(c for c in tp_gang["cases"] if c["name"] == "vlp_main")
    main_job, base = case["job"], case["job"]["results"]
    ranks = [r["vlp_main"] for r in tp_gang["ranks"]]
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
        cfg = _dist_cfg(main_job, os.path.join(base, "p0"))
        logs = [_train_log(os.path.join(base, f"p{r}")) for r in range(2)]
        curve, one_digest = _one_process_curve(torch, np, cfg)
        rel = {}
        for epoch, (l0, l1, want) in enumerate(zip(*logs, curve, strict=True)):
            for key in ("loss_overall", "grad_norm"):
                if l0[key] != l1[key]:
                    raise AssertionError(f"the ranks logged different {key}s: {l0} {l1}")
                rel[f"{key}_e{epoch}"] = abs(l0[key] - want[key]) / abs(want[key])
        lim = {"loss_overall": TRAIN_TOL["loss"], "grad_norm": TRAIN_TOL["grad_norm"]}
        bad = {k: v for k, v in rel.items() if v > lim[k.rsplit("_e", 1)[0]]}
        digests_equal = ranks[0]["digest"] == ranks[1]["digest"]
        eval_ds = MRDataset(cfg.eval_data)
        model = UniVTG(cfg.model, device="cuda", seed=cfg.seed)
        model.load_state_dict(ckpt.restore_params(
            os.path.join(base, "p0", "model_latest.ckpt"), model.state_dict()))
        sub = driver_mr._run_eval_shard(cfg, model, eval_ds, make_eval_step(cfg.eval_mode))
        full = driver_mr.evaluate_submission(sub, eval_ds.data)["brief"]
        sharded = _jsonl(os.path.join(base, "p0", "eval_log.jsonl"))[-1]
        eval_bad = {k: (sharded[k], v) for k, v in full.items()
                    if abs(sharded[k] - v) > 1e-6 * max(1.0, abs(v))}
        log(f"[dist] (ii) gloo gang of 2 ranks on one card ({card}): backends "
            f"{[r['backend'] for r in ranks]} on {[r['device'] for r in ranks]}; train_vlp "
            f"{DIST_EPOCHS} epochs of B = {cfg.bsz} per rank in "
            f"{[round(r['train_vlp_s'], 2) for r in ranks]} s (in 7u's gang); logged "
            f"curve {[(l['loss_overall'], l['grad_norm']) for l in logs[0]]} "
            f"vs one process on B = {2 * cfg.bsz} {[(c['loss_overall'], c['grad_norm']) for c in curve]}: "
            f"rel {json.dumps(rel)}; rank digests equal {digests_equal} (one process's "
            f"{'equal' if one_digest == ranks[0]['digest'] else 'differs'}); sharded eval "
            f"{json.dumps({k: sharded[k] for k in full})} vs full {json.dumps(full)}; "
            f"launches per rank {[r['launches'] for r in ranks]}")
        for r in ranks:
            log(f"[dist] (ii) rank {r['rank']} gated f32 step at B = {cfg.bsz} over gloo "
                f"({card}): {json.dumps(r['step'])}")
        if bad or not digests_equal or eval_bad:
            raise AssertionError(f"gang vs one process {bad}, digests equal "
                                 f"{digests_equal}, sharded vs full eval {eval_bad}")
        if any(launches[k] == 0 for k in FLASH_KERNELS):
            raise AssertionError(f"the gang skipped a flash kernel: {launches}")
    finally:
        torch.backends.cudnn.deterministic = cudnn
    return launches, {"rel": rel, "ranks": ranks}


def phase_dist(torch, np, card, tmp, job):
    """7k, training across processes: (i) a NCCL gang of one on the card
    (_nccl_of_one); (ii) the two gloo ranks' train_vlp runs as a case of
    7u's gang and is held by phase_dist_gang; the elastic restart at a
    smaller depth (DIST_ELASTIC); (iii) the CLIP teacher on the card
    against the CPU at ViT-B/32's text width. Returns (the NCCL gang's
    launches, stats)."""
    from univtg_tpu_torch.tools import teacher

    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        nccl = _nccl_of_one(torch, np, card, job, tmp)
        log(f"[dist] (i) in {time.perf_counter() - t0:.1f} s")

        # the elastic restart at a smaller depth: A (rank 1 exits after epoch
        # DIST_FAULT_EPOCH) beside C (uninterrupted), then B (A restarted
        # from rank 0's latest checkpoint with resume_all)
        t0 = time.perf_counter()
        small = {**job, "overrides": {**DIST_ELASTIC, "eval_epoch": 1}}
        base_a, base_c = os.path.join(tmp, "dist_elastic"), os.path.join(tmp, "dist_full")
        gang_a = _gang({**small, "mode": "elastic", "overrides": {
            **small["overrides"], "inject_fault_epoch": DIST_FAULT_EPOCH,
            "inject_fault_rank": 1}}, base_a)
        gang_c = _gang({**small, "mode": "full"}, base_c)
        # B's processes start now and reach the card while A runs; they join
        # their gang once A has ended
        a_ended = os.path.join(tmp, "dist_elastic_a_ended")
        gang_b = _gang({**small, "mode": "resume", "start_after": a_ended}, base_a,
                       job_dir=os.path.join(tmp, "dist_elastic_b"))
        try:
            _wait_gang(gang_a, rcs=[None, 3])
            log(f"[dist] (ii) elastic restart: the faulted gang ended after "
                f"{time.perf_counter() - t0:.1f} s")
            if gang_a[0].returncode == 0:
                raise AssertionError("rank 0 of the faulted gang ended as if nothing "
                                     "happened")
            resumed_from = torch.load(os.path.join(base_a, "p0", "model_latest.ckpt"),
                                      map_location="cpu", weights_only=True)["epoch"]
            with open(a_ended, "w"):
                pass
            _wait_gang(gang_b)
            _wait_gang(gang_c)
        finally:
            _kill_gang(gang_b + gang_c)
        got = _train_log(os.path.join(base_a, "p0"))[DIST_FAULT_EPOCH + 1:]
        want = {l["epoch"]: l for l in _train_log(os.path.join(base_c, "p0"))}
        n_epoch = DIST_ELASTIC["n_epoch"]
        if [l["epoch"] for l in got] != list(range(resumed_from + 1, n_epoch)):
            raise AssertionError(f"the restarted gang logged epochs {got}")
        elastic_rel = max(abs(l["loss_overall"] - want[l["epoch"]]["loss_overall"])
                          / abs(want[l["epoch"]]["loss_overall"]) for l in got)
        digests = [json.load(open(os.path.join(d, "r0.json")))["digest"]
                   for d in (base_a, base_c)]
        log(f"[dist] (ii) elastic restart ({DIST_ELASTIC}): rank 1 exited 3 after epoch "
            f"{DIST_FAULT_EPOCH}, "
            f"rank 0 {gang_a[0].returncode}; restarted from epoch {resumed_from}'s "
            f"checkpoint: epochs {[l['epoch'] for l in got]}, loss rel to the uninterrupted "
            f"gang {elastic_rel:.3g}, final params equal {digests[0] == digests[1]} "
            f"({time.perf_counter() - t0:.1f} s)")
        if elastic_rel > 1e-6:
            raise AssertionError(f"the restarted gang left the uninterrupted curve: "
                                 f"rel {elastic_rel}")
    finally:
        torch.backends.cudnn.deterministic = cudnn

    # (iii) the teacher's similarity sweep on the card against the CPU
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((TEACHER_CONCEPTS, 512)).astype(np.float32)
    feats = rng.standard_normal((TEACHER_CLIPS, 512)).astype(np.float32)
    feats[40:60] += 3 * bank[7]
    names = [f"concept {i}" for i in range(TEACHER_CONCEPTS)]
    t0 = time.perf_counter()
    rows = teacher.pseudo_label_video("v", feats, bank, names)
    card_ms = (time.perf_counter() - t0) * 1e3
    cpu_rows = teacher.pseudo_label_video("v", feats, bank, names, device="cpu")
    cpu_sim = teacher._sim(torch.from_numpy(feats), torch.from_numpy(bank)).numpy()
    sim_err = float(np.abs(teacher._sim(torch.from_numpy(feats).cuda(),
                                        torch.from_numpy(bank).cuda()).cpu().numpy()
                           - cpu_sim).max())
    # a score may fall on the other side of a multiple of the threshold
    # only where the CPU's similarity lies within TEACHER_TOL of one
    flips = [(r["qid"], i) for r, c in zip(rows, cpu_rows) for i, (a, b) in enumerate(
        zip(r["saliency_scores"], c["saliency_scores"])) if a != b]
    edge = [abs(cpu_sim[i, q] / 0.05 - round(cpu_sim[i, q] / 0.05)) * 0.05 <= TEACHER_TOL
            for q, i in flips]
    same_concepts = [r["qid"] for r in rows] == [r["qid"] for r in cpu_rows]
    log(f"[dist] (iii) teacher: {TEACHER_CLIPS} clips x {TEACHER_CONCEPTS} concepts at 512 "
        f"dims, similarity card vs CPU max |d| {sim_err:.3g}, rows equal "
        f"{rows == cpu_rows} (concepts equal {same_concepts}; {len(flips)} scores across a "
        f"threshold edge) ({len(rows)} rows, {card_ms:.1f} ms on the card)")
    if sim_err > TEACHER_TOL or not same_concepts or not all(edge) or not rows:
        raise AssertionError("the teacher on the card disagrees with the CPU")
    return nccl["launches"], {"nccl": nccl, "elastic_rel": elastic_rel}


def _md_data(corpus, split, span):
    from univtg_tpu_torch.data.mr import MRDataConfig

    return MRDataConfig(data_path=corpus[split], v_feat_dirs=corpus["v_feat_dirs"],
                        q_feat_dir=corpus["q_feat_dir"], v_feat_dim=corpus["v_dim"],
                        q_feat_dim=corpus["q_dim"], max_q_l=32, max_v_l=75,
                        span_loss_type=span)


def _md_cfg(corpus, run_dir, span, n_epoch):
    """train_mr's config of phase 7i: Moment-DETR at MomentDETRConfig()'s
    defaults (the flagship's widths), B = 32, evaluated every epoch."""
    from univtg_tpu_torch.models.moment_detr import MomentDETRConfig
    from univtg_tpu_torch.train.driver_mr import TrainConfig

    # "ce" rows unrounded (round_multiple 0), so the clip grid is the decode's
    return TrainConfig(model=MomentDETRConfig(span_loss_type=span), model_id="moment_detr",
                       train_data=_md_data(corpus, "train_path", span),
                       eval_data=_md_data(corpus, "val_path", span), results_dir=run_dir,
                       bsz=32, eval_bsz=32, n_epoch=n_epoch, eval_epoch=1,
                       save_interval=-1, eval_mode=None,
                       round_multiple=0 if span == "ce" else 1)


def _md_train(torch, np, cfg, card):
    """train_mr on the card; returns its train_log lines after checking 3
    finite steps an epoch and one evaluation an epoch."""
    from univtg_tpu_torch.train.driver_mr import train_mr

    t0 = time.perf_counter()
    metrics, best = train_mr(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = _jsonl(os.path.join(cfg.results_dir, "train_log.jsonl"))
    evals = _jsonl(os.path.join(cfg.results_dir, "eval_log.jsonl"))
    log(f"[md] train_mr {cfg.model.span_loss_type}: {sum(x['steps'] for x in lines)} "
        f"steps in {len(lines)} epochs, {wall:.2f} s with the model build and "
        f"{len(evals)} evaluations ({card}); loss by epoch "
        f"{[round(x['loss_overall'], 4) for x in lines]}; MR-full-mAP by epoch "
        f"{[e['MR-full-mAP-key'] for e in evals]}")
    if ([x["steps"] for x in lines] != [3] * cfg.n_epoch
            or not all(np.isfinite(x["loss_overall"]) for x in lines)
            or [e["epoch"] for e in evals] != list(range(cfg.n_epoch))
            or not os.path.exists(best)):
        raise AssertionError(f"Moment-DETR train_mr: {lines}, {evals}")
    return lines


def _md_rows_equal(np, got, want):
    if [r["qid"] for r in got] != [r["qid"] for r in want]:
        return False
    return all(np.array_equal(a["pred_relevant_windows"], b["pred_relevant_windows"])
               and np.array_equal(a["pred_saliency_scores"], b["pred_saliency_scores"])
               for a, b in zip(got, want))


def _md_match_check(torch, np, model, mi, tg, span):
    """hungarian_match "exhaustive" (on the card) against "callback" (scipy)
    on the costs of the model's outputs for one batch, main and aux decoder
    layers: the same assignment, or one whose total cost is within
    MATCH_TIE_REL of scipy's. Returns (calls checked, items that differed
    within the tie rule, ms of one exhaustive call)."""
    from univtg_tpu_torch.models.moment_detr import hungarian_match, match_cost
    from univtg_tpu_torch.train.steps import forward

    with torch.no_grad():
        model.eval()
        out = forward(model, mi, train=False)
    n_win = tg["n_windows"]
    ties, calls = 0, [out, *out.get("aux_outputs", [])]
    for o in calls:
        args = (o, tg["span_labels"], n_win)
        got = hungarian_match(*args, impl="exhaustive", span_loss_type=span).cpu().numpy()
        want = hungarian_match(*args, impl="callback", span_loss_type=span).cpu().numpy()
        cost = match_cost(o, tg["span_labels"], span_loss_type=span).double().cpu().numpy()
        for b, n in enumerate(n_win.cpu().numpy()):
            if np.array_equal(got[b], want[b]):
                continue
            cg = cost[b, got[b, :n], np.arange(n)].sum()
            cw = cost[b, want[b, :n], np.arange(n)].sum()
            if (got[b, n:] != -1).any() or abs(cg - cw) > MATCH_TIE_REL * abs(cw):
                raise AssertionError(f"exhaustive matching item {b}: {got[b]} (cost {cg}) "
                                     f"vs scipy {want[b]} (cost {cw})")
            ties += 1
    ms = cuda_ms(lambda: hungarian_match(out, tg["span_labels"], n_win,
                                         impl="exhaustive", span_loss_type=span), iters=20)
    return len(calls), ties, ms


def phase_md(torch, np, card, tmp, corpus):
    """7i, Moment-DETR through train_mr at MomentDETRConfig()'s defaults
    (the flagship's widths: hidden 1024, 4 encoder layers, 8 heads, FFN
    1024, 2818-d video, 512-d text; 10 queries, 2 decoder layers, aux_loss)
    on phase 7's corpus, B = 32: "l1" for MD_EPOCHS epochs evaluated each
    epoch, then "ce" for one (its windows on the 2 s clip grid); no flash
    kernel launched, "xla" attention dispatched. model_best.ckpt reloaded
    through load_torch_checkpoint gives its evaluation's metrics, and
    model_latest.ckpt the last evaluation's rows. "exhaustive" matching
    against scipy on the step's own costs. The f32 step's ms by CUDA events
    over MD_TIMED_STEPS steps, then one step under torch.profiler. Returns
    (training launches, inference launches, step stats)."""
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.interop import load_torch_checkpoint, read_checkpoint
    from univtg_tpu_torch.models.moment_detr import MomentDETR
    from univtg_tpu_torch.ops import attention
    from univtg_tpu_torch.train.driver_mr import _run_eval_shard
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.infer_mr import evaluate_submission
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import (TrainState, make_md_eval_step,
                                              make_md_train_step, make_optimizer)

    cfg = _md_cfg(corpus, os.path.join(tmp, "md_run"), "l1", MD_EPOCHS)
    ce_cfg = _md_cfg(corpus, os.path.join(tmp, "md_ce_run"), "ce", 1)
    _reset_launches()  # the Moment-DETR training main path starts here
    _md_train(torch, np, cfg, card)
    _md_train(torch, np, ce_cfg, card)
    train_launches = _launches()  # ... and ends here
    dispatched = dict(attention.dispatches)
    log(f"[md] training launches {train_launches}; attention dispatches {dispatched}")
    if any(train_launches.values()) or dispatched["xla"] == 0 or any(
            n for impl, n in dispatched.items() if impl != "xla"):
        raise AssertionError("Moment-DETR must run the plain attention alone, as the JAX "
                             f"package does: launches {train_launches}, {dispatched}")
    rows = _jsonl(os.path.join(cfg.results_dir, "latest_val_preds.jsonl"))
    if {len(r["pred_relevant_windows"]) for r in rows} != {cfg.model.num_queries}:
        raise AssertionError("a Moment-DETR row does not carry num_queries windows")
    ce_rows = _jsonl(os.path.join(ce_cfg.results_dir, "latest_val_preds.jsonl"))
    dur = {r["qid"]: r["duration"] for r in MRDataset(ce_cfg.eval_data).data}
    off = [w for r in ce_rows for w in r["pred_relevant_windows"]
           if w[0] % 2.0 or w[1] % 2.0 or not 0 <= w[0] <= dur[r["qid"]]
           or not 0 <= w[1] <= dur[r["qid"]]]
    log(f"[md] ce: {len(ce_rows)} rows, {sum(len(r['pred_relevant_windows']) for r in ce_rows)} "
        f"windows, {len(off)} off the 2 s clip grid or the video")
    if off:
        raise AssertionError(f"ce windows off the clip grid: {off[:5]}")

    # the checkpoints reloaded: their evaluations' metrics and rows again
    eval_ds = MRDataset(cfg.eval_data)
    eval_step = make_md_eval_step("l1", 2.0)

    def reload(name):
        path = os.path.join(cfg.results_dir, name)
        model = MomentDETR(cfg.model, device="meta")
        model.load_state_dict({k: v.cuda() for k, v in load_torch_checkpoint(
            path, cfg.model).items()}, assign=True)
        return model, read_checkpoint(path)["epoch"]

    model, best_epoch = reload("model_best.ckpt")
    _reset_launches()  # the Moment-DETR inference main path starts here
    sub = _run_eval_shard(cfg, model, eval_ds, eval_step)
    torch.cuda.synchronize()
    infer_launches = _launches()  # ... and ends here
    brief = evaluate_submission(sub, eval_ds.data)["brief"]
    with open(os.path.join(cfg.results_dir, f"metrics_e{best_epoch:04d}.json")) as f:
        want = json.load(f)["brief"]
    # latest_val_preds.jsonl holds the last evaluation's rows, model_latest's
    latest, latest_epoch = reload("model_latest.ckpt")
    same_rows = _md_rows_equal(np, _run_eval_shard(cfg, latest, eval_ds, eval_step), rows)
    if best_epoch == latest_epoch:
        same_rows = same_rows and _md_rows_equal(np, sub, rows)
    del latest
    log(f"[md] model_best.ckpt (epoch {best_epoch}) reloaded: brief metrics equal "
        f"{brief == want}; rows of model_latest.ckpt (epoch {latest_epoch})"
        f"{' and model_best.ckpt' if best_epoch == latest_epoch else ''} equal to the "
        f"last evaluation's {same_rows}; launches {infer_launches}")
    if brief != want or not same_rows or any(infer_launches.values()):
        raise AssertionError("a reloaded Moment-DETR checkpoint does not give its "
                             "evaluation's rows and metrics")

    # exhaustive matching against scipy, and the step's time
    batch = _train_batches(np, corpus, 1)[0]
    mi, tg = (to_device(t, "cuda") for t in strip_meta(batch))
    n_calls, ties, match_ms = _md_match_check(torch, np, model, mi, tg, "l1")
    ce_batch = _md_batches(corpus, ce_cfg)
    ce_model = MomentDETR(ce_cfg.model, device="meta")
    ce_model.load_state_dict({k: v.cuda() for k, v in load_torch_checkpoint(
        os.path.join(ce_cfg.results_dir, "model_best.ckpt"), ce_cfg.model).items()},
        assign=True)
    ce_calls, ce_ties, ce_match_ms = _md_match_check(torch, np, ce_model, *ce_batch, "ce")
    log(f"[md] exhaustive matching vs scipy on the step's costs (B = 32, 10 queries, 5 "
        f"windows, P(10, 5) = 30240 rows): l1 {n_calls} calls, {ties} near-ties, "
        f"{match_ms:.3f} ms a call; ce {ce_calls} calls, {ce_ties} near-ties, "
        f"{ce_match_ms:.3f} ms a call ({card})")
    del ce_model

    model = MomentDETR(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(
        model.parameters(), build_schedule(cfg.lr, cfg.lr_warmup, cfg.lr_drop,
                                           cfg.lr_gamma, 3), cfg.wd, cfg.grad_clip))
    step = make_md_train_step(cfg.weights, cfg.weights.eos_coef, cfg.saliency_margin, "l1")
    holder = {}

    def one():
        holder["m"] = step(state, mi, tg, 0)[1]

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(one, iters=MD_TIMED_STEPS, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    us, _, wall_us = _profile_counts(torch, one)
    busy = sum(us.values())
    top = sorted(us.items(), key=lambda kv: -kv[1])[:8]
    stats = {"cell": "train_md_f32", "device": card, "B": 32, "tokens": 75 + 32,
             "ms": ms, "profiled_host_ms": wall_us / 1e3, "profiled_busy_ms": busy / 1e3,
             "idle_share": 1.0 - busy / wall_us if busy else None,
             "matcher_ms_per_call": match_ms,
             "matcher_calls_per_step": n_calls, "peak_gib": peak,
             "top_kernels_ms": [[k[:90], t / 1e3] for k, t in top]}
    if not busy:
        stats["note"] = "torch.profiler recorded no device activity: not measured"
    log(f"[md] make_md_train_step, f32, B = 32, 75 + 32 tokens (ms by CUDA events over "
        f"{MD_TIMED_STEPS} steps, then one step under torch.profiler; {card}): "
        f"{json.dumps(stats)}")
    if not np.isfinite(float(holder["m"]["loss_overall"])):
        raise AssertionError("the Moment-DETR step is not finite")
    return train_launches, infer_launches, stats


def _md_batches(corpus, cfg):
    """The first training batch of a Moment-DETR config's data, on the card."""
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.train.epoch_runner import strip_meta

    ds = MRDataset(cfg.train_data)
    batch = collate_mr([ds[i] for i in range(32)], 32, 75)
    return tuple(to_device(t, "cuda") for t in strip_meta(batch))


def _clip_flops(cfg, tokens=None):
    """Multiply-adds x 2 of one frame through the ViT image tower (tokens
    None) or of one query of ``tokens`` tokens through the text tower:
    the patch conv, per layer the q/k/v and out projections, the scores and
    P . V, the MLP, then the projection (univtg_tpu/extract/clip/model.py
    :84-131 and :265-307)."""
    if tokens is None:
        L, D, layers = cfg.grid**2 + 1, cfg.vision_width, cfg.vision_layers
        extra = (L - 1) * 3 * cfg.vision_patch_size**2 * D + D * cfg.embed_dim
    else:
        L, D, layers = tokens, cfg.transformer_width, cfg.transformer_layers
        extra = D * cfg.embed_dim
    per_layer = 4 * L * D * D + 2 * L * L * D + 2 * L * D * 4 * D
    return 2 * (layers * per_layer + extra)


def _ground_queries(np, n, seed=0):
    """n seeded English queries."""
    rng = np.random.default_rng(seed)
    who = ["a man", "a woman", "the chef", "a child", "two friends", "the vlogger",
           "a dog", "the driver"]
    does = ["opens", "cleans", "carries", "points at", "talks about", "walks past",
            "picks up", "throws"]
    what = ["the door", "a red car", "the kitchen table", "a bowl of noodles",
            "the beach at sunset", "a tall building", "her phone", "the camera"]
    return [f"{who[rng.integers(len(who))]} {does[rng.integers(len(does))]} "
            f"{what[rng.integers(len(what))]}" for _ in range(n)]


def _ground_video(np, tmp):
    """A GROUND_CLIPS x 2 s synthetic video written by the decoder the card's
    machine has (ffmpeg, else cv2): (path, decoder). Without either, a
    placeholder file and None: the phase then replaces
    extract/video.decode_frames with seeded frames."""
    import shutil

    seconds = GROUND_CLIPS * 2
    path = os.path.join(tmp, "ground.avi")
    if shutil.which("ffmpeg") and shutil.which("ffprobe"):
        subprocess.run(["ffmpeg", "-v", "error", "-nostdin", "-f", "lavfi", "-i",
                        f"testsrc=size=320x240:rate=5:duration={seconds}", "-c:v",
                        "mjpeg", "-q:v", "5", path], check=True, timeout=300)
        return path, "ffmpeg"
    try:
        import cv2
    except ImportError:
        with open(path, "wb") as f:
            f.write(b"placeholder: no decoder on this machine")
        return path, None
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (320, 240))
    base = np.random.default_rng(0).integers(0, 256, (30, 40, 3)).astype(np.uint8)
    for i in range(seconds * 5):
        writer.write(np.roll(base, i, axis=1).repeat(8, axis=0).repeat(8, axis=1))
    writer.release()
    return path, "cv2"


class _StubComponent:
    def __init__(self, wired, label=None, **kw):
        self.wired, self.label = wired, label

    def click(self, fn, inputs=None, outputs=None):
        self.wired.append((self.label, fn))


class _StubBlocks:
    def __init__(self, **kw):
        self.launched = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def launch(self, **kw):
        self.launched = kw


def _stub_gradio(wired):
    """The gradio API that serve/app.launch_app uses (no gradio on the card's
    machine); clicks are recorded in ``wired``."""
    import contextlib

    def component(label=None, **kw):
        return _StubComponent(wired, label, **kw)

    return SimpleNamespace(Blocks=_StubBlocks, Row=contextlib.nullcontext,
                           Column=contextlib.nullcontext, Markdown=lambda *a, **k: None,
                           Video=component, Button=component, Textbox=component)


def _rel(np, a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_ground(torch, np, card, tmp):
    """7j, raw-video grounding at the upstream demo's configuration: CLIP
    ViT-B/32 (vit_b32(): 224^2, patch 32, vision 768 x 12, text 512 x 12, 8
    heads, vocabulary 49408, context 77) in front of the flagship at
    vid_dim 514 (512 CLIP + 2 TEF) and txt_dim 512, random weights from
    seeds, "pallas", f32. Returns (ground launches, ground_server launches,
    stats)."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.extract import video
    from univtg_tpu_torch.extract.clip.model import CLIP, vit_b32
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.presets import PRESETS

    t0 = time.perf_counter()
    clip_cfg = vit_b32()
    clip_sd = CLIP(clip_cfg, device="cpu", seed=0).state_dict()
    clip_path = os.path.join(tmp, "clip_vitb32.pt")
    torch.save(clip_sd, clip_path)
    model_cfg = cli.apply_overrides(PRESETS["qvhighlights_mr"](), GROUND_OVERRIDES).model
    sd = UniVTG(model_cfg, device="cpu", seed=0).state_dict()
    ckpt = os.path.join(tmp, "ground_univtg.ckpt")
    torch.save({"model": sd}, ckpt)
    path, decoder = _ground_video(np, tmp)
    log(f"[ground] CLIP ViT-B/32 from seed 0: {sum(v.numel() for v in clip_sd.values()) / 1e6:.2f}"
        f" M params ({os.path.getsize(clip_path) / 1e6:.0f} MB file); UniVTG "
        f"{model_cfg.vid_dim}/{model_cfg.txt_dim} -> {model_cfg.hidden_dim} x "
        f"{model_cfg.num_layers}, {model_cfg.attention_impl}; video decoder: "
        f"{decoder or 'none (no ffmpeg, no cv2): extract/video.decode_frames replaced by seeded uint8 frames'}"
        f" ({time.perf_counter() - t0:.1f} s)")
    decode = video.decode_frames
    if decoder is None:
        frames = np.random.default_rng(7).integers(0, 256, (GROUND_CLIPS, 224, 224, 3),
                                                   dtype=np.uint8)
        video.decode_frames = lambda p, clip_len=2.0, **kw: (
            frames, {"fps": None, "duration": GROUND_CLIPS * clip_len,
                     "width": None, "height": None})
    s = SimpleNamespace(card=card, tmp=tmp, clip_cfg=clip_cfg, clip_sd=clip_sd,
                        clip_path=clip_path, model_cfg=model_cfg, sd=sd, ckpt=ckpt,
                        path=path)
    try:
        _ground_paths(torch, np, s)
        _ground_server(torch, np, s)
        return _ground_checks(torch, np, s)
    finally:
        video.decode_frames = decode


def _ground_paths(torch, np, s):
    """phase_ground's counted main path (cli ground, cli extract-text, the
    demo app) on the video that ``s.path`` names, decoded by the machine's
    decoder or the stand-in. Adds the encoder, the pipeline, the frames, the
    queries and the launches to ``s``."""
    import contextlib
    import io

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.extract import video
    from univtg_tpu_torch.extract.pipeline import ClipEncoder, txt2clip
    from univtg_tpu_torch.serve import GroundingPipeline, app

    tmp, clip_cfg, clip_sd, model_cfg, path = s.tmp, s.clip_cfg, s.clip_sd, s.model_cfg, s.path
    queries = _ground_queries(np, GROUND_TEXT_ROWS)
    frames, _ = video.decode_frames(path)
    if not GROUND_CLIPS - 1 <= len(frames) <= GROUND_CLIPS + 1:
        raise AssertionError(f"decoded {len(frames)} frames of a {GROUND_CLIPS * 2} s video")

    # --- the main path, counted: cli ground, cli extract-text, the demo app
    _reset_launches()
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli.main(["ground", "--preset", "qvhighlights_mr", "--resume", s.ckpt, "--clip-ckpt",
                  s.clip_path, "--video", path, "--query", queries[0], *GROUND_OVERRIDES])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    cli_launches = _launches()
    out = printed.getvalue()
    described, _, answer = out.partition("\n{")
    result = json.loads("{" + answer)
    log(f"[ground] cli ground ({cli_s:.1f} s, loads included): {described!r}; top-1 "
        f"{result['top1_window']}, duration {result['duration']}, launches {cli_launches}")
    win = np.asarray(result["topk_windows"])
    if (not described.startswith(f"For query: {queries[0]}") or result["duration"]
            != len(frames) * 2.0 or not np.isfinite(win).all() or (win[:, :2] < 0).any()
            or (win[:, :2] > result["duration"]).any() or len(win) != 5):
        raise AssertionError(f"cli ground answered {out!r}")
    rows = [{"qid": i, "query": q} for i, q in enumerate(queries)]
    meta = os.path.join(tmp, "ground_queries.jsonl")
    with open(meta, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    out_dir = os.path.join(tmp, "txt_clip")
    before = _launches()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["extract-text", "--metadata", meta, "--clip-ckpt", s.clip_path,
                  "--out-dir", out_dir])
    extract_launches = {k: v - before[k] for k, v in _launches().items()}

    enc = ClipEncoder(clip_sd, clip_cfg, device="cuda")
    pipe = GroundingPipeline(model_cfg, s.sd, clip_encoder=enc, device="cuda")
    wired = []
    demo = app.launch_app(pipe, server_port=0, gr=_stub_gradio(wired))
    if [w[0] for w in wired] != ["Extract features", "Ground"] or demo.launched is None:
        raise AssertionError(f"the demo app wired {wired}")
    before = _launches()
    status = wired[0][1](path)
    answer = wired[1][1](queries[1])
    app_launches = {k: v - before[k] for k, v in _launches().items()}
    ground_launches = _launches()
    log(f"[ground] cli extract-text on {len(rows)} queries: launches {extract_launches}; "
        f"demo app: {status!r}, launches {app_launches}")
    if status != f"Extracted {len(frames)} clip features ({len(frames) * 2}s video).":
        raise AssertionError(f"the demo's extract said {status!r}")
    if not answer.startswith(f"For query: {queries[1]}") or answer.count("conf") != 5:
        raise AssertionError(f"the demo's ground said {answer!r}")
    want_launches = {k: 0 for k in ground_launches}
    want_launches["flash_fwd"] = 2 * model_cfg.num_layers  # cli ground and the app: 1 dispatch each
    if ground_launches != want_launches or any(extract_launches.values()):
        raise AssertionError(f"ground launches {ground_launches} (extract-text "
                             f"{extract_launches}), expected {want_launches}")

    # extract-text's files against txt2clip on the same weights
    err = 0.0
    for r in rows:
        with np.load(os.path.join(out_dir, f"{r['qid']}.npz")) as z:
            got = z["last_hidden_state"]
        want = txt2clip(enc, r["query"])
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"extract-text {r['qid']}: {got.shape} vs {want.shape}")
        err = max(err, float(np.abs(got - want).max()))
    log(f"[ground] extract-text npz vs txt2clip: {len(rows)} files, max abs err {err:.3g} "
        f"(limit {GROUND_TEXT_TOL}: both pad to one batch of {enc.text_batch})")
    if err > GROUND_TEXT_TOL:
        raise AssertionError("cli extract-text disagrees with txt2clip")

    s.enc, s.pipe, s.frames, s.queries, s.ground_launches = (
        enc, pipe, frames, queries, ground_launches)


def _ground_server(torch, np, s):
    """The server's counted main path: GroundingServer with the encoder, the
    raw video PUT, then GROUND_QUERIES concurrent text POSTs, each answer
    equal to the direct ground_features call on the same features. Adds the
    launches and the server's stats to ``s``."""
    from univtg_tpu_torch.extract.pipeline import txt2clip, vid2clip
    from univtg_tpu_torch.serve import GroundingServer

    pipe, path, queries = s.pipe, s.path, s.queries

    server = GroundingServer(pipe, host="127.0.0.1", port=0, max_batch=16,
                             max_wait_ms=50.0).start()
    base = f"http://127.0.0.1:{server.port}"

    def call(route, data=None, method=None, headers=None):
        req = urllib.request.Request(base + route, data=data, method=method,
                                     headers=headers or {})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    _reset_launches()
    try:
        with open(path, "rb") as f:
            body = f.read()
        t = time.perf_counter()
        status, reg = call("/videos/raw", body, "PUT", {"Content-Type": "video/x-msvideo"})
        put_ms = (time.perf_counter() - t) * 1e3
        if status != 200 or reg["clips"] != GROUND_CLIPS:
            raise AssertionError(f"raw-video PUT: {status} {reg}")
        qs = queries[:GROUND_QUERIES]
        results = [None] * len(qs)
        barrier = threading.Barrier(len(qs))

        def fire(i):
            barrier.wait()
            results[i] = call("/ground", json.dumps({"video": "raw", "query": qs[i]}).encode(),
                              "POST")

        t = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(qs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall_ms = (time.perf_counter() - t) * 1e3
        if any(th.is_alive() for th in threads):
            raise AssertionError("a text /ground request did not finish")
        _, stats = call("/stats")
    finally:
        server.close()
    launches = _launches()
    feats = vid2clip(pipe.clip_encoder, path)
    for q, (status, got) in zip(qs, results):
        want = pipe.ground_features(feats, txt2clip(pipe.clip_encoder, q))
        if status != 200 or not (
                np.allclose(got["topk_windows"], want["topk_windows"], atol=1e-4)
                and np.allclose(got["saliency"], want["saliency"], atol=1e-4)):
            raise AssertionError(f"text /ground answer differs from ground_features ({q!r})")
    log(f"[ground] server: raw-video PUT {put_ms:.1f} ms ({reg}); {len(qs)} concurrent text "
        f"/ground {wall_ms:.1f} ms wall, {stats['batches']} batches, max batch "
        f"{stats['max_batch_size']}, launches {launches}")
    want_launches = {k: 0 for k in launches}
    want_launches["flash_fwd"] = pipe.cfg.num_layers * stats["batches"]
    if launches != want_launches:
        raise AssertionError(f"server launches {launches}, expected {want_launches}")
    s.server_launches = launches
    s.server_stats = {"put_ms": put_ms, "post_wall_ms": wall_ms, "batches": stats["batches"]}


def _ground_checks(torch, np, s):
    """phase_ground's holds, times and profile, outside the counted paths.
    Returns (ground launches, ground_server launches, stats)."""
    import dataclasses
    import itertools

    from univtg_tpu_torch.extract import video
    from univtg_tpu_torch.extract.clip.tokenizer import tokenize
    from univtg_tpu_torch.extract.pipeline import ClipEncoder, txt2clip, vid2clip
    from univtg_tpu_torch.extract.video import preprocess_frames
    from univtg_tpu_torch.serve import GroundingPipeline

    card, clip_cfg, clip_sd, model_cfg = s.card, s.clip_cfg, s.clip_sd, s.model_cfg
    enc, pipe, path, frames, queries = s.enc, s.pipe, s.path, s.frames, s.queries
    qs = queries[:GROUND_QUERIES]
    feats = vid2clip(enc, path)
    txts = [txt2clip(enc, q) for q in qs]
    # "pallas" against "xla" on the same features, phase 4's f32 limits
    pipe_xla = GroundingPipeline(dataclasses.replace(model_cfg, attention_impl="xla"), s.sd,
                                 device="cuda")
    _hold_against_xla(np, "ground f32 B=1 L=128+32",
                      [pipe.ground_features(feats, t) for t in txts],
                      [pipe_xla.ground_features(feats, t) for t in txts],
                      len(feats), PIPE_TOL["float32"])
    del pipe_xla

    # the card's f32 encoder against the same encoder on the CPU
    cpu = ClipEncoder(clip_sd, clip_cfg, image_batch=8, text_batch=8, device="cpu")
    few = frames[:8]
    img_rel = _rel(np, enc.encode_images(few), cpu.encode_images(few))
    h_card, p_card = enc.encode_texts(qs)
    h_cpu, p_cpu = cpu.encode_texts(qs)
    txt_rel = max(_rel(np, p_card, p_cpu),
                  max(_rel(np, a, b) for a, b in zip(h_card, h_cpu)))
    del cpu
    # uint8 normalized on the card against f32 frames normalized on the host
    u8 = enc.encode_images(frames)
    u8_err = float(np.abs(u8 - enc.encode_images(preprocess_frames(frames))).max())
    # bf16 against f32
    enc16 = ClipEncoder(clip_sd, dataclasses.replace(clip_cfg, compute_dtype="bfloat16"),
                        device="cuda")
    bf16_img = _rel(np, enc16.encode_images(frames), u8)
    h16, p16 = enc16.encode_texts(qs)
    bf16_txt = max(_rel(np, p16, p_card), max(_rel(np, a, b) for a, b in zip(h16, h_card)))
    log(f"[ground] card f32 vs CPU f32 (8 frames, 8 queries), max |d| / max |cpu|: image "
        f"{img_rel:.3g}, text {txt_rel:.3g} (limit {CLIP_DEVICE_TOL}, TF32 off); uint8 vs "
        f"host-normalized f32 frames, {len(frames)} frames: max abs {u8_err:.3g} (limit "
        f"{CLIP_U8_TOL}); bf16 vs f32, max |d| / max |f32|: image {bf16_img:.3g}, text "
        f"{bf16_txt:.3g} (limit {CLIP_BF16_TOL})")
    if max(img_rel, txt_rel) > CLIP_DEVICE_TOL or u8_err > CLIP_U8_TOL or max(
            bf16_img, bf16_txt) > CLIP_BF16_TOL:
        raise AssertionError("a CLIP hold failed")

    # the towers' times, CUDA events after warm-up
    g = torch.Generator(device="cuda").manual_seed(0)
    frames_dev = torch.randint(0, 256, (GROUND_TIMED_FRAMES, 224, 224, 3), dtype=torch.uint8,
                               device="cuda", generator=g)
    batches = frames_dev.split(enc.image_batch)
    frame_flops = _clip_flops(clip_cfg)
    text_flops = _clip_flops(clip_cfg, clip_cfg.context_length)
    tokens = torch.from_numpy(tokenize(queries[:enc.text_batch],
                                       clip_cfg.context_length)).to("cuda")
    towers = {}
    for dname, e in (("float32", enc), ("bfloat16", enc16)):
        ring = itertools.cycle(batches)
        batch_ms = cuda_ms(lambda: e._encode_image(next(ring)), len(batches))
        fps = enc.image_batch / batch_ms * 1e3
        bound_fps = PEAK_FLOPS[dname] / frame_flops
        text_ms = cuda_ms(lambda: e._encode_text(tokens), 20)
        towers[dname] = {
            "image_batch_ms": batch_ms, "frames_per_s": fps, "bound_frames_per_s": bound_fps,
            "bound_share": fps / bound_fps, "tflops": frame_flops * fps / 1e12,
            "text_batch_ms": text_ms, "text_ms_per_query": text_ms / enc.text_batch,
            "text_bound_share": text_flops * enc.text_batch / (text_ms * 1e-3)
            / PEAK_FLOPS[dname]}
        log(f"[ground] {dname} image tower at B={enc.image_batch} over "
            f"{GROUND_TIMED_FRAMES} frames: {batch_ms:.3f} ms a batch, {fps:.0f} frames/s "
            f"({frame_flops / 1e9:.3f} GFLOP a frame, {frame_flops * fps / 1e12:.1f} "
            f"TFLOP/s, {fps / bound_fps:.3f} of the {PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s "
            f"bound); text tower {text_ms:.3f} ms a batch of {enc.text_batch} = "
            f"{text_ms / enc.text_batch:.4f} ms a query ({text_flops / 1e9:.3f} GFLOP at "
            f"{clip_cfg.context_length} tokens) ({card})")
    host = frames_dev.cpu().numpy()
    t = time.perf_counter()
    enc.encode_images(host)
    towers["float32"]["host_frames_per_s"] = len(host) / (time.perf_counter() - t)
    log(f"[ground] encode_images from host uint8, f32, {len(host)} frames: "
        f"{towers['float32']['host_frames_per_s']:.0f} frames/s (pageable copies included)")
    del frames_dev, batches, host, enc16
    torch.cuda.empty_cache()

    # the whole ground_video of the GROUND_CLIPS-clip video, and its split
    q = queries[2]
    pipe.ground_video(path, q)  # warm
    whole = []
    for _ in range(3):
        t = time.perf_counter()
        pipe.ground_video(path, q)
        whole.append((time.perf_counter() - t) * 1e3)
    # its split: each step through the entry it calls, synchronized; the
    # copy of the uint8 frames alone is also timed (it is inside image_ms)
    split = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] = (time.perf_counter() - t) * 1e3
        return out

    got, _ = timed("decode_ms", lambda: video.decode_frames(path))
    timed("copy_ms", lambda: torch.from_numpy(got).to("cuda"))
    vid_feats = timed("image_ms", lambda: enc.encode_images(got))
    txt = timed("text_ms", lambda: txt2clip(enc, q))
    timed("grounding_ms", lambda: pipe.ground_features(vid_feats, txt))
    log(f"[ground] ground_video, {len(got)} clips, f32: {', '.join(f'{w:.2f}' for w in whole)} "
        f"ms host clock; split (one run each, synchronized): "
        f"{json.dumps({k: round(v, 3) for k, v in split.items()})} ({card})")

    kernels, wall_us = _profile_window(torch, lambda: pipe.ground_video(path, q), 1)
    _profile_record("ground_vitb32_f32", card, 1, "dispatch", kernels, wall_us, ["flash_fwd"],
                    clips=len(got))
    return s.ground_launches, s.server_launches, {
        "towers": towers, "ground_video_ms": whole, "split": split, **s.server_stats}


def phase_resume(torch, np, card, fixture=RESUME_FIXTURE, label="resume"):
    """7l (7t with MOE_FIXTURE): resume_all from the JAX package's
    checkpoint (``fixture``) on the card: train/checkpoint.restore_checkpoint
    maps its params (either layout), optax state and step onto a fresh
    "pallas" model, AdamW's step lands on the card (capturable), and 2 f32
    steps on the fixture's batches meet JAX's recorded metrics at TRAIN_TOL,
    every metric it recorded. Returns (the path's launches, readings)."""
    from univtg_tpu_torch.models import ModelConfig, UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train import checkpoint as ckpt
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), fixture)
    with open(os.path.join(root, "expected.json")) as f:
        want = json.load(f)
    model = UniVTG(ModelConfig(**want["model"], attention_impl="pallas"), device="cuda",
                   seed=1)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*want["schedule"]), want["wd"],
                                             want["grad_clip"]))
    with np.load(os.path.join(root, "batches.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    _reset_launches()  # the resumed training path starts here
    state, epoch = ckpt.restore_checkpoint(os.path.join(root, "model_latest.ckpt"), state)
    steps_at = {(str(s["step"].device), float(s["step"]))
                for s in state.optimizer.adamw.state.values()}
    step = make_train_step(LossWeights(**want["weights"]))
    rel = []
    for i, w in enumerate(want["metrics"]):
        mi, tg = ({k.split("/")[2]: torch.from_numpy(v).cuda() for k, v in arrays.items()
                   if k.startswith(f"{i}/{part}/")} for part in ("model_inputs", "targets"))
        state, m = step(state, mi, tg, 1)
        if set(m) != set(w):
            raise AssertionError(f"the step's metrics {sorted(m)} are not JAX's {sorted(w)}")
        rel.append({k: abs(float(m[k]) - w[k]) / max(abs(w[k]), 1e-12) for k in w})
    torch.cuda.synchronize()
    launches = _launches()  # ... and ends here
    log(f"[{label}] {fixture}: epoch {epoch}, step {state.step - 2} restored, AdamW "
        f"step {sorted(steps_at)}; 2 f32 pallas steps vs JAX's recorded: rel {rel} (limits "
        f"{TRAIN_TOL}, loss's for every loss term); launches {launches} ({card})")
    n_layers = want["model"]["num_layers"]
    if (epoch, state.step) != (want["epoch"], want["step"] + 2) or steps_at != {
            (f"cuda:{torch.cuda.current_device()}", float(want["step"]))}:
        raise AssertionError(f"resume_all restored epoch {epoch}, step {state.step - 2}, "
                             f"AdamW steps {steps_at}")
    if any(v > TRAIN_TOL["grad_norm" if k == "grad_norm" else "loss"]
           for r in rel for k, v in r.items()):
        raise AssertionError(f"the resumed steps leave JAX's trajectory: {rel}")
    if {k: launches[k] for k in FLASH_KERNELS} != {k: 2 * n_layers for k in FLASH_KERNELS}:
        raise AssertionError(f"resumed steps launched {launches}")
    return launches, rel


def _blob_equal(torch, a, b):
    """Two checkpoint dicts equal, tensors bit for bit ("opt" aside)."""
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(
            k == "opt" or _blob_equal(torch, a[k], b[k]) for k in b)
    if isinstance(b, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def phase_async_ckpt(torch, np, card, tmp, corpus):
    """7m: `cli train-mr` at full width, bf16, "pallas", ASYNC_EPOCHS epochs
    each evaluated and checkpointed (latest and best), with
    async_checkpoint on (the default: train/checkpoint.AsyncCheckpointer)
    and off, cuDNN held deterministic: model_best.ckpt and
    model_latest.ckpt equal bit for bit; the host ms that each save blocks
    the loop (with the writer: the copy to the host; without: the whole
    write) and the writer's background ms. Returns (the writer run's
    launches, stats)."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.interop import read_checkpoint
    from univtg_tpu_torch.train import checkpoint as ckpt

    spent = {"save_blocking_ms": [], "write_ms": []}
    orig = {"async": ckpt.AsyncCheckpointer.save, "sync": ckpt.save_checkpoint,
            "write": ckpt._write_blob}

    def timing(fn, key):
        def timed_fn(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed_fn

    runs, stats = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for on in (True, False):
            run_dir = os.path.join(tmp, f"async_{on}")
            for v in spent.values():
                v.clear()
            ckpt.AsyncCheckpointer.save = timing(orig["async"], "save_blocking_ms")
            ckpt.save_checkpoint = timing(orig["sync"], "save_blocking_ms")
            ckpt._write_blob = timing(orig["write"], "write_ms")
            if on:
                _reset_launches()  # the writer's training path starts here
            t0 = time.perf_counter()
            try:
                cli.main(["train-mr", "--preset", "qvhighlights_mr",
                          f"train_data.data_path={corpus['train_path']}",
                          f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
                          f"train_data.q_feat_dir={corpus['q_feat_dir']}",
                          "train_data.v_feat_dim=2816", *_eval_overrides(corpus),
                          "eval_epoch=1", f"n_epoch={ASYNC_EPOCHS}", "bsz=32", "eval_bsz=32",
                          "model.attention_impl=pallas", "model.compute_dtype=bfloat16",
                          f"async_checkpoint={on}", f"results_dir={run_dir}"])
            finally:
                ckpt.AsyncCheckpointer.save = orig["async"]
                ckpt.save_checkpoint = orig["sync"]
                ckpt._write_blob = orig["write"]
            torch.cuda.synchronize()
            if on:
                launches = _launches()  # ... and ends here
            stats[f"async_{on}"] = {"wall_s": time.perf_counter() - t0,
                                    **{k: list(v) for k, v in spent.items()}}
            runs[on] = {n: read_checkpoint(os.path.join(run_dir, n))
                        for n in ("model_best.ckpt", "model_latest.ckpt")}
    finally:
        torch.backends.cudnn.deterministic = False
    equal = {n: _blob_equal(torch, runs[True][n], runs[False][n]) for n in runs[True]}
    opts = {on: runs[on]["model_latest.ckpt"]["opt"]["async_checkpoint"] for on in runs}
    log(f"[async ckpt] cli train-mr {ASYNC_EPOCHS} epochs, bf16 pallas, async_checkpoint "
        f"on/off: checkpoints equal {equal}, opt.json async_checkpoint {opts}; host ms a save "
        f"blocks the loop, with the writer {stats['async_True']['save_blocking_ms']} "
        f"(its background writes {stats['async_True']['write_ms']}), without "
        f"{stats['async_False']['save_blocking_ms']}; wall s "
        f"{stats['async_True']['wall_s']:.2f} / {stats['async_False']['wall_s']:.2f}; "
        f"launches {launches} ({card})")
    if not all(equal.values()) or opts != {True: True, False: False}:
        raise AssertionError("the background writer's checkpoints differ from the "
                             "synchronous writer's")
    if any(launches[k] == 0 for k in FLASH_KERNELS):
        raise AssertionError(f"train-mr with the writer skipped a kernel: {launches}")
    return launches, stats


def _hl_gang_cfg(job, results_dir):
    """The tvsum_hl run of phase 7o: the job's corpus overrides, HL_GANG_BSZ
    items a rank a step, HL_EPOCHS epochs each evaluated, "pallas", f32,
    dropouts 0."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.presets import PRESETS

    return cli.apply_overrides(PRESETS["tvsum_hl"](), [
        *job["overrides"], "model.attention_impl=pallas", "model.dropout=0.0",
        "model.droppath=0.0", "model.input_dropout=0.0", f"n_epoch={HL_EPOCHS}",
        "eval_epoch=1", f"bsz={HL_GANG_BSZ}", f"results_dir={results_dir}"])


def _hl_rank_loaders(cfg, domain, ranks, world):
    """(the domain's training set, the Loader of each rank of ``ranks``)."""
    import dataclasses

    from univtg_tpu_torch.data.hl import HLDataset, collate_hl
    from univtg_tpu_torch.data.loader import Loader

    ds = HLDataset(dataclasses.replace(cfg.data, domain=domain))
    ds.set_state("train")
    return ds, [Loader(ds, cfg.bsz, lambda items, pad_batch_to: collate_hl(
        items, cfg.data.max_q_l, cfg.data.max_v_l, pad_batch_to), shuffle=True,
        seed=cfg.seed, shard_index=r, num_shards=world) for r in ranks]


def hl_gang_worker(job, rank, world, torch, np):
    """One rank of phase 7o (a case of 7u's ``chip_smoke.py --dist-worker``
    gang, mode "mesh"): train_hl in the gang with every step's metrics recorded, its
    launches, scores and the final parameters' digest; then its step ms,
    collective host ms and idle share on its own shard's batches."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train import driver_hl
    from univtg_tpu_torch.train.epoch_runner import strip_meta

    base = job["results"]
    cfg = _hl_gang_cfg(job, os.path.join(base, f"hl_p{rank}"))
    built, steps = [], []
    make_model, make_step = driver_hl.UniVTG, driver_hl.make_train_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, mi, tg, seed):
            state, metrics = step(state, mi, tg, seed)
            steps.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        return run

    driver_hl.UniVTG = lambda *a, **k: built.append(make_model(*a, **k)) or built[-1]
    driver_hl.make_train_step = recording
    _reset_launches()  # this rank's share of the HL gang's path starts here
    t0 = time.perf_counter()
    scores = driver_hl.train_hl(cfg)
    torch.cuda.synchronize()
    out = {"rank": rank, "train_hl_s": time.perf_counter() - t0, "launches": _launches(),
           "scores": scores, "steps": steps,
           "digest": dist.tensor_digest(built[-1].state_dict().values())}
    driver_hl.UniVTG, driver_hl.make_train_step = make_model, make_step
    _, (loader,) = _hl_rank_loaders(cfg, job["domains"][0], [rank], world)
    batches = [tuple(to_device(t, "cuda") for t in strip_meta(b)) for b in loader]
    out["step"] = _gang_step_stats(torch, np, cfg, batches, cfg.seed + 1, use_gates=False)
    return out


def _hl_gang_job(tmp):
    """7o's part of 7u's gang job: phase 7f's corpus, its overrides and
    domains."""
    corpus, splits_path, domains = _hl_corpus(tmp)
    return {"overrides": _hl_overrides(corpus, splits_path), "domains": domains}


def phase_hl_gang(torch, np, card, tmp, job, tp_gang):
    """7o: train_hl in a gang of two gloo ranks sharing the card (the "hl"
    case of 7u's gang, ``tp_gang``) on phase 7f's TVSum-shaped
    corpus at full width, HL_GANG_BSZ items a rank a step, f32, "pallas",
    dropouts 0, cuDNN deterministic: every step's loss and grad norm
    against one process's make_train_step on the two shards' batches
    concatenated, from the same init, at TRAIN_TOL; the ranks' curves,
    parameters and scores equal; each rank's step ms, collective host ms
    and idle share. Returns (the launches of both ranks summed, stats)."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import make_train_step

    domains = job["domains"]
    ranks = [{"rank": r["rank"], **r["hl_gang"]} for r in tp_gang["ranks"]]
    outs = tp_gang["outs"]
    cfg = _hl_gang_cfg(job, os.path.join(tmp, "hl_one"))
    # the one-process run on the batches the gang assembles
    first = _hl_rank_loaders(cfg, domains[0], (0, 1), 2)[1][0]
    schedule = build_schedule(cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma,
                              max(1, len(first)))
    step = make_train_step(cfg.weights, tuple(cfg.losses))
    want = []
    torch.backends.cudnn.deterministic = True
    try:
        for domain in domains:
            _, loaders = _hl_rank_loaders(cfg, domain, (0, 1), 2)
            sd = UniVTG(cfg.model, device="cpu", seed=cfg.seed).state_dict()
            state = _scan_state(torch, cfg.model, sd, schedule)
            for epoch in range(cfg.n_epoch):
                for ld in loaders:
                    ld.set_epoch(epoch)
                for b0, b1 in zip(*loaders):
                    mi, tg = strip_meta({part: {k: np.concatenate([b0[part][k], b1[part][k]])
                                                for k in b0[part]}
                                         for part in ("model_inputs", "targets")})
                    want.append({k: float(v) for k, v in step(
                        state, to_device(mi, "cuda"), to_device(tg, "cuda"),
                        cfg.seed + 1)[1].items()})
    finally:
        torch.backends.cudnn.deterministic = False
    got = ranks[0]["steps"]
    rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in ("loss_overall", "grad_norm")}
           for g, w in zip(got, want)]
    launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
                for k in ranks[0]["launches"]}
    stats = {f"rank{r['rank']}": {"train_hl_s": r["train_hl_s"], **r["step"]} for r in ranks}
    log(f"[hl gang] two gloo ranks sharing the card, train_hl on {domains}, "
        f"{len(got)} steps a rank at {HL_GANG_BSZ} x 2 items: ranks' curves equal "
        f"{ranks[0]['steps'] == ranks[1]['steps']}, digests equal "
        f"{ranks[0]['digest'] == ranks[1]['digest']}, scores {ranks[0]['scores']} / "
        f"{ranks[1]['scores']}; vs one process on the assembled batches, rel per step "
        f"{rel} (limits {TRAIN_TOL}); launches of both ranks {launches}")
    log(f"[hl gang] per rank ({card}): {json.dumps(stats)}")
    if len(got) != len(want) or not want or any(
            r["loss_overall"] > TRAIN_TOL["loss"] or r["grad_norm"] > TRAIN_TOL["grad_norm"]
            for r in rel):
        raise AssertionError(f"the HL gang leaves the one-process curve: {rel}\n"
                             f"{outs[0][-2000:]}")
    if (ranks[0]["steps"] != ranks[1]["steps"] or ranks[0]["digest"] != ranks[1]["digest"]
            or ranks[0]["scores"] != ranks[1]["scores"]
            or set(ranks[0]["scores"]) != {*domains, "AVG"}):
        raise AssertionError("the HL gang's ranks disagree")
    if any(ranks[r]["launches"][k] == 0 for r in (0, 1) for k in FLASH_KERNELS):
        raise AssertionError(f"an HL rank skipped a kernel: {ranks}")
    return launches, stats


def phase_learning(torch, np, card, tmp):
    """7p: the planted-signal learning check (tools/validate_synthetic.py)
    at hidden LEARN_HIDDEN with the flagship's LEARN_HEADS heads, "pallas",
    the script's dropouts, corpus, optimizer and bar, LEARN_EPOCHS epochs,
    f32 and bf16, through train_mr: R1@0.5, R1@0.7, mIoU, MR mAP and HL mAP
    beside the JAX package's readings; each run must clear R1@0.5 > 50 and
    mIoU > 50. Returns (the f32 run's launches, readings)."""
    from univtg_tpu_torch.tools import validate_synthetic as vs
    from univtg_tpu_torch.train.driver_mr import train_mr

    readings, launches = {}, None
    for dname in ("float32", "bfloat16"):
        _, cfg = vs.build(os.path.join(tmp, f"learn_{dname}"), epochs=LEARN_EPOCHS,
                          hidden=LEARN_HIDDEN, num_heads=LEARN_HEADS,
                          attention_impl="pallas", compute_dtype=dname)
        if launches is None:
            _reset_launches()  # the learning check's training path starts here
        t0 = time.perf_counter()
        line = vs.summarize(*train_mr(cfg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if launches is None:
            launches = _launches()  # ... and ends here (f32)
        line.pop("best_ckpt")
        train_s = sum(e["time"] for e in _train_log(cfg.results_dir))
        readings[dname] = {**line, "wall_s": wall, "train_epochs_s": train_s,
                           "passed": vs.passed(line)}
        log(f"[learning] {dname} hidden {LEARN_HIDDEN}, {LEARN_HEADS} heads, {LEARN_EPOCHS} "
            f"epochs, pallas: {json.dumps(line)} in {wall:.1f} s, {train_s:.1f} s of it in "
            f"the training epochs ({card}); "
            f"{'PASSED' if vs.passed(line) else 'WEAK'} (bar {vs.BAR}); the JAX package's "
            f"readings {json.dumps(JAX_LEARNING)}")
    if not all(r["passed"] for r in readings.values()):
        raise AssertionError(f"the learning check is below its bar: {readings}")
    if any(launches[k] == 0 for k in FLASH_KERNELS):
        raise AssertionError(f"the learning check skipped a kernel: {launches}")
    return launches, readings


def _tf32(torch, on):
    """Both TF32 switches as phase_device found them (on) or off."""
    torch.backends.cuda.matmul.allow_tf32 = on and TF32_AS_FOUND["matmul"]
    torch.backends.cudnn.allow_tf32 = on and TF32_AS_FOUND["cudnn"]


def phase_tf32(torch, np, card, corpus, sd):
    """7q: the f32 comparisons of phases 4 (serving, B=2, 128 + 32), 7 (3
    train steps) and 7j (the CLIP towers on the card against the CPU,
    grounding) once more with TF32 as phase_device found it (torch's
    default: cudnn.allow_tf32 True): "pallas" against "xla" at their
    phases' limits, and each f32 result against the same run with TF32 off
    (what the switch still moves), at the same limits. Before the port held
    its f32 convolutions to f32 (device.exact_f32), serving, grounding and
    the CLIP image tower left their limits here. Returns the readings;
    fails where one leaves its limit."""
    import dataclasses

    from univtg_tpu_torch.extract.clip.model import CLIP, vit_b32
    from univtg_tpu_torch.extract.pipeline import ClipEncoder
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.serve import GroundingPipeline

    readings, failed = {}, []
    log(f"[tf32] as found: {TF32_AS_FOUND}")

    def serve_errs(got_all, want_all):
        pairs = [(np.asarray(g["topk_windows"]), np.asarray(w["topk_windows"]))
                 for g, w in zip(got_all, want_all)]
        sal = max(float(np.abs(np.asarray(g["saliency"]) - w["saliency"]).max())
                  for g, w in zip(got_all, want_all))
        ok = all(_unambiguous_ranks_agree(np, g, w, PIPE_TOL["float32"]["scores"],
                                          PIPE_TOL["float32"]["windows"])
                 for g, w in zip(got_all, want_all))
        return {"saliency": sal,
                "scores": max(float(np.abs(g[:, 2] - w[:, 2]).max()) for g, w in pairs),
                "windows_ties_included": max(float(np.abs(g[:, :2] - w[:, :2]).max())
                                             for g, w in pairs),
                "ranks_agree": ok, "ok": ok and sal <= PIPE_TOL["float32"]["saliency"]}

    # phase 4's f32 dispatch
    rng = np.random.default_rng(11)
    cfg = flagship_model(attention_impl="pallas")
    vids = [rng.standard_normal((75, cfg.vid_dim - 2)).astype(np.float32) for _ in range(2)]
    qs = [rng.standard_normal((int(rng.integers(4, 33)), cfg.txt_dim)).astype(np.float32)
          for _ in range(2)]
    res = {}
    for impl in ("pallas", "xla"):
        pipe = GroundingPipeline(flagship_model(attention_impl=impl), sd, eval_mode="add",
                                 device="cuda")
        items = [(pipe.prepare_video(v), q) for v, q in zip(vids, qs)]
        for on in (False, True):
            _tf32(torch, on)
            res[impl, on] = pipe.ground_prepared_many(items, top_k=10)
        _tf32(torch, False)
        del pipe
    readings["serving_pallas_vs_xla"] = serve_errs(res["pallas", True], res["xla", True])
    readings["serving_tf32_vs_off"] = serve_errs(res["pallas", True], res["pallas", False])

    # phase 7's three f32 train steps
    batches = _train_batches(np, corpus, 3)
    quiet = dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    runs = {}
    for impl, on in (("pallas", True), ("xla", True), ("pallas", False)):
        _tf32(torch, on)
        try:
            runs[impl, on] = _run_steps(torch, flagship_model(attention_impl=impl, **quiet),
                                        sd, batches)[1]
        finally:
            _tf32(torch, False)

    def train_errs(got, want):
        rel = {k: max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for g, w in zip(got, want))
               for k in ("loss_overall", "grad_norm")}
        return {**rel, "ok": rel["loss_overall"] <= TRAIN_TOL["loss"]
                and rel["grad_norm"] <= TRAIN_TOL["grad_norm"]}

    readings["train_pallas_vs_xla"] = train_errs(runs["pallas", True], runs["xla", True])
    readings["train_tf32_vs_off"] = train_errs(runs["pallas", True], runs["pallas", False])

    # 7j: the CLIP towers on the card against the CPU, and grounding
    clip_cfg = vit_b32()
    clip_sd = CLIP(clip_cfg, device="cpu", seed=0).state_dict()
    frames = np.random.default_rng(7).integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    texts = _ground_queries(np, 8)
    cpu = ClipEncoder(clip_sd, clip_cfg, image_batch=8, text_batch=8, device="cpu")
    want_img, (want_h, want_p) = cpu.encode_images(frames), cpu.encode_texts(texts)
    del cpu
    enc = ClipEncoder(clip_sd, clip_cfg, device="cuda")
    towers = {}
    for on in (False, True):
        _tf32(torch, on)
        try:
            h, pooled = enc.encode_texts(texts)
            towers[on] = {"image": _rel(np, enc.encode_images(frames), want_img),
                          "text": max(_rel(np, pooled, want_p),
                                      max(_rel(np, a, b) for a, b in zip(h, want_h)))}
        finally:
            _tf32(torch, False)
    readings["clip_card_vs_cpu"] = {
        **{f"{k}_tf32": v for k, v in towers[True].items()},
        **{f"{k}_off": v for k, v in towers[False].items()},
        "ok": max(towers[True].values()) <= CLIP_DEVICE_TOL}
    gcfg = dataclasses.replace(flagship_model(attention_impl="pallas"), vid_dim=514,
                               txt_dim=512)
    from univtg_tpu_torch.models import UniVTG

    gsd = UniVTG(gcfg, device="cpu", seed=0).state_dict()
    feats = np.random.default_rng(8).standard_normal((75, 512)).astype(np.float32)
    txts = [np.random.default_rng(9 + i).standard_normal((12, 512)).astype(np.float32)
            for i in range(4)]
    gres = {}
    for impl in ("pallas", "xla"):
        pipe = GroundingPipeline(dataclasses.replace(gcfg, attention_impl=impl), gsd,
                                 device="cuda")
        for on in (False, True):
            _tf32(torch, on)
            try:
                gres[impl, on] = [pipe.ground_features(feats, t) for t in txts]
            finally:
                _tf32(torch, False)
        del pipe
    readings["ground_pallas_vs_xla"] = serve_errs(gres["pallas", True], gres["xla", True])
    readings["ground_tf32_vs_off"] = serve_errs(gres["pallas", True], gres["pallas", False])
    for name, r in readings.items():
        log(f"[tf32] {name}: {json.dumps(r)}")
        if not r["ok"]:
            failed.append(name)
    log(f"[tf32] ({card}) limits: serving and grounding {PIPE_TOL['float32']}, training "
        f"{TRAIN_TOL}, CLIP card vs CPU {CLIP_DEVICE_TOL}; outside: {failed or 'none'}")
    if failed:
        raise AssertionError(f"with TF32 as found, {failed} leave their limits")
    return readings


def _ring_pairs(torch, np, n):
    """n distinct long batches (8 x 2048 clips + 32 tokens) on the card."""
    return [_long_batch(torch, np, seed=5 + i) for i in range(n)]


def _stack_pairs(torch, pairs):
    return tuple({k: torch.stack([p[part][k] for p in pairs]) for k in pairs[0][part]}
                 for part in (0, 1))


def _ring_scan_runs(torch, cfg, sd, pairs, ring):
    """RING_SCAN_GROUPS groups of RING_SCAN_K (eager, captured, replayed)
    under the ring, from one state, against as many eager single ring steps
    from another and from a third (is the eager step deterministic?):
    _compare_runs of each pair."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.parallel import use_ring
    from univtg_tpu_torch.train.steps import make_scan_train_step, make_train_step

    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    a, b, c = (_scan_state(torch, cfg, sd) for _ in range(3))
    scan, single = make_scan_train_step(weights), make_train_step(weights)
    got, want, again = [], [], []
    K = RING_SCAN_K
    with use_ring(ring):
        for g in range(RING_SCAN_GROUPS):
            group = [pairs[(g * K + i) % len(pairs)] for i in range(K)]
            got.append(scan(a, *_stack_pairs(torch, group), 0)[1])
            for mi, tg in group:
                want.append(single(b, mi, tg, 0)[1])
                again.append(single(c, mi, tg, 0)[1])
    return _compare_runs(torch, got, want, a, b), _compare_runs(torch, again, want, c, b)


def phase_ring_scan(torch, np, sd, card):
    """7n: scan_steps = RING_SCAN_K under use_ring(RingGroup(RING_P)) at
    8 x (2048 + 32), "ring_pallas", dropouts 0, bf16 and f32: the groups
    (eager, captured, replayed) against eager single ring steps, bit for
    bit by phase 7e's rule (within TRAIN_TOL and bit-equal again under
    cudnn.deterministic where the eager step does not equal itself); then ms
    per step of the captured ring step against the eager one. Returns (the
    path's launches, stats)."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.ops import attention as attn
    from univtg_tpu_torch.parallel import RingGroup, use_ring
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.steps import make_scan_train_step, make_train_step

    ring = RingGroup(RING_P)
    pairs = _ring_pairs(torch, np, RING_SCAN_K)
    quiet = dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    stats = {}
    launches = None
    for dname in ("bfloat16", "float32"):
        cfg = flagship_model(attention_impl="ring_pallas", compute_dtype=dname,
                             max_v_l=2048, **quiet)
        if launches is None:
            _reset_launches()  # the captured ring training path starts here
        diff, repeat = _ring_scan_runs(torch, cfg, sd, pairs, ring)
        if launches is None:
            torch.cuda.synchronize()
            launches = _launches()  # ... and ends here (bf16: scan and eager steps)
            ran = dict(attn.dispatches)
            steps = 2 * RING_SCAN_K * RING_SCAN_GROUPS + RING_SCAN_K * RING_SCAN_GROUPS
            want = {"ring_block": steps * 4 * RING_P * RING_P,
                    "ring_finish": steps * 4 * RING_P}
            log(f"[ring scan] bf16: launches {launches}, dispatches {ran}")
            # the capture counts nothing; each replay counts what it captured
            if {n: launches[n] for n in want} != want or ran["xla"]:
                raise AssertionError(f"ring scan: launches {launches}, dispatches {ran}, "
                                     f"expected {want} and no xla fallback")
        log(f"[ring scan] {dname} P={RING_P} K={RING_SCAN_K}, {RING_SCAN_GROUPS} groups "
            f"(eager, captured, replayed) vs eager ring steps: "
            f"{'bit-equal' if diff['equal'] else 'NOT bit-equal'} {diff}; eager twice: "
            f"{'bit-equal' if repeat['equal'] else 'NOT bit-equal'} {repeat}")
        if not diff["equal"] and (repeat["equal"]
                                  or diff["loss_overall_rel"] > TRAIN_TOL["loss"]
                                  or diff["grad_norm_rel"] > TRAIN_TOL["grad_norm"]):
            raise AssertionError(f"{dname} ring graph replay disagrees with eager ring "
                                 f"steps: {diff}")
        if not diff["equal"]:
            torch.backends.cudnn.deterministic = True
            try:
                diff, repeat = _ring_scan_runs(torch, cfg, sd, pairs, ring)
            finally:
                torch.backends.cudnn.deterministic = False
            log(f"[ring scan] {dname} again with cudnn.deterministic: replay vs eager "
                f"{'bit-equal' if diff['equal'] else 'NOT bit-equal'} {diff}; eager twice "
                f"{'bit-equal' if repeat['equal'] else 'NOT bit-equal'}")
            if repeat["equal"] and not diff["equal"]:
                raise AssertionError(f"{dname} ring graph replay disagrees with "
                                     f"deterministic eager ring steps: {diff}")
        torch.cuda.empty_cache()

        # ms per step: the captured ring step against the eager ring step
        weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
        timed_cfg = flagship_model(attention_impl="ring_pallas", compute_dtype=dname,
                                   max_v_l=2048)
        rec = {}
        with use_ring(ring):
            state = _scan_state(torch, timed_cfg, sd)
            scan = make_scan_train_step(weights)
            stacked = _stack_pairs(torch, pairs)
            rec["captured_ms"] = cuda_ms(lambda: scan(state, *stacked, 0),
                                         RING_SCAN_TIMED) / RING_SCAN_K
            del state, scan
            torch.cuda.empty_cache()
            state = _scan_state(torch, timed_cfg, sd)
            single = make_train_step(weights)
            mi, tg = pairs[0]
            rec["eager_ms"] = cuda_ms(lambda: single(state, mi, tg, 0), 2 * RING_SCAN_TIMED)
            del state
        torch.cuda.empty_cache()
        stats[dname] = {**rec, "replay_equal": diff["equal"]}
        log(f"[ring scan] {dname} B=8 L=2048+32 P={RING_P}, dropouts at the flagship's: "
            f"captured {rec['captured_ms']:.2f} ms a step, eager {rec['eager_ms']:.2f} ms "
            f"a step, CUDA events ({card})")
    return launches, stats


def _moe_model(**kw):
    """The flagship with MOE_OVERRIDES' options."""
    from univtg_tpu_torch.presets import flagship_model

    return flagship_model(moe_experts=4, moe_top_k=2, scan_layers=True, **kw)


def _record_routing(torch, records):
    """on_model for _run_steps: forward hooks on each MoE layer appending
    the routing it takes, (top-k experts (k, N), masked router
    probabilities (N, E)) on the host, to ``records``."""
    from univtg_tpu_torch.ops import moe

    def hook(mod, inputs, _):
        h, mask = inputs[0], inputs[1].reshape(-1)
        n, e = mask.shape[0], mod.router.shape[1]
        with torch.no_grad():
            probs = torch.softmax(h.reshape(n, -1).float() @ mod.router.float(), -1)
            cap = moe.moe_capacity(n, e, mod.top_k, mod.capacity_factor)
            r = moe.moe_routing(probs, e, mod.top_k, cap, mask, aux=False)
            records.append((r.expert.cpu(), (probs * mask.float()[:, None]).cpu()))

    def on_model(model):
        for layer in model.transformer.encoder.layers:
            layer.moe.register_forward_hook(hook)

    return on_model


def _routing_ties(torch, got, want):
    """Between two runs' routing records: (the tokens whose top-k choice
    differs, the largest of their near-tie gaps: |p_a - p_b| / max(p_a, p_b)
    of the two experts in ``want``'s probabilities)."""
    tokens, worst = 0, 0.0
    for (e_got, _), (e_want, p) in zip(got, want, strict=True):
        differ = e_got != e_want
        tokens += int(differ.any(0).sum())
        for k in range(differ.shape[0]):
            idx = differ[k].nonzero()[:, 0]
            if len(idx):
                a, b = p[idx, e_got[k, idx]], p[idx, e_want[k, idx]]
                worst = max(worst, ((a - b).abs() / torch.maximum(a, b)).max().item())
    return tokens, worst


def phase_moe(torch, np, card, tmp, corpus, sd):
    """7r: the MoE model at the flagship's width (MOE_OVERRIDES: 4
    experts, top-2, the scan layout) through its entry points on the flash
    kernels. `cli train-mr` on phase 7's corpus, bf16 then f32, MOE_EPOCHS
    epochs each evaluated: 4 launches of each kernel per step and 4 flash_fwd
    per eval batch, loss_moe_aux finite and in (0, E]. Then `cli infer-mr`
    (f32) on the f32 run's model_best.ckpt, `cli quantize` of it and `cli
    serve` from the int8 file (a subprocess, --config the MoE JSON, started
    before the holds below, which run while it builds its model) answering
    MOE_SERVE_QUERIES concurrent requests. Held (_moe_holds): 3 f32 steps at
    dropouts 0, "pallas" vs "xla" at TRAIN_TOL (loss_moe_aux at the loss's
    limit), a token whose top-2 choice differs between them allowed only
    within MOE_TIE_REL, counted; make_scan_train_step K = 2 replays against
    eager steps by 7e's rule, f32 and bf16. Timed: ms per step, K = 1
    (eager) and 2 (captured), bf16 and f32, and the peak memory, MoE beside
    the dense flagship (phase 7's weights), dropouts at the defaults.
    Returns (the training path's launches, the inference path's, readings)."""
    import contextlib
    import io

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.models import UniVTG

    eval_batches = -(-N_VAL // 32)
    runs = {}
    _reset_launches()  # the MoE training path starts here
    for dname in ("bfloat16", "float32"):
        run_dir = os.path.join(tmp, f"moe_run_{dname}")
        t0 = time.perf_counter()
        cli.main(["train-mr", "--preset", "qvhighlights_mr",
                  f"train_data.data_path={corpus['train_path']}",
                  f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
                  f"train_data.q_feat_dir={corpus['q_feat_dir']}",
                  "train_data.v_feat_dim=2816", *_eval_overrides(corpus), "eval_epoch=1",
                  f"n_epoch={MOE_EPOCHS}", "bsz=32", "eval_bsz=32",
                  "model.attention_impl=pallas", f"model.compute_dtype={dname}",
                  *MOE_OVERRIDES, f"results_dir={run_dir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = _jsonl(os.path.join(run_dir, "train_log.jsonl"))
        evals = _jsonl(os.path.join(run_dir, "eval_log.jsonl"))
        steps = sum(line["steps"] for line in lines)
        aux = [line["loss_moe_aux"] for line in lines]
        log(f"[moe] cli train-mr {dname} {' '.join(MOE_OVERRIDES)}: {steps} steps in "
            f"{len(lines)} epochs, epoch 0 {lines[0]['time']:.2f} s, {wall:.2f} s with model "
            f"build and {len(evals)} evaluations ({card}); losses "
            f"{[round(x['loss_overall'], 4) for x in lines]}, loss_moe_aux {aux}, MR-full-mAP "
            f"{[e['MR-full-mAP-key'] for e in evals]}")
        if (steps != 3 * MOE_EPOCHS or len(evals) != MOE_EPOCHS
                or not all(np.isfinite(x["loss_overall"]) for x in lines)):
            raise AssertionError(f"MoE train-mr {dname} did not take 3 finite steps an "
                                 f"epoch with an evaluation each: {lines}")
        if not all(np.isfinite(a) and 0 < a <= 4 for a in aux):
            raise AssertionError(f"loss_moe_aux outside (0, E]: {aux}")
        runs[dname] = run_dir
    launches = _launches()  # ... and ends here
    steps = 3 * MOE_EPOCHS * len(runs)
    want = {name: 4 * steps for name in FLASH_KERNELS}
    want["flash_fwd"] += 4 * eval_batches * MOE_EPOCHS * len(runs)
    log(f"[moe] training path launches {launches}")
    if {k: launches[k] for k in FLASH_KERNELS} != want:
        raise AssertionError(f"expected 4 launches of each kernel per step and 4 flash_fwd "
                             f"per eval batch: {launches}, not {want}")

    best = os.path.join(runs["float32"], "model_best.ckpt")
    _reset_launches()  # the MoE inference and int8 path starts here
    int8_path = os.path.join(tmp, "moe_int8.ckpt")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["quantize", "--preset", "qvhighlights_mr", "--resume", best,
                  "--out", int8_path, *MOE_OVERRIDES])
    config = os.path.join(tmp, "moe_model.json")
    with open(config, "w") as f:
        f.write(_moe_model(attention_impl="pallas").to_json())
    # cli serve builds its model in its own process while this one runs
    # infer-mr and holds pallas against xla and the replays (checks of bits,
    # not of time)
    serve_t0 = time.perf_counter()
    server = _start_serve(int8_path, tmp, config=config)
    try:
        brief, _, infer_launches, wall = _infer_mr(torch, np, tmp, best, corpus, "moe_f32",
                                                   "pallas", "float32", *MOE_OVERRIDES)
    except BaseException:
        _kill_gang([server])
        raise
    infer_path = _launches()  # ... and ends here (cli serve counts in its own process)
    if infer_launches != 4 * eval_batches:
        _finish_serve(np, server, MOE_SERVE_QUERIES)
        raise AssertionError(f"MoE infer-mr made {infer_launches} flash_fwd launches")
    try:
        _moe_holds(torch, np, corpus)
    except BaseException:
        _kill_gang([server])
        raise
    answers = _finish_serve(np, server, MOE_SERVE_QUERIES)
    serve_s = time.perf_counter() - serve_t0
    for answer in answers:
        _check_result(np, answer, 75)
    log(f"[moe] cli infer-mr f32: {infer_launches} flash_fwd launches, {wall:.2f} s with "
        f"model build; {printed.getvalue().strip()}; cli serve --config on the int8 file: "
        f"{len(answers)} concurrent answers, top-1 windows "
        f"{[a['top1_window'] for a in answers]} ({serve_s:.1f} s from its start, the "
        f"holds above run meanwhile); path launches {infer_path}")

    moe_sd = UniVTG(_moe_model(), device="cpu", seed=0).state_dict()
    stats = _moe_timings(torch, card, sd, moe_sd, _train_batches(np, corpus, 3))
    log(f"[moe] ({card}) {json.dumps(stats)}")
    return launches, infer_path, stats


def _moe_holds(torch, np, corpus):
    """f32 "pallas" against "xla", 3 steps at dropouts 0 with the routing
    recorded (TRAIN_TOL; a token routed otherwise only within MOE_TIE_REL),
    then scan replays against eager steps in f32 and bf16 (_hold_replay)."""
    from univtg_tpu_torch.models import UniVTG

    moe_sd = UniVTG(_moe_model(), device="cpu", seed=0).state_dict()
    batches = _train_batches(np, corpus, 3)
    quiet = dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    routes, hist = {}, {}
    for impl in ("pallas", "xla"):
        routes[impl] = []
        hist[impl] = _run_steps(torch, _moe_model(attention_impl=impl, **quiet), moe_sd,
                                batches, on_model=_record_routing(torch, routes[impl]))[1]
    ties, worst = _routing_ties(torch, routes["pallas"], routes["xla"])
    n_routed = sum(int((p.sum(-1) > 0).sum()) for _, p in routes["xla"])
    for i, (got, w) in enumerate(zip(hist["pallas"], hist["xla"], strict=True)):
        rel = {k: abs(got[k] - w[k]) / max(abs(w[k]), 1e-12)
               for k in ("loss_overall", "loss_moe_aux", "grad_norm")}
        log(f"[moe] f32 step {i}: pallas loss {got['loss_overall']:.6f} aux "
            f"{got['loss_moe_aux']:.6f} grad norm {got['grad_norm']:.6f}; rel err vs xla "
            f"{rel} (limits {TRAIN_TOL})")
        if (max(rel["loss_overall"], rel["loss_moe_aux"]) > TRAIN_TOL["loss"]
                or rel["grad_norm"] > TRAIN_TOL["grad_norm"]):
            raise AssertionError(f"f32 MoE pallas step {i} disagrees with xla: {rel}")
    log(f"[moe] routing, pallas vs xla over 3 steps x 4 layers: {ties} of {n_routed} "
        f"routed tokens chose otherwise, the largest near-tie gap among them {worst:.3g} "
        f"(limit MOE_TIE_REL {MOE_TIE_REL})")
    if worst > MOE_TIE_REL:
        raise AssertionError(f"a token's top-2 choice differs beyond a near-tie: {worst}")
    for dname in ("float32", "bfloat16"):
        _hold_replay(torch, "moe", _moe_model(attention_impl="pallas", compute_dtype=dname,
                                              **quiet), moe_sd, batches)
        torch.cuda.empty_cache()


def _moe_timings(torch, card, sd, moe_sd, batches):
    """ms a step of the dense and the MoE flagship, bf16 and f32, K = 1 (one
    step profiled) and 2."""
    from univtg_tpu_torch.presets import flagship_model

    stats = {}
    for dname in ("bfloat16", "float32"):
        for name, cfg, weights in (
                ("dense", flagship_model(attention_impl="pallas", compute_dtype=dname), sd),
                ("moe", _moe_model(attention_impl="pallas", compute_dtype=dname), moe_sd)):
            for K in (1, 2):
                rec, one_call = _time_scan(torch, cfg, weights, batches, K, MOE_TIMED_STEPS)
                top = ""
                if K == 1:  # where the eager step's device time goes
                    us, _, wall_us = _profile_counts(torch, one_call)
                    rec.update(profiled_host_ms=wall_us / 1e3,
                               profiled_busy_ms=sum(us.values()) / 1e3)
                    items = sorted(us.items(), key=lambda kv: -kv[1])[:6]
                    top = (f"; one step profiled: host {wall_us / 1e3:.2f} ms, busy "
                           f"{rec['profiled_busy_ms']:.2f} ms, the largest items "
                           f"{[(k[:60], round(v / 1e3, 3)) for k, v in items]}")
                stats[f"{name}_{dname}_K{K}"] = rec
                log(f"[moe] {name} {dname} K={K}: {rec['cuda_ms']:.2f} ms per step by CUDA "
                    f"events ({rec['wall_ms']:.2f} wall) over {rec['steps']} steps, peak "
                    f"{rec['peak_gib']:.2f} GiB ({card}){top}")
                torch.cuda.empty_cache()
    return stats


def phase_remat_long(torch, np, fa, card, corpus, sd):
    """7s: make_train_step at 8 x (2048 + 32) (phase 8's batch), bf16 and
    f32, "pallas", dropouts at the flagship's defaults, one generator seed,
    remat on against off, cuDNN deterministic (as 9c): loss, grad norm and
    params after 2 steps held bit-equal, the largest differences printed;
    then 3 steps timed by CUDA events, and the peak memory over the 5. The
    remat runs are the remat training path: 8 flash_fwd (the forward and its
    recompute), 4 dQ and 4 dK/dV launches a step. Then make_scan_train_step
    K = 2 of the remat step (dropouts 0) against its eager steps by 7e's
    rule, on phase 7's batches. Returns (the path's launches, readings)."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import make_train_step

    batch = _long_batch(torch, np)
    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    dtypes = ("bfloat16", "float32")

    def run(dname, remat):
        cfg = flagship_model(attention_impl="pallas", compute_dtype=dname, max_v_l=2048,
                             remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        holder = {"state": _scan_state(torch, cfg, sd,
                                       schedule=build_schedule(1e-4, 10, 200, 0.1, 100))}
        step = make_train_step(weights)
        before = dict(fa.launches)
        metrics = [step(holder["state"], *batch, 0)[1] for _ in range(2)]
        torch.cuda.synchronize()
        made = {n: (fa.launches[n] - before[n]) / 2 for n in before}
        held = ({k: torch.stack([m[k] for m in metrics]) for k in ("loss_overall",
                                                                    "grad_norm")},
                [p.detach().clone() for p in holder["state"].model.parameters()])

        def one():
            step(holder["state"], *batch, 0)

        ms = cuda_ms(one, iters=3, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del holder
        return held, {"ms": ms, "peak_gib": peak, "launches_per_step": made}

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = {d: run(d, False) for d in dtypes}
        _reset_launches()  # the remat training path starts here
        remat = {d: run(d, True) for d in dtypes}
        launches = _launches()  # ... and ends here
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = was
    stats = {}
    for d in dtypes:
        (pm, pp), prec = plain[d]
        (rm, rp), rrec = remat[d]
        diff = {k: (rm[k] - pm[k]).abs().max().item() for k in pm}
        diff["params"] = max((a - b).abs().max().item() for a, b in zip(rp, pp))
        equal = all(torch.equal(rm[k], pm[k]) for k in pm) and all(
            torch.equal(a, b) for a, b in zip(rp, pp))
        stats[d] = {"remat": rrec, "plain": prec, "max_diff": diff, "bit_equal": equal}
        log(f"[remat] {d} 8 x (2048 + 32), dropouts at the defaults, 2 steps remat on vs "
            f"off: {'bit-equal' if equal else 'NOT bit-equal'}, largest differences {diff}; "
            f"ms per step {rrec['ms']:.2f} on, {prec['ms']:.2f} off; peak "
            f"{rrec['peak_gib']:.2f} GiB on, {prec['peak_gib']:.2f} off; flash launches a "
            f"step {rrec['launches_per_step']} on, {prec['launches_per_step']} off ({card})")
        if not equal:
            raise AssertionError(f"{d} remat changed the step: {diff}")
        if (rrec["launches_per_step"] != {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
                or prec["launches_per_step"] != {n: 4 for n in FLASH_KERNELS}):
            raise AssertionError(f"{d} flash launches a step: {rrec['launches_per_step']} "
                                 f"with remat, {prec['launches_per_step']} without")
    del plain, remat
    torch.cuda.empty_cache()
    batches = _train_batches(np, corpus, 3)
    quiet = dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    for d in ("float32", "bfloat16"):
        _hold_replay(torch, "remat", flagship_model(attention_impl="pallas", compute_dtype=d,
                                                    remat=True, **quiet), sd, batches)
        torch.cuda.empty_cache()
    log(f"[remat] ({card}) {json.dumps(stats)}")
    return launches, stats


# ---- phases 7u, 7v, 7w: model parallelism across processes ------------------


def _timed_mesh_collectives(torch, pm, ring_mod):
    """Wrap the mesh's collectives (parallel/mesh.py: all-reduce, all-gather,
    reduce-scatter) and the process ring's hop with host timers that
    synchronize first; returns (seconds by name, undo). The step's own
    autograd functions call them by module attribute, so the wrap sees
    every one."""
    spent = {}
    orig = {name: getattr(pm, name) for name in ("all_reduce", "all_gather",
                                                 "reduce_scatter")}
    hop = ring_mod.ProcessRing.post_hop

    def wrap(name, fn):
        def timed_fn(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed_fn

    def timed_hop(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wait = hop(self, *a, **k)
        spent["hop_post"] = spent.get("hop_post", 0.0) + time.perf_counter() - t0

        def timed_wait():
            t1 = time.perf_counter()
            out = wait()
            spent["hop_wait"] = spent.get("hop_wait", 0.0) + time.perf_counter() - t1
            return out
        return timed_wait

    for name, fn in orig.items():
        setattr(pm, name, wrap(name, fn))
    ring_mod.ProcessRing.post_hop = timed_hop

    def undo():
        for n, f in orig.items():
            setattr(pm, n, f)
        ring_mod.ProcessRing.post_hop = hop
    return spent, undo


def _mesh_step_state(torch, cfg, mesh, lr_steps=100):
    """A seeded model (seed 0, built whole on the card, then put on the mesh)
    and its optimizer, as _long_step builds them."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer

    model = pm.shard_model(UniVTG(cfg, device="cuda", seed=0), mesh)
    return TrainState(model, make_optimizer(
        model.parameters(), build_schedule(1e-4, 10, 200, 0.1, lr_steps), 1e-4, 0.1))


def _mesh_train_mr(job, rank, torch, np):
    """7u(i): train_mr in the tp gang on phase 7's corpus, every step's
    metrics recorded, the launches of this rank's share of the path."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.train import driver_mr

    steps = []
    make_step = driver_mr.make_train_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, mi, tg, seed):
            state, metrics = step(state, mi, tg, seed)
            steps.append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return run

    cfg = cli.apply_overrides(_mesh_mr_cfg(job), [f"results_dir={job['results']}/p{rank}"])
    driver_mr.make_train_step = recording
    try:
        _reset_launches()  # this rank's share of the tp training path starts here
        t0 = time.perf_counter()
        driver_mr.train_mr(cfg)
        torch.cuda.synchronize()
        launches = _launches()  # ... and ends here
    finally:
        driver_mr.make_train_step = make_step
    evals = _jsonl(os.path.join(cfg.results_dir, "eval_log.jsonl")) if rank == 0 else []
    return {"train_mr_s": time.perf_counter() - t0, "steps": steps, "launches": launches,
            "evals": evals}


def _mesh_mr_cfg(job):
    """The qvhighlights_mr run of 7u(i): phase 7's corpus, B = 32, one epoch
    evaluated, f32, "pallas", dropouts 0, tp = job's."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.presets import PRESETS

    corpus = job["corpus"]
    return cli.apply_overrides(PRESETS["qvhighlights_mr"](), [
        f"train_data.data_path={corpus['train_path']}",
        f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
        f"train_data.q_feat_dir={corpus['q_feat_dir']}", "train_data.v_feat_dim=2816",
        *_eval_overrides(corpus), "eval_epoch=1", "n_epoch=1", "bsz=32", "eval_bsz=32",
        "model.attention_impl=pallas", "model.compute_dtype=float32", "model.dropout=0.0",
        "model.droppath=0.0", "model.input_dropout=0.0", f"tp={job['tp']}",
        "async_checkpoint=False"])


def _mesh_long_steps(job, rank, torch, np):
    """7u(ii): make_train_step at 8 x (2048 + 32) on the tp mesh, seq_shard
    off and on, bf16 at the flagship's dropouts and f32 at dropouts 0: ms
    per step by CUDA events, peak memory, flash launches a step, host ms
    inside the collectives a step, the loss ("timed"); the f32 warm step,
    the first from the seed, gives the loss and grad norm that the parent
    holds against one process ("exact")."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.ops import flash_attention as fa
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import ring as ring_mod
    from univtg_tpu_torch.presets import flagship_model
    from univtg_tpu_torch.train.steps import make_train_step

    mesh = pm.make_mesh(1, job["tp"], 1)
    mi, tg = _long_batch(torch, np)
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    out, exact = {}, {}
    for dname in ("bfloat16", "float32"):
        for seq in (False, True):
            cfg = flagship_model(attention_impl="pallas", compute_dtype=dname,
                                 max_v_l=2048, seq_shard=seq)
            if dname == "float32":
                cfg = _exact_long_cfg(seq)
            holder = {"state": _mesh_step_state(torch, cfg, mesh)}

            def one():
                holder["state"], holder["m"] = step(holder["state"], mi, tg, 0)

            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dict(fa.launches)
            spent, undo = _timed_mesh_collectives(torch, pm, ring_mod)
            try:
                one()  # the warm step, its collectives timed
            finally:
                undo()
            if dname == "float32":  # the first step from the seed, at dropouts 0
                exact[f"seq{int(seq)}"] = {k: float(holder["m"][k])
                                           for k in ("loss_overall", "grad_norm")}
            ms = cuda_ms(one, iters=MESH_TIMED_STEPS, warmup=0)
            made = {k: (fa.launches[k] - before[k]) / (MESH_TIMED_STEPS + 1) for k in before}
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[f"{dname}_seq{int(seq)}"] = {
                "ms": ms, "peak_gib": peak, "launches_a_step": made,
                "collective_host_ms": {k: v * 1e3 for k, v in spent.items()},
                "loss": float(holder["m"]["loss_overall"])}
            del holder
    return {"timed": out, "exact": exact}


def _exact_long_cfg(seq_shard):
    """The flagship at 8 x (2048 + 32), f32, "pallas", every dropout 0."""
    from univtg_tpu_torch.presets import flagship_model

    return flagship_model(attention_impl="pallas", compute_dtype="float32", max_v_l=2048,
                          seq_shard=seq_shard, dropout=0.0, droppath=0.0, input_dropout=0.0)


def _routing_recorder(torch, records, grad_only=False):
    """Wrap ops/moe.moe_routing to record each call's top-k experts and
    masked probabilities on the host (in a gang each rank routes the
    global batch, so its records are the global routing; ``grad_only``:
    the calls under autograd alone, a 1F1B stage's recomputes); returns
    undo."""
    from univtg_tpu_torch.ops import moe

    orig = moe.moe_routing

    def recording(probs, n_experts, top_k, capacity, token_mask=None, aux=True):
        r = orig(probs, n_experts, top_k, capacity, token_mask=token_mask, aux=aux)
        if grad_only and not torch.is_grad_enabled():
            return r
        mask = torch.ones(probs.shape[0], device=probs.device) if token_mask is None \
            else token_mask.float()
        records.append((r.expert.detach().cpu(),
                        (probs.detach() * mask[:, None]).cpu()))
        return r

    moe.moe_routing = recording
    return lambda: setattr(moe, "moe_routing", orig)


def _mesh_moe(job, case, rank, torch, np):
    """7w: the MoE flagship on a (dp, tp, ep) mesh, f32, "pallas", dropouts 0,
    the steps of _run_steps on the global batches at job["moe_batches"]
    (each dp row its half), from job["moe_init"]; every step's metrics and
    the global routing records; then this rank's ms per step."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    mesh = pm.make_mesh(*case["mesh"])
    model = UniVTG(_moe_model(attention_impl="pallas", dropout=0.0, droppath=0.0,
                              input_dropout=0.0), device="meta")
    model.load_state_dict({k: v.cuda() for k, v in torch.load(job["moe_init"]).items()},
                          assign=True)
    pm.shard_model(model, mesh)
    state = TrainState(model, make_optimizer(
        model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 3), 1e-4, 0.1))
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    batches = []
    for batch in torch.load(job["moe_batches"], weights_only=False):
        mi, tg = (to_device(t, "cuda") for t in strip_meta(batch))
        n = mi["src_vid"].shape[0] // mesh.dp.size
        rows = slice(mesh.dp.index * n, (mesh.dp.index + 1) * n)
        batches.append(({k: v[rows] for k, v in mi.items()},
                        {k: v[rows] for k, v in tg.items()}))
    records, history = [], []
    undo = _routing_recorder(torch, records)
    _reset_launches()  # this rank's share of the MoE gang's path starts here
    try:
        for mi, tg in batches:
            state, m = step(state, mi, tg, 0)
            history.append({k: float(v) for k, v in m.items()})
    finally:
        undo()
    torch.cuda.synchronize()
    launches = _launches()  # ... and ends here
    it = iter(range(10 ** 6))

    def one():
        step(state, *batches[next(it) % len(batches)], 0)

    ms = cuda_ms(one, iters=MESH_TIMED_STEPS, warmup=1)
    if rank == 0:
        torch.save(records, os.path.join(job["results"], f"{case['name']}_routing.pt"))
    return {"steps": history, "launches": launches, "ms": ms}


def _mesh_ring_ops(job, rank, torch, np):
    """7v(i): ring_attention_pallas over the tp axis as a ProcessRing at
    8 x 2080 (8 heads of 128), f32 and bf16: each process its 1/P of the
    seeded q, k, v and mask; the launches, ms a call (CUDA events) and the
    host ms in the hops a call; rank 0 gathers the output and holds it
    against the one-process RingGroup(P) on the same inputs."""
    from univtg_tpu_torch.ops import ring_attention_pallas as rap
    from univtg_tpu_torch.parallel import RingGroup
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import ring as ring_mod

    mesh = pm.make_mesh(1, job["ring_p"], 1)
    ring = ring_mod.ProcessRing(mesh.tp, mesh.tp_ranks())
    B, L, H, dh = MESH_RING_SHAPE
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = _attention_inputs(torch, B, L, H, dh, dtype, seed=3)
        mask[-1] = 0
        blk = [t.chunk(ring.size, dim=1)[ring.rank].contiguous() for t in (q, k, v, mask)]
        before = dict(rap.launches)
        got = rap.ring_attention_pallas(*blk, num_heads=H, ring=ring)
        torch.cuda.synchronize()
        made = {n: rap.launches[n] - before[n] for n in before}
        ms = cuda_ms(lambda: rap.ring_attention_pallas(*blk, num_heads=H, ring=ring),
                     iters=MESH_TIMED_STEPS, warmup=1)
        spent, undo = _timed_mesh_collectives(torch, pm, ring_mod)
        try:
            rap.ring_attention_pallas(*blk, num_heads=H, ring=ring)
        finally:
            undo()
        whole = pm.all_gather(got, mesh.tp, 1)
        rec = {"launches": made, "ms": ms,
               "hop_host_ms": {k: v * 1e3 for k, v in spent.items()}}
        if rank == 0:
            one = rap.ring_attention_pallas(q, k, v, mask, num_heads=H,
                                            ring=RingGroup(ring.size))
            torch.cuda.synchronize()
            rec["max_abs_diff"] = (whole.float() - one.float()).abs().max().item()
            rec["bit_equal"] = bool(torch.equal(whole, one))
        out[str(dtype)[6:]] = rec
    return out


def _long_ring_cfg(impl, dtype="float32", **kw):
    """The flagship at 8 x (2048 + 32) with ``impl``, dropouts 0."""
    from univtg_tpu_torch.presets import flagship_model

    return flagship_model(attention_impl=impl, compute_dtype=dtype, max_v_l=2048,
                          dropout=0.0, droppath=0.0, input_dropout=0.0, **kw)


def _long_ring_steps(torch, np, impl, mesh, n=MESH_RING_STEPS):
    """n f32 make_train_steps on the long batch from the flagship's seed-0
    weights (dropouts 0) on ``mesh`` (None: one process); every step's
    metrics."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train.steps import make_train_step

    mi, tg = _long_batch(torch, np)
    step = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    state = _mesh_step_state(torch, _long_ring_cfg(impl), mesh)
    history = []
    for _ in range(n):
        state, m = step(state, mi, tg, 0)
        history.append({k: float(v) for k, v in m.items()})
    return history


def _mesh_ring_train(job, rank, torch, np):
    """7v(ii): the f32 train steps at 8 x (2048 + 32) with "ring_pallas" on
    the tp mesh (the tp ranks are the ring), the ring launches of this
    process (the parent runs the "xla" reference alone)."""
    from univtg_tpu_torch.ops import attention as attn
    from univtg_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(1, job["ring_p"], 1)
    _reset_launches()  # this process's share of the ring training path starts here
    t0 = time.perf_counter()
    got = _long_ring_steps(torch, np, "ring_pallas", mesh)
    torch.cuda.synchronize()
    launches = _launches()  # ... and ends here
    return {"steps": got, "launches": launches, "dispatches": dict(attn.dispatches),
            "s": time.perf_counter() - t0}


def _pp_model_cfg(case, dtype="float32", **kw):
    """The flagship of a 7x case in the scan layout, "pallas", pipelined over
    the case's pp stages, M microbatches and interleave; ``moe``: 7r's MoE
    configuration; ``drop``: the flagship's dropouts, else all 0."""
    from univtg_tpu_torch.presets import flagship_model

    rates = {} if case.get("drop") else dict(dropout=0.0, droppath=0.0, input_dropout=0.0)
    make = _moe_model if case.get("moe") else (
        lambda **k: flagship_model(scan_layers=True, **k))
    return make(attention_impl="pallas", compute_dtype=dtype,
                pipeline_stages=case["mesh"][4], pipeline_microbatches=case["M"],
                pipeline_interleave=case.get("v", 1), **rates, **kw)


def _pp_counters(torch, pipe, model, caught):
    """What shows that the pipeline ran on this rank: the engines' ticks,
    idle ticks, hops and saved inputs, the parameters and layers it holds,
    and any fallback warning."""
    layers = sorted({int(k.split(".")[3]) for k in model.state_dict()
                     if k.startswith("transformer.encoder.layers.")})
    return {"pipe": dict(pipe.stats), "n_params": sum(p.numel() for p in model.parameters()),
            "layers": layers,
            "fallback": [str(w.message) for w in caught if "sequential scan" in str(w.message)]}


def _pp_train_mr(job, rank, torch, np):
    """7x(a): train_mr at dp = 2 x pp = 2 (GPipe) on phase 7's corpus, every
    step's metrics, this rank's launches and pipeline counters, rank 0's
    evaluations (a local non-pipeline copy on the gathered parameters)."""
    import warnings

    from univtg_tpu_torch import cli
    from univtg_tpu_torch.parallel import pipeline as pipe
    from univtg_tpu_torch.train import driver_mr

    steps, models = [], []
    make_step, build = driver_mr.make_train_step, driver_mr.build_model

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, mi, tg, seed):
            state, metrics = step(state, mi, tg, seed)
            steps.append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return run

    cfg = cli.apply_overrides(_pp_mr_cfg(job), [f"results_dir={job['results']}/p{rank}"])
    driver_mr.make_train_step = recording
    driver_mr.build_model = lambda *a, **k: models.append(build(*a, **k)) or models[-1]
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pipe.reset_stats()
            _reset_launches()  # this rank's share of the GPipe training path starts here
            t0 = time.perf_counter()
            driver_mr.train_mr(cfg)
            torch.cuda.synchronize()
            launches = _launches()  # ... and ends here
    finally:
        driver_mr.make_train_step, driver_mr.build_model = make_step, build
    evals = _jsonl(os.path.join(cfg.results_dir, "eval_log.jsonl")) if rank == 0 else []
    return {"train_mr_s": time.perf_counter() - t0, "steps": steps, "launches": launches,
            "evals": evals, **_pp_counters(torch, pipe, models[0], caught)}


def _pp_mr_cfg(job):
    """The qvhighlights_mr run of 7x(a): phase 7's corpus, B = 32 global (16 a
    dp row), one epoch evaluated, f32, "pallas", dropouts 0, the flagship in
    the scan layout on dp = 2 x pp = 2, 2 microbatches."""
    from univtg_tpu_torch import cli
    from univtg_tpu_torch.presets import PRESETS

    corpus = job["corpus"]
    return cli.apply_overrides(PRESETS["qvhighlights_mr"](), [
        f"train_data.data_path={corpus['train_path']}",
        f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
        f"train_data.q_feat_dir={corpus['q_feat_dir']}", "train_data.v_feat_dim=2816",
        *_eval_overrides(corpus), "eval_epoch=1", "n_epoch=1", "bsz=16", "eval_bsz=32",
        "model.attention_impl=pallas", "model.compute_dtype=float32", "model.dropout=0.0",
        "model.droppath=0.0", "model.input_dropout=0.0", "model.scan_layers=true",
        "model.pipeline_stages=2", "model.pipeline_microbatches=2", "pp=2",
        "async_checkpoint=False"])


def _pp_steps(job, case, rank, torch, np):
    """7x(b) and (c): PP_STEPS steps of a pipelined flagship from the seed-0
    weights at job["pp_init"] (7r's MoE model's at job["moe_init"]) on the
    global batches at job["pp_batches"], each dp row its half: 1F1B
    (make_1f1b_train_step) or, with ``drop``, GPipe (make_train_step) at the
    flagship's dropouts. Every step's metrics, this rank's launches and
    pipeline counters; for MoE the routing of each backward recompute (the
    grad-enabled calls: one per block and layer, in the blocks' order)."""
    import warnings

    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import pipeline as pipe
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step
    from univtg_tpu_torch.train.steps_1f1b import make_1f1b_train_step

    mesh = pm.make_mesh(*case["mesh"])
    model = UniVTG(_pp_model_cfg(case), device="meta")
    init = job["moe_init"] if case.get("moe") else job["pp_init"]
    model.load_state_dict({k: v.cuda() for k, v in torch.load(init).items()}, assign=True)
    pm.shard_model(model, mesh)
    state = TrainState(model, make_optimizer(
        model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 3), 1e-4, 0.1))
    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    step = (make_train_step(weights) if case.get("drop")
            else make_1f1b_train_step(weights, n_micro=case["M"]))
    batches = []
    for batch in torch.load(job["pp_batches"], weights_only=False)[:PP_STEPS]:
        mi, tg = (to_device(t, "cuda") for t in strip_meta(batch))
        n = mi["src_vid"].shape[0] // mesh.dp.size
        rows = slice(mesh.dp.index * n, (mesh.dp.index + 1) * n)
        batches.append(({k: v[rows] for k, v in mi.items()},
                        {k: v[rows] for k, v in tg.items()}))
    records, history = [], []
    undo = (_routing_recorder(torch, records, grad_only=True) if case.get("moe")
            else (lambda: None))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pipe.reset_stats()
            _reset_launches()  # this rank's share of the case's path starts here
            for mi, tg in batches:
                state, m = step(state, mi, tg, 0)
                history.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            launches = _launches()  # ... and ends here
    finally:
        undo()
    if case.get("moe") and mesh.ep.index == 0:  # the stage's routing (ep ranks route alike)
        torch.save(records, os.path.join(job["results"], f"{case['name']}_routing_"
                                                          f"s{mesh.pp.index}.pt"))
    return {"steps": history, "launches": launches,
            **_pp_counters(torch, pipe, model, caught)}


def _pp_long(job, rank, torch, np):
    """7x(d): the pipelined step at 8 x (2048 + 32), pp = 2, bf16 and f32,
    GPipe and 1F1B at PP_LONG_MICRO microbatches, the flagship's dropouts:
    per config this rank's ms a step by CUDA events over PP_TIMED_STEPS
    after one warm step, peak memory, host ms in the stage hops a step, the
    share of idle ticks, flash launches a step and the loss."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.ops import flash_attention as fa
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import pipeline as pipe
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step
    from univtg_tpu_torch.train.steps_1f1b import make_1f1b_train_step

    mesh = pm.make_mesh(1, 1, 1, 1, 2)
    mi, tg = _long_batch(torch, np)
    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    out = {}
    for dname in ("bfloat16", "float32"):
        for sched in ("gpipe", "1f1b"):
            for M in PP_LONG_MICRO:
                case = {"mesh": [1, 1, 1, 1, 2], "M": M, "drop": True}
                cfg = _pp_model_cfg(case, dname, max_v_l=2048)
                model = pm.shard_model(UniVTG(cfg, device="cuda", seed=0), mesh)
                holder = {"state": TrainState(model, make_optimizer(
                    model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 100), 1e-4, 0.1))}
                step = (make_train_step(weights) if sched == "gpipe"
                        else make_1f1b_train_step(weights, n_micro=M))

                def one():
                    holder["state"], holder["m"] = step(holder["state"], mi, tg, 0)

                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                one()  # warm
                before = dict(fa.launches)
                pipe.reset_stats()
                ms = cuda_ms(one, iters=PP_TIMED_STEPS, warmup=0)
                st = dict(pipe.stats)
                out[f"{dname}_{sched}_M{M}"] = {
                    "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "hop_host_ms_a_step": st["hop_s"] * 1e3 / PP_TIMED_STEPS,
                    "idle_tick_share": st["idle_ticks"] / max(st["ticks"], 1),
                    "ticks_a_step": st["ticks"] / PP_TIMED_STEPS,
                    "saved_peak": st["saved_peak"],
                    "launches_a_step": {k: (fa.launches[k] - before[k]) / PP_TIMED_STEPS
                                        for k in before},
                    "loss": float(holder["m"]["loss_overall"])}
                del holder, model
    return out


def _ring_calls(layers, M, steps, sched="gpipe", last=False):
    """The ring calls of a stage holding ``layers`` layers over ``steps``
    steps of M microbatches: one per layer and microbatch forward; 1F1B adds
    the backward's recompute, and skips the last stage's dead forward."""
    runs = 1 if sched == "gpipe" or last else 2
    return layers * M * steps * runs


def _pp_ring(job, rank, torch, np):
    """7x(e): a ring inside a pipeline stage, dp 1 x pp 2 x tp 2 (each stage's
    tp ranks its ring): the flagship's make_train_step (the step train_mr
    runs) with "ring_pallas" at 8 x (2048 + 32), M = PP_RING_M, dropouts 0,
    from the seed-0 weights: (i) PP_STEPS f32 GPipe steps; (ii) one f32 1F1B
    step; (iii) bf16 GPipe, timed (_pp_ring_part)."""
    from univtg_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(*PP_RING_MESH)
    batch = _long_batch(torch, np)
    out = {"stage": mesh.pp.index}
    for part, dname, sched, n in (("f32_gpipe", "float32", "gpipe", PP_STEPS),
                                  ("f32_1f1b", "float32", "1f1b", 1),
                                  ("bf16_gpipe", "bfloat16", "gpipe", PP_TIMED_STEPS)):
        out[part] = _pp_ring_part(torch, mesh, batch, dname, sched, n,
                                  timed=dname == "bfloat16")
    return out


def _pp_ring_part(torch, mesh, batch, dname, sched, n, timed):
    """n steps of one 7x(e) part on ``mesh`` from the seed-0 weights. With
    ``timed``: one warm step first, then ms a step by CUDA events over the n,
    peak memory and host ms in the stage hops, then one more step with the
    ring's hops and the mesh's collectives timed. This rank's launches and
    attention dispatches (counted from 0 before the counted steps, read
    after them), every step's metrics, the pipeline's counters and the ranks
    of its layers' rings."""
    import warnings

    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.ops import attention as attn
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import pipeline as pipe
    from univtg_tpu_torch.parallel import ring as ring_mod
    from univtg_tpu_torch.train.steps import make_train_step
    from univtg_tpu_torch.train.steps_1f1b import make_1f1b_train_step

    mi, tg = batch
    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    cfg = _long_ring_cfg("ring_pallas", dname, scan_layers=True,
                         pipeline_stages=PP_RING_MESH[4], pipeline_microbatches=PP_RING_M)
    holder = {"state": _mesh_step_state(torch, cfg, mesh)}
    step = (make_train_step(weights) if sched == "gpipe"
            else make_1f1b_train_step(weights, n_micro=PP_RING_M))
    history, rec = [], {}

    def one():
        holder["state"], m = step(holder["state"], mi, tg, 0)
        history.append({k: float(v) for k, v in m.items()})

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if timed:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            one()  # warm, not counted
        pipe.reset_stats()
        _reset_launches()  # this rank's share of the part's path starts here
        if timed:
            rec["ms"] = cuda_ms(one, iters=n, warmup=0)
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rec["stage_hop_host_ms_a_step"] = pipe.stats["hop_s"] * 1e3 / n
            spent, undo = _timed_mesh_collectives(torch, pm, ring_mod)
            try:
                one()
            finally:
                undo()
            rec["ring_hop_host_ms_a_step"] = (spent.get("hop_post", 0.0)
                                              + spent.get("hop_wait", 0.0)) * 1e3
            rec["collective_host_ms_a_step"] = {k: v * 1e3 for k, v in spent.items()}
            n += 1
        else:
            for _ in range(n):
                one()
        torch.cuda.synchronize()
        rec["launches"] = _launches()  # ... and ends here
        rec["dispatches"] = dict(attn.dispatches)
    model = holder["state"].model
    rec.update(steps=history[-n:], n_steps=n, **_pp_counters(torch, pipe, model, caught),
               ring_ranks=[list(layer.self_attn.ring.ranks)
                           for layer in model.transformer.encoder.stage_layers()])
    return rec

def mesh_worker(job, rank, world, torch, np):
    """One rank of a phase-7u/7v/7w/7x gang (``chip_smoke.py --dist-worker``
    with mode "mesh"): the job's cases in order, each on its own mesh."""
    out = {"rank": rank}
    for case in job["cases"]:
        kind = case["kind"]
        t0 = time.perf_counter()
        if kind == "train_mr":
            out[case["name"]] = _mesh_train_mr(job, rank, torch, np)
        elif kind == "long":
            out[case["name"]] = _mesh_long_steps(job, rank, torch, np)
        elif kind == "moe":
            out[case["name"]] = _mesh_moe(job, case, rank, torch, np)
        elif kind == "ring_ops":
            out[case["name"]] = _mesh_ring_ops(job, rank, torch, np)
        elif kind == "ring_train":
            out[case["name"]] = _mesh_ring_train(job, rank, torch, np)
        elif kind == "pp_train_mr":
            out[case["name"]] = _pp_train_mr(job, rank, torch, np)
        elif kind == "pp_steps":
            out[case["name"]] = _pp_steps(job, case, rank, torch, np)
        elif kind == "pp_long":
            out[case["name"]] = _pp_long(job, rank, torch, np)
        elif kind == "pp_ring":
            out[case["name"]] = _pp_ring(job, rank, torch, np)
        elif kind == "hl":
            out[case["name"]] = hl_gang_worker(job, rank, world, torch, np)
        elif kind == "vlp":
            out[case["name"]] = _vlp_rank(case["job"], rank, torch, np)
        out[case["name"]]["case_s"] = time.perf_counter() - t0
    return out


def _read_ranks(base, world):
    ranks = []
    for r in range(world):
        with open(os.path.join(base, f"r{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _rel_steps(got, want, keys=("loss_overall", "grad_norm")):
    return [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in keys}
            for g, w in zip(got, want, strict=True)]


def _within_train_tol(rel):
    return all(r["loss_overall"] <= TRAIN_TOL["loss"] and r["grad_norm"] <= TRAIN_TOL["grad_norm"]
               for r in rel)


def _flash_head_offset(torch, fa):
    """7u(iii): the flash kernels over a tp rank's heads (4 of 8, from head
    4: head_span (8, 4)) with attention dropout 0.1, forward and backward,
    f32 and bf16 at 8 x 2080, against the twin with the same offset; and
    the offset changes the kernels' mask (the global head is hashed)."""
    B, L, H, dh = MESH_RING_SHAPE
    Hl, off = H // 2, H // 2
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = _attention_inputs(torch, B, L, Hl, dh, dtype, seed=9)
        dout = torch.randn_like(q)
        seed = torch.tensor([77], dtype=torch.int32, device="cuda")
        got, lse = fa._forward(q, k, v, mask, Hl, None, 0.1, seed, (H, off))
        grads = fa._backward(q, k, v, mask, got, lse, dout, Hl, None, 0.1, seed, (H, off))
        own, _ = fa._forward(q, k, v, mask, Hl, None, 0.1, seed)
        split = lambda t: fa._split(t, B, Hl, dh)  # noqa: E731
        want, want_lse = fa.flash_attention_reference(
            split(q), split(k), split(v), mask.repeat_interleave(Hl, dim=0),
            sm_scale=dh**-0.5, dropout_rate=0.1, seed=seed, heads=(H, off, Hl))
        want_g = fa.flash_attention_backward_reference(
            split(q), split(k), split(v), mask.repeat_interleave(Hl, dim=0),
            split(got), lse, split(dout), sm_scale=dh**-0.5, dropout_rate=0.1, seed=seed,
            heads=(H, off, Hl))
        torch.cuda.synchronize()
        dname = str(dtype)[6:]
        err = (got.float() - fa._merge(want, B, Hl, dh).float()).abs().max().item()
        rels = [((g.float() - fa._merge(w, B, Hl, dh).float()).abs().max()
                 / fa._merge(w, B, Hl, dh).float().abs().max()).item()
                for g, w in zip(grads, want_g)]
        moved = not torch.equal(got, own)
        out[dname] = {"out_err": err, "bwd_rel": rels, "offset_moves_mask": moved}
        if err > TOL[dname]["out"] or max(rels) > BWD_TOL[dname]["rel"] or not moved:
            raise AssertionError(f"flash kernels with a head offset, {dname}: out err {err}, "
                                 f"backward rel {rels}, the offset moved the mask {moved}")
    return out


def phase_mesh_tp(torch, np, card, tmp, corpus, hl_job, vlp_job):
    """7u and 7w, in one gang of MESH_TP gloo ranks sharing the card
    (``chip_smoke.py --dist-worker`` mode "mesh"): (i) train_mr at tp =
    MESH_TP on phase 7's corpus (full width, B = 32, f32, "pallas", dropouts
    0, one epoch of 3 steps, evaluated on rank 0 over the gathered
    parameters): every step against one process on the same batches at
    TRAIN_TOL, the ranks equal, the canonical checkpoint read by one-process
    `cli infer-mr` with the metrics of the gang's evaluation; (ii) the long
    step at 8 x (2048 + 32), seq_shard off and on, bf16 at the flagship's
    dropouts and f32 at dropouts 0 (ms, peak memory, launches, collective
    host ms per rank), the f32 step's first step from the seed against one
    process at TRAIN_TOL; (iii) the
    flash kernels
    with a head offset against the twin (in this process); 7w: the MoE
    flagship (MOE_OVERRIDES, f32, "pallas", B = 32 global) on dp = 2 and on
    ep = 2, each 3 steps against one process on the global batches at
    TRAIN_TOL, tokens routed otherwise only within MOE_TIE_REL. Returns
    ({path: launches summed over the ranks}, stats)."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.ops import flash_attention as fa
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    base = os.path.join(tmp, "mesh_tp")
    os.makedirs(base, exist_ok=True)
    moe_batches = _train_batches(np, corpus, 3)
    moe_init = os.path.join(base, "moe_init.pt")
    moe_sd = UniVTG(_moe_model(attention_impl="pallas", dropout=0.0, droppath=0.0,
                               input_dropout=0.0), device="cpu", seed=0).state_dict()
    torch.save(moe_sd, moe_init)
    torch.save(moe_batches, os.path.join(base, "moe_batches.pt"))
    pp_init = os.path.join(base, "pp_init.pt")
    torch.save(UniVTG(_pp_model_cfg({"mesh": [1, 1, 1, 1, 2], "M": 2}), device="cpu",
                      seed=0).state_dict(), pp_init)
    job = {"mode": "mesh", "corpus": corpus, "tp": MESH_TP, "moe_init": moe_init,
           "moe_batches": os.path.join(base, "moe_batches.pt"), "pp_init": pp_init,
           "pp_batches": os.path.join(base, "moe_batches.pt"),
           "cases": [{"kind": "train_mr", "name": "tp_train_mr"},
                     {"kind": "long", "name": "tp_long"},
                     {"kind": "moe", "name": "moe_dp2", "mesh": [2, 1, 1]},
                     {"kind": "moe", "name": "moe_ep2", "mesh": [1, 1, 2]},
                     # 7x(c) and (d): pp = 2 at dp = 1 (phase_mesh_pp reads them)
                     {"kind": "pp_steps", "name": "pp_drop", "mesh": [1, 1, 1, 1, 2],
                      "M": 2, "drop": True},
                     {"kind": "pp_long", "name": "pp_long"},
                     # 7o (phase_hl_gang reads it)
                     {"kind": "hl", "name": "hl_gang"},
                     # 7k(ii) (phase_dist_gang reads it)
                     _vlp_gang_case(vlp_job, os.path.join(base, "vlp_main"))], **hl_job}
    t0 = time.perf_counter()
    outs = _wait_gang(_gang(job, base, MESH_TP), timeout=MESH_GANG_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    ranks = _read_ranks(base, MESH_TP)

    # (i) against one process on the same batches, from the same seed
    cfg = _mesh_mr_cfg(job)
    model = UniVTG(cfg.model, device="cuda", seed=cfg.seed)
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, 3), cfg.wd, cfg.grad_clip))
    step = make_train_step(cfg.weights, tuple(cfg.losses))
    want = []
    for batch in _train_batches(np, corpus, 3):
        mi, tg = (to_device(t, "cuda") for t in strip_meta(batch, cfg.transfer_dtype))
        want.append({k: float(v) for k, v in step(state, mi, tg, cfg.seed + 1)[1].items()})
    got = ranks[0]["tp_train_mr"]["steps"]
    tp_rel = rel = _rel_steps(got, want)
    same = all(r["tp_train_mr"]["steps"] == got for r in ranks)
    gang_eval = ranks[0]["tp_train_mr"]["evals"][-1]
    ckpt = os.path.join(base, "p0", "model_best.ckpt")
    torch.backends.cudnn.deterministic = True  # as in the gang's ranks
    try:
        brief, _, _, _ = _infer_mr(torch, np, tmp, ckpt, corpus, "tp_gang_ckpt", "pallas",
                                   "float32")
    finally:
        torch.backends.cudnn.deterministic = False
    mismatch = {k: (v, brief.get(k)) for k, v in gang_eval.items()
                if k != "epoch" and brief.get(k) != v}
    tp_launches = {k: sum(r["tp_train_mr"]["launches"][k] for r in ranks)
                   for k in ranks[0]["tp_train_mr"]["launches"]}
    log(f"[mesh tp] {MESH_TP} gloo ranks sharing the card, train_mr tp={MESH_TP} "
        f"({len(got)} steps, f32, pallas): ranks equal {same}; vs one process rel per "
        f"step {rel} (limits {TRAIN_TOL}); its checkpoint through one-process infer-mr: "
        f"metrics equal to the gang's evaluation {not mismatch}; launches (ranks summed) "
        f"{tp_launches}; gang {gang_s:.1f} s")
    if not got or not same or not _within_train_tol(rel):
        raise AssertionError(f"the tp gang leaves the one-process curve: {rel}\n"
                             f"{outs[0][-3000:]}")
    if mismatch:
        raise AssertionError(f"infer-mr on the gang's checkpoint: {mismatch}")
    if any(r["tp_train_mr"]["launches"][k] == 0 for r in ranks for k in FLASH_KERNELS):
        raise AssertionError(f"a tp rank skipped a kernel: {tp_launches}")

    # (ii) the long step, seq_shard off and on
    long = {f"rank{r['rank']}": r["tp_long"] for r in ranks}
    configs = ranks[0]["tp_long"]["timed"]
    for name, rec in configs.items():
        log(f"[mesh tp] long step 8 x (2048 + 32), tp={MESH_TP}, {name} ({card}): "
            f"{rec['ms']:.1f} ms, peak {rec['peak_gib']:.2f} GiB a rank, launches a step "
            f"{rec['launches_a_step']}, host ms in collectives a step "
            f"{ {k: round(v, 1) for k, v in rec['collective_host_ms'].items()} }, loss "
            f"{rec['loss']:.5f}")
    log(f"[mesh tp] long step per rank: {json.dumps(long)}")
    for rec in configs.values():
        if not np.isfinite(rec["loss"]) or any(
                rec["launches_a_step"][k] != 4 for k in FLASH_KERNELS):
            raise AssertionError(f"the tp long step: {rec}")
    # ... and at dropouts 0 against one process on the same batch
    from univtg_tpu_torch.models.losses import LossWeights

    mi, tg = _long_batch(torch, np)
    state = _mesh_step_state(torch, _exact_long_cfg(False), None)
    one = make_train_step(LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1))
    m = one(state, mi, tg, 0)[1]
    del state
    want = {k: float(m[k]) for k in ("loss_overall", "grad_norm")}
    exact = {name: _rel_steps([rec], [want])[0]
             for name, rec in ranks[0]["tp_long"]["exact"].items()}
    same = all(r["tp_long"]["exact"] == ranks[0]["tp_long"]["exact"] for r in ranks)
    log(f"[mesh tp] long step 8 x (2048 + 32), tp={MESH_TP}, f32, dropouts 0 ({card}): "
        f"ranks equal {same}; vs one process (loss {want['loss_overall']:.6f}, grad norm "
        f"{want['grad_norm']:.6f}) rel {exact} (limits {TRAIN_TOL})")
    if not same or not _within_train_tol(list(exact.values())):
        raise AssertionError(f"the tp long step at dropouts 0 leaves one process: {exact}")

    # (iii) the flash kernels over a rank's heads
    offset = _flash_head_offset(torch, fa)
    log(f"[mesh tp] flash kernels over heads 4-7 of 8 (head_span (8, 4)), dropout 0.1, "
        f"8 x 2080, against the twin with the same offset: {offset}")

    # 7w: the MoE gangs against one process on the global batches
    moe_stats, moe_launches = {}, {}
    for name in ("moe_dp2", "moe_ep2"):
        records = []
        undo = _routing_recorder(torch, records)
        try:
            _, want = _run_steps(torch, _moe_model(attention_impl="pallas", dropout=0.0,
                                                   droppath=0.0, input_dropout=0.0),
                                 moe_sd, moe_batches)
        finally:
            undo()
        mine = torch.load(os.path.join(base, f"{name}_routing.pt"))
        routed, worst = _routing_ties(torch, mine, records)
        got = ranks[0][name]["steps"]
        rel = _rel_steps(got, want, ("loss_overall", "grad_norm", "loss_moe_aux"))
        same = all(r[name]["steps"] == got for r in ranks)
        moe_launches[name] = {k: sum(r[name]["launches"][k] for r in ranks)
                              for k in ranks[0][name]["launches"]}
        moe_stats[name] = {"rel": rel, "tokens_routed_otherwise": routed,
                           "worst_tie": worst,
                           "ms_per_rank": [r[name]["ms"] for r in ranks]}
        log(f"[mesh moe] {name} ({card}): ranks equal {same}; vs one process on the "
            f"global batch, rel per step {rel}; tokens routed otherwise {routed} (largest "
            f"tie gap {worst:.2e}, limit {MOE_TIE_REL}); ms a step per rank "
            f"{moe_stats[name]['ms_per_rank']}; launches (ranks summed) "
            f"{moe_launches[name]}")
        if not got or not same or not all(
                r["loss_overall"] <= TRAIN_TOL["loss"]
                and r["grad_norm"] <= TRAIN_TOL["grad_norm"] for r in rel) \
                or worst > MOE_TIE_REL:
            raise AssertionError(f"{name} leaves the one-process curve: "
                                 f"{moe_stats[name]}\n{outs[0][-3000:]}")
        if any(r[name]["launches"][k] == 0 for r in ranks for k in FLASH_KERNELS):
            raise AssertionError(f"a {name} rank skipped a kernel: {moe_launches[name]}")
    moe_total = {k: sum(v[k] for v in moe_launches.values()) for k in tp_launches}
    return ({"tp_training": tp_launches, "moe_dist_training": moe_total},
            {"tp": {"rel": tp_rel, "long": long, "long_exact_rel": exact,
                    "head_offset": offset, "gang_s": gang_s},
             "moe": moe_stats},
            {"ranks": ranks, "outs": outs, "pp_init": pp_init, "batches": moe_batches,
             "moe_init": moe_init, "cases": job["cases"]})


def _shard_batches(np, corpus, n, bsz, dp):
    """The first n global batches of a gang of dp rows of bsz each, as the
    driver's Loaders give them in epoch 0 (each row its shard), the rows'
    batches concatenated in dp order."""
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.loader import Loader
    from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset

    ds = MRDataset(MRDataConfig(
        data_path=corpus["train_path"], v_feat_dirs=corpus["v_feat_dirs"],
        q_feat_dir=corpus["q_feat_dir"], v_feat_dim=corpus["v_dim"],
        q_feat_dim=corpus["q_dim"], max_q_l=32, max_v_l=75))
    loaders = [Loader(ds, bsz, lambda items, pad_batch_to: collate_mr(
        items, 32, 75, pad_batch_to), shuffle=True, seed=2018, num_threads=4,
        shard_index=d, num_shards=dp) for d in range(dp)]
    out = []
    for rows in zip(*loaders):
        out.append({part: {k: np.concatenate([np.asarray(b[part][k]) for b in rows])
                           for k in rows[0][part]} for part in ("model_inputs", "targets")})
        if len(out) == n:
            break
    return out


def _microbatched_steps(torch, cfg, sd, cpu_batches, n_blocks, records=None):
    """One process's reference for 1F1B: the flagship of cfg (no pipeline)
    from state_dict sd, each step's loss the mean of compute_losses over
    n_blocks consecutive row blocks (JAX's (microbatch x dp shard) blocks in
    order), through plain autograd, then AdamW with the clip; every step's
    metrics. ``records``: 7r's routing records, block by block."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.device import exact_f32
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.models.losses import LossWeights, compute_losses
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, forward, make_optimizer

    model = UniVTG(cfg, device="meta")
    model.load_state_dict({k: v.cuda() for k, v in sd.items()}, assign=True)
    state = TrainState(model, make_optimizer(
        model.parameters(), build_schedule(1e-4, 10, 200, 0.1, 3), 1e-4, 0.1))
    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    undo = _routing_recorder(torch, records) if records is not None else (lambda: None)
    history = []
    try:
        for batch in cpu_batches:
            mi, tg = (to_device(t, "cuda") for t in strip_meta(batch))
            bs = mi["src_vid"].shape[0] // n_blocks
            model.train()
            state.optimizer.zero_grad()
            sums = {}
            with exact_f32(cfg.dtype):
                for i in range(n_blocks):
                    rows = slice(i * bs, (i + 1) * bs)
                    out = forward(model, {k: v[rows] for k, v in mi.items()}, train=True)
                    ld = compute_losses(out, {k: v[rows] for k, v in tg.items()}, weights)
                    for k, v in ld.items():
                        sums[k] = sums.get(k, 0.0) + v / n_blocks
                sums["loss_overall"].backward()
            m = {k: float(v.detach()) for k, v in sums.items()}
            m["grad_norm"] = float(state.optimizer.step(state.step))
            state.step += 1
            history.append(m)
    finally:
        undo()
    return history


def _pp_ran(ranks, name, pp, v=1, layers=4):
    """Each rank ran the pipeline (ticks and hops), held one stage's layers
    alone (fewer parameters than the whole model), and fell back nowhere;
    returns {rank: (ticks, hops, idle ticks, parameters held)}."""
    shown = {}
    for r in ranks:
        c = r[name]
        stages = [_stage_layers(layers, pp, v, s) for s in range(pp)]
        if (c["pipe"]["ticks"] == 0 or c["pipe"]["hops"] == 0 or c["fallback"]
                or c["layers"] not in stages):
            raise AssertionError(f"{name}: rank {r['rank']} did not run the pipeline: {c}")
        shown[r["rank"]] = (c["pipe"]["ticks"], c["pipe"]["hops"], c["pipe"]["idle_ticks"],
                            c["n_params"])
    return shown


def _stage_layers(layers, pp, v, s):
    from univtg_tpu_torch.parallel.mesh import stage_layers

    return stage_layers(layers, pp, v, s)


def _sum_launches(ranks, name):
    return {k: sum(r[name]["launches"][k] for r in ranks) for k in ranks[0][name]["launches"]}


def _want_flash(L, M, steps, schedule, pp, v=1, ranks=1):
    """The flash launches a pipelined path makes over ``steps`` steps, summed
    over the gang: GPipe without remat L M of each kernel a step and
    pipeline; 1F1B skips the last chunk's dead forward, so (L - L / (pp v))
    M + L M forwards (the recomputes) and L M of each backward kernel;
    ``ranks`` pipelines (dp rows) or ranks a stage (ep, tp) that each
    launch them."""
    fwd = L * M if schedule == "gpipe" else (L - L // (pp * v)) * M + L * M
    return {"flash_fwd": fwd * steps * ranks, "flash_bwd_dq": L * M * steps * ranks,
            "flash_bwd_dkv": L * M * steps * ranks}


def phase_mesh_pp(torch, np, card, tmp, corpus, tp_gang):
    """7x: pipelines across processes. (a) train_mr at dp = 2 x pp = 2
    (GPipe, 2 microbatches) on phase 7's corpus, B = 32 global, f32,
    "pallas", dropouts 0, one epoch of 3 steps evaluated by rank 0 on a
    local non-pipeline copy, every step against one process on the same
    global batches at TRAIN_TOL, the ranks equal, model_best.ckpt through
    one-process `cli infer-mr` with the gang's metrics; (b) PP_CASES: 1F1B
    at pp = 4 (one layer a stage), M = 8; dp = 2 x pp = 2, interleave 2, M =
    4; 7r's MoE at pp = 2 x ep = 2, M = 4: each step against one process's
    microbatched loss (the mean of the M dp block losses) at TRAIN_TOL, MoE
    tokens routed otherwise only within MOE_TIE_REL; (a) and (b) in one
    gang of MESH_PP gloo ranks sharing the card; (c) GPipe at pp = 2 at the
    flagship's dropouts against the one-process step from the same seed at
    TRAIN_TOL, and (d) the long shape's GPipe and 1F1B at PP_LONG_MICRO, in
    7u's gang (``tp_gang``). Every part shows each rank's ticks, hops and
    the parameters it holds, and no fallback; the flash launches are the
    ones _want_flash names. Returns ({path: launches summed over the
    ranks}, stats)."""
    from univtg_tpu_torch.data.prefetch import to_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train.epoch_runner import strip_meta
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    base = os.path.join(tmp, "mesh_pp")
    os.makedirs(base, exist_ok=True)
    pp_batches = os.path.join(base, "pp_batches.pt")
    torch.save(_shard_batches(np, corpus, PP_STEPS, 16, 2), pp_batches)
    job = {"mode": "mesh", "corpus": corpus, "pp_init": tp_gang["pp_init"],
           "moe_init": tp_gang["moe_init"], "pp_batches": pp_batches, "ring_p": MESH_RING_P,
           "cases": [{"kind": "pp_train_mr", "name": "pp_train_mr"}] + [
               {"kind": "pp_steps", "name": n, "mesh": mesh, "M": M, "v": v, "moe": moe}
               for n, mesh, M, v, moe in PP_CASES]
           + [{"kind": "pp_ring", "name": "pp_ring"}]
           # 7v's, checked by phase_mesh_ring
           + [{"kind": "ring_ops", "name": "ring_ops"},
              {"kind": "ring_train", "name": "ring_train"}]}
    t0 = time.perf_counter()
    outs = _wait_gang(_gang(job, base, MESH_PP), timeout=MESH_GANG_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    ranks = _read_ranks(base, MESH_PP)
    stats, launches = {"gang_s": gang_s}, {}

    # (a) the driver at dp = 2 x pp = 2 against one process, from the same seed
    cfg = _pp_mr_cfg(job)
    one_cfg = dataclasses.replace(cfg.model, pipeline_stages=0)
    model = UniVTG(one_cfg, device="cuda", seed=cfg.seed)
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, PP_STEPS), cfg.wd, cfg.grad_clip))
    step = make_train_step(cfg.weights, tuple(cfg.losses))
    want = []
    for batch in _shard_batches(np, corpus, PP_STEPS, 16, 2):
        mi, tg = (to_device(t, "cuda") for t in strip_meta(batch, cfg.transfer_dtype))
        want.append({k: float(v) for k, v in step(state, mi, tg, cfg.seed + 1)[1].items()})
    del state, model
    got = ranks[0]["pp_train_mr"]["steps"]
    rel = _rel_steps(got, want)
    same = all(r["pp_train_mr"]["steps"] == got for r in ranks)
    gang_eval = ranks[0]["pp_train_mr"]["evals"][-1]
    ckpt = os.path.join(base, "p0", "model_best.ckpt")
    torch.backends.cudnn.deterministic = True  # as in the gang's ranks
    try:
        brief, _, _, _ = _infer_mr(torch, np, tmp, ckpt, corpus, "pp_gang_ckpt", "pallas",
                                   "float32", "model.scan_layers=true")
    finally:
        torch.backends.cudnn.deterministic = False
    mismatch = {k: (v, brief.get(k)) for k, v in gang_eval.items()
                if k != "epoch" and brief.get(k) != v}
    ran = _pp_ran(ranks, "pp_train_mr", 2)
    launches["pp_gpipe_training"] = _sum_launches(ranks, "pp_train_mr")
    wanted = _want_flash(4, 2, PP_STEPS, "gpipe", 2, ranks=2)
    wanted["flash_fwd"] += 4 * (N_VAL // 32)  # rank 0's evaluation, 4 a batch
    stats["a"] = {"rel": rel, "ran": ran, "launches": launches["pp_gpipe_training"]}
    log(f"[mesh pp] (a) train_mr dp=2 x pp=2, GPipe, 2 microbatches ({len(got)} steps, "
        f"f32, pallas; {MESH_PP} gloo ranks sharing the card, {card}): ranks equal {same}; "
        f"vs one process rel per step {rel} (limits {TRAIN_TOL}); rank 0's evaluation on "
        f"its local copy = one-process infer-mr of model_best.ckpt: {not mismatch}; "
        f"(ticks, hops, idle ticks, parameters held) per rank {ran}; launches (ranks "
        f"summed) {launches['pp_gpipe_training']} (want {wanted}); gang {gang_s:.1f} s")
    if not got or not same or not _within_train_tol(rel):
        raise AssertionError(f"the GPipe gang leaves the one-process curve: {rel}\n"
                             f"{outs[0][-3000:]}")
    if mismatch:
        raise AssertionError(f"infer-mr on the pipelined gang's checkpoint: {mismatch}")
    if {k: launches["pp_gpipe_training"][k] for k in wanted} != wanted:
        raise AssertionError(f"GPipe's flash launches: {launches['pp_gpipe_training']}, "
                             f"want {wanted}")

    # (b) 1F1B against one process's microbatched loss
    sd = torch.load(tp_gang["pp_init"])
    moe_sd = torch.load(tp_gang["moe_init"])
    cpu_batches = torch.load(pp_batches, weights_only=False)
    total = {}
    for name, mesh, M, v, moe in PP_CASES:
        dp, pp = mesh[0], mesh[4]
        case = {"mesh": mesh, "M": M, "v": v, "moe": moe}
        records = [] if moe else None
        want = _microbatched_steps(torch, dataclasses.replace(
            _pp_model_cfg(case), pipeline_stages=0), moe_sd if moe else sd, cpu_batches,
            M * dp, records)
        got = ranks[0][name]["steps"]
        keys = ("loss_overall", "grad_norm") + (("loss_moe_aux",) if moe else ())
        rel = _rel_steps(got, want, keys)
        same = all(r[name]["steps"] == got for r in ranks)
        ran = _pp_ran(ranks, name, pp, v)
        made = _sum_launches(ranks, name)
        # every dp row runs the pipeline, and both ep ranks of a stage attend
        wanted = _want_flash(4, M, PP_STEPS, "1f1b", pp, v, dp * mesh[2])
        routed = worst = None
        if moe:
            stages = [torch.load(os.path.join(base, f"{name}_routing_s{s}.pt"))
                      for s in range(pp)]
            mine = [rec for b in range(len(stages[0]) // 2) for st in stages
                    for rec in st[2 * b:2 * b + 2]]
            routed, worst = _routing_ties(torch, mine, records)
        stats[name] = {"rel": rel, "ran": ran, "launches": made,
                       "tokens_routed_otherwise": routed, "worst_tie": worst}
        for k in made:
            total[k] = total.get(k, 0) + made[k]
        log(f"[mesh pp] (b) {name}: 1F1B on mesh [dp, tp, ep, -, pp] {mesh}, M = {M}, "
            f"interleave {v}{', MoE' if moe else ''} ({card}): ranks equal {same}; vs one "
            f"process's microbatched loss rel per step {rel} (limits {TRAIN_TOL})"
            + (f"; tokens routed otherwise {routed} (largest tie gap {worst:.2e}, limit "
               f"{MOE_TIE_REL})" if moe else "")
            + f"; (ticks, hops, idle ticks, parameters held) per rank {ran}; launches "
            f"(ranks summed) {made} (want {wanted})")
        if not got or not same or not _within_train_tol(rel) or (
                moe and (worst > MOE_TIE_REL or not all(
                    r["loss_moe_aux"] <= TRAIN_TOL["loss"] for r in rel))):
            raise AssertionError(f"{name} leaves the microbatched curve: {stats[name]}\n"
                                 f"{outs[0][-3000:]}")
        if {k: made[k] for k in wanted} != wanted:
            raise AssertionError(f"{name}'s flash launches: {made}, want {wanted}")
    launches["pp_1f1b_training"] = total

    # (c) GPipe at the flagship's dropouts against one process from the seed
    tp_ranks = tp_gang["ranks"]
    case = {"mesh": [1, 1, 1, 1, 2], "M": 2, "drop": True}
    _, want = _run_steps(torch, dataclasses.replace(_pp_model_cfg(case), pipeline_stages=0),
                         sd, tp_gang["batches"][:PP_STEPS])
    got = tp_ranks[0]["pp_drop"]["steps"]
    rel = _rel_steps(got, want)
    same = all(r["pp_drop"]["steps"] == got for r in tp_ranks)
    ran = _pp_ran(tp_ranks, "pp_drop", 2)
    launches["pp_dropout_training"] = _sum_launches(tp_ranks, "pp_drop")
    wanted = _want_flash(4, 2, PP_STEPS, "gpipe", 2)
    stats["c"] = {"rel": rel, "ran": ran}
    log(f"[mesh pp] (c) GPipe pp=2, M = 2, at the flagship's dropouts, f32 ({card}): ranks "
        f"equal {same}; vs the one-process step from the same seed rel per step {rel} "
        f"(limits {TRAIN_TOL}); (ticks, hops, idle ticks, parameters held) per rank {ran}; "
        f"launches (ranks summed) {launches['pp_dropout_training']} (want {wanted})")
    if not got or not same or not _within_train_tol(rel):
        raise AssertionError(f"the dropout GPipe step leaves one process: {rel}")
    if {k: launches["pp_dropout_training"][k] for k in wanted} != wanted:
        raise AssertionError(f"the dropout GPipe step's launches: "
                             f"{launches['pp_dropout_training']}, want {wanted}")

    # (d) the long shape, GPipe against 1F1B
    long = {f"rank{r['rank']}": r["pp_long"] for r in tp_ranks}
    for key in tp_ranks[0]["pp_long"]:
        if key == "case_s":
            continue
        recs = [r["pp_long"][key] for r in tp_ranks]
        sched, M = key.split("_")[1], int(key.split("_M")[1])
        made = {k: sum(rec["launches_a_step"][k] for rec in recs) for k in FLASH_KERNELS}
        wanted = _want_flash(4, M, 1, sched, 2)
        log(f"[mesh pp] (d) 8 x (2048 + 32), pp=2, {key} ({card}): ms a step per rank "
            f"{[round(rec['ms'], 1) for rec in recs]}, peak GiB "
            f"{[round(rec['peak_gib'], 2) for rec in recs]}, host ms in the hops a step "
            f"{[round(rec['hop_host_ms_a_step'], 1) for rec in recs]}, idle tick share "
            f"{[round(rec['idle_tick_share'], 3) for rec in recs]}, saved inputs "
            f"{[rec['saved_peak'] for rec in recs]}, flash launches a step (ranks summed) "
            f"{made} (want {wanted}), loss {recs[0]['loss']:.5f}")
        if not all(np.isfinite(rec["loss"]) for rec in recs) or made != wanted:
            raise AssertionError(f"the long pipelined step {key}: {recs}")
    stats["d"] = long
    launches["pp_ring_training"], stats["e"] = _pp_ring_holds(torch, np, card, ranks, outs)
    log(f"[mesh pp] ({card}) {json.dumps(stats)}")
    return launches, stats, {"ranks": ranks, "outs": outs, "gang_s": gang_s}


def _pp_ring_holds(torch, np, card, ranks, outs):
    """7x(e)'s holds on the gang's ranks: each rank's rings are its stage's
    tp ranks and it fell back nowhere; each part's ring calls ran
    "ring_pallas" alone, PP_RING_TP ring_block + 1 ring_finish each, no flash
    kernel; the f32 GPipe steps against one process's "xla" steps and the
    1F1B step against one process's microbatched loss, at TRAIN_TOL; the
    bf16 timings logged. Returns (the launches summed over the ranks and
    parts, stats)."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.parallel.mesh import mesh_grid

    world = len(ranks)
    grid = mesh_grid(world, PP_RING_MESH[0], PP_RING_TP, 1, 1, world, PP_RING_MESH[4])
    stage_ranks = [[int(r) for r in grid[0, st, 0]] for st in range(PP_RING_MESH[4])]
    layers = 4 // PP_RING_MESH[4]
    total, stats = {}, {}
    for part in ("f32_gpipe", "f32_1f1b", "bf16_gpipe"):
        recs = [r["pp_ring"][part] for r in ranks]
        for r, rec in zip(ranks, recs):
            st = r["pp_ring"]["stage"]
            calls = _ring_calls(layers, PP_RING_M, rec["n_steps"], part.split("_")[1],
                                st == PP_RING_MESH[4] - 1)
            want_d = {k: 0 for k in rec["dispatches"]}
            want_d["ring_pallas"] = calls
            want_l = {k: 0 for k in rec["launches"]}
            want_l.update(ring_block=PP_RING_TP * calls, ring_finish=calls)
            if (rec["fallback"] or rec["dispatches"] != want_d or rec["launches"] != want_l
                    or rec["ring_ranks"] != [stage_ranks[st]] * layers
                    or r["rank"] not in stage_ranks[st] or rec["layers"] not in [
                        _stage_layers(4, PP_RING_MESH[4], 1, s)
                        for s in range(PP_RING_MESH[4])]):
                raise AssertionError(
                    f"7x(e) {part}: rank {r['rank']} (stage {st}) did not run its ring "
                    f"inside the stage as planned: dispatches {rec['dispatches']} (want "
                    f"{want_d}), launches {rec['launches']} (want {want_l}), rings "
                    f"{rec['ring_ranks']}, layers {rec['layers']}, fallback "
                    f"{rec['fallback']}\n{outs[0][-3000:]}")
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
        same = all(rec["steps"] == recs[0]["steps"] for rec in recs)
        per_rank = [{k: rec["launches"][k] for k in ("ring_block", "ring_finish")}
                    for rec in recs]
        stats[part] = {"launches_per_rank": per_rank, "ranks_equal": same,
                       "pipe_per_rank": [rec["pipe"] for rec in recs]}
        if part == "bf16_gpipe":
            stats[part].update({k: [rec[k] for rec in recs] for k in (
                "ms", "peak_gib", "stage_hop_host_ms_a_step", "ring_hop_host_ms_a_step",
                "collective_host_ms_a_step")})
            losses = [s["loss_overall"] for rec in recs for s in rec["steps"]]
            log(f"[mesh pp] (e) bf16 GPipe, ring_pallas inside each stage, dp 1 x pp 2 x tp "
                f"2, M = {PP_RING_M}, 8 x (2048 + 32) ({card}): ms a step per rank "
                f"{[round(x, 1) for x in stats[part]['ms']]}, peak GiB "
                f"{[round(x, 2) for x in stats[part]['peak_gib']]}, host ms a step in the "
                f"ring's hops {[round(x, 1) for x in stats[part]['ring_hop_host_ms_a_step']]}"
                f" and in the stage hops "
                f"{[round(x, 1) for x in stats[part]['stage_hop_host_ms_a_step']]}; "
                f"launches per rank {per_rank}; ranks equal {same}")
            if not same or not all(np.isfinite(losses)):
                raise AssertionError(f"7x(e) bf16: {stats[part]}")
            continue
        cfg = _long_ring_cfg("xla")
        if part == "f32_gpipe":
            want = _long_ring_steps(torch, np, "xla", None, PP_STEPS)
            ref = 'one process\'s "xla" steps'
        else:
            mi, tg = _long_batch(torch, np)
            sd = UniVTG(cfg, device="cuda", seed=0).state_dict()
            batch = {"model_inputs": {k: v.cpu().numpy() for k, v in mi.items()},
                     "targets": {k: v.cpu().numpy() for k, v in tg.items()}}
            want = _microbatched_steps(torch, cfg, sd, [batch], PP_RING_M)
            del sd
            ref = "one process's microbatched loss"
        rel = _rel_steps(recs[0]["steps"], want)
        stats[part]["rel"] = rel
        log(f"[mesh pp] (e) {part}: ring_pallas inside each stage, dp 1 x pp 2 x tp 2 "
            f"(rings {stage_ranks}), M = {PP_RING_M}, 8 x (2048 + 32) ({card}): ranks equal "
            f"{same}; vs {ref} rel per step {rel} (limits {TRAIN_TOL}); launches per rank "
            f"{per_rank}; (ticks, hops) per rank "
            f"{[(rec['pipe']['ticks'], rec['pipe']['hops']) for rec in recs]}")
        if not same or len(recs[0]["steps"]) != len(want) or not _within_train_tol(rel):
            raise AssertionError(f"7x(e) {part} leaves the one-process curve: {stats[part]}"
                                 f"\n{outs[0][-3000:]}")
    return total, stats


def phase_mesh_ring(torch, np, card, gang):
    """7v: the ring across processes, MESH_RING_P gloo ranks sharing the card
    (7x's gang, ``gang``: its ranks' outputs),
    the tp axis their ring: (i) ring_attention_pallas at 8 x 2080, f32 and
    bf16, each process its block, the gathered output against the
    one-process RingGroup(P) on the same inputs (bit for bit, or the
    largest difference recorded), P ring_block + 1 ring_finish a call in
    every process, ms a call and host ms in the hops; (ii) 2 f32 train
    steps at 8 x (2048 + 32) with "ring_pallas" on the tp mesh against
    "xla" in one process at TRAIN_TOL, 4 x (P + 1) launches a forward in
    every process. Returns (the training path's launches summed over the
    processes, stats)."""
    ranks, outs, gang_s = gang["ranks"], gang["outs"], gang["gang_s"]
    P = MESH_RING_P
    ops = {k: v for k, v in ranks[0]["ring_ops"].items() if k != "case_s"}
    for dname, rec in ops.items():
        log(f"[mesh ring] ring_attention_pallas over {P} processes at 8 x 2080, {dname} "
            f"({card}): vs one-process RingGroup({P}) bit-equal {rec['bit_equal']}, max "
            f"|d| {rec['max_abs_diff']:.3e}; {rec['ms']:.2f} ms a call, host ms in the "
            f"hops a call {rec['hop_host_ms']}; launches per process "
            f"{[r['ring_ops'][dname]['launches'] for r in ranks]}")
        if any(r["ring_ops"][dname]["launches"] != {"ring_block": P, "ring_finish": 1}
               for r in ranks):
            raise AssertionError(f"the process ring's launches: {ranks}")
        if rec["max_abs_diff"] > RING_TOL[dname]["abs"]:
            raise AssertionError(f"the process ring leaves the one-process ring: {rec}")
    train = ranks[0]["ring_train"]
    rel = _rel_steps(train["steps"], _long_ring_steps(torch, np, "xla", None))
    per_forward = {"ring_block": 4 * P, "ring_finish": 4}
    want = {k: v * MESH_RING_STEPS for k, v in per_forward.items()}
    launches = {k: sum(r["ring_train"]["launches"][k] for r in ranks)
                for k in ranks[0]["ring_train"]["launches"]}
    log(f"[mesh ring] 2 f32 train steps, ring_pallas on tp={P} processes vs xla in one "
        f"({card}): rel per step {rel} (limits {TRAIN_TOL}); launches per process "
        f"{[{k: r['ring_train']['launches'][k] for k in want} for r in ranks]} (want {want}), "
        f"dispatches {train['dispatches']}; steps {train['s']:.1f} s; gang {gang_s:.1f} s")
    if not _within_train_tol(rel) or any(
            {k: r["ring_train"]["launches"][k] for k in want} != want for r in ranks):
        raise AssertionError(f"the process ring's training: {rel}\n{outs[0][-3000:]}")
    return launches, {"ops": {f"rank{r['rank']}": r["ring_ops"] for r in ranks},
                      "train_rel": rel, "gang_s": gang_s}


def _kernel_line(records_serving, records_train, records_int8, records_ring, by_path,
                 sass):
    """One entry per kernel for the final JSON line: times of the headline
    record (flash: bf16 at the long shape, dropout 0; int8_matmul: bf16 at
    one qvhighlights dispatch, M=4096; ring_attention: bf16 at the long
    shape, P = RING_P), the largest error seen; the kernels with a bf16
    wgmma design (flash_fwd, the backward pair, ring_attention's block
    kernel) also carry their TFLOP/s, share of the bound, HGMMA counts and
    spill bytes (``sass``, phase 2); the backward pair also its f32
    kernel's numbers at the long shape, dropout 0 (``f32``).
    ``launches`` sums the paths of by_path, ``launches_by_path`` splits them;
    for int8_matmul that is the smoke's own call alone, which
    ``launches_note`` says; int8_matmul and ring_attention count their two
    kernels each (the product and int8_matmul_split_sum; ring_block and
    ring_finish), split in ``launches_by_kernel``."""
    out = []
    for name, (source, replaces) in KERNEL_NOTES.items():
        if name == "ring_attention":
            head = next(r for r in records_ring if r["shape"] == "long_video_2080"
                        and r["dtype"] == "bfloat16" and r["P"] == RING_P)
            kinds = ("ring_block", "ring_finish")
            out.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(path[k] for path in by_path.values() for k in kinds),
                "launches_by_path": {p: sum(path[k] for k in kinds)
                                     for p, path in by_path.items()},
                "launches_by_kernel": {k: sum(path[k] for path in by_path.values())
                                       for k in kinds},
                "max_abs_err": max(r["err"] for r in records_ring),
                "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "tflops": head["tflops"], "bound_share": head["bound_share"],
                "sass_bf16": sass["ring_block_kernel_sm90"],
                "by_shape": [{k: r[k] for k in (
                    "shape", "P", "dtype", "ms", "plain_ms", "library_ms", "flash_fwd_ms",
                    "bound_ms", "bound_by", "tflops", "bound_share", "copy_overlap_share")}
                    for r in records_ring]})
            continue
        if name == "int8_matmul":
            head = next(r for r in records_int8 if r["shape"] == "qvhighlights_dispatch"
                        and r["dtype"] == "bfloat16")
            errs = [r["err"] for r in records_int8]
        elif name == "flash_fwd":
            head = next(r for r in records_serving if r["shape"] == "long_video_2048"
                        and r["dtype"] == "bfloat16")
            errs = [r["err_out"] for r in records_serving]
        else:
            head = next(r for r in records_train if r["kernel"] == name
                        and r["shape"] == "train_long_video" and r["dtype"] == "bfloat16"
                        and r["dropout"] == 0.0)
            errs = []
        mine = [r for r in records_train if r["kernel"] == name]
        errs += [r["err"] for r in mine]
        if name == "int8_matmul":
            mine = records_int8
        kinds = INT8_KERNELS if name == "int8_matmul" else (name,)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(path[k] for path in by_path.values() for k in kinds),
                 "launches_by_path": {p: sum(path[k] for k in kinds)
                                      for p, path in by_path.items()},
                 "max_abs_err": max(errs), "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "library_ms": head["library_ms"]}
        if name == "int8_matmul":
            entry.update(launches_note=(
                "no entry point of the port launches int8_matmul, as in the JAX "
                "package: the count is the smoke's own call on the int8 file's "
                "input_vid_proj.0 weight over one eval batch, the product and, "
                "where the plan splits K, the split sum"),
                launches_by_kernel={k: sum(path[k] for path in by_path.values())
                                    for k in INT8_KERNELS},
                max_rel_err=max(r["rel_err"] for r in mine), by_shape=[
                {k: r[k] for k in ("shape", "M", "dtype", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")} for r in mine])
        elif name == "flash_fwd":
            entry.update(tflops=head["tflops"], bound_share=head["bound_share"],
                         sass_bf16=sass["flash_fwd_kernel_sm90"])
        else:
            f32 = next(r for r in mine if r["shape"] == "train_long_video"
                       and r["dtype"] == "float32" and r["dropout"] == 0.0)
            entry.update(
                max_rel_err=max(v for r in mine for k, v in r.items()
                                if k.startswith("rel_err_")),
                pair_ms=head["pair_ms"], pair_library_ms=head["pair_library_ms"],
                tflops=head["tflops"], bound_share=head["bound_share"],
                sass_bf16=sass[f"{name}_kernel_sm90"],
                f32={k: f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "tflops",
                                         "bound_share", "pair_ms", "pair_library_ms")})
        out.append(entry)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--dist-worker"]:  # one rank of a phase-7k gang
        return dist_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                           int(sys.argv[5]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from univtg_tpu_torch.ops import flash_attention as fa

    t_start = time.perf_counter()
    smi = timed("device", phase_device, torch)
    with tempfile.TemporaryDirectory(prefix="univtg_chip_faults_") as fault_dir:
        pending, sass = timed("build", phase_build, fault_dir)
        records = timed("kernels", phase_kernels, torch)
        train_records = timed("kernels", phase_train_kernels, torch)
        int8_records = timed("int8", phase_int8_kernels, torch)
        ring_records = timed("ring", phase_ring_kernels, torch)
        faults = timed("fault builds", _fault_builds, pending)
        timed("faults", phase_faults, torch, faults)

    _reset_launches()  # the serving main path starts here
    pipe_f32, pipe_bf16, long_items, timings = timed(
        "pipeline", phase_pipeline, np, fa, smi)
    timed("server", phase_server, np, pipe_f32, fa)
    serve_launches = _launches()  # ... and ends here
    if serve_launches["flash_fwd"] == 0:
        raise AssertionError("the serving path never launched flash_fwd")
    log(f"[main path] serving launches: {serve_launches}; dispatch ms {json.dumps(timings)}")
    timed("profile", phase_profile, torch, np, pipe_bf16, long_items, fa, smi)
    del pipe_f32, pipe_bf16, long_items
    torch.cuda.empty_cache()
    ring_serve_launches = timed("ring serving", phase_ring_serving, torch, np, smi)
    log(f"[main path] ring serving launches: {ring_serve_launches}")

    with tempfile.TemporaryDirectory(prefix="univtg_chip_smoke_") as tmp:
        corpus, run_dir, sd, train_launches = timed("train", phase_train, torch, np, fa,
                                                    smi, tmp)
        log(f"[main path] training launches: {train_launches}")
        eval_launches, f32_brief = timed("eval", phase_eval, torch, np, tmp, corpus, run_dir)
        log(f"[main path] eval launches: {eval_launches}")
        quantize_launches, call_launches, served_records = timed(
            "quantize", phase_quantize, torch, np, tmp, corpus, run_dir, f32_brief)
        log(f"[main path] int8 tier (quantize, serve, infer-mr) launches: "
            f"{quantize_launches}; the smoke's int8_matmul call: {call_launches}")
        # one pass (two until PR 15): the new phases of PR 16 need the time
        _, val_corpus = timed("evalsize", phase_eval_size, torch, np, fa, smi, tmp, run_dir, 1)
        repro_launches, _ = timed("reproduce", phase_reproduce, torch, np, smi, tmp,
                                  val_corpus)
        log(f"[main path] released-run reproduction (reproduce_model_md, f32 pallas) "
            f"launches: {repro_launches}")
        scan_launches = timed("scan", phase_scan_train, torch, np, tmp, corpus)
        log(f"[main path] scan training launches: {scan_launches}")
        timed("scan", phase_scan, torch, np, fa, smi, corpus, sd)
        hl_train_launches, hl_infer_launches, _ = timed("hl", phase_hl, torch, np, fa,
                                                        smi, tmp)
        log(f"[main path] HL training launches: {hl_train_launches}; HL inference "
            f"launches: {hl_infer_launches}")
        qfvs_train_launches, qfvs_infer_launches, _ = timed("qfvs", phase_qfvs, torch, np,
                                                            smi, tmp)
        log(f"[main path] QFVS training launches: {qfvs_train_launches}; QFVS inference "
            f"launches: {qfvs_infer_launches}")
        vlp_train_launches, _, vlp_specs, vlp_val = timed("vlp", phase_vlp, torch, np,
                                                          smi, tmp)
        log(f"[main path] VLP training launches: {vlp_train_launches}")
        vlp_job = {"specs": [dataclasses.asdict(s) for s in vlp_specs], "val": vlp_val}
        nccl1_launches, _ = timed("dist", phase_dist, torch, np, smi, tmp, vlp_job)
        log(f"[main path] VLP training in a NCCL gang of one launches: {nccl1_launches}")
        md_train_launches, md_infer_launches, _ = timed("md", phase_md, torch, np, smi,
                                                        tmp, corpus)
        log(f"[main path] Moment-DETR training launches: {md_train_launches}; "
            f"Moment-DETR inference launches: {md_infer_launches}")
        ground_launches, ground_server_launches, _ = timed("ground", phase_ground, torch,
                                                           np, smi, tmp)
        log(f"[main path] raw-video grounding launches: {ground_launches}; grounding "
            f"server launches: {ground_server_launches}")
        timed("tf32", phase_tf32, torch, np, smi, corpus, sd)
        resume_launches, _ = timed("resume", phase_resume, torch, np, smi)
        log(f"[main path] training resumed from a JAX checkpoint launches: "
            f"{resume_launches}")
        async_launches, _ = timed("async ckpt", phase_async_ckpt, torch, np, smi, tmp,
                                  corpus)
        log(f"[main path] train-mr with the background writer launches: {async_launches}")
        learn_launches, _ = timed("learning", phase_learning, torch, np, smi, tmp)
        log(f"[main path] the learning check (f32) launches: {learn_launches}")
        moe_train_launches, moe_infer_launches, _ = timed("moe", phase_moe, torch, np, smi,
                                                          tmp, corpus, sd)
        log(f"[main path] MoE training (train-mr bf16 and f32) launches: "
            f"{moe_train_launches}; MoE inference and int8 tier (infer-mr, quantize; cli "
            f"serve counts in its own process): {moe_infer_launches}")
        remat_launches, _ = timed("remat long", phase_remat_long, torch, np, fa, smi,
                                  corpus, sd)
        log(f"[main path] remat training (8 x 2080, bf16 and f32) launches: "
            f"{remat_launches}")
        moe_resume_launches, _ = timed("resume moe", phase_resume, torch, np, smi,
                                       MOE_FIXTURE, "resume moe")
        log(f"[main path] MoE training resumed from a JAX scan-layout checkpoint "
            f"launches: {moe_resume_launches}")
        hl_job = _hl_gang_job(tmp)
        mesh_launches, _, tp_gang = timed("mesh tp", phase_mesh_tp, torch, np, smi, tmp,
                                          corpus, hl_job, vlp_job)
        dist_launches, _ = timed("dist gang", phase_dist_gang, torch, np, smi, tmp, tp_gang)
        log(f"[main path] VLP training across processes (two gloo ranks on the card, "
            f"summed) launches: {dist_launches}")
        hl_gang_launches, _ = timed("hl gang", phase_hl_gang, torch, np, smi, tmp, hl_job,
                                    tp_gang)
        log(f"[main path] HL training across processes (two gloo ranks on the card, "
            f"summed) launches: {hl_gang_launches}")
        log(f"[main path] tp training across processes ({MESH_TP} gloo ranks on the card, "
            f"summed) launches: {mesh_launches['tp_training']}; MoE training across "
            f"processes (dp = 2 and ep = 2, summed): {mesh_launches['moe_dist_training']}")
        pp_launches, _, pp_gang = timed("mesh pp", phase_mesh_pp, torch, np, smi, tmp,
                                        corpus, tp_gang)
        del tp_gang
        ring_dist_launches, _ = timed("mesh ring", phase_mesh_ring, torch, np, smi, pp_gang)
        del pp_gang
        log(f"[main path] ring training across processes ({MESH_RING_P} gloo ranks on the "
            f"card, summed) launches: {ring_dist_launches}")
        log(f"[main path] pipelined training across processes (ranks summed): GPipe "
            f"train_mr dp = 2 x pp = 2 {pp_launches['pp_gpipe_training']}; 1F1B "
            f"{pp_launches['pp_1f1b_training']}; GPipe at the flagship's dropouts "
            f"{pp_launches['pp_dropout_training']}; a ring inside each stage (GPipe and "
            f"1F1B, dp 1 x pp 2 x tp 2) {pp_launches['pp_ring_training']}")
        long_state, long_batch, long_stats = timed("long", phase_long_train, torch, np,
                                                   fa, sd, smi)
        timed("profile", phase_train_profile, torch, np, fa, smi, corpus, sd,
              long_state, long_batch)
    del long_state, long_batch
    torch.cuda.empty_cache()
    ring_train_launches = timed("ring train", phase_ring_train, torch, np, sd, smi,
                                long_stats)
    log(f"[main path] ring training launches: {ring_train_launches}")
    ring_scan_launches, _ = timed("ring scan", phase_ring_scan, torch, np, sd, smi)
    log(f"[main path] ring training on CUDA graphs (scan_steps=2) launches: "
        f"{ring_scan_launches}")

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "univtg_tpu")]
    if bad:
        raise AssertionError(f"JAX modules were imported: {bad}")

    kernels = _kernel_line(records, train_records, int8_records + served_records,
                           ring_records,
                           {"serving": serve_launches, "training": train_launches,
                            "eval": eval_launches, "reproduce": repro_launches,
                            "int8_tier": quantize_launches,
                            "int8_smoke_call": call_launches,
                            "ring_serving": ring_serve_launches,
                            "ring_training": ring_train_launches,
                            "scan_training": scan_launches,
                            "hl_training": hl_train_launches,
                            "hl_inference": hl_infer_launches,
                            "qfvs_training": qfvs_train_launches,
                            "qfvs_inference": qfvs_infer_launches,
                            "vlp_training": vlp_train_launches,
                            "vlp_dist_training": dist_launches,
                            "vlp_nccl1_training": nccl1_launches,
                            "md_training": md_train_launches,
                            "md_inference": md_infer_launches,
                            "ground": ground_launches,
                            "ground_server": ground_server_launches,
                            "resume_training": resume_launches,
                            "async_ckpt_training": async_launches,
                            "ring_scan_training": ring_scan_launches,
                            "hl_dist_training": hl_gang_launches,
                            "learning_check": learn_launches,
                            "moe_training": moe_train_launches,
                            "moe_inference": moe_infer_launches,
                            "remat_training": remat_launches,
                            "moe_resume_training": moe_resume_launches,
                            "tp_training": mesh_launches["tp_training"],
                            "moe_dist_training": mesh_launches["moe_dist_training"],
                            "ring_dist_training": ring_dist_launches,
                            **pp_launches}, sass)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; seconds by phase "
        f"{json.dumps(PHASE_SECONDS)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

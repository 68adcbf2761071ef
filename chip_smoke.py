"""Quickest proof that the PyTorch port runs on the card: `python3 chip_smoke.py`.

Needs one CUDA card, nvcc (or $CUDA_HOME/bin/nvcc) and no network; exits
non-zero on any failure and when no card is present. Imports nothing of
JAX and nothing of the JAX package. Phases, one line each or more:

1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
   Python's bytecode kept under `.cache/pycache` for the script and every
   process it starts (`keep_bytecode`);
2. build every kernel of the port from csrc/ (one nvcc per source, all
   started together) and print the build seconds, ptxas's registers, shared
   memory and spills per kernel function, and the count of tensor-core
   instructions (`HMMA`) in each function's SASS (`cuobjdump -sass`) — the
   bf16 flash-attention kernels must have some; for the best-IoU kernel
   also its SASS instruction count, its divisions (`MUFU.RCP`) and
   min/max (`FMNMX`), and the length of its innermost loop per pair;
3. each kernel against its plain PyTorch version on the card at the shapes
   the main paths give it (vit_small's attention both contiguous and in
   the model's strided head-split layout) and at ragged and misaligned
   ones, with two times: `ms`, the host loop of 50 wrapper calls between
   CUDA events (Python dispatch included), and `device_ms`, 50 launches
   captured in one CUDA graph and replayed between CUDA events; beside
   them the plain version's time, the library call's (`library_ms` and
   `library_device_ms`, a yardstick the port never calls; none exists for
   best_iou) and the least time the card could take (`bound_ms`). best_iou
   runs fused: the three yolov3 scales as segments of one launch, timed
   as such and each scale alone, and ragged segment sets, one with NaN,
   +-inf and inverted boxes and a zero union, all held bit for bit
   against the plain version;
4. slice 1: `vit_small` at full width served by the port's own
   `serve.cli.build_server` on `cuda` — synthetic `_smoke` load, then
   `POST /predict` over 127.0.0.1 — with every answer held against
   `engine.reference()`, a small input held against the same weights on
   the CPU, and the flash-attention launch count, zeroed just before,
   showing that every dispatch went through the kernel; then
   `torch.profiler` over 5 dispatches of bucket 32 (after 3 warm-up ones)
   splits a dispatch's device time into the flash-attention kernel, GEMMs,
   copies and the rest, beside its wall time;
5. slice 2: `yolov3` at full width (416 px, 80 classes, batch 16) trained
   by the port's own `cli.run_detection` on `cuda` for 3 synthetic steps,
   2 validation batches and one checkpoint — every step's losses finite,
   the best-IoU launch count, zeroed just before, equal to 1 per train step
   and per eval batch, the checkpoint restored into a fresh trainer with
   equal weights, and the loss components of a small input held against
   the same weights on the CPU;
6. slice 5: `vit_small` at full width (batch 256, adam with clip and
   warmup, label smoothing 0.1, dropout 0.1) trained by the port's own
   `cli.run_classification` on `cuda` for 3 synthetic steps, 2 validation
   batches and one checkpoint — every step's loss finite, the
   flash-attention launch count, zeroed just before, equal to 8 per train
   step and per eval batch (the backward, the naive VJP, launches none),
   the checkpoint restored into a fresh trainer with equal weights and
   optimizer state, the loss and gradients of one f32 step on 2 images
   (dropout 0) held against the same weights on the CPU, and the gradient
   through the kernel held against plain autograd through
   `naive_attention` at (32, 6, 197, 64) in the model's strided layout;
   then the kernel's times at the training shape (256, 6, 197, 64) bf16;
7. slice 6: `lenet5` (f32, batch 256, 32 px) trained by the port's own
   `cli.run_classification` on `cuda` for 3 synthetic steps and 2
   validation batches — every step's loss finite, and the loss of one step
   on the same seeded weights and batch equal on the card and on the CPU
   within 1e-5 relative (no kernel is on this path);
8. slice 6: `resnet50_tpu` at full width (Bottleneck ResNet-50, 224 px,
   1000 classes, batch 256, momentum SGD without decay on 1-D tensors,
   label smoothing 0.1, EMA 0.9999) trained by `cli.run_classification`
   with `--device-augment` (uint8 at 256 px staged by the prefetch thread,
   cropped, flipped, jittered and normalized on the card) for 3 synthetic
   steps and 2 validation batches — every step's loss finite, `step_ms`,
   the prefetcher's bytes per batch and overlap, peak memory; the
   checkpoint restored into a fresh trainer with equal weights, BatchNorm
   statistics, momentum and EMA; the loss of one f32 step on 2 images held
   against the CPU within 1e-3 relative, its gradients within 1e-2 of the
   largest; and the device augment on the card against the CPU on the
   same draws. No kernel is on this path: convs, BatchNorm and the head
   run on cuDNN and cuBLAS;
9. slice 7: the classification zoo — `alexnet1` (227 px), `alexnet2`,
   `vgg16`, `vgg19`, `inception_v1`, `mobilenet_v1`, `shufflenet_v1`
   (224 px) and `inception_v3` (299 px), each at full width and its own
   resolution, trained by `cli.run_classification` through its family's
   `MODELS` on `cuda` for 2 synthetic steps at batch 64 and 2 validation
   batches of 32 — every step's loss finite, the parameter count equal to
   the JAX model's, `step_ms` and peak memory; for `mobilenet_v1` and
   `inception_v3` one step on 2 images (dropout off) on the card in f64
   and in f32, each against the same step in f64 on the CPU: in f64
   within 1e-12 (loss) and 1e-9 of the largest gradient, in f32 within
   2e-4 and 1e-1 (f32 gradients are ill-conditioned here: see
   ZOO_GRAD_RTOL);
10. slice 7: `mobilenet_v1` and `inception_v3` served in-process by the
   engine at buckets {1, 8, 32}: every answer held against
   `engine.reference()`, the card against an engine on the CPU on the same
   seeded weights, `measure_batch_ms` per bucket, and the device ms of a
   bucket-32 dispatch by kernel family from the same profiler split as
   phase 4. No kernel is on the paths of phases 9-10: the K1 and K2 launch
   counts, zeroed before them, stay 0;
11. slice 8: data parallelism over torch.distributed. 11a: the yolov3 and
   resnet50_tpu entry points (`YOLO/torch/train.py`,
   `ResNet/torch/train.py`) with phases 5 and 8's batch and cuts, 2
   steps each, under a torchrun launch of one process (NCCL): finite
   losses, the
   best-IoU launch count (at least one per step and eval batch) and
   `step_ms` beside phases 5 and 8's — the cost of the DDP wrap and the
   BatchNorm all-reduces at world 1. 11b: two ranks on the one card over
   gloo (NCCL refuses two ranks on one GPU), each the only process of its
   "host", so both drive card 0 — not a scaling number: yolov3 at 416 px
   (global batch 16, 2 steps, 2 eval batches; each rank's best-IoU count,
   at least 4) and resnet50_tpu at 224 px with the device augment and EMA
   (global batch 64, 2 steps), each through its family's entry point with
   one checkpoint from rank 0; then one f64 resnet50_tpu step at global
   batch 4 against the one-process step on the same images on the card,
   loss, gradients, weights and BatchNorm statistics within the DDP_F64_*
   bounds. 11b's ranks are started when 11a ends and train beside
   phases 12-13 (which run workers of their own on the card too); they
   are collected after phase 13. A worker's failure fails the phase;
12. slice 9: yolov3 inference on phase 5's checkpoint (416 px, 80
   classes). 12a: `make_predict_step` at batch 16 (bf16, NMS at IoU 0.5
   and score 0.05, 100 picks), its time split into the decoded forward
   and greedy NMS by CUDA events (median of 5 after 3), the kernels one
   NMS call launches (`torch.profiler`) and peak memory; NMS on the card
   against NMS on the CPU on identical candidates, every pick equal; the
   card against the CPU on the config's seeded weights in f32 on 2 images
   (the candidates within 1e-3 of each tensor's largest value, the top 10
   picks of each image matched greedily; phase 5's weights overflow the
   box decode's exp()); `evaluate_map` (coco) over 2 synthetic batches,
   every summary value finite. 12b: `YOLO/torch/
   evaluate.py -m yolov3 --synthetic` as a subprocess on the card, started
   once 12a's timings are taken and read at the phase's end (rc 0, a
   finite mAP in its JSON), and detect.py's chunk-to-lines function on 2
   synthetic scenes in its chunk of 8. 12c: yolov3 served at full width by
   `serve.cli.build_server` at buckets {1, 8}: synthetic `_smoke` load,
   answers of 1-9 images and one `POST /predict` of one image (three
   scales as nested lists) held leaf by leaf against
   `engine.reference()`, one image against an engine on the CPU on the
   same seeded weights (each leaf within 1e-1 of its largest value: bf16
   over 75 conv layers), `measure_batch_ms` per bucket. No kernel is on
   this path: the K1 and K2 launch counts, zeroed before it, stay 0;
13. slice 10: CenterNet and stacked-Hourglass pose at full width and 256
   px. 13a: `centernet` (80 classes, 2 stacks, order 5) trained through
   `ObjectsAsPoints/torch/train.py`'s `cli.run_centernet` for 2 synthetic
   steps at batch 32 (the config's 64 cut), 2 validation batches and one
   checkpoint — finite losses, the JAX model's parameter count, step_ms,
   peak memory, the checkpoint restored into a fresh trainer (on a
   zeroed copy of the model) with equal weights, BatchNorm statistics
   and Adam state, the step alone on a
   staged batch (CUDA events; kernels and device busy from the profiler),
   and one step on 2 images on the card in f64 and f32 against the same
   step in f64 on the CPU (phase 9's bounds; the CPU's own f32 step is
   not taken); the
   predict step at batch 32 split into the forward and decode (CUDA
   events), decode on the card against the CPU pick for pick on identical
   coarse heads (ties, zero picks), and `ObjectsAsPoints/torch/
   evaluate.py -m centernet --synthetic` at full width, as a worker
   started with the phase (rc 0, a finite mAP). 13b: the same
   for `hourglass104` (16 joints, 4 stacks, order 4, the config's batch
   128 cut to 32) through `cli.run_pose`, its predict split into the
   forward and the per-joint decode, `evaluate_pckh` on the card against
   the CPU on seeded f32 weights, and `Hourglass/torch/evaluate.py
   --synthetic` (the worker started beside 13a's). 13c: both served by
   the engine at buckets {1, 8}: every answer tree (a dict of heads per
   stack; a heatmap per stack) leaf by leaf against `engine.reference()`,
   one image against an engine on the CPU, `measure_batch_ms` per bucket.
   The CPU's halves (the one-step checks' f64 steps, 13c's CPU engines)
   run on a thread from the phase's start, beside the card's work. No
   kernel is on these paths: the K1 and K2 launch counts, zeroed before
   it, stay 0;
14. slice 11: U-Net segmentation, checkpoint restore, the GANs. 14a:
   `unet_resnet50` (ResNet-50 encoder, 21 classes, 33,759,381 parameters)
   at 224 px and the config's batch of 32, bf16, trained through
   `UNet/torch/train.py`'s `cli.run_segmentation` with the paired device
   augment (uint8 image and mask pairs at 256 px, cropped and flipped
   together on the card) and an EMA for 3 synthetic steps, 2 validation
   batches and one checkpoint — finite losses, mIoU and pixel accuracy,
   the step alone (CUDA events; kernels and device busy from the
   profiler) beside its conv bound, peak memory; one step on 2 images at
   64 px on the card in f64 and f32 against the CPU in f64; the predict
   step at batch 32. 14b (restore into the engine): the U-Net served by
   `serve.cli.build_server --workdir` at buckets {1, 8} — provenance
   `checkpoint` at epoch 1, the served int32 masks against the predict
   step on the restored EMA weights (a pixel may differ only where the
   step's top two logits lie within twice the largest difference of the
   served logits from the step's: such pixels are counted and printed),
   the answer's bytes, `measure_batch_ms`; yolov3 restored from phase 5's
   workdir answering as an engine on the trainer's restored state_dict.
   14c: `dcgan` at the config's batch of 256, 28 px, f32: 3 synthetic
   steps, a checkpoint round trip of both networks and both Adams, 16
   samples, the step alone, one f64 step (dropout off, the same noise)
   card against CPU. 14d: `cyclegan` at 256 px, the config's batch of 8,
   f32, 9 blocks: 2 steps of both phases through the image pools, a
   checkpoint round trip, a batch translated both ways, the step alone
   beside its conv bound and peak memory, one f64 step of each phase at
   64 px card against CPU (the discriminators' BatchNorm statistics after
   the generator phase included). No kernel is on these paths: the K1 and
   K2 launch counts, zeroed at the start of each sub-phase, stay 0.

15. slice 12: resilient training, yolov3 at full width (416 px, batch 16,
   bf16, synthetic, lr 1e-3). 15a: `YOLO/torch/train.py`'s
   `cli.run_detection` for 2 epochs of 3 steps with `--recover-on-
   divergence 1` and the NaN fault (DEEPVISION_FAULT_NAN_STEP) at epoch
   2's second batch: epoch 2 rolls back to epoch 1 and trains again at LR
   scale 0.5, then commits; the events, the epochs, the K2 count (one per
   train step, the diverged and the retried epoch's included, and per
   eval batch; K1's 0), the host-blocking time of `save()` (the
   snapshot), the writer's write and hash times and the bytes, and
   step_ms with a save in flight against step_ms with none (timed after
   15c has ended; the first save, which allocates the pinned buffers, is
   made after 15a). 15b: a
   verified restore timed; the newest epoch bit-flipped; strict mode
   raises; `python -m deepvision_tpu_torch fsck` (its `main`, in-process)
   exits 1, 1 with
   `--quarantine`, then 0; fallback on a copy quarantines `corrupt-2/` and
   lands on epoch 1. 15c, started first and run beside 15a, 15b, 15d
   and 15e: two runs of `YOLO/torch/train.py` (full width, 416 px) as
   subprocesses at once: SIGTERM after the first one's first step line
   (exit 0 with a verified epoch, then `--auto-resume` finishes); SIGKILL
   to the second while a save is in flight with two epochs committed
   (its resume lands on the newest epoch that verifies). 15d: the trainer's
   watchdog (5 s) with an injected abort is quiet through normal steps
   and fires on a stalled iterator. 15b, 15d and 15e each zero the launch
   counts and read them after. 15e: 15a's workdir served by
   `serve.cli.build_server --workdir`: provenance `verified: true` with
   the manifest's digest; a corrupted copy refused.
16. slice 13: running the server, vit_small at full width (224 px) behind
   `serve.cli.build_server`. 16a: 4 epochs trained by `ViT/torch/train.py`'s
   `cli.run_classification` (batch 32, 2 steps an epoch), committed into
   the served run dir one at a time; epoch 1 served over HTTP at buckets
   {1, 8, 32} with 2 dispatcher workers, the promotion gate at -0.02, a
   0.5 canary of 3 s, every request traced; under 3 closed-loop
   in-process clients and one paced HTTP client `POST /reload` promotes
   epoch 2 (shadow eval on the pinned
   shard, both generations through K1; the gate; the canary), refuses
   epoch 3 with DEEPVISION_FAULT_PROMOTE_REGRESS=3:accuracy and caches
   the refusal (a second POST scores nothing), and rolls epoch 4 back in
   the canary with ...=4:latency. Every answer within SERVE_TOL of its
   epoch's `reference()`, no batch span serving two generations, K1's
   launches equal depth x dispatches of both generations; the verified
   load, `stage_candidate`, the shadow eval and `promote_candidate` timed
   alone. 16b: DEEPVISION_FAULT_SERVE_DISPATCH_FAIL=2:3 with K=3: 500s,
   then 503 naming the model (the time from the K-th error to it), and
   after the cooldown a probe that closes the circuit. 16c: closed-loop
   overload at bucket 8 from one worker: the autoscaler grows the pool
   and shrinks it back when the load stops, the parameter storage
   unchanged; images/s and p99 at one worker, then at the peak;
   a client whose accepted request is unanswered after P16_PROBE_S prints
   the batcher's counts and every thread's stack once (the probe of
   ROADMAP Queue C), then waits out its 60 s deadline.
   16d: `/metrics` valid and monotone, `/trace` with one request's chain,
   HTTP p50/p99 at bucket 8 with tracing on and off in turns,
   `render_prometheus` for one model and three. 16e: `python -m
   deepvision_tpu_torch.serve --drain-grace 1` as a subprocess (started
   with the phase) gets SIGTERM under traffic: /healthz "draining" within
   the grace, no answer but 200 or 503 draining, exit 0.
17. slice 14: the replica tier and the flywheel, vit_small at full width
   (224 px, bf16) over phase 16's run. 17a: `python -m
   deepvision_tpu_torch.serve.tier` as a subprocess with 2 replicas on the
   card over a runs root holding epoch 1, the gate armed and
   DEEPVISION_FAULT_PROMOTE_REGRESS=3:accuracy in the replicas'
   environment, the probe and attempt caps set from phase 16d's measured
   latencies: the cold start; 8 closed-loop HTTP clients of one image
   (bucket 8) through the router and straight to one replica (p50/p99,
   images/s, no ejection); one replica SIGKILLed under traffic (zero
   failed responses; the exit, ejection, restart and readmission events;
   the respawn's kernel record: flash_attention loaded from the shared
   build cache, `cache_misses == 0`); `POST /roll` of epoch 2 promoting
   both replicas and of epoch 3 stopping after the first (the other never
   asked); the merged `/metrics` valid with a `replica` label; every
   answer within SERVE_TOL of its epoch's `reference()`; each replica's
   K1 launches equal to depth x its dispatches (its /healthz); SIGTERM to
   the router: exit 0, no 5xx. 17b: the server in-process with the gate
   and `--flywheel-every`, DEEPVISION_FAULT_DRIFT_SHIFT armed, under
   in-process traffic: one episode promoted (drift over 3 windows, a
   fine-tune of 1 epoch x 2 batches at batch 256 on the card, commit,
   gate, canary), then a new drift with every candidate regressing: one
   refusal and the circuit open at max_attempts 1; K1's launches
   equal depth x (fine-tune steps + dispatches of both generations), K2's
   0; every answer against its epoch's reference; one flywheel_id on the
   events, the spans, the decision record and /healthz.

18. slices 15-16: real datasets, built by the port's builders and
   decoded on the card. The script writes raw trees from seeded images at
   500x375 and 375x500 (nvJPEG 4:2:0 q90, one grayscale in 32): an ILSVRC
   `train/<synset>/` and `validation/` tree with its label files, a
   `VOCdevkit/VOC2007` tree (XMLs, `ImageSets/Main`), MPII's
   `{train,validation}.json`, COCO's `instances_{train,val}2017.json` and
   CycleGAN's `trainA/trainB`, with the committed gray JPEG and PNG of
   tests/fixtures/reencode among them. The builders run on the card:
   `python -m deepvision_tpu_torch.datasets.voc2007` as a subprocess from
   the start, ImageNet, MPII, COCO and CycleGAN in process; each one's
   records, bytes and images/s; their re-encodes of the committed sources
   against PIL's (`<name>.pil95.jpg`) within P18_REENCODE_MAX/_MEAN; a CMYK
   JPEG refused by name. 18a: the committed fixtures (tests/fixtures/jpeg)
   decoded by nvJPEG and held to their PIL goldens (= libjpeg's
   INTEGER_ACCURATE) within P18_DECODE_TOL, the gap to TensorFlow's
   default decode beside it; the fused resample kernel against its plain
   version; a batch of 256 decoded, device ms and images/s, with the
   decoder's record. 18b: `ResNet/torch/train.py -m resnet50_tpu
   --data-dir <records>` at full width (224 px, batch 256) with
   `--device-augment` and again with `--device-normalize --cache-val`, 3
   steps and one eval batch each: step_ms, `host_data_wait` a step
   (`--trace-out`) and after the first batch, 0 bytes staged by the
   prefetcher, the compressed bytes the card received; then the loader
   alone, images/s, and the cached val pipeline (the val file opened
   once over two passes). 18c: `vit_small` from the same records with
   `--profile-dir`, 2 steps at batch 256: K1's launches exactly 8 x
   (steps + eval batches), and K1's kernel named in the trace. 18d:
   `yolov3 --num-classes 20` from the VOC builder's records (416 px,
   batch 16, 3 steps): K2 once a step and an eval batch, the run log's
   first line its provenance header (printed); then `-c latest
   --eval-only` on the val split through a `file://` URL, K2 once an eval
   batch, the loss equal to the training run's evaluation; then
   `YOLO/torch/evaluate.py` on phase 5's checkpoint over the COCO
   builder's val records, its ragged batch kept. 18e: `hourglass104` from
   the MPII builder's records (256 px, 2 steps) and
   `Hourglass/torch/evaluate.py` on their val split; `cyclegan` from the
   CycleGAN builder's records (256 px, batch 8, 2 steps).

19. slice 17: the training step's levers. 19a: vit_small at full width
   (224 px, batch 256, dropout 0.1) through the Trainer with `remat`,
   mixup (0.2) and `log_grad_norm`, 3 steps on batches drawn on the card,
   and the same 3 steps without remat from the same seed: the losses and `grad_norm` within
   P19_REMAT_RTOL, `grad_norm` finite and in the run log, K1 counted
   exactly in both runs (depth x steps without remat; the recompute's
   launches on top with it), the peak memory of each. 19b:
   `ViT/torch/train.py -m vit_small --synthetic --cutmix-alpha 1.0
   --steps-per-dispatch 2`, 10 steps at batch 64: 5 dispatches of 2, the run log's
   records at dispatch ends only, K1 exactly depth x (steps + eval
   batches). 19c: `YOLO/torch/train.py -m yolov3 --synthetic --image-size
   416 --epoch-on-device --log-grad-norm --epochs 2` (batch 16, 3 steps):
   epoch 2 pulls no host batch, K2 exactly once a step and an eval batch,
   the shuffle a permutation, the epoch cache's bytes; then 1 epoch with
   DEEPVISION_EPOCH_CACHE_MAX_BYTES small: EpochCacheOverflowWarning by
   name and the epoch trained by the staged loop. 19d: resnet50_tpu (its
   EMA, the device augment, batch 256) through the Trainer, 8 steps on
   batches drawn on the card with `steps_per_dispatch` 4 against k = 1
   twice: the parameters and EMA
   within P19_K_RTOL of k = 1 (the two k = 1 runs give cuDNN's own
   spread), a dispatch's device and host ms. 19e: `python -m
   deepvision_tpu_torch.tools.classify -m vit_small --workdir <19b's run>
   <a JPEG>` (nvJPEG): K1 exactly depth, the top-5 the served engine's
   for the same preprocessed image (a difference only between near
   ties).

20. slice 18: int8 serving. 20a: vit_small at full width served at int8
   by `serve/quantize.py::arm_int8` on its 64-image pinned shard, at
   buckets 1, 8 and 32: the plan (49 quantized, 1 f32 head, 8 attention
   calls left on K1) and one calibration; one int8 dispatch per bucket
   with K1's launches (depth a dispatch), the int8 products
   (`ops/quant.py::int8_matmul`, `int8_depthwise`) and the dispatches by
   precision counted, zeroed just before and read just after; int8 against
   bf16 on the shard (argmax agreement, the largest difference over the
   largest logit, at most P20_REL_MAX); the int32 accumulator of the first
   query projection from the operands the int8 forward gives it on the
   card, bit for bit the CPU's; `measure_batch_ms` per bucket at bf16 and
   at int8; the f32 master, int8 and staged byte counts, the bytes
   resident per precision and what arming added to the card's allocated
   memory. 20b: resnet50_tpu the same (53 / 1 / 0), the accumulators of
   the 7x7 stem (k = 147) and of a 1x1 conv. 20c: mobilenet_v1 at bucket
   1 (27 / 1 / 0): the depthwise path runs, the stem's and a depthwise
   conv's accumulators card vs CPU. 20d: the serving stack, vit_small:
   DEEPVISION_FAULT_QUANT_REGRESS=1 on 20a's engine, gated on the pinned
   images labelled by its own bf16 answers (seeded random weights score
   about 0 on 1000 classes, and the fault's drop is clipped at 0):
   `refused_regression`, bf16 serving on, int8 requests refused; `--serve-precision int8` through
   `build_server` on phase 16's epoch 1, armed before traffic; over HTTP
   the default answer (int8) and a `"precision": "bf16"` override against
   the engine, /healthz `precision` and `quant`, /metrics with its int8
   series valid; epoch 2 hot-reloaded by `POST /reload`: its answer
   within P20_RELOAD_TOL of epoch 2's own int8 under the same quantizer,
   one calibration in the whole of 20d.

21. slice 19: model export and the PyTorch checkpoint importer. 21a:
   `python -m deepvision_tpu_torch.tools.export -m vit_small` on phase 6's
   run at `--batch-size 8` with `--saved-model` and `--tflite`, started
   as a process on the card when phase 6 ends (two inductor compile
   workers) and collected here: the program (`load_program`) and the
   AOTInductor package (`load_package`) each run once on the card, K1's
   launches zeroed before and read after each call (depth, 8, each: the
   package calls the operator through its proxy executor), both against
   the engine's eager answer on the same restored weights; the export,
   compile and load seconds and the ms a call of the eager module, the
   program and the package. 21b: `CycleGAN/torch/convert.py` on phase
   14d's cyclegan run at 256 px, started when phase 14 ends: no
   transposed convolution left in its program, no operator of the port
   in its package, K1 and K2 idle, the package against the eager
   generator; the eager generator's, the raw export's, the rewritten
   program's and the package's ms a call (the rewrite's cost). 21c:
   `Hourglass/torch/main.py` on phase 18e's hourglass104 run with
   `--checkpoint latest` and the epochs it has: nothing trains, the best
   epoch's directory copied file for file, output.txt naming it. 21d: a
   reference-named ResNet-50 `.pt` from seeded tensors through
   `python -m deepvision_tpu_torch.tools.import_torch_checkpoint`, served
   in process at bucket 8 from the workdir on the card and on the CPU:
   the pins, the verified epoch, card against CPU.
22. slice 20: the Keras, call-order and GAN checkpoint importers, their
   files written by the script's own HDF5 and tensor-bundle writers (the
   card's machine has neither h5py nor TensorFlow; a CPU test reads both
   writers' files back with h5py and TensorFlow). 22a: yolov3 at full
   width (80 classes) as seeded weights in the reference's layer names,
   an h5 of the reference's layout, `python -m deepvision_tpu_torch.tools.
   import_keras_checkpoint -m yolov3 --epoch 40` on the card: every
   imported leaf equal to the file's, the raw heads of the workdir's
   weights on the card against the CPU in f32 at batch 1, 416 px; then
   `YOLO/torch/train.py` (phase 15's arguments) resumes it with `-c
   latest` for 2 steps and its 2 eval batches, K2's launches zeroed just
   before and counted just after: one a step and an eval batch. 22b:
   hourglass104 at full width as auto-named `conv2d_<k>` /
   `batch_normalization_<k>` groups in the port model's call order (on
   the card this checks the reader and the tool; the order itself is held
   to JAX's on the CPU), imported with `-m hourglass104`, served one batch
   in process on the card against the CPU. 22c: dcgan and cyclegan (9
   blocks, 256 px) as `tf.train` bundles in TF 2.1's
   `layer_with_weights-N` names with their `step` / `epoch` counters,
   through `python -m deepvision_tpu_torch.tools.import_gan_checkpoint`
   on the card (the decoder library's CRC32C): the counter's epoch, every
   leaf equal to the bundle's, one generator call on the card against the
   CPU. K1 and K2 idle in 22b-c. The write, import, resume and compare
   seconds of each.
23. slice 21: the IR audit (`deepvision_tpu_torch/check`). 23a: `python
   -m deepvision_tpu_torch.check vit_small yolov3 attn quant --format
   json`, started at the script's start as a process of its own on the
   CPU (fake tensors, no card) at nice +10 and collected here: exit 0, its
   FLOPs equal to the committed CHECK_COST_TORCH.json's, its bytes and op
   counts within the audit's tolerance (the baseline is written on
   another PyTorch release). 23b: phase 21a's vit_small program (exported
   on the card at batch 8) called once under the audit's recorder: 8 K1
   nodes and 8 K1 launches, each node's output against the plain version
   on its own inputs, FLOPs equal to the `vit_small/serve` row. 23c: one
   real yolov3 train step at 416 px on the card at the audit's batch,
   under the same recorder: 1 `deepvision.best_iou` node and 1 K2 launch,
   its output bit for bit against `best_iou_reference`, FLOPs equal to
   the fake-traced `yolov3/train` row.

The line before the last is a JSON object with one record per kernel; the
last is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import atexit
import copy
import dataclasses
import concurrent.futures
import filecmp
import functools
import json
import os
import re
import runpy
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from deepvision_tpu_torch.cli import (run_centernet, run_classification,
                                      run_detection, run_pose,
                                      run_segmentation)
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import (DetectionTrainer,
                                                 evaluate_map,
                                                 make_predict_step,
                                                 predict_candidates,
                                                 yolo_grid_sizes)
from deepvision_tpu_torch.core.centernet import (CenterNetTrainer,
                                                 make_centernet_predict_step,
                                                 make_centernet_train_step,
                                                 predict_heads)
from deepvision_tpu_torch.core import export as model_export
from deepvision_tpu_torch.core import integrity, scoring
from deepvision_tpu_torch.core.checkpoint import (CheckpointCorruptionError,
                                                  CheckpointManager)
from deepvision_tpu_torch.core.eval_pose import evaluate_pckh
from deepvision_tpu_torch.core.gan import (CycleGANTrainer, DCGANTrainer,
                                           make_cyclegan_discriminator_step,
                                           make_cyclegan_generator_step,
                                           make_dcgan_train_step)
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.pose import PoseTrainer, make_pose_train_step
from deepvision_tpu_torch.core.segment import (
    SegmentationTrainer, make_segmentation_predict_step,
    make_segmentation_train_step)
from deepvision_tpu_torch.core.steps import make_classification_train_step
from deepvision_tpu_torch.core.config import decode_image_size
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data import device_augment as daug
from deepvision_tpu_torch.data.class_names import names_for
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.data.gan import (synthetic_mnist_batches,
                                           synthetic_two_domain_batches)
from deepvision_tpu_torch.data.pose import \
    synthetic_batches as pose_synthetic_batches
from deepvision_tpu_torch.data.segmentation import SyntheticSegmentation
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.models.common import ConvTranspose, Dropout
from deepvision_tpu_torch.models.gan import (CycleGANGenerator,
                                             DCGANDiscriminator,
                                             DCGANGenerator,
                                             PatchGANDiscriminator)
from deepvision_tpu_torch.obs.export import (chrome_trace,
                                             parse_prometheus_text,
                                             render_prometheus,
                                             validate_prometheus_text,
                                             validate_serve_exposition)
from deepvision_tpu_torch.ops import _build
from deepvision_tpu_torch.data import jpeg, util
from deepvision_tpu_torch.data import records as recs
from deepvision_tpu_torch.ops import centernet as cn_ops
from deepvision_tpu_torch.ops import yolo as yolo_ops
from deepvision_tpu_torch.ops.attention import (flash_attention,
                                                flash_attention_reference,
                                                naive_attention)
from deepvision_tpu_torch.ops.best_iou import best_iou, best_iou_reference
from deepvision_tpu_torch.ops.heatmap import decode_keypoints
from deepvision_tpu_torch.ops.nms import batched_nms
from deepvision_tpu_torch.ops import quant
from deepvision_tpu_torch.parallel import mesh
from deepvision_tpu_torch.serve.batcher import (DeadlineExpired,
                                                RequestRejected,
                                                result_within)
from deepvision_tpu_torch.serve.cli import _smoke, build_parser, build_server
from deepvision_tpu_torch.serve.engine import (PredictEngine, config_at,
                                               load_checkpoint_weights,
                                               pick_bucket)
from deepvision_tpu_torch.serve.fleet import ModelFleet
from deepvision_tpu_torch.serve.quantize import arm_int8
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils.device import resolve_device
from deepvision_tpu_torch.utils.faults import FaultInjector
from deepvision_tpu_torch.tools import (import_gan_checkpoint,
                                        import_keras_checkpoint,
                                        import_torch_checkpoint)
from deepvision_tpu_torch.tools.gan_images import tile_grid
from deepvision_tpu_torch.tools.build_report import (count_opcodes,
                                                     demangle, loop_report,
                                                     ptxas_by_function,
                                                     sass_by_function)
from deepvision_tpu_torch.check.walk import Recorder
from deepvision_tpu_torch.utils.timing import graph_ms, loop_ms
from deepvision_tpu_torch.utils import order_convert
from deepvision_tpu_torch.utils.keras_convert import stage_blocks_of
from deepvision_tpu_torch.utils.tf_checkpoint import crc32c_np

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = "vit_small"
BUCKETS = (1, 8, 32)
YOLO_MODEL = "yolov3"
YOLO_BATCH = 16
YOLO_STEPS = 3
YOLO_EVAL_BATCHES = 2          # the synthetic validation set
# best_iou against its plain version: both run the same f32 operations in
# the same order (IEEE division, no FMA contraction), so the check is bit
# for bit (NaN where the plain version has NaN); IOU_TOL, the JAX package's
# bound (tests/test_pallas_kernels.py), caps the reported max_abs_err too
IOU_TOL = 1e-6
# yolov3 loss components, card (f32 compute, best-IoU kernel, cuDNN with
# TF32 off) vs CPU (f32, plain version) on the same seeded weights, relative
# to each component: only summation orders differ, and BatchNorm in train
# mode renormalizes every layer, so the difference stays near f32 rounding
# grown over 75 conv layers
YOLO_CPU_RTOL = 1e-3
VIT_BATCH = 256
VIT_STEPS = 3
VIT_EVAL_BATCHES = 2           # the synthetic validation set
# vit_small loss and gradients of one f32 step, card (flash kernel
# forward, naive VJP, cuBLAS with TF32 off) vs CPU (the kernel's plain
# version, the same VJP) on the same weights, relative to each tensor's
# largest gradient (the key biases, whose gradient is 0, to the model's
# largest): only summation orders differ, over 8 blocks in f32
VIT_CPU_RTOL = 1e-3
VIT_GRAD_SHAPE = (32, 6, 197, 64)
LENET_MODEL = "lenet5"
LENET_STEPS = 3
# lenet5's loss, card (f32, cuDNN with TF32 off) vs CPU on the same weights
# and batch: 5 small layers in f32
LENET_CPU_RTOL = 1e-5
RESNET_MODEL = "resnet50_tpu"
RESNET_BATCH = 256
RESNET_STEPS = 3
RESNET_EVAL_BATCHES = 2
# resnet50 loss of one f32 step on 2 images, card vs CPU, relative; and
# its gradients, relative to the model's largest gradient. Per tensor they
# are ill-conditioned: BatchNorm's backward in train mode leaves each conv
# a gradient orthogonal to its own output, a small remainder of large
# terms, so the CPU alone moves the last stage's conv gradients by up to
# 22% of their largest value, and by 1.5e-3 of the model's largest
# gradient, between 1 and 8 threads (summation order only)
RESNET_CPU_RTOL = 1e-3
RESNET_GRAD_RTOL = 1e-2
# the zoo: config -> (family entry point, parameters of the JAX model at
# 1000 classes in train mode, aux heads included)
ZOO = {"alexnet1": ("AlexNet", 62_378_344), "alexnet2": ("AlexNet",
                                                         61_838_248),
       "vgg16": ("VGG", 138_357_544), "vgg19": ("VGG", 143_667_240),
       "inception_v1": ("Inception", 13_385_816),
       "inception_v3": ("Inception", 27_161_264),
       "mobilenet_v1": ("MobileNet", 4_231_976),
       "shufflenet_v1": ("ShuffleNet", 1_865_728)}
ZOO_MODELS = {"AlexNet": ["alexnet1", "alexnet2"], "VGG": ["vgg16", "vgg19"],
              "Inception": ["inception_v1", "inception_v3"],
              "MobileNet": ["mobilenet_v1"], "ShuffleNet": ["shufflenet_v1"]}
# the configs' batches are 128-512; 64 keeps eight trainings' synthetic
# input (numpy on the host) within the time limit
ZOO_BATCH = 64
ZOO_STEPS = 2
ZOO_EVAL_BATCH = 32            # 2 validation batches: one batch of 64
ZOO_SERVED = ("mobilenet_v1", "inception_v3")
# one step of the zoo's BASELINE pair on 2 images, dropout off. In f64 the
# card computes the CPU's function: loss within 1e-12, gradients within
# 1e-9 of the largest. In f32 the gradients are ill-conditioned (random
# weights, train-mode BatchNorm over 2 images: the first convs' weight
# gradients are small remainders of large terms), so the CPU's f32
# gradients already lie about 1e-2 of the largest gradient from the f64
# ones (phase 9 prints it) and phase 8's card-vs-CPU bound cannot hold:
# the card's f32 step is held to the CPU's f64 one, its loss within 2e-4,
# its gradients within 1e-1 of the largest
ZOO_F64_LOSS_RTOL = 1e-12
ZOO_F64_GRAD_RTOL = 1e-9
ZOO_LOSS_RTOL = 2e-4
ZOO_GRAD_RTOL = 1e-1
# the device augment, card vs CPU on the same draws, in f32: the contrast
# and saturation means sum in another order
AUGMENT_TOL = 1e-4
# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: f32 differs only in summation order (the
# plain version's matmuls run in full f32: TF32 is switched off below);
# bf16 inputs with f32 accumulation differ by at most ~1 bf16 rounding of
# the output
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# served answers vs engine.reference(): both run the same bf16 model on
# the card; they differ only where cuBLAS picks another GEMM for the padded
# bucket than for the exact batch, i.e. in bf16 roundings of activations
SERVE_TOL = 5e-2
# card (bf16, flash kernel) vs CPU (bf16, the kernel's plain version) on
# the same seeded weights, relative to the largest logit: bf16 keeps ~0.4%,
# and activations rounded after differently ordered GEMM sums compound over
# depth 8
CPU_RTOL = 5e-2


# -- best_iou check data: seeded boxes and the edge cases --------------------

def random_boxes(b: int, n: int, gen) -> torch.Tensor:
    """(b, n, 4) corner boxes in the unit square (some reaching past it)."""
    xy = torch.rand(b, n, 2, generator=gen) * 0.9
    wh = torch.rand(b, n, 2, generator=gen) * 0.35
    return torch.cat([xy, xy + wh], dim=-1)


def padded_gt(b: int, m: int, gen) -> torch.Tensor:
    """(b, m, 4) GT whose rows past a random count per image are zero."""
    count = torch.randint(0, m + 1, (b, 1), generator=gen)
    return random_boxes(b, m, gen) * (torch.arange(m)[None, :]
                                      < count)[..., None]


def spoil(boxes: torch.Tensor, gen,
          values=(float("nan"), float("inf"), float("-inf"))
          ) -> torch.Tensor:
    """`boxes` with some coordinates set to each of `values` and some boxes
    inverted (x2 < x1, or both axes): the plain version's IEEE semantics
    at the edges."""
    out = boxes.clone()
    n = out.shape[0] * out.shape[1]
    flat = out.view(n, 4)
    for value in values:
        rows = torch.randint(0, n, (max(1, n // 50),), generator=gen)
        cols = torch.randint(0, 4, rows.shape, generator=gen)
        flat[rows, cols] = value
    for order in ([2, 1, 0, 3], [2, 3, 0, 1]):  # x inverted; both
        rows = torch.randint(0, n, (max(1, n // 20),), generator=gen)
        flat[rows] = flat[rows][:, order]
    return out


def ragged_preds(gen) -> list:
    """Segments of 1, 130 and 507 boxes for 2 images with NaN, +-inf and
    inverted boxes, and one box of area -1e-7, whose union with a zero GT
    row is 0 (0 / 0 = NaN)."""
    preds = [spoil(random_boxes(2, n, gen), gen) for n in (1, 130, 507)]
    preds[1][1, 0] = torch.tensor([1e-7, 0.0, 0.0, 1.0])
    return preds


def ragged_gt(gen) -> torch.Tensor:
    """(2, 300, 4) padded GT, more than one shared-memory chunk, with +-inf
    coordinates and inverted boxes in both images and one NaN in image 0
    only (a NaN GT makes its image's every IoU NaN)."""
    gt = spoil(random_boxes(2, 300, gen), gen, (float("inf"), float("-inf")))
    gt[:, 250:] = 0.0
    gt[0, 7, 1] = float("nan")
    return gt


def same(out: torch.Tensor, ref: torch.Tensor) -> bool:
    """Bit for bit up to the sign of zero and NaN's payload: NaN exactly
    where `ref` has NaN, equal values elsewhere."""
    nan = torch.isnan(ref)
    return (out.shape == ref.shape and torch.equal(torch.isnan(out), nan)
            and torch.equal(out[~nan], ref[~nan]))


def abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref|, 0 where both are equal (the same +-inf
    included) or both NaN; NaN where only one of them is NaN."""
    agree = (out == ref) | (torch.isnan(out) & torch.isnan(ref))
    return torch.where(agree, 0.0, (out - ref).abs()).max().item()


T_IMPORTED = time.perf_counter()


# what else trains on the card while a line is printed (11b's ranks run
# beside phases 12-13): such a line's times do not compare with a run
# that had the card alone
BESIDE: set = set()


def phase(msg: str) -> None:
    """One line of the script's log, stamped with the seconds since the
    script was imported (where the whole run's time goes) and with what
    else is training on the card."""
    beside = "".join(f" beside {b}" for b in sorted(BESIDE))
    print(f"[chip_smoke +{time.perf_counter() - T_IMPORTED:.1f}s{beside}] "
          f"{msg}", flush=True)


# the bf16 flash-attention kernels, (DMAX, 16-byte copies), as their
# Itanium-mangled template arguments spell them
TC_KERNELS = {(dmax, vec): f"flash_attention_fwd_tcILi{dmax}ELb{int(vec)}EE"
              for dmax in (64, 128) for vec in (True, False)}


def check_tensor_cores(hmma: dict) -> None:
    """Fails unless the SASS's {mangled kernel: HMMA count} lists every
    bf16 flash-attention kernel once, each with tensor-core instructions."""
    for key, tag in TC_KERNELS.items():
        counts = [n for raw, n in hmma.items() if tag in raw]
        if len(counts) != 1 or counts[0] < 1:
            raise AssertionError(
                f"bf16 flash-attention kernel (DMAX, 16-byte) {key}: HMMA "
                f"counts in the SASS {counts}, want one kernel with at "
                f"least one")


def report_build(names) -> dict:
    """Per kernel function: ptxas's resources and the SASS's HMMA count
    (the bf16 attention kernels must use the tensor cores); for best_iou
    also its SASS counts (`sass_counts`). Returns those counts."""
    k2 = {}
    for lib in names:
        ptxas = ptxas_by_function(_build.BUILD_INFO.get(lib, {})
                                  .get("ptxas", ""))
        sass = sass_by_function(str(_build._target(lib)))
        hmma = {raw: count_opcodes(instrs, r"H(G)?MMA\b")
                for raw, instrs in sass.items()}
        mangled = sorted(set(ptxas) | set(hmma))
        for raw, name in zip(mangled, demangle(mangled)):
            phase(f"{lib}: {name}: {ptxas.get(raw, 'cached build')}; "
                  f"HMMA in SASS: {hmma.get(raw, 'not found')}")
        if lib == "flash_attention":
            check_tensor_cores(hmma)
        if lib == "best_iou":
            k2 = sass_counts(sass)
            phase(f"best_iou SASS: {json.dumps(k2)}")
    return k2


def sass_counts(sass: dict) -> dict:
    """The best-IoU kernel's SASS: its instructions, divisions (MUFU.RCP,
    one per pair) and NaN-propagating min/max (FMNMX), and its innermost
    loop with the most divisions (the unrolled pairs): that loop's length
    per pair is what one (n, m) pair costs in issue slots, against the 16
    operations of the bound."""
    raw = [k for k in sass if "best_iou" in k]
    if len(raw) != 1:
        raise AssertionError(f"best_iou kernels in the SASS: {raw}")
    instrs = sass[raw[0]]
    loop = loop_report(instrs, "MUFU.RCP")
    return {"instructions": len(instrs),
            "MUFU.RCP": count_opcodes(instrs, r"MUFU\.RCP"),
            "FMNMX": count_opcodes(instrs, r"FMNMX"),
            "loop": loop,
            "loop_instructions_per_pair": (
                loop["instructions"] / loop["MUFU.RCP"] if loop else None)}


def attention_bound(shape, dtype):
    """Least time for softmax(QK^T)V on `shape`: Q, K, V read once and O
    written once, against 2 products of 2*B*H*N*N*D operations."""
    b, h, n, d = shape
    nbytes = 4 * b * h * n * d * torch.finfo(dtype).bits // 8
    flops = 4 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_qkv(shape, dtype, gen, layout: str = "contiguous"):
    """q, k, v of (B, H, N, D) on the card: `contiguous`; `strided`, the
    model's (B, N, H*D) projections viewed as (B, H, N, D); `offset_1`,
    rows off 16 bytes (the kernel's scalar-copy variant)."""
    b, h, n, d = shape
    if layout == "strided":
        return [torch.randn((b, n, h * d), generator=gen).to("cuda", dtype)
                .view(b, n, h, d).permute(0, 2, 1, 3) for _ in range(3)]
    if layout == "offset_1":
        return [torch.randn(b * h * n * d + 1, generator=gen)
                .to("cuda", dtype)[1:].view(shape) for _ in range(3)]
    return [torch.randn(shape, generator=gen).to("cuda", dtype)
            for _ in range(3)]


def check_attention(shape, dtype, gen, timed: bool,
                    layout: str = "contiguous") -> dict:
    q, k, v = make_qkv(shape, dtype, gen, layout)
    out = flash_attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype:
        raise AssertionError(f"flash_attention gave {tuple(out.shape)} "
                             f"{out.dtype} for {tuple(shape)} {dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "layout": layout, "max_abs_err": err}
    line = (f"flash_attention {rec['dtype']} {tuple(shape)} {layout}: "
            f"max_abs_err={err:.3g}")
    if err > TOL[dtype] or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{line} exceeds {TOL[dtype]:g}")
    if timed:
        bound, bound_by = attention_bound(shape, dtype)
        kernel = functools.partial(flash_attention, q, k, v)
        library = functools.partial(F.scaled_dot_product_attention, q, k, v)
        rec.update(
            ms=loop_ms(kernel), device_ms=graph_ms(kernel),
            plain_ms=loop_ms(lambda: flash_attention_reference(q, k, v), 10),
            library_ms=loop_ms(library), library_device_ms=graph_ms(library),
            bound_ms=bound, bound_by=bound_by)
        line += (f" ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
                 f"plain_ms={rec['plain_ms']:.4f} "
                 f"library_ms={rec['library_ms']:.4f} "
                 f"library_device_ms={rec['library_device_ms']:.4f} "
                 f"bound_ms={bound:.5f} ({bound_by}) "
                 f"device_ms/bound={rec['device_ms'] / bound:.2f} "
                 f"device_ms/library_device_ms="
                 f"{rec['device_ms'] / rec['library_device_ms']:.2f}")
    phase(line)
    return rec


def best_iou_bound(b: int, n: int, m: int):
    """Least time for best_iou at (b, n, 4) x (b, m, 4), n the predicted
    boxes of all segments: predictions and GT read once and the (b, n)
    output written once, against 16 f32 operations per (n, m) pair
    (csrc/best_iou.cu) at the f32 peak of the CUDA cores."""
    t_bytes = (b * n * 16 + b * m * 16 + b * n * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 16 * b * n * m / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_best_iou(preds, gt, timed: bool) -> dict:
    """best_iou of `preds` (one (B, N, 4) tensor or a list of segments)
    against `gt` on the card, one launch, held bit for bit against the
    plain version; with `timed`, its times beside the bound."""
    single = isinstance(preds, torch.Tensor)
    preds = [p.cuda() for p in ([preds] if single else preds)]
    gt = gt.cuda()
    arg = preds[0] if single else preds
    before = best_iou.launches
    outs = best_iou(arg, gt)
    launched = best_iou.launches - before
    outs = [outs] if single else outs
    refs = best_iou_reference(preds, gt)
    torch.cuda.synchronize()
    b, m = gt.shape[0], gt.shape[1]
    segments = [[b, p.shape[1], m] for p in preds]
    for out, p in zip(outs, preds):
        if out.shape != p.shape[:2] or out.dtype != torch.float32:
            raise AssertionError(f"best_iou gave {tuple(out.shape)} "
                                 f"{out.dtype} for {tuple(p.shape)}")
    err = max(abs_err(o, r) for o, r in zip(outs, refs))
    exact = all(same(o, r) for o, r in zip(outs, refs))
    n = sum(p.shape[1] for p in preds)
    rec = {"shape": [b, n, m], "segments": segments, "max_abs_err": err}
    line = (f"best_iou {'single' if single else 'fused'} "
            f"{[s[1] for s in segments]} of B={b}, M={m}: launches="
            f"{launched} max_abs_err={err:.3g} bit_for_bit={exact}")
    if launched != 1 or not err <= IOU_TOL or not exact:
        raise AssertionError(f"{line}: want 1 launch, equal to the plain "
                             f"version")
    if timed:
        bound, bound_by = best_iou_bound(b, n, m)
        kernel = functools.partial(best_iou, arg, gt)
        rec.update(ms=loop_ms(kernel), device_ms=graph_ms(kernel),
                   plain_ms=loop_ms(lambda: best_iou_reference(arg, gt), 10),
                   library_ms=None, library_device_ms=None, bound_ms=bound,
                   bound_by=bound_by)
        line += (f" ms={rec['ms']:.4f} device_ms={rec['device_ms']:.5f} "
                 f"plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={bound:.5f} ({bound_by}) device_ms/bound="
                 f"{rec['device_ms'] / bound:.2f}")
    phase(line)
    return rec


def yolo_loss_components(model, batch, device) -> dict:
    """Per-image yolov3 loss components of `batch` through a copy of
    `model` on `device`, BatchNorm in train mode, no update."""
    m = copy.deepcopy(model).to(device).train()
    images, boxes, classes, valid = (torch.from_numpy(a).to(device)
                                     for a in batch)
    c = m.num_classes
    onehot = (classes.long()[..., None]
              == torch.arange(c, device=device)).float()
    grids = yolo_grid_sizes(images.shape[1])
    with torch.no_grad():
        y_trues = yolo_ops.encode_labels(onehot, boxes, valid, grids)
        comp = yolo_ops.yolo_loss(y_trues, m(images), boxes, valid, c)
    return {k: v.cpu() for k, v in comp.items()}


def check_yolo_slice() -> dict:
    """Slice 2: yolov3 training through the port's own entry point. Its
    workdir, with the epoch-1 checkpoint, stays for phase 12 and goes when
    the script exits."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_yolo_")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    best_iou.launches = 0            # counts of the main path only
    t0 = time.perf_counter()
    trainer, result = run_detection("YOLO", [YOLO_MODEL], [
        "-m", YOLO_MODEL, "--synthetic", "--image-size", "416",
        "--batch-size", str(YOLO_BATCH), "--steps-per-epoch",
        str(YOLO_STEPS), "--epochs", "1", "--device", "cuda",
        "--workdir", workdir])
    wall = time.perf_counter() - t0
    launches = best_iou.launches
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.config
    if (cfg.data.image_size, cfg.data.num_classes, cfg.batch_size) != (
            416, 80, YOLO_BATCH):
        raise AssertionError(f"yolov3 ran at {cfg.data}")
    steps = trainer.last_epoch_steps
    for i, s in enumerate(steps):
        phase(f"yolov3 step {i + 1}: " + " ".join(
            f"{k}={v:.4f}" for k, v in s.items()))
    if len(steps) != YOLO_STEPS or not all(
            np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"yolov3 steps not all finite: {steps}")
    val_loss = result.get("loss", float("nan"))
    if result.get("count") != YOLO_EVAL_BATCHES or not np.isfinite(
            val_loss):
        raise AssertionError(f"yolov3 validation: {result}")
    dispatches = YOLO_STEPS + YOLO_EVAL_BATCHES
    phase(f"main path: {YOLO_STEPS} train steps + {YOLO_EVAL_BATCHES} "
          f"eval batches, {launches} best_iou launches; val_loss="
          f"{val_loss:.4f}; run_detection {wall:.1f}s")
    if launches != dispatches:
        raise AssertionError(f"best_iou ran {launches} times for "
                             f"{dispatches} dispatches, want one each "
                             f"(all 3 scales in one launch)")
    step_ms = statistics.median(s["step_ms"] for s in steps[1:])
    phase(f"yolov3 train step (batch {YOLO_BATCH}, 416 px, bf16): "
          f"step_ms={step_ms:.3f} (median after the first; first "
          f"{steps[0]['step_ms']:.3f}) images_per_sec="
          f"{YOLO_BATCH / step_ms * 1e3:.2f} peak_memory_allocated="
          f"{peak / 2**30:.3f} GiB")

    fresh = DetectionTrainer(cfg, device="cuda", workdir=workdir)
    fresh.init_state()
    if fresh.resume() != 1:
        raise AssertionError("the epoch-1 checkpoint did not restore")
    want, got = trainer.state.state_dict(), fresh.state.state_dict()
    same = (all(torch.equal(v, got["model"][k])
                for k, v in want["model"].items())
            and want["step"] == got["step"]
            and want["optimizer"]["count"] == got["optimizer"]["count"])
    fresh.close()
    phase(f"checkpoint round trip: {len(want['model'])} tensors, step "
          f"{got['step']}, equal={same}")
    if not same:
        raise AssertionError("restored weights differ from the trained")

    model = build_model(get_config(YOLO_MODEL).replace(dtype="float32"))
    batch = next(synthetic_batches(batch_size=2, image_size=416,
                                   num_classes=80, steps=1, seed=7))
    card = yolo_loss_components(model, batch, torch.device("cuda"))
    cpu = yolo_loss_components(model, batch, torch.device("cpu"))
    rel = max(((card[k] - cpu[k]).abs() / cpu[k].abs().clamp(min=1.0))
              .max().item() for k in cpu)
    phase(f"yolov3 card vs CPU plain path, f32, 2 images at 416 px: loss "
          f"components {', '.join(f'{k}={cpu[k].tolist()}' for k in cpu)}; "
          f"max relative difference {rel:.3g} (bound {YOLO_CPU_RTOL:g})")
    if not all(torch.isfinite(v).all() for v in cpu.values()) \
            or rel > YOLO_CPU_RTOL:
        raise AssertionError(f"card and CPU loss differ by {rel:g}")
    return {"launches": launches, "step_ms": step_ms, "config": cfg,
            "workdir": workdir}


def check_attention_grad(shape, dtype, gen) -> float:
    """q, k, v gradients of sum(out * w) through `flash_attention` (one
    launch; the backward is the naive VJP) against plain autograd through
    `naive_attention`, in the model's strided layout: the largest
    difference, within TOL."""
    q, k, v = (t.requires_grad_(True)
               for t in make_qkv(shape, dtype, gen, "strided"))
    w = torch.randn(shape, generator=gen).cuda()
    before = flash_attention.launches
    (flash_attention(q, k, v).float() * w).sum().backward()
    launched = flash_attention.launches - before
    plain = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    (naive_attention(*plain).float() * w).sum().backward()
    torch.cuda.synchronize()
    err = max((t.grad.float() - p.grad.float()).abs().max().item()
              for t, p in zip((q, k, v), plain))
    layout = all(t.grad.stride() == t.stride() for t in (q, k, v))
    line = (f"flash_attention gradients {str(dtype).split('.')[-1]} "
            f"{tuple(shape)} strided vs naive_attention autograd: "
            f"max_abs_err={err:.3g} (bound {TOL[dtype]:g}), launches="
            f"{launched}, input strides kept={layout}")
    phase(line)
    if launched != 1 or not err <= TOL[dtype] or not layout:
        raise AssertionError(line)
    return err


def same_tree(a, b) -> bool:
    """Equal nested dicts / lists of tensors and plain values."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def float64_copy(model):
    """A copy of `model` that computes in f64 (its weights, and every
    module's compute `dtype`; BatchNorm normalizes an f64 input in f64):
    the reference that f32 gradients are held against where they are
    ill-conditioned."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    return m


def train_step_state(cfg, model, batch, device,
                     dtype: torch.dtype = torch.float32,
                     make_step=None) -> dict:
    """One train step of `cfg` (its optimizer, label smoothing and aux
    weight; f32 compute, or f64 for a reference; augment off) through a
    copy of `model` on `device`, on this process's `batch`: its `loss` (of
    the global batch under a process group), `grads` as the step leaves
    them (clipped, where the optimizer clips; averaged over the ranks
    under a group) and the model's `state` after it. `make_step(dtype)`
    makes another family's step (classification's by default)."""
    m = (float64_copy(model) if dtype == torch.float64
         else copy.deepcopy(model)).to(device)
    state = TrainState(m, build_optimizer(m.parameters(), cfg.optimizer,
                                          cfg.schedule, 1, 1))
    step = (make_step(dtype) if make_step else make_classification_train_step(
        label_smoothing=cfg.label_smoothing, aux_weight=cfg.aux_loss_weight,
        compute_dtype=dtype))
    # a reference step takes its float inputs (images, boxes, keypoints)
    # in f64 too, so the targets it renders are f64
    metrics = step(state, *(torch.from_numpy(np.ascontiguousarray(
        a, np.float64 if dtype == torch.float64 and a.dtype.kind == "f"
        else None)).to(device) for a in batch))
    return {"loss": float(metrics["loss"]),
            "grads": {n: p.grad.cpu() for n, p in m.named_parameters()},
            "state": {k: v.cpu() for k, v in m.state_dict().items()}}


def train_step_grads(cfg, model, batch, device,
                     dtype: torch.dtype = torch.float32,
                     make_step=None) -> tuple:
    """(loss, gradients) of `train_step_state`."""
    out = train_step_state(cfg, model, batch, device, dtype, make_step)
    return out["loss"], out["grads"]


def vit_grad_rel(card: dict, cpu: dict) -> float:
    """Largest |card - cpu| over each tensor's largest |cpu| (the key
    biases, whose gradient is 0 up to rounding, over the model's largest)."""
    top = max(g.abs().max().item() for g in cpu.values())
    return max((card[n] - g).abs().max().item()
               / (top if n.endswith("attn.key.bias") else g.abs().max().item())
               for n, g in cpu.items())


def check_vit_training() -> dict:
    """Slice 5: vit_small training through the port's own entry point.
    The run dir stays until the script ends: phase 21 exports it."""
    cfg = get_config(MODEL)
    depth = cfg.model_kwargs["depth"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_vit_")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0     # counts of the main path only
    t0 = time.perf_counter()
    trainer, result = run_classification("ViT", [MODEL], [
        "-m", MODEL, "--synthetic", "--batch-size", str(VIT_BATCH),
        "--steps-per-epoch", str(VIT_STEPS), "--epochs", "1",
        "--device", "cuda", "--workdir", workdir])
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    ran = trainer.config
    if (ran.data.image_size, ran.data.num_classes, ran.batch_size,
            ran.label_smoothing, ran.optimizer.name,
            ran.schedule.name) != (224, 1000, VIT_BATCH, 0.1, "adam",
                                   "cosine"):
        raise AssertionError(f"vit_small ran as {ran}")
    steps = trainer.last_epoch_steps
    for i, s in enumerate(steps):
        phase(f"vit_small step {i + 1}: " + " ".join(
            f"{k}={v:.4f}" for k, v in s.items()))
    if len(steps) != VIT_STEPS or not all(
            np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"vit_small steps not all finite: {steps}")
    if result.get("count") != VIT_EVAL_BATCHES * VIT_BATCH or not all(
            np.isfinite(result.get(k, np.nan))
            for k in ("loss", "top1", "top5")):
        raise AssertionError(f"vit_small validation: {result}")
    dispatches = VIT_STEPS + VIT_EVAL_BATCHES
    phase(f"main path: {VIT_STEPS} train steps + {VIT_EVAL_BATCHES} "
          f"eval batches of {VIT_BATCH}, {launches} flash_attention "
          f"launches (depth {depth}); val loss={result['loss']:.4f} "
          f"top1={result['top1']:.4f}; run_classification {wall:.1f}s")
    if launches != depth * dispatches:
        raise AssertionError(f"flash_attention ran {launches} times for "
                             f"{dispatches} forward passes of depth "
                             f"{depth}")
    step_ms = statistics.median(s["step_ms"] for s in steps[1:])
    phase(f"vit_small train step (batch {VIT_BATCH}, 224 px, bf16): "
          f"step_ms={step_ms:.3f} (median after the first; first "
          f"{steps[0]['step_ms']:.3f}) images_per_sec="
          f"{VIT_BATCH / step_ms * 1e3:.2f} peak_memory_allocated="
          f"{peak / 2**30:.3f} GiB")

    fresh = Trainer(ran, device="cuda", workdir=workdir)
    fresh.init_state()
    if fresh.resume() != 1:
        raise AssertionError("the epoch-1 checkpoint did not restore")
    want, got = trainer.state.state_dict(), fresh.state.state_dict()
    equal = same_tree(want, got)
    fresh.close()
    phase(f"checkpoint round trip: {len(want['model'])} tensors and the "
          f"optimizer state (count {got['optimizer']['count']}), step "
          f"{got['step']}, equal={equal}")
    if not equal:
        raise AssertionError("the restored state differs from the "
                             "trained")

    model = build_model(cfg.replace(dtype="float32", model_kwargs={
        **cfg.model_kwargs, "dropout_rate": 0.0}))
    batch = next(iter(SyntheticClassification(2, 224, 3, 1000, 1, seed=7)))
    card_loss, card_grads = train_step_grads(cfg, model, batch,
                                             torch.device("cuda"))
    cpu_loss, cpu_grads = train_step_grads(cfg, model, batch,
                                           torch.device("cpu"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_rel = vit_grad_rel(card_grads, cpu_grads)
    phase(f"vit_small card vs CPU plain path, one f32 step on 2 images, "
          f"dropout 0: loss {card_loss:.6f} vs {cpu_loss:.6f} (relative "
          f"{loss_rel:.3g}); gradients, largest relative difference "
          f"{grad_rel:.3g} (bound {VIT_CPU_RTOL:g})")
    if not (np.isfinite(cpu_loss) and loss_rel <= VIT_CPU_RTOL
            and grad_rel <= VIT_CPU_RTOL):
        raise AssertionError(f"card and CPU differ: loss {loss_rel:g}, "
                             f"gradients {grad_rel:g}")
    return {"launches": launches, "step_ms": step_ms, "peak_bytes": peak,
            "workdir": workdir}


def check_lenet_training() -> dict:
    """Slice 6: lenet5 training through the port's own entry point, and
    its loss on the card against the CPU."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_lenet_")
    try:
        trainer, result = run_classification("LeNet", [LENET_MODEL], [
            "-m", LENET_MODEL, "--synthetic", "--steps-per-epoch",
            str(LENET_STEPS), "--epochs", "1", "--device", "cuda",
            "--workdir", workdir])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cfg = trainer.config
    steps = trainer.last_epoch_steps
    for i, s in enumerate(steps):
        phase(f"lenet5 step {i + 1}: " + " ".join(
            f"{k}={v:.4f}" for k, v in s.items()))
    if len(steps) != LENET_STEPS or not all(
            np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"lenet5 steps not all finite: {steps}")
    if result.get("count") != 2 * cfg.batch_size or not np.isfinite(
            result.get("loss", np.nan)):
        raise AssertionError(f"lenet5 validation: {result}")
    model = build_model(cfg)
    batch = next(iter(SyntheticClassification(
        cfg.batch_size, cfg.data.image_size, cfg.data.channels,
        cfg.data.num_classes, 1, seed=7)))
    card, _ = train_step_grads(cfg, model, batch, torch.device("cuda"))
    cpu, _ = train_step_grads(cfg, model, batch, torch.device("cpu"))
    rel = abs(card - cpu) / abs(cpu)
    phase(f"lenet5 (batch {cfg.batch_size}, 32 px, f32): val loss="
          f"{result['loss']:.4f}; card vs CPU loss of one step {card:.7f} vs "
          f"{cpu:.7f} (relative {rel:.3g}, bound {LENET_CPU_RTOL:g})")
    if not (np.isfinite(cpu) and rel <= LENET_CPU_RTOL):
        raise AssertionError(f"lenet5 card and CPU loss differ by {rel:g}")
    return {"steps": steps}


def grad_rel(card: dict, cpu: dict) -> tuple:
    """(largest |card - cpu| over the largest |cpu| of all tensors, the
    tensor where it is)."""
    top = max(g.abs().max().item() for g in cpu.values())
    err, name = max(((card[n] - g).abs().max().item(), n)
                    for n, g in cpu.items())
    return err / top, name


def check_augment(cfg, gen) -> float:
    """The train and eval device augments of `cfg` on the card against
    the CPU on the same uint8 images and the same draws, in f32."""
    size = cfg.data.image_size
    d = decode_image_size(size)
    images = torch.randint(0, 256, (16, d, d, 3), generator=gen,
                           dtype=torch.uint8)
    draws = daug.draw_train_params(16, d, d, size, gen)
    kw = dict(mean=cfg.data.mean, std=cfg.data.std,
              compute_dtype=torch.float32)
    err = 0.0
    for fn in (lambda x, dr: daug.apply_train_augment(x, dr, size, **kw),
               lambda x, dr: daug.make_eval_augment(size, **kw)(x)):
        card = fn(images.cuda(), draws.to("cuda")).cpu()
        cpu = fn(images, draws)
        if card.shape != (16, size, size, 3):
            raise AssertionError(f"augment gave {tuple(card.shape)}")
        err = max(err, (card - cpu).abs().max().item())
    phase(f"device augment (train and eval), card vs CPU on the same draws, "
          f"16 images {d} -> {size} px, f32: max_abs_err={err:.3g} (bound "
          f"{AUGMENT_TOL:g})")
    if not err <= AUGMENT_TOL:
        raise AssertionError(f"device augment differs by {err:g}")
    return err


def check_resnet_training(gen) -> dict:
    """Slice 6: resnet50_tpu training through the port's own entry point,
    with the prefetch thread, the device augment and EMA weights."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, result = run_classification("ResNet", [RESNET_MODEL], [
            "-m", RESNET_MODEL, "--synthetic", "--device-augment",
            "--batch-size", str(RESNET_BATCH), "--steps-per-epoch",
            str(RESNET_STEPS), "--epochs", "1", "--device", "cuda",
            "--workdir", workdir])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ran = trainer.config
        if (ran.data.image_size, ran.data.num_classes, ran.batch_size,
                ran.label_smoothing, ran.optimizer.name,
                ran.optimizer.no_decay_bn_bias, ran.ema_decay,
                ran.device_augment) != (224, 1000, RESNET_BATCH, 0.1,
                                        "momentum", True, 0.9999, True):
            raise AssertionError(f"resnet50_tpu ran as {ran}")
        steps = trainer.last_epoch_steps
        for i, s in enumerate(steps):
            phase(f"resnet50_tpu step {i + 1}: " + " ".join(
                f"{k}={v:.4f}" for k, v in s.items()))
        if len(steps) != RESNET_STEPS or not all(
                np.isfinite(v) for s in steps for v in s.values()):
            raise AssertionError(f"resnet50_tpu steps not all finite: "
                                 f"{steps}")
        if result.get("count") != RESNET_EVAL_BATCHES * RESNET_BATCH \
                or not all(np.isfinite(result.get(k, np.nan))
                           for k in ("loss", "top1", "top5")):
            raise AssertionError(f"resnet50_tpu validation: {result}")
        step_ms = statistics.median(s["step_ms"] for s in steps[1:])
        ledger = trainer.last_prefetch_ledger
        per_batch = ledger["bytes_staged_total"] / ledger[
            "batches_staged_total"]
        d = decode_image_size(ran.data.image_size)
        want_bytes = RESNET_BATCH * (d * d * 3 + 4)     # uint8 + int32 labels
        f32_bytes = RESNET_BATCH * ran.data.image_size ** 2 * 3 * 4
        phase(f"main path: {RESNET_STEPS} train steps + "
              f"{RESNET_EVAL_BATCHES} eval batches of {RESNET_BATCH}; val "
              f"loss={result['loss']:.4f} top1={result['top1']:.4f} (EMA "
              f"weights); run_classification {wall:.1f}s")
        phase(f"resnet50_tpu train loop (batch {RESNET_BATCH}, "
              f"{ran.data.image_size} px, bf16, device augment, EMA): step_ms={step_ms:.3f} (median "
              f"after the first; first {steps[0]['step_ms']:.3f}) "
              f"images_per_sec={RESNET_BATCH / step_ms * 1e3:.2f} "
              f"peak_memory_allocated={peak / 2**30:.3f} GiB")
        phase(f"prefetcher: {per_batch / 1e6:.1f} MB staged per batch "
              f"(uint8 at {d} px; f32 at {ran.data.image_size} px would be "
              f"{f32_bytes / 1e6:.1f} MB), last stage "
              f"{1e3 * ledger['last_stage_secs']:.3f} ms, "
              f"{ledger['bytes_per_sec'] / 1e9:.2f} GB/s, consumer waited "
              f"{ledger['wait_secs_total']:.3f} s (first "
              f"{ledger['first_wait_secs']:.3f} s), overlapped_fraction="
              f"{ledger['overlapped_fraction']:.3f}")
        if per_batch != want_bytes:
            raise AssertionError(f"staged {per_batch} bytes per batch, want "
                                 f"{want_bytes} (uint8 at {d} px)")

        fresh = Trainer(ran, device="cuda", workdir=workdir)
        fresh.init_state()
        if fresh.resume() != 1:
            raise AssertionError("the epoch-1 checkpoint did not restore")
        want, got = trainer.state.state_dict(), fresh.state.state_dict()
        equal = same_tree(want, got) and got["ema"] is not None
        fresh.close()
        phase(f"checkpoint round trip: {len(want['model'])} tensors "
              f"(parameters and BatchNorm statistics), the momentum "
              f"(count {got['optimizer']['count']}) and {len(got['ema'])} "
              f"EMA tensors, step {got['step']}, equal={equal}")
        if not equal:
            raise AssertionError("the restored state differs from the "
                                 "trained")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    cfg = get_config(RESNET_MODEL)
    model = build_model(cfg.replace(dtype="float32"))
    batch = next(iter(SyntheticClassification(2, 224, 3, 1000, 1, seed=7)))
    card_loss, card_grads = train_step_grads(cfg, model, batch,
                                             torch.device("cuda"))
    cpu_loss, cpu_grads = train_step_grads(cfg, model, batch,
                                           torch.device("cpu"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    rel, worst = grad_rel(card_grads, cpu_grads)
    phase(f"resnet50 card vs CPU plain path, one f32 step on 2 images: loss "
          f"{card_loss:.6f} vs {cpu_loss:.6f} (relative {loss_rel:.3g}, "
          f"bound {RESNET_CPU_RTOL:g}); gradients, largest difference "
          f"{rel:.3g} of the largest gradient (in {worst}; bound "
          f"{RESNET_GRAD_RTOL:g})")
    if not (np.isfinite(cpu_loss) and loss_rel <= RESNET_CPU_RTOL
            and rel <= RESNET_GRAD_RTOL):
        raise AssertionError(f"card and CPU differ: loss {loss_rel:g}, "
                             f"gradients {rel:g}")
    augment_err = check_augment(cfg, gen)
    return {"step_ms": step_ms, "peak_bytes": peak, "ledger": ledger,
            "augment_err": augment_err}


def no_dropout(model):
    """`model` with every dropout rate 0: the card's masks and the CPU's
    come from different generators."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def check_step_against_f64(cfg, model, batch, name: str, what: str,
                           make_step=None, cpu_f32: bool = True,
                           ref: tuple = None) -> dict:
    """One train step of `cfg` (the family's `make_step`, classification's
    by default) on `batch` through `model` on the card in f64 and in f32,
    each against the same step in f64 on the CPU (and, with `cpu_f32`,
    the CPU's own f32 step beside them, printed, not bounded); fails past
    the ZOO_* bounds. `ref`, the CPU's f64 (loss, gradients) where the
    caller computed them already."""
    cpu, card = torch.device("cpu"), torch.device("cuda")
    ref_loss, ref = ref or train_step_grads(cfg, model, batch, cpu,
                                            torch.float64, make_step)
    loss64, grads64 = train_step_grads(cfg, model, batch, card,
                                       torch.float64, make_step)
    loss32, grads32 = train_step_grads(cfg, model, batch, card,
                                       make_step=make_step)
    rec = {"f64_loss": abs(loss64 - ref_loss) / abs(ref_loss),
           "f64_grad": grad_rel(grads64, ref)[0],
           "f32_loss": abs(loss32 - ref_loss) / abs(ref_loss),
           "cpu_f32_loss": float("nan"), "cpu_f32_grad": float("nan")}
    if cpu_f32:
        cpu_loss32, cpu_grads32 = train_step_grads(cfg, model, batch, cpu,
                                                   make_step=make_step)
        rec["cpu_f32_loss"] = abs(cpu_loss32 - ref_loss) / abs(ref_loss)
        rec["cpu_f32_grad"] = grad_rel(cpu_grads32, ref)[0]
    rec["f32_grad"], worst = grad_rel(grads32, ref)
    phase(f"{name} one train step on {what}, dropout off, against the same "
          f"step in f64 on the CPU (loss {ref_loss:.6f}); errors of the "
          f"loss (relative) and of the gradients (over the largest): card "
          f"f64 {rec['f64_loss']:.3g} / {rec['f64_grad']:.3g} (bounds "
          f"{ZOO_F64_LOSS_RTOL:g} / {ZOO_F64_GRAD_RTOL:g}); card f32 "
          f"{rec['f32_loss']:.3g} / {rec['f32_grad']:.3g} in {worst} "
          f"(bounds {ZOO_LOSS_RTOL:g} / {ZOO_GRAD_RTOL:g}); CPU f32 "
          f"{rec['cpu_f32_loss']:.3g} / {rec['cpu_f32_grad']:.3g}")
    if not (np.isfinite(ref_loss)
            and rec["f64_loss"] <= ZOO_F64_LOSS_RTOL
            and rec["f64_grad"] <= ZOO_F64_GRAD_RTOL
            and rec["f32_loss"] <= ZOO_LOSS_RTOL
            and rec["f32_grad"] <= ZOO_GRAD_RTOL):
        raise AssertionError(f"{name}: the card's step is off the CPU's f64 "
                             f"one: {rec}")
    return rec


def check_zoo_training() -> dict:
    """Slice 7: each zoo config trained through its family's entry point
    at full width and its own resolution; for the BASELINE pair, one f32
    step on the card against the CPU."""
    out = {}
    for name, (family, count) in ZOO.items():
        workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer, result = run_classification(family, ZOO_MODELS[family], [
                "-m", name, "--synthetic", "--batch-size", str(ZOO_BATCH),
                "--eval-batch-size", str(ZOO_EVAL_BATCH), "--steps-per-epoch",
                str(ZOO_STEPS), "--epochs", "1", "--device", "cuda",
                "--workdir", workdir])
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        peak = torch.cuda.max_memory_allocated()
        ran = trainer.config
        size = get_config(name).data.image_size
        params = sum(p.numel() for p in trainer.state.model.parameters())
        steps = trainer.last_epoch_steps
        losses = [s["loss"] for s in steps]
        step_ms = steps[-1]["step_ms"]
        phase(f"{name} ({family}, {size} px, batch {ZOO_BATCH}, "
              f"{ran.optimizer.name}, bf16): params={params:,} losses="
              f"{[round(v, 4) for v in losses]} val loss="
              f"{result.get('loss', float('nan')):.4f} step_ms={step_ms:.3f} "
              f"(step 2; step 1 {steps[0]['step_ms']:.3f}) images_per_sec="
              f"{ZOO_BATCH / step_ms * 1e3:.2f} peak_memory_allocated="
              f"{peak / 2**30:.3f} GiB; run_classification {wall:.1f}s")
        if (ran.data.image_size, ran.data.num_classes, ran.batch_size) != (
                size, 1000, ZOO_BATCH):
            raise AssertionError(f"{name} ran at {ran.data}")
        if params != count:
            raise AssertionError(f"{name} has {params:,} parameters, the "
                                 f"JAX model {count:,}")
        if len(steps) != ZOO_STEPS or not all(
                np.isfinite(v) for s in steps for v in s.values()):
            raise AssertionError(f"{name} steps not all finite: {steps}")
        if result.get("count") != 2 * ZOO_EVAL_BATCH or not all(
                np.isfinite(result.get(k, np.nan))
                for k in ("loss", "top1", "top5")):
            raise AssertionError(f"{name} validation: {result}")
        out[name] = {"step_ms": step_ms, "peak_bytes": peak,
                     "params": params, "losses": losses}

    for name in ZOO_SERVED:
        cfg = get_config(name)
        size = cfg.data.image_size
        model = no_dropout(build_model(cfg.replace(dtype="float32")))
        batch = next(iter(SyntheticClassification(2, size, 3, 1000, 1,
                                                  seed=7)))
        out[name].update(check_step_against_f64(
            cfg, model, batch, name, f"2 images at {size} px"))
    return out


def check_zoo_serving() -> dict:
    """Slice 7: the BASELINE pair served by the engine on the card."""
    out = {}
    rs = np.random.RandomState(3)
    for name in ZOO_SERVED:
        engine = PredictEngine.from_config(name, device="cuda",
                                           buckets=BUCKETS, verbose=False)
        engine.warmup()
        engine.dispatches = 0
        err = 0.0
        for n in (1, 3, 8, 20, 32):
            x = rs.randn(n, *engine.example_shape).astype(np.float32)
            got, ref = engine.predict(x), engine.reference(x)
            if got.shape != (n, 1000) or not np.isfinite(got).all():
                raise AssertionError(f"{name} answered {got.shape}")
            err = max(err, float(np.abs(got - ref).max()
                                 / max(np.abs(ref).max(), 1e-30)))
        cpu = PredictEngine.from_config(name, device="cpu", buckets=(2,),
                                        verbose=False)
        x = rs.randn(2, *engine.example_shape).astype(np.float32)
        want = cpu.reference(x)
        cpu_err = float(np.abs(engine.reference(x) - want).max()
                        / max(np.abs(want).max(), 1e-30))
        phase(f"{name} served at buckets {engine.buckets}: "
              f"{engine.dispatches} dispatches; answers vs "
              f"engine.reference(), relative to the largest logit: "
              f"{err:.3g} (bound {SERVE_TOL:g}); card vs CPU engine on the "
              f"same seeded weights, 2 images: {cpu_err:.3g} (logit scale "
              f"{np.abs(want).max():.3g}; bound {CPU_RTOL:g})")
        if not err <= SERVE_TOL or not np.isfinite(want).all() \
                or not cpu_err <= CPU_RTOL:
            raise AssertionError(f"{name} served answers differ: {err:g}, "
                                 f"card vs CPU {cpu_err:g}")
        batch_ms = {b: engine.measure_batch_ms(b, 20) for b in engine.buckets}
        phase(f"{name} measure_batch_ms (host input to host output): "
              + " ".join(f"bucket {b}: {ms:.3f}" for b, ms in
                         batch_ms.items()))
        prof = profile_dispatches(engine, BUCKETS[-1], need="gemm")
        fam = prof["family_ms"]
        phase(f"{name} profile, bucket {BUCKETS[-1]}, device ms per "
              f"dispatch: " + " ".join(f"{k}={v:.4f}" for k, v in fam.items())
              + f"; busy {prof['busy_ms']:.4f} of wall {prof['wall_ms']:.4f} "
              f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy)")
        for kname, ms in prof["top"][:4]:
            phase(f"{name} profile top kernel: {ms:.4f} ms/dispatch {kname}")
        out[name] = {"served_err": err, "cpu_err": cpu_err,
                     "batch_ms": batch_ms, "profile": prof}
    return out


GEMM_KEYS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def profile_dispatches(engine, bucket: int, warmup: int = 3,
                       iters: int = 5, need: str = "flash_attention"
                       ) -> dict:
    """Device ms per dispatch of `bucket` by kernel family, from
    `torch.profiler` over `iters` `engine.predict` calls after `warmup`
    ones, beside the wall ms per dispatch (host clock, synchronized).
    Fails unless the family `need` has device time (`gemm` holds cuDNN's
    convolutions too)."""
    x = np.random.RandomState(2).randn(
        bucket, *engine.example_shape).astype(np.float32)
    for _ in range(warmup):
        engine.predict(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.predict(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    fam = {"flash_attention": 0.0, "gemm": 0.0, "copy": 0.0, "rest": 0.0}
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / iters
        low = e.name.lower()
        key = ("flash_attention" if "flash_attention" in low
               else "gemm" if any(g in low for g in GEMM_KEYS)
               else "copy" if "memcpy" in low or "memset" in low
               else "rest")
        fam[key] += ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(fam.values())
    if busy <= 0 or fam[need] <= 0:
        raise AssertionError(f"the profile holds no device time for "
                             f"{need}: {fam}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "busy_ms": busy, "family_ms": fam,
            "top": [(name[:90], ms) for name, ms in top]}


def post(url: str, x: np.ndarray) -> np.ndarray:
    req = urllib.request.Request(
        url, data=json.dumps({"instances": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.loads(resp.read())["predictions"], np.float32)


# -- phase 11: data parallelism over torch.distributed -----------------------

# phase 11a: the normal entry points under a torchrun launch of one process
# (NCCL), at phases 5 and 8's batch, steps and cuts
# phase 11a: 2 steps each (phases 5 and 8 take 3): the one-process step
# times compare with the median after the first
DDP_YOLO_STEPS, DDP_RESNET_STEPS = 2, 2
DDP_YOLO_ARGS = ["-m", YOLO_MODEL, "--synthetic", "--image-size", "416",
                 "--batch-size", str(YOLO_BATCH), "--steps-per-epoch",
                 str(DDP_YOLO_STEPS), "--epochs", "1", "--device", "cuda"]
DDP_RESNET_ARGS = ["-m", RESNET_MODEL, "--synthetic", "--device-augment",
                   "--batch-size", str(RESNET_BATCH), "--steps-per-epoch",
                   str(DDP_RESNET_STEPS), "--epochs", "1", "--device",
                   "cuda"]
# phase 11b: two ranks on the one card over gloo (NCCL refuses two ranks on
# one GPU), each launched as the only process of its host, so each drives
# card 0; global batches, each rank taking half
DDP_RANKS = 2
DDP2_YOLO_BATCH, DDP2_YOLO_STEPS = 16, 2
DDP2_RESNET_BATCH, DDP2_RESNET_STEPS = 64, 2
DDP2_YOLO_ARGS = ["-m", YOLO_MODEL, "--synthetic", "--image-size", "416",
                  "--batch-size", str(DDP2_YOLO_BATCH), "--steps-per-epoch",
                  str(DDP2_YOLO_STEPS), "--epochs", "1", "--device", "cuda"]
DDP2_RESNET_ARGS = ["-m", RESNET_MODEL, "--synthetic", "--device-augment",
                    "--batch-size", str(DDP2_RESNET_BATCH),
                    "--steps-per-epoch", str(DDP2_RESNET_STEPS), "--epochs",
                    "1", "--device", "cuda"]
# one f64 resnet50_tpu step (augment and dropout off) at global batch 4, 2
# rows a rank, against the one-process f64 step on the same 4 images on
# the card. Both compute one function: the two-rank step differs in the
# order of sums only (the global BatchNorm statistics from all-reduced
# per-rank sums, the gradients averaged over the ranks). Bounds: the
# loss relative; the gradients over the model's largest gradient (PR 7's
# f64 card-vs-CPU bound); the updated weights over the step's largest
# update; the BatchNorm running statistics over their largest value
DDP_F64_BATCH = 4
DDP_F64_LOSS_RTOL = 1e-12
DDP_F64_GRAD_RTOL = 1e-9
DDP_F64_WEIGHT_RTOL = 1e-9
DDP_F64_STAT_RTOL = 1e-12
DDP_WORKER_TIMEOUT = 420


def family_main(family: str, argv: list):
    """The family entry point `<family>/torch/train.py` as its `__main__`
    runs it, with `argv`: returns the (closed) trainer and fit's result."""
    import importlib.util
    path = f"{family}/torch/train.py"
    spec = importlib.util.spec_from_file_location(f"{family}_torch_train",
                                                  path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    run = {"YOLO": run_detection, "ObjectsAsPoints": run_centernet,
           "Hourglass": run_pose, "UNet": run_segmentation}.get(
        family, run_classification)
    return run(family, script.MODELS, argv)


def f64_step_errors(one: dict, ranks: list, before: dict) -> dict:
    """The largest errors of the ranks' steps against the one-process
    step `one` (each from `train_step_state`): loss relative, gradients
    over the largest gradient, updated weights over the largest update from
    `before` (the weights before the step), BatchNorm running statistics
    over their largest value (0 without BatchNorm); `counters` is whether
    every rank counted the same BatchNorm updates."""
    top_grad = max(g.abs().max().item() for g in one["grads"].values())
    params = one["grads"].keys()
    top_update = max((one["state"][n] - before[n].double()).abs().max()
                     .item() for n in params)
    stats = [k for k, v in one["state"].items()
             if k not in params and v.is_floating_point()]
    top_stat = max((one["state"][k].abs().max().item() for k in stats),
                   default=1.0)
    err = {"loss": 0.0, "grad": 0.0, "weight": 0.0, "stat": 0.0,
           "counters": True}
    for r in ranks:
        err["loss"] = max(err["loss"], abs(r["loss"] - one["loss"])
                          / abs(one["loss"]))
        err["grad"] = max(err["grad"], max(
            (r["grads"][n] - g).abs().max().item()
            for n, g in one["grads"].items()) / top_grad)
        err["weight"] = max(err["weight"], max(
            (r["state"][n] - one["state"][n]).abs().max().item()
            for n in params) / top_update)
        err["stat"] = max(err["stat"], max(
            ((r["state"][k] - one["state"][k]).abs().max().item()
             for k in stats), default=0.0) / top_stat)
        err["counters"] &= all(
            torch.equal(r["state"][k], v) for k, v in one["state"].items()
            if not v.is_floating_point())
    return err


def check_f64_step_errors(err: dict) -> None:
    if not (err["loss"] <= DDP_F64_LOSS_RTOL
            and err["grad"] <= DDP_F64_GRAD_RTOL
            and err["weight"] <= DDP_F64_WEIGHT_RTOL
            and err["stat"] <= DDP_F64_STAT_RTOL and err["counters"]):
        raise AssertionError(f"the two-rank f64 step is off the one-process "
                             f"step: {err}")


def ddp_worker(spec_path: str) -> int:
    """One rank of phase 11 (`chip_smoke.py --ddp-worker spec.json`): bring
    the process group up from the launcher's environment, call each
    family entry point with its argv, then (if asked) the f64 step on this
    rank's rows; write what it saw to `<out>/rank<r>.json` (and `.pt`)."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    mesh.maybe_init_distributed(spec["backend"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = mesh.rank()
    out = {"rank": rank, "world": mesh.world_size(),
           "backend": torch.distributed.get_backend(),
           "device": str(resolve_device("cuda")),
           "device_count": torch.cuda.device_count(), "runs": []}
    for family, argv in spec["runs"]:
        torch.cuda.reset_peak_memory_stats()
        best_iou.launches = flash_attention.launches = 0
        t0 = time.perf_counter()
        trainer, result = family_main(family, argv)
        wall = time.perf_counter() - t0
        out["runs"].append({
            "family": family, "argv": argv, "wall_s": wall,
            "steps": trainer.last_epoch_steps, "result": result,
            "best_iou_launches": best_iou.launches,
            "flash_attention_launches": flash_attention.launches,
            "batch_per_rank": trainer.config.batch_size // mesh.world_size(),
            "peak_bytes": torch.cuda.max_memory_allocated()})
    if spec.get("f64"):
        cfg = get_config(RESNET_MODEL)
        model = build_model(cfg.replace(dtype="float32"))
        batch = next(iter(SyntheticClassification(
            DDP_F64_BATCH, cfg.data.image_size, 3, 1000, 1, seed=7)))
        rows = [mesh.shard_rows(a, rank, mesh.world_size()) for a in batch]
        torch.save(train_step_state(cfg, model, rows, resolve_device("cuda"),
                                    torch.float64),
                   f"{spec['out']}/rank{rank}.pt")
    with open(f"{spec['out']}/rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    mesh.destroy()
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(commands: list, envs: list, logs: list,
                timeout: float = DDP_WORKER_TIMEOUT) -> None:
    """Start every command at once (each with its environment, its output
    to its log) and wait for all; fails, with each failing log's tail,
    if any exits non-zero or outlives `timeout` (then all are killed)."""
    wait_workers(start_workers(commands, envs, logs), logs, timeout)


def start_workers(commands: list, envs: list, logs: list) -> list:
    """Start every command at once, each with its environment and its
    output to its log; a script that ends first kills them."""
    procs = []
    for cmd, env, log in zip(commands, envs, logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(cmd, env=env, stdout=fh,
                                          stderr=subprocess.STDOUT))
        atexit.register(p21_stop, procs[-1])
    return procs


def wait_workers(procs: list, logs: list,
                 timeout: float = DDP_WORKER_TIMEOUT) -> None:
    """Wait for every worker of `start_workers`; fails, with each failing
    log's tail, if any exits non-zero or outlives `timeout` (then all are
    killed)."""
    deadline = time.monotonic() + timeout
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes is None or any(codes):
        tails = []
        for log in logs:
            with open(log) as fh:
                tails.append(f"--- {log}:\n" + fh.read()[-3000:])
        raise AssertionError(f"a worker failed (exit codes {codes}):\n"
                             + "\n".join(tails))


def ddp_phase(tag: str, spec: dict, commands: list, envs: list) -> list:
    """Run one phase's workers on `spec`; the ranks' records, by rank."""
    return wait_ddp_phase(tag, start_ddp_phase(spec, commands, envs))


def start_ddp_phase(spec: dict, commands: list, envs: list) -> dict:
    """Write `spec` and start one worker a command on it (`--ddp-worker`),
    left running; `wait_ddp_phase` collects them."""
    spec_path = f"{spec['out']}/spec.json"
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    logs = [f"{spec['out']}/worker{i}.log" for i in range(len(commands))]
    procs = start_workers([c + ["--ddp-worker", spec_path]
                           for c in commands], envs, logs)
    return {"spec": spec, "procs": procs, "logs": logs,
            "t0": time.perf_counter()}


def wait_ddp_phase(tag: str, run: dict) -> list:
    """The ranks' records of a `start_ddp_phase` run, once its workers
    end (the timeout counted from their start)."""
    t0 = time.perf_counter()
    wait_workers(run["procs"], run["logs"], max(
        1.0, DDP_WORKER_TIMEOUT - (t0 - run["t0"])))
    phase(f"{tag}: workers done {time.perf_counter() - run['t0']:.1f}s "
          f"after their start (waited {time.perf_counter() - t0:.1f}s "
          f"here)")
    return ddp_ranks(run["spec"], len(run["procs"]))


def ddp_ranks(spec: dict, n: int) -> list:
    """The records the `n` ranks of `spec` wrote, by rank."""
    ranks = []
    for r in range(n):
        with open(f"{spec['out']}/rank{r}.json") as fh:
            ranks.append(json.load(fh))
    return ranks


def check_ddp_run(tag: str, rec: dict, rank: dict, n_steps: int,
                  eval_batches: int, global_batch: int) -> float:
    """One entry-point run of a rank: finite losses, the validation over
    the global batches, K2 on YOLO's path. Returns its `step_ms`."""
    steps, result = rec["steps"], rec["result"]
    name = rec["argv"][1]
    step_ms = statistics.median(s["step_ms"] for s in steps[1:])
    losses = [round(s["loss"], 4) for s in steps]
    phase(f"{tag} rank {rank['rank']}/{rank['world']} ({rank['backend']}, "
          f"{rank['device']}): {name} batch {global_batch} "
          f"({rec['batch_per_rank']} a rank) losses={losses} val="
          + " ".join(f"{k}={v:.4f}" for k, v in result.items()
                     if isinstance(v, float))
          + f" step_ms={step_ms:.3f} (median after the first; first "
          f"{steps[0]['step_ms']:.3f}) best_iou launches="
          f"{rec['best_iou_launches']} peak_memory_allocated="
          f"{rec['peak_bytes'] / 2**30:.3f} GiB; entry point "
          f"{rec['wall_s']:.1f}s")
    if len(steps) != n_steps or not all(
            np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"{tag} {name}: steps not all finite: {steps}")
    if not np.isfinite(result.get("loss", np.nan)):
        raise AssertionError(f"{tag} {name}: validation {result}")
    if name == YOLO_MODEL:
        if result.get("count") != eval_batches \
                or rec["best_iou_launches"] < n_steps + eval_batches:
            raise AssertionError(
                f"{tag} {name}: best_iou ran {rec['best_iou_launches']} "
                f"times for {n_steps} steps and {eval_batches} eval batches "
                f"(validation {result})")
    elif result.get("count") != eval_batches * global_batch:
        raise AssertionError(f"{tag} {name}: validation {result}")
    return step_ms


def ddp_plans(root: str, port: int) -> dict:
    """What phase 11 launches, by sub-phase: the spec each worker reads,
    the command of each rank (without the worker's own arguments) and its
    environment (None: this process's). 11a is one process under
    torchrun; 11b two ranks as two one-process hosts (RANK, WORLD_SIZE,
    LOCAL_RANK 0) meeting at 127.0.0.1:`port`, both on card 0."""
    here = os.path.abspath(__file__)
    two = f"{root}/two"
    return {
        "11a": ({"out": root, "backend": "nccl", "runs": [
                    ["YOLO", DDP_YOLO_ARGS + ["--workdir", f"{root}/yolo"]],
                    ["ResNet", DDP_RESNET_ARGS + ["--workdir",
                                                  f"{root}/resnet"]]]},
                [[sys.executable, "-m", "torch.distributed.run",
                  "--standalone", "--nproc_per_node=1", here]], [None]),
        "11b": ({"out": two, "backend": "gloo", "f64": True, "runs": [
                    ["YOLO", DDP2_YOLO_ARGS + ["--workdir", f"{two}/yolo"]],
                    ["ResNet", DDP2_RESNET_ARGS + ["--workdir",
                                                   f"{two}/resnet"]]]},
                [[sys.executable, here]] * DDP_RANKS,
                [dict(os.environ, RANK=str(r), WORLD_SIZE=str(DDP_RANKS),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                 for r in range(DDP_RANKS)])}


def check_data_parallel(smi: str, yolo: dict, resnet: dict) -> dict:
    """Phase 11a: the yolov3 and resnet50_tpu entry points under a
    torchrun launch of one process (NCCL), beside phases 5 and 8. Then
    11b's two ranks are started, to train beside phases 12-13 (whose own
    workers share the card too) until `collect_data_parallel`."""
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    plans = ddp_plans(root, free_port())
    (rank,) = ddp_phase("phase 11a", *plans["11a"])
    phase(f"phase 11a: world={rank['world']} backend={rank['backend']} "
          f"device_count={rank['device_count']} card: {smi}")
    ms = [check_ddp_run("phase 11a", rec, rank, n, eval_batches, batch)
          for rec, n, eval_batches, batch in zip(
              rank["runs"], (DDP_YOLO_STEPS, DDP_RESNET_STEPS),
              (YOLO_EVAL_BATCHES, RESNET_EVAL_BATCHES),
              (YOLO_BATCH, RESNET_BATCH))]
    phase(f"phase 11a: step_ms under DDP at world 1 ({rank['backend']}) "
          f"against the one-process step of phases 5 and 8 in this "
          f"run: yolov3 "
          f"{ms[0]:.3f} vs {yolo['step_ms']:.3f} "
          f"({ms[0] / yolo['step_ms']:.3f}x), resnet50_tpu {ms[1]:.3f} "
          f"vs {resnet['step_ms']:.3f} ({ms[1] / resnet['step_ms']:.3f}x)")
    out["11a"] = {"world": rank["world"], "backend": rank["backend"],
                  "yolo_step_ms": ms[0], "resnet_step_ms": ms[1],
                  "yolo_launches": rank["runs"][0]["best_iou_launches"],
                  "one_process_step_ms": [yolo["step_ms"],
                                          resnet["step_ms"]]}
    os.makedirs(plans["11b"][0]["out"])
    out["11b_run"] = start_ddp_phase(*plans["11b"])
    BESIDE.add("11b's 2 training ranks")
    out["root"] = root
    return out


def collect_data_parallel(ddp: dict, smi: str) -> dict:
    """Phase 11b, collected: two ranks on the one card over gloo, yolov3
    (K2 on every rank), resnet50_tpu with the device augment and EMA, a
    checkpoint from rank 0, and the f64 step against the one-process
    step. Their step_ms is not a scaling number (both ranks on one card,
    beside phases 12-13)."""
    root2 = ddp["11b_run"]["spec"]["out"]
    try:
        ranks = wait_ddp_phase("phase 11b", ddp.pop("11b_run"))
        phase(f"phase 11b: world={ranks[0]['world']} backend="
              f"{ranks[0]['backend']} device_count="
              f"{ranks[0]['device_count']} (both ranks on "
              f"{ranks[0]['device']} beside phases 12-13: not a scaling "
              f"number) card: {smi}")
        launches, ms2 = [], []
        for rank in ranks:
            ms2.append([check_ddp_run("phase 11b", rec, rank, n, 2, batch)
                        for rec, n, batch in zip(
                            rank["runs"],
                            (DDP2_YOLO_STEPS, DDP2_RESNET_STEPS),
                            (DDP2_YOLO_BATCH, DDP2_RESNET_BATCH))])
            launches.append(rank["runs"][0]["best_iou_launches"])
        for name in ("yolo", "resnet"):
            if not os.path.exists(f"{root2}/{name}/ckpt/1/"
                                  f"{integrity.MANIFEST_NAME}"):
                raise AssertionError(f"phase 11b: {name} saved no checkpoint")

        cfg = get_config(RESNET_MODEL)
        model = build_model(cfg.replace(dtype="float32"))
        batch = next(iter(SyntheticClassification(
            DDP_F64_BATCH, cfg.data.image_size, 3, 1000, 1, seed=7)))
        one = train_step_state(cfg, model, batch, resolve_device("cuda"),
                               torch.float64)
        two = [torch.load(f"{root2}/rank{r}.pt", weights_only=True)
               for r in range(DDP_RANKS)]
        before = {n: p.detach() for n, p in model.named_parameters()}
        err = f64_step_errors(one, two, before)
        phase(f"phase 11b: {RESNET_MODEL} one f64 step at global batch "
              f"{DDP_F64_BATCH} ({DDP_F64_BATCH // DDP_RANKS} a rank, "
              f"{cfg.data.image_size} "
              f"px, augment off) against the one-process step on the same "
              f"images on the card (loss {one['loss']:.9f}): loss "
              f"{err['loss']:.3g} relative (bound {DDP_F64_LOSS_RTOL:g}), "
              f"gradients {err['grad']:.3g} of the largest (bound "
              f"{DDP_F64_GRAD_RTOL:g}), weights {err['weight']:.3g} of the "
              f"largest update (bound {DDP_F64_WEIGHT_RTOL:g}), BatchNorm "
              f"statistics {err['stat']:.3g} of the largest (bound "
              f"{DDP_F64_STAT_RTOL:g}), counters equal={err['counters']}")
        check_f64_step_errors(err)
        ddp["11b"] = {"world": ranks[0]["world"],
                      "backend": ranks[0]["backend"],
                      "yolo_launches": launches, "step_ms": ms2,
                      "f64": err}
    finally:
        BESIDE.clear()
        shutil.rmtree(ddp.pop("root"), ignore_errors=True)
    return ddp


# -- phase 12: yolov3 inference ----------------------------------------------

PREDICT_IOU, PREDICT_SCORE = 0.5, 0.05     # evaluate_map's NMS thresholds
PREDICT_WARMUP, PREDICT_ITERS = 3, 5
# card vs CPU on the same (phase 5) weights, f32, 2 images at 416 px: the
# candidates before NMS within DETECT_CPU_RTOL of each tensor's largest
# value (75 conv layers whose sums run in other orders, phase 5's bound on
# the loss), then the card's top DETECT_TOP picks of each image matched
# greedily (same class, nearest box) among the CPU's picks on its own
# candidates, scores and boxes within the same bound
DETECT_CPU_RTOL = 1e-3
DETECT_TOP = 10
DETECT_SCENES = 2
# served yolov3 answers against engine.reference() (a padded bucket against
# the exact batch, both bf16 on the card), and the card against an engine
# on the CPU (bf16 against bf16), each leaf relative to its largest value:
# SERVE_TOL's bf16 roundings of activations in differently ordered sums,
# compounded over 75 conv layers rather than ViT's 8 blocks, and the box
# decode's exp() turns a rounding of tw into a relative error of w
# (measured 0.052 and 0.034 on the H100)
DETECT_SERVE_TOL = 1e-1
SERVE_BUCKETS = (1, 8)
EVALUATE_TIMEOUT = 300


def event_ms(fn, warmup: int = PREDICT_WARMUP, iters: int = PREDICT_ITERS):
    """(median ms of `iters` calls of `fn`, each between CUDA events after
    `warmup` calls, the last call's result)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def device_profile(fn, attempts: int = 3) -> tuple:
    """(device kernels one call of `fn` launches, copies and memsets
    apart; their summed device ms) from `torch.profiler`, after one
    unprofiled call. A profile that comes back with no device activity
    at all is taken again, up to `attempts` times: on the H100 one such
    empty capture of CenterNet's decode came between full ones of the
    same call, whose kernels ran. A capture that needed more than one
    attempt says so on a phase line of its own."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower()]
        if kernels:
            if attempt > 1:
                phase(f"device_profile: capture {attempt} of {attempts} "
                      f"held device kernels, the {attempt - 1} before it "
                      f"none")
            return (len(kernels),
                    sum(e.time_range.elapsed_us() for e in kernels) / 1e3)
    raise AssertionError(f"the profile holds no device kernel in "
                         f"{attempts} captures")


def conv_gflop(model, forward) -> float:
    """GFLOP (2 per multiply-add) of the convs of `model` in one call of
    `forward()`, from their shapes: each output element of a conv costs
    in/groups * kh * kw multiply-adds, each input element of a transposed
    conv out * kh * kw (the zeros of its dilated input cost nothing)."""
    total = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, ConvTranspose):
            total[0] += 2 * inputs[0].numel() * mod.weight[:, 0].numel()
        else:
            total[0] += 2 * out.numel() * mod.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, ConvTranspose))]
    try:
        with torch.inference_mode():
            forward()
    finally:
        for h in handles:
            h.remove()
    return total[0] / 1e9


def leaf_rel_err(got, want) -> float:
    """The worst of `leaf_rel_errs`."""
    return max(leaf_rel_errs(got, want))


def leaf_rel_errs(got, want) -> list:
    """Largest |got - want| of each leaf over that leaf's largest |want|
    (at least 1), leaf by leaf: `want` a tree (tuples) of arrays, `got`
    the same tree, or its nested lists as JSON carries it."""
    errs = []
    for g, w in _leaf_pairs(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        if g.shape != w.shape:
            raise AssertionError(f"leaf shapes differ: {g.shape} vs "
                                 f"{w.shape}")
        errs.append(float(np.abs(g - w).max())
                    / max(1.0, float(np.abs(w).max())))
    return errs


def _leaf_pairs(got, want):
    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"keys {list(got)}, want {list(want)}")
        for k in want:
            yield from _leaf_pairs(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError(f"{len(got)} outputs, want {len(want)}")
        for g, w in zip(got, want):
            yield from _leaf_pairs(g, w)
    else:
        yield got, want


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def match_picks(got, want, k: int, tol: float) -> int:
    """Greedy match of the top-k picks of each image of NMS output `got`
    among the picks of `want` ((boxes, scores, class_probs, counts), CPU
    tensors or arrays): the same class, the nearest box, score and box
    within `tol`. Returns the matched count; fails on a pick without a
    match."""
    boxes, scores, probs, counts = (np.asarray(t) for t in got)
    w_boxes, w_scores, w_probs, w_counts = (np.asarray(t) for t in want)
    matched = 0
    for i in range(len(counts)):
        pool = list(range(int(w_counts[i])))
        for d in range(min(k, int(counts[i]))):
            cls = int(np.argmax(probs[i, d]))
            best = min(pool, key=lambda w: (
                int(np.argmax(w_probs[i, w])) != cls,
                float(np.abs(boxes[i, d] - w_boxes[i, w]).max())),
                default=None)
            if best is None or int(np.argmax(w_probs[i, best])) != cls \
                    or abs(float(scores[i, d] - w_scores[i, best])) > tol \
                    or float(np.abs(boxes[i, d] - w_boxes[i, best])
                             .max()) > tol:
                raise AssertionError(f"image {i} pick {d} (class {cls}, "
                                     f"score {float(scores[i, d]):.6f}) has "
                                     f"no match within {tol:g}")
            pool.remove(best)
            matched += 1
    return matched


def check_predict(trainer, cfg) -> dict:
    """12a: the yolov3 predict step and evaluate_map at 416 px, batch 16,
    on the restored phase 5 weights; the card against the CPU on the
    config's seeded weights (phase 5's 3 steps leave the eval-mode heads
    so large that exp() in the box decode overflows: its boxes are not a
    comparison of two devices' arithmetic)."""
    batches = list(synthetic_batches(batch_size=cfg.batch_size,
                                     image_size=cfg.data.image_size,
                                     num_classes=cfg.data.num_classes,
                                     steps=2, seed=12))
    images = torch.from_numpy(batches[0][0]).cuda()
    state, model = trainer.state, trainer.model
    dtype = getattr(torch, cfg.dtype)
    nms_kw = dict(iou_thresh=PREDICT_IOU, score_thresh=PREDICT_SCORE,
                  max_detection=100)
    predict = make_predict_step(compute_dtype=dtype, **nms_kw)
    torch.cuda.reset_peak_memory_stats()
    step_ms, out = event_ms(lambda: predict(state, images))
    peak = torch.cuda.max_memory_allocated()
    model.eval()
    with torch.inference_mode():
        forward_ms, cand = event_ms(
            lambda: predict_candidates(model, images, dtype))
        nms_ms, _ = event_ms(lambda: batched_nms(*cand, **nms_kw))
        nms_kernels, nms_busy = device_profile(
            lambda: batched_nms(*cand, **nms_kw))
        forward_kernels, forward_busy = device_profile(
            lambda: predict_candidates(model, images, dtype))
    gflop = conv_gflop(model, lambda: predict_candidates(model, images[:1],
                                                         dtype))
    bound_ms = gflop * 1e9 * len(images) / PEAK_FLOPS[torch.bfloat16] * 1e3
    counts = out[3].tolist()
    n_cand = cand[1].shape[1]
    finite_boxes = float(torch.isfinite(cand[0]).float().mean())
    phase(f"12a predict step ({cfg.name}, batch {len(images)}, "
          f"{cfg.data.image_size} px, {cfg.dtype}, {n_cand} candidates, "
          f"D 100, score >= {PREDICT_SCORE}), each part timed alone by CUDA "
          f"events, median of {PREDICT_ITERS} after {PREDICT_WARMUP}: "
          f"step {step_ms:.3f} ms; forward {forward_ms:.3f} ms "
          f"({forward_kernels} kernels, {forward_busy:.3f} ms device busy; "
          f"its convs {gflop:.2f} GFLOP an image, bound {bound_ms:.3f} ms at "
          f"the bf16 peak); "
          f"NMS {nms_ms:.3f} ms ({nms_kernels} kernels, {nms_busy:.3f} ms "
          f"device busy); peak_memory_allocated={peak / 2**30:.3f} GiB; "
          f"counts {counts}; finite box coordinates {finite_boxes:.4f}")
    if out[0].shape != (len(images), 100, 4) or n_cand != 3 * sum(
            g * g for g in yolo_grid_sizes(cfg.data.image_size)):
        raise AssertionError(f"predict shapes {[t.shape for t in out]}")
    if not all(bool(((t >= 0) & (t <= 1)).all()) for t in out[1:3]):
        raise AssertionError("predict scores or class probabilities are "
                             "not finite values in [0, 1]")

    # NMS on the card against the CPU on identical inputs (every candidate
    # alive, so every image has 100 picks to compare)
    every = dict(nms_kw, score_thresh=0.0)
    with torch.inference_mode():
        card_nms = [t.cpu() for t in batched_nms(*cand, **every)]
    cpu_nms = batched_nms(*(t.cpu() for t in cand), **every)
    nms_equal = all(same(a, b) for a, b in zip(card_nms, cpu_nms))
    phase(f"12a NMS on the card vs on the CPU, identical candidates (score "
          f">= 0, {int(cpu_nms[3].sum())} picks): equal={nms_equal}")
    if not nms_equal or int(cpu_nms[3].min()) != 100:
        raise AssertionError("the card's NMS picks differ from the CPU's")

    # card vs CPU in f32 on the seeded weights
    f32 = build_model(cfg.replace(dtype="float32")).eval()
    two = batches[0][0][:2]
    with torch.inference_mode():
        cpu_cand = predict_candidates(f32, torch.from_numpy(two),
                                      torch.float32)
        card_cand = predict_candidates(copy.deepcopy(f32).cuda(),
                                       torch.from_numpy(two).cuda(),
                                       torch.float32)
        card_cand = [t.cpu() for t in card_cand]
        if not all(torch.isfinite(t).all() for t in cpu_cand):
            raise AssertionError("the seeded weights' candidates are not "
                                 "finite")
        pre_err = leaf_rel_err([t.numpy() for t in card_cand],
                               [t.numpy() for t in cpu_cand])
        scale = max(1.0, max(float(t.abs().max()) for t in cpu_cand))
        matched = match_picks(batched_nms(*card_cand, **every),
                              batched_nms(*cpu_cand, **every), DETECT_TOP,
                              DETECT_CPU_RTOL * scale)
    phase(f"12a card vs CPU, f32, the config's seeded weights, {len(two)} "
          f"images: candidates {pre_err:.3g} of each tensor's largest value "
          f"(bound {DETECT_CPU_RTOL:g}); top {DETECT_TOP} picks of each "
          f"image matched {matched}")
    if not pre_err <= DETECT_CPU_RTOL:
        raise AssertionError(f"card and CPU candidates differ by {pre_err:g}")

    t0 = time.perf_counter()
    summary = evaluate_map(state, batches, num_classes=cfg.data.num_classes,
                           metric="coco", compute_dtype=dtype)
    map_s = time.perf_counter() - t0
    phase(f"12a evaluate_map (coco) over {len(batches)} synthetic batches "
          f"of {cfg.batch_size}: " + " ".join(
              f"{k}={summary[k]:.4f}" for k in ("mAP", "mAP@0.5", "mAP@0.75")
              if k in summary) + f"; {len(summary)} keys; {map_s:.2f}s")
    if not {"mAP", "mAP@0.5", "mAP@0.95"} <= set(summary) or not all(
            np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"evaluate_map summary: {summary}")
    return {"step_ms": step_ms, "forward_ms": forward_ms, "nms_ms": nms_ms,
            "nms_kernels": nms_kernels, "nms_busy_ms": nms_busy,
            "forward_kernels": forward_kernels,
            "forward_busy_ms": forward_busy, "forward_bound_ms": bound_ms,
            "peak_bytes": peak,
            "map": summary["mAP"]}


#: background checks (phase 12b's and 13's evaluate workers, phase 13's CPU
#: halves, phase 15c)
BACKGROUND = concurrent.futures.ThreadPoolExecutor(
    max_workers=4, thread_name_prefix="chip_smoke")


def start_p12_evaluation() -> dict:
    """12b's `YOLO/torch/evaluate.py --synthetic`, a worker on the card
    started in the background once 12a's timings are taken, beside 12b's
    detect lines and 12c; `finish_p12_evaluation` reads it."""
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    run = {"root": root, "t0": time.perf_counter(),
           "json": f"{root}/eval.json"}

    def work():
        run_workers([[sys.executable, f"{HERE}/YOLO/torch/evaluate.py",
                      "-m", YOLO_MODEL, "--synthetic", "--out", run["json"],
                      "--workdir", f"{root}/wd"]], [dict(os.environ)],
                    [f"{root}/eval.log"], timeout=EVALUATE_TIMEOUT)
        return time.perf_counter() - run["t0"]

    run["job"] = BACKGROUND.submit(work)
    return run


def finish_p12_evaluation(run: dict) -> dict:
    """Wait for 12b's evaluate worker: rc 0, a finite mAP in its JSON."""
    try:
        seconds = run["job"].result(EVALUATE_TIMEOUT + 60)
        with open(run["json"]) as fh:
            metrics = json.load(fh)
    finally:
        shutil.rmtree(run["root"], ignore_errors=True)
    phase(f"12b YOLO/torch/evaluate.py -m {YOLO_MODEL} --synthetic: rc 0 "
          f"in {seconds:.1f}s (beside 12b's detect lines and 12c), "
          f"mAP={metrics['mAP']:.4f} mAP@0.5={metrics['mAP@0.5']:.4f}")
    if not np.isfinite(metrics["mAP"]):
        raise AssertionError(f"evaluate.py wrote {metrics}")
    return {"mAP": metrics["mAP"], "seconds": seconds}


def check_detection_entry_points(trainer, cfg) -> None:
    """12b: detect.py's chunk-to-lines function on synthetic scenes (its
    evaluate.py runs as a worker, `start_p12_evaluation`)."""
    detect = runpy.run_path(f"{HERE}/YOLO/torch/detect.py",
                            run_name="not_main")
    size = cfg.data.image_size
    scenes, *_ = next(synthetic_batches(batch_size=DETECT_SCENES,
                                        image_size=size,
                                        num_classes=cfg.data.num_classes,
                                        steps=1, seed=13))
    batch = np.zeros((detect["CHUNK"], size, size, 3), np.float32)
    batch[:DETECT_SCENES] = scenes
    paths = [f"scene{i}" for i in range(DETECT_SCENES)]
    lines = detect["detection_lines"](make_predict_step(), trainer.state,
                                      batch, paths, names_for(
                                          cfg.data.num_classes))
    heads = [ln for ln in lines if not ln.startswith("  ")]
    for ln in lines[:6]:
        phase(f"12b detect.py lines: {ln}")
    if [h.split(":")[0] for h in heads] != paths or not all(
            h.endswith(" detections") for h in heads):
        raise AssertionError(f"detect.py printed {lines[:4]}")


def check_detection_serving() -> dict:
    """12c: yolov3 served at full width through the port's own
    `serve.cli.build_server` on the card at buckets {1, 8}."""
    args = build_parser().parse_args(
        ["-m", YOLO_MODEL, "--device", "cuda", "--buckets",
         ",".join(map(str, SERVE_BUCKETS)), "--flush-every", "60"])
    server = build_server(args)
    engine = server.engine
    engine.dispatches = 0
    snap = _smoke(server, duration=3.0, n_threads=8)
    server.close()
    cfg = get_config(YOLO_MODEL)
    rs = np.random.RandomState(12)
    errs = np.zeros(9)
    for n in (1, 3, 8, 9):
        x = rs.randn(n, *engine.example_shape).astype(np.float32)
        got = engine.predict(x)
        want = [(n, g, g, 3, k) for g in yolo_grid_sizes(cfg.data.image_size)
                for k in (4, 1, cfg.data.num_classes)]
        if [np.shape(leaf) for leaf in _leaves(got)] != want:
            raise AssertionError(f"{YOLO_MODEL} answered "
                                 f"{[np.shape(t) for t in _leaves(got)]}")
        errs = np.maximum(errs, leaf_rel_errs(got, engine.reference(x)))
    http = InferenceServer(engine=engine, max_delay_ms=5.0,
                           default_deadline_s=120.0, flush_every_s=60.0)
    t = threading.Thread(target=lambda: http.serve(port=0), daemon=True)
    t.start()
    try:
        if not http.ready.wait(60):
            raise RuntimeError("HTTP server did not start")
        x = rs.randn(1, *engine.example_shape).astype(np.float32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{http.bound_port}/predict",
            data=json.dumps({"instances": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
        http_s = time.perf_counter() - t0
        answer = json.loads(body)["predictions"]
    finally:
        http.stop()
        t.join(timeout=60)
        http.close()
    http_err = leaf_rel_err(answer, engine.reference(x))
    cpu = PredictEngine.from_config(YOLO_MODEL, device="cpu", buckets=(1,),
                                    verbose=False)
    cpu_errs = leaf_rel_errs(engine.reference(x), cpu.reference(x))
    batch_ms = {b: engine.measure_batch_ms(b, 10) for b in engine.buckets}
    phase(f"12c {YOLO_MODEL} served at buckets {engine.buckets}: smoke "
          f"{snap['requests']:.0f} requests, p50_ms="
          f"{snap.get('p50_ms', float('nan')):.3f} p99_ms="
          f"{snap.get('p99_ms', float('nan')):.3f} images_per_sec="
          f"{snap['images_per_sec']:.1f}; {engine.dispatches} dispatches")
    err, cpu_err = max(errs), max(cpu_errs)
    phase(f"12c answers vs engine.reference(), worst leaf relative to its "
          f"largest value: in-process {err:.3g} (by leaf kind, worst scale: "
          f"{by_kind(errs)}), HTTP (1 image, {len(body) / 1e6:.1f} MB of "
          f"JSON in {http_s:.2f}s) {http_err:.3g} (bound "
          f"{DETECT_SERVE_TOL:g}); card vs CPU engine on the same seeded "
          f"weights, 1 image: {cpu_err:.3g} ({by_kind(cpu_errs)}; bound "
          f"{DETECT_SERVE_TOL:g})")
    phase("12c measure_batch_ms (host input to host output): " + " ".join(
        f"bucket {b}: {ms:.3f}" for b, ms in batch_ms.items()))
    if not (err <= DETECT_SERVE_TOL and http_err <= DETECT_SERVE_TOL
            and cpu_err <= DETECT_SERVE_TOL):
        raise AssertionError(f"{YOLO_MODEL} served answers differ: {err:g}, "
                             f"HTTP {http_err:g}, card vs CPU {cpu_err:g}")
    return {"batch_ms": batch_ms, "http_s": http_s}


def by_kind(errs) -> str:
    """Per-leaf errors of the three (boxes, objectness, class_probs)
    scales, the worst scale of each kind."""
    return " ".join(f"{kind} {max(errs[i::3]):.3g}" for i, kind in
                    enumerate(("boxes", "objectness", "class_probs")))


def check_detection_inference(yolo: dict) -> dict:
    """Phase 12, slice 9: yolov3 inference on the phase 5 checkpoint. No
    TPU kernel is on this path: the K1 and K2 counts, zeroed here, must
    stay 0."""
    t0 = time.perf_counter()
    flash_attention.launches = best_iou.launches = 0
    cfg = yolo["config"]
    trainer = DetectionTrainer(cfg, device="cuda", workdir=yolo["workdir"])
    trainer.init_state()
    if trainer.resume() != 1:
        raise AssertionError("phase 5's checkpoint did not restore")
    out = check_predict(trainer, cfg)
    evaluation = start_p12_evaluation()
    check_detection_entry_points(trainer, cfg)
    trainer.close()
    out["serve"] = check_detection_serving()
    out["evaluate"] = finish_p12_evaluation(evaluation)
    counts = (flash_attention.launches, best_iou.launches)
    phase(f"12: launches on the inference path (flash_attention, best_iou): "
          f"{counts}; phase 12 took {time.perf_counter() - t0:.1f}s")
    if counts != (0, 0):
        raise AssertionError(f"a kernel ran on the inference path: {counts}")
    return out


# -- phase 13: CenterNet and stacked-Hourglass pose -------------------------

P13_SIZE = 256
# the configs' batches (64 for centernet, 128 for hourglass104) cut to 32
P13_BATCH = 32
P13_STEPS = 2
P13_EVAL_BATCHES = 2           # the synthetic validation set
# config -> (family entry point, parameters of the JAX model)
P13_MODELS = {"centernet": ("ObjectsAsPoints", 110_102_312),
              "hourglass104": ("Hourglass", 16_290_752)}
# the predict step's detections (CenterNet decode)
P13_TOP_K = 100
# decode on the card against decode on the CPU on identical heads whose
# logits take five values: the peak test and every tie are decided by
# equal values on each device, so the picks are equal and the scores are
# one sigmoid of the same logit on each (within an f32 rounding)
DECODE_SCORE_TOL = 1e-6
# served answers (bf16): a padded bucket against the exact batch on the
# card, and the card against an engine on the CPU, each leaf within this
# share of its largest value: phase 12c's bound for a bf16 conv net of
# about 100 layers
P13_SERVE_TOL = 1e-1


def p13_args(name: str, workdir: str) -> list:
    return ["-m", name, "--synthetic", "--image-size", str(P13_SIZE),
            "--batch-size", str(P13_BATCH), "--steps-per-epoch",
            str(P13_STEPS), "--epochs", "1", "--device", "cuda",
            "--workdir", workdir]


def p13_batches(name: str, cfg, seed: int):
    """Synthetic training batches of `name`'s family at `cfg`'s batch and
    size."""
    if name == "centernet":
        return synthetic_batches(batch_size=cfg.batch_size,
                                 image_size=cfg.data.image_size,
                                 num_classes=cfg.data.num_classes, steps=1,
                                 seed=seed)
    return pose_synthetic_batches(batch_size=cfg.batch_size,
                                  image_size=cfg.data.image_size, steps=1,
                                  seed=seed)


def p13_step_factory(name: str, cfg):
    """`make_step(dtype)` of `name`'s train step at `cfg`'s size."""
    grid = cfg.data.image_size // 4
    if name == "centernet":
        return lambda dt: make_centernet_train_step(
            num_classes=cfg.data.num_classes, grid=grid, compute_dtype=dt)
    return lambda dt: make_pose_train_step(heatmap_size=(grid, grid),
                                           compute_dtype=dt)


def p13_cpu_side() -> dict:
    """The CPU's halves of phase 13, computed on a thread beside the
    card's work from the phase's start (they depend on no training): per
    model, the one-step check's config, seeded model and calibration
    batch with the CPU's f64 step on them, and 13c's engine on the CPU."""
    out = {}
    for name in P13_MODELS:
        cfg = get_config(name)
        cfg = cfg.replace(dtype="float32", data=dataclasses.replace(
            cfg.data, image_size=P13_SIZE))
        trainer_cls = CenterNetTrainer if name == "centernet" else PoseTrainer
        batch = trainer_cls._calibration_batch(
            types.SimpleNamespace(config=cfg), (P13_SIZE, P13_SIZE, 3), 2)
        model = build_model(cfg)
        ref = train_step_grads(cfg, model, batch, torch.device("cpu"),
                               torch.float64, p13_step_factory(name, cfg))
        engine = PredictEngine.from_config(name, device="cpu", buckets=(1,),
                                           verbose=False)
        out[name] = {"cfg": cfg, "model": model, "batch": batch, "ref": ref,
                     "cpu_engine": engine}
    return out


def check_p13_training(name: str, tag: str, cpu_side=None) -> dict:
    """13a/13b: `name` at full width, 256 px, trained through its family's
    entry point for 2 synthetic steps at batch 32, 2 validation batches
    and one checkpoint: finite losses, step_ms, peak memory, the
    parameter count, the checkpoint restored into a fresh trainer with
    equal weights, BatchNorm statistics and Adam state; then one f32 step
    on 2 images on the card against the CPU (check_step_against_f64)."""
    family, count = P13_MODELS[name]
    full = get_config(name)
    phase(f"{tag} {name}: the config's batch {full.batch_size} cut to "
          f"{P13_BATCH}, {P13_STEPS} steps, {P13_EVAL_BATCHES} eval batches")
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    marks = [time.perf_counter()]
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, result = family_main(family, p13_args(name, workdir))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ran = trainer.config
        params = sum(p.numel() for p in trainer.state.model.parameters())
        steps = trainer.last_epoch_steps
        for i, s in enumerate(steps):
            phase(f"{tag} {name} step {i + 1}: " + " ".join(
                f"{k}={v:.4f}" for k, v in s.items()))
        step_ms = steps[-1]["step_ms"]
        phase(f"{tag} {name} ({family}, {P13_SIZE} px, batch {P13_BATCH}, "
              f"{ran.optimizer.name}, bf16): params={params:,} val loss="
              f"{result.get('loss', float('nan')):.4f} step_ms={step_ms:.3f} "
              f"(step 2; step 1 {steps[0]['step_ms']:.3f}) images_per_sec="
              f"{P13_BATCH / step_ms * 1e3:.2f} peak_memory_allocated="
              f"{peak / 2**30:.3f} GiB; {family} entry point {wall:.1f}s")
        if (ran.data.image_size, ran.data.num_classes, ran.batch_size) != (
                P13_SIZE, full.data.num_classes, P13_BATCH):
            raise AssertionError(f"{name} ran at {ran.data}")
        if params != count:
            raise AssertionError(f"{name} has {params:,} parameters, the "
                                 f"JAX model {count:,}")
        if len(steps) != P13_STEPS or not all(
                np.isfinite(v) for s in steps for v in s.values()):
            raise AssertionError(f"{name} steps not all finite: {steps}")
        if result.get("count") != P13_EVAL_BATCHES or not np.isfinite(
                result.get("loss", np.nan)):
            raise AssertionError(f"{name} validation: {result}")
        # the fresh trainer takes a zeroed copy of the architecture (not a
        # second random init of it: 110M parameters built on the host were
        # a third of 13a), so every restored value had to come from disk
        fresh = type(trainer)(ran, device="cuda", workdir=workdir,
                              model=zeroed_copy(trainer.model))
        fresh.init_state()
        if fresh.resume() != 1:
            raise AssertionError("the epoch-1 checkpoint did not restore")
        want, got = trainer.state.state_dict(), fresh.state.state_dict()
        equal = same_tree(want, got)
        fresh.close()
        n_stats = sum(1 for k in want["model"] if "running" in k)
        phase(f"{tag} checkpoint round trip: {len(want['model'])} tensors "
              f"({n_stats} BatchNorm statistics), Adam's moments (count "
              f"{got['optimizer']['count']}), step {got['step']}, "
              f"equal={equal}")
        if not equal:
            raise AssertionError("the restored state differs from the "
                                 "trained")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    marks.append(time.perf_counter())
    # the step alone (its EMA update included) on a batch already on the
    # card: wall by CUDA events, kernels and device busy by the profiler
    batch = trainer._to_device(next(p13_batches(name, ran, seed=19)))
    alone_ms, _ = event_ms(lambda: trainer.run_step(batch), warmup=1,
                           iters=3)
    kernels, busy = device_profile(lambda: trainer.run_step(batch))
    marks.append(time.perf_counter())
    phase(f"{tag} {name} train step alone on a staged batch: "
          f"{alone_ms:.3f} ms (CUDA events, median of 3 after 1); {kernels} "
          f"kernels, {busy:.3f} ms device busy (device idle "
          f"{100 * max(0.0, 1 - busy / alone_ms):.1f}%)")
    # at P13_SIZE: smaller, the check is ill-conditioned even in f64
    # (CenterNet's focal loss clamps sigmoid(logit) at 1e-6, which some
    # logits reach at 128 px; hourglass104's BatchNorm at 64 px normalizes
    # 2 images over a few cells); the CPU's own f32 step is not taken, its
    # f64 step comes from `p13_cpu_side` where the phase started it
    if cpu_side is not None:
        side = cpu_side.result(EVALUATE_TIMEOUT)[name]
        cfg, model, batch, ref = (side["cfg"], side["model"], side["batch"],
                                  side["ref"])
    else:
        cfg = ran.replace(dtype="float32")
        model, ref = build_model(cfg), None
        batch = trainer._calibration_batch((P13_SIZE, P13_SIZE, 3), 2)
    step_err = check_step_against_f64(
        cfg, model, batch, f"{tag} {name}", f"2 images at {P13_SIZE} px",
        make_step=p13_step_factory(name, cfg), cpu_f32=False, ref=ref)
    marks.append(time.perf_counter())
    phase(f"{tag} seconds: training and round trip "
          f"{marks[1] - marks[0]:.1f}, step alone {marks[2] - marks[1]:.1f}, "
          f"one-step check {marks[3] - marks[2]:.1f}")
    return {"trainer": trainer, "step_ms": step_ms, "peak_bytes": peak,
            "params": params, "losses": steps, "step_err": step_err,
            "alone_ms": alone_ms, "kernels": kernels, "busy_ms": busy}


def coarse_heads(b: int, g: int, c: int, seed: int) -> dict:
    """CenterNet heads whose heatmap logits take five values (plateaus of
    equal peaks, more tied scores than picks); image 0 one flat plateau
    (every cell a peak, all tied); image 1 a ramp 0.02 a cell and 0.001 a
    class apart, whose only peak in each class is its last cell: fewer
    peaks than picks, the rest zero scores in index order."""
    rs = np.random.RandomState(seed)
    hm = rs.choice([-6.0, -2.0, 0.0, 1.0, 3.0], (b, g, g, c))
    hm[0] = 1.0
    ramp = np.arange(g)[:, None, None] + np.arange(g)[None, :, None]
    hm[1] = -4.0 + 0.02 * ramp + 0.001 * np.arange(c)
    return {"heatmap": torch.from_numpy(hm.astype(np.float32)),
            "size": torch.from_numpy(rs.uniform(0, 8, (b, g, g, 2))
                                     .astype(np.float32)),
            "offset": torch.from_numpy(rs.uniform(0, 1, (b, g, g, 2))
                                       .astype(np.float32))}


def check_centernet_predict(trainer) -> dict:
    """13a: the predict step at batch 32 on the trained weights, timed by
    CUDA events and split into the forward and decode; decode on the card
    against the CPU on identical coarse heads."""
    cfg = trainer.config
    dtype = getattr(torch, cfg.dtype)
    state, model = trainer.state, trainer.model
    images = torch.from_numpy(next(synthetic_batches(
        batch_size=P13_BATCH, image_size=P13_SIZE,
        num_classes=cfg.data.num_classes, steps=1, seed=14))[0]).cuda()
    predict = make_centernet_predict_step(compute_dtype=dtype,
                                          max_detections=P13_TOP_K)
    torch.cuda.reset_peak_memory_stats()
    step_ms, out = event_ms(lambda: predict(state, images))
    peak = torch.cuda.max_memory_allocated()
    model.eval()
    with torch.inference_mode():
        forward_ms, heads = event_ms(
            lambda: predict_heads(model, images, dtype))
        decode_ms, _ = event_ms(lambda: cn_ops.decode(
            heads, max_detections=P13_TOP_K))
        forward_kernels, forward_busy = device_profile(
            lambda: predict_heads(model, images, dtype))
        decode_kernels, decode_busy = device_profile(
            lambda: cn_ops.decode(heads, max_detections=P13_TOP_K))
    gflop = conv_gflop(model, lambda: predict_heads(model, images[:1],
                                                    dtype))
    bound_ms = gflop * 1e9 * P13_BATCH / PEAK_FLOPS[torch.bfloat16] * 1e3
    phase(f"13a predict step (centernet, batch {P13_BATCH}, {P13_SIZE} px, "
          f"bf16, K {P13_TOP_K}), each part timed alone by CUDA events, "
          f"median of {PREDICT_ITERS} after {PREDICT_WARMUP}: step "
          f"{step_ms:.3f} ms; forward {forward_ms:.3f} ms ({forward_kernels} "
          f"kernels, {forward_busy:.3f} ms device busy; its convs "
          f"{gflop:.2f} GFLOP an image, bound {bound_ms:.3f} ms at the bf16 "
          f"peak); decode {decode_ms:.3f} ms ({decode_kernels} kernels, "
          f"{decode_busy:.3f} ms device busy); peak_memory_allocated="
          f"{peak / 2**30:.3f} GiB")
    if [tuple(t.shape) for t in out] != [(P13_BATCH, P13_TOP_K, 4),
                                         (P13_BATCH, P13_TOP_K),
                                         (P13_BATCH, P13_TOP_K)] or not bool(
            ((out[1] >= 0) & (out[1] <= 1)).all()):
        raise AssertionError(f"predict shapes {[t.shape for t in out]}")

    g = P13_SIZE // 4
    heads = coarse_heads(P13_BATCH, g, cfg.data.num_classes, seed=15)
    cpu = cn_ops.decode(heads, max_detections=P13_TOP_K)
    with torch.inference_mode():
        card = [t.cpu() for t in cn_ops.decode(
            {k: v.cuda() for k, v in heads.items()},
            max_detections=P13_TOP_K)]
    picks_equal = torch.equal(card[2], cpu[2])
    score_err = float((card[1] - cpu[1]).abs().max())
    box_err = float((card[0] - cpu[0]).abs().max())
    zeros = int((cpu[1] == 0).sum())
    phase(f"13a decode on the card vs on the CPU, identical coarse heads "
          f"({P13_BATCH} x {g} x {g} x {cfg.data.num_classes}, five logit "
          f"values; {zeros} zero-score picks, ties in index order): classes "
          f"equal={picks_equal}, scores {score_err:.3g} (bound "
          f"{DECODE_SCORE_TOL:g}), boxes {box_err:.3g}")
    if not (picks_equal and score_err <= DECODE_SCORE_TOL
            and box_err <= DECODE_SCORE_TOL * g and zeros > 0):
        raise AssertionError("the card's decode differs from the CPU's")

    return {"step_ms": step_ms, "forward_ms": forward_ms,
            "decode_ms": decode_ms, "forward_busy_ms": forward_busy,
            "decode_busy_ms": decode_busy, "forward_kernels": forward_kernels,
            "decode_kernels": decode_kernels, "forward_bound_ms": bound_ms,
            "peak_bytes": peak}


def last_heatmaps(model, images, dtype) -> torch.Tensor:
    """The last stack's heatmaps of `model` on `images` (inference)."""
    return model(images.to(dtype))[-1]


def check_pose_predict(trainer) -> dict:
    """13b: the pose predict (last stack, per-joint decode) at batch 32,
    timed by CUDA events and split into the forward and the decode;
    evaluate_pckh on the card against the CPU on the config's seeded f32
    weights."""
    cfg = trainer.config
    dtype = getattr(torch, cfg.dtype)
    model = trainer.model
    images = torch.from_numpy(next(pose_synthetic_batches(
        batch_size=P13_BATCH, image_size=P13_SIZE, steps=1,
        seed=16))[0]).cuda()
    model.eval()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        step_ms, _ = event_ms(lambda: decode_keypoints(
            last_heatmaps(model, images, dtype)))
        peak = torch.cuda.max_memory_allocated()
        forward_ms, hm = event_ms(lambda: last_heatmaps(model, images,
                                                        dtype))
        decode_ms, _ = event_ms(lambda: decode_keypoints(hm))
        forward_kernels, forward_busy = device_profile(
            lambda: last_heatmaps(model, images, dtype))
    gflop = conv_gflop(model, lambda: model(images[:1].to(dtype)))
    bound_ms = gflop * 1e9 * P13_BATCH / PEAK_FLOPS[torch.bfloat16] * 1e3
    phase(f"13b pose predict (hourglass104, batch {P13_BATCH}, {P13_SIZE} "
          f"px, bf16, last stack + per-joint argmax), CUDA events, median "
          f"of {PREDICT_ITERS} after {PREDICT_WARMUP}: {step_ms:.3f} ms; "
          f"forward {forward_ms:.3f} ms ({forward_kernels} kernels, "
          f"{forward_busy:.3f} ms device busy; its convs {gflop:.2f} GFLOP "
          f"an image, every stack, bound {bound_ms:.3f} ms at the bf16 "
          f"peak); decode {decode_ms:.3f} ms; peak_memory_allocated="
          f"{peak / 2**30:.3f} GiB")

    # PCKh on the card and on the CPU, the config's seeded weights in f32
    f32 = build_model(cfg.replace(dtype="float32"))
    batches = list(pose_synthetic_batches(batch_size=4,
                                          image_size=P13_SIZE, steps=1,
                                          seed=17))
    sgd = torch.optim.SGD([torch.zeros(1)], lr=0.0)
    card_model = copy.deepcopy(f32).cuda()
    card = evaluate_pckh(TrainState(card_model, sgd), batches)
    cpu = evaluate_pckh(TrainState(f32, sgd), batches)
    x = torch.from_numpy(batches[0][0])
    with torch.inference_mode():
        hm_cpu = last_heatmaps(f32.eval(), x, torch.float32)
        hm_card = last_heatmaps(card_model.eval(), x.cuda(),
                                torch.float32).cpu()
    err = float((hm_card - hm_cpu).abs().max())
    scale = float(hm_cpu.abs().max())
    # a pick may differ only where the CPU's heatmap holds two cells
    # within the two devices' difference of each other
    flat_cpu = hm_cpu.flatten(1, 2)
    card_idx = hm_card.flatten(1, 2).argmax(dim=1)
    gap = flat_cpu.max(dim=1).values - flat_cpu.gather(
        1, card_idx[:, None]).squeeze(1)
    differ = card_idx != flat_cpu.argmax(dim=1)
    undecided = int((differ & (gap <= 2 * err)).sum())
    phase(f"13b evaluate_pckh on the card vs the CPU, seeded f32 weights, 4 "
          f"images: PCKh@0.5 {card['PCKh@0.5']:.4f} vs {cpu['PCKh@0.5']:.4f}"
          f", summaries equal={card == cpu}; heatmaps {err:.3g} apart (of "
          f"{scale:.3g}: random weights grow the residual stream); "
          f"picks differing {int(differ.sum())} of {differ.numel()} "
          f"({undecided} within that difference of the CPU's peak)")
    if int(differ.sum()) != undecided or (card != cpu and not undecided):
        raise AssertionError("the card's PCKh differs from the CPU's")

    return {"step_ms": step_ms, "forward_ms": forward_ms,
            "decode_ms": decode_ms, "forward_busy_ms": forward_busy,
            "forward_kernels": forward_kernels, "forward_bound_ms": bound_ms,
            "peak_bytes": peak}


def start_p13_evaluations() -> dict:
    """13a/13b's `ObjectsAsPoints/torch/evaluate.py -m centernet
    --synthetic` and `Hourglass/torch/evaluate.py --synthetic` at full
    width, started together as workers in the background when phase 13
    starts; `finish_p13_evaluations` reads them."""
    root = tempfile.mkdtemp(prefix="chip_smoke_p13_eval_")
    run = {"root": root, "t0": time.perf_counter(),
           "json": f"{root}/cn.json",
           "logs": [f"{root}/cn.log", f"{root}/hg.log"]}

    def work():
        run_workers(
            [[sys.executable, f"{HERE}/ObjectsAsPoints/torch/evaluate.py",
              "-m", "centernet", "--synthetic", "--out", run["json"],
              "--workdir", f"{root}/cn_wd"],
             [sys.executable, f"{HERE}/Hourglass/torch/evaluate.py",
              "--synthetic", "--workdir", f"{root}/hg_wd"]],
            [dict(os.environ)] * 2, run["logs"], timeout=EVALUATE_TIMEOUT)
        return time.perf_counter() - run["t0"]

    run["job"] = BACKGROUND.submit(work)
    return run


def finish_p13_evaluations(run: dict) -> dict:
    """Wait for the evaluate workers: rc 0 each, a finite mAP in the
    CenterNet JSON, one finite `PCKh@0.5` line from Hourglass."""
    try:
        seconds = run["job"].result(EVALUATE_TIMEOUT + 60)
        with open(run["json"]) as fh:
            metrics = json.load(fh)
        with open(run["logs"][1]) as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith("PCKh@0.5: ")]
    finally:
        shutil.rmtree(run["root"], ignore_errors=True)
    phase(f"13a ObjectsAsPoints/torch/evaluate.py -m centernet --synthetic "
          f"and 13b Hourglass/torch/evaluate.py --synthetic, full width, as "
          f"workers started with the phase: rc 0 both, in {seconds:.1f}s; "
          f"mAP={metrics['mAP']:.4f} mAP@0.5={metrics['mAP@0.5']:.4f}; "
          f"{lines}")
    if not np.isfinite(metrics["mAP"]):
        raise AssertionError(f"evaluate.py wrote {metrics}")
    if len(lines) != 1 or not np.isfinite(float(lines[0].split()[-1])):
        raise AssertionError(f"evaluate.py printed {lines}")
    return {"mAP": metrics["mAP"], "pckh": lines[0], "seconds": seconds}


def check_p13_serving(name: str, cpu_engine=None) -> dict:
    """13c: `name` served by the engine on the card at buckets {1, 8} on
    its seeded weights: every answer tree held leaf by leaf against
    `engine.reference()`, one image against an engine on the CPU,
    `measure_batch_ms` per bucket."""
    engine = PredictEngine.from_config(name, device="cuda",
                                       buckets=SERVE_BUCKETS, verbose=False)
    rs = np.random.RandomState(18)
    errs = []
    for n in (1, 3, 8, 9):
        x = rs.randn(n, *engine.example_shape).astype(np.float32)
        got = engine.predict(x)
        if [np.shape(leaf)[0] for leaf in _leaves(got)] != [n] * len(
                list(_leaves(got))):
            raise AssertionError(f"{name} answered {n} images with "
                                 f"{[np.shape(t) for t in _leaves(got)]}")
        errs.append(leaf_rel_err(got, engine.reference(x)))
    x = rs.randn(1, *engine.example_shape).astype(np.float32)
    cpu = cpu_engine or PredictEngine.from_config(
        name, device="cpu", buckets=(1,), verbose=False)
    cpu_err = leaf_rel_err(engine.reference(x), cpu.reference(x))
    shapes = [np.shape(leaf) for leaf in _leaves(engine.reference(x))]
    batch_ms = {b: engine.measure_batch_ms(b, 10) for b in engine.buckets}
    phase(f"13c {name} served at buckets {engine.buckets}: answer leaves "
          f"{shapes}; answers vs engine.reference() at 1, 3, 8, 9 images, "
          f"worst leaf relative to its largest value {max(errs):.3g}; card "
          f"vs CPU engine on the same seeded weights, 1 image: "
          f"{cpu_err:.3g} (bound {P13_SERVE_TOL:g}); measure_batch_ms "
          + " ".join(f"bucket {b}: {ms:.3f}" for b, ms in batch_ms.items()))
    if not (max(errs) <= P13_SERVE_TOL and cpu_err <= P13_SERVE_TOL):
        raise AssertionError(f"{name} served answers differ: {errs}, card "
                             f"vs CPU {cpu_err:g}")
    return {"batch_ms": batch_ms, "err": max(errs), "cpu_err": cpu_err}


def check_centernet_and_pose() -> dict:
    """Phase 13, slice 10: CenterNet and stacked-Hourglass pose trained,
    evaluated, inferred and served at full width. No TPU kernel is on this
    path: the K1 and K2 counts, zeroed here, must stay 0."""
    t0 = time.perf_counter()
    flash_attention.launches = best_iou.launches = 0
    evaluations = start_p13_evaluations()
    cpu_side = BACKGROUND.submit(p13_cpu_side)
    marks = [("start", time.perf_counter())]
    out = {"centernet": check_p13_training("centernet", "13a", cpu_side)}
    marks.append(("13a training", time.perf_counter()))
    out["centernet"]["predict"] = check_centernet_predict(
        out["centernet"].pop("trainer"))
    marks.append(("13a predict", time.perf_counter()))
    torch.cuda.empty_cache()
    out["hourglass104"] = check_p13_training("hourglass104", "13b",
                                             cpu_side)
    marks.append(("13b training", time.perf_counter()))
    out["hourglass104"]["predict"] = check_pose_predict(
        out["hourglass104"].pop("trainer"))
    marks.append(("13b predict", time.perf_counter()))
    torch.cuda.empty_cache()
    for name in P13_MODELS:
        out[name]["serve"] = check_p13_serving(
            name, cpu_side.result(EVALUATE_TIMEOUT)[name]["cpu_engine"])
    marks.append(("13c serving", time.perf_counter()))
    out["evaluate"] = finish_p13_evaluations(evaluations)
    marks.append(("the evaluate workers' wait", time.perf_counter()))
    phase("13: seconds by part: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in
        enumerate(marks[1:])))
    counts = (flash_attention.launches, best_iou.launches)
    phase(f"13: launches on the CenterNet and pose paths (flash_attention, "
          f"best_iou): {counts}; phase 13 took "
          f"{time.perf_counter() - t0:.1f}s")
    if counts != (0, 0):
        raise AssertionError(f"a kernel ran on the phase 13 paths: {counts}")
    return out


# -- phase 14: U-Net segmentation, checkpoint restore, DCGAN, CycleGAN ------

P14_SEG_MODEL = "unet_resnet50"
P14_SEG_SIZE = 224
P14_SEG_BATCH = 32             # the config's batch
P14_SEG_STEPS = 3
P14_SEG_EVAL_BATCHES = 2       # the synthetic validation set
# an EMA (not in the config) so that the restore must serve the EMA
# weights and not the trained ones
P14_EMA_DECAY = 0.999
# parameters of the JAX model
P14_SEG_PARAMS = 33_759_381
P14_F64_SIZE = 64              # the card-vs-CPU steps: 2 images at 64 px
# served masks against the predict step on the same restored weights: a
# pixel may differ only where the step's top two logits are closer than
# twice the largest difference between the engine's logits (its weights
# cast once, the batch padded to its bucket) and the step's; such pixels
# are counted and printed
P14_SERVE_BUCKETS = (1, 8)
P14_DCGAN_BATCH = 256          # the config's batch
P14_DCGAN_STEPS = 3
P14_DCGAN_SAMPLES = 16
P14_CG_SIZE = 256
P14_CG_BATCH = 8               # the config's batch
P14_CG_BLOCKS = 9
P14_CG_STEPS = 2
# restored yolov3 answers against an engine on the trainer's restored
# state_dict: the same weights through the same kernels on the same card
P14_RESTORE_RTOL = 1e-6


def _synthetic_seg(cfg, batch: int, seed: int):
    """One synthetic segmentation batch of `cfg` (uint8 pairs at the
    decode size under the device augment)."""
    size = cfg.data.image_size
    if cfg.device_augment:
        size = decode_image_size(size)
    return next(iter(SyntheticSegmentation(
        batch, size, cfg.data.channels, cfg.data.num_classes, 1, seed=seed,
        emit_uint8=cfg.device_augment)))


def check_segmentation_training() -> dict:
    """14a: unet_resnet50 at full width and 224 px trained through
    UNet/torch/train.py's `cli.run_segmentation` with the paired device
    augment and an EMA for 3 synthetic steps, 2 validation batches and one
    checkpoint: finite losses, mIoU and pixel accuracy, the JAX model's
    parameter count; the step alone (CUDA events; kernels and device busy
    from the profiler), peak memory; one step on 2 images at 64 px on the
    card in f64 and f32 against the CPU in f64; the predict step at batch
    32. The workdir stays for 14b."""
    name = P14_SEG_MODEL
    workdir = tempfile.mkdtemp(prefix="chip_smoke_unet_")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, result = family_main("UNet", [
        "-m", name, "--synthetic", "--image-size", str(P14_SEG_SIZE),
        "--batch-size", str(P14_SEG_BATCH), "--steps-per-epoch",
        str(P14_SEG_STEPS), "--epochs", "1", "--device-augment",
        "--ema-decay", str(P14_EMA_DECAY), "--device", "cuda",
        "--workdir", workdir])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ran = trainer.config
    params = sum(p.numel() for p in trainer.model.parameters())
    steps = trainer.last_epoch_steps
    for i, s in enumerate(steps):
        phase(f"14a {name} step {i + 1}: " + " ".join(
            f"{k}={v:.4f}" for k, v in s.items()))
    step_ms = statistics.median(s["step_ms"] for s in steps[1:])
    phase(f"14a {name} ({P14_SEG_SIZE} px, batch {P14_SEG_BATCH}, "
          f"{ran.optimizer.name}, bf16, paired device augment, EMA "
          f"{P14_EMA_DECAY}): params={params:,} val loss="
          f"{result.get('loss', float('nan')):.4f} miou="
          f"{result.get('miou', float('nan')):.4f} pixel_acc="
          f"{result.get('pixel_acc', float('nan')):.4f} step_ms="
          f"{step_ms:.3f} (median after the first; first "
          f"{steps[0]['step_ms']:.3f}) images_per_sec="
          f"{P14_SEG_BATCH / step_ms * 1e3:.2f} peak_memory_allocated="
          f"{peak / 2**30:.3f} GiB; UNet entry point {wall:.1f}s")
    if (ran.data.image_size, ran.batch_size, ran.device_augment) != (
            P14_SEG_SIZE, P14_SEG_BATCH, True):
        raise AssertionError(f"{name} ran at {ran}")
    if params != P14_SEG_PARAMS:
        raise AssertionError(f"{name} has {params:,} parameters, the JAX "
                             f"model {P14_SEG_PARAMS:,}")
    if len(steps) != P14_SEG_STEPS or not all(
            np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"{name} steps not all finite: {steps}")
    if result.get("count") != P14_SEG_EVAL_BATCHES or not all(
            np.isfinite(result.get(k, np.nan))
            for k in ("loss", "miou", "pixel_acc")):
        raise AssertionError(f"{name} validation: {result}")

    batch = trainer._to_device(_synthetic_seg(ran, P14_SEG_BATCH, seed=19))
    alone_ms, _ = event_ms(lambda: trainer.run_step(batch), warmup=1,
                           iters=3)
    kernels, busy = device_profile(lambda: trainer.run_step(batch))
    model = trainer.model
    images = torch.from_numpy(_synthetic_seg(
        ran.replace(device_augment=False), P14_SEG_BATCH, seed=20)[0]).cuda()
    gflop = conv_gflop(model, lambda: model.eval()(images[:1]))
    bound_ms = 3 * gflop * 1e9 * P14_SEG_BATCH / PEAK_FLOPS[
        torch.bfloat16] * 1e3
    phase(f"14a {name} train step alone on a staged batch (augment, SGD, "
          f"EMA): {alone_ms:.3f} ms (CUDA events, median of 3 after 1); "
          f"{kernels} kernels, {busy:.3f} ms device busy (device idle "
          f"{100 * max(0.0, 1 - busy / alone_ms):.1f}%); conv bound "
          f"{bound_ms:.3f} ms (3x the forward's {gflop:.2f} GFLOP an image "
          f"at the bf16 peak)")

    cfg = ran.replace(dtype="float32", device_augment=False)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               image_size=P14_F64_SIZE))
    rs = np.random.RandomState(21)
    two = (rs.uniform(-1, 1, (2, P14_F64_SIZE, P14_F64_SIZE, 3)).astype(
        np.float32), rs.randint(0, cfg.data.num_classes, (
            2, P14_F64_SIZE, P14_F64_SIZE)).astype(np.int32))
    step_err = check_step_against_f64(
        cfg, build_model(cfg), two, f"14a {name}",
        f"2 images at {P14_F64_SIZE} px",
        make_step=lambda dt: make_segmentation_train_step(compute_dtype=dt))

    predict = make_segmentation_predict_step(compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    predict_ms, masks = event_ms(lambda: predict(trainer.state, images))
    predict_peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        p_kernels, p_busy = device_profile(
            lambda: predict(trainer.state, images))
    p_bound = gflop * 1e9 * P14_SEG_BATCH / PEAK_FLOPS[torch.bfloat16] * 1e3
    phase(f"14a predict step ({name}, batch {P14_SEG_BATCH}, "
          f"{P14_SEG_SIZE} px, bf16, EMA weights, argmax to int32): "
          f"{predict_ms:.3f} ms (CUDA events, median of {PREDICT_ITERS} "
          f"after {PREDICT_WARMUP}); {p_kernels} kernels, {p_busy:.3f} ms "
          f"device busy; bound {p_bound:.3f} ms; peak_memory_allocated="
          f"{predict_peak / 2**30:.3f} GiB")
    if tuple(masks.shape) != (P14_SEG_BATCH, P14_SEG_SIZE, P14_SEG_SIZE) \
            or masks.dtype != torch.int32 or not bool(
                ((masks >= 0) & (masks < ran.data.num_classes)).all()):
        raise AssertionError(f"predict gave {masks.dtype} {masks.shape}")
    trainer.close()
    return {"workdir": workdir, "config": ran, "step_ms": step_ms,
            "alone_ms": alone_ms, "kernels": kernels, "busy_ms": busy,
            "bound_ms": bound_ms, "peak_bytes": peak, "params": params,
            "losses": steps, "val": result, "step_err": step_err,
            "predict_ms": predict_ms, "predict_kernels": p_kernels,
            "predict_busy_ms": p_busy, "predict_bound_ms": p_bound,
            "predict_peak_bytes": predict_peak}


def mask_agreement(served: np.ndarray, logits: torch.Tensor,
                   gap: float) -> tuple:
    """(pixels where `served` differs from the argmax of `logits`, those
    of them whose top two logits lie within `gap`, all pixels that
    close)."""
    want = logits.argmax(dim=-1).cpu().numpy()
    top2 = logits.float().topk(2, dim=-1).values
    close = ((top2[..., 0] - top2[..., 1]) <= gap).cpu().numpy()
    differ = served != want
    return int(differ.sum()), int((differ & close).sum()), int(close.sum())


def check_restored_serving(seg: dict, yolo: dict) -> dict:
    """14b, S1: unet_resnet50 served by `serve.cli.build_server` from 14a's
    workdir at buckets {1, 8}: the provenance, the masks against the
    trainer's predict step on the same restored EMA weights, the answer's
    bytes and `measure_batch_ms`; yolov3 restored from phase 5's workdir
    against an engine on the trainer's restored state_dict."""
    name, cfg = P14_SEG_MODEL, seg["config"]
    args = build_parser().parse_args(
        ["-m", name, "--workdir", seg["workdir"], "--device", "cuda",
         "--buckets", ",".join(map(str, P14_SERVE_BUCKETS)),
         "--flush-every", "60"])
    t0 = time.perf_counter()
    server = build_server(args)
    engine = server.engine
    built = time.perf_counter() - t0
    prov = engine.provenance
    trainer = SegmentationTrainer(cfg, device="cuda",
                                  workdir=seg["workdir"])
    trainer.init_state()
    if trainer.resume() != 1 or trainer.state.ema is None:
        raise AssertionError("14a's EMA checkpoint did not restore")
    rs = np.random.RandomState(22)
    differ = near = close = pixels = 0
    logit_diff = 0.0
    predict = make_segmentation_predict_step(compute_dtype=torch.bfloat16)
    model = trainer.model
    for n in (1, 3, 8):
        x = _synthetic_seg(cfg.replace(device_augment=False), n,
                           seed=int(rs.randint(1 << 30)))[0]
        served = server.fleet.get(name).submit(x).result(timeout=120)
        images = torch.from_numpy(x).cuda()
        step = predict(trainer.state, images)
        padded = np.pad(x, [(0, pick_bucket(n, engine.buckets) - n)]
                        + [(0, 0)] * 3)
        with trainer.state.ema_weights(), torch.inference_mode():
            logits = model.eval()(images.to(torch.bfloat16))
            served_logits = engine.model(torch.from_numpy(padded).cuda().to(
                engine.compute_dtype))[:n]
        if served.shape != (n, P14_SEG_SIZE, P14_SEG_SIZE) \
                or served.dtype != np.int32:
            raise AssertionError(f"served {served.dtype} {served.shape}")
        if not torch.equal(step, logits.argmax(dim=-1).to(torch.int32)):
            raise AssertionError("the predict step's masks are not the "
                                 "argmax of the EMA weights' logits")
        diff = float((served_logits - logits).abs().max())
        logit_diff = max(logit_diff, diff)
        d, nr, c = mask_agreement(served, logits, 2 * diff)
        differ, near, close = differ + d, near + nr, close + c
        pixels += served.size
    one = server.fleet.get(name).submit(x[:1]).result(timeout=120)
    answer_bytes = len(json.dumps(one.tolist()))
    batch_ms = {b: engine.measure_batch_ms(b, 10) for b in engine.buckets}
    server.close()
    trainer.close()
    phase(f"14b {name} served by build_server --workdir (built and warmed "
          f"in {built:.1f}s): provenance {prov}; served masks vs the "
          f"predict step on the restored EMA weights over {pixels} pixels: "
          f"{differ} differ, {near} of them with the step's top two logits "
          f"within twice the served logits' largest difference from the "
          f"step's ({logit_diff:.3g}; {close} pixels that close in all); "
          f"one "
          f"answer {one.nbytes} bytes int32, {answer_bytes} bytes as JSON; "
          f"measure_batch_ms " + " ".join(
              f"bucket {b}: {ms:.3f}" for b, ms in batch_ms.items()))
    if prov.get("weights") != "checkpoint" or prov.get(
            "checkpoint_epoch") != 1:
        raise AssertionError(f"{name} served {prov}")
    if differ != near:
        raise AssertionError(f"{differ - near} served pixels differ from "
                             f"the predict step beyond the logit gap")

    y_cfg = yolo["config"]
    engine = PredictEngine.from_config(YOLO_MODEL, device="cuda",
                                       buckets=(1,), workdir=yolo["workdir"],
                                       verbose=False)
    trainer = DetectionTrainer(y_cfg, device="cuda", workdir=yolo["workdir"])
    trainer.init_state()
    if trainer.resume() != 1:
        raise AssertionError("phase 5's checkpoint did not restore")
    ref = PredictEngine.from_config(
        YOLO_MODEL, device="cuda", buckets=(1,),
        state_dict=trainer.model.state_dict(), verbose=False)
    trainer.close()
    x = np.random.RandomState(23).rand(2, *engine.example_shape).astype(
        np.float32)
    got, want = engine.predict(x), ref.predict(x)
    equal = all(np.allclose(g, w, rtol=P14_RESTORE_RTOL, atol=0,
                            equal_nan=True)
                for g, w in zip(_leaves(got), _leaves(want)))
    phase(f"14b {YOLO_MODEL} restored from phase 5's workdir: provenance "
          f"{engine.provenance}; answers vs an engine on the trainer's "
          f"restored state_dict equal={equal} (rtol {P14_RESTORE_RTOL:g}, "
          f"NaN equal to NaN: phase 5's weights overflow)")
    if engine.provenance.get("weights") != "checkpoint" or not equal:
        raise AssertionError("yolov3 restored answers differ")
    return {"provenance": prov, "differ": differ, "near": near,
            "close": close, "pixels": pixels, "logit_diff": logit_diff,
            "batch_ms": batch_ms,
            "answer_bytes": answer_bytes, "mask_bytes": one.nbytes}


def _gan_state(model, device, dtype):
    """A TrainState of an f64 or f32 copy of `model` on `device`, with an
    Adam of the GAN configs' shape (the update is not compared)."""
    m = (float64_copy(model) if dtype == torch.float64
         else copy.deepcopy(model)).to(device)
    return TrainState(m, build_optimizer(
        m.parameters(), get_config("dcgan").optimizer,
        get_config("dcgan").schedule, 1, 1))


def _f64_inputs(arrays, device, dtype):
    return [torch.from_numpy(a).to(device, dtype) for a in arrays]


def gan_step_diffs(got: tuple, ref: tuple) -> dict:
    """Errors of one GAN step's `(losses, states)` against the reference's:
    losses relative, gradients over the largest of each network that the
    step differentiated, BatchNorm
    running statistics over their largest (0 without BatchNorm)."""
    (losses, states), (ref_losses, ref_states) = got, ref
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-30)
                   for k, v in ref_losses.items())
    grad_err = stat_err = 0.0
    for st, rst in zip(states, ref_states):
        want = {n: p.grad.cpu() for n, p in rst.model.named_parameters()
                if p.grad is not None}
        if want:
            grads = {n: p.grad.cpu() for n, p in st.model.named_parameters()}
            grad_err = max(grad_err, grad_rel(grads, want)[0])
        stats = {k: v.cpu() for k, v in rst.model.state_dict().items()
                 if "running" in k}
        if stats:
            top = max(v.abs().max().item() for v in stats.values())
            have = st.model.state_dict()
            stat_err = max(stat_err, max(
                (have[k].cpu() - v).abs().max().item()
                for k, v in stats.items()) / top)
    return {"loss": loss_err, "grad": grad_err, "stats": stat_err}


def gan_step_errors(run, what: str) -> dict:
    """`run(device, dtype) -> (losses, states)` on the card in f64 against
    the CPU in f64 (`gan_step_diffs`); fails past the ZOO_F64_* bounds."""
    ref = run(torch.device("cpu"), torch.float64)
    err = gan_step_diffs(run(torch.device("cuda"), torch.float64), ref)
    phase(f"{what} on the card in f64 vs the CPU in f64: losses "
          f"{err['loss']:.3g} (bound {ZOO_F64_LOSS_RTOL:g}), gradients "
          f"{err['grad']:.3g} (bound {ZOO_F64_GRAD_RTOL:g}), BatchNorm "
          f"statistics {err['stats']:.3g} (bound {ZOO_F64_GRAD_RTOL:g})")
    if not (all(np.isfinite(v) for v in ref[0].values())
            and err["loss"] <= ZOO_F64_LOSS_RTOL
            and err["grad"] <= ZOO_F64_GRAD_RTOL
            and err["stats"] <= ZOO_F64_GRAD_RTOL):
        raise AssertionError(f"{what}: the card's f64 step is off the "
                             f"CPU's")
    return err


def dcgan_step_run(seed: int = 25):
    """`run(device, dtype)`: one DCGAN step on 2 seeded images with given
    noise, dropout off, on copies of seeded networks -> (losses, (gen
    state, disc state))."""
    rs = np.random.RandomState(seed)
    real, noise = rs.uniform(-1, 1, (2, 28, 28, 1)), rs.randn(2, 100)
    gen = DCGANGenerator(generator=torch.Generator().manual_seed(seed))
    disc = no_dropout(DCGANDiscriminator(
        generator=torch.Generator().manual_seed(seed + 1)))
    step = make_dcgan_train_step(100)

    def run(device, dtype):
        g, d = _gan_state(gen, device, dtype), _gan_state(disc, device, dtype)
        x, z = _f64_inputs((real, noise), device, dtype)
        out = step(g, d, x, z)
        return {k: float(v) for k, v in out.items()}, (g, d)

    return run


def cyclegan_step_runs(size: int, blocks: int, seed: int = 27):
    """(`run_gen`, `run_disc`), each `run(device, dtype)`: one generator
    phase on 2 seeded (a, b) pairs at `size` px (-> losses, (generators,
    discriminators): their BatchNorm statistics advanced in it), and one
    discriminator phase on seeded reals and fakes (-> losses,
    (discriminators,)), on copies of seeded networks."""
    rs = np.random.RandomState(seed)
    shape = (2, size, size, 3)
    arrays = [rs.uniform(-1, 1, shape) for _ in range(4)]
    init = torch.Generator().manual_seed(seed)
    gens = torch.nn.ModuleDict({k: CycleGANGenerator(blocks, generator=init)
                                for k in ("a2b", "b2a")})
    discs = torch.nn.ModuleDict({k: PatchGANDiscriminator(generator=init)
                                 for k in ("a", "b")})
    gen_step = make_cyclegan_generator_step()
    disc_step = make_cyclegan_discriminator_step()

    def run_gen(device, dtype):
        g, d = _gan_state(gens, device, dtype), _gan_state(discs, device,
                                                           dtype)
        out, _, _ = gen_step(g, d, *_f64_inputs(arrays[:2], device, dtype))
        return {k: float(v) for k, v in out.items()}, (g, d)

    def run_disc(device, dtype):
        d = _gan_state(discs, device, dtype)
        out = disc_step(d, *_f64_inputs(arrays, device, dtype))
        return {k: float(v) for k, v in out.items()}, (d,)

    return run_gen, run_disc


def gan_round_trip(trainer, fresh) -> bool:
    """Whether `fresh`, resumed from `trainer`'s epoch-1 checkpoint, holds
    both networks, both optimizers and both step counts exactly."""
    if fresh.resume() != 1:
        raise AssertionError("the epoch-1 checkpoint did not restore")
    return same_tree(trainer._payload(), fresh._payload())


def check_dcgan() -> dict:
    """14c: dcgan at the config's batch of 256, 28 px, f32: 3 synthetic
    steps, a checkpoint round trip of both networks and optimizers, 16
    samples, the step alone, one f64 step (dropout off, the same noise) on
    the card against the CPU."""
    cfg = get_config("dcgan")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dcgan_")
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer = DCGANTrainer(cfg.replace(total_epochs=1), workdir=workdir,
                               device="cuda")
        metrics = trainer.fit(lambda epoch: synthetic_mnist_batches(
            P14_DCGAN_BATCH, steps=P14_DCGAN_STEPS, seed=epoch))
        peak = torch.cuda.max_memory_allocated()
        steps = trainer.last_epoch_steps
        for i, s in enumerate(steps):
            phase(f"14c dcgan step {i + 1}: " + " ".join(
                f"{k}={v:.4f}" for k, v in s.items()))
        if len(steps) != P14_DCGAN_STEPS or not all(
                np.isfinite(v) for s in steps for v in s.values()):
            raise AssertionError(f"dcgan steps not all finite: {steps}")
        fresh = DCGANTrainer(cfg, workdir=workdir, device="cuda")
        equal = gan_round_trip(trainer, fresh)
        fresh.close()
        samples = trainer.generate(P14_DCGAN_SAMPLES)
        grid = tile_grid(samples)
        images = torch.from_numpy(next(synthetic_mnist_batches(
            P14_DCGAN_BATCH, steps=1, seed=24))).cuda()
        alone_ms, _ = event_ms(lambda: trainer.train_step(
            trainer.gen_state, trainer.disc_state, images), warmup=1,
            iters=3)
        kernels, busy = device_profile(lambda: trainer.train_step(
            trainer.gen_state, trainer.disc_state, images))
        trainer.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase(f"14c dcgan (batch {P14_DCGAN_BATCH}, 28 px, f32, two Adams): "
          f"mean losses {metrics}; checkpoint round trip (generator, "
          f"discriminator, both Adams, both steps) equal={equal}; "
          f"{P14_DCGAN_SAMPLES} samples {samples.shape} in "
          f"[{samples.min():.3f}, {samples.max():.3f}], grid {grid.shape}; "
          f"step alone {alone_ms:.3f} ms (CUDA events, median of 3 after "
          f"1), {kernels} kernels, {busy:.3f} ms device busy; "
          f"peak_memory_allocated={peak / 2**30:.3f} GiB")
    if not equal:
        raise AssertionError("the restored DCGAN differs from the trained")
    if samples.shape != (P14_DCGAN_SAMPLES, 28, 28, 1) or not (
            np.isfinite(samples).all() and np.abs(samples).max() <= 1.0):
        raise AssertionError(f"dcgan samples {samples.shape}")

    err = gan_step_errors(dcgan_step_run(), "14c dcgan one step, 2 images, dropout off, "
                               "the same noise,")
    return {"losses": steps, "alone_ms": alone_ms, "kernels": kernels,
            "busy_ms": busy, "peak_bytes": peak, "step_err": err}


def check_cyclegan() -> dict:
    """14d: cyclegan at 256 px, the config's batch of 8, f32, 9 blocks: 2
    synthetic steps of both phases through the ImagePools, a checkpoint
    round trip, a batch translated both ways, the step alone; one f64 step
    of each phase at 64 px on the card against the CPU (the
    discriminators' BatchNorm statistics after the generator phase
    included). The run dir stays until the script ends: phase 21 converts
    its a2b generator."""
    cfg = get_config("cyclegan")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cyclegan_")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    trainer = CycleGANTrainer(cfg.replace(total_epochs=1),
                              workdir=workdir, device="cuda",
                              n_blocks=P14_CG_BLOCKS,
                              steps_per_epoch=P14_CG_STEPS)
    metrics = trainer.fit(lambda epoch: synthetic_two_domain_batches(
        P14_CG_BATCH, image_size=P14_CG_SIZE, steps=P14_CG_STEPS,
        seed=epoch))
    peak = torch.cuda.max_memory_allocated()
    steps = trainer.last_epoch_steps
    for i, s in enumerate(steps):
        phase(f"14d cyclegan step {i + 1}: " + " ".join(
            f"{k}={v:.4f}" for k, v in s.items()))
    if len(steps) != P14_CG_STEPS or not all(
            np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"cyclegan steps not all finite: {steps}")
    fresh = CycleGANTrainer(cfg, workdir=workdir, device="cuda",
                            n_blocks=P14_CG_BLOCKS)
    equal = gan_round_trip(trainer, fresh)
    fresh.close()
    a, b = next(synthetic_two_domain_batches(
        P14_CG_BATCH, image_size=P14_CG_SIZE, steps=1, seed=26))
    translated = [trainer.translate(x, d) for x, d in ((a, "a2b"),
                                                       (b, "b2a"))]
    alone_ms, _ = event_ms(lambda: trainer.train_batch(a, b), warmup=1,
                           iters=3)
    kernels, busy = device_profile(lambda: trainer.train_batch(a, b))
    one = torch.from_numpy(a[:1]).cuda()
    gen, disc = trainer.generators["a2b"], trainer.discriminators["a"]
    gflop = conv_gflop(gen, lambda: gen.eval()(one))
    d_gflop = conv_gflop(disc, lambda: disc.eval()(one))
    trainer.close()
    # a step's convs, per image: 6 generator passes and 6 discriminator
    # passes (2 in the generator phase, 4 in the discriminator phase), each
    # a forward and a backward of twice its FLOPs
    bound_ms = 3 * 6 * (gflop + d_gflop) * 1e9 * P14_CG_BATCH / PEAK_FLOPS[
        torch.float32] * 1e3
    phase(f"14d cyclegan ({P14_CG_SIZE} px, batch {P14_CG_BATCH}, f32, "
          f"{P14_CG_BLOCKS} blocks): mean losses {metrics}; checkpoint round "
          f"trip (both generators, both discriminators, both Adams) "
          f"equal={equal}; translated a2b {translated[0].shape} and b2a "
          f"{translated[1].shape}; step alone (generator phase, pools, "
          f"discriminator phase) {alone_ms:.3f} ms (CUDA events, median of "
          f"3 after 1), {kernels} kernels, {busy:.3f} ms device busy (idle "
          f"{100 * max(0.0, 1 - busy / alone_ms):.1f}%); conv bound "
          f"{bound_ms:.3f} ms (6 x 3 passes of the generator's {gflop:.2f} "
          f"and the discriminator's {d_gflop:.2f} GFLOP an image at the "
          f"f32 peak); peak_memory_allocated="
          f"{peak / 2**30:.3f} GiB")
    if not equal:
        raise AssertionError("the restored CycleGAN differs from the "
                             "trained")
    for t in translated:
        if t.shape != a.shape or not (np.isfinite(t).all()
                                      and np.abs(t).max() <= 1.0):
            raise AssertionError(f"translated {t.shape}")

    run_gen, run_disc = cyclegan_step_runs(P14_F64_SIZE, P14_CG_BLOCKS)
    gen_err = gan_step_errors(run_gen, f"14d cyclegan generator phase (the "
                                       f"discriminators' statistics "
                                       f"included), 2 images at "
                                       f"{P14_F64_SIZE} px,")
    disc_err = gan_step_errors(run_disc, f"14d cyclegan discriminator "
                                         f"phase, 2 images at "
                                         f"{P14_F64_SIZE} px,")
    return {"losses": steps, "alone_ms": alone_ms, "kernels": kernels,
            "busy_ms": busy, "bound_ms": bound_ms, "peak_bytes": peak,
            "step_err": {"gen": gen_err, "disc": disc_err},
            "workdir": workdir}


def check_segmentation_and_gans(yolo: dict) -> dict:
    """Phase 14, slice 11: U-Net segmentation trained, evaluated and
    predicted at full width (14a), served from its checkpoint and yolov3
    restored from phase 5's (14b), DCGAN (14c) and CycleGAN (14d). No TPU
    kernel is on these paths: the K1 and K2 counts, zeroed at the start of
    each sub-phase, must read 0 at its end."""
    t0 = time.perf_counter()
    out = {}
    for tag, run in (("14a", check_segmentation_training),
                     ("14b", lambda: check_restored_serving(out["14a"],
                                                            yolo)),
                     ("14c", check_dcgan), ("14d", check_cyclegan)):
        flash_attention.launches = best_iou.launches = 0
        t1 = time.perf_counter()
        out[tag] = run()
        counts = (flash_attention.launches, best_iou.launches)
        phase(f"{tag}: launches (flash_attention, best_iou): {counts}; "
              f"{time.perf_counter() - t1:.1f}s")
        if counts != (0, 0):
            raise AssertionError(f"a kernel ran on the phase {tag} path: "
                                 f"{counts}")
        torch.cuda.empty_cache()
    phase(f"14: phase 14 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 15: resilient training ---------------------------------------------

P15_SIZE = 416
P15_BATCH = 16
P15_STEPS = 3                  # per epoch
P15_EPOCHS = 2
P15_EVAL_BATCHES = 2           # the synthetic validation set
# the NaN fault (DEEPVISION_FAULT_NAN_STEP, 0-based over the run): epoch
# 2's second batch
P15_NAN_STEP = P15_STEPS + 1
# the config's lr 0.01 takes yolov3 from random weights to a non-finite
# loss by itself (ROADMAP Queue C): at 1e-3 only the injected fault makes
# a step non-finite
P15_LR = "1e-3"
P15_DEVICE = "cuda"
P15_TIMED_STEPS = 10           # step_ms with no write in flight
P15_MAX_WRITE_STEPS = 60       # steps timed while a write is in flight
P15_WATCHDOG_SECS = 5.0
P15_TIMEOUT = 600              # a subprocess of 15c
FAULT_VARS = ("DEEPVISION_FAULT_DATA_IO_STEP", "DEEPVISION_FAULT_NAN_STEP",
              "DEEPVISION_FAULT_CKPT_SAVE_FAILS",
              "DEEPVISION_FAULT_CKPT_ASYNC_FAILS",
              "DEEPVISION_FAULT_CKPT_CORRUPT")


def p15_argv(workdir: str, epochs: int, *extra) -> list:
    """YOLO/torch/train.py's arguments of phase 15: the model at full
    width, P15_SIZE px, batch P15_BATCH, synthetic, bf16."""
    return ["-m", YOLO_MODEL, "--synthetic", "--image-size", str(P15_SIZE),
            "--batch-size", str(P15_BATCH), "--steps-per-epoch",
            str(P15_STEPS), "--epochs", str(epochs), "--learning-rate",
            P15_LR, "--device", P15_DEVICE, "--workdir", workdir, *extra]


def p15_cmd(workdir: str, epochs: int, *extra) -> list:
    return [sys.executable, os.path.join(HERE, "YOLO", "torch", "train.py"),
            *p15_argv(workdir, epochs, *extra)]


def p15_env() -> dict:
    return {k: v for k, v in os.environ.items() if k not in FAULT_VARS}


def p15_workdir(tag: str) -> str:
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_p15{tag}_")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    return workdir


def verified_epochs(ckpt: str) -> list:
    """The committed epochs of `ckpt` whose files verify."""
    return [e for e in integrity.committed_epochs(ckpt)
            if integrity.verify_files(os.path.join(ckpt, str(e)))[0]
            == integrity.OK]


def flip_a_bit(step_dir: str) -> str:
    """Bit rot in the middle of an epoch's largest payload file."""
    target = max((os.path.join(r, f) for r, _, fs in os.walk(step_dir)
                  for f in fs if f != integrity.MANIFEST_NAME),
                 key=os.path.getsize)
    with open(target, "r+b") as fp:
        fp.seek(os.path.getsize(target) // 2)
        byte = fp.read(1)
        fp.seek(-1, 1)
        fp.write(bytes([byte[0] ^ 0x80]))
    return os.path.relpath(target, step_dir)


def fsck(path: str, *flags) -> tuple:
    """`python -m deepvision_tpu_torch fsck <path> --format json` in-process
    (its `fsck_summary`): (exit code, its summary)."""
    from deepvision_tpu_torch.__main__ import fsck_summary
    return fsck_summary(path, quarantine="--quarantine" in flags)


def check_p15_divergence() -> dict:
    """15a: YOLO/torch/train.py's `cli.run_detection` for P15_EPOCHS
    epochs with `--recover-on-divergence 1` and the NaN fault at epoch 2's
    second batch: epoch 2 rolls back to epoch 1 and trains again at LR
    scale plateau x 0.5, then commits. K2 launches once per train step
    (the diverged and the retried epoch's included) and per eval batch."""
    workdir = p15_workdir("a")
    os.environ["DEEPVISION_FAULT_NAN_STEP"] = str(P15_NAN_STEP)
    os.environ["DEEPVISION_IO_RETRY_DELAY"] = "0.01"
    flash_attention.launches = best_iou.launches = 0
    t0 = time.perf_counter()
    try:
        trainer, result = run_detection("YOLO", [YOLO_MODEL], p15_argv(
            workdir, P15_EPOCHS, "--recover-on-divergence", "1"))
    finally:
        for var in ("DEEPVISION_FAULT_NAN_STEP", "DEEPVISION_IO_RETRY_DELAY"):
            os.environ.pop(var, None)
    wall = time.perf_counter() - t0
    launches = (flash_attention.launches, best_iou.launches)
    hist = trainer.logger.history
    events = {k: v["value"] for k, v in hist.items()
              if k.startswith("resilience_")}
    epochs = hist["epoch_train_loss"]["epochs"]
    losses = hist["epoch_train_loss"]["value"]
    train_steps = P15_STEPS * (P15_EPOCHS + 1)
    eval_batches = P15_EVAL_BATCHES * P15_EPOCHS
    ckpt = os.path.join(workdir, "ckpt")
    scale = trainer.state.optimizer.lr_scale
    plateau = trainer.plateau.scale if trainer.plateau else 1.0
    save = {"block_ms": 1e3 * trainer.ckpt.last_save_block_secs,
            **trainer.ckpt.last_commit}
    phase(f"15a {YOLO_MODEL} ({P15_SIZE} px, batch {P15_BATCH}, "
          f"{trainer.config.dtype}, lr {P15_LR}) with the NaN fault at "
          f"batch {P15_NAN_STEP} and --recover-on-divergence 1: events "
          f"{events}; epochs logged {epochs} with mean train loss {losses}; "
          f"final step {trainer.state.step}, LR scale {scale:g} (plateau "
          f"{plateau:g}); verified epochs {verified_epochs(ckpt)}; "
          f"launches (flash_attention, best_iou) {launches} for "
          f"{train_steps} train steps and {eval_batches} eval batches; "
          f"run_detection {wall:.1f}s")
    phase(f"15a checkpoint of epoch {save['epoch']}: save() blocked "
          f"{save['block_ms']:.1f} ms (the host snapshot), the writer "
          f"wrote in {save['write_secs']:.3f}s and hashed in "
          f"{save['hash_secs']:.3f}s, {save['bytes']} bytes")
    if events.get("resilience_divergence_recoveries") != [1.0] \
            or events.get("resilience_lr_scale") != [0.5]:
        raise AssertionError(f"15a: no single rollback at scale 0.5: "
                             f"{events}")
    if epochs != [1, 2, 2] or not (np.isfinite(losses[0])
                                   and np.isnan(losses[1])
                                   and np.isfinite(losses[2])):
        raise AssertionError(f"15a: epochs {epochs}, losses {losses}")
    if trainer.state.step != P15_STEPS * P15_EPOCHS \
            or scale != plateau * 0.5:
        raise AssertionError(f"15a: step {trainer.state.step}, LR scale "
                             f"{scale}")
    if launches != (0, train_steps + eval_batches):
        raise AssertionError(f"15a: launches {launches}, want (0, "
                             f"{train_steps + eval_batches})")
    if verified_epochs(ckpt) != [1, 2] or not np.isfinite(
            result.get("loss", np.nan)):
        raise AssertionError(f"15a: committed {verified_epochs(ckpt)}, "
                             f"validation {result}")
    return {"trainer": trainer, "config": trainer.config,
            "workdir": workdir, "launches": launches[1],
            "train_steps": train_steps, "eval_batches": eval_batches,
            "events": events, "save": save}


def start_p15_save_overlap(trainer) -> dict:
    """15a's save overlap, its first half: a manager of its own saves the
    trained state once, allocating its pinned buffers (the blocking time
    is the allocation's); its writer writes and hashes in the background
    while the phase goes on."""
    root = tempfile.mkdtemp(prefix="chip_smoke_p15_save_")
    mgr = CheckpointManager(root, keep=1, keep_best=False)
    t0 = time.perf_counter()
    mgr.save(1, trainer.state.state_dict())
    return {"root": root, "mgr": mgr, "t0": t0,
            "block_ms": 1e3 * (time.perf_counter() - t0)}


def check_p15_save_overlap(trainer, started: dict) -> dict:
    """15a, the async save against the step loop, alone on the card:
    step_ms (host clock around each step and a synchronize) with no write
    in flight, then a second save of the trained state (the pinned
    buffers reused) and the steps run while its writer writes and hashes,
    then again with none."""
    mgr = started["mgr"]
    mgr.flush()
    saves = [{"block_ms": started["block_ms"],
              "save_to_commit_s": time.perf_counter() - started["t0"],
              **mgr.last_commit}]
    batch = trainer._to_device(next(synthetic_batches(
        batch_size=P15_BATCH, image_size=P15_SIZE,
        num_classes=trainer.config.data.num_classes, steps=1, seed=11)))

    def step_ms() -> float:
        t = time.perf_counter()
        trainer.run_step(batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    for _ in range(2):
        step_ms()
    alone = [step_ms() for _ in range(P15_TIMED_STEPS)]
    during: list = []
    t0 = time.perf_counter()
    mgr.save(2, trainer.state.state_dict())
    block = time.perf_counter() - t0
    while mgr.writing and len(during) < P15_MAX_WRITE_STEPS:
        during.append(step_ms())
    still = mgr.writing
    mgr.flush()
    saves.append({"block_ms": 1e3 * block,
                  "save_to_commit_s": time.perf_counter() - t0,
                  **mgr.last_commit})
    mgr.close()
    shutil.rmtree(started["root"], ignore_errors=True)
    after = [step_ms() for _ in range(P15_TIMED_STEPS)]
    out = {"alone_ms": statistics.median(alone),
           "during_ms": statistics.median(during) if during else None,
           "after_ms": statistics.median(after), "during_steps": len(during),
           "write_outlasted_steps": still, "saves": saves}
    phase(f"15a async save of the trained state: first save blocked "
          f"{saves[0]['block_ms']:.1f} ms (pinned buffers allocated; made "
          f"after 15a, its write beside 15b), the second "
          f"{saves[1]['block_ms']:.1f} ms (reused); writer "
          f"{saves[1]['write_secs']:.3f}s write + "
          f"{saves[1]['hash_secs']:.3f}s hash of {saves[1]['bytes']} bytes; "
          f"step_ms median {out['alone_ms']:.3f} with no write, "
          + (f"{out['during_ms']:.3f}" if during else "n/a")
          + f" over {len(during)} steps while the write was in flight "
          f"(still writing after them: {still}), {out['after_ms']:.3f} "
          f"after")
    if not during:
        raise AssertionError("15a: the write ended before a step ran")
    return out


def zeroed_copy(model):
    """`model`'s architecture with every parameter and buffer zero: a
    trainer built on it restores every value from disk, and skips a
    second random init of the model on the host."""
    blank = copy.deepcopy(model)
    with torch.no_grad():
        for t in list(blank.parameters()) + list(blank.buffers()):
            t.zero_()
    return blank


def check_p15_integrity(a: dict, model) -> dict:
    """15b: a verified restore timed; the newest epoch bit-flipped; strict
    mode raises and quarantines nothing; fsck exits 1, 1 with
    --quarantine, then 0; fallback on a copy of the damaged directory
    quarantines corrupt-2/ and lands on epoch 1. Each trainer takes a
    zeroed copy of 15a's `model`."""
    cfg, workdir = a["config"], a["workdir"]
    ckpt = os.path.join(workdir, "ckpt")

    def trainer_on(wd):
        t = DetectionTrainer(cfg, device=P15_DEVICE, workdir=wd,
                             model=zeroed_copy(model))
        t.init_state()
        return t

    t = trainer_on(workdir)
    t0 = time.perf_counter()
    got = t.resume()
    restore_s = time.perf_counter() - t0
    info = t.ckpt.last_restore_info
    t.close()
    total = integrity.load_manifest(os.path.join(ckpt, "2"))["total_bytes"]
    rc_clean, _ = fsck(workdir)
    flipped = flip_a_bit(os.path.join(ckpt, "2"))
    copy = p15_workdir("b")
    shutil.copytree(ckpt, os.path.join(copy, "ckpt"))
    t = trainer_on(workdir)
    try:
        t.resume(verify="strict")
        strict = "restored"
    except CheckpointCorruptionError as e:
        strict = f"refused: {str(e)[:120]}"
    t.close()
    untouched = os.path.isdir(os.path.join(ckpt, "2")) and not \
        integrity.quarantined_dirs(ckpt)
    rcs = [rc_clean]
    summaries = []
    for flags in ((), ("--quarantine",), ()):
        rc, summary = fsck(workdir, *flags)
        rcs.append(rc)
        summaries.append({k: summary[k] for k in ("fsck", "corrupt",
                                                  "quarantined")})
    t = trainer_on(copy)
    fell_back = t.resume()
    fb_info = t.ckpt.last_restore_info
    t.close()
    quarantined = integrity.quarantined_dirs(os.path.join(copy, "ckpt"))
    phase(f"15b restore of epoch {got} with its verify (file hashes, "
          f"torch.load, leaf hashes) of {total} bytes: {restore_s:.3f}s "
          f"(verified={info['verified']}); bit flipped in epoch 2's "
          f"{flipped}: strict {strict}; fsck exit codes (clean, damaged, "
          f"--quarantine, again) {rcs} {summaries}; fallback on a copy "
          f"landed on epoch {fell_back} (skipped "
          f"{fb_info['fallback_skipped']}, quarantined {quarantined})")
    if got != 2 or not info["verified"]:
        raise AssertionError(f"15b: restored {got}, {info}")
    if not strict.startswith("refused") or not untouched:
        raise AssertionError(f"15b: strict {strict}, untouched {untouched}")
    if rcs != [0, 1, 1, 0] or integrity.quarantined_dirs(ckpt) != [
            "corrupt-2"]:
        raise AssertionError(f"15b: fsck {rcs}, quarantined "
                             f"{integrity.quarantined_dirs(ckpt)}")
    if fell_back != 1 or quarantined != ["corrupt-2"] \
            or fb_info["fallback_skipped"] != 1:
        raise AssertionError(f"15b: fallback {fell_back} {fb_info}")
    torch.cuda.empty_cache()
    return {"restore_s": restore_s, "restore_bytes": total,
            "fsck": rcs, "copy": copy}


def _echo_lines(proc, lines: list, seen: threading.Event,
                pattern: str) -> None:
    for line in proc.stdout:
        lines.append(line)
        if re.search(pattern, line):
            seen.set()


def check_p15_preemption() -> dict:
    """15c: two runs of YOLO/torch/train.py as subprocesses on the card, at
    once. The first gets SIGTERM after its first step line: exit 0 with a
    verified epoch committed, then `--auto-resume` finishes the run. The
    second gets SIGKILL while a save is in flight (its temporary directory
    on disk, two epochs committed): its resume lands on the newest epoch
    that verifies. Both relaunches run at once too."""
    wd_term = p15_workdir("c")
    wd_kill = p15_workdir("c2")
    ckpt_term = os.path.join(wd_term, "ckpt")
    ckpt_kill = os.path.join(wd_kill, "ckpt")
    env = p15_env()
    t0 = time.perf_counter()
    term = subprocess.Popen(p15_cmd(wd_term, 1000, "--auto-resume"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=HERE)
    kill = subprocess.Popen(p15_cmd(wd_kill, 1000, "--auto-resume"),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=env, cwd=HERE)
    lines: list = []
    seen = threading.Event()
    reader = threading.Thread(target=_echo_lines, daemon=True,
                              args=(term, lines, seen, r"epoch \d+ step \d+"))
    reader.start()
    in_flight: list = []
    again: list = []
    epoch = None
    at: dict = {}               # seconds after the two starts

    def relaunch(workdir: str, epochs: int):
        return subprocess.Popen(p15_cmd(workdir, epochs, "--auto-resume"),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=HERE)

    try:
        deadline = time.monotonic() + P15_TIMEOUT
        while term.poll() is None or kill.poll() is None:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"15c: no step line or no save in flight within "
                    f"{P15_TIMEOUT}s: " + "".join(lines[-20:]))
            if seen.is_set() and term.poll() is None:
                at["SIGTERM"] = time.perf_counter() - t0
                term.send_signal(signal.SIGTERM)
                term.wait(timeout=P15_TIMEOUT)
                # its relaunch starts at once, beside the other run
                reader.join(timeout=60)
                out = "".join(lines)
                m = re.search(r"graceful preemption: checkpoint committed "
                              r"at epoch (\d+)", out)
                if term.returncode != 0 or not m:
                    raise AssertionError(f"15c: SIGTERM exit "
                                         f"{term.returncode}: {out[-3000:]}")
                epoch = int(m.group(1))
                if verified_epochs(ckpt_term)[-1:] != [epoch]:
                    raise AssertionError(f"15c: epoch {epoch} not verified:"
                                         f" {integrity.audit(ckpt_term)}")
                again.append(relaunch(wd_term, epoch + 1))
            if kill.poll() is None and os.path.isdir(ckpt_kill):
                in_flight = [d for d in os.listdir(ckpt_kill)
                             if d.startswith(".tmp-")]
                if in_flight and len(
                        integrity.committed_epochs(ckpt_kill)) >= 2:
                    at["SIGKILL"] = time.perf_counter() - t0
                    kill.send_signal(signal.SIGKILL)
                    kill.wait(timeout=60)
            time.sleep(0.005)
        if epoch is None:
            raise AssertionError("15c: the SIGTERM run ended before its "
                                 "first step line: " + "".join(lines[-20:]))
        committed = integrity.committed_epochs(ckpt_kill)
        newest_ok = verified_epochs(ckpt_kill)[-1]
        again.append(relaunch(wd_kill, committed[-1] + 1))
    finally:
        for proc in (term, kill):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    try:
        outs = [proc.communicate(timeout=P15_TIMEOUT) for proc in again]
    finally:
        for proc in again:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    at["relaunches ended"] = time.perf_counter() - t0
    (out_t, err_t), (out_k, err_k) = outs
    m2 = re.search(r"resumed from epoch (\d+)", out_k)
    left = [d for d in os.listdir(ckpt_kill) if d.startswith(".tmp-")]
    phase(f"15c SIGTERM after the first step line: exit {term.returncode}, "
          f"epoch {epoch} committed and verified; --auto-resume exit "
          f"{again[0].returncode}, finished epoch {epoch + 1}. SIGKILL with "
          f"{in_flight} on disk and epochs {committed} committed: newest "
          f"verified {newest_ok}, the resume landed on "
          f"{m2.group(1) if m2 else None} (exit {again[1].returncode}), "
          f"temporary directories left {left}. Seconds after the two "
          f"starts: " + ", ".join(f"{k} {v:.1f}" for k, v in at.items()))
    if again[0].returncode != 0 or f"resumed from epoch {epoch}" not in \
            out_t or "done: best=" not in out_t:
        raise AssertionError(f"15c: --auto-resume exit "
                             f"{again[0].returncode}: {out_t[-2000:]}"
                             f"{err_t[-2000:]}")
    if again[1].returncode != 0 or not m2 or int(m2.group(1)) != newest_ok \
            or left:
        raise AssertionError(f"15c: resume after SIGKILL: {out_k[-2000:]}"
                             f"{err_k[-2000:]}")
    return {"sigterm_epoch": epoch, "sigkill_committed": committed,
            "sigkill_resumed": newest_ok, "seconds": at}


class StallEnded(Exception):
    """15d's stalled data iterator, ended once the watchdog has fired."""


def check_p15_watchdog(a: dict, model) -> dict:
    """15d: `watchdog_secs` armed in a DetectionTrainer on the card (on a
    copy of 15a's trained `model`), the abort injected: P15_STEPS normal
    steps keep it quiet; a data iterator that then stalls fires it after
    the threshold, at the last step."""
    cfg = a["config"].replace(watchdog_secs=P15_WATCHDOG_SECS,
                              total_epochs=2)
    trainer = DetectionTrainer(cfg, device=P15_DEVICE,
                               workdir=p15_workdir("d"),
                               model=copy.deepcopy(model))
    fired = threading.Event()
    at: dict = {}

    def abort():
        at["step"] = trainer._host_step
        at["fired"] = time.perf_counter()
        fired.set()

    trainer.watchdog_abort = abort
    batches = list(synthetic_batches(
        batch_size=P15_BATCH, image_size=P15_SIZE,
        num_classes=cfg.data.num_classes, steps=P15_STEPS, seed=3))

    def data(epoch):
        if epoch == 1:
            yield from batches
            return
        at["quiet_through_epoch_1"] = not fired.is_set()
        at["stall"] = time.perf_counter()
        fired.wait(6 * P15_WATCHDOG_SECS)
        # where the watchdog's real abort ends the process
        raise StallEnded

    trainer.init_state()
    try:
        trainer.fit(data)
    except StallEnded:
        pass
    finally:
        trainer.close()
    waited = at.get("fired", np.inf) - at.get("stall", 0.0)
    phase(f"15d watchdog at {P15_WATCHDOG_SECS:g}s: quiet through "
          f"{P15_STEPS} steps ({at.get('quiet_through_epoch_1')}); fired "
          f"{waited:.2f}s into the stalled iterator at step "
          f"{at.get('step')}")
    if not fired.is_set() or not at.get("quiet_through_epoch_1") \
            or at.get("step") != P15_STEPS \
            or not P15_WATCHDOG_SECS <= waited <= 3 * P15_WATCHDOG_SECS:
        raise AssertionError(f"15d: {at}")
    return {"fired_after_s": waited, "step": at["step"]}


def check_p15_serving(a: dict, b: dict) -> dict:
    """15e: 15a's workdir (epoch 2 quarantined by 15b's fsck) served by
    `serve.cli.build_server --workdir`: provenance verified with epoch 1's
    manifest digest, an answer equal to `engine.reference()`; 15b's copy
    with its last good epoch bit-flipped is refused."""
    ckpt = os.path.join(a["workdir"], "ckpt")
    args = build_parser().parse_args(
        ["-m", YOLO_MODEL, "--workdir", a["workdir"], "--device", P15_DEVICE,
         "--buckets", "1", "--flush-every", "60"])
    server = build_server(args)
    engine = server.engine
    prov = engine.provenance
    want = {"weights": "checkpoint", "checkpoint_epoch": 1, "verified": True,
            "manifest_sha256": integrity.manifest_digest(
                integrity.load_manifest(os.path.join(ckpt, "1"))),
            "resharded": False}
    x = np.random.RandomState(31).rand(1, *engine.example_shape).astype(
        np.float32)
    got = server.fleet.get().submit(x).result(timeout=120)
    ref = engine.reference(x)
    equal = all(np.allclose(g, w, rtol=P14_RESTORE_RTOL, atol=0,
                            equal_nan=True)
                for g, w in zip(_leaves(got), _leaves(ref)))
    server.close()
    copy = b["copy"]
    flip_a_bit(os.path.join(copy, "ckpt", "1"))
    args = build_parser().parse_args(
        ["-m", YOLO_MODEL, "--workdir", copy, "--device", P15_DEVICE,
         "--buckets", "1", "--flush-every", "60"])
    try:
        build_server(args).close()
        refused = "served"
    except CheckpointCorruptionError as e:
        refused = f"refused: {str(e)[:120]}"
    phase(f"15e {YOLO_MODEL} served from 15a's workdir: provenance {prov}; "
          f"answer vs engine.reference() equal={equal}; the corrupted copy "
          f"{refused}")
    if prov != want or not equal or not refused.startswith("refused"):
        raise AssertionError(f"15e: provenance {prov} (want {want}), "
                             f"equal {equal}, {refused}")
    torch.cuda.empty_cache()
    return {"provenance": prov}


def check_resilience() -> dict:
    """Phase 15, slice 12: resilient yolov3 training on the card. K2 runs
    on 15a's path (the main path of this phase, its counts zeroed just
    before run_detection) and on 15d's steps; K1 on none. 15c's
    subprocesses start first and run beside 15a, 15b, 15d and 15e (their
    launches are their own processes'); 15a's save overlap makes its first
    save (the pinned buffers' allocation) after 15a and times its steps
    after 15c has ended, alone on the card."""
    t0 = time.perf_counter()
    preemption = BACKGROUND.submit(check_p15_preemption)
    out = {"15a": check_p15_divergence()}
    trainer = out["15a"].pop("trainer")
    overlap = start_p15_save_overlap(trainer)
    expected = {"15b": 0, "15d": P15_STEPS, "15e": 0}
    for tag, run in (("15b", lambda: check_p15_integrity(out["15a"],
                                                         trainer.model)),
                     ("15d", lambda: check_p15_watchdog(out["15a"],
                                                        trainer.model)),
                     ("15e", lambda: check_p15_serving(out["15a"],
                                                       out["15b"]))):
        flash_attention.launches = best_iou.launches = 0
        t1 = time.perf_counter()
        out[tag] = run()
        counts = (flash_attention.launches, best_iou.launches)
        phase(f"{tag}: launches (flash_attention, best_iou): {counts}; "
              f"{time.perf_counter() - t1:.1f}s")
        if counts != (0, expected[tag]):
            raise AssertionError(f"phase {tag}: launches {counts}, want "
                                 f"(0, {expected[tag]})")
    t1 = time.perf_counter()
    out["15c"] = preemption.result(4 * P15_TIMEOUT)
    phase(f"15c: waited {time.perf_counter() - t1:.1f}s for it after 15e; "
          f"{time.perf_counter() - t0:.1f}s into the phase")
    torch.cuda.empty_cache()
    out["15a"]["overlap"] = check_p15_save_overlap(trainer, overlap)
    del trainer
    phase(f"15: phase 15 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 16: running the server -----------------------------------------------

P16_MODEL = MODEL
P16_DEVICE = "cuda"
P16_BUCKETS = BUCKETS
P16_TRAIN_BATCH = 32
P16_TRAIN_STEPS = 2            # per epoch
P16_GATE = -0.02               # the candidate may score 2 points lower
P16_CANARY_FRAC = 0.5
P16_CANARY_WINDOW = 1.0          # as 17b's
P16_CLIENTS = 3                # closed-loop in-process clients of 16a
P16_HTTP_PAUSE = 0.1           # between 16a's HTTP client's requests
P16_INPUTS = 4                 # distinct images the 16a clients send
P16_BREAKER_K = 3
P16_BREAKER_COOLDOWN = 1.0
P16_FAIL_AT = 2                # DEEPVISION_FAULT_SERVE_DISPATCH_FAIL=2:K
P16_AUTOSCALE_EVERY = 0.5
P16_MAX_WORKERS = 4
P16_LOAD_CLIENTS = 32          # closed-loop in-process clients of 16c
P16_LOAD_SECS = 2.0            # one measured window
P16_DRAIN_GRACE = 1.0
P16_TIMEOUT = 300              # startup of 16e's subprocess, any wait
P16_DEADLINE = 60.0            # a 16c client's wait for its answer
P16_PROBE_S = 15.0             # after this wait, every thread's stack


def p16_post(base: str, body: bytes, rid: str, path: str = "/predict"):
    """POST a pre-encoded body; (status, parsed JSON, seconds)."""
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": "application/json",
                                          "X-Request-Id": rid})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw or b"{}"), time.perf_counter() - t0


def p16_get(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=120) as resp:
        raw = resp.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def p16_serve(server) -> tuple:
    """`server.serve` on a free port in a thread; (thread, base URL)."""
    t = threading.Thread(target=lambda: server.serve(port=0), daemon=True)
    t.start()
    if not server.ready.wait(P16_TIMEOUT):
        raise RuntimeError("phase 16: the server did not start")
    return t, f"http://127.0.0.1:{server.bound_port}"


def p16_stop(server, t) -> None:
    server.stop()
    t.join(timeout=P16_TIMEOUT)
    server.close()
    if t.is_alive():
        raise AssertionError("phase 16: the server did not drain")


def p16_args(*extra):
    return build_parser().parse_args(
        ["-m", P16_MODEL, "--device", P16_DEVICE, "--flush-every", "600",
         *extra])


def p16_train(workdir: str, epochs: int) -> None:
    """`ViT/torch/train.py`'s run_classification: P16_TRAIN_STEPS steps an
    epoch at batch P16_TRAIN_BATCH, synthetic, resumed from the workdir's
    newest checkpoint."""
    run_classification("ViT", [P16_MODEL], [
        "-m", P16_MODEL, "--synthetic", "--batch-size", str(P16_TRAIN_BATCH),
        "--steps-per-epoch", str(P16_TRAIN_STEPS), "--epochs", str(epochs),
        "--device", P16_DEVICE, "--workdir", workdir, "--auto-resume"])


def p16_commit(stash: str, workdir: str, epoch: int) -> None:
    """Training commits epoch `epoch` into the served run dir (a copy of
    the stashed checkpoint: the files and their manifest as written)."""
    shutil.copytree(os.path.join(stash, "ckpt", str(epoch)),
                    os.path.join(workdir, "ckpt", str(epoch)))


def p16_checkpoints() -> tuple:
    """Four epochs of vit_small at full width: epochs 1-2 from one run,
    3-4 from its resumption, each stashed as soon as it is written (the
    trainer keeps the newest 3)."""
    train = p15_workdir("16_train")
    stash = p15_workdir("16_stash")
    t0 = time.perf_counter()
    for upto in (2, 4):
        p16_train(train, upto)
        for e in range(upto - 1, upto + 1):
            shutil.copytree(os.path.join(train, "ckpt", str(e)),
                            os.path.join(stash, "ckpt", str(e)))
    phase(f"16a: {P16_MODEL} trained 4 epochs of {P16_TRAIN_STEPS} steps at "
          f"batch {P16_TRAIN_BATCH} in {time.perf_counter() - t0:.1f}s")
    return stash


def p16_references(stash: str, inputs: np.ndarray) -> dict:
    """Each epoch's answers to the 16a inputs, one at a time: the
    `reference()` (unbucketed) of an engine on that epoch's weights."""
    refs = {}
    for e in range(1, 5):
        eng = PredictEngine.from_config(P16_MODEL, device=P16_DEVICE,
                                        workdir=stash, checkpoint=e,
                                        buckets=(1,), verbose=False)
        refs[e] = [eng.reference(x[None]) for x in inputs]
        del eng
    return refs


def check_p16_promotion(stash: str) -> dict:
    """16a: epoch 1 served over HTTP with the promotion gate, the poller
    off; POST /reload promotes epoch 2 through shadow, gate and canary
    under closed-loop traffic (P16_CLIENTS in-process clients through the
    fleet's batcher, and one paced HTTP client); epoch 3 with the accuracy fault refused and
    cached; epoch 4 with the latency fault rolled back in the canary. K1's
    launches equal depth x dispatches of both generations (the shadow
    eval's included), no batch mixes generations, every answer equals its
    epoch's reference."""
    cfg = get_config(P16_MODEL)
    depth = cfg.model_kwargs["depth"]
    workdir = p15_workdir("16a")
    p16_commit(stash, workdir, 1)
    rs = np.random.RandomState(16)
    shape = (cfg.data.image_size, cfg.data.image_size, cfg.data.channels)
    inputs = rs.rand(P16_INPUTS, *shape).astype(np.float32)
    refs = p16_references(stash, inputs)
    bodies = [json.dumps({"instances": x[None].tolist()}).encode()
              for x in inputs]
    server = build_server(p16_args(
        "--workdir", workdir, "-c", "1",
        "--buckets", ",".join(map(str, P16_BUCKETS)),
        "--promote-gate", str(P16_GATE),
        "--canary-frac", str(P16_CANARY_FRAC),
        "--canary-window", str(P16_CANARY_WINDOW), "--workers", "2",
        "--trace-sample", "1.0"))
    sm = server.fleet.default
    engine, promoter = sm.engine, sm.promoter
    t, base = p16_serve(server)
    stop = threading.Event()
    answers, failures = [], []

    def http_client() -> None:
        # paced: a JSON parse of a 224 px image holds the GIL for tens of
        # ms, and back-to-back parses from 4 clients stretched every
        # dispatch the canary times to 200-240 ms on the H100 (PERF.md)
        n = 0
        while not stop.is_set():
            i = n % P16_INPUTS
            rid = f"p16a-http-{n}"
            status, body, _ = p16_post(base, bodies[i], rid)
            if status != 200:
                failures.append((rid, status, body))
                return
            answers.append((rid, i, body["generation"],
                            body["weights_epoch"],
                            np.asarray(body["predictions"], np.float32)))
            n += 1
            stop.wait(P16_HTTP_PAUSE)

    def client(k: int) -> None:
        n = 0
        while not stop.is_set():
            i = (k + n) % P16_INPUTS
            rid = f"p16a-{k}-{n}"
            fut = sm.submit(inputs[i][None], trace=server.tracer
                            .request_context(rid, forced=True))
            try:
                pred = result_within(fut, 120.0)
            except Exception as e:  # noqa: BLE001 — every failure counts
                failures.append((rid, repr(e)))
                return
            answers.append((rid, i, fut.generation,
                            fut.weights.get("checkpoint_epoch"), pred))
            n += 1

    decisions = []
    flash_attention.launches = 0         # counts of the main path only
    engine.dispatches = 0
    engine.dispatches_by_generation.update(live=0, candidate=0)
    clients = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(P16_CLIENTS)]
    clients.append(threading.Thread(target=http_client, daemon=True))
    try:
        for c in clients:
            c.start()
        time.sleep(0.5)                  # traffic on the incumbent
        for epoch, fault in ((2, None), (3, "accuracy"), (None, None),
                             (4, "latency")):
            if epoch is not None:
                p16_commit(stash, workdir, epoch)
                env = ({"DEEPVISION_FAULT_PROMOTE_REGRESS":
                        f"{epoch}:{fault}"} if fault else {})
                promoter.faults = FaultInjector.from_env(env)
            evals = promoter.shadow_evals
            _, out, secs = p16_post(base, b"", f"p16a-reload-{epoch}",
                                    "/reload")
            rec = out["models"][P16_MODEL]
            decisions.append({
                "epoch": epoch, "swapped": out["swapped"],
                "scored": promoter.shadow_evals - evals,
                "decision": (rec["promotion"]["decisions"][-1]
                             if promoter.shadow_evals > evals else None),
                "reload": rec["reload"], "post_s": secs})
            time.sleep(0.3)
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=P16_TIMEOUT)
    launches, dispatches = flash_attention.launches, engine.dispatches
    by_gen = dict(engine.dispatches_by_generation)
    trace = chrome_trace(server.tracer)
    p16_stop(server, t)

    for d in decisions:
        rec = d["decision"] or {}
        phase(f"16a POST /reload (epoch {d['epoch']}): swapped "
              f"{d['swapped']}, scored {d['scored']}, "
              f"{rec.get('decision')} "
              + " ".join(f"{k}={rec[k]}" for k in (
                  "metric_live", "metric_candidate", "metric_delta",
                  "canary_requests", "baseline_requests",
                  "live_dispatch_p50_ms", "candidate_dispatch_p50_ms",
                  "secs") if k in rec)
              + f"; the POST took {d['post_s']:.2f}s")
    want = [(1, 1, "promoted"), (0, 1, "refused_gate"), (0, 0, None),
            (0, 1, "rolled_back_canary")]
    got = [(d["swapped"], d["scored"], (d["decision"] or {}).get(
        "decision")) for d in decisions]
    if got != want or failures:
        raise AssertionError(f"16a: decisions {got} (want {want}); "
                             f"failed requests {failures[:3]}")
    if decisions[3]["decision"]["canary_requests"] <= 0:
        raise AssertionError("16a: the latency canary served no request")

    served_err, by_epoch = 0.0, {}
    for rid, i, gen, epoch, pred in answers:
        by_epoch[(gen, epoch)] = by_epoch.get((gen, epoch), 0) + 1
        served_err = max(served_err, float(np.abs(
            pred - refs[epoch][i]).max()))
    generation_of = {rid: (gen, epoch) for rid, _, gen, epoch, _ in answers}
    mixed = 0
    batches = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e["name"] == "batch"]
    for b in batches:
        served = {generation_of[r] for r in b["args"]["requests"]
                  if r in generation_of}
        mixed += len(served) > 1
    n_http = sum(rid.startswith("p16a-http") for rid, *_ in answers)
    phase(f"16a answers: {len(answers)} ({n_http} over HTTP, the rest "
          f"submitted in-process), by (generation, epoch) "
          f"{by_epoch}; max |answer - its epoch's reference| = "
          f"{served_err:.3g} (bound {SERVE_TOL:g}); {len(batches)} batch "
          f"spans, {mixed} mixing generations")
    phase(f"16a main path: {dispatches} dispatches ({by_gen}), "
          f"{launches} flash_attention launches (depth {depth}): K1 per "
          f"generation live={depth * by_gen['live']} "
          f"candidate={depth * by_gen['candidate']}")
    if served_err > SERVE_TOL or mixed or not batches:
        raise AssertionError(f"16a: answers off by {served_err:g}, "
                             f"{mixed} mixed batches")
    if dispatches == 0 or launches != depth * dispatches \
            or by_gen["candidate"] == 0:
        raise AssertionError(f"16a: flash_attention ran {launches} times for "
                             f"{dispatches} dispatches ({by_gen}) of depth "
                             f"{depth}")
    if {e for _, e in by_epoch} - {1, 2, 4} or (("live", 2) not in by_epoch):
        raise AssertionError(f"16a: answers by epoch {by_epoch}")
    return {"launches": launches, "dispatches": dispatches,
            "by_generation": by_gen, "decisions": decisions,
            "timings": p16_timings(stash)}


def p16_timings(stash: str) -> dict:
    """The promotion pipeline's pieces timed alone, on an engine of
    epoch 1: the verified load of epoch 2, `stage_candidate`, the shadow
    eval (both generations over the pinned shard), `promote_candidate`."""
    def sync():
        if P16_DEVICE == "cuda":
            torch.cuda.synchronize()

    engine = PredictEngine.from_config(
        P16_MODEL, device=P16_DEVICE, workdir=stash, checkpoint=1,
        buckets=P16_BUCKETS, verbose=False)
    engine.warmup()
    cfg = get_config(P16_MODEL)
    t0 = time.perf_counter()
    model, prov, _ = load_checkpoint_weights(P16_MODEL, stash, checkpoint=2,
                                             verbose=False)
    load_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    engine.stage_candidate(model, prov)
    stage_s = time.perf_counter() - t0
    images, targets = scoring.pinned_shard(
        cfg, image_size=engine.example_shape[0],
        input_dtype=engine.input_dtype)
    sync()
    t0 = time.perf_counter()
    scores = [scoring.score_serving_outputs(
        cfg, engine.predict(images, generation=g), targets)
        for g in (None, "candidate")]
    shadow_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.promote_candidate()
    promote_s = time.perf_counter() - t0
    out = {"verified_load_ms": 1e3 * load_s, "stage_candidate_ms":
           1e3 * stage_s, "shadow_eval_ms": 1e3 * shadow_s,
           "promote_candidate_ms": 1e3 * promote_s,
           "shadow_examples": len(images), "scores": scores}
    phase("16a timings: " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out.items()))
    return out


def check_p16_breaker() -> dict:
    """16b: DEEPVISION_FAULT_SERVE_DISPATCH_FAIL=k:K armed: the dispatch
    error answers until K errors open the circuit, then 503 naming the
    model with Retry-After; after the cooldown one probe is admitted, its
    success closes the circuit and the model answers again."""
    key = "DEEPVISION_FAULT_SERVE_DISPATCH_FAIL"
    os.environ[key] = f"{P16_FAIL_AT}:{P16_BREAKER_K}"
    try:
        server = build_server(p16_args(
            "--buckets", "1,8", "--breaker-k", str(P16_BREAKER_K),
            "--breaker-cooldown", str(P16_BREAKER_COOLDOWN)))
    finally:
        del os.environ[key]
    engine = server.engine
    t, base = p16_serve(server)
    body = json.dumps({"instances": np.zeros(
        (1, *engine.example_shape), np.float32).tolist()}).encode()
    seq, t_kth = [], time.perf_counter()
    try:
        for n in range(P16_FAIL_AT + P16_BREAKER_K + 1):
            status, out, _ = p16_post(base, body, f"p16b-{n}")
            seq.append((status, out.get("reason")))
            if status == 500:
                t_kth = time.perf_counter()
        to_503 = time.perf_counter() - t_kth
        retry = out
        time.sleep(P16_BREAKER_COOLDOWN)
        for n in range(2):
            status, out, _ = p16_post(base, body, f"p16b-probe-{n}")
            seq.append((status, out.get("reason")))
        breaker = server.fleet.default.breaker.describe()
    finally:
        p16_stop(server, t)
    want = ([(200, None)] * P16_FAIL_AT + [(500, None)] * P16_BREAKER_K
            + [(503, "circuit_open"), (200, None), (200, None)])
    phase(f"16b breaker (K={P16_BREAKER_K}, cooldown "
          f"{P16_BREAKER_COOLDOWN:g}s): statuses {seq}; from the K-th "
          f"error to the first 503: {1e3 * to_503:.3f} ms; 503 body model "
          f"{retry.get('model')!r}; breaker {breaker}")
    if seq != want or retry.get("model") != P16_MODEL \
            or breaker["opened"] != 1 or breaker["closed_after_open"] != 1:
        raise AssertionError(f"16b: {seq} (want {want}), {breaker}")
    return {"k_to_503_ms": 1e3 * to_503, "statuses": seq}


def p16_load(sm, secs: float, clients: int) -> dict:
    """Closed-loop in-process clients of one image each for `secs`: the
    window's images/s and p99 (ServingMetrics) and the refusals."""
    stop = threading.Event()
    x = np.zeros((1, *sm.engine.example_shape), sm.engine.input_dtype)
    refused = [0]

    def client():
        while not stop.is_set():
            try:
                fut = sm.submit(x)
            except RequestRejected:
                refused[0] += 1
                time.sleep(0.001)
                continue
            try:
                result_within(fut, P16_PROBE_S)
            except DeadlineExpired:
                # an accepted request unanswered for P16_PROBE_S: where
                # every thread sits (once), then the rest of the deadline
                p16_dump_stacks(sm, f"a request has waited {P16_PROBE_S:g}"
                                    f"s for its answer")
                result_within(fut, P16_DEADLINE - P16_PROBE_S)

    sm.metrics.snapshot(reset=True)
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for c in threads:
        c.start()
    time.sleep(secs)
    snap = sm.metrics.snapshot(reset=True)
    stop.set()
    for c in threads:
        c.join(timeout=P16_TIMEOUT)
    return {"images_per_sec": snap["images_per_sec"],
            "p99_ms": snap.get("p99_ms", float("nan")),
            "mean_batch_fill": snap["mean_batch_fill"],
            "workers": sm.batcher.workers, "refused": refused[0]}


P16_DUMPED = threading.Event()


def p16_dump_stacks(sm, why: str) -> None:
    """Print the batcher's counts and every thread's stack, once a
    process: the probe for an accepted request that goes unanswered
    (ROADMAP Queue C)."""
    import traceback
    if P16_DUMPED.is_set():
        return
    P16_DUMPED.set()
    b = sm.batcher
    lines = [f"16c probe: {why}; pending {b._pending} examples, "
             f"{len(b._threads)} worker(s) (target {b._target_workers}), "
             f"queue {b._q.qsize()}"]
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} ({ident})")
        lines.extend(ln.rstrip() for ln in traceback.format_stack(frame))
    print("\n".join(lines), flush=True)


def check_p16_autoscale() -> dict:
    """16c: closed-loop overload at bucket 8 with one worker, the
    autoscaler sampling every P16_AUTOSCALE_EVERY s: the pool grows while
    the load sheds and shrinks back once it stops, and no weight is
    copied. Then images/s and p99 at one worker and at the pool's peak."""
    server = build_server(p16_args(
        "--buckets", "1,8", "--max-queue", "16", "--workers", "1",
        "--max-workers", str(P16_MAX_WORKERS),
        "--autoscale-every", str(P16_AUTOSCALE_EVERY)))
    sm = server.fleet.default
    ctl = server.autoscaler
    # this phase's hysteresis: decisions 0.5 s apart, down after 2 idle
    # samples (the defaults, 2 s and 10, make the fall back take 30 s)
    ctl.cooldown_s, ctl.down_after = P16_AUTOSCALE_EVERY, 2
    ptrs = [p.data_ptr() for p in sm.engine.model.parameters()]
    try:
        server.start_control_loops()
        t0 = time.perf_counter()
        overload = p16_load(sm, 3.0, P16_LOAD_CLIENTS)
        peak = sm.batcher.workers
        deadline = time.monotonic() + 30
        while sm.batcher.workers > 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        fell_to = sm.batcher.workers
        back_s = time.perf_counter() - t0
        ctl.stop()
        stats = dict(sm.autoscale_stats)
        windows = []
        for n in (1, peak, 1, peak):
            sm.batcher.set_workers(n)
            time.sleep(0.2)
            windows.append(p16_load(sm, P16_LOAD_SECS, 16))
    finally:
        server.close()
    same = ptrs == [p.data_ptr() for p in sm.engine.model.parameters()]
    phase(f"16c autoscaler: overload {overload}; peak {peak} workers, back "
          f"to {fell_to} {back_s:.1f}s after the load began; decisions "
          f"{ {k: stats[k] for k in ('scale_ups', 'scale_downs', 'escalations')} }; "
          f"parameter storage unchanged {same}")
    for w in windows:
        phase(f"16c {w['workers']} worker(s), bucket 8, 16 closed-loop "
              f"clients: images/s={w['images_per_sec']:.1f} "
              f"p99_ms={w['p99_ms']:.3f} mean_batch_fill="
              f"{w['mean_batch_fill']:.2f}")
    if peak <= 1 or fell_to != 1 or not same or stats["scale_ups"] < 1:
        raise AssertionError(f"16c: peak {peak}, fell to {fell_to}, "
                             f"weights kept {same}, {stats}")
    return {"peak_workers": peak, "windows": windows}


def check_p16_metrics_trace() -> dict:
    """16d: `/metrics` passes validate_serve_exposition and is monotone
    across two scrapes; `/trace` holds the admission -> queue_wait ->
    batch -> device_dispatch -> response_write chain of one client-id
    request; p50/p99 at bucket 8 over HTTP with tracing on (sample 1.0)
    and off, in turns; render_prometheus for one model and three."""
    server = build_server(p16_args("--buckets", "1,8",
                                   "--trace-sample", "1.0"))
    engine = server.engine
    t, base = p16_serve(server)
    body = json.dumps({"instances": np.zeros(
        (1, *engine.example_shape), np.float32).tolist()}).encode()
    try:
        m1 = p16_get(base, "/metrics")
        status, _, _ = p16_post(base, body, "p16d-demo")
        m2 = p16_get(base, "/metrics")
        doc = p16_get(base, "/trace")
        lat = {}
        for on in (True, False, True, False):
            server.tracer.enabled = on
            lat.setdefault(on, []).extend(p16_http_load(base, body))
        server.tracer.enabled = True
        render_ms = p16_render_ms(server.fleet)
    finally:
        p16_stop(server, t)
    errors = validate_serve_exposition(m1) + validate_serve_exposition(m2)
    p1, p2 = parse_prometheus_text(m1), parse_prometheus_text(m2)
    shrank = [k for k, v in p1.items()
              if (k[0].endswith("_total") or k[0].endswith("_count")
                  or k[0].endswith("_bucket")) and p2.get(k, -1) < v]
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    mine = {e["name"]: e for e in spans
            if e["args"].get("request_id") == "p16d-demo"}
    qw = mine.get("queue_wait", {"args": {}})
    batch = [e for e in spans if e["name"] == "batch"
             and e["args"]["span_id"] == qw["args"].get("batch")]
    dispatch = [e for e in spans if e["name"] == "device_dispatch"
                and batch and e["args"]["batch"] == batch[0]["args"][
                    "span_id"]]
    chain = sorted(mine) + [e["name"] for e in batch + dispatch]
    pct = {on: (float(np.percentile(v, 50)) * 1e3,
                float(np.percentile(v, 99)) * 1e3) for on, v in lat.items()}
    phase(f"16d /metrics: {len(m2.splitlines())} lines, validate "
          f"{errors or 'clean'}, counters shrunk {shrank}; /trace chain of "
          f"p16d-demo: {chain}")
    phase(f"16d HTTP latency at bucket 8 (8 clients, JSON "
          f"{engine.example_shape[0]} px): tracing "
          f"on p50={pct[True][0]:.3f} p99={pct[True][1]:.3f} ms "
          f"({len(lat[True])} requests); off p50={pct[False][0]:.3f} "
          f"p99={pct[False][1]:.3f} ms ({len(lat[False])} requests)")
    phase(f"16d render_prometheus: {render_ms}")
    want = {"http_request", "admission", "queue_wait", "response_write",
            "batch", "device_dispatch"}
    if status != 200 or errors or shrank or not want <= set(chain):
        raise AssertionError(f"16d: status {status}, {errors[:3]}, shrank "
                             f"{shrank[:3]}, chain {chain}")
    return {"latency_ms": pct, "render_ms": render_ms}


def p16_http_load(base: str, body: bytes, clients: int = 8) -> list:
    """Closed-loop HTTP clients for P16_LOAD_SECS; each request's seconds."""
    stop = threading.Event()
    lat: list = []

    def client(k):
        n = 0
        while not stop.is_set():
            status, _, secs = p16_post(base, body, f"p16d-load-{k}-{n}")
            if status != 200:
                raise AssertionError(f"16d: status {status}")
            lat.append(secs)
            n += 1

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for c in threads:
        c.start()
    time.sleep(P16_LOAD_SECS)
    stop.set()
    for c in threads:
        c.join(timeout=P16_TIMEOUT)
    return lat


def p16_render_ms(fleet) -> dict:
    """render_prometheus of the served fleet (one model) and of a fleet
    of three (two small models beside it, each after one answer), ms per
    call over 100."""
    three = ModelFleet()
    others = [n for n in ("lenet5", "lenet5_digits", "vit_tiny")
              if n != fleet.default.name][:2]
    for name in others:
        three.add(PredictEngine.from_config(name, device=P16_DEVICE,
                                            buckets=(1,), verbose=False))
    three.add(fleet.default.engine)
    out = {}
    try:
        for sm in three:      # one answer each: every histogram has data
            result_within(sm.submit(np.zeros(
                (1, *sm.engine.example_shape), sm.engine.input_dtype)), 60.0)
        for n, f in ((1, fleet), (3, three)):
            render_prometheus(f)
            t0 = time.perf_counter()
            for _ in range(100):
                render_prometheus(f)
            out[f"{n}_models_ms"] = (time.perf_counter() - t0) / 100 * 1e3
    finally:
        three.drain(timeout=60)
    return out


def p16_start_drain() -> tuple:
    """16e's server, started first: it takes seconds to reach the card."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", P16_MODEL,
         "--device", P16_DEVICE, "--drain-grace", str(P16_DRAIN_GRACE),
         "--buckets", "1,8", "--port", str(port), "--flush-every", "600"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=p15_env())
    return proc, f"http://127.0.0.1:{port}"


def check_p16_drain(proc, base: str) -> dict:
    """16e: SIGTERM under traffic: /healthz reads "draining" at once,
    every accepted request is answered, the exit code is 0."""
    try:
        deadline = time.monotonic() + P16_TIMEOUT
        while True:
            try:
                if p16_get(base, "/healthz")["status"] == "ok":
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"16e: the server did not start: "
                                     f"{proc.stdout.read()[-3000:]}")
            time.sleep(0.2)
        cfg = get_config(P16_MODEL)
        size = cfg.data.image_size
        body = json.dumps({"instances": np.zeros(
            (1, size, size, cfg.data.channels), np.float32).tolist()}
        ).encode()
        stop = threading.Event()
        outcomes: list = []

        def client(k):
            n = 0
            while not stop.is_set():
                try:
                    status, out, _ = p16_post(base, body, f"p16e-{k}-{n}")
                    outcomes.append((status, out.get("reason")))
                except OSError:
                    outcomes.append(("refused", None))
                    time.sleep(0.05)
                n += 1

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(4)]
        for c in threads:
            c.start()
        time.sleep(1.0)
        before = len(outcomes)
        proc.send_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        health = p16_get(base, "/healthz")["status"]
        while health != "draining" \
                and time.perf_counter() - t0 < P16_DRAIN_GRACE / 2:
            health = p16_get(base, "/healthz")["status"]
        health_s = time.perf_counter() - t0
        out, _ = proc.communicate(timeout=P16_TIMEOUT)
        stop.set()
        for c in threads:
            c.join(timeout=P16_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    kinds = {}
    for o in outcomes:
        kinds[o] = kinds.get(o, 0) + 1
    bad = [o for o in outcomes
           if o not in ((200, None), (503, "draining"), ("refused", None))]
    phase(f"16e SIGTERM under traffic: /healthz {health!r} "
          f"{1e3 * health_s:.1f} ms after the signal; {before} answers "
          f"before it; outcomes {kinds}; exit {proc.returncode}")
    if proc.returncode != 0 or health != "draining" or bad \
            or "drained cleanly" not in out:
        raise AssertionError(f"16e: exit {proc.returncode}, healthz "
                             f"{health}, bad {bad[:5]}: {out[-2000:]}")
    return {"outcomes": {str(k): v for k, v in kinds.items()}}


def check_serve_ops() -> dict:
    """Phase 16, slice 13: the server's operations on vit_small at full
    width. K1 runs on 16a's path (the main path, its counts zeroed just
    before the traffic); the other sub-phases serve too and are not
    counted."""
    t0 = time.perf_counter()
    drain = p16_start_drain()
    try:
        stash = p16_checkpoints()
        out = {"16a": check_p16_promotion(stash)}
        phase(f"16a: {time.perf_counter() - t0:.1f}s")
        for tag, run in (("16b", check_p16_breaker),
                         ("16c", check_p16_autoscale),
                         ("16d", check_p16_metrics_trace),
                         ("16e", lambda: check_p16_drain(*drain))):
            t1 = time.perf_counter()
            out[tag] = run()
            phase(f"{tag}: {time.perf_counter() - t1:.1f}s")
    finally:
        if drain[0].poll() is None:
            drain[0].kill()
            drain[0].wait()
    phase(f"16: phase 16 took {time.perf_counter() - t0:.1f}s")
    out["stash"] = stash
    return out


# -- phase 17: the replica tier and the flywheel -----------------------------

P17_MODEL = MODEL
P17_DEVICE = "cuda"
P17_REPLICAS = 2
P17_BUCKETS = "1,8"
P17_CLIENTS = 8                # closed-loop HTTP clients of 1 image: bucket 8
P17_LOAD_SECS = 1.0            # each measured window of 17a
# the router's probe and attempt caps. A 224 px request is 150,528 floats
# of JSON whose parse holds a replica's GIL for tens of ms, and a /healthz
# answer waits behind the parses in flight: with 8 HTTP clients phase 16d
# measured a p99 of 628-847 ms on one server (PERF.md). JAX's defaults (a
# 1 s probe, 3 misses open a slot's breaker) sit at that p99 and would
# eject healthy replicas; 5 s is about 6x it. A forward still unanswered
# after 10 s (12x) is retried on the other replica
P17_PROBE_TIMEOUT = 5.0
P17_ATTEMPT_TIMEOUT = 10.0
P17_REGRESS_EPOCH = 3          # PROMOTE_REGRESS armed in the replicas
P17_TIMEOUT = 300              # the tier's boot, a respawn, any wait
P17_FLYWHEEL_EVERY = 0.5       # 17b's tick
P17_DRIFT = "0:3.0"            # DEEPVISION_FAULT_DRIFT_SHIFT of 17b
P17_CANARY_WINDOW = 1.0
# 17b's gate: the run's epochs sit near chance on the 1000 classes (a
# 64-image shard scores 0-2 hits), and so does a candidate fine-tuned for
# 4 steps; -0.1 lets a chance-level candidate through (PERF.md)
P17_GATE = -0.1
P17_DRIFT_AGAIN = "0:-3.0"     # a new drift after the promotion
P17_MAX_ATTEMPTS = 2           # refusals that open 17b's circuit
P17_FINETUNE_BATCHES = 2       # each 17b fine-tune: 1 epoch of this many
P17_BACKOFF_S = 0.5            # 17b's backoff after its first refusal
P17_CLIENTS_B = 3              # in-process clients of 17b


def p17_health(base: str):
    """The router's /healthz, or None while it does not answer 200."""
    try:
        return p16_get(base, "/healthz")
    except OSError:
        return None


def p17_wait(base: str, what: str, ok) -> float:
    """Poll the router's /healthz until `ok(body)`; the seconds it took."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < P17_TIMEOUT:
        body = p17_health(base)
        if body is not None and ok(body):
            return time.perf_counter() - t0
        time.sleep(0.1)
    raise AssertionError(f"17a: {what} within {P17_TIMEOUT}s: "
                         f"{p17_health(base)}")


def p17_start_tier(root: str, log_dir: str) -> tuple:
    """`python -m deepvision_tpu_torch.serve.tier` over `root` with
    P17_REPLICAS replicas on the card, the promotion gate armed for the
    router's rolls and DEEPVISION_FAULT_PROMOTE_REGRESS armed in the
    replicas' environment; its output (and the replicas') in `log_dir`."""
    port = free_port()
    env = dict(p15_env(), DEEPVISION_FAULT_PROMOTE_REGRESS=(
        f"{P17_REGRESS_EPOCH}:accuracy"))
    out = open(os.path.join(log_dir, "tier.out"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.serve.tier",
         "-m", P17_MODEL, "--replicas", str(P17_REPLICAS), "--runs-root",
         root, "--promote-gate", str(P16_GATE), "--device", P17_DEVICE,
         "--buckets", P17_BUCKETS, "--port", str(port), "--probe-timeout",
         str(P17_PROBE_TIMEOUT), "--attempt-timeout",
         str(P17_ATTEMPT_TIMEOUT), "--log-dir", log_dir],
        cwd=HERE, stdout=out, stderr=subprocess.STDOUT, env=env)
    out.close()
    return proc, f"http://127.0.0.1:{port}"


def p17_replica_pid(url: str) -> int:
    """The pid of the replica process listening at `url` (its argv names
    the port)."""
    port = url.rsplit(":", 1)[1].encode()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if (b"deepvision_tpu_torch.serve.replica" in argv
                and b"--port" in argv
                and argv[argv.index(b"--port") + 1] == port):
            return int(d)
    raise AssertionError(f"17a: no replica process serves {url}")


class P17Clients:
    """Closed-loop HTTP clients through `base`, each sending one of the
    pre-encoded bodies at a time: every answer (request id, input index,
    generation, epoch, logits), every failure and each request's seconds,
    until `stop()`."""

    def __init__(self, base: str, bodies: list, tag: str,
                 n: int = P17_CLIENTS):
        self.answers, self.failures, self.lat = [], [], []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run,
                                          args=(base, bodies, tag, k),
                                          daemon=True) for k in range(n)]
        for t in self._threads:
            t.start()

    def _run(self, base, bodies, tag, k):
        n = 0
        while not self._stop.is_set():
            i = (k + n) % len(bodies)
            rid = f"p17{tag}-{k}-{n}"
            try:
                status, body, secs = p16_post(base, bodies[i], rid)
            except Exception as e:  # noqa: BLE001 — every failure counts
                self.failures.append((rid, repr(e)))
                return
            if status != 200:
                self.failures.append((rid, status, body))
                return
            self.lat.append(secs)
            self.answers.append((rid, i, body["generation"],
                                 body["weights_epoch"],
                                 np.asarray(body["predictions"],
                                            np.float32)))
            n += 1

    def stop(self) -> "P17Clients":
        self._stop.set()
        for t in self._threads:
            t.join(timeout=P17_TIMEOUT)
        return self

    def percentiles(self) -> tuple:
        return (float(np.percentile(self.lat, 50)) * 1e3,
                float(np.percentile(self.lat, 99)) * 1e3)


def p17_replica(base: str, slot: int) -> dict:
    """Slot `slot`'s record on the router's /healthz."""
    return p17_health(base)["replicas"][slot]


def p17_decisions(url: str) -> list:
    """A replica's own promotion decisions (its /healthz)."""
    return p16_get(url, "/healthz")["models"][P17_MODEL]["promotion"][
        "decisions"]


def check_p17_tier(stash: str, direct_ms: dict) -> dict:
    """17a: the tier over a runs root holding epoch 1 of phase 16's run:
    cold start; clean closed-loop traffic at bucket 8 through the router
    and straight to one replica (no ejection); one replica SIGKILLed under
    traffic (zero failures, exit/restart/readmission events, the respawn
    loading flash_attention from the cache); epoch 2 rolled onto both
    replicas; epoch 3 (PROMOTE_REGRESS) stopped after one; the merged
    /metrics; every answer against its epoch's reference; K1's launches
    per replica; SIGTERM exits 0."""
    cfg = get_config(P17_MODEL)
    depth = cfg.model_kwargs["depth"]
    root = p15_workdir("17_root")
    run = os.path.join(root, P17_MODEL)
    p16_commit(stash, run, 1)
    log_dir = p15_workdir("17_logs")
    t0 = time.perf_counter()
    proc, base = p17_start_tier(root, log_dir)
    out = {}
    try:
        rs = np.random.RandomState(17)
        shape = (cfg.data.image_size, cfg.data.image_size,
                 cfg.data.channels)
        inputs = rs.rand(P16_INPUTS, *shape).astype(np.float32)
        bodies = [json.dumps({"instances": x[None].tolist()}).encode()
                  for x in inputs]
        refs = p16_references(stash, inputs)   # while the replicas boot
        out["cold_start_s"] = (time.perf_counter() - t0) + p17_wait(
            base, "both replicas routable",
            lambda b: b["routable"] == P17_REPLICAS)
        urls = [r["url"] for r in p17_health(base)["replicas"]]

        # clean traffic: through the router, then straight to replica 0
        routed = P17Clients(base, bodies, "a")
        time.sleep(P17_LOAD_SECS)
        routed.stop()
        direct = P17Clients(urls[0], bodies, "d")
        time.sleep(P17_LOAD_SECS)
        direct.stop()
        false_ejections = p16_get(base, "/stats")["ejections"]
        out["latency_ms"] = {"router": routed.percentiles(),
                             "direct_one_replica": direct.percentiles(),
                             "phase_16d_direct": direct_ms}
        out["images_per_s"] = {
            "router": len(routed.lat) / P17_LOAD_SECS,
            "direct_one_replica": len(direct.lat) / P17_LOAD_SECS}

        # SIGKILL replica 0 under traffic
        before = p17_replica(base, 0)["launches"]
        load = P17Clients(base, bodies, "k")
        time.sleep(1.0)
        os.kill(p17_replica_pid(urls[0]), signal.SIGKILL)
        t_kill = time.perf_counter()
        p17_wait(base, "replica 0 respawned and readmitted",
                 lambda b: b["replicas"][0]["launches"] > before
                 and b["replicas"][0]["routable"])
        out["kill_to_readmission_s"] = time.perf_counter() - t_kill
        time.sleep(1.0)
        load.stop()
        respawn = p17_replica(base, 0)

        # roll epoch 2 (clean), then epoch 3 (the regression), each with
        # no traffic in flight: under 8 JSON clients a replica's verified
        # load shares its GIL with the parses and a roll took 28-63 s on
        # the H100 (PERF.md); a window after the clean roll serves
        # epoch 2 from both replicas
        rolls = []
        after = None
        for epoch in (2, P17_REGRESS_EPOCH):
            p16_commit(stash, run, epoch)
            seen = [len(p17_decisions(u)) for u in urls]
            t1 = time.perf_counter()
            _, rec, _ = p16_post(base, b"", f"p17a-roll-{epoch}", "/roll")
            wall = time.perf_counter() - t1
            recs = [p17_decisions(u)[n:] for u, n in zip(urls, seen)]
            rolls.append({"epoch": epoch, "state": rec["state"],
                          "outcomes": [o["outcome"]
                                       for o in rec["outcomes"]],
                          "wall_s": wall,
                          "replica_s": [[d["secs"] for d in r]
                                        for r in recs],
                          "decisions": [[d["decision"] for d in r]
                                        for r in recs]})
            if after is None:
                after = P17Clients(base, bodies, "r")
                time.sleep(P17_LOAD_SECS)
                after.stop()
        metrics = p16_get(base, "/metrics")
        stats = p16_get(base, "/stats")
        replicas = [p16_get(u, "/healthz") for u in urls]
    except BaseException:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        print(open(os.path.join(log_dir, "tier.out")).read()[-4000:],
              flush=True)
        raise
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=P17_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = open(os.path.join(log_dir, "tier.out")).read()

    events = p17_jsonl(os.path.join(log_dir, "tier.jsonl"))
    names = {k[len("resilience_"):] for e in events for k in e
             if k.startswith("resilience_tier_")}
    t_of = {}
    for e in events:
        if e.get("resilience_replica_slot") == 0.0:
            for k in ("tier_replica_restarted", "tier_replica_readmitted"):
                if "resilience_" + k in e:
                    t_of[k] = e["t"]
    out["respawn_to_readmission_s"] = (
        t_of.get("tier_replica_readmitted", float("nan"))
        - t_of.get("tier_replica_restarted", float("nan")))
    out["rolls"] = rolls
    out["false_ejections"] = false_ejections
    answers = (routed.answers + direct.answers + load.answers
               + after.answers)
    failures = (routed.failures + direct.failures + load.failures
                + after.failures)
    served_err, by_epoch = 0.0, {}
    for rid, i, gen, epoch, pred in answers:
        by_epoch[(gen, epoch)] = by_epoch.get((gen, epoch), 0) + 1
        served_err = max(served_err, float(np.abs(
            pred - refs[epoch][i]).max()))
    kernel = [(r["kernel_launches"]["flash_attention"],
               r["models"][P17_MODEL]["dispatches"]["total"])
              for r in replicas]
    compile_rec = respawn["compile"][P17_MODEL]
    parsed = parse_prometheus_text(metrics)
    labelled = sorted({dict(k[1]).get("replica") for k in parsed} - {None})
    out.update({"answers": len(answers), "by_epoch": by_epoch,
                "served_err": served_err, "kernel": kernel,
                "respawn_compile": compile_rec, "stats": stats,
                "exit_code": rc})
    phase(f"17a tier of {P17_REPLICAS} on {P17_DEVICE}: cold start "
          f"{out['cold_start_s']:.1f}s; clean {P17_LOAD_SECS:g}s windows, "
          f"{P17_CLIENTS} HTTP clients at bucket 8: router p50/p99 "
          f"{routed.percentiles()[0]:.1f}/{routed.percentiles()[1]:.1f} ms "
          f"({len(routed.lat)} answers), straight to replica 0 "
          f"{direct.percentiles()[0]:.1f}/{direct.percentiles()[1]:.1f} ms "
          f"({len(direct.lat)}), phase 16d direct p50/p99 {direct_ms}; "
          f"false ejections {false_ejections}")
    phase(f"17a SIGKILL replica 0 under traffic: readmitted "
          f"{out['kill_to_readmission_s']:.1f}s after the kill, "
          f"{out['respawn_to_readmission_s']:.1f}s after its respawn; "
          f"its kernel record {compile_rec}; events {sorted(names)}")
    for r in rolls:
        phase(f"17a POST /roll epoch {r['epoch']}: {r['state']} "
              f"{r['outcomes']}, decisions per replica {r['decisions']} "
              f"in {r['replica_s']} s; the POST took {r['wall_s']:.2f}s")
    phase(f"17a answers: {len(answers)} by (generation, epoch) {by_epoch}, "
          f"failed {len(failures)}; max |answer - its epoch's reference| "
          f"= {served_err:.3g} (bound {SERVE_TOL:g}); per replica "
          f"(flash_attention launches, dispatches) {kernel}; /metrics "
          f"replica labels {labelled}; router stats {stats}; SIGTERM "
          f"exit {rc}")
    if failures or not answers:
        raise AssertionError(f"17a: failed responses {failures[:3]}")
    if served_err > SERVE_TOL or {e for _, e in by_epoch} - {1, 2} \
            or ("live", 2) not in by_epoch:
        raise AssertionError(f"17a: answers off by {served_err:g}, "
                             f"by epoch {by_epoch}")
    if false_ejections:
        raise AssertionError(f"17a: {false_ejections} ejections under "
                             f"clean traffic")
    want = {"tier_replica_exit", "tier_replica_restarted",
            "tier_replica_readmitted", "tier_replica_ejected",
            "tier_roll_completed", "tier_roll_rolled_back"}
    if not want <= names:
        raise AssertionError(f"17a: events {sorted(names)}")
    if compile_rec.get("cache_misses") != 0 or (
            P17_DEVICE == "cuda"
            and compile_rec.get("libraries", {}).get("flash_attention")
            != "hit"):
        raise AssertionError(f"17a: the respawn's kernels {compile_rec}")
    if [(r["state"], r["outcomes"]) for r in rolls] != [
            ("promoted", ["promoted"] * P17_REPLICAS),
            ("rolled_back", ["rolled_back"])] \
            or rolls[1]["decisions"][1:] != [[]] * (P17_REPLICAS - 1):
        raise AssertionError(f"17a: rolls {rolls}")
    if validate_prometheus_text(metrics) or not labelled:
        raise AssertionError(f"17a: merged /metrics "
                             f"{validate_prometheus_text(metrics)[:3]}, "
                             f"replica labels {labelled}")
    if stats["responses_5xx"] or rc != 0:
        raise AssertionError(f"17a: 5xx {stats['responses_5xx']}, exit "
                             f"{rc}: {log[-3000:]}")
    if P17_DEVICE == "cuda" and any(
            launches != depth * d or d == 0 for launches, d in kernel):
        raise AssertionError(f"17a: flash_attention (launches, dispatches) "
                             f"per replica {kernel}, depth {depth}")
    return out


class P17AlwaysRegress(FaultInjector):
    """DEEPVISION_FAULT_PROMOTE_REGRESS=k:accuracy armed for every
    candidate epoch after `after`: each retry's new epoch regresses too."""

    def __init__(self, after: int):
        super().__init__()
        self.after = after

    def promote_regression(self, epoch):
        return ("accuracy" if epoch is not None and epoch > self.after
                else None)


def p17_wait_state(fw, want, what: str, secs: float = P17_TIMEOUT) -> None:
    deadline = time.monotonic() + secs
    while not want(fw) and time.monotonic() < deadline:
        time.sleep(0.05)
    if not want(fw):
        raise AssertionError(f"17b: {what}: {fw.describe()}")


def check_p17_flywheel(stash: str) -> dict:
    """17b: epoch 1 of phase 16's run served in-process over HTTP with the
    promotion gate and the flywheel ticking (`--flywheel-every`),
    DEEPVISION_FAULT_DRIFT_SHIFT armed; under in-process traffic one
    episode runs through drift, a fine-tune of 1 epoch x 2 batches at
    the config's batch on the card, commit, gate, canary and promotion;
    then every candidate regresses: the first refusal backs off, the drift
    is re-confirmed and a second fine-tune is refused, which opens the
    circuit at P17_MAX_ATTEMPTS. K1's launches equal depth x (fine-tune
    steps + dispatches of both generations), K2's 0; every answer equals
    its epoch's reference; one flywheel_id on the events, the spans, the
    decision record and /healthz."""
    cfg = get_config(P17_MODEL)
    depth = cfg.model_kwargs["depth"]
    workdir = p15_workdir("17b")
    p16_commit(stash, workdir, 1)
    rs = np.random.RandomState(171)
    shape = (cfg.data.image_size, cfg.data.image_size, cfg.data.channels)
    inputs = rs.rand(P16_INPUTS, *shape).astype(np.float32)
    os.environ["DEEPVISION_FAULT_DRIFT_SHIFT"] = P17_DRIFT
    try:
        server = build_server(p16_args(
            "--workdir", workdir, "-c", "1", "--buckets", "1,8,32",
            "--promote-gate", str(P17_GATE), "--canary-frac", "0.5",
            "--canary-window", str(P17_CANARY_WINDOW),
            "--flywheel-every", str(P17_FLYWHEEL_EVERY),
            "--trace-sample", "0"))
    finally:
        del os.environ["DEEPVISION_FAULT_DRIFT_SHIFT"]
    sm = server.fleet.default
    engine, promoter, fw = sm.engine, sm.promoter, sm.flywheel
    fw.max_attempts = P17_MAX_ATTEMPTS
    fw.finetune_batches = P17_FINETUNE_BATCHES
    fw.backoff_base_s = P17_BACKOFF_S
    answers, failures = [], []
    stop = threading.Event()

    def client(k: int) -> None:
        n = 0
        while not stop.is_set():
            i = (k + n) % P16_INPUTS
            fut = sm.submit(inputs[i][None])
            try:
                pred = result_within(fut, 120.0)
            except Exception as e:  # noqa: BLE001 — every failure counts
                failures.append((k, n, repr(e)))
                return
            answers.append((i, fut.generation,
                            fut.weights.get("checkpoint_epoch"), pred))
            n += 1

    flash_attention.launches = best_iou.launches = 0   # the main path
    engine.dispatches = 0
    engine.dispatches_by_generation.update(live=0, candidate=0)
    t0 = time.perf_counter()
    t, base = p16_serve(server)
    clients = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(P17_CLIENTS_B)]
    timings = {}
    try:
        for c in clients:
            c.start()
        p17_wait_state(fw, lambda f: f.counters["promoted"] >= 1
                       or f.failures, "no promoted episode")
        timings["episode_s"] = time.perf_counter() - t0
        promoted_epoch = engine.provenance["checkpoint_epoch"]
        fid = fw.last_flywheel_id
        promoted_health = p16_get(base, "/healthz")["models"][P17_MODEL][
            "flywheel"]
        # the promoted weights define normal now: a new drift, and every
        # candidate from here on regresses
        promoter.faults = P17AlwaysRegress(promoted_epoch)
        fw.monitor.faults = FaultInjector.from_env(
            {"DEEPVISION_FAULT_DRIFT_SHIFT": P17_DRIFT_AGAIN})
        t1 = time.perf_counter()
        p17_wait_state(fw, lambda f: f.state == "circuit_open",
                       "the circuit did not open")
        timings["refusals_s"] = time.perf_counter() - t1
        health = p16_get(base, "/healthz")
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=P16_TIMEOUT)
        fw.stop()
    launches, k2 = flash_attention.launches, best_iou.launches
    dispatches = engine.dispatches
    by_gen = dict(engine.dispatches_by_generation)
    states = [(r["decision"], r["epoch"], r.get("flywheel_id"))
              for r in promoter.history]
    spans = server.tracer.spans()
    p16_stop(server, t)

    steps = fw.finetune_steps
    events = p17_jsonl(os.path.join(workdir, "serve.jsonl"))
    fw_events = [e for e in events if e.get("flywheel_id") == fid]
    # each refusal but the last backs off before the circuit opens
    opened = [i for i, e in enumerate(events)
              if "resilience_flywheel_circuit_open" in e]
    backoffs = [e["resilience_flywheel_backoff_s"]
                for e in events[:opened[0] if opened else len(events)]
                if "resilience_flywheel_backoff_s" in e]
    keys = sorted({k for e in fw_events for k in e
                   if k.startswith("resilience_")})
    fw_spans = sorted({s["name"] for s in spans
                       if s["args"].get("flywheel_id") == fid})
    refs = {}
    for e in sorted({e for _, _, e, _ in answers}):
        src = stash if e == 1 else workdir
        eng = PredictEngine.from_config(P17_MODEL, device=P17_DEVICE,
                                        workdir=src, checkpoint=e,
                                        buckets=(1,), verbose=False)
        refs[e] = [eng.reference(x[None]) for x in inputs]
        del eng
    served_err, by_epoch = 0.0, {}
    for i, gen, epoch, pred in answers:
        by_epoch[(gen, epoch)] = by_epoch.get((gen, epoch), 0) + 1
        served_err = max(served_err, float(np.abs(
            pred - refs[epoch][i]).max()))
    record = health["models"][P17_MODEL]["flywheel"]
    out = {"launches": launches, "dispatches": dispatches,
           "by_generation": by_gen, "finetune_steps": steps,
           "counters": dict(fw.counters), "decisions": states,
           "timings": timings, "served_err": served_err,
           "by_epoch": by_epoch, "flywheel_id": fid,
           "backoffs": backoffs}
    phase(f"17b flywheel: promoted epoch {promoted_epoch} "
          f"{timings['episode_s']:.1f}s after the traffic started, circuit "
          f"open {timings['refusals_s']:.1f}s later; counters "
          f"{fw.counters}; decisions {states}; backoffs before the "
          f"circuit opened {backoffs} s")
    phase(f"17b {fid}: events {keys}; spans {fw_spans}; /healthz after "
          f"the promotion: flywheel_id {promoted_health['flywheel_id']}, "
          f"counters {promoted_health['counters']}; at the end: state "
          f"{record['state']}, {record['finetune_steps']} fine-tune steps")
    phase(f"17b main path: {dispatches} dispatches ({by_gen}) + {steps} "
          f"fine-tune steps, {launches} flash_attention launches (depth "
          f"{depth}), best_iou {k2}; {len(answers)} answers by (generation,"
          f" epoch) {by_epoch}, max |answer - its epoch's reference| = "
          f"{served_err:.3g}; failed {len(failures)}")
    if failures or served_err > SERVE_TOL or not answers:
        raise AssertionError(f"17b: failures {failures[:3]}, answers off "
                             f"by {served_err:g}")
    if launches != depth * (steps + dispatches) or k2 != 0 or not steps:
        raise AssertionError(f"17b: flash_attention ran {launches} times "
                             f"for {steps} steps and {dispatches} "
                             f"dispatches of depth {depth}; best_iou {k2}")
    want = [("promoted", promoted_epoch, fid)] + [
        ("refused_gate", promoted_epoch + k + 1, None)
        for k in range(P17_MAX_ATTEMPTS)]
    if [(d, e, f == fid if i == 0 else None)
            for i, (d, e, f) in enumerate(states)] != [
            (d, e, True if i == 0 else None)
            for i, (d, e, _) in enumerate(want)] \
            or fw.counters["circuit_opened"] != 1 or not opened \
            or len(backoffs) != P17_MAX_ATTEMPTS - 1:
        raise AssertionError(f"17b: decisions {states}, counters "
                             f"{fw.counters}, backoffs {backoffs}")
    need = {"resilience_flywheel_drift_detected",
            "resilience_flywheel_finetuning", "resilience_flywheel_gating",
            "resilience_flywheel_promoted", "resilience_promote_promoted"}
    if not need <= set(keys) or record["state"] != "circuit_open" \
            or record["finetune_steps"] != steps \
            or promoted_health["flywheel_id"] != fid \
            or not {"flywheel_finetune", "flywheel_train_epoch",
                    "flywheel_gate"} <= set(fw_spans):
        raise AssertionError(f"17b: {fid} events {keys}, spans {fw_spans}, "
                             f"/healthz {promoted_health}, {record}")
    return out


def p17_jsonl(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def check_tier_and_flywheel(stash: str, direct_ms) -> dict:
    """Phase 17, slice 14: the replica tier (17a, K1 in every replica) and
    the flywheel (17b, K1 on its main path: the counts zeroed just before
    its traffic, read just after)."""
    t0 = time.perf_counter()
    out = {"17a": check_p17_tier(stash, direct_ms)}
    phase(f"17a: {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    out["17b"] = check_p17_flywheel(stash)
    phase(f"17b: {time.perf_counter() - t1:.1f}s")
    phase(f"17: phase 17 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 18: real datasets, the decode on the card --------------------------

P18_DEVICE = "cuda"
P18_SIZES = ((375, 500), (500, 375))      # (h, w), alternating
P18_QUALITY = 90                           # 4:2:0
P18_GRAY_EVERY = 32                        # one grayscale image in 32
P18_UNIQUE = 64                            # distinct images a dataset
P18_INET_TRAIN = 512                       # ImageNet-format records: train
P18_INET_FILES = 2
P18_INET_VAL = 256                         # one eval batch of 256
P18_DECODE_BATCH = 256
P18_DECODE_REPS = 5
P18_FIXTURES = os.path.join(HERE, "tests", "fixtures", "jpeg")
# nvJPEG against the fixtures' PIL (= libjpeg ISLOW) goldens: a different
# IDCT and chroma upsampling, measured at most 4 levels on the H100 (the
# mean under 0.7); held at 6
P18_DECODE_TOL = 6
# the resample kernel against its plain version on the same decoded
# pixels: f32 within 1e-3 on the [0, 255] scale before normalisation
# (summation order), uint8 within 1 level (a rounding tie)
P18_RESAMPLE_TOL = 1e-3
P18_RESNET_BATCH = 256
P18_RESNET_STEPS = 3
P18_VIT_STEPS = 2
P18_LOADER_BATCHES = 6                     # the loader alone, after 1
P18_YOLO_BATCH = 16
P18_YOLO_STEPS = 3
P18_YOLO_VAL = 20                          # 16 + a ragged 4
P18_YOLO_LR = "1e-4"
# --eval-only's loss against the training run's own evaluation of the same
# weights on the same val batch (one process, the same kernels)
P18_EVAL_RTOL = 1e-3
P18_POSE_BATCH = 16
P18_POSE_STEPS = 2
P18_POSE_VAL = 128                         # the config's batch: one batch
P18_CG_BATCH = 8                           # the config's batch
P18_CG_STEPS = 2
P18_SIZE = None                            # the configs' own sizes
P18_SYNSETS = 8                            # ILSVRC tree: synsets
P18_COCO_TRAIN = 16
P18_COCO_VAL = 20                          # evaluate.py: 16 + a ragged 4
# sources the builders re-encode: committed, with PIL's re-encodes of them
P18_REENCODE_FIXTURES = os.path.join(HERE, "tests", "fixtures", "reencode")
P18_ODD_FILES = {
    "inet": {"n10000001_gray.JPEG": "gray.jpg",
             "n10000001_png.JPEG": "rgb_png.png"},  # a PNG named .JPEG
    "mpii": {"gray.jpg": "gray.jpg", "png.png": "rgb_png.png"},
    "coco": {"000000999000.jpg": "gray.jpg",
             "000000999001.jpg": "rgb_png.png"},
    "cyclegan": {"png.png": "rgb_png.png", "gray.jpg": "gray.jpg"},
}
P18_ODD = ("gray.jpg", "rgb_png.png")
# the card's re-encode (nvJPEG, q95 4:2:0) against PIL's of the same
# sources, both decoded by nvJPEG: measured at most 15 levels, mean 2.15
# over the six fixtures of tests/fixtures/reencode on the H100; held at
P18_REENCODE_MAX = 20
P18_REENCODE_MEAN = 3.0
# the kernel name the profile of 18c must hold (K1's CUDA kernel)
P18_K1_KERNEL = "flash_attention_fwd"


def p18_image(h: int, w: int, gen: torch.Generator, device,
              gray: bool = False) -> torch.Tensor:
    """A seeded (h, w, 3) uint8 image on `device` (one channel when
    `gray`): gradients, a disc and noise, so the JPEG has edges and flat
    areas."""
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None, None]
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :, None]
    c = torch.arange(3, device=device, dtype=torch.float32)[None, None, :]
    phase_ = torch.rand((), generator=gen, device=device) * 6
    base = 128 + 90 * torch.sin(x / (9 + 4 * c) + c + phase_) \
        * torch.cos(y / (13 + c))
    disc = ((y - h / 2) ** 2 + (x - w / 3) ** 2 < (min(h, w) / 4) ** 2)
    noise = torch.randn((h, w, 3), generator=gen, device=device) * 10
    img = (base + 60 * disc * (1 - 2 * (c % 2)) + noise).clamp(0, 255)
    img = img.to(torch.uint8)
    return img[..., 0].contiguous() if gray else img


def p18_jpegs(n: int, seed: int, device) -> list:
    """n JPEGs at P18_SIZES, 4:2:0 at P18_QUALITY, one grayscale in
    P18_GRAY_EVERY: P18_UNIQUE seeded images encoded by the decoder
    library's nvJPEG encoder on the card (PIL on the CPU), repeated."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i in range(min(n, P18_UNIQUE)):
        h, w = P18_SIZES[i % len(P18_SIZES)]
        gray = i % P18_GRAY_EVERY == P18_GRAY_EVERY - 1
        out.append(jpeg.encode_jpeg(p18_image(h, w, gen, device, gray),
                                    P18_QUALITY, "gray" if gray else "420"))
    return [out[i % len(out)] for i in range(n)]


def p18_write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)


def p18_odd(name: str) -> bytes:
    """A committed source the builders re-encode (P18_ODD)."""
    with open(os.path.join(P18_REENCODE_FIXTURES, name), "rb") as fh:
        return fh.read()


def p18_odd_names(tag: str) -> dict:
    """{file name in tree `tag`, as `image/filename` records it: the
    committed source it holds} (P18_ODD_FILES)."""
    return dict(P18_ODD_FILES[tag])


def p18_tree_imagenet(root: str, device) -> list:
    """An ILSVRC tree: `train/<synset>/<synset>_<i>.JPEG` (P18_INET_TRAIN
    seeded JPEGs over P18_SYNSETS synsets, plus the gray JPEG and a PNG
    named .JPEG), `validation/ILSVRC2012_val_<n>.JPEG` (P18_INET_VAL),
    `synsets.txt`, the metadata file and the validation labels."""
    synsets = [f"n{10000001 + k:08d}" for k in range(P18_SYNSETS)]
    datas = p18_jpegs(P18_INET_TRAIN, 1, device)
    for i, data in enumerate(datas):
        s = synsets[i % P18_SYNSETS]
        p18_write(os.path.join(root, "train", s, f"{s}_{i}.JPEG"), data)
    for name, src in p18_odd_names("inet").items():
        p18_write(os.path.join(root, "train", name.split("_")[0], name),
                  p18_odd(src))
    for i, data in enumerate(p18_jpegs(P18_INET_VAL, 2, device)):
        p18_write(os.path.join(root, "validation",
                               f"ILSVRC2012_val_{i + 1:08d}.JPEG"), data)
    with open(os.path.join(root, "synsets.txt"), "w") as fh:
        fh.write("".join(f"{s}\n" for s in synsets))
    with open(os.path.join(root, "metadata.txt"), "w") as fh:
        fh.write("".join(f"{s}\tclass {k}\n" for k, s in enumerate(synsets)))
    with open(os.path.join(root, "val_labels.txt"), "w") as fh:
        fh.write("".join(f"{synsets[i % P18_SYNSETS]}\n"
                         for i in range(P18_INET_VAL)))
    return datas


def p18_boxes(rs: np.random.RandomState, w: int, h: int) -> list:
    """1-5 seeded pixel boxes (x1, y1, x2, y2) inside a w x h image."""
    out = []
    for _ in range(rs.randint(1, 6)):
        x1, y1 = rs.uniform(0, 0.6, 2) * (w, h)
        bw, bh = rs.uniform(0.1, 0.4, 2) * (w, h)
        out.append((int(x1), int(y1), int(min(x1 + bw, w)),
                    int(min(y1 + bh, h))))
    return out


def p18_tree_voc(root: str, device) -> str:
    """`VOCdevkit/VOC2007`: JPEGImages, an XML annotation an image with
    1-5 boxes of the 20 VOC classes (some difficult) and ImageSets/Main
    train and val lists (the 4:2:0 JPEGs go in as they are: VOC's builder
    copies the bytes)."""
    from deepvision_tpu_torch.data.class_names import VOC_CLASS_NAMES
    devkit = os.path.join(root, "VOCdevkit", "VOC2007")
    n_train = P18_YOLO_BATCH * P18_YOLO_STEPS
    rs = np.random.RandomState(3)
    split = {"train": [], "val": []}
    for i, data in enumerate(p18_jpegs(n_train + P18_YOLO_VAL, 3, device)):
        name = f"{i:06d}"
        h, w, _ = jpeg.extract_jpeg_shape(data)
        p18_write(os.path.join(devkit, "JPEGImages", f"{name}.jpg"), data)
        objs = "".join(
            f"<object><name>{VOC_CLASS_NAMES[rs.randint(20)]}</name>"
            f"<difficult>{int(rs.rand() < 0.1)}</difficult><bndbox>"
            f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
            f"<ymax>{y2}</ymax></bndbox></object>"
            for x1, y1, x2, y2 in p18_boxes(rs, w, h))
        p18_write(os.path.join(devkit, "Annotations", f"{name}.xml"), (
            f"<annotation><filename>{name}.jpg</filename><size><width>{w}"
            f"</width><height>{h}</height><depth>3</depth></size>{objs}"
            f"</annotation>").encode())
        split["train" if i < n_train else "val"].append(name)
    for s, names in split.items():
        p18_write(os.path.join(devkit, "ImageSets", "Main", f"{s}.txt"),
                  "".join(f"{n}\n" for n in names).encode())
    return devkit


def p18_tree_mpii(root: str, device) -> None:
    """`mpii/images/` and `mpii_human_pose_v1_u12_2/{train,validation}.json`:
    16 joints in pixels, about a fifth missing (-1, visibility 0); the
    first image has none; the gray JPEG and the PNG among the train
    images."""
    rs = np.random.RandomState(5)
    n_train = P18_POSE_BATCH * P18_POSE_STEPS
    items = [(f"{i:05d}.jpg", data) for i, data in enumerate(
        p18_jpegs(n_train + P18_POSE_VAL, 5, device))]
    items[1:1] = [(name, p18_odd(src))
                  for name, src in p18_odd_names("mpii").items()]
    annos = {"train.json": [], "validation.json": []}
    for i, (name, data) in enumerate(items):
        p18_write(os.path.join(root, "mpii", "images", name), data)
        h, w = images_shape(data)
        missing = (rs.rand(16) < 0.2) | (i == 0)
        joints = [[-1, -1] if m else [float(rs.uniform(0.2, 0.8) * w),
                                      float(rs.uniform(0.2, 0.8) * h)]
                  for m in missing]
        vis = [0 if m else int(rs.randint(1, 3)) for m in missing]
        annos["train.json" if i < n_train + len(P18_ODD) else
              "validation.json"].append(
            {"image": name, "joints": joints, "joints_vis": vis})
    for fname, rows in annos.items():
        p18_write(os.path.join(root, "mpii_human_pose_v1_u12_2", fname),
                  json.dumps(rows).encode())


def images_shape(data: bytes) -> tuple:
    """(height, width) of a JPEG or PNG from its header."""
    from deepvision_tpu_torch.datasets.images import probe
    _, w, h, _ = probe(data, "source")
    return h, w


P18_COCO_CATS = ((1, "person"), (3, "car"), (18, "dog"), (90, "toothbrush"))


def p18_tree_coco(root: str, device) -> None:
    """`annotations/instances_{train,val}2017.json` and the
    `{train,val}2017/<id>.jpg` images (COCO's (x, y, w, h) boxes, some
    overhanging the edge, sparse category ids); the PNG among the train
    images."""
    rs = np.random.RandomState(8)
    for split, n, seed in (("train", P18_COCO_TRAIN, 8),
                           ("val", P18_COCO_VAL, 9)):
        items = [(7 * i + 1, d) for i, d in enumerate(p18_jpegs(n, seed,
                                                               device))]
        if split == "train":
            items += [(int(name[:-4]), p18_odd(src))
                      for name, src in p18_odd_names("coco").items()]
        annos = []
        for iid, data in items:
            p18_write(os.path.join(root, f"{split}2017",
                                   f"{str(iid).rjust(12, '0')}.jpg"), data)
            h, w = images_shape(data)
            for x1, y1, x2, y2 in p18_boxes(rs, w, h):
                annos.append({"image_id": iid, "category_id": int(
                    P18_COCO_CATS[rs.randint(len(P18_COCO_CATS))][0]),
                    "bbox": [x1 - 0.5, y1, x2 - x1 + 1.0, y2 - y1]})
        p18_write(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"),
                  json.dumps({"categories": [{"id": i, "name": n} for i, n
                                             in P18_COCO_CATS],
                              "annotations": annos}).encode())


def p18_tree_cyclegan(root: str, device) -> None:
    """`datasets/toy/{trainA,trainB}/`: the two domains, the PNG in A and
    the gray JPEG in B."""
    odd = list(p18_odd_names("cyclegan").items())   # A's, then B's
    for k, dom in enumerate("AB"):
        d = os.path.join(root, "datasets", "toy", f"train{dom}")
        for i, data in enumerate(p18_jpegs(P18_CG_BATCH * P18_CG_STEPS,
                                           7 + k, device)):
            p18_write(os.path.join(d, f"{i:04d}.jpg"), data)
        name, src = odd[k]
        p18_write(os.path.join(d, name), p18_odd(src))


def p18_built(tag: str, out: str, seconds: float, crc) -> dict:
    """What a builder wrote to `out` in `seconds`: records (CRCs checked
    by `crc`), files, bytes and images/s."""
    files = recs.list_files(os.path.join(out, "*"), training=False)
    n = sum(1 for f in files for _ in recs.read_records(f, crc=crc))
    nbytes = sum(os.path.getsize(f) for f in files)
    phase(f"18: builder {tag}: {n} records in {len(files)} files, "
          f"{nbytes / 2**20:.2f} MiB written, {seconds:.2f}s, "
          f"{n / seconds:.1f} images/s")
    return {"records": n, "files": len(files), "bytes": nbytes,
            "seconds": seconds, "images_per_sec": n / seconds}


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def p18_reencodes(outs: dict, device) -> dict:
    """The builders' re-encodes of the committed sources (found by
    `image/filename`) against PIL's re-encodes of the same sources
    (`<name>.pil95.jpg`), both decoded by the same decoder: the largest
    and mean level difference, held to P18_REENCODE_MAX and _MEAN."""
    device = torch.device(device)
    crc = jpeg.host_crc32c(device)
    found = {}
    for tag, out in outs.items():
        names = p18_odd_names(tag)
        for f in recs.list_files(os.path.join(out, "*"), training=False):
            for rec in recs.read_records(f, crc=crc):
                ex = recs.parse_example(rec)
                fname = recs.feature_values(ex, "image/filename", "bytes")
                if fname and fname[0].decode() in names:
                    found[(tag, fname[0].decode())] = (
                        names[fname[0].decode()],
                        recs.feature_values(ex, "image/encoded",
                                            "bytes")[0])
    want = sum(len(p18_odd_names(t)) for t in outs)
    if len(found) != want:
        raise AssertionError(f"18: {len(found)} of {want} re-encoded "
                             f"sources found in the records: {sorted(found)}")
    rows = {}
    for (tag, name), (src, ours) in sorted(found.items()):
        pil = p18_odd(os.path.splitext(src)[0] + ".pil95.jpg")
        if jpeg.extract_jpeg_shape(ours)[2] != 3:
            raise AssertionError(f"18: {tag} {name} is not an RGB JPEG")
        a, b = (jpeg.decode_batch([x], device).image(0).cpu().numpy()
                .astype(np.int16) for x in (ours, pil))
        diff = np.abs(a - b)
        rows[f"{tag}/{name}"] = (int(diff.max()), float(diff.mean()))
    worst = max(v[0] for v in rows.values())
    mean = max(v[1] for v in rows.values())
    phase("18: the builders' re-encodes against PIL's (quality 95) of the "
          "same sources, decoded alike (max, mean levels): "
          + "; ".join(f"{k} {m}, {e:.3f}" for k, (m, e) in rows.items())
          + f"; bound {P18_REENCODE_MAX}, {P18_REENCODE_MEAN}")
    if worst > P18_REENCODE_MAX or mean > P18_REENCODE_MEAN:
        raise AssertionError(f"18: a re-encode differs from PIL's by "
                             f"{worst} (mean {mean:.3f})")
    return rows


def p18_datasets(root: str, device) -> dict:
    """Phase 18's raw trees, written from seeded images, then the port's
    builders over them on `device`: VOC2007 as a user runs it (`python -m
    ...voc2007`, started first, in the background), the others in
    process. Returns the records' directories."""
    device = torch.device(device)
    t0 = time.perf_counter()
    raw = {k: os.path.join(root, "raw", k)
           for k in ("imagenet", "voc", "mpii", "coco", "cyclegan")}
    out = {k: os.path.join(root, k) for k in ("inet", "voc", "mpii", "coco",
                                              "cyclegan")}
    # the VOC tree first: its builder starts as a process of its own at
    # once and runs while the other trees are written and built
    p18_tree_voc(raw["voc"], device)
    voc_cmd = [sys.executable, "-m", "deepvision_tpu_torch.datasets.voc2007",
               "--out", out["voc"], "--device", device.type]
    t_voc = time.perf_counter()
    path = os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH"))
                           if p)
    voc_proc = subprocess.Popen(voc_cmd, cwd=raw["voc"],
                                env={**os.environ, "PYTHONPATH": path},
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        train = p18_tree_imagenet(raw["imagenet"], device)
        p18_tree_mpii(raw["mpii"], device)
        p18_tree_coco(raw["coco"], device)
        p18_tree_cyclegan(raw["cyclegan"], device)
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs_ in os.walk(os.path.join(root, "raw"))
                     for f in fs_)
        phase(f"18: raw trees written in {time.perf_counter() - t0:.1f}s "
              f"({nbytes / 2**20:.1f} MiB): ILSVRC {P18_INET_TRAIN} + "
              f"{len(P18_ODD)} train in {P18_SYNSETS} synsets and "
              f"{P18_INET_VAL} validation, VOCdevkit "
              f"{P18_YOLO_BATCH * P18_YOLO_STEPS} + {P18_YOLO_VAL}, MPII "
              f"{P18_POSE_BATCH * P18_POSE_STEPS} + {len(P18_ODD)} + "
              f"{P18_POSE_VAL}, COCO {P18_COCO_TRAIN} + 1 + {P18_COCO_VAL}, "
              f"CycleGAN {P18_CG_BATCH * P18_CG_STEPS} + 1 a domain; the "
              f"gray JPEG and the PNG of {P18_REENCODE_FIXTURES}; mean JPEG "
              f"{np.mean([len(b) for b in train]) / 1024:.1f} KiB")
        from deepvision_tpu_torch.datasets import (coco, cyclegan, imagenet,
                                                   images, mpii)
        dev = str(device)
        r = raw["imagenet"]
        walls = {"imagenet": timed(lambda: imagenet.main([
            "--train_directory", os.path.join(r, "train"),
            "--validation_directory", os.path.join(r, "validation"),
            "--output_directory", out["inet"],
            "--labels_file", os.path.join(r, "synsets.txt"),
            "--imagenet_metadata_file", os.path.join(r, "metadata.txt"),
            "--validation_labels_file", os.path.join(r, "val_labels.txt"),
            "--train_shards", str(P18_INET_FILES), "--validation_shards",
            "1", "--num_workers", "1", "--device", dev]))}
        walls["mpii"] = timed(lambda: mpii.convert(
            os.path.join(raw["mpii"], "mpii_human_pose_v1_u12_2"),
            os.path.join(raw["mpii"], "mpii", "images"), out["mpii"],
            device=dev, num_workers=1))
        walls["coco"] = timed(lambda: coco.convert(
            os.path.join(raw["coco"], "annotations"), out["coco"], "2017",
            raw["coco"], device=dev, num_workers=1))
        walls["cyclegan"] = timed(lambda: cyclegan.convert(
            "toy", os.path.join(raw["cyclegan"], "datasets"),
            out["cyclegan"], dev))
        # a CMYK JPEG is refused by name on the card (nvJPEG decodes none
        # to RGB); the CPU re-encodes it with PIL
        if device.type == "cuda":
            try:
                images.load(os.path.join(P18_REENCODE_FIXTURES, "cmyk.jpg"),
                            "cuda")
            except images.UnsupportedImageError as e:
                phase(f"18: refused by name on the card: {e}")
            else:
                raise AssertionError("18: a CMYK JPEG was not refused")
        rows = p18_reencodes(
            {"inet": out["inet"], "mpii": out["mpii"], "coco": out["coco"],
             "cyclegan": os.path.join(out["cyclegan"], "toy")}, device)
    finally:
        try:
            voc_out, _ = voc_proc.communicate(timeout=P16_TIMEOUT)
        except subprocess.TimeoutExpired:
            voc_proc.kill()
            voc_out, _ = voc_proc.communicate()
    walls["voc2007"] = time.perf_counter() - t_voc
    if voc_proc.returncode != 0:
        raise AssertionError(f"18: {' '.join(voc_cmd)} exited "
                             f"{voc_proc.returncode}: {voc_out[-2000:]}")
    crc = jpeg.host_crc32c(device)
    built = {tag: p18_built(tag, d, walls[tag], crc) for tag, d in (
        ("imagenet", out["inet"]), ("mpii", out["mpii"]),
        ("coco", out["coco"]),
        ("cyclegan", os.path.join(out["cyclegan"], "toy")),
        ("voc2007", out["voc"]))}
    phase("18: voc2007 ran as `python -m deepvision_tpu_torch.datasets."
          "voc2007` in the background from the start (its wall includes "
          "the interpreter's start)")
    phase(f"18: trees and builders took {time.perf_counter() - t0:.1f}s")
    return {**out, "inet_train": train, "builders": built, "reencode": rows}


def check_decoder(datas: list, device) -> dict:
    """18a: the committed fixtures decoded and held to their goldens (PIL,
    = TensorFlow's INTEGER_ACCURATE) within P18_DECODE_TOL, with the gap
    to TensorFlow's default decode reported; the resample kernel against
    its plain version; one batch of P18_DECODE_BATCH timed."""
    device = torch.device(device)
    fixtures = []
    for name in sorted(f[:-4] for f in os.listdir(P18_FIXTURES)
                       if f.endswith(".jpg")):
        with open(os.path.join(P18_FIXTURES, name + ".jpg"), "rb") as fh:
            data = fh.read()
        got = jpeg.decode_batch([data], device).image(0).cpu().numpy()
        row = {"name": name}
        for golden in ("pil", "tf"):
            want = np.load(os.path.join(P18_FIXTURES,
                                        f"{name}.{golden}.npy"))
            if got.shape != want.shape:
                raise AssertionError(f"18a {name}: {got.shape} vs "
                                     f"{want.shape}")
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            row[golden] = (int(diff.max()), float(diff.mean()))
        fixtures.append(row)
    worst = max(r["pil"][0] for r in fixtures)
    phase("18a decoder vs the fixtures' goldens (max, mean abs levels): "
          + "; ".join(f"{r['name']}: PIL/INTEGER_ACCURATE {r['pil'][0]}, "
                      f"{r['pil'][1]:.3f}, TF default {r['tf'][0]}, "
                      f"{r['tf'][1]:.3f}" for r in fixtures)
          + f"; bound {P18_DECODE_TOL}")
    if worst > P18_DECODE_TOL:
        raise AssertionError(f"18a: decode differs from libjpeg by {worst}")

    batch = datas[:P18_DECODE_BATCH]
    shapes = [jpeg.extract_jpeg_shape(b)[:2] for b in batch]
    jpeg.zero_stats()
    times, walls = [], []
    cuda = device.type == "cuda"
    for i in range(P18_DECODE_REPS + 1):
        sync(device)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        decoded = jpeg.decode_batch(batch, device, shapes)
        if cuda:
            end.record()
        sync(device)
        if i:
            walls.append(time.perf_counter() - t0)
            times.append(start.elapsed_time(end) if cuda
                         else float("nan"))
    routes = dict(jpeg.stats)
    ms, wall = statistics.median(times), statistics.median(walls)
    # the resample kernel against its plain version on the same pixels
    plans = [util.Plan((3, 5, h - 7, w - 11), (256, 256), (16, 16),
                       bool(i % 2)) for i, (h, w) in enumerate(shapes[:8])]
    host = [decoded.image(i).cpu() for i in range(8)]
    cut = (jpeg.Decoded(shapes[:8], images=decoded.images[:8])
           if decoded.images is not None else
           jpeg.Decoded(shapes[:8], flat=decoded.flat,
                        offsets=decoded.offsets[:8]))
    errs = {}
    for mode in util.MODES:
        for how in (util.UINT8, util.Emit(uint8=False, clip=False, div=1.0)):
            got = jpeg.resample_batch(cut, plans, (224, 224), mode, how)
            want = util.resample(host, plans, (224, 224), mode, how)
            errs[(mode, how.uint8)] = float(
                (got.cpu().float() - want.float()).abs().max())
    phase(f"18a decode of {len(batch)} JPEGs ({shapes[0]}/{shapes[1]}, "
          f"4:2:0 q{P18_QUALITY}, one gray in {P18_GRAY_EVERY}): "
          f"{ms:.3f} device ms a batch (CUDA events, median of "
          f"{P18_DECODE_REPS} after 1), {wall * 1e3:.3f} ms host wall, "
          f"{len(batch) / wall:.1f} images/s; routes {routes}; "
          f"{jpeg.decoder_record()}")
    phase("18a resample kernel vs its plain version (8 images, 224 px "
          "window of a 256 resize, half flipped), max abs: "
          + ", ".join(f"{m} {'u8' if u8 else 'f32'} {e:.3g}"
                      for (m, u8), e in errs.items()))
    for (mode, u8), e in errs.items():
        if e > (1.0 if u8 else P18_RESAMPLE_TOL):
            raise AssertionError(f"18a resample {mode} u8={u8}: {e}")
    return {"fixtures": fixtures, "decode_ms": ms, "wall_ms": wall * 1e3,
            "images_per_sec": len(batch) / wall, "routes": routes,
            "resample_err": {f"{m}_{'u8' if u8 else 'f32'}": e
                             for (m, u8), e in errs.items()}}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_data_wait_ms(trainer) -> float:
    """The trainer's `host_data_wait` spans (--trace-out), summed, in
    ms."""
    return sum(s["dur"] for s in trainer.tracer.spans()
               if s["name"] == "host_data_wait") / 1e6


def p18_entry(family: str, model: str, root: str, tag: str, extra: list,
              device) -> tuple:
    """One entry point on the records; its trainer, result and wall."""
    wd = tempfile.mkdtemp(prefix=f"chip_smoke_p18{tag}_")
    atexit.register(shutil.rmtree, wd, ignore_errors=True)
    argv = ["-m", model, "--data-dir", root, "--epochs", "1",
            "--device", str(device), "--workdir", wd,
            "--trace-out", os.path.join(wd, "trace.json")] + extra
    if P18_SIZE:
        argv += ["--image-size", str(P18_SIZE)]
    t0 = time.perf_counter()
    trainer, result = family_main(family, argv)
    steps = trainer.last_epoch_steps
    if not steps or not all(np.isfinite(v) for s in steps
                            for v in s.values()):
        raise AssertionError(f"18{tag} {model}: steps {steps}")
    return trainer, result, time.perf_counter() - t0, wd


def check_records_resnet(paths: dict, device) -> dict:
    """18b: resnet50_tpu at full width from the ImageNet records, under
    --device-augment and --device-normalize: step_ms, host_data_wait a
    step, the prefetcher's staged bytes (0: the batches are built on the
    card), the compressed bytes the card received; then the loader
    alone."""
    from deepvision_tpu_torch.data import imagenet as inet
    out = {}
    batch = P18_RESNET_BATCH
    for flag in ("--device-augment", "--device-normalize"):
        jpeg.zero_stats()
        # --cache-val: the val records kept in host RAM after the first
        # pass (the cache itself is shown on the loader below)
        cache = ["--cache-val"] if flag == "--device-normalize" else []
        trainer, result, wall, _ = p18_entry(
            "ResNet", "resnet50_tpu", paths["inet"], "b",
            [flag, "--batch-size", str(batch), "--eval-batch-size",
             str(batch), "--steps-per-epoch", str(P18_RESNET_STEPS)]
            + cache, device)
        if trainer.config.data.cache_val != bool(cache):
            raise AssertionError(f"18b {flag}: cache_val "
                                 f"{trainer.config.data.cache_val}")
        steps = trainer.last_epoch_steps
        step_ms = statistics.median(s["step_ms"] for s in steps[1:])
        wait = host_data_wait_ms(trainer)
        ledger = trainer.last_prefetch_ledger
        staged = ledger.get("bytes_staged_total")
        # the consumer's wait after the first batch (the pipeline's fill:
        # the shuffle buffer takes a whole pass of these records first)
        steady = (ledger["wait_secs_total"] - ledger["first_wait_secs"]) \
            * 1e3 / max(1, len(steps) - 1)
        st = dict(jpeg.stats)
        images = P18_RESNET_STEPS * batch + batch
        phase(f"18b resnet50_tpu {flag} (224 px, batch {batch}, "
              f"{P18_RESNET_STEPS} steps + 1 eval batch from records): "
              f"losses {[round(s['loss'], 4) for s in steps]}, val "
              f"{result}, step_ms={step_ms:.3f} (median after the first; "
              f"first {steps[0]['step_ms']:.3f}), host_data_wait "
              f"{wait / len(steps):.3f} ms a step "
              f"({100 * wait / sum(s['step_ms'] for s in steps):.1f}% of "
              f"the steps' time; after the first batch {steady:.3f} ms a "
              f"step, first wait {ledger['first_wait_secs'] * 1e3:.1f} ms), "
              f"prefetcher staged {staged} bytes, the "
              f"card received {st['compressed_bytes']} compressed bytes "
              f"({st['compressed_bytes'] / images / 1024:.1f} KiB an "
              f"image) + {st['descriptor_bytes']} bytes of descriptors "
              f"for {images} images; entry point {wall:.1f}s")
        if staged != 0 or result.get("count") != batch:
            raise AssertionError(f"18b {flag}: staged {staged} bytes, "
                                 f"val {result}")
        if jpeg.images_decoded() < images:
            raise AssertionError(f"18b {flag}: decoded {st}")
        out[flag] = {"step_ms": step_ms, "first_step_ms":
                     steps[0]["step_ms"], "host_data_wait_ms_per_step":
                     wait / len(steps), "steady_wait_ms_per_step": steady,
                     "first_wait_ms": ledger["first_wait_secs"] * 1e3,
                     "staged_bytes": staged,
                     "compressed_bytes": st["compressed_bytes"],
                     "descriptor_bytes": st["descriptor_bytes"],
                     "images": images, "loss": [s["loss"] for s in steps]}
        del trainer
        torch.cuda.empty_cache()
    alone = {}
    for name, kw in (("device_augment", dict(host_decode_only=True)),
                     ("device_normalize", dict(normalize_on_host=False))):
        ds = inet.build_dataset(os.path.join(paths["inet"], "train*"),
                                batch_size=batch, training=True,
                                device=device, **kw)
        it = ds.batches(0)
        next(it)
        t0 = time.perf_counter()
        for _ in range(P18_LOADER_BATCHES):
            images, labels = next(it)
        sync(device)
        dt = time.perf_counter() - t0
        alone[name] = P18_LOADER_BATCHES * batch / dt
        if tuple(images.shape[1:3]) != ((256, 256) if name ==
                                        "device_augment" else (224, 224)) \
                and not P18_SIZE:
            raise AssertionError(f"18b loader {name}: {images.shape}")
    phase(f"18b the ImageNet loader alone on the card ({P18_LOADER_BATCHES} "
          f"batches of {batch} after 1, read + parse + nvJPEG + resample): "
          + ", ".join(f"{k} {v:.1f} images/s" for k, v in alone.items())
          + f" against resnet50_tpu's "
          f"{batch / out['--device-augment']['step_ms'] * 1e3:.1f} images/s"
          f" at its step_ms")
    out["loader_images_per_sec"] = alone
    out["cache_val"] = p18_cached_val(paths, device)
    return out


def p18_cached_val(paths: dict, device) -> dict:
    """The ImageNet val pipeline as `--cache-val` builds it, on the card:
    two passes, the validation file opened once, the batches equal."""
    from deepvision_tpu_torch.data import imagenet as inet
    opened = []
    read = recs.read_records

    def counting(path, **kw):
        opened.append(path)
        return read(path, **kw)

    ds = inet.build_dataset(os.path.join(paths["inet"], "val*"),
                            batch_size=P18_RESNET_BATCH, training=False,
                            normalize_on_host=False, cache=True,
                            device=device)
    recs.read_records = counting
    try:
        t0 = time.perf_counter()
        first = [b[0] for b in ds.batches(0)]
        sync(device)
        t1 = time.perf_counter()
        second = [b[0] for b in ds.batches(1)]
        sync(device)
        t2 = time.perf_counter()
    finally:
        recs.read_records = read
    same = len(first) == len(second) and all(
        torch.equal(a, b) for a, b in zip(first, second))
    phase(f"18b --cache-val's pipeline on the card: 2 passes of "
          f"{len(first)} batch(es), the val file opened {len(opened)} "
          f"time(s), batches equal {same}; first pass {1e3 * (t1 - t0):.1f}"
          f" ms, cached pass {1e3 * (t2 - t1):.1f} ms")
    if len(opened) != 1 or not same or not first:
        raise AssertionError(f"18b --cache-val: opened {opened}, equal "
                             f"{same}")
    return {"opened": len(opened), "first_ms": 1e3 * (t1 - t0),
            "cached_ms": 1e3 * (t2 - t1)}


def check_records_vit(paths: dict, device) -> dict:
    """18c: vit_small at full width from the same ImageNet records: K1's
    launches exactly depth x (train steps + eval batches)."""
    cfg = get_config("vit_small")
    depth = cfg.model_kwargs["depth"]
    batch = P18_RESNET_BATCH
    prof = tempfile.mkdtemp(prefix="chip_smoke_p18prof_")
    atexit.register(shutil.rmtree, prof, ignore_errors=True)
    flash_attention.launches = 0
    trainer, result, wall, _ = p18_entry(
        "ViT", "vit_small", paths["inet"], "c",
        ["--dataset", "imagenet", "--batch-size", str(batch),
         "--eval-batch-size", str(batch), "--steps-per-epoch",
         str(P18_VIT_STEPS), "--profile-dir", prof], device)
    launches = flash_attention.launches
    trace = os.path.join(prof, "vit_small.pt.trace.json")
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    k1 = [e for e in events if P18_K1_KERNEL in e.get("name", "")]
    phase(f"18c --profile-dir: {os.path.getsize(trace) / 2**20:.1f} MiB "
          f"trace of the first epoch, {len(events)} events, {len(k1)} "
          f"named {P18_K1_KERNEL!r} ({k1[0]['name'][:80] if k1 else ''})")
    if not k1:
        raise AssertionError(f"18c: the profile names no {P18_K1_KERNEL}")
    steps = trainer.last_epoch_steps
    want = depth * (P18_VIT_STEPS + 1)
    phase(f"18c vit_small (224 px, batch {batch}) from the ImageNet records: "
          f"losses {[round(s['loss'], 4) for s in steps]}, val {result}, "
          f"flash_attention launches {launches} (want {depth} x "
          f"({P18_VIT_STEPS} steps + 1 eval batch) = {want}); entry point "
          f"{wall:.1f}s")
    if launches != want or len(steps) != P18_VIT_STEPS:
        raise AssertionError(f"18c: {launches} K1 launches, want {want}")
    return {"launches": launches, "steps": len(steps), "eval_batches": 1}


def check_records_yolo(paths: dict, device, yolo_workdir: str) -> dict:
    """18d: yolov3 at 416 px from the VOC builder's records with
    `--num-classes 20`, K2 once a step and an eval batch; then
    `YOLO/torch/train.py -c latest --eval-only` on the val split read
    through a `file://` URL, K2 once an eval batch; then
    `YOLO/torch/evaluate.py` on phase 5's checkpoint (80 classes) over the
    COCO builder's val records, its ragged last batch kept."""
    best_iou.launches = 0
    trainer, result, wall, wd = p18_entry(
        "YOLO", "yolov3", paths["voc"], "d",
        ["--batch-size", str(P18_YOLO_BATCH), "--steps-per-epoch",
         str(P18_YOLO_STEPS), "--learning-rate", P18_YOLO_LR,
         "--num-classes", "20"], device)
    launches = best_iou.launches
    steps = trainer.last_epoch_steps
    classes = (trainer.config.data.num_classes, trainer.model.num_classes)
    eval_batches = P18_YOLO_VAL // P18_YOLO_BATCH    # drop_remainder
    want = P18_YOLO_STEPS + eval_batches
    phase(f"18d yolov3 --num-classes 20 (416 px, batch {P18_YOLO_BATCH}) "
          f"from the VOC builder's records: losses "
          f"{[round(s['loss'], 3) for s in steps]}, val {result}, "
          f"best_iou launches {launches} (want {want}: one a step and an "
          f"eval batch); step_ms "
          f"{statistics.median(s['step_ms'] for s in steps[1:]):.3f}; "
          f"entry point {wall:.1f}s")
    if launches != want or len(steps) != P18_YOLO_STEPS \
            or classes != (20, 20):
        raise AssertionError(f"18d: {launches} K2 launches, want {want}; "
                             f"classes {classes}")
    del trainer
    with open(os.path.join(wd, "yolov3.jsonl")) as fh:
        header = json.loads(fh.readline())
    meta = header.get("meta", {})
    phase(f"18d the run log's first line: {json.dumps(header)}")
    kind = (torch.cuda.get_device_name(device)
            if torch.device(device).type == "cuda" else "cpu")
    if list(meta) != ["platform", "device_kind", "n_devices", "process",
                      "torch_version", "started_at"] \
            or meta["device_kind"] != kind:
        raise AssertionError(f"18d: the run log's header is {header}")
    url = "file://" + os.path.abspath(paths["voc"])
    argv = ["-m", "yolov3", "--data-dir", url, "--workdir", wd, "-c",
            "latest", "--eval-only", "--num-classes", "20", "--batch-size",
            str(P18_YOLO_BATCH), "--device", str(device)]
    if P18_SIZE:
        argv += ["--image-size", str(P18_SIZE)]
    best_iou.launches = 0
    t0 = time.perf_counter()
    _, evaluated = family_main("YOLO", argv)
    eval_launches = best_iou.launches
    phase(f"18d YOLO/torch/train.py -c latest --eval-only on {url}/val*: "
          f"{evaluated}, best_iou launches {eval_launches} (want "
          f"{eval_batches}), the training run's own evaluation {result}; "
          f"{time.perf_counter() - t0:.1f}s")
    if eval_launches != eval_batches or evaluated.get("count") != \
            result.get("count") or not np.isclose(
                evaluated.get("loss", np.nan), result.get("loss"),
                rtol=P18_EVAL_RTOL):
        raise AssertionError(f"18d --eval-only: {evaluated} against "
                             f"{result}, {eval_launches} K2 launches")
    jpeg.zero_stats()
    t0 = time.perf_counter()
    argv = ["-m", "yolov3", "--data-dir", paths["coco"], "--workdir",
            yolo_workdir, "--device", str(device), "--metric", "coco"]
    if P18_SIZE:
        argv += ["--image-size", str(P18_SIZE)]
    metrics = runpy.run_path(os.path.join(HERE, "YOLO", "torch",
                                          "evaluate.py"),
                             run_name="chip_smoke")["main"](argv)
    st = dict(jpeg.stats)
    seen = jpeg.images_decoded()
    batch = get_config("yolov3").batch_size
    phase(f"18d YOLO/torch/evaluate.py (phase 5's checkpoint) on the COCO "
          f"builder's val records: {seen} of {P18_COCO_VAL} images decoded "
          f"in {st['decode_calls']} batches of up to {batch} (the ragged "
          f"last batch kept), mAP {metrics.get('mAP')}, mAP@0.5 "
          f"{metrics.get('mAP@0.5')}; {time.perf_counter() - t0:.1f}s")
    if seen != P18_COCO_VAL or not np.isfinite(metrics.get("mAP", np.nan)):
        raise AssertionError(f"18d evaluate: {seen} images, {metrics}")
    return {"launches": launches, "train_steps": len(steps),
            "eval_batches": eval_batches, "eval_only_launches":
            eval_launches, "eval_only": evaluated, "eval_images": seen,
            "mAP": metrics["mAP"]}


def check_records_pose_and_gan(paths: dict, device) -> dict:
    """18e: hourglass104 from the MPII-format records and
    Hourglass/torch/evaluate.py on their val split; cyclegan from its
    two-domain records."""
    trainer, result, wall, wd = p18_entry(
        "Hourglass", "hourglass104", paths["mpii"], "e",
        ["--batch-size", str(P18_POSE_BATCH), "--eval-batch-size",
         str(P18_POSE_VAL), "--steps-per-epoch", str(P18_POSE_STEPS)],
        device)
    steps = trainer.last_epoch_steps
    phase(f"18e hourglass104 (256 px, batch {P18_POSE_BATCH}) from MPII-"
          f"format records: losses {[round(s['loss'], 3) for s in steps]},"
          f" val {result}; entry point {wall:.1f}s")
    if len(steps) != P18_POSE_STEPS or result.get("count") != 1:
        raise AssertionError(f"18e hourglass104: {steps} {result}")
    del trainer
    argv = ["--data-dir", paths["mpii"], "--workdir", wd, "--device",
            str(device)]
    if P18_SIZE:
        argv += ["--image-size", str(P18_SIZE)]
    t0 = time.perf_counter()
    pckh = runpy.run_path(os.path.join(HERE, "Hourglass", "torch",
                                       "evaluate.py"),
                          run_name="chip_smoke")["main"](argv)
    phase(f"18e Hourglass/torch/evaluate.py on the val split: {pckh}; "
          f"{time.perf_counter() - t0:.1f}s")
    if not np.isfinite(pckh.get("PCKh@0.5", np.nan)):
        raise AssertionError(f"18e evaluate: {pckh}")
    wd_cg = tempfile.mkdtemp(prefix="chip_smoke_p18cg_")
    atexit.register(shutil.rmtree, wd_cg, ignore_errors=True)
    t0 = time.perf_counter()
    cg_trainer, metrics = runpy.run_path(
        os.path.join(HERE, "CycleGAN", "torch", "train.py"),
        run_name="chip_smoke")["main"](
        ["--dataset", "toy", "--tfrecords-dir", paths["cyclegan"],
         "--batch-size", str(P18_CG_BATCH), "--epochs", "1",
         "--image-size", str(P18_SIZE or 256), "--device", str(device),
         "--workdir", wd_cg])
    cg_steps = cg_trainer.last_epoch_steps
    phase(f"18e cyclegan ({P18_SIZE or 256} px, batch {P18_CG_BATCH}) from "
          f"two-domain records: {len(cg_steps)} steps, loss_gen_total "
          f"{metrics.get('loss_gen_total')}, loss_dis_total "
          f"{metrics.get('loss_dis_total')}; "
          f"{time.perf_counter() - t0:.1f}s")
    if len(cg_steps) != P18_CG_STEPS or not np.isfinite(
            metrics.get("loss_gen_total", np.nan)):
        raise AssertionError(f"18e cyclegan: {cg_steps} {metrics}")
    return {"pose_steps": len(steps), "pckh": pckh,
            "cyclegan_steps": len(cg_steps), "pose_workdir": wd}


def check_real_datasets(yolo_workdir: str) -> dict:
    """Phase 18, slices 15-16: raw trees built into records by the port's
    builders, and the record pipelines on the card. K1 on 18c's path and
    K2 on 18d's, each count zeroed just before its entry point and read
    just after. `yolo_workdir` holds phase 5's yolov3 checkpoint."""
    t0 = time.perf_counter()
    device = torch.device(P18_DEVICE)
    root = tempfile.mkdtemp(prefix="chip_smoke_p18_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    paths = p18_datasets(root, device)
    out = {"18a": check_decoder(paths["inet_train"], device)}
    out["18b"] = check_records_resnet(paths, device)
    torch.cuda.empty_cache()
    out["18c"] = check_records_vit(paths, device)
    torch.cuda.empty_cache()
    out["18d"] = check_records_yolo(paths, device, yolo_workdir)
    torch.cuda.empty_cache()
    out["18e"] = check_records_pose_and_gan(paths, device)
    out["decoder"] = jpeg.decoder_record()
    out["builders"] = paths["builders"]
    out["reencode"] = paths["reencode"]
    phase(f"18: phase 18 took {time.perf_counter() - t0:.1f}s")
    return out


P19_DEVICE = "cuda"
P19_MODEL = MODEL
P19_BATCH = 256
P19_STEPS = 3
P19_MIXUP = 0.2
# 19a: remat against no remat, the largest relative difference of a
# step's loss and grad_norm (bf16 on the card; the recompute is the same
# arithmetic, and the card gave it bit for bit: 0 measured, PERF.md)
P19_REMAT_RTOL = 1e-4
P19_B_STEPS = 10               # 19b: 5 dispatches of 2
P19_B_BATCH = 64               # 19b's host synthetic batches
P19_K = 2
P19_YOLO_SIZE = 416
P19_YOLO_BATCH = 16
P19_YOLO_STEPS = 3
P19_YOLO_LR = "1e-3"
P19_OVERFLOW_BYTES = 1 << 20   # 19c's overflow run: a 1 MiB budget
P19_RESNET_BATCH = 256
P19_RESNET_STEPS = 8
P19_RESNET_K = 4
# 19d: k = 4 against k = 1, the parameters' largest difference over their
# largest entry (cuDNN's backward need not be bitwise deterministic; the
# card gave 0 between two k = 1 runs and between k = 4 and k = 1, PERF.md)
P19_K_RTOL = 1e-3
P19_JPEG = os.path.join(HERE, "tests", "fixtures", "jpeg", "q90_420.jpg")
# 19e: a top-5 place where the tool and the engine differ must be a near
# tie: their probabilities within this much
P19_TIE = 1e-3


def p19_jsonl(workdir: str, name: str) -> list:
    with open(os.path.join(workdir, f"{name}.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def p19_batches(n: int, batch: int, size: int, classes: int, device,
                uint8: bool = False, seed: int = 1) -> list:
    """`n` (images, labels) batches drawn on `device` from a seeded
    generator: the card's steps are timed without the host's synthetic
    generator in front of them (at batch 256 and 224 px it makes about
    one batch a second)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, size, size, 3)
    out = []
    for _ in range(n):
        images = (torch.randint(0, 256, shape, generator=gen, device=device,
                                dtype=torch.uint8) if uint8 else
                  torch.randn(shape, generator=gen, device=device))
        out.append((images, torch.randint(0, classes, (batch,),
                                          generator=gen, device=device,
                                          dtype=torch.int32)))
    return out


def p19_vit(remat: bool, workdir: str, device, batches: list) -> dict:
    """19a's run: P19_STEPS steps of vit_small through the Trainer with
    mixup and the gradient norm, with or without remat, from the config's
    seed; its per-step metrics, K1's launches and the peak memory."""
    cfg = get_config(P19_MODEL)
    cfg = cfg.replace(remat=remat, mixup_alpha=P19_MIXUP, log_grad_norm=True,
                      batch_size=P19_BATCH, log_every_steps=1,
                      data=dataclasses.replace(
                          cfg.data, dataset="synthetic",
                          train_examples=P19_BATCH * P19_STEPS))
    trainer = Trainer(cfg, device=device, workdir=workdir)
    trainer.init_state()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = trainer.train_epoch(1, batches)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trainer.close()
    logged = [r["train_grad_norm"] for r in p19_jsonl(workdir, cfg.name)
              if "train_grad_norm" in r]
    return {"steps": trainer.last_epoch_steps, "launches": launches,
            "peak_bytes": peak, "logged_grad_norm": logged, "out": out,
            "wall": wall}


def check_p19_remat(device) -> dict:
    """19a: remat, mixup and the gradient norm on vit_small."""
    cfg = get_config(P19_MODEL)
    depth = cfg.model_kwargs["depth"]
    batches = p19_batches(P19_STEPS, P19_BATCH, cfg.data.image_size,
                          cfg.data.num_classes, device)
    runs = {}
    for remat in (False, True):
        wd = tempfile.mkdtemp(prefix=f"chip_smoke_p19a{int(remat)}_")
        atexit.register(shutil.rmtree, wd, ignore_errors=True)
        runs[remat] = p19_vit(remat, wd, device, batches)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    plain, rem = runs[False], runs[True]
    rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                  for a, b in zip(rem["steps"], plain["steps"]))
           for k in ("loss", "grad_norm")}
    for remat, r in runs.items():
        phase(f"19a vit_small remat={remat}: losses "
              f"{[round(s['loss'], 5) for s in r['steps']]} grad_norm "
              f"{[round(s['grad_norm'], 5) for s in r['steps']]} (logged "
              f"{len(r['logged_grad_norm'])}), K1 {r['launches']}, step_ms "
              f"{r['out'].get('step_ms', float('nan')):.3f}, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB, {r['wall']:.1f}s")
    phase(f"19a remat vs none: loss relative {rel['loss']:.3g}, grad_norm "
          f"relative {rel['grad_norm']:.3g} (bound {P19_REMAT_RTOL:g}); K1 "
          f"{plain['launches']} -> {rem['launches']}, "
          f"{(rem['launches'] - plain['launches']) / P19_STEPS:g} more a "
          f"step")
    for r in runs.values():
        norms = [s["grad_norm"] for s in r["steps"]]
        if len(norms) != P19_STEPS or not all(
                np.isfinite(v) and v > 0 for v in norms):
            raise AssertionError(f"19a: grad_norm {norms}")
        if len(r["logged_grad_norm"]) != P19_STEPS:
            raise AssertionError(f"19a: grad_norm logged "
                                 f"{r['logged_grad_norm']}")
    if max(rel.values()) > P19_REMAT_RTOL:
        raise AssertionError(f"19a: remat differs from none by {rel}")
    if plain["launches"] != depth * P19_STEPS \
            or rem["launches"] != 2 * depth * P19_STEPS:
        raise AssertionError(
            f"19a: K1 launches {plain['launches']} and {rem['launches']}, "
            f"want {depth * P19_STEPS} and {2 * depth * P19_STEPS} (the "
            f"recompute runs every block's attention again)")
    return {"launches": {"plain": plain["launches"],
                         "remat": rem["launches"]},
            "steps": P19_STEPS, "rel": rel,
            "peak_bytes": {"plain": plain["peak_bytes"],
                           "remat": rem["peak_bytes"]},
            "step_ms": {"plain": plain["out"].get("step_ms"),
                        "remat": rem["out"].get("step_ms")}}


def check_p19_dispatch(device) -> dict:
    """19b: CutMix and k steps per dispatch through ViT/torch/train.py;
    the workdir is kept for 19e."""
    cfg = get_config(P19_MODEL)
    depth = cfg.model_kwargs["depth"]
    wd = tempfile.mkdtemp(prefix="chip_smoke_p19b_")
    atexit.register(shutil.rmtree, wd, ignore_errors=True)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    trainer, result = family_main("ViT", [
        "-m", P19_MODEL, "--synthetic", "--cutmix-alpha", "1.0",
        "--steps-per-dispatch", str(P19_K), "--batch-size", str(P19_B_BATCH),
        "--steps-per-epoch", str(P19_B_STEPS), "--epochs", "1",
        "--device", str(device), "--workdir", wd])
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    records = [r for r in p19_jsonl(wd, cfg.name) if "train_loss" in r]
    ends = list(range(P19_K, P19_B_STEPS + 1, P19_K))
    log_every = trainer.config.log_every_steps
    want_logged = [e for e in ends if e // log_every > (e - P19_K)
                   // log_every]
    dispatches = trainer.last_epoch_dispatches
    evals = int(result.get("count", 0)) // P19_B_BATCH
    want = depth * (P19_B_STEPS + evals)
    phase(f"19b vit_small --cutmix-alpha 1.0 --steps-per-dispatch {P19_K}: "
          f"{trainer.dispatches_total} dispatches of "
          f"{sorted({d['steps'] for d in dispatches})} steps, train records "
          f"at steps {[r['step'] for r in records]} (log_every "
          f"{log_every}), losses "
          f"{[round(s['loss'], 4) for s in trainer.last_epoch_steps]}, K1 "
          f"{launches} (want {depth} x ({P19_B_STEPS} steps + {evals} eval "
          f"batches) = {want}); {wall:.1f}s")
    if (trainer.dispatches_total != P19_B_STEPS // P19_K
            or [d["steps"] for d in dispatches]
            != [float(P19_K)] * (P19_B_STEPS // P19_K)
            or [r["step"] for r in records] != want_logged
            or evals != 2 or not all(np.isfinite(s["loss"])
                                     for s in trainer.last_epoch_steps)):
        raise AssertionError(f"19b: {trainer.dispatches_total} dispatches "
                             f"{dispatches}, records {records}, {result}")
    if launches != want:
        raise AssertionError(f"19b: {launches} K1 launches, want {want}")
    return {"launches": launches, "steps": P19_B_STEPS, "eval_batches": evals,
            "dispatches": trainer.dispatches_total, "workdir": wd}


class P19Pulls:
    """Counts the synthetic detection batches pulled, by seed (the train
    epoch's seed is the epoch, the validation set's 10**6)."""

    def __init__(self):
        from deepvision_tpu_torch.data import detection as det
        self.module, self.real = det, det.synthetic_batches
        self.pulls: dict = {}

    def __enter__(self):
        def counted(*args, seed: int = 0, **kwargs):
            for b in self.real(*args, seed=seed, **kwargs):
                self.pulls[seed] = self.pulls.get(seed, 0) + 1
                yield b
        self.module.synthetic_batches = counted
        return self

    def __exit__(self, *exc):
        self.module.synthetic_batches = self.real


def p19_yolo(device, epochs: int, tag: str) -> tuple:
    wd = tempfile.mkdtemp(prefix=f"chip_smoke_p19{tag}_")
    atexit.register(shutil.rmtree, wd, ignore_errors=True)
    best_iou.launches = 0
    t0 = time.perf_counter()
    with P19Pulls() as pulls:
        trainer, result = family_main("YOLO", [
            "-m", "yolov3", "--synthetic", "--image-size", str(P19_YOLO_SIZE),
            "--epoch-on-device", "--log-grad-norm", "--epochs", str(epochs),
            "--batch-size", str(P19_YOLO_BATCH), "--steps-per-epoch",
            str(P19_YOLO_STEPS), "--learning-rate", P19_YOLO_LR,
            "--device", str(device), "--workdir", wd])
    return trainer, result, best_iou.launches, pulls.pulls, \
        time.perf_counter() - t0


def check_p19_epoch(device) -> dict:
    """19c: yolov3 on the whole-epoch path, then the cache's overflow."""
    import warnings

    from deepvision_tpu_torch.core.steps import draw_epoch_permutation
    from deepvision_tpu_torch.data.device_cache import \
        EpochCacheOverflowWarning
    trainer, result, launches, pulls, wall = p19_yolo(device, 2, "c")
    cache = trainer._epoch_cache
    evals = 2 * int(result.get("count", 0))
    want = 2 * P19_YOLO_STEPS + evals
    n = P19_YOLO_STEPS * P19_YOLO_BATCH
    perm = draw_epoch_permutation(trainer.config.seed, 2, n, device)
    is_perm = sorted(perm.tolist()) == list(range(n))
    norms = [s["grad_norm"] for s in trainer.last_epoch_steps]
    phase(f"19c yolov3 --epoch-on-device (416 px, batch {P19_YOLO_BATCH}, "
          f"{P19_YOLO_STEPS} steps x 2 epochs): host batches pulled by "
          f"epoch {pulls}, cache {cache.steps} steps x "
          f"{cache.examples_per_step}, {cache.nbytes / 2**20:.1f} MiB staged "
          f"in {cache.stage_secs:.3f}s, {trainer.dispatches_total} "
          f"dispatches, epoch 2 losses "
          f"{[round(s['loss'], 3) for s in trainer.last_epoch_steps]} "
          f"grad_norm {[round(v, 3) for v in norms]}, K2 {launches} (want "
          f"{2 * P19_YOLO_STEPS} steps + {evals} eval batches = {want}), "
          f"epoch 2's shuffle a permutation: {is_perm}; {wall:.1f}s")
    if (pulls.get(1) != P19_YOLO_STEPS or pulls.get(2, 0) != 0
            or trainer.dispatches_total != 2 or not is_perm
            or len(norms) != P19_YOLO_STEPS
            or not all(np.isfinite(v) for v in norms)):
        raise AssertionError(f"19c: pulls {pulls}, dispatches "
                             f"{trainer.dispatches_total}, {norms}")
    if launches != want:
        raise AssertionError(f"19c: {launches} K2 launches, want {want}")
    os.environ["DEEPVISION_EPOCH_CACHE_MAX_BYTES"] = str(P19_OVERFLOW_BYTES)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            over, res2, launches2, pulls2, wall2 = p19_yolo(device, 1, "c2")
    finally:
        del os.environ["DEEPVISION_EPOCH_CACHE_MAX_BYTES"]
    named = [w for w in caught
             if issubclass(w.category, EpochCacheOverflowWarning)]
    evals2 = int(res2.get("count", 0))
    want2 = P19_YOLO_STEPS + evals2
    for w in named:
        phase(f"19c {w.category.__name__}: {w.message}")
    phase(f"19c with a {P19_OVERFLOW_BYTES} B budget: "
          f"{len(named)} EpochCacheOverflowWarning, staged loop "
          f"{over._epoch_fallback}, {over.dispatches_total} dispatches, "
          f"pulls {pulls2}, K2 {launches2} (want {want2}); {wall2:.1f}s")
    if (len(named) != 1 or not over._epoch_fallback
            or over.dispatches_total != P19_YOLO_STEPS
            or pulls2.get(1) != P19_YOLO_STEPS or launches2 != want2):
        raise AssertionError(f"19c overflow: {len(named)} warnings, "
                             f"{over.dispatches_total} dispatches, "
                             f"{launches2} K2 launches")
    return {"launches": launches, "train_steps": 2 * P19_YOLO_STEPS,
            "eval_batches": evals, "cache_bytes": cache.nbytes,
            "stage_secs": cache.stage_secs, "pulls": pulls,
            "overflow_launches": launches2}


def p19_resnet(device, k: int, tag: str, batches: list) -> tuple:
    """19d's run: resnet50_tpu (its EMA, the device augment) through the
    Trainer, one epoch of `batches` at k steps a dispatch."""
    cfg = get_config("resnet50_tpu")
    cfg = cfg.replace(steps_per_dispatch=k, device_augment=True,
                      batch_size=P19_RESNET_BATCH,
                      data=dataclasses.replace(
                          cfg.data, dataset="synthetic",
                          train_examples=P19_RESNET_BATCH * len(batches)))
    wd = tempfile.mkdtemp(prefix=f"chip_smoke_p19{tag}_")
    atexit.register(shutil.rmtree, wd, ignore_errors=True)
    trainer = Trainer(cfg, device=device, workdir=wd)
    trainer.init_state()
    trainer.train_epoch(1, batches)
    trainer.close()
    state = trainer.state
    return trainer, ([p.detach() for p in state.model.parameters()]
                     + list(state.ema))


def p19_rel(a: list, b: list) -> float:
    return max(((x.float() - y.float()).abs().max()
                / y.float().abs().max().clamp_min(1e-30)).item()
               for x, y in zip(a, b))


def check_p19_resnet(device) -> dict:
    """19d: resnet50_tpu with k = 4 against k = 1 (twice)."""
    launches0 = (flash_attention.launches, best_iou.launches)
    size = decode_image_size(get_config("resnet50_tpu").data.image_size)
    batches = p19_batches(P19_RESNET_STEPS, P19_RESNET_BATCH, size, 1000,
                          device, uint8=True)
    one, w1 = p19_resnet(device, 1, "d1", batches)
    again, w1b = p19_resnet(device, 1, "d1b", batches)
    four, w4 = p19_resnet(device, P19_RESNET_K, "d4", batches)
    spread, rel = p19_rel(w1b, w1), p19_rel(w4, w1)
    d4 = four.last_epoch_dispatches
    d1 = one.last_epoch_dispatches
    per = {k: statistics.median(d[k] for d in d4[1:]) for k in ("ms",
                                                                 "host_ms")}
    per1 = {k: statistics.median(d[k] for d in d1[1:]) for k in ("ms",
                                                                 "host_ms")}
    phase(f"19d resnet50_tpu (batch {P19_RESNET_BATCH}, {P19_RESNET_STEPS} "
          f"steps, EMA): k={P19_RESNET_K} vs k=1 parameters and EMA, "
          f"largest difference over largest entry {rel:.3g} (bound "
          f"{P19_K_RTOL:g}; k=1 vs k=1 {spread:.3g}); a dispatch of "
          f"{P19_RESNET_K}: {per['ms']:.3f} device ms, {per['host_ms']:.3f} "
          f"host ms to issue; of 1: {per1['ms']:.3f}, {per1['host_ms']:.3f}; "
          f"dispatches {four.dispatches_total} vs {one.dispatches_total}")
    if (four.dispatches_total != P19_RESNET_STEPS // P19_RESNET_K
            or four.state.step != one.state.step or rel > P19_K_RTOL):
        raise AssertionError(f"19d: k={P19_RESNET_K} differs by {rel:g}")
    if (flash_attention.launches, best_iou.launches) != launches0:
        raise AssertionError("19d: a kernel ran on resnet50_tpu's path")
    return {"rel": rel, "spread": spread, "dispatch_ms": per,
            "step_ms_k1": per1}


def check_p19_classify(device, workdir: str) -> dict:
    """19e: the classifier tool on 19b's checkpoint, against the served
    engine."""
    from deepvision_tpu_torch.core.classify import Classifier
    from deepvision_tpu_torch.tools import classify as classify_tool
    depth = get_config(P19_MODEL).model_kwargs["depth"]
    routes = ("cpu_images",) if device.type == "cpu" else (
        "hw_images", "gpu_images", "sw_images")
    decoded0 = sum(jpeg.stats[k] for k in routes)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    top = classify_tool.main(["-m", P19_MODEL, "--workdir", workdir,
                              "--device", str(device), P19_JPEG])[P19_JPEG]
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    decoded = sum(jpeg.stats[k] for k in routes) - decoded0
    clf = Classifier(P19_MODEL, workdir=workdir, device=device)
    x = clf.preprocess(P19_JPEG).cpu().numpy()
    clf.close()
    engine = PredictEngine.from_config(P19_MODEL, device=device, buckets=(1,),
                                       workdir=workdir, verbose=False)
    probs = torch.softmax(torch.from_numpy(engine.predict(x)[0]).double(),
                          -1).numpy()
    served = [(f"class {i}", float(probs[i]))
              for i in np.argsort(probs)[::-1][:5]]
    # where the two differ, the engine's own probabilities of the two
    # classes must be a near tie
    ties = [abs(probs[int(n.split()[-1])] - q) for (n, _), (m, q) in
            zip(top, served) if n != m]
    phase(f"19e tools.classify on 19b's epoch "
          f"{engine.provenance.get('checkpoint_epoch')}"
          f": top-5 {[(n, round(p, 5)) for n, p in top]}; served "
          f"{[(n, round(p, 5)) for n, p in served]}; K1 {launches} (want "
          f"{depth}); {decoded} image(s) decoded on {device.type}; "
          f"{wall:.1f}s")
    if launches != depth or decoded != 1 or len(top) != 5:
        raise AssertionError(f"19e: K1 {launches}, decoded {decoded}")
    if ties and max(ties) > P19_TIE:
        raise AssertionError(f"19e: the top-5 differs from the engine's "
                             f"beyond a near tie: {top} vs {served}")
    return {"launches": launches, "top5": top, "served": served}


def check_levers() -> dict:
    """Phase 19, slice 17: the training step's levers, each kernel's count
    zeroed just before its entry point and read just after."""
    t0 = time.perf_counter()
    device = torch.device(P19_DEVICE)
    out = {"19a": check_p19_remat(device)}
    out["19b"] = check_p19_dispatch(device)
    out["19c"] = check_p19_epoch(device)
    out["19d"] = check_p19_resnet(device)
    out["19e"] = check_p19_classify(device, out["19b"]["workdir"])
    phase(f"19: phase 19 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 20: int8 serving ---------------------------------------------------

P20_DEVICE = "cuda"
P20_VIT = MODEL                    # 20a
P20_RESNET = RESNET_MODEL          # 20b
P20_MOBILE = "mobilenet_v1"        # 20c, at bucket 1
P20_BUCKETS = BUCKETS
P20_SIZE = None                    # the configs' own sizes
# the plans JAX traces for these configs: quantized / skipped_head /
# fused_attention (vit_small's attention in interpret mode)
P20_PLANS = {"vit_small": (49, 1, 8), "resnet50_tpu": (53, 1, 0),
             "mobilenet_v1": (27, 1, 0), "vit_tiny": (25, 1, 4)}
P20_ITERS = 5                      # measure_batch_ms, each precision
# int8 against bf16 on the 64-image pinned shard: the largest |difference|
# over the largest bf16 logit (seeded random weights; measured at most
# 0.045, vit_small, on the H100)
P20_REL_MAX = 0.15
P20_RELOAD_TOL = 1e-3              # relative to the largest logit
# 20d's fault lowers the int8 score by a fixed 0.5 clipped at 0, as in the
# JAX package: on seeded random weights, which score about 0 of 64 on 1000
# classes, it could not show. 20d gates on the pinned images labelled with
# the bf16 rung's own answers (a bf16 score of 1)


class P20Grab(quant.Int8Mode):
    """The int8 forward, keeping the arguments of the conv and dense calls
    at `positions` (planned ops' call positions)."""

    def __init__(self, plan, qweights, positions):
        super().__init__(plan, qweights)
        self.want = set(positions)
        self.grabbed = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in quant.HEAVY and self.calls in self.want:
            self.grabbed[self.calls] = (args, dict(kwargs or {}))
        return super().__torch_function__(func, types, args, kwargs)


def p20_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, (tuple, list)):
        return type(tree)(p20_cpu(t) for t in tree)
    if isinstance(tree, dict):
        return {k: p20_cpu(v) for k, v in tree.items()}
    return tree


def p20_accumulators(engine, picks: dict, x: np.ndarray) -> dict:
    """For the first planned op each of `picks` accepts (label ->
    predicate on a `quant.QuantOp`): its int32 accumulator from the
    operands the int8 forward of `x` gives it on the card, against the
    same function on the CPU, bit for bit."""
    quantizer = engine._quantizer
    plan, qweights = quantizer.plan, engine._qweights
    picks = {label: next(i for i, op in enumerate(plan.ops) if want(op))
             for label, want in picks.items()}
    grab = P20Grab(plan, qweights, [plan.ops[i].position
                                    for i in picks.values()])
    with torch.inference_mode():
        with grab:
            engine.forward(engine.model, x)
        grab.check()
        out = {}
        for label, i in picks.items():
            op = plan.ops[i]
            args, kwargs = grab.grabbed[op.position]
            s_x = plan.act_scales[i]
            card = quant.int8_accumulate(op.prim, args, kwargs, qweights[i],
                                         s_x)
            cpu = quant.int8_accumulate(op.prim, p20_cpu(args),
                                        p20_cpu(kwargs),
                                        qweights[i].to("cpu"), s_x)
            out[label] = {"op": i, "prim": op.prim,
                          "weight": list(op.weight_shape),
                          "acc_shape": list(card.shape),
                          "equal": bool(torch.equal(card.cpu(), cpu))}
    return out


def p20_sync() -> None:
    if P20_DEVICE == "cuda":
        torch.cuda.synchronize()


def check_p20_model(name: str, buckets, picks, keep: bool = False):
    """20a-c: one config at full width served at int8: `arm_int8` on its
    64-image pinned shard (the plan, one calibration), the main path at
    every bucket with K1's launches and the int8 products counted, int8
    against bf16 on the shard, accumulators card vs CPU, and each
    bucket's `measure_batch_ms` at both precisions with the byte counts.
    Returns the record, and with `keep` the engine too."""
    t0 = time.perf_counter()
    cfg = config_at(name, P20_SIZE)
    engine = PredictEngine.from_config(name, device=P20_DEVICE,
                                       buckets=buckets, image_size=P20_SIZE,
                                       verbose=False)
    engine.warmup()
    cuda = P20_DEVICE == "cuda"
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    passes = quant.calibrate.passes
    t1 = time.perf_counter()
    decision = arm_int8(engine, faults=FaultInjector(), verbose=False)
    p20_sync()
    arm_s = time.perf_counter() - t1
    mem1 = torch.cuda.memory_allocated() if cuda else 0
    plan = decision["plan"]
    got_plan = (plan["quantized"], plan["skipped_head"],
                plan["fused_attention"])
    images, _ = scoring.pinned_shard(
        cfg, image_size=engine.example_shape[0],
        input_dtype=engine.input_dtype, examples=64)
    depth = (cfg.model_kwargs.get("depth", 0) if cfg.model == "vit" else 0)

    # the main path: one int8 dispatch per bucket, the counts zeroed just
    # before and read just after
    flash_attention.launches = best_iou.launches = 0
    quant.int8_matmul.calls = quant.int8_depthwise.calls = 0
    engine.dispatches = 0
    engine.dispatches_by_precision.update(bf16=0, int8=0)
    outs = {b: engine.dispatch(images[:b])[0] for b in buckets}
    p20_sync()
    counts = {"flash_attention": flash_attention.launches,
              "best_iou": best_iou.launches,
              "int8_matmul": quant.int8_matmul.calls,
              "int8_depthwise": quant.int8_depthwise.calls,
              "dispatches": dict(engine.dispatches_by_precision)}

    q = engine.predict(images, precision="int8")
    f = engine.predict(images, precision="bf16")
    agree = float((q.argmax(-1) == f.argmax(-1)).mean())
    rel = float(np.abs(q - f).max() / max(np.abs(f).max(), 1e-12))
    acc = p20_accumulators(engine, picks, images[:1])
    ms = {}
    for b in buckets:
        ms[b] = {p: engine.measure_batch_ms(b, P20_ITERS, precision=p)
                 for p in ("bf16", "int8")}
    per_chip = engine.weight_bytes_per_chip()
    out = {"decision": decision["decision"], "plan": got_plan,
           "calibrations": quant.calibrate.passes - passes,
           "counts": counts, "argmax_agree": agree, "rel_err": rel,
           "accumulators": acc, "measure_batch_ms": ms,
           "bytes": {k: decision[k] for k in (
               "weight_bytes_bf16", "weight_bytes_int8",
               "weight_bytes_staged")},
           "per_chip": per_chip, "armed_bytes_on_card": mem1 - mem0,
           "arm_s": arm_s, "delta": decision["delta"],
           "secs": time.perf_counter() - t0}
    tag = {P20_VIT: "20a", P20_RESNET: "20b", P20_MOBILE: "20c"}[name]
    phase(f"{tag} {name} int8: {decision['decision']} (watch "
          f"{decision['watch']} bf16 {decision['metric_bf16']} int8 "
          f"{decision['metric_int8']}), plan {got_plan} "
          f"(quantized/skipped_head/fused_attention), armed in "
          f"{arm_s:.2f}s, {out['calibrations']} calibration")
    phase(f"{tag} main path, one int8 dispatch per bucket {list(buckets)}: "
          f"{counts}; flash_attention per dispatch "
          f"{counts['flash_attention'] / len(buckets):g} (depth {depth})")
    phase(f"{tag} int8 vs bf16 on the 64-image shard: argmax agreement "
          f"{agree:.4f}, max |int8 - bf16| / max |bf16| = {rel:.4g}; "
          f"int32 accumulators card vs CPU: "
          + ", ".join(f"{k} {v['prim']} {v['weight']} -> {v['acc_shape']} "
                      f"equal={v['equal']}" for k, v in acc.items()))
    phase(f"{tag} measure_batch_ms (bf16 / int8): "
          + ", ".join(f"bucket {b} {v['bf16']:.3f} / {v['int8']:.3f}"
                      for b, v in ms.items())
          + f"; bytes: f32 masters {out['bytes']['weight_bytes_bf16']}, "
          f"int8 tree {out['bytes']['weight_bytes_int8']}, staged "
          f"{out['bytes']['weight_bytes_staged']}; resident per precision "
          f"{per_chip}; memory_allocated grew {mem1 - mem0} bytes arming")
    if decision["decision"] != "int8_enabled" \
            or got_plan != P20_PLANS[name] or out["calibrations"] != 1:
        raise AssertionError(f"{tag}: {decision}")
    if counts["flash_attention"] != depth * len(buckets) \
            or counts["best_iou"] != 0 \
            or counts["dispatches"]["int8"] != len(buckets) \
            or counts["int8_matmul"] + counts["int8_depthwise"] < \
            got_plan[0] * len(buckets):
        raise AssertionError(f"{tag}: the main path's counts {counts}")
    if not (np.isfinite(q).all() and q.shape == f.shape) \
            or rel > P20_REL_MAX:
        raise AssertionError(f"{tag}: int8 vs bf16 {rel:g}, {q.shape}")
    if not all(v["equal"] for v in acc.values()):
        raise AssertionError(f"{tag}: accumulators {acc}")
    if keep:
        return out, engine
    del engine
    if P20_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def check_p20_stack(stash: str, engine) -> dict:
    """20d: the serving stack at int8, vit_small. 20a's `engine` armed
    again under the fault (on the shard labelled by its bf16 answers):
    refused, bf16 serving on; `--serve-precision int8` through
    `build_server` on
    phase 16's epoch 1 (armed before traffic); over HTTP the default
    answer (int8) and a `"precision": "bf16"` override against the engine,
    /healthz and /metrics; epoch 2 hot-reloaded by `POST /reload`: one
    calibration in all, the answers those of epoch 2's own int8."""
    t0 = time.perf_counter()
    cfg = config_at(P16_MODEL)
    rs = np.random.RandomState(20)
    x = rs.rand(1, cfg.data.image_size, cfg.data.image_size,
                cfg.data.channels).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    images, _ = scoring.pinned_shard(
        cfg, image_size=engine.example_shape[0],
        input_dtype=engine.input_dtype, examples=64)
    own = np.asarray(engine.predict(images, precision="bf16")).argmax(-1)
    fault = arm_int8(engine, shard=(images, (own,)), verbose=False,
                     faults=FaultInjector.from_env(
                         {"DEEPVISION_FAULT_QUANT_REGRESS": "1"}))
    still = engine.predict(x)
    try:
        engine.predict(x, precision="int8")
        unarmed = "served"
    except ValueError:
        unarmed = "refused"
    del engine
    if P20_DEVICE == "cuda":
        torch.cuda.empty_cache()

    workdir = p15_workdir("20d")
    p16_commit(stash, workdir, 1)
    passes = quant.calibrate.passes
    server = build_server(p16_args("--workdir", workdir, "-c", "1",
                                   "--buckets", "1,8", "--trace-sample",
                                   "0", "--serve-precision", "int8"))
    engine = server.fleet.default.engine
    armed = (engine.precision, engine.quant_decision["decision"],
             quant.calibrate.passes - passes)
    t, base = p16_serve(server)
    try:
        _, default, _ = p16_post(base, body, "p20-int8")
        _, forced, _ = p16_post(base, json.dumps(
            {"instances": x.tolist(), "precision": "bf16"}).encode(),
            "p20-bf16")
        want_q = engine.predict(x)
        want_f = engine.predict(x, precision="bf16")
        health = p16_get(base, "/healthz")
        metrics = p16_get(base, "/metrics")
        p16_commit(stash, workdir, 2)
        _, reload_rec, reload_s = p16_post(base, b"", "p20-reload",
                                           "/reload")
        _, after, _ = p16_post(base, body, "p20-after")
        quantizer = engine._quantizer
    finally:
        p16_stop(server, t)
    fresh = PredictEngine.from_config(P16_MODEL, device=P16_DEVICE,
                                      workdir=stash, checkpoint=2,
                                      buckets=(1,), verbose=False)
    fresh.enable_int8(quantizer, verbose=False)
    want_2 = fresh.predict(x, precision="int8")
    del fresh
    got = {k: np.asarray(v["predictions"], np.float32)
           for k, v in (("default", default), ("bf16", forced),
                        ("after", after))}
    scale = max(float(np.abs(want_q).max()), 1e-12)
    err = {"default_vs_int8": float(np.abs(got["default"] - want_q).max()),
           "override_vs_bf16": float(np.abs(got["bf16"] - want_f).max()),
           "reloaded_vs_epoch2_int8": float(
               np.abs(got["after"] - want_2).max())}
    calibrations = quant.calibrate.passes - passes
    out = {"fault": fault["decision"], "unarmed_int8": unarmed,
           "armed": armed, "errors": err, "calibrations": calibrations,
           "reload": reload_rec.get("swapped"), "reload_s": reload_s,
           "after_epoch": after.get("weights_epoch"),
           "secs": time.perf_counter() - t0}
    valid = validate_serve_exposition(metrics)
    int8_series = 'precision="int8"' in metrics
    phase(f"20d DEEPVISION_FAULT_QUANT_REGRESS=1 on {P16_MODEL}, its shard "
          f"labelled by its bf16 answers: {fault['decision']} (watch bf16 "
          f"{fault['metric_bf16']}, delta {fault['delta']}), bf16 serving "
          f"on, an int8 request "
          f"{unarmed}; --serve-precision int8: precision, decision, "
          f"calibrations {armed}")
    phase(f"20d HTTP: default vs engine int8 {err['default_vs_int8']:.3g}, "
          f"precision bf16 override vs engine bf16 "
          f"{err['override_vs_bf16']:.3g}; /healthz precision "
          f"{health['precision']} quant {health['quant']['decision']}; "
          f"/metrics int8 series {int8_series}, "
          f"validator {valid}")
    phase(f"20d POST /reload epoch 2 at int8: swapped {out['reload']} in "
          f"{reload_s:.2f}s, answer of epoch {out['after_epoch']}, vs epoch "
          f"2's own int8 {err['reloaded_vs_epoch2_int8']:.3g} (logit scale "
          f"{scale:.3g}); calibrations in all {calibrations}")
    if fault["decision"] != "refused_regression" or unarmed != "refused" \
            or not np.isfinite(still).all():
        raise AssertionError(f"20d: the fault {fault}, int8 {unarmed}")
    if armed != ("int8", "int8_enabled", 1) or calibrations != 1:
        raise AssertionError(f"20d: armed {armed}, {calibrations} "
                             f"calibrations")
    if health["precision"] != "int8" \
            or health["quant"]["decision"] != "int8_enabled" or valid \
            or not int8_series:
        raise AssertionError(f"20d: /healthz {health.get('quant')}, "
                             f"/metrics {valid}")
    if out["reload"] != 1 or out["after_epoch"] != 2 \
            or err["reloaded_vs_epoch2_int8"] > P20_RELOAD_TOL * scale \
            or max(err["default_vs_int8"], err["override_vs_bf16"]) \
            > P20_RELOAD_TOL * scale:
        raise AssertionError(f"20d: {out}")
    return out


def check_int8_serving(stash: str) -> dict:
    """Phase 20, slice 18: int8 serving. 20a vit_small (K1 8 a dispatch
    at int8), 20b resnet50_tpu, 20c mobilenet_v1 (the depthwise path), 20d
    the serving stack; each count zeroed just before its main path and
    read just after."""
    t0 = time.perf_counter()
    out = {}
    out["20a"], vit = check_p20_model(P20_VIT, P20_BUCKETS, {
        "query": lambda op: op.prim == "linear"}, keep=True)
    out["20b"] = check_p20_model(P20_RESNET, P20_BUCKETS, {
        "stem": lambda op: True,
        "1x1": lambda op: op.weight_shape[2:] == (1, 1)})
    out["20c"] = check_p20_model(P20_MOBILE, (1,), {
        "stem": lambda op: True,
        "depthwise": lambda op: op.prim == "conv2d"
        and op.weight_shape[1] == 1})
    out["20d"] = check_p20_stack(stash, vit)
    phase(f"20: phase 20 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 21: model export and the checkpoint importer ----------------------

P21_DEVICE = "cuda"
P21_VIT = MODEL                    # 21a, from phase 6's run
P21_BATCH = 8                      # 21a's static batch
P21_CG_SIZE = 256                  # 21b, from phase 14d's run
P21_IMPORT = "resnet50"            # 21d
P21_IMPORT_SIZE = None             # the config's own size
P21_IMPORT_EPOCH = 3
P21_BUCKET = 8
P21_ITERS = 10                     # ms a call: median of 10 after 2
P21_VERSION = "0.0.19"
P21_COMPILE_TIMEOUT = 900
# both exports run beside host-bound phases (21a beside 7-20, 21b beside
# 15-20): two inductor compile workers each, and a lower CPU priority
# (nice +P21_NICE, inherited by the workers and the C++ compiler), so the
# phases they run beside keep the host's cores
P21_EXPORT_THREADS = 2
P21_NICE = 10
# 21a: the program and the package (bf16, K1 on the card) against the
# eager forward on the same weights, relative to the largest logit. The
# program runs the eager ops, so it must match bit for bit; the package
# fuses elementwise work and keeps f32 where eager rounds to bf16 after
# every op (measured 0.0119 on the H100 80GB HBM3 at 700 W, 8.2e-3 for
# vit_tiny on the CPU; tests/test_torch_export_package.py holds that at
# 2e-2 too)
P21_PROGRAM_RTOL = 0.0
P21_PACKAGE_RTOL = 2e-2
# 21b: the cyclegan package (f32, TF32 off) against the eager generator,
# relative to the largest value: only summation order differs
P21_CG_RTOL = 1e-4
P21_SECONDS = re.compile(r"\[export\] (program exported|package compiled) "
                         r"in ([0-9.]+)s")


def p21_stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def p21_start(tag: str, cmd: list) -> dict:
    """Start one export as a process on the card, on P21_EXPORT_THREADS
    compile workers at nice +P21_NICE, its output to a log in a directory
    of its own; `p21_wait` collects it. A script that ends first kills
    it."""
    root = tempfile.mkdtemp(prefix=f"chip_smoke_p21{tag}_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        TORCHINDUCTOR_COMPILE_THREADS=str(P21_EXPORT_THREADS))
    log = os.path.join(root, "log")
    with open(log, "w") as fh:
        proc = subprocess.Popen([c.format(root=root) for c in cmd], env=env,
                                stdout=fh, stderr=subprocess.STDOUT, cwd=HERE)
    atexit.register(p21_stop, proc)
    # the child is still importing torch: its workers inherit the value
    try:
        os.setpriority(os.PRIO_PROCESS, proc.pid,
                       os.getpriority(os.PRIO_PROCESS, 0) + P21_NICE)
    except ProcessLookupError:   # it failed already; p21_wait says how
        pass
    return {"root": root, "log": log, "proc": proc,
            "t0": time.perf_counter()}


def p21_wait(run: dict, what: str) -> dict:
    """The export's seconds (what phase 21 waited for it, and the
    program's export and the package's compile from its log); fails with
    the log's tail unless it exited 0 within P21_COMPILE_TIMEOUT of its
    start."""
    t0 = time.perf_counter()
    try:
        rc = run["proc"].wait(timeout=max(
            1.0, P21_COMPILE_TIMEOUT - (t0 - run["t0"])))
    except subprocess.TimeoutExpired:
        p21_stop(run["proc"])
        rc = None
    with open(run["log"]) as fh:
        text = fh.read()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}:\n{text[-3000:]}")
    found = {m.group(1): float(m.group(2))
             for m in P21_SECONDS.finditer(text)}
    return {"waited_s": time.perf_counter() - t0,
            "export_s": found.get("program exported"),
            "compile_s": found.get("package compiled")}


def start_p21_export(vit_workdir: str) -> dict:
    """21a's `python -m deepvision_tpu_torch.tools.export` of phase 6's
    vit_small run at batch P21_BATCH, program and package, started as
    soon as the run exists."""
    return p21_start("a", [
        sys.executable, "-m", "deepvision_tpu_torch.tools.export",
        "-m", P21_VIT, "--workdir", vit_workdir,
        "--batch-size", str(P21_BATCH), "--saved-model", "{root}/program",
        "--tflite", "{root}/vit.pt2", "--device", P21_DEVICE])


def start_p21_convert(cyclegan_workdir: str) -> dict:
    """21b's `CycleGAN/torch/convert.py` of phase 14d's cyclegan run at
    P21_CG_SIZE px, the program kept beside the package, started when
    phase 14 ends so its compile runs beside phases 15-20."""
    return p21_start("b", [
        sys.executable, os.path.join(HERE, "CycleGAN", "torch",
                                     "convert.py"),
        "--workdir", cyclegan_workdir, "--direction", "a2b",
        "--image-size", str(P21_CG_SIZE), "--output", "{root}/a2b.pt2",
        "--saved-model-dir", "{root}/program", "--device", P21_DEVICE])


def p21_rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(want).float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def p21_ms(fn) -> float:
    with torch.inference_mode():
        return event_ms(fn, warmup=2, iters=P21_ITERS)[0]


def check_p21_export(run: dict, vit_workdir: str) -> dict:
    """21a: the exported vit_small program and its package on the card,
    K1's launches counted in a window of one call each, both against the
    engine's eager answer on the same restored weights."""
    seconds = p21_wait(run, "21a tools/export.py")
    device = torch.device(P21_DEVICE)
    depth = get_config(P21_VIT).model_kwargs["depth"]
    program_dir, package = (os.path.join(run["root"], "program"),
                            os.path.join(run["root"], "vit.pt2"))
    sig = model_export.load_signature(program_dir)
    t0 = time.perf_counter()
    program = model_export.load_program(program_dir)
    module = program.module()
    seconds["program_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = model_export.load_package(package)
    seconds["package_load_s"] = time.perf_counter() - t0
    nodes = model_export.flash_attention_nodes(program)
    recorded = model_export.package_operators(package).count(
        model_export.FLASH_ATTENTION_TARGET)
    if sig["input"] != "images" or sig["shape"][0] != P21_BATCH \
            or nodes != depth or recorded != depth:
        raise AssertionError(f"21a: signature {sig}, {nodes} K1 nodes, "
                             f"{recorded} K1 calls in the package")
    engine = PredictEngine.from_config(P21_VIT, workdir=vit_workdir,
                                       device=device, buckets=(P21_BATCH,),
                                       verbose=False)
    x = np.random.RandomState(21).randn(*sig["shape"]).astype(np.float32)
    want = engine.reference(x)
    xd = torch.from_numpy(x).to(device)
    launches = {}
    with torch.inference_mode():
        flash_attention.launches = 0
        got_program = module(xd)
        sync(device)
        launches["program"] = flash_attention.launches
        flash_attention.launches = 0
        got_package = runner(xd)
        sync(device)
        launches["package"] = flash_attention.launches
    errs = {"program": p21_rel(got_program, want),
            "package": p21_rel(got_package, want)}
    phase(f"21a {P21_VIT} exported at batch {P21_BATCH} (epoch "
          f"{engine.provenance['checkpoint_epoch']} of phase 6's run): "
          f"signature {sig['input']} {sig['shape']} {sig['dtype']}; "
          f"{nodes} deepvision.flash_attention nodes, {recorded} proxy "
          f"calls in the package; K1 launches in one call: {launches} "
          f"(depth {depth}); against the engine's eager answer, relative "
          f"to the largest logit: {errs} (bounds program "
          f"{P21_PROGRAM_RTOL:g}, package {P21_PACKAGE_RTOL:g})")
    if launches != {"program": depth, "package": depth} \
            or tuple(got_package.shape) != want.shape \
            or not errs["program"] <= P21_PROGRAM_RTOL \
            or not errs["package"] <= P21_PACKAGE_RTOL:
        raise AssertionError(f"21a: launches {launches}, errors {errs}")
    ms = {"eager": p21_ms(lambda: engine.model(xd)),
          "program": p21_ms(lambda: module(xd)),
          "package": p21_ms(lambda: runner(xd))}
    phase("21a seconds: " + " ".join(f"{k}={v:.1f}" for k, v in
                                     seconds.items() if v is not None)
          + "; ms a call at batch {}: ".format(P21_BATCH) + " ".join(
              f"{k}={v:.3f}" for k, v in ms.items()))
    return {"launches": launches, "depth": depth, "errors": errs,
            "seconds": seconds, "ms": ms, "program": (module, xd)}


def check_p21_convert(run: dict, cyclegan_workdir: str) -> dict:
    """21b: the cyclegan a2b package against the eager generator on the
    card; no transposed convolution in its program, K1 and K2 idle; the
    rewrite's cost, the raw export against the rewritten one."""
    seconds = p21_wait(run, "21b CycleGAN/torch/convert.py")
    device = torch.device(P21_DEVICE)
    program = model_export.load_program(os.path.join(run["root"],
                                                     "program"))
    package = os.path.join(run["root"], "a2b.pt2")
    left = model_export.transposed_convs(program)
    operators = model_export.package_operators(package)
    trainer = CycleGANTrainer(get_config("cyclegan"),
                              workdir=cyclegan_workdir, device=device)
    try:
        epoch = trainer.resume()
        gen = trainer.generators["a2b"].eval()
        x = torch.from_numpy(np.random.RandomState(22).rand(
            1, P21_CG_SIZE, P21_CG_SIZE, 3).astype(np.float32) * 2 - 1).to(
            device)
        raw = torch.export.export(gen, (x,), strict=False)
        raw_transposed = model_export.transposed_convs(raw)
        runner = model_export.load_package(package)
        rewritten, unrewritten = program.module(), raw.module()
        with torch.inference_mode():
            flash_attention.launches = best_iou.launches = 0
            want = gen(x)
            got = runner(x)
            got_program = rewritten(x)
            sync(device)
            counts = (flash_attention.launches, best_iou.launches)
        errs = {"package": p21_rel(got, want),
                "program": p21_rel(got_program, want)}
        ms = {"eager": p21_ms(lambda: gen(x)),
              "export": p21_ms(lambda: unrewritten(x)),
              "rewritten": p21_ms(lambda: rewritten(x)),
              "package": p21_ms(lambda: runner(x))}
    finally:
        trainer.close()
    phase(f"21b cyclegan a2b (epoch {epoch} of phase 14d's run) at "
          f"{P21_CG_SIZE} px: transposed convs {raw_transposed} exported, "
          f"{left} after the rewrite; proxy calls {operators}; K1 and K2 "
          f"launches {counts}; against the eager generator, relative to "
          f"the largest value: {errs} (bound {P21_CG_RTOL:g})")
    phase("21b seconds: " + " ".join(f"{k}={v:.1f}" for k, v in
                                     seconds.items() if v is not None)
          + "; ms a call: " + " ".join(f"{k}={v:.3f}" for k, v in
                                       ms.items())
          + f"; the rewrite costs {ms['rewritten'] - ms['export']:+.3f} ms "
          f"a call, eagerly")
    if epoch is None or raw_transposed == 0 or left or operators \
            or counts != (0, 0) or tuple(got.shape) != (
                1, P21_CG_SIZE, P21_CG_SIZE, 3) \
            or not all(e <= P21_CG_RTOL for e in errs.values()):
        raise AssertionError(f"21b: epoch {epoch}, transposed "
                             f"{raw_transposed} -> {left}, {operators}, "
                             f"counts {counts}, errors {errs}")
    return {"counts": counts, "errors": errs, "seconds": seconds, "ms": ms}


def check_p21_hourglass(pose_workdir: str) -> dict:
    """21c: `Hourglass/torch/main.py` on phase 18e's hourglass104 run with
    `--checkpoint latest` and the epochs it has (nothing more trains):
    the best (else latest) epoch's directory copied file for file, and
    output.txt naming it."""
    ckpt = CheckpointManager(os.path.join(pose_workdir, "ckpt"))
    try:
        latest = ckpt.latest_epoch()
        best = ckpt.best_epoch() or latest
    finally:
        ckpt.close()
    export_dir = tempfile.mkdtemp(prefix="chip_smoke_p21c_")
    atexit.register(shutil.rmtree, export_dir, ignore_errors=True)
    main = runpy.run_path(os.path.join(HERE, "Hourglass", "torch",
                                       "main.py"), run_name="chip_smoke")[
        "main"]
    t0 = time.perf_counter()
    flash_attention.launches = best_iou.launches = 0
    dst = main(["--epochs", str(latest), "--checkpoint", "latest",
                "--synthetic", "--workdir", pose_workdir, "--export-dir",
                export_dir, "--version", P21_VERSION, "--device",
                P21_DEVICE])
    wall = time.perf_counter() - t0
    counts = (flash_attention.launches, best_iou.launches)
    src = os.path.join(pose_workdir, "ckpt", str(best))
    names = sorted(os.listdir(src))
    equal = sorted(os.listdir(dst)) == names and all(
        filecmp.cmp(os.path.join(src, n), os.path.join(dst, n),
                    shallow=False) for n in names)
    with open(os.path.join(tempfile.gettempdir(), "output.txt")) as fh:
        named = fh.read()
    phase(f"21c Hourglass/torch/main.py: epoch {best} (latest {latest}) "
          f"copied to {os.path.basename(dst)}, {len(names)} files equal="
          f"{equal}; output.txt names it: {named == dst + chr(10)}; K1 and "
          f"K2 launches {counts}; {wall:.1f}s")
    if dst != os.path.join(export_dir, f"hourglass-v{P21_VERSION}-epoch-"
                                       f"{best}") \
            or not equal or named != dst + "\n" or counts != (0, 0):
        raise AssertionError(f"21c: {dst} equal={equal} {named!r} {counts}")
    return {"epoch": best, "files": len(names), "seconds": wall}


def p21_reference_resnet50(seed: int) -> dict:
    """A ResNet-50 state dict in the reference's naming
    (`ResNet/pytorch/models/resnet50.py:20-44,99-165`: conv1/bn1,
    conv{2,3,4,5}x.<i>.conv<j>/bn<j> with the stride on conv1, a
    projection on each stage's first block, linear), seeded: He-scaled
    convs, BatchNorm scales of 0.5 and statistics away from their init."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key] = torch.randn(cout, cin, k, k, generator=gen) * (
            2.0 / (cin * k * k)) ** 0.5

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = 0.5 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{prefix}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{prefix}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{prefix}.running_var"] = 1 + torch.rand(c, generator=gen)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(100)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, (stage, n) in enumerate(zip(("conv2x", "conv3x", "conv4x",
                                        "conv5x"), (3, 4, 6, 3))):
        mid = 64 * 2 ** s
        for i in range(n):
            t = f"{stage}.{i}"
            conv(f"{t}.conv1.weight", mid, cin, 1)
            bn(f"{t}.bn1", mid)
            conv(f"{t}.conv2.weight", mid, mid, 3)
            bn(f"{t}.bn2", mid)
            conv(f"{t}.conv3.weight", 4 * mid, mid, 1)
            bn(f"{t}.bn3", 4 * mid)
            if i == 0:
                conv(f"{t}.projection.0.weight", 4 * mid, cin, 1)
                bn(f"{t}.projection.1", 4 * mid)
            cin = 4 * mid
    sd["linear.weight"] = torch.randn(1000, cin, generator=gen) / cin ** 0.5
    sd["linear.bias"] = 0.01 * torch.randn(1000, generator=gen)
    return sd


def check_p21_import() -> dict:
    """21d: a reference-named ResNet-50 `.pt` made from seeded tensors,
    imported by the port's tool, served in process on the card at bucket
    P21_BUCKET and on the CPU from the same workdir."""
    root = tempfile.mkdtemp(prefix="chip_smoke_p21d_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    path, wd = os.path.join(root, "resnet50.pt"), os.path.join(root, "wd")
    torch.save({"epoch": P21_IMPORT_EPOCH,
                "model": p21_reference_resnet50(23),
                "optimizer": {"state": {}, "param_groups": []}}, path)
    t0 = time.perf_counter()
    got = import_torch_checkpoint.main(["-m", P21_IMPORT, "--torch-ckpt",
                                        path, "--workdir", wd,
                                        "--device", P21_DEVICE])
    import_s = time.perf_counter() - t0
    engines = {d: PredictEngine.from_config(
        P21_IMPORT, workdir=wd, device=d, buckets=(P21_BUCKET,),
        image_size=P21_IMPORT_SIZE, verbose=False)
        for d in (P21_DEVICE, "cpu")}
    card = engines[P21_DEVICE]
    x = np.random.RandomState(24).randn(P21_BUCKET, *card.example_shape
                                        ).astype(np.float32)
    flash_attention.launches = best_iou.launches = 0
    served = card.predict(x)
    counts = (flash_attention.launches, best_iou.launches)
    want = engines["cpu"].predict(x)
    err = float(np.abs(served - want).max() / max(np.abs(want).max(),
                                                  1e-30))
    batch_ms = card.measure_batch_ms(P21_BUCKET, P21_ITERS)
    prov = card.provenance
    phase(f"21d {P21_IMPORT} imported from a reference-named .pt in "
          f"{import_s:.1f}s: pins {got['pins']}, epoch {got['epoch']}; "
          f"served from the workdir: provenance epoch "
          f"{prov['checkpoint_epoch']} verified {prov['verified']}; bucket "
          f"{P21_BUCKET} on the card vs the CPU engine, relative to the "
          f"largest logit: {err:.3g} (logit scale {np.abs(want).max():.3g}; "
          f"bound {CPU_RTOL:g}); K1 and K2 launches {counts}; "
          f"measure_batch_ms {batch_ms:.3f}")
    if got["pins"] != {"stride_on_first": True} \
            or prov["checkpoint_epoch"] != P21_IMPORT_EPOCH \
            or not prov["verified"] or served.shape != (P21_BUCKET, 1000) \
            or not np.isfinite(want).all() or not err <= CPU_RTOL \
            or counts != (0, 0):
        raise AssertionError(f"21d: {got} {prov} err {err} {counts}")
    return {"error": err, "import_s": import_s, "batch_ms": batch_ms}


def check_export(export_run: dict, convert_run: dict, vit_workdir: str,
                 cyclegan_workdir: str, pose_workdir: str) -> dict:
    """Phase 21, slice 19: model export and the PyTorch checkpoint
    importer. 21a the vit_small program and package (K1 counted in a
    window of one call each), 21b the cyclegan package, 21c the Hourglass
    train-then-export wrapper, 21d the imported ResNet-50 served."""
    t0 = time.perf_counter()
    out = {"21a": check_p21_export(export_run, vit_workdir)}
    out["21c"] = check_p21_hourglass(pose_workdir)
    out["21d"] = check_p21_import()
    out["21b"] = check_p21_convert(convert_run, cyclegan_workdir)
    phase(f"21: phase 21 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 22: the Keras, call-order and GAN checkpoint importers ------------
#
# The fixture writers below are test tooling, not features of the port: the
# card's machine has neither h5py nor TensorFlow, so the script writes the
# reference's files itself. tests/test_torch_h5.py and tests/test_torch_tf_
# checkpoint.py read what they write back with h5py and TensorFlow.

P22_DEVICE = "cuda"
P22_EPOCH = 40                      # 22a's --epoch, as the reference names it
P22_STEPS = 2                       # 22a's resumed train steps
P22_HG = "hourglass104"             # 22b
P22_HG_SIZE = None                  # 22b served at the config's 256 px
P22_CG_BLOCKS = 9                   # 22c
P22_CG_SIZE = None                  # 22c at the config's 256 px
P22_PINS = {}                       # {model: kwargs} pinned in 22a-b's workdirs
P22_COUNTERS = {"dcgan": ("step", 12), "cyclegan": ("epoch", 7)}
P22_HEADS_RTOL = 1e-3               # 22a: f32 heads, card vs CPU (phase 12's)
P22_SERVE_TOL = P13_SERVE_TOL       # 22b: bf16 heatmaps, card vs CPU
P22_GAN_TOL = 1e-3                  # 22c: f32 tanh images (at most 1), card
                                    # vs CPU: as 22a, 1e-3 of the largest

H5_LEAF_K, H5_NODE_K = 4, 16        # h5py's: 8 names a symbol node, 32
H5_UNDEF = 0xFFFFFFFFFFFFFFFF       # children a B-tree node


def _h5_message(mtype: int, body: bytes) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _h5_header(messages) -> bytes:
    """A version-1 object header: the 16-byte prefix, then its messages."""
    block = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                       len(block)) + block


def _h5_datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        exp_at, exp_size, mant, bias = {2: (10, 5, 10, 15),
                                        4: (23, 8, 23, 127),
                                        8: (52, 11, 52, 1023)}[size]
        bits = 0x20 | (8 * size - 1) << 8      # implied msb, the sign bit
        return (struct.pack("<B3sI", 0x11, bits.to_bytes(3, "little"), size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp_at, exp_size, 0,
                              mant, bias))
    if dtype.kind in "iu":
        bits = 0x08 if dtype.kind == "i" else 0
        return (struct.pack("<B3sI", 0x10, bits.to_bytes(3, "little"), size)
                + struct.pack("<HH", 0, 8 * size))
    raise ValueError(f"no HDF5 datatype written for {dtype}")


class H5Writer:
    """A minimal writer of h5py's default layout: superblock 0, version-1
    object headers, symbol-table groups (a v1 B-tree of any depth, a local
    heap, symbol nodes) and contiguous little-endian datasets."""

    def __init__(self, fp):
        self.fp = fp
        self.at = 96                            # after the superblock

    def _put(self, data: bytes) -> int:
        address = self.at
        self.fp.seek(address)
        self.fp.write(data)
        self.at += len(data) + (-len(data) % 8)
        return address

    def dataset(self, array) -> int:
        array = np.asarray(array)
        if array.dtype.itemsize > 1:
            array = array.astype(array.dtype.newbyteorder("<"), copy=False)
        address = self._put(array.tobytes()) if array.nbytes else H5_UNDEF
        space = struct.pack("<BBB5x", 1, array.ndim, 0) + b"".join(
            struct.pack("<Q", d) for d in array.shape)
        return self._put(_h5_header([
            _h5_message(0x0001, space),
            _h5_message(0x0003, _h5_datatype(array.dtype)),
            _h5_message(0x0008, struct.pack("<BBQQ", 3, 1, address,
                                            array.nbytes))]))

    def group(self, members: dict) -> tuple:
        """Write `members` (name: a dict for a group, an array for a
        dataset), then the group: (its header, B-tree, heap addresses)."""
        entries = []
        for name, value in members.items():
            if isinstance(value, dict):
                header, btree, heap = self.group(value)
                entries.append((name.encode(), header, 1, btree, heap))
            else:
                entries.append((name.encode(), self.dataset(value), 0, 0, 0))
        entries.sort(key=lambda e: e[0])
        heap_data, offsets = bytearray(8), {}   # offset 0: the empty name
        for e in entries:
            offsets[e[0]] = len(heap_data)
            heap_data += e[0] + b"\0" * (8 - len(e[0]) % 8)
        data_at = self._put(bytes(heap_data))
        heap = self._put(b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap_data), 1, data_at))  # 1: no free block
        # symbol nodes of up to 2K names, then B-tree levels of up to 2K
        # children, each key the last name below the child before it
        children = []
        for i in range(0, len(entries), 2 * H5_LEAF_K):
            chunk = entries[i:i + 2 * H5_LEAF_K]
            body = b"".join(struct.pack("<QQIIQQ", offsets[n], h, cache, 0,
                                        bt, hp)
                            for n, h, cache, bt, hp in chunk)
            body += b"\0" * (40 * 2 * H5_LEAF_K - len(body))
            children.append((self._put(
                b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + body),
                offsets[chunk[-1][0]]))
        level = 0
        while True:
            nodes = []
            for i in range(0, max(len(children), 1), 2 * H5_NODE_K):
                chunk = children[i:i + 2 * H5_NODE_K]
                body = struct.pack("<Q", 0) + b"".join(
                    struct.pack("<QQ", child, key) for child, key in chunk)
                body += b"\0" * (8 + 16 * 2 * H5_NODE_K - len(body))
                nodes.append((self._put(
                    b"TREE" + struct.pack("<BBHQQ", 0, level, len(chunk),
                                          H5_UNDEF, H5_UNDEF) + body),
                    chunk[-1][1] if chunk else 0))
            if len(nodes) == 1:
                break
            children, level = nodes, level + 1
        btree = nodes[0][0]
        header = self._put(_h5_header([_h5_message(
            0x0011, struct.pack("<QQ", btree, heap))]))
        return header, btree, heap

    def finish(self, root: tuple) -> None:
        header, btree, heap = root
        self.fp.seek(0)
        self.fp.write(b"\x89HDF\r\n\x1a\n" + struct.pack(
            "<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, H5_LEAF_K, H5_NODE_K, 0)
            + struct.pack("<QQQQ", 0, H5_UNDEF, self.at, H5_UNDEF)
            + struct.pack("<QQIIQQ", 0, header, 1, 0, btree, heap))
        self.fp.truncate(self.at)


def write_h5(path: str, tree: dict) -> int:
    """Write nested dicts of arrays as an HDF5 file in h5py's default
    layout; returns its size in bytes."""
    with open(path, "wb") as fp:
        w = H5Writer(fp)
        w.finish(w.group(tree))
        return w.at


# the DataType enum of what the bundle writer writes
TF_DTYPES = {np.dtype("<f4"): 1, np.dtype("<f8"): 2, np.dtype("<i4"): 3,
             np.dtype("<i8"): 9, np.dtype("bool"): 10, np.dtype("<f2"): 19}
TABLE_RESTART = 16                  # LevelDB's restart interval


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb(number: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(value, bytes):
        return _varint(number << 3 | 2) + _varint(len(value)) + value
    return _varint(number << 3) + _varint(value)


def _table_block(items, restart: int) -> bytes:
    """A LevelDB block: prefix-compressed entries, a restart point every
    `restart` entries, the restart array and its count."""
    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(items):
        shared = 0
        if i % restart:
            while (shared < min(len(key), len(last))
                   and key[shared] == last[shared]):
                shared += 1
        else:
            restarts.append(len(out))
        out += (_varint(shared) + _varint(len(key) - shared)
                + _varint(len(value)) + key[shared:] + value)
        last = key
    restarts = restarts or [0]
    return (bytes(out) + struct.pack(f"<{len(restarts)}I", *restarts)
            + struct.pack("<I", len(restarts)))


def write_tf_checkpoint(prefix: str, tensors: dict, crc,
                        block_size: int = 4096) -> str:
    """Write `tensors` ({name: array}) as a V2 tensor bundle: one data
    shard, an uncompressed index table of about `block_size`-byte data
    blocks with their CRC32Cs (`crc` computes them), and the directory's
    `checkpoint` state file naming it. Returns the prefix."""
    entries, offset = [], 0
    with open(f"{prefix}.data-00000-of-00001", "wb") as fp:
        for name in sorted(tensors):
            array = np.asarray(tensors[name])
            data = array.tobytes()
            shape = b"".join(_pb(2, _pb(1, d)) for d in array.shape)
            entries.append((name.encode(), (
                _pb(1, TF_DTYPES[array.dtype]) + _pb(2, shape)
                + _pb(4, offset) + _pb(5, len(data)) + _varint(6 << 3 | 5)
                + struct.pack("<I", recs.masked_crc(crc(data))))))
            fp.write(data)
            offset += len(data)
    header = _pb(1, 1) + _pb(3, _pb(1, 1))      # one shard; producer 1
    items = [(b"", header)] + entries
    out, index = bytearray(), []

    def put(block: bytes) -> bytes:
        handle = _varint(len(out)) + _varint(len(block))
        out.extend(block + b"\0" + struct.pack(
            "<I", recs.masked_crc(crc(block + b"\0"))))
        return handle

    start = 0
    for i in range(1, len(items) + 1):
        size = sum(len(k) + len(v) + 3 for k, v in items[start:i])
        if i == len(items) or size >= block_size:
            index.append((items[i - 1][0],
                          put(_table_block(items[start:i], TABLE_RESTART))))
            start = i
    footer = put(_table_block([], TABLE_RESTART))        # the meta-index
    footer += put(_table_block(index, 1))
    out += footer + b"\0" * (40 - len(footer)) + struct.pack(
        "<Q", 0xDB4775248B80FB57)
    with open(f"{prefix}.index", "wb") as fp:
        fp.write(bytes(out))
    directory, base = os.path.split(prefix)
    with open(os.path.join(directory, "checkpoint"), "w") as fp:
        fp.write(f'model_checkpoint_path: "{base}"\n'
                 f'all_model_checkpoint_paths: "{base}"\n')
    return prefix


def p22_root(tag: str) -> str:
    root = tempfile.mkdtemp(prefix=f"chip_smoke_p22{tag}_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    return root


def p22_pinned(name: str, workdir: str):
    """`name`'s config with its P22_PINS, which also go to `workdir`'s
    `model_kwargs.json` (none at full width)."""
    cfg, pins = get_config(name), P22_PINS.get(name)
    if not pins:
        return cfg
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "model_kwargs.json"), "w") as fp:
        json.dump(pins, fp)
    return cfg.replace(model_kwargs={**cfg.model_kwargs, **pins})


def keras_weights(module, kind: str, rng) -> dict:
    """Seeded Keras weights of a layer like the port's `module` of `kind`
    (Conv, ConvTranspose, Dense, BatchNorm) in Keras's layouts: HWIO,
    (kh, kw, out, in), (in, out). He-normal kernels; scales, shifts and
    moving statistics in ranges that keep a deep stack finite."""
    if kind == "BatchNorm":
        c = module.num_features
        u = lambda lo, hi: rng.uniform(lo, hi, c).astype(np.float32)  # noqa: E731
        return {"gamma": u(0.7, 1.3), "beta": u(-0.3, 0.3),
                "moving_mean": u(-0.3, 0.3), "moving_variance": u(0.5, 2.0)}
    o, i, *hw = module.weight.shape
    shape = {"Conv": (*hw, i, o), "ConvTranspose": (*hw, o, i),
             "Dense": (i, o)}[kind]
    fan = int(np.prod(hw, dtype=np.int64)) * i
    out = {"kernel": rng.standard_normal(shape, dtype=np.float32)
           * np.float32(np.sqrt(2.0 / fan))}
    if module.bias is not None:
        out["bias"] = rng.uniform(-0.3, 0.3, o).astype(np.float32)
    return out


def port_weights(kind: str, w: dict) -> dict:
    """The port's leaves (models/common.py's layouts) that Keras weights
    `w` of a `kind` layer must become."""
    if kind == "BatchNorm":
        return {"weight": w["gamma"], "bias": w["beta"],
                "running_mean": w["moving_mean"],
                "running_var": w["moving_variance"]}
    k = w["kernel"]
    if kind == "Conv":
        out = {"weight": k.transpose(3, 2, 0, 1)}        # HWIO -> OIHW
    elif kind == "ConvTranspose":   # Keras's is the conv's gradient: flip
        out = {"weight": k[::-1, ::-1].transpose(2, 3, 0, 1)}
    else:
        out = {"weight": k.T}                            # (in, out)
    if "bias" in w:
        out["bias"] = w["bias"]
    return out


def unequal_leaves(state: dict, expected: dict) -> list:
    """The names of `expected` whose arrays `state` does not hold bit for
    bit."""
    return [k for k, v in expected.items()
            if k not in state or not np.array_equal(
                state[k].detach().float().cpu().numpy(), v)]


def yolo_reference_tree(model, rng) -> tuple:
    """Seeded weights of `model` (a port YoloV3) in the reference's layer
    names (`deepvision_tpu_torch/utils/keras_convert.py`'s grammar), laid
    out as the reference's h5: Darknet-53's layers inside the
    `darknet_53` group, every other layer in a group of its name holding
    a group of its name. Returns (the tree, the state_dict entries it
    must become)."""
    names = {"darknet53.ConvBNLeaky_0": "conv2d_0"}
    r = 0
    for stage, blocks in enumerate(stage_blocks_of(model)):
        names[f"darknet53.ConvBNLeaky_{stage + 1}"] = f"conv2d_{stage + 1}"
        for j in range(blocks):
            for k, tap in enumerate(("1x1", "3x3")):
                names[f"darknet53.DarknetResidual_{r}.ConvBNLeaky_{k}"] = \
                    f"residual_{stage}_{j}_{tap}"
            r += 1
    for scale in ("large", "medium", "small"):
        for k, tap in enumerate(("1x1_1", "3x3_1", "1x1_2", "3x3_2",
                                 "1x1_3", "3x3_3")):
            names[f"tower_{scale}.ConvBNLeaky_{k}"] = \
                f"detector_scale_{scale}_{tap}"
    for scale in ("medium", "small"):
        names[f"lateral_{scale}"] = f"detector_scale_{scale}_1x1_0"
    layers = [(f"{port}.{sub}", f"{ref}_{suffix}", kind)
              for port, ref in names.items()
              for sub, suffix, kind in (("Conv_0", "conv2d", "Conv"),
                                        ("BatchNorm_0", "bn", "BatchNorm"))]
    layers += [(f"tower_{scale}.final_conv",
                f"detector_scale_{scale}_final_conv2d", "Conv")
               for scale in ("large", "medium", "small")]
    mods = dict(model.named_modules())
    tree, expected = {}, {}
    for port, layer, kind in layers:
        w = keras_weights(mods[port], kind, rng)
        outer = "darknet_53" if port.startswith("darknet53.") else layer
        tree.setdefault(outer, {})[layer] = {f"{k}:0": v
                                             for k, v in w.items()}
        expected.update({f"{port}.{leaf}": a
                         for leaf, a in port_weights(kind, w).items()})
    return tree, expected


def check_p22_yolo() -> dict:
    """22a: yolov3 at full width from a reference-named h5 through
    `import_keras_checkpoint` on the card, then trained on by
    `YOLO/torch/train.py -c latest` with K2 counted."""
    root = p22_root("a")
    h5_path, wd = os.path.join(root, "yolov3_best.h5"), os.path.join(root,
                                                                     "wd")
    cfg = p22_pinned(YOLO_MODEL, wd)
    with torch.device("meta"):          # the layout: shapes, no weights
        layout = build_model(cfg)
    t0 = time.perf_counter()
    tree, expected = yolo_reference_tree(layout, np.random.default_rng(2201))
    nbytes = write_h5(h5_path, tree)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = import_keras_checkpoint.main([
        "-m", YOLO_MODEL, "--h5", h5_path, "--workdir", wd, "--epoch",
        str(P22_EPOCH), "--device", P22_DEVICE])
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, prov, _ = load_checkpoint_weights(YOLO_MODEL, wd, verbose=False)
    state = model.state_dict()
    unequal = unequal_leaves(state, expected)
    x = torch.from_numpy(np.random.RandomState(2202).rand(
        1, P15_SIZE, P15_SIZE, cfg.data.channels).astype(np.float32))
    heads = {}
    for device in (P22_DEVICE, "cpu"):
        with torch.device("meta"):
            m = build_model(cfg.replace(dtype="float32"))
        m.load_state_dict(state, assign=True)
        with torch.inference_mode():
            heads[device] = [h.float().cpu() for h in m.to(device).eval()(
                x.to(device), decode=False)]
    err = max(p21_rel(g, w) for g, w in zip(heads[P22_DEVICE], heads["cpu"]))
    finite = all(bool(torch.isfinite(h).all()) for h in heads["cpu"])
    compare_s = time.perf_counter() - t0
    flash_attention.launches = best_iou.launches = 0
    t0 = time.perf_counter()
    trainer, result = run_detection("YOLO", [YOLO_MODEL], p15_argv(
        wd, P22_EPOCH + 1, "-c", "latest", "--steps-per-epoch",
        str(P22_STEPS)))
    resume_s = time.perf_counter() - t0
    launches = (flash_attention.launches, best_iou.launches)
    losses = [s["loss"] for s in trainer.last_epoch_steps]
    committed = verified_epochs(os.path.join(wd, "ckpt"))
    want = P22_STEPS + P15_EVAL_BATCHES
    phase(f"22a {YOLO_MODEL} ({sum(v.size for v in expected.values()):,} "
          f"weights, {len(expected)} leaves) as a reference-named h5 of "
          f"{nbytes / 1e6:.1f} MB written in {write_s:.1f}s, imported on "
          f"the card in {import_s:.1f}s (epoch {got['epoch']}); restored "
          f"from the workdir (verified {prov['verified']}, epoch "
          f"{prov['checkpoint_epoch']}): {len(unequal)} leaves differ from "
          f"the file's; raw heads at 1 x {P15_SIZE} px in f32, card vs CPU, "
          f"relative to the largest: {err:.3g} (bound {P22_HEADS_RTOL:g}) "
          f"in {compare_s:.1f}s; resumed by YOLO/torch/train.py -c latest "
          f"for {P22_STEPS} steps in {resume_s:.1f}s: losses {losses}, "
          f"val {result.get('loss')}, committed epochs {committed}; "
          f"launches (flash_attention, best_iou) {launches} for "
          f"{P22_STEPS} train steps and {P15_EVAL_BATCHES} eval batches")
    if unequal or not prov["verified"] \
            or prov["checkpoint_epoch"] != P22_EPOCH \
            or not finite or not err <= P22_HEADS_RTOL:
        raise AssertionError(f"22a: import: unequal {unequal[:5]}, {prov}, "
                             f"heads err {err}")
    if launches != (0, want) or len(losses) != P22_STEPS \
            or not all(np.isfinite(losses)) \
            or committed != [P22_EPOCH, P22_EPOCH + 1] \
            or trainer.state.step != P22_STEPS:
        raise AssertionError(f"22a: resume: launches {launches} (want "
                             f"{want}), losses {losses}, committed "
                             f"{committed}, step {trainer.state.step}")
    return {"launches": launches[1], "train_steps": P22_STEPS,
            "eval_batches": P15_EVAL_BATCHES, "heads_err": err,
            "seconds": {"write": write_s, "import": import_s,
                        "compare": compare_s, "resume": resume_s}}


def auto_named_layers(model, *inputs) -> list:
    """[(module name, kind, Keras auto-name)] of `model`'s weighted
    modules in its call order, named per kind as Keras counts them
    (`conv2d`, `conv2d_1`, ..., `batch_normalization`, ...)."""
    prefix = {"Conv": "conv2d", "ConvTranspose": "conv2d_transpose",
              "Dense": "dense", "BatchNorm": "batch_normalization"}
    counts: dict = {}
    out = []
    for name, kind in order_convert.modules_in_call_order(model, *inputs):
        k = counts.get(kind, 0)
        counts[kind] = k + 1
        out.append((name, kind, prefix[kind] + (f"_{k}" if k else "")))
    return out


def check_p22_hourglass() -> dict:
    """22b: hourglass104 at full width from auto-named h5 groups in the
    port model's call order through `import_keras_checkpoint` on the card,
    served one batch in process on the card and on the CPU."""
    root = p22_root("b")
    h5_path, wd = os.path.join(root, "hourglass.h5"), os.path.join(root,
                                                                   "wd")
    cfg = p22_pinned(P22_HG, wd)
    size = cfg.data.image_size
    with torch.device("meta"):
        layout = build_model(cfg)
        layers = auto_named_layers(layout, torch.zeros(
            (1, size, size, cfg.data.channels)))
    rng = np.random.default_rng(2203)
    t0 = time.perf_counter()
    mods = dict(layout.named_modules())
    tree, expected = {}, {}
    for i in rng.permutation(len(layers)):      # on-disk order shuffled
        name, kind, lname = layers[i]
        w = keras_weights(mods[name], kind, rng)
        tree[lname] = {lname: {f"{k}:0": v for k, v in w.items()}}
        expected.update({f"{name}.{leaf}": a
                         for leaf, a in port_weights(kind, w).items()})
    nbytes = write_h5(h5_path, tree)
    write_s = time.perf_counter() - t0
    flash_attention.launches = best_iou.launches = 0
    t0 = time.perf_counter()
    import_keras_checkpoint.main(["-m", P22_HG, "--h5", h5_path,
                                  "--workdir", wd, "--epoch", "1",
                                  "--device", P22_DEVICE])
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engines = {d: PredictEngine.from_config(P22_HG, workdir=wd, device=d,
                                            buckets=(1,),
                                            image_size=P22_HG_SIZE,
                                            verbose=False)
               for d in (P22_DEVICE, "cpu")}
    x = np.random.RandomState(2204).randn(
        1, *engines["cpu"].example_shape).astype(np.float32)
    served = engines[P22_DEVICE].predict(x)
    counts = (flash_attention.launches, best_iou.launches)
    want = engines["cpu"].predict(x)
    err = leaf_rel_err(served, want)
    compare_s = time.perf_counter() - t0
    model, prov, _ = load_checkpoint_weights(P22_HG, wd, verbose=False,
                                             image_size=P22_HG_SIZE)
    unequal = unequal_leaves(model.state_dict(), expected)
    kinds = {k: sum(1 for _, kk, _ in layers if kk == k)
             for k in ("Conv", "BatchNorm")}
    phase(f"22b {P22_HG} ({kinds['Conv']} conv2d and {kinds['BatchNorm']} "
          f"batch_normalization groups in call order, shuffled on disk; "
          f"{nbytes / 1e6:.1f} MB) written in {write_s:.1f}s, imported on "
          f"the card in {import_s:.1f}s; {len(unequal)} leaves differ from "
          f"the file's (verified {prov['verified']}); served at 1 x "
          f"{engines['cpu'].example_shape[0]} px, card vs CPU engine, worst leaf relative to its largest "
          f"value: {err:.3g} (bound {P22_SERVE_TOL:g}) in {compare_s:.1f}s; "
          f"launches (flash_attention, best_iou) {counts}")
    if unequal or not prov["verified"] or not err <= P22_SERVE_TOL \
            or counts != (0, 0) or not all(
                np.isfinite(leaf).all() for leaf in _leaves(want)):
        raise AssertionError(f"22b: unequal {unequal[:5]}, {prov}, err "
                             f"{err}, counts {counts}")
    return {"err": err, "seconds": {"write": write_s, "import": import_s,
                                    "compare": compare_s}}


_P22_SUBLAYERS = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
                  "BatchNorm_1": "bn2"}


def gan_reference_tensors(obj: str, module, sample, rng) -> tuple:
    """Seeded weights of a port GAN network under the reference's object
    name `obj` in TF 2.1's checkpoint keys: `<obj>/layer_with_weights-<N>/
    <attr>/.ATTRIBUTES/VARIABLE_VALUE`, N counting weighted layers in call
    order, a CycleGAN residual block one layer whose sublayers are conv1,
    bn1, conv2, bn2. Returns (tensors, the state_dict entries they must
    become)."""
    mods = dict(module.named_modules())
    tensors, expected, blocks = {}, {}, {}
    n = -1
    for name, kind in order_convert.modules_in_call_order(module, sample):
        parent, _, child = name.rpartition(".")
        if parent.startswith("CycleGANResBlock_"):
            if parent not in blocks:
                n += 1
                blocks[parent] = n
            base = (f"{obj}/layer_with_weights-{blocks[parent]}/"
                    f"{_P22_SUBLAYERS[child]}")
        else:
            n += 1
            base = f"{obj}/layer_with_weights-{n}"
        w = keras_weights(mods[name], kind, rng)
        tensors.update({f"{base}/{k}/.ATTRIBUTES/VARIABLE_VALUE": v
                        for k, v in w.items()})
        expected.update({f"{name}.{leaf}": a
                         for leaf, a in port_weights(kind, w).items()})
    return tensors, expected


def p22_gan_networks(family: str) -> dict:
    """{reference object name: (port trainer's network key, a layout
    module on meta, a sample input)} of a GAN family."""
    if family == "dcgan":
        with torch.device("meta"):
            return {"generator": ("", DCGANGenerator(),
                                  torch.zeros((1, 100))),
                    "discriminator": ("", DCGANDiscriminator(),
                                      torch.zeros((1, 28, 28, 1)))}
    size = P22_CG_SIZE or get_config("cyclegan").data.image_size
    with torch.device("meta"):
        image = torch.zeros((1, size, size, 3))
        return {**{f"generator_{k}": (k, CycleGANGenerator(P22_CG_BLOCKS),
                                      image) for k in ("a2b", "b2a")},
                **{f"discriminator_{k}": (k, PatchGANDiscriminator(), image)
                   for k in ("a", "b")}}


def check_p22_gan(family: str) -> dict:
    """22c: a GAN family's `tf.train` bundle in TF 2.1's names through
    `import_gan_checkpoint` on the card: the counter's epoch, the weights,
    one generator call on the card against the CPU."""
    root = p22_root(f"c_{family}")
    rng = np.random.default_rng(2205 if family == "dcgan" else 2206)
    counter, value = P22_COUNTERS[family]
    t0 = time.perf_counter()
    tensors = {f"{counter}/.ATTRIBUTES/VARIABLE_VALUE": np.array(value,
                                                                 np.int64)}
    expected = {"gen": {}, "disc": {}}
    for obj, (key, module, sample) in p22_gan_networks(family).items():
        got, want = gan_reference_tensors(obj, module, sample, rng)
        tensors.update(got)
        side = "gen" if obj.startswith("generator") else "disc"
        expected[side].update({f"{key}.{k}" if key else k: v
                               for k, v in want.items()})
    ckpt_dir, wd = os.path.join(root, "ref"), os.path.join(root, "wd")
    os.makedirs(ckpt_dir)
    device = torch.device(P22_DEVICE)
    write_tf_checkpoint(os.path.join(ckpt_dir, "ckpt-1"), tensors,
                        jpeg.host_crc32c(device) if device.type == "cuda"
                        else crc32c_np)
    nbytes = sum(v.nbytes for v in tensors.values())
    write_s = time.perf_counter() - t0
    flash_attention.launches = best_iou.launches = 0
    t0 = time.perf_counter()
    argv = ["--family", family, "--ckpt", ckpt_dir, "--workdir", wd,
            "--device", P22_DEVICE]
    if family == "cyclegan":
        argv += ["--n-blocks", str(P22_CG_BLOCKS)]
    got = import_gan_checkpoint.main(argv)
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = get_config(family)
    outs, unequal, epochs = {}, [], {}
    rs = np.random.RandomState(2207)
    size = P22_CG_SIZE or cfg.data.image_size
    x = (rs.randn(2, 100) if family == "dcgan"
         else rs.uniform(-1, 1, (1, size, size, 3))).astype(np.float32)
    for device in (P22_DEVICE, "cpu"):
        if family == "dcgan":
            trainer = DCGANTrainer(cfg, workdir=wd, device=device)
        else:
            trainer = CycleGANTrainer(cfg, workdir=wd, device=device,
                                      n_blocks=P22_CG_BLOCKS)
        try:
            epochs[device] = trainer.resume(verify="strict")
            if device == "cpu":
                unequal = (unequal_leaves(trainer.gen_state.model.state_dict(),
                                          expected["gen"])
                           + unequal_leaves(
                               trainer.disc_state.model.state_dict(),
                               expected["disc"]))
            if family == "dcgan":
                with torch.inference_mode():
                    outs[device] = trainer.generator.eval()(
                        torch.from_numpy(x).to(device)).cpu().numpy()
            else:
                outs[device] = trainer.translate(x, "a2b")
        finally:
            trainer.close()
    err = float(np.abs(outs[P22_DEVICE] - outs["cpu"]).max())
    compare_s = time.perf_counter() - t0
    counts = (flash_attention.launches, best_iou.launches)
    phase(f"22c {family}: a tf.train bundle of {len(tensors)} tensors "
          f"({nbytes / 1e6:.1f} MB, TF 2.1 names, {counter} {value}) "
          f"written in {write_s:.1f}s, imported on the card in "
          f"{import_s:.1f}s as epoch {got['epoch']} (resumed: {epochs}); "
          f"{len(unequal)} leaves differ from the bundle's; one generator "
          f"call {outs['cpu'].shape}, card vs CPU max_abs_err {err:.3g} "
          f"(bound {P22_GAN_TOL:g}) in {compare_s:.1f}s; launches "
          f"(flash_attention, best_iou) {counts}")
    if got["epoch"] != value or set(epochs.values()) != {value} or unequal \
            or not np.isfinite(outs["cpu"]).all() \
            or not err <= P22_GAN_TOL or counts != (0, 0):
        raise AssertionError(f"22c {family}: epoch {got['epoch']} "
                             f"{epochs}, unequal {unequal[:5]}, err {err}, "
                             f"counts {counts}")
    return {"err": err, "seconds": {"write": write_s, "import": import_s,
                                    "compare": compare_s}}


def check_importers() -> dict:
    """Phase 22, slice 20: the Keras, call-order and GAN checkpoint
    importers (K2 in 22a's resumed run; K1 and K2 idle in 22b-c)."""
    t0 = time.perf_counter()
    out = {"22a": check_p22_yolo(), "22b": check_p22_hourglass(),
           "22c": {f: check_p22_gan(f) for f in ("dcgan", "cyclegan")}}
    phase(f"22: phase 22 took {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 23: the IR audit ----------------------------------------------------

P23_UNITS = ("vit_small", "yolov3", "attn", "quant")
P23_NICE = 10
P23_TIMEOUT = 900                  # from the script's start
P23_BASELINE = os.path.join(HERE, "CHECK_COST_TORCH.json")


def start_p23_audit() -> dict:
    """23a's audit as a process of its own, started at the script's
    start: fake tensors on the CPU, one thread at nice +P23_NICE, no card
    (CUDA_VISIBLE_DEVICES empty); its JSON report to a file. A script
    that ends first kills it."""
    root = tempfile.mkdtemp(prefix="chip_smoke_p23_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    out, log = os.path.join(root, "audit.json"), os.path.join(root, "log")
    with open(out, "w") as fo, open(log, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepvision_tpu_torch.check", *P23_UNITS,
             "--format", "json"], env=env, stdout=fo, stderr=fe, cwd=HERE)
    atexit.register(p21_stop, proc)
    try:
        os.setpriority(os.PRIO_PROCESS, proc.pid,
                       os.getpriority(os.PRIO_PROCESS, 0) + P23_NICE)
    except ProcessLookupError:   # it failed already; 23a says how
        pass
    return {"proc": proc, "out": out, "log": log, "t0": time.perf_counter()}


def p23_baseline() -> dict:
    with open(P23_BASELINE) as fp:
        return json.load(fp)


def check_p23_audit(run: dict, baseline: dict) -> dict:
    """23a: the audit exits 0 with no finding; every row's FLOPs equal the
    baseline's, bytes and op counts within its tolerance (the audit's own
    COST check; their drift printed here)."""
    from deepvision_tpu_torch.check.rules import COST_TOLERANCE
    t0 = time.perf_counter()
    try:
        rc = run["proc"].wait(timeout=max(
            1.0, P23_TIMEOUT - (t0 - run["t0"])))
    except subprocess.TimeoutExpired:
        p21_stop(run["proc"])
        rc = None
    waited = time.perf_counter() - t0
    with open(run["out"]) as fh:
        text = fh.read()
    with open(run["log"]) as fh:
        log = fh.read()
    if rc != 0:
        raise AssertionError(f"23a audit exited {rc}:\n{text[-3000:]}\n"
                             f"{log[-3000:]}")
    report = json.loads(text)
    rows, base = report["cost"], baseline["units"]
    prefixes = tuple(u if u in ("attn", "quant") else u + "/"
                     for u in P23_UNITS)
    expected = {u for u in base if u.startswith(prefixes)}
    drift = {f: max(abs(r[f] - base[u][f]) / max(abs(base[u][f]), 1)
                    for u, r in rows.items())
             for f in ("flops", "bytes", "eqns")}
    unequal = [u for u, r in rows.items() if r["flops"] != base[u]["flops"]]
    phase(f"23a audit of {' '.join(P23_UNITS)} (torch "
          f"{torch.__version__}, no jax, fake tensors on the CPU): rc {rc}, "
          f"{report['summary']['units']} units, "
          f"{report['summary']['findings']} findings, "
          f"{report['summary']['seconds']} s beside phases 1-22 (waited "
          f"{waited:.1f} s); {len(rows)} cost rows against "
          f"CHECK_COST_TORCH.json (torch {baseline['torch']}): FLOPs unequal "
          f"{unequal}; largest drift bytes {drift['bytes']:.3%} eqns "
          f"{drift['eqns']:.3%} (tolerance {COST_TOLERANCE['bytes']:.0%}, "
          f"{COST_TOLERANCE['eqns']:.0%})")
    if report["findings"] or unequal or set(rows) != expected:
        raise AssertionError(f"23a: findings {report['findings']}, FLOPs "
                             f"unequal {unequal}, rows {sorted(rows)}")
    return {"rc": rc, "units": report["summary"]["units"], "drift": drift,
            "seconds": report["summary"]["seconds"], "waited_s": waited}


class P23Capture(Recorder):
    """The audit's recorder, which also keeps each K1 and K2 call's
    inputs and outputs, to hold them against the plain versions."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if str(func.overloadpacket) in ("deepvision.flash_attention",
                                        "deepvision.best_iou"):
            self.calls.append((str(func.overloadpacket), args, out))
        return out


def check_p23_program(module, x: torch.Tensor, baseline: dict) -> dict:
    """23b: one call of phase 21a's vit_small program under the recorder:
    K1's nodes and launches, each node's output against the plain
    version on its own inputs, FLOPs against the `vit_small/serve` row."""
    depth = get_config(P21_VIT).model_kwargs["depth"]
    rec = P23Capture()
    flash_attention.launches = 0
    with torch.inference_mode():
        with rec:
            logits = module(x)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        errs = [(out.float() - flash_attention_reference(
            q, k, v, scale=scale).float()).abs().max().item()
            for _, (q, k, v, scale), out in rec.calls]
    nodes = rec.trace.count("deepvision.flash_attention")
    want = baseline["units"][f"{P21_VIT}/serve"]["flops"]
    phase(f"23b {P21_VIT} program (21a, batch {x.shape[0]}) under the "
          f"recorder: {nodes} deepvision.flash_attention nodes, {launches} "
          f"K1 launches (depth {depth}); each node against "
          f"flash_attention_reference on its inputs: max_abs_err="
          f"{max(errs):.3g} (bound {TOL[torch.bfloat16]:g}); FLOPs "
          f"{rec.trace.flops} vs the {P21_VIT}/serve row {want}; "
          f"{rec.trace.eqns} ops, {rec.trace.bytes} bytes")
    if nodes != depth or launches != depth or len(errs) != depth \
            or not max(errs) <= TOL[torch.bfloat16] \
            or rec.trace.flops != want \
            or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"23b: nodes {nodes}, launches {launches}, "
                             f"errors {errs}, FLOPs {rec.trace.flops}")
    return {"nodes": nodes, "launches": launches, "max_abs_err": max(errs),
            "flops": rec.trace.flops}


def check_p23_yolo_step(baseline: dict) -> dict:
    """23c: one real yolov3 train step at 416 px on the card at the
    audit's batch, under the recorder (the backward on the calling
    thread): one K2 node and one launch, its output bit for bit against
    `best_iou_reference`, FLOPs against the fake-traced row."""
    from deepvision_tpu_torch.check.harness import AUDIT_BATCH
    from deepvision_tpu_torch.core.detection import (boxes_calibration_batch,
                                                     make_yolo_train_step)
    from deepvision_tpu_torch.core.optim import build_optimizer
    from deepvision_tpu_torch.core.train_state import TrainState

    t0 = time.perf_counter()
    cfg = get_config(YOLO_MODEL)
    size = cfg.data.image_size
    device = torch.device("cuda")
    model = build_model(cfg).to(device)
    state = TrainState(model, build_optimizer(
        model.parameters(), cfg.optimizer, cfg.schedule, 1,
        cfg.total_epochs), seed=cfg.seed)
    step = make_yolo_train_step(num_classes=cfg.data.num_classes,
                                grid_sizes=yolo_grid_sizes(size),
                                compute_dtype=getattr(torch, cfg.dtype))
    batch = [torch.from_numpy(a).to(device) for a in boxes_calibration_batch(
        cfg, (size, size, cfg.data.channels), AUDIT_BATCH, seed=23)]
    rec = P23Capture()
    best_iou.launches = 0
    with torch.autograd.set_multithreading_enabled(False), rec:
        metrics = step(state, *batch)
    torch.cuda.synchronize()
    launches = best_iou.launches
    nodes = rec.trace.count("deepvision.best_iou")
    exact, err = True, 0.0
    for _, (preds, gt), outs in rec.calls:
        refs = best_iou_reference(list(preds), gt)
        exact &= all(same(o, r) for o, r in zip(outs, refs))
        err = max([err] + [abs_err(o, r) for o, r in zip(outs, refs)])
    want = baseline["units"][f"{YOLO_MODEL}/train"]["flops"]
    loss = float(metrics["loss"])
    phase(f"23c {YOLO_MODEL} train step on the card ({size} px, batch "
          f"{AUDIT_BATCH}, bf16) under the recorder: {nodes} "
          f"deepvision.best_iou node, {launches} K2 launch; its output "
          f"against best_iou_reference on its inputs: max_abs_err={err:.3g} "
          f"bit_for_bit={exact}; FLOPs {rec.trace.flops} vs the fake-traced "
          f"{YOLO_MODEL}/train row {want}; {rec.trace.eqns} ops; loss "
          f"{loss:.4f}; {time.perf_counter() - t0:.1f}s with the build")
    if nodes != 1 or launches != 1 or len(rec.calls) != 1 or not exact \
            or rec.trace.flops != want or not np.isfinite(loss):
        raise AssertionError(f"23c: nodes {nodes}, launches {launches}, "
                             f"exact {exact}, FLOPs {rec.trace.flops}")
    return {"nodes": nodes, "launches": launches, "max_abs_err": err,
            "flops": rec.trace.flops}


def check_audit(run: dict, program) -> dict:
    """Phase 23: the audit's counts on the card (23b, 23c), then the
    background audit collected (23a)."""
    t0 = time.perf_counter()
    baseline = p23_baseline()
    out = {"23b": check_p23_program(*program, baseline),
           "23c": check_p23_yolo_step(baseline),
           "23a": check_p23_audit(run, baseline)}
    phase(f"23: phase 23 took {time.perf_counter() - t0:.1f}s")
    return out


def keep_bytecode() -> None:
    """Keep the bytecode Python compiles, for this process and every one
    it starts, under the checkout's .cache/: where the interpreter's
    packages hold none and PYTHONDONTWRITEBYTECODE is set, each process
    the script starts (DDP ranks, entry points, evaluate workers, tier
    replicas) compiles torch's sources anew, 7.5 s of the 20 s a
    YOLO/torch/train.py start took on the H100 machine's host."""
    prefix = os.path.join(HERE, ".cache", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    keep_bytecode()
    t_start = time.perf_counter()

    def ended(what: str) -> None:
        beside = "".join(f" (beside {b})" for b in sorted(BESIDE))
        print(f"[chip_smoke] timing: {what} ended at "
              f"{time.perf_counter() - t_start:.1f}s{beside}", flush=True)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # 23a's audit: fake traces on the CPU, beside every phase of the card
    p23_audit = start_p23_audit()
    phase(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel and the decoder's library, in parallel
    t0 = time.perf_counter()
    libraries = ["flash_attention", "best_iou", "jpeg_decode"]
    _build.build(libraries)
    phase(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for name, info in _build.BUILD_INFO.items():
        phase(f"{name}: nvcc {info['seconds']:.1f}s")
    k2_sass = report_build(libraries)

    # 3. kernel against its plain version on the card
    gen = torch.Generator().manual_seed(0)
    cfg = get_config(MODEL)
    heads = cfg.model_kwargs["num_heads"]
    d = cfg.model_kwargs["embed_dim"] // heads
    n = (cfg.data.image_size // cfg.model_kwargs["patch_size"]) ** 2 + 1
    main_path = [check_attention((b, heads, n, d), torch.bfloat16, gen, True,
                                 layout)
                 for b in BUCKETS for layout in ("contiguous", "strided")]
    ragged = [check_attention((2, heads, nr, d), dt, gen, False)
              for nr in (1, 5, 17, 65, 300)
              for dt in (torch.float32, torch.bfloat16)]
    ragged += [check_attention((2, 3, 77, dr), torch.bfloat16, gen, False)
               for dr in (8, 40, 128)]
    ragged += [check_attention((2, 3, 33, 64), torch.bfloat16, gen, False,
                               "offset_1"),
               check_attention((2, 3, 33, 12), torch.bfloat16, gen, False)]
    max_err = max(r["max_abs_err"] for r in main_path + ragged)
    # best_iou at the three yolov3 scales (416 px, batch 16, MAX_BOXES GT):
    # fused in one launch as the loss calls it, then each scale alone (the
    # earlier per-scale rows); ragged segment sets (one box; 3 GT; one GT;
    # more GT than one shared-memory chunk; NaN, +-inf and inverted boxes;
    # batch 1)
    ns = [3 * g * g for g in yolo_grid_sizes(416)]
    preds = [random_boxes(YOLO_BATCH, n, gen) for n in ns]
    gt = padded_gt(YOLO_BATCH, yolo_ops.MAX_BOXES, gen)
    iou_fused = check_best_iou(preds, gt, True)
    iou_scales = [check_best_iou(p, gt, True) for p in preds]
    iou_ragged = [check_best_iou([random_boxes(b, n, gen) for n in segs],
                                 padded_gt(b, m, gen), False)
                  for b, segs, m in (
                      (16, (1, 130, 507), 100), (16, (1, 130, 507), 3),
                      (2, (507, 1, 130), 1), (2, (130, 1, 507), 300),
                      (1, (8112, 2028, 507), 100))]
    iou_ragged.append(check_best_iou(ragged_preds(gen), ragged_gt(gen),
                                     False))
    iou_err = max(r["max_abs_err"]
                  for r in [iou_fused] + iou_scales + iou_ragged)

    # 4. the slice through the port's own server
    depth = cfg.model_kwargs["depth"]
    args = build_parser().parse_args(
        ["-m", MODEL, "--device", "cuda",
         "--buckets", ",".join(map(str, BUCKETS)), "--flush-every", "60"])
    server = build_server(args)          # engines built and warmed up
    engine = server.engine
    flash_attention.launches = 0         # counts of the main path only
    engine.dispatches = 0
    snap = _smoke(server, duration=4.0, n_threads=8)
    server.close()
    http = InferenceServer(engine=engine, max_delay_ms=5.0,
                           default_deadline_s=60.0, flush_every_s=60.0)
    t = threading.Thread(target=lambda: http.serve(port=0), daemon=True)
    t.start()
    if not http.ready.wait(60):
        raise RuntimeError("HTTP server did not start")
    base = f"http://127.0.0.1:{http.bound_port}"
    rs = np.random.RandomState(1)
    sent, answers = [], []
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"/healthz device {health['device']!r}")
        for n_inst in (1, 2, 3, 4, 1):
            x = rs.randn(n_inst, *engine.example_shape).astype(np.float32)
            sent.append(x)
            answers.append(post(f"{base}/predict", x))
    finally:
        http.stop()
        t.join(timeout=60)
        http.close()
    launches, dispatches = flash_attention.launches, engine.dispatches
    phase(f"main path: {dispatches} dispatches, {launches} flash_attention "
          f"launches (depth {depth})")
    if dispatches == 0 or launches != depth * dispatches:
        raise AssertionError(f"flash_attention ran {launches} times for "
                             f"{dispatches} dispatches of depth {depth}")

    served_err = 0.0
    for x, y in zip(sent, answers):
        ref = engine.reference(x)
        if y.shape != (x.shape[0], cfg.data.num_classes) \
                or not np.isfinite(y).all():
            raise AssertionError(f"bad answer shape/values {y.shape}")
        served_err = max(served_err, float(np.abs(y - ref).max()))
    phase(f"HTTP answers vs engine.reference(): max_abs_err={served_err:.3g}")
    if served_err > SERVE_TOL:
        raise AssertionError(f"served answers differ by {served_err:g}")

    cpu_model = build_model(cfg).eval().cast_compute_weights_()
    x = rs.randn(2, *engine.example_shape).astype(np.float32)
    with torch.inference_mode():
        cpu_logits = cpu_model(torch.from_numpy(x)).numpy()
    cpu_err = float(np.abs(engine.reference(x) - cpu_logits).max())
    scale = max(1.0, float(np.abs(cpu_logits).max()))
    phase(f"card vs CPU plain path on 2 images: max_abs_err={cpu_err:.3g} "
          f"(logit scale {scale:.3g})")
    if not np.isfinite(cpu_logits).all() or cpu_err > CPU_RTOL * scale:
        raise AssertionError(f"card and CPU differ by {cpu_err:g}")

    for b in engine.buckets:
        phase(f"measure_batch_ms bucket {b}: {engine.measure_batch_ms(b, 20):.3f}")
    phase(f"smoke: {snap['requests']:.0f} requests, "
          f"p50_ms={snap.get('p50_ms', float('nan')):.3f} "
          f"p99_ms={snap.get('p99_ms', float('nan')):.3f} "
          f"images_per_sec={snap['images_per_sec']:.1f}; HTTP: {len(sent)} "
          f"requests")
    prof = profile_dispatches(engine, BUCKETS[-1])
    fam = prof["family_ms"]
    phase(f"profile, bucket {BUCKETS[-1]}, device ms per dispatch: "
          + " ".join(f"{k}={v:.4f}" for k, v in fam.items())
          + f"; busy {prof['busy_ms']:.4f} of wall {prof['wall_ms']:.4f} "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy); "
          f"flash_attention {100 * fam['flash_attention'] / prof['busy_ms']:.2f}"
          f"% of device time")
    for name, ms in prof["top"]:
        phase(f"profile top kernel: {ms:.4f} ms/dispatch {name}")

    ended("phases 1-4")
    # 5. slice 2: yolov3 training
    yolo = check_yolo_slice()
    k2_ms = iou_fused["device_ms"]
    phase(f"where a yolov3 train step goes: best_iou {k2_ms:.5f} ms of "
          f"{yolo['step_ms']:.3f} ms ({100 * k2_ms / yolo['step_ms']:.4f}%, "
          f"one fused launch, its device time from phase 3)")

    # 6. slice 5: vit_small training, K1 under autograd; its run is
    # exported in the background from here on, for phase 21
    vit = check_vit_training()
    p21_export = start_p21_export(vit["workdir"])
    grad_err = {str(dt).split(".")[-1]: check_attention_grad(
        VIT_GRAD_SHAPE, dt, gen) for dt in (torch.float32, torch.bfloat16)}
    train_k1 = check_attention((VIT_BATCH, heads, n, d), torch.bfloat16, gen,
                               True, "strided")
    phase(f"where a vit_small train step goes: K1 forward {depth} x "
          f"{train_k1['device_ms']:.4f} ms of {vit['step_ms']:.3f} ms "
          f"({100 * depth * train_k1['device_ms'] / vit['step_ms']:.2f}%, "
          f"its device time at the training shape)")

    ended("phases 5-6")
    # 7-8. slice 6: lenet5 and resnet50_tpu training (no kernel on these
    # paths: every launch count below stays as phases 4-6 left it)
    check_lenet_training()
    resnet = check_resnet_training(gen)

    # 9-10. slice 7: the classification zoo trained and served (no kernel
    # on these paths: the launch counts, zeroed here, must stay 0)
    flash_attention.launches = best_iou.launches = 0
    check_zoo_training()
    check_zoo_serving()
    zoo_launches = (flash_attention.launches, best_iou.launches)
    phase(f"launches on the zoo's paths (flash_attention, best_iou): "
          f"{zoo_launches}")
    if zoo_launches != (0, 0):
        raise AssertionError(f"a kernel ran on the zoo's paths: "
                             f"{zoo_launches}")

    ended("phases 7-10")
    # 11. slice 8: data parallelism (the launch counts are each rank's,
    # zeroed in the rank before each entry point)
    torch.cuda.empty_cache()        # the workers share the card
    ddp = check_data_parallel(smi, yolo, resnet)

    ended("phase 11a (11b's ranks run on beside phases 12-13)")
    # 12. slice 9: yolov3 inference on phase 5's checkpoint (no kernel on
    # this path: the launch counts, zeroed there, must stay 0)
    torch.cuda.empty_cache()
    check_detection_inference(yolo)

    ended("phase 12")
    # 13. slice 10: CenterNet and stacked-Hourglass pose (no kernel on
    # these paths: the launch counts, zeroed there, must stay 0)
    torch.cuda.empty_cache()
    check_centernet_and_pose()
    ended("phase 13")
    collect_data_parallel(ddp, smi)

    ended("phase 11b, collected")
    # 14. slice 11: U-Net segmentation, checkpoint restore into the
    # engine, DCGAN and CycleGAN (no kernel on these paths: the launch
    # counts, zeroed at each sub-phase, must stay 0)
    torch.cuda.empty_cache()
    seg_gan = check_segmentation_and_gans(yolo)
    # phase 14d's cyclegan run converted in the background, for phase 21
    p21_convert = start_p21_convert(seg_gan["14d"]["workdir"])

    ended("phase 14")
    # 15. slice 12: resilient training (K2 on its main path, 15a: the
    # counts, zeroed there, read just after run_detection)
    torch.cuda.empty_cache()
    resil = check_resilience()

    ended("phase 15")
    # 16. slice 13: running the server (K1 on its main path, 16a: the
    # counts, zeroed just before its traffic, read just after)
    torch.cuda.empty_cache()
    ops = check_serve_ops()

    ended("phase 16")
    # 17. slice 14: the replica tier over phase 16's run (K1 in every
    # replica, its launches read from each replica's /healthz) and the
    # flywheel in-process (K1 on its main path, 17b: the counts zeroed
    # just before its traffic, read just after)
    torch.cuda.empty_cache()
    fleet_ops = check_tier_and_flywheel(
        ops["stash"], ops["16d"]["latency_ms"][False])
    tier, fly = fleet_ops["17a"], fleet_ops["17b"]

    ended("phase 17")
    # 18. slice 15: real datasets from records, decoded on the card (K1 on
    # 18c's path, K2 on 18d's: each count zeroed just before its entry
    # point, read just after)
    torch.cuda.empty_cache()
    real = check_real_datasets(yolo["workdir"])

    ended("phase 18")
    # 19. slice 17: the training step's levers (K1 in 19a, 19b and 19e,
    # K2 in 19c: each count zeroed just before its run, read just after)
    torch.cuda.empty_cache()
    levers = check_levers()
    ended("phase 19")
    # 20. slice 18: int8 serving (K1 in 20a at int8: the count zeroed just
    # before its main path, read just after)
    torch.cuda.empty_cache()
    int8 = check_int8_serving(ops["stash"])
    ended("phase 20")
    # 21. slice 19: model export and the checkpoint importer (K1 in 21a's
    # program and package: the count zeroed just before each call, read
    # just after; K1 and K2 idle in 21b-d)
    torch.cuda.empty_cache()
    export = check_export(p21_export, p21_convert, vit["workdir"],
                          seg_gan["14d"]["workdir"],
                          real["18e"]["pose_workdir"])
    ended("phase 21")
    # 22. slice 20: the Keras, call-order and GAN checkpoint importers (K2
    # in 22a's resumed run: the count zeroed just before it, read just
    # after; K1 and K2 idle in 22b-c)
    torch.cuda.empty_cache()
    imports = check_importers()
    ended("phase 22")
    # 23. slice 21: the IR audit (K1 in 23b's program call, K2 in 23c's
    # train step: each count zeroed just before, read just after)
    torch.cuda.empty_cache()
    audit = check_audit(p23_audit, export["21a"]["program"])
    ended("phase 23")

    # the card again, next to the numbers: a tail of the output keeps it
    print(smi, flush=True)
    timed_keys = ("shape", "layout", "ms", "device_ms", "plain_ms",
                  "library_ms", "library_device_ms", "bound_ms")
    b32 = main_path[-1]                  # bucket 32, the model's layout
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "deepvision_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepvision_tpu/ops/attention.py:73",
        "launches": launches,
        "max_abs_err": max(max_err, train_k1["max_abs_err"]),
        "ms": b32["ms"], "device_ms": b32["device_ms"],
        "plain_ms": b32["plain_ms"], "bound_ms": b32["bound_ms"],
        "bound_by": b32["bound_by"], "library_ms": b32["library_ms"],
        "library_device_ms": b32["library_device_ms"],
        "shape": b32["shape"], "layout": b32["layout"], "dtype": b32["dtype"],
        "dispatch_profile": prof,
        "shapes": [{k: r[k] for k in timed_keys}
                   for r in main_path + [train_k1]],
        "train_launches": vit["launches"],
        "serve_ops_launches": ops["16a"]["launches"],
        "serve_ops_dispatches": ops["16a"]["dispatches"],
        "serve_ops_dispatches_by_generation": ops["16a"]["by_generation"],
        "tier": {"launches_dispatches_per_replica": tier["kernel"],
                 "answers": tier["answers"]},
        "flywheel": {"launches": fly["launches"],
                     "dispatches": fly["dispatches"],
                     "dispatches_by_generation": fly["by_generation"],
                     "finetune_steps": fly["finetune_steps"]},
        "train_shape": {k: train_k1[k] for k in timed_keys},
        "records_launches": real["18c"],
        "levers_launches": {
            "remat": levers["19a"]["launches"],
            "remat_steps": levers["19a"]["steps"],
            "cutmix_k2": {k: levers["19b"][k] for k in (
                "launches", "steps", "eval_batches", "dispatches")},
            "classify": levers["19e"]["launches"]},
        "int8_launches": {
            "launches": int8["20a"]["counts"]["flash_attention"],
            "dispatches": int8["20a"]["counts"]["dispatches"]["int8"]},
        "export_launches": {
            "program": export["21a"]["launches"]["program"],
            "package": export["21a"]["launches"]["package"],
            "calls": 1, "depth": export["21a"]["depth"],
            "ms": export["21a"]["ms"]},
        "audit": {k: audit["23b"][k] for k in ("nodes", "launches",
                                               "flops")},
        "backward": "the VJP of naive_attention (autograd), as the JAX "
                    "package's _fused_bwd: no backward kernel",
        "grad_max_abs_err": grad_err}, {
        "name": "best_iou", "route": "cuda",
        "source": "deepvision_tpu_torch/csrc/best_iou.cu",
        "replaces": "deepvision_tpu/ops/pallas_kernels.py:33",
        "launches": yolo["launches"], "max_abs_err": iou_err,
        "ddp_launches": {"world 1, NCCL": ddp["11a"]["yolo_launches"],
                         "world 2, gloo, per rank": ddp["11b"][
                             "yolo_launches"]},
        "ms": iou_fused["ms"], "device_ms": iou_fused["device_ms"],
        "plain_ms": iou_fused["plain_ms"], "bound_ms": iou_fused["bound_ms"],
        "bound_by": iou_fused["bound_by"], "library_ms": None,
        "library_device_ms": None, "shape": iou_fused["shape"],
        "segments": iou_fused["segments"], "dtype": "float32",
        "sass": k2_sass,
        "records_launches": {k: real["18d"][k] for k in (
            "launches", "train_steps", "eval_batches",
            "eval_only_launches")},
        "epoch_on_device_launches": {k: levers["19c"][k] for k in (
            "launches", "train_steps", "eval_batches", "overflow_launches")},
        "export_launches": {"cyclegan_package": export["21b"]["counts"][1]},
        "keras_import_launches": {k: imports["22a"][k] for k in (
            "launches", "train_steps", "eval_batches")},
        "audit": {k: audit["23c"][k] for k in ("nodes", "launches",
                                               "flops")},
        "resilience_launches": {
            "launches": resil["15a"]["launches"],
            "train_steps": resil["15a"]["train_steps"],
            "eval_batches": resil["15a"]["eval_batches"]},
        "scales": [{k: r[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                      "bound_ms")}
                   for r in iou_scales]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(ddp_worker(sys.argv[2]) if sys.argv[1:2] == ["--ddp-worker"]
             else main())

#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (incubator_mxnet_tpu_torch) end to end on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass, in order:

1. Build every CUDA kernel of the serving, training and conv-backward paths
   from the checkout's sources (flash_fwd.cu: K1; flash_bwd.cu: K2 and K3;
   conv_bwd.cu: K4), one nvcc per source, all started together; print
   ptxas's registers and spills per kernel instantiation of all three, and
   fail if a tensor-core (``_tc``) instantiation of K1, K2, K3 or K4 spills
   or is missing from the report.
2. Hold K1 against its plain PyTorch version on the card (``hold_fwd``), at
   the shapes the serving path gives it and at ragged/odd ones: fp32 S 1000
   D 64 causal (the FMA kernel), fp16 S 300 D 128, bf16 S 130 D 64 causal,
   bf16 S 7 D 128 causal, and bf16 S 128 D 64 causal with a fully masked
   row (its out must be 0 and its lse -inf). At the served shapes time the
   kernel (TFLOP/s on 4·BH·pairs·D and the share of its bound), the plain
   version and the PyTorch library call that computes the same function (a
   yardstick only; the port never calls it). ``hold_fwd``: lse within atol
   2e-4 / rtol 1e-5 and fp32 out within atol 1e-4 / rtol 1e-5 (summation
   order); bf16/fp16 out elementwise within one rounding of the type (2^-7
   bf16, 2^-10 fp16) of the output plus the same of each term p_ij|v_j|/l_i
   (the tensor-core kernel rounds p to the type against its running max,
   which no dense plain version mirrors), plus 1e-4, and within 1e-2 (bf16)
   / 2e-3 (fp16) relative Frobenius error of the plain version (fp32 p, the
   JAX function's arithmetic).
3. Hold K2 (dK, dV) and K3 (dQ) against their plain version
   (_fa_bwd_reference, which rounds p and ds to the input type where the
   tensor-core kernels do), and the K1 out and lse that feed them against
   K1's plain version (``hold_fwd``), on the card on the same inputs: fp32 S 1000 D 64
   causal (the FMA kernels), fp16 S 300 D 128 with a nonzero LSE
   cotangent, bf16 S 130 D 64 causal, bf16 S 7 D 128 causal, bf16 S 512
   D 64, bf16 S 128 D 64 causal with a fully masked row (its dQ must be
   zero), and the two training shapes, bf16 B 64 H 8 S 512 D 128 and
   B 1 H 8 S 8192 D 128 causal. Tolerances: in fp32 every gradient within
   1e-4 x max|plain|; in bf16/fp16 within one rounding of the type (2^-7
   bf16, 2^-10 fp16, relative) of the gradient and of each term whose p or
   ds is rounded (``hold_bwd``) plus 1e-3 x max|plain|, and within 1e-2
   (bf16) or 2e-3 (fp16) relative Frobenius error of the fp32-p recompute
   (the JAX function's arithmetic); every gradient finite. At the training
   shapes, time K1, K2, K3 (each with TFLOP/s on its own flop count and
   the share of its bound), the plain forward and backward, and the
   forward and backward of scaled_dot_product_attention (the yardsticks
   for K1 and for the pair).
4. Hold a small BERT and GPT in float32 on the card (kernel route) against
   the same weights on the CPU (plain route): a forward, then three Adam
   TrainSteps (BERT with SoftmaxCrossEntropyLoss, FeaturesView(GPT) with
   ChunkedLMLoss); per-step losses and the parameters after three steps
   within 1e-3 (atol and rtol), the two devices' float32 summation orders.
5. The serving path: full-width BERT (bench.py bench_transformer config) and
   GPT (bench.py bench_long_context config) in bfloat16 behind one
   ModelRegistry on cuda:0, random weights from a seeded generator; 16 BERT
   requests of 512 tokens from 4 client threads (bucket 8) and one GPT
   request of 8192 tokens. Every reply must have the right shape and be
   finite, served BERT rows must match a direct EvalStep forward, K1's
   launch count over this phase must equal layers x batches (a bucket's
   first dispatch captures its EvalStep graph, answered by the eager run,
   and later ones replay it: 12 launches a batch either way),
   and K2/K3 must not launch. Then one BERT request with out-of-range token ids
   (vocab_size, -vocab_size - 1) between two submissions of one batch of
   8: its reply must be NaN throughout, as the reference's, the batch's
   replies after it must equal those before it bit for bit, and the card
   must still synchronise. The 16 BERT requests and the GPT request run
   under the profiler (``profiler.set_state('run')``): each dispatched
   batch must leave exactly one ``serve:<model>:batch<bucket>`` event
   whose ``batch_size`` arguments add up to the requests served. The
   stage breakdown times BlockServable's host copy (bf16 into pinned host
   memory, widened on the host) against the old conversion (widened on
   the card, a pageable copy) on the same logits, and holds them equal
   bit for bit.
6. The NDArray layer (``check_ndarray``), after the serving models are
   freed. (a) The port's op sweep (``test_utils.op_consistency_sweep`` and
   ``grad_consistency_sweep``, 195 entries of the JAX package's sweep
   table) with the CPU and the card as its two legs: forward in fp32,
   bf16 and fp16 at the table's SWEEP_TOLS, gradients of sum(op) in fp32;
   any mismatch or error fails. (b) Imperative autograd on the card
   against the same code on the CPU within 1e-5: "write" and "add"
   variables through two backwards ("write" must equal the last
   backward's gradient, "add" the sum), ``autograd.grad`` (which must
   leave ``.grad`` alone), a custom ``autograd.Function``, writes into
   a parameter's ``data()`` outside and inside ``record()``, and an array
   taken from a parameter, which ``Trainer.step`` must leave as it was;
   the indexing operators (``take`` in each
   mode, ``pick``, ``one_hot``, ``gather_nd``, ``scatter_nd``,
   ``batch_take``, ``Embedding``) on ids out of range equal to the CPU's,
   NaN in the same places, with the card still synchronising after them.
   (c) Full-width BERT (the training config
   below) through MXNet's Gluon loop on NDArrays — ``with record(): loss
   = loss_fn(net(x), y)``, ``loss.backward()``, ``trainer.step(64)`` —
   against five TrainSteps from the same weights (saved to a .params
   file before and loaded back) and batch: the losses must agree bit for
   bit or within 1e-3 relative, every weight be finite, and K1, K2, K3
   each launch layers x steps times in the loop; both step times are
   printed, from the same run. (d) The trained model saved twice with
   ``save_parameters`` (the same bytes both times) and loaded into a
   fresh model on the card: a served batch's forward equal bit for bit.
   (e) ``nd.random``: ``seed`` repeats the draws on the card, and the
   moments of 16 M normal and uniform draws lie within 5 standard errors.
   (f) The rest of mx.nd (``check_ndarray_breadth``): every nd.linalg
   operator card vs CPU in float32 and float64 (TF32 off; the
   factorisations gelqf, svd and syevd through their sign-free
   invariants) with the gradients of the differentiable ones, within
   BREADTH_TOL; nd.sparse cast_storage round trips (exact) and
   sparse.dot card vs CPU; deformable_conv2d (DCNv2 mask, two groups)
   card vs CPU with its four gradients; an LSTM cell unrolled by
   contrib.foreach and a contrib.while_loop(max_iterations=6) inside the
   captured TrainStep equal to its eager body bit for bit over 3 steps.
   The sweep of (a) holds the new entries too (the loss layers, the
   nn-style, index and update operators, linalg.gemm2, the _v1 aliases,
   cast_storage). Prints an {"ndarray": ...} line with these numbers and
   the card.
7. The training path, after the NDArray phase's model is freed:
   full-width BERT (B 64 x S 512, SoftmaxCrossEntropyLoss on the full
   logits) and GPT (B 1 x S 8192, FeaturesView + ChunkedLMLoss) in
   bfloat16, each through gluon.Trainer("adam", lr 1e-4, multi_precision)
   and jit.TrainStep, which captures its step into a CUDA graph at the
   first call and replays it after, on a fixed batch: BERT 2 warm-up + 8
   timed steps, GPT 2 + 4, then 3 replays under torch.profiler (the
   device's idle share) and 3 issued on an idle card (the host's own cost
   of a step, with F7's telemetry around it: every captured call adds one
   to mxtpu_train_steps_total and to the step histogram's count). Every
   loss finite, the last step's mean loss below the
   first's, every parameter finite, every bf16 weight equal to its fp32
   master cast to bf16, and over the timed steps K1, K2 and K3 each
   launched layers x steps times (counted at each replay). Then, in the
   same process from the same weights, TrainStep's eager body (uncaptured)
   for 5 steps, the second phase by phase (``step_phases``), the last 3
   timed, then profiled and issued the same way: the fifth step's mean
   loss of the two runs within 1e-3 relative (the measured value is
   printed). Each run reports step ms (CUDA events), host ms (host clock,
   no synchronisation inside), idle share and peak memory. Last, GPT
   through TrainStep(remat=True): its second step's mean loss within 1e-3
   relative of TrainStep's without remat from the same weights, step ms
   and peak memory, K1 launched twice a layer and step (the recomputed
   forward), K2 and K3 once. The captured step's graph is an aot.CACHE
   entry of kind "train" (``train_entry``): over each captured run
   mxtpu_aot_misses_total{kind="train"} grows by 1 and the hits by the
   calls - 1, the entry's FLOPs (FlopCounterMode over the eager first
   step; K1-K3 by their operators' formulas) stand beside bench.py:358's
   formula as a ratio, and mxtpu_device_mfu{kind="train"} is finite and
   > 0; BERT then replays TRAIN_SYNC_STEPS more times under
   MXTPU_DEVSTATS_TRAIN_SYNC, and the device time the gauge's counters
   read must be within 10 % of the CUDA events around those replays
   (the gauge's MFU printed beside the window's and the share of 989
   TFLOP/s). Dropped and collected, each step leaves none of its entries
   in aot.CACHE and memory_reserved is back within 5 % of its level
   before the step was built (both read with cuBLAS's per-stream
   workspaces given back, as torch's own leak check reads them). Last,
   the knobs the package applies at import, in a fresh process
   (``knob_children``): MXTPU_SEED's uniform
   on gpu(0) repeats after mx.random.seed of the same value, the
   autostarted profiler's file (MXTPU_PROFILER_AUTOSTART,
   MXTPU_PROFILER_FILENAME) exists after exit and is not empty, and under
   MXTPU_MATMUL_PRECISION=highest an fp32 4096² matmul on the card is
   within 1e-5 relative Frobenius of the CPU's; the same matmul under
   the knob's 'high' (TF32) is timed beside it.
8. K4 (ops.conv_bwd) against its plain version (_conv_bwd_reference, dense
   fp32 matrix products, no conv call) at the four ResNet-50 bottleneck
   3x3 shapes in bf16 at batch 256 and at three odd shapes (C and K of 8,
   16, 24, 40, 72 against 64-wide tiles) in bf16 and fp16 (the tensor-core
   kernels; within one rounding of the type, 2^-7 bf16 / 2^-10 fp16
   relative, plus 1e-3 x max|plain|), and at two odd fp32 shapes (the FMA
   kernels; within 1e-4 x max|plain|, summation order); at the stage shapes
   dx and dw must be identical across two launches (no atomics), and K4,
   the plain version and cuDNN's dgrad + wgrad pair (the gradient of
   F.conv2d on channels-last bf16, the yardstick) are timed, K4 and cuDNN
   over 30 launches after a warm-up, and K4's launch is split into its CUDA
   kernels with torch.profiler; then the entry point: two conv3x3_s1
   backwards under autograd.record launch K4 exactly twice and agree with
   plain.
9. Small float32 LeNet and ResNet-18 on the card (cuDNN, TF32 off) against
   the same weights on the CPU: three SGD-momentum TrainSteps. LeNet: each
   step's losses within 1e-3 of the largest, every parameter after every
   step within 1e-4 of its largest value. ResNet-18: the first two steps'
   losses within 1e-3, every parameter's change after the first step
   within 1e-3 of its largest change; the third step's losses within 5e-2
   and all changes after it within 5e-2 together (L2), because a 1e-6
   weight difference after a step flips the ReLU mask of the activations
   that close to 0 and reroutes their gradients in the next.
10. TrainStep's CUDA graphs against its eager body, small float32 BERT,
   GPT (K1-K3) and ResNet-18 (cuDNN with deterministic algorithms, whose
   default backward algorithms differ run to run) from the same weights,
   4 steps each: losses and parameters, running statistics included,
   equal bit for bit, with a set_data (in place: the graph stays), a
   set_learning_rate and, in the captured run, replaced optimizer states
   (a second capture) between steps; K1-K3 launched layers x steps times
   through the replays. A small BERT with dropout 0.1 at learning rate 0:
   every replay's losses differ (fresh masks) and are finite. A step
   whose loss reads a value back to the host fails its capture with an
   error naming the loss; after it the default stream is current again,
   the allocator gives a freed 1 GiB block back to the card, and a sound
   step captures.
11. The vision training path: full-width ResNet-50 v1 (bench.py:248-279,
   uncut) at B 256 x 3 x 224 x 224 bf16 with SGD (lr 0.1, momentum 0.9,
   fp32 masters) through the captured jit.TrainStep, 3 warm-up + 10
   timed steps: every loss finite and the last below the first, every
   parameter and running statistic finite, every bf16 weight equal to
   its master cast, and no hand-written kernel launched (model-zoo convs
   stay on cuDNN, as the JAX package leaves them to XLA); then the eager
   body from the same weights as in phase 7, the running statistics after
   5 steps within 1e-3 of their largest value as well.
12. The Gluon training loop (``gluon_loop``). (a) Every registered
   optimizer (RMSProp in both forms) on a small fp32 MLP, 3 steps from
   the same weights: the captured TrainStep and the eager loop (record,
   backward, Trainer.step) on the card each within 1e-6 of the largest
   weight of the same loop on the CPU (SGLD with its noise off); SGLD
   captured with a zero gradient draws fresh N(0, lr) noise each replay.
   Each *_update operator whose formula is an optimizer's against that
   optimizer's update_all on the card, 3 steps (fp16 weights with fp32
   masters for mp_*): bit for bit; multi_mp_sgd_mom_update,
   preloaded_multi_mp_sgd_mom_update (device learning rates) and a LARS
   chain (multi_sum_sq, multi_lars, multi_all_finite, multi_sgd_update)
   captured in a CUDA graph, 3 replays equal to 3 eager calls bit for bit.
   (b) A hybridized small fp32 BERT, GPT and ResNet-18 (cuDNN
   deterministic) in the Gluon loop against the same loop without
   hybridize: losses and parameters equal bit for bit over 6 steps (a
   signature runs eagerly at its first call and is captured at its
   second) with a set_data (a new capture) and a second batch size (a
   second signature) between; 3 captures each; K1-K3 counted layers x
   steps through the replays. (c) Full-width BERT B 64 x S 512 bf16 as LAMB
   pre-training runs it: ArrayDataset -> DataLoader(2 threads,
   pin_memory) -> hybridized model under record() ->
   SoftmaxCrossEntropyLoss -> backward -> clip_global_norm(1.0) ->
   Trainer("lamb", wd 0.01, fp32 masters, PolyScheduler with warm-up) ->
   Speedometer, 8 steps: losses finite and falling, K1-K3 layers x steps,
   one capture; Perplexity and Accuracy on the card within 1e-6 relative
   of a host computation of the same batch; save_parameters and
   save_states after step 4, load_parameters (a new capture) and a fresh
   Trainer's load_states, and the last 4 steps' losses equal the
   uninterrupted run's bit for bit; the loop with the clip off against
   TrainStep with the same optimizer and scheduler, 3 steps, losses bit
   for bit or within 1e-3; the LAMB and Adam updates of this model,
   device ms and device activities. (d) Full-width GPT S 8192 through the
   same loop (FeaturesView, ChunkedLMLoss, Adam), hybridized and not from
   the same weights: 2 + 4 steps, step ms, host ms, issue ms, idle share
   under torch.profiler, peak memory; the fifth loss within 1e-3
   relative; K1-K3 layers x steps over the hybridized timed steps.
   (e) ResNet-50 v1 B 256 bf16 fed by an ArrayDataset of seeded uint8
   224 x 224 x 3 images through transform_first(Compose([
   RandomFlipLeftRight(), ToTensor(), Normalize])) and a DataLoader with
   4 thread workers and pin_memory into TrainStep with "nag" under a
   CosineScheduler with warm-up: the loader's img/s alone, the loop's
   img/s and the same step fed from the card; every loss finite;
   Accuracy and TopKAccuracy(5) on the card equal to the host's. Every
   hybridized block of (b)-(d) captured fewer graphs than
   MXTPU_EXEC_CACHE_SIZE, the bound of its cache (16 by default). Prints
   a {"gluon_loop": ...} line.
13. BASELINE config 5, the LSTM language model (``lstm_lm``). (a) At a
   small width (vocab 200, 32 / 32, 2 layers; TF32 off, cuDNN
   deterministic): dropout off, the card (cuDNN's RNN) against the CPU from
   the same weights, the first forward's logits, states and gradients and
   the weights after 3 steps of the word-LM Gluon loop within 1e-4 of
   their largest value; dropout 0.5 from one seed, the hybridized model
   against the plain one over 4 steps, losses and weights bit for bit, one
   capture; two replays on one batch give different logits (fresh masks).
   (b) Full width (vocab 10000, embed and hidden 650, 2 layers, dropout
   0.5, fp32; Zaremba et al.'s medium PTB model) on a seeded token stream
   with learnable structure (successor tables over the first 1000 ids)
   cut into (35, 20) batches, through the Gluon
   loop a word-LM trainer writes (begin_state; states detached each batch;
   record → model → SoftmaxCrossEntropyLoss → backward →
   clip_global_norm(5 · 20) → Trainer("sgd", lr 1).step(20)), hybridized
   and plain from the same weights and seed, 2 + 18 steps: losses finite
   and falling, the two runs within 1e-3; step ms, tokens/s, host ms, issue
   ms, idle share, peak memory. (c) The same model through jit.TrainStep
   (n_net_inputs 3: tokens, h0, c0; the clip on the card), captured and
   its eager body (phase by phase) from the same weights and seed, on each
   route of the recurrence (cuDNN's fused RNN and the step loop): losses
   within 1e-3. (d) A captured TrainStep right after a recorded forward
   whose states the caller holds undetached. Prints an {"rnn": ...} line.
14. The model zoo's new families (``model_zoo``): VGG-16, AlexNet,
   DenseNet-121, SqueezeNet 1.0, MobileNet 1.0, MobileNet v2 1.0 and
   Inception v3, each on the card against the CPU at a small input (fp32,
   TF32 off: logits within 1e-4), then at its published widths (B 32 x
   224², 299² for Inception v3, bf16 with fp32 masters): an eager forward
   (logits finite) and the captured TrainStep with SGD-momentum (a first
   step, a replay, 5 timed): losses finite, no hand-written kernel
   launched; img/s and peak memory (SqueezeNet 1.0 drawn Gaussian "in" at
   magnitude 2, so its loss can fall). Prints a {"model_zoo": ...} line.
15. BASELINE config 4, SSD-512 (``ssd_phase``). (a) Every operator of
   ops/multibox.py, ops/detection.py and the ported nd.contrib on the card
   against the CPU (fp32, TF32 off): index outputs equal, values and the
   gradients of roi_align, bilinear_sampler, spatial_transformer and
   RROIAlign within 1e-5 of the largest. (b) SSD at base 8 on 64² inputs,
   fp32, TF32 off, cuDNN deterministic: the eval forward and one Gluon-loop
   step card vs CPU within 1e-4. (c) SSD-512 at its defaults (20 classes,
   base 64, 512² inputs, 87,040 anchors; its forward FLOP an image counted
   from the convolutions as they run and held to 66.92 GFLOP) at batch 32
   in bf16 with fp32 masters, SGD-momentum 0.9, wd 5e-4, on the synthetic
   recipe's boxes (example/detection/train_ssd.py), labels padded to 4
   rows; the loss: MultiBoxTarget (hard negatives at 3) under
   autograd.pause(), softmax cross-entropy over the anchors whose target
   is at least 0 plus smooth-L1 under the box mask. The captured TrainStep
   against its eager body from the same weights, 3 steps, cuDNN
   deterministic: losses and parameters bit for bit. Then the captured
   TrainStep (a capture, a replay, 5 timed, then profiled and issued on an
   idle card): step ms, img/s, share of 989 TFLOP/s (3 x forward FLOP),
   issue ms, idle share, one capture, peak allocated and reserved; the
   hybridized Gluon loop (record, forward, MultiBoxTarget and the loss
   eagerly, backward, Trainer.step; 2 + 6 steps): losses finite and falling
   over the timed steps, step and issue ms, MultiBoxTarget's own ms; and
   detection (EvalStep's forward, softmax, MultiBoxDetection with nms_topk
   400 and threshold 0.45): at most 400 detections an image, forward and
   detection ms, img/s. No hand-written kernel launches on this path.
   Prints an {"ssd": ...} line.
16. The CTC acoustic model of example/speech_recognition/train_ctc.py
   (``ctc_phase``) at DeepSpeech-2 width (CTC: 161 bins, Dense(1760,
   relu) → 5 bidirectional LSTM layers of 1760 → Dense(29), blank last,
   CTCLoss, Adam 3e-3, fp32; B 32 × T 800, data lengths 400-800, label
   lengths 40-120 padded with -1; synthetic utterances from a seed, as
   train_ctc.py makes them). (a) At 2 layers, hidden 32, T 40 (TF32 off):
   the card against the CPU from the same weights, a Gluon-loop step's
   loss and gradients and the weights after two SGD steps within
   CTC_SMALL_TOL. (b) The loss alone at the model's logits shape (T 800 ×
   N 32 × C 29): ops.ctc against torch.nn.functional.ctc_loss (a
   yardstick, not on the path) on the same log-probabilities and card vs
   CPU, within CTC_LOSS_TOL; forward + backward timed eagerly and
   replayed from a CUDA graph, F.ctc_loss timed beside. (c) Full width:
   the captured TrainStep against its eager body, 3 steps, bit for bit;
   then the captured TrainStep (a capture, a replay, CTC_TIMED timed), its
   eager body and the hybridized Gluon loop, each with step ms, frames/s,
   share of 989 TFLOP/s (3 × the forward FLOP of the LSTM and Dense
   shapes), issue ms, idle share, peak allocated and reserved memory and
   top_kernels; losses finite and falling in each; no hand-written kernel
   launched. Prints a {"ctc": ...} line.
17. The symbolic API and Module.fit (``module_phase``), BASELINE config 2
   as MXNet's train_imagenet.py runs it. (a) A small symbolic ResNet v1 (2
   stages of one bottleneck unit, 16 and 32 wide, 32² inputs) through 3
   Module SGD steps on the card and on the CPU from the same Xavier draw,
   TF32 off: outputs, parameters and moving statistics within
   MODULE_SMALL_TOL. (b) A BucketingModule (Embedding → FullyConnected →
   SoftmaxOutput, bucket keys 12 and 20): 3 steps, one shared parameter
   set (the same tensors, gradients and optimizer states in every bucket),
   finite losses, card = CPU within MODULE_SMALL_TOL. (c) ImageRecordIter
   (tier 1: the C++ JPEG pipeline where g++ builds it): where PIL
   imports, one timed pass over 512 JPEGs it
   writes (batch 128, 224² random crops, mirror, mean/std, 8 threads);
   where it does not, a line says the pass did not run. (d) MXNet's
   ResNet-50 v1 symbol (symbols/resnet-v1.py: units 3/4/6/3, filters
   64/256/512/1024/2048, bottleneck) built with mx.sym, B 256 × 3 × 224²,
   1000 classes, fp32 with TF32 on, trained by Module.fit on the card
   (the default context) with fit.py's settings (SGD momentum 0.9, wd 1e-4,
   lr 0.1, Xavier gaussian/in/2, the local kvstore) over 3 seeded host
   batches (noise, labels uniform over the 1000 classes) for 2 epochs, with Speedometer and do_checkpoint: losses finite and falling
   over the repeated batches, a checkpoint each epoch; then timed Module
   steps on one batch: step ms, img/s, share of 989 TFLOP/s at 24.6
   GFLOP an image, forward/backward/update device ms (CUDA events), host
   ms, issue ms, idle share, bind s, peak allocated and reserved memory;
   no hand-written kernel launches. (e) The last checkpoint loaded by
   Module.load on the CPU and on the card (4 images, TF32 off): the same
   probabilities, and the same logits through a Module over the loaded
   graph's fc1 node, within MODULE_CKPT_TOL; SymbolBlock.imports of it equal
   to the card Module's predict within 1e-5. (f) The yardstick: the same
   network as the Gluon model zoo's resnet50_v1 through an eager fp32
   Trainer loop, step ms, issue ms and idle share. Prints a {"module":
   ...} line.
19. (Run after phase 17, before 18.) The rest of the legacy API
   (``bucketing_phase``), MXNet's example/rnn/bucketing/lstm_bucketing.py
   (v1.6) at its published defaults (BUCKETING). (a) mx.rnn cells through
   a BucketingModule on the card and on the CPU from the same Xavier
   draw, TF32 off: a 2-layer LSTMCell stack, a 2-layer FusedRNNCell
   (dropout 0) and a GRUCell, 3 SGD steps over the keys 9, 6, 9: losses
   and parameters within BUCKETING_SMALL_TOL, one shared parameter set.
   (b) Full width: 2 x LSTMCell(200), embed 200, vocabulary 10,000, batch
   32, buckets 10-60, fp32 with TF32 on, through BucketingModule.fit (the
   default context, gpu(0)) for one epoch over BUCKETING_SENTENCES
   seeded Zipf sentences from BucketSentenceIter (every bucket binds),
   with Speedometer (auto_reset False, as the script) and
   do_rnn_checkpoint: each window's perplexity finite, the last below the
   first, one shared parameter set, no hand-written kernel launched; bind
   s per bucket; the checkpoint through load_rnn_checkpoint into a CPU
   Module gives the card's probabilities for one batch (TF32 off) within
   BUCKETING_CKPT_TOL. Then each bucket's step timed (device ms by CUDA
   events, host ms, tokens/s), and at bucket 60 the issue ms, the idle
   share, the device activities a step (``kernels_in``) and the step with
   the profiler off and on (profile_imperative: every operator synced)
   in the same call, its op events a step, the aggregate table's top rows
   and a ``dump()`` that json reads; peak allocated and reserved memory.
   (c) A captured TrainStep over a hybridized ``hybrid_forward`` block
   while the profiler runs: one capture, no operator event from the
   capture or its replays, captured = eager bit for bit. Prints a
   {"bucketing": ...} line.
20. (Run after phase 19, before 18.) The serving front end and
   generation (``serving_http_phase``, ``--serving-http-only``). (a) The
   captured ``jit.EvalStep`` on full-width BERT (BERT, bf16, flash) at
   buckets 1, 2, 4, 8 and S 512: one capture a bucket (its ms), captured
   = eager bit for bit, flash_fwd launched 12 times a replay, no capture
   in steady state; a replay's device and host ms against the eager
   forward's at bucket 8. Then phase 5's 16 requests through the registry,
   captured and eager (``jit._uses_graphs`` forced off) in turns: p50s.
   (b) Version 2 of BERT (other weights) loaded with a warm_spec while 4
   clients keep submitting: no request fails, the registry's health stays
   healthy, every capture runs on the warm thread (flight-recorder
   ``compile_begin`` rows), v1 drains out; the warm's seconds. (c)
   ``ServingServer`` on 127.0.0.1 at an ephemeral port: 8 POSTs of one S
   64 item each (a reply is 64 x 32768 floats of JSON) from 4 threads,
   each within 2 % of the logit range of the registry's direct reply, the
   request id echoed; /metrics parses and carries mxtpu_requests_total,
   /debug/requests holds the 8 with their device legs, /debug/aot lists
   the S 64 graphs, an unknown model gives 404 and a malformed body 400;
   client p50 and max, the server's device ms and after-dispatch ms from
   the access log, one reply's json.dumps ms. (d) ``GenerativeEngine``
   over TinyLM (the JAX package's only generator, at its widths and its
   defaults GEN) at POST /generate: a greedy and a sampled (T 0.8, top-k
   20) round of 8 concurrent streams, one client hanging up mid-stream
   in the first: every other stream equals ``generate_sequential``'s
   tokens, the greedy ones equal a CPU engine's with the same weights,
   the hang-up frees its blocks, and nothing captures after ``warm()``;
   tokens/s, TTFT p50, inter-token p50/p99 (client clock), each decode
   bucket's graph replay ms and bucket 1's at its natural row count. (e)
   A 2-replica BERT under a ``Supervisor``: faultlab (armed over POST
   /debug/faults) kills one replica worker at batcher.dispatch; its
   request is retried once and answers 200, /healthz reads degraded,
   then healthy after the respawn. Prints a {"serving_http": ...} line;
   the kernels line's ``launches_by_path`` carries (c)'s K1 launches.
   Between phases the script drops the captured EvalStep graphs
   (``release_graphs``), so none sits in a later phase's memory peak.
21. (Run after phase 20.) Programs on disk and device telemetry
   (``programs_phase``, ``--programs-only``). (a) ``HybridBlock.export``
   of the serving BERT at B 8 x S 512: seconds, the ``.mxtpu``'s MB. (b)
   A fresh process loads it through ``SymbolBlock.imports`` and
   ``contrib.serving.load`` and answers 16 requests from 4 threads
   through ``ModelRegistry`` (bucket 8): every reply equal to this
   process's forward (PROGRAMS_TOL), K1 launched 12 times a replay,
   p50, load and capture s. (c) With ``MXTPU_AOT_CACHE_DIR`` set,
   ``EvalStep`` buckets 1 and 8 built here (export, write, capture; 1, 2,
   4 and 8 before PR 21, a depth cut for 25(f)'s time), then a
   second fresh process gets an artifact hit a bucket, runs the net's
   Python forward 0 times and replays bucket 8 bit for bit: load and
   capture s against build s. (d) ``serving.serve`` of an S 64 artifact
   over HTTP: 8 requests from 4 threads within 2 % of the logit range of
   the direct forward, every batch tapped, K1 launched exactly 12 times a
   batch of this path (the batcher's batch count); only then is a
   bf16-vs-fp32 shadow registered, so its own K1 launches stay out of the
   count. (e) ``/debug/profile`` under that HTTP traffic (12 s: a reply's
   JSON takes seconds; the trace must hold at least 2 batches) and under
   TinyLM generation traffic (8 streams, 2 s), each asked for once its
   traffic has made progress: the device's busy and idle share of the
   seconds the profiler recorded (and of the span of its device
   activity), its top kernels (K1 among the BERT ones),
   ``/debug/hotspots``. (f) devstats' MFU of the bucket-8 replay in (b)
   against the analytic forward FLOPs (a third of ``bench.py:358``'s), the
   HBM capacity and the peak memory. (g) ``/debug/numerics``: the tap's
   finite fraction 1.0, the shadow's divergence, a faultlab nan_poison's
   storm episode; ``/debug/slo`` and ``/debug/history`` with this
   traffic's series. Prints a {"programs": ...} line; the kernels line's
   ``launches_by_path`` carries the HTTP path's K1 launches.
22. (Run after phase 21.) SPMD over a device mesh (``parallel_phase``,
   ``--parallel-only``). Meshes name cuda:0 once per position unless the
   machine shows that many devices (``_par_devices``). First ring
   attention (sp = 4) against flash_attention over the whole sequence on
   one device, forward and the gradients in q, k, v: bf16 (1, 8, 8192,
   128) causal within 3e-2 relative Frobenius, fp32 (1, 2, 2048, 128) full
   and causal within 1e-4. (a) GPT at bench.py bench_long_context width
   (vocab 32768, units 1024, 4 layers, 8 heads, S 8192, B 1, bf16,
   FeaturesView + ChunkedLMLoss) from one set of weights with
   ``attention`` flash (one device), ring (sp = 4) and Ulysses (sp = 4):
   one plain forward/backward each, the loss within 1e-2 and every
   gradient within 3e-2 of flash's in Frobenius norm relative to its own
   norm, but those zero to rounding: a gradient whose norm with the
   model cast to fp32 is below 1e-2 of its bf16 norm (only the key
   biases may be: softmax ignores a shift of a row's scores; their norms
   are printed); then Adam
   (multi_precision) TrainSteps from the same weights, 2 warm-up + 5
   timed: step ms (median), tokens/s, peak memory, captured or not (a
   step that runs shard_map runs eagerly), and K1, K2, K3 each launched
   exactly 4 (flash), 40 (ring: 4 layers x (4 + 6)) and 16 (Ulysses: 4 x
   4) times a step. (b) The same model at S 32768 with flash (one device)
   and ring (local S 8192): 1 + 3 steps, the same numbers. (c)
   Full-width BERT (B 64 x S 512, bf16, flash, Adam multi_precision),
   three steps through DataParallelTrainStep (dp = 4) and
   TrainStep(mesh, zero=True) from the same weights against TrainStep on
   one device: every loss within 1e-1 of one device's 3-step loss drop;
   per parameter (but the key biases, zero to rounding as in (a)) the
   Adam first moment within 3e-2 and the fp32 master's change within
   2.5e-1 relative Frobenius (Adam moves an element whose gradient is
   below bf16 noise either way); the same check must fail two planted
   faults, a step that updates nothing and one device trained on a
   quarter of the batch. K1/K2/K3 48 a step (12 layers x 4 positions),
   every Adam state of a row-divisible parameter in 4 slices of a
   quarter; step ms. (d) BERT with ``tp_axis="tp"`` as a
   MeshServable tp = 2 x replicas = 2 behind ModelRegistry: 16 requests
   from 4 threads at bucket 8 x S 512, replies within 3e-2 of the largest
   logit of BlockServable's, the replica dispatch counts summing to 16,
   K1 exactly 12 a batch; p50 and max. (e) 4 full-width BERT encoder
   layers (flash, bf16) as a pp = 4 PipelineStack, B 32 x S 512, 8
   microbatches: the forward within 3e-2 of the sequential stack; 1F1B
   (pp = 4) and interleaved (pp = 2, v = 2) gradients within 3e-2 of
   GPipe's (the ring under autograd), ms each. (f) MoELayer (D 1024, E 8,
   ffn 4096, top-2, capacity 1.25) over 8192 tokens, fp32 with TF32 off,
   ep = 4 against ep = 1: output, auxiliary loss and gradients within
   1e-4. Prints a {"parallel": ...} line; the kernels line's
   ``launches_by_path`` carries each GPT layout's and the DP, ZeRO and
   mesh-serving paths' K1/K2/K3 launches.
23. Several processes: two workers on cuda:0 (gloo: NCCL refuses two
   ranks on one GPU) started by tools/launch.py -n 2, each first checking
   that gloo's broadcast, all_gather and all_reduce take CUDA tensors,
   then running tests/dist_worker.py's matrix through the port's stores
   at small size (push/pull, compression, dist_async diverged / synced /
   forced / uneven, row-sparse, Module updating on the store: closed
   forms in the workers, digests equal across ranks here), then
   full-width BERT (S 512, bf16, flash, Adam multi_precision, B 32 a rank
   of the global 64) three steps through autograd.record and
   Trainer(kvstore="dist_sync"): (a) every parameter and optimizer state
   bitwise equal across the ranks (SHA-256 a leaf); (b) losses, first
   moments and fp32 masters against one process's Trainer on the whole
   batch at the same effective scale, with phase 22(c)'s bounds, which a
   planted fault (rank 1's pushes carry nothing) must fail; (c) K1/K2/K3
   12 a step on each rank; step ms, the store's collective ms and bytes a
   step, a profiled step's idle share (with telemetry.profstats), the
   backend and the workers' start seconds. (d) a dist_device_sync store
   over NCCL in a group of one process: init, push and pull of a
   BERT-sized bf16 gradient list, bit for bit. (e) Module over [gpu(0),
   gpu(0)] against one context, Estimator.fit and one SVRGModule epoch
   against the CPU, within 1e-5 (fp32, TF32 off). A worker that fails
   fails the phase. Prints a {"dist": ...} line.
24. ROADMAP item 6 (``contrib_phase``, ``--contrib-only``). (a) bench.py
   bench_quantized_inference: model-zoo resnet50_v1 (1000 classes,
   Xavier, bf16), B 256 x 3 x 224 x 224 from a seeded generator;
   quantize_net on the first 32 images (BN-folded int8 groups, V1
   residual wrappers, int8 chained); the bf16 and int8 nets as captured
   EvalSteps timed by CUDA events in alternating pairs: img/s, int8 TOPS
   at 8.2 GFLOP an image and its share of 1979 TOPS, peak memory, logit
   cosine and argmax agreement. Gates: finite int8 logits, the captured
   int8 output = its eager forward bit for bit, and the test's small
   int8 net on the card against the CPU (int8 weights equal, logits
   within 1e-2 relative Frobenius, equal argmax). (b) Full-width BERT
   (bf16, flash) with every Dense int8 (calibrated on 8 rows x S 512)
   served behind ModelRegistry at bucket 8 beside the bf16 net, 16
   requests from 4 threads each: fp32 replies equal to a direct EvalStep
   forward of the int8 net bit for bit, K1 exactly 12 a batch (its fp32
   instantiation flash_fwd_fma: the int8 Dense returns fp32, as in the
   reference), p50 and max against the bf16 net's, logit cosine. (c)
   Phase 17's ResNet-50 v1 symbol through contrib.onnx export_model and
   import_model, bound on gpu(0) through Module: B 32 fp32 with TF32 off
   within 1e-5 of the original symbol; export s, file MB, import+bind s.
   (d) Every mx.np/mx.npx case of tests/np_cases.py on the card against
   the CPU (fp32 within 1e-5 + 1e-6 relative, TF32 off; ints and bools
   exact), np.random and npx.random by moments, a gradient through
   mx.np ops. (e) A softmax CustomOp (MXNet's custom_softmax.py) as the
   loss head of a small MLP, 3 SGD steps, and a TorchBlock over
   torch.nn.Linear, one step, each within 1e-5 of the CPU; to_torch and
   from_torch keep the device and do not alias; a contrib.text embedding
   file looked up on the card through nd.Embedding. Prints a
   {"contrib": ...} line; the kernels line's ``launches_by_path`` carries
   (b)'s K1 launches as ``int8_bert_serving``.
25. ROADMAP item 8 (``native_phase``, ``--native-only``): the C ABI and
   the native IO, built with g++ from the checkout into build/native/.
   (a) Full-width BERT (bf16, flash) exported at B 8 x S 512 by
   contrib.serving.export_model and loaded through the port's
   libmxtpu_predict in this process over ctypes: NATIVE_FORWARDS
   MXTPUPredForward calls, each output (raw bf16 words) bit for bit
   ServedModel.predict's, K1 exactly 12 a forward, the ABI's forward ms
   against predict's, and K1 held against its plain version at that shape.
   (b) cpp_package's predict.cc, compiled unchanged, in a fresh process on
   a float32 BERT exported at B 1 x S 64 (flash_fwd_fma, held against its
   plain version there): its 2.1 M printed values within NATIVE_CPP_TOL of
   the largest logit of the in-process forward (TF32 off); a timing client
   over the same header gives a fresh process's seconds to boot the
   interpreter and import the port, to load the artifact, and of its first
   and second forward (the four clients start together and run beside
   (a)'s export and load and (e); (a)'s timed forwards and (d) wait until
   no child is left). (c) train_mlp.cc and
   kvstore_io.cc, unchanged, on gpu(0): their OK lines. (d) 512 seeded
   256² JPEGs through ImageRecordIter at B 256, 224², 8 threads: tier 1
   (C++ decode), tier 2 (C++ reader, PIL) and tier 3 (Python) in img/s;
   then phase 17's ResNet-50 v1 symbol through Module.fit for 4 batches
   fed by tier 1, every loss finite. (e) The
   ResNet-50 v1 symbol at B 32 partitioned by a conv/BN/activation
   backend (at least one subgraph node): training outputs, gradients and
   moving statistics bit for bit the unpartitioned symbol's
   (cudnn.deterministic, TF32 off); a library.load-ed .py plugin op with a
   gradient on the card; runtime.Features with CUDA, CUDNN and NCCL
   (printed). (f) (a)'s artifact with no Python in the process:
   contrib.serving.export_pjrt_bundle compiles it into an AOTInductor
   package (timed), and native/src/aoti_serve.cc, built with g++ against
   libtorch, serves it in a fresh process with the C++ operator library
   ops/csrc/flash_fwd_op.cpp, which launches K1: no libpython in the
   child's /proc/<pid>/maps, its output words bit for bit those of
   aoti_load_package of the package in this process and within
   AOTI_BF16_TOL of the largest |logit| of ServedModel.predict's, K1
   exactly 12 a forward by the library's counter; the runner's load s
   and forward ms beside predict's. Prints a {"native": ...} line; the
   kernels line's ``launches_by_path`` carries (a)'s K1 launches as
   ``c_predict`` and (f)'s as ``aoti_serve``.
18. K5 (rtc): CudaModule compiles an axpy and a shared-memory block
   reduction with NVRTC and TritonModule an elementwise add; each launched
   once through its entry point, held against torch (exact for the add,
   1e-6 relative for axpy, fp32 summation order for the reduction), and
   timed three ways: eager (CUDA events over 50 back-to-back launches),
   host (the host clock over 1000 launches with no synchronisation inside:
   what a launch costs the host) and graph replay (the same 50 launches
   captured once in a CUDA graph and replayed: the kernels' own device
   time), beside the plain version, the library call and the bound. Each
   timed launch takes the next of six buffer sets, 96 MB or more in all,
   so its inputs come from HBM and not from the 50 MB L2. Then every
   kernel is launched again on each set (the add also with another
   BLOCK) and held against torch: the path the timings took. Last, a
   launch's host time is split into its parts (``rtc_host_breakdown``).

Prints the card's name and power limit, an {"ndarray": ...}, a
{"serving": ...}, a {"captured": ...}, a {"training": ...}, a
{"vision": ...}, a {"gluon_loop": ...}, an {"rnn": ...}, a
{"model_zoo": ...}, an {"ssd": ...}, a {"ctc": ...}, a {"module": ...},
a {"bucketing": ...}, a {"serving_http": ...}, a {"programs": ...}, a
{"parallel": ...}, a {"dist": ...}, a {"contrib": ...}, a
{"native": ...}, a {"phase_seconds": ...} and a
{"kernels": [...]} line and, as the last line, {"ok": true, "device":
{...}}. Exits
non-zero, printing no result, when CUDA is absent, the port is not beside
this script, or any phase fails.

    python3 chip_smoke.py --rtc-only [--root DIR]

runs phase 18 alone, on the port found in DIR (by default beside this
script), and prints the card's name and power limit and {"rtc": {...}}:
the way to time another tree's K5 launch path with the same code, for
example an unpacked parent commit's.

    python3 chip_smoke.py --imperative-only [--root DIR]

likewise runs phase 6c alone, AB_STEPS steps each of the imperative BERT
loop and of TrainStep, and prints {"imperative": {...}}; ``--train-only``
runs phases 1, 3 and 7 (the kernels' build, K2/K3 at the training
shapes, the full-width training path) and prints {"training": {...}};
``--gluon-only``
runs phase 12 alone and prints {"gluon_loop": {...}}, ``--rnn-only``
phase 13 ({"rnn": {...}}), ``--zoo-only`` phase 14
({"model_zoo": {...}}), ``--ssd-only`` phase 15 ({"ssd": {...}}) and
``--ctc-only`` phase 16 ({"ctc": {...}}), ``--module-only`` phase 17
({"module": {...}}), ``--bucketing-only`` phase 19
({"bucketing": {...}}), ``--serving-http-only`` phase 20
({"serving_http": {...}}), ``--programs-only`` phase 21
({"programs": {...}}), ``--parallel-only`` phase 22
({"parallel": {...}}), ``--dist-only`` phase 23 ({"dist": {...}}),
``--contrib-only`` phase 24 ({"contrib": {...}}) and ``--native-only``
phase 25 ({"native": {...}}).

    python3 chip_smoke.py --profile-stress N [--root DIR]

repeats phase 21's profile N times under its BERT and generation traffic
at once (the decode loop replaying its graph while each capture starts
and stops) and prints {"profile_stress": {...}}; a capture that hangs
ends the process after WAIT_S with every thread's stack.
"""
import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate

BERT = dict(vocab_size=32768, units=1024, hidden_size=4096, num_layers=12,
            num_heads=8, max_length=512, dropout=0.0, attention="flash")
GPT = dict(vocab_size=32768, units=1024, num_layers=4, num_heads=8,
           max_length=8192, attention="flash")
BERT_S, BERT_BUCKET, BERT_REQUESTS, CLIENTS = 512, 8, 16, 4
GPT_S = 8192
BERT_TRAIN_B, BERT_TRAIN_STEPS = 64, (2, 8)      # (warm-up, timed)
GPT_TRAIN_B, GPT_TRAIN_STEPS = 1, (2, 4)
RESNET_B, RESNET_STEPS = 256, (3, 10)
RESNET_FLOPS_PER_IMAGE = 24.6e9    # bench.py:32, forward + backward
NDARRAY_STEPS = 5      # imperative BERT steps, held to TrainStep's
EAGER_STEPS = 5        # TrainStep's eager body, held to its captured graph
TRAIN_SYNC_STEPS = 3   # BERT replays under MXTPU_DEVSTATS_TRAIN_SYNC
TRAIN_SYNC_TOL = 0.10  # their gauge's device time against CUDA events
RESERVED_TOL = 0.05    # memory_reserved after a dropped step, relative
KNOB_MATMUL_TOL = 1e-5     # fp32 matmul under 'highest', card vs CPU
CAPTURE_REL_TOL = 1e-3     # full width: step EAGER_STEPS's loss, relative
PROFILED_STEPS = 2     # steps under torch.profiler for the idle share
REMAT_STEPS = (2, 3)   # GPT with remat: (first, timed) steps
SMALL_CAPTURED_STEPS = 4
AB_STEPS = 12          # the same, with --imperative-only
RANDOM_DRAWS = 1 << 24
# BASELINE config 5, the LSTM LM at its defaults: Zaremba et al.'s
# "medium" PTB model, trained as they do (batch 20, BPTT 35, SGD lr 1.0,
# gradient norm clipped at 5), fp32
LSTM_LM = dict(vocab_size=10000, embed_size=650, hidden_size=650,
               num_layers=2, dropout=0.5)
LM_BPTT, LM_BATCH, LM_LR, LM_CLIP = 35, 20, 1.0, 5.0
LM_STEPS = (2, 18)     # Gluon loop: (warm-up, timed), hybridized and plain
LM_STEP_TIMED = 10     # TrainStep timed steps, captured and eager
LM_SMALL = dict(vocab_size=200, embed_size=32, hidden_size=32, num_layers=2)
LM_SMALL_TOL = 1e-4    # card (cuDNN RNN, TF32 off) vs CPU, fp32
LM_USED_IDS = 1000     # the token stream's ids: the loss can fall in 20 steps
# the new model-zoo families: (get_model name, published input side, the
# small side for card = CPU)
ZOO = (("vgg16", 224, 32), ("alexnet", 224, 63), ("densenet121", 224, 224),
       ("squeezenet1.0", 224, 48), ("mobilenet1.0", 224, 32),
       ("mobilenetv2_1.0", 224, 32), ("inceptionv3", 299, 299))
ZOO_BATCH, ZOO_TIMED = 32, 5
ZOO_SMALL_TOL = 1e-4
# Xavier's arguments where the default uniform "avg" draw does not do:
# SqueezeNet 1.0's fire modules shrink it to a flat loss; the Gaussian "in"
# draw at magnitude 2 (tests/test_torch_model_zoo.py's) lets it fall
ZOO_INIT = {"squeezenet1.0": ("gaussian", "in", 2)}
# BASELINE config 4, SSD-512 (MXNet's example/ssd): SSD's own defaults (20
# classes, base 64) at 512², batch 32 (example/ssd/train.py's), bf16 with
# fp32 masters, SGD-momentum 0.9, wd 5e-4 and lr 0.004 (its defaults);
# labels padded to 4 rows; hard negatives at 3 (symbol_builder.py)
SSD = dict(num_classes=20, base_channels=64)
SSD_SIZE, SSD_BATCH, SSD_LABEL_ROWS = 512, 32, 4
SSD_LR, SSD_NEG_RATIO, SSD_NMS_TOPK = 0.004, 3, 400
SSD_ANCHORS = 4 * (128 ** 2 + 64 ** 2 + 32 ** 2 + 16 ** 2)     # 87,040
SSD_FLOPS = 66.92e9   # forward FLOP an image from the conv shapes
SSD_TIMED = 5          # captured TrainStep: timed replays
SSD_LOOP_STEPS = (2, 6)    # Gluon loop: (warm-up, timed)
SSD_EXACT_STEPS = 3    # captured against eager, bit for bit
SSD_SMALL, SSD_SMALL_SIZE = dict(num_classes=20, base_channels=8), 64
SSD_SMALL_TOL = 1e-4   # card (cuDNN, TF32 off) vs CPU, fp32
DET_SMALL_TOL = 1e-5   # detection operators card vs CPU, fp32
# The CTC acoustic model of example/speech_recognition/train_ctc.py (Dense →
# bidirectional LSTM → Dense, blank last, CTCLoss, Adam 3e-3) at
# DeepSpeech-2 width (Amodei et al. 2016; MXNet's deepspeech.cfg): 161
# spectrogram bins, 5 LSTM layers of 1760 a direction, 28 classes + blank,
# batch 32 (train_ctc.py's), T 800 frames (8 s at 10 ms), data lengths
# 400-800, label lengths 40-120 padded with -1, fp32
CTC = dict(mels=161, hidden=1760, layers=5, classes=28, batch=32,
           frames=800)
CTC_DATA_LENGTHS, CTC_LABEL_LENGTHS, CTC_LR = (400, 800), (40, 120), 3e-3
CTC_SMALL = dict(mels=161, hidden=32, layers=2, classes=28, batch=4,
                 frames=40)
CTC_SMALL_LENGTHS = ((20, 40), (4, 12))      # data, label lengths
CTC_SMALL_TOL = 1e-4   # card (cuDNN RNN, TF32 off) vs CPU, fp32
CTC_TIMED = 4          # captured TrainStep: timed replays
CTC_EAGER_TIMED = 2    # eager body: timed steps
CTC_LOOP_STEPS = (2, 3)    # Gluon loop: (warm-up, timed)
CTC_EXACT_STEPS = 3    # captured against eager, bit for bit
CTC_LOSS_TOL = 1e-4    # ops.ctc against F.ctc_loss, relative, finite losses
CTC_LOSS_ITERS = 5     # timed forward + backward of the loss alone
BREADTH_TOL = {"float32": 1e-4, "float64": 1e-10}  # nd.linalg card vs CPU
# ResNet-50's bottleneck 3x3/stride-1 convs at batch 256 (N, H, W, C, K),
# benchmark/conv_bwd_pilot.py:29-35
CONV_STAGES = ((256, 56, 56, 64, 64), (256, 28, 28, 128, 128),
               (256, 14, 14, 256, 256), (256, 7, 7, 512, 512))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def timed_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh, s, d, causal, itemsize):
    """Least time for the flash forward: bf16 tensor-core flops of the two
    products (only the kept (row, col) pairs when causal) against reading
    q, k, v once and writing out and lse once."""
    flops = attention_fwd_flops(bh, s, d, causal)
    nbytes = 4.0 * bh * s * d * itemsize + 4.0 * bh * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_fwd_flops(bh, s, d, causal):
    """K1's flop count: 4·BH·pairs·D (q kᵀ and p v); pairs S² or S(S+1)/2
    causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * bh * pairs * d


def attention_bwd_flops(kernel, bh, s, d, causal):
    """A backward kernel's own flop count: K2 ("dkv") 8·BH·pairs·D (s, dp,
    dV, dK), K3 ("dq") 6·BH·pairs·D (s, dp again, dQ); pairs S² or
    S(S+1)/2 causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (8.0 if kernel == "dkv" else 6.0) * bh * pairs * d


def attention_bwd_bound_ms(kernel, bh, s, d, causal, itemsize):
    """Least time for K2 ("dkv", writes dK and dV) or K3 ("dq", writes dQ):
    bf16 tensor-core flops (``attention_bwd_flops``) against reading q, dO,
    k, v in the input type and lse, delta in fp32 once, and writing the
    gradient(s) once."""
    flops = attention_bwd_flops(kernel, bh, s, d, causal)
    n_out = 2 if kernel == "dkv" else 1
    nbytes = (4 + n_out) * bh * s * d * itemsize + 2.0 * 4 * bh * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------------ phases
def build_kernels():
    from incubator_mxnet_tpu_torch.ops import _kernels, attention, conv_bwd
    t0 = time.perf_counter()
    paths = _kernels.build(attention.SOURCE, attention.BWD_SOURCE,
                           conv_bwd.SOURCE)
    log("build: %d kernel source(s) in %.1f s" % (len(paths),
                                                  time.perf_counter() - t0))
    ptxas, tc_wanted = [], []
    for src, tc in ((attention.SOURCE, ["flash_fwd_tc %s D%d" % (t, d)
                                        for t in ("bf16", "fp16")
                                        for d in (64, 128)]),
                    (attention.BWD_SOURCE, ["flash_bwd_%s_tc %s D%d" % (n, t, d)
                                            for n in ("dkv", "dq")
                                            for t in ("bf16", "fp16")
                                            for d in (64, 128)]),
                    (conv_bwd.SOURCE, ["conv3x3_%s_tc %s%s" % (n, t, tile)
                                       for n, tile in (
                                           ("dgrad", " 128x128"),
                                           ("dgrad", " 256x64"),
                                           ("wgrad", ""))
                                       for t in ("bf16", "fp16")])):
        fns = ptxas_report(_kernels.BUILD_LOG.get(src, ""))
        if not fns:
            log("  %s was built before this run: no ptxas report" % src)
            continue
        ptxas += fns
        tc_wanted += tc
    for fn in ptxas:
        log("  ptxas %s" % fn)
    # every tensor-core instantiation is reported, and none spills
    names = {fn["kernel"] for fn in ptxas}
    check(all(n in names for n in tc_wanted),
          "ptxas reported no %s" % [n for n in tc_wanted if n not in names])
    check(all(fn["spill_stores"] == 0 for fn in ptxas
              if "_tc " in fn["kernel"]),
          "a tensor-core kernel spills: %s" % [
              fn for fn in ptxas if "_tc " in fn["kernel"]
              and fn["spill_stores"] != 0])
    return ptxas


def ptxas_report(build_log):
    """Per kernel instantiation in an ``nvcc -Xptxas -v`` log: its name
    (kernel, element type, then D for the flash kernels or the tile for
    K4's dgrad), registers and spill bytes."""
    import re
    fns, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"(flash_bwd_(?:dkv|dq)_(?:tc|fma)|flash_fwd_"
                             r"(?:tc|fma)|conv3x3_(?:dgrad|wgrad)_(?:tc|fma)|"
                             r"conv3x3_wgrad_reduce)(?=I|E)", mangled)
            dtype = ("bf16" if "bfloat16" in mangled else "fp16"
                     if "6__half" in mangled else "fp32")
            ints = re.findall(r"Li(\d+)E", mangled)
            extra = "" if not ints else " D" + ints[0] \
                if name and name.group(1).startswith("flash") \
                else " " + "x".join(ints)
            cur = dict(kernel="%s %s%s" % (
                name.group(1) if name else mangled, dtype, extra),
                registers=None, spill_stores=None, spill_loads=None)
            fns.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return fns


FWD_RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}
# relative Frobenius error against _fa_reference (fp32 p): the output's own
# rounding, about 2^-8/sqrt(3) (bf16) or 2^-11/sqrt(3) (fp16) of its spread,
# plus the smaller error of rounding each p
FWD_NORM_TOL = {"bfloat16": 1e-2, "float16": 2e-3}


def fwd_term_sums(q, k, v, causal, scale):
    """sum_j p_ij |v_j| / l_i in fp32 (B, H, S, D), with p and l as
    _fa_reference computes them: for each out element, the sum of the
    magnitudes of the terms whose p the tensor-core K1 rounds to the input
    type."""
    import math
    import torch
    from incubator_mxnet_tpu_torch.ops import attention as A
    S = q.shape[2]
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~A._causal_keep(S, S, s.device), -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    del s
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    return torch.matmul(p, v.float().abs()) / l


def hold_fwd(tag, q, k, v, out, lse, causal, scale):
    """K1's ``out`` and ``lse`` against _fa_reference (the same function in
    fp32, dense) on the same inputs; returns the larger max error.
    Tolerances: lse (fp32 everywhere) within atol 2e-4 / rtol 1e-5 and fp32
    out within atol 1e-4 / rtol 1e-5 (summation order); bf16/fp16 out
    elementwise within 1e-4 plus one rounding of the type (2^-7 bf16, 2^-10
    fp16, relative) of the output and of each term p_ij |v_j| / l_i
    (``fwd_term_sums``: the tensor-core kernel rounds p to the type against
    its running max, the plain version keeps p in fp32), and normwise within
    ``FWD_NORM_TOL``. Every out finite."""
    import torch
    from incubator_mxnet_tpu_torch.ops import attention as A
    dtype = str(q.dtype).split(".")[-1]
    ref, ref_lse = A._fa_reference(q, k, v, causal, scale)
    g, want = out.float(), ref.float()
    err = (g - want).abs()
    terms = fwd_term_sums(q, k, v, causal, scale) \
        if dtype in FWD_NORM_TOL else 0.0
    bound = 1e-4 + FWD_RTOL[dtype] * (want.abs() + terms)
    max_err = err.max().item()
    check(bool(torch.isfinite(g).all()) and bool((err <= bound).all()),
          "%s: flash_fwd out differs from plain (max abs %.3g, worst share "
          "of the bound %.3g)" % (tag, max_err, (err / bound).max().item()))
    norm = ((g - want).norm() / want.norm().clamp_min(1e-30)).item()
    check(dtype not in FWD_NORM_TOL or norm <= FWD_NORM_TOL[dtype],
          "%s: flash_fwd out differs from plain by %.3g (Frobenius, relative)"
          % (tag, norm))
    # a fully masked row has lse -inf on both sides
    lse_err = torch.where(lse == ref_lse, 0.0, (lse - ref_lse).abs()) \
        .max().item()
    check(torch.allclose(lse, ref_lse, rtol=1e-5, atol=2e-4),
          "%s: flash_fwd lse differs from plain (max abs %.3g)"
          % (tag, lse_err))
    log("  %-40s max|out-plain| %.3g (%.3g of the bound)  |out-plain|/|plain|"
        " %.3g  max|lse-plain| %.3g" % (tag, max_err,
                                        (err / bound).max().item(), norm,
                                        lse_err))
    return max(max_err, lse_err)


def masked_inputs(q, k):
    """(q, k) with row 5 of head 1 scoring -inf against every key (the
    product overflows), as in tests/test_torch_attention_bwd.py."""
    k = k.abs() + 1.0
    q = q.clone()
    q[0, 1, 5, :] = -1e38
    return q, k


def check_flash_fwd():
    """K1 against its plain version (``hold_fwd``) at ragged/odd shapes and
    the served shapes; at the served shapes also kernel, plain and SDPA
    times."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(tag, B, H, S, D, causal, dtype, masked=False):
        q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev,
                               dtype=dtype) for _ in range(3))
        if masked:
            q, k = masked_inputs(q, k)
        scale = 1.0 / D ** 0.5
        out, lse = A._flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        if masked:
            check(bool((out[0, 1, 5] == 0).all())
                  and bool(torch.isneginf(lse[1, 0, 5])),
                  "%s: the fully masked row's out is not 0 or its lse not "
                  "-inf" % tag)
        return q, k, v, scale, hold_fwd(tag, q, k, v, out, lse, causal,
                                        scale)

    log("flash_fwd vs plain version:")
    for tag, shape, causal, dtype, masked in (
            ("fp32 B2 H3 S1000 D64 causal", (2, 3, 1000, 64), True,
             torch.float32, False),
            ("fp16 B1 H4 S300 D128", (1, 4, 300, 128), False, torch.float16,
             False),
            ("bf16 B1 H2 S130 D64 causal", (1, 2, 130, 64), True,
             torch.bfloat16, False),
            ("bf16 B1 H2 S7 D128 causal", (1, 2, 7, 128), True,
             torch.bfloat16, False),
            ("bf16 B1 H2 S128 D64 causal masked row", (1, 2, 128, 64), True,
             torch.bfloat16, True),
            # the serving_http phase's shapes: BERT over HTTP at S 64 (one
            # partial tile) at its smallest and largest batch, and the
            # captured EvalStep's smaller buckets at S 512
            ("bf16 B1 H8 S64 D128 (HTTP)", (1, 8, SERVE_HTTP_S, 128), False,
             torch.bfloat16, False),
            ("bf16 B8 H8 S64 D128 (HTTP)", (8, 8, SERVE_HTTP_S, 128), False,
             torch.bfloat16, False),
            ("bf16 B1 H8 S512 D128 (EvalStep)", (1, 8, BERT_S, 128), False,
             torch.bfloat16, False),
            ("bf16 B2 H8 S512 D128 (EvalStep)", (2, 8, BERT_S, 128), False,
             torch.bfloat16, False),
            ("bf16 B4 H8 S512 D128 (EvalStep)", (4, 8, BERT_S, 128), False,
             torch.bfloat16, False),
            # the contrib phase's int8 BERT: its quantized Dense returns
            # fp32, so K1 runs its fp32 instantiation at the served shape
            ("fp32 B8 H8 S512 D128 (int8 BERT)", (BERT_BUCKET, 8, BERT_S,
                                                  128), False, torch.float32,
             False)):
        compare(tag, *shape, causal, dtype, masked)

    served = []
    for tag, (B, H, S, D), causal, iters in (
            ("bert", (BERT_BUCKET, 8, BERT_S, 128), False, 50),
            ("gpt", (1, 8, GPT_S, 128), True, 20)):
        q, k, v, scale, err = compare("bf16 %s B%d H%d S%d D%d%s" % (
            tag, B, H, S, D, " causal" if causal else ""),
            B, H, S, D, causal, torch.bfloat16)
        check(A.flash_attention_legal(q.shape, k.shape, v.shape),
              "%s shape is not kernel-legal" % tag)
        ms = timed_ms(lambda: A._flash_fwd_cuda(q, k, v, causal, scale),
                      iters)
        plain_ms = timed_ms(lambda: A._fa_reference(q, k, v, causal, scale),
                            max(2, iters // 5))
        lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
        bound_ms, bound_by = attention_bound_ms(B * H, S, D, causal, 2)
        flops = attention_fwd_flops(B * H, S, D, causal)
        served.append(dict(shape="B%d H%d S%d D%d bf16%s" % (
            B, H, S, D, " causal" if causal else ""), max_abs_err=err,
            ms=ms, flops=flops, tflops=flops / ms / 1e9,
            share_of_bound=bound_ms / ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
        log("  %s: kernel %.4f ms (%.1f TFLOP/s, %.1f%% of bound)  plain %.4f"
            " ms  sdpa %.4f ms  bound %.4f ms (%s)" % (
                tag, ms, served[-1]["tflops"],
                100 * served[-1]["share_of_bound"], plain_ms, lib_ms,
                bound_ms, bound_by))
        del q, k, v
    torch.cuda.empty_cache()
    return served


def check_small_models_against_cpu():
    """Small float32 BERT/GPT with head width 64: the card (kernel route)
    against the CPU (plain route) on the same weights; atol/rtol 1e-3 covers
    the two devices' float32 summation orders through two layers."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = onp.random.RandomState(0).randint(0, 1000, (2, 256)) \
        .astype("int32")
    for name in ("bert", "gpt"):
        net = _small_pair(name)[0]
        ref = mxt.jit.EvalStep(net)(tokens)._data
        before = _kernels.LAUNCHES.get("flash_fwd", 0)
        out = mxt.jit.EvalStep(net.to("cuda:0"))(tokens)._data.cpu()
        check(_kernels.LAUNCHES.get("flash_fwd", 0) - before == 2,
              "small %s did not run flash_fwd once per layer" % name)
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, atol=1e-3, rtol=1e-3),
              "small %s: card and CPU disagree (max abs %.3g)" % (name, err))
        log("small %s fp32, card vs CPU: max abs diff %.3g" % (name, err))


BWD_RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 0.0}
BWD_ATOL_SHARE = {"bfloat16": 1e-3, "float16": 1e-3, "float32": 1e-4}
# relative Frobenius error against the fp32-p recompute (the JAX function):
# one rounding of p and of ds to the type, about 2^-8/sqrt(3) (bf16) or
# 2^-11/sqrt(3) (fp16) of each term, plus the gradient's own rounding
BWD_NORM_TOL = {"bfloat16": 1e-2, "float16": 2e-3}
# (tag, (B, H, S, D), causal, dtype, LSE cotangent, fully masked row)
BWD_ODD_SHAPES = (
    ("fp32 B2 H3 S1000 D64 causal", (2, 3, 1000, 64), True, "float32",
     False, False),
    ("fp16 B1 H4 S300 D128 g_lse", (1, 4, 300, 128), False, "float16",
     True, False),
    ("bf16 B1 H2 S130 D64 causal", (1, 2, 130, 64), True, "bfloat16",
     False, False),
    ("bf16 B1 H2 S7 D128 causal", (1, 2, 7, 128), True, "bfloat16",
     False, False),
    ("bf16 B2 H2 S512 D64", (2, 2, 512, 64), False, "bfloat16", False,
     False),
    ("bf16 B1 H2 S128 D64 causal masked row", (1, 2, 128, 64), True,
     "bfloat16", False, True))


def bwd_term_sums(q, k, v, o, lse, do, causal, scale, g_lse):
    """(|dS| |k|, |dS|ᵀ |q|, Pᵀ |dO|) in fp32: for each gradient element, the
    sum of the magnitudes of the terms whose p or ds factor is rounded to
    the input type (the plain version's arithmetic, _fa_bwd_reference)."""
    import math
    import torch
    from incubator_mxnet_tpu_torch.ops import attention as A
    B, H, S, D = q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~A._causal_keep(S, S, s.device), -math.inf)
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    del s
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2))
               - A._bwd_delta(o, do, g_lse).reshape(B, H, S, 1))
          * scale).abs()
    return (torch.matmul(ds, kf.abs()),
            torch.matmul(ds.transpose(-1, -2), qf.abs()),
            torch.matmul(p.transpose(-1, -2), dof.abs()))


def hold_bwd(tag, q, k, v, o, lse, do, causal, scale, g_lse, got):
    """K2/K3's (dq, dk, dv) against _fa_bwd_reference on the same inputs;
    returns {gradient: max abs error}. Elementwise against the plain version,
    which rounds p and ds where the kernels do: fp32 within 1e-4 x
    max|plain| (summation order); bf16/fp16 within one rounding of the type
    (2^-7 bf16, 2^-10 fp16, relative) of the gradient and of each rounded
    term of its sum, plus 1e-3 x max|plain|. The terms' share: kernel and
    plain version compute p and ds in fp32 in another order, so a p or ds
    within an fp32 ulp or so of a rounding boundary of the type rounds to
    neighbouring values on the two sides (at BERT's training shape one dV
    element of 33.5 M exceeded the tolerance without it, by a single flip of
    a p near 0.3). bf16/fp16 also normwise against the fp32-p recompute
    (``BWD_NORM_TOL``). Every gradient finite."""
    import torch
    from incubator_mxnet_tpu_torch.ops import attention as A
    dtype = str(q.dtype).split(".")[-1]
    ref = A._fa_bwd_reference(q, k, v, o, lse, do, causal, scale, g_lse)
    ref32 = A._fa_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                lse, do.float(), causal, scale, g_lse) \
        if dtype in BWD_NORM_TOL else ref
    terms = bwd_term_sums(q, k, v, o, lse, do, causal, scale, g_lse) \
        if dtype in BWD_NORM_TOL else (0.0, 0.0, 0.0)
    errs, norms = {}, {}
    for name, g, want, want32, term in zip(("dq", "dk", "dv"), got, ref,
                                           ref32, terms):
        g, want, want32 = g.float(), want.float(), want32.float()
        err = (g - want).abs()
        bound = BWD_RTOL[dtype] * (want.abs() + term) \
            + BWD_ATOL_SHARE[dtype] * want.abs().max()
        check(bool(torch.isfinite(g).all()) and bool((err <= bound).all()),
              "%s: %s differs from plain (max abs %.3g, max|plain| %.3g)"
              % (tag, name, err.max().item(), want.abs().max().item()))
        errs[name] = err.max().item()
        norms[name] = ((g - want32).norm() / want32.norm().clamp_min(1e-30)) \
            .item()
        check(dtype not in BWD_NORM_TOL or norms[name] <= BWD_NORM_TOL[dtype],
              "%s: %s differs from the fp32-p recompute by %.3g (Frobenius, "
              "relative)" % (tag, name, norms[name]))
    log("  %-40s max|d-plain| dq %.3g dk %.3g dv %.3g; |d-fp32p|/|fp32p| "
        "dq %.3g dk %.3g dv %.3g" % (tag, errs["dq"], errs["dk"], errs["dv"],
                                     norms["dq"], norms["dk"], norms["dv"]))
    return errs


def check_flash_bwd():
    """K2 and K3 against _fa_bwd_reference (``hold_bwd``) on the same
    inputs, the forward's out and lse from K1, which is itself held against
    its plain version (``hold_fwd``) there. Returns {"dkv": [...], "dq":
    [...], "fwd": [...]}: per training shape, the max error, kernel ms,
    achieved TFLOP/s on the kernel's own flop count, share of the bound,
    plain ms (the whole plain backward), bound, and SDPA's backward ms (the
    pair's yardstick); for K1 ("fwd") its max error, kernel ms, plain
    forward ms, bound and SDPA forward ms."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def compare(tag, B, H, S, D, causal, dtype, with_g_lse, masked=False):
        q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(4))
        if masked:
            q, k = masked_inputs(q, k)
        scale = 1.0 / D ** 0.5
        o, lse = A._flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_fwd = hold_fwd(tag, q, k, v, o, lse, causal, scale)
        g_lse = torch.randn(B, H, S, generator=gen, device=dev) \
            if with_g_lse else None
        delta = A._bwd_delta(o, do, g_lse)
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        errs = hold_bwd(tag, q, k, v, o, lse, do, causal, scale, g_lse,
                        (dq, dk, dv))
        if masked:
            check(bool((dq[0, 1, 5] == 0).all()),
                  "%s: the fully masked row's dq is not zero" % tag)
        return (q, k, v, o, lse, do, delta, scale,
                max(errs["dk"], errs["dv"]), errs["dq"], err_fwd)

    log("flash_bwd_dkv / flash_bwd_dq vs plain version:")
    for tag, shape, causal, dtype, g, masked in BWD_ODD_SHAPES:
        compare(tag, *shape, causal, getattr(torch, dtype), g, masked)

    out = {"dkv": [], "dq": [], "fwd": []}
    for tag, (B, H, S, D), causal, iters in (
            ("bert", (BERT_TRAIN_B, 8, BERT_S, 128), False, 20),
            ("gpt", (GPT_TRAIN_B, 8, GPT_S, 128), True, 10)):
        shape = "B%d H%d S%d D%d bf16%s" % (B, H, S, D,
                                            " causal" if causal else "")
        (q, k, v, o, lse, do, delta, scale, err_dkv, err_dq,
         err_fwd) = compare("%s %s" % (tag, shape), B, H, S, D, causal,
                            torch.bfloat16, False)
        ms_dkv = timed_ms(lambda: A._flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal, scale), iters)
        ms_dq = timed_ms(lambda: A._flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal, scale), iters)
        ms_fwd = timed_ms(lambda: A._flash_fwd_cuda(q, k, v, causal, scale),
                          iters)
        plain_fwd_ms = timed_ms(lambda: A._fa_reference(
            q, k, v, causal, scale), 2)
        lib_fwd_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
        plain_ms = timed_ms(lambda: A._fa_bwd_reference(
            q, k, v, o, lse, do, causal, scale), 2)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        lib_ms = timed_ms(lambda: torch.autograd.grad(
            sdpa, (qr, kr, vr), do, retain_graph=True), iters)
        for kernel, ms, err in (("dkv", ms_dkv, err_dkv),
                                ("dq", ms_dq, err_dq)):
            bound_ms, bound_by = attention_bwd_bound_ms(kernel, B * H, S, D,
                                                        causal, 2)
            flops = attention_bwd_flops(kernel, B * H, S, D, causal)
            out[kernel].append(dict(
                shape=shape, max_abs_err=err, ms=ms, flops=flops,
                tflops=flops / ms / 1e9, share_of_bound=bound_ms / ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms))
        fwd_bound, fwd_by = attention_bound_ms(B * H, S, D, causal, 2)
        fwd_flops = attention_fwd_flops(B * H, S, D, causal)
        out["fwd"].append(dict(shape=shape, max_abs_err=err_fwd, ms=ms_fwd,
                               flops=fwd_flops, tflops=fwd_flops / ms_fwd / 1e9,
                               share_of_bound=fwd_bound / ms_fwd,
                               plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                               bound_ms=fwd_bound, bound_by=fwd_by))
        log("  %s: K2 %.3f ms (%.1f TFLOP/s, %.1f%% of bound)  K3 %.3f ms "
            "(%.1f TFLOP/s, %.1f%% of bound)  plain bwd %.3f ms  sdpa bwd "
            "%.3f ms  bound K2 %.4f K3 %.4f ms; K1 %.3f ms (%.1f TFLOP/s, "
            "%.1f%% of bound)  plain fwd %.3f ms  sdpa fwd %.4f ms  bound "
            "%.4f ms"
            % (tag, ms_dkv, out["dkv"][-1]["tflops"],
               100 * out["dkv"][-1]["share_of_bound"], ms_dq,
               out["dq"][-1]["tflops"], 100 * out["dq"][-1]["share_of_bound"],
               plain_ms, lib_ms, out["dkv"][-1]["bound_ms"],
               out["dq"][-1]["bound_ms"], ms_fwd, out["fwd"][-1]["tflops"],
               100 * out["fwd"][-1]["share_of_bound"], plain_fwd_ms,
               lib_fwd_ms, fwd_bound))
        del q, k, v, o, lse, do, delta, qr, kr, vr, sdpa
        torch.cuda.empty_cache()
    return out


def _small_pair(kind, seed=1):
    """A small float32 BERT or GPT on the CPU (head width 64, so the
    kernels engage on the card) and its (step net, loss) for training."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    kw = dict(vocab_size=1000, units=128, num_layers=2, num_heads=2,
              max_length=256, attention="flash")
    if kind == "bert":
        net = models.BERTModel(hidden_size=512, dropout=0.0, **kw)
    else:
        net = models.GPTModel(**kw)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    if kind == "bert":
        return net, net, mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, models.FeaturesView(net), models.ChunkedLMLoss(net,
                                                                chunk=128)


def check_small_training_against_cpu():
    """Three Adam TrainSteps of the small fp32 models, on the card (kernel
    route) and on the CPU (plain route), from the same weights: per-step
    losses and the parameters after the steps agree within 1e-3."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = onp.random.RandomState(2).randint(0, 1000, (2, 256)) \
        .astype("int32")
    for kind in ("bert", "gpt"):
        runs = {}
        for where in ("cpu", "gpu"):
            model, net, loss_fn = _small_pair(kind)
            if where == "gpu":
                model.to("cuda:0")
            step = mxt.jit.TrainStep(net, loss_fn, mxt.gluon.Trainer(
                net.collect_params(), "adam", {"learning_rate": 1e-3}))
            _kernels.reset_launches()
            losses = [step(tokens, tokens)._data.cpu() for _ in range(3)]
            launches = dict(_kernels.LAUNCHES)
            runs[where] = (losses, mxt.to_numpy_params(model))
            check(where == "cpu" or all(
                launches.get(n, 0) == 2 * 3 for n in
                ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
                "small %s training launched %s, expected 6 of each kernel"
                % (kind, launches))
        loss_err = max((a - b).abs().max().item()
                       for a, b in zip(runs["cpu"][0], runs["gpu"][0]))
        for a, b in zip(runs["cpu"][0], runs["gpu"][0]):
            check(torch.allclose(a, b, atol=1e-3, rtol=1e-3),
                  "small %s training: losses differ, card %s vs CPU %s"
                  % (kind, b.tolist(), a.tolist()))
        param_err = 0.0
        for name, ref in runs["cpu"][1].items():
            got = runs["gpu"][1][name]
            param_err = max(param_err, float(onp.abs(got - ref).max()))
            check(onp.allclose(got, ref, atol=1e-3, rtol=1e-3),
                  "small %s training: %s differs after 3 steps (max abs "
                  "%.3g)" % (kind, name, onp.abs(got - ref).max()))
        log("small %s fp32 training, card vs CPU: losses %s, max abs diff "
            "loss %.3g params %.3g" % (kind, [round(float(x.mean()), 5)
                                              for x in runs["gpu"][0]],
                                       loss_err, param_err))


def serve_full_width():
    """The main path through ModelRegistry; returns (launches, summary)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models, profiler, serving
    from incubator_mxnet_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    bert = models.BERTModel(**BERT)
    bert.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
    bert.cast("bfloat16")
    gpt = models.GPTModel(**GPT)
    gpt.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
    gpt.cast("bfloat16")
    reg = serving.ModelRegistry()
    reg.load("bert", bert, max_batch_size=BERT_BUCKET, batch_timeout_ms=50)
    reg.load("gpt", gpt, max_batch_size=1)
    log("serving: models built and loaded in %.1f s"
        % (time.perf_counter() - t0))
    rng = onp.random.RandomState(0)
    bert_rows = rng.randint(0, 32768, (BERT_REQUESTS, BERT_S)).astype("int32")
    gpt_row = rng.randint(0, 32768, (GPT_S,)).astype("int32")
    try:
        # warm-up: one request each (library handles, first launches)
        reg.predict("bert", bert_rows[0])
        reg.predict("gpt", gpt_row)
        base = {n: reg.metrics(n).batch_count for n in ("bert", "gpt")}
        replies, lat, errors = {}, {"bert": [], "gpt": []}, []

        def bert_client(c):
            try:
                mine = range(c, BERT_REQUESTS, CLIENTS)
                t = time.perf_counter()
                reqs = {i: reg.submit("bert", bert_rows[i]) for i in mine}
                for i, r in reqs.items():
                    replies[i] = r.result(600)[0]
                    lat["bert"].append((time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        def gpt_client():
            try:
                t = time.perf_counter()
                replies["gpt"] = reg.predict("gpt", gpt_row)[0]
                lat["gpt"].append((time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=bert_client, args=(c,))
                   for c in range(CLIENTS)]
        threads.append(threading.Thread(target=gpt_client))
        torch.cuda.synchronize()
        _kernels.reset_launches()
        profiler.dumps(reset=True)
        with profiler._LOCK:
            profiler._EVENTS.clear()
        profiler.set_state("run")
        t0 = time.perf_counter()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
        finally:
            profiler.set_state("stop")
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_kernels.LAUNCHES)
        served_events = {n: [e for e in profiler._EVENTS
                             if e["name"].startswith("serve:%s:" % n)]
                         for n in ("bert", "gpt")}
        check(not any(t.is_alive() for t in threads), "a client hung")
        check(not errors, "requests failed: %r" % errors[:3])
        batches = {n: reg.metrics(n).batch_count - base[n]
                   for n in ("bert", "gpt")}
        hist = reg.metrics("bert").snapshot()["batch_size_hist"]
        bad_ids = serve_after_bad_ids(reg, bert_rows[:BERT_BUCKET])
    finally:
        reg.close()

    expected = BERT["num_layers"] * batches["bert"] \
        + GPT["num_layers"] * batches["gpt"]
    check(launches.get("flash_fwd", 0) == expected,
          "flash_fwd launched %d times on the serving path, expected %d "
          "(%d layers x %d BERT batches + %d layers x %d GPT batches)"
          % (launches.get("flash_fwd", 0), expected, BERT["num_layers"],
             batches["bert"], GPT["num_layers"], batches["gpt"]))
    check(launches.get("flash_bwd_dkv", 0) == 0
          and launches.get("flash_bwd_dq", 0) == 0,
          "the backward kernels launched on the serving path: %s" % launches)
    for i in range(BERT_REQUESTS):
        r = replies[i]
        check(r.shape == (BERT_S, 32768) and r.dtype == onp.float32,
              "bert reply %d has shape %s %s" % (i, r.shape, r.dtype))
        check(bool(onp.isfinite(r).all()), "bert reply %d not finite" % i)
    g = replies["gpt"]
    check(g.shape == (GPT_S, 32768) and bool(onp.isfinite(g).all()),
          "gpt reply has shape %s or is not finite" % (g.shape,))
    for n, want in (("bert", BERT_REQUESTS), ("gpt", 1)):
        evs = served_events[n]
        check(len(evs) == batches[n] and sum(
            e["args"]["batch_size"] for e in evs) == want and all(
            e["name"] == "serve:%s:batch%d" % (n, e["args"]["bucket"])
            for e in evs), "profiler: %d serve:%s events for %d batches "
            "of %d requests: %s" % (len(evs), n, batches[n], want,
                                    [(e["name"], e["args"]) for e in evs]))
    profiled = {n: [(e["name"], e["args"]["batch_size"], e["dur"] / 1e3)
                    for e in evs] for n, evs in served_events.items()}

    # served rows against a direct forward of the same row (bf16 GEMMs at
    # another batch size may round differently: allow 2% of the logit range)
    step = mxt.jit.EvalStep(bert)
    worst = 0.0
    for i in (0, BERT_REQUESTS - 1):
        direct = step(bert_rows[i][None])[0].asnumpy()
        diff = float(onp.abs(direct - replies[i]).max())
        worst = max(worst, diff)
        check(diff <= 0.02 * float(onp.abs(direct).max()) + 1e-3,
              "served bert row %d differs from EvalStep by %.3g" % (i, diff))
    breakdown = {"bert_bucket%d" % BERT_BUCKET:
                 stage_breakdown(bert, bert_rows[:BERT_BUCKET]),
                 "gpt": stage_breakdown(gpt, gpt_row[None])}
    summary = dict(
        breakdown=breakdown,
        bert_batches=batches["bert"], bert_batch_sizes=hist,
        gpt_batches=batches["gpt"], wall_ms=wall_ms,
        bert_latency_ms=sorted(lat["bert"]), gpt_latency_ms=lat["gpt"],
        served_vs_direct_max_abs=worst, bad_ids=bad_ids,
        profiled_batches=profiled)
    log("serving: %d BERT requests in %d batches %s, 1 GPT request; "
        "wall %.1f ms" % (BERT_REQUESTS, batches["bert"], hist, wall_ms))
    log("serving: BERT latency ms p50 %.1f max %.1f; GPT latency ms %.1f; "
        "served-vs-direct max abs %.3g"
        % (sorted(lat["bert"])[len(lat["bert"]) // 2], max(lat["bert"]),
           lat["gpt"][0], worst))
    return launches, summary


def serve_after_bad_ids(reg, rows):
    """One BERT request with the token ids vocab_size and -vocab_size - 1
    between two submissions of the same batch of ``rows``. The reference
    (jnp.take) gives those ids NaN embeddings, which attention spreads over
    the whole row, so the reply must be NaN throughout (tests/
    test_torch_models.py holds the two packages' NaN against each other on
    the CPU); the batch's replies after it must equal those before it, and
    the card must still synchronise: an out-of-range gather would have
    tripped a device-side assert and left the CUDA context unusable."""
    import numpy as onp
    import torch

    def batch():
        before = reg.metrics("bert").batch_count
        reqs = [reg.submit("bert", r) for r in rows]
        return ([r.result(600)[0] for r in reqs],
                reg.metrics("bert").batch_count - before)

    first, first_batches = batch()
    bad = rows[0].copy()
    bad[3], bad[10] = BERT["vocab_size"], -BERT["vocab_size"] - 1
    reply = reg.predict("bert", bad)[0]
    check(reply.shape == (BERT_S, BERT["vocab_size"])
          and bool(onp.isnan(reply).all()),
          "the reply to out-of-range token ids is not NaN throughout "
          "(%d NaN of %d)" % (int(onp.isnan(reply).sum()), reply.size))
    again, again_batches = batch()
    check(all(onp.array_equal(a, b) for a, b in zip(first, again)),
          "a batch served after out-of-range token ids differs from the "
          "same batch before them")
    torch.cuda.synchronize()
    log("serving: out-of-range token ids answered with NaN; the batch of "
        "%d before (%d dispatch(es)) and after (%d) it agree bit for bit"
        % (len(rows), first_batches, again_batches))
    return dict(rows=len(rows), batches_before=first_batches,
                batches_after=again_batches)


def _autograd_cases(ctx):
    """MXNet's imperative autograd on ``ctx``: "write" and "add" variables
    through two backwards (and each backward alone), ``autograd.grad``, a
    custom ``Function``, writes into a parameter's ``data()`` (outside and
    inside ``record()``) and an array taken from a parameter before
    ``Trainer.step``. Returns name → numpy result."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import autograd, nd
    rng = onp.random.RandomState(9)
    x0, h0, h1 = (rng.randn(4, 5).astype("float32") for _ in range(3))
    out = {}
    for req, heads in (("write", (h0, h1)), ("add", (h0, h1)),
                       ("first", (h0,)), ("second", (h1,))):
        x = nd.array(x0, ctx=ctx)
        x.attach_grad("add" if req == "add" else "write")
        for head in heads:
            with autograd.record():
                y = nd.tanh(x) * x
            y.backward(nd.array(head, ctx=ctx))
        out[req] = x.grad.asnumpy()
    x = nd.array(x0, ctx=ctx)
    x.attach_grad()
    with autograd.record():
        y = (nd.exp(x * 0.5) * x).sum()
    out["grad"] = autograd.grad(y, x).asnumpy()
    out["grad_leaves_dot_grad"] = x.grad.asnumpy()

    class Sigmoid(autograd.Function):
        def forward(self, a):
            s = 1 / (1 + nd.exp(-a))
            self.save_for_backward(s)
            return s

        def backward(self, ds):
            (s,) = self.saved_tensors
            return ds * s * (1 - s)
    x = nd.array(x0, ctx=ctx)
    x.attach_grad()
    with autograd.record():
        y = Sigmoid()(x * 3)
    y.backward(nd.array(h0, ctx=ctx))
    out["function"] = x.grad.asnumpy()
    net = mxt.gluon.nn.Dense(3, in_units=5)
    net.initialize(ctx=ctx)
    net.weight.data()[:] = nd.array(rng.randn(3, 5).astype("float32"),
                                    ctx=ctx)
    net.bias.data()[1] = 2.5
    out["param_write"] = net(nd.array(x0, ctx=ctx)).asnumpy()
    # inside record() too a write into a variable lands in it, unrecorded
    with autograd.record():
        net.weight.data()[0] = 1.5
        w = net.weight.data()
        w += 0.25
        y = (net(nd.array(x0, ctx=ctx)) ** 2).sum()
    y.backward()
    out["param_write_in_record"] = net.weight.data().asnumpy()
    out["param_write_in_record_grad"] = net.weight.grad().asnumpy()
    # an array taken from a parameter is its own: the step leaves it be
    flat = net.weight.data().reshape(-1)
    out["weight_before_step"] = net.weight.data().asnumpy().reshape(-1)
    mxt.gluon.Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1}).step(4)
    out["taken_before_step"] = flat.asnumpy()
    out["weight_after_step"] = net.weight.data().asnumpy().reshape(-1)
    return out


def check_ndarray_sweep():
    """The port's op sweep (test_utils) with the CPU and the card as its
    two legs: forward in fp32, bf16 and fp16 at SWEEP_TOLS, gradients in
    fp32. Any mismatch or error fails."""
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import test_utils
    t0 = time.perf_counter()
    legs = [mxt.cpu(), mxt.gpu(0)]
    rows = test_utils.op_consistency_sweep(ctx_list=legs)
    grads = test_utils.grad_consistency_sweep(ctx_list=legs)
    bad = [r for r in rows if r[3] != "ok"] + \
        [r for r in grads if r[2] != "ok"]
    check(not bad, "ndarray sweep, card against CPU: %d of %d rows fail: %s"
          % (len(bad), len(rows) + len(grads), bad[:8]))
    worst = {}          # dtype -> [relative error, entry]
    for op, dt, err, _ in rows + [(op, "grad_float32", err, s)
                                  for op, err, s in grads]:
        if err >= worst.get(dt, [-1.0])[0]:
            worst[dt] = [err, op]
    summary = dict(entries=len({r[0] for r in rows}), forward_rows=len(rows),
                   grad_rows=len(grads), worst_rel_err=worst,
                   seconds=time.perf_counter() - t0)
    log("ndarray sweep, card against CPU: %d entries, %d forward rows "
        "(fp32/bf16/fp16), %d fp32 gradient rows, all ok in %.1f s; worst "
        "relative error %s" % (summary["entries"], len(rows), len(grads),
                               summary["seconds"],
                               {k: "%.3g (%s)" % tuple(v)
                                for k, v in worst.items()}))
    return summary


def check_ndarray_autograd():
    """``_autograd_cases`` on the card against the same code on the CPU,
    within 1e-5 (fp32 elementwise work and one small matrix product); on
    each device "write" is the second backward's gradient, "add" the sum
    of both, and ``autograd.grad`` leaves ``.grad`` at zeros."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    runs = [_autograd_cases(mxt.cpu()), _autograd_cases(mxt.gpu(0))]
    worst = 0.0
    for k, want in runs[0].items():
        got = runs[1][k]
        check(got.shape == want.shape and onp.allclose(
            got, want, atol=1e-5, rtol=1e-5),
            "ndarray autograd %s: card %s vs CPU %s" % (k, got, want))
        worst = max(worst, float(onp.abs(got - want).max()))
    for where, r in zip(("CPU", "card"), runs):
        check(onp.array_equal(r["write"], r["second"]),
              "%s: 'write' is not the last backward's gradient" % where)
        check(onp.allclose(r["add"], r["first"] + r["second"], rtol=1e-6,
                           atol=1e-6),
              "%s: 'add' is not the sum of the backwards" % where)
        check(not r["grad_leaves_dot_grad"].any(),
              "%s: autograd.grad wrote a variable's .grad" % where)
        check(onp.array_equal(r["taken_before_step"], r["weight_before_step"])
              and not onp.allclose(r["weight_after_step"],
                                   r["weight_before_step"]),
              "%s: an array taken from a parameter moved with its update"
              % where)
    log("ndarray autograd, card against CPU: %s agree within %.3g; 'write' "
        "is the last backward's, 'add' the sum" % (sorted(runs[0]), worst))
    return dict(cases=sorted(runs[0]), max_abs_diff=worst)


def _indexing_cases(ctx):
    """The indexing operators on ids out of range (clipped, wrapped,
    filled or dropped as the JAX package's jnp calls do) on ``ctx``."""
    import numpy as onp
    from incubator_mxnet_tpu_torch import nd
    x = nd.array(onp.arange(24, dtype="float32").reshape(6, 4), ctx=ctx)
    ids = nd.array(onp.array([0, 5, -1, -6, 6, 40, -7], "int32"), ctx=ctx)
    rows = nd.array(onp.array([1, -1, 4, 9, -9, 0], "int32"), ctx=ctx)
    nd_ids = nd.array(onp.array([[-1, 9, 0], [3, -8, 2]], "int32"), ctx=ctx)
    out = {"take_" + m: nd.take(x, ids, mode=m) for m in ("clip", "wrap",
                                                          "fill")}
    out["pick"] = nd.pick(x, rows)
    out["one_hot"] = nd.one_hot(ids, 6)
    out["gather_nd"] = nd.gather_nd(x, nd_ids)
    out["batch_take"] = nd.batch_take(x, rows)
    out["scatter_nd"] = nd.scatter_nd(nd.array([1.0, 2.0, 3.0], ctx=ctx),
                                      nd_ids, shape=(6, 4))
    out["embedding"] = nd.Embedding(ids, x)
    return {k: v.asnumpy() for k, v in out.items()}


def check_indexing_out_of_range():
    """``_indexing_cases`` on the card equal to the CPU's, NaN in the same
    places, and the card still synchronises (no device-side assert)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    want, got = _indexing_cases(mxt.cpu()), _indexing_cases(mxt.gpu(0))
    torch.cuda.synchronize()
    for k in want:
        check(onp.array_equal(got[k], want[k], equal_nan=True),
              "%s with ids out of range: card %s vs CPU %s"
              % (k, got[k], want[k]))
    check(float((torch.ones(3, device="cuda:0") * 2).sum()) == 6.0,
          "the card does not compute after the indexing ops")
    log("ndarray indexing with ids out of range: %s equal on the card and "
        "the CPU; the card still synchronises" % sorted(want))
    return sorted(want)


def _timed_step(fn):
    """(result, device ms, host ms) of one step, synchronised after."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - h0) * 1e3


def train_bert_imperative(tmp, n=NDARRAY_STEPS):
    """Full-width BERT (B 64 x S 512, bf16, Adam with fp32 masters) through
    MXNet's Gluon loop on NDArrays, held to jit.TrainStep: the same initial
    weights (saved to a .params file before the TrainStep run and loaded
    back after it) and the same batch, ``n`` steps each. Returns
    (the trained model, K1-K3 launches of the loop, summary)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import autograd, models, nd
    from incubator_mxnet_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    B, S = BERT_TRAIN_B, BERT_S
    model = models.BERTModel(**BERT)
    model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                     generator=torch.Generator(device=dev).manual_seed(7))
    model.cast("bfloat16")
    init_file = os.path.join(tmp, "bert_init.params")
    model.save_parameters(init_file)
    tokens = onp.random.RandomState(8).randint(
        0, BERT["vocab_size"], (B, S)).astype("int32")
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()

    def trainer():
        return mxt.gluon.Trainer(model.collect_params(), "adam", {
            "learning_rate": 1e-4, "multi_precision": True})

    step = mxt.jit.TrainStep(model, loss_fn, trainer())
    batch = torch.from_numpy(tokens).to(dev)
    ref = [_timed_step(lambda: step(batch, batch)) for _ in range(n)]
    del step
    gc.collect()
    torch.cuda.empty_cache()

    model.load_parameters(init_file)
    x = nd.array(tokens, ctx=mxt.gpu(0))
    y = nd.array(tokens, ctx=mxt.gpu(0))
    gluon_trainer = trainer()

    def imperative_step():
        with autograd.record():
            loss = loss_fn(model(x), y)
        loss.backward()
        gluon_trainer.step(B)
        return loss

    _kernels.reset_launches()
    got = [_timed_step(imperative_step) for _ in range(n)]
    launches = dict(_kernels.LAUNCHES)

    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches.get(k, 0) == BERT["num_layers"] * n,
              "imperative bert: %s launched %d times in %d steps, expected "
              "%d layers x %d" % (k, launches.get(k, 0), n,
                                  BERT["num_layers"], n))
    bitwise, worst = True, 0.0
    for (a, _, _), (b, _, _) in zip(ref, got):
        check(isinstance(a, nd.NDArray) and isinstance(b, nd.NDArray)
              and a.shape == b.shape == (B,),
              "imperative bert: losses are not (B,) NDArrays")
        ta, tb = a._data.detach().float(), b._data.detach().float()
        check(bool(torch.isfinite(tb).all()), "imperative bert: a loss is "
              "not finite")
        bitwise &= bool(torch.equal(a._data, b._data))
        worst = max(worst, float(((ta - tb).abs() / ta.abs()).max()))
    check(bitwise or worst <= 1e-3, "imperative bert losses differ from "
          "TrainStep's by %.3g relative" % worst)
    for name, p in model.collect_params().items():
        check(bool(torch.isfinite(p.data()._data.float()).all()),
              "imperative bert: %s is not finite" % name)
    custom = _bert_custom_loop(model, x, y, loss_fn, B)
    ms = [g[1] for g in got[1:]]
    ref_ms = [r[1] for r in ref[1:]]
    summary = dict(
        custom_loop=custom, batch=[B, S], steps=n,
        losses=[float(g[0]._data.detach().float().mean()) for g in got],
        train_step_losses=[float(r[0]._data.float().mean()) for r in ref],
        losses_bitwise_equal=bitwise, max_rel_loss_diff=worst,
        step_ms=sum(ms) / len(ms), step_host_ms=sum(
            g[2] for g in got[1:]) / len(ms),
        train_step_ms=sum(ref_ms) / len(ref_ms),
        train_step_host_ms=sum(r[2] for r in ref[1:]) / len(ref_ms),
        step_ms_each=[g[1] for g in got],
        train_step_ms_each=[r[1] for r in ref], launches=launches)
    log("imperative bert B %d x S %d (record / loss.backward() / "
        "trainer.step on NDArrays): losses %s TrainStep's (%s, max rel "
        "diff %.3g); step %.1f ms (host %.1f) against TrainStep's %.1f ms "
        "(host %.1f), steps after the first; K1/K2/K3 launched %s"
        % (B, S, "equal bit for bit to" if bitwise else "within 1e-3 of",
           ["%.4f" % v for v in summary["losses"]], worst, summary["step_ms"],
           summary["step_host_ms"], summary["train_step_ms"],
           summary["train_step_host_ms"],
           [launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dkv",
                                         "flash_bwd_dq")]))
    return model, launches, summary


def _card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines() or ["unknown"])[0]


def _bf16_apart(a, b, start):
    """(|a - b|, one bf16 ulp of max(|a|, |b|, |start|)) elementwise in
    fp32: the ulp is 2^(e - 8), e being frexp's exponent. ``start`` is
    the value a and b were updated from: where the step cancels it, a
    difference in the step shows against its size, not the result's."""
    import torch
    a, b = a.float(), b.float()
    e = torch.frexp(torch.maximum(torch.maximum(a.abs(), b.abs()),
                                  start.float().abs()))[1]
    return (a - b).abs(), torch.ldexp(torch.ones_like(a), e - 8)


def _bert_custom_loop(model, x, y, loss_fn, batch, lr=1e-4):
    """MXNet's custom training loop on the full-width BERT: two steps of
    record / backward / ``opt.update_multi_precision(i, p.data(), p.grad(),
    states[i])`` over every parameter (Adam, fp32 masters, rescale 1/B),
    against two ``Trainer.step``s of a fresh Trainer from the same weights
    and batch. Each step's ms and update ms by CUDA events. Both run
    ``update_all``, but the eager ``update`` takes Adam's step count from
    the host and computes the step size in double, as the JAX package's
    eager update does, where Trainer computes it from an fp32 device count
    (fp32 1 - 0.999 is 1.3e-5 off); so after step 1 the Adam moments must
    be equal bit for bit and every bf16 weight within one bf16 ulp of the
    larger of it and its start (a step that cancels the start leaves a
    result far smaller than the step), and after step 2 (whose gradients
    see step 1's weights) every weight within 4 lr plus that ulp (two Adam
    steps move a weight by about lr each). Returns a summary."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import autograd
    params = list(model.collect_params().values())
    start = [p._tensor().detach().clone() for p in params]

    def forward_backward():
        with autograd.record():
            loss = loss_fn(model(x), y)
        loss.backward()
        return loss

    def run(make_update, states):
        _reset(params, start)
        update = make_update()
        out = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            loss = forward_backward()
            ev[1].record()
            update()
            ev[2].record()
            ev[2].synchronize()
            st = states()
            out.append(dict(
                ms=ev[0].elapsed_time(ev[2]), update_ms=ev[1].elapsed_time(
                    ev[2]), loss=loss._data.detach().float().clone(),
                weights=[p._tensor().detach().clone() for p in params],
                masters=[s[0].clone() for s in st],
                moments=[torch.cat([s[1][0].flatten(), s[1][1].flatten()])
                         for s in st]))
        return out

    trainer = []

    def make_trainer():
        trainer.append(mxt.gluon.Trainer(model.collect_params(), "adam", {
            "learning_rate": lr, "multi_precision": True}))
        return lambda: trainer[0].step(batch)
    tr = run(make_trainer, lambda: trainer[0]._states)
    del trainer[:]
    opt = mxt.optimizer.Adam(learning_rate=lr, multi_precision=True,
                             rescale_grad=1.0 / batch)
    states = []

    def make_custom():
        states.extend(opt.create_state_multi_precision(i, p.data())
                      for i, p in enumerate(params))

        def update():
            for i, p in enumerate(params):
                opt.update_multi_precision(i, p.data(), p.grad(), states[i])
        return update

    def custom_states():
        return [(m._data, (s[0]._data, s[1]._data)) for m, s in states]
    cl = run(make_custom, custom_states)
    del states[:]
    check(all(isinstance(p.data(), mxt.nd.NDArray) for p in params),
          "custom loop: p.data() is not an NDArray")
    check(torch.equal(tr[0]["loss"], cl[0]["loss"]), "custom loop: the "
          "first losses differ from Trainer's (same weights and batch)")
    moments_equal = all(torch.equal(a, b) for a, b in zip(
        tr[0]["moments"], cl[0]["moments"]))
    bitwise = all(torch.equal(a, b) for t_, c_ in zip(tr, cl)
                  for a, b in zip(t_["weights"], c_["weights"]))
    def worst(step, fn):
        return max(fn(*_bf16_apart(a, b, w)) for a, b, w in zip(
            tr[step]["weights"], cl[step]["weights"], start))
    ulps1 = worst(0, lambda d, u: float((d / u).max()))
    ulps2 = worst(1, lambda d, u: float((d / u).max()))
    # how far past one ulp + 4 lr the worst weight of step 2 lies, in lr
    beyond2 = worst(1, lambda d, u: float((d - u - 4 * lr).max()) / lr)
    differ = [sum(int((a != b).sum()) for a, b in zip(
        t_["weights"], c_["weights"])) for t_, c_ in zip(tr, cl)]
    n_weights = sum(t.numel() for t in start)
    master_diff = [max(float((a - b).abs().max()) for a, b in zip(
        t_["masters"], c_["masters"])) for t_, c_ in zip(tr, cl)]
    if not (bitwise or (moments_equal and ulps1 <= 1 and beyond2 <= 0)):
        names = list(model.collect_params())
        k = max(range(len(params)), key=lambda i: float(
            (lambda d, u: (d / u).max())(*_bf16_apart(
                tr[0]["weights"][i], cl[0]["weights"][i], start[i]))))
        d, u = _bf16_apart(tr[0]["weights"][k], cl[0]["weights"][k],
                           start[k])
        j = int((d / u).flatten().argmax())
        n = start[k].numel()

        def at(t):
            return float(t.flatten()[j % t.numel()])
        raise SmokeFailure(
            "custom loop against Trainer.step: moments equal after step 1 "
            "%s, bf16 ulps after step 1 %.3g, after step 2 %.3g (%.3g lr "
            "past 4 lr + 1 ulp); worst at %s %s element %d: start %r, "
            "Trainer %r (master %r, m %r, v %r), loop %r (master %r, m %r, "
            "v %r)" % (moments_equal, ulps1, ulps2, beyond2, names[k],
                       tuple(start[k].shape), j, at(start[k]),
                       at(tr[0]["weights"][k]), at(tr[0]["masters"][k]),
                       at(tr[0]["moments"][k][:n]),
                       at(tr[0]["moments"][k][n:]),
                       at(cl[0]["weights"][k]), at(cl[0]["masters"][k]),
                       at(cl[0]["moments"][k][:n]),
                       at(cl[0]["moments"][k][n:])))
    summary = dict(
        steps=2, optimizer="adam", lr=lr, multi_precision=True,
        parameters=len(params), weights=n_weights,
        custom_step_ms=[r["ms"] for r in cl],
        custom_update_ms=[r["update_ms"] for r in cl],
        trainer_step_ms=[r["ms"] for r in tr],
        trainer_update_ms=[r["update_ms"] for r in tr],
        losses=[float(r["loss"].mean()) for r in cl],
        trainer_losses=[float(r["loss"].mean()) for r in tr],
        weights_bitwise_equal=bitwise,
        moments_bitwise_equal_after_step1=moments_equal,
        weights_differing=differ, max_bf16_ulps=[ulps1, ulps2],
        max_master_abs_diff=master_diff)
    log("custom loop (opt.update_multi_precision over %d parameters) on "
        "full-width BERT B %d: step %s ms, update %s ms against "
        "Trainer.step's step %s ms, update %s ms; weights %s (differing "
        "%s of %d, at most %s bf16 ulps; masters at most %s apart); Adam "
        "moments after step 1 %s [%s]" % (
            len(params), batch, ["%.1f" % v for v in summary[
                "custom_step_ms"]], ["%.1f" % v for v in summary[
                    "custom_update_ms"]],
            ["%.1f" % v for v in summary["trainer_step_ms"]],
            ["%.1f" % v for v in summary["trainer_update_ms"]],
            "equal bit for bit" if bitwise else "not bit for bit", differ,
            n_weights, ["%.3g" % v for v in (ulps1, ulps2)],
            ["%.3g" % v for v in master_diff],
            "equal bit for bit" if moments_equal else "DIFFERENT",
            _card_line()))
    return summary


def _sha256(path):
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def check_params_round_trip(model, tmp):
    """The trained model through save_parameters / load_parameters into a
    fresh model on the card: the file's bytes the same when saved twice,
    and the forward of a served batch (8 x 512) equal bit for bit."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    t0 = time.perf_counter()
    files = [os.path.join(tmp, "bert_trained_%d.params" % i) for i in (0, 1)]
    for f in files:
        model.save_parameters(f)
    digests = [_sha256(f) for f in files]
    check(digests[0] == digests[1], "save_parameters wrote different bytes "
          "twice: %s" % digests)
    fresh = models.BERTModel(**BERT)
    fresh.initialize(mxt.init.Zero(), ctx=mxt.gpu(0), generator=torch
                     .Generator(device="cuda:0").manual_seed(0))
    fresh.cast("bfloat16")
    fresh.load_parameters(files[0])
    batch = onp.random.RandomState(10).randint(
        0, BERT["vocab_size"], (BERT_BUCKET, BERT_S)).astype("int32")
    a = mxt.jit.EvalStep(model)(batch)
    b = mxt.jit.EvalStep(fresh)(batch)
    check(a.dtype == b.dtype == "bfloat16" and bool(
        torch.equal(a._data, b._data)), "the loaded model's forward differs "
        "from the saved one's")
    nbytes = os.path.getsize(files[0])
    for f in files:
        os.remove(f)
    del fresh
    log(".params round trip: %.0f MB written twice with one sha256, loaded "
        "into a fresh model on the card, served batch %d x %d equal bit for "
        "bit (%.1f s)" % (nbytes / 1e6, BERT_BUCKET, BERT_S,
                          time.perf_counter() - t0))
    return dict(bytes=nbytes, sha256=digests[0], bitwise_equal=True,
                seconds=time.perf_counter() - t0)


def check_random():
    """nd.random on the card: seed(s) repeats the draws (globally and for
    the card alone), and the moments of RANDOM_DRAWS normal and uniform
    draws lie within 5 standard errors."""
    import math
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ndarray import random
    gpu = mxt.gpu(0)

    def draw():
        return (random.normal(shape=(RANDOM_DRAWS,), ctx=gpu),
                random.uniform(shape=(RANDOM_DRAWS,), ctx=gpu))
    random.seed(11)
    a = draw()
    random.seed(11)
    b = draw()
    random.seed(12, ctx=gpu)
    c = draw()
    random.seed(12, ctx=gpu)
    d = draw()
    for u, v in ((a, b), (c, d)):
        for p, q in zip(u, v):
            check(bool((p._data == q._data).all()),
                  "nd.random.seed did not repeat the draws on the card")
    check(not bool((a[0]._data == c[0]._data).all()),
          "two seeds gave the same draws")
    n = RANDOM_DRAWS
    moments = {}
    for name, t, mean, var, var_se in (
            ("normal", a[0], 0.0, 1.0, math.sqrt(2.0 / n)),
            ("uniform", a[1], 0.5, 1.0 / 12, math.sqrt(1.0 / 180 / n))):
        x = t._data.double()
        m, v = float(x.mean()), float(x.var(unbiased=False))
        check(abs(m - mean) < 5 * math.sqrt(var / n)
              and abs(v - var) < 5 * var_se,
              "nd.random.%s moments off: mean %.6f var %.6f" % (name, m, v))
        moments[name] = dict(mean=m, var=v)
    log("nd.random on the card: seed repeats the draws; %d draws: normal "
        "mean %.5f var %.5f, uniform mean %.5f var %.5f"
        % (n, moments["normal"]["mean"], moments["normal"]["var"],
           moments["uniform"]["mean"], moments["uniform"]["var"]))
    return dict(draws=n, moments=moments, seed_repeats=True)


def _build_tmp():
    """A fresh directory under the checkout's git-ignored build/."""
    import tempfile
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_", dir=build)


def check_ndarray(card):
    """The NDArray layer on the card: the op sweep, imperative autograd,
    full-width BERT through the Gluon loop against TrainStep, the .params
    round trip of the trained model, nd.random. Returns (K1-K3 launches of
    the imperative BERT, summary)."""
    import shutil
    import torch
    tmp = _build_tmp()
    try:
        summary = dict(card=card, sweep=check_ndarray_sweep(),
                       autograd=check_ndarray_autograd(),
                       indexing=check_indexing_out_of_range(),
                       breadth=check_ndarray_breadth())
        model, launches, summary["bert"] = train_bert_imperative(tmp)
        summary["params"] = check_params_round_trip(model, tmp)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        summary["random"] = check_random()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, summary


def _eager_step(step, *inputs, n_net_inputs=1):
    """One step of TrainStep's eager body (what its CUDA graph captures),
    run uncaptured: _prepare, _forward, _backward, _update."""
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    args = step._prepare(inputs, n_net_inputs)
    loss = step._forward(args, n_net_inputs)
    step._update(args[0].shape[step.batch_axis], step._backward(loss))
    return NDArray(loss.detach())


def _raw_device_events(prof):
    """(start µs, end µs, name) of every device activity (kernels, copies,
    fills) torch.profiler recorded, from its raw results: the events
    ``prof.events()`` gives as ``FunctionEvent``s (the same intervals and
    filter), without building one for every host operator too, which took
    seconds a trace for a step of ~60,000 launches."""
    from torch.autograd import DeviceType
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def _device_events(prof):
    """(start, end) in microseconds of every device activity (kernels,
    copies, fills) torch.profiler recorded, sorted."""
    return sorted((start, end) for start, end, _ in _raw_device_events(prof))


def device_idle_share(fn, steps=PROFILED_STEPS, top=0):
    """``steps`` calls of ``fn`` under torch.profiler (CPU and CUDA
    activity): the device's busy time (the union of its activity
    intervals), the window (host clock from the first call to the end of a
    final synchronise, the profiler's own cost included), the idle share
    1 - busy / window, and the device activities a step; with ``top``, the
    ``top`` device activities taking the most time a step, as
    ``top_kernels`` gives them, from the same trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    busy, cur = 0.0, None
    events = _device_events(prof)
    for start, end in events:
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    check(events, "torch.profiler recorded no device activity")
    out = dict(idle_share=1.0 - busy / window_us, busy_ms=busy / 1e3,
               window_ms=window_us / 1e3,
               device_activities_per_step=len(events) / steps)
    if top:
        out["top_kernels"] = _top_of(prof, top, steps)
    return out


def _top_of(prof, n, steps):
    """The ``n`` device activities of a trace taking the most time, summed
    by name over its ``steps`` calls: [name (240 characters), ms a call,
    share of the device time]."""
    by_name = {}
    for start, end, name in _raw_device_events(prof):
        ms = (end - start) / 1e3 / steps
        by_name[name[:240]] = by_name.get(name[:240], 0.0) + ms
    total = sum(by_name.values()) or 1.0
    return [[k, ms, ms / total] for k, ms in
            sorted(by_name.items(), key=lambda t: -t[1])[:n] if ms > 0]


def kernels_in(fn):
    """The device activities (kernels, copies, fills) torch.profiler
    records while ``fn()`` runs (CUDA activity only: the host's operator
    events would add nothing to the count and most of the trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(_device_events(prof))


def _timed_steps(fn, n):
    """(results, device ms a step by CUDA events, host ms a step by the
    host clock with no synchronisation inside) of ``n`` calls of ``fn``."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    out = [fn() for _ in range(n)]
    host_ms = (time.perf_counter() - h0) * 1e3 / n
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / n, host_ms


def _reset(params, init):
    """Write the initial values back into the parameters, in place."""
    import torch
    with torch.no_grad():
        for p, t in zip(params, init):
            p._tensor().copy_(t)


def issue_ms(fn, n=3):
    """Host ms to issue one call of ``fn`` with the card idle before it
    (synchronised first, not after): the host's own cost of a step, with
    no launch queue to wait on. The median of ``n``."""
    import torch
    got = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        got.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(got)[n // 2]


def train_captured_and_eager(name, net, loss_fn, make_trainer, inputs,
                             warm, timed, extra_check=None, synced=0):
    """``net`` trained from its current weights through the captured
    TrainStep (a first step that captures, ``warm - 1`` replays, ``timed``
    timed replays, then PROFILED_STEPS replays under the profiler and 3
    issued with the card idle), then from the same weights through the
    eager body for EAGER_STEPS steps (the second phase by phase,
    ``step_phases``; the last EAGER_STEPS - 2 timed), then PROFILED_STEPS
    under the profiler, 3 issued with the card idle and one more whose
    update's device activities are counted. ``extra_check(trainer, losses,
    launches)`` runs on the captured run before its trainer goes. Step
    EAGER_STEPS's mean loss of the two runs must agree within
    CAPTURE_REL_TOL relative, and the running statistics (any parameter
    named "running_*") after EAGER_STEPS steps within it of their largest
    value. The captured run's calls must each add one to
    mxtpu_train_steps_total and to the step histogram's count (F7's
    telemetry, on the host around each replay). The step's graph is an
    aot.CACHE entry of kind "train" (``train_entry``): its calls count one
    miss (the capture) and a hit each after it, its FLOPs are measured
    and the gauge mxtpu_device_mfu{kind="train"} is finite and > 0; with
    ``synced``, that many more replays run under
    MXTPU_DEVSTATS_TRAIN_SYNC, and the device time the gauge's counters
    read must be within TRAIN_SYNC_TOL of the same replays' CUDA-event
    time. Dropped (and collected), the step leaves no entry behind and
    memory_reserved comes back within RESERVED_TOL of its level before
    the step was built (both read with cuBLAS's stream workspaces given
    back: ``_reserved_without_workspaces``). Returns (the captured run's
    launches over the timed steps, summary row)."""
    import torch
    from incubator_mxnet_tpu_torch import aot, jit
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.telemetry import devstats

    params = list(net.collect_params().values())
    running = [p for p in params if p.name.startswith("running")]
    init = [p._tensor().detach().clone() for p in params]

    def snap():
        return [p._tensor().detach().float().clone() for p in running]

    # -- captured, every call counted against the step's telemetry
    reserved0, workspaces0 = _reserved_without_workspaces()
    trainer = make_trainer()
    step = jit.TrainStep(net, loss_fn, trainer)
    steps0, (_, count0) = jit._STEPS.value(), jit._STEP_SECONDS.value()
    hits0, misses0 = (aot._HITS.value(kind="train"),
                      aot._MISSES.value(kind="train"))
    calls = []

    def counted():
        calls.append(1)
        return step(*inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [counted()]
    capture_s = time.perf_counter() - t0
    for _ in range(warm - 1):
        losses.append(counted())
    held = snap() if len(losses) == EAGER_STEPS else None
    _kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    for _ in range(timed):
        losses.append(counted())
        if len(losses) == EAGER_STEPS:
            held = snap()
    host_ms = (time.perf_counter() - h0) * 1e3 / timed
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / timed
    launches = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    profiled = device_idle_share(counted)
    issue = issue_ms(counted)
    check(step.captures == 1, "%s: %d captures of one signature"
          % (name, step.captures))
    telemetry = dict(calls=len(calls),
                     steps_total=jit._STEPS.value() - steps0,
                     step_seconds_count=jit._STEP_SECONDS.value()[1]
                     - count0)
    check(telemetry["steps_total"] == telemetry["step_seconds_count"]
          == len(calls), "%s: mxtpu_train_steps_total and the step "
          "histogram's count against the calls: %s" % (name, telemetry))
    if extra_check is not None:
        extra_check(trainer, losses, launches)
    means = [float(l._data.float().mean()) for l in losses]
    entry = train_entry(name, step, counted, calls, hits0, misses0, synced,
                        step_ms)
    keys = [k for k in aot.CACHE.keys() if step._token in k.extra]
    del step, trainer, counted
    reserved1, workspaces1 = _reserved_without_workspaces()
    left = [k for k in aot.CACHE.keys() if k in keys]
    entry.update(keys_left=len(left), reserved_before_gb=reserved0 / 1e9,
                 reserved_after_gb=reserved1 / 1e9,
                 cublas_workspaces_gb=[workspaces0 / 1e9, workspaces1 / 1e9])
    check(keys and not left, "%s: the dropped step's cache entries stayed "
          "(%d of %d)" % (name, len(left), len(keys)))
    check(abs(reserved1 - reserved0) <= RESERVED_TOL * reserved0,
          "%s: memory_reserved %.3f GB after the step was dropped, %.3f GB "
          "before it was built (tolerance %.0f%%)" % (
              name, reserved1 / 1e9, reserved0 / 1e9, 100 * RESERVED_TOL))
    log("%s: the dropped step left %d of its %d cache entries; "
        "memory_reserved %.3f GB before the step, %.3f GB after (cuBLAS's "
        "stream workspaces, %.3f and %.3f GB, given back first)" % (
            name, len(left), len(keys), reserved0 / 1e9, reserved1 / 1e9,
            workspaces0 / 1e9, workspaces1 / 1e9))

    # -- eager, from the same weights
    _reset(params, init)
    del init
    trainer = make_trainer()
    step = jit.TrainStep(net, loss_fn, trainer)
    torch.cuda.reset_peak_memory_stats()
    eager = [_eager_step(step, *inputs)]
    phases = step_phases(step, *inputs)
    eager.append(phases.pop("loss"))
    got, eager_ms, eager_host_ms = _timed_steps(
        lambda: _eager_step(step, *inputs), EAGER_STEPS - 2)
    eager += got
    eager_held = snap()
    eager_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eager_profiled = device_idle_share(lambda: _eager_step(step, *inputs))
    eager_issue = issue_ms(lambda: _eager_step(step, *inputs))
    args = step._prepare(inputs, 1)
    grads = step._backward(step._forward(args, 1))
    update_kernels = kernels_in(
        lambda: step._update(args[0].shape[0], grads))
    del step, trainer, args, grads
    gc.collect()
    torch.cuda.empty_cache()

    eager_means = [float(l._data.float().mean()) for l in eager]
    rel = [abs(a - b) / abs(b) for a, b in zip(means, eager_means)]
    check(all(math.isfinite(v) for v in means + eager_means),
          "%s: a loss is not finite" % name)
    check(rel[EAGER_STEPS - 1] <= CAPTURE_REL_TOL, "%s: step %d's loss "
          "captured %.6f against eager %.6f (%.3g relative)" % (
              name, EAGER_STEPS, means[EAGER_STEPS - 1],
              eager_means[EAGER_STEPS - 1], rel[EAGER_STEPS - 1]))
    stats_rel = max([float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(held, eager_held)] or [0.0])
    check(stats_rel <= CAPTURE_REL_TOL, "%s: running statistics after %d "
          "steps differ captured vs eager by %.3g of their largest value"
          % (name, EAGER_STEPS, stats_rel))
    row = dict(
        warmup_steps=warm, timed_steps=timed, step_ms=step_ms,
        step_host_ms=host_ms, issue_ms=issue, capture_step_s=capture_s,
        peak_memory_gb=peak_gb, peak_reserved_gb=reserved_gb,
        idle_share=profiled["idle_share"], profiled=profiled,
        losses=means, launches=launches, telemetry=telemetry,
        train_entry=entry,
        eager=dict(steps=EAGER_STEPS, step_ms=eager_ms,
                   step_host_ms=eager_host_ms, issue_ms=eager_issue,
                   peak_memory_gb=eager_peak_gb,
                   idle_share=eager_profiled["idle_share"],
                   profiled=eager_profiled, losses=eager_means,
                   step_phases_ms=phases,
                   update_device_activities=update_kernels),
        captured_vs_eager_rel_loss_diff=rel,
        running_stats_rel_diff=stats_rel if running else None)
    log("%s: captured step %.1f ms (host %.2f a step over the timed run, "
        "%.2f to issue one on an idle card), idle %.1f%% over %d profiled "
        "steps, first step (capture) %.1f s, peak %.2f GB (%.2f GB "
        "reserved); eager body %.1f ms (host %.1f, issue %.1f), idle "
        "%.1f%%, peak %.2f GB, phases fwd %.1f / bwd %.1f / update %.1f "
        "ms, update %d device activities; step-%d loss captured vs eager "
        "%.3g relative (all %s)%s; train telemetry: steps_total and the "
        "step histogram +%d over %d calls" % (
            name, step_ms, host_ms, issue, 100 * profiled["idle_share"],
            PROFILED_STEPS, capture_s, peak_gb, reserved_gb, eager_ms,
            eager_host_ms, eager_issue, 100 * eager_profiled["idle_share"],
            eager_peak_gb, phases["forward_ms"], phases["backward_ms"],
            phases["update_ms"], update_kernels, EAGER_STEPS,
            rel[EAGER_STEPS - 1], ["%.2g" % r for r in rel],
            "; running statistics %.3g of their largest" % stats_rel
            if running else "", telemetry["steps_total"], len(calls)))
    return launches, row


def _reserved_without_workspaces():
    """(torch.cuda.memory_reserved() with the cache emptied, the bytes of
    cuBLAS's workspaces given back before it was read). Torch keeps a
    workspace for each (thread's handle, stream) that ran a GEMM, a
    capture's side stream and autograd's thread included, which no step
    owns; torch's own leak check leaves them out the same way. Call it
    only while no captured graph that may use one is alive."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    return reserved, held - reserved


def train_entry(name, step, counted, calls, hits0, misses0, synced,
                step_ms):
    """The captured step's aot.CACHE accounting after its calls: one miss
    and len(calls) - 1 hits of kind "train", the entry's FLOPs and peak
    bytes, the train MFU gauge (finite, > 0; unsynced its time is the host
    window around each replay, so it reads high); then ``synced`` replays
    under MXTPU_DEVSTATS_TRAIN_SYNC (the gauge's EMA reset first): the
    device seconds a replay the gauge's counters read, against the CUDA
    events around the same replays (within TRAIN_SYNC_TOL), their step ms
    against the unsynced ``step_ms``, and the gauge's MFU beside the
    window's (FLOPs over the counters' device seconds)."""
    import torch
    from incubator_mxnet_tpu_torch import aot
    from incubator_mxnet_tpu_torch.telemetry import devstats
    mid = step._model_id
    stats = dict(step._last_stats or {})
    mfu = devstats._MFU.value(model=mid, kind="train", replica=0)
    out = dict(model_id=mid, flops=stats.get("flops"),
               peak_bytes=stats.get("peak_bytes"), mfu_gauge_unsynced=mfu)
    check(stats.get("flops", 0) > 0, "%s: the train entry has no FLOPs: %s"
          % (name, stats))
    check(math.isfinite(mfu) and mfu > 0, "%s: mxtpu_device_mfu{kind="
          "train} is %r" % (name, mfu))
    if synced:
        devstats.detach_model(mid)
        sec0 = devstats._DISPATCH_SECONDS.value(model=mid, kind="train")
        flops0 = devstats._FLOPS_TOTAL.value(model=mid, kind="train")
        os.environ["MXTPU_DEVSTATS_TRAIN_SYNC"] = "1"
        try:
            _, sync_ms, sync_host_ms = _timed_steps(counted, synced)
        finally:
            del os.environ["MXTPU_DEVSTATS_TRAIN_SYNC"]
        gauge_ms = (devstats._DISPATCH_SECONDS.value(model=mid, kind="train")
                    - sec0) * 1e3 / synced
        flops = devstats._FLOPS_TOTAL.value(model=mid, kind="train") - flops0
        rel = abs(gauge_ms - sync_ms) / sync_ms
        out.update(
            synced_replays=synced, synced_step_ms=sync_ms,
            synced_step_host_ms=sync_host_ms, gauge_device_ms=gauge_ms,
            gauge_vs_events_rel=rel,
            synced_vs_unsynced_step=sync_ms / step_ms,
            mfu_gauge_synced=devstats._MFU.value(model=mid, kind="train",
                                                 replica=0),
            mfu_window=flops / (gauge_ms * synced / 1e3) / PEAK_BF16_FLOPS)
        check(rel <= TRAIN_SYNC_TOL, "%s: the synced train gauge reads %.2f "
              "ms a replay, CUDA events %.2f ms (%.3g apart)"
              % (name, gauge_ms, sync_ms, rel))
        check(math.isfinite(out["mfu_gauge_synced"])
              and out["mfu_gauge_synced"] > 0, "%s: synced train MFU %r"
              % (name, out["mfu_gauge_synced"]))
    hits = aot._HITS.value(kind="train") - hits0
    misses = aot._MISSES.value(kind="train") - misses0
    out.update(calls=len(calls), hits=hits, misses=misses)
    check(misses == 1 and hits == len(calls) - 1, "%s: %d train misses and "
          "%d hits over %d calls, expected 1 and %d" % (
              name, misses, hits, len(calls), len(calls) - 1))
    log("%s train entry: %d calls, %d miss, %d hits; %.4g FLOP a step, "
        "pool %.2f GB; MFU gauge unsynced %.3g (host window)%s" % (
            name, len(calls), misses, hits, out["flops"],
            (out["peak_bytes"] or 0) / 1e9, mfu,
            "; %d synced replays %.2f ms (unsynced %.2f, %.4f x), the "
            "gauge's device time %.2f ms a replay (%.3g from CUDA events), "
            "MFU gauge %.4f, window %.4f" % (
                synced, out["synced_step_ms"], step_ms,
                out["synced_vs_unsynced_step"], out["gauge_device_ms"],
                out["gauge_vs_events_rel"], out["mfu_gauge_synced"],
                out["mfu_window"]) if synced else ""))
    return out


KNOB_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import incubator_mxnet_tpu_torch as mx
out = dict(precision=torch.get_float32_matmul_precision(),
           cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
           profiler_state=mx.profiler.state())
if os.environ.get("MXTPU_SEED") is not None:
    a = mx.nd.random.uniform(shape=(4096,), ctx=mx.gpu(0)).asnumpy()
    mx.random.seed(int(os.environ["MXTPU_SEED"]))
    b = mx.nd.random.uniform(shape=(4096,), ctx=mx.gpu(0)).asnumpy()
    out["seed_repeats"] = bool((a == b).all())
g = torch.Generator().manual_seed(0)
x, y = torch.randn(4096, 4096, generator=g), torch.randn(4096, 4096,
                                                         generator=g)
cpu = x @ y
xd, yd = x.cuda(), y.cuda()


def matmul():
    card = xd @ yd
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        xd @ yd
    end.record()
    end.synchronize()
    return dict(ms=start.elapsed_time(end) / 10,
                rel_frob_to_cpu=float((card.cpu() - cpu).norm() / cpu.norm()))
out["matmul"] = matmul()
mx._set_matmul_precision("high")          # the knob's mapping of 'high'
out["matmul_high"] = dict(matmul(), precision=(
    torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
print(json.dumps(out))
"""


def knob_children(tmp):
    """The knobs the package applies at import, in one fresh process on
    the card: MXTPU_SEED (a uniform draw on gpu(0) repeats after
    mx.random.seed of the same value), MXTPU_PROFILER_AUTOSTART with
    MXTPU_PROFILER_FILENAME (the profiler runs from import; its file
    exists after the process exits and is not empty) and
    MXTPU_MATMUL_PRECISION=highest (an fp32 4096² matmul within
    KNOB_MATMUL_TOL relative Frobenius of the CPU's); then the same
    matmul under the knob's 'high' (TF32): both times and distances
    printed."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["incubator_mxnet_tpu_torch"].__file__)))
    trace = os.path.join(tmp, "autostart-profile.json")
    got = _child(KNOB_CHILD, root, env=dict(
        MXTPU_SEED="1234", MXTPU_PROFILER_AUTOSTART="1",
        MXTPU_PROFILER_FILENAME=trace, MXTPU_MATMUL_PRECISION="highest"))
    trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
    highest, high = got["matmul"], got["matmul_high"]
    check(got["seed_repeats"], "MXTPU_SEED: the draws on gpu(0) did not "
          "repeat after mx.random.seed of the same value")
    check(got["profiler_state"] == "run" and trace_bytes > 0,
          "MXTPU_PROFILER_AUTOSTART: state %r, %d bytes in %s after exit"
          % (got["profiler_state"], trace_bytes, trace))
    check(got["precision"] == "highest" and not got["cudnn_allow_tf32"]
          and highest["rel_frob_to_cpu"] <= KNOB_MATMUL_TOL,
          "MXTPU_MATMUL_PRECISION=highest: %r" % got)
    check(high["precision"] == ["high", True], "'high': %r" % high)
    log("import-time knobs in a fresh process: MXTPU_SEED's draws repeat; "
        "the autostarted profile %d bytes after exit; fp32 4096² matmul "
        "under 'highest' %.3f ms, %.3g relative Frobenius from the CPU's; "
        "under 'high' (TF32) %.3f ms, %.3g" % (
            trace_bytes, highest["ms"], highest["rel_frob_to_cpu"],
            high["ms"], high["rel_frob_to_cpu"]))
    return dict(got, profile_bytes=trace_bytes)


def train_full_width(bwd):
    """The training path at full width, through the captured TrainStep and
    its eager body from the same weights (``train_captured_and_eager``),
    then GPT with remat; returns (launches by model, summary). ``bwd`` is
    check_flash_bwd's result: the kernels' ms at the training shapes, for
    their share of a step."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models

    dev = torch.device("cuda", 0)
    rng = onp.random.RandomState(3)
    launches_by_model, summary = {}, {}
    for i, (name, cfg, B, S, (warm, timed)) in enumerate((
            ("bert", BERT, BERT_TRAIN_B, BERT_S, BERT_TRAIN_STEPS),
            ("gpt", GPT, GPT_TRAIN_B, GPT_S, GPT_TRAIN_STEPS))):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(i)
        model = (models.BERTModel if name == "bert" else models.GPTModel)(
            **cfg)
        model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
        model.cast("bfloat16")
        if name == "bert":
            net, loss_fn = model, mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        else:
            net, loss_fn = models.FeaturesView(model), \
                models.ChunkedLMLoss(model)

        def make_trainer(net=net):
            return mxt.gluon.Trainer(net.collect_params(), "adam", {
                "learning_rate": 1e-4, "multi_precision": True})
        tokens = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (B, S))
                                  .astype("int32")).to(dev)
        n_params = sum(p.data().size
                       for p in net.collect_params().values())
        setup_s = time.perf_counter() - t0
        expected = cfg["num_layers"] * timed

        def extra_check(trainer, losses, launches, name=name,
                        expected=expected):
            means = [float(l._data.float().mean()) for l in losses]
            check(all(onp.isfinite(means)) and all(
                bool(torch.isfinite(l._data.float()).all()) for l in losses),
                "%s training: a loss is not finite: %s" % (name, means))
            check(means[-1] < means[0], "%s training: loss did not fall: %s"
                  % (name, means))
            for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
                check(launches.get(k, 0) == expected,
                      "%s training: %s launched %d times over the timed "
                      "steps, expected %d (layers x steps)"
                      % (name, k, launches.get(k, 0), expected))
            for j, p in enumerate(trainer._params):
                w = p.data()._data
                check(bool(torch.isfinite(w.float()).all()),
                      "%s training: parameter %d is not finite" % (name, j))
                check(w.dtype == torch.bfloat16 and torch.equal(
                    w, trainer._states[j][0].to(torch.bfloat16)),
                    "%s training: parameter %d is not its fp32 master cast "
                    "to bf16" % (name, j))

        launches, row = train_captured_and_eager(
            name, net, loss_fn, make_trainer, (tokens, tokens), warm, timed,
            extra_check, synced=TRAIN_SYNC_STEPS if name == "bert" else 0)
        launches_by_model[name] = launches
        shape_i = 0 if name == "bert" else 1
        kernel_ms = {k: bwd[key][shape_i]["ms"] for k, key in (
            ("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
            ("flash_bwd_dq", "dq"))}
        attn_ms = sum(kernel_ms[k] * launches[k] for k in kernel_ms) / timed
        row.update(batch=[B, S], params=n_params, setup_s=setup_s,
                   tokens_per_s=B * S / (row["step_ms"] / 1e3),
                   attention_kernels_ms_per_step=attn_ms,
                   attention_kernels_share=attn_ms / row["step_ms"])
        # bench.py:358's formula; GPT's counts its causal attention whole
        flops = 6.0 * n_params * B * S \
            + cfg["num_layers"] * 12.0 * B * S * S * cfg["units"]
        row["train_entry"].update(
            formula_flops=flops,
            entry_over_formula=row["train_entry"]["flops"] / flops)
        log("%s train entry: %.4g FLOP measured a step against bench.py:358's "
            "%.4g (%.4f x)" % (name, row["train_entry"]["flops"], flops,
                               row["train_entry"]["entry_over_formula"]))
        if name == "bert":
            row["share_of_989_tflops"] = flops / (row["step_ms"] / 1e3) \
                / PEAK_BF16_FLOPS
        else:
            row["remat"] = train_remat(net, loss_fn, make_trainer, tokens,
                                       cfg["num_layers"])
        summary[name] = row
        log("training %s: %d params, B %d x S %d; step %.1f ms (host %.2f); "
            "%.0f tokens/s; peak memory %.2f GB; losses %.4f -> %.4f; "
            "K1+K2+K3 %.1f ms per step (%.0f%%)%s"
            % (name, n_params, B, S, row["step_ms"], row["step_host_ms"],
               row["tokens_per_s"], row["peak_memory_gb"], row["losses"][0],
               row["losses"][-1], attn_ms,
               100 * row["attention_kernels_share"],
               "; %.1f%% of 989 TFLOP/s" % (100 * row["share_of_989_tflops"])
               if name == "bert" else ""))
        del model, net, loss_fn, tokens
        gc.collect()
        torch.cuda.empty_cache()
    tmp = _build_tmp()
    try:
        summary["knobs"] = knob_children(tmp)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return launches_by_model, summary


def train_remat(net, loss_fn, make_trainer, tokens, layers):
    """GPT through TrainStep(remat=True) from its current weights: the
    first REMAT_STEPS[0] steps (the first captures) held to TrainStep
    without remat from the same weights (the last one's mean loss within
    CAPTURE_REL_TOL relative: the recomputed forward's gradients), then
    REMAT_STEPS[1] timed replays; step ms, host ms and peak memory. The
    recomputed forward launches K1 twice a layer and step; K2 and K3
    once."""
    import torch
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.ops import _kernels
    params = list(net.collect_params().values())
    init = [p._tensor().detach().clone() for p in params]
    plain = jit.TrainStep(net, loss_fn, make_trainer())
    ref = [float(plain(tokens, tokens)._data.float().mean())
           for _ in range(REMAT_STEPS[0])]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    _reset(params, init)
    del init
    step = jit.TrainStep(net, loss_fn, make_trainer(), remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = [step(tokens, tokens) for _ in range(REMAT_STEPS[0])]
    _kernels.reset_launches()
    losses, ms, host_ms = _timed_steps(lambda: step(tokens, tokens),
                                       REMAT_STEPS[1])
    launches = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    means = [float(l._data.float().mean()) for l in first + losses]
    check(all(math.isfinite(v) for v in means), "gpt remat: a loss is not "
          "finite: %s" % means)
    n = REMAT_STEPS[0] - 1
    rel = abs(means[n] - ref[n]) / abs(ref[n])
    check(rel <= CAPTURE_REL_TOL, "gpt remat: step %d's loss %.6f against "
          "%.6f without remat (%.3g relative)" % (n + 1, means[n], ref[n],
                                                  rel))
    steps = REMAT_STEPS[1]
    for k, m in (("flash_fwd", 2), ("flash_bwd_dkv", 1), ("flash_bwd_dq", 1)):
        check(launches.get(k, 0) == m * layers * steps, "gpt remat: %s "
              "launched %d times in %d steps, expected %d x %d layers"
              % (k, launches.get(k, 0), steps, m, layers))
    log("gpt remat: step %.1f ms (host %.2f), peak memory %.2f GB, losses "
        "%s; step %d's loss against no remat from the same weights %.3g "
        "relative; launches %s" % (ms, host_ms, peak_gb,
                                   ["%.4f" % v for v in means], n + 1, rel,
                                   launches))
    captures = step.captures
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, step_ms=ms, step_host_ms=host_ms,
                peak_memory_gb=peak_gb, losses=means, launches=launches,
                captures=captures, no_remat_losses=ref,
                rel_loss_diff_to_no_remat=rel)


def conv_bound_ms(shape):
    """Least time for K4's work at (N, H, W, C, K): bf16 tensor-core flops of
    both products (2 x 2*N*H*W*9*C*K) against conv3x3_bytes (x, dy, dx and
    dw once in bf16)."""
    from incubator_mxnet_tpu_torch.ops import conv_bwd
    N, H, W, C, K = shape
    flops = 4.0 * N * H * W * 9 * C * K
    nbytes = conv_bwd.conv3x3_bytes((N, H, W, C), K)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), nbytes


def hold_conv(tag, got, want, dtype):
    """K4's (dx, dw) against the plain version's; returns the max error.
    fp32 within 1e-4 x max|plain| (summation order); bf16/fp16 within one
    rounding of the type (2^-7 bf16, 2^-10 fp16, relative) plus 1e-3 x
    max|plain|."""
    import torch
    rtol = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
            torch.float32: 0.0}[dtype]
    share = 1e-4 if dtype == torch.float32 else 1e-3
    errs = []
    for name, g, r in zip(("dx", "dw"), got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs()
        check(bool(torch.isfinite(g).all()) and bool(
            (err <= rtol * r.abs() + share * r.abs().max()).all()),
            "%s: conv_bwd %s differs from plain (max abs %.3g, max|plain| "
            "%.3g)" % (tag, name, err.max().item(), r.abs().max().item()))
        errs.append(err.max().item())
    log("  %-40s max|d-plain| dx %.3g dw %.3g" % (tag, errs[0], errs[1]))
    return max(errs)


CONV_ODD_SHAPES = ((3, 5, 9, 8, 16), (2, 7, 7, 40, 24), (4, 13, 11, 24, 72))
CONV_ITERS = 30     # timed launches of K4 and of cuDNN's pair, after a warm-up


def kernel_split_us(fn, iters=5):
    """Mean device microseconds per call of ``fn`` for each of K4's CUDA
    kernels (``conv3x3_*``, by name without template arguments), from
    torch.profiler; {} when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        name = e.key.split("<")[0].split("::")[-1].split("(")[0].strip()
        if us > 0 and name.startswith("conv3x3"):
            split[name] = split.get(name, 0.0) + us / iters
    return split


def check_conv_bwd():
    """K4 against _conv_bwd_reference at two odd fp32 shapes, three odd
    bf16/fp16 shapes and the four ResNet-50 stage shapes (bf16, batch 256),
    with K4, plain and cuDNN's dgrad + wgrad timed at the stage shapes and
    K4's dx and dw identical across two launches there; then conv3x3_s1's
    backward, the entry point. Returns (launches over the entry point's
    run, rows)."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import _kernels, conv_bwd
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(shape, dtype):
        N, H, W, C, K = shape
        return tuple(torch.randn(*s, generator=gen, device=dev).to(dtype)
                     for s in ((N, H, W, C), (N, H, W, K), (3, 3, C, K)))

    log("conv_bwd vs plain version:")
    for shape, dtype in (((3, 5, 9, 8, 16), torch.float32),
                         ((2, 7, 7, 32, 32), torch.float32),
                         *((sh, dt) for sh in CONV_ODD_SHAPES
                           for dt in (torch.bfloat16, torch.float16))):
        x, dy, w = inputs(shape, dtype)
        got = conv_bwd._conv_bwd_cuda(x, dy, w)
        torch.cuda.synchronize()
        hold_conv("%s N%d H%d W%d C%d K%d" % (
            str(dtype).split(".")[-1], *shape), got,
            conv_bwd._conv_bwd_reference(x, dy, w), dtype)
    rows = []
    for shape in CONV_STAGES:
        N, H, W, C, K = shape
        tag = "bf16 N%d H%d W%d C%d K%d" % shape
        x, dy, w = inputs(shape, torch.bfloat16)
        got = conv_bwd._conv_bwd_cuda(x, dy, w)
        torch.cuda.synchronize()
        err = hold_conv(tag, got, conv_bwd._conv_bwd_reference(x, dy, w),
                        torch.bfloat16)
        again = conv_bwd._conv_bwd_cuda(x, dy, w)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              "%s: conv_bwd's dx or dw differs between two launches" % tag)
        del got, again
        ms = timed_ms(lambda: conv_bwd._conv_bwd_cuda(x, dy, w), CONV_ITERS)
        plain_ms = timed_ms(lambda: conv_bwd._conv_bwd_reference(x, dy, w), 2)
        # cuDNN's pair: the gradient of F.conv2d on the channels-last views
        xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wr = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last).detach().requires_grad_()
        y = F.conv2d(xr, wr, padding=1)
        dyr = dy.permute(0, 3, 1, 2)
        lib_ms = timed_ms(lambda: torch.autograd.grad(
            y, (xr, wr), dyr, retain_graph=True), CONV_ITERS)
        bound_ms, bound_by, nbytes = conv_bound_ms(shape)
        flops = 4.0 * N * H * W * 9 * C * K
        split = kernel_split_us(lambda: conv_bwd._conv_bwd_cuda(x, dy, w))
        rows.append(dict(shape="N%d H%d W%d C%d K%d bf16" % shape,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         tflops=flops / ms / 1e9,
                         share_of_bound=bound_ms / ms, kernels_us=split))
        log("  %s: K4 %.3f ms (%.1f TFLOP/s, %.1f%% of bound; profiler us %s)"
            "  plain %.3f ms  cudnn dgrad+wgrad %.4f ms  bound %.4f ms (%s)"
            % (tag, ms, rows[-1]["tflops"], 100 * rows[-1]["share_of_bound"],
               {k: round(v, 1) for k, v in split.items()}, plain_ms, lib_ms,
               bound_ms, bound_by))
        del x, dy, w, xr, wr, y, dyr
        torch.cuda.empty_cache()

    # the entry point: conv3x3_s1 under autograd.record, then backward
    import incubator_mxnet_tpu_torch as mxt
    x0, dy, w0 = inputs((32, 56, 56, 64, 64), torch.bfloat16)
    want = conv_bwd._conv_bwd_reference(x0, dy, w0)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for _ in range(2):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        with mxt.autograd.record():
            y = conv_bwd.conv3x3_s1(x, w)
        y.backward(dy)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(launches.get("conv_bwd", 0) == 2 and sum(launches.values()) == 2,
          "two conv3x3_s1 backwards launched %s, expected conv_bwd twice"
          % launches)
    hold_conv("conv3x3_s1 backward N32 H56 W56 C64 K64", (x.grad, w.grad),
              want, torch.bfloat16)
    return launches, rows


def _vision_pair(name, seed=5):
    """A small float32 LeNet or ResNet-18 (10 classes) on the CPU, its
    deferred shapes finished by one forward, and its input batch."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    shape = (4, 1, 28, 28) if name == "lenet" else (8, 3, 32, 32)
    rng = onp.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 10, shape[0]).astype("float32"))
    net = models.LeNet() if name == "lenet" else vision.resnet18_v1(
        classes=10)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    net(x)
    return net, x, y


def check_small_vision_against_cpu():
    """Three SGD-momentum TrainSteps of a small fp32 LeNet and ResNet-18 on
    the card (cuDNN, TF32 off) and on the CPU from the same weights."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in ("lenet", "resnet18_v1"):
            runs = {}
            for where in ("cpu", "gpu"):
                net, x, y = _vision_pair(name)
                before = mxt.to_numpy_params(net)
                if where == "gpu":
                    net.to("cuda:0")
                step = mxt.jit.TrainStep(
                    net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                    mxt.gluon.Trainer(net.collect_params(), "sgd", {
                        "learning_rate": 0.01, "momentum": 0.9}))
                losses, params = [], []
                for _ in range(3):
                    losses.append(step(x, y).asnumpy())
                    params.append(mxt.to_numpy_params(net))
                runs[where] = (losses, params)
            # a step's loss depends on the weights before it: for ResNet-18
            # the third step's weights carry the second step's rerouted
            # gradients (ReLU-mask flips), so it is held loosely
            loss_err = []
            for i, (a, b) in enumerate(zip(runs["cpu"][0], runs["gpu"][0])):
                loss_err.append(float(onp.abs(a - b).max()
                                      / onp.abs(a).max()))
                tol = 1e-3 if name == "lenet" or i < 2 else 5e-2
                check(loss_err[-1] <= tol, "small %s: card and CPU losses of "
                      "step %d differ by %.3g of the largest"
                      % (name, i + 1, loss_err[-1]))
            # LeNet: every parameter after every step, against its largest
            # value; ResNet-18: every parameter's change after the first
            # step, against its largest change, then all changes after the
            # last step together in L2 (ReLU-mask flips, see the docstring)
            worst = 0.0
            held = range(3) if name == "lenet" else range(1)
            for i in held:
                cpu, gpu = runs["cpu"][1][i], runs["gpu"][1][i]
                for k in cpu:
                    ref, got = cpu[k], gpu[k]
                    if name != "lenet":
                        ref, got = ref - before[k], got - before[k]
                    rel = float(onp.abs(got - ref).max()
                                / max(onp.abs(ref).max(), 1e-30))
                    worst = max(worst, rel)
                    check(rel <= (1e-4 if name == "lenet" else 1e-3),
                          "small %s: %s differs card vs CPU after step %d by "
                          "%.3g of its largest %s" % (
                              name, k, i + 1, rel,
                              "value" if name == "lenet" else "change"))
            cpu, gpu = runs["cpu"][1][-1], runs["gpu"][1][-1]
            l2 = float(onp.sqrt(
                sum(onp.sum((gpu[k] - cpu[k]) ** 2) for k in cpu)
                / sum(onp.sum((cpu[k] - before[k]) ** 2) for k in cpu)))
            check(l2 <= (2e-2 if name == "lenet" else 5e-2), "small %s: "
                  "parameter changes differ card vs CPU by %.3g in L2"
                  % (name, l2))
            log("small %s fp32 training, card vs CPU: losses %s; rel diff "
                "loss by step %s, params %.3g, L2 of the changes after 3 "
                "steps %.3g" % (
                    name, [round(float(l.mean()), 5) for l in runs["gpu"][0]],
                    ["%.3g" % e for e in loss_err], worst, l2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def check_captured_small():
    """TrainStep's CUDA graphs against its eager body on the card, small
    float32 models (BERT and GPT through K1-K3, ResNet-18 on cuDNN with
    deterministic algorithms: cuDNN's default backward algorithms differ
    run to run), from the same weights, SMALL_CAPTURED_STEPS steps each:
    losses and parameters (running statistics included) equal bit for
    bit. Between steps both runs take the same ``set_data`` (written in
    place, so the graph stays), the same ``set_learning_rate`` and, for
    the captured run, replaced optimizer states (new tensors, so it
    captures again). K1-K3 launch layers x steps times through the
    replays. Then a small BERT with dropout 0.1 at learning rate 0: its
    replays' losses all differ (fresh masks) and are finite."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.gluon.trainer import _clone
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = torch.from_numpy(onp.random.RandomState(2).randint(
        0, 1000, (2, 256)).astype("int32")).cuda()
    summary = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in ("bert", "gpt", "resnet18_v1"):
            runs = {}
            for mode in ("captured", "eager"):
                if kind == "resnet18_v1":
                    model, x, y = _vision_pair(kind)
                    net, loss_fn = model, \
                        mxt.gluon.loss.SoftmaxCrossEntropyLoss()
                    inputs, opt = (x.cuda(), y.cuda()), ("sgd", {
                        "learning_rate": 0.01, "momentum": 0.9})
                else:
                    model, net, loss_fn = _small_pair(kind)
                    inputs, opt = (tokens, tokens), ("adam", {
                        "learning_rate": 1e-3})
                model.to("cuda:0")
                trainer = mxt.gluon.Trainer(net.collect_params(), *opt)
                step = mxt.jit.TrainStep(net, loss_fn, trainer)
                first = list(net.collect_params().values())[0]
                _kernels.reset_launches()
                losses = []
                for i in range(SMALL_CAPTURED_STEPS):
                    if i == 1:
                        first.set_data(first.data()._data * 0.5)
                    if i == 2:
                        trainer.set_learning_rate(
                            trainer.learning_rate * 2)
                        if mode == "captured":
                            trainer._states = [_clone(st) for st in
                                               trainer._states]
                    losses.append(step(*inputs)._data.clone()
                                  if mode == "captured"
                                  else _eager_step(step, *inputs)._data)
                torch.cuda.synchronize()
                runs[mode] = (losses, mxt.to_numpy_params(model),
                              dict(_kernels.LAUNCHES), step.captures)
            (la, pa, launches, captures), (lb, pb, _, _) = \
                runs["captured"], runs["eager"]
            check(all(torch.equal(a, b) for a, b in zip(la, lb)),
                  "small %s: captured losses %s differ from eager %s"
                  % (kind, [a.float().mean().item() for a in la],
                     [b.float().mean().item() for b in lb]))
            bad = [k for k in pa if not onp.array_equal(pa[k], pb[k])]
            check(not bad, "small %s: parameters differ captured vs eager: "
                  "%s" % (kind, bad[:5]))
            check(captures == 2, "small %s: %d captures, expected 2 (the "
                  "replaced states)" % (kind, captures))
            if kind != "resnet18_v1":
                check(all(launches.get(k, 0) == 2 * SMALL_CAPTURED_STEPS
                          for k in ("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq")),
                      "small %s captured: launches %s, expected 2 layers x "
                      "%d steps" % (kind, launches, SMALL_CAPTURED_STEPS))
            summary[kind] = dict(bitwise_equal=True, captures=captures,
                                 launches=launches, losses=[
                                     a.float().mean().item() for a in la])
            log("small %s fp32, captured vs eager body: %d steps with "
                "set_data, set_learning_rate and replaced states between, "
                "losses and parameters%s equal bit for bit; %d captures; "
                "launches %s" % (kind, SMALL_CAPTURED_STEPS,
                                 " and running statistics"
                                 if kind == "resnet18_v1" else "", captures,
                                 launches))
    finally:
        torch.backends.cudnn.deterministic = det

    net = models.BERTModel(vocab_size=1000, units=128, num_layers=2,
                           num_heads=2, max_length=256, attention="flash",
                           hidden_size=512, dropout=0.1)
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                   .Generator(device="cuda:0").manual_seed(1))
    step = mxt.jit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             mxt.gluon.Trainer(net.collect_params(), "sgd",
                                               {"learning_rate": 0.0}))
    losses = [step(tokens, tokens)._data.clone()
              for _ in range(SMALL_CAPTURED_STEPS)]
    means = [l.float().mean().item() for l in losses]
    check(all(math.isfinite(v) for v in means), "dropout bert: a loss is "
          "not finite: %s" % means)
    check(len({tuple(l.tolist()) for l in losses}) == len(losses),
          "dropout bert at lr 0: replays repeat a loss (one mask): %s"
          % means)
    log("small bert, dropout 0.1, lr 0, captured: losses %s, all distinct "
        "(fresh masks each replay)" % ["%.5f" % v for v in means])
    summary["dropout_bert"] = dict(losses=means, distinct=True,
                                   captures=step.captures)
    summary["failed_capture"] = check_failed_capture(tokens)
    return summary


def check_failed_capture(tokens):
    """A step whose loss reads a value back to the host (which a CUDA
    graph cannot hold) raises at its capture, naming the loss's line, and
    runs nothing eagerly in its place; the capture leaves neither its side
    stream current nor the allocator routing to its pool (empty_cache
    gives a freed block back); the card then captures and replays a sound
    step of the same model."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    model, net, base = _small_pair("bert")
    model.to("cuda:0")

    def host_read_loss(out, label):
        loss = base(out, label)
        if float(loss.sum()) < 0:           # a host read inside the step
            loss = -loss
        return loss

    def trainer():
        return mxt.gluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.01})
    step = mxt.jit.TrainStep(net, host_read_loss, trainer())
    try:
        step(tokens, tokens)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and "capturing the step into a CUDA graph "
          "failed" in raised and "host_read_loss" in raised,
          "a step reading the card's values on the host did not fail its "
          "capture by name: %r" % raised)
    check(step.captures == 0, "the failed capture was kept")
    del step
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(torch.cuda.current_stream() == torch.cuda.default_stream(),
          "a failed capture left its side stream current")
    probe = torch.empty(1 << 30, dtype=torch.uint8, device="cuda:0")
    held = torch.cuda.memory_reserved()
    del probe
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_reserved()
    check(freed >= 1 << 30, "after a failed capture the allocator frees "
          "nothing (%d bytes of a 1 GiB block given back)" % freed)
    good = mxt.jit.TrainStep(net, base, trainer())
    losses = [good(tokens, tokens)._data.float().mean().item()
              for _ in range(2)]
    check(good.captures == 1 and all(math.isfinite(v) for v in losses),
          "no sound capture after a failed one: %s" % losses)
    log("failed capture: %s; the allocator then gave back a freed 1 GiB "
        "block, and a sound step captured and replayed, losses %s"
        % (raised.splitlines()[0][:300], losses))
    return dict(message=raised.splitlines()[0][:300], after=losses)


def train_resnet_full_width():
    """ResNet-50 v1 training at full width and depth, through the captured
    TrainStep and its eager body from the same weights
    (``train_captured_and_eager``); returns (launches over the timed
    steps, summary)."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    dev = torch.device("cuda", 0)
    warm, timed = RESNET_STEPS
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(6)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
    net.cast("bfloat16")
    x = torch.randn(RESNET_B, 3, 224, 224, generator=gen, device=dev) \
        .to(torch.bfloat16)
    y = torch.randint(0, 1000, (RESNET_B,), generator=gen, device=dev) \
        .float()
    with mxt.autograd.pause(train_mode=False):
        net(x[:2])                 # finishes the deferred shapes
    setup_s = time.perf_counter() - t0

    def make_trainer():
        return mxt.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "multi_precision": True})

    def extra_check(trainer, losses, launches):
        means = [float(l._data.float().mean()) for l in losses]
        check(all(bool(torch.isfinite(l._data.float()).all())
                  for l in losses),
              "resnet50 training: a loss is not finite: %s" % means)
        check(means[-1] < means[0], "resnet50 training: loss did not fall: "
              "%s" % means)
        check(not any(launches.values()), "resnet50 training launched "
              "hand-written kernels %s; model-zoo convs stay on cuDNN"
              % launches)
        for j, p in enumerate(trainer._params):
            w = p.data()._data
            check(bool(torch.isfinite(w.float()).all()),
                  "resnet50 training: parameter %d is not finite" % j)
            if w.dtype == torch.bfloat16:
                check(torch.equal(w, trainer._states[j][0].to(
                    torch.bfloat16)), "resnet50 training: parameter %d is "
                    "not its fp32 master cast to bf16" % j)
            else:
                check(w.dtype == torch.float32 and p.name in (
                    "gamma", "beta", "running_mean", "running_var"),
                    "resnet50 training: parameter %d (%s) is %s"
                    % (j, p.name, w.dtype))

    launches, row = train_captured_and_eager(
        "resnet50", net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
        make_trainer, (x, y), warm, timed, extra_check)
    n_params = sum(p.data().size for p in net.collect_params().values()
                   if p.grad_req != "null")
    img_s = RESNET_B / (row["step_ms"] / 1e3)
    row.update(batch=[RESNET_B, 3, 224, 224], params=n_params,
               images_per_s=img_s, setup_s=setup_s,
               share_of_989_tflops=img_s * RESNET_FLOPS_PER_IMAGE
               / PEAK_BF16_FLOPS)
    log("training resnet50_v1: %d params, B %d x 3 x 224 x 224 bf16; step "
        "%.1f ms (host %.2f); %.0f img/s; %.2f%% of 989 TFLOP/s at 24.6 "
        "GFLOP/img; peak memory %.2f GB; losses %.4f -> %.4f" % (
            n_params, RESNET_B, row["step_ms"], row["step_host_ms"], img_s,
            100 * row["share_of_989_tflops"], row["peak_memory_gb"],
            row["losses"][0], row["losses"][-1]))
    del net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


# --------------------------------------------------------- the Gluon loop
SWEEP_CASES = {
    "sgd": dict(learning_rate=0.05, momentum=0.9),
    "nag": dict(learning_rate=0.05, momentum=0.9),
    "signum": dict(learning_rate=0.01, wd_lh=0.01),
    "sgld": dict(learning_rate=0.01),
    "dcasgd": dict(learning_rate=0.05, momentum=0.5),
    "adam": dict(learning_rate=0.01),
    "adamw": dict(learning_rate=0.01),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "rmsprop": dict(learning_rate=0.01, clip_weights=1.5),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True),
    "adagrad": dict(learning_rate=0.05),
    "adadelta": dict(rho=0.9),
    "ftrl": dict(learning_rate=0.1),
    "ftml": dict(learning_rate=0.01),
    "lamb": dict(learning_rate=0.01),
    "lars": dict(learning_rate=0.1, momentum=0.9),
    "test": dict(),
}
SWEEP_STEPS = 3
SWEEP_TOL = 1e-6           # of the largest value of each weight
HYBRID_SMALL_STEPS = 6
GLUON_BERT_STEPS, GLUON_BERT_SAVE_AT = 8, 4
GLUON_BERT_AB = 3          # imperative LAMB loop against TrainStep
GLUON_GPT_STEPS = (2, 4)   # (warm-up, timed), hybridized and eager
GLUON_RESNET_BATCHES = 12
LOADER_WORKERS = 4
METRIC_REL_TOL = 1e-6


class _LoopParam:
    """What a callback reads: the epoch, the batch count, the metric."""

    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, eval_metric


def _max_rel(a, b):
    """max |a - b| over the largest |b|."""
    import numpy as onp
    return float(onp.abs(a - b).max()) / max(float(onp.abs(b).max()),
                                              1e-30)


def check_optimizer_sweep():
    """Every registered optimizer (RMSProp in both forms) updates three
    parameters of different shapes (lr_mult and wd_mult on two) from the
    same weights, SWEEP_STEPS steps of the same gradients, three ways: the
    captured TrainStep on the card, the eager Gluon loop (record,
    backward, Trainer.step) on the card, and the same loop on the CPU;
    every weight within SWEEP_TOL of its largest value of the CPU's. The
    net's output is sum(w_i * c_i), so the gradients are the inputs c_i
    exactly on both devices, and only the update's arithmetic is held
    (the gradients of a real net differ in their last bits between the
    devices, which Adam-like updates, g / sqrt(v), carry into the step).
    SGLD's noise is off for this (the card's and the CPU's generators
    differ); then SGLD alone on a Dense net, captured, with a zero
    gradient: each replay's step is fresh noise of variance lr (mean and
    variance within 5 standard errors, no two steps equal)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import autograd, nd
    from incubator_mxnet_tpu_torch import optimizer as topt

    shapes = [(64, 32), (32,), (4, 8, 16)]
    mults = [(1.0, 1.0), (0.5, 2.0), (1.0, 0.0)]
    rng = onp.random.RandomState(12)
    w0 = [rng.randn(*sh).astype("float32") for sh in shapes]
    grads = [[rng.randn(*sh).astype("float32") * 2 for sh in shapes]
             for _ in range(SWEEP_STEPS)]

    class Exact(mxt.gluon.HybridBlock):
        def __init__(self, ctx):
            super().__init__()
            for i, (sh, (lm, wm)) in enumerate(zip(shapes, mults)):
                p = mxt.gluon.Parameter("w%d" % i, shape=sh, lr_mult=lm,
                                        wd_mult=wm)
                p.initialize(ctx=ctx)
                p.set_data(w0[i])
                setattr(self, "w%d" % i, p)

        def forward(self, *cs):
            return sum((getattr(self, "w%d" % i)._tensor() * c).sum()
                       for i, c in enumerate(cs)).reshape(1)

    rows = {}
    noise = topt.SGLD._noise
    topt.SGLD._noise = lambda self, ws: [torch.zeros_like(w) for w in ws]
    try:
        for case, kw in SWEEP_CASES.items():
            name = "rmsprop" if case.startswith("rmsprop") else case
            kw = dict(kw, wd=0.01, clip_gradient=2.5)
            got = {}
            for mode in ("captured", "eager", "cpu"):
                ctx = mxt.cpu() if mode == "cpu" else mxt.gpu(0)
                net = Exact(ctx)
                trainer = mxt.gluon.Trainer(net.collect_params(), name,
                                            dict(kw))
                if mode == "captured":
                    step = mxt.jit.TrainStep(net, lambda out: out, trainer)
                    for gs in grads:
                        step(*[torch.from_numpy(g).cuda() for g in gs],
                             batch_size=4, n_net_inputs=len(gs))
                    check(step.captures == 1, "sweep %s: %d captures"
                          % (case, step.captures))
                else:
                    for gs in grads:
                        with autograd.record():
                            out = net(*[nd.array(g, ctx=ctx) for g in gs])
                        out.backward()
                        trainer.step(4)
                got[mode] = [p.data().asnumpy() for p in
                             net.collect_params().values()]
            ref = got["cpu"]
            check(all(not onp.array_equal(r, w) for r, w in zip(ref, w0)),
                  "sweep %s: the weights did not move" % case)
            errs = {m: max(_max_rel(a, b) for a, b in zip(got[m], ref))
                    for m in ("captured", "eager")}
            check(max(errs.values()) <= SWEEP_TOL, "sweep %s: card against "
                  "CPU %s of the largest weight (tolerance %g)"
                  % (case, errs, SWEEP_TOL))
            rows[case] = errs
    finally:
        topt.SGLD._noise = noise

    def net_on(ctx, units, in_units):
        net = mxt.gluon.nn.HybridSequential()
        net.add(mxt.gluon.nn.Dense(units, activation="relu",
                                   in_units=in_units),
                mxt.gluon.nn.Dense(8, in_units=units))
        net.initialize(mxt.init.Xavier(), ctx=ctx,
                       generator=torch.Generator().manual_seed(3))
        return net

    lr = 0.25
    net = net_on(mxt.gpu(0), units=256, in_units=256)
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgld",
                                {"learning_rate": lr})
    step = mxt.jit.TrainStep(net, lambda out, label: out.sum(dim=1) * 0,
                             trainer)
    xd = torch.randn(4, 256, device="cuda:0")

    def flat():
        return torch.cat([p.data()._data.detach().flatten()
                          for p in net.collect_params().values()])
    before = flat()
    deltas = []
    for _ in range(4):
        step(xd, xd[:, 0])
        now = flat()
        deltas.append((now - before) / math.sqrt(lr))
        before = now
    n = deltas[0].numel()
    moments = [(float(d.mean()), float(d.var())) for d in deltas]
    check(step.captures == 1 and all(
        abs(m) < 5 / math.sqrt(n) and abs(v - 1) < 5 * math.sqrt(2.0 / n)
        for m, v in moments), "sgld captured: step noise moments %s over "
        "%d values, expected N(0, 1)" % (moments, n))
    check(len({tuple(d[:8].tolist()) for d in deltas}) == len(deltas),
          "sgld captured: a replay repeated its noise")
    log("optimizer sweep: %d optimizers, %d steps each on a small fp32 MLP, "
        "captured TrainStep and eager Trainer.step on the card against "
        "the CPU: worst %.3g of the largest weight; SGLD captured noise "
        "moments %s" % (len(rows), SWEEP_STEPS, max(
            max(r.values()) for r in rows.values()), moments))
    return dict(rel_to_cpu=rows, sgld_noise_moments=moments,
                update_ops_held=check_update_ops())


def _loop_round(net, loss_fn, x, y):
    """One record / loss / backward round; returns the loss tensor."""
    from incubator_mxnet_tpu_torch import autograd
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)          # seeded with ones, as loss.backward()
    return loss._data.detach() if hasattr(loss, "_data") else \
        loss.detach()


def check_hybridized_small():
    """A hybridized small fp32 BERT, GPT (K1-K3) and ResNet-18 (cuDNN
    deterministic) in the Gluon loop (record, loss, backward,
    Trainer.step) against the same loop without hybridize from the same
    weights, HYBRID_SMALL_STEPS steps: losses and parameters (running
    statistics included) equal bit for bit. A signature runs eagerly at
    its first call and is captured at its second; before step 3 both runs
    take a set_data (the hybridized block captures again), steps 4 and 5
    take half the batch (a second signature: eager, then captured), step
    6 the whole batch again (a replay): 3 captures. K1-K3 launch layers x
    steps times in the hybridized run, through the replays."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = torch.from_numpy(onp.random.RandomState(2).randint(
        0, 1000, (2, 256)).astype("int32")).cuda()
    summary = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in ("bert", "gpt", "resnet18_v1"):
            runs = {}
            for mode in ("hybridized", "eager"):
                if kind == "resnet18_v1":
                    model, x, y = _vision_pair(kind)
                    net, loss_fn = model, \
                        mxt.gluon.loss.SoftmaxCrossEntropyLoss()
                    x, y = x.cuda(), y.cuda()
                    opt = ("sgd", {"learning_rate": 0.01, "momentum": 0.9})
                else:
                    model, net, loss_fn = _small_pair(kind)
                    x = y = tokens
                    opt = ("adam", {"learning_rate": 1e-3})
                model.to("cuda:0")
                if mode == "hybridized":
                    net.hybridize()
                trainer = mxt.gluon.Trainer(net.collect_params(), *opt)
                first = list(net.collect_params().values())[0]
                _kernels.reset_launches()
                losses = []
                for i in range(HYBRID_SMALL_STEPS):
                    if i == 2:
                        first.set_data(first.data()._data * 0.5)
                    xs, ys = (x[:x.shape[0] // 2], y[:y.shape[0] // 2]) \
                        if i in (3, 4) else (x, y)
                    losses.append(_loop_round(net, loss_fn, xs, ys).clone())
                    trainer.step(xs.shape[0])
                torch.cuda.synchronize()
                runs[mode] = (losses, mxt.to_numpy_params(model),
                              dict(_kernels.LAUNCHES), net._captures)
            (la, pa, launches, captures), (lb, pb, _, _) = \
                runs["hybridized"], runs["eager"]
            check(all(torch.equal(a, b) for a, b in zip(la, lb)),
                  "hybridized small %s: losses %s differ from eager %s"
                  % (kind, [a.float().mean().item() for a in la],
                     [b.float().mean().item() for b in lb]))
            bad = [k for k in pa if not onp.array_equal(pa[k], pb[k])]
            check(not bad, "hybridized small %s: parameters differ from "
                  "eager: %s" % (kind, bad[:5]))
            check(captures == 3, "hybridized small %s: %d captures, "
                  "expected 3 (first signature, set_data, second batch "
                  "size)" % (kind, captures))
            if kind != "resnet18_v1":
                check(all(launches.get(k, 0) == 2 * HYBRID_SMALL_STEPS
                          for k in ("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq")),
                      "hybridized small %s: launches %s, expected 2 layers "
                      "x %d steps" % (kind, launches, HYBRID_SMALL_STEPS))
            summary[kind] = dict(bitwise_equal=True, captures=captures,
                                 launches=launches, losses=[
                                     a.float().mean().item() for a in la])
            log("hybridized small %s fp32 against eager, %d Gluon-loop "
                "steps with set_data and a second batch size between: "
                "losses and parameters equal bit for bit; %d captures; "
                "launches %s" % (kind, HYBRID_SMALL_STEPS, captures,
                                 launches))
    finally:
        torch.backends.cudnn.deterministic = det
    return summary


def _device_metrics_against_host(out, labels):
    """Perplexity (of softmax(out)) and Accuracy (argmax over the last
    axis) computed on the card, and the same from host copies with the
    JAX package's numpy arithmetic; both within METRIC_REL_TOL."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch import metric, nd
    probs = nd.softmax(out, axis=-1)
    ppl, acc = metric.Perplexity(), metric.Accuracy(axis=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppl.update([labels], [probs])
    acc.update([labels], [out])
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    card = (ppl.get()[1], acc.get()[1])
    check(isinstance(ppl.sum_metric, torch.Tensor)
          and ppl.sum_metric.device.type == "cuda",
          "Perplexity kept its sum on the host")
    lab = labels.asnumpy().astype("int32").flatten()
    p = probs.asnumpy()
    picked = p.reshape(-1, p.shape[-1])[onp.arange(lab.size), lab]
    del p
    host_ppl = math.exp(-float(onp.log(onp.maximum(
        picked.astype("float64"), 1e-10)).sum()) / lab.size)
    logits = out.asnumpy()
    host_acc = float((logits.argmax(axis=-1).astype("int32").flatten()
                      == lab).sum()) / lab.size
    del logits
    rel = (abs(card[0] - host_ppl) / host_ppl,
           abs(card[1] - host_acc) / max(host_acc, 1e-30))
    check(max(rel) <= METRIC_REL_TOL, "metrics on the card %s against the "
          "host %s: %s relative" % (card, (host_ppl, host_acc), rel))
    return dict(perplexity=card[0], accuracy=card[1],
                host_perplexity=host_ppl, host_accuracy=host_acc,
                rel_diff=rel, update_ms=update_ms)


def _bert_loop(model, loss_fn, trainer, batches, clip, speed=None,
               start=0):
    """The Gluon loop over ``batches``: record, loss, backward,
    (clip_global_norm), Trainer.step, the Speedometer. Returns [(loss
    tensor, device ms, host ms)] of each step."""
    from incubator_mxnet_tpu_torch import autograd, gluon
    params = [p for p in model.collect_params().values()
              if p.grad_req != "null"]
    out = []
    for i, (x, y) in enumerate(batches):
        def one(x=x, y=y):
            with autograd.record():
                loss = loss_fn(model(x), y)
            loss.backward()
            if clip:
                gluon.utils.clip_global_norm([p.grad() for p in params], 1.0)
            trainer.step(x.shape[0])
            return loss._data.detach()
        out.append(_timed_step(one))
        if speed is not None:
            speed(_LoopParam(0, start + i, None))
    return out


def train_bert_lamb(tmp):
    """Full-width BERT (B 64 x S 512, bf16) pre-training as the LAMB paper
    runs it, through the Gluon loop: a seeded ArrayDataset of token ids
    drawn from the first 1024 ids (labels the same ids; every batch
    differs) -> DataLoader(num_workers=2, pin_memory=True) ->
    the hybridized BERTModel under record() -> SoftmaxCrossEntropyLoss ->
    backward -> clip_global_norm(1.0) -> Trainer("lamb", wd 0.01, fp32
    masters, PolyScheduler with warm-up) -> the Speedometer; Perplexity
    and Accuracy on the card held to a host computation of one batch.
    save_parameters and save_states after step GLUON_BERT_SAVE_AT; the
    same model loads them back (load_parameters captures again), a fresh
    Trainer and scheduler load_states, and the remaining steps' losses
    must equal the uninterrupted run's bit for bit. Then, clip off,
    GLUON_BERT_AB steps of the loop against TrainStep with the same
    optimizer from the same weights and batch: losses bit for bit or
    within 1e-3 (PR 7's gate). Last, the LAMB and Adam updates of this
    model (device ms, device activities). Returns (K1-K3 launches of the
    loop's first GLUON_BERT_SAVE_AT steps, summary)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import callback, gluon, lr_scheduler
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.gluon import data as gdata
    from incubator_mxnet_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    B, S, n = BERT_TRAIN_B, BERT_S, GLUON_BERT_STEPS
    t0 = time.perf_counter()
    model = models.BERTModel(**BERT)
    model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                     generator=torch.Generator(device=dev).manual_seed(17))
    model.cast("bfloat16")
    init_file = os.path.join(tmp, "bert_lamb_init.params")
    model.save_parameters(init_file)
    # ids from the first 1024 of the vocabulary: a signal a few steps can
    # learn (which ids occur) on batches that all differ
    tokens = onp.random.RandomState(18).randint(
        0, 1024, (B * n, S)).astype("int32")
    dataset = gdata.ArrayDataset(tokens, tokens)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    setup_s = time.perf_counter() - t0

    def trainer():
        return gluon.Trainer(model.collect_params(), "lamb", {
            "learning_rate": 5e-3, "wd": 0.01, "multi_precision": True,
            "lr_scheduler": lr_scheduler.PolyScheduler(
                max_update=20, base_lr=5e-3, pwr=1, warmup_steps=2,
                warmup_begin_lr=1e-3)})

    def loader(start=0):
        return gdata.DataLoader(dataset, batch_size=B, num_workers=2,
                                pin_memory=True, sampler=gdata.
                                SequentialSampler(B * (n - start),
                                                  B * start))

    # -- the uninterrupted run, saving after step GLUON_BERT_SAVE_AT
    k = GLUON_BERT_SAVE_AT
    model.hybridize()
    tr = trainer()
    speed = callback.Speedometer(B, frequent=2)
    _kernels.reset_launches()
    first = _bert_loop(model, loss_fn, tr, itertools.islice(loader(), k),
                       True, speed)
    launches = dict(_kernels.LAUNCHES)
    mid_params = os.path.join(tmp, "bert_lamb_mid.params")
    mid_states = os.path.join(tmp, "bert_lamb_mid.states")
    t1 = time.perf_counter()
    model.save_parameters(mid_params)
    tr.save_states(mid_states)
    save_s = time.perf_counter() - t1
    rest = _bert_loop(model, loss_fn, tr, loader(k), True, speed, start=k)
    run = first + rest
    means = [float(l.float().mean()) for l, _, _ in run]
    check(all(math.isfinite(v) for v in means) and means[-1] < means[0],
          "bert lamb loop: losses not finite or not falling: %s" % means)
    for kname in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches.get(kname, 0) == BERT["num_layers"] * k,
              "bert lamb loop: %s launched %d times in %d steps, expected "
              "%d layers x %d" % (kname, launches.get(kname, 0), k,
                                  BERT["num_layers"], k))
    for j, p in enumerate(tr._params):
        w = p.data()._data
        check(bool(torch.isfinite(w.float()).all()) and torch.equal(
            w, tr._states[j][0].to(torch.bfloat16)), "bert lamb loop: "
            "parameter %d is not finite or not its master cast" % j)
    captures = model._captures
    check(captures == 1, "bert lamb loop: %d captures of one signature"
          % captures)
    x_last, y_last = next(iter(gdata.DataLoader(
        dataset, batch_size=B, sampler=gdata.SequentialSampler(B))))
    with mxt.autograd.predict_mode():
        out = model(x_last)
    metrics = _device_metrics_against_host(out, y_last)
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- resumed from step k
    t1 = time.perf_counter()
    model.load_parameters(mid_params)
    tr = trainer()
    tr.load_states(mid_states)
    load_s = time.perf_counter() - t1
    before = model._captures
    resumed = _bert_loop(model, loss_fn, tr, loader(k), True)
    bitwise_resume = len(resumed) == n - k and all(
        torch.equal(a[0], b[0]) for a, b in zip(rest, resumed))
    check(bitwise_resume, "bert lamb: the resumed run's losses %s differ "
          "from the uninterrupted run's %s" % (
              [float(l.float().mean()) for l, _, _ in resumed], means[k:]))
    check(model._captures == before + 1, "bert lamb: load_parameters did "
          "not capture again (%d -> %d)" % (before, model._captures))
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- the imperative loop (clip off) against TrainStep
    batch = torch.from_numpy(tokens[:B]).to(dev)
    model.load_parameters(init_file)
    tr = trainer()
    step = mxt.jit.TrainStep(model, loss_fn, tr)
    ref = [_timed_step(lambda: step(batch, batch)._data)
           for _ in range(GLUON_BERT_AB)]
    del step, tr
    gc.collect()
    torch.cuda.empty_cache()
    model.load_parameters(init_file)
    tr = trainer()
    same = [(mxt.nd.NDArray(batch), mxt.nd.NDArray(batch))] * GLUON_BERT_AB
    got = _bert_loop(model, loss_fn, tr, same, False)
    bitwise, worst = True, 0.0
    for (a, _, _), (b, _, _) in zip(ref, got):
        bitwise &= bool(torch.equal(a, b))
        worst = max(worst, float(((a.float() - b.float()).abs()
                                  / a.float().abs()).max()))
    check(bitwise or worst <= 1e-3, "bert lamb: the loop's losses differ "
          "from TrainStep's by %.3g relative" % worst)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- the LAMB update against Adam's on this model (eager body)
    model.hybridize(False)
    update = {}
    for name in ("lamb", "adam"):
        model.load_parameters(init_file)
        tr = gluon.Trainer(model.collect_params(), name, {
            "learning_rate": 1e-4, "multi_precision": True})
        step = mxt.jit.TrainStep(model, loss_fn, tr)
        _eager_step(step, batch, batch)
        phases = step_phases(step, batch, batch)
        args = step._prepare((batch, batch), 1)
        grads = step._backward(step._forward(args, 1))
        update[name] = dict(update_ms=phases["update_ms"],
                            device_activities=kernels_in(
                                lambda: step._update(B, grads)))
        del step, tr, args, grads, phases
        gc.collect()
        torch.cuda.empty_cache()
    ms = [r[1] for r in run[1:]]
    summary = dict(
        batch=[B, S], steps=n, saved_after=k, setup_s=setup_s,
        losses=means, step_ms=sum(ms) / len(ms),
        step_host_ms=sum(r[2] for r in run[1:]) / len(ms),
        step_ms_each=[r[1] for r in run],
        speedometer_samples_per_s=speed.last_speed, captures=captures,
        launches=launches, save_states_and_params_s=save_s, load_s=load_s,
        state_file_gb=os.path.getsize(mid_states) / 1e9,
        resumed_losses_bitwise_equal=bitwise_resume,
        imperative_vs_train_step=dict(
            steps=GLUON_BERT_AB, bitwise_equal=bitwise, max_rel_diff=worst,
            loop_ms=[g[1] for g in got], train_step_ms=[r[1] for r in ref]),
        metrics=metrics, update=update)
    log("gluon loop bert B %d x S %d (DataLoader 2 threads, pinned; "
        "hybridized; LAMB + PolyScheduler; clip_global_norm): step %.1f ms "
        "(host %.1f), Speedometer %.0f samples/s, losses %s; resumed from "
        "step %d bit for bit (states %.2f GB, save %.1f s, load %.1f s); "
        "loop vs TrainStep %s (max rel %.3g); perplexity %.2f accuracy "
        "%.5f on the card = host within %s; update LAMB %.1f ms / %d "
        "activities, Adam %.1f ms / %d" % (
            B, S, summary["step_ms"], summary["step_host_ms"],
            speed.last_speed or 0.0, ["%.4f" % v for v in means], k,
            summary["state_file_gb"], save_s, load_s,
            "bit for bit" if bitwise else "within 1e-3", worst,
            metrics["perplexity"], metrics["accuracy"], metrics["rel_diff"],
            update["lamb"]["update_ms"],
            update["lamb"]["device_activities"],
            update["adam"]["update_ms"],
            update["adam"]["device_activities"]))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def train_gpt_hybridized():
    """Full-width GPT (B 1 x S 8192, bf16, Adam with fp32 masters) through
    the Gluon loop — record, FeaturesView(model), ChunkedLMLoss, backward,
    Trainer.step — hybridized (forward and backward graphs) and not, from
    the same weights: GLUON_GPT_STEPS warm-up and timed steps each, then
    PROFILED_STEPS under the profiler (idle share) and 3 issued on an idle
    card. Step EAGER_STEPS's loss of the two runs within CAPTURE_REL_TOL
    relative; K1-K3 launched layers x steps times over the hybridized
    timed steps. Returns (those launches, summary)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    model = models.GPTModel(**GPT)
    model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                     generator=torch.Generator(device=dev).manual_seed(21))
    model.cast("bfloat16")
    net, loss_fn = models.FeaturesView(model), models.ChunkedLMLoss(model)
    params = list(net.collect_params().values())
    init = [p._tensor().detach().clone() for p in params]
    tokens = mxt.nd.array(onp.random.RandomState(22).randint(
        0, GPT["vocab_size"], (GPT_TRAIN_B, GPT_S)).astype("int32"),
        ctx=mxt.gpu(0))
    warm, timed = GLUON_GPT_STEPS
    rows = {}
    for mode in ("hybridized", "eager"):
        _reset(params, init)
        net.hybridize(mode == "hybridized")
        trainer = mxt.gluon.Trainer(net.collect_params(), "adam", {
            "learning_rate": 1e-4, "multi_precision": True})

        def one():
            loss = _loop_round(net, loss_fn, tokens, tokens)
            trainer.step(GPT_TRAIN_B)
            return loss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [one() for _ in range(warm)]
        _kernels.reset_launches()
        got, ms, host_ms = _timed_steps(one, timed)
        launches = dict(_kernels.LAUNCHES)
        losses += got
        profiled = device_idle_share(one)
        # the profiler's window also holds its own cost, which the
        # replays' steps show more of: the device's busy time over the
        # timed steps' own time is the second reading
        rows[mode] = dict(
            step_ms=ms, step_host_ms=host_ms, issue_ms=issue_ms(one),
            idle_share=profiled["idle_share"], profiled=profiled,
            idle_share_of_timed_step=1.0 - profiled["busy_ms"]
            / PROFILED_STEPS / ms,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=[float(l.float().mean()) for l in losses],
            launches=launches, captures=net._captures)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    hyb, eag = rows["hybridized"], rows["eager"]
    i = EAGER_STEPS - 1
    rel = abs(hyb["losses"][i] - eag["losses"][i]) / abs(eag["losses"][i])
    check(all(math.isfinite(v) for v in hyb["losses"] + eag["losses"])
          and hyb["losses"][-1] < hyb["losses"][0],
          "gpt gluon loop: losses not finite or not falling: %s"
          % hyb["losses"])
    check(rel <= CAPTURE_REL_TOL, "gpt gluon loop: step %d's loss "
          "hybridized %.6f against eager %.6f (%.3g relative)"
          % (i + 1, hyb["losses"][i], eag["losses"][i], rel))
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(hyb["launches"].get(k, 0) == GPT["num_layers"] * timed,
              "gpt gluon loop hybridized: %s launched %d times in %d steps, "
              "expected %d layers x %d" % (k, hyb["launches"].get(k, 0),
                                           timed, GPT["num_layers"], timed))
    check(hyb["captures"] == 1, "gpt gluon loop: %d captures of one "
          "signature" % hyb["captures"])
    log("gluon loop gpt S %d: hybridized step %.1f ms (host %.2f, issue "
        "%.2f), idle %.1f%% profiled / %.1f%% of the timed step, peak %.2f "
        "GB; eager %.1f ms (host %.2f, issue %.2f), idle %.1f%% / %.1f%%, "
        "peak %.2f GB; step-%d loss %.3g relative apart"
        % (GPT_S, hyb["step_ms"], hyb["step_host_ms"], hyb["issue_ms"],
           100 * hyb["idle_share"], 100 * hyb["idle_share_of_timed_step"],
           hyb["peak_memory_gb"], eag["step_ms"], eag["step_host_ms"],
           eag["issue_ms"], 100 * eag["idle_share"],
           100 * eag["idle_share_of_timed_step"], eag["peak_memory_gb"],
           i + 1, rel))
    net.hybridize(False)
    del model, net, loss_fn, init, tokens, params
    gc.collect()
    torch.cuda.empty_cache()
    return hyb["launches"], dict(hybridized=hyb, eager=eag,
                                 rel_loss_diff=rel,
                                 batch=[GPT_TRAIN_B, GPT_S])


def train_resnet_loader():
    """ResNet-50 v1 (B 256 bf16) fed by the Gluon data pipeline: a seeded
    ArrayDataset of uint8 224 x 224 x 3 images and labels ->
    transform_first(Compose([RandomFlipLeftRight(), ToTensor(),
    Normalize(mean, std)])) -> DataLoader(shuffle, LOADER_WORKERS thread
    workers, pin_memory) -> TrainStep with "nag" (momentum 0.9, fp32
    masters) under a CosineScheduler with warm-up. The loader's img/s
    alone (one epoch, nothing else running), the same TrainStep fed one
    batch already on the card (after its capture), and the loop's img/s
    (an epoch, the loader started inside the timed window, host clock to
    a final synchronise); then Accuracy and
    TopKAccuracy(5) of an EvalStep forward on the card, held to a host
    computation. Every loss finite."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import lr_scheduler, metric
    from incubator_mxnet_tpu_torch.gluon import data as gdata
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    dev = torch.device("cuda", 0)
    B, nb = RESNET_B, GLUON_RESNET_BATCHES
    rng = onp.random.RandomState(31)
    t0 = time.perf_counter()
    images = rng.randint(0, 256, (B * nb, 224, 224, 3), dtype=onp.uint8)
    labels = rng.randint(0, 1000, B * nb).astype("float32")
    tf = gdata.transforms
    dataset = gdata.ArrayDataset(images, labels).transform_first(
        tf.Compose([tf.RandomFlipLeftRight(), tf.ToTensor(),
                    tf.Normalize((0.485, 0.456, 0.406),
                                 (0.229, 0.224, 0.225))]))
    data_s = time.perf_counter() - t0

    def loader():
        return gdata.DataLoader(dataset, batch_size=B, shuffle=True,
                                num_workers=LOADER_WORKERS, pin_memory=True,
                                last_batch="discard")
    onp.random.seed(32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = 0
    for x, y in loader():
        count += x.shape[0]
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    check(count == B * nb and x.context == mxt.gpu(0)
          and x.shape == (B, 3, 224, 224) and x.dtype == "float32",
          "resnet loader: %d images, last batch %s on %s"
          % (count, x.shape, x.context))
    loader_img_s = count / loader_s

    gen = torch.Generator(device=dev).manual_seed(33)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
    net.cast("bfloat16")
    with mxt.autograd.pause(train_mode=False):
        net(torch.zeros(2, 3, 224, 224, dtype=torch.bfloat16, device=dev))
    trainer = mxt.gluon.Trainer(net.collect_params(), "nag", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True, "lr_scheduler":
        lr_scheduler.CosineScheduler(max_update=100, base_lr=0.1,
                                     warmup_steps=2, warmup_begin_lr=0.01)})
    step = mxt.jit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             trainer)
    xd, yd = x.astype("bfloat16"), y
    first = [step(xd, yd)]            # the eager step and the capture
    _, fed_ms, _ = _timed_steps(lambda: step(xd, yd), 3)
    onp.random.seed(34)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in loader():
        losses.append(step(x.astype("bfloat16"), y))
    torch.cuda.synchronize()
    loop_img_s = B * len(losses) / (time.perf_counter() - t0)
    means = [float(l._data.float().mean()) for l in first + losses]
    check(all(math.isfinite(v) for v in means), "resnet loop: a loss is not "
          "finite: %s" % means)
    check(step.captures == 1, "resnet loop: %d captures" % step.captures)
    out = mxt.jit.EvalStep(net)(xd)
    acc, top5 = metric.Accuracy(), metric.TopKAccuracy(5)
    acc.update([yd], [out])
    top5.update([yd], [out])
    logits = out.asnumpy()
    lab = yd.asnumpy().astype("int32")
    host_acc = float((logits.argmax(axis=1) == lab).mean())
    # top-5 with ties at the fifth value counted either way: the card's
    # topk and a host partition may break a tie differently
    mine = logits[onp.arange(lab.size), lab][:, None]
    host_top5 = (float(((logits > mine).sum(axis=1) < 5).mean()),
                 float(((logits >= mine).sum(axis=1) <= 5).mean()))
    card_top5 = top5.get()[1]
    check(abs(acc.get()[1] - host_acc) <= METRIC_REL_TOL
          and min(host_top5) - METRIC_REL_TOL <= card_top5
          <= max(host_top5) + METRIC_REL_TOL,
          "resnet metrics on the card %s against the host %s"
          % ((acc.get()[1], card_top5), (host_acc, host_top5)))
    summary = dict(
        batch=[B, 3, 224, 224], batches=nb, workers=LOADER_WORKERS,
        data_setup_s=data_s, loader_images_per_s=loader_img_s,
        loop_images_per_s=loop_img_s, fed_step_ms=fed_ms,
        fed_images_per_s=B / (fed_ms / 1e3), losses=means,
        accuracy=acc.get()[1], top5=top5.get()[1],
        host_accuracy=host_acc, host_top5=host_top5)
    log("gluon loop resnet50 B %d: loader alone %.0f img/s (%d thread "
        "workers, pinned); loop with TrainStep nag + CosineScheduler %.0f "
        "img/s; the same TrainStep fed from the card %.1f ms (%.0f img/s); "
        "losses %s; accuracy %.4f top-5 %.4f (= host)" % (
            B, loader_img_s, LOADER_WORKERS, loop_img_s, fed_ms,
            summary["fed_images_per_s"], ["%.4f" % v for v in means],
            acc.get()[1], top5.get()[1]))
    del step, trainer, net, x, y, xd, yd, out, dataset, images
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def gluon_loop(card):
    """The Gluon training loop on the card: the optimizer sweep, hybridized
    small models against eager, full-width BERT with LAMB, GPT hybridized
    and ResNet-50 fed by the DataLoader. Returns (K1-K3 launches by path,
    summary)."""
    import shutil
    import torch
    tmp = _build_tmp()
    try:
        summary = dict(card=card, optimizers=check_optimizer_sweep(),
                       hybridized_small=check_hybridized_small())
        bert_launches, summary["bert"] = train_bert_lamb(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    gpt_launches, summary["gpt"] = train_gpt_hybridized()
    summary["resnet50"] = train_resnet_loader()
    from incubator_mxnet_tpu_torch import config
    bound = config.get_env("MXTPU_EXEC_CACHE_SIZE")
    captures = {"small_" + k: v["captures"]
                for k, v in summary["hybridized_small"].items()}
    captures.update(bert_lamb=summary["bert"]["captures"],
                    gpt=summary["gpt"]["hybridized"]["captures"])
    check(all(c < bound for c in captures.values()), "a hybridized block "
          "captured as many graphs as MXTPU_EXEC_CACHE_SIZE (%d): %s"
          % (bound, captures))
    summary["hybridized_captures"] = dict(captures, exec_cache_size=bound)
    log("hybridized blocks' captures %s, each under MXTPU_EXEC_CACHE_SIZE "
        "%d" % (captures, bound))
    return {"gluon_bert": bert_launches, "gluon_gpt": gpt_launches}, summary


# ---------------------------------------------------------------- LSTM LM

def lm_token_stream(n_tokens, used, seed):
    """A seeded token stream a language model can learn, over the ids
    below ``used``: each token is followed by its first successor in a
    fixed random table (4 successors a token) 60 % of the time, by one of
    the four 30 %, by any of the ids 10 %."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    succ = rng.randint(0, used, (used, 4))
    r = rng.rand(n_tokens)
    k = rng.randint(0, 4, n_tokens)
    u = rng.randint(0, used, n_tokens)
    out = onp.empty(n_tokens, "int32")
    t = int(rng.randint(used))
    for i in range(n_tokens):
        out[i] = t
        t = int(u[i]) if r[i] < 0.1 else int(succ[t, 0 if r[i] < 0.7
                                                 else k[i]])
    return out


def lm_batches(n_batches, used, seed, bptt=LM_BPTT, batch=LM_BATCH):
    """``n_batches`` (data, target) pairs of (bptt, batch) int32 tokens cut
    from ``batch`` parallel streams (``lm_token_stream`` over the ids below
    ``used``), as the word-LM example batchifies: the target is the data
    one token on."""
    stream = lm_token_stream(n_batches * bptt * batch + batch, used, seed)
    cols = stream[:(n_batches * bptt + 1) * batch].reshape(batch, -1).T
    return [(cols[i * bptt:(i + 1) * bptt], cols[i * bptt + 1:
                                                  (i + 1) * bptt + 1])
            for i in range(n_batches)]


def _lm_loop_round(model, loss_fn, trainer, params, x, y, hidden, vocab):
    """One step of the word-LM Gluon loop: states detached, record → model
    → SoftmaxCrossEntropyLoss over every token → backward →
    clip_global_norm(LM_CLIP · batch) → Trainer.step(batch) (the gradient
    of the per-sequence sum over BPTT steps, averaged over the batch,
    clipped at LM_CLIP, as Zaremba et al. train). Returns (the loss tensor,
    the new states)."""
    import incubator_mxnet_tpu_torch as mxt
    hidden = [h.detach() for h in hidden]
    with mxt.autograd.record():
        out, hidden = model(x, hidden)
        loss = loss_fn(out.reshape((-1, vocab)), y.reshape((-1,)))
    loss.backward()
    n = x.shape[1]
    mxt.gluon.utils.clip_global_norm([p.grad() for p in params], LM_CLIP * n)
    trainer.step(n)
    return loss._data.detach(), hidden


def _lm_clip(max_norm):
    """TrainStep's grad_postprocess: the gradients scaled on the card so
    their joint norm is at most ``max_norm`` (no host read)."""
    import torch

    def clip(grads):
        norm = torch.stack(torch._foreach_norm(grads)).norm()
        return torch._foreach_mul(grads, (max_norm / (norm + 1e-8))
                                  .clamp(max=1.0))
    return clip


def _lm_step(model, lr, vocab, batch=LM_BATCH):
    """jit.TrainStep over the LSTM LM with n_net_inputs = 3 (tokens, h0,
    c0): loss on the logits, SGD at ``lr``, the clip on the card."""
    import incubator_mxnet_tpu_torch as mxt
    ce = mxt.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, y):
        return ce(out[0].reshape((-1, vocab)), y.reshape((-1,)))
    trainer = mxt.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": lr})
    return mxt.jit.TrainStep(model, loss_fn, trainer, batch_axis=1,
                             grad_postprocess=_lm_clip(LM_CLIP * batch))


def _seed_all(seed):
    """The card's two generators: torch's (nd.Dropout) and nd.random's (the
    RNN's inter-layer masks)."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    torch.cuda.manual_seed(seed)
    mxt.random.seed(seed)


def check_lstm_lm_small():
    """The LSTM LM at a small width (vocab 200, 32 / 32, 2 layers) on the
    card, TF32 off and cuDNN deterministic: (a) dropout off, the card
    (cuDNN's RNN) against the CPU from the same weights: the first
    forward's logits and states and the gradients of its loss within
    LM_SMALL_TOL of their largest value, then the weights after 3 Gluon
    loop steps (SGD, the clip) within LM_SMALL_TOL; (b) dropout 0.5 from
    one seed, the hybridized model against the plain one in the Gluon
    loop, 4 steps (eager, capture + replay, replays): losses and weights
    bit for bit, one capture; (c) two replays on the same batch with the
    weights fixed give different logits (fresh masks). Returns a
    summary."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    vocab = LM_SMALL["vocab_size"]
    batches = lm_batches(4, vocab, 41, bptt=12, batch=6)
    out = {}
    try:
        def build(ctx, dropout, weights=None):
            model = models.LSTMLanguageModel(dropout=dropout, **LM_SMALL)
            model.initialize(mxt.init.Uniform(0.1), ctx=ctx,
                             generator=torch.Generator().manual_seed(5)
                             if ctx.device_type == "cpu" else
                             torch.Generator(device="cuda").manual_seed(5))
            if weights is not None:
                mxt.from_jax_params(model, weights)
            return model

        def rounds(model, ctx, steps, lr=0.5):
            params = list(model.collect_params().values())
            trainer = mxt.gluon.Trainer(model.collect_params(), "sgd",
                                        {"learning_rate": lr})
            loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
            with ctx:
                hidden = model.begin_state(6)
            got = []
            for i in range(steps):
                x, y = (mxt.nd.array(a, ctx=ctx, dtype="int32")
                        for a in batches[i % len(batches)])
                loss, hidden = _lm_loop_round(model, loss_fn, trainer,
                                              params, x, y, hidden, vocab)
                got.append(loss.float().cpu().numpy())
            return got

        # (a) card = CPU
        cpu = build(mxt.cpu(), 0.0)
        weights = mxt.to_numpy_params(cpu)
        gpu = build(mxt.gpu(0), 0.0, weights)
        first = {}
        for name, model, ctx in (("cpu", cpu, mxt.cpu()),
                                 ("gpu", gpu, mxt.gpu(0))):
            x = mxt.nd.array(batches[0][0], ctx=ctx, dtype="int32")
            y = mxt.nd.array(batches[0][1], ctx=ctx, dtype="int32")
            with ctx:
                hidden = model.begin_state(6)
            with mxt.autograd.record():
                logits, states = model(x, hidden)
                loss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()(
                    logits.reshape((-1, vocab)), y.reshape((-1,)))
            loss.backward()
            first[name] = dict(
                logits=logits.asnumpy(), h=states[0].asnumpy(),
                c=states[1].asnumpy(),
                **{"grad " + k: p.grad().asnumpy() for k, p in
                   model._collect_params_with_prefix().items()})
            rounds(model, ctx, 3)
            first[name]["weights"] = mxt.to_numpy_params(model)
        errs = {k: _max_rel(first["gpu"][k], first["cpu"][k])
                for k in first["cpu"] if k != "weights"}
        errs.update({"weight " + k: _max_rel(
            first["gpu"]["weights"][k], v) for k, v in
            first["cpu"]["weights"].items()})
        worst = max(errs, key=errs.get)
        check(errs[worst] <= LM_SMALL_TOL, "lstm lm small: card vs CPU %s "
              "%.3g of its largest value" % (worst, errs[worst]))
        out["card_vs_cpu_worst"] = [worst, errs[worst]]
        # (b) hybridized = eager with dropout on, one seed
        runs = []
        for hybrid in (True, False):
            model = build(mxt.gpu(0), 0.5, weights)
            model.hybridize(hybrid)
            _seed_all(11)
            losses = rounds(model, mxt.gpu(0), 4)
            runs.append((losses, mxt.to_numpy_params(model),
                         model._captures))
        (lh, wh, caps), (le, we, _) = runs
        check(caps == 1, "lstm lm small: %d captures of one signature"
              % caps)
        check(all(onp.array_equal(a, b) for a, b in zip(lh, le))
              and all(onp.array_equal(wh[k], we[k]) for k in we),
              "lstm lm small: hybridized differs from eager with dropout "
              "from one seed")
        check(len({float(a.mean()) for a in lh}) == len(lh),
              "lstm lm small: the steps' losses repeat")
        # (c) two replays draw different masks
        model = build(mxt.gpu(0), 0.5, weights)
        model.hybridize()
        x = mxt.nd.array(batches[0][0], ctx=mxt.gpu(0), dtype="int32")
        with mxt.gpu(0):
            hidden = model.begin_state(6)
        with mxt.autograd.train_mode():
            got = [model(x, hidden)[0].asnumpy() for _ in range(4)]
        check(model._captures == 1 and not onp.array_equal(got[2], got[3])
              and all(onp.isfinite(g).all() for g in got),
              "lstm lm small: two replays gave the same logits (the "
              "dropout masks did not change)")
        out["hybridized_equal_eager_bitwise"] = True
        out["replays_differ"] = True
        log("lstm lm small: card vs CPU worst %s %.3g of its largest; "
            "hybridized = eager bit for bit with dropout 0.5 from one "
            "seed; replays draw fresh masks" % (worst, errs[worst]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    return out


def _lm_full_model(seed):
    """The full-width LSTM LM (BASELINE config 5) on the card,
    uniform(-0.05, 0.05) from ``seed``."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    model = models.LSTMLanguageModel(**LSTM_LM)
    model.initialize(mxt.init.Uniform(0.05), ctx=mxt.gpu(0),
                     generator=torch.Generator(device="cuda")
                     .manual_seed(seed))
    return model


def train_lstm_lm_loop(batches, init_seed=31):
    """The full-width LSTM LM through the word-LM Gluon loop
    (``_lm_loop_round``), hybridized and plain, from the same weights and
    one seed: LM_STEPS warm-up and timed steps (the hybridized model runs
    its first step eagerly and captures at its second), then
    PROFILED_STEPS under the profiler and 3 issued on an idle card. Every
    loss finite, the last 3 steps' mean loss below the first 3's, and the
    two runs' losses within CAPTURE_REL_TOL. Returns a summary."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    vocab = LSTM_LM["vocab_size"]
    model = _lm_full_model(init_seed)
    params = list(model.collect_params().values())
    init = [p._tensor().detach().clone() for p in params]
    data = [tuple(mxt.nd.array(a, ctx=mxt.gpu(0), dtype="int32") for a in b)
            for b in batches]
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    warm, timed = LM_STEPS
    rows = {}
    for mode in ("hybridized", "plain"):
        _reset(params, init)
        model.hybridize(mode == "hybridized")
        trainer = mxt.gluon.Trainer(model.collect_params(), "sgd",
                                    {"learning_rate": LM_LR})
        with mxt.gpu(0):
            state = {"hidden": model.begin_state(LM_BATCH), "i": 0}

        def one():
            x, y = data[state["i"] % len(data)]
            state["i"] += 1
            loss, state["hidden"] = _lm_loop_round(
                model, loss_fn, trainer, params, x, y, state["hidden"],
                vocab)
            return loss
        _seed_all(12)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [one() for _ in range(warm)]
        got, ms, host_ms = _timed_steps(one, timed)
        losses += got
        peak = torch.cuda.max_memory_allocated() / 1e9
        profiled = device_idle_share(one)
        rows[mode] = dict(
            step_ms=ms, step_host_ms=host_ms,
            tokens_per_s=LM_BPTT * LM_BATCH / ms * 1e3,
            issue_ms=issue_ms(one), idle_share=profiled["idle_share"],
            idle_share_of_timed_step=1.0 - profiled["busy_ms"]
            / PROFILED_STEPS / ms, profiled=profiled,
            peak_memory_gb=peak,
            losses=[float(l.float().mean()) for l in losses],
            captures=model._captures)
        del trainer
    model.hybridize(False)
    hyb, pla = rows["hybridized"], rows["plain"]
    for mode, row in rows.items():
        ls = row["losses"]
        check(all(math.isfinite(v) for v in ls)
              and sum(ls[-3:]) < sum(ls[:3]),
              "lstm lm gluon loop %s: losses not finite or not falling: %s"
              % (mode, ls))
    rel = max(abs(a - b) / abs(b) for a, b in zip(hyb["losses"],
                                                   pla["losses"]))
    check(rel <= CAPTURE_REL_TOL, "lstm lm gluon loop: hybridized losses "
          "%.3g relative from the plain loop's" % rel)
    check(hyb["captures"] == 1, "lstm lm gluon loop: %d captures of one "
          "signature" % hyb["captures"])
    del model, params, init, data
    gc.collect()
    torch.cuda.empty_cache()
    return dict(hybridized=hyb, plain=pla, max_rel_loss_diff=rel)


def _loop_layer(mode, x, h0, c0, weights):
    """The recurrence the port did not keep, timed beside it: one layer of
    ``rnn_op._rnn`` by the JAX package's arithmetic step by step (the
    input's products for every step at once, then an h2h product and the
    gates each step), in place of ``rnn_op._fused_layer`` (cuDNN's RNN)."""
    import torch
    import torch.nn.functional as F
    outs, hs, cs = [], [], []
    for d, (wi, wh, bi, bh) in enumerate(weights):
        xw = F.linear(x, wi, bi)
        h, c = h0[d], None if c0 is None else c0[d]
        ys = [None] * x.shape[0]
        steps = range(x.shape[0] - 1, -1, -1) if d else range(x.shape[0])
        for t in steps:
            hw = F.linear(h, wh, bh)
            if mode == "lstm":
                i, f, g, o = (xw[t] + hw).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                raise ValueError("the loop route times the LSTM only")
            ys[t] = h
        outs.append(torch.stack(ys))
        hs.append(h)
        cs.append(c)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1),
            torch.stack(hs), None if c0 is None else torch.stack(cs))


def train_lstm_lm_step(batches, route, timed, init_seed=31):
    """The full-width LSTM LM through jit.TrainStep (n_net_inputs = 3,
    zero states each step) with the recurrence on ``route`` ("fused", the
    port's: cuDNN's RNN; "loop", ``_loop_layer`` put in its place for this
    run): captured (a first step that captures, one replay, ``timed``
    timed replays, then the profiler and the idle-card issue), then its
    eager body from the same weights and seed (phase by phase once, then
    ``timed`` timed). Losses finite, the two runs' within CAPTURE_REL_TOL.
    Returns a summary."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ndarray import rnn_op
    vocab = LSTM_LM["vocab_size"]
    fused = rnn_op._fused_layer
    if route == "loop":
        rnn_op._fused_layer = _loop_layer
    try:
        model = _lm_full_model(init_seed)
        params = list(model.collect_params().values())
        init = [p._tensor().detach().clone() for p in params]
        with mxt.gpu(0):
            h0, c0 = model.begin_state(LM_BATCH)
        data = [tuple(mxt.nd.array(a, ctx=mxt.gpu(0), dtype="int32")
                      for a in b) for b in batches]
        pos = {"i": 0}

        def args():
            x, y = data[pos["i"] % len(data)]
            pos["i"] += 1
            return x, h0, c0, y

        step = _lm_step(model, LM_LR, vocab)
        _seed_all(13)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step(*args(), n_net_inputs=3)]
        capture_s = time.perf_counter() - t0
        losses.append(step(*args(), n_net_inputs=3))
        got, ms, host_ms = _timed_steps(
            lambda: step(*args(), n_net_inputs=3), timed)
        losses += got
        peak = torch.cuda.max_memory_allocated() / 1e9
        profiled = device_idle_share(lambda: step(*args(), n_net_inputs=3))
        issue = issue_ms(lambda: step(*args(), n_net_inputs=3))
        check(step.captures == 1, "lstm lm TrainStep: %d captures of one "
              "signature" % step.captures)
        captured = [float(l._data.float().mean()) for l in losses]
        del step
        _reset(params, init)
        pos["i"] = 0
        step = _lm_step(model, LM_LR, vocab)
        _seed_all(13)
        torch.cuda.reset_peak_memory_stats()
        eager = [_eager_step(step, *args(), n_net_inputs=3)]
        phases = step_phases(step, *args(), n_net_inputs=3)
        eager.append(phases.pop("loss"))
        got, eager_ms, eager_host_ms = _timed_steps(
            lambda: _eager_step(step, *args(), n_net_inputs=3), timed)
        eager += got
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        eager_profiled = device_idle_share(
            lambda: _eager_step(step, *args(), n_net_inputs=3))
        eager_issue = issue_ms(
            lambda: _eager_step(step, *args(), n_net_inputs=3))
        eager_losses = [float(l._data.float().mean()) for l in eager]
        del step
    finally:
        rnn_op._fused_layer = fused
    rel = max(abs(a - b) / abs(b) for a, b in zip(captured, eager_losses))
    check(all(math.isfinite(v) for v in captured + eager_losses),
          "lstm lm TrainStep (%s): a loss is not finite" % route)
    check(rel <= CAPTURE_REL_TOL, "lstm lm TrainStep (%s): captured losses "
          "%.3g relative from the eager body's" % (route, rel))
    del model, params, init, data
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        route=route, captured=dict(
            step_ms=ms, step_host_ms=host_ms,
            tokens_per_s=LM_BPTT * LM_BATCH / ms * 1e3, issue_ms=issue,
            idle_share=profiled["idle_share"], profiled=profiled,
            capture_step_s=capture_s, peak_memory_gb=peak,
            losses=captured),
        eager=dict(
            step_ms=eager_ms, step_host_ms=eager_host_ms,
            tokens_per_s=LM_BPTT * LM_BATCH / eager_ms * 1e3,
            issue_ms=eager_issue, idle_share=eager_profiled["idle_share"],
            profiled=eager_profiled, peak_memory_gb=eager_peak,
            step_phases_ms=phases, losses=eager_losses),
        max_rel_loss_diff=rel)


def check_lstm_lm_undetached(batches):
    """A captured TrainStep right after a recorded forward whose states the
    caller holds undetached (their graph alive, made on the default
    stream): it captures (the port raised here before its capture read the
    parameters through detached leaves) and two steps give finite
    losses."""
    import incubator_mxnet_tpu_torch as mxt
    vocab = LSTM_LM["vocab_size"]
    model = _lm_full_model(32)
    x, y = (mxt.nd.array(a, ctx=mxt.gpu(0), dtype="int32")
            for a in batches[0])
    with mxt.gpu(0):
        hidden = model.begin_state(LM_BATCH)
    with mxt.autograd.record():
        _, held = model(x, hidden)
    check(held[0]._data.requires_grad, "lstm lm: the held states carry no "
          "graph")
    step = _lm_step(model, LM_LR, vocab)
    losses = [float(step(x, held[0], held[1], y, n_net_inputs=3)
                    ._data.float().mean()) for _ in range(2)]
    check(step.captures == 1 and all(math.isfinite(v) for v in losses),
          "lstm lm: TrainStep after an undetached forward: captures %d, "
          "losses %s" % (step.captures, losses))
    del model, step, held, hidden
    gc.collect()
    return dict(captures=1, losses=losses)


def lstm_lm(card):
    """BASELINE config 5 on the card: the small-width checks, the
    full-width Gluon loop (hybridized and plain), TrainStep captured and
    eager on the port's recurrence (cuDNN's RNN) and on the step loop it
    did not keep, and a capture after an undetached forward. Returns
    (kernel launches over the main path, summary)."""
    from incubator_mxnet_tpu_torch.ops import _kernels
    summary = dict(card=card, small=check_lstm_lm_small(),
                   config=dict(LSTM_LM, bptt=LM_BPTT, batch=LM_BATCH,
                               lr=LM_LR, clip=LM_CLIP, dtype="float32"))
    batches = lm_batches(sum(LM_STEPS) + PROFILED_STEPS + 3, LM_USED_IDS,
                         40)
    _kernels.reset_launches()
    summary["gluon_loop"] = train_lstm_lm_loop(batches)
    launches = dict(_kernels.LAUNCHES)
    summary["train_step"] = {
        route: train_lstm_lm_step(batches, route, LM_STEP_TIMED)
        for route in ("fused", "loop")}
    summary["undetached_capture"] = check_lstm_lm_undetached(batches)
    loop, ts = summary["gluon_loop"], summary["train_step"]
    log("lstm lm (vocab %d, %d/%d, %d layers, B %d x BPTT %d, fp32): "
        "gluon loop hybridized %.2f ms (%.0f tokens/s, issue %.2f ms, idle "
        "%.1f%%), plain %.2f ms (%.0f tokens/s, issue %.2f, idle %.1f%%); "
        "TrainStep captured fused %.2f / loop %.2f ms, eager body fused "
        "%.2f / loop %.2f ms; losses %.3f -> %.3f"
        % (LSTM_LM["vocab_size"], LSTM_LM["embed_size"],
           LSTM_LM["hidden_size"], LSTM_LM["num_layers"], LM_BATCH, LM_BPTT,
           loop["hybridized"]["step_ms"], loop["hybridized"]["tokens_per_s"],
           loop["hybridized"]["issue_ms"],
           100 * loop["hybridized"]["idle_share"],
           loop["plain"]["step_ms"], loop["plain"]["tokens_per_s"],
           loop["plain"]["issue_ms"], 100 * loop["plain"]["idle_share"],
           ts["fused"]["captured"]["step_ms"],
           ts["loop"]["captured"]["step_ms"],
           ts["fused"]["eager"]["step_ms"], ts["loop"]["eager"]["step_ms"],
           loop["hybridized"]["losses"][0],
           loop["hybridized"]["losses"][-1]))
    return launches, summary


# --------------------------------------------------------------- model zoo

def check_zoo_small():
    """Each new model-zoo family (its ZOO model) at a small input in fp32,
    TF32 off and cuDNN deterministic: an eval-mode forward on the card
    within ZOO_SMALL_TOL of the same weights' forward on the CPU."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    errs = {}
    try:
        for name, _, small in ZOO:
            x = onp.random.RandomState(51).uniform(
                -1, 1, (2, 3, small, small)).astype("float32")
            nets = []
            for ctx in (mxt.cpu(), mxt.gpu(0)):
                net = vision.get_model(name)
                net.initialize(mxt.init.Xavier("gaussian", "in", 2), ctx=ctx,
                               generator=torch.Generator().manual_seed(52)
                               if ctx.device_type == "cpu" else
                               torch.Generator(device="cuda")
                               .manual_seed(52))
                with ctx:
                    net(mxt.nd.array(x, ctx=ctx))
                if nets:
                    mxt.from_jax_params(net, mxt.to_numpy_params(nets[0]))
                nets.append(net)
            got = [net(mxt.nd.array(x, ctx=ctx)).asnumpy() for net, ctx in
                   zip(nets, (mxt.cpu(), mxt.gpu(0)))]
            errs[name] = _max_rel(got[1], got[0])
            check(onp.isfinite(got[1]).all() and errs[name] <= ZOO_SMALL_TOL,
                  "model zoo %s: card vs CPU %.3g of the largest logit"
                  % (name, errs[name]))
            del nets
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    log("model zoo card vs CPU (fp32, small inputs): %s"
        % ", ".join("%s %.2g" % kv for kv in errs.items()))
    return errs


def train_zoo_model(name, size):
    """One family at its published widths: batch ZOO_BATCH x 3 x size²
    bf16 (fp32 masters, batch norm statistics fp32), Xavier from a seed
    (ZOO_INIT's arguments for SqueezeNet 1.0): one eager forward (logits finite, (batch, 1000)), then jit.TrainStep
    with SGD-momentum, captured: a first step, one replay, ZOO_TIMED timed
    replays; losses finite, no hand-written kernel launched. Returns a
    row."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.ops import _kernels
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(53)
    net = vision.get_model(name)
    net.initialize(mxt.init.Xavier(*ZOO_INIT.get(name, ())), ctx=mxt.gpu(0),
                   generator=gen)
    net.cast("bfloat16")
    x = torch.randn(ZOO_BATCH, 3, size, size, device=dev, generator=gen) \
        .to(torch.bfloat16)
    y = torch.randint(0, 1000, (ZOO_BATCH,), device=dev, generator=gen) \
        .float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = net(x)                   # deferred shapes
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits = net(x)
        end.record()
        end.synchronize()
    check(tuple(logits.shape) == (ZOO_BATCH, 1000)
          and bool(torch.isfinite(logits).all()),
          "model zoo %s: eager logits %s, finite %s" % (
              name, tuple(logits.shape), bool(torch.isfinite(logits).all())))
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.01, "momentum": 0.9, "multi_precision": True})
    step = mxt.jit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             trainer)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [step(x, y)]
    capture_s = time.perf_counter() - t0
    losses.append(step(x, y))
    got, ms, host_ms = _timed_steps(lambda: step(x, y), ZOO_TIMED)
    losses = [float(l._data.float().mean()) for l in losses + got]
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    check(all(math.isfinite(v) for v in losses) and step.captures == 1
          and not launches, "model zoo %s: losses %s, captures %d, "
          "hand-written kernels launched %s" % (name, losses, step.captures,
                                                launches))
    row = dict(batch=ZOO_BATCH, size=size, dtype="bfloat16",
               eager_forward_ms=start.elapsed_time(end), step_ms=ms,
               step_host_ms=host_ms, img_per_s=ZOO_BATCH / ms * 1e3,
               capture_step_s=capture_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               params=sum(p._tensor().numel() for p in
                          net.collect_params().values()), losses=losses)
    del net, step, trainer, x, y, logits
    gc.collect()
    torch.cuda.empty_cache()
    return row


def model_zoo(card):
    """The new model-zoo families on the card: card = CPU at small inputs,
    then each at its published widths through TrainStep. Returns
    (kernel launches over the main path, summary)."""
    from incubator_mxnet_tpu_torch.ops import _kernels
    summary = dict(card=card, card_vs_cpu=check_zoo_small())
    _kernels.reset_launches()
    summary["train"] = {name: train_zoo_model(name, size)
                        for name, size, _ in ZOO}
    launches = dict(_kernels.LAUNCHES)
    log("model zoo, B %d bf16 TrainStep captured: %s" % (ZOO_BATCH, ", ".join(
        "%s %.1f ms (%.0f img/s, %.1f GB)" % (
            k, r["step_ms"], r["img_per_s"], r["peak_memory_gb"])
        for k, r in summary["train"].items())))
    return launches, summary


# -------------------------------------------------------------------- SSD

def _ssd_synthetic(batch, size, seed, rows=SSD_LABEL_ROWS):
    """example/detection/train_ssd.py's synthetic_batches at ``size``²:
    images of noise with a class-coloured square each, and its box as the
    label, padded to ``rows`` rows of class -1. Numpy, from ``seed``."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    img = rng.rand(batch, 3, size, size).astype("float32") * 0.1
    label = onp.full((batch, rows, 5), -1.0, "float32")
    for i in range(batch):
        cls = rng.randint(0, 3)
        x1, y1 = rng.uniform(0.05, 0.5, 2)
        w = rng.uniform(0.2, 0.4)
        label[i, 0] = (cls, x1, y1, min(x1 + w, 0.95), min(y1 + w, 0.95))
        xa, ya, wb = int(x1 * size), int(y1 * size), int(w * size)
        img[i, cls, ya: ya + wb, xa: xa + wb] += 0.8
    return img, label


def _ssd_loss():
    """The SSD loss, per image, in float32: MultiBoxTarget (hard negatives
    at SSD_NEG_RATIO, as MXNet's example/ssd/symbol/symbol_builder.py sets
    it) under autograd.pause(), softmax cross-entropy over the anchors
    whose target is at least 0 (the ignored ones, -1, masked out: pick
    clips -1 to 0) plus smooth-L1 (scalar 1) under the box mask, each
    divided by its count of valid terms (symbol_builder.py's
    normalization="valid"; summed, the loss of 87,040 anchors diverges at
    example/ssd's learning rate). ``nd`` operators, so it runs on the
    NDArrays of the Gluon loop and on the tensors of a TrainStep."""
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import MultiBoxTarget
    nd = mxt.nd

    def loss(out, label):
        anchors, cls_preds, loc_preds = out
        cls_preds = nd.cast(cls_preds, "float32")
        loc_preds = nd.cast(loc_preds, "float32")
        with mxt.autograd.pause():
            loc_t, loc_mask, cls_t = MultiBoxTarget(
                anchors, label, cls_preds,
                negative_mining_ratio=SSD_NEG_RATIO)
        valid = nd.cast(cls_t >= 0, "float32")
        logp = nd.log_softmax(cls_preds, axis=1)
        ce = -(nd.pick(logp, nd.relu(cls_t), axis=1) * valid).sum(axis=1)
        box = (nd.smooth_l1(loc_preds - loc_t, scalar=1.0) * loc_mask) \
            .sum(axis=1)
        return ce / nd.maximum(valid.sum(axis=1), 1.0) + \
            box / nd.maximum(loc_mask.sum(axis=1), 1.0)
    return loss


def _ssd_model(ctx, seed, dtype="float32", **config):
    """``models.SSD(**config)`` on ``ctx`` with Xavier weights from
    ``seed`` (a generator on that device), in ``dtype`` (bf16 weights keep
    fp32 batch-norm statistics); shapes finished by one forward."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    net = models.SSD(**config)
    dev = "cuda" if ctx.device_type == "gpu" else "cpu"
    net.initialize(mxt.init.Xavier(), ctx=ctx,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    if dtype != "float32":
        net.cast(dtype)
    with torch.no_grad(), ctx:
        net(torch.zeros(1, 3, 64, 64, device=dev,
                        dtype=getattr(torch, dtype)))
    return net


def _ssd_sgd(net):
    import incubator_mxnet_tpu_torch as mxt
    return mxt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": SSD_LR, "momentum": 0.9, "wd": 5e-4,
        "multi_precision": True})


def _detection_cases():
    """(name, fn(ctx) -> list of numpy outputs, indices of the outputs held
    exactly) for every operator of ops/multibox.py, ops/detection.py and
    the ported nd.contrib, on inputs from seeds; the gradients of
    roi_align, bilinear_sampler and spatial_transformer are outputs too."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ndarray import contrib
    from incubator_mxnet_tpu_torch.ops import detection as det
    from incubator_mxnet_tpu_torch.ops import multibox as mb
    rng = onp.random.RandomState(61)
    feat = rng.randn(2, 3, 8, 8).astype("float32")
    rois = onp.array([[0, 0.5, 0.5, 5.5, 4.0], [1, 2.0, 1.0, 7.5, 7.0],
                      [0, 3.2, 2.1, 3.9, 2.9], [5, -1.0, -2.0, 9.0, 9.5]],
                     "float32")
    grid = rng.uniform(-1.2, 1.2, (2, 2, 5, 6)).astype("float32")
    theta = (onp.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.2]] * 2)
             + rng.randn(2, 6) * 0.1).astype("float32")
    anc_in = onp.zeros((1, 1, 6, 6), "float32")
    label = onp.array([[[1, 0.1, 0.1, 0.45, 0.5], [0, 0.5, 0.4, 0.9, 0.95],
                        [-1, 0, 0, 0, 0]],
                       [[2, 0.2, 0.3, 0.6, 0.7], [-1, 0, 0, 0, 0],
                        [-1, 0, 0, 0, 0]]], "float32")
    cls_pred = rng.randn(2, 4, 144).astype("float32")
    logits = rng.randn(2, 4, 144).astype("float32") * 2
    prob = (onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)) \
        .astype("float32")
    loc = (rng.randn(2, 144 * 4) * 0.5).astype("float32")

    def boxes(n, batch=()):
        xy = rng.rand(*batch, n, 2) * 0.7
        return onp.concatenate([xy, xy + rng.rand(*batch, n, 2) * 0.4
                                + 0.05], -1).astype("float32")
    b6, b4 = boxes(6, (2,)), boxes(4, (2,))
    rows = onp.concatenate([rng.randint(0, 3, (2, 12, 1)),
                            rng.rand(2, 12, 1), boxes(12, (2,))], -1) \
        .astype("float32")
    scores = rng.rand(5, 4).astype("float32")
    rpn = (rng.rand(2, 12, 4, 5).astype("float32"),
           (rng.randn(2, 24, 4, 5) * 0.2).astype("float32"),
           onp.array([[30, 38, 1], [26, 40, 1]], "float32"))
    sig = rng.randn(3, 2, 8).astype("float32")
    qkv = rng.randn(5, 3, 24).astype("float32")
    att = rng.rand(6, 5, 5).astype("float32")
    q, kv = rng.randn(5, 3, 8).astype("float32"), \
        rng.randn(7, 3, 16).astype("float32")
    att2 = rng.rand(6, 5, 7).astype("float32")
    bn = [rng.randn(4, 3, 2, 2).astype("float32"),
          rng.rand(3).astype("float32") + 0.5, rng.randn(3).astype("float32"),
          rng.randn(3).astype("float32"), rng.rand(3).astype("float32") + 0.5]
    rroi = onp.array([[0, 3.5, 4.0, 4.0, 3.0, 0.3],
                      [1, 5.0, 3.0, 6.0, 2.0, -1.1]], "float32")
    kw_rpn = dict(feature_stride=8, scales=(2, 4), ratios=(0.5, 1, 2),
                  rpn_pre_nms_top_n=40, rpn_post_nms_top_n=9, threshold=0.6,
                  rpn_min_size=4)

    def nd_(ctx, *arrays):
        return [mxt.nd.array(a, ctx=ctx) for a in arrays]

    def out(*arrays):
        return [a.asnumpy() if hasattr(a, "asnumpy") else
                onp.asarray(a.detach().cpu()) for a in arrays]

    def grads(fn, arrays, ctx):
        dev = "cuda" if ctx.device_type == "gpu" else "cpu"
        ts = [torch.tensor(a, device=dev, requires_grad=True)
              for a in arrays]
        y = fn(*ts)
        cot = torch.from_numpy(onp.random.RandomState(62).randn(
            *y.shape).astype("float32")).to(dev)
        return out(y, *torch.autograd.grad(y, ts, cot))

    def adagrad(ctx):
        w, g, h = nd_(ctx, bn[0][:, :, 0, 0], bn[0][:, :, 1, 1],
                      onp.ones((4, 1), "float32"))
        contrib.group_adagrad_update(w, g, h, 0.1, clip_gradient=0.5)
        return out(w, h)

    return [
        ("MultiBoxPrior", lambda c: out(mb.MultiBoxPrior(
            *nd_(c, anc_in), sizes=(0.25, 0.4), ratios=(1, 2, 0.5),
            clip=True)), ()),
        ("multibox.box_iou", lambda c: out(mb.box_iou(*nd_(c, b6[0], b4[0]))),
         ()),
        ("MultiBoxTarget", lambda c: out(*mb.MultiBoxTarget(*nd_(
            c, mb.MultiBoxPrior(mxt.nd.array(anc_in, ctx=mxt.cpu()),
                                sizes=(0.25, 0.4), ratios=(1, 2, 0.5))
            .asnumpy(), label, cls_pred), negative_mining_ratio=3,
            overlap_threshold=0.4)), (1, 2)),
        ("MultiBoxDetection", lambda c: out(mb.MultiBoxDetection(*nd_(
            c, prob, loc, mb.MultiBoxPrior(mxt.nd.array(anc_in, ctx=mxt.cpu()),
                                           sizes=(0.25, 0.4),
                                           ratios=(1, 2, 0.5)).asnumpy()),
            nms_threshold=0.45)[:, :, 0], mb.MultiBoxDetection(*nd_(
                c, prob, loc, mb.MultiBoxPrior(
                    mxt.nd.array(anc_in, ctx=mxt.cpu()), sizes=(0.25, 0.4),
                    ratios=(1, 2, 0.5)).asnumpy()), nms_threshold=0.45,
                nms_topk=7)), (0,)),
        ("roi_align", lambda c: grads(lambda d, r: det.roi_align(
            d, r, (3, 2), 0.75, 2), [feat, rois], c), ()),
        ("roi_pooling", lambda c: out(det.roi_pooling(
            *nd_(c, feat, rois), (2, 3), 1.0)), ()),
        ("grid_generator", lambda c: out(det.grid_generator(
            *nd_(c, theta), "affine", (5, 4))), ()),
        ("bilinear_sampler", lambda c: grads(det.bilinear_sampler,
                                             [feat, grid], c), ()),
        ("spatial_transformer", lambda c: grads(
            lambda d, t: det.spatial_transformer(d, t, (6, 5)),
            [feat, theta], c), ()),
        ("detection.box_iou", lambda c: out(det.box_iou(
            *nd_(c, b6, b4), "center")), ()),
        ("box_nms", lambda c: out(det.box_nms(*nd_(c, rows), id_index=0,
                                              topk=5)), (0,)),
        ("bipartite_matching", lambda c: out(*det.bipartite_matching(
            *nd_(c, scores), 0.2)), (0, 1)),
        ("multi_proposal", lambda c: out(det.multi_proposal(
            *nd_(c, *rpn), **kw_rpn)), ()),
        ("fft", lambda c: out(det.fft(*nd_(c, sig))), ()),
        ("ifft", lambda c: out(det.ifft(*nd_(c, onp.concatenate(
            [sig, sig], -1)))), ()),
        ("contrib.isinf/isnan/isfinite", lambda c: out(*[
            getattr(contrib, n)(*nd_(c, onp.array([1.0, onp.inf, onp.nan],
                                                  "float32")))
            for n in ("isinf", "isnan", "isfinite")]), (0, 1, 2)),
        ("contrib.ROIAlign", lambda c: out(contrib.ROIAlign(
            *nd_(c, feat, rois * 2), (2, 2), 0.5)), ()),
        ("contrib.AdaptiveAvgPooling2D", lambda c: out(
            contrib.AdaptiveAvgPooling2D(*nd_(c, feat), (3, 5))), ()),
        ("contrib.boolean_mask", lambda c: out(contrib.boolean_mask(
            *nd_(c, feat[0, 0], onp.array([1, 0, 1, 1, 0, 0, 1, 0],
                                          "float32")))), ()),
        ("contrib.index_copy", lambda c: out(contrib.index_copy(
            *nd_(c, feat[0, 0], onp.array([4, 1], "float32"),
                 feat[1, 0, :2]))), ()),
        ("contrib.gradientmultiplier/quadratic", lambda c: out(
            contrib.gradientmultiplier(*nd_(c, feat), 0.25),
            contrib.quadratic(*nd_(c, feat), 0.5, -1.0, 2.0)), ()),
        ("contrib.allclose", lambda c: out(contrib.allclose(
            *nd_(c, feat, feat + 1e-7))), (0,)),
        ("contrib.arange_like", lambda c: out(contrib.arange_like(
            *nd_(c, feat), start=2.0, step=0.5)), ()),
        ("contrib.SyncBatchNorm", lambda c: out(contrib.SyncBatchNorm(
            *nd_(c, *bn), ndev=1)), ()),
        ("contrib.SparseEmbedding", lambda c: out(contrib.SparseEmbedding(
            *nd_(c, onp.array([[0, 5], [2, 2]], "float32"), feat[0, 0, :6]),
            6, 8)), ()),
        ("contrib.index_array", lambda c: out(contrib.index_array(
            *nd_(c, feat), (3, 0))), (0,)),
        ("contrib.group_adagrad_update", adagrad, ()),
        ("contrib.interleaved_matmul_*", lambda c: out(
            contrib.interleaved_matmul_selfatt_qk(*nd_(c, qkv), heads=2),
            contrib.interleaved_matmul_selfatt_valatt(*nd_(c, qkv, att),
                                                      heads=2),
            contrib.interleaved_matmul_encdec_qk(*nd_(c, q, kv), heads=2),
            contrib.interleaved_matmul_encdec_valatt(*nd_(c, kv, att2),
                                                     heads=2)), ()),
        ("contrib.box_encode/box_decode", lambda c: out(
            *contrib.box_encode(*nd_(c, onp.array([[1, 0, 1, 1, 0, 1]] * 2,
                                                  "float32"),
                                     onp.array([[0, -1, 2, 1, 0, 2]] * 2,
                                               "float32"), b6, boxes(3, (2,)))),
            contrib.box_decode(*nd_(c, (b6 - 0.3) * 0.5, b6), clip=0.1)),
         (1,)),
        ("contrib.RROIAlign", lambda c: grads(
            lambda d, r: contrib.RROIAlign(d, r, (2, 3), 1.0),
            [feat, rroi], c)[:2], ()),
    ]


def check_detection_small():
    """Every operator of ops/multibox.py, ops/detection.py and the ported
    nd.contrib on the card against the CPU, float32 with TF32 off: index
    outputs (class ids, masks, matches, kept rows) equal, values (and the
    gradients of roi_align, bilinear_sampler, spatial_transformer and
    RROIAlign) within DET_SMALL_TOL of the largest. Returns the largest
    relative error by operator."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for name, fn, exact in _detection_cases():
            cases = _detection_cases()       # the same seeds for each leg
            fn_cpu = next(f for n, f, _ in cases if n == name)
            with mxt.cpu():
                want = fn_cpu(mxt.cpu())
            with mxt.gpu(0):
                got = fn(mxt.gpu(0))
            check(len(got) == len(want), "%s: %d outputs on the card, %d on "
                  "the CPU" % (name, len(got), len(want)))
            err = 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                check(g.shape == w.shape, "%s output %d: shape %s vs %s"
                      % (name, i, g.shape, w.shape))
                if i in exact:
                    check(onp.array_equal(g, w), "%s output %d: card != CPU"
                          % (name, i))
                    continue
                check(onp.array_equal(onp.isnan(g), onp.isnan(w)),
                      "%s output %d: NaNs differ" % (name, i))
                scale = max(float(onp.nanmax(onp.abs(w))) if w.size else 0,
                            1e-30)
                e = float(onp.nan_to_num(onp.abs(g.astype("float64") - w))
                          .max()) / scale if w.size else 0.0
                check(e <= DET_SMALL_TOL, "%s output %d: card vs CPU %.3g of "
                      "the largest" % (name, i, e))
                err = max(err, e)
            errs[name] = err
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    log("detection ops card vs CPU (fp32, TF32 off): %d operators, largest "
        "%.2g" % (len(errs), max(errs.values())))
    return errs


def check_ssd_small():
    """SSD at base_channels SSD_SMALL["base_channels"] on SSD_SMALL_SIZE²
    inputs, fp32, TF32 off and cuDNN deterministic: the same weights on
    the card and the CPU, the eval forward's anchors, class and box
    predictions and one Gluon-loop step (record, the SSD loss, backward,
    Trainer.step) on the same batch: losses and every parameter after it
    within SSD_SMALL_TOL of their largest value."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    img, label = _ssd_synthetic(4, SSD_SMALL_SIZE, 63)
    loss_fn = _ssd_loss()
    runs = []
    try:
        for ctx in (mxt.cpu(), mxt.gpu(0)):
            net = _ssd_model(ctx, 64, **SSD_SMALL)
            if runs:          # the CPU's weights on the card
                mxt.from_jax_params(net, runs[0]["init"], strict=True)
            init = mxt.to_numpy_params(net)
            with ctx:
                x = mxt.nd.array(img, ctx=ctx)
                y = mxt.nd.array(label, ctx=ctx)
                fwd = [o.asnumpy() for o in net(x)]
                trainer = _ssd_sgd(net)
                with mxt.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(x.shape[0])
            runs.append(dict(init=init, fwd=fwd, loss=loss.asnumpy(),
                             after=mxt.to_numpy_params(net)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    cpu, card = runs
    errs = {"forward": max(_max_rel(g, w) for g, w in zip(card["fwd"],
                                                           cpu["fwd"])),
            "loss": _max_rel(card["loss"], cpu["loss"]),
            "weights": max(_max_rel(card["after"][k], cpu["after"][k])
                           for k in cpu["after"])}
    check(all(onp.isfinite(v) and v <= SSD_SMALL_TOL for v in errs.values()),
          "SSD small card vs CPU: %s" % errs)
    log("SSD small (base %d, %d², fp32) card vs CPU: forward %.2g, loss "
        "%.2g, weights after a step %.2g" % (
            SSD_SMALL["base_channels"], SSD_SMALL_SIZE, errs["forward"],
            errs["loss"], errs["weights"]))
    return errs


def ssd_conv_flops(net, size):
    """Forward FLOPs of one image from the convolutions' shapes as they
    run: 2 · output elements · (input channels / groups · kernel area) for
    every Conv2D, counted by forward hooks on a one-image forward."""
    import torch
    total = [0]

    def hook(mod, inputs, output):
        total[0] += 2 * output.numel() * mod.weight._tensor()[0].numel()
    hooks = [torch.nn.Module.register_forward_hook(m, hook)
             for m in net.modules() if type(m).__name__ == "Conv2D"]
    w = next(p._tensor() for p in net.collect_params().values())
    try:
        with torch.no_grad():
            net(torch.zeros(1, 3, size, size, device=w.device,
                            dtype=w.dtype))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def check_captured_equals_eager(net, loss_fn, make_trainer, inputs, init,
                                n, what):
    """From ``init``, ``n`` steps of the captured TrainStep and of its
    eager body, cuDNN deterministic: losses and every parameter (running
    statistics and the fp32 masters' casts included) equal bit for bit.
    Leaves ``init`` in the net; returns ``n``."""
    import torch
    from incubator_mxnet_tpu_torch import jit
    params = list(net.collect_params().values())
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for mode in ("captured", "eager"):
            _reset(params, init)
            step = jit.TrainStep(net, loss_fn, make_trainer())
            if mode == "captured":
                losses = [step(*inputs)._data.clone() for _ in range(n)]
                check(step.captures == 1, "%s: %d captures for one "
                      "signature" % (what, step.captures))
            else:
                losses = [_eager_step(step, *inputs)._data.clone()
                          for _ in range(n)]
            runs.append((losses, [p._tensor().detach().clone()
                                  for p in params]))
            del step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    (lc, pc), (le, pe) = runs
    check(all(torch.equal(a, b) for a, b in zip(lc, le)),
          "%s: captured losses %s != eager %s" % (
              what, [float(v.mean()) for v in lc],
              [float(v.mean()) for v in le]))
    bad = [p.name for p, a, b in zip(params, pc, pe) if not torch.equal(a, b)]
    check(not bad, "%s: captured != eager after %d steps in %s"
          % (what, n, bad[:5]))
    _reset(params, init)
    return n


def top_kernels(fn, n=10):
    """The ``n`` CUDA kernels taking the most device time over one call of
    ``fn`` (after a warm-up), from torch.profiler: [name (240 characters),
    ms, share of the call's device time]; [] when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [(e.key[:240], getattr(e, "device_time_total", 0.0) / 1e3)
             for e in prof.key_averages()]
    total = sum(ms for _, ms in times) or 1.0
    return [[k, ms, ms / total] for k, ms in
            sorted(times, key=lambda t: -t[1])[:n] if ms > 0]


def train_ssd_captured(net, x, y, flops):
    """SSD-512 through the captured TrainStep (SGD-momentum, fp32 masters):
    a first step (which captures), a replay, SSD_TIMED timed replays,
    PROFILED_STEPS under the profiler, 3 issued with the card idle, and
    one split by kernel (``top_kernels``). Losses finite, one capture, no
    hand-written kernel launched. Returns a row."""
    import torch
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.ops import _kernels
    step = jit.TrainStep(net, _ssd_loss(), _ssd_sgd(net))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(x, y)]
    capture_s = time.perf_counter() - t0
    losses.append(step(x, y))
    got, ms, host_ms = _timed_steps(lambda: step(x, y), SSD_TIMED)
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    idle = device_idle_share(lambda: step(x, y))
    issue = issue_ms(lambda: step(x, y))
    kernels = top_kernels(lambda: step(x, y))
    losses = [float(v._data.float().mean()) for v in losses + got]
    batch = x.shape[0]
    check(all(math.isfinite(v) for v in losses) and step.captures == 1
          and not launches,
          "SSD TrainStep: losses %s, captures %d, hand-written kernels "
          "launched %s" % (losses, step.captures, launches))
    row = dict(step_ms=ms, step_host_ms=host_ms, issue_ms=issue,
               img_per_s=batch / ms * 1e3,
               share_of_peak=3 * flops * batch / (ms * 1e-3) / PEAK_BF16_FLOPS,
               capture_step_s=capture_s, captures=step.captures,
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               losses=losses, top_kernels=kernels, **idle)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_ssd_loop(net, x, y):
    """SSD-512 in MXNet's Gluon loop, the model hybridized: record, the
    forward (a captured graph from the second call), MultiBoxTarget and
    the loss eagerly, backward, Trainer.step; SSD_LOOP_STEPS warm-up and
    timed steps on one batch, then PROFILED_STEPS under the profiler and
    3 issued with the card idle. The losses must be finite and fall over
    the timed steps. Also MultiBoxTarget's own ms a batch (CUDA events).
    Returns a row."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import MultiBoxTarget
    loss_fn = _ssd_loss()
    trainer = _ssd_sgd(net)
    net.hybridize()
    x, y = mxt.nd.NDArray(x), mxt.nd.NDArray(y)     # MXNet's loop: NDArrays

    def round_():
        with mxt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        return loss
    warm, timed = SSD_LOOP_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [round_() for _ in range(warm)]
    got, ms, host_ms = _timed_steps(round_, timed)
    losses = [float(v.asnumpy().mean()) for v in losses + got]
    idle = device_idle_share(round_)
    issue = issue_ms(round_)
    with torch.no_grad():
        anchors, cls_preds, _ = net(x._data)
    cls32 = mxt.nd.cast(cls_preds, "float32")
    target_ms = timed_ms(lambda: MultiBoxTarget(
        anchors, y._data, cls32, negative_mining_ratio=SSD_NEG_RATIO), 10)
    check(all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[warm],
          "SSD Gluon loop: losses %s (finite, falling over the timed steps)"
          % losses)
    row = dict(step_ms=ms, step_host_ms=host_ms, issue_ms=issue,
               img_per_s=x.shape[0] / ms * 1e3, captures=net._captures,
               multibox_target_ms=target_ms,
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, **idle)
    net.hybridize(False)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def detect_ssd(net, x):
    """SSD-512 detection as a server runs it: EvalStep's forward, softmax
    over the classes in fp32, MultiBoxDetection(nms_topk SSD_NMS_TOPK, nms
    threshold 0.45). Rows (B, A, 6), sorted by score: class ids in [-1,
    classes), at most nms_topk detections an image, every row past them
    -1, scores and boxes finite. Forward and detection ms by CUDA events
    (3 runs each after a warm-up) and img/s. Returns a row."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.ops import MultiBoxDetection
    ev = jit.EvalStep(net)
    anchors, cls_preds, loc_preds = ev(x)

    def decode():
        prob = mxt.nd.softmax(mxt.nd.cast(cls_preds, "float32"), axis=1)
        return MultiBoxDetection(prob, mxt.nd.cast(loc_preds, "float32"),
                                 anchors, nms_threshold=0.45,
                                 nms_topk=SSD_NMS_TOPK)
    fwd_ms = timed_ms(lambda: ev(x), 3)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    det_ms = timed_ms(decode, 3)
    det_host_ms = (time.perf_counter() - h0) * 1e3 / 4
    out = decode()._data
    n, a = x.shape[0], anchors.shape[1]
    ids = out[..., 0]
    kept = (ids >= 0).sum(1)
    check(tuple(out.shape) == (n, a, 6) and bool(torch.isfinite(
        out[..., 1:]).all()) and int(ids.min()) >= -1
        and int(ids.max()) < SSD["num_classes"]
        and int(kept.max()) <= SSD_NMS_TOPK
        and bool((ids[:, SSD_NMS_TOPK:] == -1).all()),
        "SSD detection: shape %s, ids in [%d, %d], kept at most %d"
        % (tuple(out.shape), int(ids.min()), int(ids.max()),
           int(kept.max())))
    return dict(forward_ms=fwd_ms, detection_ms=det_ms,
                detection_host_ms=det_host_ms,
                img_per_s=n / (fwd_ms + det_ms) * 1e3,
                detections_per_image=float(kept.float().mean()))


def ssd_phase(card):
    """BASELINE config 4 on the card: the detection operators and a small
    SSD card = CPU, then SSD-512 (SSD's defaults: 20 classes, base 64, 512²
    inputs, 87,040 anchors) at batch SSD_BATCH in bf16 with fp32 masters
    on the synthetic recipe's boxes: captured = eager bit for bit, the
    captured TrainStep, the hybridized Gluon loop and detection. Returns
    (kernel launches over the main path, summary)."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    summary = dict(card=card, ops_card_vs_cpu=check_detection_small(),
                   small_card_vs_cpu=check_ssd_small(),
                   config=dict(SSD, size=SSD_SIZE, batch=SSD_BATCH,
                               dtype="bfloat16", optimizer="sgd", lr=SSD_LR,
                               momentum=0.9, wd=5e-4,
                               negative_mining_ratio=SSD_NEG_RATIO))
    img, label = _ssd_synthetic(SSD_BATCH, SSD_SIZE, 64)
    ctx = mxt.gpu(0)
    dev = mxt.context.as_device(ctx)
    x = torch.from_numpy(img).to(dev, torch.bfloat16)
    y = torch.from_numpy(label).to(dev)
    net = _ssd_model(ctx, 65, "bfloat16", **SSD)
    flops = ssd_conv_flops(net, SSD_SIZE)
    check(abs(flops - SSD_FLOPS) <= 0.01 * SSD_FLOPS,
          "SSD-512 forward %.4g FLOP an image, expected about %.4g"
          % (flops, SSD_FLOPS))
    with torch.no_grad():
        anchors = net(x[:1])[0]
    check(anchors.shape[1] == SSD_ANCHORS, "SSD-512: %d anchors, expected "
          "%d" % (anchors.shape[1], SSD_ANCHORS))
    summary.update(forward_gflop_per_image=flops / 1e9,
                   anchors=SSD_ANCHORS)
    params = list(net.collect_params().values())
    init = [p._tensor().detach().clone() for p in params]
    summary["captured_equals_eager_steps"] = check_captured_equals_eager(
        net, _ssd_loss(), lambda: _ssd_sgd(net), [x, y], init,
        SSD_EXACT_STEPS, "SSD")
    _kernels.reset_launches()
    summary["train_step"] = train_ssd_captured(net, x, y, flops)
    _reset(params, init)
    summary["gluon_loop"] = train_ssd_loop(net, x, y)
    summary["detection"] = detect_ssd(net, x)
    launches = dict(_kernels.LAUNCHES)
    check(not any(launches.values()), "SSD path launched hand-written "
          "kernels %s" % launches)
    ts, loop, det = (summary["train_step"], summary["gluon_loop"],
                     summary["detection"])
    log("SSD-512 (B %d bf16, %d anchors, %.1f GFLOP an image forward): "
        "TrainStep captured %.1f ms (%.0f img/s, %.2f%% of 989 TFLOP/s, "
        "issue %.2f ms, idle %.1f%%, peak %.1f GB); Gluon loop hybridized "
        "%.1f ms (issue %.1f ms, MultiBoxTarget %.2f ms); detection forward "
        "%.1f + NMS %.1f ms (%.0f img/s); losses %.3f -> %.3f"
        % (SSD_BATCH, SSD_ANCHORS, flops / 1e9, ts["step_ms"],
           ts["img_per_s"], 100 * ts["share_of_peak"], ts["issue_ms"],
           100 * ts["idle_share"], ts["peak_allocated_gb"], loop["step_ms"],
           loop["issue_ms"], loop["multibox_target_ms"], det["forward_ms"],
           det["detection_ms"], det["img_per_s"], loop["losses"][0],
           loop["losses"][-1]))
    del net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


# -------------------------------------------------------------- op breadth

def _breadth_linalg_cases(rng):
    """(name, call(linalg, *arrays), arrays) for every nd.linalg operator;
    the factorisations through their sign-free invariants."""
    import numpy as onp

    def spd(n):
        a = rng.randn(3, n, n)
        return a @ a.transpose(0, 2, 1) + n * onp.eye(n)
    sq = rng.randn(3, 6, 6) + 6 * onp.eye(6)
    low, m = onp.tril(sq), rng.randn(3, 5, 7)

    def lq(la, a):
        ll, q = la.gelqf(a)
        return [la.gemm2(ll, q), q.abs()]

    def svd(la, a):
        u, s_, vh = la.svd(a)
        return [s_, la.gemm2(u * s_.expand_dims(1), vh)]

    def eig(la, a):
        u, w = la.syevd(a)
        return [w, la.gemm2(u, u * w.expand_dims(2), transpose_a=True)]
    return [
        ("gemm", lambda la, a, b, c: la.gemm(a, b, c, alpha=0.5, beta=2.0),
         [m, rng.randn(3, 7, 4), rng.randn(3, 5, 4)]),
        ("gemm2", lambda la, a, b: la.gemm2(a, b, transpose_b=True),
         [m, rng.randn(3, 4, 7)]),
        ("potrf", lambda la, a: la.potrf(a), [spd(6)]),
        ("potri", lambda la, a: la.potri(a),
         [onp.linalg.cholesky(spd(6))]),
        ("trsm", lambda la, a, b: la.trsm(a, b, rightside=True,
                                          transpose=True, alpha=2.0),
         [low, rng.randn(3, 4, 6)]),
        ("trmm", lambda la, a, b: la.trmm(a, b, lower=False),
         [sq, rng.randn(3, 6, 4)]),
        ("syrk", lambda la, a: la.syrk(a, transpose=True), [m]),
        ("gelqf", lq, [m]),
        ("sumlogdiag", lambda la, a: la.sumlogdiag(a), [spd(6)]),
        ("extractdiag", lambda la, a: la.extractdiag(a, offset=-1), [sq]),
        ("makediag", lambda la, a: la.makediag(a, offset=1),
         [rng.randn(3, 5)]),
        ("extracttrian", lambda la, a: la.extracttrian(a, offset=1), [sq]),
        ("maketrian", lambda la, a: la.maketrian(a, lower=False),
         [rng.randn(3, 21)]),
        ("inverse", lambda la, a: la.inverse(a), [sq]),
        ("det", lambda la, a: la.det(a), [sq]),
        ("slogdet", lambda la, a: list(la.slogdet(a)), [sq]),
        ("svd", svd, [m]),
        ("syevd", eig, [spd(6)]),
    ]


def _breadth_close(got, want, tol):
    """max |got - want| over the largest |want|, checked against ``tol``;
    returns it."""
    import numpy as onp
    err = 0.0
    for g, w in zip(got, want):
        g, w = onp.asarray(g, "float64"), onp.asarray(w, "float64")
        err = max(err, float(onp.abs(g - w).max())
                  / max(float(onp.abs(w).max()), 1e-30))
    check(err <= tol, "card vs CPU %.3g of the largest value (tolerance %g)"
          % (err, tol))
    return err


def _two_legs(fn, arrays, dtype, grads=()):
    """``fn(*arrays)`` on the CPU and on the card (TF32 off): the outputs
    and the gradients of their sum with respect to the arrays at
    ``grads``, as numpy."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import autograd, nd
    from incubator_mxnet_tpu_torch.test_utils import _full_precision
    legs = []
    with _full_precision(True):
        for ctx in (mxt.cpu(), mxt.gpu(0)):
            xs = [nd.array(a, ctx=ctx, dtype=dtype) for a in arrays]
            for i in grads:
                xs[i].attach_grad()
            with autograd.record():
                out = fn(*xs)
                outs = out if isinstance(out, (list, tuple)) else [out]
                total = sum(o.astype("float64").sum() for o in outs)
            if grads:
                total.backward()
            legs.append([o.asnumpy() for o in outs]
                        + [xs[i].grad.asnumpy() for i in grads])
    torch.cuda.synchronize()
    return legs


def check_ndarray_breadth():
    """The rest of mx.nd on the card: every nd.linalg operator card vs CPU
    in float32 and float64 (the factorisations through their invariants)
    with the gradients of the differentiable ones; nd.sparse cast_storage
    round trips and sparse.dot card vs CPU; deformable_conv2d (DCNv2 mask,
    two groups) card vs CPU with its four gradients; an LSTM cell unrolled
    by contrib.foreach and a contrib.while_loop(max_iterations=6) inside
    the captured TrainStep equal to its eager body bit for bit. Returns a
    summary."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.ndarray import contrib
    from incubator_mxnet_tpu_torch.ops.deformable import deformable_conv2d
    rng = onp.random.RandomState(23)
    linalg = {}
    for name, fn, arrays in _breadth_linalg_cases(rng):
        diff = () if name in ("slogdet", "gelqf", "svd", "syevd") \
            else tuple(range(len(arrays)))
        for dtype in ("float32", "float64"):
            cpu, card = _two_legs(lambda *xs: fn(nd.linalg, *xs), arrays,
                                  dtype, diff)
            linalg["%s_%s" % (name, dtype)] = _breadth_close(
                card, cpu, BREADTH_TOL[dtype] * (10 if name in (
                    "inverse", "potri", "trsm", "det", "svd", "syevd",
                    "gelqf") else 1))
    dense = rng.randn(40, 24).astype("float32")
    dense[rng.rand(40) < 0.5] = 0
    dense[rng.rand(40, 24) < 0.3] = 0
    rhs = rng.randn(24, 16).astype("float32")
    sparse = {}
    for ctx in (mxt.cpu(), mxt.gpu(0)):
        a = nd.array(dense, ctx=ctx)
        for stype in ("row_sparse", "csr"):
            back = nd.cast_storage(nd.cast_storage(a, stype), "default")
            check(onp.array_equal(back.asnumpy(), dense),
                  "cast_storage %s round trip on %s" % (stype, ctx))
        sparse[str(ctx)] = nd.sparse.dot(
            a.tostype("csr"), nd.array(rhs, ctx=ctx)).asnumpy()
    sparse_err = _breadth_close([sparse["gpu(0)"]], [sparse["cpu(0)"]],
                                1e-5)
    n, c, h, w, co, ndg = 2, 8, 12, 10, 6, 2
    arrays = [rng.randn(n, c, h, w), rng.randn(n, ndg * 18, h, w) * 2,
              rng.randn(co, c, 3, 3), rng.randn(co),
              rng.rand(n, ndg * 9, h, w)]
    cpu, card = _two_legs(
        lambda *xs: nd._apply(lambda x, off, wt, b, m: deformable_conv2d(
            x, off, wt, b, kernel=(3, 3), pad=(1, 1),
            num_deformable_group=ndg, mask=m), *xs),
        arrays, "float32", (0, 1, 2, 3, 4))
    deform_err = _breadth_close(card, cpu, 1e-4)

    def unrolled():
        g = mxt.gluon

        class Unrolled(g.HybridBlock):
            def __init__(self):
                super().__init__()
                self.cell = g.rnn.LSTMCell(64, input_size=32)
                self.out = g.nn.Dense(10, in_units=64)

            def forward(self, x):
                begin = [torch.zeros(x.shape[1], 64, device=x.device)] * 2
                outs, _ = contrib.foreach(
                    lambda xt, st: self.cell(xt, st), x, begin)
                return self.out(outs[-1])
        net = Unrolled()
        net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                       generator=torch.Generator("cuda").manual_seed(4))
        return net

    def looped():
        g = mxt.gluon

        class Looped(g.HybridBlock):
            def __init__(self):
                super().__init__()
                self.step = g.nn.Dense(32, in_units=32)
                self.out = g.nn.Dense(10, in_units=32)

            def forward(self, x):
                i = torch.zeros(1, device=x.device)
                outs, (_, h) = contrib.while_loop(
                    lambda i, h: i < 3.5,
                    lambda i, h: ((torch.tanh(self.step(h)),),
                                  (i + 1, torch.tanh(self.step(h)))),
                    [i, x], max_iterations=6)
                return self.out(h + outs[0].sum(0))
        net = Looped()
        net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                       generator=torch.Generator("cuda").manual_seed(5))
        return net

    dev = torch.device("cuda", 0)
    y = torch.arange(8, device=dev).float() % 10
    steps = {}
    for what, make, x in (("foreach", unrolled, (12, 8, 32)),
                          ("while_loop", looped, (8, 32))):
        net = make()
        init = [p._tensor().detach().clone()
                for p in net.collect_params().values()]
        steps[what] = check_captured_equals_eager(
            net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
            lambda: mxt.gluon.Trainer(net.collect_params(), "sgd",
                                      {"learning_rate": 0.1}),
            [torch.randn(*x, device=dev), y], init, 3, what)
    foreach_steps, while_steps = steps["foreach"], steps["while_loop"]
    summary = dict(linalg_rel_err=linalg, sparse_dot_rel_err=sparse_err,
                   deformable_rel_err=deform_err, f9=_f9_on_card(),
                   foreach_captured_equals_eager_steps=foreach_steps,
                   while_loop_captured_equals_eager_steps=while_steps)
    log("nd breadth on the card: nd.linalg card vs CPU worst fp32 %.3g, "
        "fp64 %.3g (%d operators); sparse round trips exact, sparse.dot "
        "%.3g; deformable_conv2d with gradients %.3g; foreach and "
        "while_loop captured = eager bit for bit over %d steps"
        % (max(v for k, v in linalg.items() if k.endswith("32")),
           max(v for k, v in linalg.items() if k.endswith("64")),
           len(linalg) // 2, sparse_err, deform_err, foreach_steps))
    return summary


def _f9_on_card():
    """MXNet idioms on gpu(0) that the port once refused: every
    initializer fills a CUDA NDArray in place (the draws equal to the
    tensor path's from the same seed); ``x += 100`` after a recorded
    ``y = sum(x * x)`` leaves ``y.backward()`` the gradient [2, 4];
    TopKAccuracy(2) breaks the reference's tie (0.5); the list format's
    ``save_ndarray_list``/``load_ndarray_list`` round-trip a bf16 and an
    fp32 array bit for bit; an eager-or-captured EvalStep on a CUDA net
    shows as an ``eval:step`` span in the profiler's dump. Returns a
    summary."""
    import json as _json
    import shutil
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import autograd, metric, nd, profiler
    from incubator_mxnet_tpu_torch.ndarray import random as ndrandom
    from incubator_mxnet_tpu_torch.ndarray import serialization as ser
    from incubator_mxnet_tpu_torch.telemetry import spans
    gpu, dev = mxt.gpu(0), torch.device("cuda", 0)
    init = mxt.init
    inits = {"zeros": (init.Zero(), (16, 8)), "ones": (init.One(), (16, 8)),
             "constant": (init.Constant(0.25), (16, 8)),
             "uniform": (init.Uniform(0.07), (16, 8)),
             "normal": (init.Normal(0.01), (16, 8)),
             "orthogonal": (init.Orthogonal(), (8, 16)),
             "xavier": (init.Xavier(), (16, 8)),
             "msraprelu": (init.MSRAPrelu(), (16, 8)),
             "bilinear": (init.Bilinear(), (2, 2, 4, 4)),
             "lstmbias": (init.LSTMBias(2.0), (16,)),
             "mixed": (init.Mixed(["w.*"], [init.Constant(0.5)]), (4, 4))}
    filled = {}
    for name, (ini, shape) in inits.items():
        arr = nd.zeros(shape, ctx=gpu)
        held = arr._data
        mxt.random.seed(3)
        (mxt.init.create(name) if name in ("zeros", "ones", "xavier")
         else ini)("weight", arr)
        ref = torch.zeros(shape, device=dev)
        mxt.random.seed(3)
        ini("weight", ref, ndrandom._generator(dev))
        # the orthogonal factor comes from cuSOLVER's SVD of the draws
        same = torch.allclose(held, ref, rtol=0, atol=1e-6) \
            if name == "orthogonal" else torch.equal(held, ref)
        check(arr._data is held and held.is_cuda and same
              and bool(held.isfinite().all()),
              "init %s on a CUDA NDArray: in place %s, equal to the "
              "tensor path %s" % (name, arr._data is held, same))
        filled[name] = dict(mean=float(held.mean()), absmax=float(
            held.abs().max()))
    check(filled["zeros"]["absmax"] == 0 and filled["ones"]["mean"] == 1
          and filled["constant"]["mean"] == 0.25
          and filled["uniform"]["absmax"] <= 0.07, "initializer values %s"
          % filled)
    x = nd.array([1.0, 2.0], ctx=gpu)
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    x += 100
    y.backward()
    grad = x.grad.asnumpy().tolist()
    check(grad == [2.0, 4.0] and x.asnumpy().tolist() == [101.0, 102.0],
          "+= after record(): grad %s, x %s" % (grad, x.asnumpy()))
    top = metric.TopKAccuracy(top_k=2)
    top.update([nd.array([2, 1], ctx=gpu)],
               [nd.array([[0.1, 0.5, 0.4], [0.8, 0.1, 0.1]], ctx=gpu)])
    check(top.get()[1] == 0.5, "TopKAccuracy(2) on the card: %s"
          % top.get()[1])
    tmp = _build_tmp()
    try:
        f = os.path.join(tmp, "list.params")
        arrays = [nd.array([[1.5, -2.25], [3.0, 1e-3]], ctx=gpu).astype(
            "bfloat16"), nd.array([0.1, -7.0, 1e-30], ctx=gpu)]
        ser.save_ndarray_list(f, arrays, ["bf16", "fp32"])
        back, names = ser.load_ndarray_list(f)
        check(names == ["bf16", "fp32"] and all(
            b.dtype == a.dtype and torch.equal(b._data, a._data.cpu())
            for a, b in zip(arrays, back)), "the list format's round trip "
            "on the card")
        net = mxt.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=gpu, generator=torch.Generator().manual_seed(9))
        step = mxt.jit.EvalStep(net)
        trace = os.path.join(tmp, "trace.json")
        profiler.set_config(filename=trace)
        profiler.set_state("run")
        try:
            # the dump may hold earlier sessions' events: count the
            # children of this span
            with spans.span("f9:eval_calls") as calls:
                for _ in range(3):
                    step(nd.ones((2, 4), ctx=gpu))
        finally:
            profiler.set_state("stop")
        profiler.dump()
        with open(trace) as fh:
            spans_ = [e for e in _json.load(fh)["traceEvents"]
                      if e.get("cat") == "span" and e["name"] == "eval:step"
                      and e["args"].get("parent_id") == calls.span_id]
        step.release()
        check(len(spans_) == 3, "EvalStep on the card: %d eval:step spans "
              "under the calls' span in the profiler's dump for 3 calls"
              % len(spans_))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("F9 on the card: %d initializers fill CUDA NDArrays in place (draws "
        "= the tensor path's); += after record() keeps the graph (grad %s); "
        "TopKAccuracy(2) %.2f; save/load_ndarray_list bf16 + fp32 bit for "
        "bit; eval:step spans %d for 3 EvalStep calls" % (
            len(filled), grad, top.get()[1], len(spans_)))
    return dict(initializers=filled, grad_after_write=grad,
                top2=top.get()[1], list_round_trip_bitwise=True,
                eval_step_spans=len(spans_))


#: op -> (optimizer, its arguments, the op's arguments, number of states,
#: the optimizer's state from the op's states, fp32 masters)
UPDATE_OPS = {
    "sgd_update": ("sgd", {}, {}, 0, lambda s: None, False),
    "sgd_mom_update": ("sgd", dict(momentum=0.9), dict(momentum=0.9), 1,
                       lambda s: s[0], False),
    "mp_sgd_update": ("sgd", {}, {}, 0, lambda s: None, True),
    "mp_sgd_mom_update": ("sgd", dict(momentum=0.9), dict(momentum=0.9), 1,
                          lambda s: s[0], True),
    "nag_mom_update": ("nag", dict(momentum=0.9), dict(momentum=0.9), 1,
                       lambda s: s[0], False),
    "mp_nag_mom_update": ("nag", dict(momentum=0.9), dict(momentum=0.9), 1,
                          lambda s: s[0], True),
    "adam_update": ("adam", {}, {}, 2, tuple, False),
    "rmsprop_update": ("rmsprop", dict(gamma1=0.9), dict(gamma1=0.9), 1,
                       tuple, False),
    "rmspropalex_update": ("rmsprop", dict(gamma1=0.9, gamma2=0.8,
                                           centered=True),
                           dict(gamma1=0.9, gamma2=0.8), 3, tuple, False),
    "ftrl_update": ("ftrl", dict(lamda1=0.01), dict(lamda1=0.01), 2, tuple,
                    False),
    "ftml_update": ("ftml", {}, dict(t=3), 3, tuple, False),
    "signum_update": ("signum", dict(momentum=0.9, wd_lh=0.01),
                      dict(momentum=0.9, wd_lh=0.01), 1, lambda s: s[0],
                      False),
}


def check_update_ops():
    """Each *_update operator whose formula is an optimizer's against that
    optimizer's Optimizer.update_all on the card, three steps from the
    same weight and states (fp16 weights with fp32 masters for mp_*):
    weights and states bit for bit. Then multi_mp_sgd_mom_update (host
    learning rates) and preloaded_multi_mp_sgd_mom_update (device arrays),
    and a LARS chain (multi_sum_sq, multi_lars, multi_all_finite), each
    captured in a CUDA graph and replayed three times against three eager
    calls: bit for bit. Returns the number of operators held."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch import optimizer as topt
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)

    def rand(*shape, scale=1.0, positive=False):
        t = torch.randn(*shape, device=dev, generator=gen) * scale
        return t.abs() + 0.1 if positive else t

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    lr, wd, rescale, t = 0.05, 0.01, 0.5, 3
    held = []
    for name, (opt_name, okw, kw, n_states, state_of, mp) in \
            UPDATE_OPS.items():
        opt = topt.create(opt_name, learning_rate=lr, wd=wd,
                          multi_precision=mp, **okw)
        dt = torch.float16 if mp else torch.float32
        w0 = rand(513, 257).to(dt)
        st0 = [rand(513, 257, scale=0.1, positive=True)
               for _ in range(n_states)]
        if n_states == 3 and opt_name == "rmsprop":
            st0[1] = st0[1] * 0.1
        grads = [rand(513, 257).to(dt) for _ in range(3)]
        w_opt, st_opt = w0.clone(), [s.clone() for s in st0]
        master_opt = w0.float()
        w_op = nd.NDArray(w0.clone())
        st_op = [nd.NDArray(s.clone()) for s in st0]
        master_op = nd.NDArray(w0.float())
        step_lr = lr
        if name == "adam_update":
            step_lr = f32([lr]) * torch.sqrt(1 - opt.beta2 ** f32(t)) \
                / (1 - opt.beta1 ** f32(t))
        for g in grads:
            state = state_of(st_opt)
            opt.update_all([w_opt], [g], [(master_opt, state) if mp
                                          else state],
                           f32([lr]), f32([wd]),
                           t if name == "ftml_update" else f32(t),
                           f32(rescale), use_master=[mp])
            args = st_op + ([master_op] if mp else [])
            getattr(nd, name)(w_op, nd.NDArray(g), *args, lr=step_lr, wd=wd,
                              rescale_grad=rescale, **kw)
        check(torch.equal(w_op._data, w_opt)
              and all(torch.equal(a._data, b)
                      for a, b in zip(st_op, st_opt))
              and (not mp or torch.equal(master_op._data, master_opt)),
              "%s on the card != %s's update_all" % (name, opt_name))
        held.append(name)

    def graph_equals_eager(what, make):
        """``make()`` -> (fn, tensors): fn's three replays from a capture
        against three eager calls on a copy of the tensors."""
        fn, tensors = make()
        copies = [x.clone() for x in tensors]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        scratch = [x.clone() for x in tensors]
        with torch.cuda.stream(side):
            fn(scratch)                        # warm-up on scratch copies
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(tensors)
        for _ in range(3):
            graph.replay()
        for _ in range(3):
            fn(copies)
        torch.cuda.synchronize(dev)
        check(all(torch.equal(a, b) for a, b in zip(tensors, copies)),
              "%s: captured != eager over 3 steps" % what)
        held.append(what)

    shapes = [(300, 70), (1025,), (16, 8, 9)]

    def multi(preloaded):
        def make():
            ws = [rand(*sh).half() for sh in shapes]
            tensors = ws + [rand(*sh).half() for sh in shapes] + \
                [rand(*sh, scale=0.1) for sh in shapes] + \
                [w.float() for w in ws] + [f32([0.1, 0.05, 0.2]),
                                           f32([0.0, 0.01, 0.02])]

            def fn(ts):
                k = len(shapes)
                w, g, m, w32 = (ts[i * k:(i + 1) * k] for i in range(4))
                w, g, m, w32 = ([nd.NDArray(x) for x in part]
                                for part in (w, g, m, w32))
                if preloaded:
                    nd.preloaded_multi_mp_sgd_mom_update(
                        w, g, m, w32, nd.NDArray(ts[-2]),
                        nd.NDArray(ts[-1]), momentum=0.9,
                        rescale_grad=0.5)
                else:
                    nd.multi_mp_sgd_mom_update(
                        w, g, m, w32, [0.1, 0.05, 0.2], [0.0, 0.01, 0.02],
                        momentum=0.9, rescale_grad=0.5)
            return fn, tensors
        return make

    def lars():
        ws = [rand(*sh) for sh in shapes]
        gs = [rand(*sh) for sh in shapes]
        tensors = ws + gs + [f32([0.1, 0.2, 0.3]), f32([0.01] * 3),
                             torch.zeros(1, device=dev)]

        def fn(ts):
            k = len(shapes)
            w = [nd.NDArray(x) for x in ts[:k]]
            g = [nd.NDArray(x) for x in ts[k:2 * k]]
            wss = nd.multi_sum_sq(*w, num_arrays=k)
            gss = nd.multi_sum_sq(*g, num_arrays=k)
            nd.multi_lars(nd.NDArray(ts[-3]), wss, gss, nd.NDArray(ts[-2]),
                          eta=0.01, out=nd.NDArray(ts[-3]))
            nd.multi_all_finite(*g, num_arrays=k, out=nd.NDArray(ts[-1]))
            nd.multi_sgd_update(w, g, nd.NDArray(ts[-3]),
                                nd.NDArray(ts[-2]))
        return fn, tensors

    graph_equals_eager("multi_mp_sgd_mom_update", multi(False))
    graph_equals_eager("preloaded_multi_mp_sgd_mom_update", multi(True))
    graph_equals_eager("multi_sum_sq + multi_lars + multi_sgd_update", lars)
    log("update operators on the card: %d held bit for bit (against "
        "update_all, or captured against eager)" % len(held))
    return held


# -------------------------------------------------------------------- CTC

def ctc_synthetic(cfg, lengths, seed):
    """Utterances as train_ctc.py's synth_utterances makes them, at
    ``cfg``'s width: one fixed spectral pattern a class (shared by every
    utterance), each label's pattern plus noise held for its share of the
    utterance's frames, zeros past its length. Returns (features (B, T,
    mels), labels (B, L max) padded with -1, data lengths (B,)), numpy
    float32."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    patterns = onp.random.RandomState(1234).randn(
        cfg["classes"], cfg["mels"]).astype("float32")
    (d_lo, d_hi), (l_lo, l_hi) = lengths
    b, t = cfg["batch"], cfg["frames"]
    feats = onp.zeros((b, t, cfg["mels"]), "float32")
    labels = -onp.ones((b, l_hi), "float32")
    dls = rng.randint(d_lo, d_hi + 1, b)
    for i in range(b):
        n = rng.randint(l_lo, l_hi + 1)
        seq = rng.randint(0, cfg["classes"], n)
        cuts = onp.sort(rng.choice(onp.arange(1, dls[i]), n - 1,
                                   replace=False))
        owner = onp.searchsorted(cuts, onp.arange(dls[i]), side="right")
        feats[i, :dls[i]] = patterns[seq[owner]] + 0.3 * rng.randn(
            dls[i], cfg["mels"]).astype("float32")
        labels[i, :n] = seq
    return feats, labels, dls.astype("float32")


def ctc_model(cfg, ctx, seed):
    """train_ctc.py's network at ``cfg``'s width, Xavier from ``seed``."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.context import as_device
    g = mxt.gluon
    h = cfg["hidden"]
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(h, activation="relu", in_units=cfg["mels"],
                       flatten=False),
            g.rnn.LSTM(h, num_layers=cfg["layers"], layout="NTC",
                       bidirectional=True, input_size=h),
            g.nn.Dense(cfg["classes"] + 1, flatten=False, in_units=2 * h))
    net.initialize(mxt.init.Xavier(), ctx=ctx, generator=torch.Generator(
        as_device(ctx)).manual_seed(seed))
    return net


def ctc_flops(cfg):
    """Forward FLOP of a batch (2 per multiply-add): the two Dense layers
    and, a layer and direction, the LSTM's four gates over input and
    state; the CTC recursion is not counted."""
    b, t, h = cfg["batch"], cfg["frames"], cfg["hidden"]
    flops = 2 * b * t * cfg["mels"] * h + 2 * b * t * 2 * h * (
        cfg["classes"] + 1)
    for layer in range(cfg["layers"]):
        inp = h if layer == 0 else 2 * h
        flops += 2 * 2 * b * t * 4 * h * (inp + h)
    return flops


def _ctc_adam(net):
    import incubator_mxnet_tpu_torch as mxt
    return mxt.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": CTC_LR})


def check_ctc_small():
    """The CTC model at a small width (2 layers, hidden 32, T 40) on the
    card (cuDNN's RNN, TF32 off) against the CPU from the same weights:
    the loss and every gradient of a Gluon-loop step, then the loss and
    every weight after two SGD steps (Adam's g / sqrt(v) turns the last
    bits of a near-zero gradient into a whole step), each within
    CTC_SMALL_TOL of its largest value. Returns the worst relative
    difference of each."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.test_utils import _full_precision
    x, y, dl = ctc_synthetic(CTC_SMALL, CTC_SMALL_LENGTHS, 51)
    ref = ctc_model(CTC_SMALL, mxt.cpu(), 52)
    weights = mxt.to_numpy_params(ref)
    runs = []
    with _full_precision(True):
        for ctx in (mxt.cpu(), mxt.gpu(0)):
            net = ctc_model(CTC_SMALL, ctx, 52)
            mxt.from_jax_params(net, weights)
            loss_fn = mxt.gluon.loss.CTCLoss()
            trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1})
            args = [mxt.nd.array(a, ctx=ctx) for a in (x, y, dl)]
            got = {}
            for k in range(3):
                with mxt.autograd.record():
                    loss = loss_fn(net(args[0]), args[1], args[2])
                loss.backward()
                got["loss_%d" % k] = [loss.asnumpy()]
                if k == 0:
                    got["gradients"] = [p.grad().asnumpy() for p in
                                        net.collect_params().values()]
                if k < 2:
                    trainer.step(x.shape[0])
            got["weights"] = [p.data().asnumpy()
                              for p in net.collect_params().values()]
            runs.append(got)
    errs = {k: max(float(onp.abs(a - b).max())
                   / max(float(onp.abs(b).max()), 1e-30)
                   for a, b in zip(runs[1][k], runs[0][k]))
            for k in runs[0]}
    check(max(errs.values()) <= CTC_SMALL_TOL
          and all(onp.isfinite(a).all() for v in runs[1].values()
                  for a in v),
          "CTC model small: card vs CPU %s of the largest value" % errs)
    return errs


def _ctc_row(ms, host_ms, issue, idle, kernels, flops, losses, extra):
    import torch
    b, t = CTC["batch"], CTC["frames"]
    return dict(step_ms=ms, step_host_ms=host_ms, issue_ms=issue,
                frames_per_s=b * t / ms * 1e3,
                share_of_peak=3 * flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
                peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                losses=losses, top_kernels=kernels, **idle, **extra)


def train_ctc(net, inputs, init, flops):
    """The full-width CTC model three ways from the same weights: the
    captured TrainStep (a first step that captures, a replay, CTC_TIMED
    timed replays), its eager body (a step phase by phase, then
    CTC_EAGER_TIMED timed), and the hybridized Gluon loop (record,
    forward, CTCLoss, backward, Trainer.step; CTC_LOOP_STEPS). Each then
    one step under the profiler (its idle share and its split by kernel,
    from one trace: a step is ~60,000 device activities, and the profiler
    takes seconds for each trace) and 3 (eager: 1) issued with the card
    idle. Every loss finite, and each run's last loss below its first.
    Returns rows."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    params = list(net.collect_params().values())
    loss_fn = mxt.gluon.loss.CTCLoss()
    rows = {}

    def falling(what, losses):
        check(all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0],
              "CTC %s: losses %s (finite, falling)" % (what, losses))

    _reset(params, init)
    step = mxt.jit.TrainStep(net, loss_fn, _ctc_adam(net))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(*inputs)]
    capture_s = time.perf_counter() - t0
    losses.append(step(*inputs))
    got, ms, host_ms = _timed_steps(lambda: step(*inputs), CTC_TIMED)
    losses = [float(v._data.mean()) for v in losses + got]
    idle = device_idle_share(lambda: step(*inputs), steps=1, top=10)
    kernels = idle.pop("top_kernels")
    issue = issue_ms(lambda: step(*inputs))
    check(step.captures == 1, "CTC TrainStep: %d captures" % step.captures)
    falling("captured TrainStep", losses)
    rows["captured"] = _ctc_row(ms, host_ms, issue, idle, kernels, flops,
                                losses, dict(capture_step_s=capture_s))
    del step
    gc.collect()
    torch.cuda.empty_cache()

    _reset(params, init)
    step = mxt.jit.TrainStep(net, loss_fn, _ctc_adam(net))
    torch.cuda.reset_peak_memory_stats()
    losses = [_eager_step(step, *inputs)]
    phases = step_phases(step, *inputs)
    losses.append(phases.pop("loss"))
    got, ms, host_ms = _timed_steps(lambda: _eager_step(step, *inputs),
                                    CTC_EAGER_TIMED)
    losses = [float(v._data.mean()) for v in losses + got]
    idle = device_idle_share(lambda: _eager_step(step, *inputs), steps=1,
                             top=10)
    kernels = idle.pop("top_kernels")
    issue = issue_ms(lambda: _eager_step(step, *inputs), n=1)
    falling("eager body", losses)
    rows["eager"] = _ctc_row(ms, host_ms, issue, idle, kernels, flops,
                             losses, dict(step_phases_ms=phases))
    del step
    gc.collect()
    torch.cuda.empty_cache()

    _reset(params, init)
    trainer = _ctc_adam(net)
    net.hybridize()
    x, y, dl = (mxt.nd.NDArray(a) for a in inputs)

    def round_():
        with mxt.autograd.record():
            loss = loss_fn(net(x), y, dl)
        loss.backward()
        trainer.step(x.shape[0])
        return loss
    warm, timed = CTC_LOOP_STEPS
    torch.cuda.reset_peak_memory_stats()
    losses = [round_() for _ in range(warm)]
    got, ms, host_ms = _timed_steps(round_, timed)
    losses = [float(v.asnumpy().mean()) for v in losses + got]
    idle = device_idle_share(round_, steps=1, top=10)
    kernels = idle.pop("top_kernels")
    issue = issue_ms(round_, n=1)
    falling("Gluon loop", losses)
    rows["gluon_loop"] = _ctc_row(ms, host_ms, issue, idle, kernels, flops,
                                  losses, dict(captures=net._captures))
    net.hybridize(False)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def ctc_loss_alone():
    """ops.ctc's forward + backward on the model's logits shape (T 800 x N
    32 x C 29, labels up to 120, blank last) against
    torch.nn.functional.ctc_loss on the same log-probabilities (a
    yardstick, not on the port's path): the finite losses within
    CTC_LOSS_TOL relative, the card's against the CPU's within it too;
    each timed eagerly (CUDA events, CTC_LOSS_ITERS calls), the port's
    also replayed from a CUDA graph (its device time without the host's
    launches). Returns a row."""
    import numpy as onp
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.ctc import ctc_loss
    t, n, c = CTC["frames"], CTC["batch"], CTC["classes"] + 1
    _, labels, dls = ctc_synthetic(dict(CTC, mels=1), (CTC_DATA_LENGTHS,
                                                       CTC_LABEL_LENGTHS), 61)
    dev = torch.device("cuda", 0)
    x = torch.randn(t, n, c, device=dev, generator=torch.Generator(
        dev).manual_seed(62), requires_grad=True)
    lab = torch.from_numpy(labels).to(dev)
    dl = torch.from_numpy(dls).to(dev)
    ll = (lab >= 0).sum(1)

    def port():
        x.grad = None
        loss = ctc_loss(x, lab, dl, None, "last")
        loss.sum().backward()
        return loss

    def library():
        x.grad = None
        logp = torch.log_softmax(x, -1)
        loss = F.ctc_loss(logp, lab.clamp_min(0).long(), dl.long(), ll,
                          blank=c - 1, reduction="none", zero_infinity=False)
        loss.sum().backward()
        return loss
    mine, theirs = port().detach(), library().detach()
    finite = torch.isfinite(theirs)
    rel = float(((mine - theirs).abs() / theirs.abs())[finite].max())
    check(bool(finite.all()) and rel <= CTC_LOSS_TOL,
          "CTC loss: ops.ctc against F.ctc_loss %.3g relative (%d finite)"
          % (rel, int(finite.sum())))
    with torch.no_grad():
        cpu = ctc_loss(x.detach().cpu(), lab.cpu(), dl.cpu(), None, "last")
    card_vs_cpu = float(((mine.cpu() - cpu).abs() / cpu.abs()).max())
    check(card_vs_cpu <= CTC_LOSS_TOL, "CTC loss card vs CPU %.3g relative"
          % card_vs_cpu)
    port_ms = timed_ms(port, CTC_LOSS_ITERS)
    lib_ms = timed_ms(library, CTC_LOSS_ITERS)
    launches = kernels_in(port)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        port()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    x.grad = None
    with torch.cuda.graph(graph):
        # a leaf of the capture's stream: autograd joins a gradient to its
        # leaf's stream, which must not be the default one here
        leaf = x.detach().requires_grad_()
        loss = ctc_loss(leaf, lab, dl, None, "last")
        grad, = torch.autograd.grad(loss.sum(), leaf)
    graph_ms = timed_ms(graph.replay, CTC_LOSS_ITERS)
    row = dict(shape=[t, n, c], max_label=int(lab.shape[1]),
               port_ms=port_ms, port_graph_ms=graph_ms, library_ms=lib_ms,
               port_device_activities=launches, rel_vs_library=rel,
               card_vs_cpu_rel=card_vs_cpu,
               mean_loss=float(mine.mean()))
    log("CTC loss alone (T %d x N %d x C %d, L <= %d, forward + backward): "
        "ops.ctc eager %.2f ms (%d device activities), replayed from a "
        "graph %.2f ms; F.ctc_loss %.2f ms; losses within %.3g relative, "
        "card vs CPU %.3g" % (t, n, c, lab.shape[1], port_ms, launches,
                              graph_ms, lib_ms, rel, card_vs_cpu))
    del graph, x
    gc.collect()
    torch.cuda.empty_cache()
    return row


def ctc_phase(card):
    """The CTC acoustic model of example/speech_recognition at DeepSpeech-2
    width (CTC): the small card = CPU check, the loss alone against
    F.ctc_loss, captured = eager bit for bit, then the captured TrainStep,
    its eager body and the hybridized Gluon loop. Returns (kernel launches
    over the main path, summary)."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    summary = dict(card=card, small_card_vs_cpu=check_ctc_small(),
                   loss_alone=ctc_loss_alone(),
                   config=dict(CTC, data_lengths=CTC_DATA_LENGTHS,
                               label_lengths=CTC_LABEL_LENGTHS,
                               optimizer="adam", lr=CTC_LR, dtype="float32",
                               blank="last"))
    feats, labels, dls = ctc_synthetic(CTC, (CTC_DATA_LENGTHS,
                                             CTC_LABEL_LENGTHS), 63)
    dev = torch.device("cuda", 0)
    inputs = [torch.from_numpy(a).to(dev) for a in (feats, labels, dls)]
    net = ctc_model(CTC, mxt.gpu(0), 64)
    params = list(net.collect_params().values())
    n_params = sum(p._tensor().numel() for p in params)
    flops = ctc_flops(CTC)
    init = [p._tensor().detach().clone() for p in params]
    summary.update(parameters=n_params, forward_tflop_per_step=flops / 1e12)
    summary["captured_equals_eager_steps"] = check_captured_equals_eager(
        net, mxt.gluon.loss.CTCLoss(), lambda: _ctc_adam(net), inputs, init,
        CTC_EXACT_STEPS, "CTC")
    _kernels.reset_launches()
    summary.update(train_ctc(net, inputs, init, flops))
    launches = dict(_kernels.LAUNCHES)
    check(not any(launches.values()), "CTC path launched hand-written "
          "kernels %s" % launches)
    cap, eag, loop = (summary["captured"], summary["eager"],
                      summary["gluon_loop"])
    log("CTC model (DeepSpeech-2 width: %d bins, %d x %d bidirectional LSTM, "
        "%d classes + blank, B %d x T %d fp32, %.1f M parameters, %.2f "
        "TFLOP a step forward): TrainStep captured %.1f ms (%.0f frames/s, "
        "%.2f%% of 989 TFLOP/s, issue %.2f ms, idle %.1f%%, peak %.1f GB "
        "allocated, %.1f reserved); eager body %.1f ms (issue %.1f ms, idle "
        "%.1f%%); Gluon loop hybridized %.1f ms (issue %.1f ms, idle "
        "%.1f%%); losses %.2f -> %.2f"
        % (CTC["mels"], CTC["layers"], CTC["hidden"], CTC["classes"],
           CTC["batch"], CTC["frames"], n_params / 1e6, flops / 1e12,
           cap["step_ms"], cap["frames_per_s"], 100 * cap["share_of_peak"],
           cap["issue_ms"], 100 * cap["idle_share"],
           cap["peak_allocated_gb"], cap["peak_reserved_gb"],
           eag["step_ms"], eag["issue_ms"], 100 * eag["idle_share"],
           loop["step_ms"], loop["issue_ms"], 100 * loop["idle_share"],
           cap["losses"][0], cap["losses"][-1]))
    del net, params, init, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


# ------------------------------------------------------- the symbolic API

MODULE_BATCHES = 3         # seeded host batches an epoch, repeated
MODULE_EPOCHS = 2
MODULE_TIMED = 3           # timed Module steps after fit (and split, issued)
MODULE_PREDICT_IMAGES = 300  # Module.predict at batch 256: a short last batch
MODULE_GLUON_STEPS = (2, 3)    # the Gluon yardstick: (warm-up, timed)
MODULE_SMALL_STEPS = 3
MODULE_SMALL_TOL = 1e-4    # card (TF32 off) vs CPU, fp32
MODULE_CKPT_IMAGES = 4     # images of the checkpoint's card = CPU check
MODULE_CKPT_TOL = 1e-4     # of the largest probability, TF32 off
MODULE_REC_IMAGES = 512    # JPEGs of the ImageRecordIter pass
MODULE_REC_BATCH = 128


def resnet_v1_symbol(sym, units, filters, num_classes, image_side,
                     bn_mom=0.9):
    """MXNet's example/image-classification/symbols/resnet-v1.py with
    bottleneck units, built with the port's mx.sym: the stride on each
    stage's first 1x1 convolution, a projection shortcut where the shape
    changes, BatchNorm (fix_gamma False, eps 2e-5) after every convolution,
    global average pooling, one FullyConnected and SoftmaxOutput. A
    224-pixel input takes the 7x7/2 stem and a 3x3/2 max pool, a side of 32
    or less the 3x3/1 stem."""
    def bn(x, name):
        return sym.BatchNorm(x, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name=name)

    def unit(x, nf, stride, dim_match, name):
        mid = nf // 4
        y = sym.Convolution(x, num_filter=mid, kernel=(1, 1), stride=stride,
                            pad=(0, 0), no_bias=True, name=name + "_conv1")
        y = sym.Activation(bn(y, name + "_bn1"), act_type="relu",
                           name=name + "_relu1")
        y = sym.Convolution(y, num_filter=mid, kernel=(3, 3), stride=(1, 1),
                            pad=(1, 1), no_bias=True, name=name + "_conv2")
        y = sym.Activation(bn(y, name + "_bn2"), act_type="relu",
                           name=name + "_relu2")
        y = sym.Convolution(y, num_filter=nf, kernel=(1, 1), stride=(1, 1),
                            pad=(0, 0), no_bias=True, name=name + "_conv3")
        y = bn(y, name + "_bn3")
        if dim_match:
            short = x
        else:
            short = bn(sym.Convolution(x, num_filter=nf, kernel=(1, 1),
                                       stride=stride, no_bias=True,
                                       name=name + "_conv1sc"), name + "_sc")
        return sym.Activation(y + short, act_type="relu", name=name + "_relu3")

    body = sym.var("data")
    if image_side <= 32:
        body = sym.Convolution(body, num_filter=filters[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
        body = sym.Activation(bn(body, "bn0"), act_type="relu", name="relu0")
    else:
        body = sym.Convolution(body, num_filter=filters[0], kernel=(7, 7),
                               stride=(2, 2), pad=(3, 3), no_bias=True,
                               name="conv0")
        body = sym.Activation(bn(body, "bn0"), act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", name="pool0")
    for i, n in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        body = unit(body, filters[i + 1], stride, False,
                    "stage%d_unit1" % (i + 1))
        for j in range(n - 1):
            body = unit(body, filters[i + 1], (1, 1), True,
                        "stage%d_unit%d" % (i + 1, j + 2))
    body = sym.Pooling(body, global_pool=True, kernel=(7, 7), pool_type="avg",
                       name="pool1")
    body = sym.FullyConnected(sym.Flatten(body), num_hidden=num_classes,
                              name="fc1")
    return sym.SoftmaxOutput(body, name="softmax")


def _module_data(n, side, classes, seed):
    """n images (float32 NCHW, standard normal noise) and labels uniform
    over ``classes``, from ``seed``: ImageNet's first steps as far as the
    gradients go (no two samples alike)."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    x = rng.standard_normal((n, 3, side, side), dtype=onp.float32)
    return x, rng.integers(0, classes, n).astype("float32")


def _xavier():
    import incubator_mxnet_tpu_torch as mxt
    # example/image-classification/common/fit.py's initializer
    return mxt.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)


def _sgd_params(lr=0.1):
    # fit.py: SGD, momentum 0.9, wd 1e-4 (rescale_grad 1/batch by Module)
    return {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4}


class _TF32:
    """TF32 for cuDNN's convolutions and cuBLAS's products on or off
    inside the block, restored after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        import torch
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


def _module_steps(mod, it, n):
    """``n`` training steps of ``mod`` over ``it``: the outputs of each."""
    outs = []
    it.reset()
    for _, batch in zip(range(n), it):
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return outs


def check_module_small():
    """A small symbolic ResNet v1 (2 stages of one bottleneck unit, 16 and
    32 wide, 32x32 inputs, 10 classes) through 3 Module steps on the card
    and on the CPU, TF32 off, from the same Xavier draw (the Module draws
    on the host from nd.random's CPU generator): every step's outputs and
    the parameters and moving statistics after within MODULE_SMALL_TOL of
    the largest value."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    x, y = _module_data(24, 32, 10, 71)
    got = []
    for ctx in (mxt.gpu(0), mxt.cpu()):
        mxt.random.seed(72)
        sym = resnet_v1_symbol(mxt.sym, (1, 1), (16, 16, 32), 10, 32)
        mod = mxt.mod.Module(sym, context=ctx)
        it = mxt.io.NDArrayIter(x, y, batch_size=8)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(_xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params=_sgd_params())
        with _TF32(False):
            outs = _module_steps(mod, it, MODULE_SMALL_STEPS)
        arg, aux = mod.get_params()
        got.append((outs, {k: v.asnumpy() for k, v in
                           list(arg.items()) + list(aux.items())}))
    worst = 0.0
    for (a, b) in zip(got[0][0], got[1][0]):
        worst = max(worst, _max_rel(a, b))
    for k, v in got[1][1].items():
        worst = max(worst, _max_rel(got[0][1][k], v))
    check(worst <= MODULE_SMALL_TOL, "small Module card vs CPU: %.3g of the "
          "largest value (tolerance %g)" % (worst, MODULE_SMALL_TOL))
    check(all(onp.isfinite(o).all() for o in got[0][0]),
          "small Module: an output is not finite")
    return dict(steps=MODULE_SMALL_STEPS, max_rel_err=worst,
                tol=MODULE_SMALL_TOL, params=len(got[1][1]))


def check_bucketing_small():
    """A BucketingModule over two bucket keys: Embedding → reshape →
    FullyConnected → SoftmaxOutput (sym_gen of the sequence length, labels
    one per token), 3 SGD steps on the keys 12, 20, 12. Every bucket must
    hold the default bucket's parameter tensors, gradients and optimizer
    states (one parameter set), every loss be finite, and the steps equal
    the same module on the CPU within MODULE_SMALL_TOL."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    vocab, dim, classes, batch = 50, 16, 8, 4

    def sym_gen(seq_len):
        S = mxt.sym
        e = S.Embedding(S.var("data"), input_dim=vocab, output_dim=dim,
                        name="embed")
        fc = S.FullyConnected(S.reshape(e, shape=(-1, dim)),
                              num_hidden=classes, name="fc")
        label = S.reshape(S.var("softmax_label"), shape=(-1,))
        return S.SoftmaxOutput(fc, label, name="softmax"), ("data",), \
            ("softmax_label",)

    rng = onp.random.RandomState(73)
    keys = (12, 20, 12)
    batches = [(rng.randint(0, vocab, (batch, k)).astype("float32"),
                rng.randint(0, classes, (batch, k)).astype("float32"))
               for k in keys]
    runs = []
    for ctx in (mxt.gpu(0), mxt.cpu()):
        mxt.random.seed(74)
        bm = mxt.mod.BucketingModule(sym_gen, default_bucket_key=12,
                                     context=ctx)
        desc = mxt.io.DataDesc
        bm.bind([desc("data", (batch, 12))],
                [desc("softmax_label", (batch, 12))])
        bm.init_params(mxt.init.Xavier())
        bm.init_optimizer(optimizer="sgd", optimizer_params=_sgd_params(0.5))
        losses = []
        with _TF32(False):
            for k, (d, l) in zip(keys, batches):
                b = mxt.io.DataBatch(
                    [mxt.nd.array(d, ctx=mxt.cpu())],
                    [mxt.nd.array(l, ctx=mxt.cpu())], bucket_key=k,
                    provide_data=[desc("data", (batch, k))],
                    provide_label=[desc("softmax_label", (batch, k))])
                bm.forward(b, is_train=True)
                bm.backward()
                bm.update()
                p = bm.get_outputs()[0].asnumpy()
                losses.append(float(-onp.log(
                    p[onp.arange(p.shape[0]), l.ravel().astype(int)]).mean()))
        runs.append((bm, losses))
    bm, losses = runs[0]
    a, b = bm._buckets[12], bm._buckets[20]
    shared = all(a._exec.arg_dict[n] is b._exec.arg_dict[n]
                 and a._exec.grad_dict[n] is b._exec.grad_dict[n]
                 for n in ("embed_weight", "fc_weight", "fc_bias")) \
        and a._updater_states is b._updater_states
    check(shared, "BucketingModule: the buckets do not share one parameter "
          "set")
    check(all(math.isfinite(v) for v in losses), "BucketingModule: a loss "
          "is not finite: %s" % losses)
    err = max(_max_rel(onp.array(losses), onp.array(runs[1][1])),
              max(_max_rel(v.asnumpy(), runs[1][0].get_params()[0][k]
                           .asnumpy())
                  for k, v in bm.get_params()[0].items()))
    check(err <= MODULE_SMALL_TOL, "BucketingModule card vs CPU: %.3g" % err)
    return dict(keys=list(keys), losses=losses, shared_parameter_set=shared,
                max_rel_err_vs_cpu=err)


def check_image_record_iter(tmp):
    """ImageRecordIter over JPEGs: the native pipeline (tier 1, C++ decode)
    where g++ builds it, as in the JAX package. Where PIL imports, write
    MODULE_REC_IMAGES 256x256 JPEGs (and the .idx) and time one pass at
    batch MODULE_REC_BATCH (rand_crop to 224, rand_mirror, mean/std, 8
    decode threads); else say it did not run."""
    try:
        import PIL
    except ImportError:
        log("module phase: ImageRecordIter pass NOT RUN: PIL does not "
            "import on this machine")
        return dict(pil=False, ran=False)
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    rec = os.path.join(tmp, "images.rec")
    rng = onp.random.RandomState(75)
    t0 = time.perf_counter()
    w = mxt.recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "w")
    for i in range(MODULE_REC_IMAGES):
        img = rng.randint(0, 256, (256, 256, 3)).astype("uint8")
        w.write_idx(i, mxt.recordio.pack_img(
            mxt.recordio.IRHeader(0, float(i % 1000), i, 0), img,
            quality=90))
    w.close()
    write_s = time.perf_counter() - t0
    it = mxt.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, 224, 224),
        batch_size=MODULE_REC_BATCH, shuffle=True, rand_crop=True,
        rand_mirror=True, mean_r=123.68, mean_g=116.28, mean_b=103.53,
        std_r=58.395, std_g=57.12, std_b=57.375, preprocess_threads=8)
    t0 = time.perf_counter()
    n = 0
    for b in it:
        n += b.data[0].shape[0] - b.pad
        check(b.data[0].shape == (MODULE_REC_BATCH, 3, 224, 224)
              and b.data[0].context == mxt.cpu()
              and bool(onp.isfinite(b.data[0].asnumpy()).all()),
              "ImageRecordIter: batch %s on %s" % (b.data[0].shape,
                                                   b.data[0].context))
    pass_s = time.perf_counter() - t0
    check(n == MODULE_REC_IMAGES, "ImageRecordIter: %d images" % n)
    return dict(pil=PIL.__version__, ran=True, images=n, tier=it.tier,
                batch=MODULE_REC_BATCH, write_s=write_s, pass_s=pass_s,
                images_per_s=n / pass_s, decode_threads=8)


def _module_loss(mod, labels):
    """Mean cross-entropy of the last forward's softmax at ``labels``, each
    probability floored at 1e-12 as MXNet's CrossEntropy metric does (on
    the card; one host read)."""
    import torch
    p = mod.get_outputs()[0]._data.detach()
    lbl = torch.as_tensor(labels, device=p.device).long()
    picked = p[torch.arange(p.shape[0], device=p.device), lbl]
    return float(-torch.log(picked.clamp_min(1e-12)).mean())


def _module_split(mod, batch, n):
    """Device ms of forward, backward and update (CUDA events around each,
    the medians of ``n`` steps)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = {"forward": [], "backward": [], "update": []}
    for _ in range(n):
        ev[0].record()
        mod.forward(batch, is_train=True)
        ev[1].record()
        mod.backward()
        ev[2].record()
        mod.update()
        ev[3].record()
        ev[3].synchronize()
        for j, k in enumerate(parts):
            parts[k].append(ev[j].elapsed_time(ev[j + 1]))
    return {k + "_ms": sorted(v)[n // 2] for k, v in parts.items()}


def train_module_resnet(tmp):
    """BASELINE config 2 through the symbolic API: MXNet's ResNet-50 v1
    symbol, B 256 x 3 x 224², 1000 classes, fp32 with TF32 on, trained by
    Module.fit (SGD momentum 0.9, wd 1e-4, lr 0.1, Xavier gaussian/in/2,
    the local kvstore) over MODULE_BATCHES seeded host batches for
    MODULE_EPOCHS epochs with Speedometer and do_checkpoint; then timed
    Module steps on the same batches. Returns (summary, the checkpoint
    prefix, the host batches)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt

    B, nb = RESNET_B, MODULE_BATCHES
    t0 = time.perf_counter()
    x, y = _module_data(B * nb, 224, 1000, 76)
    data_s = time.perf_counter() - t0
    sym = resnet_v1_symbol(mxt.sym, (3, 4, 6, 3), (64, 256, 512, 1024, 2048),
                           1000, 224)
    prefix = os.path.join(tmp, "resnet50_v1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = mxt.io.NDArrayIter(x, y, batch_size=B)
    mod = mxt.mod.Module(sym)               # context None: gpu(0)
    check(mod._context == mxt.gpu(0), "Module's default context is %s"
          % mod._context)
    t0 = time.perf_counter()
    mod.bind(it.provide_data, it.provide_label)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    n_params = sum(a.size for n, a in mod._exec.arg_dict.items()
                   if n in mod.param_names)
    mxt.random.seed(77)
    t0 = time.perf_counter()
    mod.init_params(_xavier())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, batch_ms = [], []
    speed = mxt.callback.Speedometer(B, frequent=1)
    clock = [None]

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if clock[0] is not None:
            batch_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        losses.append(_module_loss(mod, y[param.nbatch * B:
                                          (param.nbatch + 1) * B]))

    with _TF32(True):
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=MODULE_EPOCHS, optimizer="sgd",
                optimizer_params=_sgd_params(), initializer=_xavier(),
                batch_end_callback=[speed, on_batch],
                epoch_end_callback=mxt.callback.do_checkpoint(prefix))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        check(all(math.isfinite(v) for v in losses), "Module.fit resnet50: "
              "a loss is not finite: %s" % losses)
        first, second = losses[:nb], losses[nb:]
        check(sum(second) < sum(first) and losses[-1] < losses[0],
              "Module.fit resnet50: the losses did not fall over the "
              "repeated batches: %s" % losses)
        for e in range(1, MODULE_EPOCHS + 1):
            check(os.path.exists("%s-%04d.params" % (prefix, e)),
                  "do_checkpoint wrote no epoch %d file" % e)
        it.reset()
        batch = next(iter(it))
        _, step_ms, host_ms = _timed_steps(
            lambda: (mod.forward_backward(batch), mod.update()),
            MODULE_TIMED)
        split = _module_split(mod, batch, MODULE_TIMED)
        idle = device_idle_share(
            lambda: (mod.forward_backward(batch), mod.update()))
        issue = issue_ms(lambda: (mod.forward_backward(batch), mod.update()))
        torch.cuda.synchronize()
        predict = _module_predict_short_batch(mod, x, split["forward_ms"])
    img_s = B / (step_ms / 1e3)
    for n in mod.param_names:
        check(bool(torch.isfinite(mod._exec.arg_dict[n]._data).all()),
              "Module.fit resnet50: %s is not finite" % n)
    summary = dict(
        symbol="example/image-classification/symbols/resnet-v1.py, "
               "num_layers 50 (units 3/4/6/3, filters 64/256/512/1024/2048, "
               "bottleneck)",
        batch=[B, 3, 224, 224], classes=1000, dtype="float32", tf32=True,
        batches=nb, epochs=MODULE_EPOCHS, params=n_params,
        optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4,
        initializer="Xavier(gaussian, in, 2)", kvstore="local",
        data_setup_s=data_s, bind_s=bind_s, init_params_s=init_s, fit_s=fit_s,
        fit_batch_ms=batch_ms, losses=losses,
        speedometer_images_per_s=speed.last_speed,
        step_ms=step_ms, step_host_ms=host_ms, images_per_s=img_s,
        share_of_989_tflops=img_s * RESNET_FLOPS_PER_IMAGE / PEAK_BF16_FLOPS,
        issue_ms=issue, peak_allocated_gb=torch.cuda.max_memory_allocated()
        / 1e9, peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        predict_short_batch=predict, **split, **idle)
    log("Module.fit resnet50_v1 (symbolic, B %d x 3 x 224 x 224 fp32, TF32 "
        "on, %.1f M params): bind %.2f s; step %.1f ms (forward %.1f, "
        "backward %.1f, update %.1f device ms; host %.1f ms, issue %.1f ms, "
        "idle %.1f%%); %.0f img/s; %.2f%% of 989 TFLOP/s at 24.6 GFLOP/img; "
        "peak %.1f GB allocated, %.1f reserved; fit %.1f s for %d steps; "
        "losses %s" % (
            B, n_params / 1e6, bind_s, step_ms, split["forward_ms"],
            split["backward_ms"], split["update_ms"], host_ms, issue,
            100 * idle["idle_share"], img_s,
            100 * summary["share_of_989_tflops"],
            summary["peak_allocated_gb"], summary["peak_reserved_gb"],
            fit_s, len(losses), ["%.3f" % v for v in losses]))
    del mod, it, batch
    gc.collect()
    torch.cuda.empty_cache()
    return summary, prefix, (x, y)


def _module_predict_short_batch(mod, x, fit_forward_ms):
    """Module.predict of the trained net over an NDArrayIter of
    MODULE_PREDICT_IMAGES images at the bound batch (its last batch holds
    the rest plus padding), against one forward of the same images at
    their own batch, which rebinds the executor at that shape
    (``Executor._reshape``, timed between synchronisations; feeding the
    bound shape again takes its kept buffers back). The predict must give
    (images, 1000) rows equal to the forward's within rtol 2e-2 and atol
    2e-2 (two batch sizes may take other convolution algorithms, TF32 on).
    Returns a summary."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    n, B = MODULE_PREDICT_IMAGES, RESNET_B
    xs = x[:n]
    it = mxt.io.NDArrayIter(xs, batch_size=B)
    ex = mod._exec
    reshape_ms, real = [], ex._reshape

    def timed_reshape(fed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(fed)
        torch.cuda.synchronize()
        reshape_ms.append((time.perf_counter() - t0) * 1e3)
    ex._reshape = timed_reshape
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.predict(it)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        bound_reshapes = len(reshape_ms)
        mod.forward(mxt.io.DataBatch([mxt.nd.array(xs, ctx=mxt.gpu(0))]),
                    is_train=False)
        whole = mod.get_outputs()[0].asnumpy()
        it.reset()
        again = mod.predict(it)
    finally:
        del ex._reshape
    got = out.asnumpy()
    check(out.shape == again.shape == (n, 1000) and whole.shape == (n, 1000),
          "Module.predict over %d images at batch %d: %s, the forward at "
          "batch %d: %s" % (n, B, out.shape, n, whole.shape))
    check(bound_reshapes == 0 and len(reshape_ms) == 2, "Module.predict: "
          "%d reshapes at the bound batch, %d in all" % (bound_reshapes,
                                                        len(reshape_ms)))
    err = float((onp.abs(got - whole) - 2e-2 * onp.abs(whole)).max())
    check(err <= 2e-2 and onp.array_equal(got, again.asnumpy()),
          "Module.predict against the forward at batch %d: %.3g past rtol "
          "2e-2 (atol 2e-2)" % (n, err))
    rows = B * -(-n // B)
    summary = dict(images=n, batch=B, rows_computed=rows,
                   predict_s=predict_s, predict_images_per_s=n / predict_s,
                   predict_rows_per_s=rows / predict_s,
                   fit_forward_images_per_s=B / (fit_forward_ms / 1e3),
                   reshape_ms=reshape_ms[0], reshape_back_ms=reshape_ms[1],
                   max_abs_diff=float(onp.abs(got - whole).max()))
    log("Module.predict resnet50_v1 over %d images at batch %d (last batch "
        "%d + pad): %.0f img/s (%.0f rows/s; Module.fit's forward %.0f "
        "img/s); the forward at batch %d rebinds in %.2f ms (back to %d in "
        "%.2f ms), rows equal within %.3g [%s]" % (
            n, B, n % B, summary["predict_images_per_s"],
            summary["predict_rows_per_s"],
            summary["fit_forward_images_per_s"], n, reshape_ms[0], B,
            reshape_ms[1], summary["max_abs_diff"], _card_line()))
    return summary


def check_module_checkpoint(prefix, x):
    """The card's last checkpoint: Module.load on the CPU and on the card
    (inference binds of MODULE_CKPT_IMAGES images, TF32 off) give the same
    probabilities, and a Module over the loaded graph's fc1 node the same
    logits (the probabilities of a briefly trained net can saturate),
    within MODULE_CKPT_TOL of the largest; SymbolBlock.imports of it on the
    card equals the card Module's predict within 1e-5."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    n = MODULE_CKPT_IMAGES
    xs, ys = x[:n], onp.zeros(n, "float32")
    probs, logits = {}, {}
    with _TF32(False):
        for name, ctx in (("card", mxt.gpu(0)), ("cpu", mxt.cpu())):
            mod = mxt.mod.Module.load(prefix, MODULE_EPOCHS, context=ctx)
            it = mxt.io.NDArrayIter(xs, ys, batch_size=n)
            mod.bind(it.provide_data, it.provide_label, for_training=False)
            probs[name] = mod.predict(it).asnumpy()
            sym, arg, aux = mxt.load_checkpoint(prefix, MODULE_EPOCHS)
            fc1 = [s for s in sym.get_internals() if s.name == "fc1"][0]
            head = mxt.mod.Module(fc1, label_names=None, context=ctx)
            it = mxt.io.NDArrayIter(xs, batch_size=n)
            head.bind(it.provide_data, for_training=False)
            head.init_params(arg_params=arg, aux_params=aux)
            logits[name] = head.predict(it).asnumpy()
        blk = mxt.gluon.SymbolBlock.imports(
            prefix + "-symbol.json", ["data", "softmax_label"],
            "%s-%04d.params" % (prefix, MODULE_EPOCHS), ctx=mxt.gpu(0))
        with mxt.autograd.predict_mode():
            got = blk(mxt.nd.array(xs, ctx=mxt.gpu(0)),
                      mxt.nd.array(ys, ctx=mxt.gpu(0))).asnumpy()
    prob_err = _max_rel(probs["card"], probs["cpu"])
    logit_err = _max_rel(logits["card"], logits["cpu"])
    imports_err = _max_rel(got, probs["card"])
    check(max(prob_err, logit_err) <= MODULE_CKPT_TOL, "checkpoint loaded "
          "on the CPU: probabilities %.3g, logits %.3g of the card's largest"
          % (prob_err, logit_err))
    check(imports_err <= 1e-5, "SymbolBlock.imports against Module.predict: "
          "%.3g" % imports_err)
    return dict(images=n, cpu_vs_card_probabilities_max_rel=prob_err,
                cpu_vs_card_logits_max_rel=logit_err,
                largest_probability=float(probs["card"].max()),
                largest_logit=float(onp.abs(logits["card"]).max()),
                symbol_block_vs_predict_max_rel=imports_err)


def train_gluon_resnet_yardstick(x, y):
    """The same network as the port's Gluon model_zoo resnet50_v1 (Xavier
    gaussian/in/2, fp32, TF32 on) through the eager Trainer loop (record,
    forward, SoftmaxCrossEntropyLoss, backward, Trainer.step with SGD
    momentum 0.9, wd 1e-4, lr 0.1), each batch copied from the same host
    arrays to the card: step ms, host ms, issue ms, idle share, peak
    memory."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    B = RESNET_B
    warm, timed = MODULE_GLUON_STEPS
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(78)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(_xavier(), ctx=mxt.gpu(0), generator=gen)
    xb = mxt.nd.array(x[:B], ctx=mxt.cpu())
    yb = mxt.nd.array(y[:B], ctx=mxt.cpu())
    with mxt.autograd.pause(train_mode=False):
        net(xb[:2].as_in_context(mxt.gpu(0)))
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd", _sgd_params())
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []

    def step():
        xd, yd = xb.as_in_context(mxt.gpu(0)), yb.as_in_context(mxt.gpu(0))
        with mxt.autograd.record():
            loss = loss_fn(net(xd), yd)
        loss.backward()
        trainer.step(B)
        losses.append(loss)

    with _TF32(True):
        for _ in range(warm):
            step()
        _, step_ms, host_ms = _timed_steps(step, timed)
        idle = device_idle_share(step)
        issue = issue_ms(step)
    means = [float(l._data.detach().mean()) for l in losses]
    check(all(math.isfinite(v) for v in means), "Gluon resnet50 yardstick: "
          "a loss is not finite: %s" % means)
    img_s = B / (step_ms / 1e3)
    row = dict(step_ms=step_ms, step_host_ms=host_ms, issue_ms=issue,
               images_per_s=img_s,
               share_of_989_tflops=img_s * RESNET_FLOPS_PER_IMAGE
               / PEAK_BF16_FLOPS, losses=means,
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               **idle)
    log("Gluon resnet50_v1 yardstick (eager Trainer loop, B %d fp32, TF32 "
        "on): step %.1f ms (host %.1f, issue %.1f, idle %.1f%%); %.0f img/s; "
        "peak %.1f GB allocated" % (B, step_ms, host_ms, issue,
                                    100 * idle["idle_share"], img_s,
                                    row["peak_allocated_gb"]))
    del net, trainer, losses, xb, yb
    gc.collect()
    torch.cuda.empty_cache()
    return row


def module_phase(card):
    """The symbolic API and Module.fit (``module_phase``): the small card
    = CPU Module check, the BucketingModule, ImageRecordIter, ResNet-50 v1
    through Module.fit at BASELINE config 2's shape, its checkpoint on the
    CPU and through SymbolBlock.imports, and the Gluon yardstick. Returns
    (kernel launches over the main path, summary)."""
    import shutil
    import torch
    from incubator_mxnet_tpu_torch.ops import _kernels
    tmp = _build_tmp()
    try:
        summary = dict(card=card, small_card_vs_cpu=check_module_small(),
                       bucketing=check_bucketing_small(),
                       image_record_iter=check_image_record_iter(tmp))
        _kernels.reset_launches()
        summary["resnet50"], prefix, (x, y) = train_module_resnet(tmp)
        launches = dict(_kernels.LAUNCHES)
        check(not any(launches.values()), "the Module path launched "
              "hand-written kernels %s" % launches)
        summary["checkpoint"] = check_module_checkpoint(prefix, x)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["gluon_yardstick"] = train_gluon_resnet_yardstick(x, y)
    del x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


# MXNet's example/rnn/bucketing/lstm_bucketing.py (apache/incubator-mxnet
# v1.6) at its published defaults: 2 x mx.rnn.LSTMCell(200), embed 200,
# buckets 10-60, batch 32, SGD lr 0.01 momentum 0 wd 1e-5, Xavier(in, 2.34),
# Perplexity(invalid_label 0); PTB's vocabulary of 10,000 (PTB is not in
# the repository: a seeded Zipf corpus stands in)
BUCKETING = dict(num_hidden=200, num_embed=200, num_layers=2, vocab=10000,
                 batch=32, buckets=(10, 20, 30, 40, 50, 60),
                 invalid_label=0, lr=0.01, momentum=0.0, wd=1e-5)
BUCKETING_SENTENCES = 1600     # lengths 1-60: 8 batches a bucket, one epoch
BUCKETING_DISP = 8             # Speedometer's window (the script's 50 > epoch)
BUCKETING_TIMED = 3            # timed steps a bucket after fit
BUCKETING_PROFILED = 2         # steps at bucket 60 under the profiler
BUCKETING_SMALL_STEPS = 3
BUCKETING_SMALL_TOL = 1e-4     # card (TF32 off) vs CPU, fp32
BUCKETING_CKPT_TOL = 1e-4      # checkpoint on the CPU vs the card, TF32 off


def zipf_sentences(n, vocab, max_len, seed):
    """``n`` sentences of lengths uniform over 1..``max_len``, their ids
    drawn from a Zipf law (rank r with weight 1/r) over 1..vocab-1, id 0
    being the invalid label."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    lengths = rng.randint(1, max_len + 1, n)
    p = 1.0 / onp.arange(1, vocab)
    ids = rng.choice(vocab - 1, int(lengths.sum()), p=p / p.sum()) + 1
    cuts = onp.cumsum(lengths)[:-1]
    return [s.tolist() for s in onp.split(ids, cuts)]


def lstm_bucketing_sym_gen(R, S, stack, vocab, num_embed, num_hidden):
    """lstm_bucketing.py's sym_gen over ``stack`` (mx.rnn cells) with the
    port's mx.rnn ``R`` and mx.sym ``S``."""
    def sym_gen(seq_len):
        data = S.var("data")
        label = S.var("softmax_label")
        embed = S.Embedding(data=data, input_dim=vocab, output_dim=num_embed,
                            name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = S.reshape(outputs, shape=(-1, num_hidden))
        pred = S.FullyConnected(data=pred, num_hidden=vocab, name="pred")
        label = S.reshape(label, shape=(-1,))
        pred = S.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _bucketing_sgd(lr):
    return {"learning_rate": lr, "momentum": BUCKETING["momentum"],
            "wd": BUCKETING["wd"]}


def _shares_one_set(bm, names):
    """Whether every bound bucket holds the default bucket's parameter
    tensors, gradients and optimizer states."""
    base = bm._buckets[bm._default_bucket_key]
    return all(m._exec.arg_dict[n] is base._exec.arg_dict[n]
               and m._exec.grad_dict[n] is base._exec.grad_dict[n]
               for m in bm._buckets.values() if m.binded for n in names) \
        and all(m._updater_states is base._updater_states
                for m in bm._buckets.values() if m.binded)


def check_bucketing_cells_small():
    """The legacy cells through BucketingModule, on the card and on the
    CPU from the same Xavier draw, TF32 off: a 2-layer LSTMCell stack, a
    2-layer FusedRNNCell (dropout 0) and a GRUCell, each BUCKETING_SMALL_
    STEPS SGD steps over the keys 9, 6, 9. Losses and parameters within
    BUCKETING_SMALL_TOL of the largest value; the buckets share one
    parameter set."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    vocab, embed, hidden, batch, keys = 40, 12, 16, 4, (9, 6, 9)

    def lstm_stack(R):
        s = R.SequentialRNNCell()
        for i in range(2):
            s.add(R.LSTMCell(hidden, prefix="lstm_l%d_" % i))
        return s

    cells = {"lstm_stack": lstm_stack,
             "fused_lstm": lambda R: R.FusedRNNCell(
                 hidden, num_layers=2, mode="lstm", dropout=0.0,
                 prefix="fused_"),
             "gru": lambda R: R.GRUCell(hidden, prefix="gru_")}
    rng = onp.random.RandomState(82)
    batches = [(rng.randint(1, vocab, (batch, k)).astype("float32"),
                rng.randint(0, vocab, (batch, k)).astype("float32"))
               for k in keys]
    desc = mxt.io.DataDesc
    out = {}
    for name, make in cells.items():
        runs = []
        for ctx in (mxt.gpu(0), mxt.cpu()):
            mxt.random.seed(83)
            bm = mxt.mod.BucketingModule(
                lstm_bucketing_sym_gen(mxt.rnn, mxt.sym, make(mxt.rnn),
                                       vocab, embed, hidden),
                default_bucket_key=9, context=ctx)
            bm.bind([desc("data", (batch, 9))],
                    [desc("softmax_label", (batch, 9))])
            bm.init_params(mxt.init.Xavier(factor_type="in",
                                           magnitude=2.34))
            bm.init_optimizer(optimizer="sgd",
                              optimizer_params=_bucketing_sgd(0.5))
            losses = []
            with _TF32(False):
                for k, (d, l) in zip(keys, batches):
                    b = mxt.io.DataBatch(
                        [mxt.nd.array(d, ctx=mxt.cpu())],
                        [mxt.nd.array(l, ctx=mxt.cpu())], bucket_key=k,
                        provide_data=[desc("data", (batch, k))],
                        provide_label=[desc("softmax_label", (batch, k))])
                    bm.forward(b, is_train=True)
                    bm.backward()
                    bm.update()
                    p = bm.get_outputs()[0].asnumpy()
                    losses.append(float(-onp.log(p[onp.arange(
                        p.shape[0]), l.ravel().astype(int)]).mean()))
            params = {k: v.asnumpy() for k, v in bm.get_params()[0].items()}
            runs.append((bm, losses, params))
        (bm, losses, params), (_, cpu_losses, cpu_params) = runs
        shared = _shares_one_set(bm, list(params))
        check(shared, "small %s: the buckets do not share one parameter "
              "set" % name)
        check(all(math.isfinite(v) for v in losses), "small %s: a loss is "
              "not finite: %s" % (name, losses))
        err = max([_max_rel(onp.array(losses), onp.array(cpu_losses))]
                  + [_max_rel(params[k], cpu_params[k]) for k in params])
        check(err <= BUCKETING_SMALL_TOL, "small %s card vs CPU: %.3g of the "
              "largest value (tolerance %g)" % (name, err,
                                                BUCKETING_SMALL_TOL))
        out[name] = dict(losses=losses, max_rel_err_vs_cpu=err,
                         params=sorted(params), shared_parameter_set=shared)
    log("bucketing, small cells card vs CPU (%d steps, keys %s, TF32 off): "
        "%s" % (BUCKETING_SMALL_STEPS, list(keys),
                {k: "%.2g" % v["max_rel_err_vs_cpu"] for k, v in out.items()}))
    return dict(steps=BUCKETING_SMALL_STEPS, keys=list(keys),
                tol=BUCKETING_SMALL_TOL, cells=out)


def _bucket_batch(it, key):
    """The first batch of bucket ``key`` in ``it``'s order."""
    it.reset()
    return next(b for b in it if b.bucket_key == key)


def check_bucketing_checkpoint(bm, stack_gen, prefix, it):
    """The epoch's checkpoint (do_rnn_checkpoint: the current bucket's
    symbol and the parameters) through load_rnn_checkpoint into a Module on
    the CPU: its probabilities for one batch of that bucket equal the
    card's (TF32 off) within BUCKETING_CKPT_TOL of the largest."""
    import incubator_mxnet_tpu_torch as mxt
    key = bm._curr_bucket_key
    sym, arg, aux = mxt.rnn.load_rnn_checkpoint(stack_gen(), prefix, 1)
    batch = _bucket_batch(it, key)
    with _TF32(False):
        bm.forward(batch, is_train=False)
        card = bm.get_outputs()[0].asnumpy()
    mod = mxt.mod.Module(sym, context=mxt.cpu())
    mod.bind(batch.provide_data, batch.provide_label, for_training=False)
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.forward(batch, is_train=False)
    cpu = mod.get_outputs()[0].asnumpy()
    err = _max_rel(card, cpu)
    check(err <= BUCKETING_CKPT_TOL, "bucketing checkpoint on the CPU vs the "
          "card: %.3g of the largest probability" % err)
    return dict(bucket=key, params=len(arg), max_rel_err=err,
                largest_probability=float(card.max()))


def _hf_net(mxt):
    """A small MLP in MXNet's ``hybrid_forward`` idiom (F is nd)."""
    class HFNet(mxt.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc1 = mxt.gluon.nn.Dense(64, in_units=32)
                self.fc2 = mxt.gluon.nn.Dense(10, in_units=64)

        def hybrid_forward(self, F, x):
            h = F.relu(self.fc1(x))
            return self.fc2(F.tanh(h) * 0.5 + h)
    return HFNet()


def check_profiled_capture():
    """A captured TrainStep over a hybridized hybrid_forward block while
    the profiler runs with profile_imperative: the capture succeeds, no
    operator event comes from it or from its replays (the events after
    the steps are those of the one eager first step), and its losses and
    weights equal the eager body's bit for bit (that run profiled too)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import profiler
    rng = onp.random.RandomState(84)
    x = torch.from_numpy(rng.randn(16, 32).astype("float32")).cuda()
    y = torch.from_numpy(rng.randint(0, 10, 16).astype("float32")).cuda()
    runs = {}
    for mode in ("eager", "captured"):
        net = _hf_net(mxt)
        net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                       generator=torch.Generator(device="cuda:0")
                       .manual_seed(85))
        net.hybridize()
        step = mxt.jit.TrainStep(
            net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
            mxt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}))
        profiler.dumps(reset=True)
        with profiler._LOCK:
            profiler._EVENTS.clear()
        profiler.set_state("run")
        losses, events = [], []
        try:
            for _ in range(SMALL_CAPTURED_STEPS):
                losses.append((step(x, y)._data if mode == "captured"
                               else _eager_step(step, x, y)._data).clone())
                torch.cuda.synchronize()
                events.append(sum(1 for e in profiler._EVENTS
                                  if e["name"].startswith("op:")))
        finally:
            profiler.set_state("stop")
        runs[mode] = (losses, events, mxt.to_numpy_params(net),
                      step.captures)
    (el, ee, ep, _), (cl, ce, cp, captures) = runs["eager"], \
        runs["captured"]
    per_step = ee[0]
    check(captures == 1, "profiled capture: %d captures, expected 1"
          % captures)
    check(per_step > 0 and ee == [per_step * (i + 1)
                                  for i in range(len(ee))],
          "profiled eager body: op events %s" % ee)
    check(ce == [per_step] * len(ce), "profiled capture: op events %s, "
          "expected the eager first step's %d only" % (ce, per_step))
    check(all(torch.equal(a, b) for a, b in zip(cl, el)),
          "profiled capture: captured losses differ from eager")
    bad = [k for k in ep if not onp.array_equal(ep[k], cp[k])]
    check(not bad, "profiled capture: weights differ from eager: %s" % bad)
    return dict(captures=captures, op_events_per_eager_step=per_step,
                op_events_captured_run=ce, bitwise_equal=True,
                steps=len(cl))


def train_bucketing_lm(tmp):
    """MXNet's bucketing LSTM LM (BUCKETING) through BucketingModule.fit
    for one epoch over a seeded Zipf corpus (BUCKETING_SENTENCES
    sentences, so every bucket binds), fp32 with TF32 on, Speedometer
    (auto_reset False, as the script) and do_rnn_checkpoint; then each
    bucket's step timed, the bucket-60 step's issue ms and idle share, and
    the profiler's cost there. Returns (summary, the sym_gen's stack
    maker, prefix, iterator, module)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import profiler
    cfg = BUCKETING
    B, V, H = cfg["batch"], cfg["vocab"], cfg["num_hidden"]
    t0 = time.perf_counter()
    sents = zipf_sentences(BUCKETING_SENTENCES, V, max(cfg["buckets"]), 86)
    it = mxt.rnn.BucketSentenceIter(
        sents, B, buckets=list(cfg["buckets"]),
        invalid_label=cfg["invalid_label"],
        generator=onp.random.RandomState(87))
    data_s = time.perf_counter() - t0

    def stack_gen():
        stack = mxt.rnn.SequentialRNNCell()
        for i in range(cfg["num_layers"]):
            stack.add(mxt.rnn.LSTMCell(num_hidden=H, prefix="lstm_l%d_" % i))
        return stack

    stack = stack_gen()
    bm = mxt.mod.BucketingModule(
        lstm_bucketing_sym_gen(mxt.rnn, mxt.sym, stack, V, cfg["num_embed"],
                               H),
        default_bucket_key=it.default_bucket_key)     # context None: gpu(0)
    bind_s = {}
    bind, switch = bm.bind, bm.switch_bucket

    def timed(fn, key):
        def call(*args, **kwargs):
            new = key(*args) not in bm._buckets or \
                not bm._buckets[key(*args)].binded
            t = time.perf_counter()
            fn(*args, **kwargs)
            torch.cuda.synchronize()
            if new:
                bind_s[key(*args)] = time.perf_counter() - t
        return call
    bm.bind = timed(bind, lambda *a: bm._default_bucket_key)
    bm.switch_bucket = timed(switch, lambda k, *a: k)

    metric = mxt.metric.Perplexity(cfg["invalid_label"])
    windows, marks = [], [(0.0, 0)]

    def window(param):
        if param.nbatch and param.nbatch % BUCKETING_DISP == 0:
            s, n = float(metric.sum_metric), int(float(metric.num_inst))
            windows.append(math.exp((s - marks[-1][0]) / (n - marks[-1][1])))
            marks.append((s, n))
    speed = mxt.callback.Speedometer(B, BUCKETING_DISP, auto_reset=False)
    prefix = os.path.join(tmp, "lstm_bucketing")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mxt.random.seed(88)
    with _TF32(True):
        t0 = time.perf_counter()
        bm.fit(it, eval_metric=metric, kvstore="local", optimizer="sgd",
               optimizer_params=_bucketing_sgd(cfg["lr"]),
               initializer=mxt.init.Xavier(factor_type="in",
                                           magnitude=2.34),
               num_epoch=1, batch_end_callback=[window, speed],
               epoch_end_callback=mxt.rnn.do_rnn_checkpoint(stack, prefix))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    s, n = float(metric.sum_metric), int(float(metric.num_inst))
    if n > marks[-1][1]:
        windows.append(math.exp((s - marks[-1][0]) / (n - marks[-1][1])))
    steps = len(it.idx)
    slots = sum(B * it.buckets[i] for i, _ in it.idx)
    # the share of the token slots a step computes that hold a real token
    fill = sum(int(onp.count_nonzero(d)) for d in it.data) / \
        sum(d.size for d in it.data)
    check(all(math.isfinite(v) for v in windows), "bucketing LM: a "
          "window's perplexity is not finite: %s" % windows)
    check(windows[-1] < windows[0], "bucketing LM: perplexity did not fall "
          "over the epoch: %s" % windows)
    check(sorted(bind_s) == sorted(cfg["buckets"]), "bucketing LM: bound "
          "buckets %s" % sorted(bind_s))
    names = list(bm.get_params()[0])
    shared = _shares_one_set(bm, names)
    check(shared, "bucketing LM: the buckets do not share one parameter set")
    check(os.path.exists("%s-0001.params" % prefix), "do_rnn_checkpoint "
          "wrote no epoch 1 file")
    base = bm._buckets[bm._default_bucket_key]
    for n_ in names:
        check(bool(torch.isfinite(base._exec.arg_dict[n_]._data).all()),
              "bucketing LM: %s is not finite" % n_)
    n_params = sum(base._exec.arg_dict[n_].size for n_ in names)
    ckpt = check_bucketing_checkpoint(bm, stack_gen, prefix, it)

    per_bucket = {}
    with _TF32(True):
        for key in cfg["buckets"]:
            batch = _bucket_batch(it, key)

            def step(batch=batch):
                bm.forward_backward(batch)
                bm.update()
            step()
            _, ms, host = _timed_steps(step, BUCKETING_TIMED)
            per_bucket[key] = dict(step_ms=ms, host_ms=host,
                                   tokens_per_s=B * key / (ms / 1e3),
                                   bind_s=bind_s[key])
        top = max(cfg["buckets"])
        batch = _bucket_batch(it, top)

        def step60():
            bm.forward_backward(batch)
            bm.update()
        issue = issue_ms(step60)
        idle = device_idle_share(step60)
        activities = kernels_in(step60)
        _, off_ms, off_host = _timed_steps(step60, BUCKETING_PROFILED)
        profiler.set_config(profile_imperative=True, profile_memory=True,
                            filename=os.path.join(tmp, "profile.json"))
        profiler.dumps(reset=True)
        with profiler._LOCK:
            profiler._EVENTS.clear()
        profiler.set_state("run")
        try:
            _, on_ms, on_host = _timed_steps(step60, BUCKETING_PROFILED)
        finally:
            profiler.set_state("stop")
        op_events = sum(1 for e in profiler._EVENTS
                        if e["name"].startswith("op:"))
        table = profiler.dumps(reset=True).splitlines()
        # the synchronise alone: the same with no memory sample an op
        profiler.set_config(profile_memory=False)
        profiler.set_state("run")
        try:
            _, sync_ms, _ = _timed_steps(step60, BUCKETING_PROFILED)
        finally:
            profiler.set_state("stop")
            profiler.set_config(profile_memory=True)
        profiler.dump()
        with open(os.path.join(tmp, "profile.json")) as f:
            trace = json.load(f)
        check(trace["traceEvents"] and "deviceMemory" in trace,
              "profiler.dump wrote no events")
        torch.cuda.synchronize()
    check(op_events > 0, "the profiler recorded no operator at bucket 60")
    summary = dict(
        config="example/rnn/bucketing/lstm_bucketing.py (MXNet v1.6) "
               "defaults: 2 x LSTMCell(200), embed 200, vocab 10000, batch "
               "32, buckets 10-60, SGD lr 0.01 mom 0 wd 1e-5, Xavier(in, "
               "2.34), Perplexity(0)",
        corpus="Zipf over ids 1-9999, %d sentences of 1-60 tokens "
               "(seeded; no PTB)" % BUCKETING_SENTENCES,
        dtype="float32", tf32=True, params=n_params, steps=steps,
        data_setup_s=data_s, fit_s=fit_s,
        fit_tokens_per_s=slots / fit_s, corpus_fill=fill,
        speedometer_samples_per_s=speed.last_speed,
        perplexity_windows=windows, window_batches=BUCKETING_DISP,
        shared_parameter_set=shared, bind_s=bind_s, per_bucket=per_bucket,
        bucket60=dict(issue_ms=issue, device_activities=activities,
                      step_ms_profiler_off=off_ms,
                      step_host_ms_profiler_off=off_host,
                      step_ms_profiler_on=on_ms,
                      step_host_ms_profiler_on=on_host,
                      step_ms_profiler_on_memory_off=sync_ms,
                      op_events_per_step=op_events / BUCKETING_PROFILED,
                      profiler_table_top=table[:8], **idle),
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        checkpoint=ckpt)
    log("bucketing LM (lstm_bucketing.py, %.2f M params, fp32 TF32 on): "
        "fit %.1f s for %d steps (%.0f token slots/s); bind s %s; "
        "perplexity windows %s; step ms by bucket %s; bucket 60: issue "
        "%.1f ms, idle %.1f%%, %d device activities, %.0f op events a step, "
        "step %.1f ms profiler off / %.1f on (%.1f without memory "
        "samples); peak %.2f GB allocated, %.2f reserved" % (
            n_params / 1e6, fit_s, steps, slots / fit_s,
            {k: round(v, 3) for k, v in bind_s.items()},
            ["%.1f" % v for v in windows],
            {k: round(v["step_ms"], 1) for k, v in per_bucket.items()},
            issue, 100 * idle["idle_share"], activities,
            op_events / BUCKETING_PROFILED, off_ms, on_ms, sync_ms,
            summary["peak_allocated_gb"], summary["peak_reserved_gb"]))
    log("profiler, top rows at bucket 60:\n" + "\n".join(table[:8]))
    return summary


def bucketing_phase(card):
    """The legacy API on the card (``--bucketing-only``): the small cells
    card = CPU through BucketingModule, MXNet's bucketing LSTM LM through
    BucketingModule.fit under Speedometer and do_rnn_checkpoint, its
    checkpoint on the CPU, the profiler's cost at bucket 60, and a capture
    under a running profiler. Returns (kernel launches over the main path,
    summary)."""
    import shutil
    import torch
    from incubator_mxnet_tpu_torch.ops import _kernels
    tmp = _build_tmp()
    try:
        summary = dict(card=card, small_cells=check_bucketing_cells_small())
        _kernels.reset_launches()
        summary["lstm_bucketing"] = train_bucketing_lm(tmp)
        launches = dict(_kernels.LAUNCHES)
        check(not any(launches.values()), "the bucketing path launched "
              "hand-written kernels %s" % launches)
        summary["profiled_capture"] = check_profiled_capture()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


SERVE_HTTP_S = 64          # the HTTP phase's item length (JSON replies)
SERVE_HTTP_REQUESTS = 8
EVAL_BUCKETS = (1, 2, 4, 8)
EVAL_REPLAYS = 3           # replays a bucket, counted against K1
EVAL_TIMED = 5             # replays and eager forwards timed at bucket 8
RELOAD_CLIENTS = 4
RELOAD_HEALTH_POLL_S = 0.02
#: the JAX package's generation defaults (config MXTPU_GEN_*)
GEN = dict(block_size=16, num_blocks=256, max_batch=8, prefill_len=64,
           max_tokens=128)
GEN_STREAMS = 8
GEN_DISCONNECT = (3, 5)    # (client, tokens read before it hangs up)
GEN_STEP_TIMED = 20        # decode graph replays timed a bucket


def release_graphs():
    """Drop every captured TrainStep/EvalStep/generation graph held by the
    port's process-wide AOT cache (with the parameters and memory pools
    they hold; a live step captures again at its next call), then collect
    and give cached memory back: between phases, so a phase's graphs do
    not sit in a later phase's memory peak."""
    import torch
    from incubator_mxnet_tpu_torch import aot
    aot.CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _serving_bert(seed, config=None):
    """Full-width BERT (``config``, by default BERT), bf16, flash
    attention, on the card."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    net = models.BERTModel(**(config or BERT))
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                   .Generator(device="cuda:0").manual_seed(seed))
    net.cast("bfloat16")
    return net


def _pct(values, q):
    from incubator_mxnet_tpu_torch.serving import percentile
    return percentile(sorted(values), q)


def check_captured_evalstep(bert):
    """Phase 20(a): jit.EvalStep on full-width BERT, buckets EVAL_BUCKETS
    at S 512: one capture a bucket (its ms), captured = eager bit for
    bit, flash_fwd launched 12 times a replay, no capture in steady
    state; a replay's device and host ms against the eager forward's at
    bucket 8. Returns (launches, summary)."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.ops import _kernels
    rng = onp.random.RandomState(20)
    xs = {b: torch.as_tensor(rng.randint(0, BERT["vocab_size"], (
        b, BERT_S)).astype("int32")).cuda() for b in EVAL_BUCKETS}
    step = jit.EvalStep(bert)
    c0 = jit._COMPILES.value(kind="eval")
    capture_ms, pool_mib = {}, {}
    for b in EVAL_BUCKETS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        step._run(xs[b])
        torch.cuda.synchronize()
        capture_ms[b] = (time.perf_counter() - t0) * 1e3
        # what the cache entry keeps reserved: its graph's private pool
        torch.cuda.empty_cache()
        pool_mib[b] = (torch.cuda.memory_reserved() - held) / 2 ** 20
    check(step.captures == len(EVAL_BUCKETS) and jit._COMPILES.value(
        kind="eval") == c0 + len(EVAL_BUCKETS),
        "EvalStep: %d captures for %d buckets" % (step.captures,
                                                  len(EVAL_BUCKETS)))
    for b in EVAL_BUCKETS:
        eager = step._forward([xs[b]], inference=True)
        captured = step._run(xs[b])
        check(captured.dtype == eager.dtype and torch.equal(captured, eager),
              "EvalStep bucket %d: captured differs from eager (max abs "
              "%.3g)" % (b, float((captured.float() - eager.float()).abs()
                                  .max())))
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for b in EVAL_BUCKETS:
        for _ in range(EVAL_REPLAYS):
            step._run(xs[b])
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    replays = EVAL_REPLAYS * len(EVAL_BUCKETS)
    check(launches.get("flash_fwd", 0) == BERT["num_layers"] * replays,
          "EvalStep: flash_fwd launched %d times in %d replays, expected "
          "%d" % (launches.get("flash_fwd", 0), replays,
                  BERT["num_layers"] * replays))
    check(step.captures == len(EVAL_BUCKETS) and jit._COMPILES.value(
        kind="eval") == c0 + len(EVAL_BUCKETS),
        "EvalStep captured in steady state")
    x8 = xs[EVAL_BUCKETS[-1]]
    rows = {}
    for name, fn in (("captured", lambda: step._run(x8)),
                     ("eager", lambda: step._forward([x8], inference=True)),
                     ("eager_2", lambda: step._forward([x8],
                                                       inference=True)),
                     ("captured_2", lambda: step._run(x8))):
        rows[name] = dict(device_ms=timed_ms(fn, EVAL_TIMED),
                          host_ms=issue_ms(fn, EVAL_TIMED))
    summary = dict(capture_ms=capture_ms, graph_pool_mib=pool_mib,
                   replays=replays,
                   flash_fwd_launches=launches.get("flash_fwd", 0),
                   bucket8=rows)
    log("serving_http: EvalStep captured = eager bit for bit at buckets %s;"
        " capture ms %s; graph pool MiB %s; bucket 8 replay %.3f ms device"
        " / %.3f ms host, eager %.3f / %.3f" % (
            list(EVAL_BUCKETS), {b: round(v, 1) for b, v in
                                 capture_ms.items()},
            {b: round(v, 1) for b, v in pool_mib.items()},
            rows["captured"]["device_ms"], rows["captured"]["host_ms"],
            rows["eager"]["device_ms"], rows["eager"]["host_ms"]))
    return launches, summary


def _registry_round(reg, name, rows):
    """Phase 5's serving round: CLIENTS threads each submit their share of
    ``rows`` at once and wait; -> sorted client latencies in ms."""
    lat, errors = [], []

    def client(c):
        try:
            t = time.perf_counter()
            reqs = [reg.submit(name, rows[i])
                    for i in range(c, len(rows), CLIENTS)]
            for r in reqs:
                r.result(600)
                lat.append((time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads) and not errors,
          "serving round on %r failed: %r" % (name, errors[:3]))
    return sorted(lat)


def _captured_against_eager(reg, rows):
    """The registry's BERT round captured and eager (jit._uses_graphs
    forced off), in turns C E E C; -> p50s and the lists."""
    from incubator_mxnet_tpu_torch import jit
    out = {}
    uses_graphs = jit._uses_graphs
    for i, mode in enumerate(("captured", "eager", "eager", "captured")):
        if mode == "eager":
            jit._uses_graphs = lambda device: False
        try:
            lat = _registry_round(reg, "bert", rows)
        finally:
            jit._uses_graphs = uses_graphs
        out["%s_%d" % (mode, i)] = dict(p50_ms=_pct(lat, 50),
                                        latency_ms=lat)
    log("serving_http: registry p50 ms %s" % {
        k: round(v["p50_ms"], 1) for k, v in out.items()})
    return out


def prewarmed_reload(reg, rows):
    """Phase 20(b): version 2 of BERT loaded with a warm_spec while
    RELOAD_CLIENTS clients keep submitting: no request fails, /healthz
    (the registry's health) stays healthy throughout, every capture of
    the reload runs on the warm thread (none on a batcher worker), and v1
    drains out. Returns (v2's net, summary)."""
    import numpy as onp
    from incubator_mxnet_tpu_torch.telemetry import flightrec
    v2_net = _serving_bert(seed=1)
    stop, errors, oks, health = threading.Event(), [], [0], []
    rng = onp.random.RandomState(21)

    def client(c):
        r = onp.random.RandomState(100 + c)
        while not stop.is_set():
            try:
                reg.predict("bert", rows[r.randint(len(rows))], timeout=600)
                oks[0] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
                return

    def poll():
        while not stop.is_set():
            health.append(reg.health()["status"])
            time.sleep(RELOAD_HEALTH_POLL_S)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(RELOAD_CLIENTS)]
    threads.append(threading.Thread(target=poll))
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        mark = max([ev["seq"] for ev in flightrec.snapshot()] or [0])
        t0 = time.perf_counter()
        v2 = reg.load("bert", v2_net,
                      warm_spec=[((BERT_S,), "int32")])
        warm_s = time.perf_counter() - t0
        served_before = oks[0]
        time.sleep(0.5)
        reg.unload("bert", version=v2 - 1, drain=True, timeout=600)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(600)
    check(not any(t.is_alive() for t in threads), "a reload client hung")
    check(not errors, "requests failed across the reload: %r" % errors[:3])
    check(set(health) == {"healthy"}, "health during the reload: %s"
          % sorted(set(health)))
    builds = [ev for ev in flightrec.snapshot() if ev["seq"] > mark
              and ev["event"] == "compile_begin"]
    threads_built = sorted({ev["thread"] for ev in builds})
    check(len(builds) == len(EVAL_BUCKETS)
          and threads_built == ["mxtpu-aot-warm-bert"],
          "the reload's captures ran on %s (%d captures), expected the warm "
          "thread only" % (threads_built, len(builds)))
    check(reg._entry("bert").describe()["versions"] == [v2],
          "bert versions after the reload: %s"
          % reg._entry("bert").describe()["versions"])
    got = reg.predict("bert", rows[0])[0]
    direct = _direct(v2_net, rows[0])
    check(float(onp.abs(got - direct).max()) <= 0.02 * float(
        onp.abs(direct).max()) + 1e-3, "bert v2 reply differs from v2's "
        "forward")
    summary = dict(warm_s=warm_s, requests=oks[0],
                   requests_before_load_returned=served_before,
                   health_samples=len(health), captures=len(builds))
    log("serving_http: hot reload warmed %d buckets in %.2f s on the warm "
        "thread under traffic; %d requests, none failed; health healthy in "
        "%d samples" % (len(builds), warm_s, oks[0], len(health)))
    return v2_net, summary


def _direct(net, row):
    """``net``'s own forward of one row, as a float32 numpy array."""
    from incubator_mxnet_tpu_torch import jit
    return jit.EvalStep(net)(row[None])[0].asnumpy()


WAIT_S = 120    # every wait of the HTTP sections (phases 20 and 21)


def _stuck(what):
    """Print every thread's stack (stderr) and fail naming the wait that
    ran out: a hang names itself long before the script's time limit."""
    import faulthandler
    faulthandler.dump_traceback(all_threads=True)
    raise SmokeFailure("%s did not finish within %d s (every thread's "
                       "stack is on stderr)" % (what, WAIT_S))


def _join(threads, what):
    """Join ``threads`` within WAIT_S in all, else ``_stuck(what)``."""
    end = time.monotonic() + WAIT_S
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    if any(t.is_alive() for t in threads):
        _stuck(what)


def _drain(numwatch, what):
    if not numwatch.shadow_drain(WAIT_S):
        _stuck(what)
    return True


@contextlib.contextmanager
def _hang_guard(what, seconds):
    """Past ``seconds``, print every thread's stack (stderr) and exit 1,
    naming the wait first: a thread that blocks holding the interpreter
    lock (a ``torch.profiler`` stop that never returned did) lets no
    Python timeout fire, only faulthandler's own thread. Then the
    script's 1100 s dump is armed again."""
    import faulthandler
    print("chip_smoke: waiting for %s (past %d s: every thread's stack, "
          "then exit 1)" % (what, seconds), file=sys.stderr, flush=True)
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        _arm_script_dump()


def _http(srv, method, path, payload=None, headers=None, timeout=WAIT_S):
    """-> (status, lower-cased headers, body bytes); a reply that does not
    come within ``timeout`` fails the phase (``_stuck``)."""
    import http.client
    import socket
    c = http.client.HTTPConnection(srv.host, srv.port, timeout=timeout)
    try:
        body = None if payload is None else (
            payload if isinstance(payload, bytes)
            else json.dumps(payload).encode("utf-8"))
        c.request(method, path, body, {"Content-Type": "application/json",
                                       **(headers or {})})
        r = c.getresponse()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                r.read())
    except (socket.timeout, TimeoutError):
        _stuck("HTTP %s %s" % (method, path.split("?")[0]))
    finally:
        c.close()


def http_front_end(reg, srv, net):
    """Phase 20(c): SERVE_HTTP_REQUESTS POSTs of one S SERVE_HTTP_S item
    each to /v1/models/bert64:predict from CLIENTS threads: each reply
    within 2% of the logit range of the registry's direct reply, the
    request id echoed; /metrics parses and carries mxtpu_requests_total;
    /debug/requests holds the requests with their device legs; /debug/aot
    lists the captured S 64 graphs; unknown model 404, malformed body 400.
    Returns (launches, summary)."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.serving import accesslog
    reg.load("bert64", net, max_batch_size=BERT_BUCKET, batch_timeout_ms=20,
             warm_spec=[((SERVE_HTTP_S,), "int32")])
    rng = onp.random.RandomState(22)
    rows = rng.randint(0, BERT["vocab_size"], (
        SERVE_HTTP_REQUESTS, SERVE_HTTP_S)).astype("int32")
    accesslog.reset()
    base = reg.metrics("bert64").batch_count
    torch.cuda.synchronize()
    _kernels.reset_launches()
    replies, lat, errors = {}, {}, []

    def client(c):
        try:
            for i in range(c, SERVE_HTTP_REQUESTS, CLIENTS):
                t = time.perf_counter()
                st, hdrs, body = _http(
                    srv, "POST", "/v1/models/bert64:predict",
                    {"inputs": [rows[i].tolist()], "dtype": "int32"},
                    {"X-Request-Id": "http-%d" % i})
                lat[i] = (time.perf_counter() - t) * 1e3
                check(st == 200, "HTTP predict %d: %d %s" % (i, st,
                                                            body[:200]))
                check(hdrs.get("x-request-id") == "http-%d" % i,
                      "X-Request-Id not echoed: %s" % hdrs)
                replies[i] = onp.asarray(json.loads(body)["outputs"][0],
                                         "float32")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(not any(t.is_alive() for t in threads) and not errors,
          "HTTP clients failed: %r" % errors[:3])
    batches = reg.metrics("bert64").batch_count - base
    # the HTTP path's launches alone, before the reference replies below
    launches = dict(_kernels.LAUNCHES)
    check(launches.get("flash_fwd", 0) == BERT["num_layers"] * batches,
          "HTTP path: flash_fwd launched %d times for %d batches"
          % (launches.get("flash_fwd", 0), batches))
    worst = 0.0
    for i in range(SERVE_HTTP_REQUESTS):
        direct = reg.predict("bert64", rows[i])[0]
        diff = float(onp.abs(replies[i] - direct).max())
        worst = max(worst, diff)
        check(replies[i].shape == (SERVE_HTTP_S, BERT["vocab_size"])
              and diff <= 0.02 * float(onp.abs(direct).max()) + 1e-3,
              "HTTP reply %d differs from the registry's by %.3g" % (i,
                                                                     diff))
    st, _h, text = _http(srv, "GET", "/metrics")
    samples = {}
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    check(st == 200 and any(k.startswith(
        'mxtpu_requests_total{model="bert64"') for k in samples),
        "/metrics carries no mxtpu_requests_total for bert64")
    st, _h, text = _http(srv, "GET", "/debug/requests?n=%d"
                         % (2 * SERVE_HTTP_REQUESTS))
    recs = [json.loads(ln) for ln in text.decode().splitlines()]
    mine = [r for r in recs if str(r["request_id"]).startswith("http-")]
    check(len(mine) == SERVE_HTTP_REQUESTS and all(
        r["code"] == 200 and r["device_ms"] is not None for r in mine),
        "/debug/requests: %d records of the HTTP requests" % len(mine))
    st, _h, body = _http(srv, "GET", "/debug/aot")
    entries = json.loads(body)["entries"]
    sigs = sorted({e["input_sig"][0][0][0] for e in entries
                   if e["kind"] == "eval"
                   and e["input_sig"][0][0][1] == SERVE_HTTP_S})
    check(sigs == list(EVAL_BUCKETS), "/debug/aot lists S %d graphs at "
          "buckets %s" % (SERVE_HTTP_S, sigs))
    st404 = _http(srv, "POST", "/v1/models/nope:predict",
                  {"inputs": [[1]]})[0]
    st400 = _http(srv, "POST", "/v1/models/bert64:predict", b"{oops")[0]
    check((st404, st400) == (404, 400), "unknown model %d, malformed "
          "body %d" % (st404, st400))
    encode = [r["latency_ms"] - r["queue_ms"] - r["batch_ms"] for r in mine]
    device = [r["device_ms"] for r in mine]
    t = time.perf_counter()
    json.dumps({"outputs": [replies[0].tolist()]})
    json_ms = (time.perf_counter() - t) * 1e3
    summary = dict(requests=SERVE_HTTP_REQUESTS, batches=batches,
                   wall_ms=wall_ms,
                   client_p50_ms=_pct(list(lat.values()), 50),
                   client_max_ms=max(lat.values()),
                   encode_ms=encode, device_ms=device,
                   one_reply_json_ms=json_ms,
                   served_vs_direct_max_abs=worst)
    log("serving_http: %d HTTP requests in %d batches, client p50 %.1f ms "
        "max %.1f; server legs p50 device %.1f ms, after-dispatch (JSON "
        "lists) %.1f ms; one reply's json.dumps %.1f ms"
        % (SERVE_HTTP_REQUESTS, batches, summary["client_p50_ms"],
           summary["client_max_ms"], _pct(device, 50), _pct(encode, 50),
           json_ms))
    return launches, summary


def _gen_requests(rng, sampled):
    reqs = []
    for i in range(GEN_STREAMS):
        n = int(rng.randint(4, GEN["prefill_len"]))
        reqs.append({"model": "tinylm", "prompt": rng.randint(
            1, 256, n).tolist(), "max_new_tokens": int(rng.randint(
                GEN["max_tokens"] // 2, GEN["max_tokens"] + 1)),
            "seed": int(rng.randint(1 << 30)),
            "temperature": 0.8 if sampled else 0.0,
            "top_k": 20 if sampled else 0})
    return reqs


def _gen_client(srv, body, hang_up_after=None):
    """One streaming POST /generate: (status, tokens, finish reason,
    seconds to each token line)."""
    import http.client
    c = http.client.HTTPConnection(srv.host, srv.port, timeout=WAIT_S)
    try:
        t0 = time.perf_counter()
        c.request("POST", "/generate", json.dumps(body).encode("utf-8"),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        if r.status != 200:
            return r.status, [], r.read().decode()[:200], []
        toks, stamps, reason = [], [], None
        while True:
            line = r.readline()
            if not line:
                break
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec.get("done"):
                reason = rec["reason"]
                r.read()              # the last chunk: a clean close
                break
            toks.append(rec["token"])
            stamps.append(time.perf_counter() - t0)
            if hang_up_after is not None and len(toks) >= hang_up_after:
                c.sock.close()
                return r.status, toks, "hung_up", stamps
        return r.status, toks, reason, stamps
    finally:
        c.close()


def generation(reg, srv):
    """Phase 20(d): GenerativeEngine over TinyLM at the JAX package's
    widths and defaults (GEN), served at POST /generate. A greedy round
    and a sampled round (T 0.8, top-k 20) of GEN_STREAMS concurrent
    streams, one client hanging up mid-stream in the greedy one: every
    other stream's tokens equal generate_sequential's for its seed, the
    greedy ones equal a CPU engine's for the same weights, the hang-up
    frees its blocks, and nothing captures (compile counter, gen:compile
    spans) after warm(). Then the decode graph's replay ms (every step
    runs it at max_batch rows), and the same step captured at one row
    (the price of that padding). Returns a summary."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.ops import kvcache
    from incubator_mxnet_tpu_torch.serving import generate
    from incubator_mxnet_tpu_torch.telemetry import spans
    kinds = ("serve", "decode")
    t0 = time.perf_counter()
    eng = reg.load_generator("tinylm", seed=0, **GEN)
    warm_s = time.perf_counter() - t0
    cpu = generate.GenerativeEngine(name="tinylm-cpu", seed=0,
                                    ctx=mxt.cpu(), **GEN)
    c0 = sum(jit._COMPILES.value(kind=k) for k in kinds)
    spans.reset()
    rng = onp.random.RandomState(23)
    rounds = {}
    try:
        for label, sampled in (("greedy", False), ("sampled", True)):
            reqs = _gen_requests(rng, sampled)
            refs = [eng.generate_sequential(
                r["prompt"], r["max_new_tokens"],
                temperature=r["temperature"], top_k=r["top_k"],
                seed=r["seed"]) for r in reqs]
            if not sampled:
                for r, ref in zip(reqs, refs):
                    want = cpu.generate_sequential(r["prompt"],
                                                   r["max_new_tokens"],
                                                   seed=r["seed"])
                    check(ref == want, "greedy tokens on the card differ "
                          "from the CPU's: %s vs %s" % (ref[0][:8],
                                                        want[0][:8]))
            got = [None] * GEN_STREAMS

            def client(i, reqs=reqs, sampled=sampled):
                hang = GEN_DISCONNECT[1] if (
                    not sampled and i == GEN_DISCONNECT[0]) else None
                got[i] = _gen_client(srv, reqs[i], hang)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(GEN_STREAMS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t
            check(not any(th.is_alive() for th in threads),
                  "a generate client hung")
            ttft, gaps, ntok = [], [], 0
            for i, (st, toks, reason, stamps) in enumerate(got):
                check(st == 200, "generate stream %d: %s %s" % (i, st,
                                                                reason))
                ntok += len(toks)
                if stamps:
                    ttft.append(stamps[0] * 1e3)
                    gaps += [(b - a) * 1e3 for a, b in zip(stamps,
                                                           stamps[1:])]
                if reason == "hung_up":
                    continue
                check((toks, reason) == refs[i], "%s stream %d: %s (%s) "
                      "differs from generate_sequential's %s (%s)"
                      % (label, i, toks[:8], reason, refs[i][0][:8],
                         refs[i][1]))
            deadline = time.monotonic() + 30
            while eng.kv_blocks()[0] and time.monotonic() < deadline:
                time.sleep(0.01)
            check(eng.kv_blocks()[0] == 0, "%d KV blocks still held after "
                  "the %s round" % (eng.kv_blocks()[0], label))
            rounds[label] = dict(
                tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
                ttft_p50_ms=_pct(ttft, 50),
                inter_token_p50_ms=_pct(gaps, 50),
                inter_token_p99_ms=_pct(gaps, 99))
        compiles = sum(jit._COMPILES.value(kind=k) for k in kinds) - c0
        compile_spans = [s for s in spans.snapshot()
                         if s["name"] == "gen:compile"]
        check(compiles == 0 and not compile_spans, "generation captured "
              "after warm(): %d builds, %d gen:compile spans"
              % (compiles, len(compile_spans)))
        # the decode graph alone, on an all-inactive batch
        prog = eng._decode_fn()
        prog(eng._packed([]))
        step_ms = timed_ms(prog.captured.graph.replay, GEN_STEP_TIMED)
        m = eng.model
        pool = kvcache.make_pool(GEN["num_blocks"], GEN["block_size"],
                                 m.LAYERS, m.HEADS, m.HEAD_DIM,
                                 device=eng.device)
        mb = eng.max_blocks
        packed = torch.as_tensor(eng._packed([])[:1]).cuda()

        def natural(p):
            col = p[:, mb:]
            nt, fin = m.decode_step(pool, p[:, :mb], col[:, 0], col[:, 1],
                                    col[:, 2], col[:, 3],
                                    col[:, 4].view(torch.float32),
                                    col[:, 5], col[:, 6] != 0)
            return [nt, fin]
        captured, _ = jit._capture(natural, [packed], "measure",
                                   tensors=m.tensors())
        natural_ms = timed_ms(captured.graph.replay, GEN_STEP_TIMED)
    finally:
        cpu.close()
    summary = dict(warm_s=warm_s, rounds=rounds, decode_step_ms=step_ms,
                   decode_one_row_ms=natural_ms,
                   pool_bytes=kvcache.pool_bytes(
                       GEN["num_blocks"], GEN["block_size"], m.LAYERS,
                       m.HEADS, m.HEAD_DIM))
    log("serving_http: generation (TinyLM, %s) warm %.2f s; greedy %s; "
        "sampled %s; decode step %.4f ms at %d rows (%.4f at one row)"
        % (GEN, warm_s, {k: round(v, 2) if isinstance(
            v, float) else v for k, v in rounds["greedy"].items()},
            {k: round(v, 2) if isinstance(v, float) else v
             for k, v in rounds["sampled"].items()},
            step_ms, GEN["max_batch"], natural_ms))
    return summary


def resilience(reg, srv, net):
    """Phase 20(e): a 2-replica BERT (S SERVE_HTTP_S) under a Supervisor;
    faultlab (armed over POST /debug/faults) kills one replica worker at
    batcher.dispatch: the request is retried once and answers 200,
    /healthz reads degraded while the replica is dead and healthy after
    the Supervisor respawns it. Returns a summary."""
    import numpy as onp
    from incubator_mxnet_tpu_torch.serving import Supervisor
    from incubator_mxnet_tpu_torch.serving import batcher as batcher_mod
    reg.load("bert-r2", net, max_batch_size=2, batch_timeout_ms=5,
             replicas=2, warm_spec=[((SERVE_HTTP_S,), "int32")])
    sup = Supervisor(reg, poll_s=0.02, backoff_base_s=0.5,
                     backoff_cap_s=1.0).start()
    row = onp.random.RandomState(24).randint(
        0, BERT["vocab_size"], SERVE_HTTP_S).astype("int32")
    statuses, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            st, _h, body = _http(srv, "GET", "/healthz", timeout=60)
            statuses.append(json.loads(body)["status"])
            time.sleep(0.01)
    poller = threading.Thread(target=poll)
    try:
        r0 = batcher_mod._RETRIES.value(model="bert-r2")
        st, _h, body = _http(srv, "POST", "/debug/faults", {
            "spec": "batcher.dispatch:replica_kill:stride=1:budget=1"})
        check(st == 200 and json.loads(body)["armed"], "arming faultlab "
              "over HTTP: %d %s" % (st, body[:200]))
        poller.start()
        t0 = time.perf_counter()
        st, _h, body = _http(srv, "POST", "/v1/models/bert-r2:predict",
                             {"inputs": [row.tolist()], "dtype": "int32"})
        retried_ms = (time.perf_counter() - t0) * 1e3
        check(st == 200, "the killed replica's request: %d %s"
              % (st, body[:200]))
        check(batcher_mod._RETRIES.value(model="bert-r2") == r0 + 1,
              "the request was not retried once")
        b = reg._entry("bert-r2").batcher
        deadline = time.monotonic() + 30
        while (b.dead_replicas() or "degraded" not in statuses) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)
    finally:
        stop.set()
        if poller.is_alive():
            poller.join(60)
        sup.stop()
    check(not b.dead_replicas(), "the supervisor did not respawn the "
          "replica: dead %s" % b.dead_replicas())
    check("degraded" in statuses and statuses[-1] == "healthy",
          "/healthz through the kill: %s" % sorted(set(statuses)))
    first_bad = statuses.index("degraded")
    healed = len(statuses) - 1 - statuses[::-1].index("degraded")
    summary = dict(retried_request_ms=retried_ms,
                   health_samples=len(statuses),
                   degraded_samples=statuses.count("degraded"),
                   healed_after_samples=healed - first_bad + 1)
    log("serving_http: replica killed, its request retried (%.1f ms), "
        "/healthz degraded for %d of %d samples, then healthy"
        % (retried_ms, summary["degraded_samples"], len(statuses)))
    return summary


def serving_http_phase(card):
    """Phase 20: the serving front end and generation on the card
    (``--serving-http-only``). Returns (launches of the HTTP path,
    summary)."""
    import numpy as onp
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.telemetry import faultlab
    t0 = time.perf_counter()
    bert = _serving_bert(seed=0)
    eval_launches, evalstep = check_captured_evalstep(bert)
    reg = serving.ModelRegistry()
    srv = None
    try:
        reg.load("bert", bert, max_batch_size=BERT_BUCKET,
                 batch_timeout_ms=50, warm_spec=[((BERT_S,), "int32")])
        rows = onp.random.RandomState(0).randint(
            0, BERT["vocab_size"], (BERT_REQUESTS, BERT_S)).astype("int32")
        latency = _captured_against_eager(reg, rows)
        v2, reload = prewarmed_reload(reg, rows)
        del bert
        srv = serving.ServingServer(reg, port=0).start()
        http_launches, front = http_front_end(reg, srv, v2)
        gen = generation(reg, srv)
        res = resilience(reg, srv, v2)
    finally:
        faultlab.disarm()
        if srv is not None:
            srv.stop()
        reg.close()
    summary = dict(card=card, evalstep=evalstep, registry_latency=latency,
                   hot_reload=reload, http=front, generation=gen,
                   resilience=res, eval_replay_launches=eval_launches,
                   seconds=time.perf_counter() - t0)
    return http_launches, summary


# --------------------------------------------------- phase 21: programs
PROGRAMS_B = 8              # the exported batch of the S 512 artifact
PROGRAMS_BUCKETS = (1, 8)   # 21(c)'s buckets on disk ((1, 2, 4, 8) before
#                             PR 21: a depth cut that makes room for 25(f))
PROGRAMS_REQUESTS = 16
PROGRAMS_TOL = 0.0          # the loaded program runs the live one's ops
PROGRAMS_HTTP_TOL = 0.02    # of the logit range (phase 20's HTTP contract)
PROFILE_HTTP_S = 12.0       # an HTTP round is seconds of JSON a reply
PROFILE_GEN_S = 2.0         # a decode step every ~1.5 ms

_SERVE_CHILD = r'''
import json, os, sys, threading, time
root, manifest, artifact, rows_path, ref_path = sys.argv[1:6]
sys.path.insert(0, root)
import numpy as onp
import torch
import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import aot, gluon, serving
from incubator_mxnet_tpu_torch.contrib import serving as cs
from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.telemetry import devstats
rows = onp.load(rows_path)
ref = torch.load(ref_path)                     # (n, S, V) bf16, the CPU
t0 = time.perf_counter()
block = gluon.SymbolBlock.imports(manifest, ["data"])
imports_s = time.perf_counter() - t0
got = block(mxt.nd.array(rows[:8], ctx=mxt.gpu(0), dtype="int32"))._data
imports_err = float((got.float() - ref[:8].cuda().float()).abs().max())
del block, got
t0 = time.perf_counter()
served = cs.load(artifact)
load_s = time.perf_counter() - t0
replays = [0]
run = served._run
def counted(*a, **k):
    replays[0] += 1
    return run(*a, **k)
served._run = counted
torch.cuda.reset_peak_memory_stats()
reg = serving.ModelRegistry()
t0 = time.perf_counter()
reg.load("bert", served, max_batch_size=8, batch_timeout_ms=50,
         warm_spec=[((rows.shape[1],), "int32")])
capture_s = time.perf_counter() - t0
replays[0] = 0
_kernels.reset_launches()
lat, replies = [None] * len(rows), [None] * len(rows)
def client(idx):
    for i in idx:
        t = time.perf_counter()
        replies[i] = reg.predict("bert", rows[i], timeout=600)[0]
        lat[i] = (time.perf_counter() - t) * 1e3
threads = [threading.Thread(target=client, args=(range(c, len(rows), 4),))
           for c in range(4)]
for t in threads: t.start()
for t in threads: t.join(600)
launches = dict(_kernels.LAUNCHES)
errs, exact = [], 0
for i, r in enumerate(replies):
    want = ref[i].float().numpy()
    errs.append(float(onp.abs(r - want).max()))
    exact += int(onp.array_equal(r, want))
entry = [e for e in aot.CACHE.snapshot() if e["kind"] == "serve"][0]
mfu = {"%s/%s/%s" % (l["model"], l["kind"], l["replica"]): v
       for l, v in devstats._MFU.series()}
reg.close()
print(json.dumps(dict(
    imports_s=imports_s, imports_max_abs_err=imports_err, load_s=load_s,
    capture_s=capture_s, replays=replays[0], launches=launches,
    p50_ms=sorted(lat)[len(lat) // 2], max_ms=max(lat),
    max_abs_err=max(errs), bit_for_bit=exact, requests=len(rows),
    stats=entry["stats"], mfu=mfu, dispatch=devstats.dispatch_totals(),
    hbm_capacity=devstats.hbm_capacity(),
    peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)))
'''

_ARTIFACT_CHILD = r'''
import hashlib, json, os, sys, time
root, rows_path, buckets = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
config = json.loads(sys.argv[5])
sys.path.insert(0, root)
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[4])))
import numpy as onp
import torch
import chip_smoke
from incubator_mxnet_tpu_torch import aot, jit, models
from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.telemetry import spans
bert = chip_smoke._serving_bert(seed=0, config=config)
forwards = [0]
forward = models.BERTModel.forward
def counted(self, *a, **k):      # on the class: the instance is untouched
    forwards[0] += 1
    return forward(self, *a, **k)
models.BERTModel.forward = counted
rows = torch.as_tensor(onp.load(rows_path)).cuda()
step = jit.EvalStep(bert)
torch.cuda.synchronize()
t0 = time.perf_counter()
for b in buckets:
    step(rows[:b])
torch.cuda.synchronize()
load_capture_s = time.perf_counter() - t0
_kernels.reset_launches()
out = step(rows[:max(buckets)])._data
torch.cuda.synchronize()
print(json.dumps(dict(
    hits=aot._ARTIFACT_HITS.value(kind="eval"),
    compiles=jit._COMPILES.value(kind="eval"), python_forwards=forwards[0],
    sources=[e["source"] for e in aot.CACHE.snapshot()],
    load_capture_s=load_capture_s, replay_launches=dict(_kernels.LAUNCHES),
    load_s=sum(r["dur_us"] for r in spans.snapshot()
               if r["name"] == "aot:load") / 1e6,
    out_sha256=hashlib.sha256(out.view(torch.int16).cpu().numpy()
                              .tobytes()).hexdigest())))
'''


def _child(script, *args, env=None):
    """Run ``script`` in a fresh interpreter beside this checkout; its last
    stdout line is JSON. Raises with its output if it fails."""
    r = subprocess.run([sys.executable, "-c", script, *args],
                       capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, **(env or {})))
    if r.returncode:
        raise SmokeFailure("a fresh process failed (exit %d):\n%s\n%s"
                           % (r.returncode, r.stdout[-3000:],
                              r.stderr[-6000:]))
    return json.loads(r.stdout.strip().splitlines()[-1])


def _forward_flops(net, b, s):
    """BERT's analytic forward FLOPs: one third of bench.py:358's training
    formula, 2·params·B·S + 4·L·B·S²·U."""
    params = sum(math.prod(p.shape) for p in net.collect_params().values())
    return 2 * params * b * s + 4 * BERT["num_layers"] * b * s * s \
        * BERT["units"]


def export_and_serve(bert, tmp, root):
    """Phase 21(a) and (b): HybridBlock.export of full-width BERT at B 8 x
    S 512 (seconds, MB), then a fresh process loads it through
    SymbolBlock.imports and contrib.serving.load and serves 16 requests
    from 4 threads through ModelRegistry (bucket 8); replies held to this
    process's direct forward, K1 = 12 x replays, and devstats' MFU of the
    bucket-8 replay against the analytic forward FLOPs (f)."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch import jit
    rng = onp.random.RandomState(21)
    rows = rng.randint(0, BERT["vocab_size"], (PROGRAMS_REQUESTS, BERT_S)) \
        .astype("int32")
    x = torch.as_tensor(rows[:PROGRAMS_B]).cuda()
    path = os.path.join(tmp, "bert")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bert.export(path, example_inputs=[x])
    export_s = time.perf_counter() - t0
    artifact = path + ".mxtpu"
    mb = os.path.getsize(artifact) / 1e6
    step = jit.EvalStep(bert)
    ref = torch.cat([step(torch.as_tensor(rows[i:i + PROGRAMS_B]).cuda())
                     ._data.cpu() for i in range(0, len(rows), PROGRAMS_B)])
    step.release()
    onp.save(os.path.join(tmp, "rows.npy"), rows)
    torch.save(ref, os.path.join(tmp, "ref.pt"))
    del ref
    got = _child(_SERVE_CHILD, root, path + "-symbol.json", artifact,
                 os.path.join(tmp, "rows.npy"), os.path.join(tmp, "ref.pt"))
    check(got["max_abs_err"] <= PROGRAMS_TOL and
          got["imports_max_abs_err"] <= PROGRAMS_TOL,
          "the loaded BERT's replies leave this process's forward: "
          "%.3g (registry), %.3g (SymbolBlock.imports)"
          % (got["max_abs_err"], got["imports_max_abs_err"]))
    check(got["launches"].get("flash_fwd", 0) == 12 * got["replays"]
          and got["replays"] > 0,
          "K1 launched %s times over %d replays of the loaded program, "
          "not 12 a replay" % (got["launches"].get("flash_fwd"),
                               got["replays"]))
    flops = _forward_flops(bert, PROGRAMS_B, BERT_S)
    counted = got["stats"]["flops"]
    check(0.5 <= counted / flops <= 1.5,
          "FlopCounterMode's %.4g FLOPs of the B 8 program are far from "
          "the analytic %.4g" % (counted, flops))
    mfu = got["mfu"].get("bert/serve/0")
    check(mfu is not None and 0 < mfu < 1,
          "devstats' MFU of the bucket-8 replay: %r" % (mfu,))
    got.update(export_s=export_s, artifact_mb=mb, analytic_flops=flops,
               flops_ratio=counted / flops, bucket8_mfu=mfu)
    return got, rows


def artifacts_in_a_fresh_process(bert, tmp, root, rows):
    """Phase 21(c): with MXTPU_AOT_CACHE_DIR set, EvalStep buckets
    PROGRAMS_BUCKETS built here (export, write, capture), then a fresh
    process gets an artifact hit a bucket and runs the net's Python
    forward 0 times; its bucket-8 replay is this process's bit for bit."""
    import hashlib
    import torch
    from incubator_mxnet_tpu_torch import aot, jit
    cache_dir = os.path.join(tmp, "aot")
    x = torch.as_tensor(rows).cuda()
    old = os.environ.get("MXTPU_AOT_CACHE_DIR")
    os.environ["MXTPU_AOT_CACHE_DIR"] = cache_dir
    w0 = aot._ARTIFACT_WRITES.value(kind="eval")
    try:
        step = jit.EvalStep(bert)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in PROGRAMS_BUCKETS:
            step(x[:b])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        out = step(x[:max(PROGRAMS_BUCKETS)])._data
        digest = hashlib.sha256(out.view(torch.int16).cpu().numpy()
                                .tobytes()).hexdigest()
        step.release()
    finally:
        if old is None:
            os.environ.pop("MXTPU_AOT_CACHE_DIR", None)
        else:
            os.environ["MXTPU_AOT_CACHE_DIR"] = old
    writes = aot._ARTIFACT_WRITES.value(kind="eval") - w0
    check(writes == len(PROGRAMS_BUCKETS), "%d artifacts written for %d "
          "buckets" % (writes, len(PROGRAMS_BUCKETS)))
    got = _child(_ARTIFACT_CHILD, root, os.path.join(tmp, "rows.npy"),
                 json.dumps(list(PROGRAMS_BUCKETS)),
                 os.path.abspath(__file__), json.dumps(BERT),
                 env={"MXTPU_AOT_CACHE_DIR": cache_dir})
    check(got["hits"] == len(PROGRAMS_BUCKETS)
          and got["python_forwards"] == 0,
          "the fresh process: %d artifact hits for %d buckets, %d Python "
          "forwards" % (got["hits"], len(PROGRAMS_BUCKETS),
                        got["python_forwards"]))
    check(got["replay_launches"].get("flash_fwd") == 12,
          "a loaded bucket-8 replay launched K1 %s times"
          % got["replay_launches"].get("flash_fwd"))
    check(got["out_sha256"] == digest,
          "the loaded bucket-8 program answers other bits than this "
          "process's")
    files = [f for _d, _s, fs in os.walk(cache_dir) for f in fs]
    got.update(build_s=build_s, writes=writes, files=len(files),
               artifact_mb=sum(os.path.getsize(os.path.join(d, f))
                               for d, _s, fs in os.walk(cache_dir)
                               for f in fs) / 1e6,
               bit_for_bit=True)
    return got


def _profile(srv, traffic, progress, seconds, batch_kernel=None):
    """GET /debug/profile?seconds= under ``traffic(stop)``. The traffic
    starts first, on its own threads, and the capture is asked for only
    once ``progress()`` (the path's batch or token count) has moved, so
    work is in flight when the window opens; ``progress`` must move again
    while the capture runs. With ``batch_kernel`` (a kernel the path
    launches 12 times a batch) the trace itself must hold at least two
    batches. Returns the capture's whole summary (GET /debug/hotspots
    ?capture=) reduced to the device's busy and idle share over the
    seconds the profiler recorded (the primary reading) and over the span
    of its device activity, and its top kernels. The call around the
    recording also starts, stops and exports the trace (``call_s``)."""
    stop = threading.Event()
    p0 = progress()
    threads = traffic(stop)
    try:
        deadline = time.monotonic() + 300
        while progress() == p0 and time.monotonic() < deadline:
            time.sleep(0.01)
        p1 = progress()
        check(p1 > p0, "the traffic made no progress in 300 s")
        with _hang_guard("GET /debug/profile?seconds=%g" % seconds,
                         WAIT_S + seconds):
            st, _h, body = _http(srv, "GET", "/debug/profile?seconds=%g"
                                 % seconds)
        p2 = progress()
    finally:
        stop.set()
        _join(threads, "the traffic threads of /debug/profile")
    check(st == 200, "/debug/profile answered %d: %s" % (st, body[:300]))
    check(p2 > p1, "the traffic made no progress during the capture")
    out = json.loads(body)
    st, _h, full = _http(srv, "GET", "/debug/hotspots?capture=%s"
                         % out["capture_id"])
    check(st == 200, "/debug/hotspots?capture= answered %d" % st)
    full = json.loads(full)
    busy = full["device_busy_us"]
    window = full["window_us"]
    traced_s = full["devstats"]["traced_s"]
    check(full["events"] > 0 and window > 0 and traced_s >= seconds,
          "the profile under traffic holds no device activity")
    traced = None
    if batch_kernel is not None:
        traced = sum(o["count"] for o in full["ops"]
                     if batch_kernel in o["op"]) / BERT["num_layers"]
        check(traced >= 2, "the profile under traffic holds %.3g batches "
              "(%s launches / %d), not at least 2"
              % (traced, batch_kernel, BERT["num_layers"]))
    # idle over the seconds the profiler recorded (the primary reading);
    # the call's wall time adds the session's start, stop and export
    return dict(idle_share=1.0 - busy / (traced_s * 1e6),
                busy_share=busy / (traced_s * 1e6), traced_s=traced_s,
                call_s=full["devstats"]["window_s"],
                asked_s=seconds, progress_during=p2 - p1,
                batches_traced=traced,
                idle_share_of_activity_span=full["device_idle_ratio"],
                activity_span_ms=window / 1e3, busy_ms=busy / 1e3,
                device_activities=full["events"],
                categories={c: round(v["share"], 4)
                            for c, v in full["categories"].items()},
                top=[dict(op=o["op"][:80], category=o["category"],
                          ms=o["self_us"] / 1e3, count=o["count"],
                          share=round(o["share"], 4))
                     for o in full["ops"][:8]],
                flash_fwd=[dict(rank=i + 1, op=o["op"][:40],
                                ms=o["self_us"] / 1e3, count=o["count"],
                                share=o["share"])
                           for i, o in enumerate(full["ops"])
                           if "flash_fwd" in o["op"]],
                capture_id=out["capture_id"])


def _gen_traffic(srv, rng):
    """``traffic(stop)`` for ``_profile``: GEN_STREAMS streaming clients of
    the registry's TinyLM ("tinylm"), each sending its request again until
    ``stop`` is set."""
    def traffic(stop):
        reqs = _gen_requests(rng, sampled=False)

        def loop(body):
            while not stop.is_set():
                _gen_client(srv, body)
        threads = [threading.Thread(target=loop, args=(b,)) for b in reqs]
        for t in threads:
            t.start()
        return threads
    return traffic


def _decoded():
    """The TinyLM's decoded tokens so far (``progress`` for ``_profile``)."""
    from incubator_mxnet_tpu_torch.serving import generate
    return sum(v for l, v in generate._TOKENS.series()
               if l.get("model") == "tinylm" and l.get("phase") == "decode")


def _bert_http_traffic(srv, rows):
    """``traffic(stop)`` for ``_profile``: CLIENTS clients of the
    registry's "bert", each posting its next row of ``rows`` until
    ``stop`` is set."""
    def traffic(stop):
        def loop(c):
            i = c
            while not stop.is_set():
                _http(srv, "POST", "/v1/models/bert:predict",
                      {"inputs": [rows[i % len(rows)].tolist()],
                       "dtype": "int32"})
                i += CLIENTS
        threads = [threading.Thread(target=loop, args=(c,))
                   for c in range(CLIENTS)]
        for t in threads:
            t.start()
        return threads
    return traffic


def profile_stress(card, n):
    """``--profile-stress N``: phase 21's profiles N times over under all
    of its traffic at once: BERT (S 64, B 8, every batch tapped, an fp32
    shadow comparing each) from CLIENTS HTTP clients and TinyLM
    generation from GEN_STREAMS streaming clients, each capture
    ``GET /debug/profile?seconds=PROFILE_GEN_S``; so captures start and
    stop while batches, shadow comparisons and decode steps launch on
    other threads. Every capture must answer with device activity; one
    that does not return within WAIT_S ends the process
    (``_hang_guard``)."""
    import copy
    import numpy as onp
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.telemetry import numwatch
    build_kernels()
    rng = onp.random.RandomState(22)
    rows = rng.randint(0, BERT["vocab_size"], (SERVE_HTTP_REQUESTS,
                                               SERVE_HTTP_S)).astype("int32")
    bert = _serving_bert(seed=0)
    fp32 = copy.deepcopy(bert)
    fp32.cast("float32")
    saved = os.environ.get("MXTPU_NUMWATCH_SAMPLE")
    os.environ["MXTPU_NUMWATCH_SAMPLE"] = "1"
    srv = serving.serve({"bert": bert}, port=0, max_batch_size=PROGRAMS_B,
                        batch_timeout_ms=20)
    busy = []
    t0 = time.perf_counter()
    try:
        srv.registry.register_shadow("bert", fp32, stride=1, threshold=1e9)
        srv.registry.load_generator("tinylm", seed=0, **GEN)
        bert_traffic = _bert_http_traffic(srv, rows)
        gen_traffic = _gen_traffic(srv, rng)

        def traffic(stop):
            return bert_traffic(stop) + gen_traffic(stop)
        for i in range(n):
            busy.append(_profile(srv, traffic, _decoded,
                                 PROFILE_GEN_S)["busy_share"])
            log("  profile stress: capture %d of %d, busy %.4f (%.1f s)"
                % (i + 1, n, busy[-1], time.perf_counter() - t0))
        _drain(numwatch, "the shadow worker's drain")
    finally:
        srv.stop()
        if saved is None:
            os.environ.pop("MXTPU_NUMWATCH_SAMPLE", None)
        else:
            os.environ["MXTPU_NUMWATCH_SAMPLE"] = saved
    return dict(card=card, captures=n, seconds=time.perf_counter() - t0,
                busy_share_min=min(busy), busy_share_max=max(busy))


def serve_artifact_over_http(bert, tmp):
    """Phase 21(d), (e), (g): ``serving.serve`` of an S 64 artifact (B 8)
    over HTTP, 8 requests from 4 threads within PROGRAMS_HTTP_TOL of the
    logit range of the direct forward, with every batch tapped
    (MXTPU_NUMWATCH_SAMPLE 1) and K1 = 12 x this path's batches; then a
    bf16-vs-fp32 shadow registered (after the counted window: its worker
    runs K1 too);
    /debug/profile under that traffic and under TinyLM generation traffic
    (8 streams): device busy and idle share and top kernels (K1 among the
    BERT ones), /debug/hotspots; /debug/numerics (the tap's finite
    fraction 1.0, the shadow's divergence, a faultlab NaN injection's
    storm episode), /debug/slo and /debug/history with this traffic's
    series. Returns (the parent's launches on this path, summary)."""
    import copy
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.contrib import serving as cs
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.telemetry import faultlab, history
    rng = onp.random.RandomState(22)
    rows = rng.randint(0, BERT["vocab_size"], (SERVE_HTTP_REQUESTS,
                                               SERVE_HTTP_S)).astype("int32")
    path = os.path.join(tmp, "bert64.mxtpu")
    cs.export_model(bert, [torch.as_tensor(rows[:PROGRAMS_B]).cuda()], path)
    direct = [_direct(bert, r) for r in rows]
    fp32 = copy.deepcopy(bert)
    fp32.cast("float32")
    saved = {k: os.environ.get(k) for k in ("MXTPU_NUMWATCH_SAMPLE",)}
    os.environ["MXTPU_NUMWATCH_SAMPLE"] = "1"
    history.reset()
    history.start(interval_s=0.25)
    srv = serving.serve({"bert": path}, port=0, max_batch_size=PROGRAMS_B,
                        batch_timeout_ms=20)
    out = {}
    try:
        # the counted window holds this path's own batches only: the
        # shadow (an fp32 BERT whose worker runs K1 after each reply) is
        # registered once its launches are read
        base = srv.registry.metrics("bert").batch_count
        _kernels.reset_launches()
        replies, lat = [None] * len(rows), [None] * len(rows)

        def client(idx):
            for i in idx:
                t = time.perf_counter()
                st, _h, body = _http(srv, "POST", "/v1/models/bert:predict",
                                     {"inputs": [rows[i].tolist()],
                                      "dtype": "int32"})
                lat[i] = (time.perf_counter() - t) * 1e3
                replies[i] = (st, body)
        threads = [threading.Thread(target=client, args=(
            range(c, len(rows), CLIENTS),)) for c in range(CLIENTS)]
        for t in threads:
            t.start()
        _join(threads, "the artifact's HTTP clients")
        errs = []
        for (st, body), want in zip(replies, direct):
            check(st == 200, "POST predict of the artifact: %d %s"
                  % (st, body[:200]))
            got = onp.asarray(json.loads(body)["outputs"][0], "float32")
            span = float(want.max() - want.min())
            errs.append(float(onp.abs(got - want).max()) / span)
        check(max(errs) <= PROGRAMS_HTTP_TOL,
              "the served artifact's replies leave the direct forward by "
              "%.3g of the logit range" % max(errs))
        launches = dict(_kernels.LAUNCHES)
        batches = srv.registry.metrics("bert").batch_count - base
        check(batches > 0 and launches.get("flash_fwd", 0)
              == BERT["num_layers"] * batches,
              "the served artifact: flash_fwd launched %d times for %d "
              "batches" % (launches.get("flash_fwd", 0), batches))
        srv.registry.register_shadow("bert", fp32, stride=1,
                                     threshold=1e9)
        # one request so the shadow captures its graph before any profile
        from incubator_mxnet_tpu_torch.telemetry import numwatch
        st, _h, _b = _http(srv, "POST", "/v1/models/bert:predict",
                           {"inputs": [rows[0].tolist()], "dtype": "int32"})
        check(st == 200 and _drain(numwatch, "the shadow's first sample"),
              "the shadow's first sample: %d" % st)

        http_profile = _profile(
            srv, _bert_http_traffic(srv, rows),
            lambda: srv.registry.metrics("bert").batch_count,
            PROFILE_HTTP_S, batch_kernel="flash_fwd_tc")
        check(bool(http_profile["flash_fwd"]),
              "K1 (flash_fwd) is not among the kernels the profile under "
              "HTTP traffic recorded")
        srv.registry.load_generator("tinylm", seed=0, **GEN)
        gen_profile = _profile(srv, _gen_traffic(srv, rng), _decoded,
                               PROFILE_GEN_S)
        st, _h, hot = _http(srv, "GET", "/debug/hotspots?n=8")
        check(st == 200, "/debug/hotspots answered %d" % st)
        hot = json.loads(hot)
        _drain(numwatch, "the shadow worker's drain")
        st, _h, num = _http(srv, "GET", "/debug/numerics")
        num = json.loads(num)
        tap = num["taps"].get("bert/serve:outputs")
        shadow = num["shadows"].get("bert")
        check(st == 200 and tap and tap["last"][0] == 1.0
              and tap["nonfinite"] == 0,
              "/debug/numerics: the serve:outputs tap %r" % (tap,))
        check(shadow and shadow["samples"] > 0
              and shadow["last"]["max_abs_diff"] > 0,
              "/debug/numerics: the bf16-vs-fp32 shadow %r" % (shadow,))
        st, _h, _b = _http(srv, "POST", "/debug/faults", {
            "spec": "batcher.dispatch:nan_poison:stride=1:budget=1"})
        check(st == 200, "arming nan_poison answered %d" % st)
        st, _h, _b = _http(srv, "POST", "/v1/models/bert:predict",
                           {"inputs": [rows[0].tolist()], "dtype": "int32"})
        faultlab.disarm()
        num = json.loads(_http(srv, "GET", "/debug/numerics")[2])
        storm = num["taps"]["bert/serve:outputs"]
        check(storm["storms"] == 1 and storm["nonfinite"] == 1,
              "a NaN injection opened no storm episode: %r" % (storm,))
        st, _h, slo = _http(srv, "GET", "/debug/slo")
        slo = json.loads(slo)
        check(st == 200 and any(s.get("model") == "bert"
                                for s in slo.get("slos", [])),
              "/debug/slo holds no objective of this traffic: %s"
              % json.dumps(slo)[:300])
        st, _h, hist = _http(srv, "GET",
                             "/debug/history?series=mxtpu_serving_queue_depth")
        hist = json.loads(hist)
        check(st == 200 and any("bert" in k for k in hist.get("series", {})),
              "/debug/history holds no series of this traffic: %s"
              % json.dumps(hist)[:300])
        st, _h, inc = _http(srv, "GET", "/debug/incident")
        check(st == 200, "/debug/incident answered %d" % st)
        out = dict(
            http_batches=batches,
            http_p50_ms=sorted(lat)[len(lat) // 2], http_max_ms=max(lat),
            max_rel_err=max(errs), http_profile=http_profile,
            generation_profile=gen_profile,
            hotspots=dict(captures=hot["captures"],
                          top=[dict(op=o["op"][:80], category=o["category"],
                                    share=round(o["share"], 4))
                               for o in hot["ops"]],
                          rolling_idle=hot["rolling_idle_ratio"]),
            numerics=dict(tap_last=tap["last"], taps=tap["sampled"],
                          shadow=shadow["last"],
                          shadow_samples=shadow["samples"],
                          storm=dict(storms=storm["storms"],
                                     nonfinite=storm["nonfinite"])),
            slo=[dict(name=s["name"], budget=s["budget_remaining"])
                 for s in slo["slos"] if s.get("model") == "bert"],
            history_points=sum(len(v.get("raw", []))
                               for v in hist["series"].values()),
            incident_events=len(json.loads(inc).get("timeline", [])))
    finally:
        faultlab.disarm()
        history.stop()
        srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches, out


def programs_phase(card):
    """Phase 21: programs on disk and device telemetry
    (``--programs-only``). Returns (the launches of its HTTP path,
    summary)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["incubator_mxnet_tpu_torch"].__file__)))
    build_kernels()
    tmp = tempfile.mkdtemp(prefix="mxtpu-programs-")
    try:
        bert = _serving_bert(seed=0)
        served, rows = export_and_serve(bert, tmp, root)
        log("  programs (a)(b)(f): %s" % json.dumps(served))
        release_graphs()
        artifacts = artifacts_in_a_fresh_process(bert, tmp, root, rows)
        log("  programs (c): %s" % json.dumps(artifacts))
        release_graphs()
        launches, http = serve_artifact_over_http(bert, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, dict(card=card, served=served, artifacts=artifacts,
                          http=http, seconds=time.perf_counter() - t0)


# ------------------------------------------------- phase 22: SPMD on a mesh
PAR_SP = 4                  # sequence-parallel positions (ring, Ulysses)
PAR_GPT_STEPS = (2, 5)      # GPT S 8192: (warm-up, timed; median)
PAR_LONG_S, PAR_LONG_STEPS = 32768, (2, 3)
PAR_DP, PAR_DP_STEPS, PAR_LR = 4, 3, 1e-4
PAR_TP, PAR_TP_REPLICAS = 2, 2
PAR_PIPE_LAYERS, PAR_PIPE_B, PAR_PIPE_MICRO = 4, 32, 8
PAR_MOE = dict(hidden_size=1024, num_experts=8, ffn_hidden=4096, top_k=2,
               capacity_factor=1.25)
PAR_MOE_TOKENS, PAR_EP = 8192, 4
# bf16 tolerances, stated before the first run: a loss within 1e-2
# relative, each gradient and each output within 3e-2 relative Frobenius
# error (a ring's local outputs are rounded to bf16 before the fp32 merge,
# a data-parallel gradient is summed from bf16 parts, a row-parallel
# output from bf16 partial products); fp32 (the FMA kernels) within 1e-4
PAR_LOSS_TOL, PAR_BF16_TOL, PAR_FP32_TOL = 1e-2, 3e-2, 1e-4
# a parameter whose gradient is zero to rounding: its fp32 gradient's norm
# below 1e-2 of its bf16 gradient's (the bf16 values are rounding noise).
# The attention key projection's bias is such a leaf: softmax ignores a
# shift of a row's scores, so its exact gradient is zero
PAR_ZERO_GRAD_REL = 1e-2
# data parallel and ZeRO-1 against one device after PAR_DP_STEPS Adam
# steps: each loss within 1e-1 of one device's loss drop over the steps;
# per parameter, its Adam first moment (a running sum of gradients)
# within PAR_BF16_TOL and its fp32 master's change within PAR_MASTER_TOL
# of one device's, relative Frobenius, or within PAR_NOISE_MULT times the
# parameter's own bf16 rounding error where that is larger: a gradient
# that is a near-cancelling sum (a query bias) is mostly rounding noise,
# and data parallelism rounds each position's part to bf16 before the sum
PAR_DP_LOSS_TOL, PAR_MASTER_TOL, PAR_NOISE_MULT = 1e-1, 1e-1, 4.0


def _par_devices(n):
    """``n`` mesh positions: the visible CUDA devices if there are that
    many, else cuda:0 named ``n`` times (one card)."""
    import torch
    count = torch.cuda.device_count()
    if count >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _rel_frob(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _set_attention(model, kind):
    """Every MultiHeadAttention of ``model`` to ``kind`` (same weights)."""
    from incubator_mxnet_tpu_torch.models.bert import MultiHeadAttention
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m._attention = kind


def check_ring_kernels():
    """Ring attention (sp = 4) on the card against flash_attention over the
    whole sequence on one device: bf16 (1, 8, 8192, 128) causal and fp32
    (1, 2, 2048, 128) full and causal, forward and the gradients of
    sum(out * dO) in q, k and v."""
    import torch
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    mesh = parallel.make_mesh({"sp": PAR_SP}, devices=_par_devices(PAR_SP))
    rows = []
    gen = torch.Generator(device="cuda:0").manual_seed(22)
    for dtype, shape, causal, tol in (
            (torch.bfloat16, (1, 8, 8192, 128), True, PAR_BF16_TOL),
            (torch.float32, (1, 2, 2048, 128), False, PAR_FP32_TOL),
            (torch.float32, (1, 2, 2048, 128), True, PAR_FP32_TOL)):
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        got = {}
        for name, fn in (("flash", lambda a, b, c: flash_attention(
                a, b, c, causal)), ("ring", lambda a, b, c: parallel
                .ring_attention(a, b, c, mesh=mesh, causal=causal))):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            grads = torch.autograd.grad((out.float() * do.float()).sum(),
                                        leaves)
            got[name] = (out.detach(), grads)
        errs = [_rel_frob(got["ring"][0], got["flash"][0])] + [
            _rel_frob(a, b) for a, b in zip(got["ring"][1], got["flash"][1])]
        row = dict(dtype=str(dtype).split(".")[-1], shape=list(shape),
                   causal=causal, out_rel=errs[0], dq_rel=errs[1],
                   dk_rel=errs[2], dv_rel=errs[3], tol=tol)
        rows.append(row)
        log("  parallel ring vs flash %s %s causal=%s: out %.3g, dq %.3g, "
            "dk %.3g, dv %.3g relative (tol %g)" % (
                row["dtype"], shape, causal, *errs, tol))
        check(all(math.isfinite(e) and e <= tol for e in errs),
              "ring attention disagrees with flash on the card: %s" % row)
        del q, k, v, do, got
    return rows


def _leaf_grads(model, loss_of):
    """(the loss, every parameter's gradient in fp32) of one plain forward
    and backward of the mean of ``loss_of()``."""
    import torch
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon._functional import plain
    params = [p._tensor() for p in model.collect_params().values()]
    with autograd.record(), plain():
        loss = loss_of().float().mean()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), [None if g is None else g.detach().float()
                                  for g in grads]


def _gpt_loss(model, tokens):
    """FeaturesView + ChunkedLMLoss: the per-token losses."""
    from incubator_mxnet_tpu_torch import models
    return models.ChunkedLMLoss(model)(models.FeaturesView(model)(tokens),
                                       tokens)


def _gpt_grads(model, tokens):
    return _leaf_grads(model, lambda: _gpt_loss(model, tokens))


def _rounding(model, loss_of, bf16_grads, what):
    """(the parameters of bf16 ``model`` whose gradient is zero to rounding
    (PAR_ZERO_GRAD_REL), each parameter's bf16 rounding error): the
    gradients of ``loss_of`` once more with the model cast to fp32 (and
    back: exact; TF32 off), against ``bf16_grads``; the error is
    |bf16 - fp32| / |fp32| in Frobenius norm. Each leaf zero to rounding
    must be an attention key projection's bias; their norms are
    printed."""
    import torch
    names = list(model.collect_params().keys())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.cast("float32")
    try:
        _, fp32 = _leaf_grads(model, loss_of)
    finally:
        model.cast("bfloat16")
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    zero, noise = {}, {}
    for n, g, g32 in zip(names, bf16_grads, fp32):
        if g is None or g32 is None:
            continue
        noise[n] = _rel_frob(g, g32) if float(g32.norm()) > 0 else (
            0.0 if float(g.norm()) == 0 else math.inf)
        if float(g32.norm()) < PAR_ZERO_GRAD_REL * float(g.norm()):
            zero[n] = dict(bf16_norm=float(g.norm()),
                           fp32_norm=float(g32.norm()))
    log("  %s: gradients zero to rounding (fp32 norm below %g of bf16's): "
        "%s" % (what, PAR_ZERO_GRAD_REL, ", ".join(
            "%s %.3g / %.3g" % (n, v["fp32_norm"], v["bf16_norm"])
            for n, v in zero.items()) or "none"))
    check(all(n.endswith("key.bias") for n in zero),
          "%s: a gradient other than a key bias is zero to rounding: %s"
          % (what, sorted(zero)))
    return zero, noise


def _gpt_layout_steps(model, kind, tokens, warm, timed, init):
    """``timed`` TrainSteps (after ``warm``) of ``model`` with attention
    ``kind`` from the weights ``init``: step ms (median over the timed
    steps, CUDA events), tokens/s, peak memory, the K1/K2/K3 launches over
    the timed steps, whether the step was captured, losses."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import jit, models
    from incubator_mxnet_tpu_torch.ops import _kernels
    params = list(model.collect_params().values())
    _reset(params, init)
    _set_attention(model, kind)
    net = models.FeaturesView(model)
    trainer = mxt.gluon.Trainer(net.collect_params(), "adam", {
        "learning_rate": 1e-4, "multi_precision": True})
    step = jit.TrainStep(net, models.ChunkedLMLoss(model), trainer)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(tokens, tokens) for _ in range(warm)]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    times = []
    for _ in range(timed):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        losses.append(step(tokens, tokens))
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    launches = {k: _kernels.LAUNCHES.get(k, 0) for k in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    means = [float(l._data.float().mean()) for l in losses]
    check(all(math.isfinite(m) for m in means),
          "parallel GPT %s: a loss is not finite: %s" % (kind, means))
    profiled = device_idle_share(lambda: step(tokens, tokens))
    row = dict(step_ms=sorted(times)[len(times) // 2], step_ms_all=times,
               issue_ms=issue_ms(lambda: step(tokens, tokens)),
               idle_share=profiled["idle_share"],
               tokens_per_s=tokens.numel() / (sorted(times)[len(times) // 2]
                                              / 1e3),
               peak_memory_gb=peak, captured=step.captures,
               launches=launches, losses=means)
    del step, trainer, net
    return row


def parallel_gpt(card):
    """22(a) and (b): GPT at bench.py bench_long_context width with flash,
    ring (sp = 4) and Ulysses (sp = 4) attention from one set of weights:
    one plain forward/backward each against flash's, then TrainSteps; then
    S 32768 with flash and ring."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models, parallel
    dev = torch.device("cuda", 0)
    n_layers = GPT["num_layers"]
    per_step = {"flash": n_layers, "ring": n_layers * (
        PAR_SP + PAR_SP * (PAR_SP - 1) // 2), "ulysses": n_layers * PAR_SP}
    parallel.make_mesh({"sp": PAR_SP}, devices=_par_devices(PAR_SP))
    out, launches = {}, {}
    for S, layouts, (warm, timed) in (
            (GPT_S, ("flash", "ring", "ulysses"), PAR_GPT_STEPS),
            (PAR_LONG_S, ("flash", "ring"), PAR_LONG_STEPS)):
        model = models.GPTModel(**dict(GPT, max_length=S))
        model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                         .Generator(device=dev).manual_seed(17))
        model.cast("bfloat16")
        names = list(model.collect_params().keys())
        params = list(model.collect_params().values())
        init = [p._tensor().detach().clone() for p in params]
        tokens = torch.from_numpy(onp.random.RandomState(S).randint(
            0, GPT["vocab_size"], (1, S)).astype("int32")).to(dev)
        rows = {}
        if S == GPT_S:
            ref_loss, ref, zero = None, None, None
            for kind in layouts:
                _set_attention(model, kind)
                loss, grads = _gpt_grads(model, tokens)
                if ref is None:
                    ref_loss, ref = loss, grads
                    zero, _ = _rounding(model, lambda: _gpt_loss(
                        model, tokens), ref, "parallel GPT S %d flash" % S)
                    rows[kind] = dict(loss=loss, zero_to_rounding=zero)
                    continue
                # each gradient's error over its own norm, but for those
                # zero to rounding (both computed values are noise)
                rel = {n: _rel_frob(g, r)
                       for n, g, r in zip(names, grads, ref)
                       if g is not None and r is not None and n not in zero}
                worst = max(rel, key=rel.get)
                loss_rel = abs(loss - ref_loss) / abs(ref_loss)
                vals = sorted(rel.values())
                rows[kind] = dict(loss=loss, loss_rel=loss_rel,
                                  grad_rel_max=rel[worst], grad_worst=worst,
                                  grad_rel_median=vals[len(vals) // 2],
                                  grad_rel=rel)
                log("  parallel GPT S %d %s vs flash: loss %.5f vs %.5f "
                    "(%.3g rel), gradients max %.3g (%s) / median %.3g rel "
                    "Frobenius (tol %g / %g)" % (
                        S, kind, loss, ref_loss, loss_rel, rel[worst], worst,
                        rows[kind]["grad_rel_median"], PAR_LOSS_TOL,
                        PAR_BF16_TOL))
                check(loss_rel <= PAR_LOSS_TOL and rel[worst] <= PAR_BF16_TOL,
                      "parallel GPT %s: loss or gradients disagree with "
                      "flash: %s" % (kind, rows[kind]))
                del grads
            del ref
        for kind in layouts:
            row = _gpt_layout_steps(model, kind, tokens, warm, timed, init)
            want = per_step[kind] * timed
            check(all(v == want for v in row["launches"].values()),
                  "parallel GPT S %d %s: K1/K2/K3 launched %s over %d "
                  "steps, expected %d each" % (S, kind, row["launches"],
                                               timed, want))
            rows.setdefault(kind, {}).update(row)
            launches["parallel_gpt%s_%s" % ("" if S == GPT_S else "_long",
                                            kind)] = row["launches"]
            log("  parallel GPT S %d %s: step %.1f ms (median of %d, %s), "
                "%.0f tokens/s, peak %.2f GB, issue %.1f ms, idle %.1f%%, "
                "K1/K2/K3 %s a step" % (
                    S, kind, row["step_ms"], timed,
                    "captured" if row["captured"] else "eager",
                    row["tokens_per_s"], row["peak_memory_gb"],
                    row["issue_ms"], 100 * row["idle_share"],
                    per_step[kind]))
        out["S%d" % S] = rows
        del model, params, init, tokens
        gc.collect()
        torch.cuda.empty_cache()
    parallel.set_current_mesh(None)
    return launches, out


def _bert_trained(model, init, make_step, tokens, steps, timing=True):
    """(mean losses, step ms, each parameter's (fp32 master, Adam first
    moment) after ``steps`` steps (ZeRO's slices gathered), trainer,
    {issue ms, idle share} of further steps, unless not ``timing``) of a
    step made by ``make_step(trainer)`` from the weights ``init``."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.parallel.data_parallel import gathered
    params = list(model.collect_params().values())
    _reset(params, init)
    trainer = mxt.gluon.Trainer(model.collect_params(), "adam", {
        "learning_rate": PAR_LR, "multi_precision": True})
    step = make_step(trainer)
    losses, times = [], []
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for _ in range(steps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        losses.append(float(step(tokens, tokens)._data.float().mean()))
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    after = []
    for st in trainer._states:
        master, (mean, _) = gathered(st)
        after.append((master.detach().clone(), mean.detach().clone()))
    counts = {k: _kernels.LAUNCHES.get(k, 0) for k in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    host = dict(launches=counts)
    if timing:
        profiled = device_idle_share(lambda: step(tokens, tokens))
        host.update(issue_ms=issue_ms(lambda: step(tokens, tokens)),
                    idle_share=profiled["idle_share"])
    return losses, times, after, trainer, host


def _dp_errors(losses, states, ref_losses, ref_states, init, names, zero):
    """A data-parallel run against one device's: the worst loss error over
    one device's loss drop, and per parameter (but those zero to rounding)
    the relative Frobenius errors of its fp32 master's change from
    ``init`` and of its Adam first moment."""
    drop = abs(ref_losses[-1] - ref_losses[0])
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses)) / drop
    master, moment = {}, {}
    for n, (m, mean), (rm, rmean), w0 in zip(names, states, ref_states,
                                             init):
        if n not in zero:
            w0 = w0.float()
            master[n] = _rel_frob(m - w0, rm - w0)
            moment[n] = _rel_frob(mean, rmean)
    return loss_err, master, moment


def _dp_over(loss_err, master, moment, noise):
    """Each check's errors over their bounds (1 or less passes): the loss
    error over PAR_DP_LOSS_TOL; per parameter the first moment's error
    over max(PAR_BF16_TOL, PAR_NOISE_MULT x the parameter's bf16 rounding
    error) and the master change's over max(PAR_MASTER_TOL, the same)."""
    def over(errs, tol):
        return {n: e / max(tol, PAR_NOISE_MULT * noise.get(n, 0.0))
                for n, e in errs.items()}
    return dict(loss=loss_err / PAR_DP_LOSS_TOL,
                master=over(master, PAR_MASTER_TOL),
                moment=over(moment, PAR_BF16_TOL))


def _dp_report(what, loss_err, master, moment, noise):
    """Log a data-parallel comparison; returns (passes, its row)."""
    over = _dp_over(loss_err, master, moment, noise)
    row = dict(loss_err=loss_err)
    for kind, errs in (("master", master), ("moment", moment)):
        worst = sorted(over[kind], key=over[kind].get, reverse=True)
        row[kind] = dict(
            rel_max=max(errs.values()),
            rel_median=sorted(errs.values())[len(errs) // 2],
            over_bound=sum(v > 1 for v in over[kind].values()),
            leaves=len(errs),
            worst=[(n, errs[n], noise.get(n, 0.0)) for n in worst[:6]])
    log("  parallel BERT %s: loss error %.3g of the drop (tol %g); master "
        "change rel max %.3g / median %.3g, %d of %d leaves over bound; "
        "first moment rel max %.3g / median %.3g, %d of %d over; worst "
        "(leaf, rel, bf16 noise): masters %s, moments %s" % (
            what, loss_err, PAR_DP_LOSS_TOL, row["master"]["rel_max"],
            row["master"]["rel_median"], row["master"]["over_bound"],
            row["master"]["leaves"], row["moment"]["rel_max"],
            row["moment"]["rel_median"], row["moment"]["over_bound"],
            row["moment"]["leaves"],
            ["%s %.3g %.3g" % w for w in row["master"]["worst"][:3]],
            ["%s %.3g %.3g" % w for w in row["moment"]["worst"][:3]]))
    passes = over["loss"] <= 1 and row["master"]["over_bound"] == 0 and \
        row["moment"]["over_bound"] == 0
    return passes, row


def parallel_bert_dp(card):
    """22(c): full-width BERT (B 64 x S 512, bf16, flash, Adam
    multi_precision) three steps through DataParallelTrainStep (dp = 4)
    and TrainStep(mesh, zero=True) against TrainStep on one device."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import jit, models, parallel
    from incubator_mxnet_tpu_torch.parallel.data_parallel import (
        ShardedState, _leaves)
    dev = torch.device("cuda", 0)
    model = models.BERTModel(**BERT)
    model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                     .Generator(device=dev).manual_seed(23))
    model.cast("bfloat16")
    init = [p._tensor().detach().clone()
            for p in model.collect_params().values()]
    tokens = torch.from_numpy(onp.random.RandomState(23).randint(
        0, BERT["vocab_size"], (BERT_TRAIN_B, BERT_S)).astype("int32")) \
        .to(dev)
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    names = list(model.collect_params().keys())
    # each parameter's bf16 rounding error on one position's share
    part = tokens[:BERT_TRAIN_B // PAR_DP]

    def part_loss():
        return loss_fn(model(part), part)
    _, part_grads = _leaf_grads(model, part_loss)
    zero, noise = _rounding(model, part_loss, part_grads,
                            "parallel BERT B %d" % part.shape[0])
    del part_grads
    mesh = parallel.make_mesh({"dp": PAR_DP}, devices=_par_devices(PAR_DP))
    one_l, one_t, one_s, _, one_host = _bert_trained(
        model, init, lambda tr: jit.TrainStep(model, loss_fn, tr), tokens,
        PAR_DP_STEPS)
    one_host.pop("launches")
    rows = {"one_device": dict(losses=one_l, step_ms=one_t, **one_host),
            "zero_to_rounding": zero, "bf16_noise": noise}
    # the check must fail a step that updates nothing, and one that trains
    # on one position's quarter of the batch (one device on that quarter)
    planted = {"no_update": ([one_l[0]] * PAR_DP_STEPS, [
        (w0.float(), torch.zeros_like(w0, dtype=torch.float32))
        for w0 in init])}
    q_l, _, q_s, _, _ = _bert_trained(
        model, init, lambda tr: jit.TrainStep(model, loss_fn, tr),
        tokens[:BERT_TRAIN_B // PAR_DP], PAR_DP_STEPS, timing=False)
    planted["quarter_batch"] = (q_l, q_s)
    failures = []
    for name, (losses, states) in planted.items():
        passes, rows["planted_" + name] = _dp_report(
            "planted " + name, *_dp_errors(losses, states, one_l, one_s,
                                           init, names, zero), noise)
        # checked after the runs below, so that all their numbers print
        failures.append((not passes, "parallel BERT: the data-parallel "
                         "check passes a planted %s step" % name))
    del q_s, planted
    launches = {}
    per_forward = BERT["num_layers"] * PAR_DP
    for name, make in (
            ("dp", lambda tr: parallel.DataParallelTrainStep(
                model, loss_fn, tr, mesh=mesh)),
            ("zero", lambda tr: jit.TrainStep(model, loss_fn, tr, mesh=mesh,
                                              zero=True))):
        losses, times, states, trainer, host = _bert_trained(
            model, init, make, tokens, PAR_DP_STEPS)
        counts = host.pop("launches")
        want = per_forward * PAR_DP_STEPS
        check(all(v == want for v in counts.values()),
              "parallel BERT %s: K1/K2/K3 launched %s over %d steps, "
              "expected %d each (%d a forward)" % (
                  name, counts, PAR_DP_STEPS, want, per_forward))
        passes, row = _dp_report(
            name + " against one device", *_dp_errors(
                losses, states, one_l, one_s, init, names, zero), noise)
        failures.append((passes, "parallel BERT %s against one device: "
                         "losses %s vs %s; %s" % (name, losses, one_l, row)))
        row.update(losses=losses, step_ms=times, launches=counts, **host)
        if name == "zero":
            n_sharded = 0
            for p, st in zip(trainer._params, trainer._states):
                for leaf in _leaves(st):
                    if isinstance(leaf, ShardedState):
                        n_sharded += 1
                        check(len(leaf.slices) == PAR_DP and all(
                            s.numel() * PAR_DP == p._tensor().numel()
                            for s in leaf.slices),
                            "ZeRO-1: a state is not in %d quarters" % PAR_DP)
            check(n_sharded >= 3 * len([p for p in trainer._params
                                        if p.shape[0] % PAR_DP == 0]),
                  "ZeRO-1: %d states held in slices" % n_sharded)
            row["sharded_states"] = n_sharded
        rows[name] = row
        launches["parallel_bert_" + name] = counts
        log("  parallel BERT %s (dp %d): step ms %s (one device %s), issue "
            "%.1f ms (%.1f), idle %.1f%% (%.1f%%), losses %s vs %s, K1 %d "
            "a forward%s" % (
                name, PAR_DP, ["%.1f" % t for t in times],
                ["%.1f" % t for t in one_t], host["issue_ms"],
                one_host["issue_ms"], 100 * host["idle_share"],
                100 * one_host["idle_share"], ["%.4f" % v for v in losses],
                ["%.4f" % v for v in one_l], counts["flash_fwd"]
                // PAR_DP_STEPS, "; %d states in %d slices" % (
                    row["sharded_states"], PAR_DP) if name == "zero"
                else ""))
        del trainer, states
        gc.collect()
        torch.cuda.empty_cache()
    parallel.set_current_mesh(None)
    for ok, msg in failures:
        check(ok, msg)
    del model, init, one_s
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


def parallel_mesh_serving(card):
    """22(d): BERT with tp_axis="tp" as MeshServable tp = 2 x replicas = 2
    behind ModelRegistry: 16 requests from 4 threads at bucket 8 x S 512
    against BlockServable's replies; K1 12 a batch."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models, serving
    from incubator_mxnet_tpu_torch.ops import _kernels
    net = models.BERTModel(**dict(BERT, tp_axis="tp"))
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                   .Generator(device="cuda:0").manual_seed(24))
    net.cast("bfloat16")
    rows = onp.random.RandomState(24).randint(
        0, BERT["vocab_size"], (BERT_REQUESTS, BERT_S)).astype("int32")
    plain = serving.BlockServable(net)
    want = onp.concatenate([plain.predict_batch(rows[i:i + BERT_BUCKET])[0]
                            for i in range(0, BERT_REQUESTS, BERT_BUCKET)])
    plain.release()
    sv = serving.MeshServable(net, tp=PAR_TP, replicas=PAR_TP_REPLICAS,
                              devices=_par_devices(PAR_TP * PAR_TP_REPLICAS))
    reg = serving.ModelRegistry()
    # one bucket, prewarmed on both replicas: the timed traffic replays
    # built programs (a build runs the forward under FlopCounterMode)
    reg.load("bert_tp", sv, max_batch_size=BERT_BUCKET, batch_timeout_ms=50,
             replicas=PAR_TP_REPLICAS, buckets=[BERT_BUCKET],
             warm_spec=[((BERT_S,), "int32")])
    try:
        base = reg.metrics("bert_tp").batch_count
        replies, lat, errors = {}, [], []

        def client(c):
            try:
                t = time.perf_counter()
                reqs = {i: reg.submit("bert_tp", rows[i])
                        for i in range(c, BERT_REQUESTS, CLIENTS)}
                for i, r in reqs.items():
                    replies[i] = r.result(600)[0]
                    lat.append((time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        launches = {"flash_fwd": _kernels.LAUNCHES.get("flash_fwd", 0)}
        batches = reg.metrics("bert_tp").batch_count - base
        counts = reg._entry("bert_tp").batcher.replica_dispatch_counts()
    finally:
        reg.close()
        sv.release()
    check(not errors and len(replies) == BERT_REQUESTS,
          "mesh serving: requests failed: %r" % errors[:3])
    check(sum(counts) == BERT_REQUESTS, "mesh serving: replica dispatch "
          "counts %s do not sum to %d" % (counts, BERT_REQUESTS))
    check(launches["flash_fwd"] == BERT["num_layers"] * batches,
          "mesh serving: K1 launched %d times for %d batches, expected %d "
          "a batch" % (launches["flash_fwd"], batches, BERT["num_layers"]))
    err = max(float(onp.abs(onp.asarray(replies[i], "float32") - want[i])
                    .max() / onp.abs(want[i]).max())
              for i in range(BERT_REQUESTS))
    check(err <= PAR_BF16_TOL, "mesh serving: replies differ from "
          "BlockServable's by %.3g of their largest logit" % err)
    lat.sort()
    row = dict(tp=PAR_TP, replicas=PAR_TP_REPLICAS, batches=batches,
               replica_dispatch_counts=counts, k1=launches["flash_fwd"],
               p50_ms=lat[len(lat) // 2], max_ms=lat[-1], max_rel_err=err)
    log("  parallel mesh serving tp %d x replicas %d: %d batches %s, K1 %d, "
        "p50 %.1f ms, max %.1f ms, replies within %.3g of BlockServable's"
        % (PAR_TP, PAR_TP_REPLICAS, batches, counts, launches["flash_fwd"],
           row["p50_ms"], row["max_ms"], err))
    del net, sv
    gc.collect()
    torch.cuda.empty_cache()
    return {"parallel_mesh_serving": launches}, row


def _cuda_ms(fn, warm=True):
    """(fn()'s result, its ms by CUDA events); with ``warm`` one call
    first, untimed (first-use costs: handles, allocator growth)."""
    import torch
    if warm:
        fn()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def parallel_pipeline(card):
    """22(e): 4 full-width BERT encoder layers (flash, bf16) as pp = 4
    stages of a PipelineStack, B 32 x S 512, 8 microbatches: the forward
    against the sequential stack; 1F1B (pp = 4) and interleaved (pp = 2,
    v = 2) gradients against GPipe's (the ring under autograd)."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.gluon import parameter as _param
    from incubator_mxnet_tpu_torch.models.bert import TransformerEncoderLayer
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(25)
    layers = []
    for _ in range(PAR_PIPE_LAYERS):
        layer = TransformerEncoderLayer(BERT["units"], BERT["hidden_size"],
                                        BERT["num_heads"], dropout=0.0,
                                        attention="flash")
        layer.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
        layer.cast("bfloat16")
        layers.append(layer)
    shape = (PAR_PIPE_B, BERT_S, BERT["units"])
    x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    y = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    m, mb = PAR_PIPE_MICRO, PAR_PIPE_B // PAR_PIPE_MICRO
    mesh4 = parallel.make_mesh({"pp": PAR_PIPE_LAYERS},
                               devices=_par_devices(PAR_PIPE_LAYERS))
    stack = parallel.PipelineStack(layers, mesh4, n_microbatches=m)
    per = [list(l.collect_params().values()) for l in layers]

    def loss_fn(out, yb):
        return ((out.float() - yb.float()) ** 2).mean()

    def stage_fn(stage_params, h):
        mapping = {id(p): t for p, t in zip(per[0], stage_params)}
        saved = getattr(_param._OVERRIDE, "fn", None)
        _param._OVERRIDE.fn = lambda p: mapping.get(id(p))
        try:
            return layers[0](h)
        finally:
            _param._OVERRIDE.fn = saved

    with torch.no_grad():
        seq, seq_ms = _cuda_ms(lambda: _sequential(layers, x))
        piped, pipe_ms = _cuda_ms(lambda: stack(x))
    fwd_rel = _rel_frob(piped, seq)
    check(fwd_rel <= PAR_BF16_TOL, "PipelineStack forward vs the sequential "
          "stack: %.3g relative" % fwd_rel)
    flat = [p._tensor() for ps in per for p in ps]

    def gpipe():
        out = stack(x).reshape(m, mb, *shape[1:])
        loss = sum(loss_fn(out[i], y.reshape(m, mb, *shape[1:])[i])
                   for i in range(m)) / m
        return loss, torch.autograd.grad(loss, flat)
    (g_loss, g_grads), gpipe_ms = _cuda_ms(gpipe)
    g_loss = g_loss.detach()
    nper = len(per[0])
    g_by = [[g_grads[s * nper + j] for s in range(PAR_PIPE_LAYERS)]
            for j in range(nper)]
    stacked = [torch.stack([per[s][j]._tensor().detach()
                            for s in range(PAR_PIPE_LAYERS)])
               for j in range(nper)]
    (l1, g1, _), ms_1f1b = _cuda_ms(lambda: parallel.pipeline_1f1b_grads(
        stage_fn, loss_fn, stacked, x, y, mesh4, m))
    mesh2 = parallel.make_mesh({"pp": 2}, devices=_par_devices(2))
    v, p = 2, 2
    inter = [s.reshape(v, p, *s.shape[1:]) for s in stacked]
    (li, gi, _), ms_inter = _cuda_ms(
        lambda: parallel.pipeline_interleaved_grads(
            stage_fn, loss_fn, inter, x, y, mesh2, m, v))
    errs = {"1f1b": max(_rel_frob(a / m, torch.stack(b))
                        for a, b in zip(g1, g_by)),
            "interleaved": max(_rel_frob(a.reshape(PAR_PIPE_LAYERS,
                                                   *a.shape[2:]) / m,
                                         torch.stack(b))
                               for a, b in zip(gi, g_by))}
    loss_rel = max(abs(float(l1) - float(g_loss)), abs(float(li) - float(
        g_loss))) / abs(float(g_loss))
    row = dict(forward_rel=fwd_rel, sequential_ms=seq_ms,
               pipeline_forward_ms=pipe_ms, gpipe_ms=gpipe_ms,
               one_f_one_b_ms=ms_1f1b, interleaved_ms=ms_inter,
               grad_rel=errs, loss_rel=loss_rel)
    log("  parallel pipeline (4 BERT layers, B %d x S %d, %d microbatches): "
        "forward %.1f ms vs sequential %.1f (%.3g rel); GPipe fwd+bwd %.1f "
        "ms, 1F1B %.1f ms, interleaved (pp 2, v 2) %.1f ms; gradients vs "
        "GPipe %s, loss %.3g rel" % (
            PAR_PIPE_B, BERT_S, m, pipe_ms, seq_ms, fwd_rel, gpipe_ms,
            ms_1f1b, ms_inter, {k: "%.3g" % e for k, e in errs.items()},
            loss_rel))
    check(loss_rel <= PAR_LOSS_TOL and all(e <= PAR_BF16_TOL
                                           for e in errs.values()),
          "pipeline gradients disagree with GPipe's: %s" % row)
    parallel.set_current_mesh(None)
    del layers, stack, x, y, g_grads, g1, gi, stacked, inter
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _sequential(layers, h):
    for layer in layers:
        h = layer(h)
    return h


def parallel_moe(card):
    """22(f): MoELayer (D 1024, E 8, ffn 4096, top-2, capacity 1.25) over
    8192 tokens, ep = 4 against ep = 1, fp32 with TF32 off: the output,
    the auxiliary loss and the gradients of sum(out * dY) + aux."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import parallel
    dev = torch.device("cuda", 0)
    layer = parallel.MoELayer(**PAR_MOE)
    layer.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                     .Generator(device=dev).manual_seed(26))
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(PAR_MOE_TOKENS, PAR_MOE["hidden_size"], device=dev,
                    generator=gen)
    dy = torch.randn(x.shape, device=dev, generator=gen)
    params = [layer.gate_weight._tensor(), layer.w1._tensor(),
              layer.w2._tensor()]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    try:
        for ep in (1, PAR_EP):
            parallel.make_mesh({"ep": ep}, devices=_par_devices(ep))

            def run():
                xi = x.clone().requires_grad_()
                out, aux = layer.forward_with_aux(xi)
                grads = torch.autograd.grad((out * dy).sum() + aux,
                                            [xi] + params)
                return out.detach(), float(aux.detach()), grads
            got[ep], ms = _cuda_ms(run)
            got[ep] += (ms,)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        parallel.set_current_mesh(None)
    (o1, a1, g1, ms1), (o4, a4, g4, ms4) = got[1], got[PAR_EP]
    errs = dict(out=_rel_frob(o4, o1), aux=abs(a4 - a1) / abs(a1),
                **{n: _rel_frob(a, b) for n, a, b in zip(
                    ("dx", "dgate", "dw1", "dw2"), g4, g1)})
    row = dict(tokens=PAR_MOE_TOKENS, ep=PAR_EP, ep1_ms=ms1,
               ep4_ms=ms4, rel=errs, aux=a4)
    log("  parallel MoE (E %d, top-2, capacity 1.25, %d tokens): ep %d "
        "%.1f ms vs ep 1 %.1f ms (forward + backward); relative %s" % (
            PAR_MOE["num_experts"], PAR_MOE_TOKENS, PAR_EP, ms4, ms1,
            {k: "%.3g" % v for k, v in errs.items()}))
    check(all(v <= PAR_FP32_TOL for v in errs.values()),
          "MoE ep %d disagrees with ep 1: %s" % (PAR_EP, errs))
    del layer, x, dy, params, got
    gc.collect()
    torch.cuda.empty_cache()
    return row


def parallel_phase(card):
    """Phase 22: SPMD over a mesh (``--parallel-only``). Returns (launches
    by path, summary)."""
    t0 = time.perf_counter()
    build_kernels()
    log("parallel: %s; meshes over %s" % (
        card, sorted({str(d) for d in _par_devices(PAR_SP)})))
    ring = check_ring_kernels()
    launches, gpt = parallel_gpt(card)
    release_graphs()
    more, bert = parallel_bert_dp(card)
    launches.update(more)
    release_graphs()
    more, serving = parallel_mesh_serving(card)
    launches.update(more)
    release_graphs()
    pipeline = parallel_pipeline(card)
    moe = parallel_moe(card)
    return launches, dict(card=card, ring_vs_flash=ring, gpt=gpt, bert=bert,
                          mesh_serving=serving, pipeline=pipeline, moe=moe,
                          seconds=time.perf_counter() - t0)


# ------------------------------------------------- phase 23: several processes
DIST_N = 2                  # worker processes, both on cuda:0 (gloo)
DIST_STEPS = 3
DIST_B = BERT_TRAIN_B // DIST_N     # each rank's rows of the global batch
DIST_WORKER_TIMEOUT_S = 600         # the launcher's subprocess bound
DIST_GROUP_TIMEOUT_S = 180          # the process group's, each collective's
DIST_SMALL_TOL = 1e-5       # card against one context / the CPU, fp32


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sha256_leaves(tensors):
    """SHA-256 of each tensor's bytes (a thread pool: hashlib releases the
    interpreter lock on large buffers)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import torch

    def digest(t):
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    with ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(digest, tensors))


def _gloo_cuda_collectives(dist_mod):
    """Whether gloo's broadcast, all_gather and all_reduce take CUDA
    tensors on this build, each checked on a small value: {op: "ok" or the
    error}. Nothing is copied to the host around them."""
    import torch
    import torch.distributed as tdist
    rank, n = dist_mod.rank(), dist_mod.num_workers()
    dev = torch.device("cuda", 0)
    got = {}
    for op in ("broadcast", "all_gather", "all_reduce"):
        try:
            t = torch.full((4,), float(rank + 1), device=dev)
            if op == "broadcast":
                tdist.broadcast(t, src=0)
                ok = torch.equal(t, torch.ones_like(t))
            elif op == "all_gather":
                rows = [torch.empty_like(t) for _ in range(n)]
                tdist.all_gather(rows, t)
                ok = all(torch.equal(r, torch.full_like(t, i + 1.0))
                         for i, r in enumerate(rows))
            else:
                tdist.all_reduce(t)
                ok = torch.equal(t, torch.full_like(t, n * (n + 1) / 2))
            got[op] = "ok" if ok else "wrong values"
        except Exception as e:        # reported, and fatal in the parent
            got[op] = "%s: %s" % (type(e).__name__, e)
    return got


def _dist_matrix(mxt, rank, n):
    """tests/dist_worker.py's matrix through the port's stores on the
    card, at small size: push/pull, dist_sync SGD, compression, dist_async
    diverged / synced / forced / uneven, Module updating on the store,
    row-sparse sync and async. Closed forms are checked here; the digests,
    which must agree across ranks (but the diverged one), go back to the
    parent."""
    import hashlib
    import numpy as onp
    nd, gpu = mxt.nd, mxt.gpu(0)

    def arr(a):
        return nd.array(onp.asarray(a, dtype="float32"), ctx=gpu)

    def digest(a):
        return hashlib.sha256(a.asnumpy().tobytes()).hexdigest()
    out = {}
    kv = mxt.kv.create("dist_sync")
    check((kv.rank, kv.num_workers) == (rank, n), "dist_sync's rank")
    kv.init("a", arr(onp.full(4, 100.0 if rank == 0 else 0.0)))
    o = arr(onp.zeros(4))
    kv.pull("a", out=o)
    check(onp.all(o.asnumpy() == 100.0), "init did not broadcast rank 0's")
    kv.push("a", arr(onp.full(4, rank + 1.0)))
    kv.pull("a", out=o)
    check(onp.all(o.asnumpy() == n * (n + 1) / 2), "push/pull: %s" % o)
    kv2 = mxt.kv.create("dist_sync")
    kv2.set_optimizer(mxt.optimizer.SGD(learning_rate=0.1))
    kv2.init(0, arr(onp.random.RandomState(7).randn(8, 4)))
    for step in range(3):
        kv2.push(0, arr(onp.full((8, 4), 0.01 * (rank + 1) * (step + 1))))
    w = arr(onp.zeros((8, 4)))
    kv2.pull(0, out=w)
    out["params"] = digest(w)
    kv3 = mxt.kv.create("dist_sync")
    kv3.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv3.init("c", arr(onp.zeros(4)))
    kv3.push("c", arr([0.6, -0.7, 0.2, 0.0] if rank == 0 else
                      [0.4, 0.0, -0.9, 0.1]))
    kv3.pull("c", out=o)
    check(o.asnumpy().tolist() == [0.5, -0.5, -0.5 * (n - 1), 0.0],
          "compression: %s" % o.asnumpy())
    kva = mxt.kv.create("dist_async")
    kva._staleness = 2
    kva.set_optimizer(mxt.optimizer.SGD(learning_rate=0.1))
    w_init = onp.random.RandomState(11).randn(4, 2).astype("float32")
    kva.init(0, arr(w_init))
    wa = arr(onp.zeros((4, 2)))
    kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.pull(0, out=wa)
    out["async_diverged"] = digest(wa)
    kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.pull(0, out=wa)
    out["async_synced"] = digest(wa)
    want = sum(w_init - 0.2 * (r + 1) for r in range(n)) / n
    check(onp.allclose(wa.asnumpy(), want, atol=1e-5), "dist_async average")
    kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.sync()
    kva.pull(0, out=wa)
    out["async_forced"] = digest(wa)
    planned = 5 if rank == 0 else 3
    budget = kva.begin_epoch(planned)
    check(budget == 1, "uneven shards: budget %s" % budget)
    for _ in range(planned):
        kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.sync()
    kva.pull(0, out=wa)
    out["async_uneven"] = digest(wa)
    sym = mxt.sym
    net = sym.LinearRegressionOutput(
        sym.FullyConnected(sym.Variable("data"), num_hidden=1, name="fc"),
        sym.Variable("softmax_label"), name="lro")
    m = mxt.mod.Module(net, context=gpu)
    m.bind(data_shapes=[("data", (4, 3))],
           label_shapes=[("softmax_label", (4, 1))])
    m.init_params(arg_params={
        "fc_weight": arr(onp.random.RandomState(5).randn(1, 3)),
        "fc_bias": arr(onp.zeros(1))})
    m.init_optimizer(kvstore=mxt.kv.create("dist_sync"), optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1})
    check(m._update_on_kvstore, "Module does not update on a dist store")
    batch = mxt.io.DataBatch(data=[arr(onp.full((4, 3), rank + 1.0))],
                             label=[arr(onp.full((4, 1), -float(rank)))])
    for _ in range(2):
        m.forward_backward(batch)
        m.update()
    out["module_kv"] = digest(m.get_params()[0]["fc_weight"])
    dense = onp.zeros((6, 3), "float32")
    for r in (rank % 6, (rank + 2) % 6):
        dense[r] = rank + 1
    want_rs = onp.zeros((6, 3), "float32")
    for r in range(n):
        for row in (r % 6, (r + 2) % 6):
            want_rs[row] += r + 1
    kvr = mxt.kv.create("dist_sync")
    kvr.init("rs", arr(onp.zeros((6, 3))))
    kvr.push("rs", arr(dense).tostype("row_sparse"))
    outr = arr(onp.zeros((6, 3)))
    kvr.pull("rs", out=outr)
    check(onp.array_equal(outr.asnumpy(), want_rs), "row_sparse sync")
    kvar = mxt.kv.create("dist_async")
    kvar._staleness = 10 ** 9
    kvar.init("ars", arr(onp.zeros((6, 3))))
    kvar.push("ars", arr(dense).tostype("row_sparse"))
    kvar.sync()
    kvar.pull("ars", out=outr)
    out["rowsparse_async"] = digest(outr)
    return out


def _dist_bert_run(mxt, model, init, tokens, kvstore, skip_push=False,
                   profile_dir=None):
    """DIST_STEPS Adam (multi_precision) steps of ``model`` from the
    weights ``init`` on ``tokens`` through ``Trainer(kvstore=...)``, each
    step recorded through ``autograd.record`` and ``Trainer.step(DIST_B)``.
    Returns (the global mean losses, a row a step, each parameter's (fp32
    master, first moment, second moment), trainer). With ``skip_push``
    this rank's gradients are zeroed before the push (the planted fault:
    its pushes carry nothing). With ``profile_dir`` one more step runs
    under torch.profiler after the checked ones."""
    import torch
    import torch.distributed as tdist
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.ops import _kernels
    params = list(model.collect_params().values())
    _reset(params, init)
    trainer = mxt.gluon.Trainer(model.collect_params(), "adam", {
        "learning_rate": PAR_LR, "multi_precision": True}, kvstore=kvstore)
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, rows = [], []
    tokens = mxt.nd.NDArray(tokens)     # NDArrays: backward seeds ones

    def one_step():
        with autograd.record():
            loss = loss_fn(model(tokens), tokens)
        loss.backward()
        if skip_push:
            for p in params:
                p.grad()._data.zero_()
        trainer.step(DIST_B)
        return loss
    for _ in range(DIST_STEPS):
        kv = trainer._kvstore
        before = dict(kv.collective_stats) if kv is not None else None
        torch.cuda.synchronize()
        _kernels.reset_launches()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        h0 = time.perf_counter()
        s.record()
        loss = one_step()
        e.record()
        e.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        row = dict(step_ms=s.elapsed_time(e), host_ms=host_ms,
                   launches={k: _kernels.LAUNCHES.get(k, 0) for k in (
                       "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
        mean = loss._data.detach().float().mean().reshape(1)
        kv = trainer._kvstore
        if kv is not None:
            tdist.all_reduce(mean)
            mean = mean / kv.num_workers
            after = kv.collective_stats
            row.update(
                collective_ms=(after["seconds"] - (before or {}).get(
                    "seconds", 0.0)) * 1e3,
                bytes_pushed=after["bytes"] - (before or {}).get("bytes", 0),
                collectives=after["collectives"] - (before or {}).get(
                    "collectives", 0))
        losses.append(float(mean))
        rows.append(row)
    states = trainer._kvstore._updater.states if trainer._update_on_kvstore \
        else dict(enumerate(trainer._states))
    after = [(st[0].detach().clone(), st[1][0].detach().clone(),
              st[1][1].detach().clone())
             for _, st in sorted(states.items())]
    if profile_dir is not None:
        rows.append(dict(profiled=_profiled_step(one_step, profile_dir)))
    return losses, rows, after, trainer


def _profiled_step(step, out_dir):
    """One call of ``step`` under torch.profiler: the device's idle share
    over the host's window and, from the chrome trace through the port's
    ``telemetry.profstats``, its idle ratio and device time by
    category."""
    from torch.profiler import ProfilerActivity, profile
    import torch
    from incubator_mxnet_tpu_torch.telemetry import profstats
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if torch.cuda.is_available() else
                 [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, "trace-%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    summary = profstats.summarize_trace(path)
    busy_ms = summary["device_busy_us"] / 1e3
    os.remove(path)
    return dict(window_ms=window_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / window_ms,
                profstats_idle_ratio=summary["device_idle_ratio"],
                categories_ms={k: v["self_us"] / 1e3 for k, v in
                               summary["categories"].items()},
                top=[(o["op"][:60], o["self_us"] / 1e3)
                     for o in summary["ops"][:6]])


def dist_worker(opts):
    """One rank of phase 23 (started by tools/launch.py; the package import
    started the gloo group from the launcher's environment). Writes its
    results to ``<out>/rank<r>.json``."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.parallel import dist
    ready_s = time.time() - opts.t0
    rank, n = dist.rank(), dist.num_workers()
    res = dict(rank=rank, workers=n, backend=dist.backend(), start_s=ready_s,
               device=str(dist._STATE["device"]))
    check(n == DIST_N and res["backend"] == "gloo",
          "rank %d: %d workers over %s" % (rank, n, res["backend"]))
    res["gloo_cuda"] = _gloo_cuda_collectives(dist)
    t0 = time.perf_counter()
    res["matrix"] = _dist_matrix(mxt, rank, n)
    res["matrix_s"] = time.perf_counter() - t0
    dev = mxt.context.as_device(mxt.gpu(0))
    model = models.BERTModel(**BERT)
    model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                     .Generator(device=dev).manual_seed(23))
    model.cast("bfloat16")
    params = list(model.collect_params().values())
    init = [p._tensor().detach().clone() for p in params]
    everything = torch.from_numpy(onp.random.RandomState(23).randint(
        0, BERT["vocab_size"], (BERT_TRAIN_B, BERT_S)).astype("int32")) \
        .to(dev)
    mine = everything[rank * DIST_B:(rank + 1) * DIST_B]
    losses, rows, states, trainer = _dist_bert_run(
        mxt, model, init, mine, "dist_sync", profile_dir=opts.out)
    res.update(losses=losses, steps=rows)
    res["digests"] = _sha256_leaves(
        [p._tensor() for p in params] + [t for st in states for t in st])
    del trainer
    f_losses, _, f_states, trainer = _dist_bert_run(
        mxt, model, init, mine, "dist_sync", skip_push=rank == 1)
    res["fault_digests"] = _sha256_leaves([t for st in f_states
                                           for t in st])
    del trainer
    if rank == 0:
        res["check"] = _dist_against_one_process(
            mxt, model, init, everything, mine, losses, states, f_losses,
            f_states)
    with open(os.path.join(opts.out, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    log("rank %d: done %.1f s after the launch" % (
        rank, time.time() - opts.t0))
    return 0


def _dist_against_one_process(mxt, model, init, everything, mine, losses,
                              states, f_losses, f_states):
    """(b), on rank 0 once the collectives are done: the two ranks'
    parameters, first moments and losses against one process's Trainer on
    the whole batch at the same effective scale, with phase 22(c)'s bounds
    (each leaf's bf16 rounding error measured on this rank's rows), and
    the planted fault (rank 1's pushes carry nothing) must fail them. The
    scale: the ranks push their gradient sums over 32 rows each, the store
    sums them and the update rescales by 1/DIST_B, so the step takes the
    global 64 rows' gradient sum over 32, twice the batch mean; one
    process takes the 64 rows and Trainer.step(DIST_B), the same."""
    import torch
    names = list(model.collect_params().keys())
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    _reset(list(model.collect_params().values()), init)
    _, part_grads = _leaf_grads(model, lambda: loss_fn(model(mine), mine))
    zero, noise = _rounding(model, lambda: loss_fn(model(mine), mine),
                            part_grads, "dist BERT B %d" % DIST_B)
    del part_grads
    one_l, one_rows, one_s, trainer = _dist_bert_run(
        mxt, model, init, everything, None)
    del trainer
    torch.cuda.empty_cache()

    def two(st):
        return [(m, mean) for m, mean, _ in st]
    out = dict(one_process_losses=one_l,
               one_process_step_ms=[r["step_ms"] for r in one_rows],
               zero_to_rounding=zero)
    passes, out["two_ranks"] = _dp_report(
        "dist_sync (2 ranks) against one process", *_dp_errors(
            losses, two(states), one_l, two(one_s), init, names, zero),
        noise)
    fault_passes, out["planted_skipped_push"] = _dp_report(
        "planted: rank 1 skips its push", *_dp_errors(
            f_losses, two(f_states), one_l, two(one_s), init, names, zero),
        noise)
    out.update(passes=passes, planted_fails=not fault_passes)
    return out


def dist_nccl_one(opts):
    """(d): a dist_device_sync store over NCCL in a group of one process:
    init, push and pull of a gradient list of full-width BERT's shapes
    (bf16), the pulled values the pushed ones bit for bit. Writes
    ``<out>/nccl.json``."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.parallel import dist
    dist.init_distributed("127.0.0.1:%d" % _free_port(), 1, 0,
                          backend="nccl", device="cuda:0",
                          timeout=DIST_GROUP_TIMEOUT_S)
    check(dist.backend() == "nccl", "backend %s" % dist.backend())
    dev = torch.device("cuda", 0)
    model = models.BERTModel(**BERT)
    model.initialize(ctx=mxt.gpu(0))
    shapes = [tuple(p.shape) for p in model.collect_params().values()]
    del model
    g = torch.Generator(device=dev).manual_seed(5)
    grads = [mxt.nd.NDArray(torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16)) for s in shapes]
    keys = list(range(len(shapes)))
    kv = mxt.kv.create("dist_device_sync")
    kv.init(keys, [mxt.nd.NDArray(torch.zeros(s, dtype=torch.bfloat16,
                                              device=dev)) for s in shapes])
    outs = [mxt.nd.NDArray(torch.empty(s, dtype=torch.bfloat16, device=dev))
            for s in shapes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv.push(keys, grads)
    kv.pull(keys, out=outs)
    torch.cuda.synchronize()
    push_pull_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(o._data, w._data) for o, w in zip(outs, grads)),
          "NCCL world of one: a pulled value is not the pushed one")
    st = kv.collective_stats
    res = dict(backend=dist.backend(), leaves=len(shapes),
               bytes=st["bytes"], collectives=st["collectives"],
               push_pull_ms=push_pull_ms)
    with open(os.path.join(opts.out, "nccl.json"), "w") as f:
        json.dump(res, f)
    return 0


def _small_module_on_contexts(mxt, ctx, x, y):
    """A small fp32 MLP symbol through two SGD-momentum updates over
    ``ctx``: (parameters, outputs)."""
    import numpy as onp
    sym = mxt.sym
    net = sym.FullyConnected(sym.var("data"), num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="tanh", name="t1")
    net = sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=4,
                                               name="fc2"), name="softmax")
    mod = mxt.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    rng = onp.random.RandomState(3)
    dev = ctx[0] if isinstance(ctx, list) else ctx
    mod.init_params(arg_params={
        k: mxt.nd.array((rng.randn(*s) * 0.3).astype("float32"), ctx=dev)
        for k, s in (("fc1_weight", (16, x.shape[1])), ("fc1_bias", (16,)),
                     ("fc2_weight", (4, 16)), ("fc2_bias", (4,)))})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    batch = mxt.io.DataBatch(data=[mxt.nd.array(x, ctx=dev)],
                             label=[mxt.nd.array(y, ctx=dev)])
    for _ in range(2):
        mod.forward_backward(batch)
        mod.update()
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            mod.get_outputs()[0].asnumpy())


def _small_estimator(mxt, ctx):
    """Estimator.fit of a Dense net (2 epochs x 3 batches) with a logging
    handler on ``ctx``: (weight, bias, evaluate's accuracy)."""
    import numpy as onp
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator
    net = mxt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=ctx)
    rng = onp.random.RandomState(4)
    net.weight.set_data(mxt.nd.array(
        rng.uniform(-0.5, 0.5, (3, 4)).astype("float32"), ctx=ctx))
    net.bias.set_data(mxt.nd.zeros((3,), ctx=ctx))
    batches = [(mxt.nd.array(rng.randn(4, 4).astype("float32"), ctx=ctx),
                mxt.nd.array(rng.randint(0, 3, 4).astype("float32"),
                             ctx=ctx)) for _ in range(3)]
    est = estimator.Estimator(
        net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=mxt.metric.Accuracy(),
        trainer=mxt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.5}))
    est.fit(batches, epochs=2, event_handlers=[
        estimator.LoggingHandler(metrics=est.train_metrics)])
    return (net.weight.data().asnumpy(), net.bias.data().asnumpy(),
            est.evaluate(batches)[0].get()[1])


def _small_svrg(mxt, ctx):
    """One SVRGModule.fit epoch of a linear regression symbol on ``ctx``:
    (weight, mu)."""
    import numpy as onp
    S = mxt.sym
    net = S.LinearRegressionOutput(
        S.FullyConnected(S.var("data"), num_hidden=1, name="fc"),
        S.var("lin_reg_label"), name="lro")
    rng = onp.random.RandomState(0)
    x = rng.randn(16, 3).astype("float32")
    y = (x @ onp.array([[1.5], [-2.0], [0.5]], "float32") + 0.3).ravel()
    it = mxt.io.NDArrayIter(x, y, batch_size=4, label_name="lin_reg_label")
    mod = mxt.contrib.svrg.SVRGModule(net, label_names=["lin_reg_label"],
                                      context=ctx, update_freq=1)
    mod.fit(it, num_epoch=1, eval_metric="mse", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05),),
            arg_params={"fc_weight": mxt.nd.array(
                rng.randn(1, 3).astype("float32") * 0.1, ctx=ctx),
                "fc_bias": mxt.nd.zeros((1,), ctx=ctx)})
    return (mod.get_params()[0]["fc_weight"].asnumpy(),
            mod._mu["fc_weight"].asnumpy())


def _close_rel(got, want):
    import numpy as onp
    want = onp.asarray(want, "float64")
    return float(onp.abs(onp.asarray(got, "float64") - want).max()) / max(
        float(onp.abs(want).max()), 1e-30)


def dist_single_process_checks():
    """(e)'s single-process part on the card, fp32 with TF32 off:
    Module(context=[gpu(0), gpu(0)]) against one context, Estimator.fit
    and one SVRGModule.fit epoch against the CPU, each within
    DIST_SMALL_TOL of the largest value."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = onp.random.RandomState(8)
        x = rng.randn(8, 6).astype("float32")
        y = rng.randint(0, 4, 8).astype("float32")
        two = _small_module_on_contexts(mxt, [mxt.gpu(0), mxt.gpu(0)], x, y)
        one = _small_module_on_contexts(mxt, mxt.gpu(0), x, y)
        errs = {"module_two_contexts": max(
            [_close_rel(two[0][k], one[0][k]) for k in one[0]]
            + [_close_rel(two[1], one[1])])}
        card = _small_estimator(mxt, mxt.gpu(0))
        host = _small_estimator(mxt, mxt.cpu())
        errs["estimator"] = max(_close_rel(card[0], host[0]),
                                _close_rel(card[1], host[1]))
        check(card[2] == host[2], "Estimator: accuracy %s on the card, %s "
              "on the CPU" % (card[2], host[2]))
        card, host = _small_svrg(mxt, mxt.gpu(0)), _small_svrg(mxt, mxt.cpu())
        errs["svrg"] = max(_close_rel(card[0], host[0]),
                           _close_rel(card[1], host[1]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log("  dist: single-process checks on the card (relative to the "
        "largest value, tol %g): %s" % (DIST_SMALL_TOL, errs))
    check(all(e <= DIST_SMALL_TOL for e in errs.values()),
          "dist single-process checks: %s" % errs)
    return errs


def _dist_verdicts(ranks, nccl_res):
    """Phase 23's checks on the workers' results (each fatal) and its
    lines; returns the main path's K1/K2/K3 launches (both ranks' three
    steps)."""
    for r in ranks:
        check(all(v == "ok" for v in r["gloo_cuda"].values()),
              "rank %d: gloo collectives on CUDA tensors: %s"
              % (r["rank"], r["gloo_cuda"]))
    # (e) the matrix: every digest the same on both ranks, but the
    # diverged dist_async one
    for k in ranks[0]["matrix"]:
        same = len({r["matrix"][k] for r in ranks}) == 1
        check(same != (k == "async_diverged"),
              "dist matrix %s: digests %s" % (k, [r["matrix"][k]
                                                  for r in ranks]))
    # (a) bitwise equal across ranks, leaf by leaf
    diff = [i for i, (a, b) in enumerate(zip(ranks[0]["digests"],
                                             ranks[1]["digests"])) if a != b]
    check(not diff and len(ranks[0]["digests"]) == len(
        ranks[1]["digests"]), "dist BERT: leaves %s differ across ranks"
        % diff[:8])
    check(ranks[0]["fault_digests"] == ranks[1]["fault_digests"],
          "dist BERT: the planted fault's ranks differ")
    # (c) K1/K2/K3 a step: one each a layer
    per = BERT["num_layers"]
    for r in ranks:
        for i, row in enumerate(r["steps"][:DIST_STEPS]):
            check(all(v == per for v in row["launches"].values()),
                  "rank %d step %d: K1/K2/K3 launched %s, expected %d each"
                  % (r["rank"], i, row["launches"], per))
    got = ranks[0]["check"]
    check(got["passes"], "dist BERT (2 ranks) against one process: %s"
          % got["two_ranks"])
    check(got["planted_fails"], "the dist check passes the planted skipped "
          "push: %s" % got["planted_skipped_push"])
    # (d)
    check(nccl_res["backend"] == "nccl", "NCCL world of one: %s" % nccl_res)
    launches = {"dist_bert": {k: sum(row["launches"][k] for r in ranks
                                     for row in r["steps"][:DIST_STEPS])
                              for k in ("flash_fwd", "flash_bwd_dkv",
                                        "flash_bwd_dq")}}
    for r in ranks:
        steps = r["steps"][:DIST_STEPS]
        prof = r["steps"][DIST_STEPS]["profiled"]
        log("  dist rank %d: backend %s, started in %.1f s, step ms %s "
            "(host %s), kvstore collectives ms a step %s (%d collectives, "
            "%.1f MB sent a step), profiled step: idle %.1f%% of %.0f ms "
            "(profstats %.1f%%), device ms by category %s, top %s; "
            "losses %s" % (
                r["rank"], r["backend"], r["start_s"],
                ["%.1f" % s["step_ms"] for s in steps],
                ["%.1f" % s["host_ms"] for s in steps],
                ["%.1f" % s["collective_ms"] for s in steps],
                steps[-1]["collectives"], steps[-1]["bytes_pushed"] / 1e6,
                100 * prof["idle_share"], prof["window_ms"],
                100 * (prof["profstats_idle_ratio"] or 0.0),
                {k: round(v, 1) for k, v in prof["categories_ms"].items()},
                prof["top"], ["%.4f" % v for v in r["losses"]]))
    log("  dist BERT: one process %s ms a step, losses %s; NCCL world of "
        "one: %d leaves, %.1f MB, push + pull %.1f ms" % (
            ["%.1f" % v for v in got["one_process_step_ms"]],
            ["%.4f" % v for v in got["one_process_losses"]],
            nccl_res["leaves"], nccl_res["bytes"] / 1e6,
            nccl_res["push_pull_ms"]))
    return launches


def dist_phase(card):
    """Phase 23 (``--dist-only``): several processes. Two workers on the
    one card (cuda:0, so gloo: NCCL refuses two ranks on one GPU), started
    through the reference's own launcher, tools/launch.py -n 2, run (e)'s
    small-size dist matrix, then train full-width BERT (S 512, bf16,
    flash, Adam multi_precision, B 32 each of the global 64) three steps
    through autograd.record and Trainer(kvstore="dist_sync"), then the
    same with a planted fault; rank 0 then holds both to one process's
    Trainer on the whole batch (b). The parent checks (a) every parameter
    and optimizer state bitwise equal across the ranks (SHA-256 a leaf),
    (c) K1/K2/K3 launches a step, (d) a dist_device_sync store over NCCL
    in a group of one process (its own process, started with the
    workers), and (e)'s single-process checks. Returns (launches by path,
    summary)."""
    import shutil
    t0 = time.perf_counter()
    build_kernels()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["incubator_mxnet_tpu_torch"].__file__)))
    out = _build_tmp()
    env = dict(os.environ, MXTPU_DIST_TIMEOUT_S=str(DIST_GROUP_TIMEOUT_S))
    me = [sys.executable, os.path.abspath(__file__), "--root", root,
          "--out", out]
    try:
        nccl = subprocess.Popen(me + ["--dist-nccl-one"], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        launch_t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "tools", "launch.py"),
                 "-n", str(DIST_N), "--coord-addr",
                 "127.0.0.1:%d" % _free_port()] + me + [
                    "--dist-worker", "--t0", repr(launch_t0)],
                env=env, capture_output=True, text=True,
                timeout=DIST_WORKER_TIMEOUT_S)
        finally:
            try:
                nccl_out, _ = nccl.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                nccl.kill()
                nccl_out, _ = nccl.communicate()
        for line in proc.stdout.splitlines():
            log("  [dist] " + line)
        for line in nccl_out.splitlines():
            log("  [nccl] " + line)
        if proc.returncode != 0:
            log(proc.stderr[-8000:])
        check(proc.returncode == 0, "dist workers exited with %d"
              % proc.returncode)
        check(nccl.returncode == 0, "the NCCL world of one exited with %d"
              % nccl.returncode)
        ranks = []
        for r in range(DIST_N):
            with open(os.path.join(out, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        with open(os.path.join(out, "nccl.json")) as f:
            nccl_res = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    launches = _dist_verdicts(ranks, nccl_res)
    singles = dist_single_process_checks()
    for r in ranks:
        r["leaves_hashed"] = len(r.pop("digests"))
        r.pop("fault_digests")
    return launches, dict(card=card, ranks=ranks, nccl_world_of_one=nccl_res,
                          single_process=singles,
                          seconds=time.perf_counter() - t0)


RESNET_INT8_B = 256         # bench.py bench_quantized_inference's batch
RESNET_CALIB_B = 32         # its calibration batch (one)
RESNET_INT8_TIMED = (4, 5)  # (alternating pairs, forwards a leg a pair)
RESNET_INT8_FLOPS = 8.2e9   # bench.py:416: 4.1 GMACs x 2 at 224 x 224
PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8 tensor-core rate
INT8_SMALL_TOL = 1e-2       # tests/test_torch_quantization.py: logits,
                            # relative Frobenius, equal argmax
ONNX_B = 32
ONNX_TOL = 1e-5             # of the largest probability, TF32 off
CUSTOM_TOL = 1e-5           # the custom-op MLP and TorchBlock card vs CPU
CUSTOM_STEPS = 3


def _small_int8_net(mxt, ctx, x, arrays=None):
    """tests/test_torch_quantization.py's net (a Conv-BN-ReLU group, a
    max-pool, a BottleneckV1, a group after it, a max-pool and a Dense
    head) on ``ctx``: its weights from ``arrays`` (else Xavier from seed 0
    and random BatchNorm statistics), quantized on ``x``. Returns (the
    float arrays, the net's logits, its int8 weights in order)."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch.contrib import quantization as quant
    nn = mxt.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.MaxPool2D(2, 2),
            mxt.gluon.model_zoo.vision.BottleneckV1(16, 1, downsample=True,
                                                    in_channels=8),
            nn.Conv2D(8, 1, in_channels=16), nn.BatchNorm(in_channels=8),
            nn.Activation("relu"), nn.MaxPool2D(2, 2),
            nn.Dense(10, in_units=8 * 8 * 8))
    net.initialize(mxt.init.Xavier(), ctx=ctx,
                   generator=torch.Generator().manual_seed(0))
    xa = mxt.nd.array(x, ctx=ctx)
    net(xa)
    if arrays is None:
        rng = onp.random.RandomState(6)
        arrays = {}
        for name, p in sorted(net._collect_params_with_prefix().items()):
            a = p.data().asnumpy()
            if name.endswith(("running_var", "gamma")):
                a = onp.abs(rng.randn(*a.shape)).astype("float32") + 0.5
            elif name.endswith(("running_mean", "beta")):
                a = (rng.randn(*a.shape) * 0.1).astype("float32")
            arrays[name] = a
    mxt.convert.from_jax_params(net, arrays)
    quant.quantize_net(net, calib_data=[(xa,)], num_calib_batches=1)
    wq = []

    def walk(b):
        for c in b._modules.values():
            if c is None:
                continue
            w = getattr(c, "_wq", None)
            inner = c.__dict__.get("_inner")
            if w is None and inner is not None:
                w = inner._wq
            if w is not None:
                wq.append(w.asnumpy())
            walk(c)
    walk(net)
    return arrays, net(xa).asnumpy(), wq


def check_int8_small():
    """Phase 24(a)'s small gate: the test's int8 net on the card against
    the same net on the CPU (same float weights, same calibration batch):
    the int8 weights equal, the logits within INT8_SMALL_TOL relative
    Frobenius with equal argmax."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    x = onp.random.RandomState(7).randn(4, 3, 32, 32).astype("float32")
    arrays, cpu_logits, cpu_wq = _small_int8_net(mxt, mxt.cpu(), x)
    with _TF32(False):
        _, gpu_logits, gpu_wq = _small_int8_net(mxt, mxt.gpu(0), x, arrays)
    check(len(cpu_wq) == len(gpu_wq) and all(
        onp.array_equal(a, b) for a, b in zip(cpu_wq, gpu_wq)),
        "the small int8 net's int8 weights differ card vs CPU")
    rel = float(onp.linalg.norm(gpu_logits - cpu_logits)
                / onp.linalg.norm(cpu_logits))
    check(rel <= INT8_SMALL_TOL and (gpu_logits.argmax(1)
                                     == cpu_logits.argmax(1)).all(),
          "the small int8 net card vs CPU: %.3g relative, argmax %s vs %s"
          % (rel, gpu_logits.argmax(1), cpu_logits.argmax(1)))
    return dict(rel_frobenius=rel, int8_weights=len(gpu_wq))


def _leg_ms(step, x, n):
    """ms a forward of ``step`` over ``n`` back-to-back calls (CUDA
    events)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        step(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def int8_resnet(card):
    """Phase 24(a): bench.py's bench_quantized_inference on the card."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.contrib import quantization as quant
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    def net_from_seed():
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                       .Generator(device="cuda:0").manual_seed(0))
        net.cast("bfloat16")
        return net

    x = torch.randn((RESNET_INT8_B, 3, 224, 224), device="cuda:0",
                    generator=torch.Generator(device="cuda:0")
                    .manual_seed(1)).to(torch.bfloat16)
    small = check_int8_small()
    fp = net_from_seed()
    fp(x[:1])
    qnet = net_from_seed()
    qnet(x[:1])
    t0 = time.perf_counter()
    quant.quantize_net(qnet, calib_data=[(x[:RESNET_CALIB_B],)],
                       num_calib_batches=1)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    groups = sum(type(m).__name__ == "_QuantizedConvGroup"
                 for m in qnet.modules())
    chained = sum(bool(getattr(m, "emit_int8", False))
                  for m in qnet.modules())
    bf16_step, int8_step = jit.EvalStep(fp), jit.EvalStep(qnet)
    ref = bf16_step(x).asnumpy()
    torch.cuda.reset_peak_memory_stats()
    q1 = int8_step(x).asnumpy()             # capture
    q2 = int8_step(x).asnumpy()             # replay
    int8_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        eager = qnet(x).float().cpu().numpy()
    check(bool(onp.isfinite(q2).all()), "int8 ResNet-50 logits not finite")
    check(onp.array_equal(q1, q2) and onp.array_equal(q2, eager),
          "int8 ResNet-50: captured %s eager bit for bit (max |d| %.3g)"
          % ("!=", float(onp.abs(q2 - eager).max())))
    pairs, n = RESNET_INT8_TIMED
    legs = []
    for _ in range(pairs):
        legs.append((_leg_ms(bf16_step, x, n), _leg_ms(int8_step, x, n)))
    bf16_ms = min(b for b, _ in legs)
    int8_ms = min(i for _, i in legs)
    a, b = ref.astype("float64").ravel(), q2.astype("float64").ravel()
    cos = float(a @ b / (onp.linalg.norm(a) * onp.linalg.norm(b)))
    agree = float((ref.argmax(1) == q2.argmax(1)).mean())
    int8_img_s = RESNET_INT8_B / int8_ms * 1e3
    row = dict(
        card=card, batch=RESNET_INT8_B, bf16_ms=bf16_ms, int8_ms=int8_ms,
        legs_ms=legs, bf16_img_s=RESNET_INT8_B / bf16_ms * 1e3,
        int8_img_s=int8_img_s, int8_over_bf16=bf16_ms / int8_ms,
        int8_tops=int8_img_s * RESNET_INT8_FLOPS / 1e12,
        int8_share_of_peak=int8_img_s * RESNET_INT8_FLOPS / PEAK_INT8_OPS,
        int8_peak_gb=int8_peak / 1e9, logit_cos=cos, argmax_agreement=agree,
        quantize_s=quantize_s, conv_groups=groups, int8_chained=chained,
        small_card_vs_cpu=small)
    log("int8 ResNet-50 B %d: bf16 %.2f ms, int8 %.2f ms (%.1f img/s, "
        "%.1f TOPS), cos %.4f, argmax %.3f, %d groups (%d emit int8)"
        % (RESNET_INT8_B, bf16_ms, int8_ms, int8_img_s, row["int8_tops"],
           cos, agree, groups, chained))
    del fp, qnet, bf16_step, int8_step
    release_graphs()
    return row


def int8_bert_served(card):
    """Phase 24(b): full-width BERT with every Dense int8, served behind
    ModelRegistry beside the bf16 net. Returns (K1 launches, row)."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch import jit, serving
    from incubator_mxnet_tpu_torch.contrib import quantization as quant
    from incubator_mxnet_tpu_torch.ops import _kernels, attention

    rng = onp.random.RandomState(0)
    rows = rng.randint(0, BERT["vocab_size"], (BERT_REQUESTS, BERT_S)) \
        .astype("int32")
    bf16 = _serving_bert(0)
    qnet = _serving_bert(0)
    t0 = time.perf_counter()
    quant.quantize_net(qnet, calib_data=[(torch.from_numpy(
        rows[:BERT_BUCKET]).cuda(),)], num_calib_batches=1)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    dense = sum(type(m).__name__ == "_QuantizedDenseBlock"
                for m in qnet.modules())
    dtypes = set()
    launch = attention._flash_fwd_cuda

    def noted(q, *a, **k):
        dtypes.add(str(q.dtype))
        return launch(q, *a, **k)
    reg = serving.ModelRegistry()
    out = {}
    try:
        attention._flash_fwd_cuda = noted
        reg.load("bert", bf16, max_batch_size=BERT_BUCKET,
                 batch_timeout_ms=50)
        reg.load("bert_int8", qnet, max_batch_size=BERT_BUCKET,
                 batch_timeout_ms=50)
        for name in ("bert", "bert_int8"):
            reg.predict(name, rows[0])                 # warm-up: captures
        attention._flash_fwd_cuda = launch
        for name in ("bert", "bert_int8"):
            base = reg.metrics(name).batch_count
            replies, lat, errors = {}, [], []

            def client(c):
                try:
                    t = time.perf_counter()
                    reqs = {i: reg.submit(name, rows[i])
                            for i in range(c, BERT_REQUESTS, CLIENTS)}
                    for i, r in reqs.items():
                        replies[i] = r.result(120)[0]
                        lat.append((time.perf_counter() - t) * 1e3)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(CLIENTS)]
            torch.cuda.synchronize()
            _kernels.reset_launches()
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            check(not any(t.is_alive() for t in threads),
                  "a %s client hung" % name)
            check(not errors, "%s requests failed: %r" % (name, errors[:3]))
            out[name] = dict(replies=replies, lat=sorted(lat),
                             launches=dict(_kernels.LAUNCHES),
                             batches=reg.metrics(name).batch_count - base)
    finally:
        attention._flash_fwd_cuda = launch
        reg.close()
    q = out["bert_int8"]
    k1 = q["launches"].get("flash_fwd", 0)
    check(q["batches"] > 0 and out["bert"]["batches"] > 0,
          "int8 BERT served: the registry ran %d int8 and %d bf16 batches"
          % (q["batches"], out["bert"]["batches"]))
    check(k1 == BERT["num_layers"] * q["batches"],
          "int8 BERT served: flash_fwd launched %d times for %d batches "
          "(expected %d a batch)" % (k1, q["batches"], BERT["num_layers"]))
    check(dtypes == {"torch.bfloat16", "torch.float32"},
          "K1's input types on the two nets: %s" % sorted(dtypes))
    step = jit.EvalStep(qnet)
    direct = onp.concatenate([step(rows[i:i + BERT_BUCKET]).asnumpy()
                              for i in range(0, BERT_REQUESTS,
                                             BERT_BUCKET)])
    worst, cos = 0.0, []
    for i in range(BERT_REQUESTS):
        r = q["replies"][i]
        check(r.dtype == onp.float32 and r.shape == (BERT_S,
                                                     BERT["vocab_size"]),
              "int8 reply %d: %s %s" % (i, r.dtype, r.shape))
        check(bool(onp.isfinite(r).all()), "int8 reply %d not finite" % i)
        worst = max(worst, float(onp.abs(r - direct[i]).max()))
        a = out["bert"]["replies"][i].astype("float64").ravel()
        b = r.astype("float64").ravel()
        cos.append(float(a @ b / (onp.linalg.norm(a) * onp.linalg.norm(b))))
    check(worst == 0.0, "int8 replies differ from the direct EvalStep "
          "forward by up to %.3g" % worst)
    row = dict(
        card=card, requests=BERT_REQUESTS, bucket=BERT_BUCKET,
        int8_dense_blocks=dense, quantize_s=quantize_s,
        k1_instantiation="flash_fwd_fma (fp32: the int8 Dense returns "
                         "fp32, as in the reference)",
        k1_launches=k1, int8_batches=q["batches"],
        bf16_batches=out["bert"]["batches"],
        int8_p50_ms=_pct(q["lat"], 50), int8_max_ms=max(q["lat"]),
        bf16_p50_ms=_pct(out["bert"]["lat"], 50),
        bf16_max_ms=max(out["bert"]["lat"]),
        logit_cos_min=min(cos), logit_cos_mean=sum(cos) / len(cos),
        reply_dtype="float32")
    log("int8 BERT served: p50 %.1f ms (bf16 %.1f), max %.1f (bf16 %.1f), "
        "K1 %d for %d batches, cos %.4f"
        % (row["int8_p50_ms"], row["bf16_p50_ms"], row["int8_max_ms"],
           row["bf16_max_ms"], k1, q["batches"], row["logit_cos_min"]))
    del bf16, qnet, step
    release_graphs()
    return {"flash_fwd": k1}, row


def onnx_round_trip(card):
    """Phase 24(c): phase 17's ResNet-50 v1 symbol through export_model
    and import_model, bound on gpu(0) through Module: B ONNX_B fp32 with
    TF32 off, the imported graph within ONNX_TOL of the original."""
    import shutil
    import tempfile
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.contrib import onnx as tonnx
    sym = resnet_v1_symbol(mxt.sym, (3, 4, 6, 3),
                           (64, 256, 512, 1024, 2048), 1000, 224)
    shape = (ONNX_B, 3, 224, 224)
    rng = onp.random.RandomState(3)
    x = rng.randn(*shape).astype("float32")
    tmp = tempfile.mkdtemp(prefix="mxtpu_onnx_")
    try:
        with _TF32(False):
            mod = mxt.mod.Module(sym, context=mxt.gpu(0))
            mod.bind([("data", shape)], [("softmax_label", (ONNX_B,))],
                     for_training=False)
            mod.init_params(_xavier())
            arg, aux = mod.get_params()
            aux = {k: mxt.nd.array(
                (onp.abs(rng.randn(*v.shape)) + 0.5 if "var" in k
                 else rng.randn(*v.shape) * 0.1).astype("float32"),
                ctx=mxt.cpu()) for k, v in aux.items()}
            mod.set_params(arg, aux)
            batch = mxt.io.DataBatch([mxt.nd.array(x, ctx=mxt.cpu())],
                                     [mxt.nd.zeros((ONNX_B,), ctx=mxt.cpu())])
            mod.forward(batch, is_train=False)
            want = mod.get_outputs()[0].asnumpy()
            path = os.path.join(tmp, "resnet50_v1.onnx")
            t0 = time.perf_counter()
            tonnx.export_model(sym, {**arg, **aux},
                               [shape, (ONNX_B,)], onnx_file_path=path)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sym2, arg2, aux2 = tonnx.import_model(path)
            mod2 = mxt.mod.Module(sym2, label_names=None,
                                  context=mxt.gpu(0))
            mod2.bind([("data", shape)], for_training=False)
            mod2.set_params(arg2, aux2)
            import_s = time.perf_counter() - t0
            mod2.forward(mxt.io.DataBatch([mxt.nd.array(x, ctx=mxt.cpu())]),
                         is_train=False)
            got = mod2.get_outputs()[0].asnumpy()
        mb = os.path.getsize(path) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err = float(onp.abs(got - want).max() / onp.abs(want).max())
    check(got.shape == want.shape and err <= ONNX_TOL,
          "ONNX round trip of ResNet-50 v1: %.3g of the largest value" % err)
    row = dict(card=card, batch=ONNX_B, export_s=export_s, file_mb=mb,
               import_bind_s=import_s, max_rel_err=err)
    log("ONNX ResNet-50 v1: export %.2f s, %.1f MB, import+bind %.2f s, "
        "%.3g of the largest value" % (export_s, mb, import_s, err))
    return row


def np_on_card(card, root):
    """Phase 24(d): every mx.np/mx.npx case of tests/np_cases.py on the
    card against the same call on the CPU (fp32 within np_cases' ATOL +
    RTOL with TF32 off, ints and bools exact), np.random and npx.random
    by moments, and a gradient through a chain of mx.np ops."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    sys.path.insert(0, os.path.join(root, "tests"))
    import np_cases as C
    np, npx = mxt.np, mxt.npx
    cases = C.NP_CASES + C.LINALG_CASES + C.NPX_CASES + C.NPX_IMAGE_CASES
    failed = []
    t0 = time.perf_counter()
    with _TF32(False):
        with mxt.cpu():
            xc = C.inputs(np)
        with mxt.gpu(0):
            xg = C.inputs(np)
        for label, fn in cases:
            try:
                with mxt.cpu():
                    want = C.host(fn(np, npx, xc))
                with mxt.gpu(0):
                    got = C.host(fn(np, npx, xg))
                C.compare(got, want, label)
            except Exception as e:  # noqa: BLE001 — listed below
                failed.append("%s: %s" % (label, repr(e)[:300]))
        for label, draw, moments in C.RANDOM_CASES:
            try:
                with mxt.gpu(0):
                    s = draw(np, npx)
                check(s._data.is_cuda, "%s drew on the host" % label)
                C.moments_ok(s.asnumpy(), *moments, label)
            except Exception as e:  # noqa: BLE001 — listed below
                failed.append("%s: %s" % (label, repr(e)[:300]))
        grads = []
        rng = onp.random.RandomState(2)
        xh, wh = rng.randn(3, 4).astype("float32"), \
            rng.randn(4, 5).astype("float32")
        for ctx in (mxt.cpu(), mxt.gpu(0)):
            with ctx:
                a, b = np.array(xh), np.array(wh)
                a.attach_grad()
                with mxt.autograd.record():
                    h = np.tanh(np.matmul(a, b))
                    h = np.concatenate([h, np.exp(-np.square(h))], axis=1)
                    y = np.sum(np.mean(h, axis=0) * np.arange(10) / 10.0)
                y.backward()
                grads.append(a.grad.asnumpy())
        try:
            C.compare(grads[1], grads[0], "gradient through mx.np")
        except AssertionError as e:
            failed.append(repr(e)[:300])
    check(not failed, "mx.np/mx.npx card vs CPU: %d failed: %s"
          % (len(failed), failed[:5]))
    row = dict(card=card, cases=len(cases), random=len(C.RANDOM_CASES),
               seconds=time.perf_counter() - t0)
    log("mx.np/mx.npx: %d cases and %d draws card = CPU in %.1f s"
        % (len(cases), len(C.RANDOM_CASES), row["seconds"]))
    return row


def _custom_softmax(mxt):
    """MXNet's example/numpy-ops/custom_softmax.py: the softmax loss head
    as a CustomOp (backward p - onehot(label))."""
    nd = mxt.nd
    if "chip_smoke_softmax" in mxt.operator.get_all_registered():
        return

    class Softmax(mxt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            y = nd.exp(x - nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        y / nd.sum(y, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - nd.one_hot(in_data[1], y.shape[1]))
            self.assign(in_grad[1], "null", in_data[1])

    @mxt.operator.register("chip_smoke_softmax")
    class SoftmaxProp(mxt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def custom_bridge_text(card):
    """Phase 24(e): a custom softmax head on a small MLP (CUSTOM_STEPS SGD
    steps), a TorchBlock over torch.nn.Linear (one step), to_torch /
    from_torch and a contrib.text embedding, each card against the CPU."""
    import shutil
    import tempfile
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    import incubator_mxnet_tpu_torch.torch as bridge
    nd = mxt.nd
    _custom_softmax(mxt)
    rng = onp.random.RandomState(4)
    x = rng.randn(16, 8).astype("float32")
    lab = rng.randint(0, 4, (16,)).astype("float32")
    w0 = [(rng.randn(8, 16) * 0.3).astype("float32"),
          (rng.randn(16, 4) * 0.3).astype("float32")]

    def mlp(ctx):
        ws = [nd.array(w, ctx=ctx) for w in w0]
        xa, la = nd.array(x, ctx=ctx), nd.array(lab, ctx=ctx)
        for w in ws:
            w.attach_grad()
        for _ in range(CUSTOM_STEPS):
            with mxt.autograd.record():
                h = nd.relu(nd.dot(xa, ws[0]))
                p = nd.Custom(nd.dot(h, ws[1]), la,
                              op_type="chip_smoke_softmax")
            p.backward()
            for w in ws:
                w[:] = w - 0.5 * w.grad
        return [w.asnumpy() for w in ws]

    def linear(device):
        torch.manual_seed(0)
        lin = torch.nn.Linear(8, 4).to(device)
        blk = bridge.TorchBlock(lin)
        opt = torch.optim.SGD(lin.parameters(), lr=0.5)
        xa = nd.array(x, ctx=mxt.gpu(0) if device == "cuda" else mxt.cpu())
        xa.attach_grad()
        with mxt.autograd.record():
            loss = (blk(xa) ** 2).mean()
        loss.backward()
        opt.step()
        return lin.weight.detach().cpu().numpy(), xa.grad.asnumpy()

    with _TF32(False):
        got, want = mlp(mxt.gpu(0)), mlp(mxt.cpu())
        lin_got, lin_want = linear("cuda"), linear("cpu")
    mlp_err = max(float(onp.abs(g - w).max()) for g, w in zip(got, want))
    lin_err = max(float(onp.abs(g - w).max())
                  for g, w in zip(lin_got, lin_want))
    check(mlp_err <= CUSTOM_TOL, "custom-op MLP card vs CPU: %.3g" % mlp_err)
    check(lin_err <= CUSTOM_TOL, "TorchBlock card vs CPU: %.3g" % lin_err)
    a = nd.array(x, ctx=mxt.gpu(0))
    t = bridge.to_torch(a)
    check(t.is_cuda and t.data_ptr() != a._data.data_ptr(),
          "to_torch moved or aliased the array")
    t.add_(1.0)
    check(onp.array_equal(a.asnumpy(), x), "to_torch aliased the array")
    src = torch.from_numpy(x.copy())
    b = bridge.from_torch(src, ctx=mxt.gpu(0))
    src.add_(1.0)
    check(b._data.is_cuda and onp.array_equal(b.asnumpy(), x),
          "from_torch did not copy onto the card")
    tmp = tempfile.mkdtemp(prefix="mxtpu_text_")
    try:
        path = os.path.join(tmp, "emb.txt")
        vecs = {w: rng.randn(6).astype("float32")
                for w in ("the", "cat", "sat", "mat")}
        with open(path, "w") as f:
            for w, v in vecs.items():
                f.write(w + " " + " ".join("%r" % float(e) for e in v) + "\n")
        text = mxt.contrib.text
        vocab = text.Vocabulary(text.count_tokens_from_str(
            "the cat sat on the mat"))
        emb = text.CustomEmbedding(file_path=path, vocabulary=vocab,
                                   ctx=mxt.gpu(0))
        ids = nd.array(emb.to_indices(["cat", "mat", "on"]),
                       ctx=mxt.gpu(0))
        out = nd.Embedding(ids, emb.idx_to_vec, input_dim=len(vocab),
                           output_dim=emb.vec_len)
        want_text = onp.stack([vecs["cat"], vecs["mat"],
                               onp.zeros(6, "float32")])
        check(out._data.is_cuda and onp.array_equal(out.asnumpy(),
                                                    want_text),
              "contrib.text vectors through nd.Embedding on the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = dict(card=card, custom_mlp_max_abs=mlp_err,
               torch_block_max_abs=lin_err, text_tokens=len(vocab))
    log("custom op MLP %d steps card vs CPU %.3g, TorchBlock %.3g, text "
        "ok" % (CUSTOM_STEPS, mlp_err, lin_err))
    return row


def contrib_phase(card, root=None):
    """Phase 24: ROADMAP item 6 on the card (``--contrib-only``). Returns
    (the int8 BERT path's K1 launches, summary)."""
    import torch
    root = root or os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    summary = dict(card=card)
    summary["int8_resnet50"] = int8_resnet(card)
    launches, summary["int8_bert_served"] = int8_bert_served(card)
    summary["onnx"] = onnx_round_trip(card)
    summary["np_npx"] = np_on_card(card, root)
    summary["custom_bridge_text"] = custom_bridge_text(card)
    summary["seconds"] = time.perf_counter() - t0
    release_graphs()
    torch.cuda.empty_cache()
    return launches, summary


# ------------------------------------------- phase 25: the C ABI and native IO
NATIVE_FORWARDS = 3         # MXTPUPredForward calls on the B 8 x S 512 program
NATIVE_CPP_S = 64           # predict.cc's float32 BERT: B 1 x S NATIVE_CPP_S
NATIVE_CPP_TOL = 1e-5       # of the largest logit: printed text vs forward
NATIVE_REC_IMAGES = 512     # seeded 256x256 JPEGs of the native IO pass
NATIVE_REC_BATCH = 256
NATIVE_FIT_EPOCHS = 2       # 2 epochs x 2 batches of 256: 4 Module.fit steps
NATIVE_PART_B = 32          # the partitioned ResNet-50 v1's batch
NATIVE_CHILD_TIMEOUT_S = 300
# phase 25(f): the Python-free runner's output against ServedModel.predict's
# on the same bf16 program. Inductor fuses the glue around K1 and rounds
# where eager bf16 ops would not, so the two differ by a few bf16 roundings
# (2^-8 relative each): AOTI_BF16_TOL is four of them, relative to the
# largest |logit|. Against aoti_load_package in this process (the same
# package) the runner is held bit for bit.
AOTI_BF16_TOL = 4 * 2.0 ** -8
AOTI_BUNDLE_TIMEOUT_S = 600     # the bundle's compile in its child process
AOTI_PREDICT_TIMED = 2      # predict and in-process package forwards timed

# a fresh process's cold start through cpp_package's Predictor, split:
# booting the interpreter and importing the port (the first ABI call, here
# MXTPUNDArrayWaitAll), loading the artifact, the first and second forward
# (predict.cc itself prints only the values)
_PREDICT_TIMING_CC = r"""
#include <dlfcn.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iterator>
#include <vector>

#include "mxnet_tpu_cpp/predictor.hpp"

int main(int argc, char** argv) {
  using clk = std::chrono::steady_clock;
  auto s = [](clk::time_point a, clk::time_point b) {
    return std::chrono::duration<double>(b - a).count();
  };
  std::ifstream in(argv[2], std::ios::binary);
  std::vector<char> buf((std::istreambuf_iterator<char>(in)),
                        std::istreambuf_iterator<char>());
  auto t0 = clk::now();
  void* so = dlopen(std::getenv("MXTPU_PREDICT_LIB"), RTLD_NOW | RTLD_GLOBAL);
  auto wait_all = reinterpret_cast<int (*)()>(
      so ? dlsym(so, "MXTPUNDArrayWaitAll") : nullptr);
  if (!wait_all || wait_all() != 0) return 3;
  auto t1 = clk::now();
  mxnet_tpu_cpp::Predictor pred(argv[1]);
  auto t2 = clk::now();
  pred.SetInputBytes(0, buf.data(), (int64_t)buf.size());
  pred.Forward();
  std::vector<float> a = pred.GetOutput(0);
  auto t3 = clk::now();
  pred.SetInputBytes(0, buf.data(), (int64_t)buf.size());
  pred.Forward();
  std::vector<float> b = pred.GetOutput(0);
  auto t4 = clk::now();
  std::printf("{\"boot_import_s\": %.6f, \"load_s\": %.6f, "
              "\"first_forward_s\": %.6f, \"second_forward_s\": %.6f, "
              "\"values\": %zu, \"repeat_equal\": %s}\n", s(t0, t1),
              s(t1, t2), s(t2, t3), s(t3, t4), a.size(),
              a == b ? "true" : "false");
  return 0;
}
"""
CPP_CLIENTS = ("predict", "train_mlp", "kvstore_io")


def _capi(so_path):
    """libmxtpu_predict loaded into this process over ctypes (it finds the
    running interpreter) and an ``ok(rc, what)`` that fails with its last
    error."""
    import ctypes as c
    so = c.CDLL(so_path)
    so.MXTPUPredGetLastError.restype = c.c_char_p
    so.MXTPUPredGetLastError.argtypes = []
    for fn, args in (
            ("MXTPUPredCreate", [c.c_char_p, c.POINTER(c.c_void_p)]),
            ("MXTPUPredGetInputDType", [c.c_void_p, c.c_int, c.c_char_p,
                                        c.c_int]),
            ("MXTPUPredGetOutputDType", [c.c_void_p, c.c_int, c.c_char_p,
                                         c.c_int]),
            ("MXTPUPredSetInput", [c.c_void_p, c.c_int, c.c_char_p,
                                   c.c_int64]),
            ("MXTPUPredForward", [c.c_void_p]),
            ("MXTPUPredGetOutput", [c.c_void_p, c.c_int, c.c_char_p,
                                    c.c_int64]),
            ("MXTPUPredFree", [c.c_void_p])):
        getattr(so, fn).argtypes = args
        getattr(so, fn).restype = c.c_int

    def ok(rc, what):
        check(rc == 0, "%s: %s" % (what, so.MXTPUPredGetLastError()
                                   .decode(errors="replace")))
    return so, ok


def _hold_k1(tag, B, H, S, D, dtype):
    """K1 against its plain version (``hold_fwd``) on seeded inputs of one
    shape, non-causal, as check_flash_fwd holds it."""
    import torch
    from incubator_mxnet_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda:0").manual_seed(25)
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda:0",
                           dtype=dtype) for _ in range(3))
    scale = 1.0 / D ** 0.5
    out, lse = A._flash_fwd_cuda(q, k, v, False, scale)
    torch.cuda.synchronize()
    return hold_fwd(tag, q, k, v, out, lse, False, scale)


def native_predict_export(tmp):
    """Phase 25(a)'s artifact: full-width BERT (bf16, flash) exported at B 8
    x S 512 by contrib.serving.export_model into tmp/bert.mxtpu. Returns
    {model (its ServedModel), rows, path, export_s}."""
    import numpy as onp
    import torch
    from incubator_mxnet_tpu_torch.contrib import serving

    bert = _serving_bert(25)
    rows = onp.random.RandomState(25).randint(
        0, BERT["vocab_size"], (BERT_BUCKET, BERT_S)).astype("int32")
    path = os.path.join(tmp, "bert.mxtpu")
    t0 = time.perf_counter()
    model = serving.export_model(bert, [torch.from_numpy(rows).cuda()], path)
    return dict(model=model, rows=rows, path=path,
                export_s=time.perf_counter() - t0)


def native_predict_load(so_path, exported):
    """Phase 25(a), set up: the artifact of ``native_predict_export`` loaded
    through the port's libmxtpu_predict in this process over ctypes
    (MXTPUPredCreate); the ABI's dtype names."""
    import ctypes
    model, rows, path = (exported[k] for k in ("model", "rows", "path"))
    so, ok = _capi(so_path)
    h = ctypes.c_void_p()
    t0 = time.perf_counter()
    ok(so.MXTPUPredCreate(path.encode(), ctypes.byref(h)), "MXTPUPredCreate")
    create_s = time.perf_counter() - t0
    names = []
    for fn in (so.MXTPUPredGetInputDType, so.MXTPUPredGetOutputDType):
        buf = ctypes.create_string_buffer(32)
        ok(fn(h, 0, buf, 32), "MXTPUPredGet*DType")
        names.append(buf.value.decode())
    check(names == ["int32", "bfloat16"], "the artifact's dtypes through "
          "the ABI: %s" % names)
    return dict(so=so, ok=ok, handle=h, model=model, rows=rows,
                row=dict(shape="B %d x S %d" % (BERT_BUCKET, BERT_S),
                         dtypes=names, export_s=exported["export_s"],
                         create_s=create_s))


def native_predict_run(loaded):
    """Phase 25(a): NATIVE_FORWARDS MXTPUPredForward calls on the loaded
    program, each output (raw bf16 words) bit for bit ServedModel.predict's
    (its first call captures), K1 exactly 12 a forward, the ABI's forward
    ms against predict's, MXTPUPredGetOutput's ms; K1 held against its
    plain version at that shape. Returns (K1 launches, row)."""
    import ctypes
    import torch
    from incubator_mxnet_tpu_torch.ops import _kernels

    so, ok, h, model = (loaded[k] for k in ("so", "ok", "handle", "model"))
    rows, row = loaded["rows"], loaded["row"]
    x = torch.from_numpy(rows).cuda()
    want = model.predict(x)._data
    torch.cuda.synchronize()
    want_bits = want.contiguous().view(torch.int16).cpu().numpy().tobytes()
    raw = rows.tobytes()
    out = ctypes.create_string_buffer(len(want_bits))
    abi_ms, get_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for i in range(NATIVE_FORWARDS):
        t0 = time.perf_counter()
        ok(so.MXTPUPredSetInput(h, 0, raw, ctypes.c_int64(len(raw))),
           "MXTPUPredSetInput")
        ok(so.MXTPUPredForward(h), "MXTPUPredForward")
        torch.cuda.synchronize()
        abi_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ok(so.MXTPUPredGetOutput(h, 0, out, ctypes.c_int64(len(want_bits))),
           "MXTPUPredGetOutput")
        get_ms.append((time.perf_counter() - t0) * 1e3)
        check(out.raw == want_bits, "the ABI's forward %d differs from "
              "ServedModel.predict's output" % i)
    torch.cuda.synchronize()
    k1 = _kernels.LAUNCHES.get("flash_fwd", 0)
    check(k1 == BERT["num_layers"] * NATIVE_FORWARDS,
          "K1 launched %d times over %d MXTPUPredForward calls, not %d a "
          "forward" % (k1, NATIVE_FORWARDS, BERT["num_layers"]))
    predict_ms = []
    for _ in range(NATIVE_FORWARDS):
        t0 = time.perf_counter()
        model.predict(x)
        torch.cuda.synchronize()
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    ok(so.MXTPUPredFree(h), "MXTPUPredFree")
    err = _hold_k1("bf16 B8 H8 S512 D128 (C predict)", BERT_BUCKET,
                   BERT["num_heads"], BERT_S, BERT["units"]
                   // BERT["num_heads"], torch.bfloat16)
    row.update(forwards=NATIVE_FORWARDS, k1_launches=k1,
               abi_forward_ms=abi_ms, predict_ms=predict_ms,
               abi_get_output_ms=get_ms, output_mb=len(want_bits) / 1e6,
               bit_for_bit=True, k1_max_abs_err=err)
    log("C predict: BERT B %d x S %d bf16, MXTPUPredForward %s ms against "
        "predict %s ms, GetOutput %s ms (%.0f MB), K1 %d, create %.1f s, "
        "export %.1f s" % (BERT_BUCKET, BERT_S,
                           ["%.2f" % v for v in abi_ms],
                           ["%.2f" % v for v in predict_ms],
                           ["%.1f" % v for v in get_ms], row["output_mb"],
                           k1, row["create_s"], row["export_s"]))
    return {"flash_fwd": k1}, row


def _export_fp32_bert(tmp):
    """Full-width BERT in float32 exported at B 1 x S NATIVE_CPP_S, its ids
    file and its in-process forward (TF32 off)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.contrib import serving
    net = models.BERTModel(**BERT)
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=torch
                   .Generator(device="cuda:0").manual_seed(26))
    ids = onp.random.RandomState(26).randint(
        0, BERT["vocab_size"], (1, NATIVE_CPP_S)).astype("int32")
    x = torch.from_numpy(ids).cuda()
    path = os.path.join(tmp, "bert_fp32.mxtpu")
    with _TF32(False):
        model = serving.export_model(net, [x], path)
        want = model.predict(x).asnumpy()
    model.release()
    check(want.dtype == onp.float32 and want.shape == (
        1, NATIVE_CPP_S, BERT["vocab_size"]), "the float32 BERT's output: "
        "%s %s" % (want.dtype, want.shape))
    inp = os.path.join(tmp, "ids.bin")
    with open(inp, "wb") as f:
        f.write(ids.tobytes())
    return path, inp, want


def _start_cpp_builds(root, tmp):
    """One g++ per C++ client at once: cpp_package's predict.cc,
    train_mlp.cc and kvstore_io.cc as they are, and the timing client.
    Returns {name: (executable, process)}."""
    include = os.path.join(root, "cpp_package", "include")
    timing_src = os.path.join(tmp, "predict_timing.cc")
    with open(timing_src, "w") as f:
        f.write(_PREDICT_TIMING_CC)
    builds = {}
    for name in CPP_CLIENTS + ("predict_timing",):
        src = timing_src if name == "predict_timing" else os.path.join(
            root, "cpp_package", "example", name + ".cc")
        exe = os.path.join(tmp, name)
        builds[name] = (exe, subprocess.Popen(
            ["g++", "-O2", "-std=c++17", src, "-I", include, "-ldl", "-o",
             exe], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return builds


def _start_child(name, argv, env, tmp):
    """A C++ client in the background, its output into files in tmp."""
    out = open(os.path.join(tmp, name + ".out"), "w")
    err = open(os.path.join(tmp, name + ".err"), "w")
    try:
        return subprocess.Popen(argv, stdout=out, stderr=err, env=env), \
            out, err
    except BaseException:
        out.close()
        err.close()
        raise


def _stop_children(children):
    """Kill what still runs, wait for every child, close its files."""
    for proc, out, err in children.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        out.close()
        err.close()


def _join_children(children, tmp, t0=None,
                   timeout_s=NATIVE_CHILD_TIMEOUT_S):
    """Wait for every child (``timeout_s`` in all from ``t0``) and return
    {name: stdout text}; a child that failed or outlived the bound fails
    the phase. Every child is stopped either way."""
    t0 = time.perf_counter() if t0 is None else t0
    try:
        for name, (proc, _, _) in children.items():
            try:
                proc.wait(timeout=max(1.0, timeout_s - (
                    time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise SmokeFailure("%s ran past %d s" % (name, timeout_s))
    finally:
        _stop_children(children)
    text = {}
    for name, (proc, _, _) in children.items():
        with open(os.path.join(tmp, name + ".err")) as f:
            err = f.read()
        check(proc.returncode == 0, "%s failed (exit %d):\n%s"
              % (name, proc.returncode, err[-4000:]))
        with open(os.path.join(tmp, name + ".out")) as f:
            text[name] = f.read()
    return text


def native_cpp_check(text, want):
    """Phase 25(b) and (c), checked: predict.cc's printed values against
    the in-process forward (within NATIVE_CPP_TOL of the largest logit),
    train_mlp's and kvstore_io's OK lines."""
    import numpy as onp
    got = onp.array(text["predict"].split(), dtype=onp.float32)
    check(got.size == want.size, "predict.cc printed %d values, not %d"
          % (got.size, want.size))
    got = got.reshape(want.shape)
    scale = float(onp.abs(want).max())
    max_err = float(onp.abs(got - want).max())
    check(bool(onp.isfinite(got).all()) and max_err <= NATIVE_CPP_TOL * scale,
          "predict.cc's values leave the in-process forward by %.3g (%.3g "
          "of the largest logit)" % (max_err, max_err / scale))
    check("CPP GRAPH TRAIN OK" in text["train_mlp"],
          "train_mlp: %s" % text["train_mlp"][-2000:])
    check("CPP EXT TIER OK" in text["kvstore_io"],
          "kvstore_io: %s" % text["kvstore_io"][-2000:])
    final = [l for l in text["train_mlp"].splitlines()
             if l.startswith("FINAL")]
    log("C++ clients: predict.cc %d values within %.3g of the largest logit"
        " (%.3g); %s; kvstore_io OK" % (got.size, max_err / scale, max_err,
                                        final[0] if final else ""))
    return dict(predict_max_abs_err=max_err,
                predict_rel_err=max_err / scale,
                train_mlp=final[0] if final else None,
                kvstore_io="CPP EXT TIER OK")


def _write_jpeg_rec(path, n, side, seed):
    """``n`` seeded side x side JPEGs (quality 90, label i % 1000) into a
    .rec and its .idx."""
    import numpy as onp
    import incubator_mxnet_tpu_torch as mxt
    rng = onp.random.RandomState(seed)
    w = mxt.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rng.randint(0, 256, (side, side, 3)).astype("uint8")
        w.write_idx(i, mxt.recordio.pack_img(
            mxt.recordio.IRHeader(0, float(i % 1000), i, 0), img,
            quality=90))
    w.close()


def native_io(tmp):
    """Phase 25(d): NATIVE_REC_IMAGES seeded 256² JPEGs, ImageRecordIter at
    B 256, 224² random crops, mirror, mean/std, 8 threads through tier 1
    (the C++ pipeline), tier 2 (the C++ reader, PIL decode) and tier 3
    (Python): construction s and img/s of a pass after a reset (each
    batch checked: shape, finite, pad); then phase 17's ResNet-50 v1 symbol
    through Module.fit (fp32, TF32 on) for NATIVE_FIT_EPOCHS epochs fed by
    tier 1: every loss finite."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.io import io as io_mod

    rec = os.path.join(tmp, "images.rec")
    t0 = time.perf_counter()
    _write_jpeg_rec(rec, NATIVE_REC_IMAGES, 256, 25)
    write_s = time.perf_counter() - t0
    kw = dict(path_imgrec=rec, data_shape=(3, 224, 224),
              batch_size=NATIVE_REC_BATCH, rand_crop=True, rand_mirror=True,
              mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
              std_g=57.12, std_b=57.375, preprocess_threads=8)
    tiers = {}
    jpeg_probe = io_mod._payload_is_jpeg
    for tier in (1, 2, 3):
        try:
            if tier == 2:       # JPEG payloads take tier 1 unless told not
                io_mod._payload_is_jpeg = lambda path: False
            t0 = time.perf_counter()
            it = mxt.io.ImageRecordIter(force_python=tier == 3, **kw)
            construct_s = time.perf_counter() - t0
        finally:
            io_mod._payload_is_jpeg = jpeg_probe
        check(it.tier == tier, "ImageRecordIter took tier %d, not %d"
              % (it.tier, tier))
        passes = []
        for _ in range(2):
            it.reset()
            t0 = time.perf_counter()
            n = 0
            for b in it:
                d = b.data[0]
                check(d.shape == (NATIVE_REC_BATCH, 3, 224, 224)
                      and d.context == mxt.cpu()
                      and bool(torch.isfinite(d._data).all()),
                      "tier %d: a batch %s on %s" % (tier, d.shape,
                                                     d.context))
                n += NATIVE_REC_BATCH - b.pad
            passes.append(time.perf_counter() - t0)
            check(n == NATIVE_REC_IMAGES, "tier %d: %d images" % (tier, n))
        tiers["tier%d" % tier] = dict(construct_s=construct_s,
                                      pass_s=passes,
                                      images_per_s=n / passes[-1])
        del it
    log("ImageRecordIter B %d 224² 8 threads, img/s: tier 1 %.0f, tier 2 "
        "%.0f, tier 3 %.0f" % (NATIVE_REC_BATCH,
                               tiers["tier1"]["images_per_s"],
                               tiers["tier2"]["images_per_s"],
                               tiers["tier3"]["images_per_s"]))
    sym = resnet_v1_symbol(mxt.sym, (3, 4, 6, 3), (64, 256, 512, 1024, 2048),
                           1000, 224)
    it = mxt.io.ImageRecordIter(**kw)
    check(it.tier == 1, "Module.fit's iterator took tier %d" % it.tier)
    mod = mxt.mod.Module(sym)               # gpu(0)
    losses = []

    def on_batch(param):
        lo = param.nbatch * NATIVE_REC_BATCH
        losses.append(_module_loss(mod, onp.arange(
            lo, lo + NATIVE_REC_BATCH) % 1000))
    mxt.random.seed(25)
    t0 = time.perf_counter()
    with _TF32(True):
        mod.fit(it, num_epoch=NATIVE_FIT_EPOCHS, optimizer="sgd",
                optimizer_params=_sgd_params(), initializer=_xavier(),
                batch_end_callback=on_batch)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = NATIVE_FIT_EPOCHS * NATIVE_REC_IMAGES // NATIVE_REC_BATCH
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          "Module.fit fed by tier 1: losses %s" % losses)
    log("Module.fit ResNet-50 v1 fed by tier 1: %d steps in %.1f s, losses "
        "%s" % (steps, fit_s, ["%.3f" % v for v in losses]))
    del mod, it
    torch.cuda.empty_cache()
    return dict(images=NATIVE_REC_IMAGES, batch=NATIVE_REC_BATCH,
                write_s=write_s, decode_threads=8, **tiers,
                fit=dict(steps=steps, seconds=fit_s, losses=losses))


def _resnet_params(ex, seed):
    """Seeded values for every argument and auxiliary state of a ResNet
    executor: He-normal convolution and FC weights, BatchNorm's gamma 1,
    beta 0, moving mean 0 and variance 1, biases 0."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    args, aux = {}, {}
    for name, arr in sorted(ex.arg_dict.items()):
        if name in ("data", "softmax_label"):
            continue
        shape = arr.shape
        if name.endswith("_weight"):
            fan_in = int(onp.prod(shape[1:]))
            v = rng.standard_normal(shape, dtype=onp.float32) \
                * onp.float32((2.0 / fan_in) ** 0.5)
        elif name.endswith("_gamma"):
            v = onp.ones(shape, onp.float32)
        else:
            v = onp.zeros(shape, onp.float32)
        args[name] = v
    for name, arr in ex.aux_dict.items():
        aux[name] = onp.ones(arr.shape, onp.float32) \
            if name.endswith("_var") else onp.zeros(arr.shape, onp.float32)
    return args, aux


def native_extensions(tmp):
    """Phase 25(e): phase 17's ResNet-50 v1 symbol at B NATIVE_PART_B
    partitioned by a backend that claims conv, BN and activation chains (at
    least one subgraph node), bound on gpu(0) beside the unpartitioned
    symbol with the same values: the training forward's outputs, every
    gradient and the moving statistics bit for bit (cudnn.deterministic,
    TF32 off); a library.load-ed .py plugin op with a gradient on the
    card; runtime.Features with CUDA, CUDNN and NCCL enabled (printed)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt

    class ConvChain(mxt.subgraph.SubgraphProperty):
        name = "conv_bn_relu"

        def match(self, node):
            return node._op_name in ("Convolution", "BatchNorm",
                                     "Activation")
    mxt.subgraph.register_backend("conv_bn_relu", ConvChain)
    sym = resnet_v1_symbol(mxt.sym, (3, 4, 6, 3), (64, 256, 512, 1024, 2048),
                           1000, 224)
    t0 = time.perf_counter()
    part = sym.optimize_for("conv_bn_relu")
    partition_s = time.perf_counter() - t0
    subgraphs = [s for s in part.get_internals()
                 if s._op_name == "_subgraph_conv_bn_relu"]
    members = sum(len(s._subgraph[1]) for s in subgraphs)
    check(len(subgraphs) >= 1, "the partition formed no subgraph node")
    x, y = _module_data(NATIVE_PART_B, 224, 1000, 27)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    results = []
    try:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        with _TF32(False):
            for s in (sym, part):
                ex = s.simple_bind(mxt.gpu(0), data=x.shape,
                                   softmax_label=y.shape)
                if not results:
                    args, aux = _resnet_params(ex, 27)
                ex.copy_params_from(args, aux)
                out = ex.forward(is_train=True, data=mxt.nd.array(x),
                                 softmax_label=mxt.nd.array(y))[0]
                ex.backward()
                torch.cuda.synchronize()
                results.append((out._data.clone(),
                                {k: g._data.clone()
                                 for k, g in ex.grad_dict.items()},
                                {k: a._data.clone()
                                 for k, a in ex.aux_dict.items()}))
                del ex, out
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    (o1, g1, a1), (o2, g2, a2) = results
    check(bool(torch.isfinite(o1).all()) and torch.equal(o1, o2),
          "the partitioned ResNet-50's outputs differ from the symbol's")
    check(set(g1) == set(g2), "gradient sets differ")
    bad = sorted(k for k in g1 if not torch.equal(g1[k], g2[k]))
    check(not bad, "gradients of the partitioned ResNet-50 differ: %s" % bad)
    check(all(torch.equal(a1[k], a2[k]) for k in a1),
          "the partitioned ResNet-50's moving statistics differ")
    del results, o1, o2, g1, g2, a1, a2
    plugin = os.path.join(tmp, "native_cube.py")
    with open(plugin, "w") as f:
        f.write("from incubator_mxnet_tpu_torch import library\n"
                "library.register_op(\n"
                "    'native_cube', lambda x: x * x * x,\n"
                "    gradient=lambda ins, g: [g * 3 * ins[0] * ins[0]])\n")
    mxt.library.load(plugin)
    try:
        a = mxt.nd.array([1.0, -2.0, 3.0], ctx=mxt.gpu(0))
        a.attach_grad()
        with mxt.autograd.record():
            c = mxt.nd.native_cube(a)
        c.backward()
        check(c.context == mxt.gpu(0)
              and c.asnumpy().tolist() == [1.0, -8.0, 27.0]
              and a.grad.asnumpy().tolist() == [3.0, 12.0, 27.0],
              "the plugin op on the card: %s, grad %s"
              % (c.asnumpy(), a.grad.asnumpy()))
    finally:
        mxt.library.unregister_op("native_cube")
    feats = mxt.runtime.Features()
    for key in ("CUDA", "CUDNN", "NCCL", "NATIVE_RECORDIO"):
        check(feats.is_enabled(key), "runtime.Features: %s disabled" % key)
    log("runtime.Features(): %s" % sorted(feats.values(),
                                          key=lambda f: f.name))
    log("subgraph: ResNet-50 v1 B %d, %d subgraph node(s) of %d operators, "
        "outputs, gradients and moving statistics bit for bit"
        % (NATIVE_PART_B, len(subgraphs), members))
    return dict(subgraph_nodes=len(subgraphs), subgraph_members=members,
                partition_s=partition_s, batch=NATIVE_PART_B,
                bit_for_bit=True, plugin_op="native_cube",
                features={f.name: f.enabled for f in feats.values()})


def _aoti_runner(argv, out_dir):
    """The runner in a fresh process with ``--hold``: its key/value lines
    up to "done", then its /proc/<pid>/maps while it still runs, then its
    exit. stderr goes to a file. Killed after NATIVE_CHILD_TIMEOUT_S.
    Returns (lines, maps text, exit code, stderr text)."""
    err_path = os.path.join(out_dir, "aoti_serve.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
    timer = threading.Timer(NATIVE_CHILD_TIMEOUT_S, proc.kill)
    timer.start()
    lines, maps = {}, ""
    try:
        for line in proc.stdout:
            if line.strip() == "done":
                with open("/proc/%d/maps" % proc.pid) as f:
                    maps = f.read()
                break
            key, _, val = line.strip().partition(" ")
            lines[key] = val
        proc.stdin.close()
        proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(err_path) as f:
        return lines, maps, proc.returncode, f.read()


def aoti_bundle_child(opts):
    """``--aoti-bundle ARTIFACT OUT_DIR``: contrib.serving.export_pjrt_bundle
    of ARTIFACT into OUT_DIR in this (child) process; prints one JSON line
    {package, manifest, export_s}."""
    from incubator_mxnet_tpu_torch.contrib import serving
    artifact, out_dir = opts.aoti_bundle
    t0 = time.perf_counter()
    package, manifest = serving.export_pjrt_bundle(artifact, out_dir)
    print(json.dumps(dict(package=package, manifest=manifest,
                          export_s=time.perf_counter() - t0)), flush=True)
    return 0


def native_aoti(loaded, tmp, made, waited_s):
    """Phase 25(f): (a)'s artifact (full-width BERT, bf16, B 8 x S 512)
    served with no Python in the process. export_pjrt_bundle compiled it
    into an AOTInductor package on cuda:0 in a child process started when
    the artifact was written (``made``: its JSON line, the compile's
    seconds measured there; ``waited_s``: how long the phase then waited
    for it); the runner
    (native/src/aoti_serve.cc, built with g++ against libtorch) loads the
    package and the C++ operator library that launches K1 in a fresh
    process: its /proc/<pid>/maps holds libtorch_cuda and no libpython;
    its output words are bit for bit those of aoti_load_package of the
    same package in this process, and within AOTI_BF16_TOL of the largest
    |logit| of ServedModel.predict's; K1 exactly 12 a forward by the
    operator library's counter. Returns (K1 launches of the runner,
    row)."""
    import torch
    import torch._inductor
    from incubator_mxnet_tpu_torch.native import lib
    rows, model = loaded["rows"], loaded["model"]
    package, manifest_path = made["package"], made["manifest"]
    bundle_s = made["export_s"]
    with open(manifest_path) as f:
        manifest = json.load(f)
    want_manifest = dict(
        device="cuda:0",
        inputs=[dict(shape=[BERT_BUCKET, BERT_S], dtype="int32")],
        outputs=[dict(shape=[BERT_BUCKET, BERT_S, BERT["vocab_size"]],
                      dtype="bfloat16")])
    check(all(manifest[k] == v for k, v in want_manifest.items()),
          "the bundle's manifest: %s" % manifest)
    runner = lib.build_aoti_serve()
    inp, out = os.path.join(tmp, "aoti_in.bin"), os.path.join(
        tmp, "aoti_out.bin")
    with open(inp, "wb") as f:
        f.write(rows.tobytes())
    t0 = time.perf_counter()
    lines, maps, rc, err = _aoti_runner(
        [runner, "--hold", manifest["op_library"], package, inp, out,
         "%d,%d" % (BERT_BUCKET, BERT_S)], tmp)
    process_s = time.perf_counter() - t0
    check(rc == 0 and maps, "aoti_serve failed (exit %s): %s" % (
        rc, err[-4000:]))
    mapped = sorted({line.split()[-1] for line in maps.splitlines()
                     if len(line.split()) > 5})
    check(not any("libpython" in m for m in mapped)
          and any("libtorch_cuda" in m for m in mapped),
          "the runner's mapped libraries: %s" % mapped)
    k1 = int(lines["k1_launches"])
    check(k1 == 2 * BERT["num_layers"] and lines["k1_plain_calls"] == "0"
          and lines["repeat_equal"] == "true" and lines["device"]
          == "cuda:0", "aoti_serve's report: %s" % lines)
    with open(out, "rb") as f:
        got = f.read()
    x = torch.from_numpy(rows).cuda()
    t0 = time.perf_counter()
    package_model = torch._inductor.aoti_load_package(package)
    load_in_process_s = time.perf_counter() - t0
    in_process = package_model(x)
    torch.cuda.synchronize()
    want = in_process.contiguous().view(torch.int16).cpu().numpy()
    check(got == want.tobytes(), "the runner's output differs from "
          "aoti_load_package's in this process")
    pred = model.predict(x)._data
    rel = float((in_process.float() - pred.float()).abs().max()
                / pred.float().abs().max())
    check(math.isfinite(rel) and rel <= AOTI_BF16_TOL, "the bundle against "
          "ServedModel.predict: %.3g of the largest |logit| (bound %.3g)"
          % (rel, AOTI_BF16_TOL))
    predict_ms, package_ms = [], []
    for fn, into in ((lambda: model.predict(x), predict_ms),
                     (lambda: package_model(x), package_ms)):
        for _ in range(AOTI_PREDICT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
    del package_model, in_process
    pkg_mb = os.path.getsize(package) / 1e6
    row = dict(shape="B %d x S %d bf16" % (BERT_BUCKET, BERT_S),
               export_and_compile_s=bundle_s, waited_for_it_s=waited_s,
               package_mb=pkg_mb,
               runner_process_s=process_s,
               runner_load_s=float(lines["load_s"]),
               runner_forward_ms=[float(lines["forward1_ms"]),
                                  float(lines["forward2_ms"])],
               predict_ms=predict_ms, in_process_package_ms=package_ms,
               in_process_load_s=load_in_process_s, k1_launches=k1,
               k1_per_forward=k1 // 2, bit_for_bit_in_process=True,
               rel_to_predict=rel, tolerance=AOTI_BF16_TOL,
               libpython_mapped=False)
    log("aoti_serve (no Python in the process): BERT B %d x S %d bf16, "
        "export_pjrt_bundle %.1f s in a child beside (b)-(e) (%.0f MB "
        "package), runner load %.2f s, "
        "forwards %s ms against predict %s ms and the package in this "
        "process %s ms, K1 %d a forward, bit for bit aoti_load_package, "
        "%.3g of the largest |logit| from predict" % (
            BERT_BUCKET, BERT_S, bundle_s, pkg_mb, row["runner_load_s"],
            ["%.2f" % v for v in row["runner_forward_ms"]],
            ["%.2f" % v for v in predict_ms],
            ["%.2f" % v for v in package_ms], k1 // 2, rel))
    return {"flash_fwd": k1}, row


def native_phase(card, root=None):
    """Phase 25: ROADMAP item 8 on the card (``--native-only``): the port's
    C ABI and native IO. The four C++ clients start together and run
    beside (a)'s load and (e), and (f)'s bundle compiles in a child process
    from (a)'s export on; (a)'s timed forwards, (f)'s runner and (d) run
    with no child left. Returns ({"c_predict": K1 launches of (a),
    "aoti_serve": of (f)'s runner}, summary)."""
    import json as _json
    import shutil
    import threading
    import torch
    from incubator_mxnet_tpu_torch.native import lib
    root = root or os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    summary = dict(card=card)
    tmp = _build_tmp()
    builds = _start_cpp_builds(root, tmp)
    children, bundle = {}, {}
    try:
        # (a)'s artifact first: (f)'s bundle compiles in a child beside the
        # rest of the phase (Inductor takes minutes at full width)
        exported = native_predict_export(tmp)
        bundle_t0 = time.perf_counter()
        bundle["aoti_bundle"] = _start_child("aoti_bundle", [
            sys.executable, os.path.abspath(__file__), "--root", root,
            "--aoti-bundle", exported["path"], os.path.join(tmp, "aoti")],
            dict(os.environ), tmp)
        t0 = time.perf_counter()
        failed = []

        def build(fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — raised below
                failed.append(e)
        threads = [threading.Thread(target=build, args=(fn,))
                   for fn in (lib.build, lib.build_predict,
                              lib.build_aoti_serve)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failed:
            raise failed[0]
        so_path = lib.build_predict()
        summary["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        path, inp, want = _export_fp32_bert(tmp)
        export32_s = time.perf_counter() - t0
        for name, (_, proc) in builds.items():
            out, _ = proc.communicate(timeout=NATIVE_CHILD_TIMEOUT_S)
            check(proc.returncode == 0, "g++ %s failed:\n%s" % (name, out))
        k1_err = _hold_k1("fp32 B1 H8 S%d D128 (predict.cc)" % NATIVE_CPP_S,
                          1, BERT["num_heads"], NATIVE_CPP_S,
                          BERT["units"] // BERT["num_heads"], torch.float32)
        env = dict(os.environ, MXTPU_PREDICT_LIB=so_path)
        env.pop("MXTPU_CAPI_CONTEXT", None)        # the default, gpu(0)
        exe = {name: b[0] for name, b in builds.items()}
        t0 = time.perf_counter()
        for name, args in (("predict_timing", [path, inp]),
                           ("predict", [path, inp]), ("train_mlp", []),
                           ("kvstore_io", [tmp])):
            children[name] = _start_child(name, [exe[name], *args], env, tmp)
        loaded = native_predict_load(so_path, exported)
        del exported
        summary["extensions"] = native_extensions(tmp)
        text = _join_children(children, tmp, t0)
        children = {}
        timing = _json.loads(text["predict_timing"].strip().splitlines()[-1])
        check(timing["repeat_equal"] and timing["values"] == want.size,
              "the timing client: %s" % timing)
        log("predict_timing (a fresh process, cpp_package's Predictor, "
            "beside the other clients): boot and import %.2f s, load %.2f s,"
            " first forward %.2f s, second %.3f s" % (
                timing["boot_import_s"], timing["load_s"],
                timing["first_forward_s"], timing["second_forward_s"]))
        joined = native_cpp_check(text, want)
        summary["cpp_predict"] = dict(
            shape="B 1 x S %d float32" % NATIVE_CPP_S,
            k1_instantiation="flash_fwd_fma", export_s=export32_s,
            k1_max_abs_err=k1_err,
            max_abs_err=joined.pop("predict_max_abs_err"),
            rel_err=joined.pop("predict_rel_err"), **timing)
        summary["cpp_graph_ext"] = joined
        t0 = time.perf_counter()
        made = _join_children(bundle, tmp, bundle_t0,
                              timeout_s=AOTI_BUNDLE_TIMEOUT_S)["aoti_bundle"]
        bundle = {}
        made = _json.loads(made.strip().splitlines()[-1])
        waited_s = time.perf_counter() - t0
        launches, summary["c_predict"] = native_predict_run(loaded)
        aoti_launches, summary["aoti_serve"] = native_aoti(
            loaded, tmp, made, waited_s)
        loaded["model"].release()
        del loaded
        release_graphs()
        summary["io"] = native_io(tmp)
    finally:
        for _, proc in builds.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        _stop_children(children)
        _stop_children(bundle)
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_phase
    release_graphs()
    torch.cuda.empty_cache()
    return dict(c_predict=launches, aoti_serve=aoti_launches), summary


RTC_SOURCE = r"""
extern "C" __global__ void axpy(const float *x, float *y, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += a * x[i];
}
extern "C" __global__ void block_sum(const float *x, float *out, int n) {
  extern __shared__ float sh[];
  float s = 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    s += x[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) sh[threadIdx.x] += sh[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sh[0];
}
"""
RTC_N, RTC_GRID, RTC_BLOCK = 1 << 22, 128, 512
RTC_TIMED = 50              # launches per event-timed run and per graph
RTC_HOST_LAUNCHES = 1000    # launches per host-clock run
# buffer sets the timed launches rotate through: 6 x 16 MB of x, of y and
# of axpy's output, well beyond the H100's 50 MB L2, so every launch reads
# its inputs from HBM, as the bound counts them
RTC_SETS = 6


def _triton_add():
    import triton
    import triton.language as tl

    @triton.jit
    def add(a, b, n, out, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = i < n
        tl.store(out + i, tl.load(a + i, mask=mask) + tl.load(b + i, mask=mask),
                 mask=mask)
    return add


def check_rtc():
    """K5: NVRTC (CudaModule) and Triton (TritonModule) sample kernels, each
    launched once through its entry point (the counts read around those
    launches), held against torch, then timed: eager ms (``timed_ms``),
    host us a launch (``host_us``) and graph-replay ms (``graph_ms``), each
    launch on the next of ``RTC_SETS`` buffer sets; then each kernel
    launched again on every set (and the Triton add with another
    ``constexpr``) and held against torch once more: those later launches
    take the path the timings took. Returns (launches, rows by kernel,
    NVRTC compile ms)."""
    import torch
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.ops import _kernels
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    n, grid, block = RTC_N, RTC_GRID, RTC_BLOCK
    xs = [torch.randn(n, generator=gen, device=dev) for _ in range(RTC_SETS)]
    y0s = [torch.randn(n, generator=gen, device=dev)
           for _ in range(RTC_SETS)]
    ys = [y.clone() for y in y0s]               # axpy's in-place outputs
    outs = [torch.empty(grid, device=dev) for _ in range(RTC_SETS)]
    mod = rtc.CudaModule(RTC_SOURCE)
    axpy = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
    bsum = mod.get_kernel("block_sum", "const float *x, float *out, int n")
    tri = rtc.TritonModule(_triton_add(), lambda a, b, n: (a.shape, a.dtype)) \
        .get_kernel()
    run = {"axpy": lambda i: axpy.launch([xs[i], ys[i], 2.5, n], dev,
                                         (-(-n // 256),), (256,)),
           "block_sum": lambda i: bsum.launch([xs[i], outs[i], n], "cuda:0",
                                              (grid,), (block,), block * 4),
           "triton_add": lambda i, b=1024: tri.launch(
               [xs[i], y0s[i], n], dev, (-(-n // b),), BLOCK=b)}
    plain = {"axpy": lambda i: y0s[i] + 2.5 * xs[i],
             "block_sum": lambda i: xs[i].view(-1, grid, block)
             .sum(dim=(0, 2)),
             "triton_add": lambda i: xs[i] + y0s[i]}
    library = {"axpy": lambda i: torch.add(y0s[i], xs[i], alpha=2.5),
               "block_sum": lambda i: torch.sum(xs[i].view(-1, grid, block),
                                                dim=(0, 2)),
               "triton_add": lambda i: torch.add(xs[i], y0s[i])}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    run["axpy"](0)
    run["block_sum"](0)
    added = run["triton_add"](0)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(launches.get("rtc", 0) == 2 and launches.get("rtc_triton", 0) == 1
          and sum(launches.values()) == 3,
          "rtc launched %s, expected rtc 2 and rtc_triton 1" % launches)
    got = {"axpy": ys[0], "block_sum": outs[0], "triton_add": added}
    # axpy: one fma against two roundings; block_sum: fp32 sums of n/grid
    # terms in another order; the add is exact
    atol = {"axpy": max(1e-6 * (y.abs().max() + 2.5 * x.abs().max()).item()
                        for x, y in zip(xs, y0s)),
            "block_sum": max(1e-5 * x.abs().sum().item() / grid for x in xs),
            "triton_add": 0.0}
    err = {}
    for name in got:
        err[name] = (got[name] - plain[name](0)).abs().max().item()
        check(err[name] <= atol[name], "rtc %s differs from torch (max abs "
              "%.3g, allowed %.3g)" % (name, err[name], atol[name]))
    # bytes: each input read once, each output written once (fp32)
    nbytes = {"axpy": 3 * 4 * n, "block_sum": 4 * n + 4 * grid,
              "triton_add": 3 * 4 * n}
    rows = {}
    log("rtc: NVRTC compiled the two-kernel module in %.1f ms (%s)"
        % (mod.compile_ms, mod.arch))
    for name in ("axpy", "block_sum", "triton_add"):
        bound_ms = nbytes[name] / PEAK_BYTES * 1e3
        kernel, ref, lib = (rotating(f[name]) for f in (run, plain, library))
        rows[name] = dict(max_abs_err=err[name],
                          ms=timed_ms(kernel, RTC_TIMED),
                          host_us=host_us(kernel, RTC_HOST_LAUNCHES),
                          graph_ms=graph_ms(kernel, RTC_TIMED),
                          plain_ms=timed_ms(ref, RTC_TIMED),
                          library_ms=timed_ms(lib, RTC_TIMED),
                          library_host_us=host_us(lib, RTC_HOST_LAUNCHES),
                          bound_ms=bound_ms, bound_by="bytes",
                          shape="%d fp32, %d buffer sets" % (n, RTC_SETS))
    # later launches, on every set: the path just timed, against torch
    for i in range(RTC_SETS):
        ys[i].copy_(y0s[i])
        run["axpy"](i)
        run["block_sum"](i)
        later = [("axpy", ys[i]), ("block_sum", outs[i]),
                 ("triton_add", run["triton_add"](i))]
        if i == 1:      # another BLOCK: another specialization
            later.append(("triton_add", run["triton_add"](i, 512)))
        for key, out in later:
            e = (out - plain[key](i)).abs().max().item()
            check(e <= atol[key], "rtc %s, a later launch on buffer set %d, "
                  "differs from torch (max abs %.3g, allowed %.3g)"
                  % (key, i, e, atol[key]))
            rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], e)
    for name, r in rows.items():
        log("  %s: max|k-torch| %.3g  eager %.4f ms  host %.1f us/launch  "
            "graph replay %.4f ms  plain %.4f ms  library %.4f ms (host "
            "%.1f us)  bound %.4f ms (bytes)" % (
                name, r["max_abs_err"], r["ms"], r["host_us"], r["graph_ms"],
                r["plain_ms"], r["library_ms"], r["library_host_us"],
                r["bound_ms"]))
    return launches, rows, mod.compile_ms


def rotating(fn):
    """A call of no arguments that calls ``fn(i)`` with the next of the
    ``RTC_SETS`` buffer sets each time."""
    sets = itertools.cycle(range(RTC_SETS))
    return lambda: fn(next(sets))


def rtc_host_breakdown():
    """Where a K5 launch's host time goes (host us a call, 2000 calls, at a
    size so small that the card never holds the host back): the whole
    launch, its checks and argument packing, the CUDA driver's
    ``cuLaunchKernel`` alone, the context check, the launch count, the
    stream's lookup (PyTorch's C entry point, which a launch takes, and
    ``torch.cuda.current_stream``); for Triton the whole launch, the
    output's allocation and Triton's JIT dispatch alone; and torch.add on
    the same tensors, PyTorch's own launch path."""
    import ctypes
    import torch
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.ops import _kernels
    dev = torch.device("cuda", 0)
    n, iters = 32, 2000
    x = torch.randn(n, device=dev)
    y = torch.randn(n, device=dev)
    out = torch.empty(n, device=dev)
    axpy = rtc.CudaModule(RTC_SOURCE).get_kernel(
        "axpy", "const float *x, float *y, float a, int n")
    axpy.launch([x, y, 2.5, n], dev, (1,), (32,))
    layout, lib = axpy._layout, rtc._libcuda()
    handle, current = axpy._functions[0].handle, ctypes.c_void_p()
    stream = _kernels.stream(dev)
    tri = rtc.TritonModule(_triton_add()).get_kernel()
    tri.launch([x, y, n], dev, (1,), BLOCK=1024)

    def checks():
        rtc._cuda_device(dev)
        rtc._dims((1,), "grid_dims")
        rtc._dims((32,), "block_dims")
        layout.fill([x, y, 2.5, n], dev)

    parts = {
        "cuda_launch": lambda: axpy.launch([x, y, 2.5, n], dev, (1,), (32,)),
        "cuda_checks_and_packing": checks,
        "cuda_launch_call": lambda: lib.cuLaunchKernel(
            handle, 1, 1, 1, 32, 1, 1, 0, stream, layout.array, None),
        "cuda_context_check": lambda: lib.cuCtxGetCurrent(current),
        "stream_raw": lambda: _kernels.stream(dev),
        "stream_public": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "launch_count": lambda: _kernels.count("rtc"),
        "triton_launch": lambda: tri.launch([x, y, n], dev, (1,),
                                            BLOCK=1024),
        "triton_output_alloc": lambda: torch.empty(n, device=dev),
        "triton_jit_dispatch": lambda: tri._kernel_fn[(1,)](x, y, n, out,
                                                            BLOCK=1024),
        "torch_add": lambda: torch.add(x, y),
    }
    us = {k: host_us(f, iters) for k, f in parts.items()}
    log("rtc host us a call (%d calls, %d fp32): %s" % (
        iters, n, ", ".join("%s %.2f" % kv for kv in us.items())))
    return us


def host_us(fn, iters):
    """Host time of one launch: ``iters`` back-to-back calls of ``fn`` on
    the host clock with no synchronisation inside, then one."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def graph_ms(fn, iters, replays=5):
    """Device time of one launch with no host in the way: ``iters`` calls
    of ``fn`` captured once in a CUDA graph (torch.cuda.graph's side
    stream), the graph replayed once to warm up, then ``replays`` replays
    timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def step_phases(step, *inputs, n_net_inputs=1):
    """One TrainStep, phase by phase as TrainStep.__call__ runs them, with
    CUDA events between: forward (with the loss), backward, update."""
    import torch
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    args = step._prepare(inputs, n_net_inputs)
    ev[0].record()
    loss = step._forward(args, n_net_inputs)
    ev[1].record()
    grads = step._backward(loss)
    ev[2].record()
    step._update(args[0].shape[step.batch_axis], grads)
    ev[3].record()
    ev[3].synchronize()
    return dict(forward_ms=ev[0].elapsed_time(ev[1]),
                backward_ms=ev[1].elapsed_time(ev[2]),
                update_ms=ev[2].elapsed_time(ev[3]),
                loss=NDArray(loss.detach()))


def stage_breakdown(net, batch, reps=3):
    """Where one dispatched batch's time goes (warm, three repeats): the
    forward on the card (CUDA events), the same forward on the host clock
    (launch overhead included), and BlockServable's output conversion to
    float32 numpy on the host (``to_host_ms``: bf16 into pinned memory,
    widened on the host) against the old one (``to_host_ms_old``: widened
    on the card, then a pageable copy), alternating which goes first; the
    two must agree bit for bit."""
    import torch
    from incubator_mxnet_tpu_torch import jit
    from incubator_mxnet_tpu_torch.serving.registry import _to_host

    def old(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    step = jit.EvalStep(net)
    out = {"forward_device_ms": [], "forward_host_ms": [], "to_host_ms": [],
           "to_host_ms_old": []}
    for r in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = step(batch)._data
        end.record()
        end.synchronize()
        t1 = time.perf_counter()
        out["forward_device_ms"].append(start.elapsed_time(end))
        out["forward_host_ms"].append((t1 - t0) * 1e3)
        got = {}
        for key, fn in ((("to_host_ms", _to_host), ("to_host_ms_old", old))
                        if r % 2 == 0 else
                        (("to_host_ms_old", old), ("to_host_ms", _to_host))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got[key] = fn(logits)
            out[key].append((time.perf_counter() - t) * 1e3)
        check(got["to_host_ms"].dtype == got["to_host_ms_old"].dtype and
              got["to_host_ms"].tobytes() == got["to_host_ms_old"].tobytes(),
              "BlockServable's host copy differs from the old conversion")
        del logits, got
    return out


PHASE_SECONDS = {}      # the whole script's phases, seconds each
_PHASE_MARK = [None]


def phase_done(name):
    """Log and keep the seconds since the previous phase ended (or since
    the first call)."""
    now = time.perf_counter()
    if _PHASE_MARK[0] is not None:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + \
            now - _PHASE_MARK[0]
        log("phase %s: %.1f s" % (name, PHASE_SECONDS[name]))
    _PHASE_MARK[0] = now


_SCRIPT_T0 = time.monotonic()
SCRIPT_DUMP_S = 1100    # the script's own stack dump, before the 1200 s limit


def _arm_script_dump():
    """A run still going SCRIPT_DUMP_S after the script started prints
    where every thread waits (stderr), so a hang names itself."""
    import faulthandler
    faulthandler.dump_traceback_later(
        max(1.0, SCRIPT_DUMP_S - (time.monotonic() - _SCRIPT_T0)),
        exit=False)


def main(argv):
    import argparse
    parser = argparse.ArgumentParser(description="Run the PyTorch/CUDA port "
                                     "end to end on one NVIDIA GPU.")
    parser.add_argument("--rtc-only", action="store_true",
                        help="time K5's launch path (phase 18) alone")
    parser.add_argument("--imperative-only", action="store_true",
                        help="time the imperative BERT loop against "
                        "TrainStep (phase 6c) alone")
    parser.add_argument("--train-only", action="store_true",
                        help="run the full-width training path (phases 1, "
                        "3 and 7) alone")
    parser.add_argument("--gluon-only", action="store_true",
                        help="run the Gluon training loop (phase 12) "
                        "alone")
    parser.add_argument("--rnn-only", action="store_true",
                        help="run the LSTM language model (phase 13) "
                        "alone")
    parser.add_argument("--zoo-only", action="store_true",
                        help="run the model-zoo families (phase 14) alone")
    parser.add_argument("--ssd-only", action="store_true",
                        help="run SSD-512, BASELINE config 4 (phase 15), "
                        "alone")
    parser.add_argument("--ctc-only", action="store_true",
                        help="run the CTC acoustic model at DeepSpeech-2 "
                        "width (phase 16) alone")
    parser.add_argument("--module-only", action="store_true",
                        help="run the symbolic API and Module.fit's "
                        "ResNet-50 v1 (phase 17) alone")
    parser.add_argument("--bucketing-only", action="store_true",
                        help="run the legacy API's bucketing LSTM LM "
                        "through BucketingModule.fit (phase 19) alone")
    parser.add_argument("--serving-http-only", action="store_true",
                        help="run the serving front end and generation "
                        "(phase 20) alone")
    parser.add_argument("--programs-only", action="store_true",
                        help="run programs on disk and device telemetry "
                        "(phase 21) alone")
    parser.add_argument("--parallel-only", action="store_true",
                        help="run SPMD over a mesh (phase 22) alone")
    parser.add_argument("--dist-only", action="store_true",
                        help="run several processes (phase 23) alone")
    parser.add_argument("--contrib-only", action="store_true",
                        help="run mx.np/mx.npx, int8 quantization, ONNX, "
                        "nd.Custom, contrib.text and the torch bridge "
                        "(phase 24) alone")
    parser.add_argument("--native-only", action="store_true",
                        help="run the C ABI and native IO (phase 25) "
                        "alone")
    parser.add_argument("--profile-stress", type=int, metavar="N",
                        help="N GET /debug/profile captures under TinyLM "
                        "generation traffic (phase 21's second profile, "
                        "repeated) alone")
    parser.add_argument("--dist-worker", action="store_true",
                        help=argparse.SUPPRESS)   # one rank of phase 23
    parser.add_argument("--dist-nccl-one", action="store_true",
                        help=argparse.SUPPRESS)   # phase 23(d)
    parser.add_argument("--aoti-bundle", nargs=2, help=argparse.SUPPRESS)
    #                                               phase 25(f)'s compile
    parser.add_argument("--out", help=argparse.SUPPRESS)
    parser.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="the checkout whose port runs")
    opts = parser.parse_args(argv)
    _arm_script_dump()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(opts.root))
    try:
        import incubator_mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port package is not in %s (%s)"
              % (opts.root, e), file=sys.stderr)
        return 2
    for flag, fn in ((opts.dist_worker, dist_worker),
                     (opts.dist_nccl_one, dist_nccl_one),
                     (opts.aoti_bundle, aoti_bundle_child)):
        if flag:
            try:
                return fn(opts)
            except SmokeFailure as e:
                print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
                return 1
    card = _card_line()
    if opts.rtc_only:
        try:
            _, rtc_rows, rtc_compile_ms = check_rtc()
        except SmokeFailure as e:
            print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
            return 1
        log(card)
        log(json.dumps({"rtc": dict(rtc_rows, compile_ms=rtc_compile_ms,
                                    root=os.path.abspath(opts.root))}))
        return 0
    if opts.imperative_only:
        import shutil
        tmp = _build_tmp()
        try:
            _, _, bert = train_bert_imperative(tmp, AB_STEPS)
        except SmokeFailure as e:
            print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(card)
        log(json.dumps({"imperative": dict(bert,
                                           root=os.path.abspath(opts.root))}))
        return 0
    if opts.train_only:
        try:
            build_kernels()
            _, training = train_full_width(check_flash_bwd())
        except SmokeFailure as e:
            print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
            return 1
        log(card)
        log(json.dumps({"training": dict(training, root=os.path.abspath(
            opts.root))}))
        return 0
    if opts.gluon_only:
        try:
            build_kernels()
            _, gluon = gluon_loop(card)
        except SmokeFailure as e:
            print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
            return 1
        log(card)
        log(json.dumps({"gluon_loop": dict(gluon, root=os.path.abspath(
            opts.root))}))
        return 0
    for flag, key, phase in ((opts.rnn_only, "rnn", lstm_lm),
                             (opts.zoo_only, "model_zoo", model_zoo),
                             (opts.ssd_only, "ssd", ssd_phase),
                             (opts.ctc_only, "ctc", ctc_phase),
                             (opts.module_only, "module", module_phase),
                             (opts.bucketing_only, "bucketing",
                              bucketing_phase),
                             (opts.serving_http_only, "serving_http",
                              serving_http_phase),
                             (opts.programs_only, "programs",
                              programs_phase),
                             (opts.parallel_only, "parallel",
                              parallel_phase),
                             (opts.dist_only, "dist", dist_phase),
                             (opts.contrib_only, "contrib",
                              lambda c: contrib_phase(c, opts.root)),
                             (opts.native_only, "native",
                              lambda c: native_phase(c, opts.root)),
                             (opts.profile_stress, "profile_stress",
                              lambda c: (None, profile_stress(
                                  c, opts.profile_stress)))):
        if flag:
            try:
                _, got = phase(card)
            except SmokeFailure as e:
                print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
                return 1
            log(card)
            log(json.dumps({key: dict(got, root=os.path.abspath(
                opts.root))}))
            return 0
    try:
        phase_done("start")
        ptxas = build_kernels()
        phase_done("build_kernels")
        served = check_flash_fwd()
        phase_done("check_flash_fwd")
        bwd = check_flash_bwd()
        phase_done("check_flash_bwd")
        conv_launches, conv_rows = check_conv_bwd()
        phase_done("check_conv_bwd")
        check_small_models_against_cpu()
        phase_done("check_small_models_against_cpu")
        check_small_training_against_cpu()
        phase_done("check_small_training_against_cpu")
        check_small_vision_against_cpu()
        phase_done("check_small_vision_against_cpu")
        captured = check_captured_small()
        phase_done("check_captured_small")
        serve_launches, serving = serve_full_width()
        phase_done("serve_full_width")
        release_graphs()
        ndarray_launches, ndarray_summary = check_ndarray(card)
        phase_done("check_ndarray")
        release_graphs()
        train_launches, training = train_full_width(bwd)
        phase_done("train_full_width")
        release_graphs()
        train_launches["resnet50"], vision = train_resnet_full_width()
        phase_done("train_resnet_full_width")
        release_graphs()
        gluon_launches, gluon = gluon_loop(card)
        phase_done("gluon_loop")
        release_graphs()
        rnn_launches, rnn = lstm_lm(card)
        phase_done("lstm_lm")
        release_graphs()
        zoo_launches, zoo = model_zoo(card)
        phase_done("model_zoo")
        release_graphs()
        ssd_launches, ssd = ssd_phase(card)
        phase_done("ssd_phase")
        release_graphs()
        ctc_launches, ctc = ctc_phase(card)
        phase_done("ctc_phase")
        release_graphs()
        module_launches, module = module_phase(card)
        phase_done("module_phase")
        release_graphs()
        bucketing_launches, bucketing = bucketing_phase(card)
        phase_done("bucketing_phase")
        release_graphs()
        serving_http_launches, serving_http = serving_http_phase(card)
        phase_done("serving_http_phase")
        release_graphs()
        programs_launches, programs = programs_phase(card)
        phase_done("programs_phase")
        release_graphs()
        parallel_launches, parallel = parallel_phase(card)
        phase_done("parallel_phase")
        release_graphs()
        dist_launches, dist = dist_phase(card)
        phase_done("dist_phase")
        release_graphs()
        contrib_launches, contrib = contrib_phase(card, opts.root)
        phase_done("contrib_phase")
        release_graphs()
        native_launches, native = native_phase(card, opts.root)
        phase_done("native_phase")
        rtc_launches, rtc_rows, rtc_compile_ms = check_rtc()
        phase_done("check_rtc")
        rtc_host = rtc_host_breakdown()
        phase_done("rtc_host_breakdown")
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        return 1
    src = "incubator_mxnet_tpu_torch/ops/csrc/"
    # the GPT training shape is the served GPT shape: listed once
    fwd_shapes = served + bwd["fwd"][:1]
    paths = {"serving": serve_launches, "conv3x3_s1": conv_launches,
             "rtc": rtc_launches, "ndarray_bert": ndarray_launches,
             "lstm_lm": rnn_launches, "model_zoo": zoo_launches,
             "ssd": ssd_launches, "ctc": ctc_launches,
             "module": module_launches, "bucketing": bucketing_launches,
             "serving_http": serving_http_launches,
             "programs": programs_launches,
             "int8_bert_serving": contrib_launches,
             **native_launches,
             **parallel_launches,
             **dist_launches,
             **gluon_launches,
             **{"training_" + m: train_launches[m] for m in train_launches}}
    by_path = {k: {p: launches.get(k, 0) for p, launches in paths.items()}
               for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                         "conv_bwd", "rtc", "rtc_triton")}
    kernels = [dict(
        name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
        replaces="incubator_mxnet_tpu/ops/attention.py:103",
        launches=sum(by_path["flash_fwd"].values()),
        launches_by_path=by_path["flash_fwd"],
        max_abs_err=max(s["max_abs_err"] for s in fwd_shapes),
        ms=sum(s["ms"] for s in fwd_shapes),
        plain_ms=sum(s["plain_ms"] for s in fwd_shapes),
        bound_ms=sum(s["bound_ms"] for s in fwd_shapes),
        bound_by=max(fwd_shapes, key=lambda s: s["bound_ms"])["bound_by"],
        library_ms=sum(s["library_ms"] for s in fwd_shapes),
        tflops=sum(s["flops"] for s in fwd_shapes)
        / sum(s["ms"] for s in fwd_shapes) / 1e9,
        share_of_bound=sum(s["bound_ms"] for s in fwd_shapes)
        / sum(s["ms"] for s in fwd_shapes),
        ptxas=[fn for fn in ptxas if fn["kernel"].startswith("flash_fwd")],
        note="ms/plain_ms/bound_ms/library_ms: one launch at each shape of "
             "the serving and training paths, summed; per shape in "
             "'shapes' (served BERT, GPT, then BERT training; GPT training "
             "is the served GPT shape). bf16/fp16 run flash_fwd_tc (tensor "
             "cores), fp32 flash_fwd_fma. tflops is 4·BH·pairs·D over the "
             "kernel's time",
        shapes=fwd_shapes)]
    for name, key, line in (("flash_bwd_dkv", "dkv", 223),
                            ("flash_bwd_dq", "dq", 248)):
        rows = bwd[key]
        kernels.append(dict(
            name=name, route="cuda", source=src + "flash_bwd.cu",
            replaces="incubator_mxnet_tpu/ops/attention.py:%d" % line,
            launches=sum(by_path[name].values()),
            launches_by_path=by_path[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=sum(r["library_ms"] for r in rows),
            tflops=sum(r["flops"] for r in rows) / sum(r["ms"] for r in rows)
            / 1e9,
            share_of_bound=sum(r["bound_ms"] for r in rows)
            / sum(r["ms"] for r in rows),
            ptxas=[fn for fn in ptxas if fn["kernel"].startswith(name)],
            note="one launch at each training shape, summed; per shape in "
                 "'shapes'. tflops is the kernel's own flop count (K2 "
                 "8·BH·pairs·D, K3 6·BH·pairs·D) over its time. plain_ms is "
                 "the whole plain backward (_fa_bwd_reference: dQ, dK and "
                 "dV) and library_ms the backward of "
                 "scaled_dot_product_attention, which also computes all "
                 "three: both are the pair K2 + K3's",
            shapes=rows))
    kernels.append(dict(
        name="conv_bwd", route="cuda", source=src + "conv_bwd.cu",
        replaces="incubator_mxnet_tpu/ops/conv_bwd.py:115",
        launches=sum(by_path["conv_bwd"].values()),
        launches_by_path=by_path["conv_bwd"],
        max_abs_err=max(r["max_abs_err"] for r in conv_rows),
        ms=sum(r["ms"] for r in conv_rows),
        plain_ms=sum(r["plain_ms"] for r in conv_rows),
        bound_ms=sum(r["bound_ms"] for r in conv_rows),
        bound_by=max(conv_rows, key=lambda r: r["bound_ms"])["bound_by"],
        library_ms=sum(r["library_ms"] for r in conv_rows),
        tflops=sum(r["flops"] for r in conv_rows)
        / sum(r["ms"] for r in conv_rows) / 1e9,
        share_of_bound=sum(r["bound_ms"] for r in conv_rows)
        / sum(r["ms"] for r in conv_rows),
        ptxas=[fn for fn in ptxas if fn["kernel"].startswith("conv3x3")],
        note="one launch at each ResNet-50 bottleneck 3x3 shape (batch 256, "
             "bf16: conv3x3_dgrad_tc, conv3x3_wgrad_tc and the reduce "
             "pass; fp32 runs the *_fma kernels), summed; per shape in "
             "'shapes'. tflops is 2 x 2·N·H·W·9·C·K over the kernel's time; "
             "kernels_us splits a launch by CUDA kernel (torch.profiler). "
             "library_ms is cuDNN's "
             "dgrad + wgrad pair (the gradient of F.conv2d on channels-last "
             "bf16). launches: conv3x3_s1's entry point (two backwards); "
             "model-zoo convs stay on cuDNN, so ResNet-50 training launches "
             "none",
        shapes=conv_rows))
    for name, route, samples in (("rtc", "cuda", ("axpy", "block_sum")),
                                 ("rtc_triton", "triton", ("triton_add",))):
        rows = [dict(rtc_rows[k], sample=k) for k in samples]
        kernels.append(dict(
            name=name, route=route,
            source="incubator_mxnet_tpu_torch/rtc.py",
            replaces="incubator_mxnet_tpu/rtc.py:35",
            launches=sum(by_path[name].values()),
            launches_by_path=by_path[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="bytes",
            library_ms=sum(r["library_ms"] for r in rows),
            host_us=sum(r["host_us"] for r in rows),
            graph_ms=sum(r["graph_ms"] for r in rows),
            compile_ms=rtc_compile_ms if route == "cuda" else None,
            host_breakdown_us={
                k: v for k, v in rtc_host.items()
                if not k.startswith(("cuda_", "triton_"))
                or k.startswith(route + "_")},
            note="runtime-compiled user kernels: the samples are chip_smoke."
                 "py's (RTC_SOURCE, _triton_add), one launch each summed; "
                 "per sample in 'shapes'; ms is the eager launch (50 back "
                 "to back), host_us the host's time a launch (1000, no "
                 "sync inside), graph_ms the launch replayed from a CUDA "
                 "graph; compile_ms is NVRTC's for the module",
            shapes=rows))
    log(json.dumps({"ndarray": ndarray_summary}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"captured": captured}))
    log(json.dumps({"training": training}))
    log(json.dumps({"vision": vision}))
    log(json.dumps({"gluon_loop": gluon}))
    log(json.dumps({"rnn": rnn}))
    log(json.dumps({"model_zoo": zoo}))
    log(json.dumps({"ssd": ssd}))
    log(json.dumps({"ctc": ctc}))
    log(json.dumps({"module": module}))
    log(json.dumps({"bucketing": bucketing}))
    log(json.dumps({"serving_http": serving_http}))
    log(json.dumps({"programs": programs}))
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"dist": dist}))
    log(json.dumps({"contrib": contrib}))
    log(json.dumps({"native": native}))
    log(json.dumps({"phase_seconds": PHASE_SECONDS}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

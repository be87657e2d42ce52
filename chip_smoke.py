#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which must pass:

  1. the card (nvidia-smi name and power limit); build the CUDA kernels
     (nvcc, sm_90a: ragged paged attention's simple and sm90 designs,
     flash attention, B1's and B2's sm90 designs, norms, the
     multi-tensor update and its statistics variant, and the build
     variants of B1's, B2's and B3's sm90 sources that the block-config
     cache times) and the block allocator (g++) from the checkout's
     sources, all at once, timed;
  2. the serving kernel (B3) against its plain PyTorch version in f32 on
     the card, at the engine's shapes (gpt3_1p3b's 16 heads, GQA, int8,
     padding, and llama2_7b's 32 heads, in bf16; gpt3_1p3b's fresh and
     prefix-resume waves and an int8 pool under f16 q; phase 20's verify
     wave, 8 rows of 8 tokens, and phase 21's int8 wave, bf16 q over int8
     pools), each design that
     takes a case within its limit (the simple one KERNEL_ATOL, the sm90
     one twice the reference's own bf16 or f16 rounding), dead rows
     exactly 0, two faults
     planted in the plain version's masks rejected; timed by CUDA events
     and by CUDA-graph replay with the plan built outside, beside the
     plan alone, the plain version, the roofline bound of the same work
     and one torch.nn.functional.scaled_dot_product_attention call on
     the rows padded into a batch (a yardstick only; an int8 pool is
     dequantized first, outside the timed call);
  3. the flash-attention kernels (B1 forward, B2 backward) against their
     plain versions in nine cases (gpt2_small's and gpt3_1p3b's training
     shapes, GQA, segment ids, non-causal, cross-length causal both ways,
     head_dim 256, and the fused encoder's non-causal call on k/v views
     of a packed qkv projection), in bf16, in f16 and in f32,
     element by element relative to each row's size, with two faults
     planted in the kernels' outputs that the check must reject; the
     design each B1 and B2 call ran (sm90 for bf16 and f16 at head_dim
     64/128, the simple kernels otherwise, or the phase fails) and its
     launches;
     timed beside their bound, the plain versions and
     torch.nn.functional.scaled_dot_product_attention (a yardstick
     only: the port never calls it); B1 and B2 in bf16 by single-call
     events and by CUDA-graph replay, beside the simple kernels and
     SDPA's forward (and its backward alone, by replay) in the same run,
     and so in f16 at gpt2_small's and gpt3_1p3b's training shapes;
  4. gpt3_1p3b (bf16, all 24 layers, random weights from seed 0) served
     by LLMEngine: 16 requests sharing a 512-token prefix, 64 new tokens
     each; B3's launch counters are read around this run (every launch
     sm90, one plan built per packed wave);
  5. the engine against the port's dense `generate` in f32 (TF32 off)
     on a 2-layer model at gpt3_1p3b's widths (B3's simple design);
  6. gpt2_small (all 12 layers, random weights from seed 0) trained by
     TrainStep in bf16 O1 with AdamW and flash attention, batch 16,
     seq 1024: 2 warm-up steps and 10 timed ones, the first call an
     eager step that is then captured as one CUDA graph, every later
     call a replay; the counters of B1/B2, the update kernel and the
     graphs, by design, are read around this run (a counter counts the
     eager step's launch and the captured one); the step timed by wall
     and by replay of its graph (the device's idle share), the update
     alone by replay beside its bound, B1/B2 by events in the eager
     step, peak memory;
  7. TrainStep with the flash kernels through its graph against the
     plain attention composite through its graph and against the
     kernels in eager steps, in f32 (TF32 off), on 2 layers at
     gpt2_small's widths: per-step losses, and the parameters after 3
     steps (the largest difference and the share of elements that
     differ);
  8. the norm kernels (B4 layer norm, B5 RMS norm) against their plain
     versions at the main paths' shapes and two edge cases, in bf16 and
     f32, with the affine on and off, element by element, with two
     faults planted that the check must reject; timed by CUDA-graph
     replay (device time only) beside their bound, the plain versions
     and one torch.nn.functional.layer_norm / rms_norm call (a
     yardstick only);
  9. llama2_7b (bf16, all 32 layers, random weights from seed 0) served
     by LLMEngine as in phase 4; B3's counters are read around it, as
     in phase 4, and B5 runs through incubate fused_rms_norm on every
     decoder layer's input captured during the first packed wave, held
     to the layer's own RMSNorm within the reference's split of the two
     forms, with B5's counters read around those calls;
 10. phase 5 for LLaMA: 2 layers at llama2_7b's widths with 8 kv heads
     (GQA through B3's simple design, whose launches it reports, and the
     decode path);
 11. 12 FusedTransformerEncoderLayers at bert_base's widths (post-LN,
     eval, bf16, batch 16 x seq 512; each layer drawn from its own
     seeded init_generator): B4's and B1's counters read
     around one forward (24 and 12), B1's operands in that forward
     recorded and its results held to its plain version, the forward
     timed, and a 2-layer f32 copy on the card held to the same stack
     run on the CPU;
 12. the multi-tensor Adam update kernel against its plain version at
     gpt2_small's 148 parameter shapes: AdamW in f32 with two groups'
     decays, bf16 moments, Adam with coupled L2, bf16 parameters with
     f32 masters; element by element in ulps, a planted fault (one
     tensor's lr x 1.01) rejected; timed by events and by CUDA-graph
     replay beside its bound, the plain version and
     torch._fused_adamw_ (a yardstick only);
 13. bench.py::bench_gpt_1p3b's config trained at full width and depth
     (gpt3_1p3b: 24 layers, batch 4 x seq 2048, bf16 O1, AdamW with
     bf16 moments, flash attention, every third block recomputed,
     random weights from seed 0) through TrainStep's graph, 2 + 6
     calls: B1/B2 must take their sm90 design, the counters read around
     the eager first step and the capture must show 32 B1 launches a
     step (24 blocks and the 8 recomputed ones), 24 of B2 and 2 of the
     update (292 tensors, 192 a launch), every loss finite; the step by
     wall and by replay, the idle share, tokens/s, MFU and peak memory;
     then the same config without recompute, for what recompute costs
     and saves;
 14. recompute through TrainStep's graph against eager steps without
     it: gpt3_1p3b's widths at 4 layers, bf16 O1, dropout 0.1, one
     seed, 3 steps, at recompute intervals 1 and 3 under the "full" and
     "dots" policies: losses and parameters within phase 7's rule, the
     largest difference printed;
 15. gpt2_small (12 layers, batch 16 x seq 1024, flash attention, AdamW,
     dropout 0) in f16 O1: 8 eager steps through Optimizer.step with a
     GradScaler (decr_every_n_nan_or_inf=1), step 4's gradient poisoned
     with inf: that update skipped, the weight kept, the scale halved,
     one unscale pass and one host sync (torch's sync debug mode) a
     step; 2 + 6 TrainStep calls through its graph (no scaler, as the
     reference's TrainStep) with B1/B2's f16 launches read around the
     capture, held to as many eager steps by phase 7's rule; one step
     of amp.decorate(level="O2", dtype="float16"): f16 parameters, f32
     masters, one update launch writing their casts; step ms, tokens/s
     and MFU of both forms;
 16. gpt3_1p3b in f16 served as in phase 4 (f16 pools, every B3 launch
     sm90, the decode graphs), each request's tokens held to the port's
     f16 dense `generate` under a margin guard of twice the f16 logits'
     own rounding error (their distance from the same weights in f32);
 17. LLaMA trained at LLaMA-2-13B's widths (hidden 5120, 40 heads of
     128, FFN 13824, vocab 32000) cut to 4 layers, batch 2 x seq 4096,
     bf16 O1, AdamW, flash attention, random weights from seed 0, the
     reference's test loss (logits[:, :-1] against ids[:, 1:]), through
     TrainStep's graph, 2 + 6 calls, without recompute and with every
     layer recomputed: B1/B2 must take their sm90 design, the counters
     read around the eager first step and the capture must show (B1,
     B2, update) at (4, 4, 1) launches a step, (8, 4, 1) with
     recompute, every loss finite; the step by wall and by replay, the
     idle share, tokens/s, MFU and peak memory of both; then the GQA
     sub-run: 2 layers at llama2_7b's widths with 8 kv heads, batch 2 x
     seq 2048, 3 graph steps held to 3 eager steps by phase 7's rule,
     B1/B2's sm90 launches counted and B1's calls recorded;
 18. bench.py::bench_bert_base's config at full width and depth
     (bert_base, 110,104,890 parameters, batch 32 x seq 512, bf16 O1,
     AdamW lr 1e-4, dropout 0, no mask, MLM labels at ~15 % of the
     positions as bench.py makes them) through TrainStep's graph, 2 + 6
     calls: (B1, B2, update) at (12, 12, 2) launches a step (204
     tensors), all sm90, every loss finite; the same numbers as phase
     17; then a 2-layer copy at the same widths and batch, 3 graph steps
     held to 3 eager steps, B1's calls recorded (non-causal, head_dim
     64, bf16);
 19. bench.py::bench_resnet50's config, BASELINE config 1, at full width
     and depth (resnet50 NHWC with the space-to-depth stem, 1000
     classes, 25,557,032 parameters, batch 256 x 224^2 x 3 images from
     a numpy seed on the card, bf16 O1, Momentum lr 0.1 with momentum
     0.9 and weight decay 1e-4, FLAGS_fast_bn_stats on, random weights
     from seed 0) through TrainStep's graph, 2 + 10 calls: the first
     call eager and captured, every later one a replay, every loss
     finite, every one of the 106 batch-norm buffers bit-equal to its
     value before the run, no kernel of the port launched, no
     AccumulateGrad warning; the step by wall and by replay, the idle
     share, images/s, MFU (bench.py's 3 x 4.09 GFLOP an image over the
     bf16 peak), peak memory, and the Momentum update alone (its
     launches by torch.profiler, its ms by replay, its byte bound); then,
     in f32 with TF32 off and cuDNN deterministic (both put back after),
     resnet50 at batch 8 x 64^2 through 3 graph steps held to 3 eager
     steps by phase 7's rule with the buffers unchanged in both, NHWC +
     s2d eval logits held to NCHW with the plain stem (the reference's
     5e-5 plus 1e-5 of the largest logit), and SGD, Momentum (Nesterov),
     Adamax, Adagrad, RMSProp (centered, momentum), Lamb, Adadelta and
     AdamW8bitStub each through 3 graph steps held to 3 eager steps on
     resnet18 at batch 8 x 64^2;
 20. bench.py::bench_spec_decode's configuration uncut (gpt3_1p3b's
     widths, bf16, max_batch 8, block 64, decode_chunk 16, prefix caching
     off; 16 requests, a 16-token pattern tiled 8 times, 128 new tokens
     each) served with n-gram speculation (k = 7) and without, each
     engine warmed on two requests first: tokens/s both ways, spec steps,
     drafted and accepted tokens, the pool's peak, the verify waves' B3
     launches counted around each wave (one a layer, every one sm90),
     spec-on tokens held to spec-off's under phase 16's margin guard;
     then spec off with one request poisoned at engine.decode.seq, one
     aborted and one past its deadline (an injected clock): the others'
     tokens held to the clean run's, every page back; then 2 layers in
     f32 (TF32 off) with DraftModelProposer drafting for the model
     itself: its acceptance rate (at least 0.95) and its tokens against
     spec off;
 21. gpt3_1p3b (bf16, 24 layers) served with int8 pools on phase 4's
     traffic, the scales from calibrate_kv_scales on the first prompt:
     the pools int8 at half of bf16's bytes, B3's simple design launched
     with dequant scales for the prefix-resume waves (recorded call by
     call), the decode graphs, tokens equal to phase 4's at half the
     positions or more, and equal under the guard of its own logit
     margins to the same engine run with its decode eager and B3 on its
     plain version;
 22. the eager API: every case of tests/eager_op_cases.py on CUDA
     Tensors held to the same case on CPU Tensors (values and
     backward() grads, TF32 off), every op of the registry dispatched on
     the card, the largest difference by op module; the random ops' same
     draws under one seed, their shapes and dtypes as on the CPU, and
     the range and moments of 10^6 draws of each; then bench_gpt2_small's
     config (b16 x s1024, bf16 O1, AdamW, dropout 0, all 12 layers) as
     the eager script of tests/eager_gpt_script.py on Tensors for 3
     steps, held to a GPTForCausalLM's own eager steps from the same
     weights by phase 7's rule, B1 and B2 at 12 sm90 launches a step
     through the scaled_dot_product_attention op, the step by wall
     beside phase 6's graph step, the ops dispatched a step, the host
     µs of a dispatched op and the device's idle share in a profiled
     step; then the same config as the GPT of
     tests/eager_gpt_layer_script.py, built from nn.Layers (Embedding,
     LayerNorm, Linear; weights in by set_state_dict, AdamW over
     model.parameters()), its state_dict keys GPTForCausalLM's, held
     bit for bit to GPTForCausalLM's eager steps (losses and every
     parameter), B1 and B2 at 12 sm90 launches a step, the ops of the
     dict script, its step by wall beside the dict script's (steps of
     the two forms in turns, with the allocator's counters, and two
     profiled pairs: device ms, idle share, device events and the
     kernels most apart), the host µs of a no-op Layer call against
     its forward; and a save/load round
     trip: save(model.state_dict()), the file read back with pickle
     and numpy alone and held to the model's values, set_state_dict(
     load(path)) into a fresh model, and one more step of each (a fresh
     AdamW each) bit-equal.
  23. io: the CPUs, the affinity set and /dev/shm's free bytes, and the
     process tier's worker count W (the largest <= 8 whose batches fit
     in /dev/shm at once); then (a) phase 19's config (resnet50, NHWC,
     s2d stem, b256 x 224^2, bf16 O1, Momentum, FLAGS_fast_bn_stats) fed
     by a DataLoader over 512 pooled images from a numpy seed, 2 + 10
     steps with num_workers=0 and again with W spawned workers, through
     one TrainStep: one capture and every later call a replay, losses
     finite, one host-to-device copy a batch, no fallback warning; step
     ms and images/s beside phase 19's, the consumer's wait a batch;
     (b) resnet50 at b8 x 64^2 in f32 (TF32 off, cuDNN deterministic):
     3 graph steps fed by the process tier bit-equal to 3 fed the same
     arrays; (c) the ImageNet-style pipeline: DatasetFolder over 1,280
     uint8 256^2 .npy files through RandomResizedCrop(224),
     RandomHorizontalFlip and an HWC Normalize on W workers, images/s of
     the loader alone and feeding (a)'s step (a reading), the temp dir
     and this process's segments gone after; (d) phase 22's nn.Layer
     GPT fed its 3 batches by a DataLoader with 2 workers, bit-equal to
     phase 22's steps, B1 and B2 at 12 sm90 launches a step.
 24. the LSTM language model of tests/lstm_lm_script.py at Zaremba et
     al.'s "large" PTB config (2 layers of 1500, 10,000 words, batch 20
     x 35 steps, 66.0 M parameters, f32, SGD lr 1, weights uniform in
     ±0.04 from numpy seed 0, random tokens): 3 eager steps on CUDA
     Tensors at dropout 0.65 with clip_grad_norm_(10), the states
     carried and detached (step ms by wall, one more step profiled:
     device ms, idle share); 2 + 10 TrainStep calls through one
     captured graph at dropout 0.65, the states carried in tensors the
     step writes (one capture, every later call a replay, no kernel of
     the port launched: the recurrence is plain PyTorch); the step by
     wall and by replay, the idle share, tokens/s and peak memory; at
     dropout 0 in f32 (TF32 off), 3 graph steps held to 3 of the same
     step run eagerly and to the script's 3 eager Tensor steps by
     phase 7's rule, the carried states to the script's; the port's
     nn.LSTM alone forward + backward beside torch.nn.LSTM (cuDNN, a
     yardstick only) with the same weights, held to it; one LBFGS step
     (strong Wolfe, history 10, max_iter 5): the loss falls and every
     iteration begins below max_eval;
 25. nn.functional.flash_attn_unpadded through B1/B2: 32 sequences of
     128-512 tokens from a numpy seed packed into one row (the total
     padded to a multiple of 128), at bert_base's widths (12 x 64,
     non-causal) and gpt2_small's (causal, equal packings), bf16: one
     sm90 B1 and one sm90 B2 launch a call with segment ids, the
     outputs and gradients held to B1/B2's plain versions in f32 on
     the card (phase 3's bf16 limit), padding rows and their
     gradients exactly 0; timed by events (the call, forward +
     backward) and B1 / B2 alone by replay beside the same sequences
     padded to [32, 512], with the block pairs each walks;
 26. the rest of the nn surface: the new op cases of phase 22's sweep
     (card against CPU) reported; weight_quantize (int8, int4,
     llm.int8) codes and scales equal to the CPU's, weight_only_linear
     (int8, int4) and llm_int8_linear at LLaMA-2-7B's MLP widths (4096
     -> 11008, 2048 tokens, bf16) held to the CPU, LLM.int8()'s split
     equal, each timed beside a bf16 product; LSTM, GRU and SimpleRNN
     (2 layers, bidirect) on the card held to the CPU.
 27. jit.save and the inference Predictor: a bert_base encoder
     (BertModel, 12 x 768, 12 heads, vocab 30,522, weights from numpy
     seed 0 through bert_params_from_numpy) cast to bf16 by
     amp.decorate(level="O2"), saved with InputSpec([None, 512],
     "int64") (the batch symbolic, bench_bert_base's s512), loaded by
     inference.Config + create_predictor and served at b32 and b8
     through the handle API: 12 sm90 B1 launches a run from inside the
     loaded program (the operator's CUDA implementation), the outputs
     against the eager model (bit-equal expected; EXPORT_TOL bounds
     them), the Predictor's graph replays bit-equal to the loaded
     module's eager call, one capture a batch size, a run's ms by wall
     (host copies included) and by replay beside the loaded module's and
     the eager model's forward, save and load seconds and the artifact's
     MiB; then bert_tiny in f32 saved on the CPU, served on the card and
     held to its CPU run within 1e-5;
 28. hapi: phase 22's nn.Layer GPT at bench_gpt2_small's config trained
     3 steps by Model.fit (AdamW, the next-token loss, metric.Accuracy)
     over a DataLoader of an io.Dataset of phase 22's batches, under the
     same bf16 O1 auto_cast (tests/hapi_gpt_script.py): losses and every
     parameter bit-equal to phase 22's eager steps, B1/B2 at 12 sm90
     launches a step, the step by wall beside phase 22's; summary's
     parameter count and FLOPs row, evaluate and predict on one batch, a
     Model.save / load round trip whose next step is bit-equal, and the
     net through jit.to_static equal to its eager forward.
 29. the vision zoo: every constructor but the ResNets (21, 1000
     classes, batch 2; LeNet at 28^2, InceptionV3 at 299^2, the rest at
     224^2) built on the CPU from one seed, its eval logits on the card
     against the CPU's within ZOO_TOL of the largest (f32, TF32 off);
     then mobilenet_v2 at bench_resnet50's recipe (scale 1.0, NCHW,
     b256 x 224^2, bf16 O1, Momentum(0.1, 0.9, wd 1e-4),
     FLAGS_fast_bn_stats) through TrainStep's graph, 2 + 10 calls, every
     batch-norm buffer kept, no kernel of the port on the path: the
     step by wall and by replay, the idle share, images/s, MFU by
     bench.py's convention (the forward's multiply-adds counted from the
     layers' shapes, x 3), peak memory, the update alone by replay;
     then in f32 at b8 x 64^2 (dropout 0), 3 graph steps bit-equal to
     3 eager steps, and one step on the card against the CPU's stage
     by stage (each stage from the CPU's input and cotangent) within
     MOBILENET_STAGE_TOL;
 30. detection at COCO widths, the card against the CPU on the same
     inputs: phase 22's long-tail op cases; YOLOv3's three heads (b8 at
     608^2, 80 classes, the paper's nine anchors, 50 ground truths an
     image): yolo_loss forward and backward, yolo_box, then
     multiclass_nms over the heads' 22,743 boxes (the card's yolo_box
     output on both devices, held exactly); Faster R-CNN's C4 RPN (2
     images of 800 x 1333, a 50 x 84 map, 15 anchors a cell):
     generate_proposals at Detectron's test settings (6000 / 1000, IoU
     0.7), then on its proposals roi_align from a 1024-channel map at
     14 x 14 (1.5 GiB out), distribute_fpn_proposals, roi_pool,
     psroi_pool, matrix_nms and nms; each timed by events, the NMS loops
     also by wall, profiled and not, and by the device time
     torch.profiler records (their host share against the unprofiled
     events time), every output on the card;
 31. incubate whole: its 16 registered op cases of phase 22's sweep;
     (a) FusedMultiTransformer at gpt3_1p3b's widths uncut (24 layers,
     2048 wide, 16 heads of 128, FFN 8192, gelu, pre-LN, bf16, weights
     from ParamAttr initializers on a seeded generator), 8 requests of
     512-token prompts prefilled into dense caches, then 64 decode steps
     through time_step, each held to a full forward of the 576 tokens
     without caches within MT_TOL, a corrupted cache row rejected; the
     prefill and each step timed by events beside the weight-read floor,
     one step profiled, peak memory; (b) 12 FusedTransformerEncoderLayers
     at bert_base's widths (post-LN, dropout 0.1) trained 3 eager steps
     on Tensors at b16 x s512 in bf16 O1 under asp.decorate(LookAhead(
     AdamW, k=2)) with the FFN weights pruned 2:4 and an identity_loss:
     B1 12, B2 12 and B4 24 sm90 launches a step, no plain version, every
     B1 call held to its plain version, the masks kept, ModelAverage's
     restore bit-equal; (c) at llama2_7b's widths, fused_rms_norm (B5),
     rotary, and B1/B2 through loss.backward() of fused_flash_attention
     and memory_efficient_attention (lower-triangular; block-diagonal
     causal over packed lengths, through segment ids), each call held to
     the plain versions, the packed call timed beside the padded batch.
 33. observability on the serving and training paths, in two parts
     that each run on the last phase's model and free it: (a) right
     after phase 4, on its gpt3_1p3b model, fresh engines serve phase
     4's 16 requests with observability off, on, off and on (metrics
     and tracing, the flight recorder armed in the last run); every run
     gives phase 4's tokens and launches B3 sm90 only; in the last,
     every decode step is a replay, paddle_tpu_engine_events_total
     equals engine.stats key by key, the TTFT / TPOT / e2e histograms
     count 16 requests, the spans engine.step > engine.prefill >
     engine.ragged and engine.step > engine.decode_chunk are there and
     each request's events hang under its own root span,
     paddle_tpu_compile_total{family} equals the captures, and every
     engine_decode and engine_ragged roofline sample and the window's
     record lie in (0, 1.05] (printed beside phase 4's weight-read
     floor); a planted deadline miss drops one flight bundle holding
     the metrics and the trace; a Profiler session over two engine
     steps exports a chrome trace with host spans and device kernels;
     tokens/s and the median steady decode step (a chunk alone, no
     capture, no packed wave) of each run. (b) right after phase 6, on
     its gpt2_small TrainStep: 4 calls from one state (a fresh capture,
     then replays) with observability off, on, off and on, the losses
     bit-equal, the captures equal paddle_tpu_compile_total, every
     train_step roofline sample and the window in (0, 1.05]; a Profiler
     session over one replayed train step (in a RecordEvent) exports a
     chrome trace with host spans and device kernels, a second one over
     an eager step, each printing the hand-written kernels it names;
     device.max_memory_allocated() equals torch.cuda's across a reset;
     the step's median ms off and on. Both print the card's name and
     power limit.
 34. the numerics plane on phase 6's gpt2_small TrainStep (all 12
     layers, bf16 O1, AdamW, b16 x s1024), right after 33b: (a) the
     multi-tensor update's statistics variant against its plain version
     at phase 6's 148 f32 shapes (phase 12's first case): the packed
     sums within NUM_STATS_RTOL of pack_stats over a clone of the
     pre-update work arrays, the counts equal, parameters, moments and
     powers bit-equal to the statistics-off launch, a row left out of
     the table caught; on and off timed by replay in turns beside the
     byte bound; (b) 8 calls from one state with the plane off, on, off
     and on (metrics on throughout), each a fresh capture: one graph a
     run counted as a train_step compile, one pull a published step,
     the statistics kernel launched on the path and not with the plane
     off, losses and parameters bit-equal on and off, step 1's grad
     norm, param norm and update ratio within NUM_RECOMPUTE_RTOL of a
     plain recomputation, the step's median ms off and on; (c) an eager
     step (the eager API's backward, Optimizer.step) with one
     parameter's gradient poisoned through the numerics.check fault
     point gives exactly one numerics_divergence flight bundle naming
     it, with the backward tap's record; a clean step re-arms the
     sentinel; an f16 GradScaler run poisoned at every step halves its
     scale from 16 to the floor and fires one more bundle with the
     scale history; (d) the goodput fractions (comms, compute, stall)
     published by the timed replays, summing to at most 1;
 35. the host modules on the card: text.ViterbiDecoder (64 x 256 x 48)
     on CUDA tensors equals the CPU's, a static.Executor program with a
     static.nn.while_loop runs on the card as on the CPU,
     save_inference_model / load_inference_model round-trip an MLP on
     the card, and a g++ utils.cpp_extension op gives the same result
     on CUDA and CPU tensors;
 36. the serving fleet on gpt3_1p3b at full width (bf16, 120 pages of
     64 tokens a replica, bench.py's fleet configurations), its oracle
     one never-killed engine's greedy tokens under the margin guard:
     (a) two in-process replicas behind a Router on
     bench_router_serving's traffic (8 sessions x 4 turns, a 512-token
     prefix each), affinity on and off (tokens/s, prefix hit rates),
     then replica 0 killed by the `router.replica.step` fault: one
     failover, no leaked page, B3 sm90 in every replica; (b) a
     DisaggRouter (1 prefill, 2 decode replicas) on bench_disagg's 80
     events, a fixed prompt set on the migrated rung and, under the
     `disagg.migrate` fault, on the re-admission rung (bytes = pages x
     12 MiB, handoff MiB/s), then an Autoscaler over a FleetSLOMonitor
     growing 1 -> 2 replicas on a burst and retiring one when calm, one
     flight bundle a decision; (c) two replica processes on the card
     (one exec-cache store, a FleetAggregator), 8 requests, one process
     SIGKILLed mid-decode: ReplicaGone, failover, a replacement whose
     kernel libraries are all disk hits (no compiler run), bundles from
     every process, the failed-over traces connected; spawn-to-ready
     cold and warm.
 37. the models on Tensors: gpt2_small at full width (f32) called on a
     Tensor gives a Tensor bit-equal to the torch-level call;
     model.generate on a Tensor (32 new tokens) gives generate's tokens
     on torch tensors; save(state_dict) / set_state_dict(load) gives
     bit-equal logits; AdamW.minimize equals backward, step,
     clear_grad bit for bit; LLaMA at LLaMA-2-7B's widths (2 layers,
     bf16) and BERT-base (2 layers) take Tensors;
 38. the block-config cache: from an empty cache under build/, B1 and
     B2 tuned at gpt2_small's training shape and B3 at gpt3_1p3b's
     fresh wave (each candidate build's time, the winner, the
     bandwidth probes, persisted), each winner held to the plain
     version at phase 3's and phase 2's tolerances, a fresh process
     reading the winners with no timing, the kill switch restoring the
     defaults, phase 6's run again with the winners (its step by
     replay beside phase 6's), and no timing inside a capture over the
     whole run (every phase tunes at its first shape class, from an
     empty cache of the run's own);
 39. the collectives: gpt2_small's 148 gradient-sized tensors through
     every collective, eager rank-major at the card's world (1) and
     per-rank through an NCCL process group of world size 1, each
     equal to its value, the comms series (bytes, seconds,
     algorithmic bandwidth) recorded; a DataParallel gpt2_small step
     bit-equal to the bare step; destroy_process_group.

Each phase's wall seconds are printed ("[phase-seconds]"). The last
three lines of standard output are a JSON record of the
kernels, the card's name and power limit, and the final
{"ok": true, "device": ...} line. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# roofline bound of a launch is the larger of bytes / HBM rate and
# flops / bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12          # outside the tensor cores

# kernel vs plain tolerance (absolute, on f32 outputs of order 1): the
# plain version runs in f32 on the same bf16 values the kernel reads,
# and the kernel also computes in f32, so the two differ only in
# summation order (~1e-6). 1e-3 still catches a single key wrongly
# masked in or out of a ~500-key row (an error of order 1e-3..1e-2).
KERNEL_ATOL = 1e-3
# the design every B3 launch of the serving runs (phases 4 and 9) takes
B3_MAIN_DESIGN = "sm90"
# decode graphs a serving run may capture: one per page-table width
# bucket its chunks meet (tests/test_torch_decode_graph.py holds the
# bucket rule to this on the runs' traffic)
MAX_DECODE_GRAPHS = 4
B3_SOURCES = {"sm90": "ragged_paged_attention_sm90.cu",
              "simple": "ragged_paged_attention.cu"}


def log(*a):
    print(*a, flush=True)


# The models are Layers, whose own parameters() / state_dict() /
# buffers() give the eager API's Parameters and Tensors; the torch-level
# phases read torch's.
def _torch_params(model):
    import torch
    return torch.nn.Module.parameters(model)


def _torch_named_params(model):
    import torch
    return torch.nn.Module.named_parameters(model)


def _torch_state(model):
    import torch
    return torch.nn.Module.state_dict(model)


def _torch_buffers(model):
    import torch
    return torch.nn.Module.buffers(model)


@contextlib.contextmanager
def kernel_events(**targets):
    """Measurement only: while the block runs, each wrapper named by
    targets (name=(module, attribute)) is timed by CUDA events around
    every call outside a CUDA-graph capture (a replay calls no wrapper);
    yields {name: [(start, end), ...]}, read after a synchronise. The
    wrappers are restored on exit."""
    import torch
    events = {name: [] for name in targets}
    saved = {name: getattr(m, a) for name, (m, a) in targets.items()}

    def timed(name, fn):
        def run(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kw)      # a capture runs nothing
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*args, **kw)
            e.record()
            events[name].append((s, e))
            return r
        return run

    for name, (m, a) in targets.items():
        setattr(m, a, timed(name, saved[name]))
    try:
        yield events
    finally:
        for name, (m, a) in targets.items():
            setattr(m, a, saved[name])


@contextlib.contextmanager
def capture_counts(read):
    """Measurement only: while the block runs, `read()` (a tuple of
    launch counters) is taken at the start and at the end of every
    CUDA-graph capture; yields [(before, after), ...], one pair a
    capture. A counter counts a launch of an eager run and one of a
    capture (which runs nothing) alike: this splits the two."""
    import torch
    spans = []
    base = torch.cuda.graph

    class counted(base):
        def __enter__(self):
            self._counts_before = read()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            spans.append((self._counts_before, read()))
            return out

    torch.cuda.graph = counted
    try:
        yield spans
    finally:
        torch.cuda.graph = base


@contextlib.contextmanager
def kernel_calls(module, attr, keep=None):
    """Checking only: while the block runs, every call of the wrapper
    module.attr is recorded as (args, result), for holding the kernel's
    results on the main path against its plain version afterwards, or
    as `keep(args, result)` where that is given (a training run keeps no
    tensor: one kept from a step would keep that step's autograd graph
    alive into the next). The wrapper is restored on exit; nothing is
    launched by the recording."""
    calls = []
    saved = getattr(module, attr)

    def run(*args):
        r = saved(*args)
        calls.append((args, r) if keep is None else keep(args, r))
        return r

    setattr(module, attr, run)
    try:
        yield calls
    finally:
        setattr(module, attr, saved)


@contextlib.contextmanager
def stream_mismatch_warnings():
    """Checking only: while the block runs, torch gives each warning it
    would give once a process every time (torch.set_warn_always), and
    the block's warnings are recorded; yields a list that holds, after
    the block, the messages of torch's "AccumulateGrad node's stream
    does not match" warning. torch gives it when a backward reaches a
    parameter's gradient node made on another stream by an earlier step
    whose autograd graph is still alive: in a capture, a dependency on
    another stream that the eager step does not have. Other warnings
    are shown once each."""
    import warnings

    import torch
    always = torch.is_warn_always_enabled()
    found = []
    torch.set_warn_always(True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield found
    finally:
        torch.set_warn_always(always)
    shown = set()
    for w in seen:
        msg = str(w.message)
        if "AccumulateGrad node's stream" in msg:
            found.append(msg)
        elif msg not in shown:
            shown.add(msg)
            warnings.showwarning(w.message, w.category, w.filename,
                                 w.lineno)


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of `fn` over `iters` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn, reps=20, iters=10):
    """Median device time of one `fn` call: `reps` calls captured in one
    CUDA graph and replayed `iters` times between CUDA events. Unlike
    cuda_ms, no host time enters: a call shorter than its wrapper's
    host path (argument checks, allocation, the launch) is timed as what
    the device spends on it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: card and builds
# ---------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_all() -> dict:
    """Build every native library at once (one compiler per source, all
    started together); returns {name: seconds}."""
    from paddle_tpu_torch.inference import paged_cache
    from paddle_tpu_torch.io import native
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.kernels import norms
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    jobs = {"ragged_paged_attention.cu (nvcc)": rpa._load_kernel,
            "ragged_paged_attention_sm90.cu (nvcc)": rpa._load_sm90,
            "flash_attention.cu (nvcc)": fa._load_kernel,
            "flash_fwd_sm90.cu (nvcc)": fa._load_sm90,
            "flash_bwd_sm90.cu (nvcc)": fa._load_sm90_bwd,
            "norms.cu (nvcc)": norms._load_kernel,
            "multi_tensor_adam.cu (nvcc)": mta._load_kernel,
            "_block_allocator.cpp (g++)": paged_cache._load_lib,
            "io/native/queue.cc (g++)": native.load}
    # the build variants the block-config cache times (phase 38): one
    # nvcc each, with the rest
    for src, table in (("flash_fwd_sm90.cu", fa._FWD_VARIANTS),
                       ("flash_bwd_sm90.cu", fa._BWD_VARIANTS),
                       ("ragged_paged_attention_sm90.cu", rpa._RPA_VARIANTS)):
        for v in table.variants[1:]:
            d = min(v)
            jobs[f"{src} {' '.join(table.flags(d, v[d]))} (nvcc)"] = (
                lambda t=table, d=d, c=v[d]: t.library(d, c))
    secs, errors = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:          # reported below, run fails
            errors[name] = e
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    return secs


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version at the engine's shapes
# ---------------------------------------------------------------------------
def _token_bucket(n, quantum=128):
    """The engine's total-token bucket (LLMEngine._token_bucket)."""
    if n >= quantum:
        return -(-n // quantum) * quantum
    b = 8
    while b < n:
        b *= 2
    return b


def _case(name, rng, *, rows_spec, H=16, Hk=16, D=128, bs=64, NB=257,
          int8=False, shared_prefix_pages=0, dtype="bfloat16"):
    """One packed launch. rows_spec: [(cached_tokens, new_tokens)] per
    live row (a row with 0 new tokens is an empty slot). Pages are drawn
    at random from the pool; the first `shared_prefix_pages` pages of
    every row are the same physical pages (a shared cached prefix).
    q/k/v (and fp pools) are of `dtype`, bfloat16 or float16."""
    import torch
    B = len(rows_spec)
    T_raw = sum(m for _c, m in rows_spec)
    T = _token_bucket(T_raw)
    rows = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    kv_start = np.zeros((B,), np.int32)
    off = np.full((B, NB), -1, np.int32)
    free = list(rng.permutation(NB))
    shared = [free.pop() for _ in range(shared_prefix_pages)]
    c = 0
    for b, (cached, m) in enumerate(rows_spec):
        if m == 0:
            continue
        rows[c:c + m] = b
        pos[c:c + m] = cached + np.arange(m)
        kv_start[b] = cached
        npg = -(-(cached + m) // bs)
        pages = shared[:min(npg, len(shared))]
        pages = pages + [free.pop() for _ in range(npg - len(pages))]
        off[b, pages] = np.arange(npg) * bs
        c += m
    dev = "cuda"
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dt)

    x = dict(q=rnd(T, H, D), k_new=rnd(T, Hk, D), v_new=rnd(T, Hk, D),
             rows=torch.from_numpy(rows).to(dev),
             pos=torch.from_numpy(pos).to(dev),
             kv_start=torch.from_numpy(kv_start).to(dev),
             off=torch.from_numpy(off).to(dev), kdq=None, vdq=None)
    with_pool = bool(kv_start.any())
    if int8:
        for k in ("kpool", "vpool"):
            x[k] = torch.from_numpy(rng.integers(
                -127, 128, (NB * bs, Hk, D)).astype(np.int8)).to(dev)
        x["kdq"] = torch.from_numpy(rng.uniform(
            0.005, 0.02, (Hk,)).astype(np.float32)).to(dev)
        x["vdq"] = torch.from_numpy(rng.uniform(
            0.005, 0.02, (Hk,)).astype(np.float32)).to(dev)
    else:
        x["kpool"] = rnd(NB * bs, Hk, D)
        x["vpool"] = rnd(NB * bs, Hk, D)
    meta = dict(name=name, T=T, T_live=T_raw, H=H, Hk=Hk, D=D, bs=bs,
                with_pool=with_pool, rows=rows, pos=pos, kv_start=kv_start,
                off=off)
    return x, meta


def _bound(meta, pool_itemsize):
    """(bound_ms, bound_by, bytes, flops) of one launch: each input byte
    read once (q, k_new, v_new of live tokens, metadata, the rows' valid
    pool slots counted once across rows sharing them), the f32 output
    written once; 4*D flops per valid (q head, key) pair."""
    rows, pos, kv_start, off = (meta[k] for k in ("rows", "pos",
                                                  "kv_start", "off"))
    H, Hk, D, bs = meta["H"], meta["Hk"], meta["D"], meta["bs"]
    live = rows >= 0
    pool_keys = np.zeros(len(kv_start), np.int64)
    slots = set()
    if meta["with_pool"]:
        for b in range(len(kv_start)):
            for p in np.flatnonzero(off[b] >= 0):
                n = int(np.clip(kv_start[b] - off[b, p], 0, bs))
                pool_keys[b] += n
                slots.update(range(p * bs, p * bs + n))
    pairs = 0
    for t in np.flatnonzero(live):
        r = rows[t]
        pairs += pool_keys[r] + int(((rows == r) & (pos <= pos[t])).sum())
    flops = 4 * D * H * pairs
    n_live = int(live.sum())
    nbytes = (n_live * (H + 2 * Hk) * D * 2 + 8 * len(rows)
              + len(slots) * Hk * D * pool_itemsize * 2
              + len(rows) * H * D * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


# B3's specs at the engine's shapes: (name, _case keywords)
def _ragged_specs(rng):
    prefix_tails = [(512, int(m)) for m in rng.integers(8, 33, 8)]
    fresh = [(0, 512 + int(m)) for m in rng.integers(8, 33, 8)]
    return [
        ("fresh wave, no pool", dict(rows_spec=fresh)),
        ("prefix-resume wave", dict(rows_spec=prefix_tails,
                                    shared_prefix_pages=8)),
        ("int8 pool + dequant", dict(rows_spec=prefix_tails,
                                     shared_prefix_pages=8, int8=True)),
        ("GQA H=16 Hk=4", dict(rows_spec=prefix_tails, Hk=4,
                               shared_prefix_pages=8)),
        ("dead padding rows",
         dict(rows_spec=[(100, 16), (0, 0), (777, 1), (0, 0), (64, 9),
                         (300, 5), (0, 0), (1000, 3)])),
        # llama2_7b's waves in phase 9: 32 heads, as many kv heads
        ("llama2_7b fresh wave H=32",
         dict(rows_spec=[(0, 512 + int(m)) for m in rng.integers(8, 33, 8)],
              H=32, Hk=32)),
        ("llama2_7b prefix-resume H=32",
         dict(rows_spec=prefix_tails, H=32, Hk=32, shared_prefix_pages=8)),
        # phase 16's waves: gpt3_1p3b in f16 (f16 q/k/v over f16 pools),
        # and f16 q over an int8 pool
        ("f16 fresh wave, no pool", dict(rows_spec=fresh, dtype="float16")),
        ("f16 prefix-resume wave", dict(rows_spec=prefix_tails,
                                        shared_prefix_pages=8,
                                        dtype="float16")),
        ("f16 int8 pool + dequant", dict(rows_spec=prefix_tails,
                                         shared_prefix_pages=8, int8=True,
                                         dtype="float16")),
    ]


# B3 at the two calls phases 20-21 add (drawn from a generator of their
# own, so the cases above keep their data): a speculative verify wave at
# bench_spec_decode's config (8 rows of 1 + 7 drafts over cached
# contexts, the bucket pinned at 64 tokens), and the int8 engine's
# prefix-resume wave (bf16 q over int8 pools with dequant scales)
def _ragged_specs_new_calls(rng):
    return [
        ("verify wave 8x8", dict(rows_spec=[
            (int(c), 8) for c in rng.integers(128, 256, 8)])),
        ("int8 engine wave", dict(rows_spec=[
            (512, int(m)) for m in rng.integers(8, 33, 8)],
            shared_prefix_pages=8, int8=True)),
    ]


# faults planted in the plain version's masks (f32); their effect on the
# output, added to each design's result, must fail that design's check
RAGGED_PLANTED = ("one page's valid slots dropped",
                  "one fresh key past the diagonal let in")


def _ragged_planted(rpa, f32_args, common, meta, want) -> dict:
    """{fault: output change} of RAGGED_PLANTED on this case (a fault with
    no place in the case, such as a dropped page without a pool, is
    left out): the plain version in f32 run with the fault in its
    masks, less `want`. The dropped page is the first valid page of the
    first row with a pool; the key let in is the next token of the row
    of the query with the fewest valid keys."""
    import torch
    rows, pos, kv_start, off, bs = (meta[k] for k in (
        "rows", "pos", "kv_start", "off", "bs"))
    live = rows >= 0
    spots = {}
    if meta["with_pool"]:
        r = int(next(b for b in rows[live] if kv_start[b] > 0))
        pg = int(np.argmin(np.where(off[r] >= 0, off[r].astype(np.int64),
                                     2 ** 31)))
        n = int(min(kv_start[r] - off[r, pg], bs))
        spots[RAGGED_PLANTED[0]] = ("pool", np.flatnonzero(rows == r),
                                    slice(pg * bs, pg * bs + n))
    nkeys = [(kv_start[rows[t]] + int(((rows == rows[t])
                                       & (pos <= pos[t])).sum()), t)
             for t in np.flatnonzero(live)
             if ((rows == rows[t]) & (pos == pos[t] + 1)).any()]
    if nkeys:
        t = min(nkeys)[1]
        u = int(np.flatnonzero((rows == rows[t]) & (pos == pos[t] + 1))[0])
        spots[RAGGED_PLANTED[1]] = ("pack", np.array([t]), u)
    saved = rpa._masks_reference
    out = {}
    for what, (kind, toks, cols) in spots.items():
        def planted(*a, **kw):
            pool_ok, pack_ok = saved(*a, **kw)
            m = (pool_ok if kind == "pool" else pack_ok).clone()
            for t in toks:
                m[int(t), cols] = kind != "pool"
            return (m, pack_ok) if kind == "pool" else (pool_ok, m)
        rpa._masks_reference = planted
        try:
            bad = rpa._ragged_reference(*f32_args, meta["bs"],
                                        common["scale"], kdq=common["kdq"],
                                        vdq=common["vdq"],
                                        with_pool=common["with_pool"])
        finally:
            rpa._masks_reference = saved
        out[what] = bad - want
        del bad
    torch.cuda.synchronize()
    return out


def _sdpa_yardstick(x, meta, scale):
    """(call, unpack) for one torch.nn.functional.scaled_dot_product_attention
    call that computes the case's function (a yardstick only: the port
    never calls it for B3); an int8 pool is dequantized to q's dtype
    first, outside the call. Operands are
    padded and gathered outside the timed call: each live row's tokens,
    sorted by position, are one batch entry [B_live, H, Lq_max, D].
    Without a pool each row starts at position 0, so top-left is_causal
    is right for its valid tokens; with a pool the keys are the row's
    valid pool slots (in page order) then its fresh keys [B_live, Hk,
    Lk_max, D], under a boolean mask. unpack(o) scatters SDPA's output
    back to the packed [T, H, D] rows."""
    import torch
    import torch.nn.functional as tF
    kpool, vpool = x["kpool"], x["vpool"]
    if kpool.dtype == torch.int8:
        # int8 pools: SDPA on the pools dequantized to q's dtype, the
        # dequant done here, outside the timed call (not counted)
        kpool, vpool = ((pool.float() * dq[None, :, None]).to(x["q"].dtype)
                        for pool, dq in ((kpool, x["kdq"]),
                                         (vpool, x["vdq"])))
    rows, pos, kv_start, off, bs = (meta[k] for k in (
        "rows", "pos", "kv_start", "off", "bs"))
    wp = meta["with_pool"]
    live_rows = sorted({int(r) for r in rows if r >= 0})
    toks = [np.flatnonzero(rows == r) for r in live_rows]
    toks = [t[np.argsort(pos[t], kind="stable")] for t in toks]
    ctx = []
    for r in live_rows:
        sl = []
        if wp:
            for p in np.argsort(np.where(off[r] >= 0, off[r].astype(np.int64),
                                         2 ** 31), kind="stable"):
                n = int(np.clip(kv_start[r] - off[r, p], 0, bs))
                if off[r, p] < 0 or n == 0:
                    break
                sl.extend(range(p * bs, p * bs + n))
        ctx.append(np.asarray(sl, np.int64))
    Bl, H, D = len(live_rows), meta["H"], meta["D"]
    Hk = meta["Hk"]
    Lq = max(len(t) for t in toks)
    Lk = max(len(c) + len(t) for c, t in zip(ctx, toks))
    dev = x["q"].device
    qp = torch.zeros((Bl, H, Lq, D), dtype=x["q"].dtype, device=dev)
    kp = torch.zeros((Bl, Hk, Lk, D), dtype=x["q"].dtype, device=dev)
    vp = torch.zeros_like(kp)
    mask = torch.zeros((Bl, 1, Lq, Lk), dtype=torch.bool, device=dev)
    for i, (t, c) in enumerate(zip(toks, ctx)):
        ti = torch.from_numpy(t).to(dev)
        qp[i, :, :len(t)] = x["q"][ti].transpose(0, 1)
        if len(c):
            ci = torch.from_numpy(c).to(dev)
            kp[i, :, :len(c)] = kpool[ci].transpose(0, 1)
            vp[i, :, :len(c)] = vpool[ci].transpose(0, 1)
        kp[i, :, len(c):len(c) + len(t)] = x["k_new"][ti].transpose(0, 1)
        vp[i, :, len(c):len(c) + len(t)] = x["v_new"][ti].transpose(0, 1)
        ok = np.zeros((Lq, Lk), bool)
        ok[:, :len(c)] = True
        ok[:len(t), len(c):len(c) + len(t)] = pos[t][None, :] <= pos[t][:, None]
        ok[len(t):, 0] = True            # padded queries: any one key
        mask[i, 0] = torch.from_numpy(ok).to(dev)
    gqa = Hk != H
    if wp:
        call = lambda: tF.scaled_dot_product_attention(
            qp, kp, vp, attn_mask=mask, scale=scale, enable_gqa=gqa)
    else:
        call = lambda: tF.scaled_dot_product_attention(
            qp, kp, vp, is_causal=True, scale=scale, enable_gqa=gqa)

    def unpack(o):
        out = torch.zeros((len(rows), H, D), dtype=torch.float32,
                          device=dev)
        for i, t in enumerate(toks):
            out[torch.from_numpy(t).to(dev)] = \
                o[i, :, :len(t)].transpose(0, 1).float()
        return out
    return call, unpack


def ragged_case(rpa, name, kw, rng, timed=True) -> dict:
    """B3 at one phase 2 case: every design that takes the case (the
    simple one always; the tiled one for bf16 or f16 over pools of the
    same dtype at head_dim 64/128) held to the plain version in f32 on
    the same bf16 (or f16) values, each within its limit, with dead rows
    exactly 0 and the planted faults rejected; then
    (`timed`) each design by single-call events and by CUDA-graph replay
    with the plan built outside, the plan alone, the plain version, and
    the SDPA yardstick by events and by replay."""
    import torch
    x, meta = _case(name, rng, **kw)
    wp = meta["with_pool"]
    common = dict(block_size=meta["bs"], scale=1.0 / np.sqrt(meta["D"]),
                  kdq=x["kdq"], vdq=x["vdq"], with_pool=wp)
    args = [x[k] for k in ("q", "k_new", "v_new", "kpool", "vpool",
                           "rows", "pos", "kv_start", "off")]
    meta_args = (x["rows"], x["pos"], x["kv_start"], x["off"], meta["bs"],
                 wp)
    plan = rpa.ragged_plan(*meta_args)
    auto = rpa._rpa_design(x["q"].dtype, x["kpool"].dtype if wp else None,
                           meta["D"], True)
    designs = [d for d in rpa._RPA_DESIGNS if d == "simple" or d == auto]

    def kern(design):
        return lambda: rpa._ragged_cuda(*args, **common, _plan=plan,
                                        design=design)

    def plain():
        return rpa.ragged_paged_attention(*args, path="torch", **common)

    low = (torch.bfloat16, torch.float16)
    f32 = [a.float() if a.dtype in low else a for a in args]
    want = rpa.ragged_paged_attention(*f32, path="torch", **common)
    # the reference's own rounding: the plain version in its cast order
    # (q * scale and p cast to bf16 or f16 before the products) against
    # f32
    gap = float((plain() - want).abs().max())
    tols = {"simple": KERNEL_ATOL, "sm90": max(KERNEL_ATOL, 2 * gap)}
    planted = _ragged_planted(rpa, f32, common, meta, want)
    dead = torch.from_numpy(meta["rows"] < 0).to(want.device)
    rec = dict(case=name, dtype=str(x["q"].dtype).removeprefix("torch."),
               T=meta["T"], T_live=meta["T_live"], H=meta["H"],
               Hk=meta["Hk"], D=meta["D"], with_pool=wp, design=auto,
               reference_gap=gap, designs={})
    for d in designs:
        n0 = dict(rpa.ragged_paged_attention.design_launches)
        got = kern(d)()
        torch.cuda.synchronize()
        moved = {k: v - n0[k] for k, v in
                 rpa.ragged_paged_attention.design_launches.items()}
        err = float((got - want).abs().max())
        bad = {what: float((got + delta - want).abs().max())
               for what, delta in planted.items()}
        ok = (moved == {k: int(k == d) for k in moved}
              and bool(torch.isfinite(got).all()) and err <= tols[d]
              and (not dead.any() or bool((got[dead] == 0).all()))
              and all(e > tols[d] for e in bad.values()))
        if not ok:
            raise RuntimeError(
                f"kernel case {name!r} ({d}): max abs err {err} (limit "
                f"{tols[d]}), launches by design {moved}, planted {bad}, "
                "or non-finite / non-zero dead rows")
        rec["designs"][d] = dict(max_abs_err=err, tol=tols[d],
                                 planted_max_abs_err=bad)
        del got
    rec["max_abs_err"] = rec["designs"][auto]["max_abs_err"]
    if timed:
        for d in designs:
            rec["designs"][d].update(ms=cuda_ms(kern(d)),
                                     ms_graph=graph_ms(kern(d)))
        rec["ms"] = rec["designs"][auto]["ms"]
        rec["ms_graph"] = rec["designs"][auto]["ms_graph"]
        rec["simple_ms"] = rec["designs"]["simple"]["ms"]
        rec["simple_ms_graph"] = rec["designs"]["simple"]["ms_graph"]
        rec["plan_ms"] = cuda_ms(lambda: rpa.ragged_plan(*meta_args))
        rec["plain_ms"] = cuda_ms(plain, iters=10)
        lib = _sdpa_yardstick(x, meta, common["scale"])
        rec["library_ms"] = rec["library_ms_graph"] = None
        if lib is not None:
            call, unpack = lib
            with torch.no_grad():
                live = torch.from_numpy(meta["rows"] >= 0).to(want.device)
                rec["library_max_abs_err"] = float(
                    (unpack(call()) - want)[live].abs().max())
                rec["library_ms"] = cuda_ms(call)
                rec["library_ms_graph"] = graph_ms(call)
        (rec["bound_ms"], rec["bound_by"], rec["bytes"],
         rec["flops"]) = _bound(meta, x["kpool"].element_size())
    del x, args, f32, want, plan, planted
    torch.cuda.empty_cache()
    return rec


def _fmt_ms(v):
    return "n/a" if v is None else f"{v:.4f}"


def kernel_phase() -> list:
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    rng = np.random.default_rng(0)
    rng_new = np.random.default_rng(14)
    out = []
    for name, kw, r in ([(n, kw, rng) for n, kw in _ragged_specs(rng)]
                        + [(n, kw, rng_new)
                           for n, kw in _ragged_specs_new_calls(rng_new)]):
        rec = ragged_case(rpa, name, kw, r)
        by = "; ".join(
            f"{d} err {r['max_abs_err']:.3e} (limit {r['tol']:.3e}, planted "
            f"{ {k[:12]: round(v, 4) for k, v in r['planted_max_abs_err'].items()} }) "
            f"{r['ms']:.4f} ms by events, {r['ms_graph']:.4f} by replay"
            for d, r in rec["designs"].items())
        log(f"[kernel] {name}: {rec['dtype']} T={rec['T']} (live "
            f"{rec['T_live']}) H={rec['H']} Hk={rec['Hk']} design "
            f"{rec['design']}; {by}; "
            f"plan {rec['plan_ms']:.4f} ms; plain {rec['plain_ms']:.4f}; "
            f"SDPA {_fmt_ms(rec['library_ms'])} / "
            f"{_fmt_ms(rec['library_ms_graph'])} (err "
            f"{rec.get('library_max_abs_err')}); reference gap "
            f"{rec['reference_gap']:.3e}; bound {rec['bound_ms']:.5f} "
            f"({rec['bound_by']})")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 4: gpt3_1p3b served at full width and depth
# ---------------------------------------------------------------------------
def _all_sm90(designs, launches):
    """serve_phase's default B3 check: every launch the sm90 design."""
    return (f"every B3 launch ran the {B3_MAIN_DESIGN} design",
            designs == {d: launches * (d == B3_MAIN_DESIGN)
                        for d in designs})


# each serving run's tokens by request, keyed by (label, dtype, pools):
# phase 21 holds the int8 engine's to phase 4's
SERVED = {}


def serve_phase(label, build, engine_kw, wave_hooks=None, after=None,
                oracle=None, b3_check=_all_sm90, keep=None) -> dict:
    """Serve 16 requests sharing a 512-token prefix (64 new tokens each)
    through LLMEngine on the model `build()` returns ((model, cfg), bf16
    or f16 at full width and depth); `engine_kw` is the engine's
    keywords, or a function of (model, prompts) that makes them.
    `wave_hooks(model)` names modules
    whose inputs are captured during the first packed wave; `after(model,
    captured)` runs checks on them before the model is freed and returns
    a dict merged into the record; so does `oracle(model, prompts, done)`
    with the requests' results. `b3_check(designs, launches)` says which
    B3 designs the run must launch. `keep`, a dict, receives the model,
    its config, the prompts and the engine's keywords (phase 33a serves
    them again) instead of the model being freed."""
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa

    t0 = time.perf_counter()
    model, cfg = build()
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (512,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    (int(t),))])
               .astype(np.int32) for t in rng.integers(8, 33, 16)]
    n_new = 64
    eng = LLMEngine(model, **(engine_kw(model, prompts)
                              if callable(engine_kw) else engine_kw))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # measurement only: wall time of each packed wave and of each decode
    # chunk (with its step count), and device time of each attention call
    # inside the waves (CUDA events, read after the run)
    waves, chunks, captured = [], [], []
    run_ragged = eng._run_ragged
    decode_chunk = eng._decode_chunk
    hooked = wave_hooks(model) if wave_hooks else []

    def timed_wave(entries):
        # measurement only: the first wave's hooked inputs are copied out
        handles = [] if waves else [m.register_forward_pre_hook(
            lambda _m, args: captured.append(args[0].detach().clone()))
            for m in hooked]
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run_ragged(entries)
        waves.append(time.perf_counter() - t)
        for h in handles:
            h.remove()
        return r

    def timed_chunk(cur, lens, tbl, chunk):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = decode_chunk(cur, lens, tbl, chunk)     # ends in a host copy
        chunks.append((time.perf_counter() - t, chunk, tbl.shape[1]))
        return r

    eng._run_ragged = timed_wave
    eng._decode_chunk = timed_chunk
    torch.cuda.reset_peak_memory_stats()
    with kernel_events(attn=(eng_mod, "ragged_paged_attention"),
                       plan=(eng_mod, "ragged_plan")) as events:
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=n_new)
        done, step_s = {}, []
        rpa.reset_counters()
        cuda_graph.reset_counters()
        t_run = time.perf_counter()
        while eng.has_unfinished:
            t = time.perf_counter()
            for r in eng.step():
                done[r.request_id] = r
            step_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        f = rpa.ragged_paged_attention
        launches, plain_calls = f.kernel_launches, f.plain_calls
        designs, plans = dict(f.design_launches), f.plan_builds
        graph_captures = cuda_graph.captures["engine_decode"]
        graph_replays = cuda_graph.replays["engine_decode"]
        capture_s = cuda_graph.capture_seconds["engine_decode"]
    attn_ms = sum(s.elapsed_time(e) for s, e in events["attn"])
    plan_ms = sum(s.elapsed_time(e) for s, e in events["plan"])

    bad = [i for i in range(len(prompts))
           if i not in done or done[i].finish_reason != "length"
           or len(done[i].output_ids) != n_new
           or not ((done[i].output_ids >= 0)
                   & (done[i].output_ids < cfg.vocab_size)).all()]
    st = eng.stats
    decode_steps = sum(n for _s, n, _w in chunks)
    widths = sorted({w for _s, _n, w in chunks})
    checks = {
        "every request returned 64 in-vocab tokens": not bad,
        f"every decode step replayed a captured graph ({decode_steps})":
            graph_replays == decode_steps,
        f"one graph captured per width bucket {widths}, at most "
        f"{MAX_DECODE_GRAPHS}": graph_captures == len(widths)
            <= MAX_DECODE_GRAPHS,
        "prefix cache hit (with_pool wave ran)":
            st["prefix_cache_hit_tokens"] > 0,
        "kernel launched": launches > 0,
        **dict([b3_check(designs, launches)]),
        "plain version never ran on CUDA tensors": plain_calls == 0,
        f"one plan built per packed wave ({len(waves)})":
            plans == len(waves),
    }
    for what, ok in checks.items():
        log(f"[engine] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"engine phase failed: bad={bad} stats={st}")
    n_tok = sum(len(r.output_ids) for r in done.values())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in _torch_params(model))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms, attn_step_ms, attn_err, attn_tol = _decode_device_ms(
        eng, widths[-1])
    ok = attn_err <= attn_tol
    log(f"[engine] check: decode attention on the card == on the CPU "
        f"(err {attn_err:.3e}, limit {attn_tol:.3e}): "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("decode attention differs from its CPU version")
    rec = dict(config=label, layers=cfg.num_layers, tokens=n_tok,
               run_s=run_s, tokens_per_s=n_tok / run_s,
               steps=len(step_s), step_ms_mean=1e3 * run_s / len(step_s),
               step_ms_median=1e3 * statistics.median(step_s),
               step_ms_max=1e3 * max(step_s),
               ragged_waves_ms=[1e3 * w for w in waves],
               ragged_attention_ms=attn_ms, ragged_plan_ms=plan_ms,
               ragged_design_launches=designs, ragged_plan_builds=plans,
               decode_chunks_ms=[1e3 * s for s, _n, _w in chunks],
               decode_steps=decode_steps,
               # the chunks' wall time less the graphs' capture
               decode_ms_per_step=1e3 * (sum(s for s, _n, _w in chunks)
                                         - capture_s) / decode_steps,
               decode_graph_captures=graph_captures,
               decode_graph_replays=graph_replays,
               decode_graph_widths=widths, decode_capture_s=capture_s,
               # device time by replay: one graph step, and the
               # attention of one layer at the last width bucket
               decode_step_replay_ms=step_ms,
               decode_attention_replay_ms=attn_step_ms,
               decode_attention_err=attn_err,
               decode_attention_tol=attn_tol,
               decode_attention_share=cfg.num_layers * attn_step_ms
               / step_ms,
               # a floor for one batch decode step: every weight read once
               weight_read_ms=1e3 * weight_bytes / HBM_BYTES_PER_S,
               kernel_launches=launches,
               plain_calls=plain_calls, setup_s=setup_s,
               peak_mem_gb=peak_gb,
               stats={k: st[k] for k in (
                   "prefills", "preemptions", "decode_chunks",
                   "decode_tokens", "prefix_cache_hit_tokens",
                   "prefix_cache_miss_tokens", "ragged_launches")})
    if after is not None:
        rec.update(after(model, captured))
    if oracle is not None:
        rec.update(oracle(model, prompts, done))
    dname = str(eng.fam.dtype).removeprefix("torch.")
    rec["dtype"] = dname
    pools = str(eng.cache.key_caches[0].dtype).removeprefix("torch.")
    SERVED[label, dname, pools] = {i: r.output_ids for i, r in done.items()}
    if keep is not None:
        keep.update(model=model, cfg=cfg, prompts=prompts,
                    engine_kw=engine_kw, n_new=n_new)
    log(f"[engine] {label} {dname} {cfg.num_layers} layers: {n_tok} tokens "
        f"in {run_s:.3f} s = {rec['tokens_per_s']:.1f} tokens/s; "
        f"{len(step_s)} steps, step wall ms mean "
        f"{rec['step_ms_mean']:.2f} median {rec['step_ms_median']:.2f} "
        f"max {rec['step_ms_max']:.2f}; ragged waves ms "
        f"{[round(w, 2) for w in rec['ragged_waves_ms']]}, attention "
        f"kernel time within them {attn_ms:.2f} ms over {launches} "
        f"launches ({designs}) and {plan_ms:.2f} ms of {plans} plans; "
        f"decode {decode_steps} steps at {rec['decode_ms_per_step']:.2f} ms "
        f"each (weight read floor {rec['weight_read_ms']:.3f} ms; "
        f"{graph_captures} graphs captured at widths {widths} in "
        f"{capture_s:.3f} s, {graph_replays} replays; a step by replay "
        f"{step_ms:.3f} ms, of which attention {cfg.num_layers} x "
        f"{attn_step_ms:.4f} ms = {100 * rec['decode_attention_share']:.1f} "
        f"%); "
        f"peak mem {rec['peak_mem_gb']:.2f} GiB; "
        f"stats {rec['stats']}; card {card_line()}")
    del eng, model, captured
    torch.cuda.empty_cache()
    return rec


def _decode_device_ms(eng, width):
    """Device ms of one decode step by replaying the engine's captured
    graph at `width` (chunks of 16 steps from the step counter's 0, 5
    times, between CUDA events), and of one layer's
    `_pool_decode_attention` by graph_ms at that width (8 rows, each
    row's length in its last page; every layer's pool in turn, so each
    read finds its pool cold in L2 as a step does), and that
    attention's largest difference (the first layer's pool) from the
    same call on the CPU (the
    card's bf16 or f16 products into f32 against the CPU's widened
    operands) with its limit: a p rounded the other way moves an output
    by at most one ulp of p in the pool's dtype (eps: 2^-7 of it for
    bf16, 2^-10 for f16) times |v|, so eps max |v|, plus 1e-5 for the
    f32 sums' order. Measurement only: the engine has served its
    requests, and the replays rewrite the slots its last chunk
    wrote."""
    import torch
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    graph = eng._dec_graphs[width]
    n = eng.decode_chunk
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        eng._dec_step.zero_()
        for _ in range(n):
            graph.graph.replay()
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / (5 * n)
    cfg = eng.model.config
    B, bs = eng.max_batch, eng.block_size
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q = torch.randn((B, cfg.num_heads, eng.fam.head_dim), generator=g,
                    device="cuda").to(eng.fam.dtype)
    nb = eng.cache.allocator.num_blocks
    tbl = (torch.arange(B * width, device="cuda") % (nb - 1) + 1
           ).reshape(B, width)
    lens = torch.full((B,), width * bs - 1, device="cuda")
    kcs, vcs = eng.cache.key_caches, eng.cache.value_caches
    kc, vc = kcs[0], vcs[0]
    scale = 1.0 / eng.fam.head_dim ** 0.5
    dqs = [dict(kdq=None if eng._kdq is None else eng._kdq[li],
                vdq=None if eng._vdq is None else eng._vdq[li])
           for li in range(len(kcs))]
    attn_ms = graph_ms(lambda: [eng_mod._pool_decode_attention(
        q, k, v, tbl, lens, scale, bs, **dq)
        for k, v, dq in zip(kcs, vcs, dqs)], reps=2) / len(kcs)
    got = eng_mod._pool_decode_attention(q, kc, vc, tbl, lens, scale, bs,
                                         **dqs[0])
    want = eng_mod._pool_decode_attention(
        q.cpu(), kc.cpu(), vc.cpu(), tbl.cpu(), lens.cpu(), scale, bs,
        **{k: None if v is None else v.cpu() for k, v in dqs[0].items()})
    err = float((got.cpu() - want).abs().max())
    if vc.dtype == torch.int8:
        # an int8 pool is read in f32 on both sides: the sums' order
        # only (f32 scores of up to ~1e2 moved by ~1e-5 move each weight
        # by ~1e-5 relative), relative to the largest dequantized value
        tol = 1e-4 * float((vc.float() * dqs[0]["vdq"][None, :, None])
                           .abs().max()) + 1e-5
    else:
        tol = torch.finfo(vc.dtype).eps * float(vc.float().abs().max()) \
            + 1e-5
    return step_ms, attn_ms, err, tol


def engine_phase(keep=None) -> dict:
    """Phase 4: gpt3_1p3b served at full width and depth (`keep`: see
    serve_phase)."""
    def build():
        from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
        cfg = gpt3_1p3b()
        return GPTForCausalLM(cfg, dtype="bfloat16", seed=0), cfg

    return serve_phase("gpt3_1p3b", build, dict(
        max_batch=8, block_size=64, decode_chunk=16, prompt_quantum=128),
        keep=keep)


# ---------------------------------------------------------------------------
# phase 5: engine == dense generate (f32, TF32 off)
# ---------------------------------------------------------------------------
def parity_phase(label="gpt3_1p3b", build=None) -> dict:
    """Greedy tokens of LLMEngine against the port's dense `generate`, in
    f32 with TF32 off, under the logit-margin guard, on the 2-layer
    model `build()` returns (gpt3_1p3b's widths by default)."""
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if build is None:
        cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
        model = GPTForCausalLM(cfg, dtype="float32", seed=1)
    else:
        model, cfg = build()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(190, 211, 4)]
    n_new, margin = 16, 1e-3
    engine_kw = dict(max_batch=4, block_size=64, decode_chunk=16,
                     prompt_quantum=128)
    eng = LLMEngine(model, **engine_kw)
    rpa.reset_counters()
    cuda_graph.reset_counters()
    res = eng.generate(prompts, max_new_tokens=n_new)
    # f32: B3's simple design (the tiled one takes bf16 only)
    designs = dict(rpa.ragged_paged_attention.design_launches)
    replays = cuda_graph.replays["engine_decode"]
    # the same traffic with the engine's decode steps run eagerly on the
    # card: the graphs' tokens must be exactly these
    eager = LLMEngine(model, **engine_kw)
    eager._eager_decode = True
    eager_res = eager.generate(prompts, max_new_tokens=n_new)
    graph_vs_eager = [i for i, (a, b) in enumerate(zip(res, eager_res))
                      if not np.array_equal(a.output_ids, b.output_ids)]
    guarded, mismatched, dense_vs_eager = [], [], []
    with torch.no_grad():
        for i, (p, r) in enumerate(zip(prompts, res)):
            # dense generate's graphs (use_fused_step=True) against its
            # eager loop on the card: exactly the same tokens
            dense = generate(model, p[None], max_new_tokens=n_new)
            if not torch.equal(dense, generate(model, p[None],
                                               max_new_tokens=n_new,
                                               use_fused_step=False)):
                dense_vs_eager.append(i)
            dense = dense[0].cpu().numpy()
            lg = model(torch.as_tensor(dense[None].astype(np.int64),
                                       device="cuda"))[0]
            top2 = torch.topk(lg[len(p) - 1:-1].float(), 2, dim=-1).values
            low = np.flatnonzero(
                (top2[:, 0] - top2[:, 1]).cpu().numpy() < margin)
            n = int(low[0]) if len(low) else n_new
            guarded.append(n)
            if not np.array_equal(r.output_ids[:n], dense[len(p):][:n]):
                mismatched.append(i)
    dense_replays = {k: cuda_graph.replays[k]
                     for k in ("generate_prefill", "generate_decode")}
    log(f"[parity] {label}: engine vs dense generate (f32, 2 layers): tokens "
        f"compared per request {guarded} of {n_new} (margin guard "
        f"{margin}); mismatched requests {mismatched}; B3 launches by "
        f"design {designs}; engine decode graph replays {replays}, "
        f"requests whose graph tokens differ from the eager steps' "
        f"{graph_vs_eager}; dense generate graph replays "
        f"{dict(dense_replays)}, requests whose graph tokens differ from "
        f"its eager loop's {dense_vs_eager}")
    if mismatched or min(guarded) == 0 or designs["simple"] == 0:
        raise RuntimeError("engine tokens differ from dense generate, or "
                           "B3's simple design did not run")
    if graph_vs_eager or replays == 0:
        raise RuntimeError("the engine's decode graphs did not run, or "
                           "their tokens differ from the eager steps'")
    if dense_vs_eager or dense_replays["generate_decode"] != len(prompts) \
            * (n_new - 1):
        raise RuntimeError("dense generate's graphs did not run every "
                           "decode step, or their tokens differ from its "
                           "eager loop's")
    del eng, eager, model
    torch.cuda.empty_cache()
    return dict(config=label, guarded=guarded, n_new=n_new,
                b3_design_launches=designs, engine_graph_replays=replays,
                engine_graph_vs_eager_mismatched=graph_vs_eager,
                generate_graph_replays=dense_replays,
                generate_graph_vs_eager_mismatched=dense_vs_eager)


# ---------------------------------------------------------------------------
# phase 3: B1/B2 (flash attention) vs their plain versions
# ---------------------------------------------------------------------------
# name: (b, sq, sk, H, Hk, D, causal, segments, packed): packed = k and v
# are strided views of one [b, s, 3, H, D] projection, as
# fused_multi_head_attention hands them to B1
FLASH_CASES = [
    ("a gpt2_small train", (16, 1024, 1024, 12, 12, 64, True, False, False)),
    ("b gpt3_1p3b train", (4, 2048, 2048, 16, 16, 128, True, False, False)),
    ("c GQA H16/Hk4", (4, 1024, 1024, 16, 4, 128, True, False, False)),
    ("d segment ids", (4, 1024, 1024, 12, 12, 64, True, True, False)),
    ("e non-causal", (4, 1024, 1024, 12, 12, 64, False, False, False)),
    ("f cross sq<sk", (4, 512, 1024, 12, 12, 64, True, False, False)),
    ("f cross sq>sk", (4, 1024, 512, 12, 12, 64, True, False, False)),
    ("g head_dim 256", (2, 1024, 1024, 8, 8, 256, True, False, False)),
    ("h fused encoder, packed qkv",
     (16, 512, 512, 12, 12, 64, False, False, True)),
    # the training calls of phases 17 and 18: LLaMA-2-13B's widths (MHA,
    # 40 heads of 128, LLaMA-2's context), the GQA sub-run, bert_base
    ("i llama2_13b train", (2, 4096, 4096, 40, 40, 128, True, False, False)),
    ("j llama GQA 32/8 train",
     (2, 2048, 2048, 32, 8, 128, True, False, False)),
    ("k bert_base train", (32, 512, 512, 12, 12, 64, False, False, False)),
]
# kernel vs plain tolerances, element by element: |got - want| <= tol *
# (|want| + rms of want's row + rms of want), a row being the head_dim
# axis of one (batch, token, head), so a late query row, ~30x smaller
# than row 0 in a causal 1024-token case, is held to about its own size.
# The tensor's rms covers rows that are 0 only by cancellation (dq of
# the first causal row), where both sides hold f32 noise. bf16: both sides
# round p (and ds) to bf16 before the products, the kernel relative to
# its running row max and the plain version to the final one; each
# rounding is off by up to 2^-9 relative, which moves a row by ~2^-9 of
# its rms; both round their outputs to bf16 (ulp 2^-8..2^-7 relative):
# 2^-6 is 2-4 ulps. f16: the same roundings with 3 more mantissa bits
# (p off by up to 2^-12 relative, outputs' ulp 2^-11..2^-10 relative):
# 2^-9 is the same 2-4 ulps. f32: only the summation order differs
# (~1e-6 relative). lse is held at the f32 limit to 1 + |lse|.
FLASH_TOL = {"bf16": 2.0 ** -6, "f16": 2.0 ** -9, "f32": 1e-4}
# the cases phase 3 also times in f16: gpt2_small's and gpt3_1p3b's
# training shapes
FLASH_F16_TIMED = ("a gpt2_small train", "b gpt3_1p3b train")
# faults planted in each case's kernel outputs, which the check must
# reject: the second half of the query rows' o off by 5 %, and the last
# 64-key tile's dv zeroed
PLANTED = ("o late rows x1.05", "dv last k tile zeroed")


def _flash_inputs(spec, dtype, seed):
    import torch
    b, sq, sk, H, Hk, D, causal, seg, packed = spec
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    scale = torch.tensor(D ** -0.5, dtype=dtype, device="cuda")
    if packed:
        # k and v stay views of the projection (read in place, row stride
        # 3*H*D); q is pre-scaled into a tensor of its own, as _FlashCore
        # does
        q, k, v = rnd(b, sq, 3, H, D).unbind(2)
        qs, do = q * scale, rnd(b, sq, H, D)
        if k.is_contiguous() or v.is_contiguous():
            raise RuntimeError("packed case: k/v are not strided views")
    else:
        qs = rnd(b, sq, H, D) * scale
        k, v, do = rnd(b, sk, Hk, D), rnd(b, sk, Hk, D), rnd(b, sq, H, D)
    segs = None
    if seg:
        # three packed documents per row and tail padding (-1 on both
        # sides); in row 0 the last 64 queries carry an id no key has,
        # so their rows are fully masked
        qseg = torch.full((b, sq), -1, dtype=torch.int32, device="cuda")
        kseg = torch.full((b, sk), -1, dtype=torch.int32, device="cuda")
        for r in range(b):
            cuts = [0, 300 + 17 * r, 620 + 9 * r, sq - 96, sq]
            for i in range(3):
                qseg[r, cuts[i]:cuts[i + 1]] = i
                kseg[r, cuts[i]:cuts[i + 1]] = i
        qseg[0, sq - 64:] = 9
        segs = (qseg, kseg)
    return qs, k, v, do, segs


def _valid_pairs(spec, segs):
    """(q head, q, k) pairs the mask leaves valid, counted from the data."""
    import torch
    b, sq, sk, H, Hk, D, causal, _seg, _packed = spec
    ok = torch.ones((1, sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        ok = (torch.arange(sq, device="cuda")[:, None] + (sk - sq)
              >= torch.arange(sk, device="cuda")[None, :])[None]
    if segs is not None:
        ok = ok & (segs[0][:, :, None] == segs[1][:, None, :])
        return int(ok.sum()) * H
    return int(ok.sum()) * b * H


def _flash_bound(spec, pairs, itemsize, bwd):
    """(bound_ms, bound_by, bytes, flops): 4*D flops per valid pair
    forward, 10*D backward (s recomputed, dv, dp, dk, dq); bytes are q, k,
    v, o (+ do, dq, dk, dv backward) and lse (+ delta), each once."""
    b, sq, sk, H, Hk, D, _causal, _seg, _packed = spec
    qo = b * sq * H * D * itemsize
    kv = b * sk * Hk * D * itemsize
    stats = b * H * sq * 4
    if bwd:
        nbytes, flops = 4 * qo + 4 * kv + 2 * stats, 10 * D * pairs
    else:
        nbytes, flops = 2 * qo + 2 * kv + stats, 4 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


def _norm_err(got, want, rows=True):
    """The largest |got - want| / (|want| + rms of want's row + rms of
    want) over the elements, rows along the last axis (rows=False:
    |want| + 1); where `want` is all 0, any difference counts inf."""
    import torch
    got, want = got.float(), want.float()
    d = (got - want).abs()
    base = (want.pow(2).mean(-1, keepdim=True).sqrt()
            + want.pow(2).mean().sqrt()) if rows else 1.0
    scale = base + want.abs()
    r = torch.where(scale > 0, d / scale,
                    torch.where(d > 0, float("inf"), 0.0))
    return float(r.max())


def _check_flash(name, dt, got, want):
    """({tensor: max abs error}, {tensor: normalised error}, {planted
    fault: normalised error}) of the kernels' (o, lse, dq, dk, dv), or of
    B1's (o, lse) alone, against the plain versions'; raises unless every
    tensor is within FLASH_TOL and every planted fault beyond it."""
    abs_errs, errs = {}, {}
    for what, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        if not torch_isfinite(g):
            raise RuntimeError(f"flash case {name!r} {dt}: {what} not finite")
        if what == "lse":
            # rows both sides mask fully (lse -1e30) compare exactly
            dead = w < -1e29
            if not bool((g[dead] == w[dead]).all()):
                raise RuntimeError(f"flash case {name!r}: masked rows' lse")
            g, w = g[~dead], w[~dead]
            err, tol = _norm_err(g, w, rows=False), FLASH_TOL["f32"]
        else:
            err, tol = _norm_err(g, w), FLASH_TOL[dt]
        if err > tol:
            raise RuntimeError(
                f"flash case {name!r} {dt}: {what} normalised err {err} > "
                f"{tol}")
        abs_errs[what] = float((g.float() - w.float()).abs().max())
        errs[what] = err
    o = got[0].clone()
    o[:, o.shape[1] // 2:] *= 1.05
    planted = {PLANTED[0]: _norm_err(o, want[0])}
    if len(got) == 5:           # B2's outputs too
        dv = got[4].clone()
        dv[:, -64:] = 0
        planted[PLANTED[1]] = _norm_err(dv, want[4])
    for what, e in planted.items():
        if e <= FLASH_TOL[dt]:
            raise RuntimeError(f"flash case {name!r} {dt}: the check passes "
                               f"a planted fault ({what}: {e})")
    return abs_errs, errs, planted


def torch_isfinite(t):
    import torch
    return bool(torch.isfinite(t).all()) if t.dtype.is_floating_point \
        else True


def _sdpa_fwd(qs, k, v, causal, grad):
    """SDPA's forward on [b, H, s, D] copies of the operands (a yardstick
    only: torch aligns is_causal top-left, so only sq == sk compares).
    `grad`: the inputs require grad, as in training, so the forward also
    keeps what its backward needs."""
    import torch.nn.functional as tF
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(grad)
                  for t in (qs, k, v))
    gqa = lk.shape[1] != lq.shape[1]
    return (lambda: tF.scaled_dot_product_attention(
        lq, lk, lv, is_causal=causal, scale=1.0, enable_gqa=gqa)), (lq, lk,
                                                                   lv)


def b1_times(spec, qs, k, v, segs, simple=True) -> dict:
    """Device times (ms) of B1 at one bf16 (or f16) case: the design the
    main path
    takes, by single-call CUDA events (`fwd_ms`, host path included) and
    by CUDA-graph replay (`fwd_ms_graph`, device only); the simple
    kernel the same way where the design is not the simple one (and
    `simple`); SDPA's forward the same way where sq == sk and no
    segments (else None)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, sq, sk, H, Hk, D, causal, seg, _packed = spec
    design = fa._fwd_design(qs.dtype, D)
    run = lambda **kw: fa._fwd_cuda(qs, k, v, causal, segs, **kw)
    rec = dict(fwd_design=design, fwd_ms=cuda_ms(run),
               fwd_ms_graph=graph_ms(run), simple_fwd_ms=None,
               simple_fwd_ms_graph=None, library_fwd_ms=None,
               library_fwd_ms_graph=None)
    if simple and design != "simple":
        simple_run = lambda: run(design="simple")
        rec["simple_fwd_ms"] = cuda_ms(simple_run)
        rec["simple_fwd_ms_graph"] = graph_ms(simple_run)
    if sq == sk and not seg:
        lib, _ = _sdpa_fwd(qs, k, v, causal, grad=True)
        rec["library_fwd_ms"] = cuda_ms(lib)
        lib, _ = _sdpa_fwd(qs, k, v, causal, grad=False)
        with torch.no_grad():
            rec["library_fwd_ms_graph"] = graph_ms(lib)
    return rec


def b2_times(spec, qs, k, v, o, lse, do, segs, simple=True) -> dict:
    """Device times (ms) of B2 at one bf16 (or f16) case, as b1_times
    times B1:
    the design the main path takes by single-call events (`bwd_ms`) and
    by CUDA-graph replay (`bwd_ms_graph`); the simple kernel both ways
    where the design is not the simple one (and `simple`); where sq ==
    sk and no segments, SDPA's forward + backward by events
    (`library_fwd_bwd_ms`) and its backward alone by replay
    (`library_bwd_ms_graph`: the captured forward + backward less the
    captured forward, both with inputs that require grad), else None."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, sq, sk, H, Hk, D, causal, seg, _packed = spec
    sc = D ** -0.5
    design = fa._bwd_design(qs.dtype, D)
    run = lambda **kw: fa._bwd_cuda(qs, k, v, o, lse, do, causal, segs, sc,
                                    **kw)
    rec = dict(bwd_design=design, bwd_ms=cuda_ms(run),
               bwd_ms_graph=graph_ms(run), simple_bwd_ms=None,
               simple_bwd_ms_graph=None, library_fwd_bwd_ms=None,
               library_bwd_ms_graph=None)
    if simple and design != "simple":
        simple_run = lambda: run(design="simple")
        rec["simple_bwd_ms"] = cuda_ms(simple_run)
        rec["simple_bwd_ms_graph"] = graph_ms(simple_run)
    if sq == sk and not seg:
        lib, lqkv = _sdpa_fwd(qs, k, v, causal, grad=True)
        ldo = do.transpose(1, 2).contiguous()
        fwd_bwd = lambda: torch.autograd.grad(lib(), lqkv, ldo)
        rec["library_fwd_bwd_ms"] = cuda_ms(fwd_bwd)
        rec["library_bwd_ms_graph"] = graph_ms(fwd_bwd) - graph_ms(lib)
    return rec


def flash_phase() -> list:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    out = []
    for i, (name, spec) in enumerate(FLASH_CASES):
        b, sq, sk, H, Hk, D, causal, seg, packed = spec
        if fa.attention_path((b, sq, H, D), (b, sk, Hk, D)) != ("cuda", ""):
            raise RuntimeError(f"flash case {name!r} would not take the "
                               "kernels")
        rec = dict(case=name, b=b, sq=sq, sk=sk, H=H, Hk=Hk, D=D,
                   causal=causal, segments=seg, packed_qkv=packed)
        for dt, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16),
                          ("f32", torch.float32)):
            qs, k, v, do, segs = _flash_inputs(spec, dtype, seed=i)
            sc = D ** -0.5
            n0 = dict(fa.flash_fwd.design_launches)
            o, lse = fa.flash_fwd(qs, k, v, causal, segs, path="cuda")
            rec[f"fwd_design_launches_{dt}"] = {
                d: n - n0[d] for d, n in fa.flash_fwd.design_launches.items()}
            n0 = dict(fa.flash_bwd.design_launches)
            dq, dk, dv = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal,
                                      segs, path="cuda")
            torch.cuda.synchronize()
            got = {d: n - n0[d]
                   for d, n in fa.flash_bwd.design_launches.items()}
            rec[f"bwd_design_launches_{dt}"] = got
            # bf16 and f16 at head_dim 64/128 run the sm90 design, the
            # rest the simple one
            want = "sm90" if dt in ("bf16", "f16") and D in fa._SM90_D \
                else "simple"
            if got != {d: int(d == want) for d in got}:
                raise RuntimeError(f"flash case {name!r} {dt}: B2 ran "
                                   f"{got}, expected one {want} launch")
            wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
            # B2 from the same (o, lse) on both sides
            wdq, wdk, wdv = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal,
                                         segs, path="torch")
            abs_errs, errs, planted = _check_flash(
                name, dt, (o, lse, dq, dk, dv), (wo, wlse, wdq, wdk, wdv))
            rec[f"max_abs_err_{dt}"] = abs_errs
            rec[f"norm_err_{dt}"] = errs
            rec[f"planted_norm_err_{dt}"] = planted
            del wo, wlse, wdq, wdk, wdv
            if dt == "bf16" or (dt == "f16" and name in FLASH_F16_TIMED):
                # bf16's times and bounds in the case's record, f16's in
                # its "f16" entry
                t = rec if dt == "bf16" else rec.setdefault("f16", {})
                pairs = _valid_pairs(spec, segs)
                rec["valid_pairs"] = pairs
                t.update(b1_times(spec, qs, k, v, segs))
                t.update(b2_times(spec, qs, k, v, o, lse, do, segs))
                t["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_fwd(
                    qs, k, v, causal, segs, path="torch"), iters=5)
                t["plain_bwd_ms"] = cuda_ms(lambda: fa.flash_bwd(
                    qs, k, v, o, lse, do, sc, causal, segs, path="torch"),
                    iters=5)
                for kind in ("fwd", "bwd"):
                    bms, by, nb, fl = _flash_bound(spec, pairs, 2,
                                                   kind == "bwd")
                    t[f"{kind}_bound_ms"], t[f"{kind}_bound_by"] = bms, by
                    t[f"{kind}_bytes"], t[f"{kind}_flops"] = nb, fl
            del qs, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()
        fmt = lambda d: {k: f"{e:.2e}" for k, e in d.items()}
        log(f"[flash] {name}: b={b} sq={sq} sk={sk} H={H}/{Hk} D={D} "
            f"causal={causal} seg={seg}; normalised err bf16 "
            f"{fmt(rec['norm_err_bf16'])} (tol {FLASH_TOL['bf16']:.2e}; "
            f"planted {fmt(rec['planted_norm_err_bf16'])}) f16 "
            f"{fmt(rec['norm_err_f16'])} (tol {FLASH_TOL['f16']:.2e}; "
            f"planted {fmt(rec['planted_norm_err_f16'])}) f32 "
            f"{fmt(rec['norm_err_f32'])} (tol {FLASH_TOL['f32']:.0e}; "
            f"planted {fmt(rec['planted_norm_err_f32'])}); max abs err bf16 "
            f"{fmt(rec['max_abs_err_bf16'])} f16 "
            f"{fmt(rec['max_abs_err_f16'])}; launches by design: B1 bf16 "
            f"{rec['fwd_design_launches_bf16']} f16 "
            f"{rec['fwd_design_launches_f16']} f32 "
            f"{rec['fwd_design_launches_f32']}, B2 bf16 "
            f"{rec['bwd_design_launches_bf16']} f16 "
            f"{rec['bwd_design_launches_f16']} f32 "
            f"{rec['bwd_design_launches_f32']}")
        log(f"[flash] {name}: B1 bf16 ({rec['fwd_design']}) "
            f"{rec['fwd_ms']:.4f} ms by events, {rec['fwd_ms_graph']:.4f} "
            f"by graph replay (bound {rec['fwd_bound_ms']:.4f}, "
            f"{rec['fwd_bound_by']}; simple {rec['simple_fwd_ms']} / "
            f"{rec['simple_fwd_ms_graph']}; library {rec['library_fwd_ms']}"
            f" / {rec['library_fwd_ms_graph']}; plain "
            f"{rec['plain_fwd_ms']:.3f}); "
            f"B2 bf16 ({rec['bwd_design']}) {rec['bwd_ms']:.4f} ms by "
            f"events, {rec['bwd_ms_graph']:.4f} by graph replay (bound "
            f"{rec['bwd_bound_ms']:.4f}, {rec['bwd_bound_by']}; simple "
            f"{rec['simple_bwd_ms']} / {rec['simple_bwd_ms_graph']}; "
            f"library fwd+bwd {rec['library_fwd_bwd_ms']} by events, bwd "
            f"{rec['library_bwd_ms_graph']} by replay; plain "
            f"{rec['plain_bwd_ms']:.3f})")
        if "f16" in rec:
            t = rec["f16"]
            log(f"[flash] {name}: f16 B1 ({t['fwd_design']}) "
                f"{t['fwd_ms']:.4f} ms by events, {t['fwd_ms_graph']:.4f} "
                f"by graph replay (simple {t['simple_fwd_ms']} / "
                f"{t['simple_fwd_ms_graph']}; library "
                f"{t['library_fwd_ms']} / {t['library_fwd_ms_graph']}; "
                f"plain {t['plain_fwd_ms']:.3f}); B2 ({t['bwd_design']}) "
                f"{t['bwd_ms']:.4f} ms by events, {t['bwd_ms_graph']:.4f} "
                f"by graph replay (simple {t['simple_bwd_ms']} / "
                f"{t['simple_bwd_ms_graph']}; library fwd+bwd "
                f"{t['library_fwd_bwd_ms']}, bwd "
                f"{t['library_bwd_ms_graph']} by replay; plain "
                f"{t['plain_bwd_ms']:.3f}); bounds as bf16's")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 6: gpt2_small trained by TrainStep at full width and depth
# ---------------------------------------------------------------------------
def _gpt_train_step(cfg, use_amp, lr=1e-4, seed=0, moment_dtype=None,
                    amp_dtype="bfloat16"):
    """bench.py::bench_gpt's step: an f32 GPTForCausalLM, AdamW(lr,
    weight decay 0.01, moments in `moment_dtype`), O1 auto_cast in
    `amp_dtype` around the forward when `use_amp`,
    GPTPretrainingCriterion."""
    from paddle_tpu_torch import TrainStep, amp
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, dtype="float32", seed=seed)
    model.train()
    opt = AdamW(learning_rate=lr, parameters=_torch_params(model),
                weight_decay=0.01, moment_dtype=moment_dtype)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids, labels):
        with amp.auto_cast(enable=use_amp, level="O1", dtype=amp_dtype):
            logits = m(ids)
        return crit(logits, labels)

    return model, TrainStep(model, opt, loss_fn)


def _replay_ms(graph, iters=5):
    """Median device time of one replay of `graph` (CUDA events)."""
    import torch
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _counted_steps(step, batch, n_calls) -> dict:
    """`n_calls` TrainStep calls on the arrays `batch`, each synchronised
    and timed by wall, with the counters of B1, B2, the update kernel and
    the graphs set to 0 just before and read just after. The first call
    runs the step eagerly and captures it; every later call replays the
    graph, which runs the captured launches again without calling the
    wrappers: a counter counts a launch of the eager step and one of the
    capture, and the card runs the captured launches once a replay. The
    counters read around each capture split the two, so the launches on
    the card are the eager step's plus the captured step's times the
    replays. Launch tuples are (B1, B2, update). torch's AccumulateGrad
    stream-mismatch warnings are counted (stream_mismatch_warnings)."""
    import torch
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta

    def read():
        return (fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches,
                mta.multi_tensor_adam.kernel_launches)

    with stream_mismatch_warnings() as warned, \
            capture_counts(read) as spans:
        fa.reset_counters()
        mta.multi_tensor_adam.kernel_launches = 0
        mta.multi_tensor_adam.plain_calls = 0
        cuda_graph.reset_counters()
        losses, step_s = [], []
        for _ in range(n_calls):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(*batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(loss)
        counted = read()
        run = dict(
            designs=dict(fa.flash_fwd.design_launches),
            bwd_designs=dict(fa.flash_bwd.design_launches),
            plain=(fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls),
            update_plain=mta.multi_tensor_adam.plain_calls,
            captures=dict(cuda_graph.captures),
            replays=dict(cuda_graph.replays),
            capture_s=cuda_graph.capture_seconds["train_step"])
    in_graph = tuple(sum(b[i] - a[i] for a, b in spans) for i in range(3))
    eager = tuple(c - g for c, g in zip(counted, in_graph))
    n_replays = run["replays"].get("train_step", 0)
    run.update(
        counted=counted, in_graph=in_graph, eager=eager,
        on_device=tuple(e + g * n_replays for e, g in zip(eager, in_graph)),
        distinct=len({x.data_ptr() for x in losses}) == len(losses),
        losses=[float(x) for x in losses], step_s=step_s,
        stream_warnings=len(warned))
    return run


def train_phase(keep=None) -> dict:
    """Phase 6 (`keep`, a dict, receives the model, the TrainStep and
    its batch for phase 33b instead of their being freed)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models import gpt2_small, num_params
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     use_flash_attention=True)
    batch, seq, warmup, steps = 16, 1024, 2, 10
    path = fa.attention_path((batch, seq, cfg.num_heads, cfg.head_dim),
                             (batch, seq, cfg.num_heads, cfg.head_dim))
    if path != ("cuda", ""):
        raise RuntimeError(f"gpt2_small attention would not take the "
                           f"kernels: {path}")
    t0 = time.perf_counter()
    model, step = _gpt_train_step(cfg, use_amp=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    run = _counted_steps(step, (ids, labels), warmup + steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counted, in_graph, eager, on_device = (
        run[k] for k in ("counted", "in_graph", "eager", "on_device"))
    designs, bwd_designs = run["designs"], run["bwd_designs"]
    plain, update_plain = run["plain"], run["update_plain"]
    captures, replays = run["captures"], run["replays"]
    capture_s, losses, step_s = run["capture_s"], run["losses"], run["step_s"]
    n_replays = replays.get("train_step", 0)
    timed_s = step_s[warmup:]
    n_steps = warmup + steps
    L = cfg.num_layers
    checks = {
        "every loss finite": all(np.isfinite(losses)),
        "every returned loss a tensor of its own": run["distinct"],
        "one graph captured, every later step a replay": (
            captures, replays) == ({"train_step": 1},
                                   {"train_step": n_steps - 1}),
        "B1 and B2 at 12 launches in the captured step and 12 in the "
        "eager one": in_graph[:2] == eager[:2] == (L, L),
        "every B1 launch ran the sm90 design": designs == {
            "sm90": 2 * L, "simple": 0},
        "every B2 launch ran the sm90 design": bwd_designs == {
            "sm90": 2 * L, "simple": 0},
        "plain versions never ran on CUDA tensors": plain == (0, 0),
        "attention_path names the kernels": path == ("cuda", ""),
        "the update kernel at one launch in the captured step and one "
        "in the eager one": (in_graph[2], eager[2]) == (1, 1),
        "no plain update call": update_plain == 0,
        "no AccumulateGrad stream-mismatch warning":
            run["stream_warnings"] == 0,
    }
    for what, ok in checks.items():
        log(f"[train] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"training phase failed: {run}")
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    # the update alone, by replay, on the model's own tensors and state
    # (a gradient from a seed; measurement after the run)
    opt = step.optimizer
    gen = torch.Generator(device="cuda").manual_seed(0)
    slots = [mta.AdamSlot(p.detach(), torch.randn(
        p.shape, device="cuda", generator=gen) * 1e-3,
        *(opt._get_state(p)[k] for k in ("moment1", "moment2",
                                          "beta1_pow", "beta2_pow")),
        wd=0.01) for p in _torch_params(model)]
    lr_t = opt._lr_tensor(opt.get_lr(), torch.device("cuda"))
    update_ms = graph_ms(lambda: mta.multi_tensor_adam(
        slots, lr_t, beta1=opt.beta1, beta2=opt.beta2, eps=opt.epsilon,
        decoupled=True), reps=5, iters=10)
    update_bound = _update_bound(slots)
    del slots
    # B1/B2 device time by events in an eager step (a replay calls no
    # wrapper), outside the counted run: the second of two, since the
    # first allocates its activations anew (the graph's pool holds the
    # earlier ones) and the host then stretches its kernels
    step._eager = True
    step(ids, labels)
    with kernel_events(fwd=(fa, "_fwd_cuda"), bwd=(fa, "_bwd_cuda")) \
            as events:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        eager_step_ms = 1e3 * (time.perf_counter() - t)
    step._eager = False
    per_step = {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in events.items()}
    n = num_params(cfg)
    tok_s = batch * seq * steps / sum(timed_s)
    med = statistics.median(timed_s)
    rec = dict(config="gpt2_small", layers=L, batch=batch, seq=seq,
               stream_warnings=run["stream_warnings"],
               params=n, warmup_steps=warmup, timed_steps=steps,
               tokens_per_s=tok_s, step_ms_median=1e3 * med,
               step_ms=[1e3 * x for x in timed_s],
               first_step_ms=1e3 * step_s[0], captures=captures,
               capture_s=capture_s, replays=replays,
               step_ms_replay=replay_ms,
               idle_share=1 - replay_ms / (1e3 * med),
               mfu=6.0 * n * tok_s / BF16_FLOPS_PER_S,
               step_floor_ms=6.0 * n * batch * seq / BF16_FLOPS_PER_S * 1e3,
               eager_step_ms=eager_step_ms,
               b1_ms_per_step=per_step["fwd"],
               b2_ms_per_step=per_step["bwd"],
               b1_launches=counted[0], b2_launches=counted[1],
               b1_design_launches=designs, b2_design_launches=bwd_designs,
               launches_in_graph=list(in_graph),
               launches_eager=list(eager),
               b1_launches_on_device=on_device[0],
               b2_launches_on_device=on_device[1],
               plain_calls=list(plain), update_launches=counted[2],
               update_launches_on_device=on_device[2],
               update_plain_calls=update_plain, update_ms_graph=update_ms,
               update_bound_ms=update_bound[0],
               update_bound_by=update_bound[1], losses=losses,
               setup_s=setup_s, peak_mem_gb=peak)
    log(f"[train] gpt2_small bf16 O1 AdamW, {L} layers, batch {batch} x "
        f"seq {seq}: {tok_s:.1f} tokens/s, step median {1e3 * med:.2f} ms "
        f"by wall, {replay_ms:.2f} ms by replay of the step graph (device "
        f"idle {100 * rec['idle_share']:.1f} %; 6ND floor "
        f"{rec['step_floor_ms']:.2f} ms), MFU {rec['mfu']:.4f}; first "
        f"call (eager step + capture) {rec['first_step_ms']:.1f} ms, "
        f"captures {captures} in {capture_s:.3f} s, replays {replays}; "
        f"update {update_ms:.4f} ms by replay (bound {update_bound[0]:.4f}"
        f" ms, {update_bound[1]}); a second eager step after the run "
        f"{eager_step_ms:.2f} ms by wall, B1 {per_step['fwd']:.3f} ms + "
        f"B2 {per_step['bwd']:.3f} ms of device time in it; launches "
        f"(B1, B2, update) counted {counted}: eager {eager}, captured "
        f"step {in_graph}, on the card {on_device} over {n_replays} "
        f"replays; peak mem {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}")
    if keep is not None:
        keep.update(model=model, step=step, ids=ids, labels=labels)
    del model, step
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 7: TrainStep with the kernels == TrainStep with the composite
# ---------------------------------------------------------------------------
def _params_diff(pa, pb, lr):
    """(largest |a - b|, elements beyond 1e-3 * lr, elements) of two
    sequences of parameter tensors in one order."""
    if len(pa) != len(pb):
        raise ValueError(f"{len(pa)} tensors against {len(pb)}")
    err = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    far = sum(int(((a - b).abs() > 1e-3 * lr).sum()) for a, b in zip(pa, pb))
    return err, far, sum(a.numel() for a in pa)


def _held_to(losses, want_losses, params, want_params, lr, n_steps):
    """Phase 7's rule, which every comparison of two training runs
    uses: losses within 1e-5 relative, no parameter element beyond
    2 * lr * steps apart, and fewer than 2e-3 of the elements beyond
    1e-3 * lr. A sign flip of a near-zero gradient moves an Adam
    parameter by up to ~2 lr a step, so one element may reach the
    bound, but such flips are rare (the key bias, whose gradient is
    zero up to rounding); a wrong dq, dk or dv moves every parameter it
    reaches by ~lr. `params`, `want_params`: the runs' parameters (state
    dict values) in one order. Returns the comparison's record, `ok`
    whether it holds."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    err, far, n = _params_diff(params, want_params, lr)
    bound = 2 * lr * n_steps
    return dict(loss_max_rel_diff=loss_err, param_max_abs_diff=err,
                params_far=far, params_total=n, param_bound=bound,
                ok=loss_err <= 1e-5 and err <= bound and far / n < 2e-3)


def _state(model):
    """A copy of the model's state dict values, in their order."""
    return [v.detach().clone() for v in _torch_state(model).values()]


def train_parity_phase() -> dict:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn import functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, n_steps = 1e-4, 3
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50304, (2, 512)).astype(np.int32)
    labels = rng.integers(0, 50304, (2, 512)).astype(np.int32)
    runs = {}
    sdpa_takes_kernel = F._sdpa_takes_kernel
    # (flash kernels, through the step graph): the kernels and the
    # composite through the graph, and the kernels in eager steps
    for flash, graphed in ((True, True), (False, True), (True, False)):
        cfg = dataclasses.replace(
            gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                       use_flash_attention=flash), num_layers=2)
        model, step = _gpt_train_step(cfg, use_amp=False, lr=lr, seed=1)
        step._eager = not graphed
        n0 = fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches
        if not flash:
            # the composite, forced plain: SDPA would route this call into
            # the kernels on the card
            F._sdpa_takes_kernel = lambda *a: False
        try:
            losses = [float(step(ids, labels)) for _ in range(n_steps)]
        finally:
            F._sdpa_takes_kernel = sdpa_takes_kernel
        n1 = fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches
        # a graph counts the eager first step's launches and the
        # captured step's; eager steps count each of theirs
        want = cfg.num_layers * (2 if graphed else n_steps) if flash else 0
        if (n1[0] - n0[0], n1[1] - n0[1]) != (want, want):
            raise RuntimeError(f"parity run flash={flash} graphed={graphed}:"
                               f" kernel launches {n1} from {n0}, expected "
                               f"+{want}")
        runs[flash, graphed] = (losses, _state(model))
        del model, step
    # phase 7's rule (_held_to). f32 on both sides (kernels in full f32,
    # cuBLAS without TF32): only summation order differs, ~1e-6 relative
    # on the loss
    out = {}
    for what, other in (("composite", (False, True)),
                        ("eager", (True, False))):
        (lk, pk), (lc, pc) = runs[True, True], runs[other]
        cmp = _held_to(lk, lc, pk, pc, lr, n_steps)
        far, n = cmp["params_far"], cmp["params_total"]
        log(f"[train-parity] f32, 2 layers, batch 2 x seq 512, {n_steps} "
            f"steps, kernels through the step graph vs {what}: losses "
            f"{[round(x, 6) for x in lk]} vs {[round(x, 6) for x in lc]} "
            f"(max rel diff {cmp['loss_max_rel_diff']:.2e}, tol 1e-5); "
            f"params max abs diff {cmp['param_max_abs_diff']:.2e} (bound "
            f"2*lr*steps = {cmp['param_bound']:.1e}), {far} of {n} "
            f"elements differ by more than 1e-3*lr (share {far / n:.2e}, "
            f"tol 2e-3): {'ok' if cmp['ok'] else 'FAILED'}")
        if not cmp["ok"]:
            raise RuntimeError(f"TrainStep with the kernels through the "
                               f"graph differs from the {what} run")
        out[what] = dict(losses=lc, **{k: cmp[k] for k in (
            "loss_max_rel_diff", "param_max_abs_diff", "params_far")})
    torch.cuda.empty_cache()
    return dict(losses_kernels_graph=runs[True, True][0],
                param_bound=cmp["param_bound"], params_total=n, **out)


# ---------------------------------------------------------------------------
# phase 8: B4 (layer norm) and B5 (RMS norm) vs their plain versions
# ---------------------------------------------------------------------------
# (name, rows, width): the main paths' shapes and two edge cases
NORM_CASES = [
    ("llama2_7b prefill", 8192, 4096),
    ("llama decode", 8, 4096),
    ("bert_base", 8192, 768),
    ("gpt3_1p3b", 8192, 2048),
    # rows not 16-byte aligned: the scalar path, 8 warps a row
    ("odd rows, width not a multiple of 8", 7, 1001),
    ("wide row", 64, 16384),
]
# kernel vs plain, element by element: |got - want| <= tol * (|want| +
# floor * rms of want's row). Both compute the same f32 value (sums in
# other orders, rsqrtf within 2 ulps) and round it once: one ulp of the
# output dtype apart (bf16 <= 2^-7 relative), or, for a value near 0
# after centring, f32 noise of the row's size.
NORM_TOL = {"bf16": (2.0 ** -7, 2.0 ** -8), "f32": (1e-5, 1.0)}
# fused_rms_norm (the kernel form: weight in f32, one cast) against
# LLaMA's RMSNorm (the reference's plain op: cast, then the weight in
# bf16): the known split of the reference, two bf16 roundings apart
SPLIT_TOL = (2.0 ** -6, 2.0 ** -8)
NORM_PLANTED = ("late row x(1+2^-5)", "last column's weight dropped")


def _lim_err(got, want, tol):
    """The largest |got - want| / (tol[0] * (|want| + tol[1] * rms of
    want's row)) over the elements: above 1 fails."""
    import torch
    got, want = got.float(), want.float()
    row = want.pow(2).mean(-1, keepdim=True).sqrt()
    lim = tol[0] * (want.abs() + tol[1] * row)
    d = (got - want).abs()
    return float(torch.where(lim > 0, d / lim,
                             torch.where(d > 0, float("inf"), 0.0)).max())


def _norm_bound(kind, n, h, itemsize, affine):
    """(bound_ms, bound_by, bytes, flops): x read and out written once,
    w (and b) read once; f32 flops per element (layer norm: sum, centre,
    square-add, centre, scale = 6; RMS: square-add, scale = 3; +1 for
    each affine term) over the card's f32 rate outside the tensor cores."""
    terms = (2 if kind == "layer_norm" else 1) if affine else 0
    nbytes = 2 * n * h * itemsize + terms * h * itemsize
    flops = n * h * ((6 if kind == "layer_norm" else 3) + terms)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


def norm_phase() -> list:
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import norms
    out = []
    for ci, (name, n, h) in enumerate(NORM_CASES):
        for kind in ("layer_norm", "rms_norm"):
            fwd = norms.layer_norm_fwd if kind == "layer_norm" \
                else norms.rms_norm_fwd
            eps = 1e-5 if kind == "layer_norm" else 1e-6
            for dt, dtype in (("bf16", torch.bfloat16),
                              ("f32", torch.float32)):
                g = torch.Generator(device="cuda")
                g.manual_seed(ci)
                x = (torch.randn((n, h), generator=g, device="cuda") * 2
                     + 1).to(dtype)
                w = torch.rand((h,), generator=g, device="cuda") + 0.5
                w[-1] = 0.6          # away from 1: dropping it is a fault
                w = w.to(dtype)
                b = torch.randn((h,), generator=g, device="cuda").to(dtype)
                for affine in (True, False):
                    wa = w if affine else None
                    ba = b if affine and kind == "layer_norm" else None
                    args = (x, wa, ba) if kind == "layer_norm" else (x, wa)

                    def kern():
                        return fwd(*args, eps, path="cuda")

                    def plain():
                        return fwd(*args, eps, path="torch")

                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    if not torch.isfinite(got).all() or \
                            got.dtype != dtype or got.shape != x.shape:
                        raise RuntimeError(f"norm case {name!r} {kind} {dt}"
                                           ": non-finite or wrong shape")
                    err = _lim_err(got, want, NORM_TOL[dt])
                    if err > 1.0:
                        raise RuntimeError(
                            f"norm case {name!r} {kind} {dt} affine="
                            f"{affine}: normalised err {err} > 1")
                    planted = {}
                    if affine:
                        late = got.clone()
                        r = n - 1 - n // 4
                        late[r] = (late[r].float() * (1 + 2 ** -5)).to(dtype)
                        # a copy: float() of an f32 tensor is the tensor
                        no_w = got.float().clone()
                        shift = b[-1].float() if ba is not None else 0.0
                        no_w[:, -1] = (no_w[:, -1] - shift) / w[-1].float() \
                            + shift
                        planted = dict(zip(NORM_PLANTED, (
                            _lim_err(late, want, NORM_TOL[dt]),
                            _lim_err(no_w.to(dtype), want, NORM_TOL[dt]))))
                        for what, e in planted.items():
                            if e <= 1.0:
                                raise RuntimeError(
                                    f"norm case {name!r} {kind} {dt}: the "
                                    f"check passes a planted fault ({what}:"
                                    f" {e})")
                    if kind == "layer_norm":
                        lib = lambda: tF.layer_norm(x, (h,), wa, ba, eps)
                    else:
                        lib = lambda: tF.rms_norm(x, (h,), wa, eps)
                    bms, by, nb, fl = _norm_bound(kind, n, h,
                                                  x.element_size(), affine)
                    rec = dict(case=name, kind=kind, n=n, h=h, dtype=dt,
                               affine=affine, norm_err=err,
                               max_abs_err=float((got.float() - want.float())
                                                 .abs().max()),
                               planted_norm_err=planted, ms=graph_ms(kern),
                               plain_ms=graph_ms(plain),
                               library_ms=graph_ms(lib),
                               call_ms=cuda_ms(kern), bound_ms=bms,
                               bound_by=by, bytes=nb, flops=fl)
                    out.append(rec)
                    log(f"[norms] {kind} {name} [{n}, {h}] {dt} affine="
                        f"{affine}: normalised err {err:.3f} (planted "
                        f"{ {k: round(v, 2) for k, v in planted.items()} }) "
                        f"max abs err {rec['max_abs_err']:.2e}; kernel "
                        f"{rec['ms']:.4f} ms (bound {bms:.4f}, {by}; one "
                        f"call with its host path {rec['call_ms']:.4f}); "
                        f"plain {rec['plain_ms']:.4f}; library "
                        f"{rec['library_ms']:.4f}")
                del x, w, b
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: llama2_7b served at full width and depth; B5 on its activations
# ---------------------------------------------------------------------------
def _rms_on_activations(model, captured) -> dict:
    """B5 through fused_rms_norm on the inputs of every decoder layer's
    input norm, captured during the first packed wave, against the
    model's own RMSNorm (the reference's plain op) within the split of
    the two forms, and against B5's plain version. B5's counters are set
    to 0 just before the fused_rms_norm calls and read just after."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.kernels import norms
    layers = list(model.llama.layers)
    if len(captured) != len(layers):
        raise RuntimeError(f"captured {len(captured)} layer inputs, "
                           f"expected {len(layers)}")
    fwd = norms.rms_norm_fwd
    with torch.no_grad():
        fwd.kernel_launches = fwd.plain_calls = 0
        outs = [fused_rms_norm(x, l.input_layernorm.weight._data,
                               l.input_layernorm.epsilon)
                for l, x in zip(layers, captured)]
        torch.cuda.synchronize()
        launches, plain_calls = fwd.kernel_launches, fwd.plain_calls
        split = max(_lim_err(o, l.input_layernorm(x), SPLIT_TOL)
                    for o, l, x in zip(outs, layers, captured))
        vs_plain = max(_lim_err(o, fwd(x, l.input_layernorm.weight._data,
                                       l.input_layernorm.epsilon,
                                       path="torch"), NORM_TOL["bf16"])
                       for o, l, x in zip(outs, layers, captured))
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    checks = {
        f"B5 launched once per layer ({len(layers)})":
            launches == len(layers),
        "B5's plain version never ran on CUDA tensors": plain_calls == 0,
        "fused_rms_norm == the layer's RMSNorm within the split":
            split <= 1.0 and finite,
        "B5 == its plain version on real activations": vs_plain <= 1.0,
    }
    for what, ok in checks.items():
        log(f"[engine] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"B5 on real activations failed: launches "
                           f"{launches} plain {plain_calls} split {split} "
                           f"vs plain {vs_plain}")
    log(f"[engine] B5 on {len(outs)} layers' real inputs "
        f"{list(captured[0].shape)}: normalised err vs RMSNorm {split:.3f} "
        f"(tol {SPLIT_TOL}), vs plain {vs_plain:.3f}")
    return dict(b5_launches=launches, b5_plain_calls=plain_calls,
                b5_rows=int(captured[0].shape[0]),
                b5_split_norm_err=split, b5_vs_plain_norm_err=vs_plain)


def llama_engine_phase() -> dict:
    def build():
        import torch
        from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
        cfg = llama2_7b()
        model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=0)
        # RMSNorm weights are constructed as 1; a trained model's are not,
        # and at 1 the two forms of the norm would not differ: draw them
        # from N(1, 0.1), seeded
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        with torch.no_grad():
            for name, p in _torch_named_params(model):
                if name.endswith("norm.weight"):
                    p.normal_(1.0, 0.1, generator=g)
        return model, cfg

    return serve_phase(
        "llama2_7b", build,
        dict(max_batch=8, block_size=64, decode_chunk=16, prompt_quantum=128,
             max_model_len=1024),
        wave_hooks=lambda m: [l.input_layernorm for l in m.llama.layers],
        after=_rms_on_activations)


def llama_parity_phase() -> dict:
    """Phase 10: engine == dense generate on 2 layers at llama2_7b's
    widths with 8 kv heads (GQA through B3 and decode)."""
    def build():
        from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
        cfg = dataclasses.replace(llama2_7b(), num_layers=2, num_kv_heads=8)
        return LlamaForCausalLM(cfg, dtype="float32", seed=1), cfg

    return parity_phase("llama2_7b 2 layers GQA 32/8", build)


# ---------------------------------------------------------------------------
# phase 11: the incubate fused path (FusedTransformerEncoderLayer)
# ---------------------------------------------------------------------------
BERT_BASE = dict(d_model=768, nhead=12, dim_feedforward=3072,
                 activation="gelu")


def _encoder_stack(n_layers, dtype, device="cuda"):
    """bert_base-wide post-LN FusedTransformerEncoderLayers in eval,
    layer i drawn from a generator seeded with 4 * i."""
    import torch
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    stack = torch.nn.Sequential(*[FusedTransformerEncoderLayer(
        **BERT_BASE, dropout_rate=0.1, normalize_before=False,
        device=device, dtype=dtype,
        init_generator=torch.Generator(device).manual_seed(4 * i))
        for i in range(n_layers)])
    return stack.eval()


def fused_phase() -> dict:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import norms
    n_layers, batch, seq = 12, 16, 512
    stack = _encoder_stack(n_layers, "bfloat16")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((batch, seq, BERT_BASE["d_model"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    counters = (norms.layer_norm_fwd, fa.flash_fwd)
    with torch.no_grad():
        torch.cuda.synchronize()
        norms.layer_norm_fwd.kernel_launches = 0
        norms.layer_norm_fwd.plain_calls = 0
        fa.reset_counters()
        with kernel_calls(fa, "_fwd_cuda") as b1_calls:
            y = stack(x)
        torch.cuda.synchronize()
        launches = tuple(c.kernel_launches for c in counters)
        designs = dict(fa.flash_fwd.design_launches)
        plain = tuple(c.plain_calls for c in counters)
        # B1 on the main path's operands (pre-scaled q, k and v as views
        # of each layer's qkv projection) against its plain version
        b1_err = b1_lse_err = 0.0
        for (qs, k, v, causal, segs), (o, lse) in b1_calls:
            wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
            b1_err = max(b1_err, _norm_err(o, wo))
            b1_lse_err = max(b1_lse_err, _norm_err(lse, wlse, rows=False))
        strided = bool(b1_calls) and not b1_calls[0][0][1].is_contiguous()
        del b1_calls
        fwd_ms = cuda_ms(lambda: stack(x), iters=5, warmup=1)
        with kernel_events(b4=(norms, "_norm_cuda"), b1=(fa, "_fwd_cuda")) \
                as events:
            stack(x)
        torch.cuda.synchronize()
    split = {k: sum(s.elapsed_time(e) for s, e in v)
             for k, v in events.items()}
    ok_out = bool(torch.isfinite(y).all()) and y.shape == x.shape
    # 2 layers in f32: the card (kernels, TF32 off) against the same
    # stack and weights on the CPU (plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    small = _encoder_stack(2, "float32")
    cpu = _encoder_stack(2, "float32", device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    xs = torch.randn((2, seq, BERT_BASE["d_model"]), generator=g,
                     device="cuda")
    with torch.no_grad():
        got = small(xs)
        want = cpu(xs.cpu())
    parity = _lim_err(got.cpu(), want, (1e-4, 1.0))
    checks = {
        "output finite, of the input's shape": ok_out,
        f"B4 launched twice per layer ({2 * n_layers})":
            launches[0] == 2 * n_layers,
        f"B1 launched once per layer ({n_layers})": launches[1] == n_layers,
        "every B1 launch ran the sm90 design": designs == {
            "sm90": n_layers, "simple": 0},
        "plain versions never ran on CUDA tensors": plain == (0, 0),
        "B1 read k and v in place as strided views": strided,
        f"B1 == its plain version on the layers' operands (o within "
        f"{FLASH_TOL['bf16']:.2e}, lse within {FLASH_TOL['f32']:.0e})":
            b1_err <= FLASH_TOL["bf16"] and b1_lse_err <= FLASH_TOL["f32"],
        "2-layer f32 stack on the card == on the CPU (1e-4 relative)":
            parity <= 1.0,
    }
    for what, ok in checks.items():
        log(f"[fused] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"fused phase failed: launches {launches} B1 by "
                           f"design {designs} plain "
                           f"{plain} B1 err {b1_err} lse {b1_lse_err} "
                           f"parity {parity}")
    rec = dict(layers=n_layers, batch=batch, seq=seq, forward_ms=fwd_ms,
               b4_ms_per_forward=split["b4"], b1_ms_per_forward=split["b1"],
               b4_launches=launches[0], b1_launches=launches[1],
               b1_design_launches=designs,
               plain_calls=list(plain), b1_norm_err=b1_err,
               b1_lse_norm_err=b1_lse_err, parity_norm_err=parity)
    log(f"[fused] {n_layers} x FusedTransformerEncoderLayer (bert_base, "
        f"post-LN, bf16, eval), batch {batch} x seq {seq}: forward "
        f"{fwd_ms:.3f} ms, of which B4 {split['b4']:.3f} ms and B1 "
        f"{split['b1']:.3f} ms of device time (events around the "
        f"wrappers); B4 {launches[0]} and B1 {launches[1]} launches; B1 vs "
        f"plain on the layers' operands: o {b1_err:.2e}, lse "
        f"{b1_lse_err:.2e}; 2-layer f32 card vs CPU normalised err "
        f"{parity:.3f}")
    del stack, small, cpu, x, y
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 12: the multi-tensor Adam update vs its plain version
# ---------------------------------------------------------------------------
# (name, AdamW (decoupled decay) or Adam (coupled L2), moment dtype, grad
# dtype, bf16 parameters with f32 masters, decays of the two groups:
# matrices, then vectors)
UPDATE_CASES = [
    ("adamw f32, two groups' decays", True, "float32", "float32", False,
     (0.01, 0.1)),
    ("adamw bf16 moments", True, "bfloat16", "float32", False, (0.01, 0.0)),
    ("adam coupled L2", False, "float32", "float32", False, (0.01, 0.01)),
    ("adamw bf16 params with f32 masters", True, "float32", "bfloat16", True,
     (0.01, 0.01)),
]
# kernel vs plain, element by element, in units of the last place of the
# stored type at the plain value (or at the tensor's rms, if larger): the
# kernel computes the plain
# version's f32 operations in the same order with no FMA contraction and
# rounds each store to nearest even as the plain casts do, so 2 f32 ulps
# and 1 bf16 ulp; a planted 1 % error in one tensor's lr moves its
# elements by ~1e-2 of an update, hundreds of f32 ulps
UPDATE_ULPS = {"float32": 2, "bfloat16": 1}
UPDATE_MANTISSA = {"float32": 23, "bfloat16": 7}
UPDATE_LR, UPDATE_STEPS = 1e-4, 3


def _ulp_err(got, want):
    """The largest |got - want| in units of the last place of want's
    dtype at |want|, or at the tensor's rms where |want| is smaller (a
    value that is small by cancellation carries its terms' rounding)."""
    import torch
    dt = str(want.dtype).split(".")[-1]
    w = want.double()
    floor = max(float(w.square().mean().sqrt()) if w.numel() else 0.0,
                torch.finfo(want.dtype).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(floor)))
                     - UPDATE_MANTISSA[dt])
    return float(((got.double() - w).abs() / ulp).max()) if w.numel() \
        else 0.0


def _update_bound(slots):
    """(bound_ms, bound_by, bytes, flops): each element reads w, g, m
    and v once and writes w, m, v (and a master's cast) once; ~17 f32
    operations an element over the card's f32 rate outside the tensor
    cores."""
    nbytes = flops = 0
    for s in slots:
        n = s.w.numel()
        nbytes += n * (2 * 4 + s.g.element_size()
                       + 4 * s.m.element_size()
                       + (0 if s.out is None else s.out.element_size()))
        flops += 17 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


def _update_slots(shapes, init, case, seed):
    """One case's slots at gpt2_small's parameter shapes: w from the
    model's initial weights, a gradient and moments from `seed` (the
    moments of a run some steps in), powers at step 10."""
    import torch
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    _, _, mdt, gdt, masters, decays = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slots = []
    for shape, w0 in zip(shapes, init):
        w = w0.clone()
        g = (torch.randn(shape, device="cuda", generator=gen) * 1e-3).to(
            getattr(torch, gdt))
        m = (torch.randn(shape, device="cuda", generator=gen) * 1e-4).to(
            getattr(torch, mdt))
        v = (torch.rand(shape, device="cuda", generator=gen) * 1e-7).to(
            getattr(torch, mdt))
        pows = [torch.full((), b ** 10, device="cuda") for b in (0.9, 0.999)]
        slots.append(mta.AdamSlot(
            w, g, m, v, *pows, wd=decays[0] if len(shape) > 1 else decays[1],
            out=w.to(torch.bfloat16) if masters else None))
    return slots


def _update_errs(got, want):
    """{array: largest error in ulps} over every slot, and whether the
    powers agree exactly."""
    errs = {}
    for k in ("w", "m", "v", "out"):
        pairs = [(getattr(a, k), getattr(b, k)) for a, b in zip(got, want)
                 if getattr(a, k) is not None]
        if pairs:
            errs[k] = max(_ulp_err(a, b) for a, b in pairs)
    pows = all(bool(a.beta1_pow == b.beta1_pow)
               and bool(a.beta2_pow == b.beta2_pow)
               for a, b in zip(got, want))
    return errs, pows


def update_phase() -> list:
    """Phase 12: the update kernel against its plain version at
    gpt2_small's 148 parameter shapes, a fault planted, timed."""
    import torch
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    model = GPTForCausalLM(gpt2_small(), device="cuda", dtype="float32",
                           seed=0)
    init = [p.detach().clone() for p in _torch_params(model)]
    shapes = [tuple(p.shape) for p in init]
    del model
    lr = torch.full((), UPDATE_LR, device="cuda")
    out = []
    for ci, case in enumerate(UPDATE_CASES):
        name, decoupled, mdt, gdt, masters, _ = case
        kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=decoupled)
        got = _update_slots(shapes, init, case, seed=ci)
        want = _update_slots(shapes, init, case, seed=ci)
        planted = _update_slots(shapes, init, case, seed=ci)
        n0 = mta.multi_tensor_adam.kernel_launches
        big = max(range(len(shapes)), key=lambda i: got[i].w.numel())
        for _ in range(UPDATE_STEPS):
            mta.multi_tensor_adam(got, lr, **kw)
            mta.multi_tensor_adam(want, lr, path="torch", **kw)
            # the planted fault: the largest tensor's lr off by 1 %
            mta.multi_tensor_adam(planted[:big] + planted[big + 1:], lr,
                                  path="torch", **kw)
            mta.multi_tensor_adam(planted[big:big + 1], lr * 1.01,
                                  path="torch", **kw)
        torch.cuda.synchronize()
        launches = mta.multi_tensor_adam.kernel_launches - n0
        errs, pows = _update_errs(got, want)
        perrs, _ = _update_errs(got, planted)
        limits = {"w": UPDATE_ULPS["float32"], "m": UPDATE_ULPS[mdt],
                  "v": UPDATE_ULPS[mdt], "out": UPDATE_ULPS["bfloat16"]}
        max_abs = max(float((a.w - b.w).abs().max())
                      for a, b in zip(got, want))
        moved = max(float((a.w - w0).abs().max())
                    for a, w0 in zip(got, init))
        del planted
        bms, by, nbytes, flops = _update_bound(got)
        rec = dict(case=name, tensors=len(shapes),
                   elements=sum(s.w.numel() for s in got), ulp_err=errs,
                   planted_ulp_err=perrs, powers_equal=pows,
                   max_abs_err=max_abs, moved=moved, launches=launches,
                   bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
        rec["ms_graph"] = graph_ms(
            lambda: mta.multi_tensor_adam(got, lr, **kw), reps=5, iters=10)
        rec["ms"] = cuda_ms(lambda: mta.multi_tensor_adam(got, lr, **kw),
                            iters=10)
        rec["plain_ms"] = cuda_ms(lambda: mta.multi_tensor_adam(
            want, lr, path="torch", **kw), iters=5)
        rec["library_ms"] = None
        if ci == 0:
            # a yardstick only, never on the port's path: torch's fused
            # AdamW decays first and rounds in another order
            steps = [torch.full((), 10.0, device="cuda") for _ in got]
            ws, gs = [s.w for s in got], [s.g for s in got]
            ms_, vs = [s.m for s in got], [s.v for s in got]
            rec["library_ms"] = graph_ms(lambda: torch._fused_adamw_(
                ws, gs, ms_, vs, [], steps, lr=UPDATE_LR, beta1=0.9,
                beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                maximize=False), reps=5, iters=10)
        ok = (launches == UPDATE_STEPS and pows and moved > UPDATE_LR
              and all(e <= limits[k] for k, e in errs.items())
              and perrs["w"] > limits["w"])
        log(f"[update] {name}: {len(shapes)} tensors, {rec['elements']} "
            f"elements, {launches} launches in {UPDATE_STEPS} steps; err "
            f"in ulps {errs} (limits {limits}), powers equal {pows}; "
            f"planted lr x1.01 on the largest tensor: w err "
            f"{perrs['w']:.1f} ulps (must exceed {limits['w']}); kernel "
            f"{rec['ms_graph']:.4f} ms by replay, {rec['ms']:.4f} by "
            f"events; bound {bms:.4f} ({by}); plain {rec['plain_ms']:.3f};"
            f" torch._fused_adamw_ {rec['library_ms']}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"update phase failed: {rec}")
        del got, want
        torch.cuda.empty_cache()
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 13: bench_gpt_1p3b's config trained at full width and depth
# ---------------------------------------------------------------------------
# bench.py::bench_gpt_1p3b (bench.py:167-190): GPT-3 XL widths, batch 4 x
# seq 2048, bf16 O1, AdamW with bf16 moments, flash attention, every
# third block recomputed ("full": only its input kept)
B1P3_BATCH, B1P3_SEQ, B1P3_INTERVAL = 4, 2048, 3


def _fresh_card():
    """Free what earlier runs left (the allocator's cache included) and
    reset the peak: returns the GiB still held (by earlier phases)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def _check(prefix, checks, detail):
    """Log each named check after `prefix`; raise if any failed."""
    for what, ok in checks.items():
        log(f"{prefix} check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"{prefix} failed: {detail}")


def _train_run(tag, label, model, step, batch, per_step, warmup=2,
               steps=6) -> dict:
    """`warmup` + `steps` TrainStep calls on `batch` through the step's
    graph (_counted_steps), checked: every loss finite, one capture and
    every later call a replay, (B1, B2, update) at `per_step` launches in
    the eager first step and in the captured one, every B1/B2 launch
    sm90, no plain version on CUDA tensors, no AccumulateGrad
    stream-mismatch warning. Then the step by wall (the
    median of the timed calls) and by replay of its graph, the idle
    share, tokens/s, MFU (bench.py's 6·N·tokens/s over the bf16 peak, N
    the model's parameters) and peak memory since the caller's reset.
    `tag` prefixes the log lines, `label` names the run."""
    import torch
    run = _counted_steps(step, batch, warmup + steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_calls = warmup + steps
    checks = {
        "every loss finite": all(np.isfinite(run["losses"])),
        "one graph captured, every later step a replay": (
            run["captures"], run["replays"]) == (
            {"train_step": 1}, {"train_step": n_calls - 1}),
        f"(B1, B2, update) at {per_step} launches in the eager step and "
        f"in the captured one": run["eager"] == run["in_graph"] == per_step,
        "every B1 and B2 launch ran the sm90 design": (
            run["designs"], run["bwd_designs"]) == (
            {"sm90": 2 * per_step[0], "simple": 0},
            {"sm90": 2 * per_step[1], "simple": 0}),
        "no plain version ran on CUDA tensors": run["plain"] == (0, 0)
            and run["update_plain"] == 0,
        "no AccumulateGrad stream-mismatch warning":
            run["stream_warnings"] == 0,
    }
    _check(f"[{tag}] {label}:", checks, run)
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    del graph
    timed = run["step_s"][warmup:]
    wall_ms = 1e3 * statistics.median(timed)
    n = sum(p.numel() for p in _torch_params(model))
    tokens = int(np.prod(np.shape(batch[0])))
    tok_s = tokens / (wall_ms / 1e3)
    rec = dict(
        params=n, tokens_per_step=tokens, timed_steps=steps,
        step_ms_median=wall_ms, step_ms=[1e3 * x for x in timed],
        first_step_ms=1e3 * run["step_s"][0], capture_s=run["capture_s"],
        step_ms_replay=replay_ms, idle_share=1 - replay_ms / wall_ms,
        tokens_per_s=tok_s, mfu=6.0 * n * tok_s / BF16_FLOPS_PER_S,
        step_floor_ms=6.0 * n * tokens / BF16_FLOPS_PER_S * 1e3,
        peak_mem_gb=peak,
        launches_counted=list(run["counted"]),
        launches_eager=list(run["eager"]),
        launches_in_graph=list(run["in_graph"]),
        launches_on_device=list(run["on_device"]),
        captures=run["captures"], replays=run["replays"],
        stream_warnings=run["stream_warnings"], losses=run["losses"])
    log(f"[{tag}] {label}: {n} params, {tokens} tokens a step: step "
        f"median {wall_ms:.2f} ms by wall ({min(rec['step_ms']):.2f}-"
        f"{max(rec['step_ms']):.2f} over {steps}), {replay_ms:.2f} ms by "
        f"replay (device idle {100 * rec['idle_share']:.1f} %); "
        f"{tok_s:.1f} tokens/s, MFU {rec['mfu']:.4f} (6ND floor "
        f"{rec['step_floor_ms']:.2f} ms); peak mem {peak:.2f} GiB; first "
        f"call {rec['first_step_ms']:.0f} ms (capture "
        f"{run['capture_s']:.2f} s); launches (B1, B2, update) eager "
        f"{run['eager']}, captured step {run['in_graph']}, on the card "
        f"{run['on_device']}; losses {[round(x, 4) for x in run['losses']]}")
    return rec


def _require_sm90(label, shape_q, shape_k):
    """Raise unless a bf16 attention call on [b, s, H, D] operands of
    these shapes takes B1's and B2's sm90 kernels."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    d = shape_q[-1]
    picked = (fa.attention_path(shape_q, shape_k),
              fa._fwd_design(torch.bfloat16, d),
              fa._bwd_design(torch.bfloat16, d))
    if picked != (("cuda", ""), "sm90", "sm90"):
        raise RuntimeError(f"{label} attention would not take B1/B2's "
                           f"sm90 kernels: {picked}")


def _train_1p3b(recompute: bool) -> dict:
    """One TrainStep run of bench_gpt_1p3b's config (with or without
    recompute) through its graph, 2 warm-up calls and 6 timed: counters,
    losses, the step by wall and by replay, peak memory from a freed
    card."""
    from paddle_tpu_torch.models import gpt3_1p3b
    held = _fresh_card()
    cfg = gpt3_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                    use_flash_attention=True, recompute=recompute,
                    recompute_interval=B1P3_INTERVAL,
                    recompute_policy="full")
    b, s = B1P3_BATCH, B1P3_SEQ
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    _require_sm90("gpt3_1p3b", shape, shape)
    model, step = _gpt_train_step(cfg, use_amp=True, lr=1e-4, seed=0,
                                  moment_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    L = cfg.num_layers
    remat = len(range(0, L, B1P3_INTERVAL)) if recompute else 0
    rec = _train_run("train-1p3b", "recompute" if recompute
                     else "no recompute", model, step, (ids, labels),
                     per_step=(L + remat, L, 2))
    rec.update(config="gpt3_1p3b (bench_gpt_1p3b)", recompute=recompute,
               recompute_interval=B1P3_INTERVAL if recompute else None,
               recomputed_blocks=remat, layers=L, batch=b, seq=s,
               held_at_start_gb=held)
    del model, step
    _fresh_card()
    return rec


def train_1p3b_phase() -> dict:
    """Phase 13: bench_gpt_1p3b's config with recompute, then without
    it: what recompute costs in step time and saves in memory."""
    with_r = _train_1p3b(recompute=True)
    without = _train_1p3b(recompute=False)
    log(f"[train-1p3b] recompute costs "
        f"{with_r['step_ms_median'] - without['step_ms_median']:.2f} ms a "
        f"step by wall ({with_r['step_ms_replay'] - without['step_ms_replay']:.2f}"
        f" by replay) and saves "
        f"{without['peak_mem_gb'] - with_r['peak_mem_gb']:.2f} GiB of peak "
        f"memory")
    return dict(recompute=with_r, no_recompute=without)


# ---------------------------------------------------------------------------
# phase 14: recompute through TrainStep's graph == no recompute, eager
# ---------------------------------------------------------------------------
# (recompute_interval, policy) of the graph runs held to the eager run
RECOMPUTE_CASES = ((1, "full"), (3, "full"), (1, "dots"), (3, "dots"))


def recompute_parity_phase() -> dict:
    """gpt3_1p3b's widths at 4 layers, bf16 O1, dropout 0.1, one seed:
    3 TrainStep steps through the graph with recompute, for each case,
    against 3 eager steps without it. Equal masks and equal kernels
    should make the two equal bit for bit; they are held to phase 7's
    rule (_held_to: one block's masks drawn anew would move nearly every
    parameter by ~lr), and the largest difference is recorded."""
    import gc

    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt3_1p3b
    lr, n_steps, layers = 1e-4, 3, 4
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50304, (2, 1024)).astype(np.int32)
    labels = rng.integers(0, 50304, (2, 1024)).astype(np.int32)
    base = dataclasses.replace(
        gpt3_1p3b(hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                  use_flash_attention=True), num_layers=layers)

    def run(cfg, eager):
        model, step = _gpt_train_step(cfg, use_amp=True, lr=lr, seed=0,
                                      moment_dtype="bfloat16")
        step._eager = eager
        n0 = fa.flash_fwd.kernel_launches
        losses = [float(step(ids, labels)) for _ in range(n_steps)]
        b1 = fa.flash_fwd.kernel_launches - n0
        params = _state(model)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        return losses, params, b1

    want_losses, want, _ = run(base, eager=True)
    out = []
    for interval, policy in RECOMPUTE_CASES:
        cfg = dataclasses.replace(base, recompute=True,
                                  recompute_interval=interval,
                                  recompute_policy=policy)
        losses, got, b1 = run(cfg, eager=False)
        # the eager first step's launches and the captured step's
        want_b1 = 2 * (layers + len(range(0, layers, interval)))
        cmp = _held_to(losses, want_losses, got, want, lr, n_steps)
        ok = b1 == want_b1 and all(np.isfinite(losses)) and cmp["ok"]
        log(f"[recompute-parity] interval {interval}, {policy}: graph "
            f"steps with recompute vs eager steps without, losses "
            f"{[round(x, 5) for x in losses]} vs "
            f"{[round(x, 5) for x in want_losses]} (max rel diff "
            f"{cmp['loss_max_rel_diff']:.2e}, tol 1e-5); params max abs "
            f"diff {cmp['param_max_abs_diff']:.3e} (bound "
            f"{cmp['param_bound']:.1e}), {cmp['params_far']} of "
            f"{cmp['params_total']} beyond 1e-3*lr; B1 launches {b1} "
            f"(expected {want_b1}): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"recompute parity failed at interval "
                               f"{interval}, {policy}")
        out.append(dict(interval=interval, policy=policy, losses=losses,
                        b1_launches=b1, **{k: cmp[k] for k in (
                            "loss_max_rel_diff", "param_max_abs_diff",
                            "params_far")}))
    return dict(eager_losses=want_losses, cases=out)


# ---------------------------------------------------------------------------
# phase 15: gpt2_small trained in f16 O1 (GradScaler, TrainStep, O2)
# ---------------------------------------------------------------------------
# eager steps with the scaler and the one whose gradient is poisoned; the
# graph's calls (2 warm-up + 6 timed). MFU is taken against the bf16 peak,
# which is the f16 peak too (989 TFLOP/s dense)
F16_EAGER_STEPS, F16_POISON_AT = 8, 4
F16_GRAPH_CALLS = 2 + 6


def _sync_count(fn):
    """(fn(), the synchronising CUDA calls it made), counted by torch's
    sync debug mode (each one warns "called a synchronizing CUDA
    operation" while it is on; the mode's own notice is not one)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return r, sum("called a synchronizing" in str(w.message) for w in seen)


def _scaler_steps(cfg, ids, labels) -> dict:
    """F16_EAGER_STEPS eager f16 O1 steps through Optimizer.step with a
    GradScaler (decr_every_n_nan_or_inf=1), the first weight's gradient
    set to inf after the backward of step F16_POISON_AT: the scaler must
    skip that update, leave the weight as it was and halve the scale,
    and step every other time; one unscale pass and one host sync a
    step. B1/B2 and the update kernel's launches are counted."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, dtype="float32", seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=_torch_params(model),
                weight_decay=0.01)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            decr_every_n_nan_or_inf=1)
    crit = GPTPretrainingCriterion()
    ids_t, labels_t = (torch.as_tensor(a, device="cuda")
                       for a in (ids, labels))
    w0 = next(_torch_params(model))
    fa.reset_counters()
    mta.multi_tensor_adam.kernel_launches = 0
    losses, step_s, scales, ran, syncs = [], [], [], [], []
    kept = None
    for i in range(F16_EAGER_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="float16"):
            logits = model(ids_t)
        loss = crit(logits, labels_t)
        scaler.scale(loss).backward()
        if i == F16_POISON_AT:
            w0.grad.view(-1)[0] = float("inf")
            before = w0.detach().clone()
        n0 = mta.multi_tensor_adam.kernel_launches
        _, n_sync = _sync_count(lambda: scaler.step(opt))
        opt.clear_grad()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        syncs.append(n_sync)
        ran.append(mta.multi_tensor_adam.kernel_launches > n0)
        scales.append(scaler._scale)
        losses.append(loss.detach())
        if i == F16_POISON_AT:
            kept = bool(torch.equal(w0.detach(), before))
    rec = dict(losses=[float(x) for x in losses], step_s=step_s,
               scales=scales, ran=ran, syncs_in_step=syncs,
               weight_kept_on_skip=kept,
               unscale_stats=dict(scaler._unscale_stats),
               b1_design_launches=dict(fa.flash_fwd.design_launches),
               b2_design_launches=dict(fa.flash_bwd.design_launches),
               plain_calls=[fa.flash_fwd.plain_calls,
                            fa.flash_bwd.plain_calls],
               update_launches=mta.multi_tensor_adam.kernel_launches)
    del model, opt, losses
    torch.cuda.empty_cache()
    return rec


def _o2_step(cfg, ids, labels) -> dict:
    """One scaled step of amp.decorate(model, opt, level="O2",
    dtype="float16"): f16 parameters, f32 masters made by the step, the
    multi-tensor update on the masters writing the f16 casts."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, dtype="float32", seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=_torch_params(model),
                weight_decay=0.01)
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    crit = GPTPretrainingCriterion()
    ids_t, labels_t = (torch.as_tensor(a, device="cuda")
                       for a in (ids, labels))
    before = [p.detach().clone() for p in _torch_params(model)]
    n0 = mta.multi_tensor_adam.kernel_launches
    with amp.auto_cast(level="O2", dtype="float16"):
        logits = model(ids_t)
    loss = crit(logits, labels_t)
    scaler.scale(loss).backward()
    scaler.step(opt)
    torch.cuda.synchronize()
    params = list(_torch_params(model))
    masters = [opt._master_weights.get(id(p)) for p in params]
    rec = dict(
        loss=float(loss.detach()), logits_dtype=str(logits.dtype),
        params_f16=all(p.dtype == torch.float16 for p in params),
        masters_f32=all(m is not None and m.dtype == torch.float32
                        for m in masters),
        params_are_master_casts=all(
            torch.equal(p.detach(), m.to(torch.float16))
            for p, m in zip(params, masters) if m is not None),
        moved=max(float((p.detach().float() - b.float()).abs().max())
                  for p, b in zip(params, before)),
        update_launches=mta.multi_tensor_adam.kernel_launches - n0,
        optimizer_steps=opt._step_count)
    del model, opt, before, params, masters
    torch.cuda.empty_cache()
    return rec


def f16_train_phase() -> dict:
    """Phase 15: gpt2_small at full width and depth in f16 O1, batch 16 x
    seq 1024, AdamW, flash attention, dropout 0: eager steps with a
    GradScaler (one of them poisoned), TrainStep's graph (no scaler, as
    the reference's TrainStep takes none) against its eager steps, and
    one O2 decorate step."""
    import torch
    from paddle_tpu_torch.models import gpt2_small, num_params
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     use_flash_attention=True)
    batch, seq = 16, 1024
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    L, n = cfg.num_layers, num_params(cfg)

    sc = _scaler_steps(cfg, ids, labels)
    k = F16_POISON_AT
    good = [s for i, s in enumerate(sc["step_s"]) if i >= 2 and i != k]
    eager_med = statistics.median(good)

    torch.cuda.reset_peak_memory_stats()
    model, step = _gpt_train_step(cfg, use_amp=True, amp_dtype="float16")
    run = _counted_steps(step, (ids, labels), F16_GRAPH_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    graph_params = _state(model)
    # after the parameters are kept: each replay is one more step
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    del model, step
    torch.cuda.empty_cache()
    model, step = _gpt_train_step(cfg, use_amp=True, amp_dtype="float16")
    step._eager = True
    eager_losses = [float(step(ids, labels))
                    for _ in range(F16_GRAPH_CALLS)]
    cmp = _held_to(run["losses"], eager_losses, graph_params,
                   list(_torch_state(model).values()),
                   step.optimizer.get_lr(), F16_GRAPH_CALLS)
    loss_err, param_err = cmp["loss_max_rel_diff"], cmp["param_max_abs_diff"]
    far, n_el, bound = cmp["params_far"], cmp["params_total"], \
        cmp["param_bound"]
    del model, step, graph_params
    torch.cuda.empty_cache()

    o2 = _o2_step(cfg, ids, labels)

    timed = run["step_s"][2:]
    med = statistics.median(timed)
    n_graph = F16_GRAPH_CALLS
    checks = {
        "every loss finite (scaler, graph, eager)": all(np.isfinite(
            sc["losses"] + run["losses"] + eager_losses)),
        f"the poisoned step {k} skipped, every other step updated":
            sc["ran"] == [i != k for i in range(F16_EAGER_STEPS)],
        "the skipped step left the weight as it was":
            sc["weight_kept_on_skip"] is True,
        "the scale halved at the skip, and only there": all(
            sc["scales"][i] == (2.0 ** 14 if i >= k else 2.0 ** 15)
            for i in range(F16_EAGER_STEPS)),
        "one unscale pass and one host sync a step": sc["unscale_stats"]
            == {"dispatches": F16_EAGER_STEPS, "syncs": F16_EAGER_STEPS}
            and sc["syncs_in_step"] == [1] * F16_EAGER_STEPS,
        "every B1/B2 launch of the scaler steps ran sm90": (
            sc["b1_design_launches"], sc["b2_design_launches"]) == (
            {"sm90": L * F16_EAGER_STEPS, "simple": 0},) * 2,
        "the graph: one capture, every later call a replay": (
            run["captures"], run["replays"]) == (
            {"train_step": 1}, {"train_step": n_graph - 1}),
        "B1, B2 and the update at (12, 12, 1) in the eager step and in "
        "the captured one": run["in_graph"] == run["eager"] == (L, L, 1),
        "every graph B1/B2 launch ran sm90": (
            run["designs"], run["bwd_designs"]) == (
            {"sm90": 2 * L, "simple": 0},) * 2,
        "plain versions never ran on CUDA tensors": sc["plain_calls"]
            == [0, 0] and run["plain"] == (0, 0)
            and run["update_plain"] == 0,
        "no AccumulateGrad stream-mismatch warning in the graph steps":
            run["stream_warnings"] == 0,
        "graph steps == eager steps (phase 7's rule)": cmp["ok"],
        "O2: f16 parameters, f32 masters, one update launch writing the "
        "masters' casts": o2["params_f16"] and o2["masters_f32"]
            and o2["params_are_master_casts"]
            and o2["update_launches"] == 1 and o2["optimizer_steps"] == 1
            and o2["moved"] > 0 and np.isfinite(o2["loss"]),
    }
    for what, ok in checks.items():
        log(f"[train-f16] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"f16 training phase failed: scaler {sc}, "
                           f"graph {run}, eager {eager_losses}, O2 {o2}")
    tok_graph = batch * seq * len(timed) / sum(timed)
    tok_eager = batch * seq / eager_med
    rec = dict(
        config="gpt2_small", dtype="float16", level="O1", layers=L,
        batch=batch, seq=seq, params=n,
        scaler_step_ms_median=1e3 * eager_med,
        scaler_tokens_per_s=tok_eager,
        scaler_mfu=6.0 * n * tok_eager / BF16_FLOPS_PER_S,
        scaler_losses=sc["losses"], scales=sc["scales"],
        scaler_ran=sc["ran"], unscale_stats=sc["unscale_stats"],
        syncs_in_scaler_step=sc["syncs_in_step"],
        graph_step_ms_median=1e3 * med, graph_tokens_per_s=tok_graph,
        graph_mfu=6.0 * n * tok_graph / BF16_FLOPS_PER_S,
        step_ms_replay=replay_ms, idle_share=1 - replay_ms / (1e3 * med),
        first_call_ms=1e3 * run["step_s"][0],
        graph_losses=run["losses"], eager_losses=eager_losses,
        graph_vs_eager_loss_rel=loss_err,
        graph_vs_eager_param_max_abs=param_err, params_far=far,
        b1_launches=run["counted"][0], b2_launches=run["counted"][1],
        launches_in_graph=list(run["in_graph"]),
        launches_eager=list(run["eager"]),
        b1_launches_on_device=run["on_device"][0],
        b2_launches_on_device=run["on_device"][1],
        scaler_b1_launches=sc["b1_design_launches"]["sm90"],
        scaler_b2_launches=sc["b2_design_launches"]["sm90"],
        stream_warnings=run["stream_warnings"], peak_mem_gb=peak, o2=o2)
    log(f"[train-f16] gpt2_small f16 O1 AdamW, {L} layers, batch {batch} "
        f"x seq {seq}: eager with GradScaler step median "
        f"{1e3 * eager_med:.2f} ms by wall, {tok_eager:.1f} tokens/s, MFU "
        f"{rec['scaler_mfu']:.4f}, scales {sc['scales']}, steps run "
        f"{sc['ran']}, syncs in scaler.step {sc['syncs_in_step']}; "
        f"TrainStep graph step median {1e3 * med:.2f} ms by wall, "
        f"{replay_ms:.2f} ms by replay (device idle "
        f"{100 * rec['idle_share']:.1f} %), {tok_graph:.1f} tokens/s, MFU "
        f"{rec['graph_mfu']:.4f}; graph vs eager losses max rel diff "
        f"{loss_err:.2e}, params max abs diff {param_err:.2e} (bound "
        f"{bound:.1e}, {far} of {n_el} beyond 1e-3*lr); launches (B1, B2, "
        f"update) eager {run['eager']}, captured {run['in_graph']}, on "
        f"the card {run['on_device']}; O2 step loss {o2['loss']:.4f}, "
        f"update launches {o2['update_launches']}, max move "
        f"{o2['moved']:.2e}; peak mem {peak:.2f} GiB; card {card_line()}")
    return rec


# ---------------------------------------------------------------------------
# phase 16: gpt3_1p3b served in f16
# ---------------------------------------------------------------------------
def _f16_generate_oracle(model, prompts, done) -> dict:
    """Each request's engine tokens against the port's f16 dense
    `generate` (its decode graphs), compared up to the first position
    whose top-1/top-2 margin in the dense sequence's f16 logits is below
    twice those logits' own rounding error: their largest difference
    from the same weights' logits in f32 (TF32 off) over the request.
    Engine and dense loop round at other places, each within that error
    of exact, so a narrower race may legitimately flip."""
    import copy
    import torch
    from paddle_tpu_torch.models import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    model.eval()
    m32 = copy.deepcopy(model).float()
    n_new = len(done[0].output_ids)
    guarded, margins, mismatched = [], [], []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            dense = generate(model, p[None], max_new_tokens=n_new)[0]
            seq = dense[None].long()
            lg = model(seq)[0, len(p) - 1:-1].float()
            noise = float((m32(seq)[0, len(p) - 1:-1] - lg).abs().max())
            margin = 2 * noise
            top2 = torch.topk(lg, 2, dim=-1).values
            low = np.flatnonzero(
                (top2[:, 0] - top2[:, 1]).cpu().numpy() < margin)
            n = int(low[0]) if len(low) else n_new
            guarded.append(n)
            margins.append(margin)
            want = dense[len(p):].cpu().numpy()
            if not np.array_equal(done[i].output_ids[:n], want[:n]):
                mismatched.append(i)
    del m32
    torch.cuda.empty_cache()
    ok = not mismatched and sum(guarded) > 0
    log(f"[engine-f16] check: engine tokens == f16 dense generate under "
        f"the margin guard: {'ok' if ok else 'FAILED'} (tokens compared "
        f"per request {guarded} of {n_new}, margins "
        f"{[round(m, 4) for m in margins]}, mismatched {mismatched})")
    if not ok:
        raise RuntimeError("f16 engine tokens differ from f16 generate")
    return dict(oracle_guarded=guarded, oracle_margins=margins,
                oracle_mismatched=mismatched)


def f16_engine_phase() -> dict:
    """Phase 16: gpt3_1p3b in f16 at full width and depth served by
    LLMEngine with phase 4's traffic (f16 pools, every B3 launch sm90,
    the decode graphs), its tokens held to f16 dense `generate`."""
    def build():
        from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
        cfg = gpt3_1p3b()
        return GPTForCausalLM(cfg, dtype="float16", seed=0), cfg

    return serve_phase("gpt3_1p3b", build, dict(
        max_batch=8, block_size=64, decode_chunk=16, prompt_quantum=128),
        oracle=_f16_generate_oracle)


# ---------------------------------------------------------------------------
# phases 17-18: LLaMA and BERT trained through TrainStep's graph
# ---------------------------------------------------------------------------
def _b1_signature(args, _result):
    """(q shape, k shape, causal, dtype) of a recorded B1 call."""
    return (tuple(args[0].shape), tuple(args[1].shape), args[3],
            str(args[0].dtype))


def _graph_vs_eager(build, batch, n_steps, build_eager=None) -> dict:
    """`n_steps` TrainStep calls through the graph of the model and step
    `build()` makes, then as many eager steps of those `build_eager()`
    (default `build`) makes from the same seed, held to each other by
    phase 7's rule (_held_to). In each run B1/B2's launches are counted
    by design, B1's calls recorded as {(q shape, k shape, causal,
    dtype)}, and torch's AccumulateGrad stream-mismatch warnings
    counted."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    runs = {}
    for eager in (False, True):
        _fresh_card()
        model, step = (build_eager or build)() if eager else build()
        step._eager = eager
        fa.reset_counters()
        with stream_mismatch_warnings() as warned, kernel_calls(
                fa, "_fwd_cuda", keep=_b1_signature) as calls:
            losses = [float(step(*batch)) for _ in range(n_steps)]
        runs[eager] = dict(
            losses=losses, b1_calls=set(calls),
            designs=dict(fa.flash_fwd.design_launches),
            bwd_designs=dict(fa.flash_bwd.design_launches),
            plain=(fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls),
            stream_warnings=len(warned), params=_state(model))
        lr = step.optimizer.get_lr()
        del model, step
    graph, eager = runs[False], runs[True]
    cmp = _held_to(graph["losses"], eager["losses"], graph.pop("params"),
                   eager.pop("params"), lr, n_steps)
    _fresh_card()
    return dict(graph=graph, eager=eager, **cmp)


def _parity_checks(res, layers, n_steps, want_calls, remat=False):
    """phase 7's rule and the launch counts of a _graph_vs_eager run:
    the graph run launches B1 and B2 once a layer in its eager first
    step and once in the capture (B1 twice with every layer recomputed,
    `remat`), the eager run once a layer a step, all sm90; both runs'
    B1 calls are `want_calls`; no AccumulateGrad stream-mismatch
    warning in either run."""
    g, e = res["graph"], res["eager"]
    sm90 = lambda n: {"sm90": n * layers, "simple": 0}
    return {
        "every loss finite": all(np.isfinite(g["losses"] + e["losses"])),
        "graph steps == eager steps (phase 7's rule)": res["ok"],
        "B1/B2 launches by design, graph and eager runs": (
            g["designs"], g["bwd_designs"], e["designs"], e["bwd_designs"])
            == (sm90(4 if remat else 2), sm90(2), sm90(n_steps),
                sm90(n_steps)),
        "no plain version ran on CUDA tensors": g["plain"] == e["plain"]
            == (0, 0),
        f"B1's calls {want_calls} in both runs":
            g["b1_calls"] == e["b1_calls"] == want_calls,
        "no AccumulateGrad stream-mismatch warning in either run":
            g["stream_warnings"] == e["stream_warnings"] == 0,
    }


def _parity_record(res):
    """The JSON record of a _graph_vs_eager run."""
    return dict(b1_calls=sorted(map(str, res["eager"]["b1_calls"])),
                graph_losses=res["graph"]["losses"],
                eager_losses=res["eager"]["losses"],
                stream_warnings=[res["graph"]["stream_warnings"],
                                 res["eager"]["stream_warnings"]],
                **{k: v for k, v in res.items()
                   if k not in ("graph", "eager")})


def _log_parity(tag, label, res):
    log(f"[{tag}] {label}: graph steps vs eager steps, losses "
        f"{[round(x, 5) for x in res['graph']['losses']]} vs "
        f"{[round(x, 5) for x in res['eager']['losses']]} (max rel diff "
        f"{res['loss_max_rel_diff']:.2e}, tol 1e-5); params max abs diff "
        f"{res['param_max_abs_diff']:.3e} (bound "
        f"{res['param_bound']:.1e}), {res['params_far']} of "
        f"{res['params_total']} beyond 1e-3*lr; B1/B2 launches by design "
        f"graph {res['graph']['designs']}/{res['graph']['bwd_designs']}, "
        f"eager {res['eager']['designs']}/{res['eager']['bwd_designs']}; "
        f"AccumulateGrad stream warnings graph "
        f"{res['graph']['stream_warnings']}, eager "
        f"{res['eager']['stream_warnings']}")


def _parity_subrun(tag, label, build, batch, layers, want_calls,
                   build_eager=None, remat=False) -> dict:
    """A _graph_vs_eager run of PARITY_STEPS steps, logged, checked
    (_parity_checks) and recorded."""
    res = _graph_vs_eager(build, batch, PARITY_STEPS, build_eager)
    _log_parity(tag, label, res)
    _check(f"[{tag}]", _parity_checks(res, layers, PARITY_STEPS,
                                      want_calls, remat), res)
    return dict(layers=layers, **_parity_record(res))


# phase 17: LLaMA-2-13B's widths (hidden 5120, 40 heads of 128, FFN
# 13824, vocab 32000) cut to 4 layers, LLaMA-2's 4096-token context; its
# recompute sub-run cut to 2 layers
LLAMA13_LAYERS, LLAMA13_BATCH, LLAMA13_SEQ = 4, 2, 4096
LLAMA13_REMAT_PARITY_LAYERS = 2
# the GQA sub-run: phase 10's config (llama2_7b's widths, 8 kv heads)
LLAMA_GQA_LAYERS, LLAMA_GQA_KV, LLAMA_GQA_BATCH, LLAMA_GQA_SEQ = 2, 8, 2, 2048
PARITY_STEPS = 3


def _llama_train_step(cfg, lr=1e-4, seed=0, recompute_layers=False):
    """An f32 LlamaForCausalLM trained by TrainStep: AdamW(lr, weight
    decay 0.01), the loss the reference's own test takes
    (cross_entropy(logits[:, :-1], ids[:, 1:])) with the forward under
    bf16 O1 auto_cast. `recompute_layers`: every decoder layer runs
    through distributed.meta_parallel.recompute (the reference's
    LlamaConfig has no recompute option; the caller wraps the layers)."""
    import torch
    from paddle_tpu_torch import TrainStep, amp
    from paddle_tpu_torch.distributed.meta_parallel import recompute
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    class RecomputedLayer(torch.nn.Module):
        def __init__(self, layer):
            super().__init__()
            self.layer = layer

        def forward(self, *args):
            if self.training:
                return recompute(self.layer, *args)
            return self.layer(*args)

    model = LlamaForCausalLM(cfg, dtype="float32", seed=seed)
    if recompute_layers:
        layers = model.llama.layers
        for i, layer in enumerate(layers):
            layers[i] = RecomputedLayer(layer)
    model.train()
    opt = AdamW(learning_rate=lr, parameters=_torch_params(model),
                weight_decay=0.01)

    def loss_fn(m, ids):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(ids)
        return F.cross_entropy(logits[:, :-1], ids[:, 1:])

    return model, TrainStep(model, opt, loss_fn)


def llama_train_phase() -> dict:
    """Phase 17: LLaMA-2-13B's widths at 4 layers, b2 x s4096, bf16 O1,
    AdamW, flash attention (MHA, 40 heads of 128), random weights from
    seed 0, through TrainStep's graph (2 + 6 calls), without recompute
    and with every layer recomputed; then two sub-runs of 3 graph steps
    held to 3 eager steps: the same widths and batch at 2 layers, every
    layer recomputed in the graph steps and none in the eager ones; and
    GQA, 2 layers at llama2_7b's widths with 8 kv heads, b2 x s2048."""
    from paddle_tpu_torch.models import llama2_7b, llama2_13b
    cfg = dataclasses.replace(llama2_13b(use_flash_attention=True),
                              num_layers=LLAMA13_LAYERS)
    b, s, L = LLAMA13_BATCH, LLAMA13_SEQ, cfg.num_layers
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    _require_sm90("llama2_13b", shape, shape)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {}
    for remat in (False, True):
        held = _fresh_card()
        model, step = _llama_train_step(cfg, recompute_layers=remat)
        label = "every layer recomputed" if remat else "no recompute"
        rec = _train_run("train-llama13b", label, model, step, (ids,),
                         per_step=(2 * L if remat else L, L, 1))
        rec.update(config="llama2_13b widths", layers=L, batch=b, seq=s,
                   recompute=remat, held_at_start_gb=held)
        out["recompute" if remat else "no_recompute"] = rec
        del model, step
    with_r, without = out["recompute"], out["no_recompute"]
    cost = {k: with_r[k] - without[k]
            for k in ("step_ms_median", "step_ms_replay", "peak_mem_gb")}
    log(f"[train-llama13b] recompute costs {cost['step_ms_median']:.2f} ms "
        f"a step by wall ({cost['step_ms_replay']:.2f} by replay) and saves "
        f"{-cost['peak_mem_gb']:.2f} GiB of peak memory")

    rl = LLAMA13_REMAT_PARITY_LAYERS
    rcfg = dataclasses.replace(cfg, num_layers=rl)
    out["recompute_parity"] = dict(
        config="llama2_13b widths", batch=b, seq=s, **_parity_subrun(
            "train-llama13b-remat", f"llama2_13b widths, {rl} layers, "
            f"batch {b} x seq {s}, bf16 O1, every layer recomputed in the "
            f"graph steps, none in the eager ones",
            lambda: _llama_train_step(rcfg, recompute_layers=True), (ids,),
            rl, {(shape, shape, True, "torch.bfloat16")},
            build_eager=lambda: _llama_train_step(rcfg), remat=True))

    gcfg = dataclasses.replace(
        llama2_7b(num_kv_heads=LLAMA_GQA_KV, use_flash_attention=True),
        num_layers=LLAMA_GQA_LAYERS)
    gb, gs = LLAMA_GQA_BATCH, LLAMA_GQA_SEQ
    gq = (gb, gs, gcfg.num_heads, gcfg.head_dim)
    gk = (gb, gs, LLAMA_GQA_KV, gcfg.head_dim)
    _require_sm90("llama2_7b GQA", gq, gk)
    gids = np.random.default_rng(3).integers(
        0, gcfg.vocab_size, (gb, gs)).astype(np.int32)
    out["gqa"] = dict(
        config="llama2_7b widths, 8 kv heads", batch=gb, seq=gs,
        **_parity_subrun(
            "train-llama-gqa", f"llama2_7b widths, {LLAMA_GQA_LAYERS} "
            f"layers, GQA {gcfg.num_heads}/{LLAMA_GQA_KV}, batch {gb} x "
            f"seq {gs}, bf16 O1", lambda: _llama_train_step(gcfg), (gids,),
            LLAMA_GQA_LAYERS, {(gq, gk, True, "torch.bfloat16")}))
    return out


# phase 18: bench.py::bench_bert_base (bench.py:271-325): bert_base, batch
# 32 x seq 512, bf16 O1, AdamW lr 1e-4, dropout 0, no attention mask
BERT_BATCH, BERT_SEQ = 32, 512


def _bert_train_step(cfg, lr=1e-4, seed=0):
    """bench_bert_base's step: an f32 BertForMaskedLM, AdamW(lr) with the
    reference's defaults, the MLM loss under bf16 O1 auto_cast."""
    from paddle_tpu_torch import TrainStep, amp
    from paddle_tpu_torch.models import BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    model = BertForMaskedLM(cfg, dtype="float32", seed=seed)
    model.train()
    opt = AdamW(learning_rate=lr, parameters=_torch_params(model))

    def loss_fn(m, ids, labels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = m(ids, labels=labels)
        return loss

    return model, TrainStep(model, opt, loss_fn)


def bert_train_phase() -> dict:
    """Phase 18: bench_bert_base's config at full width and depth
    through TrainStep's graph (2 + 6 calls): 12 B1 and 12 B2 launches a
    step (non-causal, head_dim 64, sm90), 2 of the update (204
    tensors); then a 2-layer copy at the same widths and batch, 3 graph
    steps held to 3 eager steps, B1's calls recorded."""
    from paddle_tpu_torch.models import bert_base
    cfg = bert_base(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    b, s, L = BERT_BATCH, BERT_SEQ, cfg.num_layers
    hd = cfg.hidden_size // cfg.num_heads
    shape = (b, s, cfg.num_heads, hd)
    _require_sm90("bert_base", shape, shape)
    # bench_bert_base's batch: ids, and labels at ~15 % of the positions
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.where(rng.random((b, s)) < 0.15, ids, -100).astype(np.int32)
    held = _fresh_card()
    model, step = _bert_train_step(cfg)
    n_tensors = len(list(_torch_params(model)))
    _check("[train-bert]", {
        "bert_base's 204 tensors (2 update launches a step)":
            n_tensors == 204}, n_tensors)
    rec = _train_run("train-bert", "bert_base (bench_bert_base)", model,
                     step, (ids, labels), per_step=(L, L, 2))
    rec.update(config="bert_base (bench_bert_base)", layers=L, batch=b,
               seq=s, update_tensors=n_tensors, held_at_start_gb=held,
               masked_positions=int((labels != -100).sum()))
    del model, step
    two = dataclasses.replace(cfg, num_layers=2)
    rec["two_layers"] = _parity_subrun(
        "train-bert", f"bert_base widths, 2 layers, batch {b} x seq {s}, "
        f"bf16 O1", lambda: _bert_train_step(two), (ids, labels), 2,
        {(shape, shape, False, "torch.bfloat16")})
    return rec


# ---------------------------------------------------------------------------
# phase 19: bench.py::bench_resnet50 (bench.py:193-268), BASELINE config 1
# ---------------------------------------------------------------------------
# resnet50 NHWC with the space-to-depth stem, 1000 classes, batch 256 x
# 224^2 x 3, bf16 O1, Momentum(lr 0.1, momentum 0.9, weight decay 1e-4),
# FLAGS_fast_bn_stats on; the sub-runs at batch 8 x 64^2 in f32
RESNET_BATCH, RESNET_HW = 256, 224
RESNET_SUB_BATCH, RESNET_SUB_HW = 8, 64
# bench.py's count: ResNet-50's forward takes 4.09 GFLOP an image at
# 224^2, a training step 3x the forward
RESNET_TRAIN_FLOP = 3 * 4.09e9
# ResNet-50's 53 batch norms, two buffers each
RESNET50_BUFFERS = 106
# the optimizers held graph == eager on resnet18 (Momentum's graph is the
# main run's, and the graph-vs-eager sub-run's), each with its decay
RESNET_OPTIMIZERS = (
    ("SGD", dict(weight_decay=1e-4)),
    ("Momentum", dict(momentum=0.9, use_nesterov=True, weight_decay=1e-4)),
    ("Adamax", dict(weight_decay=1e-4)),
    ("Adagrad", dict(weight_decay=1e-4)),
    ("RMSProp", dict(centered=True, momentum=0.5, weight_decay=1e-4)),
    ("Lamb", dict()),
    ("Adadelta", dict(weight_decay=1e-4)),
    ("AdamW8bitStub", dict()),
)


def _resnet_train_step(arch="resnet50", opt="Momentum", lr=0.1, amp=True,
                       seed=0, **opt_kw):
    """bench_resnet50's step: an f32 `arch` (NHWC, space-to-depth stem,
    1000 classes, random weights from `seed`) trained by TrainStep with
    optimizer `opt` (default bench's Momentum(lr, 0.9, weight decay
    1e-4)), the forward under bf16 O1 auto_cast when `amp`, the loss
    cross_entropy of the logits outside it."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import optimizers
    from paddle_tpu_torch.vision import models
    model = getattr(models, arch)(data_format="NHWC",
                                  space_to_depth_stem=True, seed=seed)
    model.train()
    if opt == "Momentum" and not opt_kw:
        opt_kw = dict(momentum=0.9, weight_decay=1e-4)
    optimizer = getattr(optimizers, opt)(
        learning_rate=lr, parameters=_torch_params(model), **opt_kw)

    def loss_fn(m, x, y):
        with tamp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            logits = m(x)
        return F.cross_entropy(logits, y)

    return model, TrainStep(model, optimizer, loss_fn)


def _images(batch, hw, seed, channels_last=True):
    """Images (on the card) and int32 labels of 1000 classes, from a
    numpy seed."""
    import torch
    rng = np.random.default_rng(seed)
    shape = (batch, hw, hw, 3) if channels_last else (batch, 3, hw, hw)
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.integers(0, 1000, (batch,)).astype(np.int32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _same_buffers(model, before):
    """Every buffer of `model` bit-equal to `before` (a copy, in order)."""
    import torch
    now = list(_torch_buffers(model))
    return len(now) == len(before) and all(
        torch.equal(a, b) for a, b in zip(now, before))


@contextlib.contextmanager
def _f32_exact():
    """Checking only: TF32 off for cuBLAS and cuDNN (the reference's f32
    convolutions run at Precision.HIGHEST) and cuDNN deterministic while
    the block runs; the three flags put back after it."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def _image_update(step) -> dict:
    """The main run's optimizer update alone, on the model's parameters
    and velocities with gradients from a seed (measurement after the
    run): its launches on the card (torch.profiler's device events of
    one call), its device time by CUDA-graph replay, and its byte bound
    (each parameter read and written, its gradient read, its velocity
    read and written, in f32)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    opt = step.optimizer
    gen = torch.Generator(device="cuda").manual_seed(0)
    items = [(p, torch.randn(p.shape, device="cuda", generator=gen) * 1e-3,
              opt._param_groups[0]) for p in step._params]
    opt._update_in_place(items, masters=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt._update_in_place(items, masters=False)
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    ms = graph_ms(lambda: opt._update_in_place(items, masters=False),
                  reps=3, iters=5)
    n = sum(p.numel() for p in step._params)
    return dict(update_tensors=len(items), update_launches=launches,
                update_ms_graph=ms,
                update_bound_ms=20.0 * n / HBM_BYTES_PER_S * 1e3,
                update_bound_by="bytes")


def _nhwc(model) -> bool:
    return getattr(model, "data_format", "NCHW") == "NHWC"


def _image_train_main(tag, build, config, n_buffers, flop, warmup=2,
                      steps=10) -> dict:
    """bench_resnet50's config through TrainStep's graph for the model
    and step `build()` makes: RESNET_BATCH x RESNET_HW^2 images in the
    model's layout, `warmup` + `steps` calls, checked and timed; MFU
    from `flop(model)`, a step's FLOPs an image by bench.py's
    convention."""
    import torch
    b, hw = RESNET_BATCH, RESNET_HW
    held = _fresh_card()
    model, step = build()
    n_params = sum(p.numel() for p in _torch_params(model))
    x, y = _images(b, hw, 0, channels_last=_nhwc(model))
    before = [t.detach().clone() for t in _torch_buffers(model)]
    torch.cuda.reset_peak_memory_stats()
    run = _counted_steps(step, (x, y), warmup + steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_calls = warmup + steps
    _check(tag, {
        "every loss finite": all(np.isfinite(run["losses"])),
        "every returned loss a tensor of its own": run["distinct"],
        "the first call eager and captured, every later call a replay": (
            run["captures"], run["replays"]) == (
            {"train_step": 1}, {"train_step": n_calls - 1}),
        f"{n_buffers} batch-norm buffers, every one bit-equal to its "
        f"value before the run": len(before) == n_buffers
            and _same_buffers(model, before),
        "no kernel of the port on this path (B1, B2, the Adam update) and "
        "no plain version": run["counted"] == (0, 0, 0)
            and run["plain"] == (0, 0) and run["update_plain"] == 0,
        "no AccumulateGrad stream-mismatch warning":
            run["stream_warnings"] == 0,
    }, run)
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    del graph
    timed = run["step_s"][warmup:]
    wall_ms = 1e3 * statistics.median(timed)
    img_s = b / (wall_ms / 1e3)
    per_image = flop(model)
    rec = dict(
        config=config, batch=b, image=hw, params=n_params,
        buffers=len(before), held_at_start_gb=held,
        train_flop_per_image=per_image, timed_steps=steps,
        step_ms_median=wall_ms, step_ms=[1e3 * t for t in timed],
        first_step_ms=1e3 * run["step_s"][0], capture_s=run["capture_s"],
        captures=run["captures"], replays=run["replays"],
        step_ms_replay=replay_ms, idle_share=1 - replay_ms / wall_ms,
        images_per_s=img_s, mfu=per_image * img_s / BF16_FLOPS_PER_S,
        step_floor_ms=per_image * b / BF16_FLOPS_PER_S * 1e3,
        peak_mem_gb=peak, stream_warnings=run["stream_warnings"],
        losses=run["losses"])
    rec.update(_image_update(step))
    log(f"{tag} {n_params} params, batch {b} x {hw}^2: step "
        f"median {wall_ms:.2f} ms by wall ({min(rec['step_ms']):.2f}-"
        f"{max(rec['step_ms']):.2f} over {steps}), {replay_ms:.2f} ms by "
        f"replay (device idle {100 * rec['idle_share']:.1f} %); "
        f"{img_s:.1f} images/s, MFU {rec['mfu']:.4f} ({per_image / 1e9:.3f}"
        f" GFLOP an image a step, bench.py's convention; floor "
        f"{rec['step_floor_ms']:.2f} ms); peak mem {peak:.2f} GiB; first "
        f"call {rec['first_step_ms']:.0f} ms (capture "
        f"{run['capture_s']:.2f} s); the update alone "
        f"{rec['update_ms_graph']:.3f} ms by replay, "
        f"{rec['update_launches']} launches over {rec['update_tensors']} "
        f"tensors (byte bound {rec['update_bound_ms']:.4f} ms); buffers "
        f"unchanged; losses {[round(v, 4) for v in run['losses']]}")
    del model, step, x, y
    _fresh_card()
    return rec


def _resnet_main() -> dict:
    """bench_resnet50's config through TrainStep's graph (phase 19's main
    run)."""
    return _image_train_main(
        "[train-resnet50]", _resnet_train_step,
        "resnet50 (bench_resnet50), NHWC, s2d stem, bf16 O1, Momentum, "
        "FLAGS_fast_bn_stats", RESNET50_BUFFERS,
        lambda m: RESNET_TRAIN_FLOP)


def _image_graph_vs_eager(build, n_steps=PARITY_STEPS, seed=1) -> dict:
    """`n_steps` TrainStep calls through the graph of the model and step
    `build()` makes, then as many eager steps of another from the same
    seed, on one batch of RESNET_SUB_BATCH x RESNET_SUB_HW^2 images in
    the model's layout,
    held by phase 7's rule (_held_to); each run's buffers after its
    steps bit-equal to before, and its AccumulateGrad stream-mismatch
    warnings counted."""
    runs = {}
    for eager in (False, True):
        model, step = build()
        x, y = _images(RESNET_SUB_BATCH, RESNET_SUB_HW, seed,
                       channels_last=_nhwc(model))
        step._eager = eager
        before = [t.detach().clone() for t in _torch_buffers(model)]
        with stream_mismatch_warnings() as warned:
            losses = [float(step(x, y)) for _ in range(n_steps)]
        runs[eager] = dict(losses=losses, params=_state(model),
                           buffers_kept=_same_buffers(model, before),
                           stream_warnings=len(warned),
                           captures=len(step._graphs))
        lr = step.optimizer.get_lr()
        del model, step
    g, e = runs[False], runs[True]
    bit_equal = all(bool((a == b).all()) for a, b in zip(g["params"],
                                                          e["params"]))
    cmp = _held_to(g["losses"], e["losses"], g.pop("params"),
                   e.pop("params"), lr, n_steps)
    ok = cmp["ok"] and g["buffers_kept"] and e["buffers_kept"] \
        and g["stream_warnings"] == e["stream_warnings"] == 0 \
        and (g["captures"], e["captures"]) == (1, 0) \
        and all(np.isfinite(g["losses"] + e["losses"]))
    return dict(graph=g, eager=e, bit_equal=bit_equal, **dict(cmp, ok=ok))


def _log_resnet_parity(label, res):
    g, e = res["graph"], res["eager"]
    log(f"[train-resnet50] {label}: graph steps vs eager steps, losses "
        f"{[round(v, 5) for v in g['losses']]} vs "
        f"{[round(v, 5) for v in e['losses']]} (max rel diff "
        f"{res['loss_max_rel_diff']:.2e}, tol 1e-5); params max abs diff "
        f"{res['param_max_abs_diff']:.3e} (bound {res['param_bound']:.1e}),"
        f" {res['params_far']} of {res['params_total']} beyond 1e-3*lr; "
        f"bit-equal {res['bit_equal']}; buffers kept graph "
        f"{g['buffers_kept']}, eager {e['buffers_kept']}; stream warnings "
        f"{g['stream_warnings']}/{e['stream_warnings']}: "
        f"{'ok' if res['ok'] else 'FAILED'}")


def _resnet_layout() -> dict:
    """NHWC with the space-to-depth stem against NCHW with the plain stem,
    the same weights (seed 2), eval logits of RESNET_SUB_BATCH images of
    RESNET_SUB_HW^2 in f32 with TF32 off. Tolerance: the reference's
    5e-5 (tests/test_s2d_stem.py:42, between two NHWC models) plus 1e-5
    of the largest logit, since cuDNN takes other algorithms, summing in
    other orders, in the two layouts."""
    import torch
    from paddle_tpu_torch.vision.models import resnet50
    nchw = resnet50(data_format="NCHW", seed=2)
    nhwc = resnet50(data_format="NHWC", space_to_depth_stem=True, seed=3)
    nhwc.load_state_dict(_torch_state(nchw))
    nchw.eval()
    nhwc.eval()
    x, _ = _images(RESNET_SUB_BATCH, RESNET_SUB_HW, 2)
    with torch.no_grad():
        want = nchw(x.permute(0, 3, 1, 2).contiguous())
        got = nhwc(x)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = 5e-5 + 1e-5 * scale
    rec = dict(batch=RESNET_SUB_BATCH, image=RESNET_SUB_HW,
               max_abs_err=err, largest_logit=scale, tol=tol,
               ok=bool(err <= tol))
    log(f"[train-resnet50] layout: NHWC + s2d eval logits vs NCHW plain "
        f"stem, f32 (TF32 off), batch {RESNET_SUB_BATCH} x "
        f"{RESNET_SUB_HW}^2: max abs diff {err:.3e} (largest logit "
        f"{scale:.3e}, tol {tol:.3e}): {'ok' if rec['ok'] else 'FAILED'}")
    del nchw, nhwc
    return rec


def resnet_train_phase() -> dict:
    """Phase 19: bench_resnet50's config (BASELINE config 1) through
    TrainStep's graph, 2 + 10 calls, FLAGS_fast_bn_stats on; then, in f32
    with TF32 off and cuDNN deterministic, resnet50 (NHWC + s2d, b8 x
    64^2, Momentum lr 0.01) through 3 graph steps held to 3 eager steps,
    NHWC + s2d eval logits held to NCHW's, and each ported optimizer's 3
    graph steps held to 3 eager steps on resnet18 at b8 x 64^2 (lr
    1e-3). The flag is put back after the phase."""
    from paddle_tpu_torch import get_flags, set_flags
    flag = "FLAGS_fast_bn_stats"
    saved = get_flags(flag)
    set_flags({flag: True})
    try:
        rec = _resnet_main()
        with _f32_exact():
            sub = _image_graph_vs_eager(lambda: _resnet_train_step(
                lr=0.01, amp=False, seed=1))
            _log_resnet_parity("resnet50 f32, batch "
                               f"{RESNET_SUB_BATCH} x {RESNET_SUB_HW}^2, "
                               "Momentum lr 0.01", sub)
            rec["graph_vs_eager"] = sub
            rec["layout"] = _resnet_layout()
            opts = {}
            for name, kw in RESNET_OPTIMIZERS:
                res = _image_graph_vs_eager(
                    lambda: _resnet_train_step("resnet18", name, lr=1e-3,
                                               amp=False, seed=4, **kw))
                _log_resnet_parity(f"resnet18 f32, {name} {kw}", res)
                opts[name] = res
            rec["optimizers"] = opts
        _fresh_card()
    finally:
        set_flags(saved)
    _check("[train-resnet50]", {
        "graph steps == eager steps (phase 7's rule), buffers kept":
            rec["graph_vs_eager"]["ok"],
        "NHWC + s2d logits == NCHW logits": rec["layout"]["ok"],
        "every optimizer's graph steps == its eager steps, buffers kept":
            all(r["ok"] for r in rec["optimizers"].values()),
    }, {k: rec[k] for k in ("graph_vs_eager", "layout", "optimizers")})
    return rec


def _launches_17_18(runs, i):
    """B1's (i = 0), B2's (1) or the update's (2) launches in the runs of
    phases 17-18: counted over the eager first step and the capture, and
    run on the card (the captured ones once a replay)."""
    out = {}
    for name, rec in runs:
        out[f"launches_{name}"] = rec["launches_counted"][i]
        out[f"launches_on_device_{name}"] = rec["launches_on_device"][i]
    return out


# ---------------------------------------------------------------------------
# phase 20: speculative decoding at bench_spec_decode's configuration
# ---------------------------------------------------------------------------
# bench.py::bench_spec_decode (bench.py:988-1020), its TPU configuration,
# uncut: gpt3_1p3b's widths (vocab 50304, hidden 2048, 24 layers, 16
# heads, max_position 2048) in bf16; max_batch 8, block 64, decode_chunk
# 16, prompt_quantum 128, prefix caching off; 16 requests, each a 16-token
# pattern tiled 8 times, 128 new tokens each; n-gram drafting with k = 7,
# against the same engine without speculation
SPEC_ENGINE = dict(max_batch=8, block_size=64, decode_chunk=16,
                   prompt_quantum=128, enable_prefix_caching=False)
SPEC_K = 7
SPEC_NEW = 128
# the self-drafting sub-run's bar: a model drafting for itself accepts
# every draft whose greedy pick the verify wave agrees with
SELF_DRAFT_MIN_RATE = 0.95


def _spec_prompts(vocab, n=16, pat_len=16, reps=8, seed=0):
    """bench_spec_decode's traffic: each prompt a random `pat_len`-token
    pattern tiled `reps` times."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, (pat_len,)).astype(np.int32),
                    reps) for _ in range(n)]


def _serve_timed(eng, prompts, n_new, after_step=None):
    """Serve `prompts` through `eng` to the end: (results by id, wall s,
    steps, the verify waves' record: waves, B3 launches and launches by
    design counted around each, their wall s). `after_step(eng, n)` runs
    after step n (the lifecycle faults)."""
    import torch
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    f = rpa.ragged_paged_attention
    verify = dict(waves=0, launches=0, wall_s=0.0,
                  designs=dict.fromkeys(f.design_launches, 0))
    run_ragged = eng._run_ragged

    def counted(entries):
        if not entries[0][3]:                   # a prefill wave
            return run_ragged(entries)
        n0, d0 = f.kernel_launches, dict(f.design_launches)
        t = time.perf_counter()
        r = run_ragged(entries)                 # ends in a host copy
        verify["wall_s"] += time.perf_counter() - t
        verify["waves"] += 1
        verify["launches"] += f.kernel_launches - n0
        for d in d0:
            verify["designs"][d] += f.design_launches[d] - d0[d]
        return r

    eng._run_ragged = counted
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=n_new)
    done, steps = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_unfinished:
        for r in eng.step():
            done[r.request_id] = r
        steps += 1
        if after_step is not None:
            after_step(eng, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._run_ragged = run_ragged
    return done, wall, steps, verify


def _guard_lengths(model, prompts, outputs, margin=None):
    """For each request, how many leading tokens of `outputs[i]` sit at
    positions whose top-1/top-2 margin, in `model`'s logits over prompt +
    output, is at least `margin`; margin None: twice those logits' own
    rounding error, their largest difference over the request from the
    same weights' logits in f32 (TF32 off), as phase 16's guard. Two runs
    that round at other places, each within that error of exact, may
    legitimately differ past a narrower race. Returns (lengths,
    margins)."""
    import copy
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = copy.deepcopy(model).float() if margin is None else None
    lengths, margins = [], []
    with torch.no_grad():
        for p, out in zip(prompts, outputs):
            seq = torch.as_tensor(np.concatenate([p, out])[None].astype(
                np.int64), device=model.device)
            lg = model(seq)[0, len(p) - 1:-1].float()
            m = margin
            if m is None:
                m = 2 * float((m32(seq)[0, len(p) - 1:-1] - lg).abs().max())
            top2 = torch.topk(lg, 2, dim=-1).values
            low = np.flatnonzero((top2[:, 0] - top2[:, 1]).cpu().numpy() < m)
            lengths.append(int(low[0]) if len(low) else len(out))
            margins.append(m)
    del m32
    torch.cuda.empty_cache()
    return lengths, margins


def _mismatched(want, got, lengths):
    """Requests whose `got` tokens differ from `want`'s within their
    guarded lengths."""
    return [i for i, n in enumerate(lengths)
            if not np.array_equal(np.asarray(got[i])[:n],
                                  np.asarray(want[i])[:n])]


def _spec_self_draft(kw) -> dict:
    """Phase 20's sub-run: 2 layers at gpt3_1p3b's widths in f32 (TF32
    off), DraftModelProposer(model) drafting for the model itself (the
    reference's acceptance oracle, test_spec_decode.py:254) on four of
    the phase's prompts (32 new tokens), against the same engine without
    speculation under the margin guard (1e-3, phase 5's)."""
    import torch
    from paddle_tpu_torch.inference import (DraftModelProposer, LLMEngine,
                                            SpeculativeConfig)
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
    model = GPTForCausalLM(cfg, dtype="float32", seed=1)
    prompts = _spec_prompts(cfg.vocab_size, n=4, seed=1)
    n_new = 32
    on = LLMEngine(model, speculative_config=SpeculativeConfig(
        proposer=DraftModelProposer(model), num_speculative_tokens=SPEC_K),
        **kw)
    t = time.perf_counter()
    got = [r.output_ids for r in on.generate(prompts, n_new)]
    on_s = time.perf_counter() - t
    want = [r.output_ids for r in LLMEngine(model, **kw).generate(
        prompts, n_new)]
    lengths, _m = _guard_lengths(model, prompts, want, margin=1e-3)
    st = on.stats
    rate = st["spec_accepted_tokens"] / max(st["spec_drafted_tokens"], 1)
    rec = dict(spec_steps=st["spec_steps"],
               drafted=st["spec_drafted_tokens"],
               accepted=st["spec_accepted_tokens"], acceptance_rate=rate,
               guarded=lengths, mismatched=_mismatched(want, got, lengths),
               run_s=on_s)
    del on, model
    torch.cuda.empty_cache()
    return rec


def spec_phase() -> dict:
    """Phase 20: bench_spec_decode's configuration served with n-gram
    speculation and without (each engine warmed on two of the requests
    first, then timed on all 16); the verify waves' B3 launches counted
    around each wave; spec-on tokens held to spec-off's under the margin
    guard; then the lifecycle sub-run (spec off, full width: one request
    poisoned at engine.decode.seq, one aborted, one past its deadline on
    an injected clock) against the clean run, and the self-drafting
    sub-run."""
    import torch
    from paddle_tpu_torch.inference import LLMEngine, SpeculativeConfig
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.resilience import faults
    cfg = gpt3_1p3b()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, dtype="bfloat16", seed=0)
    setup_s = time.perf_counter() - t0
    prompts = _spec_prompts(cfg.vocab_size)
    kw = dict(SPEC_ENGINE, max_model_len=cfg.max_position_embeddings)
    f = rpa.ragged_paged_attention
    runs = {}
    for spec in (True, False):
        eng = LLMEngine(model, speculative_config=SpeculativeConfig(
            "ngram", num_speculative_tokens=SPEC_K) if spec else None, **kw)
        _serve_timed(eng, prompts[:2], SPEC_NEW)        # warm-up
        before = dict(eng.stats)
        eng.peak_used_blocks = 0
        rpa.reset_counters()
        done, wall, steps, verify = _serve_timed(eng, prompts, SPEC_NEW)
        st = {k: eng.stats[k] - before[k] for k in eng.stats}
        n_tok = sum(len(r.output_ids) for r in done.values())
        runs[spec] = dict(
            done=done, tokens=n_tok, run_s=wall, tokens_per_s=n_tok / wall,
            steps=steps, step_ms_mean=1e3 * wall / steps, stats=st,
            peak_used_blocks=eng.peak_used_blocks,
            pages_back=eng.cache.available_blocks
            == eng.cache.allocator.num_blocks - 1,
            b3_launches=f.kernel_launches, b3_plain_calls=f.plain_calls,
            b3_designs=dict(f.design_launches), verify=verify)
        del eng
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    want = [off["done"][i].output_ids for i in range(len(prompts))]
    got = [on["done"][i].output_ids for i in range(len(prompts))]
    lengths, margins = _guard_lengths(model, prompts, want)
    mism = _mismatched(want, got, lengths)
    st, v = on["stats"], on["verify"]
    layers = cfg.num_layers
    ok_tokens = all(
        r.finish_reason == "length" and len(r.output_ids) == SPEC_NEW
        and ((r.output_ids >= 0) & (r.output_ids < cfg.vocab_size)).all()
        for run in (on, off) for r in run["done"].values())

    # lifecycle sub-run: the clean run is the spec-off run above
    clock = [0.0]
    eng = LLMEngine(model, **kw)
    eng._now = lambda: clock[0]
    poisoned, aborted, expired = 3, 5, 7
    life = {}

    def after_step(e, n):
        if n == 1:
            life["abort_hit"] = e.abort_request(aborted)
        if n == 2:
            clock[0] = 100.0                # request 7's deadline passes

    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=SPEC_NEW,
                        deadline_s=10.0 if i == expired else None)
    with faults.inject("engine.decode.seq",
                       exc=MemoryError("chaos decode OOM"),
                       match={"rid": poisoned}):
        ldone, _w, _s, _v = _serve_timed(eng, [], SPEC_NEW, after_step)
    others = [i for i in range(len(prompts))
              if i not in (poisoned, aborted, expired)]
    lmism = [i for i in others if not np.array_equal(
        ldone[i].output_ids[:lengths[i]], want[i][:lengths[i]])]
    lst = eng.stats
    life.update(
        reasons={i: ldone[i].finish_reason for i in sorted(ldone)},
        poisoned_error=ldone[poisoned].error, mismatched=lmism,
        stats={k: lst[k] for k in ("failed_requests", "aborted_requests",
                                   "deadline_expired", "decode_chunks")},
        pages_back=eng.cache.available_blocks
        == eng.cache.allocator.num_blocks - 1)
    del eng, model
    torch.cuda.empty_cache()
    self_draft = _spec_self_draft(kw)

    checks = {
        f"every request returned {SPEC_NEW} in-vocab tokens, both runs":
            ok_tokens,
        f"speculation ran ({st['spec_steps']} spec steps)":
            st["spec_steps"] > 0,
        "no spec step degraded, no proposer error":
            st["spec_step_errors"] == st["spec_proposer_errors"] == 0,
        f"one verify wave a spec step ({v['waves']})":
            v["waves"] == st["spec_steps"],
        f"B3 once a layer a verify wave ({v['launches']} launches)":
            v["launches"] == layers * v["waves"],
        "every verify-wave B3 launch sm90":
            v["designs"] == {d: v["launches"] * (d == "sm90")
                             for d in v["designs"]},
        "plain version never ran on CUDA tensors":
            on["b3_plain_calls"] == off["b3_plain_calls"] == 0,
        f"spec-on tokens == spec-off tokens under the margin guard "
        f"(compared {sum(lengths)} of {SPEC_NEW * len(prompts)})":
            not mism and sum(lengths) > 0,
        "every page back in the pool, both runs":
            on["pages_back"] and off["pages_back"],
        "lifecycle: poisoned request failed alone (error), one aborted, "
        "one past its deadline, the rest finished":
            life["abort_hit"]
            and life["reasons"] == {
                i: {poisoned: "error", aborted: "aborted",
                    expired: "deadline"}.get(i, "length")
                for i in range(len(prompts))}
            and "chaos decode OOM" in (life["poisoned_error"] or ""),
        "lifecycle: the others' tokens == the clean run's under the guard":
            not lmism,
        "lifecycle: stats (2 failed, 1 aborted, 1 expired), every page "
        "back": life["stats"]["failed_requests"] == 2
            and life["stats"]["aborted_requests"] == 1
            and life["stats"]["deadline_expired"] == 1
            and life["pages_back"],
        f"self-drafting acceptance rate "
        f"{self_draft['acceptance_rate']:.4f} >= {SELF_DRAFT_MIN_RATE}":
            self_draft["drafted"] > 0
            and self_draft["acceptance_rate"] >= SELF_DRAFT_MIN_RATE,
        "self-drafting tokens == spec-off tokens under the guard":
            not self_draft["mismatched"] and sum(self_draft["guarded"]) > 0,
    }
    for what, ok in checks.items():
        log(f"[spec] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"spec phase failed: spec-on {st}, verify {v}, "
                           f"mismatched {mism}, lifecycle {life}, "
                           f"self-draft {self_draft}")
    rec = dict(
        config="bench_spec_decode (gpt3_1p3b, bf16)", setup_s=setup_s,
        guarded=lengths, margins=margins, lifecycle=life,
        self_draft=self_draft,
        accepted_per_step=st["spec_accepted_tokens"] / st["spec_steps"],
        acceptance_rate=st["spec_accepted_tokens"]
        / max(st["spec_drafted_tokens"], 1),
        verify_wave_ms_mean=1e3 * v["wall_s"] / v["waves"],
        speedup=on["tokens_per_s"] / off["tokens_per_s"])
    for name, run in (("spec_on", on), ("spec_off", off)):
        rec[name] = {k: run[k] for k in (
            "tokens", "run_s", "tokens_per_s", "steps", "step_ms_mean",
            "stats", "peak_used_blocks", "b3_launches", "b3_designs",
            "verify")}
    log(f"[spec] bench_spec_decode: spec on {on['tokens_per_s']:.1f} "
        f"tokens/s ({on['steps']} steps, {st['spec_steps']} spec steps, "
        f"{st['spec_drafted_tokens']} drafted, {st['spec_accepted_tokens']} "
        f"accepted, {rec['accepted_per_step']:.3f} accepted a spec step, "
        f"{st['decode_chunks']} decode chunks; verify waves "
        f"{rec['verify_wave_ms_mean']:.2f} ms each by wall, "
        f"{v['launches']} B3 launches {v['designs']}; peak "
        f"{on['peak_used_blocks']} blocks) against spec off "
        f"{off['tokens_per_s']:.1f} tokens/s ({off['steps']} steps, peak "
        f"{off['peak_used_blocks']} blocks): x{rec['speedup']:.3f}; "
        f"self-drafting (2 layers, f32) acceptance "
        f"{self_draft['acceptance_rate']:.4f} over "
        f"{self_draft['drafted']} drafts; lifecycle {life['reasons']}; "
        f"card {card_line()}")
    return rec


# ---------------------------------------------------------------------------
# phase 21: int8 pools at gpt3_1p3b with phase 4's traffic
# ---------------------------------------------------------------------------
# phase 4's engine
SERVE_ENGINE = dict(max_batch=8, block_size=64, decode_chunk=16,
                    prompt_quantum=128)


def _plain_int8_run(model, engine_kw, prompts, n_new):
    """The int8 engine's tokens with its decode steps eager and B3 on
    its plain version (checking only), and each request's top-1/top-2
    logit margin at each token it sampled, read from the logits of that
    run's own sampling calls."""
    import functools
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    eng = LLMEngine(model, **engine_kw)
    eng._eager_decode = True
    margins = {i: [] for i in range(len(prompts))}
    rows = []                   # the slots whose token a call samples
    saved = (eng_mod.ragged_paged_attention, eng_mod._pick_token)

    def pick(lf, *a):
        top2 = torch.topk(lf, 2, dim=-1).values
        m = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        for b in rows:
            margins[eng.slots[b].rid].append(float(m[b]))
        return saved[1](lf, *a)

    run_ragged, launch = eng._run_ragged, eng._launch_decode_chunk

    def wave(entries):
        rows[:] = [e[0].slot for e in entries]
        return run_ragged(entries)

    def chunk(lease):
        rows[:] = [] if lease is None else [s.slot for s in lease[0]]
        return launch(lease)

    eng._run_ragged, eng._launch_decode_chunk = wave, chunk
    eng_mod.ragged_paged_attention = functools.partial(
        saved[0], path="torch")
    eng_mod._pick_token = pick
    try:
        res = eng.generate(prompts, max_new_tokens=n_new)
    finally:
        eng_mod.ragged_paged_attention, eng_mod._pick_token = saved
    pool = eng.cache.key_caches[0]
    out = dict(tokens=[r.output_ids for r in res],
               margins=[margins[i][:n_new] for i in range(len(prompts))],
               pool_dtype=pool.dtype,
               pool_bytes=sum(t.numel() * t.element_size()
                              for t in eng.cache.key_caches
                              + eng.cache.value_caches),
               pool_numel=sum(t.numel() for t in eng.cache.key_caches
                              + eng.cache.value_caches))
    del eng
    torch.cuda.empty_cache()
    return out


def int8_engine_phase() -> dict:
    """Phase 21: gpt3_1p3b (bf16, 24 layers, seed 0) served with int8
    pools on phase 4's traffic, the scales from calibrate_kv_scales on
    the first prompt. B3's launches recorded by design and by whether
    they carried dequant scales; the tokens held to phase 4's bf16
    engine's (at least half equal, the reference's bar) and to the same
    engine run with its decode eager and B3 on its plain version (under
    the guard of that run's own logit margins against twice the bf16
    logits' rounding error)."""
    import torch
    from paddle_tpu_torch.inference import calibrate_kv_scales
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    torch.backends.cuda.matmul.allow_tf32 = False
    hold = {}

    def build():
        cfg = gpt3_1p3b()
        return GPTForCausalLM(cfg, dtype="bfloat16", seed=0), cfg

    def engine_kw(model, prompts):
        hold["kw"] = dict(SERVE_ENGINE, kv_quant_scales=calibrate_kv_scales(
            model, prompts[0][None]))
        return hold["kw"]

    def b3_check(designs, launches):
        return ("B3: sm90 for the fresh waves, the simple design for the "
                "prefix-resume waves over the int8 pools",
                designs["sm90"] > 0 and designs["simple"] > 0
                and sum(designs.values()) == launches)

    calls = []                  # (design, carried dequant scales)
    launch = rpa._ragged_cuda

    def recorded(*a, **kw):
        d0 = dict(rpa.ragged_paged_attention.design_launches)
        out = launch(*a, **kw)
        moved = [d for d, n in rpa.ragged_paged_attention
                 .design_launches.items() if n != d0[d]]
        calls.append((moved[0], kw.get("kdq") is not None
                      and kw.get("with_pool", True)))
        return out

    def oracle(model, prompts, done):
        n_new = len(done[0].output_ids)
        plain = _plain_int8_run(model, hold["kw"], prompts, n_new)
        got = [done[i].output_ids for i in range(len(prompts))]
        noise_len, noise = _guard_lengths(model, prompts[:1],
                                          [plain["tokens"][0]])
        lengths = []
        for m in plain["margins"]:
            low = np.flatnonzero(np.asarray(m) < noise[0])
            lengths.append(int(low[0]) if len(low) else len(m))
        bf16 = SERVED["gpt3_1p3b", "bfloat16", "bfloat16"]
        agree = float(np.mean([np.mean(got[i] == bf16[i])
                               for i in range(len(prompts))]))
        return dict(plain_guarded=lengths, plain_margin=noise[0],
                    plain_mismatched=_mismatched(plain["tokens"], got,
                                                 lengths),
                    plain_b3_calls=rpa.ragged_paged_attention.plain_calls,
                    bf16_agreement=agree,
                    pool_dtype=str(plain["pool_dtype"]),
                    pool_bytes=plain["pool_bytes"],
                    bf16_pool_bytes=2 * plain["pool_numel"])

    rpa._ragged_cuda = recorded
    try:
        rec = serve_phase("gpt3_1p3b int8", build, engine_kw,
                          oracle=oracle, b3_check=b3_check)
    finally:
        rpa._ragged_cuda = launch
    dequant = sum(1 for d, dq in calls if dq)
    simple_dequant = sum(1 for d, dq in calls if dq and d == "simple")
    checks = {
        "the pools are torch.int8, at half of bf16's bytes":
            rec["pool_dtype"] == "torch.int8"
            and 2 * rec["pool_bytes"] == rec["bf16_pool_bytes"],
        f"B3's simple design launched with dequant scales "
        f"({simple_dequant} of {dequant} dequant launches)":
            simple_dequant == dequant > 0,
        f"tokens equal to the bf16 engine's at >= half the positions "
        f"({rec['bf16_agreement']:.4f})": rec["bf16_agreement"] >= 0.5,
        f"tokens == the eager, plain-B3 run's under the guard (compared "
        f"{sum(rec['plain_guarded'])})":
            not rec["plain_mismatched"] and sum(rec["plain_guarded"]) > 0
            and rec["plain_b3_calls"] > 0,
    }
    for what, ok in checks.items():
        log(f"[int8] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"int8 phase failed: {checks}")
    rec.update(b3_dequant_launches=dequant,
               b3_simple_dequant_launches=simple_dequant,
               b3_launches_by_design={
                   d: sum(1 for c, _ in calls if c == d)
                   for d in rpa._RPA_DESIGNS})
    log(f"[int8] gpt3_1p3b int8 pools: {rec['tokens_per_s']:.1f} tokens/s, "
        f"decode {rec['decode_ms_per_step']:.2f} ms a step (a step by "
        f"replay {rec['decode_step_replay_ms']:.3f} ms, attention "
        f"{100 * rec['decode_attention_share']:.1f} %), pools "
        f"{rec['pool_bytes'] / 2 ** 30:.3f} GiB (bf16 "
        f"{rec['bf16_pool_bytes'] / 2 ** 30:.3f}); B3 "
        f"{rec['b3_launches_by_design']}, {dequant} with dequant; "
        f"agreement with bf16 {rec['bf16_agreement']:.4f}; card "
        f"{card_line()}")
    return rec


# ---------------------------------------------------------------------------
# phase 22: the eager API
# ---------------------------------------------------------------------------
# the op sweep's limits, CUDA Tensors against CPU Tensors (rtol = atol):
# each case's own (tests/eager_op_cases.py) and at least 1e-5 for
# values and 1e-4 for grads: the card's f32 kernels (TF32 off) sum in
# other orders than the CPU's, and its transcendentals differ by a few
# ulps; the flash kernels' f32 design against the CPU's composite (the
# attention cases) stays within the cases' 1e-4
SWEEP_TOL, SWEEP_GRAD_TOL = 1e-5, 1e-4
# draws each random op's moments are taken over on the card
SWEEP_DRAWS = 1_000_000
# the range each bounded random op's draws must lie in
# (tests/eager_op_cases.py RANDOM_MOMENTS's parameters; the normals are
# unbounded)
RANDOM_RANGES = {"rand": (0.0, 1.0), "uniform": (-2.0, 3.0),
                 "randint": (0, 9), "bernoulli": (0, 1),
                 "poisson": (0, float("inf")), "binomial": (0, 10),
                 "standard_gamma": (0.0, float("inf")),
                 "exponential": (0.0, float("inf")),
                 "truncated_normal": (-2.0, 2.0)}
EAGER_STEPS = 3
EAGER_LR = 1e-4
# what phase 22 leaves for phases 23 and 28: the GPT's weights, batches
# and the model's eager losses and parameters
EAGER_GPT = {}
# pairs of one dict-script step and one nn.Layer-GPT step timed in turns
ALTERNATE = 4


def _tests_module(name):
    """A module of tests/ that imports numpy only (the op cases, the
    eager GPT script): the same code the CPU tests run."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep_diff(got, want, tol):
    """(largest |got - want|, whether every element is within tol +
    tol * |want|); NaN against NaN and equal infinities agree."""
    kind = np.complex128 if got.dtype.kind == "c" else np.float64
    g, w = got.astype(kind), np.asarray(want).astype(kind)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    d = np.where(same, 0.0, np.abs(g - w))
    ok = bool((same | (d <= tol + tol * np.abs(w))).all())
    return (float(d.max()) if d.size else 0.0), ok


def _sweep_compare(got, want, got_g, want_g, tol, gtol):
    """(largest difference, what disagreed or "") of one case's outputs
    and grads on the card against the CPU's."""
    if len(got) != len(want):
        return float("inf"), f"{len(got)} outputs against {len(want)}"
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), (f"output {i}: {g.shape} {g.dtype} "
                                  f"against {w.shape} {w.dtype}")
        e, ok = _sweep_diff(g, w, tol)
        err = max(err, e)
        if not ok:
            return err, f"output {i} off by {e:.3g} (limit {tol:g})"
    if set(got_g) != set(want_g):
        return err, f"grads of inputs {sorted(got_g)} against " \
                    f"{sorted(want_g)}"
    for k in got_g:
        e, ok = _sweep_diff(got_g[k], want_g[k], gtol)
        err = max(err, e)
        if not ok:
            return err, f"grad of input {k} off by {e:.3g} (limit {gtol:g})"
    return err, ""


def eager_op_sweep(C) -> dict:
    """Every case of tests/eager_op_cases.py (module `C`) on CUDA Tensors
    against the same case on CPU Tensors, values and backward() grads,
    TF32 off; the registry's dispatches on the card are recorded by
    case. Returns the failures, the ops of OPS no case dispatched on the
    card, the ops run and the largest difference by op module."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.ops import OPS, registry
    real = registry.dispatch
    seen = {}
    current = [None]

    def spy(opdef, args, kwargs):
        seen.setdefault(current[0], set()).add(opdef.name)
        return real(opdef, args, kwargs)

    failures, errs = [], {}
    saved_place = tdevice._current_place
    try:
        with _f32_exact():
            for name, fn, opts in C.CASES:
                grad = opts.get("grad", True)
                P.set_device("cpu")
                want, want_g = C.run_case(P, fn, place="cpu", grad=grad)
                P.set_device("gpu:0")
                current[0] = name
                registry.dispatch = spy
                try:
                    got, got_g = C.run_case(P, fn, place="gpu:0", grad=grad)
                finally:
                    registry.dispatch = real
                errs[name], bad = _sweep_compare(
                    got, want, got_g, want_g,
                    max(opts.get("tol", 1e-6), SWEEP_TOL),
                    max(opts.get("grad_tol", 1e-5), SWEEP_GRAD_TOL))
                if bad:
                    failures.append(f"{name}: {bad}")
    finally:
        tdevice._current_place = saved_place
    ran = set().union(*seen.values()) if seen else set()
    nn_cases = {n: errs[n] for n in C.NN_CASES}
    lt_cases = {n: errs[n] for n in C.LONGTAIL_CASES}
    inc_cases = {n: errs[n] for n in C.INCUBATE_CASES}
    os_cases = {n: errs[n] for n in C.OPSURF_CASES}
    by_module = {}
    for name, ops in seen.items():
        for op in ops:
            mod = OPS[op].fn.__module__.removeprefix("paddle_tpu_torch.")
            by_module[mod] = max(by_module.get(mod, 0.0), errs[name])
    return dict(cases=len(C.CASES), ops_in_table=len(OPS),
                ops_run=len(ran), not_run=sorted(set(OPS) - ran),
                failures=failures, max_abs_err_by_module=by_module,
                max_abs_err=max(errs.values()), nn_cases=nn_cases,
                nn_failures=[f for f in failures
                             if f.split(":")[0] in nn_cases],
                longtail_cases=lt_cases,
                longtail_failures=[f for f in failures
                                   if f.split(":")[0] in lt_cases],
                incubate_cases=inc_cases,
                incubate_failures=[f for f in failures
                                   if f.split(":")[0] in inc_cases],
                opsurf_cases=os_cases,
                opsurf_failures=[f for f in failures
                                 if f.split(":")[0] in os_cases])


def eager_random_checks(C) -> dict:
    """The random ops on the card: the same draws under the same seed,
    each draw's shape and dtype as on the CPU, and SWEEP_DRAWS draws of
    each op in RANDOM_MOMENTS within RANDOM_RANGES and its moments
    within eager_op_cases.moments_ok's limits."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    saved_place = tdevice._current_place
    try:
        P.set_device("cpu")
        cpu = C.random_draws(P)
        P.set_device("gpu:0")
        P.seed(11)
        a = [t.numpy() for t in C.random_draws(P)]
        P.seed(11)
        b = C.random_draws(P)
        same = all(np.array_equal(x, y.numpy()) for x, y in zip(a, b))
        layout = all(x.shape == y.shape and x.dtype == y.dtype
                     and x.place == P.CUDAPlace(0)
                     for x, y in zip(b, cpu))
        moments, bad = {}, []
        for name, draw, mean, sd in C.RANDOM_MOMENTS:
            P.seed(2024)
            v = draw(P, SWEEP_DRAWS).numpy()
            ok, m, s = C.moments_ok(v, mean, sd)
            lo, hi = RANDOM_RANGES.get(name, (-np.inf, np.inf))
            ok = ok and bool((v >= lo).all() and (v <= hi).all())
            moments[name] = dict(mean=m, want_mean=mean, sd=s, want_sd=sd,
                                 ok=ok)
            if not ok:
                bad.append(name)
    finally:
        tdevice._current_place = saved_place
    return dict(same_draws_under_seed=same, layout_as_cpu=layout,
                moments=moments, moments_failed=bad)


def _device_ms(prof):
    """The device time torch.profiler recorded (ms): the sum of its
    events' self device time."""
    tot = 0.0
    for e in prof.key_averages():
        tot += getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    return tot / 1e3


def _dispatch_overhead(P, n=5000) -> dict:
    """Host µs of one dispatched op (P.add on two 16-element CUDA
    Tensors) and of the same torch call on their torch tensors, each the
    mean of n calls, synchronised at the end; their difference is the
    registry's overhead."""
    import torch
    a = P.to_tensor(np.ones(16, np.float32), place="gpu:0")
    b = P.to_tensor(np.ones(16, np.float32), place="gpu:0")
    ad, bd = a._data, b._data
    out = {}
    for what, fn in (("dispatched", lambda: P.add(a, b)),
                     ("torch", lambda: torch.add(ad, bd))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[what] = 1e6 * (time.perf_counter() - t) / n
    out["overhead"] = out["dispatched"] - out["torch"]
    return out


def _layer_call_overhead(P, n=20000, rounds=3) -> dict:
    """Host µs that ``Layer.__call__`` adds: a Layer whose forward
    returns its input, called (torch's ``_call_impl``) and its forward
    called directly, n times each, in alternating blocks (`rounds`
    each, the medians kept); and one read of a Parameter by attribute
    (``layer.weight``, the wrapper's cached lookup)."""
    class Noop(P.nn.Layer):
        def forward(self, x):
            return x

    layer, lin = Noop(), P.nn.Linear(16, 16)
    x = P.to_tensor(np.ones((1, 16), np.float32), place="gpu:0")
    times = {"call": [], "forward": [], "weight": []}
    for _ in range(rounds):
        for what, fn in (("call", lambda: layer(x)),
                         ("forward", lambda: layer.forward(x)),
                         ("weight", lambda: lin.weight)):
            t = time.perf_counter()
            for _ in range(n):
                fn()
            times[what].append(1e6 * (time.perf_counter() - t) / n)
    out = {k: statistics.median(v) for k, v in times.items()}
    out["overhead"] = out["call"] - out["forward"]
    return out


_ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "num_sync_all_streams")


def _alloc_counts() -> dict:
    """The caching allocator's counters of device allocations, frees,
    retries and whole-device syncs (None where this torch lacks one)."""
    import torch
    st = torch.cuda.memory_stats()
    return {k: st.get(k) for k in _ALLOC_KEYS}


def _alloc_delta(before) -> dict:
    after = _alloc_counts()
    return {k: None if after[k] is None or before[k] is None
            else after[k] - before[k] for k in _ALLOC_KEYS}


def _profiled_pairs(dict_step, layer_step, pairs=2, top=6) -> dict:
    """Each form's step under torch.profiler (CUDA events), in turns,
    `pairs` times each, both models held: the wall ms, the device ms,
    the idle share, the device events and the allocator's counters of
    each step, and the `top` kernels whose device ms differ most
    between the forms (the means of each form's steps)."""
    from torch.profiler import ProfilerActivity, profile
    out = {"dict": [], "layers": []}
    kernels = {"dict": {}, "layers": {}}
    for _ in range(pairs):
        for what, fn in (("dict", dict_step), ("layers", layer_step)):
            a0 = _alloc_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn()
                wall = 1e3 * (time.perf_counter() - t)
            dev = _device_ms(prof)
            events = 0
            for e in prof.key_averages():
                ms = getattr(e, "self_device_time_total", 0.0) / 1e3
                kernels[what][e.key] = kernels[what].get(e.key, 0.0) \
                    + ms / pairs
                events += e.count
            out[what].append(dict(
                wall_ms=wall, device_ms=dev, device_events=events,
                idle_share=(1 - dev / wall) if dev else None,
                allocator=_alloc_delta(a0)))
    names = set(kernels["dict"]) | set(kernels["layers"])
    diff = sorted(((kernels["layers"].get(n, 0.0)
                    - kernels["dict"].get(n, 0.0), n) for n in names),
                  key=lambda d: -abs(d[0]))[:top]
    out["kernels_most_apart"] = [
        dict(name=n[:80], layers_minus_dict_ms=d,
             dict_ms=kernels["dict"].get(n, 0.0)) for d, n in diff]
    return out


def _step_marks(marks):
    """Per step: wall ms, ops dispatched and B1/B2 launches by design,
    from the marks ``on_step`` took before each step and after the
    last."""
    steps = []
    for (t0, n0, f0, b0), (t1, n1, f1, b1) in zip(marks, marks[1:]):
        steps.append(dict(
            ms=1e3 * (t1 - t0), ops=n1 - n0,
            b1={k: f1[k] - f0[k] for k in f1},
            b2={k: b1[k] - b0[k] for k in b1}))
    return steps


def eager_layer_gpt(P, S, weights, batches, want_losses, want_params,
                    names, L, H, mark, dict_step) -> dict:
    """The GPT of tests/eager_gpt_layer_script.py (``P.nn.Layer``s,
    weights in by ``set_state_dict``, ``AdamW(parameters=
    model.parameters())``) on CUDA Tensors for the batches of phase 22,
    held bit for bit to GPTForCausalLM's eager steps (`want_losses`,
    `want_params` in the order of `names`); `mark()` is taken before
    each step and after the last. Then the save/load round trip: the
    state_dict saved, the file read back with pickle and numpy alone and
    held to the model's values, loaded into a fresh model by
    ``set_state_dict(load(path))``, and one more step from the same
    batch on each model (a fresh AdamW each), bit-equal. Between the
    two, ALTERNATE pairs of one more step of the dict script
    (`dict_step()`, synchronised) and of this model, each timed by
    wall with the allocator's counters around it, then two such pairs
    profiled (``_profiled_pairs``): the two forms compared in turns on
    one card, both models held."""
    import tempfile

    import torch
    marks = []
    losses, model, opt = S.layer_gpt_steps(
        P, weights, batches, L, H, lr=EAGER_LR, amp=True, place="gpu:0",
        on_step=lambda _i: marks.append(mark()))
    marks.append(mark())
    steps = _step_marks(marks)
    sd = model.state_dict()
    keys_ok = list(sd) == names
    got = [sd[k]._data for k in names]
    held = _held_to(losses, want_losses, got, want_params, EAGER_LR,
                    EAGER_STEPS)
    bit_equal = losses == want_losses and all(
        torch.equal(g, w) for g, w in zip(got, want_params))
    del got
    ids_t = P.to_tensor(batches[0][0], place="gpu:0")
    labels_t = P.to_tensor(batches[0][1], place="gpu:0")

    def layer_step():           # dict_step's form, on this model
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = S.layer_gpt_loss(P, model, ids_t, labels_t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()

    pairs = {"dict": [], "layers": []}
    allocs = {"dict": [], "layers": []}
    for _ in range(ALTERNATE):
        for what, fn in (("dict", dict_step), ("layers", layer_step)):
            a0 = _alloc_counts()
            t = time.perf_counter()
            fn()
            pairs[what].append(1e3 * (time.perf_counter() - t))
            allocs[what].append(_alloc_delta(a0))
    profiled = _profiled_pairs(dict_step, layer_step)
    del opt, ids_t, labels_t
    before = {k: v._data.detach().to("cpu", copy=True)
              for k, v in sd.items()}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/gpt2_small.pdparams"
        t = time.perf_counter()
        arrays, fresh, (loss_fresh, loss_orig) = S.round_trip(
            P, model, path, batches[0], L, H, lr=EAGER_LR, amp=True,
            place="gpu:0")
        round_trip_s = time.perf_counter() - t
        file_mb = __import__("os").path.getsize(path) / 2 ** 20
    file_ok = list(arrays) == names and all(
        np.array_equal(arrays[k], before[k].numpy()) for k in names)
    a, b = fresh.state_dict(), model.state_dict()
    step_equal = loss_fresh == loss_orig and all(
        torch.equal(a[k]._data, b[k]._data) for k in names)
    del arrays, before, a, b, fresh, model, sd
    return dict(losses=losses, held_to_model=held, bit_equal=bit_equal,
                keys_are_the_models=keys_ok,
                step_ms=[s["ms"] for s in steps],
                step_ms_after_first=statistics.mean(
                    s["ms"] for s in steps[1:]),
                ops_per_step=[s["ops"] for s in steps],
                b1_by_step=[s["b1"] for s in steps],
                b2_by_step=[s["b2"] for s in steps],
                alternating_ms=pairs, alternating_ms_median={
                    k: statistics.median(v) for k, v in pairs.items()},
                alternating_allocator=allocs, profiled=profiled,
                round_trip=dict(file_form_and_values=file_ok,
                                next_step_bit_equal=step_equal,
                                loss_loaded=loss_fresh,
                                loss_original=loss_orig, file_mib=file_mb,
                                seconds=round_trip_s))


def eager_gpt_phase(train) -> dict:
    """bench_gpt2_small's config at full width and depth (b16 x s1024,
    bf16 O1, AdamW, dropout 0) as the eager script of
    tests/eager_gpt_script.py on CUDA Tensors, started from a port
    GPTForCausalLM's weights and held to that model's own eager steps
    on the same batches by phase 7's rule; B1/B2's launches by design
    read around each step; the step by wall beside phase 6's graph step,
    the ops dispatched a step, the host µs of a dispatched op and the
    device's idle share in one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt2_small)
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW
    S = _tests_module("eager_gpt_script")
    _fresh_card()
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     use_flash_attention=True)
    L, H, batch, seq = cfg.num_layers, cfg.num_heads, 16, 1024
    rng = np.random.default_rng(0)
    batches = [tuple(rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32) for _ in range(2)) for _ in range(EAGER_STEPS)]
    model = GPTForCausalLM(cfg, seed=0)
    weights = {k: v.detach().clone() for k, v in _torch_state(model).items()}
    names = list(weights)

    # the model's own eager steps on torch tensors
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=EAGER_LR, parameters=_torch_params(model),
                weight_decay=0.01)
    want_losses = []
    for ids, labels in batches:
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(torch.as_tensor(ids, device="cuda")),
                        torch.as_tensor(labels, device="cuda"))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want_losses.append(float(loss.detach()))
    state = _torch_state(model)
    want_params = [state[k].detach().clone() for k in names]
    del model, opt, state, loss
    _fresh_card()

    # the eager script on Tensors, marks taken before each step
    marks = []

    def mark():
        torch.cuda.synchronize()
        return (time.perf_counter(), registry.dispatch_count(),
                dict(fa.flash_fwd.design_launches),
                dict(fa.flash_bwd.design_launches))

    def on_step(_i):
        marks.append(mark())

    saved_place = tdevice._current_place
    P.set_device("gpu:0")
    try:
        losses, params = S.eager_gpt_steps(
            P, weights, batches, L, H, lr=EAGER_LR, amp=True, place="gpu:0",
            on_step=on_step)
        on_step(EAGER_STEPS)
        steps = _step_marks(marks)
        held = _held_to(losses, want_losses,
                        [params[k]._data for k in names], want_params,
                        EAGER_LR, EAGER_STEPS)
        bit_equal = losses == want_losses and all(
            torch.equal(params[k]._data, w)
            for k, w in zip(names, want_params))

        # one more step unprofiled and one profiled (the device's idle
        # share), on the script's parameters with an optimizer of their
        # own (its first step makes its moments)
        ids_t = P.to_tensor(batches[0][0], place="gpu:0")
        labels_t = P.to_tensor(batches[0][1], place="gpu:0")
        opt2 = P.optimizer.AdamW(learning_rate=EAGER_LR,
                                 parameters=list(params.values()),
                                 weight_decay=0.01)

        def one_step():
            with P.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = S.gpt_loss(P, params, ids_t, labels_t, L, H)
            loss.backward()
            opt2.step()
            opt2.clear_grad()
            torch.cuda.synchronize()

        one_step()
        t = time.perf_counter()
        one_step()
        step_ms_again = 1e3 * (time.perf_counter() - t)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            one_step()
            profiled_ms = 1e3 * (time.perf_counter() - t)
        device_ms = _device_ms(prof)
        overhead = _dispatch_overhead(P)
        # the same GPT built from nn.Layers (held bit for bit, then
        # timed in turns with the dict script's one_step), and the
        # save/load round trip
        layers = eager_layer_gpt(
            P, _tests_module("eager_gpt_layer_script"), weights, batches,
            want_losses, want_params, names, L, H, mark, one_step)
        # phases 23 and 28 feed the nn.Layer GPT the same batches from a
        # DataLoader and hold it to these steps
        EAGER_GPT.update(weights=weights, batches=batches,
                         losses=want_losses, params=want_params,
                         names=names, L=L, H=H)
        del want_params, params, opt2, ids_t, labels_t
        layer_call = _layer_call_overhead(P)
    finally:
        tdevice._current_place = saved_place
    timed = [s["ms"] for s in steps[1:]]
    rec = dict(
        config="gpt2_small", layers=L, batch=batch, seq=seq,
        steps=EAGER_STEPS, lr=EAGER_LR, losses=losses,
        model_losses=want_losses, held_to_model=held, bit_equal=bit_equal,
        step_ms=[s["ms"] for s in steps],
        step_ms_after_first=statistics.mean(timed),
        step_ms_fourth=step_ms_again, step_ms_profiled=profiled_ms,
        device_ms_profiled=device_ms,
        idle_share=(1 - device_ms / profiled_ms) if device_ms else None,
        graph_step_ms=train["step_ms_median"],
        graph_step_ms_replay=train["step_ms_replay"],
        trainstep_eager_step_ms=train["eager_step_ms"],
        ops_per_step=[s["ops"] for s in steps],
        b1_by_step=[s["b1"] for s in steps],
        b2_by_step=[s["b2"] for s in steps],
        host_us_dispatched_op=overhead["dispatched"],
        host_us_torch_op=overhead["torch"],
        host_us_dispatch_overhead=overhead["overhead"],
        nn_layer_gpt=layers, host_us_layer_call=layer_call["call"],
        host_us_layer_forward=layer_call["forward"],
        host_us_layer_call_overhead=layer_call["overhead"],
        host_us_parameter_read=layer_call["weight"],
        card=card_line())
    want_designs = {"sm90": L, "simple": 0}
    rt = layers["round_trip"]
    _check("[eager]", {
        "every loss finite": all(np.isfinite(losses)),
        "the script held to GPTForCausalLM's eager steps (phase 7's "
        "rule)": held["ok"],
        f"B1 at {L} sm90 launches a step": all(
            s["b1"] == want_designs for s in steps),
        f"B2 at {L} sm90 launches a step": all(
            s["b2"] == want_designs for s in steps),
        "the same ops dispatched every step": len(set(
            rec["ops_per_step"])) == 1,
        "the nn.Layer GPT's state_dict keys are GPTForCausalLM's":
            layers["keys_are_the_models"],
        "the nn.Layer GPT bit-equal to GPTForCausalLM's eager steps "
        "(losses and every parameter)": layers["bit_equal"],
        f"the nn.Layer GPT: B1 at {L} sm90 launches a step": all(
            s == want_designs for s in layers["b1_by_step"]),
        f"the nn.Layer GPT: B2 at {L} sm90 launches a step": all(
            s == want_designs for s in layers["b2_by_step"]),
        "the nn.Layer GPT dispatches the dict script's ops":
            layers["ops_per_step"] == rec["ops_per_step"],
        "save: the file read by pickle and numpy holds every value under "
        "the model's names": rt["file_form_and_values"],
        "load: the loaded model's next step bit-equal to the original's":
            rt["next_step_bit_equal"],
    }, rec)
    idle = "not measured" if rec["idle_share"] is None \
        else f"{100 * rec['idle_share']:.1f} %"
    log(f"[eager] gpt2_small eager script, bf16 O1 AdamW, {L} layers, "
        f"b{batch} x s{seq}: steps {[round(x, 2) for x in rec['step_ms']]} "
        f"ms by wall (then {step_ms_again:.2f} ms; phase 6's graph step "
        f"{rec['graph_step_ms']:.2f} ms by wall, its eager TrainStep step "
        f"{rec['trainstep_eager_step_ms']:.2f} ms); {rec['ops_per_step']} "
        f"ops dispatched a step; a dispatched op {overhead['dispatched']:.2f}"
        f" us of host time against {overhead['torch']:.2f} us for the "
        f"torch call ({overhead['overhead']:.2f} us of registry); profiled "
        f"step {profiled_ms:.2f} ms, device {device_ms:.2f} ms, idle "
        f"{idle}; losses {losses} against the model's {want_losses} "
        f"(bit-equal {bit_equal}, {held}); B1 {rec['b1_by_step']}, B2 "
        f"{rec['b2_by_step']}; card {rec['card']}")
    log(f"[eager] gpt2_small from nn.Layers, the same config: steps "
        f"{[round(x, 2) for x in layers['step_ms']]} ms by wall (the dict "
        f"script's {[round(x, 2) for x in rec['step_ms']]}; phase 6's "
        f"graph step {rec['graph_step_ms']:.2f} ms); "
        f"{layers['ops_per_step']} ops a step; bit-equal to the model "
        f"{layers['bit_equal']}; B1 {layers['b1_by_step']}, B2 "
        f"{layers['b2_by_step']}; in turns with the dict script "
        f"{json.dumps(layers['alternating_ms'])} ms (medians "
        f"{json.dumps(layers['alternating_ms_median'])}); a no-op Layer "
        f"call {layer_call['call']:.3f} us of host time against "
        f"{layer_call['forward']:.3f} us for its forward "
        f"({layer_call['overhead']:.3f} us of __call__), a Parameter read "
        f"{layer_call['weight']:.3f} us; save/load "
        f"{rt['file_mib']:.1f} MiB in {rt['seconds']:.2f} s, the next step "
        f"{rt['loss_loaded']} against {rt['loss_original']} (bit-equal "
        f"{rt['next_step_bit_equal']}); card {rec['card']}")
    log(f"[eager] the two forms in turns, allocator counters a step "
        f"{json.dumps(layers['alternating_allocator'])}; profiled in turns "
        f"{json.dumps({k: layers['profiled'][k] for k in ('dict', 'layers')})}"
        f"; kernels most apart "
        f"{json.dumps(layers['profiled']['kernels_most_apart'])}")
    del weights
    _fresh_card()
    return rec


def eager_phase(train) -> dict:
    """Phase 22: the op sweep, the random ops, then the eager GPT-2
    small."""
    C = _tests_module("eager_op_cases")
    sweep = eager_op_sweep(C)
    rand = eager_random_checks(C)
    _check("[eager-ops]", {
        "every case on the card agrees with the CPU": not sweep["failures"],
        "every op of the registry dispatched on the card":
            not sweep["not_run"],
        "the same draws under the same seed on the card":
            rand["same_draws_under_seed"],
        "each random op's draws shaped and typed as on the CPU":
            rand["layout_as_cpu"],
        "every random op's moments and range within their limits":
            not rand["moments_failed"],
    }, dict(sweep=sweep, random=rand))
    log(f"[eager-ops] {sweep['cases']} cases, {sweep['ops_run']} of "
        f"{sweep['ops_in_table']} ops of the registry run on the card and "
        f"held to the CPU; largest difference by module "
        f"{json.dumps(sweep['max_abs_err_by_module'])}; random ops: same "
        f"draws under one seed, {len(rand['moments'])} moment checks of "
        f"{SWEEP_DRAWS} draws passed")
    return dict(sweep=sweep, random=rand, gpt=eager_gpt_phase(train))


# ---------------------------------------------------------------------------
# phase 23: io and the vision input path
# ---------------------------------------------------------------------------
IO_PREFETCH = 2
IO_WARMUP, IO_TIMED = 2, 10
IO_POOL = 512
IO_MAX_WORKERS = 8
# phase 23c's folder: 10 classes x 128 uint8 256^2 x 3 images, 1 + 4
# batches of 256 through the ImageNet-style transform
IO_FOLDER = dict(classes=10, per_class=128, hw=256)
IO_PIPELINE_BATCHES = 5
IMAGENET_MEAN = [123.675, 116.28, 103.53]
IMAGENET_STD = [58.395, 57.12, 57.375]
# phase 23d's loader: phase 22's batches from 2 spawned workers
IO_GPT_WORKERS = 2


def _io_cases():
    """tests/torch_io_cases.py imported by name (tests/ put on sys.path):
    spawned workers unpickle its datasets by that name."""
    import importlib
    import pathlib
    tests = str(pathlib.Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("torch_io_cases")


def _shm_free() -> int:
    import os
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def _own_segments() -> list:
    """This process's loaders' segments left in /dev/shm."""
    import os

    from paddle_tpu_torch.io import _process_worker as PW
    prefix = PW.shm_prefix(os.getpid())
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


def _io_workers(batch_bytes) -> dict:
    """The process tier's worker count: the largest W <= 8 (and <= the
    CPUs this process may run on) whose segments fit in /dev/shm's free
    bytes at once. A worker holds up to prefetch_factor batches in its
    queue and one more it has packed and waits to put, and the parent
    one it is copying out: W * (prefetch_factor + 1) + 1 batches. Raises
    when /dev/shm cannot hold even one batch."""
    import os
    free = _shm_free()
    if free < batch_bytes:
        raise RuntimeError(
            f"[io] /dev/shm has {free} bytes free: not even one batch of "
            f"{batch_bytes} bytes fits, so the process tier cannot run")
    cpus = len(os.sched_getaffinity(0))
    w = min(IO_MAX_WORKERS, cpus)
    while w > 1 and (w * (IO_PREFETCH + 1) + 1) * batch_bytes > free:
        w -= 1
    return dict(workers=w, shm_free=free, cpus=cpus,
                batches_held=w * (IO_PREFETCH + 1) + 1,
                why=f"largest W <= min({IO_MAX_WORKERS}, {cpus} CPUs) with "
                    f"(W * (prefetch {IO_PREFETCH} + 1) + 1) x {batch_bytes}"
                    f" bytes <= {free} bytes free in /dev/shm")


@contextlib.contextmanager
def _io_warnings():
    """Every warning of the block recorded (the loader's fallback and
    respawn warnings among them)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield caught


def _loader_fed(step, loader, n):
    """`n` TrainStep calls, each on the loader's next batch: per call
    the consumer's wait for the batch and the call (both synchronised),
    by wall; the loader's host-to-device copies; the losses."""
    import torch
    waits, iters, losses = [], [], []
    copies0 = loader.h2d_copies
    it = iter(loader)
    try:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, y = next(it)
            t1 = time.perf_counter()
            loss = step(x, y)
            torch.cuda.synchronize()
            waits.append(t1 - t0)
            iters.append(time.perf_counter() - t0)
            losses.append(float(loss))
    finally:
        it.close()
    return dict(wait_s=waits, iter_s=iters, losses=losses,
                h2d_copies=loader.h2d_copies - copies0)


def _io_summary(run, batch, warmup):
    timed = [1e3 * t for t in run["iter_s"][warmup:]]
    waits = [1e3 * t for t in run["wait_s"][warmup:]]
    med = statistics.median(timed)
    return dict(step_ms_median=med, step_ms_min=min(timed),
                step_ms_max=max(timed), images_per_s=batch / (med / 1e3),
                wait_ms_median=statistics.median(waits),
                wait_ms_max=max(waits),
                h2d_copies_per_batch=run["h2d_copies"] / len(run["iter_s"]),
                losses=run["losses"])


def _io_resnet(C, workers, resnet) -> dict:
    """23a: bench_resnet50's config fed by a DataLoader over 512 pooled
    images (12 batches of 256), with num_workers=0 (the buffered prefetch
    thread) and with `workers` spawned workers, through one TrainStep:
    one capture, every later call a replay."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import cuda_graph
    n = IO_WARMUP + IO_TIMED
    b = RESNET_BATCH
    ds = C.ImagePool(n * b, pool=IO_POOL, hw=RESNET_HW)
    _fresh_card()
    model, step = _resnet_train_step()
    cap0 = cuda_graph.captures["train_step"]
    rep0 = cuda_graph.replays["train_step"]
    runs = {}
    with _io_warnings() as caught:
        for tier, kw in (("num_workers=0", dict(num_workers=0)),
                         (f"process tier, {workers} workers",
                          dict(num_workers=workers,
                               prefetch_factor=IO_PREFETCH))):
            loader = DataLoader(ds, batch_size=b, **kw)
            runs[tier] = _io_summary(_loader_fed(step, loader, n), b,
                                     IO_WARMUP)
            if kw["num_workers"]:
                runs[tier]["spawn_picklable"] = \
                    loader._spawn_picklable_result
    rec = dict(runs=runs, batch=b, image=RESNET_HW, pool=IO_POOL,
               batches=n, workers=workers,
               captures=cuda_graph.captures["train_step"] - cap0,
               replays=cuda_graph.replays["train_step"] - rep0,
               warnings=[str(w.message) for w in caught],
               phase19_step_ms_median=resnet["step_ms_median"],
               phase19_images_per_s=resnet["images_per_s"])
    return rec, model, step


def _io_exact(C, workers) -> dict:
    """23b: resnet50 at phase 19's sub-size (b8 x 64^2, f32, TF32 off,
    cuDNN deterministic): 3 graph steps fed by the process tier against
    3 graph steps fed the same arrays directly, bit for bit."""
    import torch
    from paddle_tpu_torch.io import DataLoader
    rng = np.random.default_rng(5)
    bs, hw = RESNET_SUB_BATCH, RESNET_SUB_HW
    xs = rng.standard_normal((PARITY_STEPS * bs, hw, hw, 3),
                             dtype=np.float32)
    ys = rng.integers(0, 1000, (PARITY_STEPS * bs,)).astype(np.int32)
    out = {}
    with _f32_exact():
        for fed in ("loader", "arrays"):
            model, step = _resnet_train_step(lr=0.01, amp=False, seed=1)
            if fed == "loader":
                loader = DataLoader(C.ArraysDs(xs, ys), batch_size=bs,
                                    num_workers=min(workers, 2))
                with _io_warnings() as caught:
                    batches = list(loader)
                losses = [float(step(x, y)) for x, y in batches]
                copies = loader.h2d_copies
                del batches
            else:
                losses = [float(step(
                    torch.from_numpy(xs[i * bs:(i + 1) * bs]).to(
                        step.device),
                    torch.from_numpy(ys[i * bs:(i + 1) * bs]).to(
                        step.device)))
                    for i in range(PARITY_STEPS)]
            out[fed] = dict(losses=losses, params=_state(model),
                            captures=len(step._graphs))
            del model, step
    a, b = out["loader"], out["arrays"]
    equal = a["losses"] == b["losses"] and all(
        torch.equal(p, q) for p, q in zip(a.pop("params"), b.pop("params")))
    return dict(loader=a, arrays=b, bit_equal=equal, h2d_copies=copies,
                warnings=[str(w.message) for w in caught])


def _io_pipeline(C, workers, step) -> dict:
    """23c: DatasetFolder over 1,280 uint8 256^2 .npy images through
    RandomResizedCrop(224), RandomHorizontalFlip and an HWC Normalize,
    on `workers` spawned workers: 1 + 4 batches of 256 read alone, then
    1 + 4 more each feeding `step` (23a's TrainStep). A reading: can
    the host feed the card?"""
    import tempfile

    import torch
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision import transforms as T
    b = RESNET_BATCH
    rec = {}
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        n = C.write_image_folder(root, **IO_FOLDER)
        rec["write_s"] = time.perf_counter() - t
        pipe = T.Compose([T.RandomResizedCrop(RESNET_HW),
                          T.RandomHorizontalFlip(),
                          T.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                      data_format="HWC")])
        ds = datasets.DatasetFolder(root, transform=pipe)
        loader = DataLoader(ds, batch_size=b, shuffle=True, drop_last=True,
                            num_workers=workers,
                            prefetch_factor=IO_PREFETCH)
        with _io_warnings() as caught:
            marks, shapes = [], None
            it = iter(loader)
            for x, y in it:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                shapes = (x.shape, str(x.dtype), y.shape, str(y.dtype))
            alone_s = marks[-1] - marks[0]
            fed = _io_summary(_loader_fed(step, loader,
                                          IO_PIPELINE_BATCHES), b, 1)
        rec.update(
            files=n, workers=workers, batches=len(marks),
            batch_shapes=shapes,
            loader_images_per_s=(len(marks) - 1) * b / alone_s,
            in_step=fed, warnings=[str(w.message) for w in caught])
    rec["segments_left"] = _own_segments()
    return rec


def _io_gpt(C) -> dict:
    """23d: phase 22's nn.Layer GPT (bench_gpt2_small's config) fed its
    3 batches by a DataLoader with 2 spawned workers over host int32
    rows, held bit for bit to phase 22's eager steps; B1/B2 launches
    counted a step."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.kernels import flash_attention as fa
    g = EAGER_GPT
    S = _tests_module("eager_gpt_layer_script")
    marks = []

    def mark(_i=None):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), 0,
                      dict(fa.flash_fwd.design_launches),
                      dict(fa.flash_bwd.design_launches)))

    saved_place = tdevice._current_place
    P.set_device("gpu:0")
    try:
        _fresh_card()
        model = S.gpt_from_weights(P, g["weights"], g["L"], g["H"])
        opt = P.optimizer.AdamW(learning_rate=EAGER_LR,
                                parameters=model.parameters(),
                                weight_decay=0.01)
        loader = DataLoader(C.RowsDs(g["batches"]),
                            batch_size=len(g["batches"][0][0]),
                            num_workers=IO_GPT_WORKERS)
        with _io_warnings() as caught:
            losses = S.train_steps(P, model, opt, loader, amp=True,
                                   on_step=mark)
        mark()
        steps = _step_marks(marks)
        sd = model.state_dict()
        bit_equal = losses == g["losses"] and all(
            torch.equal(sd[k]._data, w)
            for k, w in zip(g["names"], g["params"]))
        copies = loader.h2d_copies
        del model, opt, sd
    finally:
        tdevice._current_place = saved_place
    return dict(losses=losses, phase22_losses=g["losses"],
                bit_equal=bit_equal, b1_by_step=[s["b1"] for s in steps],
                b2_by_step=[s["b2"] for s in steps],
                step_ms=[s["ms"] for s in steps], h2d_copies=copies,
                batches=len(g["batches"]), workers=IO_GPT_WORKERS,
                layers=g["L"],
                warnings=[str(w.message) for w in caught])


def _fallback_warnings(messages):
    return [m for m in messages if "falling back" in m or "respawn" in m]


def io_phase(resnet) -> dict:
    """Phase 23: the DataLoader feeding the card. Prints the CPUs, the
    affinity set and /dev/shm's free bytes, then runs 23a-23d."""
    import os

    from paddle_tpu_torch import get_flags, set_flags
    C = _io_cases()
    batch_bytes = RESNET_BATCH * RESNET_HW * RESNET_HW * 3 * 4
    affinity = sorted(os.sched_getaffinity(0))
    log(f"[io] os.cpu_count() {os.cpu_count()}, affinity {len(affinity)} "
        f"CPUs {affinity}, /dev/shm {_shm_free()} bytes free; a ResNet-50 "
        f"batch is {batch_bytes} bytes")
    w = _io_workers(batch_bytes)
    log(f"[io] process tier at W = {w['workers']}: {w['why']}")
    workers = w["workers"]
    flag = "FLAGS_fast_bn_stats"
    saved = get_flags(flag)
    set_flags({flag: True})
    secs = {}
    t = time.perf_counter()
    try:
        a, model, step = _io_resnet(C, workers, resnet)
        secs["a"] = time.perf_counter() - t
        c = _io_pipeline(C, workers, step)
        secs["c"] = time.perf_counter() - t - secs["a"]
        del model, step
        _fresh_card()
        t = time.perf_counter()
        b = _io_exact(C, workers)
        secs["b"] = time.perf_counter() - t
    finally:
        set_flags(saved)
    _fresh_card()
    t = time.perf_counter()
    d = _io_gpt(C)
    secs["d"] = time.perf_counter() - t
    _fresh_card()
    n = IO_WARMUP + IO_TIMED
    L = d["layers"]     # one B1 and one B2 launch a layer a step
    checks = {
        "23a: one capture and every later call a replay (Tensor batches "
        "from both loaders)": (a["captures"], a["replays"]) == (1, 2 * n - 1),
        "23a: every loss finite": all(
            np.isfinite(r["losses"]).all() for r in a["runs"].values()),
        "23a: one host-to-device copy a batch": all(
            r["h2d_copies_per_batch"] == 1 for r in a["runs"].values()),
        "23a: no fallback or respawn warning, the process tier kept":
            not _fallback_warnings(a["warnings"]) and all(
                r.get("spawn_picklable", True) for r in a["runs"].values()),
        "23b: 3 graph steps fed by the process tier bit-equal to 3 fed "
        "the arrays directly": b["bit_equal"],
        "23b: one capture each": (b["loader"]["captures"],
                                  b["arrays"]["captures"]) == (1, 1),
        "23b: one host-to-device copy a batch":
            b["h2d_copies"] == PARITY_STEPS,
        "23b: no fallback warning": not _fallback_warnings(b["warnings"]),
        "23c: the pipeline's batches [256, 224, 224, 3] f32 and [256] "
        "int32": c["batch_shapes"] == (
            [RESNET_BATCH, RESNET_HW, RESNET_HW, 3], "torch.float32",
            [RESNET_BATCH], "torch.int32"),
        "23c: every loss finite": np.isfinite(c["in_step"]["losses"]).all(),
        "23c: no fallback warning": not _fallback_warnings(c["warnings"]),
        "23c: no segment of this process left in /dev/shm":
            not c["segments_left"],
        "23d: the loader-fed nn.Layer GPT bit-equal to phase 22's eager "
        "steps (losses and every parameter)": d["bit_equal"],
        f"23d: B1 at {L} sm90 launches a step": all(
            s == {"sm90": L, "simple": 0} for s in d["b1_by_step"]),
        f"23d: B2 at {L} sm90 launches a step": all(
            s == {"sm90": L, "simple": 0} for s in d["b2_by_step"]),
        "23d: one host-to-device copy a batch":
            d["h2d_copies"] == d["batches"],
        "23d: no fallback warning": not _fallback_warnings(d["warnings"]),
    }
    rec = dict(workers=w, resnet=a, exact=b, pipeline=c, gpt=d,
               seconds=secs, card=card_line())
    _check("[io]", checks, rec)
    card = rec["card"]
    for tier, r in a["runs"].items():
        log(f"[io] 23a resnet50 b{RESNET_BATCH} x {RESNET_HW}^2 fed by the "
            f"DataLoader, {tier}: step {r['step_ms_median']:.2f} ms median "
            f"({r['step_ms_min']:.2f}-{r['step_ms_max']:.2f} over "
            f"{IO_TIMED}), {r['images_per_s']:.1f} images/s, the "
            f"consumer's wait {r['wait_ms_median']:.3f} ms a batch (max "
            f"{r['wait_ms_max']:.3f}), {r['h2d_copies_per_batch']:.0f} H2D "
            f"copy a batch; phase 19 (arrays on the card) "
            f"{resnet['step_ms_median']:.2f} ms, "
            f"{resnet['images_per_s']:.1f} images/s; card {card}")
    log(f"[io] 23a: {a['captures']} capture, {a['replays']} replays over "
        f"both loaders")
    log(f"[io] 23b resnet50 f32 b{RESNET_SUB_BATCH} x {RESNET_SUB_HW}^2: "
        f"loader-fed losses {b['loader']['losses']} against array-fed "
        f"{b['arrays']['losses']}: bit-equal {b['bit_equal']}")
    log(f"[io] 23c DatasetFolder ({c['files']} files, written in "
        f"{c['write_s']:.2f} s) through RandomResizedCrop(224), "
        f"RandomHorizontalFlip, Normalize(HWC) on {c['workers']} workers: "
        f"the loader alone {c['loader_images_per_s']:.1f} images/s; "
        f"feeding 23a's step {c['in_step']['images_per_s']:.1f} images/s "
        f"(step {c['in_step']['step_ms_median']:.2f} ms median, wait "
        f"{c['in_step']['wait_ms_median']:.2f} ms); card {card}")
    log(f"[io] 23d nn.Layer GPT fed by {d['workers']} workers: losses "
        f"{d['losses']} (phase 22 {d['phase22_losses']}), bit-equal "
        f"{d['bit_equal']}; B1 {d['b1_by_step']}, B2 {d['b2_by_step']}; "
        f"steps {[round(x, 2) for x in d['step_ms']]} ms (the last with "
        f"the epoch's end: the workers joined)")
    log(f"[io] seconds by part {json.dumps(secs)}")
    return rec


# ---------------------------------------------------------------------------
# phase 24: an LSTM language model at PTB-large widths
# ---------------------------------------------------------------------------
def lstm_train_step(model, lr, layers, batch, hidden, device="cuda"):
    """(TrainStep, (h, c)) for the LSTM LM of tests/lstm_lm_script.py
    with SGD at `lr`: the loss function starts each batch from the
    states (h, c) [layers, batch, hidden] (zeros at first; clones, so
    autograd keeps its inputs) and writes the batch's final states into
    them, so the states carry across the graph's replays as they do
    across eager steps. TrainStep clips nothing (as the reference's)."""
    import torch
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch import jit
    carry = tuple(torch.zeros((layers, batch, hidden), device=device)
                  for _ in range(2))

    def loss_fn(m, ids, labels):
        logits, h, c = m(ids, carry[0].clone(), carry[1].clone())
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        with torch.no_grad():
            carry[0].copy_(h)
            carry[1].copy_(c)
        return loss

    opt = SGD(learning_rate=lr,
              parameters=torch.nn.Module.parameters(model))
    return jit.TrainStep(model, opt, loss_fn), carry


# phase 24: the LSTM LM of tests/lstm_lm_script.py at its PTB_LARGE config
# (2 layers of 1500, 10,000 words, batch 20 x 35 steps): 3 eager steps
# on Tensors, 2 + 10 TrainStep calls through its graph (the timed run,
# dropout 0.65), 3 graph steps held to 3 eager ones at dropout 0, the
# LSTM alone beside cuDNN's, then one LBFGS step
LSTM_EAGER_STEPS = 3
LSTM_WARMUP, LSTM_TIMED = 2, 10
LSTM_LBFGS = dict(line_search_fn="strong_wolfe", history_size=10,
                  max_iter=5)
# the port's LSTM against torch.nn.LSTM (cuDNN) at the same widths in
# f32 with TF32 off: the same gates in the same order, summed in other
# orders over 35 steps
LSTM_VS_CUDNN_TOL = 1e-4


def _port_kernel_counts():
    """Every counter of the port's kernels and of their plain versions
    (B1, B2, B3, B4, B5, the update), and a function that sets them to
    0."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.kernels import norms
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    fns = (fa.flash_fwd, fa.flash_bwd, rpa.ragged_paged_attention,
           norms.layer_norm_fwd, norms.rms_norm_fwd, mta.multi_tensor_adam)

    def read():
        return [(f.kernel_launches, f.plain_calls) for f in fns]

    def reset():
        for f in fns:
            f.kernel_launches = f.plain_calls = 0

    return read, reset


def _lm_setup():
    """(the script module, its PTB_LARGE config, the weights from numpy
    seed 0, the batches of every run)."""
    S = _tests_module("lstm_lm_script")
    c = S.PTB_LARGE
    weights = S.lm_weights(c["vocab_size"], c["hidden_size"],
                           c["num_layers"], seed=0,
                           init_scale=c["init_scale"])
    n = max(LSTM_EAGER_STEPS + 1, LSTM_WARMUP + LSTM_TIMED)
    batches = S.lm_batches(c["vocab_size"], c["batch_size"],
                           c["num_steps"], n, seed=0)
    return S, c, weights, batches


def _lm_eager(P, S, c, weights, batches) -> dict:
    """Run 1: LSTM_EAGER_STEPS eager steps on CUDA Tensors through the
    script (dropout 0.65, SGD lr 1, clip_grad_norm_ 10, the states
    carried and detached), each timed by wall to its loss's host read,
    then one more step under torch.profiler: its device ms and idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    L, B, H = c["num_layers"], c["batch_size"], c["hidden_size"]
    model = S.lm_from_weights(P, weights, L, c["dropout"])
    opt = P.optimizer.SGD(learning_rate=c["lr"],
                          parameters=model.parameters())
    marks = []

    def mark(_i=None):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    losses, states = S.lm_steps(
        P, model, opt, batches[:LSTM_EAGER_STEPS],
        S.zero_states(P, L, B, H, place="gpu:0"), c["max_grad_norm"],
        place="gpu:0", on_step=mark)
    mark()
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        more, _ = S.lm_steps(P, model, opt, batches[LSTM_EAGER_STEPS:
                                                    LSTM_EAGER_STEPS + 1],
                             states, c["max_grad_norm"], place="gpu:0")
        wall = 1e3 * (time.perf_counter() - t)
    dev = _device_ms(prof)
    events = sum(e.count for e in prof.key_averages())
    del model, opt, states, prof
    return dict(losses=losses + more, step_ms=step_ms,
                profiled_step=dict(wall_ms=wall, device_ms=dev,
                                   idle_share=1 - dev / wall,
                                   device_events=events))


def _lm_graph_run(P, S, c, weights, batches) -> dict:
    """Run 2, the timed run: LSTM_WARMUP + LSTM_TIMED TrainStep calls at
    dropout 0.65 through one captured graph (chip_smoke.lstm_train_step:
    the states carried in the tensors the step writes), a batch of its
    own each call, synchronised and timed by wall; the step by replay of
    the graph, the idle share, tokens/s and peak memory."""
    import torch
    from paddle_tpu_torch.jit import cuda_graph
    L, B, H = c["num_layers"], c["batch_size"], c["hidden_size"]
    _fresh_card()
    model = S.lm_from_weights(P, weights, L, c["dropout"])
    step, carry = lstm_train_step(model, c["lr"], L, B, H)
    dev_batches = [tuple(torch.as_tensor(a, device="cuda") for a in b)
                   for b in batches]
    read, reset = _port_kernel_counts()
    reset()
    cuda_graph.reset_counters()
    losses, step_s = [], []
    with stream_mismatch_warnings() as warned:
        for i in range(LSTM_WARMUP + LSTM_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(*dev_batches[i])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(loss))
    captures, replays = dict(cuda_graph.captures), dict(cuda_graph.replays)
    port_kernels = read()
    carried = float(carry[0].abs().sum()) > 0 and float(
        carry[1].abs().sum()) > 0
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    del graph
    wall_ms = 1e3 * statistics.median(step_s[LSTM_WARMUP:])
    tokens = B * c["num_steps"]
    n = sum(p.numel() for p in torch.nn.Module.parameters(model))
    rec = dict(params=n, tokens_per_step=tokens, losses=losses,
               step_ms_median=wall_ms,
               step_ms=[1e3 * s for s in step_s[LSTM_WARMUP:]],
               first_step_ms=1e3 * step_s[0],
               capture_s=cuda_graph.capture_seconds["train_step"],
               step_ms_replay=replay_ms, idle_share=1 - replay_ms / wall_ms,
               tokens_per_s=tokens / (wall_ms / 1e3),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               captures=captures, replays=replays,
               stream_warnings=len(warned), states_carried=carried,
               port_kernel_counts=port_kernels)
    _check("[lstm] graph run:", {
        "every loss finite": all(np.isfinite(losses)),
        "one graph captured, every later step a replay": (
            captures, replays) == ({"train_step": 1}, {
                "train_step": LSTM_WARMUP + LSTM_TIMED - 1}),
        "the states carried across the replays (nonzero)": carried,
        "no kernel of the port on this path and no plain version (the "
        "recurrence is plain PyTorch, no TPU kernel stands behind it)":
            not any(map(any, port_kernels)),
        "no AccumulateGrad stream-mismatch warning": not warned,
    }, rec)
    del model, step, carry, dev_batches
    return rec


def _lm_state(model):
    """Copies of `model`'s state (torch's state_dict values), in order."""
    import torch
    return [v.detach().clone()
            for v in torch.nn.Module.state_dict(model).values()]


def _lm_parity(P, S, c, weights, batches) -> dict:
    """Run 3, at dropout 0 in f32 with TF32 off: 3 TrainStep calls
    through the graph, 3 through the same step run eagerly
    (``step._eager``), and the script's 3 eager Tensor steps without a
    clip (TrainStep clips nothing, as the reference's), each from the
    weights; the graph's held to both by phase 7's rule (_held_to), and
    its carried states to the script's last ones."""
    import torch
    L, B, H = c["num_layers"], c["batch_size"], c["hidden_size"]
    n = LSTM_EAGER_STEPS
    dev_batches = [tuple(torch.as_tensor(a, device="cuda") for a in b)
                   for b in batches[:n]]
    runs = {}
    with _f32_exact():
        for eager in (False, True):
            _fresh_card()
            model = S.lm_from_weights(P, weights, L, 0.0)
            step, carry = lstm_train_step(model, c["lr"], L, B, H)
            step._eager = eager
            losses = [float(step(*b)) for b in dev_batches]
            runs[eager] = (losses, _lm_state(model),
                           [t.clone() for t in carry])
            del model, step, carry
        model = S.lm_from_weights(P, weights, L, 0.0)
        opt = P.optimizer.SGD(learning_rate=c["lr"],
                              parameters=model.parameters())
        s_losses, (h, c_) = S.lm_steps(
            P, model, opt, batches[:n],
            S.zero_states(P, L, B, H, place="gpu:0"), place="gpu:0")
        script = (s_losses, _lm_state(model), [h._data, c_._data])
        del model, opt
    (g_losses, g_params, g_carry) = runs[False]
    to_eager = _held_to(g_losses, runs[True][0], g_params, runs[True][1],
                        c["lr"], n)
    to_script = _held_to(g_losses, script[0], g_params, script[1], c["lr"],
                         n)
    states_err = max(float((a - b).abs().max())
                     for a, b in zip(g_carry, script[2]))
    rec = dict(graph_losses=g_losses, eager_losses=runs[True][0],
               script_losses=script[0], to_trainstep_eager=to_eager,
               to_script=to_script, carried_states_max_abs_diff=states_err)
    _check("[lstm] parity, dropout 0:", {
        "graph steps == TrainStep's eager steps (phase 7's rule)":
            to_eager["ok"],
        "graph steps == the script's eager Tensor steps (phase 7's rule)":
            to_script["ok"],
        "carried states == the script's (1e-4)": states_err <= 1e-4,
    }, rec)
    _fresh_card()
    return rec


def _lm_lstm_vs_cudnn(P, c, weights) -> dict:
    """The port's nn.LSTM alone (time-major, dropout 0) beside
    torch.nn.LSTM (cuDNN, a yardstick only) with the same weights, at
    the LM's shape: forward + backward of every weight and the input by
    CUDA events, the port's also by graph replay; their outputs held to
    each other in f32 with TF32 off (LSTM_VS_CUDNN_TOL)."""
    import torch
    L, B, H, T = (c["num_layers"], c["batch_size"], c["hidden_size"],
                  c["num_steps"])
    port = P.nn.LSTM(H, H, num_layers=L, time_major=True)
    lib = torch.nn.LSTM(H, H, num_layers=L).cuda()
    with torch.no_grad():
        for k in range(L):
            for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                w = torch.as_tensor(weights[f"lstm.{n}_l{k}"], device="cuda")
                port._parameters[f"{n}_l{k}"].copy_(w)
                getattr(lib, f"{n}_l{k}").copy_(w)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, B, H), generator=g, device="cuda").requires_grad_()
    h0 = torch.zeros((L, B, H), device="cuda")
    dout = torch.randn((T, B, H), generator=g, device="cuda")
    p_params = list(torch.nn.Module.parameters(port)) + [x]
    l_params = list(lib.parameters()) + [x]

    def port_fb():
        out, _ = port(x, (h0, h0))
        return torch.autograd.grad(out, p_params, dout)

    def lib_fb():
        out, _ = lib(x, (h0, h0))
        return torch.autograd.grad(out, l_params, dout)

    with _f32_exact():
        got, want = port_fb(), lib_fb()
        with torch.no_grad():
            out_p, out_l = port(x, (h0, h0))[0], lib(x, (h0, h0))[0]
        err = max([_norm_err(out_p, out_l, rows=False)]
                  + [_norm_err(a, b, rows=False) for a, b in zip(got, want)])
    with _f32_exact():      # both in full f32: no TF32 on either side
        rec = dict(port_fwd_bwd_ms=cuda_ms(port_fb, iters=10),
                   port_fwd_bwd_ms_graph=graph_ms(port_fb, reps=2, iters=5),
                   cudnn_fwd_bwd_ms=cuda_ms(lib_fb, iters=10),
                   port_vs_cudnn_norm_err=err)
    rec["factor"] = rec["port_fwd_bwd_ms"] / rec["cudnn_fwd_bwd_ms"]
    _check("[lstm] nn.LSTM vs cuDNN:", {
        f"outputs and grads within {LSTM_VS_CUDNN_TOL:g}":
            err <= LSTM_VS_CUDNN_TOL}, rec)
    del port, lib, got, want
    return rec


def _lm_lbfgs(P, S, c, weights, batches) -> dict:
    """Run 5: one LBFGS step (LSTM_LBFGS, lr 1) over the dropout-0 model
    on the first batch from zero states: the loss before and after, the
    closure calls, and the calls made before each iteration began (the
    reference's max_eval rule: an iteration begins only below
    max_eval), timed by wall."""
    import torch
    L, B, H = c["num_layers"], c["batch_size"], c["hidden_size"]
    _fresh_card()
    model = S.lm_from_weights(P, weights, L, 0.0)
    opt = P.optimizer.LBFGS(learning_rate=1.0, parameters=list(
        torch.nn.Module.parameters(model)), **LSTM_LBFGS)
    ids, labels = (torch.as_tensor(a, device="cuda") for a in batches[0])
    zeros = torch.zeros((L, B, H), device="cuda")
    calls, begins = [0], []

    def closure():
        calls[0] += 1
        opt.clear_grad()
        loss = S.lm_loss(P, model, ids, labels, zeros, zeros)[0]
        loss.backward()
        return loss

    direction = opt._direction

    def counted(g):
        begins.append(calls[0])
        return direction(g)

    opt._direction = counted
    with torch.no_grad():
        f0 = float(S.lm_loss(P, model, ids, labels, zeros, zeros)[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    f_step = float(opt.step(closure))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    with torch.no_grad():
        f1 = float(S.lm_loss(P, model, ids, labels, zeros, zeros)[0])
    rec = dict(loss_before=f0, loss_after=f1, step_returned=f_step,
               closure_calls=calls[0], max_eval=opt.max_eval,
               calls_at_iteration_starts=begins, seconds=secs,
               history=len(opt._s_hist),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    _check("[lstm] LBFGS:", {
        "the loss fell": f1 < f0,
        "every iteration began below max_eval (the reference's rule)":
            all(b < opt.max_eval for b in begins),
        "the closure calls are the step's count of evaluations":
            calls[0] == opt._n_evals,
    }, rec)
    del model, opt
    _fresh_card()
    return rec


def lstm_phase() -> dict:
    """Phase 24: the LSTM language model at PTB-large widths."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    S, c, weights, batches = _lm_setup()
    saved = tdevice._current_place
    P.set_device("gpu:0")
    try:
        eager = _lm_eager(P, S, c, weights, batches)
        graph = _lm_graph_run(P, S, c, weights, batches)
        parity = _lm_parity(P, S, c, weights, batches)
        cudnn = _lm_lstm_vs_cudnn(P, c, weights)
        lbfgs = _lm_lbfgs(P, S, c, weights, batches)
    finally:
        tdevice._current_place = saved
    rec = dict(config=c, eager=eager, graph=graph, parity=parity,
               lstm_vs_cudnn=cudnn, lbfgs=lbfgs)
    prof = eager["profiled_step"]
    log(f"[lstm] PTB-large LM ({graph['params']} params, "
        f"{graph['tokens_per_step']} tokens a step, dropout "
        f"{c['dropout']}): eager steps "
        f"{[round(x, 1) for x in eager['step_ms']]} ms by wall (profiled "
        f"step: device {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} "
        f"ms, idle {100 * prof['idle_share']:.1f} %); graph step "
        f"median {graph['step_ms_median']:.2f} ms by wall, "
        f"{graph['step_ms_replay']:.2f} by replay (idle "
        f"{100 * graph['idle_share']:.1f} %), {graph['tokens_per_s']:.0f} "
        f"tokens/s, peak {graph['peak_mem_gb']:.2f} GiB, capture "
        f"{graph['capture_s']:.2f} s; losses eager "
        f"{[round(x, 4) for x in eager['losses']]} graph "
        f"{[round(x, 4) for x in graph['losses']]}")
    log(f"[lstm] parity at dropout 0: graph {parity['graph_losses']} vs "
        f"TrainStep eager {parity['eager_losses']} vs script "
        f"{parity['script_losses']}; params max diff "
        f"{parity['to_trainstep_eager']['param_max_abs_diff']:.3e} / "
        f"{parity['to_script']['param_max_abs_diff']:.3e}; states "
        f"{parity['carried_states_max_abs_diff']:.3e}")
    log(f"[lstm] nn.LSTM 2x{c['hidden_size']} fwd+bwd at "
        f"[{c['num_steps']}, {c['batch_size']}]: port "
        f"{cudnn['port_fwd_bwd_ms']:.2f} ms by events "
        f"({cudnn['port_fwd_bwd_ms_graph']:.2f} by replay), cuDNN "
        f"{cudnn['cudnn_fwd_bwd_ms']:.2f} ms (x{cudnn['factor']:.1f}); "
        f"norm err vs cuDNN {cudnn['port_vs_cudnn_norm_err']:.2e}")
    log(f"[lstm] LBFGS {LSTM_LBFGS}: loss {lbfgs['loss_before']:.4f} -> "
        f"{lbfgs['loss_after']:.4f}, {lbfgs['closure_calls']} closure calls"
        f" (max_eval {lbfgs['max_eval']}; at iteration starts "
        f"{lbfgs['calls_at_iteration_starts']}), {lbfgs['seconds']:.2f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 25: flash_attn_unpadded through B1/B2
# ---------------------------------------------------------------------------
# (name, heads, head_dim, causal, seed): bert_base's widths non-causal,
# gpt2_small's causal (equal packings); each 32 sequences of 128-512
# tokens drawn from the seed, packed, the total padded to a multiple of
# 128
UNPADDED_CASES = [("bert_base non-causal", 12, 64, False, 0),
                  ("gpt2_small causal", 12, 64, True, 1)]
UNPADDED_SEQS, UNPADDED_MIN, UNPADDED_MAX = 32, 128, 512


def _unpadded_inputs(H, D, seed):
    import torch
    lens = np.random.default_rng(seed).integers(
        UNPADDED_MIN, UNPADDED_MAX + 1, UNPADDED_SEQS)
    cu = np.cumsum([0] + list(lens)).astype(np.int32)
    total = -(-int(cu[-1]) // 128) * 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((total, H, D), generator=g, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    return lens, cu, total, q, k, v, do


def _block_pairs(cu, total, causal, per_seq=None):
    """The 128 x 128 (q, k) block pairs B1 walks on the packed row (every
    pair, or below the diagonal when causal), those whose segment ranges
    meet (what a kernel that skipped segment-disjoint pairs would walk),
    and the padded batch's [n_seqs, per_seq] pairs, per head."""
    n = total // 128
    seg = np.full(total, -1)
    for i in range(len(cu) - 1):
        seg[cu[i]:cu[i + 1]] = i
    blocks = seg.reshape(n, 128)
    lo = np.where(blocks >= 0, blocks, 1 << 30).min(1)
    hi = blocks.max(1)
    walk = meet = 0
    for i in range(n):
        for j in range(i + 1 if causal else n):
            walk += 1
            meet += int(hi[i] >= 0 and hi[j] >= 0 and lo[i] <= hi[j]
                        and lo[j] <= hi[i])
    m = (per_seq or UNPADDED_MAX) // 128
    padded = (len(cu) - 1) * (m * (m + 1) // 2 if causal else m * m)
    return dict(packed=walk, segments_meet=meet, padded=padded)


def unpadded_case(name, H, D, causal, seed) -> dict:
    """One flash_attn_unpadded case: the call end to end in bf16 with its
    backward, B1/B2's launches counted by design around it; outputs and
    gradients held to B1/B2's plain versions run in f32 on the card on
    the same bf16 values (B2's from B1's own o and lse; FLASH_TOL bf16,
    as phase 3), padding rows and
    their gradients exactly 0; then timed by events (the call, its
    forward + backward) and B1 / B2 alone by graph replay, beside the
    same sequences padded to [n_seqs, 512] through B1 / B2 without
    segment ids, and the block pairs each walks."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    lens, cu, total, q, k, v, do = _unpadded_inputs(H, D, seed)
    cu_t = torch.as_tensor(cu, device="cuda")
    mx = int(lens.max())
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.reset_counters()
    out, soft = F.flash_attn_unpadded(qg, kg, vg, cu_t, cu_t, mx, mx,
                                      causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(fwd=dict(fa.flash_fwd.design_launches),
                    bwd=dict(fa.flash_bwd.design_launches),
                    plain=(fa.flash_fwd.plain_calls,
                           fa.flash_bwd.plain_calls))
    end = int(cu[-1])
    pad_zero = all(not bool(t[end:].any())
                   for t in (out, qg.grad, kg.grad, vg.grad))
    # B1 / B2's plain versions (f32 inside) on the same bf16 operands,
    # B2's from the kernel's own (o, lse), as phase 3 holds them: B2's
    # delta reads o as B1 rounded it
    sc = D ** -0.5
    qs = q * float(torch.tensor(sc, dtype=q.dtype))
    q_seg = F._segments_of(cu_t, total, q.device)
    kv_seg = torch.where(q_seg < 0, -2, q_seg)
    segs = (q_seg[None], kv_seg[None])
    qs1, k1, v1, do1 = qs[None], k[None], v[None], do[None]
    o1, lse1 = fa._fwd_cuda(qs1, k1, v1, causal, segs)
    wo, _ = fa.flash_fwd(qs1, k1, v1, causal, segs, path="torch")
    wdq, wdk, wdv = fa.flash_bwd(qs1, k1, v1, o1, lse1, do1, sc, causal,
                                 segs, path="torch")
    pairs = (("o", out.detach(), wo), ("dq", qg.grad, wdq),
             ("dk", kg.grad, wdk), ("dv", vg.grad, wdv))
    errs = {n: _norm_err(g[None], w) for n, g, w in pairs}
    abs_errs = {n: float((g[None].float() - w.float()).abs().max())
                for n, g, w in pairs}
    same_o = torch.equal(o1[0], out.detach())
    del pairs
    del wo, wdq, wdk, wdv
    torch.cuda.empty_cache()
    # times
    call = lambda: F.flash_attn_unpadded(q, k, v, cu_t, cu_t, mx, mx,
                                         causal=causal)
    fwd_bwd = lambda: torch.autograd.grad(
        F.flash_attn_unpadded(qg, kg, vg, cu_t, cu_t, mx, mx,
                              causal=causal)[0], (qg, kg, vg), do)
    b1 = lambda: fa._fwd_cuda(qs1, k1, v1, causal, segs)
    b2 = lambda: fa._bwd_cuda(qs1, k1, v1, o1, lse1, do1, causal, segs, sc)
    # the padded yardstick: each sequence at the start of its own row
    nseq = len(lens)
    pads = [torch.zeros((nseq, UNPADDED_MAX, H, D), dtype=q.dtype,
                        device="cuda") for _ in range(4)]
    for i in range(nseq):
        for p, t in zip(pads, (qs, k, v, do)):
            p[i, :lens[i]] = t[cu[i]:cu[i + 1]]
    po, plse = fa._fwd_cuda(pads[0], pads[1], pads[2], causal, None)
    b1p = lambda: fa._fwd_cuda(pads[0], pads[1], pads[2], causal, None)
    b2p = lambda: fa._bwd_cuda(pads[0], pads[1], pads[2], po, plse, pads[3],
                               causal, None, sc)
    pairs_valid = int(sum(int(n) * (int(n) + 1) // 2 if causal
                          else int(n) ** 2 for n in lens)) * H
    spec = (1, total, total, H, H, D, causal, True, False)
    rec = dict(case=name, seqs=nseq, tokens=end, total=total, H=H, D=D,
               causal=causal, launches_by_design=launches,
               padding_exactly_zero=pad_zero,
               call_o_equals_b1s=same_o, norm_err=errs,
               max_abs_err=abs_errs, call_ms=cuda_ms(call),
               fwd_bwd_ms=cuda_ms(fwd_bwd), b1_ms_graph=graph_ms(b1),
               b2_ms_graph=graph_ms(b2), padded_b1_ms_graph=graph_ms(b1p),
               padded_b2_ms_graph=graph_ms(b2p),
               block_pairs=_block_pairs(cu, total, causal),
               valid_pairs=pairs_valid)
    for kind in ("fwd", "bwd"):
        bms, by, _nb, _fl = _flash_bound(spec, pairs_valid, 2, kind == "bwd")
        rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = bms, by
    rec["b1_factor_vs_padded"] = rec["b1_ms_graph"] / rec["padded_b1_ms_graph"]
    rec["b2_factor_vs_padded"] = rec["b2_ms_graph"] / rec["padded_b2_ms_graph"]
    _check(f"[unpadded] {name}:", {
        "one sm90 B1 and one sm90 B2 launch, no plain version": (
            launches["fwd"], launches["bwd"], launches["plain"]) == (
            {"sm90": 1, "simple": 0}, {"sm90": 1, "simple": 0}, (0, 0)),
        "the softmax is not returned": soft is None,
        "padding rows and their gradients exactly 0": pad_zero,
        "the call's output is B1's on the packed row": same_o,
        f"o, dq, dk, dv within {FLASH_TOL['bf16']:.2e} of the plain "
        "versions (f32 inside; B2's from B1's o and lse)":
            max(errs.values()) <= FLASH_TOL["bf16"],
    }, rec)
    bp = rec["block_pairs"]
    log(f"[unpadded] {name}: {nseq} sequences, {end} tokens packed into "
        f"{total}; launches {launches}; normalised err "
        f"{ {n: f'{e:.2e}' for n, e in errs.items()} }; the call "
        f"{rec['call_ms']:.3f} ms by events, fwd+bwd "
        f"{rec['fwd_bwd_ms']:.3f}; B1 {rec['b1_ms_graph']:.4f} ms by replay"
        f" (padded [{nseq}, {UNPADDED_MAX}] {rec['padded_b1_ms_graph']:.4f},"
        f" x{rec['b1_factor_vs_padded']:.2f}; bound "
        f"{rec['fwd_bound_ms']:.4f} {rec['fwd_bound_by']}), B2 "
        f"{rec['b2_ms_graph']:.4f} (padded {rec['padded_b2_ms_graph']:.4f},"
        f" x{rec['b2_factor_vs_padded']:.2f}; bound {rec['bwd_bound_ms']:.4f}"
        f"); block pairs a head: packed {bp['packed']}, of which "
        f"{bp['segments_meet']} meet a segment, padded {bp['padded']}")
    del q, k, v, do, qg, kg, vg, out, pads, po, plse, o1, lse1
    _fresh_card()
    return rec


def unpadded_phase() -> list:
    """Phase 25: flash_attn_unpadded through B1/B2."""
    return [unpadded_case(*case) for case in UNPADDED_CASES]


# ---------------------------------------------------------------------------
# phase 26: the rest of the nn surface on the card
# ---------------------------------------------------------------------------
# LLaMA-2-7B's MLP up projection: 4096 -> 11008, 2048 tokens, bf16
QUANT_IN, QUANT_OUT, QUANT_TOKENS = 4096, 11008, 2048
# the card against the CPU on the same bf16 inputs: both dequantize to
# f32 and sum 4096 f32 products (in other orders), then round to bf16;
# a sum near a rounding boundary lands on either side: one bf16 ulp
# (2^-8 relative) of the row's size
QUANT_TOL = 2.0 ** -7
# the bidirectional RNNs, card against CPU in f32 with TF32 off: the
# same recurrence, its products summed in other orders over 20 steps
RNN_CARD_TOL = 1e-4


def _quant_on_card() -> dict:
    """weight_quantize (int8, int4, llm.int8) on the card and on the
    CPU from the same f32 weight: the codes and scales equal exactly;
    weight_only_linear (int8, int4) and llm_int8_linear on bf16
    activations (two columns of outliers for LLM.int8()) held to the CPU
    within QUANT_TOL, LLM.int8()'s split (outlier columns, int8 codes)
    equal exactly; each timed by events beside a bf16 torch.matmul of
    the dequantized weight (a yardstick)."""
    import torch
    from paddle_tpu_torch.nn import quant as tq
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((QUANT_IN, QUANT_OUT), generator=g, device="cuda") * 0.02
    x = torch.randn((QUANT_TOKENS, QUANT_IN), generator=g, device="cuda")
    x[:, 7] *= 40.0
    x[:, QUANT_IN // 4] *= 25.0
    x = x.to(torch.bfloat16)
    w_cpu, x_cpu = w.cpu(), x.cpu()
    rec, checks = {}, {}
    for algo, wdt in (("weight_only_int8", "int8"),
                      ("weight_only_int4", "int4"), ("llm.int8", None)):
        q, s = tq.weight_quantize(w, algo=algo)
        q_cpu, s_cpu = tq.weight_quantize(w_cpu, algo=algo)
        same = torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)
        checks[f"{algo} codes and scales equal the CPU's"] = same
        if wdt is not None:
            fn = lambda: tq.weight_only_linear(x, q, None, s, wdt)
            want = tq.weight_only_linear(x_cpu, q_cpu, None, s_cpu, wdt)
        else:
            fn = lambda: tq.llm_int8_linear(x, q, None, s)
            want = tq.llm_int8_linear(x_cpu, q_cpu, None, s_cpu)
            split = tq._int8_split(x.float(), 6.0)
            split_cpu = tq._int8_split(x_cpu.float(), 6.0)
            checks["LLM.int8() outlier columns and codes equal the CPU's"] = (
                torch.equal(split[0].cpu(), split_cpu[0])
                and torch.equal(split[2].cpu(), split_cpu[2]))
            rec["llm_int8_outlier_columns"] = int(split[0].sum())
        err = _norm_err(fn().cpu(), want)
        checks[f"{algo} product within {QUANT_TOL:g} of the CPU's"] = \
            err <= QUANT_TOL
        wdq = tq.weight_dequantize(q, s, "weight_only_int4" if wdt == "int4"
                                   else "weight_only_int8", "bfloat16")
        rec[algo] = dict(norm_err=err, ms=cuda_ms(fn, iters=10),
                         bf16_matmul_ms=cuda_ms(lambda: x @ wdq, iters=10),
                         codes_bytes=q.numel() * q.element_size())
    _check("[nn-surface] quant at LLaMA-2-7B's MLP widths:", checks, rec)
    return rec


def _rnn_on_card() -> dict:
    """LSTM, GRU and SimpleRNN, 2 layers, direction "bidirect", on the
    card and on the CPU from the same weights and inputs (f32, TF32
    off): outputs, final states and the grads of the input and every
    weight within RNN_CARD_TOL (normalised by each tensor's size)."""
    import torch
    import paddle_tpu_torch as P
    rec, checks = {}, {}
    x0 = np.random.default_rng(3).standard_normal((8, 20, 64)).astype(
        np.float32)
    for mode in ("LSTM", "GRU", "SimpleRNN"):
        outs = {}
        for dev in ("cpu", "cuda"):
            layer = getattr(P.nn, mode)(64, 128, num_layers=2,
                                        direction="bidirect", device=dev)
            if dev == "cpu":
                sd = {k: v.numpy() for k, v in layer.state_dict().items()}
            else:
                layer.set_state_dict(sd)
            x = torch.tensor(x0, device=dev, requires_grad=True)
            with _f32_exact():
                out, st = layer(x)
                flat = [out] + (list(st) if mode == "LSTM" else [st])
                crng = np.random.default_rng(4)
                cot = [torch.tensor(crng.standard_normal(tuple(t.shape)),
                                    dtype=torch.float32, device=dev)
                       for t in flat]
                grads = torch.autograd.grad(
                    flat, list(torch.nn.Module.parameters(layer)) + [x],
                    cot)
            outs[dev] = [t.detach().cpu() for t in flat + list(grads)]
        err = max(_norm_err(a, b, rows=False)
                  for a, b in zip(outs["cuda"], outs["cpu"]))
        rec[mode] = dict(norm_err=err)
        checks[f"{mode} bidirect: outputs, states and grads within "
               f"{RNN_CARD_TOL:g} of the CPU"] = err <= RNN_CARD_TOL
    _check("[nn-surface] RNN layers on the card:", checks, rec)
    return rec


def surface_phase(eager) -> dict:
    """Phase 26: the new ops' cases of phase 22's sweep (card against
    CPU), quantized linears at LLaMA-2-7B's MLP widths against the CPU,
    and the bidirectional RNN layers against the CPU."""
    sweep = eager["sweep"]
    cases = sweep["nn_cases"]
    _check("[nn-surface] sweep:", {
        f"the {len(cases)} new cases agree with the CPU (phase 22)":
            not sweep["nn_failures"],
    }, cases)
    quant = _quant_on_card()
    rnn = _rnn_on_card()
    log(f"[nn-surface] {len(cases)} new op cases on the card, largest "
        f"difference {max(cases.values()):.2e}; quant "
        + "; ".join(f"{a}: {r['ms']:.3f} ms (bf16 matmul "
                    f"{r['bf16_matmul_ms']:.3f}), err {r['norm_err']:.2e}"
                    for a, r in quant.items() if isinstance(r, dict))
        + f"; RNN bidirect vs CPU {json.dumps(rnn)}")
    return dict(sweep_cases=cases, quant=quant, rnn=rnn)


# ---------------------------------------------------------------------------
# phase 27: jit.save / inference.Predictor; phase 28: hapi.Model.fit
# ---------------------------------------------------------------------------
EXPORT_BATCHES = (32, 8)
EXPORT_RUNS = 10
# the exported program against the eager model: the same torch ops on
# the same bf16 weights, so bit-equal is expected; a difference beyond
# one bf16 rounding of the hidden states' scale would be a fault
EXPORT_TOL = 2.0 ** -6


def _bert_numpy_weights(model, std, seed=0):
    """`model`'s state from a numpy seed (the reference's initializer
    scales: N(0, std) for embeddings and weights, norms at 1 and 0,
    biases 0), by its names."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in _torch_state(model).items():
        shape = tuple(v.shape)
        if "norm" in k:
            out[k] = (np.ones if k.endswith("weight") else np.zeros)(
                shape, np.float32)
        elif k.endswith("bias"):
            out[k] = np.zeros(shape, np.float32)
        else:
            out[k] = std * rng.standard_normal(shape, dtype=np.float32)
    return out


def _bitwise_equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def _export_small_cpu_program(P, d) -> dict:
    """27's last part: bert_tiny in f32 exported from CPU tensors, loaded
    onto the CPU and, through a Predictor, onto the card (the program
    moved there at load); the two held within 1e-5 with TF32 off."""
    import torch

    from paddle_tpu_torch.models import bert
    cfg = bert.bert_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    torch.manual_seed(0)
    m = bert.BertModel(cfg, device="cpu").eval()
    path = f"{d}/bert_tiny_cpu"
    P.jit.save(m, path, input_spec=[P.jit.InputSpec([None, 128], "int64")])
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 128))
    cpu = [t.numpy() for t in P.jit.load(path, device="cpu")(ids)]
    with _f32_exact():
        pred = P.inference.create_predictor(P.inference.Config(path))
        card = pred.run([ids])
    err = max(float(np.abs(g - c).max()) for g, c in zip(card, cpu))
    return dict(saved_on="cpu", served_on=str(pred._layer._device),
                max_abs_err=err, ok=err <= 1e-5)


def export_phase() -> dict:
    """Phase 27: a bert_base encoder (BertModel, 12 x 768, 12 heads,
    vocab 30,522) from numpy-seeded weights through
    ``bert_params_from_numpy``, bf16 by ``amp.decorate(level="O2")``,
    saved by ``jit.save`` with ``InputSpec([None, 512], "int64")``,
    loaded by ``inference.Config`` + ``create_predictor`` and served at
    batches 32 and 8 through the handle API: B1's launches from inside
    the loaded program, the outputs against the eager model, the replay
    against the loaded module's eager call, a run's ms by wall (host
    copies included) and by replay beside the eager forward, captures
    and replays, save and load seconds and the artifact's MiB; then a
    small program saved on the CPU and served on the card."""
    import os
    import tempfile

    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch import bert_params_from_numpy
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    L, s = cfg.num_layers, BERT_SEQ
    hd = cfg.hidden_size // cfg.num_heads
    _require_sm90("bert_base export", (max(EXPORT_BATCHES), s, cfg.num_heads,
                                       hd), (max(EXPORT_BATCHES), s,
                                             cfg.num_heads, hd))
    _fresh_card()
    saved_place = tdevice._current_place
    P.set_device("gpu:0")
    try:
        model = bert.BertModel(cfg, device="cuda")
        model.load_state_dict(bert_params_from_numpy(
            _bert_numpy_weights(model, cfg.initializer_range)))
        P.amp.decorate(models=model, level="O2", dtype="bfloat16")
        model.eval()
        n_params = sum(p.numel() for p in _torch_params(model))
        rng = np.random.default_rng(0)
        ids = {b: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
               for b in EXPORT_BATCHES}
        with torch.no_grad():
            want = {b: model(torch.as_tensor(x, device="cuda"))
                    for b, x in ids.items()}
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/bert_base"
            t = time.perf_counter()
            P.jit.save(model, path, input_spec=[
                P.jit.InputSpec([None, s], "int64")])
            save_s = time.perf_counter() - t
            mib = sum(os.path.getsize(path + suf) for suf in (
                ".pdmodel", ".pdiparams", ".pdconsts")) / 2 ** 20
            t = time.perf_counter()
            pred = P.inference.create_predictor(P.inference.Config(
                path + ".pdmodel", path + ".pdiparams"))
            load_s = time.perf_counter() - t
            small = _export_small_cpu_program(P, d)
        loaded = pred._layer

        # B1 from inside the loaded program: one eager call a batch
        eager_runs = {}
        for b, x in ids.items():
            fa.reset_counters()
            out = loaded._run(loaded._inputs([x]))
            torch.cuda.synchronize()
            eager_runs[b] = dict(
                out=out, launches=dict(fa.flash_fwd.design_launches),
                plain=fa.flash_fwd.plain_calls)
        # the Predictor's runs: handle API, one graph a batch signature
        cuda_graph.reset_counters()
        fa.reset_counters()
        served = {}
        for b, x in ids.items():
            pred.get_input_handle("x0").copy_from_cpu(x)
            pred.run()
            served[b] = [pred.get_output_handle(n).copy_to_cpu()
                         for n in pred.get_output_names()]
        capture_launches = dict(fa.flash_fwd.design_launches)
        rows = {}
        for b in EXPORT_BATCHES:
            host = [torch.as_tensor(a.view(np.int16)).view(torch.bfloat16)
                    if a.dtype.name == "bfloat16" else torch.as_tensor(a)
                    for a in served[b]]
            rows[b] = dict(
                replay_bit_equal_to_loaded=all(
                    _bitwise_equal(h, o.cpu())
                    for h, o in zip(host, eager_runs[b]["out"])),
                bit_equal_to_eager_model=all(
                    _bitwise_equal(o, w) for o, w in zip(
                        eager_runs[b]["out"], want[b])),
                max_abs_err_to_eager_model=max(
                    float((o.float() - w.float()).abs().max())
                    for o, w in zip(eager_runs[b]["out"], want[b])),
                finite=all(bool(torch.isfinite(h.float()).all())
                           for h in host),
                shapes=[list(h.shape) for h in host],
                b1_launches=eager_runs[b]["launches"],
                b1_plain_calls=eager_runs[b]["plain"])
        del eager_runs, want

        # timing at batch 32: a run by wall (the host copies and the
        # numpy outputs included), the graph alone by replay, the eager
        # module and the eager model by events
        b = EXPORT_BATCHES[0]
        x = ids[b]
        walls = []
        for _ in range(EXPORT_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pred.run([x])
            walls.append(1e3 * (time.perf_counter() - t))
        captured, _ = next(iter(pred._graphs.values()))
        replay_ms = cuda_ms(captured.graph.replay, iters=EXPORT_RUNS)
        xs = loaded._inputs([x])
        loaded_ms = cuda_ms(lambda: loaded._run(xs), iters=EXPORT_RUNS)
        xt = torch.as_tensor(x, device="cuda")
        with torch.no_grad():
            model_ms = cuda_ms(lambda: model(xt), iters=EXPORT_RUNS)
        captures = dict(cuda_graph.captures)
        replays = dict(cuda_graph.replays)
        del pred, loaded, model, captured, xs, xt
    finally:
        tdevice._current_place = saved_place
    rec = dict(
        config="bert_base encoder (BertModel), bf16 O2", layers=L,
        params=n_params, seq=s, batches=list(EXPORT_BATCHES),
        save_s=save_s, load_s=load_s, artifact_mib=mib,
        by_batch={str(k): v for k, v in rows.items()},
        b1_launches_per_run=rows[b]["b1_launches"],
        b1_launches_capturing=capture_launches,
        captures=captures, replays=replays,
        run_ms_wall=walls, run_ms_wall_median=statistics.median(walls),
        run_ms_replay=replay_ms, loaded_module_ms=loaded_ms,
        eager_model_ms=model_ms, cpu_saved_program=small, card=card_line())
    want_launches = {"sm90": L, "simple": 0}
    _check("[export]", {
        f"B1 at {L} sm90 launches a run from inside the loaded program, no "
        "plain call": all(r["b1_launches"] == want_launches
                          and r["b1_plain_calls"] == 0
                          for r in rows.values()),
        "the Predictor's replays bit-equal to the loaded module's eager "
        "call": all(r["replay_bit_equal_to_loaded"] for r in rows.values()),
        f"the loaded program within {EXPORT_TOL} of the eager model":
            all(r["max_abs_err_to_eager_model"] <= EXPORT_TOL
                for r in rows.values()),
        "every output finite, of the encoder's shapes": all(
            r["finite"] and r["shapes"] == [[k, s, cfg.hidden_size],
                                            [k, cfg.hidden_size]]
            for k, r in rows.items()),
        "one capture a batch size, every run a replay":
            captures.get("predictor") == len(EXPORT_BATCHES)
            and replays.get("predictor") == len(EXPORT_BATCHES)
            + EXPORT_RUNS,
        "the capture's runs launch B1 through the operator, sm90 only":
            capture_launches == {"sm90": 2 * L * len(EXPORT_BATCHES),
                                 "simple": 0},
        "a program saved on the CPU serves on the card (within 1e-5)":
            small["ok"],
    }, rec)
    log(f"[export] bert_base encoder ({n_params:,} parameters, bf16 O2) "
        f"saved by jit.save in {save_s:.2f} s ({mib:.1f} MiB), loaded by "
        f"create_predictor in {load_s:.2f} s; B1 a run from inside the "
        f"loaded program {rec['b1_launches_per_run']}; batch {b} x s{s}: "
        f"a run {rec['run_ms_wall_median']:.2f} ms by wall (host copies "
        f"included), {replay_ms:.3f} ms by replay, the loaded module "
        f"eagerly {loaded_ms:.3f} ms, the eager model {model_ms:.3f} ms; "
        f"captures {captures}, replays {replays}; by batch "
        f"{json.dumps(rec['by_batch'])}; saved on the CPU, served on the "
        f"card {json.dumps(small)}; card {rec['card']}")
    _fresh_card()
    return rec


def hapi_phase(eager) -> dict:
    """Phase 28: phase 22's nn.Layer GPT (bench_gpt2_small's config:
    b16 x s1024, 12 x 768, dropout 0) trained 3 steps by
    ``hapi.Model(net).prepare(AdamW, loss, metric.Accuracy()).fit(...)``
    over a DataLoader of an io.Dataset of phase 22's batches, under phase
    22's bf16 O1 auto_cast (tests/hapi_gpt_script.py): losses and every
    parameter bit-equal to phase 22's eager steps, B1/B2 at 12 sm90
    launches a step, the step by wall beside phase 22's; summary's
    parameter count and FLOPs row, evaluate and predict on one batch, a
    Model.save / load round trip whose next step is bit-equal, and the
    net's forward through to_static equal to its eager forward."""
    import contextlib
    import io
    import tempfile

    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.kernels import flash_attention as fa
    g = EAGER_GPT
    S = _tests_module("eager_gpt_layer_script")
    H = _tests_module("hapi_gpt_script")
    L, heads, batches = g["L"], g["H"], g["batches"]
    b, s = batches[0][0].shape
    marks = []

    def mark(_i=None):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), 0,
                      dict(fa.flash_fwd.design_launches),
                      dict(fa.flash_bwd.design_launches)))

    saved_place = tdevice._current_place
    P.set_device("gpu:0")
    try:
        _fresh_card()
        losses, accs, model = H.hapi_fit(
            P, S, g["weights"], batches, L, heads, lr=EAGER_LR, amp=True,
            on_step=mark)
        steps = _step_marks(marks)
        net = model.network
        sd = net.state_dict()
        bit_equal = losses == g["losses"] and all(
            torch.equal(sd[k]._data, w)
            for k, w in zip(g["names"], g["params"]))
        del sd
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            summ = P.summary(net, (b, s), dtypes="int32")
        flops_row = next(line for line in text.getvalue().splitlines()
                         if line.startswith("Total FLOPs"))
        one = H.batch_loader(P, batches[:1])
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            t = time.perf_counter()
            ev = model.evaluate(one)
            evaluate_s = time.perf_counter() - t
            (logits,) = model.predict(one)
        pred_shape, pred_finite = logits.shape, bool(
            torch.isfinite(logits._data.float()).all())
        # what a fit step adds to the eager step: Accuracy over the
        # logits (top-1 on the card, its hits read back) and the
        # loader's batch, each by wall, synchronised
        labels = P.to_tensor(batches[0][1])
        metric_ms, loader_ms = [], []
        for _ in range(3):
            acc = P.metric.Accuracy()
            torch.cuda.synchronize()
            t = time.perf_counter()
            acc.update(acc.compute(logits, labels))
            torch.cuda.synchronize()
            metric_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            next(iter(one))
            torch.cuda.synchronize()
            loader_ms.append(1e3 * (time.perf_counter() - t))
        del logits, labels
        with tempfile.TemporaryDirectory() as d:
            t = time.perf_counter()
            fresh, loss_fresh, loss_orig = H.round_trip(
                P, S, model, f"{d}/gpt2_small", batches[0], g["weights"], L,
                heads, lr=EAGER_LR, amp=True)
            round_trip_s = time.perf_counter() - t
        a, c = fresh.network.state_dict(), net.state_dict()
        round_trip_equal = loss_fresh == loss_orig and all(
            torch.equal(a[k]._data, c[k]._data) for k in g["names"])
        del a, c, fresh
        ids = P.to_tensor(batches[0][0])
        net.eval()
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            eager_out = net(ids)._data.clone()
            P.jit.to_static(net)
            t = time.perf_counter()
            static_out = net(ids)._data
            to_static_s = time.perf_counter() - t
        (program,) = net.forward.concrete_programs
        probe_b1 = sum(1 for n in program.graph.nodes
                       if n.target is torch.ops.paddle_tpu_torch.flash_fwd
                       .default)
        static_equal = torch.equal(static_out, eager_out)
        del model, net, program, eager_out, static_out, ids
    finally:
        tdevice._current_place = saved_place
    layer_ms = eager["gpt"]["nn_layer_gpt"]["step_ms"]
    rec = dict(
        config="gpt2_small from nn.Layers (bench_gpt2_small)", layers=L,
        batch=b, seq=s, steps=len(batches), losses=losses,
        phase22_losses=g["losses"], accuracies=accs, bit_equal=bit_equal,
        step_ms=[st["ms"] for st in steps],
        step_ms_after_first=statistics.mean(st["ms"] for st in steps[1:]),
        phase22_layer_step_ms=layer_ms,
        accuracy_update_ms=statistics.median(metric_ms),
        loader_batch_ms=statistics.median(loader_ms),
        b1_by_step=[st["b1"] for st in steps],
        b2_by_step=[st["b2"] for st in steps],
        summary=summ, flops_row=flops_row, evaluate=ev,
        evaluate_s=evaluate_s, predict_shape=pred_shape,
        round_trip_next_step_bit_equal=round_trip_equal,
        round_trip_losses=[loss_fresh, loss_orig],
        round_trip_s=round_trip_s, to_static_equal=static_equal,
        to_static_probe_b1_ops=probe_b1, to_static_first_call_s=to_static_s,
        card=card_line())
    want = {"sm90": L, "simple": 0}
    _check("[hapi]", {
        "Model.fit's losses and parameters bit-equal to phase 22's eager "
        "steps": bit_equal,
        f"B1 and B2 at {L} sm90 launches a step": all(
            st["b1"] == want and st["b2"] == want for st in steps),
        "summary counts the GPT's parameters and a FLOPs row":
            summ["total_params"] == sum(
                int(np.prod(w.shape)) for w in g["weights"].values())
            and summ.get("total_flops", 0) > 0,
        "evaluate's loss finite, predict's logits finite of [b, s, vocab]":
            bool(np.isfinite(ev["loss"])) and pred_finite
            and pred_shape[:2] == [b, s],
        "Model.save / load: the next step bit-equal": round_trip_equal,
        f"to_static: the forward equal to eager, its probe holding {L} B1 "
        "operators": static_equal and probe_b1 == L,
    }, rec)
    log(f"[hapi] gpt2_small from nn.Layers through Model.fit, bf16 O1, "
        f"b{b} x s{s}: steps {[round(x, 2) for x in rec['step_ms']]} ms by "
        f"wall (phase 22's nn.Layer steps "
        f"{[round(x, 2) for x in layer_ms]}; of a fit step, Accuracy's "
        f"update {rec['accuracy_update_ms']:.2f} ms and a loader batch "
        f"{rec['loader_batch_ms']:.2f} ms); losses {losses} (bit-equal "
        f"to phase 22 {bit_equal}); B1 {rec['b1_by_step']}, B2 "
        f"{rec['b2_by_step']}; summary {summ} ({flops_row}); evaluate "
        f"{ev} in {evaluate_s:.2f} s; predict {pred_shape}; save/load "
        f"round trip {round_trip_s:.2f} s, next step {loss_fresh} against "
        f"{loss_orig} (bit-equal {round_trip_equal}); to_static equal "
        f"{static_equal}, probe {probe_b1} B1 operators, first call "
        f"{to_static_s:.2f} s; card {rec['card']}")
    _fresh_card()
    return rec


# ---------------------------------------------------------------------------
# phase 29: the vision zoo on the card; MobileNetV2 trained at
# bench_resnet50's recipe (bench.py:193)
# ---------------------------------------------------------------------------
# the card (phases 29-30 put their tensors there)
CARD = "cuda"
# (constructor, image side, in channels): every constructor of the zoo
# but the ResNets (phase 19), 1000 classes, batch 2
ZOO_MODELS = [("LeNet", 28, 1), ("alexnet", 224, 3), ("vgg11", 224, 3),
              ("vgg13", 224, 3), ("vgg16", 224, 3), ("vgg19", 224, 3),
              ("mobilenet_v2", 224, 3), ("densenet121", 224, 3),
              ("densenet161", 224, 3), ("densenet169", 224, 3),
              ("densenet201", 224, 3), ("squeezenet1_0", 224, 3),
              ("squeezenet1_1", 224, 3), ("mobilenet_v1", 224, 3),
              ("mobilenet_v3_small", 224, 3), ("mobilenet_v3_large", 224, 3),
              ("shufflenet_v2_x0_5", 224, 3), ("shufflenet_v2_x1_0", 224, 3),
              ("shufflenet_v2_x2_0", 224, 3), ("googlenet", 224, 3),
              ("inception_v3", 299, 3)]
# eval logits, card against CPU, f32 with TF32 off: the same convolutions
# summed in other orders (cuDNN's algorithms against oneDNN's), no batch
# statistics to amplify them; within this share of the largest logit
ZOO_TOL = 1e-4
# a stage's output (over its largest) and gradients (over the stage's
# largest gradient norm), card against CPU in f32 with TF32 off
MOBILENET_STAGE_TOL = 1e-4


def _zoo_forward_on_card() -> dict:
    """Phase 29a: each zoo constructor's eval logits at batch 2, built
    from one seed on the CPU, then moved to the card: the card's logits
    against the CPU's (f32, TF32 off) within ZOO_TOL of the largest."""
    import torch
    from paddle_tpu_torch.vision import models
    rec = {}
    for name, hw, cin in ZOO_MODELS:
        model = getattr(models, name)(num_classes=1000, device="cpu",
                                      seed=0).eval()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, cin, hw, hw)).astype(np.float32))
        with torch.no_grad():
            want = model(x)
            model.to(CARD)
            got = model(x.to(CARD))
            ms = cuda_ms(lambda: model(x.to(CARD)), iters=3, warmup=1)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        rec[name] = dict(image=hw, rel_err=err, ms=ms,
                         on_card=got.device.type == CARD,
                         params=sum(p.numel() for p in _torch_params(model)))
        del model, got
    _fresh_card()
    return rec


def _mobilenet_step(amp=True, seed=0, lr=0.1, dropout=None):
    """bench_resnet50's recipe on mobilenet_v2 (scale 1.0, 1000 classes,
    NCHW, random weights from `seed`): Momentum(lr, 0.9, weight decay
    1e-4), the forward under bf16 O1 auto_cast when `amp`, the loss
    cross_entropy of the logits outside it; `dropout` sets the
    classifier's."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import optimizers
    from paddle_tpu_torch.vision.models import mobilenet_v2
    model = mobilenet_v2(device=CARD, seed=seed)
    if dropout is not None:
        model.classifier[0].p = dropout
    model.train()
    opt = optimizers.Momentum(learning_rate=lr, momentum=0.9,
                              weight_decay=1e-4,
                              parameters=_torch_params(model))

    def loss_fn(m, x, y):
        with tamp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            logits = m(x)
        return F.cross_entropy(logits, y)

    return model, TrainStep(model, opt, loss_fn)


def _mac_count(model, hw) -> float:
    """Multiply-adds of one image's forward, from the layers' shapes: a
    convolution's output elements x (in channels / groups) x kh x kw, a
    Linear's in x out."""
    import torch
    from paddle_tpu_torch.nn.layers import Conv2D, Linear
    macs = [0]

    def conv(m, inputs, out):
        w = m._parameters["weight"]
        macs[0] += out[0].numel() * w.shape[1] * w.shape[2] * w.shape[3]

    def lin(m, inputs, out):
        w = m._parameters["weight"]
        macs[0] += out[0].numel() * w.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D) else lin)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1, 3, hw, hw), device=CARD))
    model.train(was)
    for h in hooks:
        h.remove()
    return float(macs[0])


def _mobilenet_stages(m):
    """mobilenet_v2's forward cut into stages: the stem (conv, bn,
    ReLU6), each inverted residual block, the last 1x1 conv with its bn
    and ReLU6, the head (pool, flatten, classifier)."""
    from paddle_tpu_torch.nn import functional as F
    f = m.features
    n = len(f)
    return ([("stem", lambda v: f[2](f[1](f[0](v))))]
            + [(f"features.{i}", f[i]) for i in range(3, n - 3)]
            + [("last", lambda v: f[n - 1](f[n - 2](f[n - 3](v)))),
               ("head", lambda v: m.classifier(F.flatten(m.pool2d_avg(v),
                                                         1)))])


def _mobilenet_stage_of(name, n=23):
    head = name.split(".")
    if head[0] == "classifier":
        return "head"
    i = int(head[1])
    return "stem" if i < 3 else "last" if i >= n - 3 else f"features.{i}"


def _mobilenet_card_vs_cpu(seed=2) -> dict:
    """Phase 29c: one train-mode step of mobilenet_v2 (f32, dropout 0)
    on the CPU, stage by stage (each stage's input a leaf, its output's
    cotangent the next stage's input gradient), then each stage on the
    card from the CPU's input and cotangent: the card's stage output
    within MOBILENET_STAGE_TOL of its largest, its parameters' and
    input's gradients within MOBILENET_STAGE_TOL of the stage's largest
    gradient norm."""
    import torch
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import mobilenet_v2
    cpu = mobilenet_v2(device="cpu", seed=seed)
    card = mobilenet_v2(device=CARD, seed=seed)
    card.load_state_dict(_torch_state(cpu))
    for m in (cpu, card):
        m.classifier[0].p = 0.0
        m.train()
    x, y = _images(RESNET_SUB_BATCH, RESNET_SUB_HW, seed,
                   channels_last=False)
    x, y = x.cpu(), y.cpu()
    stages = _mobilenet_stages(cpu)
    leaves, outs, cur = [], [], x
    for _, f in stages:
        leaves.append(cur.detach().requires_grad_())
        outs.append(f(leaves[-1]))
        cur = outs[-1]
    F.cross_entropy(outs[-1], y).backward()
    cots = [None] * (len(stages) - 1)
    for k in reversed(range(len(stages) - 1)):
        cots[k] = leaves[k + 1].grad
        outs[k].backward(cots[k])
    params = dict(torch.nn.Module.named_parameters(cpu))
    rec = {}
    for k, (name, f) in enumerate(_mobilenet_stages(card)):
        xin = leaves[k].detach().to(CARD).requires_grad_()
        got = f(xin)
        if name == "head":
            F.cross_entropy(got, y.to(CARD)).backward()
        else:
            got.backward(cots[k].to(CARD))
        want = outs[k].detach()
        out_err = float((got.detach().cpu() - want).abs().max()
                        / want.abs().max())
        grads = {f"{name} input": (xin.grad, leaves[k].grad)}
        grads.update((n, (p.grad, params[n].grad))
                     for n, p in torch.nn.Module.named_parameters(card)
                     if _mobilenet_stage_of(n) == name)
        scale = max(float(w.norm()) for _, w in grads.values())
        rec[name] = dict(out_err=out_err, grad_err=max(
            float((g.cpu() - w).norm()) / scale for g, w in grads.values()))
    del cpu, card
    _fresh_card()
    return rec


def mobilenet_phase() -> dict:
    """Phase 29: the zoo's eval logits on the card against the CPU;
    mobilenet_v2 trained at bench_resnet50's recipe through TrainStep's
    graph (FLAGS_fast_bn_stats on, put back after); then in f32 with
    TF32 off and cuDNN deterministic, graph steps bit-equal to eager
    steps and the card's step against the CPU's by stage."""
    from paddle_tpu_torch import get_flags, set_flags
    with _f32_exact():
        zoo = _zoo_forward_on_card()
    _check("[zoo]", {
        f"{len(zoo)} constructors' logits on the card within {ZOO_TOL:g} "
        f"of the CPU's": all(r["rel_err"] <= ZOO_TOL and r["on_card"]
                              for r in zoo.values()),
    }, zoo)
    log("[zoo] eval logits, card vs CPU (largest difference over the "
        "largest logit; ms a batch-2 forward by events): " + "; ".join(
            f"{n} {r['rel_err']:.1e} {r['ms']:.2f} ms"
            for n, r in zoo.items()))
    flag = "FLAGS_fast_bn_stats"
    saved = get_flags(flag)
    set_flags({flag: True})
    try:
        rec = _image_train_main(
            "[train-mobilenet_v2]", _mobilenet_step,
            "mobilenet_v2 (scale 1.0, 1000 classes, NCHW), bench_resnet50's"
            " recipe: bf16 O1, Momentum(0.1, 0.9, wd 1e-4), "
            "FLAGS_fast_bn_stats", 104,
            # bench.py's convention (bench.py:229-230): ResNet-50's 4.09e9
            # is its forward's multiply-adds at 224^2, counted as FLOPs; a
            # step 3x that
            lambda m: 3 * _mac_count(m, RESNET_HW))
    finally:
        set_flags(saved)
    with _f32_exact():
        sub = _image_graph_vs_eager(lambda: _mobilenet_step(
            amp=False, seed=1, lr=0.01, dropout=0.0))
        stages = _mobilenet_card_vs_cpu()
    _check("[train-mobilenet_v2]", {
        "graph steps == eager steps, bit for bit, buffers kept":
            sub["ok"] and sub["bit_equal"],
        f"every stage on the card within {MOBILENET_STAGE_TOL:g} of the "
        f"CPU's": all(r["out_err"] <= MOBILENET_STAGE_TOL
                      and r["grad_err"] <= MOBILENET_STAGE_TOL
                      for r in stages.values()),
    }, dict(graph_vs_eager=sub, stages=stages))
    worst = max(stages.items(), key=lambda kv: kv[1]["grad_err"])
    log(f"[train-mobilenet_v2] f32 batch {RESNET_SUB_BATCH} x "
        f"{RESNET_SUB_HW}^2: graph vs eager losses "
        f"{[round(v, 5) for v in sub['graph']['losses']]} vs "
        f"{[round(v, 5) for v in sub['eager']['losses']]}, bit-equal "
        f"{sub['bit_equal']}; card vs CPU by stage: largest output "
        f"difference {max(r['out_err'] for r in stages.values()):.2e}, "
        f"largest gradient difference {worst[1]['grad_err']:.2e} "
        f"({worst[0]})")
    rec.update(zoo=zoo, graph_vs_eager=sub, stages=stages)
    return rec


# ---------------------------------------------------------------------------
# phase 30: detection at COCO widths
# ---------------------------------------------------------------------------
# YOLOv3 (arXiv 1804.02767): 608^2 inputs, heads at strides 32, 16 and 8,
# 3 of the 9 COCO anchors each, 80 classes; 50 ground truths an image
YOLO_BATCH, YOLO_HW, YOLO_CLASSES, YOLO_GT = 8, 608, 80, 50
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = (([6, 7, 8], 32), ([3, 4, 5], 16), ([0, 1, 2], 8))
# images of the batch the CPU recomputes multiclass_nms for (80 classes
# x 1000 candidates an image: an IoU matrix of 8e7 pairs each)
YOLO_NMS_CPU = 2
# Faster R-CNN's C4 RPN on 2 images of 800 x 1333: a stride-16 map of
# 50 x 84, 15 anchors a cell (5 sizes x 3 ratios), Detectron's test
# proposal settings, RoIs pooled from a 1024-channel C4 map; R-FCN's
# position-sensitive map for psroi_pool (81 classes x 7 x 7)
RPN_IMAGES, RPN_H, RPN_W, RPN_STRIDE = 2, 50, 84, 16
RPN_IMAGE = (800, 1333)
RPN_SIZES, RPN_RATIOS = (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
RPN_PRE, RPN_POST, RPN_NMS = 6000, 1000, 0.7
C4_CHANNELS, PS_CLASSES, ROI_OUT = 1024, 81, 14
# the CPU recomputes every ROI_CPU_EVERY-th RoI of the pooling ops (each
# RoI's output depends on it alone)
ROI_CPU_EVERY = 10
# card against CPU: floats within this share of the largest, the
# decoded boxes within DET_BOX_TOL pixels
DET_TOL, DET_BOX_TOL = 1e-5, 1e-3


def _rpn_anchors():
    """[H, W, 15, 4] anchors (x1, y1, x2, y2) centred on the stride-16
    grid."""
    cells = []
    for s in RPN_SIZES:
        for r in RPN_RATIOS:
            w, h = s / np.sqrt(r), s * np.sqrt(r)
            cells.append((-w / 2, -h / 2, w / 2, h / 2))
    cells = np.asarray(cells, np.float32)
    ys = (np.arange(RPN_H) + 0.5) * RPN_STRIDE
    xs = (np.arange(RPN_W) + 0.5) * RPN_STRIDE
    ctr = np.stack(np.meshgrid(xs, ys), -1)                    # [H, W, 2]
    ctr = np.concatenate([ctr, ctr], -1)[:, :, None, :]
    return (ctr + cells[None, None]).astype(np.float32)


def _timed(fn, iters=3):
    """(result, times) of `fn` on the card. Unprofiled: `ms`, the median
    by CUDA events of `iters` calls, and `wall_ms`, one synchronised
    call by the host's clock. Under torch.profiler, in a call of its
    own: `device_ms`, the device time it records, and
    `profiled_wall_ms`, that call's wall time, the profiler's cost a
    launch included. `host_share` = 1 - device_ms / ms: how much of the
    op's unprofiled time its host loop does not hide (the events bracket
    the whole loop, the device's idle gaps included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = fn()
    ms = cuda_ms(fn, iters=iters, warmup=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t)
    dev_ms = _device_ms(prof)
    return out, dict(ms=ms, wall_ms=wall, device_ms=dev_ms,
                     profiled_wall_ms=prof_wall,
                     host_share=1 - dev_ms / ms)


def _fpn_levels(out, rois):
    """Each RoI's place in distribute_fpn_proposals' output `out` (on the
    CPU): its level's index where the output is consistent (the counts
    cover the RoIs, restore_index is a permutation whose rows, level by
    level in input order, hold the RoI's box), -1 for each RoI where it
    is not."""
    import torch
    *levels, counts, restore = [t.cpu() for t in out]
    r = rois.shape[0]
    idx = restore[:, 0].long()
    ends = torch.cumsum(counts.long(), 0)
    lv = torch.searchsorted(ends, idx, right=True)
    bad = torch.ones(r, dtype=torch.bool)
    if int(ends[-1]) == r and torch.equal(idx.sort().values,
                                          torch.arange(r)):
        lv = lv.clamp_max(len(levels) - 1)
        start = torch.cat([torch.zeros(1, dtype=torch.long), ends[:-1]])
        row = idx - start[lv]
        boxes = torch.cat(levels)[lv * r + row]
        # input order within a level: rows rise with the RoI's index
        ordered = torch.ones(r, dtype=torch.bool)
        for k in range(len(levels)):
            mine = (lv == k).nonzero()[:, 0]
            ordered[mine] = bool((row[mine].diff() > 0).all())
        bad = ~(torch.equal(boxes, rois) & ordered)
    return torch.where(bad, torch.full_like(lv, -1), lv)


def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _yolo_phase(rng) -> dict:
    """Phase 30a: YOLOv3's three heads at COCO widths on the card and on
    the CPU from the same inputs: yolo_loss forward and backward,
    yolo_box, then multiclass_nms over the three heads' boxes (the
    card's yolo_box output on both devices, so its decisions are held
    exactly)."""
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.vision import ops as vops
    n = YOLO_BATCH
    gt = np.concatenate([rng.uniform(0.02, 0.98, (n, YOLO_GT, 2)),
                         rng.uniform(0.01, 0.5, (n, YOLO_GT, 2))], -1)
    gt = torch.from_numpy(gt.astype(np.float32))
    label = torch.from_numpy(rng.integers(0, YOLO_CLASSES, (n, YOLO_GT))
                             .astype(np.int32))
    img = torch.full((n, 2), YOLO_HW, dtype=torch.int32)
    rec, checks, boxes, scores = {"heads": []}, {}, [], []
    for mask, down in YOLO_HEADS:
        hw = YOLO_HW // down
        x = torch.from_numpy(rng.standard_normal(
            (n, 3 * (5 + YOLO_CLASSES), hw, hw)).astype(np.float32))
        res = {}
        for dev in ("cpu", CARD):
            xd = x.to(dev).requires_grad_()

            def loss_fn(xd=xd, dev=dev):
                return vops.yolo_loss(xd, gt.to(dev), label.to(dev),
                                      YOLO_ANCHORS, mask, YOLO_CLASSES, 0.7,
                                      down)
            loss = loss_fn()
            grad, = torch.autograd.grad(loss.sum(), xd)
            res[dev] = (loss.detach(), grad)
        xc = x.to(CARD).requires_grad_()

        def fwd_bwd():
            loss = vops.yolo_loss(xc, gt.to(CARD), label.to(CARD), YOLO_ANCHORS,
                                  mask, YOLO_CLASSES, 0.7, down)
            return torch.autograd.grad(loss.sum(), xc)
        loss_ms = cuda_ms(fwd_bwd, iters=5)
        box = {dev: ops.yolo_box(x.to(dev), img.to(dev), [
            YOLO_ANCHORS[2 * i + j] for i in mask for j in (0, 1)],
            YOLO_CLASSES, conf_thresh=0.005, downsample_ratio=down,
            clip_bbox=True) for dev in ("cpu", CARD)}
        box_ms = cuda_ms(lambda: ops.yolo_box(
            x.to(CARD), img.to(CARD), [YOLO_ANCHORS[2 * i + j] for i in mask
                                   for j in (0, 1)], YOLO_CLASSES, 0.005,
            down, True), iters=5)
        live = {d: (b[0].abs().sum(-1) > 0) for d, b in box.items()}
        flips = int((live["cpu"] != live[CARD].cpu()).sum())
        both = live["cpu"] & live[CARD].cpu()
        box_err = float((box[CARD][0].detach().cpu()
                         - box["cpu"][0].detach())[both].abs().max())
        head = dict(grid=hw, loss_rel_err=_rel(res[CARD][0],
                                               res["cpu"][0]),
                    grad_rel_err=float((res[CARD][1].cpu() - res["cpu"][1])
                                       .norm() / res["cpu"][1].norm()),
                    loss_fwd_bwd_ms=loss_ms, yolo_box_ms=box_ms,
                    box_err_px=box_err, score_rel_err=_rel(
                        box[CARD][1], box["cpu"][1]),
                    keep_flips=flips, boxes=int(both.numel()))
        rec["heads"].append(head)
        checks[f"stride {down}: yolo_loss and its gradient within 1e-4 of "
               f"the CPU's"] = head["loss_rel_err"] <= 1e-4 \
            and head["grad_rel_err"] <= 1e-4
        checks[f"stride {down}: yolo_box within {DET_BOX_TOL:g} px and "
               f"{DET_TOL:g}, at most 1e-4 of the boxes across conf_thresh"] \
            = box_err <= DET_BOX_TOL and head["score_rel_err"] <= DET_TOL \
            and flips <= 1e-4 * both.numel()
        boxes.append(box[CARD][0])
        scores.append(box[CARD][1])
    bb = torch.cat(boxes, 1)
    sc = torch.cat(scores, 1).permute(0, 2, 1).contiguous()
    kw = dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
              nms_threshold=0.45, background_label=-1)
    (out, num), times = _timed(lambda: ops.multiclass_nms(bb, sc, **kw),
                               iters=2)
    # the CPU redoes the first YOLO_NMS_CPU images (each image's result
    # depends on it alone)
    k = YOLO_NMS_CPU
    want, want_num = ops.multiclass_nms(bb[:k].cpu(), sc[:k].cpu(), **kw)
    rec["multiclass_nms"] = dict(
        candidates=int(bb.shape[1]), classes=YOLO_CLASSES, **times,
        kept=num.tolist(), on_card=out.device.type == CARD)
    checks["multiclass_nms on the card equal to the CPU's on the same "
           "boxes, on the card"] = bool(torch.equal(out[:k].cpu(), want)) \
        and bool(torch.equal(num[:k].cpu(), want_num)) \
        and out.device.type == CARD
    _check("[detect-yolo]", checks, rec)
    return rec


def _rpn_phase(rng) -> dict:
    """Phase 30b: Faster R-CNN's C4 RPN: generate_proposals on the card
    and on the CPU from the same inputs; then, on the card's proposals
    (on both devices), roi_align, distribute_fpn_proposals, roi_pool,
    psroi_pool, matrix_nms and nms."""
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.vision import ops as vops
    a = len(RPN_SIZES) * len(RPN_RATIOS)
    n, h, w = RPN_IMAGES, RPN_H, RPN_W
    anchors = torch.from_numpy(_rpn_anchors())
    var = torch.ones_like(anchors)
    scores = torch.from_numpy(rng.standard_normal((n, a, h, w)).astype(
        np.float32))
    deltas = torch.from_numpy((rng.standard_normal((n, 4 * a, h, w)) * 0.2)
                              .astype(np.float32))
    im = torch.tensor([RPN_IMAGE] * n, dtype=torch.float32)
    kw = dict(pre_nms_top_n=RPN_PRE, post_nms_top_n=RPN_POST,
              nms_thresh=RPN_NMS, min_size=0.0)
    cuda = [t.to(CARD) for t in (scores, deltas, im, anchors, var)]
    (rois, probs, num), times = _timed(
        lambda: ops.generate_proposals(*cuda, **kw), iters=2)
    w_rois, w_probs, w_num = ops.generate_proposals(
        scores, deltas, im, anchors, var, **kw)
    apart = int(((rois.cpu() - w_rois).abs().amax(-1) > DET_BOX_TOL).sum())
    rec = {"generate_proposals": dict(
        anchors=int(h * w * a), **times, proposals=num.tolist(),
        cpu_proposals=w_num.tolist(), rows_apart=apart,
        on_card=rois.device.type == CARD)}
    checks = {"generate_proposals on the card, its counts, scores and "
              f"order the CPU's and its boxes within {DET_BOX_TOL:g} px":
              rois.device.type == CARD and apart == 0
              and bool(torch.equal(num.cpu(), w_num))
              and bool(torch.equal(probs.cpu(), w_probs))}
    # the pooling ops on the card's proposals
    flat = rois.reshape(-1, 4)
    cnt = num.to(torch.int32)
    c4 = torch.from_numpy(rng.standard_normal(
        (n, C4_CHANNELS, h, w)).astype(np.float32)).to(CARD)
    ps = torch.from_numpy(rng.standard_normal(
        (n, PS_CLASSES * 49, h, w)).astype(np.float32)).to(CARD)
    # every ROI_CPU_EVERY-th RoI of each image for the CPU
    pick = torch.arange(0, RPN_POST, ROI_CPU_EVERY)
    sub = torch.cat([flat[i * RPN_POST + pick] for i in range(n)]).cpu()
    sub_rows = torch.cat([i * RPN_POST + pick for i in range(n)])
    sub_num = torch.full((n,), len(pick), dtype=torch.int32)
    full_num = torch.full((n,), RPN_POST, dtype=torch.int32)
    for name, fn, x in (
            ("roi_align", lambda x, b, k: vops.roi_align(
                x, b, k, ROI_OUT, 1 / RPN_STRIDE, -1, True), c4),
            ("roi_pool", lambda x, b, k: ops.roi_pool(
                x, b, k, 7, 1 / RPN_STRIDE), c4),
            ("psroi_pool", lambda x, b, k: ops.psroi_pool(
                x, b, k, 7, 1 / RPN_STRIDE), ps)):
        out, times = _timed(lambda: fn(x, flat, full_num.to(CARD)),
                            iters=2)
        want = fn(x.cpu(), sub, sub_num)
        err = _rel(out[sub_rows.to(CARD)], want)
        rec[name] = dict(rois=int(flat.shape[0]), out_shape=list(out.shape),
                         out_gb=out.numel() * 4 / 2 ** 30, ms=times["ms"],
                         rel_err=err, on_card=out.device.type == CARD)
        checks[f"{name} on the card within {DET_TOL:g} of the CPU's"] = \
            err <= DET_TOL and out.device.type == CARD
        del out
    dist, times = _timed(lambda: ops.distribute_fpn_proposals(
        flat, 2, 5, 4, 224, rois_num=cnt), iters=3)
    want = ops.distribute_fpn_proposals(flat.cpu(), 2, 5, 4, 224,
                                        rois_num=cnt.cpu())
    # RoIs whose level (in float64) lies within 1e-5 of a boundary: the
    # two devices' log2 may put them on either side; every other RoI's
    # level, and so its row, is held exactly
    f64 = flat.cpu().double()
    lvl = 4 + torch.log2(torch.sqrt(((f64[:, 2] - f64[:, 0])
                                     * (f64[:, 3] - f64[:, 1])).clamp_min(
        1e-12)) / 224 + 1e-12)
    near = (lvl - lvl.round()).abs() < 1e-5
    got_lv, want_lv = (_fpn_levels(d, flat.cpu()) for d in (dist, want))
    equal = all(torch.equal(g.cpu(), w) for g, w in zip(dist, want))
    moved = int((got_lv != want_lv).sum())
    rec["distribute_fpn_proposals"] = dict(
        ms=times["ms"], per_level=dist[-2].tolist(), equal=equal,
        near_boundary=int(near.sum()), moved=moved)
    checks["distribute_fpn_proposals: each RoI's level, row and restore "
           "index consistent on both devices, the levels equal to the "
           "CPU's but for a RoI within 1e-5 of a level boundary, which "
           "moves at most one level"] = (
        bool(got_lv.ge(0).all()) and bool(want_lv.ge(0).all())
        and bool((got_lv == want_lv)[~near].all())
        and bool(((got_lv - want_lv).abs() <= 1).all()))
    live = torch.arange(RPN_POST, device=probs.device)[None] < num[:, None]
    sc = torch.where(live, torch.sigmoid(probs),
                     torch.zeros_like(probs))[:, None, :]
    mkw = dict(score_threshold=0.05, post_threshold=0.05, nms_top_k=1000,
               keep_top_k=100)
    (mout, mnum), times = _timed(lambda: ops.matrix_nms(rois, sc, **mkw),
                                 iters=3)
    want = ops.matrix_nms(rois.cpu(), sc.cpu(), **mkw)
    rec["matrix_nms"] = dict(ms=times["ms"], kept=mnum.tolist())
    checks["matrix_nms equal to the CPU's"] = bool(
        torch.equal(mout.cpu(), want[0])) and bool(torch.equal(
            mnum.cpu(), want[1]))
    keep, times = _timed(lambda: vops.nms(rois[0], 0.5, probs[0]),
                         iters=2)
    want = vops.nms(rois[0].cpu(), 0.5, probs[0].cpu())
    rec["nms"] = dict(candidates=int(rois.shape[1]), kept=int(keep.numel()),
                      **times)
    checks["nms (eager, a read-back a candidate) equal to the CPU's, on "
           "the card"] = bool(torch.equal(keep.cpu(), want)) \
        and keep.device.type == CARD
    _check("[detect-rpn]", checks, rec)
    return rec


def _loop_times(name, t) -> str:
    return (f"{name} {t['ms']:.2f} ms by events, {t['wall_ms']:.2f} by "
            f"wall ({t['profiled_wall_ms']:.2f} profiled), "
            f"{t['device_ms']:.2f} on the device (host share "
            f"{t['host_share']:.3f})")


def detection_phase(eager) -> dict:
    """Phase 30: the long-tail op cases of phase 22's sweep (card against
    CPU), YOLOv3's head and Faster R-CNN's C4 RPN at COCO widths on the
    card against the CPU."""
    sweep = eager["sweep"]
    cases = sweep["longtail_cases"]
    _check("[detect] sweep:", {
        f"the {len(cases)} long-tail, sequence and detection cases agree "
        f"with the CPU (phase 22)": not sweep["longtail_failures"],
    }, cases)
    rng = np.random.default_rng(30)
    t = time.perf_counter()
    yolo = _yolo_phase(rng)
    rpn = _rpn_phase(rng)
    _fresh_card()
    rec = dict(sweep_cases=cases, yolo=yolo, rpn=rpn,
               seconds=time.perf_counter() - t)
    log(f"[detect] {len(cases)} op cases on the card, largest difference "
        f"{max(cases.values()):.2e}; YOLOv3 heads: " + "; ".join(
            f"{hd['grid']}^2 loss+grad {hd['loss_fwd_bwd_ms']:.2f} ms, "
            f"yolo_box {hd['yolo_box_ms']:.3f} ms" for hd in yolo["heads"])
        + f"; {_loop_times('multiclass_nms', yolo['multiclass_nms'])}; "
        f"RPN: {_loop_times('generate_proposals', rpn['generate_proposals'])}"
        f", roi_align {rpn['roi_align']['ms']:.2f} ms "
        f"({rpn['roi_align']['out_gb']:.2f} GiB out), roi_pool "
        f"{rpn['roi_pool']['ms']:.2f}, psroi_pool "
        f"{rpn['psroi_pool']['ms']:.2f}, distribute "
        f"{rpn['distribute_fpn_proposals']['ms']:.2f} (levels moved "
        f"{rpn['distribute_fpn_proposals']['moved']}, near a boundary "
        f"{rpn['distribute_fpn_proposals']['near_boundary']}), matrix_nms "
        f"{rpn['matrix_nms']['ms']:.2f}, {_loop_times('nms', rpn['nms'])}; "
        f"{rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 31: incubate whole on the card
# ---------------------------------------------------------------------------
# 31a: FusedMultiTransformer at gpt3_1p3b's widths, uncut (24 layers,
# d_model 2048, 16 heads of 128, FFN 8192, gelu, pre-LN, bf16), 8
# requests of 512-token prompts then 64 decode steps through dense caches
MT_LAYERS, MT_DM, MT_HEADS, MT_FFN = 24, 2048, 16, 8192
MT_BATCH, MT_PROMPT, MT_STEPS = 8, 512, 64
# decode against the full forward, element by element (_norm_err: |got -
# want| / (|want| + rms of want's row + rms of want)): the decode steps
# read k and v back from the bf16 caches where the full forward keeps
# them in f32 (2^-9 relative each), and the two paths' products run at
# other row counts, so an activation near a bf16 rounding boundary may
# round the other way (2^-8 relative) before the next product: 2^-6 is
# 2-4 such roundings. A cache row corrupted in one layer must fail it.
MT_TOL = 2.0 ** -6
# 31b: bench_bert_base's encoder as 12 fused layers trained eagerly
ENC_LAYERS, ENC_BATCH, ENC_SEQ = 12, 16, 512
# 31c: llama2_7b's widths (32 heads of 128) at 2 x 2048 tokens, and the
# packed lengths of the block-diagonal call
LLAMA_Q = (2, 2048, 32, 128)
PACKED_LENS = (512, 1024, 384, 128)


def _mt_serving() -> dict:
    """31a: prefill, 64 decode steps, the full forward of the 576 tokens
    without caches; each decode step (and the prefill) held to the full
    forward within MT_TOL, then a planted cache fault rejected. Timed by
    events: the prefill, each decode step (beside its weight-read
    floor), peak memory."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn.initializer import Normal
    held = _fresh_card()
    gen = torch.Generator("cuda").manual_seed(31)
    w_attr = ParamAttr(initializer=Normal(0.0, 0.02))
    mt = P.incubate.nn.FusedMultiTransformer(
        MT_DM, MT_HEADS, MT_FFN, activation="gelu", normalize_before=True,
        qkv_weight_attrs=[w_attr] * MT_LAYERS, linear_weight_attrs=w_attr,
        ffn1_weight_attrs=w_attr, ffn2_weight_attrs=w_attr,
        dtype="bfloat16", device="cuda", init_generator=gen)
    mt.eval()
    params = list(torch.nn.Module.parameters(mt))
    n_params = sum(p.numel() for p in params)
    w_bytes = sum(p.numel() * p.element_size() for p in params)
    total = MT_PROMPT + MT_STEPS
    x = torch.randn((MT_BATCH, total, MT_DM), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    caches = [Tensor._wrap(torch.zeros(
        (2, MT_BATCH, MT_HEADS, total, MT_DM // MT_HEADS),
        dtype=torch.bfloat16, device="cuda")) for _ in range(MT_LAYERS)]
    cache_bytes = sum(c._data.numel() * 2 for c in caches)
    read_counts, reset_counts = _port_kernel_counts()
    reset_counts()

    def prefill():
        return mt(Tensor._wrap(x[:, :MT_PROMPT]), caches=caches)

    with torch.no_grad():
        prefill()                        # warm-up (cuBLAS plans)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out, caches = prefill()
        e.record()
        torch.cuda.synchronize()
        prefill_ms = s.elapsed_time(e)
        steps, step_ms = [], []
        for i in range(MT_STEPS):
            t = MT_PROMPT + i
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            o, caches = mt(Tensor._wrap(x[:, t:t + 1]), caches=caches,
                           time_step=torch.tensor(t, dtype=torch.int32))
            e.record()
            steps.append(o._data[:, 0])
            step_ms.append((s, e))
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in step_ms]
        full = mt(Tensor._wrap(x))._data
        torch.cuda.synchronize()
        # (launches, plain calls) of B1, B2, B3, B4, B5 and the update
        launches = read_counts()
        prefill_err = _norm_err(out._data, full[:, :MT_PROMPT])
        step_errs = [_norm_err(o, full[:, MT_PROMPT + i])
                     for i, o in enumerate(steps)]
        finite = bool(torch.isfinite(full).all()) and all(
            bool(torch.isfinite(o).all()) for o in steps)
        # the planted fault: layer 5's cache row of request 0 (its k and
        # v at every position) replaced by request 1's, as a wrong row
        # mapping would; the last step run again over it
        t = total - 1
        kc = caches[5]._data
        saved = kc[:, 0].clone()
        kc[:, 0] = kc[:, 1]
        o_bad, _ = mt(Tensor._wrap(x[:, t:t + 1]), caches=caches,
                      time_step=torch.tensor(t, dtype=torch.int32))
        planted_err = _norm_err(o_bad._data[:, 0], full[:, t])
        kc[:, 0] = saved
        o_again, _ = mt(Tensor._wrap(x[:, t:t + 1]), caches=caches,
                        time_step=torch.tensor(t, dtype=torch.int32))
        again_err = _norm_err(o_again._data[:, 0], full[:, t])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # one more step (the last, written again) under torch.profiler:
        # its device time, events and largest kernels against its wall
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            mt(Tensor._wrap(x[:, t:t + 1]), caches=caches,
               time_step=torch.tensor(t, dtype=torch.int32))
            torch.cuda.synchronize()
            prof_wall = 1e3 * (time.perf_counter() - w0)
    prof_dev = _device_ms(prof)
    by_kernel = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3,
                         e.count, e.key) for e in prof.key_averages()),
                       reverse=True)
    profiled = dict(
        wall_ms=prof_wall, device_ms=prof_dev,
        device_events=sum(c for _, c, _ in by_kernel),
        idle_share=(1 - prof_dev / prof_wall) if prof_dev else None,
        top=[dict(kernel=k[:120], ms=ms, count=c)
             for ms, c, k in by_kernel[:6]])
    floor_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    rec = dict(layers=MT_LAYERS, d_model=MT_DM, heads=MT_HEADS, ffn=MT_FFN,
               batch=MT_BATCH, prompt=MT_PROMPT, decode_steps=MT_STEPS,
               params=n_params, weight_gb=w_bytes / 1e9,
               cache_gb=cache_bytes / 1e9, prefill_ms=prefill_ms,
               decode_ms_median=statistics.median(step_ms),
               decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
               weight_read_floor_ms=floor_ms,
               prefill_err=prefill_err, max_step_err=max(step_errs),
               planted_err=planted_err, restored_err=again_err,
               port_kernel_launches=launches, peak_gib=peak,
               gib_held_before=held, profiled_step=profiled)
    _check("[incubate] 31a", {
        "prefill and every decode step finite": finite,
        f"prefill == the full forward (within {MT_TOL:.2e})":
            prefill_err <= MT_TOL,
        f"each of the {MT_STEPS} decode steps == the full forward (within "
        f"{MT_TOL:.2e})": max(step_errs) <= MT_TOL,
        "a corrupted cache row (layer 5, request 0) is rejected":
            planted_err > MT_TOL,
        "the step over the restored row passes again": again_err <= MT_TOL,
        "no kernel of the port on the path (plain einsums, as the "
        "reference)": not any(a or b for a, b in launches),
    }, rec)
    log(f"[incubate] 31a FusedMultiTransformer at gpt3_1p3b's widths "
        f"({n_params / 1e9:.3f} G parameters, {w_bytes / 1e9:.2f} GB bf16; "
        f"caches {cache_bytes / 1e9:.3f} GB): prefill {MT_BATCH} x "
        f"{MT_PROMPT} in {prefill_ms:.2f} ms, decode "
        f"{rec['decode_ms_median']:.3f} ms a step (median of {MT_STEPS}, "
        f"{min(step_ms):.3f}-{max(step_ms):.3f}) against a "
        f"{floor_ms:.3f} ms weight-read floor; decode vs full forward "
        f"{max(step_errs):.2e}, prefill {prefill_err:.2e}, planted fault "
        f"{planted_err:.2e}; peak {peak:.2f} GiB; a profiled step "
        f"{prof_wall:.2f} ms by wall, {prof_dev:.3f} ms on the device in "
        f"{profiled['device_events']} events (idle share "
        f"{profiled['idle_share'] or 0:.3f})")
    del mt, caches, x, full, steps, params, prof
    _fresh_card()
    return rec


def _encoder_training() -> dict:
    """31b: 12 FusedTransformerEncoderLayers (bert_base, post-LN, dropout
    0.1, attention dropout 0 so B1/B2 take the attention) trained 3
    eager steps on Tensors at b16 x s512 in bf16 O1: the FFN weights
    pruned 2:4 by asp, asp.decorate(LookAhead(AdamW, k=2)), an
    identity_loss mean loss; B1/B2/B4 counted a step, B1's calls held to
    its plain version; then ModelAverage's apply() / restore() around an
    eval forward."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import norms
    held = _fresh_card()
    gi = torch.Generator("cuda").manual_seed(311)
    gd = torch.Generator("cuda").manual_seed(312)
    stack = P.nn.Sequential(*[P.incubate.nn.FusedTransformerEncoderLayer(
        **BERT_BASE, dropout_rate=0.1, attn_dropout_rate=0.0,
        normalize_before=False, device="cuda", init_generator=gi,
        generator=gd) for _ in range(ENC_LAYERS)])
    asp.reset_excluded_layers()
    asp.set_excluded_layers([n for n, _ in stack.named_parameters()
                             if "fused_attn" in n])
    masks = asp.prune_model(stack)
    opt = asp.decorate(P.incubate.LookAhead(P.optimizer.AdamW(
        learning_rate=1e-4, parameters=stack.parameters()), alpha=0.5, k=2))
    ma = P.incubate.ModelAverage(0.5, parameters=stack.parameters(),
                                 min_average_window=10,
                                 max_average_window=100)
    x = Tensor._wrap(torch.randn((ENC_BATCH, ENC_SEQ, BERT_BASE["d_model"]),
                                 generator=gi, device="cuda"))
    tgt = Tensor._wrap(torch.randn(x._data.shape, generator=gi,
                                   device="cuda"))
    counters = (fa.flash_fwd, fa.flash_bwd, norms.layer_norm_fwd)
    by_step, losses, step_ms, recorded = [], [], [], []

    def keep(args, r):
        qs, k, v, causal, segs = args[:5]
        return ((qs.clone(), k.clone(), v.clone(), causal, segs),
                tuple(t.clone() for t in r))

    for _ in range(3):
        torch.cuda.synchronize()
        fa.reset_counters()
        norms.layer_norm_fwd.kernel_launches = 0
        norms.layer_norm_fwd.plain_calls = 0
        t0 = time.perf_counter()
        with kernel_calls(fa, "_fwd_cuda", keep=keep) as calls:
            with P.amp.auto_cast(level="O1"):
                out = stack(x)
                loss = P.incubate.identity_loss((out - tgt) ** 2,
                                                reduction="mean")
            loss.backward()
            opt.step()
            opt.clear_grad()
            ma.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.numpy()))
        recorded.extend(calls)
        by_step.append(dict(
            b1=fa.flash_fwd.kernel_launches, b2=fa.flash_bwd.kernel_launches,
            b4=norms.layer_norm_fwd.kernel_launches,
            b1_designs=dict(fa.flash_fwd.design_launches),
            b2_designs=dict(fa.flash_bwd.design_launches),
            plain=[c.plain_calls for c in counters]))
        del out, loss
    b1_err = b1_lse_err = 0.0
    for (qs, k, v, causal, segs), (o, lse) in recorded:
        wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
        b1_err = max(b1_err, _norm_err(o, wo))
        b1_lse_err = max(b1_lse_err, _norm_err(lse, wlse, rows=False))
    n_b1 = len(recorded)
    del recorded
    named = dict(stack.named_parameters())
    still_24 = all(bool(((named[n]._data.reshape(-1, 4) != 0).sum(-1)
                         <= 2).all()) for n in masks)
    before = {n: p._data.detach().clone() for n, p in named.items()}
    stack.eval()
    with torch.no_grad():
        with ma.apply():
            averaged = any(not torch.equal(named[n]._data, before[n])
                           for n in named)
            y_eval = stack(x)._data
        restored = all(torch.equal(named[n]._data, before[n])
                       for n in named)
    L = ENC_LAYERS
    rec = dict(layers=L, batch=ENC_BATCH, seq=ENC_SEQ, losses=losses,
               step_ms=step_ms, launches_by_step=by_step,
               masks=len(masks), b1_calls_held=n_b1, b1_norm_err=b1_err,
               b1_lse_norm_err=b1_lse_err, gib_held_before=held)
    _check("[incubate] 31b", {
        "losses finite": all(np.isfinite(losses)),
        f"B1 {L}, B2 {L} and B4 {2 * L} launches a step, all sm90": all(
            (s["b1"], s["b2"], s["b4"]) == (L, L, 2 * L)
            and s["b1_designs"] == {"sm90": L, "simple": 0}
            and s["b2_designs"] == {"sm90": L, "simple": 0}
            for s in by_step),
        "no plain version ran on CUDA tensors": all(
            s["plain"] == [0, 0, 0] for s in by_step),
        f"every recorded B1 call ({n_b1}) == its plain version (o within "
        f"{FLASH_TOL['bf16']:.2e}, lse within {FLASH_TOL['f32']:.0e})":
            n_b1 == 3 * L and b1_err <= FLASH_TOL["bf16"]
            and b1_lse_err <= FLASH_TOL["f32"],
        f"the {2 * L} pruned FFN weights still 2:4 after the steps":
            len(masks) == 2 * L and still_24,
        "ModelAverage.apply() swapped averages in": averaged,
        "restore() put every weight back bit for bit": restored,
        "the eval forward under the averages finite":
            bool(torch.isfinite(y_eval).all()),
    }, rec)
    log(f"[incubate] 31b {L} FusedTransformerEncoderLayers (bert_base, "
        f"post-LN, dropout 0.1), b{ENC_BATCH} x s{ENC_SEQ}, bf16 O1, asp "
        f"2:4 on the FFN, LookAhead(AdamW, k=2): steps "
        f"{[round(t, 2) for t in step_ms]} ms by wall, losses "
        f"{[round(v, 5) for v in losses]}; (B1, B2, B4) "
        f"{[(s['b1'], s['b2'], s['b4']) for s in by_step]} a step; B1 vs "
        f"plain o {b1_err:.2e}, lse {b1_lse_err:.2e}")
    del stack, opt, ma, x, tgt, y_eval, before, named
    asp.reset_excluded_layers()
    asp._masks.clear()
    _fresh_card()
    return rec


def _llama_width_functionals() -> dict:
    """31c: fused_rms_norm (B5) on [4096, 4096], rotary on q and k, then
    B1 and B2 through loss.backward() of fused_flash_attention (causal),
    memory_efficient_attention with a LowerTriangularMask and with a
    BlockDiagonalCausalMask over PACKED_LENS (segment ids), every call
    held to the plain versions; the packed call timed beside the same
    sequences padded into a batch."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.incubate.nn import attn_bias
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import norms
    _fresh_card()
    g = torch.Generator("cuda").manual_seed(313)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    fa.reset_counters()
    norms.rms_norm_fwd.kernel_launches = norms.rms_norm_fwd.plain_calls = 0
    xs = torch.randn((4096, 4096), generator=g, **bf)
    ws = torch.randn(4096, generator=g, **bf)
    rms = IF.fused_rms_norm(Tensor._wrap(xs), Tensor._wrap(ws))._data
    q, k, v = (torch.randn(LLAMA_Q, generator=g, **bf) for _ in range(3))
    qr, kr = IF.fused_rotary_position_embedding(Tensor._wrap(q),
                                                Tensor._wrap(k))
    cot = torch.randn(LLAMA_Q, generator=g, **bf)
    b, s = LLAMA_Q[:2]
    calls = {
        "fused_flash_attention causal": lambda *t: IF.fused_flash_attention(
            *t, causal=True),
        "memory_efficient_attention LowerTriangularMask":
            lambda *t: P.incubate.nn.memory_efficient_attention(
                *t, attn_bias=attn_bias.LowerTriangularMask()),
        "memory_efficient_attention BlockDiagonalCausalMask "
        f"{list(PACKED_LENS)}":
            lambda *t: P.incubate.nn.memory_efficient_attention(
                *t, attn_bias=attn_bias.BlockDiagonalCausalMask
                .from_seqlens(list(PACKED_LENS))),
    }
    keep = (lambda args, r: (tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in args),
                             tuple(t.clone() for t in r)))
    with kernel_calls(fa, "_fwd_cuda", keep=keep) as fwd, \
            kernel_calls(fa, "_bwd_cuda", keep=keep) as bwd:
        for fn in calls.values():
            leaves = [Tensor._wrap(t._data.detach().clone().requires_grad_())
                      for t in (qr, kr)] + [
                Tensor._wrap(v.clone().requires_grad_())]
            out = fn(*leaves)
            (out * Tensor._wrap(cot)).sum().backward()
    torch.cuda.synchronize()
    launches = dict(
        b1=fa.flash_fwd.kernel_launches, b2=fa.flash_bwd.kernel_launches,
        b5=norms.rms_norm_fwd.kernel_launches,
        b1_designs=dict(fa.flash_fwd.design_launches),
        b2_designs=dict(fa.flash_bwd.design_launches),
        plain=[fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls,
               norms.rms_norm_fwd.plain_calls])
    rms_err = _lim_err(rms, norms.rms_norm_fwd(xs, ws, 1e-6, path="torch"),
                       NORM_TOL["bf16"])
    rope_cpu = IF.fused_rotary_position_embedding(q.cpu(), k.cpu())
    rope_err = max(_lim_err(a._data.cpu(), w, NORM_TOL["bf16"])
                   for a, w in zip((qr, kr), rope_cpu))
    flash = {}
    for name, ((fargs, (o, lse)), (bargs, (dq, dk, dv))) in zip(
            calls, zip(fwd, bwd)):
        qs, kk, vv, causal, segs = fargs[:5]
        wo, wlse = fa.flash_fwd(qs, kk, vv, causal, segs, path="torch")
        _, _, _, bo, blse, do, bcausal, bsegs, scale = bargs[:9]
        wdq, wdk, wdv = fa.flash_bwd(qs, kk, vv, bo, blse, do, scale,
                                     bcausal, bsegs, path="torch")
        abs_errs, errs, planted = _check_flash(
            name, "bf16", (o, lse, dq, dk, dv), (wo, wlse, wdq, wdk, wdv))
        flash[name] = dict(max_abs_err=abs_errs, norm_err=errs,
                           planted=planted, segments=segs is not None)
    del fwd, bwd
    # the packed call's B1 beside the same sequences padded into a batch
    # (one padded row a sequence, at the longest length), forward only
    bias = attn_bias.BlockDiagonalCausalMask.from_seqlens(list(PACKED_LENS))
    longest = max(PACKED_LENS)
    pad = [torch.zeros((b * len(PACKED_LENS), longest) + LLAMA_Q[2:], **bf)
           for _ in range(3)]
    for src, dst in zip((qr._data, kr._data, v), pad):
        for r in range(b):
            at = 0
            for i, n in enumerate(PACKED_LENS):
                dst[r * len(PACKED_LENS) + i, :n] = src[r, at:at + n]
                at += n
    with torch.no_grad():
        packed_ms = cuda_ms(lambda: P.incubate.nn.memory_efficient_attention(
            qr, kr, Tensor._wrap(v), attn_bias=bias), iters=10)
        padded_ms = cuda_ms(lambda: IF.fused_flash_attention(
            *map(Tensor._wrap, pad), causal=True), iters=10)
    rec = dict(launches=launches, rms_lim_err=rms_err, rope_lim_err=rope_err,
               flash=flash, packed_fwd_ms=packed_ms, padded_fwd_ms=padded_ms)
    _check("[incubate] 31c", {
        "B5 once, B1 and B2 three times each, all sm90": (
            launches["b1"], launches["b2"], launches["b5"]) == (3, 3, 1)
            and launches["b1_designs"] == {"sm90": 3, "simple": 0}
            and launches["b2_designs"] == {"sm90": 3, "simple": 0},
        "no plain version ran on CUDA tensors": launches["plain"] == [0] * 3,
        "B5 == its plain version (NORM_TOL bf16)": rms_err <= 1.0,
        "rotary on the card == on the CPU (NORM_TOL bf16)": rope_err <= 1.0,
        "the block-diagonal call reached B1/B2 with segment ids":
            len(flash) == 3 and list(flash.values())[2]["segments"],
    }, rec)
    log(f"[incubate] 31c llama2_7b widths {list(LLAMA_Q)}: B5 vs plain "
        f"{rms_err:.3f} of its limit, rotary vs CPU {rope_err:.3f}; "
        + "; ".join(f"{n}: o {r['norm_err']['o']:.2e} dq "
                    f"{r['norm_err']['dq']:.2e}" for n, r in flash.items())
        + f"; packed B1 forward {packed_ms:.3f} ms against "
        f"{padded_ms:.3f} ms padded")
    del pad, q, k, v, qr, kr, xs, rms
    _fresh_card()
    return rec


def incubate_phase(eager) -> dict:
    """Phase 31: incubate whole (31a serving, 31b training, 31c the
    registered functionals at llama2_7b's widths), and the incubate op
    cases of phase 22's sweep."""
    sweep = eager["sweep"]
    cases = sweep["incubate_cases"]
    _check("[incubate] sweep:", {
        f"the {len(cases)} incubate op cases agree with the CPU (phase 22)":
            bool(cases) and not sweep["incubate_failures"],
    }, cases)
    t0 = time.perf_counter()
    serving = _mt_serving()
    training = _encoder_training()
    functionals = _llama_width_functionals()
    secs = time.perf_counter() - t0
    log(f"[incubate] phase 31 took {secs:.1f} s")
    return dict(sweep_cases=cases, serving=serving, training=training,
                functionals=functionals, seconds=secs)


# ---------------------------------------------------------------------------
# phase 32: the op surfaces (fft, signal, audio, geometric, sparse,
# distribution, quantization) on the card
# ---------------------------------------------------------------------------
# 32a: PANNs CNN14's feature config as PaddleSpeech's ESC-50 recipe uses
# it: 32 kHz, n_fft 1024, hop 320, a Hann window of 1024, 64 mels from 50
# to 14,000 Hz; 64 clips of 5 s; MFCC with 40 coefficients
AUDIO = dict(sr=32000, n_fft=1024, hop_length=320, win_length=1024,
             window="hann", n_mels=64, f_min=50.0, f_max=14000.0)
AUDIO_CLIPS, AUDIO_SAMPLES, AUDIO_MFCC = 64, 160000, 40
# log-mel in dB: cuFFT and pocketfft give f32 powers a few ulps apart,
# 1e-5 relative at worst, 4e-5 dB; the bound allows 25x that
AUDIO_DB_TOL = 1e-3
# 32b: ogbn-arxiv's size (169,343 nodes, 1,166,243 edges, 128 features,
# 40 classes), power-law in-degrees; GraphSAGE-mean 128 -> 256 -> 40;
# GraphSAGE's fan-outs [25, 10] from 1,024 seeds
GRAPH_NODES, GRAPH_EDGES, GRAPH_FEAT = 169_343, 1_166_243, 128
GRAPH_HIDDEN, GRAPH_CLASSES = 256, 40
GRAPH_SEEDS, GRAPH_FANOUTS = 1024, (25, 10)
# index_add / scatter sums in other orders on the card (atomics) and the
# CPU, through two f32 layers
GRAPH_TOL = 1e-4
# 32c: SECOND's third middle-encoder stage on KITTI's voxel grid: [1, 11,
# 400, 352] sites, 64 channels, 40,000 active; the card-vs-CPU check on a
# [1, 11, 100, 88] cut at the same density
VOXEL_GRID, VOXEL_C, VOXEL_ACTIVE = (1, 11, 400, 352), 64, 40_000
VOXEL_CUT = (1, 11, 100, 88)
# sparse attention: b 4, h 12, s 1024, d 64 under a 128-wide band
SPATTN = (4, 12, 1024, 64)
SPATTN_BAND = 128
# f32 with TF32 off for the comparisons (27-tap convolutions and the
# products summed in other orders): 1e-4 of the largest value
SPARSE_TOL = 1e-4
# 32d: a PPO policy's heads: Normal over MuJoCo Humanoid's 17 action dims
# at batch 4096, Categorical over LLaMA's 32,000-token vocabulary at
# batch 256; moments of 10^6 draws within 6 standard errors
PPO_BATCH, PPO_ACT = 4096, 17
CAT_BATCH, CAT_VOCAB = 256, 32_000
DIST_DRAWS = 1_000_000
# 32e: MobileNetV2 QAT at phase 29's recipe; the card-vs-CPU step at
# batch 4 x 224^2 in f32
QAT_EAGER_STEPS, QAT_GRAPH_CALLS = 2, 4
QAT_SUB_BATCH, QAT_SUB_HW = 4, 224
# the whole step's loss, card against CPU: a flip in one layer moves
# every later one (first runs on an H100: 1.1e-3 at 224^2; 4.1e-3 and
# 1.7e-2 at 64^2, where batch norm normalises 2 x 2 maps)
QAT_LOSS_TOL = 2e-2


def _card_ms(dev, fn, iters=5):
    """Device ms of fn by CUDA events on the card, None elsewhere."""
    return cuda_ms(fn, iters=iters, warmup=1) if dev == "cuda" else None


def _sync():
    import torch
    if CARD == "cuda":
        torch.cuda.synchronize()


def _peak_gib(held):
    import torch
    if CARD != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30 - held


def _rel_err(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


def _audio_clips(n, samples, seed=32):
    """5 s clips at 32 kHz: a few partials with a decaying envelope over
    noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples, dtype=np.float64) / AUDIO["sr"]
    f0 = rng.uniform(80, 4000, (n, 1, 1))
    k = np.arange(1, 6)[None, :, None]
    tone = (np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6, (n, 5, 1)))
            / k).sum(1)
    env = np.exp(-t * rng.uniform(0.2, 2.0, (n, 1)))
    x = 0.3 * tone * env + 0.05 * rng.standard_normal((n, samples))
    return x.astype(np.float32)


def _audio_run(dev, x_np):
    """32a on `dev`: the log-mel and MFCC features, stft -> istft with
    length, the stft's gradient of a power sum; times on the card."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import audio, signal
    x = P.to_tensor(x_np, place=dev)
    logmel = audio.LogMelSpectrogram(**AUDIO, device=dev)
    mfcc = audio.MFCC(n_mfcc=AUDIO_MFCC, **AUDIO, device=dev)
    lm, mf = logmel(x), mfcc(x)
    w = audio.functional.get_window("hann", AUDIO["n_fft"], device=dev)
    st = dict(n_fft=AUDIO["n_fft"], hop_length=AUDIO["hop_length"],
              window=w)
    spec = signal.stft(x, **st)
    back = signal.istft(spec, length=AUDIO_SAMPLES, **st)
    g = P.to_tensor(x_np[:8], place=dev, stop_gradient=False)
    (signal.stft(g, **st).abs() ** 2).sum().backward()
    rec = dict(logmel=lm._data, mfcc=mf._data, roundtrip=back._data,
               grad=g.grad._data, stop_gradient=lm.stop_gradient)
    if dev == CARD:
        rec["ms"] = dict(
            logmel=_card_ms(dev, lambda: logmel(x)),
            mfcc=_card_ms(dev, lambda: mfcc(x)),
            stft=_card_ms(dev, lambda: signal.stft(x, **st)),
            istft=_card_ms(dev, lambda: signal.istft(
                spec, length=AUDIO_SAMPLES, **st)))
    return rec


def _audio_front_end(n=None, samples=None) -> dict:
    """Phase 32a."""
    import torch
    x = _audio_clips(n or AUDIO_CLIPS, samples or AUDIO_SAMPLES)
    card, cpu = (_audio_run(d, x) for d in (CARD, "cpu"))
    frames = 1 + (x.shape[1] // AUDIO["hop_length"])
    rec = dict(
        shape=list(card["logmel"].shape), frames=frames,
        logmel_max_abs_db=float((card["logmel"].cpu()
                                 - cpu["logmel"]).abs().max()),
        mfcc_rel_err=_rel_err(card["mfcc"], cpu["mfcc"]),
        roundtrip_max_abs_err=float((card["roundtrip"].cpu()
                                     - torch.from_numpy(x)).abs().max()),
        grad_rel_err=_rel_err(card["grad"], cpu["grad"]),
        features_record_no_grad=card["stop_gradient"],
        ms=card.get("ms"))
    return rec


def _power_law_graph(seed=33):
    """ogbn-arxiv-sized directed graph: uniform sources, destinations
    drawn with probability ~ rank^-0.8 over a shuffled node order (a
    power-law in-degree); edges sorted by destination, with the CSC
    colptr."""
    rng = np.random.default_rng(seed)
    n, e = GRAPH_NODES, GRAPH_EDGES
    p = np.arange(1, n + 1, dtype=np.float64) ** -0.8
    p /= p.sum()
    dst = rng.permutation(n)[rng.choice(n, size=e, p=p)]
    order = np.argsort(dst, kind="stable")
    dst = dst[order].astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)[order]
    colptr = np.concatenate([[0], np.cumsum(np.bincount(
        dst, minlength=n))]).astype(np.int32)
    return src, dst, colptr


def _sage_weights(seed=34):
    rng = np.random.default_rng(seed)
    dims = [(GRAPH_FEAT, GRAPH_HIDDEN)] * 2 + [(GRAPH_HIDDEN,
                                                GRAPH_CLASSES)] * 2
    return [(rng.standard_normal(d) / np.sqrt(d[0])).astype(np.float32)
            for d in dims]


def _graph_run(dev, graph, x_np, wts, seeds, relu_mask=None):
    """32b on `dev`: GraphSAGE-mean forward and backward through
    send_u_recv, sum and max once, send_ue_recv and send_uv, the two-hop
    sample and reindex_graph. With `relu_mask` (a bool array of the
    hidden layer's shape) the hidden ReLU keeps the units the mask holds
    instead of the positive ones; `positive` is the pre-activation's
    sign as this device computed it."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import geometric as G
    src_np, dst_np, colptr_np = graph
    T = lambda a, **kw: P.to_tensor(a, place=dev, **kw)  # noqa: E731
    src, dst, x = T(src_np), T(dst_np), T(x_np)
    ws = [T(w, stop_gradient=False) for w in wts]
    n = GRAPH_NODES
    keep = (None if relu_mask is None
            else T(relu_mask.astype(np.float32)))
    positive = []

    def sage():
        h = x
        for i in range(2):
            agg = G.send_u_recv(h, src, dst, "mean", out_size=n)
            h = P.matmul(h, ws[2 * i]) + P.matmul(agg, ws[2 * i + 1])
            if i == 0:
                if not positive:
                    positive.append(h._data.detach() > 0)
                h = (P.nn.functional.relu(h) if keep is None
                     else h * keep)
        return h

    logits = sage()
    labels = T(np.arange(n, dtype=np.int32) % GRAPH_CLASSES)
    loss = P.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    ew = T(np.random.default_rng(35).uniform(0.5, 1.5, GRAPH_EDGES)
           .astype(np.float32))
    rec = dict(logits=logits._data.detach(), loss=float(loss),
               grads=[w.grad._data for w in ws],
               positive=positive[0].cpu().numpy(),
               sum=G.send_u_recv(x, src, dst, "sum")._data,
               max=G.send_u_recv(x, src, dst, "max")._data,
               ue=G.send_ue_recv(x, ew, src, dst, "mul", "sum")._data,
               uv=G.send_uv(x, x, src, dst, "mul")._data)
    P.seed(36)
    row, cp = T(src_np), T(colptr_np)
    nodes = T(seeds)
    hops = []
    for k in GRAPH_FANOUTS:
        nb, cnt = G.sample_neighbors(row, cp, nodes, sample_size=k)
        r_src, r_dst, out_nodes = G.reindex_graph(nodes, nb, cnt)
        hops.append([t._data.cpu().numpy() for t in
                     (nodes, nb, cnt, r_src, r_dst, out_nodes)])
        nodes = out_nodes
    rec["hops"] = hops
    if dev == CARD:
        def step():
            for w in ws:
                w.clear_grad()
            P.nn.functional.cross_entropy(sage(), labels).backward()
        rec["ms"] = dict(
            sage_step=_card_ms(dev, step, iters=3),
            send_u_recv_sum=_card_ms(dev, lambda: G.send_u_recv(
                x, src, dst, "sum")),
            send_u_recv_mean=_card_ms(dev, lambda: G.send_u_recv(
                x, src, dst, "mean")),
            send_u_recv_max=_card_ms(dev, lambda: G.send_u_recv(
                x, src, dst, "max")))
    return rec


def _samples_hold_the_rule(hops, colptr, row, fanouts):
    """Each node's picks lie among its neighbours, with no repeats, and
    number min(degree, fan-out)."""
    for (nodes, nb, cnt, *_), k in zip(hops, fanouts):
        deg = np.diff(colptr)[nodes]
        if not np.array_equal(cnt, np.minimum(deg, k)):
            return False
        off = np.concatenate([[0], np.cumsum(cnt)])
        for i, node in enumerate(nodes.tolist()):
            picks = nb[off[i]:off[i + 1]]
            nbrs = row[colptr[node]:colptr[node + 1]]
            # multi-edges may repeat a neighbour id: compare as multisets
            vals, counts = np.unique(picks, return_counts=True)
            have = dict(zip(*np.unique(nbrs, return_counts=True)))
            if any(have.get(v, 0) < c for v, c in zip(vals, counts)):
                return False
    return True


def _graph_phase() -> dict:
    """Phase 32b."""
    graph = _power_law_graph()
    src, dst, colptr = graph
    x = np.random.default_rng(37).standard_normal(
        (GRAPH_NODES, GRAPH_FEAT)).astype(np.float32)
    wts = _sage_weights()
    seeds = np.random.default_rng(38).choice(
        GRAPH_NODES, GRAPH_SEEDS, replace=False).astype(np.int32)
    card = _graph_run(CARD, graph, x, wts, seeds)
    # The CPU's reference takes the card's hidden ReLU mask. A hidden
    # pre-activation within rounding of 0 can land on either side of it on
    # the two devices (the card's index_add sums in another order), and
    # one such unit moves a layer-0 gradient column by ~2e-4 of its
    # largest while moving the logits by ~1e-7: the gradients are held to
    # the CPU's on the same branch, and the plain ReLU's CPU run is kept
    # to show what the flips alone cost.
    cpu_own = _graph_run("cpu", graph, x, wts, seeds)
    cpu = _graph_run("cpu", graph, x, wts, seeds,
                     relu_mask=card["positive"])
    hops_equal = all(np.array_equal(a, b) for ha, hb in
                     zip(card["hops"], cpu["hops"]) for a, b in zip(ha, hb))
    deg = np.bincount(dst, minlength=GRAPH_NODES)
    return dict(
        nodes=GRAPH_NODES, edges=GRAPH_EDGES, max_in_degree=int(deg.max()),
        median_in_degree=float(np.median(deg)),
        isolated=int((deg == 0).sum()),
        loss=card["loss"], loss_cpu=cpu["loss"],
        logits_rel_err=_rel_err(card["logits"], cpu["logits"]),
        grad_rel_err=max(_rel_err(a, b) for a, b in
                         zip(card["grads"], cpu["grads"])),
        relu_flips=int((card["positive"] != cpu_own["positive"]).sum()),
        logits_rel_err_own_relu=_rel_err(card["logits"], cpu_own["logits"]),
        grad_rel_err_own_relu=max(_rel_err(a, b) for a, b in
                                  zip(card["grads"], cpu_own["grads"])),
        sum_rel_err=_rel_err(card["sum"], cpu["sum"]),
        max_equal=bool(np.array_equal(card["max"].cpu().numpy(),
                                      cpu["max"].numpy())),
        ue_rel_err=_rel_err(card["ue"], cpu["ue"]),
        uv_equal=bool(np.array_equal(card["uv"].cpu().numpy(),
                                     cpu["uv"].numpy())),
        samples_equal=hops_equal,
        samples_hold_rule=_samples_hold_the_rule(card["hops"], colptr, src,
                                                 GRAPH_FANOUTS),
        sampled=[int(h[2].sum()) for h in card["hops"]],
        subgraph_nodes=[int(len(h[5])) for h in card["hops"]],
        ms=card.get("ms"))


def _voxels(grid, active, seed):
    """A [*grid, C] NDHWC input with `active` distinct active sites."""
    rng = np.random.default_rng(seed)
    n_sites = int(np.prod(grid))
    sites = rng.choice(n_sites, active, replace=False)
    feats = rng.standard_normal((active, VOXEL_C)).astype(np.float32)
    idx = np.stack(np.unravel_index(np.sort(sites), grid))
    return idx.astype(np.int64), feats


def _second_stage(dev, idx, feats, grid, seed=39):
    """Two SubmConv3D(64, 64, 3) + ReLU, Conv3D(64, 64, 3, stride 2,
    padding 1), MaxPool3D(2): forward, and backward of the squared
    output."""
    import torch

    from paddle_tpu_torch import sparse
    # the weights drawn on the CPU from the seed, so every device gets
    # the same ones
    mk = dict(device="cpu",
              init_generator=torch.Generator("cpu").manual_seed(seed))
    layers = [sparse.nn.SubmConv3D(VOXEL_C, VOXEL_C, 3, **mk),
              sparse.nn.SubmConv3D(VOXEL_C, VOXEL_C, 3, **mk),
              sparse.nn.Conv3D(VOXEL_C, VOXEL_C, 3, stride=2, padding=1,
                               **mk)]
    for lay in layers:
        torch.nn.Module.to(lay, dev)
    x = sparse.sparse_coo_tensor(idx, feats, shape=grid + (VOXEL_C,),
                                 place=dev)
    relu, pool = sparse.nn.ReLU(), sparse.nn.MaxPool3D(2)
    h1 = relu(layers[0](x))
    h2 = relu(layers[1](h1))
    h3 = layers[2](h2)
    out = pool(h3)
    (out.to_dense() ** 2).sum().backward()
    return dict(x=x, h1=h1, h2=h2, h3=h3, out=out, layers=layers,
                grads=[p.grad._data for lay in layers
                       for p in (lay.weight, lay.bias)])


def _reach(mask, k=3, stride=2, pad=1):
    """The regular conv's site rule, independently: any active site in
    the receptive field (a max-pool of the mask)."""
    import torch.nn.functional as TF
    return TF.max_pool3d(mask[:, None].float(), k, stride, pad)[:, 0] > 0


def _band_csr(b, h, s, band):
    """A causal band of `band` keys a row as Paddle's flat batched CSR."""
    cols, crow = [], [0]
    for r in range(s):
        cols.extend(range(max(0, r - band + 1), r + 1))
        crow.append(len(cols))
    nb = b * h
    return (np.tile(np.asarray(crow, np.int64), nb),
            np.tile(np.asarray(cols, np.int64), nb), len(cols))


def _sparse_phase() -> dict:
    """Phase 32c: SECOND's stage at full size on the card (the site rules
    and the backward checked, timed with cuDNN's default TF32 and
    without), the same stage on a cut grid against the CPU (TF32 off),
    the graph's row-normalised adjacency through sparse.matmul against
    send_u_recv's mean, and the band-masked attention against SDPA with
    the band as a dense mask."""
    import torch
    import torch.nn.functional as TF

    import paddle_tpu_torch as P
    from paddle_tpu_torch import geometric, sparse
    held = _fresh_card()
    rec = dict(dense_activation_mb=float(np.prod(VOXEL_GRID) * VOXEL_C * 4
                                         / 1e6),
               tf32=dict(cudnn_default=bool(torch.backends.cudnn.allow_tf32),
                         matmul_default=bool(
                             torch.backends.cuda.matmul.allow_tf32)))
    idx, feats = _voxels(VOXEL_GRID, VOXEL_ACTIVE, 40)
    run = _second_stage(CARD, idx, feats, VOXEL_GRID)

    def sites(t):
        """The active sites of a sparse tensor's dense form."""
        return torch.nonzero((t._todense() != 0).any(-1)).t().to(
            torch.int32)
    rec.update(
        active_in=run["x"].nnz(), active_subm=[run["h1"].nnz(),
                                               run["h2"].nnz()],
        active_conv=run["h3"].nnz(), active_pool=run["out"].nnz(),
        subm_keeps_sites=bool(torch.equal(run["h1"].indices()._data,
                                          run["x"].indices()._data)
                              and torch.equal(run["h2"].indices()._data,
                                              sites(run["h1"]))),
        conv_sites_by_rule=bool(torch.equal(
            run["h3"].indices()._data, torch.nonzero(_reach(
                (run["h2"]._todense() != 0).any(-1))).t().to(torch.int32))),
        grads_finite_nonzero=all(bool(torch.isfinite(g).all())
                                 and float(g.abs().sum()) > 0
                                 for g in run["grads"]),
        peak_gib=_peak_gib(held))
    layers = run["layers"]
    del run

    def stage():
        x = sparse.sparse_coo_tensor(idx, feats, shape=VOXEL_GRID
                                     + (VOXEL_C,), place=CARD)
        h = sparse.nn.ReLU()(layers[0](x))
        h = sparse.nn.ReLU()(layers[1](h))
        out = sparse.nn.MaxPool3D(2)(layers[2](h))
        (out.to_dense() ** 2).sum().backward()

    rec["stage_ms"] = _card_ms(CARD, stage, iters=3)
    with _f32_exact():
        rec["stage_ms_no_tf32"] = _card_ms(CARD, stage, iters=3)
        cut_active = VOXEL_ACTIVE * int(np.prod(VOXEL_CUT)) // int(
            np.prod(VOXEL_GRID))
        cidx, cfeats = _voxels(VOXEL_CUT, cut_active, 41)
        card, cpu = (_second_stage(d, cidx, cfeats, VOXEL_CUT)
                     for d in (CARD, "cpu"))
        rec["cut"] = dict(
            active=cut_active,
            indices_equal=all(torch.equal(card[k].indices()._data.cpu(),
                                          cpu[k].indices()._data)
                              for k in ("h1", "h2", "h3", "out")),
            out_rel_err=_rel_err(card["out"].values()._data,
                                 cpu["out"].values()._data),
            grad_rel_err=max(_rel_err(a, b) for a, b in
                             zip(card["grads"], cpu["grads"])))
        del card, cpu
        # the row-normalised adjacency of 32b's graph, A[dst, src] =
        # 1 / in-degree(dst), against send_u_recv's mean
        src, dst, _ = _power_law_graph()
        deg = np.bincount(dst, minlength=GRAPH_NODES)
        vals = (1.0 / np.maximum(deg[dst], 1)).astype(np.float32)
        adj = sparse.sparse_coo_tensor(np.stack([dst, src]).astype(np.int64),
                                       vals, shape=[GRAPH_NODES] * 2,
                                       place=CARD)
        xg = P.to_tensor(np.random.default_rng(37).standard_normal(
            (GRAPH_NODES, GRAPH_FEAT)).astype(np.float32), place=CARD)
        got = sparse.matmul(adj, xg)._data
        want = geometric.send_u_recv(xg, P.to_tensor(src, place=CARD),
                                     P.to_tensor(dst, place=CARD),
                                     "mean")._data
        tsrc, tdst = (P.to_tensor(a, place=CARD) for a in (src, dst))
        rec["adjacency"] = dict(
            nnz=adj.nnz(), rel_err_vs_mean=_rel_err(got, want),
            ms=_card_ms(CARD, lambda: sparse.matmul(adj, xg)),
            mean_ms=_card_ms(CARD, lambda: geometric.send_u_recv(
                xg, tsrc, tdst, "mean")))
        del adj, xg, got, want
        b, h, s, d = SPATTN
        crows, cols, nnz = _band_csr(b, h, s, SPATTN_BAND)
        m = sparse.sparse_csr_tensor(crows, cols, np.ones(
            b * h * nnz, np.float32), [b * h, s, s], place=CARD)
        gen = torch.Generator(CARD).manual_seed(42)
        q, k, v = (torch.randn(SPATTN, generator=gen, device=CARD)
                   for _ in range(3))
        got = sparse.nn.functional.attention(q, k, v, m)
        r = torch.arange(s, device=CARD)
        band = (r[None, :] <= r[:, None]) & (r[None, :]
                                             > r[:, None] - SPATTN_BAND)
        want = TF.scaled_dot_product_attention(q, k, v, attn_mask=band)
        cpu_got = sparse.nn.functional.attention(
            q[:1].cpu(), k[:1].cpu(), v[:1].cpu(),
            sparse.sparse_csr_tensor(crows[:h * (s + 1)], cols[:h * nnz],
                                     np.ones(h * nnz, np.float32),
                                     [h, s, s], place="cpu"))
        rec["attention"] = dict(
            shape=list(SPATTN), band=SPATTN_BAND, nnz_per_head=nnz,
            rel_err_vs_sdpa=_rel_err(got, want),
            rel_err_vs_cpu=_rel_err(got[:1], cpu_got),
            ms=_card_ms(CARD, lambda: sparse.nn.functional.attention(
                q, k, v, m)),
            sdpa_ms=_card_ms(CARD, lambda: TF.scaled_dot_product_attention(
                q, k, v, attn_mask=band)))
    _fresh_card()
    return rec


def _moments_within(x, mean, var, se=6.0):
    """x [N, ...] (a torch tensor on the card): each mean within `se`
    standard errors of `mean`, each variance within `se` standard errors
    of `var` (from the fourth central moment of the draws)."""
    import torch
    x = x.double()
    mean = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
    var = torch.as_tensor(var, dtype=torch.float64, device=x.device)
    n = x.shape[0]
    m, v = x.mean(0), x.var(0, unbiased=False)
    m4 = ((x - mean) ** 4).mean(0)
    ok_m = (m - mean).abs() <= se * (var / n).sqrt() + 1e-12
    ok_v = (v - var).abs() <= se * ((m4 - var ** 2).clamp(min=1e-24)
                                    / n).sqrt() + 1e-12
    return bool(ok_m.all() and ok_v.all()), [
        float(t) for t in (m.flatten()[0], v.flatten()[0],
                           mean.flatten()[0], var.flatten()[0])]


def _ppo_run(dev, arrays):
    """32d's policy heads on `dev`: values, gradients, rsample's."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import distribution as D
    T = lambda a, **kw: P.to_tensor(a, place=dev, **kw)  # noqa: E731
    mu = T(arrays["mu"], stop_gradient=False)
    log_std = T(arrays["log_std"], stop_gradient=False)
    old = D.Normal(T(arrays["mu_old"]), T(np.exp(arrays["log_std_old"])))
    pi = D.Normal(mu, P.exp(log_std))
    act = T(arrays["act"])
    lp, ent, kl = pi.log_prob(act), pi.entropy(), D.kl_divergence(old, pi)
    ratio = P.exp(lp.sum(-1) - old.log_prob(act).sum(-1))
    adv = T(arrays["adv"])
    loss = -(ratio * adv).mean() - 0.01 * ent.mean() + kl.mean()
    loss.backward()
    # rsample's reparameterised gradient: d sum(s) / d mu = 1 and
    # d sum(s) / d log_std = s - mu (the draws are the device's own)
    mu2 = T(arrays["mu"], stop_gradient=False)
    ls2 = T(arrays["log_std"], stop_gradient=False)
    P.seed(43)
    s = D.Normal(mu2, P.exp(ls2)).rsample((2,))
    s.sum().backward()
    dev_s = (s._data - mu2._data).detach()
    rsample_err = max(
        float((mu2.grad._data - 2.0).abs().max()),
        float((ls2.grad._data - dev_s.sum(0)).abs().max()
              / dev_s.abs().max()))
    logits = T(arrays["logits"], stop_gradient=False)
    cat, cat_old = D.Categorical(logits), D.Categorical(T(arrays[
        "logits_old"]))
    tok = T(arrays["tokens"])
    cl = cat.log_prob(tok).mean() - 0.01 * cat.entropy().mean() \
        + D.kl_divergence(cat_old, cat).mean()
    cl.backward()
    rec = dict(lp=lp._data.detach(), ent=ent._data.detach(),
               kl=kl._data.detach(), loss=float(loss),
               grads=[mu.grad._data, log_std.grad._data, logits.grad._data],
               cat=float(cl), rsample_shape=s.shape,
               rsample_grad_err=rsample_err)
    if dev == CARD:
        P.seed(44)
        draws = cat.sample((4,))._data
        rec["cat_sample_ok"] = bool((draws >= 0).all() and (
            draws < CAT_VOCAB).all()) and list(draws.shape) == [
            4, CAT_BATCH]
        rec["ms"] = dict(
            normal_rsample_logprob=_card_ms(dev, lambda: pi.log_prob(
                pi.rsample())),
            categorical_sample=_card_ms(dev, lambda: cat.sample()),
            categorical_entropy=_card_ms(dev, lambda: cat.entropy()))
    return rec


def _distribution_phase() -> dict:
    """Phase 32d: the PPO heads on the card against the CPU (values and
    gradients), then the moments of 10^6 draws on the card."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import distribution as D
    rng = np.random.default_rng(45)
    arrays = dict(
        mu=np.tanh(rng.standard_normal((PPO_BATCH, PPO_ACT))).astype(
            np.float32),
        log_std=np.full((PPO_BATCH, PPO_ACT), -0.5, np.float32),
        mu_old=np.tanh(rng.standard_normal((PPO_BATCH, PPO_ACT))).astype(
            np.float32),
        log_std_old=np.full((PPO_BATCH, PPO_ACT), -0.4, np.float32),
        act=None,
        adv=rng.standard_normal(PPO_BATCH).astype(np.float32),
        logits=rng.standard_normal((CAT_BATCH, CAT_VOCAB)).astype(
            np.float32),
        logits_old=rng.standard_normal((CAT_BATCH, CAT_VOCAB)).astype(
            np.float32),
        tokens=rng.integers(0, CAT_VOCAB, CAT_BATCH).astype(np.int32))
    # actions the old policy took
    arrays["act"] = (arrays["mu_old"] + np.exp(arrays["log_std_old"])
                     * rng.standard_normal((PPO_BATCH, PPO_ACT))).astype(
        np.float32)
    card, cpu = (_ppo_run(d, arrays) for d in (CARD, "cpu"))
    rec = dict(
        values_rel_err=max(_rel_err(card[k], cpu[k])
                           for k in ("lp", "ent", "kl")),
        loss=card["loss"], loss_cpu=cpu["loss"],
        cat_loss=card["cat"], cat_loss_cpu=cpu["cat"],
        grad_rel_err=max(_rel_err(a, b) for a, b in
                         zip(card["grads"], cpu["grads"])),
        cat_sample_ok=card["cat_sample_ok"], ms=card["ms"],
        rsample_grad_err=max(card["rsample_grad_err"],
                             cpu["rsample_grad_err"]))
    n = DIST_DRAWS
    P.seed(46)
    c = lambda a: P.to_tensor(np.asarray(a, np.float32),  # noqa: E731
                              place=CARD)
    a3 = np.array([1.0, 2.0, 3.5])
    p3 = np.array([0.2, 0.5, 0.3])
    a0 = a3.sum()
    cases = {
        "Gamma": (D.Gamma(c(2.5), c(1.5)), 2.5 / 1.5, 2.5 / 1.5 ** 2),
        "Beta": (D.Beta(c(2.0), c(5.0)), 2 / 7, 10 / (49 * 8)),
        "Dirichlet": (D.Dirichlet(c(a3)), a3 / a0,
                      a3 * (a0 - a3) / (a0 ** 2 * (a0 + 1))),
        "Binomial": (D.Binomial(10, c(0.3)), 3.0, 2.1),
        "Multinomial": (D.Multinomial(8, c(p3)), 8 * p3, 8 * p3 * (1 - p3)),
    }
    moments, ok = {}, True
    for name, (d, mean, var) in cases.items():
        x = d.sample((n,))._data
        good, got = _moments_within(x, mean, var)
        moments[name] = dict(ok=good, mean_var=got, sample_ms=_card_ms(
            CARD, lambda: d.sample((n,)), iters=3))
        ok = ok and good
    rec.update(moments=moments, moments_ok=ok, draws=n)
    _fresh_card()
    return rec


def _qat_config():
    from paddle_tpu_torch import quantization as Q
    q = Q.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
    return Q.QAT(Q.QuantConfig(activation=q, weight=q))


def _quanters(model):
    from paddle_tpu_torch.quantization import \
        FakeQuanterWithAbsMaxObserverLayer as Q
    return [m for m in model.modules() if isinstance(m, Q)]


def _scales(model):
    import torch
    return torch.cat([q._parameters["scale"].detach().clone()
                      for q in _quanters(model)])


def _qat_card_vs_cpu(seed=47) -> dict:
    """32e's card-vs-CPU check at batch 4 x 224^2 in f32 (dropout 0,
    TF32 off), from one state. Each quanter of the CPU's first QAT step
    is held to a fresh quanter on the card fed the CPU's own input: the
    same scale, and the same fake-quantized values but where x / s * 127
    lies within float rounding of k + 0.5, which may land one step
    (s / 127) apart. The whole step's loss on each device: within
    QAT_LOSS_TOL."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.quantization import \
        FakeQuanterWithAbsMaxObserverLayer as Quanter
    from paddle_tpu_torch.vision.models import mobilenet_v2
    cpu = mobilenet_v2(device="cpu", seed=seed)
    card = mobilenet_v2(device=CARD, seed=seed)
    card.load_state_dict(_torch_state(cpu))
    x, y = _images(QAT_SUB_BATCH, QAT_SUB_HW, seed, channels_last=False)
    seen, losses, models = [], {}, {}
    for name, m, dev in (("card", card, CARD), ("cpu", cpu, "cpu")):
        m.classifier[0].p = 0.0
        m = _qat_config().quantize(m)
        m.train()
        hooks = [q.register_forward_hook(
            lambda mod, inp, out: seen.append((inp[0].detach(),
                                               out.detach())))
            for q in _quanters(m)] if name == "cpu" else []
        losses[name] = float(F.cross_entropy(m(x.to(dev)), y.to(dev)))
        for h in hooks:
            h.remove()
        models[name] = m
    scales_cpu = _scales(models["cpu"])
    same_scale, flips, off = 0, 0, 0
    for (inp, want), s_cpu in zip(seen, scales_cpu):
        q = Quanter(device=CARD)
        q.train()
        got = q(inp.to(CARD)).cpu()
        s = q._parameters["scale"].detach().cpu()[0]
        same_scale += int(s == s_cpu)
        bad = got != want
        pos = inp[bad].double() / float(s_cpu) * 127
        near_half = ((pos - torch.floor(pos)) - 0.5).abs() <= 1e-5 * (
            pos.abs() + 1)
        one_step = (got[bad] - want[bad]).abs() <= s_cpu / 127 * 1.0001
        flips += int(bad.sum())
        off += int((~(near_half & one_step)).sum())
    sc = _scales(models["card"]).cpu()
    return dict(loss=losses["card"], loss_cpu=losses["cpu"],
                loss_rel_err=abs(losses["card"] - losses["cpu"])
                / abs(losses["cpu"]),
                quanters=len(seen), same_scale_from_cpu_input=same_scale,
                flips=flips, flips_off_rule=off,
                end_to_end_scales_equal=int((sc == scales_cpu).sum()),
                end_to_end_scale_max_rel_err=float(
                    ((sc - scales_cpu).abs() / scales_cpu).max()))


def _qat_phase() -> dict:
    """Phase 32e: mobilenet_v2 at phase 29's recipe (b256 x 224^2, bf16
    O1, Momentum) with every Conv2D and Linear fake-quantized: eager
    steps (the observers move), TrainStep's graph (they do not), then
    convert; and the card-vs-CPU step."""
    import torch

    from paddle_tpu_torch.nn.layers import Conv2D, Linear
    from paddle_tpu_torch.quantization import QuantedLayer
    from paddle_tpu_torch.vision.models import mobilenet_v2
    held = _fresh_card()
    model = mobilenet_v2(device=CARD, seed=0)
    n_layers = sum(isinstance(m, (Conv2D, Linear)) for m in model.modules())
    qat = _qat_config()
    model = qat.quantize(model)
    wrapped = sum(isinstance(m, QuantedLayer) for m in model.modules())
    model, step = _qat_train(model)
    x, y = _images(RESNET_BATCH, RESNET_HW, 48, channels_last=False)
    opt = step.optimizer
    s0 = _scales(model)
    eager_ms = []
    for _ in range(QAT_EAGER_STEPS):
        t0 = time.perf_counter()
        loss = step.loss_fn(model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        _sync()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    # the last eager step's graph must not live into the capture (its
    # AccumulateGrad nodes are on the default stream)
    del loss
    s1 = _scales(model)
    losses = [step(x, y) for _ in range(QAT_GRAPH_CALLS)]
    _sync()
    s2 = _scales(model)
    graph_ms = _card_ms(CARD, lambda: step(x, y), iters=3)
    s3 = _scales(model)
    peak = _peak_gib(held)
    model.eval()
    with torch.no_grad():
        xe = x[:32]
        qat_logits = model(xe).float()
        # the same weights without the activation quanters
        wrappers = [m for m in model.modules()
                    if isinstance(m, QuantedLayer)]
        acts = [m.activation_quanter for m in wrappers]
        for m in wrappers:
            m.activation_quanter = None
        weight_only = model(xe).float()
        for m, a in zip(wrappers, acts):
            m.activation_quanter = a
        conv = qat.convert(model)
        conv_logits = conv(xe).float()
    distinct = max(int(torch.unique(m._parameters["weight"]).numel())
                   for m in conv.modules() if isinstance(m, (Conv2D,
                                                            Linear)))
    rec = dict(
        layers=n_layers, wrapped=wrapped, quanters=len(s0),
        eager_moved=int((s1 != s0).sum()),
        graph_moved=int((s2 != s1).sum() + (s3 != s2).sum()),
        losses=[float(v) for v in losses],
        eager_step_ms=eager_ms, graph_step_ms=graph_ms, peak_gib=peak,
        converted_unwrapped=not any(isinstance(m, QuantedLayer)
                                    for m in conv.modules()),
        max_distinct_weight_values=distinct,
        convert_vs_weight_only_rel_err=_rel_err(conv_logits, weight_only),
        convert_vs_qat_rel_l2=float((conv_logits - qat_logits).norm()
                                    / qat_logits.norm()),
        convert_vs_qat_top1=float((conv_logits.argmax(-1)
                                   == qat_logits.argmax(-1)).float()
                                  .mean()))
    del model, step, conv
    _fresh_card()
    with _f32_exact():
        rec["card_vs_cpu"] = _qat_card_vs_cpu()
    _fresh_card()
    return rec


def _qat_train(model):
    """The TrainStep of phase 29's recipe over an already built (and
    quantized) model."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import optimizers
    model.train()
    opt = optimizers.Momentum(learning_rate=0.1, momentum=0.9,
                              weight_decay=1e-4,
                              parameters=_torch_params(model))

    def loss_fn(m, x, y):
        with tamp.auto_cast(enable=True, level="O1", dtype="bfloat16"):
            logits = m(x)
        return F.cross_entropy(logits, y)

    return model, TrainStep(model, opt, loss_fn)


def opsurf_phase(eager) -> dict:
    """Phase 32: the op surfaces' cases of phase 22's sweep, then 32a-32e
    at their users' sizes, each held to the CPU on the same inputs."""
    sweep = eager["sweep"]
    cases = sweep["opsurf_cases"]
    _check("[opsurf] sweep:", {
        f"the {len(cases)} op-surface cases agree with the CPU (phase 22)":
            bool(cases) and not sweep["opsurf_failures"],
    }, cases)
    card = card_line()
    t0 = time.perf_counter()
    _fresh_card()
    audio = _audio_front_end()
    _check("[opsurf] 32a audio:", {
        f"log-mel [{AUDIO_CLIPS}, {AUDIO['n_mels']}, "
        f"{audio['frames']}] within {AUDIO_DB_TOL} dB of the CPU":
            audio["shape"] == [AUDIO_CLIPS, AUDIO["n_mels"],
                               audio["frames"]]
            and audio["logmel_max_abs_db"] <= AUDIO_DB_TOL,
        "MFCC within 1e-4 of the CPU's largest": audio["mfcc_rel_err"]
            <= 1e-4,
        "istft(stft(x), length) within 1e-5 of x":
            audio["roundtrip_max_abs_err"] <= 1e-5,
        "stft's gradient within 1e-4 of the CPU's": audio["grad_rel_err"]
            <= 1e-4,
        "the features record no gradient": audio["features_record_no_grad"],
    }, audio)
    _fresh_card()
    graph = _graph_phase()
    _check("[opsurf] 32b graph:", {
        f"GraphSAGE logits and gradients within {GRAPH_TOL:g} of the CPU":
            graph["logits_rel_err"] <= GRAPH_TOL
            and graph["grad_rel_err"] <= GRAPH_TOL,
        "send_u_recv max equal to the CPU's": graph["max_equal"],
        "send_uv equal, sum and send_ue_recv within 1e-5":
            graph["uv_equal"] and graph["sum_rel_err"] <= 1e-5
            and graph["ue_rel_err"] <= 1e-5,
        "samples, counts and reindexing equal to the CPU's":
            graph["samples_equal"],
        "each sample holds the rule": graph["samples_hold_rule"],
    }, graph)
    _fresh_card()
    sp = _sparse_phase()
    _check("[opsurf] 32c sparse:", {
        "submanifold convs keep the input's sites": sp["subm_keeps_sites"],
        "the regular conv's sites by the reach rule":
            sp["conv_sites_by_rule"],
        "every weight's gradient finite and nonzero":
            sp["grads_finite_nonzero"],
        f"the cut stage's sites equal and values within {SPARSE_TOL:g} of "
        "the CPU (TF32 off)": sp["cut"]["indices_equal"]
            and sp["cut"]["out_rel_err"] <= SPARSE_TOL
            and sp["cut"]["grad_rel_err"] <= SPARSE_TOL,
        "A_norm @ X within 1e-5 of send_u_recv's mean":
            sp["adjacency"]["rel_err_vs_mean"] <= 1e-5,
        "band attention within 1e-4 of SDPA and of the CPU":
            sp["attention"]["rel_err_vs_sdpa"] <= 1e-4
            and sp["attention"]["rel_err_vs_cpu"] <= 1e-4,
    }, sp)
    _fresh_card()
    dist = _distribution_phase()
    _check("[opsurf] 32d distributions:", {
        "PPO heads' values and gradients within 1e-5 of the CPU":
            dist["values_rel_err"] <= 1e-5 and dist["grad_rel_err"] <= 1e-5
            and abs(dist["loss"] - dist["loss_cpu"]) <= 1e-5 * max(
                1.0, abs(dist["loss_cpu"])),
        "categorical draws in range": dist["cat_sample_ok"],
        "rsample's gradients the reparameterised ones within 1e-5":
            dist["rsample_grad_err"] <= 1e-5,
        f"moments of {DIST_DRAWS} draws within 6 standard errors":
            dist["moments_ok"],
    }, dist)
    qat = _qat_phase()
    cvc = qat["card_vs_cpu"]
    _check("[opsurf] 32e QAT:", {
        "every Conv2D and Linear wrapped": qat["wrapped"] == qat["layers"],
        "the eager steps move the observers": qat["eager_moved"] > 0,
        "TrainStep's graph leaves them": qat["graph_moved"] == 0,
        "converted weights take at most 255 values":
            qat["converted_unwrapped"]
            and qat["max_distinct_weight_values"] <= 255,
        # convert drops the activation quanters (as the reference's
        # does): its logits are the QAT model's with those off
        "converted logits equal the QAT model's without activation "
        "quanters within 1e-3": qat["convert_vs_weight_only_rel_err"]
            <= 1e-3,
        "card vs CPU: each quanter's scale equal and its values equal "
        "but for one-step flips at k + 0.5, the loss within "
        f"{QAT_LOSS_TOL:g}": cvc["same_scale_from_cpu_input"]
            == cvc["quanters"] and cvc["flips_off_rule"] == 0
            and cvc["loss_rel_err"] <= QAT_LOSS_TOL,
    }, qat)
    secs = time.perf_counter() - t0
    ms = dict(audio=audio["ms"], graph=graph["ms"],
              second_stage=sp["stage_ms"],
              second_stage_no_tf32=sp["stage_ms_no_tf32"],
              adjacency_spmm=sp["adjacency"]["ms"],
              band_attention=sp["attention"]["ms"],
              band_sdpa=sp["attention"]["sdpa_ms"], distributions=dist["ms"],
              qat_graph_step=qat["graph_step_ms"],
              qat_eager_step=qat["eager_step_ms"])
    log(f"[opsurf] phase 32 on {card} took {secs:.1f} s; ms by CUDA events: "
        + json.dumps(ms))
    return dict(card=card, seconds=secs, sweep_cases=cases, audio=audio,
                graph=graph, sparse=sp, distributions=dist, qat=qat)


# ---------------------------------------------------------------------------
# phase 33: observability on the serving and training paths
# ---------------------------------------------------------------------------
# phase 4's model, kept for phase 33a (main frees it right after), and
# phase 6's TrainStep, kept for phase 33b (freed right after): nothing
# of one phase's lives into another's measured run
OBS_KEEP = {"serve": {}, "train": {}}
OBS_ROOFLINE_MAX = 1.05
# the hand-written kernels a profiler session may name (substrings of
# the demangled names)
HAND_KERNELS = ("rpa_sm90", "flash_fwd_sm90", "flash_bwd_dkdv_sm90",
                "flash_bwd_dq_sm90", "flash_bwd_delta", "mta_update")


@contextlib.contextmanager
def roofline_samples():
    """Measurement only: every roofline sample published while the block
    runs, {family: [(hbm, flops) utilization, ...]}, by the gauges' own
    formula (the recorder is wrapped, not changed; a gauge keeps only
    its last sample)."""
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.observability import perf
    observe = perf.observe_roofline
    out = {}

    def sampled(family, seconds, cost):
        observe(family, seconds, cost)
        peaks = perf.device_peaks()
        if om._ENABLED and cost is not None and seconds > 0 and peaks:
            out.setdefault(family, []).append(
                (cost.bytes_accessed / seconds / peaks[1],
                 cost.flops / seconds / peaks[0]))

    perf.observe_roofline = sampled
    try:
        yield out
    finally:
        perf.observe_roofline = observe


def _roofline_checks(families, samples, window) -> dict:
    """Every sample of each family and its window's record (the gauges'
    bounds, hbm and flops) in (0, OBS_ROOFLINE_MAX]."""
    ok = lambda x: x is not None and 0.0 < x <= OBS_ROOFLINE_MAX  # noqa
    return {
        f"{f} roofline: every sample ({len(samples.get(f, ()))}) and the "
        f"window in (0, {OBS_ROOFLINE_MAX}]": bool(samples.get(f)) and all(
            ok(x) for s in samples[f] for x in s) and f in window and ok(
            window[f]["utilization_hbm"]) and ok(
            window[f]["utilization_flops"])
        for f in families}


def _sample_range(samples) -> dict:
    """{family: [[min hbm, max hbm], [min flops, max flops], samples]}."""
    return {f: [[min(s[0] for s in v), max(s[0] for s in v)],
                [min(s[1] for s in v), max(s[1] for s in v)], len(v)]
            for f, v in samples.items()}


def _obs_serve(model, prompts, n_new, engine_kw) -> dict:
    """`prompts` served to the end through a fresh LLMEngine over
    `model`: tokens by request, wall seconds, each step's wall ms with
    the captures and packed waves it ran (a step reads its tokens back,
    so its wall covers its device time), B3's launches by design, the
    decode steps the chunks ran (counted around `_decode_chunk`,
    measurement only) and the engine, kept for the caller."""
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    eng = LLMEngine(model, **engine_kw)
    steps = [0]
    decode_chunk = eng._decode_chunk

    def counted(cur, lens, tbl, chunk):
        steps[0] += chunk
        return decode_chunk(cur, lens, tbl, chunk)

    eng._decode_chunk = counted
    rpa.reset_counters()
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=n_new)
    done, walls = {}, []
    torch.cuda.synchronize()
    t = time.perf_counter()
    while eng.has_unfinished:
        caps = sum(cuda_graph.captures.values())
        waves = eng.stats["ragged_launches"]
        t1 = time.perf_counter()
        for r in eng.step():
            done[r.request_id] = r
        walls.append((1e3 * (time.perf_counter() - t1),
                      sum(cuda_graph.captures.values()) - caps,
                      eng.stats["ragged_launches"] - waves))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    eng._decode_chunk = decode_chunk
    f = rpa.ragged_paged_attention
    # steady steps: a decode chunk alone, no capture, no packed wave
    steady = [w for w, c, n in walls if not c and not n]
    return dict(eng=eng, done=done, seconds=secs,
                tokens=sum(len(r.output_ids) for r in done.values()),
                step_walls=walls, steady_ms=statistics.median(steady),
                steady_steps=len(steady), launches=f.kernel_launches,
                designs=dict(f.design_launches), decode_steps=steps[0])


def _series(doc, name):
    """{label tuple (sorted items): value} of one metric of a to_json
    document."""
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in doc.get(name, {}).get("series", [])}


def _trace_shape(evs) -> dict:
    """Checks of the trace ring after the observed run: the engine's
    spans and their parents, and every request's events under its own
    root span."""
    by_id = {e.get("span_id"): e for e in evs}

    def parent(e):
        p = by_id.get(e.get("parent_id"))
        return p["name"] if p is not None else None

    names = {e["name"] for e in evs}
    roots = {e["trace_id"]: e for e in evs if e["name"] == "request"}
    req_evs = [e for e in evs if e["name"].startswith("request.")]
    return {
        "engine.step, .prefill, .ragged, .decode_chunk present":
            {"engine.step", "engine.prefill", "engine.ragged",
             "engine.decode_chunk"} <= names,
        "engine.prefill and .decode_chunk under engine.step, engine."
        "ragged under engine.prefill": all(
            parent(e) == want for e in evs for n, want in (
                ("engine.prefill", "engine.step"),
                ("engine.decode_chunk", "engine.step"),
                ("engine.ragged", "engine.prefill")) if e["name"] == n),
        "16 request roots, each request's prefill and decode chunks "
        "under its own root": len(roots) == 16 and all(
            e["trace_id"] in roots
            and e.get("parent_id") == roots[e["trace_id"]]["span_id"]
            for e in req_evs) and {
            e["trace_id"] for e in req_evs
            if e["name"] == "request.prefill"} == set(roots) and {
            e["trace_id"] for e in req_evs
            if e["name"] == "request.decode_chunk"} == set(roots),
    }


def _named_kernels(evs) -> dict:
    """{hand-written kernel: device events naming it} of a session."""
    out = {}
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        for k in HAND_KERNELS:
            if k in e["name"]:
                out[k] = out.get(k, 0) + 1
    return out


def _chrome_trace(prof, tmp, name):
    """The session's exported chrome trace: (host span names, kernel
    events, {hand-written kernel: events})."""
    from paddle_tpu_torch import profiler
    path = profiler.export_chrome_tracing(f"{tmp}/prof", name)(prof)
    trace = profiler.load_profiler_result(path)["traceEvents"]
    return (sorted({e["name"] for e in trace if "cat" not in e}),
            sum(e.get("cat") == "kernel" for e in trace),
            _named_kernels(trace))


def _report(phase, checks, rec):
    for what, ok in checks.items():
        log(f"[obs] {phase} check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"observability phase {phase} failed: {rec}")


def obs_serve_phase(engine: dict) -> dict:
    """Phase 33a (see the module docstring), on phase 4's model."""
    import gc
    import tempfile
    import torch
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.observability import flight
    sv = OBS_KEEP["serve"]
    model, prompts, kw = sv["model"], sv["prompts"], sv["engine_kw"]
    n_new = sv["n_new"]
    want = SERVED["gpt3_1p3b", "bfloat16", "bfloat16"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    checks = {}

    def served(r):
        return set(r["done"]) == set(want) and all(
            np.array_equal(r["done"][i].output_ids, want[i]) for i in want)

    # -- off, on, off, then on with the flight recorder armed: the checks
    # read the last run; the rates and steady steps of all four --------
    runs = {"off": [], "on": []}
    for mode in ("off", "on", "off", "on"):
        obs.disable()
        obs.reset()
        last = len(runs["on"]) == 1 and mode == "on"
        if last:
            flight.arm(f"{tmp}/flight")
        if mode == "on":
            obs.enable()
        cuda_graph.reset_counters()
        with roofline_samples() as samples:
            r = _obs_serve(model, prompts, n_new, kw)
        runs[mode].append(dict(
            tokens_per_s=r["tokens"] / r["seconds"],
            steady_ms=r["steady_ms"], steady_steps=r["steady_steps"],
            step_ms=[w for w, _c, _n in r["step_walls"]]))
        checks[f"observability {mode} (run {len(runs[mode])}): phase 4's "
               f"tokens"] = served(r)
        checks[f"observability {mode} (run {len(runs[mode])}): every B3 "
               f"launch sm90"] = r["designs"].get("sm90", 0) \
            == r["launches"] > 0
        if not last:
            del r["eng"], r
            gc.collect()        # an engine's graphs and pools form cycles
            torch.cuda.empty_cache()
    on, eng = r, r["eng"]
    caps = dict(cuda_graph.captures)
    doc = json.loads(obs.to_json())
    evs = obs.trace_events()
    window = obs.perf.family_records()
    events = {dict(k)["event"]: v for k, v in
              _series(doc, "paddle_tpu_engine_events_total").items()}
    mirrored = {k: v for k, v in eng.stats.items() if v and k not in (
        "prefix_cache_hit_tokens", "prefix_cache_miss_tokens",
        "spec_drafted_tokens", "spec_accepted_tokens")}
    hist_n = {n: sum(v["count"] for v in _series(
        doc, f"paddle_tpu_request_{n}_seconds").values())
        for n in ("ttft", "tpot", "e2e")}
    compiles = {dict(k)["family"]: v for k, v in _series(
        doc, "paddle_tpu_compile_total").items() if v}
    roof = {}
    for k, v in _series(doc, "paddle_tpu_roofline_utilization").items():
        d = dict(k)
        roof.setdefault(d["family"], {})[d["bound"]] = v
    checks["observability on: every decode step a replay"] = \
        cuda_graph.replays["engine_decode"] == on["decode_steps"]
    checks["paddle_tpu_engine_events_total == engine.stats"] = \
        events == {k: float(v) for k, v in mirrored.items()}
    checks["TTFT, TPOT and e2e histograms count 16 requests"] = \
        hist_n == {"ttft": 16, "tpot": 16, "e2e": 16}
    checks["paddle_tpu_compile_total{family} == the captures"] = \
        compiles == {"engine_decode": float(caps.get("engine_decode", 0))}
    checks.update(_trace_shape(evs))
    checks.update(_roofline_checks(("engine_decode", "engine_ragged"),
                                   samples, window))

    # -- a planted deadline miss: one flight bundle --------------------
    clock = {"now": 0.0}
    eng._now = lambda: clock["now"]
    eng.add_request("late", prompts[0], max_new_tokens=4, deadline_s=1.0)
    clock["now"] = 10.0
    eng.step()
    bundles = flight.bundles()
    bundle = flight.load_bundle(bundles[-1]) if bundles else None
    checks["a planted deadline miss drops one bundle with the metrics "
           "and the trace"] = (
        len(bundles) == 1 and bundle["meta"]["reason"] == "deadline_miss"
        and "paddle_tpu_engine_events_total" in bundle["metrics"]
        and any(e["name"] == "engine.step" for e in bundle["trace"]))
    flight.disarm()

    # -- a profiler session over two engine steps -----------------------
    for i, p in enumerate(prompts[:2]):
        eng.add_request(f"prof{i}", p, max_new_tokens=n_new)
    clock["now"] = 0.0
    with profiler.Profiler() as prof:
        eng.step()
        eng.step()
    host, n_kernels, named = _chrome_trace(prof, tmp, "serve")
    checks["a profiler session's chrome trace over two engine steps "
           "holds host spans and device kernels"] = (
        "engine.step" in host and n_kernels > 0)
    while eng.has_unfinished:
        eng.step()
    obs.disable()
    obs.reset()
    b3_launches = on["launches"]
    del eng, on, r
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(
        tokens_per_s_off=[x["tokens_per_s"] for x in runs["off"]],
        tokens_per_s_on=[x["tokens_per_s"] for x in runs["on"]],
        steady_ms_off=[x["steady_ms"] for x in runs["off"]],
        steady_ms_on=[x["steady_ms"] for x in runs["on"]], runs=runs,
        roofline=roof, roofline_samples=_sample_range(samples),
        family_records=window, weight_read_ms=engine["weight_read_ms"],
        decode_ms_per_step=engine["decode_ms_per_step"],
        b3_launches=b3_launches, captures=caps,
        compiles=compiles, events=events, histogram_counts=hist_n,
        kernels_named=named, device_kernel_events=n_kernels,
        host_span_names=host, card=card_line())
    log(f"[obs] 33a gpt3_1p3b served 16 requests a run (off, on, off, "
        f"on): {[round(x, 1) for x in rec['tokens_per_s_off']]} tokens/s "
        f"off, {[round(x, 1) for x in rec['tokens_per_s_on']]} on; steady "
        f"decode steps (median ms, a chunk alone, no capture, no packed "
        f"wave) {[round(x, 3) for x in rec['steady_ms_off']]} off, "
        f"{[round(x, 3) for x in rec['steady_ms_on']]} on; rooflines "
        f"(hbm min-max, flops min-max, samples) "
        f"{json.dumps(rec['roofline_samples'])}, over the window "
        f"{json.dumps({f: (w['utilization_hbm'], w['utilization_flops'], w['runs']) for f, w in window.items()})} "
        f"beside phase 4's weight-read floor "
        f"{engine['weight_read_ms']:.3f} ms and decode "
        f"{engine['decode_ms_per_step']:.3f} ms a step; compiles "
        f"{compiles}; the profiler names {named} over 2 engine steps "
        f"({n_kernels} kernel events); card {rec['card']}")
    _report("33a", checks, rec)
    return rec


def _obs_train(step, ids, labels, state, n_calls=4) -> dict:
    """`n_calls` TrainStep calls from `state` (restored first), through
    a fresh graph cache (a capture, then replays), each timed by wall
    with a sync; the losses and the step times."""
    import torch
    from paddle_tpu_torch.jit.cuda_graph import GraphCache
    with torch.no_grad():
        for p, (p0, st0) in zip(step._params, state):
            p.copy_(p0)
            for k, v in step.optimizer._get_state(p).items():
                v.copy_(st0[k])
    step._graphs = GraphCache()
    losses, times = [], []
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
    return dict(losses=losses, step_s=times)


def obs_train_phase(train: dict) -> dict:
    """Phase 33b (see the module docstring), on phase 6's TrainStep."""
    import tempfile
    import torch
    from paddle_tpu_torch import device as pdev
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.jit import cuda_graph
    tr = OBS_KEEP["train"]
    step, ids, labels = tr["step"], tr["ids"], tr["labels"]
    state = [(p.detach().clone(), {
        k: v.detach().clone() for k, v in step.optimizer._get_state(
            p).items()}) for p in step._params]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    checks = {}

    # -- 4 calls off, 4 from the same state on, in turns ----------------
    times = {"off": [], "on": []}
    for mode in ("off", "on", "off", "on"):
        obs.disable()
        obs.reset()
        if mode == "on":
            obs.enable()
        cuda_graph.reset_counters()
        with roofline_samples() as samples:
            r = _obs_train(step, ids, labels, state)
            torch.cuda.synchronize()
            step._read_timings()
        times[mode].append(1e3 * statistics.median(r["step_s"][1:]))
        if mode == "off":
            want = r["losses"]
        checks[f"train_step losses bit-equal, observability {mode} (run "
               f"{len(times[mode])}) and off"] = r["losses"] == want
    caps = dict(cuda_graph.captures)
    doc = json.loads(obs.to_json())
    window = obs.perf.family_records()
    compiles = {dict(k)["family"]: v for k, v in _series(
        doc, "paddle_tpu_compile_total").items() if v}
    checks["paddle_tpu_compile_total{family} == the captures"] = \
        compiles == {"train_step": float(caps.get("train_step", 0))}
    roof = {dict(k)["bound"]: v for k, v in _series(
        doc, "paddle_tpu_roofline_utilization").items()}
    checks.update(_roofline_checks(("train_step",), samples, window))

    # -- profiler sessions: a replayed step, then an eager one ---------
    with profiler.Profiler() as prof:
        with profiler.RecordEvent("train_step"):
            step(ids, labels)
    host, n_kernels, named_replay = _chrome_trace(prof, tmp, "train")
    checks["a profiler session's chrome trace over a replayed train "
           "step holds host spans and device kernels"] = (
        "train_step" in host and n_kernels > 0)
    step._eager = True
    with profiler.Profiler() as prof2:
        step(ids, labels)
    step._eager = False
    named_eager = _named_kernels(prof2.events())

    # -- device.memory against torch.cuda across a reset ----------------
    pdev.cuda.reset_peak_memory_stats()
    base = (pdev.cuda.max_memory_allocated(),
            torch.cuda.max_memory_allocated())
    held = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    peak = (pdev.cuda.max_memory_allocated(),
            torch.cuda.max_memory_allocated())
    del held
    checks["device.max_memory_allocated() == torch.cuda's across a "
           "reset"] = base[0] == base[1] and peak[0] == peak[1] \
        and peak[0] >= base[0] + (1 << 28)
    obs.disable()
    obs.reset()
    rec = dict(
        step_ms_off=times["off"], step_ms_on=times["on"],
        phase6_step_ms_median=train["step_ms_median"], roofline=roof,
        roofline_samples=_sample_range(samples), family_records=window,
        captures=caps, compiles=compiles, losses=r["losses"],
        kernels_named_replay=named_replay, kernels_named_eager=named_eager,
        device_kernel_events=n_kernels, host_span_names=host,
        memory_base=base, memory_peak=peak, card=card_line())
    log(f"[obs] 33b gpt2_small TrainStep, median ms of calls 2-4 (off, "
        f"on, off, on): {[round(x, 3) for x in times['off']]} off, "
        f"{[round(x, 3) for x in times['on']]} on; roofline (hbm min-max, "
        f"flops min-max, samples) {json.dumps(rec['roofline_samples'])}, "
        f"over the window {json.dumps({f: (w['utilization_hbm'], w['utilization_flops'], w['runs']) for f, w in window.items()})}; "
        f"compiles {compiles}; the profiler names {named_replay} (a "
        f"replayed train step, {n_kernels} kernel events) and "
        f"{named_eager} (an eager train step); card {rec['card']}")
    _report("33b", checks, rec)
    return rec


# ---------------------------------------------------------------------------
# phase 34: the numerics plane on phase 6's gpt2_small TrainStep
# ---------------------------------------------------------------------------
# the statistics kernel against pack_stats over a clone of the pre-update
# work arrays: f32 sums of the same positive terms in another order (per
# thread, warp shuffles, chunk rows, tensor rows) against torch's
# reductions, so a relative tolerance; counts exactly
NUM_STATS_RTOL = 1e-5
# the plane's record against a plain recomputation at one step: norms of
# the same f32 arrays in float64 (param, update), and the gradient of an
# eager forward and backward from the same state and batch, whose
# reductions the graph's launches may order differently
NUM_RECOMPUTE_RTOL = 1e-3
NUM_STEPS = 8


def _stats_errs(got, want):
    """{part: largest relative error} of a packed bundle against the
    plain one, and whether the counts are equal."""
    import torch
    P = (want.numel() - 3) // 2
    g, w = got.double().cpu(), want.double().cpu()

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    errs = {"grad_sq": rel(g[:P], w[:P]), "param_sq": rel(g[2 * P],
                                                          w[2 * P]),
            "update_sq": rel(g[2 * P + 1], w[2 * P + 1])}
    counts = torch.equal(g[P:2 * P], w[P:2 * P]) and float(
        g[2 * P + 2]) == float(w[2 * P + 2])
    return errs, counts, float((g - w).abs().max())


def _numerics_kernel(shapes, init) -> dict:
    """34a: the statistics variant against its plain version at phase 6's
    148 shapes (phase 12's first case: f32, AdamW, two groups' decays),
    bit-equality with the statistics-off launch, and both timed by
    replay beside the byte bound."""
    import torch
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.observability import numerics
    case = UPDATE_CASES[0]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=case[1])
    lr = torch.full((), UPDATE_LR, device="cuda")
    on = _update_slots(shapes, init, case, seed=34)
    off = _update_slots(shapes, init, case, seed=34)
    olds = [s.w.clone() for s in on]
    P = len(shapes)
    table = torch.zeros(P, mta.STATS_COLS, device="cuda")
    packed = torch.zeros(2 * P + 3, device="cuda")
    scratch = torch.zeros(mta.scratch_floats(s.w.numel() for s in on),
                          device="cuda")
    n0 = mta.multi_tensor_adam.stats_launches
    mta.multi_tensor_adam(on, lr, stats=table, scratch=scratch, **kw)
    mta.pack_rows(table, out=packed)
    mta.multi_tensor_adam(off, lr, **kw)
    torch.cuda.synchronize()
    launches = mta.multi_tensor_adam.stats_launches - n0
    bit_equal = all(torch.equal(getattr(a, k), getattr(b, k))
                    for a, b in zip(on, off)
                    for k in ("w", "m", "v", "beta1_pow", "beta2_pow"))
    want = numerics.pack_stats(olds, [s.g for s in on], [s.w for s in on])
    errs, counts, max_abs = _stats_errs(packed, want)
    del olds
    # a fault planted: one tensor's row left out of the table
    planted = table.clone()
    planted[P // 2] = 0.0
    perrs, _pc, _pa = _stats_errs(mta.pack_rows(planted), want)
    ms_on = graph_ms(lambda: (mta.multi_tensor_adam(
        on, lr, stats=table, scratch=scratch, **kw),
        mta.pack_rows(table, out=packed)), reps=5, iters=10)
    ms_off = graph_ms(lambda: mta.multi_tensor_adam(off, lr, **kw), reps=5,
                      iters=10)
    ms_on2 = graph_ms(lambda: (mta.multi_tensor_adam(
        on, lr, stats=table, scratch=scratch, **kw),
        mta.pack_rows(table, out=packed)), reps=5, iters=10)
    ms_off2 = graph_ms(lambda: mta.multi_tensor_adam(off, lr, **kw),
                       reps=5, iters=10)
    plain_ms = cuda_ms(lambda: (mta.multi_tensor_adam(
        off, lr, path="torch", stats=table, **kw), mta.pack_rows(
            table, out=packed)), iters=3, warmup=1)
    bms, _by, nbytes, flops = _update_bound(on)
    chunks = sum(-(-s.w.numel() // 16384) for s in on)
    # the statistics add a [chunks, 5] row each block writes and the fold
    # reads, the [P, 5] table written and read, and the bundle written
    extra = 2 * 20 * chunks + 2 * 20 * P + 4 * (2 * P + 3)
    t_bytes = (nbytes + extra) / HBM_BYTES_PER_S * 1e3
    t_ops = (flops + 8 * sum(s.w.numel() for s in on)) / F32_FLOPS_PER_S \
        * 1e3
    checks = {
        "one statistics launch for 148 tensors": launches == 1,
        "parameters, moments and powers bit-equal to the statistics-off "
        "launch": bit_equal,
        f"every sum within rel {NUM_STATS_RTOL} of pack_stats": all(
            e <= NUM_STATS_RTOL for e in errs.values()),
        "the nonfinite counts equal (0)": counts,
        "a tensor's row left out is caught": perrs["grad_sq"] > 0.5,
    }
    rec = dict(tensors=P, chunks=chunks, launches=launches,
               errs=errs, planted_errs=perrs, max_abs_err=max_abs,
               ms_on=[ms_on, ms_on2], ms_off=[ms_off, ms_off2],
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_ms_off=bms, extra_bytes=extra)
    log(f"[numerics] 34a statistics kernel, {P} tensors ({chunks} chunks): "
        f"statistics launches {launches}, bit-equal {bit_equal}, rel "
        f"errs {errs}, counts equal {counts}; planted row {perrs}; by "
        f"replay on {ms_on:.4f} / {ms_on2:.4f} ms, off {ms_off:.4f} / "
        f"{ms_off2:.4f} ms (off, on, off, on); plain {plain_ms:.3f} ms; "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; off "
        f"{bms:.4f}); card {card_line()}")
    _check("[numerics] 34a", checks, rec)
    del on, off, table, packed, scratch, planted
    torch.cuda.empty_cache()
    return rec


def _restore(step, state):
    import torch
    with torch.no_grad():
        for p, (p0, st0) in zip(step._params, state):
            p.copy_(p0)
            for k, v in step.optimizer._get_state(p).items():
                v.copy_(st0[k])


def _numerics_run(step, ids, labels, state, plane) -> dict:
    """NUM_STEPS TrainStep calls from `state` through a fresh graph cache
    (a capture, then replays), each timed by wall with a sync, the plane
    on or off (metrics on in both); with the plane on, the statistics
    launches counted around the run and split at its capture, the pulls,
    the record of step 1 and the parameters after step 1."""
    import torch
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.jit.cuda_graph import GraphCache
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.observability import numerics
    _restore(step, state)
    step._graphs = GraphCache()
    step._pending.clear()
    numerics.disable()
    numerics.reset_window()
    if plane:
        numerics.enable(interval=1)
    cuda_graph.reset_counters()

    def read():
        return (mta.multi_tensor_adam.stats_launches,)

    losses, times, rec1, w1 = [], [], None, None
    pulls0 = numerics.pulls()
    with capture_counts(read) as spans:
        mta.multi_tensor_adam.stats_launches = 0
        for i in range(NUM_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
            if plane and i == 0:
                w1 = [p.detach().clone() for p in step._params]
            if plane and i == 1:
                rec1 = numerics.last()
        counted = read()[0]
    pulls_before_flush = numerics.pulls() - pulls0
    last = numerics.flush() if plane else None
    in_graph = sum(b[0] - a[0] for a, b in spans)
    eager = counted - in_graph
    replays = cuda_graph.replays.get("train_step", 0)
    numerics.disable()
    return dict(
        losses=losses, step_s=times, rec1=rec1, w1=w1, last=last,
        pulls_before_flush=pulls_before_flush,
        pulls=numerics.pulls() - pulls0, counted=counted,
        on_device=eager + in_graph * replays,
        captures=dict(cuda_graph.captures),
        params=[p.detach().clone() for p in step._params])


def _numerics_recompute(step, ids, labels, state, w1) -> dict:
    """Step 1's grad norm, param norm and update ratio recomputed plainly
    from `state` (the parameters before step 1) and `w1` (after it): the
    gradient of an eager forward and backward of the step's loss."""
    import torch
    _restore(step, state)
    ids_t = torch.as_tensor(ids, device="cuda")
    labels_t = torch.as_tensor(labels, device="cuda")
    loss = step.loss_fn(step.model, ids_t, labels_t)
    grads = torch.autograd.grad(loss, step._params)
    gsq = sum(float(g.double().square().sum()) for g in grads)
    psq = sum(float(p0.double().square().sum()) for p0, _ in state)
    dsq = sum(float((a.double() - p0.double()).square().sum())
              for a, (p0, _) in zip(w1, state))
    del grads, loss
    return dict(grad_norm=gsq ** 0.5, param_norm=psq ** 0.5,
                update_ratio=dsq ** 0.5 / psq ** 0.5)


def _eager_poisoned(step, ids, labels, state, tmp) -> dict:
    """34c: an eager step (the eager API's backward, Optimizer.step) with
    one parameter's gradient poisoned through the numerics.check fault
    point, then a clean step; then an f16 GradScaler run poisoned at
    every step until the scale reaches the floor."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.autograd import backward
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.observability import flight, numerics
    from paddle_tpu_torch.resilience import faults
    opt, model = step.optimizer, step.model
    ids_t = torch.as_tensor(ids, device="cuda")
    labels_t = torch.as_tensor(labels, device="cuda")
    name = opt._names[id(step._params[5])]
    flight.arm(tmp, min_interval_s=0.0)
    numerics.reset_window()
    numerics.enable(interval=1, loss_scale_floor=2.0)

    def eager_step(poison):
        loss = step.loss_fn(model, ids_t, labels_t)
        backward([Tensor._wrap(loss, stop_gradient=False)])
        if poison:
            with faults.inject("numerics.check", times=1,
                               exc=numerics.PoisonGradient(param=name),
                               match={"where": "step"}):
                opt.step()
        else:
            opt.step()
        opt.clear_grad()

    _restore(step, state)
    eager_step(poison=True)
    numerics.flush()
    poisoned = flight.bundles(tmp)
    _restore(step, state)
    eager_step(poison=False)
    rec_clean = numerics.flush()
    rearmed = not numerics._DIVERGED
    # the f16 scaler: a scale of 16 halved at each skipped step
    scaler = amp.GradScaler(init_loss_scaling=16.0,
                            decr_every_n_nan_or_inf=1)
    scales = []
    with faults.inject("numerics.check", exc=numerics.PoisonGradient(),
                       match={"where": "amp"}):
        for _ in range(4):
            with amp.auto_cast(level="O1", dtype="float16"):
                logits = model(ids_t)
            loss = GPTPretrainingCriterion()(logits, labels_t)
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            scales.append(scaler._scale)
    numerics.disable()
    bundles = flight.bundles(tmp)
    flight.disarm()
    metas = [flight.load_bundle(b)["meta"] for b in bundles]
    return dict(name=name, poisoned_bundles=len(poisoned),
                bundles=len(bundles), metas=metas, rearmed=rearmed,
                clean_source=rec_clean["source"],
                clean_nonfinite=rec_clean["nonfinite"], scales=scales)


def numerics_phase() -> dict:
    """Phase 34 (see the module docstring), on phase 6's TrainStep."""
    import tempfile
    import torch
    from paddle_tpu_torch import observability as obs
    t0 = time.perf_counter()
    tr = OBS_KEEP["train"]
    step, ids, labels = tr["step"], tr["ids"], tr["labels"]
    state = [(p.detach().clone(), {
        k: v.detach().clone() for k, v in step.optimizer._get_state(
            p).items()}) for p in step._params]
    shapes = [tuple(p.shape) for p in step._params]
    kernel = _numerics_kernel(shapes, [p0 for p0, _ in state])

    # -- 34b: off, on, off, on from the same state ----------------------
    obs.disable()
    obs.reset()
    obs.metrics.enable()
    runs = {"off": [], "on": []}
    with roofline_samples() as samples:
        for mode in ("off", "on", "off", "on"):
            runs[mode].append(_numerics_run(step, ids, labels, state,
                                            mode == "on"))
        torch.cuda.synchronize()
        step._read_timings()
    doc = json.loads(obs.to_json())
    compiles = {dict(k)["family"]: v for k, v in _series(
        doc, "paddle_tpu_compile_total").items() if v}
    goodput = {dict(k)["component"]: v for k, v in _series(
        doc, "paddle_tpu_train_goodput_fraction").items()}
    off, on = runs["off"][0], runs["on"][0]
    rec1, w1 = on["rec1"], on["w1"]
    plain = _numerics_recompute(step, ids, labels, state, w1)
    near = lambda a, b: a is not None and math.isfinite(a) and abs(  # noqa
        a - b) <= NUM_RECOMPUTE_RTOL * abs(b)
    ms = {m: [1e3 * statistics.median(r["step_s"][1:]) for r in runs[m]]
          for m in runs}
    checks = {
        "the plane's runs capture one graph each, counted as train_step "
        "compiles": all(r["captures"] == {"train_step": 1}
                        for rs in runs.values() for r in rs)
        and compiles == {"train_step": 4.0},
        f"one pull a published step ({NUM_STEPS} steps: "
        f"{NUM_STEPS - 1} before the flush, {NUM_STEPS} after)": all(
            (r["pulls_before_flush"], r["pulls"]) == (NUM_STEPS - 1,
                                                      NUM_STEPS)
            for r in runs["on"]),
        "the statistics kernel launched on the path (eager warm-up and "
        "capture; on the card once a step)": all(
            r["counted"] == 2 and r["on_device"] == NUM_STEPS
            for r in runs["on"]),
        "no statistics launch with the plane off": all(
            r["counted"] == 0 for r in runs["off"]),
        "losses bit-equal, plane on and off": all(
            r["losses"] == off["losses"] for rs in runs.values()
            for r in rs),
        f"parameters after {NUM_STEPS} steps bit-equal, plane on and off":
            all(all(torch.equal(a, b) for a, b in zip(r["params"],
                                                       off["params"]))
                for r in runs["on"] + runs["off"][1:]),
        "step 1's grad norm, param norm and update ratio finite and within "
        f"rel {NUM_RECOMPUTE_RTOL} of a plain recomputation": rec1 is not
        None and rec1["step"] == 1 and all(near(rec1[k], plain[k]) for k in
                                           ("grad_norm", "param_norm",
                                            "update_ratio")),
        "the last record is step 8's, clean, with its loss": on["last"][
            "step"] == NUM_STEPS and on["last"]["nonfinite"] == {
            "grad": 0, "param": 0, "loss": 0} and on["last"]["loss"] ==
        on["losses"][-1],
        # 34d
        "goodput published (comms, compute, stall), summing to <= 1":
            set(goodput) == {"comms", "compute", "stall"} and sum(
                goodput.values()) <= 1.0 + 1e-9,
    }
    del w1
    for r in runs["on"] + runs["off"]:
        r.pop("params")
        r.pop("w1")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_numerics_")
    obs.enable()
    sent = _eager_poisoned(step, ids, labels, state, tmp)
    obs.disable()
    obs.reset()
    first, *rest = sent["metas"]
    det = first["detail"]
    floor = rest[0]["detail"] if rest else {}
    checks.update({
        "the poisoned eager step gives exactly one numerics_divergence "
        "bundle naming the parameter, with the backward tap's record":
            sent["poisoned_bundles"] == 1
            and first["reason"] == "numerics_divergence"
            and det["first_nonfinite_param"] == sent["name"]
            and "nonfinite" in det["reasons"]
            and det["backward"] is not None
            and det["backward"]["segments"] == 1,
        "a clean step re-arms the sentinel": sent["rearmed"]
        and sent["clean_source"] == "optimizer_fused"
        and sent["clean_nonfinite"] == {"grad": 0, "param": 0, "loss": 0},
        "the f16 scaler reaching the floor fires one more bundle with the "
        "scale history": sent["bundles"] == 2
        and floor.get("reasons") == ["loss_scale_floor"]
        and floor.get("loss_scale_history", [])[-3:] == [8.0, 4.0, 2.0]
        and sent["scales"] == [8.0, 4.0, 2.0, 1.0],
    })
    rec = dict(kernel=kernel, step_ms_off=ms["off"], step_ms_on=ms["on"],
               losses=on["losses"], record_step1={
                   k: rec1[k] for k in ("grad_norm", "param_norm",
                                        "update_ratio", "source")},
               plain_step1=plain, compiles=compiles, goodput=goodput,
               roofline_samples=_sample_range(samples),
               stats_launches=on["counted"],
               stats_launches_on_device=on["on_device"],
               sentinel={k: v for k, v in sent.items() if k != "metas"},
               bundle_reasons=[m["detail"]["reasons"] for m in sent["metas"]],
               card=card_line())
    rec["seconds"] = time.perf_counter() - t0
    log(f"[numerics] 34b gpt2_small TrainStep, {NUM_STEPS} calls a run, "
        f"median ms of calls 2-{NUM_STEPS} (off, on, off, on): "
        f"{[round(x, 3) for x in ms['off']]} off, "
        f"{[round(x, 3) for x in ms['on']]} on; step 1 {rec['record_step1']}"
        f" vs plain {plain}; compiles {compiles}; statistics launches "
        f"counted {on['counted']}, on the card {on['on_device']}; 34c "
        f"bundles {rec['bundle_reasons']}, scales {sent['scales']}; 34d "
        f"goodput {goodput}; {rec['seconds']:.1f} s; card {rec['card']}")
    _report("34", checks, rec)
    return rec


# ---------------------------------------------------------------------------
# phase 35: text, static, the inference model and a cpp_extension op
# ---------------------------------------------------------------------------
CPP_EXT_SRC = r"""
#include <cmath>
extern "C" void axpb(const void* const* in, const long long* sizes,
                     int n, void* out, long long n_out) {
  const float* x = static_cast<const float*>(in[0]);
  const float* y = static_cast<const float*>(in[1]);
  float* o = static_cast<float*>(out);
  for (long long i = 0; i < n_out; ++i) o[i] = 2.f * x[i] + std::sqrt(y[i]);
}
"""


def host_modules_phase() -> dict:
    """Phase 35 (see the module docstring)."""
    import os
    import tempfile
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import static, text
    from paddle_tpu_torch.utils import cpp_extension
    t0 = time.perf_counter()
    rng = np.random.default_rng(35)
    checks = {}
    # ViterbiDecoder: a CRF over 64 sequences of 256 steps, 48 tags
    pots = rng.standard_normal((64, 256, 48)).astype(np.float32)
    trans = rng.standard_normal((48, 48)).astype(np.float32)
    lens = rng.integers(1, 257, 64).astype(np.int64)
    out = {}
    for dev in ("cuda", "cpu"):
        dec = text.ViterbiDecoder(ptt.to_tensor(trans, place=dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores, paths = dec(ptt.to_tensor(pots, place=dev),
                            ptt.to_tensor(lens, place=dev))
        torch.cuda.synchronize()
        out[dev] = (scores._data.cpu(), paths._data.cpu(),
                    scores._data.device.type, time.perf_counter() - t)
    checks["ViterbiDecoder on CUDA tensors equals the CPU's (paths "
           "exactly, scores within 1e-5)"] = (
        out["cuda"][2] == "cuda" and torch.equal(out["cuda"][1],
                                                 out["cpu"][1])
        and torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                           atol=1e-5))
    # a static.Executor program and a static.nn.while_loop on the card
    x = rng.standard_normal((512, 512)).astype(np.float32)

    def prog(x):
        y = ptt.tanh(ptt.matmul(x, x))
        i, s = static.nn.while_loop(
            lambda i, s: i < 4, lambda i, s: (i + 1, s + y.sum()),
            [ptt.to_tensor(np.array(0), place=x.place),
             ptt.to_tensor(np.array(0.0, np.float32), place=x.place)])
        return y, s
    res = {dev: static.Executor().run(prog, feed={"x": ptt.to_tensor(
        x, place=dev)}) for dev in ("cuda", "cpu")}
    checks["a static.Executor program with a static.nn.while_loop runs on "
           "the card as on the CPU"] = (
        res["cuda"][0]._data.device.type == "cuda"
        and torch.allclose(res["cuda"][0]._data.cpu(), res["cpu"][0]._data,
                           rtol=1e-4, atol=1e-4)
        and abs(float(res["cuda"][1]._data) - float(res["cpu"][1]._data))
        <= 1e-3 * abs(float(res["cpu"][1]._data)))
    # save_inference_model / load_inference_model on the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_static_")
    ptt.set_device("gpu:0")
    mlp = ptt.nn.Sequential(ptt.nn.Linear(64, 128), ptt.nn.GELU(),
                            ptt.nn.Linear(128, 10))
    feed = rng.standard_normal((32, 64)).astype(np.float32)
    want = mlp(ptt.to_tensor(feed))._data
    prefix = os.path.join(tmp, "mlp")
    static.save_inference_model(prefix, [static.data("x", [None, 64])],
                                None, program=mlp)
    program, feeds, _fetch = static.load_inference_model(prefix)
    (got,) = static.Executor().run(program, feed={"x": feed})
    checks["save_inference_model / load_inference_model round-trip on "
           "the card"] = (feeds == ["x"] and got._data.device.type == "cuda"
                          and torch.allclose(got._data, want, rtol=1e-5,
                                             atol=1e-5))
    # a g++ cpp_extension op on CUDA and CPU tensors
    src = os.path.join(tmp, "axpb.cc")
    with open(src, "w") as f:
        f.write(CPP_EXT_SRC)
    t = time.perf_counter()
    mod = cpp_extension.load("chip_smoke_axpb", [src],
                             build_directory=os.path.join(tmp, "build"))
    build_s = time.perf_counter() - t
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.random((256, 256)).astype(np.float32)
    on_card = mod.axpb(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
    on_cpu = mod.axpb(torch.from_numpy(a), torch.from_numpy(b))
    checks["a g++ cpp_extension op gives the same result on CUDA and CPU "
           "tensors (the CUDA result back on the card)"] = (
        on_card._data.device.type == "cuda"
        and torch.equal(on_card._data.cpu(), on_cpu._data)
        and torch.allclose(on_cpu._data, torch.from_numpy(
            2 * a + np.sqrt(b)), rtol=1e-6, atol=1e-6))
    rec = dict(viterbi_s={d: out[d][3] for d in out}, cpp_build_s=build_s,
               seconds=time.perf_counter() - t0)
    log(f"[host-modules] 35: ViterbiDecoder 64 x 256 x 48 in "
        f"{out['cuda'][3] * 1e3:.1f} ms on the card, {out['cpu'][3] * 1e3:.1f}"
        f" on the CPU; the cpp_extension op built in {build_s:.2f} s; "
        f"{rec['seconds']:.1f} s")
    _check("[host-modules] 35", checks, rec)
    return rec


# ---------------------------------------------------------------------------
# phase 36: the serving fleet at full width (Router, DisaggRouter, the
# Autoscaler, replica processes)
# ---------------------------------------------------------------------------
# bench.py's fleet configurations (bench_router_serving, bench_disagg):
# gpt3_1p3b in bf16, 120 pages of 64 tokens a replica
FLEET_ENGINE_KW = dict(max_batch=8, block_size=64, num_blocks=120,
                       decode_chunk=16, prompt_quantum=128)
# 36b: bench_disagg's schedule (80 events over ~7 s; the default cohorts'
# prompts are short: 2 of the 80 span a 64-token page, so most handoffs
# take the re-admission rung)
DISAGG_TRAFFIC = dict(seed=7, base_rate=3.0, burst_rate=30.0, off_s=2.0,
                      on_s=1.5, max_body=768, max_out=64)
DISAGG_EVENTS = 80


def _fleet_gpt(device="cuda", seed=0):
    """gpt3_1p3b at full width in bf16, weights drawn from `seed`, on
    `device`: phase 36's model, and the model builder of 36c's replica
    processes (module-level, so the spawn context pickles it by
    reference)."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    return GPTForCausalLM(gpt3_1p3b(), device=device, dtype="bfloat16",
                          seed=seed)


def _b3_launches():
    """B3's launches by design in this process: called in a replica
    process over its RPC layer (module-level, pickled by reference)."""
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    return dict(rpa.ragged_paged_attention.design_launches)


def _router_traffic(vocab, seed=0):
    """bench_router_serving's traffic: 8 sessions x 4 turns, each session
    its own 512-token prefix, turns of 8-32 fresh tokens, the arrivals
    shuffled, drawn from `seed`. [(session, prompt)]."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, (512,)).astype(np.int32)
                for _ in range(8)]
    traffic = []
    for _t in range(4):
        for s in range(8):
            tail = rng.integers(0, vocab, (int(rng.integers(8, 33)),))
            traffic.append((f"s{s}", np.concatenate(
                [prefixes[s], tail]).astype(np.int32)))
    return [traffic[i] for i in rng.permutation(len(traffic))]


def _drive(router, traffic, n_new, tag):
    """Submit [(session, prompt)] to a router and step it to the end:
    ({index: result}, wall s)."""
    import torch
    for i, (sess, p) in enumerate(traffic):
        router.submit((tag, i), p, max_new_tokens=n_new, session_id=sess)
    done = {}
    t0 = time.perf_counter()
    while router.has_unfinished:
        for r in router.step():
            done[r.request_id[1]] = r
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def _engine_tokens(model, prompts, n_new):
    """One engine, never killed, on `prompts`: the oracle's tokens."""
    from paddle_tpu_torch.inference import LLMEngine
    eng = LLMEngine(model, device="cuda", **FLEET_ENGINE_KW)
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=n_new)
    done = {}
    while eng.has_unfinished:
        for r in eng.step():
            done[r.request_id] = r.output_ids
    del eng
    return [done[i] for i in range(len(prompts))]


def _exact(want, got):
    """How many requests' tokens equal the oracle's whole (the margin
    guard compares only each one's leading safe positions)."""
    return sum(np.array_equal(np.asarray(w), np.asarray(g))
               for w, g in zip(want, got))


def _reconciled(router):
    """Live replicas whose pools do not reconcile (a leaked page): free
    plus parked pages must be every block but the trash page."""
    return [h.name for h in router.replicas if h.engine is not None
            and h.engine.cache.available_blocks
            != h.engine.cache.allocator.num_blocks - 1]


def _counted_factory(model, per_replica):
    """An engine factory whose engines count, in `per_replica[name]`,
    the sm90 B3 launches of their own steps (measurement only)."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    f = rpa.ragged_paged_attention

    def factory(i):
        eng = LLMEngine(model, device="cuda", **FLEET_ENGINE_KW)
        step, name = eng.step, f"replica-{i}"

        def counted():
            before = f.design_launches["sm90"]
            try:
                return step()
            finally:
                per_replica[name] += f.design_launches["sm90"] - before
        eng.step = counted
        return eng
    return factory


def fleet_router_phase(model, traffic, want, lengths) -> dict:
    """36a: two in-process replicas behind a Router at
    bench_router_serving's config, affinity on and off (a pass over
    unrelated prompts of the same lengths, then the timed pass over the
    traffic, whose prefixes no pool holds yet), then a run whose
    `router.replica.step` fault kills replica 0 mid-run."""
    import collections
    import torch
    from paddle_tpu_torch.inference import ReplicaGone, Router
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.resilience import faults

    f = rpa.ragged_paged_attention
    n_new = 64
    rec, checks = {}, {}
    unrelated = _router_traffic(model.config.vocab_size, seed=1)
    for label, affinity in (("affinity", True), ("least_loaded", False)):
        per_replica = collections.Counter()
        router = Router(_counted_factory(model, per_replica), n_replicas=2,
                        affinity=affinity)
        # the first pass captures the decode graphs on prompts that
        # share no prefix with the traffic, so the timed pass is the
        # traffic's cold pass, where the policies' prefix hits part
        _drive(router, unrelated, n_new, "warm")
        hit0 = sum(h.engine.stats["prefix_cache_hit_tokens"]
                   for h in router.replicas)
        miss0 = sum(h.engine.stats["prefix_cache_miss_tokens"]
                    for h in router.replicas)
        per_replica.clear()
        plain0 = f.plain_calls
        cap0 = cuda_graph.captures["engine_decode"]
        done, wall = _drive(router, traffic, n_new, "timed")
        hit = sum(h.engine.stats["prefix_cache_hit_tokens"]
                  for h in router.replicas) - hit0
        miss = sum(h.engine.stats["prefix_cache_miss_tokens"]
                   for h in router.replicas) - miss0
        tokens = sum(len(r.output_ids) for r in done.values())
        got = [done[i].output_ids for i in range(len(traffic))]
        rec[label] = dict(tokens=tokens, wall_s=wall,
                          tokens_per_s=tokens / wall,
                          prefix_hit_tokens=hit, prefix_miss_tokens=miss,
                          prefix_hit_rate=hit / max(hit + miss, 1),
                          captures_timed=cuda_graph.captures[
                              "engine_decode"] - cap0,
                          b3_sm90_by_replica=dict(per_replica),
                          mismatched=_mismatched(want, got, lengths),
                          exact=_exact(want, got),
                          leaked=_reconciled(router),
                          plain_calls=f.plain_calls - plain0)
        checks[f"{label}: every request ok with 64 tokens"] = all(
            r.ok and len(r.output_ids) == n_new for r in done.values())
        checks[f"{label}: tokens == the single engine's (margin guard)"] = \
            not rec[label]["mismatched"]
        checks[f"{label}: each replica launched B3 sm90"] = \
            len(per_replica) == 2 and min(per_replica.values()) > 0
        checks[f"{label}: no pool block leaked"] = not rec[label]["leaked"]
        checks[f"{label}: B3's plain version never ran"] = \
            rec[label]["plain_calls"] == 0
        del router, done
        _fresh_card()
    checks["affinity's prefix-hit tokens exceed least-loaded's"] = \
        rec["affinity"]["prefix_hit_tokens"] > \
        rec["least_loaded"]["prefix_hit_tokens"]

    # the kill: replica 0's 6th step raises ReplicaGone (its process
    # "vanished"); its in-flight requests re-serve on replica 1
    faults.clear_all()
    seen = {"n": 0}

    def sixth(ctx):
        seen["n"] += 1
        return seen["n"] == 6
    faults.inject("router.replica.step", exc=ReplicaGone("phase 36a kill"),
                  times=1, match={"replica": "replica-0"}, when=sixth)
    per_replica = collections.Counter()
    router = Router(_counted_factory(model, per_replica), n_replicas=2)
    try:
        done, wall = _drive(router, traffic, n_new, "kill")
    finally:
        kills = faults.fired("router.replica.step")
        faults.clear_all()
    got = [done[i].output_ids for i in range(len(traffic))]
    rec["killed"] = dict(
        kills=kills, failovers=router.stats["failovers"],
        reroutes=router.stats["reroutes"], wall_s=wall,
        tokens_per_s=sum(len(r.output_ids) for r in done.values()) / wall,
        b3_sm90_by_replica=dict(per_replica),
        mismatched=_mismatched(want, got, lengths), exact=_exact(want, got),
        leaked=_reconciled(router),
        states=[(h.name, h.state) for h in router.replicas])
    checks["killed: failovers == injected kills (1)"] = \
        kills == 1 and router.stats["failovers"] == 1
    checks["killed: every request ok, tokens == the single engine's"] = \
        all(r.ok for r in done.values()) and not rec["killed"]["mismatched"]
    checks["killed: survivors leak no pool block"] = \
        not rec["killed"]["leaked"]
    del router, done
    _fresh_card()
    rec["b3_sm90_launches"] = sum(
        sum(rec[k]["b3_sm90_by_replica"].values())
        for k in ("affinity", "least_loaded", "killed"))
    torch.cuda.synchronize()
    log(f"[fleet] 36a: tokens compared per request (margin guard) "
        f"{lengths} of {n_new} (whole requests equal: affinity "
        f"{rec['affinity']['exact']}, least-loaded "
        f"{rec['least_loaded']['exact']}, killed {rec['killed']['exact']} "
        f"of {len(traffic)}); timed (cold) pass: affinity "
        f"{rec['affinity']['tokens_per_s']:.1f} tokens/s, prefix hit rate "
        f"{rec['affinity']['prefix_hit_rate']:.4f} "
        f"({rec['affinity']['prefix_hit_tokens']} tokens), captures "
        f"{rec['affinity']['captures_timed']}; least-loaded "
        f"{rec['least_loaded']['tokens_per_s']:.1f} tokens/s, hit rate "
        f"{rec['least_loaded']['prefix_hit_rate']:.4f} "
        f"({rec['least_loaded']['prefix_hit_tokens']} tokens), captures "
        f"{rec['least_loaded']['captures_timed']}; killed run "
        f"{rec['killed']['tokens_per_s']:.1f} tokens/s, failovers "
        f"{rec['killed']['failovers']}, reroutes {rec['killed']['reroutes']}; "
        f"B3 sm90 launches by replica {rec['affinity']['b3_sm90_by_replica']} "
        f"/ {rec['least_loaded']['b3_sm90_by_replica']} / "
        f"{rec['killed']['b3_sm90_by_replica']}")
    _check("[fleet] 36a", checks, rec)
    return rec


def _p50_ttft(om, before):
    """Median TTFT (s) of the engine's histogram since `before` (its
    bucket counts then), and the counts now."""
    m = om.registry().get("paddle_tpu_request_ttft_seconds")
    counts = [0] * (len(m.buckets) + 1)
    for _key, child in m._series():
        counts = [a + b for a, b in zip(counts, child._buckets)]
    delta = [a - b for a, b in zip(counts, before)] if before else counts
    return om.quantile_from_buckets(m.buckets, delta, 0.5), counts


def fleet_disagg_phase(model) -> dict:
    """36b: a DisaggRouter over 1 prefill and 2 decode in-process replicas
    on bench_disagg's schedule; a fixed greedy prompt set on the migrated
    rung and, with a `disagg.migrate` fault, on the re-admission rung,
    against a role-less engine; then an Autoscaler with a RouterActuator
    over a FleetSLOMonitor reading the engine's real TTFT series."""
    import collections
    import os
    import tempfile
    import torch
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.inference import (Autoscaler, DisaggRouter,
                                            LLMEngine, Router,
                                            RouterActuator, TrafficModel,
                                            run_traffic)
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.observability import slo, slo_fleet
    from paddle_tpu_torch.resilience import faults

    f = rpa.ragged_paged_attention
    # the fixed greedy prompt set served below (fresh to every pool) and
    # the oracle's tokens for it, before the fleet runs: the oracle's
    # launches are none of the fleet's
    rng = np.random.default_rng(36)
    fixed = [rng.integers(0, model.config.vocab_size, (int(n),)).astype(
        np.int32) for n in rng.integers(200, 700, 9)]
    n_new = 32
    want = _engine_tokens(model, fixed, n_new)
    lengths, _margins = _guard_lengths(model, fixed, want)
    torch.cuda.synchronize()

    obs.disable()
    obs.reset()
    obs.enable()
    shipped = collections.Counter()     # pages reaching a replica's import
    imported = collections.Counter()    # pages it registered
    pool_waves = collections.Counter()  # B3 prefix-resume waves, by replica
    per_replica = collections.Counter()     # B3 sm90 launches, by replica

    def factory(i):
        # measurement only: the B3 sm90 launches of each replica's own
        # steps (as `_counted_factory`), the pages each migration chunk
        # carries to its target, and the prefix-resume (with_pool)
        # waves each replica launches
        eng = _counted_factory(model, per_replica)(i)
        name = f"replica-{i}"
        imp, wave = eng.import_kv_pages, eng._ragged_wave

        def import_(payload):
            shipped[name] += len(payload["pages"])
            n = imp(payload)
            imported[name] += n
            return n

        def ragged(*a, **k):
            with_pool = k.get("with_pool", a[7] if len(a) > 7 else None)
            pool_waves[name] += bool(with_pool)
            return wave(*a, **k)
        eng.import_kv_pages, eng._ragged_wave = import_, ragged
        return eng

    router = DisaggRouter(factory, n_prefill=1, n_decode=2)
    roles = {h.name: h.role for h in router.replicas}
    c = router.replicas.handles[0].engine.cache
    # one page of the pool: layers x (k, v) x tokens x kv heads x head
    # dim x bytes (gpt3_1p3b in bf16: 24 x 2 x 64 x 16 x 128 x 2 = 12 MiB)
    page_bytes = 2 * c.num_layers * c.block_size * c.kv_heads * \
        c.head_dim * c.key_caches[0].element_size()
    decode = [n for n, r in roles.items() if r == "decode"]
    handoffs = []
    handoff = router._handoff

    def timed_handoff(req, src):        # measurement only
        b0 = router.stats["migrated_bytes"]
        t0 = time.perf_counter()
        handoff(req, src)
        torch.cuda.synchronize()
        handoffs.append((time.perf_counter() - t0,
                         router.stats["migrated_bytes"] - b0))
    router._handoff = timed_handoff
    evs = list(TrafficModel(**DISAGG_TRAFFIC).events(80))[:DISAGG_EVENTS]
    launches0 = f.design_launches["sm90"]
    report = run_traffic(router, evs, max_prompt=768)
    torch.cuda.synchronize()
    st = dict(router.stats)
    rec = dict(events=len(evs), traffic=dict(
        submitted=report["submitted"], ok=report["ok"],
        shed=report["shed"], failed=report["failed"],
        wall_s=report["wall_s"], req_per_s=report["req_per_s"]),
        traffic_stats=st,
        b3_sm90_launches_traffic=sum(per_replica.values()))
    checks = {
        f"traffic: {len(evs)} of 80 events served, none failed":
            report["ok"] + report["shed"] == len(evs)
            and report["failed"] == 0,
    }

    # the fixed set: six migrated, then three more on the re-admission
    # rung (`disagg.migrate` raising)
    hits0 = {n: h.engine.stats["prefix_cache_hit_tokens"]
             for h in router.replicas for n in [h.name] if n in decode}
    imp0 = dict(imported)
    waves0 = {n: pool_waves[n] for n in decode}
    st0 = dict(router.stats)
    done, _wall = _drive(router, [(None, p) for p in fixed[:6]], n_new, "mig")
    hits = sum(h.engine.stats["prefix_cache_hit_tokens"] - hits0[h.name]
               for h in router.replicas if h.name in decode)
    pages = sum(imported[n] - imp0.get(n, 0) for n in decode)
    migrated = router.stats["handoff_migrated"] - st0["handoff_migrated"]
    st1 = dict(router.stats)
    faults.inject("disagg.migrate", exc=RuntimeError("phase 36b fault"))
    try:
        done2, _w = _drive(router, [(None, p) for p in fixed[6:]], n_new,
                           "fallback")
    finally:
        faults.clear_all()
    fallback = router.stats["handoff_fallback"] - st1["handoff_fallback"]
    st = dict(router.stats)
    mig = [(dt, b) for dt, b in handoffs if b]
    rec.update(
        stats=st, page_bytes=page_bytes,
        pages_shipped=sum(shipped.values()), pages_imported=dict(imported),
        handoffs_timed=len(handoffs),
        handoff_s_mean=sum(dt for dt, _b in handoffs) / max(len(handoffs), 1),
        migrated_handoff_s=[dt for dt, _b in mig],
        migrated_handoff_mib=[b / 2 ** 20 for _dt, b in mig],
        migrated_mib_per_s=(sum(b for _dt, b in mig) / 2 ** 20
                            / sum(dt for dt, _b in mig) if mig else None))
    checks.update({
        "handoffs{path=migrated} > 0": st["handoff_migrated"] > 0,
        f"migrated bytes == pages shipped x {page_bytes / 2 ** 20:g} MiB":
            st["migrated_bytes"] == sum(shipped.values()) * page_bytes,
    })
    got = [done[i].output_ids for i in range(6)] + \
        [done2[i].output_ids for i in range(3)]
    rec.update(fixed=dict(
        guarded=lengths, n_new=n_new, migrated=migrated, fallback=fallback,
        decode_hit_tokens=hits, decode_pages_imported=pages,
        decode_pool_waves={n: pool_waves[n] - waves0[n] for n in decode},
        mismatched=_mismatched(want, got, lengths), exact=_exact(want, got)))
    checks.update({
        "fixed set: 6 handoffs on the migrated rung": migrated == 6,
        "fixed set: decode replicas' prefix-resume waves read the imported "
        "pages (hits > 0, <= 64 x pages imported)":
            0 < hits <= 64 * pages
            and sum(rec["fixed"]["decode_pool_waves"].values()) > 0,
        "disagg.migrate fault: 3 handoffs on the re-admission rung":
            fallback == 3,
        "fixed set: tokens == a role-less engine's (margin guard), both "
        "rungs": not rec["fixed"]["mismatched"],
        "no pool block leaked": not _reconciled(router),
    })
    # the fleet's launches, counted in its replicas' own steps; every
    # sm90 launch of this process since the traffic began was one
    rec["b3_sm90_by_replica"] = dict(per_replica)
    rec["b3_sm90_launches"] = sum(per_replica.values())
    rec["b3_sm90_launches_process"] = f.design_launches["sm90"] - launches0
    checks["B3 sm90 launches: each replica launched, and the process "
           "launched no other"] = (
        len(per_replica) == 3 and min(per_replica.values()) > 0
        and rec["b3_sm90_launches"] == rec["b3_sm90_launches_process"])
    series = obs.snapshot()
    rec["disagg_series"] = {
        "handoffs": series["paddle_tpu_disagg_handoffs_total"]["series"],
        "migrated_bytes": series[
            "paddle_tpu_disagg_migrated_bytes_total"]["series"],
        "handoff_seconds_count": series[
            "paddle_tpu_disagg_handoff_seconds"]["series"][()]["count"],
        "pool": series["paddle_tpu_disagg_pool_replicas"]["series"]}
    rec["disagg_series"] = {k: {str(kk): vv for kk, vv in v.items()}
                            if isinstance(v, dict) else v
                            for k, v in rec["disagg_series"].items()}
    del router, done, done2
    _fresh_card()

    # the Autoscaler: one replica, a TTFT objective below the TTFT a
    # measured 8-prompt burst gets there; the next burst breaches, the
    # fleet grows to 2; idle scans are calm and retire one
    def burst(seed):
        r = np.random.default_rng(seed)
        return [(None, r.integers(0, model.config.vocab_size, (int(n),))
                 .astype(np.int32)) for n in r.integers(300, 500, 8)]
    fdir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    flight.arm(fdir, retention=64)
    try:
        router = Router(lambda _i: LLMEngine(model, device="cuda",
                                             **FLEET_ENGINE_KW),
                        n_replicas=1)
        _drive(router, burst(1), 16, "b1")          # warm-up
        _p, counts = _p50_ttft(om, None)
        _drive(router, burst(2), 16, "b2")          # the measured burst
        p50, counts = _p50_ttft(om, counts)
        rule = slo.SLO("fleet_ttft", "paddle_tpu_request_ttft_seconds",
                       threshold_s=0.5 * p50, objective=0.9)
        mon = slo_fleet.FleetSLOMonitor(registry=om.registry(), rules=[rule])
        mon.evaluate()              # the window starts after the bursts
        asc = Autoscaler(RouterActuator(router), mon, min_replicas=1,
                         max_replicas=2, grow_after=1, retire_after=2,
                         cooldown_scans=0)
        _drive(router, burst(3), 16, "b3")          # breaches
        scans = [asc.scan()]
        grown = len(router.replicas)
        _drive(router, burst(4), 16, "b4")          # on 2 replicas
        mon.evaluate()              # that window is read, not acted on
        scans += [asc.scan(), asc.scan()]           # idle: calm, calm
        decisions = [(d["action"], d["replicas_before"],
                      d["replicas_after"]) for d in asc.decisions]
        dec_bundles = [b for b in flight.bundles(fdir)
                       if "autoscale_decision" in os.path.basename(b)]
        rec["autoscaler"] = dict(
            ttft_p50_burst_s=p50, threshold_s=rule.threshold_s,
            decisions=decisions, replicas_after_grow=grown,
            replicas_end=len(router.replicas),
            decision_bundles=len(dec_bundles),
            scans=[None if s is None else s["action"] for s in scans])
        checks.update({
            "autoscaler: grew 1 -> 2 on the burst, retired one when calm":
                decisions == [("grow", 1, 2), ("retire", 2, 1)]
                and grown == 2 and len(router.replicas) == 1,
            "autoscaler: one flight bundle per decision":
                len(dec_bundles) == len(decisions) == 2,
        })
        del router
    finally:
        flight.disarm()
        obs.disable()
        obs.reset()
    _fresh_card()
    ts = rec["traffic_stats"]
    log(f"[fleet] 36b: {len(evs)} of 80 events, handoffs {ts['handoffs']} "
        f"(migrated {ts['handoff_migrated']}, readmitted "
        f"{ts['handoff_readmitted']}, fallback {ts['handoff_fallback']}); "
        f"with the fixed sets {st['handoffs']} (migrated "
        f"{st['handoff_migrated']}, fallback {st['handoff_fallback']}), "
        f"{rec['pages_shipped']} pages shipped = "
        f"{st['migrated_bytes'] / 2 ** 20:.0f} MiB; a handoff "
        f"{rec['handoff_s_mean']:.4f} s mean, migrated ones "
        f"{[round(x, 4) for x in rec['migrated_handoff_s']]} s for "
        f"{[round(x) for x in rec['migrated_handoff_mib']]} MiB: "
        f"{rec['migrated_mib_per_s']} MiB/s; fixed set tokens "
        f"compared per request {lengths} of {n_new} (whole requests "
        f"equal {rec['fixed']['exact']} of 9); autoscaler "
        f"{rec['autoscaler']}")
    _check("[fleet] 36b", checks, rec)
    return rec


def fleet_process_phase(traffic, want, lengths) -> dict:
    """36c: two replica processes on the card (process_engine_factory,
    one shared exec-cache store, a FleetAggregator served in this
    process), 8 requests of 36a's traffic through a Router over them,
    replica 0's process SIGKILLed mid-decode, its replacement spawned
    warm from the store."""
    import concurrent.futures as cf
    import os
    import shutil
    import signal
    import tempfile
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.inference import ReplicaGone, Router
    from paddle_tpu_torch.inference.replica_proc import \
        process_engine_factory
    from paddle_tpu_torch.observability import fleet, tracing

    store = tempfile.mkdtemp(prefix="chip_smoke_exec_cache_")
    obs.disable()
    obs.reset()
    obs.enable()            # the workers trace too (their parent does)
    agg = fleet.serve_aggregator(stale_after_s=600.0)
    factory = process_engine_factory(
        _fleet_gpt, dict(seed=0), FLEET_ENGINE_KW, exec_cache_dir=store,
        aggregator_endpoint=agg.endpoint, device="cuda",
        start_timeout_s=300.0, step_timeout_s=300.0)
    spawn_s = {}

    def timed(i):
        t0 = time.perf_counter()
        c = factory(i)
        spawn_s.setdefault(i, []).append(time.perf_counter() - t0)
        return c
    clients = []
    try:
        with cf.ThreadPoolExecutor(2) as ex:     # both cold, at once
            ready = dict(zip((0, 1), ex.map(timed, (0, 1))))
        clients += ready.values()
        cold = {i: spawn_s[i][0] for i in (0, 1)}

        def router_factory(i):
            c = ready.pop(i, None)
            if c is None:
                c = timed(i)        # the replacement
                clients.append(c)
            return c
        router = Router(router_factory, n_replicas=2, cooldown_s=0.0)
        first = router.replicas.handles[0].engine
        deadline = time.monotonic() + 60
        while not {"engine-0", "engine-1"} <= set(agg.processes()):
            if time.monotonic() > deadline:
                raise RuntimeError("no bundle from the replica processes")
            time.sleep(0.05)
        eight = traffic[:8]
        for i, (sess, p) in enumerate(eight):
            router.submit(("proc", i), p, max_new_tokens=64,
                          session_id=sess)
        done, steps, killed = {}, 0, None
        t0 = time.perf_counter()
        while router.has_unfinished:
            for r in router.step():
                done[r.request_id[1]] = r
            steps += 1
            if steps == 2 and killed is None:       # mid-decode
                killed = first.pid
                os.kill(killed, signal.SIGKILL)
                first._proc.join(timeout=30)
        wall = time.perf_counter() - t0
        second = router.replicas.handles[0].engine
        # four more of 36a's requests: the replacement serves some
        for i, (sess, p) in enumerate(traffic[8:12], 8):
            router.submit(("proc", i), p, max_new_tokens=64,
                          session_id=sess)
        while router.has_unfinished:
            for r in router.step():
                done[r.request_id[1]] = r
        outcomes = second.compile_outcomes()
        runs = second.compiler_runs()
        b3 = {h.name: h.engine._call(_b3_launches)
              for h in router.replicas}
        got = [done[i].output_ids for i in range(12)]
        mism = _mismatched(want[:12], got, lengths[:12])
        for c in clients:
            c.shutdown()                # their agents ship a farewell
        procs = agg.processes()
        restarts = agg.registry.snapshot().get(
            "paddle_tpu_fleet_process_restarts_total", {}).get(
                "series", {})
        evs = tracing.events()
        reroutes = [e["trace_id"] for e in evs
                    if e["name"] == "router.reroute"]
        trees = {}
        for tid in reroutes:
            mine = [e for e in evs if e.get("trace_id") == tid]
            spans = {e["span_id"] for e in mine}
            roots = [e for e in mine if e["name"] == "request"]
            trees[tid] = dict(
                events=len(mine), pids=sorted({e["pid"] for e in mine}),
                connected=len(roots) == 1 and all(
                    e.get("parent_id") in spans
                    for e in mine if e is not roots[0]))
        # the kernel libraries' outcomes (the graphs, captured again in
        # every process, report "engine_decode" compiles beside them)
        lib_names = ("paged_block_allocator", "ragged_paged_attention_sm90")
        libs = {k: v for k, v in outcomes.items() if k[0] in lib_names}
        rec = dict(spawn_to_ready_cold_s=cold,
                   spawn_to_ready_warm_s=spawn_s[0][1:],
                   wall_s=wall, killed_pid=killed,
                   failovers=router.stats["failovers"],
                   reroutes=router.stats["reroutes"],
                   replacement_compile_outcomes={
                       f"{fam}/{o}": v for (fam, o), v in outcomes.items()},
                   replacement_compiler_runs=runs,
                   b3_launches_by_replica=b3,
                   b3_sm90_launches=sum(d["sm90"] for d in b3.values()),
                   mismatched=mism, exact=_exact(want[:12], got),
                   aggregator={p: dict(role=s["role"], bundles=s["bundles"],
                                       pid=s["pid"])
                               for p, s in procs.items()},
                   restarts={str(k): v for k, v in restarts.items()},
                   rerouted_traces=list(trees.values()))
        checks = {
            "12 requests ok, tokens == 36a's single engine's (margin "
            "guard)": len(done) == 12
                and all(r.ok for r in done.values()) and not mism,
            "SIGKILL: ReplicaGone failed over once":
                router.stats["failovers"] == 1 and second.pid != killed,
            "replacement: every kernel library a disk_hit, no compile":
                sorted(libs) == [(n, "disk_hit") for n in lib_names]
                and not [f for f, o in outcomes
                         if o == "compile" and f != "engine_decode"],
            "replacement: no nvcc (no compiler) run": not runs,
            "the survivor and the replacement launched B3 sm90":
                all(d["sm90"] > 0 for d in b3.values()),
            "aggregator: bundles from every process, role engine":
                {"engine-0", "engine-1"} <= set(procs) and all(
                    s["role"] == "engine" and s["bundles"] > 0
                    for s in procs.values()),
            "a failed-over request's trace is one connected tree, across "
            "this process and a surviving replica process":
                bool(trees) and all(
                    t["connected"] and os.getpid() in t["pids"]
                    and set(t["pids"]) - {os.getpid(), killed}
                    for t in trees.values()),
        }
        del router
    finally:
        for c in clients:
            try:
                c.shutdown(timeout_s=10.0)
            except Exception as e:      # the check below reports it
                log(f"[fleet] 36c: shutdown of {c.endpoint}: {e!r}")
        agg.close()
        obs.disable()
        obs.reset()
        shutil.rmtree(store, ignore_errors=True)
    alive = [c.pid for c in clients if c._proc.is_alive()]
    checks["every replica process stopped"] = not alive
    _fresh_card()
    log(f"[fleet] 36c: spawn-to-ready cold {cold} s, warm "
        f"{rec['spawn_to_ready_warm_s']} s; killed pid {killed} at step 2, "
        f"failovers {rec['failovers']}, reroutes {rec['reroutes']}; "
        f"replacement outcomes {rec['replacement_compile_outcomes']}, "
        f"compiler runs {runs}; whole requests equal {rec['exact']} of 12; "
        f"B3 by replica {b3}; aggregator "
        f"{rec['aggregator']}; rerouted traces {rec['rerouted_traces']}")
    _check("[fleet] 36c", checks, rec)
    return rec


def fleet_phase() -> dict:
    """Phase 36: the serving fleet on gpt3_1p3b at full width: 36a the
    Router, 36b the DisaggRouter and the Autoscaler, 36c replica
    processes. The single engine's tokens on 36a's traffic (and their
    margin-guard lengths) are the oracle of 36a and 36c."""
    import torch

    t0 = time.perf_counter()
    model = _fleet_gpt()
    traffic = _router_traffic(model.config.vocab_size)
    prompts = [p for _s, p in traffic]
    want = _engine_tokens(model, prompts, 64)
    lengths, margins = _guard_lengths(model, prompts, want)
    torch.cuda.synchronize()
    rec = dict(oracle_s=time.perf_counter() - t0, guarded=lengths,
               margins=margins)
    rec["router"] = timed("36a", fleet_router_phase, model, traffic, want,
                          lengths)
    rec["disagg"] = timed("36b", fleet_disagg_phase, model)
    del model
    _fresh_card()
    rec["process"] = timed("36c", fleet_process_phase, traffic, want,
                           lengths)
    rec["b3_sm90_launches"] = dict(
        router=rec["router"]["b3_sm90_launches"],
        disagg=rec["disagg"]["b3_sm90_launches"],
        process=rec["process"]["b3_sm90_launches"])
    return rec


# seconds each phase took, by phase number (printed with the results)
# ---------------------------------------------------------------------------
# phase 37: the models on Tensors (Queue C faults 1-4)
# ---------------------------------------------------------------------------
MODELS_IO_BATCH, MODELS_IO_SEQ, MODELS_IO_NEW = 2, 128, 32


def models_io_phase() -> dict:
    """gpt2_small at full width (12 x 768, f32): a Tensor in gives a
    Tensor out, bit-equal to the torch-level call; model.generate on a
    Tensor gives models.generation.generate's tokens on torch tensors;
    save(state_dict) / set_state_dict(load) gives bit-equal logits;
    AdamW.minimize is bit-equal to backward, step, clear_grad; LLaMA at
    LLaMA-2-7B's widths (2 layers, bf16) and BERT-base (2 layers) take a
    Tensor, bit-equal to their torch-level calls."""
    import os
    import tempfile

    import torch
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         generate, gpt2_small)
    from paddle_tpu_torch.models import bert, llama
    from paddle_tpu_torch.optimizer import AdamW
    rng = np.random.default_rng(37)
    b, s = MODELS_IO_BATCH, MODELS_IO_SEQ
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ids_t = torch.as_tensor(ids, device="cuda")
    saved_place = P.get_device()
    P.set_device("gpu:0")
    try:
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        model.eval()
        with torch.no_grad():
            want = model(ids_t)
            got = model(P.to_tensor(ids))
        logits_equal = isinstance(got, P.Tensor) and torch.equal(
            got._data, want)
        prompt = ids[:, :64]
        t0 = time.perf_counter()
        gen = model.generate(P.to_tensor(prompt),
                             max_new_tokens=MODELS_IO_NEW)
        gen_s = time.perf_counter() - t0
        ref = generate(model, torch.as_tensor(prompt, device="cuda"),
                       max_new_tokens=MODELS_IO_NEW)
        tokens_equal = isinstance(gen, P.Tensor) and torch.equal(
            gen._data, ref)
        with tempfile.TemporaryDirectory(dir=_build_dir()) as d:
            path = os.path.join(d, "gpt2_small.pdparams")
            t0 = time.perf_counter()
            P.save(model.state_dict(), path)
            fresh = GPTForCausalLM(cfg, device="cuda", seed=5)
            fresh.eval()
            missing, unexpected = fresh.set_state_dict(P.load(path))
            round_trip_s = time.perf_counter() - t0
            file_mb = os.path.getsize(path) / 2 ** 20
        with torch.no_grad():
            round_trip_equal = torch.equal(fresh(ids_t), want) \
                and missing == [] and unexpected == []
        del fresh, got, want
        # one AdamW step by minimize against backward / step / clear_grad
        params = []
        for how in ("minimize", "steps"):
            m = GPTForCausalLM(cfg, device="cuda", seed=1)
            m.train()
            opt = AdamW(learning_rate=1e-4, parameters=m.parameters(),
                        weight_decay=0.01)
            x = P.to_tensor(ids)
            loss = GPTPretrainingCriterion()(m(x)[:, :-1], x[:, 1:])
            if how == "minimize":
                out = opt.minimize(loss)
            else:
                loss.backward()
                opt.step()
                opt.clear_grad()
            params.append([p.detach().clone() for p in _torch_params(m)])
            cleared = all(p.grad is None for p in _torch_params(m))
            del m, opt, loss
        minimize_equal = out == (None, None) and cleared and all(
            torch.equal(a, c) for a, c in zip(*params))
        del params, model
        _fresh_card()
        # LLaMA at LLaMA-2-7B's widths and BERT-base, cut in depth
        lcfg = llama.llama2_7b(num_layers=2)
        lm = llama.LlamaForCausalLM(lcfg, device="cuda", dtype="bfloat16",
                                    seed=0)
        lm.eval()
        lids = rng.integers(0, lcfg.vocab_size, (b, s)).astype(np.int32)
        with torch.no_grad():
            lt = lm(P.to_tensor(lids))
            llama_equal = isinstance(lt, P.Tensor) and torch.equal(
                lt._data, lm(torch.as_tensor(lids, device="cuda")))
        del lm, lt
        bcfg = bert.bert_base(num_layers=2, hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0)
        bm = bert.BertForMaskedLM(bcfg, device="cuda", seed=0)
        bm.eval()
        bids = rng.integers(0, bcfg.vocab_size, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        with torch.no_grad():
            bt = bm(P.to_tensor(bids), attention_mask=P.to_tensor(mask))
            bert_equal = isinstance(bt, P.Tensor) and torch.equal(
                bt._data, bm(torch.as_tensor(bids, device="cuda"),
                             attention_mask=torch.as_tensor(
                                 mask, device="cuda")))
        del bm, bt
        layers = all(issubclass(c, P.nn.Layer) for c in (
            GPTForCausalLM, llama.LlamaForCausalLM, bert.BertForMaskedLM))
    finally:
        P.set_device(saved_place)
    _fresh_card()
    rec = dict(batch=b, seq=s, new_tokens=MODELS_IO_NEW,
               generate_s=gen_s, round_trip_s=round_trip_s,
               file_mb=file_mb)
    _check("[models-io]", {
        "gpt2_small(Tensor) is a Tensor bit-equal to the torch-level "
        "call": logits_equal,
        "model.generate(Tensor) gives generate's tokens on torch "
        "tensors": tokens_equal,
        "set_state_dict(load(save(state_dict))) gives bit-equal logits":
            round_trip_equal,
        "AdamW.minimize is bit-equal to backward, step, clear_grad":
            minimize_equal,
        "LLaMA (7B widths, 2 layers, bf16) takes a Tensor": llama_equal,
        "BERT-base (2 layers) takes a Tensor": bert_equal,
        "the models are Layers": layers}, rec)
    log(f"[models-io] gpt2_small b{b} s{s}: generate {MODELS_IO_NEW} "
        f"tokens from a Tensor in {gen_s:.2f} s; save / set_state_dict "
        f"round trip {round_trip_s:.2f} s ({file_mb:.1f} MiB)")
    return rec


def _build_dir():
    from paddle_tpu_torch.utils.build import build_dir
    return str(build_dir().parent)


# ---------------------------------------------------------------------------
# phase 38: the block-config cache of B1, B2 and B3
# ---------------------------------------------------------------------------
# timings made while a stream was capturing, over the whole run (the
# cache never times inside a capture: _count_capture_timings wraps its
# timer at the start of main)
CAPTURE_TIMINGS = {"timed": 0, "capturing": 0}


def _count_capture_timings():
    import torch
    from paddle_tpu_torch.kernels import autotune
    timer = autotune._time_call

    def counted(fn, iters=20):
        CAPTURE_TIMINGS["timed"] += 1
        CAPTURE_TIMINGS["capturing"] += int(
            torch.cuda.is_current_stream_capturing())
        return timer(fn, iters)

    autotune._time_call = counted


AUTOTUNE_CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch.kernels import autotune
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
timings = []
real = autotune._time_call
autotune._time_call = lambda *a, **k: timings.append(1) or real(*a, **k)
libs = cs._autotune_calls()
print(json.dumps(dict(libs=libs, sweeps=autotune.drain_sweeps(),
                      timings=len(timings))))
"""


def _autotune_calls():
    """One call each of B1 and B2 at gpt2_small's training shape and of
    B3 at gpt3_1p3b's fresh wave (phase 2's first case); returns the
    build flags of the library each launched, and the calls' outputs
    and inputs as `_AUTOTUNE_LAST`."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    name, spec = FLASH_CASES[0]
    causal = spec[6]
    qs, k, v, do, segs = _flash_inputs(spec, torch.bfloat16, seed=0)
    o, lse = fa._fwd_cuda(qs, k, v, causal, segs)
    grads = fa._bwd_cuda(qs, k, v, o, lse, do, causal, segs,
                         spec[5] ** -0.5)
    rname, kw = _ragged_specs(np.random.default_rng(0))[0]
    x, meta = _case(rname, np.random.default_rng(38), **kw)
    args = [x[key] for key in ("q", "k_new", "v_new", "kpool", "vpool",
                               "rows", "pos", "kv_start", "off")]
    common = dict(block_size=meta["bs"], scale=1.0 / np.sqrt(meta["D"]),
                  kdq=x["kdq"], vdq=x["vdq"], with_pool=meta["with_pool"])
    out = rpa._ragged_cuda(*args, **common)
    torch.cuda.synchronize()
    _AUTOTUNE_LAST.update(flash=(name, spec, qs, k, v, do, segs, o, lse,
                                 grads), ragged=(args, common, out, meta))
    fkey = fa._tune_key("fwd", qs, k, causal, segs is not None)
    bkey = fa._tune_key("bwd", qs, k, causal, segs is not None)
    T, H, D = x["q"].shape
    rkey = ("ragged", T, x["kpool"].shape[0] if meta["with_pool"] else 0,
            H, x["k_new"].shape[1], D, "bfloat16", 0, meta["bs"])
    return {kind: list(table.chosen_flags(key))
            for kind, table, key in (
                ("B1", fa._FWD_VARIANTS, fkey),
                ("B2", fa._BWD_VARIANTS, bkey),
                ("B3", rpa._RPA_VARIANTS, rkey))}


_AUTOTUNE_LAST = {}


def autotune_phase(train) -> dict:
    """From an empty cache under build/: tune B1 and B2 at gpt2_small's
    training shape and B3 at gpt3_1p3b's fresh wave, print every
    candidate's time, the winners, the bandwidth probes and whether each
    was persisted; hold each winner to the plain version at phases 3's
    and 2's tolerances; a fresh process reads the winners from disk with
    no timing; the kill switch restores the defaults; then phase 6's run
    (its checks) with the winners, its step by replay beside phase 6's.
    `train`: phase 6's record."""
    import os
    import shutil
    import torch
    from paddle_tpu_torch.kernels import autotune
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    cache = os.path.join(_build_dir(), "autotune_phase38")
    shutil.rmtree(cache, ignore_errors=True)
    saved = os.environ.get("PADDLE_TPU_CACHE_DIR")
    os.environ["PADDLE_TPU_CACHE_DIR"] = cache
    try:
        autotune.clear()
        autotune.drain_sweeps()
        probes = [autotune.measure_effective_bw() for _ in range(20)]
        t0 = time.perf_counter()
        libs = _autotune_calls()
        sweep_s = time.perf_counter() - t0
        sweeps = autotune.drain_sweeps()
        # each winner against the plain version
        name, spec, qs, k, v, do, segs, o, lse, grads = \
            _AUTOTUNE_LAST["flash"]
        causal, sc = spec[6], spec[5] ** -0.5
        wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
        wg = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs,
                          path="torch")
        flash_err, _norm, _planted = _check_flash(
            name, "bf16", (o, lse, *grads), (wo, wlse, *wg))
        del wo, wlse, wg
        args, common, out, meta = _AUTOTUNE_LAST["ragged"]
        low = (torch.bfloat16, torch.float16)
        f32 = [a.float() if a.dtype in low else a for a in args]
        want = rpa.ragged_paged_attention(*f32, path="torch", **common)
        plain = rpa.ragged_paged_attention(*args, path="torch", **common)
        gap = float((plain - want).abs().max())
        ragged_tol = max(KERNEL_ATOL, 2 * gap)
        ragged_err = float((out - want).abs().max())
        _AUTOTUNE_LAST.clear()
        del want, plain, f32, args, out
        persisted = [sw["persisted"] for sw in sweeps]
        files = [f for f in os.listdir(cache) if f.endswith(".json")] \
            if os.path.isdir(cache) else []
        on_disk = json.load(open(os.path.join(cache, files[0]))) \
            if files else {}
        # a fresh process: the winners from disk, no timing
        env = dict(os.environ, PADDLE_TPU_CACHE_DIR=cache)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", AUTOTUNE_CHILD], capture_output=True,
            text=True, timeout=600, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise RuntimeError(f"autotune child failed: {child.stderr}")
        fresh = json.loads(child.stdout.strip().splitlines()[-1])
        # the kill switch over the cached winners
        os.environ["PADDLE_TPU_PALLAS_AUTOTUNE"] = "0"
        try:
            killed = {kind: table.select(("kill-switch",), d, None)
                      is table.library(d, table.defaults(d))
                      for kind, table, d in (
                          ("B1", fa._FWD_VARIANTS, 64),
                          ("B2", fa._BWD_VARIANTS, 64),
                          ("B3", rpa._RPA_VARIANTS, 128))}
        finally:
            del os.environ["PADDLE_TPU_PALLAS_AUTOTUNE"]
        # phase 6's run with the winners (its checks raise on a fault)
        _fresh_card()
        tuned = train_phase()
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_CACHE_DIR", None)
        else:
            os.environ["PADDLE_TPU_CACHE_DIR"] = saved
    window = autotune._validated_bw_window()
    good = [p for p in probes if p is not None]
    rec = dict(sweeps=sweeps, winners_flags=libs, sweep_s=sweep_s,
               bw_probes=probes, bw_min=min(good), bw_median=float(
                   np.median(good)), bw_max=max(good),
               bw_window=window, flash_max_abs_err=flash_err,
               ragged_max_abs_err=ragged_err, ragged_tol=ragged_tol,
               on_disk=on_disk, fresh_process=fresh, fresh_process_s=child_s,
               kill_switch_defaults=killed,
               capture_timings=dict(CAPTURE_TIMINGS),
               train_step_ms_replay=tuned["step_ms_replay"],
               train_step_ms_median=tuned["step_ms_median"],
               phase6_step_ms_replay=train["step_ms_replay"],
               phase6_step_ms_median=train["step_ms_median"])
    for sw in sweeps:
        log(f"[autotune] {sw['key']}: candidates (s) {sw['candidates']}, "
            f"winner {sw['winner']}, probes {sw['bw_probes_bytes_per_s']} "
            f"(window {sw['bw_window']}), persisted {sw['persisted']}")
    _check("[autotune]", {
        "three sweeps from the empty cache (B1, B2, B3)":
            [sw["key"][0] for sw in sweeps] == ["fwd", "bwd", "ragged"],
        "every candidate timed (none failed)": all(
            t is not None for sw in sweeps
            for t in sw["candidates"].values()),
        "every winner persisted": all(persisted) and len(on_disk) == 3,
        "B1 and B2's winners within phase 3's tolerance (_check_flash "
        "raises otherwise)": bool(flash_err),
        f"B3's winner within phase 2's limit ({ragged_tol:.3e})":
            ragged_err <= ragged_tol,
        "a fresh process reads the winners with no sweep and no timing":
            fresh["sweeps"] == [] and fresh["timings"] == 0
            and fresh["libs"] == libs,
        "PADDLE_TPU_PALLAS_AUTOTUNE=0 restores the defaults":
            all(killed.values()),
        "no timing inside a CUDA-graph capture, over the whole run":
            CAPTURE_TIMINGS["capturing"] == 0},
        rec)
    log(f"[autotune] winners (build flags) {libs}; sweeps {sweep_s:.2f} s "
        f"(builds included); bandwidth probes min {rec['bw_min'] / 1e12:.4f}"
        f" median {rec['bw_median'] / 1e12:.4f} max "
        f"{rec['bw_max'] / 1e12:.4f} TB/s (window {window}); fresh process "
        f"{child_s:.1f} s; gpt2_small step with the winners "
        f"{tuned['step_ms_replay']:.3f} ms by replay, "
        f"{tuned['step_ms_median']:.2f} by wall (phase 6: "
        f"{train['step_ms_replay']:.3f}, {train['step_ms_median']:.2f}); "
        f"timings {CAPTURE_TIMINGS}")
    return rec


# ---------------------------------------------------------------------------
# phase 39: the collectives through NCCL at world size 1
# ---------------------------------------------------------------------------
def _collectives_on(dist, grads, rank_major):
    """Every collective on each of `grads` (a list of CUDA tensors),
    smallest first, so each op's algorithmic-bandwidth gauge keeps the
    largest tensor's sample; in rank-major mode each is the world's
    [1, ...] rank-major tensor. Returns {collective: all results equal
    their expected values}."""
    import torch
    ok = {}
    grads = sorted(grads, key=lambda g: g.numel())
    R = dist.ReduceOp

    def each(name, fn):
        ok[name] = all(fn(g) for g in grads)

    def rm(g):
        return g[None] if rank_major else g

    def reduced(op):
        def f(g):
            t = rm(g).clone()
            dist.all_reduce(t, op=op)
            return torch.equal(t, rm(g))
        return f

    for nm in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        each(f"all_reduce {nm}", reduced(getattr(R, nm)))

    def reduce(g):
        t = rm(g).clone()
        dist.reduce(t, dst=0)
        return torch.equal(t, rm(g))

    def broadcast(g):
        t = rm(g).clone()
        dist.broadcast(t, src=0)
        return torch.equal(t, rm(g))

    def all_gather(g):
        parts = []
        dist.all_gather(parts, rm(g))
        cat = dist.all_gather(rm(g))
        # a part is one rank's local tensor
        return len(parts) == 1 and torch.equal(parts[0], g) \
            and torch.equal(cat.reshape(rm(g).shape), rm(g))

    def reduce_scatter(g):
        out = dist.reduce_scatter(rm(g).clone())
        return torch.equal(out.reshape(rm(g).shape), rm(g))

    def all_to_all(g):
        return torch.equal(dist.all_to_all(rm(g).clone()), rm(g))

    def scatter(g):
        t = torch.empty_like(rm(g))
        dist.scatter(t, [rm(g)[0] if rank_major else rm(g)], src=0)
        return torch.equal(t, rm(g))

    def p2p(g):
        if not rank_major:
            # one rank cannot send to itself over NCCL
            return True
        dist.send(rm(g), dst=0)
        t = torch.empty_like(rm(g))
        dist.recv(t, src=0)
        return torch.equal(t, rm(g))

    for f in (reduce, broadcast, all_gather, reduce_scatter, all_to_all,
              scatter, p2p):
        each(f.__name__, f)
    w = dist.all_reduce(rm(grads[-1]).clone(), sync_op=False)
    ok["async all_reduce"] = w.wait() is True
    dist.barrier()
    return ok


def collectives_phase() -> dict:
    """gpt2_small's 148 gradient-sized tensors (~124 M f32) through every
    collective, eager rank-major at the card's world (1) and per-rank
    through an NCCL process group of world size 1, each equal to its
    expected value, the comms series recorded; a DataParallel gpt2_small
    step bit-equal to the bare step; the group destroyed."""
    import socket

    import torch
    import torch.distributed as tdist
    import paddle_tpu_torch as P
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt2_small)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     use_flash_attention=True)
    shapes = [tuple(p.shape) for p in _torch_params(
        GPTForCausalLM(cfg, device="cuda"))]
    _fresh_card()
    gen = torch.Generator(device="cuda").manual_seed(39)
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    n_elems = sum(g.numel() for g in grads)
    dist.destroy_process_group()
    obs.disable()
    obs.reset()
    obs.enable()
    try:
        world = dist.get_world_size()
        t0 = time.perf_counter()
        rank_major = _collectives_on(dist, grads, rank_major=True)
        rm_s = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                 f"{port}", world_size=1, rank=0)
        g = dist.init_parallel_env()
        backend = str(tdist.get_backend())
        t0 = time.perf_counter()
        per_rank = _collectives_on(dist, grads, rank_major=False)
        pg_s = time.perf_counter() - t0
        snap = obs.snapshot()

        def series(name):
            return {str(k): v for k, v in snap.get(name, {}).get(
                "series", {}).items()}

        seconds = series("paddle_tpu_collective_seconds")
        nbytes = series("paddle_tpu_collective_bytes_total")
        algbw = series("paddle_tpu_collective_algbw_bytes_per_sec")
        # a DataParallel step against the bare step
        losses, params = [], []
        rng = np.random.default_rng(39)
        ids = rng.integers(0, cfg.vocab_size, (4, 1024)).astype(np.int32)
        for wrap in (True, False):
            m = GPTForCausalLM(cfg, device="cuda", seed=0)
            m.train()
            net = dist.DataParallel(m) if wrap else m
            opt = AdamW(learning_rate=1e-4, parameters=net.parameters(),
                        weight_decay=0.01)
            x = torch.as_tensor(ids, device="cuda")
            loss = GPTPretrainingCriterion()(net(x)[:, :-1], x[:, 1:])
            loss.backward()
            if wrap:
                net.apply_collective_grads()
            opt.step()
            losses.append(float(loss.detach()))
            params.append([p.detach().clone() for p in _torch_params(m)])
            del m, net, opt, loss
        dp_equal = losses[0] == losses[1] and all(
            torch.equal(a, b) for a, b in zip(*params))
        del params
        dist.destroy_process_group()
        destroyed = not tdist.is_initialized() and not dist.is_initialized()
    finally:
        obs.disable()
        obs.reset()
        if tdist.is_initialized():
            tdist.destroy_process_group()
    del grads
    _fresh_card()
    bw = {k: v for k, v in algbw.items() if v}
    rec = dict(tensors=len(shapes), elements=n_elems, world=world,
               backend=backend, rank_major=rank_major, per_rank=per_rank,
               rank_major_s=rm_s, per_rank_s=pg_s,
               seconds={k: v["sum"] for k, v in seconds.items()},
               counts={k: v["count"] for k, v in seconds.items()},
               bytes=nbytes, algbw=bw, card=card_line(),
               data_parallel_loss=losses[0])
    _check("[collectives]", {
        "148 gradient tensors": len(shapes) == 148,
        "the card's rank-major world is one rank": world == 1,
        "every collective equals its value, rank-major":
            all(rank_major.values()),
        "every collective equals its value through NCCL":
            all(per_rank.values()) and "nccl" in backend,
        "comms recorded non-zero bytes, seconds and algorithmic bandwidth":
            bool(bw) and all(v for v in nbytes.values())
            and all(v["sum"] > 0 for v in seconds.values()),
        "a DataParallel step is bit-equal to the bare step": dp_equal,
        "destroy_process_group ends the group": destroyed}, rec)
    log(f"[collectives] {len(shapes)} tensors, {n_elems} f32: rank-major "
        f"{rm_s:.2f} s, NCCL ({backend}) {pg_s:.2f} s; all_reduce algbw "
        f"{ {k: round(v / 1e9, 2) for k, v in bw.items()} } GB/s on "
        f"{rec['card']}")
    return rec


PHASE_S = {}


def timed(phase, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds recorded as PHASE_S[phase]."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[phase] = round(time.perf_counter() - t0, 2)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    # every phase tunes B1, B2 and B3 at its first shape class, from an
    # empty block-config cache of this run's own under build/
    import os
    import shutil
    cache = os.path.join(_build_dir(), "autotune_smoke")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["PADDLE_TPU_CACHE_DIR"] = cache
    _count_capture_timings()
    secs = timed("1", build_all)
    log("[build] " + "; ".join(f"{k}: {v:.1f} s" for k, v in secs.items()))
    cases = timed("2", kernel_phase)
    flash = timed("3", flash_phase)
    engine = timed("4", engine_phase, keep=OBS_KEEP["serve"])
    # 33a, on 4's model
    observed = {"serve": timed("33a", obs_serve_phase, engine)}
    OBS_KEEP["serve"].clear()
    _fresh_card()
    parity = timed("5", parity_phase)
    train = timed("6", train_phase, keep=OBS_KEEP["train"])
    # 33b and 34, on 6's step
    observed["train"] = timed("33b", obs_train_phase, train)
    numerics = timed("34", numerics_phase)
    OBS_KEEP["train"].clear()
    _fresh_card()
    train_parity = timed("7", train_parity_phase)
    norm_cases = timed("8", norm_phase)
    llama = timed("9", llama_engine_phase)
    llama_parity = timed("10", llama_parity_phase)
    fused = timed("11", fused_phase)
    updates = timed("12", update_phase)
    train_1p3b = timed("13", train_1p3b_phase)
    recompute_parity = timed("14", recompute_parity_phase)
    train_f16 = timed("15", f16_train_phase)
    engine_f16 = timed("16", f16_engine_phase)
    train_llama = timed("17", llama_train_phase)
    train_bert = timed("18", bert_train_phase)
    train_resnet = timed("19", resnet_train_phase)
    spec = timed("20", spec_phase)
    int8 = timed("21", int8_engine_phase)
    eager = timed("22", eager_phase, train)
    io = timed("23", io_phase, train_resnet)
    lstm = timed("24", lstm_phase)
    unpadded = timed("25", unpadded_phase)
    surface = timed("26", surface_phase, eager)
    export = timed("27", export_phase)
    hapi = timed("28", hapi_phase, eager)
    mobilenet = timed("29", mobilenet_phase)
    detection = timed("30", detection_phase, eager)
    incubate = timed("31", incubate_phase, eager)
    opsurf = timed("32", opsurf_phase, eager)
    host_modules = timed("35", host_modules_phase)
    fleet = timed("36", fleet_phase)
    models_io = timed("37", models_io_phase)
    tuned = timed("38", autotune_phase, train)
    collectives = timed("39", collectives_phase)
    winners = tuned["winners_flags"]
    EAGER_GPT.clear()       # phases 23d and 28 read phase 22's GPT
    runs_17_18 =(("llama13b", train_llama["no_recompute"]),
                  ("llama13b_recompute", train_llama["recompute"]),
                  ("bert_base", train_bert))
    main_case = cases[0]    # the engine's fresh wave: its largest launch
    f16_case = next(c for c in cases if c["case"] == "f16 fresh wave, no pool")
    fmain = flash[0]        # gpt2_small's training shape
    verify_case = next(c for c in cases if c["case"] == "verify wave 8x8")
    int8_case = next(c for c in cases if c["case"] == "int8 engine wave")
    src = "paddle_tpu_torch/kernels/csrc/"

    def b3_call(case, **launches):
        """B3's record at one phase 2 case beside its launches on a
        path."""
        return dict(**launches, design=case["design"],
                    max_abs_err=case["max_abs_err"], ms=case["ms"],
                    ms_graph=case["ms_graph"],
                    simple_ms=case["simple_ms_graph"],
                    plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                    bound_by=case["bound_by"],
                    library_ms=case["library_ms"],
                    library_ms_graph=case["library_ms_graph"])

    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source=src + B3_SOURCES[main_case["design"]],
        replaces="paddle_tpu/kernels/pallas/ragged_paged_attention.py:313",
        launches=engine["kernel_launches"],
        max_abs_err=max(r["max_abs_err"] for c in cases
                        for r in c["designs"].values()),
        # ms by single-call events (the wrapper's host path included) and
        # by CUDA-graph replay (device only), the plan built outside both;
        # the simple design and SDPA's yardstick by replay
        ms=main_case["ms"], ms_graph=main_case["ms_graph"],
        design=main_case["design"], simple_ms=main_case["simple_ms_graph"],
        plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"],
        library_ms_graph=main_case["library_ms_graph"],
        # the same wave in f16 (phase 2) and its launches serving
        # gpt3_1p3b in f16 (phase 16)
        f16=dict(launches=engine_f16["kernel_launches"],
                 design=f16_case["design"],
                 max_abs_err=max(r["max_abs_err"] for c in cases
                                 if c["dtype"] == "float16"
                                 for r in c["designs"].values()),
                 ms=f16_case["ms"], ms_graph=f16_case["ms_graph"],
                 simple_ms=f16_case["simple_ms_graph"],
                 plain_ms=f16_case["plain_ms"],
                 bound_ms=f16_case["bound_ms"],
                 bound_by=f16_case["bound_by"],
                 library_ms=f16_case["library_ms"],
                 library_ms_graph=f16_case["library_ms_graph"]),
        # phase 20's verify waves (every launch sm90) at phase 2's verify
        # case, and phase 21's int8 engine: its launches with dequant
        # scales (the simple design) at phase 2's int8 engine wave
        verify=b3_call(verify_case,
                       launches=spec["spec_on"]["verify"]["launches"]),
        int8=b3_call(int8_case, launches=int8["b3_simple_dequant_launches"],
                     launches_by_design=int8["b3_launches_by_design"]),
        # phase 33a's last observed serving run (every launch sm90)
        launches_observed=observed["serve"]["b3_launches"],
        # phase 36's fleet paths (sm90 launches): 36a's Router runs (the
        # timed affinity and least-loaded passes and the killed run),
        # 36b's DisaggRouter (its traffic, the fixed prompt sets; the
        # decode replicas' prefix-resume waves over imported pages), 36c's
        # replica processes (the survivor's and the replacement's)
        launches_fleet=fleet["b3_sm90_launches"],
        # the build variant phase 38 chose at this case's shape class
        # (its -D flags; none: the source's defaults)
        variant=winners["B3"],
        cases=cases)]
    t13 = train_1p3b["recompute"]
    for i, (kind, name, line, launches, source) in enumerate((
            ("fwd", "flash_attention_fwd", 267,
             train["b1_design_launches"]["sm90"], "flash_fwd_sm90.cu"),
            ("bwd", "flash_attention_bwd", 457,
             train["b2_design_launches"]["sm90"], "flash_bwd_sm90.cu"))):
        kernels.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=f"paddle_tpu/kernels/pallas/flash_attention.py:{line}",
            # counted: the eager first step's and the captured step's;
            # run on the card: the eager step's and the captured step's
            # times the replays, from the counters read around the capture
            launches=launches,
            launches_on_device=train[f"b{1 if kind == 'fwd' else 2}"
                                     "_launches_on_device"],
            # phase 13's path (gpt3_1p3b, recompute every third block):
            # counted over its eager step and capture, and run on the card
            launches_1p3b=t13["launches_counted"][i],
            launches_on_device_1p3b=t13["launches_on_device"][i],
            **_launches_17_18(runs_17_18, i),
            # phase 22: the eager API's scaled_dot_product_attention op
            # (and its backward) over the eager script's 3 steps
            launches_eager_api=sum(
                s["sm90"] for s in eager["gpt"]["b1_by_step" if i == 0
                                                else "b2_by_step"]),
            # phase 22's GPT built from nn.Layers, over its 3 steps
            launches_eager_layers=sum(
                s["sm90"] for s in eager["gpt"]["nn_layer_gpt"][
                    "b1_by_step" if i == 0 else "b2_by_step"]),
            # phase 23d: that GPT fed by a DataLoader, over its 3 steps
            launches_io=sum(
                s["sm90"] for s in io["gpt"][
                    "b1_by_step" if i == 0 else "b2_by_step"]),
            # phase 25: flash_attn_unpadded's packed calls, one a case
            launches_unpadded=sum(
                c["launches_by_design"][kind]["sm90"] for c in unpadded),
            # phase 27 (B1 only): one eager run of the loaded program at
            # each batch, and the Predictor's captures (warm-up and
            # capture of each batch signature; replays launch nothing
            # the host counts)
            **(dict(launches_export=sum(
                r["b1_launches"]["sm90"]
                for r in export["by_batch"].values()),
                launches_predictor_capturing=export[
                    "b1_launches_capturing"]["sm90"]) if kind == "fwd"
               else {}),
            # phase 28: hapi.Model.fit's 3 steps
            launches_hapi=sum(
                st["sm90"] for st in hapi[
                    "b1_by_step" if i == 0 else "b2_by_step"]),
            # phase 31b: the fused encoder layers' 3 eager training steps
            # on Tensors; 31c: fused_flash_attention and the two
            # memory_efficient_attention calls through loss.backward()
            launches_incubate_training=sum(
                st["b1" if i == 0 else "b2"]
                for st in incubate["training"]["launches_by_step"]),
            launches_incubate_functionals=incubate["functionals"][
                "launches"]["b1" if i == 0 else "b2"],
            max_abs_err=max(e for c in flash for dt in ("bf16", "f16")
                            for what, e in c[f"max_abs_err_{dt}"].items()
                            if (what in ("o", "lse")) == (kind == "fwd")),
            ms=fmain[f"{kind}_ms"], plain_ms=fmain[f"plain_{kind}_ms"],
            bound_ms=fmain[f"{kind}_bound_ms"],
            bound_by=fmain[f"{kind}_bound_by"],
            library_ms=fmain["library_fwd_ms" if kind == "fwd"
                             else "library_fwd_bwd_ms"],
            # by graph replay (device time only), the design, and the
            # simple kernel at the same shape by graph replay; B2's
            # library time by replay is SDPA's backward alone
            ms_graph=fmain[f"{kind}_ms_graph"],
            library_ms_graph=fmain[f"library_{kind}_ms_graph"],
            design=fmain[f"{kind}_design"],
            variant=winners["B1" if kind == "fwd" else "B2"],
            simple_ms=fmain[f"simple_{kind}_ms_graph"],
            # f16 at the same shape (phase 3) and its launches in phase
            # 15's graph steps, counted and on the card
            f16=dict(
                launches=train_f16[f"b{1 if kind == 'fwd' else 2}"
                                   "_launches"],
                launches_on_device=train_f16[
                    f"b{1 if kind == 'fwd' else 2}_launches_on_device"],
                design=fmain["f16"][f"{kind}_design"],
                ms=fmain["f16"][f"{kind}_ms"],
                ms_graph=fmain["f16"][f"{kind}_ms_graph"],
                simple_ms=fmain["f16"][f"simple_{kind}_ms_graph"],
                plain_ms=fmain["f16"][f"plain_{kind}_ms"],
                bound_ms=fmain["f16"][f"{kind}_bound_ms"],
                bound_by=fmain["f16"][f"{kind}_bound_by"],
                library_ms=fmain["f16"]["library_fwd_ms" if kind == "fwd"
                                        else "library_fwd_bwd_ms"],
                library_ms_graph=fmain["f16"][f"library_{kind}_ms_graph"],
                max_abs_err=max(e for c in flash for what, e in
                                c["max_abs_err_f16"].items()
                                if (what in ("o", "lse"))
                                == (kind == "fwd"))),
            cases=flash))
    # B4 at the fused encoder's shape, B5 at LLaMA-2-7B's packed prefill,
    # both bf16 with their affine; launches from phases 11 and 9, and
    # phase 31's (31b's training steps, 31c's fused_rms_norm)
    for kind, main_name, line, launches, inc in (
            ("layer_norm", "bert_base", 68, fused["b4_launches"],
             sum(st["b4"] for st in incubate["training"][
                 "launches_by_step"])),
            ("rms_norm", "llama2_7b prefill", 88, llama["b5_launches"],
             incubate["functionals"]["launches"]["b5"])):
        mine = [c for c in norm_cases if c["kind"] == kind]
        m = next(c for c in mine if c["case"] == main_name
                 and c["dtype"] == "bf16" and c["affine"])
        kernels.append(dict(
            name=kind, route="cuda", source=src + "norms.cu",
            replaces=f"paddle_tpu/kernels/pallas/norms.py:{line}",
            launches=launches, launches_incubate=inc,
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            cases=mine))
    # the update at gpt2_small's shapes, AdamW in f32 (phase 6's case);
    # launches from phase 6
    u = updates[0]
    kernels.append(dict(
        name="multi_tensor_adam", route="cuda",
        source=src + "multi_tensor_adam.cu",
        replaces="paddle_tpu/optimizer/optimizer.py:317",
        launches=train["update_launches"],
        launches_on_device=train["update_launches_on_device"],
        launches_1p3b=t13["launches_counted"][2],
        launches_on_device_1p3b=t13["launches_on_device"][2],
        **_launches_17_18(runs_17_18, 2),
        max_abs_err=max(c["max_abs_err"] for c in updates),
        ms=u["ms"], ms_graph=u["ms_graph"], plain_ms=u["plain_ms"],
        bound_ms=u["bound_ms"], bound_by=u["bound_by"],
        library_ms=u["library_ms"], cases=updates))
    # its statistics variant (the numerics plane's bundle) at phase 6's
    # shapes (34a); launches from phase 34b's runs with the plane on
    nk = numerics["kernel"]
    kernels.append(dict(
        name="multi_tensor_adam_stats", route="cuda",
        source=src + "multi_tensor_adam.cu",
        replaces="paddle_tpu/optimizer/optimizer.py:388",
        design="mta_update<true> + mta_advance<true>",
        launches=numerics["stats_launches"],
        launches_on_device=numerics["stats_launches_on_device"],
        max_abs_err=nk["max_abs_err"], max_rel_err=max(nk["errs"].values()),
        ms=nk["ms_on"][0], ms_graph=nk["ms_on"], ms_off_graph=nk["ms_off"],
        plain_ms=nk["plain_ms"], bound_ms=nk["bound_ms"],
        bound_by=nk["bound_by"], library_ms=None))
    log("[engine] " + json.dumps(engine))
    log("[parity] " + json.dumps(parity))
    log("[train] " + json.dumps(train))
    log("[train-parity] " + json.dumps(train_parity))
    log("[llama] " + json.dumps(llama))
    log("[llama-parity] " + json.dumps(llama_parity))
    log("[fused] " + json.dumps(fused))
    log("[train-1p3b] " + json.dumps(train_1p3b))
    log("[recompute-parity] " + json.dumps(recompute_parity))
    log("[train-f16] " + json.dumps(train_f16))
    log("[engine-f16] " + json.dumps(engine_f16))
    log("[train-llama13b] " + json.dumps(train_llama))
    log("[train-bert] " + json.dumps(train_bert))
    log("[train-resnet50] " + json.dumps(train_resnet))
    log("[spec] " + json.dumps(spec))
    log("[int8] " + json.dumps(int8))
    log("[eager] " + json.dumps(eager))
    log("[io] " + json.dumps(io))
    log("[lstm] " + json.dumps(lstm))
    log("[unpadded] " + json.dumps(unpadded))
    log("[nn-surface] " + json.dumps(surface))
    log("[export] " + json.dumps(export))
    log("[hapi] " + json.dumps(hapi))
    log("[train-mobilenet_v2] " + json.dumps(mobilenet))
    log("[detect] " + json.dumps(detection))
    log("[incubate] " + json.dumps(incubate))
    log("[opsurf] " + json.dumps(opsurf))
    log("[obs] " + json.dumps(observed))
    log("[numerics] " + json.dumps(numerics))
    log("[host-modules] " + json.dumps(host_modules))
    log("[fleet] " + json.dumps(fleet, default=str))
    log("[models-io] " + json.dumps(models_io))
    log("[autotune] " + json.dumps(tuned))
    log("[collectives] " + json.dumps(collectives))
    log("[phase-seconds] " + json.dumps(PHASE_S))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

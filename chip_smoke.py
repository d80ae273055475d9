#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (room_slam_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--requests 5] [--warmup 20]
                          [--window 200]

Phases, one line each or more (a failed check raises; nothing is caught):

1. device: card name, count, and ``nvidia-smi`` name and power limit;
2. build: every kernel source in ``room_slam_torch/csrc``, one ``nvcc`` each,
   all started together (registers and spills from ``-Xptxas -v``); the
   BiGRU tensor-core kernels, the fused kind (#9), the GRU and LSTM BPTT
   unit kernels, the LSTM register cluster kernels, the stream kernels
   and the pipe kernels (``csrc/bilstm_pipe.cu``, ``csrc/bigru_pipe.cu``,
   and the forwards' ``csrc/bilstm_fwd_pipe.cu``, ``csrc/bigru_fwd_pipe.cu``,
   asserted free of spills) and the GRU register cluster kernels
   (``csrc/bigru_fwd_reg.cu``, ``csrc/bigru_bwd_reg.cu``, every instance;
   those that spilled nothing when they were added asserted so) by name, the
   tensor-core kernels, #9's bf16 kind and the LSTM BPTT unit kernels
   asserted free of spills; the native trace parser
   (``room_slam_torch/native/trace_parser.cc``, g++) into ``build/native``;
3. kernel check on the card: ``bilstm_fwd`` (the unit kernel, H <= 64)
   against its plain version, ``bilstm_fwd_train`` (ys, c, gates) and
   ``bilstm_bwd`` (dg; the unit kernel, asserted, then every unit tile the
   card runs and the wide kernel) against theirs, and ``BiLSTMFunction``'s
   four gradients against torch autograd through the plain loop, at the
   bench, serving, flagship training and a ragged shape, H=16 and 17 rows;
   the wide forward kernel (the first design) forced at the ragged shape;
   ``bilstm_bwd`` and ``lstm_bwd`` (both walk orders) on their route at
   ``WIDE`` (H=96: the register cluster kernel, asserted), and
   ``bilstm_bwd`` on the wide kernel forced there;
4. kernel timing: each kernel, its plain version, the cuDNN yardstick
   (never called by the port) and the roofline bound, at the bench and
   serving shapes (``bilstm_fwd``) or bench and training shapes (the
   training kernels), µs per step beside cuDNN's, and each kernel under
   every plan (each unit tile the card runs, and the wide kernel) with the
   planner's pick beside the fastest;
5. model: the flagship model (``configs/flagship_v15.json``) at full width
   with seeded random weights, forward at B=32, N=500 through the kernel,
   against the same model through the plain recurrence;
6. serving (a main path): a predictor answers requests on seeded walk
   traces of up to 3000 points (1500 after downsampling; loaded through the
   native parser), writes collider JSON, and one answer is held against
   the same predictor on the CPU;
7. serving latency: ``--window`` full-length requests after ``--warmup``,
   p50 and p99 over all of them, each request split into its stages on the
   host clock (the JSON stage beside the Python parser's earlier time), and
   the forward and post-process on CUDA events;
8. training (a main path): ``ROOMS`` seeded rooms written as
   trace/collider JSON, ``train_benchmark`` on the flagship config at full
   width for ``EPOCHS`` epochs; finite losses, a checkpoint with the
   optimizer state, and the launch counts (two training forwards and two
   BPTT launches per step, light launches only in validation); then the
   run resumed from the last epoch's periodic checkpoint for one more
   epoch (the restored epoch, learning rate and AdamW count asserted, no
   recovery), and ``evaluate_benchmark`` on the best model on the card
   against the same call on the CPU (metrics within 1e-3, mAP equal where
   the kept detections are), plain and with ``refine`` 0.3,
   ``refine_furniture`` and ``extent_slack`` 1.0;
9. the checkpoint served: the port's predictor loads the best model and
   answers one request on the card;
10. one-step parity: one train step on the card and the same step on the
    CPU from the same parameters and batch (augmentation off, dropout 0,
    ``train.matmul_precision`` float32 on both): losses, Hungarian
    assignments and updated parameters agree; and, not asserted, how many
    assignments differ at the unmodified random init; then the step at the
    config's own precision ('bfloat16': TF32 products) against float32 on
    the card (losses rel ``PRECISION_LOSS_RTOL``, gradients max-rel
    ``PRECISION_GRAD_REL``, not equal);
11. train-step timing at the flagship training shape (B=20, N=1500) and the
    bench shape (B=32, N=500): p50 step ms and traces/s over ``STEPS``
    steps after ``STEP_WARMUP``, then a per-stage mean with a
    synchronise between stages;
12. BiGRU kernel check on the card: ``bigru_fwd`` (ys), ``bigru_fwd_train``
    (ys, gates, hn) and ``bigru_bwd`` (dx, dhn) against their plain
    versions, and ``BiGRUFunction``'s six gradients against torch autograd
    through the plain loop, at the scale-up shape (128, 5000, 256) in bf16,
    (16, 1000, 256) in f32, (5, 43, 16) in both and the tensor-core
    kernels' edges in bf16 ((17, 300, 256), (5, 43, 64), (1, 500, 256)),
    with each launch's kernel (asserted: "tc" for bf16 where the rule
    holds, else "cluster"), cluster size and batch tile; where the
    tensor-core kernels run, also under every tc plan the card runs;
13. BiGRU kernel timing at the scale-up shape: each kernel, its plain
    version, torch ``nn.GRU`` (never called by the port), the bound and the
    time per step, and each kernel under every plan (the tensor-core
    kernel's and the cluster kernel at its planner's pick) there and at a
    batch of one row; then the dW_hh / db_hh products outside the kernels
    as the port runs them (bf16 operands, f32 sums and result) beside the
    f32 products of upcast copies (the port's before), held to max-rel
    1e-4;
14. scale-up training (a main path): seeded rooms of 5000-7500 points,
    ``train_benchmark`` on the scale-up bigru config (d_model 512, 32
    queries, bf16 streams, B=128, N=5000) for 3 steps; finite losses, a
    checkpoint, launch counts (the tensor-core kernels, asserted), peak
    device memory;
15. scale-up serving (a main path): the checkpoint answers one request of
    7500 points with two ``bigru_fwd`` launches; outputs and colliders
    against the same model through the plain recurrence on the card;
16. one scale-up step at B=8 with the kernels and with their plain
    versions patched in, on the card: equal assignments, losses within the
    bf16 tolerance;
17. scale-up train-step timing (B=128, N=5000): p50 over
    ``SCALEUP_STEPS`` after ``SCALEUP_WARMUP``, then the per-stage split;
18. single-direction kernel check on the card: ``gru_fwd``,
    ``gru_fwd_train`` and ``gru_bwd`` (each the unit kernel at H <= 64,
    asserted) at the legacy shape (32, 500, 64) in f32 and bf16, the
    serving, training and ragged shapes in f32, (5, 43, 16) and (17, 300,
    64) in f32 and bf16, and (8, 1000, 256) bf16 (the cluster kernel,
    asserted), and ``lstm_fwd``, ``lstm_fwd_train`` and ``lstm_bwd`` at
    phase 3's shapes in f32, both walk orders, against their plain
    versions (the LSTM kernels on the unit kernel, asserted), and
    ``GRUFunction``'s / ``LSTMFunction``'s gradients against autograd
    through the plain loop;
19. their timing at (32, 500, 64) f32: kernel, plain version, bound and
    cuDNN's unidirectional ``nn.GRU`` / ``nn.LSTM`` (never called by the
    port), µs per step beside cuDNN's, and every kernel under every plan
    (each unit tile the card runs, and the first design: the cluster
    kernel at its planner's pick, the wide LSTM kernels) with the
    planner's pick beside the fastest; ``gru_bwd`` also in bf16 against
    ``nn.GRU`` bf16 and cuDNN fp16;
20. legacy training (a main path): ``LEGACY_ROOMS`` seeded rooms written as
    legacy CSV/objects pairs, ``train_legacy`` at its defaults (hidden 128,
    seq 500, batch 32) for ``LEGACY_EPOCHS`` epochs; finite losses, a
    ``best_model_legacy`` checkpoint, and exactly 4 ``gru_fwd_train`` and 4
    ``gru_bwd`` launches a step, 4 ``gru_fwd`` a validation batch, nothing
    else;
21. legacy evaluation (a main path): ``evaluate_legacy`` with the
    occupancy baseline on the card (4 ``gru_fwd`` launches), mAP and the
    baseline's, and the model's boxes, labels and mAP against the same
    evaluation on the CPU;
22. one legacy step card vs CPU (dropout 0, same parameters and batch):
    equal assignments, losses and updated parameters;
23. legacy train-step timing (B=32, N=500): p50 over ``LEGACY_STEPS``
    after ``LEGACY_WARMUP``, then the per-stage split;
24. the ops-level LSTM path: ``ops/rnn.py`` ``lstm_recurrence(use_kernel=
    True)`` forward and backward at (32, 500, 64) in f32 and in bf16, its
    launches and its values and gradients against the plain loop;
25. split BPTT check: ``bigru_bwd_split`` (#10, on #6's route) against its
    plain version and against ``bigru_bwd`` (#6; in float32 the same
    function up to sum order) at the phase 12 shapes and ``SPLIT_SHAPES``
    (a shape for each kernel of the route), each launch's kernel asserted
    #6's, a second launch bit-equal, with each launch's plan;
26. fused layer check: ``bigru_layer`` under grad (its backward the fused
    kernel #9) at (3, 53, 16, 24) f32, (2, 40, 16, 16) bf16,
    (16, 1000, 256, 512) bf16 and (5, 97, 32, 40) bf16 (samples, D and 3H
    off the tensor-core tiles): the output and nine gradients against the
    same layer with #9's plain version on the card, a second run bit for
    bit, and the unfused layer (``BiGRUFunction`` + torch products);
27. #9 against #6 plus cuBLAS at the scale-up shape (B=128, N=5000, H=256,
    D=512, bf16): one layer's forward + backward both ways, 6 after 2
    warm-up (#9's path: its launches are counted there), then #9 alone,
    #6 at #9's plan and their difference (what the chunks' products cost),
    its plain version once, its bound;
28. the tool (#10's path): ``room_slam_torch.tools.bench_bigru_bwd`` at the
    scale-up shape, ``--tiles auto --reps 5`` (the plans of the route's
    kernel), its rows; then #10 on the route, #10's first design and #6 in
    turns at ``SPLIT_SHAPES`` beside cuDNN and the bound;
29. the six LSTM kernels in bf16 against their plain versions (values, BPTT
    on the unit kernel and under every plan, and the Functions'
    gradients) at phase 3's shapes, and their timing against ``nn.LSTM``
    bf16 and cuDNN fp16 (each the median of three rounds of 20 calls
    after 2 warm-up, with the rounds' spread), µs per step beside cuDNN's,
    each kernel under every plan;
30. the bf16 flagship path: ``configs/flagship_v15.json`` with
    ``compute_dtype`` bfloat16 at full width, a B=32, N=500 forward and one
    served 3000-point request against the plain recurrence on the card,
    and 3 training steps, launch counts read around each;
31. the LSTM cluster route (H above the wide kernels, to 256) at
    ``CLUSTER_WIDTHS`` x ``CLUSTER_BATCHES``, N=``CLUSTER_N``, f32 and
    bf16: the light and training forward and the BPTT, two directions and
    one, each launch's route asserted "reg" (the register cluster kernels)
    and its plan printed, against the plain versions, the BPTT bit-equal
    on a second launch; the first cluster kernels, forced at their
    planner's pick, the same way at ``OLD_CLUSTER_WIDTHS`` (one width a
    kind and dtype);
32. the GRU cluster kernels' masked slices (the first design, the
    cluster size need not divide H; forced at the card's pick since the
    GRU register cluster kernels took the route) at ``MASKED_WIDTHS``,
    ``MASKED_BATCHES``,
    N=``MASKED_N``, checked the same way, each plan's cluster asserted not
    to divide H;
33. the new routes' timing: the LSTM kernels at ``LSTM_REG_TIME``
    ((32, 500, 256) f32 and bf16, the reference lstm request's (1, 3000,
    128) f32), the register cluster kernel (at the first shape beside the
    first cluster kernel forced at its planner's pick in the same call):
    kernel, plain version, bound and cuDNN ``nn.LSTM`` (fp16 for the bf16
    rows), µs a step (the GRU's rows are phase 41's);
34. their main paths, counted: the flagship ``lstm`` at d_model 512
    (H=256) forward against the plain recurrence and one train step with
    the kernels and with the plain versions patched in (equal assignments,
    losses rel 1e-4); ``lstm_recurrence`` / ``gru_recurrence``
    (``use_kernel=True``) at H=256 / 139; a ``bigru`` at H=139, one
    forward and one train step (the GRU's on the register cluster
    kernels);
35. serving recipes on the flagship (a main path): ``unseen`` (``y_planes``
    from a written colliders JSON, soft-NMS 0.25 at ``nms`` 0.5, ttopt with
    deadband 0.25 behind its auto gate), ``tta`` (rotations, reflection,
    scales 0.9 and 1.1: R = 24 views; fuse, consensus, top_k 15) and
    ``passes`` (refine 0.3 furniture-aware, wall and v2 furniture
    synthesis, extent slack 1.0, qscore behind its auto gate, ttopt with
    the adopted deadband 0.25 and no gate), each
    ``RECIPE_REQUESTS`` seeded 3000-point walks on the card against the
    same predictor on the CPU (labels equal, values within 1e-3), two
    ``bilstm_fwd`` launches a request at B = R (asserted); the gates' tau
    0.448, or between the middle signals when 0.448 does not split the
    requests, each request's way printed; one request each at R = 4 and 8;
    p50 / p99 over ``RECIPE_WINDOW`` requests after ``RECIPE_WARMUP``,
    split into load / prepare / run / finish, with the NMS and ttopt stages
    on CUDA events; and ``post_process(support=0.25)`` on the passes
    recipe's pooled candidates, card vs CPU;
36. ``bilstm_fwd`` at the view batches (4, 8, 24) x (1500, 64) f32 against
    its plain version (the planner's unit tile), its time against the
    bound and cuDNN's bidirectional ``nn.LSTM``, µs a step, and phase 35's
    launches at each batch;
37. the flagship with ``hole_tokens`` 8 on ``HOLE_ROOMS`` seeded rooms: a
    B=32, N=500 forward against the plain recurrence, one train step card
    vs CPU (as phase 10), one request served card vs CPU;
38. the flagship's frozen recipe (FINAL.md): ``make_synthetic_datasets``
    at 2048 mixed rooms, seed 100, L 1500 and its val split on the card
    (time, walks/s, peak memory; time strictly increasing, inside the
    walls within 0.05 m and never inside a blocking footprint on every
    walk; the first 8 rooms of each half against the CPU: labels and
    valid equal, boxes within 1e-5, the share of traces within 1e-3),
    ``make_rooms``' captures tiled 16 times in with ``concat``, one epoch
    at the config's ``bfloat16`` precision (TF32 on in every step and in
    the validation, asserted; step p50; #1t and #2 twice a step, #1 only
    in validation), then ``demo`` and ``create_sample_data`` on the card;
39. the transformer family at ModelConfig's width (d_model 128, 4 heads,
    3 + 3 layers, FFN 512, 30 queries; seeded weights, the anchor
    attention sharpened as in phase 5): (a) ``TRANSFORMER_REQUESTS``
    3000-point requests (1500 after downsampling) card vs CPU, then
    phase 7's latency window; (b) phase 11's step timing at B=20, N=1500
    at the config's ``bfloat16`` precision (with peak memory) and one
    step card vs CPU at float32 (phase 10's rule); (c) the same with
    ``moe_experts`` 4 (``moe_aux`` within rel 1e-4), then its timing; (d)
    reference-named ``.pth`` files (``tests/torch_pth_cases.py``) of the
    transformer at d_model 128 and the lstm at 128 and 256, each loaded
    by ``load_model_for_inference`` and serving 5 requests card vs CPU,
    #1's launches and route (unit at H=64, cluster at H=128) asserted;
    (e) one encoder self-attention forward + backward at (b)'s shape,
    the port's plain attention against ``F.scaled_dot_product_attention``
    (values and gradients, then CUDA-event times and peak memory); (f)
    ``tools.parity.score_checkpoint`` on 16 ``make_rooms`` traces for the
    (d) transformer and a port checkpoint, card vs CPU. No kernel launches
    on the transformer's paths (asserted);
40. (a) the ``bigru`` model at the CLI's defaults (``--model bigru``:
    d_model 128, H=64, float32, B=20, N=3000) on the unit kernels, #5 / #5t
    with a grid of two directions and #6 in one launch of two: their
    timing at ``BIGRU_TIME`` beside the first cluster design forced at its
    planner's pick, the plain versions, the bound and cuDNN's
    bidirectional ``nn.GRU`` (#6 bit-equal run to run); the tensor-core
    kernels against the unit kernels in bf16 at ``BIGRU_BF16``, in turns,
    beside bf16 ``nn.GRU`` (PyTorch's own step loop) and cuDNN in fp16;
    one train step and one served request card vs CPU, each launch on the
    unit kernels (asserted), then the step p50 and the request p50 on the
    unit kernels and with the first cluster design forced; (b) the pipe
    kernels above the cluster kernels' widths (the forwards' to H=1816 for
    the LSTM, 1024 for the GRU; the LSTM and GRU BPTTs', the GRU's to
    H=1024; the first stream designs, W_hh read from global memory every
    step, stay for the widths above and for the A/B) at ``STREAM_WIDTHS``
    x ``STREAM_BATCHES``, f32 and bf16, two directions and one, the twelve
    LSTM and GRU wrappers on their route against their plain versions,
    bit-equal run to run, the pipe kernels' wider instance families at
    ``PIPE_WIDTHS`` (on the route or forced where it stops), the forwards
    under the card's first ``FWD_PIPE_PLANS`` forward pipe plans and the
    GRU BPTT under its first ``GRU_PIPE_PLANS``, the first stream designs
    forced at ``STREAM_OLD``, and their timing at ``STREAM_TIME`` beside
    the bound and cuDNN (read before and after the kernels; the pipe
    kernels beside the first stream design forced, in turns, asserted
    faster, at H=320 the GRU's also beside its first cluster design
    (kLinear's for the BPTT) at its pick, and beside the card's next pipe
    plans), all twelve also at ``PIPE_TIME`` (H=1024); (c)
    their main paths: the lstm at d_model ``STREAM_LSTM_D`` (H=512), a
    forward against the plain recurrence and one train step card vs CPU at
    ``STREAM_STEP``'s B and N (cut from the config's 20 and 1500), its step
    p50 at ``STREAM_STEP_TIME`` (bench.py's B and N) and its served
    forward's p50 at ``STREAM_SERVE`` with the forwards on the pipe kernel
    and on the first stream design, in turns (the BPTT on its pipe route),
    the ops-level ``lstm_recurrence`` / ``gru_recurrence(use_kernel=True)``
    and a bigru at d_model ``STREAM_LSTM_D``, one forward and one train
    step, then its step p50 and served forward's p50 as the lstm's;
41. the GRU register cluster kernels (``csrc/bigru_fwd_reg.cu``,
    ``csrc/bigru_bwd_reg.cu``: #5 / #5t, #7 / #7t, #6 and #8 at H 65-256,
    the route for float32, for bf16 with one direction and for bf16 with
    two where no tensor-core plan fits): (a) the six wrappers at
    ``REG_WIDTHS`` x ``REG_BATCHES``, N=``REG_N``, f32 and bf16, both walk
    orders, each launch asserted on the register kernels (bf16
    two-direction launches the tensor-core kernels take: the card's
    register pick forced), against the plain versions, the BPTT bit-equal
    run to run; (b) the A/B at ``REG_TIME`` f32 ((32, 500, 255) all six,
    (128, 5000, 256) the scale-up's #5 / #5t / #6, (1, 1500, 128) a served
    request's #5): the route (the register kernels; the forwards' batch
    rule sends a register grid of more than two waves to the pipe kernel)
    beside the first cluster design and the pipe kernel, each forced at its
    planner's pick, in turns (the route asserted faster than the first
    design; the first design and the pipe kernel held to the route's
    outputs), the card's first ``REG_SWEEP`` register plans, the bound and
    cuDNN (at the first shape before and after the kernels; the plain
    versions held and timed there only); (c) a ``bigru`` at d_model ``REG_GRU_D`` (H=256, f32): one
    train step card vs CPU at ``REG_STEP``'s B and N, then the step p50 at
    bench.py's B, N = ``REG_STEP_TIME`` and a served forward's p50 at
    ``REG_SERVE`` on the register kernels and on the first cluster design
    in turns, each launch's kernel asserted;
42. the LSTM register cluster kernels at H 65-118, the route there since
    they replaced the wide kernels (#1 / #1t, #3 / #3t, #2, #4): (a) the
    six wrappers at ``MID_WIDTHS`` x ``MID_BATCHES``, N=``MID_N``, f32 and
    bf16, both walk orders, each launch asserted on the register kernels,
    against the plain versions, the BPTT bit-equal run to run, the
    Functions' gradients against autograd through the plain loop, and the
    wide kernel forced at H=96; (b) the A/B at ``MID_TIME`` f32 ((32, 500,
    96) and (32, 500, 116), bench.py's B and N, and a served request's (1,
    1500, 96)): the register kernel at the card's pick beside the wide
    kernel forced, in turns (the route asserted faster), the card's first
    ``MID_SWEEP`` register plans with their resident counts, the LSTM
    planner's pick beside the shared ranking's, the bound and cuDNN before
    and after the kernels (the plain versions held at every shape, timed
    at the first); the card's resident clusters at ``MID_RESIDENT_H``; the
    planner's pick beside the shared ranking's at ``MID_TERMS``; (c) the
    lstm at d_model ``MID_LSTM_D`` (H=96, f32): a forward against the
    plain recurrence, one train step card vs CPU at ``MID_STEP``'s B and
    N, ``lstm_recurrence(use_kernel=True)``, then the step p50 at
    ``MID_STEP_TIME``, a profiler trace of its steps, and a served
    forward's p50 at ``MID_SERVE`` (held to the plain recurrence) on the
    register kernels and on the wide kernels in turns, and the step p50
    again at d_model ``MID_WIDE_D`` (H=116);
43. the exact matcher (``csrc/hungarian.cu``, one block a problem, one
    thread a column): both forms (``hungarian_match_fast``, the set
    criterion's; ``hungarian_match``, the legacy loss's square form) at
    ``MATCH_CASES`` (the flagship's B=20, Q=30, M=50; the scale-up's
    B=128, Q=32, M=32; the legacy square form; M > Q), each on seeded
    float costs and on integer costs full of ties, with an item of no
    valid column, one launch a call, against the plain version on the CPU
    (assignments equal to the bit) and scipy's optimum (rtol
    ``MATCH_TOTAL_RTOL``); the kernel's time (CUDA events) beside the
    plain version's on the card and the host path it replaced (copy,
    scipy per item, copy back), with the bound by bytes;
44. the fused run (a main path): ``train_benchmark_fused`` on the flagship
    at phase 8's size (``ROOMS`` rooms, ``EPOCHS`` epochs) and
    ``train_benchmark`` on the same seed and rooms (both on the plateau
    rule, the fused run's whatever the config says; both on the fused
    run's AdamW, capturable): losses and learning
    rates within ``FUSED_RTOL``, the count sums and the best epoch equal;
    launch counts (the matcher once a step and twice a validation batch),
    both wall times; the per-epoch driver again on its default AdamW (its
    distance from the fused run printed, not held); the flagship's train
    step p50 with AdamW
    ``capturable`` (the fused run's) and with a float learning rate
    and host step count, in turns;
45. the profilers at the scale-up shape: ``tools/profile_scaleup2.py``
    (``--k PROFILE_K --kernels``) and ``tools/profile_scaleup.py``
    (``--reps PROFILE_REPS``), ``PROFILE_RUNS`` runs each, their JSON under
    ``build/``, each run's decomposition and each row's range over the
    runs printed, and one ``utils/profiling.device_trace`` of
    ``PROFILE_TRACE_STEPS`` train steps: the device's busy share;
46. the model-selection tools (a main path: the calibration forward on
    the card through #1), run right after phase 11 on phase 8's best
    checkpoint and the first ``TOOLS_ROOMS`` of its validation rooms, each
    card against CPU: (a) ``calibrate._forward_val_set`` at batch
    ``TOOLS_BATCH`` with 8 views x 3 temporal variants, #1's launches
    asserted (2 layers x 8 x 3 a batch), the arrays within ``TOOLS_TOL``,
    names and ground truth equal; (c) ``qscore.fit`` (``TOOLS_FIT_EPOCHS``
    epochs) weights within ``TOOLS_FIT_ATOL``, AUCs within ``TOOLS_TOL``,
    its weight file swept by (b); (b) ``calibrate.sweep`` over 16 cells
    touching every axis on (a)'s card and CPU arrays: the same cells in the
    same order, mAP and det_f1 within ``TOOLS_TOL`` and equal where the
    kept detections (recorded from ``post_process``) are the same, cells/s
    on both; (d) ``realbench.run`` over two directories with
    ``TOOLS_BOOTSTRAP`` resamples under (b)'s rule, then
    ``diagnose_zeroshot.diagnose`` on the card; the wall times beside the
    card's name and power limit;
47. the serving export (main paths), run right after phase 46:
    ``tools/export.py`` at the JAX tool's defaults (threshold 0.05, NMS
    0.1, extent 1.0, top-K 12, fusion, max_trace_len 3000), three exports
    at once: phase 8's best (#1) on the card in this process through
    ``export_checkpoint``, and through the CLI, each in a process of its
    own, the same checkpoint on the CPU and a seeded ``bigru`` at the CLI's
    defaults (#5, the unit kernel) on the card; each artifact loaded onto
    the card with ``load_exported`` and called once on the first validation
    trace, held to ``predict.run`` (keep and label columns equal, rows
    within ``EXPORT_TOL``) with one launch a layer of its kernel and
    nothing else; export seconds, artifact bytes, the p50 of the exported
    call beside ``predict.run`` (``EXPORT_CALLS`` synchronised calls each)
    and one profiled call of each (the flagship);
48. the live UDP path (a main path): loopback UDP probed, then
    ``data/ingest.py`` ``live(device="cuda")`` on phase 8's best, fed by
    ``replay --realtime`` of the first validation trace from a process of
    its own over ``LIVE_STREAM_S``; #1 asserted once a layer a refresh,
    no packet lost, the last refresh's rows held to ``build_predictor`` on
    the same rows (``LIVE_TOL``); the refresh times' spread while the trace
    streams and over ``LIVE_IDLE_CALLS`` at its full length.

Phases 10 (and 37's step), 16, 34 and 39's steps pin
``train.matmul_precision`` to float32: they compare two float32
computations (card and CPU, or kernels and plain versions). In-run
validation runs at the run's precision; no phase compares an in-run
validation loss card vs CPU (phase 8's resumed run holds the card's own
plateau step), so none needed a new pin.

Then a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from room_slam_torch import predictor as predictor_mod
from room_slam_torch import resolve_device
from room_slam_torch.config import ExperimentConfig
from room_slam_torch.data import formats
from room_slam_torch import demo
from room_slam_torch.data import synthetic
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.data.features import featurize
from room_slam_torch.data.legacy import LegacyArrays, create_sample_data
from room_slam_torch.data.rooms import write_legacy_rooms, write_rooms
from room_slam_torch.evaluate import (benchmark_rows, evaluate_benchmark,
                                      evaluate_legacy, load_legacy_model)
from room_slam_torch.models import gru as gru_mod
from room_slam_torch.models import lstm as lstm_mod
from room_slam_torch.models.factory import build_model
from room_slam_torch.models.common import MultiHeadAttention
from room_slam_torch.models.legacy_gru import RoomSlamGRU
from room_slam_torch.native import trace_parser
from room_slam_torch.ops import build, gru_cuda, hungarian, rnn_cuda
from room_slam_torch.ops import losses as losses_mod
from room_slam_torch.ops import rnn as rnn_ops
from room_slam_torch.ops.losses import legacy_criterion, legacy_match
from room_slam_torch.ops.nms import post_process
from room_slam_torch.ops.refine import y_planes_from_colliders
from room_slam_torch.ops.ttopt import TTOptParams
from room_slam_torch.predictor import build_predictor
from room_slam_torch.tools import calibrate as calibrate_tool
from room_slam_torch.tools import diagnose_zeroshot as diagnose_tool
from room_slam_torch.tools import parity as parity_tool
from room_slam_torch.tools import qscore as qscore_tool
from room_slam_torch.tools import realbench as realbench_tool
from room_slam_torch.train import checkpoint as ckpt_lib
from room_slam_torch.train import driver as driver_mod
from room_slam_torch.train import loop
from room_slam_torch.train.driver import (legacy_batches, legacy_data,
                                          legacy_optimizer, legacy_targets,
                                          load_model_for_inference,
                                          make_legacy_step,
                                          make_synthetic_datasets,
                                          train_benchmark,
                                          train_benchmark_fused, train_legacy)
from room_slam_torch.weights import load_params, random_params

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "flagship_v15.json"
# H100 SXM published peaks at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
KERNEL_ATOL = 1e-4   # on h, c and gates: f32 sum order over <= 1500 steps
GRAD_REL = 1e-4      # max abs error / max abs reference, the JAX suite's
MODEL_TOL = 1e-3     # rtol and atol on the model outputs (boxes in metres)
LOSS_RTOL = 1e-4     # card vs CPU train step: losses
# card vs CPU matching: the card's assignment priced with the CPU's costs
# (entries ~40, float32 ulp ~4e-6) may exceed the CPU's optimum only by
# rounding; a real mismatch costs O(1)
TIE_RTOL = 1e-5
PARAM_ATOL = 1e-5    # card vs CPU train step: updated parameters
BENCH, SERVE, RAGGED = (32, 500, 64), (1, 1500, 64), (5, 43, 64)
TRAIN = (20, 1500, 64)   # flagship batch_size, max_trace_len, d_model / 2
# the unit kernels' checks also run at a narrow H and at 17 rows, no
# multiple of a 2- or 4-row tile
NARROW, ODD = (5, 43, 16), (17, 300, 64)
LSTM_SHAPES = (BENCH, SERVE, TRAIN, RAGGED, NARROW, ODD)   # phases 3, 29
WIDE = (5, 43, 96)   # above the unit kernels' H <= 64: the BPTT's route
STEP_SHAPES = ((20, 1500), (32, 500))
ROOMS, EPOCHS = 40, 2        # seeded rooms (1 in 5 for validation), epochs
STEPS, STEP_WARMUP = 50, 5   # train steps timed per shape, after warm-up
# the scale-up bigru config (bench.py bench_scaleup): B, N, d_model / 2
SCALEUP = (128, 5000, 256)
SCALEUP_SETS = ("model.model_type=bigru", "model.d_model=512",
                "model.num_queries=32", "model.compute_dtype=bfloat16",
                "data.max_colliders=32")
GRU_SHAPES = ((SCALEUP, torch.bfloat16), ((16, 1000, 256), torch.float32),
              ((5, 43, 16), torch.float32), ((5, 43, 16), torch.bfloat16))
# phases 25 and 28: #10 on each kernel of #6's route (tc, unit, reg in bf16
# and f32, pipe), checked and timed beside #10's first design and #6
SPLIT_SHAPES = ((SCALEUP, torch.bfloat16), ((20, 1500, 64), torch.bfloat16),
                ((32, 500, 255), torch.bfloat16),
                ((32, 500, 255), torch.float32),
                ((32, 500, 512), torch.bfloat16))
# the tensor-core kernels' edges (bf16, both directions): a batch off the
# 16-row tiles, a narrow H the route takes (8-unit warps at C = 4 and 8;
# not H=64, which the route sends to the unit kernels) and the served
# request's batch of one row
TC_EDGE_SHAPES = (((17, 300, 256), torch.bfloat16),
                  ((5, 43, 128), torch.bfloat16),
                  ((1, 500, 256), torch.bfloat16))
BF16_RTOL, BF16_ATOL = 0.05, 0.03   # bf16 streams: values (the JAX suite's)
BF16_GRAD_REL = 0.1                 # bf16 streams: gradients, max-rel
# phase 29: rounds of the bf16 / fp16 library timing (3 until the register
# cluster kernels' timing was added to phase 33)
YARDSTICK_ROUNDS = 2
SCALEUP_TRAIN_ROOMS, SCALEUP_VAL_ROOMS = 96, 8   # x 4 rotations: 3 steps
SCALEUP_POINTS = (5000, 7500)       # walk length per room, before the cut
SCALEUP_REQUEST = 7500              # points of the served request
SCALEUP_PARITY_B = 8                # batch of the kernel-vs-plain step
SCALEUP_STEPS, SCALEUP_WARMUP = 10, 3   # bench_scaleup's own counts
# the legacy GRU surface (train_legacy's defaults): B, N, hidden_size / 2
LEGACY = (32, 500, 64)
SINGLE_GRU_SHAPES = ((LEGACY, torch.float32), (LEGACY, torch.bfloat16),
                     (SERVE, torch.float32), (TRAIN, torch.float32),
                     (RAGGED, torch.float32), (NARROW, torch.float32),
                     (NARROW, torch.bfloat16), (ODD, torch.float32),
                     (ODD, torch.bfloat16),
                     ((8, 1000, 256), torch.bfloat16))
SINGLE_LSTM_SHAPES = LSTM_SHAPES
LEGACY_ROOMS, LEGACY_POINTS = 40, (1500, 3000)   # about 180 windows of 500
LEGACY_EPOCHS = 2
LEGACY_THRESHOLD = 0.0       # every slot scored: mAP over a full ranking
LEGACY_STEPS, LEGACY_WARMUP = 50, 5
# the fused BiGRU layer (#9): B, N, H, D and stream dtype
# phases 31-34: the widths above the unit and wide kernels
CLUSTER_WIDTHS = (119, 128, 130, 192, 256)   # the LSTM cluster route
CLUSTER_BATCHES = (1, 5, 32)
OLD_CLUSTER_WIDTHS = {torch.float32: 130, torch.bfloat16: 256}
# phase 33: the register cluster kernels against the first cluster kernels
LSTM_REG_TIME = (((32, 500, 256), torch.float32),
                 ((32, 500, 256), torch.bfloat16),
                 ((1, 3000, 128), torch.float32))
REG_SWEEP_PLANS = 4   # register plans swept at LSTM_REG_TIME's first shape
CLUSTER_N = 300
# phase 32's widths, N and batches (CLUSTER_N and CLUSTER_BATCHES until the
# register cluster kernels took the GRU route and the masked slices became a
# forced plan's; widths 139, 201, 255 and the first even H no dividing plan
# fits until phase 42 joined)
MASKED_WIDTHS = (139,)
MASKED_N = 100
MASKED_BATCHES = (5,)
WIDE_TIME = (32, 500, 256)        # the new routes' timing (GRU: H=255)
WIDE_LSTM_D = 512                 # the wide lstm model's d_model (H=256)
WIDE_GRU = (8, 300, 139)          # the masked BiGRU / GRU paths
# phase 40: the bigru model's defaults on the unit kernels (#5 / #5t / #6
# timed at BIGRU_TIME f32 beside the first cluster design, the bf16 tc
# kernels against the unit kernels at BIGRU_BF16; the CLI's default step
# and request on BIGRU_ROOMS seeded rooms), and the pipe kernels above
# the cluster kernels' widths, forwards and BPTTs (checked at STREAM_WIDTHS
# x STREAM_BATCHES, N=STREAM_N, the first stream designs forced at
# STREAM_OLD; timed at STREAM_TIME beside the first stream design, cuDNN
# before and after the kernels; the lstm and bigru at d_model
# STREAM_LSTM_D, one step card vs CPU at STREAM_STEP's B, N, cut from 20,
# 1500 for the CPU's step; the lstm's and the bigru's step p50 at
# bench.py's B, N = STREAM_STEP_TIME over STREAM_STEPS after STREAM_WARMUP
# on STREAM_ROOMS rooms, and their served forward's p50 at STREAM_SERVE
# over STREAM_SERVE_CALLS after STREAM_WARMUP, the forwards on the pipe
# kernel and on the first stream design in turns)
BIGRU_TIME = ((20, 1500, 64), (1, 1500, 64))
BIGRU_BF16 = (20, 1500, 64)
BIGRU_ROOMS = 8
BIGRU_STEPS, BIGRU_WARMUP = 20, 3
BIGRU_REQUESTS = 20
STREAM_WIDTHS = (257, 320, 512)
STREAM_BATCHES = (1, 5, 32)
STREAM_N = 20
STREAM_TIME = ((32, 500, 320), (32, 500, 512))
# the pipe kernel's other instance families: blocks of more than four
# consumer warps (H 513-1024) and two k groups a thread (1025-2048), checked
# at PIPE_WIDTHS x PIPE_BATCHES (2048 by a forced plan: the route stops
# where the first stream design does, at 1816; the GPU tests take every
# STREAM_BATCHES) and timed at PIPE_TIME beside the first stream design
# (the H=1816 row, timed until the GRU register kernels' phase 41 joined,
# is in PERF.md); at every timed shape the card's first PIPE_SWEEP pipe
# plans (4 until then) are timed beside the planner's pick
PIPE_WIDTHS = (640, 1024, 1100, 2048)
PIPE_BATCHES = (5,)
PIPE_TIME = ((32, 500, 1024),)
PIPE_SWEEP = 2
# the GRU BPTT's pipe kernel (to H=1024) is checked on its route at
# STREAM_WIDTHS x STREAM_BATCHES and at the PIPE_WIDTHS it takes, under the
# card's first GRU_PIPE_PLANS plans at STREAM_OLD, and timed at STREAM_TIME
# and the PIPE_TIME it takes (1024) beside the first stream design (at
# H=320 also beside kLinear's cluster kernel)
GRU_PIPE_PLANS = 3
# the forwards' pipe kernels are also checked under the card's first
# FWD_PIPE_PLANS forward pipe plans at STREAM_OLD
FWD_PIPE_PLANS = 3
STREAM_OLD = (5, 512)
STREAM_LSTM_D = 1024
STREAM_STEP = (8, 300)
STREAM_STEP_TIME = (32, 500)
STREAM_STEPS, STREAM_WARMUP = 5, 2
STREAM_ROOMS = 8
STREAM_SERVE = (1, 1500)       # a served request's forward: B, N
STREAM_SERVE_CALLS = 10
# phase 41: the GRU register cluster kernels (#5/#5t, #7/#7t, #6 and #8 at
# H 65-256): the six wrappers on their route against the plain versions at
# REG_WIDTHS x REG_BATCHES (N=REG_N), float32 and bf16, both walk orders,
# the BPTT bit-equal run to run (bf16 two-direction launches the
# tensor-core kernels take are checked on the card's register pick,
# forced); the kernel A/B at REG_TIME (the kernels REG_TIME names: the
# route beside the first cluster design forced at its planner's pick and
# the pipe kernels forced at theirs, in turns, the card's first REG_SWEEP
# register plans beside the pick, cuDNN before and after; the plain
# versions timed at the first shape only); the bigru at d_model REG_GRU_D
# (H=256, f32): one step card vs CPU at REG_STEP's B, N, the step p50 at
# bench.py's B, N = REG_STEP_TIME and a served forward's p50 at REG_SERVE,
# each REG_STEPS after REG_WARMUP, on the register kernels and on the first
# cluster design in turns (new, first, first, new)
REG_WIDTHS = (65, 128, 139, 201, 255, 256)
REG_BATCHES = (1, 17)
REG_N = 24
REG_TIME = {(32, 500, 255): ("bigru_fwd", "bigru_fwd_train", "bigru_bwd",
                             "gru_fwd", "gru_fwd_train", "gru_bwd"),
            (128, 5000, 256): ("bigru_fwd", "bigru_fwd_train", "bigru_bwd"),
            (1, 1500, 128): ("bigru_fwd",)}
REG_SWEEP = 3
REG_GRU_D = 512
REG_STEP = (4, 120)
REG_STEP_TIME = (32, 500)
REG_SERVE = (1, 1500)
REG_STEPS, REG_WARMUP = 5, 2
REG_ROOMS = 8
# phase 42: the LSTM register cluster kernels at the wide kernels' widths,
# H 65-118 (#1/#1t, #3/#3t, #2 and #4): the six wrappers on their route
# against the plain versions at MID_WIDTHS x MID_BATCHES (N=MID_N), float32
# and bf16, both walk orders, the BPTT bit-equal run to run, then the wide
# kernel forced once at H=96; the card's resident clusters of every
# register plan at MID_RESIDENT_H; the kernel A/B at MID_TIME f32 (the
# register kernel at the card's pick beside the wide kernel, the first
# design, forced, in turns; the card's first MID_SWEEP register plans; the
# LSTM planner's pick beside the shared ranking's; cuDNN before and after;
# the plain versions held at every shape, timed at the first only); the
# planner's pick beside the shared ranking's at MID_TERMS; the lstm at
# d_model MID_LSTM_D (H=96, f32): one forward against the plain
# recurrence, one step card vs CPU at MID_STEP's B, N, the step p50 at
# bench.py's B, N = MID_STEP_TIME and a served forward's p50 at MID_SERVE
# (held to the plain recurrence), each MID_STEPS after MID_WARMUP, and a
# profiler trace of MID_TRACE_STEPS steps (MID_RANGED's calls in ranges),
# on the route and on the wide kernels in turns (new, wide, wide, new); the
# step p50 again at d_model MID_WIDE_D (H=116)
MID_WIDTHS = (65, 80, 96, 116, 117, 118)
MID_BATCHES = (1, 5, 17, 32)
MID_N = 24
MID_TIME = ((32, 500, 96), (32, 500, 116), (1, 1500, 96))
MID_SWEEP = 3
MID_RESIDENT_H = (96, 116)
MID_TERMS = ((1, 3000, 128), (32, 500, 160), (1, 1500, 160), (32, 500, 256))
MID_LSTM_D = 192
MID_WIDE_D = 232
MID_STEP = (8, 300)
MID_STEP_TIME = (32, 500)
MID_SERVE = (1, 1500)
MID_STEPS, MID_WARMUP = 5, 2
MID_TRACE_STEPS = 3
MID_RANGED = {"bilstm_fwd_train": (rnn_cuda, "bilstm_fwd_train"),
              "bilstm_bwd": (rnn_cuda, "bilstm_bwd")}
MID_ROOMS = 8
FUSED_SHAPES = (((3, 53, 16, 24), torch.float32),
                ((2, 40, 16, 16), torch.bfloat16),
                ((16, 1000, 256, 512), torch.bfloat16),
                ((5, 97, 32, 40), torch.bfloat16))
LSTM_BF16_SHAPES = LSTM_SHAPES   # bf16 BiLSTM kernel checks
# phases 35-37: the serving path's options, #1 at the test-time view
# batches, hole tokens
RECIPE_REQUESTS = 3                       # requests checked card vs CPU
# requests timed per recipe (7: 50 before phase 39 was added, 25 before
# the forward pipe kernels' timing joined phase 40, 13 before phases 47-48
# were added, cut to keep the whole run inside its time limit on a slow
# host)
RECIPE_WINDOW, RECIPE_WARMUP = 5, 2
GATE_TAU = 0.448                          # the adopted auto gates' tau
QSCORE_WEIGHTS = REPO / "results" / "r5_qscore_multi.json"
TTA_SHAPES = ((4, 1500, 64), (8, 1500, 64), (24, 1500, 64))
HOLE_TOKENS, HOLE_ROOMS = 8, 32
# phase 10: the config's matmul_precision ('bfloat16': TF32) against
# 'float32', one flagship step on the card; measured 8.3e-05 and 2.0e-02
# (NVIDIA H100 80GB HBM3, 700.00 W), inside the bf16 bounds (0.05, 0.1)
PRECISION_LOSS_RTOL = 1e-3
PRECISION_GRAD_REL = 5e-2
# phase 38: the flagship's frozen recipe (FINAL.md: --synthetic 2048
# --synthetic_mode mixed --mix_real DIR --mix_copies C --seed 100)
RECIPE_ROOMS, RECIPE_SEED = 2048, 100
RECIPE_CPU_ROOMS = 2           # per half, generated again on the CPU
RECIPE_REAL_ROOMS = 8          # make_rooms: 7 captures to mix in, 1 val
RECIPE_MIX_COPIES = 16
WALL_SLACK = 0.05              # the JAX suite's: inside the walls
DEMO_ROOMS, SAMPLE_TRACES = 3, 10
# phase 39: the transformer family at ModelConfig's width (d_model 128, 4
# heads, 3 + 3 layers, FFN 512, 30 queries) and the flagship's B=20,
# N=1500
TRANSFORMER_REQUESTS = 5                  # requests checked card vs CPU
TRANSFORMER_ROOMS = 10                    # make_rooms: 8 train rooms
TRANSFORMER_STEPS, TRANSFORMER_WARMUP = 30, 3
MOE_EXPERTS = 4
MOE_STEPS, MOE_WARMUP = 20, 3
PTH_MODELS = (("transformer", 128), ("lstm", 128), ("lstm", 256))
PTH_ROUTE = {128: "unit", 256: "reg"}  # #1's route at H = d_model / 2
PTH_REQUESTS = 5
ATTN_ITERS = 10                           # attention yardstick calls
PARITY_ROOMS = 20                         # make_rooms: 16 traces scored
PARITY_KW = dict(batch_size=8, iou_thresh=0.5, threshold=0.1, nms=0.3)
# phase 7's JSON stage measured with the Python parser before the native
# one (NVIDIA H100 80GB HBM3, 700.00 W)
PYTHON_PARSER_JSON_MS = 7.710
# phase 43: the matcher's cases (name, form, B, Q, M, share of valid
# columns), each on float and on integer costs; timing rounds
MATCH_CASES = (("flagship", "fast", 20, 30, 50, 0.3),
               ("scaleup", "fast", 128, 32, 32, 0.4),
               ("legacy", "square", 32, 10, 10, 0.5),
               ("m_over_q", "square", 8, 5, 9, 0.9))
MATCH_TOTAL_RTOL = 1e-5
MATCH_ITERS = 50
MATCH_HOST_ITERS = 10
# phase 44: the fused run against the per-epoch driver on one seed; the
# flagship step's p50 with AdamW capturable and not, in turns
FUSED_RTOL = 1e-5
ADAMW_STEPS, ADAMW_WARMUP = 20, 3
# phase 45: the profilers' depth (profile_scaleup2's default K, the
# --reps the JAX tool's decomposition took), runs of each, the traced steps
PROFILE_K = 8
PROFILE_REPS = 5
PROFILE_RUNS = 2
PROFILE_TRACE_STEPS = 3
# phase 46: the model-selection tools on phase 8's checkpoint and rooms
TOOLS_ROOMS = 2                 # phase 8's validation rooms the tools read
TOOLS_BATCH = 8                 # _forward_val_set's batch (the CLIs')
TOOLS_VIEWS = dict(tta=True, tta_reflect=True, tta_windows=2)  # 8 x 3
TOOLS_TTOPT = dict(steps=3, deadband=0.25)
TOOLS_FIT_EPOCHS = 200
TOOLS_FIT_IOU = 0.01            # phase 8's boxes barely overlap the GT
TOOLS_BOOTSTRAP = 200
TOOLS_TOL = 1e-3                # card vs CPU: forwards, mAP / det_f1, AUCs
TOOLS_FIT_ATOL = 1e-4           # card vs CPU: the quality fit's weights
# the seed offset of the large inputs' device generator (``stream_generator``)
STREAM_SEED = 10_000
GRU_PLAIN = {"bigru_fwd_cuda": gru_cuda.bigru_fwd_plain,
             "bigru_fwd_train_cuda": gru_cuda.bigru_fwd_train_plain,
             "bigru_bwd_cuda": gru_cuda.bigru_bwd_plain}


_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line: seconds since the script started, the phase's tag, the
    message."""
    print(f"{time.perf_counter() - _T0:7.1f} [{phase}] {msg}", flush=True)


# mangled-name parts of the kernels that phase 2 reports, by library
USAGE_KERNELS = {
    "bigru_fwd": {"bigru_fwd_tc": ("bigru_fwd_tc_kernel",),
                  "bigru_fwd_stream": ("bigru_fwd_kernel", "Lb1EE")},
    "bigru_bwd": {"bigru_bwd_tc": ("bigru_bwd_tc_kernel",),
                  "bigru_bwd_fused_bf16": ("bigru_bwd_kernel", "bfloat16Li2E"),
                  "bigru_bwd_fused_f32": ("bigru_bwd_kernel", "IfLi2E"),
                  "gru_bwd_unit_f32": ("gru_bwd_unit_kernel", "IfLi"),
                  "gru_bwd_unit_bf16": ("gru_bwd_unit_kernel", "bfloat16Li"),
                  "bigru_bwd_stream": ("bigru_bwd_kernel", "Li3EE")},
    "bilstm_bwd": {
        "bilstm_bwd_unit_f32": ("bilstm_bwd_unit_kernel", "IfLi"),
        "bilstm_bwd_unit_bf16": ("bilstm_bwd_unit_kernel", "bfloat16Li"),
        "bilstm_bwd_reg": ("bilstm_bwd_reg_kernel",),
        "bilstm_bwd_stream": ("bilstm_bwd_cluster_kernel", "Lb1EE")},
    "bilstm_pipe": {"bilstm_bwd_pipe": ("bilstm_bwd_pipe_kernel",)},
    "bigru_pipe": {"bigru_bwd_pipe": ("bigru_bwd_pipe_kernel",)},
    "bilstm_fwd_pipe": {"bilstm_fwd_pipe": ("bilstm_fwd_pipe_kernel",)},
    "bigru_fwd_pipe": {"bigru_fwd_pipe": ("bigru_fwd_pipe_kernel",)},
    "bilstm_fwd": {"bilstm_fwd_reg": ("bilstm_fwd_reg_kernel",),
                   "bilstm_fwd_stream": ("bilstm_fwd_cluster_kernel",
                                         "Lb1EE")},
    "bigru_fwd_reg": {"bigru_fwd_reg": ("bigru_fwd_reg_kernel",)},
    "bigru_bwd_reg": {"bigru_bwd_reg": ("bigru_bwd_reg_kernel",)}}
# the kernels that must spill nothing: the tensor-core BiGRU kernels (W_hh
# fragments and an input ring in registers), #9's bf16 kind (its products
# on tensor cores), the LSTM BPTT unit kernels (W_hh and an 8-step input
# ring in registers) and the forward pipe kernels (every instance: their
# accumulators in registers). The LSTM register cluster kernels are
# reported, not held: at two blocks an SM (128 registers) their 8-row
# tiles spill.
NO_SPILL = ("bigru_fwd_tc", "bigru_bwd_tc", "bigru_bwd_fused_bf16",
            "bilstm_bwd_unit_f32", "bilstm_bwd_unit_bf16", "bilstm_fwd_pipe",
            "bigru_fwd_pipe")
# and, of the GRU register cluster kernels (every instance reported), the
# instances that spilled nothing on an H100 when they were added (mangled
# template parts): the forward's float32 light variant, its 1- and 2-row
# tiles and its light 4-row tiles; the BPTT's 1-row tiles. The others (the
# training forward's 4- and 8-row tiles, bf16's light 8-row tile, the
# BPTT's 2- to 8-row tiles) spilled 8 to 68 bytes at 128 registers.
# The LSTM forward register kernel's instances with 12 k a lane (H <= 96)
# that spilled nothing when they were added: the 1- and 2-row tiles and the
# light 4-row tiles (the training 4-row tiles spilled 4 and 8 bytes).
# #10's instances (kSplitCoef, the last template flag true) that spilled
# nothing when they were added, each as #6's of the same tile: the unit
# kernels, the register BPTT's 1-row tiles, the pipe BPTT's narrow blocks
# and its wide ones of 1, 2 and 4 rows (the tensor-core ones: NO_SPILL).
NO_SPILL_PARTS = {"bigru_fwd_reg": ("IfLb0E", "Li1EE", "Li2EE",
                                    "Lb0ELi4EE"),
                  "bigru_bwd_reg": ("Li1ELb0EE", "Li1ELb1EE"),
                  "gru_bwd_unit_f32": ("Lb1EE",),
                  "gru_bwd_unit_bf16": ("Lb1EE",),
                  "bigru_bwd_pipe": ("Lb0ELb1EE", "Li1ELb1ELb1EE",
                                     "Li2ELb1ELb1EE", "Li4ELb1ELb1EE"),
                  "bilstm_fwd_reg": ("Li1ELi12EE", "Li2ELi12EE",
                                     "Lb0ELi4ELi12EE")}


def check_usage(lib: str, usage):
    """Phase 2: registers, stack and spills of the kernels of library
    ``lib`` named in ``USAGE_KERNELS`` from ``-Xptxas -v``; those of
    ``NO_SPILL`` and the instances ``NO_SPILL_PARTS`` names must spill
    nothing."""
    for key, parts in USAGE_KERNELS[lib].items():
        found = {name: u for name, u in usage.items()
                 if all(p in name for p in parts)}
        assert found, (key, sorted(usage))
        for name, u in sorted(found.items()):
            inst = name[name.index(parts[0]):][:48]   # kernel<T, R>'s part
            log("build", f"{key} ({inst}...): {u.get('registers')} "
                f"registers, {u.get('stack')} bytes stack, "
                f"{u.get('spill_stores')} / {u.get('spill_loads')} bytes "
                "spill stores / loads")
            if key in NO_SPILL or any(
                    p in name for p in NO_SPILL_PARTS.get(key, ())):
                assert u.get("spill_stores") == u.get("spill_loads") == 0, u


def timed_once(fn):
    """``fn()`` and its device time in ms, CUDA events around one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOP_PER_S):
    """Least time in ms for ``nbytes`` moved and ``flops`` operations at
    ``peak`` (f32 by default) on the card, and which of the two sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _item_peak(dtype: torch.dtype):
    """Bytes per stream value and the peak rate of the operand type."""
    if dtype == torch.bfloat16:
        return 2, PEAK_BF16_FLOP_PER_S
    return 4, PEAK_F32_FLOP_PER_S


def bilstm_bound(B: int, N: int, H: int, dirs: int = 2,
                 dtype: torch.dtype = torch.float32):
    """Light forward, ``dirs`` directions: xg read once, W_hh read once, ys
    written once; h @ W_hh, the xg add and the cell update."""
    item, peak = _item_peak(dtype)
    return bound(item * dirs * (B * N * 4 * H + H * 4 * H + B * N * H),
                 dirs * B * N * (2 * H * 4 * H + 4 * H + 5 * H), peak)


def fwd_train_bound(B: int, N: int, H: int, dirs: int = 2,
                    dtype: torch.dtype = torch.float32):
    """Training forward: as the light one, and c (H) and the activated
    gates (4H) written once per step."""
    item, peak = _item_peak(dtype)
    return bound(item * dirs * (B * N * (4 * H + H + H + 4 * H) + 4 * H * H),
                 dirs * B * N * (2 * H * 4 * H + 4 * H + 5 * H), peak)


def bwd_bound(B: int, N: int, H: int, dirs: int = 2,
              dtype: torch.dtype = torch.float32):
    """BPTT, ``dirs`` directions: gates (4H), c and dy (2H) read once, dg
    (4H) written once, W_hh read once; per (row, step) the 4H-deep dot
    product for each of H units and 25 operations per unit (coefficients,
    carries, tanh counted as one)."""
    item, peak = _item_peak(dtype)
    return bound(item * dirs * (B * N * (4 * H + 2 * H + 4 * H) + 4 * H * H),
                 dirs * B * N * (2 * 4 * H * H + 25 * H), peak)


GRU_COLS = {"fwd": 4, "fwd_train": 8, "bwd": 10}


def gru_bound(kind: str, B: int, N: int, H: int, dtype: torch.dtype,
              dirs: int = 2):
    """``dirs`` directions: per (row, step) the stream values each kernel
    must read and write (``fwd`` 3H in + H out; ``fwd_train`` also 3H + H
    of residuals out; ``bwd`` 3H + H + H + H in, 3H + H out), W_hh read
    once; operations: the h @ W_hh (dg @ W_hh^T) products, 2 * 3H * H per
    (row, step), at the peak of the operand type."""
    item = torch.finfo(dtype).bits // 8
    nbytes = dirs * (B * N * GRU_COLS[kind] * H + 3 * H * H) * item
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_F32_FLOP_PER_S
    return bound(nbytes, dirs * B * N * 2 * 3 * H * H, peak)


def fused_bound(B: int, N: int, H: int, D: int, dtype: torch.dtype):
    """#9, both directions: #6's streams, plus x read once and dX written
    once per direction (D each per row and step), W_ih read and the f32
    weight gradients written once; operations: the dg @ W_hh^T chain, dX =
    dx @ W_ih^T and dW_ih (2 * 3H * D each) and dW_hh (2 * 3H * H) per
    (row, step), at the peak of the operand type."""
    item, peak = _item_peak(dtype)
    nbytes = 2 * ((B * N * (GRU_COLS["bwd"] * H + 2 * D) + 3 * H * (H + D))
                  * item + ((D + H) * 3 * H + 6 * H) * 4)
    return bound(nbytes, 2 * B * N * 2 * 3 * H * (2 * H + 2 * D), peak)


def stream_generator(dev, seed):
    """The device generator of the large seeded inputs (gate streams,
    layer inputs): drawn on the card, where numpy takes seconds a tensor
    at the scale-up shape; a stream of its own (the upstream gradients
    draw from generators seeded ``seed`` and ``seed + 1``)."""
    return torch.Generator(dev).manual_seed(STREAM_SEED + seed)


def gru_inputs(B, N, H, dtype, dev, seed):
    """Seeded BiGRU kernel inputs: gate streams in ``dtype`` (N(0, 0.25),
    drawn on the device), W_hh and b_hh float32 U(+-1/sqrt(H))."""
    g = np.random.default_rng(seed)
    gen = stream_generator(dev, seed)
    xs = [(torch.randn(B, N, 3 * H, device=dev, generator=gen) * 0.5
           ).to(dtype) for _ in range(2)]
    ws = [torch.tensor(g.uniform(-1, 1, size=sz) / np.sqrt(H),
                       dtype=torch.float32, device=dev)
          for sz in ((H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    return [*xs, *ws]


def gru_bwd_inputs(ins, seed):
    """``bigru_bwd``'s arguments on the plain training forward's residuals
    of ``ins``, with a seeded upstream gradient in the stream dtype."""
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train_plain(*ins)
    g = torch.Generator(ins[0].device).manual_seed(seed)
    dy_f, dy_b = (torch.randn(ys_f.shape, device=ys_f.device, generator=g
                              ).to(ys_f.dtype) for _ in range(2))
    return ins[2], ins[4], gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b


def value_err(got, ref, dtype) -> float:
    """Max abs error over output pairs; asserts the tolerance of ``dtype``
    (f32: ``KERNEL_ATOL``; bf16: rtol ``BF16_RTOL`` / atol ``BF16_ATOL``)."""
    err = 0.0
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all()
        a, b = a.float(), b.float()
        err = max(err, (a - b).abs().max().item())
        if dtype == torch.bfloat16:
            assert torch.allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL), \
                (a - b).abs().max().item()
    if dtype == torch.float32:
        assert err <= KERNEL_ATOL, err
    return err


def plan_text(fn) -> str:
    p = fn.last_launch
    return (f"{p['kernel']} kernel, cluster {p['cluster']} x rows "
            f"{p['rows']}, {p['clusters']} clusters, {p['resident']} "
            "resident")


def plan_key(plan) -> str:
    """A launch plan as text: "unit x1", "wide x4", "cluster 1x4", "tc
    4x16", "reg 16x8"; a BiGRU wrapper's ``(cluster, rows)`` is the cluster
    kernel's."""
    if isinstance(plan[0], int):
        return f"cluster {plan[0]}x{plan[1]}"
    if plan[0] in ("cluster", "tc", "reg"):
        return f"{plan[0]} {plan[1]}x{plan[2]}"
    return f"{plan[0]} x{plan[1]}"


def lstm_plans(B, H, dev, dtype, save, dirs):
    """Every forward plan of ``csrc/bilstm_fwd.cu`` at this shape: the unit
    kernel's tiles the card runs (the planner's order) and the wide kernel
    (the first design)."""
    return [*(("unit", r) for r in rnn_cuda.card_lstm_unit_plans(
        B, H, dev, dtype, save, dirs)), ("wide", 4)]


def lstm_bwd_plans(B, H, dev, dtype, dirs):
    """Every BPTT plan of ``csrc/bilstm_bwd.cu`` at this shape: the unit
    kernel's tiles the card runs (the planner's order) and the wide kernel
    (the first design)."""
    return [*(("unit", r) for r in rnn_cuda.card_lstm_bwd_unit_plans(
        B, H, dev, dtype, dirs)), ("wide", 4)]


def gru_single_plans(B, H, dev, dtype, save):
    """Every one-direction forward plan of ``csrc/bigru_fwd.cu`` at this
    shape: the unit kernel's tiles the card runs (the planner's order) and
    the cluster kernel at its planner's pick (the first design)."""
    c, r = gru_cuda.card_plans("fwd", B, H, dev, dtype, dirs=1)[0]
    return [*(("unit", t) for t in gru_cuda.card_gru_unit_plans(
        B, H, dev, dtype, save)), ("cluster", c, r)]


def gru_bwd_plans(B, H, dev, dtype):
    """Every one-direction BPTT plan of ``csrc/bigru_bwd.cu`` at this
    shape: the unit kernel's tiles the card runs (the planner's order) and
    kLinear at its planner's pick (the first design)."""
    c, r = gru_cuda.card_plans("bwd", B, H, dev, dtype, dirs=1)[0]
    return [*(("unit", t) for t in gru_cuda.card_gru_bwd_unit_plans(
        B, H, dev, dtype)), ("cluster", c, r)]


def plan_sweep(name, fn, args, plans, shape, iters):
    """Phases 4, 19, 29 and 33: µs per step of ``fn(*args, plan=p)`` at
    ``shape``
    (B, N, H) for every plan, CUDA events over ``iters`` launches each, then
    one launch without a plan; returns the times, the planner's pick and
    the fastest plan."""
    N = shape[1]
    us = {plan_key(p): cuda_ms(lambda: fn(*args, plan=p), iters) / N * 1e3
          for p in plans}
    fn(*args)
    last = fn.last_launch
    pick = plan_key((last["kernel"], last["cluster"], last["rows"])
                    if last["kernel"] in ("cluster", "tc", "reg")
                    else (last["kernel"], last["rows"]))
    fastest = min(us, key=us.get)
    dtype = next(a.dtype for a in args if a.dim() == 3)   # the streams'
    log("plan_sweep", f"{name} B,N,H={shape} {str(dtype)[6:]}: us "
        "per step " + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
        + f"; planner's pick {pick}, fastest {fastest}")
    return {"us_per_step": us, "pick": pick, "fastest": fastest}


def gru_route(shape, dtype):
    """The kernel a two-direction BiGRU launch at ``shape`` takes ("tc",
    "unit" or "reg", the forward's and the BPTT's routes agreeing)."""
    H = shape[2]
    route = gru_cuda.gru_fwd_kernel_route(H, 2, dtype)
    assert gru_cuda.gru_bwd_kernel_route(H, 2, dtype) == route, shape
    return route


def check_tc_plans(shape, ins, args, refs):
    """Phase 12 at a shape the tensor-core kernels take: the three kernels
    under every tc plan the card runs against the plain versions' outputs
    ``refs`` (values at the bf16 bound, the BPTT max-rel); returns the
    worst error of each kernel by plan."""
    B, _, H = shape
    out = {}
    for name, fn, a, ref in (
            ("bigru_fwd", gru_cuda.bigru_fwd_cuda, ins, refs[0]),
            ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda, ins, refs[1]),
            ("bigru_bwd", gru_cuda.bigru_bwd_cuda, args, refs[2])):
        kind = name[len("bigru_"):]
        for c, r in gru_cuda.card_tc_plans(kind, B, H, a[0].device):
            got = fn(*a, plan=("tc", c, r))
            assert fn.last_launch["kernel"] == "tc"
            assert (fn.last_launch["cluster"], fn.last_launch["rows"]) == (c, r)
            if kind == "bwd":
                err, rel = bwd_errs(got, ref)
                assert rel <= BF16_GRAD_REL, (shape, c, r, rel)
                err = rel
            else:
                err = value_err(got, ref, torch.bfloat16)
            out.setdefault(name, {})[f"tc {c}x{r}"] = err
            del got
    return out


def check_gru_kernels(dev, seed):
    """Phase 12: the three BiGRU kernels against their plain versions and
    ``BiGRUFunction``'s six gradients against torch autograd through the
    plain loop, at ``GRU_SHAPES`` and ``TC_EDGE_SHAPES``; at the shapes the
    tensor-core kernels take also under every tc plan the card runs. Each
    launch records the kernel its route names ("tc" for bf16 streams where
    the rule holds, "unit" at H <= 64, else "reg"). Returns errors by
    (shape, dtype)."""
    errs = {}
    for shape, dtype in (*GRU_SHAPES, *TC_EDGE_SHAPES):
        route = gru_route(shape, dtype)
        ins = gru_inputs(*shape, dtype, dev, seed)
        plain_ms = {}
        light_ref, plain_ms["bigru_fwd"] = timed_once(
            lambda: gru_cuda.bigru_fwd_plain(*ins))
        light_err = value_err(gru_cuda.bigru_fwd_cuda(*ins), light_ref, dtype)
        plans = {"bigru_fwd": plan_text(gru_cuda.bigru_fwd_cuda)}
        train_ref, plain_ms["bigru_fwd_train"] = timed_once(
            lambda: gru_cuda.bigru_fwd_train_plain(*ins))
        train_err = value_err(gru_cuda.bigru_fwd_train_cuda(*ins), train_ref,
                              dtype)
        plans["bigru_fwd_train"] = plan_text(gru_cuda.bigru_fwd_train_cuda)
        args = gru_bwd_inputs(ins, seed + 1)
        got = gru_cuda.bigru_bwd_cuda(*args)
        plans["bigru_bwd"] = plan_text(gru_cuda.bigru_bwd_cuda)
        ref, plain_ms["bigru_bwd"] = timed_once(
            lambda: gru_cuda.bigru_bwd_plain(*args))
        torch.cuda.synchronize()
        for fn in (gru_cuda.bigru_fwd_cuda, gru_cuda.bigru_fwd_train_cuda,
                   gru_cuda.bigru_bwd_cuda):
            assert fn.last_launch["kernel"] == route, (shape, dtype, route)
        assert all(torch.isfinite(a).all() for a in got), shape
        bwd_abs = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, ref))
        bwd_rel = max(max_rel(a.float(), b.float()) for a, b in zip(got, ref))
        del got
        tc_errs = (check_tc_plans(shape, ins, args, (light_ref, train_ref,
                                                     ref))
                   if route == "tc" else {})
        del light_ref, train_ref, ref
        x = [t.clone().requires_grad_(True) for t in ins]
        dys = [args[5], args[9]]
        grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
        ref_grads = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
        fn_rel = {name: max_rel(a.float(), b.float()) for name, a, b in zip(
            ("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"), grads,
            ref_grads)}
        del x, grads, ref_grads, args
        key = (shape, dtype)
        errs[key] = {"fwd": light_err, "fwd_train": train_err,
                     "bwd_abs": bwd_abs, "bwd_rel": bwd_rel,
                     "function_rel": fn_rel, "tc_plans": tc_errs,
                     "plain_ms": plain_ms}
        rel_tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
        tol = (f"tol {KERNEL_ATOL:.0e}" if dtype == torch.float32 else
               f"tol rtol {BF16_RTOL} atol {BF16_ATOL}")
        log("kernel_check",
            f"B,N,H={shape} {str(dtype)[6:]}: bigru_fwd ys max_abs_err="
            f"{light_err:.3e}, bigru_fwd_train (ys, gates, hn) max_abs_err="
            f"{train_err:.3e} ({tol}); bigru_bwd (dx, dhn) max_abs_err="
            f"{bwd_abs:.3e} max_rel_err={bwd_rel:.3e} tol {rel_tol:g}; "
            "BiGRUFunction vs autograd through the plain loop max_rel_err "
            + " ".join(f"{k}={v:.3e}" for k, v in fn_rel.items())
            + "; launches: " + "; ".join(f"{k} {v}" for k, v in plans.items())
            + (("; every tc plan (fwd, fwd_train: max abs err; bwd: "
                "max-rel err) " + json.dumps(tc_errs)) if tc_errs else ""))
        assert bwd_rel <= rel_tol, (shape, bwd_rel)
        assert max(fn_rel.values()) <= rel_tol, (shape, fn_rel)
    return errs


def bigru_plans(name, B, H, dev, dtype):
    """Every two-direction plan of BiGRU wrapper ``name`` at this batch and
    H: the tensor-core kernel's plans the card runs (the planner's order)
    and the cluster kernel at its planner's pick (the first design)."""
    kind = name[len("bigru_"):]
    src = "bwd" if kind == "bwd" else "fwd"
    return [*(("tc", c, r) for c, r in gru_cuda.card_tc_plans(kind, B, H,
                                                               dev)),
            gru_cuda.card_plans(src, B, H, dev, dtype)[0]]


def time_gru_kernels(dev, seed, errs):
    """Phase 13: each BiGRU kernel at the scale-up shape in bf16, its plain
    version (the one call phase 12 timed), torch ``nn.GRU`` (bidirectional, bf16, its input projection
    included; never called by the port) and the bound; then each kernel
    under every plan (the tensor-core kernel's and the cluster kernel at
    its planner's pick) at the scale-up shape and at the served request's
    batch of one row."""
    B, N, H = SCALEUP
    dtype = torch.bfloat16
    ins = gru_inputs(B, N, H, dtype, dev, seed)
    args = gru_bwd_inputs(ins, seed + 1)
    lib = torch.nn.GRU(2 * H, H, batch_first=True, bidirectional=True).to(
        dev, dtype)
    x = torch.randn(B, N, 2 * H, device=dev, dtype=dtype, requires_grad=True,
                    generator=torch.Generator(dev).manual_seed(seed))
    dy = torch.randn(B, N, 2 * H, device=dev, dtype=dtype,
                     generator=torch.Generator(dev).manual_seed(seed))
    cudnn = torch.backends.cudnn.is_acceptable(x)
    lib_ms = {}
    # cuDNN takes no bf16 RNN (is_acceptable), so nn.GRU in bf16 runs
    # PyTorch's own step loop; cuDNN in fp16 (same bytes per value) is timed
    # beside it
    for key, dt in (("bf16", dtype), ("cudnn_fp16", torch.float16)):
        m = lib.to(dt)
        m.flatten_parameters()
        xi = x.detach().to(dt).requires_grad_(True)
        dyi = dy.to(dt)
        with torch.no_grad():
            light = cuda_ms(lambda: m(xi), 3, warmup=1)
        fwd = cuda_ms(lambda: m(xi), 3, warmup=1)
        fb = cuda_ms(lambda: m(xi)[0].backward(dyi), 3, warmup=1)
        lib_ms[key] = {"bigru_fwd": light, "bigru_fwd_train": fwd,
                       "bigru_bwd": fb - fwd}
    err = errs[(SCALEUP, dtype)]
    rows = {}
    for name, fn, a, e in (
            ("bigru_fwd", gru_cuda.bigru_fwd_cuda, ins, err["fwd"]),
            ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda, ins,
             err["fwd_train"]),
            ("bigru_bwd", gru_cuda.bigru_bwd_cuda, args, err["bwd_abs"])):
        ms = cuda_ms(lambda: fn(*a), 3, warmup=1)
        b = gru_bound(name[len("bigru_"):], B, N, H, dtype)
        rows[name] = {"shape": [B, N, H], "dtype": "bfloat16",
                      "kernel_ms": ms, "plain_ms": err["plain_ms"][name],
                      "library_ms": lib_ms["bf16"][name],
                      "cudnn_fp16_ms": lib_ms["cudnn_fp16"][name],
                      "bound_us": b[0] * 1e3,
                      "bound_by": b[1], "us_per_step": ms / N * 1e3,
                      "err": e, "launch": dict(fn.last_launch)}
        rows[name]["plans"] = plan_sweep(
            name, fn, a, bigru_plans(name, B, H, dev, dtype), (B, N, H), 3)
        log("kernel_time", f"{name} " + json.dumps(rows[name]) + (
            "  (library_ms: nn.GRU bidirectional bf16, "
            f"cudnn.is_acceptable={cudnn}; cudnn_fp16_ms: the same in fp16 "
            "through cuDNN; both "
            + {"bigru_fwd": "forward without grad",
               "bigru_fwd_train": "forward with grad on",
               "bigru_bwd": "forward + backward minus forward"}[name]
            + ", includes the input projection)"))
    del ins, args
    # the served request's batch: one row, the planner's pick among the
    # same plans
    ins = gru_inputs(1, N, H, dtype, dev, seed)
    args = gru_bwd_inputs(ins, seed + 1)
    for name, fn, a in (("bigru_fwd", gru_cuda.bigru_fwd_cuda, ins),
                        ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda,
                         ins),
                        ("bigru_bwd", gru_cuda.bigru_bwd_cuda, args)):
        rows[name]["plans_b1"] = plan_sweep(
            name, fn, a, bigru_plans(name, 1, H, dev, dtype), (1, N, H), 3)
    return rows


def hidden_grads_f32(ys, dx, dhn, reverse):
    """``hidden_grads`` as the port ran it before: the bf16 streams upcast
    to float32 copies, float32 products (TF32 off)."""
    H = ys.shape[-1]
    f32 = torch.float32
    hp = rnn_cuda.prev_steps(ys, reverse).reshape(-1, H).to(f32)
    d2 = dx[..., :2 * H].reshape(-1, 2 * H).to(f32)
    dn = dhn.reshape(-1, H).to(f32)
    return (torch.cat([hp.t() @ d2, hp.t() @ dn], dim=-1),
            torch.cat([d2.sum(0), dn.sum(0)]))


def time_hidden_grads(dev, seed):
    """Phase 13, last: dW_hh and db_hh of one direction and layer
    (``gru_cuda.hidden_grads``, four per scale-up step) at the scale-up
    shape from bf16 residuals, as the port runs them (bf16 operands, float32
    sums and result) beside the float32 products of upcast copies (the
    port's products before, TF32 off), the two held to max-rel 1e-4."""
    B, N, H = SCALEUP
    g = torch.Generator(dev).manual_seed(seed)
    ys, dhn = (torch.randn(B, N, H, device=dev, generator=g).bfloat16()
               for _ in range(2))
    dx = torch.randn(B, N, 3 * H, device=dev, generator=g).bfloat16()
    got = gru_cuda.hidden_grads(ys, dx, dhn, False, torch.float32)
    ref = hidden_grads_f32(ys, dx, dhn, False)
    rel = [max_rel(a, r) for a, r in zip(got, ref)]
    assert all(a.dtype == torch.float32 for a in got)
    assert max(rel) <= 1e-4, rel
    row = {"shape": [B, N, H],
           "ms": cuda_ms(lambda: gru_cuda.hidden_grads(
               ys, dx, dhn, False, torch.float32), 10, warmup=3),
           "f32_ms": cuda_ms(lambda: hidden_grads_f32(ys, dx, dhn, False),
                             10, warmup=3),
           "max_rel_err": rel}
    log("kernel_time", "hidden_grads (dW_hh, db_hh of one direction and "
        "layer, outside the kernels; ms: bf16 operands, f32 sums, as the "
        "port runs them; f32_ms: the f32 products of upcast copies) "
        + json.dumps(row))
    return row


def kernel_inputs(B, N, H, dev, seed):
    g = np.random.default_rng(seed)
    arrs = [g.normal(size=(B, N, 4 * H)) * 0.5,
            g.normal(size=(B, N, 4 * H)) * 0.5,
            g.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H),
            g.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H)]
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def bwd_inputs(ins, seed):
    """The BPTT kernel's arguments on the plain training forward's
    residuals of ``ins``, with a seeded upstream gradient."""
    ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = rnn_cuda.bilstm_fwd_train_plain(*ins)
    g = torch.Generator(ins[0].device).manual_seed(seed)
    dy_f = torch.randn(ys_f.shape, device=ys_f.device, generator=g)
    dy_b = torch.randn(ys_b.shape, device=ys_b.device, generator=g)
    return ins[2], ins[3], gs_f, cs_f, dy_f, gs_b, cs_b, dy_b


def max_rel(a, b) -> float:
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def walk(n: int, seed: int) -> np.ndarray:
    """Seeded room walk: ``[n, 4]`` (x, y, z, t) at 30 Hz."""
    g = np.random.default_rng(seed)
    heading = np.cumsum(g.normal(scale=0.15, size=n))
    step = 0.04 * np.stack([np.cos(heading), np.sin(heading)], -1)
    xz = np.clip(np.cumsum(step, 0), -3.0, 3.0)
    y = 1.6 + 0.02 * g.standard_normal(n)
    t = np.arange(n) / 30.0
    return np.stack([xz[:, 0], y, xz[:, 1], t], -1).astype(np.float32)


def collider_values(c):
    return [c["confidence"], *c["center"].values(), *c["size"].values()]


WRAPPERS = {"bilstm_fwd": (rnn_cuda, "bilstm_fwd_cuda"),
            "bilstm_fwd_train": (rnn_cuda, "bilstm_fwd_train_cuda"),
            "bilstm_bwd": (rnn_cuda, "bilstm_bwd_cuda"),
            "bigru_fwd": (gru_cuda, "bigru_fwd_cuda"),
            "bigru_fwd_train": (gru_cuda, "bigru_fwd_train_cuda"),
            "bigru_bwd": (gru_cuda, "bigru_bwd_cuda"),
            "gru_fwd": (gru_cuda, "gru_fwd_cuda"),
            "gru_fwd_train": (gru_cuda, "gru_fwd_train_cuda"),
            "gru_bwd": (gru_cuda, "gru_bwd_cuda"),
            "lstm_fwd": (rnn_cuda, "lstm_fwd_cuda"),
            "lstm_fwd_train": (rnn_cuda, "lstm_fwd_train_cuda"),
            "lstm_bwd": (rnn_cuda, "lstm_bwd_cuda"),
            "bigru_bwd_split": (gru_cuda, "bigru_bwd_split_cuda"),
            "bigru_bwd_fused": (gru_cuda, "bigru_bwd_fused_cuda")}


def counts():
    return {k: getattr(mod, fn).launches for k, (mod, fn) in WRAPPERS.items()}


def reset_counts() -> None:
    for mod, fn in WRAPPERS.values():
        getattr(mod, fn).launches = 0


def expected_counts(**launched):
    """Every wrapper's count: the given ones, zero for the rest."""
    return {k: launched.get(k, 0) for k in WRAPPERS}


def check_training_kernels(dev, seed):
    """Phase 3 for the training kernels; returns per-shape errors."""
    errs = {}
    for shape in LSTM_SHAPES:
        ins = kernel_inputs(*shape, dev, seed)
        got = rnn_cuda.bilstm_fwd_train_cuda(*ins)
        ref = rnn_cuda.bilstm_fwd_train_plain(*ins)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in got), shape
        fwd_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        args = bwd_inputs(ins, seed + 1)
        dg = rnn_cuda.bilstm_bwd_cuda(*args)
        launch = plan_text(rnn_cuda.bilstm_bwd_cuda)
        # H <= 64 (the flagship's H=64): the BPTT's unit kernel
        assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "unit", \
            launch
        dg_ref = rnn_cuda.bilstm_bwd_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in dg), shape
        bwd_abs = max((a - b).abs().max().item() for a, b in zip(dg, dg_ref))
        bwd_rel = max(max_rel(a, b) for a, b in zip(dg, dg_ref))
        plan_rel = {}
        for plan in lstm_bwd_plans(shape[0], shape[2], dev, torch.float32,
                                   2):
            got = rnn_cuda.bilstm_bwd_cuda(*args, plan=plan)
            assert all(torch.isfinite(a).all() for a in got), plan
            plan_rel[plan_key(plan)] = max(max_rel(a, b)
                                           for a, b in zip(got, dg_ref))
        x = [t.clone().requires_grad_(True) for t in ins]
        ys = rnn_cuda.bilstm_recurrence(*x)
        dys = [args[4], args[7]]
        grads = torch.autograd.grad(ys, x, dys)
        ref_grads = torch.autograd.grad(
            rnn_cuda.bilstm_recurrence_plain(*x), x, dys)
        fn_rel = {name: max_rel(a, b) for name, a, b in zip(
            ("dxg_f", "dxg_b", "dW_f", "dW_b"), grads, ref_grads)}
        errs[shape] = {"fwd_train": fwd_err, "bwd_abs": bwd_abs,
                       "bwd_rel": bwd_rel, "function_rel": fn_rel,
                       "bwd_plan_rel": plan_rel}
        log("kernel_check",
            f"bilstm_fwd_train B,N,H={shape} max_abs_err(ys,c,gates)="
            f"{fwd_err:.3e} tol={KERNEL_ATOL:.0e}; bilstm_bwd dg max_abs_err="
            f"{bwd_abs:.3e} max_rel_err={bwd_rel:.3e} tol={GRAD_REL:.0e} "
            f"(launch {launch}; every plan max_rel_err "
            + ", ".join(f"{k} {v:.3e}" for k, v in plan_rel.items())
            + "); BiLSTMFunction vs autograd through the plain loop "
            "max_rel_err " + " ".join(f"{k}={v:.3e}" for k, v in
                                      fn_rel.items()))
        assert fwd_err <= KERNEL_ATOL, (shape, fwd_err)
        assert bwd_rel <= GRAD_REL, (shape, bwd_rel)
        assert max(plan_rel.values()) <= GRAD_REL, (shape, plan_rel)
        assert max(fn_rel.values()) <= GRAD_REL, (shape, fn_rel)
    check_wide_bwd(dev, seed)
    return errs


def check_wide_bwd(dev, seed):
    """Phase 3, last: the BPTT at ``WIDE`` (H above the unit kernel's 64)
    on its route, the register cluster kernel (asserted), both directions
    and one direction in both walk orders, then both directions on the
    wide kernel (the first design) forced, against the plain versions."""
    args = bwd_inputs(kernel_inputs(*WIDE, dev, seed), seed + 1)
    ref = rnn_cuda.bilstm_bwd_plain(*args)
    rel = {"bilstm_bwd": max(max_rel(a, b) for a, b in zip(
        rnn_cuda.bilstm_bwd_cuda(*args), ref))}
    assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "reg"
    launch = plan_text(rnn_cuda.bilstm_bwd_cuda)
    for rev, w, streams, r in ((False, args[0], args[2:5], ref[0]),
                               (True, args[1], args[5:8], ref[1])):
        got = rnn_cuda.lstm_bwd_cuda(w, *streams, rev)
        assert rnn_cuda.lstm_bwd_cuda.last_launch["kernel"] == "reg"
        rel[f"lstm_bwd reverse={rev}"] = max_rel(got, r)
    rel["bilstm_bwd wide, forced"] = max(max_rel(a, b) for a, b in zip(
        rnn_cuda.bilstm_bwd_cuda(*args, plan=("wide", 4)), ref))
    assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "wide"
    torch.cuda.synchronize()
    log("kernel_check", f"BPTT above the unit kernel B,N,H={WIDE} "
        "max_rel_err " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" tol={GRAD_REL:.0e}; launch {launch}")
    assert max(rel.values()) <= GRAD_REL, rel


def time_training_kernels(dev, seed, errs):
    """Phase 4 for the training kernels; returns one row per kernel and
    shape."""
    rows = {"bilstm_fwd_train": [], "bilstm_bwd": []}
    for shape, iters in ((BENCH, 20), (TRAIN, 10)):
        B, N, H = shape
        ins = kernel_inputs(*shape, dev, seed)
        args = bwd_inputs(ins, seed + 1)
        fwd_ms = cuda_ms(lambda: rnn_cuda.bilstm_fwd_train_cuda(*ins), iters)
        fwd_plain = cuda_ms(lambda: rnn_cuda.bilstm_fwd_train_plain(*ins),
                            2, warmup=1)
        bwd_ms = cuda_ms(lambda: rnn_cuda.bilstm_bwd_cuda(*args), iters)
        bwd_plain = cuda_ms(lambda: rnn_cuda.bilstm_bwd_plain(*args), 2,
                            warmup=1)
        lib = torch.nn.LSTM(2 * H, H, batch_first=True,
                            bidirectional=True).to(dev)
        x = torch.randn(B, N, 2 * H, device=dev, requires_grad=True,
                        generator=torch.Generator(dev).manual_seed(seed))
        dy = torch.randn(B, N, 2 * H, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
        lib_fwd = cuda_ms(lambda: lib(x), iters)
        lib_fb = cuda_ms(lambda: lib(x)[0].backward(dy), iters)
        for name, ms, plain, b, lib_ms in (
                ("bilstm_fwd_train", fwd_ms, fwd_plain,
                 fwd_train_bound(*shape), lib_fwd),
                ("bilstm_bwd", bwd_ms, bwd_plain, bwd_bound(*shape),
                 lib_fb - lib_fwd)):
            row = {"shape": list(shape), "kernel_ms": ms, "plain_ms": plain,
                   "library_ms": lib_ms, "bound_us": b[0] * 1e3,
                   "bound_by": b[1], "us_per_step": ms / N * 1e3,
                   "library_us_per_step": lib_ms / N * 1e3,
                   "err": (errs[shape]["fwd_train"]
                           if name == "bilstm_fwd_train"
                           else errs[shape]["bwd_abs"])}
            fn, a, plans = {
                "bilstm_fwd_train": (
                    rnn_cuda.bilstm_fwd_train_cuda, ins,
                    lstm_plans(B, H, dev, torch.float32, True, 2)),
                "bilstm_bwd": (rnn_cuda.bilstm_bwd_cuda, args,
                               lstm_bwd_plans(B, H, dev, torch.float32, 2))
            }[name]
            row["plans"] = plan_sweep(name, fn, a, plans, shape, iters)
            row["launch"] = dict(fn.last_launch)
            rows[name].append(row)
            log("kernel_time", f"{name} " + json.dumps(row) + (
                "  (library_ms: cuDNN bidirectional nn.LSTM forward with "
                "grad on" if name == "bilstm_fwd_train" else
                "  (library_ms: cuDNN bidirectional nn.LSTM forward + "
                "backward minus forward") + ", includes the input projection)")
    return rows


def make_rooms(root: Path, n_rooms: int, seed: int):
    """``n_rooms`` seeded rooms, one in five for validation."""
    n_val = max(n_rooms // 5, 1)
    write_rooms(root / "train", n_rooms - n_val, seed)
    write_rooms(root / "val", n_val, seed + 1)
    return root / "train", root / "val"


def train_main_path(cfg, train_dir, val_dir, save_dir, epochs, dev, smi,
                    prefix="bilstm"):
    """Phases 8 and 14: the trainer on the card, launch counts read around
    it: two training forwards and two BPTT launches of the ``prefix``
    kernels per step, light launches only in validation, nothing else."""
    cfg = copy.deepcopy(cfg)
    cfg.data.data_dir, cfg.data.val_dir = str(train_dir), str(val_dir)
    cfg.train.num_epochs = epochs
    cfg.train.save_dir = str(save_dir)
    train_ds = TraceColliderArrays(train_dir, cfg.data, augment=True,
                                   verbose=False)
    val_ds = TraceColliderArrays(val_dir, cfg.data, augment=False,
                                 verbose=False)
    steps = epochs * train_ds.num_batches(cfg.train.batch_size)
    val_batches = epochs * val_ds.num_batches(cfg.train.batch_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_benchmark(cfg, device=dev, verbose=True, train_ds=train_ds,
                          val_ds=val_ds, checkpoint_every=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.model.lstm_layers
    assert launched == expected_counts(**{
        f"{prefix}_fwd": layers * val_batches,
        f"{prefix}_fwd_train": layers * steps,
        f"{prefix}_bwd": layers * steps}), launched
    bwd_plan = plan_text(getattr(*WRAPPERS[f"{prefix}_bwd"]))
    if prefix == "bilstm":   # the flagship's H=64: the BPTT's unit kernel
        assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "unit", \
            bwd_plan
    else:   # the scale-up's bf16 streams: the tensor-core kernels
        assert_tc("bigru_fwd", "bigru_fwd_train", "bigru_bwd")
    assert len(res["history"]) == epochs
    for row in res["history"]:
        assert np.isfinite(row["train_loss"]) and \
            np.isfinite(row["val_loss"]), row
    best = Path(save_dir) / "best_model"
    assert best.with_suffix(".msgpack").exists()
    assert json.loads(best.with_suffix(".json").read_text())[
        "has_opt_state"] is True
    log("train", f"{cfg.model.model_type} d_model={cfg.model.d_model} "
                 f"{cfg.model.compute_dtype}: train_benchmark {epochs} epochs of "
                 f"{train_ds.num_samples} samples ({train_ds.n_base} rooms x "
                 f"{len(train_ds.rotation_angles)} rotations), B="
                 f"{cfg.train.batch_size}, N={cfg.data.max_trace_len}: "
                 f"{steps} steps, {val_batches} validation batches in "
                 f"{wall:.1f} s on {smi}; losses "
                 + json.dumps([{k: r[k] for k in ("epoch", "train_loss",
                                                  "val_loss", "mIoU")}
                               for r in res["history"]])
                 + f"; launches {launched}; peak device memory "
                 f"{peak_gb:.2f} GB; last {prefix}_bwd launch {bwd_plan}")
    return launched, best, res


def assert_tc(*names):
    """Each BiGRU wrapper of ``names`` last launched the tensor-core
    kernel."""
    for name in names:
        last = getattr(*WRAPPERS[name]).last_launch
        assert last["kernel"] == "tc", (name, last)


def serve_checkpoint(best, trace_file, dev):
    """Phase 9: the written checkpoint through the port's predictor."""
    model, cfg = load_model_for_inference(str(best), device=dev)
    predict = build_predictor(model, max_trace_len=cfg.data.max_trace_len,
                              confidence_threshold=0.0, nms_threshold=0.3,
                              device=dev, verbose=False)
    reset_counts()
    cols = predict(formats.load_trace_json(trace_file))
    torch.cuda.synchronize()
    assert counts() == expected_counts(bilstm_fwd=cfg.model.lstm_layers)
    assert len(cols) > 0
    for c in cols:
        assert np.isfinite(collider_values(c)).all()
    log("serve_checkpoint", f"{best.name} served {trace_file.name}: "
                            f"{len(cols)} colliders, labels "
                            f"{sorted(set(c['label'] for c in cols))}")


def assignments(model, host, data_cfg, d):
    """A copy of ``model`` on device ``d``, its Hungarian rows and matched
    mask on the batch ``host`` (on the CPU), the batch on ``d`` and the
    match cost ``[B, Q, M]`` (on the CPU)."""
    m = copy.deepcopy(model).to(d)
    batch = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
    feats, mask, targets = loop.prepare_batch(batch, data_cfg)
    with torch.no_grad():
        out = m.train()(feats, mask)
        cost = losses_mod.match_cost(out["pred_boxes"], out["pred_classes"],
                                     targets["boxes"], targets["labels"])
        rows, matched = losses_mod.hungarian_match_fast(
            cost, targets["valid_mask"])
    return m, rows.cpu(), matched.cpu(), batch, cost.cpu()


def assignment_cost(cost, rows, matched):
    """Total match cost of each batch item's assignment, float64."""
    cols = torch.arange(cost.shape[2])
    return torch.stack([cost[b].double()[rows[b], cols][matched[b]].sum()
                        for b in range(cost.shape[0])])


def n_moved(rows_a, matched_a, rows_b, matched_b) -> int:
    """Targets whose assignment differs between two matchings."""
    both = matched_a & matched_b
    return int(((matched_a != matched_b) | (both & (rows_a != rows_b))).sum())


def step_parity(cfg, train_dir, dev, seed, tag="step_parity"):
    """Phase 10: one step on the card and on the CPU from the same
    parameters and batch, augmentation off, dropout 0 (phase 37 under
    ``tag`` "hole_step")."""
    cfg = copy.deepcopy(cfg)
    cfg.model.dropout = 0.0
    # two float32 computations: TF32 products would be the difference
    # (precision_check holds the config's own level against this one)
    cfg.train.matmul_precision = "float32"
    ds = TraceColliderArrays(train_dir, cfg.data, augment=False,
                             verbose=False)
    host = ds.gather(np.arange(cfg.train.batch_size) % ds.num_samples)
    model = build_model(cfg.model)
    params = random_params(model, seed)
    load_params(model, params)
    # At the unmodified init the random queries sit so close together in
    # the match cost that card vs CPU rounding can move an assignment:
    # count how many move, without asserting.
    init_moved = n_moved(*assignments(model, host, cfg.data, dev)[1:3],
                         *assignments(model, host, cfg.data, "cpu")[1:3])
    # As in phase 5, a sharp attention spreads the queries over the walk,
    # so no two of them tie in the match cost. It also keeps the float32
    # softmax backward well conditioned.
    sharpen(params)
    load_params(model, params)
    # The L1 match cost of boxes that lie on one side of two targets in
    # every coordinate is additive, so two such queries tie exactly over
    # those targets and rounding picks between the optima. The card's
    # assignment must be optimal under the CPU's costs; the two steps then
    # take the CPU's matcher output, replayed on the card.
    res, replay = {}, []
    match_batch = losses_mod.hungarian_match_fast

    def record(cost, valid):
        replay.append(match_batch(cost, valid))
        return replay[-1]

    def replayed(cost, valid):
        rows, matched = replay.pop(0)
        return rows.to(cost.device), matched.to(cost.device)

    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        m, rows, matched, batch, cost = assignments(model, host, cfg.data, d)
        opt = loop.make_optimizer(m, cfg)
        step = loop.make_train_step(m, opt, cfg, augment=False)
        with mock.patch.object(losses_mod, "hungarian_match_fast",
                               record if name == "cpu" else replayed):
            losses = step(batch, torch.Generator(d).manual_seed(seed))
        res[name] = ({k: float(v) for k, v in losses.items()},
                     rows, matched,
                     {n: p.detach().cpu() for n, p in m.named_parameters()},
                     {n: p.grad.cpu() for n, p in opt.named}, cost)
    assert not replay, len(replay)
    ((l_gpu, r_gpu, m_gpu, p_gpu, _, _),
     (l_cpu, r_cpu, m_cpu, p_cpu, g_cpu, c_cpu)) = res["card"], res["cpu"]
    assert torch.equal(m_gpu, m_cpu)
    best = assignment_cost(c_cpu, r_cpu, m_cpu)
    tie_gap = ((assignment_cost(c_cpu, r_gpu, m_gpu) - best).abs()
               / best.abs().clamp_min(1.0)).max().item()
    assert tie_gap <= TIE_RTOL, tie_gap
    loss_rel, live_err, other_err = step_diffs(l_gpu, l_cpu, p_gpu, p_cpu,
                                               g_cpu)
    log(tag,
        f"{cfg.model.model_type} card vs CPU at the unmodified init, not "
        f"asserted: {init_moved} matched targets assigned differently")
    log(tag,
        f"card vs CPU, one step B={cfg.train.batch_size} N="
        f"{cfg.data.max_trace_len}, anchor attention x100: "
        f"{int(m_cpu.sum())} matched "
        f"pairs, {n_moved(r_gpu, m_gpu, r_cpu, m_cpu)} assigned differently "
        f"across exact ties (the card's assignment under the CPU's costs: "
        f"max_rel_gap={tie_gap:.3e} tol={TIE_RTOL:.0e}); both steps on the "
        f"CPU's assignment: losses max_rel_diff="
        f"{loss_rel:.3e} tol={LOSS_RTOL:.0e}; updated params max_abs_diff="
        f"{live_err:.3e} tol={PARAM_ATOL:.0e} where |grad| > 1e-5 of the "
        f"largest, {other_err:.3e} elsewhere (tol 2*lr="
        f"{2 * cfg.train.lr:.0e}: AdamW's first step maps rounding noise "
        "to +-lr)")
    assert loss_rel <= LOSS_RTOL, l_gpu
    assert live_err <= PARAM_ATOL, live_err
    assert other_err <= 2 * cfg.train.lr + PARAM_ATOL, other_err
    return l_gpu, l_cpu


def sharpen(params, factor: float = 100.0) -> None:
    """Give the anchor attention of the seeded weights ``params`` the
    temperature ``factor``: the lstm's ``inv_temp``, the transformer's
    anchor query projection scaled. Random weights give a near-uniform
    attention, so every query would decode the same box; a sharp one
    spreads the queries over the walk."""
    dec = params["params"]["decoder"]
    if "inv_temp" in dec:
        dec["inv_temp"] = np.float32(factor)
        return
    for k in ("kernel", "bias"):
        dec["q_proj"][k] = (dec["q_proj"][k] * factor).astype(np.float32)


def precision_check(cfg, train_dir, dev, seed, smi):
    """Phase 10, then: one step on the card at the config's own
    ``train.matmul_precision`` ('bfloat16': TF32 products in cuBLAS and
    cuDNN inside the step) against the same step at 'float32', from the
    same parameters and batch (augmentation off, dropout 0, inv_temp 100,
    the float32 step's assignment replayed): losses and gradients within
    ``PRECISION_LOSS_RTOL`` / ``PRECISION_GRAD_REL`` and not equal (the
    setting took effect), TF32 off again after each step."""
    cfg = copy.deepcopy(cfg)
    cfg.model.dropout = 0.0
    level = cfg.train.matmul_precision
    ds = TraceColliderArrays(train_dir, cfg.data, augment=False,
                             verbose=False)
    host = ds.gather(np.arange(cfg.train.batch_size) % ds.num_samples)
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    replay = []
    match_batch = losses_mod.hungarian_match_fast

    def record(cost, valid):
        replay.append(match_batch(cost, valid))
        return replay[-1]

    def replayed(cost, valid):
        rows, matched = replay.pop(0)
        return rows.to(cost.device), matched.to(cost.device)

    res = {}
    for prec in ("float32", level):
        c = copy.deepcopy(cfg)
        c.train.matmul_precision = prec
        m, _, _, batch, _ = assignments(model, host, c.data, dev)
        opt = loop.make_optimizer(m, c)
        step = loop.make_train_step(m, opt, c, augment=False)
        with mock.patch.object(losses_mod, "hungarian_match_fast",
                               record if prec == "float32" else replayed):
            losses = step(batch, torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        assert not torch.backends.cuda.matmul.allow_tf32
        res[prec] = ({k: float(v) for k, v in losses.items()},
                     {n: p.grad.cpu() for n, p in opt.named},
                     {n: p.detach().cpu() for n, p in m.named_parameters()})
    assert not replay, len(replay)
    (l_ref, g_ref, p_ref), (l_got, g_got, p_got) = res["float32"], res[level]
    loss_rel = max(abs(l_got[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_ref.items())
    scale = max(g.abs().max().item() for g in g_ref.values())
    grad_rel = max((g_got[n] - g).abs().max().item()
                   for n, g in g_ref.items()) / scale
    param_err = max((p_got[n] - p).abs().max().item()
                    for n, p in p_ref.items())
    log("precision", f"one step B={cfg.train.batch_size} N="
        f"{cfg.data.max_trace_len} on the card, train.matmul_precision="
        f"{level!r} (TF32 in the step) vs 'float32': losses max rel "
        f"{loss_rel:.3e} (tol {PRECISION_LOSS_RTOL:.0e}), gradients max-rel "
        f"{grad_rel:.3e} (tol {PRECISION_GRAD_REL:.0e}), updated params max "
        f"abs diff {param_err:.3e}, on {smi}")
    assert 0 < grad_rel <= PRECISION_GRAD_REL, grad_rel
    assert loss_rel <= PRECISION_LOSS_RTOL, loss_rel


def step_diffs(l_gpu, l_cpu, p_gpu, p_cpu, g_cpu):
    """Card vs CPU after one step: the losses' max relative difference and
    the updated parameters' max abs difference where the CPU gradient is
    live (over 1e-5 of the largest) and elsewhere."""
    loss_rel = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_cpu.items())
    scale = max(g.abs().max().item() for g in g_cpu.values())
    live_err, other_err = 0.0, 0.0
    for n, p in p_cpu.items():
        diff = (p_gpu[n] - p).abs()
        live = g_cpu[n].abs() > 1e-5 * scale
        live_err = max(live_err, diff[live].max().item() if live.any()
                       else 0.0)
        other_err = max(other_err, diff.max().item())
    return loss_rel, live_err, other_err


def scaleup_config():
    """The scale-up config from the default one, as the training CLI's
    ``--set`` builds it, at bench_scaleup's batch and sequence length."""
    cfg = ExperimentConfig().apply_overrides(list(SCALEUP_SETS))
    cfg.train.batch_size, cfg.data.max_trace_len = SCALEUP[0], SCALEUP[1]
    return cfg


def bf16_close(a, b) -> float:
    """Max abs difference; asserts the bf16 tolerance."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert torch.allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL), \
        (a - b).abs().max().item()
    return (a - b).abs().max().item() if a.numel() else 0.0


def serve_scaleup(best, dev, seed):
    """Phase 15: the scale-up checkpoint served; the answer and the model's
    outputs against the same model through the plain recurrence on the
    card."""
    model, cfg = load_model_for_inference(str(best), device=dev)
    predict = build_predictor(model, max_trace_len=cfg.data.max_trace_len,
                              confidence_threshold=0.0, nms_threshold=0.3,
                              device=dev, verbose=False)
    arr = walk(SCALEUP_REQUEST, seed + 300)
    reset_counts()
    cols = predict(arr)
    torch.cuda.synchronize()
    launched = counts()
    assert launched == expected_counts(bigru_fwd=cfg.model.lstm_layers), \
        launched
    assert_tc("bigru_fwd")
    assert len(cols) > 0
    x, m = predict.prepare(arr)
    with torch.inference_mode():
        out = model(x, m)
        with mock.patch.object(gru_mod, "bigru_recurrence",
                               gru_cuda.bigru_fwd_plain):
            ref_out = model(x, m)
            ref = predict(arr)
    out_err = max(bf16_close(out[k], ref_out[k]) for k in out)
    assert [c["label"] for c in cols] == [c["label"] for c in ref]
    col_err = max(bf16_close(collider_values(a), collider_values(b))
                  for a, b in zip(cols, ref))
    log("serve_scaleup",
        f"{best.name} ({cfg.model.model_type} d_model={cfg.model.d_model} "
        f"{cfg.model.compute_dtype}) answered {len(arr)} points "
        f"({min(len(arr), cfg.data.max_trace_len)} after downsampling): "
        f"{len(cols)} colliders; launches {launched} "
        f"({plan_text(gru_cuda.bigru_fwd_cuda)}); vs the plain recurrence "
        f"on the card: outputs max abs diff {out_err:.3e}, colliders "
        f"{col_err:.3e} (rtol {BF16_RTOL} atol {BF16_ATOL}), labels equal")
    return launched


def step_parity_scaleup(cfg, train_dir, dev, seed):
    """Phase 16: one scale-up train step (B=SCALEUP_PARITY_B, bf16) with
    the kernels and with their plain versions patched in, on the card, from
    the same parameters and batch (augmentation off, dropout 0,
    inv_temp 100)."""
    cfg = copy.deepcopy(cfg)
    cfg.model.dropout = 0.0
    cfg.train.batch_size = SCALEUP_PARITY_B
    cfg.train.matmul_precision = "float32"     # the kernels are the change
    ds = TraceColliderArrays(train_dir, cfg.data, augment=False,
                             verbose=False)
    host = ds.gather(np.arange(SCALEUP_PARITY_B) % ds.num_samples)
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    res = {}
    for name, patch in (("kernels", None), ("plain", GRU_PLAIN)):
        reset_counts()
        with (mock.patch.multiple(gru_cuda, **patch) if patch
              else contextlib.nullcontext()):
            m, rows, matched, batch, _ = assignments(model, host, cfg.data,
                                                     dev)
            opt = loop.make_optimizer(m, cfg)
            step = loop.make_train_step(m, opt, cfg, augment=False)
            losses = step(batch, torch.Generator(dev).manual_seed(seed))
            torch.cuda.synchronize()
        res[name] = ({k: float(v) for k, v in losses.items()}, rows, matched,
                     counts())
    (l_k, r_k, m_k, c_k), (l_p, r_p, m_p, c_p) = res["kernels"], res["plain"]
    layers = cfg.model.lstm_layers
    assert c_k == expected_counts(bigru_fwd=layers, bigru_fwd_train=layers,
                                  bigru_bwd=layers), c_k
    assert_tc("bigru_fwd", "bigru_fwd_train", "bigru_bwd")
    assert c_p == expected_counts(), c_p
    assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p)
    loss_err = max(bf16_close(l_k[k], v) for k, v in l_p.items())
    log("step_parity_scaleup",
        f"one step B={SCALEUP_PARITY_B} N={cfg.data.max_trace_len} "
        f"{cfg.model.compute_dtype}, inv_temp=100, kernels vs plain versions "
        f"on the card: assignments equal ({int(m_p.sum())} matched pairs); "
        f"losses max abs diff {loss_err:.3e} (rtol {BF16_RTOL} atol "
        f"{BF16_ATOL}); " + json.dumps({"kernels": l_k, "plain": l_p}))


def time_steps(cfg, train_dir, dev, seed, smi, kernel_rows, shapes,
               n_steps, n_warmup, prefix):
    """Phases 11 and 17: p50 step time of the trainer's step at each (B, N)
    of ``shapes`` over ``n_steps`` after ``n_warmup``, then a per-stage
    mean with a synchronise between stages; ``kernel_rows`` (phase 4 or
    13) give the ``prefix`` kernels' share."""
    out = []
    for B, N in shapes:
        c = copy.deepcopy(cfg)
        c.train.batch_size, c.data.max_trace_len = B, N
        ds = TraceColliderArrays(train_dir, c.data, augment=True,
                                 verbose=False)
        data = {k: torch.from_numpy(v).to(dev)
                for k, v in ds.device_arrays().items()}
        plan = ds.epoch_plan(B, seed=seed)
        nb = plan["base_idx"].shape[0]
        model = build_model(c.model, generator=torch.Generator()
                            .manual_seed(seed)).to(dev)
        opt = loop.make_optimizer(model, c)
        step = loop.make_train_step(model, opt, c, augment=True)
        gen = torch.Generator(dev).manual_seed(seed)
        batches = [loop.gather_batch(data, plan, i % nb)
                   for i in range(n_steps + n_warmup)]
        ms = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            losses = step(batch, gen)
            torch.cuda.synchronize()
            if i >= n_warmup:
                ms.append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(float(losses["total_loss"]))
        p50 = float(np.percentile(ms, 50))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if prefix == "bilstm":   # the flagship's H=64: the unit BPTT kernel
            assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "unit"
        elif prefix == "bigru":   # the scale-up's bf16: the tc kernels
            assert_tc("bigru_fwd_train", "bigru_bwd")
        else:   # the transformer: no kernel of the JAX package's
            assert counts() == expected_counts(), counts()

        # per stage, with a synchronise between stages
        lw = loop._loss_weight_dict(c)
        match_ms = []
        match = losses_mod.match

        def timed_match(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = match(*a)
            torch.cuda.synchronize()
            match_ms.append((time.perf_counter() - t) * 1e3)
            return r

        stages = np.zeros((n_steps, 5))
        with mock.patch.object(losses_mod, "match", timed_match):
            for i, batch in enumerate(batches[n_warmup:]):
                t = [time.perf_counter()]
                feats, mask, targets = loop.prepare_batch(batch, c.data, gen)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                model.train()
                opt.zero_grad()
                o = model(feats, mask, generator=gen)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                ls = losses_mod.set_criterion(o, targets, batch["weight"], lw)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                ls["total_loss"].backward()
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                opt.step()
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                stages[i] = np.diff(t) * 1e3
        mean = stages.mean(0)
        m_ms = float(np.mean(match_ms))
        layers = c.model.lstm_layers
        k_ms = {name: next((r["kernel_ms"] for r in rows
                            if r["shape"] == [B, N, c.model.d_model // 2]),
                           None) for name, rows in kernel_rows.items()}
        row = {"model": c.model.model_type, "B": B, "N": N,
               "steps": n_steps, "p50_ms": p50,
               "p99_ms": float(np.percentile(ms, 99)),
               "traces_per_s": B / p50 * 1e3, "peak_gb": peak_gb,
               "last_losses": {k: float(v) for k, v in losses.items()},
               "stage_ms": {"augment_featurize": mean[0],
                            "forward": mean[1],
                            "criterion_matching": m_ms,
                            "criterion_rest": mean[2] - m_ms,
                            "backward": mean[3], "optimizer": mean[4]},
               "staged_step_ms": float(mean.sum()),
               "fwd_train_kernels_ms": (
                   layers * k_ms[f"{prefix}_fwd_train"]
                   if k_ms.get(f"{prefix}_fwd_train") else None),
               "bwd_kernels_ms": (layers * k_ms[f"{prefix}_bwd"]
                                  if k_ms.get(f"{prefix}_bwd") else None)}
        out.append(row)
        log("train_step", json.dumps(row) + f" on {smi}")
    return out


# ---------------------------------------------------------------------------
# Phases 18-24: the single-direction kernels and the legacy GRU surface
# ---------------------------------------------------------------------------


def grads_rel(fn, plain, x, dy, dtype):
    """Max-rel error of each gradient of ``fn(*x)`` (the Function) against
    autograd through ``plain(*x)``; asserts the tolerance of ``dtype``."""
    x = [t.clone().requires_grad_(True) for t in x]
    got = torch.autograd.grad(fn(*x), x, dy)
    ref = torch.autograd.grad(plain(*x), x, dy)
    rel = [max_rel(a.float(), b.float()) for a, b in zip(got, ref)]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
    assert max(rel) <= (GRAD_REL if dtype == torch.float32
                        else BF16_GRAD_REL), rel
    return rel


def check_single_kernels(dev, seed):
    """Phase 18: ``gru_fwd``, ``gru_fwd_train``, ``gru_bwd`` and the three
    LSTM kernels against their plain versions, and ``GRUFunction``'s three
    / ``LSTMFunction``'s two gradients against torch autograd through the
    plain loop, both walk orders; returns errors by (kernel, shape)."""
    errs = {}
    for shape, dtype in SINGLE_GRU_SHAPES:
        xg, _, w, b, _, _ = gru_inputs(*shape, dtype, dev, seed)
        for reverse in (False, True):
            light = value_err((gru_cuda.gru_fwd_cuda(xg, w, b, reverse),),
                              (gru_cuda.gru_recurrence(xg, w, b, reverse),),
                              dtype)
            train = value_err(gru_cuda.gru_fwd_train_cuda(xg, w, b, reverse),
                              gru_cuda.gru_fwd_train_plain(xg, w, b, reverse),
                              dtype)
            plan = plan_text(gru_cuda.gru_fwd_train_cuda)
            ys, gs, hn = gru_cuda.gru_fwd_train_plain(xg, w, b, reverse)
            dy = torch.randn(ys.shape, device=dev, generator=torch.Generator(
                dev).manual_seed(seed + 1)).to(dtype)
            got = gru_cuda.gru_bwd_cuda(w, gs, hn, ys, dy, reverse)
            bwd_plan = plan_text(gru_cuda.gru_bwd_cuda)
            ref = gru_cuda.gru_bwd_plain(w, gs, hn, ys, dy, reverse)
            torch.cuda.synchronize()
            assert all(torch.isfinite(a).all() for a in got)
            bwd_abs = max((a.float() - r.float()).abs().max().item()
                          for a, r in zip(got, ref))
            bwd_rel = max(max_rel(a.float(), r.float())
                          for a, r in zip(got, ref))
            assert bwd_rel <= (GRAD_REL if dtype == torch.float32
                               else BF16_GRAD_REL), bwd_rel
            fn_rel = grads_rel(
                lambda *a: gru_cuda.gru_recurrence_kernel(*a, reverse),
                lambda *a: gru_cuda.gru_recurrence(*a, reverse),
                (xg, w, b), dy, dtype)
            last = gru_cuda.gru_fwd_train_cuda.last_launch
            bwd_kernel = gru_cuda.gru_bwd_cuda.last_launch["kernel"]
            if shape[-1] == 256:    # W_hh of H=256 needs a cluster
                assert last["kernel"] == "reg" and last["cluster"] > 1, plan
                assert bwd_kernel == "reg", bwd_plan
            else:                   # H <= 64, one direction: the unit kernel
                assert last["kernel"] == "unit", plan
                assert gru_cuda.gru_fwd_cuda.last_launch["kernel"] == "unit"
                assert bwd_kernel == "unit", bwd_plan
            for name, e in (("gru_fwd", light), ("gru_fwd_train", train),
                            ("gru_bwd", bwd_abs)):
                key = (name, shape, dtype)
                errs[key] = max(errs.get(key, 0.0), e)
            log("kernel_check",
                f"B,N,H={shape} {str(dtype)[6:]} reverse={reverse}: gru_fwd "
                f"ys max_abs_err={light:.3e}, gru_fwd_train (ys, gates, hn) "
                f"{train:.3e}; gru_bwd (dx, dhn) max_abs_err={bwd_abs:.3e} "
                f"max_rel_err={bwd_rel:.3e}; GRUFunction vs autograd "
                "through the plain loop max_rel_err (dxg, dW_hh, db_hh) "
                + " ".join(f"{v:.3e}" for v in fn_rel) + f"; launch {plan}"
                + f"; gru_bwd launch {bwd_plan}")
    for shape in SINGLE_LSTM_SHAPES:
        xg, _, w, _ = kernel_inputs(*shape, dev, seed)
        for reverse in (False, True):
            light = value_err((rnn_cuda.lstm_fwd_cuda(xg, w, reverse),),
                              (rnn_cuda.lstm_recurrence(xg, w, reverse),),
                              torch.float32)
            train = value_err(rnn_cuda.lstm_fwd_train_cuda(xg, w, reverse),
                              rnn_cuda.lstm_fwd_train_plain(xg, w, reverse),
                              torch.float32)
            ys, cs, gs = rnn_cuda.lstm_fwd_train_plain(xg, w, reverse)
            dy = torch.randn(ys.shape, device=dev, generator=torch.Generator(
                dev).manual_seed(seed + 1))
            dg = rnn_cuda.lstm_bwd_cuda(w, gs, cs, dy, reverse)
            ref = rnn_cuda.lstm_bwd_plain(w, gs, cs, dy, reverse)
            torch.cuda.synchronize()
            assert torch.isfinite(dg).all()
            bwd_abs = (dg - ref).abs().max().item()
            bwd_rel = max_rel(dg, ref)
            assert bwd_rel <= GRAD_REL, bwd_rel
            fn_rel = grads_rel(
                lambda *a: rnn_cuda.lstm_recurrence_kernel(*a, reverse),
                lambda *a: rnn_cuda.lstm_recurrence(*a, reverse),
                (xg, w), dy, torch.float32)
            for name, e in (("lstm_fwd", light), ("lstm_fwd_train", train),
                            ("lstm_bwd", bwd_abs)):
                key = (name, shape, torch.float32)
                errs[key] = max(errs.get(key, 0.0), e)
            for fn in (rnn_cuda.lstm_fwd_cuda, rnn_cuda.lstm_fwd_train_cuda,
                       rnn_cuda.lstm_bwd_cuda):
                assert fn.last_launch["kernel"] == "unit", fn.last_launch
            log("kernel_check",
                f"B,N,H={shape} float32 reverse={reverse}: lstm_fwd ys "
                f"max_abs_err={light:.3e}, lstm_fwd_train (ys, c, gates) "
                f"{train:.3e} (tol {KERNEL_ATOL:.0e}); lstm_bwd dg "
                f"max_abs_err={bwd_abs:.3e} max_rel_err={bwd_rel:.3e}; "
                "LSTMFunction vs autograd through the plain loop max_rel_err "
                "(dxg, dW_hh) " + " ".join(f"{v:.3e}" for v in fn_rel)
                + f"; launch {plan_text(rnn_cuda.lstm_fwd_train_cuda)}; "
                f"lstm_bwd launch {plan_text(rnn_cuda.lstm_bwd_cuda)}")
    return errs


def time_single_kernels(dev, seed, errs):
    """Phase 19: each single-direction kernel at the legacy shape in f32,
    its plain version, the bound and cuDNN's unidirectional ``nn.GRU`` /
    ``nn.LSTM`` in f32 (never called by the port; input projection
    included)."""
    B, N, H = LEGACY
    f32 = torch.float32
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, N, 2 * H, device=dev, generator=g, requires_grad=True)
    dy = torch.randn(B, N, H, device=dev, generator=g)
    lib_ms = {}
    for fam, mod in (("gru", torch.nn.GRU), ("lstm", torch.nn.LSTM)):
        lib = mod(2 * H, H, batch_first=True).to(dev)
        with torch.no_grad():
            lib_ms[f"{fam}_fwd"] = cuda_ms(lambda: lib(x), 20)
        fwd = cuda_ms(lambda: lib(x), 20)
        lib_ms[f"{fam}_fwd_train"] = fwd
        lib_ms[f"{fam}_bwd"] = cuda_ms(lambda: lib(x)[0].backward(dy),
                                       20) - fwd
    xg, _, w, b, _, _ = gru_inputs(B, N, H, f32, dev, seed)
    gres = gru_cuda.gru_fwd_train_plain(xg, w, b)
    gargs = (w, *gres[1:], gres[0], dy)
    lx, _, lw, _ = kernel_inputs(B, N, H, dev, seed)
    ys, cs, gs = rnn_cuda.lstm_fwd_train_plain(lx, lw)
    largs = (lw, gs, cs, dy)
    rows = {}
    for name, fn, plain, a, bnd in (
            ("gru_fwd", gru_cuda.gru_fwd_cuda, gru_cuda.gru_recurrence,
             (xg, w, b), gru_bound("fwd", B, N, H, f32, dirs=1)),
            ("gru_fwd_train", gru_cuda.gru_fwd_train_cuda,
             gru_cuda.gru_fwd_train_plain, (xg, w, b),
             gru_bound("fwd_train", B, N, H, f32, dirs=1)),
            ("gru_bwd", gru_cuda.gru_bwd_cuda, gru_cuda.gru_bwd_plain, gargs,
             gru_bound("bwd", B, N, H, f32, dirs=1)),
            ("lstm_fwd", rnn_cuda.lstm_fwd_cuda, rnn_cuda.lstm_recurrence,
             (lx, lw), bilstm_bound(B, N, H, dirs=1)),
            ("lstm_fwd_train", rnn_cuda.lstm_fwd_train_cuda,
             rnn_cuda.lstm_fwd_train_plain, (lx, lw),
             fwd_train_bound(B, N, H, dirs=1)),
            ("lstm_bwd", rnn_cuda.lstm_bwd_cuda, rnn_cuda.lstm_bwd_plain,
             largs, bwd_bound(B, N, H, dirs=1))):
        ms = cuda_ms(lambda: fn(*a), 20)
        plain_ms = cuda_ms(lambda: plain(*a), 2, warmup=1)
        rows[name] = {"shape": [B, N, H], "dtype": "float32",
                      "kernel_ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms[name], "bound_us": bnd[0] * 1e3,
                      "bound_by": bnd[1], "us_per_step": ms / N * 1e3,
                      "library_us_per_step": lib_ms[name] / N * 1e3,
                      "err": errs[(name, LEGACY, f32)]}
        if name == "gru_bwd":
            rows[name]["plans"] = plan_sweep(
                name, fn, a, gru_bwd_plans(B, H, dev, f32), LEGACY, 20)
        elif name == "lstm_bwd":
            rows[name]["plans"] = plan_sweep(
                name, fn, a, lstm_bwd_plans(B, H, dev, f32, 1), LEGACY, 20)
        else:
            save = name.endswith("train")
            plans = (gru_single_plans(B, H, dev, f32, save)
                     if name.startswith("gru")
                     else lstm_plans(B, H, dev, f32, save, 1))
            rows[name]["plans"] = plan_sweep(name, fn, a, plans, LEGACY, 20)
        if hasattr(fn, "last_launch"):
            rows[name]["launch"] = dict(fn.last_launch)
        log("kernel_time", f"{name} " + json.dumps(rows[name]) + (
            "  (library_ms: cuDNN unidirectional nn."
            + ("GRU" if name.startswith("gru") else "LSTM") + " f32, "
            + {"fwd": "forward without grad", "fwd_train":
               "forward with grad on", "bwd": "forward + backward minus "
               "forward"}[name.split("_", 1)[1]]
            + ", includes the input projection)"))
    rows["gru_bwd_bf16"] = time_gru_bwd_bf16(dev, seed, x, dy)
    return rows


def time_gru_bwd_bf16(dev, seed, x, dy):
    """Phase 19, last: ``gru_bwd`` at the legacy shape with bf16 streams,
    held to its plain version (values rtol / atol, max-rel 0.1), its time,
    plain time, bound and plans, against unidirectional ``nn.GRU`` in bf16
    (PyTorch's own step loop: cuDNN takes no bf16 RNN) and through cuDNN in
    fp16 (never called by the port; forward + backward minus forward)."""
    B, N, H = LEGACY
    bf = torch.bfloat16
    lib_ms = {}
    for key, dt in (("bf16", bf), ("cudnn_fp16", torch.float16)):
        lib = torch.nn.GRU(2 * H, H, batch_first=True).to(dev, dt)
        xi = x.detach().to(dt).requires_grad_(True)
        dyi = dy.to(dt)
        fwd = cuda_ms(lambda: lib(xi), 5)
        lib_ms[key] = cuda_ms(lambda: lib(xi)[0].backward(dyi), 5) - fwd
    xg, _, w, b, _, _ = gru_inputs(B, N, H, bf, dev, seed)
    ys, gs, hn = gru_cuda.gru_fwd_train_plain(xg, w, b)
    a = (w, gs, hn, ys, dy.to(bf))
    got = gru_cuda.gru_bwd_cuda(*a)
    ref = gru_cuda.gru_bwd_plain(*a)
    err = value_err(got, ref, bf)
    rel = max(max_rel(g.float(), r.float()) for g, r in zip(got, ref))
    assert rel <= BF16_GRAD_REL, rel
    ms = cuda_ms(lambda: gru_cuda.gru_bwd_cuda(*a), 20)
    plain_ms = cuda_ms(lambda: gru_cuda.gru_bwd_plain(*a), 2, warmup=1)
    bnd = gru_bound("bwd", B, N, H, bf, dirs=1)
    row = {"shape": [B, N, H], "dtype": "bfloat16", "kernel_ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms["bf16"],
           "cudnn_fp16_ms": lib_ms["cudnn_fp16"], "bound_us": bnd[0] * 1e3,
           "bound_by": bnd[1], "us_per_step": ms / N * 1e3,
           "library_us_per_step": lib_ms["cudnn_fp16"] / N * 1e3,
           "err": err, "max_rel_err": rel,
           "plans": plan_sweep("gru_bwd", gru_cuda.gru_bwd_cuda, a,
                               gru_bwd_plans(B, H, dev, bf), LEGACY, 20),
           "launch": dict(gru_cuda.gru_bwd_cuda.last_launch)}
    log("kernel_time", "gru_bwd bf16 " + json.dumps(row) + "  (library_ms: "
        "unidirectional nn.GRU bf16; cudnn_fp16_ms: the same in fp16 through "
        "cuDNN; both forward + backward minus forward, input projection "
        "included; library_us_per_step from cuDNN fp16)")
    return row


def train_legacy_path(data, save_dir, dev, seed, smi):
    """Phase 20: ``train_legacy`` at its documented defaults on the card,
    launch counts read around it: per step 4 ``gru_fwd_train`` and 4
    ``gru_bwd`` (2 layers x 2 directions), only ``gru_fwd`` (4 a batch) in
    validation, nothing else."""
    B = LEGACY[0]
    reset_counts()
    t0 = time.perf_counter()
    res = train_legacy(str(data), epochs=LEGACY_EPOCHS, batch_size=B,
                       hidden_size=2 * LEGACY[2], seq_len=LEGACY[1],
                       save_dir=str(save_dir), seed=seed, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    n_val = len(res["val_idx"])
    n_train = len(res["dataset"]) - n_val
    steps = LEGACY_EPOCHS * -(-n_train // B)
    val_batches = LEGACY_EPOCHS * -(-n_val // B)
    assert launched == expected_counts(gru_fwd_train=4 * steps,
                                       gru_bwd=4 * steps,
                                       gru_fwd=4 * val_batches), launched
    for row in res["history"]:
        assert np.isfinite(row["train_loss"]) and \
            np.isfinite(row["val_loss"]), row
    best = Path(save_dir) / "best_model_legacy"
    assert best.with_suffix(".msgpack").exists()
    log("train_legacy",
        f"train_legacy (hidden {2 * LEGACY[2]}, seq {LEGACY[1]}, max_objects "
        f"10, batch {B}, lr 1e-3) {LEGACY_EPOCHS} epochs of {n_train} "
        f"windows ({n_val} for "
        f"validation) from {LEGACY_ROOMS} rooms of {LEGACY_POINTS} points: "
        f"{steps} steps, {val_batches} validation batches in {wall:.1f} s "
        f"on {smi}; losses {json.dumps(res['history'])}; launches "
        f"{launched}; last gru_fwd_train "
        f"{plan_text(gru_cuda.gru_fwd_train_cuda)}, gru_bwd "
        f"{plan_text(gru_cuda.gru_bwd_cuda)}")
    return launched, best


def evaluate_legacy_path(best, data, dev):
    """Phase 21: ``evaluate_legacy`` with the baseline on the card (only
    ``gru_fwd``, 4 launches: one forward over every window), then the
    model's outputs and the evaluation against the same on the CPU."""
    reset_counts()
    hidden = 2 * LEGACY[2]
    res = evaluate_legacy(str(best), str(data), hidden, threshold=
                          LEGACY_THRESHOLD, compare_baseline=True, device=dev)
    torch.cuda.synchronize()
    launched = counts()
    assert launched == expected_counts(gru_fwd=4), launched
    assert np.isfinite(res["mAP"]) and np.isfinite(res["baseline_mAP"])
    ref = evaluate_legacy(str(best), str(data), hidden, threshold=
                          LEGACY_THRESHOLD, compare_baseline=True,
                          device="cpu")
    ds = LegacyArrays(data)
    x = torch.from_numpy(np.ascontiguousarray(ds.traces[:, :, 1:3]))
    with torch.no_grad():
        out = load_legacy_model(str(best), hidden, device=dev)[0](x.to(dev))
        cpu = load_legacy_model(str(best), hidden, device="cpu")[0](x)
    box_err = (out["pred_boxes"].cpu() - cpu["pred_boxes"]).abs().max().item()
    labels_equal = torch.equal(out["classes"].argmax(-1).cpu(),
                               cpu["classes"].argmax(-1))
    log("evaluate_legacy",
        f"{best.name} on {len(ds)} windows of {len(set(ds.trace_id))} traces "
        f"(threshold {LEGACY_THRESHOLD}): mAP {res['mAP']:.6f}, baseline "
        f"mAP {res['baseline_mAP']:.6f}; AP per class "
        f"{json.dumps(res['AP_per_class'])}, baseline "
        f"{json.dumps(res['baseline_AP_per_class'])}; launches {launched}; "
        f"card vs CPU: boxes max abs diff {box_err:.3e} (tol {MODEL_TOL:.0e})"
        f", labels equal {labels_equal}, mAP {ref['mAP']:.6f} and baseline "
        f"mAP {ref['baseline_mAP']:.6f} on the CPU")
    assert box_err <= MODEL_TOL and labels_equal
    assert abs(res["mAP"] - ref["mAP"]) <= 1e-9, (res, ref)
    return launched


def legacy_batch(ds, model, B, seed):
    """The first ``B`` windows as a batch (on the CPU), their GT positions
    moved next to a shuffled subset of ``model``'s predicted positions so no
    two assignments tie."""
    traces = np.ascontiguousarray(ds.traces[:B, :, 1:3])
    with torch.no_grad():
        pos = model.eval()(torch.from_numpy(traces))["positions"].numpy()
    rng = np.random.default_rng(seed)
    boxes = ds.boxes[:B].copy()
    for i in range(B):
        boxes[i, :, :2] = pos[i, rng.permutation(pos.shape[1])] + \
            rng.normal(scale=0.05, size=(pos.shape[1], 2))
    return {"traces": traces, "boxes": boxes, "labels": ds.labels[:B],
            "valid": ds.valid[:B], "weight": np.ones(B, np.float32)}


def legacy_rows(model, host, d):
    """Hungarian rows and matched mask of ``model`` on the batch ``host``,
    computed on device ``d``, back on the CPU."""
    m = copy.deepcopy(model).to(d).eval()
    batch = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
    with torch.no_grad():
        rows, matched = legacy_match(m(batch["traces"]),
                                     legacy_targets(batch))
    return rows.cpu(), matched.cpu()


def legacy_step_parity(data, dev, seed):
    """Phase 22: one legacy step on the card and on the CPU from the same
    parameters (``random_params``) and batch, dropout 0."""
    model = RoomSlamGRU(hidden_size=2 * LEGACY[2], dropout=0.0)
    params = random_params(model, seed)
    load_params(model, params)
    ds = LegacyArrays(data, seq_len=LEGACY[1])
    # At the random init a window's ten predicted positions sit within
    # ~0.3 m of each other, and card vs CPU rounding can move an
    # assignment among them: count how many move, without asserting.
    host = legacy_batch(ds, model, LEGACY[0], seed)
    init_moved = n_moved(*legacy_rows(model, host, dev),
                         *legacy_rows(model, host, "cpu"))
    # A position head 100x larger spreads them over ~20 m, so the targets
    # placed next to them have one clear assignment.
    params["params"]["position_head"]["kernel"] *= 100.0
    load_params(model, params)
    host = legacy_batch(ds, model, LEGACY[0], seed)
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        rows, matched = legacy_rows(model, host, d)
        m = copy.deepcopy(model).to(d)
        batch = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
        opt = legacy_optimizer(m, 1e-3)
        losses = make_legacy_step(m, opt)(batch,
                                          torch.Generator(d).manual_seed(seed))
        res[name] = ({k: float(v) for k, v in losses.items()},
                     rows, matched,
                     {n: p.detach().cpu() for n, p in m.named_parameters()},
                     {n: p.grad.cpu() for n, p in opt.named})
    (l_gpu, r_gpu, m_gpu, p_gpu, _), (l_cpu, r_cpu, m_cpu, p_cpu, g_cpu) = \
        res["card"], res["cpu"]
    assert torch.equal(m_gpu, m_cpu)
    assert torch.equal(torch.where(m_cpu, r_gpu, -1),
                       torch.where(m_cpu, r_cpu, -1))
    loss_rel, live_err, other_err = step_diffs(l_gpu, l_cpu, p_gpu, p_cpu,
                                               g_cpu)
    log("legacy_step_parity",
        f"card vs CPU at the unmodified init, not asserted: {init_moved} "
        "matched targets assigned differently")
    log("legacy_step_parity",
        f"card vs CPU, one legacy step B={LEGACY[0]} N={LEGACY[1]}, dropout "
        f"0, position head x100: assignments equal ({int(m_cpu.sum())} matched pairs); losses "
        f"max_rel_diff={loss_rel:.3e} tol={LOSS_RTOL:.0e}; updated params "
        f"max_abs_diff={live_err:.3e} tol={PARAM_ATOL:.0e} where |grad| > "
        f"1e-5 of the largest, {other_err:.3e} elsewhere (tol 2*lr)")
    assert loss_rel <= LOSS_RTOL, (l_gpu, l_cpu)
    assert live_err <= PARAM_ATOL, live_err
    assert other_err <= 2 * 1e-3 + PARAM_ATOL, other_err


def time_legacy_steps(data, dev, seed, smi, rows):
    """Phase 23: p50 of ``make_legacy_step`` at B=32, N=500 over
    ``LEGACY_STEPS`` after ``LEGACY_WARMUP``, then a per-stage mean with a
    synchronise between stages; ``rows`` (phase 19) give the kernels'
    share."""
    B = LEGACY[0]
    ds = LegacyArrays(data, seq_len=LEGACY[1])
    dev_data = legacy_data(ds, dev)
    model = RoomSlamGRU(hidden_size=2 * LEGACY[2], generator=torch.Generator(
        ).manual_seed(seed)).to(dev)
    opt = legacy_optimizer(model, 1e-3)
    step = make_legacy_step(model, opt)
    gen = torch.Generator(dev).manual_seed(seed)
    n = LEGACY_STEPS + LEGACY_WARMUP
    batches = []
    while len(batches) < n:
        batches += list(legacy_batches(dev_data, np.arange(len(ds)), B,
                                       seed + len(batches), True))
    ms = []
    for i, batch in enumerate(batches[:n]):
        t0 = time.perf_counter()
        losses = step(batch, gen)
        torch.cuda.synchronize()
        if i >= LEGACY_WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(losses["total_loss"]))
    match_ms = []
    match = losses_mod.hungarian_match_batch

    def timed_match(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = match(*a)
        torch.cuda.synchronize()
        match_ms.append((time.perf_counter() - t) * 1e3)
        return r

    stages = np.zeros((LEGACY_STEPS, 4))
    with mock.patch.object(losses_mod, "hungarian_match_batch", timed_match):
        for i, batch in enumerate(batches[LEGACY_WARMUP:n]):
            t = [time.perf_counter()]
            model.train()
            opt.zero_grad()
            out = model(batch["traces"], generator=gen)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            ls = legacy_criterion(out, legacy_targets(batch), batch["weight"])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            ls["total_loss"].backward()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            opt.step()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            stages[i] = np.diff(t) * 1e3
    mean = stages.mean(0)
    m_ms = float(np.mean(match_ms))
    p50 = float(np.percentile(ms, 50))
    row = {"B": B, "N": LEGACY[1], "steps": LEGACY_STEPS, "p50_ms": p50,
           "p99_ms": float(np.percentile(ms, 99)),
           "windows_per_s": B / p50 * 1e3,
           "stage_ms": {"forward": mean[0],
                        "criterion_host_matching": m_ms,
                        "criterion_rest": mean[1] - m_ms,
                        "backward": mean[2], "optimizer": mean[3]},
           "staged_step_ms": float(mean.sum()),
           "fwd_train_kernels_ms": 4 * rows["gru_fwd_train"]["kernel_ms"],
           "bwd_kernels_ms": 4 * rows["gru_bwd"]["kernel_ms"]}
    log("train_step_legacy", json.dumps(row) + f" on {smi}")
    return row


def lstm_ops_path(dev, seed):
    """Phase 24: ``ops/rnn.py`` ``lstm_recurrence(use_kernel=True)`` at the
    legacy shape, forward without grad (one ``lstm_fwd``) and forward and
    backward with it (one ``lstm_fwd_train``, one ``lstm_bwd``), both walk
    orders of the JAX package's per-direction calls, with float32 and with
    bfloat16 streams; held against the plain loop and autograd through it.
    Returns the launches of each dtype's run."""
    launched = {}
    for dtype in (torch.float32, torch.bfloat16):
        xg, _, w, _ = kernel_inputs(*LEGACY, dev, seed)
        xg = xg.to(dtype)
        dy = torch.randn(*LEGACY[:2], LEGACY[2], device=dev,
                         generator=torch.Generator(dev).manual_seed(seed)
                         ).to(dtype)
        reset_counts()
        with torch.no_grad():
            ys = rnn_ops.lstm_recurrence(xg, w, False, use_kernel=True)
        x = [t.clone().requires_grad_(True) for t in (xg, w)]
        yr = rnn_ops.lstm_recurrence(*x, True, use_kernel=True)
        grads = torch.autograd.grad(yr, x, dy)
        torch.cuda.synchronize()
        launched[dtype] = counts()
        assert launched[dtype] == expected_counts(
            lstm_fwd=1, lstm_fwd_train=1, lstm_bwd=1), launched[dtype]
        err = value_err((ys, yr), (rnn_ops.lstm_recurrence(xg, w),
                                   rnn_ops.lstm_recurrence(xg, w, True)),
                        dtype)
        ref = torch.autograd.grad(rnn_ops.lstm_recurrence(*x, True), x, dy)
        rel = [max_rel(a.float(), b.float()) for a, b in zip(grads, ref)]
        rel_tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
        log("lstm_ops", f"lstm_recurrence(use_kernel=True) B,N,H={LEGACY} "
            f"{str(dtype)[6:]}: launches {launched[dtype]}; values "
            f"max_abs_err={err:.3e}; gradients (dxg, dW_hh) max_rel_err "
            + " ".join(f"{v:.3e}" for v in rel) + f" tol {rel_tol:g}")
        assert max(rel) <= rel_tol, rel
    return launched


# ---------------------------------------------------------------------------
# Phases 25-30: the split BPTT (#10), the fused layer VJP (#9), the
# bench_bigru_bwd tool, and bf16 streams through the BiLSTM kernels
# ---------------------------------------------------------------------------


def bwd_errs(got, ref):
    """Max abs and max-rel error over output pairs."""
    assert all(torch.isfinite(a).all() for a in got)
    return (max((a.float() - b.float()).abs().max().item()
                for a, b in zip(got, ref)),
            max(max_rel(a.float(), b.float()) for a, b in zip(got, ref)))


def check_tool_plans(args, ref, plans):
    """At the scale-up shape: #10 and #6 under each plan the tool sweeps
    (``--tiles auto``: the plans of the route's kernel) against their plain
    versions (``ref``: #10's; #6's is computed here), max-rel at the bf16
    bound."""
    ref6 = gru_cuda.bigru_bwd_plain(*args)
    for p in plans:
        for name, fn, want in (
                ("bigru_bwd_split", gru_cuda.bigru_bwd_split_cuda, ref),
                ("bigru_bwd", gru_cuda.bigru_bwd_cuda, ref6)):
            err, rel = bwd_errs(fn(*args, plan=p), want)
            log("split_check",
                f"B,N,H={SCALEUP} bfloat16, the tool's plan {plan_key(p)}: "
                f"{name} vs plain max_abs_err={err:.3e} max_rel_err="
                f"{rel:.3e} tol {BF16_GRAD_REL:g}; launch "
                f"{plan_text(fn)}")
            assert rel <= BF16_GRAD_REL, (name, p, rel)


def check_split(dev, seed):
    """Phase 25: ``bigru_bwd_split`` (#10) on #6's route against its plain
    version and against #6 at the BiGRU check shapes and ``SPLIT_SHAPES``
    (a shape for each kernel of the route), each launch's kernel asserted
    #6's and its plan printed, a second launch bit-equal, and at the
    scale-up shape both under every plan the tool sweeps; returns errors
    and the plain version's ms by shape and dtype, and the plans checked at
    the scale-up shape."""
    errs, plain_ms = {}, {}
    plans = gru_cuda.card_bwd_plans(SCALEUP[0], SCALEUP[2], dev,
                                    torch.bfloat16)[1][:6]
    for shape, dtype in dict.fromkeys((*GRU_SHAPES, *SPLIT_SHAPES)):
        args = gru_bwd_inputs(gru_inputs(*shape, dtype, dev, seed), seed + 1)
        got = gru_cuda.bigru_bwd_split_cuda(*args)
        same = all(torch.equal(a, b) for a, b in zip(
            got, gru_cuda.bigru_bwd_split_cuda(*args)))
        plan = plan_text(gru_cuda.bigru_bwd_split_cuda)
        kernel = gru_cuda.bigru_bwd_split_cuda.last_launch["kernel"]
        ref, plain_ms[(shape, dtype)] = timed_once(
            lambda: gru_cuda.bigru_bwd_split_plain(*args))
        err, rel = bwd_errs(got, ref)
        if dtype == torch.bfloat16:
            value_err(got, ref, dtype)
        if shape == SCALEUP:
            check_tool_plans(args, ref, plans)
        del ref
        vs6, vs6_rel = bwd_errs(got, gru_cuda.bigru_bwd_cuda(*args))
        kernel6 = gru_cuda.bigru_bwd_cuda.last_launch["kernel"]
        rel_tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
        errs[(shape, dtype)] = {"abs": err, "rel": rel, "vs6_abs": vs6}
        log("split_check",
            f"B,N,H={shape} {str(dtype)[6:]}: bigru_bwd_split (dx, dhn) vs "
            f"plain max_abs_err={err:.3e} max_rel_err={rel:.3e} tol "
            f"{rel_tol:g}; vs bigru_bwd (#6, {kernel6} kernel) "
            f"max_abs_diff={vs6:.3e} max_rel_diff={vs6_rel:.3e}"
            + (f" tol {KERNEL_ATOL:.0e}" if dtype == torch.float32 else
               " (the coefficients' bf16 rounding differs)")
            + f"; twice bit-equal={same}; launch {plan}")
        assert rel <= rel_tol, (shape, rel)
        assert kernel == kernel6, (shape, kernel, kernel6)
        assert same, shape
        if dtype == torch.float32:
            assert vs6 <= KERNEL_ATOL, (shape, vs6)
    return errs, plain_ms, plans


def fused_case(B, N, H, D, dtype, dev, seed):
    """``bigru_layer``'s inputs: x in the stream dtype, the eight float32
    weights U(+-1/sqrt(H)) (W_ih U(+-1/sqrt(D))), and an upstream
    gradient."""
    g = np.random.default_rng(seed)
    x = (torch.randn(B, N, D, device=dev, generator=stream_generator(
        dev, seed)) * 0.5).to(dtype)
    ws = [torch.tensor(g.uniform(-1, 1, size=sz) / np.sqrt(sz[0]),
                       dtype=torch.float32, device=dev)
          for _ in range(2)
          for sz in ((D, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    dy = torch.randn(B, N, 2 * H, device=dev, generator=torch.Generator(
        dev).manual_seed(seed)).to(dtype)
    return x, ws, dy


def layer_grads(fn, x, ws, dy):
    """``fn``'s output and the gradients of its nine inputs (x and the
    eight weights) for the upstream gradient ``dy``."""
    ins = [t.clone().requires_grad_(True) for t in (x, *ws)]
    y = fn(*ins)
    return y, torch.autograd.grad(y, ins, dy)


def unfused_layer(x, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b, bhh_b):
    """The same layer unfused: the gate products in torch and
    ``BiGRUFunction`` (#5t, #6 and the dW_hh products), as the models run
    it."""
    ys_f, ys_b = gru_cuda.BiGRUFunction.apply(
        rnn_ops.input_gates(x, wih_f, bih_f),
        rnn_ops.input_gates(x, wih_b, bih_b), whh_f, bhh_f, whh_b, bhh_b)
    return torch.cat([ys_f, ys_b], dim=-1)


GRAD_NAMES = ("dx", "dW_ih_f", "db_ih_f", "dW_hh_f", "db_hh_f", "dW_ih_b",
              "db_ih_b", "dW_hh_b", "db_hh_b")


def check_fused(dev, seed):
    """Phase 26: ``bigru_layer`` under grad (its backward #9) against the
    same layer with #9's plain version on the card, output and nine
    gradients, twice (bit for bit), and against the unfused
    composition."""
    for shape, dtype in FUSED_SHAPES:
        x, ws, dy = fused_case(*shape, dtype, dev, seed)
        before = gru_cuda.bigru_bwd_fused_cuda.launches
        y, got = layer_grads(gru_cuda.bigru_layer, x, ws, dy)
        _, again = layer_grads(gru_cuda.bigru_layer, x, ws, dy)
        torch.cuda.synchronize()
        assert gru_cuda.bigru_bwd_fused_cuda.launches == before + 2
        plan = plan_text(gru_cuda.bigru_bwd_fused_cuda)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        with mock.patch.object(gru_cuda, "bigru_bwd_fused",
                               gru_cuda.bigru_bwd_fused_plain):
            y_ref, ref = layer_grads(gru_cuda.bigru_layer, x, ws, dy)
        _, unf = layer_grads(unfused_layer, x, ws, dy)
        rel_tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
        y_err = value_err((y,), (y_ref,), dtype)
        rel = {n: max_rel(a.float(), b.float())
               for n, a, b in zip(GRAD_NAMES, got, ref)}
        rel_unf = {n: max_rel(a.float(), b.float())
                   for n, a, b in zip(GRAD_NAMES, got, unf)}
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.isfinite(a).all()
        log("fused_check",
            f"B,N,H,D={shape} {str(dtype)[6:]}: bigru_layer output "
            f"max_abs_err={y_err:.3e}; the nine gradients (#9) vs #9's plain "
            "version max_rel_err "
            + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
            + f" tol {rel_tol:g}; run twice bit-equal={same}; vs the "
            "unfused layer (BiGRUFunction + torch products) max_rel_diff "
            + " ".join(f"{k}={v:.3e}" for k, v in rel_unf.items())
            + f"; launch {plan}")
        assert same
        assert max(rel.values()) <= rel_tol, rel
        assert max(rel_unf.values()) <= rel_tol, rel_unf
        del got, again, ref, unf


def fused_ab(dev, seed, smi, lib_ms):
    """Phase 27: one BiGRU layer's forward + backward at the scale-up shape
    (B=128, N=5000, H=256, D=512, bf16), fused (``bigru_layer``, #5t then
    #9) against unfused (``BiGRUFunction`` + torch products), 6 steps after
    2 warm-up each on CUDA events; then #9 alone at this shape and plan:
    its ten outputs twice (bit for bit) and against its plain version
    (max-rel at the bf16 bound), its time and its bound. The fused side is
    #9's path: its launches are counted around it."""
    B, N, H = SCALEUP
    D = 2 * H
    x, ws, dy = fused_case(B, N, H, D, torch.bfloat16, dev, seed)
    ins = [t.clone().requires_grad_(True) for t in (x, *ws)]

    def step(fn):
        return lambda: torch.autograd.grad(fn(*ins), ins, dy)

    unfused_ms = cuda_ms(step(unfused_layer), 6)
    reset_counts()
    fused_ms = cuda_ms(step(gru_cuda.bigru_layer), 6)
    launched = gru_cuda.bigru_bwd_fused_cuda.launches
    assert launched == 8 and counts()["bigru_fwd_train"] == 8, launched
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train(
        rnn_ops.input_gates(x, ws[0], ws[1]),
        rnn_ops.input_gates(x, ws[4], ws[5]), ws[2], ws[3], ws[6], ws[7])
    args = (x, ws[0], ws[2], ws[4], ws[6], gs_f, hn_f, ys_f,
            dy[..., :H].contiguous(), gs_b, hn_b, ys_b,
            dy[..., H:].contiguous())
    got = gru_cuda.bigru_bwd_fused_cuda(*args)
    again = gru_cuda.bigru_bwd_fused_cuda(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    kernel_ms = cuda_ms(lambda: gru_cuda.bigru_bwd_fused_cuda(*args), 3,
                        warmup=0)
    # #6 (the same chain without the products) at #9's plan: the difference
    # is what the chunks' stops and products cost
    last = gru_cuda.bigru_bwd_fused_cuda.last_launch
    plan = (last["cluster"], last["rows"])
    args6 = (ws[2], ws[6], gs_f, hn_f, ys_f, args[8], gs_b, hn_b, ys_b,
             args[12])
    chain_ms = cuda_ms(lambda: gru_cuda.bigru_bwd_cuda(*args6, plan=plan), 3)
    assert gru_cuda.bigru_bwd_cuda.last_launch["rows"] == plan[1]
    ref, plain_ms = timed_once(lambda: gru_cuda.bigru_bwd_fused_plain(*args))
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
    err, _ = bwd_errs(got, ref)
    rel = {n: max_rel(a.float(), r.float()) for n, a, r in zip(
        ("dX_f", "dX_b", *GRAD_NAMES[1:]), got, ref)}
    del got, ref
    b = fused_bound(B, N, H, D, torch.bfloat16)
    row = {"shape": [B, N, H, D], "dtype": "bfloat16",
           "fused_layer_fwd_bwd_ms": fused_ms,
           "unfused_layer_fwd_bwd_ms": unfused_ms,
           "fused_over_unfused": fused_ms / unfused_ms,
           "kernel_ms": kernel_ms, "chain_ms": chain_ms,
           "products_ms": kernel_ms - chain_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_us": b[0] * 1e3, "bound_by": b[1],
           "us_per_step": kernel_ms / N * 1e3, "err": err,
           "max_rel_err": max(rel.values()), "bit_equal": same,
           "launch": dict(gru_cuda.bigru_bwd_fused_cuda.last_launch)}
    log("fused_ab", json.dumps(row) + f" on {smi}  (library_ms: nn.GRU "
        "bidirectional bf16 forward + backward minus forward, phase 13: "
        "the layer's VJP with its input projection)")
    log("fused_ab", f"at plan {plan[0]}x{plan[1]}: #9 {kernel_ms:.3f} ms, #6 "
        f"{chain_ms:.3f} ms, #9 - #6 {kernel_ms - chain_ms:.3f} ms (the "
        "chunks' stops and products)")
    log("fused_ab", "#9's ten outputs vs its plain version max_rel_err "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
        + f" tol {BF16_GRAD_REL:g}; run twice bit-equal={same}; launch "
        + plan_text(gru_cuda.bigru_bwd_fused_cuda))
    assert same
    assert max(rel.values()) <= BF16_GRAD_REL, rel
    return row, launched


def run_bench_tool(dev, smi, checked):
    """Phase 28: ``room_slam_torch.tools.bench_bigru_bwd`` at the scale-up
    shape, ``--tiles auto --reps 5``; #6 and #10 launch in it (#10's path:
    its launches are counted around it), on the route's kernel at the
    plans phase 25 checked (``checked``)."""
    from room_slam_torch.tools import bench_bigru_bwd

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "bench_bigru_bwd.json"
        t0 = time.perf_counter()
        result = bench_bigru_bwd.main(
            ["--batch", str(SCALEUP[0]), "--seq", str(SCALEUP[1]),
             "--hidden", str(SCALEUP[2]), "--tiles", "auto", "--reps", "5",
             "--output", str(out)])
        assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    launched = gru_cuda.bigru_bwd_split_cuda.launches
    assert launched > 0 and counts()["bigru_bwd"] > 0, launched
    assert result["config"]["platform"] == "gpu"
    assert result["config"]["plans"] == [list(p) for p in checked], \
        (result["config"]["plans"], checked)
    assert result["config"]["kernel"] == checked[0][0], result["config"]
    log("bench_tool", f"bench_bigru_bwd in {time.perf_counter() - t0:.1f} s "
        f"on {smi}: launches bigru_bwd {counts()['bigru_bwd']}, "
        f"bigru_bwd_split {launched}; rows " + json.dumps(
            result["measured_ms"]))
    return result, launched


def time_split_route(dev, seed, smi, errs, plain_ms):
    """Phase 28, after the tool: at each of ``SPLIT_SHAPES`` #10 on the
    route, #10's first design (the split kind of the first cluster kernel
    at its planner's pick, where one fits) and #6 on the route, in turns
    (route, first, #6, #6, first, route; CUDA events), beside cuDNN's
    bidirectional backward (fp16 for bf16 streams; forward + backward
    minus forward) and the bound; #10's launches on the route are counted
    by shape. ``errs`` and ``plain_ms``: phase 25's, by shape and dtype."""
    rows = []
    for shape, dtype in SPLIT_SHAPES:
        B, N, H = shape
        args = gru_bwd_inputs(gru_inputs(*shape, dtype, dev, seed), seed + 1)
        iters = 3 if B * N >= 100000 else 10
        first = gru_cuda.card_plans("split", B, H, dev, dtype)
        fns = {"route": lambda: gru_cuda.bigru_bwd_split_cuda(*args),
               "bwd": lambda: gru_cuda.bigru_bwd_cuda(*args)}
        if first:
            fns["first"] = lambda: gru_cuda.bigru_bwd_split_cuda(
                *args, plan=("cluster", *first[0]))
        ms = {k: [] for k in fns}
        launches = 0
        for key in ("route", "first", "bwd", "bwd", "first", "route"):
            if key not in fns:
                continue
            before = gru_cuda.bigru_bwd_split_cuda.launches
            ms[key].append(cuda_ms(fns[key], iters))
            if key == "route":
                launches += gru_cuda.bigru_bwd_split_cuda.launches - before
                launch = dict(gru_cuda.bigru_bwd_split_cuda.last_launch)
        lib = _library_ms(torch.nn.GRU, B, N, H, dtype, dev, seed,
                          (2,))["bigru_bwd"]
        b = gru_bound("bwd", B, N, H, dtype)
        kernel_ms = float(np.mean(ms["route"]))
        row = {"shape": list(shape), "dtype": str(dtype)[6:],
               "kernel": launch["kernel"], "kernel_ms": kernel_ms,
               "route_ms": ms["route"], "bwd_ms": ms["bwd"],
               "first_ms": ms.get("first"),
               "first_plan": list(first[0]) if first else None,
               "plain_ms": plain_ms[(shape, dtype)], "library_ms": lib,
               "bound_us": b[0] * 1e3, "bound_by": b[1],
               "us_per_step": kernel_ms / N * 1e3,
               "err": errs[(shape, dtype)]["abs"],
               "max_rel_err": errs[(shape, dtype)]["rel"],
               "launch": launch, "launches": launches}
        log("split_route", json.dumps(row) + f" on {smi}  (library_ms: "
            "cuDNN's bidirectional nn.GRU, fp16 for bf16 streams, forward "
            "+ backward minus forward)")
        bwd_ms = float(np.mean(ms["bwd"]))
        first_ms = float(np.mean(ms["first"])) if first else None
        log("split_route",
            f"B,N,H={shape} {row['dtype']}: #10 on the {launch['kernel']} "
            f"kernel {kernel_ms:.3f} ms, #6 {bwd_ms:.3f} (#10 / #6 "
            f"{kernel_ms / bwd_ms:.3f}), #10's first design "
            + (f"{first_ms:.3f} ({first_ms / kernel_ms:.2f}x the route)"
               if first else "takes no plan")
            + f", cuDNN {lib:.3f}, bound {b[0]:.4f} ({b[1]})")
        assert launch["kernel"] == gru_cuda.bigru_bwd_cuda.last_launch[
            "kernel"], (shape, launch)
        rows.append(row)
    return rows


LSTM_BF16_NAMES = ("bilstm_fwd", "bilstm_fwd_train", "bilstm_bwd",
                   "lstm_fwd", "lstm_fwd_train", "lstm_bwd")


def check_lstm_bf16(dev, seed):
    """Phase 29, check: the six LSTM kernels in bf16 against their plain
    versions (values; BPTT max-rel) and the Functions' gradients against
    autograd through the plain loop; returns errors by kernel and shape."""
    bf = torch.bfloat16
    errs = {}

    def note(name, shape, e):
        errs[(name, shape)] = max(errs.get((name, shape), 0.0), e)

    for shape in LSTM_BF16_SHAPES:
        xg_f, xg_b, w_f, w_b = kernel_inputs(*shape, dev, seed)
        xg_f, xg_b = xg_f.to(bf), xg_b.to(bf)
        ins = (xg_f, xg_b, w_f, w_b)
        note("bilstm_fwd", shape, value_err(
            rnn_cuda.bilstm_fwd_cuda(*ins),
            rnn_cuda.bilstm_recurrence_plain(*ins), bf))
        res = rnn_cuda.bilstm_fwd_train_plain(*ins)
        note("bilstm_fwd_train", shape, value_err(
            rnn_cuda.bilstm_fwd_train_cuda(*ins), res, bf))
        g = torch.Generator(dev).manual_seed(seed + 1)
        dy_f, dy_b = (torch.randn(res[0].shape, device=dev, generator=g
                                  ).to(bf) for _ in range(2))
        args = (w_f, w_b, res[4], res[2], dy_f, res[5], res[3], dy_b)
        b_ref = rnn_cuda.bilstm_bwd_plain(*args)
        b_abs, b_rel = bwd_errs(rnn_cuda.bilstm_bwd_cuda(*args), b_ref)
        assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "unit"
        # the BPTT under every plan the card runs (unit tiles, wide)
        plan_rel = [bwd_errs(rnn_cuda.bilstm_bwd_cuda(*args, plan=p),
                             b_ref)[1]
                    for p in lstm_bwd_plans(shape[0], shape[2], dev, bf, 2)]
        assert max(b_rel, *plan_rel) <= BF16_GRAD_REL, (b_rel, plan_rel)
        note("bilstm_bwd", shape, b_abs)
        fn_rel = grads_rel(rnn_cuda.bilstm_recurrence,
                           rnn_cuda.bilstm_recurrence_plain, ins,
                           [dy_f, dy_b], bf)
        single = []
        for reverse in (False, True):
            note("lstm_fwd", shape, value_err(
                (rnn_cuda.lstm_fwd_cuda(xg_f, w_f, reverse),),
                (rnn_cuda.lstm_recurrence(xg_f, w_f, reverse),), bf))
            ref = rnn_cuda.lstm_fwd_train_plain(xg_f, w_f, reverse)
            note("lstm_fwd_train", shape, value_err(
                rnn_cuda.lstm_fwd_train_cuda(xg_f, w_f, reverse), ref, bf))
            s_args = (w_f, ref[2], ref[1], dy_f, reverse)
            s_ref = (rnn_cuda.lstm_bwd_plain(*s_args),)
            s_abs, s_rel = bwd_errs((rnn_cuda.lstm_bwd_cuda(*s_args),), s_ref)
            assert rnn_cuda.lstm_bwd_cuda.last_launch["kernel"] == "unit"
            plan_rel += [bwd_errs((rnn_cuda.lstm_bwd_cuda(*s_args, plan=p),),
                                  s_ref)[1]
                         for p in lstm_bwd_plans(shape[0], shape[2], dev, bf,
                                                 1)]
            assert max(s_rel, *plan_rel) <= BF16_GRAD_REL, (s_rel, plan_rel)
            note("lstm_bwd", shape, s_abs)
            single += grads_rel(
                lambda *a: rnn_cuda.lstm_recurrence_kernel(*a, reverse),
                lambda *a: rnn_cuda.lstm_recurrence(*a, reverse),
                (xg_f, w_f), dy_f, bf)
        log("lstm_bf16_check",
            f"B,N,H={shape} bfloat16: max_abs_err "
            + " ".join(f"{n}={errs[(n, shape)]:.3e}" for n in LSTM_BF16_NAMES)
            + f" (values rtol {BF16_RTOL} atol {BF16_ATOL}); bilstm_bwd "
            f"max_rel_err={b_rel:.3e}, every BPTT plan (bilstm_bwd, lstm_bwd)"
            f" {max(plan_rel):.3e}; BiLSTMFunction vs autograd through "
            "the plain loop max_rel_err (dxg_f, dxg_b, dW_f, dW_b) "
            + " ".join(f"{v:.3e}" for v in fn_rel)
            + "; LSTMFunction (dxg, dW_hh, both walk orders) "
            + " ".join(f"{v:.3e}" for v in single)
            + f" tol {BF16_GRAD_REL:g}")
    return errs


def yardstick_ms(fns, rounds: int = YARDSTICK_ROUNDS):
    """Library times for phase 29: each of ``fns`` (a name to a callable)
    over 20 calls after 2 warm-up (phase 19's counts), in ``rounds`` rounds;
    per name the median, the spread (max - min) and the rounds. The "bwd"
    entry is "fwd_bwd" minus "fwd_train" round by round."""
    runs = []
    for _ in range(rounds):
        r = {k: cuda_ms(f, 20) for k, f in fns.items()}
        r["bwd"] = r.pop("fwd_bwd") - r["fwd_train"]
        runs.append(r)
    return {k: {"median": float(np.median([r[k] for r in runs])),
                "spread": max(r[k] for r in runs) - min(r[k] for r in runs),
                "rounds": [r[k] for r in runs]} for k in runs[0]}


def time_lstm_bf16(dev, seed, errs):
    """Phase 29, timing: each LSTM kernel in bf16 at its f32 table shape,
    its plain version, the bound, torch ``nn.LSTM`` in bf16 (cuDNN takes no
    bf16 RNN, so PyTorch's own step loop) and cuDNN in fp16 (never called
    by the port; input projection included), each the median of
    ``yardstick_ms``'s rounds with their spread."""
    bf = torch.bfloat16
    shapes = {"bilstm_fwd": BENCH, "bilstm_fwd_train": TRAIN,
              "bilstm_bwd": TRAIN, "lstm_fwd": LEGACY,
              "lstm_fwd_train": LEGACY, "lstm_bwd": LEGACY}
    lib = {}
    for shape, dirs in ((BENCH, 2), (TRAIN, 2), (LEGACY, 1)):
        B, N, H = shape
        g = torch.Generator(dev).manual_seed(seed)
        x = torch.randn(B, N, 2 * H, device=dev, generator=g)
        dy = torch.randn(B, N, dirs * H, device=dev, generator=g)
        m = torch.nn.LSTM(2 * H, H, batch_first=True,
                          bidirectional=dirs == 2).to(dev)
        for key, dt in (("bf16", bf), ("cudnn_fp16", torch.float16)):
            m = m.to(dt)
            m.flatten_parameters()
            xi = x.to(dt).requires_grad_(True)
            dyi = dy.to(dt)

            def light():
                with torch.no_grad():
                    return m(xi)

            lib[(shape, dirs, key)] = yardstick_ms({
                "fwd": light, "fwd_train": lambda: m(xi),
                "fwd_bwd": lambda: m(xi)[0].backward(dyi)})
    rows = {}
    for name in LSTM_BF16_NAMES:
        B, N, H = shape = shapes[name]
        dirs = 2 if name.startswith("bi") else 1
        xg_f, xg_b, w_f, w_b = kernel_inputs(*shape, dev, seed)
        xg_f, xg_b = xg_f.to(bf), xg_b.to(bf)
        dy = torch.randn(B, N, H, device=dev, generator=torch.Generator(
            dev).manual_seed(seed + 1)).to(bf)
        if dirs == 2:
            res = rnn_cuda.bilstm_fwd_train_plain(xg_f, xg_b, w_f, w_b)
            a = {"bilstm_fwd": (xg_f, xg_b, w_f, w_b),
                 "bilstm_fwd_train": (xg_f, xg_b, w_f, w_b),
                 "bilstm_bwd": (w_f, w_b, res[4], res[2], dy, res[5],
                                res[3], dy)}[name]
        else:
            res = rnn_cuda.lstm_fwd_train_plain(xg_f, w_f)
            a = {"lstm_fwd": (xg_f, w_f), "lstm_fwd_train": (xg_f, w_f),
                 "lstm_bwd": (w_f, res[2], res[1], dy)}[name]
        fn = getattr(rnn_cuda, f"{name}_cuda")
        plain = {"bilstm_fwd": rnn_cuda.bilstm_recurrence_plain,
                 "bilstm_fwd_train": rnn_cuda.bilstm_fwd_train_plain,
                 "bilstm_bwd": rnn_cuda.bilstm_bwd_plain,
                 "lstm_fwd": rnn_cuda.lstm_recurrence,
                 "lstm_fwd_train": rnn_cuda.lstm_fwd_train_plain,
                 "lstm_bwd": rnn_cuda.lstm_bwd_plain}[name]
        kind = name.split("_", 1)[1]
        bnd = {"fwd": bilstm_bound, "fwd_train": fwd_train_bound,
               "bwd": bwd_bound}[kind](B, N, H, dirs, bf)
        ms = cuda_ms(lambda: fn(*a), 10)
        torch_bf16 = lib[(shape, dirs, "bf16")][kind]
        fp16 = lib[(shape, dirs, "cudnn_fp16")][kind]
        rows[name] = {
            "shape": list(shape), "dtype": "bfloat16", "kernel_ms": ms,
            "plain_ms": cuda_ms(lambda: plain(*a), 1, warmup=1),
            "library_ms": torch_bf16["median"],
            "library_spread_ms": torch_bf16["spread"],
            "cudnn_fp16_ms": fp16["median"],
            "cudnn_fp16_spread_ms": fp16["spread"],
            "cudnn_fp16_rounds_ms": fp16["rounds"],
            "bound_us": bnd[0] * 1e3, "bound_by": bnd[1],
            "us_per_step": ms / N * 1e3,
            "cudnn_fp16_us_per_step": fp16["median"] / N * 1e3,
            "err": max(v for (n, _), v in errs.items() if n == name)}
        plans = (lstm_bwd_plans(B, H, dev, bf, dirs) if kind == "bwd" else
                 lstm_plans(B, H, dev, bf, kind == "fwd_train", dirs))
        rows[name]["plans"] = plan_sweep(name, fn, a, plans, shape, 10)
        rows[name]["launch"] = dict(fn.last_launch)
        log("lstm_bf16_time", f"{name} " + json.dumps(rows[name]) + (
            "  (library_ms: nn.LSTM " + ("bidirectional " if dirs == 2
                                         else "unidirectional ")
            + "bf16, PyTorch's own step loop; cudnn_fp16_ms: the same in fp16"
            f" through cuDNN; each the median of {YARDSTICK_ROUNDS} rounds of"
            " 20 calls after 2 warm-up, spread = max - min; both " + {
                "fwd": "forward without grad",
                "fwd_train": "forward with grad on",
                "bwd": "forward + backward minus forward"}[kind]
            + ", includes the input projection)"))
    return rows


def flagship_bf16_path(dev, seed, smi):
    """Phase 30: the flagship config with ``compute_dtype`` bfloat16 at full
    width with seeded weights: a B=32, N=500 forward through the kernels
    against the plain recurrence on the card, one served 3000-point
    request against the plain recurrence, and 3 training steps on phase
    8's rooms, launch counts read around each."""
    cfg = ExperimentConfig.from_json(CONFIG).apply_overrides(
        ["model.compute_dtype=bfloat16"])
    mcfg = cfg.model
    layers = mcfg.lstm_layers
    model = build_model(mcfg)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    B, N = BENCH[:2]
    raw = np.stack([walk(N, seed + 1 + b) for b in range(B)])
    lengths = np.random.default_rng(seed).integers(N // 2, N + 1, size=B)
    lengths[0] = N
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.from_numpy(lengths).to(dev))
    def plain():
        return mock.patch.object(lstm_mod, "bilstm_recurrence",
                                 rnn_cuda.bilstm_recurrence_plain)

    with torch.inference_mode():
        reset_counts()
        out = model(feats, mask)
        torch.cuda.synchronize()
        fwd_counts = counts()
        assert fwd_counts == expected_counts(bilstm_fwd=layers), fwd_counts
        with plain():
            ref = model(feats, mask)
    fwd_err = max(bf16_close(out[k], ref[k]) for k in out)
    predict = build_predictor(model, max_trace_len=cfg.data.max_trace_len,
                              confidence_threshold=0.0, nms_threshold=0.3,
                              device=dev, verbose=False)
    arr = walk(2 * cfg.data.max_trace_len, seed + 100)
    reset_counts()
    cols = predict(arr)
    torch.cuda.synchronize()
    serve_counts = counts()
    assert serve_counts == expected_counts(bilstm_fwd=layers), serve_counts
    with plain():
        ref_cols = predict(arr)
    assert len(cols) > 0
    assert [c["label"] for c in cols] == [c["label"] for c in ref_cols]
    col_err = max(bf16_close(collider_values(a), collider_values(b))
                  for a, b in zip(cols, ref_cols))
    steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, _ = make_rooms(Path(tmp) / "rooms", ROOMS, seed)
        ds = TraceColliderArrays(train_dir, cfg.data, augment=True,
                                 verbose=False)
        data = {k: torch.from_numpy(v).to(dev)
                for k, v in ds.device_arrays().items()}
        plan = ds.epoch_plan(cfg.train.batch_size, seed=seed)
        tmodel = build_model(mcfg, generator=torch.Generator()
                             .manual_seed(seed)).to(dev)
        step = loop.make_train_step(tmodel, loop.make_optimizer(tmodel, cfg),
                                    cfg, augment=True)
        gen = torch.Generator(dev).manual_seed(seed)
        reset_counts()
        losses = [float(step(loop.gather_batch(data, plan, i), gen)
                        ["total_loss"]) for i in range(steps)]
        torch.cuda.synchronize()
    train_counts = counts()
    assert train_counts == expected_counts(
        bilstm_fwd_train=layers * steps, bilstm_bwd=layers * steps), \
        train_counts
    assert np.isfinite(losses).all(), losses
    log("flagship_bf16",
        f"lstm d_model={mcfg.d_model} {mcfg.compute_dtype}: forward B={B} "
        f"N={N} vs the plain recurrence on the card max abs diff "
        f"{fwd_err:.3e}; served {len(arr)} points: {len(cols)} colliders, "
        f"labels equal to the plain recurrence's, values max abs diff "
        f"{col_err:.3e} (rtol {BF16_RTOL} atol {BF16_ATOL}); {steps} train "
        f"steps B={cfg.train.batch_size} N={cfg.data.max_trace_len}: losses "
        f"{losses}; launches forward {fwd_counts}, serving {serve_counts}, "
        f"training {train_counts} on {smi}")
    return {k: fwd_counts[k] + serve_counts[k] + train_counts[k]
            for k in fwd_counts}


# ---------------------------------------------------------------------------
# Phases 8 (resume, evaluation) and 31-34: resuming the flagship run, the
# benchmark surface's evaluation, and the widths above the unit and wide
# kernels: the LSTM cluster route and the GRU cluster kernels' masked
# slices
# ---------------------------------------------------------------------------


def resume_path(cfg, train_dir, val_dir, save_dir, epochs, dev, first):
    """Phase 8, then: ``train_benchmark`` resumed from the periodic
    checkpoint of the last epoch for one more epoch; the restored epoch,
    the learning rate its schedule gives there, AdamW's step count (the
    first run's and this epoch's steps) and no recovery are asserted.
    Returns the launches (counted around the resumed run)."""
    cfg = copy.deepcopy(cfg)
    cfg.data.data_dir, cfg.data.val_dir = str(train_dir), str(val_dir)
    cfg.train.num_epochs = epochs + 1
    cfg.train.save_dir = str(save_dir)
    ck = Path(save_dir) / f"checkpoint_epoch_{epochs - 1}"
    side = json.loads(ck.with_suffix(".json").read_text())
    assert side["has_opt_state"] and side["epoch"] == epochs - 1, side
    train_ds = TraceColliderArrays(train_dir, cfg.data, augment=True,
                                   verbose=False)
    val_ds = TraceColliderArrays(val_dir, cfg.data, augment=False,
                                 verbose=False)
    steps = train_ds.num_batches(cfg.train.batch_size)
    reset_counts()
    res = train_benchmark(cfg, device=dev, verbose=True, train_ds=train_ds,
                          val_ds=val_ds, resume=str(ck))
    torch.cuda.synchronize()
    launched = counts()
    if cfg.train.lr_schedule == "cosine":
        want_lr = loop.warmup_cosine_lr(cfg, epochs)
    else:
        t = cfg.train
        sched = loop.PlateauScheduler(
            lr=t.lr, factor=t.plateau_factor, patience=t.plateau_patience,
            cooldown=t.plateau_cooldown, min_lr=t.lr * t.plateau_min_scale)
        sched.load_state_dict(side["sched"])
        want_lr = sched.step(res["history"][-1]["val_loss"])
    assert res["start_epoch"] == epochs and res["recoveries"] == 0, res
    assert [h["epoch"] for h in res["history"]] == [epochs]
    assert res["count"] == first["count"] + steps, (res["count"],
                                                    first["count"], steps)
    assert abs(res["lr"] - want_lr) <= 1e-9 * max(want_lr, 1.0), (
        res["lr"], want_lr)
    layers = cfg.model.lstm_layers
    assert launched["bilstm_fwd_train"] == launched["bilstm_bwd"] == \
        layers * steps, launched
    log("train_resume", f"resumed {ck.name} (epoch {side['epoch']}, AdamW "
        f"count {first['count']}) for epoch {res['start_epoch']}: count "
        f"{res['count']} (+{steps} steps), lr {res['lr']:.6g} "
        f"({cfg.train.lr_schedule}), recoveries {res['recoveries']}, "
        f"train_loss {res['history'][-1]['train_loss']:.4f}; launches "
        f"{launched}")
    return launched


EVAL_KW = dict(batch_size=8, iou_thresh=0.5, threshold=0.1, nms=0.3)


def evaluate_path(best, val_dir, dev, **passes):
    """Phase 8, last: ``evaluate_benchmark`` on the flagship checkpoint on
    the card against the same call on the CPU: the metric sums' mIoU,
    precision, recall, F1 and class accuracy within 1e-3, and the kept
    detections compared; mAP equal where the kept sets are equal. Then
    again with the post-passes ``passes`` (``refine``,
    ``refine_furniture``, ``extent_slack``). Returns the launches of the
    card's evaluation."""
    kw = dict(EVAL_KW, **passes)
    reset_counts()
    t0 = time.perf_counter()
    got = evaluate_benchmark(str(best), str(val_dir), device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    want = evaluate_benchmark(str(best), str(val_dir), device="cpu", **kw)
    for k in ("mIoU", "precision", "recall", "f1", "cls_acc"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    rows = {d: benchmark_rows(str(best), str(val_dir), device=d, **kw)[1]
            for d in (dev, "cpu")}
    kept = [[(r[1], r[3]) for r in rows[d]] for d in (dev, "cpu")]
    same = kept[0] == kept[1]
    if same and "mAP" in want:
        assert abs(got["mAP"] - want["mAP"]) <= 1e-6, (got["mAP"],
                                                      want["mAP"])
    log("evaluate", f"evaluate_benchmark {best.name} on {val_dir.name} "
        f"({kw}) in {wall:.1f} s: "
        + json.dumps({k: got[k] for k in got if k != "AP_per_class"})
        + f"; vs the CPU: "
        + " ".join(f"{k} {abs(got[k] - want[k]):.2e}" for k in
                   ("mIoU", "precision", "recall", "f1", "cls_acc"))
        + f" (tol 1e-3); kept sets equal: {same} ({len(kept[0])} / "
          f"{len(kept[1])} detections); mAP card {got.get('mAP')} CPU "
          f"{want.get('mAP')}; launches {launched}")
    return launched


def _lstm_bwd_case(ins, dtype, seed):
    """The BPTT's arguments on the plain training forward's residuals of
    ``ins``, the upstream gradient in the stream dtype."""
    res = rnn_cuda.bilstm_fwd_train_plain(*ins)
    g = torch.Generator(ins[0].device).manual_seed(seed)
    dy_f, dy_b = (torch.randn(res[0].shape, device=ins[0].device,
                              generator=g).to(dtype) for _ in range(2))
    return (ins[2], ins[3], res[4], res[2], dy_f, res[5], res[3], dy_b)


def _lstm_cluster_case(H, B, dtype, dev, seed, kernel, plan_of=None,
                       n=CLUSTER_N, bwd_kernel=None, fwd_again=False,
                       bwd=True):
    """The six LSTM kernels at (B, ``n``, H) in ``dtype`` (``bwd`` False:
    the four forwards) against their plain versions (f32 max abs err
    ``KERNEL_ATOL`` on values, ``GRAD_REL`` on dg; bf16 rtol / atol and
    ``BF16_GRAD_REL``), each launch's kernel asserted ``kernel`` (the
    BPTT's ``bwd_kernel``, by default the same), the BPTT (and with
    ``fwd_again`` the forwards) bit-equal on a second launch;
    ``plan_of(kind, save, dirs)`` forces a plan. Returns the values' and
    dg's worst errors and the plans."""
    xg_f, xg_b, w_f, w_b = kernel_inputs(B, n, H, dev, seed)
    xg_f, xg_b = xg_f.to(dtype), xg_b.to(dtype)
    ins = (xg_f, xg_b, w_f, w_b)
    plans, errs = [], []

    def kw(kind, save, dirs):
        return {} if plan_of is None else {"plan": plan_of(kind, save,
                                                           dirs)}
    for name, fn, a, ref, save, dirs in (
            ("bilstm_fwd", rnn_cuda.bilstm_fwd_cuda, ins,
             rnn_cuda.bilstm_recurrence_plain(*ins), False, 2),
            ("bilstm_fwd_train", rnn_cuda.bilstm_fwd_train_cuda,
             ins, rnn_cuda.bilstm_fwd_train_plain(*ins), True, 2),
            ("lstm_fwd", rnn_cuda.lstm_fwd_cuda,
             (xg_b, w_b, True),
             (rnn_cuda.lstm_recurrence(xg_b, w_b, True),), False, 1),
            ("lstm_fwd_train", rnn_cuda.lstm_fwd_train_cuda,
             (xg_f, w_f, False),
             rnn_cuda.lstm_fwd_train_plain(xg_f, w_f), True, 1)):
        got = fn(*a, **kw("fwd", save, dirs))
        got = got if isinstance(got, tuple) else (got,)
        assert fn.last_launch["kernel"] == kernel, (name, fn.last_launch)
        if fwd_again:
            again = fn(*a, **kw("fwd", save, dirs))
            again = again if isinstance(again, tuple) else (again,)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), name
        errs.append(value_err(got, ref, dtype))
        plans.append(f"{name} {plan_text(fn)}")
    if not bwd:
        torch.cuda.synchronize()
        return max(errs), 0.0, plans
    args = _lstm_bwd_case(ins, dtype, seed + 1)
    ref = rnn_cuda.bilstm_bwd_plain(*args)
    tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
    rels = []
    for name, fn, a, r, dirs in (
            ("bilstm_bwd", rnn_cuda.bilstm_bwd_cuda, args, ref, 2),
            ("lstm_bwd", rnn_cuda.lstm_bwd_cuda,
             (args[0], *args[2:5], False), ref[:1], 1),
            ("lstm_bwd", rnn_cuda.lstm_bwd_cuda,
             (args[1], *args[5:8], True), ref[1:], 1)):
        got = fn(*a, **kw("bwd", False, dirs))
        got = got if isinstance(got, tuple) else (got,)
        assert fn.last_launch["kernel"] == (bwd_kernel or kernel), (
            name, fn.last_launch)
        again = fn(*a, **kw("bwd", False, dirs))
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), name
        rels += [max_rel(x.float(), y.float()) for x, y in zip(got, r)]
        assert all(torch.isfinite(x).all() for x in got)
        plans.append(f"{name} {plan_text(fn)}")
    assert max(rels) <= tol, (H, B, dtype, rels)
    torch.cuda.synchronize()
    return max(errs), max(rels), plans


def check_lstm_cluster(dev, seed):
    """Phase 31: the LSTM cluster route (H above the wide kernels) at
    ``CLUSTER_WIDTHS`` x ``CLUSTER_BATCHES``, N=``CLUSTER_N``, float32 and
    bf16: the light and training forward and the BPTT, two directions and
    one (both walk orders), each launch's route asserted "reg" (the
    register cluster kernels) and its plan printed, against the plain
    versions, the BPTT bit-equal run to run (``_lstm_cluster_case``); then
    the first cluster kernels, forced at their planner's pick, at
    ``OLD_CLUSTER_WIDTHS`` and B=5."""
    worst = {}
    for H in CLUSTER_WIDTHS:
        for B in CLUSTER_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                err, rel, plans = _lstm_cluster_case(H, B, dtype, dev, seed,
                                                     "reg")
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), err)
                log("lstm_cluster", f"B,N,H=({B}, {CLUSTER_N}, {H}) {key}: "
                    f"values max_abs_err={err:.3e}, dg max_rel_err="
                    f"{rel:.3e}, BPTT bit-equal run to run; "
                    + "; ".join(plans))
    for dtype, H in OLD_CLUSTER_WIDTHS.items():
        B = 5

        def old(kind, save, dirs):
            return ("cluster", *rnn_cuda.card_lstm_cluster_plans(
                kind, B, H, dev, dtype, save, dirs)[0])
        err, rel, plans = _lstm_cluster_case(H, B, dtype, dev, seed,
                                             "cluster", old)
        log("lstm_cluster", f"first cluster kernels, forced: B,N,H=({B}, "
            f"{CLUSTER_N}, {H}) {str(dtype)[6:]}: values max_abs_err="
            f"{err:.3e}, dg max_rel_err={rel:.3e}; " + "; ".join(plans))
    return worst


def check_gru_masked(dev, seed):
    """Phase 32: the GRU cluster kernels' masked slices (the first design,
    forced at its planner's pick since the register cluster kernels took
    the route) at ``MASKED_WIDTHS``, B in ``MASKED_BATCHES``,
    N=``MASKED_N``, float32 and bf16: the BiGRU light and training forward
    and BPTT and the one-direction GRU's, each launch on the cluster kernel
    with a cluster size that does not divide H (asserted, printed), against
    the plain versions (bounds as phase 31)."""
    for H in MASKED_WIDTHS:
        for B in MASKED_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                ins = gru_inputs(B, MASKED_N, H, dtype, dev, seed)
                args = gru_bwd_inputs(ins, seed + 1)
                ref_b = gru_cuda.bigru_bwd_plain(*args)
                tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
                plans, errs, rels = [], [], []
                for name, fn, a, ref, bwd in (
                        ("bigru_fwd", gru_cuda.bigru_fwd_cuda, ins,
                         gru_cuda.bigru_fwd_plain(*ins), False),
                        ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda,
                         ins, gru_cuda.bigru_fwd_train_plain(*ins), False),
                        ("bigru_bwd", gru_cuda.bigru_bwd_cuda, args, ref_b,
                         True),
                        ("gru_fwd", gru_cuda.gru_fwd_cuda,
                         (ins[1], ins[4], ins[5], True),
                         (gru_cuda.gru_recurrence(ins[1], ins[4], ins[5],
                                                  True),), False),
                        ("gru_fwd_train", gru_cuda.gru_fwd_train_cuda,
                         (ins[0], ins[2], ins[3], False),
                         gru_cuda.gru_fwd_train_plain(ins[0], ins[2],
                                                      ins[3]), False),
                        ("gru_bwd", gru_cuda.gru_bwd_cuda,
                         (args[1], *args[6:], True), ref_b[2:], True)):
                    plan = ("cluster", *gru_cuda.card_plans(
                        "bwd" if bwd else "fwd", B, H, dev, dtype,
                        2 if name.startswith("bi") else 1)[0])
                    got = fn(*a, plan=plan)
                    got = got if isinstance(got, tuple) else (got,)
                    last = fn.last_launch
                    assert last["kernel"] == "cluster" and \
                        H % last["cluster"], (name, last)
                    if bwd:
                        rels += [max_rel(x.float(), y.float())
                                 for x, y in zip(got, ref)]
                        assert all(torch.isfinite(x).all() for x in got)
                    else:
                        errs.append(value_err(got, ref, dtype))
                    plans.append(f"{name} {plan_text(fn)}")
                assert max(rels) <= tol, (H, B, dtype, rels)
                torch.cuda.synchronize()
                log("gru_masked", f"B,N,H=({B}, {MASKED_N}, {H}) "
                    f"{str(dtype)[6:]}: values max_abs_err={max(errs):.3e},"
                    f" dx/dhn max_rel_err={max(rels):.3e}; "
                    + "; ".join(plans))
    return MASKED_WIDTHS


def _library_ms(mod, B, N, H, dtype, dev, seed, dir_counts=(2, 1)):
    """cuDNN's ``mod`` (``nn.LSTM`` / ``nn.GRU``; fp16 for bf16 streams,
    which cuDNN refuses) at (B, N, H) in each of ``dir_counts`` (both by
    default), input projection included, never called by the port:
    forward without grad, forward with grad on, and forward + backward
    minus forward, ms by wrapper name."""
    fam = "lstm" if mod is torch.nn.LSTM else "gru"
    dt = torch.float16 if dtype == torch.bfloat16 else torch.float32
    g = torch.Generator(dev).manual_seed(seed)
    out = {}
    for dirs in dir_counts:
        lib = mod(2 * H, H, batch_first=True,
                  bidirectional=dirs == 2).to(dev, dt)
        x = torch.randn(B, N, 2 * H, device=dev, generator=g).to(dt)
        x.requires_grad_(True)
        dy = torch.randn(B, N, dirs * H, device=dev, generator=g).to(dt)
        pre = "bi" if dirs == 2 else ""
        with torch.no_grad():
            out[f"{pre}{fam}_fwd"] = cuda_ms(lambda: lib(x), 5)
        fwd = cuda_ms(lambda: lib(x), 5)
        out[f"{pre}{fam}_fwd_train"] = fwd
        out[f"{pre}{fam}_bwd"] = cuda_ms(lambda: lib(x)[0].backward(dy),
                                         5) - fwd
    return out


def _time_row(name, fn, plain, a, bnd, lib_ms, dtype, shape, **extra):
    """One kernel's row: its time over 5 calls after 2 (CUDA events),
    the plain version's over one call, the bound, the library's time and
    µs a step; errors against the plain version asserted."""
    got = fn(*a)
    launch = dict(fn.last_launch)
    ref, plain_ms = timed_once(lambda: plain(*a))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if name.endswith("bwd"):
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, ref))
        assert max(max_rel(x.float(), y.float()) for x, y in zip(got, ref)) \
            <= (GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL), name
    else:
        err = value_err(got, ref, dtype)
    ms = cuda_ms(lambda: fn(*a), 5)
    N = shape[1]
    return {"shape": list(shape),
            "dtype": str(dtype)[6:], "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_us": bnd[0] * 1e3,
            "bound_by": bnd[1], "us_per_step": ms / N * 1e3,
            "library_us_per_step": lib_ms / N * 1e3, "err": err,
            "launch": launch, **extra}


def _lstm_cases(B, N, H, dtype, dev, seed):
    """The six LSTM wrappers at (B, N, H) in ``dtype``: name, wrapper,
    plain version, arguments, bound, kind, kSave and directions."""
    xg_f, xg_b, w_f, w_b = kernel_inputs(B, N, H, dev, seed)
    ins = (xg_f.to(dtype), xg_b.to(dtype), w_f, w_b)
    args = _lstm_bwd_case(ins, dtype, seed + 1)
    kw = {"dtype": dtype}
    return (
        ("bilstm_fwd", rnn_cuda.bilstm_fwd_cuda,
         rnn_cuda.bilstm_recurrence_plain, ins, bilstm_bound(B, N, H, **kw),
         "fwd", False, 2),
        ("bilstm_fwd_train", rnn_cuda.bilstm_fwd_train_cuda,
         rnn_cuda.bilstm_fwd_train_plain, ins,
         fwd_train_bound(B, N, H, **kw), "fwd", True, 2),
        ("bilstm_bwd", rnn_cuda.bilstm_bwd_cuda, rnn_cuda.bilstm_bwd_plain,
         args, bwd_bound(B, N, H, **kw), "bwd", False, 2),
        ("lstm_fwd", rnn_cuda.lstm_fwd_cuda, rnn_cuda.lstm_recurrence,
         (ins[0], ins[2]), bilstm_bound(B, N, H, dirs=1, **kw), "fwd",
         False, 1),
        ("lstm_fwd_train", rnn_cuda.lstm_fwd_train_cuda,
         rnn_cuda.lstm_fwd_train_plain, (ins[0], ins[2]),
         fwd_train_bound(B, N, H, dirs=1, **kw), "fwd", True, 1),
        ("lstm_bwd", rnn_cuda.lstm_bwd_cuda, rnn_cuda.lstm_bwd_plain,
         (args[0], *args[2:5]), bwd_bound(B, N, H, dirs=1, **kw), "bwd",
         False, 1))


def time_new_routes(dev, seed):
    """Phase 33: the new routes' timing. The six LSTM kernels on the
    register cluster route at ``LSTM_REG_TIME``, at the first shape each
    beside the first cluster kernel forced at its planner's pick in the
    same call (ms, µs a step; PERF.md keeps PR 15's times of the others),
    and at the first shape under the card's first
    ``REG_SWEEP_PLANS`` register plans; kernel ms (CUDA events), plain ms,
    the bound, cuDNN's ``nn.LSTM`` (bidirectional for the two-direction
    kernels; fp16 for bf16 streams; never called by the port; input
    projection included) and µs a step. (The six GRU kernels, timed here at
    (32, 500, 255) on their masked slices until the GRU register cluster
    kernels took the route, are phase 41's.) Returns the rows by wrapper
    name, a list each, the (32, 500, 256) f32 row first."""
    rows = {}
    for (B, N, H), dtype in LSTM_REG_TIME:
        lib_ms = _library_ms(torch.nn.LSTM, B, N, H, dtype, dev, seed)
        for name, fn, plain, a, bnd, kind, save, dirs in _lstm_cases(
                B, N, H, dtype, dev, seed):
            extra = {}
            if name not in rows:   # the first shape: the first design too
                old = ("cluster", *rnn_cuda.card_lstm_cluster_plans(
                    kind, B, H, dev, dtype, save, dirs)[0])
                old_ms = cuda_ms(lambda: fn(*a, plan=old), 3, warmup=1)
                extra = {"old_cluster_ms": old_ms,
                         "old_cluster_us_per_step": old_ms / N * 1e3,
                         "old_cluster_launch": dict(fn.last_launch)}
            row = _time_row(name, fn, plain, a, bnd, lib_ms[name], dtype,
                            (B, N, H), **extra)
            assert row["launch"]["kernel"] == "reg", (name, row["launch"])
            if name not in rows:   # the first shape: the plans swept
                row["plans"] = plan_sweep(
                    name, fn, a, [("reg", *p) for p in
                                  rnn_cuda.card_lstm_reg_plans(
                                      kind, B, H, dev, dtype, save, dirs)[
                                      :REG_SWEEP_PLANS]], (B, N, H), 3)
            rows.setdefault(name, []).append(row)
            log("kernel_time", f"{name} (register cluster route) "
                + json.dumps(row) + "  (library_ms: cuDNN "
                + ("bidirectional " if name.startswith("bi") else
                   "unidirectional ") + "nn.LSTM "
                + ("fp16" if dtype == torch.bfloat16 else "f32") + ", "
                + {"fwd": "forward without grad", "fwd_train":
                   "forward with grad on", "bwd": "forward + backward "
                   "minus forward"}[name.split("_", 1)[1]]
                + ", includes the input projection; old_cluster_ms (the "
                "first shape): the first cluster kernel forced at its "
                "planner's pick)")
    return rows


LSTM_PLAIN = {"bilstm_fwd_cuda": rnn_cuda.bilstm_recurrence_plain,
              "bilstm_fwd_train_cuda": rnn_cuda.bilstm_fwd_train_plain,
              "bilstm_bwd_cuda": rnn_cuda.bilstm_bwd_plain}


def wide_paths(dev, seed, smi):
    """Phase 34, the new routes' main paths, the counts set to 0 just
    before each and read just after: (a) the flagship ``lstm`` at
    d_model ``WIDE_LSTM_D`` (H=256, f32), a forward at ``WIDE_TIME``'s B and
    N through the register cluster kernels against the plain recurrence,
    then one train step with the kernels, with the plain versions patched
    in and on the CPU (equal assignments, losses rel ``LOSS_RTOL``); (b) ``lstm_recurrence(use_kernel=True)`` at
    ``WIDE_TIME`` forward and backward; (c) a ``bigru`` at d_model
    2 x ``WIDE_GRU``'s H (f32, a masked slice; on the GRU register cluster
    kernels since they took the route), one forward and one train step;
    (d) ``gru_recurrence(use_kernel=True)`` at ``WIDE_GRU`` forward and
    backward (the register kernels). Returns each path's launches."""
    out = {}
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.model.d_model = WIDE_LSTM_D
    cfg.model.dropout = 0.0
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    B, N = WIDE_TIME[:2]
    raw = np.stack([walk(N, seed + 500 + b) for b in range(B)])
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.full((B,), N, device=dev))
    layers = cfg.model.lstm_layers
    with torch.inference_mode():
        reset_counts()
        res = model(feats, mask)
        torch.cuda.synchronize()
        out["lstm_forward"] = counts()
        assert out["lstm_forward"] == expected_counts(bilstm_fwd=layers)
        assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "reg"
        with mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain):
            ref = model(feats, mask)
    fwd_err = max((res[k] - ref[k]).abs().max().item() for k in res)
    for k in res:
        assert torch.allclose(res[k], ref[k], rtol=MODEL_TOL,
                              atol=MODEL_TOL), k
    # one train step with the kernels, with the plain versions on the card
    # and on the CPU
    tcfg = copy.deepcopy(cfg)
    tcfg.train.batch_size = 8
    tcfg.train.matmul_precision = "float32"    # the kernels are the change
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), 8, seed + 600)
        ds = TraceColliderArrays(tmp, tcfg.data, augment=False,
                                 verbose=False)
        host = ds.gather(np.arange(8) % ds.num_samples)
    cpu_model = copy.deepcopy(model).cpu()
    res_steps = {}
    cpu = torch.device("cpu")
    for name, patch, d in (("kernels", None, dev), ("plain", LSTM_PLAIN, dev),
                           ("cpu", None, cpu)):
        reset_counts()
        with (mock.patch.multiple(rnn_cuda, **patch) if patch
              else contextlib.nullcontext()):
            m, rows, matched, batch, _ = assignments(cpu_model, host,
                                                     tcfg.data, d)
            opt = loop.make_optimizer(m, tcfg)
            step = loop.make_train_step(m, opt, tcfg, augment=False)
            losses = step(batch, torch.Generator(d).manual_seed(seed))
            torch.cuda.synchronize()
        res_steps[name] = ({k: float(v) for k, v in losses.items()}, rows,
                           matched, counts())
    (l_k, r_k, m_k, c_k), (l_p, r_p, m_p, c_p), (l_c, r_c, m_c, c_c) = (
        res_steps["kernels"], res_steps["plain"], res_steps["cpu"])
    assert c_k == expected_counts(bilstm_fwd=layers, bilstm_fwd_train=layers,
                                  bilstm_bwd=layers), c_k
    assert rnn_cuda.bilstm_fwd_train_cuda.last_launch["kernel"] == "reg"
    assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "reg"
    assert c_p == c_c == expected_counts(), (c_p, c_c)
    assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p)
    assert torch.equal(r_k, r_c) and torch.equal(m_k, m_c)
    loss_rel = max(abs(l_k[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_p.items())
    cpu_rel = max(abs(l_k[k] - v) / max(abs(v), 1e-12)
                  for k, v in l_c.items())
    assert max(loss_rel, cpu_rel) <= LOSS_RTOL, (loss_rel, cpu_rel)
    out["lstm_step"] = c_k
    log("wide_lstm", f"flagship lstm d_model={WIDE_LSTM_D} (H=256) f32: "
        f"forward B={B} N={N} launches {out['lstm_forward']} "
        f"({plan_text(rnn_cuda.bilstm_fwd_cuda)}), vs the plain recurrence "
        f"max abs diff {fwd_err:.3e} (tol {MODEL_TOL:.0e}); one step B=8 "
        f"kernels vs plain versions on the card and vs the CPU: assignments "
        f"equal ({int(m_p.sum())} pairs), losses max rel {loss_rel:.2e} / "
        f"{cpu_rel:.2e} (tol {LOSS_RTOL:.0e}); launches {c_k} (bilstm_bwd "
        f"{plan_text(rnn_cuda.bilstm_bwd_cuda)}) on {smi}")

    # (b) and (d): the ops-level one-direction paths
    for fam, shape in (("lstm", WIDE_TIME), ("gru", WIDE_GRU)):
        Bs, Ns, Hs = shape
        if fam == "lstm":
            xg, _, w, _ = kernel_inputs(*shape, dev, seed)
            extra = ()
            fn = rnn_ops.lstm_recurrence
        else:
            xg, _, w, b, _, _ = gru_inputs(*shape, torch.float32, dev, seed)
            extra = (b,)
            fn = rnn_ops.gru_recurrence
        dy = torch.randn(Bs, Ns, Hs, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
        reset_counts()
        with torch.no_grad():
            ys = fn(xg, w, *extra, False, use_kernel=True)
        x = [t.clone().requires_grad_(True) for t in (xg, w, *extra)]
        yr = fn(*x, True, use_kernel=True)
        grads = torch.autograd.grad(yr, x, dy)
        torch.cuda.synchronize()
        launched = counts()
        assert launched == expected_counts(**{
            f"{fam}_fwd": 1, f"{fam}_fwd_train": 1, f"{fam}_bwd": 1}), \
            launched
        mod = rnn_cuda if fam == "lstm" else gru_cuda
        last = getattr(mod, f"{fam}_bwd_cuda").last_launch
        assert last["kernel"] == "reg", last
        err = value_err((ys,), (fn(xg, w, *extra),), torch.float32)
        ref_g = torch.autograd.grad(fn(*x, True), x, dy)
        rel = max(max_rel(a, r) for a, r in zip(grads, ref_g))
        assert rel <= GRAD_REL, rel
        out[f"{fam}_ops"] = launched
        log("wide_ops", f"{fam}_recurrence(use_kernel=True) B,N,H={shape}: "
            f"launches {launched}; values max_abs_err={err:.3e}; gradients "
            f"max_rel_err={rel:.3e}; BPTT {plan_text(getattr(mod, fam + '_bwd_cuda'))}")

    # (c): a bigru at a masked width, one forward and one train step
    Bg, Ng, Hg = WIDE_GRU
    gcfg = ExperimentConfig().apply_overrides(
        ["model.model_type=bigru", f"model.d_model={2 * Hg}",
         "model.dropout=0.0"])
    gcfg.train.batch_size, gcfg.data.max_trace_len = Bg, Ng
    gmodel = build_model(gcfg.model).to(dev)
    raw = np.stack([walk(Ng, seed + 700 + b) for b in range(Bg)])
    gfeats, gmask = featurize(torch.from_numpy(raw).to(dev),
                              torch.full((Bg,), Ng, device=dev))
    reset_counts()
    with torch.inference_mode():
        gout = gmodel.eval()(gfeats, gmask)
    with mock.patch.object(gru_mod, "bigru_recurrence",
                           gru_cuda.bigru_fwd_plain), torch.inference_mode():
        gref = gmodel(gfeats, gmask)
    gerr = max((gout[k] - gref[k]).abs().max().item() for k in gout)
    assert all(torch.allclose(gout[k], gref[k], rtol=MODEL_TOL,
                              atol=MODEL_TOL) for k in gout), gerr
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), Bg, seed + 800)
        ds = TraceColliderArrays(tmp, gcfg.data, augment=False,
                                 verbose=False)
        host = ds.gather(np.arange(Bg) % ds.num_samples)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    opt = loop.make_optimizer(gmodel, gcfg)
    losses = loop.make_train_step(gmodel, opt, gcfg, augment=False)(
        batch, torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    launched = counts()
    gl = gcfg.model.lstm_layers
    assert launched == expected_counts(bigru_fwd=gl, bigru_fwd_train=gl,
                                       bigru_bwd=gl), launched
    for name in ("bigru_fwd", "bigru_fwd_train", "bigru_bwd"):
        last = getattr(*WRAPPERS[name]).last_launch
        assert last["kernel"] == "reg", last
    assert all(np.isfinite(float(v)) for v in losses.values())
    out["bigru"] = launched
    log("wide_bigru", f"bigru d_model={2 * Hg} (H={Hg}) f32: forward "
        f"B={Bg} N={Ng} vs the plain recurrence max abs diff {gerr:.3e} "
        f"(tol {MODEL_TOL:.0e}); one train step, total_loss "
        f"{float(losses['total_loss']):.4f}; launches {launched} (bigru_bwd "
        f"{plan_text(gru_cuda.bigru_bwd_cuda)})")
    return out


# ---------------------------------------------------------------------------
# Phase 40: the bigru model's default path on the unit kernels (#5 / #5t /
# #6 with two directions at H=64, float32), and the stream kernels at every
# width above the cluster kernels'
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def old_bigru_route():
    """Two-direction BiGRU launches routed as before: the cluster kernel
    (the first design) where the unit kernels now take float32 at H <= 64;
    one-direction launches and other widths unchanged."""
    routes = {name: getattr(gru_cuda, name) for name in
              ("gru_fwd_kernel_route", "gru_bwd_kernel_route")}

    def old(route):
        def pick(hidden, dirs, dtype=torch.float32):
            got = route(hidden, dirs, dtype)
            return "cluster" if dirs == 2 and got == "unit" else got
        return pick

    with mock.patch.multiple(gru_cuda, **{k: old(v)
                                          for k, v in routes.items()}):
        yield


def bigru_default_config():
    """``python -m room_slam_torch.train --model bigru`` without a config:
    the default ExperimentConfig (d_model 128: H=64, float32 streams,
    B=20, max_trace_len 3000) with the bigru encoder."""
    return ExperimentConfig().apply_overrides(["model.model_type=bigru"])


def train_steps(cfg, train_dir, dev, seed, capturable=None):
    """The trainer on ``train_dir``'s rooms: ``batch(i)``, the i-th batch
    of its epoch plan, and ``take(batch)``, one step, its losses
    (``capturable``: ``loop.make_optimizer``'s, None its default)."""
    ds = TraceColliderArrays(train_dir, cfg.data, augment=True,
                             verbose=False)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in ds.device_arrays().items()}
    B = cfg.train.batch_size
    plan = ds.epoch_plan(B, seed=seed)
    nb = plan["base_idx"].shape[0]
    model = build_model(cfg.model, generator=torch.Generator()
                        .manual_seed(seed)).to(dev)
    opt = loop.make_optimizer(model, cfg, capturable=capturable)
    step = loop.make_train_step(model, opt, cfg, augment=True)
    gen = torch.Generator(dev).manual_seed(seed)
    return (lambda i: loop.gather_batch(data, plan, i % nb),
            lambda batch: step(batch, gen))


def step_p50(cfg, train_dir, dev, seed, n_steps, n_warmup, capturable=None):
    """p50 host ms of the trainer's step (ending in a synchronise) over
    ``n_steps`` after ``n_warmup``, and the launches of one step."""
    batch_of, take = train_steps(cfg, train_dir, dev, seed, capturable)
    ms = []
    for i in range(n_steps + n_warmup):
        batch = batch_of(i)
        reset_counts()
        t0 = time.perf_counter()
        losses = take(batch)
        torch.cuda.synchronize()
        if i >= n_warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(losses["total_loss"]))
    return float(np.percentile(ms, 50)), counts()


def device_busy_us(events, skip=()):
    """The union of the device intervals of a ``torch.profiler`` trace's
    events (kernels and copies; names in ``skip`` left out) in us, and
    those events."""
    on_dev = [e for e in events
              if e.device_type.name == "CUDA" and e.name not in skip]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in on_dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy, on_dev


# the CUDA API calls in which the host waits for the card
STEP_WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def step_trace(cfg, train_dir, dev, seed, n_steps, n_warmup, ranged):
    """One ``torch.profiler`` trace (CPU and CUDA activities) of the
    trainer's ``n_steps`` steps after ``n_warmup``, each ending in a
    synchronise, each function ``ranged`` names (``(module, attribute)``
    by label) run inside a ``record_function`` range of its label. Returns
    the host ms a step over the traced steps (the profiler's own cost
    included), the device's busy ms a step (the union of its kernels' and
    copies' intervals, the ranges' device spans left out) and idle share
    (1 - busy / host), the device ms a
    step of the kernels whose names hold "bilstm", the host ms a step in
    the CUDA API's launches and in its waits (``STEP_WAITS``), each label's
    host ms a call and calls a step, and the launches of the last step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    batch_of, take = train_steps(cfg, train_dir, dev, seed)
    for i in range(n_warmup):
        take(batch_of(i))
    torch.cuda.synchronize()

    def in_range(label, fn):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    with contextlib.ExitStack() as stack:
        for label, (mod, attr) in ranged.items():
            stack.enter_context(mock.patch.object(
                mod, attr, in_range(label, getattr(mod, attr))))
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        for i in range(n_warmup, n_warmup + n_steps):
            reset_counts()
            take(batch_of(i))
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    launched = counts()
    events = prof.events()
    # the ranges' own device spans (user annotations) are no device work
    busy, on_dev = device_busy_us(events, skip=ranged)
    busy_ms = busy / 1e3 / n_steps
    out = {"steps": n_steps, "host_ms": host_ms,
           "device_events": len(on_dev),
           "device_busy_ms": busy_ms if on_dev else None,
           "device_idle_share": 1 - busy_ms / host_ms if on_dev else None,
           "bilstm_kernels_device_ms": sum(
               e.time_range.elapsed_us() for e in on_dev
               if "bilstm" in e.name) / 1e3 / n_steps}
    on_host = [e for e in events if e.device_type.name == "CPU"]
    out["launch_api_ms"] = sum(
        e.time_range.elapsed_us() for e in on_host
        if e.name.startswith(("cudaLaunch", "cuLaunch"))) / 1e3 / n_steps
    out["wait_api_ms"] = sum(
        e.time_range.elapsed_us() for e in on_host
        if e.name in STEP_WAITS) / 1e3 / n_steps
    for label in ranged:
        host = [e.time_range.elapsed_us() for e in events
                if e.name == label and e.device_type.name == "CPU"]
        out[f"{label}_host_ms_a_call"] = (sum(host) / len(host) / 1e3
                                          if host else None)
        out[f"{label}_calls_a_step"] = len(host) / n_steps
    return out, launched


def request_p50(predict, trace_file, n, warmup):
    """p50 host ms of one served request (JSON load to collider dicts)
    over ``n`` after ``warmup``, and the launches of one request."""
    for _ in range(warmup):
        predict(formats.load_trace_json(trace_file))
    ms = []
    for _ in range(n):
        reset_counts()
        t0 = time.perf_counter()
        predict(formats.load_trace_json(trace_file))
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ms, 50)), counts()


BIGRU_WRAPPERS = (("bigru_fwd", gru_cuda.bigru_fwd_plain, "fwd"),
                  ("bigru_fwd_train", gru_cuda.bigru_fwd_train_plain,
                   "fwd_train"),
                  ("bigru_bwd", gru_cuda.bigru_bwd_plain, "bwd"))


def time_bigru_unit(dev, seed):
    """Phase 40 (a), the kernels: #5, #5t and #6 at ``BIGRU_TIME`` f32 on
    the unit kernels (the route, asserted), each beside the first cluster
    design forced at its planner's pick in the same call, the plain
    version, the bound and cuDNN's bidirectional ``nn.GRU``; then at
    ``BIGRU_BF16`` bf16 the unit kernels (the route there)
    against the tensor-core kernels forced at their planner's pick, in
    turns, beside the library: bidirectional ``nn.GRU`` in bf16 (cuDNN
    takes no bf16 RNN: PyTorch's own step loop) and through cuDNN in fp16,
    forward without grad, with grad on, and forward + backward minus
    forward (``yardstick_ms``). Returns the f32 rows by wrapper name (a
    list, ``BIGRU_TIME``'s order) and the bf16 comparison."""
    f32 = torch.float32
    rows = {}
    for B, N, H in BIGRU_TIME:
        lib_ms = _library_ms(torch.nn.GRU, B, N, H, f32, dev, seed)
        ins = gru_inputs(B, N, H, f32, dev, seed)
        args = gru_bwd_inputs(ins, seed + 1)
        for name, plain, kind in BIGRU_WRAPPERS:
            fn = getattr(*WRAPPERS[name])
            a = args if kind == "bwd" else ins
            src = "bwd" if kind == "bwd" else "fwd"
            old = gru_cuda.card_plans(src, B, H, dev, f32)[0]
            old_ms = cuda_ms(lambda: fn(*a, plan=old), 3, warmup=1)
            old_launch = dict(fn.last_launch)
            row = _time_row(name, fn, plain, a,
                            gru_bound(kind, B, N, H, f32), lib_ms[name],
                            f32, (B, N, H), old_cluster_ms=old_ms,
                            old_cluster_us_per_step=old_ms / N * 1e3,
                            old_cluster_launch=old_launch)
            assert row["launch"]["kernel"] == "unit", (name, row["launch"])
            if kind == "bwd":   # both directions in one launch, bit-equal
                assert all(torch.equal(x, y) for x, y in
                           zip(fn(*a), fn(*a))), name
            rows.setdefault(name, []).append(row)
            log("kernel_time", f"{name} (unit kernels, two directions) "
                + json.dumps(row) + "  (library_ms: cuDNN bidirectional "
                "nn.GRU f32, " + {"fwd": "forward without grad",
                                  "fwd_train": "forward with grad on",
                                  "bwd": "forward + backward minus forward"}[
                                      kind]
                + ", includes the input projection; old_cluster_ms: the "
                "first cluster design forced at its planner's pick)")
    B, N, H = BIGRU_BF16
    bf16 = torch.bfloat16
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, N, 2 * H, device=dev, generator=g)
    dy = torch.randn(B, N, 2 * H, device=dev, generator=g)
    m = torch.nn.GRU(2 * H, H, batch_first=True, bidirectional=True).to(dev)
    lib = {}
    for key, dt in (("bf16", bf16), ("cudnn_fp16", torch.float16)):
        m = m.to(dt)
        m.flatten_parameters()
        xi = x.to(dt).requires_grad_(True)
        dyi = dy.to(dt)

        def light():
            with torch.no_grad():
                return m(xi)

        lib[key] = yardstick_ms({
            "fwd": light, "fwd_train": lambda: m(xi),
            "fwd_bwd": lambda: m(xi)[0].backward(dyi)})
    ins = gru_inputs(B, N, H, bf16, dev, seed)
    args = gru_bwd_inputs(ins, seed + 1)
    cmp = {}
    for name, plain, kind in BIGRU_WRAPPERS:
        fn = getattr(*WRAPPERS[name])
        a = args if kind == "bwd" else ins
        src = "bwd" if kind == "bwd" else "fwd"
        tc = ("tc", *gru_cuda.card_tc_plans(kind, B, H, dev)[0])
        ref = plain(*a)
        got = fn(*a)
        unit = dict(fn.last_launch)
        assert unit["kernel"] == "unit", unit
        if kind == "bwd":
            assert max(max_rel(x.float(), y.float())
                       for x, y in zip(got, ref)) <= BF16_GRAD_REL, name
        else:
            value_err(got, ref, bf16)
        turns = [cuda_ms(lambda: fn(*a, plan=p), 5)
                 for p in (tc, None, None, tc)]
        cmp[name] = {"tc_ms": [turns[0], turns[3]],
                     "unit_ms": [turns[1], turns[2]],
                     "tc_plan": list(tc), "unit_launch": unit,
                     "tc_us_per_step": min(turns[0], turns[3]) / N * 1e3,
                     "unit_us_per_step": min(turns[1], turns[2]) / N * 1e3,
                     "library_ms": lib["bf16"][kind]["median"],
                     "library_spread_ms": lib["bf16"][kind]["spread"],
                     "cudnn_fp16_ms": lib["cudnn_fp16"][kind]["median"],
                     "cudnn_fp16_spread_ms":
                         lib["cudnn_fp16"][kind]["spread"]}
        log("kernel_time", f"{name} B,N,H={BIGRU_BF16} bf16, tc vs unit "
            f"in turns (tc, unit, unit, tc): " + json.dumps(cmp[name])
            + f"  (library_ms: nn.GRU bidirectional bf16, PyTorch's own "
            f"step loop; cudnn_fp16_ms: the same in fp16 through cuDNN; each"
            f" the median of {YARDSTICK_ROUNDS} rounds of 20 calls after 2 "
            "warm-up, spread = max - min; " + {
                "fwd": "forward without grad",
                "fwd_train": "forward with grad on",
                "bwd": "forward + backward minus forward"}[kind]
            + ", includes the input projection)")
    return rows, cmp


def bigru_default_path(dev, seed, smi):
    """Phase 40 (a): the ``bigru`` model at the CLI's defaults
    (``bigru_default_config``), the counts set to 0 just before each part
    and read just after: one train step card vs CPU (phase 10's rule:
    assignments, losses rel ``LOSS_RTOL``, updated parameters), one served
    request card vs CPU (colliders within ``MODEL_TOL``, labels equal),
    each launch of #5 / #5t / #6 on the unit kernels (asserted); then the
    step p50 (``BIGRU_STEPS`` after ``BIGRU_WARMUP``) and the request p50
    (``BIGRU_REQUESTS`` after ``BIGRU_WARMUP``) on the unit kernels and
    with the first cluster design forced (``old_bigru_route``), in turns
    new, old. Returns the launches of the step and of the request."""
    cfg = bigru_default_config()
    H = cfg.model.d_model // 2
    f32 = torch.float32
    assert gru_cuda.gru_fwd_kernel_route(H, 2, f32) == "unit"
    assert gru_cuda.gru_bwd_kernel_route(H, 2, f32) == "unit"
    layers = cfg.model.lstm_layers
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rooms = Path(tmp) / "rooms"
        write_rooms(rooms, BIGRU_ROOMS, seed + 900)
        reset_counts()
        step_parity(cfg, rooms, dev, seed, tag="bigru_step")
        torch.cuda.synchronize()
        # the card's step: its training forward and BPTT, and the light
        # forward of the match before it (and of the unmodified init)
        out["step"] = counts()
        assert out["step"]["bigru_fwd_train"] == layers, out["step"]
        assert out["step"]["bigru_bwd"] == layers, out["step"]
        for name in ("bigru_fwd", "bigru_fwd_train", "bigru_bwd"):
            last = getattr(*WRAPPERS[name]).last_launch
            assert last["kernel"] == "unit", (name, last)
        model = build_model(cfg.model)
        params = random_params(model, seed)
        sharpen(params)
        load_params(model, params)
        model = model.to(dev).eval()
        kw = dict(max_trace_len=cfg.data.max_trace_len,
                  confidence_threshold=0.0, nms_threshold=0.3,
                  verbose=False)
        predict = build_predictor(model, device=dev, **kw)
        cpu_predict = build_predictor(copy.deepcopy(model).cpu(),
                                      device="cpu", **kw)
        trace = Path(tmp) / "trace.json"
        formats.save_trace_json(trace, walk(cfg.data.max_trace_len,
                                            seed + 901))
        arr = formats.load_trace_json(trace)
        predict(arr)
        reset_counts()
        got = predict(arr)
        torch.cuda.synchronize()
        out["request"] = counts()
        assert out["request"] == expected_counts(bigru_fwd=layers), \
            out["request"]
        assert gru_cuda.bigru_fwd_cuda.last_launch["kernel"] == "unit"
        err, moved = matched_diff(got, cpu_predict(arr))
        assert err <= MODEL_TOL and len(got) > 0, err
        log("bigru_default", f"one request of {len(arr)} points card vs "
            f"CPU: {len(got)} colliders, labels equal, max abs diff "
            f"{err:.3e} (tol {MODEL_TOL:.0e}), {moved} at another rank; "
            f"launches {out['request']} "
            f"({plan_text(gru_cuda.bigru_fwd_cuda)})")
        timing = {}
        for name, ctx in (("unit", contextlib.nullcontext),
                          ("old_cluster", old_bigru_route)):
            with ctx():
                step_ms, step_launched = step_p50(cfg, rooms, dev, seed,
                                                  BIGRU_STEPS, BIGRU_WARMUP)
                kernel = gru_cuda.bigru_bwd_cuda.last_launch["kernel"]
                req_ms, req_launched = request_p50(predict, trace,
                                                   BIGRU_REQUESTS,
                                                   BIGRU_WARMUP)
            assert kernel == ("unit" if name == "unit" else "cluster")
            assert gru_cuda.bigru_fwd_cuda.last_launch["kernel"] == kernel
            timing[name] = {"step_p50_ms": step_ms,
                            "request_p50_ms": req_ms,
                            "step_launches": step_launched,
                            "request_launches": req_launched}
        log("bigru_default", f"bigru d_model {cfg.model.d_model} (H={H}) "
            f"f32, B={cfg.train.batch_size}, N={cfg.data.max_trace_len}: "
            f"step p50 over {BIGRU_STEPS} after {BIGRU_WARMUP} and request "
            f"p50 over {BIGRU_REQUESTS} after {BIGRU_WARMUP}, unit kernels "
            f"then the first cluster design forced: " + json.dumps(timing)
            + f" on {smi}")
    return out, timing


def _gru_stream_case(H, B, N, dtype, dev, seed, bwd_plan=None,
                     bwd_only=False, fwd_plan=None, fwd_only=False):
    """The six GRU wrappers at (B, N, H) in ``dtype`` (``bwd_only``: the two
    BPTT ones; ``fwd_only``: the four forwards) against their plain
    versions (bounds as phase 31), bit-equal run to run: the forwards on
    their route, the forward pipe kernel, or on the plan ``fwd_plan(kind,
    save, dirs)`` forces, the BPTTs on their route, the pipe kernel, or on
    the plan ``bwd_plan(dirs)`` forces. Returns the values' and the BPTT's
    worst errors and the plans."""
    ins = gru_inputs(B, N, H, dtype, dev, seed)
    args = gru_bwd_inputs(ins, seed + 1)
    ref_b = gru_cuda.bigru_bwd_plain(*args)
    tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
    plans, errs, rels = [], [0.0], [0.0]
    for name, fn, a, ref, kind, dirs, save in (
            ("bigru_fwd", gru_cuda.bigru_fwd_cuda, ins,
             gru_cuda.bigru_fwd_plain(*ins), "fwd", 2, False),
            ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda, ins,
             gru_cuda.bigru_fwd_train_plain(*ins), "fwd", 2, True),
            ("bigru_bwd", gru_cuda.bigru_bwd_cuda, args, ref_b, "bwd", 2,
             False),
            ("gru_fwd", gru_cuda.gru_fwd_cuda, (ins[1], ins[4], ins[5], True),
             (gru_cuda.gru_recurrence(ins[1], ins[4], ins[5], True),), "fwd",
             1, False),
            ("gru_fwd_train", gru_cuda.gru_fwd_train_cuda,
             (ins[0], ins[2], ins[3], False),
             gru_cuda.gru_fwd_train_plain(ins[0], ins[2], ins[3]), "fwd", 1,
             True),
            ("gru_bwd", gru_cuda.gru_bwd_cuda, (args[1], *args[6:], True),
             ref_b[2:], "bwd", 1, False)):
        if (bwd_only and kind != "bwd") or (fwd_only and kind == "bwd"):
            continue
        route = (gru_cuda.gru_fwd_kernel_route if kind == "fwd"
                 else gru_cuda.gru_bwd_kernel_route)(H, dirs, dtype)
        if kind == "bwd":
            forced = None if bwd_plan is None else bwd_plan(dirs)
        else:
            forced = None if fwd_plan is None else fwd_plan(kind, save, dirs)
        want = route if forced is None else forced[0]
        kw = {} if forced is None else {"plan": forced}
        got = fn(*a, **kw)
        got = got if isinstance(got, tuple) else (got,)
        assert fn.last_launch["kernel"] == want, (name, fn.last_launch)
        again = fn(*a, **kw)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), name
        if kind == "bwd":
            rels += [max_rel(x.float(), y.float()) for x, y in zip(got, ref)]
            assert all(torch.isfinite(x).all() for x in got)
        else:
            errs.append(value_err(got, ref, dtype))
        plans.append(f"{name} {plan_text(fn)}"
                     + ("" if forced is None else " (forced)"))
    assert max(rels) <= tol, (H, B, dtype, rels)
    torch.cuda.synchronize()
    return max(errs), max(rels), plans


def _fwd_pipe_or_route(fam, B, H, dev, dtype, i=None):
    """``plan_of(kind, save, dirs)`` for the forwards of family ``fam``:
    the route where it is the pipe kernel (``i`` None) or where no forward
    pipe plan takes H (above 1920: the first stream design's), else the
    card's ``i``-th forward pipe plan (the first by default), forced; None
    for the BPTT (its route)."""
    def plan_of(kind, save, dirs):
        if kind == "bwd" or not rnn_cuda.fwd_pipe_takes(H):
            return None
        route = (rnn_cuda.lstm_fwd_kernel_route(H) if fam == "lstm" else
                 gru_cuda.gru_fwd_kernel_route(H, dirs, dtype))
        if route == "pipe" and i is None:
            return None
        found = (rnn_cuda.card_lstm_fwd_pipe_plans if fam == "lstm" else
                 gru_cuda.card_gru_fwd_pipe_plans)(B, H, dev, dtype, save,
                                                   dirs)
        return ("pipe", *found[min(i or 0, len(found) - 1)])
    return plan_of


def check_stream_route(dev, seed):
    """Phase 40 (b): the pipe kernels at ``STREAM_WIDTHS`` x
    ``STREAM_BATCHES``, N=``STREAM_N``, float32 and bf16, two directions
    and one: the LSTM's six wrappers on their route (asserted "pipe",
    ``_lstm_cluster_case``), the GRU's six (``_gru_stream_case``; at the
    cluster kernel's widths the forwards' pipe plan forced where the route
    is not the pipe kernel), against the plain versions, bit-equal run to
    run; the LSTM's six so at ``PIPE_WIDTHS`` x ``PIPE_BATCHES`` (the pipe
    kernels' wider instances: the route, or its card's first plan forced
    where the route stops; the forwards above 1920, where no forward pipe
    plan fits, on their route, the first stream design), the GRU's six at
    those its BPTT's pipe kernel takes (to 1024) and its four forwards,
    forced, at the others the forward pipe kernel takes; the
    forwards under the card's first ``FWD_PIPE_PLANS`` forward pipe plans
    and the GRU BPTT under its first ``GRU_PIPE_PLANS`` pipe plans at
    ``STREAM_OLD``; then the first stream designs, all twelve wrappers
    forced at their card's first plan, at ``STREAM_OLD``'s B and H in both
    types."""
    worst = {}

    def note(key, err, rel):
        w = worst.setdefault(key, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], rel)

    for H in STREAM_WIDTHS:
        for B in STREAM_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                key = str(dtype)[6:]
                for fam, case in (
                        ("lstm", lambda: _lstm_cluster_case(
                            H, B, dtype, dev, seed, "pipe", n=STREAM_N,
                            fwd_again=True)),
                        ("gru", lambda: _gru_stream_case(
                            H, B, STREAM_N, dtype, dev, seed,
                            fwd_plan=_fwd_pipe_or_route("gru", B, H, dev,
                                                        dtype)))):
                    err, rel, plans = case()
                    note(f"{fam}_{key}", err, rel)
                    log("stream_check", f"{fam} B,N,H=({B}, {STREAM_N}, {H}"
                        f") {key}: values max_abs_err={err:.3e}, BPTT "
                        f"max_rel_err={rel:.3e}, bit-equal run to run; "
                        + "; ".join(plans))
    for H in PIPE_WIDTHS:
        try:
            routed = rnn_cuda.lstm_bwd_kernel_route(H) == "pipe"
        except ValueError:
            routed = False
        for B in PIPE_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                fwd = _fwd_pipe_or_route("lstm", B, H, dev, dtype)

                def pick(kind, save, dirs):
                    # the route, or past it the card's first pipe plan
                    if kind == "fwd":
                        return fwd(kind, save, dirs)
                    return (None if routed else
                            ("pipe", *rnn_cuda.card_lstm_pipe_plans(
                                B, H, dev, dtype, dirs)[0]))
                err, rel, plans = _lstm_cluster_case(
                    H, B, dtype, dev, seed,
                    "pipe" if rnn_cuda.fwd_pipe_takes(H) else "stream", pick,
                    n=STREAM_N, bwd_kernel="pipe", fwd_again=True)
                note(f"lstm_pipe_{str(dtype)[6:]}", err, rel)
                log("stream_check", f"pipe kernels: lstm B,N,H=("
                    f"{B}, {STREAM_N}, {H}) {str(dtype)[6:]}: values "
                    f"max_abs_err={err:.3e}, BPTT max_rel_err={rel:.3e}, "
                    "bit-equal run to run; " + "; ".join(plans))
                bwd = gru_cuda.gru_bwd_kernel_route(H, 2, dtype) == "pipe"
                if not (bwd or rnn_cuda.fwd_pipe_takes(H)):
                    continue
                err, rel, plans = _gru_stream_case(
                    H, B, STREAM_N, dtype, dev, seed,
                    fwd_plan=_fwd_pipe_or_route("gru", B, H, dev, dtype),
                    fwd_only=not bwd)
                note(f"gru_pipe_{str(dtype)[6:]}", err, rel)
                log("stream_check", f"GRU pipe kernels: gru "
                    f"B,N,H=({B}, {STREAM_N}, {H}) {str(dtype)[6:]}"
                    f"{'' if bwd else ' (forwards only)'}: values "
                    f"max_abs_err={err:.3e}, BPTT max_rel_err={rel:.3e}, "
                    "bit-equal run to run; " + "; ".join(plans))
    B, H = STREAM_OLD
    for dtype in (torch.float32, torch.bfloat16):
        for i in range(FWD_PIPE_PLANS):
            err, _, plans = _lstm_cluster_case(
                H, B, dtype, dev, seed, "pipe",
                _fwd_pipe_or_route("lstm", B, H, dev, dtype, i), n=STREAM_N,
                fwd_again=True, bwd=False)
            err_g, _, plans_g = _gru_stream_case(
                H, B, STREAM_N, dtype, dev, seed,
                fwd_plan=_fwd_pipe_or_route("gru", B, H, dev, dtype, i),
                fwd_only=True)
            log("stream_check", f"forward pipe plan {i + 1} of the card's, "
                f"forced: B,N,H=({B}, {STREAM_N}, {H}) {str(dtype)[6:]}: "
                f"lstm values max_abs_err={err:.3e}, gru {err_g:.3e}, "
                "bit-equal run to run; " + "; ".join(plans + plans_g))
        for i in range(GRU_PIPE_PLANS):
            def nth(dirs, i=i):
                found = gru_cuda.card_gru_pipe_plans(B, H, dev, dtype, dirs)
                return ("pipe", *found[min(i, len(found) - 1)])
            err, rel, plans = _gru_stream_case(H, B, STREAM_N, dtype, dev,
                                               seed, nth, bwd_only=True)
            log("stream_check", f"GRU pipe plan {i + 1} of the card's, "
                f"forced: gru B,N,H=({B}, {STREAM_N}, {H}) "
                f"{str(dtype)[6:]}: BPTT max_rel_err={rel:.3e}, bit-equal "
                "run to run; " + "; ".join(plans))

        def first(kind, save, dirs):
            return ("stream", *rnn_cuda.card_lstm_stream_plans(
                kind, B, H, dev, dtype, save, dirs)[0])
        err, rel, plans = _lstm_cluster_case(H, B, dtype, dev, seed,
                                             "stream", first, n=STREAM_N,
                                             fwd_again=True)
        log("stream_check", f"first stream designs, forced: lstm B,N,H=({B}"
            f", {STREAM_N}, {H}) {str(dtype)[6:]}: values max_abs_err="
            f"{err:.3e}, BPTT max_rel_err={rel:.3e}, bit-equal run to run; "
            + "; ".join(plans))
        err, rel, plans = _gru_stream_case(
            H, B, STREAM_N, dtype, dev, seed,
            lambda dirs: ("stream", *gru_cuda.card_stream_plans(
                "bwd", B, H, dev, dtype, False, dirs)[0]),
            fwd_plan=lambda kind, save, dirs: (
                "stream", *gru_cuda.card_stream_plans(
                    "fwd", B, H, dev, dtype, save, dirs)[0]))
        log("stream_check", f"first stream designs, forced: gru B,N,H=({B}, "
            f"{STREAM_N}, {H}) {str(dtype)[6:]}: values max_abs_err="
            f"{err:.3e}, BPTT max_rel_err={rel:.3e}, bit-equal run to run; "
            + "; ".join(plans))
    return worst


def klinear_plan(name, B, H, dev, dirs):
    """The card's first plan of the GRU's first cluster design (kLinear's
    for the BPTT) as wrapper ``name`` takes it forced: ``(C, R)`` for the
    two-direction wrappers, ``("cluster", C, R)`` for the one-direction
    ones; None where no cluster plan takes H."""
    kind = "bwd" if name.endswith("bwd") else "fwd"
    if not gru_cuda.cluster_takes(kind, H):
        return None
    plan = tuple(gru_cuda.card_plans(kind, B, H, dev, torch.float32,
                                     dirs)[0])
    return plan if name.startswith("bi") else ("cluster", *plan)


def _pipe_ab(fn, a, fam, kind, B, N, H, save, dirs, dev):
    """The wrapper ``fn`` of family ``fam`` ("lstm" or "gru") and ``kind``
    ("fwd" or "bwd") on its route, the pipe kernel, beside the first stream
    design forced at its card's first plan and, for the GRU where a cluster
    plan takes H, its first cluster design (kLinear's for the BPTT) at its
    card's pick, in turns (pipe, stream[, cluster, cluster], stream, pipe;
    the pipe kernel asserted faster than each), and the card's first
    ``PIPE_SWEEP`` pipe plans (the planner's pick first, and whether it is
    the fastest) in f32: a row's extra keys."""
    f32 = torch.float32
    if fam == "lstm":
        first = ("stream", *rnn_cuda.card_lstm_stream_plans(
            kind, B, H, dev, f32, save, dirs)[0])
        pipes = (rnn_cuda.card_lstm_pipe_plans(B, H, dev, f32, dirs)
                 if kind == "bwd" else rnn_cuda.card_lstm_fwd_pipe_plans(
                     B, H, dev, f32, save, dirs))
        klinear = None
    else:
        first = ("stream", *gru_cuda.card_stream_plans(
            kind, B, H, dev, f32, save, dirs)[0])
        pipes = (gru_cuda.card_gru_pipe_plans(B, H, dev, f32, dirs)
                 if kind == "bwd" else gru_cuda.card_gru_fwd_pipe_plans(
                     B, H, dev, f32, save, dirs))
        klinear = klinear_plan(fn.__name__[:-len("_cuda")], B, H, dev, dirs)
    order = [None, first, *([klinear] * 2 if klinear else []), first, None]
    turns = [cuda_ms(lambda: fn(*a, plan=p), 3, warmup=1) for p in order]
    fn(*a, plan=first)
    old_launch = dict(fn.last_launch)
    pipe_ms = [turns[0], turns[-1]]
    stream_ms = [turns[1], turns[-2]]
    assert max(pipe_ms) < min(stream_ms), (fn.__name__, H, turns)
    extra = {}
    if klinear:
        # kLinear's cluster kernel (the BPTT), the first cluster design
        # (the forward)
        key = "klinear" if kind == "bwd" else "cluster"
        kl_ms = turns[2:4]
        assert max(pipe_ms) < min(kl_ms), (fn.__name__, H, turns)
        fn(*a, plan=klinear)
        extra = {f"{key}_turns_ms": kl_ms, f"{key}_ms": min(kl_ms),
                 f"{key}_us_per_step": min(kl_ms) / N * 1e3,
                 f"{key}_launch": dict(fn.last_launch)}
    sweep = [{"plan": list(p), "ms": cuda_ms(
        lambda: fn(*a, plan=("pipe", *p)), 3, warmup=1)}
        for p in pipes[:PIPE_SWEEP]]
    return {"pipe_turns_ms": pipe_ms, "stream_turns_ms": stream_ms,
            "stream_ms": min(stream_ms),
            "stream_us_per_step": min(stream_ms) / N * 1e3,
            "stream_launch": old_launch, **extra, "pipe_plans_ms": sweep,
            "pick_fastest": sweep[0]["ms"] == min(r["ms"] for r in sweep)}


def _library_turns(rows, second):
    """Give ``rows`` (one shape's, a wrapper's name each) cuDNN's second
    reading ``second`` (``_library_ms``'s, taken after the kernels): both
    readings in ``library_turns_ms``, the lower one as the row's library
    time."""
    for name, row in rows:
        N = row["shape"][1]
        pair = [row["library_ms"], second[name]]
        row.update(library_turns_ms=pair, library_ms=min(pair),
                   library_us_per_step=min(pair) / N * 1e3)


def _log_time_row(name, fam, row):
    route = row["route"]
    turns = "library_turns_ms" in row
    log("kernel_time", f"{name} ("
        + ("pipe kernel, the route; stream_ms: the first stream design "
           "forced, in turns; "
           + ("klinear_ms: kLinear's cluster kernel forced at its pick, "
              "in turns; " if "klinear_ms" in row else "")
           + ("cluster_ms: the first cluster design forced at its pick, "
              "in turns; " if "cluster_ms" in row else "")
           + "pipe_plans_ms: the card's first pipe plans, pick_fastest: "
           "the planner's pick the fastest of them"
           if route == "pipe" else "stream kernel"
           + ("" if route == "stream" else f", forced; route {route}"))
        + ") " + json.dumps(row) + "  (library_ms: "
        + ("the lower of " if turns else "") + "cuDNN "
        + ("bidirectional " if name.startswith("bi") else
           "unidirectional ") + f"nn.{fam.upper()} f32"
        + ("'s two readings, before and after the kernels, " if turns
           else ", ")
        + {"fwd": "forward without grad", "fwd_train":
           "forward with grad on", "bwd": "forward + backward "
           "minus forward"}[name.split("_", 1)[1]]
        + ", includes the input projection)")


def _gru_cases(B, N, H, dev, seed):
    """The six GRU wrappers at (B, N, H) in float32, as ``_lstm_cases``:
    name, wrapper, plain version, arguments, bound, kind, kSave and
    directions."""
    f32 = torch.float32
    ins = gru_inputs(B, N, H, f32, dev, seed)
    args = gru_bwd_inputs(ins, seed + 1)
    cases = []
    for name, fn, plain, a, kind, dirs, save in (
            ("bigru_fwd", gru_cuda.bigru_fwd_cuda,
             gru_cuda.bigru_fwd_plain, ins, "fwd", 2, False),
            ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda,
             gru_cuda.bigru_fwd_train_plain, ins, "fwd_train", 2, True),
            ("bigru_bwd", gru_cuda.bigru_bwd_cuda,
             gru_cuda.bigru_bwd_plain, args, "bwd", 2, False),
            ("gru_fwd", gru_cuda.gru_fwd_cuda, gru_cuda.gru_recurrence,
             (ins[0], ins[2], ins[3]), "fwd", 1, False),
            ("gru_fwd_train", gru_cuda.gru_fwd_train_cuda,
             gru_cuda.gru_fwd_train_plain, (ins[0], ins[2], ins[3]),
             "fwd_train", 1, True),
            ("gru_bwd", gru_cuda.gru_bwd_cuda, gru_cuda.gru_bwd_plain,
             (args[0], *args[2:6]), "bwd", 1, False)):
        cases.append((name, fn, plain, a,
                      gru_bound(kind, B, N, H, f32, dirs=dirs),
                      "bwd" if kind == "bwd" else "fwd", save, dirs))
    return cases


def _route_of(fam, kind, H, dirs):
    """The route of a float32 launch of family ``fam``'s ``kind``."""
    if fam == "lstm":
        return (rnn_cuda.lstm_fwd_kernel_route if kind == "fwd"
                else rnn_cuda.lstm_bwd_kernel_route)(H)
    return (gru_cuda.gru_fwd_kernel_route if kind == "fwd"
            else gru_cuda.gru_bwd_kernel_route)(H, dirs, torch.float32)


def time_stream_route(dev, seed):
    """Phase 40 (b), the timing: the twelve wrappers at ``STREAM_TIME`` f32
    on their route, the pipe kernels, beside the first stream design (and
    at H=320 the GRU's first cluster design, kLinear's for the BPTT) and the
    pipe plans (``_pipe_ab``): kernel ms (CUDA events), plain ms, the
    bound, cuDNN's ``nn.LSTM`` / ``nn.GRU`` (bidirectional for the
    two-direction kernels; never called by the port; input projection
    included; read before and after the shape's kernels,
    ``_library_turns``) and µs a step. Then all twelve so at ``PIPE_TIME``
    (the GRU's where its pipe kernels take H; cuDNN read once; their rows
    under the wrapper's name and ``"_wide"``). Returns the rows by wrapper
    name, a list in ``STREAM_TIME``'s order."""
    f32 = torch.float32
    rows = {}
    for B, N, H in STREAM_TIME:
        lib = {"lstm": _library_ms(torch.nn.LSTM, B, N, H, f32, dev, seed),
               "gru": _library_ms(torch.nn.GRU, B, N, H, f32, dev, seed)}
        cases = [(*case, "lstm") for case in _lstm_cases(B, N, H, f32, dev,
                                                          seed)]
        cases += [(*case, "gru") for case in _gru_cases(B, N, H, dev, seed)]
        shape_rows = []
        for name, fn, plain, a, bnd, kind, save, dirs, fam in cases:
            route = _route_of(fam, kind, H, dirs)
            assert route == "pipe", (name, H, route)
            row = _time_row(name, fn, plain, a, bnd, lib[fam][name], f32,
                            (B, N, H), route=route,
                            **_pipe_ab(fn, a, fam, kind, B, N, H, save, dirs,
                                       dev))
            assert row["launch"]["kernel"] == "pipe", (name, row)
            rows.setdefault(name, []).append(row)
            shape_rows.append((name, fam, row))
        second = {**_library_ms(torch.nn.LSTM, B, N, H, f32, dev, seed),
                  **_library_ms(torch.nn.GRU, B, N, H, f32, dev, seed)}
        _library_turns([(name, row) for name, _, row in shape_rows], second)
        for name, fam, row in shape_rows:
            _log_time_row(name, fam, row)
    for B, N, H in PIPE_TIME:
        for fam, mod, cases in (
                ("lstm", torch.nn.LSTM, _lstm_cases(B, N, H, f32, dev, seed)),
                ("gru", torch.nn.GRU, _gru_cases(B, N, H, dev, seed)
                 if gru_cuda.gru_bwd_kernel_route(H, 2) == "pipe" else ())):
            lib = _library_ms(mod, B, N, H, f32, dev, seed) if cases else {}
            for name, fn, plain, a, bnd, kind, save, dirs in cases:
                route = _route_of(fam, kind, H, dirs)
                assert route == "pipe", (name, H, route)
                row = _time_row(name, fn, plain, a, bnd, lib[name], f32,
                                (B, N, H), route=route,
                                **_pipe_ab(fn, a, fam, kind, B, N, H, save,
                                           dirs, dev))
                assert row["launch"]["kernel"] == "pipe", (name, row)
                rows.setdefault(f"{name}_wide", []).append(row)
                _log_time_row(name, fam, row)
    return rows


@contextlib.contextmanager
def first_stream_fwd():
    """The LSTM and GRU forwards routed as before their pipe kernels: the
    first stream design wherever a route says "pipe"; every other route
    (the BPTTs' too) unchanged."""
    lstm = rnn_cuda.lstm_fwd_kernel_route
    gru = gru_cuda.gru_fwd_kernel_route

    def old_lstm(hidden):
        got = lstm(hidden)
        return "stream" if got == "pipe" else got

    def old_gru(hidden, dirs, dtype=torch.float32):
        got = gru(hidden, dirs, dtype)
        return "stream" if got == "pipe" else got

    with mock.patch.object(rnn_cuda, "lstm_fwd_kernel_route", old_lstm), \
            mock.patch.object(gru_cuda, "gru_fwd_kernel_route", old_gru):
        yield


def _fwd_turns(run, kernel_of):
    """``run()`` in turns with the forwards on their pipe route and on the
    first stream design (``first_stream_fwd``): pipe, stream, stream,
    pipe. ``run`` returns (ms, launches); ``kernel_of()`` the kernel of the
    last forward launch, asserted. Returns the ms by kernel and the last
    launches."""
    turns = {"pipe": [], "stream": []}
    for kernel in ("pipe", "stream", "stream", "pipe"):
        ctx = (first_stream_fwd if kernel == "stream"
               else contextlib.nullcontext)
        with ctx():
            ms, launched = run()
        assert kernel_of() == kernel, (kernel, kernel_of())
        turns[kernel].append(ms)
    return turns, launched


def served_p50(model, feats, mask, n, warmup):
    """p50 device ms (CUDA events) of one served forward of ``model``
    (inference mode, the light kernels) over ``n`` after ``warmup``, and
    the launches of one forward."""
    ms = []
    with torch.inference_mode():
        for i in range(n + warmup):
            reset_counts()
            _, t = timed_once(lambda: model(feats, mask))
            if i >= warmup:
                ms.append(t)
    return float(np.percentile(ms, 50)), counts()


def stream_paths(dev, seed, smi):
    """Phase 40 (c), the pipe kernels' main paths, the counts set to 0
    just before each and read just after: the flagship ``lstm`` at
    d_model ``STREAM_LSTM_D`` (H=512, f32), a forward at ``STREAM_STEP``'s
    B and N through the pipe kernels against the plain recurrence, then
    one train step card vs CPU (``step_parity``: assignments, losses rel
    ``LOSS_RTOL``, updated parameters) at B, N = ``STREAM_STEP`` (cut from
    the config's 20 and 1500 for the CPU's step); a ``bigru`` at d_model
    ``STREAM_LSTM_D`` (H=512, f32), one forward against the plain
    recurrence and one train step; ``lstm_recurrence`` /
    ``gru_recurrence(use_kernel=True)`` at (B, N, 512) forward and
    backward; the lstm's and the bigru's train-step p50 at
    ``STREAM_STEP_TIME`` (bench.py's B and N) over ``STREAM_STEPS`` after
    ``STREAM_WARMUP`` and their served forward's p50 at ``STREAM_SERVE``
    (B=1, the light kernels) over ``STREAM_SERVE_CALLS``, the forwards on
    the pipe kernel (the route) and on the first stream design
    (``first_stream_fwd``) in turns, the BPTT on its pipe route in both.
    Each launch is asserted on the pipe kernels but the forwards' stream
    turns. Returns each path's launches and the timings."""
    out = {}
    B, N = STREAM_STEP
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.model.d_model = STREAM_LSTM_D
    cfg.model.dropout = 0.0
    cfg.train.batch_size, cfg.data.max_trace_len = B, N
    cfg.train.matmul_precision = "float32"    # the kernels are the change
    H = STREAM_LSTM_D // 2
    layers = cfg.model.lstm_layers
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    raw = np.stack([walk(N, seed + 950 + b) for b in range(B)])
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.full((B,), N, device=dev))
    with torch.inference_mode():
        reset_counts()
        res = model(feats, mask)
        torch.cuda.synchronize()
        out["lstm_forward"] = counts()
        assert out["lstm_forward"] == expected_counts(bilstm_fwd=layers)
        assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "pipe"
        with mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain):
            ref = model(feats, mask)
    fwd_err = max((res[k] - ref[k]).abs().max().item() for k in res)
    assert all(torch.allclose(res[k], ref[k], rtol=MODEL_TOL, atol=MODEL_TOL)
               for k in res), fwd_err
    # one step card vs CPU, phase 10's rule (the card's assignment optimal
    # under the CPU's costs, both steps on the CPU's): at d_model 1024 the
    # random queries tie more often than at 512
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), B, seed + 960)
        reset_counts()
        step_parity(cfg, Path(tmp), dev, seed, tag="stream_lstm_step")
        torch.cuda.synchronize()
        c_k = counts()
    # the card's step, and its match's light forward (and the unmodified
    # init's): the CPU's launch nothing
    assert c_k == expected_counts(bilstm_fwd=c_k["bilstm_fwd"],
                                  bilstm_fwd_train=layers,
                                  bilstm_bwd=layers), c_k
    for name in ("bilstm_fwd", "bilstm_fwd_train", "bilstm_bwd"):
        assert getattr(*WRAPPERS[name]).last_launch["kernel"] == "pipe"
    out["lstm_step"] = c_k
    log("stream_lstm", f"flagship lstm d_model={STREAM_LSTM_D} (H={H}) f32:"
        f" forward B={B} N={N} launches {out['lstm_forward']} "
        f"({plan_text(rnn_cuda.bilstm_fwd_cuda)}), vs the plain recurrence "
        f"max abs diff {fwd_err:.3e} (tol {MODEL_TOL:.0e}); one step card "
        f"vs CPU at B={B}, N={N} (cut from the config's 20, 1500) as "
        f"above; launches {c_k} (bilstm_fwd_train "
        f"{plan_text(rnn_cuda.bilstm_fwd_train_cuda)}; bilstm_bwd "
        f"{plan_text(rnn_cuda.bilstm_bwd_cuda)}) on {smi}")

    # the lstm's train step at bench.py's B and N (the config's precision)
    # and its served forward, the forwards on the pipe kernel and on the
    # first stream design, in turns
    tcfg = ExperimentConfig.from_json(CONFIG)
    tcfg.model.d_model = STREAM_LSTM_D
    tcfg.train.batch_size, tcfg.data.max_trace_len = STREAM_STEP_TIME
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), STREAM_ROOMS, seed + 980)
        turns, step_launched = _fwd_turns(
            lambda: step_p50(tcfg, Path(tmp), dev, seed, STREAM_STEPS,
                             STREAM_WARMUP),
            lambda: rnn_cuda.bilstm_fwd_train_cuda.last_launch["kernel"])
    assert step_launched == expected_counts(
        bilstm_fwd_train=layers, bilstm_bwd=layers), step_launched
    assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "pipe"
    sB, sN = STREAM_SERVE
    sraw = walk(sN, seed + 985)[None]
    sfeats, smask = featurize(torch.from_numpy(sraw).to(dev),
                              torch.full((sB,), sN, device=dev))
    serve_turns, serve_launched = _fwd_turns(
        lambda: served_p50(model, sfeats, smask, STREAM_SERVE_CALLS,
                           STREAM_WARMUP),
        lambda: rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"])
    assert serve_launched == expected_counts(bilstm_fwd=layers), \
        serve_launched
    out["lstm_step_p50"] = {
        "shape": [*STREAM_STEP_TIME, H], "pipe_step_p50_ms": turns["pipe"],
        "stream_step_p50_ms": turns["stream"],
        "step_launches": step_launched,
        "matmul_precision": tcfg.train.matmul_precision,
        "fwd_train_plan": dict(rnn_cuda.bilstm_fwd_train_cuda.last_launch),
        "bwd_plan": dict(rnn_cuda.bilstm_bwd_cuda.last_launch),
        "serve_shape": [sB, sN, H],
        "pipe_serve_p50_ms": serve_turns["pipe"],
        "stream_serve_p50_ms": serve_turns["stream"],
        "serve_launches": serve_launched}
    log("stream_lstm", f"flagship lstm d_model={STREAM_LSTM_D} (H={H}) "
        f"train step at B, N = {STREAM_STEP_TIME} (bench.py's), p50 over "
        f"{STREAM_STEPS} after {STREAM_WARMUP}, and served forward at B, N "
        f"= {STREAM_SERVE} (light kernels, CUDA events), p50 over "
        f"{STREAM_SERVE_CALLS} after {STREAM_WARMUP}, in turns pipe, stream,"
        f" stream, pipe (the forwards' kernel; the BPTT on its pipe route; "
        f"the config's matmul precision {tcfg.train.matmul_precision}): "
        + json.dumps(out["lstm_step_p50"]) + f" on {smi}")

    # the ops-level one-direction paths
    for fam in ("lstm", "gru"):
        if fam == "lstm":
            xg, _, w, _ = kernel_inputs(B, N, H, dev, seed)
            extra, fn = (), rnn_ops.lstm_recurrence
        else:
            xg, _, w, b, _, _ = gru_inputs(B, N, H, torch.float32, dev, seed)
            extra, fn = (b,), rnn_ops.gru_recurrence
        dy = torch.randn(B, N, H, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
        reset_counts()
        with torch.no_grad():
            ys = fn(xg, w, *extra, False, use_kernel=True)
        x = [t.clone().requires_grad_(True) for t in (xg, w, *extra)]
        grads = torch.autograd.grad(fn(*x, True, use_kernel=True), x, dy)
        torch.cuda.synchronize()
        launched = counts()
        assert launched == expected_counts(**{
            f"{fam}_fwd": 1, f"{fam}_fwd_train": 1, f"{fam}_bwd": 1}), \
            launched
        mod = rnn_cuda if fam == "lstm" else gru_cuda
        for kind in ("fwd", "fwd_train", "bwd"):
            last = getattr(mod, f"{fam}_{kind}_cuda").last_launch
            assert last["kernel"] == "pipe", (fam, kind, last)
        err = value_err((ys,), (fn(xg, w, *extra),), torch.float32)
        ref_g = torch.autograd.grad(fn(*x, True), x, dy)
        rel = max(max_rel(a, r) for a, r in zip(grads, ref_g))
        assert rel <= GRAD_REL, rel
        out[f"{fam}_ops"] = launched
        log("stream_ops", f"{fam}_recurrence(use_kernel=True) B,N,H=({B}, "
            f"{N}, {H}): launches {launched}; values max_abs_err={err:.3e}; "
            f"gradients max_rel_err={rel:.3e}; forward "
            f"{plan_text(getattr(mod, fam + '_fwd_cuda'))}; BPTT "
            f"{plan_text(getattr(mod, fam + '_bwd_cuda'))}")

    # a bigru at H=512: one forward and one train step
    gcfg = ExperimentConfig().apply_overrides(
        ["model.model_type=bigru", f"model.d_model={STREAM_LSTM_D}",
         "model.dropout=0.0"])
    gcfg.train.batch_size, gcfg.data.max_trace_len = B, N
    gmodel = build_model(gcfg.model).to(dev)
    reset_counts()
    with torch.inference_mode():
        gout = gmodel.eval()(feats, mask)
    with mock.patch.object(gru_mod, "bigru_recurrence",
                           gru_cuda.bigru_fwd_plain), torch.inference_mode():
        gref = gmodel(feats, mask)
    gerr = max((gout[k] - gref[k]).abs().max().item() for k in gout)
    assert all(torch.allclose(gout[k], gref[k], rtol=MODEL_TOL,
                              atol=MODEL_TOL) for k in gout), gerr
    fwd_launched = counts()
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), B, seed + 970)
        ds = TraceColliderArrays(tmp, gcfg.data, augment=False,
                                 verbose=False)
        ghost = ds.gather(np.arange(B) % ds.num_samples)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in ghost.items()}
    reset_counts()
    opt = loop.make_optimizer(gmodel, gcfg)
    losses = loop.make_train_step(gmodel, opt, gcfg, augment=False)(
        batch, torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    step_launched = counts()
    gl = gcfg.model.lstm_layers
    assert fwd_launched == expected_counts(bigru_fwd=gl), fwd_launched
    assert step_launched == expected_counts(bigru_fwd_train=gl,
                                            bigru_bwd=gl), step_launched
    for name in ("bigru_fwd", "bigru_fwd_train", "bigru_bwd"):
        last = getattr(*WRAPPERS[name]).last_launch
        assert last["kernel"] == "pipe", (name, last)
    assert all(np.isfinite(float(v)) for v in losses.values())
    launched = {k: fwd_launched[k] + step_launched[k] for k in WRAPPERS}
    out["bigru"] = launched
    log("stream_bigru", f"bigru d_model={STREAM_LSTM_D} (H={H}) f32: "
        f"forward B={B} N={N} vs the plain recurrence max abs diff "
        f"{gerr:.3e} (tol {MODEL_TOL:.0e}); one train step, total_loss "
        f"{float(losses['total_loss']):.4f}; launches {launched} "
        f"(bigru_fwd_train {plan_text(gru_cuda.bigru_fwd_train_cuda)}; "
        f"bigru_bwd {plan_text(gru_cuda.bigru_bwd_cuda)})")

    # the bigru's train step at bench.py's B and N (the default config's
    # precision) and its served forward, the forwards on the pipe kernel
    # and on the first stream design, in turns
    bcfg = ExperimentConfig().apply_overrides(
        ["model.model_type=bigru", f"model.d_model={STREAM_LSTM_D}"])
    bcfg.train.batch_size, bcfg.data.max_trace_len = STREAM_STEP_TIME
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), STREAM_ROOMS, seed + 990)
        turns, step_launched = _fwd_turns(
            lambda: step_p50(bcfg, Path(tmp), dev, seed, STREAM_STEPS,
                             STREAM_WARMUP),
            lambda: gru_cuda.bigru_fwd_train_cuda.last_launch["kernel"])
    assert step_launched == expected_counts(
        bigru_fwd_train=gl, bigru_bwd=gl), step_launched
    assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == "pipe"
    serve_turns, serve_launched = _fwd_turns(
        lambda: served_p50(gmodel.eval(), sfeats, smask, STREAM_SERVE_CALLS,
                           STREAM_WARMUP),
        lambda: gru_cuda.bigru_fwd_cuda.last_launch["kernel"])
    assert serve_launched == expected_counts(bigru_fwd=gl), serve_launched
    out["bigru_step_p50"] = {
        "shape": [*STREAM_STEP_TIME, H], "pipe_step_p50_ms": turns["pipe"],
        "stream_step_p50_ms": turns["stream"],
        "step_launches": step_launched,
        "matmul_precision": bcfg.train.matmul_precision,
        "fwd_train_plan": dict(gru_cuda.bigru_fwd_train_cuda.last_launch),
        "bwd_plan": dict(gru_cuda.bigru_bwd_cuda.last_launch),
        "serve_shape": [sB, sN, H],
        "pipe_serve_p50_ms": serve_turns["pipe"],
        "stream_serve_p50_ms": serve_turns["stream"],
        "serve_launches": serve_launched}
    log("stream_bigru", f"bigru d_model={STREAM_LSTM_D} (H={H}) train step "
        f"at B, N = {STREAM_STEP_TIME} (bench.py's), p50 over "
        f"{STREAM_STEPS} after {STREAM_WARMUP}, and served forward at B, N "
        f"= {STREAM_SERVE} (light kernels, CUDA events), p50 over "
        f"{STREAM_SERVE_CALLS} after {STREAM_WARMUP}, in turns pipe, stream,"
        f" stream, pipe (the forwards' kernel; the BPTT on its pipe route; "
        f"the config's matmul precision {bcfg.train.matmul_precision}): "
        + json.dumps(out["bigru_step_p50"]) + f" on {smi}")
    return out


# ---------------------------------------------------------------------------
# Phase 41: the GRU register cluster kernels (csrc/bigru_fwd_reg.cu,
# csrc/bigru_bwd_reg.cu: #5/#5t, #7/#7t, #6 and #8 at H 65-256), their
# checks, their A/B beside the first cluster design and the pipe kernels,
# and a bigru at d_model 512 on them
# ---------------------------------------------------------------------------


def _reg_cases(B, N, H, dtype, dev, seed, card_residuals=False):
    """The six GRU wrappers at (B, N, H) in ``dtype``, the one-direction
    ones in both walk orders: name, wrapper, plain version, arguments,
    kind ("fwd" or "bwd"), kSave and directions. The BPTT's residuals come
    from the plain training forward, or (``card_residuals``, at the large
    shapes where the plain walk takes seconds) from the card's."""
    ins = gru_inputs(B, N, H, dtype, dev, seed)
    if card_residuals:
        ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train_cuda(
            *ins)
        g = torch.Generator(dev).manual_seed(seed + 1)
        dy_f, dy_b = (torch.randn(ys_f.shape, device=dev, generator=g
                                  ).to(dtype) for _ in range(2))
        args = (ins[2], ins[4], gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b,
                dy_b)
    else:
        args = gru_bwd_inputs(ins, seed + 1)
    g = gru_cuda
    fwd_one = ((ins[0], ins[2], ins[3], False), (ins[1], ins[4], ins[5], True))
    bwd_one = ((args[0], *args[2:6], False), (args[1], *args[6:], True))
    return (
        ("bigru_fwd", g.bigru_fwd_cuda, g.bigru_fwd_plain, ins, "fwd", False,
         2),
        ("bigru_fwd_train", g.bigru_fwd_train_cuda, g.bigru_fwd_train_plain,
         ins, "fwd", True, 2),
        ("bigru_bwd", g.bigru_bwd_cuda, g.bigru_bwd_plain, args, "bwd",
         False, 2),
        *(("gru_fwd", g.gru_fwd_cuda, g.gru_recurrence, a, "fwd", False, 1)
          for a in fwd_one),
        *(("gru_fwd_train", g.gru_fwd_train_cuda, g.gru_fwd_train_plain, a,
           "fwd", True, 1) for a in fwd_one),
        *(("gru_bwd", g.gru_bwd_cuda, g.gru_bwd_plain, a, "bwd", False, 1)
          for a in bwd_one))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_gru_reg(dev, seed):
    """Phase 41 (a): the six GRU wrappers on their route, the register
    cluster kernels (asserted), at ``REG_WIDTHS`` x ``REG_BATCHES``,
    N=``REG_N``, float32 and bf16, the one-direction ones in both walk
    orders, against the plain versions (values: f32 max abs err
    ``KERNEL_ATOL``, bf16 rtol / atol ``BF16_RTOL`` / ``BF16_ATOL``; the
    BPTT's dx and dhn max-rel ``GRAD_REL`` / ``BF16_GRAD_REL``), the BPTT
    bit-equal run to run. bf16 two-direction launches the tensor-core
    kernels take (H=128, 256) are checked on the card's register pick,
    forced. Returns the worst errors by dtype."""
    worst = {}
    for H in REG_WIDTHS:
        for B in REG_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
                errs, rels, plans = [], [], {}
                for name, fn, plain, a, kind, save, dirs in _reg_cases(
                        B, REG_N, H, dtype, dev, seed):
                    route = (gru_cuda.gru_fwd_kernel_route if kind == "fwd"
                             else gru_cuda.gru_bwd_kernel_route)(H, dirs,
                                                                 dtype)
                    plan = None if route == "reg" else ("reg", *(
                        gru_cuda.card_gru_reg_plans(kind, B, H, dev, dtype,
                                                    save, dirs)[0]))
                    got = _as_tuple(fn(*a, plan=plan))
                    assert fn.last_launch["kernel"] == "reg", (
                        name, H, B, dtype, route, fn.last_launch)
                    ref = _as_tuple(plain(*a))
                    if kind == "bwd":
                        again = _as_tuple(fn(*a, plan=plan))
                        assert all(torch.equal(x, y)
                                   for x, y in zip(got, again)), (name, H, B)
                        assert all(torch.isfinite(x).all() for x in got)
                        rels += [max_rel(x.float(), y.float())
                                 for x, y in zip(got, ref)]
                    else:
                        errs.append(value_err(got, ref, dtype))
                    plans.setdefault(name, (
                        f"{name} {plan_text(fn)}"
                        + ("" if plan is None else f" (route {route})")))
                assert max(rels) <= tol, (H, B, dtype, rels)
                torch.cuda.synchronize()
                key = str(dtype)[6:]
                w = worst.setdefault(key, [0.0, 0.0])
                w[0], w[1] = max(w[0], max(errs)), max(w[1], max(rels))
                log("gru_reg", f"B,N,H=({B}, {REG_N}, {H}) {key}: values "
                    f"max_abs_err={max(errs):.3e}, dx/dhn max_rel_err="
                    f"{max(rels):.3e} (tol {tol:g}), both walk orders, the "
                    "BPTT bit-equal run to run; " + "; ".join(plans.values()))
    return worst


def _reg_ab(fn, a, kind, save, dirs, B, N, H, dev, route, got):
    """The register kernel (forced at its card's pick), the first cluster
    design and the pipe kernel (each forced at its planner's pick, as the
    wrapper ``fn`` takes them) in turns, reg, cluster, pipe, pipe, cluster,
    reg (CUDA events, 3 after 1 each); the route's kernel ``route`` ("reg"
    or "pipe") asserted faster than the first design; whether it is the
    fastest of the three; the first design's and the pipe kernel's outputs
    held to the route's ``got`` (f32 values ``KERNEL_ATOL``, the BPTT
    max-rel ``GRAD_REL``); and the card's first ``REG_SWEEP`` register
    plans: a row's extra keys."""
    f32 = torch.float32
    plans = {
        "reg": ("reg", *gru_cuda.card_gru_reg_plans(kind, B, H, dev, f32,
                                                    save, dirs)[0]),
        "cluster": ("cluster", *gru_cuda.card_plans(kind, B, H, dev, f32,
                                                    dirs)[0]),
        "pipe": ("pipe", *(gru_cuda.card_gru_pipe_plans(B, H, dev, f32, dirs)
                           if kind == "bwd" else
                           gru_cuda.card_gru_fwd_pipe_plans(
                               B, H, dev, f32, save, dirs))[0])}
    turns, launches, agree = {}, {}, {}
    for key in ("reg", "cluster", "pipe", "pipe", "cluster", "reg"):
        plan = plans[key]
        turns.setdefault(key, []).append(
            cuda_ms(lambda: fn(*a, plan=plan), 3, warmup=1))
        launches[key] = dict(fn.last_launch)
        assert launches[key]["kernel"] == key, launches[key]
    for key in ("cluster", "pipe"):
        out = _as_tuple(fn(*a, plan=plans[key]))
        if kind == "bwd":
            agree[key] = max(max_rel(x.float(), y.float())
                             for x, y in zip(out, got))
            assert agree[key] <= GRAD_REL, (key, agree[key])
        else:
            agree[key] = value_err(out, got, f32)
        del out
    best = {k: min(v) for k, v in turns.items()}
    assert best[route] < best["cluster"], (route, turns)
    sweep = [{"plan": [c, r], "ms": cuda_ms(
        lambda: fn(*a, plan=("reg", c, r)), 3, warmup=1)}
        for c, r in gru_cuda.card_gru_reg_plans(kind, B, H, dev, f32, save,
                                                dirs)[:REG_SWEEP]]
    return {**{f"{k}_turns_ms": v for k, v in turns.items()},
            **{f"{k}_ms": v for k, v in best.items()},
            **{f"{k}_us_per_step": v / N * 1e3 for k, v in best.items()},
            **{f"{k}_launch": v for k, v in launches.items()},
            "route_fastest": best[route] == min(best.values()),
            "first_over_route": best["cluster"] / best[route],
            "max_err_vs_route": agree, "reg_plans_ms": sweep,
            "reg_pick_fastest": sweep[0]["ms"] == min(r["ms"] for r in sweep)}


def time_gru_reg(dev, seed):
    """Phase 41 (b), the kernel A/B at each ``REG_TIME`` shape (float32)
    for the wrappers it names (the one-direction ones walking forward): the
    route (the register kernel; at the scale-up batch the forwards' batch
    rule takes the pipe kernel) beside the first cluster design and the
    pipe kernel in turns (``_reg_ab``), the register plans swept; at the
    first shape the plain version held and timed (one call), at the others
    the route held to the first design (``_reg_ab``); the bound; cuDNN's
    ``nn.GRU`` (bidirectional for the two-direction kernels; never called
    by the port; input projection included; read before and after the
    first shape's kernels, the lower kept: ``_library_turns``; at the
    others read once) and µs a step. Returns the rows by wrapper name, a
    list in ``REG_TIME``'s order."""
    f32 = torch.float32
    rows = {}
    for i, ((B, N, H), names) in enumerate(REG_TIME.items()):
        first = i == 0
        # cuDNN in the direction counts the shape's wrappers take
        dir_counts = tuple(sorted({2 if n.startswith("bi") else 1
                                   for n in names}, reverse=True))
        lib = _library_ms(torch.nn.GRU, B, N, H, f32, dev, seed, dir_counts)
        shape_rows, seen = [], set()
        for name, fn, plain, a, kind, save, dirs in _reg_cases(
                B, N, H, f32, dev, seed, card_residuals=not first):
            if name not in names or name in seen:
                continue
            seen.add(name)
            got = _as_tuple(fn(*a))
            launch = dict(fn.last_launch)
            route = launch["kernel"]
            assert route in ("reg", "pipe"), (name, launch)
            row = {"shape": [B, N, H], "dtype": "float32", "route": route,
                   "launch": launch, "plain_ms": None, "err": None}
            if first:
                ref, row["plain_ms"] = timed_once(lambda: _as_tuple(plain(*a)))
                if kind == "bwd":
                    row["err"] = max((x.float() - y.float()).abs().max().item()
                                     for x, y in zip(got, ref))
                    row["max_rel_err"] = max(
                        max_rel(x.float(), y.float()) for x, y in zip(got, ref))
                    assert row["max_rel_err"] <= GRAD_REL, (name, row)
                else:
                    row["err"] = value_err(got, ref, f32)
                del ref
            row.update(_reg_ab(fn, a, kind, save, dirs, B, N, H, dev, route,
                               got))
            if not first:   # held to the first design there
                row["err"] = row["max_err_vs_route"]["cluster"]
            del got
            ms = row[f"{route}_ms"]
            bnd = gru_bound("bwd" if kind == "bwd" else
                            "fwd_train" if save else "fwd", B, N, H, f32,
                            dirs=dirs)
            row.update(kernel_ms=ms, us_per_step=ms / N * 1e3,
                       bound_us=bnd[0] * 1e3, bound_by=bnd[1],
                       library_ms=lib[name])
            rows.setdefault(name, []).append(row)
            shape_rows.append((name, row))
        if first:
            _library_turns(shape_rows, _library_ms(torch.nn.GRU, B, N, H,
                                                   f32, dev, seed,
                                                   dir_counts))
        for name, row in shape_rows:
            log("kernel_time", f"{name} (GRU register route, kernel "
                f"{row['route']}: kernel_ms its lower reading in turns; "
                "cluster_ms: the first cluster design forced at its pick, "
                "pipe_ms: the pipe kernel forced at its pick, in turns reg, "
                "cluster, pipe, pipe, cluster, reg; reg_plans_ms: the card's "
                "first register plans) " + json.dumps(row)
                + "  (library_ms: cuDNN "
                + ("bidirectional " if name.startswith("bi") else
                   "unidirectional ") + "nn.GRU f32"
                + ("'s lower reading, before and after the kernels, "
                   if "library_turns_ms" in row else ", ")
                + {"fwd": "forward without grad", "fwd_train":
                   "forward with grad on", "bwd": "forward + backward "
                   "minus forward"}[name.split("_", 1)[1]]
                + ", includes the input projection; err against the plain "
                "version; plain_ms one call, at the first shape only)")
    return rows


@contextlib.contextmanager
def first_gru_cluster():
    """The GRU routes as before the register cluster kernels: the first
    cluster design wherever a route says "reg" (both grids, forward and
    BPTT); every other route unchanged."""
    routes = {name: getattr(gru_cuda, name) for name in
              ("gru_fwd_kernel_route", "gru_bwd_kernel_route")}

    def old(route):
        def pick(hidden, dirs, dtype=torch.float32):
            got = route(hidden, dirs, dtype)
            return "cluster" if got == "reg" else got
        return pick

    with mock.patch.multiple(gru_cuda, **{k: old(v)
                                          for k, v in routes.items()}):
        yield


def _reg_turns(run, kernels_of):
    """``run()`` in turns on the GRU register route and on the first
    cluster design (``first_gru_cluster``): reg, cluster, cluster, reg.
    ``run`` returns (ms, launches); ``kernels_of()`` the kernels of the
    last launches, each asserted. Returns the ms by kernel and the last
    launches (a register turn's)."""
    turns = {"reg": [], "cluster": []}
    for kernel in ("reg", "cluster", "cluster", "reg"):
        ctx = (first_gru_cluster if kernel == "cluster"
               else contextlib.nullcontext)
        with ctx():
            ms, launched = run()
        assert all(k == kernel for k in kernels_of()), (kernel, kernels_of())
        turns[kernel].append(ms)
    return turns, launched


def reg_paths(dev, seed, smi):
    """Phase 41 (c), a ``bigru`` at d_model ``REG_GRU_D`` (H=256, f32) on
    the GRU register cluster kernels, the counts set to 0 just before each
    path and read just after: one train step card vs CPU
    (``step_parity``: assignments, losses rel ``LOSS_RTOL``, updated
    parameters) at B, N = ``REG_STEP``; the train step's p50 at bench.py's
    B, N = ``REG_STEP_TIME`` over ``REG_STEPS`` after ``REG_WARMUP`` on
    ``REG_ROOMS`` rooms (the default config's matmul precision) and a
    served forward's p50 (CUDA events, the light kernels) at ``REG_SERVE``,
    on the register kernels and on the first cluster design
    (``first_gru_cluster``) in turns, each launch's kernel asserted.
    Returns the launches of the step and of the served forward (a register
    turn's) and the timings."""
    out = {}
    H = REG_GRU_D // 2
    B, N = REG_STEP
    sets = ["model.model_type=bigru", f"model.d_model={REG_GRU_D}"]
    cfg = ExperimentConfig().apply_overrides([*sets, "model.dropout=0.0"])
    cfg.train.batch_size, cfg.data.max_trace_len = B, N
    gl = cfg.model.lstm_layers
    bigru = ("bigru_fwd", "bigru_fwd_train", "bigru_bwd")
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), B, seed + 1010)
        reset_counts()
        step_parity(cfg, Path(tmp), dev, seed, tag="reg_bigru_step")
        torch.cuda.synchronize()
        c_k = counts()
    # the card's step and its match's light forward (and the unmodified
    # init's); the CPU's launch nothing
    assert c_k == expected_counts(bigru_fwd=c_k["bigru_fwd"],
                                  bigru_fwd_train=gl, bigru_bwd=gl), c_k
    for name in bigru:
        assert getattr(*WRAPPERS[name]).last_launch["kernel"] == "reg"
    out["parity_step"] = c_k
    log("reg_bigru", f"bigru d_model={REG_GRU_D} (H={H}) f32: one step card "
        f"vs CPU at B={B}, N={N} as above; launches {c_k} (bigru_fwd_train "
        f"{plan_text(gru_cuda.bigru_fwd_train_cuda)}; bigru_bwd "
        f"{plan_text(gru_cuda.bigru_bwd_cuda)}) on {smi}")

    tcfg = ExperimentConfig().apply_overrides(sets)
    tcfg.train.batch_size, tcfg.data.max_trace_len = REG_STEP_TIME
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), REG_ROOMS, seed + 1020)
        turns, step_launched = _reg_turns(
            lambda: step_p50(tcfg, Path(tmp), dev, seed, REG_STEPS,
                             REG_WARMUP),
            lambda: [getattr(*WRAPPERS[n]).last_launch["kernel"]
                     for n in bigru[1:]])
    assert step_launched == expected_counts(bigru_fwd_train=gl,
                                            bigru_bwd=gl), step_launched
    model = build_model(tcfg.model, generator=torch.Generator()
                        .manual_seed(seed)).to(dev).eval()
    sB, sN = REG_SERVE
    raw = walk(sN, seed + 1030)[None]
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.full((sB,), sN, device=dev))
    serve_turns, serve_launched = _reg_turns(
        lambda: served_p50(model, feats, mask, REG_STEPS, REG_WARMUP),
        lambda: [gru_cuda.bigru_fwd_cuda.last_launch["kernel"]])
    assert serve_launched == expected_counts(bigru_fwd=gl), serve_launched
    out["step"], out["serve"] = step_launched, serve_launched
    out["timing"] = {
        "shape": [*REG_STEP_TIME, H], "reg_step_p50_ms": turns["reg"],
        "cluster_step_p50_ms": turns["cluster"],
        "step_launches": step_launched,
        "matmul_precision": tcfg.train.matmul_precision,
        "fwd_train_plan": dict(gru_cuda.bigru_fwd_train_cuda.last_launch),
        "bwd_plan": dict(gru_cuda.bigru_bwd_cuda.last_launch),
        "serve_shape": [sB, sN, H], "reg_serve_p50_ms": serve_turns["reg"],
        "cluster_serve_p50_ms": serve_turns["cluster"],
        "serve_launches": serve_launched,
        "serve_plan": dict(gru_cuda.bigru_fwd_cuda.last_launch)}
    log("reg_bigru", f"bigru d_model={REG_GRU_D} (H={H}) train step at B, N "
        f"= {REG_STEP_TIME} (bench.py's), p50 over {REG_STEPS} after "
        f"{REG_WARMUP}, and served forward at B, N = {REG_SERVE} (light "
        f"kernels, CUDA events), p50 over {REG_STEPS} after {REG_WARMUP}, in "
        "turns reg, cluster, cluster, reg (the forwards' and the BPTT's "
        "kernel; the config's matmul precision "
        f"{tcfg.train.matmul_precision}): " + json.dumps(out["timing"])
        + f" on {smi}")
    return out


# ---------------------------------------------------------------------------
# Phase 42: the LSTM register cluster kernels at H 65-118, the widths of the
# wide kernels (the first design)
# ---------------------------------------------------------------------------


def lstm_mid_phase(dev, seed, smi):
    """Phase 42, (a) to (c); returns the worst errors, the A/B rows and
    the paths' launches and timings."""
    t0 = time.perf_counter()
    worst = check_lstm_mid(dev, seed)
    mid_resident(dev)
    rows = time_lstm_mid(dev, seed)
    time_plan_terms(dev, seed)
    launched = mid_paths(dev, seed, smi)
    log("done", f"phase 42 in {time.perf_counter() - t0:.1f} s; worst "
                "errors (values, BPTT max-rel, the Functions' max-rel) "
                f"{json.dumps(worst)}")
    return worst, rows, launched


def check_lstm_mid(dev, seed):
    """Phase 42 (a): the six LSTM wrappers on their route, the register
    cluster kernels (asserted), at ``MID_WIDTHS`` x ``MID_BATCHES``,
    N=``MID_N``, float32 and bf16, two directions and one in both walk
    orders, against the plain versions, the BPTT bit-equal on a second
    launch (``_lstm_cluster_case``); ``BiLSTMFunction``'s and
    ``LSTMFunction``'s gradients (both walk orders) against autograd
    through the plain loop (``grads_rel``: max-rel ``GRAD_REL``, bf16
    ``BF16_GRAD_REL``); then the wide kernel (the first design) forced at
    H=96, B=5. Returns the worst errors by dtype."""
    worst = {}
    for H in MID_WIDTHS:
        for B in MID_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                err, rel, plans = _lstm_cluster_case(H, B, dtype, dev, seed,
                                                     "reg", n=MID_N)
                xg_f, xg_b, w_f, w_b = kernel_inputs(B, MID_N, H, dev, seed)
                xg_f, xg_b = xg_f.to(dtype), xg_b.to(dtype)
                g = torch.Generator(dev).manual_seed(seed + 2)
                dy = [torch.randn(B, MID_N, H, device=dev, generator=g
                                  ).to(dtype) for _ in range(2)]
                fn_rel = grads_rel(rnn_cuda.bilstm_recurrence,
                                   rnn_cuda.bilstm_recurrence_plain,
                                   (xg_f, xg_b, w_f, w_b), dy, dtype)
                for reverse in (False, True):
                    fn_rel += grads_rel(
                        lambda *a: rnn_cuda.lstm_recurrence_kernel(*a,
                                                                   reverse),
                        lambda *a: rnn_cuda.lstm_recurrence(*a, reverse),
                        (xg_b, w_b), dy[1], dtype)
                for name in ("bilstm_fwd_train", "bilstm_bwd",
                             "lstm_fwd_train", "lstm_bwd"):
                    last = getattr(*WRAPPERS[name]).last_launch
                    assert last["kernel"] == "reg", (name, last)
                key = str(dtype)[6:]
                w = worst.setdefault(key, [0.0, 0.0, 0.0])
                w[:] = max(w[0], err), max(w[1], rel), max(w[2], *fn_rel)
                log("lstm_mid", f"B,N,H=({B}, {MID_N}, {H}) {key}: values "
                    f"max_abs_err={err:.3e}, dg max_rel_err={rel:.3e}, the "
                    "BPTT bit-equal run to run; BiLSTMFunction / "
                    "LSTMFunction (both walk orders) vs autograd through the "
                    f"plain loop max_rel_err {max(fn_rel):.3e}; "
                    + "; ".join(plans))
    err, rel, plans = _lstm_cluster_case(
        96, 5, torch.float32, dev, seed, "wide",
        lambda kind, save, dirs: ("wide", 4), n=MID_N)
    log("lstm_mid", f"the wide kernel (the first design), forced: B,N,H=(5, "
        f"{MID_N}, 96) float32: values max_abs_err={err:.3e}, dg "
        f"max_rel_err={rel:.3e}; " + "; ".join(plans))
    return worst


def _mid_ab(fn, a, kind, save, dirs, B, N, H, dev, got):
    """The register kernel at the card's pick and the wide kernel (the
    first design), both forced, in turns reg, wide, wide, reg (CUDA
    events, 5 after 1 each); the wide kernel's output held to the route's
    ``got`` (f32 values ``KERNEL_ATOL``, the BPTT max-rel ``GRAD_REL``);
    the card's first ``MID_SWEEP`` register plans: a row's extra keys."""
    f32 = torch.float32
    reg = rnn_cuda.card_lstm_reg_plans(kind, B, H, dev, f32, save, dirs)
    plans = {"reg": ("reg", *reg[0]), "wide": ("wide", 4)}
    turns, launches = {}, {}
    for key in ("reg", "wide", "wide", "reg"):
        turns.setdefault(key, []).append(
            cuda_ms(lambda: fn(*a, plan=plans[key]), 5, warmup=1))
        launches[key] = dict(fn.last_launch)
        assert launches[key]["kernel"] == key, launches[key]
    out = _as_tuple(fn(*a, plan=plans["wide"]))
    if kind == "bwd":
        agree = max(max_rel(x.float(), y.float()) for x, y in zip(out, got))
        assert agree <= GRAD_REL, agree
    else:
        agree = value_err(out, got, f32)
    del out
    best = {k: min(v) for k, v in turns.items()}
    resident = _reg_resident(kind, H, dev, save)
    sweep = [{"plan": [c, r], "resident": resident(c, r), "ms": cuda_ms(
        lambda: fn(*a, plan=("reg", c, r)), 5, warmup=1)}
        for c, r in reg[:MID_SWEEP]]
    return {**{f"{k}_turns_ms": v for k, v in turns.items()},
            **{f"{k}_ms": v for k, v in best.items()},
            **{f"{k}_us_per_step": v / N * 1e3 for k, v in best.items()},
            **{f"{k}_launch": v for k, v in launches.items()},
            "wide_over_reg": best["wide"] / best["reg"],
            "wide_err_vs_route": agree, "reg_plans_ms": sweep,
            "reg_pick_fastest": sweep[0]["ms"] == min(r["ms"] for r in sweep),
            "terms_ab": _terms_ab(fn, a, kind, save, dirs, B, H, dev)}


def _reg_resident(kind, H, dev, save):
    """``resident(cluster, rows)``: the card's count of clusters of that
    plan of the LSTM register kernel ``kind`` (float32) at H."""
    return rnn_cuda._cluster_resident(f"bilstm_{kind}", H, dev,
                                      torch.float32, save, "reg")


def _terms_ab(fn, a, kind, save, dirs, B, H, dev):
    """The LSTM planner's pick (``rnn_cuda.lstm_reg_terms``' cost terms)
    beside the shared ranking's pick without them (``rnn_cuda.reg_plans``,
    the GRU's and the LSTM's before the terms), on the card's counts; where
    they differ both forced in turns pick, shared, shared, pick (CUDA
    events, 5 after 1 each)."""
    resident = _reg_resident(kind, H, dev, save)
    pick = rnn_cuda.lstm_reg_plans(kind, B, H, resident, dirs)[0]
    shared = rnn_cuda.reg_plans(kind, B, H, resident, dirs)[0]
    row = {"pick": list(pick), "shared_pick": list(shared)}
    if pick != shared:
        turns = {"pick": [], "shared": []}
        for key in ("pick", "shared", "shared", "pick"):
            c, r = pick if key == "pick" else shared
            turns[key].append(cuda_ms(lambda: fn(*a, plan=("reg", c, r)), 5,
                                      warmup=1))
        row.update(pick_turns_ms=turns["pick"],
                   shared_turns_ms=turns["shared"],
                   shared_over_pick=min(turns["shared"]) / min(turns["pick"]))
    return row


def mid_resident(dev):
    """Phase 42 (b): the card's resident clusters
    (``cudaOccupancyMaxActiveClusters``) of every plan the register rule
    takes at ``MID_RESIDENT_H``, float32, for the light and the training
    forward and the BPTT: the counts behind the planner's picks."""
    table = {}
    for H in MID_RESIDENT_H:
        for kind, save in (("fwd", False), ("fwd", True), ("bwd", False)):
            resident = _reg_resident(kind, H, dev, save)
            table[f"{kind}{'_train' if save else ''} H={H}"] = {
                f"{c}x{r}": resident(c, r)
                for c in range(1, rnn_cuda.REG_MAX_CLUSTER + 1)
                for r in rnn_cuda.reg_rows(kind)
                if rnn_cuda._reg_rule(kind, H, c, r)}
    log("lstm_mid_resident", "float32 resident clusters by plan CxR: "
        + json.dumps(table))
    return table


def time_plan_terms(dev, seed):
    """Phase 42 (b), the LSTM planner's cost terms at register widths
    outside H 65-118, ``MID_TERMS`` float32: for each of the six wrappers
    ``_terms_ab`` (the pick beside the shared ranking's, in turns where
    they differ). Returns the rows by wrapper name."""
    rows = {}
    for B, N, H in MID_TERMS:
        for name, fn, _, a, _, kind, save, dirs in _lstm_cases(
                B, N, H, torch.float32, dev, seed):
            row = {"shape": [B, N, H],
                   **_terms_ab(fn, a, kind, save, dirs, B, H, dev)}
            rows.setdefault(name, []).append(row)
            log("plan_terms", f"{name} (the LSTM register planner's pick "
                "with its cost terms beside the shared ranking's, forced, "
                "in turns pick, shared, shared, pick where they differ; "
                "float32) " + json.dumps(row))
    return rows


def time_lstm_mid(dev, seed, route="reg"):
    """Phase 42 (b), the kernel A/B at each ``MID_TIME`` shape (float32)
    for the six LSTM wrappers (the one-direction ones walking forward): the
    route (asserted ``route``) and ``_mid_ab``'s turns of the register
    kernel and the wide kernel, forced; the register kernel asserted faster
    where it is the route; the bound; the plain version held at every
    shape (f32 values ``KERNEL_ATOL``, the BPTT max-rel ``GRAD_REL``) and
    timed (one call) at the first; cuDNN's ``nn.LSTM`` (bidirectional for
    the two-direction
    kernels; never called by the port; input projection included) read
    before and after each shape's kernels, the lower kept
    (``_library_turns``); µs a step. Returns the rows by wrapper name, a
    list in ``MID_TIME``'s order."""
    f32 = torch.float32
    rows = {}
    for i, (B, N, H) in enumerate(MID_TIME):
        first = i == 0
        lib = _library_ms(torch.nn.LSTM, B, N, H, f32, dev, seed)
        shape_rows = []
        for name, fn, plain, a, bnd, kind, save, dirs in _lstm_cases(
                B, N, H, f32, dev, seed):
            got = _as_tuple(fn(*a))
            launch = dict(fn.last_launch)
            assert launch["kernel"] == route, (name, launch)
            ref, plain_ms = timed_once(lambda: _as_tuple(plain(*a)))
            row = {"shape": [B, N, H], "dtype": "float32", "route": route,
                   "launch": launch, "plain_ms": plain_ms if first else None}
            if kind == "bwd":
                row["err"] = max((x - y).abs().max().item()
                                 for x, y in zip(got, ref))
                row["max_rel_err"] = max(max_rel(x, y)
                                         for x, y in zip(got, ref))
                assert row["max_rel_err"] <= GRAD_REL, (name, row)
            else:
                row["err"] = value_err(got, ref, f32)
            del ref
            row.update(_mid_ab(fn, a, kind, save, dirs, B, N, H, dev, got))
            del got
            if route == "reg":
                assert row["reg_ms"] < row["wide_ms"], (name, row)
            ms = row[f"{route}_ms"]
            row.update(kernel_ms=ms, us_per_step=ms / N * 1e3,
                       bound_us=bnd[0] * 1e3, bound_by=bnd[1],
                       library_ms=lib[name])
            rows.setdefault(name, []).append(row)
            shape_rows.append((name, row))
        _library_turns(shape_rows, _library_ms(torch.nn.LSTM, B, N, H, f32,
                                               dev, seed))
        for name, row in shape_rows:
            log("kernel_time", f"{name} (LSTM at H 65-118, kernel "
                f"{row['route']}: kernel_ms its lower reading in turns reg, "
                "wide, wide, reg, both forced, reg at the card's pick; "
                "reg_plans_ms: the card's first register plans) "
                + json.dumps(row) + "  (library_ms: the lower of cuDNN "
                + ("bidirectional " if name.startswith("bi") else
                   "unidirectional ") + "nn.LSTM f32's two readings, before "
                "and after the kernels, "
                + {"fwd": "forward without grad", "fwd_train":
                   "forward with grad on", "bwd": "forward + backward "
                   "minus forward"}[name.split("_", 1)[1]]
                + ", includes the input projection; err against the plain "
                "version; plain_ms one call, at the first shape only)")
    return rows


@contextlib.contextmanager
def wide_lstm():
    """The LSTM routes as before the register cluster kernels took H
    65-118: the wide kernel (the first design) wherever it fits (the
    forward to H=118, the BPTT to 116); every other route unchanged."""
    fwd, bwd = rnn_cuda.lstm_fwd_kernel_route, rnn_cuda.lstm_bwd_kernel_route

    def old(route, fits):
        def pick(hidden):
            got = route(hidden)
            return "wide" if got == "reg" and fits(hidden) else got
        return pick

    with mock.patch.multiple(rnn_cuda, lstm_fwd_kernel_route=old(
            fwd, lambda h: 4 * h <= rnn_cuda.MAX_THREADS and
            rnn_cuda.bilstm_smem_bytes(h) <= rnn_cuda.MAX_SMEM_BYTES),
            lstm_bwd_kernel_route=old(
                bwd, lambda h: rnn_cuda.bilstm_bwd_smem_bytes(h)
                <= rnn_cuda.MAX_SMEM_BYTES)):
        yield


def _mid_turns(run, kernels_of):
    """``run()`` in turns on the route (the register cluster kernels) and
    on the wide kernels (``wide_lstm``): reg, wide, wide, reg. ``run``
    returns (ms, launches); ``kernels_of()`` the kernels of the last
    launches, each asserted. Returns the ms by kernel and the last
    launches (a register turn's)."""
    turns = {"reg": [], "wide": []}
    for kernel in ("reg", "wide", "wide", "reg"):
        ctx = wide_lstm if kernel == "wide" else contextlib.nullcontext
        with ctx():
            ms, launched = run()
        assert all(k == kernel for k in kernels_of()), (kernel, kernels_of())
        turns[kernel].append(ms)
    return turns, launched


def mid_config(d_model, B, N):
    """``configs/flagship_v15.json``'s lstm at ``d_model``, B and N."""
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.model.d_model = d_model
    cfg.train.batch_size, cfg.data.max_trace_len = B, N
    return cfg


def mid_paths(dev, seed, smi):
    """Phase 42 (c), the lstm at d_model ``MID_LSTM_D`` (H=96, f32; the
    other fields ``configs/flagship_v15.json``'s, seeded weights) on the
    register cluster kernels, the counts set to 0 just before each path and
    read just after: a forward at ``MID_STEP_TIME``'s B, N against the plain
    recurrence; one train step card vs CPU (``step_parity``: assignments,
    losses rel ``LOSS_RTOL``, updated parameters) at ``MID_STEP``'s B, N;
    ``lstm_recurrence(use_kernel=True)`` at (``MID_STEP``, 96) forward and
    backward; the train step's p50 at bench.py's B, N = ``MID_STEP_TIME``
    over ``MID_STEPS`` after ``MID_WARMUP`` on ``MID_ROOMS`` rooms (the
    config's matmul precision) and a served forward's p50 (CUDA events,
    the light kernel) at ``MID_SERVE``, each on the register kernels and on
    the wide kernels (``wide_lstm``) in turns; then ``MID_TRACE_STEPS``
    steps in one ``step_trace`` on each, in turns (the device's busy ms and
    idle share a step, the LSTM kernels' device ms, the host ms of each
    ``MID_RANGED`` call); the served forward held to the plain recurrence
    (``MODEL_TOL``); the step p50 again at d_model ``MID_WIDE_D`` (H=116).
    Each launch's kernel is asserted. Returns the paths' launches and the
    timings."""
    out = {}
    H = MID_LSTM_D // 2
    B, N = MID_STEP_TIME
    cfg = mid_config(MID_LSTM_D, B, N)
    cfg.model.dropout = 0.0
    layers = cfg.model.lstm_layers
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    raw = np.stack([walk(N, seed + 1100 + b) for b in range(B)])
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.full((B,), N, device=dev))
    with torch.inference_mode():
        reset_counts()
        res = model(feats, mask)
        torch.cuda.synchronize()
        out["forward"] = counts()
        assert out["forward"] == expected_counts(bilstm_fwd=layers)
        assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "reg"
        with mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain):
            ref = model(feats, mask)
    fwd_err = max((res[k] - ref[k]).abs().max().item() for k in res)
    assert all(torch.allclose(res[k], ref[k], rtol=MODEL_TOL, atol=MODEL_TOL)
               for k in res), fwd_err
    sB, sN = MID_STEP
    scfg = mid_config(MID_LSTM_D, sB, sN)
    with tempfile.TemporaryDirectory() as tmp:
        write_rooms(Path(tmp), sB, seed + 1110)
        reset_counts()
        step_parity(scfg, Path(tmp), dev, seed, tag="mid_lstm_step")
        torch.cuda.synchronize()
        c_k = counts()
    # the card's step, and its match's light forward (and the unmodified
    # init's): the CPU's launch nothing
    assert c_k == expected_counts(bilstm_fwd=c_k["bilstm_fwd"],
                                  bilstm_fwd_train=layers,
                                  bilstm_bwd=layers), c_k
    for name in ("bilstm_fwd", "bilstm_fwd_train", "bilstm_bwd"):
        assert getattr(*WRAPPERS[name]).last_launch["kernel"] == "reg"
    out["parity_step"] = c_k
    log("mid_lstm", f"flagship lstm d_model={MID_LSTM_D} (H={H}) f32: "
        f"forward B={B} N={N} launches {out['forward']} "
        f"({plan_text(rnn_cuda.bilstm_fwd_cuda)}), vs the plain recurrence "
        f"max abs diff {fwd_err:.3e} (tol {MODEL_TOL:.0e}); one step card "
        f"vs CPU at B={sB}, N={sN} as above; launches {c_k} "
        f"(bilstm_fwd_train {plan_text(rnn_cuda.bilstm_fwd_train_cuda)}; "
        f"bilstm_bwd {plan_text(rnn_cuda.bilstm_bwd_cuda)}) on {smi}")

    # the ops-level one-direction path (#3, #3t, #4)
    xg, _, w, _ = kernel_inputs(sB, sN, H, dev, seed)
    dy = torch.randn(sB, sN, H, device=dev,
                     generator=torch.Generator(dev).manual_seed(seed))
    reset_counts()
    with torch.no_grad():
        ys = rnn_ops.lstm_recurrence(xg, w, False, use_kernel=True)
    x = [t.clone().requires_grad_(True) for t in (xg, w)]
    grads = torch.autograd.grad(
        rnn_ops.lstm_recurrence(*x, True, use_kernel=True), x, dy)
    torch.cuda.synchronize()
    out["ops"] = counts()
    assert out["ops"] == expected_counts(lstm_fwd=1, lstm_fwd_train=1,
                                         lstm_bwd=1), out["ops"]
    for name in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd"):
        assert getattr(*WRAPPERS[name]).last_launch["kernel"] == "reg"
    err = value_err((ys,), (rnn_ops.lstm_recurrence(xg, w, False),),
                    torch.float32)
    rel = max(max_rel(a, r) for a, r in zip(grads, torch.autograd.grad(
        rnn_ops.lstm_recurrence(*x, True), x, dy)))
    assert rel <= GRAD_REL, rel
    log("mid_ops", f"lstm_recurrence(use_kernel=True) B,N,H=({sB}, {sN}, "
        f"{H}): launches {out['ops']}; values max_abs_err={err:.3e}; "
        f"gradients max_rel_err={rel:.3e}; BPTT "
        f"{plan_text(rnn_cuda.lstm_bwd_cuda)}")

    # the train step at bench.py's B and N (the config's precision) and a
    # served forward, on the register kernels and on the wide kernels, in
    # turns; the step again at d_model MID_WIDE_D
    kernels = ("bilstm_fwd_train", "bilstm_bwd")
    timing = {}
    for d_model in (MID_LSTM_D, MID_WIDE_D):
        tcfg = mid_config(d_model, *MID_STEP_TIME)
        with tempfile.TemporaryDirectory() as tmp:
            write_rooms(Path(tmp), MID_ROOMS, seed + 1120)
            turns, launched = _mid_turns(
                lambda: step_p50(tcfg, Path(tmp), dev, seed, MID_STEPS,
                                 MID_WARMUP),
                lambda: [getattr(*WRAPPERS[n]).last_launch["kernel"]
                         for n in kernels])
            if d_model == MID_LSTM_D:
                traces, _ = _mid_turns(
                    lambda: step_trace(tcfg, Path(tmp), dev, seed,
                                       MID_TRACE_STEPS, MID_WARMUP,
                                       MID_RANGED),
                    lambda: [getattr(*WRAPPERS[n]).last_launch["kernel"]
                             for n in kernels])
        assert launched == expected_counts(bilstm_fwd_train=layers,
                                           bilstm_bwd=layers), launched
        timing[d_model] = {
            "shape": [*MID_STEP_TIME, d_model // 2],
            "reg_step_p50_ms": turns["reg"],
            "wide_step_p50_ms": turns["wide"], "step_launches": launched,
            "matmul_precision": tcfg.train.matmul_precision,
            "fwd_train_plan": dict(rnn_cuda.bilstm_fwd_train_cuda
                                   .last_launch),
            "bwd_plan": dict(rnn_cuda.bilstm_bwd_cuda.last_launch)}
        if d_model == MID_LSTM_D:
            out["step"] = launched
            timing[d_model].update(reg_trace=traces["reg"],
                                   wide_trace=traces["wide"])
    vB, vN = MID_SERVE
    vraw = walk(vN, seed + 1130)[None]
    vfeats, vmask = featurize(torch.from_numpy(vraw).to(dev),
                              torch.full((vB,), vN, device=dev))
    with torch.inference_mode():
        res = model(vfeats, vmask)
        assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "reg"
        with mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain):
            ref = model(vfeats, vmask)
    serve_err = max((res[k] - ref[k]).abs().max().item() for k in res)
    assert all(torch.allclose(res[k], ref[k], rtol=MODEL_TOL, atol=MODEL_TOL)
               for k in res), serve_err
    del res, ref
    serve_turns, serve_launched = _mid_turns(
        lambda: served_p50(model, vfeats, vmask, MID_STEPS, MID_WARMUP),
        lambda: [rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"]])
    assert serve_launched == expected_counts(bilstm_fwd=layers), \
        serve_launched
    out["serve"] = serve_launched
    timing[MID_LSTM_D].update(
        serve_shape=[vB, vN, H], serve_err_vs_plain=serve_err,
        reg_serve_p50_ms=serve_turns["reg"],
        wide_serve_p50_ms=serve_turns["wide"],
        serve_launches=serve_launched,
        serve_plan=dict(rnn_cuda.bilstm_fwd_cuda.last_launch))
    out["timing"] = timing
    log("mid_lstm", f"flagship lstm d_model={MID_LSTM_D} (H={H}) and "
        f"{MID_WIDE_D} (H={MID_WIDE_D // 2}): train step at B, N = "
        f"{MID_STEP_TIME} (bench.py's), p50 over {MID_STEPS} after "
        f"{MID_WARMUP}, and (d_model {MID_LSTM_D}) served forward at B, N = "
        f"{MID_SERVE} (light kernels, CUDA events), p50 over {MID_STEPS} "
        f"after {MID_WARMUP}, in turns reg, wide, wide, reg (the forwards' "
        "and the BPTT's kernel): " + json.dumps(timing) + f" on {smi}")
    return out


class EventTimer:
    """CUDA events around every call of the functions it wraps."""

    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out
        return timed

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


@contextlib.contextmanager
def fwd_batches():
    """The batch of every ``bilstm_fwd`` launch made inside the block."""
    seen = []
    launch = rnn_cuda._bilstm_fwd_launch

    def spy(fn, save, xg_f, *args, **kwargs):
        if fn is rnn_cuda.bilstm_fwd_cuda:
            seen.append(xg_f.shape[0])
        return launch(fn, save, xg_f, *args, **kwargs)

    with mock.patch.object(rnn_cuda, "_bilstm_fwd_launch", spy):
        yield seen


def max_confidence(model, x, m) -> float:
    """The auto gates' signal: the largest raw candidate confidence."""
    with torch.no_grad():
        out = model(x, m)
    return float(predictor_mod._max_confidence(out["pred_classes"],
                                               out.get("pred_objectness")))


def serving_recipes(y_planes, tau):
    """Phase 35's three recipes (``build_predictor`` arguments). ttopt runs
    with the adopted deadband 0.25: without it, a box the walk grazes
    switches its plow force on and off as points cross its faces, and 150
    Adam steps turn a 1e-6 difference in the model's boxes (the kernel's
    summation order against the plain recurrence's) into steps of the
    order of lr (0.02 m) and a changed ranking."""
    return {
        "unseen": dict(confidence_threshold=0.0, nms_threshold=0.5,
                       y_planes=y_planes, soft_sigma=0.25, ttopt=True,
                       ttopt_params={"deadband": 0.25, "auto": tau}),
        "tta": dict(confidence_threshold=0.0, nms_threshold=0.3,
                    tta_rotations=True, tta_reflect=True,
                    tta_scales=(0.9, 1.1), fuse=True, consensus=True,
                    top_k=15),
        "passes": dict(confidence_threshold=0.0, nms_threshold=0.3,
                       refine_clearance=0.3, refine_furniture=True,
                       synth_walls=True, synth_furniture="v2",
                       extent_slack=1.0, qscore=str(QSCORE_WEIGHTS),
                       qscore_auto=tau, ttopt=True,
                       ttopt_params={"deadband": 0.25}),
    }


def colliders_diff(got, ref) -> float:
    """Card vs CPU answers: labels equal (asserted), the largest abs
    difference of confidences, centers and sizes."""
    assert [c["label"] for c in got] == [c["label"] for c in ref], (
        [c["label"] for c in got], [c["label"] for c in ref])
    return max((np.abs(np.subtract(collider_values(a), collider_values(b))
                       ).max() for a, b in zip(got, ref)), default=0.0)


def serve_recipes(model, max_len, dev, seed, smi):
    """Phase 35: the flagship served with the three recipes. Per recipe,
    ``RECIPE_REQUESTS`` requests on the card against the same predictor on
    the CPU (labels equal, values within MODEL_TOL), exactly two
    ``bilstm_fwd`` launches a request at B = R views (asserted), then p50 /
    p99 over ``RECIPE_WINDOW`` requests after ``RECIPE_WARMUP``, split into
    load / prepare / run / finish on the host clock with the NMS
    (``post_process``) and ttopt stages on CUDA events. Returns the launch
    batches of the checked requests and the rows."""
    traces = [walk(2 * max_len, seed + 200 + i)
              for i in range(RECIPE_REQUESTS)]
    cpu_model = copy.deepcopy(model).cpu()
    batches, rows = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, t in enumerate(traces):
            files.append(Path(tmp) / f"request_{i}.json")
            formats.save_trace_json(files[-1], t)
        cols = Path(tmp) / "colliders.json"
        cols.write_text(json.dumps({"colliders": [
            {"label": "BLOCK", "center": {"x": 0.0, "y": 1.8, "z": -3.1},
             "size": {"x": 6.0, "y": 3.6, "z": 0.12}},
            {"label": "BLOCK", "center": {"x": 3.1, "y": 1.75, "z": 0.0},
             "size": {"x": 0.12, "y": 3.5, "z": 6.0}},
            {"label": "MID", "center": {"x": 1.0, "y": 0.5, "z": 1.0},
             "size": {"x": 1.0, "y": 1.0, "z": 0.6}}]}))
        y_planes = y_planes_from_colliders(str(cols))
        assert np.allclose(y_planes, (0.0, 3.6)), y_planes
        probe = build_predictor(model, max_trace_len=max_len, device=dev,
                                verbose=False)
        signals = [max_confidence(model, *probe.prepare(
            formats.load_trace_json(f))) for f in files]
        tau = GATE_TAU
        if not min(signals) < tau <= max(signals):
            s = sorted(signals)
            tau = (s[len(s) // 2 - 1] + s[len(s) // 2]) / 2
        fires = [sig < tau for sig in signals]
        assert any(fires) and not all(fires), (signals, tau)
        log("serve_recipes",
            f"gate signals (max raw confidence) {[round(v, 4) for v in signals]}"
            f"; tau {tau:.4f} (the adopted {GATE_TAU} "
            + ("reaches both ways" if tau == GATE_TAU else
               "does not split them: set between the middle signals")
            + f"): the gates fire for requests "
            f"{[i for i, f in enumerate(fires) if f]}, skip "
            f"{[i for i, f in enumerate(fires) if not f]}")
        recipes = serving_recipes(y_planes, tau)
        # the view batches the tta recipe's R = 24 leaves out, one request
        # each, card vs CPU
        extra = {"tta_rot": dict(confidence_threshold=0.0, nms_threshold=0.3,
                                 tta_rotations=True),
                 "tta_rot_reflect": dict(confidence_threshold=0.0,
                                         nms_threshold=0.3,
                                         tta_rotations=True,
                                         tta_reflect=True, fuse=True)}
        for name, kw in {**recipes, **extra}.items():
            predict = build_predictor(model, max_trace_len=max_len,
                                      device=dev, verbose=False, **kw)
            cpu_predict = build_predictor(cpu_model, max_trace_len=max_len,
                                          device="cpu", verbose=False, **kw)
            R = len(predict.views)
            checked = files if name in recipes else files[:1]
            reset_counts()
            with fwd_batches() as seen:
                answers = [predict(formats.load_trace_json(f))
                           for f in checked]
            torch.cuda.synchronize()
            assert counts() == expected_counts(
                bilstm_fwd=2 * len(checked)), counts()
            assert seen == [R] * (2 * len(checked)), seen
            batches += seen
            errs = [colliders_diff(a, cpu_predict(formats.load_trace_json(f)))
                    for a, f in zip(answers, checked)]
            assert max(errs) <= MODEL_TOL, (name, errs)
            assert all(len(a) > 0 for a in answers), name
            log("serve_recipes",
                f"{name} {kw}: R={R} views, {len(checked)} requests, "
                f"colliders {[len(a) for a in answers]}, bilstm_fwd launches "
                f"at B={sorted(set(seen))}: {len(seen)}; card vs CPU max abs "
                f"diff {max(errs):.3e} tol {MODEL_TOL:.0e}, labels equal")
            if name not in recipes:
                continue
            rows[name] = time_recipe(name, predict, files, R, smi)
        support_direct(recipes["passes"], model, cpu_model, max_len, dev,
                       files[0])
    return batches, rows


def time_recipe(name, predict, files, R, smi):
    """Phase 35's timing of one recipe: the window's requests cycle over
    the checked traces."""
    stages = ("load", "prepare", "run", "finish")
    for i in range(RECIPE_WARMUP):
        predict(formats.load_trace_json(files[i % len(files)]))
    nms, ttopt = EventTimer(), EventTimer()
    ms = np.zeros((RECIPE_WINDOW, len(stages)))
    with mock.patch.object(predictor_mod, "post_process",
                           nms.wrap(predictor_mod.post_process)), \
            mock.patch.object(predictor_mod, "adapt_boxes",
                              ttopt.wrap(predictor_mod.adapt_boxes)):
        for i in range(RECIPE_WINDOW):
            t = [time.perf_counter()]
            arr = formats.load_trace_json(files[i % len(files)])
            t.append(time.perf_counter())
            x, m = predict.prepare(arr)
            t.append(time.perf_counter())
            stacked = predict.run(x, m)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            predict.finish(stacked)
            t.append(time.perf_counter())
            ms[i] = np.diff(t) * 1e3
    req = ms.sum(1)
    nms_ms, ttopt_ms = nms.ms(), ttopt.ms()
    row = {"recipe": name, "views": R, "requests": RECIPE_WINDOW,
           "warmup": RECIPE_WARMUP,
           "p50_ms": float(np.percentile(req, 50)),
           "p99_ms": float(np.percentile(req, 99)),
           "mean_ms": float(req.mean()),
           **{f"{k}_ms": float(v) for k, v in zip(stages, ms.mean(0))},
           "nms_ms": float(np.median(nms_ms)),
           "ttopt_ms": float(np.median(ttopt_ms)) if ttopt_ms else None,
           "candidates": int(stacked.shape[0])}
    log("serve_recipes", f"{name}: {json.dumps(row)} (host clock; nms_ms "
        f"and ttopt_ms: CUDA events, median a request) on {smi}")
    return row


def support_direct(kw, model, cpu_model, max_len, dev, trace_file):
    """Phase 35: support-ordered NMS (``post_process(support=)``, which no
    predictor argument reaches) on the passes recipe's pooled candidates of
    one request, card vs CPU on the same inputs."""
    captured = []

    def capture(*args, **kwargs):
        captured.append((args, kwargs))
        return post_process(*args, **kwargs)

    predict = build_predictor(model, max_trace_len=max_len, device=dev,
                              verbose=False, **kw)
    with mock.patch.object(predictor_mod, "post_process", capture):
        predict(formats.load_trace_json(trace_file))
    (boxes, logits), opts = captured[0]
    opts = dict(opts, support=0.25)
    got, ms = timed_once(lambda: post_process(boxes, logits, **opts))
    cpu_opts = {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in opts.items()}
    ref = post_process(boxes.cpu(), logits.cpu(), **cpu_opts)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(
        got[1].cpu(), ref[1])
    err = max((g.cpu() - r).abs().max().item()
              for g, r in zip(got[2:], ref[2:]))
    assert err <= MODEL_TOL, err
    log("serve_recipes", f"support=0.25 through post_process on the passes "
        f"recipe's {boxes.shape[0]} pooled candidates: {int(got[0].sum())} "
        f"kept, keep and labels equal card vs CPU, values max abs diff "
        f"{err:.3e}; {ms:.3f} ms (CUDA events, one call)")


def time_tta_batches(dev, seed, launched):
    """Phase 36: ``bilstm_fwd`` at the test-time view batches against its
    plain version (the planner's unit tile), its time against the bound and
    cuDNN's bidirectional ``nn.LSTM`` (never called by the port), µs a
    step; ``launched`` maps a batch to phase 35's launches at it."""
    rows = []
    for shape in TTA_SHAPES:
        B, N, H = shape
        ins = kernel_inputs(*shape, dev, seed)
        got = rnn_cuda.bilstm_fwd_cuda(*ins)
        plan = dict(rnn_cuda.bilstm_fwd_cuda.last_launch)
        ref, plain_ms = timed_once(
            lambda: rnn_cuda.bilstm_recurrence_plain(*ins))
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        assert plan["kernel"] == "unit", plan
        assert err <= KERNEL_ATOL, (shape, err)
        kernel_ms = cuda_ms(lambda: rnn_cuda.bilstm_fwd_cuda(*ins), 10)
        lib = torch.nn.LSTM(2 * H, H, batch_first=True,
                            bidirectional=True).to(dev)
        x = torch.randn(B, N, 2 * H, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lib(x), 10)
        bound_ms, bound_by = bilstm_bound(B, N, H)
        row = {"shape": list(shape), "err": err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_us": bound_ms * 1e3, "bound_by": bound_by,
               "us_per_step": kernel_ms / N * 1e3,
               "library_us_per_step": library_ms / N * 1e3,
               "launch": plan, "launches": launched.get(B, 0)}
        rows.append(row)
        log("tta_kernel", json.dumps(row) + "  (library_ms: cuDNN "
            "bidirectional nn.LSTM, includes the input projection; plain_ms "
            "one call; launches: phase 35's at this batch)")
    return rows


def hole_tokens_path(cfg, dev, seed, smi):
    """Phase 37: the flagship with ``hole_tokens`` at full width, seeded
    weights, on ``HOLE_ROOMS`` seeded rooms (their walks leave interior
    holes): a B=32, N=500 forward on the card against the plain
    recurrence, one train step card vs CPU (as phase 10), one request
    served card vs CPU."""
    hcfg = copy.deepcopy(cfg)
    hcfg.model.hole_tokens = HOLE_TOKENS
    model = build_model(hcfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    B, N = 32, 500
    with tempfile.TemporaryDirectory() as tmp:
        rooms = write_rooms(Path(tmp), HOLE_ROOMS, seed + 30)
        walks = [formats.load_trace_json(f) for f in rooms]
        raw = np.stack([formats.linspace_downsample(w, N)
                        for w in walks[:B]])
        lengths = np.random.default_rng(seed + 3).integers(N // 2, N + 1,
                                                           size=len(raw))
        lengths[0] = N
        feats, mask = featurize(torch.from_numpy(raw).to(dev),
                                torch.from_numpy(lengths).to(dev))
        with torch.inference_mode():
            reset_counts()
            out = model(feats, mask)
            torch.cuda.synchronize()
            assert counts() == expected_counts(bilstm_fwd=2), counts()
            with mock.patch.object(lstm_mod, "bilstm_recurrence",
                                   rnn_cuda.bilstm_recurrence_plain):
                ref = model(feats, mask)
            errs = {}
            for k, v in out.items():
                assert torch.isfinite(v).all(), k
                errs[k] = (v - ref[k]).abs().max().item()
                assert torch.allclose(v, ref[k], rtol=MODEL_TOL,
                                      atol=MODEL_TOL), (k, errs[k])
            holes = lstm_mod.hole_components(feats[..., 0], feats[..., 2],
                                             mask, HOLE_TOKENS)
            live = int((holes["area_m2"] > 0.02).sum())
            fwd_ms = cuda_ms(lambda: model(feats, mask), 10)
        assert live > 0
        log("hole_tokens", f"lstm hole_tokens={HOLE_TOKENS} forward "
            f"B={len(raw)} N={N} on {HOLE_ROOMS} seeded rooms: {live} of "
            f"{len(raw) * HOLE_TOKENS} hole slots live; max abs err vs plain "
            + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" tol {MODEL_TOL:.0e}; {fwd_ms:.3f} ms (CUDA events) on {smi}")
        step_parity(hcfg, Path(tmp), dev, seed, tag="hole_step")
        kw = dict(max_trace_len=hcfg.data.max_trace_len,
                  confidence_threshold=0.0, nms_threshold=0.3, verbose=False)
        reset_counts()
        got = build_predictor(model, device=dev, **kw)(walks[-1])
        assert counts() == expected_counts(bilstm_fwd=2), counts()
        err = colliders_diff(got, build_predictor(
            copy.deepcopy(model).cpu(), device="cpu", **kw)(walks[-1]))
        assert err <= MODEL_TOL and len(got) > 0, err
        log("hole_tokens", f"one request of {len(walks[-1])} points served: "
            f"{len(got)} colliders, card vs CPU max abs diff {err:.3e}, "
            "labels equal")


def check_walks(ds, name):
    """Phase 38: the generator's invariants on every walk of ``ds``: time
    strictly increasing, inside the walls within ``WALL_SLACK``, never
    strictly inside a blocking footprint (valid, bottom below knee
    height). Returns the walks checked."""
    n = ds.n_base
    for c0 in range(0, n, 256):
        raw = ds.raw[c0:c0 + 256]
        boxes, valid = ds.boxes[c0:c0 + 256], ds.valid[c0:c0 + 256]
        assert (np.diff(raw[..., 3], axis=1) > 0).all(), (name, c0)
        wv = valid[:, :synthetic.N_WALL_SLOTS]
        for ax, col in ((0, 0), (2, 2)):
            wc = boxes[:, :synthetic.N_WALL_SLOTS, col]
            lo = np.where(wv, wc, np.inf).min(1) - WALL_SLACK
            hi = np.where(wv, wc, -np.inf).max(1) + WALL_SLACK
            p = raw[..., ax]
            assert ((p >= lo[:, None]) & (p <= hi[:, None])).all(), \
                (name, c0, ax)
        blocking = valid & (boxes[..., 1] - boxes[..., 4] / 2
                            < synthetic.FLOOR_Y + 0.4)
        inside = ((np.abs(raw[:, :, None, 0] - boxes[:, None, :, 0])
                   < boxes[:, None, :, 3] / 2)
                  & (np.abs(raw[:, :, None, 2] - boxes[:, None, :, 2])
                     < boxes[:, None, :, 5] / 2) & blocking[:, None])
        assert not inside.any(), (name, c0, np.argwhere(inside)[:3])
    return n


def recipe_path(cfg, dev, seed, smi):
    """Phase 38: the flagship's frozen training recipe on the card. (a)
    ``make_synthetic_datasets`` at ``RECIPE_ROOMS`` rooms, mixed, seed
    ``RECIPE_SEED``, at the flagship's width (L 1500, 50 colliders; agent
    6000 ticks at 30 Hz, human 3600 at 37 Hz) and its val split: time,
    walks/s, peak memory; the invariants on every walk; the first
    ``RECIPE_CPU_ROOMS`` rooms of each half generated again on the CPU
    (labels and valid equal, boxes within 1e-5, the share of traces
    within 1e-3 printed). (b) ``make_rooms``' seeded captures tiled
    ``RECIPE_MIX_COPIES`` times into the train split with ``concat``, one
    epoch of ``train_benchmark`` with the config's precision honoured in
    every step: step p50, launch counts (#1t and #2 twice a step, #1 only
    in validation). (c) ``demo.run_demo`` and ``create_sample_data`` on the
    card. Returns the launches of (b)."""
    rcfg = copy.deepcopy(cfg)
    L, B = rcfg.data.max_trace_len, rcfg.train.batch_size
    gen_times = []
    real_gen = synthetic.generate_rooms_and_traces

    def timed_gen(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_gen(*a, **kw)
        torch.cuda.synchronize()
        gen_times.append({"rooms": a[1], "human": kw["human"],
                          "ticks": kw["sim_steps"],
                          "s": time.perf_counter() - t0})
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(synthetic, "generate_rooms_and_traces",
                           timed_gen):
        tr, va = make_synthetic_datasets(rcfg, RECIPE_ROOMS, RECIPE_SEED,
                                         mode="mixed", device=dev)
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    walks = tr.n_base + va.n_base
    assert tr.n_base == RECIPE_ROOMS and va.n_base == RECIPE_ROOMS // 8
    assert tr.raw.shape[1:] == (L, 4) and np.isfinite(tr.raw).all()
    checked = check_walks(tr, "train") + check_walks(va, "val")
    log("recipe", f"generated {tr.n_base} train + {va.n_base} val rooms "
        f"(mixed, seed {RECIPE_SEED}, L={L}, {rcfg.data.max_colliders} "
        f"colliders) in {gen_s:.3f} s = {walks / gen_s:.1f} walks/s; peak "
        f"device memory {peak_gb:.3f} GB; per call " + json.dumps(
            [{**g, "walks_per_s": g["rooms"] / g["s"]} for g in gen_times])
        + f"; invariants held on all {checked} walks; on {smi}")
    t0 = time.perf_counter()
    ctr, _ = make_synthetic_datasets(rcfg, 2 * RECIPE_CPU_ROOMS, RECIPE_SEED,
                                     mode="mixed", device="cpu")
    cpu_s = time.perf_counter() - t0
    half, k = RECIPE_ROOMS // 2, RECIPE_CPU_ROOMS
    idx = np.r_[0:k, half:half + k]
    assert (tr.labels[idx] == ctr.labels).all()
    assert (tr.valid[idx] == ctr.valid).all()
    box_err = float(np.abs(tr.boxes[idx] - ctr.boxes).max())
    assert box_err <= 1e-5, box_err
    trace_err = np.abs(tr.raw[idx] - ctr.raw).reshape(2 * k, -1).max(1)
    log("recipe", f"the first {k} rooms of each half card vs CPU (CPU "
        f"{cpu_s:.1f} s): labels and valid equal, boxes max abs diff "
        f"{box_err:.3e} (tol 1e-5); traces within 1e-3: "
        f"{(trace_err <= 1e-3).mean():.4f} of {2 * k} (max abs diff "
        f"{trace_err.max():.3e}, median {np.median(trace_err):.3e})")

    with tempfile.TemporaryDirectory() as tmp:
        real_dir, _ = make_rooms(Path(tmp) / "real", RECIPE_REAL_ROOMS,
                                 seed + 40)
        real = TraceColliderArrays(real_dir, rcfg.data, augment=True,
                                   verbose=False)
        mixed = TraceColliderArrays.concat([tr, real],
                                           [1, RECIPE_MIX_COPIES])
        assert mixed.n_base == tr.n_base + real.n_base * RECIPE_MIX_COPIES
        rcfg.train.num_epochs = 1
        rcfg.train.save_dir = str(Path(tmp) / "ckpt")
        steps = mixed.num_batches(B)
        val_batches = va.num_batches(B)
        step_ms, levels = [], []
        make_step, precision = driver_mod.make_train_step, \
            loop.matmul_precision

        def timed_make(*a, **kw):
            step = make_step(*a, **kw)

            def timed(batch, gen):
                t = time.perf_counter()
                out = step(batch, gen)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                return out
            return timed

        def recorder(into):
            @contextlib.contextmanager
            def seen(level, device):
                with precision(level, device):
                    into.append((level,
                                 torch.backends.cuda.matmul.allow_tf32))
                    yield
            return seen

        val_levels = []
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(driver_mod, "make_train_step", timed_make), \
                mock.patch.object(loop, "matmul_precision",
                                  recorder(levels)), \
                mock.patch.object(driver_mod, "matmul_precision",
                                  recorder(val_levels)):
            res = train_benchmark(rcfg, device=dev, verbose=False,
                                  train_ds=mixed, val_ds=va,
                                  checkpoint_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
    layers = rcfg.model.lstm_layers
    assert launched == expected_counts(
        bilstm_fwd=layers * val_batches, bilstm_fwd_train=layers * steps,
        bilstm_bwd=layers * steps), launched
    assert levels == [(rcfg.train.matmul_precision, True)] * steps, \
        levels[:3]
    # the epoch's validation too runs at the run's precision
    assert val_levels == [(rcfg.train.matmul_precision, True)], val_levels
    assert not torch.backends.cuda.matmul.allow_tf32
    row = res["history"][0]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    log("recipe", f"one epoch of {mixed.num_samples} samples ({tr.n_base} "
        f"generated + {real.n_base} captures x {RECIPE_MIX_COPIES}, x "
        f"{len(mixed.rotation_angles)} rotations), B={B} N={L}, "
        f"train.matmul_precision={rcfg.train.matmul_precision!r} (TF32 on in "
        f"all {steps} steps and the validation): {wall:.1f} s; step p50 "
        f"{np.percentile(step_ms, 50):.3f} ms (p50 after 5: "
        f"{np.percentile(step_ms[5:], 50):.3f}, p99 "
        f"{np.percentile(step_ms, 99):.3f}, mean {np.mean(step_ms):.3f}); "
        f"{val_batches} validation batches; train_loss "
        f"{row['train_loss']:.4f} val_loss {row['val_loss']:.4f} mIoU "
        f"{row['mIoU']:.4f}; launches {launched} on {smi}")

    t0 = time.perf_counter()
    results = demo.run_demo(DEMO_ROOMS, 3000, seed, device=dev,
                            verbose=False)
    demo_s = time.perf_counter() - t0
    assert [r["room"] for r in results] == list(range(DEMO_ROOMS))
    n_obj = [len(r["objects"]) for r in results]
    assert sum(n_obj) > 0, n_obj
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        create_sample_data(Path(tmp), n_traces=SAMPLE_TRACES, seed=seed,
                           device=dev)
        sample_s = time.perf_counter() - t0
        legacy = LegacyArrays(tmp)
        assert len(list(Path(tmp).glob("*.csv"))) == SAMPLE_TRACES
        assert np.isfinite(legacy.traces).all()
    log("recipe", f"demo: {DEMO_ROOMS} rooms of 3000 ticks and the "
        f"occupancy baseline on the card in {demo_s:.2f} s, objects "
        f"{n_obj}; create_sample_data: {SAMPLE_TRACES} legacy CSV rooms in "
        f"{sample_s:.2f} s, {legacy.num_samples} windows")
    return launched


# ---------------------------------------------------------------------------
# Phase 39: the transformer family
# ---------------------------------------------------------------------------


def transformer_config(**model):
    """The default config's model as the transformer (ModelConfig's
    defaults are the reference's training config) at the flagship's B=20,
    N=1500 and the config's ``bfloat16`` matmul precision."""
    cfg = ExperimentConfig()
    cfg.model.model_type = "transformer"
    for k, v in model.items():
        setattr(cfg.model, k, v)
    cfg.train.batch_size, cfg.data.max_trace_len = TRAIN[:2]
    return cfg


def matched_diff(got, ref):
    """Card vs CPU answers, each card collider paired one to one with the
    CPU's collider of its label closest in value (confidence, center,
    size): the largest abs difference over the pairs and how many pairs
    sit at another rank. Two colliders whose confidences differ by less
    than the card-vs-CPU rounding may rank either way; the pairing holds
    their confidences to the same tolerance as every other value."""
    assert len(got) == len(ref), (len(got), len(ref))
    left = list(range(len(ref)))
    worst, moved = 0.0, 0
    for i, a in enumerate(got):
        va = np.asarray(collider_values(a))
        same = [j for j in left if ref[j]["label"] == a["label"]]
        assert same, (i, a["label"])
        j = min(same, key=lambda j: np.abs(
            va - collider_values(ref[j])).max())
        worst = max(worst, float(np.abs(va - collider_values(ref[j])).max()))
        moved += j != i
        left.remove(j)
    return worst, moved


def serve_timed(model, predict, cpu_predict, files, window, warmup, smi,
                tag, **launched):
    """Phase 7's protocol on ``predict`` (of ``model``, on the card): each
    request of ``files`` on the card against ``cpu_predict`` (the answers
    paired by ``matched_diff``: labels equal, values within
    ``MODEL_TOL``) with the kernel launches ``launched`` per request, then
    ``window`` requests of ``files[0]`` after ``warmup``, each split into
    load / prepare / run / finish on the host clock. Returns the card's
    answers."""
    predict(formats.load_trace_json(files[0]))          # warm-up
    reset_counts()
    answers, errs, moved = [], [], []
    for f in files:
        arr = formats.load_trace_json(f)
        answers.append(predict(arr))
        ref = cpu_predict(arr)
        err, n = matched_diff(answers[-1], ref)
        if err > MODEL_TOL:
            log(tag, f"{f.name}: card {answers[-1]} CPU {ref}")
        errs.append(err)
        moved.append(n)
    torch.cuda.synchronize()
    want = {k: v * len(files) for k, v in launched.items()}
    assert counts() == expected_counts(**want), counts()
    assert max(errs) <= MODEL_TOL and min(map(len, answers)) > 0, errs
    log(tag, f"{len(files)} requests card vs CPU: colliders "
        f"{[len(a) for a in answers]}, labels equal, max abs diff "
        f"{max(errs):.3e} (tol {MODEL_TOL:.0e}), colliders at another rank "
        f"{moved}; launches {want}")
    if not window:
        return answers
    stages = ("load", "prepare", "run", "finish")
    for _ in range(warmup):
        predict(formats.load_trace_json(files[0]))
    ms = np.zeros((window, len(stages)))
    for i in range(window):
        t = [time.perf_counter()]
        arr = formats.load_trace_json(files[0])
        t.append(time.perf_counter())
        x, m = predict.prepare(arr)
        t.append(time.perf_counter())
        stacked = predict.run(x, m)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        predict.finish(stacked)
        t.append(time.perf_counter())
        ms[i] = np.diff(t) * 1e3
    req = ms.sum(1)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, m), 50)
    run_ms = cuda_ms(lambda: predict.run(x, m), 50)
    log(tag, f"{window} requests of {len(formats.load_trace_json(files[0]))}"
        f" points (N={x.shape[1]}) after {warmup} warm-up: p50 "
        f"{np.percentile(req, 50):.3f} ms, p99 {np.percentile(req, 99):.3f}"
        f" ms, mean {req.mean():.3f}; mean "
        + ", ".join(f"{k} {v:.3f}" for k, v in zip(stages, ms.mean(0)))
        + f" ms; device (CUDA events): forward {fwd_ms:.3f} ms, run "
        f"{run_ms:.3f} ms on {smi}")
    return answers


def serve_transformer(model, cfg, dev, seed, smi, window, warmup, tmp):
    """Phase 39a: the seeded transformer served at full length (3000-point
    walks, 1500 after downsampling), card vs CPU, then timed; no kernel
    launches."""
    kw = dict(max_trace_len=cfg.data.max_trace_len, confidence_threshold=0.0,
              nms_threshold=0.3, verbose=False)
    files = []
    for i in range(TRANSFORMER_REQUESTS):
        files.append(tmp / f"request_{i}.json")
        formats.save_trace_json(
            files[-1], walk(2 * cfg.data.max_trace_len, seed + 300 + i))
    serve_timed(model, build_predictor(model, device=dev, **kw),
                build_predictor(copy.deepcopy(model).cpu(), device="cpu",
                                **kw),
                files, window, warmup, smi, "transformer_serve")
    return files


def reference_checkpoints(dev, seed, smi, tmp, files):
    """Phase 39d: reference-named ``.pth`` files (tests/torch_pth_cases.py)
    of the transformer and the lstm at the loader's defaults, each loaded
    through ``load_model_for_inference`` on the card and on the CPU and
    serving ``files`` card vs CPU; #1's launches and route asserted for
    the lstm. Returns the #1 launches per lstm width and the paths."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_pth_cases import write_reference_pth
    launched, paths = {}, {}
    for model_type, d_model in PTH_MODELS:
        name = f"{model_type}_{d_model}"
        mcfg = copy.deepcopy(ExperimentConfig().model)
        mcfg.model_type, mcfg.d_model = model_type, d_model
        params = random_params(build_model(mcfg), seed)
        sharpen(params)
        # Random weights also give near-uniform class probabilities: the
        # reference lstm (no objectness head) then ranks its queries by
        # confidences within 1e-7 of each other, and NMS keeps one of two
        # overlapping equals by rounding (one of 35 colliders moved by
        # 0.2 m on an NVIDIA H100 80GB HBM3, 700.00 W). A class head ten
        # times larger spreads the confidences.
        head = params["params"]["decoder"]["class_head"]
        head["kernel"] = (head["kernel"] * 10.0).astype(np.float32)
        paths[name] = tmp / f"reference_{name}.pth"
        write_reference_pth(paths[name], params, {
            "model_type": model_type, "d_model": d_model,
            "num_queries": mcfg.num_queries})
        model, cfg = load_model_for_inference(str(paths[name]), device=dev)
        cpu_model, _ = load_model_for_inference(str(paths[name]),
                                                device="cpu")
        assert (cfg.model.model_type, cfg.model.d_model) == (model_type,
                                                              d_model)
        kw = dict(max_trace_len=cfg.data.max_trace_len,
                  confidence_threshold=0.0, nms_threshold=0.3,
                  verbose=False)
        lstm = model_type == "lstm"
        per_request = {"bilstm_fwd": cfg.model.lstm_layers} if lstm else {}
        serve_timed(model, build_predictor(model, device=dev, **kw),
                    build_predictor(cpu_model, device="cpu", **kw),
                    files[:PTH_REQUESTS], 0, 0, smi, f"pth_{name}",
                    **per_request)
        launched[name] = counts()["bilstm_fwd"]
        if lstm:
            last = rnn_cuda.bilstm_fwd_cuda.last_launch
            assert last["kernel"] == PTH_ROUTE[d_model], last
            log(f"pth_{name}", f"#1 at H={d_model // 2}: "
                f"{plan_text(rnn_cuda.bilstm_fwd_cuda)}")
    return launched, paths


def attention_yardstick(dev, seed, smi):
    """Phase 39e: one encoder self-attention forward + backward at (b)'s
    shape (B=20, N=1500, d_model 128, 4 heads, a ragged boolean mask, no
    dropout): the port's plain attention against the same projections
    around ``F.scaled_dot_product_attention`` (never called by the port),
    values and gradients compared at IEEE float32, then both timed on CUDA
    events at IEEE float32 and at the config's TF32, with peak memory."""
    B, N = TRAIN[:2]
    D, H = 128, 4
    g = torch.Generator(dev).manual_seed(seed)
    mha = MultiHeadAttention(D, H).to(dev)
    x = torch.randn(B, N, D, device=dev, generator=g)
    dy = torch.randn(B, N, D, device=dev, generator=g)
    lengths = torch.randint(N // 2, N + 1, (B,), device=dev, generator=g)
    lengths[0] = N
    mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]

    def library(xr):
        def split(t):
            return t.view(B, N, H, D // H).transpose(1, 2)

        q, k, v = (split(getattr(mha, f"{n}_proj")(xr)) for n in "qkv")
        o = F.scaled_dot_product_attention(q, k, v,
                                           attn_mask=mask[:, None, None, :])
        return mha.out_proj(o.transpose(1, 2).reshape(B, N, D))

    def plain(xr):
        return mha(xr, xr, xr, key_padding_mask=mask)

    names = ["out", "dx", *(n for n, _ in mha.named_parameters())]

    def fwd_bwd(fn):
        xr = x.detach().requires_grad_(True)
        out = fn(xr)
        return (out, *torch.autograd.grad(out, [xr, *mha.parameters()], dy))

    got, ref = fwd_bwd(library), fwd_bwd(plain)
    # k_proj's bias shifts a softmax row evenly: its gradient is 0 up to
    # rounding, held to the largest gradient instead
    top = max(b.abs().max().item() for b in ref[1:])
    err = max((a - b).abs().max().item()
              / (top if n == "k_proj.bias" else b.abs().max().item())
              for n, a, b in zip(names, got, ref))
    assert err <= GRAD_REL, err
    row = {"shape": [B, N, D, H], "max_rel_err": err}
    for level in ("float32", "bfloat16"):
        with loop.matmul_precision(level, dev):
            for name, fn in (("plain", plain), ("sdpa", library)):
                torch.cuda.reset_peak_memory_stats()
                row[f"{name}_ms_{level}"] = cuda_ms(lambda: fwd_bwd(fn),
                                                    ATTN_ITERS)
                row[f"{name}_peak_gb_{level}"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
    row["plain_over_sdpa_bfloat16"] = (row["plain_ms_bfloat16"]
                                       / row["sdpa_ms_bfloat16"])
    log("attention", json.dumps(row) + "  (sdpa: F.scaled_dot_product_"
        "attention with the boolean mask, the same projections; values and "
        f"grads max-rel vs plain, tol {GRAD_REL:.0e}) on {smi}")
    return row


def parity_path(ckpts, dev, seed, smi, tmp):
    """Phase 39f: ``tools.parity.score_checkpoint`` on 16 ``make_rooms``
    traces for each checkpoint of ``ckpts``, on the card against the CPU:
    the metric sums' mIoU, precision, recall, F1 and class accuracy within
    1e-3, mAP equal where the kept detections are; no kernel launches."""
    rooms, _ = make_rooms(tmp / "parity", PARITY_ROOMS, seed + 50)
    n = len(list(rooms.glob("*_trace.json")))
    kept = []

    def rows(*args, **kwargs):       # the detections each score kept
        out = benchmark_rows(*args, **kwargs)
        kept.append([(r[1], r[3]) for r in out[1]])
        return out

    for name, ck in ckpts.items():
        kept.clear()
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(parity_tool, "benchmark_rows", rows):
            got = parity_tool.score_checkpoint(str(ck), str(rooms),
                                               device=dev, **PARITY_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert counts() == expected_counts(), counts()
            want = parity_tool.score_checkpoint(str(ck), str(rooms),
                                                device="cpu", **PARITY_KW)
        diffs = {k: abs(got[k] - want[k])
                 for k in ("mIoU", "precision", "recall", "f1", "cls_acc")}
        assert max(diffs.values()) <= 1e-3, diffs
        same = kept[0] == kept[1]
        if same:
            assert abs(got["mAP"] - want["mAP"]) <= 1e-6, (got["mAP"],
                                                          want["mAP"])
        log("parity", f"score_checkpoint {name} on {n} traces in "
            f"{wall:.1f} s: " + json.dumps(
                {k: v for k, v in got.items() if k != "AP_per_class"})
            + " vs the CPU: " + " ".join(f"{k} {v:.2e}"
                                         for k, v in diffs.items())
            + f" (tol 1e-3); kept sets equal: {same} ({len(kept[0])} / "
            f"{len(kept[1])}); mAP card {got['mAP']} CPU {want['mAP']} "
            f"on {smi}")


def transformer_path(dev, seed, smi, window, warmup):
    """Phase 39: the transformer family on the card (a-f). Returns the #1
    launches of the reference lstm checkpoints' serving."""
    cfg = transformer_config()
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = serve_transformer(model, cfg, dev, seed, smi, window, warmup,
                                  tmp)
        train_dir, _ = make_rooms(tmp / "rooms", TRANSFORMER_ROOMS,
                                  seed + 40)
        time_steps(cfg, train_dir, dev, seed, smi, {}, [TRAIN[:2]],
                   TRANSFORMER_STEPS, TRANSFORMER_WARMUP, "transformer")
        step_parity(cfg, train_dir, dev, seed, tag="transformer_step")
        moe = transformer_config(moe_experts=MOE_EXPERTS)
        l_gpu, l_cpu = step_parity(moe, train_dir, dev, seed, tag="moe_step")
        rel = abs(l_gpu["moe_aux"] - l_cpu["moe_aux"]) / l_cpu["moe_aux"]
        assert rel <= LOSS_RTOL, rel
        log("moe_step", f"moe_experts={MOE_EXPERTS}: moe_aux card "
            f"{l_gpu['moe_aux']:.6f} CPU {l_cpu['moe_aux']:.6f} (rel "
            f"{rel:.3e}, tol {LOSS_RTOL:.0e}), total_loss card "
            f"{l_gpu['total_loss']:.6f} CPU {l_cpu['total_loss']:.6f}")
        time_steps(moe, train_dir, dev, seed, smi, {}, [TRAIN[:2]],
                   MOE_STEPS, MOE_WARMUP, "transformer")
        launched, pths = reference_checkpoints(dev, seed, smi, tmp, files)
        attention_yardstick(dev, seed, smi)
        ours = tmp / "transformer_checkpoint"
        ckpt_lib.save_checkpoint(ours, model.state_dict(), config=cfg,
                                 model=model)
        parity_path({"reference_transformer_128": pths["transformer_128"],
                     "port_transformer": ours}, dev, seed, smi, tmp)
    return launched


MATCH_FORMS = {"fast": hungarian.hungarian_match_fast,
               "square": hungarian.hungarian_match}


def match_inputs(B, Q, M, share, ints, dev, seed):
    """A seeded match cost ``[B, Q, M]`` (normal, or integers 0-2: ties
    everywhere) and valid mask, item 0 with no valid column."""
    g = np.random.default_rng(seed)
    cost = (g.integers(0, 3, (B, Q, M)) if ints
            else g.normal(size=(B, Q, M))).astype(np.float32)
    valid = g.uniform(size=(B, M)) < share
    valid[0] = False
    return torch.tensor(cost, device=dev), torch.tensor(valid, device=dev)


def host_match(cost, valid):
    """The matcher the kernel replaced, kept here as its yardstick: the
    batch's cost copied to the host, scipy on each item's first
    ``min(M, Q)`` valid columns (``hungarian_match_fast``'s contract), the
    assignment copied back."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().float().cpu().numpy()
    v = valid.cpu().numpy()
    B, Q, M = c.shape
    rows = np.zeros((B, M), np.int64)
    matched = np.zeros((B, M), bool)
    for b in range(B):
        sel = np.flatnonzero(v[b])[:min(M, Q)]
        if len(sel):
            gt, pred = linear_sum_assignment(c[b][:, sel].T)
            rows[b, sel[gt]] = pred
            matched[b, sel[gt]] = True
    return (torch.from_numpy(rows).to(cost.device),
            torch.from_numpy(matched).to(cost.device))


def scipy_totals(cost, valid):
    """Each item's optimal total over its valid columns (scipy, float64)."""
    from scipy.optimize import linear_sum_assignment

    out = []
    for c, v in zip(cost.double().numpy(), valid.numpy()):
        sub = c[:, np.flatnonzero(v)]
        r, k = linear_sum_assignment(sub)
        out.append(sub[r, k].sum())
    return torch.tensor(out, dtype=torch.float64)


def hungarian_phase(dev, seed, smi):
    """Phase 43: both matcher forms at ``MATCH_CASES`` on float and tie
    costs, the kernel (one launch a call) against the plain version on the
    CPU, bit for bit, and against scipy's optimum; the kernel's time beside
    the plain version's on the card and the host path's. Returns the
    flagship case's row for the kernels line."""
    rows, worst = {}, 0
    for name, form, B, Q, M, share in MATCH_CASES:
        fn = MATCH_FORMS[form]
        for ints in (False, True):
            cost, valid = match_inputs(B, Q, M, share, ints, dev, seed)
            before = hungarian.hungarian_cuda.launches
            got = fn(cost, valid)
            torch.cuda.synchronize()
            assert hungarian.hungarian_cuda.launches == before + 1
            c_cpu, v_cpu = cost.cpu(), valid.cpu()
            ref = fn(c_cpu, v_cpu)
            assert torch.equal(got[0].cpu(), ref[0]), (name, ints)
            assert torch.equal(got[1].cpu(), ref[1]), (name, ints)
            assert not got[1][0].any(), name
            worst = max(worst, int((got[0].cpu() - ref[0]).abs().max()))
            # the optimum over the valid columns (the fast form: where
            # every one is kept)
            keep = (torch.ones(B, dtype=torch.bool) if form == "square"
                    else v_cpu.sum(1) <= Q)
            total = assignment_cost(c_cpu, ref[0], ref[1])[keep]
            opt = scipy_totals(c_cpu[keep], v_cpu[keep])
            gap = ((total - opt).abs() / opt.abs().clamp_min(1.0)).max()
            assert float(gap) <= MATCH_TOTAL_RTOL, (name, ints, float(gap))
        # timing on the float costs
        cost, valid = match_inputs(B, Q, M, share, False, dev, seed)
        if form == "fast":
            _, _, sub, n_rows = hungarian.fast_problem(cost, valid)
        else:
            sub, n_rows = hungarian.square_problem(cost, valid), None
        n, m = sub.shape[1:]
        kernel_ms = cuda_ms(lambda: hungarian.hungarian_cuda(sub, n_rows),
                            MATCH_ITERS)
        match_ms = cuda_ms(lambda: fn(cost, valid), MATCH_ITERS)
        plain_ms = np.mean([timed_host(lambda: hungarian.assign_plain(
            sub, n_rows)) for _ in range(MATCH_HOST_ITERS)])
        host_ms = np.mean([timed_host(lambda: host_match(cost, valid))
                           for _ in range(MATCH_HOST_ITERS)])
        inserted = B * n if n_rows is None else int(n_rows.sum())
        nbytes = B * (n * m * 4 + 4 + (n + m) * 4)
        bnd, by = bound(nbytes, 4.0 * inserted * m)
        rows[name] = {"form": form, "shape": [B, Q, M], "problem": [B, n, m],
                      "inserted_rows": inserted, "err": worst,
                      "kernel_ms": kernel_ms, "match_ms": match_ms,
                      "plain_ms": float(plain_ms), "host_ms": float(host_ms),
                      "bound_us": bnd * 1e3, "bound_by": by,
                      "library_ms": None}
        log("matcher", f"{name}: " + json.dumps(rows[name]) + f" on {smi} "
            "(kernel_ms: the kernel alone, CUDA events over "
            f"{MATCH_ITERS} calls; match_ms: the whole {form} matcher; "
            "plain_ms: assign_plain on the card, host clock; host_ms: the "
            "host path it replaced: copy, scipy per item, copy back)")
    return rows


def timed_host(fn) -> float:
    """Host ms of one call of ``fn``, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def fused_run_phase(cfg, dev, seed, smi):
    """Phase 44: ``train_benchmark_fused`` and ``train_benchmark`` on the
    flagship, one seed and one set of rooms: histories, best epochs,
    launch counts and wall times, the per-epoch driver on the fused run's
    AdamW (capturable), then on its own default AdamW (the distance
    printed); then the flagship's train step (a
    host-bound one) with AdamW ``capturable`` (a device learning rate and
    step count, the fused run's) and without (a float learning
    rate, the host's step count), p50 over ``ADAMW_STEPS`` after
    ``ADAMW_WARMUP`` in turns on, off, off, on. Returns the matcher's
    launches in the fused run, the two wall times and the step p50s."""
    c = copy.deepcopy(cfg)
    c.train.num_epochs = EPOCHS
    # the fused run applies the plateau rule whatever the config says (the
    # flagship's is cosine), as the JAX package's: the per-epoch driver
    # takes the same rule here
    c.train.lr_schedule = "plateau"
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, val_dir = make_rooms(Path(tmp) / "rooms", ROOMS, seed)
        c.data.data_dir, c.data.val_dir = str(train_dir), str(val_dir)
        train_ds = TraceColliderArrays(train_dir, c.data, augment=True,
                                       verbose=False)
        val_ds = TraceColliderArrays(val_dir, c.data, augment=False,
                                     verbose=False)
        steps = EPOCHS * train_ds.num_batches(c.train.batch_size)
        val_batches = EPOCHS * val_ds.num_batches(c.train.batch_size)
        # the per-epoch driver on the fused run's AdamW (capturable), so
        # that the two runs differ in their drivers only; then on its own
        # default AdamW (the step size rounded on the host: its distance is
        # printed, not held)
        per_epoch_opt = mock.patch.object(
            driver_mod, "make_optimizer",
            lambda model, cfg: loop.make_optimizer(model, cfg,
                                                   capturable=True))
        for name, fn, ctx in (
                ("fused", train_benchmark_fused, contextlib.nullcontext()),
                ("per_epoch", train_benchmark, per_epoch_opt),
                ("per_epoch_default", train_benchmark,
                 contextlib.nullcontext())):
            c.train.save_dir = str(Path(tmp) / name)
            reset_counts()
            hungarian.hungarian_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                res = fn(c, device=dev, verbose=False, train_ds=train_ds,
                         val_ds=val_ds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            layers = c.model.lstm_layers
            launched = counts()
            assert launched == expected_counts(
                bilstm_fwd=layers * val_batches,
                bilstm_fwd_train=layers * steps,
                bilstm_bwd=layers * steps), (name, launched)
            matcher = hungarian.hungarian_cuda.launches
            # one match a step; the criterion's and the metrics' a batch
            assert matcher == steps + 2 * val_batches, (name, matcher)
            logged = [json.loads(x) for x in (Path(tmp) / name /
                      "history.jsonl").read_text().splitlines()]
            runs[name] = (res, wall, matcher, [r["lr"] for r in logged])
        adamw = {"capturable": [], "host_step": []}
        for cap in (True, False, False, True):
            ms, _ = step_p50(cfg, train_dir, dev, seed, ADAMW_STEPS,
                             ADAMW_WARMUP, capturable=cap)
            adamw["capturable" if cap else "host_step"].append(ms)
    (fused, f_wall, f_match, f_lr), (plain, p_wall, _, p_lr) = \
        runs["fused"], runs["per_epoch"]

    def distance(a, b, a_lr, b_lr):
        d = {"loss_rel": 0.0, "lr_rel": 0.0, "miou_rel": 0.0,
             "counts_equal": True}
        for f, p, fl, pl in zip(a["history"], b["history"], a_lr, b_lr):
            for k in ("train_loss", "val_loss"):
                d["loss_rel"] = max(d["loss_rel"],
                                    abs(f[k] - p[k]) / abs(p[k]))
            d["lr_rel"] = max(d["lr_rel"], abs(fl - pl) / pl)
            d["miou_rel"] = max(d["miou_rel"], abs(f["mIoU"] - p["mIoU"])
                                / max(abs(p["mIoU"]), 1e-12))
            d["counts_equal"] &= all(f[k] == p[k] for k in
                                     ("tp", "fp", "fn", "cls_acc"))
        return d

    diffs = distance(fused, plain, f_lr, p_lr)
    assert diffs.pop("counts_equal"), (fused["history"], plain["history"])
    assert all(v <= FUSED_RTOL for v in diffs.values()), diffs
    vals = [r["val_loss"] for r in plain["history"]]
    assert fused["best_epoch"] == int(np.argmin(vals)), (fused, vals)
    timing = {"fused_wall_s": f_wall, "per_epoch_wall_s": p_wall,
              "epochs": EPOCHS, "steps": steps,
              "validation_batches": val_batches, "matcher_launches": f_match,
              "best_epoch": fused["best_epoch"], **diffs}
    log("fused_run", json.dumps(timing) + f" on {smi} (host clock, the "
        "fused run first; losses and learning rates within "
        f"{FUSED_RTOL} rel, tp / fp / fn / cls_acc and the best epoch "
        "equal)")
    timing["adamw_step_p50_ms"] = adamw
    default, d_wall, _, d_lr = runs["per_epoch_default"]
    timing["per_epoch_default_adamw"] = {
        "wall_s": d_wall, **distance(fused, default, f_lr, d_lr)}
    log("fused_run", "the per-epoch driver on its default AdamW (float lr, "
        "host step count) against the fused run, not held: "
        + json.dumps(timing["per_epoch_default_adamw"]) + f" on {smi}")
    log("fused_run", "flagship train step p50 (host ms, B="
        f"{cfg.train.batch_size}, N={cfg.data.max_trace_len}, over "
        f"{ADAMW_STEPS} after {ADAMW_WARMUP}, turns on, off, off, on) with "
        "AdamW capturable (device lr and step count) and with a float lr "
        f"and host step count: {json.dumps(adamw)} on {smi}")
    return timing


def row_ranges(results):
    """Each number of the runs' ``measured_ms`` and ``derived`` blocks as
    ``[min, max]`` over the runs (nested dicts kept)."""
    def span(vals):
        if isinstance(vals[0], dict):
            return {k: span([v[k] for v in vals]) for k in vals[0]}
        if any(v is None for v in vals):
            return None
        return [min(vals), max(vals)]
    return {block: span([r[block] for r in results])
            for block in ("measured_ms", "derived")}


def profiler_phase(dev, smi):
    """Phase 45: both profilers at the scale-up shape, ``PROFILE_RUNS``
    runs each (the JSON of each run under ``build/``, each row's range over
    the runs printed), and one device trace of the scale-up train step:
    the device's busy share."""
    from room_slam_torch.tools import profile_scaleup, profile_scaleup2
    from room_slam_torch.utils.profiling import device_trace

    out = REPO / "build"
    B, N = SCALEUP[:2]
    shape = ["--batch", str(B), "--seq", str(N), "--device", "cuda"]
    tools = (("profile_scaleup2", profile_scaleup2,
              ["--k", str(PROFILE_K), "--kernels"]),
             ("profile_scaleup", profile_scaleup,
              ["--reps", str(PROFILE_REPS)]))
    results = {}
    for run in range(PROFILE_RUNS):
        for name, tool, flags in tools:
            r = tool.main(shape + flags + [
                "--output", str(out / f"{name}_run{run}.json")])
            results.setdefault(name, []).append(r)
            log("profile", f"{name} run {run}: measured "
                + json.dumps(r["measured_ms"]) + " derived "
                + json.dumps(r["derived"]) + f" on {smi}")
            torch.cuda.empty_cache()
    for name, _, flags in tools:
        log("profile", f"{name} over {PROFILE_RUNS} runs ([min, max], ms; "
            f"{' '.join(flags)}): " + json.dumps(row_ranges(results[name]))
            + f" on {smi}")
    cfg = profile_scaleup.scaleup_config(B, N)
    model = build_model(cfg.model,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    step = loop.make_train_step(model, loop.make_optimizer(model, cfg), cfg)
    batch = profile_scaleup.scaleup_batch(B, N, cfg.data.max_colliders, dev)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(2):
        step(batch, gen)
    torch.cuda.synchronize()
    with device_trace(out / "trace_scaleup") as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TRACE_STEPS):
            step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_TRACE_STEPS
    busy, on_dev = device_busy_us(prof.events())
    busy_ms = busy / 1e3 / PROFILE_TRACE_STEPS
    trace = {"steps": PROFILE_TRACE_STEPS, "host_ms_a_step": wall_ms,
             "device_events": len(on_dev),
             "device_busy_ms_a_step": busy_ms if on_dev else None,
             "device_busy_share": busy_ms / wall_ms if on_dev else None}
    log("profile", "full_step device trace " + json.dumps(trace)
        + f" on {smi} (torch.profiler, the union of kernel and copy "
        "intervals over the host's step time; the profiler's own cost "
        "included)")
    del model, step, batch
    torch.cuda.empty_cache()
    return {**results, "trace": trace}


# Phase 46: the model-selection tools (tools/calibrate.py, realbench.py,
# qscore.py, diagnose_zeroshot.py) on phase 8's flagship checkpoint and
# rooms: the cached forward through #1, the post-pass sweep, the quality
# fit and the per-capture scoring, each card against CPU.


def tools_rooms(val_dir: Path, root: Path):
    """Phase 46's directories: the first ``TOOLS_ROOMS`` of phase 8's
    validation rooms, and the same rooms split in two for realbench."""
    pairs = formats.find_data_pairs(val_dir)[:TOOLS_ROOMS]
    half = (len(pairs) + 1) // 2
    out = {"all": root / "tools", "a": root / "tools_a",
           "b": root / "tools_b"}
    for i, pair in enumerate(pairs):
        for d in (out["all"], out["a" if i < half else "b"]):
            d.mkdir(parents=True, exist_ok=True)
            for f in pair:
                (d / f.name).write_bytes(f.read_bytes())
    return out


def kept_record(store):
    """``post_process`` that keeps each call's keep mask and labels (device
    tensors, read after the sweep: no synchronization in it)."""
    def wrapped(*args, **kw):
        out = post_process(*args, **kw)
        store.append((out[0], out[1]))
        return out
    return wrapped


def same_kept(a, b) -> bool:
    return all(torch.equal(ka.cpu(), kb.cpu())
               and torch.equal(la.cpu()[ka.cpu()], lb.cpu()[kb.cpu()])
               for (ka, la), (kb, lb) in zip(a, b))


def tools_sweep_grid(qs_path):
    """Phase 46 (b)'s grid: 16 cells, every axis of the sweep touched
    (refine none / 0.3 with trust, wall and furniture (v2) synthesis,
    ttopt, extent, consensus, top_k, fusion, support, physics and learned
    rescoring, soft-NMS)."""
    return dict(thresholds=[0.0, 0.3], nms_vals=[0.3],
                refine_vals=[None, 0.3], trust_vals=[0.6],
                extent_vals=[1.0], consensus_vals=[True], top_k_vals=[10],
                synth_vals=[False, True], synthf_vals=["v2"],
                ttopt_vals=[True], ttopt_params=TTOptParams(**TOOLS_TTOPT),
                fuse_vals=[True], support_vals=[0.25], pen_vals=[1.0],
                soft_vals=[None, 0.25], qscore_vals=[str(qs_path)])


def grid_keys(cell):
    """A sweep cell's operating-point keys (not its metrics)."""
    return [k for k in cell if not k.startswith(
        ("mAP", "AP_", "det_", "tp@", "num_"))]


def metric_rule(got, want, same, keys, tag):
    """(b)'s rule: each metric within ``TOOLS_TOL`` of the CPU's, equal
    (1e-6) where the kept detections are the same. Returns the largest
    difference."""
    worst = 0.0
    for k in keys:
        d = abs(got[k] - want[k])
        worst = max(worst, d)
        assert d <= (1e-6 if same else TOOLS_TOL), (tag, k, got[k], want[k])
    return worst


def tools_phase(best, val_dir, root, dev, seed, smi):
    """Phase 46, (a) to (d); returns #1's launches on each tool's card
    run."""
    dirs = tools_rooms(val_dir, root)
    apply_op = realbench_tool.apply_operating_point
    launched = {}

    # (a) the cached forward: 8 views x (the full trace + 2 windows)
    reset_counts()
    t0 = time.perf_counter()
    card = calibrate_tool._forward_val_set(str(best), str(dirs["all"]),
                                           TOOLS_BATCH, device=dev,
                                           **TOOLS_VIEWS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched["forward_val_set"] = counts()["bilstm_fwd"]
    n_batches = -(-TOOLS_ROOMS // TOOLS_BATCH)
    assert counts() == expected_counts(bilstm_fwd=2 * 8 * 3 * n_batches), \
        counts()
    t0 = time.perf_counter()
    cpu = calibrate_tool._forward_val_set(str(best), str(dirs["all"]),
                                          TOOLS_BATCH, device="cpu",
                                          **TOOLS_VIEWS)
    cpu_s = time.perf_counter() - t0
    assert card["names"] == cpu["names"] and card.keys() == cpu.keys()
    errs = {}
    for k in cpu:
        if k == "names":
            continue
        assert card[k].shape == cpu[k].shape and \
            np.isfinite(card[k]).all(), k
        if k in ("raw", "length", "gt_boxes", "gt_labels", "gt_valid"):
            assert np.array_equal(card[k], cpu[k]), k
        else:
            errs[k] = float(np.abs(card[k] - cpu[k]).max())
            assert errs[k] <= TOOLS_TOL, (k, errs[k])
    log("tools", f"_forward_val_set {TOOLS_ROOMS} rooms, batch "
        f"{TOOLS_BATCH}, {TOOLS_VIEWS}: candidates "
        f"{tuple(card['pred_boxes'].shape)}; card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s on {smi}; bilstm_fwd launches "
        f"{launched['forward_val_set']} (2 layers x 8 views x 3 variants "
        f"x {n_batches} batch); card vs CPU max abs {json.dumps(errs)} "
        f"(tol {TOOLS_TOL:.0e})")

    # (c) the quality fit on all of phase 8's validation rooms (one batch),
    # card against CPU; its weights feed (b)
    specs = [{"checkpoint": str(best), "data_dir": str(val_dir)}]
    fit_batches = -(-len(formats.find_data_pairs(val_dir)) // TOOLS_BATCH)
    fits, fit_s = {}, {}
    for d in (dev, "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        fits[d] = qscore_tool.fit(specs, tta=True, batch_size=TOOLS_BATCH,
                                  epochs=TOOLS_FIT_EPOCHS, seed=seed,
                                  iou=TOOLS_FIT_IOU, synthf="v2", device=d,
                                  log=lambda *_: None)
        if d == dev:
            torch.cuda.synchronize()
            launched["qscore_fit"] = counts()["bilstm_fwd"]
            assert counts() == expected_counts(
                bilstm_fwd=2 * 4 * fit_batches)
        fit_s[d] = time.perf_counter() - t0
    (w_card, rep_card), (w_cpu, rep_cpu) = fits[dev], fits["cpu"]
    w_err = max(float(np.abs(np.subtract(w_card[k], w_cpu[k])).max())
                for k in ("w1", "b1", "w2", "b2", "mu", "sigma"))
    assert w_err <= TOOLS_FIT_ATOL, w_err
    for k, v in rep_cpu.items():
        assert (v != v and rep_card[k] != rep_card[k]) or \
            abs(rep_card[k] - v) <= (TOOLS_TOL if "auc" in k else 0), \
            (k, rep_card[k], v)
    qs_path = root / "qscore_weights.json"
    qs_path.write_text(json.dumps(w_card))
    log("tools", f"qscore.fit {TOOLS_FIT_EPOCHS} epochs (4 views, synthf v2, "
        f"IoU {TOOLS_FIT_IOU}): card "
        f"{fit_s[dev]:.2f} s, CPU {fit_s['cpu']:.2f} s; weights "
        f"card vs CPU max abs {w_err:.2e} (tol {TOOLS_FIT_ATOL:.0e}); "
        f"report card {json.dumps(rep_card)} CPU {json.dumps(rep_cpu)}; "
        f"bilstm_fwd launches {launched['qscore_fit']}")

    # (b) the sweep on (a)'s card arrays on the card, its CPU arrays on
    # the CPU; the kept detections recorded to decide the rule
    grid = tools_sweep_grid(qs_path)
    kept, cells, wall = {}, {}, {}
    for d, cached in ((dev, card), ("cpu", cpu)):
        kept[d] = []
        with mock.patch.object(calibrate_tool, "post_process",
                               kept_record(kept[d])):
            t0 = time.perf_counter()
            cells[d] = calibrate_tool.sweep(cached, device=d, **grid)
            if d == dev:
                torch.cuda.synchronize()
            wall[d] = time.perf_counter() - t0
    n = len(cells["cpu"])
    assert n >= 16 and len(cells[dev]) == n
    per = len(kept["cpu"]) // n
    worst, n_same = 0.0, 0
    keys = ("mAP@0.5", "mAP@0.25", "det_f1@0.5", "det_f1@0.25")
    for i, (g, w) in enumerate(zip(cells[dev], cells["cpu"])):
        assert {k: g[k] for k in grid_keys(g)} == \
            {k: w[k] for k in grid_keys(w)}, (i, g, w)
        same = same_kept(kept[dev][i * per:(i + 1) * per],
                         kept["cpu"][i * per:(i + 1) * per])
        n_same += same
        worst = max(worst, metric_rule(g, w, same, keys, ("cell", i)))
        assert all(np.isfinite(g[k]) for k in keys), g
    log("tools", f"sweep {n} cells x {TOOLS_ROOMS} rooms ({per} post_process "
        f"calls a cell): card {wall[dev]:.2f} s = {n / wall[dev]:.2f} "
        f"cells/s, CPU {wall['cpu']:.2f} s = {n / wall['cpu']:.2f} cells/s"
        f" on {smi}; kept detections equal in {n_same}/{n} cells; worst "
        f"mAP / det_f1 difference {worst:.2e} (tol {TOOLS_TOL:.0e}); best "
        f"cell (card) mAP@0.25 "
        f"{max(c['mAP@0.25'] for c in cells[dev]):.4f}")

    # (d) the per-capture scoring, two directories, card against CPU, then
    # the zero-shot diagnosis on the card
    cell = {"threshold": 0.0, "nms": 0.3, "refine": 0.3, "trust": 0.6,
            "synth": True, "extent": 1.0, "consensus": False, "top_k": 10,
            "fuse": True, "ttopt": dict(TOOLS_TTOPT, auto=GATE_TAU),
            "support": None, "pen_beta": None, "soft": None,
            "synthf": "v2", "qscore": str(qs_path), "qscore_auto": GATE_TAU,
            "ycal": list(y_planes_from_colliders(str(formats.find_data_pairs(
                dirs["all"])[0][1])))}
    reports, dets, wall = {}, {}, {}
    for d in (dev, "cpu"):
        dets[d] = []

        def keep_dets(*args, _store=dets[d], **kw):
            out = apply_op(*args, **kw)
            _store.append(out)
            return out

        reset_counts()
        with mock.patch.object(realbench_tool, "apply_operating_point",
                               keep_dets):
            t0 = time.perf_counter()
            reports[d] = realbench_tool.run(
                str(best), [str(dirs["a"]), str(dirs["b"])], dict(cell),
                bootstrap=TOOLS_BOOTSTRAP, batch_size=TOOLS_BATCH,
                seed=seed, device=d)
            if d == dev:
                torch.cuda.synchronize()
                launched["realbench"] = counts()["bilstm_fwd"]
            wall[d] = time.perf_counter() - t0
    a, b = dets[dev][0], dets["cpu"][0]
    same = (np.array_equal(a["img"], b["img"])
            and np.array_equal(a["labels"], b["labels"])
            and np.abs(a["boxes"] - b["boxes"]).max(initial=0) <= TOOLS_TOL)
    got, want = reports[dev], reports["cpu"]
    assert [r["name"] for r in got["captures"]] == \
        [r["name"] for r in want["captures"]]
    assert got["per_dir"].keys() == want["per_dir"].keys() == \
        {"tools_a", "tools_b"}
    rb_worst = metric_rule(got["aggregate"], want["aggregate"], same, keys,
                           "aggregate")
    for g, w in zip(got["captures"], want["captures"]):
        rb_worst = max(rb_worst, metric_rule(g, w, same, keys, g["name"]))
    if same:
        assert got["bootstrap"] == want["bootstrap"]
    reset_counts()
    t0 = time.perf_counter()
    diag = diagnose_tool.diagnose(str(best), str(dirs["a"]), dict(cell),
                                  batch_size=TOOLS_BATCH, device=dev)
    torch.cuda.synchronize()
    diag_s = time.perf_counter() - t0
    launched["diagnose"] = counts()["bilstm_fwd"]
    assert diag["aggregate"]["all"]["n"] == sum(
        len(c["boxes"]) for c in diag["captures"]) > 0
    agg = got["aggregate"]
    log("tools", f"realbench.run 2 directories, bootstrap "
        f"{TOOLS_BOOTSTRAP}: card {wall[dev]:.2f} s, CPU {wall['cpu']:.2f} s;"
        f" detections {len(a['img'])} / {len(b['img'])}, equal {same}; "
        f"worst mAP / det_f1 difference {rb_worst:.2e}; aggregate mAP@0.25 "
        f"{agg['mAP@0.25']:.4f} det_f1@0.25 {agg['det_f1@0.25']:.4f}; "
        f"diagnose on the card {diag_s:.2f} s, "
        f"{json.dumps(diag['aggregate']['all'])}; launches "
        f"{json.dumps(launched)}")
    return launched


# phases 47-48: the serving export and the live UDP path on phase 8's best
EXPORT_TOL = 1e-5          # the exported program against predict.run: rows
EXPORT_CALLS = 20          # calls of each timed for the p50 (host clock)
LIVE_INTERVAL = 0.1        # live's refresh interval, seconds
LIVE_STREAM_S = 2.5        # the sender streams the trace over about this
LIVE_DURATION = 60.0       # live's time limit, reached only if packets drop
LIVE_IDLE_CALLS = 20       # refreshes timed at the full length, sender idle
LIVE_TOL = 1e-5            # live's final estimate against build_predictor


def same_rows(got, want, tol: float) -> float:
    """``[RQ', 9]`` rows: the keep and label columns equal, the rest within
    ``tol``; returns the max abs difference."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert torch.equal(got[:, 6:8], want[:, 6:8])
    assert got[:, 6].sum() > 0          # something is kept
    err = (got - want).abs().max().item()
    assert err <= tol, err
    return err


def operating_predictor(model, meta, dev):
    """``build_predictor`` at an export sidecar's shape and operating
    point (the live ``predict.run`` the artifact is held to)."""
    op = meta["operating_point"]
    return build_predictor(
        model, max_trace_len=meta["input"]["traces"][1],
        confidence_threshold=op["threshold"], nms_threshold=op["nms"],
        refine_clearance=op["refine"],
        refine_furniture=op["refine_furniture"], extent_slack=op["extent"],
        top_k=op["top_k"], tta_rotations=op["tta"], fuse=op["fuse"],
        device=dev, verbose=False)


def host_split(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (host activity only):
    the outermost operator calls (``aten::`` and custom ops, each counted
    once however deep it dispatches), the host ms inside them, and the
    call's wall ms (the profiler's own cost included in both); ``by_op``
    holds each operator's calls and host ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    outer = []
    for e in prof.events():
        if "::" not in e.name:
            continue
        p = e.cpu_parent
        while p is not None and "::" not in p.name:
            p = p.cpu_parent
        if p is None:
            outer.append(e)
    by_op = {}
    for e in outer:
        calls, ms = by_op.get(e.name, (0, 0.0))
        by_op[e.name] = (calls + 1, ms + e.cpu_time_total / 1e3)
    return {"ops": len(outer),
            "in_ops_ms": round(sum(ms for _, ms in by_op.values()), 3),
            "wall_ms": round(wall, 3), "by_op": by_op}


def export_cli(checkpoint, output, device, platforms):
    """``python -m room_slam_torch.tools.export`` in a process of its own
    (started, not waited for; its errors go to ``output`` + ``.err``)."""
    with open(f"{output}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "room_slam_torch.tools.export",
             "--checkpoint", str(checkpoint), "--output", str(output),
             "--device", device, "--platforms", platforms],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=err)


def export_phase(best, val_dir, root, dev, seed, smi):
    """Phase 47: ``tools/export.py`` at the JAX tool's defaults. Three
    exports run at once, each a host-bound process of its own: the flagship
    (phase 8's best: #1) on the card here through ``export_checkpoint``,
    and through the CLI the flagship on the CPU and a seeded ``bigru`` at
    the CLI's defaults (#5 on the unit kernel) on the card. Each artifact
    is loaded onto the card with ``load_exported`` and called once on the
    first validation trace (prepared by ``predict.prepare``), held to
    ``predict.run``, the counts set to 0 just before the call and read
    just after (one launch a layer, nothing else); the card export's is
    held while the CLI's processes still run. Then, all processes ended,
    the p50 of the exported call beside ``predict.run`` (alternating, for
    the two card exports) and one profiled call of each (the flagship).
    Logs the seconds of each export (the save apart for the one here), the
    artifacts' bytes and the loads. Returns the launches of the held calls
    by kernel."""
    from room_slam_torch.tools import export as export_tool

    cfg = bigru_default_config()
    model = build_model(cfg.model)
    params = random_params(model, seed)
    sharpen(params)
    load_params(model, params)
    gru_stem = root / "export_bigru" / "best_model"
    ckpt_lib.save_checkpoint(gru_stem, model.state_dict(), config=cfg,
                             model=model)
    arr = formats.load_trace_json(sorted(val_dir.glob("*_trace.json"))[0])
    cases = {"lstm": (best, "bilstm_fwd", ["cuda"]),
             "lstm_cpu": (best, "bilstm_fwd", ["cpu"]),
             "bigru": (gru_stem, "bigru_fwd", ["cuda"])}
    outs = {name: root / f"export_{name}.pt2" for name in cases}
    launched = {"bilstm_fwd": 0, "bigru_fwd": 0}
    held = {}

    def hold(name):
        """Load one artifact onto the card and hold one call of it."""
        stem, kernel, platforms = cases[name]
        meta = json.loads(outs[name].with_suffix(".json").read_text())
        assert meta["platforms"] == platforms and meta["bytes"] > 0, meta
        t0 = time.perf_counter()
        fn = export_tool.load_exported(str(outs[name]), device=dev)
        load_s = time.perf_counter() - t0
        model, mcfg = load_model_for_inference(str(stem), device=dev)
        layers = mcfg.model.lstm_layers
        predict = operating_predictor(model, meta, dev)
        x, m = predict.prepare(arr)
        reset_counts()
        served = fn(x, m)
        torch.cuda.synchronize()
        got = counts()
        assert got == expected_counts(**{kernel: layers}), got
        assert getattr(*WRAPPERS[kernel]).last_launch["kernel"] == "unit"
        launched[kernel] += layers
        err = same_rows(served, predict.run(x, m), EXPORT_TOL)
        held[name] = (fn, predict, x, m, served)
        line = (f"{name} ({mcfg.model.model_type}, d_model "
                f"{mcfg.model.d_model}, {layers} layers, exported for "
                f"{meta['platforms']}) at "
                f"{json.dumps(meta['operating_point'])}, input "
                f"{meta['input']['traces']}: artifact {meta['bytes']} bytes, "
                f"loaded onto the card in {load_s:.2f} s; {kernel} launches "
                f"{got[kernel]} a call "
                f"({plan_text(getattr(*WRAPPERS[kernel]))}); "
                f"{int(served[:, 6].sum())} kept of {served.shape[0]} rows, "
                f"max abs vs predict.run {err:.3e} (tol {EXPORT_TOL:.0e})")
        if name == "lstm_cpu":
            line += (", equal to the card export's rows: "
                     f"{torch.equal(served, held['lstm'][4])}")
        log("export", f"{line} on {smi}")

    t0 = time.perf_counter()
    procs = {"lstm_cpu": export_cli(best, outs["lstm_cpu"], "cpu", "cpu"),
             "bigru": export_cli(gru_stem, outs["bigru"], "cuda", "cuda")}
    wall = {}
    try:
        saving = []
        real_save = torch.export.save

        def timed_save(*a, **k):
            t = time.perf_counter()
            real_save(*a, **k)
            saving.append(time.perf_counter() - t)

        with mock.patch.object(torch.export, "save", timed_save):
            export_tool.export_checkpoint(str(best), str(outs["lstm"]),
                                          platforms=("cuda",), device=dev)
        wall["lstm"] = time.perf_counter() - t0
        hold("lstm")
        while len(wall) < 3:
            assert time.perf_counter() - t0 < 600, wall
            for name, proc in procs.items():
                if name not in wall and proc.poll() is not None:
                    wall[name] = time.perf_counter() - t0
                    assert proc.returncode == 0, (
                        name, Path(f"{outs[name]}.err").read_text()[-2000:])
            time.sleep(0.05)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("export", f"three exports at once: the flagship on the card here "
        f"{wall['lstm']:.2f} s (of it the save {saving[0]:.2f} s; the "
        f"first export of this process, torch.export's imports included), "
        f"the CLI's processes (interpreter start, imports, load, export, "
        f"save) ending at {wall['lstm_cpu']:.2f} s (the flagship on the "
        f"CPU) and {wall['bigru']:.2f} s (the bigru on the card), the card "
        f"export's artifact loaded and held meanwhile; "
        f"{time.perf_counter() - t0:.2f} s in all")
    hold("lstm_cpu")
    hold("bigru")

    for name in ("lstm", "bigru"):
        fn, predict, x, m, _ = held[name]
        ms = {"exported": [], "predict.run": []}
        for _ in range(EXPORT_CALLS):
            ms["exported"].append(timed_host(lambda: fn(x, m)))
            ms["predict.run"].append(timed_host(lambda: predict.run(x, m)))
        line = (f"{name}: p50 over {EXPORT_CALLS} synchronised calls each, "
                "alternating: " + ", ".join(
                    f"{k} {np.percentile(v, 50):.3f} ms (min {min(v):.3f}, "
                    f"max {max(v):.3f})" for k, v in ms.items()))
        if name == "lstm":
            split = {"exported": host_split(lambda: fn(x, m)),
                     "predict.run": host_split(lambda: predict.run(x, m))}
            a, b = (split[k].pop("by_op") for k in split)
            diff = sorted(((a.get(k, (0, 0.0))[1] - b.get(k, (0, 0.0))[1],
                            k, a.get(k, (0,))[0], b.get(k, (0,))[0])
                           for k in set(a) | set(b)), reverse=True)
            line += ("; one profiled call each (outer operator calls, host "
                     f"ms inside them, wall ms): {json.dumps(split)}; the "
                     "operators with the most extra host ms in the exported "
                     "call (ms, name, calls exported / predict.run): "
                     + json.dumps([[round(d, 3), k, ca, cb]
                                   for d, k, ca, cb in diff[:6]]))
        log("export", f"{line} on {smi}")
    return launched


def live_phase(best, val_dir, root, dev, seed, smi):
    """Phase 48: ``data/ingest.py`` ``live(device="cuda")`` on phase 8's
    best in a thread on a free 127.0.0.1 port (loopback UDP probed first),
    ``max_points`` the first validation trace's length, fed by ``replay``
    of that trace in a process of its own (``--realtime``, over about
    ``LIVE_STREAM_S``; started once live's socket is bound, so what
    arrives during the model load queues as the backlog); each refresh's
    host time recorded around the predictor ``live`` builds, and the last
    refresh's rows and ``[RQ', 9]`` result; the counts set to 0 just
    before and read just after (#1 once a layer a refresh, nothing else).
    Asserts every packet arrived, and holds the last result to
    ``build_predictor``'s on the same rows (keep and label columns equal,
    values within ``LIVE_TOL``; the estimate's colliders too). Then, the
    counts read and the sender gone, times ``LIVE_IDLE_CALLS`` refreshes
    of live's predictor on the whole trace. Returns #1's launches."""
    import socket
    import threading

    from room_slam_torch.data import ingest

    # loopback UDP on this host: a refusal fails the phase
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.sendto(b"probe", rx.getsockname())
    assert rx.recvfrom(16)[0] == b"probe"
    port = rx.getsockname()[1]
    tx.close()
    rx.close()

    trace = sorted(val_dir.glob("*_trace.json"))[0]
    arr = formats.sort_by_time(formats.load_trace_json(trace))
    n = len(arr)
    seen, last, result = [], {}, {}
    bound = threading.Event()
    real_build = predictor_mod.build_predictor
    real_bind = ingest._bind

    def signalling_bind(*a):
        sock = real_bind(*a)
        bound.set()
        return sock

    def recording_build(*a, **k):
        predict = real_build(*a, **k)

        last["predict"] = predict

        def predict_array(rows):      # = predict(rows) for rows non-empty
            t0 = time.perf_counter()
            stacked = predict.run(*predict.prepare(rows))
            out = predict.finish(stacked)   # reads the result back
            seen.append((len(rows), (time.perf_counter() - t0) * 1e3))
            last.update(rows=rows.copy(), stacked=stacked)
            return out

        return predict_array

    def runner():
        try:
            result["preds"] = ingest.live(
                str(best), host="127.0.0.1", port=port,
                interval=LIVE_INTERVAL, duration=LIVE_DURATION, max_points=n,
                output=str(root / "live.json"), threshold=0.0, device=dev)
        except BaseException as e:  # noqa: BLE001 (raised below)
            result["error"] = e
        bound.set()

    t_start = time.perf_counter()
    reset_counts()
    with mock.patch.object(predictor_mod, "build_predictor",
                           recording_build), \
            mock.patch.object(ingest, "_bind", signalling_bind):
        th = threading.Thread(target=runner)
        th.start()
        assert bound.wait(60) and "error" not in result, result
        t_sender = time.perf_counter()
        sender = subprocess.Popen(
            [sys.executable, "-m", "room_slam_torch.data.ingest", "replay",
             str(trace), "--host", "127.0.0.1", "--port", str(port),
             "--hz", f"{n / LIVE_STREAM_S:.1f}", "--realtime"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            out, err = sender.communicate(timeout=LIVE_DURATION)
            sender_s = time.perf_counter() - t_sender
        finally:
            if sender.poll() is None:
                sender.kill()
                sender.wait()
        th.join(LIVE_DURATION + 60)
    wall_s = time.perf_counter() - t_start
    assert not th.is_alive()
    if "error" in result:
        raise result["error"]
    assert sender.returncode == 0, err[-2000:]
    sent = int(out.split("Sent ")[-1].split()[0])
    launched = counts()
    layers = ckpt_lib.load_config_from_checkpoint(str(best)).model.lstm_layers
    refreshes = len(seen)
    assert refreshes > 0 and sent == n, (refreshes, sent, n)
    assert launched == expected_counts(bilstm_fwd=refreshes * layers), \
        launched
    rows = last["rows"]
    lost = n - len(rows)
    assert lost == 0, f"{lost} of {n} packets lost"
    t = arr[:, 3].astype(np.float64)
    want = np.column_stack([arr[:, :3], t - t[0]]).astype(np.float32)
    assert np.array_equal(rows, want)
    model, mcfg = load_model_for_inference(str(best), device=dev)
    ref = build_predictor(model, max_trace_len=mcfg.data.max_trace_len,
                          confidence_threshold=0.0, nms_threshold=0.3,
                          device=dev, verbose=False)
    err = same_rows(last["stacked"], ref.run(*ref.prepare(rows)), LIVE_TOL)
    got, want_preds = result["preds"], ref(rows)
    assert [c["label"] for c in got] == [c["label"] for c in want_preds]
    assert len(got) > 0
    cerr = max(np.abs(np.subtract(collider_values(a), collider_values(b))
                      ).max() for a, b in zip(got, want_preds))
    assert cerr <= LIVE_TOL, cerr
    saved = json.loads((root / "live.json").read_text())
    assert saved["metadata"]["num_colliders"] == len(got)
    idle = [timed_host(lambda: last["predict"](rows))
            for _ in range(LIVE_IDLE_CALLS)]

    def spread(ms):
        return json.dumps({q: round(float(np.percentile(ms, q)), 3)
                           for q in (0, 10, 50, 90, 100)})

    log("live", f"live(device={dev}) on 127.0.0.1:{port}, interval "
        f"{LIVE_INTERVAL} s: {sent} poses sent by replay --realtime at "
        f"{n / LIVE_STREAM_S:.1f} Hz from its own process ({sender_s:.2f} "
        f"s from its start to its exit), {len(rows)} "
        f"received ({lost} lost); {refreshes} refreshes at n from "
        f"{seen[0][0]} to {seen[-1][0]}, bilstm_fwd launches "
        f"{launched['bilstm_fwd']} = {refreshes} x {layers} layers; refresh "
        f"host ms (predict_array: prepare, run, finish) percentiles "
        f"{spread([s for _, s in seen])} over the {refreshes} while the "
        f"trace streamed, {spread(idle)} over {LIVE_IDLE_CALLS} at its full "
        f"length with the sender idle; the last refresh's "
        f"{tuple(last['stacked'].shape)} "
        f"rows against build_predictor's on the same rows: max abs "
        f"{err:.3e} (tol {LIVE_TOL:.0e}), {len(got)} colliders kept; phase "
        f"wall {wall_s:.2f} s on {smi}")
    return launched["bilstm_fwd"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=5,
                    help="mixed-size requests of the correctness check")
    ap.add_argument("--warmup", type=int, default=20,
                    help="full-length requests before the latency window")
    ap.add_argument("--window", type=int, default=200,
                    help="full-length requests timed for p50 / p99")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = resolve_device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log("device", f"{kind} count={count} torch={torch.__version__} "
                  f"cuda={torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    for res in build.build_all():
        ptxas = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "bytes stack" in ln]
        log("build", f"{res.name}: {res.seconds:.1f} s {res.path.name}"
                     + (" (reused)" if res.reused else "") + " | "
                     + " | ".join(ptxas))
        if res.name in USAGE_KERNELS:
            check_usage(res.name, build.ptxas_usage(res.log))
    log("build", f"all kernels in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parser_lib = trace_parser.build()
    trace_parser.load_library()
    assert parser_lib.parent == REPO / "build" / "native", parser_lib
    log("build", f"native trace parser (g++ {' '.join(trace_parser.GXX_FLAGS)}"
                 f") from {trace_parser.SRC.relative_to(REPO)}: "
                 f"{parser_lib.relative_to(REPO)} in "
                 f"{time.perf_counter() - t0:.1f} s")

    log("done", f"phases 1-2 in {time.perf_counter() - t_start:.1f} s")
    t_phase = time.perf_counter()

    # 3. kernel check against the plain versions on the card
    errs = {}
    for shape in LSTM_SHAPES:
        ins = kernel_inputs(*shape, dev, args.seed)
        got = rnn_cuda.bilstm_fwd_cuda(*ins)
        ref = rnn_cuda.bilstm_recurrence_plain(*ins)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        rel = err / max(b.abs().max().item() for b in ref)
        errs[shape] = err
        assert all(torch.isfinite(a).all() for a in got), shape
        assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "unit"
        log("kernel_check", f"bilstm_fwd B,N,H={shape} max_abs_err={err:.3e} "
                            f"max_rel_err={rel:.3e} tol={KERNEL_ATOL:.0e}; "
                            f"launch {plan_text(rnn_cuda.bilstm_fwd_cuda)}")
        assert err <= KERNEL_ATOL, (shape, err)
    # the wide kernel (the first design, H > 64) forced at H=64: phase 4
    # times it beside the unit kernel
    ins = kernel_inputs(*RAGGED, dev, args.seed)
    wide_err = value_err(
        rnn_cuda.bilstm_fwd_train_cuda(*ins, plan=("wide", 4)),
        rnn_cuda.bilstm_fwd_train_plain(*ins), torch.float32)
    log("kernel_check", f"bilstm_fwd_train on the wide kernel B,N,H={RAGGED}"
        f" max_abs_err={wide_err:.3e} tol={KERNEL_ATOL:.0e}")
    train_errs = check_training_kernels(dev, args.seed)

    # 4. kernel timing
    shapes = []
    for shape, iters in ((BENCH, 20), (SERVE, 10)):
        B, N, H = shape
        ins = kernel_inputs(*shape, dev, args.seed)
        kernel_ms = cuda_ms(lambda: rnn_cuda.bilstm_fwd_cuda(*ins), iters)
        plain_ms = cuda_ms(lambda: rnn_cuda.bilstm_recurrence_plain(*ins),
                           2, warmup=1)
        lib = torch.nn.LSTM(2 * H, H, batch_first=True,
                            bidirectional=True).to(dev)
        x = torch.randn(B, N, 2 * H, device=dev,
                        generator=torch.Generator(dev).manual_seed(args.seed))
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lib(x), iters)
        bound_ms, bound_by = bilstm_bound(B, N, H)
        row = {"shape": list(shape), "err": errs[shape],
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_us": bound_ms * 1e3,
               "bound_by": bound_by, "us_per_step": kernel_ms / N * 1e3,
               "library_us_per_step": library_ms / N * 1e3,
               "plans": plan_sweep(
                   "bilstm_fwd", rnn_cuda.bilstm_fwd_cuda, ins,
                   lstm_plans(B, H, dev, torch.float32, False, 2), shape,
                   iters),
               "launch": dict(rnn_cuda.bilstm_fwd_cuda.last_launch)}
        shapes.append(row)
        log("kernel_time", json.dumps(row) + "  (library_ms: cuDNN "
            "bidirectional nn.LSTM, includes the input projection)")
    train_rows = time_training_kernels(dev, args.seed, train_errs)
    log("done", f"phases 3-4 in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 5. the flagship model at full width
    cfg = ExperimentConfig.from_json(CONFIG)
    mcfg = cfg.model
    model = build_model(mcfg)
    params = random_params(model, args.seed)
    # Random weights give near-uniform attention, so every query would
    # decode the same box; a sharp attention temperature spreads the
    # queries over the walk and the answers hold several colliders.
    sharpen(params)
    load_params(model, params)
    model = model.to(dev).eval()
    g = np.random.default_rng(args.seed)
    B, N = 32, 500
    raw = np.stack([walk(N, args.seed + 1 + b) for b in range(B)])
    lengths = g.integers(N // 2, N + 1, size=B)
    lengths[0] = N
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.from_numpy(lengths).to(dev))
    with torch.inference_mode():
        before = rnn_cuda.bilstm_fwd_cuda.launches
        out = model(feats, mask)
        torch.cuda.synchronize()
        per_fwd = rnn_cuda.bilstm_fwd_cuda.launches - before
        assert per_fwd == mcfg.lstm_layers, per_fwd
        with mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain):
            ref = model(feats, mask)
        for k, v in out.items():
            assert torch.isfinite(v).all(), k
            err = (v - ref[k]).abs().max().item()
            ok = torch.allclose(v, ref[k], rtol=MODEL_TOL, atol=MODEL_TOL)
            log("model", f"{k} {tuple(v.shape)} max_abs_err_vs_plain="
                         f"{err:.3e} tol={MODEL_TOL:.0e}")
            assert ok, (k, err)
        fwd_ms = cuda_ms(lambda: model(feats, mask), 10)
    log("model", f"flagship lstm d_model={mcfg.d_model} Q={mcfg.num_queries} "
                 f"layers={mcfg.lstm_layers} refine={mcfg.refine_stages}: "
                 f"forward B={B} N={N} {fwd_ms:.3f} ms = "
                 f"{B / fwd_ms * 1e3:.1f} traces/s on {smi}; "
                 f"kernel launches per forward={per_fwd}")

    # 6. serving: a main path
    max_len = cfg.data.max_trace_len
    full = walk(2 * max_len, args.seed + 100)
    sizes = np.linspace(len(full) / args.requests, len(full),
                        args.requests).astype(int)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, n in enumerate(sizes):
            files.append(Path(tmp) / f"trace_{i}.json")
            formats.save_trace_json(files[-1], full[:n])
        predict = build_predictor(model, max_trace_len=max_len,
                                  confidence_threshold=0.0,
                                  nms_threshold=0.3, device=dev,
                                  verbose=False)
        predict(formats.load_trace_json(files[0]))        # warm-up
        reset_counts()
        answers, lat, load_ms = [], [], []
        for f in files:
            t0 = time.perf_counter()
            arr = formats.load_trace_json(f)
            t1 = time.perf_counter()
            answers.append(predict(arr))
            lat.append((time.perf_counter() - t0) * 1e3)
            load_ms.append((t1 - t0) * 1e3)
        launches = rnn_cuda.bilstm_fwd_cuda.launches
        assert launches == args.requests * mcfg.lstm_layers, launches
        assert counts()["bilstm_fwd_train"] == counts()["bilstm_bwd"] == 0
        out_json = Path(tmp) / "colliders.json"
        formats.save_predictions_json(out_json, answers[-1], 0.0, 0.3)
        back = json.loads(out_json.read_text())
        cols = back["colliders"]
        assert back["metadata"]["num_colliders"] == len(cols) > 0
        for c in cols:
            assert c["label"] in ("BLOCK", "LOW", "MID", "HIGH")
            assert np.isfinite(collider_values(c)).all()
            assert min(c["size"].values()) > 0

        cpu_predict = build_predictor(copy.deepcopy(model).cpu(),
                                      max_trace_len=max_len,
                                      confidence_threshold=0.0,
                                      nms_threshold=0.3, device="cpu",
                                      verbose=False)
        ref = cpu_predict(formats.load_trace_json(files[-1]))
    assert [c["label"] for c in ref] == [c["label"] for c in cols]
    err = max(np.abs(np.subtract(collider_values(a), collider_values(b))
                     ).max() for a, b in zip(cols, ref))
    assert err <= MODEL_TOL, err
    log("serve", f"{args.requests} requests, trace points {sizes.tolist()} "
                 f"-> {min(len(full), max_len)} max; colliders per answer "
                 f"{[len(a) for a in answers]}; kernel launches {launches}; "
                 f"card vs CPU max abs diff {err:.3e}")

    # 7. serving latency: full-length requests after warm-up, each stage
    # of predict_array (= finish(run(*prepare(arr)))) on the host clock
    stages = ("load", "prepare", "run", "finish")
    with tempfile.TemporaryDirectory() as tmp:
        f_full = Path(tmp) / "trace_full.json"
        formats.save_trace_json(f_full, full)
        for _ in range(args.warmup):
            predict(formats.load_trace_json(f_full))
        rnn_cuda.bilstm_fwd_cuda.launches = 0
        ms = np.zeros((args.window, len(stages)))
        for i in range(args.window):
            t = [time.perf_counter()]
            arr = formats.load_trace_json(f_full)
            t.append(time.perf_counter())
            x, m = predict.prepare(arr)
            t.append(time.perf_counter())
            stacked = predict.run(x, m)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            cols_i = predict.finish(stacked)
            t.append(time.perf_counter())
            ms[i] = np.diff(t) * 1e3
            assert len(cols_i) == len(answers[-1]), (i, len(cols_i))
    window_launches = rnn_cuda.bilstm_fwd_cuda.launches
    assert window_launches == args.window * mcfg.lstm_layers, window_launches
    req = ms.sum(1)
    mean = dict(zip(stages, ms.mean(0)))
    with torch.inference_mode():
        fwd1_ms = cuda_ms(lambda: model(x, m), 50)
    run_ms = cuda_ms(lambda: predict.run(x, m), 50)
    bench_row, serve_row = shapes
    bench_row["launches"] = per_fwd       # one bench-shape forward
    serve_row["launches"] = launches      # the serving path's requests
    log("serve_latency",
        f"{args.window} requests of {len(full)} points "
        f"({min(len(full), max_len)} after downsampling), after "
        f"{args.warmup} warm-up: p50 "
        f"{np.percentile(req, 50):.3f} ms, p99 {np.percentile(req, 99):.3f} "
        f"ms, mean {req.mean():.3f}, min {req.min():.3f}, max "
        f"{req.max():.3f} ms on {smi}")
    log("serve_latency",
        "mean per request (host clock): JSON load {load:.3f} ms (native "
        "parser; the Python parser's earlier run: {py:.3f} ms on NVIDIA "
        "H100 80GB HBM3, 700.00 W); prepare (featurize, pad, H2D) "
        "{prepare:.3f} ms; run (forward + post_process, launch and wait) "
        "{run:.3f} ms; finish (D2H, collider dicts) {finish:.3f} ms".format(
            py=PYTHON_PARSER_JSON_MS, **mean))
    log("serve_latency",
        f"device (CUDA events, 50 calls back to back): forward "
        f"{fwd1_ms:.3f} ms, of which bilstm_fwd {mcfg.lstm_layers} x "
        f"{serve_row['kernel_ms']:.3f} ms; run {run_ms:.3f} ms, so "
        f"post_process {run_ms - fwd1_ms:.3f} ms")

    log("done", f"phases 5-7 in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 8-11. training: the main path, its checkpoint served, card vs CPU
    # parity of one step, step timing
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, val_dir = make_rooms(Path(tmp) / "rooms", ROOMS,
                                        args.seed)
        trained, best, first = train_main_path(
            cfg, train_dir, val_dir, Path(tmp) / "ckpt", EPOCHS, dev, smi)
        resume_path(cfg, train_dir, val_dir, Path(tmp) / "ckpt", EPOCHS, dev,
                    first)
        evaluated = evaluate_path(best, val_dir, dev)
        evaluate_path(best, val_dir, dev, refine=0.3, refine_furniture=True,
                      extent_slack=1.0)
        serve_checkpoint(best, sorted(val_dir.glob("*_trace.json"))[0], dev)
        step_parity(cfg, train_dir, dev, args.seed)
        precision_check(cfg, train_dir, dev, args.seed, smi)
        time_steps(cfg, train_dir, dev, args.seed, smi, train_rows,
                   STEP_SHAPES, STEPS, STEP_WARMUP, "bilstm")
        log("done", f"phases 8-11 in {time.perf_counter() - t_phase:.1f} s")

        # 46. the model-selection tools on phase 8's checkpoint and rooms
        # (a main path: the cached forward through #1), card against CPU
        t_phase = time.perf_counter()
        tools_launched = tools_phase(best, val_dir, Path(tmp), dev,
                                     args.seed, smi)
        log("done", f"phase 46 in {time.perf_counter() - t_phase:.1f} s")

        # 47-48. the serving export (main paths: #1 and #5 inside exported
        # programs) and the live UDP path (#1 on every refresh) on phase 8's
        # checkpoint and rooms
        t_phase = time.perf_counter()
        export_launched = export_phase(best, val_dir, Path(tmp), dev,
                                       args.seed, smi)
        live_launched = live_phase(best, val_dir, Path(tmp), dev, args.seed,
                                   smi)
        log("done", f"phases 47-48 in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 12-17. the scale-up bigru: kernel checks and timing, training (a
    # main path), its checkpoint served (a main path), kernels vs plain
    # versions in one step, step timing
    gru_errs = check_gru_kernels(dev, args.seed)
    gru_rows = time_gru_kernels(dev, args.seed, gru_errs)
    time_hidden_grads(dev, args.seed)
    up = scaleup_config()
    with tempfile.TemporaryDirectory() as tmp:
        rooms = Path(tmp) / "rooms"
        t0 = time.perf_counter()
        write_rooms(rooms / "train", SCALEUP_TRAIN_ROOMS, args.seed + 10,
                    points=SCALEUP_POINTS)
        write_rooms(rooms / "val", SCALEUP_VAL_ROOMS, args.seed + 11,
                    points=SCALEUP_POINTS)
        log("train_scaleup", f"wrote {SCALEUP_TRAIN_ROOMS} + "
                             f"{SCALEUP_VAL_ROOMS} rooms of {SCALEUP_POINTS} "
                             f"points in {time.perf_counter() - t0:.1f} s")
        gru_trained, gru_best, _ = train_main_path(
            up, rooms / "train", rooms / "val", Path(tmp) / "ckpt", 1, dev,
            smi, prefix="bigru")
        log("train_scaleup", "last launches: bigru_fwd_train "
            f"{plan_text(gru_cuda.bigru_fwd_train_cuda)}; bigru_bwd "
            f"{plan_text(gru_cuda.bigru_bwd_cuda)}")
        gru_served = serve_scaleup(gru_best, dev, args.seed)
        step_parity_scaleup(up, rooms / "train", dev, args.seed)
        time_steps(up, rooms / "train", dev, args.seed, smi,
                   {k: [v] for k, v in gru_rows.items()}, [SCALEUP[:2]],
                   SCALEUP_STEPS, SCALEUP_WARMUP, "bigru")

    log("done", f"phases 12-17 in {time.perf_counter() - t_phase:.1f} s")

    # 18-24. the single-direction kernels and the legacy GRU surface:
    # kernel checks and timing, training and evaluation (main paths), one
    # step card vs CPU, step timing, then the ops-level LSTM path
    t_single = time.perf_counter()
    single_errs = check_single_kernels(dev, args.seed)
    single_rows = time_single_kernels(dev, args.seed, single_errs)
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "legacy"
        t0 = time.perf_counter()
        write_legacy_rooms(data, LEGACY_ROOMS, args.seed + 20,
                           points=LEGACY_POINTS)
        log("train_legacy", f"wrote {LEGACY_ROOMS} legacy rooms of "
                            f"{LEGACY_POINTS} points in "
                            f"{time.perf_counter() - t0:.1f} s")
        legacy_trained, legacy_best = train_legacy_path(
            data, Path(tmp) / "ckpt", dev, args.seed, smi)
        legacy_evaluated = evaluate_legacy_path(legacy_best, data, dev)
        legacy_step_parity(data, dev, args.seed)
        time_legacy_steps(data, dev, args.seed, smi, single_rows)
    lstm_ops_launched = lstm_ops_path(dev, args.seed)
    lstm_launched = lstm_ops_launched[torch.float32]
    log("done", f"phases 18-24 in {time.perf_counter() - t_single:.1f} s")

    # 25-30. the split BPTT (#10) and the fused layer VJP (#9) against
    # their plain versions, #9 against #6 plus cuBLAS, the bench_bigru_bwd
    # tool (#10's path), the bf16 BiLSTM kernels and the bf16 flagship
    t_new = time.perf_counter()
    split_errs, split_plain_ms, split_plans = check_split(dev, args.seed)
    check_fused(dev, args.seed)
    ab_row, fused_launched = fused_ab(dev, args.seed, smi,
                                      gru_rows["bigru_bwd"]["library_ms"])
    tool, split_launched = run_bench_tool(dev, smi, split_plans)
    split_rows = time_split_route(dev, args.seed, smi, split_errs,
                                  split_plain_ms)
    lstm_bf16_errs = check_lstm_bf16(dev, args.seed)
    lstm_bf16_rows = time_lstm_bf16(dev, args.seed, lstm_bf16_errs)
    bf16_launched = flagship_bf16_path(dev, args.seed, smi)
    for name in ("bilstm_fwd", "bilstm_fwd_train", "bilstm_bwd"):
        lstm_bf16_rows[name]["launches"] = bf16_launched[name]
    for name in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd"):
        lstm_bf16_rows[name]["launches"] = lstm_ops_launched[
            torch.bfloat16][name]
    log("done", f"phases 25-30 in {time.perf_counter() - t_new:.1f} s")

    # 31-34. the widths above the unit and wide kernels: the LSTM cluster
    # route and the GRU cluster kernels' masked slices against their plain
    # versions, their timing, and their main paths
    t_wide = time.perf_counter()
    check_lstm_cluster(dev, args.seed)
    masked = check_gru_masked(dev, args.seed)
    wide_rows = time_new_routes(dev, args.seed)
    wide_launched = wide_paths(dev, args.seed, smi)
    log("done", f"phases 31-34 (GRU masked widths of the first design, "
                f"forced: {list(masked)}) in "
                f"{time.perf_counter() - t_wide:.1f} s")

    # 35-37. the serving path's recipes on the flagship (a main path), #1
    # at the test-time view batches, the flagship with hole tokens
    t_serve = time.perf_counter()
    recipe_batches, recipe_rows = serve_recipes(model, max_len, dev,
                                                args.seed, smi)
    tta_rows = time_tta_batches(
        dev, args.seed, {B: recipe_batches.count(B) for B in
                         set(recipe_batches)})
    hole_tokens_path(cfg, dev, args.seed, smi)
    log("done", f"phases 35-37 in {time.perf_counter() - t_serve:.1f} s")

    # 38. the flagship's frozen training recipe: generated rooms (a main
    # path), the captures mixed in, one epoch at the config's precision,
    # the demo and the legacy sample data
    t_recipe = time.perf_counter()
    recipe_launched = recipe_path(cfg, dev, args.seed, smi)
    log("done", f"phase 38 in {time.perf_counter() - t_recipe:.1f} s")

    # 39. the transformer family: serving, the train step, the MoE step,
    # reference .pth checkpoints (the lstm's through #1), the attention
    # yardstick and the parity tool
    t_trans = time.perf_counter()
    pth_launched = transformer_path(dev, args.seed, smi, args.window,
                                    args.warmup)
    log("done", f"phase 39 in {time.perf_counter() - t_trans:.1f} s")

    # 40. the bigru model's defaults on the unit kernels (#5 / #5t / #6,
    # two directions, H=64 f32) and the pipe kernels (forwards and BPTTs)
    # above the cluster kernels' widths, beside the first stream designs:
    # their checks, timing and main paths
    t_40 = time.perf_counter()
    bigru_rows, bigru_bf16 = time_bigru_unit(dev, args.seed)
    bigru_launched, bigru_timing = bigru_default_path(dev, args.seed, smi)
    stream_worst = check_stream_route(dev, args.seed)
    stream_rows = time_stream_route(dev, args.seed)
    stream_launched = stream_paths(dev, args.seed, smi)
    log("done", f"phase 40 in {time.perf_counter() - t_40:.1f} s; stream "
                f"worst errors {json.dumps(stream_worst)}")

    # 41. the GRU register cluster kernels (#5 / #5t, #7 / #7t, #6, #8 at H
    # 65-256): their checks, their A/B beside the first cluster design and
    # the pipe kernels, and a bigru at d_model 512 on them (a main path)
    t_41 = time.perf_counter()
    reg_worst = check_gru_reg(dev, args.seed)
    reg_rows = time_gru_reg(dev, args.seed)
    reg_launched = reg_paths(dev, args.seed, smi)
    log("done", f"phase 41 in {time.perf_counter() - t_41:.1f} s; worst "
                f"errors (values, BPTT max-rel) {json.dumps(reg_worst)}")

    # 42. the LSTM register cluster kernels at H 65-118 (#1 / #1t, #3 / #3t,
    # #2, #4 at the wide kernels' widths): their checks, their A/B beside
    # the wide kernels, and an lstm at d_model 192 on them (a main path)
    mid_worst, mid_rows, mid_launched = lstm_mid_phase(dev, args.seed, smi)

    # 43-45. the exact matcher on the card, the fused run (a main path)
    # beside the per-epoch driver, the profilers at the scale-up shape
    t_43 = time.perf_counter()
    match_rows = hungarian_phase(dev, args.seed, smi)
    fused_timing = fused_run_phase(ExperimentConfig.from_json(CONFIG), dev,
                                   args.seed, smi)
    profiler_phase(dev, smi)
    log("done", f"phases 43-45 in {time.perf_counter() - t_43:.1f} s")

    def entry(name, source, replaces, launched, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": row["err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_us"] / 1e3,
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                **({"launch": row["launch"]} if "launch" in row else {})}

    train_row = {name: next(r for r in rows if r["shape"] == list(TRAIN))
                 for name, rows in train_rows.items()}
    kernels = [
        {**entry("bilstm_fwd", "room_slam_torch/csrc/bilstm_fwd.cu",
                 "room_slam_tpu/ops/rnn_pallas.py:390", launches, serve_row),
         "shapes": shapes},
        {**entry("bilstm_fwd_train", "room_slam_torch/csrc/bilstm_fwd.cu",
                 "room_slam_tpu/ops/rnn_pallas.py:531",
                 trained["bilstm_fwd_train"], train_row["bilstm_fwd_train"]),
         "shapes": train_rows["bilstm_fwd_train"]},
        {**entry("bilstm_bwd", "room_slam_torch/csrc/bilstm_bwd.cu",
                 "room_slam_tpu/ops/rnn_pallas.py:438",
                 trained["bilstm_bwd"], train_row["bilstm_bwd"]),
         "max_rel_err": train_errs[TRAIN]["bwd_rel"],
         "shapes": train_rows["bilstm_bwd"]},
        {**entry("bigru_fwd", "room_slam_torch/csrc/bigru_fwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:314",
                 gru_served["bigru_fwd"], gru_rows["bigru_fwd"]),
         "shapes": [gru_rows["bigru_fwd"]]},
        {**entry("bigru_fwd_train", "room_slam_torch/csrc/bigru_fwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:454",
                 gru_trained["bigru_fwd_train"], gru_rows["bigru_fwd_train"]),
         "shapes": [gru_rows["bigru_fwd_train"]]},
        {**entry("bigru_bwd", "room_slam_torch/csrc/bigru_bwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:357",
                 gru_trained["bigru_bwd"], gru_rows["bigru_bwd"]),
         "max_rel_err": gru_errs[(SCALEUP, torch.bfloat16)]["bwd_rel"],
         "shapes": [gru_rows["bigru_bwd"]]},
    ]
    for name, source, line, launched in (
            ("gru_fwd", "bigru_fwd.cu", "gru_pallas.py:39", legacy_evaluated),
            ("gru_fwd_train", "bigru_fwd.cu", "gru_pallas.py:155",
             legacy_trained),
            ("gru_bwd", "bigru_bwd.cu", "gru_pallas.py:71", legacy_trained),
            ("lstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:105", lstm_launched),
            ("lstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:183",
             lstm_launched),
            ("lstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:242", lstm_launched)):
        extra = [single_rows["gru_bwd_bf16"]] if name == "gru_bwd" else []
        kernels.append({**entry(name, f"room_slam_torch/csrc/{source}",
                                f"room_slam_tpu/ops/{line}", launched[name],
                                single_rows[name]),
                        "shapes": [single_rows[name], *extra]})
    pick = tool["config"]["tiles"][0]
    b = gru_bound("bwd", *SCALEUP, torch.bfloat16)
    split_row = {"shape": list(SCALEUP), "dtype": "bfloat16",
                 "plan": pick, "kernel": tool["config"]["kernel"],
                 "kernel_ms": tool["measured_ms"][f"bwd_split@{pick}_ms"],
                 "plain_ms": split_plain_ms[(SCALEUP, torch.bfloat16)],
                 "library_ms": gru_rows["bigru_bwd"]["library_ms"],
                 "bound_us": b[0] * 1e3, "bound_by": b[1],
                 "err": split_errs[(SCALEUP, torch.bfloat16)]["abs"]}
    kernels += [
        {**entry("bigru_bwd_split", "room_slam_torch/csrc/bigru_bwd.cu",
                 "room_slam_tpu/tools/bench_bigru_bwd.py:127",
                 split_launched, split_row),
         "max_rel_err": split_errs[(SCALEUP, torch.bfloat16)]["rel"],
         "shapes": [split_row, *split_rows]},
        {**entry("bigru_bwd_fused", "room_slam_torch/csrc/bigru_bwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:646", fused_launched,
                 ab_row),
         "max_rel_err": ab_row["max_rel_err"], "shapes": [ab_row]}]
    for k in kernels:
        if k["name"] in lstm_bf16_rows:
            k["shapes"] = [*k["shapes"], lstm_bf16_rows[k["name"]]]
    # the new routes, each with its own main path's launches
    lstm_step = wide_launched["lstm_step"]
    for name, source, line, launched in (
            ("bilstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:390",
             wide_launched["lstm_forward"]),
            ("bilstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:531",
             lstm_step),
            ("bilstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:438", lstm_step),
            ("lstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:105",
             wide_launched["lstm_ops"]),
            ("lstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:183",
             wide_launched["lstm_ops"]),
            ("lstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:242",
             wide_launched["lstm_ops"])):
        rows = wide_rows[name]
        kernels.append({**entry(f"{name}_reg",
                                f"room_slam_torch/csrc/{source}",
                                f"room_slam_tpu/ops/{line}", launched[name],
                                rows[0]),
                        "old_cluster_ms": rows[0]["old_cluster_ms"],
                        "shapes": rows})
    # the GRU register cluster kernels (phase 41): the bigru at d_model 512
    # (its step's and its served forward's launches), the one-direction
    # kernels on phase 34's gru_recurrence path (H=139); the first cluster
    # design's and the pipe kernel's times beside them
    for name, source, line, launched in (
            ("bigru_fwd", "bigru_fwd_reg.cu", "gru_pallas.py:314",
             reg_launched["serve"]),
            ("bigru_fwd_train", "bigru_fwd_reg.cu", "gru_pallas.py:454",
             reg_launched["step"]),
            ("bigru_bwd", "bigru_bwd_reg.cu", "gru_pallas.py:357",
             reg_launched["step"]),
            ("gru_fwd", "bigru_fwd_reg.cu", "gru_pallas.py:39",
             wide_launched["gru_ops"]),
            ("gru_fwd_train", "bigru_fwd_reg.cu", "gru_pallas.py:155",
             wide_launched["gru_ops"]),
            ("gru_bwd", "bigru_bwd_reg.cu", "gru_pallas.py:71",
             wide_launched["gru_ops"])):
        rows = reg_rows[name]
        kernels.append({**entry(f"{name}_reg",
                                f"room_slam_torch/csrc/{source}",
                                f"room_slam_tpu/ops/{line}", launched[name],
                                rows[0]),
                        **{k: rows[0][k] for k in (
                            "cluster_ms", "pipe_ms", "route_fastest",
                            "first_over_route")},
                        **({"path_timing": reg_launched["timing"]}
                           if name.startswith("bigru") else {}),
                        "shapes": rows})
    # the LSTM register cluster kernels at H 65-118 (phase 42): the lstm at
    # d_model 192 (its served forward's and its step's launches), the
    # one-direction kernels on its lstm_recurrence path; the wide kernels'
    # times beside them
    for name, source, line, path in (
            ("bilstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:390", "serve"),
            ("bilstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:531",
             "step"),
            ("bilstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:438", "step"),
            ("lstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:105", "ops"),
            ("lstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:183", "ops"),
            ("lstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:242", "ops")):
        rows = mid_rows[name]
        kernels.append({**entry(f"{name}_mid",
                                f"room_slam_torch/csrc/{source}",
                                f"room_slam_tpu/ops/{line}",
                                mid_launched[path][name], rows[0]),
                        **{k: rows[0][k] for k in ("wide_ms",
                                                   "wide_over_reg")},
                        **({"path_timing": mid_launched["timing"]}
                           if name.startswith("bilstm") else {}),
                        "shapes": rows})
    # phase 40: #5 / #5t / #6 on the unit kernels (the bigru default path's
    # step and request), and the pipe kernels with their main paths
    for name, line, launched in (
            ("bigru_fwd", "gru_pallas.py:314", bigru_launched["request"]),
            ("bigru_fwd_train", "gru_pallas.py:454", bigru_launched["step"]),
            ("bigru_bwd", "gru_pallas.py:357", bigru_launched["step"])):
        rows = bigru_rows[name]
        kernels.append({**entry(f"{name}_unit",
                                f"room_slam_torch/csrc/{name[:9]}.cu",
                                f"room_slam_tpu/ops/{line}", launched[name],
                                rows[0]),
                        "old_cluster_ms": rows[0]["old_cluster_ms"],
                        "bf16_tc_vs_unit": bigru_bf16[name],
                        "path_timing": bigru_timing, "shapes": rows})
    for name, source, line, path in (
            ("bilstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:390",
             "lstm_forward"),
            ("bilstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:531",
             "lstm_step"),
            ("bilstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:438", "lstm_step"),
            ("lstm_fwd", "bilstm_fwd.cu", "rnn_pallas.py:105", "lstm_ops"),
            ("lstm_fwd_train", "bilstm_fwd.cu", "rnn_pallas.py:183",
             "lstm_ops"),
            ("lstm_bwd", "bilstm_bwd.cu", "rnn_pallas.py:242", "lstm_ops"),
            ("bigru_fwd", "bigru_fwd.cu", "gru_pallas.py:314", "bigru"),
            ("bigru_fwd_train", "bigru_fwd.cu", "gru_pallas.py:454",
             "bigru"),
            ("bigru_bwd", "bigru_bwd.cu", "gru_pallas.py:357", "bigru"),
            ("gru_fwd", "bigru_fwd.cu", "gru_pallas.py:39", "gru_ops"),
            ("gru_fwd_train", "bigru_fwd.cu", "gru_pallas.py:155", "gru_ops"),
            ("gru_bwd", "bigru_bwd.cu", "gru_pallas.py:71", "gru_ops")):
        rows = stream_rows[name]
        # the pipe kernels (sources of their own), the first stream design
        # (and at H=320 the GRU's first cluster design, kLinear's for the
        # BPTT) beside them
        source = {"bilstm_fwd.cu": "bilstm_fwd_pipe.cu",
                  "bigru_fwd.cu": "bigru_fwd_pipe.cu",
                  "bilstm_bwd.cu": "bilstm_pipe.cu",
                  "bigru_bwd.cu": "bigru_pipe.cu"}[source]
        step = ("lstm_step_p50" if name.startswith("bilstm") else
                "bigru_step_p50" if name.startswith("bigru") else None)
        kernels.append({**entry(f"{name}_pipe",
                                f"room_slam_torch/csrc/{source}",
                                f"room_slam_tpu/ops/{line}",
                                stream_launched[path][name], rows[-1]),
                        "stream_ms": rows[-1]["stream_ms"],
                        "wide_shapes": stream_rows[f"{name}_wide"],
                        **{k: rows[0][k] for k in ("klinear_ms", "cluster_ms")
                           if k in rows[0]},
                        **({"path_timing": stream_launched[step]}
                           if step else {}),
                        "shapes": rows})
    for k in kernels[:3]:
        k["launches_recipe"] = recipe_launched[k["name"]]
    kernels[0]["launches_evaluate"] = evaluated["bilstm_fwd"]
    kernels[0]["launches_tools"] = tools_launched
    kernels[0]["launches_export"] = export_launched["bilstm_fwd"]
    kernels[0]["launches_live"] = live_launched
    next(k for k in kernels if k["name"] == "bigru_fwd_unit")[
        "launches_export"] = export_launched["bigru_fwd"]
    # the reference lstm checkpoints' requests: H=64 (unit), H=128 (reg)
    kernels[0]["launches_pth"] = pth_launched["lstm_128"]
    next(k for k in kernels if k["name"] == "bilstm_fwd_reg")[
        "launches_pth"] = pth_launched["lstm_256"]
    kernels[0]["shapes"] += tta_rows
    kernels[0]["recipes"] = recipe_rows
    kernels.append({
        **entry("hungarian", "room_slam_torch/csrc/hungarian.cu",
                "room_slam_tpu/ops/hungarian.py:227",
                fused_timing["matcher_launches"], match_rows["flagship"]),
        "host_ms": match_rows["flagship"]["host_ms"],
        "match_ms": match_rows["flagship"]["match_ms"],
        "shapes": list(match_rows.values())})
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

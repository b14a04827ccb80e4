"""Smoke run of mxnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile]

Builds the package's CUDA kernels from the sources in this checkout
(``build/kernels/``, one ``nvcc`` per source, all at once), then:

1. **Serving phase: generation serving at full width.**
   ``transformer_lm_base`` (units 768, 12 layers, 12 heads, head_dim 64,
   vocab 32000, max_len 2048) with random weights made from ``--seed`` with
   numpy and loaded through ``convert.load_mxnet_params``; ``DecodeEngine``
   (8 slots, max_seq 2048, ladder 16..1024, float32, no prefix cache and
   no chunking: the monolithic path) behind
   ``GenerationScheduler`` behind ``ModelServer`` on an ephemeral port.
   Eight concurrent ``POST /generate`` requests (prompt lengths 5, 37, 100,
   128, 200, 511, 700, 1000; 32 greedy tokens each). Checks that every
   stream ends with ``{"done": true, "reason": "length", "n_tokens": 32}``;
   that the engine's programs ran through ``CachedOp`` (one CUDA graph per
   signature: after the burst, one decode graph and at most one prefill
   graph a rung), so that the flash kernel launched 2 x 12 times for each
   prefill rung captured in that run (the side-stream run and the
   capture; a replay launches nothing the counters see); and that the two
   longest streams equal greedy decoding by re-prefill: one
   full ``forward`` over prompt + stream on the plain attention path, whose
   argmax at each position must be the next streamed token.
2. **Serving v2 phase: chunked prefill, the prefix cache, speculative
   decoding, lanes and retry at full width.** ``transformer_lm_base`` with
   the serving phase's weights; every engine has 8 slots, max_seq 2048,
   ladder 16..1024 and float32; prompt tokens from
   ``numpy.random.default_rng(seed + ...)``. (a) A 640-token shared system
   prompt plus 8 suffixes of 7..120 tokens, 32 greedy tokens each, with
   ``chunk=128``: a cold pass without a prefix cache, then a warm pass
   over a ``PrefixCache(block=128)`` primed by one request and flushed.
   Checks 8 hits saving 8 x 640 tokens, warm streams equal to cold ones,
   bitwise-equal arena rows of a cold and a hit slot (direct engine
   calls), the two longest streams equal to greedy re-prefill, and no
   flash launch (the chunk program is the plain path). (b) Three live
   100-token streams of 96 tokens; after 8 tokens a 1000-token prompt
   arrives, monolithic (``chunk=0``: one flash prefill) and chunked
   (``chunk=128``); the live streams' inter-token p99 and max are printed.
   Then a 1900-token prompt (beyond the ladder) through ``chunk=128``: its
   16 tokens must equal greedy re-prefill. (c) The serving burst's 8
   prompts, 32 greedy tokens each, plain, with a self-draft (a second
   ``transformer_lm_base`` with the same weights) and with an independent
   draft (units 256, 2 layers, 4 heads, weights from ``seed + 7``), k = 4,
   each run serving the burst 3 times (tokens/s: median and range):
   every speculative burst must be token-exact against the plain run,
   except that a stream's comparison stops at a near tie (the plain
   path's top-2 logit margin under 1e-5 of its largest |logit|, by
   re-prefill), which is printed and counted. (d) A ``"prefill"`` lane and
   a ``"decode"`` lane over one ``PrefixCache(block=128)``: a 700-token
   prompt retires on the prefill lane with reason ``"prefill"``, then hits
   640 tokens on the decode lane with no ``decode_lane_misses``, its
   stream equal to a mixed lane's. (e) A 4-request burst under a
   ``RetryPolicy`` with ``chaos.arm("generation.step", "transient",
   first=2)``: every stream equals its unarmed run, with 2 retries. (f)
   Each program alone, every slot holding a 1000-token prompt: the flash
   prefill at rung 1024, a 128-token chunk at 0 and at 896, the decode
   step (these three CUDA-graph replays), the verify (8 slots x 5) and the
   2-layer draft's step, 10 calls each between CUDA events (and with
   ``--profile`` under ``torch.profiler``: kernel busy ms and kernels a
   call). (g) The programs as graphs against the same programs run
   eagerly (``DecodeEngine(cached=False)``), two engines on one model:
   prefill, chunk and decode graphs captured on slots 0 and 5 and replayed
   on slots 3 and 6 must leave both arenas and the sampled tokens equal
   bit for bit; the decode step with every slot at a 1000-token prompt,
   replay and eager, 10 calls between CUDA events and 10 more under
   ``torch.profiler`` (kernels and busy ms a call); 12 greedy requests of
   mixed lengths and budgets through the 8 slots must give the same
   streams in both engines, after which the graph engine holds one decode
   graph and at most one prefill graph a rung. Flash launches are counted
   per part: 2 x 12 for each prefill rung an engine captured, 12 for each
   eager prefill. The tracer is on through the phase: each part prints its
   generation spans' counts and mean host ms (the draft engine's as
   ``generation.draft.*``). After both serving phases every engine is
   closed or dropped: more than 512 MiB of device memory still allocated
   fails the run.
3. **Training phase: TransformerLM training at full width.** The same
   weights in ``transformer_lm_base`` with max_len 512 (the configuration of
   the reference's ``bench_translm``), ``ShardedTrainer`` with
   ``SoftmaxCrossEntropyLoss`` over the shifted logits (labels are the next
   tokens, the last one -1 and ignored) and Adam at lr 1e-4, batch 32 x seq
   512 of numpy tokens, repeated: 8 steps in float32, then 8 in
   ``dtype="bfloat16"``. Checks that every loss is finite, that the fp32
   loss falls, and that the forward, dQ and dK/dV kernels each launched
   steps x 12 times in that run. The first fp32 step is run again from the
   same weights on the plain path (``MXNET_FLASH_ATTENTION=0``: plain
   attention and torch autograd): the loss must agree to 1e-4 relative and
   every parameter gradient to 1e-3 of its largest |value| (fp32 both,
   sums in another order). Two steps with dropout 0.1 under one
   ``random.seed`` are run twice and must give bitwise-equal losses (no
   atomics anywhere on the path), and the dQ kernel, run twice on the same
   inputs at the training shape (fp32 and bf16, dropout 0 and 0.1), must
   give bitwise-equal results.
4. **BERT phase: BERT-base pretraining at full width.** ``bert_base``
   (units 768, 12 layers, 12 heads, hidden 3072, vocab 30522, max_length
   128, dropout 0.1) with random N(0, 0.02) weights made from ``--seed``
   with numpy (LayerNorm 1 and 0), written under reference names with
   ``ndarray.save_ndarrays`` to a ``.params`` file under ``build/`` and
   loaded back through ``convert.load_mxnet_params``. ``ShardedTrainer``
   over ``PretrainStep`` with ``PretrainLoss`` and Adam at lr 1e-4, on one
   ``synthetic_batch`` of the reference bench (batch 64, seq 128, 20
   masks), repeated: 8 steps in float32, then 8 in ``dtype="bfloat16"``.
   Every attention is non-causal with no key mask (``valid_len=None``, as
   in the reference) and dropout 0.1 in the kernels. Checks that every loss
   is finite and that the forward, dQ and dK/dV kernels each launched steps
   x 12 times in that run. Then, with dropout 0 from the same weights, in
   fp32 and in bf16: one step through ``PretrainStep``, and a forward and
   backward of ``BERTModel`` + ``BERTPretrainingLoss(picked=True)`` with a
   ``valid_len`` of lengths in 64..128 (a key mask in all three kernels),
   each run again on the plain path: the losses must agree to 1e-4
   relative and every gradient to 1e-3 of its largest |value| in fp32. In
   bf16 the losses must agree to 1e-2, and both paths' gradients are held
   against the fp32 plain path on the same weights: the kernel path's
   worst distance (in units of each gradient's largest |value|) at most
   twice the plain path's. Two dropout-0.1 steps under one
   ``random.seed``, run twice, must give bitwise-equal losses and
   second-step gradients.
5. **Surface phase: the Gluon training surface at full width.**
   (a) ``bert_base`` at the BERT phase's configuration (b64 s128 m20,
   dropout 0.1), initialized as the reference's recipe does: after
   ``random.seed(--seed)``, ``collect_params(PretrainStep(net))
   .initialize(Xavier())`` (numpy draws, the reference's values bit for
   bit). ``ShardedTrainer`` with ``"lamb"`` (lr 1e-4, wd 0.01), the lr of
   step ``i`` from ``PolyScheduler(max_update=8, base_lr=1e-4, pwr=1,
   warmup_steps=2)`` at ``num_update = i`` (printed), 8 steps in float32
   and 8 in bf16, then 8 bf16 Adam steps on the same weights and schedule
   (LAMB's cost beside Adam's). Checks: finite losses, each kernel steps x
   12 launches, and one dropout-0 LAMB step against the plain path with
   the BERT phase's tolerances (fp32: loss 1e-4 relative, gradients 1e-3
   of their max; bf16: the kernel path's worst distance from the fp32
   plain path at most twice the bf16 plain path's). (b)
   ``transformer_lm_base`` at the training phase's b32 s512, initialized
   with ``collect_params(net).initialize(Xavier())``, trained eagerly as a
   Gluon script does: forward, the per-sample ``SoftmaxCrossEntropyLoss``,
   ``backward`` of the loss vector, ``clip_global_norm`` of the gradients
   at 0.25 a sample, ``gluon.Trainer(params, "adam", {lr 1e-4})
   .step(32)``; 8 steps in float32, then 8 with the net in bf16 and
   ``multi_precision=True`` (fp32 master copies, checked). Checks: finite
   losses, the fp32 loss falls, each kernel steps x 12 launches, and the
   first fp32 step equals one ``ShardedTrainer`` Adam step from the same
   weights (``rescale_grad`` = the clip's scale): the loss to 1e-6
   relative and every parameter to 1e-5 of its largest |value|.
6. **Forward kernel phase.** At the serving shapes (B 1, H 12, D 64, S 128
   and 1024; causal with a key mask; both layouts; fp32 and bf16; a
   dropout case in each type), at B 8, S 512 with D 32 and D 128 (fp32,
   BSHD, causal with a key mask), at the training shape (B 32, S 512,
   causal) and at the BERT shape (B 64, S 128, BSHD, non-causal; without
   and with a key mask, and with dropout 0.1; fp32 and bf16), each kernel
   call is held against ``flash_attention_plain`` on the card (fp32
   atol/rtol 2e-4: sums in another order; bf16 2e-2: P is rounded to bf16
   before PV) and timed with CUDA events, beside the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (the yardstick
   only; the package never calls it): with ``is_causal`` as the case and
   no mask where the case has no key mask, so that SDPA can take its flash
   backend, and with the same boolean mask (and the causal one, where the
   case is causal) where it has one.
7. **Backward kernel phase.** At B 8, S 512, H 12, D 64, causal with a key
   mask (both layouts, fp32 and bf16, a dropout case in each type, D 32 and
   D 128 cases in each type), at the training shape (B 32, S 512, causal;
   fp32 and bf16) and at the BERT shape (the cases of phase 6), the dQ and
   the dK/dV kernels are held against ``flash_attention_bwd_plain`` on the
   card (the largest error at most 2e-4 of the largest |value| in fp32,
   2e-2 in bf16) and timed eager and from a CUDA graph, beside their bound,
   the plain backward and ``torch.autograd.grad`` through SDPA (the
   yardstick only; SDPA called as in phase 6): eager with the forward
   outside the timed region, and from a CUDA graph as the graph time of
   forward + backward less that of the forward alone.

8. **Predict phase: ``/predict`` serving of BERT-base through the core
   runtime.** ``bert_base`` (vocab 30522, max_length 128) with the BERT
   phase's random weights (a ``.params`` file written under ``build/``
   and loaded through ``convert``), ``eval()``, ``hybridize()``, under
   ``autograd.predict_mode()``. The served function takes NDArrays
   ``(tokens, segments, valid_len)`` and returns the pooled [CLS] row and
   its NSP logits (``net.encoder``, ``net.pooler``, ``nd.tanh``,
   ``net.nsp``). ``InferenceEngine`` (buckets 1..32) over it, ``warmup``
   (one CUDA graph per bucket), then ``ModelServer`` over the engine
   (``max_batch_size`` 32, 5 ms window): 8 client threads x 8 ``POST
   /predict`` of S = 128 with ``valid_len`` drawn from 16..128; in fp32,
   then with the net cast to bf16 and a new engine. Checks, per dtype: 6
   misses and 6 graphs after warmup, 2 x 12 flash forward launches per
   bucket in it (the side-stream run and the capture), and no new miss
   under traffic; at every bucket the graph replay equals the
   non-hybridized forward bit for bit (12 flash launches per eager call);
   0 errors and a mean batch above 1 over HTTP; each output over all
   replies within 1e-5 (fp32) or 2e-2 (bf16) of its largest |value| of
   the rows run alone. Prints the capture ms per bucket, eager and replay
   ms per bucket (CUDA events, 20 calls), the graph pool's bytes, client
   p50/p99 and rows/s (``--profile``: kernels and busy ms of one eager
   call at bucket 32). The whole ``BERTModel`` (MLM logits too) is served
   in-process at bucket 8 and must equal its eager forward bit for bit.
9. **Autograd phase: the Gluon loop over NDArrays.**
   ``transformer_lm_base`` at max_len 512 from surface (b)'s weights
   (``random.seed``, ``collect_params().initialize(Xavier())``), batch 32
   x 512: surface (b)'s first step on tensors, then the same step as a
   script writes it (``nd.array`` inputs, ``with autograd.record():``,
   ``loss.backward()``); the per-sample losses and every gradient must be
   equal bit for bit. Then 3 fp32 and 3 bf16 (``cast``, fp32 masters)
   steps with ``gluon.Trainer`` Adam, step ms printed; each training
   kernel launches 12 times a step.
10. **Registry-op phase.** ``nd._contrib_dot_product_attention`` in its
    default (B, H, S, D) layout at B 8, S 512, H 12, D 64, causal and
    not, fp32 and bf16, forward and backward under
    ``autograd.record()``, against the plain path
    (``MXNET_FLASH_ATTENTION=0``): output and gradients within 2e-4
    (fp32) or 2e-2 (bf16) of their largest |value|; the (B, H, S, D)
    forward, dQ and dK/dV kernels launch once a call each.

11. **Vision phase: ResNet-50 v1 inference and training.** (a) The
    reference's ``__graft_entry__.entry()`` step for step:
    ``resnet50_v1()`` after ``random.seed(--seed)`` (numpy too),
    ``initialize(Xavier())`` on the card, one forward at (1, 3, 224, 224)
    to settle the deferred shapes, ``cast("bfloat16")`` (every one of the
    212 BatchNorm parameters must stay fp32, every other one bf16), then
    the b32 bf16 forward of uniform [0, 1) images through
    ``functionalize(net, train=False)`` and through the hybridized net (a
    CUDA-graph replay): equal bit for bit; against an fp32 copy of the
    same (bf16) weights on the same inputs within ``VISION_BF16_TOL``
    (2e-2) of the logits' largest |value|. Prints eager and replay ms
    (CUDA events) and img/s, the capture ms and the graph pool's bytes.
    (b) ``bench.py``'s ``resnet50_train``: b32 at 224x224,
    ``SoftmaxCrossEntropyLoss``, SGD lr 0.1 momentum 0.9 through
    ``ShardedTrainer``, in fp32 (TF32 off) and in bf16 (the net cast
    first, as ``bench.py`` does): 3 ``step``s, then one ``bench_span`` of
    8 steps on batches made on the card; ms a step (CUDA events), img/s,
    peak memory; finite losses. Before them, one step with weight decay
    0.1 through its own trainer: the stem BatchNorm's moving mean and
    variance must equal 0.9 x old + 0.1 x the batch's (taken on the card
    in float64 from the layer's input) within 1e-5 of their largest
    |value|, in the trainer and in the block (a decay would move them
    1%). No flash kernel may launch in the phase.
12. **Data phase: ResNet-50 v1 trained from a RecordIO file.** The native
    IO library is built from ``mxnet_tpu_torch/csrc/io/`` with ``g++``
    (JPEG only where libjpeg's headers are present). 640 raw records
    (``pack_img(..., ".raw")``), each a 3 x 256 x 256 uint8 image from
    ``--seed``, about 126 MB, are written to a temporary directory and
    read by ``ImageRecordIter(data_shape=(3, 224, 224), batch_size=32,
    rand_crop=True, rand_mirror=True)`` with the ImageNet mean and std; it
    must take the native pump. The pump alone is timed over an epoch, and
    a pinned-to-device copy of one batch (H2D GB/s). Per dtype (fp32 with
    TF32 off; bf16 with the net cast and the batch cast in the step), with
    cuDNN's deterministic algorithms: a ``DeviceFeed`` (depth 4,
    prefilled) feeds ``ShardedTrainer.step_stream`` (SGD lr 0.1 momentum
    0.9, chunk 8, 16 steps); no stage wait may occur; each staged batch's
    checksum (the sum of its bit patterns, taken on the consumer's stream)
    must equal its host batch's; the losses must equal, bit for bit,
    ``step()`` calls of a second trainer from the same parameters over the
    same host batches; then an 8-step ``bench_span`` on the fed trainer.
    Prints data-fed against ``bench_span`` ms a step and img/s and
    ``feed_stats()``. Then four batches of ``DataLoader(ImageRecordDataset
    (...).transform_first(Compose([ToTensor(), Normalize(...)])),
    batch_size=32, pin_memory=True, num_workers=4)`` must be CUDA
    NDArrays equal to the unpinned loader's. No flash kernel may launch.
13. **RNN phase: the LSTM word language model at WikiText-2 width.**
    ``RNNModel("lstm", 33278, 1500, 1500, 2, dropout=0)`` from
    ``Xavier()`` (``benchmark/bench_lm.py:266-300``), every layer through
    cuDNN (``ops/rnn.py``). (b) First, the first step's loss
    (``bench_lm.py``'s float32 log-softmax cross-entropy over (T·B, V))
    and every gradient through cuDNN against the plain per-step path on
    the card at b128 s35: fp32 within ``RNN_LOSS_TOL`` (1e-5, of the loss)
    and ``RNN_GRAD_TOL`` (1e-4 of each gradient's largest |value|); in
    bf16 both against fp32 on an fp32 copy of the bf16 weights, each
    gradient's cuDNN distance at most ``RNN_BF16_FACTOR`` (2x) the plain
    path's for the same parameter (floored at ``RNN_BF16_FLOOR``). (a)
    ``ShardedTrainer`` (SGD lr 1.0, no mesh) 8 fp32 and 8 bf16 steps at
    b128 s35: ms a step (CUDA events, steps 2..8), tokens/s, peak memory,
    losses, each layer's path (every call cuDNN's), whether torch warned
    that the weights are "not part of single contiguous chunk of memory"
    (the warning is shown, not silenced) with the bytes cuDNN copies a
    step and the time of one such copy, the LSTM stack's forward and
    backward alone, and one more step under ``torch.profiler`` (the
    cuDNN RNN kernels by name; one must appear). (c)
    ``example/gluon/word_language_model.py``'s eager loop at the same
    width, fp32, 4 steps: ``gluon.Trainer("sgd")``, the hidden state
    carried and detached, ``clip_global_norm(grads, 0.25 x 35 x 128)``,
    dropout 0.2 (keyed ``Dropout``), fed by ``mx.rnn.BucketSentenceIter``
    over a synthetic corpus from ``--seed`` (the example's rule): step ms
    and clip norms. (d) The hybridized forward with ``hidden`` through
    ``CachedOp`` (a CUDA graph) at b128 s35, fp32 and bf16: the replay
    equal to eager bit for bit, replay and eager ms. (e) ``Estimator.fit``
    (``fit_batch`` taking the loader's (B, T) batches as (T, B)), one
    epoch of 8 b32 batches of a pinned ``DataLoader`` over token windows,
    ``Loss`` and ``Accuracy``, ``LoggingHandler`` and ``CheckpointHandler``
    into a temporary directory, the default context the card; the
    checkpoint, loaded through ``convert.load_mxnet_params`` into a fresh
    ``RNNModel``, gives the trained model's forward bit for bit. No flash
    kernel may launch.
14. **Symbol phase: the symbolic and legacy frontends.** (a)
    ``resnet50_v1()`` (the vision phase's, from ``Xavier()``) exported
    (``HybridBlock.export`` into a temporary directory) and imported as
    a ``SymbolBlock`` on the card: the graph's op counts (53
    ``Convolution``, 53 ``BatchNorm``, 49 ``Activation``, 2 ``Pooling``,
    16 ``add``, 1 ``FullyConnected``), the imported block's b32 eager
    forward equal to the original's bit for bit in fp32 and, both cast,
    in bf16 (BatchNorm's inputs float32), each block's CUDA-graph replay
    equal to its eager forward, and both replays' ms. (b)
    ``InferenceEngine.load`` of those files (buckets 1, 2, 4) behind
    ``ModelServer``: 8 single-image ``/predict`` requests in waves of 1,
    3 and 4, each answer within ``SYMBOL_PREDICT_TOL`` (1e-5) of its max
    from the imported block's forward of its row; client p50 and the
    buckets seen. (c) The exported symbol under ``mx.sym.SoftmaxOutput``,
    bound in ``mx.mod.Module`` for (32, 3, 224, 224) and initialized from
    ``mx.model.load_checkpoint`` of (a)'s files, SGD lr 0.1 momentum 0.9
    (``bench.py``'s): the first update within ``SYMBOL_STEP_TOL`` (1e-5)
    of each weight's max from one eager ``gluon.Trainer`` step of the
    original net under ``autograd.record(train_mode=False)`` (the
    executor runs BatchNorm on its moving statistics, as the reference's
    does), 8 steps (ms a step by CUDA events over steps 2..8, img/s,
    printed beside the vision phase's fp32 ``bench_span``), every moving
    statistic unchanged, and the first step's ``save_checkpoint`` ->
    ``Module.load`` -> ``predict`` equal to that module's ``predict`` bit
    for bit (nothing normalizes the activations, so at this rate the
    weights may leave the finite range by the 8th step: printed).
    No flash kernel may launch in (a)-(c). (d)
    ``mx.sym._contrib_dot_product_attention`` (BHSD, causal) at the
    registry phase's shape through ``simple_bind`` in fp32 and bf16: a
    training forward and ``backward`` launch the forward, dQ and dK/dV
    kernels once each, and match the plain path at the registry phase's
    tolerances; the inference forward's replay (the executor's
    ``CachedOp``) equals its eager forward.
15. **Ops phase: the first part of the op corpus on the card.** Every name
    that the reference's ``ops/core.py``, ``ops/tensor_extra.py`` and
    ``ops/random_ops.py`` register (with the aliases other reference
    files register onto their functions) and ``nn.py``'s samplers
    (``OPS_NEW_NAMES``, 321) runs through ``nd.<name>`` on ``gpu(0)``
    NDArrays; its outputs must be on the card. The deterministic ones are
    held to the port's CPU result on the same inputs (made from
    ``--seed``): ordering, indexing, creation, shape, comparison and
    arithmetic that rounds once bit for bit; transcendental functions
    within the CPU tests' tolerance (rtol 1e-6 / atol 1e-7; atol 1e-6
    where ``gammaln`` or ``digamma`` cancel; ``gamma`` rtol 2e-6 and the
    densities rtol 3e-5, the exp of those sums); linalg and reductions
    within 1e-5 of each output's max. (a) ``sort``, ``argsort``,
    ``topk`` (k 50, every ``ret_typ``), ``argmax_channel`` and ``cumsum``
    over logits (32, 32000) in fp32 and bf16; (b) ``linalg_gemm``/``gemm2`` and
    ``batch_dot`` at BERT-base's attention batches (768, 128, 64) x (768,
    64, 128), ``linalg_potrf``/``trsm``/``syrk``/``sumlogdiag`` on SPD
    (64, 768, 768); (c) the elementwise, comparison, reduction and
    histogram ops on ResNet-50's first activation (32, 64, 112, 112); (d)
    ``multi_sum_sq``, ``multi_all_finite`` and ``reset_arrays`` over
    BERT-base's parameter shapes; the densities one distribution a row.
    (e) Every sampler draws 32 x 3 x 224 x 224 values on the card (a
    per-row sampler 2 rows of half that): mean and variance within the
    bounds of ``tests/test_random_stats.py``, a seed repeats the draw bit
    for bit; the multinomial frequencies, zipfian counts and shuffles;
    a hybridized block that samples in its forward captures a CUDA graph,
    two replays differ, and a seed repeats the replays that follow it.
    (f) BERT-base Adam (from ``Xavier()``) through ``gluon.Trainer``: two
    steps, ``save_states`` and a ``.params``; a fresh model from that file
    and a fresh trainer that ``load_states`` take the third step, which must
    equal the uninterrupted one bit for bit, first on the plain attention
    path (``MXNET_FLASH_ATTENTION=0``), then on the flash path that BERT
    training runs. Prints the count of names run on the card and the
    card's ms for ``topk``, ``sort`` and ``linalg_gemm2`` at these shapes
    beside its name and power limit. No flash kernel may launch in parts
    a-f on the plain path; the flash resume's launches (48 of each BSHD
    kernel) are listed apart, as ``ops_resume``.
16. **np phase: the numpy frontends and the second part of the op
    corpus.** (a) Every name the slice registers (``NP_NEW_NAMES``, 184:
    the reference's ``ops/numpy_ops.py``, ``optim_ops.py``,
    ``linalg_extra.py`` and ``image_ops.py``, the rest of ``nn.py`` and
    the aliases) through ``nd.<name>`` on ``gpu(0)`` against the port's
    CPU result on the same inputs, computed once a primary op: logits
    (32, 32000) for the elementwise, ``numpy_ops`` and update ops (mp in
    bf16), BERT-base's (768, 3072) weight for ``_npi_svd``, SPD (64, 768,
    768) for ``potri``, ``inverse``, ``det``, ``slogdet``, ``trmm`` and
    ``syevd``, (64, 128, 768) for ``gelqf`` (the CPU recomputes the first
    ``NP_CPU_SLICE`` matrices of those batches), the images' shapes for
    ``image_ops``; bitwise where exact, else the ops phase's tolerances
    (updates ``NP_UPDATE_TOL``, bf16 one ulp; factors by reconstruction
    and vectors up to sign within ``NP_VECTOR_TOL``; uint8 resize within
    one level, the count printed); the samplers and random image ops on
    the card, in the CPU's dtype and shape, repeated by their key. (b)
    Every public callable of ``mx.np``, ``np.linalg``, ``np.random`` and
    ``mx.npx`` on ``gpu(0)`` against the CPU (the cases of the CPU tests,
    ``np_cases``, at ``NP_SIZES["card"]``): dtypes equal, values within
    ``NP_TOL``. (c) BERT-base's MLM loss through ``mx.np`` (hidden (1280,
    768), ``np.dot`` with the (30522, 768) embedding's transpose,
    ``npx.log_softmax``, ``npx.pick``, ``np.mean``) and its backward:
    bitwise to the ``nd`` expression on the card, within ``NP_MLM_TOL``
    of the CPU. (d) The update ops over BERT-base's parameters from
    ``Xavier()`` (~110M values): ``sgd_mom_update``, ``adam_update``,
    ``adamw_update`` per array, ``multi_sgd_mom_update``,
    ``multi_mp_sgd_mom_update`` and ``preloaded_multi_sgd_mom_update`` in
    one call each, ``multi_lars`` over ``multi_sum_sq``, each held to the
    CPU and timed (CUDA events) beside ``optimizer.Adam`` through
    ``gluon.Trainer``, with Adam's bytes bound. (e) 32 seeded uint8 images
    of 256^2 x 3: ``_image_resize`` to 224, ``_image_to_tensor``,
    ``_image_normalize`` (ImageNet mean and std) on the card (ms printed)
    and on the CPU, both batches through one bf16 ``resnet50_v1()``
    (``Xavier()``): logits within ``NP_LOGIT_TOL``; the random image ops
    at that shape, repeated by a seed. (f) ``np.random``'s samplers at
    (32, 3, 224, 224): moments within bounds, repeated by a seed. No
    flash kernel may launch.
17. **Detection phase: the contrib, control-flow, spatial and detection
    families (item 8 steps 1-4).** (a) Every name the slice registers
    (``DET_NEW_NAMES``, 130) through ``nd.<name>`` on ``gpu(0)`` against
    the CPU on the same seeded inputs, at the widths of (b) and (c) (the
    generation ops at ``transformer_lm_base``'s logits and arena, the
    interleaved matmuls at BERT-base's): exact families bitwise, float ops
    within ``DET_TOL`` of max. ``box_nms`` and the RPN's NMS on the same
    rows bitwise; rows kept on one side only by ``MultiBoxDetection`` or
    ``Proposal`` (a decoded box an ``exp`` ulp apart) are counted. The
    control-flow trio, and ``nd.contrib.foreach`` over an LSTM cell at the
    LSTM LM's width (b128, 35 steps, 1500 hidden) forward and backward,
    its first rows against the CPU. (b) SSD300 on VOC at b32: anchors
    from ``MultiBoxPrior`` over the six maps of MXNet 1.6's
    VGG16-reduced 300 network (8732), ``MultiBoxTarget`` with up to 20
    boxes an image and negative mining ratio 3, the softmax CE plus
    ``smooth_l1`` loss over (32, 21, 8732) / (32, 34928) predictions and
    its gradient, ``MultiBoxDetection`` (NMS 0.45, top 400), each timed
    with the peak memory. (c) Faster R-CNN C4 at 600x1000 (a 38x63 map):
    ``Proposal`` at its defaults, ``ROIAlign`` of its 300 rois over 1024
    channels (14x14, forward and backward), R-FCN's ``PSROIPooling`` (21 x
    7 x 7) and a 3x3 ``DeformableConvolution`` (dilation 2, 512
    channels), each timed. No flash kernel may launch.
18. **Quant phase: the Custom op and INT8 (item 8 step 5).** (a)
    ``resnet50_v1()`` from ``Xavier()`` exported as the symbol phase does,
    its head ``sym.Custom(fc, label, op_type="chip_softmax")`` running
    ``example/numpy-ops/custom_softmax.py``'s numpy softmax: one b32
    step's parameter gradients through ``Module`` against the same step
    with ``SoftmaxOutput`` (within ``QUANT_GRAD_TOL`` of each gradient's
    max), 8 SGD steps (ms a step beside the symbol phase's), the op alone
    forward and backward against ``SoftmaxOutput`` (the host round trip);
    a hybridized block ending in ``nd.Custom`` served through
    ``InferenceEngine`` (its signature eager and counted under
    ``host_eager``, its answers the block's), and a block that reads a
    value to the host outside a host op still fails its capture. (b) The
    same net's BatchNorm statistics from 3 training-mode forwards, its
    fp32 and bf16 replays, ``quantize_net(calib_mode="naive")`` on 4
    calibration batches (54 layers swapped: 53 convolutions folded with
    their BatchNorm, and the Dense); b32 int8 inference, every layer's
    int32 accumulators bitwise against the plain version (a float64
    product) on the same int8 inputs, eager and replayed, the peak
    memory, top-1 agreement with the fp32 net; the same quantized net on
    the CPU from its ``.params`` file (4 rows: logits within
    ``QUANT_LOGIT_TOL``, int8 values off by one counted); the ``.params``
    round trip bitwise; ``quantize_model`` on the exported symbol; every
    one of the 26 names once against the CPU, bitwise. No flash kernel
    may launch.
19. **Sparse phase: sparse storage and the graph ops (item 8 step 6).**
    (c) MXNet 1.6's ``example/sparse/linear_classification`` at Avazu's
    width: a (1,000,001, 1) fp32 weight, CSR batches of 8192 rows with 15
    nonzeros a row (one hashed feature in each of 15 disjoint field
    ranges, value 1), ``sparse.dot(csr, w)`` plus a bias, the logistic
    loss, the row-sparse gradient ``dot(csr.T, g)`` over the touched rows
    and SGD's lazy update (lr 0.1, wd 1e-4), 20 steps: twice on the card
    (bitwise), on the CPU and in float64 numpy (within
    ``SPARSE_CPU_ULPS`` and ``SPARSE_TRUTH_ULPS`` float32 ulps of the
    largest weight), the untouched rows bitwise unchanged, ms a step. (d)
    The 7 graph names on a CSR graph on the card (20,000 vertices, 8
    neighbours each) against the CPU, bitwise; ``LeakyReLU`` rrelu in
    training at ResNet-50's first activation. No flash kernel may launch.

20. **Mesh phase: distribution inside one process (item 10a).** (a)
    ``transformer_lm_base`` at the training phase's configuration (b32 x
    s512, fp32, Adam at lr 1e-4, 4 steps over 4 numpy batches) under
    ``ShardedTrainer(mesh=make_mesh(dp=2, tp=2, devices=[gpu(0)] * 4),
    param_rules=tp_rules())`` and on one device from the same weights:
    losses agree to ``MESH_LOSS_RTOL``, the final parameters within
    ``MESH_PARAM_ATOL`` and Adam's moments within ``MESH_STATE_RTOL`` of
    their largest magnitude (limits from readings, see their comment; the
    largest gaps are printed; a gap that is not finite fails); two planted
    controls (replica 1's gradient left out, the gradient sum doubled) must
    each break one of those limits; every ``tp_rules()`` parameter holds
    half of itself at each position; the mesh run launches the flash
    forward, dQ and dK/dV on (B, S, H, D) 2 replicas x 4 steps x 12 layers
    times each and no (B, H, S, D) kernel (the backward wrappers count by
    layout); ms a step, both runs. With more than one
    visible GPU (a) runs again with the four positions over distinct GPUs.
    (b) ``ring_attention_sharded`` over ``make_mesh(dp=1, sp=4)`` at the
    long-context demo's widths (seq 4096, 4 heads, dim 64), causal and
    not, against dense attention in float64 (``MESH_RING_ATOL``). (c)
    ``moe_lm_tiny`` under ``plan_sharding(4, profile, force="dp=2,pp=1,
    ep=2")``: four replicas, each MoE layer routing the gathered token
    pool; 3 Adam steps whose losses equal the one-device trainer's within
    ``MESH_MOE_RTOL``. (d) (a)'s mesh trainer checkpointed after
    step 2 (``save_checkpoint``) and restored into a fresh trainer: steps
    3-4 equal the uninterrupted run bit for bit (losses and parameters).
    (e) ResNet-50 v1 b32 fp32 as the symbol phase exports it, bound with
    ``MXNET_SUBGRAPH_BACKEND=TPU_ELEMWISE``: its inference output equals
    the unpartitioned bind bit for bit; both replays' ms. (f) A ``device``
    kvstore with ``2bit`` compression (threshold 0.05, two (1024, 1024)
    copies a push, 4 pushes) on the card equals the same on the CPU bit
    for bit. The phase prints ``torch.cuda.device_count()``.
21. **Dist phase: several processes and training resilience (items 10b,
    11a).** (a) The launcher (``python -m mxnet_tpu_torch.tools.launch -n
    2``) starts two workers (this script with ``--dist-worker``) on
    ``cuda:0``; the backend rule gives gloo (two ranks share the card).
    Each trains ``transformer_lm_base`` (768 x 12, vocab 32000, max_len
    512; the mesh phase's weights) in fp32 with ``gluon.Trainer(...,
    "adam", MESH_ADAM, kvstore="dist_sync")`` on its b16 x 512 half of
    each of 4 global b32 batches, ``step(32)``. Rank 0's losses, parameters
    and Adam moments are held against one process that takes the two
    halves in turn and sums their gradients (bit for bit: a two-operand
    sum commutes) and against one context at b32 (``DIST_*`` limits); the
    ranks' parameters must be bitwise equal. Two planted controls run in
    the same workers (rank 1's push left out; the cross-process sum
    doubled) and must break the b32 limits. Each worker reports its step
    ms, the all-reduce's ms and bytes a step and its own launches of each
    (B, S, H, D) flash kernel (12 a step). (b) Before (a) the workers run
    ``tests/dist_torch/dist_sync_kvstore_worker.py``'s invariants on CUDA
    tensors. (c) ``--supervise -n 2``: full replicas of a 768-wide 2-layer
    LM (b8 x 512, 6 steps, a checkpoint every 2; ``tests/dist_torch/
    elastic_worker.py``); rank 1 dies with ``host_loss`` (exit 137) at step
    3, the supervisor evicts it and generation 1 resumes through
    ``elastic_fit``, bitwise equal to a restore-and-replay of the same
    checkpoint in a fresh process and to an uninterrupted run; beside it,
    a real SIGTERM to rank 1 gives an emergency checkpoint in the grace
    window and exit 75, and the restart ends bitwise equal to the
    uninterrupted run. (d) ``GuardedStep`` over ``ShardedTrainer`` at
    ``transformer_lm_base`` b32 x 512 fp32 Adam with dynamic scaling from
    2^15, 6 steps, step 3's batch poisoned (``trainer.grads``, ``nan``):
    step 3 leaves parameters, moments and the optimizer's step bitwise,
    halves the scale and counts one skip; steps 1-2 and 4-6 equal an
    unguarded run over batches 1, 2, 4, 5, 6 bit for bit; under
    ``torch.cuda.set_sync_debug_mode("warn")`` a guarded step warns no
    more than an unguarded one. (e) ``parallel.initialize`` with NCCL, a
    world of one: the store's all-reduce and a barrier through it (NCCL
    between ranks needs a second card).

The predict phase's bf16 pass (8.) holds the kernel path to the plain
path by ``PREDICT_BF16_FACTOR``, each path's distance from the fp32 path:
each bucket's pooled output; the NSP logits over all the rows it checks
(every bucket and the ROADMAP C10 case, the inputs on which a per-bucket
NSP rule failed); and each bucket's attention, layer by layer, against
the float64 attention of that layer's inputs.

With ``--profile`` the burst is served a second time, serving v2's part
(f) is profiled, and two fp32 and two bf16 training steps, two bf16 BERT
steps and two bf16 BERT steps each with LAMB and Adam (surface phase),
one bf16 ResNet-50 step and one b32 bf16 ResNet-50 eager forward (vision
phase), one fp32 ``Module`` step (symbol phase), one b32 int8 ResNet-50
eager forward (quant phase), one sparse linear step (sparse phase) and
two fp32 steps of the mesh phase's dp=2 x tp=2 trainer and of its
one-device trainer are run, under
``torch.profiler`` (after the checked runs) to print the device's busy
share, its kernel count and its top kernels.

Prints the serving, serving v2, training, BERT, surface, predict,
autograd, registry-op, vision, data, rnn, symbol, ops, np, detection,
quant, sparse, mesh and dist numbers, one
``{"kernels": [...]}`` line with an
entry per TPU kernel (the three (B, S, H, D) ones with the numbers of the
training shape in fp32, under ``*_bf16`` keys in bf16, and under ``bert``
those of the BERT shape; the three (B, H, S, D) ones with the numbers of
the registry op's shape; every kernel's launches also under ``vision``,
``data``, ``rnn``, ``ops``, ``np``, ``detection``, ``quant`` and
``sparse``, where none runs,
``symbol``, ``mesh``: the (a) mesh run's, and ``dist``: the dist
phase's (a) workers' and (d) runs'),
the
card's name
and power limit,
the whole script's seconds, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line. Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PROMPT_LENS = (5, 37, 100, 128, 200, 511, 700, 1000)
NEW_TOKENS = 32
LADDER = (16, 32, 64, 128, 256, 512, 1024)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
SOURCES = ("flash_attn_fwd", "flash_attn_bwd")
PALLAS = "mxnet_tpu/ops/pallas_kernels.py:%d"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 512, 8
LOSS_RTOL = 1e-4      # first fp32 step, kernel path vs plain path
GRAD_TOL = 1e-3       # of each gradient's largest |value|
# BERT pretraining: the reference bench's configuration
# (benchmark/bench_lm.py:107-150)
BERT_BATCH, BERT_SEQ, BERT_MASKS, BERT_VOCAB, BERT_STEPS = 64, 128, 20, \
    30522, 8
# bf16, kernel path vs plain path: both round activations to bf16 (2^-8
# relative) op by op, in other places (the kernel rounds P once, the plain
# path its scores and softmax), through 12 layers. Gradients that cancel
# over the batch (the NSP bias: 64 terms of about +-0.5) are far off in
# either path, so the bf16 gradients are held against the fp32 plain path
# on the same weights instead: the kernel path's worst distance at most
# twice the bf16 plain path's.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_FACTOR = 2.0
# the Gluon training surface: LAMB as the reference's BERT recipe takes it
SURFACE_STEPS = 8
SURFACE_LAMB = {"learning_rate": 1e-4, "wd": 0.01}
# clip_global_norm over the gradient of the batch's summed loss: 0.25 a
# sample (example/gluon/word_language_model.py clips 0.25 x bptt x batch)
SURFACE_CLIP = 0.25 * TRAIN_BATCH
# the first eager step against ShardedTrainer's: the same mean, the same
# kernels, the batch's 1/B applied at another point
SURFACE_LOSS_RTOL = 1e-6
SURFACE_PARAM_TOL = 1e-5


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def live_tensors(torch, top=8):
    """The largest CUDA tensors still alive, with what holds them (the
    types of their referrers, two levels up): what a failed memory check
    prints."""
    found = []
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                found.append(obj)
        except Exception:  # noqa: BLE001 — objects that refuse inspection
            continue
    found.sort(key=lambda t: -t.untyped_storage().nbytes())
    out = []
    for t in found[:top]:
        holders = []
        for r in gc.get_referrers(t):
            if r is found:
                continue
            up = [type(q).__name__ for q in gc.get_referrers(r)
                  if q is not found][:4]
            holders.append("%s<-%s" % (type(r).__name__, "/".join(up)))
        out.append("%s %s %d B held by %s" % (
            tuple(t.shape), t.dtype, t.untyped_storage().nbytes(),
            ", ".join(holders[:4])))
    return "; ".join(out)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def random_params(model, seed):
    """Reference-named parameters (``transformerlm0_...``) drawn with
    numpy: N(0, 0.02) weights and biases, LayerNorm gamma 1 and beta 0."""
    from mxnet_tpu_torch import convert
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("gamma"):
            arr = np.ones(shape, np.float32)
        elif name.endswith("beta"):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * 0.02
        out[name] = arr
    import torch
    return convert.mxnet_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in out.items()})


def stream_generate(url, prompt, results, idx):
    body = json.dumps({"prompt": prompt, "max_new_tokens": NEW_TOKENS,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(url + "/generate", data=body,
                                 method="POST")
    t0 = time.perf_counter()
    lines = []
    first = None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            if first is None:
                first = time.perf_counter() - t0
            lines.append(json.loads(raw))
    results[idx] = {"lines": lines, "ttft_s": first,
                    "total_s": time.perf_counter() - t0}


def run_burst(url, prompts):
    """All prompts at once, one client thread each; (results, wall s)."""
    results = [None] * len(prompts)
    threads = [threading.Thread(target=stream_generate,
                                args=(url, p, results, i))
               for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def profile(torch, fn, match=None):
    """``fn()`` once more under ``torch.profiler``: the device's busy time
    (sum of kernel times; one stream) against the wall time, and the
    kernels that took the most device time; with ``match`` (a regex), also
    every kernel whose name it finds, and their share of the busy time."""
    from torch.profiler import ProfilerActivity, profile as _profile
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls, us = per.get(e.name, (0, 0.0))
            per[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / (wall * 1e6),
           "kernels_launched": sum(c for c, _ in per.values()),
           "top_kernels": [{"name": n[:90], "calls": c, "ms": us / 1e3}
                           for n, (c, us) in top]}
    if match is not None:
        hit = {n[:120]: {"calls": c, "ms": us / 1e3}
               for n, (c, us) in per.items() if match.search(n)}
        out["matched"] = hit
        out["matched_share_of_busy"] = sum(
            v["ms"] for v in hit.values()) * 1e3 / max(busy_us, 1e-9)
    return out


def serving_phase(args, torch):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import transformer_lm_base
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                    GenerationScheduler)
    dev = torch.device("cuda")
    model = transformer_lm_base(vocab_size=32000, max_len=2048, device=dev)
    convert.load_mxnet_params(model, random_params(model, args.seed))
    model.eval()
    eng = DecodeEngine(model, num_slots=8, max_seq=2048, ladder=LADDER,
                       dtype="float32", seed=args.seed, device=dev,
                       prefix_cache=False, chunk=0)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(0, 32000, n).tolist() for n in PROMPT_LENS]
    # warm-up (library handles, kernel load), outside the measured run
    slot = eng.cache.acquire()
    eng.prefill(slot, prompts[0])
    eng.decode_step(np.zeros(eng.num_slots, np.int64),
                    np.zeros(eng.num_slots, np.float32))
    eng.cache.release(slot)
    torch.cuda.synchronize()
    sched = GenerationScheduler(eng)
    srv = ModelServer(None, port=0, generator=sched).start()
    try:
        prefills0 = eng.stats()["prefill_total"]
        captures0 = prefill_captures(eng)
        fa.reset_launches()
        results, wall = run_burst(srv.url, prompts)
        torch.cuda.synchronize()
        launches = fa.flash_attention_bshd.launches + \
            fa.flash_attention.launches
        if fa.flash_attention_bwd_dq.launches or \
                fa.flash_attention_bwd_dkv.launches:
            fail("serving launched a backward kernel")
        prefills = eng.stats()["prefill_total"] - prefills0
        captures = prefill_captures(eng) - captures0
        compile_st = eng.compile_stats()
        snap = sched.metrics.snapshot()
        prof = profile(torch, lambda: run_burst(srv.url, prompts)) \
            if args.profile else None
    finally:
        srv.stop()
        sched.close()
        eng.close()
    streams = []
    for n, res in zip(PROMPT_LENS, results):
        if res is None:
            fail("request with a %d-token prompt got no reply" % n)
        done = res["lines"][-1]
        want = {"done": True, "reason": "length", "n_tokens": NEW_TOKENS}
        if any(done.get(k) != v for k, v in want.items()):
            fail("prompt %d: stream ended %r" % (n, done))
        toks = [x["token"] for x in res["lines"][:-1]]
        if len(toks) != NEW_TOKENS or not all(0 <= t < 32000 for t in toks):
            fail("prompt %d: bad tokens %r" % (n, toks))
        streams.append(toks)
    if prefills != len(prompts):
        fail("%d prefills for %d requests" % (prefills, len(prompts)))
    check_compile(compile_st, "serving")
    if not captures or \
            launches != CAPTURE_RUNS * captures * model.num_layers:
        fail("flash kernel launched %d times for %d prefill captures x %d "
             "layers" % (launches, captures, model.num_layers))
    checked = []
    for idx in np.argsort(PROMPT_LENS)[-2:]:
        check_reprefill(torch, model, prompts[idx], streams[idx], "serving")
        checked.append(PROMPT_LENS[idx])
    ttfts = sorted(r["ttft_s"] for r in results)
    return {
        "model": "transformer_lm_base", "requests": len(prompts),
        "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
        "prefills": prefills, "prefill_captures": captures,
        "flash_launches": launches, "compile": compile_st,
        "ttft_ms_p50_client": 1e3 * float(np.median(ttfts)),
        "ttft_ms_server": snap["ttft_ms"],
        "decode_tokens_s": snap["decode_tokens_s"],
        "step_ms_mean": snap["step_ms_mean"],
        "prefill_ms_mean": snap["prefill_ms_mean"],
        "wall_s": wall, "greedy_reprefill_checked": checked,
        "profile": prof,
    }


# serving v2: the shared system prompt of chat and agent deployments
# (benchmark/generation_bench.py:172) at the card's widths
SYSTEM_LEN, SUFFIX_LENS, PREFIX_BLOCK, CHUNK = 640, (7, 19, 33, 48, 64, 80,
                                                     101, 120), 128, 128
LIVE_LEN, LIVE_TOKENS, LONG_LEN, BEYOND_LEN = 100, 96, 1000, 1900
SPEC_K = 4
# (c)'s bursts are short (~0.4-0.8 s): each run serves it this many times
SPEC_REPEATS = 3
# (f): calls of each program per timing
PROGRAM_CALLS = 10
# device memory still allocated once both serving phases have returned:
# an engine's arena alone is 1.21 GB
LEFTOVER_BYTES = 512 << 20
# a speculative stream's comparison with the plain one stops where the
# plain path's top-2 logit margin is under this share of its largest
# |logit|: GEMMs of another M (the verify's k + 1 rows against the decode
# step's 1) may round the last bits otherwise
NEAR_TIE = 1e-5


def flash_launches():
    from mxnet_tpu_torch.ops import flash_attention as fa
    return fa.flash_attention_bshd.launches + fa.flash_attention.launches


# a CachedOp runs a program twice when it captures it (on a side stream,
# then into the graph), and a replay launches nothing that the wrappers
# count: a prefill program's flash kernels launch 2 x layers times at
# each capture and never again
CAPTURE_RUNS = 2


def prefill_captures(*engines):
    """Prefill signatures captured by ``engines`` (each one a CUDA graph;
    counted on closed engines too)."""
    return sum(e.compile_stats()["prefill"]["misses"] for e in engines)


def check_compile(stats, what):
    """The churn contract: one decode graph, at most one prefill graph a
    ladder rung, whatever joined and left the batch."""
    if stats["decode"]["misses"] != 1 or \
            stats["prefill"]["misses"] > len(LADDER):
        fail("%s: %d decode and %d prefill captures (ladder %d)"
             % (what, stats["decode"]["misses"], stats["prefill"]["misses"],
                len(LADDER)))


def reprefill_logits(torch, model, prompt, toks):
    """One causal forward over ``prompt + toks[:-1]`` on the plain
    attention path (it must launch no kernel): row ``i`` of the result
    predicts ``toks[i]``."""
    seq = torch.tensor([list(prompt) + list(toks[:-1])], device=model.device)

    def run():
        with torch.no_grad():
            return model(seq)[0, len(prompt) - 1:]

    logits = on_plain_path(run, "greedy re-prefill")
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits on the plain path")
    return logits


def check_reprefill(torch, model, prompt, toks, what):
    """Greedy by re-prefill: position ``len(prompt) - 1 + i`` of one
    forward must predict streamed token ``i``."""
    ref = reprefill_logits(torch, model, prompt, toks).argmax(dim=-1).tolist()
    if ref != list(toks):
        fail("%s: prompt %d: stream %r != re-prefill %r"
             % (what, len(prompt), list(toks), ref))


def compare_exact(torch, model, prompt, plain, got, what, ties):
    """``got`` must equal ``plain`` token for token. At the first
    difference, a near tie of the plain path there (by re-prefill) ends the
    comparison and is recorded in ``ties``; anything else fails."""
    if got == plain:
        return
    i = next((j for j, (a, b) in enumerate(zip(plain, got)) if a != b),
             min(len(plain), len(got)))
    if i >= len(plain):
        fail("%s: prompt %d: stream %r != plain %r"
             % (what, len(prompt), got, plain))
    logits = reprefill_logits(torch, model, prompt, plain[:i + 1])[-1]
    top = logits.topk(2).values
    margin = float(top[0] - top[1])
    scale = float(logits.abs().max())
    if margin >= NEAR_TIE * scale:
        fail("%s: prompt %d: token %d is %r, the plain path's %r (top-2 "
             "margin %.3g of max |logit| %.3g)"
             % (what, len(prompt), i, got[i:i + 1], plain[i], margin, scale))
    tie = {"what": what, "prompt_len": len(prompt), "position": i,
           "margin": margin, "max_abs_logit": scale}
    print("serving v2: near tie %s" % json.dumps(tie))
    ties.append(tie)


def spans():
    """Count and mean host ms of each generation span since the last call
    (the tracer is on through serving v2), then reset. The draft engine's
    programs are ``generation.draft.*``. A span's host time is not its
    program's device time: a chunk call ends without a sync, and a span
    may open by waiting on earlier launches; part (f) times the programs
    on the device."""
    from mxnet_tpu_torch.observability import tracer
    out = {name: {"count": st["count"], "mean_ms": st["mean_ms"]}
           for name, st in tracer.phase_stats().items()
           if name.startswith("generation.")}
    tracer.reset_phase_stats()
    return out


def v2_engine(args, dev, model, chunk, prefix_cache, name):
    from mxnet_tpu_torch.serving.generation import DecodeEngine
    return DecodeEngine(model, num_slots=8, max_seq=2048, ladder=LADDER,
                        dtype="float32", seed=args.seed, device=dev,
                        chunk=chunk, prefix_cache=prefix_cache, name=name)


def sched_burst(sched, prompts, n):
    """Every prompt submitted at once, ``n`` tokens each; (streams, wall
    s, requests). Each stream must end by its budget."""
    t0 = time.perf_counter()
    reqs = [sched.submit(p, max_new_tokens=n) for p in prompts]
    streams = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    for p, r, toks in zip(prompts, reqs, streams):
        if r.finish_reason != "length" or len(toks) != n or \
                not all(0 <= t < 32000 for t in toks):
            fail("%s: prompt %d ended %r with %r"
                 % (sched.name, len(p), r.finish_reason, toks))
    return streams, wall, reqs


def v2_prefix(args, torch, model, dev):
    """(a) A shared system prompt, cold and then through the prefix
    cache."""
    from mxnet_tpu_torch.serving.generation import (GenerationScheduler,
                                                    PrefixCache)
    rng = np.random.default_rng(args.seed + 2)
    system = rng.integers(0, 32000, SYSTEM_LEN).tolist()
    prompts = [system + rng.integers(0, 32000, n).tolist()
               for n in SUFFIX_LENS]
    prime = system + rng.integers(0, 32000, 5).tolist()
    f0 = flash_launches()
    eng = v2_engine(args, dev, model, CHUNK, False, "v2.cold")
    sched = GenerationScheduler(eng, name="v2.cold")
    try:
        spans()
        cold, cold_wall, _ = sched_burst(sched, prompts, NEW_TOKENS)
        cold_snap = sched.metrics.snapshot()
        cold_spans = spans()
    finally:
        sched.close()
        eng.close()
    pc = PrefixCache(block=PREFIX_BLOCK, name="v2.prefix")
    eng = v2_engine(args, dev, model, CHUNK, pc, "v2.warm")
    try:
        primer = GenerationScheduler(eng, name="v2.primer")
        try:
            primer.generate(prime, max_new_tokens=1)
        finally:
            primer.close()
        eng.prefix_flush()
        store = pc.stats()
        stored_tokens = sum(range(PREFIX_BLOCK, SYSTEM_LEN + 1,
                                  PREFIX_BLOCK))
        if store["entries"] != SYSTEM_LEN // PREFIX_BLOCK or \
                store["bytes"] != stored_tokens * 2 * model.num_layers * \
                model.num_heads * model.head_dim * 4:
            fail("prefix cache after priming: %r" % store)
        sched = GenerationScheduler(eng, name="v2.warm")
        try:
            spans()
            warm, warm_wall, reqs = sched_burst(sched, prompts, NEW_TOKENS)
            warm_snap = sched.metrics.snapshot()
            warm_spans = spans()
            st = sched.stats()
        finally:
            sched.close()
        if st["prefix_hits"] != len(prompts) or \
                st["prefix_tokens_saved"] != len(prompts) * SYSTEM_LEN or \
                any(r.prefix_skipped != SYSTEM_LEN for r in reqs):
            fail("warm pass: %d hits saving %d tokens (%r)"
                 % (st["prefix_hits"], st["prefix_tokens_saved"],
                    [r.prefix_skipped for r in reqs]))
        for p, a, b in zip(prompts, cold, warm):
            if a != b:
                fail("prompt %d: warm stream %r != cold %r" % (len(p), b, a))
        # a cold and a hit slot, by direct engine calls: bitwise rows
        p = prompts[-1]
        n = len(p)
        s_cold = eng.cache.acquire()
        s_hit = eng.cache.acquire()
        _, tok_cold = eng.prefill_chunks(s_cold, p, 0)
        skipped = eng.prefix_admit(s_hit, p)
        _, tok_hit = eng.prefill_chunks(s_hit, p, skipped)
        rows_equal = all(
            torch.equal(a[:, s_cold, :n], a[:, s_hit, :n])
            for a in (eng.cache.k_arena, eng.cache.v_arena))
        if skipped != SYSTEM_LEN or tok_cold != tok_hit or not rows_equal:
            fail("hit slot vs cold slot: skipped %d, first tokens %d/%d, "
                 "rows bitwise equal %s" % (skipped, tok_cold, tok_hit,
                                            rows_equal))
        eng.cache.release(s_cold)
        eng.cache.release(s_hit)
    finally:
        eng.close()
        pc.close()
    flash = flash_launches() - f0
    if flash:
        fail("the prefix-cache passes launched the flash kernel %d times"
             % flash)
    for idx in np.argsort(SUFFIX_LENS)[-2:]:
        check_reprefill(torch, model, prompts[idx], warm[idx], "warm")
    return {"system_len": SYSTEM_LEN, "suffix_lens": list(SUFFIX_LENS),
            "block": PREFIX_BLOCK, "chunk": CHUNK, "hits": st["prefix_hits"],
            "tokens_saved": st["prefix_tokens_saved"],
            "slab_entries": store["entries"], "slab_tokens": stored_tokens,
            "slab_bytes": store["bytes"],
            "ttft_ms_cold": cold_snap["ttft_ms"],
            "ttft_ms_warm": warm_snap["ttft_ms"],
            "wall_s_cold": cold_wall, "wall_s_warm": warm_wall,
            "prefill_ms_mean_cold": cold_snap["prefill_ms_mean"],
            "prefill_ms_mean_warm": warm_snap["prefill_ms_mean"],
            "rows_bitwise_equal": rows_equal, "flash_launches": flash,
            "spans_cold": cold_spans, "spans_warm": warm_spans}


def nearest_rank(values, q):
    vals = sorted(values)
    return vals[min(len(vals) - 1, max(0, int(np.ceil(q / 100.0
                                                      * len(vals))) - 1))]


def v2_chunked(args, torch, model, dev):
    """(b) Live streams while a long prompt prefills, monolithic and
    chunked; then a prompt beyond the ladder."""
    from mxnet_tpu_torch.serving.generation import GenerationScheduler
    rng = np.random.default_rng(args.seed + 4)
    live_prompts = [rng.integers(0, 32000, LIVE_LEN).tolist()
                    for _ in range(3)]
    long_prompt = rng.integers(0, 32000, LONG_LEN).tolist()
    runs = {}
    for label, chunk in (("monolithic", 0), ("chunked", CHUNK)):
        f0 = flash_launches()
        eng = v2_engine(args, dev, model, chunk, False, "v2." + label)
        sched = GenerationScheduler(eng, name="v2." + label)
        stamps = [[] for _ in live_prompts]
        spans()
        try:
            live = [sched.submit(p, max_new_tokens=LIVE_TOKENS)
                    for p in live_prompts]
            threads = [threading.Thread(
                target=lambda r=r, st=st: st.extend(
                    time.perf_counter() for _ in r.tokens(timeout=600)))
                for r, st in zip(live, stamps)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 600
            while any(len(st) < 8 for st in stamps):
                if time.monotonic() > deadline:
                    fail("%s: live streams stalled" % label)
                time.sleep(0.001)
            long_req = sched.submit(long_prompt, max_new_tokens=8)
            long_toks = long_req.result(timeout=600)
            for t in threads:
                t.join(600)
            for r in live:
                if r.finish_reason != "length" or \
                        len(r.tokens_out) != LIVE_TOKENS:
                    fail("%s: live stream ended %r after %d tokens"
                         % (label, r.finish_reason, len(r.tokens_out)))
            chunks = eng.stats()["chunk_total"]
        finally:
            sched.close()
            eng.close()
        captures = prefill_captures(eng)
        gaps = [b - a for st in stamps for a, b in zip(st, st[1:])]
        runs[label] = {
            "chunk": chunk, "inter_token_p99_ms": 1e3 * nearest_rank(gaps, 99),
            "inter_token_max_ms": 1e3 * max(gaps),
            "inter_token_p50_ms": 1e3 * nearest_rank(gaps, 50),
            "long_ttft_ms": 1e3 * (long_req.first_token_t
                                   - long_req.enqueue_t),
            "long_tokens": long_toks, "chunk_calls": chunks,
            "prefill_captures": captures,
            "flash_launches": flash_launches() - f0, "spans": spans()}
    want = {"monolithic": CAPTURE_RUNS * model.num_layers
            * runs["monolithic"]["prefill_captures"], "chunked": 0}
    if not runs["monolithic"]["prefill_captures"]:
        fail("monolithic: no prefill captured")
    for label, n in want.items():
        if runs[label]["flash_launches"] != n:
            fail("%s: %d flash launches, want %d"
                 % (label, runs[label]["flash_launches"], n))
    eng = v2_engine(args, dev, model, CHUNK, False, "v2.beyond")
    sched = GenerationScheduler(eng, name="v2.beyond")
    beyond = rng.integers(0, 32000, BEYOND_LEN).tolist()
    try:
        toks = sched.generate(beyond, max_new_tokens=16)
        chunks = eng.stats()["chunk_total"]
    finally:
        sched.close()
        eng.close()
    if chunks != -(-BEYOND_LEN // CHUNK):
        fail("%d-token prompt took %d chunks" % (BEYOND_LEN, chunks))
    check_reprefill(torch, model, beyond, toks, "beyond the ladder")
    runs["beyond_ladder"] = {"prompt_len": BEYOND_LEN, "chunk_calls": chunks,
                             "tokens": len(toks)}
    return runs


def v2_speculative(args, torch, model, dev, ties):
    """(c) The serving burst plain, with a self-draft and with an
    independent draft; both token-exact against the plain run."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_base
    from mxnet_tpu_torch.serving.generation import (GenerationScheduler,
                                                    SpeculativeDecoder)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(0, 32000, n).tolist() for n in PROMPT_LENS]
    self_draft = transformer_lm_base(vocab_size=32000, max_len=2048,
                                     device=dev)
    convert.load_mxnet_params(self_draft, random_params(self_draft,
                                                        args.seed))
    small = TransformerLM(32000, units=256, num_layers=2, num_heads=4,
                          max_len=2048, device=dev)
    convert.load_mxnet_params(small, random_params(small, args.seed + 7))
    runs, plain = {}, None
    for label, draft in (("plain", None), ("self_draft", self_draft.eval()),
                         ("independent_draft", small.eval())):
        f0 = flash_launches()
        eng = v2_engine(args, dev, model, 0, False, "v2.spec." + label)
        spec = None if draft is None else SpeculativeDecoder(eng, draft,
                                                             k=SPEC_K)
        sched = GenerationScheduler(eng, speculative=spec,
                                    name="v2.spec." + label)
        spans()
        walls = []
        try:
            for _ in range(SPEC_REPEATS):
                streams, wall, _ = sched_burst(sched, prompts, NEW_TOKENS)
                walls.append(wall)
                if plain is None:
                    plain = streams
                for p, a, b in zip(prompts, plain, streams):
                    compare_exact(torch, model, p, a, b, label, ties)
            snap = sched.metrics.snapshot()
            sst = None if spec is None else spec.stats()
            run_spans = spans()
        finally:
            sched.close()
            if spec is not None:
                spec.close()
            eng.close()
        flash = flash_launches() - f0
        captures = prefill_captures(eng)
        if flash != CAPTURE_RUNS * captures * model.num_layers:
            fail("%s: %d flash launches for %d prefill captures"
                 % (label, flash, captures))
        if spec is None:
            check_compile(eng.compile_stats(), label)
        tokens_s = sorted(len(prompts) * NEW_TOKENS / w for w in walls)
        run = {"walls_s": walls, "tokens_s": tokens_s[len(walls) // 2],
               "tokens_s_min": tokens_s[0], "tokens_s_max": tokens_s[-1],
               "decode_tokens_s": snap["decode_tokens_s"],
               "steps": snap["steps"], "step_ms_mean": snap["step_ms_mean"],
               "flash_launches": flash, "spans": run_spans}
        if sst is not None:
            run.update(acceptance_rate=sst["acceptance_rate"],
                       rounds=sst["rounds"], syncs=sst["syncs"],
                       drafted=sst["drafted"], accepted=sst["accepted"])
        runs[label] = run
    runs["k"] = SPEC_K
    return runs


def v2_lanes(args, torch, model, dev):
    """(d) A prefill lane hands a prompt to a decode lane through one
    prefix cache."""
    from mxnet_tpu_torch.serving.generation import (GenerationScheduler,
                                                    PrefixCache)
    prompt = np.random.default_rng(args.seed + 5).integers(
        0, 32000, 700).tolist()
    pc = PrefixCache(block=PREFIX_BLOCK, name="v2.lanes")
    pre_eng = v2_engine(args, dev, model, CHUNK, pc, "v2.lane.prefill")
    dec_eng = v2_engine(args, dev, model, CHUNK, pc, "v2.lane.decode")
    pre = GenerationScheduler(pre_eng, lane_policy="prefill",
                              name="v2.lane.prefill")
    dec = GenerationScheduler(dec_eng, lane_policy="decode",
                              name="v2.lane.decode")
    try:
        req = pre.submit(prompt, max_new_tokens=NEW_TOKENS)
        first = req.result(timeout=600)
        pre_eng.prefix_flush()
        dreq = dec.submit(prompt, max_new_tokens=NEW_TOKENS)
        got = dreq.result(timeout=600)
        st = dec.stats()
    finally:
        pre.close()
        dec.close()
        pre_eng.close()
        dec_eng.close()
        pc.close()
    if req.finish_reason != "prefill" or len(first) != 1:
        fail("prefill lane ended %r with %r" % (req.finish_reason, first))
    want_skip = (len(prompt) - 1) // PREFIX_BLOCK * PREFIX_BLOCK
    if dreq.prefix_skipped != want_skip or st["decode_lane_misses"] or \
            st["prefix_hits"] != 1:
        fail("decode lane: skipped %d, %d hits, %d misses"
             % (dreq.prefix_skipped, st["prefix_hits"],
                st["decode_lane_misses"]))
    eng = v2_engine(args, dev, model, CHUNK, False, "v2.lane.mixed")
    mixed = GenerationScheduler(eng, name="v2.lane.mixed")
    try:
        want = mixed.generate(prompt, max_new_tokens=NEW_TOKENS)
    finally:
        mixed.close()
        eng.close()
    if got != want or first[0] != want[0]:
        fail("decode lane stream %r != mixed lane %r (prefill lane's first "
             "token %d)" % (got, want, first[0]))
    return {"prompt_len": len(prompt), "prefill_reason": req.finish_reason,
            "decode_prefix_skipped": dreq.prefix_skipped,
            "decode_lane_misses": st["decode_lane_misses"]}


def v2_retry(args, torch, model, dev):
    """(e) Transient step faults absorbed by the retry policy."""
    from mxnet_tpu_torch.resilience import RetryPolicy, chaos
    from mxnet_tpu_torch.serving.generation import GenerationScheduler
    rng = np.random.default_rng(args.seed + 6)
    prompts = [rng.integers(0, 32000, n).tolist() for n in PROMPT_LENS[::2]]
    f0 = flash_launches()
    eng = v2_engine(args, dev, model, 0, False, "v2.retry")
    pol = RetryPolicy(max_attempts=3, base_delay_ms=1.0, jitter=0.0,
                      name="retry.smoke", register=False)
    sched = GenerationScheduler(eng, retry_policy=pol, name="v2.retry")
    try:
        clean, _, _ = sched_burst(sched, prompts, NEW_TOKENS)
        r0 = pol.stats()["retries"]
        chaos.arm("generation.step", "transient", first=2)
        try:
            armed, _, _ = sched_burst(sched, prompts, NEW_TOKENS)
        finally:
            chaos.clear()
        retries = pol.stats()["retries"] - r0
        failures = sched.metrics.snapshot()["step_failures"]
    finally:
        sched.close()
        eng.close()
    flash = flash_launches() - f0
    if armed != clean or retries != 2 or failures:
        fail("under chaos: streams equal %s, %d retries, %d step failures"
             % (armed == clean, retries, failures))
    if flash != CAPTURE_RUNS * prefill_captures(eng) * model.num_layers:
        fail("retry: %d flash launches for %d prefill captures"
             % (flash, prefill_captures(eng)))
    return {"requests": len(prompts), "retries": retries,
            "flash_launches": flash}


def v2_programs(args, torch, model, dev):
    """(f) Each program of serving v2 alone, on an engine whose 8 slots
    hold a 1000-token prompt: ``PROGRAM_CALLS`` back-to-back calls between
    two CUDA events (ms a call on the device's clock, host work included
    where the device waits on it), and with ``--profile`` the same calls
    under ``torch.profiler`` (the kernels' busy ms a call)."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.serving.generation import SpeculativeDecoder
    prompt = np.random.default_rng(args.seed + 8).integers(
        0, 32000, LONG_LEN).tolist()
    small = TransformerLM(32000, units=256, num_layers=2, num_heads=4,
                          max_len=2048, device=dev)
    convert.load_mxnet_params(small, random_params(small, args.seed + 7))
    f0 = flash_launches()
    eng = v2_engine(args, dev, model, CHUNK, False, "v2.programs")
    spec = SpeculativeDecoder(eng, small.eval(), k=SPEC_K)
    zeros = np.zeros(eng.num_slots, np.int64)
    temps = np.zeros(eng.num_slots, np.float32)
    verify_tokens = np.tile(np.asarray(prompt[:SPEC_K + 1], np.int64),
                            (eng.num_slots, 1))
    last = LONG_LEN // CHUNK * CHUNK
    programs = (
        ("prefill_1024_flash", lambda: eng.prefill(0, prompt)),
        ("chunk_128_at_0", lambda: eng.prefill_chunks(
            1, prompt, 0, max_chunks=1, sample=False)),
        ("chunk_128_at_%d" % last, lambda: eng.prefill_chunks(
            1, prompt, last, max_chunks=1, sample=False)),
        ("decode_step", lambda: eng.decode_step(zeros, temps)),
        ("verify_k%d" % SPEC_K, lambda: spec.verify(verify_tokens)),
        ("draft_step", lambda: spec.draft.decode_step(zeros, temps)))
    out = {}
    try:
        for _ in range(eng.num_slots):
            eng.prefill(eng.cache.acquire(), prompt)
        for name, fn in programs:
            fn()                                     # warm-up
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            for _ in range(PROGRAM_CALLS):
                fn()
            t1.record()
            t1.synchronize()
            row = {"ms": t0.elapsed_time(t1) / PROGRAM_CALLS}
            if args.profile:
                prof = profile(torch, lambda: [fn() for _ in
                                               range(PROGRAM_CALLS)])
                row.update(busy_ms=prof["device_busy_ms"] / PROGRAM_CALLS,
                           kernels=prof["kernels_launched"] / PROGRAM_CALLS,
                           top=prof["top_kernels"][:3])
            out[name] = row
    finally:
        spec.close()
        eng.close()
    flash = flash_launches() - f0
    captures = prefill_captures(eng)
    if captures != 1 or flash != CAPTURE_RUNS * model.num_layers:
        fail("programs: %d flash launches for %d prefill captures"
             % (flash, captures))
    return {"calls": PROGRAM_CALLS, "programs": out, "flash_launches": flash,
            "compile": eng.compile_stats()}


def _arenas_equal(torch, a, b):
    return all(torch.equal(getattr(a.cache, k), getattr(b.cache, k))
               for k in ("k_arena", "v_arena"))


def v2_graphs(args, torch, model, dev):
    """(g) The generation programs as CUDA graphs against the same
    programs run eagerly (``DecodeEngine(cached=False)``): the slot swap,
    the decode step's ms and kernels a call, greedy streams of a churned
    burst, and the compile counts after it."""
    from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                    GenerationScheduler)
    rng = np.random.default_rng(args.seed + 9)
    prompt = rng.integers(0, 32000, LONG_LEN).tolist()

    def make(cached, name):
        return DecodeEngine(model, num_slots=8, max_seq=2048, ladder=LADDER,
                            dtype="float32", seed=args.seed, device=dev,
                            chunk=0, prefix_cache=False, name=name,
                            cached=cached)
    f0 = flash_launches()
    graphs, eager = make(True, "v2.graphs"), make(False, "v2.eager")
    out = {}
    try:
        # every program captured on one slot and replayed on another
        # (the slot, the start and the lengths are device tensors)
        for eng in (graphs, eager):
            for _ in range(eng.num_slots):
                eng.cache.acquire()
            first = [eng.prefill(0, prompt[:100]),
                     eng.prefill(3, prompt[100:190])]
            eng.prefill_chunks(5, prompt[:300], 0)
            eng.prefill_chunks(6, prompt[300:590], 0)
            cur = np.asarray(first + [7] * 6, np.int64)
            for _ in range(4):
                cur = eng.decode_step(cur, np.zeros(8, np.float32))
                eng.cache.advance(list(range(8)))
            eng.swap_tokens = cur.tolist()
        st = graphs.compile_stats()
        if st["prefill"]["misses"] != 1 or st["prefill"]["hits"] != 1 or \
                st["chunk"]["misses"] != 1 or st["chunk"]["hits"] != 1 or \
                st["decode"]["misses"] != 1:
            fail("slot swap: captures %r" % {
                k: (v["misses"], v["hits"]) for k, v in st.items()})
        if not _arenas_equal(torch, graphs, eager) or \
                graphs.swap_tokens != eager.swap_tokens:
            fail("slot swap: a graph captured on slot 0 and replayed on "
                 "slot 3 left another arena than the eager programs")
        # the decode step, every slot at a 1000-token prompt
        zeros = np.zeros(8, np.int64)
        temps = np.zeros(8, np.float32)
        for eng in (graphs, eager):
            for slot in range(8):
                eng.prefill(slot, prompt)
        for label, eng in (("replay", graphs), ("eager", eager)):
            eng.decode_step(zeros, temps)
            torch.cuda.synchronize()
            ms = _events_ms(torch, lambda: eng.decode_step(zeros, temps),
                            PROGRAM_CALLS)
            prof = profile(torch, lambda: [eng.decode_step(zeros, temps)
                                           for _ in range(PROGRAM_CALLS)])
            out["decode_" + label] = {
                "ms": ms, "kernels": prof["kernels_launched"] / PROGRAM_CALLS,
                "busy_ms": prof["device_busy_ms"] / PROGRAM_CALLS}
        if not _arenas_equal(torch, graphs, eager):
            fail("decode step: replay and eager arenas differ")
        for eng in (graphs, eager):
            for slot in range(8):
                eng.cache.release(slot)
        # a churned burst: 12 requests of mixed lengths and budgets
        # through 8 slots, greedy, in both engines
        lens = list(PROMPT_LENS) + [17, 64, 300, 90]
        budgets = [8, 16, 24, 32] * 3
        prompts = [rng.integers(0, 32000, n).tolist() for n in lens]
        streams = {}
        for label, eng in (("replay", graphs), ("eager", eager)):
            sched = GenerationScheduler(eng, name="v2.graphs." + label)
            try:
                reqs = [sched.submit(p, max_new_tokens=n)
                        for p, n in zip(prompts, budgets)]
                streams[label] = [r.result(timeout=600) for r in reqs]
            finally:
                sched.close()
        if streams["replay"] != streams["eager"]:
            bad = sum(a != b for a, b in zip(streams["replay"],
                                             streams["eager"]))
            fail("greedy streams: %d of %d differ between replay and eager"
                 % (bad, len(prompts)))
        st = graphs.compile_stats()
        check_compile(st, "churned burst")
        out["compile"] = st
        out["requests"] = len(prompts)
        eager_prefills = eager.stats()["prefill_total"]
    finally:
        graphs.close()
        eager.close()
    flash = flash_launches() - f0
    want = (CAPTURE_RUNS * prefill_captures(graphs) + eager_prefills) * \
        model.num_layers
    if flash != want:
        fail("graphs: %d flash launches, want %d" % (flash, want))
    out["flash_launches"] = flash
    out["eager_prefills"] = eager_prefills
    return out


def serving_v2_phase(args, torch):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import transformer_lm_base
    from mxnet_tpu_torch.observability import tracer
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    model = transformer_lm_base(vocab_size=32000, max_len=2048, device=dev)
    convert.load_mxnet_params(model, random_params(model, args.seed))
    model.eval()
    ties = []
    t0 = time.perf_counter()
    tracer.enable()
    fa.reset_launches()
    try:
        out = {"prefix": v2_prefix(args, torch, model, dev),
               "chunked": v2_chunked(args, torch, model, dev),
               "speculative": v2_speculative(args, torch, model, dev, ties),
               "lanes": v2_lanes(args, torch, model, dev),
               "retry": v2_retry(args, torch, model, dev),
               "programs": v2_programs(args, torch, model, dev),
               "graphs": v2_graphs(args, torch, model, dev)}
    finally:
        tracer.disable()
    launches = kernel_launches()
    if launches["flash_attn_bwd_dq"] or launches["flash_attn_bwd_dkv"]:
        fail("serving v2 launched a backward kernel")
    parts = (out["prefix"]["flash_launches"]
             + sum(out["chunked"][k]["flash_launches"]
                   for k in ("monolithic", "chunked"))
             + sum(out["speculative"][k]["flash_launches"]
                   for k in ("plain", "self_draft", "independent_draft"))
             + out["retry"]["flash_launches"]
             + out["programs"]["flash_launches"]
             + out["graphs"]["flash_launches"])
    flash = launches["flash_attn_fwd"] + launches["flash_attn_fwd_bhsd"]
    if flash != parts or not flash:
        fail("serving v2: %d flash launches, the parts count %d"
             % (flash, parts))
    out.update(near_ties=ties, flash_launches=flash,
               wall_s=time.perf_counter() - t0)
    return out


def lm_batch(seed):
    """Tokens ``(32, 512)`` and their next-token labels (the last -1: the
    loss is over the shifted logits)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 32000, (TRAIN_BATCH, TRAIN_SEQ))
    y = np.concatenate([x[:, 1:], np.full((TRAIN_BATCH, 1), -1)], axis=1)
    return x, y


def train_steps(torch, trainer, x, y, n):
    """``n`` steps; (losses, per-step ms from CUDA events)."""
    return timed_steps(torch, lambda i: trainer.step(x, y), n)


def timed_steps(torch, step, n):
    """``step(i)`` for i in 0..n-1, each returning its loss (a tensor);
    (losses as floats, per-step ms from CUDA events)."""
    events, losses = [], []
    for i in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        losses.append(step(i))
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [float(v) for v in losses], [a.elapsed_time(b) for a, b in events]


def kernel_launches():
    from mxnet_tpu_torch.ops import flash_attention as fa
    return {"flash_attn_fwd": fa.flash_attention_bshd.launches,
            "flash_attn_fwd_bhsd": fa.flash_attention.launches,
            "flash_attn_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attn_bwd_dkv": fa.flash_attention_bwd_dkv.launches}


def on_plain_path(run, what):
    """``run()`` with ``MXNET_FLASH_ATTENTION=0``; it must launch no
    kernel."""
    before = sum(kernel_launches().values())
    os.environ["MXNET_FLASH_ATTENTION"] = "0"
    try:
        res = run()
    finally:
        del os.environ["MXNET_FLASH_ATTENTION"]
    if sum(kernel_launches().values()) != before:
        fail("%s: the plain path launched a kernel" % what)
    return res


def rel_to_max(a, ref):
    return (a.float() - ref.float()).abs().max().item() / max(
        ref.float().abs().max().item(), 1e-30)


def against_plain(run, loss_tol, grad_tol, what, kernel=None, truth=None):
    """``run()`` -> ``(loss, {name: gradient})`` on the kernel path (or
    ``kernel``, its result already taken) and again on the plain path,
    which must launch no kernel: the losses must agree to ``loss_tol``
    relative, and every gradient to ``grad_tol`` of its largest |value|.

    Given ``truth``, the same function in fp32 on the same weights, both
    paths' gradients are held against it instead, each by its distance
    from the truth in units of the truth's largest |value|: the kernel
    path's worst distance must be at most ``grad_tol`` times the plain
    path's worst (the kernel path as accurate as the plain path). Returns
    what was compared."""
    loss_k, grads_k = kernel if kernel is not None else run()
    loss_p, grads_p = on_plain_path(run, what)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if not loss_rel <= loss_tol:
        fail("%s: loss %r != plain path %r (rel %g > %g)"
             % (what, loss_k, loss_p, loss_rel, loss_tol))
    ref = grads_p if truth is None else truth[1]
    err_k = {n: rel_to_max(grads_k[n], r) for n, r in ref.items()}
    worst = max(err_k, key=err_k.get)
    out = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": loss_rel, "loss_tol": loss_tol,
           "grad_worst_param": worst, "grad_worst_rel_to_max": err_k[worst],
           "grad_tol": grad_tol}
    limit = grad_tol
    if truth is not None:
        err_p = {n: rel_to_max(grads_p[n], r) for n, r in ref.items()}
        worst_p = max(err_p, key=err_p.get)
        limit = grad_tol * err_p[worst_p]
        out.update(loss_fp32=truth[0], grad_worst_plain_param=worst_p,
                   grad_worst_plain_rel_to_max=err_p[worst_p],
                   grad_top_kernel=sorted(err_k.items(),
                                          key=lambda kv: -kv[1])[:4],
                   grad_top_plain=sorted(err_p.items(),
                                         key=lambda kv: -kv[1])[:4])
    if err_k[worst] > limit:
        fail("%s: gradient of %s off by %g of its max (limit %g)"
             % (what, worst, err_k[worst], limit))
    return out


def train_phase(args, torch):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import transformer_lm_base
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import ShardedTrainer
    dev = torch.device("cuda")
    model = transformer_lm_base(vocab_size=32000, max_len=TRAIN_SEQ,
                                device=dev)
    convert.load_mxnet_params(model, random_params(model, args.seed))
    x, y = (torch.from_numpy(a).to(dev) for a in lm_batch(args.seed + 2))
    loss_fn = SoftmaxCrossEntropyLoss()

    def trainer(net, dtype=None):
        return ShardedTrainer(net, loss_fn, "adam", {"learning_rate": 1e-4},
                              dtype=dtype, device=dev)

    out = {"model": "transformer_lm_base", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps_per_dtype": TRAIN_STEPS}
    fa.reset_launches()
    for dname in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(model, None if dname == "float32" else dname)
        first, ms0 = train_steps(torch, tr, x, y, 1)
        if dname == "float32":
            grads1 = {n: v.grad.detach().clone()
                      for n, v in tr.values.items()}
        rest, ms = train_steps(torch, tr, x, y, TRAIN_STEPS - 1)
        losses = first + rest
        if not all(np.isfinite(losses)):
            fail("%s training losses not finite: %r" % (dname, losses))
        step_ms = float(np.mean(ms))          # steps 2.., warm
        out[dname] = {
            "losses": losses, "first_step_ms": ms0[0], "step_ms_mean": step_ms,
            "step_ms": ms, "tokens_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        del tr
        torch.cuda.empty_cache()
    out["launches"] = kernel_launches()
    check_launches(out["launches"], 2 * TRAIN_STEPS, model.num_layers,
                   "training")
    fp32 = out["float32"]["losses"]
    if not fp32[-1] < fp32[0]:
        fail("the fp32 loss did not fall: %r" % fp32)

    # the first fp32 step again, from the same weights, on the plain path
    def first_step():
        tr = trainer(model)
        return float(tr.step(x, y)), {n: v.grad for n, v in
                                      tr.values.items()}

    out["plain_check"] = against_plain(first_step, LOSS_RTOL, GRAD_TOL,
                                       "first fp32 step",
                                       kernel=(fp32[0], grads1))
    del grads1
    torch.cuda.empty_cache()

    # dropout 0.1: two steps under one seed, twice, bitwise-equal losses
    net = transformer_lm_base(vocab_size=32000, max_len=TRAIN_SEQ,
                              dropout=0.1, device=dev)
    net.load_state_dict(model.state_dict())
    runs = []
    for _ in range(2):
        trandom.seed(args.seed + 3)
        tr = trainer(net)
        runs.append(train_steps(torch, tr, x, y, 2)[0])
        del tr
    if runs[0] != runs[1]:
        fail("dropout steps are not repeatable: %r != %r" % tuple(runs))
    out["dropout_losses"] = runs[0]
    out["dq_repeat_dropouts"] = dq_repeat_check(torch)
    if args.profile:
        for dname in ("float32", "bfloat16"):
            tr = trainer(model, None if dname == "float32" else dname)
            tr.step(x, y)
            out["profile_" + dname] = profile(
                torch, lambda: train_steps(torch, tr, x, y, 2))
            del tr
    del net, model
    torch.cuda.empty_cache()
    return out


def bert_plain_checks(torch, model, runs, tag):
    """For dropout-0 fp32 and bf16 copies of the BERT ``model``: each
    ``(what, make)`` of ``runs``, where ``make(net)()`` gives ``(loss,
    {name: gradient})``, on the kernel path (each kernel once per layer)
    against the plain path: fp32 at ``LOSS_RTOL`` / ``GRAD_TOL``; bf16 at
    ``BF16_LOSS_RTOL``, its gradients held against the fp32 plain path on
    the same (bf16) weights with ``BF16_GRAD_FACTOR``. Returns
    ``{dtype: {what: comparison}}``."""
    from mxnet_tpu_torch.models import bert_base

    def dropout_free(dt):
        net = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                        dropout=0.0, device=torch.device("cuda"), dtype=dt)
        net.load_state_dict(model.state_dict())
        return net

    layers = len(model.encoder.layers)
    checks = {}
    for dname, dt, ltol, gtol in (
            ("float32", torch.float32, LOSS_RTOL, GRAD_TOL),
            ("bfloat16", torch.bfloat16, BF16_LOSS_RTOL, BF16_GRAD_FACTOR)):
        net = dropout_free(dt)
        if dt == torch.bfloat16:
            net32 = dropout_free(torch.float32)
            net32.load_state_dict(net.state_dict())   # the bf16 values
        checks[dname] = {}
        for what, make in runs:
            truth = None
            if dt == torch.bfloat16:
                truth = on_plain_path(make(net32), "%s fp32 %s" % (tag, what))
            label = "%s %s %s" % (tag, dname, what)
            c = against_plain(make(net), ltol, gtol, label,
                              kernel=launched_per_layer(make(net), layers,
                                                        label),
                              truth=truth)
            checks[dname][what] = c
            print("%s vs plain path (dropout 0): loss rel err %.3g "
                  "(tol %g), worst gradient %s at %.3g of its max%s"
                  % (label, c["loss_rel_err"], c["loss_tol"],
                     c["grad_worst_param"], c["grad_worst_rel_to_max"],
                     " (tol %g)" % c["grad_tol"] if truth is None else
                     " from the fp32 path, the bf16 plain path's worst %s "
                     "at %.3g (tol: %g times it); top kernel %s; top plain "
                     "%s" % (
                         c["grad_worst_plain_param"],
                         c["grad_worst_plain_rel_to_max"], c["grad_tol"],
                         c["grad_top_kernel"], c["grad_top_plain"])),
                  flush=True)
            del truth
        del net
        torch.cuda.empty_cache()
    return checks


def bert_phase(args, torch):
    """BERT-base pretraining at the reference bench's configuration."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.models import (BERTPretrainingLoss, PretrainLoss,
                                        PretrainStep, bert_base,
                                        synthetic_batch)
    from mxnet_tpu_torch.ndarray import save_ndarrays
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import ShardedTrainer
    dev = torch.device("cuda")
    model = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ, device=dev)
    # the weights go through a .params file under reference names
    params = random_params(model, args.seed)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "bert_base_seed%d.params" % args.seed)
    save_ndarrays(path, list(params.values()), list(params))
    try:
        convert.load_mxnet_params(model, path)
    finally:
        os.remove(path)
    del params
    batch = synthetic_batch(np.random.default_rng(args.seed + 4), BERT_BATCH,
                            BERT_SEQ, BERT_VOCAB, BERT_MASKS)
    data = tuple(torch.from_numpy(a).to(dev) for a in batch)
    dummy = torch.zeros(BERT_BATCH, device=dev)

    def trainer(net, dtype=None):
        return ShardedTrainer(PretrainStep(net), PretrainLoss(), "adam",
                              {"learning_rate": 1e-4}, dtype=dtype,
                              device=dev)

    out = {"model": "bert_base", "batch": BERT_BATCH, "seq": BERT_SEQ,
           "masks": BERT_MASKS, "vocab": BERT_VOCAB, "dropout": 0.1,
           "steps_per_dtype": BERT_STEPS}
    fa.reset_launches()
    for dname in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(model, None if dname == "float32" else dname)
        first, ms0 = train_steps(torch, tr, data, dummy, 1)
        rest, ms = train_steps(torch, tr, data, dummy, BERT_STEPS - 1)
        losses = first + rest
        if not all(np.isfinite(losses)):
            fail("BERT %s losses not finite: %r" % (dname, losses))
        step_ms = float(np.mean(ms))
        t = out[dname] = {
            "losses": losses, "first_step_ms": ms0[0],
            "step_ms_mean": step_ms, "step_ms": ms,
            "sequences_s": BERT_BATCH / step_ms * 1e3,
            "tokens_s": BERT_BATCH * BERT_SEQ / step_ms * 1e3,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        print("bert %s: bert_base b%d s%d m%d vocab %d dropout 0.1, step "
              "%.2f ms mean (first %.2f ms), %.1f sequences/s, %.1f "
              "tokens/s, peak memory %.2f GB, losses %s"
              % (dname, BERT_BATCH, BERT_SEQ, BERT_MASKS, BERT_VOCAB,
                 t["step_ms_mean"], t["first_step_ms"], t["sequences_s"],
                 t["tokens_s"], t["max_memory_allocated_gb"],
                 ", ".join("%.4f" % v for v in t["losses"])), flush=True)
        del tr
        torch.cuda.empty_cache()
    out["launches"] = kernel_launches()
    check_launches(out["launches"], 2 * BERT_STEPS, len(model.encoder.layers),
                   "BERT")

    # against the plain path, dropout 0, from the same weights: one step
    # through PretrainStep (valid_len None), and a forward and backward of
    # BERTModel + BERTPretrainingLoss with a valid_len (a key mask)
    rng = np.random.default_rng(args.seed + 5)
    lens = torch.from_numpy(rng.integers(64, BERT_SEQ + 1, BERT_BATCH)
                            .astype("float32")).to(dev)
    tokens, segments, positions, labels, weights, nsp = data
    loss_fn = BERTPretrainingLoss(picked=True)

    def one_step(net):
        def run():
            tr = trainer(net)
            return float(tr.step(data, dummy)), {
                n: v.grad for n, v in tr.values.items()}
        return run

    def masked(net):
        def run():
            net.zero_grad(set_to_none=True)
            _, _, mlm, nspl = net(tokens, segments, lens, positions)
            loss = loss_fn(mlm, nspl, labels, positions, weights, nsp)
            loss.backward()
            return float(loss.detach()), {n: p.grad.detach().clone()
                                          for n, p in net.named_parameters()}
        return run

    checks = bert_plain_checks(torch, model, (("step", one_step),
                                              ("valid_len", masked)), "bert")
    out["plain_check"] = checks
    out["valid_len"] = [int(v) for v in lens.tolist()]

    # dropout 0.1: two steps under one seed, twice, bitwise-equal losses
    # and gradients of the second step
    runs, grads = [], []
    for _ in range(2):
        trandom.seed(args.seed + 6)
        tr = trainer(model)
        runs.append(train_steps(torch, tr, data, dummy, 2)[0])
        grads.append({n: v.grad for n, v in tr.values.items()})
        del tr
    if runs[0] != runs[1]:
        fail("BERT dropout steps are not repeatable: %r != %r" % tuple(runs))
    differ = [n for n in grads[0] if not torch.equal(grads[0][n],
                                                     grads[1][n])]
    if differ:
        fail("BERT dropout step gradients are not repeatable: %s"
             % ", ".join(differ))
    del grads
    out["dropout_losses"] = runs[0]
    if args.profile:
        tr = trainer(model, "bfloat16")
        tr.step(data, dummy)
        out["profile_bfloat16"] = profile(
            torch, lambda: train_steps(torch, tr, data, dummy, 2))
        del tr
    del model
    torch.cuda.empty_cache()
    return out


def launched_per_layer(run, layers, what):
    """``run()``, which must launch each training kernel once per layer."""
    n0 = kernel_launches()
    res = run()
    n1 = kernel_launches()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if n1[name] - n0[name] != layers:
            fail("%s: %s launched %d times, not once per each of %d layers"
                 % (what, name, n1[name] - n0[name], layers))
    return res


def check_launches(launches, steps, layers, what):
    """Each training kernel launched ``steps x layers`` times, the (B, H,
    S, D) forward never."""
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if launches[name] != steps * layers:
            fail("%s: %s launched %d times in %d steps x %d layers"
                 % (what, name, launches[name], steps, layers))
    if launches["flash_attn_fwd_bhsd"]:
        fail("%s launched the (B, H, S, D) forward" % what)


def surface_bert(args, torch):
    """Part (a): BERT-base pretraining from the reference's Xavier
    initialization with LAMB under a PolyScheduler."""
    from mxnet_tpu_torch import initializer, lr_scheduler
    from mxnet_tpu_torch.gluon import collect_params
    from mxnet_tpu_torch.models import (PretrainLoss, PretrainStep,
                                        bert_base, synthetic_batch)
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch import random as trandom
    dev = torch.device("cuda")
    trandom.seed(args.seed)
    model = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ, device=dev)
    t0 = time.perf_counter()
    collect_params(PretrainStep(model)).initialize(initializer.Xavier())
    init_s = time.perf_counter() - t0
    layers = len(model.encoder.layers)
    batch = synthetic_batch(np.random.default_rng(args.seed + 7), BERT_BATCH,
                            BERT_SEQ, BERT_VOCAB, BERT_MASKS)
    data = tuple(torch.from_numpy(a).to(dev) for a in batch)
    dummy = torch.zeros(BERT_BATCH, device=dev)

    def trainer(net, dtype=None, optimizer="lamb"):
        return ShardedTrainer(PretrainStep(net), PretrainLoss(), optimizer,
                              dict(SURFACE_LAMB), dtype=dtype, device=dev)

    def schedule():
        return lr_scheduler.PolyScheduler(max_update=SURFACE_STEPS,
                                          base_lr=SURFACE_LAMB[
                                              "learning_rate"],
                                          pwr=1, warmup_steps=2)

    def run(tr):
        sched = schedule()
        # the optimizer's num_update is 1 on the first step
        lrs = [sched(i + 1) for i in range(SURFACE_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(
            torch, lambda i: tr.step(data, dummy, lr=lrs[i]), SURFACE_STEPS)
        step_ms = float(np.mean(ms[1:]))
        return {"losses": losses, "lrs": lrs, "first_step_ms": ms[0],
                "step_ms_mean": step_ms, "step_ms": ms,
                "tokens_s": BERT_BATCH * BERT_SEQ / step_ms * 1e3,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}

    out = {"model": "bert_base", "init": "Xavier() from --seed",
           "init_s": init_s, "optimizer": "lamb", "hyper": SURFACE_LAMB,
           "schedule": "PolyScheduler(max_update=%d, base_lr=1e-4, pwr=1, "
                       "warmup_steps=2)" % SURFACE_STEPS,
           "steps_per_dtype": SURFACE_STEPS}
    fa.reset_launches()
    for dname in ("float32", "bfloat16"):
        tr = trainer(model, None if dname == "float32" else dname)
        t = out[dname] = run(tr)
        if not all(np.isfinite(t["losses"])):
            fail("surface BERT LAMB %s losses not finite: %r"
                 % (dname, t["losses"]))
        del tr
        torch.cuda.empty_cache()
    out["launches"] = kernel_launches()
    check_launches(out["launches"], 2 * SURFACE_STEPS, layers,
                   "surface BERT LAMB")
    # Adam on the same weights, batch and schedule: LAMB's cost beside it
    tr = trainer(model, "bfloat16", "adam")
    out["bfloat16_adam"] = run(tr)
    del tr
    for dname in ("float32", "bfloat16"):
        t = out[dname]
        print("surface bert %s: LAMB from Xavier, lr per step %s, step %.2f "
              "ms mean (first %.2f ms), %.1f tokens/s, peak memory %.2f GB, "
              "losses %s" % (
                  dname, ", ".join("%.3g" % v for v in t["lrs"]),
                  t["step_ms_mean"], t["first_step_ms"], t["tokens_s"],
                  t["max_memory_allocated_gb"],
                  ", ".join("%.4f" % v for v in t["losses"])), flush=True)
    print("surface bert bfloat16 Adam (same weights and schedule): step "
          "%.2f ms mean; LAMB adds %.2f ms a step"
          % (out["bfloat16_adam"]["step_ms_mean"],
             out["bfloat16"]["step_ms_mean"]
             - out["bfloat16_adam"]["step_ms_mean"]), flush=True)

    # one LAMB step at dropout 0 against the plain path, as the BERT phase
    def one_step(net):
        def run_one():
            tr = trainer(net)
            return float(tr.step(data, dummy, lr=schedule()(1))), {
                n: v.grad for n, v in tr.values.items()}
        return run_one

    out["plain_check"] = bert_plain_checks(
        torch, model, (("LAMB step", one_step),), "surface bert")
    if args.profile:
        for name in ("lamb", "adam"):
            tr = trainer(model, "bfloat16", name)
            tr.step(data, dummy, lr=1e-4)
            out["profile_bfloat16_" + name] = profile(
                torch, lambda: train_steps(torch, tr, data, dummy, 2))
            del tr
    del model
    torch.cuda.empty_cache()
    return out


def surface_eager(args, torch):
    """Part (b): eager TransformerLM training through ``gluon.Trainer``,
    from the reference's Xavier initialization, with
    ``clip_global_norm`` over the gradients each step."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    from mxnet_tpu_torch.models import transformer_lm_base
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import ShardedTrainer
    dev = torch.device("cuda")
    trandom.seed(args.seed)
    net = transformer_lm_base(vocab_size=32000, max_len=TRAIN_SEQ,
                              device=dev)
    params = collect_params(net)
    params.initialize(initializer.Xavier())
    plist = list(params.values())
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    x, y = (torch.from_numpy(a).to(dev) for a in lm_batch(args.seed + 2))
    loss_fn = SoftmaxCrossEntropyLoss()
    norms = []

    def eager_step(trainer):
        """One step as a Gluon script takes it: forward, per-sample loss,
        backward of the loss vector, clip, ``step(batch)``."""
        def step(_):
            losses = loss_fn(net(x), y)
            losses.backward(torch.ones_like(losses))
            norms.append(clip_global_norm([p.grad() for p in plist],
                                          SURFACE_CLIP))
            trainer.step(TRAIN_BATCH)
            return losses.detach().float().mean()
        return step

    def summary(losses, ms):
        step_ms = float(np.mean(ms[1:]))
        return {"losses": losses, "first_step_ms": ms[0],
                "step_ms_mean": step_ms, "step_ms": ms,
                "tokens_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}

    out = {"model": "transformer_lm_base", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "optimizer": "adam", "lr": 1e-4,
           "clip_global_norm": SURFACE_CLIP, "steps_per_dtype": SURFACE_STEPS}
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(params, "adam", {"learning_rate": 1e-4})
    first, ms0 = timed_steps(torch, eager_step(tr), 1)
    after1 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    rest, ms = timed_steps(torch, eager_step(tr), SURFACE_STEPS - 1)
    out["float32"] = summary(first + rest, ms0 + ms)
    del tr
    # bf16 weights with fp32 master copies, from the same start
    net.load_state_dict(start)
    net.to(torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(params, "adam", {"learning_rate": 1e-4,
                                  "multi_precision": True})
    out["bfloat16"] = summary(*timed_steps(torch, eager_step(tr),
                                           SURFACE_STEPS))
    masters = [s[0].dtype for s in tr._updaters[0].states.values()]
    if not all(d == torch.float32 for d in masters) or \
            net.head.weight.dtype != torch.bfloat16:
        fail("surface eager bf16: no fp32 master copies (%s)" % masters)
    del tr
    out["launches"] = kernel_launches()
    check_launches(out["launches"], 2 * SURFACE_STEPS, net.num_layers,
                   "surface eager TransformerLM")
    out["clip_norms"] = [float(v) for v in norms]
    for dname in ("float32", "bfloat16"):
        t = out[dname]
        if not all(np.isfinite(t["losses"])):
            fail("surface eager %s losses not finite: %r"
                 % (dname, t["losses"]))
        print("surface eager %s: TransformerLM b%d s%d gluon.Trainer "
              "%s, step %.2f ms mean (first %.2f ms), %.1f tokens/s, peak "
              "memory %.2f GB, losses %s" % (
                  dname, TRAIN_BATCH, TRAIN_SEQ,
                  "Adam multi_precision" if dname == "bfloat16" else "Adam",
                  t["step_ms_mean"], t["first_step_ms"], t["tokens_s"],
                  t["max_memory_allocated_gb"],
                  ", ".join("%.4f" % v for v in t["losses"])), flush=True)
    fp32 = out["float32"]["losses"]
    if not fp32[-1] < fp32[0]:
        fail("the eager fp32 loss did not fall: %r" % fp32)

    # the first eager step against one ShardedTrainer Adam step from the
    # same weights: both minimise the batch mean; the clip's scale enters
    # as rescale_grad
    scale = min(1.0, SURFACE_CLIP / (norms[0] + 1e-8))
    del net, params, plist
    torch.cuda.empty_cache()
    ref_net = transformer_lm_base(vocab_size=32000, max_len=TRAIN_SEQ,
                                  device=dev)
    ref_net.load_state_dict(start)
    sharded = ShardedTrainer(ref_net, loss_fn, "adam",
                             {"learning_rate": 1e-4, "rescale_grad": scale},
                             device=dev)
    loss_sharded = float(sharded.step(x, y))
    loss_rel = abs(fp32[0] - loss_sharded) / abs(loss_sharded)
    errs = {n: rel_to_max(after1[n], v) for n, v in sharded.values.items()}
    worst = max(errs, key=errs.get)
    out["sharded_check"] = {
        "clip_scale": scale, "loss_eager": fp32[0],
        "loss_sharded": loss_sharded, "loss_rel_err": loss_rel,
        "loss_tol": SURFACE_LOSS_RTOL, "param_worst": worst,
        "param_worst_rel_to_max": errs[worst],
        "param_tol": SURFACE_PARAM_TOL,
        "param_top": sorted(errs.items(), key=lambda kv: -kv[1])[:4]}
    print("surface eager first step vs ShardedTrainer Adam (clip scale "
          "%.4g): loss rel err %.3g (tol %g), worst parameter %s at %.3g "
          "of its max (tol %g); top %s" % (
              scale, loss_rel, SURFACE_LOSS_RTOL, worst, errs[worst],
              SURFACE_PARAM_TOL, out["sharded_check"]["param_top"]),
          flush=True)
    if not loss_rel <= SURFACE_LOSS_RTOL:
        fail("surface eager first step: loss %r != ShardedTrainer %r"
             % (fp32[0], loss_sharded))
    if errs[worst] > SURFACE_PARAM_TOL:
        fail("surface eager first step: parameter %s off by %g of its max "
             "from ShardedTrainer's" % (worst, errs[worst]))
    del sharded, ref_net, start, after1
    torch.cuda.empty_cache()
    return out


def dq_repeat_check(torch):
    """The fp32 and the bf16 dQ kernel twice on the same inputs at the
    training shape (B 32, S 512, H 12, D 64, BSHD, causal), without and
    with dropout 0.1: the results must be bitwise equal (no atomics).
    Returns the dropout rates checked."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(99)
    drops = (0.0, 0.1)
    for dt in (torch.float32, torch.bfloat16):
        (q, k, v, do), _ = attention_inputs(torch, gen, TRAIN_BATCH,
                                            TRAIN_SEQ, 12, 64, "BSHD", dt, 4,
                                            False)
        for drop in drops:
            seed = 20240603 if drop else None
            o, lse = fa.flash_attention_bshd(q, k, v, None, seed, True, drop,
                                             return_lse=True)
            args = (q, k, v, do, lse, fa._delta(do, o, "BSHD"), None, seed,
                    True, drop, "BSHD")
            first = fa.flash_attention_bwd_dq(*args)
            second = fa.flash_attention_bwd_dq(*args)
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                fail("%s dQ is not bitwise repeatable at dropout %s"
                     % (dt, drop))
    return list(drops)


def time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(torch, fn, iters=20):
    """Device time per call: ``iters`` calls captured in one CUDA graph
    and replayed, so no Python launch cost sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(B, H, S, D, dtype, causal, products=2, n_in=3, n_out=1, rows=1):
    """Least time for the card: the larger of FLOPs over the dtype's peak
    and bytes over HBM. FLOPs: ``products`` S x S x D products of
    2*B*H*S^2*D each (forward 2; dQ 3; dK/dV 4), halved under causal.
    Bytes: ``n_in`` inputs and ``n_out`` outputs of (B, S, H, D), the int32
    key mask and ``rows`` fp32 (B, H, S) rows (the forward writes LSE; the
    backward reads LSE and delta), each moved once."""
    flops = products * 2.0 * B * H * S * S * D * (0.5 if causal else 1.0)
    item = 4 if dtype == "float32" else 2
    nbytes = (n_in + n_out) * B * S * H * D * item + B * S * 4 \
        + rows * B * H * S * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def attention_inputs(torch, g, B, S, H, D, layout, dt, n, masked):
    dev = torch.device("cuda")
    shape = (B, S, H, D) if layout == "BSHD" else (B, H, S, D)
    xs = [torch.randn(shape, generator=g, device=dev).to(dt)
          for _ in range(n)]
    mask = None
    if masked:
        valid = S - S // 8            # a padded prompt: key 0 always valid
        mask = (torch.arange(S, device=dev) < valid).to(torch.int32)
        mask = mask.reshape(1, S).expand(B, S).contiguous()
    return xs, mask


def sdpa(torch, F, B, S, mask, causal=True):
    """The SDPA call for (B, H, S, D) inputs: with no key mask,
    ``is_causal`` alone and no mask (its flash backend can run); with one,
    the causal (when ``causal``) and key masks as one boolean mask."""
    if mask is None:
        return lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
    keep = mask.bool().reshape(B, 1, 1, S)
    if causal:
        keep = keep & torch.ones((S, S), dtype=torch.bool,
                                 device="cuda").tril()
    return lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=keep)


def bert_specs(torch):
    """The kernel cases of BERT pretraining: B 64, S 128, H 12, D 64, BSHD,
    non-causal, fp32 and bf16, without and with a key mask, and with the
    training's dropout 0.1 (``(B, S, D, layout, dtype, dropout, key mask,
    causal)``)."""
    return [(BERT_BATCH, BERT_SEQ, 64, "BSHD", dt, drop, masked, False)
            for dt in (torch.float32, torch.bfloat16)
            for drop, masked in ((0.0, False), (0.0, True), (0.1, False))]


def kernel_phase(torch):
    """The forward kernel at the serving shapes, the training shape and
    the BERT shape."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1234)
    cases = []
    H = 12
    specs = [(1, S, 64, layout, dt, 0.0, True, True) for S in (128, 1024)
             for layout in ("BSHD", "BHSD")
             for dt in (torch.float32, torch.bfloat16)]
    specs += [(1, 1024, 64, "BSHD", dt, 0.1, True, True)
              for dt in (torch.float32, torch.bfloat16)]
    specs += [(8, 512, D, "BSHD", torch.float32, 0.0, True, True)
              for D in (32, 128)]
    specs += [(8, 512, 64, "BHSD", dt, 0.0, True, True)
              for dt in (torch.float32, torch.bfloat16)]
    specs += [(TRAIN_BATCH, TRAIN_SEQ, 64, "BSHD", dt, 0.0, False, True)
              for dt in (torch.float32, torch.bfloat16)]
    specs += bert_specs(torch)
    for B, S, D, layout, dt, drop, masked, causal in specs:
        (q, k, v), mask = attention_inputs(torch, g, B, S, H, D, layout, dt,
                                           3, masked)
        fn = fa.flash_attention_bshd if layout == "BSHD" else \
            fa.flash_attention
        seed = 20240601 if drop else None
        out = fn(q, k, v, mask, seed, causal, drop)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, mask, seed, causal, drop,
                                       layout=layout)
        tol = 2e-4 if dt == torch.float32 else 2e-2
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
            fail("kernel != plain: B=%d S=%d D=%d %s %s causal=%s "
                 "dropout=%s max_err=%g" % (B, S, D, layout, dt, causal,
                                            drop, err))
        ms = time_ms(torch, lambda: fn(q, k, v, mask, seed, causal, drop))
        dev_ms = graph_ms(torch, lambda: fn(q, k, v, mask, seed, causal,
                                            drop))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, mask, seed, causal, drop, layout=layout), iters=5)
        lib_ms = lib_graph_ms = None
        if drop == 0.0:
            qb, kb, vb = ((x.transpose(1, 2) if layout == "BSHD" else x)
                          for x in (q, k, v))
            lib = sdpa(torch, F, B, S, mask, causal)
            lib_ms = time_ms(torch, lambda: lib(qb, kb, vb))
            lib_graph_ms = graph_ms(torch, lambda: lib(qb, kb, vb))
        dname = str(dt).replace("torch.", "")
        b_ms, b_by = bound(B, H, S, D, dname, causal)
        cases.append({"B": B, "S": S, "H": H, "D": D, "layout": layout,
                      "dtype": dname, "dropout": drop, "causal": causal,
                      "key_mask": masked, "max_abs_err": err, "tol": tol,
                      "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
    return cases


def bwd_phase(torch):
    """The dQ and dK/dV kernels against the plain backward, and timed."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(4321)
    cases = []
    H = 12
    specs = [(8, 512, 64, layout, dt, 0.0, True, True)
             for layout in ("BSHD", "BHSD")
             for dt in (torch.float32, torch.bfloat16)]
    specs += [(8, 512, D, "BSHD", dt, drop, True, True)
              for dt in (torch.float32, torch.bfloat16)
              for D, drop in ((64, 0.1), (32, 0.0), (128, 0.0))]
    specs += [(TRAIN_BATCH, TRAIN_SEQ, 64, "BSHD", dt, 0.0, False, True)
              for dt in (torch.float32, torch.bfloat16)]
    specs += bert_specs(torch)
    for B, S, D, layout, dt, drop, masked, causal in specs:
        (q, k, v, do), mask = attention_inputs(torch, g, B, S, H, D, layout,
                                               dt, 4, masked)
        fn = fa.flash_attention_bshd if layout == "BSHD" else \
            fa.flash_attention
        seed = 20240602 if drop else None
        o, lse = fn(q, k, v, mask, seed, causal, drop, return_lse=True)
        delta = fa._delta(do, o, layout)
        args = (q, k, v, do, lse, delta, mask, seed, causal, drop, layout)
        dq = fa.flash_attention_bwd_dq(*args)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, mask, seed, o, lse, do,
                                           causal, drop, layout)
        tol = 2e-4 if dt == torch.float32 else 2e-2
        errs = {}
        for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            if not err <= tol * top:
                fail("%s kernel != plain: B=%d S=%d D=%d %s %s causal=%s "
                     "dropout=%s max_err=%g max|ref|=%g"
                     % (name, B, S, D, layout, dt, causal, drop, err, top))
            errs[name] = (err, err / top)
        times = {}
        for name, kern, products, n_out in (
                ("dq", fa.flash_attention_bwd_dq, 3, 1),
                ("dkv", fa.flash_attention_bwd_dkv, 4, 2)):
            dname = str(dt).replace("torch.", "")
            b_ms, b_by = bound(B, H, S, D, dname, causal, products, 4,
                               n_out, 2)
            times[name] = {"ms": time_ms(torch, lambda: kern(*args)),
                           "graph_ms": graph_ms(torch, lambda: kern(*args)),
                           "bound_ms": b_ms, "bound_by": b_by}
        plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, mask, seed, o, lse, do, causal, drop, layout), iters=5)
        lib_ms = lib_graph_ms = None
        if drop == 0.0:
            leaves = [(x.transpose(1, 2) if layout == "BSHD" else x)
                      .detach().requires_grad_() for x in (q, k, v)]
            lib = sdpa(torch, F, B, S, mask, causal)
            lib_out = lib(*leaves)
            lib_do = do.transpose(1, 2) if layout == "BSHD" else do
            lib_ms = time_ms(torch, lambda: torch.autograd.grad(
                lib_out, leaves, lib_do, retain_graph=True))
            # fresh leaves, so that no autograd node made on the default
            # stream outside the capture is still alive in it
            del lib_out
            leaves = [x.detach().requires_grad_() for x in leaves]

            def fwd_bwd():
                torch.autograd.grad(lib(*leaves), leaves, lib_do)

            with torch.no_grad():
                fwd_graph = graph_ms(torch, lambda: lib(*leaves))
            lib_graph_ms = graph_ms(torch, fwd_bwd) - fwd_graph
            del leaves
        cases.append({"B": B, "S": S, "H": H, "D": D, "layout": layout,
                      "dtype": str(dt).replace("torch.", ""),
                      "dropout": drop, "causal": causal, "key_mask": masked,
                      "tol_rel_to_max": tol,
                      "max_abs_err": {n: e[0] for n, e in errs.items()},
                      "max_err_rel_to_max": {n: e[1]
                                             for n, e in errs.items()},
                      "dq": times["dq"], "dkv": times["dkv"],
                      "plain_bwd_ms": plain_ms, "library_bwd_ms": lib_ms,
                      "library_bwd_graph_ms": lib_graph_ms})
        del q, k, v, do, o, lse, delta, dq, dk, dv, ref
        torch.cuda.empty_cache()
    return cases


def kernel_label(mangled):
    """``bwd_dq_tc_kernel<64,64,0>`` from a mangled instance name (the
    integer and bool template arguments, ``f32`` for a float one)."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()       # a length prefix may follow other digits
        for k in range(len(digits)):
            end = m.end() + int(digits[k:])
            name = mangled[m.end():end]
            if name.endswith("_kernel") and mangled[end:end + 1] == "I":
                args = mangled[end + 1:mangled.find("EEv", end)]
                return "%s<%s>" % (name, ",".join(
                    (["f32"] if args.startswith("f") else [])
                    + re.findall(r"L[ib](\d+)", args)))
    return mangled


def ptxas_summary(_build, name):
    """``name: kernel<template args> <registers>r/<spill store bytes>s``
    for every instance that ptxas reported in this process's build."""
    parts = []
    for chunk in _build.build_log(name).split("Compiling entry function")[1:]:
        fn = re.search(r"'(\w+)'", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        parts.append("%s %sr/%ss" % (kernel_label(fn.group(1)) if fn else "?",
                                     regs.group(1) if regs else "?",
                                     spill.group(1) if spill else "?"))
    return "%s: ptxas %d kernels: %s" % (name, len(parts), ", ".join(parts))


# ---- the core runtime: /predict, the Gluon loop over NDArrays, the
# registry op ----------------------------------------------------------------

PREDICT_SEQ, PREDICT_CLIENTS, PREDICT_PER_CLIENT = 128, 8, 8
PREDICT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of the output's max
# bf16 against the plain path, as the BERT phase holds bf16: each path's
# distance from the fp32 plain path on the same (bf16) weights, the kernel
# path's at most this many times the plain path's. Each bucket holds its
# pooled [CLS] output (768 values a row) to it. The NSP head's 2 logits a
# row (at bucket 2 four values) make a per-bucket max a noisy statistic
# (ROADMAP C10), so the NSP logits are held to it over every row the pass
# checks (all buckets and the C10 case together). Each bucket's attention
# is held to it layer by layer too, against the float64 attention of the
# layer's inputs.
PREDICT_BF16_FACTOR = 2.0
# ROADMAP C10: the bucket-2 rows of the bf16 pass when ``--profile`` draws
# one more bucket-32 input first (seed 0); on them the NSP logits of the
# kernel path lay 2.1 times as far from the fp32 path as the plain path's.
# Checked on every run.
C10_SEED, C10_BUCKET, C10_VALID_LEN = 0, 2, [102.0, 64.0]
AUTOGRAD_STEPS = 3
REGISTRY_SHAPE = (8, 512, 12, 64)                   # B, S, H, D (BHSD)


def _served(net):
    """The served function: sentence-pair scoring over NDArrays, the
    pooled [CLS] row and its NSP logits (no (T, vocab) MLM output)."""
    from mxnet_tpu_torch import nd

    def serve(tokens, segments, valid_len):
        seq = net.encoder(tokens, segments, valid_len)
        pooled = nd.tanh(net.pooler(seq[:, 0]))
        return pooled, net.nsp(pooled)
    return serve


def _served_eager(torch, net, tokens, segments, valid_len):
    """The same function on tensors, outside any CachedOp."""
    with torch.no_grad():
        seq = net.encoder(tokens, segments, valid_len)
        pooled = torch.tanh(net.pooler(seq[:, 0]))
        return pooled, net.nsp(pooled)


def _bucket_inputs(torch, rng, n, dev):
    tokens = torch.from_numpy(rng.integers(1, BERT_VOCAB, (n, PREDICT_SEQ))
                              .astype("float32")).to(dev)
    segments = torch.zeros((n, PREDICT_SEQ), device=dev)
    segments[:, PREDICT_SEQ // 2:] = 1.0
    lens = torch.from_numpy(rng.integers(16, PREDICT_SEQ + 1, n)
                            .astype("float32")).to(dev)
    return tokens, segments, lens


def _attention_inputs(torch, run):
    """``run()`` with every flash forward's inputs and output recorded:
    ``(result, [(q, k, v, kv_mask, out), ...])``, one entry a layer."""
    from mxnet_tpu_torch.ops import nn as onn
    calls, kernel = [], onn.flash_attention_bshd

    def recorded(q, k, v, kv_mask=None, seed=None, causal=False,
                 dropout=0.0):
        out = kernel(q, k, v, kv_mask, seed, causal, dropout)
        calls.append((q, k, v, kv_mask, out))
        return out
    onn.flash_attention_bshd = recorded
    try:
        res = run()
    finally:
        onn.flash_attention_bshd = kernel
    return res, calls


def _attention64(torch, q, k, v, mask):
    """The float64 attention of one layer's (B, S, H, D) inputs under its
    (B, S) key mask."""
    q64, k64, v64 = (x.double().transpose(1, 2) for x in (q, k, v))
    sc = q64 @ k64.transpose(-1, -2) / q.shape[-1] ** 0.5
    if mask is not None:
        sc = sc.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))
    return (torch.softmax(sc, -1) @ v64).transpose(1, 2)


def _attention_distances(torch, calls):
    """For each recorded flash forward, the kernel's output and the plain
    path's on the same inputs, each as a distance from the float64
    attention (of that output's max): ``[(kernel, plain), ...]``."""
    from mxnet_tpu_torch.ops import nn as onn
    res = []
    for q, k, v, mask, out in calls:
        ref = _attention64(torch, q, k, v, mask)
        m4 = None if mask is None else mask[:, None, None, :]
        plain = onn._plain_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), m4, 0.0, True,
                                     False, None).transpose(1, 2)
        res.append((rel_to_max(out, ref), rel_to_max(plain, ref)))
    return res


def _attention_vs_plain(torch, calls, layers, what):
    """Each of the ``layers`` layers' bf16 kernel attention within
    ``PREDICT_BF16_FACTOR`` times the plain path's distance from the
    float64 attention (:func:`_attention_distances`). Returns the worst
    ratio."""
    if len(calls) != layers:
        fail("%s: %d flash forwards recorded, not one for each of the %d "
             "layers" % (what, len(calls), layers))
    worst = 0.0
    for i, (ker_d, plain_d) in enumerate(_attention_distances(torch, calls)):
        if not ker_d <= PREDICT_BF16_FACTOR * plain_d:
            fail("%s: layer %d's attention is %g of its max from the "
                 "float64 attention, the plain path's %g (tol: %g times "
                 "it)" % (what, i, ker_d, plain_d, PREDICT_BF16_FACTOR))
        worst = max(worst, ker_d / max(plain_d, 1e-30))
    return worst


def _vs_plain(torch, net, t, s, v, eager, what, truth_net=None):
    """The served function's kernel-path outputs ``eager`` against the
    plain path on the same inputs: fp32 within ``PREDICT_TOL`` of each
    output's max. bf16 (given ``truth_net``, an fp32 copy of the bf16
    weights): each path's distance from ``truth_net``'s plain path, per
    output; the pooled output's held to ``PREDICT_BF16_FACTOR`` here,
    the NSP logits kept under ``"nsp_rows"`` for the pass's check over
    all its rows (:func:`_nsp_vs_fp32`); each layer's attention by
    :func:`_attention_vs_plain`."""
    def plain(n):
        return on_plain_path(lambda: _served_eager(torch, n, t, s, v), what)

    def worst(got, ref):
        return max(rel_to_max(g, r) for g, r in zip(got, ref))

    if not all(torch.isfinite(e).all() for e in eager):
        fail("%s: the served outputs are not finite" % what)
    ref = plain(net)
    out = {"vs_plain_rel_to_max": worst(eager, ref)}
    if truth_net is None:
        if not out["vs_plain_rel_to_max"] <= PREDICT_TOL["float32"]:
            fail("%s: kernel path != plain path (%g of the output's max, "
                 "tol %g)" % (what, out["vs_plain_rel_to_max"],
                              PREDICT_TOL["float32"]))
        return out
    truth = plain(truth_net)
    out["kernel_vs_fp32"] = worst(eager, truth)
    out["plain_vs_fp32"] = worst(ref, truth)
    out["by_output"] = {
        name: {"kernel_vs_fp32": rel_to_max(e, tr),
               "plain_vs_fp32": rel_to_max(r, tr)}
        for name, e, r, tr in zip(("pooled", "nsp"), eager, ref, truth)}
    p = out["by_output"]["pooled"]
    if not p["kernel_vs_fp32"] <= PREDICT_BF16_FACTOR * p["plain_vs_fp32"]:
        fail("%s: the kernel path's pooled output is %g of its max from "
             "the fp32 path, the plain path's %g (tol: %g times it)" % (
                 what, p["kernel_vs_fp32"], p["plain_vs_fp32"],
                 PREDICT_BF16_FACTOR))
    again, calls = _attention_inputs(
        torch, lambda: _served_eager(torch, net, t, s, v))
    if not all(torch.equal(a, e) for a, e in zip(again, eager)):
        fail("%s: a second eager forward differs from the first" % what)
    out["attention_worst_ratio"] = _attention_vs_plain(
        torch, calls, len(net.encoder.layers), what)
    out["nsp_rows"] = (eager[1], ref[1], truth[1])
    return out


def _nsp_vs_fp32(torch, per_case, dname):
    """The bf16 pass's NSP rule over every checked row: the kernel path's
    distance from the fp32 path (of the logits' max over all rows) at most
    ``PREDICT_BF16_FACTOR`` times the plain path's."""
    ker, plain, truth = (torch.cat([c["nsp_rows"][i] for c in per_case])
                         for i in range(3))
    res = {"kernel_vs_fp32": rel_to_max(ker, truth),
           "plain_vs_fp32": rel_to_max(plain, truth),
           "rows": int(truth.shape[0])}
    if not res["kernel_vs_fp32"] <= PREDICT_BF16_FACTOR * \
            res["plain_vs_fp32"]:
        fail("predict %s: over all %d checked rows the kernel path's NSP "
             "logits are %g of their max from the fp32 path, the plain "
             "path's %g (tol: %g times it)" % (
                 dname, res["rows"], res["kernel_vs_fp32"],
                 res["plain_vs_fp32"], PREDICT_BF16_FACTOR))
    for c in per_case:
        del c["nsp_rows"]
    return res


def _c10_inputs(torch, dev):
    """ROADMAP C10's failing inputs: the bucket-2 rows that the bf16 pass
    draws at ``C10_SEED`` when ``--profile`` draws one more bucket-32 input
    (the phase's draws replayed on a fresh generator; it fails if they no
    longer give C10's valid lengths)."""
    from mxnet_tpu_torch.serving import DEFAULT_BUCKETS
    rng = np.random.default_rng(C10_SEED + 11)
    for b in DEFAULT_BUCKETS:
        _bucket_inputs(torch, rng, b, dev)
    _bucket_inputs(torch, rng, DEFAULT_BUCKETS[-1], dev)
    for _ in range(PREDICT_CLIENTS * PREDICT_PER_CLIENT):
        _bucket_inputs(torch, rng, 1, dev)
    _bucket_inputs(torch, rng, 8, dev)
    for b in DEFAULT_BUCKETS:
        inputs = _bucket_inputs(torch, rng, b, dev)
        if b == C10_BUCKET:
            if inputs[2].tolist() != C10_VALID_LEN:
                fail("predict: the replayed draws give valid lengths %s, "
                     "not C10's %s" % (inputs[2].tolist(), C10_VALID_LEN))
            return inputs


def _predict_dtype(args, torch, net, dname, rng, truth_net=None):
    """One dtype of the predict phase: warmup, per-bucket checks (replay
    against eager, eager against the plain path) and times, batcher rows
    against rows alone, and HTTP traffic."""
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch import autograd, gpu, nd
    from mxnet_tpu_torch.serving import (DEFAULT_BUCKETS, InferenceEngine,
                                         ModelServer)
    dev = torch.device("cuda")
    out = {"buckets": list(DEFAULT_BUCKETS)}
    eng = InferenceEngine(_served(net), buckets=DEFAULT_BUCKETS,
                          name="bert_predict_" + dname, ctx=gpu(0))
    op = eng.cached_op
    example = (np.zeros((1, PREDICT_SEQ), "float32"),
               np.zeros((1, PREDICT_SEQ), "float32"),
               np.full((1,), PREDICT_SEQ, "float32"))
    with autograd.predict_mode():
        n0 = kernel_launches()
        t0 = time.perf_counter()
        eng.warmup(example)
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
        out["warmup_launches"] = {k: v - n0[k] for k, v in
                                  kernel_launches().items()}
        st = op.cache_stats()
        if st["misses"] != len(DEFAULT_BUCKETS) or st["graphs"] != \
                len(DEFAULT_BUCKETS):
            fail("predict %s: %d misses, %d graphs after warmup, not %d"
                 % (dname, st["misses"], st["graphs"],
                    len(DEFAULT_BUCKETS)))
        # warmup runs each bucket twice (the side-stream run and the
        # capture): one flash forward a layer each time
        layers = len(net.encoder.layers)
        if out["warmup_launches"]["flash_attn_fwd"] != \
                2 * layers * len(DEFAULT_BUCKETS):
            fail("predict %s: warmup launched the flash forward %d times"
                 % (dname, out["warmup_launches"]["flash_attn_fwd"]))
        out["capture_ms"] = dict(op.capture_ms)
        out["pool_bytes"] = op.pool_bytes
        out["per_bucket"] = {}
        for b in DEFAULT_BUCKETS:
            t, s, v = _bucket_inputs(torch, rng, b, dev)
            n0 = kernel_launches()["flash_attn_fwd"]
            eager = _served_eager(torch, net, t, s, v)
            per_call = kernel_launches()["flash_attn_fwd"] - n0
            if per_call != layers:
                fail("predict %s bucket %d: %d flash launches a call, not "
                     "%d" % (dname, b, per_call, layers))
            nds = [nd.NDArray(x) for x in (t, s, v)]
            replay = op(*nds)
            for e, r in zip(eager, replay):
                if not torch.equal(e, r._data):
                    fail("predict %s bucket %d: graph replay != eager "
                         "forward (max diff %g)" % (
                             dname, b, (e.float() - r._data.float()).abs()
                             .max().item()))
            out["per_bucket"][b] = _vs_plain(
                torch, net, t, s, v, eager,
                "predict %s bucket %d" % (dname, b), truth_net)
            out["per_bucket"][b].update({
                "eager_ms": time_ms(torch, lambda: _served_eager(
                    torch, net, t, s, v)),
                "replay_ms": time_ms(torch, lambda: op(*nds)),
                "flash_launches_per_call": per_call})
        if truth_net is not None:
            t, s, v = _c10_inputs(torch, dev)
            out["c10_case"] = _vs_plain(
                torch, net, t, s, v, _served_eager(torch, net, t, s, v),
                "predict %s, the C10 case" % dname, truth_net)
            out["c10_case"]["valid_len"] = v.tolist()
            out["bf16_nsp"] = _nsp_vs_fp32(
                torch, list(out["per_bucket"].values()) + [out["c10_case"]],
                dname)
        if args.profile:
            t, s, v = _bucket_inputs(torch, rng, DEFAULT_BUCKETS[-1], dev)
            out["profile_eager_b32"] = profile(
                torch, lambda: _served_eager(torch, net, t, s, v))
        misses = op.cache_stats()["misses"]

        # HTTP: 8 clients x 8 requests, rows held against the row alone
        payloads = []
        for _ in range(PREDICT_CLIENTS * PREDICT_PER_CLIENT):
            t, s, v = (x.cpu().numpy() for x in _bucket_inputs(
                torch, rng, 1, dev))
            payloads.append((t[0], s[0], v[0]))
        srv = ModelServer(eng, port=0, max_batch_size=DEFAULT_BUCKETS[-1],
                          max_latency_ms=5.0).start()
        try:
            def client(c):
                got = []
                for i in range(PREDICT_PER_CLIENT):
                    t, s, v = payloads[c * PREDICT_PER_CLIENT + i]
                    body = json.dumps({"inputs": [t.tolist(), s.tolist(),
                                                  float(v)]}).encode()
                    req = urllib.request.Request(
                        srv.url + "/predict", data=body, method="POST",
                        headers={"Content-Type": "application/json"})
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=120) as r:
                        reply = json.loads(r.read())
                    got.append((time.perf_counter() - t0, reply))
                return got

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=PREDICT_CLIENTS) as pool:
                results = [f.result(timeout=600) for f in
                           [pool.submit(client, c)
                            for c in range(PREDICT_CLIENTS)]]
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=60) as r:
                metrics = json.loads(r.read())
            if op.cache_stats()["misses"] != misses:
                fail("predict %s: traffic missed the cache" % dname)
            # each reply against its row alone (bucket 1), before stop()
            # releases the engine's graphs
            replies = [r[1] for c in results for r in c]
            alone = [eng.predict(t[None], s[None], v[None])
                     for t, s, v in payloads]
            cache = op.cache_stats()
        finally:
            srv.stop(timeout=60)
        if metrics["errors"] or metrics["requests"] != len(payloads):
            fail("predict %s: %d requests, %d errors" % (
                dname, metrics["requests"], metrics["errors"]))
        if not metrics["avg_batch_size"] > 1.0:
            fail("predict %s: mean batch %.2f, traffic did not coalesce"
                 % (dname, metrics["avg_batch_size"]))
        lat = sorted(r[0] for c in results for r in c)
        # each output over every reply: the largest difference from the
        # rows run alone, against that output's largest |value|
        rows = {}
        for j, name in enumerate(("pooled", "nsp")):
            got = np.stack([np.asarray(r["outputs"][j], "float32")
                            for r in replies])
            ref = np.stack([a[j].asnumpy().astype("float32")[0]
                            for a in alone])
            if got.shape != ref.shape:
                fail("predict %s: %s replies %s, rows alone %s"
                     % (dname, name, got.shape, ref.shape))
            rows[name] = {"max_abs_err": float(np.abs(got - ref).max()),
                          "max_abs": float(np.abs(ref).max())}
            rows[name]["rel_to_max"] = rows[name]["max_abs_err"] / max(
                rows[name]["max_abs"], 1e-30)
        worst = max(r["rel_to_max"] for r in rows.values())
        if not worst <= PREDICT_TOL[dname]:
            fail("predict %s: batched rows differ from the rows alone by "
                 "%s (tol %g of each output's max)" % (dname, rows,
                                                       PREDICT_TOL[dname]))
        out.update({
            "requests": metrics["requests"], "errors": metrics["errors"],
            "avg_batch_size": metrics["avg_batch_size"],
            "batches": metrics["batches"],
            "client_ms": {"p50": nearest_rank(lat, 50) * 1e3,
                          "p99": nearest_rank(lat, 99) * 1e3},
            "rows_s": len(payloads) / wall, "wall_s": wall,
            "row_vs_alone_rel_to_max": worst, "row_vs_alone": rows,
            "cache": cache})
    return out


def predict_net(torch, seed):
    """The predict phase's fp32 BERT-base on the card, in eval mode: random
    weights from ``seed`` loaded through a ``.params`` file."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ndarray import save_ndarrays
    net = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                    device=torch.device("cuda"))
    params = random_params(net, seed)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "bert_base_seed%d.params" % seed)
    save_ndarrays(path, list(params.values()), list(params))
    try:
        convert.load_mxnet_params(net, path)
    finally:
        os.remove(path)
    net.eval()
    return net


def predict_phase(args, torch):
    """``/predict`` serving of BERT-base: ``ModelServer`` ->
    ``DynamicBatcher`` -> ``InferenceEngine`` -> ``CachedOp`` (one CUDA
    graph per bucket) -> a hybridized ``BERTModel``, fp32 then bf16."""
    from mxnet_tpu_torch import autograd, gpu, nd
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import InferenceEngine
    dev = torch.device("cuda")
    net = predict_net(torch, args.seed)
    net.hybridize()
    rng = np.random.default_rng(args.seed + 11)
    t0 = time.perf_counter()
    fa.reset_launches()
    out = {"model": "bert_base", "seq": PREDICT_SEQ,
           "clients": PREDICT_CLIENTS, "per_client": PREDICT_PER_CLIENT}
    out["float32"] = _predict_dtype(args, torch, net, "float32", rng)

    # the whole BERTModel output (MLM logits too) in-process at bucket 8
    whole = InferenceEngine(net, buckets=(8,), name="bert_whole", ctx=gpu(0))
    t, s, v = _bucket_inputs(torch, rng, 8, dev)
    with autograd.predict_mode():
        got = whole.predict(nd.NDArray(t), nd.NDArray(s), nd.NDArray(v))
        with torch.no_grad():
            ref = net(t, s, v)
    for g, r in zip(got, ref):
        if not torch.equal(g._data, r) or not torch.isfinite(r).all():
            fail("predict: the whole BERTModel at bucket 8 != eager")
    out["whole_model_shapes"] = [list(g.shape) for g in got]
    whole.close()
    del got, ref, whole

    net.cast("bfloat16")
    # the bf16 weights in fp32, built before the engine captures (a
    # parameter given new storage drops every CachedOp's graphs)
    net32 = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ, device=dev)
    net32.load_state_dict(net.state_dict())
    net32.eval()
    out["bfloat16"] = _predict_dtype(args, torch, net, "bfloat16", rng,
                                     truth_net=net32)
    out["launches"] = kernel_launches()
    out["wall_s"] = time.perf_counter() - t0
    del net, net32
    torch.cuda.empty_cache()
    return out


def autograd_phase(args, torch):
    """The classic Gluon loop over NDArrays at ``transformer_lm_base``
    width, from surface (b)'s weights: ``autograd.record()``, the loss's
    ``backward()``, ``gluon.Trainer.step``."""
    from mxnet_tpu_torch import autograd, gpu, initializer, nd
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import transformer_lm_base
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    trandom.seed(args.seed)
    net = transformer_lm_base(vocab_size=32000, max_len=TRAIN_SEQ,
                              device=dev)
    params = net.collect_params()
    params.initialize(initializer.Xavier())
    xs, ys = lm_batch(args.seed + 2)
    loss_fn = SoftmaxCrossEntropyLoss()

    # surface (b)'s first step on tensors, then the same step on NDArrays
    x, y = (torch.from_numpy(a).to(dev) for a in (xs, ys))
    losses = loss_fn(net(x), y)
    losses.backward(torch.ones_like(losses))
    ref_losses = losses.detach().clone()
    ref_grads = {n: p.grad_tensor().clone() for n, p in params.items()}
    params.zero_grad()
    xn, yn = nd.array(xs, ctx=gpu(0)), nd.array(ys, ctx=gpu(0))
    with autograd.record():
        loss = loss_fn(net(xn), yn)
    loss.backward()
    nd_loss = float(loss.mean().asscalar())
    differ = [n for n, p in params.items()
              if not torch.equal(p.grad_tensor(), ref_grads[n])]
    if not torch.equal(loss._data.detach(), ref_losses) or differ:
        fail("autograd: the NDArray step differs from surface (b)'s first "
             "step: losses equal %s, gradients differ %s" % (
                 torch.equal(loss._data.detach(), ref_losses), differ[:4]))
    del ref_grads
    out = {"model": "transformer_lm_base", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "first_loss": nd_loss,
           "first_step_equal_surface_b": True}
    fa.reset_launches()
    for dname in ("float32", "bfloat16"):
        if dname == "bfloat16":
            net.cast("bfloat16")
        tr = Trainer(params, "adam", {"learning_rate": 1e-4,
                                      "multi_precision": dname != "float32"})

        def step(_):
            with autograd.record():
                loss = loss_fn(net(xn), yn)
            loss.backward()
            tr.step(TRAIN_BATCH)
            return loss.mean()._data.float()

        ls, ms = timed_steps(torch, step, AUTOGRAD_STEPS)
        if not all(np.isfinite(ls)):
            fail("autograd %s losses not finite: %r" % (dname, ls))
        out[dname] = {"losses": ls, "step_ms": ms,
                      "step_ms_mean": float(np.mean(ms[1:]))}
        del tr
    out["launches"] = kernel_launches()
    check_launches(out["launches"], 2 * AUTOGRAD_STEPS, net.num_layers,
                   "autograd loop")
    del net, params
    torch.cuda.empty_cache()
    return out


def registry_phase(torch):
    """``nd._contrib_dot_product_attention`` with its default BHSD layout,
    forward and backward under ``autograd.record()``, against the plain
    path (``MXNET_FLASH_ATTENTION=0``)."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ops import flash_attention as fa
    B, S, H, D = REGISTRY_SHAPE
    g = torch.Generator(device="cuda").manual_seed(777)
    fa.reset_launches()
    cases = []

    def run(q, k, v, do, causal):
        leaves = [nd.NDArray(a.clone()) for a in (q, k, v)]
        for a in leaves:
            a.attach_grad()
        with autograd.record():
            o = nd._contrib_dot_product_attention(*leaves, causal=causal)
        o.backward(nd.NDArray(do))
        return [o._data] + [a.grad._data for a in leaves]

    for dt in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            (q, k, v, do), _ = attention_inputs(torch, g, B, S, H, D,
                                                "BHSD", dt, 4, False)
            got = run(q, k, v, do, causal)
            torch.cuda.synchronize()
            ref = on_plain_path(lambda: run(q, k, v, do, causal),
                                "registry op")
            tol = 2e-4 if dt == torch.float32 else 2e-2
            errs = {}
            for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
                err = (a.float() - r.float()).abs().max().item() / max(
                    r.float().abs().max().item(), 1e-30)
                if not err <= tol:
                    fail("registry op %s %s causal=%s: %s differs from the "
                         "plain path by %g of its max" % (dt, "BHSD",
                                                         causal, name, err))
                errs[name] = err
            cases.append({"dtype": str(dt).replace("torch.", ""),
                          "causal": causal, "err_rel_to_max": errs,
                          "tol": tol})
    launches = kernel_launches()
    for name in ("flash_attn_fwd_bhsd", "flash_attn_bwd_dq",
                 "flash_attn_bwd_dkv"):
        if launches[name] != len(cases):
            fail("registry op: %s launched %d times in %d calls"
                 % (name, launches[name], len(cases)))
    if launches["flash_attn_fwd"]:
        fail("registry op: the default layout launched the BSHD forward")
    return {"shape": "B=%d S=%d H=%d D=%d BHSD" % REGISTRY_SHAPE,
            "cases": cases, "launches": launches}


VISION_BATCH, VISION_IMAGE, VISION_CLASSES = 32, 224, 1000
VISION_STEPS, VISION_SPAN = 3, 8
VISION_SGD = {"learning_rate": 0.1, "momentum": 0.9}   # bench.py's
VISION_BF16_TOL = 2e-2      # bf16 logits against fp32 ones, of their max
VISION_STATS_TOL = 1e-5     # moving statistics, of their largest |value|
VISION_CHECK_WD = 0.1       # a decay would move the statistics by 1%
VISION_REPLAYS = 20


def _resnet50(torch, trandom, seed):
    """``resnet50_v1()`` as the reference's ``entry()`` makes it:
    ``random.seed``, ``initialize(Xavier())`` on the card, one forward at
    (1, 3, 224, 224) to settle the deferred shapes."""
    from mxnet_tpu_torch import initializer, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    trandom.seed(seed)
    np.random.seed(seed)
    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier())
    net(nd.zeros((1, 3, VISION_IMAGE, VISION_IMAGE)))
    return net


def _events_ms(torch, fn, n):
    """``fn()`` ``n`` times between two CUDA events: ms a call."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def vision_inference(args, torch):
    """(a) ``__graft_entry__.entry()`` step for step: ResNet-50 v1 from
    ``Xavier()``, cast to bf16 (BatchNorm stays fp32), the b32 bf16
    forward through ``functionalize(net, train=False)`` and hybridized
    (a CUDA-graph replay), bitwise equal, and against an fp32 copy of the
    same weights."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.parallel import functionalize
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    net = _resnet50(torch, trandom, args.seed)
    init_s = time.perf_counter() - t0
    net.cast("bfloat16")
    bn = {id(p) for m in net.modules() if isinstance(m, BatchNorm)
          for p in (m.gamma, m.beta, m.running_mean, m.running_var)}
    params = net.collect_params()
    wrong = [n for n, p in params.items()
             if p.dtype != (torch.float32 if id(p) in bn
                            else torch.bfloat16)]
    if len(bn) != 4 * 53 or wrong:
        fail("vision: after cast('bfloat16') %d BatchNorm parameters, "
             "wrong dtypes %s" % (len(bn), wrong[:4]))
    x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                   generator=torch.Generator().manual_seed(args.seed)) \
        .to(dev, torch.bfloat16)
    pure, plist = functionalize(net, train=False)
    vals = [p.tensor() for p in plist]

    def eager():
        with torch.no_grad():
            return pure(None, vals, x)[0][0]
    out = eager()
    net.hybridize()
    xn = NDArray(x)
    with autograd.predict_mode():
        net(xn)                                 # the capture
        replay = net(xn)._data
    if not torch.equal(replay, out):
        fail("vision: the CUDA-graph replay differs from the eager forward "
             "(max |diff| %g)" % (replay.float() - out.float()).abs().max())
    op = next(iter(net._cached_ops.values()))
    with autograd.predict_mode():
        replay_ms = _events_ms(torch, lambda: net(xn), VISION_REPLAYS)
    eager_ms = _events_ms(torch, eager, 5)
    # an fp32 copy of the same (bf16) weights on the same inputs
    net32 = _resnet50(torch, trandom, args.seed)
    for p, q in zip(net32.collect_params().values(), params.values()):
        p.set_data(q.data().astype("float32"))
    net32.eval()
    with torch.no_grad():
        out32 = net32(x.float())
    err = float((out.float() - out32).abs().max() / out32.abs().max())
    if not (err <= VISION_BF16_TOL and torch.isfinite(out).all()):
        fail("vision: bf16 logits %.3g of their max from the fp32 copy's "
             "(tolerance %g)" % (err, VISION_BF16_TOL))
    res = {"model": "resnet50_v1", "batch": VISION_BATCH,
           "image": VISION_IMAGE, "init_s": init_s,
           "batchnorm_params_fp32": len(bn), "out_shape": list(out.shape),
           "replay_equals_eager": True, "bf16_vs_fp32_rel_to_max": err,
           "eager_ms": eager_ms, "replay_ms": replay_ms,
           "img_s_replay": VISION_BATCH * 1e3 / replay_ms,
           "img_s_eager": VISION_BATCH * 1e3 / eager_ms,
           "capture_ms": list(op.capture_ms.values()),
           "pool_bytes": op.pool_bytes}
    if args.profile:
        with autograd.predict_mode():
            res["profile_eager"] = profile(torch, eager)
    del net, net32, op, out, out32, replay, vals
    return res


def _stats_check(torch, net, dname, seed):
    """One step with weight decay through a fresh ``ShardedTrainer``: the
    stem BatchNorm's moving statistics must be ``0.9 * old + 0.1 *
    batch`` of its own input (mean and biased variance taken here in
    float64), in the trainer and in the block, and no decay may touch
    them."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    dev = torch.device("cuda")
    bn = net.features[1]
    seen = []
    hook = bn.register_forward_hook(
        lambda blk, a, o: seen.append(a[0].detach().double()))
    trainer = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(VISION_SGD, wd=VISION_CHECK_WD))
    names = {id(t): n for n, t in net.named_parameters()}
    key = {leaf: names[id(getattr(bn, leaf).tensor())]
           for leaf in ("running_mean", "running_var", "gamma")}
    old = {k: trainer.values[n].detach().double().clone()
           for k, n in key.items()}
    g = torch.Generator(dev).manual_seed(seed)
    dt = torch.bfloat16 if dname == "bfloat16" else torch.float32
    x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                   generator=g, device=dev, dtype=dt)
    y = torch.randint(0, VISION_CLASSES, (VISION_BATCH,), generator=g,
                      device=dev).float()
    trainer.step(x, y)
    hook.detach()
    a = seen[0]
    want = {"running_mean": 0.9 * old["running_mean"]
            + 0.1 * a.mean(dim=(0, 2, 3)),
            "running_var": 0.9 * old["running_var"]
            + 0.1 * a.var(dim=(0, 2, 3), unbiased=False)}
    errs = {}
    for leaf, w in want.items():
        got = trainer.values[key[leaf]].detach().double()
        block = getattr(bn, leaf).tensor().detach().double()
        errs[leaf] = float((got - w).abs().max() / w.abs().max())
        if errs[leaf] > VISION_STATS_TOL or not torch.equal(got, block):
            fail("vision %s: %s %.3g of its max from the momentum rule "
                 "(tolerance %g), block equal %s" % (
                     dname, leaf, errs[leaf], VISION_STATS_TOL,
                     torch.equal(got, block)))
    moved = float((trainer.values[key["gamma"]].detach().double()
                   - old["gamma"]).abs().max())
    if moved == 0.0:
        fail("vision %s: the optimizer left gamma unchanged" % dname)
    del trainer
    return {"stem_bn_err_rel_to_max": errs, "wd": VISION_CHECK_WD,
            "gamma_moved": moved}


def vision_training(args, torch, dname):
    """(b) ``bench.py``'s ``resnet50_train`` configuration: b32 at 224^2,
    ``SoftmaxCrossEntropyLoss``, SGD lr 0.1 momentum 0.9 through
    ``ShardedTrainer`` (the net cast first in bf16, as ``bench.py``
    does); a few ``step``s, then one ``bench_span``."""
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    dev = torch.device("cuda")
    net = _resnet50(torch, trandom, args.seed)
    if dname == "bfloat16":
        net.cast("bfloat16")
    check = _stats_check(torch, net, dname, args.seed + 1)
    trainer = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(VISION_SGD))
    g = torch.Generator(dev).manual_seed(args.seed + 2)
    dt = torch.bfloat16 if dname == "bfloat16" else torch.float32
    x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                   generator=g, device=dev, dtype=dt)
    y = torch.randint(0, VISION_CLASSES, (VISION_BATCH,), generator=g,
                      device=dev).float()
    losses, ms = train_steps(torch, trainer, x, y, VISION_STEPS)
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    span = trainer.bench_span(VISION_SPAN, (VISION_BATCH, 3, VISION_IMAGE,
                                            VISION_IMAGE), VISION_CLASSES,
                              dtype=dname)
    e1.record()
    torch.cuda.synchronize()
    span_ms = e0.elapsed_time(e1) / VISION_SPAN
    span = [float(v) for v in span]
    if not all(np.isfinite(losses + span)):
        fail("vision %s: losses not finite: %r %r" % (dname, losses, span))
    res = {"losses": losses, "step_ms": ms, "span_losses": span,
           "span_step_ms": span_ms,
           "img_s": VISION_BATCH * 1e3 / span_ms,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9, "stats": check}
    if args.profile and dname == "bfloat16":
        res["profile"] = profile(torch, lambda: trainer.step(x, y))
    del trainer, net
    return res


def vision_phase(args, torch):
    """ResNet-50 v1 inference (a) and training (b, fp32 and bf16); no
    flash kernel runs on this path."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.reset_launches()
    out = {"inference": vision_inference(args, torch)}
    torch.cuda.empty_cache()
    for dname in ("float32", "bfloat16"):
        out[dname] = vision_training(args, torch, dname)
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = kernel_launches()
    if any(out["launches"].values()):
        fail("vision: a flash kernel launched on the vision path: %s"
             % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


# the data phase: ResNet-50 v1 trained from a RecordIO file
DATA_IMAGES, DATA_SIDE = 640, 256          # raw 3 x 256 x 256 uint8 records
DATA_STEPS, DATA_CHUNK, DATA_DEPTH = 16, 8, 4
DATA_MEAN = (123.68, 116.28, 103.53)       # the reference's ImageNet ones
DATA_STD = (58.395, 57.12, 57.375)
DATA_LOADER_BATCHES, DATA_LOADER_WORKERS = 4, 4
DATA_H2D_COPIES = 10


def write_rec(args, dirname):
    """``DATA_IMAGES`` raw records (``pack_img(..., ".raw")``: the card
    has no libjpeg), each a 3 x 256 x 256 uint8 image made from ``--seed``
    with numpy, label ``i % 1000``, with an ``.idx`` for the datasets."""
    from mxnet_tpu_torch import recordio
    path = os.path.join(dirname, "train.rec")
    rec = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    rng = np.random.default_rng(args.seed + 11)
    for i in range(DATA_IMAGES):
        img = rng.integers(0, 256, (DATA_SIDE, DATA_SIDE, 3), dtype=np.uint8)
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % VISION_CLASSES), i, 0), img,
            img_fmt=".raw"))
    rec.close()
    return path


def _bits_sum(a):
    """An exact, order-free checksum of float32 data: the sum of its bit
    patterns as int64 (numpy array or tensor)."""
    if isinstance(a, np.ndarray):
        return int(a.view(np.int32).astype(np.int64).sum())
    import torch
    return a.contiguous().view(torch.int32).to(torch.int64).sum()


class _Kept:
    """An iterator's host batches, passed on and kept (``step()`` runs
    over the same batches afterwards)."""

    def __init__(self, it):
        self.it = it
        self.batches = []

    def __iter__(self):
        for b in self.it:
            x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
            self.batches.append((x, y))
            yield x, y


def _checked_feed(torch):
    from mxnet_tpu_torch.parallel import DeviceFeed

    class CheckedFeed(DeviceFeed):
        """A DeviceFeed that takes each served batch's checksum on the
        consumer's stream (no host sync)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.sums = []

        def __next__(self):
            item = super().__next__()
            self.sums.append(_bits_sum(item[0][0]))
            return item
    return CheckedFeed


def data_training(args, torch, path, dname):
    """One dtype: ``step_stream`` over a ``DeviceFeed`` of the native
    ``ImageRecordIter``, then ``step()`` over the same host batches from
    the same parameters, then ``bench_span`` on the fed trainer."""
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.io import ImageRecordIter
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net = _resnet50(torch, trandom, args.seed)
    pre = None
    if dname == "bfloat16":
        net.cast("bfloat16")
        pre = lambda x: x.to(torch.bfloat16)   # noqa: E731
    fed, ref = (ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                               dict(VISION_SGD), preprocess=pre)
                for _ in range(2))
    it = ImageRecordIter(path, **_record_kw())
    if not it.native:
        fail("data %s: ImageRecordIter took the pure-Python path" % dname)
    kept = _Kept(it)
    feed = _checked_feed(torch)(kept, depth=DATA_DEPTH, name="data." + dname)
    try:
        staged = feed.prefill(timeout=120.0)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        losses = fed.step_stream(feed, steps=DATA_STEPS, chunk=DATA_CHUNK)
        e1.record()
        torch.cuda.synchronize()
        fed_ms = e0.elapsed_time(e1) / DATA_STEPS
        stats = feed.stats()
        sums = [int(v) for v in feed.sums]
    finally:
        feed.close()
        it.close()
    if stats["stage_waits"]:
        fail("data %s: the consumer waited %d times on staging after the "
             "warm-up" % (dname, stats["stage_waits"]))
    host = kept.batches[:DATA_STEPS]
    if len(sums) != DATA_STEPS or \
            sums != [_bits_sum(x) for x, _ in host]:
        fail("data %s: a staged batch differs from its host batch" % dname)
    ref_losses = torch.stack([ref.step(x, y) for x, y in host])
    if not torch.equal(losses, ref_losses):
        fail("data %s: step_stream losses %s != step() losses %s"
             % (dname, losses.tolist(), ref_losses.tolist()))
    fl = [float(v) for v in losses]
    if not all(np.isfinite(fl)):
        fail("data %s: losses not finite: %r" % (dname, fl))
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fed.bench_span(VISION_SPAN, (VISION_BATCH, 3, VISION_IMAGE,
                                 VISION_IMAGE), VISION_CLASSES, dtype=dname)
    e1.record()
    torch.cuda.synchronize()
    span_ms = e0.elapsed_time(e1) / VISION_SPAN
    del fed, ref, net
    return {"losses": fl, "fed_step_ms": fed_ms,
            "fed_img_s": VISION_BATCH * 1e3 / fed_ms,
            "span_step_ms": span_ms,
            "span_img_s": VISION_BATCH * 1e3 / span_ms,
            "staged_before": staged, "feed": stats}


def _record_kw():
    return dict(data_shape=(3, VISION_IMAGE, VISION_IMAGE),
                batch_size=VISION_BATCH, rand_crop=True, rand_mirror=True,
                mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1],
                mean_b=DATA_MEAN[2], std_r=DATA_STD[0], std_g=DATA_STD[1],
                std_b=DATA_STD[2])


def data_loader_check(torch, path):
    """``DataLoader(ImageRecordDataset(...).transform_first(...),
    pin_memory=True, num_workers=4)``: four batches, CUDA NDArrays equal
    to the unpinned loader's."""
    import itertools
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    tf = T.Compose([T.ToTensor(),
                    T.Normalize([m / 255 for m in DATA_MEAN],
                                [d / 255 for d in DATA_STD])])
    ds = ImageRecordDataset(path).transform_first(tf)
    got = {}
    t0 = time.perf_counter()
    for pin in (True, False):
        loader = DataLoader(ds, batch_size=VISION_BATCH, pin_memory=pin,
                            num_workers=DATA_LOADER_WORKERS)
        got[pin] = [(x.asnumpy(), y.asnumpy(), x.ctx.device_type)
                    for x, y in itertools.islice(loader,
                                                 DATA_LOADER_BATCHES)]
        del loader
    wall = time.perf_counter() - t0
    for (a, b, dev), (c, d, host) in zip(got[True], got[False]):
        if dev != "gpu" or host != "cpu" or not np.array_equal(a, c) or \
                not np.array_equal(b, d):
            fail("pinned DataLoader batch (%s) differs from the unpinned "
                 "one (%s)" % (dev, host))
    if len(got[True]) != DATA_LOADER_BATCHES:
        fail("pinned DataLoader gave %d batches" % len(got[True]))
    return {"batches": DATA_LOADER_BATCHES, "workers": DATA_LOADER_WORKERS,
            "wall_s": wall, "shape": list(got[True][0][0].shape)}


def data_phase(args, torch):
    """ResNet-50 v1 trained from a RecordIO file: the native pump, a
    ``DeviceFeed`` of pinned host buffers, ``step_stream``; the pinned
    ``DataLoader``. No flash kernel runs on this path."""
    import tempfile
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.io import ImageRecordIter
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.reset_launches()
    t = time.perf_counter()
    _native.build()
    out = {"native_build_s": time.perf_counter() - t,
           "native_jpeg": _native.has_jpeg()}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as d:
        t = time.perf_counter()
        path = write_rec(args, d)
        out["rec_write_s"] = time.perf_counter() - t
        out["rec_bytes"] = os.path.getsize(path)
        it = ImageRecordIter(path, **_record_kw())
        if not it.native:
            fail("data: ImageRecordIter took the pure-Python path")
        t = time.perf_counter()
        n = sum(1 for _ in it)
        out["pump_batches_s"] = n / (time.perf_counter() - t)
        it.close()
        pinned = torch.empty((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                             pin_memory=True)
        dev = torch.empty(pinned.shape, device="cuda")
        dev.copy_(pinned, non_blocking=True)
        ms = _events_ms(torch, lambda: dev.copy_(pinned, non_blocking=True),
                        DATA_H2D_COPIES)
        out["h2d_gb_s"] = pinned.numel() * 4 / ms / 1e6
        del pinned, dev
        try:
            for dname in ("float32", "bfloat16"):
                out[dname] = data_training(args, torch, path, dname)
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = det
        out["loader"] = data_loader_check(torch, path)
    out["launches"] = kernel_launches()
    if any(out["launches"].values()):
        fail("data: a flash kernel launched on the data path: %s"
             % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


# the rnn phase: the LSTM word language model at WikiText-2 width
# (benchmark/bench_lm.py:266-300)
RNN_VOCAB, RNN_WIDTH, RNN_LAYERS = 33278, 1500, 2
RNN_SEQ, RNN_BATCH, RNN_STEPS = 35, 128, 8
RNN_SGD = {"learning_rate": 1.0}
# (b) cuDNN against the plain per-step path in fp32, with the tolerances
# of tests/test_torch_rnn.py (outputs, here the loss, within 1e-5 of
# their largest |value|; gradients within 1e-4 of theirs); in bf16 each
# path against an fp32 run on an fp32 copy of the bf16 weights, each
# gradient of the card's path at most twice as far as the plain path's
# same gradient (PREDICT_BF16_FACTOR), the plain distance floored at one
# bf16 step at the gradient's largest |value| (2^-8 of it)
RNN_LOSS_TOL, RNN_GRAD_TOL, RNN_BF16_FACTOR = 1e-5, 1e-4, 2.0
RNN_BF16_FLOOR = 2.0 ** -8
# (c) example/gluon/word_language_model.py's loop: dropout 0.2, the clip
RNN_EAGER_STEPS, RNN_EAGER_DROPOUT, RNN_CLIP = 4, 0.2, 0.25
# (d) calls timed a side; (e) the estimator's batch and epoch
RNN_CALLS = 10
RNN_EST_BATCH, RNN_EST_BATCHES = 32, 8
RNN_KERNEL_RE = re.compile(r"(?i)rnn|lstm|gru|cudnn")


class RNNLoss:
    """``benchmark/bench_lm.py``'s ``LMLoss``: the float32 log-softmax
    cross-entropy over ``(T*B, V)``, its mean."""

    def __call__(self, out, y):
        import torch
        logp = torch.log_softmax(out.float(), dim=-1)
        return -logp.reshape(-1, logp.shape[-1]).gather(
            1, y.reshape(-1, 1).long()).mean()


def rnn_model(seed, dropout=0.0, init=True):
    """``RNNModel("lstm", 33278, 1500, 1500, 2)`` as the reference's bench
    makes it: ``random.seed``, then ``initialize(Xavier())`` on the card
    (when ``init``)."""
    from mxnet_tpu_torch import initializer, random as trandom
    from mxnet_tpu_torch.models import RNNModel
    trandom.seed(seed)
    np.random.seed(seed)
    net = RNNModel("lstm", RNN_VOCAB, RNN_WIDTH, RNN_WIDTH, RNN_LAYERS,
                   dropout=dropout)
    if init:
        net.initialize(initializer.Xavier())
    return net


def rnn_batch(seed, batch=None):
    """Random ``(T, B)`` tokens and labels (B 128 unless ``batch``), as
    the bench draws them."""
    rng = np.random.default_rng(seed)
    shape = (RNN_SEQ, batch or RNN_BATCH)
    return (rng.integers(0, RNN_VOCAB, shape),
            rng.integers(0, RNN_VOCAB, shape))


def rnn_grads(torch, net, values, x, y, dtype, plain):
    """The loss and every gradient (as fp32) of ``RNNLoss`` over ``net``
    run on copies of ``values`` in ``dtype``, through the card's path or
    the plain one (``force_plain``)."""
    import contextlib
    from torch.func import functional_call
    from mxnet_tpu_torch.ops import rnn as orn
    vals = {n: v.detach().to(dtype).clone().requires_grad_()
            for n, v in values.items()}
    net.train()
    with orn.force_plain() if plain else contextlib.nullcontext():
        loss = RNNLoss()(functional_call(net, vals, (x,)), y)
        loss.backward()
    return float(loss.detach()), {n: v.grad.float() for n, v in vals.items()}


def rnn_against_plain(torch, net, x, y):
    """(b) The first step's loss and gradients at full width, the card's
    path against the plain per-step one: fp32 within the CPU tests'
    tolerances; in bf16 both held against fp32 on an fp32 copy of the
    bf16 weights."""
    from mxnet_tpu_torch.ops import rnn as orn
    values = {n: p.detach() for n, p in net.named_parameters()}
    before = orn.path_counts()
    loss_c, g_c = rnn_grads(torch, net, values, x, y, torch.float32, False)
    loss_p, g_p = rnn_grads(torch, net, values, x, y, torch.float32, True)
    took = {k: v - before[k] for k, v in orn.path_counts().items()}
    if took != {"cudnn": RNN_LAYERS, "native": 0, "plain": RNN_LAYERS}:
        fail("rnn (b): the fp32 runs took the paths %s" % took)
    err = {n: rel_to_max(g_c[n], g_p[n]) for n in g_p}
    worst = max(err, key=err.get)
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    out = {"float32": {"loss_cudnn": loss_c, "loss_plain": loss_p,
                       "loss_rel_err": loss_rel, "grad_worst_param": worst,
                       "grad_worst_rel_to_max": err[worst],
                       "loss_tol": RNN_LOSS_TOL, "grad_tol": RNN_GRAD_TOL}}
    if loss_rel > RNN_LOSS_TOL or err[worst] > RNN_GRAD_TOL:
        fail("rnn (b): fp32 cuDNN against plain: loss rel %g (tol %g), "
             "gradient of %s %g of its max (tol %g)" % (
                 loss_rel, RNN_LOSS_TOL, worst, err[worst], RNN_GRAD_TOL))
    del g_c, g_p
    rounded = {n: v.to(torch.bfloat16).float() for n, v in values.items()}
    truth = rnn_grads(torch, net, rounded, x, y, torch.float32, True)[1]
    runs = {"card": rnn_grads(torch, net, rounded, x, y, torch.bfloat16,
                              False),
            "plain": rnn_grads(torch, net, rounded, x, y, torch.bfloat16,
                               True)}
    dist = {k: {n: rel_to_max(g[n], truth[n]) for n in truth}
            for k, (_, g) in runs.items()}
    # each parameter's cuDNN distance against the plain path's for the
    # same parameter, the plain one floored at RNN_BF16_FLOOR
    ratio = {n: dist["card"][n] / max(dist["plain"][n], RNN_BF16_FLOOR)
             for n in truth}
    worst = max(ratio, key=ratio.get)
    out["bfloat16"] = {
        "path": orn.layer_path(torch.zeros(1, device=x.device,
                                           dtype=torch.bfloat16)),
        "loss": runs["card"][0], "loss_plain": runs["plain"][0],
        "grad_rel_to_max": {n: [dist["card"][n], dist["plain"][n]]
                            for n in truth},
        "worst_ratio_param": worst, "worst_ratio": ratio[worst],
        "factor": RNN_BF16_FACTOR, "floor": RNN_BF16_FLOOR}
    if ratio[worst] > RNN_BF16_FACTOR:
        fail("rnn (b): bf16 gradient of %s %g of its max from fp32, more "
             "than %g x the plain path's %g (floor %g)" % (
                 worst, dist["card"][worst], RNN_BF16_FACTOR,
                 dist["plain"][worst], RNN_BF16_FLOOR))
    return out


def rnn_weight_copy(torch, values, caught):
    """The copy of the LSTM's weights into cuDNN's flat buffer that every
    call makes (the layer's tensors are separate parameters): whether torch
    warned of it, its bytes a step (one forward), and the time of one copy
    of as many bytes between CUDA events."""
    ws = [v.detach() for n, v in values.items() if n.startswith("rnn.")]
    flat = torch.empty(sum(p.numel() for p in ws), device=ws[0].device,
                       dtype=ws[0].dtype)

    def copy():
        off = 0
        for p in ws:
            flat[off:off + p.numel()].copy_(p.reshape(-1))
            off += p.numel()
    copy()
    msgs = [str(w.message) for w in caught]
    return {"warned": any("single contiguous chunk" in m for m in msgs),
            "warnings": sorted(set(m[:160] for m in msgs)),
            "bytes_a_step": flat.numel() * flat.element_size(),
            "copy_ms": _events_ms(torch, copy, RNN_CALLS)}


def rnn_training(args, torch, net, dname):
    """(a) ``bench_lstm``: SGD lr 1.0 through ``ShardedTrainer`` (no mesh:
    one device), 8 steps at b128 s35; step ms (CUDA events, steps 2..8),
    tokens/s, peak memory, losses, the paths each step took; then the
    same step once more under ``torch.profiler``."""
    import warnings
    from mxnet_tpu_torch.ops import rnn as orn
    from mxnet_tpu_torch.parallel import ShardedTrainer
    tr = ShardedTrainer(net, RNNLoss(), "sgd", dict(RNN_SGD),
                        dtype=None if dname == "float32" else dname)
    x, y = rnn_batch(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    orn.reset_path_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses, ms = train_steps(torch, tr, x, y, RNN_STEPS)
    shown = set()
    for w in caught:    # shown (once each) as well as counted
        if str(w.message) not in shown:
            shown.add(str(w.message))
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    paths = orn.path_counts()
    if paths != {"cudnn": RNN_STEPS * RNN_LAYERS, "native": 0, "plain": 0}:
        fail("rnn (a) %s: the layers took the paths %s, not %d cuDNN calls"
             % (dname, paths, RNN_STEPS * RNN_LAYERS))
    if not all(np.isfinite(losses)):
        fail("rnn (a) %s: losses %s" % (dname, losses))
    mean = float(np.mean(ms[1:]))
    out = {"losses": losses, "step_ms": ms, "step_ms_mean": mean,
           "first_step_ms": ms[0],
           "tokens_s": RNN_SEQ * RNN_BATCH / mean * 1e3,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "paths": paths,
           "weight_copy": rnn_weight_copy(torch, tr.values, caught),
           "lstm_ms": rnn_lstm_ms(torch, net, tr.values)}
    out["profile"] = profile(torch, lambda: tr.step(x, y), RNN_KERNEL_RE)
    if not any("RNN" in n or "LSTM" in n for n in out["profile"]["matched"]):
        fail("rnn (a) %s: no cuDNN RNN kernel in the profile: %s"
             % (dname, out["profile"]["matched"]))
    return out


def rnn_lstm_ms(torch, net, values):
    """The LSTM stack's forward and backward alone (cuDNN), on the
    trainer's values and a ``(T, B, 1500)`` input: ms a call between CUDA
    events, the part of a step the RNN kernels and their GEMMs take."""
    from torch.func import functional_call
    vals = {n[len("rnn."):]: v for n, v in values.items()
            if n.startswith("rnn.")}
    dtype = next(iter(vals.values())).dtype
    x = torch.randn(RNN_SEQ, RNN_BATCH, RNN_WIDTH, device="cuda",
                    dtype=dtype, requires_grad=True)

    def run():
        functional_call(net.rnn, vals, (x,)).float().sum().backward()
    run()
    ms = _events_ms(torch, run, RNN_CALLS)
    for v in vals.values():
        v.grad = None
    return ms


def rnn_eager(args, torch):
    """(c) ``example/gluon/word_language_model.py``'s loop at the same
    width, fp32: ``gluon.Trainer("sgd")``, the hidden state carried and
    detached, ``clip_global_norm(grads, 0.25 * bptt * batch)``, dropout
    0.2 (keyed ``Dropout``), fed by ``mx.rnn.BucketSentenceIter`` over a
    synthetic corpus (the example's Markov-ish rule, vocab 33278)."""
    import random
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import rnn as mrnn
    net = rnn_model(args.seed + 1, dropout=RNN_EAGER_DROPOUT)
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0,
                                            "momentum": 0, "wd": 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(args.seed)
    corpus = [0]
    for _ in range(RNN_EAGER_STEPS * RNN_BATCH * RNN_SEQ - 1):
        corpus.append((corpus[-1] * 31 + rng.randint(0, 7)) % RNN_VOCAB)
    sentences = [corpus[i:i + RNN_SEQ]
                 for i in range(0, len(corpus), RNN_SEQ)]
    random.seed(args.seed)
    np.random.seed(args.seed)
    it = mrnn.BucketSentenceIter(sentences, RNN_BATCH, buckets=[RNN_SEQ],
                                 layout="TN")
    hidden = net.begin_state(batch_size=RNN_BATCH)
    ctx = hidden[0].ctx
    losses, norms, events = [], [], []
    for batch in it:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        x = batch.data[0].as_in_context(ctx)
        y = batch.label[0].as_in_context(ctx).reshape((-1,))
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            output, hidden = net(x, hidden)
            L = loss_fn(output.reshape((-1, RNN_VOCAB)), y).mean()
        L.backward()
        grads = [p.grad() for p in params.values() if p.grad_req != "null"]
        norms.append(float(gluon.utils.clip_global_norm(
            grads, RNN_CLIP * RNN_SEQ * RNN_BATCH)))
        trainer.step(1)
        losses.append(float(L.asscalar()))
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    if len(losses) != RNN_EAGER_STEPS or not all(np.isfinite(losses)) \
            or not all(np.isfinite(norms)):
        fail("rnn (c): %d steps, losses %s, norms %s"
             % (len(losses), losses, norms))
    return {"losses": losses, "clip_norms": norms, "step_ms": ms,
            "step_ms_mean": float(np.mean(ms[1:]))}


def rnn_inference(args, torch, net, dname):
    """(d) The hybridized ``RNNModel`` forward with ``hidden`` through
    ``CachedOp`` (a CUDA graph) at b128 s35, against the same call eager:
    equal bit for bit; ms a call of each (CUDA events)."""
    from mxnet_tpu_torch import cached_op, nd
    x, _ = rnn_batch(args.seed + 2)
    x = nd.array(x.astype(np.float32))
    hidden = net.begin_state(batch_size=RNN_BATCH, dtype=dname)
    net.hybridize(False)

    def eager():
        return net(x, hidden)
    e_out, e_hid = eager()
    e_ms = _events_ms(torch, eager, RNN_CALLS)
    net.hybridize()
    cached_op.reset_cache_stats()
    r_out, r_hid = net(x, hidden)          # the capture
    r_out, r_hid = net(x, hidden)          # a replay
    r_ms = _events_ms(torch, lambda: net(x, hidden), RNN_CALLS)
    stats = cached_op.cache_stats()
    net.hybridize(False)
    pairs = [("output", e_out, r_out)] + [
        ("state%d" % i, a, b) for i, (a, b) in enumerate(zip(e_hid, r_hid))]
    for what, a, b in pairs:
        if not torch.equal(a._data, b._data):
            fail("rnn (d) %s: the replayed %s differs from eager (max %g)"
                 % (dname, what, (a._data.float() - b._data.float())
                    .abs().max().item()))
    if stats["misses"] != 1 or stats["hits"] < RNN_CALLS + 1:
        fail("rnn (d) %s: CachedOp %s" % (dname, stats))
    return {"eager_ms": e_ms, "replay_ms": r_ms, "cache": stats,
            "bitwise": True,
            "tokens_s_replay": RNN_SEQ * RNN_BATCH / r_ms * 1e3}


def rnn_estimator(args, torch, net):
    """(e) ``Estimator.fit`` for one epoch of 8 batches of a pinned
    ``DataLoader`` over token windows at b32 (``Loss`` and ``Accuracy``
    metrics, ``LoggingHandler``, ``CheckpointHandler`` into a temporary
    directory); the checkpoint, loaded through ``load_mxnet_params`` into a
    fresh ``RNNModel``, must give the trained model's forward bit for
    bit."""
    import logging
    import tempfile
    from mxnet_tpu_torch import autograd, convert, gluon, gpu, metric, nd
    from mxnet_tpu_torch.gluon.contrib.estimator import (
        CheckpointHandler, Estimator, LoggingHandler)
    rng = np.random.default_rng(args.seed + 3)
    n = RNN_EST_BATCH * RNN_EST_BATCHES
    windows = rng.integers(0, RNN_VOCAB, (n, RNN_SEQ + 1)).astype(np.float32)
    ds = gluon.data.ArrayDataset(windows[:, :-1], windows[:, 1:])
    loader = gluon.data.DataLoader(ds, batch_size=RNN_EST_BATCH,
                                   pin_memory=True)
    class TimeMajorEstimator(Estimator):
        """The loader's ``(B, T)`` batches enter ``RNNModel`` as ``(T,
        B)``."""

        def fit_batch(self, train_batch, batch_axis=0):
            data, label = train_batch[0].T, train_batch[1].T
            with autograd.record():
                pred = self.net(data)
                loss = self.loss(pred, label)
            loss.backward()
            self.trainer.step(data.shape[1])
            return data, label, pred, loss

    est = TimeMajorEstimator(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        metrics=[metric.Accuracy(axis=2)],
        trainer=gluon.Trainer(net.collect_params(), "sgd", dict(RNN_SGD)))
    if est.context != [gpu(0)]:
        fail("rnn (e): the estimator's default context is %s" % est.context)
    seen = []

    class Record(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())
    log = logging.getLogger(
        "mxnet_tpu_torch.gluon.contrib.estimator.event_handler")
    rec = Record()
    log.addHandler(rec)
    log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rnn_") as d:
            est.fit(loader, epochs=1, event_handlers=[
                LoggingHandler(metrics=est.train_metrics
                               + est.train_loss_metrics),
                CheckpointHandler(d, model_prefix="rnnlm")])
            wall = time.perf_counter() - t0
            path = os.path.join(d, "rnnlm-epoch1.params")
            fresh = rnn_model(args.seed, init=False)
            convert.load_mxnet_params(fresh, path)
    finally:
        log.removeHandler(rec)
    x = nd.array(rnn_batch(args.seed + 4, RNN_EST_BATCH)[0]
                 .astype(np.float32))
    a, b = net(x), fresh(x)
    if not torch.equal(a._data, b._data):
        fail("rnn (e): the reloaded checkpoint's forward differs (max %g)"
             % (a._data - b._data).abs().max().item())
    loss = est.train_loss_metrics[0].get()[1]
    acc = est.train_metrics[0].get()[1]
    if not np.isfinite(loss) or not 0.0 <= acc <= 1.0:
        fail("rnn (e): loss %r, accuracy %r" % (loss, acc))
    del fresh
    return {"loss": loss, "accuracy": acc, "wall_s": wall, "log": seen,
            "checkpoint_bitwise": True}


def rnn_phase(args, torch):
    """The LSTM word language model at WikiText-2 width: (a) training,
    (b) the card's path against the plain one, (c) the eager loop, (d)
    inference through ``CachedOp``, (e) the estimator. No flash kernel
    runs on this path."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.reset_launches()
    net = rnn_model(args.seed)
    out = {"init_s": time.perf_counter() - t0}
    x, y = (torch.as_tensor(v, device="cuda") for v in rnn_batch(args.seed))
    out["plain_check"] = rnn_against_plain(torch, net, x, y)
    del x, y
    for dname in ("float32", "bfloat16"):
        out[dname] = rnn_training(args, torch, net, dname)
        gc.collect()
        torch.cuda.empty_cache()
    out["eager"] = rnn_eager(args, torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["inference"] = {"float32": rnn_inference(args, torch, net,
                                                 "float32")}
    out["estimator"] = rnn_estimator(args, torch, net)
    net.cast("bfloat16")
    out["inference"]["bfloat16"] = rnn_inference(args, torch, net,
                                                 "bfloat16")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = kernel_launches()
    if any(out["launches"].values()):
        fail("rnn: a flash kernel launched on the rnn path: %s"
             % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


# the symbol phase: ResNet-50 v1 exported, imported, served and trained
# through Module, and the attention op through an Executor
SYMBOL_OPS = {"Convolution": 53, "BatchNorm": 53, "Activation": 49,
              "Pooling": 2, "add": 16, "FullyConnected": 1}
SYMBOL_REPLAYS = 20
SYMBOL_WAVES = (1, 3, 4)        # /predict requests sent together (8 in all)
SYMBOL_BUCKETS = (1, 2, 4)
SYMBOL_PREDICT_TOL = 1e-5       # an answer against the block's row, of max
SYMBOL_STEPS = 8
SYMBOL_STEP_TOL = 1e-5          # Module step against Gluon's, of each max


def _graph_ops(path):
    with open(path) as f:
        nodes = json.load(f)["nodes"]
    ops = {}
    for n in nodes:
        if n["op"] != "null":
            ops[n["op"]] = ops.get(n["op"], 0) + 1
    return ops


def _replay_check(torch, blocks, xn, what):
    """Hybridize each block; its CUDA-graph replay must equal its eager
    output; the replay ms of each."""
    from mxnet_tpu_torch import autograd
    out = {}
    for name, (block, eager) in blocks.items():
        block.hybridize()
        with autograd.predict_mode():
            block(xn)                           # the capture
            replay = block(xn)._data
            if not torch.equal(replay, eager):
                fail("symbol %s: %s's replay differs from its eager forward "
                     "(max |diff| %g)" % (what, name, (
                         replay.float() - eager.float()).abs().max()))
            out[name] = _events_ms(torch, lambda: block(xn), SYMBOL_REPLAYS)
        block.hybridize(False)
    return out


def symbol_export(args, torch, tmp):
    """(a) ``resnet50_v1`` exported and imported as a ``SymbolBlock`` on
    the card: the graph's ops, the imported eager forward equal to the
    original's bit for bit, each replay equal to its eager forward."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon import SymbolBlock
    dev = torch.device("cuda")
    net = _resnet50(torch, trandom, args.seed)
    prefix = os.path.join(tmp, "resnet50_v1")
    t0 = time.perf_counter()
    files = net.export(prefix)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    block = SymbolBlock.imports(files[0], ["data"], files[1])
    import_s = time.perf_counter() - t0
    ops = _graph_ops(files[0])
    if ops != SYMBOL_OPS:
        fail("symbol (a): the exported graph's ops %s, not %s"
             % (ops, SYMBOL_OPS))
    x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                   generator=torch.Generator().manual_seed(args.seed)).to(dev)
    res = {"ops": ops, "export_s": export_s, "import_s": import_s,
           "prefix": prefix, "param_prefix": net.prefix,
           "param_bytes": os.path.getsize(files[1])}
    xn = nd.NDArray(x)
    with autograd.predict_mode():
        orig, imp = net(xn)._data, block(xn)._data
    if not torch.equal(orig, imp) or not torch.isfinite(orig).all():
        fail("symbol (a) float32: the imported forward differs from the "
             "original's (max |diff| %g)" % (orig - imp).abs().max())
    res["float32"] = {"imported_equals_original": True, "replay_ms":
                      _replay_check(torch, {"original": (net, orig),
                                            "imported": (block, imp)},
                                    xn, "(a) float32")}
    return net, block, res


def symbol_bf16(torch, net, block, x):
    """(a) in bf16: both cast (BatchNorm's inputs stay float32)."""
    from mxnet_tpu_torch import autograd, nd
    net.cast("bfloat16")
    block.cast("bfloat16")
    xn = nd.NDArray(x.bfloat16())
    with autograd.predict_mode():
        orig, imp = net(xn)._data, block(xn)._data
    if imp.dtype != torch.bfloat16 or not torch.equal(orig, imp):
        fail("symbol (a) bfloat16: the imported forward differs from the "
             "original's (max |diff| %g)" % (
                 orig.float() - imp.float()).abs().max())
    return {"imported_equals_original": True, "replay_ms": _replay_check(
        torch, {"original": (net, orig), "imported": (block, imp)}, xn,
        "(a) bfloat16")}


def symbol_predict(args, torch, prefix, block):
    """(b) ``InferenceEngine.load`` of (a)'s files behind ``ModelServer``:
    8 single-image requests in waves of 1, 3 and 4; each answer against
    the imported block's eager forward of its row."""
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.serving import InferenceEngine, ModelServer
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine = InferenceEngine.load(prefix, buckets=SYMBOL_BUCKETS)
    load_s = time.perf_counter() - t0
    n = sum(SYMBOL_WAVES)
    imgs = np.random.default_rng(args.seed + 3).random(
        (n, 3, VISION_IMAGE, VISION_IMAGE)).astype("float32")
    answers, client_ms = [None] * n, [None] * n
    srv = ModelServer(engine, port=0).start()

    def post(i):
        body = json.dumps({"data": imgs[i].tolist()}).encode()
        req = urllib.request.Request(srv.url + "/predict", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        t = time.perf_counter()
        reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
        client_ms[i] = (time.perf_counter() - t) * 1e3
        answers[i] = np.asarray(reply["output"], np.float32)

    try:
        start = 0
        with ThreadPoolExecutor(max(SYMBOL_WAVES)) as pool:
            for wave in SYMBOL_WAVES:
                list(pool.map(post, range(start, start + wave)))
                start += wave
    finally:
        srv.stop()
    errs = []
    with autograd.predict_mode():
        for i in range(n):
            row = block(nd.NDArray(torch.from_numpy(imgs[i:i + 1]).to(dev)))
            want = row.asnumpy().reshape(answers[i].shape)
            errs.append(float(np.abs(answers[i] - want).max()
                              / np.abs(want).max()))
    if not max(errs) <= SYMBOL_PREDICT_TOL:
        fail("symbol (b): an answer lies %.3g of its max from the block's "
             "forward (tolerance %g)" % (max(errs), SYMBOL_PREDICT_TOL))
    stats = engine.stats()
    engine.close()
    return {"requests": n, "waves": list(SYMBOL_WAVES), "load_s": load_s,
            "buckets_seen": stats["buckets_seen"], "misses": stats["misses"],
            "client_ms_p50": nearest_rank(client_ms, 50),
            "client_ms_max": max(client_ms),
            "max_err_rel_to_max": max(errs)}


def _sm_loss(torch, probs, y):
    """The mean negative log-likelihood of the labels under ``probs``."""
    p = probs.gather(1, y.long().reshape(-1, 1)).clamp_min(1e-30)
    return float(-p.log().mean())


def symbol_module(args, torch, prefix, param_prefix, tmp):
    """(c) the exported symbol under ``SoftmaxOutput``, bound for b32 in a
    ``Module`` from ``load_checkpoint`` of (a)'s files; SGD lr 0.1
    momentum 0.9 (``bench.py``'s); the first update against one eager
    ``gluon.Trainer`` step of the original net; the moving statistics;
    the first step's ``save_checkpoint`` -> ``Module.load`` -> ``predict``
    against that module's ``predict``. (With BatchNorm on its moving
    statistics nothing normalizes the activations, and at this rate the
    weights leave the finite range after a few steps: the outputs after
    the 8th step are reported, not required finite.)"""
    from mxnet_tpu_torch import autograd, gluon, io, model, nd, sym
    from mxnet_tpu_torch import module as mod_ns
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    dev = torch.device("cuda")
    shape = (VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE)
    t0 = time.perf_counter()
    graph, arg_p, aux_p = model.load_checkpoint(prefix, 0)
    head = sym.SoftmaxOutput(graph, sym.var("softmax_label"), name="softmax")
    m = mod_ns.Module(head)
    m.bind(data_shapes=[("data", shape)],
           label_shapes=[("softmax_label", (VISION_BATCH,))])
    m.init_params(arg_params=arg_p, aux_params=aux_p)
    m.init_optimizer(optimizer="sgd", optimizer_params=dict(VISION_SGD))
    bind_s = time.perf_counter() - t0
    g = torch.Generator(dev).manual_seed(args.seed + 4)
    x = torch.rand(shape, generator=g, device=dev)
    y = torch.randint(0, VISION_CLASSES, (VISION_BATCH,), generator=g,
                      device=dev).float()
    batch = io.DataBatch(data=[nd.NDArray(x)], label=[nd.NDArray(y)])
    # one eager Gluon step of the original net from the same weights, with
    # BatchNorm on its moving statistics as the Module's executor runs it
    net = _resnet50(torch, trandom, args.seed)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(VISION_SGD))
    with autograd.record(train_mode=False):
        loss = SoftmaxCrossEntropyLoss()(net(nd.NDArray(x)), nd.NDArray(y))
    loss.backward()
    trainer.step(VISION_BATCH)
    gluon_w = {param_prefix + n[len(net.prefix):]: p.tensor()
               for n, p in net.collect_params().items()}
    aux0 = {n: a._data.clone() for n, a in m.get_params()[1].items()}
    losses = []
    m.forward_backward(batch)
    m.update()
    losses.append(_sm_loss(torch, m.get_outputs()[0]._data, y))
    worst, worst_name = 0.0, None
    for n, w in m.get_params()[0].items():
        err = rel_to_max(w._data, gluon_w[n])
        if err > worst:
            worst, worst_name = err, n
    if not worst <= SYMBOL_STEP_TOL:
        fail("symbol (c): after the first step %s lies %.3g of its max "
             "from the Gluon step's (tolerance %g)"
             % (worst_name, worst, SYMBOL_STEP_TOL))
    del net, trainer, gluon_w, loss
    # the checkpoint of the first step, and its module's inference outputs
    ckpt = os.path.join(tmp, "module")
    m.save_checkpoint(ckpt, 1)
    data = io.NDArrayIter(x.cpu().numpy(), y.cpu().numpy(),
                          batch_size=VISION_BATCH)
    want = m.predict(data)._data

    def step():
        m.forward_backward(batch)
        m.update()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(SYMBOL_STEPS - 1):
        step()
        losses.append(_sm_loss(torch, m.get_outputs()[0]._data, y))
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / (SYMBOL_STEPS - 1)
    if not all(np.isfinite(losses)):
        fail("symbol (c): losses not finite: %r" % losses)
    moved = [n for n, a in m.get_params()[1].items()
             if not torch.equal(a._data, aux0[n])]
    if moved:
        fail("symbol (c): Module training moved the moving statistics %s "
             "(the reference's executor leaves them)" % moved[:4])
    res = {"bind_s": bind_s, "losses": losses, "step_ms": step_ms,
           "img_s": VISION_BATCH * 1e3 / step_ms,
           "first_step_vs_gluon_rel_to_max": worst,
           "first_step_worst_param": worst_name,
           "moving_stats_unchanged": len(aux0),
           "outputs_finite_after": bool(torch.isfinite(
               m.predict(data)._data).all())}
    back = mod_ns.Module.load(ckpt, 1)
    back.bind(data_shapes=[("data", shape)],
              label_shapes=[("softmax_label", (VISION_BATCH,))],
              for_training=False)
    got = back.predict(data)._data
    if not torch.isfinite(want).all() or not torch.equal(got, want):
        fail("symbol (c): Module.load -> predict differs from the saved "
             "module's (max |diff| %g; %d non-finite of %d)" % (
                 (got - want).abs().max(), (~torch.isfinite(want)).sum(),
                 want.numel()))
    res["load_predict_equal"] = True
    if args.profile:
        res["profile"] = profile(torch, step)
    return res


def symbol_attention(torch):
    """(d) ``sym._contrib_dot_product_attention`` (BHSD, causal) at the
    registry op's shape through an ``Executor`` in fp32 and bf16:
    ``simple_bind``, a training forward and ``backward``, one launch of
    each kernel a call, held against the plain path; the inference
    forward's replay against its eager forward."""
    from mxnet_tpu_torch import gpu, nd, sym
    from mxnet_tpu_torch.symbol.symbol import evaluate_graph
    B, S, H, D = REGISTRY_SHAPE
    g = torch.Generator(device="cuda").manual_seed(778)
    att = sym._contrib_dot_product_attention(
        sym.var("q"), sym.var("k"), sym.var("v"), causal=True, name="att")
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        ex = att.simple_bind(gpu(0), type_dict=dict.fromkeys("qkv", dname),
                             q=(B, H, S, D), k=(B, H, S, D), v=(B, H, S, D))
        (q, k, v, do), _ = attention_inputs(torch, g, B, S, H, D, "BHSD", dt,
                                            4, False)
        feed = {"q": nd.NDArray(q), "k": nd.NDArray(k), "v": nd.NDArray(v)}

        def run():
            ex.forward(is_train=True, **feed)
            ex.backward([nd.NDArray(do)])
            return [ex.outputs[0]._data.clone()] + [
                ex.grad_dict[n]._data.clone() for n in "qkv"]

        n0 = kernel_launches()
        got = run()
        torch.cuda.synchronize()
        per_call = {n: c - n0[n] for n, c in kernel_launches().items()}
        if per_call != {"flash_attn_fwd": 0, "flash_attn_fwd_bhsd": 1,
                        "flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1}:
            fail("symbol (d) %s: a training forward and backward launched "
                 "%s" % (dname, per_call))
        ref = on_plain_path(run, "symbol (d)")
        tol = 2e-4 if dt == torch.float32 else 2e-2
        errs = {}
        for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
            errs[name] = rel_to_max(a, r)
            if not errs[name] <= tol:
                fail("symbol (d) %s: %s differs from the plain path by %g "
                     "of its max (tolerance %g)" % (dname, name, errs[name],
                                                    tol))
        ex.forward(**feed)                     # the capture
        replay = ex.forward(**feed)[0]._data
        with torch.no_grad():
            eager = evaluate_graph(att, ex._bindings())[0]
        if not torch.equal(replay, eager):
            fail("symbol (d) %s: the executor's replay differs from its "
                 "eager forward" % dname)
        cases.append({"dtype": dname, "per_call": per_call,
                      "err_rel_to_max": errs, "tol": tol,
                      "replay_equals_eager": True})
    return {"shape": "B=%d S=%d H=%d D=%d BHSD causal" % REGISTRY_SHAPE,
            "cases": cases}


def symbol_phase(args, torch):
    """ResNet-50 v1 through the symbol frontend (a)-(c): no flash kernel;
    then the attention op through an Executor (d): every BHSD kernel."""
    import tempfile
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.reset_launches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        net, block, out["export"] = symbol_export(args, torch, tmp)
        prefix = out["export"]["prefix"]
        out["predict"] = symbol_predict(args, torch, prefix, block)
        x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                       generator=torch.Generator().manual_seed(args.seed)) \
            .to(torch.device("cuda"))
        out["export"]["bfloat16"] = symbol_bf16(torch, net, block, x)
        del net, block, x
        gc.collect()
        torch.cuda.empty_cache()
        out["module"] = symbol_module(args, torch, prefix,
                                      out["export"]["param_prefix"], tmp)
    gc.collect()
    torch.cuda.empty_cache()
    resnet = kernel_launches()
    if any(resnet.values()):
        fail("symbol: a flash kernel launched on the ResNet-50 path: %s"
             % resnet)
    out["attention"] = symbol_attention(torch)
    out["launches"] = kernel_launches()
    if not all(out["launches"][n] for n in (
            "flash_attn_fwd_bhsd", "flash_attn_bwd_dq",
            "flash_attn_bwd_dkv")):
        fail("symbol: a BHSD kernel never launched: %s" % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_symbol(sym_out, vision, card):
    e, p, m = sym_out["export"], sym_out["predict"], sym_out["module"]
    print("symbol (a) resnet50_v1 export %.2f s (%d bytes of params), "
          "SymbolBlock.imports %.2f s; graph %s; imported == original "
          "bitwise in fp32 and bf16; replay ms original/imported fp32 "
          "%.3f/%.3f, bf16 %.3f/%.3f [%s]" % (
              e["export_s"], e["param_bytes"], e["import_s"], e["ops"],
              e["float32"]["replay_ms"]["original"],
              e["float32"]["replay_ms"]["imported"],
              e["bfloat16"]["replay_ms"]["original"],
              e["bfloat16"]["replay_ms"]["imported"], card), flush=True)
    print("symbol (b) InferenceEngine.load %.2f s, /predict %d requests "
          "(waves %s): client p50 %.2f ms, max %.2f ms; buckets %s; answers "
          "vs the block's rows %.3g of max [%s]" % (
              p["load_s"], p["requests"], p["waves"], p["client_ms_p50"],
              p["client_ms_max"], p["buckets_seen"],
              p["max_err_rel_to_max"], card), flush=True)
    print("symbol (c) Module b%d fp32 SGD: step %.2f ms (steps 2..%d, %.1f "
          "img/s) against the vision phase's fp32 bench_span %.2f ms (%.1f "
          "img/s); first update vs Gluon %.3g of max (%s); %d moving "
          "statistics unchanged; Module.load -> predict bitwise; losses %s; "
          "outputs finite after step %d: %s [%s]" % (
              VISION_BATCH, m["step_ms"], SYMBOL_STEPS, m["img_s"],
              vision["float32"]["span_step_ms"], vision["float32"]["img_s"],
              m["first_step_vs_gluon_rel_to_max"],
              m["first_step_worst_param"], m["moving_stats_unchanged"],
              ", ".join("%.4f" % v for v in m["losses"]), SYMBOL_STEPS,
              m["outputs_finite_after"], card), flush=True)
    a = sym_out["attention"]
    print("symbol (d) _contrib_dot_product_attention %s through an "
          "Executor: %s; launches %s; %.1f s" % (
              a["shape"], "; ".join(
                  "%s %s replay == eager" % (c["dtype"], ", ".join(
                      "%s %.2g" % kv for kv in c["err_rel_to_max"].items()))
                  for c in a["cases"]), sym_out["launches"],
              sym_out["wall_s"]), flush=True)
    if "profile" in m:
        pr = m["profile"]
        print("profile 1 fp32 Module step (symbol): %.1f ms wall, device "
              "busy %.1f ms (%.1f%%), %d kernels; top: %s" % (
                  pr["wall_ms"], pr["device_busy_ms"],
                  100 * pr["device_busy_share"], pr["kernels_launched"],
                  "; ".join("%s x%d %.1f ms" % (k["name"][:40], k["calls"],
                                                k["ms"])
                            for k in pr["top_kernels"][:6])), flush=True)


# ---- ops phase: the first part of the op corpus on the card -------------

# every name that ops/core.py, ops/tensor_extra.py and ops/random_ops.py of
# the reference register (with the aliases other reference files register
# onto their functions) and nn.py's samplers, which the port lacked before
OPS_NEW_NAMES = """
    BlockGrad_identity SparseEmbedding _Div _Equal _EqualScalar _Greater
    _GreaterEqualScalar _GreaterScalar _Greater_Equal _Hypot _HypotScalar
    _Lesser _LesserEqualScalar _LesserScalar _Lesser_Equal _LogicalAndScalar
    _LogicalOrScalar _LogicalXorScalar _Logical_And _Logical_Or _Logical_Xor
    _Maximum _MaximumScalar _Minimum _MinimumScalar _Minus _Mod _ModScalar _Mul
    _NotEqualScalar _Not_Equal _Plus _Power _RModScalar
    _contrib_SparseEmbedding _crop_assign _crop_assign_scalar _equal_scalar
    _eye _full _grad_add _greater_equal_scalar _greater_scalar _histogram
    _hypot _hypot_scalar _identity_with_attr_like_rhs _lesser_equal_scalar
    _lesser_scalar _linalg_extractdiag _linalg_gemm _linalg_gemm2 _linalg_potrf
    _linalg_sumlogdiag _linalg_syrk _linalg_trsm _linspace _logical_and
    _logical_and_scalar _logical_or _logical_or_scalar _logical_xor
    _logical_xor_scalar _maximum_scalar _minimum_scalar _mod _mod_scalar
    _not_equal_scalar _np__random_shuffle _np_broadcast_to _np_copy _np_cumsum
    _np_dot _np_max _np_min _np_ones_like _np_prod _np_repeat _np_reshape
    _np_roll _np_squeeze _np_sum _np_transpose _np_zeros_like _npi_abs
    _npi_absolute _npi_add _npi_add_scalar _npi_arange _npi_arccos _npi_arccosh
    _npi_arcsin _npi_arcsinh _npi_arctan _npi_arctanh _npi_argmax _npi_argmin
    _npi_cast _npi_cbrt _npi_ceil _npi_cholesky _npi_clip _npi_concatenate
    _npi_cos _npi_cosh _npi_deg2rad _npi_degrees _npi_exp _npi_expand_dims
    _npi_expm1 _npi_eye _npi_fix _npi_flip _npi_floor _npi_full _npi_gather_nd
    _npi_histogram _npi_hypot _npi_hypot_scalar _npi_linspace _npi_log
    _npi_log10 _npi_log1p _npi_log2 _npi_logical_not _npi_maximum
    _npi_maximum_scalar _npi_mean _npi_minimum _npi_minimum_scalar _npi_mod
    _npi_mod_scalar _npi_multiply _npi_multiply_scalar _npi_negative
    _npi_normal _npi_ones _npi_power _npi_power_scalar _npi_rad2deg
    _npi_radians _npi_random_randint _npi_reciprocal _npi_reshape _npi_rint
    _npi_rmod_scalar _npi_rpower_scalar _npi_rsubtract_scalar
    _npi_rtrue_divide_scalar _npi_scatter_set_nd _npi_sign _npi_sin _npi_sinh
    _npi_slice _npi_slice_assign _npi_slice_assign_scalar _npi_split _npi_sqrt
    _npi_square _npi_stack _npi_subtract _npi_subtract_scalar _npi_swapaxes
    _npi_take _npi_tan _npi_tanh _npi_tile _npi_true_divide
    _npi_true_divide_scalar _npi_trunc _npi_uniform _npi_zeros _npx_batch_dot
    _npx_batch_flatten _npx_cast _npx_embedding _npx_gamma _npx_one_hot
    _npx_pick _npx_reshape _npx_reshape_like _npx_slice _npx_topk _ones
    _random_exponential _random_exponential_like _random_gamma
    _random_gamma_like _random_generalized_negative_binomial
    _random_generalized_negative_binomial_like _random_negative_binomial
    _random_negative_binomial_like _random_normal _random_normal_like
    _random_pdf_dirichlet _random_pdf_exponential _random_pdf_gamma
    _random_pdf_generalized_negative_binomial _random_pdf_negative_binomial
    _random_pdf_normal _random_pdf_poisson _random_pdf_uniform _random_poisson
    _random_poisson_like _random_randint _random_uniform _random_uniform_like
    _ravel_multi_index _rmod_scalar _sample_exponential _sample_gamma
    _sample_generalized_negative_binomial _sample_multinomial
    _sample_negative_binomial _sample_normal _sample_poisson _sample_uniform
    _sample_unique_zipfian _scatter_set_nd _shuffle _slice_assign
    _slice_assign_scalar _sparse_retain _split_v2 _square_sum _unravel_index
    _zeros _zeros_without_dtype all_finite amp_cast amp_multicast arccosh
    arcsinh arctanh argmax_channel argsort broadcast_hypot broadcast_like
    broadcast_logical_and broadcast_logical_or broadcast_logical_xor
    cast_storage cbrt choose_element_0index cumsum degrees depth_to_space diag
    digamma erfinv fix fmod gamma gammaln hypot isfinite isinf isnan khatri_rao
    less less_equal linalg_extractdiag linalg_gemm linalg_gemm2 linalg_potrf
    linalg_sumlogdiag linalg_syrk linalg_trsm logical_and logical_not
    logical_or logical_xor moments multi_all_finite multi_sum_sq nanprod nansum
    normal radians random_exponential random_gamma
    random_generalized_negative_binomial random_negative_binomial random_normal
    random_pdf_dirichlet random_pdf_exponential random_pdf_gamma
    random_pdf_generalized_negative_binomial random_pdf_negative_binomial
    random_pdf_normal random_pdf_poisson random_pdf_uniform random_poisson
    random_randint random_uniform ravel_multi_index rcbrt reset_arrays
    reshape_like rint roll sample_exponential sample_gamma
    sample_generalized_negative_binomial sample_multinomial
    sample_negative_binomial sample_normal sample_poisson sample_uniform
    sample_unique_zipfian scatter_nd shape_array shuffle size_array sort
    space_to_depth sparse_retain square_sum topk uniform unravel_index
""".split()
OPS_LOGITS = (32, 32000)          # transformer_lm_base's vocabulary
OPS_TOPK = 50
OPS_GEMM = (64 * 12, 128, 64)     # BERT-base's attention batches
OPS_SPD = (64, 768, 768)
OPS_ACT = (32, 64, 112, 112)      # ResNet-50's first activation
OPS_DRAWS = (32, 3, 224, 224)
OPS_FLOAT = (1e-6, 1e-7)          # rtol, atol: the CPU tests' float family
OPS_LGAMMA_ATOL = 1e-6            # the CPU tests' lgamma family
# gamma = exp(gammaln): the lgamma family's absolute error is a relative
# one after exp, so gamma takes rtol 1e-6 + 1e-6
OPS_GAMMA_RTOL = 2e-6
# a density is exp of a sum of log and gammaln terms; a Dirichlet's reach
# ~200 in magnitude (log of components near 1e-5), where an ulp of the
# sum is ~1.5e-5 of the density: 3e-5, relative
OPS_DENSITY_RTOL = 3e-5
OPS_LINALG_TOL = 1e-5             # of each output's largest |value|
OPS_TIMED = ("topk", "sort", "linalg_gemm2")


def _ops_arrays(seed):
    """The phase's inputs (numpy, made from ``seed``), by key."""
    import torch
    rng = np.random.default_rng(seed + 31)
    f32 = np.float32

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape, dtype=f32)).astype(f32)

    x = normal(OPS_ACT)
    nan = x.copy()
    nan.reshape(-1)[::9973] = np.nan
    nan.reshape(-1)[5::9973] = np.inf
    ties = rng.integers(-3, 4, OPS_ACT).astype(f32)
    ties.reshape(-1)[1::10007] = np.nan
    m = torch.from_numpy(normal(OPS_SPD)) / OPS_SPD[-1] ** 0.5
    spd = (m @ m.transpose(-1, -2) + torch.eye(OPS_SPD[-1])).numpy()
    lower = torch.linalg.cholesky(torch.from_numpy(spd)).numpy()
    bert_shapes = [tuple(p.shape) for p in _bert_param_shapes()]
    qnan = rng.uniform(0.9, 1.1, OPS_ACT).astype(f32)
    qnan.reshape(-1)[::9973] = np.nan
    return {
        "QN": qnan, "L": normal(OPS_LOGITS, 3.0), "A": normal(OPS_GEMM),
        "B": normal((OPS_GEMM[0], OPS_GEMM[2], OPS_GEMM[1])),
        "C": normal((OPS_GEMM[0], OPS_GEMM[1], OPS_GEMM[1])),
        "S": spd, "Lo": lower, "R": normal(OPS_SPD[:2] + (64,)),
        "X": x, "Y": normal(OPS_ACT), "N": nan, "T": ties,
        "T2": rng.integers(-3, 4, OPS_ACT).astype(f32),
        "P": rng.uniform(0.5, 4.5, OPS_ACT).astype(f32),
        "U": rng.uniform(-0.9, 0.9, OPS_ACT).astype(f32),
        "G": rng.uniform(1.0, 9.0, OPS_ACT).astype(f32),
        "I": rng.integers(0, 8, OPS_ACT).astype(f32),
        "Q": rng.uniform(0.9, 1.1, OPS_ACT).astype(f32),
        "rows": rng.uniform(0.5, 3.0, OPS_ACT[0] * OPS_ACT[1]).astype(f32),
        "lo": np.full(OPS_ACT[0] * OPS_ACT[1], -1.0, f32),
        "prob": rng.uniform(0.2, 0.8, OPS_ACT[0] * OPS_ACT[1]).astype(f32),
        "simplex": rng.dirichlet(np.ones(8), OPS_ACT[:2] + OPS_ACT[3:])
        .astype(f32),
        "alpha": rng.uniform(0.5, 3.0, OPS_ACT[:2] + (8,)).astype(f32),
        "tok": rng.integers(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ))
        .astype(f32),
        "emb": normal((BERT_VOCAB, 768), 0.02),
        "idx": np.stack(np.unravel_index(rng.choice(
            int(np.prod(OPS_ACT[:3])), 1000, replace=False), OPS_ACT[:3]))
        .astype(np.int64),
        "flat": rng.integers(0, int(np.prod(OPS_ACT)), 100000)
        .astype(np.int64),
        "bert": [normal(s) for s in bert_shapes],
    }


def _bert_param_shapes():
    """BERT-base's parameters (shapes only: built on the meta device)."""
    from mxnet_tpu_torch.models import bert_base
    import torch
    return list(bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                          device=torch.device("meta")).parameters())


def _ops_cases():
    """Each deterministic primary op of the corpus: (args, kwargs,
    family). ``"@K"`` is the phase's array ``K`` (``"@K:bf16"`` in bf16),
    ``"@bert"`` the BERT-base parameter list (spread as arguments)."""
    c0, c1 = _ops_channels()
    ew = {}
    for n in ("rint", "fix", "degrees", "radians", "isnan", "isinf",
              "isfinite", "logical_not", "abs", "negative", "sign", "ceil",
              "floor", "trunc", "square", "reciprocal", "identity",
              "zeros_like", "ones_like"):
        ew[n] = (["@N" if n.startswith("is") else "@X"], {}, "exact")
    for n, arr in (("cbrt", "@X"), ("rcbrt", "@P"), ("gamma", "@P"),
                   ("erfinv", "@U"), ("arcsinh", "@X"),
                   ("arccosh", "@G"), ("arctanh", "@U"), ("arccos", "@U"),
                   ("arcsin", "@U"), ("arctan", "@X"), ("cos", "@X"),
                   ("cosh", "@U"), ("sin", "@X"), ("sinh", "@U"),
                   ("tan", "@U"), ("tanh", "@X"), ("exp", "@U"),
                   ("expm1", "@U"), ("log", "@P"), ("log10", "@P"),
                   ("log1p", "@P"), ("log2", "@P"), ("sqrt", "@P")):
        ew[n] = ([arr], {}, "float")
    ew["gammaln"] = (["@P"], {}, "lgamma")
    ew["digamma"] = (["@P"], {}, "lgamma")
    ew["gamma"] = (["@P"], {}, "gamma")
    for n in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
              "equal", "not_equal", "greater", "greater_equal", "lesser",
              "lesser_equal", "logical_and", "logical_or", "logical_xor",
              "_logical_and", "_logical_or", "_logical_xor"):
        ew[n] = (["@T", "@T2"], {}, "exact")
    for n in ("hypot", "power", "fmod", "mod"):
        ew[n] = (["@P", "@X"] if n == "power" else ["@X", "@P"], {},
                 "float")
    for n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar", "_logical_and_scalar",
              "_logical_or_scalar", "_logical_xor_scalar", "_maximum_scalar",
              "_minimum_scalar", "_plus_scalar", "_minus_scalar",
              "_rminus_scalar", "_mul_scalar", "_div_scalar",
              "_rdiv_scalar"):
        ew[n] = (["@T"], {"scalar": 1.0}, "exact")
    for n in ("_mod_scalar", "_rmod_scalar", "_hypot_scalar",
              "_power_scalar", "_rpower_scalar"):
        ew[n] = (["@P"], {"scalar": 1.5}, "float")
    for n in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod",
              "_square_sum"):
        arr = "@QN" if n.startswith("nan") else ("@Q" if n == "prod" else
                                                 "@X")
        ew[n] = ([arr], {"axis": (2, 3)}, "exact" if n in ("max", "min")
                 else "reduce")
    ew.update({
        "_histogram": (["@X"], {"bin_cnt": 50}, "hist"),
        "argmax": (["@X"], {"axis": 1}, "exact"),
        "argmin": (["@X"], {"axis": 1}, "exact"),
        "moments": (["@X"], {"axes": (0, 2, 3)}, "reduce"),
        "clip": (["@X"], {"a_min": -0.5, "a_max": 0.7}, "exact"),
        "cast": (["@X"], {"dtype": "bfloat16"}, "exact"),
        "amp_cast": (["@X"], {"dtype": "bfloat16"}, "exact"),
        "amp_multicast": (["@X:bf16", "@Y"], {"num_outputs": 2}, "exact"),
        "cast_storage": (["@X"], {"stype": "default"}, "exact"),
        "_identity_with_attr_like_rhs": (["@X", "@Y"], {}, "exact"),
        # (a) the vocabulary's logits, fp32 and bf16
        "sort": (["@L"], {"is_ascend": False}, "exact"),
        "argsort": (["@L"], {"is_ascend": False}, "exact"),
        "topk": (["@L"], {"k": OPS_TOPK, "ret_typ": "both"}, "exact"),
        "argmax_channel": (["@L"], {}, "exact"),
        "cumsum": (["@L"], {"axis": 1}, "exact"),
        # (b) BERT-base's attention batches and SPD matrices
        "linalg_gemm2": (["@A", "@B"], {}, "linalg"),
        "linalg_gemm": (["@A", "@B", "@C"], {"alpha": 0.5, "beta": 2.0},
                        "linalg"),
        "batch_dot": (["@A", "@B"], {}, "linalg"),
        "dot": (["@A:2d", "@A:2dt"], {}, "linalg"),
        "linalg_potrf": (["@S"], {}, "linalg"),
        "linalg_trsm": (["@Lo", "@R"], {}, "linalg"),
        "linalg_syrk": (["@S"], {}, "linalg"),
        "linalg_sumlogdiag": (["@S"], {}, "linalg"),
        "linalg_extractdiag": (["@S"], {}, "exact"),
        "khatri_rao": (["@A:kr", "@A:kr"], {}, "float"),
        # (d) BERT-base's parameters
        "multi_sum_sq": (["@bert"], {}, "reduce"),
        "multi_all_finite": (["@bert"], {}, "exact"),
        "all_finite": (["@N"], {}, "exact"),
        "reset_arrays": (["@bert"], {}, "exact"),
        # shape, indexing, assignment
        "roll": (["@X"], {"shift": 3, "axis": 2}, "exact"),
        "depth_to_space": (["@X"], {"block_size": 2}, "exact"),
        "space_to_depth": (["@X"], {"block_size": 2}, "exact"),
        "scatter_nd": (["@X:1k", "@idx"], {"shape": OPS_ACT[:3]}, "exact"),
        "gather_nd": (["@X", "@idx"], {}, "exact"),
        "_scatter_set_nd": (["@X", "@Y:nd", "@idx"], {}, "exact"),
        "shape_array": (["@X"], {}, "exact"),
        "size_array": (["@X"], {}, "exact"),
        "diag": (["@S"], {"k": 1}, "exact"),
        "_slice_assign": (["@X", "@Y:slice"],
                          {"begin": (0, c0, 0, 0), "end": OPS_ACT[:1] + (
                              c1,) + OPS_ACT[2:]}, "exact"),
        "_slice_assign_scalar": (["@X"], {"scalar": 0.5, "begin": (0, c0),
                                          "end": (OPS_ACT[0], c1)}, "exact"),
        "_ravel_multi_index": (["@idx"], {"shape": OPS_ACT[:3]}, "exact"),
        "_unravel_index": (["@flat"], {"shape": OPS_ACT}, "exact"),
        "broadcast_like": (["@X:mean", "@X"], {}, "exact"),
        "broadcast_to": (["@X:mean"], {"shape": OPS_ACT}, "exact"),
        "reshape_like": (["@X", "@Y:flat2"], {"lhs_begin": 0, "lhs_end": 2,
                                              "rhs_begin": 0, "rhs_end": 1},
                         "exact"),
        "reshape": (["@X"], {"shape": (32, -1)}, "exact"),
        "transpose": (["@X"], {"axes": (0, 2, 3, 1)}, "exact"),
        "swapaxes": (["@X"], {"dim1": 1, "dim2": 3}, "exact"),
        "expand_dims": (["@X"], {"axis": 1}, "exact"),
        "squeeze": (["@X:mean"], {"axis": (2, 3)}, "exact"),
        "flip": (["@X"], {"axis": 3}, "exact"),
        "tile": (["@L"], {"reps": (2, 1)}, "exact"),
        "repeat": (["@L"], {"repeats": 2, "axis": 0}, "exact"),
        "concat": (["@X", "@Y"], {"dim": 1}, "exact"),
        "stack": (["@X", "@Y"], {"axis": 0}, "exact"),
        "split": (["@X"], {"num_outputs": 4, "axis": 1}, "exact"),
        "_split_v2": (["@X"], {"indices": (c0, c1), "axis": 1}, "exact"),
        "slice": (["@X"], {"begin": (0, c0), "end": (OPS_ACT[0] // 2, c1)},
                  "exact"),
        "Flatten": (["@X"], {}, "exact"),
        "take": (["@emb", "@tok"], {}, "exact"),
        "embedding": (["@tok", "@emb"], {}, "exact"),
        "pick": (["@L", "@L:argmax"], {"axis": 1}, "exact"),
        "one_hot": (["@L:argmax"], {"depth": 32000}, "exact"),
        "_sparse_retain": (["@emb", "@tok:row"], {}, "exact"),
        # creation (on the context's device)
        "_zeros": ([], {"shape": OPS_ACT}, "exact"),
        "_ones": ([], {"shape": OPS_ACT}, "exact"),
        "_full": ([], {"shape": OPS_ACT, "value": 0.3}, "exact"),
        "_eye": ([], {"N": 768, "M": 1024, "k": 3}, "exact"),
        "_linspace": ([], {"start": -3.0, "stop": 7.0, "num": 32000},
                      "exact"),
        "_arange": ([], {"start": 0.0, "stop": 3200.0, "step": 0.1},
                    "exact"),
        # densities: one distribution a row of 112 samples
        "_random_pdf_uniform": (["@U:s", "@lo", "@rows"], {}, "density"),
        "_random_pdf_normal": (["@X:s", "@lo", "@rows"], {}, "density"),
        "_random_pdf_gamma": (["@P:s", "@rows", "@rows"], {}, "density"),
        "_random_pdf_exponential": (["@P:s", "@rows"], {}, "density"),
        "_random_pdf_poisson": (["@I:s", "@rows"], {}, "density"),
        "_random_pdf_negative_binomial": (["@I:s", "@rows", "@prob"], {},
                                          "density"),
        "_random_pdf_generalized_negative_binomial": (
            ["@I:s", "@rows", "@rows"], {}, "density"),
        "_random_pdf_dirichlet": (["@simplex", "@alpha"], {}, "density"),
    })
    return ew


def _ops_channels():
    """The channel range the slice ops take: 8..40 of ResNet-50's 64."""
    return OPS_ACT[1] // 8, OPS_ACT[1] // 8 * 5


def _ops_array(arrays, key):
    """``"@K[:form]"`` as a numpy array (or list of them)."""
    name, _, form = key[1:].partition(":")
    a = arrays[name]
    if form == "bf16":
        return ("bf16", a)
    if form == "2d":
        return a.reshape(-1, a.shape[-1])[:4096]
    if form == "2dt":
        return np.ascontiguousarray(a.reshape(-1, a.shape[-1])[:4096].T)
    if form == "1k":
        return a.reshape(-1)[:1000].copy()
    if form == "flat2":
        return a.reshape(a.shape[0] * a.shape[1], -1)
    if form == "kr":
        return a.reshape(-1, a.shape[-1])[:64].copy()
    if form == "nd":
        return a[tuple(arrays["idx"])]
    if form == "mean":
        return a.mean(axis=(2, 3), keepdims=True)
    if form == "slice":
        c0, c1 = _ops_channels()
        return a[:, c0:c1].copy()
    if form == "argmax":
        return a.argmax(axis=1).astype(np.float32)
    if form == "row":
        return np.unique(a.reshape(-1).astype(np.int64))[:4096]
    if form == "s":             # one row of 112 samples a (image, channel)
        return np.ascontiguousarray(a[:, :, 0, :]).reshape(-1, a.shape[-1])
    return a


def _ops_nd(torch, value, dev):
    """A numpy value (or a list) as NDArray(s) on ``dev``."""
    from mxnet_tpu_torch import nd
    if isinstance(value, list):
        return [_ops_nd(torch, v, dev) for v in value]
    if isinstance(value, tuple) and value[0] == "bf16":
        return nd.NDArray(torch.from_numpy(value[1]).to(dev).bfloat16())
    return nd.NDArray(torch.from_numpy(np.ascontiguousarray(value)).to(dev))


class _OpsMismatch(Exception):
    """A card output that differs from the CPU's (collected, then failed
    on together)."""


def _ops_compare(torch, family, own, ref, what, dev):
    """The card's outputs against the CPU's (see ``_ops_cases``); raises
    :class:`_OpsMismatch`."""
    def fail(msg):
        raise _OpsMismatch(msg)

    own = own if isinstance(own, (list, tuple)) else [own]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    if len(own) != len(ref):
        fail("ops %s: %d outputs on the card, %d on the CPU"
             % (what, len(own), len(ref)))
    for i, (o, r) in enumerate(zip(own, ref)):
        o, r = o._data, r._data
        if o.device.type != dev.type:
            fail("ops %s: output %d is on %s, not the card" % (what, i,
                                                                 o.device))
        if o.dtype != r.dtype or o.shape != r.shape:
            fail("ops %s: output %d is %s %s on the card, %s %s on the CPU"
                 % (what, i, o.dtype, tuple(o.shape), r.dtype,
                    tuple(r.shape)))
        o = o.cpu()
        fam = family if family != "hist" else ("exact" if i == 0 else
                                               "float")
        if fam == "exact":
            same = torch.equal(o, r) if not o.is_floating_point() else \
                bool(((o == r) | (torch.isnan(o) & torch.isnan(r))).all())
            if not same:
                fail("ops %s: output %d differs from the CPU's (exact)"
                     % (what, i))
            continue
        of, rf = o.double(), r.double()
        if fam in ("reduce", "linalg"):
            scale = max(rf.abs().max().item(), 1e-30)
            err = (of - rf).abs().max().item()
            if not err <= OPS_LINALG_TOL * scale:
                fail("ops %s: output %d is %g of its max from the CPU's "
                     "(tol %g)" % (what, i, err / scale, OPS_LINALG_TOL))
            continue
        if o.dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(
                rf.abs().clamp(min=2.0 ** -126))) - 7)
            bad = ~(((of - rf).abs() <= ulp) | (torch.isnan(of)
                                                 & torch.isnan(rf)))
        else:
            rtol, atol = OPS_FLOAT
            if fam == "lgamma":
                atol = OPS_LGAMMA_ATOL
            elif fam == "gamma":
                rtol = OPS_GAMMA_RTOL
            elif fam == "density":
                rtol, atol = OPS_DENSITY_RTOL, OPS_LGAMMA_ATOL
            bad = ~(((of - rf).abs() <= atol + rtol * rf.abs())
                    | (torch.isnan(of) & torch.isnan(rf))
                    | ((of == rf) & torch.isinf(rf)))
        if bool(bad.any()):
            fail("ops %s: output %d has %d values outside the CPU tests' "
                 "tolerance of the CPU's (%s)" % (what, i, int(bad.sum()),
                                                 fam))


# (a): the vocabulary's ops run in both dtypes; topk with every ret_typ
OPS_PART_A = ("sort", "argsort", "topk", "argmax_channel", "cumsum")


def _ops_samplers(nd, mx):
    """Every sampler primary of the corpus: a draw of ``OPS_DRAWS`` values
    on the card, with its theoretical mean and variance and the bounds of
    ``tests/test_random_stats.py`` (a per-row sampler: its first row)."""
    n = int(np.prod(OPS_DRAWS))
    ctx = mx.gpu(0)
    z = nd.zeros(OPS_DRAWS, ctx=ctx)

    def rows(*vals):
        return nd.array(np.array(vals, np.float32), ctx=ctx)
    half = (n // 2,)
    return {
        "_random_uniform": (lambda: nd._random_uniform(
            low=-2.0, high=4.0, shape=OPS_DRAWS, ctx=ctx), 1.0, 3.0,
            (0.02, 0.05)),
        "_random_normal": (lambda: nd._random_normal(
            loc=1.5, scale=2.0, shape=OPS_DRAWS, ctx=ctx), 1.5, 4.0,
            (0.02, 0.08)),
        "_random_gamma": (lambda: nd._random_gamma(
            alpha=3.0, beta=2.0, shape=OPS_DRAWS, ctx=ctx), 6.0, 12.0,
            (0.06, 0.4)),
        "_random_exponential": (lambda: nd._random_exponential(
            lam=0.4, shape=OPS_DRAWS, ctx=ctx), 2.5, 6.25, (0.03, 0.15)),
        "_random_poisson": (lambda: nd._random_poisson(
            lam=4.0, shape=OPS_DRAWS, ctx=ctx), 4.0, 4.0, (0.04, 0.15)),
        "_random_negative_binomial": (lambda: nd._random_negative_binomial(
            k=5, p=0.4, shape=OPS_DRAWS, ctx=ctx), 7.5, 18.75, (0.12, 0.8)),
        "_random_generalized_negative_binomial": (
            lambda: nd._random_generalized_negative_binomial(
                mu=2.0, alpha=0.5, shape=OPS_DRAWS, ctx=ctx), 2.0, 4.0,
            (0.04, 0.2)),
        "_random_randint": (lambda: nd._random_randint(
            low=3, high=9, shape=OPS_DRAWS, ctx=ctx), 5.5, 35 / 12,
            (0.02, 0.05)),
        "_random_uniform_like": (lambda: nd._random_uniform_like(
            z, low=-2.0, high=4.0), 1.0, 3.0, (0.02, 0.05)),
        "_random_normal_like": (lambda: nd._random_normal_like(
            z, loc=1.5, scale=2.0), 1.5, 4.0, (0.02, 0.08)),
        "_random_gamma_like": (lambda: nd._random_gamma_like(
            z, alpha=3.0, beta=2.0), 6.0, 12.0, (0.06, 0.4)),
        "_random_exponential_like": (lambda: nd._random_exponential_like(
            z, lam=0.4), 2.5, 6.25, (0.03, 0.15)),
        "_random_poisson_like": (lambda: nd._random_poisson_like(
            z, lam=4.0), 4.0, 4.0, (0.04, 0.15)),
        "_random_negative_binomial_like": (
            lambda: nd._random_negative_binomial_like(z, k=5, p=0.4), 7.5,
            18.75, (0.12, 0.8)),
        "_random_generalized_negative_binomial_like": (
            lambda: nd._random_generalized_negative_binomial_like(
                z, mu=2.0, alpha=0.5), 2.0, 4.0, (0.04, 0.2)),
        "_sample_uniform": (lambda: nd._sample_uniform(
            rows(-2.0, 0.0), rows(4.0, 1.0), shape=half), 1.0, 3.0,
            (0.02, 0.05)),
        "_sample_normal": (lambda: nd._sample_normal(
            rows(1.5, -1.0), rows(2.0, 0.5), shape=half), 1.5, 4.0,
            (0.02, 0.08)),
        "_sample_exponential": (lambda: nd._sample_exponential(
            rows(0.4, 2.0), shape=half), 2.5, 6.25, (0.03, 0.15)),
        "_sample_gamma": (lambda: nd._sample_gamma(
            rows(3.0, 1.0), rows(2.0, 1.0), shape=half), 6.0, 12.0,
            (0.06, 0.4)),
        "_sample_poisson": (lambda: nd._sample_poisson(
            rows(4.0, 1.0), shape=half), 4.0, 4.0, (0.04, 0.15)),
        "_sample_negative_binomial": (lambda: nd._sample_negative_binomial(
            rows(5.0, 2.0), rows(0.4, 0.5), shape=half), 7.5, 18.75,
            (0.12, 0.8)),
        "_sample_generalized_negative_binomial": (
            lambda: nd._sample_generalized_negative_binomial(
                rows(2.0, 1.0), rows(0.5, 1.0), shape=half), 2.0, 4.0,
            (0.04, 0.2)),
        "random.uniform": (lambda: mx.random.uniform(
            -2.0, 4.0, shape=OPS_DRAWS, ctx=ctx), 1.0, 3.0, (0.02, 0.05)),
        "random.normal": (lambda: mx.random.normal(
            1.5, 2.0, shape=OPS_DRAWS, ctx=ctx), 1.5, 4.0, (0.02, 0.08)),
        "random.randn": (lambda: mx.random.randn(*OPS_DRAWS, ctx=ctx),
                         0.0, 1.0, (0.02, 0.02)),
        "random.randint": (lambda: mx.random.randint(
            3, 9, shape=OPS_DRAWS, ctx=ctx), 5.5, 35 / 12, (0.02, 0.05)),
        "random.gamma": (lambda: mx.random.gamma(
            3.0, 2.0, shape=OPS_DRAWS, ctx=ctx), 6.0, 12.0, (0.06, 0.4)),
        "random.exponential": (lambda: mx.random.exponential(
            2.5, shape=OPS_DRAWS, ctx=ctx), 2.5, 6.25, (0.03, 0.15)),
        "random.poisson": (lambda: mx.random.poisson(
            4.0, shape=OPS_DRAWS, ctx=ctx), 4.0, 4.0, (0.04, 0.15)),
        "random.negative_binomial": (lambda: mx.random.negative_binomial(
            5, 0.4, shape=OPS_DRAWS, ctx=ctx), 7.5, 18.75, (0.12, 0.8)),
        "random.generalized_negative_binomial": (
            lambda: mx.random.generalized_negative_binomial(
                2.0, 0.5, shape=OPS_DRAWS, ctx=ctx), 2.0, 4.0, (0.04, 0.2)),
        "random.bernoulli": (lambda: mx.random.bernoulli(
            0.3, shape=OPS_DRAWS, ctx=ctx), 0.3, 0.21, (0.005, 0.005)),
    }


def ops_phase(args, torch):
    """The first part of the op corpus on the card: every name this slice
    registers through ``nd.<name>`` on ``gpu(0)`` NDArrays, held to the
    port's CPU result on the same inputs (parts a-d), every sampler's
    moments, seeding and graph replays (e), and a ``.states`` resume of
    BERT-base Adam through ``gluon.Trainer`` (f)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops.registry import get_op
    t0 = time.perf_counter()
    fa_reset = kernel_launches()
    arrays = _ops_arrays(args.seed)
    cases = _ops_cases()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cache = {}

    def operand(key, device):
        if not isinstance(key, str) or not key.startswith("@"):
            return key
        if (key, device) not in cache:
            cache[(key, device)] = _ops_nd(torch, _ops_array(arrays, key),
                                           device)
        return cache[(key, device)]

    def call(name, args_, kw, device):
        ctx = mx.gpu(0) if device.type == "cuda" else mx.cpu()
        vals = []
        for a in args_:
            v = operand(a, device)
            vals.extend(v if isinstance(v, list) else [v])
        with ctx:
            return getattr(nd, name)(*vals, **kw)

    run_names, samplers, mismatches = [], [], []
    for name in OPS_NEW_NAMES:
        primary = get_op(name).name
        if primary not in cases:
            samplers.append(name)
            continue
        args_, kw, family = cases[primary]
        variants = [(args_, kw)]
        if primary in OPS_PART_A:
            variants += [([a + ":bf16" for a in args_], kw)]
        if primary == "topk":
            variants = [(a, dict(k, ret_typ=r)) for a, k in variants
                        for r in ("value", "indices", "both", "mask")]
        for a, k in variants:
            what = "%s%s" % (name, "" if a is args_ else " " + " ".join(
                "%s=%s" % kv for kv in sorted(k.items())
                if kv[0] == "ret_typ") + (" bf16" if a[0].endswith(
                    ":bf16") else ""))
            own = call(name, a, dict(k), dev)
            try:
                _ops_compare(torch, family, own,
                             call(name, a, dict(k), cpu), what, dev)
            except _OpsMismatch as e:
                mismatches.append(str(e))
        run_names.append(name)
        cache = {k: v for k, v in cache.items() if k[1] == dev} \
            if len(cache) > 40 else cache
    out = {"names_total": len(OPS_NEW_NAMES),
           "deterministic_on_card": len(run_names)}

    # (e) samplers: moments, seeding, graph replays
    draws = _ops_samplers(nd, mx)
    sampler_primaries = {get_op(n).name for n in samplers}
    missing = sampler_primaries - set(draws) - {
        "_sample_multinomial", "_sample_unique_zipfian", "_shuffle"}
    if missing:
        fail("ops (e): no draw for %s" % sorted(missing))
    moments = {}
    for key, (draw, mean, var, (bm, bv)) in draws.items():
        mx.random.seed(args.seed)
        got = draw()
        if got._data.device.type != dev.type:
            fail("ops (e) %s drew on %s" % (key, got._data.device))
        a = got._data.double()
        a = a[0] if key.startswith("_sample_") else a
        m, v = a.mean().item(), a.var(unbiased=False).item()
        if not (abs(m - mean) < bm and abs(v - var) < bv):
            fail("ops (e) %s: mean %g var %g, theory %g %g (bounds %g %g)"
                 % (key, m, v, mean, var, bm, bv))
        mx.random.seed(args.seed)
        if not torch.equal(draw()._data, got._data):
            fail("ops (e) %s: a seed does not repeat the draw" % key)
        moments[key] = (m, v)
    ctx = mx.gpu(0)
    n = int(np.prod(OPS_DRAWS))
    mx.random.seed(args.seed)
    probs = nd.array(np.array([[0.2, 0.3, 0.5]], np.float32), ctx=ctx)
    s, lp = nd._sample_multinomial(probs, shape=(n,), get_prob=True)
    freq = torch.bincount(s._data.reshape(-1).long(), minlength=3) / n
    if s._data.device.type != dev.type or not torch.allclose(
            freq.cpu().double(), torch.tensor([0.2, 0.3, 0.5],
                                              dtype=torch.float64),
            atol=0.01):
        fail("ops (e) _sample_multinomial: frequencies %s" % freq.tolist())
    v = mx.random.multinomial(nd.array([0.2, 0.3, 0.5], ctx=ctx),
                              shape=(n,))
    if v._data.device.type != dev.type:
        fail("ops (e) random.multinomial drew on %s" % v._data.device)
    draws_z, counts = nd._sample_unique_zipfian(range_max=32000,
                                                shape=(32, 4096))
    dz = draws_z._data
    uniq = [len(torch.unique(r)) for r in dz]
    if dz.device.type != dev.type or \
            uniq != counts._data.reshape(-1).tolist() or \
            int(dz.min()) < 0 or int(dz.max()) >= 32000:
        fail("ops (e) _sample_unique_zipfian: counts or range wrong")
    x = nd.array(np.arange(OPS_DRAWS[0] * OPS_DRAWS[1] * OPS_DRAWS[2],
                           dtype=np.float32), ctx=ctx)
    for sh in (nd.shuffle, nd._shuffle, nd._np__random_shuffle,
               mx.random.shuffle):
        got = sh(x)._data
        if got.device.type != dev.type or not torch.equal(
                torch.sort(got).values,
                                              x._data) \
                or torch.equal(got, x._data):
            fail("ops (e) %s is not a permutation drawn on the card" % sh)

    class Noisy(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, data):
            return data + F._random_normal_like(data)

    net = Noisy()
    net.hybridize()
    xin = nd.zeros((8, 1024), ctx=ctx)
    with mx.autograd.predict_mode():
        net(xin)                  # the capture: the seeded calls replay
        replays = []
        for _ in range(2):
            mx.random.seed(args.seed)
            replays.append([net(xin)._data.clone() for _ in range(3)])
    st = [op.cache_stats() for op in
          net.__dict__.get("_cached_ops", {}).values()]
    if dev.type == "cuda" and not any(c.get("graphs") for c in st):
        fail("ops (e): the hybridized sampling block captured no CUDA "
             "graph: %s" % st)
    a, b = replays
    if torch.equal(a[1], a[2]) or torch.equal(a[0], a[1]):
        fail("ops (e): replays of a hybridized sampling block repeat")
    if not all(torch.equal(p, q) for p, q in zip(a, b)):
        fail("ops (e): a seed does not repeat a hybridized block's replays")
    out["samplers"] = {"names": len(samplers), "moments": moments,
                       "hybridized": st}
    out["names_on_card"] = len(run_names) + len(samplers)
    if out["names_on_card"] != len(OPS_NEW_NAMES):
        fail("ops: %d of %d names ran on the card"
             % (out["names_on_card"], len(OPS_NEW_NAMES)))

    # the card's times at these shapes
    L, A, B = (operand(k, dev) for k in ("@L", "@A", "@B"))
    out["ms"] = {
        "topk": time_ms(torch, lambda: nd.topk(L, k=OPS_TOPK,
                                               ret_typ="both")),
        "sort": time_ms(torch, lambda: nd.sort(L)),
        "linalg_gemm2": time_ms(torch, lambda: nd.linalg_gemm2(A, B))}
    del cache, arrays
    torch.cuda.empty_cache()
    out["states_resume"] = on_plain_path(
        lambda: _ops_states_resume(args, torch), "ops (f)")
    out["launches"] = {k: v - fa_reset[k] for k, v in
                       kernel_launches().items()}
    if any(out["launches"].values()):
        fail("ops: a flash kernel launched %s" % out["launches"])
    # (f) again on the flash path that BERT training runs; its launches
    # are counted apart (``ops_resume`` in the kernel rows): 4 steps, one
    # forward and one backward a layer each
    n0 = kernel_launches()
    out["states_resume_flash"] = _ops_states_resume(args, torch)
    out["resume_launches"] = {k: v - n0[k] for k, v in
                              kernel_launches().items()}
    want = 4 * out["states_resume_flash"]["layers"]
    if out["resume_launches"] != {
            "flash_attn_fwd": want, "flash_attn_fwd_bhsd": 0,
            "flash_attn_bwd_dq": want, "flash_attn_bwd_dkv": want}:
        fail("ops (f) on the flash path launched %s, not %d of each BSHD "
             "kernel" % (out["resume_launches"], want))
    if mismatches:                # after (e) and (f): one run tells all
        fail("ops: %d cases differ from the CPU: %s"
             % (len(mismatches), "; ".join(mismatches)))
    out["wall_s"] = time.perf_counter() - t0
    return out


def _ops_states_resume(args, torch):
    """(f) BERT-base Adam through ``gluon.Trainer`` on the card: two steps,
    ``save_states`` and the ``.params``; a fresh model from that file and a
    fresh trainer that ``load_states``; the third step must equal the
    uninterrupted one bit for bit (every parameter). The caller runs it on
    the plain attention path (where parts a-f launch no flash kernel) and
    then on the flash path."""
    from mxnet_tpu_torch import convert, gluon, initializer
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon import collect_params
    from mxnet_tpu_torch.models import PretrainStep, bert_base, \
        synthetic_batch
    from mxnet_tpu_torch.ndarray import save_ndarrays
    dev = torch.device("cuda")
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    params_path = os.path.join(build, "ops_resume.params")
    states_path = os.path.join(build, "ops_resume.states")
    batches = [tuple(torch.from_numpy(a).to(dev) for a in synthetic_batch(
        np.random.default_rng(args.seed + 40 + i), BERT_BATCH, BERT_SEQ,
        BERT_VOCAB, BERT_MASKS)) for i in range(3)]
    hyper = {"learning_rate": 1e-4, "wd": 0.01}

    def model_and_trainer(path=None):
        model = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                          device=dev)
        step = PretrainStep(model)
        params = collect_params(step)
        if path is None:
            trandom.seed(args.seed)
            params.initialize(initializer.Xavier())
        else:
            convert.load_mxnet_params(model, path)
        return model, step, gluon.Trainer(params, "adam", dict(hyper))

    def train(step, tr, i):
        trandom.seed(args.seed + 100 + i)      # the same dropout keys
        loss = step(*batches[i])
        loss.backward()
        tr.step(1)
        return float(loss.detach())

    model, step, tr = model_and_trainer()
    layers = len(model.encoder.layers)
    losses = [train(step, tr, i) for i in range(2)]
    saved = convert.mxnet_params_from_state_dict(model.state_dict())
    save_ndarrays(params_path, list(saved.values()), list(saved))
    tr.save_states(states_path)
    nbytes = os.path.getsize(states_path)
    losses.append(train(step, tr, 2))
    want = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, step, tr, saved
    torch.cuda.empty_cache()
    model2, step2, tr2 = model_and_trainer(params_path)
    tr2.load_states(states_path)
    resumed = train(step2, tr2, 2)
    got = model2.state_dict()
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    n_params = len(want)
    os.remove(params_path)
    os.remove(states_path)
    if differ or resumed != losses[2]:
        fail("ops (f): the resumed third step differs (loss %r vs %r; "
             "parameters %s)" % (resumed, losses[2], differ[:4]))
    del model2, step2, tr2, want, got
    torch.cuda.empty_cache()
    return {"losses": losses, "states_bytes": nbytes,
            "parameters_equal": n_params, "layers": layers}


def print_ops(ops, card):
    """The ops phase's lines of the output."""
    g = OPS_GEMM
    print("ops: %d of %d new names ran through nd.<name> on gpu(0) (%d "
          "deterministic ones held to the CPU, %d samplers); topk k%d %s "
          "%.4f ms, sort %s %.4f ms, linalg_gemm2 %s x %s %.4f ms fp32 [%s]; "
          "flash launches %s; %.1f s" % (
              ops["names_on_card"], ops["names_total"],
              ops["deterministic_on_card"], ops["samplers"]["names"],
              OPS_TOPK, OPS_LOGITS, ops["ms"]["topk"], OPS_LOGITS,
              ops["ms"]["sort"], g, (g[0], g[2], g[1]),
              ops["ms"]["linalg_gemm2"], card, ops["launches"],
              ops["wall_s"]), flush=True)
    for key, path in (("states_resume", "plain attention path"),
                      ("states_resume_flash", "flash path, launches %s"
                       % ops["resume_launches"])):
        r = ops[key]
        print("ops (f): BERT-base Adam via gluon.Trainer (%s), .states %d "
              "bytes, the resumed third step equals the uninterrupted one "
              "bit for bit (%d parameters; losses %s)" % (
                  path, r["states_bytes"], r["parameters_equal"],
                  ", ".join("%.4f" % v for v in r["losses"])), flush=True)


# ---- np phase: the numpy frontends and the second part of the op corpus --

NP_SIZES = {"small": {"rows": 3, "cols": 4, "depth": 2, "n": 6, "knots": 5,
                      "m": 3},
            # the card phase's (b): every function at a few hundred KB
            "card": {"rows": 48, "cols": 64, "depth": 8, "n": 512,
                     "knots": 64, "m": 64}}


def np_host(size="small", seed=7):
    """The ``mx.np`` cases' inputs (numpy, made from ``seed``): name ->
    (array, dtype or None)."""
    z = NP_SIZES[size]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rows, cols, n = z["rows"], z["cols"], z["n"]
    a = rng.standard_normal((z["m"], z["m"])).astype(f32)
    nan = rng.standard_normal(n).astype(f32)
    nan[2::7] = np.nan
    ints = np.array([3, 0, 2, 2, 5, 1] * (n // 6 + 1), np.int32)[:n]
    return {
        "x": (rng.standard_normal((rows, cols)).astype(f32), None),
        "y": (rng.standard_normal((rows, cols)).astype(f32), None),
        "v": (rng.standard_normal(n).astype(f32), None),
        "w": (rng.uniform(0.5, 2.0, n).astype(f32), None),
        "u": (rng.uniform(-0.9, 0.9, n).astype(f32), None),
        "i": (ints, "int32"),
        "j": (np.array([1, 4, 2, 3, 1, 2] * (n // 6 + 1),
                       np.int32)[:n], "int32"),
        "b": (np.array([True, False, True, True, False, True] *
                       (n // 6 + 1))[:n], "bool"),
        "s": (np.sort(rng.standard_normal(z["knots"])).astype(f32), None),
        "m": ((a @ a.T / z["m"] + 3 * np.eye(z["m"])).astype(f32), None),
        "t": (rng.standard_normal((z["depth"], rows, cols)).astype(f32),
              None),
        "n": (nan, None),
        "p": (np.array([0.2, 0.5, 0.3], f32), None),
    }


def np_arrays(npmod, host):
    """``host``'s arrays as ``npmod.array``s (the CPU or the card: the
    caller's context)."""
    return {k: npmod.array(v, dtype=d) for k, (v, d) in host.items()}


NP_UNARY = {  # the generated families' unary functions: the input each takes
    "abs": "x", "absolute": "x", "sign": "x", "sqrt": "w", "cbrt": "x",
    "square": "x", "exp": "u", "expm1": "u", "log": "w", "log2": "w",
    "log10": "w", "log1p": "w", "sin": "x", "cos": "x", "tan": "u",
    "arcsin": "u", "arccos": "u", "arctan": "x", "sinh": "u", "cosh": "u",
    "tanh": "x", "arcsinh": "x", "arccosh": "w1", "arctanh": "u",
    "floor": "x", "ceil": "x", "trunc": "x", "rint": "x", "fix": "x",
    "negative": "x", "reciprocal": "w", "degrees": "x", "radians": "x",
    "deg2rad": "x", "rad2deg": "x", "isnan": "n", "isinf": "n",
    "isfinite": "n", "logical_not": "b", "sort": "x", "argsort": "i",
    "copy": "x", "conj": "x", "real": "x", "imag": "x", "angle": "x",
    "exp2": "u", "positive": "x", "invert": "i", "signbit": "x",
    "sinc": "x", "i0": "x", "isposinf": "n", "isneginf": "n",
    "iscomplex": "x", "isreal": "x", "bitwise_not": "i", "conjugate": "x",
    "fabs": "x", "spacing": "x", "argwhere": "i", "flatnonzero": "i",
    "ravel": "t", "flipud": "x", "fliplr": "x", "atleast_1d": "v",
    "atleast_2d": "v", "atleast_3d": "x", "nonzero": "i",
    "count_nonzero": "i", "trim_zeros": "i0", "ediff1d": "i",
    "transpose": "t", "squeeze": "x1", "flatten": "t", "unique": "i",
    "ptp": "x", "gradient": "v", "cov": "x", "corrcoef": "x", "unwrap": "v",
    "median": "x", "nanmedian": "n", "nanmean": "n", "nansum": "n",
    "nanstd": "n", "nanvar": "n", "nanmin": "n", "nanmax": "n",
    "nanargmin": "n", "nanargmax": "n", "nanprod": "n", "nancumsum": "n",
    "nancumprod": "n", "average": "x", "histogram_bin_edges": "v",
    "histogram": "v", "bincount": "i", "sum": "t", "mean": "t", "std": "t",
    "var": "t", "prod": "x", "max": "t", "min": "t", "amax": "x",
    "amin": "x", "argmax": "x", "argmin": "x", "cumsum": "x",
    "cumprod": "x", "all": "b", "any": "b", "diagonal": "x", "diag": "v",
    "tril": "x", "triu": "x", "trace": "x", "around": "x", "round": "x",
    "nan_to_num": "n", "rot90": "x", "flip": "t",
}


def np_unary_input(a, key):
    if key == "w1":
        return a["w"] + 1
    if key == "i0":
        return a["i"] * (a["i"] != 5)
    if key == "x1":
        return a["x"].reshape((1,) + a["x"].shape)
    return a[key]


NP_BINARY = {  # the binary functions: their two inputs
    "add": "xy", "subtract": "xy", "multiply": "xy", "divide": "xy",
    "true_divide": "xy", "mod": "ij", "remainder": "xy", "power": "wv",
    "float_power": "wv", "maximum": "xy", "minimum": "xy", "hypot": "xy",
    "arctan2": "xy", "logaddexp": "xy", "copysign": "xy", "fmod": "xy",
    "fmax": "xy", "fmin": "xy", "equal": "ij", "not_equal": "ij",
    "greater": "xy", "greater_equal": "xy", "less": "xy",
    "less_equal": "xy", "logical_and": "bi", "logical_or": "bi",
    "logical_xor": "bi", "bitwise_and": "ij", "bitwise_or": "ij",
    "bitwise_xor": "ij", "left_shift": "ij", "right_shift": "ij",
    "gcd": "ij", "lcm": "ij", "heaviside": "xy", "ldexp": "vi",
    "floor_divide": "xy", "nextafter": "xy", "logaddexp2": "xy",
    "isclose": "xy", "outer": "vi", "inner": "vv", "kron": "vi",
    "vdot": "vw", "polyval": "sv", "convolve": "vs", "correlate": "vs",
    "isin": "ij", "in1d": "ij", "intersect1d": "ij", "union1d": "ij",
    "setdiff1d": "ij", "setxor1d": "ij", "append": "iv",
}


def np_cases():
    """Every public function of ``mx.np`` and ``mx.np.linalg`` bar
    creation, utilities and the factor functions: ``name -> (function of
    (np module, arrays), kind)``, the arrays those of :func:`np_host`, at
    any of its sizes (the CPU tests' and the card phase's). ``kind``
    ``"loose"`` marks products of several float32 roundings."""
    cases = {}
    for name, key in NP_UNARY.items():
        cases[name] = (lambda np, a, n=name, k=key:
                       getattr(np, n)(np_unary_input(a, k)), None)
    for name, (k1, k2) in NP_BINARY.items():
        cases[name] = (lambda np, a, n=name, p=k1, q=k2:
                       getattr(np, n)(a[p], a[q]), None)
    cases.update({
        "matmul": (lambda np, a: np.matmul(a["x"], a["y"].T), None),
        "dot": (lambda np, a: np.dot(a["t"], a["y"].T), None),
        "cross": (lambda np, a: np.cross(a["x"][:, :3], a["y"][:, :3]),
                  None),
        "take_along_axis": (lambda np, a: np.take_along_axis(
            a["x"], (a["i"][:a["x"].shape[1]] % a["x"].shape[0]).reshape(
                1, -1).astype("int64"), 0), None),
        "polyval": (lambda np, a: np.polyval(a["s"][:5], a["v"]), "loose"),
        "sort_axis": (lambda np, a: np.sort(a["x"], 0), None),
        "argsort_float": (lambda np, a: np.argsort(a["x"], axis=1), None),
        "sum_axis": (lambda np, a: np.sum(a["t"], axis=(0, 2),
                                          keepdims=True), None),
        "mean_axis": (lambda np, a: np.mean(a["t"], 1), None),
        "std_ddof": (lambda np, a: np.std(a["t"], axis=2, ddof=1), None),
        "var_axis": (lambda np, a: np.var(a["x"], axis=0), None),
        "max_axis": (lambda np, a: np.max(a["t"], axis=2), None),
        "argmax_axis": (lambda np, a: np.argmax(a["t"], axis=1), None),
        "cumsum_axis": (lambda np, a: np.cumsum(a["t"], axis=2), None),
        "quantile": (lambda np, a: np.quantile(a["x"], 0.3, axis=1), None),
        "percentile": (lambda np, a: np.percentile(a["v"], 75), None),
        "nanquantile": (lambda np, a: np.nanquantile(a["n"], 0.3), None),
        "nanpercentile": (lambda np, a: np.nanpercentile(a["n"], 40),
                          None),
        "median_axis": (lambda np, a: np.median(a["t"], axis=(0, 2)), None),
        "expand_dims": (lambda np, a: np.expand_dims(a["x"], 1), None),
        "roll": (lambda np, a: np.roll(a["x"], 2, 1), None),
        "roll_flat": (lambda np, a: np.roll(a["x"], 5), None),
        "tile": (lambda np, a: np.tile(a["v"], (2, 2)), None),
        "repeat": (lambda np, a: np.repeat(a["x"], 2, axis=0), None),
        "unique_all": (lambda np, a: np.unique(a["i"], True, True, True),
                       None),
        "diff": (lambda np, a: np.diff(a["x"], 2, axis=1), None),
        "clip": (lambda np, a: np.clip(a["x"], -0.5, 0.5), None),
        "clip_int": (lambda np, a: np.clip(a["i"], 1, 3), None),
        "around_dec": (lambda np, a: np.around(a["x"], 2), None),
        "reshape": (lambda np, a: np.reshape(a["t"], (-1, 2 * a["t"].shape[
            -1])), None),
        "swapaxes": (lambda np, a: np.swapaxes(a["t"], 0, 2), None),
        "moveaxis": (lambda np, a: np.moveaxis(a["t"], 0, -1), None),
        "rollaxis": (lambda np, a: np.rollaxis(a["t"], 2), None),
        "broadcast_to": (lambda np, a: np.broadcast_to(
            a["v"], (2,) + a["v"].shape), None),
        "trace_off": (lambda np, a: np.trace(a["x"], 1), None),
        "diagonal_off": (lambda np, a: np.diagonal(a["t"], 1, 1, 2), None),
        "diag_k": (lambda np, a: np.diag(a["x"], -1), None),
        "tril_k": (lambda np, a: np.tril(a["x"], 1), None),
        "searchsorted": (lambda np, a: np.searchsorted(a["s"], a["v"]),
                         None),
        "searchsorted_right": (lambda np, a: np.searchsorted(
            a["s"], a["v"], side="right"), None),
        "partition": (lambda np, a: np.partition(a["v"], 2), None),
        "argpartition": (lambda np, a: np.argpartition(a["v"], 2), None),
        "pad": (lambda np, a: np.pad(a["x"], 1), None),
        "pad_reflect": (lambda np, a: np.pad(a["x"], ((1, 2), (3, 0)),
                                             mode="reflect"), None),
        "pad_edge": (lambda np, a: np.pad(a["v"], 2, mode="edge"), None),
        "pad_value": (lambda np, a: np.pad(a["v"], (1, 2),
                                           constant_values=7), None),
        "average_w": (lambda np, a: np.average(a["x"], 1, a["w"][
            :a["x"].shape[1]]), None),
        "take": (lambda np, a: np.take(a["x"], a["i"]), None),
        "take_axis": (lambda np, a: np.take(a["x"], a["j"] % 4, axis=1),
                      None),
        "compress": (lambda np, a: np.compress(a["b"][:3], a["x"], 0),
                     None),
        "delete": (lambda np, a: np.delete(a["v"], 2), None),
        "delete_axis": (lambda np, a: np.delete(a["x"], 2, 1), None),
        "delete_many": (lambda np, a: np.delete(a["v"], a["j"][:2]), None),
        "insert": (lambda np, a: np.insert(a["i"], 1, 9), None),
        "insert_axis": (lambda np, a: np.insert(a["x"], 2, 5.0, axis=1),
                        None),
        "append_axis": (lambda np, a: np.append(a["x"], a["y"], 0), None),
        "resize": (lambda np, a: np.resize(a["i"], (3, 3)), None),
        "digitize": (lambda np, a: np.digitize(a["v"], a["s"]), None),
        "digitize_right": (lambda np, a: np.digitize(a["v"], a["s"], True),
                           None),
        "histogram_range": (lambda np, a: np.histogram(a["v"], 4,
                                                       (-1.0, 1.0)), None),
        "cov_rows": (lambda np, a: np.cov(a["x"]), "loose"),
        "corrcoef_rows": (lambda np, a: np.corrcoef(a["x"]), "loose"),
        "gradient_2d": (lambda np, a: np.gradient(a["x"]), None),
        "unravel_index": (lambda np, a: np.unravel_index(a["i"], (2, 3)),
                          None),
        "nan_to_num_args": (lambda np, a: np.nan_to_num(a["n"], nan=-1.0),
                            None),
        "concatenate": (lambda np, a: np.concatenate([a["x"], a["y"]], 1),
                        None),
        "concatenate_none": (lambda np, a: np.concatenate(
            [a["x"], a["v"]], axis=None), None),
        "stack": (lambda np, a: np.stack([a["x"], a["y"]], 2), None),
        "vstack": (lambda np, a: np.vstack([a["x"], a["y"]]), None),
        "hstack": (lambda np, a: np.hstack([a["x"], a["y"]]), None),
        "dstack": (lambda np, a: np.dstack([a["x"], a["y"]]), None),
        "column_stack": (lambda np, a: np.column_stack([a["v"], a["w"]]),
                         None),
        "split": (lambda np, a: np.split(a["t"], 2, axis=2), None),
        "split_idx": (lambda np, a: np.split(a["v"], [1, 4]), None),
        "array_split": (lambda np, a: np.array_split(a["v"], 4), None),
        "hsplit": (lambda np, a: np.hsplit(a["x"], 2), None),
        "vsplit": (lambda np, a: np.vsplit(a["x"], [1]), None),
        "dsplit": (lambda np, a: np.dsplit(a["t"], 2), None),
        "where": (lambda np, a: np.where(a["b"], a["v"], a["w"]), None),
        "where_scalar": (lambda np, a: np.where(a["b"], a["i"], 1.5), None),
        "where_one": (lambda np, a: np.where(a["i"]), None),
        "einsum": (lambda np, a: np.einsum("ij,kj->ik", a["x"], a["y"]),
                   None),
        "tensordot": (lambda np, a: np.tensordot(a["t"], a["x"],
                                                 ([1, 2], [0, 1])), None),
        "meshgrid": (lambda np, a: np.meshgrid(a["v"], a["s"]), None),
        "broadcast_arrays": (lambda np, a: np.broadcast_arrays(
            a["x"], a["v"][:a["x"].shape[1]]), None),
        "zeros_like": (lambda np, a: np.zeros_like(a["i"]), None),
        "ones_like": (lambda np, a: np.ones_like(a["x"], dtype="float16"),
                      None),
        "full_like": (lambda np, a: np.full_like(a["x"], 2.5), None),
        "tril_indices": (lambda np, a: np.tril_indices(4, 1), None),
        "triu_indices": (lambda np, a: np.triu_indices(3, 0, 4), None),
        "diag_indices": (lambda np, a: np.diag_indices(3), None),
        "vander": (lambda np, a: np.vander(a["v"], 4), "loose"),
        "vander_inc": (lambda np, a: np.vander(a["i"][:6], increasing=True),
                       None),
        "divmod": (lambda np, a: np.divmod(a["i"], a["j"]), None),
        "modf": (lambda np, a: np.modf(a["x"]), None),
        "frexp": (lambda np, a: np.frexp(a["x"]), None),
        "flatten": (lambda np, a: np.flatten(a["t"]), None),
        "kaiser": (lambda np, a: np.kaiser(7, 3.0), "loose"),
        "isin_invert": (lambda np, a: np.isin(a["i"], a["j"], invert=True),
                        None),
        "intersect_idx": (lambda np, a: np.intersect1d(
            a["i"], a["j"], return_indices=True), None),
        "linalg.norm": (lambda np, a: np.linalg.norm(a["x"]), None),
        "linalg.norm_ord": (lambda np, a: np.linalg.norm(a["x"], 1, 1),
                            None),
        "linalg.norm_fro": (lambda np, a: np.linalg.norm(a["x"], "fro"),
                            None),
        "linalg.inv": (lambda np, a: np.linalg.inv(a["m"]), "loose"),
        "linalg.pinv": (lambda np, a: np.linalg.pinv(a["x"]), "loose"),
        "linalg.det": (lambda np, a: np.linalg.det(a["m"]), "loose"),
        "linalg.slogdet": (lambda np, a: np.linalg.slogdet(a["m"]),
                           "loose"),
        "linalg.solve": (lambda np, a: np.linalg.solve(a["m"], a["m"][:, :2]
                                                       + 1), "loose"),
        "linalg.lstsq": (lambda np, a: np.linalg.lstsq(
            a["x"].T, a["v"][:a["x"].shape[1]]), "loose"),
        "linalg.matrix_rank": (lambda np, a: np.linalg.matrix_rank(a["x"]),
                               None),
        "linalg.matrix_power": (lambda np, a: np.linalg.matrix_power(
            a["m"], 3), "loose"),
        "linalg.eigvalsh": (lambda np, a: np.linalg.eigvalsh(a["m"]),
                            "loose"),
        "interp": (lambda np, a: np.interp(a["v"], a["s"], a["w"][
            :a["s"].shape[0]]), None),
        "linalg.tensorinv": (lambda np, a: np.linalg.tensorinv(a["m"], 1),
                             "loose"),
        "linalg.tensorsolve": (lambda np, a: np.linalg.tensorsolve(
            a["m"], a["v"][:a["m"].shape[0]]), "loose"),
    })
    return cases


# every name the reference's ops/numpy_ops.py, ops/optim_ops.py,
# ops/linalg_extra.py and ops/image_ops.py register, the rest of its
# ops/nn.py, and numpy_ops.py's aliases onto the port's other ops
NP_NEW_NAMES = """
    Convolution_v1 L2Normalization LRN Pooling_v1 SoftmaxActivation
    UpSampling _adamw_update _image_adjust_lighting _image_crop
    _image_flip_left_right _image_flip_top_bottom _image_normalize
    _image_random_brightness _image_random_color_jitter
    _image_random_contrast _image_random_flip_left_right
    _image_random_flip_top_bottom _image_random_hue _image_random_lighting
    _image_random_saturation _image_resize _image_to_tensor _linalg_det
    _linalg_extracttrian _linalg_gelqf _linalg_inverse _linalg_makediag
    _linalg_maketrian _linalg_potri _linalg_slogdet _linalg_syevd
    _linalg_trmm _mp_adamw_update _multi_adamw_update
    _multi_mp_adamw_update _np_moveaxis _np_trace _npi_arctan2
    _npi_arctan2_scalar _npi_around _npi_bernoulli _npi_blackman
    _npi_boolean_mask_assign_scalar _npi_boolean_mask_assign_tensor
    _npi_choice _npi_column_stack _npi_copysign _npi_copysign_scalar
    _npi_diff _npi_dstack _npi_einsum _npi_hamming _npi_hanning _npi_hsplit
    _npi_identity _npi_indices _npi_inv _npi_lcm _npi_lcm_scalar _npi_ldexp
    _npi_ldexp_scalar _npi_logspace _npi_multinomial _npi_nan_to_num
    _npi_nonzero _npi_rarctan2_scalar _npi_rcopysign_scalar
    _npi_rldexp_scalar _npi_rot90 _npi_share_memory _npi_std _npi_svd
    _npi_tensordot _npi_tensordot_int_axes _npi_tril _npi_unique _npi_var
    _npi_vstack _npx__image_adjust_lighting _npx__image_crop
    _npx__image_flip_left_right _npx__image_flip_top_bottom
    _npx__image_normalize _npx__image_random_brightness
    _npx__image_random_color_jitter _npx__image_random_contrast
    _npx__image_random_flip_left_right _npx__image_random_flip_top_bottom
    _npx__image_random_hue _npx__image_random_lighting
    _npx__image_random_saturation _npx__image_resize _npx__image_to_tensor
    _npx_activation _npx_batch_norm _npx_convolution _npx_deconvolution
    _npx_dropout _npx_fully_connected _npx_layer_norm _npx_leaky_relu
    _npx_log_softmax _npx_nonzero _npx_pooling _npx_relu _npx_sigmoid
    _npx_softmax _sparse_adagrad_update adagrad_update adam_update
    adamw_update arctan2 around batch_take blackman column_stack copysign
    det diff dstack einsum ftml_update ftrl_update hamming hanning
    hard_sigmoid image_crop image_flip_left_right image_flip_top_bottom
    image_normalize image_resize image_to_tensor indices inverse lcm ldexp
    linalg_det linalg_extracttrian linalg_gelqf linalg_inverse
    linalg_makediag linalg_maketrian linalg_potri linalg_slogdet
    linalg_syevd linalg_trmm logspace moveaxis mp_adamw_update
    mp_nag_mom_update mp_sgd_mom_update mp_sgd_update multi_adamw_update
    multi_lars multi_mp_adamw_update multi_mp_sgd_mom_update
    multi_mp_sgd_update multi_sgd_mom_update multi_sgd_update
    nag_mom_update nan_to_num nonzero preloaded_multi_mp_sgd_mom_update
    preloaded_multi_mp_sgd_update preloaded_multi_sgd_mom_update
    preloaded_multi_sgd_update rmsprop_update rmspropalex_update rot90
    sgd_mom_update sgd_update share_memory signsgd_update signum_update
    softmax_cross_entropy softmin std svd tensordot trace tril unique var
    vstack
""".split()
NP_LOGITS = (32, 32000)           # transformer_lm_base's vocabulary
NP_SVD = ((768, 768), (768, 3072))  # BERT-base's weights
NP_SPD = (64, 768, 768)
NP_LQ = (64, 128, 768)
# the CPU recomputes the first NP_CPU_SLICE matrices of the SPD and LQ
# batches (the card runs all 64): the CPU's LAPACK takes seconds a batch
NP_CPU_SLICE = 4
NP_IMAGES = (32, 256, 256, 3)     # uint8, resized to NP_CROP
NP_CROP = 224
NP_MEAN = (0.485, 0.456, 0.406)
NP_STD = (0.229, 0.224, 0.225)
NP_MLM_ROWS = BERT_BATCH * BERT_MASKS      # 1280 masked positions
NP_DRAWS = (32, 3, 224, 224)
NP_TOL = (1e-5, 1e-5)             # (b): rtol, atol of the output's max
NP_MLM_TOL = 1e-4                 # (c): the card against the CPU, of max
NP_UPDATE_TOL = (1e-6, 1e-7)      # (a), (d): fp32 updates, rtol, atol
NP_LOGIT_TOL = 2e-2               # (e): logits of the two batches, of max
# a singular or eigen vector of a float32 factorization is as accurate as
# eps / (the gap to its neighbours): those with a gap of NP_GAP of the
# largest value are held to |<u, u_cpu>| = 1 within NP_VECTOR_TOL
NP_VECTOR_TOL = 1e-3
NP_GAP = 1e-3          # a vector is compared where its value's gap is this
NP_FACTOR_TOL = 1e-5   # a factorization's values, of the largest
NP_UPDATE_ITERS = 5
NP_ADAM = {"lr": 1e-4, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
           "wd": 0.01}


def _np_arrays(seed):
    """Part (a)'s inputs (numpy, made from ``seed``), by key."""
    import torch
    rng = np.random.default_rng(seed + 61)
    f32 = np.float32

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape, dtype=f32)).astype(f32)
    L = normal(NP_LOGITS, 3.0)
    nan = L.copy()
    nan.reshape(-1)[::9973] = np.nan
    nan.reshape(-1)[5::9973] = np.inf
    nan.reshape(-1)[7::9973] = -np.inf
    m = torch.from_numpy(normal(NP_SPD)) / NP_SPD[-1] ** 0.5
    spd = (m @ m.transpose(-1, -2) + torch.eye(NP_SPD[-1])).numpy()
    lower = torch.linalg.cholesky(torch.from_numpy(spd)).numpy()
    # det overflows float32 at 768 (eigenvalues 1..5): each matrix scaled
    # to determinant ~1 for it
    logdet = torch.linalg.slogdet(torch.from_numpy(spd).double())[1]
    unit = (spd / torch.exp(logdet / NP_SPD[-1]).numpy()[:, None, None]) \
        .astype(f32)
    n_tri = NP_SPD[-1] * (NP_SPD[-1] + 1) // 2
    return {
        "L": L, "L2": normal(NP_LOGITS), "N": nan,
        "P": rng.uniform(0.5, 2.0, NP_LOGITS).astype(f32),
        "U": rng.uniform(-0.9, 0.9, NP_LOGITS).astype(f32),
        "I": rng.integers(1, 13, NP_LOGITS).astype(np.int32),
        "J": rng.integers(1, 13, NP_LOGITS).astype(np.int32),
        "E": rng.integers(-8, 9, NP_LOGITS).astype(np.int32),
        "M": rng.integers(0, 2, NP_LOGITS).astype(f32),
        "lab": rng.integers(-1, NP_LOGITS[1], NP_LOGITS[0]).astype(f32),
        "W768": normal(NP_SVD[0], 0.02), "W3072": normal(NP_SVD[1], 0.02),
        "S": spd, "SD": unit, "Lo": lower,
        "R": normal(NP_SPD[:2] + (64,)),
        "Q": normal(NP_LQ), "D": normal(NP_SPD[:2]),
        "T": normal((NP_SPD[0], n_tri)),
        "X": normal((32, 64, 56, 56)),
        "IMG": rng.integers(0, 256, NP_IMAGES).astype(np.uint8),
        "CHW": rng.uniform(0, 1, (NP_IMAGES[0], 3, NP_CROP, NP_CROP))
        .astype(f32),
        "V3": normal((NP_LOGITS[0], 4096)),
        "lrs": np.array([0.1, 0.05, 0.2], f32),
        "wds": np.array([0.0, 0.01, 0.02], f32),
        "scale": np.array(0.5, f32),
    }


def _np_op_cases():
    """Each deterministic primary op of part (a): (args, kwargs, family);
    ``"@K"`` is array ``K`` (``"@K:bf16"`` in bf16, ``"@K:cpu4"`` the
    first NP_CPU_SLICE matrices on the CPU side), ``"@upd3"`` three
    (weight, grad, ...) groups of the logits' shape."""
    hyper = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
             "clip_gradient": 0.3}
    mom = dict(hyper, momentum=0.9)
    multi = {"lrs": [0.1, 0.05, 0.2], "wds": [0.0, 0.01, 0.02],
             "rescale_grad": 0.5, "clip_gradient": 0.3, "num_weights": 3}
    pre = {"rescale_grad": 0.5, "clip_gradient": 0.3, "num_weights": 3}
    c = {
        # ops/numpy_ops.py at the logits' shape
        "around": (["@L"], {"decimals": 2}, "exact"),
        "rot90": (["@L"], {"k": 3}, "exact"),
        "std": (["@L"], {"axis": 1, "ddof": 1}, "reduce"),
        "var": (["@L"], {"axis": 1}, "reduce"),
        "einsum": (["@L", "@L2"], {"subscripts": "ij,ij->i"}, "linalg"),
        "tensordot": (["@L", "@L2"], {"a_axes_summed": (1,),
                                      "b_axes_summed": (1,)}, "linalg"),
        "_npi_tensordot_int_axes": (["@L", "@L2"], {"axes": 2}, "reduce"),
        "diff": (["@L"], {"n": 2, "axis": 1}, "exact"),
        "copysign": (["@L", "@L2"], {}, "exact"),
        "_npi_copysign_scalar": (["@L"], {"scalar": -1.0}, "exact"),
        "_npi_rcopysign_scalar": (["@L"], {"scalar": 2.5}, "exact"),
        "lcm": (["@I", "@J"], {}, "exact"),
        "_npi_lcm_scalar": (["@I"], {"scalar": 6}, "exact"),
        "ldexp": (["@L", "@E"], {}, "float"),
        "_npi_ldexp_scalar": (["@L"], {"scalar": 3}, "float"),
        "_npi_rldexp_scalar": (["@E"], {"scalar": 1.5}, "float"),
        "arctan2": (["@L", "@L2"], {}, "float"),
        "_npi_arctan2_scalar": (["@L"], {"scalar": 0.5}, "float"),
        "_npi_rarctan2_scalar": (["@L"], {"scalar": -0.5}, "float"),
        "nan_to_num": (["@N"], {"nan": 1.0}, "exact"),
        "_npi_indices": ([], {"dimensions": (32, 32, 32)}, "exact"),
        "logspace": ([], {"start": -2.0, "stop": 2.0, "num": 32000},
                     "float"),
        "_npi_blackman": ([], {"M": 32000}, "float"),
        "_npi_hamming": ([], {"M": 32000}, "float"),
        "_npi_hanning": ([], {"M": 32000}, "float"),
        "column_stack": (["@L", "@L2"], {}, "exact"),
        "dstack": (["@L", "@L2"], {}, "exact"),
        "vstack": (["@L", "@L2"], {}, "exact"),
        "_npi_hsplit": (["@L"], {"sections": 4}, "exact"),
        "tril": (["@W768"], {"k": -1}, "exact"),
        "moveaxis": (["@X"], {"source": 1, "destination": 3}, "exact"),
        "trace": (["@X"], {"axis1": 2, "axis2": 3}, "reduce"),
        "_npi_identity": ([], {"n": 768}, "exact"),
        "share_memory": (["@L", "@L2"], {}, "exact"),
        "_npi_boolean_mask_assign_scalar": (["@L", "@M"], {"value": 0.5},
                                            "exact"),
        "_npi_boolean_mask_assign_tensor": (["@L", "@M", "@L2"], {},
                                            "exact"),
        "nonzero": (["@M"], {}, "exact"),
        "unique": (["@I"], {"return_index": True, "return_inverse": True,
                            "return_counts": True}, "exact"),
        # the rest of nn.py
        "hard_sigmoid": (["@L"], {}, "exact"),
        "softmin": (["@L"], {}, "reduce"),
        "SoftmaxActivation": (["@X"], {"mode": "channel"}, "float"),
        "softmax_cross_entropy": (["@L", "@lab"], {}, "reduce"),
        "L2Normalization": (["@X"], {}, "float"),
        "LRN": (["@X"], {"nsize": 5}, "float"),
        "batch_take": (["@L", "@lab"], {}, "exact"),
        "UpSampling": (["@X"], {"scale": 2, "sample_type": "bilinear"},
                       "linalg"),
        "Convolution": (["@X", "@X:w", "@X:b"], {"kernel": (3, 3),
                                                 "num_filter": 64,
                                                 "pad": (1, 1)}, "linalg"),
        "Pooling": (["@X"], {"kernel": (3, 3), "stride": (2, 2),
                             "pool_type": "max"}, "exact"),
        "Activation": (["@L"], {"act_type": "relu"}, "exact"),
        "BatchNorm": (["@X", "@X:g", "@X:b", "@X:b", "@X:g"], {},
                      "float"),
        "Deconvolution": (["@X", "@X:w", "@X:b"], {"kernel": (3, 3),
                                                   "num_filter": 64},
                          "linalg"),
        "Dropout": (["@L"], {}, "exact"),
        "FullyConnected": (["@L", "@L:fw", "@L:fb"], {"num_hidden": 64},
                           "linalg"),
        "LayerNorm": (["@L", "@L:g", "@L:fb0"], {}, "float"),
        "LeakyReLU": (["@L"], {}, "exact"),
        "log_softmax": (["@L"], {}, "reduce"),
        "relu": (["@L"], {}, "exact"),
        "sigmoid": (["@L"], {}, "float"),
        "softmax": (["@L"], {}, "reduce"),
        # ops/linalg_extra.py at BERT-base's shapes
        "_npi_svd": (["@W3072"], {}, "factors"),
        "linalg_det": (["@SD:cpu4"], {}, "linalg"),
        "linalg_slogdet": (["@S:cpu4"], {}, "linalg"),
        "linalg_inverse": (["@S:cpu4"], {}, "linalg"),
        "linalg_potri": (["@Lo:cpu4"], {}, "linalg"),
        "linalg_trmm": (["@Lo:cpu4", "@R:cpu4"], {"alpha": 0.5}, "linalg"),
        "linalg_gelqf": (["@Q:cpu4"], {}, "factors"),
        "linalg_syevd": (["@S:cpu4"], {}, "factors"),
        "linalg_makediag": (["@D"], {"offset": 1}, "exact"),
        "linalg_maketrian": (["@T"], {}, "exact"),
        "linalg_extracttrian": (["@S"], {"lower": False}, "exact"),
        # ops/image_ops.py at the preprocessing shapes
        "_image_to_tensor": (["@IMG"], {}, "exact"),
        "_image_normalize": (["@CHW"], {"mean": NP_MEAN, "std": NP_STD},
                             "exact"),
        "_image_crop": (["@IMG"], {"x": 16, "y": 16, "width": NP_CROP,
                                   "height": NP_CROP}, "exact"),
        "_image_resize": (["@IMG"], {"size": NP_CROP}, "resize"),
        "_image_flip_left_right": (["@IMG"], {}, "exact"),
        "_image_flip_top_bottom": (["@IMG"], {}, "exact"),
        "_image_adjust_lighting": (["@IMG"], {"alpha": (0.3, -0.2, 0.1)},
                                   "exact"),
        # ops/optim_ops.py at the logits' shape (fp32; mp in bf16)
        "sgd_update": (["@L", "@L2"], hyper, "update"),
        "sgd_mom_update": (["@L", "@L2", "@U"], mom, "update"),
        "mp_sgd_update": (["@L:bf16", "@L2:bf16", "@L"], hyper, "update"),
        "mp_sgd_mom_update": (["@L:bf16", "@L2:bf16", "@U", "@L"], mom,
                              "update"),
        "nag_mom_update": (["@L", "@L2", "@U"], mom, "update"),
        "mp_nag_mom_update": (["@L:bf16", "@L2:bf16", "@U", "@L"], mom,
                              "update"),
        "adam_update": (["@L", "@L2", "@U", "@P"], hyper, "update"),
        "_adamw_update": (["@L", "@L2", "@U", "@P", "@scale"],
                          {"lr": 0.01, "wd": 0.1, "clip_gradient": 0.3},
                          "update"),
        "_mp_adamw_update": (["@L:bf16", "@L2:bf16", "@U", "@P", "@L",
                              "@scale"], {"lr": 0.01, "wd": 0.1},
                             "update"),
        "ftml_update": (["@L", "@L2", "@U", "@P", "@P"], dict(hyper, t=3),
                        "update"),
        # sqrt(n + g^2) - sqrt(n) cancels: an ulp of sqrt(n) is up to ~1e5
        # of the difference, so FTRL is held within 1e-5 of each max
        "ftrl_update": (["@L", "@L2", "@U", "@P"], hyper, "reduce"),
        "rmsprop_update": (["@L", "@L2", "@P"], hyper, "update"),
        "rmspropalex_update": (["@L", "@L2", "@P", "@U", "@U"], hyper,
                               "update"),
        "signsgd_update": (["@L", "@L2"], hyper, "update"),
        "signum_update": (["@L", "@L2", "@U"], mom, "update"),
        "_sparse_adagrad_update": (["@L", "@L2", "@P"], hyper, "update"),
        "multi_lars": (["@lrs", "@lrs:sq", "@wds:sq", "@wds"],
                       {"eta": 0.01}, "update"),
        "multi_sgd_update": (["@upd2"], multi, "update"),
        "multi_sgd_mom_update": (["@upd3"], dict(multi, momentum=0.9),
                                 "update"),
        "multi_mp_sgd_update": (["@upd3mp"], multi, "update"),
        "multi_mp_sgd_mom_update": (["@upd4mp"], dict(multi, momentum=0.9),
                                    "update"),
        "_multi_adamw_update": (["@upd4", "@scale"],
                                {"lrs": multi["lrs"], "wds": multi["wds"],
                                 "num_weights": 3}, "update"),
        "_multi_mp_adamw_update": (["@upd5mp", "@scale"],
                                   {"lrs": multi["lrs"],
                                    "wds": multi["wds"], "num_weights": 3},
                                   "update"),
        "preloaded_multi_sgd_update": (["@upd2", "@lrs", "@wds"], pre,
                                       "update"),
        "preloaded_multi_sgd_mom_update": (["@upd3", "@lrs", "@wds"], pre,
                                           "update"),
        "preloaded_multi_mp_sgd_update": (["@upd3mp", "@lrs", "@wds"], pre,
                                          "update"),
        "preloaded_multi_mp_sgd_mom_update": (["@upd4mp", "@lrs", "@wds"],
                                              pre, "update"),
    }
    return c


# the random ops of part (a): a draw on the card, its dtype and shape
# those of the CPU's draw, the same key words the same draw
NP_RANDOM_OPS = {
    "_npi_bernoulli": ([], {"prob": 0.3, "size": NP_LOGITS}),
    "_npi_choice": ([], {"a": 32000, "size": NP_LOGITS}),
    "_npi_multinomial": ([], {"n": 20, "pvals": (0.2, 0.3, 0.5),
                              "size": (4096,)}),
    "_image_random_flip_left_right": (["@IMG"], {}),
    "_image_random_flip_top_bottom": (["@IMG"], {}),
    "_image_random_brightness": (["@IMG"], {"min_factor": 0.6,
                                            "max_factor": 1.4}),
    "_image_random_contrast": (["@IMG"], {"min_factor": 0.6,
                                          "max_factor": 1.4}),
    "_image_random_saturation": (["@IMG"], {"min_factor": 0.6,
                                            "max_factor": 1.4}),
    "_image_random_hue": (["@IMG"], {"min_factor": -0.2, "max_factor": 0.2}),
    "_image_random_lighting": (["@IMG"], {"alpha_std": 0.1}),
    "_image_random_color_jitter": (["@IMG"], {"brightness": 0.4,
                                              "contrast": 0.4,
                                              "saturation": 0.4,
                                              "hue": 0.1}),
}


def _np_operand(arrays, key):
    """``"@K[:form]"`` as numpy (a list for the update groups, a
    ``("bf16", a)`` pair for bf16)."""
    name, _, form = key[1:].partition(":")
    if name.startswith("upd"):
        k = int(name[3])
        mp = name.endswith("mp")
        base = [arrays[n] for n in ("L", "L2", "U", "P", "L")]
        out = []
        for g in range(3):
            rows = slice(g * 8, g * 8 + 8)
            grp = [b[rows] for b in base[:k]]
            if mp:
                grp = [("bf16", grp[0]), ("bf16", grp[1])] + grp[2:-1] + \
                    [np.ascontiguousarray(grp[0])]
            out += [g_ if isinstance(g_, tuple) else np.ascontiguousarray(g_)
                    for g_ in grp]
        return out
    a = arrays[name]
    if form == "bf16":
        return ("bf16", a)
    if form == "sq":
        return (a * a + 1).astype(np.float32)
    if form == "w":
        return (0.05 * np.ones((64, a.shape[1], 3, 3), np.float32))
    if form == "b":
        return np.zeros(a.shape[1], np.float32)
    if form == "g":
        return np.ones(a.shape[1], np.float32)
    if form == "fw":
        return (np.resize(a, (64, a.shape[1])) * 0.01).astype(np.float32)
    if form == "fb":
        return np.zeros(64, np.float32)
    if form == "fb0":
        return np.zeros(a.shape[1], np.float32)
    return a


def _np_to(torch, value, dev):
    """A numpy operand as NDArray(s) on ``dev``."""
    from mxnet_tpu_torch import nd
    if isinstance(value, list):
        return [_np_to(torch, v, dev) for v in value]
    if isinstance(value, tuple) and value[0] == "bf16":
        return nd.NDArray(torch.from_numpy(value[1]).to(dev).bfloat16())
    t = torch.from_numpy(np.ascontiguousarray(value)).to(dev)
    return nd.NDArray(t)


def _np_compare(torch, family, own, ref, what, dev):
    """(a)'s card outputs against the CPU's: ``_ops_compare``'s families,
    ``update`` (fp32 rtol/atol NP_UPDATE_TOL, bf16 one ulp) and
    ``resize`` (uint8 within one level; the count of differing values is
    returned)."""
    own = own if isinstance(own, (list, tuple)) else [own]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    if len(own) != len(ref):
        raise _OpsMismatch("np %s: %d outputs on the card, %d on the CPU"
                           % (what, len(own), len(ref)))
    if family == "update":
        for i, (o, r) in enumerate(zip(own, ref)):
            o, r = o._data, r._data
            if o.device.type != dev.type or o.dtype != r.dtype or \
                    o.shape != r.shape:
                raise _OpsMismatch("np %s: output %d is %s %s on %s, "
                                   "%s %s on the CPU" % (
                                       what, i, o.dtype, tuple(o.shape),
                                       o.device, r.dtype, tuple(r.shape)))
            of, rf = o.cpu().double(), r.double()
            if o.dtype == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    rf.abs().clamp(min=2.0 ** -126))) - 7)
                bad = (of - rf).abs() > ulp
            else:
                rtol, atol = NP_UPDATE_TOL
                bad = (of - rf).abs() > atol + rtol * rf.abs()
            if bool(bad.any()):
                raise _OpsMismatch("np %s: output %d has %d values "
                                   "outside rtol %g atol %g of the CPU's"
                                   % (what, i, int(bad.sum()),
                                      *NP_UPDATE_TOL))
        return 0
    if family == "resize":
        o, r = own[0]._data, ref[0]._data
        if o.dtype != r.dtype or o.shape != r.shape or \
                o.device.type != dev.type:
            raise _OpsMismatch("np %s: %s %s on %s vs %s %s" % (
                what, o.dtype, tuple(o.shape), o.device, r.dtype,
                tuple(r.shape)))
        d = (o.cpu().int() - r.int()).abs()
        if int(d.max()) > 1:
            raise _OpsMismatch("np %s: %d levels from the CPU's"
                               % (what, int(d.max())))
        return int((d > 0).sum())
    _ops_compare(torch, family, own, ref, "np " + what, dev)
    return 0


def _np_factors(torch, name, own, ref, what):
    """(a)'s factor ops: values to the CPU's (NP_FACTOR_TOL of max), and
    each vector whose value stands apart from its neighbours (a gap of at
    least NP_GAP of the largest value: a float32 vector is as accurate as
    eps over its gap) against the CPU's up to its sign (|<u, u_cpu>| = 1
    within NP_VECTOR_TOL); the CPU holds the first NP_CPU_SLICE matrices
    of a batch. Returns the card's reconstruction and the count of
    vectors compared."""
    o = [x._data.double() for x in own]
    r = [x._data.double() for x in ref]
    if name == "_npi_svd":
        (u, s, vh), (ru, rs, rvh) = o, r
        vals, vecs, ref_vecs, ref_vals = s, u.transpose(-1, -2), \
            ru.transpose(-1, -2), rs
        recon = (u * s.unsqueeze(-2)) @ vh
    elif name == "linalg_gelqf":
        (lo, q), (rl, rq) = o, r
        vals, vecs, ref_vecs = lo.diagonal(dim1=-2, dim2=-1).abs(), q, rq
        ref_vals = rl.diagonal(dim1=-2, dim2=-1).abs()
        recon = lo @ q
    else:
        (uu, w), (ru, rw) = o, r
        vals, vecs, ref_vecs, ref_vals = w, uu, ru, rw
        recon = uu.transpose(-1, -2) @ (w.unsqueeze(-1) * uu)
    n = ref_vals.shape[0]
    if vals.dim() > 1:
        vals, vecs = vals[:n], vecs[:n]
    scale = ref_vals.abs().max().item()
    err = (vals.cpu() - ref_vals).abs().max().item() / scale
    if err > NP_FACTOR_TOL:
        raise _OpsMismatch("np (a) %s: values %.3g of max from the CPU's "
                           "(tol %g)" % (what, err, NP_FACTOR_TOL))
    if name == "linalg_gelqf":
        keep = torch.ones(ref_vals.shape, dtype=torch.bool)
    else:
        srt = ref_vals.sort(-1).values
        gaps = torch.diff(srt, dim=-1).abs()
        lo = torch.cat([gaps[..., :1] * 0 + float("inf"), gaps], -1)
        hi = torch.cat([gaps, gaps[..., :1] * 0 + float("inf")], -1)
        gap_sorted = torch.minimum(lo, hi)
        order = ref_vals.argsort(-1)
        gap = torch.empty_like(gap_sorted).scatter_(-1, order, gap_sorted)
        keep = gap >= NP_GAP * scale
    dots = (vecs.cpu() * ref_vecs).sum(-1).abs()
    worst = (dots - 1).abs()[keep].max().item() if bool(keep.any()) else 0.0
    if worst > NP_VECTOR_TOL:
        raise _OpsMismatch("np (a) %s: %d separated vectors, the worst "
                           "%.3g from the CPU's up to sign (tol %g)"
                           % (what, int(keep.sum()), worst, NP_VECTOR_TOL))
    return recon, int(keep.sum())


def _np_part_a(args, torch, mx, nd, dev, cpu):
    """(a) every new registry name through ``nd.<name>`` on ``gpu(0)``
    against the port's CPU result on the same inputs (computed once a
    primary and input)."""
    from mxnet_tpu_torch.ops.registry import get_op
    arrays = _np_arrays(args.seed)
    cases = _np_op_cases()
    cache, ref_cache, mismatches, vectors = {}, {}, [], {}
    resize_diff = 0

    def operand(key, device):
        if not isinstance(key, str) or not key.startswith("@"):
            return key
        base, _, form = key.partition(":")
        cpu4 = form == "cpu4"
        ck = (key, device.type)
        if ck not in cache:
            v = _np_operand(arrays, base if cpu4 else key)
            if cpu4 and device.type == "cpu":
                v = v[:NP_CPU_SLICE]
            cache[ck] = _np_to(torch, v, device)
        return cache[ck]

    def call(name, args_, kw, device):
        ctx = mx.gpu(0) if device.type == "cuda" else mx.cpu()
        vals = []
        for a in args_:
            v = operand(a, device)
            vals.extend(v if isinstance(v, list) else [v])
        with ctx:
            return getattr(nd, name)(*vals, **dict(kw))

    run = []
    for name in NP_NEW_NAMES:
        primary = get_op(name).name
        if primary in NP_RANDOM_OPS:
            continue
        if primary not in cases:
            mismatches.append("np (a) %s: no case" % name)
            continue
        args_, kw, family = cases[primary]
        try:
            own = call(name, args_, kw, dev)
            if primary not in ref_cache:
                ref_cache[primary] = call(name, args_, kw, cpu)
            ref = ref_cache[primary]
            if family == "factors":
                recon, n_vec = _np_factors(torch, primary, own, ref, name)
                vectors[name] = n_vec
                inp = operand(args_[0], dev)._data.double()
                if (recon - inp).abs().max().item() > \
                        1e-5 * inp.abs().max().item():
                    raise _OpsMismatch("np (a) %s: the factors do not "
                                       "reconstruct the input" % name)
            else:
                if args_ and str(args_[0]).endswith(":cpu4"):
                    own = [nd.NDArray(o._data[:NP_CPU_SLICE]) for o in
                           (own if isinstance(own, (list, tuple))
                            else [own])]
                resize_diff += _np_compare(torch, family, own, ref,
                                           "(a) " + name, dev)
        except _OpsMismatch as e:
            mismatches.append(str(e))
        run.append(name)
    # the random ops: on the card, the CPU's dtype and shape, keyed
    for name in NP_NEW_NAMES:
        primary = get_op(name).name
        if primary not in NP_RANDOM_OPS:
            continue
        args_, kw = NP_RANDOM_OPS[primary]
        kw = dict(kw, key=(args.seed, 17))
        a = call(name, args_, kw, dev)
        b = call(name, args_, kw, dev)
        c = call(name, args_, kw, cpu)
        a, b, c = a._data, b._data, c._data
        if a.device.type != dev.type or a.dtype != c.dtype or \
                a.shape != c.shape or not torch.equal(a, b):
            mismatches.append("np (a) %s: %s %s on %s (CPU %s %s), repeat "
                              "%s" % (name, a.dtype, tuple(a.shape),
                                      a.device, c.dtype, tuple(c.shape),
                                      torch.equal(a, b)))
        run.append(name)
    del cache, ref_cache
    return {"names": len(run), "resize_pixels_off_by_one": resize_diff,
            "vectors_compared": vectors,
            "resize_values": int(np.prod((NP_IMAGES[0], NP_CROP, NP_CROP,
                                          3)))}, mismatches


def _np_factor_fns(torch, npm, host):
    """(b)'s factor functions, each checked on its own device: values
    returned for the CPU comparison, the factors by reconstruction."""
    m, x = npm.array(host["m"][0]), npm.array(host["x"][0])
    out = {}
    u, s, vh = npm.linalg.svd(x)
    out["linalg.svd"] = (s, (u._data * s._data.unsqueeze(-2)) @ vh._data,
                         x._data)
    w, v = npm.linalg.eigh(m)
    out["linalg.eigh"] = (w, (v._data * w._data.unsqueeze(-2))
                          @ v._data.T, m._data)
    q, r = npm.linalg.qr(x)
    out["linalg.qr"] = (npm.abs(npm.diagonal(r)), q._data @ r._data,
                        x._data)
    c = npm.linalg.cholesky(m)
    out["linalg.cholesky"] = (c, c._data @ c._data.T, m._data)
    lam, vec = npm.linalg.eig(m)
    out["linalg.eig"] = (None, ((vec._data * lam._data.unsqueeze(-2))
                                @ torch.linalg.inv(vec._data)).real,
                         m._data)
    ev = npm.linalg.eigvals(m)
    if ev._data.dtype != torch.complex64:
        fail("np (b) linalg.eigvals gives %s" % ev._data.dtype)
    return out


def _np_part_b(args, torch, mx, dev, cpu):
    """(b) every public function of ``mx.np``, ``np.linalg``,
    ``np.random`` and ``mx.npx`` on ``gpu(0)`` against the CPU (the
    inputs of ``np_host("card")``); the dtypes must be equal."""
    import inspect
    from mxnet_tpu_torch import numpy as npm
    from mxnet_tpu_torch import numpy_extension as npx
    host = np_host("card", args.seed + 71)
    cases = np_cases()
    mismatches = []
    rtol, atol = NP_TOL

    def values(out):
        if isinstance(out, (tuple, list)):
            return [v for o in out for v in values(o)]
        return [out]

    with mx.cpu():
        cpu_arrays = np_arrays(npm, host)
    with mx.gpu(0):
        gpu_arrays = np_arrays(npm, host)
    for name in sorted(cases):
        fn, kind = cases[name]
        with mx.gpu(0):
            own = values(fn(npm, gpu_arrays))
        with mx.cpu():
            ref = values(fn(npm, cpu_arrays))
        for k, (o, r) in enumerate(zip(own, ref)):
            if not hasattr(r, "_data"):
                if not (o == r or (isinstance(r, float) and
                                   abs(o - r) <= 1e-5 * abs(r))):
                    mismatches.append("np (b) %s[%d]: %r vs %r"
                                      % (name, k, o, r))
                continue
            ot, rt = o._data, r._data
            if ot.device.type != dev.type or ot.dtype != rt.dtype or \
                    ot.shape != rt.shape:
                mismatches.append("np (b) %s[%d]: %s %s on %s, CPU %s %s"
                                  % (name, k, ot.dtype, tuple(ot.shape),
                                     ot.device, rt.dtype, tuple(rt.shape)))
                continue
            oc = ot.cpu()
            if not rt.is_floating_point() and not rt.is_complex():
                if not torch.equal(oc, rt):
                    mismatches.append("np (b) %s[%d]: differs (exact)"
                                      % (name, k))
                continue
            of, rf = oc.double(), rt.double()
            scale = rf[torch.isfinite(rf)].abs().max().item() \
                if bool(torch.isfinite(rf).any()) else 1.0
            tol = (1e-4 if kind == "loose" else rtol)
            bad = ~(((of - rf).abs() <= atol * scale + tol * rf.abs())
                    | (torch.isnan(of) & torch.isnan(rf))
                    | (of == rf))
            if bool(bad.any()):
                mismatches.append("np (b) %s[%d]: %d values off (rtol %g, "
                                  "atol %g of max)" % (name, k,
                                                       int(bad.sum()), tol,
                                                       atol))
    # the factor functions: reconstruction on the card, values to the CPU
    with mx.gpu(0):
        own = _np_factor_fns(torch, npm, host)
    with mx.cpu():
        ref = _np_factor_fns(torch, npm, host)
    for name, (vals, recon, inp) in own.items():
        if recon is not None and (recon - inp).abs().max().item() > \
                1e-4 * inp.abs().max().item():
            mismatches.append("np (b) %s: the factors do not reconstruct "
                              "the input" % name)
        rv = ref[name][0]
        if vals is not None and not torch.allclose(
                vals._data.cpu().double(), rv._data.double(), rtol=1e-4,
                atol=1e-5 * rv._data.abs().max().item()):
            mismatches.append("np (b) %s: values differ from the CPU's"
                              % name)
    factor_names = {"svd", "eigh", "qr", "cholesky", "eig", "eigvals",
                    "multi_dot"}
    with mx.gpu(0):
        md = npm.linalg.multi_dot([gpu_arrays["m"], gpu_arrays["m"],
                                   gpu_arrays["v"][:host["m"][0].shape[0]]])
    with mx.cpu():
        mdc = npm.linalg.multi_dot([cpu_arrays["m"], cpu_arrays["m"],
                                    cpu_arrays["v"][:host["m"][0].shape[0]]])
    if not torch.allclose(md._data.cpu(), mdc._data, rtol=1e-4, atol=1e-4):
        mismatches.append("np (b) linalg.multi_dot differs")
    # creation and the utilities on the card
    extra = _np_creation_and_utilities(torch, mx, npm, dev)
    mismatches += extra["mismatches"]
    random_out = _np_random_functions(args, torch, mx, npm, dev)
    mismatches += random_out["mismatches"]
    npx_out = _np_npx_functions(torch, mx, npm, npx, dev, cpu_arrays,
                                gpu_arrays)
    mismatches += npx_out["mismatches"]
    # every public callable of the four modules ran
    covered = set(cases) | {c.rsplit("_", 1)[0] for c in cases} | \
        set(extra["names"]) | {"linalg." + n for n in factor_names}
    public = {}
    for mod, prefix in ((npm, ""), (npm.linalg, "linalg."),
                        (npm.random, "random."), (npx, "npx.")):
        public.update({prefix + n: mod for n in dir(mod)
                       if not n.startswith("_") and
                       callable(getattr(mod, n)) and
                       not inspect.ismodule(getattr(mod, n)) and
                       not inspect.isclass(getattr(mod, n))})
    covered |= {"random." + n for n in random_out["names"]} | \
        {"npx." + n for n in npx_out["names"]}
    missing = sorted(set(public) - covered)
    if missing:
        mismatches.append("np (b): not run on the card: %s" % missing)
    return {"functions": len(public), "cases": len(cases) + len(own),
            "np_dtypes_equal": True}, mismatches


def _np_creation_and_utilities(torch, mx, npm, dev):
    """The creation functions' defaults on the card (dtype and values
    equal to the CPU's) and the utilities."""
    calls = {
        "ones": lambda: npm.ones(3), "zeros": lambda: npm.zeros((2,)),
        "empty": lambda: npm.empty(4), "full": lambda: npm.full(2, 1.5),
        "arange": lambda: npm.arange(0, 1, 0.125),
        "linspace": lambda: npm.linspace(0, 1, 5),
        "logspace": lambda: npm.logspace(0, 1, 5),
        "eye": lambda: npm.eye(3, 4, 1), "identity": lambda: npm.identity(2),
        "tri": lambda: npm.tri(3), "indices": lambda: npm.indices((2, 3)),
        "array": lambda: npm.array([1, 2]),
        "asarray": lambda: npm.asarray([1.5, 2.5]),
        "ascontiguousarray": lambda: npm.ascontiguousarray([1.5]),
        "hanning": lambda: npm.hanning(5), "hamming": lambda: npm.hamming(5),
        "blackman": lambda: npm.blackman(5),
        "bartlett": lambda: npm.bartlett(5),
        "kaiser": lambda: npm.kaiser(5, 2.0),
        "zeros_like": lambda: npm.zeros_like(npm.arange(3)),
        "ones_like": lambda: npm.ones_like(npm.arange(3)),
        "full_like": lambda: npm.full_like(npm.arange(3), 2.5),
        "fromfunction": lambda: npm.fromfunction(lambda i, j: i + j, (2, 2)),
        "frombuffer": lambda: npm.frombuffer(b"\x01\x02", dtype=np.uint8),
        "tril_indices": lambda: npm.tril_indices(3)[0],
        "triu_indices": lambda: npm.triu_indices(3)[1],
        "diag_indices": lambda: npm.diag_indices(3)[0],
    }
    mismatches = []
    for name, call in calls.items():
        with mx.gpu(0):
            o = call()
        with mx.cpu():
            r = call()
        if o._data.device.type != dev.type or o._data.dtype != \
                r._data.dtype or not torch.allclose(
                    o._data.cpu().double(), r._data.double()):
            mismatches.append("np (b) %s: %s on %s, CPU %s" % (
                name, o._data.dtype, o._data.device, r._data.dtype))
    with mx.gpu(0):
        a = npm.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        d = npm.zeros((2, 3), dtype="float32")
        npm.copyto(d, a)
        p = npm.zeros((2, 3), dtype="float32")
        npm.put_along_axis(p, npm.array(np.array([[0], [2]]), dtype="int64"),
                           npm.array(np.ones((2, 1), np.float32)), 1)
        ok = (npm.ndim(a) == 2 and npm.shape(a) == (2, 3) and
              npm.size(a) == 6 and npm.isscalar(1.0) and
              npm.allclose(a, d) and npm.array_equal(a, d) and
              not npm.may_share_memory(a, d) and
              not npm.shares_memory(a, d) and
              npm.result_type(a, d) == np.float32 and
              float(p.sum()) == 2.0 and
              d._data.device.type == dev.type and
              (npm.asnumpy(a) == np.arange(6).reshape(2, 3)).all())
        npm.set_printoptions(precision=4)
        g = npm.genfromtxt(__import__("io").StringIO("1 2\n3 4"))
        ok = ok and g._data.device.type == dev.type
    if not ok:
        mismatches.append("np (b): the utilities failed on the card")
    names = list(calls) + ["copyto", "put_along_axis", "ndim", "shape",
                           "size", "isscalar", "allclose", "array_equal",
                           "may_share_memory", "shares_memory",
                           "result_type", "asnumpy", "set_printoptions",
                           "genfromtxt", "current_context", "dtype_np"]
    return {"names": names, "mismatches": mismatches}


def _np_random_functions(args, torch, mx, npm, dev):
    """``np.random``'s functions on the card: the CPU draw's dtype and
    shape, and a seed repeats the card's draw (the moments are (f)'s)."""
    calls = {
        "uniform": lambda r: r.uniform(size=(64,)),
        "normal": lambda r: r.normal(size=(64,)),
        "randn": lambda r: r.randn(64), "rand": lambda r: r.rand(64),
        "randint": lambda r: r.randint(3, 9, size=(64,)),
        "choice": lambda r: r.choice(10, size=(64,)),
        "permutation": lambda r: r.permutation(64),
        "gamma": lambda r: r.gamma(2.0, size=(64,)),
        "beta": lambda r: r.beta(2.0, 3.0, size=(64,)),
        "exponential": lambda r: r.exponential(size=(64,)),
        "poisson": lambda r: r.poisson(3.0, size=(64,)),
        "multinomial": lambda r: r.multinomial(10, [0.5, 0.5], size=(8,)),
        "logistic": lambda r: r.logistic(size=(64,)),
        "gumbel": lambda r: r.gumbel(size=(64,)),
        "lognormal": lambda r: r.lognormal(size=(64,)),
    }
    mismatches = []
    for name, call in calls.items():
        with mx.gpu(0):
            npm.random.seed(args.seed)
            a = call(npm.random)
            npm.random.seed(args.seed)
            b = call(npm.random)
        with mx.cpu():
            c = call(npm.random)
        if a._data.device.type != dev.type or a._data.dtype != \
                c._data.dtype or a.shape != c.shape or \
                not torch.equal(a._data, b._data):
            mismatches.append("np (b) random.%s: %s on %s (CPU %s), seed "
                              "repeats %s" % (name, a._data.dtype,
                                              a._data.device, c._data.dtype,
                                              torch.equal(a._data,
                                                          b._data)))
    with mx.gpu(0):
        x = npm.arange(64)
        before = x._data
        npm.random.shuffle(x)
        if x._data is before or x._data.device.type != dev.type or \
                sorted(x.asnumpy().tolist()) != list(range(64)):
            mismatches.append("np (b) random.shuffle is not an in-place "
                              "permutation on the card")
    return {"names": list(calls) + ["seed", "shuffle", "dtype_np"],
            "mismatches": mismatches}


def _np_npx_functions(torch, mx, npm, npx, dev, cpu_arrays, gpu_arrays):
    """``mx.npx``'s functions on the card against the CPU (results are
    ``mx.np`` arrays of the CPU's dtype)."""
    import tempfile
    img = np.random.default_rng(5).standard_normal((2, 4, 8, 8)) \
        .astype(np.float32)

    def run(a):
        x = a["x"]
        im = npm.array(img)
        w = npm.array(np.full((3, 4, 3, 3), 0.1, np.float32))
        ch = npm.array(np.ones(4, np.float32))
        z = npm.array(np.zeros(4, np.float32))
        return {
            "softmax": npx.softmax(x), "log_softmax": npx.log_softmax(x),
            "relu": npx.relu(x), "sigmoid": npx.sigmoid(x),
            "batch_norm": npx.batch_norm(im, ch, z, z, ch),
            "convolution": npx.convolution(im, w, None, kernel=(3, 3),
                                           num_filter=3, no_bias=True),
            "fully_connected": npx.fully_connected(x, a["y"], None,
                                                   num_hidden=x.shape[0],
                                                   no_bias=True),
            "pooling": npx.pooling(im, kernel=(2, 2), stride=(2, 2)),
            "one_hot": npx.one_hot(a["i"], 6),
            "pick": npx.pick(x, a["i"][:x.shape[0]] % x.shape[1]),
            "reshape_like": npx.reshape_like(a["t"], a["t"].T),
            "topk": npx.topk(x, k=3),
            "bernoulli": npx.bernoulli(prob=0.5, size=(4,)).shape,
            "_npx_relu": npx._npx_relu(x),
        }
    mismatches = []
    with mx.gpu(0):
        own = run(gpu_arrays)
    with mx.cpu():
        ref = run(cpu_arrays)
    for name, o in own.items():
        r = ref[name]
        if isinstance(r, tuple):
            if o != r:
                mismatches.append("npx.%s shape %s vs %s" % (name, o, r))
            continue
        if not isinstance(o, npm.ndarray) or o._data.device.type != \
                dev.type or o._data.dtype != r._data.dtype or \
                not torch.allclose(o._data.cpu().double(),
                                   r._data.double(), rtol=1e-5, atol=1e-5):
            mismatches.append("np (b) npx.%s differs from the CPU's" % name)
    with mx.gpu(0), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "np.params")
        npx.save(path, {"x": gpu_arrays["x"]})
        back = npx.load(path)["x"]
        npx.waitall()
        if not isinstance(back, npm.ndarray) or \
                back._data.device.type != dev.type or \
                not torch.equal(back._data, gpu_arrays["x"]._data):
            mismatches.append("np (b) npx.save/load did not round-trip on "
                              "the card")
        npx.seed(3)
        npx.set_np()
        flags = npx.is_np_array() and npx.is_np_shape()
        npx.reset_np()
        flags = flags and not npx.is_np_array() and \
            npx.use_np(len) is len and npx.use_np_shape(len) is len and \
            npx.use_np_array(len) is len
        if not flags:
            mismatches.append("np (b) npx flags")
    return {"names": list(own) + ["save", "load", "waitall", "seed",
                                  "set_np", "reset_np", "is_np_array",
                                  "is_np_shape", "use_np", "use_np_shape",
                                  "use_np_array"],
            "mismatches": mismatches}


def _np_mlm(torch, mx, npm, npx, nd, autograd, dev, seed):
    """(c) The MLM loss of BERT-base's pretraining head at full width:
    hidden (1280, 768) = 64 x 20 masked positions, ``np.dot`` with the
    (30522, 768) embedding's transpose, ``npx.log_softmax``, ``npx.pick``
    of the labels and ``np.mean``, backward under ``autograd.record``;
    held bitwise to the same expression in ``nd`` ops on the card, and to
    the CPU within NP_MLM_TOL of each output's max."""
    rng = np.random.default_rng(seed + 81)
    h = rng.standard_normal((NP_MLM_ROWS, 768)).astype(np.float32)
    emb = (0.02 * rng.standard_normal((BERT_VOCAB, 768))).astype(np.float32)
    lab = rng.integers(0, BERT_VOCAB, NP_MLM_ROWS).astype(np.float32)

    def run(mod, ctx, use_np):
        with ctx:
            hh, ee, ll = mod.array(h), mod.array(emb), mod.array(lab)
            hh.attach_grad()
            ee.attach_grad()
            with autograd.record():
                if use_np:
                    logp = npx.log_softmax(npm.dot(hh, ee.T))
                    loss = -npm.mean(npx.pick(logp, ll))
                else:
                    logp = nd.log_softmax(nd.dot(hh, ee, transpose_b=True))
                    loss = -nd.mean(nd.pick(logp, ll))
            loss.backward()
            return [loss._data.detach(), hh.grad._data, ee.grad._data]
    card_np = run(npm, mx.gpu(0), True)
    card_nd = run(nd, mx.gpu(0), False)
    bitwise = all(torch.equal(a, b) for a, b in zip(card_np, card_nd))
    if not bitwise:
        fail("np (c): the mx.np MLM loss or gradients differ from nd's on "
             "the card")
    cpu_np = run(npm, mx.cpu(), True)
    errs = [rel_to_max(a.cpu(), b) for a, b in zip(card_np, cpu_np)]
    if not max(errs) <= NP_MLM_TOL:
        fail("np (c): the card's MLM loss/gradients are %s of max from the "
             "CPU's (tolerance %g)" % (errs, NP_MLM_TOL))
    if card_np[0].device.type != dev.type:
        fail("np (c): the loss is not on the card")
    return {"loss": float(card_np[0]), "np_equals_nd_bitwise": bitwise,
            "card_vs_cpu_rel_to_max": errs}


def _np_updates(args, torch, mx, nd, dev):
    """(d) The update ops over BERT-base's parameters (from ``Xavier()``
    as the ops phase's (f) builds them; seeded gradients and states):
    ``sgd_mom_update``, ``adam_update`` and ``adamw_update`` once per
    array; ``multi_sgd_mom_update``, ``multi_mp_sgd_mom_update`` (bf16
    weights, fp32 masters) and ``preloaded_multi_sgd_mom_update`` in one
    call each; ``multi_lars`` over ``multi_sum_sq``. Each is held to the
    CPU; each pass is timed with CUDA events beside ``optimizer.Adam``
    through ``gluon.Trainer`` on the same parameters."""
    from mxnet_tpu_torch import gluon, initializer
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon import collect_params
    from mxnet_tpu_torch.models import bert_base
    model = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                      device=dev)
    params = collect_params(model)
    trandom.seed(args.seed)
    params.initialize(initializer.Xavier())
    plist = [params[k] for k in sorted(params)]
    ws = [p.tensor() for p in plist]
    n_values = sum(w.numel() for w in ws)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 91)
    gs = [torch.randn(w.shape, generator=gen, device=dev) * 1e-3
          for w in ws]
    ms = [torch.randn(w.shape, generator=gen, device=dev) * 1e-4
          for w in ws]
    vs = [torch.rand(w.shape, generator=gen, device=dev) * 1e-6
          for w in ws]
    W = [nd.NDArray(w.detach()) for w in ws]
    G, M, V = ([nd.NDArray(t) for t in ts] for ts in (gs, ms, vs))
    cpu = mx.cpu()
    Wc, Gc, Mc, Vc = ([x.as_in_context(cpu) for x in xs]
                      for xs in (W, G, M, V))
    scale = nd.array(np.array(1.0, np.float32), ctx=mx.gpu(0))
    hyper = dict(NP_ADAM)
    mism, ms_out = [], {}

    def check(what, own, ref):
        try:
            _np_compare(torch, "update", own, ref, what, dev)
        except _OpsMismatch as e:
            mism.append(str(e))

    def per_array(fn, arrays, **kw):
        return [fn(*a, **kw) for a in zip(*arrays)]
    sgd_kw = {"lr": 0.01, "momentum": 0.9, "wd": 0.01}
    passes = {
        "sgd_mom_update": (nd.sgd_mom_update, (W, G, M), (Wc, Gc, Mc),
                           sgd_kw),
        "adam_update": (nd.adam_update, (W, G, M, V), (Wc, Gc, Mc, Vc),
                        hyper),
        "adamw_update": (nd.adamw_update, (W, G, M, V, [scale] * len(W)),
                         (Wc, Gc, Mc, Vc, [scale.as_in_context(cpu)]
                          * len(W)), {"lr": 1e-4, "wd": 0.01}),
    }
    for name, (fn, own_in, cpu_in, kw) in passes.items():
        own = per_array(fn, own_in, **kw)
        ref = per_array(fn, cpu_in, **kw)
        for i in range(len(own)):
            check("(d) %s[%d]" % (name, i), own[i], ref[i])
        del own, ref
        ms_out[name] = time_ms(torch, lambda: per_array(fn, own_in, **kw),
                               NP_UPDATE_ITERS)
    flat = [x for grp in zip(W, G, M) for x in grp]
    flat_c = [x for grp in zip(Wc, Gc, Mc) for x in grp]
    lrs = [0.01] * len(W)
    wds = [0.01] * len(W)
    kw = {"lrs": lrs, "wds": wds, "momentum": 0.9, "num_weights": len(W)}
    own = nd.multi_sgd_mom_update(*flat, **kw)
    ref = nd.multi_sgd_mom_update(*flat_c, **kw)
    check("(d) multi_sgd_mom_update", own, ref)
    ms_out["multi_sgd_mom_update"] = time_ms(
        torch, lambda: nd.multi_sgd_mom_update(*flat, **kw),
        NP_UPDATE_ITERS)
    del own, ref
    Wb = [nd.NDArray(w._data.bfloat16()) for w in W]
    Gb = [nd.NDArray(g._data.bfloat16()) for g in G]
    W32 = [nd.NDArray(w._data.clone()) for w in W]
    flat_mp = [x for grp in zip(Wb, Gb, M, W32) for x in grp]
    flat_mpc = [x.as_in_context(cpu) for x in flat_mp]
    own = nd.multi_mp_sgd_mom_update(*flat_mp, **kw)
    ref = nd.multi_mp_sgd_mom_update(*flat_mpc, **kw)
    check("(d) multi_mp_sgd_mom_update", own, ref)
    ms_out["multi_mp_sgd_mom_update"] = time_ms(
        torch, lambda: nd.multi_mp_sgd_mom_update(*flat_mp, **kw),
        NP_UPDATE_ITERS)
    del own, ref, flat_mpc
    lr_t = nd.array(np.full(len(W), 0.01, np.float32), ctx=mx.gpu(0))
    wd_t = nd.array(np.full(len(W), 0.01, np.float32), ctx=mx.gpu(0))
    pre_kw = {"num_weights": len(W)}
    own = nd.preloaded_multi_sgd_mom_update(*flat, lr_t, wd_t, **pre_kw)
    ref = nd.preloaded_multi_sgd_mom_update(
        *flat_c, lr_t.as_in_context(cpu), wd_t.as_in_context(cpu), **pre_kw)
    check("(d) preloaded_multi_sgd_mom_update", own, ref)
    ms_out["preloaded_multi_sgd_mom_update"] = time_ms(
        torch, lambda: nd.preloaded_multi_sgd_mom_update(
            *flat, lr_t, wd_t, **pre_kw), NP_UPDATE_ITERS)
    del own, ref
    wsq = nd.stack(*nd.multi_sum_sq(*W, num_arrays=len(W)))
    gsq = nd.stack(*nd.multi_sum_sq(*G, num_arrays=len(G)))
    lars = nd.multi_lars(lr_t, wsq, gsq, wd_t, eta=0.001)
    lars_c = nd.multi_lars(lr_t.as_in_context(cpu), wsq.as_in_context(cpu),
                           gsq.as_in_context(cpu), wd_t.as_in_context(cpu),
                           eta=0.001)
    check("(d) multi_lars", lars, lars_c)
    del flat, flat_c, Wc, Gc, Mc, Vc
    # gluon.Trainer's Adam on the same parameters
    for p, g in zip(plist, gs):
        p.tensor().grad = g.clone()
    tr = gluon.Trainer(params, "adam", {"learning_rate": 1e-4, "wd": 0.01})
    tr.step(1)
    ms_out["trainer_adam"] = time_ms(torch, lambda: tr.step(1),
                                     NP_UPDATE_ITERS)
    adam_bytes = 7 * 4 * n_values          # w, g, m, v read; w, m, v written
    del model, params, plist, tr, W, G, M, V, Wb, Gb, W32
    torch.cuda.empty_cache()
    if mism:
        fail("np (d): %s" % "; ".join(mism))
    return {"arrays": len(ws), "values": n_values, "ms": ms_out,
            "adam_bound_ms": adam_bytes / PEAK_BYTES * 1e3,
            "adam_bytes": adam_bytes}


def _np_preprocess(nd, x, ctx):
    """ImageNet preprocessing: resize to NP_CROP, to_tensor, normalize."""
    with ctx:
        r = nd._image_resize(x, size=NP_CROP)
        return r, nd._image_normalize(nd._image_to_tensor(r), mean=NP_MEAN,
                                      std=NP_STD)


def _np_images(args, torch, mx, nd, dev):
    """(e) 32 seeded uint8 images of 256 x 256 x 3 resized, made tensors
    and normalized on the card and on the CPU, then fed through one
    ``resnet50_v1()`` (``Xavier()``, bf16, as the vision phase builds it)
    on the card: logits held to the CPU-preprocessed batch's within
    NP_LOGIT_TOL of their max; the random image ops at that shape, which a
    seed repeats."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as trandom
    imgs = np.random.default_rng(args.seed + 101).integers(
        0, 256, NP_IMAGES).astype(np.uint8)
    xg = nd.array(imgs, ctx=mx.gpu(0), dtype="uint8")
    xc = nd.array(imgs, ctx=mx.cpu(), dtype="uint8")
    rg, ng = _np_preprocess(nd, xg, mx.gpu(0))
    rc, nc = _np_preprocess(nd, xc, mx.cpu())
    if ng._data.device.type != dev.type or ng.shape != (
            NP_IMAGES[0], 3, NP_CROP, NP_CROP):
        fail("np (e): the preprocessed batch is %s on %s" % (
            ng.shape, ng._data.device))
    diff = (rg._data.cpu().int() - rc._data.int()).abs()
    if int(diff.max()) > 1:
        fail("np (e): the card's resize is %d levels from the CPU's"
             % int(diff.max()))
    pre_ms = time_ms(torch, lambda: _np_preprocess(nd, xg, mx.gpu(0)), 10)
    net = _resnet50(torch, trandom, args.seed)
    net.cast("bfloat16")
    with autograd.predict_mode(), torch.no_grad():
        lg = net(nd.NDArray(ng._data.bfloat16()))._data.float()
        lc = net(nd.NDArray(nc._data.to(dev).bfloat16()))._data.float()
    err = rel_to_max(lg, lc)
    if not (err <= NP_LOGIT_TOL and bool(torch.isfinite(lg).all())):
        fail("np (e): logits of the card-preprocessed batch %.3g of max "
             "from the CPU-preprocessed one's (tolerance %g)"
             % (err, NP_LOGIT_TOL))
    rand = {}
    for name in ("_image_random_flip_left_right",
                 "_image_random_flip_top_bottom", "_image_random_brightness",
                 "_image_random_contrast", "_image_random_saturation",
                 "_image_random_hue", "_image_random_lighting",
                 "_image_random_color_jitter"):
        kw = NP_RANDOM_OPS[name][1]
        outs = []
        for _ in range(2):
            mx.random.seed(args.seed)
            with mx.gpu(0):
                outs.append(getattr(nd, name)(xg, **kw)._data)
        if outs[0].device.type != dev.type or \
                not torch.equal(outs[0], outs[1]):
            fail("np (e) %s: a seed does not repeat it on the card" % name)
        rand[name] = str(outs[0].dtype).replace("torch.", "")
    del net, xg, rg, ng, lg, lc
    torch.cuda.empty_cache()
    return {"preprocess_ms": pre_ms, "logits_rel_to_max": err,
            "resize_pixels_off_by_one": int((diff > 0).sum()),
            "resize_values": int(diff.numel()), "random_ops": rand}


def _np_samplers(args, torch, mx, npm, dev):
    """(f) ``np.random``'s samplers at NP_DRAWS on the card: mean and
    variance within bounds of the theory (``tests/test_random_stats.py``'s
    kind), and a seed repeats the draw."""
    draws = {
        "uniform": (lambda r: r.uniform(-2.0, 4.0, size=NP_DRAWS), 1.0, 3.0,
                    (0.02, 0.05)),
        "normal": (lambda r: r.normal(1.5, 2.0, size=NP_DRAWS), 1.5, 4.0,
                   (0.02, 0.08)),
        "randn": (lambda r: r.randn(*NP_DRAWS), 0.0, 1.0, (0.02, 0.02)),
        "randint": (lambda r: r.randint(3, 9, size=NP_DRAWS), 5.5, 35 / 12,
                    (0.02, 0.05)),
        "gamma": (lambda r: r.gamma(3.0, 2.0, size=NP_DRAWS), 6.0, 12.0,
                  (0.06, 0.4)),
        "beta": (lambda r: r.beta(2.0, 3.0, size=NP_DRAWS), 0.4, 0.04,
                 (0.005, 0.002)),
        "exponential": (lambda r: r.exponential(2.5, size=NP_DRAWS), 2.5,
                        6.25, (0.03, 0.15)),
        "poisson": (lambda r: r.poisson(4.0, size=NP_DRAWS), 4.0, 4.0,
                    (0.04, 0.15)),
        "logistic": (lambda r: r.logistic(1.0, 2.0, size=NP_DRAWS), 1.0,
                     4 * np.pi ** 2 / 3, (0.04, 0.4)),
        "gumbel": (lambda r: r.gumbel(0.5, 1.0, size=NP_DRAWS),
                   0.5 + np.euler_gamma, np.pi ** 2 / 6, (0.02, 0.05)),
        "lognormal": (lambda r: r.lognormal(0.0, 0.5, size=NP_DRAWS),
                      np.exp(0.125), (np.exp(0.25) - 1) * np.exp(0.25),
                      (0.01, 0.02)),
        "choice": (lambda r: r.choice(10, size=NP_DRAWS), 4.5, 8.25,
                   (0.03, 0.1)),
    }
    out = {}
    with mx.gpu(0):
        for name, (draw, mean, var, (bm, bv)) in draws.items():
            npm.random.seed(args.seed)
            got = draw(npm.random)
            if got._data.device.type != dev.type:
                fail("np (f) %s drew on %s" % (name, got._data.device))
            a = got._data.double()
            m, v = a.mean().item(), a.var(unbiased=False).item()
            if not (abs(m - mean) < bm and abs(v - var) < bv):
                fail("np (f) %s: mean %g var %g, theory %g %g (bounds %g "
                     "%g)" % (name, m, v, mean, var, bm, bv))
            npm.random.seed(args.seed)
            if not torch.equal(draw(npm.random)._data, got._data):
                fail("np (f) %s: a seed does not repeat the draw" % name)
            out[name] = (m, v)
            del got, a
    return out


def np_phase(args, torch):
    """The numpy frontends and the second part of the op corpus on the
    card, parts (a)-(f) (see the module docstring)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch import numpy as npm
    from mxnet_tpu_torch import numpy_extension as npx
    t0 = time.perf_counter()
    fa0 = kernel_launches()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out, mismatches = {}, []
    ta = time.perf_counter()
    out["a"], mism = _np_part_a(args, torch, mx, nd, dev, cpu)
    mismatches += mism
    out["a"]["wall_s"] = time.perf_counter() - ta
    tb = time.perf_counter()
    out["b"], mism = _np_part_b(args, torch, mx, dev, cpu)
    mismatches += mism
    out["b"]["wall_s"] = time.perf_counter() - tb
    torch.cuda.empty_cache()
    if mismatches:
        fail("np: %d cases differ from the CPU: %s"
             % (len(mismatches), "; ".join(mismatches)))
    out["c"] = _np_mlm(torch, mx, npm, npx, nd, autograd, dev, args.seed)
    torch.cuda.empty_cache()
    out["d"] = _np_updates(args, torch, mx, nd, dev)
    out["e"] = _np_images(args, torch, mx, nd, dev)
    out["f"] = _np_samplers(args, torch, mx, npm, dev)
    out["launches"] = {k: v - fa0[k] for k, v in kernel_launches().items()}
    if any(out["launches"].values()):
        fail("np: a flash kernel launched %s" % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_np(res, card):
    """The np phase's lines of the output."""
    a, b, c, d, e = res["a"], res["b"], res["c"], res["d"], res["e"]
    print("np (a): %d new registry names through nd.<name> on gpu(0) == the "
          "CPU (exact, or the ops phase's tolerances; updates rtol %g atol "
          "%g, bf16 one ulp; factors by reconstruction and vectors within "
          "%g where the gap is %g of max: %s; SPD and LQ batches of 64, "
          "the CPU's first %d); resize uint8 %d of %d values one level "
          "off; %.1f s"
          % (a["names"], NP_UPDATE_TOL[0], NP_UPDATE_TOL[1], NP_VECTOR_TOL,
             NP_GAP, a["vectors_compared"], NP_CPU_SLICE,
             a["resize_pixels_off_by_one"], a["resize_values"],
             a["wall_s"]), flush=True)
    print("np (b): %d public callables of mx.np, np.linalg, np.random and "
          "mx.npx on gpu(0), dtypes equal to the CPU's, values within rtol "
          "%g atol %g of max (1e-4 where loose); %.1f s"
          % (b["functions"], NP_TOL[0], NP_TOL[1], b["wall_s"]), flush=True)
    print("np (c): BERT-base MLM loss (%d x 768 hidden, vocab %d) through "
          "mx.np under autograd.record: loss %.5f, == nd ops bitwise, card "
          "vs CPU %s of max (tol %g)"
          % (NP_MLM_ROWS, BERT_VOCAB, c["loss"], ", ".join(
              "%.2g" % v for v in c["card_vs_cpu_rel_to_max"]), NP_MLM_TOL),
          flush=True)
    print("np (d): update ops over BERT-base (%d arrays, %d values), held "
          "to the CPU; ms a pass: %s; gluon.Trainer Adam %.3f ms; Adam's "
          "bytes bound %.3f ms (%d bytes at 3.35 TB/s) [%s]"
          % (d["arrays"], d["values"], ", ".join(
              "%s %.3f" % kv for kv in d["ms"].items()
              if kv[0] != "trainer_adam"), d["ms"]["trainer_adam"],
             d["adam_bound_ms"], d["adam_bytes"], card), flush=True)
    print("np (e): %s uint8 -> resize %d, to_tensor, normalize on gpu(0) "
          "%.3f ms; resize %d of %d values one level off the CPU's; "
          "resnet50_v1 bf16 logits vs the CPU-preprocessed batch %.3g of "
          "max (tol %g); random image ops repeat under a seed %s [%s]"
          % ("x".join(map(str, NP_IMAGES)), NP_CROP, e["preprocess_ms"],
             e["resize_pixels_off_by_one"],
             e["resize_values"], e["logits_rel_to_max"], NP_LOGIT_TOL,
             e["random_ops"], card), flush=True)
    print("np (f): np.random at %s on gpu(0), moments within bounds and "
          "seeded: %s; flash launches %s; %.1f s"
          % ("x".join(map(str, NP_DRAWS)), ", ".join(
              "%s %.4g/%.4g" % (k, m, v) for k, (m, v) in res["f"].items()),
             res["launches"], res["wall_s"]), flush=True)



# ---- the detection phase: item 8 steps 1-4 on the card ---------------------
# (b) SSD300 (MXNet 1.6's example/ssd, VGG16-reduced 300 on VOC): the six
# maps, their sizes, ratios and steps (symbol/symbol_factory.py), 4, 6, 6,
# 6, 4, 4 anchors a position: 8732; up to 20 ground-truth boxes an image
DET_SSD_MAPS = (38, 19, 10, 5, 3, 1)
DET_SSD_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                 (0.71, 0.79), (0.88, 0.961))
DET_SSD_RATIOS = ((1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3),
                  (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5, 3, 1.0 / 3),
                  (1, 2, 0.5), (1, 2, 0.5))
DET_SSD_STEPS = tuple(x / 300.0 for x in (8, 16, 32, 64, 100, 300))
DET_BATCH, DET_CLASSES, DET_GT, DET_ANCHORS = 32, 21, 20, 8732
DET_NMS, DET_TOPK, DET_NEG_RATIO = 0.45, 400, 3.0
# (c) Faster R-CNN C4 at 600x1000: stride 16, a 38x63 map; Proposal at the
# op's defaults (12 anchors, pre-NMS 6000, post-NMS 300, threshold 0.7);
# ROIAlign 14x14 over 1024 channels; R-FCN's PSROIPooling (21 x 7 x 7 =
# 1029 channels); one 3x3 DeformableConvolution, dilation 2, 512 channels
DET_IMAGE, DET_STRIDE, DET_MAP = (600, 1000), 16, (38, 63)
DET_C4, DET_POOL, DET_PS, DET_DCN = 1024, 14, (21, 7), 512
# (a) the control flow: foreach over an LSTM cell at the LSTM LM's width;
# the CPU recomputes the first DET_CPU_ROWS rows (rows are independent)
DET_LSTM = (35, 128, 1500)
DET_CPU_ROWS = 8
DET_TOL = 1e-5             # float ops: of the output's largest |value|
DET_CALLS = 10             # calls timed a side
DET_NEW_NAMES = """
AdaptiveAvgPooling2D BilinearResize2D BilinearSampler CTCLoss CTCLoss_op
Correlation Crop DeformableConvolution DeformablePSROIPooling GridGenerator
IdentityAttachKLSparseReg ModulatedDeformableConvolution MultiBoxDetection
MultiBoxPrior MultiBoxTarget MultiProposal PSROIPooling Proposal ROIAlign
ROIPooling RROIAlign SVMOutput SpatialTransformer SyncBatchNorm _cond
_contrib_AdaptiveAvgPooling2D _contrib_BilinearResize2D _contrib_CTCLoss
_contrib_DeformableConvolution _contrib_DeformablePSROIPooling
_contrib_ModulatedDeformableConvolution _contrib_MultiBoxDetection
_contrib_MultiBoxPrior _contrib_MultiBoxTarget _contrib_MultiProposal
_contrib_PSROIPooling _contrib_Proposal _contrib_ROIAlign _contrib_RROIAlign
_contrib_SyncBatchNorm _contrib_allclose _contrib_arange_like
_contrib_arena_slice _contrib_arena_update _contrib_bipartite_matching
_contrib_boolean_mask _contrib_box_decode _contrib_box_encode
_contrib_box_iou _contrib_box_nms _contrib_box_non_maximum_suppression
_contrib_count_sketch _contrib_ctc_loss _contrib_div_sqrt_dim _contrib_fft
_contrib_generation_sample _contrib_gradientmultiplier
_contrib_group_adagrad_update _contrib_hawkesll _contrib_ifft
_contrib_index_array _contrib_index_copy
_contrib_interleaved_matmul_encdec_qk
_contrib_interleaved_matmul_encdec_valatt
_contrib_interleaved_matmul_selfatt_qk
_contrib_interleaved_matmul_selfatt_valatt _contrib_kv_cache_update
_contrib_moe_ffn _contrib_mrcnn_mask_target _contrib_quadratic
_contrib_round_ste _contrib_sample_greedy _contrib_sample_temperature
_contrib_sample_top_k _contrib_sign_ste _ctc_loss _foreach _npi_boolean_mask
_npx_multibox_detection _npx_multibox_prior _npx_multibox_target
_npx_roi_pooling _npx_smooth_l1 _scatter_elemwise_div _scatter_minus_scalar
_scatter_plus_scalar _while_loop adaptive_avg_pool2d allclose arena_slice
arena_update bilinear_resize_2d bilinear_sampler bipartite_matching
boolean_mask box_decode box_encode box_iou box_nms correlation count_sketch
crop_v1 ctc_loss fft generation_sample gradientmultiplier grid_generator
group_adagrad_update hawkesll ifft index_array index_copy
interleaved_matmul_encdec_qk interleaved_matmul_encdec_valatt
interleaved_matmul_selfatt_qk interleaved_matmul_selfatt_valatt
kv_cache_update moe_ffn mrcnn_mask_target multibox_prior quadratic roi_align
round_ste sample_greedy sample_temperature sample_top_k sign_ste smooth_l1
spatial_transformer svm_output
""".split()


def _det_softmax(z, axis):
    e = np.exp(z - z.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _det_gt(rng, n_img):
    """Up to DET_GT ground-truth rows ``[cls, x1, y1, x2, y2]`` an image
    (the rest -1), classes 0..19, boxes in the unit square."""
    lab = np.full((n_img, DET_GT, 5), -1.0, np.float32)
    for b in range(n_img):
        k = int(rng.integers(1, DET_GT + 1))
        c = rng.uniform(0.1, 0.9, (k, 2))
        wh = rng.uniform(0.05, 0.5, (k, 2))
        lab[b, :k, 0] = rng.integers(0, DET_CLASSES - 1, k)
        lab[b, :k, 1:3] = np.clip(c - wh / 2, 0, 1)
        lab[b, :k, 3:5] = np.clip(c + wh / 2, 0, 1)
    return lab


def _det_arrays(seed):
    """The phase's inputs (numpy, from ``seed``), at the widths of (b) and
    (c); the rois and anchors come from the card's own ops (see
    :func:`_det_derived`)."""
    rng = np.random.default_rng(seed + 16)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    H, W = DET_MAP
    a = {"cls_preds": f(DET_BATCH, DET_CLASSES, DET_ANCHORS),
         "loc_preds": f(DET_BATCH, DET_ANCHORS * 4, scale=0.5),
         "labels": _det_gt(rng, DET_BATCH),
         "rpn_prob": rng.uniform(0, 1, (1, 24, H, W)).astype(np.float32),
         "rpn_deltas": f(1, 48, H, W, scale=0.2),
         "im_info": np.array([[DET_IMAGE[0], DET_IMAGE[1], 1.0]],
                             np.float32),
         "c4": f(1, DET_C4, H, W),
         "ps": f(1, DET_PS[0] * DET_PS[1] ** 2, H, W),
         "dcn": f(1, DET_DCN, H, W),
         "dcn_off": f(1, 18, H, W),
         "dcn_w": f(DET_DCN, DET_DCN, 3, 3, scale=0.02),
         "dcn_b": f(DET_DCN, scale=0.1),
         "mdcn_mask": rng.uniform(0, 1, (1, 9, H, W)).astype(np.float32),
         "ps_trans": f(300, 2, DET_PS[1], DET_PS[1], scale=0.1),
         "masks": (rng.uniform(0, 1, (1, DET_GT, 150, 250)) > 0.5).astype(
             np.float32),
         "matches": rng.integers(0, DET_GT, (1, 300)).astype(np.float32),
         "mask_cls": rng.integers(0, DET_CLASSES, (1, 300)).astype(
             np.float32),
         "images": f(DET_BATCH, 3, 300, 300),
         "theta": (np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                           (DET_BATCH, 1)) + f(DET_BATCH, 6, scale=0.1)),
         "flow": f(DET_BATCH, 2, 38, 38, scale=2.0),
         "corr": f(2, 1, 256, H, W),
         "signal": f(DET_BATCH, 1024),
         "sketch_h": rng.integers(0, 256, 1024).astype(np.float32),
         "sketch_s": np.sign(f(1024)).astype(np.float32),
         "bn": f(DET_BATCH, 256, 38, 38, scale=2.0),
         "bn_params": f(4, 256),
         "logits": f(DET_BATCH, 32000),
         "arena": f(2, 8, 128, 12, 64),
         "block": f(2, 1, 16, 12, 64),
         "qkv": f(128, DET_BATCH, 3 * 768),
         "att": _det_softmax(f(DET_BATCH * 12, 128, 128), -1),
         "ctc": f(35, DET_BATCH, DET_CLASSES),
         "ctc_labels": rng.integers(0, DET_CLASSES - 1, (DET_BATCH, 10))
         .astype(np.float32),
         "hawkes_lags": rng.uniform(0.1, 1.0, (DET_BATCH, 35)).astype(
             np.float32),
         "hawkes_marks": rng.integers(0, 4, (DET_BATCH, 35)).astype(
             np.float32),
         "moe": f(2, 128, 768),
         "moe_gate": f(768, 4, scale=0.05),
         "moe_w1": f(4, 768, 3072, scale=0.02),
         "moe_w2": f(4, 3072, 768, scale=0.02),
         "lstm_x": f(*DET_LSTM),
         "lstm_wi": f(4 * DET_LSTM[2], DET_LSTM[2], scale=0.02),
         "lstm_wh": f(4 * DET_LSTM[2], DET_LSTM[2], scale=0.02),
         "lstm_b": f(4 * DET_LSTM[2], scale=0.02)}
    a["cls_prob"] = _det_softmax(a["cls_preds"], 1)
    a["svm_labels"] = rng.integers(0, DET_CLASSES, DET_BATCH * 64).astype(
        np.float32)
    return a


def _det_anchors(nd, dev):
    """SSD300's anchors: MultiBoxPrior over the six maps, concatenated."""
    parts = []
    for s, sizes, ratios, step in zip(DET_SSD_MAPS, DET_SSD_SIZES,
                                      DET_SSD_RATIOS, DET_SSD_STEPS):
        feat = nd.NDArray(_det_zeros(dev, (1, 1, s, s)))
        parts.append(nd.MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                      steps=(step, step)))
    return nd.concat(*parts, dim=1)


def _det_zeros(dev, shape):
    import torch
    return torch.zeros(shape, device=dev)


def _det_cases(a):
    """``{canonical op: (args, kwargs, family)}``; an ``args`` entry is a
    key of the arrays (``"@key"``) or a Python value. Families: ``exact``
    (bitwise, NaN as NaN), ``float`` (DET_TOL of max), ``draw`` (a
    sampler: dtype, shape and range), ``mbt`` (float, the class targets
    exact), ``nms`` (rows kept on both sides within DET_TOL; rows kept on
    one side only are counted: the decode differs by an ulp, see
    :func:`_det_nms_explained`)."""
    s16 = 1.0 / DET_STRIDE
    ssd = {"sizes": DET_SSD_SIZES[0], "ratios": DET_SSD_RATIOS[0],
           "steps": (DET_SSD_STEPS[0],) * 2}
    return {
        "_contrib_sample_greedy": (["@logits"], {}, "exact"),
        "_contrib_sample_temperature": (["@logits", (3, 5)],
                                        {"temperature": 0.8}, "draw"),
        "_contrib_sample_top_k": (["@logits", (3, 5)], {"k": 1}, "exact"),
        "_contrib_generation_sample": (["@logits", (3, 5), "@zeros32"],
                                       {"k": 40}, "exact"),
        "_contrib_kv_cache_update": (["@arena0", "@block0", "@positions"],
                                     {}, "exact"),
        "_contrib_arena_slice": (["@arena", 40], {"size": 16, "axis": 2},
                                 "exact"),
        "_contrib_arena_update": (["@arena", "@block", 40], {"axis": 2},
                                  "exact"),
        "_ctc_loss": (["@ctc", "@ctc_labels"], {}, "float"),
        "_contrib_interleaved_matmul_selfatt_qk": (["@qkv"], {"heads": 12},
                                                   "float"),
        "_contrib_interleaved_matmul_selfatt_valatt": (
            ["@qkv", "@att"], {"heads": 12}, "float"),
        "_contrib_interleaved_matmul_encdec_qk": (
            ["@q", "@kv"], {"heads": 12}, "float"),
        "_contrib_interleaved_matmul_encdec_valatt": (
            ["@kv", "@att"], {"heads": 12}, "float"),
        "_contrib_arange_like": (["@cls_preds"], {"start": 1.0, "step": 0.5,
                                                  "axis": 2}, "exact"),
        "_contrib_div_sqrt_dim": (["@qkv"], {}, "float"),
        "smooth_l1": (["@loc_preds"], {"scalar": 1.0}, "float"),
        "_contrib_quadratic": (["@loc_preds"], {"a": 0.5, "b": -1.0,
                                                "c": 0.25}, "float"),
        "_contrib_index_copy": (["@c4_rows", "@row_index", "@c4_new"], {},
                                "exact"),
        "_contrib_index_array": (["@cls_preds"], {"axes": (0, 2)}, "exact"),
        "_contrib_group_adagrad_update": (["@dcn_w2", "@dcn_g2", "@hist"],
                                          {"lr": 0.01, "clip_gradient": 1.0},
                                          "float"),
        "_contrib_hawkesll": (["@hawkes_lda", "@hawkes_alpha",
                               "@hawkes_beta", "@hawkes_state",
                               "@hawkes_lags", "@hawkes_marks",
                               "@hawkes_valid", "@hawkes_time"], {},
                              "float"),
        "_contrib_moe_ffn": (["@moe", "@moe_gate", "@moe_w1", "@moe_w2"],
                             {}, "float"),
        "_contrib_round_ste": (["@loc_preds"], {}, "exact"),
        "_contrib_sign_ste": (["@loc_preds"], {}, "exact"),
        "_contrib_gradientmultiplier": (["@loc_preds"], {"scalar": -0.1},
                                        "exact"),
        "_scatter_plus_scalar": (["@loc_preds"], {"scalar": 0.5}, "exact"),
        "_scatter_minus_scalar": (["@loc_preds"], {"scalar": 0.5}, "exact"),
        "_scatter_elemwise_div": (["@loc_preds", "@loc_pos"], {}, "exact"),
        "ROIPooling": (["@c4", "@rois32"], {"pooled_size": (7, 7),
                                          "spatial_scale": s16}, "exact"),
        "IdentityAttachKLSparseReg": (["@c4"], {}, "exact"),
        "GridGenerator": (["@theta"], {"transform_type": "affine",
                                       "target_shape": (300, 300)}, "float"),
        "GridGenerator/warp": (["@flow"], {"transform_type": "warp"},
                               "float"),
        "BilinearSampler": (["@images", "@grid"], {}, "float"),
        "SpatialTransformer": (["@images", "@theta"],
                               {"target_shape": (300, 300)}, "float"),
        "Crop": (["@c4", "@crop_like"], {"offset": (2, 5)}, "exact"),
        "SVMOutput": (["@svm_scores", "@svm_labels"], {}, "exact"),
        "Correlation": (["@corr1", "@corr2"], {"max_displacement": 4,
                                               "pad_size": 4}, "float"),
        "_contrib_fft": (["@signal"], {}, "float"),
        "_contrib_ifft": (["@spectrum"], {}, "float"),
        "_contrib_count_sketch": (["@signal", "@sketch_h", "@sketch_s"],
                                  {"out_dim": 256}, "float"),
        "_contrib_SyncBatchNorm": (["@bn", "@bn_g", "@bn_b", "@bn_m",
                                    "@bn_v"], {"fix_gamma": False,
                                               "output_mean_var": True},
                                   "float"),
        "_contrib_box_iou": (["@anchors2d", "@gt2d"], {}, "exact"),
        "_contrib_box_nms": (["@det"], {"overlap_thresh": DET_NMS,
                                        "valid_thresh": 0.01,
                                        "topk": DET_TOPK, "id_index": 0,
                                        "background_id": -1}, "exact"),
        "_contrib_bipartite_matching": (["@gt_iou"], {"threshold": 0.5},
                                        "exact"),
        "_contrib_box_encode": (["@samples", "@matches_enc", "@anchors_b",
                                 "@refs"], {}, "float"),
        "_contrib_box_decode": (["@loc_b", "@anchors_b"], {}, "float"),
        "_contrib_MultiBoxPrior": (["@map38"], ssd, "exact"),
        "_contrib_ROIAlign": (["@c4", "@rois"],
                              {"pooled_size": (DET_POOL, DET_POOL),
                               "spatial_scale": s16, "sample_ratio": 2},
                              "float"),
        "_contrib_BilinearResize2D": (["@c4"], {"height": 76, "width": 126},
                                      "float"),
        "_contrib_AdaptiveAvgPooling2D": (["@c4"], {"output_size": (7, 7)},
                                          "float"),
        "_contrib_boolean_mask": (["@c4_rows", "@row_mask"], {}, "exact"),
        "_contrib_allclose": (["@loc_preds", "@loc_preds"], {}, "exact"),
        "_contrib_MultiBoxTarget": (["@anchors", "@labels", "@cls_preds"],
                                    {"negative_mining_ratio": DET_NEG_RATIO,
                                     "negative_mining_thresh": 0.5}, "mbt"),
        "_contrib_MultiBoxDetection": (["@cls_prob", "@loc_preds",
                                        "@anchors"],
                                       {"nms_threshold": DET_NMS,
                                        "nms_topk": DET_TOPK}, "nms"),
        "_contrib_Proposal": (["@rpn_prob", "@rpn_deltas", "@im_info"],
                              {"output_score": True}, "nms"),
        "_contrib_MultiProposal": (["@rpn_prob", "@rpn_deltas", "@im_info"],
                                   {}, "nms"),
        "_contrib_PSROIPooling": (["@ps", "@rois"],
                                  {"spatial_scale": s16,
                                   "output_dim": DET_PS[0],
                                   "pooled_size": DET_PS[1]}, "float"),
        "_contrib_RROIAlign": (["@c4", "@rrois"],
                               {"pooled_size": (7, 7), "spatial_scale": s16},
                               "float"),
        "_contrib_DeformablePSROIPooling": (
            ["@ps", "@rois", "@ps_trans"],
            {"spatial_scale": s16, "output_dim": DET_PS[0],
             "group_size": DET_PS[1], "pooled_size": DET_PS[1],
             "trans_std": 0.1}, "float"),
        "_contrib_DeformableConvolution": (
            ["@dcn", "@dcn_off", "@dcn_w", "@dcn_b"],
            {"kernel": (3, 3), "pad": (2, 2), "dilate": (2, 2),
             "num_filter": DET_DCN}, "float"),
        "_contrib_ModulatedDeformableConvolution": (
            ["@dcn", "@dcn_off", "@mdcn_mask", "@dcn_w", "@dcn_b"],
            {"kernel": (3, 3), "pad": (2, 2), "dilate": (2, 2),
             "num_filter": DET_DCN}, "float"),
        "_contrib_mrcnn_mask_target": (
            ["@mask_rois", "@masks", "@matches", "@mask_cls"],
            {"num_classes": DET_CLASSES, "mask_size": (14, 14)}, "float"),
    }


def _det_derived(torch, nd, a, dev):
    """The arrays that come from the card's own ops (copied to the host,
    so both sides get the same bits): SSD's anchors, the decoded SSD rows,
    the proposals' rois; and the small derived inputs of the cases."""
    from mxnet_tpu_torch.ops import proposal_ops
    anchors = _det_anchors(nd, dev)
    d = dict(a)
    d["anchors"] = anchors.asnumpy()
    if d["anchors"].shape != (1, DET_ANCHORS, 4):
        fail("detection: SSD300's anchors are %s, not (1, %d, 4)"
             % (d["anchors"].shape, DET_ANCHORS))
    d["det"] = proposal_ops.multibox_decode(
        torch.from_numpy(a["cls_prob"]).to(dev),
        torch.from_numpy(a["loc_preds"]).to(dev),
        anchors._data).cpu().numpy()
    rois = nd.Proposal(nd.NDArray(torch.from_numpy(a["rpn_prob"]).to(dev)),
                       nd.NDArray(torch.from_numpy(a["rpn_deltas"]).to(dev)),
                       nd.NDArray(torch.from_numpy(a["im_info"]).to(dev)))
    d["rois"] = rois[0].asnumpy() if isinstance(rois, (list, tuple)) \
        else rois.asnumpy()
    r = d["rois"]
    d["rrois"] = np.concatenate(
        [r[:, :1], (r[:, 1:3] + r[:, 3:5]) / 2, r[:, 3:5] - r[:, 1:3] + 1,
         np.linspace(-90, 90, r.shape[0], dtype=np.float32)[:, None]], 1)
    d["rois32"] = r[:32].copy()
    d["mask_rois"] = (r[None, :, 1:] / 4.0).astype(np.float32)
    d["zeros32"] = np.zeros(DET_BATCH, np.float32)
    d["arena0"] = a["arena"][0].reshape(8, 128, 12, 64)
    d["block0"] = a["block"][0].reshape(1, 16, 12, 64).repeat(8, 0)
    d["positions"] = np.arange(8, dtype=np.int32) * 13
    d["q"] = a["qkv"][:, :, :768].copy()
    d["kv"] = a["qkv"][:, :, 768:].copy()
    d["loc_pos"] = np.abs(a["loc_preds"]) + 0.5
    d["c4_rows"] = a["c4"].reshape(DET_C4, -1)
    d["row_index"] = np.arange(0, DET_C4, 7, dtype=np.float32)[::-1].copy()
    d["c4_new"] = a["c4"].reshape(DET_C4, -1)[:len(d["row_index"])] * 2
    d["row_mask"] = (np.arange(DET_C4) % 3 == 0).astype(np.float32)
    d["dcn_w2"] = a["dcn_w"].reshape(DET_DCN, -1)
    d["dcn_g2"] = a["dcn_w"].reshape(DET_DCN, -1)[::-1].copy()
    d["hist"] = np.abs(a["dcn_b"]).reshape(DET_DCN, 1)
    n = DET_BATCH
    d["hawkes_lda"] = np.abs(a["bn_params"][0, :4 * n]).reshape(n, 4) + 0.1
    d["hawkes_alpha"] = np.full(4, 0.3, np.float32)
    d["hawkes_beta"] = np.full(4, 1.5, np.float32)
    d["hawkes_state"] = np.abs(a["bn_params"][1, :4 * n]).reshape(n, 4)
    d["hawkes_valid"] = np.full(n, 30, np.float32)
    d["hawkes_time"] = a["hawkes_lags"].sum(1) + 1.0
    d["map38"] = np.zeros((1, 1, 38, 38), np.float32)
    d["crop_like"] = np.zeros((1, 1, 30, 50), np.float32)
    d["svm_scores"] = a["cls_preds"][:, :, :64].transpose(0, 2, 1).reshape(
        -1, DET_CLASSES).copy()
    d["grid"] = np.clip(a["flow"][:, :, :30, :30].repeat(10, 2).repeat(
        10, 3) / 4.0, -1.2, 1.2)
    d["corr1"], d["corr2"] = a["corr"][0], a["corr"][1]
    spec = np.fft.fft(a["signal"].astype(np.float64), axis=-1)
    d["spectrum"] = np.stack([spec.real, spec.imag], -1).reshape(
        DET_BATCH, -1).astype(np.float32)
    d["bn_g"], d["bn_b"] = a["bn_params"][0], a["bn_params"][1]
    d["bn_m"], d["bn_v"] = a["bn_params"][2], np.abs(a["bn_params"][3]) + 0.5
    d["anchors2d"] = d["anchors"][0]
    d["gt2d"] = a["labels"][0, :, 1:]
    gt = torch.from_numpy(a["labels"][:, :, 1:])
    from mxnet_tpu_torch.ops import detection_ops
    d["gt_iou"] = detection_ops.iou_corner(
        gt, torch.from_numpy(d["anchors"]).expand(DET_BATCH, -1, -1)).numpy()
    d["samples"] = np.sign(a["loc_preds"][:, :DET_ANCHORS]).astype(np.float32)
    d["matches_enc"] = np.abs(a["loc_preds"][:, DET_ANCHORS:2 * DET_ANCHORS]
                              * 7).astype(np.int64).clip(0, DET_GT - 1) \
        .astype(np.float32)
    d["anchors_b"] = np.repeat(d["anchors"], DET_BATCH, 0)
    d["refs"] = a["labels"][:, :, 1:].copy()
    d["loc_b"] = a["loc_preds"].reshape(DET_BATCH, DET_ANCHORS, 4)
    return d


def _det_value(torch, d, v, dev):
    """A case argument on ``dev``: an NDArray for ``"@key"``, a key tuple
    as a uint32 NDArray, else the value."""
    from mxnet_tpu_torch import nd
    if isinstance(v, str) and v.startswith("@"):
        return nd.NDArray(torch.from_numpy(
            np.ascontiguousarray(d[v[1:]])).to(dev))
    if isinstance(v, tuple):
        return nd.NDArray(torch.tensor(v, dtype=torch.int64).to(dev))
    return v


def _det_compare(torch, family, own, ref, what, dev):
    """(a)'s card outputs against the CPU's (see :func:`_det_cases`);
    raises :class:`_OpsMismatch`; returns the rows an ``nms`` family kept
    on one side only."""
    own = own if isinstance(own, (list, tuple)) else [own]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    if len(own) != len(ref):
        raise _OpsMismatch("detection %s: %d outputs on the card, %d on "
                           "the CPU" % (what, len(own), len(ref)))
    odd = 0
    for i, (o, r) in enumerate(zip(own, ref)):
        o, r = o._data, r._data
        if o.device.type != dev.type or o.dtype != r.dtype or \
                o.shape != r.shape:
            raise _OpsMismatch("detection %s: output %d is %s %s on %s, %s "
                               "%s on the CPU" % (what, i, o.dtype,
                                                  tuple(o.shape), o.device,
                                                  r.dtype, tuple(r.shape)))
        o = o.cpu()
        fam = family
        if family == "mbt":
            fam = "exact" if i == 2 else "float"
        if fam == "draw":
            if int(o.min()) < 0 or int(o.max()) >= 32000:
                raise _OpsMismatch("detection %s: tokens out of range"
                                   % what)
            continue
        if fam == "exact":
            same = torch.equal(o, r) if not o.is_floating_point() else \
                bool(((o == r) & (torch.signbit(o) == torch.signbit(r))
                      | (torch.isnan(o) & torch.isnan(r))).all())
            if not same:
                raise _OpsMismatch("detection %s: output %d differs from "
                                   "the CPU's (exact)" % (what, i))
            continue
        of, rf = o.double(), r.double()
        if fam == "nms":
            if i == 0:     # kept rows: not all -1 (rois: a nonzero box)
                rows_o = ~(of == -1).all(-1) if of.shape[-1] == 6 else \
                    ~(of[..., 1:] == 0).all(-1)
                rows_r = ~(rf == -1).all(-1) if rf.shape[-1] == 6 else \
                    ~(rf[..., 1:] == 0).all(-1)
                odd = int((rows_o ^ rows_r).sum())
            if odd:        # rows moved: the NMS check covers this output
                continue
            if i == 0:
                of, rf = of[rows_o], rf[rows_r]
        if of.numel() == 0:
            continue
        scale = max(rf.abs().max().item(), 1e-30)
        err = (of - rf).abs().max().item()
        if not err <= DET_TOL * scale:
            raise _OpsMismatch("detection %s: output %d is %.3g of its max "
                               "from the CPU's (tol %g)"
                               % (what, i, err / scale, DET_TOL))
    return odd


def _det_nms_explained(torch, d, dev, cpu):
    """The NMS family's exactness, apart from its decode: the card's
    decoded SSD rows within DET_TOL of the CPU's, and ``box_nms`` on the
    card bitwise to the CPU's on the same (the card's) rows; the same for
    the RPN's candidates and ``proposal_select``. Returns the rows each
    full op keeps on one side only (an ulp of ``exp`` moves a decoded box;
    this check shows the NMS itself agrees)."""
    from mxnet_tpu_torch.ops import detection_ops, proposal_ops
    out = {}
    det_card = torch.from_numpy(d["det"]).to(dev)
    det_cpu = proposal_ops.multibox_decode(
        torch.from_numpy(d["cls_prob"]), torch.from_numpy(d["loc_preds"]),
        torch.from_numpy(d["anchors"]))
    err = (det_card.cpu().double() - det_cpu.double()).abs().max().item()
    if not err <= DET_TOL:
        fail("detection: SSD decode %.3g from the CPU's" % err)
    kw = dict(overlap_thresh=DET_NMS, valid_thresh=0.01, topk=DET_TOPK,
              coord_start=2, score_index=1, id_index=0, background_id=-1)
    on_card = detection_ops.box_nms.fn(det_card, **kw).cpu()
    on_cpu = detection_ops.box_nms.fn(det_card.cpu(), **kw)
    if not torch.equal(on_card, on_cpu):
        fail("detection: box_nms of the same rows differs on the card")
    out["ssd_decode_err"] = err
    base = proposal_ops.base_anchors(DET_STRIDE, (0.5, 1, 2),
                                     (4, 8, 16, 32), torch.float32, dev)
    args = (torch.from_numpy(d["rpn_prob"][0, 12:]).to(dev),
            torch.from_numpy(d["rpn_deltas"][0]).to(dev),
            torch.from_numpy(d["im_info"][0]).to(dev), base,
            float(DET_STRIDE), 6000, 16.0)
    cand = proposal_ops.proposal_candidates(*args)
    cand_cpu = proposal_ops.proposal_candidates(
        *[t.cpu() if isinstance(t, torch.Tensor) else t for t in args])
    err = (cand.cpu().double() - cand_cpu.double()).abs().max().item()
    scale = cand_cpu.double().abs().max().item()
    if not err <= DET_TOL * scale:
        fail("detection: RPN candidates %.3g of max from the CPU's"
             % (err / scale))
    sel = proposal_ops.proposal_select(cand, 300, 0.7)
    sel_cpu = proposal_ops.proposal_select(cand.cpu(), 300, 0.7)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(sel, sel_cpu)):
        fail("detection: the RPN's NMS of the same rows differs on the card")
    out["rpn_candidates_rel_err"] = err / scale
    return out


def _det_part_a(args, torch, nd, d, dev, cpu):
    """(a): every new name on the card against the CPU."""
    from mxnet_tpu_torch.ops.registry import get_op
    cases = _det_cases(d)
    done, odd, mism = set(), {}, []
    ref_cache = {}
    for canon, (cargs, kw, fam) in cases.items():
        op = get_op(canon.split("/")[0])
        run_cpu = [_det_value(torch, d, v, cpu) for v in cargs]
        try:
            ref_cache[canon] = (op(*run_cpu, **kw), fam)
        except Exception as e:  # noqa: BLE001 — reported with the name
            mism.append("%s on the CPU: %s" % (canon, e))
    by_canon = {}
    for name in DET_NEW_NAMES:
        op = get_op(name)
        if op is None:
            mism.append("%s is not registered" % name)
            continue
        by_canon.setdefault(op.name, []).append(name)
    for canon, (cargs, kw, fam) in cases.items():
        base = canon.split("/")[0]
        if canon not in ref_cache:
            continue
        ref, _ = ref_cache[canon]
        for name in by_canon.get(base, [base]):
            run = [_det_value(torch, d, v, dev) for v in cargs]
            try:
                own = getattr(nd, name)(*run, **kw)
                odd[name] = _det_compare(torch, fam, own, ref,
                                         "%s (%s)" % (name, canon), dev)
                done.add(name)
            except _OpsMismatch as e:
                mism.append(str(e))
    # the control-flow trio, through its registry names and nd.contrib
    x = nd.NDArray(torch.from_numpy(d["signal"][:4]).to(dev))
    xc = nd.NDArray(torch.from_numpy(d["signal"][:4]))
    for name, fn in (
            ("_foreach", lambda v, m: m._foreach(
                lambda t, s: (t * s, s + t), v, v[0])),
            ("_while_loop", lambda v, m: m._while_loop(
                lambda s: s.sum() < 1e6, lambda s: s * 2 + 1,
                nd.abs(v[0]))),
            ("_cond", lambda v, m: m._cond(v.sum() > 0, lambda: [v * 2],
                                           lambda: [v - 1]))):
        try:
            own, ref = fn(x, nd), fn(xc, nd)
            _det_compare(torch, "float", list(own), list(ref), name, dev)
            done.add(name)
        except _OpsMismatch as e:
            mism.append(str(e))
    missing = sorted(set(DET_NEW_NAMES) - done)
    if missing:
        mism.append("not checked: %s" % " ".join(missing))
    return {"names": len(done), "nms_rows_one_side": {
        k: v for k, v in odd.items() if v}}, mism


def _det_lstm(torch, nd, autograd, d, dev, cpu):
    """(a): ``nd.contrib.foreach`` over an LSTM cell (gates i, f, c, o) at
    the LSTM LM's width, forward and backward on the card (ms), the first
    DET_CPU_ROWS rows' outputs and input gradients against the CPU's."""
    T, B, H = DET_LSTM

    def run(ctx_dev, rows):
        x = nd.NDArray(torch.from_numpy(d["lstm_x"][:, :rows]).to(ctx_dev))
        wi, wh, b = (nd.NDArray(torch.from_numpy(d[k]).to(ctx_dev))
                     for k in ("lstm_wi", "lstm_wh", "lstm_b"))
        h0 = nd.NDArray(torch.zeros((rows, H), device=ctx_dev))
        x.attach_grad()

        def cell(xt, states):
            h, c = states
            g = nd.dot(xt, wi, transpose_b=True) + \
                nd.dot(h, wh, transpose_b=True) + b
            i, f, cc, o = nd.split(g, num_outputs=4, axis=1)
            c2 = nd.sigmoid(f) * c + nd.sigmoid(i) * nd.tanh(cc)
            h2 = nd.sigmoid(o) * nd.tanh(c2)
            return h2, [h2, c2]

        with autograd.record():
            out, (h, c) = nd.contrib.foreach(cell, x, [h0, h0])
            loss = (out * out).sum()
        loss.backward()
        return out, x.grad

    run(dev, B)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out, grad = run(dev, B)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    ref_out, ref_grad = run(cpu, DET_CPU_ROWS)
    res = {"ms_fwd_bwd": ms}
    for k, o, r in (("out", out, ref_out), ("grad", grad, ref_grad)):
        o = o._data[:, :DET_CPU_ROWS].cpu().double()
        r = r._data.double()
        rel = ((o - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
        if not rel <= 1e-4:
            fail("detection: foreach LSTM %s %.3g of max from the CPU's"
                 % (k, rel))
        res[k + "_rel_to_max"] = rel
    return res


def _det_ssd(args, torch, nd, autograd, d, dev):
    """(b): SSD300's anchors, targets, loss (with its gradient) and
    detection on the card, each timed (CUDA events) with the peak
    memory."""
    torch.cuda.reset_peak_memory_stats()
    t = lambda k: nd.NDArray(torch.from_numpy(d[k]).to(dev))  # noqa: E731
    labels, cls_preds, loc_preds = t("labels"), t("cls_preds"), t("loc_preds")
    anchors = _det_anchors(nd, dev)
    ms = {"MultiBoxPrior": _events_ms(torch, lambda: _det_anchors(nd, dev),
                                      DET_CALLS)}

    def target():
        return nd.MultiBoxTarget(anchors, labels, cls_preds,
                                 negative_mining_ratio=DET_NEG_RATIO,
                                 negative_mining_thresh=0.5)
    box_t, box_m, cls_t = target()
    ms["MultiBoxTarget"] = _events_ms(torch, target, DET_CALLS)
    pos = int((cls_t._data > 0).sum())
    neg = int((cls_t._data == 0).sum())
    if pos == 0 or not neg <= DET_NEG_RATIO * pos:
        fail("detection: SSD targets %d positives, %d negatives" % (pos, neg))

    def loss_step():
        cp, lp = cls_preds.copy(), loc_preds.copy()
        cp.attach_grad()
        lp.attach_grad()
        with autograd.record():
            logp = nd.log_softmax(cp, axis=1)
            keep = cls_t >= 0
            ce = -nd.pick(logp, nd.maximum(cls_t, 0), axis=1) * keep
            l1 = nd.smooth_l1((lp - box_t) * box_m, scalar=1.0)
            loss = (ce.sum() + l1.sum()) / max(pos, 1)
        loss.backward()
        return loss, cp.grad, lp.grad
    loss, gc_, gl = loss_step()
    ms["loss_fwd_bwd"] = _events_ms(torch, loss_step, DET_CALLS)
    if not all(bool(torch.isfinite(x._data).all()) for x in (loss, gc_, gl)):
        fail("detection: the SSD loss or its gradient is not finite")
    cls_prob = nd.softmax(cls_preds, axis=1)

    def detect():
        return nd.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                    nms_threshold=DET_NMS, nms_topk=DET_TOPK)
    det = detect()
    ms["MultiBoxDetection"] = _events_ms(torch, detect, DET_CALLS)
    kept = int((~(det._data == -1).all(-1)).sum())
    if not 0 < kept <= DET_BATCH * DET_TOPK:
        fail("detection: MultiBoxDetection kept %d rows" % kept)
    return {"ms": ms, "loss": float(loss.asnumpy()), "positives": pos,
            "negatives": neg, "kept": kept,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def _det_frcnn(args, torch, nd, autograd, d, dev):
    """(c): Faster R-CNN C4's Proposal, ROIAlign forward and backward,
    R-FCN's PSROIPooling and one deformable convolution, each timed."""
    torch.cuda.reset_peak_memory_stats()
    t = lambda k: nd.NDArray(torch.from_numpy(d[k]).to(dev))  # noqa: E731
    prob, deltas, info = t("rpn_prob"), t("rpn_deltas"), t("im_info")
    ms = {}

    def propose():
        return nd.Proposal(prob, deltas, info)
    rois = propose()
    rois = rois[0] if isinstance(rois, (list, tuple)) else rois
    ms["Proposal"] = _events_ms(torch, propose, DET_CALLS)
    kept = int((~(rois._data[:, 1:] == 0).all(-1)).sum())
    if rois.shape != (300, 5) or kept == 0:
        fail("detection: Proposal gave %s with %d rows" % (rois.shape, kept))
    c4 = t("c4")
    s16 = 1.0 / DET_STRIDE
    ms["ROIAlign"] = _events_ms(torch, lambda: nd.ROIAlign(
        c4, rois, pooled_size=(DET_POOL, DET_POOL), spatial_scale=s16,
        sample_ratio=2), DET_CALLS)

    def align_bwd():
        x = c4.copy()
        x.attach_grad()
        with autograd.record():
            y = nd.ROIAlign(x, rois, pooled_size=(DET_POOL, DET_POOL),
                            spatial_scale=s16, sample_ratio=2)
        y.backward(nd.ones_like(y))
        return x.grad
    g = align_bwd()
    ms["ROIAlign_fwd_bwd"] = _events_ms(torch, align_bwd, DET_CALLS)
    total = float(g._data.double().sum())
    want = 300 * DET_C4 * DET_POOL * DET_POOL
    if not abs(total - want) <= 1e-3 * want:
        fail("detection: ROIAlign's gradient sums to %g, not %d"
             % (total, want))
    ps = t("ps")
    ms["PSROIPooling"] = _events_ms(torch, lambda: nd.PSROIPooling(
        ps, rois, spatial_scale=s16, output_dim=DET_PS[0],
        pooled_size=DET_PS[1]), DET_CALLS)
    dx, off, w, b = t("dcn"), t("dcn_off"), t("dcn_w"), t("dcn_b")
    ms["DeformableConvolution"] = _events_ms(
        torch, lambda: nd.DeformableConvolution(
            dx, off, w, b, kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
            num_filter=DET_DCN), DET_CALLS)
    return {"ms": ms, "rois_kept": kept,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def detection_phase(args, torch):
    """Item 8 steps 1-4 on the card, parts (a)-(c) (see the module
    docstring)."""
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch import autograd, nd
    t0 = time.perf_counter()
    fa0 = kernel_launches()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    d = _det_derived(torch, nd, _det_arrays(args.seed), dev)
    out = {}
    ta = time.perf_counter()
    out["a"], mism = _det_part_a(args, torch, nd, d, dev, cpu)
    if mism:
        fail("detection: %d cases differ from the CPU: %s"
             % (len(mism), "; ".join(mism)))
    out["a"]["nms"] = _det_nms_explained(torch, d, dev, cpu)
    out["a"]["lstm"] = _det_lstm(torch, nd, autograd, d, dev, cpu)
    out["a"]["wall_s"] = time.perf_counter() - ta
    torch.cuda.empty_cache()
    out["b"] = _det_ssd(args, torch, nd, autograd, d, dev)
    torch.cuda.empty_cache()
    out["c"] = _det_frcnn(args, torch, nd, autograd, d, dev)
    torch.cuda.empty_cache()
    out["launches"] = {k: v - fa0[k] for k, v in kernel_launches().items()}
    if any(out["launches"].values()):
        fail("detection: a flash kernel launched %s" % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_detection(res, card):
    """The detection phase's lines of the output."""
    a, b, c = res["a"], res["b"], res["c"]
    print("detection (a): %d new registry names on gpu(0) == the CPU (exact "
          "families bitwise, float ops within %g of max); NMS on the same "
          "rows bitwise, SSD decode %.3g, RPN candidates %.3g of max; rows "
          "kept on one side only (decode ulps) %s; foreach LSTM b%d s%d "
          "h%d fwd+bwd %.1f ms, out %.2g / grad %.2g of max vs the CPU; "
          "%.1f s [%s]"
          % (a["names"], DET_TOL, a["nms"]["ssd_decode_err"],
             a["nms"]["rpn_candidates_rel_err"], a["nms_rows_one_side"] or 0,
             DET_LSTM[1], DET_LSTM[0], DET_LSTM[2], a["lstm"]["ms_fwd_bwd"],
             a["lstm"]["out_rel_to_max"], a["lstm"]["grad_rel_to_max"],
             a["wall_s"], card), flush=True)
    print("detection (b) SSD300 VOC b%d, %d anchors: ms %s; loss %.4f, %d "
          "positives, %d negatives, %d rows kept; peak memory %.2f GB [%s]"
          % (DET_BATCH, DET_ANCHORS, ", ".join(
              "%s %.3f" % kv for kv in b["ms"].items()), b["loss"],
             b["positives"], b["negatives"], b["kept"], b["peak_gb"], card),
          flush=True)
    print("detection (c) Faster R-CNN C4 %dx%d (map %dx%d): ms %s; %d rois "
          "kept; peak memory %.2f GB; flash launches %s; %.1f s [%s]"
          % (DET_IMAGE[0], DET_IMAGE[1], DET_MAP[0], DET_MAP[1], ", ".join(
              "%s %.3f" % kv for kv in c["ms"].items()), c["rois_kept"],
             c["peak_gb"], res["launches"], res["wall_s"], card), flush=True)


# the quant phase: the Custom op and INT8 ResNet-50 v1 (item 8 step 5)
QUANT_GRAD_TOL = 1e-4       # a Custom-head step's gradients against
#                             SoftmaxOutput's, of each gradient's max
QUANT_BN_BATCHES = 3        # training-mode forwards that set the statistics
QUANT_CALIB_BATCHES = 4     # quantize_net's calibration batches (naive)
QUANT_LAYERS = 54           # ResNet-50 v1: 53 convolutions and the Dense
QUANT_CPU_ROWS = 4          # rows of the b32 batch run again on the CPU
QUANT_LOGIT_TOL = 1e-3      # int8 logits, the card against the CPU, of max
QUANT_REPLAYS = 20
QUANT_ROUND_TRIPS = 20      # the Custom softmax alone, calls timed a side
QUANT_GEMM_RE = re.compile(r"(?i)imma|igemm|i8i8|int8|s8")   # cuBLASLt's


def _register_custom_softmax(mx):
    """``example/numpy-ops/custom_softmax.py``'s op as ``chip_softmax``
    (numpy softmax; backward ``p - onehot(label)``, no top gradient), and
    its forward alone as ``chip_softmax_infer`` (data only)."""

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("chip_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    @mx.operator.register("chip_softmax_infer")
    class InferProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def _custom_module(torch, graph, head, arg_p, aux_p):
    from mxnet_tpu_torch import module as mod_ns
    shape = (VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE)
    m = mod_ns.Module(head)
    m.bind(data_shapes=[("data", shape)],
           label_shapes=[("softmax_label", (VISION_BATCH,))])
    m.init_params(arg_params=arg_p, aux_params=aux_p)
    m.init_optimizer(optimizer="sgd", optimizer_params=dict(VISION_SGD))
    return m


def quant_custom(args, torch, tmp):
    """(a) ResNet-50 v1 exported, its head the Custom softmax: one step's
    gradients against ``SoftmaxOutput``'s, 8 SGD steps through
    ``Module``, the op alone against ``SoftmaxOutput``; a hybridized block
    ending in ``nd.Custom`` served through ``InferenceEngine`` (its
    signature eager, counted); a host read outside a host op still fails
    its capture."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, io, model, nd, sym
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.serving import InferenceEngine
    dev = torch.device("cuda")
    _register_custom_softmax(mx)
    net = _resnet50(torch, trandom, args.seed)
    prefix = os.path.join(tmp, "resnet50_custom")
    net.export(prefix)
    graph, arg_p, aux_p = model.load_checkpoint(prefix, 0)
    label = sym.var("softmax_label")
    g = torch.Generator(dev).manual_seed(args.seed + 5)
    x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                   generator=g, device=dev)
    y = torch.randint(0, VISION_CLASSES, (VISION_BATCH,), generator=g,
                      device=dev).float()
    batch = io.DataBatch(data=[nd.NDArray(x)], label=[nd.NDArray(y)])
    res = {}
    ref = _custom_module(torch, graph, sym.SoftmaxOutput(
        graph, label, name="softmax"), arg_p, aux_p)
    ref.forward_backward(batch)
    want = {n: a._data.clone() for n, a in ref._exec.grad_dict.items()
            if n in arg_p}
    probs = ref.get_outputs()[0]._data.clone()
    del ref
    custom = _custom_module(torch, graph, sym.Custom(
        graph, label, op_type="chip_softmax", name="softmax"), arg_p, aux_p)
    custom.forward_backward(batch)
    worst, worst_name = 0.0, None
    for n, w in want.items():
        err = rel_to_max(custom._exec.grad_dict[n]._data, w)
        if not err <= worst:
            worst, worst_name = err, n
    if not worst <= QUANT_GRAD_TOL:
        fail("quant (a): the Custom head's gradient of %s lies %.3g of its "
             "max from SoftmaxOutput's (tolerance %g)"
             % (worst_name, worst, QUANT_GRAD_TOL))
    res["grad_vs_softmax_output"] = {"worst_rel_to_max": worst,
                                     "param": worst_name,
                                     "params": len(want)}
    res["probs_vs_softmax_output"] = rel_to_max(
        custom.get_outputs()[0]._data, probs)
    del want, probs
    custom.update()
    losses = [_sm_loss(torch, custom.get_outputs()[0]._data, y)]

    def step():
        custom.forward_backward(batch)
        custom.update()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(SYMBOL_STEPS - 1):
        step()
        losses.append(_sm_loss(torch, custom.get_outputs()[0]._data, y))
    e1.record()
    torch.cuda.synchronize()
    res["step_ms"] = e0.elapsed_time(e1) / (SYMBOL_STEPS - 1)
    res["losses"] = losses
    del custom
    # the op alone at the head's shape: the host round trip's cost
    logits = nd.NDArray(torch.randn((VISION_BATCH, VISION_CLASSES),
                                    generator=g, device=dev))
    logits.attach_grad()
    lab = nd.NDArray(y)

    def run(custom_op):
        def once():
            with autograd.record():
                out = nd.Custom(logits, lab, op_type="chip_softmax") \
                    if custom_op else nd.SoftmaxOutput(logits, lab)
            out.backward()
        return once
    run(True)()
    run(False)()
    res["custom_fwd_bwd_ms"] = _events_ms(torch, run(True),
                                          QUANT_ROUND_TRIPS)
    res["softmax_output_fwd_bwd_ms"] = _events_ms(torch, run(False),
                                                  QUANT_ROUND_TRIPS)

    class Served(gluon.HybridBlock):
        def __init__(self, body):
            super().__init__()
            self.body = body

        def hybrid_forward(self, F, data):
            return F.Custom(self.body(data), op_type="chip_softmax_infer")

    served = Served(net)
    served.hybridize()
    engine = InferenceEngine(served, buckets=(1, 8, 32))
    xs = nd.NDArray(x[:8])
    with autograd.predict_mode():
        outs = [engine.predict(xs)._data for _ in range(3)]
        eager = served._nd_forward(xs)._data
    stats = engine.stats()
    if not (stats["host_eager"] == 1 and stats["graphs"] == 0
            and stats["hits"] == 2):
        fail("quant (a): the served Custom signature was not run eagerly "
             "and counted: %s" % stats)
    if not all(torch.equal(o, eager) for o in outs) or not torch.allclose(
            eager.sum(1), torch.ones(eager.shape[0], device=dev),
            atol=1e-5):
        fail("quant (a): the served answers differ from the block's eager "
             "forward")
    res["served"] = {k: stats[k] for k in ("host_eager", "graphs", "hits",
                                           "misses")}
    engine.close()

    class Syncs(gluon.HybridBlock):
        def hybrid_forward(self, F, data):
            return data * float(data.sum().asscalar())

    syncs = Syncs()
    syncs.hybridize()
    try:
        with autograd.predict_mode():
            syncs(nd.NDArray(torch.ones(4, device=dev)))
    except Exception as e:  # noqa: BLE001 — the capture's own error
        res["other_capture_raises"] = type(e).__name__
    else:
        fail("quant (a): a host read outside a host op was captured")
    torch.cuda.synchronize()
    return net, res


def _int8_layers(net):
    return [m for m in net.modules()
            if type(m).__name__ in ("_Int8Conv", "_Int8Dense")]


def _trace_int8(torch, net, x, check=None):
    """One eager forward of a quantized net on ``x``: each int8 layer's
    int8 input (on the host), and ``check(layer, qx)`` of each."""
    from mxnet_tpu_torch import autograd, nd
    trace, handles = [], []

    def hook(block, inputs):
        qx = block._quantize_in(inputs[0])[0]
        trace.append(qx.cpu())
        if check is not None:
            check(block, qx)
    for m in _int8_layers(net):
        handles.append(m.register_forward_pre_hook(hook))
    try:
        with autograd.predict_mode():
            out = net(nd.NDArray(x))._data
    finally:
        for h in handles:
            h.detach()
    return out, trace


def _int8_conv_plain(torch, qx, w, stride, pad, dilate):
    """The plain version of an int8 convolution: ``F.conv2d`` of the int8
    values in float64 (exact: every sum stays under 2^53), with cuDNN off
    so that PyTorch's own convolution (im2col and cuBLAS's DGEMM) makes
    it, apart from the port's im2col and ``torch._int_mm``."""
    import torch.nn.functional as F
    with torch.backends.cudnn.flags(enabled=False):
        out = F.conv2d(qx.double(), w.double(), stride=stride, padding=pad,
                       dilation=dilate)
    return out.to(torch.int32)


def _accumulators_check(torch, results):
    """``check`` of :func:`_trace_int8`: the layer's int32 accumulators
    from the port's route (im2col and ``torch._int_mm``) against the
    plain version (a float64 convolution or product, exact) on the same
    int8 input."""
    from mxnet_tpu_torch.ops import quantized_ops as qo

    def check(block, qx):
        w = block._wq
        if type(block).__name__ == "_Int8Conv":
            k = block._kwargs
            geo = (tuple(k["stride"]), tuple(k["pad"]), tuple(k["dilate"]))
            got = qo.int8_conv(qx, w, *geo)
            plain = _int8_conv_plain(torch, qx, w, *geo)
        else:
            rows = qx.reshape(qx.shape[0], -1)
            got = qo.int8_matmul(rows, w)
            plain = qo.int8_matmul_plain(rows, w)
        results.append((tuple(got.shape), bool(torch.equal(got, plain))))
    return check


def _range_set_in_place(torch, net, xn, replay8):
    """``set_data`` of a narrower range into the first int8 layer of the
    hybridized, captured ``net``: its replay must quantize in the new
    range (equal to an eager forward in it, unlike the old output); the
    old range set back gives the old output again. Leaves ``net``
    eager."""
    first = _int8_layers(net)[0]
    old = first.calib.data()._data.clone()
    first.calib.set_data(old * 0.5)
    replayed = net(xn)._data.clone()
    first.calib.set_data(old)
    restored = net(xn)._data.clone()
    net.hybridize(False)
    first.calib.set_data(old * 0.5)
    eager = net(xn)._data.clone()
    first.calib.set_data(old)
    ok = (torch.equal(replayed, eager) and not torch.equal(replayed, replay8)
          and torch.equal(restored, replay8))
    if not ok:
        fail("quant (b): a range set in place after the capture was not "
             "used by the replay")
    return True


def quant_int8(args, torch, tmp, net):
    """(b) ``net`` (ResNet-50 v1 from ``Xavier()``) with BatchNorm
    statistics from training-mode forwards, ``quantize_net`` on 4
    calibration batches; b32 int8 inference against the plain
    accumulators, the CPU, the fp32 net, timed beside the fp32 and bf16
    replays; a ``.params`` round trip; ``quantize_model`` on the exported
    symbol."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, model, nd
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.contrib.quantization import (quantize_model,
                                                      quantize_net)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    dev = torch.device("cuda")
    shape = (VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE)
    g = torch.Generator(dev).manual_seed(args.seed + 6)
    with autograd.train_mode():
        for _ in range(QUANT_BN_BATCHES):
            net(nd.NDArray(torch.rand(shape, generator=g, device=dev)))
    calib = [nd.NDArray(torch.rand(shape, generator=g, device=dev))
             for _ in range(QUANT_CALIB_BATCHES)]
    x = torch.rand(shape, generator=g, device=dev)
    xn = nd.NDArray(x)
    res = {}
    src = os.path.join(tmp, "resnet50_float")
    net.hybridize()
    with autograd.predict_mode():
        net(xn)                                     # the capture
        out32 = net(xn)._data.clone()
        res["fp32_replay_ms"] = _events_ms(torch, lambda: net(xn),
                                           QUANT_REPLAYS)
    net.export(src)
    net.hybridize(False)
    nbf = _resnet50(torch, trandom, args.seed)
    for p, q in zip(nbf.collect_params().values(),
                    net.collect_params().values()):
        p.set_data(q.data())
    nbf.cast("bfloat16")
    nbf.hybridize()
    xb = nd.NDArray(x.bfloat16())
    with autograd.predict_mode():
        nbf(xb)
        res["bf16_replay_ms"] = _events_ms(torch, lambda: nbf(xb),
                                           QUANT_REPLAYS)
    del nbf
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    quantize_net(net, calib_data=calib, calib_mode="naive")
    res["quantize_s"] = time.perf_counter() - t0
    layers = _int8_layers(net)
    if len(layers) != QUANT_LAYERS or any(m._range is None for m in layers):
        fail("quant (b): %d layers swapped (%d calibrated), not %d"
             % (len(layers), sum(m._range is not None for m in layers),
                QUANT_LAYERS))
    acc = []
    torch.cuda.reset_peak_memory_stats()
    out8, _ = _trace_int8(torch, net, x, _accumulators_check(torch, acc))
    if len(acc) != QUANT_LAYERS or not all(eq for _, eq in acc):
        fail("quant (b): int32 accumulators differ from the plain version "
             "in %d of %d layers" % (sum(not eq for _, eq in acc),
                                     len(acc)))
    res["accumulators_bitwise"] = len(acc)
    with autograd.predict_mode():
        torch.cuda.reset_peak_memory_stats()
        eager8 = net(xn)._data.clone()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["int8_eager_ms"] = _events_ms(torch, lambda: net(xn), 5)
        net.hybridize()
        net(xn)                                     # the capture
        replay8 = net(xn)._data.clone()
        res["int8_replay_ms"] = _events_ms(torch, lambda: net(xn),
                                           QUANT_REPLAYS)
        res["range_set_in_place"] = _range_set_in_place(torch, net, xn,
                                                        replay8)
    net.hybridize(False)
    if args.profile:
        with autograd.predict_mode():
            res["profile"] = profile(torch, lambda: net(xn), QUANT_GEMM_RE)
    if not (torch.equal(eager8, out8) and torch.equal(replay8, out8)
            and torch.isfinite(out8).all()):
        fail("quant (b): the int8 forward's replay or a second eager "
             "forward differs, or is not finite")
    res["top1_agree_fp32"] = float(
        (out8.argmax(1) == out32.argmax(1)).float().mean())
    res["logits_vs_fp32_rel_to_max"] = rel_to_max(out8, out32)
    # the same quantized net on the CPU, from its .params file
    fparams = os.path.join(tmp, "int8.params")
    net.save_parameters(fparams)
    rows = x[:QUANT_CPU_ROWS]
    card_out, card_trace = _trace_int8(torch, net, rows)
    with mx.cpu():
        trandom.seed(args.seed)
        np.random.seed(args.seed)
        cpu_net = vision.resnet50_v1()
        cpu_net.initialize(mx.initializer.Xavier())
        cpu_net(nd.zeros((1, 3, VISION_IMAGE, VISION_IMAGE)))
        quantize_net(cpu_net)
        cpu_net.load_parameters(fparams)
        cpu_out, cpu_trace = _trace_int8(torch, cpu_net, rows.cpu())
    diffs = [(a.to(torch.int32) - b.to(torch.int32)).abs()
             for a, b in zip(card_trace, cpu_trace)]
    res["cpu"] = {"rows": QUANT_CPU_ROWS,
                  "int8_off_by_one": int(sum((d == 1).sum() for d in diffs)),
                  "int8_off_by_more": int(sum((d > 1).sum() for d in diffs)),
                  "int8_values": int(sum(d.numel() for d in diffs)),
                  "logits_rel_to_max": rel_to_max(card_out.cpu(), cpu_out),
                  "tol": QUANT_LOGIT_TOL}
    if not res["cpu"]["logits_rel_to_max"] <= QUANT_LOGIT_TOL:
        fail("quant (b): the int8 logits lie %.3g of their max from the "
             "CPU's (tolerance %g)" % (res["cpu"]["logits_rel_to_max"],
                                       QUANT_LOGIT_TOL))
    del cpu_net
    # .params round trip into a fresh quantized net on the card
    twin = _resnet50(torch, trandom, args.seed + 1)
    quantize_net(twin)
    twin.load_parameters(fparams)
    with autograd.predict_mode():
        back = twin(xn)._data
    if not torch.equal(back, out8):
        fail("quant (b): the int8 net loaded from its .params file answers "
             "otherwise (max |diff| %g)" % (back - out8).abs().max())
    res["params_round_trip_bitwise"] = True
    del twin
    # quantize_model on the exported float symbol
    graph, arg_p, aux_p = model.load_checkpoint(src, 0)
    _, qargs, qaux = quantize_model(graph, arg_p, aux_p, ctx=mx.gpu(0))
    quantized = [n for n in arg_p if n.endswith("weight")]
    ex = graph.bind(mx.gpu(0), dict(qargs, data=xn), aux_states=qaux)
    qout = ex.forward()[0]._data
    res["quantize_model"] = {
        "weights": len(quantized),
        "worst_weight_step": max(
            float(((qargs[n]._data - arg_p[n]._data).abs().amax(
                dim=tuple(range(1, arg_p[n].ndim)))
                / (arg_p[n]._data.abs().amax(
                    dim=tuple(range(1, arg_p[n].ndim))) / 127.0)
                .clamp_min(1e-30)).max()) for n in quantized),
        "logits_vs_fp32_rel_to_max": rel_to_max(qout, out32)}
    if len(quantized) != QUANT_LAYERS or \
            not res["quantize_model"]["worst_weight_step"] <= 0.5 + 1e-3:
        fail("quant (b): quantize_model: %s" % res["quantize_model"])
    del ex, qargs
    return res


def _quant_cases(torch, g, dev):
    """Each of the 13 ops at ResNet-50's widths, on ``dev``'s tensors
    drawn from ``g`` (on the card) and copied."""
    def i8(*s):
        return torch.randint(-127, 128, s, generator=g, device=dev,
                             dtype=torch.int8)

    def f(*s):
        return torch.randn(s, generator=g, device=dev)

    def r(v):
        return torch.full((1,), v, device=dev)
    act = f(32, 3, 224, 224)
    return {
        "quantize_v2": ([act], {"min_calib_range": -2.1,
                                "max_calib_range": 2.6}),
        "quantize": ([act, r(-2.1), r(2.6)], {}),
        "dequantize": ([i8(32, 64, 56, 56), r(-3.0), r(4.0)], {}),
        "requantize": ([torch.randint(-2 ** 24, 2 ** 24, (32, 1000),
                                      generator=g, device=dev,
                                      dtype=torch.int32),
                        r(-400.0), r(400.0)], {}),
        "quantized_fully_connected": (
            [i8(32, 2048), i8(1000, 2048), f(1000)],
            dict(min_data=-3.0, max_data=3.0, min_weight=-0.2,
                 max_weight=0.2, min_bias=-1.0, max_bias=1.0,
                 num_hidden=1000)),
        "quantized_conv": (
            [i8(8, 3, 224, 224), i8(64, 3, 7, 7), f(64)],
            dict(min_data=-2.0, max_data=2.0, min_weight=-0.1,
                 max_weight=0.1, min_bias=-0.5, max_bias=0.5,
                 kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64)),
        "quantized_pooling": (
            [i8(32, 64, 112, 112)],
            dict(min_data=-1.0, max_data=1.0, kernel=(3, 3), stride=(2, 2),
                 pad=(1, 1), pool_type="max")),
        "quantized_act": ([i8(32, 64, 112, 112)],
                          dict(min_data=-1.0, max_data=1.0)),
        "quantized_flatten": ([i8(32, 2048, 1, 1)],
                              dict(min_data=-1.0, max_data=1.0)),
        "quantized_elemwise_add": (
            [i8(32, 256, 56, 56), i8(32, 256, 56, 56)],
            dict(lhs_min=-1.0, lhs_max=1.0, rhs_min=-2.0, rhs_max=3.0)),
        "quantized_concat": (
            [i8(32, 64, 56, 56), i8(32, 128, 56, 56), r(-1.0), r(1.0),
             r(-2.0), r(3.0)], dict(num_args=2, dim=1)),
        "quantized_batch_norm": (
            [i8(32, 64, 56, 56), f(64) + 1.0, f(64), f(64),
             f(64).abs() + 0.5], dict(min_data=-2.0, max_data=2.0)),
        "calibrate_entropy": (
            [torch.randint(0, 1000, (512,), generator=g, device=dev)
             .float(), torch.linspace(0, 8.0, 513, device=dev)],
            dict(num_quantized_bins=255)),
    }


def quant_names(args, torch):
    """(b) every one of the 26 names once on the card against the CPU on
    the same inputs: bitwise (int8/uint8/int32 payloads and the float32
    ranges and values alike)."""
    from mxnet_tpu_torch.ops import registry as treg
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    g = torch.Generator(dev).manual_seed(args.seed + 8)
    cases = _quant_cases(torch, g, dev)
    mism, names = [], 0
    for base, (a, kw) in sorted(cases.items()):
        want = treg.get_op(base).fn(*[t.to(cpu) for t in a], **kw)
        want = want if isinstance(want, tuple) else (want,)
        for name in (base, "_contrib_" + base):
            got = treg.get_op(name).fn(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            names += 1
            for i, (o, w) in enumerate(zip(got, want)):
                if o.dtype != w.dtype or not torch.equal(o.cpu(), w):
                    mism.append("%s[%d]" % (name, i))
    if mism:
        fail("quant: %d outputs differ from the CPU: %s"
             % (len(mism), ", ".join(mism)))
    return {"names": names}


def quant_phase(args, torch):
    """The quant phase, parts (a) and (b) (see the module docstring)."""
    import tempfile
    t0 = time.perf_counter()
    fa0 = kernel_launches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        net, out["custom"] = quant_custom(args, torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["int8"] = quant_int8(args, torch, tmp, net)
        del net
    gc.collect()
    torch.cuda.empty_cache()
    out["ops"] = quant_names(args, torch)
    out["launches"] = {k: v - fa0[k] for k, v in kernel_launches().items()}
    if any(out["launches"].values()):
        fail("quant: a flash kernel launched %s" % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_quant(res, symbol, vision, card):
    """The quant phase's lines of the output."""
    c, q = res["custom"], res["int8"]
    print("quant (a) resnet50_v1 b%d, Custom softmax head (numpy on the "
          "host) through Module: gradients vs SoftmaxOutput %.3g of max "
          "(%d arrays, tol %g); step %.2f ms against the symbol phase's "
          "SoftmaxOutput step %.2f ms; the op alone fwd+bwd %.3f ms against "
          "SoftmaxOutput's %.3f ms; losses %s; served hybridized block: %s, "
          "a host read outside a host op raises %s [%s]"
          % (VISION_BATCH, c["grad_vs_softmax_output"]["worst_rel_to_max"],
             c["grad_vs_softmax_output"]["params"], QUANT_GRAD_TOL,
             c["step_ms"], symbol["module"]["step_ms"],
             c["custom_fwd_bwd_ms"], c["softmax_output_fwd_bwd_ms"],
             ", ".join("%.4f" % v for v in c["losses"]), c["served"],
             c["other_capture_raises"], card), flush=True)
    cpu = q["cpu"]
    print("quant (b) int8 resnet50_v1 b%d: %d layers swapped, int32 "
          "accumulators == plain (float64) in all %d; int8 eager %.3f ms, "
          "replay %.3f ms; fp32 replay %.3f ms, bf16 replay %.3f ms (vision "
          "phase bf16 %.3f); peak %.2f GB; top-1 vs fp32 %.3f (logits %.3g of "
          "max); CPU (%d rows): logits %.3g of max (tol %g), int8 values off "
          "by one %d / more %d of %d; .params round trip bitwise; "
          "quantize_model %d weights (worst %.3f of a step), logits %.3g of "
          "fp32 max; %d names == CPU; quantize_net %.1f s; flash launches "
          "%s; %.1f s [%s]"
          % (VISION_BATCH, QUANT_LAYERS, q["accumulators_bitwise"],
             q["int8_eager_ms"], q["int8_replay_ms"], q["fp32_replay_ms"],
             q["bf16_replay_ms"], vision["inference"]["replay_ms"],
             q["peak_gb"], q["top1_agree_fp32"],
             q["logits_vs_fp32_rel_to_max"], cpu["rows"],
             cpu["logits_rel_to_max"], cpu["tol"], cpu["int8_off_by_one"],
             cpu["int8_off_by_more"], cpu["int8_values"],
             q["quantize_model"]["weights"],
             q["quantize_model"]["worst_weight_step"],
             q["quantize_model"]["logits_vs_fp32_rel_to_max"],
             res["ops"]["names"], q["quantize_s"], res["launches"],
             res["wall_s"], card), flush=True)
    if "profile" in q:
        pr = q["profile"]
        print("profile quant (b) int8 b%d eager forward: %.1f ms wall, "
              "device busy %.1f ms (%.1f%%), %d kernels; int8 GEMMs %.1f%% "
              "of busy; top: %s" % (
                  VISION_BATCH, pr["wall_ms"], pr["device_busy_ms"],
                  100 * pr["device_busy_share"], pr["kernels_launched"],
                  100 * pr["matched_share_of_busy"],
                  "; ".join("%s x%d %.2f ms" % (k["name"][:48], k["calls"],
                                                k["ms"])
                            for k in pr["top_kernels"][:6])), flush=True)


# the sparse phase: MXNet 1.6's example/sparse/linear_classification at
# Avazu's width, and the graph ops (item 8 step 6)
SPARSE_FEATURES = 1000001   # Avazu's hashed features, and one
SPARSE_FIELDS = 15          # nonzeros a row: one hashed feature a field
SPARSE_BATCH = 8192
SPARSE_STEPS = 20
SPARSE_SGD = {"learning_rate": 0.1, "wd": 1e-4}
SPARSE_CPU_ULPS = 4         # the weight vs the CPU's, in float32 ulps of
SPARSE_TRUTH_ULPS = 16      # the largest |weight|; vs float64 numpy
GRAPH_VERTICES = 20000
GRAPH_DEGREE = 8
GRAPH_PAIRS = 2000          # edge_id queries
GRAPH_SUBSET = 1000         # dgl_subgraph's vertices
GRAPH_SEEDS = 32            # a sampler's seed vertices (two seed arrays)
RRELU_SHAPE = (32, 64, 112, 112)   # ResNet-50's first activation


def _avazu_batches(torch, seed, dev):
    """Every step's CSR batch, made in bulk on ``dev``: one hashed column a
    field (the fields' ranges are disjoint, so a row's columns are sorted
    and distinct), value 1, and a 0/1 label; the weight from N(0, 0.01)."""
    g = torch.Generator(dev).manual_seed(seed)
    width = SPARSE_FEATURES // SPARSE_FIELDS
    cols = torch.arange(SPARSE_FIELDS, device=dev) * width + torch.randint(
        0, width, (SPARSE_STEPS, SPARSE_BATCH, SPARSE_FIELDS), generator=g,
        device=dev)
    labels = torch.randint(0, 2, (SPARSE_STEPS, SPARSE_BATCH, 1),
                           generator=g, device=dev).float()
    w0 = torch.randn((SPARSE_FEATURES, 1), generator=g, device=dev) * 0.01
    return cols, labels, w0


def _linear_steps(torch, cols, labels, w0, dev, timed=False):
    """``linear_classification``'s loop on ``dev``: ``dot(csr, w) + b``,
    the logistic loss, the row-sparse gradient ``dot(csr.T, g)`` and SGD's
    lazy update; the bias by the dense rule. ``w`` is a
    ``RowSparseNDArray`` that stores every row (the example's
    ``stype='row_sparse'`` weight from ``Normal``); the weight is returned
    as the dense tensor its payload (values at indices) makes."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import nd, optimizer
    from mxnet_tpu_torch.ndarray import sparse
    cols, labels = cols.to(dev), labels.to(dev)
    steps, batch, fields = cols.shape
    w = sparse.RowSparseNDArray(w0.to(dev).clone(),
                                torch.arange(w0.shape[0], device=dev),
                                tuple(w0.shape))
    b = torch.zeros(1, device=dev)
    opt = optimizer.SGD(lazy_update=True, **SPARSE_SGD)
    indptr = torch.arange(0, batch * fields + 1, fields, device=dev)
    ones = torch.ones(batch * fields, device=dev)
    rows = torch.full((), float(batch), device=dev)
    losses, events = [], []
    for s in range(steps):
        if timed:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        csr = sparse.CSRNDArray(ones, cols[s].reshape(-1), indptr,
                                (batch, SPARSE_FEATURES))
        z = sparse.dot(csr, w)._data + b
        losses.append(F.binary_cross_entropy_with_logits(z, labels[s]))
        gz = (torch.sigmoid(z) - labels[s]) / rows
        gw = sparse.dot(csr, nd.NDArray(gz), transpose_a=True,
                        forward_stype="row_sparse")
        opt.update(0, w, gw, None)
        opt.update(1, b, gz.sum(0), None)
    if timed:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    if w.stype != "row_sparse":
        fail("sparse (c): the weight's storage became %r" % w.stype)
    values, idx = w.data._data, w.indices._data
    stored = torch.zeros(tuple(w0.shape), dtype=values.dtype, device=dev)
    stored[idx] = values
    if not torch.equal(stored, w.tostype("default")._data):
        fail("sparse (c): the row-sparse weight's payload disagrees with "
             "its dense value after %d SGD steps" % steps)
    return stored, b, [float(v) for v in losses], ms


def _linear_truth(cols, labels, w0):
    """The same 20 steps in float64 numpy."""
    lr, wd = SPARSE_SGD["learning_rate"], SPARSE_SGD["wd"]
    w, b = w0.astype(np.float64).ravel(), 0.0
    for s in range(SPARSE_STEPS):
        idx, y = cols[s], labels[s].ravel().astype(np.float64)
        z = w[idx].sum(1) + b
        gz = (1.0 / (1.0 + np.exp(-z)) - y) / SPARSE_BATCH
        gw = np.zeros_like(w)
        np.add.at(gw, idx.ravel(), np.repeat(gz, SPARSE_FIELDS))
        touched = np.unique(idx)
        w[touched] -= lr * (gw[touched] + wd * w[touched])
        b -= lr * (gz.sum() + wd * b)
    return w


def sparse_linear(args, torch):
    """(c) the sparse linear classifier at Avazu's width: 20 steps on the
    card twice (bitwise repeat), on the CPU, and in float64 numpy."""
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cols, labels, w0 = _avazu_batches(torch, args.seed + 9, dev)
    _linear_steps(torch, cols[:2], labels[:2], w0, dev)   # warm-up
    w, b, losses, ms = _linear_steps(torch, cols, labels, w0, dev,
                                     timed=True)
    w2, _, _, _ = _linear_steps(torch, cols, labels, w0, dev)
    prof = profile(torch, lambda: _linear_steps(
        torch, cols[:1], labels[:1], w0, dev)) if args.profile else None
    wc, _, _, _ = _linear_steps(torch, cols, labels, w0, cpu)
    truth = _linear_truth(cols.cpu().numpy(), labels.cpu().numpy(),
                          w0.cpu().numpy())
    touched = torch.zeros(SPARSE_FEATURES, dtype=torch.bool, device=dev)
    touched[cols.reshape(-1)] = True
    ulp = float(np.spacing(np.float32(w.abs().max().item())))
    w64 = w.ravel().double().cpu()
    delta = w64 - w0.cpu().ravel().double()
    d_truth = torch.from_numpy(truth) - w0.cpu().ravel().double()
    res = {"features": SPARSE_FEATURES, "batch": SPARSE_BATCH,
           "weight_stype": "row_sparse", "payload_matches_dense": True,
           "nnz_per_row": SPARSE_FIELDS, "steps": SPARSE_STEPS,
           "sgd": dict(SPARSE_SGD), "losses": losses,
           "first_step_ms": ms[0], "step_ms": float(np.mean(ms[1:])),
           "touched_rows": int(touched.sum()),
           "repeat_bitwise": bool(torch.equal(w, w2)),
           "cpu_bitwise": bool(torch.equal(w.cpu(), wc)),
           "vs_cpu_ulps": float((w64 - wc.ravel().double()).abs().max())
           / ulp,
           "vs_float64_ulps": float((delta - d_truth).abs().max()) / ulp,
           "max_change": float(d_truth.abs().max()), "ulp": ulp,
           "untouched_unchanged": bool(torch.equal(w[~touched],
                                                   w0[~touched]))}
    if prof is not None:
        res["profile_one_step"] = prof
    if not (res["repeat_bitwise"] and res["untouched_unchanged"]
            and res["vs_cpu_ulps"] <= SPARSE_CPU_ULPS
            and res["vs_float64_ulps"] <= SPARSE_TRUTH_ULPS
            and all(np.isfinite(losses))):
        fail("sparse (c): %s" % {k: v for k, v in res.items()
                                 if k != "losses"})
    return res


def _graph(torch, seed, dev):
    """A random graph on ``dev``: ``GRAPH_DEGREE`` distinct neighbours a
    vertex (none itself), values 1-9."""
    from mxnet_tpu_torch.ndarray import sparse
    g = torch.Generator(dev).manual_seed(seed)
    n, d = GRAPH_VERTICES, GRAPH_DEGREE
    steps = torch.randint(1, (n - 1) // d, (n, d), generator=g, device=dev)
    nbrs = (torch.arange(n, device=dev)[:, None] + steps.cumsum(1)) % n
    nbrs = nbrs.sort(1).values
    vals = torch.randint(1, 10, (n * d,), generator=g, device=dev).float()
    indptr = torch.arange(0, n * d + 1, d, device=dev)
    return sparse.CSRNDArray(vals, nbrs.reshape(-1), indptr, (n, n)), g


def _graph_run(nd, csr, q, seed):
    out = {"edge_id": nd._contrib_edge_id(csr, q["u"], q["v"]),
           "getnnz": nd._contrib_getnnz(csr),
           "getnnz0": nd._contrib_getnnz(csr, axis=0),
           "getnnz1": nd._contrib_getnnz(csr, axis=1),
           "adjacency": nd._contrib_dgl_adjacency(csr),
           "subgraph": nd._contrib_dgl_subgraph(csr, q["subset"],
                                                return_mapping=True)}
    np.random.seed(seed)
    out["uniform"] = nd._contrib_dgl_csr_neighbor_uniform_sample(
        csr, q["seeds0"], q["seeds1"], num_hops=2, num_neighbor=4,
        max_num_vertices=500)
    np.random.seed(seed + 1)
    out["non_uniform"] = nd._contrib_dgl_csr_neighbor_non_uniform_sample(
        csr, q["prob"], q["seeds0"], num_hops=2, num_neighbor=4,
        max_num_vertices=500)
    verts, sub = out["uniform"][0], out["uniform"][2]
    out["compact"] = nd._contrib_dgl_graph_compact(
        sub, verts, graph_sizes=(int(verts.asnumpy()[-1]),))
    return out


def _graph_flat(v):
    items = v if isinstance(v, (tuple, list)) else (v,)
    res = []
    for a in items:
        res.append(a.asnumpy())
        if a.stype == "csr":
            res.extend(getattr(a, p).asnumpy()
                       for p in ("data", "indices", "indptr"))
    return res


def sparse_graph(args, torch):
    """(d) the seven graph names on a CSR graph held on the card against
    the same graph on the CPU (the samplers under the same numpy seeds)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray import sparse
    dev = torch.device("cuda")
    csr, g = _graph(torch, args.seed + 10, dev)
    n = GRAPH_VERTICES
    idx = lambda k: torch.randint(0, n, (k,), generator=g,  # noqa: E731
                                  device=dev)
    rows = idx(GRAPH_PAIRS // 2)
    hits = csr._csr_indices.reshape(n, GRAPH_DEGREE)[rows, 0]
    q = {"u": torch.cat([rows, idx(GRAPH_PAIRS // 2)]),
         "v": torch.cat([hits, idx(GRAPH_PAIRS // 2)]),
         "subset": torch.randperm(n, generator=g, device=dev)[:GRAPH_SUBSET],
         "seeds0": idx(GRAPH_SEEDS), "seeds1": idx(GRAPH_SEEDS),
         "prob": torch.rand(n, generator=g, device=dev)}
    t0 = time.perf_counter()
    card = _graph_run(nd, csr, {k: nd.NDArray(v) for k, v in q.items()},
                      args.seed)
    card_s = time.perf_counter() - t0
    with mx.cpu():
        d, i, p = csr._payload()
        host = sparse.CSRNDArray(d.cpu(), i.cpu(), p.cpu(), csr.shape)
        cpu = _graph_run(nd, host, {k: nd.NDArray(v.cpu())
                                    for k, v in q.items()}, args.seed)
    mism = []
    for k in card:
        a, b = _graph_flat(card[k]), _graph_flat(cpu[k])
        if len(a) != len(b) or any(x.dtype != y.dtype or x.shape != y.shape
                                   or not np.array_equal(x, y)
                                   for x, y in zip(a, b)):
            mism.append(k)
    if mism:
        fail("sparse (d): graph ops differ from the CPU: %s" % mism)
    on_card = all(a.ctx.device_type == "gpu" for v in card.values()
                  for a in (v if isinstance(v, tuple) else (v,)))
    if not on_card:
        fail("sparse (d): a graph op's result left the card")
    verts = card["uniform"][0].asnumpy()
    return {"vertices": n, "edges": n * GRAPH_DEGREE, "names": 7,
            "calls": len(card), "card_s": card_s,
            "sampled_vertices": int(verts[-1])}


def sparse_rrelu(args, torch):
    """(d) ``LeakyReLU`` rrelu in training on the card: slopes within
    their bounds with the right mean, the identity on positive inputs,
    one key one mask, and its gradient the drawn slope (``torch.randn``
    on the card makes exact zeros now and then: those take a slope, as
    ``x > 0`` is false for them)."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ops import registry as treg
    dev = torch.device("cuda")
    lo, hi = 0.125, 0.334
    g = torch.Generator(dev).manual_seed(args.seed + 11)
    x = torch.randn(RRELU_SHAPE, generator=g, device=dev)
    fn = treg.get_op("LeakyReLU").fn
    y = fn(x, act_type="rrelu", key=(3, 4), train=True)
    again = fn(x, act_type="rrelu", key=(3, 4), train=True)
    other = fn(x, act_type="rrelu", key=(3, 5), train=True)
    neg = ~(x > 0)       # the op's own test: x == 0 takes the slope too
    xn = nd.NDArray(x)
    xn.attach_grad()
    with autograd.record(train_mode=True):
        out = nd.LeakyReLU(xn, act_type="rrelu")
    out.backward()
    grad = xn.grad._data
    slopes = grad[neg].double()        # d(u * x)/dx = u, exactly
    res = {"shape": list(RRELU_SHAPE), "slope_min": float(slopes.min()),
           "slope_max": float(slopes.max()),
           "slope_mean": float(slopes.mean()),
           "positive_identity": bool(torch.equal(y[~neg], x[~neg])),
           "one_key_one_mask": bool(torch.equal(y, again)
                                    and not torch.equal(y, other)),
           "grad_is_slope": bool(torch.equal(grad[~neg],
                                             torch.ones_like(x[~neg]))
                                 and torch.equal(grad[neg] * x[neg],
                                                 out._data[neg]))}
    if not (res["positive_identity"] and res["one_key_one_mask"]
            and res["grad_is_slope"] and lo <= res["slope_min"]
            and res["slope_max"] < hi
            and abs(res["slope_mean"] - (lo + hi) / 2) < 1e-3):
        fail("sparse (d) rrelu: %s" % res)
    return res


def sparse_phase(args, torch):
    """The sparse phase, parts (c) and (d) (see the module docstring)."""
    t0 = time.perf_counter()
    fa0 = kernel_launches()
    out = {"linear": sparse_linear(args, torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["graph"] = sparse_graph(args, torch)
    out["rrelu"] = sparse_rrelu(args, torch)
    out["launches"] = {k: v - fa0[k] for k, v in kernel_launches().items()}
    if any(out["launches"].values()):
        fail("sparse: a flash kernel launched %s" % out["launches"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_sparse(res, card):
    """The sparse phase's lines of the output."""
    s, g, r = res["linear"], res["graph"], res["rrelu"]
    print("sparse (c) linear classification, Avazu width (%d features), "
          "CSR b%d x %d nonzeros a row, SGD lazy %s: %d steps, step %.3f ms "
          "(first %.3f); %d rows touched, untouched rows bitwise unchanged "
          "%s; repeat bitwise %s; vs CPU bitwise %s, %.3g ulps of max "
          "|w| (tol %d); vs float64 %.3g ulps (tol %d; the largest change "
          "%.3g, an ulp %.3g); losses %.5f -> %.5f [%s]"
          % (s["features"], s["batch"], s["nnz_per_row"], s["sgd"],
             s["steps"], s["step_ms"], s["first_step_ms"], s["touched_rows"],
             s["untouched_unchanged"], s["repeat_bitwise"], s["cpu_bitwise"],
             s["vs_cpu_ulps"], SPARSE_CPU_ULPS, s["vs_float64_ulps"],
             SPARSE_TRUTH_ULPS, s["max_change"], s["ulp"], s["losses"][0],
             s["losses"][-1], card), flush=True)
    if "profile_one_step" in s:
        pr = s["profile_one_step"]
        print("profile sparse (c) one step (with the weight's copy): %.2f ms "
              "wall, device busy %.3f ms (%.1f%%), %d kernels; top: %s" % (
                  pr["wall_ms"], pr["device_busy_ms"],
                  100 * pr["device_busy_share"], pr["kernels_launched"],
                  "; ".join("%s x%d %.3f ms" % (k["name"][:48], k["calls"],
                                                k["ms"])
                            for k in pr["top_kernels"][:6])), flush=True)
    print("sparse (d) graph ops on gpu(0), %d vertices, %d edges: %d names "
          "(%d calls) == the CPU bitwise, %.2f s on the card (host loops), "
          "%d vertices sampled; rrelu training at %s: slopes %.4f..%.4f mean "
          "%.4f, identity on x > 0, one key one mask, gradient the slope; "
          "flash launches %s; %.1f s [%s]"
          % (g["vertices"], g["edges"], g["names"], g["calls"], g["card_s"],
             g["sampled_vertices"], "x".join(map(str, r["shape"])),
             r["slope_min"], r["slope_max"], r["slope_mean"],
             res["launches"], res["wall_s"], card), flush=True)


# ---- mesh phase -------------------------------------------------------------

MESH_STEPS = 4
MESH_ADAM = {"learning_rate": 1e-4}
# (a): the mesh run computes the one-device step with its sums in another
# order (two half-batch means added, two replicas' gradients added), in
# fp32 with TF32 off. The limits are set from the sound runs' largest
# readings on an H100 (PERF.md §6) with room above them: the losses
# read 9.07e-8 relative, the parameters 1.78e-6 absolute, Adam's moments
# 1.11e-5 of each moment's largest magnitude. Adam moves an element by
# about lr a step whatever its gradient's size, so the parameters see a
# gradient scaled wrongly only where eps matters: the moments, held to the
# one-device run's, see the gradient's size. The two planted controls of
# ``_mesh_controls`` (replica 1's gradient left out; the gradient sum
# doubled) must break them.
MESH_LOSS_RTOL = 1e-6
MESH_PARAM_ATOL = 1e-5
MESH_STATE_RTOL = 1e-4
MESH_RING = (1, 4, 4096, 64)       # B, H, S, D (ring_attention_demo's)
MESH_RING_ATOL = 1e-4               # fp32 online softmax vs float64
MESH_MOE_STEPS = 3
MESH_MOE_RTOL = 1e-5
# (c): two replicas over dp and two over ep, so each MoE layer gathers the
# four replicas' tokens and routes the global pool
MESH_MOE_PLAN = "dp=2,pp=1,ep=2"
MESH_KV_SHAPE, MESH_KV_PUSHES = (1024, 1024), 4


def _mesh_lm(args, torch, batches=True):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import transformer_lm_base
    model = transformer_lm_base(vocab_size=32000, max_len=TRAIN_SEQ,
                                device=torch.device("cuda"))
    convert.load_mxnet_params(model, random_params(model, args.seed))
    if not batches:
        return model, None
    return model, [tuple(torch.from_numpy(a).cuda()
                         for a in lm_batch(args.seed + 40 + i))
                   for i in range(MESH_STEPS)]


def _mesh_steps(torch, tr, batches, first=0):
    return timed_steps(torch, lambda i: tr.step(*batches[first + i]),
                       len(batches) - first)


def _mesh_trainer(model, mesh):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import tp_rules
    from mxnet_tpu_torch.parallel import ShardedTrainer
    return ShardedTrainer(model, SoftmaxCrossEntropyLoss(), "adam",
                          MESH_ADAM, mesh=mesh, param_rules=tp_rules())


def _mesh_gaps(tr, want, want_states, losses, one_losses):
    """(a)'s comparison of a mesh run with the one-device run: the losses'
    largest relative gap, each parameter's largest absolute gap, each Adam
    moment's largest gap over the one-device moment's largest magnitude;
    and the limits broken (a gap that is not finite breaks its limit)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    param = {n: (v.full() - want[n]).abs().max().item()
             for n, v in tr.values.items()}
    state = {}
    for n, moments in tr.states.items():
        for k, (got, ref) in enumerate(zip(moments, want_states[n])):
            scale = ref.abs().max().item() or 1.0
            state["%s[%d]" % (n, k)] = \
                (got.full() - ref).abs().max().item() / scale
    worst_p = max(param, key=lambda n: (np.isnan(param[n]), param[n]))
    worst_s = max(state, key=lambda n: (np.isnan(state[n]), state[n]))
    gaps = {"loss_rel_gap": loss, "param_max_gap": param[worst_p],
            "param_max_gap_name": worst_p,
            "param_median_gap": float(np.median(list(param.values()))),
            "state_max_rel_gap": state[worst_s],
            "state_max_rel_gap_name": worst_s,
            "state_median_rel_gap": float(np.median(list(state.values())))}
    broken = []
    if not loss <= MESH_LOSS_RTOL:
        broken.append("losses %.3g > %g" % (loss, MESH_LOSS_RTOL))
    if not param[worst_p] <= MESH_PARAM_ATOL:
        broken.append("parameter %s %.3g > %g"
                      % (worst_p, param[worst_p], MESH_PARAM_ATOL))
    if not state[worst_s] <= MESH_STATE_RTOL:
        broken.append("Adam moment %s %.3g > %g"
                      % (worst_s, state[worst_s], MESH_STATE_RTOL))
    return gaps, broken


def _mesh_controls(torch, model, mesh, batches, want, want_states,
                   one_losses):
    """(a)'s planted faults, each through the phase's own comparison: the
    mesh trainer with replica 1's gradient left out of the sum, and with
    the gradient sum doubled. Each must break a limit."""
    def drop_replica_1(values):
        for v in values[1].values():
            if v.requires_grad:
                v.register_hook(torch.zeros_like)

    def double(values):
        for vals in values:
            for v in vals.values():
                if v.requires_grad:
                    v.register_hook(lambda g: g * 2)

    out = {}
    for name, plant in (("replica_1_gradient_left_out", drop_replica_1),
                        ("gradient_sum_doubled", double)):
        tr = _mesh_trainer(model, mesh)
        make = tr._replica_values

        def planted(devices, grad, make=make, plant=plant):
            values = make(devices, grad)
            plant(values)
            return values
        tr._replica_values = planted
        losses, _ = _mesh_steps(torch, tr, batches)
        gaps, broken = _mesh_gaps(tr, want, want_states, losses, one_losses)
        del tr
        if not broken:
            fail("mesh (a) control %s passed the comparison: %r"
                 % (name, gaps))
        out[name] = dict(gaps, broken=broken)
    torch.cuda.empty_cache()
    return out


def _mesh_lm_part(args, torch, tmp):
    """(a) and (d)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.parameter import collect_params
    from mxnet_tpu_torch.models import tp_rules
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import (ShardedTrainer, make_mesh,
                                          restore_checkpoint,
                                          save_checkpoint)
    model, batches = _mesh_lm(args, torch)
    one = ShardedTrainer(model, SoftmaxCrossEntropyLoss(), "adam",
                         MESH_ADAM, device=torch.device("cuda"))
    one_losses, one_ms = _mesh_steps(torch, one, batches)
    want = {n: v.detach().clone() for n, v in one.values.items()}
    want_states = {n: tuple(m.clone() for m in st)
                   for n, st in one.states.items()}
    del one
    torch.cuda.empty_cache()
    mesh = make_mesh(dp=2, tp=2, devices=[mx.gpu(0)] * 4)
    tr = _mesh_trainer(model, mesh)
    fa.reset_launches()
    first, ms = _mesh_steps(torch, tr, batches[:2])
    launches_half = kernel_launches()
    save_checkpoint(tr, os.path.join(tmp, "mesh_ckpt"))
    rest, ms2 = _mesh_steps(torch, tr, batches, first=2)
    launches = kernel_launches()
    by_layout = {"flash_attn_bwd_dq":
                 dict(fa.flash_attention_bwd_dq.launches_by_layout),
                 "flash_attn_bwd_dkv":
                 dict(fa.flash_attention_bwd_dkv.launches_by_layout)}
    losses = first + rest
    out = {"model": "transformer_lm_base", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": MESH_STEPS,
           "mesh": dict(mesh.shape), "devices": "gpu(0) x 4",
           "losses_mesh": losses, "losses_one": one_losses,
           "step_ms_mesh": ms + ms2, "step_ms_one": one_ms,
           "launches": launches, "launches_bwd_by_layout": by_layout,
           "launches_first_two": launches_half}
    expect = 2 * MESH_STEPS * model.num_layers
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        bshd = by_layout[name]["BSHD"] if name in by_layout \
            else launches[name]
        if bshd != expect:
            fail("mesh (a): %s launched %d times on (B, S, H, D), not 2 "
                 "replicas x %d steps x %d layers"
                 % (name, bshd, MESH_STEPS, model.num_layers))
    if launches["flash_attn_fwd_bhsd"] or any(
            v["BHSD"] for v in by_layout.values()):
        fail("mesh (a) launched a (B, H, S, D) kernel: %r %r"
             % (launches, by_layout))
    gaps, broken = _mesh_gaps(tr, want, want_states, losses, one_losses)
    out.update(gaps, param_atol=MESH_PARAM_ATOL, loss_rtol=MESH_LOSS_RTOL,
               state_rtol=MESH_STATE_RTOL)
    if broken:
        fail("mesh (a): the mesh run differs from the one-device run: %s"
             % "; ".join(broken))
    halves = []
    ref_names = list(collect_params(model).keys())
    rules = [r for r, _ in tp_rules()]
    import re as _re
    for (name, v), rname in zip(tr.values.items(), ref_names):
        if any(_re.search(r, rname) for r in rules):
            full = int(np.prod(v.shape))
            if not all(s.numel() * 2 == full for s in v.shards):
                fail("mesh (a): %s does not hold half a shard at each "
                     "position" % rname)
            halves.append(rname)
    out["tp_sharded"] = len(halves)
    if len(halves) != 2 + 4 * model.num_layers:
        fail("mesh (a): %d tp_rules parameters, expected %d"
             % (len(halves), 2 + 4 * model.num_layers))
    # (d) a fresh trainer from the checkpoint: steps 3-4 bit for bit
    fresh = _mesh_trainer(model, mesh)
    restore_checkpoint(fresh, os.path.join(tmp, "mesh_ckpt"))
    again, _ = _mesh_steps(torch, fresh, batches, first=2)
    same = again == rest and all(
        torch.equal(a.full(), b.full()) for a, b in
        zip(fresh.values.values(), tr.values.values()))
    if not same:
        fail("mesh (d): the restored run's steps 3-4 %r differ from the "
             "uninterrupted %r" % (again, rest))
    out["resumed_losses"] = again
    del tr
    torch.cuda.empty_cache()
    out["controls"] = _mesh_controls(torch, model, mesh, batches, want,
                                     want_states, one_losses)
    if args.profile:
        # after the checks: two more steps of each, under the profiler
        out["profile_mesh"] = profile(
            torch, lambda: _mesh_steps(torch, fresh, batches[:2]))
        one = ShardedTrainer(model, SoftmaxCrossEntropyLoss(), "adam",
                             MESH_ADAM, device=torch.device("cuda"))
        one.step(*batches[0])
        out["profile_one"] = profile(
            torch, lambda: _mesh_steps(torch, one, batches[:2]))
        del one
    del fresh, want, want_states
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    if n > 1:
        mesh = make_mesh(dp=2, tp=2, devices=[mx.gpu(i % n)
                                              for i in range(4)])
        tr = _mesh_trainer(model, mesh)
        l2, ms3 = _mesh_steps(torch, tr, batches)
        rel2 = max(abs(a - b) / abs(b) for a, b in zip(l2, one_losses))
        if not rel2 <= MESH_LOSS_RTOL:
            fail("mesh (a) over %d GPUs: losses %r vs %r" % (n, l2,
                                                             one_losses))
        out["distinct_gpus"] = {"devices": n, "losses": l2,
                                "step_ms": ms3, "loss_rel_gap": rel2}
        del tr
    else:
        out["distinct_gpus"] = "not run: 1 visible GPU"
    del model
    torch.cuda.empty_cache()
    return out


def _mesh_ring(args, torch):
    """(b)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import make_mesh, ring_attention_sharded
    B, H, S, D = MESH_RING
    g = torch.Generator().manual_seed(args.seed + 50)
    q, k, v = (torch.randn((B, H, S, D), generator=g).cuda()
               for _ in range(3))
    mesh = make_mesh(dp=1, sp=4, devices=[mx.gpu(0)] * 4)
    out = {"shape": MESH_RING, "mesh": dict(mesh.shape)}
    for causal in (False, True):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got = ring_attention_sharded(q, k, v, mesh, causal=causal)
        e1.record()
        torch.cuda.synchronize()
        q64, k64, v64 = (t.double() for t in (q, k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q64, k64) / np.sqrt(D)
        if causal:
            s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool,
                                          device=s.device).tril(), -np.inf)
        want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v64)
        err = (got.double() - want).abs().max().item()
        del s, want
        if not err <= MESH_RING_ATOL:
            fail("mesh (b) causal=%s: ring attention off by %g (> %g)"
                 % (causal, err, MESH_RING_ATOL))
        out["causal" if causal else "full"] = {
            "max_abs_err": err, "ms": e0.elapsed_time(e1)}
    torch.cuda.empty_cache()
    return out


def _mesh_moe(args, torch):
    """(c)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import initializer, nd
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import moe_lm_tiny
    from mxnet_tpu_torch.parallel import ShardedTrainer, plan_sharding

    def net():
        trandom.seed(args.seed)
        np.random.seed(args.seed)
        with mx.gpu(0):
            m = moe_lm_tiny()
            m.initialize(initializer.Xavier())
            m(nd.zeros((1, 4), dtype="int32"))
        return m
    rng = np.random.default_rng(args.seed + 60)
    batches = [(torch.from_numpy(rng.integers(0, 64, (8, 16))).cuda(),
                torch.from_numpy(rng.integers(0, 64, (8, 16))).float()
                .cuda()) for _ in range(MESH_MOE_STEPS)]
    first = net()
    plan = plan_sharding(4, first.profile(batch=8, seq=16),
                         force=MESH_MOE_PLAN)
    runs, replicas = {}, None
    for kind in ("plan", "one"):
        kw = {"plan": plan, "device": torch.device("cuda")} \
            if kind == "plan" else {"device": torch.device("cuda")}
        tr = ShardedTrainer(first if kind == "plan" else net(),
                            SoftmaxCrossEntropyLoss(), "adam",
                            {"learning_rate": 1e-2}, **kw)
        if kind == "plan":
            replicas = len(tr._replica_devices())
            if replicas != 4:
                fail("mesh (c): plan %s ran %d replicas, not dp x ep = 4"
                     % (plan.describe(), replicas))
        runs[kind] = [float(tr.step(x, y)) for x, y in batches]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["plan"],
                                                  runs["one"]))
    if not rel <= MESH_MOE_RTOL:
        fail("mesh (c): plan %s losses %r vs one device %r (rel %g)"
             % (plan.describe(), runs["plan"], runs["one"], rel))
    return {"plan": plan.describe(), "replicas": replicas,
            "losses_plan": runs["plan"], "losses_one": runs["one"],
            "loss_rel_gap": rel}


def _mesh_subgraph(args, torch, tmp):
    """(e)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch import random as trandom
    net = _resnet50(torch, trandom, args.seed)
    prefix = os.path.join(tmp, "resnet50_v1")
    net.export(prefix)
    del net
    symbol, arg_p, aux_p = mx.model.load_checkpoint(prefix, 0,
                                                    ctx=mx.gpu(0))
    x = torch.rand((VISION_BATCH, 3, VISION_IMAGE, VISION_IMAGE),
                   generator=torch.Generator().manual_seed(args.seed)).cuda()
    out, results = {}, {}
    for tag, backend in (("plain", None), ("partitioned", "TPU_ELEMWISE")):
        if backend:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = backend
        try:
            args_ = dict(arg_p)
            args_["data"] = nd.NDArray(torch.zeros_like(x))
            ex = symbol.bind(mx.gpu(0), args_, aux_states=dict(aux_p),
                             grad_req="null")
        finally:
            os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        xn = nd.NDArray(x)
        results[tag] = ex.forward(data=xn)[0]._data.clone()   # capture
        replay = ex.forward(data=xn)[0]._data
        if not torch.equal(replay, results[tag]):
            fail("mesh (e) %s: replay differs from the first forward" % tag)
        out[tag] = {"replay_ms": _events_ms(
            torch, lambda: ex.forward(data=xn), SYMBOL_REPLAYS),
            "regions": sum(1 for n in ex._symbol._toposort()
                           if n._attr.get("__subgraph__"))}
        del ex
    if not out["partitioned"]["regions"]:
        fail("mesh (e): MXNET_SUBGRAPH_BACKEND made no region")
    if not torch.equal(results["plain"], results["partitioned"]):
        fail("mesh (e): the partitioned bind's output differs (max |diff| "
             "%g)" % (results["plain"] - results["partitioned"]).abs().max())
    out["bitwise_equal"] = True
    torch.cuda.empty_cache()
    return out


def _mesh_kvstore(args, torch):
    """(f)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    g = torch.Generator().manual_seed(args.seed + 70)
    pushes = [[torch.randn(MESH_KV_SHAPE, generator=g) * 0.1
               for _ in range(2)] for _ in range(MESH_KV_PUSHES)]
    pulled = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        kv = mx.kvstore.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.05})
        with ctx:
            kv.init(0, nd.zeros(MESH_KV_SHAPE, ctx=ctx))
            got = []
            for copies in pushes:
                kv.push(0, [nd.NDArray(c.to(ctx.torch_device))
                            for c in copies])
                o = nd.zeros(MESH_KV_SHAPE, ctx=ctx)
                kv.pull(0, out=o)
                got.append(o._data.cpu())
        pulled[str(ctx)] = torch.stack(got)
    card, cpu = pulled["gpu(0)"], pulled["cpu(0)"]
    if not torch.equal(card, cpu):
        fail("mesh (f): the 2bit device store on the card differs from the "
             "CPU (max |diff| %g)" % (card - cpu).abs().max())
    return {"pushes": MESH_KV_PUSHES, "shape": MESH_KV_SHAPE,
            "bitwise_equal": True,
            "levels": sorted(set(card[0].unique().tolist()))}


def mesh_phase(args, torch):
    """(a)-(f): distribution inside one process on the card."""
    import tempfile
    t0 = time.perf_counter()
    out = {"device_count": torch.cuda.device_count()}
    with tempfile.TemporaryDirectory() as tmp:
        out["lm"] = _mesh_lm_part(args, torch, tmp)
        out["ring"] = _mesh_ring(args, torch)
        out["moe"] = _mesh_moe(args, torch)
        out["subgraph"] = _mesh_subgraph(args, torch, tmp)
    out["kvstore"] = _mesh_kvstore(args, torch)
    out["launches"] = out["lm"]["launches"]
    out["launches_bwd_by_layout"] = out["lm"]["launches_bwd_by_layout"]
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_mesh(res, card):
    """The mesh phase's lines of the output."""
    a = res["lm"]
    print("mesh: torch.cuda.device_count() = %d; (a) transformer_lm_base "
          "b%d s%d fp32 Adam over %s (%s): %.2f ms a step (one device "
          "%.2f ms); losses %s vs one device %s (rel gap %.3g, rtol %g); "
          "params max gap %.3g (%s, atol %g), median %.3g; Adam moments max "
          "gap %.3g of their max (%s, rtol %g), median %.3g; %d tp_rules "
          "params at half a shard; launches %s, backward by layout %s; "
          "distinct GPUs: %s [%s]" % (
              res["device_count"], a["batch"], a["seq"], a["mesh"],
              a["devices"], float(np.mean(a["step_ms_mesh"][1:])),
              float(np.mean(a["step_ms_one"][1:])),
              ", ".join("%.5f" % v for v in a["losses_mesh"]),
              ", ".join("%.5f" % v for v in a["losses_one"]),
              a["loss_rel_gap"], a["loss_rtol"], a["param_max_gap"],
              a["param_max_gap_name"], a["param_atol"],
              a["param_median_gap"], a["state_max_rel_gap"],
              a["state_max_rel_gap_name"], a["state_rtol"],
              a["state_median_rel_gap"], a["tp_sharded"], a["launches"],
              a["launches_bwd_by_layout"], a["distinct_gpus"], card),
          flush=True)
    for name, c in a["controls"].items():
        print("mesh: (a) control %s: loss gap %.3g, params max gap %.3g "
              "(%s), Adam moments max gap %.3g (%s); broke: %s [%s]" % (
                  name, c["loss_rel_gap"], c["param_max_gap"],
                  c["param_max_gap_name"], c["state_max_rel_gap"],
                  c["state_max_rel_gap_name"], "; ".join(c["broken"]),
                  card), flush=True)
    r, m, e, k = res["ring"], res["moe"], res["subgraph"], res["kvstore"]
    print("mesh: (b) ring attention %s over sp=4: full max err %.3g (%.2f "
          "ms), causal %.3g (%.2f ms) vs float64; (c) moe_lm_tiny plan %s "
          "(%d replicas) losses %s vs one device (rel gap %.3g); (d) "
          "resumed steps 3-4 %s bitwise; (e) resnet50_v1 b%d TPU_ELEMWISE "
          "%d regions, bitwise; replay %.3f ms partitioned vs %.3f ms "
          "plain; (f) 2bit device kvstore card == CPU bitwise (levels %s); "
          "%.1f s [%s]" % (
              r["shape"], r["full"]["max_abs_err"], r["full"]["ms"],
              r["causal"]["max_abs_err"], r["causal"]["ms"], m["plan"],
              m["replicas"], ", ".join("%.5f" % v for v in m["losses_plan"]),
              m["loss_rel_gap"], ", ".join("%.5f" % v
                                           for v in a["resumed_losses"]),
              VISION_BATCH, e["partitioned"]["regions"],
              e["partitioned"]["replay_ms"], e["plain"]["replay_ms"],
              k["levels"], res["wall_s"], card), flush=True)


DIST_RANKS = 2
DIST_DEVICE = "cuda"
DIST_STEPS = 4
DIST_CONTROLS = ("rank_1_push_left_out", "cross_process_sum_doubled")
# (a) against one context at b32: the same sums in another order (each
# rank's half-batch gradient, then their sum), fp32, TF32 off. The limits
# come from the readings on an H100 (PERF.md §6): losses 4.54e-8 relative,
# parameters 1.78e-6, moments 1.11e-5 of each moment's largest magnitude,
# as the mesh phase read them; both planted controls must break them.
DIST_LOSS_RTOL = 1e-6
DIST_PARAM_ATOL = 1e-5
DIST_STATE_RTOL = 1e-4
# (c): the elastic drills' replicas
DIST_EL_LAYERS, DIST_EL_STEPS, DIST_EL_EVERY, DIST_EL_FAIL = 2, 6, 2, 3
# the SIGTERM drill's steps; every drill step lasts at least
# DIST_EL_SLOW_MS, so the survivor is mid-run when its peer goes
DIST_EL_TERM_STEPS, DIST_EL_SLOW_MS = 8, 300
DIST_EL_MODEL = "lm"
# the grace of a SIGTERM, both the supervisor's before its SIGKILL and the
# workers' emergency checkpoint (a 768 MB checkpoint beside another drill)
DIST_EL_GRACE_MS = 60000
# (d)
DIST_GUARD_STEPS, DIST_GUARD_POISON, DIST_GUARD_SCALE = 6, 3, 2.0 ** 15
DIST_TIMEOUT_S = 600


def _repo():
    return os.path.dirname(os.path.abspath(__file__))


def _dist_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo() + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _launches_by_layout():
    """Every flash wrapper's launches, the backward ones by layout."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    out = kernel_launches()
    for name, w in (("flash_attn_bwd_dq", fa.flash_attention_bwd_dq),
                    ("flash_attn_bwd_dkv", fa.flash_attention_bwd_dkv)):
        out[name + "_bhsd"] = w.launches_by_layout["BHSD"]
        out[name] = w.launches_by_layout["BSHD"]
    return out


def _dist_lm(args, torch, kvstore):
    """(a)'s model (the mesh phase's weights) and its ``gluon.Trainer``."""
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    model, _ = _mesh_lm(args, torch, batches=False)
    params = list(collect_params(model).values())
    return model, params, Trainer(params, "adam", dict(MESH_ADAM),
                                  kvstore=kvstore)


def _dist_loss(torch, model, x, y):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    losses = SoftmaxCrossEntropyLoss()(model(x), y)
    losses.backward(torch.ones_like(losses))
    return float(losses.detach().float().mean())


def _dist_state(tr, params, device="cpu"):
    """The trained values and Adam moments by parameter name, copied to
    ``device``."""
    states = tr._updaters[0].states
    return {"params": {p.name: p.tensor().detach().to(device, copy=True)
                       for p in params},
            "moments": {p.name: tuple(m.detach().to(device, copy=True)
                                      for m in states[i])
                        for i, p in enumerate(params)}}


def _dist_digest(state):
    import hashlib
    h = hashlib.sha256()
    for n in sorted(state["params"]):
        h.update(state["params"][n].numpy().tobytes())
        for m in state["moments"][n]:
            h.update(m.numpy().tobytes())
    return h.hexdigest()


def dist_worker(args, torch):
    """One rank of the dist phase's (b) and (a), started by the launcher:
    the kvstore invariants on CUDA tensors, then (a)'s run and its two
    planted controls. Writes ``$DIST_OUT/rank<r>.json`` and, on rank 0,
    each run's parameters and moments (``<run>.pt``)."""
    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import _process
    out_dir = os.environ["DIST_OUT"]
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    os.environ["DIST_DEVICE"] = DIST_DEVICE
    sys.path.insert(0, os.path.join(_repo(), "tests", "dist_torch"))
    import dist_sync_kvstore_worker
    t0 = time.perf_counter()
    dist_sync_kvstore_worker.main()        # joins the launcher's job
    res = {"rank": rank, "world": _process.size(),
           "backend": _process.backend(), "kvstore_s":
           time.perf_counter() - t0, "runs": {}}
    half = TRAIN_BATCH // DIST_RANKS
    rows = slice(rank * half, (rank + 1) * half)
    batches = [tuple(torch.from_numpy(a[rows]).to(DIST_DEVICE) for a in
                     lm_batch(args.seed + 40 + i)) for i in range(DIST_STEPS)]
    real = kvs._cross_process_allreduce
    plants = {"sum": real,
              "rank_1_push_left_out":
                  lambda x: real(torch.zeros_like(x) if rank == 1 else x),
              "cross_process_sum_doubled": lambda x: real(x) * 2}
    for run in ("sum",) + DIST_CONTROLS:
        kvs._cross_process_allreduce = plants[run]
        model, params, tr = _dist_lm(args, torch, "dist_sync")
        fa.reset_launches()
        losses, ms, ar_ms, ar_bytes = [], [], [], []
        for x, y in batches:
            torch.cuda.synchronize()
            s0, t0 = _process.stats(), time.perf_counter()
            losses.append(_dist_loss(torch, model, x, y))
            tr.step(TRAIN_BATCH)
            torch.cuda.synchronize()
            s1 = _process.stats()
            ms.append((time.perf_counter() - t0) * 1e3)
            ar_ms.append((s1["allreduce_s"] - s0["allreduce_s"]) * 1e3)
            ar_bytes.append(s1["allreduce_bytes"] - s0["allreduce_bytes"])
        state = _dist_state(tr, params)
        res["runs"][run] = {"losses": losses, "step_ms": ms,
                            "allreduce_ms": ar_ms,
                            "allreduce_bytes": ar_bytes,
                            "launches": _launches_by_layout(),
                            "digest": _dist_digest(state),
                            "kvstore": tr._kvstore.type,
                            "num_workers": tr._kvstore.num_workers}
        if rank == 0:
            torch.save(state, os.path.join(out_dir, "%s.pt" % run))
        del model, params, tr, state
        gc.collect()
        torch.cuda.empty_cache()
    kvs._cross_process_allreduce = real
    _process.barrier()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    print("dist worker rank %d OK" % rank, flush=True)
    return 0


def _dist_gaps(got, want, losses, want_losses):
    """(a)'s comparison with the b32 run: the losses' largest relative gap,
    each parameter's largest absolute gap, each Adam moment's largest gap
    over the b32 moment's largest magnitude; the limits broken (a gap that
    is not finite breaks its limit)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    param = {n: (got["params"][n] - v).abs().max().item()
             for n, v in want["params"].items()}
    state = {}
    for n, moments in want["moments"].items():
        for k, (g, ref) in enumerate(zip(got["moments"][n], moments)):
            scale = ref.abs().max().item() or 1.0
            state["%s[%d]" % (n, k)] = \
                (g - ref).abs().max().item() / scale
    worst_p = max(param, key=lambda n: (np.isnan(param[n]), param[n]))
    worst_s = max(state, key=lambda n: (np.isnan(state[n]), state[n]))
    gaps = {"loss_rel_gap": loss, "param_max_gap": param[worst_p],
            "param_max_gap_name": worst_p,
            "param_median_gap": float(np.median(list(param.values()))),
            "state_max_rel_gap": state[worst_s],
            "state_max_rel_gap_name": worst_s,
            "state_median_rel_gap": float(np.median(list(state.values())))}
    broken = []
    if not loss <= DIST_LOSS_RTOL:
        broken.append("losses %.3g > %g" % (loss, DIST_LOSS_RTOL))
    if not param[worst_p] <= DIST_PARAM_ATOL:
        broken.append("parameter %s %.3g > %g"
                      % (worst_p, param[worst_p], DIST_PARAM_ATOL))
    if not state[worst_s] <= DIST_STATE_RTOL:
        broken.append("Adam moment %s %.3g > %g"
                      % (worst_s, state[worst_s], DIST_STATE_RTOL))
    return gaps, broken


def _dist_bitwise(got, want):
    """The names whose parameter or moments differ in any bit."""
    def equal(a, b):
        return a.shape == b.shape and bool((a == b).all()) and \
            a.dtype == b.dtype

    out = [n for n, v in want["params"].items()
           if not equal(got["params"][n], v)]
    out += ["%s[moments]" % n for n, ms in want["moments"].items()
            if not all(equal(a, b) for a, b in zip(got["moments"][n], ms))]
    return out


def _dist_oracles(args, torch):
    """(a)'s two one-process runs: the halves in turn (their gradients
    summed rank 0's plus rank 1's) and one context at b32; each's
    losses (per half, and the b32 mean), step ms and final state."""
    half = TRAIN_BATCH // DIST_RANKS
    full = [tuple(torch.from_numpy(a).to(DIST_DEVICE) for a in
                  lm_batch(args.seed + 40 + i)) for i in range(DIST_STEPS)]
    out = {}
    model, params, tr = _dist_lm(args, torch, None)
    losses, ms = [], []
    for x, y in full:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pair = []
        for r in range(DIST_RANKS):
            rows = slice(r * half, (r + 1) * half)
            pair.append(_dist_loss(torch, model, x[rows], y[rows]))
            if r == 0:
                g0 = [p.grad_tensor().clone() for p in params]
        with torch.no_grad():
            for p, g in zip(params, g0):
                grad = p.grad_tensor()
                grad.copy_(g + grad)
        tr.step(TRAIN_BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(pair)
    out["in_turn"] = {"losses": losses, "step_ms": ms,
                      "state": _dist_state(tr, params, DIST_DEVICE)}
    del model, params, tr
    torch.cuda.empty_cache()
    model, params, tr = _dist_lm(args, torch, None)
    losses, ms = [], []
    for x, y in full:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_dist_loss(torch, model, x, y))
        tr.step(TRAIN_BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["b32"] = {"losses": losses, "step_ms": ms,
                  "state": _dist_state(tr, params, DIST_DEVICE)}
    del model, params, tr
    torch.cuda.empty_cache()
    return out


def _dist_workers(args, tmp):
    """(a) and (b)'s workers: two ranks through the launcher; their
    results."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(DIST_RANKS), "--coordinator", "127.0.0.1:%d" % _free_port(),
           sys.executable, os.path.abspath(__file__), "--dist-worker",
           "--seed", str(args.seed)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=_dist_env(DIST_OUT=tmp), cwd=_repo(),
                          capture_output=True, text=True,
                          timeout=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail("dist (a)/(b): the workers failed (rc %d):\n%s\n%s"
             % (proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(tmp, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    return {"workers_wall_s": wall, "ranks_raw": ranks,
            "backend_line": [ln for ln in proc.stdout.splitlines()
                             if ln.startswith("parallel.initialize")]}


def _dist_training(torch, tmp, workers, oracles):
    """(a)'s checks: the workers' results against the in-turn and b32
    runs, the controls, the launches."""
    ranks = workers.pop("ranks_raw")
    out = dict(workers, backend=ranks[0]["backend"],
               kvstore_checks_s=[w["kvstore_s"] for w in ranks])
    if [w["backend"] for w in ranks] != ["gloo"] * DIST_RANKS or \
            any(w["world"] != DIST_RANKS for w in ranks):
        fail("dist (a): not a gloo world of %d: %r" % (DIST_RANKS, ranks))
    for w in ranks:
        run = w["runs"]["sum"]
        if run["kvstore"] != "dist_sync" or \
                run["num_workers"] != DIST_RANKS:
            fail("dist (a): rank %d's store %r" % (w["rank"], run))
    if ranks[0]["runs"]["sum"]["digest"] != ranks[1]["runs"]["sum"]["digest"]:
        fail("dist (a): the two ranks' parameters and moments differ")
    turn, b32 = oracles["in_turn"], oracles["b32"]
    got = torch.load(os.path.join(tmp, "sum.pt"), map_location=DIST_DEVICE)
    r0 = ranks[0]["runs"]["sum"]
    out["in_turn_bitwise_mismatches"] = _dist_bitwise(got, turn["state"])
    out["in_turn_losses_equal"] = r0["losses"] == [p[0] for p in
                                                   turn["losses"]]
    if out["in_turn_bitwise_mismatches"] or not out["in_turn_losses_equal"]:
        fail("dist (a): rank 0 differs from the in-turn run: %s; losses "
             "%r vs %r" % (out["in_turn_bitwise_mismatches"][:8],
                           r0["losses"], turn["losses"]))
    mean = [(a + b) / 2 for a, b in zip(ranks[0]["runs"]["sum"]["losses"],
                                        ranks[1]["runs"]["sum"]["losses"])]
    gaps, broken = _dist_gaps(got, b32["state"], mean, b32["losses"])
    out.update(b32_gaps=gaps, loss_rtol=DIST_LOSS_RTOL,
               param_atol=DIST_PARAM_ATOL, state_rtol=DIST_STATE_RTOL)
    if broken:
        fail("dist (a): the 2-process run differs from one context at b32: "
             "%s" % "; ".join(broken))
    del got
    out["controls"] = {}
    for name in DIST_CONTROLS:
        c = torch.load(os.path.join(tmp, "%s.pt" % name),
                       map_location=DIST_DEVICE)
        cm = [(a + b) / 2 for a, b in zip(ranks[0]["runs"][name]["losses"],
                                          ranks[1]["runs"][name]["losses"])]
        cg, cb = _dist_gaps(c, b32["state"], cm, b32["losses"])
        if not cb:
            fail("dist (a) control %s passed the comparison: %r" % (name, cg))
        out["controls"][name] = dict(cg, broken=cb,
                                     in_turn_bitwise_mismatches=len(
                                         _dist_bitwise(c, turn["state"])))
        del c
    layers = 12
    for w in ranks:
        launches = w["runs"]["sum"]["launches"]
        for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkv"):
            if launches[k] != DIST_STEPS * layers:
                fail("dist (a): rank %d launched %s %d times, not %d steps "
                     "x %d layers" % (w["rank"], k, launches[k], DIST_STEPS,
                                      layers))
        if any(launches[k] for k in ("flash_attn_fwd_bhsd",
                                     "flash_attn_bwd_dq_bhsd",
                                     "flash_attn_bwd_dkv_bhsd")):
            fail("dist (a): rank %d launched a (B, H, S, D) kernel: %r"
                 % (w["rank"], launches))
    out["ranks"] = [{"rank": w["rank"], "launches": w["runs"]["sum"][
        "launches"], "step_ms": w["runs"]["sum"]["step_ms"],
        "allreduce_ms": w["runs"]["sum"]["allreduce_ms"],
        "allreduce_bytes": w["runs"]["sum"]["allreduce_bytes"],
        "losses": w["runs"]["sum"]["losses"]} for w in ranks]
    out["launches"] = {k: sum(w["runs"]["sum"]["launches"][k] for w in ranks)
                       for k in ranks[0]["runs"]["sum"]["launches"]}
    out["step_ms_2proc"] = float(np.mean(r0["step_ms"][1:]))
    out["step_ms_in_turn"] = float(np.mean(turn["step_ms"][1:]))
    out["step_ms_b32"] = float(np.mean(b32["step_ms"][1:]))
    out["allreduce_ms"] = float(np.mean(r0["allreduce_ms"][1:]))
    out["allreduce_bytes"] = r0["allreduce_bytes"][-1]
    out["losses_b32"] = b32["losses"]
    out["losses_2proc_mean"] = mean
    return out


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kill_rank1(rdzv, box):
    """(c)'s eviction notice: SIGTERM to rank 1 once both ranks made 2
    steps (rank 0 then holds a checkpoint to resume from)."""
    import signal

    def record(rank):
        try:
            with open(os.path.join(rdzv, "member-%05d.json" % rank)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while time.monotonic() < deadline:
        r0, r1 = record(0), record(1)
        if r1.get("status") == "up" and r1.get("step", 0) >= 2 and \
                r0.get("step", 0) >= 2:
            os.kill(r1["pid"], signal.SIGTERM)
            box["pid"] = r1["pid"]
            return
        time.sleep(0.05)


def _dist_uninterrupted(torch):
    """(c)'s reference: the replica trained straight through, in this
    process (losses, and the parameters' digest after each drill's
    steps)."""
    sys.path.insert(0, os.path.join(_repo(), "tests", "dist_torch"))
    import elastic_worker
    from mxnet_tpu_torch import random as trandom
    trainer, batches, _ = elastic_worker.build(DIST_EL_MODEL, DIST_EL_LAYERS)
    losses, digests = [], {}
    for x, y in batches(DIST_EL_TERM_STEPS):
        trandom.seed(trainer._t + 1)
        losses.append(float(trainer.step(x, y)))
        if trainer._t in (DIST_EL_STEPS, DIST_EL_TERM_STEPS):
            digests[trainer._t] = elastic_worker.digest(trainer)
    out = {"losses": losses, "params_sha256": digests}
    del trainer
    torch.cuda.empty_cache()
    return out


def _drill_env(**extra):
    return _dist_env(ELASTIC_MODEL=DIST_EL_MODEL,
                     ELASTIC_LM_LAYERS=DIST_EL_LAYERS,
                     ELASTIC_CKPT_EVERY=DIST_EL_EVERY,
                     ELASTIC_STEP_SLOW_MS=DIST_EL_SLOW_MS,
                     MXNET_ELASTIC_GRACE_MS=DIST_EL_GRACE_MS, **extra)


def _dist_drills_start(tmp):
    """(c): the host-loss and SIGTERM drills, started at once (they run
    while this process checks (a))."""
    worker = os.path.join(_repo(), "tests", "dist_torch", "elastic_worker.py")
    drills = {"host_loss": dict(ELASTIC_FAIL_RANK=1,
                                ELASTIC_FAIL_STEP=DIST_EL_FAIL,
                                ELASTIC_FAIL_KIND="host_loss",
                                ELASTIC_FAIL_AFTER_PEER=1,
                                ELASTIC_STEPS=DIST_EL_STEPS),
              "sigterm": dict(ELASTIC_STEPS=DIST_EL_TERM_STEPS)}
    procs = {}
    for name, extra in drills.items():
        work = os.path.join(tmp, name)
        os.makedirs(os.path.join(work, "rdzv"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
             "2", "--supervise", "--max-restarts", "0", "--rdzv-dir",
             os.path.join(work, "rdzv"), "--event-log",
             os.path.join(work, "events.jsonl"), "--grace-ms",
             str(DIST_EL_GRACE_MS), sys.executable, worker],
            env=_drill_env(ELASTIC_WORKDIR=work, **extra), cwd=_repo(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}
    killer = threading.Thread(target=_kill_rank1, daemon=True, args=(
        os.path.join(tmp, "sigterm", "rdzv"), box))
    killer.start()
    return {"tmp": tmp, "worker": worker, "drills": drills, "procs": procs,
            "box": box, "killer": killer, "t0": time.perf_counter()}


def _stop_drills(d):
    """Stop every supervisor still running (SIGTERM: it tears its workers
    down), then kill what is left."""
    import signal
    for p in d["procs"].values():
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in d["procs"].values():
        try:
            p.communicate(timeout=DIST_EL_GRACE_MS / 1e3 + 10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()


def _drill_result(name, rc, stdout, stderr, d):
    if rc != 0:
        fail("dist (c) %s: the supervised run failed (rc %d):\n%s\n%s"
             % (name, rc, stdout[-3000:], stderr[-3000:]))
    work = os.path.join(d["tmp"], name)
    with open(os.path.join(work, "events.jsonl")) as f:
        evs = [json.loads(ln) for ln in f]
    failed = next((e for e in evs if e["event"] == "worker_failed"), None)
    if failed is None:
        fail("dist (c) %s: no worker failed: %r\n%s" % (
            name, [e["event"] for e in evs], stdout[-3000:]))
    with open(os.path.join(work, "out", "result_gen1_rank0.json")) as f:
        res = json.load(f)
    out = {"worker_failed": failed,
           "evicted": next(e for e in evs if e["event"] == "evicted"),
           "events": [e["event"] for e in evs], "gen1": res,
           "preempted_lines": [ln for ln in stdout.splitlines()
                               if "preempted at step" in ln]}
    want = (1, 137, "host_loss") if name == "host_loss" else \
        (1, 75, "preempted")
    got = (failed["rank"], failed["rc"], failed["reason"])
    if got != want or "run_complete" not in out["events"] or \
            res["world"] != 1 or \
            res["end_step"] != d["drills"][name]["ELASTIC_STEPS"]:
        fail("dist (c) %s: %r, events %r, generation 1 %r"
             % (name, got, out["events"], res))
    return out


def _dist_drills_finish(torch, d):
    """(c)'s checks: each drill's run; a fresh process's replay of the
    host-loss run's restored checkpoint (started as soon as that drill
    ends); an uninterrupted run in this process."""
    tmp, out, replay = d["tmp"], {}, None
    try:
        pending = dict(d["procs"])
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while pending and time.monotonic() < deadline:
            for name, p in list(pending.items()):
                if p.poll() is None:
                    continue
                stdout, stderr = p.communicate()
                del pending[name]
                out[name] = _drill_result(name, p.returncode, stdout,
                                          stderr, d)
                if name == "host_loss":
                    ref = os.path.join(tmp, "replay")
                    os.makedirs(os.path.join(ref, "ckpt-rank0"))
                    shutil.copytree(os.path.join(tmp, "host_loss", "out",
                                                 "restored_gen1_rank0"),
                                    os.path.join(ref, "ckpt-rank0",
                                                 "resume_ckpt"))
                    replay = subprocess.Popen(
                        [sys.executable, d["worker"]], cwd=_repo(),
                        env=_drill_env(ELASTIC_WORKDIR=ref,
                                       MXTPU_GENERATION=1,
                                       ELASTIC_STEPS=DIST_EL_STEPS),
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True)
            time.sleep(0.1)
        if pending:
            fail("dist (c): the drills %s did not end in %d s"
                 % (sorted(pending), DIST_TIMEOUT_S))
        out["drills_wall_s"] = time.perf_counter() - d["t0"]
        _, rerr = replay.communicate(timeout=DIST_TIMEOUT_S)
        if replay.returncode != 0:
            fail("dist (c): the replay failed:\n%s" % rerr[-3000:])
    finally:
        _stop_drills(d)
        if replay is not None and replay.poll() is None:
            replay.kill()
            replay.communicate()
    d["killer"].join(5)
    out["sigterm_pid"] = d["box"].get("pid")
    if out["sigterm_pid"] is None:
        fail("dist (c): rank 1 of the SIGTERM drill never made 2 steps")
    lines = out["sigterm"]["preempted_lines"]
    left = [float(ln.split("(")[1].split(" ms")[0]) for ln in lines
            if "ms of grace left" in ln]
    if not left or min(left) <= 0:
        fail("dist (c) sigterm: no emergency checkpoint inside the grace "
             "window: %r" % lines)
    out["sigterm"]["grace_left_ms"] = left
    with open(os.path.join(tmp, "replay", "out",
                           "result_gen1_rank0.json")) as f:
        out["replay"] = json.load(f)
    out["replay_wall_s"] = time.perf_counter() - d["t0"] - \
        out["drills_wall_s"]
    straight = _dist_uninterrupted(torch)
    out["uninterrupted"] = straight
    res, rep = out["host_loss"]["gen1"], out["replay"]
    if (rep["start_step"], rep["losses"], rep["params_sha256"]) \
            != (res["start_step"], res["losses"], res["params_sha256"]):
        fail("dist (c) host_loss: generation 1 %r differs from the replay "
             "%r" % (res, rep))
    for name in d["drills"]:
        res = out[name]["gen1"]
        start, end = res["start_step"], res["end_step"]
        if not 0 < start < end or \
                res["losses"] != straight["losses"][start:end] or \
                res["params_sha256"] != straight["params_sha256"][end]:
            fail("dist (c) %s: generation 1 from step %d %r differs from "
                 "the uninterrupted run %r" % (name, start, res, straight))
    return out


def _dist_guarded(args, torch):
    """(d)."""
    import warnings
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.resilience.guardrails import GuardedStep
    model, _ = _mesh_lm(args, torch, batches=False)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = [tuple(torch.from_numpy(a).to(DIST_DEVICE) for a in
                     lm_batch(args.seed + 60 + i))
               for i in range(DIST_GUARD_STEPS)]
    batches = [(x, y.float()) for x, y in batches]   # a float label: the
    # nan kind poisons it (an integer token stream cannot hold a NaN)

    def snapshot(tr, opt_t=None):
        return ({n: v.detach().clone() for n, v in tr.values.items()},
                {n: tuple(m.clone() for m in st)
                 for n, st in tr.states.items()}, opt_t)

    def same(a, b):
        return all(torch.equal(v, b[0][n]) for n, v in a[0].items()) and \
            all(torch.equal(m, o) for n, st in a[1].items()
                for m, o in zip(st, b[1][n]))

    where = []

    def counted(fn):
        """``fn``'s synchronizing calls (their code lines kept in
        ``where``), by sync debug mode's warning for each (not its notice
        that the mode is a prototype)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        hits = [w for w in caught
                if "synchronizing CUDA operation" in str(w.message)]
        where.extend("%s:%d" % (os.path.basename(w.filename), w.lineno)
                     for w in hits)
        return len(hits)

    from mxnet_tpu_torch.ops import flash_attention as fa
    fa.reset_launches()
    tr = ShardedTrainer(model, SoftmaxCrossEntropyLoss(), "adam",
                        dict(MESH_ADAM), device=torch.device(DIST_DEVICE))
    g = GuardedStep(tr, dynamic_scale=True, init_scale=DIST_GUARD_SCALE,
                    detector=False, name="dist_guard")
    losses, ms, syncs, snaps, scales = [], [], [], {}, []
    chaos.clear()
    chaos.arm("trainer.grads", "nan", at=DIST_GUARD_POISON)
    try:
        for i, (x, y) in enumerate(batches):
            e0, e1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            box = {}
            e0.record()
            syncs.append(counted(lambda: box.setdefault("l", g.step(x, y))))
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(box["l"]))
            g.flush()
            scales.append(g.loss_scale)
            if i + 1 in (DIST_GUARD_POISON - 1, DIST_GUARD_POISON):
                snaps[i + 1] = snapshot(tr, int(g.opt_step))
    finally:
        chaos.clear()
    skips = g.skipped_steps
    g.close()
    guarded = snapshot(tr, int(g.opt_step))
    del tr, g
    torch.cuda.empty_cache()
    model.load_state_dict(start)
    ref = ShardedTrainer(model, SoftmaxCrossEntropyLoss(), "adam",
                         dict(MESH_ADAM), device=torch.device(DIST_DEVICE))
    keep = [i for i in range(DIST_GUARD_STEPS) if i + 1 != DIST_GUARD_POISON]
    ref_losses, ref_ms, ref_syncs = [], [], []
    for k, i in enumerate(keep):
        x, y = batches[i]
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        box = {}
        e0.record()
        ref_syncs.append(counted(lambda: box.setdefault("l", ref.step(x, y))))
        e1.record()
        torch.cuda.synchronize()
        ref_ms.append(e0.elapsed_time(e1))
        ref_losses.append(float(box["l"]))
        if k + 1 == DIST_GUARD_POISON - 1:
            ref_snap = snapshot(ref)
    unguarded = snapshot(ref)
    launches = _launches_by_layout()
    del ref
    torch.cuda.empty_cache()
    p = DIST_GUARD_POISON
    out = {"steps": DIST_GUARD_STEPS, "poisoned_step": p,
           "init_scale": DIST_GUARD_SCALE, "losses": losses,
           "losses_unguarded": ref_losses, "scales": scales, "skips": skips,
           "syncs_guarded": syncs, "syncs_unguarded": ref_syncs,
           "step_ms_guarded": float(np.mean([m for i, m in enumerate(ms)
                                             if i not in (0, p - 1)])),
           "step_ms_unguarded": float(np.mean(ref_ms[1:])),
           "launches": launches}
    checks = {
        "skipped_step_bitwise": same(snaps[p], snaps[p - 1])
        and snaps[p][2] == snaps[p - 1][2] == p - 1,
        "scale_halved": scales[p - 1] == scales[p - 2] / 2,
        "one_skip": skips == 1,
        "steps_1_2_bitwise": same(snaps[p - 1], ref_snap),
        "steps_4_6_bitwise": same(guarded, unguarded)
        and guarded[2] == DIST_GUARD_STEPS - 1,
        "losses_bitwise": [l for i, l in enumerate(losses) if i != p - 1]
        == ref_losses and not np.isfinite(losses[p - 1]),
        "no_added_sync": all(
            g <= u for g, u in zip([n for i, n in enumerate(syncs)
                                    if i != p - 1], ref_syncs))
        and syncs[p - 1] <= max(ref_syncs)}
    out["checks"] = checks
    out["sync_sites"] = where
    if not all(checks.values()):
        fail("dist (d): %r; %r" % (checks, {k: out[k] for k in (
            "losses", "losses_unguarded", "scales", "skips",
            "syncs_guarded", "syncs_unguarded", "sync_sites")}))
    del model, start, snaps, guarded, unguarded, ref_snap
    torch.cuda.empty_cache()
    return out


def _dist_nccl(torch):
    """(e): NCCL in a world of one."""
    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import _process
    backend = parallel.initialize("127.0.0.1:%d" % _free_port(), 1, 0)
    try:
        x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
        y = kvs._cross_process_allreduce(x)
        kv = kvs.create("dist_sync")
        kv.barrier()
        _process.barrier()
        ok = backend == "nccl" and torch.equal(x, y) and \
            kv.num_workers == 1 and parallel.backend() == "nccl"
    finally:
        _process.destroy()
    if not ok:
        fail("dist (e): NCCL world of one: backend %s" % backend)
    return {"backend": backend, "all_reduce_bytes": x.numel() * 4,
            "between_ranks": "not run: one card (NCCL refuses two ranks on "
                             "one device)"}


def dist_phase(args, torch):
    """(a)-(e): several processes and training resilience on the card.
    The drills of (c) run while (a)'s results are checked."""
    import tempfile
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        workers = _dist_workers(args, tmp)
        oracles = _dist_oracles(args, torch)
        drills = _dist_drills_start(os.path.join(tmp, "el"))
        try:
            out["training"] = _dist_training(torch, tmp, workers, oracles)
            del oracles
            gc.collect()
            torch.cuda.empty_cache()
            out["elastic"] = _dist_drills_finish(torch, drills)
        finally:
            _stop_drills(drills)
    out["guarded"] = _dist_guarded(args, torch)
    out["nccl"] = _dist_nccl(torch)
    out["launches"] = {k: out["training"]["launches"][k]
                       + out["guarded"]["launches"][k]
                       for k in out["training"]["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_dist(res, card):
    """The dist phase's lines of the output."""
    a, c, d, e = res["training"], res["elastic"], res["guarded"], \
        res["nccl"]
    print("dist: (a) %s; 2 processes x transformer_lm_base b%d s%d fp32 "
          "gluon.Trainer Adam over dist_sync: %.2f ms a step (in turn in "
          "one process %.2f ms, one context b%d %.2f ms); all-reduce %.2f "
          "ms and %d bytes a step; rank 0 == the in-turn run bit for bit "
          "(params, moments, losses); vs b%d: losses %.3g (rtol %g), params "
          "%.3g (%s, atol %g), moments %.3g (%s, rtol %g); launches by rank "
          "%s; losses %s vs b%d %s [%s]" % (
              "; ".join(a["backend_line"]), TRAIN_BATCH // DIST_RANKS,
              TRAIN_SEQ, a["step_ms_2proc"], a["step_ms_in_turn"],
              TRAIN_BATCH, a["step_ms_b32"], a["allreduce_ms"],
              a["allreduce_bytes"], TRAIN_BATCH,
              a["b32_gaps"]["loss_rel_gap"], a["loss_rtol"],
              a["b32_gaps"]["param_max_gap"],
              a["b32_gaps"]["param_max_gap_name"], a["param_atol"],
              a["b32_gaps"]["state_max_rel_gap"],
              a["b32_gaps"]["state_max_rel_gap_name"], a["state_rtol"],
              [r["launches"] for r in a["ranks"]],
              ", ".join("%.5f" % v for v in a["losses_2proc_mean"]),
              TRAIN_BATCH, ", ".join("%.5f" % v for v in a["losses_b32"]),
              card), flush=True)
    for name, k in a["controls"].items():
        print("dist: (a) control %s: loss gap %.3g, params %.3g (%s), "
              "moments %.3g (%s); broke: %s [%s]" % (
                  name, k["loss_rel_gap"], k["param_max_gap"],
                  k["param_max_gap_name"], k["state_max_rel_gap"],
                  k["state_max_rel_gap_name"], "; ".join(k["broken"]),
                  card), flush=True)
    print("dist: (b) dist_sync kvstore invariants on CUDA tensors over 2 "
          "processes: ok (%s s); (c) host_loss: %s, generation 1 from step "
          "%d == replay in a fresh process == uninterrupted (bitwise); "
          "SIGTERM: %s, emergency checkpoint with %s ms of grace left, "
          "generation 1 from step %d == uninterrupted (bitwise); drills "
          "%.1f s" % (
              ", ".join("%.1f" % v for v in a["kvstore_checks_s"]),
              c["host_loss"]["worker_failed"],
              c["host_loss"]["gen1"]["start_step"],
              c["sigterm"]["worker_failed"],
              ", ".join("%.0f" % v for v in c["sigterm"]["grace_left_ms"]),
              c["sigterm"]["gen1"]["start_step"], c["drills_wall_s"]),
          flush=True)
    print("dist: (d) GuardedStep transformer_lm_base b%d fp32 Adam, scale "
          "from %g, step %d poisoned: %s; scales %s; %.2f ms a guarded step "
          "vs %.2f unguarded; syncs a step %s vs %s; (e) %s world of one: "
          "all-reduce and barrier ok; NCCL between ranks %s; dist %.1f s "
          "[%s]" % (
              TRAIN_BATCH, d["init_scale"], d["poisoned_step"],
              d["checks"], d["scales"], d["step_ms_guarded"],
              d["step_ms_unguarded"], d["syncs_guarded"],
              d["syncs_unguarded"], e["backend"], e["between_ranks"],
              res["wall_s"], card), flush=True)


def kernel_entries(serving, v2, training, bert, surface, core, vision,
                   data, rnn, symbol, ops, np_res, det, quant, sparse,
                   mesh, dist, fwd_cases, bwd_cases):
    """The ``{"kernels": [...]}`` entries, one per TPU kernel. The three
    ``(B, S, H, D)`` ones: numbers of the main path's training shape (B 32,
    S 512, H 12, D 64, causal) in fp32, and under ``*_bf16`` keys in bf16;
    under ``bert``, those of the BERT shape (B 64, S 128, non-causal)
    without and with a key mask. The three ``(B, H, S, D)`` ones: numbers
    at the registry op's shape (B 8, S 512, H 12, D 64, causal, key mask).
    ``core`` holds the predict, autograd and registry-op phases' launch
    counts; the backward kernels serve both layouts, so their launches are
    split by the phase's layout (the mesh phase's by the wrappers' own
    counts by layout, ``launches_by_layout``). The vision, data, rnn, ops, np,
    detection, quant and sparse phases' launches (none: no attention on
    those paths) are
    listed under their names, the ops phase's ``.states`` resume on the flash path under
    ``ops_resume`` (BSHD), and the symbol phase's (its attention op
    through an Executor: BHSD)."""
    def pick(cases, dtype="float32", B=TRAIN_BATCH, layout="BSHD"):
        return next(c for c in cases if c["B"] == B and c["S"] == 512
                    and c["D"] == 64 and c["layout"] == layout
                    and c["dtype"] == dtype and not c["dropout"])

    def bert_rows(cases, part=None):
        rows = {}
        for c in cases:
            if c["B"] != BERT_BATCH or c["dropout"]:
                continue
            t = c if part is None else c[part]
            rows["%s_%s" % (c["dtype"], "key_mask" if c["key_mask"]
                            else "no_mask")] = {
                "ms": t["ms"], "graph_ms": t["graph_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "plain_ms": c["plain_ms" if part is None else "plain_bwd_ms"],
                "library_ms": c["library_ms" if part is None
                                else "library_bwd_ms"],
                "library_graph_ms": c["library_graph_ms" if part is None
                                      else "library_bwd_graph_ms"]}
        rows["timed_case"] = "B=%d S=%d H=12 D=64 BSHD non-causal" % (
            BERT_BATCH, BERT_SEQ)
        return rows

    def timed(c, cb, part=None):
        t, tb = (c, cb) if part is None else (c[part], cb[part])
        plain = "plain_ms" if part is None else "plain_bwd_ms"
        lib = "library_ms" if part is None else "library_bwd_ms"
        libg = "library_graph_ms" if part is None \
            else "library_bwd_graph_ms"
        return {"ms": t["ms"], "graph_ms": t["graph_ms"],
                "plain_ms": c[plain], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": c[lib],
                "library_graph_ms": c[libg],
                "ms_bf16": tb["ms"], "graph_ms_bf16": tb["graph_ms"],
                "plain_ms_bf16": cb[plain], "bound_ms_bf16": tb["bound_ms"],
                "bound_by_bf16": tb["bound_by"], "library_ms_bf16": cb[lib],
                "library_graph_ms_bf16": cb[libg]}

    paths = {"serving": serving["flash_launches"],
             "serving_v2": v2["flash_launches"],
             "training": training["launches"]["flash_attn_fwd"],
             "bert": bert["launches"]["flash_attn_fwd"],
             "surface": surface["launches"]["flash_attn_fwd"],
             "predict": core["predict"]["flash_attn_fwd"],
             "autograd": core["autograd"]["flash_attn_fwd"],
             "vision": vision["launches"]["flash_attn_fwd"],
             "data": data["launches"]["flash_attn_fwd"],
             "rnn": rnn["launches"]["flash_attn_fwd"],
             "symbol": symbol["launches"]["flash_attn_fwd"],
             "ops": ops["launches"]["flash_attn_fwd"],
             "ops_resume": ops["resume_launches"]["flash_attn_fwd"],
             "np": np_res["launches"]["flash_attn_fwd"],
             "detection": det["launches"]["flash_attn_fwd"],
             "quant": quant["launches"]["flash_attn_fwd"],
             "sparse": sparse["launches"]["flash_attn_fwd"],
             "mesh": mesh["launches"]["flash_attn_fwd"],
             "dist": dist["launches"]["flash_attn_fwd"]}
    train_timed = "B=%d S=%d H=12 D=64 BSHD causal, float32 (*_bf16: " \
        "bfloat16)" % (TRAIN_BATCH, TRAIN_SEQ)
    reg_timed = "B=8 S=512 H=12 D=64 BHSD causal with a key mask, float32 " \
        "(*_bf16: bfloat16)"
    entries = [dict(name="flash_attn_fwd", source="flash_attn_fwd",
                    line=589, timed_case=train_timed,
                    max_abs_err=max(c["max_abs_err"] for c in fwd_cases
                                    if c["layout"] == "BSHD"),
                    launches=sum(paths.values()), launches_by_path=paths,
                    bert=bert_rows(fwd_cases),
                    **timed(pick(fwd_cases), pick(fwd_cases, "bfloat16")))]
    reg = core["registry"]
    entries.append(dict(
        name="flash_attn_fwd_bhsd", source="flash_attn_fwd", line=239,
        timed_case=reg_timed,
        max_abs_err=max(c["max_abs_err"] for c in fwd_cases
                        if c["layout"] == "BHSD"),
        launches=reg["flash_attn_fwd_bhsd"]
        + symbol["launches"]["flash_attn_fwd_bhsd"],
        launches_by_path={"registry_op": reg["flash_attn_fwd_bhsd"],
                          "vision": vision["launches"]["flash_attn_fwd_bhsd"],
                          "data": data["launches"]["flash_attn_fwd_bhsd"],
                          "rnn": rnn["launches"]["flash_attn_fwd_bhsd"],
                          "symbol":
                              symbol["launches"]["flash_attn_fwd_bhsd"],
                          "ops": ops["launches"]["flash_attn_fwd_bhsd"],
                          "np": np_res["launches"]["flash_attn_fwd_bhsd"],
                          "detection":
                              det["launches"]["flash_attn_fwd_bhsd"],
                          "quant": quant["launches"]["flash_attn_fwd_bhsd"],
                          "sparse":
                              sparse["launches"]["flash_attn_fwd_bhsd"],
                          "mesh": mesh["launches"]["flash_attn_fwd_bhsd"],
                          "dist": dist["launches"]["flash_attn_fwd_bhsd"]},
        **timed(pick(fwd_cases, B=8, layout="BHSD"),
                pick(fwd_cases, "bfloat16", B=8, layout="BHSD"))))
    for name, part, line, line_bhsd in (
            ("flash_attn_bwd_dq", "dq", 629, 312),
            ("flash_attn_bwd_dkv", "dkv", 668, 348)):
        by = {"serving": 0, "serving_v2": 0,
              "training": training["launches"][name],
              "bert": bert["launches"][name],
              "surface": surface["launches"][name],
              "predict": core["predict"][name],
              "autograd": core["autograd"][name],
              "vision": vision["launches"][name],
              "data": data["launches"][name],
              "rnn": rnn["launches"][name],
              "symbol": 0, "ops": ops["launches"][name],
              "ops_resume": ops["resume_launches"][name],
              "np": np_res["launches"][name],
              "detection": det["launches"][name],
              "quant": quant["launches"][name],
              "sparse": sparse["launches"][name],
              "mesh": mesh["launches_bwd_by_layout"][name]["BSHD"],
              "dist": dist["launches"][name]}
        for layout, ln in (("BSHD", line), ("BHSD", line_bhsd)):
            errs = [c["max_abs_err"][n] for c in bwd_cases
                    if c["layout"] == layout
                    for n in ((part,) if part == "dq" else ("dk", "dv"))]
            if layout == "BSHD":
                e = dict(name=name, line=ln, timed_case=train_timed,
                         launches=sum(by.values()), launches_by_path=by,
                         bert=bert_rows(bwd_cases, part),
                         **timed(pick(bwd_cases), pick(bwd_cases,
                                                       "bfloat16"), part))
            else:
                e = dict(name=name + "_bhsd", line=ln, timed_case=reg_timed,
                         launches=reg[name] + symbol["launches"][name],
                         launches_by_path={"registry_op": reg[name],
                                           "vision": vision["launches"][name],
                                           "data": data["launches"][name],
                                           "rnn": rnn["launches"][name],
                                           "symbol":
                                               symbol["launches"][name],
                                           "ops": ops["launches"][name],
                                           "np": np_res["launches"][name],
                                           "detection":
                                               det["launches"][name],
                                           "quant": quant["launches"][name],
                                           "sparse":
                                               sparse["launches"][name],
                                           "mesh": mesh[
                                               "launches_bwd_by_layout"][
                                               name]["BHSD"],
                                           "dist": dist["launches"][
                                               name + "_bhsd"]},
                         **timed(pick(bwd_cases, B=8, layout="BHSD"),
                                 pick(bwd_cases, "bfloat16", B=8,
                                      layout="BHSD"), part))
            e.update(source="flash_attn_bwd", max_abs_err=max(errs))
            entries.append(e)
    for e in entries:
        e.update(route="cuda",
                 source="mxnet_tpu_torch/csrc/%s.cu" % e["source"],
                 replaces=PALLAS % e.pop("line"))
    entries[0]["cases"] = fwd_cases
    entries[2]["cases"] = bwd_cases
    return entries


def print_rnn(rnn, card):
    """The rnn phase's lines of the output."""
    pc = rnn["plain_check"]
    f, b = pc["float32"], pc["bfloat16"]
    print("rnn (b) first step at full width, cuDNN vs the plain per-step "
          "path, fp32: loss %.6f / %.6f (rel %.3g), worst gradient %s at "
          "%.3g of its max; bf16 (%s path) vs fp32 on the same weights, "
          "each gradient's distance cuDNN / plain: %s; worst ratio %s %.3g "
          "(limit %g) (init %.1f s) [%s]"
          % (f["loss_cudnn"], f["loss_plain"], f["loss_rel_err"],
             f["grad_worst_param"], f["grad_worst_rel_to_max"], b["path"],
             ", ".join("%s %.3g / %.3g" % (n, c, p) for n, (c, p) in
                       b["grad_rel_to_max"].items()),
             b["worst_ratio_param"], b["worst_ratio"], b["factor"],
             rnn["init_s"], card), flush=True)
    for dname in ("float32", "bfloat16"):
        t = rnn[dname]
        w, pr = t["weight_copy"], t["profile"]
        print("rnn (a) %s: LSTM LM V%d %dx%d b%d s%d SGD, step %.2f ms mean "
              "(first %.2f), %.1f tokens/s, peak memory %.2f GB, losses %s; "
              "paths %s; the LSTM's forward and backward alone %.2f ms; "
              "weights-not-contiguous warning %s, %d bytes copied a step "
              "(one such copy %.3f ms) [%s]" % (
                  dname, RNN_VOCAB, RNN_LAYERS, RNN_WIDTH, RNN_BATCH,
                  RNN_SEQ, t["step_ms_mean"], t["first_step_ms"],
                  t["tokens_s"], t["max_memory_allocated_gb"],
                  ", ".join("%.4f" % v for v in t["losses"]), t["paths"],
                  t["lstm_ms"], w["warned"], w["bytes_a_step"], w["copy_ms"],
                  card), flush=True)
        print("rnn (a) %s profiled step: %.1f ms wall, busy %.1f ms (%.1f%%), "
              "%d kernels; RNN kernels %.1f%% of busy: %s; top: %s" % (
                  dname, pr["wall_ms"], pr["device_busy_ms"],
                  100 * pr["device_busy_share"], pr["kernels_launched"],
                  100 * pr["matched_share_of_busy"], "; ".join(
                      "%s x%d %.2f ms" % (n[:60], v["calls"], v["ms"])
                      for n, v in sorted(pr["matched"].items(),
                                         key=lambda kv: -kv[1]["ms"])[:6]),
                  "; ".join("%s x%d %.1f ms" % (k["name"][:40], k["calls"],
                                                k["ms"])
                            for k in pr["top_kernels"][:4])), flush=True)
    e = rnn["eager"]
    print("rnn (c) eager word-LM loop fp32 b%d bptt %d dropout %.1f: step "
          "%.2f ms mean (%s), losses %s, clip norms %s" % (
              RNN_BATCH, RNN_SEQ, RNN_EAGER_DROPOUT, e["step_ms_mean"],
              ", ".join("%.2f" % m for m in e["step_ms"]),
              ", ".join("%.4f" % v for v in e["losses"]),
              ", ".join("%.4g" % v for v in e["clip_norms"])), flush=True)
    for dname, r in rnn["inference"].items():
        print("rnn (d) %s hybridized forward with hidden, b%d s%d: replay "
              "%.3f ms, eager %.3f ms (%.2fx), bitwise equal; %s" % (
                  dname, RNN_BATCH, RNN_SEQ, r["replay_ms"], r["eager_ms"],
                  r["eager_ms"] / r["replay_ms"], r["cache"]), flush=True)
    s = rnn["estimator"]
    print("rnn (e) Estimator.fit 1 epoch of %d b%d batches in %.1f s: loss "
          "%.4f, accuracy %.4f; checkpoint reloaded bitwise; log: %s" % (
              RNN_EST_BATCHES, RNN_EST_BATCH, s["wall_s"], s["loss"],
              s["accuracy"], " | ".join(s["log"])), flush=True)
    print("rnn: flash launches %s; %.1f s" % (rnn["launches"],
                                               rnn["wall_s"]), flush=True)


def print_v2(v2):
    """The serving v2 lines of the output."""
    a, b, c = v2["prefix"], v2["chunked"], v2["speculative"]
    print("serving v2 (a) prefix cache: %d hits saving %d tokens (slabs: %d "
          "entries, %d tokens, %.1f MB); TTFT p50 %.2f ms cold, %.2f ms warm "
          "(server); prefill %.2f / %.2f ms mean; rows bitwise equal %s"
          % (a["hits"], a["tokens_saved"], a["slab_entries"],
             a["slab_tokens"], a["slab_bytes"] / 1e6,
             a["ttft_ms_cold"]["p50"], a["ttft_ms_warm"]["p50"],
             a["prefill_ms_mean_cold"], a["prefill_ms_mean_warm"],
             a["rows_bitwise_equal"]))
    for label in ("monolithic", "chunked"):
        r = b[label]
        print("serving v2 (b) %s: live inter-token p50 %.2f ms, p99 %.2f ms, "
              "max %.2f ms; the %d-token prompt's TTFT %.2f ms; %d chunk "
              "calls; flash launches %d"
              % (label, r["inter_token_p50_ms"], r["inter_token_p99_ms"],
                 r["inter_token_max_ms"], LONG_LEN, r["long_ttft_ms"],
                 r["chunk_calls"], r["flash_launches"]))
    print("serving v2 (b) a %d-token prompt beyond the ladder in %d chunks "
          "equals greedy re-prefill" % (b["beyond_ladder"]["prompt_len"],
                                        b["beyond_ladder"]["chunk_calls"]))
    for label in ("plain", "self_draft", "independent_draft"):
        r = c[label]
        spec = "" if label == "plain" else (
            "; acceptance %.3f, %d rounds, %d syncs"
            % (r["acceptance_rate"], r["rounds"], r["syncs"]))
        print("serving v2 (c) %s: %.1f tokens/s median of %d bursts (%.1f.."
              "%.1f; walls %s s), decode %.1f tokens/s, %d steps of %.2f "
              "ms%s"
              % (label, r["tokens_s"], len(r["walls_s"]), r["tokens_s_min"],
                 r["tokens_s_max"], ", ".join("%.3f" % w
                                             for w in r["walls_s"]),
                 r["decode_tokens_s"], r["steps"], r["step_ms_mean"], spec))
    for tag, sp in (("(a) cold", a["spans_cold"]),
                    ("(a) warm", a["spans_warm"]),
                    ("(b) monolithic", b["monolithic"]["spans"]),
                    ("(b) chunked", b["chunked"]["spans"]),
                    ("(c) plain", c["plain"]["spans"]),
                    ("(c) self_draft", c["self_draft"]["spans"]),
                    ("(c) independent_draft",
                     c["independent_draft"]["spans"])):
        print("serving v2 %s spans (host ms): %s" % (tag, ", ".join(
            "%s x%d %.2f" % (k.split(".", 1)[1], v["count"], v["mean_ms"])
            for k, v in sorted(sp.items()))))
    for name, r in v2["programs"]["programs"].items():
        print("serving v2 (f) %s: %.3f ms a call (CUDA events, %d calls)%s"
              % (name, r["ms"], v2["programs"]["calls"],
                 "" if "busy_ms" not in r else
                 "; device busy %.3f ms, %.0f kernels a call; top: %s"
                 % (r["busy_ms"], r["kernels"], "; ".join(
                     "%s x%d %.2f ms" % (k["name"][:40], k["calls"], k["ms"])
                     for k in r["top"]))))
    g = v2["graphs"]
    print("serving v2 (g) decode step, 8 slots at %d tokens: replay %.3f ms "
          "a call (%.0f kernels, busy %.3f ms), eager %.3f ms (%.0f kernels, "
          "busy %.3f ms); slot swap bitwise; %d churned greedy streams equal "
          "eager; captures %s" % (
              LONG_LEN, g["decode_replay"]["ms"],
              g["decode_replay"]["kernels"], g["decode_replay"]["busy_ms"],
              g["decode_eager"]["ms"], g["decode_eager"]["kernels"],
              g["decode_eager"]["busy_ms"], g["requests"],
              {k: v["misses"] for k, v in g["compile"].items()}))
    print("serving v2 (c) speculative streams token-exact against plain; "
          "near ties %d; (d) lanes: prefill lane retired %r, decode lane "
          "skipped %d tokens, %d misses; (e) retry: %d retries, streams "
          "equal; flash launches %d in %.1f s"
          % (len(v2["near_ties"]), v2["lanes"]["prefill_reason"],
             v2["lanes"]["decode_prefix_skipped"],
             v2["lanes"]["decode_lane_misses"], v2["retry"]["retries"],
             v2["flash_launches"], v2["wall_s"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="serve the burst a second time and run two fp32 "
                         "and two bf16 training steps (and the other "
                         "phases' profiled parts) under torch.profiler and "
                         "print the device's busy share")
    ap.add_argument("--dist-worker", action="store_true",
                    help="run as one rank of the dist phase's (a) and (b) "
                         "(the dist phase starts two through the launcher)")
    args = ap.parse_args()
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dist_worker:
        return dist_worker(args, torch)
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build(SOURCES)
    build_s = time.perf_counter() - t0
    print("build: %s in %.1f s (parallel nvcc); %s" % (
        ", ".join(SOURCES), build_s,
        "; ".join(ptxas_summary(_build, n) for n in SOURCES)))

    serving = serving_phase(args, torch)
    print("serving: %d requests, TTFT p50 %.2f ms (server), %.2f ms "
          "(client); decode %.1f tokens/s; step %.2f ms; prefill %.2f ms"
          % (serving["requests"], serving["ttft_ms_server"]["p50"],
             serving["ttft_ms_p50_client"], serving["decode_tokens_s"],
             serving["step_ms_mean"], serving["prefill_ms_mean"]))
    print("serving: greedy streams equal re-prefill for prompts of %s "
          "tokens; flash launches %d = 2 x %d prefill captures x 12 layers "
          "(%d prefills); captures %s"
          % (serving["greedy_reprefill_checked"], serving["flash_launches"],
             serving["prefill_captures"], serving["prefills"],
             {k: v["misses"] for k, v in serving["compile"].items()}))

    v2 = serving_v2_phase(args, torch)
    print_v2(v2)
    # every engine of both serving phases is closed or dropped: their
    # arenas, prefix slabs and models must be freed
    gc.collect()
    leftover = torch.cuda.memory_allocated()
    print("serving: %d bytes of device memory still allocated after both "
          "serving phases" % leftover)
    if leftover > LEFTOVER_BYTES:
        fail("%d bytes of device memory outlive the serving phases; the "
             "largest live tensors: %s" % (leftover, live_tensors(torch)))

    training = train_phase(args, torch)
    for dname in ("float32", "bfloat16"):
        t = training[dname]
        print("training %s: b%d s%d, step %.2f ms mean (first %.2f ms), "
              "%.1f tokens/s, peak memory %.2f GB, losses %s"
              % (dname, TRAIN_BATCH, TRAIN_SEQ, t["step_ms_mean"],
                 t["first_step_ms"], t["tokens_s"],
                 t["max_memory_allocated_gb"],
                 ", ".join("%.4f" % v for v in t["losses"])))
    pc = training["plain_check"]
    print("training: launches %s; first step vs plain path: loss rel err "
          "%.3g, worst gradient %s at %.3g of its max; dropout losses "
          "repeat %s; fp32 and bf16 dQ bitwise repeatable at dropout %s"
          % (training["launches"], pc["loss_rel_err"],
             pc["grad_worst_param"], pc["grad_worst_rel_to_max"],
             training["dropout_losses"],
             training["dq_repeat_dropouts"]))

    bert = bert_phase(args, torch)
    print("bert: launches %s; valid_len %d..%d in the key-mask check; "
          "dropout losses repeat %s"
          % (bert["launches"], min(bert["valid_len"]),
             max(bert["valid_len"]), bert["dropout_losses"]))

    surface = {"bert_lamb": surface_bert(args, torch),
               "eager_lm": surface_eager(args, torch)}
    surface["launches"] = {
        k: surface["bert_lamb"]["launches"][k]
        + surface["eager_lm"]["launches"][k]
        for k in surface["bert_lamb"]["launches"]}
    print("surface: launches %s (BERT LAMB %s, eager TransformerLM %s); "
          "eager clip norms %s" % (
              surface["launches"], surface["bert_lamb"]["launches"],
              surface["eager_lm"]["launches"],
              ", ".join("%.4g" % v for v in
                        surface["eager_lm"]["clip_norms"])))

    predict = predict_phase(args, torch)
    for dname in ("float32", "bfloat16"):
        r = predict[dname]
        print("predict %s: bert_base S%d buckets %s, warmup %.2f s (%d "
              "misses), capture ms %s, graph pool %d bytes; per bucket "
              "eager/replay ms %s; HTTP %d clients x %d: %d requests, %d "
              "errors, mean batch %.2f, client p50 %.2f ms p99 %.2f ms, %.1f "
              "rows/s; batched rows vs alone %.3g of max" % (
                  dname, PREDICT_SEQ, r["buckets"], r["warmup_s"],
                  r["cache"]["misses"], ", ".join(
                      "%.1f" % v for v in r["capture_ms"].values()),
                  r["pool_bytes"], ", ".join(
                      "%d: %.3f/%.3f" % (b, t["eager_ms"], t["replay_ms"])
                      for b, t in r["per_bucket"].items()),
                  PREDICT_CLIENTS, PREDICT_PER_CLIENT, r["requests"],
                  r["errors"], r["avg_batch_size"], r["client_ms"]["p50"],
                  r["client_ms"]["p99"], r["rows_s"],
                  r["row_vs_alone_rel_to_max"]), flush=True)
        print("predict %s vs the plain path per bucket (of the output's "
              "max): %s" % (dname, "; ".join(
                  "%d: %s" % (b, ", ".join(
                      "%s %.3g" % (k, t[k]) for k in (
                          "vs_plain_rel_to_max", "kernel_vs_fp32",
                          "plain_vs_fp32") if k in t))
                  for b, t in r["per_bucket"].items())), flush=True)
        if "bf16_nsp" in r:
            c, n = r["c10_case"], r["bf16_nsp"]
            print("predict %s pooled output per bucket, kernel/plain "
                  "distance from fp32 (tol %g): %s; the C10 case (bucket %d, "
                  "valid_len %s) %.3g/%.3g; NSP logits over all %d checked "
                  "rows: kernel %.3g, plain %.3g; every layer's attention "
                  "within %.2f of the plain path's distance from float64 "
                  "(C10 case %.2f)" % (
                      dname, PREDICT_BF16_FACTOR, ", ".join(
                          "%d: %.3g/%.3g" % (
                              b, t["by_output"]["pooled"]["kernel_vs_fp32"],
                              t["by_output"]["pooled"]["plain_vs_fp32"])
                          for b, t in r["per_bucket"].items()),
                      C10_BUCKET, c["valid_len"],
                      c["by_output"]["pooled"]["kernel_vs_fp32"],
                      c["by_output"]["pooled"]["plain_vs_fp32"], n["rows"],
                      n["kernel_vs_fp32"], n["plain_vs_fp32"],
                      max(t["attention_worst_ratio"]
                          for t in r["per_bucket"].values()),
                      c["attention_worst_ratio"]), flush=True)
        if "profile_eager_b32" in r:
            pr = r["profile_eager_b32"]
            print("profile predict %s eager bucket 32: %d kernels, device "
                  "busy %.2f ms of %.2f ms" % (dname, pr["kernels_launched"],
                                               pr["device_busy_ms"],
                                               pr["wall_ms"]))
    print("predict: replay == eager bitwise and eager == plain path at "
          "every bucket, 12 flash launches a call; whole BERTModel at bucket 8 %s; launches %s; "
          "%.1f s" % (predict["whole_model_shapes"], predict["launches"],
                      predict["wall_s"]), flush=True)
    core_ag = autograd_phase(args, torch)
    print("autograd: transformer_lm_base b%d s%d, first NDArray step == "
          "surface (b) bitwise (losses and every gradient); fp32 step %.2f "
          "ms, bf16 step %.2f ms (means after the first); losses %s / %s; "
          "launches %s" % (
              TRAIN_BATCH, TRAIN_SEQ, core_ag["float32"]["step_ms_mean"],
              core_ag["bfloat16"]["step_ms_mean"],
              ", ".join("%.4f" % v for v in core_ag["float32"]["losses"]),
              ", ".join("%.4f" % v for v in core_ag["bfloat16"]["losses"]),
              core_ag["launches"]), flush=True)
    registry = registry_phase(torch)
    print("registry op: nd._contrib_dot_product_attention %s, fp32/bf16 x "
          "causal/full, forward and backward vs plain: %s; launches %s" % (
              registry["shape"], "; ".join(
                  "%s causal=%s %s" % (c["dtype"], c["causal"], ", ".join(
                      "%s %.2g" % kv for kv in c["err_rel_to_max"].items()))
                  for c in registry["cases"]), registry["launches"]),
          flush=True)
    core = {"predict": predict["launches"], "autograd": core_ag["launches"],
            "registry": registry["launches"]}
    vision = vision_phase(args, torch)
    card = card_line()
    v = vision["inference"]
    print("vision (a) resnet50_v1 b%d %dx%d bf16 (BatchNorm fp32, %d "
          "parameters): replay == eager bitwise; eager %.3f ms (%.1f img/s), "
          "replay %.3f ms (%.1f img/s); capture %s ms, graph pool %d bytes; "
          "bf16 vs fp32 copy %.3g of max; init %.1f s [%s]" % (
              v["batch"], v["image"], v["image"], v["batchnorm_params_fp32"],
              v["eager_ms"], v["img_s_eager"], v["replay_ms"],
              v["img_s_replay"], ", ".join("%.1f" % c for c in
                                          v["capture_ms"]),
              v["pool_bytes"], v["bf16_vs_fp32_rel_to_max"], v["init_s"],
              card), flush=True)
    for dname in ("float32", "bfloat16"):
        t = vision[dname]
        print("vision (b) %s: b%d SGD momentum, steps %s ms, bench_span %d "
              "steps %.2f ms a step (%.1f img/s), peak memory %.2f GB; "
              "losses %s | %s; stem BatchNorm stats vs the momentum rule "
              "%s (wd %g) [%s]" % (
                  dname, VISION_BATCH, ", ".join("%.2f" % m
                                                 for m in t["step_ms"]),
                  VISION_SPAN, t["span_step_ms"], t["img_s"],
                  t["max_memory_allocated_gb"],
                  ", ".join("%.4f" % l for l in t["losses"]),
                  ", ".join("%.4f" % l for l in t["span_losses"]),
                  ", ".join("%s %.2g" % kv for kv in
                            t["stats"]["stem_bn_err_rel_to_max"].items()),
                  t["stats"]["wd"], card), flush=True)
    print("vision: flash launches %s; %.1f s" % (vision["launches"],
                                                 vision["wall_s"]),
          flush=True)
    data = data_phase(args, torch)
    print("data: native IO library built in %.1f s (JPEG %s); %d raw "
          "records, %d bytes, written in %.1f s; the pump alone %.2f "
          "batches/s (b%d, 224 crops, mirror, mean/std); H2D %.1f GB/s "
          "(pinned, %d copies) [%s]" % (
              data["native_build_s"], "on" if data["native_jpeg"] else "off",
              DATA_IMAGES, data["rec_bytes"], data["rec_write_s"],
              data["pump_batches_s"], VISION_BATCH, data["h2d_gb_s"],
              DATA_H2D_COPIES, card), flush=True)
    for dname in ("float32", "bfloat16"):
        t = data[dname]
        print("data %s: step_stream %d steps (chunk %d, depth %d) %.2f ms a "
              "step (%.1f img/s) against bench_span %.2f ms (%.1f img/s); "
              "losses == step() bitwise, checksums equal, stage waits %d; "
              "feed %s; losses %s [%s]" % (
                  dname, DATA_STEPS, DATA_CHUNK, DATA_DEPTH,
                  t["fed_step_ms"], t["fed_img_s"], t["span_step_ms"],
                  t["span_img_s"], t["feed"]["stage_waits"], t["feed"],
                  ", ".join("%.4f" % v for v in t["losses"]), card),
              flush=True)
    print("data: pinned DataLoader (%d workers) %d batches %s == unpinned, "
          "%.1f s; flash launches %s; %.1f s" % (
              data["loader"]["workers"], data["loader"]["batches"],
              data["loader"]["shape"], data["loader"]["wall_s"],
              data["launches"], data["wall_s"]), flush=True)

    rnn = rnn_phase(args, torch)
    print_rnn(rnn, card)
    symbol = symbol_phase(args, torch)
    print_symbol(symbol, vision, card)
    ops = ops_phase(args, torch)
    print_ops(ops, card)
    np_res = np_phase(args, torch)
    print_np(np_res, card)
    det = detection_phase(args, torch)
    print_detection(det, card)
    quant = quant_phase(args, torch)
    print_quant(quant, symbol, vision, card)
    sparse = sparse_phase(args, torch)
    print_sparse(sparse, card)
    mesh = mesh_phase(args, torch)
    print_mesh(mesh, card)
    dist = dist_phase(args, torch)
    print_dist(dist, card)

    for tag, prof in (("serving burst", serving["profile"]),
                      ("2 fp32 training steps",
                       training.get("profile_float32")),
                      ("2 bf16 training steps",
                       training.get("profile_bfloat16")),
                      ("2 bf16 BERT steps", bert.get("profile_bfloat16")),
                      ("2 bf16 BERT LAMB steps (surface)",
                       surface["bert_lamb"].get("profile_bfloat16_lamb")),
                      ("2 bf16 BERT Adam steps (surface)",
                       surface["bert_lamb"].get("profile_bfloat16_adam")),
                      ("1 bf16 resnet50_v1 step (vision)",
                       vision["bfloat16"].get("profile")),
                      ("1 bf16 resnet50_v1 b32 eager forward (vision)",
                       vision["inference"].get("profile_eager")),
                      ("2 fp32 dp=2 x tp=2 mesh steps (mesh)",
                       mesh["lm"].get("profile_mesh")),
                      ("2 fp32 one-device steps (mesh)",
                       mesh["lm"].get("profile_one"))):
        if prof is not None:
            print("profile %s: %.1f ms wall, device busy %.1f ms (%.1f%%), "
                  "%d kernels; top: %s" % (
                      tag, prof["wall_ms"], prof["device_busy_ms"],
                      100 * prof["device_busy_share"],
                      prof["kernels_launched"],
                      "; ".join("%s x%d %.1f ms" % (k["name"][:40],
                                                    k["calls"], k["ms"])
                                for k in prof["top_kernels"][:6])))

    fwd_cases = kernel_phase(torch)
    for c in fwd_cases:
        lib = "-" if c["library_ms"] is None else "%.4f ms (graph %.4f)" % (
            c["library_ms"], c["library_graph_ms"])
        print("kernel fwd: B=%-2d S=%-5d D=%-3d %s %-8s %s mask=%d "
              "dropout=%.1f  %.4f ms (graph %.4f)  plain %.4f ms  library "
              "%s  bound %.4f ms (%s)  max_err %.3g"
              % (c["B"], c["S"], c["D"], c["layout"], c["dtype"],
                 "causal" if c["causal"] else "full", c["key_mask"],
                 c["dropout"], c["ms"], c["graph_ms"], c["plain_ms"], lib,
                 c["bound_ms"], c["bound_by"], c["max_abs_err"]))
    bwd_cases = bwd_phase(torch)
    for c in bwd_cases:
        lib = "-" if c["library_bwd_ms"] is None else \
            "%.4f ms (graph %.4f)" % (c["library_bwd_ms"],
                                      c["library_bwd_graph_ms"])
        print("kernel bwd: B=%-2d S=%d D=%-3d %s %-8s %s mask=%d "
              "dropout=%.1f  dq %.4f ms (graph %.4f, bound %.4f %s)  dkv "
              "%.4f ms (graph %.4f, bound %.4f %s)  plain bwd %.4f ms  "
              "library bwd %s  err/max %s"
              % (c["B"], c["S"], c["D"], c["layout"], c["dtype"],
                 "causal" if c["causal"] else "full", c["key_mask"],
                 c["dropout"], c["dq"]["ms"], c["dq"]["graph_ms"],
                 c["dq"]["bound_ms"], c["dq"]["bound_by"], c["dkv"]["ms"],
                 c["dkv"]["graph_ms"], c["dkv"]["bound_ms"],
                 c["dkv"]["bound_by"], c["plain_bwd_ms"], lib,
                 ",".join("%.2g" % v for v in
                          c["max_err_rel_to_max"].values())))
    entries = kernel_entries(serving, v2, training, bert, surface, core,
                             vision, data, rnn, symbol, ops, np_res, det,
                             quant, sparse, mesh, dist, fwd_cases, bwd_cases)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"serving": serving, "serving_v2": v2,
                       "training": training,
                       "bert": bert, "surface": surface,
                       "predict": predict, "autograd": core_ag,
                       "registry_op": registry, "vision": vision,
                       "data": data, "rnn": rnn, "symbol": symbol,
                       "ops": ops, "np": np_res, "detection": det,
                       "quant": quant, "sparse": sparse, "mesh": mesh,
                       "dist": dist,
                       "kernels": entries,
                       "card": card,
                       "build_s": build_s}, f, indent=1)
    print("chip_smoke: %.1f s in all (the build included)"
          % (time.perf_counter() - t_main))
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "cases"} for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

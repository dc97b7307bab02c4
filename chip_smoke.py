#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cxxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--conf examples/ImageNet/inception_bn.conf]
                          [--json OUT.json]
    python3 chip_smoke.py --ab PARENT . . PARENT   # A/B of two checkouts
    python3 chip_smoke.py --step-ab PARENT . . PARENT   # train steps A/B
    python3 chip_smoke.py --wgrad                  # f32 conv weight gradients
    python3 chip_smoke.py --phase telemetry        # the build and phase 19
    python3 chip_smoke.py --phase data_service     # the build and phase 20
    python3 chip_smoke.py --phase grammar          # the build and phase 21
    python3 chip_smoke.py --phase operations       # the build, 19 and 22

With ``--ab``, only the kernels of the vectorised designs are timed, in
each checkout root given, in turn, one process each (``bn_fwd`` at
bn_stem1 one- and two-pass and at a mid layer, ``bn_bwd`` and
``epilogue_bwd`` at fc1 and AlexNet's cv1 and fc6 as phase 6 times
them, the four sync-BN kernels as phase 11 does, ``lrn_fwd`` and
``lrn_bwd`` at AlexNet's lrn1 and lrn2 as phase 8 does, with their
rates at lrn1, out of the L2, and a copy of the bytes beside them; a
tree that plans the LRN blocks also times lrn1 at each of LRN_SWEEP
threads a block; ``pool_bwd_max`` at spp1 as phase 8 does and at the
digits LeNet's 2x2, ``stem`` at phase 12's shape with no mean, a
per-channel mean and a mean image, with their rates, ``epilogue_fwd`` at
AlexNet's cv1 and cv2, the SPP net's cv1 and fc1, and ``adam_apply`` over
the LM's and Inception-BN's leaves, each beside its bound, plain version
and library call).

With ``--step-ab``, each checkout root in turn, one process each, times
the train steps of STEP_AB (full-width Inception-BN in bf16 and f32,
AlexNet and the kaggle_bowl net in f32, synthetic batches) with cuDNN's
deterministic algorithms off and on. With ``--wgrad``, the float32 conv
weight gradient at each WGRAD_SHAPES shape: cuDNN's (deterministic off
and on), ATen's own with cuDNN off, and the port's im2col gemm, each
timed and held against a float64 reference.

Phases, each printing one line of its own; any failure exits non-zero
and prints no result:

1. env:     torch / CUDA versions, the card, compute capability 9.0.
2. build:   every kernel under ``cxxnet_tpu_torch/csrc`` built with nvcc
            for sm_90a (one nvcc per source, all at once), and beside
            them the image pipeline's host libraries under ``native/``
            with g++ (``png.cc``, ``warp.cc``, and ``nvjpeg.cc`` against
            the CUDA toolkit's nvJPEG).
3. kernels: each kernel against its plain PyTorch version on the card,
            at the serving and training paths' shapes, in bf16, f16 and
            f32, and at row counts the TPU kernels' gates refused (the
            pooling forward also at the digits LeNet's 2x2 tiles, C 20
            and 1000, a base 2 bytes past a 16-byte boundary, and NaNs
            in max and sum windows, which must stay NaN); the
            flash attention kernels (forward, dQ, dK/dV) in bf16, f16
            and f32, causal and not, at S 2048 and the ragged 1000, head
            widths 16, 64 and 128, and non-causal with 300 queries over
            1000 keys (f32 within 2e-5 of max|plain|, bf16 and f16 one
            ulp plus 2e-5 of max|plain|, lse 1e-5 of max|lse|); the
            Adam apply over the LM's and Inception-BN's parameter groups
            and the odd leaves of ADAM_EDGES, their streams aligned or 4,
            8 and 12 bytes past a 16-byte boundary, bit-equal; the
            epilogue forward at fc1's buckets, AlexNet's cv1 and fc6, the
            SPP net's cv1, C 5, 7 and 1001, a base 2 or 4 bytes past 16,
            and NaN, +0 and -0 inputs, equal (NaN where plain has one);
            LRN forward and backward at AlexNet's lrn1 and
            lrn2 and at 7 rows by C 7, C 1500, C 4104 (a row in chunks)
            and a ragged row count,
            nsize 3/4/5, knorm 1/2, beta 0.75/0.5 (f32 within 4 ulp of
            max|plain|, bf16/f16 one ulp); the first-match max-pool
            backward at spp1's shape, a 2x2 tile and a global 7x7
            window on tie-ridden integer inputs, first matches in
            different window rows on the lanes of one vector, C 5, 20
            and 40, a base one element past 16 bytes, NaN cells and
            maxima, non-positive windows, a global 13x13 and 27x27,
            pre_relu on and off (POOL_BWD_CASES, bit-equal); the stem
            in every STEM_CASES entry (bit-equal; phase 12 lists
            them); the four data-parallel BN kernels at every BN
            shape of Inception-BN at 64 rows a rank, a flat node, C 1, 7
            and 1500, a ragged row count and ragged rows 1 element past
            a 16-byte boundary in bf16, f16 and f32: their sums within
            the order-of-summation bound of the exact sum (the longest
            addition chain of colsum_vec.cuh's plan for each, * 2^-24 *
            sum|term|), bn_sums' bit-equal to bn_fwd's of the same rows,
            ``bn_norm``'s output bit-equal to the plain version's,
            ``bn_bwd_dx``'s within 4 f32 ulp of max|plain| (bf16/f16 one
            ulp more); the epilogue backward at fc1, AlexNet-like cv1
            rows and odd shapes: dx equal, dbias within the
            order-of-summation bound of its plan.
4. serve:   full-width Inception-BN (224x224x3, 69 batch_norm layers,
            1000 classes, bfloat16) with random weights drawn by numpy
            from ``--seed``, BN statistics calibrated on one seeded
            batch, written as a round by the port's checkpoint writer
            and served over HTTP by ``cxxnet_tpu_torch.main.run`` (what
            ``python -m cxxnet_tpu_torch.main <conf> task=serve`` calls)
            on a thread. Launch counts are set to 0 just before the
            requests and read just after; every kernel must have run.
            Answers are checked (finite softmax rows summing to 1) and
            held against an engine with ``fused_kernels = 0``.
5. times:   CUDA-event times of the engine forward per bucket and of
            each kernel beside its bound, its plain version and one
            PyTorch library call computing the same function.
6. train:   full-width Inception-BN trained through
            ``cxxnet_tpu_torch.main.run`` (what ``python -m
            cxxnet_tpu_torch.main <conf> task=train`` calls) from the
            flagship's netconfig and globals (bf16, SGD with momentum,
            batch 128) over ``iter = synthetic`` data drawn from
            ``--seed``: 4 steps, the round line with one evaluation, one
            round written. Launch counts are set to 0 just before the
            first step and read just after the run: per step 69 of each
            BN kernel, 2 SGD applies (one per tag group), and the pooling
            and epilogue kernels. Each bf16 step is held against the
            same step taken with ``fused_kernels = 0`` from the same
            state: loss within 2e-2 * max(1, |loss|), BN statistics
            rel L2 2e-2, the per-leaf ratio of the norms of the step's
            gradient part in [0.5, 2], and at steps 2-4 the median over
            leaves of the update's rel L2 at most 1.5 times that of
            plain bf16 against plain f32 from the same state (the bf16
            rounding, amplified by the 69 BN layers' gradient chaos at
            init; at step 1 it reads 0.94, so step 1's update is held by
            the ratio only). Then every layer in bf16, kernels against
            plain from the same inputs and upstream gradient: output,
            input and master gradients rel L2 2e-2. Two float32 steps
            with the kernels, each against the plain step from the same
            state: loss rtol 1e-4, update rel L2 median 5e-2 and worst
            leaf 0.15, BN statistics 1e-3. The written round is loaded
            and served a finite answer; the train step and each
            training kernel are timed; ``bn_fwd`` also at a mid layer
            (BN_MID) and by launch, and the device time and launches of
            a step's 69 ``bn_fwd`` summed from the step's profile by
            kind (BN_FWD_KINDS); ``bn_bwd`` also by launch beside
            the library call's launches, and beside the two-pass byte
            floors (7 streams with y read twice, 6.125 with the mask
            bits it reads) as well as the table's 4-stream bound;
            ``epilogue_bwd`` at fc1 and at AlexNet's cv1 and fc6 (relu
            and a bias, EPI_CV1 and EPI_FC6 rows) beside its yardstick
            (``dy.sum(0)``; ``threshold_backward`` then ``.sum(0)``),
            fc1 and cv1 also by launch. With
            the kernels, ``bn_bwd``'s dx (its dx pass reads the mask
            bits) is held bit-equal to ``bn_bwd_dx``'s (which reads y)
            given the same sums.
7. lm:      the long-context causal LM (``examples/LM/long_context_lm
            .conf``: E 128, 8 heads of 16 with rope, ffn 512, S 2048,
            batch 8, bf16, remat, Adam) trained through ``main.run``
            for 4 steps (``num_inst`` cut to 32, weights from
            ``--seed``), one round written. Launch counts, set to 0 just
            before the first step and read after the run: per step 2
            ``flash_fwd`` (remat runs the forward again), 1 each of
            ``flash_bwd_dq`` and ``flash_bwd_dkv``, and one
            ``adam_apply`` per tag group. Each bf16 step, and two float32
            steps from the init, held against ``fused_kernels = 0`` from
            the same state: the loss (LM_LOSS_TOL of max(1, |loss|)) and
            each leaf's gradient (rel L2 LM_GRAD_TOL), except the k
            projections' biases, whose gradient is zero analytically
            and rounding noise in practice: their move in a step, in the
            run and in the plain step, stays within 1.001 of the most an
            Adam step can move an element. The written round loads and
            gives finite log-probabilities; the LM step and each LM
            kernel are timed beside bound, plain version and library
            call (``F.scaled_dot_product_attention`` forward; SDPA's
            backward as one op in a CUDA graph, fed its own forward's
            saved outputs, the faster of its flash and cuDNN ops, with
            its autograd host loop printed beside it;
            ``torch.optim.Adam(fused=True)``); a flash
            kernel's bound is the largest of its bytes, its products at
            the bf16 tensor-core rate and its exponentials at the SFU's
            rate (SFU_EXP_PER_S). The three flash kernels also timed
            non-causal and in f16 at the path's shape.

8. convnets: full-width AlexNet (``examples/ImageNet/alexnet.conf``:
            batch 256, 3x227x227, bf16, SGD, dropout 0.5, LRN) and the
            SPP net (``kaiming.conf``: batch 128, 3x224x224, insanity,
            a four-level pyramid of max pools) trained through
            ``main.run`` for CONVNET_STEPS steps each over ``iter =
            synthetic`` data from ``--seed``, one round written. Launch
            counts are read after every step: ``lrn_fwd`` = ``lrn_bwd`` =
            2 a step for AlexNet, ``pool_bwd_max`` = 1 for the SPP net,
            ``sgd_apply`` one per tag group, the epilogues at least 1.
            Each bf16 step, and two float32 steps from the init, held
            against ``fused_kernels = 0`` from the same state and the
            same draws (CONVNET_LOSS_TOL, CONVNET_GRAD_TOL); insanity's
            step counters read CONVNET_STEPS; the written round answers
            finite softmax rows. Step and kernel times (and rates)
            beside bound, plain version and library call
            (``F.local_response_norm`` forward and backward,
            ``max_pool2d_with_indices_backward``, and the epilogue
            forward at AlexNet's cv1 and cv2 and the SPP net's cv1,
            EPI_FWD, beside ``torch.add`` of the bias, then ``.relu_()``
            for AlexNet's); for each net the device time and launches a
            step of its epilogue forwards, and for AlexNet of its
            epilogue backwards, from the step's profile by kind.
9. digits:  ``examples/digits/digits_lenet.conf`` trained one round
            through ``main.run`` on the card from gzipped idx files
            written from ``--seed``; ``pool_bwd_max`` launches once a
            step.
10. int8:   the int8 product ``q_mm`` bit-equal to ``q_mm_plain`` at the
            int8 paths' shapes (fc1 at M 1, 8, 32; conv1 as im2col at
            bucket 32, K 147 padded to 160 as the conv pads it; an
            inception 3x3, K 576; a 7x7 inception conv at bucket 1, M 49
            and N 384; AlexNet's conv1 (K 363, padded to 368) and
            grouped conv2; fc6 at M 1 and 32, fc7 at M 32) and odd ones
            (K 4112, whose steps the split of K does not divide; 7x13x5;
            K 4096 with every code at +-127, |acc| past 2^24), with bias
            and relu and without; every path shape takes the pipelined
            variant (``fused_quant.Q_MM_VARIANTS``).
            Phase 4's Inception-BN round quantized by ``python -m
            cxxnet_tpu_torch.quant``'s ``main()`` over synthetic batches
            from ``--seed`` (its drift line printed) and served over
            HTTP by ``main.run`` with ``serve_dtype=int8``: launch counts
            set to 0 just before the requests and read just after, 70
            ``q_mm`` a forward (69 convs and fc1), every launch of the
            pipelined variant (as in the AlexNet run); finite rows summing to
            1, held against an int8 engine with ``fused_kernels = 0``
            (INT8_ROW_ATOL). AlexNet (``alexnet.conf``, random weights)
            quantized the same way and run by the int8 engine at bucket
            32: 8 ``q_mm`` a forward, held the same way. The int8
            rows against fp32 (rel L2, top-1) printed, not gated: random
            weights. Times: the int8 forward per bucket beside phase 5's
            bf16 one, and ``q_mm`` at each path shape beside its bound,
            its plain version and ``torch._int_mm`` with the epilogue;
            the fc shapes also cold, over weight copies past the L2.

11. dp:     full-width Inception-BN trained data-parallel through
            ``main.run`` (what ``python -m cxxnet_tpu_torch.main <conf>
            dev=gpu:0-1`` calls) with the launcher's override of two
            ranks on card 0 over gloo (NCCL refuses two ranks on one
            card; every kernel, activation and update stays on the card,
            only the collectives go through the host): global batch 128,
            64 a rank, bf16, SGD, ``iter = synthetic`` from ``--seed``, 4
            steps, the round line with one evaluation, one round written.
            Launch counts, set to 0 in each rank just before its first
            step and read after each: 69 of each sync-BN kernel
            (``bn_sums``, ``bn_norm``, ``bn_bwd_sums``, ``bn_bwd_dx``) a
            step, 0 of ``bn_fwd``/``bn_bwd``, 2 ``sgd_apply``. The ranks'
            masters, momenta and BN statistics bit-equal after every
            step. Each step held against the single-device step on the
            same global batch from the same state with phase 6's bounds
            (loss 2e-2 * max(1, |loss|), BN statistics rel L2 2e-2, the
            gradient-part norm ratio in [0.5, 2], the update's median rel
            L2 at most 1.5x that of single-device bf16 against f32 at
            steps 2-4); two float32 dp steps from the same init (a second
            launch): loss rtol 1e-4, update median rel L2 5e-2, BN
            statistics rel L2 2e-4 (only the order of the sums differs;
            the single-device kernels against their plain versions read
            the same order of size, printed beside it), and step 1 again
            with rank-local BN moments planted must read above 2e-4.
            The written round served finite softmax rows by a
            single-device engine. The dp step time per rank and the host
            time inside the collectives; the four kernels timed at
            bn_stem1's per-rank shape beside bound, plain version and
            ``torch.batch_norm_stats`` / ``batch_norm_elemt`` /
            ``batch_norm_backward_reduce`` / ``batch_norm_backward_elemt``.

12. imgrec: full-width Inception-BN trained through ``main.run`` from
            ``inception_bn.conf``'s own data and eval sections (``iter =
            imgrec`` with ``image_mean``, ``rand_crop``, ``rand_mirror``,
            ``shuffle``, then ``iter = threadbuffer``; the eval section
            center-crops), only ``image_rec`` and ``image_mean``
            rewritten to files the phase writes from ``--seed``: 512
            train records (128 distinct images, written in turn) and 128
            val RGB images of 256x256 in the port's record files, twice: (a) as PNGs (its own PNG writer over zlib,
            every row filter in each image), decoded by ``png.cc``; (b)
            as JPEGs (its own numpy baseline writer, ``jpeg_encode``:
            quality 90, 4:2:0, the Annex K tables, restart markers in
            every fourth file), decoded by nvJPEG on the card. Each run:
            batch 128, bf16, SGD, 4 steps, one evaluation, one round
            written; the mean image is computed on first use and
            written, and the log must show ``device_normalize
            auto-resolved to 1``. Launch counts, set to 0 just before
            the first step and read after each: ``stem`` 1 a step and 0
            in the evaluation, ``bn_fwd`` = ``bn_bwd`` = 69 and
            ``sgd_apply`` = 2. Each step held against ``fused_kernels =
            0`` from the same state on the same uint8 batches with phase
            6's bounds; the folded input bit-equal to the ``input_fold =
            0`` path cast to bf16; the val crops bit-equal to the center
            crops of the decoded records (the encoded arrays for PNG;
            nvJPEG's pixels for JPEG, each at least JPEG_PSNR_MIN dB
            from its array); the written round answers finite softmax
            rows. Between the runs, (c) nvJPEG against the libjpeg pixels
            of ``tests/torch_jpeg_fixture.py`` (grey, 4:4:4, 4:2:2,
            4:2:0, progressive, restart intervals; its CMYK and YCCK
            files against the JAX package's pixels, cv2's conversion of
            libjpeg's CMYK) within its NVJPEG_BOUNDS, and the fixture
            decoded on 8 threads at once bit-equal to one thread. Before the phases' runs, with the other
            kernels, ``stem`` is held bit-equal to its plain version at
            the path shape (128x224x224x3 to bf16, a mean image), with a
            per-channel mean to f32 and f16, without a mean at a factor
            of 1/255, at a ragged 5x17x13x3, a batch of 1, 37 images,
            C 1 and 4, and cols 4 mod 8 and odd. Times, printed and not
            gated: ``stem`` and its rate beside its bound and plain
            version, the H2D copy of one uint8 and one float32 batch,
            the imgrec train step beside phase 6's, each run's train
            chain's decoded images/s with its ``decode_threads`` (and
            with 1), and each decoder alone (``png.cc``, nvJPEG) on 1
            and 8 threads.

13. tasks:  run right after phase 6, on its round (full-width
            Inception-BN, bf16, trained 4 steps), every task through
            ``main.run``, the launch counts set to 0 before each and
            read after it. ``pred_raw``, ``pred``, ``extract`` at
            ``gap`` (txt) and ``i_5b`` (1024x7x7, ``output_format =
            bin``) and ``get_weight`` (fc1's ``wmat``, bin) over a
            ``pred = <file>`` section of TASKS_INST synthetic rows at
            batch TASKS_BATCH, the last batch padded: each forward
            launches ``pool_fwd`` and ``epilogue_fwd``; ``pred_raw``'s
            rows finite and summing to 1 (1e-3), against the same task
            with ``fused_kernels = 0`` (no launch) at atol 2e-2 and the
            same top-1 wherever the margin exceeds 0.05; ``pred``'s ids
            the argmax of those rows; the ``.meta`` files ``nrow,1024,1,1``
            and ``nrow,1024,7,7``; each gap row within one bf16 ulp of
            the global average pool (``pool_fwd_plain``) of the i_5b row
            read as NHWC (the element order); fc1's ``wmat`` bit-equal to
            the round's. ``continue = 1`` with ``num_round = 2`` over
            phase 6's train section cut to TASKS_STEPS steps: it prints
            ``continuing from round 0``, loads params, momenta, BN state
            and counters bit-equal to the round, launches phase 6's
            counts a step, writes ``0001.model``, and its first loss is
            within 2e-2 * max(1, |loss|) of phase 6's trainer taking the
            same step from the round. ``task = finetune`` from the round
            with fc1 cut to FINETUNE_CLASSES: every other layer copied
            bit-equal, fc1 its fresh draw, phase 6's launch counts, round
            0 written. Printed, not gated: the ``pred_raw`` task's
            seconds and images/s end to end (the round's load, the net's
            build, the iterator and the text write), the forward at batch
            TASKS_BATCH with the kernels and with ``fused_kernels = 0``,
            the runs' and the phase's seconds, the card's name and power
            limit.

14. bowl:   ``examples/kaggle_bowl/bowl.conf``'s own train and eval
            sections (``iter = imgrec`` with ``max_rotate_angle = 180``,
            ``max_aspect_ratio = 0.5``, ``max_shear_ratio = 0.3``,
            ``min/max_crop_size = 32/48``, ``rand_crop``, ``rand_mirror``,
            ``shuffle`` and ``image_mean``; its netconfig at its own
            widths, 3x40x40, 121 classes, batch 64, float32), only
            ``image_rec`` and ``image_mean`` rewritten to JPEG records
            the phase writes from ``--seed``: 1,024 train and 256 val
            RGB images of 48x48, as ``gen_resize.py`` makes them. One
            round through ``main.run``: the 16 steps of the epoch (1,024
            records at batch 64), one evaluation, one round written; the
            mean computed on first use. Every step's launches, set to 0
            before it: ``epilogue_fwd`` = ``epilogue_bwd`` = the net's
            biased conv and fullc layers (7), ``sgd_apply`` = its tag
            groups (2), no other kernel (its 3x3/2 pools do not tile).
            Each step held against ``fused_kernels = 0`` from the same
            state on the same host batches (CONVNET_LOSS_TOL,
            CONVNET_GRAD_TOL at float32); ``warp.cc`` against
            ``warp_affine_plain`` on 8 of the phase's images within
            BOWL_WARP_ATOL; the written round answers finite softmax
            rows. Printed: the decoded-and-augmented images/s of the
            train chain and the step time.

15. rest:   the rest of training, each run through ``main.run`` with its
            launch counts set to 0 just before its first step and read
            after it. (a) Full-width Inception-BN with only
            ``compute_dtype = float16`` (batch 128, SGD, 4 steps):
            phase 6's launches a step; the loss scaler's scale and
            ``good`` after each step; each applied step held against
            ``fused_kernels = 0`` from the same state at phase 6's
            bounds (the yardstick plain f16 against plain f32), a step
            whose apply the scaler skipped (the deep net's float16
            gradients overflow at the first scale) skipped by the plain
            step too with every master bit-unchanged; at least 2 of the
            4 applied. A planted overflow (one batch of 1e8, past
            float16's 65504): the scale halved, ``good`` 0, every
            master and momentum bit-unchanged, and no host read in the
            step (PyTorch's CUDA sync debug mode, which sees the one
            sync of an ``.item()``); the next clean batch applies, the
            masters finite; with ``loss_scale_window = 2`` the scale
            doubles after two clean applies. (b) Full-width AlexNet at
            ``alexnet.conf``'s own fallback, batch 128 with
            ``update_period = 2`` (bf16, 4 steps): ``lrn_*`` 2 a step,
            ``sgd_apply`` 0 at the mid-period steps and one a tag group
            at the applies; masters and momenta bit-unchanged after
            each mid-period step; each step against ``fused_kernels =
            0`` from the same state and accumulator (the accumulator
            after a mid-period step, the update after an apply) at the
            bf16 convnet bounds; ``epoch_counter`` 2; the mid-period and
            apply steps timed. (c) Full-width Inception-BN (bf16) with
            ``train_chain = 4`` over one round of 10 batches: two chains
            and a tail of two ``update()`` calls, phase 6's launches a
            step, and with ``torch.backends.cudnn.deterministic`` set
            the losses, masters, momenta and BN statistics bit-equal to
            10 sequential ``update()`` calls from the same init. (d) The
            long-context LM with ``compute_dtype = float16`` (Adam, 4
            steps): phase 7's launches (2 / 1 / 1 / 2 a step, no apply
            skipped), each step's gradients against ``fused_kernels =
            0`` from the same state (LM_LOSS_TOL, LM_GRAD_TOL at
            float16), the step timed beside phase 7's bf16 step. Phase 3
            adds float16 cases at the paths' full-width shapes: the BN
            forward and backward at bn_stem1, the 7x7 pool backward and
            forward at batch 128, fc1's epilogue, and the SGD apply over
            Inception-BN's groups with the skip flag set (every bit
            kept) and clear (the flash kernels' f16 cases at the LM's
            shape were there before); phase 15 times those kernels in
            f16 beside bf16 on the same data, and the SGD apply with a
            clear flag beside none.

16. lm serve: run right after phase 7, on its round (the long-context
            LM trained 4 steps, ``<tmp>/lm/0000.model``) loaded by
            ``InferenceEngine.from_checkpoint``, the LM plane
            (``cxxnet_tpu_torch.serve.lm``) at LMS_KNOBS: blocks of 16,
            1,025 of them (8 x 128 and the scratch block), 8 decode
            rows, context 2048, prefill chunks of 128, 64 new tokens,
            bf16; pools and steps on the card. (a) ``paged_attention``
            on the card at decode (8, 1) and prefill (1, 128) over the
            whole pool and shuffled tables, against
            ``attention_reference`` over the same gathered keys: f32
            within 1e-5 of max(1, max|ref|), bf16 within one bf16 ulp.
            (b) 24 seeded prompts of 64-1536 tokens (LMS_PROMPTS): each
            prompt's last-position logits from the chunked prefill, as
            log-probabilities, against the eval forward of the same
            network at S 2048 (its mha through ``flash_fwd``, row 15a,
            launches counted): within 5e-3 of max(1, |log-prob|), top-1
            equal wherever the forward's margin exceeds 0.05; then the
            round served and run in f32, within 1e-5, where two faulty
            steps (each chunk's ``lengths`` one short; the last block
            of keys dropped) must read over 1e-5. (c) the
            same prompts through ``LMScheduler`` (8 rows, at most
            LMS_IN_FLIGHT sequences live, so the pool never runs dry)
            bit-equal, prompt by prompt, to ``generate_whole``; the
            runner cache's misses unchanged after its warm-up. (d) 16
            concurrent ``POST /generate`` clients over loopback
            (``ServeServer.attach_lm``; prompts of 64-960 tokens, so 16
            sequences fit the pool), half streamed and half ``"stream":
            0``, launch counts set to 0 just before and read just after
            (the LM step launches no hand kernel, and none may run):
            zero failures, every stream token events then ``done``,
            every answer equal to ``generate_whole``, ``/statz``'s
            ``lm`` block at ``kv_blocks_used`` 0 after the drain, the
            misses at their warm-up value. (e) a prefill-role scheduler
            handing each of (c)'s prompts to a decode-role one on the
            same card over loopback: the tokens equal (c)'s. (f) a pool
            that holds one of the two longest prompts and its 64 tokens
            only: the newer evicted under pressure (503's
            ``Backpressure``), the older's tokens equal, then one
            deadline eviction (5 ms), every block freed. Printed, not
            limited: the decode step at 8 live rows and the prefill
            chunk (CUDA events, median of 20), the decode step's
            kernels and idle share (torch.profiler), and run (d)'s
            tokens/s, TTFT and inter-token p50/p99, beside the card's
            name and power limit.
17. fleet:  run right after phase 16 (``phase_fleet``), full-width
            Inception-BN and the long-context LM on the one card through
            ``main.run`` (``task = serve serve_replicas = 2``; both
            replicas on ``cuda:0``, each dispatching from its own thread
            on the default stream). (a) Rounds A and B (numpy weights
            from two seeds, ``write_round``); open-loop ``/predict``
            clients (``raw = 1``, sizes FLEET_SIZES from 1 to 32, rows
            on a 1/8 grid of N(0, 1), FLEET_RATE a second for
            FLEET_LOAD_S) against one engine, then against the fleet
            (``serve_reload_s``) while round B lands in ``model_dir``
            at half time: no request fails, one sweep, both replicas on
            r0002, every answer within FLEET_ROW_TOL rel L2 of a single
            engine's on round A or B (and nearer it than the other by
            FLEET_SEP; a control, B's params with A's BN state, must
            read over FLEET_ROW_TOL), every request sent after the sweep
            on B, and ``pool_fwd`` / ``epilogue_fwd`` launched a
            forward's worth for each forward of each replica;
            closed-loop in-process load (FLEET_CLIENTS, FLEET_CLOSED_S)
            on both; printed: answers/s and latency of the fleet and the
            engine, and the latency of requests in flight during the
            sweep against the rest, each with the count of requests
            behind it (a p99 only over P99_MIN_N or more). (b) ``serve_ab = 1``, one canary: after the canary
            reload, ``X-Model-Version`` pins answer from their rounds,
            r0042 gets 400, ``/statz`` ``versions`` holds both,
            ``promote()`` brings both replicas to B. (c) ``serve_dtype =
            int8`` over round A quantized over served rows: 70 ``q_mm`` a
            forward on both replicas, the replicas' dispatches run at
            once bit-equal to serial ones (``split_scratch`` on one
            stream), a plain round landing refused once (no drain, both
            replicas up on r0001-int8), int8 against float32 within
            INT8_VS_FP. (d) Phase 7's LM round quantized by the quant
            CLI over its ``synthetic_lm`` section (the prompts'
            distribution) and served int8 by two replicas with an LM
            plane each (``attach_lm``): concurrent decodes of the two
            bit-equal to serial ones; the f32 logits of a prefill chunk
            a row and a decode step over 8 rows (the ``lm_head`` through
            ``q_mm`` at M 128 and 8, every launch of the pipelined
            variant) within LMF_STEP_TOL of the same steps with
            ``fused_kernels = 0``; streamed ``/generate`` clients
            (LMF_PROMPTS) across ``set_lm_role(0, "prefill", peer=...)``
            all equal to ``generate_whole``, the second wave handed off;
            one ``q_mm`` launch every LM step (prefill chunk and decode
            step, the ``lm_head`` at M 128 and 8); int8 and bf16 greedy
            tokens equal over the leading steps where bf16's margin
            clears LMF_MARGIN, and, teacher-forced on bf16's tokens,
            int8's greedy token equal on every step where bf16's
            log-prob margin exceeds LMS_MARGIN; a reload of the decode replica with two
            live sequences swaps only once they finished (the
            ``live_count`` probe), and the KV pools are empty after.
            Printed: the int8 decode step at 8 live rows (ms, launches,
            profile) beside phase 16's bf16 one.
18. cascade: run right after phase 17 on its round A and the int8
            round (c) derived from it (``phase_cascade``), full-width
            Inception-BN through ``main.run``. (a) ``cascade_enable =
            1``, ``cascade_model`` the int8 round, one replica a tier on
            ``cuda:0``, ``cascade_threshold`` between the two middle
            margins of an int8 engine over the request rows (phase 17's
            FLEET_SIZES requests, 1 to 32 rows): no request fails, each
            answer row within FLEET_ROW_TOL rel L2 of the int8 engine's
            where it stays and of the bf16 engine's where it escalates
            (either, within CASCADE_BAND of the threshold), the
            escalation count the mask's outside that band, and
            ``q_mm`` (70 a fast forward), ``pool_fwd`` and
            ``epilogue_fwd`` launched between the first request and the
            last; then closed-loop in-process load (CASCADE_CLIENTS,
            CASCADE_CLOSED_S) on the cascade and on its bf16 flagship
            replica alone (version-pinned), over the same requests.
            (b) ``deploy_enable = 1`` over two bf16 replicas,
            ``deploy_poll_s = 0``, DEPLOY_WINDOW_S and DEPLOY_BACKOFF_S,
            ticked through the server's ``reload_watcher`` while
            DEPLOY_CLIENTS in-process clients keep load on it: round A
            times 1 + DEPLOY_NOISE N(0, 1) canaries, then promotes, and
            both replicas answer within FLEET_ROW_TOL of one engine on
            it; NaN in DEPLOY_NAN_LAYER's weights is blocked naming that
            layer; fc1's columns permuted (finite, SUSPECT) canaries and
            rolls back on the parity gate, the canary's answers bit-equal
            to its answers before the canary, and the backoff refuses
            the round again; no request fails; ``pool_fwd`` and
            ``epilogue_fwd`` launched. (c) Printed: the escalation rate,
            the cascade's answers/s and latency beside the flagship's
            alone, and the canary, promote, blocked and rollback ticks'
            seconds, beside the card's name and power limit.
19. telemetry: run last (``phase_telemetry``), full-width Inception-BN
            (batch 128, bf16, ``iter = synthetic``). (a) A child process
            ``python -m cxxnet_tpu_torch.main`` trains TEL_STEPS steps
            with ``telemetry_profile_steps = 8-9``, ``telemetry_trace``,
            ``telemetry_ledger`` and ``telemetry_port``: ``/metrics``
            answers while it trains; its torch.profiler summary names
            every device kernel of the hand kernels of the train step
            (TEL_FRAGMENTS), each as many times a step as one step's
            CUDA graph in this process holds it (``_graph_nodes``). (b)
            ``failpoints = device.step=once`` through ``main.run`` with
            ``continue = 1`` on (a)'s round: the ledger has
            ``sentinel_trip`` and ``rollback``, and the run ends with
            finite parameters. (c) ``task = serve`` on that round:
            ``GET /metrics`` counts exactly the TEL_REQUESTS requests
            sent. Printed: the step-time probe's EMAs and verdict, and
            the trace's medians of its spans over steps 2-7, the host
            syncs of one update with the train metrics on (CUDA sync
            debug mode), and the step with the default telemetry beside
            ``telemetry_steptime = 0 sentinel = 0`` (not gated: a host
            drifts 25-35 % between runs), beside the card's name and
            power limit. Run alone with ``--phase telemetry``.
20. data_service: run after phase 19 (``phase_data_service``). (a)
            DS_RECORDS JPEG records (DS_UNIQUE seeded images written in
            turn, so the DS_SHARDS byte ranges split the file at its
            middle) and a mean image, written under a ``file://`` URL
            through the stream layer; two reader processes
            ``python -m cxxnet_tpu_torch.main ... task=data_reader
            dev=gpu:0`` (nvJPEG on this card), one shard each. (b) One
            epoch through ``ServiceIterator``: uint8 batches, labels,
            ``inst_index`` and ``norm`` bit-equal to ``data_service =
            local`` in this process; a second client's pass is served
            wholly from the readers' caches. (c) Full-width Inception-BN
            (bf16, SGD, batch 128, cuDNN deterministic) through
            ``main.run`` with ``continue = 1`` from a seeded round 0,
            rounds 1 and 2 of DS_STEPS batches over the readers: reader
            1 is SIGKILLed after step DS_KILL_STEP of round 1 (failover
            and rebalance onto reader 0), reader 0 after step
            DS_KILL_STEP of round 2 (one degrade warning); each step's
            loss, the masters, momenta and BN statistics bit-equal to an
            uninterrupted ``data_service = local`` run; launches per
            step DS_WANT, and every kernel of the train path launched.
            (d) That run's ``model_dir`` is a ``file://`` URL with
            ``failpoints = io.read=once``: one ``io.retries``; its round
            2 answers ``task = pred`` to a ``file://`` output. Printed,
            not gated: the probe's data wait a step over the service and
            local, the readers' frames/s, the fetch latency p50/p99 cold
            and cached, beside the card's name and power limit. Run
            alone with ``--phase data_service``.
21. grammar: run last (``phase_grammar``). (a) ``tiny_moe_lm.conf`` as
            written (E 64, S 64, batch 64, 4 experts top-2, Adam, f32;
            ``attn_impl = flash``, since its S 64 is under the 128 block
            that ``auto`` wants for the flash path) one round of 32 steps
            through ``main.run`` with the kernels, then with
            ``fused_kernels = 0`` from the same init: finite losses;
            per step ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` 1
            a mha layer and ``adam_apply`` 1 a tag group, every step,
            and none under ``fused_kernels = 0``; each step's loss and
            gradients with the kernels against the plain step from the
            same state (LM_LOSS_TOL, LM_GRAD_TOL in f32), a step where a
            token is routed otherwise counted and its gradients not held
            when that token's first three gates lie within MOE_TIE (a
            near-tie), failing otherwise; ``task = pred`` on the round.
            (b) bowl.conf's net and sections with one EXTRA_DIM-wide
            ``extra_data`` input concatenated after ``fl``, fed by
            ``attachtxt`` (a side file lacking every fifth id) over
            GRAMMAR_TRAIN + GRAMMAR_VAL 48x48 JPEG records, every
            GRAMMAR_FOUR-th the fixture's CMYK or YCCK file (nvJPEG's
            four planes): one round through ``main.run``, per step one
            ``epilogue_fwd`` and ``epilogue_bwd`` a biased conv or fullc
            and ``sgd_apply`` a tag group, no other kernel, each step
            against ``fused_kernels = 0`` from the same state (phase 14's
            bounds); nvJPEG on the CMYK and YCCK files within
            NVJPEG_BOUNDS of their CPU pixels. (c) bias, prelu (with its
            train-time noise), fixconn, maxout (conv and flat), pairtest
            (conv against conv), a plugin layer and insanity_max_pooling's
            training pick at AlexNet's node shapes (batch 256), f32 on
            the card against the CPU with shared params, draws and
            upstream gradient (GRAMMAR_ELEM_TOL, GRAMMAR_SUM_TOL,
            GRAMMAR_PICK_SHARE); AlexNet's conv2 weight gradient (5x5,
            2 groups) of the port's float32 conv (its im2col gemm) and
            of cuDNN's own algorithm, with and without
            ``cudnn.deterministic`` (named from the profiler's kernels),
            each held against a float64 CPU reference, the port's within
            GRAMMAR_SUM_TOL. Printed: the phase's seconds, the MoE and
            attachtxt train steps' ms, beside the card's name and power
            limit. Run alone with ``--phase grammar``.
22. operations: run last (``phase_operations``), full-width
            Inception-BN (batch 128, bf16, ``iter = synthetic``) through
            ``main.run``, which trains with cuDNN's deterministic
            algorithms; the script sets no cuDNN flag. (a) OPS_STEPS steps with
            ``health = 1 health_interval = OPS_INTERVAL`` and with
            ``health = 0`` from one seed: each step's loss, the masters,
            momenta and BN statistics bit-equal; the host syncs of the
            run (CUDA sync debug mode) at most one more an interval with
            health on; one step's CUDA graph with ``health = 0`` holds as
            many nodes as phase 19's; the ``cxxnet_health_*`` gauges on
            ``GET /metrics`` while it trains. Each run pushes to a
            ``telemetry_fleet_dir`` where the script writes a second
            host's snapshot with 3x the trainer's step time: the
            aggregator's straggler verdict names host 1 (round line and
            ``straggler`` event). (b) ``failpoints = device.step=every:7``
            with ``health = 1``, rounds of OPS_ROUND_STEPS, through
            ``python -m cxxnet_tpu_torch.main`` in a process of its own:
            the ``sentinel_trip`` and ``rollback`` events carry the same
            non-empty provenance. (c) ``python -m
            cxxnet_tpu_torch.replay <(b)'s ledger> --last --failpoints
            on`` exits 0 with ``bit_exact`` and that provenance;
            ``--failpoints off`` exits 0 or 2; ``--config`` with another
            ``eta`` exits 3 with ``unreproducible:config-drift``. (d) A
            ``throttle`` data section with ``throttle_ms`` OPS_THROTTLE_MS
            under ``telemetry_hang_s = 1``: one ``hang_dump`` or more,
            with the threads' stacks. (e) One data-service reader
            process (``telemetry_trace``) serving the trainer with
            ``telemetry_trace_sample = 1``: ``tools/trace_assemble.py``
            links every ``dataservice.fetch`` to the reader's
            ``dataservice.serve``; a ``traceparent`` sent to ``task =
            serve`` parents its ``serve.request`` span. (f) Phase 19's
            profile bracket printed the per-phase attribution line, with
            ``conv``, ``bn_act``, ``pool`` and ``optim`` non-zero, and
            ``bn_act`` holds every ``bn_fwd`` and ``bn_bwd`` launch of
            its summary. Printed, not gated: the health on and off step
            ms, the probe's syncs, the replay's and the phase's seconds,
            beside the card's name and power limit. Run alone with
            ``--phase operations`` (phase 19 first, for (f)).

Then, on lines of their own: the card's name and power limit as
``nvidia-smi`` reports them, the kernels JSON line, and last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits 2 when
there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import io
import pickle
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "examples", "ImageNet", "inception_bn.conf")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, and the bf16 tensor cores' dense FLOP/s (the
# peak for attention's products on bf16 inputs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: and the int8 tensor cores' dense operations per second (the peak for
#: the int8 product of phase 10)
INT8_OPS = 1979e12
#: exponentials per second on the SFU: 16 a clock per SM (the CUDA
#: programming guide's arithmetic-throughput table, compute capability
#: 9.0) on 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9

BUCKETS = (1, 8, 32)
SERVE_KERNELS = ("pool_fwd", "epilogue_fwd")
TRAIN_KERNELS = SERVE_KERNELS + ("pool_bwd", "epilogue_bwd", "bn_fwd",
                                 "bn_bwd", "sgd_apply")
#: a net whose batch_norm_no_ma normalizes with batch moments at eval
NO_MA_NET = """
netconfig = start
layer[in->c] = conv:cv
  kernel_size = 3
  nchannel = 16
  pad = 1
  no_bias = 1
layer[c->b] = batch_norm_no_ma:bn
layer[b->r] = relu:ac
layer[r->f] = flatten:fl
layer[f->o] = fullc:fc
  nhidden = 5
layer[o->o] = softmax:sm
netconfig = end
input_shape = 8,7,7
compute_dtype = bfloat16
"""
LM_CONF = os.path.join(ROOT, "examples", "LM", "long_context_lm.conf")
#: the long-context LM's attention: (B, S, H, D, dtype, causal)
LM_PATH_ATTN = (8, 2048, 8, 16, torch.bfloat16, True)
LM_STEPS = 4            # batches of 8: num_inst cut from 256 to 32
#: the kernels' times before their redesign, as PERF.md's kernel table
#: has them (ms on the H100 at the path shapes), printed beside the new
#: ones
PERF_BEFORE_MS = {"bn_fwd": "0.4064 ms",
                  "bn_fwd (mid)": "0.02807 ms",
                  "bn_sums": "0.07506 ms",
                  "flash_fwd": "0.8869 ms",
                  "flash_bwd_dq": "0.7877 ms",
                  "flash_bwd_dkv": "0.7659 ms",
                  "q_mm conv1 b32": "0.1640 ms",
                  "q_mm fc6 b32": "0.1918 ms warm",
                  "bn_bwd_sums": "0.1768 ms",
                  "pool_fwd": "0.00923 ms",
                  "bn_bwd": "0.7367 ms",
                  "bn_bwd_dx": "0.1889 ms",
                  "epilogue_bwd": "0.004553 ms",
                  "epilogue_bwd (cv1)": "0.2254 ms",
                  "bn_norm": "0.1430 ms",
                  "pool_bwd_max": "0.07046 ms",
                  "stem": "0.04496 ms",
                  "epilogue_fwd": "0.002147 ms",
                  "epilogue_fwd (alexnet cv1)": "0.2036 ms",
                  "epilogue_fwd (alexnet cv2)": "0.1321 ms",
                  "epilogue_fwd (spp cv1)": "0.3959 ms",
                  "adam_apply": "0.01181 ms",
                  "adam_apply (Inception-BN)": "0.1194 ms"}
TRAIN_BATCH = 128       # the flagship's batch_size
TRAIN_STEPS = 4         # 512 synthetic rows
TRAIN_IMAGE, TRAIN_CLASSES = "3,224,224", 1000


def bound_ms(nbytes: int, nops: int, flops: float = F32_FLOPS):
    """Least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type
    (float32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(nbytes: int, nflops: int, nexp: int):
    """Least time of a flash-attention kernel: the largest of its bytes
    over the memory rate, its products over the bf16 tensor cores' rate
    and its exponentials over the SFU's (each kernel computes P once).
    Returns (ms, "bytes" or "operations", the term that bounds it)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "tensor-core FLOPs": nflops / BF16_FLOPS * 1e3,
             "exponentials": nexp / SFU_EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term == "bytes" else "operations",
            term)


def time_call(fn, reps: int = 20, inner: int = 50) -> float:
    """Median device time of one ``fn()`` in ms: ``inner`` calls
    captured in a CUDA graph, replayed ``reps`` times between CUDA
    events (device time, without the host's launch cost)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def time_forward(fn, reps: int = 20) -> float:
    """Median wall time of one ``fn()`` on the device in ms, each timed
    alone between CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_loop(fn, reps: int = 20) -> float:
    """Median over 5 runs of the time of ``reps`` host-launched calls of
    ``fn`` between CUDA events, per call, in ms (for calls that cannot
    be captured in a CUDA graph)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


#: kernel-name fragments -> what the time is spent on (first match wins)
_KINDS = (("q_mm_kernel", "q_mm kernel"),
          ("flash_fwd_kernel", "flash fwd kernel"),
          ("flash_fwd_tc", "flash fwd kernel"),
          ("flash_bwd_dq_kernel", "flash dq kernel"),
          ("flash_bwd_dq_tc", "flash dq kernel"),
          ("flash_bwd_dkv_kernel", "flash dkv kernel"),
          ("flash_bwd_dkv_tc", "flash dkv kernel"),
          ("adam_apply_kernel", "adam kernel"), ("embedding", "embedding"),
          ("nvjet", "matmul"),
          ("lrn_fwd_kernel", "lrn kernel"), ("lrn_bwd_kernel", "lrn kernel"),
          ("pool_fwd_kernel", "pool kernel"), ("pool_bwd_kernel", "pool kernel"),
          ("pool_bwd_max_kernel", "pool kernel"),
          ("epilogue_fwd_kernel", "epilogue kernel"),
          ("epibwdvec", "epilogue bwd kernel"),
          ("mask_copy_vec", "epilogue bwd kernel"),
          ("momentsvec", "bn moments kernel"),
          ("sqdevvec", "bn moments kernel"),
          ("bn_fwd_norm_vec", "bn fwd normalize kernel"),
          ("colsum_vec", "bn sums kernel"),
          ("bn_norm_vec", "bn kernel"), ("bn_dx", "bn kernel"),
          ("sgd_apply_kernel", "sgd kernel"),
          ("conv", "conv"), ("xmma", "conv"), ("cudnn", "conv"),
          ("gemm", "matmul"), ("sm90", "conv/matmul"),
          ("cat", "concat"), ("reduce", "reduce"), ("pool", "torch pool"),
          ("elementwise", "elementwise"), ("copy", "copy/cast"))


def profile_calls(fn, n: int = 5, what: str = "forward") -> str:
    """torch.profiler over ``n`` calls of ``fn``: kernels per call, the
    device's busy share of the span its kernels cover, host time per
    call, and device time by kind of kernel."""
    return profile_kinds(fn, n, what)[0]


def profile_kinds(fn, n: int = 5, what: str = "forward"):
    """:func:`profile_calls`'s line, and per kind of kernel (``_KINDS``)
    the device ms and the launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return "no device events in the trace (not measured)", {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_kind, other, count = {}, {}, {}
    for e in kern:
        name = e.name.lower()
        kind = next((k for frag, k in _KINDS if frag in name), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total
        count[kind] = count.get(kind, 0) + 1
        if kind == "other":
            other[e.name[:60]] = other.get(e.name[:60], 0.0) \
                + e.device_time_total
    total = sum(by_kind.values())
    kinds = ", ".join(f"{k} {v / n / 1e3:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1]))
    top = "; ".join(f"{k} {v / n / 1e3:.3f} ms" for k, v in
                    sorted(other.items(), key=lambda kv: -kv[1])[:3])
    return (f"{len(kern) / n:.0f} kernels per {what}, host {wall_ms:.3f} "
            f"ms per {what}, device busy {busy / n / 1e3:.3f} ms per {what}"
            f" = {100 * busy / span:.1f}% of the kernels' span (idle "
            f"{100 - 100 * busy / span:.1f}%) | device time: {kinds}"
            f" | largest other: {top}",
            {k: (v / n / 1e3, count[k] / n) for k, v in by_kind.items()})


def launch_breakdown(fn, n: int = 20) -> str:
    """torch.profiler over ``n`` calls of ``fn``: the mean device time of
    a launch and the launches per call of each kernel it launches, by
    name (a wrapper that makes more than one launch shows each apart; a
    trace that lost events shows fewer launches a call, not a shorter
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.device_time_total, k + 1)
    if not by_name:
        return "no device events in the trace (not measured)"
    return ", ".join(f"{name.split('(')[0][:48]} {t / k:.2f} us x{k / n:g}"
                     for name, (t, k) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][0]))


# -- phase 1 ------------------------------------------------------------------

def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    cc = torch.cuda.get_device_capability(0)
    import fsspec
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} fsspec {fsspec.__version__} device "
          f"{torch.cuda.get_device_name(0)} cc {cc[0]}.{cc[1]} count "
          f"{torch.cuda.device_count()} | {smi_line}", flush=True)
    if cc != (9, 0):
        raise RuntimeError(f"compute capability {cc}: the kernels are "
                           "built for sm_90a (Hopper)")
    return smi_line


# -- phase 2 ------------------------------------------------------------------

def build_host_libs() -> dict:
    """Build and load the image pipeline's host libraries (``native/``:
    png.cc, warp.cc, nvjpeg.cc against the CUDA toolkit) with g++;
    returns seconds per library."""
    from cxxnet_tpu_torch.io import augment, decode
    times = {}
    for name, load in (("png.cc", decode._png), ("warp.cc", augment._warp),
                       ("nvjpeg.cc", decode._nvjpeg_lib)):
        t0 = time.perf_counter()
        load()
        times[name] = time.perf_counter() - t0
    return times


def phase_build():
    import concurrent.futures as futures
    from cxxnet_tpu_torch.ops import KERNELS, _build
    sources = sorted({k.source for k in KERNELS.values()})
    t0 = time.perf_counter()
    with futures.ThreadPoolExecutor(1) as ex:
        host = ex.submit(build_host_libs)  # g++ beside the nvcc builds
        per = _build.build(sources)
        host_times = host.result()
    took = time.perf_counter() - t0
    regs = []
    for src in sources:
        used = [ln.split("info    :")[-1].strip()
                for ln in _build.build_log(src).splitlines()
                if "Used" in ln]
        regs.append(f"{src}: {'; '.join(used[:3]) or 'cached'}")
    print(f"build: {len(sources)} sources with nvcc for sm_90a in "
          f"{took:.1f}s ({', '.join(f'{s} {t:.1f}s' for s, t in per.items())})"
          f" | ptxas {' | '.join(regs)} | host libraries with g++ beside "
          f"them: {', '.join(f'{k} {v:.1f}s' for k, v in host_times.items())}",
          flush=True)
    for src in REPORT_PTXAS:
        print(f"ptxas {src}: " + ", ".join(
            f"{name} {n} registers" + (f" {sp} bytes spilled" if sp else "")
            for name, n, sp in ptxas_functions(_build.build_log(src))
            if not name.startswith("_Z")),
            flush=True)


#: the sources whose every kernel's registers and spills phase 2 prints
REPORT_PTXAS = ("flash_fwd.cu", "flash_bwd.cu", "q_mm.cu", "bn_sync.cu",
                "bn_fwd.cu", "bn_bwd.cu", "pool_fwd.cu", "epilogue_bwd.cu",
                "lrn_fwd.cu", "lrn_bwd.cu", "pool_bwd_max.cu", "stem.cu",
                "epilogue_fwd.cu", "adam_apply.cu")


def ptxas_functions(log: str):
    """(kernel with its template arguments, registers, spill-store bytes)
    of each entry function in an ``nvcc -Xptxas -v`` log."""
    import re
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"(flash_\w+?_(?:tc|kernel)|q_mm_kernel|"
                          r"colsum_vec|bn_dx_vec|bn_norm_vec|bn_fwd_norm_vec|"
                          r"mask_copy_vec|pool_fwd_kernel|lrn_fwd_kernel|"
                          r"lrn_bwd_kernel|pool_bwd_max_kernel|stem_kernel|"
                          r"epilogue_fwd_kernel|adam_apply_kernel)"
                          r"(?:I(\w+))?", m.group(1))
            if k is None:
                name = m.group(1)
            elif k.group(2) is None:          # not a template
                name = k.group(1)
            else:
                g = k.group(2)
                ops = "BwdSumsVec|EpiBwdVec|MomentsVec|SqDevVec"
                op = re.match(rf"\d+({ops})I", g)
                args = [op.group(1)] if op else []
                args += ["f32"] if g.startswith("f") or re.match(
                    rf"\d+(?:{ops})If", g) else []
                args += [{"13__nv_bfloat16": "bf16", "6__half": "f16"}.get(t, t)
                         for t in re.findall(
                             r"13__nv_bfloat16|6__half|(?<=L[ib])\d+(?=E)",
                             k.group(2))]
                name = f"{k.group(1)}<{','.join(args)}>"
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


# -- phase 3 ------------------------------------------------------------------

def _ulp_tol(dtype) -> float:
    """Relative tolerance: one unit in the last place of ``dtype``
    (sums taken in float32 in another order may round across one)."""
    return {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[dtype]


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version; returns the largest error
    per kernel at the serving path's shape."""
    from cxxnet_tpu_torch.ops.fused_epilogue import bias_act_plain, fused_bias_act
    from cxxnet_tpu_torch.ops.fused_pool import fused_pool, pool_fwd_plain
    dev = torch.device("cuda")
    path_err = {}
    lines = []

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # (shape, dtype, window, reducer, avg, relu, how): "" plain inputs,
    # "nan" a NaN planted in some windows, "offset" x and y 2 bytes past a
    # 16-byte boundary (the one-element loads)
    pool_cases = [((b, 7, 7, 1024), torch.bfloat16, 7, 7, "sum", True, False,
                   "") for b in (1, 5, 32)]
    pool_cases += [
        ((3, 14, 14, 64), torch.float32, 2, 2, "max", False, True, ""),
        ((3, 14, 14, 64), torch.float16, 2, 2, "sum", False, False, ""),
        ((5, 7, 7, 256), torch.float16, 7, 7, "sum", False, True, ""),
        ((2, 8, 8, 96), torch.float32, 8, 8, "sum", True, False, ""),
        ((100, 8, 8, 32), torch.float32, 2, 2, "max", False, False, ""),
        ((4, 6, 6, 20), torch.bfloat16, 3, 3, "max", False, True, ""),
        ((3, 7, 7, 1000), torch.bfloat16, 7, 7, "sum", True, False, ""),
        ((2, 7, 7, 1024), torch.bfloat16, 7, 7, "sum", True, False,
         "offset"),
        ((2, 4, 4, 64), torch.bfloat16, 2, 2, "max", False, True, "nan"),
        ((2, 7, 7, 64), torch.bfloat16, 7, 7, "sum", False, False, "nan"),
        # the float16 training path's global average (phase 15)
        ((TRAIN_BATCH, 7, 7, 1024), torch.float16, 7, 7, "sum", True, False,
         ""),
    ]
    for shape, dt, kh, kw, red, avg, relu, how in pool_cases:
        x = rnd(shape, dt)
        if how == "offset":
            x = rnd((x.numel() + 1,), dt)[1:].view(shape)
        if how == "nan":
            x.view(-1)[::37] = float("nan")
        got = fused_pool(x, kh, kw, red, avg, relu)
        want = pool_fwd_plain(x, kh, kw, red, avg, relu)
        torch.cuda.synchronize()
        nan_ok = torch.equal(got.isnan(), want.isnan())
        err = (got.float() - want.float()).abs().nan_to_num(0.0)
        tol = 0.0 if red == "max" else _ulp_tol(dt)
        bad = err > tol * want.float().abs().nan_to_num(0.0) + 1e-6
        name = "avg" if avg else red
        lines.append(f"pool {name} {kh}x{kw} {tuple(shape)} "
                     f"{str(dt)[6:]} relu={int(relu)} {how or 'plain'}: "
                     f"max_abs_err {err.max().item():.3g} (tol "
                     f"{tol:.3g}*|plain| + 1e-6), NaNs where plain has them "
                     f"{nan_ok}")
        if bad.any() or not nan_ok:
            raise AssertionError("pool kernel disagrees: " + lines[-1])
        if shape == (32, 7, 7, 1024):
            path_err["pool_fwd"] = err.max().item()

    # (shape, dtype, bias, act, how): "" plain inputs, "offset" x 2 or 4
    # bytes past a 16-byte boundary (the one-element loads), "nan" NaN, +0
    # and -0 planted (NaN where the plain version has one, the rest equal)
    epi_cases = [((b, 1000), torch.bfloat16, True, "none", "")
                 for b in (1, 5, 32)]
    epi_cases += [((2 * 28 * 28, 192), torch.bfloat16, True, "relu", ""),
                  ((37, 192), torch.float32, False, "relu", ""),
                  ((9, 333), torch.float16, True, "relu", "")]
    epi_cases += [(EPI_CV1, torch.bfloat16, True, "relu", ""),
                  (EPI_FWD["spp cv1"][:2], torch.bfloat16, True, "none", ""),
                  (EPI_FC6, torch.bfloat16, True, "relu", ""),
                  ((333, 5), torch.bfloat16, True, "relu", ""),
                  ((1000, 7), torch.float16, True, "none", ""),
                  ((37, 1001), torch.float32, True, "relu", ""),
                  ((1000, 96), torch.bfloat16, True, "relu", "offset"),
                  ((64, 1000), torch.float32, True, "none", "offset"),
                  ((999, 40), torch.bfloat16, True, "none", "nan"),
                  ((999, 40), torch.float16, True, "relu", "nan"),
                  ((999, 40), torch.float32, False, "relu", "nan"),
                  # the float16 training path's fc1 (phase 15)
                  ((TRAIN_BATCH, 1000), torch.float16, True, "none", "")]
    for shape, dt, with_bias, act, how in epi_cases:
        x = rnd(shape, dt)
        if how == "offset":
            x = rnd((x.numel() + 1,), dt)[1:].view(shape)
        if how == "nan":
            x.view(-1)[::17] = float("nan")
            x.view(-1)[5::23] = 0.0
            x.view(-1)[7::29] = -0.0
        bias = rnd((shape[1],), torch.float32) if with_bias else None
        got = fused_bias_act(x, bias, act)
        want = bias_act_plain(x, bias, act)
        torch.cuda.synchronize()
        nan = want.isnan()
        nan_ok = torch.equal(got.isnan(), nan)
        err = (got.float() - want.float()).abs()[~nan].max().item()
        lines.append(f"epilogue {tuple(shape)} {str(dt)[6:]} "
                     f"bias={int(with_bias)} act={act} {how or 'plain'}: "
                     f"max_abs_err {err:.3g} (tol 0: one rounding on both "
                     f"sides), NaNs where plain has them {nan_ok}")
        if err != 0.0 or not nan_ok:
            raise AssertionError("epilogue kernel disagrees: " + lines[-1])
        if shape == (32, 1000):
            path_err["epilogue_fwd"] = err
    print(f"kernels: {len(lines)} cases agree with the plain versions | "
          + " | ".join(lines), flush=True)
    return path_err


def flagship_shapes(conf: str, batch: int = TRAIN_BATCH):
    """(BN inputs as (N, C) rows at ``batch`` in graph order, param leaf
    shapes by tag group) of the net config ``conf``."""
    from cxxnet_tpu_torch.config import parse_config_file, split_sections
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg, _ = split_sections(parse_config_file(conf))
    graph = build_graph(cfg)
    net = Network(graph, cfg, device="cpu")
    bn = []
    for spec in graph.layers:
        if spec.type.startswith("batch_norm"):
            c, y, x = net.node_shapes[spec.nindex_in[0]]
            bn.append((batch * y * x, c))
    return bn, param_groups(net)


def param_groups(net):
    """Parameter leaf shapes of ``net`` by tag group."""
    from cxxnet_tpu_torch.optim import tag_for_param
    groups = {}
    for path, shape in net._expected()[0].items():
        groups.setdefault(tag_for_param(path[-1]), []).append(shape)
    return groups


def lm_shapes(conf: str):
    """(the LM's network on the CPU, its parameter leaf shapes by tag
    group) of the net config ``conf``."""
    from cxxnet_tpu_torch.config import parse_config_file, split_sections
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg, _ = split_sections(parse_config_file(conf))
    net = Network(build_graph(cfg), cfg, device="cpu")
    return net, param_groups(net)


def phase_train_kernels(gen: torch.Generator, conf: str) -> dict:
    """The training kernels against their plain versions: at the
    training path's shapes (bn_stem1 and the last BN layer, the 7x7
    global average's backward, fc1's epilogue backward, Inception-BN's
    parameter set) in bf16, AlexNet-like cv1 rows of the epilogue
    backward, and at odd shapes in f16 and f32. Returns the largest
    error per kernel at the path's shape."""
    from cxxnet_tpu_torch.ops.fused import sm_count
    from cxxnet_tpu_torch.ops.fused_epilogue import (epilogue_bwd_plain,
                                                     epilogue_bwd_plan,
                                                     fused_epilogue_bwd)
    from cxxnet_tpu_torch.ops.fused_norm import (bn_act_plain, bn_bwd,
                                                 bn_bwd_dx, bn_bwd_plain,
                                                 bn_fwd, bn_norm_plain,
                                                 colsum_vec_depth)
    from cxxnet_tpu_torch.ops.fused_optim import (fused_sgd_apply,
                                                  sgd_apply_plain)
    from cxxnet_tpu_torch.ops.fused_pool import (fused_pool_bwd_lin,
                                                 pool_bwd_lin_plain)
    dev = gen.device
    bn_shapes, groups = flagship_shapes(conf)
    path_err, lines = {}, []

    def rnd(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def ulp_bad(got, want, dtype, atol):
        err = (got.float() - want.float()).abs()
        return err, bool((err > _ulp_tol(dtype) * want.float().abs()
                          + atol).any())

    bn_cases = [(bn_shapes[0], torch.bfloat16, True, False),
                (bn_shapes[-1], torch.bfloat16, True, False),
                (bn_shapes[0], torch.float16, True, False),
                ((333, 200), torch.float16, True, True),
                ((1000, 64), torch.float32, False, False),
                ((37, 3), torch.float32, True, True)]
    for (n, c), dt, relu, two_pass in bn_cases:
        act = "relu" if relu else "none"
        x = rnd((n, c), dt, 1.5, 0.25)
        g = rnd((c,), torch.float32, 0.2, 1.0)
        b = rnd((c,), torch.float32, 0.1)
        y, mean, var, rstd = bn_fwd(x, g, b, 1e-5, act, two_pass)
        y0, mean0, var0 = bn_act_plain(x, g, b, 1e-5, act, two_pass)
        # with its own moments, y is the plain normalize's bit for bit
        same_norm = torch.equal(y, bn_norm_plain(x, g, b, mean, rstd, act))
        dy = rnd((n, c), dt)
        yy = y if relu else None
        dx, dg, db = bn_bwd(x, dy, yy, g, mean, rstd)
        dx0, dg0, db0 = bn_bwd_plain(x, dy, yy, g, mean, rstd)
        # bn_bwd_dx reads y, bn_bwd's dx pass the mask bits: with the same
        # sums over N (divided once, as bn_bwd does) the same dx
        dxy = bn_bwd_dx(x, dy, yy, g, mean, rstd, (db.double() / n).float(),
                        (dg.double() / n).float())
        torch.cuda.synchronize()
        ints = torch.int32 if dt == torch.float32 else torch.int16
        same_y = torch.equal(dx.view(ints), dxy.view(ints))
        stat = max((mean - mean0).abs().max().item(),
                   ((var - var0).abs() / var0.clamp(min=1e-6)).max().item())
        ey, bad_y = ulp_bad(y, y0, dt, 1e-4)
        edx, bad_dx = ulp_bad(dx, dx0, dt, 1e-3)
        egb = max(((dg - dg0).abs() / (dg0.abs() + 1.0)).max().item(),
                  ((db - db0).abs() / (db0.abs() + 1.0)).max().item())
        lines.append(f"bn ({n},{c}) {str(dt)[6:]} relu={int(relu)} "
                     f"two_pass={int(two_pass)}: y {ey.max().item():.3g}, "
                     f"y = bn_norm_plain's with its moments {same_norm}, "
                     f"stats {stat:.3g}, dx {edx.max().item():.3g}, "
                     f"dgamma/dbeta {egb:.3g}, dx = bn_bwd_dx's with its "
                     f"sums {same_y}")
        if (bad_y or bad_dx or stat > 1e-4 or egb > 1e-3 or not same_y
                or not same_norm):
            raise AssertionError(
                "bn kernels disagree (tol: y one ulp + 1e-4 and bit-equal "
                "to bn_norm_plain with its own moments, dx one ulp + 1e-3, "
                "stats 1e-4, dgamma/dbeta 1e-3 of |v| + 1; dx bit-equal to "
                "bn_bwd_dx's with the same sums): " + lines[-1])
        if (n, c) == bn_shapes[0] and dt == torch.bfloat16:
            path_err["bn_fwd"] = ey.max().item()
            path_err["bn_bwd"] = edx.max().item()

    pool_cases = [((TRAIN_BATCH, 1, 1, 1024), torch.bfloat16, 7, 7, True),
                  ((TRAIN_BATCH, 1, 1, 1024), torch.float16, 7, 7, True),
                  ((5, 1, 1, 333), torch.float16, 7, 7, True),
                  ((3, 3, 4, 40), torch.float32, 4, 5, False)]
    for shape, dt, kh, kw, avg in pool_cases:
        dy = rnd(shape, dt)
        got = fused_pool_bwd_lin(dy, kh, kw, avg)
        want = pool_bwd_lin_plain(dy, kh, kw, avg)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lines.append(f"pool_bwd {kh}x{kw} dy {shape} {str(dt)[6:]} "
                     f"avg={int(avg)}: max_abs_err {err:.3g} (tol 0)")
        if err != 0.0:
            raise AssertionError("pool backward kernel disagrees: "
                                 + lines[-1])
        if shape[0] == TRAIN_BATCH and dt == torch.bfloat16:
            path_err["pool_bwd"] = err

    epi_cases = [((TRAIN_BATCH, 1000), torch.bfloat16, True, "none"),
                 ((55 * 55 * 8, 96), torch.bfloat16, True, "relu"),
                 ((37, 333), torch.float16, True, "relu"),
                 ((9, 7), torch.float32, False, "relu"),
                 ((1000, 96), torch.float32, True, "relu")]
    for shape, dt, with_bias, act in epi_cases:
        y, dy = rnd(shape, dt), rnd(shape, dt)
        dx, db = fused_epilogue_bwd(y, dy, act, with_bias)
        dx0, db0 = epilogue_bwd_plain(y, dy, act, with_bias)
        torch.cuda.synchronize()
        err = (dx.float() - dx0.float()).abs().max().item()
        errb, ratio = 0.0, 0.0
        if db is not None:
            errb = ((db - db0).abs() / (db0.abs() + 1.0)).max().item()
            plan = epilogue_bwd_plan(shape[0], shape[1], dy.element_size(),
                                     True, sm_count(dev))
            ratio = _sum_bound_ratio(db, dx0.float(),
                                     colsum_vec_depth(plan, shape[1], 1))
        lines.append(f"epilogue_bwd {shape} {str(dt)[6:]} "
                     f"bias={int(with_bias)} act={act}: dx {err:.3g} "
                     f"(tol 0), dbias {errb:.3g} (tol 1e-5 of |v| + 1), "
                     f"{ratio:.3g} of its order-of-summation bound")
        if err != 0.0 or errb > 1e-5 or ratio > 1.0 or (
                act == "none" and dx is not dy):
            raise AssertionError("epilogue backward kernel disagrees: "
                                 + lines[-1])
        if shape[0] == TRAIN_BATCH:
            path_err["epilogue_bwd"] = max(err, errb)

    worst = 0.0
    for tag, shapes in sorted(groups.items()):
        ws = [rnd(sh, torch.float32) for sh in shapes]
        gs = [rnd(sh, torch.float32) for sh in shapes]
        gs[0].view(-1)[::7] = float("nan")
        ms = [rnd(sh, torch.float32, 0.1) for sh in shapes]
        want_w, want_m = sgd_apply_plain(ws, gs, ms, 0.1, 0.9, 1e-4, 0.0,
                                         tag == "bias")
        fused_sgd_apply(ws, gs, ms, 0.1, 0.9, wd=1e-4, clip=0.0,
                        nag=tag == "bias")
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item()
                  for a, b in zip(ws + ms, want_w + want_m))
        rel = max(((a - b).abs() / (b.abs() + 1.0)).max().item()
                  for a, b in zip(ws + ms, want_w + want_m))
        worst = max(worst, err)
        lines.append(f"sgd_apply {tag} group ({len(shapes)} leaves, "
                     f"{sum(int(np.prod(sh)) for sh in shapes)} params, "
                     f"{'nag' if tag == 'bias' else 'sgd'}): max_abs_err "
                     f"{err:.3g} (tol 2.4e-7 of |v| + 1: two f32 ulp)")
        if rel > 2.4e-7:
            raise AssertionError("sgd apply kernel disagrees: " + lines[-1])
        # the loss scaler's skip flag, on the card: set, kernel and plain
        # keep every bit; clear, they compute the same as without it
        for flag in (1, 0):
            skip = torch.tensor(flag, dtype=torch.int32, device=dev)
            old = [t.clone() for t in ws + ms]
            want_w, want_m = sgd_apply_plain(ws, gs, ms, 0.1, 0.9, 1e-4, 0.0,
                                             tag == "bias", skip)
            fused_sgd_apply(ws, gs, ms, 0.1, 0.9, wd=1e-4, clip=0.0,
                            nag=tag == "bias", skip=skip)
            torch.cuda.synchronize()
            if flag:
                same = all(torch.equal(a, o) and torch.equal(b, o) for a, b, o
                           in zip(ws + ms, want_w + want_m, old))
                lines.append(f"sgd_apply {tag} group, skip flag set: every "
                             f"leaf and moment bit-unchanged {same}")
                if not same:
                    raise AssertionError("sgd apply skip: " + lines[-1])
                continue
            rel = max(((a - b).abs() / (b.abs() + 1.0)).max().item()
                      for a, b in zip(ws + ms, want_w + want_m))
            lines.append(f"sgd_apply {tag} group, skip flag clear: max rel "
                         f"err {rel:.3g} (tol 2.4e-7)")
            if rel > 2.4e-7:
                raise AssertionError("sgd apply skip: " + lines[-1])
    path_err["sgd_apply"] = worst

    # batch_norm_no_ma at eval: the BN forward kernel on the card
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS
    cfg = parse_config_string(NO_MA_NET)
    net = Network(build_graph(cfg), cfg, device=dev)
    net.load_weights(*net.init(torch.Generator().manual_seed(0)))
    x = rnd((5, 7, 7, 8), torch.float32)
    before = KERNELS["bn_fwd"].launches
    got = net(x).out
    launched = KERNELS["bn_fwd"].launches - before
    want = net(x, fused=False).out
    err = (got - want).abs().max().item()
    lines.append(f"batch_norm_no_ma eval (5,7,7,8) bf16: {launched} bn_fwd "
                 f"launch(es), softmax max_abs_err {err:.3g} (tol 1e-2)")
    if (dev.type == "cuda" and launched != 1) or err > 1e-2:
        raise AssertionError("batch_norm_no_ma eval: " + lines[-1])
    print(f"kernels (train): {len(lines)} cases agree with the plain "
          "versions | " + " | ".join(lines), flush=True)
    return path_err


#: the data-parallel BN kernels (queue B rows 8-11)
DP_KERNELS = ("bn_sums", "bn_norm", "bn_bwd_sums", "bn_bwd_dx")
#: per-rank batch of phase 11 (two ranks share the flagship's 128)
DP_RANKS = 2
DP_BATCH = TRAIN_BATCH // DP_RANKS


def _sum_bound_ratio(got, terms, depth):
    """Worst ratio, over the channels of one (C,) row of column sums, of
    its distance from the exact (float64) sum of its float32 ``terms``
    to the order-of-summation bound depth * 2^-24 * sum|t|, ``depth``
    the longest addition chain of the kernel's order."""
    t = terms.double()
    bound = depth * 2.0 ** -24 * t.abs().sum(0)
    err = (got.double() - t.sum(0)).abs()
    return float((err / bound.clamp_min(1e-300)).max())


def phase_sync_bn_kernels(gen: torch.Generator, conf: str) -> dict:
    """The four data-parallel BN kernels against their plain versions at
    every BN shape of the Inception-BN path at a per-rank batch of
    DP_BATCH, a flat (DP_BATCH, 1024) node, C 1, 7 and 1500, a ragged
    row count and the ragged rows 1 element past a 16-byte boundary (the
    one-element loads), in bf16, f16 and f32, relu on the path's shapes:
    the sums (rows 8, 10) within the order-of-summation bound of their
    exact value (each kernel's own addition depth), ``bn_sums``' bit-equal
    to ``bn_fwd``'s one-pass sums of the same rows, ``bn_norm``'s output
    (row 9) bit-equal to the plain version's, ``bn_bwd_dx``'s (row 11)
    within 4 f32 ulp of max|plain| in f32 and one ulp (plus that) in
    bf16/f16. Returns the largest error against the plain version per
    kernel at bn_stem1."""
    from cxxnet_tpu_torch.ops.fused import sm_count
    from cxxnet_tpu_torch.ops.fused_norm import (
        bn_bwd_dx, bn_bwd_dx_plain, bn_bwd_sums, bn_bwd_sums_plain,
        bn_fwd_sums, bn_norm, bn_norm_plain, bn_sums, bn_sums_plain,
        colsum_vec_depth, colsum_vec_plan)
    dev = gen.device
    bn_shapes, _ = flagship_shapes(conf, DP_BATCH)
    shapes = [(n, c, False) for n, c in dict.fromkeys(bn_shapes)]
    shapes += [(DP_BATCH, 1024, False), (4099, 1, False), (333, 7, False),
               (1000, 1500, False), (12345, 64, False), (12345, 64, True)]
    path_err = {k: 0.0 for k in DP_KERNELS}
    worst = {"sums": 0.0, "out": 0.0}
    cases = 0

    def rows(n, c, dt, scale, shift, offset):
        """(n, c) rows, ``offset`` elements past a 16-byte boundary"""
        t = torch.randn((n * c + offset,), generator=gen, device=dev)
        return (t * scale + shift).to(dt)[offset:].view(n, c)
    for n, c, off in shapes:
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            relu = (n, c) in bn_shapes or c == 7 or off
            act = "relu" if relu else "none"
            x = rows(n, c, dt, 1.5, 0.25, int(off))
            g = torch.randn((c,), generator=gen, device=dev) * 0.2 + 1.0
            b = torch.randn((c,), generator=gen, device=dev) * 0.1
            dy = rows(n, c, dt, 1.0, 0.0, int(off))
            xf = x.float()
            s, s0 = bn_sums(x), bn_sums_plain(x)
            fwd_same = torch.equal(s.view(torch.int32), bn_fwd_sums(
                x, g, b, 1e-5, act)[2].view(torch.int32))
            mean = s0[0] / n
            rstd = torch.rsqrt(torch.clamp(s0[1] / n - mean * mean, min=0.0)
                               + 1e-5)
            y, y0 = (bn_norm(x, g, b, mean, rstd, act),
                     bn_norm_plain(x, g, b, mean, rstd, act))
            yy = y0 if relu else None
            if off:             # y too 2 or 4 bytes past a boundary
                yy = torch.cat([y0.new_zeros(1), y0.view(-1)])[1:].view(n, c)
            d = dy.float() if yy is None else torch.where(
                yy.float() > 0, dy.float(), torch.zeros_like(xf))
            bs, bs0 = (bn_bwd_sums(x, dy, yy, mean, rstd),
                       bn_bwd_sums_plain(x, dy, yy, mean, rstd))
            sbn, sxhn = bs0[0] / n, bs0[1] / n
            dx, dx0 = (bn_bwd_dx(x, dy, yy, g, mean, rstd, sbn, sxhn),
                       bn_bwd_dx_plain(x, dy, yy, g, mean, rstd, sbn, sxhn))
            torch.cuda.synchronize()
            plan = colsum_vec_plan(n, c, x.element_size(), not off,
                                   sm_count(dev))
            if off != (x.data_ptr() % 16 != 0):
                raise AssertionError(f"({n},{c}) {dt}: the offset case must "
                                     "be the one not 16-byte aligned")
            depth = colsum_vec_depth(plan, c)
            ratio = max(_sum_bound_ratio(s[0], xf, depth),
                        _sum_bound_ratio(s[1], xf * xf, depth),
                        _sum_bound_ratio(bs[0], d, depth),
                        _sum_bound_ratio(bs[1], d * ((xf - mean) * rstd),
                                         depth))
            outs = [0.0 if torch.equal(y, y0) else float("inf")]
            for got, want in ((dx, dx0),):
                err = (got.float() - want.float()).abs()
                tol = 4 * 2.0 ** -23 * want.float().abs().max().item()
                if dt != torch.float32:
                    tol = _ulp_tol(dt) * want.float().abs() + tol
                outs.append(float((err / tol).max()) if torch.is_tensor(tol)
                            else err.max().item() / max(tol, 1e-300))
            worst["sums"] = max(worst["sums"], ratio)
            worst["out"] = max(worst["out"], *outs)
            cases += 1
            if ratio > 1.0 or max(outs) > 1.0 or not fwd_same:
                raise AssertionError(
                    f"sync-BN kernels disagree at ({n},{c}) {dt} act={act}"
                    f"{' offset' if off else ''}: "
                    f"sums at {ratio:.3g} of their bound, bn_sums "
                    f"{'equal' if fwd_same else 'not equal'} to bn_fwd's, y "
                    f"{'equal' if outs[0] == 0 else 'not equal'} to the "
                    f"plain version's, dx at {outs[1]:.3g} of its "
                    f"tolerance")
            if (n, c) == bn_shapes[0] and dt == torch.bfloat16 and not off:
                for k, got, want in (("bn_sums", s, s0), ("bn_norm", y, y0),
                                     ("bn_bwd_sums", bs, bs0),
                                     ("bn_bwd_dx", dx, dx0)):
                    path_err[k] = (got.float() - want.float()).abs().max() \
                        .item()
    print(f"kernels (sync BN): {cases} cases ({len(shapes)} shapes: the "
          f"{len(set(bn_shapes))} distinct BN shapes of Inception-BN at "
          f"{DP_BATCH} a rank, a flat node, C 1/7/1500, ragged rows, "
          f"inputs 1 element past a 16-byte boundary; bf16, f16, f32) agree "
          f"with the plain versions | sums: worst {worst['sums']:.3g} of the "
          f"order-of-summation bound (distance to the exact f64 sum of the "
          f"f32 terms over depth * 2^-24 * sum|term|, depth = the longest "
          f"addition chain of colsum_vec.cuh's plan) | bn_sums bit-equal to "
          f"bn_fwd's one-pass sums in every case | y bit-equal to the plain "
          f"version's "
          f"in every case | dx: worst {worst['out']:.3g} of the tolerance "
          f"(4 f32 ulp of max|plain|; bf16/f16 one ulp more) | at "
          f"bn_stem1 bf16 vs plain: "
          + ", ".join(f"{k} {v:.3g}" for k, v in path_err.items()),
          flush=True)
    return path_err


#: flash attention cases of phase 3: (B, H) per head width, the LM path's
#: (8, 8) at D = 16 and fewer heads where D is wider
FLASH_BH = {16: (8, 8), 64: (2, 4), 128: (2, 2)}
#: sequence lengths of phase 3's flash cases: the path's, and a ragged one
FLASH_S = (2048, 1000)
#: and a non-causal case with other query and key counts: (B, Sq, Sk, H, D)
FLASH_SQ_SK = (2, 300, 1000, 4, 64)


def _flash_bad(got, want, dtype):
    """(max abs error, whether it exceeds the bound): float32 2e-5 of
    max|plain| (f32 sums over up to 2048 keys in another order);
    bfloat16 and float16 one ulp of the value (2^-7, 2^-10 relative)
    plus 2e-5 of max|plain| (the same f32 sums, then one rounding each
    side)."""
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    rel = 0.0 if dtype == torch.float32 else _ulp_tol(dtype)
    return err.max().item(), bool(
        (err > rel * want.float().abs() + 2e-5 * top).any())


def flash_case(gen, B, S, H, D, dtype, causal, Sk=None):
    """The three flash kernels against their plain versions on one
    seeded case (``Sk`` keys, default S); the backward kernels get the
    plain forward's output and lse, as their plain versions do. Returns
    {kernel: max abs error}."""
    from cxxnet_tpu_torch.ops import attention as att
    dev = gen.device
    Sk = S if Sk is None else Sk
    q, g = (torch.randn((B, S, H, D), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    scale = D ** -0.5
    out, lse = att.flash_fwd(q, k, v, causal, scale)
    out0, lse0 = att.flash_fwd_plain(q, k, v, causal, scale)
    delta = att.flash_delta(out0, g)
    args = (q, k, v, g, lse0, delta, causal, scale)
    dq, dq0 = att.flash_bwd_dq(*args), att.flash_bwd_dq_plain(*args)
    (dk, dv), (dk0, dv0) = att.flash_bwd_dkv(*args), \
        att.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    errs, bad = {}, []
    for name, pairs in (("flash_fwd", [(out, out0)]),
                        ("flash_bwd_dq", [(dq, dq0)]),
                        ("flash_bwd_dkv", [(dk, dk0), (dv, dv0)])):
        e = 0.0
        for got, want in pairs:
            m, b = _flash_bad(got, want, dtype)
            e = max(e, m)
            if b:
                bad.append(name)
        errs[name] = e
    lse_err = (lse - lse0).abs().max().item()
    if lse_err > 1e-5 * lse0.abs().max().item():
        bad.append("flash_fwd lse")
    errs["lse"] = lse_err
    return errs, bad


#: phase 3's Adam edge leaves: odd sizes, a partial last vector, single
#: elements; with ADAM_EDGE_OFFSETS (elements past a 16-byte boundary of
#: w, g, m1 and m2, a leaf each) streams 4, 8 or 12 bytes past together
#: (a head of single elements, then vectors) or apart (single elements)
ADAM_EDGES = [(1,), (3,), (4097,), (8193,), (1025,), (7,), (5000,)]
ADAM_EDGE_OFFSETS = [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3), (1, 1, 1, 1),
                     (2, 2, 2, 2), (3, 3, 3, 3), (0, 2, 1, 3)]


def adam_inputs(gen: torch.Generator, shapes, offsets=None):
    """w, g (a NaN every 7th element of the first leaf), m1 and m2 (>= 0)
    f32 leaves of ``shapes`` on the generator's device, each stream of
    leaf i starting ``offsets[i][k]`` elements past a 16-byte boundary."""
    out = []
    for k, scale in enumerate((1.0, 1.0, 0.1, 0.1)):
        ts = []
        for i, sh in enumerate(shapes):
            t = torch.randn(sh, generator=gen, device=gen.device) * scale
            off = 0 if offsets is None else offsets[i][k]
            if off:
                buf = torch.empty(t.numel() + off, device=gen.device)
                buf[off:] = t.view(-1)
                t = buf[off:].view(sh)
            ts.append(t.abs() if k == 3 else t)
        out.append(ts)
    out[1][0].view(-1)[::7] = float("nan")
    return out


def phase_lm_kernels(gen: torch.Generator, conf: str) -> dict:
    """The LM path's kernels against their plain versions: flash
    attention forward, dQ and dK/dV in bf16, f16 and f32, causal and
    not, at S 2048 (the path's) and 1000 (a ragged edge the TPU kernel
    refused), head widths 16 (the path's), 64 and 128, and non-causal
    with 300 queries over 1000 keys; the Adam apply over the LM's
    parameter groups and over Inception-BN's, exact. Returns the largest
    error per kernel at the path's shape."""
    from cxxnet_tpu_torch.ops.fused_optim import (adam_apply_plain,
                                                  fused_adam_apply)
    dev = gen.device
    path_err, lines = {}, []
    cases = [(FLASH_BH[D][0], S, S, FLASH_BH[D][1], D, causal)
             for causal in (True, False) for S in FLASH_S
             for D in sorted(FLASH_BH)]
    b_, sq_, sk_, h_, d_ = FLASH_SQ_SK
    cases.append((b_, sq_, sk_, h_, d_, False))
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for B, S, Sk, H, D, causal in cases:
            errs, bad = flash_case(gen, B, S, H, D, dt, causal, Sk)
            lines.append(
                f"flash ({B},{S}{'' if Sk == S else f'x{Sk}'},{H},{D}) "
                f"{str(dt)[6:]} causal={int(causal)}: fwd "
                f"{errs['flash_fwd']:.3g} lse {errs['lse']:.3g} dq "
                f"{errs['flash_bwd_dq']:.3g} dkv {errs['flash_bwd_dkv']:.3g}")
            if bad:
                raise AssertionError(
                    f"flash kernels disagree ({bad}; tol f32 2e-5 of "
                    "max|plain|, bf16/f16 one ulp + 2e-5 of max|plain|, lse "
                    "1e-5 of max|lse|): " + lines[-1])
            if (B, S, H, D, dt, causal) == LM_PATH_ATTN and Sk == S:
                path_err.update({k: v for k, v in errs.items()
                                 if k != "lse"})
    # the paths' tag groups, then ADAM_EDGES in both groups' settings
    cases = [(what, tag, shapes, None)
             for what, groups in (("LM", lm_shapes(conf)[1]),
                                  ("Inception-BN",
                                   flagship_shapes(FLAGSHIP)[1]))
             for tag, shapes in sorted(groups.items())]
    cases += [(what, tag, ADAM_EDGES, offsets) for tag in ("wmat", "bias")
              for what, offsets in (("edge sizes", None),
                                    ("offsets", ADAM_EDGE_OFFSETS))]
    for what, tag, shapes, offsets in cases:
        ws, gs, m1, m2 = adam_inputs(gen, shapes, offsets)
        wd, clip = (1e-4, 0.0) if tag == "wmat" else (0.0, 0.5)
        want = adam_apply_plain(ws, gs, m1, m2, 1e-3, 0.1, 0.001, wd, clip)
        fused_adam_apply(ws, gs, m1, m2, 1e-3, d1=0.1, d2=0.001, wd=wd,
                         clip=clip)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in
                  zip(ws + m1 + m2, sum(want, [])))
        lines.append(f"adam_apply {what} {tag} group ({len(shapes)} "
                     f"leaves, {sum(int(np.prod(sh)) for sh in shapes)} "
                     f"params, wd {wd}, clip {clip}): max_abs_err "
                     f"{err:.3g} (tol 0: the same rounded f32 ops)")
        if err != 0.0:
            raise AssertionError("adam apply kernel disagrees: " + lines[-1])
        if what == "LM":
            path_err["adam_apply"] = max(path_err.get("adam_apply", 0.0),
                                         err)
    print(f"kernels (LM): {len(lines)} cases agree with the plain versions"
          " | " + " | ".join(lines), flush=True)
    return path_err


# -- phase 4 ------------------------------------------------------------------

def random_round(net, seed: int):
    """JAX-layout (params, state) numpy trees for ``net``'s graph, drawn
    by numpy from ``seed``: conv/fullc weights scaled by fan-in, BN
    slopes near 1, small biases, zero running statistics."""
    from cxxnet_tpu_torch.convert import params_to_jax
    shapes_p, shapes_s = params_to_jax(*net.init(torch.Generator()))
    rs = np.random.RandomState(seed)
    params = {}
    for layer, leaves in shapes_p.items():
        out = {}
        for leaf, a in leaves.items():
            if leaf == "wmat" and a.ndim == 4:        # HWIO
                std = np.sqrt(2.0 / (a.shape[0] * a.shape[1] * a.shape[2]))
                v = rs.standard_normal(a.shape) * std
            elif leaf == "wmat" and a.ndim == 2:      # (in, out)
                v = rs.standard_normal(a.shape) * np.sqrt(1.0 / a.shape[0])
            elif leaf == "wmat":                      # BN slope
                v = 1.0 + 0.1 * rs.standard_normal(a.shape)
            else:
                v = 0.1 * rs.standard_normal(a.shape)
            out[leaf] = v.astype(np.float32)
        params[layer] = out
    state = {l: {k: np.zeros_like(v) for k, v in d.items()}
             for l, d in shapes_s.items()}
    return params, state


def write_round(conf: str, seed: int, out_dir: str, device,
                round_counter: int = 1) -> str:
    """Random weights, BN statistics calibrated with the port's plain
    forward on one seeded batch, written as round ``round_counter``
    (``0001.model`` by default)."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import parse_config_file, split_sections
    from cxxnet_tpu_torch.convert import params_from_jax, params_to_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network, calibrate_bn
    cfg, _ = split_sections(parse_config_file(conf))
    graph = build_graph(cfg)
    net = Network(graph, cfg, device=device)
    params, state = random_round(net, seed)
    net.load_weights(*params_from_jax(params, state))
    c, y, x = graph.input_shape
    calib = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        16, y, x, c).astype(np.float32)).to(device)
    state = params_to_jax({}, calibrate_bn(net, calib))[1]
    path = ckpt.model_path(out_dir, round_counter)
    ckpt.save_model(path, structure_sig=graph.structure_signature(),
                    round_counter=round_counter, epoch_counter=0,
                    params=params, net_state=state)
    return path


def _post(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def start_serve(cfg):
    """``main.run(cfg)`` on a thread; returns (server, thread) once it
    listens."""
    from cxxnet_tpu_torch.main import run
    ready = threading.Event()
    box = {}

    def on_ready(srv):
        box["srv"] = srv
        ready.set()

    def target():
        try:
            run(cfg, ready=on_ready)
        except BaseException as e:          # reported by the main thread
            box["error"] = e
            ready.set()
    t = threading.Thread(target=target, name="serve-main", daemon=True)
    t.start()
    if not ready.wait(timeout=600):
        raise TimeoutError("server did not come up within 600 s")
    if "error" in box:
        raise RuntimeError("task=serve failed") from box["error"]
    return box["srv"], t


def stop_serve(srv, t) -> None:
    srv.stop()
    t.join(timeout=60)
    if t.is_alive():
        raise RuntimeError("task=serve did not return after stop()")


def phase_serve(conf: str, seed: int, model_path: str, extra=()):
    """Serve the round through ``main.run`` on a thread; returns
    (engine, launches, requests' rows and answers, statz)."""
    from cxxnet_tpu_torch.config import parse_cli_overrides, parse_config_file
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    cfg = parse_config_file(conf) + parse_cli_overrides(
        ["task=serve", f"model_in={model_path}", "serve_port=0",
         f"serve_buckets={','.join(map(str, BUCKETS))}",
         f"serve_max_batch={BUCKETS[-1]}", "serve_max_latency_ms=2",
         *extra])
    c, y, x = [int(v) for v in dict(cfg)["input_shape"].split(",")]
    rs = np.random.RandomState(seed + 2)
    reset_launches()
    srv, t = start_serve(cfg)
    base = f"http://127.0.0.1:{srv.port}"
    answers = []
    try:
        for n, raw in ((1, 0), (3, 1), (8, 1), (8, 0), (1, 1)):
            rows = rs.randn(n, c * y * x).astype(np.float32)
            out = _post(base + "/predict", {"data": rows.tolist(), "raw": raw})
            answers.append((rows, raw, np.asarray(
                out["prob" if raw else "pred"], np.float32)))
        feats = _post(base + "/extract",
                      {"data": answers[0][0].tolist(), "node": "top"})
        health = _get(base + "/healthz")
        statz = _get(base + "/statz")
    finally:
        stop_serve(srv, t)
    launches = {k.name: k.launches for k in KERNELS.values()}
    if health.get("status") != "ok":
        raise AssertionError(f"/healthz: {health}")
    if statz["requests"]["ok"] != len(answers) + 1:
        raise AssertionError(f"/statz requests: {statz['requests']}")
    if np.asarray(feats["features"]).shape != (1, 1000):
        raise AssertionError("extract top: wrong shape")
    return srv.engine, launches, answers, statz


def check_answers(engine_plain, answers, atol: float = 2e-2) -> float:
    """Softmax rows finite and summing to 1 (1e-3); classes in range;
    the answers held against the plain engine (``atol`` on
    probabilities, top-1 equal where the margin exceeds 0.05)."""
    worst = 0.0
    for rows, raw, got in answers:
        want = engine_plain.predict_raw(rows)
        if raw:
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"bad softmax rows {got.shape}")
            if np.abs(got.sum(1) - 1.0).max() > 1e-3:
                raise AssertionError("softmax rows do not sum to 1")
            worst = max(worst, float(np.abs(got - want).max()))
            if worst > atol:
                raise AssertionError(f"kernels vs plain: {worst} > {atol}")
            pred = got.argmax(1)
        else:
            pred = got.astype(np.int64)
            if ((pred < 0) | (pred >= want.shape[1])).any():
                raise AssertionError(f"class ids out of range: {pred}")
        srt = np.sort(want, 1)
        sure = srt[:, -1] - srt[:, -2] > 0.05
        if (pred[sure] != want.argmax(1)[sure]).any():
            raise AssertionError("top-1 differs from the plain engine")
    return worst


# -- phase 5 ------------------------------------------------------------------

def pool_fwd_row(xp) -> dict:
    """``pool_fwd``'s 7x7 global average over ``xp`` (B, 7, 7, C) bf16
    beside its bound, its plain version and ``x.mean``."""
    from cxxnet_tpu_torch.ops.fused_pool import fused_pool, pool_fwd_plain
    b, _, _, c = xp.shape
    return dict(
        ms=time_call(lambda: fused_pool(xp, 7, 7, "sum", True, False)),
        plain_ms=time_call(lambda: pool_fwd_plain(xp, 7, 7, "sum", True,
                                                  False)),
        library_ms=time_call(lambda: xp.mean(dim=(1, 2))),
        bound=bound_ms(xp.numel() * 2 + b * c * 2, xp.numel() + b * c),
        shape=f"avg 7x7 global on {tuple(xp.shape)} bf16",
        library="x.mean(dim=(1, 2))")


def phase_times(engine, gen: torch.Generator) -> dict:
    from cxxnet_tpu_torch.ops.fused_epilogue import bias_act_plain, fused_bias_act
    net = engine.net
    c, y, x = net.graph.input_shape
    fwd = {}
    for b in BUCKETS:
        data = torch.randn((b, y, x, c), generator=gen, device=net.device)
        ms = time_forward(lambda: net(data))
        ms_plain = time_forward(lambda: net(data, fused=False))
        fwd[b] = (ms, ms_plain)
    print("times: engine forward " + " | ".join(
        f"bucket {b}: {ms:.3f} ms ({b / ms * 1e3:.1f} img/s), "
        f"fused_kernels=0 {mp:.3f} ms" for b, (ms, mp) in fwd.items())
        + f" | peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
        flush=True)
    for b in (BUCKETS[0], BUCKETS[-1]):
        data = torch.randn((b, y, x, c), generator=gen, device=net.device)
        print(f"profile: bucket {b}: {profile_calls(lambda: net(data))}",
              flush=True)
    b = BUCKETS[-1]
    dev = net.device
    xp = torch.randn((b, 7, 7, 1024), generator=gen, device=dev).to(torch.bfloat16)
    xe = torch.randn((b, 1000), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((1000,), generator=gen, device=dev)
    bias16 = bias.to(torch.bfloat16)
    rows = {
        "pool_fwd": pool_fwd_row(xp),
        "epilogue_fwd": dict(
            ms=time_call(lambda: fused_bias_act(xe, bias, "none")),
            plain_ms=time_call(lambda: bias_act_plain(xe, bias, "none")),
            library_ms=time_call(lambda: torch.add(xe, bias16)),
            bound=bound_ms(xe.numel() * 2 * 2 + 1000 * 4, xe.numel()),
            shape=f"bias on {tuple(xe.shape)} bf16, f32 bias",
            library="torch.add(x, bias_bf16)"),
    }
    print("times: " + " | ".join(
        f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us, bound "
        f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), plain "
        f"{r['plain_ms'] * 1e3:.2f} us, {r['library']} "
        f"{r['library_ms'] * 1e3:.2f} us" for k, r in rows.items()), flush=True)
    return {"forward": fwd, "kernels": rows}


# -- phase 6 ------------------------------------------------------------------

def train_cfg(conf: str, seed: int, model_dir: str, extra=(),
              batch: int = TRAIN_BATCH, steps: int = TRAIN_STEPS,
              image: str = TRAIN_IMAGE, classes: int = TRAIN_CLASSES):
    """``conf``'s netconfig and globals (the flagship's by default) with
    its data/eval sections replaced by ``iter = synthetic`` (``image``,
    ``classes`` clusters, 1000 by default, from ``seed``): ``steps``
    batches of ``batch`` to train on, one to evaluate."""
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file, split_sections)
    glob, _ = split_sections(parse_config_file(conf))

    def synth(kind, name, n, s):
        return [(kind, name), ("iter", "synthetic"), ("num_inst", str(n)),
                ("num_class", str(classes)),
                ("input_shape", image), ("seed_data", str(s)),
                ("iter", "end")]
    return (glob + synth("data", "train", batch * steps, seed)
            + synth("eval", "val", batch, seed + 1)
            + parse_cli_overrides([
                "task=train", f"batch_size={batch}", "num_round=1",
                f"model_dir={model_dir}", "save_model=1", "print_step=1",
                *extra]))


def _snap(tr):
    """Host copies of a trainer's (params, momenta, BN state), JAX layout."""
    from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
    p, s = params_to_jax(tr.params, tr.net.state)
    return p, opt_to_jax(tr.opt_state), s


def _leafs(tree):
    return {(l, k): v for l, d in tree.items() for k, v in d.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _step_rels(got, want, before):
    """One step's update ``got - before`` against ``want - before``: the
    relative L2 difference per parameter and momentum leaf, as (rel,
    leaf) pairs, and the largest relative L2 difference of a BN running
    statistic after the step."""
    rels = []
    for g, w, b in ((got[0], want[0], before[0]),
                    (got[1]["mom"], want[1]["mom"], before[1]["mom"])):
        g, w, b = _leafs(g), _leafs(w), _leafs(b)
        rels += [(_rel(g[k] - b[k], w[k] - b[k]), k) for k in w]
    gs, ws = _leafs(got[2]), _leafs(want[2])
    return rels, max((_rel(gs[k], ws[k]) for k in ws), default=0.0)


def _grad_ratios(got, want, before, mom):
    """Per leaf, the ratio of the norms of one SGD step's gradient part
    (``-eta * (g + wd * w)``: the new momentum less ``mom`` times the
    old), ``got`` over ``want``, as (ratio, leaf) pairs."""
    g, w, b = (_leafs(t[1]["mom"]) for t in (got, want, before))
    return [(float(np.linalg.norm(g[k] - mom * b[k])
                   / max(np.linalg.norm(w[k] - mom * b[k]), 1e-30)), k)
            for k in w]


#: bound on the relative L2 difference of each layer's output, input
#: gradients and master gradients, kernels against plain, in the
#: layer-by-layer bf16 check (the CPU test's bound against the JAX
#: layers)
LAYER_TOL = 2e-2


def layer_parity(tr, batch, gen) -> dict:
    """Every layer of ``tr``'s net in its compute dtype and training
    mode, once through the kernels and once through their plain
    versions, from the same inputs (the node values of a training
    forward with the kernels, from ``tr``'s state) and the same seeded
    upstream gradient (the loss layer: its loss, upstream 1), the f32
    masters cast inside the graph as in a train step. No gradient chaos
    enters: each layer's bf16 backward is held on its own. Returns the
    worst relative L2 difference of the outputs, the input gradients and
    the masters' gradients, each as (value, layer)."""
    from cxxnet_tpu_torch.layers import ApplyCtx
    net = tr.net
    dev, cdt, g = net.device, net.compute_dtype, net.graph
    x = torch.from_numpy(batch.data).to(dev)
    label = torch.from_numpy(batch.label).to(dev)
    mask = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
    with torch.no_grad():
        _, _, nodes = net.apply(tr.params, net.state, x, train=True,
                                capture_nodes=True)
    worst = {"out": (0.0, ""), "dx": (0.0, ""), "dmaster": (0.0, "")}
    done = set()
    for li, (spec, layer) in enumerate(zip(g.layers, net.layers)):
        if li in net._act_folded or layer.name in done:
            continue
        done.add(layer.name)
        ins = [nodes[g.node_names[ni]] for ni in spec.nindex_in]
        got, dys = [], None
        for fused in (True, False):
            lp = {k: v.detach().clone().requires_grad_(True)
                  for k, v in tr.params.get(layer.name, {}).items()}
            xs = [t.detach().clone().requires_grad_(True) for t in ins]
            ctx = ApplyCtx(compute_dtype=cdt, fused=fused, train=True,
                           fuse_act=net._fuse_act.get(li), state_sink={})
            outs = layer.forward(
                net._cast_tree({layer.name: lp}, cdt).get(layer.name, {}),
                net.state.get(layer.name, {}), xs, ctx)
            if layer.is_loss:
                a, b = g.label_slice(layer.target)
                outs = [layer.loss(outs, label[:, a:b].float(), mask)]
            if dys is None:
                dys = [torch.ones_like(o) if layer.is_loss else torch.randn(
                    o.shape, generator=gen, device=dev).to(o.dtype)
                    for o in outs]
            grads = torch.autograd.grad(outs, list(lp.values()) + xs, dys)
            if any(v.dtype != torch.float32 for v in grads[:len(lp)]):
                raise AssertionError(f"{layer.name}: a master's gradient "
                                     "is not float32")
            got.append(([o.detach().float() for o in outs],
                        [v.float() for v in grads[:len(lp)]],
                        [v.float() for v in grads[len(lp):]]))
        for what, a, b in zip(("out", "dmaster", "dx"), got[0], got[1]):
            for u, v in zip(a, b):
                r = float((u - v).norm() / v.norm().clamp_min(1e-30))
                if not r <= worst[what][0]:
                    worst[what] = (r, layer.name)
    return worst


def _load(tr, snap, epoch, step=None):
    """Load ``snap`` as the state before update ``epoch`` (its step
    counter too, ``step`` where it differs, so a drawing layer draws
    what that step drew)."""
    from cxxnet_tpu_torch.checkpoint import _sig_to_json
    p, o, s = snap
    tr.load_blob({"meta": {"structure_sig": _sig_to_json(
        tr.graph.structure_signature()), "round": 0, "epoch": epoch,
        "step_count": epoch if step is None else step}, "params": p,
        "state": s, "opt": o})


def steps_vs_plain(glob, before, after, losses, batches, skipped=()):
    """Each step of a kernel run (``before[i]`` -> ``after[i]``, loss
    ``losses[i]``, on ``batches[i]``) held against the same step with
    fused_kernels = 0 from the same state, in the run's compute dtype
    and, as the yardstick of its rounding, in f32 (the module
    docstring's phase 6 bounds). A step in ``skipped`` (a float16 step
    whose apply the loss scaler skipped) must be skipped by the plain
    step too, with its masters and momenta bit-unchanged. Returns the
    readings and the plain trainer; raises past a bound."""
    from cxxnet_tpu_torch.trainer import Trainer
    plain = Trainer(glob + [("fused_kernels", "0")])
    plain32 = Trainer(glob + [("fused_kernels", "0"), ("silent", "1"),
                              ("compute_dtype", "float32")])
    worst = {"loss": 0.0, "state": 0.0, "kp": [], "pf": [], "ratio": [],
             "skipped": []}
    for i, b in enumerate(batches):
        if i in skipped:
            _load(plain, before[i], i)
            plain.update(b)
            got = _snap(plain)
            mp0, mp1 = before[i][1]["_mp"], got[1]["_mp"]
            same = all(np.array_equal(x, y) for x, y in zip(
                _flat_np(before[i][0]) + _flat_np(before[i][1]["mom"]),
                _flat_np(got[0]) + _flat_np(got[1]["mom"])))
            if not same or float(mp1["scale"]) != max(
                    float(mp0["scale"]) / 2, plain.optimizer.ls_min):
                raise AssertionError(f"step {i + 1}: the kernels' apply was "
                                     "skipped, the plain step's not")
            worst["skipped"].append(i + 1)
            continue
        got = []
        for t in (plain, plain32):
            _load(t, before[i], i)
            t.update(b)
            got.append((t.last_loss, _snap(t)))
        (lp, sp), (_, sf) = got
        moms = {m for _, m in plain.optimizer.schedules(i).values()}
        if len(moms) != 1:
            raise AssertionError(f"momentum differs between tags: {moms}")
        worst["loss"] = max(worst["loss"],
                            abs(lp - losses[i]) / max(1.0, abs(losses[i])))
        kp, st = _step_rels(after[i], sp, before[i])
        pf, _ = _step_rels(sp, sf, before[i])
        ratio = _grad_ratios(after[i], sp, before[i], moms.pop())
        worst["state"] = max(worst["state"], st)
        worst["kp"].append((float(np.median([r for r, _ in kp])), max(kp)))
        worst["pf"].append((float(np.median([r for r, _ in pf])), max(pf)))
        worst["ratio"].append((min(ratio), max(ratio)))
    del plain32
    # step 1's bf16 rounding yardstick (median 0.94) leaves no bound
    # under 1, so its update is held by the ratio check only
    applied = [i for i in range(len(batches)) if i not in skipped]
    bad = [i + 1 for i, mk, mf in zip(applied, worst["kp"], worst["pf"])
           if i > 0 and mk[0] > 1.5 * mf[0]]
    bad += [f"ratio at step {i + 1}" for i, (lo, hi) in
            enumerate(worst["ratio"]) if lo[0] < 0.5 or hi[0] > 2]
    if worst["loss"] > 2e-2 or worst["state"] > 2e-2 or bad:
        raise AssertionError(f"kernel vs fused_kernels=0 steps {bad}: "
                             f"{worst}")
    return worst, plain


def _flat_np(tree):
    """The leaves of a nested tree of arrays, depth first."""
    out = []
    for v in tree.values():
        out += _flat_np(v) if isinstance(v, dict) else [np.asarray(v)]
    return out


def _steps_line(worst, dt: str = "bf16") -> str:
    """The round-line text of :func:`steps_vs_plain`'s readings."""
    return (f"vs fused_kernels=0 from the same state, worst over steps: loss "
            f"{worst['loss']:.3g} of max(1,|loss|) (tol 2e-2), BN statistics "
            f"{worst['state']:.3g} (tol 2e-2); per step, update rel L2 "
            f"median over leaves / worst leaf, kernels vs plain {dt} "
            f"{[(round(m, 4), round(w[0], 4)) for m, w in worst['kp']]} "
            f"against plain {dt} vs plain f32 ({dt} rounding) "
            f"{[(round(m, 4), round(w[0], 4)) for m, w in worst['pf']]} "
            f"(tol: median at most 1.5x the rounding's at steps 2-"
            f"{len(worst['kp'])}); gradient-part norm ratio per leaf, "
            f"kernels / plain, min-max per step "
            f"{[(round(lo[0], 3), round(hi[0], 3)) for lo, hi in worst['ratio']]}"
            f" (tol [0.5, 2])")


def train_launches(what: str, launches: dict, steps: int) -> None:
    """Raise unless Inception-BN's training launched, over ``steps``
    steps, 69 ``bn_fwd`` and ``bn_bwd`` and 2 ``sgd_apply`` a step and
    each other training kernel at least once a step (phase 6's
    counts)."""
    check_launches(what, launches,
                   {"bn_fwd": 69 * steps, "bn_bwd": 69 * steps,
                    "sgd_apply": 2 * steps},
                   {k: steps for k in TRAIN_KERNELS
                    if k not in ("bn_fwd", "bn_bwd", "sgd_apply")})


def phase_train(conf: str, seed: int, tmp: str):
    """Train through main.run, check the launches, hold each step
    against the plain one from the same state and the written round's
    answers; returns (trainer, plain trainer, batches, launches, notes)."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    model_dir = os.path.join(tmp, "train")
    cfg = train_cfg(conf, seed, model_dir)
    box = {"losses": [], "before": []}

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        if len(box["losses"]) < TRAIN_STEPS:
            box["before"].append(_snap(tr))

    def ready(tr):
        box["before"].append(_snap(tr))
        tr.step_hook = on_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS.values()}
    took = time.perf_counter() - box["t0"]
    peak = torch.cuda.max_memory_allocated()
    tr.step_hook = None
    n_bn = sum(s.type.startswith("batch_norm") for s in tr.graph.layers)
    steps = len(box["losses"])
    if steps != TRAIN_STEPS or n_bn != 69:
        raise AssertionError(f"{steps} steps, {n_bn} batch_norm layers")
    train_launches("train", launches, steps)
    losses = box["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    after = box["before"][1:] + [_snap(tr)]

    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    batches = list(create_iterator(glob + data))
    worst, plain = steps_vs_plain(glob, box["before"], after, losses,
                                  batches)
    layers = layer_parity(tr, batches[0], torch.Generator(
        device=tr.device).manual_seed(seed))
    if any(not v <= LAYER_TOL for v, _ in layers.values()):
        raise AssertionError(f"layer by layer, kernels vs plain: {layers}")

    # the written round loads in the port and answers finitely
    path = ckpt.model_path(model_dir, 0)
    blob = ckpt.load_for_inference(path)
    glob_net = [kv for kv in glob if kv[0] != "task"]
    net = Network(tr.graph, glob_net)
    ckpt.check_structure(blob["meta"], tr.graph.structure_signature())
    net.load_weights(*params_from_jax(blob["params"], blob["state"]))
    x = torch.from_numpy(batches[0].data[:8]).to(net.device)
    prob = net(x).out.float().reshape(8, -1)
    if not bool(torch.isfinite(prob).all()) or \
            (prob.sum(1) - 1).abs().max().item() > 1e-3:
        raise AssertionError("the written round's answers are not finite "
                             "softmax rows")
    n_params = sum(v.numel() for d in tr.params.values() for v in d.values())
    print(f"train: {steps} steps of full-width Inception-BN (batch "
          f"{TRAIN_BATCH}, bf16, SGD momentum) through main.run in "
          f"{took:.1f}s with the evaluation and the round written | losses "
          f"{[round(v, 4) for v in losses]} | launches {launches} (per "
          f"step: bn_fwd {launches['bn_fwd'] // steps}, bn_bwd "
          f"{launches['bn_bwd'] // steps}, sgd_apply "
          f"{launches['sgd_apply'] // steps}) | {_steps_line(worst)}"
          f" | layer by layer in bf16, kernels vs plain "
          f"from the same inputs and upstream gradient, worst rel L2: "
          f"{', '.join(f'{k} {v:.3g} at {n}' for k, (v, n) in layers.items())}"
          f" (tol {LAYER_TOL}) | round {os.path.basename(path)}"
          f" loads, finite softmax rows | {n_params} parameters | peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    return tr, plain, batches, launches, {
        "losses": losses, "worst": worst, "layers": layers,
        "params": n_params,
        "peak_gib": peak / 2**30, "seconds": took,
        "init": (box["before"][0][0], box["before"][0][2])}


def phase_train_f32(batches, weights, glob) -> dict:
    """Two float32 steps with the kernels, each held against the same
    step with fused_kernels = 0 from the same state: loss rtol 1e-4,
    update rel L2 median over leaves 5e-2 and worst leaf 0.15, BN
    statistics 1e-3 (f32 sums in another order, amplified by the 69 BN
    layers' gradient at init as on the CPU narrow net)."""
    from cxxnet_tpu_torch.trainer import Trainer
    f32 = [("compute_dtype", "float32"), ("silent", "1")]
    k32 = Trainer(glob + f32)
    p32 = Trainer(glob + f32 + [("fused_kernels", "0")])
    k32.init_model(weights)
    out = []
    for i, b in enumerate(batches[:2]):
        before = _snap(k32)
        k32.update(b)
        _load(p32, before, i)
        p32.update(b)
        rels, st = _step_rels(_snap(k32), _snap(p32), before)
        out.append((abs(k32.last_loss / p32.last_loss - 1),
                    float(np.median([r for r, _ in rels])), max(rels), st))
    del k32, p32
    torch.cuda.empty_cache()
    print("train f32: per step from the same state, kernels vs "
          "fused_kernels=0: " + " | ".join(
              f"step {i + 1}: loss rtol {dl:.3g}, update rel L2 median "
              f"{md:.3g}, worst {w[0]:.3g} at {w[1]}, BN statistics "
              f"{st:.3g}" for i, (dl, md, w, st) in enumerate(out))
          + " (tol 1e-4, 5e-2, 0.15, 1e-3)", flush=True)
    if any(dl > 1e-4 or md > 5e-2 or w[0] > 0.15 or st > 1e-3
           for dl, md, w, st in out):
        raise AssertionError("float32 kernel and plain training disagree")
    return {"steps": [{"loss_rtol": dl, "update_median": md,
                       "update_worst": w[0], "state": st}
                      for dl, md, w, st in out]}


#: the batch-norm backward's traffic in streams of N * C elements when it
#: reads the rows twice: the sums pass reads x, dy and y; the dx pass reads
#: x, dy and y again and writes dx (7), or reads the mask bits that the
#: sums pass wrote, 1/16 of a bf16 stream each way, in place of y (6.125)
BN_BWD_STREAMS = {"y": 7.0, "bits": 6.125}


def bn_bwd_times(gen: torch.Generator) -> dict:
    """``bn_bwd`` at bn_stem1 at batch 128 (bf16, relu): CUDA-graph times
    of the wrapper, its plain version and
    ``aten.native_batch_norm_backward``, and both by launch (profiler);
    the table's bound (4 streams: the rows read once) beside the two-pass
    floors of BN_BWD_STREAMS. Prints one line; returns the kernel table's
    row."""
    from cxxnet_tpu_torch.ops.fused_norm import bn_bwd, bn_bwd_plain, bn_fwd
    dev = gen.device
    bf = torch.bfloat16
    n, c = TRAIN_BATCH * 112 * 112, 64                  # bn_stem1
    x = torch.randn((n, c), generator=gen, device=dev).to(bf) * 1.5
    g = torch.rand((c,), generator=gen, device=dev) + 0.5
    be = torch.randn((c,), generator=gen, device=dev) * 0.1
    y, mean, var, rstd = bn_fwd(x, g, be, 1e-10, "relu")
    dy = torch.randn((n, c), generator=gen, device=dev).to(bf)
    w16 = g.to(bf)
    _, smean, sinv = torch.ops.aten.native_batch_norm(
        x, w16, be.to(bf), None, None, True, 0.1, 1e-10)
    ours = lambda: bn_bwd(x, dy, y, g, mean, rstd)
    lib = lambda: torch.ops.aten.native_batch_norm_backward(
        dy, x, w16, None, None, smean, sinv, True, 1e-10, [True, True, True])
    row = dict(
        ms=time_call(ours),
        plain_ms=time_call(lambda: bn_bwd_plain(x, dy, y, g, mean, rstd)),
        library_ms=time_call(lib),
        bound=bound_ms(4 * n * c * 2, 12 * n * c),
        shape=f"bn_stem1 ({n},{c}) bf16 relu",
        library="aten.native_batch_norm_backward, no relu mask")
    floor = {k: v * n * c * 2 / HBM_BYTES_PER_S * 1e3
             for k, v in BN_BWD_STREAMS.items()}
    print(f"times (bn_bwd) at bn_stem1 ({n},{c}) bf16 relu: "
          f"{row['ms'] * 1e3:.2f} us | bound {row['bound'][0] * 1e3:.2f} us (4 streams: the rows "
          f"read once); two-pass floors {floor['y'] * 1e3:.2f} us (7 "
          f"streams, y read twice), {floor['bits'] * 1e3:.2f} us (6.125, "
          f"the mask bits) | {row['library']} "
          f"{row['library_ms'] * 1e3:.2f} us | by launch: "
          f"{launch_breakdown(ours)} | the library by launch: "
          f"{launch_breakdown(lib)}", flush=True)
    return row


#: AlexNet's cv1 and fc6 outputs as (N, C) rows: their epilogues' relu
#: and bias
EPI_CV1 = (256 * 55 * 55, 96)
EPI_FC6 = (256, 4096)


def epilogue_bwd_times(gen: torch.Generator) -> dict:
    """``epilogue_bwd`` at fc1 (Inception-BN, (TRAIN_BATCH, 1000) bf16, no
    relu, a bias: dx is dy) and at AlexNet's cv1 and fc6 (EPI_CV1 and
    EPI_FC6 bf16, relu, a bias): CUDA-graph times of the wrapper and of
    its plain version beside the bound and one PyTorch yardstick, fc1
    and cv1 also by launch (profiler). Prints one line; returns the rows
    "epilogue_bwd" (fc1), "epilogue_bwd (cv1)" and "epilogue_bwd
    (fc6)"."""
    from cxxnet_tpu_torch.ops.fused_epilogue import (epilogue_bwd_plain,
                                                     fused_epilogue_bwd)
    dev, bf, f32 = gen.device, torch.bfloat16, torch.float32
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    ye, dye = rnd((TRAIN_BATCH, 1000)).to(bf), rnd((TRAIN_BATCH, 1000)).to(bf)
    n, c = EPI_CV1
    y, dy = torch.relu(rnd((n, c))).to(bf), rnd((n, c)).to(bf)
    fc1 = lambda: fused_epilogue_bwd(ye, dye, "none", True)
    cv1 = lambda: fused_epilogue_bwd(y, dy, "relu", True)
    lib_fc1 = lambda: dye.sum(0, dtype=f32)
    lib_cv1 = lambda: torch.ops.aten.threshold_backward(dy, y, 0).sum(
        0, dtype=f32)
    n6, c6 = EPI_FC6
    y6, dy6 = torch.relu(rnd((n6, c6))).to(bf), rnd((n6, c6)).to(bf)
    rows = {
        "epilogue_bwd": dict(
            ms=time_call(fc1),
            plain_ms=time_call(lambda: epilogue_bwd_plain(ye, dye, "none",
                                                          True)),
            library_ms=time_call(lib_fc1),
            # dx is dy: dy read once, dbias written
            bound=bound_ms(dye.numel() * 2 + 1000 * 4, dye.numel()),
            shape=f"fc1 bias on {tuple(dye.shape)} bf16 (launch-bound)",
            library="dy.sum(0, dtype=float32) (dx is dy)"),
        "epilogue_bwd (cv1)": dict(
            ms=time_call(cv1),
            plain_ms=time_call(lambda: epilogue_bwd_plain(y, dy, "relu",
                                                          True)),
            library_ms=time_call(lib_cv1),
            # dy and y read, dx written: 6 bytes an element, and dbias
            bound=bound_ms(6 * n * c + 4 * c, 2 * n * c),
            shape=f"AlexNet cv1 relu + bias on ({n},{c}) bf16",
            library="aten.threshold_backward then .sum(0, dtype=float32), "
                    "two calls"),
        "epilogue_bwd (fc6)": dict(
            ms=time_call(lambda: fused_epilogue_bwd(y6, dy6, "relu", True)),
            plain_ms=time_call(lambda: epilogue_bwd_plain(y6, dy6, "relu",
                                                          True)),
            library_ms=time_call(lambda: torch.ops.aten.threshold_backward(
                dy6, y6, 0).sum(0, dtype=f32)),
            bound=bound_ms(6 * n6 * c6 + 4 * c6, 2 * n6 * c6),
            shape=f"AlexNet fc6 relu + bias on ({n6},{c6}) bf16",
            library="aten.threshold_backward then .sum(0, dtype=float32), "
                    "two calls"),
    }
    print("times (epilogue_bwd): " + " | ".join(
        f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us, bound "
        f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), plain "
        f"{r['plain_ms'] * 1e3:.2f} us, {r['library']} "
        f"{r['library_ms'] * 1e3:.2f} us" for k, r in rows.items())
        + f" | fc1 by launch: {launch_breakdown(fc1)} | its yardstick by "
        f"launch: {launch_breakdown(lib_fc1)} | cv1 by launch: "
        f"{launch_breakdown(cv1)} | its yardstick by launch: "
        f"{launch_breakdown(lib_cv1)} | cv1 without the bias (the masked "
        f"copy, the same bytes): "
        f"{time_call(lambda: fused_epilogue_bwd(y, dy, 'relu', False)) * 1e3:.2f}"
        f" us", flush=True)
    return rows


#: the epilogue forward's timed shapes as (N, C) rows and its act:
#: AlexNet's cv1 and cv2 at batch 256 (relu folded), the SPP net's cv1 at
#: batch 128 (insanity is not folded: the bias only) and Inception-BN's fc1
EPI_FWD = {"alexnet cv1": EPI_CV1 + ("relu",),
           "alexnet cv2": (256 * 27 * 27, 256, "relu"),
           "spp cv1": (128 * 109 * 109, 96, "none"),
           "fc1": (TRAIN_BATCH, 1000, "none")}


def epilogue_fwd_row(gen: torch.Generator, n: int, c: int, act: str) -> dict:
    """``epilogue_fwd`` over (n, c) bf16 rows with an f32 bias and
    ``act``: CUDA-graph times of the wrapper, its plain version and the
    library's ``torch.add`` of the bias in bf16 (then ``.relu_()``, two
    calls) beside the bound (x read, y written, the bias read)."""
    from cxxnet_tpu_torch.ops.fused_epilogue import (bias_act_plain,
                                                     fused_bias_act)
    dev = gen.device
    x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((c,), generator=gen, device=dev)
    b16 = bias.to(torch.bfloat16)
    relu = act == "relu"
    lib = (lambda: torch.add(x, b16).relu_()) if relu else \
        (lambda: torch.add(x, b16))
    return dict(
        ms=time_call(lambda: fused_bias_act(x, bias, act)),
        plain_ms=time_call(lambda: bias_act_plain(x, bias, act)),
        library_ms=time_call(lib),
        bound=bound_ms(2 * 2 * n * c + 4 * c, (1 + relu) * n * c),
        shape=f"bias{' + relu' if relu else ''} on ({n},{c}) bf16",
        library="torch.add(x, bias_bf16)" + (" then .relu_(), two calls"
                                             if relu else ""))


#: the profile kinds (``_KINDS``) of bn_fwd's launches in a train step
BN_FWD_KINDS = ("bn moments kernel", "bn fwd normalize kernel")
#: (rows, channels) of Inception-BN's bn_stem1 at batch TRAIN_BATCH, and
#: of a mid layer (14 x 14, C 256)
BN_STEM1 = (TRAIN_BATCH * 112 * 112, 64)
BN_MID = (TRAIN_BATCH * 14 * 14, 256)


def bn_fwd_cases(gen: torch.Generator) -> dict:
    """``bn_fwd``'s timed cases, bf16 with relu: bn_stem1 one-pass (the
    kernel table's row), bn_stem1 two-pass, and the mid layer one-pass.
    Per case (x, gamma, beta, two_pass)."""
    dev = gen.device
    out = {}
    for name, (n, c), two_pass in (("bn_fwd", BN_STEM1, False),
                                   ("bn_fwd (two-pass)", BN_STEM1, True),
                                   ("bn_fwd (mid)", BN_MID, False)):
        x = (torch.randn((n, c), generator=gen, device=dev) * 1.5
             ).to(torch.bfloat16)
        g = torch.rand((c,), generator=gen, device=dev) + 0.5
        be = torch.randn((c,), generator=gen, device=dev) * 0.1
        out[name] = (x, g, be, two_pass)
    return out


def lrn_ab_times(gen: torch.Generator) -> dict:
    """``lrn_fwd`` and ``lrn_bwd`` at AlexNet's lrn1 and lrn2 (bf16,
    LRN_ALEX), timed as :func:`phase_convnet_times` times them, and
    lrn1's rates. Where the tree plans its blocks by
    ``fused_lrn.LRN_THREADS``, also prints both at lrn1 for each of
    LRN_SWEEP threads a block (the rows a block follow) and at nsize 4
    and 6 (the run-time window), and their issue floor."""
    from cxxnet_tpu_torch.ops import fused_lrn
    n, alpha, beta, knorm = LRN_ALEX
    out = {}
    for layer, shape in LRN_LAYERS:
        x, dy = lrn_inputs(gen, shape)
        fwd = lambda: fused_lrn.fused_lrn_fwd(x, n, alpha, beta, knorm)
        bwd = lambda: fused_lrn.fused_lrn_bwd(x, dy, n, alpha, beta, knorm)
        out[f"lrn_fwd {layer}"] = time_call(fwd)
        out[f"lrn_bwd {layer}"] = time_call(bwd)
        if layer != "lrn1":
            continue
        # what sets the pace: the same rows' rate out of the L2, and a
        # copy of the forward's bytes
        xs, dys = x[:LRN_L2_IMAGES], dy[:LRN_L2_IMAGES]
        el, els = x.numel(), xs.numel()
        l2 = (time_call(lambda: fused_lrn.fused_lrn_fwd(xs, n, alpha, beta,
                                                        knorm)),
              time_call(lambda: fused_lrn.fused_lrn_bwd(xs, dys, n, alpha,
                                                        beta, knorm)))
        copy = time_call(lambda: x.clone())
        rate = lambda ms, m: f"{m / ms / 1e6:.1f} G elements/s"
        print(f"ab: lrn rates at lrn1 {shape} bf16: fwd "
              f"{rate(out['lrn_fwd lrn1'], el)} "
              f"({4 * el / out['lrn_fwd lrn1'] / 1e9:.2f} TB/s), bwd "
              f"{rate(out['lrn_bwd lrn1'], el)} "
              f"({6 * el / out['lrn_bwd lrn1'] / 1e9:.2f} TB/s) | the first "
              f"{LRN_L2_IMAGES} images ({4 * els / 1e6:.1f} MB in and out "
              f"forward, in the L2): fwd {l2[0]:.5f} ms = {rate(l2[0], els)},"
              f" bwd {l2[1]:.5f} ms = {rate(l2[1], els)} | x.clone() of "
              f"lrn1 {copy:.5f} ms ({4 * el / copy / 1e9:.2f} TB/s, the "
              f"forward's bytes)", flush=True)
        if not hasattr(fused_lrn, "LRN_THREADS"):
            continue
        print(lrn_issue_floor(out["lrn_fwd lrn1"], out["lrn_bwd lrn1"]),
              flush=True)
        keep, sweep = fused_lrn.LRN_THREADS, []
        try:
            for threads in LRN_SWEEP:
                fused_lrn.LRN_THREADS = threads
                plan = fused_lrn.lrn_plan(*fused_lrn._rows(x), 2, n)
                sweep.append(f"{threads} threads ({plan.rows} rows): fwd "
                             f"{time_call(fwd):.5f} bwd {time_call(bwd):.5f}")
        finally:
            fused_lrn.LRN_THREADS = keep
        for k in (4, 6):      # nsize 5's window is compiled in, these not
            f = time_call(lambda: fused_lrn.fused_lrn_fwd(x, k, alpha, beta,
                                                          knorm))
            b = time_call(lambda: fused_lrn.fused_lrn_bwd(x, dy, k, alpha,
                                                          beta, knorm))
            sweep.append(f"nsize {k} (run-time window): fwd {f:.5f} bwd "
                         f"{b:.5f}")
        print(f"ab: lrn sweep at lrn1 {shape} bf16, ms: " + " | ".join(sweep),
              flush=True)
    return out


def sass_counts(source: str, fragment: str) -> dict:
    """Static SASS instructions (NOPs left out) of each kernel of
    ``source``'s built library whose mangled name holds ``fragment``, by
    name, from ``cuobjdump -sass`` beside nvcc; {} without cuobjdump."""
    import re
    from cxxnet_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", _build.lib_path(source)],
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            name = m.group(1) if fragment in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln) \
                and "NOP" not in ln:
            counts[name] += 1
    return counts


def lrn_issue_floor(fwd_ms: float, bwd_ms: float) -> str:
    """The LRN kernels at lrn1 (bf16, 8 channels a thread, nsize 5)
    against their instruction issue: static SASS instructions a thread
    (an upper bound of what a thread runs: the rare branches count too),
    and the time 4 warp instructions a clock on each of the card's SMs
    would take for all of lrn1's warps at the SM clock nvidia-smi reads
    now and at its maximum."""
    from cxxnet_tpu_torch.ops import fused_lrn
    n, c = 256 * 27 * 27, 96
    plan = fused_lrn.lrn_plan(n, c, 2, 5)
    warps = -(-n // plan.rows) * -(-plan.rows * plan.tpr // 32)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split(",")
    mhz = [float(v) for v in smi]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parts = []
    for src, kern, ms in (("lrn_fwd.cu", "lrn_fwd_kernel", fwd_ms),
                          ("lrn_bwd.cu", "lrn_bwd_kernel", bwd_ms)):
        k = [v for name, v in sass_counts(src, kern).items()
             if "nv_bfloat16Li8ELi5E" in name]
        if not k:
            parts.append(f"{kern}: no SASS (not measured)")
            continue
        floor = [warps * k[0] / (sms * 4 * f * 1e3) for f in mhz]
        parts.append(f"{kern}<bf16,8,5> {k[0]} SASS instructions a thread "
                     f"({k[0] / plan.vec:.1f} an element): issue floor "
                     f"{floor[0]:.5f} ms at {mhz[0]:.0f} MHz, {floor[1]:.5f} "
                     f"at {mhz[1]:.0f}; measured {ms:.5f} "
                     f"({100 * floor[0] / ms:.0f}% of issue at {mhz[0]:.0f})")
    return f"ab: lrn issue at lrn1 ({warps} warps): " + " | ".join(parts)


#: spp1's input at batch 128 and its 3x3/3 window
SPP1 = ((128, 27, 27, 256), 3)
#: the digits LeNet's pool input at batch 100 and its 2x2/2 window
LENET_POOL = ((100, 8, 8, 32), 2)


def _tbs(nbytes: int, ms: float) -> str:
    return f"{nbytes / ms / 1e9:.2f} TB/s"


def _rate(row: dict) -> str:
    """A timed kernel row's rate: the bytes of its bound over its time."""
    if row["bound"][1] != "bytes":
        return "bound by operations"
    return _tbs(row["bound"][0] * 1e-3 * HBM_BYTES_PER_S, row["ms"])


def max_pool_inputs(gen: torch.Generator, shape=SPP1[0], k: int = SPP1[1],
                    relu: bool = False):
    """x (bf16, normal), y its k x k/k max (relu_max with ``relu``) and dy
    (bf16, normal), and the bytes the backward must move (x, y, dy read,
    dx written); spp1's by default."""
    from cxxnet_tpu_torch.ops.fused_pool import pool_fwd_plain
    x = torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)
    y = pool_fwd_plain(x, k, k, "max", False, relu)
    dy = torch.randn(y.shape, generator=gen, device=gen.device).to(
        torch.bfloat16)
    return x, y, dy, 2 * (2 * x.numel() + 2 * y.numel())


def pool_stem_ab_times(gen: torch.Generator) -> dict:
    """``pool_bwd_max`` at spp1 (bf16, pre_relu off, as phase 8 times it)
    and at the digits LeNet's 2x2 (bf16, pre_relu on), and ``stem`` at
    the imgrec path's shape to bf16 with each kind of mean, with their
    rates and a copy of spp1's x beside them."""
    from cxxnet_tpu_torch.ops import fused_pool as fp
    from cxxnet_tpu_torch.ops import fused_stem as fs
    out, notes = {}, []
    for what, (shape, k), relu in (("spp1", SPP1, False),
                                   ("lenet", LENET_POOL, True)):
        x, y, dy, nbytes = max_pool_inputs(gen, shape, k, relu)
        key = f"pool_bwd_max {what}"
        out[key] = time_call(
            lambda: fp.fused_pool_bwd_max(x, y, dy, k, k, relu))
        notes.append(f"{key} {_tbs(nbytes, out[key])}")
        if what == "spp1":
            copy = time_call(lambda: x.clone())
            notes.append(f"x.clone() of spp1 {copy:.5f} ms "
                         f"({_tbs(4 * x.numel(), copy)})")
        del x, y, dy
    for kind in ("none", "channel", "image"):
        # the imgrec path's batch; bytes: x and the mean read, y written
        xs, mean = _stem_inputs(gen, (TRAIN_BATCH, 224, 224, 3), kind)
        nb = 3 * xs.numel() + (0 if mean is None else 4 * mean.numel())
        out[f"stem {kind}"] = time_call(
            lambda: fs.fused_decode_normalize(xs, mean, 1 / 58.0,
                                              torch.bfloat16))
        notes.append(f"stem {kind} {_tbs(nb, out[f'stem {kind}'])}")
    print("ab: pool_bwd_max and stem rates: " + " | ".join(notes),
          flush=True)
    return out


def ab_times(gen: torch.Generator) -> None:
    """The times of the kernels this tree's vectorised designs touch, for
    an A/B of two trees (``--ab``): ``bn_fwd`` at :func:`bn_fwd_cases`,
    ``bn_bwd`` as :func:`bn_bwd_times` takes it, the four sync-BN
    kernels as :func:`phase_dp_times` does, ``epilogue_bwd`` at fc1,
    cv1 and fc6 as :func:`epilogue_bwd_times` does, the LRN kernels
    as :func:`lrn_ab_times` does, ``pool_bwd_max`` and ``stem`` as
    :func:`pool_stem_ab_times` does, ``epilogue_fwd`` at each EPI_FWD
    shape as :func:`epilogue_fwd_row` times it, and ``adam_apply`` over
    the LM's and Inception-BN's leaves as :func:`adam_row` does. Prints
    them as one JSON line."""
    from cxxnet_tpu_torch.ops.fused_norm import bn_fwd
    pool_stem = pool_stem_ab_times(gen)
    torch.cuda.empty_cache()
    lrn = lrn_ab_times(gen)
    torch.cuda.empty_cache()
    fwd = {}
    for k, (x, g, be, tp) in bn_fwd_cases(gen).items():
        call = lambda: bn_fwd(x, g, be, 1e-10, "relu", tp)
        fwd[k] = time_call(call)
        print(f"ab: {k} {tuple(x.shape)} by launch: "
              f"{launch_breakdown(call)}", flush=True)
    del x
    torch.cuda.empty_cache()
    r = bn_bwd_times(gen)
    dp = phase_dp_times(gen)["kernels"]
    epi = epilogue_bwd_times(gen)
    torch.cuda.empty_cache()
    epi_adam = {f"epilogue_fwd {k}": epilogue_fwd_row(gen, *v)
                for k, v in EPI_FWD.items()}
    epi_adam.update({f"adam_apply {what}": adam_row(
        [torch.randn(sh, generator=gen, device=gen.device)
         for sh in adam_shapes(conf)], what)
        for what, conf in (("LM", LM_CONF), ("Inception-BN", FLAGSHIP))})
    print("ab: epilogue_fwd and adam_apply: " + " | ".join(
        f"{k} {row['shape']}: {row['ms'] * 1e3:.3f} us ({_rate(row)}), "
        f"bound {row['bound'][0] * 1e3:.3f} us, plain "
        f"{row['plain_ms'] * 1e3:.3f} us, {row['library']} "
        f"{row['library_ms'] * 1e3:.3f} us"
        for k, row in epi_adam.items()), flush=True)
    print("ab: " + json.dumps({**fwd, "bn_bwd": r["ms"],
                               **{k: v["ms"] for k, v in dp.items()},
                               "epilogue_bwd fc1": epi["epilogue_bwd"]["ms"],
                               "epilogue_bwd cv1":
                                   epi["epilogue_bwd (cv1)"]["ms"],
                               "epilogue_bwd fc6":
                                   epi["epilogue_bwd (fc6)"]["ms"],
                               **lrn, **pool_stem,
                               **{k: v["ms"] for k, v in epi_adam.items()}}),
          flush=True)


def run_ab(trees, seed: int, fn: str = "ab_times") -> int:
    """:func:`ab_times` (or ``fn``, a function of this file taking the
    generator) of each checkout root in ``trees`` in turn, one process
    each, on the kernels built from that tree's sources (this file's
    timing code throughout). Returns the first non-zero exit."""
    print(phase_env(), flush=True)
    for tree in trees:
        tree = os.path.abspath(tree)
        code = (f"import sys, runpy, torch; sys.path.insert(0, {tree!r}); "
                f"m = runpy.run_path({os.path.abspath(__file__)!r}); "
                f"m[{fn!r}](torch.Generator(device='cuda')"
                f".manual_seed({seed}))")
        print(f"ab: tree {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", code], cwd=tree).returncode
        if rc != 0:
            return rc
    return 0


#: ``--step-ab``: (name, conf, batch, input shape, overrides) of each
#: timed train step
STEP_AB = (
    ("inception_bn bf16", FLAGSHIP, TRAIN_BATCH, TRAIN_IMAGE,
     ("compute_dtype=bfloat16",)),
    ("inception_bn f32", FLAGSHIP, TRAIN_BATCH, TRAIN_IMAGE,
     ("compute_dtype=float32",)),
    ("alexnet f32", os.path.join(ROOT, "examples", "ImageNet",
                                 "alexnet.conf"), 256, "3,227,227",
     ("compute_dtype=float32",)),
    ("bowl f32", os.path.join(ROOT, "examples", "kaggle_bowl", "bowl.conf"),
     64, "3,40,40", ("compute_dtype=float32",)))


def step_ab_times(gen: torch.Generator) -> None:
    """For ``--step-ab``: the wall ms of each STEP_AB train step
    (``Trainer.update`` on one staged synthetic batch, median of 10 after
    3 warm-ups), with ``cudnn.deterministic`` off and on (benchmark off,
    TF32 off), in this process's tree. Prints them as one JSON line."""
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.trainer import Trainer
    seed = int(gen.initial_seed())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, conf, batch, image, extra in STEP_AB:
            cfg = _train_only(train_cfg(conf, seed, tmp, extra, batch=batch,
                                        steps=1, image=image, classes=10))
            glob, sections = split_sections(cfg)
            data = [p for kind, _, p in sections if kind == "data"][0]
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                tr = Trainer(glob)
                tr.init_model()
                staged = tr.stage_batch(_first_batch(glob + data))
                out[f"{name} det={int(det)}"] = time_forward(
                    lambda: tr.update(staged), reps=10)
                del tr, staged
                torch.cuda.empty_cache()
    print("step-ab: " + json.dumps(out), flush=True)


#: ``--wgrad``: (x NCHW, w OIHW, stride, padding, groups) of float32 conv
#: weight gradients on the float32 training paths
WGRAD_SHAPES = {
    "alexnet conv1 11x11/4": ((256, 3, 227, 227), (96, 3, 11, 11), 4, 0, 1),
    "alexnet conv2 5x5 g2": ((256, 96, 27, 27), (256, 48, 5, 5), 1, 2, 2),
    "alexnet conv3 3x3": ((256, 256, 13, 13), (384, 256, 3, 3), 1, 1, 1),
    "inception_bn stem 7x7/2": ((128, 3, 224, 224), (64, 3, 7, 7), 2, 3, 1),
    "inception_bn 3x3 at 28": ((128, 160, 28, 28), (192, 160, 3, 3), 1, 1,
                               1),
    "inception_bn 3x3/2 at 28": ((128, 192, 28, 28), (240, 192, 3, 3), 2, 1,
                                 1),
    "inception_bn 1x1 at 28": ((128, 256, 28, 28), (64, 256, 1, 1), 1, 0, 1),
    "bowl 3x3 at 40": ((64, 32, 40, 40), (32, 32, 3, 3), 1, 1, 1),
}


def wgrad_times(seed: int) -> dict:
    """For ``--wgrad``: each WGRAD_SHAPES weight gradient in float32 (x
    and dy in channels_last memory, as the port's conv gives them) by
    cuDNN with ``deterministic`` off and on, by ATen's own convolution
    backward with cuDNN off, and by the port's
    ``layers.conv.conv2d_weight_gemm``: device ms (median of 10 after 3
    warm-ups) and rel L2 from a float64 reference (ATen's, cuDNN off, on
    the card); the route ``layers.conv.wgrad_by_gemm`` gives the
    shape. Prints one line a shape and returns the table."""
    from cxxnet_tpu_torch.layers.conv import conv2d_weight_gemm, \
        wgrad_by_gemm
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = {}
    try:
        for name, (xs, ws, st, pd, gr) in WGRAD_SHAPES.items():
            n, c, h, wd = xs
            x = torch.randn((n, h, wd, c), device="cuda",
                            generator=g).permute(0, 3, 1, 2)
            w = torch.randn(ws, device="cuda", generator=g) * 0.05
            oh = (h + 2 * pd - ws[2]) // st + 1
            ow = (wd + 2 * pd - ws[3]) // st + 1
            gy = torch.randn((n, oh, ow, ws[0]), device="cuda",
                             generator=g).permute(0, 3, 1, 2)

            def aten(x, gy, w):
                return torch.ops.aten.convolution_backward(
                    gy, x, w, None, [st, st], [pd, pd], [1, 1], False,
                    [0, 0], gr, [False, True, False])[1]
            torch.backends.cudnn.enabled = False
            want = aten(x.double(), gy.double(), w.double())
            torch.backends.cudnn.enabled = True

            def rel(got):
                return float((got.double() - want).norm() / want.norm())
            row = {"port_route": "gemm" if wgrad_by_gemm(st, ws[2], ws[3])
                   else "cudnn"}
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                fn = lambda: aten(x, gy, w)
                row[f"cudnn det={int(det)}"] = {
                    "ms": time_forward(fn, reps=10), "rel": rel(fn())}
            torch.backends.cudnn.enabled = False
            fn = lambda: aten(x, gy, w)
            row["aten, cudnn off"] = {"ms": time_forward(fn, reps=10),
                                      "rel": rel(fn())}
            torch.backends.cudnn.enabled = True
            fn = lambda: conv2d_weight_gemm(x, gy, ws, st, (pd, pd), gr)
            row["gemm"] = {"ms": time_forward(fn, reps=10),
                           "rel": rel(fn())}
            table[name] = row
            print(f"wgrad: {name} {json.dumps(row)}", flush=True)
            del x, gy, w, want
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return table


def phase_train_times(tr, plain, batches, gen) -> dict:
    """CUDA-event times of a train step (one host batch, H2D included)
    with the kernels and with fused_kernels = 0, and of each kernel at
    the training path's shapes beside its bound, its plain version and
    one PyTorch call computing the same function."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import fused_optim
    from cxxnet_tpu_torch.ops.fused import stream_handle
    from cxxnet_tpu_torch.ops.fused_epilogue import (bias_act_plain,
                                                     fused_bias_act)
    from cxxnet_tpu_torch.ops.fused_norm import bn_act_plain, bn_fwd
    from cxxnet_tpu_torch.ops.fused_pool import (fused_pool_bwd_lin,
                                                 pool_bwd_lin_plain)
    b0 = batches[0]
    step_ms = time_forward(lambda: tr.update(b0), reps=10)
    step_plain = time_forward(lambda: plain.update(b0), reps=10)
    for who, t in (("kernels", tr), ("fused_kernels=0", plain)):
        line, kinds = profile_kinds(lambda: t.update(b0), 3, "step")
        print(f"profile: train step, {who}: {line}", flush=True)
        if t is tr:
            fwd = [kinds.get(k, (0.0, 0.0)) for k in BN_FWD_KINDS]
            bn_fwd_step = {"ms": sum(ms for ms, _ in fwd),
                           "launches": sum(k for _, k in fwd)} \
                if kinds else None
    print(f"profile: bn_fwd in one train step (the step's profile, kinds "
          f"{' + '.join(BN_FWD_KINDS)}): "
          + ("not measured (no device events)" if bn_fwd_step is None else
             f"{bn_fwd_step['ms']:.4f} ms over {bn_fwd_step['launches']:g} "
             "launches"), flush=True)
    dev = tr.device
    bf = torch.bfloat16
    rnd = lambda shape, dt=bf: torch.randn(shape, generator=gen,
                                           device=dev).to(dt)
    cases = bn_fwd_cases(gen)
    x, g, be, _ = cases["bn_fwd"]                       # bn_stem1
    n, c = x.shape
    w16, b16 = g.to(bf), be.to(bf)
    xm, gm, bm, _ = cases["bn_fwd (mid)"]
    nm, cm = xm.shape
    del cases
    xp = rnd((TRAIN_BATCH, 7, 7, 1024))
    dyp = rnd((TRAIN_BATCH, 1, 1, 1024))
    xe = rnd((TRAIN_BATCH, 1000))
    bias = torch.randn((1000,), generator=gen, device=dev)
    ws = [v.detach().clone() for d in tr.params.values() for v in d.values()]
    gs = [torch.randn_like(w) for w in ws]
    ms = [torch.zeros_like(w) for w in ws]
    table, nblk = fused_optim._table(ws, gs, ms)
    stream = lambda: stream_handle(dev)
    nparam = sum(w.numel() for w in ws)
    tparams = [w.clone().requires_grad_(True) for w in ws]
    for t, gg in zip(tparams, gs):
        t.grad = gg
    sgd = torch.optim.SGD(tparams, lr=0.1, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    rows = {
        "bn_fwd": dict(
            ms=time_call(lambda: bn_fwd(x, g, be, 1e-10, "relu")),
            plain_ms=time_call(lambda: bn_act_plain(x, g, be, 1e-10,
                                                    "relu")),
            library_ms=time_call(lambda: F.batch_norm(
                x, None, None, w16, b16, True, 0.1, 1e-10)),
            bound=bound_ms(2 * n * c * 2, 8 * n * c),
            shape=f"bn_stem1 ({n},{c}) bf16 relu",
            library="F.batch_norm(training=True), bf16 weights, no relu"),
        "bn_fwd (mid)": dict(
            ms=time_call(lambda: bn_fwd(xm, gm, bm, 1e-10, "relu")),
            plain_ms=time_call(lambda: bn_act_plain(xm, gm, bm, 1e-10,
                                                    "relu")),
            library_ms=time_call(lambda: F.batch_norm(
                xm, None, None, gm.to(bf), bm.to(bf), True, 0.1, 1e-10)),
            bound=bound_ms(2 * nm * cm * 2, 8 * nm * cm),
            shape=f"mid layer ({nm},{cm}) bf16 relu",
            library="F.batch_norm(training=True), bf16 weights, no relu"),
        "bn_bwd": bn_bwd_times(gen),
        "pool_fwd": pool_fwd_row(xp),
        "pool_bwd": dict(
            ms=time_call(lambda: fused_pool_bwd_lin(dyp, 7, 7, True)),
            plain_ms=time_call(lambda: pool_bwd_lin_plain(dyp, 7, 7, True)),
            library_ms=time_call(lambda: torch.ops.aten.avg_pool2d_backward(
                dyp.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), [7, 7],
                [1, 1], [0, 0], False, True, None)),
            bound=bound_ms(dyp.numel() * 2 + xp.numel() * 2, xp.numel()),
            shape=f"avg 7x7 global, dy {tuple(dyp.shape)} bf16",
            library="aten.avg_pool2d_backward"),
        "epilogue_fwd": dict(
            ms=time_call(lambda: fused_bias_act(xe, bias, "none")),
            plain_ms=time_call(lambda: bias_act_plain(xe, bias, "none")),
            library_ms=time_call(lambda: torch.add(xe, bias.to(bf))),
            bound=bound_ms(xe.numel() * 2 * 2 + 1000 * 4, xe.numel()),
            shape=f"fc1 bias on {tuple(xe.shape)} bf16",
            library="torch.add(x, bias_bf16)"),
        **epilogue_bwd_times(gen),
        "sgd_apply": dict(
            ms=time_call(lambda: fused_optim.SGD_APPLY.launch(
                table.data_ptr(), len(ws), nblk, fused_optim.CHUNK, 0.1,
                0.9, 1e-4, 0.0, 0, None, stream())),
            plain_ms=time_call(lambda: fused_optim.sgd_apply_plain(
                ws, gs, ms, 0.1, 0.9, 1e-4, 0.0, False)),
            library_ms=time_loop(sgd.step),
            bound=bound_ms(20 * nparam, 6 * nparam),
            shape=f"all {len(ws)} leaves, {nparam} params, f32, one launch",
            library="torch.optim.SGD(fused=True).step() (its momentum "
                    "buffer is cxxnet's times -1/lr)"),
    }
    print(f"times (bn_fwd) by launch: bn_stem1 "
          f"{launch_breakdown(lambda: bn_fwd(x, g, be, 1e-10, 'relu'))} | "
          f"mid layer "
          f"{launch_breakdown(lambda: bn_fwd(xm, gm, bm, 1e-10, 'relu'))}",
          flush=True)
    print(f"times (train): train step {step_ms:.3f} ms, fused_kernels=0 "
          f"{step_plain:.3f} ms (one batch of {TRAIN_BATCH} from the host, "
          "CUDA events, median of 10) | " + " | ".join(
              f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us, bound "
              f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, {r['library']} "
              f"{r['library_ms'] * 1e3:.2f} us"
              + (f" (PERF.md before: {PERF_BEFORE_MS[k]})"
                 if k in PERF_BEFORE_MS else "") for k, r in rows.items()),
          flush=True)
    return {"step_ms": step_ms, "step_plain_ms": step_plain,
            "bn_fwd_step": bn_fwd_step,
            "kernels": rows}


# -- phase 13 -----------------------------------------------------------------

#: rows of the batch tasks' pred section and the batch they run at: the
#: last batch holds 4 real rows and 28 padded ones
TASKS_INST, TASKS_BATCH = 100, 32
#: classes of the pred section's synthetic data: its labels go unused,
#: and the iterator draws num_class x 150,528 centers on the host (some
#: seconds a run at 1000 classes)
TASKS_PRED_CLASSES = 10
#: steps of the continue and finetune runs (TASKS_STEPS batches of 128)
TASKS_STEPS = 2
#: fc1's width in the finetune run
FINETUNE_CLASSES = 10
#: (c, y, x) of the node ``i_5b`` that the global average pool reads
TASKS_I5B = (1024, 7, 7)


def tasks_cfg(conf: str, seed: int, model_path: str, out: str, task: str,
              extra=()):
    """``conf``'s netconfig and globals with a ``pred = <out>`` section of
    ``iter = synthetic`` (TASKS_INST rows from ``seed``) and ``task``
    over the round at ``model_path``, at batch TASKS_BATCH."""
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file, split_sections)
    glob, _ = split_sections(parse_config_file(conf))
    pred = [("pred", out), ("iter", "synthetic"),
            ("num_inst", str(TASKS_INST)),
            ("num_class", str(TASKS_PRED_CLASSES)),
            ("input_shape", TRAIN_IMAGE), ("seed_data", str(seed + 5)),
            ("iter", "end")]
    return glob + pred + parse_cli_overrides([
        f"task={task}", f"batch_size={TASKS_BATCH}", f"model_in={model_path}",
        *extra])


def run_counted(cfg, ready=None, quiet: str = ""):
    """``main.run(cfg)`` with the launch counts set to 0 just before it
    and read just after; returns (its result, launches, seconds, what it
    printed). Printed lines that start with ``quiet`` are kept from
    stdout (still returned)."""
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    tee, old = _Tee(None if quiet else sys.stdout), sys.stdout
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sys.stdout = tee
    try:
        res = run(cfg, ready=ready)
        torch.cuda.synchronize()
    finally:
        sys.stdout = old
    took = time.perf_counter() - t0
    log = "".join(tee.parts)
    if quiet:
        print("".join(ln for ln in log.splitlines(True)
                      if not ln.startswith(quiet)), end="", flush=True)
    return (res, {k.name: k.launches for k in KERNELS.values()}, took, log)


def _read_rows(path: str, ncol: int = 0) -> np.ndarray:
    """A task's output: text rows, or with ``ncol`` little-endian f32."""
    if ncol:
        return np.fromfile(path, "<f4").reshape(-1, ncol)
    with open(path) as f:
        return np.array([[float(v) for v in ln.split()]
                         for ln in f.read().splitlines()], np.float64)


def gap_of(rows: np.ndarray, cyx):
    """Extracted rows of a (c, y, x) node read as NHWC: each channel's
    mean over the y*x cells in float64, and as the global average pool
    defines it in bf16 (``pool_fwd_plain``: the f32 sum rounded to bf16,
    times 1/(y*x) in bf16, rounded), both as (rows, c)."""
    from cxxnet_tpu_torch.ops.fused_pool import pool_fwd_plain
    c, y, x = cyx
    nhwc = rows.reshape(-1, y, x, c)
    pool = pool_fwd_plain(torch.from_numpy(np.ascontiguousarray(
        nhwc, np.float32)).to(torch.bfloat16), y, x, "sum", True, False)
    return (nhwc.astype(np.float64).mean((1, 2)),
            pool.float().numpy().reshape(-1, c))


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference in bf16 units in the last place of
    ``want`` (printed values: 6 digits hold a bf16 value to 2^-17)."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).clip(1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _check_trees(what: str, got, want, skip=()):
    """Every leaf of ``want`` (layer -> leaf -> array) bit-equal in
    ``got``, but for the layers of ``skip``."""
    bad = [f"{l}/{k}" for l, d in want.items() if l not in skip
           for k, v in d.items() if not np.array_equal(got[l][k], v)]
    if bad or set(got) != set(want):
        raise AssertionError(f"{what}: not bit-equal at {bad[:5]} "
                             f"(layers {sorted(set(got) ^ set(want))[:5]})")


def phase_tasks(conf: str, seed: int, tmp: str, tr, smi_line: str) -> dict:
    """Phase 13: the batch tasks and resumed training on phase 6's round
    (``<tmp>/train/0000.model``), each through ``main.run``; ``tr`` is
    phase 6's trainer, which takes the continue run's first step from
    the same state. Returns what the module docstring's phase 13
    prints."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import parse_cli_overrides, split_sections
    from cxxnet_tpu_torch.convert import params_to_jax
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.ops import reset_launches
    t_phase = time.perf_counter()
    c5, y5, x5 = TASKS_I5B
    round_path = os.path.join(tmp, "train", "0000.model")
    blob = ckpt.load_model(round_path)
    out_dir = os.path.join(tmp, "tasks")
    os.makedirs(out_dir)
    n_fwd = -(-TASKS_INST // TASKS_BATCH)

    def forward_task(task, name, extra=(), kernels=True):
        """Run ``task`` into ``name``; with ``kernels`` every forward
        launched the serve kernels, else no kernel launched (the plain
        versions, or a task without a forward)."""
        out = os.path.join(out_dir, name)
        res, launches, took, log = run_counted(
            tasks_cfg(conf, seed, round_path, out, task, extra))
        if kernels:
            bad = {k: launches[k] for k in SERVE_KERNELS
                   if launches[k] < n_fwd or launches[k] % n_fwd}
            if bad:
                raise AssertionError(f"task = {task}: launches {bad} over "
                                     f"{n_fwd} forwards ({launches})")
        elif any(launches.values()):
            raise AssertionError(f"task = {task} {extra} launched kernels: "
                                 f"{launches}")
        if f"write into {out}" not in log:
            raise AssertionError(f"task = {task}: no 'write into {out}'")
        return res, out, launches, took

    # pred_raw with the kernels and with fused_kernels = 0
    tr_raw, raw_path, raw_launches, raw_s = forward_task("pred_raw", "raw.txt")
    _, plain_path, _, _ = forward_task("pred_raw", "plain.txt",
                                       ["fused_kernels=0"], kernels=False)
    raw, plain = _read_rows(raw_path), _read_rows(plain_path)
    if raw.shape != (TASKS_INST, TRAIN_CLASSES) or not np.isfinite(raw).all():
        raise AssertionError(f"pred_raw rows {raw.shape}, finite "
                             f"{np.isfinite(raw).all()}")
    if np.abs(raw.sum(1) - 1.0).max() > 1e-3:
        raise AssertionError("pred_raw rows do not sum to 1")
    raw_err = float(np.abs(raw - plain).max())
    srt = np.sort(plain, 1)
    sure = srt[:, -1] - srt[:, -2] > 0.05
    if raw_err > 2e-2 or (raw.argmax(1)[sure] != plain.argmax(1)[sure]).any():
        raise AssertionError(f"pred_raw vs fused_kernels=0: max diff "
                             f"{raw_err} (atol 2e-2) or top-1 differs")
    # pred: each id among the classes of the row's largest printed value
    _, pred_path, _, _ = forward_task("pred", "pred.txt")
    ids = _read_rows(pred_path)[:, 0].astype(np.int64)
    if ids.shape != (TASKS_INST,) or not all(
            raw[i, j] == raw[i].max() for i, j in enumerate(ids)):
        raise AssertionError("pred's ids are not the argmax of pred_raw")
    # extract at gap (txt) and i_5b (bin); gap is i_5b's channel mean
    _, gap_path, _, _ = forward_task(
        "extract", "gap.txt", ["extract_node_name=gap"])
    _, i5b_path, _, _ = forward_task(
        "extract", "i_5b.bin", ["extract_node_name=i_5b", "output_format=bin"])
    metas = [_read(p + ".meta") for p in (gap_path, i5b_path)]
    if metas != [f"{TASKS_INST},{c5},1,1\n",
                 f"{TASKS_INST},{c5},{y5},{x5}\n"]:
        raise AssertionError(f"extract .meta files: {metas}")
    gap = _read_rows(gap_path)
    i5b = _read_rows(i5b_path, c5 * y5 * x5)
    mean, want = gap_of(i5b, TASKS_I5B)
    # the true mean, beside the check: the pool's three bf16 roundings
    mean_err = float((np.abs(gap - mean) / np.abs(mean).clip(1e-30)).max())
    gap_err = _ulps(gap, want)
    if gap.shape != want.shape or gap_err > 1.0:
        raise AssertionError(f"gap vs the pool of i_5b's NHWC rows: "
                             f"{gap_err} bf16 ulp (tol 1)")
    # get_weight: fc1's wmat bit-equal to the round's
    _, w_path, _, _ = forward_task(
        "get_weight", "fc1.bin", ["extract_layer_name=fc1",
                                  "weight_name=wmat", "output_format=bin"],
        kernels=False)
    want_w = blob["params"]["fc1"]["wmat"]
    got_w = _read_rows(w_path, want_w.shape[1])
    if _read(w_path + ".meta") != f"{c5} {TRAIN_CLASSES}\n" or \
            not np.array_equal(got_w, want_w):
        raise AssertionError("get_weight fc1 wmat differs from the round")
    # the pred_raw forward a batch of TASKS_BATCH, kernels and plain
    net = tr_raw.net
    c, y, x = net.graph.input_shape
    data = torch.randn((TASKS_BATCH, y, x, c), device=net.device,
                       generator=torch.Generator(device=net.device)
                       .manual_seed(seed))
    fwd_ms = time_forward(lambda: net(data))
    fwd_plain_ms = time_forward(lambda: net(data, fused=False))
    del tr_raw, net, data
    torch.cuda.empty_cache()
    print(f"tasks: pred, pred_raw, extract, get_weight through main.run "
          f"from phase 6's round ({TASKS_INST} rows at batch {TASKS_BATCH}, "
          f"the last padded) | pred_raw launches "
          f"{ {k: raw_launches[k] for k in SERVE_KERNELS} } over {n_fwd} "
          f"forwards, rows sum to 1, vs fused_kernels=0 max diff "
          f"{raw_err:.3g} (atol 2e-2), top-1 equal on {int(sure.sum())} "
          f"sure rows | pred ids = argmax of pred_raw | extract .meta "
          f"{metas[0].strip()} and {metas[1].strip()}, gap vs the pool of "
          f"i_5b's rows read as NHWC {gap_err:.3g} bf16 ulp (tol 1; vs their "
          f"f64 channel mean rel {mean_err:.3g}) | get_weight fc1 wmat "
          f"bit-equal | pred_raw task {raw_s:.2f} s end to end (round load "
          f"and net build included), {TASKS_INST / raw_s:.1f} images/s | "
          f"forward at batch {TASKS_BATCH} {fwd_ms:.3f} ms, fused_kernels=0 "
          f"{fwd_plain_ms:.3f} ms | {smi_line}", flush=True)

    # continue = 1 over phase 6's train section cut to TASKS_STEPS steps
    cont_dir = os.path.join(tmp, "continue")
    os.makedirs(cont_dir)
    shutil.copy(round_path, cont_dir)
    box = {"losses": []}

    def ready_continue(t):
        p, o, st = _snap(t)
        _check_trees("continue: params", p, blob["params"])
        _check_trees("continue: momenta", o["mom"], blob["opt"]["mom"])
        _check_trees("continue: BN state", st, blob["state"])
        box["counters"] = (t.round_counter, t.epoch_counter, t.step_count)
        t.step_hook = lambda t2: box["losses"].append(t2.last_loss)
        torch.cuda.synchronize()
        reset_launches()

    cfg = train_cfg(conf, seed, cont_dir, steps=TASKS_STEPS) + \
        parse_cli_overrides(["continue=1", "num_round=2"])
    t_cont, cont_launches, cont_s, log = run_counted(cfg, ready_continue)
    t_cont.step_hook = None
    del t_cont
    if "continuing from round 0 (" not in log:
        raise AssertionError("continue = 1 did not print 'continuing from "
                             "round 0'")
    if box["counters"] != (0, 4, 4):
        raise AssertionError(f"continue: round, epoch, step count "
                             f"{box['counters']}, want (0, 4, 4)")
    train_launches("continue", cont_launches, TASKS_STEPS)
    if not os.path.exists(os.path.join(cont_dir, "0001.model")):
        raise AssertionError("continue = 1 wrote no 0001.model")
    glob, secs = split_sections(cfg)
    first = next(iter(create_iterator(
        glob + [p for kind, _, p in secs if kind == "data"][0])))
    _load(tr, (blob["params"], blob["opt"], blob["state"]), 4)
    tr.update(first)
    ref = tr.last_loss
    got = box["losses"][0]
    cont_err = abs(got - ref) / max(1.0, abs(ref))
    if len(box["losses"]) != TASKS_STEPS or not cont_err <= 2e-2:
        raise AssertionError(f"continue: losses {box['losses']}, first vs "
                             f"phase 6's trainer from the round {ref} "
                             f"(tol 2e-2 of max(1, |loss|))")

    # finetune from the round with fc1 at FINETUNE_CLASSES
    ft_dir = os.path.join(tmp, "finetune")
    cfg = train_cfg(conf, seed, ft_dir, steps=TASKS_STEPS) + \
        parse_cli_overrides(["task=finetune", f"model_in={round_path}"])
    at = cfg.index(("layer[flat->fc]", "fullc:fc1")) + 1
    if cfg[at] != ("nhidden", str(TRAIN_CLASSES)):
        raise AssertionError(f"fc1's width is not at {at}: {cfg[at]}")
    cfg[at] = ("nhidden", str(FINETUNE_CLASSES))
    cfg = [("num_class", str(FINETUNE_CLASSES)) if kv[0] == "num_class"
           else kv for kv in cfg]

    def ready_finetune(t):
        got_p = params_to_jax(t.params, {})[0]
        _check_trees("finetune: copied layers", got_p, blob["params"],
                     skip=("fc1",))
        fresh = params_to_jax(*t.net.init(
            torch.Generator().manual_seed(t.seed)))[0]["fc1"]
        _check_trees("finetune: fc1's fresh draw", {"fc1": got_p["fc1"]},
                     {"fc1": fresh})
        box["fc1"] = got_p["fc1"]["wmat"].shape
        torch.cuda.synchronize()
        reset_launches()

    _, ft_launches, ft_s, log = run_counted(
        cfg, ready_finetune, quiet="CopyModelFrom: copied layer")
    if "CopyModelFrom: shape mismatch, skip layer 'fc1'" not in log or \
            box["fc1"] != (c5, FINETUNE_CLASSES):
        raise AssertionError(f"finetune: fc1 {box['fc1']}, no skip line")
    train_launches("finetune", ft_launches, TASKS_STEPS)
    if not os.path.exists(os.path.join(ft_dir, "0000.model")):
        raise AssertionError("finetune wrote no 0000.model")
    seconds = time.perf_counter() - t_phase
    print(f"tasks: continue = 1 (num_round 2, {TASKS_STEPS} steps) resumed "
          f"round 0 bit-equal (params, momenta, BN state; round, epoch, "
          f"step count {box['counters']}), losses "
          f"{[round(v, 4) for v in box['losses']]}, first step vs phase 6's "
          f"trainer from the round {cont_err:.3g} of max(1,|loss|) (tol "
          f"2e-2), launches per step bn_fwd {cont_launches['bn_fwd'] // TASKS_STEPS}"
          f" bn_bwd {cont_launches['bn_bwd'] // TASKS_STEPS} sgd_apply "
          f"{cont_launches['sgd_apply'] // TASKS_STEPS}, 0001.model written, "
          f"{cont_s:.1f} s | finetune fc1 -> {FINETUNE_CLASSES} classes: "
          f"every other layer copied bit-equal, fc1 its fresh draw, "
          f"launches per step bn_fwd {ft_launches['bn_fwd'] // TASKS_STEPS} "
          f"sgd_apply {ft_launches['sgd_apply'] // TASKS_STEPS}, "
          f"0000.model written, {ft_s:.1f} s | phase {seconds:.1f} s | "
          f"{smi_line}", flush=True)
    return {"pred_raw_s": raw_s, "pred_raw_images_per_s": TASKS_INST / raw_s,
            "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
            "pred_raw_vs_plain": raw_err, "gap_vs_i5b_pool_ulp": gap_err,
            "gap_vs_i5b_mean": mean_err,
            "continue_losses": box["losses"], "continue_first_vs_tr": cont_err,
            "continue_s": cont_s, "finetune_s": ft_s, "seconds": seconds,
            "launches": {"pred_raw": {k: raw_launches[k]
                                      for k in SERVE_KERNELS},
                         "continue": cont_launches,
                         "finetune": ft_launches}}


# -- phase 7 ------------------------------------------------------------------

#: bounds of the LM phase, kernels against fused_kernels = 0 from the
#: same state (readings in PERF.md section 2): the loss relative to
#: max(1, |loss|), and each parameter leaf's gradient as a relative L2
#: difference; per dtype
LM_LOSS_TOL = {"bfloat16": 1e-4, "float16": 1e-4, "float32": 1e-6}
LM_GRAD_TOL = {"bfloat16": 1e-2, "float16": 1e-2, "float32": 1e-5}


def lm_cfg(seed: int, model_dir: str, extra=()):
    """The long-context LM's config as ``python -m cxxnet_tpu_torch.main``
    reads it, its data section's ``num_inst`` cut from 256 to LM_STEPS
    batches of 8 (a cut of depth only), weights drawn from ``seed``."""
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file, split_sections)
    glob, sections = split_sections(parse_config_file(LM_CONF))
    data = [p for kind, _, p in sections if kind == "data"][0]
    data = [(k, str(8 * LM_STEPS) if k == "num_inst" else v)
            for k, v in data]
    return (glob + [("data", "train")] + data + [("iter", "end")]
            + parse_cli_overrides([
                "task=train", "num_round=1", f"model_dir={model_dir}",
                "save_model=1", "print_step=1", f"seed={seed}", *extra]))


def _paths(tree):
    from cxxnet_tpu_torch.optim import leaves
    return dict(leaves(tree))


def _is_k_bias(path):
    return len(path) == 3 and path[1:] == ("k", "bias")


def _grad_rels(got, want):
    """Per parameter leaf (the k biases aside), the relative L2
    difference of two gradient trees, as (rel, leaf) pairs."""
    g, w = _paths(got), _paths(want)
    return [(float((g[p] - w[p]).norm() / w[p].norm().clamp_min(1e-30)),
             "/".join(p)) for p in w if not _is_k_bias(p)]


def adam_step_bound(lr: float, t: int, d1: float, d2: float) -> float:
    """The most one Adam step t can move an element: lr times the
    Cauchy-Schwarz bound sqrt(sum_i a_i^2 / b_i) of |m1_hat| /
    sqrt(m2_hat), with a_i and b_i the weights of gradient i in the
    bias-corrected moments (1 at t = 1, 1.007 at t = 4 for d1 0.1 and d2
    0.001). A leaf whose gradient is rounding noise moves this far at
    most, in either direction."""
    i = np.arange(1, t + 1)
    a = d1 * (1 - d1) ** (t - i) / (1 - (1 - d1) ** t)
    b = d2 * (1 - d2) ** (t - i) / (1 - (1 - d2) ** t)
    return lr * float(np.sqrt(np.sum(a * a / b)))


def _k_bias_moves(params, before, opt, epoch):
    """Largest move of a k bias in step ``epoch + 1`` over the most an
    Adam step can move it (:func:`adam_step_bound`)."""
    h = opt.hypers["bias"]
    bound = adam_step_bound(opt.schedules(epoch)["bias"][0], epoch + 1,
                            h.beta1_decay, h.beta2_decay)
    p, b = _paths(params), _paths(before)
    return max(float((p[k].detach().cpu() - torch.as_tensor(b[k]))
                     .abs().max()) / bound for k in b if _is_k_bias(k))


def lm_step_check(kern, plain, snap, batch, epoch, dtype):
    """One step's gradients with the kernels and with fused_kernels = 0
    from the same state: (loss difference of max(1, |loss|), per-leaf
    gradient rel L2 pairs, the plain step's k-bias move over its bound,
    loss)."""
    got = []
    for t in (kern, plain):
        _load(t, snap, epoch)
        loss, _, _, grads = t.gradients(batch)
        got.append((float(loss.detach()), grads))
    (lk, gk), (lp, gp) = got
    plain.optimizer.update(plain.params, gp, plain.opt_state,
                           plain.optimizer.schedules(epoch))
    return (abs(lk - lp) / max(1.0, abs(lp)), _grad_rels(gk, gp),
            _k_bias_moves(plain.params, snap[0], plain.optimizer, epoch),
            lk)


def phase_lm(seed: int, tmp: str):
    """Train the long-context LM through main.run (LM_STEPS steps of
    batch 8 at S 2048, bf16, remat, Adam), check the launches, hold
    each step against fused_kernels = 0 from the same state, then two
    f32 steps likewise, and load the written round. Returns (the run's
    trainer, a bf16 kernel trainer and its fused_kernels = 0 twin,
    batches, launches, notes)."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    model_dir = os.path.join(tmp, "lm")
    cfg = lm_cfg(seed, model_dir)
    box = {"losses": [], "before": []}

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        box["before"].append(_snap(tr))

    def ready(tr):
        box["before"].append(_snap(tr))
        tr.step_hook = on_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS.values()}
    took = time.perf_counter() - box["t0"]
    peak = torch.cuda.max_memory_allocated()
    tr.step_hook = None
    g = tr.graph
    mha = [l for l in tr.net.layers if l.spec.type == "mha"]
    c, _, S = g.input_shape
    B = int(dict(tr.cfg)["batch_size"])
    E = tr.net.node_shapes[mha[0].spec.nindex_in[0]][0]
    attn = (B, S, mha[0].nhead, E // mha[0].nhead, tr.net.compute_dtype,
            mha[0].causal)
    steps = len(box["losses"])
    if attn != LM_PATH_ATTN or steps != LM_STEPS or not tr.net.remat:
        raise AssertionError(f"LM path {attn}, {steps} steps, remat "
                             f"{tr.net.remat}")
    groups = len(tr.optimizer._groups(tr.params))
    want = {"flash_fwd": 2 * len(mha) * steps,
            "flash_bwd_dq": len(mha) * steps,
            "flash_bwd_dkv": len(mha) * steps,
            "adam_apply": groups * steps}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"LM launches (got, want) per kernel: {bad}")
    losses = box["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite LM loss: {losses}")

    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    batches = list(create_iterator(glob + data))
    quiet = [("silent", "1")]
    checks = {}
    for dt in ("bfloat16", "float32"):
        pol = quiet + [("compute_dtype", dt)]
        kern = Trainer(glob + pol)
        plain = Trainer(glob + pol + [("fused_kernels", "0")])
        snaps = box["before"][:steps] if dt == "bfloat16" else []
        if dt == "float32":               # two f32 steps from the init
            kern.init_model((box["before"][0][0], box["before"][0][2]))
            for b in batches[:2]:
                snaps.append(_snap(kern))
                kern.update(b)
        rows = []
        for i, b in enumerate(batches[:len(snaps)]):
            dl, rels, kmove, lk = lm_step_check(kern, plain, snaps[i], b,
                                                i, dt)
            rows.append((dl, float(np.median([r for r, _ in rels])),
                         max(rels), kmove, lk))
        checks[dt] = rows
        if dt == "bfloat16":
            kern_lm, plain_lm = kern, plain
        else:
            del kern, plain
    # the run's own steps: each k bias moved at most its Adam step bound
    run_kmove = max(_k_bias_moves(_unflat_np(after[0]),
                                  box["before"][i][0], tr.optimizer, i)
                    for i, after in enumerate(box["before"][1:]))
    fails = [f"{dt} step {i + 1}: {row}" for dt, rows in checks.items()
             for i, row in enumerate(rows)
             if row[0] > LM_LOSS_TOL[dt] or row[2][0] > LM_GRAD_TOL[dt]
             or row[3] > 1 + 1e-3]
    if run_kmove > 1 + 1e-3:
        fails.append(f"the run's k bias moved {run_kmove} of the bound")
    if fails:
        raise AssertionError("LM kernels vs fused_kernels=0 from the same "
                             f"state (tol loss {LM_LOSS_TOL}, gradient "
                             f"{LM_GRAD_TOL}, k bias 1 + 1e-3 of the Adam "
                             f"step bound): {fails}")

    # the written round loads in the port and gives finite log-probs
    path = ckpt.model_path(model_dir, 0)
    blob = ckpt.load_for_inference(path)
    net = Network(tr.graph, [kv for kv in glob if kv[0] != "task"])
    ckpt.check_structure(blob["meta"], tr.graph.structure_signature())
    net.load_weights(*params_from_jax(blob["params"], blob["state"]))
    x = torch.from_numpy(batches[0].data).to(net.device)
    logp = net(x).out.float()
    norm = torch.logsumexp(logp, dim=-1).abs().max().item()
    if not bool(torch.isfinite(logp).all()) or norm > 1e-3:
        raise AssertionError(f"the written round's log-probabilities: "
                             f"finite {bool(torch.isfinite(logp).all())}, "
                             f"|logsumexp| {norm}")
    n_params = sum(v.numel() for v in _paths(tr.params).values())
    fmt = lambda rows: [(f"{dl:.2g}", f"{md:.2g}", f"{w[0]:.2g} {w[1]}",
                         f"{km:.2g}") for dl, md, w, km, _ in rows]
    print(f"lm: {steps} steps of the long-context LM (E 128, 8 heads of "
          f"16, S 2048, batch 8, bf16, remat, Adam) through main.run in "
          f"{took:.1f}s with the round written | losses "
          f"{[round(v, 4) for v in losses]} | launches "
          f"{ {k: launches[k] for k in want} } (per step: flash_fwd "
          f"{launches['flash_fwd'] // steps}, flash_bwd_dq "
          f"{launches['flash_bwd_dq'] // steps}, flash_bwd_dkv "
          f"{launches['flash_bwd_dkv'] // steps}, adam_apply "
          f"{launches['adam_apply'] // steps} for {groups} tag groups) | "
          f"vs fused_kernels=0 from the same state, per step (loss diff of "
          f"max(1,|loss|), gradient rel L2 median, worst leaf, k-bias move "
          f"of the plain step over the Adam step bound): bf16 "
          f"{fmt(checks['bfloat16'])}, f32 "
          f"{fmt(checks['float32'])} (tol loss {LM_LOSS_TOL}, gradient "
          f"{LM_GRAD_TOL}, k bias 1.001) | the run's k-bias move "
          f"{run_kmove:.3g} of the bound | round {os.path.basename(path)} "
          f"loads, "
          f"finite log-probs (|logsumexp| {norm:.2g}) | {n_params} "
          f"parameters | peak memory {peak / 2**30:.2f} GiB", flush=True)
    return tr, kern_lm, plain_lm, batches, launches, {
        "losses": losses, "checks": checks, "params": n_params,
        "peak_gib": peak / 2**30, "seconds": took,
        "run_k_bias_move": run_kmove}


def _unflat_np(tree):
    from cxxnet_tpu_torch.optim import leaves, unflatten
    return unflatten((p, torch.as_tensor(v)) for p, v in leaves(tree))


def adam_shapes(conf: str):
    """Every parameter leaf shape of the net config ``conf``, both tag
    groups (the Adam rows time them in one launch)."""
    return [sh for shapes in lm_shapes(conf)[1].values() for sh in shapes]


def adam_launcher(ws, gs, m1, m2, lr_t=1e-3, d1=0.1, d2=0.001, wd=1e-4,
                  clip=0.0):
    """A call that launches the tree's ``adam_apply`` kernel once over the
    leaves, its table uploaded once beforehand (``fused_optim.adam_table``;
    a tree without it takes ``_table``'s CHUNK-element CTAs)."""
    from cxxnet_tpu_torch.ops import fused_optim as fo
    from cxxnet_tpu_torch.ops.fused import stream_handle
    if hasattr(fo, "adam_table"):
        table, nblk = fo.adam_table(ws, gs, m1, m2)
        args = (table.data_ptr(), len(ws), nblk)
    else:
        table, nblk = fo._table(ws, gs, m1, m2)
        args = (table.data_ptr(), len(ws), nblk, fo.CHUNK)

    def call(table=table):             # keeps the table alive
        fo.ADAM_APPLY.launch(*args, lr_t, d1, d2, wd, clip,
                             stream_handle(table.device))
    return call


def adam_row(ws, what: str) -> dict:
    """``adam_apply`` over the leaves ``ws`` in one launch (wd 1e-4, no
    clip): its CUDA-graph time beside its bound (w, g, m1, m2 read, w, m1,
    m2 written: 28 bytes a parameter), its plain version and
    ``torch.optim.Adam(fused=True).step()`` (a host loop)."""
    from cxxnet_tpu_torch.ops.fused_optim import adam_apply_plain
    gs = [torch.randn_like(w) for w in ws]
    m1 = [torch.zeros_like(w) for w in ws]
    m2 = [torch.zeros_like(w) for w in ws]
    n = sum(w.numel() for w in ws)
    tparams = [w.clone().requires_grad_(True) for w in ws]
    for t, gg in zip(tparams, gs):
        t.grad = gg
    adam = torch.optim.Adam(tparams, lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    return dict(
        ms=time_call(adam_launcher(ws, gs, m1, m2)),
        plain_ms=time_call(lambda: adam_apply_plain(
            ws, gs, m1, m2, 1e-3, 0.1, 0.001, 1e-4, 0.0)),
        library_ms=time_loop(adam.step),
        bound=bound_ms(28 * n, 12 * n),
        shape=f"{what}: all {len(ws)} leaves, {n} params, f32, one "
              "launch",
        library="torch.optim.Adam(fused=True).step()")


def phase_lm_times(tr, kern, plain, batches, gen) -> dict:
    """CUDA-event times of an LM train step with the kernels and with
    fused_kernels = 0 (from the same state, one host batch), and of each
    LM kernel at the path's shape beside its bound, its plain version
    and one PyTorch library call computing the same function; the Adam
    apply also at Inception-BN's size."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import attention as att
    b0 = batches[0]
    snap = _snap(tr)
    _load(kern, snap, 0)
    _load(plain, snap, 0)
    step_ms = time_forward(lambda: kern.update(b0), reps=10)
    step_plain = time_forward(lambda: plain.update(b0), reps=10)
    prof = {}
    for who, t in (("kernels", kern), ("fused_kernels=0", plain)):
        prof[who] = profile_calls(lambda: t.update(b0), 3, "step")
        print(f"profile: LM train step, {who}: {prof[who]}", flush=True)
    dev = tr.device
    B, S, H, D, dt, causal = LM_PATH_ATTN
    q, k, v, g = (torch.randn((B, S, H, D), generator=gen, device=dev)
                  .to(dt) for _ in range(4))
    scale = D ** -0.5
    out, lse = att.flash_fwd(q, k, v, causal, scale)
    delta = att.flash_delta(out, g)
    args = (q, k, v, g, lse, delta, causal, scale)
    qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    # SDPA's backward as one op in a CUDA graph, fed its own forward's
    # saved outputs, as the kernels are timed (its flash op and its cuDNN
    # op, which F.scaled_dot_product_attention dispatches to on the H100);
    # and through autograd in a host loop, printed beside them
    sdpa_bwd = sdpa_backward_ms(qh, kh, vh, gh, causal, scale)
    qh, kh, vh = (t.requires_grad_(True) for t in (qh, kh, vh))
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    sdpa_bwd_loop = time_loop(lambda: torch.autograd.grad(
        oh, (qh, kh, vh), gh, retain_graph=True))
    el, rows_ = B * S * H * D, B * H * S
    # the (query, key) pairs that count: the causal lower triangle with
    # its diagonal, or all; one product (2 D FLOPs) and, per kernel, one
    # exponential each
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    rows = {
        "flash_fwd": dict(
            ms=time_call(lambda: att.flash_fwd(q, k, v, causal, scale)),
            plain_ms=time_loop(lambda: att.flash_fwd_plain(q, k, v, causal,
                                                           scale)),
            library_ms=time_call(lambda: F.scaled_dot_product_attention(
                qh.detach(), kh.detach(), vh.detach(), is_causal=causal)),
            bound=flash_bound_ms(4 * el * 2 + 4 * rows_, 2 * 2 * pairs * D,
                                 pairs),
            library="F.scaled_dot_product_attention forward"),
        "flash_bwd_dq": dict(
            ms=time_call(lambda: att.flash_bwd_dq(*args)),
            plain_ms=time_loop(lambda: att.flash_bwd_dq_plain(*args)),
            library_ms=min(sdpa_bwd.values()),
            bound=flash_bound_ms(5 * el * 2 + 8 * rows_, 3 * 2 * pairs * D,
                                 pairs),
            library="SDPA backward, the faster of its flash and cuDNN "
                    "ops in a CUDA graph (dq, dk and dv together)"),
        "flash_bwd_dkv": dict(
            ms=time_call(lambda: att.flash_bwd_dkv(*args)),
            plain_ms=time_loop(lambda: att.flash_bwd_dkv_plain(*args)),
            library_ms=min(sdpa_bwd.values()),
            bound=flash_bound_ms(6 * el * 2 + 8 * rows_, 4 * 2 * pairs * D,
                                 pairs),
            library="SDPA backward, the faster of its flash and cuDNN "
                    "ops in a CUDA graph (dq, dk and dv together)"),
    }
    for r in rows.values():
        r["shape"] = (f"(B {B}, S {S}, H {H}, D {D}) {str(dt)[6:]} "
                      f"causal={int(causal)}")
    # the three kernels where the exponentials double (no mask) and in
    # f16: do their times track the exp count?
    extra = {}
    for what, c, t in (("non-causal", False, dt),
                       ("f16", causal, torch.float16)):
        qq, kk, vv, gg = (x.to(t) for x in (q, k, v, g))
        pp = B * H * S * (S + 1) // 2 if c else B * H * S * S
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous()
                          for x in (qq, kk, vv, gg))
        oo, ll = att.flash_fwd(qq, kk, vv, c, scale)
        a2 = (qq, kk, vv, gg, ll, att.flash_delta(oo, gg), c, scale)
        sdpa_b = sdpa_backward_ms(qt, kt, vt, gt, c, scale)
        extra[what] = {
            "flash_fwd": dict(
                ms=time_call(lambda: att.flash_fwd(qq, kk, vv, c, scale)),
                library_ms=time_call(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=c)),
                bound=flash_bound_ms(4 * el * 2 + 4 * rows_, 2 * 2 * pp * D,
                                     pp)),
            "flash_bwd_dq": dict(
                ms=time_call(lambda: att.flash_bwd_dq(*a2)),
                library_ms=min(sdpa_b.values()),
                bound=flash_bound_ms(5 * el * 2 + 8 * rows_, 3 * 2 * pp * D,
                                     pp)),
            "flash_bwd_dkv": dict(
                ms=time_call(lambda: att.flash_bwd_dkv(*a2)),
                library_ms=min(sdpa_b.values()),
                bound=flash_bound_ms(6 * el * 2 + 8 * rows_, 4 * 2 * pp * D,
                                     pp))}

    rows["adam_apply"] = adam_row(
        [v.detach().clone() for v in _paths(tr.params).values()], "LM")
    ibn = adam_row([torch.randn(sh, generator=gen, device=dev)
                    for sh in adam_shapes(FLAGSHIP)], "Inception-BN")
    line = lambda k, r: (f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us "
                         f"({_rate(r)}), bound "
                         f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][-1]}), "
                         f"plain {r['plain_ms'] * 1e3:.2f} us, "
                         f"{r['library']} {r['library_ms'] * 1e3:.2f} us"
                         + (f" (PERF.md before: {PERF_BEFORE_MS[k]})"
                            if k in PERF_BEFORE_MS else ""))
    print(f"times (LM): train step {step_ms:.3f} ms, fused_kernels=0 "
          f"{step_plain:.3f} ms (one batch of 8 x 2048 tokens from the host, "
          "CUDA events, median of 10) | "
          + " | ".join(line(k, r) for k, r in rows.items())
          + " | SDPA backward ops in a CUDA graph: " + ", ".join(
              f"{k} {v * 1e3:.2f} us" for k, v in sdpa_bwd.items())
          + f"; through autograd, host loop: {sdpa_bwd_loop * 1e3:.2f} us"
          + " | " + line("adam_apply (Inception-BN)", ibn) + " | "
          + " | ".join(
              f"{k} {what}: {r['ms'] * 1e3:.2f} us, bound "
              f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][-1]}), SDPA "
              f"{'forward' if k == 'flash_fwd' else 'backward'} "
              f"{r['library_ms'] * 1e3:.2f} us"
              for what, e in extra.items() for k, r in e.items()),
          flush=True)
    return {"step_ms": step_ms, "step_plain_ms": step_plain,
            "kernels": rows, "adam_ibn": ibn, "profile": prof,
            "sdpa_backward_ms": sdpa_bwd,
            "sdpa_backward_host_loop_ms": sdpa_bwd_loop,
            "flash_extra": {w: {k: {"ms": r["ms"],
                                    "library_ms": r["library_ms"],
                                    "bound_ms": r["bound"][0]}
                                for k, r in e.items()}
                            for w, e in extra.items()}}


def sdpa_backward_ms(qh, kh, vh, gh, causal: bool, scale: float) -> dict:
    """CUDA-graph time in ms of SDPA's backward as one op on (B, H, S, D)
    tensors, fed the saved outputs of its own forward, through its flash
    op and its cuDNN op (the library yardstick of the flash backward
    kernels: dq, dk and dv in one call)."""
    aten = torch.ops.aten
    o, lse, cq, ck, mq, mk, seed, off = \
        aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, causal, False, scale=scale)[:8]
    flash = lambda: aten._scaled_dot_product_flash_attention_backward(
        gh, qh, kh, vh, o, lse, cq, ck, mq, mk, 0.0, causal, seed, off,
        scale=scale)
    o2, lse2, cq2, ck2, mq2, mk2, seed2, off2 = \
        aten._scaled_dot_product_cudnn_attention(
            qh, kh, vh, None, True, 0.0, causal, False, scale=scale)[:8]
    cudnn = lambda: aten._scaled_dot_product_cudnn_attention_backward(
        gh, qh, kh, vh, o2, lse2, seed2, off2, None, cq2, ck2, mq2, mk2, 0.0,
        causal, scale=scale)
    return {"flash": time_call(flash), "cudnn": time_call(cudnn)}


# -- phase 8 ------------------------------------------------------------------

ALEXNET = os.path.join(ROOT, "examples", "ImageNet", "alexnet.conf")
KAIMING = os.path.join(ROOT, "examples", "ImageNet", "kaiming.conf")
DIGITS = os.path.join(ROOT, "examples", "digits", "digits_lenet.conf")
#: the convnet cells: name -> (config, batch, input shape, launches per
#: step of the kernels this slice added)
CONVNETS = {"alexnet": (ALEXNET, 256, "3,227,227",
                        {"lrn_fwd": 2, "lrn_bwd": 2}),
            "spp": (KAIMING, 128, "3,224,224", {"pool_bwd_max": 1})}
CONVNET_STEPS = 4
#: bounds of the convnet phase, kernels against fused_kernels = 0 from the
#: same state with the same draws (readings in PERF.md section 2), per
#: dtype: the loss difference (bf16: of max(1, |loss|); f32: relative)
#: and the parameter gradients' relative L2 difference, as (median over
#: leaves, worst leaf). In f32 the worst leaf is AlexNet's cv2 weight,
#: whose gradient is 1e-3 of its weight's norm and sums 186,624 products
#: of mixed sign: cuDNN's nondeterministic weight gradient of that
#: grouped conv moves it by 8.8e-4 between two runs of the same plain
#: step, so each check also reports that run-to-run spread
CONVNET_LOSS_TOL = {"bfloat16": 1e-3, "float32": 1e-5}
CONVNET_GRAD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (4e-6, 1e-2)}
#: phase 3's LRN hyperparameters: AlexNet's, then the odd cases'
LRN_ALEX = (5, 1e-4, 0.75, 1.0)          # nsize, alpha, beta, knorm
#: AlexNet's two LRN layers and their inputs' shapes at batch 256
LRN_LAYERS = (("lrn1", (256, 27, 27, 96)), ("lrn2", (256, 13, 13, 256)))
#: threads a block of the LRN kernels swept by ``--ab`` at lrn1
LRN_SWEEP = (128, 256, 512)
#: lrn1's images that ``--ab`` also times out of the L2 (x and y 19 MB)
LRN_L2_IMAGES = 64


def lrn_inputs(gen: torch.Generator, shape):
    """x (scaled by 3, so that the window sums matter) and dy, bf16."""
    x = (torch.randn(shape, generator=gen, device=gen.device) * 3).to(
        torch.bfloat16)
    return x, torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


#: the max-pool backward on the paths: (inputs, x shape, window); spp1,
#: the digits LeNet's 2x2 and a global 7x7 on tie-ridden integers
POOL_BWD_PATHS = (("ints",) + SPP1, ("ints",) + LENET_POOL,
                  ("ints", (32, 7, 7, 256), 7))
#: the max-pool backward's edge cases: the first match in another window
#: row on each lane of a vector, C that no 16-byte vector divides, a base
#: one element past 16 bytes, NaN cells and NaN maxima, windows of
#: non-positive values, a global 13x13 (169 cells, a row in chunks) and a
#: global 27x27 (two rounds of 16 rows)
POOL_BWD_EDGES = (("rows", (16, 9, 9, 64), 3), ("rows", (16, 8, 8, 16), 2),
                  ("ints", (6, 9, 9, 5), 3), ("ints", (6, 6, 6, 20), 2),
                  ("ints", (6, 9, 9, 40), 3), ("offset", (6, 9, 9, 64), 3),
                  ("nan", (16, 9, 9, 64), 3), ("nonpos", (16, 9, 9, 64), 3),
                  ("ints", (8, 13, 13, 64), 13), ("ints", (4, 27, 27, 16), 27))
#: phase 3's max-pool backward cases
POOL_BWD_CASES = POOL_BWD_PATHS + POOL_BWD_EDGES


def pool_bwd_case(seed: int, kind: str, shape, k: int, dt, relu: bool,
                  dev="cuda"):
    """x, y and dy of a max-pool backward case (POOL_BWD_CASES), made
    from ``seed`` with numpy and put on ``dev``: x drawn from -2..2 (ties
    abound); "rows": lane c's max (2, and a tie 1 cell later) in window
    row c mod k; "offset": x starts one element past a 16-byte boundary;
    "nan": NaN cells after y was taken and NaN maxima; "nonpos": windows
    of values <= 0 (under pre_relu they pass nothing)."""
    from cxxnet_tpu_torch.ops.fused_pool import pool_fwd_plain
    rng = np.random.RandomState(seed)
    lo, hi = (-3, 1) if kind == "nonpos" else (-2, 3)
    xn = rng.randint(lo, hi, shape).astype(np.float32)
    if kind == "rows":
        b, h, w, c = shape
        xr = xn.reshape(b, h // k, k, w // k, k, c)
        np.minimum(xr, 1, out=xr)
        for ch in range(c):
            r, col = ch % k, (ch // k) % k
            xr[:, :, r, :, col, ch] = 2
            xr[:, :, (r + (col + 1) // k) % k, :, (col + 1) % k, ch] = 2
    x = torch.from_numpy(xn).to(dev, dt)
    if kind == "offset":
        buf = torch.empty(x.numel() + 1, dtype=dt, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    y = pool_fwd_plain(x, k, k, "max", False, relu)
    if kind == "nan":
        x.view(-1)[::37] = float("nan")
        y.view(-1)[::29] = float("nan")
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    return x, y, dy.to(dev, dt)


def phase_convnet_kernels(gen: torch.Generator) -> dict:
    """The convnet path's kernels against their plain versions: LRN
    forward and backward at AlexNet's lrn1 and lrn2 (bf16, f16, f32) and
    at 7 rows by C 7, C 1500 (past the TPU kernel's 1024), C 4104 (past
    a block's threads in bf16: chunks of a row) and a ragged row count,
    with nsize 3, 4 and 5, knorm 1 and 2, beta 0.75 and 0.5
    (float32 within 4 ulp of max|plain|, bf16/f16 one ulp of the value);
    the first-match max-pool backward in every case of POOL_BWD_CASES,
    pre_relu on and off (bit-equal). Returns the largest error per
    kernel at the path's shape."""
    from cxxnet_tpu_torch.ops.fused_lrn import (fused_lrn_bwd, fused_lrn_fwd,
                                                lrn_bwd_plain, lrn_plain)
    from cxxnet_tpu_torch.ops.fused_pool import (fused_pool_bwd_max,
                                                 pool_bwd_max_plain)
    dev = gen.device
    path_err, lines = {}, []
    dts = (torch.bfloat16, torch.float16, torch.float32)
    cases = [((256, 27, 27, 96), dt, LRN_ALEX) for dt in dts]
    cases += [((256, 13, 13, 256), dt, LRN_ALEX) for dt in dts]
    cases += [(shape, dt, (n, 0.1, beta, knorm))
              for shape in ((1, 1, 7, 7), (1, 1, 3, 1500), (3, 5, 7, 33),
                            (1, 1, 7, 4104))
              for dt in dts for n in (3, 4, 5)
              for knorm, beta in ((1.0, 0.75), (2.0, 0.5))]
    for shape, dt, (n, alpha, beta, knorm) in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
        dy = torch.randn(shape, generator=gen, device=dev).to(dt)
        y = fused_lrn_fwd(x, n, alpha, beta, knorm)
        y0 = lrn_plain(x, n, alpha, beta, knorm)
        dx = fused_lrn_bwd(x, dy, n, alpha, beta, knorm)
        dx0 = lrn_bwd_plain(x, dy, n, alpha, beta, knorm)
        torch.cuda.synchronize()
        errs = []
        for got, want in ((y, y0), (dx, dx0)):
            err = (got.float() - want.float()).abs()
            if dt == torch.float32:
                bad = bool((err > 4 * 2.0 ** -23
                            * want.abs().max()).any())
            else:
                bad = bool((err > _ulp_tol(dt) * want.float().abs()
                            + 1e-30).any())
            errs.append((err.max().item(), bad))
        lines.append(f"lrn {shape} {str(dt)[6:]} nsize {n} knorm {knorm} "
                     f"beta {beta}: fwd {errs[0][0]:.3g} bwd "
                     f"{errs[1][0]:.3g}")
        if errs[0][1] or errs[1][1]:
            raise AssertionError("lrn kernels disagree (tol f32 4 ulp of "
                                 "max|plain|, bf16/f16 one ulp): "
                                 + lines[-1])
        if shape == (256, 27, 27, 96) and dt == torch.bfloat16:
            path_err["lrn_fwd"], path_err["lrn_bwd"] = errs[0][0], errs[1][0]
    for (kind, shape, k), dt, relu in ((p, dt, r) for p in POOL_BWD_CASES
                                       for dt in dts for r in (False, True)):
        x, y, dy = pool_bwd_case(shape[3] + k, kind, shape, k, dt, relu)
        got = fused_pool_bwd_max(x, y, dy, k, k, relu)
        want = pool_bwd_max_plain(x, y, dy, k, k, relu)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lines.append(f"pool_bwd_max {kind} {k}x{k} {shape} {str(dt)[6:]} "
                     f"relu={int(relu)}: max_abs_err {err:.3g} (tol 0)")
        if not torch.equal(got, want):
            raise AssertionError("max-pool backward kernel disagrees: "
                                 + lines[-1])
        if (shape, k) == SPP1 and dt == torch.bfloat16 and not relu:
            path_err["pool_bwd_max"] = err
    print(f"kernels (convnets): {len(lines)} cases agree with the plain "
          "versions | " + " | ".join(lines), flush=True)
    return path_err


def check_launches(what: str, launches: dict, exact: dict,
                   at_least: dict) -> None:
    """Raise unless each kernel of ``exact`` launched exactly that often
    and each of ``at_least`` at least that often."""
    bad = {k: (launches[k], v) for k, v in exact.items() if launches[k] != v}
    bad.update({k: (launches[k], f">= {v}") for k, v in at_least.items()
                if launches[k] < v})
    if bad:
        raise AssertionError(f"{what} launches (got, want): {bad}")


def convnet_step_check(kern, plain, snap, batch, step, dtype):
    """One step's loss and gradients with the kernels and with
    fused_kernels = 0 (twice) from the same state and the same draws:
    (loss difference, per-leaf gradient rel L2 pairs of kernels against
    plain, the worst pair of plain against itself)."""
    got = []
    for t in (kern, plain, plain):
        _load(t, snap, step)
        loss, _, _, grads = t.gradients(batch)
        got.append((float(loss.detach()), grads))
    (lk, gk), (lp, gp), (_, gp2) = got
    dl = abs(lk - lp) / (max(1.0, abs(lp)) if dtype == "bfloat16"
                         else abs(lp))
    return dl, _grad_rels(gk, gp), max(_grad_rels(gp2, gp))


def phase_convnet(name: str, seed: int, tmp: str):
    """Train one convnet cell through main.run (CONVNET_STEPS steps, bf16,
    SGD, the config's own dropout and activations), check the launches
    per step, hold each bf16 step and two float32 steps from the init
    against fused_kernels = 0 from the same state and draws, check
    insanity's step counters and load the written round. Returns (the
    run's trainer, its fused_kernels = 0 twin, batches, launches,
    notes)."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    conf, batch, image, per_step = CONVNETS[name]
    steps = CONVNET_STEPS
    model_dir = os.path.join(tmp, name)
    cfg = train_cfg(conf, seed, model_dir, (f"seed={seed}",), batch=batch,
                    steps=steps, image=image)
    box = {"losses": [], "before": [], "counts": []}

    def on_step(tr):
        box["counts"].append({k.name: k.launches for k in KERNELS.values()})
        box["losses"].append(tr.last_loss)
        if len(box["losses"]) < steps:
            box["before"].append(_snap(tr))

    def ready(tr):
        box["before"].append(_snap(tr))
        tr.step_hook = on_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS.values()}
    took = time.perf_counter() - box["t0"]
    peak = torch.cuda.max_memory_allocated()
    tr.step_hook = None
    if len(box["losses"]) != steps:
        raise AssertionError(f"{name}: {len(box['losses'])} steps")
    # launches of each step (the counts after it less those before it);
    # the evaluation after the last step launches forward kernels too
    want = dict(per_step)
    want["sgd_apply"] = len(tr.optimizer._groups(tr.params))
    before = {k: 0 for k in launches}
    for i, after in enumerate(box["counts"]):
        check_launches(f"{name} step {i + 1}",
                       {k: after[k] - before[k] for k in after}, want,
                       {"epilogue_fwd": 1, "epilogue_bwd": 1})
        before = after
    losses = box["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    counters = {l.name: int(tr.net.state[l.name]["step"])
                for l in tr.net.layers if l.spec.type == "insanity"}
    if any(v != steps for v in counters.values()):
        raise AssertionError(f"{name}: insanity step counters {counters}")

    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    batches = list(create_iterator(glob + data))
    quiet = [("silent", "1")]
    checks = {}
    for dt in ("bfloat16", "float32"):
        pol = quiet + [("compute_dtype", dt)]
        kern = Trainer(glob + pol)
        plain = Trainer(glob + pol + [("fused_kernels", "0")])
        snaps = box["before"][:steps] if dt == "bfloat16" else []
        if dt == "float32":               # two f32 steps from the init
            kern.init_model((box["before"][0][0], box["before"][0][2]))
            for b in batches[:2]:
                snaps.append(_snap(kern))
                kern.update(b)
        rows = []
        for i, b in enumerate(batches[:len(snaps)]):
            dl, rels, spread = convnet_step_check(kern, plain, snaps[i], b,
                                                  i, dt)
            rows.append((dl, float(np.median([r for r, _ in rels])),
                         max(rels), spread))
        checks[dt] = rows
        if dt == "bfloat16":
            plain_bf16 = plain
        else:
            del plain
        del kern
    torch.cuda.empty_cache()
    fails = [f"{dt} step {i + 1}: {row}" for dt, rows in checks.items()
             for i, row in enumerate(rows)
             if row[0] > CONVNET_LOSS_TOL[dt]
             or row[1] > CONVNET_GRAD_TOL[dt][0]
             or row[2][0] > CONVNET_GRAD_TOL[dt][1]]
    if fails:
        raise AssertionError(f"{name}: kernels vs fused_kernels=0 from the "
                             f"same state (tol loss {CONVNET_LOSS_TOL}, "
                             f"gradient {CONVNET_GRAD_TOL}): {fails}")

    # the written round loads in the port and answers finitely
    path = ckpt.model_path(model_dir, 0)
    blob = ckpt.load_for_inference(path)
    net = Network(tr.graph, [kv for kv in glob if kv[0] != "task"])
    ckpt.check_structure(blob["meta"], tr.graph.structure_signature())
    net.load_weights(*params_from_jax(blob["params"], blob["state"]))
    x = torch.from_numpy(batches[0].data[:8]).to(net.device)
    prob = net(x).out.float().reshape(8, -1)
    if not bool(torch.isfinite(prob).all()) or \
            (prob.sum(1) - 1).abs().max().item() > 1e-3:
        raise AssertionError(f"{name}: the written round's answers are not "
                             "finite softmax rows")
    del net
    n_params = sum(v.numel() for v in _paths(tr.params).values())
    fmt = lambda rows: [(f"{dl:.2g}", f"{md:.2g}", f"{w[0]:.2g} {w[1]}",
                         f"{sp[0]:.2g} {sp[1]}") for dl, md, w, sp in rows]
    print(f"{name}: {steps} steps (batch {batch}, {image}, bf16, SGD, "
          f"{n_params} parameters) through main.run in {took:.1f}s with "
          f"the evaluation and the round written | losses "
          f"{[round(v, 4) for v in losses]} | launches per step "
          f"{want} (each step checked), the run with its evaluation "
          f"{ {k: v for k, v in launches.items() if v} }"
          f" | insanity step counters {counters or 'none'} | vs "
          f"fused_kernels=0 from the same state and draws, per step (loss "
          f"diff, gradient rel L2 median, worst leaf; the plain step "
          f"against itself, worst leaf): bf16 "
          f"{fmt(checks['bfloat16'])}, f32 {fmt(checks['float32'])} (tol "
          f"loss {CONVNET_LOSS_TOL}, gradient (median, worst) "
          f"{CONVNET_GRAD_TOL}) | round "
          f"{os.path.basename(path)} loads, finite softmax rows | peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    return tr, plain_bf16, batches, launches, {
        "losses": losses, "checks": checks, "params": n_params,
        "insanity_steps": counters, "peak_gib": peak / 2**30,
        "seconds": took}


def phase_convnet_times(name, tr, plain, batches, gen) -> dict:
    """CUDA-event times of one train step of the cell with the kernels
    and with fused_kernels = 0 from the same state, a profile of the step,
    and, for the kernels the cell adds, each kernel at the path's shape
    beside its bound, its plain version and one PyTorch library call."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.fused_lrn import (fused_lrn_bwd, fused_lrn_fwd,
                                                lrn_bwd_plain, lrn_plain)
    from cxxnet_tpu_torch.ops.fused_pool import (fused_pool_bwd_max,
                                                 pool_bwd_max_plain)
    b0 = batches[0]
    snap = _snap(tr)
    _load(plain, snap, tr.epoch_counter)
    step_ms = time_forward(lambda: tr.update(b0), reps=5)
    step_plain = time_forward(lambda: plain.update(b0), reps=5)
    prof, kinds = profile_kinds(lambda: tr.update(b0), 3, "step")
    print(f"profile: {name} train step, kernels: {prof}", flush=True)
    ms, k = kinds.get("epilogue kernel", (0.0, 0))
    print(f"profile: {name} epilogue kernel: {k:g} launches a step, "
          f"{ms:.4f} ms a step in all (the step's profile by kind; the "
          f"forward of each biased conv and fullc)", flush=True)
    if name == "alexnet":
        ms, k = kinds.get("epilogue bwd kernel", (0.0, 0))
        print(f"profile: alexnet epilogue backward: {k:g} launches a step, "
              f"{ms:.4f} ms a step in all (the step's profile by kind; "
              f"8 epilogues with a bias, 7 with relu)", flush=True)
        ms, k = kinds.get("lrn kernel", (0.0, 0))
        print(f"profile: alexnet lrn: {k:g} launches a step, {ms:.4f} ms a "
              f"step in all (the step's profile by kind; lrn_fwd and lrn_bwd "
              f"at lrn1 and lrn2)", flush=True)
    rows = {f"epilogue_fwd ({k})": epilogue_fwd_row(gen, *v)
            for k, v in EPI_FWD.items() if k.startswith(name)}
    if name == "alexnet":
        n, alpha, beta, knorm = LRN_ALEX
        for layer, shape in LRN_LAYERS:
            x, dy = lrn_inputs(gen, shape)
            xn = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
            yn = F.local_response_norm(xn, n, alpha, beta, knorm)
            dyn = dy.permute(0, 3, 1, 2)
            el = x.numel()
            for kname, r in (
                    ("lrn_fwd", dict(
                        ms=time_call(lambda: fused_lrn_fwd(x, n, alpha, beta,
                                                           knorm)),
                        plain_ms=time_call(lambda: lrn_plain(
                            x, n, alpha, beta, knorm)),
                        library_ms=time_call(lambda: F.local_response_norm(
                            xn.detach(), n, alpha, beta, knorm)),
                        bound=bound_ms(2 * el * 2, (n + 8) * el),
                        library="F.local_response_norm forward")),
                    ("lrn_bwd", dict(
                        ms=time_call(lambda: fused_lrn_bwd(x, dy, n, alpha,
                                                           beta, knorm)),
                        plain_ms=time_call(lambda: lrn_bwd_plain(
                            x, dy, n, alpha, beta, knorm)),
                        library_ms=time_loop(lambda: torch.autograd.grad(
                            yn, [xn], dyn, retain_graph=True)),
                        bound=bound_ms(3 * el * 2, (2 * n + 16) * el),
                        library="F.local_response_norm backward "
                                "(autograd)"))):
                r["shape"] = f"{layer} {shape} bf16 nsize {n}"
                rows[kname if layer == "lrn1" else f"{kname} ({layer})"] = r
    if name == "spp":
        shape, k = SPP1
        x, y, dy, nbytes = max_pool_inputs(gen)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        _, idx = F.max_pool2d(xn, k, k, return_indices=True)
        rows["pool_bwd_max"] = dict(
            ms=time_call(lambda: fused_pool_bwd_max(x, y, dy, k, k, False)),
            plain_ms=time_call(lambda: pool_bwd_max_plain(x, y, dy, k, k,
                                                          False)),
            library_ms=time_call(
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    dyn, xn, [k, k], [k, k], [0, 0], [1, 1], False, idx)),
            bound=bound_ms(nbytes, x.numel()),
            shape=f"spp1 3x3/3, x {shape} bf16",
            library="aten.max_pool2d_with_indices_backward (indices "
                    "from the forward)")
    line = lambda k, r: (f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us "
                         f"({_rate(r)}), bound "
                         f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), "
                         f"plain {r['plain_ms'] * 1e3:.2f} us, "
                         f"{r['library']} {r['library_ms'] * 1e3:.2f} us"
                         + (f" (PERF.md before: {PERF_BEFORE_MS[k]})"
                            if k in PERF_BEFORE_MS else ""))
    print(f"times ({name}): train step {step_ms:.3f} ms, fused_kernels=0 "
          f"{step_plain:.3f} ms (one batch from the host, CUDA events, "
          f"median of 5) | " + " | ".join(line(k, r) for k, r in
                                          rows.items()), flush=True)
    return {"step_ms": step_ms, "step_plain_ms": step_plain,
            "kernels": rows, "profile": prof}


def _write_idx(path: str, arr: np.ndarray) -> None:
    """An idx-ubyte file, gzipped (the MNIST layout)."""
    import gzip
    import struct
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    head = struct.pack(">i", 2048 + arr.ndim) + b"".join(
        struct.pack(">i", d) for d in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.tobytes())


def phase_digits(seed: int, tmp: str) -> dict:
    """The digits LeNet (``examples/digits/digits_lenet.conf``) trained
    for one round through main.run on the card from idx files written
    here from ``seed`` (1500 training images of 8x8, 300 to evaluate), its
    paths pointed at them; the max-pool backward kernel must run."""
    from cxxnet_tpu_torch.config import parse_config_file
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    rs = np.random.RandomState(seed)
    files = {}
    for split, n in (("train", 1500), ("t10k", 300)):
        for what, arr in (("images-idx3", rs.randint(0, 256, (n, 8, 8))),
                          ("labels-idx1", rs.randint(0, 10, (n,)))):
            p = os.path.join(tmp, f"{split}-{what}-ubyte.gz")
            _write_idx(p, arr)
            files[os.path.basename(p)] = p
    cfg = [(k, files[os.path.basename(v)] if k in ("path_img", "path_label")
            else v) for k, v in parse_config_file(DIGITS)]
    cfg += [("dev", "gpu"), ("num_round", "1"), ("print_step", "5"),
            ("seed", str(seed))]
    box = {}

    def ready(tr):
        reset_launches()
        box["t0"] = time.perf_counter()

    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    took = time.perf_counter() - box["t0"]
    launches = {k.name: k.launches for k in KERNELS.values()}
    steps = tr.step_count
    if steps != 15 or not np.isfinite(tr.last_loss):
        raise AssertionError(f"digits LeNet: {steps} steps, loss "
                             f"{tr.last_loss}")
    check_launches("digits LeNet", launches, {"pool_bwd_max": steps},
                   {"pool_fwd": steps, "sgd_apply": steps})
    launches = {k: v for k, v in launches.items() if v}
    print(f"digits: LeNet trained one round of {steps} steps from idx "
          f"files through main.run in {took:.1f}s | loss "
          f"{tr.last_loss:.4f} | launches {launches}", flush=True)
    return {"steps": steps, "launches": launches, "seconds": took}


# -- phase 10 -----------------------------------------------------------------

#: q_mm cases of phase 10 at the int8 serve paths' shapes (and odd ones):
#: name -> (M, K, N per group, groups, all codes at +-127, K padded to a
#: multiple of 16 with zero columns as the int8 conv pads it). The
#: "lm_head" cases are the int8 long-context LM's head (seqfc, K 128,
#: N 64) in a decode step of 8 rows and a prefill chunk of 128
Q_MM_CASES = {
    "fc1 b1": (1, 1024, 1000, 1, False, False),
    "fc1 b8": (8, 1024, 1000, 1, False, False),
    "fc1 b32": (32, 1024, 1000, 1, False, False),
    "conv1 b32": (BUCKETS[-1] * 112 * 112, 147, 64, 1, False, True),
    "3a 3x3 b32": (BUCKETS[-1] * 28 * 28, 576, 64, 1, False, True),
    "5b 3x3 b1": (49, 1728, 384, 1, False, True),
    "alex conv1 b32": (BUCKETS[-1] * 55 * 55, 363, 96, 1, False, True),
    "alex conv2 b32": (BUCKETS[-1] * 27 * 27, 1200, 128, 2, False, True),
    "fc6 b1": (1, 9216, 4096, 1, False, False),
    "fc6 b32": (32, 9216, 4096, 1, False, False),
    "fc7 b32": (32, 4096, 4096, 1, False, False),
    "lm_head decode": (8, 128, 64, 1, False, False),
    "lm_head prefill": (128, 128, 64, 1, False, False),
    "K 4112 split": (8, 4112, 512, 1, False, False),
    "odd": (7, 13, 5, 1, False, False),
    "K4096 +-127": (5, 4096, 3, 1, True, False),
}
#: the cases that are not shapes of a path (every other case must take
#: the pipelined variant)
Q_MM_OFF_PATH = ("odd", "K4096 +-127", "K 4112 split")
#: the case whose numbers stand in the kernels JSON line: the largest
#: product of the served Inception-BN forward at bucket 32
Q_MM_PATH = "conv1 b32"
#: launches of q_mm per int8 forward: Inception-BN's 69 convs and fc1;
#: AlexNet's 5 convs (the grouped ones one launch each) and fc6-fc8
Q_MM_PER_FORWARD = {"inception_bn": 70, "alexnet": 8}
#: int8 engine with the kernels against fused_kernels = 0 on the same
#: round and rows: the largest probability difference. Read 0 for both
#: nets (PERF.md section 2): q_mm is bit-equal to its plain version.
#: The global pool kernel may sum in another order than the plain pool,
#: which can move one of fc1's input codes by a step: a logit by about
#: act_scale/127 * |w| (2e-3 at random weights), a probability by less
#: than 5e-4; the bound is twice that
INT8_ROW_ATOL = 1e-3
#: int8 against float32, rel L2 of the served softmax rows, on the round
#: quantized over rows drawn as the served ones: the bound sits between
#: the sound reading (0.1119 on the H100; 0.109 at full width on the
#: CPU, in both packages) and the control's, the same round quantized
#: over the synthetic iterator's cluster rows (11.21), which must read
#: over it (PERF.md section 6)
INT8_VS_FP = 0.5


def _codes(shape, gen, extreme):
    dev = gen.device
    if extreme:
        return torch.where(torch.rand(shape, generator=gen, device=dev) < 0.9,
                           127, -127).to(torch.int8)
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def q_mm_case(gen, name):
    """Operands of one Q_MM_CASES case on the card: (xq, wt, factor,
    bias, groups), K padded with zero columns in both operands to a
    multiple of 16 where the case is padded."""
    from cxxnet_tpu_torch.ops.fused_quant import padded_k
    m, k, n, g, extreme, pad = Q_MM_CASES[name]
    dev = gen.device
    kp = padded_k(k) if pad else k
    xq = _codes((m, g, kp), gen, extreme)
    wt = _codes((g * n, kp), gen, extreme)
    xq[..., k:] = 0
    wt[:, k:] = 0
    f = torch.rand((g * n,), generator=gen, device=dev) * 1e-3
    b = torch.randn((g * n,), generator=gen, device=dev)
    return xq.view(m, g * kp), wt, f, b, g


def check_q_mm_variants(what: str) -> dict:
    """The q_mm variants launched since the last reset; raises unless
    every one is the pipelined (16-byte copy ring) variant."""
    from cxxnet_tpu_torch.ops.fused_quant import Q_MM_VARIANTS
    got = dict(Q_MM_VARIANTS)
    if not got or any(not v.startswith("pipelined") for v in got):
        raise AssertionError(f"{what}: q_mm launches off the pipelined "
                             f"variant: {got}")
    return got


def phase_int8_kernels(gen: torch.Generator) -> dict:
    """q_mm against q_mm_plain at every Q_MM_CASES shape, with bias and
    relu and without: bit-equal (an exact int32 sum on both sides, then
    the same two f32 roundings). Returns the largest error at the path's
    shape."""
    from cxxnet_tpu_torch.ops.fused_quant import (Q_MM_VARIANTS, q_mm,
                                                  q_mm_plain,
                                                  reset_q_mm_variants)
    lines, worst = [], {}
    for name in Q_MM_CASES:
        xq, wt, f, b, g = q_mm_case(gen, name)
        errs = []
        reset_q_mm_variants()
        for bias, act in ((b, "relu"), (None, "none")):
            got = q_mm(xq, wt, f, bias, act, g)
            want = q_mm_plain(xq, wt, f, bias, act, g)
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
        worst[name] = max(errs)
        variant = (dict(Q_MM_VARIANTS) if name in Q_MM_OFF_PATH
                   else check_q_mm_variants(f"q_mm case {name}"))
        lines.append(f"{name} {tuple(xq.shape)}x{tuple(wt.shape)} G {g}: "
                     f"max_abs_err {worst[name]:.3g} {variant}")
        if worst[name] != 0.0:
            raise AssertionError("q_mm disagrees with q_mm_plain (tol 0): "
                                 + lines[-1])
        del xq, wt, got, want
    torch.cuda.empty_cache()
    print(f"kernels (int8): q_mm bit-equal to q_mm_plain in "
          f"{2 * len(lines)} cases (bias+relu, none) | " + " | ".join(lines),
          flush=True)
    return {"q_mm": worst[Q_MM_PATH]}


def write_conf(path: str, pairs) -> str:
    """``pairs`` as a config file of the key=value dialect."""
    def q(v):
        if v and not any(ch in v for ch in " \t\r\n#='\"\\"):
            return v
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    with open(path, "w") as f:
        f.writelines(f"{k} = {q(v)}\n" for k, v in pairs)
    return path


def quantize_round(conf: str, model: str, seed: int, tmp: str, tag: str,
                   image: str, batch: int = BUCKETS[-1]) -> tuple:
    """The round ``model`` quantized by ``python -m cxxnet_tpu_torch.quant``'s
    ``main()`` over 2 synthetic batches of ``batch`` from ``seed`` (cluster
    rows, another distribution than the served one: phase 10's control);
    returns (path, exit code, the drift verdict line)."""
    import contextlib
    import io
    from cxxnet_tpu_torch.quant.__main__ import main as quant_main
    cfg_path = write_conf(os.path.join(tmp, f"{tag}-calib.conf"), train_cfg(
        conf, seed + 3, tmp, batch=batch, steps=2, image=image))
    out = os.path.join(tmp, f"{tag}-int8.model")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = quant_main([cfg_path, model, out, "quant_calib_batches=2"])
    lines = buf.getvalue().strip().splitlines()
    if rc not in (0, 2) or not lines or "quant drift" not in lines[-1]:
        raise AssertionError(f"quantize {tag}: exit {rc}, output {lines[-3:]}")
    return out, rc, lines[-1]


def served_rows(seed: int, n: int, width: int) -> np.ndarray:
    """``n`` flat request rows of N(0, 1), NCHW order: how phase 4 and
    the fleet phase draw what they serve."""
    return np.random.RandomState(seed).randn(n, width).astype(np.float32)


def quantize_served(conf: str, model: str, seed: int, out: str,
                    batch: int = BUCKETS[-1], batches: int = 2) -> tuple:
    """The round ``model`` quantized by the port's PTQ
    (``quant.quantize_blob``) over ``batches`` batches of ``batch`` rows
    drawn as the served rows are (N(0, 1), from ``seed + 3``), written to
    ``out``; returns (out, the drift verdict line). The round's BN
    statistics come from such rows too (``write_round``), so the act
    scales cover what is served."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import parse_quant_config
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.quant import (drift_verdict, quantize_blob,
                                        write_quantized_round)
    cfg = _serve_cfg(conf, [])
    graph = build_graph(cfg)
    net = Network(graph, cfg, device=torch.device("cuda"))
    c, y, x = graph.input_shape
    rows = served_rows(seed + 3, batch * batches, c * y * x)
    calib = [r.reshape(batch, c, y, x).transpose(0, 2, 3, 1).copy()
             for r in np.split(rows, batches)]
    qc = parse_quant_config([("quant_calib_batches", str(batches))])
    qblob, qm = quantize_blob(net, ckpt.load_for_inference(model), calib, qc)
    write_quantized_round(out, graph.structure_signature(), qblob, qm)
    del net
    return out, drift_verdict(qm, qc.max_rel_err, qc.max_sat_frac)["line"]


def _int8_vs_fp(got, want):
    """(rel L2 of the softmax rows, top-1 agreement, mean top
    probability of int8 and of fp32) of int8 vs fp32 rows."""
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return (rel, float(np.mean(got.argmax(1) == want.argmax(1))),
            float(got.max(1).mean()), float(want.max(1).mean()))


def phase_int8(conf: str, seed: int, tmp: str, bf16_forward) -> dict:
    """Inception-BN quantized and served int8 over HTTP through main.run,
    AlexNet int8 through the engine at bucket 32; launches, answers
    against fused_kernels = 0, and times."""
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.ops.fused_quant import reset_q_mm_variants
    from cxxnet_tpu_torch.serve import InferenceEngine
    notes, t0 = {}, time.perf_counter()
    dev = torch.device("cuda")
    reset_q_mm_variants()
    model = write_round(conf, seed, tmp, dev)
    qpath, drift = quantize_served(conf, model, seed,
                                   os.path.join(tmp, "ibn-int8.model"))
    cpath, rc, cdrift = quantize_round(conf, model, seed, tmp, "control",
                                       TRAIN_IMAGE)
    print(f"int8: Inception-BN round quantized over served rows: {drift} | "
          f"the control, over synthetic cluster rows by "
          f"cxxnet_tpu_torch.quant (exit {rc}): {cdrift}", flush=True)
    engine, launches, answers, statz = phase_serve(
        conf, seed, qpath, extra=("serve_dtype=int8",))
    forwards = launches["pool_fwd"]
    per = Q_MM_PER_FORWARD["inception_bn"]
    if not engine.serve_int8 or forwards < 6 \
            or launches["q_mm"] != per * forwards:
        raise AssertionError(f"int8 serve: q_mm {launches['q_mm']} launches "
                             f"for {forwards} forwards, want {per} each")
    if statz["version"] != "r0001-int8":
        raise AssertionError(f"int8 serve version {statz['version']}")
    variants = check_q_mm_variants("int8 serve, Inception-BN")
    serve_cfg = dict(buckets=",".join(map(str, BUCKETS)),
                     max_batch=BUCKETS[-1])
    plain = InferenceEngine.from_checkpoint(
        _serve_cfg(conf, ["fused_kernels=0"]), qpath, dtype="int8",
        **serve_cfg)
    worst = check_answers(plain, answers, INT8_ROW_ATOL)
    del plain
    fp = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), model,
                                         dtype="float32", **serve_cfg)
    got = np.concatenate([a for _, raw, a in answers if raw])
    raw_rows = np.concatenate([r for r, raw, _ in answers if raw])
    want = fp.predict_raw(raw_rows)
    del fp
    rel, top1, pmax, pmax_fp = _int8_vs_fp(got, want)
    ctl = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), cpath,
                                          dtype="int8", **serve_cfg)
    crel, ctop1, cpmax, _ = _int8_vs_fp(ctl.predict_raw(raw_rows), want)
    del ctl
    if not rel <= INT8_VS_FP < crel:
        raise AssertionError(
            f"int8 vs fp32: rel L2 {rel:.4g} (served-row calibration) and "
            f"{crel:.4g} (control) do not straddle {INT8_VS_FP}")
    notes["inception_bn"] = {"launches_q_mm": launches["q_mm"],
                             "q_mm_variants": variants,
                             "forwards": forwards, "vs_plain": worst,
                             "int8_vs_fp32_rel_l2": rel, "top1_agree": top1,
                             "top_prob": (pmax, pmax_fp), "drift": drift,
                             "control_rel_l2": crel, "control_top1": ctop1,
                             "control_drift": cdrift}
    print(f"int8: Inception-BN served over HTTP by main.run "
          f"(serve_dtype=int8, version {statz['version']}) | q_mm "
          f"{launches['q_mm']} launches in {forwards} forwards ({per} each) "
          f"| variants {variants} | vs fused_kernels=0: max prob diff "
          f"{worst:.3g} (atol "
          f"{INT8_ROW_ATOL}) | int8 vs fp32 over {len(raw_rows)} served "
          f"rows: rel L2 {rel:.4g} (bound {INT8_VS_FP}), top-1 agree "
          f"{top1:.3f}, mean top prob {pmax:.3g} vs {pmax_fp:.3g}; the "
          f"control reads rel L2 {crel:.4g}, top-1 agree {ctop1:.3f}, mean "
          f"top prob {cpmax:.3g}", flush=True)
    net = engine.net
    c, y, x = net.graph.input_shape
    f32 = torch.float32
    fwd = {}
    for b in BUCKETS:
        data = torch.randn((b, y, x, c), generator=torch.Generator(
            device=dev).manual_seed(seed + b), device=dev)
        fwd[b] = (time_forward(lambda: net(data, compute_dtype=f32)),
                  time_forward(lambda: net(data, compute_dtype=f32,
                                           fused=False)))
    print("times (int8): Inception-BN engine forward " + " | ".join(
        f"bucket {b}: int8 {ms:.3f} ms ({b / ms * 1e3:.1f} img/s), "
        f"fused_kernels=0 {mp:.3f} ms, bf16 (phase 5) "
        f"{bf16_forward[b][0]:.3f} ms" for b, (ms, mp) in fwd.items()),
        flush=True)
    prof = profile_calls(lambda: net(data, compute_dtype=f32))
    print(f"profile: int8 bucket {BUCKETS[-1]}: {prof}", flush=True)
    notes["inception_bn"].update(forward_ms={str(b): v[0]
                                             for b, v in fwd.items()},
                                 forward_plain_ms={str(b): v[1]
                                                   for b, v in fwd.items()},
                                 profile=prof)
    del engine, net, data
    torch.cuda.empty_cache()
    # AlexNet int8 at bucket 32, through the engine
    adir = os.path.join(tmp, "alexnet")
    os.makedirs(adir, exist_ok=True)
    amodel = write_round(ALEXNET, seed, adir, dev)
    b = BUCKETS[-1]
    aq, adrift = quantize_served(ALEXNET, amodel, seed,
                                 os.path.join(tmp, "alexnet-int8.model"))
    kw = dict(buckets=str(b), max_batch=b)
    eng = InferenceEngine.from_checkpoint(_serve_cfg(ALEXNET, []), aq,
                                          dtype="int8", **kw)
    rows = served_rows(seed + 5, b, 3 * 227 * 227)
    reset_launches()
    reset_q_mm_variants()
    got = eng.predict_raw(rows)
    torch.cuda.synchronize()
    alaunch = {k.name: k.launches for k in KERNELS.values() if k.launches}
    if alaunch.get("q_mm") != Q_MM_PER_FORWARD["alexnet"]:
        raise AssertionError(f"AlexNet int8: launches {alaunch}")
    avariants = check_q_mm_variants("int8 forward, AlexNet")
    plain = InferenceEngine.from_checkpoint(
        _serve_cfg(ALEXNET, ["fused_kernels=0"]), aq, dtype="int8", **kw)
    aworst = check_answers(plain, [(rows, 1, got)], INT8_ROW_ATOL)
    del plain
    fp = InferenceEngine.from_checkpoint(_serve_cfg(ALEXNET, []), amodel,
                                         dtype="float32", **kw)
    arel, atop1, apmax, apmax_fp = _int8_vs_fp(got, fp.predict_raw(rows))
    del fp
    data = torch.from_numpy(eng._to_input(rows)).to(dev)
    ams = time_forward(lambda: eng.net(data, compute_dtype=f32))
    ams_plain = time_forward(lambda: eng.net(data, compute_dtype=f32,
                                             fused=False))
    notes["alexnet"] = {"launches": alaunch, "q_mm_variants": avariants,
                        "vs_plain": aworst,
                        "int8_vs_fp32_rel_l2": arel, "top1_agree": atop1,
                        "top_prob": (apmax, apmax_fp), "drift": adrift, "forward_ms": ams,
                        "forward_plain_ms": ams_plain}
    print(f"int8: AlexNet quantized over served rows ({adrift}) and run "
          f"through "
          f"the int8 engine at bucket {b} | launches {alaunch} | variants "
          f"{avariants} | vs "
          f"fused_kernels=0: max prob diff {aworst:.3g} | int8 vs fp32 (not "
          f"gated): rel L2 {arel:.3g}, top-1 agree {atop1:.3f}, mean top "
          f"prob {apmax:.3g} vs {apmax_fp:.3g} | forward "
          f"{ams:.3f} ms, fused_kernels=0 {ams_plain:.3f} ms", flush=True)
    del eng
    torch.cuda.empty_cache()
    notes["seconds"] = time.perf_counter() - t0
    return notes


#: operand bytes a cold timing rotates through: three times the L2
COLD_BYTES = 150_000_000


def time_cold(fn_of, copies: int) -> float:
    """time_call of ``fn_of(i)`` with i rotating through ``copies``
    operand copies, so that each call finds its operand out of L2 (as a
    served forward finds fc6's weight: the other layers come between)."""
    i = [0]

    def call():
        i[0] += 1
        return fn_of(i[0] % copies)
    return time_call(call)


def phase_int8_times(gen: torch.Generator) -> dict:
    """q_mm at each path shape (bias, relu for the convs and fc6/fc7)
    beside its bound (at the unpadded K), q_mm_plain and torch._int_mm
    (cuBLASLt) with the same epilogue in PyTorch, where its shape rules
    hold (M > 16, N a multiple of 8, one group; K padded to a multiple
    of 8 outside the timed call). The fc cases also cold: over a
    rotation of weight copies past the 50 MB L2, the kernel and the
    library alike."""
    from cxxnet_tpu_torch.ops.fused_quant import q_mm, q_mm_plain
    rows = {}
    for name in Q_MM_CASES:
        if name in Q_MM_OFF_PATH:
            continue
        m, k, n, g, _, _ = Q_MM_CASES[name]
        xq, wt, f, b, g = q_mm_case(gen, name)
        act = "none" if name.startswith(("fc1", "lm_head")) else "relu"
        copies = max(2, -(-COLD_BYTES // wt.numel())) \
            if name.startswith("fc") else 0
        wts = [wt] + [wt.clone() for _ in range(copies - 1)]
        r = dict(
            ms=time_call(lambda: q_mm(xq, wt, f, b, act, g)),
            ms_cold=time_cold(lambda i: q_mm(xq, wts[i], f, b, act, g),
                              copies) if copies else None,
            plain_ms=time_call(lambda: q_mm_plain(xq, wt, f, b, act, g)),
            library_ms=None, library_cold_ms=None,
            bound=bound_ms(m * g * k + g * n * k + m * g * n * 4 + 2 * g * n * 4,
                           2 * m * n * k * g, INT8_OPS),
            shape=f"{name} M {m} K {k} (rows of {wt.shape[1]}) N {n} G {g} "
                  f"{act}")
        if g == 1 and m > 16 and n % 8 == 0:
            k8 = -(-k // 8) * 8
            xl = xq[:, :k8].contiguous()
            wkn = [w[:, :k8].contiguous().t() for w in wts]

            def lib(i):
                y = torch._int_mm(xl, wkn[i]).float() * f + b
                return torch.relu(y) if act == "relu" else y
            r["library_ms"] = time_call(lambda: lib(0))
            if copies:
                r["library_cold_ms"] = time_cold(lib, copies)
            del wkn
        rows[name] = r
        del xq, wt, wts
        torch.cuda.empty_cache()
    us = lambda v: "n/a" if v is None else f"{v * 1e3:.2f} us"
    print("times (int8): " + " | ".join(
        f"q_mm {r['shape']}: {us(r['ms'])}"
        + (f" warm, {us(r['ms_cold'])} cold" if r["ms_cold"] else "")
        + f", bound {r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), plain "
        f"{us(r['plain_ms'])}, torch._int_mm + epilogue {us(r['library_ms'])}"
        + (f" warm, {us(r['library_cold_ms'])} cold"
           if r["library_cold_ms"] else "")
        + (f" (PERF.md before: {PERF_BEFORE_MS['q_mm ' + name]})"
           if "q_mm " + name in PERF_BEFORE_MS else "")
        for name, r in rows.items()), flush=True)
    return {"kernels": {"q_mm": rows[Q_MM_PATH]}, "all": rows}


# -- phase 11 -----------------------------------------------------------------

#: phase 11's ranks: two on card 0 over gloo (NCCL refuses two ranks on
#: one card); every kernel, activation and update stays on the card, the
#: collectives are staged through the host
DP_DEVICES = ("cuda:0",) * DP_RANKS
#: steps timed per rank in phase 11
DP_TIME_STEPS = 8
#: phase 11's bound on the BN running statistics' rel L2 after a float32
#: dp step against the single-device step: sound runs on the card read
#: up to 5.1e-5 (the order of the sums alone), the same step with
#: rank-local moments planted must read above it
DP_F32_STATE_TOL = 2e-4


def _dump(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)


def _undump(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _replica(tr) -> torch.Tensor:
    """A rank's masters, momenta and BN statistics, flat, as float32."""
    from cxxnet_tpu_torch.optim import leaves
    trees = [tr.params, tr.net.state] + [
        v for k, v in sorted(tr.opt_state.items()) if k != "t"]
    return torch.cat([v.detach().float().reshape(-1)
                      for t in trees for _, v in leaves(t)])


def _dp_ready(out_dir: str, tr) -> None:
    """Phase 11's hook in each rank of ``main.run``: rank 0 writes the
    state before the first step; after each step every rank reads its
    launch counts (set to 0 just before the first step and after each
    read), checks its replica bit-equal to rank 0's (a broadcast), and
    rank 0 writes the state after the step. After the last step each
    rank writes its record."""
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    rec = {"launches": [], "equal": [], "losses": []}
    if tr.dp.is_main:
        _dump(os.path.join(out_dir, "state_0.pkl"), _snap(tr))

    def on_step(t):
        torch.cuda.synchronize()
        rec["launches"].append({k.name: k.launches for k in KERNELS.values()})
        reset_launches()
        mine = _replica(t)
        rec["equal"].append(bool(torch.equal(
            mine, t.dp.broadcast(mine.clone(), 0))))
        rec["losses"].append(t.last_loss)
        step = len(rec["losses"])
        if t.dp.is_main:
            _dump(os.path.join(out_dir, f"state_{step}.pkl"), _snap(t))
        if step == TRAIN_STEPS:
            t.step_hook = None
            with open(os.path.join(out_dir, f"rank{t.dp.rank}.json"),
                      "w") as f:
                json.dump(rec, f)

    tr.step_hook = on_step
    torch.cuda.synchronize()
    reset_launches()                      # just before the first step


class _RankLocal:
    """The fault planted in phase 11's float32 check: a batch_norm that
    sees its own rank alone (rank-local moments, no all-reduce)."""
    world = 1

    @staticmethod
    def all_reduce(t):
        return t


def _dp_f32_and_time(dp, glob, data, out_dir):
    """Phase 11's second launch, in each rank: two float32 dp steps from
    the bf16 run's initial state (rank 0 writes the state after each),
    the first step again with rank-local BN moments planted (rank 0
    writes the state after it), then the bf16 dp step timed (host clock around DP_TIME_STEPS steps
    ending in a synchronize, the host time inside the collectives beside
    it) and profiled."""
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.trainer import Trainer
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = list(create_iterator(glob + data))
    init = _undump(os.path.join(out_dir, "state_0.pkl"))
    quiet = [("silent", "1")]
    t32 = Trainer(glob + quiet + [("compute_dtype", "float32")], dp=dp)
    _load(t32, init, 0)
    out = {"losses32": [], "equal32": []}
    for i, b in enumerate(batches[:2]):
        t32.update(b)
        out["losses32"].append(t32.last_loss)
        mine = _replica(t32)
        out["equal32"].append(bool(torch.equal(
            mine, dp.broadcast(mine.clone(), 0))))
        if dp.is_main:
            _dump(os.path.join(out_dir, f"f32_{i + 1}.pkl"), _snap(t32))
    from cxxnet_tpu_torch.layers import norm
    sound = norm.sync_bn_act
    norm.sync_bn_act = lambda x, g, b, eps, act, _dp, fused: sound(
        x, g, b, eps, act, _RankLocal(), fused)
    try:
        _load(t32, init, 0)
        t32.update(batches[0])
    finally:
        norm.sync_bn_act = sound
    if dp.is_main:
        _dump(os.path.join(out_dir, "f32_fault.pkl"), _snap(t32))
    del t32
    torch.cuda.empty_cache()
    tr = Trainer(glob + quiet, dp=dp)
    _load(tr, init, 0)
    b0 = batches[0]
    for _ in range(2):
        tr.update(b0)
    torch.cuda.synchronize()
    c0, n0 = dp.comm_seconds, dp.collectives
    t0 = time.perf_counter()
    for _ in range(DP_TIME_STEPS):
        tr.update(b0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / DP_TIME_STEPS
    out.update(step_ms=step_ms,
               comm_ms=(dp.comm_seconds - c0) * 1e3 / DP_TIME_STEPS,
               collectives=(dp.collectives - n0) / DP_TIME_STEPS,
               profile=profile_calls(lambda: tr.update(b0), 3, "step"))
    return out


def check_dp_records(recs) -> None:
    """The ranks' records of phase 11's run: TRAIN_STEPS steps each, the
    replicas bit-equal after every step, one global loss, and the launch
    counts per step of each rank (69 of each sync-BN kernel, none of the
    single-device BN kernels, 2 SGD applies, the pool and epilogue
    kernels at least once)."""
    n_bn = 69
    want = {k: n_bn for k in DP_KERNELS}
    want.update(bn_fwd=0, bn_bwd=0, sgd_apply=2)
    bad = []
    for r, rec in enumerate(recs):
        if len(rec["launches"]) != TRAIN_STEPS or not all(rec["equal"]) \
                or rec["losses"] != recs[0]["losses"]:
            bad.append(f"rank {r}: {len(rec['launches'])} steps, replicas "
                       f"equal {rec['equal']}, losses {rec['losses']}")
        for i, c in enumerate(rec["launches"]):
            bad += [f"rank {r} step {i + 1}: {k} {c[k]} (want {v})"
                    for k, v in want.items() if c[k] != v]
            bad += [f"rank {r} step {i + 1}: {k} {c[k]} (want >= 1)"
                    for k in TRAIN_KERNELS if k not in want and c[k] < 1]
    if bad:
        raise AssertionError("dp run: " + "; ".join(bad))


def phase_dp(conf: str, seed: int, tmp: str) -> dict:
    """Full-width Inception-BN trained data-parallel through ``main.run``
    (what ``python -m cxxnet_tpu_torch.main <conf> dev=gpu:0-1`` calls)
    on two ranks of card 0 over gloo, global batch TRAIN_BATCH; checks
    and returns what the module docstring's phase 11 lists."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.parallel import launch
    from cxxnet_tpu_torch.serve import InferenceEngine
    from cxxnet_tpu_torch.trainer import Trainer
    model_dir, out_dir = os.path.join(tmp, "dp"), os.path.join(tmp, "dps")
    os.makedirs(out_dir)
    # the single-device float32 steps below in full float32, as the
    # ranks' (main.run and _dp_f32_and_time turn TF32 off there)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_cfg(conf, seed, model_dir)
    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    t0 = time.perf_counter()
    run(cfg, ready=functools.partial(_dp_ready, out_dir),
        devices=DP_DEVICES, backend="gloo")
    took = time.perf_counter() - t0
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(DP_RANKS)]
    check_dp_records(recs)
    launches = {k: sum(c[k] for c in recs[0]["launches"])
                for k in recs[0]["launches"][0]}
    losses = recs[0]["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite dp loss: {losses}")

    # each bf16 dp step against the single-device step on the same global
    # batch from the same state, phase 6's bounds; f32 as the yardstick
    batches = list(create_iterator(glob + data))
    quiet = [("silent", "1")]
    sd16 = Trainer(glob + quiet)
    sd32 = Trainer(glob + quiet + [("compute_dtype", "float32")])
    worst = {"loss": 0.0, "state": 0.0, "kp": [], "pf": [], "ratio": []}
    for i, b in enumerate(batches):
        before = _undump(os.path.join(out_dir, f"state_{i}.pkl"))
        after = _undump(os.path.join(out_dir, f"state_{i + 1}.pkl"))
        got = []
        for t in (sd16, sd32):
            _load(t, before, i)
            t.update(b)
            got.append((t.last_loss, _snap(t)))
        (l16, s16), (_, s32) = got
        mom = {m for _, m in sd16.optimizer.schedules(i).values()}.pop()
        worst["loss"] = max(worst["loss"],
                            abs(losses[i] - l16) / max(1.0, abs(l16)))
        kp, st = _step_rels(after, s16, before)
        pf, _ = _step_rels(s16, s32, before)
        ratio = _grad_ratios(after, s16, before, mom)
        worst["state"] = max(worst["state"], st)
        worst["kp"].append((float(np.median([r for r, _ in kp])), max(kp)))
        worst["pf"].append((float(np.median([r for r, _ in pf])), max(pf)))
        worst["ratio"].append((min(ratio), max(ratio)))
    del sd16
    bad = [i + 1 for i, (mk, mf) in enumerate(zip(worst["kp"], worst["pf"]))
           if i > 0 and mk[0] > 1.5 * mf[0]]
    bad += [f"ratio at step {i + 1}" for i, (lo, hi) in
            enumerate(worst["ratio"]) if lo[0] < 0.5 or hi[0] > 2]
    print(f"dp train: {TRAIN_STEPS} steps of full-width Inception-BN "
          f"through main.run on {DP_RANKS} ranks of card 0 over gloo "
          f"(global batch {TRAIN_BATCH}, {DP_BATCH} a rank, bf16, SGD) in "
          f"{took:.1f}s with the spawn, the evaluation and the round "
          f"written | losses {[round(v, 4) for v in losses]} | launches "
          f"per rank per step "
          f"{ {k: v for k, v in recs[0]['launches'][0].items() if v} } | "
          f"replicas bit-equal after every step | vs the single-device step "
          f"from the same state: loss {worst['loss']:.3g} of max(1,|loss|) "
          f"(tol 2e-2), BN statistics {worst['state']:.3g} (tol 2e-2), "
          f"update rel L2 median / worst leaf, dp vs single bf16 "
          f"{[(round(m, 4), round(w[0], 4)) for m, w in worst['kp']]} "
          f"against single bf16 vs single f32 "
          f"{[(round(m, 4), round(w[0], 4)) for m, w in worst['pf']]} "
          f"(tol: median at most 1.5x at steps 2-{TRAIN_STEPS}); "
          f"gradient-part norm ratio min-max per step "
          f"{[(round(lo[0], 3), round(hi[0], 3)) for lo, hi in worst['ratio']]}"
          f" (tol [0.5, 2])", flush=True)
    if worst["loss"] > 2e-2 or worst["state"] > 2e-2 or bad:
        raise AssertionError(f"dp vs single-device steps {bad}: {worst}")

    # two float32 dp steps (second launch, which also times the bf16
    # step), each against the single-device f32 step from the same state;
    # the single-device kernels against fused_kernels = 0 from that state
    # is the yardstick of a change of summation order alone
    t1 = time.perf_counter()
    res = launch(_dp_f32_and_time, (glob, data, out_dir), devices=DP_DEVICES,
                 backend="gloo")
    took_f32 = time.perf_counter() - t1
    if res[0]["losses32"] != res[1]["losses32"] or not all(
            res[0]["equal32"] + res[1]["equal32"]):
        raise AssertionError(f"f32 dp ranks differ: {res}")
    pl32 = Trainer(glob + quiet + [("compute_dtype", "float32"),
                                   ("fused_kernels", "0")])
    f32 = []
    init = _undump(os.path.join(out_dir, "state_0.pkl"))
    for i, b in enumerate(batches[:2]):
        before = init if i == 0 else \
            _undump(os.path.join(out_dir, f"f32_{i}.pkl"))
        after = _undump(os.path.join(out_dir, f"f32_{i + 1}.pkl"))
        for t in (sd32, pl32):
            _load(t, before, i)
            t.update(b)
        single = _snap(sd32)
        if i == 0:
            _, fault = _step_rels(
                _undump(os.path.join(out_dir, "f32_fault.pkl")), single,
                before)
        rels, st = _step_rels(after, single, before)
        _, yard = _step_rels(single, _snap(pl32), before)
        f32.append((abs(res[0]["losses32"][i] / sd32.last_loss - 1),
                    float(np.median([r for r, _ in rels])), max(rels), st,
                    yard))
    del sd32, pl32
    torch.cuda.empty_cache()
    print(f"dp train f32 (second launch, {took_f32:.1f}s), per step from "
          f"the same state, dp vs single device: " + " | ".join(
              f"step {i + 1}: loss rtol {dl:.3g}, update rel L2 median "
              f"{md:.3g}, worst {w[0]:.3g} at {w[1]}, BN statistics "
              f"{st:.3g} (single-device kernels vs fused_kernels=0: "
              f"{yd:.3g})" for i, (dl, md, w, st, yd) in enumerate(f32))
          + f" (tol: loss 1e-4, median 5e-2, BN statistics "
          f"{DP_F32_STATE_TOL:g}) | planted fault, step 1 with rank-local "
          f"BN moments: BN statistics {fault:.3g} (must exceed "
          f"{DP_F32_STATE_TOL:g})", flush=True)
    if any(dl > 1e-4 or md > 5e-2 or st > DP_F32_STATE_TOL
           for dl, md, _, st, _ in f32) or fault <= DP_F32_STATE_TOL:
        raise AssertionError(f"f32 dp vs single-device: {f32}, planted "
                             f"fault {fault}")

    # the written round loads in a single-device engine and answers
    path = ckpt.model_path(model_dir, 0)
    engine = InferenceEngine.from_checkpoint(
        _serve_cfg(conf, []), path, buckets="8", max_batch=8)
    prob = engine.predict_raw(batches[0].data[:8].transpose(0, 3, 1, 2))
    del engine
    if not np.isfinite(prob).all() or np.abs(prob.sum(1) - 1).max() > 1e-3:
        raise AssertionError("the dp round's answers are not finite "
                             "softmax rows")
    print(f"dp train: round {os.path.basename(path)} loads in a "
          f"single-device engine, finite softmax rows", flush=True)
    for r, rr in enumerate(res):
        print(f"profile: dp train step, rank {r}: {rr['step_ms']:.3f} ms a "
              f"step (host clock, {DP_TIME_STEPS} steps), "
              f"{rr['collectives']:.0f} collectives a step taking "
              f"{rr['comm_ms']:.3f} ms on the host "
              f"({100 * rr['comm_ms'] / rr['step_ms']:.1f}% of the step) | "
              f"{rr['profile']}", flush=True)
    return {"launches": launches, "losses": losses, "worst": worst,
            "f32": [{"loss_rtol": dl, "update_median": md,
                     "update_worst": w[0], "state": st,
                     "state_kernels_vs_plain": yd}
                    for dl, md, w, st, yd in f32],
            "f32_state_rank_local": fault,
            "seconds": took, "step_ms": [rr["step_ms"] for rr in res],
            "comm_ms": [rr["comm_ms"] for rr in res],
            "profile": [rr["profile"] for rr in res]}


def phase_dp_times(gen: torch.Generator) -> dict:
    """CUDA-event times of the four data-parallel BN kernels at
    bn_stem1's per-rank shape (DP_BATCH x 112 x 112, 64, bf16, relu)
    beside the bound (bytes at the memory rate), the plain version and
    the PyTorch call computing the same function."""
    from cxxnet_tpu_torch.ops.fused_norm import (
        bn_bwd_dx, bn_bwd_dx_plain, bn_bwd_sums, bn_bwd_sums_plain, bn_norm,
        bn_norm_plain, bn_sums, bn_sums_plain)
    dev = gen.device
    n, c = DP_BATCH * 112 * 112, 64
    x = (torch.randn((n, c), generator=gen, device=dev) * 1.5
         + 0.25).to(torch.bfloat16)
    g = torch.rand((c,), generator=gen, device=dev) + 0.5
    b = torch.randn((c,), generator=gen, device=dev) * 0.1
    s = bn_sums(x)
    mean = s[0] / n
    rstd = torch.rsqrt(torch.clamp(s[1] / n - mean * mean, min=0) + 1e-10)
    y = bn_norm(x, g, b, mean, rstd, "relu")
    dy = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
    bs = bn_bwd_sums(x, dy, y, mean, rstd)
    sbn, sxhn = bs[0] / n, bs[1] / n
    count = torch.full((DP_RANKS,), n, dtype=torch.int32, device=dev)
    e, v = n * c * 2, 4 * c * 4              # bytes of a (N, C) bf16, vectors

    def lib(fn):
        try:
            return time_call(fn)
        except Exception as ex:               # not gated: a yardstick only
            print(f"times (sync BN): library call failed: {ex!r}", flush=True)
            return None
    rows = {
        "bn_sums": dict(
            ms=time_call(lambda: bn_sums(x)),
            plain_ms=time_call(lambda: bn_sums_plain(x)),
            library_ms=lib(lambda: torch.batch_norm_stats(x, 1e-10)),
            bound=bound_ms(e + 2 * c * 4, 3 * n * c),
            library="torch.batch_norm_stats (mean, invstd)"),
        "bn_norm": dict(
            ms=time_call(lambda: bn_norm(x, g, b, mean, rstd, "relu")),
            plain_ms=time_call(lambda: bn_norm_plain(x, g, b, mean, rstd,
                                                     "relu")),
            library_ms=lib(lambda: torch.batch_norm_elemt(
                x, g, b, mean, rstd, 1e-10)),
            bound=bound_ms(2 * e + v, 5 * n * c),
            library="torch.batch_norm_elemt (no relu)"),
        "bn_bwd_sums": dict(
            ms=time_call(lambda: bn_bwd_sums(x, dy, y, mean, rstd)),
            plain_ms=time_call(lambda: bn_bwd_sums_plain(x, dy, y, mean,
                                                         rstd)),
            library_ms=lib(lambda: torch.batch_norm_backward_reduce(
                dy, x, mean, rstd, g, True, True, True)),
            bound=bound_ms(3 * e + 2 * c * 4 + 2 * c * 4, 6 * n * c),
            library="torch.batch_norm_backward_reduce (no relu mask)"),
        "bn_bwd_dx": dict(
            ms=time_call(lambda: bn_bwd_dx(x, dy, y, g, mean, rstd, sbn,
                                           sxhn)),
            plain_ms=time_call(lambda: bn_bwd_dx_plain(x, dy, y, g, mean,
                                                       rstd, sbn, sxhn)),
            library_ms=lib(lambda: torch.batch_norm_backward_elemt(
                dy, x, mean, rstd, g, bs[0], bs[1], count)),
            bound=bound_ms(4 * e + 5 * c * 4, 9 * n * c),
            library="torch.batch_norm_backward_elemt (no relu mask)"),
    }
    print(f"times (sync BN) at bn_stem1 per rank ({n},{c}) bf16 relu: "
          + " | ".join(
              f"{k}: {r['ms'] * 1e3:.2f} us, bound {r['bound'][0] * 1e3:.2f}"
              f" us ({r['bound'][1]}), plain {r['plain_ms'] * 1e3:.2f} us, "
              f"{r['library']} "
              + ("failed" if r["library_ms"] is None
                 else f"{r['library_ms'] * 1e3:.2f} us")
              + (f" (PERF.md before: {PERF_BEFORE_MS[k]})"
                 if k in PERF_BEFORE_MS else "")
              for k, r in rows.items()), flush=True)
    # the library reduce reads dy and x only: its own byte bound
    lib2 = bound_ms(2 * e + 2 * c * 4 + 2 * c * 4, 6 * n * c)[0]
    lib_ms = rows["bn_bwd_sums"]["library_ms"]
    ours = launch_breakdown(lambda: bn_bwd_sums(x, dy, y, mean, rstd))
    theirs = launch_breakdown(lambda: torch.batch_norm_backward_reduce(
        dy, x, mean, rstd, g, True, True, True))
    clone_ms = time_call(lambda: x.clone())
    print(f"times (sync BN): bn_bwd_sums by launch: {ours} | "
          f"torch.batch_norm_backward_reduce by launch: {theirs} | its "
          f"own 2-stream byte bound {lib2 * 1e3:.2f} us"
          + ("" if lib_ms is None else
             f" = {100 * lib2 / lib_ms:.1f}% of its time")
          + f" | x.clone() {clone_ms * 1e3:.2f} us (bn_norm's bytes as a "
          f"plain copy: one read and one write stream)", flush=True)
    return {"kernels": rows}


# -- phase 12 -----------------------------------------------------------------

#: phase 12's records: train and val images of IMGREC_SIDE^2 RGB pixels,
#: cropped to the flagship's 224 (its own data/eval sections); the train
#: file writes IMGREC_VAL distinct images in turn (encoding them is what
#: writing the records costs)
IMGREC_TRAIN, IMGREC_VAL, IMGREC_SIDE = TRAIN_BATCH * TRAIN_STEPS, 128, 256


def _png_filter_types(h: int):
    """Row filters of phase 12's PNGs: the five types in turn on 5 rows
    of every 20 (so every image has rows of each), Up on the rest; a
    tenth of the rows need the decoder's byte loop (Average, Paeth)."""
    return np.array([r % 5 if (r // 5) % 4 == 0 else 2 for r in range(h)])


def png_encode(img: np.ndarray, ftypes) -> bytes:
    """A minimal 8-bit RGB PNG writer over zlib: each row filtered by
    its type of ``ftypes`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    import struct
    import zlib
    h, w, ch = img.shape
    r = img.reshape(h, w * ch).astype(np.int32)
    a = np.zeros_like(r)
    a[:, ch:] = r[:, :-ch]                       # left
    b = np.zeros_like(r)
    b[1:] = r[:-1]                               # up
    c = np.zeros_like(r)
    c[1:, ch:] = r[:-1, :-ch]                    # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(r), a, b, (a + b) >> 1, paeth])
    rows = np.take_along_axis(pred, ftypes[None, :, None], 0)[0]
    body = np.concatenate([ftypes[:, None], (r - rows) & 255], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.astype(np.uint8).tobytes(), 1))
            + chunk(b"IEND", b""))


#: Annex K.1 quantization tables (luminance, chrominance), row-major
JPEG_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
              92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
              100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32))
_AC_LUM_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHR_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
#: Annex K.3 Huffman tables: (class << 4 | id) -> (code counts of lengths
#: 1..16, symbols)
JPEG_HUFF = {
    0x00: ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    0x01: ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    0x10: ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), _AC_LUM_VALS),
    0x11: ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHR_VALS),
}
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    (i // 8 + i % 8), (i % 8 if (i // 8 + i % 8) % 2 == 0 else i // 8))))


def _huff_codes(counts, symbols):
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    lut_code = np.zeros(256, np.int64)
    lut_len = np.zeros(256, np.int64)
    for s, (c, ln) in out.items():
        lut_code[s], lut_len[s] = c, ln
    return lut_code, lut_len


_HUFF_LUT = {k: _huff_codes(*v) for k, v in JPEG_HUFF.items()}
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _category(v):
    """JPEG magnitude category (bits of |v|) and the extra bits of v."""
    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    extra = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, extra


def _entropy_code(blocks, comp_of, restart_every):
    """The entropy-coded segment of quantized zigzag blocks (n, 64) in
    scan order; ``comp_of`` gives each block's component (0 = Y). Returns
    bytes, byte-stuffed, with RST markers every ``restart_every`` MCUs
    (given as a block count per interval, 0 = none)."""
    n = blocks.shape[0]
    per = restart_every if restart_every else n
    out = bytearray()
    for s0 in range(0, n, per):
        seg = blocks[s0:s0 + per]
        comp = comp_of[s0:s0 + per]
        nb = seg.shape[0]
        # DC differences per component within the interval
        dc = seg[:, 0].copy()
        diff = np.zeros(nb, np.int64)
        for c in np.unique(comp):
            idx = np.flatnonzero(comp == c)
            d = dc[idx]
            diff[idx] = d - np.concatenate([[0], d[:-1]])
        tab = np.minimum(comp, 1)          # Y tables 0, chroma 1
        codes, lens, keys = [], [], []
        size, extra = _category(diff)
        dcode = np.where(tab == 0, _HUFF_LUT[0x00][0][size],
                         _HUFF_LUT[0x01][0][size])
        dlen = np.where(tab == 0, _HUFF_LUT[0x00][1][size],
                        _HUFF_LUT[0x01][1][size])
        codes.append((dcode << size) | extra)
        lens.append(dlen + size)
        keys.append(np.arange(nb) * 4096)
        # AC: nonzero coefficients with their zero runs
        b, k = np.nonzero(seg[:, 1:])
        k = k + 1
        first = np.ones(len(b), bool)
        first[1:] = b[1:] != b[:-1]
        prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
        run = k - prev - 1
        v = seg[b, k]
        asize, aextra = _category(v)
        sym = ((run % 16) << 4) | asize
        atab = tab[b]
        acode = np.where(atab == 0, _HUFF_LUT[0x10][0][sym],
                         _HUFF_LUT[0x11][0][sym])
        alen = np.where(atab == 0, _HUFF_LUT[0x10][1][sym],
                        _HUFF_LUT[0x11][1][sym])
        codes.append((acode << asize) | aextra)
        lens.append(alen + asize)
        keys.append(b * 4096 + k * 32 + 16)
        # ZRL (16 zeros) symbols before a coefficient with a run >= 16
        nzrl = run // 16
        zb = np.repeat(b, nzrl)
        zk = np.repeat(k, nzrl)
        zi = np.arange(len(zb)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        ztab = tab[zb]
        codes.append(np.where(ztab == 0, _HUFF_LUT[0x10][0][0xF0],
                              _HUFF_LUT[0x11][0][0xF0]))
        lens.append(np.where(ztab == 0, _HUFF_LUT[0x10][1][0xF0],
                             _HUFF_LUT[0x11][1][0xF0]))
        keys.append(zb * 4096 + zk * 32 + zi)
        # EOB where the last nonzero coefficient is before 63
        last = np.zeros(nb, np.int64)
        np.maximum.at(last, b, k)
        eb = np.flatnonzero(last < 63)
        codes.append(np.where(tab[eb] == 0, _HUFF_LUT[0x10][0][0],
                              _HUFF_LUT[0x11][0][0]))
        lens.append(np.where(tab[eb] == 0, _HUFF_LUT[0x10][1][0],
                             _HUFF_LUT[0x11][1][0]))
        keys.append(eb * 4096 + 64 * 32)
        codes, lens, keys = (np.concatenate(a) for a in (codes, lens, keys))
        order = np.argsort(keys, kind="stable")
        codes, lens = codes[order], lens[order]
        total = int(lens.sum())
        pad = -total % 8
        ends = np.cumsum(lens)
        ev = np.repeat(np.arange(len(lens)), lens)
        j = np.arange(total) - np.repeat(ends - lens, lens)
        bits = (codes[ev] >> (lens[ev] - 1 - j)) & 1
        bits = np.concatenate([bits, np.ones(pad, np.int64)])
        data = np.packbits(bits.astype(np.uint8))
        ff = np.flatnonzero(data == 0xFF)
        data = np.insert(data, ff + 1, 0)
        out += data.tobytes()
        if restart_every and s0 + per < n:
            out += bytes([0xFF, 0xD0 + (s0 // per) % 8])
    return bytes(out)


def jpeg_encode(img, quality=90, restart_mcus=0):
    """A baseline JFIF JPEG of an RGB uint8 (h, w, 3) image: YCbCr 4:2:0,
    Annex K tables scaled to ``quality`` as libjpeg scales them, standard
    Huffman codes, a restart marker every ``restart_mcus`` MCUs (0 =
    none)."""
    h, w, _ = img.shape
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    qt = [np.clip((q * scale + 50) // 100, 1, 255).astype(np.int64)
          for q in JPEG_QUANT]
    x = img.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168735892 * x[..., 0] - 0.331264108 * x[..., 1] + 0.5 * x[..., 2]
        + 128,
        0.5 * x[..., 0] - 0.418687589 * x[..., 1] - 0.081312411 * x[..., 2]
        + 128], -1)
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    ycc = np.pad(ycc, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    planes = [ycc[..., 0]] + [ycc[..., c].reshape(hp // 2, 2, wp // 2, 2)
                              .mean((1, 3)) for c in (1, 2)]

    def blocks(p, q):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        b = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = _DCT @ b @ _DCT.T
        return np.rint(f / q.reshape(8, 8)).astype(np.int64).reshape(
            bh, bw, 64)[..., _ZIGZAG]
    yb = blocks(planes[0], qt[0])
    cb, cr = blocks(planes[1], qt[1]), blocks(planes[2], qt[1])
    my, mx = hp // 16, wp // 16
    # MCU: Y00 Y01 Y10 Y11 Cb Cr
    ys = yb.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcu = np.concatenate([ys, cb[:, :, None], cr[:, :, None]], 2)
    scan = mcu.reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    ecs = _entropy_code(scan, comp, restart_mcus * 6)

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, q in enumerate(qt):
        out += seg(0xDB, bytes([i]) + q[_ZIGZAG].astype(np.uint8).tobytes())
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc, (counts, syms) in JPEG_HUFF.items():
        out += seg(0xC4, bytes([tc]) + bytes(counts) + syms)
    if restart_mcus:
        out += seg(0xDD, struct.pack(">H", restart_mcus))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + ecs + b"\xff\xd9"


def seeded_images(rng: np.random.RandomState, n: int, side: int):
    """``n`` RGB images with structure (a gradient per channel, two
    bright rectangles, noise), uint8."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    out = []
    for _ in range(n):
        k = rng.uniform(-0.4, 0.4, (2, 3)).astype(np.float32)
        img = (128 + k[0] * (yy[..., None] - side / 2)
               + k[1] * (xx[..., None] - side / 2))
        for _ in range(2):
            y0, x0 = rng.randint(0, side * 3 // 4, 2)
            img[y0:y0 + side // 4, x0:x0 + side // 4] += rng.uniform(
                -60, 60, 3)
        img += rng.randn(side, side, 3).astype(np.float32) * 8
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return out


#: phase 12's JPEGs: quality, and a restart marker every this many MCUs
#: in every fourth file
JPEG_QUALITY, JPEG_RESTART_MCUS = 90, 8
#: the least PSNR (dB) of phase 12's decoded JPEGs against their arrays:
#: libjpeg reads 30.4 on these images (per-channel noise that 4:2:0
#: chroma cannot keep; tests/test_torch_decode.py)
JPEG_PSNR_MIN = 28.0


def encode_image(img: np.ndarray, fmt: str, i: int) -> bytes:
    """Image ``i`` of a record file as ``fmt``: phase 12's PNG filter
    mix, or a quality-90 4:2:0 JPEG, every fourth with restart
    markers."""
    if fmt == "png":
        return png_encode(img, _png_filter_types(img.shape[0]))
    return jpeg_encode(img, JPEG_QUALITY,
                       JPEG_RESTART_MCUS if i % 4 == 3 else 0)


def write_records(tmp: str, seed: int, sizes, side: int, classes: int,
                  fmt: str, unique: int = 0):
    """Record files of seeded RGB images (``sizes``: name -> count) of
    ``side``^2 pixels as ``fmt``, labels below ``classes``, through the
    port's RecordWriter (``tmp`` may be a ``file://`` URL); with
    ``unique``, a file holds at most that many distinct images, written
    in turn (each record its own id and label). Returns their paths, the
    distinct images by name and the seconds taken."""
    from cxxnet_tpu_torch.io.recordio import ImageRecord, RecordWriter
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    paths, imgs = {}, {}
    for name, n in sizes:
        imgs[name] = seeded_images(rng, min(n, unique or n), side)
        labels = rng.randint(0, classes, n)
        encoded = [encode_image(img, fmt, i)
                   for i, img in enumerate(imgs[name])]
        paths[name] = os.path.join(tmp, f"{name}.{fmt}.rec")
        with RecordWriter(paths[name]) as w:
            for i, lab in enumerate(labels):
                w.write(ImageRecord(inst_id=i, labels=np.float32([lab]),
                                    data=encoded[i % len(encoded)]).pack())
            w.write_index(paths[name])
    return paths, imgs, time.perf_counter() - t0


def write_imgrec(tmp: str, seed: int, fmt: str = "png"):
    """Phase 12's record files (train and val images with labels from
    ``seed``, PNG or JPEG); returns their paths, the val images and the
    seconds taken."""
    paths, imgs, took = write_records(
        tmp, seed, (("train", IMGREC_TRAIN), ("val", IMGREC_VAL)),
        IMGREC_SIDE, TRAIN_CLASSES, fmt, unique=IMGREC_VAL)
    return paths, imgs["val"], took


def read_records(path: str):
    """The ImageRecords of a record file."""
    from cxxnet_tpu_torch.io.recordio import ImageRecord, RecordReader
    reader = RecordReader(path)
    try:
        return [ImageRecord.unpack(p) for p in reader]
    finally:
        reader.close()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def imgrec_cfg(conf: str, paths, mean: str, model_dir: str, extra=()):
    """``conf`` as it stands, its data and eval sections included, with
    only the record and mean paths rewritten to the phase's files."""
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file)
    out, section = [], None
    for k, v in parse_config_file(conf):
        if k in ("data", "eval"):
            section = "train" if k == "data" else "val"
        if k == "image_rec":
            v = paths[section]
        elif k == "image_mean":
            v = mean
        out.append((k, v))
    return out + parse_cli_overrides([
        "task=train", "num_round=1", f"model_dir={model_dir}",
        "save_model=1", "print_step=1", *extra])


#: stem cases of phase 12: (name, shape, mean kind, factor, out dtype)
STEM_CASES = (
    ("path", (TRAIN_BATCH, 224, 224, 3), "image", 1.0, torch.bfloat16),
    ("channel f32", (8, 224, 224, 3), "channel", 1 / 58.0, torch.float32),
    ("channel f16", (8, 224, 224, 3), "channel", 1 / 58.0, torch.float16),
    ("no mean", (16, 227, 227, 3), "none", 1 / 255.0, torch.bfloat16),
    ("ragged", (5, 17, 13, 3), "image", 0.017, torch.float32),
    ("batch 1", (1, 224, 224, 3), "channel", 1.0, torch.bfloat16),
    ("rows ragged", (37, 224, 224, 3), "image", 1 / 58.0, torch.bfloat16),
    ("C 1", (9, 31, 17, 1), "channel", 0.5, torch.float16),
    ("C 4", (6, 20, 20, 4), "channel", 1 / 255.0, torch.float32),
    ("cols 4 mod 8", (5, 10, 10, 3), "channel", 0.017, torch.bfloat16),
    ("cols odd", (7, 15, 15, 3), "image", 0.017, torch.bfloat16),
)


def _stem_inputs(gen, shape, mean_kind):
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.uint8)
    mean = {"none": None,
            "channel": torch.tensor([123.68, 116.78, 103.94, 99.5][
                :shape[-1]], device="cuda"),
            "image": torch.rand(shape[1:], generator=gen, device="cuda")
            * 255}[mean_kind]
    return x, mean


def phase_stem_kernels(gen: torch.Generator) -> dict:
    """``stem`` bit-equal to its plain version in every case of
    STEM_CASES; returns the worst absolute difference (0)."""
    from cxxnet_tpu_torch.ops import fused_stem as fs
    worst, notes = 0.0, []
    for name, shape, mk, f, dt in STEM_CASES:
        x, mean = _stem_inputs(gen, shape, mk)
        got = fs.fused_decode_normalize(x, mean, f, dt)
        want = fs.decode_normalize_reference(x, mean, f, dt)
        torch.cuda.synchronize()
        if got.dtype != dt or not torch.equal(got, want):
            raise AssertionError(f"stem {name} {shape}: max |kernel - "
                                 f"plain| {(got.float() - want.float()).abs().max().item()}")
        notes.append(f"{name} {shape} {str(dt)[6:]}")
    print(f"kernels (stem): bit-equal to decode_normalize_reference in "
          f"{len(notes)} cases: {', '.join(notes)}", flush=True)
    return {"stem": worst}


class _Tee:
    """stdout that is also kept: the phase reads the run's log (kept
    only, with ``out`` None)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return len(s) if self.out is None else self.out.write(s)

    def flush(self):
        if self.out is not None:
            self.out.flush()


def phase_imgrec(conf: str, seed: int, tmp: str, extra=(),
                 fmt: str = "png"):
    """Phase 12: train Inception-BN from ``conf``'s own imgrec sections
    over seeded PNG or JPEG (``fmt``) records and check it (module
    docstring); returns (trainer, batches, config, val images, notes,
    launches)."""
    import contextlib
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.io import close_chain, create_iterator
    from cxxnet_tpu_torch.io.decode import decode_image
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    tmp = os.path.join(tmp, fmt)
    os.makedirs(tmp, exist_ok=True)
    paths, val_imgs, t_write = write_imgrec(tmp, seed, fmt)
    mean_path = os.path.join(tmp, "mean.bin")
    model_dir = os.path.join(tmp, "imgrec")
    cfg = imgrec_cfg(conf, paths, mean_path, model_dir, extra)
    box = {"losses": [], "before": [], "batches": [], "per_step": []}
    counted = ("stem", "bn_fwd", "bn_bwd", "sgd_apply")

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        box["per_step"].append({k: KERNELS[k].launches for k in counted})
        reset_launches()
        if len(box["losses"]) < TRAIN_STEPS:
            box["before"].append(_snap(tr))

    def ready(tr):
        box["before"].append(_snap(tr))
        tr.step_hook = on_step
        update = tr.update

        def keep(b):
            # the round loop stages each batch as it draws it: keep the
            # host batch
            box["batches"].append(getattr(b, "host", b))
            update(b)
        tr.update = keep
        torch.cuda.synchronize()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    had_mean = os.path.exists(mean_path + ".npy")
    tee = _Tee(sys.stdout)
    t_run = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    eval_launches = {k: KERNELS[k].launches for k in counted}
    del tr.update
    tr.step_hook = None
    log = "".join(tee.parts)
    if "device_normalize auto-resolved to 1" not in log:
        raise AssertionError("the imgrec sections did not resolve "
                             "device_normalize to 1")
    if had_mean or not os.path.exists(mean_path + ".npy"):
        raise AssertionError("the mean image was not computed and written "
                             "on first use")
    steps = len(box["losses"])
    batches = box["batches"]
    if steps != TRAIN_STEPS or len(batches) != steps or any(
            b.data.dtype != np.uint8 or b.norm is None for b in batches):
        raise AssertionError(f"{steps} steps over {len(batches)} batches; "
                             "want uint8 batches with norm")
    want = {"stem": 1, "bn_fwd": 69, "bn_bwd": 69, "sgd_apply": 2}
    bad = [(i + 1, n) for i, n in enumerate(box["per_step"]) if n != want]
    if bad or eval_launches["stem"] != 0:
        raise AssertionError(f"launches per step {bad} (want {want}), stem "
                             f"in the evaluation {eval_launches['stem']}")
    losses = box["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    after = box["before"][1:] + [_snap(tr)]
    glob, sections = split_sections(cfg)
    worst, plain = steps_vs_plain(glob, box["before"], after, losses,
                                  batches)
    # the folded input against the input_fold = 0 eager path, in bf16
    eager = Trainer(glob + [("input_fold", "0"), ("silent", "1")])
    for b in batches:
        folded = tr._input(b, fold=True)
        ref = eager._input(b, fold=True).to(folded.dtype)
        if folded.dtype != torch.bfloat16 or not torch.equal(folded, ref):
            raise AssertionError("the folded input differs from the "
                                 "input_fold = 0 path cast to bf16")
    del eager
    # the val crops: center crops of the decoded records, bit for bit
    # (the encoded arrays themselves for PNG; nvJPEG's pixels for JPEG,
    # which must stay near the arrays)
    val_pairs = [p for kind, _, p in sections if kind == "eval"][0]
    it = create_iterator(glob + val_pairs + [("silent", "1")])
    vb = it.next()
    close_chain(it)
    if fmt == "png":
        decoded, worst_psnr = val_imgs, None
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
        decoded = [decode_image(r.data, 3, dev)
                   for r in read_records(paths["val"])]
        worst_psnr = min(psnr(a, b) for a, b in zip(decoded, val_imgs))
        if worst_psnr < JPEG_PSNR_MIN:
            raise AssertionError(f"nvJPEG's val images read {worst_psnr:.2f}"
                                 f" dB against their arrays (want >= "
                                 f"{JPEG_PSNR_MIN})")
    crop = vb.data.shape[1]
    o = (IMGREC_SIDE - crop) // 2
    crops = np.stack([decoded[i][o:o + crop, o:o + crop]
                      for i in vb.inst_index])
    if vb.data.dtype != np.uint8 or not np.array_equal(vb.data, crops):
        raise AssertionError("the val crops differ from the decoded "
                             "records' center crops")
    # the written round serves finite softmax rows
    blob = ckpt.load_for_inference(ckpt.model_path(model_dir, 0))
    net = Network(tr.graph, [kv for kv in glob if kv[0] != "task"])
    ckpt.check_structure(blob["meta"], tr.graph.structure_signature())
    net.load_weights(*params_from_jax(blob["params"], blob["state"]))
    prob = net(tr._input(vb, fold=False)[:8]).out.float().reshape(8, -1)
    if not bool(torch.isfinite(prob).all()) or \
            (prob.sum(1) - 1).abs().max().item() > 1e-3:
        raise AssertionError("the written round's answers are not finite "
                             "softmax rows")
    del net
    route = ("png.cc" if fmt == "png" else
             f"nvJPEG; its val decodes >= {worst_psnr:.2f} dB against the "
             f"arrays")
    print(f"imgrec ({fmt}): {steps} steps of full-width Inception-BN from "
          f"{os.path.relpath(conf, ROOT)}'s own data/eval sections (imgrec, "
          f"rand_crop, rand_mirror, shuffle, image_mean, threadbuffer; "
          f"{IMGREC_TRAIN} train ({IMGREC_VAL} distinct images) and "
          f"{IMGREC_VAL} val {fmt.upper()} records"
          f" of {IMGREC_SIDE}x{IMGREC_SIDE} written in {t_write:.1f}s, "
          f"decoded through {route}) through main.run in {t_run:.1f}s with "
          f"the mean computed and written, the evaluation and the round | "
          f"device_normalize auto-resolved to 1, uint8 batches | losses "
          f"{[round(v, 4) for v in losses]} | launches per step "
          f"{box['per_step'][0]} (want {want}), stem in the evaluation "
          f"{eval_launches['stem']} | {_steps_line(worst)} | folded input "
          f"bit-equal to input_fold=0 cast to bf16 | val crops bit-equal "
          f"to the decoded records' center crops | round loads, finite "
          f"softmax rows", flush=True)
    launches = {k: sum(n[k] for n in box["per_step"]) + eval_launches[k]
                for k in counted}
    notes = {"losses": losses, "worst": worst, "seconds": t_run,
             "write_seconds": t_write, "format": fmt,
             "val_psnr_min": worst_psnr}
    del plain
    return tr, batches, cfg, val_imgs, notes, launches


#: PR 15's PNG chain (numpy unfilter), from PERF.md section 5
PNG_CHAIN_BEFORE = "52.4 images/s, 2,444.8 ms a batch"
#: threads of the decode-alone rates (the iterator's default on 8 cores)
DECODE_THREADS = 8


def chain_rates(cfg) -> dict:
    """The data section's chain read for one epoch: images/s by
    ``decode_threads`` (the default, and 1)."""
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.io import close_chain, create_iterator
    glob, sections = split_sections(cfg)
    data_pairs = [p for kind, _, p in sections if kind == "data"][0]
    chain = {}
    for extra in ((), (("decode_threads", "1"),)):
        it = create_iterator(glob + data_pairs + [("silent", "1"), *extra])
        t0 = time.perf_counter()
        seen = sum(bb.batch_size for bb in it)
        chain[getattr(it, "base", it).nthread] = \
            seen / (time.perf_counter() - t0)
        close_chain(it)
    return chain


def decode_rates(decode, datas) -> dict:
    """Images/s of ``decode`` over ``datas``, on one thread and on a pool
    of DECODE_THREADS (each after one warm call a thread)."""
    import concurrent.futures as futures
    out = {}
    for n in (1, DECODE_THREADS):
        with futures.ThreadPoolExecutor(n) as ex:
            list(ex.map(decode, datas[:n]))
            t0 = time.perf_counter()
            list(ex.map(decode, datas))
            out[n] = len(datas) / (time.perf_counter() - t0)
    return out


def _rates(r: dict) -> str:
    return " / ".join(f"{v:.1f}" for _, v in sorted(r.items()))


def phase_imgrec_times(tr, batches, cfg, val_imgs, synthetic_step_ms):
    """Phase 12's times, printed and not gated: ``stem`` at the path
    shape beside its bound and plain version, the H2D copy of a uint8 and
    a float32 batch, the train step over an imgrec batch beside phase
    6's, the train chain's decode rate and the PNG decoder's alone."""
    from cxxnet_tpu_torch.io.decode import decode_image
    from cxxnet_tpu_torch.ops import fused_stem as fs
    b0 = batches[0]
    x = torch.from_numpy(b0.data).cuda()
    mean_t = torch.from_numpy(np.asarray(b0.norm["mean"], np.float32)).cuda()
    f = np.float32(b0.norm["scale"] / b0.norm["divideby"])
    n, cols = x.shape[0], x[0].numel()
    stem = dict(
        ms=time_call(lambda: fs.fused_decode_normalize(x, mean_t, f,
                                                       torch.bfloat16)),
        plain_ms=time_call(lambda: fs.decode_normalize_reference(
            x, mean_t, f, torch.bfloat16)),
        library_ms=None,
        bound=bound_ms(n * cols + n * cols * 2 + cols * 4, 2 * n * cols),
        shape=f"{tuple(x.shape)} u8 -> bf16, mean image",
        library="n/a (no one call)")
    host8 = torch.from_numpy(b0.data).pin_memory()
    host32 = torch.from_numpy(b0.data.astype(np.float32)).pin_memory()
    h2d = {k: time_forward(lambda h=h: h.to("cuda", non_blocking=True))
           for k, h in (("uint8", host8), ("float32", host32))}
    step_ms = time_forward(lambda: tr.update(b0), reps=10)
    prof = profile_calls(lambda: tr.update(b0), 3, "step")
    # decode: the train chain's images/s over one epoch (its first batch
    # waits for the decode of four), and the PNG decoder alone (phase
    # 12's filter mix, and a Paeth-only image)
    chain = chain_rates(cfg)
    threads = max(chain)
    iter_ips = chain[threads]
    enc = png_encode(val_imgs[0], _png_filter_types(IMGREC_SIDE))
    enc4 = png_encode(val_imgs[0], np.full(IMGREC_SIDE, 4))
    rates = {}
    for k, e in (("mix", enc), ("paeth", enc4)):
        if not np.array_equal(decode_image(e, 3), val_imgs[0]):
            raise AssertionError(f"PNG ({k}) does not decode to its array")
        rates[k] = decode_rates(lambda d: decode_image(d, 3), [e] * 64)
    host_ms = TRAIN_BATCH / iter_ips * 1e3
    print(f"times (imgrec): stem {stem['shape']}: {stem['ms'] * 1e3:.2f} us "
          f"({_rate(stem)}; PERF.md before: {PERF_BEFORE_MS['stem']}), "
          f"bound {stem['bound'][0] * 1e3:.2f} us ({stem['bound'][1]}), "
          f"plain {stem['plain_ms'] * 1e3:.2f} us, library "
          f"{stem['library']} | H2D of one batch (pinned, CUDA events, "
          f"median of 20): uint8 {host8.numel() / 1e6:.1f} MB "
          f"{h2d['uint8']:.3f} ms, float32 {host32.numel() * 4 / 1e6:.1f} MB "
          f"{h2d['float32']:.3f} ms | train step over an imgrec batch "
          f"(uint8 H2D, stem, forward, backward, SGD) {step_ms:.3f} ms, "
          f"phase 6's synthetic step {synthetic_step_ms:.3f} ms | train "
          f"chain (png.cc) {iter_ips:.1f} images/s with decode_threads="
          f"{threads} (the default; host decode of one batch of "
          f"{TRAIN_BATCH}: {host_ms:.1f} ms; PERF.md before, numpy "
          f"unfilter: {PNG_CHAIN_BEFORE}), {chain[1]:.1f} with "
          f"decode_threads=1 | PNG decode alone (png.cc), "
          f"{IMGREC_SIDE}x{IMGREC_SIDE} RGB, images/s on 1 and "
          f"{DECODE_THREADS} threads: {_rates(rates['mix'])} at phase 12's "
          f"filter mix, {_rates(rates['paeth'])} Paeth-only | profile: "
          f"train step over an imgrec batch: {prof}", flush=True)
    return {"kernels": {"stem": stem}, "step_ms": step_ms,
            "h2d_ms": h2d, "iter_images_per_s": iter_ips,
            "iter_images_per_s_1_thread": chain[1],
            "decode_threads": threads, "png_images_per_s": rates,
            "profile": prof}


def jpeg_fixture():
    """tests/torch_jpeg_fixture.py (no jax, no PIL at import)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_jpeg_fixture
    return torch_jpeg_fixture


def phase_nvjpeg() -> dict:
    """nvJPEG against the fixture's pixels (libjpeg's; for the CMYK and
    YCCK files the JAX package's), within its bounds (``NVJPEG_BOUNDS``);
    the fixture decoded on DECODE_THREADS threads at once gives the
    pixels one thread gives. Returns the readings by file."""
    import concurrent.futures as futures
    from cxxnet_tpu_torch.io.decode import decode_image
    jfx = jpeg_fixture()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows, bad = {}, []
    for name in jfx.SPECS:
        data = jfx.jpeg(name)
        for want in (3, 1):
            got = decode_image(data, want, dev)
            ref = jfx.pixels(name, want)
            d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            mx, mean = int(d.max()), float(d.mean())
            bmax, bmean = jfx.bound_of(name, want)
            rows[f"{name}/{want}"] = (mx, round(mean, 4))
            if got.shape != ref.shape or mx > bmax or (
                    bmean is not None and mean > bmean):
                bad.append(f"{name} to {want}: max {mx} mean {mean:.4f} "
                           f"(bounds {bmax}, {bmean})")
    names = list(jfx.SPECS) * 8
    one = [decode_image(jfx.jpeg(n), 3, dev) for n in names]
    with futures.ThreadPoolExecutor(DECODE_THREADS) as ex:
        many = list(ex.map(lambda n: decode_image(jfx.jpeg(n), 3, dev),
                           names))
    if not all(np.array_equal(a, b) for a, b in zip(one, many)):
        bad.append(f"{DECODE_THREADS} threads at once differ from one")
    if bad:
        raise AssertionError("nvJPEG against the fixture's pixels: "
                             + "; ".join(bad))
    print(f"nvjpeg: {len(jfx.SPECS)} fixture files (grey, 4:4:4, 4:2:2, "
          f"4:2:0, progressive, restart intervals, CMYK, YCCK) against "
          f"libjpeg's pixels (the JAX package's for CMYK and YCCK), (max "
          f"|d|, mean |d|) by file/channels: {rows} within "
          f"{jfx.NVJPEG_BOUNDS} | {len(names)} decodes on "
          f"{DECODE_THREADS} threads at once bit-equal to one thread",
          flush=True)
    return rows


def phase_jpeg_times(tr, batches, cfg, val_imgs, png_step_ms) -> dict:
    """The JPEG run's times, printed and not gated: its train chain's
    images/s (nvJPEG on the decode threads), nvJPEG alone on 1 and
    DECODE_THREADS threads, and the train step over a JPEG batch."""
    from cxxnet_tpu_torch.io.decode import decode_image
    dev = torch.device("cuda", torch.cuda.current_device())
    chain = chain_rates(cfg)
    threads = max(chain)
    enc = [encode_image(img, "jpeg", i) for i, img in enumerate(val_imgs)]
    alone = decode_rates(lambda d: decode_image(d, 3, dev), enc)
    step_ms = time_forward(lambda: tr.update(batches[0]), reps=10)
    print(f"times (imgrec, jpeg): train chain (nvJPEG) {chain[threads]:.1f}"
          f" images/s with decode_threads={threads} (host decode of one "
          f"batch of {TRAIN_BATCH}: {TRAIN_BATCH / chain[threads] * 1e3:.1f}"
          f" ms), {chain[1]:.1f} with decode_threads=1 | nvJPEG alone, "
          f"{IMGREC_SIDE}x{IMGREC_SIDE} 4:2:0 quality {JPEG_QUALITY}, "
          f"images/s on 1 and {DECODE_THREADS} threads: {_rates(alone)} | "
          f"train step over a JPEG batch {step_ms:.3f} ms (the PNG run's "
          f"{png_step_ms:.3f})", flush=True)
    return {"iter_images_per_s": chain[threads],
            "iter_images_per_s_1_thread": chain[1],
            "decode_threads": threads, "nvjpeg_images_per_s": alone,
            "step_ms": step_ms}


# -- phase 14 -------------------------------------------------------------------

BOWL_CONF = os.path.join(ROOT, "examples", "kaggle_bowl", "bowl.conf")
#: phase 14's records: 48x48 RGB as gen_resize.py makes them, 121 classes
BOWL_TRAIN, BOWL_VAL, BOWL_SIDE, BOWL_CLASSES = 1024, 256, 48, 121
#: warp.cc against warp_affine_plain on the phase's images (0..255)
BOWL_WARP_ATOL = 2e-3


def phase_bowl(seed: int, tmp: str, extra=()) -> dict:
    """Phase 14: bowl.conf's train and eval sections as written (the
    affine keys included) over seeded JPEG records, trained one round
    through main.run and checked (module docstring). Returns notes."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.io.augment import (AugmentParams, ImageAugmenter,
                                             warp_affine, warp_affine_plain)
    from cxxnet_tpu_torch.io.decode import decode_image
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    t_phase = time.perf_counter()
    tmp = os.path.join(tmp, "bowl")
    os.makedirs(tmp, exist_ok=True)
    paths, imgs, t_write = write_records(
        tmp, seed, (("train", BOWL_TRAIN), ("val", BOWL_VAL)), BOWL_SIDE,
        BOWL_CLASSES, "jpeg")
    model_dir = os.path.join(tmp, "models")
    cfg = imgrec_cfg(BOWL_CONF, paths, os.path.join(tmp, "bowl_mean.bin"),
                     model_dir, extra)
    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    batch = int(dict(glob)["batch_size"])
    steps = BOWL_TRAIN // batch
    counted = ("epilogue_fwd", "epilogue_bwd", "sgd_apply")
    box = {"losses": [], "before": [], "batches": [], "per_step": []}

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        box["per_step"].append({k: KERNELS[k].launches for k in KERNELS})
        reset_launches()
        if len(box["losses"]) < steps:
            box["before"].append(_snap(tr))

    def ready(tr):
        box["before"].append(_snap(tr))
        tr.step_hook = on_step
        update = tr.update

        def keep(b):
            # the round loop stages each batch as it draws it: keep the
            # host batch
            box["batches"].append(getattr(b, "host", b))
            update(b)
        tr.update = keep
        torch.cuda.synchronize()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    t_run = time.perf_counter()
    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    del tr.update
    tr.step_hook = None
    batches, losses = box["batches"], box["losses"]
    if len(losses) != steps or len(batches) != steps:
        raise AssertionError(f"bowl: {len(losses)} steps over "
                             f"{len(batches)} batches, want {steps}")
    if any(b.data.dtype != np.float32 or b.norm is not None
           for b in batches):
        raise AssertionError("bowl: the affine section must give float32 "
                             "host-normalized batches")
    # the launches a step, counted from the net: one epilogue forward
    # and backward for each conv and fullc with a bias, one SGD apply a
    # tag group, no other kernel (the 3x3/2 pools do not tile)
    biased = sum(1 for layer in tr.net.layers
                 if layer.spec.type in ("conv", "fullc")
                 and not layer.hp.no_bias)
    want = {"epilogue_fwd": biased, "epilogue_bwd": biased,
            "sgd_apply": len(tr.optimizer._groups(tr.params))}
    others = {}
    for i, n in enumerate(box["per_step"]):
        check_launches(f"bowl step {i + 1}", n, want, {})
        others.update({k: v for k, v in n.items()
                       if k not in counted and v})
    if others:
        raise AssertionError(f"bowl: other kernels launched {others}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bowl: non-finite loss {losses}")
    # each step against fused_kernels = 0 from the same state and batch
    dt = dict(glob).get("compute_dtype", "float32")
    quiet = [("silent", "1")]
    kern = Trainer(glob + quiet)
    plain = Trainer(glob + quiet + [("fused_kernels", "0")])
    rows = []
    for i, b in enumerate(batches):
        dl, rels, spread = convnet_step_check(kern, plain, box["before"][i],
                                              b, i, dt)
        rows.append((dl, float(np.median([r for r, _ in rels])), max(rels),
                     spread))
    fails = [f"step {i + 1}: {r}" for i, r in enumerate(rows)
             if r[0] > CONVNET_LOSS_TOL[dt] or r[1] > CONVNET_GRAD_TOL[dt][0]
             or r[2][0] > CONVNET_GRAD_TOL[dt][1]]
    if fails:
        raise AssertionError(f"bowl: kernels vs fused_kernels=0 from the "
                             f"same state (tol loss {CONVNET_LOSS_TOL[dt]}, "
                             f"gradient {CONVNET_GRAD_TOL[dt]}): {fails}")
    step_ms = time_forward(lambda: tr.update(batches[0]), reps=10)
    del kern, plain
    # warp.cc against its plain version on the phase's own images
    aug = AugmentParams()
    for k, v in data:
        aug.set_param(k, v)
    c, oy, ox = (int(v) for v in dict(glob)["input_shape"].split(","))
    augmenter = ImageAugmenter(aug, (c, oy, ox))
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda", torch.cuda.current_device())
    warp_err = 0.0
    for rec in read_records(paths["train"])[:8]:
        img = decode_image(rec.data, 3, dev).astype(np.float32)
        m = augmenter.affine_matrix(img.shape[0], img.shape[1], rng)
        got = warp_affine(img, m, (oy, ox), aug.fill_value)
        ref = warp_affine_plain(img, m, (oy, ox), aug.fill_value)
        warp_err = max(warp_err, float(np.abs(got - ref).max()))
    if warp_err > BOWL_WARP_ATOL:
        raise AssertionError(f"bowl: warp.cc against warp_affine_plain "
                             f"{warp_err} (atol {BOWL_WARP_ATOL})")
    # the written round answers finite softmax rows
    blob = ckpt.load_for_inference(ckpt.model_path(model_dir, 0))
    net = Network(tr.graph, [kv for kv in glob if kv[0] != "task"])
    ckpt.check_structure(blob["meta"], tr.graph.structure_signature())
    net.load_weights(*params_from_jax(blob["params"], blob["state"]))
    x = torch.from_numpy(batches[0].data[:8]).to(net.device)
    prob = net(x).out.float().reshape(8, -1)
    if not bool(torch.isfinite(prob).all()) or \
            (prob.sum(1) - 1).abs().max().item() > 1e-3:
        raise AssertionError("bowl: the written round's answers are not "
                             "finite softmax rows")
    del net
    chain = chain_rates(cfg)
    threads = max(chain)
    fmt = [(f"{dl:.2g}", f"{md:.2g}", f"{w[0]:.2g} {w[1]}")
           for dl, md, w, _ in rows]
    took = time.perf_counter() - t_phase
    print(f"bowl: {steps} steps of {os.path.relpath(BOWL_CONF, ROOT)}'s own "
          f"train and eval sections (imgrec with max_rotate_angle 180, "
          f"max_aspect_ratio 0.5, max_shear_ratio 0.3, crop 32-48, "
          f"rand_crop, rand_mirror, shuffle, image_mean; batch {batch}, "
          f"{dt}) over {BOWL_TRAIN} train and {BOWL_VAL} val JPEG records "
          f"of {BOWL_SIDE}x{BOWL_SIDE}, {BOWL_CLASSES} classes, written in "
          f"{t_write:.1f}s, through main.run in {t_run:.1f}s with the mean "
          f"computed, one evaluation and the round | losses "
          f"{[round(v, 4) for v in losses]} | launches per step {want} "
          f"(each step checked, no other kernel) | vs fused_kernels=0 from "
          f"the same state, per step (loss diff, gradient rel L2 median, "
          f"worst leaf): {fmt} (tol loss {CONVNET_LOSS_TOL[dt]}, gradient "
          f"{CONVNET_GRAD_TOL[dt]}) | warp.cc vs warp_affine_plain on 8 of "
          f"the phase's images: max |d| {warp_err:.3g} (atol "
          f"{BOWL_WARP_ATOL}) | round loads, finite softmax rows | times: "
          f"decoded and augmented {chain[threads]:.1f} images/s with "
          f"decode_threads={threads}, {chain[1]:.1f} with 1; train step "
          f"{step_ms:.3f} ms | phase {took:.1f}s", flush=True)
    return {"losses": losses, "checks": rows, "warp_err": warp_err,
            "launches_per_step": want, "steps": steps,
            "iter_images_per_s": chain[threads],
            "iter_images_per_s_1_thread": chain[1], "decode_threads": threads,
            "step_ms": step_ms, "seconds": took, "write_seconds": t_write}


# -- phase 15: the rest of training -------------------------------------------

#: the planted overflow: every input value 1e8, past float16's 65504
PLANT = 1e8
#: AlexNet under accumulation: alexnet.conf's own fallback, batch 128 with
#: update_period = 2 (its comment: equivalent to batch 256)
ACCUM_BATCH, ACCUM_PERIOD = 128, 2
#: the chained run: train_chain = CHAIN_K over CHAIN_BATCHES batches, so
#: two chains and a tail of two update() calls
CHAIN_K, CHAIN_BATCHES = 4, 10


def _scaler(tr):
    """(scale, good) of a trainer's float16 loss scaler."""
    mp = tr.opt_state["_mp"]
    return float(mp["scale"]), int(mp["good"])


def _bits_equal(a, b) -> bool:
    """Whether the masters and momenta of two snapshots are bit-equal."""
    return all(np.array_equal(x, y) for x, y in zip(
        _flat_np(a[0]) + _flat_np(a[1]["mom"]),
        _flat_np(b[0]) + _flat_np(b[1]["mom"])))


def _host_syncs(fn) -> list:
    """The host syncs ``fn()`` makes, caught by PyTorch's CUDA sync
    debug mode (a warning for each synchronizing call), as the
    ``file:line`` of the Python line that made each."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
            if "called a synchronizing" in str(w.message)]


def _train_run(cfg, on_step=None, wrap=None):
    """``main.run(cfg)`` with the launch counts set to 0 just before the
    first step and read just after the run; ``on_step`` is the trainer's
    step hook, ``wrap(tr)`` is called in ``ready``. Returns (trainer,
    launches, the init's snapshot, seconds)."""
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    box = {}

    def ready(tr):
        box["init"] = _snap(tr)
        tr.step_hook = on_step
        if wrap is not None:
            wrap(tr)
        torch.cuda.synchronize()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS.values()}
    tr.step_hook = None
    return tr, launches, box["init"], time.perf_counter() - box["t0"]


def _data_batches(cfg):
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.io import create_iterator
    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    return glob, list(create_iterator(glob + data))


def phase_fp16(conf: str, seed: int, tmp: str, bf16_step_ms: float) -> dict:
    """Full-width Inception-BN with ``compute_dtype = float16`` through
    main.run (phase 6's run otherwise), the planted overflow, and the
    scale's growth with ``loss_scale_window = 2``."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.trainer import Trainer
    cfg = train_cfg(conf, seed, os.path.join(tmp, "fp16"),
                    ("compute_dtype=float16",))
    box = {"losses": [], "after": [], "scales": []}

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        box["scales"].append(_scaler(tr))
        box["after"].append(_snap(tr))

    tr, launches, init, took = _train_run(cfg, on_step)
    steps = len(box["losses"])
    if steps != TRAIN_STEPS:
        raise AssertionError(f"fp16: {steps} steps")
    train_launches("fp16", launches, steps)
    mp = init[1]["_mp"]
    scales = [(float(mp["scale"]), int(mp["good"]))] + box["scales"]
    # no growth within a window of 200: good 0 after a step is a skip
    skipped = {i for i in range(steps) if scales[i + 1][1] == 0}
    if len(skipped) > steps - 2:
        raise AssertionError(f"fp16: fewer than 2 of {steps} steps applied: "
                             f"scale, good {scales}")
    losses = box["losses"]
    if not all(np.isfinite(v) for i, v in enumerate(losses)
               if i not in skipped):
        raise AssertionError(f"fp16: non-finite loss {losses}")
    before = [init] + box["after"][:-1]
    glob, batches = _data_batches(cfg)
    worst, plain = steps_vs_plain(glob, before, box["after"], losses,
                                  batches, skipped)
    del plain
    # the planted overflow: skipped on the card, with no host read (the
    # train metrics, whose one-step-late read is a host read by design,
    # drained before it and off during it)
    b0 = batches[0]
    bad = DataBatch(data=np.full_like(b0.data, PLANT), label=b0.label)
    snap0, sc0 = _snap(tr), _scaler(tr)
    tr._drain_pending_metric()
    eval_train, tr.eval_train = tr.eval_train, 0
    # the detector sees a host read: one .item() is one sync
    probe = _host_syncs(lambda: torch.ones((), device=tr.device).item())
    syncs = _host_syncs(lambda: tr.update(bad))
    tr.eval_train = eval_train
    if len(probe) != 1:
        raise AssertionError(f"the sync detector saw {probe} in one .item()")
    snap1, sc1 = _snap(tr), _scaler(tr)
    want = (max(sc0[0] / 2, tr.optimizer.ls_min), 0)
    kept = _bits_equal(snap0, snap1)
    if sc1 != want or not kept or syncs:
        raise AssertionError(f"planted overflow: scale {sc0} -> {sc1} "
                             f"(want {want}), masters and momenta "
                             f"bit-unchanged {kept}, host syncs {syncs}")
    tr.update(batches[1])
    snap2, sc2 = _snap(tr), _scaler(tr)
    moved = not _bits_equal(snap1, snap2)
    finite = all(np.isfinite(x).all() for x in _flat_np(snap2[0]))
    if sc2 != (sc1[0], 1) or not moved or not finite:
        raise AssertionError(f"after the overflow, a clean batch: scale "
                             f"{sc2}, applied {moved}, finite {finite}")
    step_ms = time_forward(lambda: tr.update(batches[2]), reps=10)
    del tr
    # the scale's growth: loss_scale_window = 2 from the skipped state
    t2 = Trainer(glob + [("loss_scale_window", "2"), ("silent", "1")])
    _load(t2, snap1, steps + 1)
    grow = [_scaler(t2)]
    for b in batches[2:4]:
        t2.update(b)
        grow.append(_scaler(t2))
    del t2
    torch.cuda.empty_cache()
    s1 = sc1[0]
    if grow != [(s1, 0), (s1, 1), (2 * s1, 0)]:
        raise AssertionError(f"loss_scale_window = 2: scale, good {grow}")
    print(f"fp16: {steps} steps of full-width Inception-BN (batch "
          f"{TRAIN_BATCH}, compute_dtype = float16, SGD momentum) through "
          f"main.run in {took:.1f}s | losses {[round(v, 4) for v in losses]}"
          f" | scale, good after each step {scales[1:]}; applies skipped "
          f"{sorted(i + 1 for i in skipped) or 'none'} | launches per step: "
          f"bn_fwd {launches['bn_fwd'] // steps}, bn_bwd "
          f"{launches['bn_bwd'] // steps}, sgd_apply "
          f"{launches['sgd_apply'] // steps} (phase 6's) | "
          f"{_steps_line(worst, 'f16')} | planted overflow (inputs "
          f"{PLANT:g}): "
          f"scale {sc0} -> {sc1}, masters and momenta bit-unchanged, "
          f"{len(syncs)} host syncs in the step (CUDA sync debug mode); next "
          f"clean batch applies, finite masters, scale {sc2} | "
          f"loss_scale_window = 2: {grow} | step {step_ms:.3f} ms in float16"
          f" beside phase 6's {bf16_step_ms:.3f} ms in bf16", flush=True)
    return {"losses": losses, "scales": scales[1:],
            "skipped": sorted(i + 1 for i in skipped), "worst": worst,
            "planted": {"scale": [sc0, sc1], "host_syncs": syncs,
                        "next": sc2}, "window2": grow,
            "step_ms": step_ms, "bf16_step_ms": bf16_step_ms,
            "seconds": took}


def _accum_np(tr):
    """A host copy of the trainer's accumulator, JAX layout."""
    from cxxnet_tpu_torch.convert import params_to_jax
    return params_to_jax(tr.accum, {})[0]


def phase_accum(seed: int, tmp: str) -> dict:
    """Full-width AlexNet with ``update_period = 2`` at batch 128 (bf16)
    through main.run: the masters bit-unchanged after a mid-period
    step, each step against fused_kernels = 0 from the same state and
    accumulator, ``epoch_counter`` 2 after 4 steps, the two kinds of
    step timed."""
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.optim import tree_map
    from cxxnet_tpu_torch.trainer import Trainer
    conf, _, image, per_step = CONVNETS["alexnet"]
    steps = CONVNET_STEPS
    cfg = train_cfg(conf, seed, os.path.join(tmp, "accum"),
                    (f"seed={seed}", f"update_period={ACCUM_PERIOD}"),
                    batch=ACCUM_BATCH, steps=steps, image=image)
    box = {"counts": [], "losses": [], "after": []}

    def on_step(tr):
        box["counts"].append({k.name: k.launches for k in KERNELS.values()})
        box["losses"].append(tr.last_loss)
        box["after"].append((_snap(tr), _accum_np(tr)))

    accum0 = {}
    tr, launches, init, took = _train_run(
        cfg, on_step, wrap=lambda t: accum0.update(a=_accum_np(t)))
    if len(box["losses"]) != steps or (tr.epoch_counter,
                                       tr.sample_counter) != (2, 0):
        raise AssertionError(f"accum: {len(box['losses'])} steps, epoch "
                             f"{tr.epoch_counter}, sample "
                             f"{tr.sample_counter}")
    groups = len(tr.optimizer._groups(tr.params))
    prev = {k: 0 for k in launches}
    for i, after in enumerate(box["counts"]):
        want = dict(per_step, sgd_apply=groups if i % 2 else 0)
        check_launches(f"accum step {i + 1}",
                       {k: after[k] - prev[k] for k in after}, want,
                       {"epilogue_fwd": 1, "epilogue_bwd": 1})
        prev = after
    before = [(init, accum0["a"])] + box["after"][:-1]
    kept = [_bits_equal(before[i][0], box["after"][i][0])
            for i in range(0, steps, 2)]
    if not all(kept):
        raise AssertionError(f"accum: a mid-period step changed the "
                             f"masters or momenta: {kept}")
    glob, batches = _data_batches(cfg)
    plain = Trainer(glob + [("fused_kernels", "0"), ("silent", "1")])
    rows = []
    for i, b in enumerate(batches):
        (snap, acc), (after, acc_after) = before[i], box["after"][i]
        _load(plain, snap, i // ACCUM_PERIOD, step=i)
        plain.accum = tree_map(lambda v: v.to(plain.device),
                               params_from_jax(acc, {})[0])
        plain.sample_counter = i % ACCUM_PERIOD
        plain.update(b)
        lk = box["losses"][i]
        dl = abs(plain.last_loss - lk) / max(1.0, abs(lk))
        if i % ACCUM_PERIOD == 0:         # mid-period: the accumulator
            g, w = _leafs(acc_after), _leafs(_accum_np(plain))
            rels = [(_rel(g[k], w[k]), k) for k in w]
        else:                             # the apply
            rels, _ = _step_rels(after, _snap(plain), snap)
        rows.append((dl, float(np.median([r for r, _ in rels])), max(rels)))
    del plain
    fails = [f"step {i + 1}: {r}" for i, r in enumerate(rows)
             if r[0] > CONVNET_LOSS_TOL["bfloat16"]
             or r[1] > CONVNET_GRAD_TOL["bfloat16"][0]
             or r[2][0] > CONVNET_GRAD_TOL["bfloat16"][1]]
    if fails:
        raise AssertionError(f"accum: kernels vs fused_kernels=0 from the "
                             f"same state and accumulator: {fails}")
    # the mid-period step (forward, backward, accumulate) and the apply
    times = {0: [], 1: []}
    for r in range(12):
        which = tr.sample_counter
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        tr.update(batches[r % steps])
        e.record()
        e.synchronize()
        if r >= 2:
            times[which].append(a.elapsed_time(e))
    mid_ms, apply_ms = (statistics.median(times[k]) for k in (0, 1))
    del tr
    torch.cuda.empty_cache()
    fmt = [(f"{dl:.2g}", f"{md:.2g}", f"{w[0]:.2g} {w[1]}")
           for dl, md, w in rows]
    print(f"accum: {steps} steps of full-width AlexNet (batch "
          f"{ACCUM_BATCH}, update_period = {ACCUM_PERIOD}, bf16, SGD) "
          f"through main.run in {took:.1f}s | losses "
          f"{[round(v, 4) for v in box['losses']]} | epoch_counter 2, "
          f"masters and momenta bit-unchanged after steps 1 and 3 | "
          f"launches per step {per_step} each step, sgd_apply 0 at steps "
          f"1 and 3 and {groups} at steps 2 and 4 | vs fused_kernels=0 from "
          f"the same state and accumulator, per step (loss diff, rel L2 "
          f"median, worst leaf: of the accumulator at steps 1 and 3, of the "
          f"update at 2 and 4): {fmt} (tol loss "
          f"{CONVNET_LOSS_TOL['bfloat16']}, (median, worst) "
          f"{CONVNET_GRAD_TOL['bfloat16']}) | mid-period step {mid_ms:.3f} "
          f"ms, apply step {apply_ms:.3f} ms (CUDA events, median of 5)",
          flush=True)
    return {"losses": box["losses"], "checks": rows, "mid_ms": mid_ms,
            "apply_ms": apply_ms, "seconds": took}


def phase_chain(conf: str, seed: int, tmp: str) -> dict:
    """Full-width Inception-BN (bf16) with ``train_chain = 4`` through
    main.run over one round of 10 batches (two chains, a tail of two
    ``update()`` calls), held bit for bit against 10 sequential
    ``update()`` calls from the same init, with cuDNN deterministic."""
    from cxxnet_tpu_torch.trainer import Trainer
    cfg = train_cfg(conf, seed, os.path.join(tmp, "chain"),
                    (f"train_chain={CHAIN_K}",), steps=CHAIN_BATCHES)
    box = {"losses": [], "calls": []}

    def wrap(tr):
        update, chain = tr.update, tr.update_chain_batches

        def one(b):
            update(b)
            box["losses"].append(tr.last_loss)
            box["calls"].append(1)

        def many(bs):
            losses = chain(bs)
            box["losses"] += losses.tolist()
            box["calls"].append(len(bs))
            return losses
        tr.update, tr.update_chain_batches = one, many

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        tr, launches, init, took = _train_run(cfg, wrap=wrap)
        train_launches("chain", launches, CHAIN_BATCHES)
        if box["calls"] != [CHAIN_K, CHAIN_K, 1, 1]:
            raise AssertionError(f"chain: dispatches {box['calls']}")
        glob, batches = _data_batches(cfg)
        seq = Trainer([kv for kv in glob if kv[0] != "train_chain"]
                      + [("silent", "1")])
        seq.init_model((init[0], init[2]))
        want = []
        for b in batches:
            seq.update(b)
            want.append(seq.last_loss)
        got, ref = _snap(tr), _snap(seq)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    diff = max(float(np.abs(x - y).max()) for x, y in zip(
        _flat_np(got[0]) + _flat_np(got[1]["mom"]) + _flat_np(got[2]),
        _flat_np(ref[0]) + _flat_np(ref[1]["mom"]) + _flat_np(ref[2])))
    same_loss = box["losses"] == want
    if not same_loss or diff != 0.0:
        raise AssertionError(f"chain vs sequential (cuDNN deterministic): "
                             f"losses equal {same_loss} ({box['losses']} vs "
                             f"{want}), largest master/momentum/BN difference"
                             f" {diff}")
    counters = (tr.step_count, tr.epoch_counter)
    del tr, seq
    torch.cuda.empty_cache()
    print(f"chain: full-width Inception-BN (batch {TRAIN_BATCH}, bf16) with "
          f"train_chain = {CHAIN_K} through main.run over {CHAIN_BATCHES} "
          f"batches in {took:.1f}s: dispatches {box['calls']} (two chains, "
          f"a tail of two update() calls), step and epoch counters "
          f"{counters} | launches per step: bn_fwd "
          f"{launches['bn_fwd'] // CHAIN_BATCHES}, bn_bwd "
          f"{launches['bn_bwd'] // CHAIN_BATCHES}, sgd_apply "
          f"{launches['sgd_apply'] // CHAIN_BATCHES} (phase 6's) | against "
          f"{CHAIN_BATCHES} sequential update() calls from the same init, "
          f"cuDNN deterministic: losses bit-equal "
          f"{[round(v, 4) for v in want]}, masters, momenta and BN "
          f"statistics bit-equal", flush=True)
    return {"losses": want, "dispatches": box["calls"], "seconds": took,
            "bit_equal": True}


def phase_lm_fp16(seed: int, tmp: str, bf16_step_ms: float) -> dict:
    """The long-context LM with ``compute_dtype = float16`` (Adam)
    through main.run: phase 7's launches, each step's gradients against
    fused_kernels = 0 from the same state, the step timed beside
    phase 7's bf16 step."""
    from cxxnet_tpu_torch.trainer import Trainer
    cfg = lm_cfg(seed, os.path.join(tmp, "lm16"), ("compute_dtype=float16",))
    box = {"losses": [], "after": [], "scales": []}

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        box["scales"].append(_scaler(tr))
        box["after"].append(_snap(tr))

    tr, launches, init, took = _train_run(cfg, on_step)
    steps = len(box["losses"])
    mha = [l for l in tr.net.layers if l.spec.type == "mha"]
    groups = len(tr.optimizer._groups(tr.params))
    skipped = [i + 1 for i, (_, good) in enumerate(box["scales"])
               if good == 0]
    want = {"flash_fwd": 2 * len(mha) * steps,
            "flash_bwd_dq": len(mha) * steps,
            "flash_bwd_dkv": len(mha) * steps,
            "adam_apply": groups * (steps - len(skipped))}
    if steps != LM_STEPS or skipped:
        raise AssertionError(f"lm fp16: {steps} steps, skipped applies "
                             f"{skipped} (scale, good {box['scales']})")
    check_launches("lm fp16", launches, want, {})
    glob, batches = _data_batches(cfg)
    quiet = [("silent", "1")]
    kern = Trainer(glob + quiet)
    plain = Trainer(glob + quiet + [("fused_kernels", "0")])
    snaps = [init] + box["after"][:-1]
    rows = []
    for i, b in enumerate(batches[:steps]):
        dl, rels, kmove, _ = lm_step_check(kern, plain, snaps[i], b, i,
                                           "float16")
        rows.append((dl, float(np.median([r for r, _ in rels])), max(rels),
                     kmove))
    fails = [f"step {i + 1}: {r}" for i, r in enumerate(rows)
             if r[0] > LM_LOSS_TOL["float16"]
             or r[2][0] > LM_GRAD_TOL["float16"] or r[3] > 1 + 1e-3]
    if fails:
        raise AssertionError(f"lm fp16 kernels vs fused_kernels=0: {fails}")
    _load(kern, snaps[0], 0)
    step_ms = time_forward(lambda: kern.update(batches[0]), reps=10)
    del tr, kern, plain
    torch.cuda.empty_cache()
    fmt = [(f"{dl:.2g}", f"{md:.2g}", f"{w[0]:.2g} {w[1]}", f"{km:.2g}")
           for dl, md, w, km in rows]
    print(f"lm fp16: {steps} steps of the long-context LM with "
          f"compute_dtype = float16 (Adam) through main.run in {took:.1f}s "
          f"| losses {[round(v, 4) for v in box['losses']]} | scale, good "
          f"{box['scales']}, no apply skipped | launches "
          f"{ {k: launches[k] for k in want} } (per step 2 / 1 / 1 / "
          f"{groups}, phase 7's) | vs fused_kernels=0 from the same state, "
          f"per step (loss diff of max(1,|loss|), gradient rel L2 median, "
          f"worst leaf, k-bias move over the Adam step bound): {fmt} (tol "
          f"loss {LM_LOSS_TOL['float16']}, gradient "
          f"{LM_GRAD_TOL['float16']}, k bias 1.001) | step {step_ms:.3f} ms "
          f"in float16 (Adam reads the skip flag on the host once per "
          f"apply) beside phase 7's {bf16_step_ms:.3f} ms in bf16",
          flush=True)
    return {"losses": box["losses"], "scales": box["scales"],
            "checks": rows, "step_ms": step_ms,
            "bf16_step_ms": bf16_step_ms, "seconds": took}


def fp16_kernel_times(gen: torch.Generator, conf: str) -> dict:
    """CUDA-graph times of the float16 training path's kernels beside the
    same kernels in bf16 on the same data (both 2-byte types: one bound):
    ``bn_fwd`` and ``bn_bwd`` at bn_stem1 (relu), ``pool_fwd`` and
    ``pool_bwd`` at the 7x7 global average of batch 128, the fc1
    epilogue forward and backward; and ``sgd_apply`` over Inception-BN's
    groups with the skip flag (clear) beside without it. Prints one
    line; returns {kernel: {dtype: ms}, "bound": ms}."""
    from cxxnet_tpu_torch.ops.fused_epilogue import (fused_bias_act,
                                                     fused_epilogue_bwd)
    from cxxnet_tpu_torch.ops.fused_norm import bn_bwd, bn_fwd
    from cxxnet_tpu_torch.ops import fused_optim
    from cxxnet_tpu_torch.ops.fused import stream_handle
    from cxxnet_tpu_torch.ops.fused_pool import fused_pool, fused_pool_bwd_lin
    dev = gen.device
    n, c = TRAIN_BATCH * 112 * 112, 64                  # bn_stem1
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    g, be = rnd((c,)).abs() + 0.5, rnd((c,)) * 0.1
    bias = rnd((1000,))
    out = {}
    for dt in (torch.float16, torch.bfloat16):
        name = str(dt)[6:]
        x, dy = (rnd((n, c)).to(dt) for _ in range(2))
        y, mean, _, rstd = bn_fwd(x, g, be, 1e-5, "relu")
        xp = rnd((TRAIN_BATCH, 7, 7, 1024)).to(dt)
        dyp = rnd((TRAIN_BATCH, 1, 1, 1024)).to(dt)
        xf, dyf = rnd((TRAIN_BATCH, 1000)).to(dt), rnd((TRAIN_BATCH,
                                                         1000)).to(dt)
        for k, fn in (
                ("bn_fwd", lambda: bn_fwd(x, g, be, 1e-5, "relu")),
                ("bn_bwd", lambda: bn_bwd(x, dy, y, g, mean, rstd)),
                ("pool_fwd", lambda: fused_pool(xp, 7, 7, "sum", True,
                                                False)),
                ("pool_bwd", lambda: fused_pool_bwd_lin(dyp, 7, 7, True)),
                ("epilogue_fwd", lambda: fused_bias_act(xf, bias, "none")),
                ("epilogue_bwd", lambda: fused_epilogue_bwd(
                    xf, dyf, "none", True))):
            out.setdefault(k, {})[name] = time_call(fn)
        del x, dy, y
    _, groups = flagship_shapes(conf)
    ws, gs, ms = ([rnd(sh) for sh in groups["wmat"]] for _ in range(3))
    # the table made once, outside the captured graph, as phase 6 times it
    table, nblk = fused_optim._table(ws, gs, ms)
    clear = torch.zeros((), dtype=torch.int32, device=dev)
    out["sgd_apply"] = {
        what: time_call(lambda: fused_optim.SGD_APPLY.launch(
            table.data_ptr(), len(ws), nblk, fused_optim.CHUNK, 0.1, 0.9,
            1e-4, 0.0, 0, flag, stream_handle(dev)))
        for what, flag in (("no flag", None),
                           ("flag clear", clear.data_ptr()))}
    print("times (f16): " + " | ".join(
        f"{k} " + ", ".join(f"{d} {v * 1e3:.2f} us" for d, v in r.items())
        for k, r in out.items()) + f" (bn at bn_stem1 ({n},{c}) relu, "
        f"pools and fc1 at batch {TRAIN_BATCH}; sgd_apply over "
        f"Inception-BN's wmat group)", flush=True)
    return out


def phase_rest(conf: str, seed: int, tmp: str, train_step_ms: float,
               lm_step_ms: float, gen: torch.Generator) -> dict:
    """Phase 15: float16 Inception-BN, AlexNet under update_period,
    Inception-BN in chains, the float16 LM, the float16 kernel times."""
    return {"fp16": phase_fp16(conf, seed, tmp, train_step_ms),
            "accum": phase_accum(seed, tmp),
            "chain": phase_chain(conf, seed, tmp),
            "lm_fp16": phase_lm_fp16(seed, tmp, lm_step_ms),
            "kernels_f16": fp16_kernel_times(gen, conf)}


# -- phase 16 -----------------------------------------------------------------

#: the LM plane's knobs at the long-context LM's full width: 8 rows of
#: 2048 tokens fill the pool exactly (8 * 128 blocks of 16, and scratch)
LMS_KNOBS = (("kv_block_size", "16"), ("kv_pool_blocks", "1025"),
             ("lm_serve_max_seqs", "8"), ("lm_serve_max_context", "2048"),
             ("lm_serve_prefill_chunk", "128"),
             ("lm_serve_max_new_tokens", "64"))
LMS_PROMPTS = (24, 64, 1536)    # (c): prompts, shortest, longest
LMS_CLIENTS = (16, 64, 960)     # (d): 16 clients x 64 blocks = the pool
LMS_IN_FLIGHT = 10              # (c), (e): 10 x 100 blocks < the pool
LMS_NEW = 64
#: (b): of max(1, |log-prob|). The round (4 Adam steps from the init) is
#: near uniform, so a faulty step moves its log-probs little: the bf16
#: bound sits 10x over the sound bf16 reading and guards against gross
#: faults; the f32 bound sits between the sound f32 reading and the
#: controls', which must exceed it (PERF.md section 6, PR 20)
LMS_LOGIT_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
LMS_MARGIN = 0.05               # (b): top-1 held where the margin exceeds


def lm_prompts(seed: int, spec):
    n, lo, hi = spec
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 64, size=rs.randint(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


def lm_prefill_last(lme, prompt, cut: int = 0):
    """A prompt prefilled chunk by chunk through ``lme.step`` on blocks of
    its own (freed after): the greedy token and the f32 logits at its
    last position. ``cut = 1`` is (b)'s first control: each chunk's
    ``lengths`` one short, so the chunk's last key and value go to the
    scratch block, its last query loses its own key, and later chunks
    read a stale slot in its place."""
    pool = lme.block_pool
    need = pool.blocks_for_tokens(prompt.size)
    blocks = pool.alloc(need, seq_id=-2)
    table = np.zeros((lme.T,), np.int32)
    table[:need] = blocks
    try:
        p0, C = 0, lme.chunk
        while p0 < prompt.size:
            c = min(C, prompt.size - p0)
            ids = np.zeros((1, C), np.int32)
            ids[0, :c] = prompt[p0:p0 + c]
            tok, last = lme.step(ids, (p0 + np.arange(C))[None], table[None],
                                 [p0 + c - cut], [c - 1])
            p0 += c
        return int(tok[0]), last[0].float().cpu()
    finally:
        pool.free(blocks)


@contextlib.contextmanager
def lm_last_block_dropped(lme):
    """(b)'s second control: while open, the LM step's paged attention
    reads no key of a row's last block (``lengths`` cut to the block's
    start; a row inside its first block keeps its first key)."""
    from cxxnet_tpu_torch.serve.lm import engine as lm_engine
    sound, bs = lm_engine.paged_attention, lme.block_size

    def dropped(q, kp, vp, tables, q_pos, lengths):
        cut = torch.clamp((lengths - 1) // bs * bs, min=1)
        return sound(q, kp, vp, tables, q_pos, cut)

    lm_engine.paged_attention = dropped
    try:
        yield
    finally:
        lm_engine.paged_attention = sound


def lm_logit_err(last, ref) -> float:
    """(b)'s reading: the largest |log-prob error| over max(1, |ref|)."""
    last = torch.log_softmax(last, dim=-1)
    return float(((last - ref).abs() / ref.abs().clamp_min(1.0)).max())


def lm_logit_readings(eng, lme, prompts) -> dict:
    """(b) in ``lme``'s compute dtype: each prompt's last-position
    log-probabilities from the chunked prefill against the eval forward of
    ``eng``'s network over batches of 8 padded to S (its mha through
    ``flash_fwd``, launches counted), as ``lm_logit_err``; top-1 held where
    the forward's margin exceeds LMS_MARGIN; the same reading of the two
    controls."""
    from cxxnet_tpu_torch.ops import KERNELS
    S = eng.net.graph.input_shape[2]
    fwd = []
    flash0 = KERNELS["flash_fwd"].launches
    for i in range(0, len(prompts), 8):
        x = np.zeros((8, 1, 1, S), np.float32)
        for j, p in enumerate(prompts[i:i + 8]):
            x[j, 0, 0, :p.size] = p
        # the forward's output: lmloss's log-probabilities of the head
        logp = eng.net(torch.from_numpy(x).to(lme.device)).out
        fwd += [logp[j, p.size - 1, 0].float().cpu()
                for j, p in enumerate(prompts[i:i + 8])]
    flash_n = KERNELS["flash_fwd"].launches - flash0
    if flash_n != len(lme.pools) * -(-len(prompts) // 8):
        raise AssertionError(f"the eval forward launched flash_fwd "
                             f"{flash_n} times")
    out = {"worst": 0.0, "held": 0, "flips": [], "firsts": [],
           "flash_fwd": flash_n}
    for i, p in enumerate(prompts):
        tok, last = lm_prefill_last(lme, p)
        out["firsts"].append(tok)
        ref = fwd[i]
        if not bool(torch.isfinite(last).all()):
            raise AssertionError(f"prompt {i}: non-finite prefill logits")
        out["worst"] = max(out["worst"], lm_logit_err(last, ref))
        top2 = torch.topk(ref, 2).values
        if float(top2[0] - top2[1]) > LMS_MARGIN:
            out["held"] += 1
            if int(torch.argmax(last)) != int(torch.argmax(ref)):
                out["flips"].append(i)
    out["controls"] = {"own key masked": max(
        lm_logit_err(lm_prefill_last(lme, p, cut=1)[1], fwd[i])
        for i, p in enumerate(prompts))}
    with lm_last_block_dropped(lme):
        out["controls"]["last block dropped"] = max(
            lm_logit_err(lm_prefill_last(lme, p)[1], fwd[i])
            for i, p in enumerate(prompts))
    return out


def paged_attention_check(gen: torch.Generator, lme) -> dict:
    """(a): ``paged_attention`` on the card at the path's decode (8, 1)
    and prefill (1, 128) shapes over the full pool and shuffled tables,
    against ``attention_reference`` in f32 over the same gathered keys
    and queries (rounded to bf16 for the bf16 case): f32 within 1e-5 of
    max(1, max|ref|), bf16 within one bf16 ulp of it; the decode call
    timed in a CUDA graph."""
    from cxxnet_tpu_torch.ops.attention import (attention_reference,
                                                paged_attention)
    dev = gen.device
    N, bs = lme.num_blocks, lme.block_size
    _, pool = next(iter(lme.pools.items()))
    H, D = pool["k"].shape[2:]
    T, B = lme.T, lme.max_seqs
    rs = np.random.RandomState(5)
    kp = torch.randn((N, bs, H, D), generator=gen, device=dev)
    vp = torch.randn((N, bs, H, D), generator=gen, device=dev)
    tables = torch.from_numpy(rs.permutation(np.arange(1, N))[:B * T]
                              .reshape(B, T).astype(np.int64)).to(dev)
    lengths = torch.from_numpy(np.concatenate([
        [T * bs, 1], rs.randint(2, T * bs, B - 2)]).astype(np.int64)).to(dev)
    out, worst = {}, {}
    for what, q_pos, lens, rows in (
            ("decode (8,1)", (lengths - 1)[:, None], lengths, B),
            ("prefill (1,128)", 1024 + torch.arange(lme.chunk, device=dev)
             [None], torch.tensor([1024 + lme.chunk], device=dev), 1)):
        q = torch.randn((rows, q_pos.shape[1], H, D), generator=gen,
                        device=dev)
        tabs = tables[:rows]
        got = {dt: paged_attention(q.to(dt), kp.to(dt), vp.to(dt), tabs,
                                   q_pos, lens).float()
               for dt in (torch.float32, torch.bfloat16)}
        errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for b in range(rows):
            n = int(lens[b])
            kg = kp[tabs[b]].reshape(-1, H, D)[:n][None]
            vg = vp[tabs[b]].reshape(-1, H, D)[:n][None]
            Q = q_pos.shape[1]
            qf = torch.zeros((1, n, H, D), device=dev)
            qf[0, n - Q:] = q[b]                # queries at n-Q .. n-1
            for dt in (torch.float32, torch.bfloat16):
                # the reference in f32 over the inputs rounded to dt
                ref = attention_reference(
                    *(t.to(dt).float() for t in (qf, kg, vg)),
                    causal=True)[0, n - Q:]
                scale = max(1.0, float(ref.abs().max()))
                tol = (1e-5 if dt == torch.float32 else 2.0 ** -7) * scale
                e = float((got[dt][b] - ref).abs().max())
                errs[dt] = max(errs[dt], e)
                if not e <= tol:
                    raise AssertionError(
                        f"paged_attention {what} {dt} row {b} (length {n}): "
                        f"max|err| {e:.3g} > {tol:.3g}")
        worst[what] = {str(dt)[6:]: e for dt, e in errs.items()}
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    qb = torch.randn((B, 1, H, D), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    out["decode_ms"] = time_call(lambda: paged_attention(
        qb, kb, vb, tables, (lengths - 1)[:, None], lengths), inner=20)
    out["max_abs_err"] = worst
    return out


def lm_run_clients(submit, prompts, in_flight: int):
    """Each prompt through ``submit(prompt) -> handle`` with at most
    ``in_flight`` sequences live at once (a finished one lets the next
    in): the terminal events in prompt order."""
    outs = [None] * len(prompts)
    sem = threading.Semaphore(in_flight)

    def one(i):
        try:
            outs[i] = submit(prompts[i]).result(timeout=300)
        except BaseException as e:          # reported by the caller
            outs[i] = e
        finally:
            sem.release()

    threads = []
    for i in range(len(prompts)):
        sem.acquire()
        t = threading.Thread(target=one, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=600)
    bad = [(i, o) for i, o in enumerate(outs)
           if not isinstance(o, dict) or o.get("event") != "done"]
    if bad:
        raise AssertionError(f"sequences failed: {bad[:4]}")
    return [o["tokens"] for o in outs]


def _stream_client(base: str, prompt, stream: int, box: dict) -> None:
    """One /generate client: its tokens, and the times of its events."""
    t0 = time.perf_counter()
    req = urllib.request.Request(
        base + "/generate", headers={"Content-Type": "application/json"},
        data=json.dumps({"prompt": prompt.tolist(), "max_new": LMS_NEW,
                         "stream": stream}).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            if not stream:
                box["tokens"] = json.loads(r.read())["tokens"]
                box["t"] = [time.perf_counter() - t0]
                return
            evs, ts = [], []
            while True:
                line = r.readline()
                if not line:
                    break
                evs.append(json.loads(line))
                ts.append(time.perf_counter() - t0)
        box["events"], box["t"] = evs, ts
        box["tokens"] = evs[-1].get("tokens") if evs else None
    except BaseException as e:              # reported by the caller
        box["error"] = repr(e)


def _pcts(v):
    return (f"p50 {np.percentile(v, 50):.2f} ms, p99 "
            f"{np.percentile(v, 99):.2f} ms")


def phase_lm_serve(seed: int, tmp: str, gen: torch.Generator,
                   smi_line: str) -> dict:
    """Phase 16: serve the LM phase's round through the LM plane at
    full width; checks (a)-(f) of the docstring, then the times."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import parse_lm_serve_config
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.serve import (Backpressure, DeadlineExceeded,
                                        InferenceEngine, ServeServer)
    from cxxnet_tpu_torch.serve.lm import LMEngine, LMScheduler
    t_phase = time.perf_counter()
    model = ckpt.model_path(os.path.join(tmp, "lm"), 0)
    eng = InferenceEngine.from_checkpoint(_serve_cfg(LM_CONF, []), model,
                                          buckets="1", max_batch=1)
    cfg = parse_lm_serve_config(list(LMS_KNOBS))
    lme = LMEngine(eng, cfg)
    if lme.device.type != "cuda" or \
            {p[w].device.type for p in lme.pools.values() for w in "kv"} \
            != {"cuda"}:
        raise AssertionError(f"the LM plane is not on the card: "
                             f"{lme.device}")
    notes = {"version": eng.weights_version}

    # (a) paged attention on the card
    notes["paged_attention"] = paged_attention_check(gen, lme)

    # (b) prefill logits against the training network's eval forward, in
    # the round's bf16 and again in f32, where the controls must fail
    prompts = lm_prompts(seed + 16, LMS_PROMPTS)
    reads = {"bfloat16": lm_logit_readings(eng, lme, prompts)}
    eng32 = InferenceEngine.from_checkpoint(
        _serve_cfg(LM_CONF, ["compute_dtype=float32"]), model, buckets="1",
        max_batch=1)
    lme32 = LMEngine(eng32, cfg)
    reads["float32"] = lm_logit_readings(eng32, lme32, prompts)
    lme32.close()
    print("lm serve (b): prefill log-probs vs the eval forward, worst of "
          "max(1,|log-prob|), sound and controls: " + "; ".join(
              f"{dt} {r['worst']:.4g}, "
              f"{ {k: float(f'{v:.4g}') for k, v in r['controls'].items()} }"
              f" (tol {LMS_LOGIT_TOL[dt]})" for dt, r in reads.items()),
          flush=True)
    for dt, r in reads.items():
        if r["worst"] > LMS_LOGIT_TOL[dt] or r["flips"]:
            raise AssertionError(
                f"{dt} prefill log-probs vs the eval forward (flash_fwd): "
                f"worst {r['worst']:.3g} of max(1,|log-prob|) (tol "
                f"{LMS_LOGIT_TOL[dt]}); top-1 differs on prompts "
                f"{r['flips']}")
    blind = {k: v for k, v in reads["float32"]["controls"].items()
             if not v > LMS_LOGIT_TOL["float32"]}
    if blind:
        raise AssertionError(f"check (b) passes faulty f32 steps: {blind} "
                             f"within {LMS_LOGIT_TOL['float32']}")
    firsts, held = reads["bfloat16"]["firsts"], reads["bfloat16"]["held"]
    worst_b = reads["bfloat16"]["worst"]
    flash_n = reads["bfloat16"]["flash_fwd"]

    # (c) continuous batching bit-equal to the whole-request path
    t0 = time.perf_counter()
    ref_tokens = [lme.generate_whole(p, max_new=LMS_NEW) for p in prompts]
    whole_s = time.perf_counter() - t0
    if [r[0] for r in ref_tokens] != firsts:
        raise AssertionError("generate_whole's first tokens differ from "
                             "the prefill's")
    warm = lme.compile_info()["misses"]
    sched = LMScheduler(lme, cfg)
    sched.start()
    try:
        t0 = time.perf_counter()
        got = lm_run_clients(lambda p: sched.submit(p, max_new=LMS_NEW),
                             prompts, LMS_IN_FLIGHT)
        sched_s = time.perf_counter() - t0
        steps = sched.steps
    finally:
        sched.stop(drain=True)
    bad = [i for i, (a, b) in enumerate(zip(got, ref_tokens)) if a != b]
    if bad or lme.block_pool.used or lme.compile_info()["misses"] != warm:
        raise AssertionError(
            f"scheduler vs generate_whole: prompts {bad} differ; blocks "
            f"used {lme.block_pool.used}; misses "
            f"{lme.compile_info()['misses']} (warm-up {warm})")

    # timings at 8 live rows, then launches per decode step
    B, T = cfg.max_seqs, lme.T
    blocks = lme.block_pool.alloc(B * T, seq_id=-3)
    tables = np.asarray(blocks, np.int32).reshape(B, T)
    ids = np.asarray([p[0] for p in prompts[:B]], np.int32)
    L = np.full((B,), 1500, np.int32)
    decode = lambda: lme.run_decode(ids, L, tables, L + 1)
    decode_ms = time_forward(decode)
    chunk = prompts[0][:lme.chunk].copy()
    prefill_ms = time_forward(lambda: lme.run_prefill(
        tables[0], chunk, 1024, lme.chunk))
    prof = profile_kinds(decode, n=20, what="decode step")[0]
    lme.block_pool.free(blocks)

    # (d) 16 concurrent /generate clients over loopback
    dprompts = lm_prompts(seed + 17, LMS_CLIENTS)
    dref = [lme.generate_whole(p, max_new=LMS_NEW) for p in dprompts]
    srv = ServeServer(eng, port=0, silent=True, handle_signals=False)
    srv.start()
    try:
        srv.attach_lm(cfg)
        srv.lm.engine.generate_whole(dprompts[0], max_new=2)   # warm-up
        d_warm = srv.lm.engine.compile_info()["misses"]
        base = f"http://127.0.0.1:{srv.port}"
        boxes = [{} for _ in dprompts]
        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(
            target=_stream_client, args=(base, p, i % 2 == 0, boxes[i]),
            daemon=True) for i, p in enumerate(dprompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        http_s = time.perf_counter() - t0
        hand = {k.name: k.launches for k in KERNELS.values() if k.launches}
        for _ in range(500):
            if srv.lm.live_count() == 0:
                break
            time.sleep(0.01)
        statz = _get(base + "/statz")
        d_misses = srv.lm.engine.compile_info()["misses"]
    finally:
        srv.stop()
    fails = [(i, b.get("error")) for i, b in enumerate(boxes)
             if "error" in b or b.get("tokens") != dref[i]]
    order = [i for i, b in enumerate(boxes) if "events" in b and not (
        b["events"][0]["event"] == "token" and b["events"][-1]["event"]
        == "done" and len(b["events"]) == LMS_NEW + 1)]
    lm_statz = statz.get("lm", {})
    if fails or order or lm_statz.get("kv_blocks_used") != 0 \
            or d_misses != d_warm or hand:
        raise AssertionError(
            f"/generate: failed or wrong tokens {fails}; event order "
            f"{order}; /statz lm {lm_statz}; misses {d_misses} (warm-up "
            f"{d_warm}); hand-kernel launches {hand} (the LM step has none)")
    streamed = [b for b in boxes if "events" in b]
    ttft = [1e3 * b["t"][0] for b in streamed]
    itl = [1e3 * (b2 - b1) for b in streamed
           for b1, b2 in zip(b["t"][:-2], b["t"][1:-1])]
    n_tok = sum(len(b["tokens"]) for b in boxes)

    # (e) prefill -> decode handoff on the same card
    pre, dec = LMEngine(eng, cfg), LMEngine(eng, cfg)
    d_sched = LMScheduler(dec, cfg, role="decode")
    d_sched.start()
    p_sched = LMScheduler(pre, cfg, role="prefill",
                          peer=d_sched.handoff_addr)
    p_sched.start()
    try:
        t0 = time.perf_counter()
        hgot = lm_run_clients(lambda p: p_sched.submit(p, max_new=LMS_NEW),
                              prompts, LMS_IN_FLIGHT)
        hand_s = time.perf_counter() - t0
    finally:
        p_sched.stop(drain=True)
        d_sched.stop(drain=True)
    hbad = [i for i, (a, b) in enumerate(zip(hgot, ref_tokens)) if a != b]
    if hbad or pre.block_pool.used or dec.block_pool.used \
            or p_sched.steps or not d_sched.steps:
        raise AssertionError(
            f"handoff: prompts {hbad} differ from (c); blocks used "
            f"{pre.block_pool.used}/{dec.block_pool.used}; decode steps "
            f"{p_sched.steps}/{d_sched.steps}")
    pre.close()
    dec.close()

    # (f) a pool two long prompts cannot share, and a deadline
    long2 = sorted(range(len(prompts)), key=lambda i: -prompts[i].size)[:2]
    blocks_one = -(-(prompts[long2[0]].size + LMS_NEW) // 16)
    small_cfg = parse_lm_serve_config(
        list(LMS_KNOBS) + [("kv_pool_blocks", str(blocks_one + 1))])
    small = LMEngine(eng, small_cfg)
    s_sched = LMScheduler(small, small_cfg)
    s_sched.start()
    try:
        h_old = s_sched.submit(prompts[long2[0]], max_new=LMS_NEW)
        h_new = s_sched.submit(prompts[long2[1]], max_new=LMS_NEW)
        old = h_old.result(timeout=300)
        try:
            h_new.result(timeout=300)
            pressure = "not evicted"
        except Backpressure as e:
            pressure = str(e)
        h_dl = s_sched.submit(prompts[long2[0]], max_new=LMS_NEW,
                              deadline_ms=5.0)
        try:
            h_dl.result(timeout=300)
            deadline = "not evicted"
        except DeadlineExceeded as e:
            deadline = str(e)
        evictions = s_sched.evictions
    finally:
        s_sched.stop(drain=True)
    if old["tokens"] != ref_tokens[long2[0]] or "pressure" not in pressure \
            or "deadline" not in deadline or evictions != 2 \
            or small.block_pool.used:
        raise AssertionError(
            f"evictions: survivor equal {old['tokens'] == ref_tokens[long2[0]]}"
            f", pressure {pressure!r}, deadline {deadline!r}, evictions "
            f"{evictions}, blocks used {small.block_pool.used}")
    small.close()
    lme.close()

    took = time.perf_counter() - t_phase
    notes.update({
        "decode_step_ms": decode_ms, "prefill_chunk_ms": prefill_ms,
        "decode_profile": prof, "prefill_logit_err": worst_b,
        "prefill_logit": {dt: {k: r[k] for k in ("worst", "controls")}
                          for dt, r in reads.items()},
        "top1_held": held, "whole_s": whole_s, "sched_s": sched_s,
        "sched_steps": steps, "http_s": http_s,
        "tokens_per_s": n_tok / http_s,
        "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                    "p99": float(np.percentile(ttft, 99))},
        "itl_ms": {"p50": float(np.percentile(itl, 50)),
                   "p99": float(np.percentile(itl, 99))},
        "handoff_s": hand_s, "seconds": took, "card": smi_line})
    pa = notes["paged_attention"]
    print(f"lm serve: the LM phase's round ({notes['version']}) served at "
          f"full width (kv {cfg.kv_pool_blocks} blocks of "
          f"{cfg.kv_block_size}, {cfg.max_seqs} rows, context "
          f"{cfg.max_context}, chunk {cfg.prefill_chunk}, bf16) on "
          f"{lme.device} | (a) paged_attention vs attention_reference "
          f"over the gathered keys: {pa['max_abs_err']} (tol f32 1e-5, "
          f"bf16 2^-7 of max(1,|ref|)), decode call {pa['decode_ms']:.4f} "
          f"ms in a CUDA graph | (b) {len(prompts)} prompts "
          f"({min(p.size for p in prompts)}-{max(p.size for p in prompts)}"
          f" tokens): prefill log-probs vs the eval forward through "
          f"flash_fwd "
          f"({flash_n} launches) worst {worst_b:.3g} of max(1,|log-prob|) ("
          f"tol {LMS_LOGIT_TOL['bfloat16']}), f32 "
          f"{reads['float32']['worst']:.3g} (tol "
          f"{LMS_LOGIT_TOL['float32']}; both controls over it), top-1 "
          f"equal on all {held} with a margin > "
          f"{LMS_MARGIN} | (c) scheduler ({LMS_IN_FLIGHT} in flight, "
          f"{steps} decode steps, {sched_s:.2f}s) bit-equal to "
          f"generate_whole ({whole_s:.2f}s) on all {len(prompts)}, runner "
          f"misses {warm} | (d) {len(dprompts)} clients over HTTP "
          f"({len(streamed)} streamed, {len(dprompts) - len(streamed)} "
          f"stream=0): 0 failures, tokens equal to generate_whole, "
          f"{n_tok} tokens in {http_s:.3f}s = {n_tok / http_s:.1f} "
          f"tokens/s, TTFT {_pcts(ttft)}, inter-token {_pcts(itl)}, /statz "
          f"lm {lm_statz}, hand-kernel launches 0 | (e) prefill -> decode "
          f"handoff over loopback: all {len(prompts)} equal to (c) in "
          f"{hand_s:.2f}s | (f) pool of {blocks_one} blocks: pressure "
          f"eviction of the newer sequence, the older's tokens equal, one "
          f"deadline eviction, blocks all freed | decode step at 8 live "
          f"rows {decode_ms:.3f} ms, prefill chunk of 128 "
          f"{prefill_ms:.3f} ms (CUDA events, median of 20) | decode step "
          f"profile: {prof} | phase {took:.1f}s | {smi_line}", flush=True)
    return notes


# -- phase 17 -----------------------------------------------------------------

#: (a): the open-loop clients' request sizes (rows), cycled; 1 to 32
FLEET_SIZES = (1, 2, 1, 4, 1, 8, 3, 1, 16, 2, 1, 32)
FLEET_RATE = 2.0            # (a): requests a second, open loop
FLEET_LOAD_S = 10.0         # (a): seconds of load, for the fleet and alone
FLEET_RELOAD_S = 0.5        # (a)-(c): serve_reload_s
FLEET_CLIENTS = 8           # (a): closed-loop in-process clients
FLEET_CLOSED_S = 4.0        # (a): seconds of the closed-loop load
#: (a), (b): a fleet answer against the single engine's for the same
#: rows on its round, rel L2 of each softmax row: read 0 on the H100
#: (the bf16 forward is the same in every bucket; PERF.md section 6).
#: The control, round B's params with round A's BN state (a swap that
#: mixed a pair), must read over it against both rounds, and the two
#: rounds' rows (0.561 apart) over twice it. An answer must also lie
#: within FLEET_SEP of its distance to the other round's, so that it
#: tells the rounds apart
FLEET_ROW_TOL = 1e-3
FLEET_SEP = 0.5
LMF_PROMPTS = (8, 64, 512)  # (d): prompts, shortest, longest
LMF_MARGIN = 0.02           # (d): bf16 margin of tests/test_quant.py's bar
#: (d): the int8 LM's f32 logits of a prefill chunk and a decode step
#: against the same step with fused_kernels = 0, of max(1, |logit|):
#: q_mm is bit-equal to q_mm_plain and every other op of the step is the
#: same, so the sound reading is 0
LMF_STEP_TOL = 1e-5
#: open-loop latency: the fewest requests behind a p99 (fewer print the
#: largest instead)
P99_MIN_N = 100


def _post_bytes(url: str, body: bytes, box: dict, headers=None) -> None:
    """One /predict client: its answer (or error) and its times."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            box["prob"] = np.asarray(json.loads(r.read())["prob"],
                                     np.float32)
    except BaseException as e:              # reported by the caller
        box["error"] = repr(e)
    box["t_done"] = time.perf_counter()


def open_loop(base: str, bodies, rate: float, duration: float,
              on_half=None):
    """Open-loop /predict load: request i (body ``i % len(bodies)``) sent
    at ``i / rate`` s, each on a thread of its own, whatever the
    answers' pace; ``on_half()`` runs at half time. Returns a box a
    request: ``k`` (its body), ``t_send``, ``t_done``, ``prob`` or
    ``error``."""
    boxes, threads = [], []
    t0 = time.perf_counter()
    half_done = on_half is None
    i = 0
    while i / rate < duration:
        now = time.perf_counter() - t0
        if not half_done and now >= duration / 2:
            on_half()
            half_done = True
        if now < i / rate:
            time.sleep(min(i / rate - now, 0.05))
            continue
        box = {"k": i % len(bodies), "t_send": time.perf_counter()}
        th = threading.Thread(target=_post_bytes, daemon=True, args=(
            base + "/predict", bodies[box["k"]], box))
        th.start()
        boxes.append(box)
        threads.append(th)
        i += 1
    for th in threads:
        th.join(timeout=300)
    return boxes


def closed_loop(submit, rows, clients: int, seconds: float) -> dict:
    """``clients`` threads each submitting the next of ``rows`` and
    waiting for its answer, for ``seconds``: answers/s, rows/s and the
    latency line (:func:`_lat_line`)."""
    lat, n_rows, stop = [], [0], threading.Event()
    lock = threading.Lock()

    def client(c):
        j = c
        while not stop.is_set():
            x = rows[j % len(rows)]
            t = time.perf_counter()
            submit(x).result(timeout=300)
            with lock:
                lat.append(1e3 * (time.perf_counter() - t))
                n_rows[0] += x.shape[0]
            j += 1
    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in ts:
        t.join(timeout=300)
    took = time.perf_counter() - t0
    return {"answers_per_s": len(lat) / took, "rows_per_s": n_rows[0] / took,
            "latency": _lat_line(lat)}


def land(src: str, model_dir: str, r: int) -> str:
    """Copy round file ``src`` into ``model_dir`` as round ``r`` the way a
    trainer's writer publishes one: whole, by a rename."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    dst = ckpt.model_path(model_dir, r)
    part = os.path.join(os.path.dirname(model_dir), f"landing-{r}")
    shutil.copy(src, part)
    os.replace(part, dst)
    return dst


def fleet_rows(conf: str, seed: int):
    """The request rows of phases 17 and 18: FLEET_SIZES rows each, on a
    1/8 grid of N(0, 1)."""
    c, y, x = [int(v) for v in
               dict(_serve_cfg(conf, []))["input_shape"].split(",")]
    return [(np.round(served_rows(seed + 50 + k, n, c * y * x) * 8) / 8)
            .astype(np.float32) for k, n in enumerate(FLEET_SIZES)]


def _row_rel(got, want) -> np.ndarray:
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


def _lat_line(v) -> str:
    """p50 and p99 of ``v`` (ms) and how many values stand behind them;
    under P99_MIN_N values the largest instead of the p99."""
    if not len(v):
        return "none"
    tail = (f"p99 {np.percentile(v, 99):.1f} ms" if len(v) >= P99_MIN_N
            else f"max {np.max(v):.1f} ms")
    return f"p50 {np.percentile(v, 50):.1f} ms, {tail} over {len(v)}"


def _count_calls(obj, name: str, counter: list) -> None:
    """Wrap ``obj.name`` so that each call adds one to ``counter[0]``."""
    fn = getattr(obj, name)

    def counted(*a, **k):
        counter[0] += 1
        return fn(*a, **k)
    setattr(obj, name, counted)


def fleet_reload(conf: str, seed: int, fdir: str, dev) -> dict:
    """(a): the open-loop load on one engine, then on a 2-replica fleet
    through which a new round sweeps mid-run; closed-loop in-process
    load on both. Returns the readings and the rounds' paths."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.serve import InferenceEngine
    models, stage = os.path.join(fdir, "models"), os.path.join(fdir, "stage")
    os.makedirs(models)
    os.makedirs(stage)
    ra = write_round(conf, seed + 40, models, dev, round_counter=1)
    rb = write_round(conf, seed + 41, stage, dev, round_counter=2)
    rows = fleet_rows(conf, seed)
    bodies = [json.dumps({"data": r.tolist(), "raw": 1}).encode()
              for r in rows]
    kw = dict(buckets=",".join(map(str, BUCKETS)), max_batch=BUCKETS[-1])
    refs = {}
    for tag, path in (("a", ra), ("b", rb)):
        eng = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), path, **kw)
        refs[tag] = [eng.predict_raw(r) for r in rows]
    # the control: round B's params with round A's BN state
    eng.swap_weights(ckpt.load_for_inference(rb)["params"],
                     ckpt.load_for_inference(ra)["state"], 99)
    mixed = min(float(np.minimum(_row_rel(m, a), _row_rel(m, b)).min())
                for m, a, b in zip([eng.predict_raw(r) for r in rows],
                                   refs["a"], refs["b"]))
    del eng
    apart = min(float(_row_rel(a, b).min())
                for a, b in zip(refs["a"], refs["b"]))
    if apart < 2 * FLEET_ROW_TOL or not mixed > FLEET_ROW_TOL:
        raise AssertionError(f"rounds A and B answer too alike ({apart}), "
                             f"or the control (B's params, A's BN state) "
                             f"reads {mixed} <= {FLEET_ROW_TOL}")
    base_over = ["task=serve", f"model_in={ra}", "serve_port=0",
                 f"serve_buckets={','.join(map(str, BUCKETS))}",
                 f"serve_max_batch={BUCKETS[-1]}", "serve_max_latency_ms=2",
                 "silent=1"]
    out = {"rows": [r.shape[0] for r in rows], "apart": apart,
           "control": mixed}
    # one engine under the load
    srv, t = start_serve(_serve_cfg(conf, base_over))
    try:
        base = f"http://127.0.0.1:{srv.port}"
        t0 = time.perf_counter()
        one = open_loop(base, bodies, FLEET_RATE, FLEET_LOAD_S)
        one_s = time.perf_counter() - t0
        one_closed = closed_loop(lambda r: srv.submit(r, "raw"), rows,
                                 FLEET_CLIENTS, FLEET_CLOSED_S)
    finally:
        stop_serve(srv, t)
    # the fleet under the same load, the sweep to round B at half time
    srv, t = start_serve(_serve_cfg(conf, base_over + [
        "serve_replicas=2", f"serve_reload_s={FLEET_RELOAD_S}",
        f"model_dir={models}"]))
    pool, watcher = srv.pool, srv.reload_watcher
    sweep, fwd = [], [[0] for _ in pool.replicas]
    reload_replica = pool.reload_replica

    def timed_reload(*a, **k):
        t_start = time.perf_counter()
        try:
            return reload_replica(*a, **k)
        finally:
            sweep.append((t_start, time.perf_counter()))
    pool.reload_replica = timed_reload
    for rep, n in zip(pool.replicas, fwd):
        _count_calls(rep.engine, "run_padded", n)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        reset_launches()
        t0 = time.perf_counter()
        boxes = open_loop(base, bodies, FLEET_RATE, FLEET_LOAD_S,
                          on_half=lambda: os.replace(
                              rb, os.path.join(models, "0002.model")))
        fleet_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in KERNELS.values()}
        n_fwd = [n[0] for n in fwd]
        for _ in range(200):
            if watcher.reloads:
                break
            time.sleep(0.05)
        statz = _get(base + "/statz")
        fleet_closed = closed_loop(lambda r: srv.submit(r, "raw"), rows,
                                   FLEET_CLIENTS, FLEET_CLOSED_S)
    finally:
        stop_serve(srv, t)
    # one forward's launches of each serve kernel
    eng = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), ra, **kw)
    reset_launches()
    eng.predict_raw(rows[0])
    torch.cuda.synchronize()
    per = {k: KERNELS[k].launches for k in SERVE_KERNELS}
    del eng
    fails = [b for b in boxes + one if "error" in b]
    if fails:
        raise AssertionError(f"(a) requests failed: {fails[:3]}")
    versions = [r["version"] for r in statz["replicas"]]
    if watcher.reloads != 1 or len(sweep) != 2 or versions != ["r0002"] * 2:
        raise AssertionError(f"(a) sweeps {watcher.reloads}, replica "
                             f"reloads {len(sweep)}, versions {versions}")
    s0, s1 = sweep[0][0], sweep[-1][1]
    bad, late_bad, worst = [], [], 0.0
    for b in boxes:
        ea = _row_rel(b["prob"], refs["a"][b["k"]])
        eb = _row_rel(b["prob"], refs["b"][b["k"]])
        own = np.minimum(ea, eb)
        worst = max(worst, float(own.max()))
        if (own > FLEET_ROW_TOL).any() or \
                (own > FLEET_SEP * np.maximum(ea, eb)).any():
            bad.append((b["k"], float(ea.max()), float(eb.max())))
        if b["t_send"] > s1 and not (eb < FLEET_SEP * ea).all():
            late_bad.append((b["k"], float(eb.max())))
        b["lat"] = 1e3 * (b["t_done"] - b["t_send"])
    want_l = {k: per[k] * sum(n_fwd) for k in SERVE_KERNELS}
    got_l = {k: launches[k] for k in SERVE_KERNELS}
    if bad or late_bad or min(n_fwd) == 0 or got_l != want_l \
            or 0 in per.values():
        raise AssertionError(
            f"(a) answers on neither round {bad[:3]}; after the sweep not "
            f"on round B {late_bad[:3]}; forwards by replica {n_fwd}; "
            f"launches {got_l}, want {want_l} ({per} a forward)")
    during = [b["lat"] for b in boxes
              if b["t_done"] >= s0 and b["t_send"] <= s1]
    outside = [b["lat"] for b in boxes
               if not (b["t_done"] >= s0 and b["t_send"] <= s1)]
    lat_one = [1e3 * (b["t_done"] - b["t_send"]) for b in one]
    lat_fleet = [b["lat"] for b in boxes]
    out.update(
        requests=len(boxes), after_sweep=sum(b["t_send"] > s1
                                             for b in boxes),
        sweep_s=s1 - s0, forwards=n_fwd, launches=got_l, worst=worst,
        one={"answers_per_s": len(one) / one_s,
             "rows_per_s": sum(rows[b["k"]].shape[0] for b in one) / one_s,
             "p50_ms": float(np.percentile(lat_one, 50)),
             "latency": _lat_line(lat_one), "closed": one_closed},
        fleet={"answers_per_s": len(boxes) / fleet_s,
               "rows_per_s": sum(rows[b["k"]].shape[0]
                                 for b in boxes) / fleet_s,
               "p50_ms": float(np.percentile(lat_fleet, 50)),
               "latency": _lat_line(lat_fleet), "closed": fleet_closed},
        during_sweep=_lat_line(during), outside_sweep=_lat_line(outside),
        ra=ra, rb=os.path.join(models, "0002.model"), bodies=bodies,
        rows_data=rows, refs=refs)
    return out


def fleet_ab(conf: str, a: dict, fdir: str) -> dict:
    """(b): A/B with one canary replica: pins route to their round, an
    unknown pin is refused, ``promote()`` rolls the other replica."""
    models = os.path.join(fdir, "ab")
    os.makedirs(models)
    land(a["ra"], models, 1)
    srv, t = start_serve(_serve_cfg(conf, [
        "task=serve", f"model_in={a['ra']}", "serve_port=0",
        f"serve_buckets={','.join(map(str, BUCKETS))}",
        f"serve_max_batch={BUCKETS[-1]}", "serve_replicas=2",
        f"serve_reload_s={FLEET_RELOAD_S}", "serve_ab=1",
        "serve_ab_replicas=1", f"model_dir={models}", "silent=1"]))
    try:
        base = f"http://127.0.0.1:{srv.port}"
        land(a["rb"], models, 2)
        for _ in range(200):
            if srv.reload_watcher.reloads:
                break
            time.sleep(0.05)
        split = [r.version for r in srv.pool.replicas]
        worst = 0.0
        for k in range(4):
            for ver, tag in (("r0002", "b"), ("r0001", "a")):
                box = {}
                _post_bytes(base + "/predict", a["bodies"][k], box,
                            {"X-Model-Version": ver})
                if "error" in box:
                    raise AssertionError(f"(b) pin {ver}: {box['error']}")
                own = _row_rel(box["prob"], a["refs"][tag][k])
                other = _row_rel(box["prob"],
                                 a["refs"]["a" if tag == "b" else "b"][k])
                if (own > FLEET_SEP * other).any():
                    raise AssertionError(f"(b) pin {ver} answered nearer "
                                         f"the other round")
                worst = max(worst, float(own.max()))
        box = {}
        _post_bytes(base + "/predict", a["bodies"][0], box,
                    {"X-Model-Version": "r0042"})
        unknown = box.get("error", "answered")
        statz = _get(base + "/statz")
        promoted = srv.reload_watcher.promote()
        after = [r.version for r in srv.pool.replicas]
    finally:
        stop_serve(srv, t)
    if split != ["r0002", "r0001"] or worst > FLEET_ROW_TOL \
            or "400" not in unknown or set(statz["versions"]) \
            != {"r0001", "r0002"} or not promoted or after != ["r0002"] * 2:
        raise AssertionError(
            f"(b) canary split {split}, pinned answers {worst:.3g} from "
            f"their rounds, unknown pin {unknown!r}, /statz versions "
            f"{sorted(statz['versions'])}, promoted {promoted} to {after}")
    return {"split": split, "pinned_worst": worst,
            "versions": statz["versions"], "promoted": after}


def fleet_int8(conf: str, seed: int, a: dict, fdir: str) -> dict:
    """(c): an int8 fleet: q_mm on both replicas, concurrent dispatches
    bit-equal to serial ones, a plain round refused once, int8 against
    float32 gated."""
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.serve import InferenceEngine
    models = os.path.join(fdir, "int8")
    os.makedirs(models)
    qpath, drift = quantize_served(conf, a["ra"], seed + 40,
                                   os.path.join(models, "0001.model"))
    srv, t = start_serve(_serve_cfg(conf, [
        "task=serve", f"model_in={qpath}", "serve_port=0",
        f"serve_buckets={','.join(map(str, BUCKETS))}",
        f"serve_max_batch={BUCKETS[-1]}", "serve_replicas=2",
        "serve_dtype=int8", f"serve_reload_s={FLEET_RELOAD_S}",
        f"model_dir={models}", "silent=1"]))
    pool = srv.pool
    fwd, reloads = [[0] for _ in pool.replicas], [0]
    for rep, n in zip(pool.replicas, fwd):
        _count_calls(rep.engine, "run_padded", n)
    _count_calls(pool, "reload_replica", reloads)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        reqs = [a["rows_data"][k] for k in (0, 5, 11)]     # 1, 8, 32 rows
        reset_launches()
        http = []
        for k in (0, 1, 3, 5):
            box = {}
            _post_bytes(base + "/predict", a["bodies"][k], box)
            http.append(box)
        q_mm, n_fwd = KERNELS["q_mm"].launches, [n[0] for n in fwd]
        engs = [r.engine for r in pool.replicas]
        serial = [[e.predict_raw(x) for x in reqs] for e in engs]
        outs = [[] for _ in engs]
        go = threading.Barrier(len(engs))

        def hammer(i):
            go.wait()
            for _ in range(3):
                outs[i].append([engs[i].predict_raw(x) for x in reqs])
        ts = [threading.Thread(target=hammer, args=(i,))
              for i in range(len(engs))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=300)
        concurrent_equal = all(
            np.array_equal(g, w) for per in outs for got in per
            for g, w in zip(got, serial[0]))
        # a plain round lands: refused once, before any drain
        land(a["rb"], models, 2)
        time.sleep(4 * FLEET_RELOAD_S)
        refused = dict(srv.reload_watcher.snapshot(),
                       refusals=srv.reload_watcher.refusals)
        still = [(r.version, r.state) for r in pool.replicas]
        again = engs[0].predict_raw(reqs[1])
    finally:
        stop_serve(srv, t)
    fp = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), a["ra"],
                                         dtype="float32",
                                         buckets=",".join(map(str, BUCKETS)),
                                         max_batch=BUCKETS[-1])
    rel = float(np.linalg.norm(serial[0][2] - fp.predict_raw(reqs[2]))
                / np.linalg.norm(fp.predict_raw(reqs[2])))
    del fp
    per = Q_MM_PER_FORWARD["inception_bn"]
    fails = [b["error"] for b in http if "error" in b]
    if fails or min(n_fwd) == 0 or q_mm != per * sum(n_fwd):
        raise AssertionError(f"(c) failures {fails}; forwards by replica "
                             f"{n_fwd}; q_mm {q_mm}, want {per} a forward")
    if not all(np.array_equal(g, w) for g, w in zip(serial[1], serial[0])):
        raise AssertionError("(c) the two replicas answer apart serially")
    if not concurrent_equal:
        raise AssertionError("(c) concurrent int8 dispatches differ from "
                             "serial ones")
    if refused["refusals"] != 1 or reloads[0] != 0 or "not quantized" \
            not in refused["last_error"] or still != [("r0001-int8", "up")] \
            * 2 or not np.array_equal(again, serial[0][1]):
        raise AssertionError(f"(c) plain round: {refused}, replica reloads "
                             f"{reloads[0]}, replicas {still}")
    if not rel <= INT8_VS_FP:
        raise AssertionError(f"(c) int8 vs fp32 rel L2 {rel:.4g} > "
                             f"{INT8_VS_FP}")
    return {"drift": drift, "forwards": n_fwd, "q_mm": q_mm,
            "concurrent_equal": True, "refused": refused["last_error"],
            "int8_vs_fp32_rel_l2": rel}


def lm_step_readings(kern, plain, prompts) -> tuple:
    """The f32 logits of ``kern`` (an int8 LMEngine with the kernels)
    against ``plain`` (the same round with fused_kernels = 0) from the
    same prompts: one prefill chunk a row (the head at M = chunk), then
    one decode step over every row (M = max_seqs). Returns the worst of
    each, of max(1, |logit|)."""
    lasts = []
    for e in (kern, plain):
        B, C, T = e.max_seqs, e.chunk, e.T
        # the blocks a chunk and one token take, the rest of each table
        # on the scratch block
        need = e.block_pool.blocks_for_tokens(C + 1)
        blocks = e.block_pool.alloc(B * need, seq_id=-4)
        tables = np.zeros((B, T), np.int64)
        tables[:, :need] = np.asarray(blocks).reshape(B, need)
        pre, n_real = [], []
        for b in range(B):
            p = prompts[b % len(prompts)][:C]
            ids = np.zeros((1, C), np.int64)
            ids[0, :p.size] = p
            pre.append(e.step(ids, np.arange(C)[None, :], tables[b:b + 1],
                              [p.size], [p.size - 1])[1])
            n_real.append(p.size)
        pre = torch.cat(pre)
        n_real = np.asarray(n_real)
        _, dec = e.step(pre.argmax(-1).cpu().numpy()[:, None],
                        n_real[:, None], tables, n_real + 1,
                        np.zeros((B,), np.int64))
        torch.cuda.synchronize()
        e.block_pool.free(blocks)
        lasts.append((pre, dec))

    def err(got, want):
        return float(((got - want).abs()
                      / want.abs().clamp(min=1.0)).max())
    return (err(lasts[0][0], lasts[1][0]), err(lasts[0][1], lasts[1][1]))


def fleet_lm(seed: int, tmp: str, fdir: str, lm_serve: dict) -> dict:
    """(d): the LM phase's round quantized and served int8 by a 2-replica
    pool with an LM plane each, split into prefill and decode under
    streamed load; a reload that waits for live sequences."""
    import contextlib
    import io
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import parse_lm_serve_config
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.ops.fused_quant import reset_q_mm_variants
    from cxxnet_tpu_torch.quant.__main__ import main as quant_main
    from cxxnet_tpu_torch.serve import InferenceEngine
    from cxxnet_tpu_torch.serve.lm import LMEngine
    ldir = os.path.join(fdir, "lm")
    os.makedirs(ldir)
    src = ckpt.model_path(os.path.join(tmp, "lm"), 0)
    calib = write_conf(os.path.join(ldir, "calib.conf"),
                       lm_cfg(seed, ldir))
    qpath = os.path.join(ldir, "0000.model")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = quant_main([calib, src, qpath, "quant_calib_batches=2"])
    drift = buf.getvalue().strip().splitlines()[-1]
    if rc not in (0, 2):
        raise AssertionError(f"(d) quantize: exit {rc}: {drift}")
    cfg = parse_lm_serve_config(list(LMS_KNOBS))
    srv, t = start_serve(_serve_cfg(LM_CONF, [
        "task=serve", f"model_in={qpath}", "serve_port=0",
        "serve_buckets=1", "serve_max_batch=1", "serve_replicas=2",
        "serve_dtype=int8", "silent=1"]))
    pool = srv.pool
    try:
        srv.attach_lm(cfg)
        base = f"http://127.0.0.1:{srv.port}"
        lmes = [r.lm.engine for r in pool.replicas]
        if {lme.device.type for lme in lmes} != {"cuda"} \
                or lmes[0].compute_dtype != torch.float32:
            raise AssertionError("(d) the int8 LM plane is not f32 on the "
                                 "card")
        steps = [[0] for _ in lmes]
        for lme, n in zip(lmes, steps):
            _count_calls(lme, "step", n)
        prompts = lm_prompts(seed + 21, LMF_PROMPTS)
        refs = [lmes[0].generate_whole(p, max_new=LMS_NEW) for p in prompts]
        # concurrent decode on both replicas, bit-equal to serial
        got = [None, None]
        ths = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, [lmes[i].generate_whole(p, max_new=LMS_NEW)
                for p in prompts[:4]])) for i in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        if got != [refs[:4]] * 2:
            raise AssertionError("(d) concurrent int8 decodes differ from "
                                 "serial ones")
        # the head through q_mm at the step's shapes, against the plain
        # product of fused_kernels = 0 on the same round
        plain = LMEngine(InferenceEngine.from_checkpoint(
            _serve_cfg(LM_CONF, ["fused_kernels=0"]), qpath, dtype="int8",
            buckets="1", max_batch=1), cfg)
        reset_q_mm_variants()
        step_err = lm_step_readings(lmes[0], plain, prompts)
        head_variants = check_q_mm_variants("int8 LM head")
        plain.close()
        del plain
        if not max(step_err) <= LMF_STEP_TOL:
            raise AssertionError(
                f"(d) int8 LM logits against fused_kernels = 0: prefill "
                f"{step_err[0]:.3g}, decode {step_err[1]:.3g} > "
                f"{LMF_STEP_TOL}")
        # q_mm launches once a step (the head)
        for n in steps:
            n[0] = 0
        reset_launches()
        boxes = [{} for _ in prompts]
        half = len(prompts) // 2

        def wave(idx):
            ts = [threading.Thread(target=_stream_client, daemon=True,
                                   args=(base, prompts[i], i % 2 == 0,
                                         boxes[i])) for i in idx]
            for th in ts:
                th.start()
            return ts
        handoffs = [0]
        _count_calls(pool.replicas[1].lm, "admit_handoff", handoffs)
        ts = wave(range(half))
        time.sleep(0.2)
        pool.set_lm_role(0, "prefill", peer=pool.replicas[1].lm.handoff_addr)
        pool.set_lm_role(1, "decode")
        ts += wave(range(half, len(prompts)))
        for th in ts:
            th.join(timeout=600)
        for _ in range(500):
            if all(r.lm.live_count() == 0 for r in pool.replicas):
                break
            time.sleep(0.01)
        q_mm, n_steps = KERNELS["q_mm"].launches, sum(n[0] for n in steps)
        fails = [(i, b.get("error")) for i, b in enumerate(boxes)
                 if "error" in b or b.get("tokens") != refs[i]]
        if fails or handoffs[0] < len(prompts) - half or q_mm != n_steps:
            raise AssertionError(
                f"(d) /generate failed or differs from generate_whole "
                f"{fails[:3]}; handoffs {handoffs[0]}; q_mm {q_mm} for "
                f"{n_steps} steps")
        # the decode step at 8 live rows, int8 against phase 16's bf16
        lme = lmes[1]
        B, T = cfg.max_seqs, lme.T
        blocks = lme.block_pool.alloc(B * T, seq_id=-3)
        tables = np.asarray(blocks, np.int32).reshape(B, T)
        ids = np.asarray([p[0] for p in prompts[:B]], np.int32)
        L = np.full((B,), 1500, np.int32)
        decode = lambda: lme.run_decode(ids, L, tables, L + 1)
        decode_ms = time_forward(decode)
        reset_launches()
        decode()
        torch.cuda.synchronize()
        step_launch = {k.name: k.launches for k in KERNELS.values()
                       if k.launches}
        prof = profile_kinds(decode, n=20, what="decode step")[0]
        lme.block_pool.free(blocks)
        # a reload of the decode replica waits for its live sequences
        blob = ckpt.load_for_inference(qpath)
        blob["params"]["lm_head"]["wmat_scale"] = \
            blob["params"]["lm_head"]["wmat_scale"] * np.float32(0.9)
        rep = pool.replicas[1]
        seen = []
        _swap = rep.engine.swap_weights

        def spy(*a, **k):
            seen.append((rep.lm.live_count(), rep.batcher.idle))
            return _swap(*a, **k)
        rep.engine.swap_weights = spy
        hs = [pool.submit_lm(p, max_new=LMS_NEW) for p in prompts[:2]]
        for _ in range(500):            # handed off to the decode replica
            if rep.lm.live_count() == 2:
                break
            time.sleep(0.01)
        live = rep.lm.live_count()
        t0 = time.perf_counter()
        pool.reload_replica(1, blob["params"], blob["state"], 1)
        waited = time.perf_counter() - t0
        olds = [h.result(timeout=300)["tokens"] for h in hs]
        if live < 1 or seen != [(0, True)] or olds != refs[:2] \
                or rep.version != "r0001-int8":
            raise AssertionError(
                f"(d) reload: {live} live before, swap saw {seen}, old "
                f"sequences equal {olds == refs[:2]}, version {rep.version}")
        statz = _get(base + "/statz")
        used = [r["stats"]["lm"]["kv_blocks_used"]
                for r in statz["replicas"]]
        if used != [0, 0] or any(r.lm.engine.block_pool.used
                                 for r in pool.replicas):
            raise AssertionError(f"(d) KV blocks left: {used}")
    finally:
        stop_serve(srv, t)
    # int8 against bf16 greedy tokens where bf16's margin clears the bar
    eng = InferenceEngine.from_checkpoint(_serve_cfg(LM_CONF, []), src,
                                          buckets="1", max_batch=1)
    bl = LMEngine(eng, cfg)
    S = eng.net.graph.input_shape[2]
    agree = total = conf_total = 0
    forced = [0, 0]            # steps held, of them equal
    net8 = InferenceEngine.from_checkpoint(
        _serve_cfg(LM_CONF, []), qpath, dtype="int8", buckets="1",
        max_batch=1).net
    for p, r8 in zip(prompts, refs):
        rb = bl.generate_whole(p, max_new=LMS_NEW)
        seq = np.concatenate([p, np.asarray(rb)])[:S]
        xin = np.zeros((1, 1, 1, S), np.float32)
        xin[0, 0, 0, :seq.size] = seq
        logp = eng.net(torch.from_numpy(xin).to(bl.device)).out.float()
        logp = logp.reshape(S, -1)[p.size - 1:p.size - 1 + len(rb)]
        top2 = torch.topk(torch.exp(logp), 2).values.cpu().numpy()
        conf_steps = 0
        while conf_steps < len(rb) and \
                top2[conf_steps, 0] - top2[conf_steps, 1] >= LMF_MARGIN:
            conf_steps += 1
        if r8[:conf_steps] != rb[:conf_steps]:
            raise AssertionError(f"(d) int8 and bf16 greedy tokens differ "
                                 f"within {conf_steps} confident steps")
        # teacher-forced over bf16's tokens: the int8 network's greedy
        # token where bf16's log-prob margin exceeds LMS_MARGIN
        lp8 = net8(torch.from_numpy(xin).to(bl.device),
                   compute_dtype=torch.float32).out.float()
        lp8 = lp8.reshape(S, -1)[p.size - 1:p.size - 1 + len(rb)]
        lmarg = torch.topk(logp, 2).values
        sure = (lmarg[:, 0] - lmarg[:, 1]) > LMS_MARGIN
        forced[0] += int(sure.sum())
        forced[1] += int((lp8.argmax(-1) == logp.argmax(-1))[sure].sum())
        agree += sum(x == y for x, y in zip(r8, rb))
        total += len(rb)
        conf_total += conf_steps
    bl.close()
    del eng, net8
    if not forced[0] or forced[1] != forced[0]:
        raise AssertionError(
            f"(d) teacher-forced on bf16's tokens, int8's greedy token "
            f"equal on {forced[1]} of the {forced[0]} steps where bf16's "
            f"log-prob margin exceeds {LMS_MARGIN}")
    return {"forced_held": forced[0], "forced_equal": forced[1],
            "step_err": step_err, "head_variants": head_variants,
            "drift": drift, "handoffs": handoffs[0], "q_mm": q_mm,
            "steps": n_steps, "decode_step_ms": decode_ms,
            "decode_launches": step_launch, "decode_profile": prof,
            "bf16_decode_step_ms": lm_serve["decode_step_ms"],
            "bf16_decode_profile": lm_serve["decode_profile"],
            "reload_waited_s": waited, "live_at_reload": live,
            "int8_bf16_token_agree": agree / total,
            "confident_steps": conf_total}


def phase_fleet(conf: str, seed: int, tmp: str, lm_serve: dict,
                smi_line: str) -> dict:
    """Phase 17: the serving fleet at full width, (a)-(d) of the
    docstring."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    fdir = os.path.join(tmp, "fleet")
    a = fleet_reload(conf, seed, fdir, dev)
    b = fleet_ab(conf, a, fdir)
    c = fleet_int8(conf, seed, a, fdir)
    d = fleet_lm(seed, tmp, fdir, lm_serve)
    notes = {"reload": {k: v for k, v in a.items() if k not in (
        "bodies", "rows_data", "refs", "ra", "rb")},
        "ab": b, "int8": c, "lm": d,
        "seconds": time.perf_counter() - t_phase, "card": smi_line}
    one, fl = a["one"], a["fleet"]
    print(f"fleet: (a) full-width Inception-BN, 2 replicas on {dev} through "
          f"main.run, {a['requests']} open-loop /predict requests (raw, "
          f"sizes {sorted(set(a['rows']))}) at {FLEET_RATE}/s for "
          f"{FLEET_LOAD_S:.0f} s: 0 failed, one sweep to r0002 in "
          f"{a['sweep_s']:.2f} s ({a['after_sweep']} requests sent after it, "
          f"all on r0002), every answer within {FLEET_ROW_TOL} rel L2 of "
          f"the single engine's on its round (worst {a['worst']:.3g}; "
          f"control, B's params with A's BN state, {a['control']:.3g}; "
          f"rounds {a['apart']:.3g} apart), forwards by replica "
          f"{a['forwards']}, launches "
          f"{a['launches']} | open loop, one engine: {one['answers_per_s']:.2f}"
          f" answers/s ({one['rows_per_s']:.1f} rows/s), {one['latency']}; "
          f"fleet: {fl['answers_per_s']:.2f} answers/s "
          f"({fl['rows_per_s']:.1f} rows/s), {fl['latency']} | latency of "
          f"the requests in flight during the sweep {a['during_sweep']}, "
          f"of the rest {a['outside_sweep']} | closed loop in process "
          f"({FLEET_CLIENTS} clients, {FLEET_CLOSED_S:.0f} s): one engine "
          f"{one['closed']['answers_per_s']:.1f} answers/s "
          f"({one['closed']['rows_per_s']:.1f} rows/s, "
          f"{one['closed']['latency']}), fleet "
          f"{fl['closed']['answers_per_s']:.1f} answers/s "
          f"({fl['closed']['rows_per_s']:.1f} rows/s, "
          f"{fl['closed']['latency']}) | {smi_line}", flush=True)
    print(f"fleet: (b) A/B (serve_ab=1, serve_ab_replicas=1): canary "
          f"{b['split']}, X-Model-Version pins answered from their rounds "
          f"(worst {b['pinned_worst']:.3g} rel L2), r0042 refused with 400, "
          f"/statz versions {sorted(b['versions'])}, promote() -> "
          f"{b['promoted']} | (c) int8 fleet ({c['drift']}): q_mm "
          f"{c['q_mm']} launches over forwards {c['forwards']} (70 each), "
          f"concurrent dispatches of the two replicas bit-equal to serial "
          f"ones, a plain round refused once ({c['refused']}), int8 vs "
          f"fp32 rel L2 {c['int8_vs_fp32_rel_l2']:.4g} (bound {INT8_VS_FP})",
          flush=True)
    print(f"fleet: (d) the long-context LM quantized ({d['drift']}) and "
          f"served int8 by 2 replicas with an LM plane each: concurrent "
          f"decodes bit-equal to serial, {len(lm_prompts(seed + 21, LMF_PROMPTS))}"
          f" streamed /generate clients across set_lm_role(0, prefill) "
          f"equal to generate_whole ({d['handoffs']} handed off), q_mm "
          f"{d['q_mm']} launches for {d['steps']} steps, a reload waited "
          f"{d['reload_waited_s']:.3f} s for {d['live_at_reload']} live "
          f"sequences, KV pools empty after; int8 and bf16 greedy tokens "
          f"agree on {100 * d['int8_bf16_token_agree']:.1f}% of steps, all "
          f"{d['confident_steps']} leading steps where bf16's margin >= "
          f"{LMF_MARGIN}; teacher-forced on bf16's tokens, int8's greedy "
          f"token equal on {d['forced_equal']} of the {d['forced_held']} "
          f"steps where bf16's log-prob margin exceeds {LMS_MARGIN} (all "
          f"required); f32 logits against fused_kernels = 0, of max(1, "
          f"|logit|): prefill chunk {d['step_err'][0]:.3g}, decode step "
          f"{d['step_err'][1]:.3g} (tol {LMF_STEP_TOL}; q_mm "
          f"{d['head_variants']}) | decode step at 8 live "
          f"rows: int8 {d['decode_step_ms']:.3f} ms, launches "
          f"{d['decode_launches']}, {d['decode_profile']} | bf16 (phase 16) "
          f"{d['bf16_decode_step_ms']:.3f} ms, {d['bf16_decode_profile']} | "
          f"phase {notes['seconds']:.1f}s | {smi_line}", flush=True)
    return notes


# -- phase 18 -----------------------------------------------------------------

#: (a): kernels the cascade's two tiers launch (int8: q_mm, pool_fwd,
#: epilogue_fwd; bf16: pool_fwd, epilogue_fwd)
CASCADE_KERNELS = ("q_mm",) + SERVE_KERNELS
#: (a): rows whose int8 margin lies this close to the threshold may go
#: either way
CASCADE_BAND = 1e-6
CASCADE_CLIENTS = 8         # (a): closed-loop in-process clients
CASCADE_CLOSED_S = 4.0      # (a): seconds of closed-loop load, each arm
#: (b): the canary window and the backoff after a rejection (s), the
#: conv whose weights the blocked round poisons, the relative noise of
#: the sane round, and the in-process clients that keep load on the fleet
DEPLOY_WINDOW_S = 0.5
DEPLOY_BACKOFF_S = 1.0
DEPLOY_NAN_LAYER = "cv_3a_3x3"
DEPLOY_NOISE = 1e-3
DEPLOY_CLIENTS = 2


def cascade_serve(conf: str, seed: int, ra: str, qpath: str) -> dict:
    """(a): the two-tier cascade through ``main.run`` (``cascade_enable =
    1``): the int8 round ``qpath`` as the fast tier, round ``ra`` in bf16
    as the flagship, one replica each on the card, the threshold between
    the two middle int8 margins over the request rows."""
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.serve import InferenceEngine, row_confidence
    rows = fleet_rows(conf, seed)
    bodies = [json.dumps({"data": r.tolist(), "raw": 1}).encode()
              for r in rows]
    kw = dict(buckets=",".join(map(str, BUCKETS)), max_batch=BUCKETS[-1])
    eng = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), qpath,
                                          dtype="int8", **kw)
    want_fast = [eng.predict_raw(r) for r in rows]
    confs = [row_confidence(p) for p in want_fast]
    m = np.sort(np.concatenate(confs))
    thr = float((m[len(m) // 2 - 1] + m[len(m) // 2]) / 2)
    # the flagship's answers to the rows that escalate, sent as the
    # router sends them (one request of those rows: the bf16 forward
    # differs in the last bits from bucket to bucket), and to every row
    # for those within CASCADE_BAND, which may go either way
    eng = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), ra, **kw)
    want_flag = []
    for r, c in zip(rows, confs):
        w = eng.predict_raw(r)
        if (c < thr).any():
            w[c < thr] = eng.predict_raw(r[c < thr])
        want_flag.append(w)
    del eng
    srv, t = start_serve(_serve_cfg(conf, [
        "task=serve", f"model_in={ra}", "serve_port=0",
        f"serve_buckets={','.join(map(str, BUCKETS))}",
        f"serve_max_batch={BUCKETS[-1]}", "serve_max_latency_ms=2",
        "cascade_enable=1", f"cascade_model={qpath}",
        f"cascade_threshold={thr!r}", "silent=1"]))
    pool = srv.pool
    fwd = [[0] for _ in pool.replicas]
    for rep, n in zip(pool.replicas, fwd):
        _count_calls(rep.engine, "run_padded", n)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        tiers = [r.version for r in pool.replicas]
        reset_launches()
        boxes = []
        for k, body in enumerate(bodies):
            box = {"k": k}
            _post_bytes(base + "/predict", body, box)
            boxes.append(box)
        torch.cuda.synchronize()
        launches = {k: KERNELS[k].launches for k in CASCADE_KERNELS}
        n_fwd = [n[0] for n in fwd]
        stats = pool.cascade_stats()
        # the cost: the cascade beside the flagship replica alone (the
        # same replica, pinned), over the same requests
        casc = closed_loop(lambda r: srv.submit(r, "raw"), rows,
                           CASCADE_CLIENTS, CASCADE_CLOSED_S)
        alone = closed_loop(
            lambda r: srv.submit(r, "raw", version=pool.flagship_version),
            rows, CASCADE_CLIENTS, CASCADE_CLOSED_S)
        statz = _get(base + "/statz")
    finally:
        stop_serve(srv, t)
    fails = [b["error"] for b in boxes if "error" in b]
    bad, worst, sure_esc, band = [], 0.0, 0, 0
    for b in boxes:
        k, c = b["k"], confs[b["k"]]
        near = np.abs(c - thr) <= CASCADE_BAND
        esc = c < thr
        band += int(near.sum())
        sure_esc += int((esc & ~near).sum())
        e_fast = _row_rel(b["prob"], want_fast[k])
        e_flag = _row_rel(b["prob"], want_flag[k])
        own = np.where(esc, e_flag, e_fast)
        own = np.where(near, np.minimum(e_fast, e_flag), own)
        worst = max(worst, float(own.max()))
        if (own > FLEET_ROW_TOL).any():
            bad.append((k, float(e_fast.max()), float(e_flag.max()),
                        esc.tolist()))
    total = sum(r.shape[0] for r in rows)
    per = Q_MM_PER_FORWARD["inception_bn"]
    failed = stats["failed"] + sum(v["failed"]
                                   for v in statz["versions"].values())
    if fails or failed or bad or tiers != ["r0001-int8", "r0001"]:
        raise AssertionError(
            f"(a) failures {fails[:3]} (failed outcomes {failed}); "
            f"answers off their tier's engine {bad[:3]}; tiers {tiers}")
    if stats["rows"] != total or not sure_esc <= stats["rows_escalated"] \
            <= sure_esc + band or not 0 < stats["rows_escalated"] < total:
        raise AssertionError(
            f"(a) cascade_stats {stats}: want rows {total}, escalated "
            f"{sure_esc} (+{band} within {CASCADE_BAND} of {thr})")
    if 0 in launches.values() or launches["q_mm"] != per * n_fwd[0] \
            or 0 in n_fwd:
        raise AssertionError(
            f"(a) launches {launches} over forwards {n_fwd} (fast, "
            f"flagship); want q_mm {per} a fast forward and every kernel")
    return {"threshold": thr, "rows": total, "requests": len(boxes),
            "rows_escalated": stats["rows_escalated"],
            "requests_escalated": stats["requests_escalated"],
            "escalation_rate": stats["escalation_rate"], "band": band,
            "worst": worst, "forwards": n_fwd, "launches": launches,
            "cascade": casc, "flagship_alone": alone,
            "closed_escalation_rate":
                statz["cascade"]["escalation_rate"]}


def derive_round(conf: str, src: str, out: str, r: int, edit) -> str:
    """Round ``r`` at ``out``: round ``src``'s params passed through
    ``edit`` (JAX layout, in place), its BN state as it is."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.graph import build_graph
    blob = ckpt.load_for_inference(src)
    params = {k: {kk: np.array(vv) for kk, vv in v.items()}
              for k, v in blob["params"].items()}
    edit(params)
    ckpt.save_model(
        out, structure_sig=build_graph(_serve_cfg(conf, []))
        .structure_signature(), round_counter=r, epoch_counter=0,
        params=params, net_state=blob["state"])
    return out


def deploy_loop(conf: str, seed: int, fdir: str, ra: str) -> dict:
    """(b): the deployment controller through ``main.run``
    (``deploy_enable = 1``, two bf16 replicas, ``deploy_poll_s = 0``),
    ticked through the server's ``reload_watcher`` while in-process
    clients keep load on the fleet: a sane round canaries and promotes,
    a round with NaN in one conv is blocked naming it, a round with
    fc1's columns permuted canaries and rolls back, and the backoff
    refuses it again."""
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.serve import InferenceEngine
    models, stage = os.path.join(fdir, "deploy"), os.path.join(fdir, "dstage")
    os.makedirs(models)
    os.makedirs(stage)
    land(ra, models, 1)
    rs = np.random.RandomState(seed + 60)

    def noise(p):
        for lp in p.values():
            for k, v in lp.items():
                lp[k] = (v * (1 + DEPLOY_NOISE * rs.standard_normal(
                    v.shape))).astype(np.float32)
    sane = derive_round(conf, ra, os.path.join(stage, "sane"), 2, noise)

    def poison(p):
        p[DEPLOY_NAN_LAYER]["wmat"].flat[0] = np.nan
    nan = derive_round(conf, sane, os.path.join(stage, "nan"), 3, poison)

    def permute(p):
        order = np.roll(np.arange(p["fc1"]["bias"].shape[0]), 1)
        p["fc1"]["wmat"] = p["fc1"]["wmat"][:, order]
        p["fc1"]["bias"] = p["fc1"]["bias"][order]
    perm = derive_round(conf, sane, os.path.join(stage, "perm"), 4, permute)
    rows = fleet_rows(conf, seed)
    kw = dict(buckets=",".join(map(str, BUCKETS)), max_batch=BUCKETS[-1])
    eng = InferenceEngine.from_checkpoint(_serve_cfg(conf, []), sane, **kw)
    want_sane = eng.predict_raw(rows[-1])
    del eng
    srv, t = start_serve(_serve_cfg(conf, [
        "task=serve", f"model_in={ra}", f"model_dir={models}",
        "serve_port=0", f"serve_buckets={','.join(map(str, BUCKETS))}",
        f"serve_max_batch={BUCKETS[-1]}", "serve_max_latency_ms=2",
        "serve_replicas=2", "deploy_enable=1", "deploy_poll_s=0",
        f"deploy_window_s={DEPLOY_WINDOW_S}",
        f"deploy_backoff_s={DEPLOY_BACKOFF_S}", "silent=1"]))
    pool, ctl = srv.pool, srv.reload_watcher
    stop, errors, answered = threading.Event(), [], [0]

    def client(c):
        j = c
        while not stop.is_set():
            try:
                srv.submit(rows[j % len(rows)], "raw").result(timeout=300)
                answered[0] += 1
            except BaseException as e:      # reported below
                errors.append(repr(e))
            j += 1

    def tick(want: str, limit_s: float = 60.0):
        """Tick until an action; returns (it, the seconds of the tick
        that took it)."""
        t_end = time.perf_counter() + limit_s
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            act = ctl.check_once()
            took = time.perf_counter() - t0
            if act:
                if act != want:
                    raise AssertionError(f"(b) {act!r}, want {want!r}: "
                                         f"{ctl.last_incident}")
                return took
            time.sleep(0.02)
        raise AssertionError(f"(b) no {want!r} within {limit_s} s")

    versions = lambda: [r.version for r in pool.replicas]
    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(DEPLOY_CLIENTS)]
    try:
        reset_launches()
        for th in ts:
            th.start()
        out = {}
        land(sane, models, 2)
        out["canary_s"] = tick("canary")
        out["canary_versions"] = versions()
        out["promote_s"] = tick("promote")
        promoted = versions()
        sane_err = max(float(_row_rel(r.engine.predict_raw(rows[-1]),
                                      want_sane).max())
                       for r in pool.replicas)
        land(nan, models, 3)
        out["blocked_s"] = tick("blocked")
        blocked = dict(ctl.last_incident)
        after_block = versions()
        before = pool.replicas[0].engine.predict_raw(rows[-1])
        land(perm, models, 4)
        out["suspect_canary_s"] = tick("canary")
        suspect = ctl.snapshot()["canary"]
        out["rollback_s"] = tick("rollback")
        rolled = dict(ctl.last_incident)
        after = pool.replicas[0].engine.predict_raw(rows[-1])
        time.sleep(2 * DEPLOY_BACKOFF_S)
        again = ctl.check_once()
        snap = ctl.snapshot()
        final = versions()
    finally:
        stop.set()
        for th in ts:
            th.join(timeout=300)
        torch.cuda.synchronize()
        launches = {k: KERNELS[k].launches for k in SERVE_KERNELS}
        stop_serve(srv, t)
    if errors or not answered[0]:
        raise AssertionError(f"(b) {len(errors)} requests failed "
                             f"({errors[:3]}), {answered[0]} answered")
    if out["canary_versions"] != ["r0002", "r0001"] \
            or promoted != ["r0002"] * 2 or not sane_err <= FLEET_ROW_TOL:
        raise AssertionError(
            f"(b) sane round: canary {out['canary_versions']}, promoted "
            f"{promoted}, answers {sane_err:.3g} from one engine on it")
    if blocked["gate"] != "offline" or blocked["layers"] \
            != [DEPLOY_NAN_LAYER] or not blocked["provenance"].startswith(
                f"layer={DEPLOY_NAN_LAYER} ") or after_block != promoted:
        raise AssertionError(f"(b) NaN round: {blocked}, replicas "
                             f"{after_block}")
    if not suspect["suspect"] or rolled["gate"] != "parity" \
            or not rolled["rolled_back"] or not np.array_equal(after, before) \
            or again != "" or snap["rejected_rounds"] != [3, 4] \
            or final != ["r0002"] * 2 or snap["promotions"] != 1 \
            or snap["rollbacks"] != 1 or 0 in launches.values():
        raise AssertionError(
            f"(b) permuted round: canary {suspect}, incident {rolled}, "
            f"canary bit-equal after the rollback "
            f"{np.array_equal(after, before)}, tick after the backoff "
            f"{again!r}, controller {snap}, replicas {final}, launches "
            f"{launches}")
    out.update(sane_worst=sane_err, blocked=blocked["reason"],
               rollback=rolled["reason"], answered=answered[0],
               launches=launches, window_s=suspect["window_s"])
    return out


def phase_cascade(conf: str, seed: int, tmp: str, smi_line: str) -> dict:
    """Phase 18: the two-tier cascade and the deployment controller at
    full width, (a)-(c) of the docstring, on phase 17's round A and its
    int8 derivation."""
    t_phase = time.perf_counter()
    fdir = os.path.join(tmp, "fleet")
    ra = os.path.join(fdir, "models", "0001.model")
    qpath = os.path.join(fdir, "int8", "0001.model")
    a = cascade_serve(conf, seed, ra, qpath)
    b = deploy_loop(conf, seed, fdir, ra)
    notes = {"cascade": a, "deploy": b,
             "seconds": time.perf_counter() - t_phase, "card": smi_line}
    casc, alone = a["cascade"], a["flagship_alone"]
    print(f"cascade: (a) full-width Inception-BN through main.run "
          f"(cascade_enable=1): r0001-int8 (q_mm) answers first, r0001 in "
          f"bf16 takes rows under cascade_threshold {a['threshold']:.6g} "
          f"(the median int8 margin), one replica each on cuda:0; "
          f"{a['requests']} /predict requests ({a['rows']} rows, sizes "
          f"{sorted(set(FLEET_SIZES))}): 0 failed, {a['rows_escalated']} "
          f"rows escalated in {a['requests_escalated']} requests "
          f"(escalation rate {a['escalation_rate']:.4g}, {a['band']} rows "
          f"within {CASCADE_BAND} of the threshold), every row within "
          f"{FLEET_ROW_TOL} rel L2 of its tier's engine (worst "
          f"{a['worst']:.3g}), forwards (fast, flagship) {a['forwards']}, "
          f"launches {a['launches']} | closed loop in process "
          f"({CASCADE_CLIENTS} clients, {CASCADE_CLOSED_S:.0f} s, the same "
          f"requests): cascade {casc['answers_per_s']:.1f} answers/s "
          f"({casc['rows_per_s']:.1f} rows/s, {casc['latency']}, escalation "
          f"rate {a['closed_escalation_rate']:.4g}); the bf16 flagship "
          f"replica alone {alone['answers_per_s']:.1f} answers/s "
          f"({alone['rows_per_s']:.1f} rows/s, {alone['latency']}) | "
          f"{smi_line}", flush=True)
    print(f"cascade: (b) deploy_enable=1 over 2 bf16 replicas "
          f"(deploy_window_s {DEPLOY_WINDOW_S}, backoff "
          f"{DEPLOY_BACKOFF_S} s), {DEPLOY_CLIENTS} in-process clients, "
          f"{b['answered']} answered, 0 failed: a sane round (x(1 + "
          f"{DEPLOY_NOISE} N(0, 1))) canaried in {b['canary_s']:.3f} s and "
          f"promoted in {b['promote_s']:.3f} s (both replicas within "
          f"{FLEET_ROW_TOL} of one engine on it, worst "
          f"{b['sane_worst']:.3g}); NaN in {DEPLOY_NAN_LAYER} blocked in "
          f"{b['blocked_s']:.3f} s ({b['blocked'][:90]}); fc1's columns "
          f"permuted: SUSPECT canary ({b['window_s']:.3g} s window) in "
          f"{b['suspect_canary_s']:.3f} s, rolled back in "
          f"{b['rollback_s']:.3f} s ({b['rollback']}), the canary's answers "
          f"bit-equal to before, refused again after the backoff; "
          f"launches {b['launches']} | phase {notes['seconds']:.1f}s | "
          f"{smi_line}", flush=True)
    return notes


# -- main ---------------------------------------------------------------------

# -- phase 19 ------------------------------------------------------------------

#: the child's steps: the profiled pair TEL_PROFILE and the probe's first
#: window of 8 lie inside
TEL_STEPS = 10
TEL_PROFILE = "8-9"
#: steps of the sentinel run (b) and of each step-time run
TEL_SHORT_STEPS = 2
TEL_TIMED_STEPS = 4
#: requests the served engine's /metrics must count (c)
TEL_REQUESTS = 5
#: the synthetic data's clusters: the generator draws a centre of
#: 3x224x224 for each, and 1000 of them cost seconds an iterator
TEL_CLASSES = 10
#: the device kernels of the hand kernels of PERF.md rows 1-7 and 12a by
#: a fragment of their name, as torch.profiler (demangled) and the CUDA
#: graph (mangled) both spell it; TRAIN_KERNELS are on the Inception-BN
#: step, the rest must read 0 in both
TEL_FRAGMENTS = {
    "pool_fwd": ("pool_fwd_kernel",),
    "pool_bwd_max": ("pool_bwd_max_kernel",),
    "pool_bwd": ("pool_bwd_kernel",),
    "epilogue_fwd": ("epilogue_fwd_kernel",),
    "epilogue_bwd": ("mask_copy_vec", "EpiBwdVec"),
    "bn_fwd": ("MomentsVec", "SqDevVec", "bn_fwd_norm_vec"),
    "bn_bwd": ("BwdSumsVec", "bn_dx_vec"),
    "sgd_apply": ("sgd_apply_kernel",),
}


def _graph_nodes(fn):
    """The kernel names of one ``fn()`` captured in a CUDA graph, read
    through the CUDA driver's graph calls (tests/test_torch_cuda.py's
    reader; the warm-up runs on a side stream, as graph capture of a
    backward asks, and the capture is relaxed: the graph only is read,
    never replayed)."""
    import ctypes

    class KernelParams(ctypes.Structure):       # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [
            (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz",
                                         "smem")] + [
            (f, ctypes.c_void_p) for f in ("params", "extra", "kern",
                                           "ctx")]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind, name = ctypes.c_int(-1), ctypes.c_char_p()
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value != 0:
            continue
        kp = KernelParams()
        if cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(kp)):
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        rc = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(kp.func))
              if kp.func else
              cu.cuKernelGetName(ctypes.byref(name),
                                 ctypes.c_void_p(kp.kern)))
        if rc:
            raise RuntimeError(f"cuFuncGetName failed ({rc})")
        out.append(name.value.decode())
    del g
    return out


def child_attribution(out: str, prof: str, summary: dict, steps: int
                      ) -> dict:
    """Phase 22 (f) on phase 19's child: the attribution line it printed
    when its profile bracket closed, the per-phase ms and launches a
    step (``telemetry.traceparse.attribute_profile`` of its trace), and
    its summary's ``bn_fwd`` and ``bn_bwd`` device kernels with their
    launches and phase."""
    from cxxnet_tpu_torch.telemetry.traceparse import (attribute_profile,
                                                       classify_op)
    line = next((ln.strip() for ln in out.splitlines()
                 if "profile[" in ln), "")
    att = attribute_profile(prof, steps)
    frags = TEL_FRAGMENTS["bn_fwd"] + TEL_FRAGMENTS["bn_bwd"]
    bn = {n: k["count"] for n, k in summary["kernels"].items()
          if any(f in n for f in frags)}
    return {"line": line,
            "phases": {ph: {"ms": d["ms"], "count": d["count"]}
                       for ph, d in att["phases"].items()},
            "top_other": att["top_other"][:4],
            "bn_launches": sum(bn.values()),
            "bn_elsewhere": sorted(n[:60] for n in bn
                                   if classify_op(n) != "bn_act")}


def _fragment_counts(names_counts) -> dict:
    """{fragment: count} of TEL_FRAGMENTS over (kernel name, count)
    pairs, each name going to its first matching fragment."""
    frags = [f for fs in TEL_FRAGMENTS.values() for f in fs]
    out = dict.fromkeys(frags, 0)
    for name, k in names_counts:
        hit = next((f for f in frags if f in name), None)
        if hit is not None:
            out[hit] += k
    return out


def _steady_spans(path: str) -> dict:
    """Medians (ms) over steps 2-7 of the ``train.data_wait``,
    ``train.step_dispatch`` and ``train.step`` spans of a telemetry
    trace: the step-time probe's components past the first step's
    warm-up and before the profiled pair."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for key, name in (("data_wait", "train.data_wait"),
                      ("dispatch", "train.step_dispatch"),
                      ("step", "train.step")):
        durs = [e["dur"] / 1e3 for e in sorted(
            (e for e in events if e.get("name") == name),
            key=lambda e: e["ts"])][1:7]
        out[key] = statistics.median(durs)
    return out


def _child_timeline(path: str) -> dict:
    """Seconds from the child's first traced event to its first step's
    end, its last step's end, the profile bracket's stop (the trace and
    summary written) and the checkpoint's end, from its telemetry
    trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") in ("X", "i")]
    t0 = min(e["ts"] for e in events)
    end = lambda e: (e["ts"] + e.get("dur", 0.0) - t0) / 1e6
    steps = sorted(end(e) for e in events if e["name"] == "train.step")
    stop = [end(e) for e in events if e["name"] == "profiler.stop_trace"]
    start = [end(e) for e in events if e["name"] == "profiler.start_trace"]
    save = [end(e) for e in events if e["name"] == "ckpt.save"]
    return {"first step": steps[0], "last step": steps[-1],
            "profile start": start[0], "profile stop": stop[0],
            "saved": save[-1]}


def _first_batch(pairs):
    """The first batch of the iterator of ``pairs`` (its chain closed)."""
    from cxxnet_tpu_torch.io import close_chain, create_iterator
    it = create_iterator(pairs)
    try:
        return next(iter(it))
    finally:
        close_chain(it)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        return r.read().decode("utf-8")


def _metric_sum(text: str, name: str, **labels) -> float:
    """The sum of the samples of ``name`` whose labels include
    ``labels``."""
    import re
    total = 0.0
    for m in re.finditer(r"^%s(\{[^}]*\})? (\S+)$" % re.escape(name), text,
                         re.M):
        lab = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
        if all(lab.get(k) == v for k, v in labels.items()):
            total += float(m.group(2))
    return total


def _train_only(cfg):
    """``cfg`` without its ``eval`` section (a run that only trains)."""
    out, skip = [], False
    for k, v in cfg:
        if k == "eval":
            skip = True
        elif skip and (k, v) == ("iter", "end"):
            skip = False
        elif not skip:
            out.append((k, v))
    return out


def _step_wall_ms(cfg) -> float:
    """The median wall time between consecutive steps of a
    ``main.run(cfg)`` train run (the step hook's clock; the last step
    waited for)."""
    stamps = []

    def on_step(tr):
        stamps.append(time.perf_counter())
    _train_run(cfg, on_step)
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return 1e3 * statistics.median(gaps)


def phase_telemetry(conf: str, seed: int, tmp: str, smi_line: str) -> dict:
    """Phase 19 (see the module docstring)."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.telemetry.ledger import read_ledger
    from cxxnet_tpu_torch.trainer import Trainer
    t_start = time.perf_counter()
    marks = {}
    mdir = os.path.join(tmp, "telemetry")
    prof = os.path.join(tmp, "telemetry_profile")
    port = _free_port()
    cfg = _train_only(train_cfg(conf, seed, mdir, (
        f"telemetry_profile_steps={TEL_PROFILE}",
        f"telemetry_profile_dir={prof}",
        f"telemetry_trace={tmp}/telemetry_trace.json",
        f"telemetry_ledger={tmp}/telemetry_ledger.jsonl",
        f"telemetry_port={port}", "print_step=0"), steps=TEL_STEPS,
        classes=TEL_CLASSES))
    conf_path = write_conf(os.path.join(tmp, "telemetry.conf"), cfg)
    # (a) a process of its own: a profiler session late in a process
    # that ran many loses its device events
    child = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", conf_path],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    scraped = None
    try:
        deadline = time.perf_counter() + 300
        while child.poll() is None and time.perf_counter() < deadline:
            try:
                body = _scrape(port)
            except OSError:
                time.sleep(0.1)
                continue
            marks.setdefault("child up", time.perf_counter())
            if _metric_sum(body, "cxxnet_steptime_steps_total") > 0:
                scraped = body
                marks["child stepping"] = time.perf_counter()
                break
            time.sleep(0.05)
        out, _ = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    marks["child done"] = time.perf_counter()
    if child.returncode:
        raise AssertionError(f"telemetry child exited {child.returncode}:"
                             f"\n{out[-4000:]}")
    if scraped is None:
        raise AssertionError("/metrics of telemetry_port did not answer "
                             "while the trainer stepped")
    lines = [ln for ln in out.splitlines() if ln.startswith("round")]
    probe = next((ln for ln in lines if "\tbound:" in ln), None)
    if probe is None:
        raise AssertionError(f"no round line with the probe's verdict:\n"
                             f"{out[-2000:]}")
    frag = probe[probe.index("\tdata_ms:"):].strip().replace("\t", " ")
    steady = _steady_spans(os.path.join(tmp, "telemetry_trace.json"))
    child_t = _child_timeline(os.path.join(tmp, "telemetry_trace.json"))
    with open(os.path.join(prof, "summary.json")) as f:
        summary = json.load(f)
    steps = 2
    attribution = child_attribution(out, prof, summary, steps)
    got = _fragment_counts((n, k["count"]) for n, k in
                           summary["kernels"].items())
    ledger = read_ledger(os.path.join(tmp, "telemetry_ledger.jsonl"))
    events = [r["event"] for r in ledger]
    for e in ("run_start", "round_end", "ckpt_save", "run_end"):
        if e not in events:
            raise AssertionError(f"ledger lacks {e}: {events}")
    # (b) the sentinel rolls a poisoned step back
    ledger_b = os.path.join(tmp, "telemetry_sentinel.jsonl")
    cfg_b = _train_only(train_cfg(conf, seed, mdir, (
        "continue=1", "num_round=2", "failpoints=device.step=once",
        f"telemetry_ledger={ledger_b}", "print_step=0"),
        steps=TEL_SHORT_STEPS, classes=TEL_CLASSES))
    tr = run(cfg_b)
    finite = tr.params_finite()
    rec = read_ledger(ledger_b)
    trips = [r for r in rec if r["event"] in ("sentinel_trip", "rollback")]
    if [r["event"] for r in trips] != ["sentinel_trip", "rollback"] \
            or trips[1]["to_round"] != 0 or not finite:
        raise AssertionError(f"device.step=once: ledger {trips}, finite "
                             f"params {finite}")
    marks["sentinel"] = time.perf_counter()
    # one step's CUDA graph, in this process, on (b)'s trainer
    glob, sections = split_sections(cfg_b)
    batch = _first_batch(glob + sections[0][2])
    # what the probe cannot see: the host syncs of one update with the
    # train metrics on (eval_train = 1 reads step k-1's nodes after step
    # k was queued)
    tr.update(batch)
    update_syncs = _host_syncs(lambda: tr.update(batch))
    staged = tr.stage_batch(batch)
    mask = tr._mask(batch)
    nodes = _graph_nodes(lambda: tr._step(staged.data, staged.label, mask))
    want = _fragment_counts((n, 1) for n in nodes)
    graph_total = len(nodes)
    del tr, staged
    torch.cuda.empty_cache()
    marks["graph"] = time.perf_counter()
    per_step = {f: got[f] / steps for f in got}
    bad = {f: (per_step[f], want[f]) for f in got if per_step[f] != want[f]}
    # every hand kernel of the step holds one of its device kernels at
    # least (pool_bwd_max is not on Inception-BN's path: 0 in both)
    absent = [k for k in TRAIN_KERNELS
              if not any(want[f] for f in TEL_FRAGMENTS[k])]
    if bad or absent:
        raise AssertionError(f"profiler trace vs one step's CUDA graph "
                             f"(per step, graph): {bad}; kernels absent "
                             f"from the step: {absent}; graph {want}")
    # (c) a served engine's /metrics counts the requests sent
    srv, t = start_serve(_serve_cfg(conf, [
        "task=serve", f"model_in={ckpt.model_path(mdir, 1)}",
        "serve_port=0", "serve_buckets=1", "serve_max_batch=1",
        "silent=1"]))
    try:
        base = f"http://127.0.0.1:{srv.port}"
        rs = np.random.RandomState(seed)
        width = int(np.prod([int(v) for v in TRAIN_IMAGE.split(",")]))
        for _ in range(TEL_REQUESTS):
            _post(base + "/predict", {"data": rs.randn(1, width)
                                      .astype(np.float32).tolist()})
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode("utf-8")
        eng = srv.engine.stats.instance
        served = {res: _metric_sum(text, "cxxnet_serve_requests_total",
                                   engine=eng, result=res)
                  for res in ("received", "ok")}
    finally:
        stop_serve(srv, t)
    if served != {"received": TEL_REQUESTS, "ok": TEL_REQUESTS}:
        raise AssertionError(f"/metrics counted {served}, sent "
                             f"{TEL_REQUESTS}")
    marks["serve"] = time.perf_counter()
    # the step with the default telemetry beside both off, from round 1
    timed = ("save_model=0", "continue=1", "num_round=3")
    on_ms = _step_wall_ms(_train_only(train_cfg(
        conf, seed, mdir, timed, steps=TEL_TIMED_STEPS,
        classes=TEL_CLASSES)))
    off_ms = _step_wall_ms(_train_only(train_cfg(
        conf, seed, mdir, timed + ("telemetry_steptime=0", "sentinel=0"),
        steps=TEL_TIMED_STEPS, classes=TEL_CLASSES)))
    marks["step times"] = time.perf_counter()
    took = time.perf_counter() - t_start
    spans = ", ".join(f"{k} {v - t_start:.1f}s" for k, v in marks.items())
    kern = ", ".join(f"{k} {'+'.join(str(want[f]) for f in fs)}"
                     for k, fs in TEL_FRAGMENTS.items())
    print(f"telemetry: child main.run of {TEL_STEPS} steps: /metrics "
          f"answered while it trained; "
          f"torch.profiler steps {TEL_PROFILE}: {summary['device_events']} "
          f"device events, {summary['device_us'] / 1e3 / steps:.3f} ms of "
          f"kernels a step; the hand kernels' device kernels a step equal "
          f"one step's CUDA graph ({kern}) | probe {frag}; the trace's "
          f"medians over steps 2-7: data wait {steady['data_wait']:.2f} ms, "
          f"dispatch {steady['dispatch']:.2f} ms, step "
          f"{steady['step']:.2f} ms; host syncs in one update with "
          f"eval_train = 1: {update_syncs} | "
          f"device.step=once: sentinel_trip, rollback to round 0, finite "
          f"params | serve /metrics counted {TEL_REQUESTS} of "
          f"{TEL_REQUESTS} requests | step {on_ms:.3f} ms with the default "
          f"telemetry, {off_ms:.3f} ms with telemetry_steptime = 0 "
          f"sentinel = 0 (not gated) | {took:.1f}s ({spans}; the child "
          f"from its first span: " + ", ".join(
              f"{k} {v:.1f}s" for k, v in child_t.items())
          + f") | {smi_line}",
          flush=True)
    return {"probe": frag, "steady_ms": steady,
            "update_host_syncs": update_syncs, "graph_per_step": want,
            "graph_nodes": graph_total, "attribution": attribution,
            "profile_per_step": per_step,
            "profile_device_ms_per_step": summary["device_us"] / 1e3 / steps,
            "device_events": summary["device_events"],
            "served": served, "step_ms": on_ms, "step_off_ms": off_ms,
            "child_timeline": child_t,
            "seconds": took, "marks": {k: v - t_start
                                       for k, v in marks.items()},
            "card": smi_line}


# -- phase 20 -----------------------------------------------------------------

#: phase 20's records: DS_UNIQUE seeded JPEGs (IMGREC_SIDE^2), written in
#: turn DS_RECORDS // DS_UNIQUE times: one epoch of DS_STEPS batches, and
#: two halves of equal bytes, so the DS_SHARDS byte ranges split the file
#: at its middle record
DS_UNIQUE, DS_STEPS, DS_SHARDS = 128, 8, 2
DS_RECORDS = TRAIN_BATCH * DS_STEPS
DS_SEED = 11            # data_service_seed
DS_PROBE_EPOCH = 9      # (b)'s epoch: one that (c) does not train
DS_KILL_STEP = 3        # (c): a reader dies after this step of a round
DS_WANT = {"stem": 1, "bn_fwd": 69, "bn_bwd": 69, "sgd_apply": 2}
DS_KERNELS = TRAIN_KERNELS + ("stem",)   # every kernel of the path
DS_READY_S = 180.0      # the readers' start, the kernels' libraries loaded
DS_READER_DEV = "gpu:0"  # the readers' decode device: nvJPEG on this card


def ds_records(url: str, seed: int):
    """Phase 20's record file (``write_records``) and mean image under the
    ``file://`` URL ``url``, through the stream layer; returns their URLs
    and seconds."""
    from cxxnet_tpu_torch.io import stream
    t0 = time.perf_counter()
    paths, imgs, _ = write_records(url, seed, (("train", DS_RECORDS),),
                                   IMGREC_SIDE, TRAIN_CLASSES, "jpeg",
                                   unique=DS_UNIQUE)
    crop = int(TRAIN_IMAGE.split(",")[1])
    o = (IMGREC_SIDE - crop) // 2
    mean = np.mean([im[o:o + crop, o:o + crop] for im in imgs["train"]],
                   axis=0, dtype=np.float64).astype(np.float32)
    mean_url = f"{url}/mean.npy"
    with stream.sopen(mean_url, "wb") as f:
        np.save(f, mean)
    return paths["train"], mean_url, time.perf_counter() - t0


def ds_cfg(conf: str, rec: str, mean: str, extra=()):
    """``conf``'s netconfig and globals with its own train section over
    phase 20's records and mean (the eval section dropped)."""
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file)
    out, section = [], None
    for k, v in parse_config_file(conf):
        if k in ("data", "eval"):
            section = k
        if section == "eval":
            if k == "iter" and v == "end":
                section = None
            continue
        if k == "image_rec":
            v = rec
        elif k == "image_mean":
            v = mean
        out.append((k, v))
    return out + parse_cli_overrides(["print_step=0", *extra])


def _ds_stream(it, epoch: int):
    """Every batch of ``epoch`` and each draw's seconds."""
    it.set_epoch(epoch)
    it.before_first()
    out, lat = [], []
    while True:
        t0 = time.perf_counter()
        b = it.next()
        lat.append(time.perf_counter() - t0)
        if b is None:
            return out, lat[:-1]
        out.append(b)


def _ds_equal(got, want) -> bool:
    def norm_eq(a, b):
        if (a is None) != (b is None):
            return False
        return a is None or (sorted(a) == sorted(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a))
    return len(got) == len(want) and all(
        a.data.dtype == b.data.dtype and np.array_equal(a.data, b.data)
        and np.array_equal(a.label, b.label)
        and np.array_equal(a.inst_index, b.inst_index)
        and a.num_batch_padd == b.num_batch_padd and norm_eq(a.norm, b.norm)
        for a, b in zip(got, want))


def _ds_run(cfg, on_step):
    """``main.run(cfg)`` from ``continue = 1``, its log kept, the launch
    counts set to 0 just before the first step: (trainer, log, losses,
    per-step launches, launches of the whole run, the ``io.retries`` of
    the run's start: the round's read)."""
    import contextlib
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.resilience import counters
    box = {"losses": [], "per_step": []}
    retries = counters.get("io.retries")
    counted = tuple(DS_WANT)

    def step(tr):
        box["losses"].append(tr.last_loss)
        box["per_step"].append({k: KERNELS[k].launches - box["at"][k]
                                for k in counted})
        box["at"] = {k: KERNELS[k].launches for k in counted}
        on_step(len(box["losses"]))

    def ready(tr):
        box["retries"] = counters.get("io.retries") - retries
        tr.step_hook = step
        torch.cuda.synchronize()
        reset_launches()                  # just before the first step
        box["at"] = {k: 0 for k in counted}

    tee = _Tee(None)
    with contextlib.redirect_stdout(tee):
        tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    tr.step_hook = None
    whole = {k.name: k.launches for k in KERNELS.values()}
    return (tr, "".join(tee.parts), box["losses"], box["per_step"], whole,
            box["retries"])


def _data_ms(log: str) -> list:
    """The step-time probe's data wait a step, from each round line."""
    lines = [ln for ln in log.splitlines() if "\tdata_ms:" in ln]
    if not lines:
        raise AssertionError(f"no round line with data_ms:\n{log[-2000:]}")
    return [float(ln.split("\tdata_ms:")[1].split("\t")[0])
            for ln in lines]


def phase_data_service(conf: str, seed: int, tmp: str,
                       smi_line: str) -> dict:
    """Phase 20 (see the module docstring)."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import (parse_data_service_config,
                                         split_sections)
    from cxxnet_tpu_torch.data_service import (DataServiceClient,
                                               build_service_iterator)
    from cxxnet_tpu_torch.io import stream
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.telemetry.registry import REGISTRY
    t_start = time.perf_counter()
    marks = {}
    url = "file://" + os.path.join(tmp, "ds")
    rec, mean, t_write = ds_records(url, seed)
    marks["records"] = time.perf_counter()
    endpoints = ",".join(f"127.0.0.1:{_free_port()}"
                         for _ in range(DS_SHARDS))
    svc_keys = [f"data_service_shards={DS_SHARDS}",
                f"data_service_seed={DS_SEED}",
                "data_service_timeout_ms=30000"]
    status = os.path.join(tmp, "ds_status")
    conf_path = write_conf(os.path.join(tmp, "ds.conf"), ds_cfg(conf, rec,
                                                                mean))
    logs = [open(os.path.join(tmp, f"reader{i}.log"), "w")
            for i in range(DS_SHARDS)]
    # (a) two reader processes, decoding through nvJPEG on this card
    readers = [subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", conf_path,
         "task=data_reader", f"dev={DS_READER_DEV}",
         f"data_service={endpoints}",
         f"data_service_reader={i}", f"data_service_status_dir={status}",
         *svc_keys], cwd=ROOT, stdout=logs[i], stderr=subprocess.STDOUT)
        for i in range(DS_SHARDS)]
    try:
        glob, sections = split_sections(ds_cfg(conf, rec, mean))
        section = glob + sections[0][2]
        local_svc = parse_data_service_config(
            [("data_service", "local")] + [tuple(k.split("=")) for k in
                                           svc_keys])
        # (b)'s control while the readers start
        control, _ = _ds_stream(build_service_iterator(section, local_svc),
                                DS_PROBE_EPOCH)
        marks["control"] = time.perf_counter()
        deadline = time.perf_counter() + DS_READY_S
        while not all(os.path.exists(os.path.join(
                status, f"reader_{i}.json")) for i in range(DS_SHARDS)):
            dead = [i for i, r in enumerate(readers) if r.poll() is not None]
            if dead or time.perf_counter() > deadline:
                raise AssertionError(
                    f"readers {dead} exited (or none answered in "
                    f"{DS_READY_S:.0f}s): "
                    + open(os.path.join(tmp, "reader0.log")).read()[-3000:])
            time.sleep(0.05)
        marks["readers up"] = time.perf_counter()
        # (b) one epoch over the readers, then a second client's
        svc = parse_data_service_config(
            [("data_service", endpoints), ("data_service_prefetch", "0")]
            + [tuple(k.split("=")) for k in svc_keys])
        stats = DataServiceClient(svc)
        eps = svc.endpoint_list

        def tally():
            s = [stats.stats(ep) for ep in eps]
            return (sum(x["served"] for x in s),
                    sum(x["cache_hits"] for x in s))
        t0 = time.perf_counter()
        first_it = build_service_iterator(section, svc)
        first, lat_cold = _ds_stream(first_it, DS_PROBE_EPOCH)
        t_first = time.perf_counter() - t0
        served0, hits0 = tally()
        second_it = build_service_iterator(section, svc)
        second, lat_warm = _ds_stream(second_it, DS_PROBE_EPOCH)
        served1, hits1 = tally()
        for it in (first_it, second_it, stats):
            it.close()
        if not (_ds_equal(first, control) and _ds_equal(second, control)):
            raise AssertionError("the service stream differs from the "
                                 "data_service = local stream")
        if len(control) != DS_STEPS or control[0].data.dtype != np.uint8 \
                or control[0].norm is None:
            raise AssertionError(f"{len(control)} batches, want {DS_STEPS} "
                                 "uint8 batches with norm")
        frames = served1 - served0
        if frames != DS_STEPS + DS_SHARDS or hits1 - hits0 != frames:
            raise AssertionError(f"second client: {frames} frames served, "
                                 f"{hits1 - hits0} from the cache (want "
                                 f"{DS_STEPS} batches + {DS_SHARDS} ends, "
                                 "all cached)")
        marks["stream"] = time.perf_counter()
        # (c) rounds 1 and 2 of full-width Inception-BN from one round 0:
        # over the readers (model_dir under file://, io.read armed once),
        # killing reader 1 in round 1 and reader 0 in round 2, and over
        # data_service = local
        mdir = f"{url}/models"
        cdir = os.path.join(tmp, "ds_control")
        stream.makedirs(mdir)
        r0 = write_round(conf, seed, mdir, torch.device("cuda"),
                         round_counter=0)
        os.makedirs(cdir)
        stream.write_bytes_atomic(ckpt.model_path(cdir, 0),
                                  stream.read_bytes(r0))
        common = ["continue=1", "num_round=3", "save_model=1",
                  f"seed={seed}", *svc_keys]
        kills = {DS_KILL_STEP: 1, DS_STEPS + DS_KILL_STEP: 0}

        def on_step(n):
            if n in kills:
                readers[kills[n]].kill()
                readers[kills[n]].wait()

        def degrades():
            return REGISTRY.counter(
                "cxxnet_dataservice_degrades_total",
                "Service clients that fell back to the local pipeline"
            ).labels().value

        def failovers():
            return REGISTRY.counter(
                "cxxnet_dataservice_failovers_total",
                "Fetches that left their shard's owner for a surviving "
                "reader").labels().value
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            d0, f0 = degrades(), failovers()
            t0 = time.perf_counter()
            tr, log, losses, per_step, whole, retries = _ds_run(
                ds_cfg(conf, rec, mean, [
                    *common, f"model_dir={mdir}",
                    f"data_service={endpoints}",
                    "failpoints=io.read=once"]), on_step)
            t_svc = time.perf_counter() - t0
            got = _snap(tr)
            d1, f1 = degrades() - d0, failovers() - f0
            del tr
            marks["service run"] = time.perf_counter()
            t0 = time.perf_counter()
            ctr, clog, closses, cper, _, _ = _ds_run(
                ds_cfg(conf, rec, mean, [*common, f"model_dir={cdir}",
                                         "data_service=local"]),
                lambda n: None)
            t_local = time.perf_counter() - t0
            ref = _snap(ctr)
            del ctr
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = flags
        torch.cuda.empty_cache()
        marks["local run"] = time.perf_counter()
        warn = [ln for ln in log.splitlines()
                if "degraded to the local input pipeline" in ln]
        if len(losses) != 2 * DS_STEPS or losses != closses:
            raise AssertionError(f"losses over the service {losses} vs "
                                 f"data_service = local {closses}")
        diff = max(float(np.abs(x - y).max()) for x, y in zip(
            _flat_np(got[0]) + _flat_np(got[1]["mom"]) + _flat_np(got[2]),
            _flat_np(ref[0]) + _flat_np(ref[1]["mom"]) + _flat_np(ref[2])))
        if diff != 0.0:
            raise AssertionError(f"masters, momenta and BN statistics over "
                                 f"the service vs local: largest difference"
                                 f" {diff}")
        bad = [(i + 1, n) for i, n in enumerate(per_step + cper)
               if n != DS_WANT]
        absent = [k for k in DS_KERNELS if whole[k] == 0]
        if bad or absent:
            raise AssertionError(f"launches per step {bad} (want {DS_WANT});"
                                 f" kernels never launched {absent}")
        if len(warn) != 1 or d1 != 1 or f1 < 1 or retries != 1:
            raise AssertionError(
                f"degrade warnings {len(warn)}, degrades {d1}, failovers "
                f"{f1}, io.retries {retries} (want 1, 1, >= 1, 1)")
        # (d) the round written under file:// answers task = pred to a
        # file:// output
        pred = f"{url}/pred.txt"
        run(ds_cfg(conf, rec, mean, [
            "task=pred", f"model_in={ckpt.model_path(mdir, 2)}",
            f"name_pred={pred}", "silent=1"]))
        rows = stream.read_bytes(pred).decode().split()
        if len(rows) != DS_RECORDS or not all(
                0 <= int(float(v)) < TRAIN_CLASSES for v in rows):
            raise AssertionError(f"task = pred wrote {len(rows)} rows, want "
                                 f"{DS_RECORDS} class ids")
        marks["pred"] = time.perf_counter()
    finally:
        for r in readers:
            if r.poll() is None:
                r.kill()
            r.wait()
        for f in logs:
            f.close()
    svc_ms, local_ms = _data_ms(log), _data_ms(clog)
    took = time.perf_counter() - t_start
    pct = lambda v, q: float(np.percentile(np.asarray(v) * 1e3, q))
    spans = ", ".join(f"{k} {v - t_start:.1f}s" for k, v in marks.items())
    print(f"data_service: {DS_RECORDS} JPEG records ({DS_UNIQUE} images of "
          f"{IMGREC_SIDE}x{IMGREC_SIDE}) and the mean written under file:// "
          f"in {t_write:.1f}s; two task = data_reader processes (dev = "
          f"gpu:0, nvJPEG), {DS_SHARDS} shards | (b) epoch "
          f"{DS_PROBE_EPOCH}: {len(first)} uint8 batches with norm "
          f"bit-equal to data_service = local, a second client's "
          f"{served1 - served0} frames all cache hits | (c) full-width "
          f"Inception-BN (batch {TRAIN_BATCH}, bf16, cuDNN deterministic) "
          f"rounds 1-2 over the readers with reader 1 killed after step "
          f"{DS_KILL_STEP} of round 1 (failovers {f1:g}) and reader 0 "
          f"after step {DS_KILL_STEP} of round 2 (one degrade warning): "
          f"losses, masters, momenta and BN statistics bit-equal to "
          f"data_service = local; launches per step {DS_WANT} | (d) "
          f"model_dir under file:// with io.read=once: io.retries "
          f"{retries}; round 2 answered task = pred to file:// | the "
          f"probe's data wait a step, rounds 1 and 2: {svc_ms} ms over the "
          f"service (round 2 degraded after step {DS_KILL_STEP}), "
          f"{local_ms} ms local (not gated) | readers {len(first) / t_first:.2f} "
          f"frames/s cold ({len(first) * TRAIN_BATCH / t_first:.1f} "
          f"images/s), fetch p50/p99 {pct(lat_cold, 50):.1f}/"
          f"{pct(lat_cold, 99):.1f} ms cold, {pct(lat_warm, 50):.1f}/"
          f"{pct(lat_warm, 99):.1f} ms cached | runs {t_svc:.1f}s service,"
          f" {t_local:.1f}s local | {took:.1f}s ({spans}) | {smi_line}",
          flush=True)
    return {"data_ms_service": svc_ms, "data_ms_local": local_ms,
            "frames_per_s_cold": len(first) / t_first,
            "images_per_s_cold": len(first) * TRAIN_BATCH / t_first,
            "cache_hits_second_client": hits1 - hits0,
            "fetch_ms_cold": [pct(lat_cold, 50), pct(lat_cold, 99)],
            "fetch_ms_cached": [pct(lat_warm, 50), pct(lat_warm, 99)],
            "losses": losses, "failovers": f1, "io_retries": retries,
            "write_seconds": t_write, "service_run_seconds": t_svc,
            "local_run_seconds": t_local, "seconds": took,
            "marks": {k: v - t_start for k, v in marks.items()},
            "card": smi_line}



# -- phase 21: the rest of the net grammar ------------------------------------

MOE_CONF = os.path.join(ROOT, "examples", "LM", "tiny_moe_lm.conf")
#: tiny_moe_lm.conf's S 64 is under attn_block's 128, where attn_impl =
#: auto takes the reference attention: (a) asks for the flash path
MOE_OVERRIDES = ("attn_impl=flash",)
#: (a): a token whose first three gates lie closer than this may be routed
#: otherwise by last-bit differences of the two runs; a step with such a
#: flip is counted and its gradients are not held (the loss still is)
MOE_TIE = 1e-5
#: (b): bowl.conf's net with one EXTRA_DIM-wide extra_data input after
#: fl, over GRAMMAR_TRAIN + GRAMMAR_VAL 48x48 JPEG records (GRAMMAR_UNIQUE
#: distinct seeded images), every GRAMMAR_FOUR-th the fixture's 48x48
#: CMYK or YCCK file in turn; the side file lacks every fifth id
EXTRA_DIM = 16
GRAMMAR_TRAIN, GRAMMAR_VAL, GRAMMAR_UNIQUE, GRAMMAR_FOUR = 512, 128, 64, 8
#: (c): AlexNet's node shapes at its batch, (name, type, keys, NHWC input)
ALEX_B = 256
GRAMMAR_LAYERS = (
    ("bias fc6", "bias", "  init_bias = 0.5", (ALEX_B, 1, 1, 4096)),
    ("prelu pool1", "prelu", "  random = 0.3\n  random_slope = 1",
     (ALEX_B, 27, 27, 96)),
    ("fixconn fc7", "fixconn", "  weight_file = {wfile}",
     (ALEX_B, 1, 1, 4096)),
    ("maxout conv1", "maxout", "  num_piece = 2", (ALEX_B, 55, 55, 96)),
    ("maxout fc6", "maxout", "  num_piece = 4", (ALEX_B, 1, 1, 4096)),
    ("pairtest conv2", "pairtest-conv-conv",
     "  nchannel = 256\n  kernel_size = 5\n  pad = 2\n  ngroup = 2",
     (ALEX_B, 27, 27, 96)),
    ("plugin pool2", "plugin", "  plugin_module = torch_plugin_layer\n"
     "  plugin_layer = ScaleShift\n  init_scale = 0.5",
     (ALEX_B, 13, 13, 256)),
    ("insanity_max_pooling conv1", "insanity_max_pooling",
     "  kernel_size = 3\n  stride = 2", (ALEX_B, 55, 55, 96)),
)
#: (c): f32 on the card against the CPU: max |d| over max |CPU| for the
#: elementwise layers, rel L2 for the products (the sums' order); the
#: pick's outputs that differ (a near-tie of the uniform draw and a cdf
#: step, whose f32 sums may differ in the last bit) as a share of all
GRAMMAR_ELEM_TOL, GRAMMAR_SUM_TOL, GRAMMAR_PICK_SHARE = 1e-6, 1e-5, 1e-5
#: (c): AlexNet's conv2 (5x5, 2 groups, pad 2) at its batch, for the
#: float64 reference of its weight gradient: cuDNN's own float32
#: algorithms (Winograd, FFT) read 5.1e-3 rel L2 from it on an NVIDIA H100
#: 80GB HBM3 at 700.00 W, so the port's float32 conv takes its weight
#: gradient as an im2col gemm (layers/conv.py; PERF.md section 7)
WGRAD_CONV2 = ((ALEX_B, 96, 27, 27), (256, 48, 5, 5), 2, 2)


def moe_cfg(seed: int, model_dir: str, extra=()):
    """tiny_moe_lm.conf as written, its sections included, weights drawn
    from ``seed``, the flash path asked for (MOE_OVERRIDES)."""
    from cxxnet_tpu_torch.config import parse_cli_overrides, parse_config_file
    return parse_config_file(MOE_CONF) + parse_cli_overrides([
        "task=train", "num_round=1", f"model_dir={model_dir}",
        "save_model=1", f"seed={seed}", *MOE_OVERRIDES, *extra])


def _route_recorder(tr) -> list:
    """Wrap the route of each moe layer of ``tr``'s network to record the
    gates and the choices of each forward; returns the record list."""
    rec = []
    for layer in tr.net.layers:
        if layer.spec.type != "moe":
            continue
        real = layer.route

        def route(x, router, dp=None, _real=real):
            gates, sel, aux = _real(x, router, dp)
            rec.append((gates.detach(),
                        [oh.detach().argmax(-1) for oh, _ in sel]))
            return gates, sel, aux
        layer.route = route
    return rec


def _tie_gaps(gates: torch.Tensor) -> torch.Tensor:
    """Per token, the least gap between its first three gates."""
    g = gates.float().topk(3, dim=-1).values
    return (g[..., :-1] - g[..., 1:]).min(dim=-1).values


def moe_step_check(kern, plain, snap, batch, epoch, rk, rp):
    """One step's loss and gradients with the kernels and with
    fused_kernels = 0 from the same state: (loss difference of max(1,
    |loss|), per-leaf gradient rel L2 pairs, tokens routed otherwise, the
    largest tie gap of those tokens)."""
    got = []
    for t, rec in ((kern, rk), (plain, rp)):
        _load(t, snap, epoch)
        rec.clear()
        loss, _, _, grads = t.gradients(batch)
        got.append((float(loss.detach()), grads))
    (lk, gk), (lp, gp) = got
    flips, gap = 0, 0.0
    for (gk_, ck), (gp_, cp) in zip(rk, rp):
        diff = torch.zeros_like(ck[0], dtype=torch.bool)
        for a, b in zip(ck, cp):
            diff |= a != b
        if bool(diff.any()):
            flips += int(diff.sum())
            gap = max(gap, float(_tie_gaps(gp_)[diff].max()))
    return abs(lk - lp) / max(1.0, abs(lp)), _grad_rels(gk, gp), flips, gap


def grammar_moe(seed: int, tmp: str) -> dict:
    """Phase 21 (a): tiny_moe_lm.conf trained one round through main.run
    with the kernels and with fused_kernels = 0 from the same init, each
    kernel step held against the plain step from the same state, then
    ``task = pred`` on the round."""
    from cxxnet_tpu_torch.config import parse_cli_overrides
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    runs = {}
    for mode, extra in (("kernels", ()), ("plain", ("fused_kernels=0",))):
        model_dir = os.path.join(tmp, f"moe_{mode}")
        cfg = moe_cfg(seed, model_dir, extra)
        box = {"losses": [], "before": [], "per_step": [], "batches": []}

        def on_step(tr, box=box):
            box["losses"].append(tr.last_loss)
            box["per_step"].append({k: KERNELS[k].launches for k in KERNELS})
            reset_launches()
            box["before"].append(_snap(tr))

        def ready(tr, box=box):
            box["before"].append(_snap(tr))
            tr.step_hook = on_step
            update = tr.update

            def keep(b):
                box["batches"].append(getattr(b, "host", b))
                update(b)
            tr.update = keep
            torch.cuda.synchronize()
            reset_launches()              # just before the first step
            box["t0"] = time.perf_counter()

        tr = run(cfg, ready=ready)
        torch.cuda.synchronize()
        box["took"] = time.perf_counter() - box["t0"]
        del tr.update
        tr.step_hook = None
        runs[mode] = (tr, box, cfg, model_dir)
    tr, box, cfg, model_dir = runs["kernels"]
    steps = len(box["losses"])
    mha = [l for l in tr.net.layers if l.spec.type == "mha"]
    moe = [l for l in tr.net.layers if l.spec.type == "moe"]
    groups = len(tr.optimizer._groups(tr.params))
    want = {"flash_fwd": len(mha), "flash_bwd_dq": len(mha),
            "flash_bwd_dkv": len(mha), "adam_apply": groups}
    if steps != 32 or not mha or not moe or moe[0].topk != 2:
        raise AssertionError(f"moe: {steps} steps, {len(mha)} mha, "
                             f"{len(moe)} moe layers")
    for i, n in enumerate(box["per_step"]):
        check_launches(f"moe step {i + 1}", n, want, {})
    plain_box = runs["plain"][1]
    ran = {k: v for n in plain_box["per_step"] for k, v in n.items() if v}
    if ran:
        raise AssertionError(f"moe: fused_kernels = 0 launched {ran}")
    for mode in runs:
        if not all(np.isfinite(runs[mode][1]["losses"])):
            raise AssertionError(f"moe {mode}: non-finite loss "
                                 f"{runs[mode][1]['losses']}")
    drift = max(abs(a - b) for a, b in zip(box["losses"],
                                           plain_box["losses"]))
    # each kernel step against the plain step from the same state
    glob = [kv for kv in runs["plain"][0].cfg if kv[0] != "fused_kernels"]
    quiet = [("silent", "1")]
    kern = Trainer(glob + quiet)
    plain = Trainer(glob + quiet + [("fused_kernels", "0")])
    rk, rp = _route_recorder(kern), _route_recorder(plain)
    rows, fails = [], []
    for i, b in enumerate(box["batches"]):
        dl, rels, flips, gap = moe_step_check(kern, plain, box["before"][i],
                                              b, i, rk, rp)
        rows.append((dl, float(np.median([r for r, _ in rels])), max(rels),
                     flips, gap))
        if dl > LM_LOSS_TOL["float32"]:
            fails.append(f"step {i + 1} loss {dl:.3g}")
        if flips and gap >= MOE_TIE:
            fails.append(f"step {i + 1}: {flips} tokens routed otherwise, "
                         f"tie gap {gap:.3g} >= {MOE_TIE}")
        if not flips and max(rels)[0] > LM_GRAD_TOL["float32"]:
            fails.append(f"step {i + 1} gradient {max(rels)}")
    if fails:
        raise AssertionError(
            f"moe: kernels vs fused_kernels=0 from the same state (tol loss "
            f"{LM_LOSS_TOL['float32']}, gradient {LM_GRAD_TOL['float32']}, "
            f"tie {MOE_TIE}): {fails}")
    del kern, plain
    step_ms = time_forward(lambda: tr.update(box["batches"][0]), reps=10)
    # task = pred on the round
    pred = os.path.join(tmp, "moe_pred.txt")
    t0 = time.perf_counter()
    run([kv for kv in cfg if kv[0] not in ("task", "num_round")]
        + parse_cli_overrides(["task=pred", f"name_pred={pred}",
                               f"model_in={model_dir}/0000.model"]))
    pred_s = time.perf_counter() - t0
    ids = np.loadtxt(pred, ndmin=1)
    n_rows = int(dict(glob)["batch_size"]) * steps
    S, V = 64, 32
    if ids.shape != (n_rows,) or not np.all((ids >= 0) & (ids < S * V)) \
            or not np.array_equal(ids, np.rint(ids)):
        raise AssertionError(f"moe pred: {ids.shape} rows, want {n_rows} "
                             f"ids in [0, {S * V})")
    flipped = [i + 1 for i, r in enumerate(rows) if r[3]]
    worst = max(rows, key=lambda r: r[2][0])
    print(f"grammar (a) moe: {steps} steps of {os.path.relpath(MOE_CONF, ROOT)}"
          f" as written (E 64, 4 heads, S 64, batch 64, 4 experts top-2, "
          f"Adam, f32, {' '.join(MOE_OVERRIDES)}) through main.run with the "
          f"kernels in {box['took']:.1f}s and with fused_kernels = 0 in "
          f"{plain_box['took']:.1f}s from the same init | losses "
          f"{box['losses'][0]:.4f} -> {box['losses'][-1]:.4f}, the runs "
          f"apart by {drift:.3g} at most | launches per step {want}, every "
          f"step | vs fused_kernels=0 from the same state, worst of "
          f"{steps} steps: loss {max(r[0] for r in rows):.2g}, gradient "
          f"rel L2 {worst[2][0]:.2g} ({worst[2][1]}), median "
          f"{max(r[1] for r in rows):.2g} (tol {LM_LOSS_TOL['float32']}, "
          f"{LM_GRAD_TOL['float32']}); steps with a near-tie flip "
          f"{flipped} | train step {step_ms:.3f} ms | task=pred over "
          f"{n_rows} rows in {pred_s:.1f}s", flush=True)
    return {"losses": box["losses"], "plain_losses": plain_box["losses"],
            "drift": drift, "checks": rows, "launches_per_step": want,
            "step_ms": step_ms, "seconds": box["took"],
            "plain_seconds": plain_box["took"], "pred_seconds": pred_s,
            "flip_steps": flipped}


def grammar_records(tmp: str, seed: int):
    """(b)'s record files and side file: seeded 48x48 quality-90 JPEGs,
    every GRAMMAR_FOUR-th record the fixture's 48x48 CMYK or YCCK file
    in turn. Returns (paths, side file, the four-component files)."""
    from cxxnet_tpu_torch.io.recordio import ImageRecord, RecordWriter
    jfx = jpeg_fixture()
    four = {n: jfx.jpeg(n) for n in ("cmyk_48x48", "ycck_48x48")}
    rng = np.random.RandomState(seed)
    paths = {}
    for name, n in (("train", GRAMMAR_TRAIN), ("val", GRAMMAR_VAL)):
        enc = [jpeg_encode(img, JPEG_QUALITY) for img in
               seeded_images(rng, GRAMMAR_UNIQUE, BOWL_SIDE)]
        labels = rng.randint(0, BOWL_CLASSES, n)
        paths[name] = os.path.join(tmp, f"{name}.grammar.rec")
        with RecordWriter(paths[name]) as w:
            for i, lab in enumerate(labels):
                k = i // GRAMMAR_FOUR
                data = (list(four.values())[k % 2]
                        if i % GRAMMAR_FOUR == GRAMMAR_FOUR - 1
                        else enc[i % len(enc)])
                w.write(ImageRecord(inst_id=i, labels=np.float32([lab]),
                                    data=data).pack())
            w.write_index(paths[name])
    side = os.path.join(tmp, "side.txt")
    feats = rng.randn(GRAMMAR_TRAIN, EXTRA_DIM).astype(np.float32)
    with open(side, "w") as f:
        f.write(f"{EXTRA_DIM}\n")
        for i in range(GRAMMAR_TRAIN):
            if i % 5 != 4:
                f.write(" ".join([str(i)] + [repr(float(v))
                                             for v in feats[i]]) + "\n")
    return paths, side, four


def grammar_bowl_cfg(paths, side: str, mean: str, model_dir: str, extra=()):
    """bowl.conf as written, its sections' records and mean rewritten,
    ``attachtxt`` over ``side`` before each threadbuffer, and one
    EXTRA_DIM-wide extra_data input concatenated after ``fl``."""
    out = [("extra_data_num", "1"),
           ("extra_data_shape[0]", f"1,1,{EXTRA_DIM}")]
    for k, v in imgrec_cfg(BOWL_CONF, paths, mean, model_dir, extra):
        if (k, v) == ("iter", "threadbuffer"):
            out += [("iter", "attachtxt"), ("filename", side)]
        if (k, v) == ("layer[+1]", "flatten:fl"):
            out += [("layer[+1:flo]", "flatten:fl"),
                    ("layer[flo,in_1->flx]", "concat:flx")]
            continue
        out.append((k, v))
    return out


def grammar_bowl(seed: int, tmp: str, extra=()) -> dict:
    """Phase 21 (b): bowl.conf's net with an extra_data input fed by
    attachtxt over JPEG records (CMYK and YCCK among them), one round
    through main.run, each step against fused_kernels = 0."""
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.io.decode import decode_image
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    tmp = os.path.join(tmp, "grammar_bowl")
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    paths, side, four = grammar_records(tmp, seed)
    t_write = time.perf_counter() - t0
    model_dir = os.path.join(tmp, "models")
    cfg = grammar_bowl_cfg(paths, side, os.path.join(tmp, "mean.bin"),
                           model_dir, extra)
    glob, _ = split_sections(cfg)
    batch = int(dict(glob)["batch_size"])
    steps = GRAMMAR_TRAIN // batch
    counted = ("epilogue_fwd", "epilogue_bwd", "sgd_apply")
    box = {"losses": [], "before": [], "batches": [], "per_step": []}

    def on_step(tr):
        box["losses"].append(tr.last_loss)
        box["per_step"].append({k: KERNELS[k].launches for k in KERNELS})
        reset_launches()
        box["before"].append(_snap(tr))

    def ready(tr):
        box["before"].append(_snap(tr))
        tr.step_hook = on_step
        update = tr.update

        def keep(b):
            box["batches"].append(getattr(b, "host", b))
            update(b)
        tr.update = keep
        torch.cuda.synchronize()
        reset_launches()                  # just before the first step
        box["t0"] = time.perf_counter()

    tr = run(cfg, ready=ready)
    torch.cuda.synchronize()
    took = time.perf_counter() - box["t0"]
    del tr.update
    tr.step_hook = None
    batches, losses = box["batches"], box["losses"]
    if len(losses) != steps:
        raise AssertionError(f"grammar bowl: {len(losses)} steps, want "
                             f"{steps}")
    ex = [b.extra_data for b in batches]
    if any(len(e) != 1 or e[0].shape != (batch, 1, 1, EXTRA_DIM)
           for e in ex):
        raise AssertionError("grammar bowl: each batch must carry one "
                             f"(batch, 1, 1, {EXTRA_DIM}) side array")
    zero_rows = sum(int((~b.extra_data[0].any(axis=(1, 2, 3))).sum())
                    for b in batches)
    if zero_rows == 0:
        raise AssertionError("grammar bowl: no missing id joined as zeros")
    biased = sum(1 for layer in tr.net.layers
                 if layer.spec.type in ("conv", "fullc")
                 and not layer.hp.no_bias)
    want = {"epilogue_fwd": biased, "epilogue_bwd": biased,
            "sgd_apply": len(tr.optimizer._groups(tr.params))}
    others = {}
    for i, n in enumerate(box["per_step"]):
        check_launches(f"grammar bowl step {i + 1}", n, want, {})
        others.update({k: v for k, v in n.items()
                       if k not in counted and v})
    if others:
        raise AssertionError(f"grammar bowl: other kernels launched {others}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"grammar bowl: non-finite loss {losses}")
    dt = dict(glob).get("compute_dtype", "float32")
    quiet = [("silent", "1")]
    kern = Trainer(glob + quiet)
    plain = Trainer(glob + quiet + [("fused_kernels", "0")])
    rows = []
    for i, b in enumerate(batches):
        dl, rels, spread = convnet_step_check(kern, plain, box["before"][i],
                                              b, i, dt)
        rows.append((dl, float(np.median([r for r, _ in rels])), max(rels),
                     spread))
    fails = [f"step {i + 1}: {r}" for i, r in enumerate(rows)
             if r[0] > CONVNET_LOSS_TOL[dt] or r[1] > CONVNET_GRAD_TOL[dt][0]
             or r[2][0] > CONVNET_GRAD_TOL[dt][1]]
    if fails:
        raise AssertionError(f"grammar bowl: kernels vs fused_kernels=0 "
                             f"from the same state (tol loss "
                             f"{CONVNET_LOSS_TOL[dt]}, gradient "
                             f"{CONVNET_GRAD_TOL[dt]}): {fails}")
    del kern, plain
    step_ms = time_forward(lambda: tr.update(batches[0]), reps=10)
    # the records' four-component files through nvJPEG, against the
    # fixture's CPU pixels
    jfx = jpeg_fixture()
    dev = torch.device("cuda", torch.cuda.current_device())
    nv = {}
    for name, data in four.items():
        for w in (3, 1):
            got = decode_image(data, w, dev)
            d = np.abs(got.astype(np.int32)
                       - jfx.pixels(name, w).astype(np.int32))
            bmax, bmean = jfx.bound_of(name, w)
            nv[f"{name}/{w}"] = (int(d.max()), round(float(d.mean()), 4))
            if d.max() > bmax or (bmean is not None and d.mean() > bmean):
                raise AssertionError(f"grammar bowl: nvJPEG on {name} to {w}"
                                     f": {nv[f'{name}/{w}']} over {bmax}, "
                                     f"{bmean}")
    fmt = [(f"{dl:.2g}", f"{md:.2g}", f"{w[0]:.2g}") for dl, md, w, _ in rows]
    print(f"grammar (b) attachtxt: {steps} steps of "
          f"{os.path.relpath(BOWL_CONF, ROOT)}'s net and sections with an "
          f"extra_data input ({EXTRA_DIM} features by attachtxt, "
          f"concatenated after fl; {zero_rows} rows of missing ids zero) "
          f"over {GRAMMAR_TRAIN} + {GRAMMAR_VAL} JPEG records of 48x48 (every "
          f"{GRAMMAR_FOUR}th CMYK or YCCK), written in {t_write:.1f}s, "
          f"through main.run in {took:.1f}s | losses "
          f"{[round(v, 4) for v in losses]} | launches per step {want} "
          f"(each step, no other kernel) | vs fused_kernels=0 from the same "
          f"state (loss diff, gradient rel L2 median, worst leaf): {fmt} "
          f"(tol {CONVNET_LOSS_TOL[dt]}, {CONVNET_GRAD_TOL[dt]}) | nvJPEG on "
          f"the CMYK and YCCK records vs the CPU pixels (max, mean |d|): "
          f"{nv} | train step {step_ms:.3f} ms", flush=True)
    return {"losses": losses, "checks": rows, "launches_per_step": want,
            "nvjpeg_four": nv, "step_ms": step_ms, "seconds": took,
            "write_seconds": t_write, "zero_rows": zero_rows}


class SharedDraws:
    """Uniform draws made on the CPU from one seed and moved to the
    device asked for: the card's layer and the CPU's draw the same
    numbers."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, torch.device(device)

    def uniform(self, shape, dtype):
        g = torch.Generator().manual_seed(self.seed)
        return torch.rand(tuple(shape), generator=g).to(self.device, dtype)

    def keep_mask(self, shape, pkeep):
        return self.uniform(shape, torch.float32) < pkeep


def grammar_layer_case(name, kind, keys, shape, seed, wfile,
                       devices=("cuda", "cpu")):
    """One layer of (c) on the card and on the CPU (``devices``) from the
    same params, input, draws and upstream gradient, f32: (output, input
    gradient, parameter gradients) of each, as CPU tensors, by device;
    a pairtest's params are its master's and slave's."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.layers import ApplyCtx
    from cxxnet_tpu_torch.model import Network
    b, y, x, c = shape
    in_shape = f"1,1,{c}" if y == x == 1 else f"{c},{y},{x}"
    text = (f"netconfig = start\nlayer[in->o] = {kind}:ly\n"
            f"{keys.format(wfile=wfile)}\nnetconfig = end\n"
            f"input_shape = {in_shape}\n")
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(shape, generator=g)
    out = {}
    for dev in devices:
        cfg = parse_config_string(text + ("dev = cpu\n" if dev == "cpu"
                                          else ""))
        net = Network(build_graph(cfg), cfg)
        layer = net.layers[0]
        # a conv alone draws what a pairtest's master draws
        params, _ = net.init(torch.Generator().manual_seed(seed + 1))
        flat = []

        def place(t):
            if isinstance(t, dict):
                return {k: place(v) for k, v in t.items()}
            t = t.to(dev).requires_grad_(True)
            flat.append(t)
            return t
        lp = place(params.get("ly", {}))
        xt = xs.to(dev).requires_grad_(True)
        (yv,) = layer.forward(layer.cast_params(lp, torch.float32), {}, [xt],
                              ApplyCtx(compute_dtype=torch.float32,
                                       train=True, state_sink={},
                                       fused=dev == "cuda",
                                       draws=SharedDraws(seed + 2, dev)))
        dy = torch.randn(yv.shape, generator=torch.Generator().manual_seed(
            seed + 3)).to(dev)
        # pairtest's slave params do not reach the output: zeros
        grads = torch.autograd.grad(yv, [xt] + flat, dy, allow_unused=True)
        out[dev] = (yv.detach().cpu(),
                    [torch.zeros(t.shape) if gr is None else gr.cpu()
                     for t, gr in zip([xt] + flat, grads)])
    return out


def _elem_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def grammar_layers(seed: int, tmp: str) -> dict:
    """Phase 21 (c): each new layer type and insanity_max_pooling's
    training pick at AlexNet's node shapes (batch 256), f32 on the card
    against the CPU, shared params, draws and upstream gradient."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one cuDNN algorithm for a conv's weight gradient (some add with
    # atomics): the pairtest and its master alone then agree bit for bit
    torch.backends.cudnn.deterministic = True
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)            # torch_plugin_layer
    wfile = os.path.join(tmp, "fixconn.txt")
    w = np.random.RandomState(seed).randn(4096, 16).astype(np.float32)
    with open(wfile, "w") as f:
        f.write("4096 16 " + " ".join(repr(float(v)) for v in w.ravel())
                + "\n")
    rows, fails = {}, []
    try:
        for i, (name, kind, keys, shape) in enumerate(GRAMMAR_LAYERS):
            t0 = time.perf_counter()
            r = grammar_layer_case(name, kind, keys, shape, seed + 10 * i,
                                   wfile)
            (yc, gc), (yh, gh) = r["cuda"], r["cpu"]
            if kind == "insanity_max_pooling":
                share = float((yc != yh).float().mean())
                dx_share = float((gc[0] != gh[0]).float().mean())
                rows[name] = {"pick_share": share, "dx_share": dx_share}
                if share > GRAMMAR_PICK_SHARE or dx_share > 9 * \
                        GRAMMAR_PICK_SHARE:
                    fails.append(f"{name}: {rows[name]}")
            else:
                products = kind in ("fixconn", "pairtest-conv-conv")
                err = (lambda a, b: _rel(a, b)) if products else _elem_err
                tol = GRAMMAR_SUM_TOL if products else GRAMMAR_ELEM_TOL
                errs = [err(yc, yh)] + [err(a, b) for a, b in zip(gc, gh)]
                tols = [tol] * len(errs)
                if kind == "pairtest-conv-conv":
                    alone = grammar_layer_case(
                        name, "conv", keys, shape, seed + 10 * i, wfile,
                        devices=("cuda",))["cuda"]
                    same = bool(torch.equal(alone[0], yc)) and all(
                        torch.equal(a, b) for a, b in zip(alone[1], gc))
                    rows[name] = {"master_alone_equal": same}
                    if not same:
                        fails.append(f"{name}: differs from its master conv "
                                     "alone on the card")
                rows.setdefault(name, {})["errs"] = [f"{e:.3g}" for e in errs]
                bad = [(e, t) for e, t in zip(errs, tols) if e > t]
                if bad:
                    fails.append(f"{name}: {errs} (tol {tols})")
            rows[name]["seconds"] = round(time.perf_counter() - t0, 2)
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    if fails:
        raise AssertionError(f"grammar layers, card vs CPU in f32: {fails}")
    print(f"grammar (c) layers at AlexNet's node shapes (batch {ALEX_B}), "
          f"f32 card vs CPU, output and every gradient (tol elementwise "
          f"{GRAMMAR_ELEM_TOL} of max|CPU|, products rel L2 "
          f"{GRAMMAR_SUM_TOL}, picks that differ {GRAMMAR_PICK_SHARE}): "
          f"{rows}", flush=True)
    return rows


def grammar_wgrad(seed: int) -> dict:
    """Phase 21 (c): AlexNet conv2's float32 weight gradient on the card,
    the port's (``layers.conv.conv2d_weight_gemm``) and cuDNN's with and
    without ``cudnn.deterministic`` (its kernels named from the
    profiler), and the CPU's, each as rel L2 from a float64 CPU
    reference of the same inputs; the port's within GRAMMAR_SUM_TOL."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from cxxnet_tpu_torch.layers.conv import conv2d_weight_gemm
    xs, ws, groups, pad = WGRAD_CONV2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g)
    w = torch.randn(ws, generator=g) * 0.05
    gy = torch.randn((xs[0], ws[0]) + xs[2:], generator=g)
    t0 = time.perf_counter()
    w64 = w.double().requires_grad_(True)
    (want,) = torch.autograd.grad(
        F.conv2d(x.double(), w64, padding=pad, groups=groups), [w64],
        gy.double())
    ref_s = time.perf_counter() - t0

    def rel(got):
        return float((got.double().cpu() - want).norm() / want.norm())
    wc = w.clone().requires_grad_(True)
    (cpu,) = torch.autograd.grad(F.conv2d(x, wc, padding=pad,
                                          groups=groups), [wc], gy)
    out = {"cpu": rel(cpu), "f64_s": round(ref_s, 2)}
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xg, gyg = x.cuda(), gy.cuda()
    try:
        out["port"] = rel(conv2d_weight_gemm(xg, gyg, ws, 1, (pad, pad),
                                             groups))
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            wg = w.cuda().requires_grad_(True)

            def cudnn_wgrad():
                return torch.autograd.grad(
                    F.conv2d(xg, wg, padding=pad, groups=groups), [wg],
                    gyg)[0]
            cudnn_wgrad()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                got = cudnn_wgrad()
                torch.cuda.synchronize()
            kinds = sorted({e.key.split("<")[0].split("(")[0][:48]
                            for e in p.key_averages()
                            if "wgrad" in e.key.lower()
                            or "winograd" in e.key.lower()
                            or "fft" in e.key.lower()})
            out[f"cudnn det={int(det)}"] = {"rel": rel(got),
                                            "kernels": kinds}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cuda.matmul.allow_tf32) = prev
    if not out["port"] <= GRAMMAR_SUM_TOL:
        raise AssertionError(f"conv2's float32 weight gradient of the "
                             f"port vs float64: {out}")
    print(f"grammar (c) AlexNet conv2 float32 weight gradient, rel L2 from "
          f"a float64 CPU reference: {out}", flush=True)
    return out


def phase_grammar(conf: str, seed: int, tmp: str, smi_line: str) -> dict:
    """Phase 21: (a) experts, (b) attachtxt / extra_data with CMYK and
    YCCK records, (c) the remaining layers (module docstring)."""
    t0 = time.perf_counter()
    moe = grammar_moe(seed, tmp)
    torch.cuda.empty_cache()
    bowl = grammar_bowl(seed, tmp)
    torch.cuda.empty_cache()
    layers = grammar_layers(seed, tmp)
    layers["conv2 wgrad"] = grammar_wgrad(seed)
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    print(f"grammar: phase 21 in {took:.1f}s | MoE step {moe['step_ms']:.3f}"
          f" ms, attachtxt net step {bowl['step_ms']:.3f} ms | {smi_line}",
          flush=True)
    return {"moe": moe, "attachtxt": bowl, "layers": layers,
            "seconds": took}


# -- phase 22 ------------------------------------------------------------------

#: (a): steps of each health run, two probe intervals
OPS_STEPS, OPS_INTERVAL = 16, 8
#: (b): steps a round, and the fault: device.step fires at the 7th check,
#: in round 1 (steps 5-8), and the sentinel's check at tick 8 trips
OPS_ROUND_STEPS, OPS_FAULT = 4, "device.step=every:7"
#: (a): the straggler rule's factor: host 1 runs 3x slower, and the
#: median of each host sits somewhere inside a bucket of the step-time
#: histogram, whose edges lie 2.15x apart
OPS_STRAGGLER_FACTOR = 1.5
#: (d): the data wait a batch, over telemetry_hang_s = 1
OPS_THROTTLE_MS, OPS_HANG_STEPS = 1500, 2
#: (e): steps served by the reader
OPS_DS_STEPS = 2


def _with_throttle(cfg, ms: int):
    """``cfg`` with its train data section wrapped by ``iter = throttle``."""
    out, in_data = [], False
    for k, v in cfg:
        if (k, v) == ("data", "train"):
            in_data = True
        elif in_data and (k, v) == ("iter", "end"):
            out += [("iter", "throttle"), ("throttle_ms", str(ms))]
            in_data = False
        out.append((k, v))
    return out


def _slow_host(fleet_dir: str, run_id: str, factor: float = 3.0) -> float:
    """Write host 1's snapshot into ``fleet_dir``: 8 steps at ``factor``
    times this process's median step time (its
    ``cxxnet_steptime_step_seconds`` histogram, whose edges it takes);
    returns this process's median in seconds."""
    from cxxnet_tpu_torch.telemetry.aggregate import quantile, write_snapshot
    from cxxnet_tpu_torch.telemetry.registry import REGISTRY, MetricRegistry
    fam = REGISTRY.get("cxxnet_steptime_step_seconds")
    (_, child), = fam.samples()
    edges, counts, _, _ = child.raw()
    med = quantile(list(edges), counts, 0.5)
    reg = MetricRegistry()
    h = reg.histogram("cxxnet_steptime_step_seconds", "", buckets=edges)
    for _ in range(8):
        h.observe(factor * med)
    write_snapshot(fleet_dir, 1, reg, run_id=run_id)
    return med


def _ops_health(conf: str, seed: int, tmp: str, health: int) -> dict:
    """(a): one OPS_STEPS run with ``health``: each step's loss (device),
    the final (masters, momenta, BN state), the run's host syncs, the
    step's wall ms, one step's CUDA graph, a /metrics scrape at step 12,
    and the fleet pieces (the straggler verdict)."""
    from cxxnet_tpu_torch.telemetry.ledger import read_ledger
    port = _free_port()
    fleet = os.path.join(tmp, f"fleet{health}")
    run_id = f"ops-health{health}"
    led = os.path.join(tmp, f"ops_health{health}.jsonl")
    cfg = _train_only(train_cfg(conf, seed, os.path.join(tmp, f"h{health}"), (
        f"health={health}", f"health_interval={OPS_INTERVAL}",
        "save_model=0", "print_step=0", f"telemetry_port={port}",
        f"telemetry_fleet_dir={fleet}", f"telemetry_run_id={run_id}",
        "telemetry_straggler_min_steps=4",
        f"telemetry_straggler_factor={OPS_STRAGGLER_FACTOR}",
        f"telemetry_ledger={led}"),
        steps=OPS_STEPS, classes=TEL_CLASSES))
    losses, stamps, box = [], [], {}

    def on_step(tr):
        losses.append(tr.last_loss_tensor.detach().clone())
        stamps.append(time.perf_counter())
        if tr.step_count == 12:
            box["scrape"] = _scrape(port)
        if tr.step_count == OPS_STEPS - 1:
            box["median_s"] = _slow_host(fleet, run_id)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        syncs = _host_syncs(lambda: box.update(
            run=_train_run(cfg, on_step)))
    sys.stdout.write(printed.getvalue())
    tr = box["run"][0]
    snap = _snap(tr)
    # a batch of one step's data section (a fresh draw of all OPS_STEPS
    # batches would cost seconds of the generator)
    staged = tr.stage_batch(_first_batch(split_sections_of(_train_only(
        train_cfg(conf, seed, tmp, steps=1, classes=TEL_CLASSES)))))
    mask = tr._mask(staged.host)
    nodes = len(_graph_nodes(lambda: tr._step(
        staged.data, staged.label, mask, health=bool(health))))
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    strag = [e for e in read_ledger(led) if e["event"] == "straggler"]
    line = next((ln for ln in printed.getvalue().splitlines()
                 if ln.startswith("round") and "\tstraggler:" in ln), "")
    del tr, staged
    torch.cuda.empty_cache()
    return {"losses": torch.stack(losses).cpu(), "snap": snap,
            "syncs": syncs, "step_ms": 1e3 * statistics.median(gaps),
            "graph_nodes": nodes, "scrape": box.get("scrape", ""),
            "straggler_events": strag, "straggler_line": line,
            "median_s": box.get("median_s")}


def split_sections_of(cfg):
    """The global pairs plus the data section's, as one list."""
    from cxxnet_tpu_torch.config import split_sections
    glob, sections = split_sections(cfg)
    return glob + [p for kind, _, p in sections if kind == "data"][0]


def _replay(args, child: bool) -> tuple:
    """``python -m cxxnet_tpu_torch.replay *args`` in a process of its
    own (``child``) or its ``main`` in this one: (exit code, output,
    seconds)."""
    t0 = time.perf_counter()
    if child:
        r = subprocess.run([sys.executable, "-m", "cxxnet_tpu_torch.replay",
                            *args], cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, timeout=600)
        return r.returncode, r.stdout, time.perf_counter() - t0
    from cxxnet_tpu_torch.replay.__main__ import main as replay_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = replay_main(list(args))
    return rc, out.getvalue(), time.perf_counter() - t0


def _trace_events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _ops_tracing(conf: str, seed: int, tmp: str, model: str) -> dict:
    """(e): a reader process and the trainer, both traced, assembled by
    tools/trace_assemble.py; a traceparent sent to task = serve."""
    from cxxnet_tpu_torch.main import run
    ep = f"127.0.0.1:{_free_port()}"
    status = os.path.join(tmp, "ops_status")
    t_trainer = os.path.join(tmp, "ops_trainer.json")
    t_reader = os.path.join(tmp, "ops_reader.json")
    cfg = _train_only(train_cfg(conf, seed, os.path.join(tmp, "e"), (
        f"data_service={ep}", "data_service_shards=1",
        "data_service_timeout_ms=30000", f"telemetry_trace={t_trainer}",
        "telemetry_trace_sample=1", "save_model=0", "print_step=0"),
        steps=OPS_DS_STEPS, classes=TEL_CLASSES))
    conf_path = write_conf(os.path.join(tmp, "ops_e.conf"), cfg)
    log = open(os.path.join(tmp, "ops_reader.log"), "w")
    reader = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", conf_path,
         "task=data_reader", "dev=cpu", "data_service_reader=0",
         f"data_service_status_dir={status}", f"telemetry_trace={t_reader}"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.perf_counter() + DS_READY_S
        while not os.path.exists(os.path.join(status, "reader_0.json")):
            if reader.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError("the traced reader did not come up: "
                                     + open(log.name).read()[-3000:])
            time.sleep(0.05)
        run(cfg)
    finally:
        reader.send_signal(signal.SIGTERM)
        try:
            reader.wait(timeout=60)
        except subprocess.TimeoutExpired:
            reader.kill()
            reader.wait()
        log.close()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_assemble.py"),
         t_trainer, t_reader, "-o", os.path.join(tmp, "ops_fleet.json"),
         "--report", os.path.join(tmp, "ops_cp.json")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"trace_assemble exited {r.returncode}: "
                             f"{r.stdout[-2000:]}")
    with open(os.path.join(tmp, "ops_cp.json")) as f:
        report = json.load(f)
    fetch = [e for e in _trace_events(t_trainer)
             if e["name"] == "dataservice.fetch"]
    serve = {e["args"].get("parent_span_id") for e in
             _trace_events(t_reader) if e["name"] == "dataservice.serve"}
    unlinked = [e["args"]["span_id"] for e in fetch
                if e["args"]["span_id"] not in serve]
    if not fetch or unlinked or report["flow_links"] < len(fetch):
        raise AssertionError(
            f"trace_assemble: {len(fetch)} fetch spans, {len(unlinked)} "
            f"without the reader's serve span, {report['flow_links']} flow "
            f"links:\n{r.stdout[-1500:]}")
    # a traceparent sent to task = serve parents its request span
    t_serve = os.path.join(tmp, "ops_serve.json")
    tid, sid = os.urandom(16).hex(), os.urandom(8).hex()
    srv, t = start_serve(_serve_cfg(conf, [
        "task=serve", f"model_in={model}", "serve_port=0",
        "serve_buckets=1", "serve_max_batch=1", "silent=1",
        f"telemetry_trace={t_serve}"]))
    try:
        width = int(np.prod([int(v) for v in TRAIN_IMAGE.split(",")]))
        body = json.dumps({"data": np.random.RandomState(seed).randn(
            1, width).astype(np.float32).tolist()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict", data=body, headers={
                "Content-Type": "application/json",
                "traceparent": f"00-{tid}-{sid}-01"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            resp.read()
    finally:
        stop_serve(srv, t)
    reqs = [e for e in _trace_events(t_serve) if e["name"] == "serve.request"
            and e["args"].get("trace_id") == tid
            and e["args"].get("parent_span_id") == sid]
    kids = [e for e in _trace_events(t_serve)
            if e["args"].get("trace_id") == tid
            and e["name"] != "serve.request"]
    if len(reqs) != 1:
        raise AssertionError(f"no serve.request span under the sent "
                             f"traceparent (trace {tid})")
    return {"fetch_spans": len(fetch), "flow_links": report["flow_links"],
            "serve_children": sorted({e["name"] for e in kids})}


def phase_operations(conf: str, seed: int, tmp: str, smi_line: str,
                     telemetry: dict) -> dict:
    """Phase 22 (see the module docstring); ``telemetry`` is phase 19's
    result, whose child's profile bracket (f) reads."""
    from cxxnet_tpu_torch.checkpoint import load_model
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.telemetry.ledger import read_ledger
    t_start = time.perf_counter()
    marks = {}
    # (a) health on and off from one seed
    on = _ops_health(conf, seed, tmp, 1)
    off = _ops_health(conf, seed, tmp, 0)
    marks["health"] = time.perf_counter()
    equal = (torch.equal(on["losses"], off["losses"])
             and _bits_equal(on["snap"], off["snap"])
             and all(np.array_equal(a, b) for a, b in zip(
                 _flat_np(on["snap"][2]), _flat_np(off["snap"][2]))))
    extra = len(on["syncs"]) - len(off["syncs"])
    intervals = OPS_STEPS // OPS_INTERVAL
    gauges = [g for g in ("cxxnet_health_grad_norm",
                          "cxxnet_health_bn_var_min",
                          "cxxnet_health_dead_frac")
              if g not in on["scrape"]]
    graph_ok = off["graph_nodes"] == telemetry["graph_nodes"]
    strag = [e for e in on["straggler_events"] + off["straggler_events"]
             if e.get("straggler_host") == 1]
    lines_ok = all("straggler:h1(" in r["straggler_line"] for r in (on, off))
    if not equal or extra > intervals or gauges or not graph_ok \
            or len(strag) != 2 or not lines_ok:
        raise AssertionError(
            f"operations (a): health on/off bit-equal {equal}; host syncs "
            f"{len(on['syncs'])} on vs {len(off['syncs'])} off over "
            f"{intervals} intervals; gauges missing from /metrics {gauges}; "
            f"graph nodes health=0 {off['graph_nodes']} vs phase 19 "
            f"{telemetry['graph_nodes']}; straggler events {strag}, lines "
            f"{[r['straggler_line'] for r in (on, off)]}")
    # (b) a trip with provenance
    mdir_b = os.path.join(tmp, "b")
    led_b = os.path.join(tmp, "ops_trip.jsonl")
    cfg_b = _train_only(train_cfg(conf, seed, mdir_b, (
        "health=1", f"failpoints={OPS_FAULT}", f"telemetry_ledger={led_b}",
        "num_round=3", "print_step=0"), steps=OPS_ROUND_STEPS,
        classes=TEL_CLASSES))
    # the trip through the entry point, in a process of its own
    r = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.main",
         write_conf(os.path.join(tmp, "ops_trip.conf"), cfg_b)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=900)
    if r.returncode:
        raise AssertionError(f"operations (b): python -m "
                             f"cxxnet_tpu_torch.main exited "
                             f"{r.returncode}:\n{r.stdout[-3000:]}")
    final = load_model(os.path.join(mdir_b, "0002.model"))
    finite = all(np.isfinite(v).all() for d in final["params"].values()
                 for v in d.values())
    trips = [r for r in read_ledger(led_b)
             if r["event"] in ("sentinel_trip", "rollback")]
    prov = {r.get("provenance") for r in trips}
    if [r["event"] for r in trips] != ["sentinel_trip", "rollback"] \
            or len(prov) != 1 or not next(iter(prov)) or not finite:
        raise AssertionError(f"operations (b): {trips}, finite {finite}")
    provenance = next(iter(prov))
    marks["trip"] = time.perf_counter()
    # (c) replay: bit_exact with the fault, 0 or 2 without, 3 on drift
    # the recorded fault in a fresh process; the rest in this one
    rc_on, out_on, replay_s = _replay([led_b, "--last", "--failpoints",
                                       "on"], child=True)
    rc_off, out_off, _ = _replay([led_b, "--last", "--failpoints", "off"],
                                 child=False)
    drift = write_conf(os.path.join(tmp, "ops_drift.conf"),
                       [(k, "0.0123" if k == "eta" else v)
                        for k, v in cfg_b])
    rc_drift, out_drift, _ = _replay([led_b, "--last", "--config", drift],
                                     child=False)
    torch.cuda.empty_cache()
    if rc_on != 0 or "verdict: bit_exact" not in out_on \
            or f"replayed={provenance!r} OK" not in out_on \
            or rc_off not in (0, 2) or rc_drift != 3 \
            or "unreproducible:config-drift" not in out_drift \
            or "eta" not in out_drift:
        raise AssertionError(
            f"operations (c): --failpoints on exit {rc_on}:\n{out_on}\n"
            f"--failpoints off exit {rc_off}:\n{out_off}\n--config "
            f"drift exit {rc_drift}:\n{out_drift}")
    marks["replay"] = time.perf_counter()
    # (d) a hang under the throttle
    led_d = os.path.join(tmp, "ops_hang.jsonl")
    cfg_d = _with_throttle(_train_only(train_cfg(
        conf, seed, os.path.join(tmp, "d"), (
            "telemetry_hang_s=1", f"telemetry_ledger={led_d}",
            "save_model=0", "print_step=0"), steps=OPS_HANG_STEPS,
        classes=TEL_CLASSES)), OPS_THROTTLE_MS)
    run(cfg_d)
    torch.cuda.empty_cache()
    hangs = [r for r in read_ledger(led_d) if r["event"] == "hang_dump"]
    if not hangs or not all("thread" in r.get("stacks", "").lower()
                            for r in hangs):
        raise AssertionError(f"operations (d): hang_dump events {hangs}")
    marks["hang"] = time.perf_counter()
    # (e) distributed tracing
    tracing = _ops_tracing(conf, seed, tmp,
                           os.path.join(mdir_b, "0002.model"))
    marks["tracing"] = time.perf_counter()
    # (f) the attribution of phase 19's profile bracket
    att = telemetry["attribution"]
    zero = [ph for ph in ("conv", "bn_act", "pool", "optim")
            if not att["phases"].get(ph, {}).get("ms")]
    if not att["line"] or zero or att["bn_elsewhere"] \
            or att["phases"]["bn_act"]["count"] < att["bn_launches"]:
        raise AssertionError(f"operations (f): {att}")
    took = time.perf_counter() - t_start
    spans = ", ".join(f"{k} {v - t_start:.1f}s" for k, v in marks.items())
    print(f"operations: (a) health = 1 bit-equal to health = 0 over "
          f"{OPS_STEPS} steps (losses, masters, momenta, BN statistics); "
          f"host syncs {len(on['syncs'])} with health = 1, "
          f"{len(off['syncs'])} without ({extra} more over {intervals} "
          f"intervals of {OPS_INTERVAL}); step {on['step_ms']:.3f} ms with "
          f"health = 1, {off['step_ms']:.3f} ms without (not gated); one "
          f"step's CUDA graph {off['graph_nodes']} nodes with health = 0 "
          f"(phase 19: {telemetry['graph_nodes']}), {on['graph_nodes']} "
          f"with health = 1; cxxnet_health_* on /metrics; straggler "
          f"{on['straggler_events'][0]['ratio']}x: h1 named, 3x the "
          f"trainer's median {1e3 * on['median_s']:.2f} ms | (b) "
          f"sentinel_trip and rollback "
          f"provenance {provenance!r} | (c) replay --failpoints on exit "
          f"{rc_on} bit_exact in {replay_s:.1f}s, off exit {rc_off}, eta "
          f"drift exit {rc_drift} | (d) {len(hangs)} hang_dump(s) with a "
          f"{OPS_THROTTLE_MS} ms throttle under telemetry_hang_s = 1 | (e) "
          f"{tracing['fetch_spans']} dataservice.fetch spans all linked to "
          f"the reader's dataservice.serve ({tracing['flow_links']} flow "
          f"links), a sent traceparent parents serve.request and its "
          f"{tracing['serve_children']} | (f) {att['line']} (bn_fwd and "
          f"bn_bwd launches of the bracket {att['bn_launches']}, bn_act "
          f"{att['phases']['bn_act']['count']}) | {took:.1f}s ({spans}) | "
          f"{smi_line}", flush=True)
    return {"health_step_ms": on["step_ms"], "plain_step_ms": off["step_ms"],
            "host_syncs": [len(on["syncs"]), len(off["syncs"])],
            "graph_nodes": [on["graph_nodes"], off["graph_nodes"]],
            "provenance": provenance, "replay_s": replay_s,
            "replay_rc": [rc_on, rc_off, rc_drift], "hang_dumps": len(hangs),
            "tracing": tracing, "attribution": att, "seconds": took,
            "marks": {k: v - t_start for k, v in marks.items()},
            "card": smi_line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conf", default=FLAGSHIP)
    ap.add_argument("--json", default="", help="also write the results here")
    ap.add_argument("--phase", choices=("telemetry", "data_service",
                                        "grammar", "operations"),
                    help="run the build and this phase only (operations: "
                         "phase 19, then 22)")
    ap.add_argument("--ab", nargs="+", metavar="TREE",
                    help="only time the vectorised BN, epilogue, LRN, "
                         "max-pool backward, stem and Adam kernels of each "
                         "checkout root in turn (e.g. parent change change "
                         "parent)")
    ap.add_argument("--step-ab", nargs="+", metavar="TREE",
                    help="only time the STEP_AB train steps of each "
                         "checkout root in turn")
    ap.add_argument("--wgrad", action="store_true",
                    help="only time the float32 conv weight gradients of "
                         "WGRAD_SHAPES by each route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the "
              "port on the card only", file=sys.stderr, flush=True)
        return 2
    if args.ab:
        return run_ab(args.ab, args.seed)
    if args.step_ab:
        return run_ab(args.step_ab, args.seed, "step_ab_times")
    if args.wgrad:
        print(phase_env(), flush=True)
        wgrad_times(args.seed)
        return 0
    from cxxnet_tpu_torch.ops import KERNELS
    from cxxnet_tpu_torch.serve import InferenceEngine
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    marks = [("start", t_start)]

    def mark(what):
        marks.append((what, time.perf_counter()))
    smi_line = phase_env()
    phase_build()
    mark("build")
    if args.phase:
        phase = {"telemetry": phase_telemetry,
                 "data_service": phase_data_service,
                 "grammar": phase_grammar,
                 "operations": phase_telemetry}[args.phase]
        with tempfile.TemporaryDirectory() as tmp:
            res = phase(args.conf, args.seed, tmp, smi_line)
        if args.phase == "operations":
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory() as tmp:
                phase_operations(args.conf, args.seed, tmp, smi_line, res)
        print(smi_line, flush=True)
        return 0
    errs = phase_kernels(gen)
    errs.update(phase_train_kernels(gen, args.conf))
    errs.update(phase_sync_bn_kernels(gen, args.conf))
    errs.update(phase_lm_kernels(gen, LM_CONF))
    errs.update(phase_convnet_kernels(gen))
    errs.update(phase_stem_kernels(gen))
    mark("kernels")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model = write_round(args.conf, args.seed, tmp, torch.device("cuda"))
        engine, launches, answers, statz = phase_serve(
            args.conf, args.seed, model)
        served = {k: launches[k] for k in SERVE_KERNELS}
        missing = [k for k, n in served.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the served "
                                 f"path: {missing} ({launches})")
        plain = InferenceEngine.from_checkpoint(
            _serve_cfg(args.conf, ["fused_kernels=0"]), model,
            buckets=",".join(map(str, BUCKETS)), max_batch=BUCKETS[-1])
        worst = check_answers(plain, answers)
        del plain
        print(f"serve: {statz['requests']['ok']} requests ok over HTTP in "
              f"{time.perf_counter() - t0:.1f}s (round written, served by "
              f"main.run) | launches {served} | vs fused_kernels=0: max "
              f"prob diff {worst:.3g} (atol 2e-2) | latency_ms "
              f"{statz['latency_ms']} | batches {statz['batches']}", flush=True)
        times = phase_times(engine, gen)
        mark("serve")
        del engine
        tr, plain_tr, batches, launches, notes = phase_train(
            args.conf, args.seed, tmp)
        mark("train")
        tasks = phase_tasks(args.conf, args.seed, tmp, tr, smi_line)
        mark("tasks")
    train_times = phase_train_times(tr, plain_tr, batches, gen)
    glob = [kv for kv in plain_tr.cfg if kv[0] != "fused_kernels"]
    del tr, plain_tr
    torch.cuda.empty_cache()
    f32 = phase_train_f32(batches, notes["init"], glob)
    mark("train times")
    with tempfile.TemporaryDirectory() as tmp:
        tr, kern, plain_tr, lm_batches, lm_launches, lm_notes = phase_lm(
            args.seed, tmp)
        lm_serve = phase_lm_serve(args.seed, tmp, gen, smi_line)
        mark("lm serve")
        fleet = phase_fleet(args.conf, args.seed, tmp, lm_serve, smi_line)
        mark("fleet")
        cascade = phase_cascade(args.conf, args.seed, tmp, smi_line)
        mark("cascade")
    lm_times = phase_lm_times(tr, kern, plain_tr, lm_batches, gen)
    mark("lm")
    del tr, kern, plain_tr
    torch.cuda.empty_cache()
    # each kernel's time and launches from the path that runs it
    source = {k: (train_times, launches) for k in TRAIN_KERNELS}
    source.update({k: (lm_times, lm_launches) for k in lm_times["kernels"]})
    convnets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in CONVNETS:
            tr, plain_tr, cbatches, claunches, cnotes = phase_convnet(
                name, args.seed, tmp)
            ctimes = phase_convnet_times(name, tr, plain_tr, cbatches, gen)
            del tr, plain_tr, cbatches
            torch.cuda.empty_cache()
            convnets[name] = {"notes": cnotes, "times": ctimes,
                              "launches": claunches}
            mark(name)
            source.update({k: (ctimes, claunches)
                           for k in CONVNETS[name][3]})
        digits = phase_digits(args.seed, tmp)
        mark("digits")
    errs.update(phase_int8_kernels(gen))
    with tempfile.TemporaryDirectory() as tmp:
        int8 = phase_int8(args.conf, args.seed, tmp, times["forward"])
    int8_times = phase_int8_times(gen)
    mark("int8")
    source["q_mm"] = (int8_times,
                      {"q_mm": int8["inception_bn"]["launches_q_mm"]})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dp = phase_dp(args.conf, args.seed, tmp)
    dp_times = phase_dp_times(gen)
    mark("dp")
    source.update({k: (dp_times, dp["launches"]) for k in DP_KERNELS})
    with tempfile.TemporaryDirectory() as tmp:
        tr, ibatches, icfg, val_imgs, imgrec, imgrec_launches = \
            phase_imgrec(args.conf, args.seed, tmp)
        imgrec_times = phase_imgrec_times(tr, ibatches, icfg, val_imgs,
                                          train_times["step_ms"])
        del tr, ibatches
        torch.cuda.empty_cache()
        nvjpeg = phase_nvjpeg()
        tr, jbatches, jcfg, jval, imgrec_jpeg, jpeg_launches = \
            phase_imgrec(args.conf, args.seed, tmp, fmt="jpeg")
        jpeg_times = phase_jpeg_times(tr, jbatches, jcfg, jval,
                                      imgrec_times["step_ms"])
        del tr, jbatches
    torch.cuda.empty_cache()
    mark("imgrec")
    with tempfile.TemporaryDirectory() as tmp:
        bowl = phase_bowl(args.seed, tmp)
    torch.cuda.empty_cache()
    mark("bowl")
    with tempfile.TemporaryDirectory() as tmp:
        rest = phase_rest(args.conf, args.seed, tmp, train_times["step_ms"],
                          lm_times["step_ms"], gen)
    mark("rest")
    with tempfile.TemporaryDirectory() as tmp:
        telemetry = phase_telemetry(args.conf, args.seed, tmp, smi_line)
    mark("telemetry")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        data_service = phase_data_service(args.conf, args.seed, tmp,
                                          smi_line)
    mark("data_service")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        grammar = phase_grammar(args.conf, args.seed, tmp, smi_line)
    mark("grammar")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        operations = phase_operations(args.conf, args.seed, tmp, smi_line,
                                      telemetry)
    mark("operations")
    source["stem"] = (imgrec_times, imgrec_launches)
    kernels = []
    for name, k in KERNELS.items():
        times_of, launches_of = source[name]
        r = times_of["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cxxnet_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": launches_of[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    result = {"kernels": kernels,
              "forward_ms": {str(b): v[0] for b, v in times["forward"].items()},
              "forward_plain_ms": {str(b): v[1]
                                   for b, v in times["forward"].items()},
              "serve_kernels": {k: {kk: vv for kk, vv in r.items()
                                    if kk != "bound"}
                                for k, r in times["kernels"].items()},
              "train_step_ms": train_times["step_ms"],
              "train_step_plain_ms": train_times["step_plain_ms"],
              "bn_fwd_step": train_times["bn_fwd_step"],
              "bn_fwd_mid": {k: v for k, v in
                             train_times["kernels"]["bn_fwd (mid)"].items()
                             if k != "bound"},
              "train": {k: v for k, v in notes.items() if k != "init"},
              "train_f32": f32,
              "tasks": tasks,
              "lm_step_ms": lm_times["step_ms"],
              "lm_step_plain_ms": lm_times["step_plain_ms"],
              "lm": lm_notes, "lm_profile": lm_times["profile"],
              "lm_serve": lm_serve,
              "fleet": fleet,
              "cascade": cascade,
              "adam_inception_bn": {kk: vv for kk, vv in
                                    lm_times["adam_ibn"].items()
                                    if kk != "bound"},
              "convnets": {n: {"step_ms": c["times"]["step_ms"],
                               "step_plain_ms": c["times"]["step_plain_ms"],
                               "profile": c["times"]["profile"],
                               "kernels": {kk: {a: b for a, b in r.items()
                                                if a != "bound"}
                                           for kk, r in
                                           c["times"]["kernels"].items()},
                               **c["notes"]}
                           for n, c in convnets.items()},
              "digits": digits,
              "int8": int8,
              "int8_kernels": {k: {kk: vv for kk, vv in r.items()
                                   if kk != "bound"}
                               for k, r in int8_times["all"].items()},
              "dp": dp,
              "imgrec": {**imgrec, **{k: v for k, v in imgrec_times.items()
                                      if k != "kernels"}},
              "imgrec_jpeg": {**imgrec_jpeg, **jpeg_times,
                              "launches": jpeg_launches},
              "nvjpeg_fixture": nvjpeg,
              "bowl": bowl,
              "rest": rest,
              "telemetry": telemetry,
              "data_service": data_service,
              "grammar": grammar,
              "operations": operations,
              "phase_seconds": {b[0]: b[1] - a[1]
                                for a, b in zip(marks, marks[1:])},
              "card": smi_line, "seconds": time.perf_counter() - t_start}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(f"chip_smoke: all phases passed in {result['seconds']:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in
                      result["phase_seconds"].items()) + ")", flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run uses one card, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


def _serve_cfg(conf: str, overrides):
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file, split_sections)
    cfg, _ = split_sections(parse_config_file(conf))
    return cfg + parse_cli_overrides(list(overrides))


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        sys.exit(1)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cxxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--conf examples/ImageNet/inception_bn.conf]
                          [--json OUT.json]

Phases, each printing one line of its own; any failure exits non-zero
and prints no result:

1. env:     torch / CUDA versions, the card, compute capability 9.0.
2. build:   every kernel under ``cxxnet_tpu_torch/csrc`` built with nvcc
            for sm_90a (one nvcc per source, all at once).
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
            Adam apply over the LM's and Inception-BN's parameter groups,
            bit-equal; LRN forward and backward at AlexNet's lrn1 and
            lrn2 and at 7 rows by C 7, C 1500 and a ragged row count,
            nsize 3/4/5, knorm 1/2, beta 0.75/0.5 (f32 within 4 ulp of
            max|plain|, bf16/f16 one ulp); the first-match max-pool
            backward at spp1's shape, a 2x2 tile and a global 7x7
            window, pre_relu on and off, on tie-ridden integer inputs
            (bit-equal); the four data-parallel BN kernels at every BN
            shape of Inception-BN at 64 rows a rank, a flat node, C 1, 7
            and 1500, a ragged row count and ragged rows 1 element past
            a 16-byte boundary in bf16, f16 and f32: their sums within
            the order-of-summation bound of the exact sum (the longest
            addition chain of colsum.cuh's order for bn_sums, of
            colsum_vec.cuh's plan for bn_bwd_sums, * 2^-24 * sum|term|),
            their outputs within 4 f32 ulp of max|plain| (bf16/f16 one
            ulp more).
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
            training kernel are timed.
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
            finite softmax rows. Step and kernel times beside bound,
            plain version and library call (``F.local_response_norm``
            forward and backward, ``max_pool2d_with_indices_backward``).
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
            train and 128 val RGB PNGs of 256x256 (its own PNG writer
            over zlib, every row filter in each image) in the port's
            record files. Batch 128, bf16, SGD, 4 steps, one evaluation,
            one round written; the mean image is computed on first use
            and written, and the log must show ``device_normalize
            auto-resolved to 1``. Launch counts, set to 0 just before
            the first step and read after each: ``stem`` 1 a step and 0
            in the evaluation, ``bn_fwd`` = ``bn_bwd`` = 69 and
            ``sgd_apply`` = 2. Each step held against ``fused_kernels =
            0`` from the same state on the same uint8 batches with phase
            6's bounds; the folded input bit-equal to the ``input_fold =
            0`` path cast to bf16; the val crops bit-equal to the center
            crops of the encoded arrays; the written round answers
            finite softmax rows. Before the phases' runs, with the other
            kernels, ``stem`` is held bit-equal to its plain version at
            the path shape (128x224x224x3 to bf16, a mean image), with a
            per-channel mean to f32 and f16, without a mean at a factor
            of 1/255, at a ragged 5x17x13x3 and a batch of 1. Times,
            printed and not gated: ``stem`` beside its bound and plain
            version, the H2D copy of one uint8 and one float32 batch,
            the imgrec train step beside phase 6's, the train chain's
            decoded images/s with its ``decode_threads`` and the PNG
            decoder's alone.

Then, on lines of their own: the card's name and power limit as
``nvidia-smi`` reports them, the kernels JSON line, and last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits 2 when
there is none.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import statistics
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
PERF_BEFORE_MS = {"flash_fwd": "0.8869 ms",
                  "flash_bwd_dq": "0.7877 ms",
                  "flash_bwd_dkv": "0.7659 ms",
                  "q_mm conv1 b32": "0.1640 ms",
                  "q_mm fc6 b32": "0.1918 ms warm",
                  "bn_bwd_sums": "0.1768 ms",
                  "pool_fwd": "0.00923 ms"}
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
          ("mask_copy", "epilogue kernel"), ("finalize_dbias", "epilogue kernel"),
          ("colsum_partials", "bn/epilogue sums kernel"),
          ("colsum_vec", "bn/epilogue sums kernel"),
          ("bn_normalize", "bn kernel"), ("bn_dx", "bn kernel"),
          ("finalize", "bn kernel"), ("sgd_apply_kernel", "sgd kernel"),
          ("conv", "conv"), ("xmma", "conv"), ("cudnn", "conv"),
          ("gemm", "matmul"), ("sm90", "conv/matmul"),
          ("cat", "concat"), ("reduce", "reduce"), ("pool", "torch pool"),
          ("elementwise", "elementwise"), ("copy", "copy/cast"))


def profile_calls(fn, n: int = 5, what: str = "forward") -> str:
    """torch.profiler over ``n`` calls of ``fn``: kernels per call, the
    device's busy share of the span its kernels cover, host time per
    call, and device time by kind of kernel."""
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
        return "no device events in the trace (not measured)"
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
    by_kind, other = {}, {}
    for e in kern:
        name = e.name.lower()
        kind = next((k for frag, k in _KINDS if frag in name), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total
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
            f" | largest other: {top}")


def launch_breakdown(fn, n: int = 20) -> str:
    """torch.profiler over ``n`` calls of ``fn``: device time and launches
    per call of each kernel it launches, by name (a wrapper that makes
    more than one launch shows each apart)."""
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
    return ", ".join(f"{name.split('(')[0][:48]} {t / n:.2f} us x{k / n:g}"
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
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"cc {cc[0]}.{cc[1]} count {torch.cuda.device_count()} "
          f"| {smi_line}", flush=True)
    if cc != (9, 0):
        raise RuntimeError(f"compute capability {cc}: the kernels are "
                           "built for sm_90a (Hopper)")
    return smi_line


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    from cxxnet_tpu_torch.ops import KERNELS, _build
    sources = sorted({k.source for k in KERNELS.values()})
    t0 = time.perf_counter()
    per = _build.build(sources)
    took = time.perf_counter() - t0
    regs = []
    for src in sources:
        used = [ln.split("info    :")[-1].strip()
                for ln in _build.build_log(src).splitlines()
                if "Used" in ln]
        regs.append(f"{src}: {'; '.join(used[:3]) or 'cached'}")
    print(f"build: {len(sources)} sources with nvcc for sm_90a in "
          f"{took:.1f}s ({', '.join(f'{s} {t:.1f}s' for s, t in per.items())})"
          f" | ptxas {' | '.join(regs)}", flush=True)
    for src in REPORT_PTXAS:
        print(f"ptxas {src}: " + ", ".join(
            f"{name} {n} registers" + (f" {sp} bytes spilled" if sp else "")
            for name, n, sp in ptxas_functions(_build.build_log(src))
            if not name.startswith("_Z")),
            flush=True)


#: the sources whose every kernel's registers and spills phase 2 prints
REPORT_PTXAS = ("flash_fwd.cu", "flash_bwd.cu", "q_mm.cu", "bn_sync.cu",
                "pool_fwd.cu")


def ptxas_functions(log: str):
    """(kernel with its template arguments, registers, spill-store bytes)
    of each entry function in an ``nvcc -Xptxas -v`` log."""
    import re
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"(flash_\w+?_(?:tc|kernel)|q_mm_kernel|"
                          r"colsum_vec|pool_fwd_kernel)I(\w+)", m.group(1))
            if k is None:
                name = m.group(1)
            else:
                g = k.group(2)
                args = ["f32"] if g.startswith("f") or re.match(
                    r"\d+BwdSumsVecIf", g) else []
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

    epi_cases = [((b, 1000), torch.bfloat16, True, "none") for b in (1, 5, 32)]
    epi_cases += [((2 * 28 * 28, 192), torch.bfloat16, True, "relu"),
                  ((37, 192), torch.float32, False, "relu"),
                  ((9, 333), torch.float16, True, "relu")]
    for shape, dt, with_bias, act in epi_cases:
        x = rnd(shape, dt)
        bias = rnd((shape[1],), torch.float32) if with_bias else None
        got = fused_bias_act(x, bias, act)
        want = bias_act_plain(x, bias, act)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lines.append(f"epilogue {tuple(shape)} {str(dt)[6:]} "
                     f"bias={int(with_bias)} act={act}: max_abs_err "
                     f"{err:.3g} (tol 0: one rounding on both sides)")
        if err != 0.0:
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
    parameter set) in bf16, and at odd shapes in f16 and f32. Returns the
    largest error per kernel at the path's shape."""
    from cxxnet_tpu_torch.ops.fused_epilogue import (epilogue_bwd_plain,
                                                     fused_epilogue_bwd)
    from cxxnet_tpu_torch.ops.fused_norm import (bn_act_plain, bn_bwd,
                                                 bn_bwd_plain, bn_fwd)
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
        dy = rnd((n, c), dt)
        yy = y if relu else None
        dx, dg, db = bn_bwd(x, dy, yy, g, mean, rstd)
        dx0, dg0, db0 = bn_bwd_plain(x, dy, yy, g, mean, rstd)
        torch.cuda.synchronize()
        stat = max((mean - mean0).abs().max().item(),
                   ((var - var0).abs() / var0.clamp(min=1e-6)).max().item())
        ey, bad_y = ulp_bad(y, y0, dt, 1e-4)
        edx, bad_dx = ulp_bad(dx, dx0, dt, 1e-3)
        egb = max(((dg - dg0).abs() / (dg0.abs() + 1.0)).max().item(),
                  ((db - db0).abs() / (db0.abs() + 1.0)).max().item())
        lines.append(f"bn ({n},{c}) {str(dt)[6:]} relu={int(relu)} "
                     f"two_pass={int(two_pass)}: y {ey.max().item():.3g}, "
                     f"stats {stat:.3g}, dx {edx.max().item():.3g}, "
                     f"dgamma/dbeta {egb:.3g}")
        if bad_y or bad_dx or stat > 1e-4 or egb > 1e-3:
            raise AssertionError(
                "bn kernels disagree (tol: y one ulp + 1e-4, dx one ulp + "
                "1e-3, stats 1e-4, dgamma/dbeta 1e-3 of |v| + 1): "
                + lines[-1])
        if (n, c) == bn_shapes[0]:
            path_err["bn_fwd"] = ey.max().item()
            path_err["bn_bwd"] = edx.max().item()

    pool_cases = [((TRAIN_BATCH, 1, 1, 1024), torch.bfloat16, 7, 7, True),
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
        if shape[0] == TRAIN_BATCH:
            path_err["pool_bwd"] = err

    epi_cases = [((TRAIN_BATCH, 1000), torch.bfloat16, True, "none"),
                 ((37, 333), torch.float16, True, "relu"),
                 ((9, 7), torch.float32, False, "relu")]
    for shape, dt, with_bias, act in epi_cases:
        y, dy = rnd(shape, dt), rnd(shape, dt)
        dx, db = fused_epilogue_bwd(y, dy, act, with_bias)
        dx0, db0 = epilogue_bwd_plain(y, dy, act, with_bias)
        torch.cuda.synchronize()
        err = (dx.float() - dx0.float()).abs().max().item()
        errb = 0.0 if db is None else (
            (db - db0).abs() / (db0.abs() + 1.0)).max().item()
        lines.append(f"epilogue_bwd {shape} {str(dt)[6:]} "
                     f"bias={int(with_bias)} act={act}: dx {err:.3g} "
                     f"(tol 0), dbias {errb:.3g} (tol 1e-5 of |v| + 1)")
        if err != 0.0 or errb > 1e-5:
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
    exact value (each kernel's own addition depth), the outputs (rows 9,
    11) within 4 f32 ulp of max|plain| in f32 and one ulp (plus that) in
    bf16/f16. Returns the largest error against the plain version per
    kernel at bn_stem1."""
    from cxxnet_tpu_torch.ops.fused import colsum_depth, sm_count
    from cxxnet_tpu_torch.ops.fused_norm import (
        bn_bwd_dx, bn_bwd_dx_plain, bn_bwd_sums, bn_bwd_sums_plain, bn_norm,
        bn_norm_plain, bn_sums, bn_sums_plain, colsum_vec_depth,
        colsum_vec_plan)
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
            d_old, d_new = colsum_depth(n, c), colsum_vec_depth(plan, c)
            ratio = max(_sum_bound_ratio(s[0], xf, d_old),
                        _sum_bound_ratio(s[1], xf * xf, d_old),
                        _sum_bound_ratio(bs[0], d, d_new),
                        _sum_bound_ratio(bs[1], d * ((xf - mean) * rstd),
                                         d_new))
            outs = []
            for got, want in ((y, y0), (dx, dx0)):
                err = (got.float() - want.float()).abs()
                tol = 4 * 2.0 ** -23 * want.float().abs().max().item()
                if dt != torch.float32:
                    tol = _ulp_tol(dt) * want.float().abs() + tol
                outs.append(float((err / tol).max()) if torch.is_tensor(tol)
                            else err.max().item() / max(tol, 1e-300))
            worst["sums"] = max(worst["sums"], ratio)
            worst["out"] = max(worst["out"], *outs)
            cases += 1
            if ratio > 1.0 or max(outs) > 1.0:
                raise AssertionError(
                    f"sync-BN kernels disagree at ({n},{c}) {dt} act={act}"
                    f"{' offset' if off else ''}: "
                    f"sums at {ratio:.3g} of their bound, y and dx at "
                    f"{outs[0]:.3g} and {outs[1]:.3g} of their tolerance")
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
          f"addition chain: colsum.cuh's for bn_sums, colsum_vec.cuh's "
          f"plan's for bn_bwd_sums) | y, "
          f"dx: worst {worst['out']:.3g} of the tolerance (4 f32 ulp of "
          f"max|plain|; bf16/f16 one ulp more) | at bn_stem1 bf16 vs plain: "
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
    for what, groups in (("LM", lm_shapes(conf)[1]),
                         ("Inception-BN", flagship_shapes(FLAGSHIP)[1])):
        for tag, shapes in sorted(groups.items()):
            rnd = lambda sh, sc=1.0: torch.randn(sh, generator=gen,
                                                 device=dev) * sc
            ws = [rnd(sh) for sh in shapes]
            gs = [rnd(sh) for sh in shapes]
            gs[0].view(-1)[::7] = float("nan")
            m1 = [rnd(sh, 0.1) for sh in shapes]
            m2 = [rnd(sh, 0.1).abs() for sh in shapes]
            wd, clip = (1e-4, 0.0) if tag == "wmat" else (0.0, 0.5)
            want = adam_apply_plain(ws, gs, m1, m2, 1e-3, 0.1, 0.001, wd,
                                    clip)
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
                raise AssertionError("adam apply kernel disagrees: "
                                     + lines[-1])
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


def write_round(conf: str, seed: int, out_dir: str, device) -> str:
    """Random weights, BN statistics calibrated with the port's plain
    forward on one seeded batch, written as ``0001.model``."""
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
    path = os.path.join(out_dir, "0001.model")
    ckpt.save_model(path, structure_sig=graph.structure_signature(),
                    round_counter=1, epoch_counter=0, params=params,
                    net_state=state)
    return path


def _post(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(conf: str, seed: int, model_path: str, extra=()):
    """Serve the round through ``main.run`` on a thread; returns
    (engine, launches, requests' rows and answers, statz)."""
    from cxxnet_tpu_torch.config import parse_cli_overrides, parse_config_file
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    cfg = parse_config_file(conf) + parse_cli_overrides(
        ["task=serve", f"model_in={model_path}", "serve_port=0",
         f"serve_buckets={','.join(map(str, BUCKETS))}",
         f"serve_max_batch={BUCKETS[-1]}", "serve_max_latency_ms=2",
         *extra])
    c, y, x = [int(v) for v in dict(cfg)["input_shape"].split(",")]
    rs = np.random.RandomState(seed + 2)
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

    reset_launches()
    t = threading.Thread(target=target, name="serve-main", daemon=True)
    t.start()
    if not ready.wait(timeout=600):
        raise TimeoutError("server did not come up within 600 s")
    if "error" in box:
        raise RuntimeError("task=serve failed") from box["error"]
    srv = box["srv"]
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
        srv.stop()
        t.join(timeout=60)
    launches = {k.name: k.launches for k in KERNELS.values()}
    if t.is_alive():
        raise RuntimeError("task=serve did not return after stop()")
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
              image: str = TRAIN_IMAGE):
    """``conf``'s netconfig and globals (the flagship's by default) with
    its data/eval sections replaced by ``iter = synthetic`` (``image``,
    1000 classes, from ``seed``): ``steps`` batches of ``batch`` to train
    on, one to evaluate."""
    from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                         parse_config_file, split_sections)
    glob, _ = split_sections(parse_config_file(conf))

    def synth(kind, name, n, s):
        return [(kind, name), ("iter", "synthetic"), ("num_inst", str(n)),
                ("num_class", str(TRAIN_CLASSES)),
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
    return rels, max(_rel(gs[k], ws[k]) for k in ws)


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


def _load(tr, snap, epoch):
    """Load ``snap`` as the state before update ``epoch`` (its step
    counter too, so a drawing layer draws what that step drew)."""
    from cxxnet_tpu_torch.checkpoint import _sig_to_json
    p, o, s = snap
    tr.load_blob({"meta": {"structure_sig": _sig_to_json(
        tr.graph.structure_signature()), "round": 0, "epoch": epoch,
        "step_count": epoch}, "params": p, "state": s, "opt": o})


def steps_vs_plain(glob, before, after, losses, batches):
    """Each step of a kernel run (``before[i]`` -> ``after[i]``, loss
    ``losses[i]``, on ``batches[i]``) held against the same step with
    fused_kernels = 0 from the same state, in bf16 and, as the yardstick
    of bf16 rounding, in f32 (the module docstring's phase 6 bounds).
    Returns the readings and the plain bf16 trainer; raises past a
    bound."""
    from cxxnet_tpu_torch.trainer import Trainer
    plain = Trainer(glob + [("fused_kernels", "0")])
    plain32 = Trainer(glob + [("fused_kernels", "0"), ("silent", "1"),
                              ("compute_dtype", "float32")])
    worst = {"loss": 0.0, "state": 0.0, "kp": [], "pf": [], "ratio": []}
    for i, b in enumerate(batches):
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
    bad = [i + 1 for i, (mk, mf) in enumerate(zip(worst["kp"], worst["pf"]))
           if i > 0 and mk[0] > 1.5 * mf[0]]
    bad += [f"ratio at step {i + 1}" for i, (lo, hi) in
            enumerate(worst["ratio"]) if lo[0] < 0.5 or hi[0] > 2]
    if worst["loss"] > 2e-2 or worst["state"] > 2e-2 or bad:
        raise AssertionError(f"kernel vs fused_kernels=0 steps {bad}: "
                             f"{worst}")
    return worst, plain


def _steps_line(worst) -> str:
    """The round-line text of :func:`steps_vs_plain`'s readings."""
    return (f"vs fused_kernels=0 from the same state, worst over steps: loss "
            f"{worst['loss']:.3g} of max(1,|loss|) (tol 2e-2), BN statistics "
            f"{worst['state']:.3g} (tol 2e-2); per step, update rel L2 "
            f"median over leaves / worst leaf, kernels vs plain bf16 "
            f"{[(round(m, 4), round(w[0], 4)) for m, w in worst['kp']]} "
            f"against plain bf16 vs plain f32 (bf16 rounding) "
            f"{[(round(m, 4), round(w[0], 4)) for m, w in worst['pf']]} "
            f"(tol: median at most 1.5x the rounding's at steps 2-"
            f"{len(worst['kp'])}); gradient-part norm ratio per leaf, "
            f"kernels / plain, min-max per step "
            f"{[(round(lo[0], 3), round(hi[0], 3)) for lo, hi in worst['ratio']]}"
            f" (tol [0.5, 2])")


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
    want = {"bn_fwd": n_bn * steps, "bn_bwd": n_bn * steps,
            "sgd_apply": 2 * steps}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    bad.update({k: (launches[k], f">= {steps}") for k in TRAIN_KERNELS
                if k not in want and launches[k] < steps})
    if bad:
        raise AssertionError(f"launches (got, want) per kernel: {bad}")
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


def phase_train_times(tr, plain, batches, gen) -> dict:
    """CUDA-event times of a train step (one host batch, H2D included)
    with the kernels and with fused_kernels = 0, and of each kernel at
    the training path's shapes beside its bound, its plain version and
    one PyTorch call computing the same function."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import fused_optim
    from cxxnet_tpu_torch.ops.fused import stream_handle
    from cxxnet_tpu_torch.ops.fused_epilogue import (
        bias_act_plain, epilogue_bwd_plain, fused_bias_act,
        fused_epilogue_bwd)
    from cxxnet_tpu_torch.ops.fused_norm import (bn_act_plain, bn_bwd,
                                                 bn_bwd_plain, bn_fwd)
    from cxxnet_tpu_torch.ops.fused_pool import (fused_pool_bwd_lin,
                                                 pool_bwd_lin_plain)
    b0 = batches[0]
    step_ms = time_forward(lambda: tr.update(b0), reps=10)
    step_plain = time_forward(lambda: plain.update(b0), reps=10)
    for who, t in (("kernels", tr), ("fused_kernels=0", plain)):
        print(f"profile: train step, {who}: "
              f"{profile_calls(lambda: t.update(b0), 3, 'step')}",
              flush=True)
    dev = tr.device
    bf = torch.bfloat16
    rnd = lambda shape, dt=bf: torch.randn(shape, generator=gen,
                                           device=dev).to(dt)
    n, c = TRAIN_BATCH * 112 * 112, 64                  # bn_stem1
    x = rnd((n, c)) * 1.5
    g = torch.rand((c,), generator=gen, device=dev) + 0.5
    be = torch.randn((c,), generator=gen, device=dev) * 0.1
    y, mean, var, rstd = bn_fwd(x, g, be, 1e-10, "relu")
    dy = rnd((n, c))
    w16, b16 = g.to(bf), be.to(bf)
    _, smean, sinv = torch.ops.aten.native_batch_norm(
        x, w16, b16, None, None, True, 0.1, 1e-10)
    xp = rnd((TRAIN_BATCH, 7, 7, 1024))
    dyp = rnd((TRAIN_BATCH, 1, 1, 1024))
    xe, dye = rnd((TRAIN_BATCH, 1000)), rnd((TRAIN_BATCH, 1000))
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
        "bn_bwd": dict(
            ms=time_call(lambda: bn_bwd(x, dy, y, g, mean, rstd)),
            plain_ms=time_call(lambda: bn_bwd_plain(x, dy, y, g, mean,
                                                    rstd)),
            library_ms=time_call(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dy, x, w16, None, None, smean, sinv, True, 1e-10,
                    [True, True, True])),
            bound=bound_ms(4 * n * c * 2, 12 * n * c),
            shape=f"bn_stem1 ({n},{c}) bf16 relu",
            library="aten.native_batch_norm_backward, no relu mask"),
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
        "epilogue_bwd": dict(
            ms=time_call(lambda: fused_epilogue_bwd(xe, dye, "none", True)),
            plain_ms=time_call(lambda: epilogue_bwd_plain(xe, dye, "none",
                                                          True)),
            library_ms=time_call(lambda: dye.sum(0, dtype=torch.float32)),
            bound=bound_ms(dye.numel() * 2 * 2 + 1000 * 4, dye.numel()),
            shape=f"fc1 bias on {tuple(dye.shape)} bf16 (launch-bound)",
            library="dy.sum(0, dtype=float32) (dx is dy)"),
        "sgd_apply": dict(
            ms=time_call(lambda: fused_optim.SGD_APPLY.launch(
                table.data_ptr(), len(ws), nblk, fused_optim.CHUNK, 0.1,
                0.9, 1e-4, 0.0, 0, stream())),
            plain_ms=time_call(lambda: fused_optim.sgd_apply_plain(
                ws, gs, ms, 0.1, 0.9, 1e-4, 0.0, False)),
            library_ms=time_loop(sgd.step),
            bound=bound_ms(20 * nparam, 6 * nparam),
            shape=f"all {len(ws)} leaves, {nparam} params, f32, one launch",
            library="torch.optim.SGD(fused=True).step() (its momentum "
                    "buffer is cxxnet's times -1/lr)"),
    }
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
            "kernels": rows}


# -- phase 7 ------------------------------------------------------------------

#: bounds of the LM phase, kernels against fused_kernels = 0 from the
#: same state (readings in PERF.md section 2): the loss relative to
#: max(1, |loss|), and each parameter leaf's gradient as a relative L2
#: difference; per dtype
LM_LOSS_TOL = {"bfloat16": 1e-4, "float32": 1e-6}
LM_GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-5}


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


def phase_lm_times(tr, kern, plain, batches, gen) -> dict:
    """CUDA-event times of an LM train step with the kernels and with
    fused_kernels = 0 (from the same state, one host batch), and of each
    LM kernel at the path's shape beside its bound, its plain version
    and one PyTorch library call computing the same function; the Adam
    apply also at Inception-BN's size."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import attention as att
    from cxxnet_tpu_torch.ops import fused_optim
    from cxxnet_tpu_torch.ops.fused import stream_handle
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

    def adam_row(ws, what):
        gs = [torch.randn_like(w) for w in ws]
        m1 = [torch.zeros_like(w) for w in ws]
        m2 = [torch.zeros_like(w) for w in ws]
        table, nblk = fused_optim._table(ws, gs, m1, m2)
        n = sum(w.numel() for w in ws)
        tparams = [w.clone().requires_grad_(True) for w in ws]
        for t, gg in zip(tparams, gs):
            t.grad = gg
        adam = torch.optim.Adam(tparams, lr=1e-3, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4, fused=True)
        return dict(
            ms=time_call(lambda: fused_optim.ADAM_APPLY.launch(
                table.data_ptr(), len(ws), nblk, fused_optim.CHUNK, 1e-3,
                0.1, 0.001, 1e-4, 0.0, stream_handle(dev))),
            plain_ms=time_call(lambda: fused_optim.adam_apply_plain(
                ws, gs, m1, m2, 1e-3, 0.1, 0.001, 1e-4, 0.0)),
            library_ms=time_loop(adam.step),
            bound=bound_ms(28 * n, 12 * n),
            shape=f"{what}: all {len(ws)} leaves, {n} params, f32, one "
                  "launch",
            library="torch.optim.Adam(fused=True).step()")
    rows["adam_apply"] = adam_row(
        [v.detach().clone() for v in _paths(tr.params).values()], "LM")
    ibn = adam_row([torch.randn(sh, generator=gen, device=dev)
                    for shapes in flagship_shapes(FLAGSHIP)[1].values()
                    for sh in shapes], "Inception-BN")
    line = lambda k, r: (f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us, bound "
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
          + " | " + line("adam_apply", ibn) + " | " + " | ".join(
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


def phase_convnet_kernels(gen: torch.Generator) -> dict:
    """The convnet path's kernels against their plain versions: LRN
    forward and backward at AlexNet's lrn1 and lrn2 (bf16, f16, f32) and
    at 7 rows by C 7, C 1500 (past the TPU kernel's 1024) and a ragged row
    count, with nsize 3, 4 and 5, knorm 1 and 2, beta 0.75 and 0.5
    (float32 within 4 ulp of max|plain|, bf16/f16 one ulp of the value);
    the first-match max-pool backward at spp1's shape, the digits LeNet's
    2x2 pool and a global 7x7 window, pre_relu on and off, inputs drawn
    from five integer values so that ties abound (bit-equal). Returns the
    largest error per kernel at the path's shape."""
    from cxxnet_tpu_torch.ops.fused_lrn import (fused_lrn_bwd, fused_lrn_fwd,
                                                lrn_bwd_plain, lrn_plain)
    from cxxnet_tpu_torch.ops.fused_pool import (fused_pool_bwd_max,
                                                 pool_bwd_max_plain,
                                                 pool_fwd_plain)
    dev = gen.device
    path_err, lines = {}, []
    dts = (torch.bfloat16, torch.float16, torch.float32)
    cases = [((256, 27, 27, 96), dt, LRN_ALEX) for dt in dts]
    cases += [((256, 13, 13, 256), dt, LRN_ALEX) for dt in dts]
    cases += [(shape, dt, (n, 0.1, beta, knorm))
              for shape in ((1, 1, 7, 7), (1, 1, 3, 1500), (3, 5, 7, 33))
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
    pools = [((128, 27, 27, 256), 3), ((100, 8, 8, 32), 2),
             ((32, 7, 7, 256), 7)]
    for (shape, k), dt, relu in ((p, dt, r) for p in pools for dt in dts
                                 for r in (False, True)):
        x = torch.randint(-2, 3, shape, generator=gen, device=dev).to(dt)
        y = pool_fwd_plain(x, k, k, "max", False, relu)
        dy = torch.randn(y.shape, generator=gen, device=dev).to(dt)
        got = fused_pool_bwd_max(x, y, dy, k, k, relu)
        want = pool_bwd_max_plain(x, y, dy, k, k, relu)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lines.append(f"pool_bwd_max {k}x{k} {shape} {str(dt)[6:]} "
                     f"relu={int(relu)}: max_abs_err {err:.3g} (tol 0)")
        if not torch.equal(got, want):
            raise AssertionError("max-pool backward kernel disagrees: "
                                 + lines[-1])
        if shape[0] == 128 and dt == torch.bfloat16 and not relu:
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
                                                 pool_bwd_max_plain,
                                                 pool_fwd_plain)
    b0 = batches[0]
    snap = _snap(tr)
    _load(plain, snap, tr.epoch_counter)
    step_ms = time_forward(lambda: tr.update(b0), reps=5)
    step_plain = time_forward(lambda: plain.update(b0), reps=5)
    prof = profile_calls(lambda: tr.update(b0), 3, "step")
    print(f"profile: {name} train step, kernels: {prof}", flush=True)
    dev, bf = tr.device, torch.bfloat16
    rows = {}
    if name == "alexnet":
        n, alpha, beta, knorm = LRN_ALEX
        for layer, shape in (("lrn1", (256, 27, 27, 96)),
                             ("lrn2", (256, 13, 13, 256))):
            x = (torch.randn(shape, generator=gen, device=dev) * 3).to(bf)
            dy = torch.randn(shape, generator=gen, device=dev).to(bf)
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
        shape, k = (128, 27, 27, 256), 3
        x = torch.randn(shape, generator=gen, device=dev).to(bf)
        y = pool_fwd_plain(x, k, k, "max", False, False)
        dy = torch.randn(y.shape, generator=gen, device=dev).to(bf)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        _, idx = F.max_pool2d(xn, k, k, return_indices=True)
        nbytes = 2 * (2 * x.numel() + 2 * y.numel())
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
    line = lambda k, r: (f"{k} {r['shape']}: {r['ms'] * 1e3:.2f} us, bound "
                         f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), "
                         f"plain {r['plain_ms'] * 1e3:.2f} us, "
                         f"{r['library']} {r['library_ms'] * 1e3:.2f} us")
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
#: multiple of 16 with zero columns as the int8 conv pads it)
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
    ``main()`` over 2 synthetic batches of ``batch`` from ``seed``; returns
    (path, exit code, the drift verdict line)."""
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
    qpath, rc, drift = quantize_round(conf, model, seed, tmp, "ibn",
                                      TRAIN_IMAGE)
    print(f"int8: Inception-BN round quantized by cxxnet_tpu_torch.quant "
          f"(exit {rc}): {drift}", flush=True)
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
    want = fp.predict_raw(np.concatenate([r for r, raw, _ in answers if raw]))
    del fp
    rel, top1, pmax, pmax_fp = _int8_vs_fp(got, want)
    notes["inception_bn"] = {"launches_q_mm": launches["q_mm"],
                             "q_mm_variants": variants,
                             "forwards": forwards, "vs_plain": worst,
                             "int8_vs_fp32_rel_l2": rel, "top1_agree": top1,
                             "top_prob": (pmax, pmax_fp), "drift": drift}
    print(f"int8: Inception-BN served over HTTP by main.run "
          f"(serve_dtype=int8, version {statz['version']}) | q_mm "
          f"{launches['q_mm']} launches in {forwards} forwards ({per} each) "
          f"| variants {variants} | vs fused_kernels=0: max prob diff "
          f"{worst:.3g} (atol "
          f"{INT8_ROW_ATOL}) | int8 vs fp32 (random weights, not gated): "
          f"rel L2 {rel:.3g}, top-1 agree {top1:.3f}, mean top prob "
          f"{pmax:.3g} vs {pmax_fp:.3g}", flush=True)
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
    aq, rc, adrift = quantize_round(ALEXNET, amodel, seed, tmp, "alexnet",
                                    "3,227,227")
    b = BUCKETS[-1]
    kw = dict(buckets=str(b), max_batch=b)
    eng = InferenceEngine.from_checkpoint(_serve_cfg(ALEXNET, []), aq,
                                          dtype="int8", **kw)
    rows = np.random.RandomState(seed + 5).randn(
        b, 3 * 227 * 227).astype(np.float32)
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
    print(f"int8: AlexNet quantized (exit {rc}: {adrift}) and run through "
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
        act = "none" if name.startswith("fc1") else "relu"
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
    print(f"times (sync BN): bn_bwd_sums by launch: {ours} | "
          f"torch.batch_norm_backward_reduce by launch: {theirs} | its "
          f"own 2-stream byte bound {lib2 * 1e3:.2f} us"
          + ("" if lib_ms is None else
             f" = {100 * lib2 / lib_ms:.1f}% of its time"), flush=True)
    return {"kernels": rows}


# -- phase 12 -----------------------------------------------------------------

#: phase 12's records: train and val images of IMGREC_SIDE^2 RGB pixels,
#: cropped to the flagship's 224 (its own data/eval sections)
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


def write_imgrec(tmp: str, seed: int):
    """Phase 12's record files (train and val PNGs with labels from
    ``seed``) through the port's RecordWriter; returns their paths, the
    val images and the seconds taken."""
    from cxxnet_tpu_torch.io.recordio import ImageRecord, RecordWriter
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    ft = _png_filter_types(IMGREC_SIDE)
    paths, val = {}, None
    for name, n in (("train", IMGREC_TRAIN), ("val", IMGREC_VAL)):
        imgs = seeded_images(rng, n, IMGREC_SIDE)
        labels = rng.randint(0, TRAIN_CLASSES, n)
        paths[name] = os.path.join(tmp, f"{name}.rec")
        with RecordWriter(paths[name]) as w:
            for i, (img, lab) in enumerate(zip(imgs, labels)):
                w.write(ImageRecord(inst_id=i, labels=np.float32([lab]),
                                    data=png_encode(img, ft)).pack())
            w.write_index(paths[name])
        if name == "val":
            val = imgs
    return paths, val, time.perf_counter() - t0


def imgrec_cfg(conf: str, paths, mean: str, model_dir: str, extra=()):
    """``conf`` as it stands, its data and eval sections included, with
    only the record and mean paths rewritten to phase 12's files."""
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
)


def _stem_inputs(gen, shape, mean_kind):
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.uint8)
    mean = {"none": None,
            "channel": torch.tensor([123.68, 116.78, 103.94],
                                    device="cuda"),
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
    """stdout that is also kept: the phase reads the run's log."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_imgrec(conf: str, seed: int, tmp: str, extra=()):
    """Phase 12: train Inception-BN from ``conf``'s own imgrec sections
    over seeded PNG records and check it (module docstring); returns
    (trainer, batches, config, val images, notes, launches)."""
    import contextlib
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.io import close_chain, create_iterator
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import KERNELS, reset_launches
    from cxxnet_tpu_torch.trainer import Trainer
    paths, val_imgs, t_write = write_imgrec(tmp, seed)
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
            box["batches"].append(b)
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
    # the val crops: center crops of the encoded arrays, bit for bit
    val_pairs = [p for kind, _, p in sections if kind == "eval"][0]
    it = create_iterator(glob + val_pairs + [("silent", "1")])
    vb = it.next()
    close_chain(it)
    crop = vb.data.shape[1]
    o = (IMGREC_SIDE - crop) // 2
    crops = np.stack([val_imgs[i][o:o + crop, o:o + crop]
                      for i in vb.inst_index])
    if vb.data.dtype != np.uint8 or not np.array_equal(vb.data, crops):
        raise AssertionError("the val crops differ from the encoded arrays")
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
    print(f"imgrec: {steps} steps of full-width Inception-BN from "
          f"{os.path.relpath(conf, ROOT)}'s own data/eval sections (imgrec, "
          f"rand_crop, rand_mirror, shuffle, image_mean, threadbuffer; "
          f"{IMGREC_TRAIN} train and {IMGREC_VAL} val PNG records of "
          f"{IMGREC_SIDE}x{IMGREC_SIDE} written in {t_write:.1f}s) through "
          f"main.run in {t_run:.1f}s with the mean computed and written, "
          f"the evaluation and the round | device_normalize auto-resolved "
          f"to 1, uint8 batches | losses {[round(v, 4) for v in losses]} | "
          f"launches per step {box['per_step'][0]} (want {want}), stem in "
          f"the evaluation {eval_launches['stem']} | {_steps_line(worst)} |"
          f" folded input bit-equal to input_fold=0 cast to bf16 | val "
          f"crops bit-equal to the encoded arrays' center crops | round "
          f"loads, finite softmax rows", flush=True)
    launches = {k: sum(n[k] for n in box["per_step"]) + eval_launches[k]
                for k in counted}
    notes = {"losses": losses, "worst": worst, "seconds": t_run,
             "write_seconds": t_write}
    del plain
    return tr, batches, cfg, val_imgs, notes, launches


def phase_imgrec_times(tr, batches, cfg, val_imgs, synthetic_step_ms):
    """Phase 12's times, printed and not gated: ``stem`` at the path
    shape beside its bound and plain version, the H2D copy of a uint8 and
    a float32 batch, the train step over an imgrec batch beside phase
    6's, the train chain's decode rate and the PNG decoder's alone."""
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.io import close_chain, create_iterator
    from cxxnet_tpu_torch.io.decode import decode_image
    from cxxnet_tpu_torch.ops import fused_stem as fs
    glob, sections = split_sections(cfg)
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
    # waits for the decode of four), and
    # the PNG decoder alone on one thread (phase 12's filter mix, and a
    # Paeth-only image)
    data_pairs = [p for kind, _, p in sections if kind == "data"][0]
    chain = {}
    for extra in ((), (("decode_threads", "1"),)):
        it = create_iterator(glob + data_pairs + [("silent", "1"), *extra])
        t0 = time.perf_counter()
        seen = sum(bb.batch_size for bb in it)
        chain[getattr(it, "base", it).nthread] = \
            seen / (time.perf_counter() - t0)
        close_chain(it)
    threads = max(chain)
    iter_ips = chain[threads]
    enc = png_encode(val_imgs[0], _png_filter_types(IMGREC_SIDE))
    enc4 = png_encode(val_imgs[0], np.full(IMGREC_SIDE, 4))
    rates = {}
    for k, e in (("mix", enc), ("paeth", enc4)):
        if not np.array_equal(decode_image(e, 3), val_imgs[0]):
            raise AssertionError(f"PNG ({k}) does not decode to its array")
        t0 = time.perf_counter()
        for _ in range(20):
            decode_image(e, 3)
        rates[k] = 20 / (time.perf_counter() - t0)
    host_ms = TRAIN_BATCH / iter_ips * 1e3
    print(f"times (imgrec): stem {stem['shape']}: {stem['ms'] * 1e3:.2f} us, "
          f"bound {stem['bound'][0] * 1e3:.2f} us ({stem['bound'][1]}), "
          f"plain {stem['plain_ms'] * 1e3:.2f} us, library "
          f"{stem['library']} | H2D of one batch (pinned, CUDA events, "
          f"median of 20): uint8 {host8.numel() / 1e6:.1f} MB "
          f"{h2d['uint8']:.3f} ms, float32 {host32.numel() * 4 / 1e6:.1f} MB "
          f"{h2d['float32']:.3f} ms | train step over an imgrec batch "
          f"(uint8 H2D, stem, forward, backward, SGD) {step_ms:.3f} ms, "
          f"phase 6's synthetic step {synthetic_step_ms:.3f} ms | train "
          f"chain {iter_ips:.1f} images/s with decode_threads={threads} "
          f"(the default; host decode of one batch of {TRAIN_BATCH}: "
          f"{host_ms:.1f} ms), {chain[1]:.1f} with decode_threads=1 | "
          f"PNG decode alone, one thread, {IMGREC_SIDE}x{IMGREC_SIDE} RGB: "
          f"{rates['mix']:.1f} images/s at phase 12's filter mix, "
          f"{rates['paeth']:.1f} Paeth-only | profile: train step over an "
          f"imgrec batch: {prof}", flush=True)
    return {"kernels": {"stem": stem}, "step_ms": step_ms,
            "h2d_ms": h2d, "iter_images_per_s": iter_ips,
            "iter_images_per_s_1_thread": chain[1],
            "decode_threads": threads, "png_images_per_s": rates,
            "profile": prof}


# -- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conf", default=FLAGSHIP)
    ap.add_argument("--json", default="", help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the "
              "port on the card only", file=sys.stderr, flush=True)
        return 2
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
    train_times = phase_train_times(tr, plain_tr, batches, gen)
    glob = [kv for kv in plain_tr.cfg if kv[0] != "fused_kernels"]
    del tr, plain_tr
    torch.cuda.empty_cache()
    f32 = phase_train_f32(batches, notes["init"], glob)
    mark("train")
    with tempfile.TemporaryDirectory() as tmp:
        tr, kern, plain_tr, lm_batches, lm_launches, lm_notes = phase_lm(
            args.seed, tmp)
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
    mark("imgrec")
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
              "train": {k: v for k, v in notes.items() if k != "init"},
              "train_f32": f32,
              "lm_step_ms": lm_times["step_ms"],
              "lm_step_plain_ms": lm_times["step_plain_ms"],
              "lm": lm_notes, "lm_profile": lm_times["profile"],
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

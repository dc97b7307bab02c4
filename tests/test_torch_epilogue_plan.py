"""The epilogue's launch plans, forward and backward, and the walk of
the data-parallel batch-norm normalize on the CPU.

The forward (``epilogue_fwd``: ``csrc/epilogue_fwd.cu``) takes the
normalize's channel-group walk under ``epilogue_fwd_plan``: every vector
of every slice once, each from the thread's own channel group, at every
biased conv and fullc of AlexNet and the SPP net (held against their
configs), fc1, odd C and misaligned bases; its per-vector op, emulated
in numpy with each operation rounded, equals ``bias_act_plain`` and the
JAX package's Pallas forward (interpreted).

The backward's launch plans (``epilogue_bwd``:
``csrc/epilogue_bwd.cu`` over ``csrc/colsum_vec.cuh``) and the walk of
the data-parallel batch-norm normalize (``bn_norm``:
``csrc/bn_norm_vec.cuh``) on the CPU.

With a bias the epilogue's dbias is ``colsum_vec`` with one sum a
channel under ``epilogue_bwd_plan``: one row block whose lanes take
EPI_MIN_ROWS rows each at a fullc's few hundred rows, the BN sums' plan
at a conv's; with relu and no bias a masked copy walks flat vectors
under ``epilogue_copy_plan``. Each plan must take every row and
channel, or every element, exactly once; the order of the dbias sums is
emulated in float32 (``tests/torch_colsum_order.py``) and must meet the
``colsum_vec_depth`` bound against the float64 sum, the plain version
and the JAX package's Pallas backward (interpreted). The BN callers'
plans and depths are held to a frozen copy of the plan before the
epilogue shared the kernel. The
normalize walks the dx pass's plan with its own rows in flight: every
vector once, from the thread's own channel group, and its f32
arithmetic (emulated in numpy, each operation rounded) equals
``bn_norm_plain`` bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.fused_epilogue import fused_bias_act as jax_bias_act
from cxxnet_tpu_torch.ops import fused_epilogue as E
from cxxnet_tpu_torch.ops import fused_norm as N

import torch_colsum_order as order
from test_torch_colsum_plan import IBN_BN_64, ODD

#: (rows, channels, relu) of AlexNet's eight biased epilogues at batch 256
#: (held against the config below)
ALEXNET_EPI = [(256 * 55 * 55, 96, True), (256 * 27 * 27, 256, True),
               (256 * 13 * 13, 384, True), (256 * 13 * 13, 384, True),
               (256 * 13 * 13, 256, True), (256, 4096, True),
               (256, 4096, True), (256, 1000, False)]
#: (rows, channels, relu) of the SPP net's eight biased epilogues at batch
#: 128 (insanity is not folded: the bias only; held against the config)
SPP_EPI = [(128 * 109 * 109, 96, False), (128 * 54 * 54, 256, False),
           (128 * 27 * 27, 384, False), (128 * 27 * 27, 384, False),
           (128 * 27 * 27, 256, False), (128, 4096, False),
           (128, 4096, False), (128, 1000, False)]
#: Inception-BN's fc1 at batch 128: a bias, no relu
FC1 = (128, 1000)


def _conf_epilogue_shapes(conf, batch):
    """(rows, channels) of every conv and fullc output of ``conf`` at
    ``batch``, in graph order."""
    from cxxnet_tpu_torch.config import parse_config_file, split_sections
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg, _ = split_sections(parse_config_file(conf))
    graph = build_graph(cfg)
    net = Network(graph, cfg, device="cpu")
    shapes = []
    for spec in graph.layers:
        if spec.type in ("conv", "fullc"):
            a, b, c = net.node_shapes[spec.nindex_out[0]]
            # conv nodes are (C, H, W), fullc nodes (1, 1, n)
            n, ch = (batch * b * c, a) if spec.type == "conv" else (batch, c)
            shapes.append((n, ch))
    return shapes


def test_alexnet_epilogue_shapes_are_the_configs():
    assert _conf_epilogue_shapes("examples/ImageNet/alexnet.conf", 256) == \
        [(n, c) for n, c, _ in ALEXNET_EPI]


def test_spp_epilogue_shapes_are_the_configs():
    assert _conf_epilogue_shapes("examples/ImageNet/kaiming.conf", 128) == \
        [(n, c) for n, c, _ in SPP_EPI]


_SIZE = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}
#: (n, c, itemsize, aligned) of the forward's walk: every biased epilogue
#: of AlexNet and the SPP net and fc1 in bf16, fc1 in f32, C 5, 7 and 1001
#: and misaligned bases in bf16, f16 and f32
FWD_CASES = [(n, c, 2, True) for n, c, _ in ALEXNET_EPI + SPP_EPI]
FWD_CASES += [FC1 + (2, True), FC1 + (4, True)]
FWD_CASES += [(n, c, _SIZE[dt], aligned)
              for dt in (torch.bfloat16, torch.float16, torch.float32)
              for n, c, aligned in ((333, 5, True), (1000, 7, True),
                                    (37, 1001, True), (1000, 96, False),
                                    (64, 1000, False))]


def _fwd_walk(plan, n, c):
    """Each (slice's first vector, threads, vectors) step of the forward's
    walk under ``plan``, as the kernel takes it: each slice of
    ``plan.slice_rows`` rows one launch of the normalize's walk
    (``order.dx_walk`` with BN_NORM_ROWS vectors in flight), its
    vectors counted from the slice's first row."""
    dx = N.DxPlan(plan.vec, plan.lanes, plan.blocks)
    for r0 in range(0, n, plan.slice_rows):
        rows = min(plan.slice_rows, n - r0)
        for t, v in order.dx_walk(dx, rows, c, rows=N.BN_NORM_ROWS):
            yield r0 * c // plan.vec, t, v


@pytest.mark.parametrize("n,c,size,aligned", FWD_CASES)
def test_epilogue_fwd_walk_takes_every_vector_once(n, c, size, aligned):
    """The forward under ``epilogue_fwd_plan``: the normalize's plan
    (16-byte vectors where C and the bases allow), one launch at every
    path shape, and every vector exactly once, each from the thread's own
    channel group, at 32-bit indices."""
    plan = E.epilogue_fwd_plan(n, c, size, aligned)
    assert plan[:3] == N.bn_dx_plan(n, c, size, aligned)
    vw = 16 // size
    assert plan.vec == (vw if aligned and c % vw == 0 else 1)
    assert plan.slice_rows >= n          # one launch
    groups = c // plan.vec
    stride = plan.lanes * groups
    seen = np.zeros(n * c // plan.vec, np.uint8)
    for base, t, v in _fwd_walk(plan, n, c):
        assert (v % groups == t % groups).all()
        assert v.max() + N.BN_NORM_ROWS * stride < 2 ** 31
        seen[base + v] += 1
    assert (seen == 1).all()


def test_epilogue_fwd_keeps_fc1_one_launch_of_few_ctas():
    """fc1 (128 x 1000 bf16): one launch of half a wave, each thread one
    16-byte vector."""
    plan = E.epilogue_fwd_plan(*FC1, 2)
    assert plan.slice_rows >= FC1[0] and plan.blocks < 132
    assert plan.lanes * (FC1[1] // plan.vec) == FC1[0] * FC1[1] // 8


@pytest.mark.parametrize("n,c,size,aligned", [
    (1000, 96, 2, True), (1000, 96, 2, False), (999, 7, 4, True),
    (50, 1001, 2, True)])
def test_epilogue_fwd_slices_take_every_vector_once(monkeypatch, n, c, size,
                                                    aligned):
    """Past EPI_FWD_SLICE elements the rows go in slices, one launch
    each: every vector of every slice once, from the thread's own channel
    group (EPI_FWD_SLICE cut to a few thousand elements here)."""
    monkeypatch.setattr(E, "EPI_FWD_SLICE", 4096)
    plan = E.epilogue_fwd_plan(n, c, size, aligned)
    assert plan.slice_rows == max(1, 4096 // c) < n
    groups = c // plan.vec
    seen = np.zeros(n * c // plan.vec, np.uint8)
    for base, t, v in _fwd_walk(plan, n, c):
        assert (v % groups == t % groups).all()
        seen[base + v] += 1
    assert (seen == 1).all()


def _epi_fwd_emulated(x, bias, act):
    """The kernel's per-vector op in numpy, each operation rounded: x in
    f32 plus the bias rounded to x's dtype (one f32 add), a relu that
    lets NaN through, then the round to the dtype."""
    v = x.float().numpy()
    if bias is not None:
        v = v + bias.to(x.dtype).float().numpy()
    assert v.dtype == np.float32
    if act == "relu":
        v = np.where((v > 0) | np.isnan(v), v, np.float32(0))
    return torch.from_numpy(v).to(x.dtype)


def _same(got, want):
    """Equal where not NaN (torch.equal: +0 and -0 compare equal, and the
    kernel's relu gives +0 where torch.relu may keep a -0), NaN where
    ``want`` is."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got[~nan],
                                                         want[~nan])


def _epi_fwd_inputs(n, c, dtype, seed):
    """x (n, c) with NaNs, +0 and -0 planted, and a f32 bias with a -0."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, c).astype(np.float32) * 3
    x.reshape(-1)[::17] = np.nan
    x.reshape(-1)[5::23] = 0.0
    x.reshape(-1)[7::29] = -0.0
    b = (rs.randn(c) * 2).astype(np.float32)
    b[::3] = -0.0
    return torch.from_numpy(x).to(dtype), torch.from_numpy(b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("with_bias,act", [(True, "none"), (True, "relu"),
                                           (False, "relu")])
def test_epilogue_fwd_arithmetic_is_the_plain_version(dtype, with_bias, act):
    """The kernel's op, emulated, equals ``bias_act_plain`` on rows with
    NaN, +0 and -0 inputs, a bias with -0 and values past bf16's and
    f16's rounding."""
    x, b = _epi_fwd_inputs(999, 40, dtype, seed=3)
    bias = b if with_bias else None
    got = _epi_fwd_emulated(x, bias, act)
    assert _same(got, E.bias_act_plain(x, bias, act))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.float32],
                         ids=str)
@pytest.mark.parametrize("c,with_bias,act", [
    (1, True, "none"), (5, True, "relu"), (8, False, "relu"),
    (16, True, "relu")])
def test_epilogue_fwd_arithmetic_is_the_jax_kernel(dtype, c, with_bias, act):
    """The emulated op against the JAX package's epilogue forward
    (``_epi_fwd_kernel``, interpreted) on the same 16 rows (the row block
    its 16-bit kernels need) with NaN, +0 and -0 planted."""
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16,
           jnp.float32: torch.float32}[dtype]
    x, b = _epi_fwd_inputs(16, c, tdt, seed=c)
    xj = jnp.asarray(x.float().numpy()).astype(dtype).reshape(16, 1, 1, c)
    bj = jnp.asarray(b.numpy()) if with_bias else None
    call = lambda a, bb: jax_bias_act(a, bb, act, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(call)(xj, bj))
    want = torch.from_numpy(np.array(call(xj, bj).astype(jnp.float32))
                            .reshape(16, c)).to(tdt)
    assert _same(_epi_fwd_emulated(x, b if with_bias else None, act), want)


#: (n, c, itemsize, aligned) of the epilogue's plan cases: AlexNet's and
#: fc1 in bf16, C not a multiple of 8, fewer rows than a lane takes, odd
#: shapes in bf16 and f32, misaligned bases
EPI_CASES = [(n, c, 2, True) for n, c, _ in ALEXNET_EPI[:3]]
EPI_CASES += [(256 * 13 * 13, 256, 2, True), (256, 4096, 2, True),
              (256, 1000, 2, True), FC1 + (2, True), FC1 + (4, True),
              (37, 333, 2, True), (4099, 7, 2, True), (3, 1000, 2, True),
              (1, 8, 2, True), (1, 1, 4, True), (5, 96, 2, True)]
EPI_CASES += [(256, 1000, 2, True), (257, 24, 2, True), (512, 4096, 2, True),
              (64, 4096, 2, True)]
EPI_CASES += [(n, c, 4, True) for n, c in ODD]
EPI_CASES += [(1000, 96, 2, False), (128, 1000, 2, False)]


@pytest.mark.parametrize("n,c,size,aligned", EPI_CASES)
def test_epilogue_plan_covers_every_row_and_channel_once(n, c, size,
                                                         aligned):
    plan = E.epilogue_bwd_plan(n, c, size, aligned)
    vw = 16 // size
    assert plan.vec == (vw if aligned and c % vw == 0 else 1)
    assert plan.lanes * plan.cgt <= N.COLSUM_VEC_THREADS
    assert plan.blocks * plan.rows_per >= n > (plan.blocks - 1) * plan.rows_per
    assert plan.blocks * plan.tiles <= N.COLSUM_VEC_CTAS_PER_SM * 132 \
        or plan.blocks == 1
    seen = np.zeros(c, np.int64)
    for t in range(plan.tiles):
        for cg in range(plan.cgt):
            np.add.at(seen, order.tile_channels(plan, c, t, cg), 1)
    assert (seen == 1).all()
    rows = np.zeros(n, np.int64)
    most = 0
    for b in range(plan.blocks):
        for lane in range(plan.lanes):
            mine = order.lane_rows(plan, n, b, lane)
            most = max(most, len(mine))
            np.add.at(rows, mine, 1)
    assert (rows == 1).all()
    if -(-n // E.EPI_MIN_ROWS) <= N.COLSUM_VEC_THREADS // 2:
        # one row block: every lane's rows in one round, two channel
        # groups a tile at least
        assert plan.blocks == 1 and most <= E.EPI_MIN_ROWS
        assert plan.cgt >= 2 or c // plan.vec == 1
    else:
        assert plan == N.colsum_vec_plan(n, c, size, aligned)
    chain = order.colsum_vec_chain(plan, n, c, sums=1)
    assert chain == N.colsum_vec_depth(plan, c, sums=1)


def test_epilogue_plan_loads_fc1_in_one_round():
    """At fc1 every lane's rows are one round of the kVecRows loads in
    flight, in one row block: the whole input is loaded at once and no
    CTA waits for another."""
    n, c = FC1
    plan = E.epilogue_bwd_plan(n, c, 2)
    lens = {len(order.lane_rows(plan, n, b, lane))
            for b in range(plan.blocks) for lane in range(plan.lanes)}
    assert lens == {E.EPI_MIN_ROWS} and plan.blocks == 1
    assert plan.tiles * plan.cgt * plan.vec >= c > \
        (plan.tiles - 1) * plan.cgt * plan.vec


def _old_colsum_vec_plan(n, c, itemsize, aligned=True, sms=132):
    """``colsum_vec_plan`` as the BN sums took it before the epilogue's
    dbias shared the kernel."""
    vw = 16 // itemsize
    vec = vw if aligned and c % vw == 0 else 1
    groups = c // vec
    tiles = max(1, min(groups, round(math.sqrt(c / 64))),
                -(-groups // 256))
    cgt = -(-groups // tiles)
    tiles = -(-groups // cgt)
    lanes = 256 // cgt
    want = max(1, 3 * sms // tiles)
    blocks = max(1, min(want, -(-n // (lanes * 8))))
    rows_per = -(-n // blocks)
    blocks = -(-n // rows_per)
    fvec = 4 if c % 4 == 0 and (cgt * vec) % 4 == 0 else 1
    return N.ColsumPlan(vec, cgt, lanes, tiles, blocks, rows_per, fvec)


def _old_colsum_vec_depth(plan, c):
    """``colsum_vec_depth`` as it stood before its ``sums`` keyword (two
    sums a channel)."""
    tile = plan.cgt * plan.vec
    fin = 0
    for t in range(plan.tiles):
        cw = min(tile, c - t * tile)
        runs = max(1, min(plan.blocks, 256 // (2 * cw // plan.fvec)))
        fin = max(fin, -(-plan.blocks // runs) + runs)
    return -(-plan.rows_per // plan.lanes) + plan.lanes + fin


BN_CASES = [(n * r, c, s, a) for r in (1, 2) for n, c in IBN_BN_64
            for s, a in ((2, True), (2, False), (4, True))]
BN_CASES += [(n, c, s, True) for n, c in ODD for s in (2, 4)]


@pytest.mark.parametrize("n,c,size,aligned", BN_CASES)
def test_bn_sum_plans_and_depths_unchanged(n, c, size, aligned):
    """The BN sums (``bn_bwd_sums``, ``bn_bwd``) keep their plans and
    their depth bound at every Inception-BN shape, 64 and 128 a rank, and
    the odd shapes: the same launch, the same bits."""
    for sms in (132, 114):
        plan = N.colsum_vec_plan(n, c, size, aligned, sms)
        assert plan == _old_colsum_vec_plan(n, c, size, aligned, sms)
        assert N.colsum_vec_depth(plan, c) == _old_colsum_vec_depth(plan, c)
        assert N.colsum_vec_depth(plan, c, sums=2) == \
            _old_colsum_vec_depth(plan, c)


def _epi_rows(n, c, dtype, seed):
    rs = np.random.RandomState(seed)
    y = torch.from_numpy(rs.randn(n, c).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rs.randn(n, c).astype(np.float32)).to(dtype)
    y.view(-1)[::31] = float("nan")
    return y, dy


def _terms(y, dy, relu):
    """dx in float32: dy masked by y > 0 (NaN off) with relu."""
    d = dy.float().numpy()
    return np.where(y.float().numpy() > 0, d, np.float32(0)) if relu else d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("n,c,relu,aligned", [
    FC1 + (False, True), (256, 4096, True, True), (3025 * 8, 96, True, True),
    (169 * 16, 384, True, True), (37, 333, True, True), (3, 1000, False, True),
    (4099, 7, True, True), (1000, 96, True, False)])
def test_epilogue_dbias_order_meets_its_bound(n, c, relu, aligned, dtype):
    """dbias in the kernel's order (emulated, one sum a channel) against
    the float64 sum of the same float32 terms: within depth * 2^-24 *
    sum|term|, depth the emulation's longest chain, which is
    ``colsum_vec_depth(plan, c, sums=1)``; and the plain version's dbias
    within the same bound plus its own (float32 sums of n terms)."""
    y, dy = _epi_rows(n, c, dtype, seed=n + c)
    plan = E.epilogue_bwd_plan(n, c, y.element_size(), aligned)
    t = _terms(y, dy, relu)
    got, chain = order.colsum_vec_sum(t, plan, sums=1)
    depth = N.colsum_vec_depth(plan, c, sums=1)
    assert chain == depth
    exact = t.astype(np.float64).sum(0)
    mag = np.abs(t.astype(np.float64)).sum(0)
    assert (np.abs(got - exact) <= depth * 2.0 ** -24 * mag).all()
    dx, db = E.epilogue_bwd_plain(y, dy, "relu" if relu else "none", True)
    np.testing.assert_array_equal(dx.float().numpy(), t)
    assert (np.abs(db.numpy() - got) <= (depth + n) * 2.0 ** -24 * mag).all()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c", [(32, 24), (256, 64), (48, 1000)])
def test_epilogue_dbias_order_near_the_jax_kernel(n, c, relu):
    """The emulated dbias against the JAX package's epilogue backward
    (``_epi_bwd_kernel``, interpreted) on the same bf16 rows: within both
    addition depths (ours, and n for the JAX kernel's row blocks) times
    2^-24 of sum|term|; dx equal."""
    rs = np.random.RandomState(c)
    node = (n, 1, 1, c)                 # a flat node, as the layers pass it
    x = jnp.asarray(rs.randn(*node).astype(np.float32)).astype(jnp.bfloat16)
    bias = jnp.asarray(rs.randn(c).astype(np.float32) * 0.1)
    dyj = jnp.asarray(rs.randn(*node).astype(np.float32)).astype(jnp.bfloat16)
    act = "relu" if relu else "none"
    call = lambda a, b: jax_bias_act(a, b, act, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(
        lambda a, b, d: jax.vjp(call, a, b)[1](d))(x, bias, dyj))
    yj, vjp = jax.vjp(call, x, bias)
    dxj, dbj = vjp(dyj)
    f = lambda a: np.array(a.astype(jnp.float32)).reshape(-1, c)
    y = torch.from_numpy(f(yj)).to(torch.bfloat16)
    dy = torch.from_numpy(f(dyj)).to(torch.bfloat16)
    t = _terms(y, dy, relu)
    np.testing.assert_array_equal(t, f(dxj))
    plan = E.epilogue_bwd_plan(n, c, 2)
    got, _ = order.colsum_vec_sum(t, plan, sums=1)
    depth = N.colsum_vec_depth(plan, c, sums=1) + n
    bound = depth * 2.0 ** -24 * np.abs(t.astype(np.float64)).sum(0)
    assert (np.abs(got - f(dbj)[0]) <= bound).all()


@pytest.mark.parametrize("numel,size,aligned", [
    (128 * 1000, 2, True), (3025 * 96, 2, True), (37 * 333, 2, True),
    (37 * 333, 4, True), (1000 * 96, 2, False), (7, 4, True), (1, 2, True),
    (3 * 132 * 256 * 8 * 5 + 8, 2, True)])
def test_epilogue_copy_plan_takes_every_element_once(numel, size, aligned):
    """The masked copy's flat walk (thread t takes vectors t, t + stride,
    ..., kEpiRows in flight): every vector once, one wave at most."""
    cp = E.epilogue_copy_plan(numel, size, aligned)
    vw = 16 // size
    assert cp.vec == (vw if aligned and numel % vw == 0 else 1)
    assert 1 <= cp.blocks <= E.EPI_COPY_CTAS_PER_SM * 132
    nv = numel // cp.vec
    stride = cp.blocks * E.EPI_COPY_THREADS
    assert stride - E.EPI_COPY_THREADS < nv or cp.blocks == 1
    # the walk as order.dx_walk takes it, with one "channel group"
    walk = order.dx_walk(N.DxPlan(1, stride, cp.blocks), nv, 1, rows=2)
    seen = np.zeros(nv, np.int64)
    for _, v in walk:
        np.add.at(seen, v, 1)
    assert (seen == 1).all()


NORM_CASES = [(802816, 64, 2, True), (3136, 352, 2, True), (64, 1024, 2, True),
              (333, 7, 2, True), (12345, 64, 2, False), (37, 3, 4, True),
              (999, 36, 4, False), (1000, 1500, 2, True), (5, 1, 4, True)]


@pytest.mark.parametrize("n,c,size,aligned", NORM_CASES)
def test_bn_norm_walk_takes_every_vector_once(n, c, size, aligned):
    """The normalize under ``bn_dx_plan`` with BN_NORM_ROWS vectors in
    flight: every vector exactly once, each from the thread's own channel
    group, for V = 16 / itemsize and V = 1."""
    plan = N.bn_dx_plan(n, c, size, aligned)
    vw = 16 // size
    assert plan.vec == (vw if aligned and c % vw == 0 else 1)
    groups = c // plan.vec
    seen = np.zeros(n * c // plan.vec, np.uint8)
    for t, v in order.dx_walk(plan, n, c, rows=N.BN_NORM_ROWS):
        assert (v % groups == t % groups).all()
        seen[v] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("relu", [False, True])
def test_bn_norm_arithmetic_is_the_plain_version(dtype, relu):
    """The kernel's f32 operations, emulated in numpy (each rounded:
    x - mean, times rstd, times gamma, plus beta, relu, then the round to
    the dtype), equal ``bn_norm_plain`` bit for bit on finite inputs."""
    rs = np.random.RandomState(7)
    n, c = 999, 40
    x = torch.from_numpy((rs.randn(n, c) * 1.5 + 0.25).astype(np.float32)
                         ).to(dtype)
    g = torch.from_numpy((rs.randn(c) * 0.2 + 1).astype(np.float32))
    b = torch.from_numpy((rs.randn(c) * 0.1).astype(np.float32))
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    f = lambda t: t.float().numpy()
    v = ((f(x) - f(mean)) * f(rstd)) * f(g) + f(b)
    assert v.dtype == np.float32
    if relu:
        v = np.where(v > 0, v, np.float32(0))
    want = N.bn_norm_plain(x, g, b, mean, rstd, "relu" if relu else "none")
    assert torch.equal(torch.from_numpy(v).to(dtype), want)

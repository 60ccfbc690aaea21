"""qgemv_plan, the host's launch plan for the decode GEMV kernels
(ops/qmatmul.py): properties over rows, shapes, groups, weight layouts,
schemes and dtypes, checked with hypothesis; and a plain-torch emulation
of the plan's decomposition (each rank's K range summed on its own, the
group partials folded with their scales, the ranks added in rank order)
held to the plain versions by chip_smoke's row rule, so the split the
kernel runs computes the function. Imports no JAX."""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from chip_smoke import QMM_SHAPES, QMM_TOL, row_rel_err
from inferd_tpu_torch.ops import qmatmul as Q
from inferd_tpu_torch.ops import quant

torch.set_num_threads(2)

PER_LAYER = [s for s in QMM_SHAPES if s != "lm_head_q"]
DTYPES = [torch.bfloat16, torch.float32]


def _groups(k: int, group: int = 128) -> int:
    return k // quant._group_size(k, group)


def _layout(kind: str, k: int) -> str:
    """int4 is nibble-packed for even K, one value per byte for odd K."""
    return kind if kind == "int8" or k % 2 == 0 else "int4_bytes"


@st.composite
def calls(draw):
    """(m, k, n, groups, kind, scheme, dtype): main-path shapes, ragged N,
    odd K and random K/N/G."""
    m = draw(st.integers(1, Q.MAX_KERNEL_ROWS))
    shape = draw(st.sampled_from(["main", "head", "ragged", "odd_k", "random"]))
    if shape == "main":
        k, n = QMM_SHAPES[draw(st.sampled_from(PER_LAYER))]
    elif shape == "head":
        k, n = QMM_SHAPES["lm_head_q"]
    elif shape == "ragged":
        k, n = 1024, draw(st.sampled_from([1000, 333]))
    elif shape == "odd_k":
        k, n = 1023, 1024
    else:
        k, n = draw(st.integers(1, 9000)), draw(st.integers(1, 200000))
    kind = draw(st.sampled_from(["int8", "int4"]))
    group = draw(st.sampled_from([16, 32, 64, 96, 128, 200, 256, 512]))
    groups = 1 if kind == "int8" else _groups(k, group)
    scheme = "grouped" if kind == "int8" else draw(st.sampled_from(["grouped", "dequant"]))
    return m, k, n, groups, _layout(kind, k), scheme, draw(st.sampled_from(DTYPES))


@settings(max_examples=400, deadline=None)
@given(calls())
def test_rank_ranges_tile_k_exactly_once(call):
    m, k, n, groups, kind, scheme, dtype = call
    p = Q.qgemv_plan(*call)
    covered = []
    for lo, hi in p.rank_ranges(k):
        assert lo < hi  # no empty rank
        covered.extend(range(lo, hi))
    assert covered == list(range(k))  # no gap, no overlap, in order
    for lo, hi in p.rank_ranges(k):  # the stages cover each range in order
        starts = p.stage_starts(lo, hi)
        assert starts[0] == lo and all(b - a == p.stage_k for a, b in zip(starts, starts[1:]))
        assert starts[-1] < hi <= starts[-1] + p.stage_k


@settings(max_examples=400, deadline=None)
@given(calls())
def test_mma_ranges_align_to_the_mma_step_and_the_group(call):
    m, k, n, groups, kind, scheme, dtype = call
    p = Q.qgemv_plan(*call)
    gs = k // groups
    scaled_after = kind == "int8" or (scheme == "grouped" and groups == 1)
    assert p.stage_k % 16 == 0 and 1 <= p.depth <= Q.MAX_DEPTH
    if p.route == "mma":
        for lo, hi in p.rank_ranges(k):
            assert lo % 16 == 0 and hi % 16 == 0
            if not scaled_after:
                assert lo % gs == 0 and hi % gs == 0 and p.stage_k % gs == 0
    elif kind == "int4":  # packed: ranks split at byte rows
        assert p.k_per_rank % 2 == 0


@settings(max_examples=400, deadline=None)
@given(calls())
def test_cluster_size_and_cta_count(call):
    m, k, n, groups, kind, scheme, dtype = call
    p = Q.qgemv_plan(*call)
    tiles = -(-n // p.block_n)
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= Q.MAX_CLUSTER
    assert p.ctas == tiles * p.cluster and p.ctas % p.cluster == 0
    if p.block_n != Q.BLOCK_N:  # the wide tile: unsplit, wide, few rows
        assert p.block_n == Q.WIDE_BLOCK_N and p.cluster == 1 and n >= Q.WIDE_N
        assert Q.kernel_rows(m, p.route) <= (16 if p.route == "mma" else 8)
    if p.cluster > 1:  # split only while short of the target, never below the minimum range
        assert tiles * p.cluster // 2 < Q.TARGET_CTAS and k // p.cluster >= Q.MIN_RANK_K


@settings(max_examples=400, deadline=None)
@given(calls())
def test_route_rule(call):
    m, k, n, groups, kind, scheme, dtype = call
    p = Q.qgemv_plan(*call)
    gs = k // groups
    scaled_after = kind == "int8" or (scheme == "grouped" and groups == 1)
    if m == 1 or dtype == torch.float32 or kind == "int4_bytes" or k % 16:
        assert p.route == "simt"
    elif not scaled_after and (gs % 16 or gs > Q.MMA_MAX_GROUP):
        assert p.route == "simt"
    else:
        assert p.route == "mma"


@pytest.mark.parametrize("m", [1, 8, 9, 33, 64])
@pytest.mark.parametrize("shape", sorted(QMM_SHAPES))
def test_main_path_plans(shape, m):
    """Every per-layer projection launches at least TARGET_CTAS CTAs, on the
    tensor cores from 2 rows and on the CUDA cores at 1; the head takes no
    split."""
    k, n = QMM_SHAPES[shape]
    for kind, scheme in (("int8", "grouped"), ("int4", "grouped"), ("int4", "dequant")):
        groups = 1 if kind == "int8" else _groups(k)
        p = Q.qgemv_plan(m, k, n, groups, kind, scheme, torch.bfloat16)
        assert p.route == ("simt" if m == 1 else "mma")
        if shape == "lm_head_q":
            wide = m <= (8 if p.route == "simt" else 16)
            assert p.cluster == 1 and p.block_n == (Q.WIDE_BLOCK_N if wide else Q.BLOCK_N)
            assert p.ctas == -(-n // p.block_n)
        else:
            assert p.ctas >= Q.TARGET_CTAS and p.cluster > 1


def test_off_path_shapes_take_simt():
    assert Q.qgemv_plan(8, 1023, 1024, 11, "int4_bytes", "grouped", torch.bfloat16).route == "simt"
    assert Q.qgemv_plan(8, 1024, 3072, 8, "int8", "grouped", torch.float32).route == "simt"
    # K 130: groups of 65 split byte pairs
    assert Q.qgemv_plan(5, 130, 200, 2, "int4", "grouped", torch.bfloat16).route == "simt"
    # ragged N stays on the tensor cores
    assert Q.qgemv_plan(3, 1024, 333, 8, "int4", "grouped", torch.bfloat16).route == "mma"


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="kind"):
        Q.qgemv_plan(1, 64, 64, 1, "int2", "grouped", torch.bfloat16)
    with pytest.raises(ValueError, match="scheme"):
        Q.qgemv_plan(1, 64, 64, 1, "int4", "fused", torch.bfloat16)
    with pytest.raises(ValueError, match="groups"):
        Q.qgemv_plan(1, 64, 64, 3, "int4", "grouped", torch.bfloat16)


# -- the decomposition, emulated -------------------------------------------------


def emulate(plan, x, w, scale, kernel):
    """The plan's split in plain f32 torch: each rank sums its K range (the
    grouped scheme per group, each group's partial times its scale; dequant
    against q * scale rounded to x's dtype), the ranks added in rank order,
    w8a16's scale on the total."""
    k = x.shape[1]
    gs = k // scale.shape[0] if scale.ndim == 2 else k
    xf, wf = x.float(), w.float()
    total = torch.zeros(x.shape[0], w.shape[1])
    for lo, hi in plan.rank_ranges(k):
        if kernel == "w8a16":
            part = xf[:, lo:hi] @ wf[lo:hi]
        elif kernel == "w4a16_dequant":
            wd = (wf * scale.float().repeat_interleave(gs, dim=0)).to(x.dtype).float()
            part = xf[:, lo:hi] @ wd[lo:hi]
        else:
            part = torch.zeros_like(total)
            for g in range(lo // gs, (hi - 1) // gs + 1):
                a, b = max(lo, g * gs), min(hi, (g + 1) * gs)
                part += (xf[:, a:b] @ wf[a:b]) * scale[g].float()
        total += part
    if kernel == "w8a16":
        total = total * scale.float()
    return total.to(x.dtype)


@st.composite
def emulated_cases(draw):
    m = draw(st.integers(1, Q.MAX_KERNEL_ROWS))
    k = draw(st.sampled_from([1024, 1023, 3072, 130, 96, 2048, draw(st.integers(2, 1500))]))
    n = draw(st.sampled_from([64, 333, 200, draw(st.integers(1, 260))]))
    kernel = draw(st.sampled_from(["w8a16", "w4a16_grouped", "w4a16_dequant"]))
    group = draw(st.sampled_from([32, 64, 128]))
    return m, k, n, kernel, group, draw(st.sampled_from(DTYPES)), draw(st.integers(0, 2**31 - 1))


def split_err(got, want, x, w) -> float:
    """Worst row of max |got - want| over the row's scale: the larger of
    its own RMS and the RMS a row of random-sign dot products of these
    inputs has (sqrt(mean over columns of sum_k x_k^2 w_k^2)). The second
    never vanishes, so a row of one value that cancels to near zero is
    measured against what its sum could have been, not against itself."""
    g, r = got.float(), want.float()
    diff = (g - r).abs().amax(dim=1)
    rms = r.pow(2).mean(dim=1).sqrt()
    typical = (x.float().pow(2) @ w.float().pow(2)).mean(dim=1).sqrt()
    return (diff / torch.maximum(rms, typical)).max().item()


@settings(max_examples=60, deadline=None)
@given(emulated_cases())
# a one-value row whose sum cancels to ~1e-6: a row RMS measure fails it
@example((27, 3072, 1, "w8a16", 32, torch.float32, 1))
def test_the_split_computes_the_function(case):
    m, k, n, kernel, group, dtype, seed = case
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.02, (k, n)).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dtype)
    if kernel == "w8a16":
        q8 = quant.quantize(w)
        plan = Q.qgemv_plan(m, k, n, 1, "int8", "grouped", dtype)
        got = emulate(plan, x, q8.q, q8.scale, kernel)
        want = Q.w8a16_matmul_reference(x, q8.q, q8.scale)
    else:
        q4 = quant.quantize_int4(w, group)
        scheme = kernel.split("_")[1]
        plan = Q.qgemv_plan(m, k, n, q4.scale.shape[0], "int4" if q4.packed else "int4_bytes",
                            scheme, dtype)
        got = emulate(plan, x, q4.unpacked(), q4.scale, kernel)
        want = Q.w4a16_matvec_reference(x, q4, scheme)
    tol = QMM_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    assert split_err(got, want, x, w) <= tol


def test_a_wrong_split_is_caught():
    """The emulation is not blind: a rank dropped reads far above the limit."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.02, (1024, 1024)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 1, (8, 1024)).astype(np.float32)).to(torch.bfloat16)
    q8 = quant.quantize(w)
    plan = Q.qgemv_plan(8, 1024, 1024, 1, "int8", "grouped", torch.bfloat16)
    xd = x.clone()
    lo, hi = plan.rank_ranges(1024)[1]
    xd[:, lo:hi] = 0
    want = Q.w8a16_matmul_reference(x, q8.q, q8.scale)
    assert row_rel_err(emulate(plan, xd, q8.q, q8.scale, "w8a16"), want, 1024) > QMM_TOL["bfloat16"]

"""The flash_gqa, paged_decode_gqa, w8a16_matmul, w4a16_matvec and
fused_lane_delta wrappers' contracts, and on a card each CUDA kernel
against its plain version.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a CUDA card and no JAX: there, skip the JAX-pinning conftest
with `python -m pytest --noconftest tests/test_torch_kernels.py`.

Tolerance on the card: chip_smoke's rule, `row_rel_err` against
`ATTN_TOL`: the worst output row's max |kernel - plain| over that row's
RMS in the plain version, with rows the plain version leaves at zero held
to exactly zero (chip_smoke.py says why, and PERF.md gives the sound and
planted-fault readings that place the limits); for the f32 lane delta,
chip_smoke's LORA_TOL."""

import numpy as np
import pytest
import torch

from chip_smoke import (
    ATTN_TOL, LORA_CASES, LORA_LAYER, LORA_TOL, QMM_SHAPES, QMM_TOL, lora_inputs, row_rel_err,
)
from inferd_tpu_torch.ops import attention as A
from inferd_tpu_torch.ops import build
from inferd_tpu_torch.ops import lora as L
from inferd_tpu_torch.ops import qmatmul as Q
from inferd_tpu_torch.ops import quant

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """Decided inside the fixture, never at import, so every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode); run on the card")
    return torch.device("cuda")


requires_cuda = pytest.mark.usefixtures("cuda_device")


def _qkv(seed, b, s, t, nq, nkv, d, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, nq, d, generator=g)
    k = torch.randn(b, t, nkv, d, generator=g)
    v = torch.randn(b, t, nkv, d, generator=g)
    return tuple(x.to(device=device, dtype=dtype) for x in (q, k, v))


def test_cpu_tensors_run_the_plain_version_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not reach the kernel build")

    monkeypatch.setattr(build, "load", no_build)
    before = A.flash_gqa.launches
    q, k, v = _qkv(0, 2, 5, 16, 4, 2, 16)
    got = A.flash_gqa(q, k, v, 3, 8, stream=True, window=4)
    want = A.flash_gqa_reference(q, k, v, 3, 8, window=4)
    assert torch.equal(got, want)
    assert A.flash_gqa.launches == before


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Builders that start together (a node process while another builds)
    compile a kernel once: the others wait for its lock and take the
    library it left, log included. A stand-in compiler counts its runs."""
    import threading

    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho run >> "%s"\nsleep 0.3\n'
                    'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
                    'echo "ptxas info: 1 kernel"\n' % runs)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.build("k"))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert runs.read_text().count("run") == 1
    assert sorted(r["built"] for r in got) == [False, False, True]
    assert {r["path"] for r in got} == {build.library_path("k")}
    assert all("ptxas info" in r["log"] for r in got)


def test_plain_version_matches_naive_per_head_softmax():
    """The plain version against a loop over (batch, head, query), written
    from the masking rules alone."""
    b, s, t, nq, nkv, d = 2, 3, 12, 4, 2, 8
    q, k, v = _qkv(1, b, s, t, nq, nkv, d)
    q_start, kv_len, kv_start, win, cap = [4, 9], [8, 12], [1, 0], 3, 20.0
    sinks = torch.randn(nq, generator=torch.Generator().manual_seed(2))
    got = A.flash_gqa_reference(q, k, v, torch.tensor(q_start), torch.tensor(kv_len),
                                torch.tensor(kv_start), window=win, softcap=cap, sinks=sinks)
    want = torch.zeros(b, s, nq, d, dtype=torch.float64)
    g = nq // nkv
    for bi in range(b):
        for h in range(nq):
            for i in range(s):
                qpos = q_start[bi] + i
                logits, vals = [], []
                for j in range(t):
                    kpos = kv_start[bi] + j
                    if j < kv_len[bi] and kpos <= qpos and kpos > qpos - win:
                        sc = float(q[bi, i, h].double() @ k[bi, j, h // g].double()) / d ** 0.5
                        logits.append(cap * np.tanh(sc / cap))
                        vals.append(v[bi, j, h // g].double())
                if not logits:
                    continue
                m = max(max(logits), float(sinks[h]))
                p = np.exp(np.asarray(logits) - m)
                denom = p.sum() + np.exp(float(sinks[h]) - m)
                want[bi, i, h] = sum(pj * vj for pj, vj in zip(p, vals)) / denom
    torch.testing.assert_close(got.reshape(b, s, nq, d).double(), want, rtol=1e-5, atol=1e-5)


def test_plain_version_fully_masked_rows_are_zero():
    q, k, v = _qkv(3, 3, 2, 8, 4, 2, 16)
    out = A.flash_gqa_reference(q, k, v, torch.tensor([0, 0, 20]), torch.tensor([0, 8, 8]),
                                torch.tensor([0, 0, 30]))
    assert out[0].abs().max() == 0  # kv_len 0
    assert out[2].abs().max() == 0  # every slot is in the queries' future
    assert out[1].abs().max() > 0


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(d=16), "head_dim"),
        (dict(q_dtype=torch.float16), "f32 or bf16"),
        (dict(kv_dtype=torch.float16), "K/V dtype"),
        (dict(nq=6, nkv=4), "groups"),
        (dict(nq=66, nkv=2), "groups"),
        (dict(noncontig=True), "contiguous"),
        (dict(sinks_len=3), "sinks shape"),
    ],
)
def test_kernel_path_rejects_what_the_kernel_does_not_take(kw, err):
    """The CUDA path validates before it builds or launches (checked here
    on CPU tensors, which the validation treats like any other)."""
    nq, nkv, d = kw.get("nq", 4), kw.get("nkv", 2), kw.get("d", 64)
    q, k, v = _qkv(4, 1, 2, 8, nq, nkv, d, dtype=kw.get("q_dtype", torch.float32))
    if "kv_dtype" in kw:
        k, v = k.to(kw["kv_dtype"]), v.to(kw["kv_dtype"])
    if kw.get("noncontig"):
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    sinks = torch.zeros(kw["sinks_len"]) if "sinks_len" in kw else None
    with pytest.raises((ValueError, TypeError), match=err):
        A._launch(q, k, v, 0, 8, 0, None, 0.0, None, sinks)


CUDA_CASES = {
    # (b, s, t, nq, nkv, d, q_start, kv_len, kv_start, extra); extra["route"]
    # is the route (flash_plan's rule: bf16 with G*S > 16 rows takes the
    # tensor cores) whose counter the call must move
    "prefill": (1, 64, 64, 16, 8, 128, 0, 64, 0, {"route": "mma"}),
    "chunk_over_buffer": (1, 40, 256, 16, 8, 128, 100, 140, 0, {"route": "mma"}),
    "decode": (1, 1, 300, 16, 8, 128, 250, 251, 0, {"route": "split", "splits": True}),
    "per_batch_meta": (3, 4, 32, 8, 2, 64, [0, 8, 20], [4, 0, 24], [0, 0, 0], {"route": "split"}),
    "kv_start_window_softcap": (2, 16, 96, 8, 2, 64, 120, 80, 50,
                                {"window": 24, "softcap": 30.0, "route": "mma"}),
    "sinks_stream": (1, 8, 128, 16, 8, 128, 100, 108, 0,
                     {"sinks": True, "stream": True, "route": "split", "splits": True}),
    "group8": (1, 5, 64, 16, 2, 128, 30, 35, 0, {"route": "mma"}),
    "f32": (2, 9, 64, 8, 4, 64, 10, 19, 0, {"dtype": torch.float32, "route": "split"}),
    "fp8_kv_f32_q": (1, 8, 64, 8, 4, 64, 20, 28, 0,
                     {"dtype": torch.float32, "fp8": True, "route": "split"}),
    "fp8_kv_bf16_q": (1, 8, 64, 8, 4, 128, 20, 28, 0, {"fp8": True, "route": "split"}),
    # the route boundary: 16 packed rows split, 18 take the tensor cores
    "route_rows_16": (1, 8, 1024, 16, 8, 128, 700, 708, 0, {"route": "split", "splits": True}),
    "route_rows_18": (1, 9, 1024, 16, 8, 128, 700, 709, 0, {"route": "mma"}),
    # many splits: sinks fold once, after the merge; a window floor inside a split
    "decode_sinks_split": (1, 1, 4096, 16, 8, 128, 4095, 4096, 0,
                           {"sinks": True, "route": "split", "splits": True}),
    "decode_window_split": (1, 1, 4096, 16, 8, 128, 2999, 3000, 0,
                            {"window": 1000, "route": "split", "splits": True}),
    "mma_sinks_split": (1, 32, 4096, 16, 8, 128, 4064, 4096, 0,
                        {"sinks": True, "route": "mma", "splits": True}),
    # device meta: dense-lane decode with an empty lane; the lanes' chunk
    "dense_lanes_decode": (8, 1, 4096, 16, 8, 128, [16, 0, 229, 700, 999, 2047, 3099, 3999],
                           [17, 0, 230, 701, 1000, 2048, 3100, 4000], [0] * 8,
                           {"route": "split", "splits": True}),
    "lanes_chunk_meta": (1, 256, 1024, 16, 8, 128, [444], [700], [0], {"route": "mma"}),
    "fp8_kv_mma_ragged_t": (2, 24, 200, 16, 8, 128, [150, 0], [174, 24], [0, 0],
                            {"fp8": True, "route": "mma"}),
}


@requires_cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(cuda_device, name):
    b, s, t, nq, nkv, d, q_start, kv_len, kv_start, ex = CUDA_CASES[name]
    dt = ex.get("dtype", torch.bfloat16)
    q, k, v = _qkv(5, b, s, t, nq, nkv, d, device=cuda_device, dtype=dt)
    if ex.get("fp8"):
        k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)

    def arg(x):
        return torch.tensor(x, device=cuda_device) if isinstance(x, list) else x

    kw = dict(stream=ex.get("stream"), softcap=ex.get("softcap", 0.0), window=ex.get("window"),
              sinks=torch.randn(nq, device=cuda_device) if ex.get("sinks") else None)
    plan = A.flash_plan(b, s, t, nq, nkv, dt, arg(q_start), arg(kv_len), ex.get("window"),
                        arg(kv_start))
    assert plan.route == ex["route"] and (plan.splits > 1) == bool(ex.get("splits"))
    before = (A.flash_gqa.launches, A.flash_gqa.split_launches, A.flash_gqa.mma_launches)
    got = A.flash_gqa(q, k, v, arg(q_start), arg(kv_len), arg(kv_start), **kw)
    want = A.flash_gqa_reference(q, k, v, arg(q_start), arg(kv_len), arg(kv_start), **kw)
    torch.cuda.synchronize()
    split, mma = ex["route"] == "split", ex["route"] == "mma"
    assert (A.flash_gqa.launches, A.flash_gqa.split_launches, A.flash_gqa.mma_launches) == (
        before[0] + 1, before[1] + split, before[2] + mma)
    assert got.dtype == dt and got.device.type == "cuda"
    tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]
    assert row_rel_err(got, want, d) <= tol


@requires_cuda
def test_cuda_kernel_rejects_mixed_devices_and_fp16(cuda_device):
    q, k, v = _qkv(6, 1, 4, 16, 8, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one device"):
        A.flash_gqa(q, k.cpu(), v.cpu(), 0, 4)
    with pytest.raises(TypeError):
        A.flash_gqa(q.half(), k.half(), v.half(), 0, 4)


# -- paged decode attention ------------------------------------------------------


def _paged_case(seed, b, nq, nkv, d, bs, mb, kv_len, device="cpu", dtype=torch.float32,
                pool_dtype=None, nb=None):
    """Pools with garbage in the scratch block 0 and in unchained blocks,
    chains shuffled through the pool, each lane's query at kv_len - 1."""
    g = torch.Generator().manual_seed(seed)
    nb = nb or 1 + b * mb + 3
    kp = torch.randn(nb, bs, nkv, d, generator=g)
    vp = torch.randn(nb, bs, nkv, d, generator=g)
    kp[0], vp[0] = 300.0, -300.0  # scratch: any read of it would show (finite in fp8)
    table = (torch.randperm(nb - 1, generator=g)[: b * mb] + 1).reshape(b, mb).to(torch.int32)
    for lane, n in enumerate(kv_len):
        table[lane, -(-n // bs):] = 0  # unallocated chain slots point at scratch
    q = torch.randn(b, 1, nq, d, generator=g)
    kl = torch.tensor(kv_len)
    qpos = (kl - 1).clamp(min=0)[:, None]
    pd = pool_dtype or dtype
    return (q.to(device, dtype), kp.to(device, pd), vp.to(device, pd), table.to(device),
            qpos.to(device), kl.to(device))


def test_paged_plain_version_equals_dense_gather_and_zero_lanes():
    """The plain paged version over a shuffled chain equals flash_gqa's
    plain version over the gathered dense view, and a kv_len 0 lane gives
    exact zeros."""
    q, kp, vp, table, qpos, kl = _paged_case(7, 3, 4, 2, 16, 4, 5, [13, 0, 20])
    got = A.paged_decode_gqa(q, kp, vp, table, qpos, kl)
    kd, vd = A.gather_block_kv(kp, vp, table)
    want = A.flash_gqa_reference(q, kd, vd, qpos[:, 0], kl)
    assert torch.equal(got, want)
    assert got[1].abs().max() == 0 and got[0].abs().max() > 0
    assert torch.isfinite(got).all()  # scratch's 1e4 garbage is never attended


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(s=2), "S == 1"),
        (dict(d=32), "head_dim"),
        (dict(table_dtype=torch.int64), "int32"),
        (dict(nq=18, nkv=2), "groups"),
        (dict(pool_dtype=torch.float16), "pool dtype"),
        (dict(noncontig=True), "contiguous"),
    ],
)
def test_paged_kernel_path_rejects_what_the_kernel_does_not_take(kw, err):
    nq, nkv, d = kw.get("nq", 4), kw.get("nkv", 2), kw.get("d", 64)
    q, kp, vp, table, qpos, kl = _paged_case(8, 2, nq, nkv, d, 8, 3, [10, 20],
                                             pool_dtype=kw.get("pool_dtype"))
    if kw.get("s"):
        q = q.expand(2, kw["s"], nq, d).contiguous()
    if "table_dtype" in kw:
        table = table.to(kw["table_dtype"])
    if kw.get("noncontig"):
        kp = kp.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError), match=err):
        A._paged_launch(q, kp, vp, table, qpos, kl, None, 0.0, None, None)


PAGED_CUDA_CASES = {
    # (b, nq, nkv, d, bs, mb, kv_len, extra)
    "qwen_b8_bs32": (8, 16, 8, 128, 32, 32, [17, 60, 101, 230, 301, 480, 701, 1000], {}),
    "bs16_group4": (3, 16, 4, 128, 16, 9, [1, 70, 144], {}),
    "d64_group8_zero_lane": (4, 16, 2, 64, 32, 4, [0, 31, 33, 128], {}),
    "window_softcap_sinks": (2, 16, 8, 128, 32, 8, [200, 256],
                             {"window": 70, "softcap": 30.0, "sinks": True, "scale": 0.05}),
    "fp8_pools": (2, 16, 8, 128, 32, 6, [100, 190], {"fp8": True}),
    "f32": (2, 8, 4, 64, 16, 6, [40, 96], {"dtype": torch.float32}),
    "f32_fp8": (2, 8, 4, 128, 16, 6, [40, 96], {"dtype": torch.float32, "fp8": True}),
}


@requires_cuda
@pytest.mark.parametrize("name", sorted(PAGED_CUDA_CASES))
def test_cuda_paged_kernel_matches_plain(cuda_device, name):
    b, nq, nkv, d, bs, mb, kv_len, ex = PAGED_CUDA_CASES[name]
    dt = ex.get("dtype", torch.bfloat16)
    q, kp, vp, table, qpos, kl = _paged_case(
        9, b, nq, nkv, d, bs, mb, kv_len, device=cuda_device, dtype=dt,
        pool_dtype=torch.float8_e4m3fn if ex.get("fp8") else None)
    kw = dict(scale=ex.get("scale"), softcap=ex.get("softcap", 0.0), window=ex.get("window"),
              sinks=torch.randn(nq, device=cuda_device) if ex.get("sinks") else None)
    before = A.paged_decode_gqa.launches
    got = A.decode_gqa(q, kp, vp, qpos, kl, block_table=table, **kw)
    want = A.paged_decode_gqa_reference(q, kp, vp, table, qpos, kl, **kw)
    torch.cuda.synchronize()
    assert A.paged_decode_gqa.launches == before + 1
    assert got.dtype == dt and got.shape == (b, 1, nq * d)
    tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]
    assert row_rel_err(got, want, d) <= tol


PAGED_SPLIT_CASES = {
    # (b, nq, nkv, d, bs, mb, kv_len, extra): chains long enough that
    # paged_plan splits them; a lane shorter than a range, an empty lane,
    # a window whose floor falls inside a range, sinks folded once
    "one_long_b4": (4, 16, 8, 128, 32, 128, [4096, 17, 0, 300], {}),
    "b1_4096_sinks": (1, 16, 8, 128, 32, 128, [4096], {"sinks": True}),
    "window_inside_a_range": (2, 16, 8, 128, 16, 64, [1000, 700], {"window": 300}),
    "f32_fp8_d64": (2, 8, 2, 64, 16, 40, [640, 9], {"dtype": torch.float32, "fp8": True}),
}


@requires_cuda
@pytest.mark.parametrize("name", sorted(PAGED_SPLIT_CASES))
def test_cuda_paged_split_route_matches_plain_and_repeats(cuda_device, name):
    """Chains cut into ranges and merged by the combine kernel: within the
    tolerance of the plain version, the split counter moved, and two calls
    give the same bits."""
    b, nq, nkv, d, bs, mb, kv_len, ex = PAGED_SPLIT_CASES[name]
    dt = ex.get("dtype", torch.bfloat16)
    q, kp, vp, table, qpos, kl = _paged_case(
        11, b, nq, nkv, d, bs, mb, kv_len, device=cuda_device, dtype=dt,
        pool_dtype=torch.float8_e4m3fn if ex.get("fp8") else None)
    kw = dict(window=ex.get("window"),
              sinks=torch.randn(nq, device=cuda_device) if ex.get("sinks") else None)
    plan = A.paged_plan(b, nkv, mb, bs, dt)
    assert plan.splits > 1
    before = (A.paged_decode_gqa.launches, A.paged_decode_gqa.split_launches)
    got = A.paged_decode_gqa(q, kp, vp, table, qpos, kl, **kw)
    again = A.paged_decode_gqa(q, kp, vp, table, qpos, kl, **kw)
    want = A.paged_decode_gqa_reference(q, kp, vp, table, qpos, kl, **kw)
    torch.cuda.synchronize()
    assert (A.paged_decode_gqa.launches, A.paged_decode_gqa.split_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]
    assert row_rel_err(got, want, d) <= tol
    empty = (kl == 0).nonzero().flatten()
    if not ex.get("sinks"):
        assert torch.equal(got[empty], torch.zeros_like(got[empty]))


# -- decode GEMVs (w8a16_matmul, w4a16_matvec) --------------------------------------


def _qmm_case(seed, m, k, n, device="cpu", dtype=torch.float32, group=128):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=g) * 0.02
    x = torch.randn(m, k, generator=g)
    return (x.to(device, dtype), quant.quantize(w.to(device, dtype)),
            quant.quantize_int4(w.to(device, dtype), group))


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(m=65), "MAX_KERNEL_ROWS"),
        (dict(dtype=torch.float16), "f32 or bf16"),
        (dict(noncontig=True), "contiguous"),
        (dict(misaligned=True), "16-byte aligned"),
        (dict(scale_dtype=torch.bfloat16), "f32 scale"),
        (dict(k_mismatch=True), "want x"),
    ],
)
def test_gemv_kernel_paths_reject_what_the_kernels_do_not_take(kw, err):
    """The CUDA paths validate before they build or launch (checked on CPU
    tensors, which the validation treats like any other)."""
    x, q8, q4 = _qmm_case(1, kw.get("m", 4), 64, 48, dtype=kw.get("dtype", torch.float32))
    if kw.get("k_mismatch"):
        x = x[:, :32]
    if kw.get("noncontig"):
        q8 = quant.QuantWeight(q8.q.t().contiguous().t(), q8.scale)
        q4 = quant.Int4Weight(q4.q.t().contiguous().t(), q4.scale, q4.packed)
    if kw.get("misaligned"):
        raw = torch.zeros(q8.q.numel() + 1, dtype=torch.int8)
        raw[1:] = q8.q.flatten()
        q8 = quant.QuantWeight(raw[1:].view(q8.q.shape), q8.scale)
        raw4 = torch.zeros(q4.q.numel() + 1, dtype=torch.int8)
        raw4[1:] = q4.q.flatten()
        q4 = quant.Int4Weight(raw4[1:].view(q4.q.shape), q4.scale, q4.packed)
    if "scale_dtype" in kw:
        q8 = quant.QuantWeight(q8.q, q8.scale.to(kw["scale_dtype"]))
        q4 = quant.Int4Weight(q4.q, q4.scale.to(kw["scale_dtype"]), q4.packed)
    with pytest.raises((ValueError, TypeError), match=err):
        Q._launch_w8a16(x, q8.q, q8.scale)
    with pytest.raises((ValueError, TypeError), match=err):
        Q._launch_w4a16(x, q4, "grouped")


def test_w4a16_rejects_an_unknown_scheme():
    x, _, q4 = _qmm_case(2, 2, 64, 48)
    with pytest.raises(ValueError, match="scheme"):
        Q.w4a16_matvec(x, q4, "fused")


def test_gemv_plain_versions_match_dequantized_products():
    """Each plain version against x @ the dequantized weight in f64 (the
    dequant scheme rounds q * scale to x.dtype first: exact in f32)."""
    x, q8, q4 = _qmm_case(3, 5, 130, 40, group=64)  # K 130: groups of 65 split byte pairs
    xd = x.double()
    torch.testing.assert_close(Q.w8a16_matmul_reference(x, q8.q, q8.scale).double(),
                               xd @ q8.dequantize(torch.float64), rtol=1e-5, atol=1e-5)
    for scheme in ("grouped", "dequant"):
        torch.testing.assert_close(Q.w4a16_matvec_reference(x, q4, scheme).double(),
                                   xd @ q4.dequantize(torch.float64), rtol=1e-5, atol=1e-5)


GEMV_CUDA_CASES = {
    # name: (M, K, N, dtype, int4 group)
    "q_proj_m1": (1, *QMM_SHAPES["q_proj"], torch.bfloat16, 128),
    "gate_up_m8": (8, *QMM_SHAPES["gate_up_proj"], torch.bfloat16, 128),
    "down_m64": (64, *QMM_SHAPES["down_proj"], torch.bfloat16, 128),
    "head_m1": (1, *QMM_SHAPES["lm_head_q"], torch.bfloat16, 128),
    "f32_m3": (3, 1024, 1024, torch.float32, 128),
    "ragged_n1000": (8, 1024, 1000, torch.bfloat16, 128),
    "ragged_n333": (2, 256, 333, torch.bfloat16, 128),
    "odd_k1023": (4, 1023, 512, torch.bfloat16, 128),
    "k130_group65": (5, 130, 200, torch.float32, 128),
}


@requires_cuda
@pytest.mark.parametrize("kernel", ["w8a16", "w4a16_grouped", "w4a16_dequant"])
@pytest.mark.parametrize("name", sorted(GEMV_CUDA_CASES))
def test_cuda_gemv_kernels_match_plain(cuda_device, name, kernel):
    m, k, n, dt, group = GEMV_CUDA_CASES[name]
    x, q8, q4 = _qmm_case(4, m, k, n, device=cuda_device, dtype=dt, group=group)
    if kernel == "w8a16":
        before = Q.w8a16_matmul.launches
        got, want = Q.w8a16_matmul(x, q8.q, q8.scale), Q.w8a16_matmul_reference(x, q8.q, q8.scale)
        launches = Q.w8a16_matmul.launches - before
    else:
        scheme = kernel.split("_")[1]
        before = Q.w4a16_matvec.launches
        got, want = Q.w4a16_matvec(x, q4, scheme), Q.w4a16_matvec_reference(x, q4, scheme)
        launches = Q.w4a16_matvec.launches - before
    torch.cuda.synchronize()
    assert launches == 1 and got.dtype == dt and got.shape == (m, n)
    assert row_rel_err(got, want, n) <= QMM_TOL["float32" if dt == torch.float32 else "bfloat16"]


GEMV_ROUTE_CASES = {
    # name: (M, K, N, dtype): the mma route's four row capacities past 8,
    # a K split whose last rank is short, odd K and f32 on the simt route
    "m9": (9, 1024, 1024, torch.bfloat16),
    "m33": (33, 2048, 1024, torch.bfloat16),
    "m64_head_slice": (64, 1024, 4096, torch.bfloat16),
    "ragged_last_rank_k1040": (8, 1040, 1024, torch.bfloat16),
    "odd_k1023_m33": (33, 1023, 1024, torch.bfloat16),
    "f32_m64": (64, 1024, 1024, torch.float32),
    "f32_m1": (1, 3072, 1024, torch.float32),
    # the 128-column tile of a wide unsplit weight, its last tile ragged
    "wide_m12": (12, 1024, 16448, torch.bfloat16),
    "wide_f32_m8": (8, 512, 16448, torch.float32),
}


@requires_cuda
@pytest.mark.parametrize("kernel", ["w8a16", "w4a16_grouped", "w4a16_dequant"])
@pytest.mark.parametrize("name", sorted(GEMV_ROUTE_CASES))
def test_cuda_gemv_routes_splits_and_repeats(cuda_device, name, kernel):
    """Each call moves the counter of the route qgemv_plan names, matches
    the plain version, and gives the same bits twice."""
    m, k, n, dt = GEMV_ROUTE_CASES[name]
    x, q8, q4 = _qmm_case(9, m, k, n, device=cuda_device, dtype=dt)
    if kernel == "w8a16":
        wrapper, plan = Q.w8a16_matmul, Q.qgemv_plan(m, k, n, 1, "int8", "grouped", dt)
        call = lambda: Q.w8a16_matmul(x, q8.q, q8.scale)  # noqa: E731
        want = Q.w8a16_matmul_reference(x, q8.q, q8.scale)
    else:
        scheme = kernel.split("_")[1]
        wrapper = Q.w4a16_matvec
        plan = Q.qgemv_plan(m, k, n, q4.scale.shape[0], "int4" if q4.packed else "int4_bytes",
                            scheme, dt)
        call = lambda: Q.w4a16_matvec(x, q4, scheme)  # noqa: E731
        want = Q.w4a16_matvec_reference(x, q4, scheme)
    before = {r: getattr(wrapper, f"{r}_launches") for r in ("mma", "simt")}
    got, again = call(), call()
    torch.cuda.synchronize()
    moved = {r: getattr(wrapper, f"{r}_launches") - v for r, v in before.items()}
    assert moved == {r: 2 if r == plan.route else 0 for r in moved}
    if name == "ragged_last_rank_k1040" and kernel == "w8a16":
        lo, hi = plan.rank_ranges(k)[-1]
        assert plan.cluster > 1 and 0 < hi - lo < plan.k_per_rank
    assert torch.equal(got, again)
    assert row_rel_err(got, want, n) <= QMM_TOL["float32" if dt == torch.float32 else "bfloat16"]


@requires_cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_qdot_launches_the_kernel_up_to_64_rows(cuda_device, bits):
    """A stacked weight's layer slice (q[i]: an offset view) through qdot:
    64 rows launch the kernel once, 65 take the plain product."""
    g = torch.Generator().manual_seed(5)
    w = (torch.randn(3, 1024, 2048, generator=g) * 0.02).to(cuda_device, torch.bfloat16)
    qw = quant.quantize(w) if bits == 8 else quant.quantize_int4(w)
    wrapper = Q.w8a16_matmul if bits == 8 else Q.w4a16_matvec
    for rows, launched in ((1, 1), (Q.MAX_KERNEL_ROWS, 1), (Q.MAX_KERNEL_ROWS + 1, 0)):
        x = torch.randn(1, rows, 1024, generator=g).to(cuda_device, torch.bfloat16)
        before = wrapper.launches
        got = quant.qdot(x, qw[2])
        torch.cuda.synchronize()
        assert wrapper.launches - before == launched
        want = x.float() @ qw[2].dequantize(torch.float32)
        assert row_rel_err(got, want, 2048) <= QMM_TOL["bfloat16"]


@pytest.mark.parametrize("m,n", [(0, 48), (3, 0)])
def test_gemv_empty_products_reach_no_kernel(m, n, monkeypatch):
    """No rows or no columns: the launch path returns an empty [M, N] before
    it builds anything (checked on CPU tensors, as above)."""
    from inferd_tpu_torch.ops import build

    def no_build(name):
        raise AssertionError("an empty product must not reach the kernel build")

    monkeypatch.setattr(build, "load", no_build)
    x, q8, q4 = _qmm_case(7, m, 64, max(n, 2))
    q8 = quant.QuantWeight(q8.q[:, :n].contiguous(), q8.scale[:n].contiguous())
    q4 = quant.Int4Weight(q4.q[:, :n].contiguous(), q4.scale[:, :n].contiguous(), q4.packed)
    for out, plan in (Q._launch_w8a16(x, q8.q, q8.scale), Q._launch_w4a16(x, q4, "grouped")):
        assert out.shape == (m, n) and plan is None  # no plan: nothing launched


@requires_cuda
def test_cuda_gemv_empty_product_counts_no_launch(cuda_device):
    x, q8, q4 = _qmm_case(8, 0, 256, 128, device=cuda_device, dtype=torch.bfloat16)
    before = Q.w8a16_matmul.launches, Q.w4a16_matvec.launches
    assert Q.w8a16_matmul(x, q8.q, q8.scale).shape == (0, 128)
    assert Q.w4a16_matvec(x, q4, "grouped").shape == (0, 128)
    assert (Q.w8a16_matmul.launches, Q.w4a16_matvec.launches) == before


@requires_cuda
def test_cuda_gemv_rejects_noncontiguous_weight(cuda_device):
    x, q8, q4 = _qmm_case(6, 2, 256, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        Q.w8a16_matmul(x, q8.q.t().contiguous().t(), q8.scale)
    with pytest.raises(ValueError, match="contiguous"):
        Q.w4a16_matvec(x, quant.Int4Weight(q4.q.t().contiguous().t(), q4.scale), "grouped")


# -- the fused LoRA lane delta ------------------------------------------------------


@requires_cuda
@pytest.mark.parametrize("name", [c["name"] for c in LORA_CASES])
def test_cuda_lora_delta_matches_plain(cuda_device, name):
    """chip_smoke's cases: decode at 8 lanes (ranks 16 and 64, every
    projection), prefill at S 256 and 1000, f32, ranks 1 and 33, all lanes
    on the base slot (exact zeros)."""
    c = next(c for c in LORA_CASES if c["name"] == name)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, a_pool, b_pool, scale, ids = lora_inputs(c, gen, cuda_device)
    before = L.fused_lane_delta.launches
    got = L.fused_lane_delta(x, a_pool, b_pool, scale, ids, LORA_LAYER)
    want = L.fused_lane_delta_reference(x, a_pool, b_pool, scale, ids, LORA_LAYER)
    torch.cuda.synchronize()
    assert L.fused_lane_delta.launches - before == 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert row_rel_err(got, want, got.shape[-1]) <= LORA_TOL
    base = (ids == 0).nonzero().flatten()
    assert torch.equal(got[base], torch.zeros_like(got[base]))  # exact zeros, not small


LORA_ROUTE_CASES = {
    # (b, s, din, dout, r, ids, x/pool dtype): each lora_plan route, row tile
    # and cluster size, K walked in chunks, unaligned rows (element loads),
    # ragged columns
    "mma_prefill_chunks_r128": (1, 40, 3072, 1024, 128, [1], torch.bfloat16),
    "mma_two_lanes_r8": (2, 33, 1024, 1000, 8, [2, 1], torch.bfloat16),
    "simt_cluster1_odd": (3, 5, 40, 24, 3, [1, 0, 2], torch.bfloat16),
    "simt_decode_odd_k": (3, 1, 45, 24, 5, [2, 1, 0], torch.bfloat16),
    "simt_cluster4_din1000": (2, 17, 1000, 333, 7, [2, 1], torch.float32),
    "simt_f32_chunks_r128": (2, 1, 3072, 1024, 128, [1, 2], torch.float32),
}


@requires_cuda
@pytest.mark.parametrize("name", sorted(LORA_ROUTE_CASES))
def test_cuda_lora_delta_routes_match_plain_and_y_mode(cuda_device, name):
    """Every plan shape against the plain version (LORA_TOL), the same bits
    on two calls, and the y= mode equal to the unfused add bit for bit, in
    place too, with base lanes leaving y untouched."""
    b, s, din, dout, r, ids, dt = LORA_ROUTE_CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    a_pool = torch.randn((3, 2, din, r), generator=g, device=cuda_device) * 0.05
    b_pool = torch.randn((3, 2, r, dout), generator=g, device=cuda_device) * 0.05
    a_pool[0] = b_pool[0] = 0.0
    a_pool, b_pool = a_pool.to(dt), b_pool.to(dt)
    x = torch.randn((b, s, din), generator=g, device=cuda_device).to(dt)
    scale = torch.tensor([0.0, 2.0, 0.5], device=cuda_device)
    idt = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
    plan = L.lora_plan(b, s, din, dout, r, dt, dt)
    got = L.fused_lane_delta(x, a_pool, b_pool, scale, idt, 1)
    again = L.fused_lane_delta(x, a_pool, b_pool, scale, idt, 1)
    want = L.fused_lane_delta_reference(x, a_pool, b_pool, scale, idt, 1)
    y = torch.randn((b, s, dout), generator=g, device=cuda_device).to(torch.bfloat16)
    fused = L.fused_lane_delta(x, a_pool, b_pool, scale, idt, 1, y=y)
    y_in = y.clone()
    L.fused_lane_delta(x, a_pool, b_pool, scale, idt, 1, y=y_in, inplace=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert row_rel_err(got, want, dout) <= LORA_TOL, plan
    assert torch.equal(fused, (y.float() + got).to(y.dtype))
    assert torch.equal(y_in, fused)
    base = (idt == 0).nonzero().flatten()
    assert torch.equal(fused[base], y[base]) and torch.equal(got[base], torch.zeros_like(got[base]))


@requires_cuda
def test_cuda_lora_delta_slot_out_of_range_writes_nan(cuda_device):
    c = dict(LORA_CASES[0])
    x, a_pool, b_pool, scale, ids = lora_inputs(c, torch.Generator(device=cuda_device)
                                                .manual_seed(2), cuda_device)
    ids = ids.clone()
    ids[1] = a_pool.shape[0]  # one past the last slot
    got = L.fused_lane_delta(x, a_pool, b_pool, scale, ids, 0)
    y = torch.zeros(got.shape, dtype=torch.bfloat16, device=cuda_device)
    L.fused_lane_delta(x, a_pool, b_pool, scale, ids, 0, y=y, inplace=True)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all() and torch.isfinite(got[0]).all()
    assert torch.isnan(y[1].float()).all() and torch.isfinite(y[0].float()).all()


@requires_cuda
def test_cuda_lora_delta_refuses_noncontiguous_x_and_counts_no_empty_launch(cuda_device):
    c = dict(LORA_CASES[0])
    x, a_pool, b_pool, scale, ids = lora_inputs(c, torch.Generator(device=cuda_device)
                                                .manual_seed(1), cuda_device)
    xt = torch.cat([x, x], dim=-1)[..., ::2]  # the same values, every other element
    with pytest.raises(ValueError, match="contiguous"):
        L.fused_lane_delta(xt, a_pool, b_pool, scale, ids, 0)
    before = L.fused_lane_delta.launches
    assert L.fused_lane_delta(x[:, :0], a_pool, b_pool, scale, ids, 0).shape == (8, 0, 2048)
    assert L.fused_lane_delta.launches == before


@requires_cuda
def test_cuda_lane_executor_launches_the_delta_only_for_tenant_dispatches(cuda_device, tmp_path):
    """A base session's prefill and decode on a registry executor launch no
    lane delta; a tenant's prefill launches one per layer and covered
    projection, and the decode windows it joins launch for every lane."""
    import dataclasses

    from inferd_tpu_torch.config import TINY
    from inferd_tpu_torch.models import qwen3
    from inferd_tpu_torch.parallel.stages import StageSpec
    from inferd_tpu_torch.runtime.adapters import AdapterRegistry
    from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

    cfg = dataclasses.replace(TINY, head_dim=64)  # a head size the flash kernel takes
    g = np.random.default_rng(0)
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "o_proj": (cfg.q_dim, cfg.hidden_size)}
    layers = {t: (g.normal(0, 0.3, (cfg.num_layers, din, 4)).astype(np.float32),
                  g.normal(0, 0.3, (cfg.num_layers, 4, dout)).astype(np.float32))
              for t, (din, dout) in dims.items()}
    L.save_adapter(str(tmp_path / "ten"), layers, alpha=8, r=4)
    params = qwen3.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    reg = AdapterRegistry(cfg, [str(tmp_path / "ten")], device=cuda_device)
    ex = BatchedStageExecutor(cfg, StageSpec(0, 1, 0, cfg.num_layers - 1), params, lanes=2,
                              max_len=64, adapters=reg)
    prompt = [3, 17, 42, 9, 5]
    before = L.fused_lane_delta.launches
    base = ex.process("b", {"tokens": [prompt], "start_pos": 0, "real_len": 5})["logits"]
    ex.process("b", {"tokens": [[int(base.argmax())]], "start_pos": 5, "real_len": 1})
    assert L.fused_lane_delta.launches == before
    ten = ex.process("t", {"tokens": [prompt], "start_pos": 0, "real_len": 5,
                           "adapter": "ten"})["logits"]
    assert L.fused_lane_delta.launches - before == 2 * cfg.num_layers
    assert not torch.equal(ten, base)
    out = ex.process_batch([("b", {"tokens": [[1]], "start_pos": 6, "real_len": 1}),
                            ("t", {"tokens": [[2]], "start_pos": 5, "real_len": 1})])
    assert not any(isinstance(o, Exception) for o in out), out
    assert L.fused_lane_delta.launches - before == 4 * cfg.num_layers

"""The flash_gqa and paged_decode_gqa wrappers' contracts, and on a card
each CUDA kernel against its plain version.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a CUDA card and no JAX: there, skip the JAX-pinning conftest
with `python -m pytest --noconftest tests/test_torch_kernels.py`.

Tolerance on the card: chip_smoke's rule, `row_rel_err` against
`ATTN_TOL`: the worst output row's max |kernel - plain| over that row's
RMS in the plain version, with rows the plain version leaves at zero held
to exactly zero (chip_smoke.py says why, and PERF.md gives the sound and
planted-fault readings that place the limits)."""

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL, row_rel_err
from inferd_tpu_torch.ops import attention as A
from inferd_tpu_torch.ops import build

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
    # (b, s, t, nq, nkv, d, q_start, kv_len, kv_start, extra)
    "prefill": (1, 64, 64, 16, 8, 128, 0, 64, 0, {}),
    "chunk_over_buffer": (1, 40, 256, 16, 8, 128, 100, 140, 0, {}),
    "decode": (1, 1, 300, 16, 8, 128, 250, 251, 0, {}),
    "per_batch_meta": (3, 4, 32, 8, 2, 64, [0, 8, 20], [4, 0, 24], [0, 0, 0], {}),
    "kv_start_window_softcap": (2, 16, 96, 8, 2, 64, 120, 80, 50, {"window": 24, "softcap": 30.0}),
    "sinks_stream": (1, 8, 128, 16, 8, 128, 100, 108, 0, {"sinks": True, "stream": True}),
    "group8": (1, 5, 64, 16, 2, 128, 30, 35, 0, {}),
    "f32": (2, 9, 64, 8, 4, 64, 10, 19, 0, {"dtype": torch.float32}),
    "fp8_kv_f32_q": (1, 8, 64, 8, 4, 64, 20, 28, 0, {"dtype": torch.float32, "fp8": True}),
    "fp8_kv_bf16_q": (1, 8, 64, 8, 4, 128, 20, 28, 0, {"fp8": True}),
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
    before = A.flash_gqa.launches
    got = A.flash_gqa(q, k, v, arg(q_start), arg(kv_len), arg(kv_start), **kw)
    want = A.flash_gqa_reference(q, k, v, arg(q_start), arg(kv_len), arg(kv_start), **kw)
    torch.cuda.synchronize()
    assert A.flash_gqa.launches == before + 1
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

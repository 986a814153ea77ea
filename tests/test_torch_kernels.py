"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run the kernels' plain PyTorch versions; they are
held against the JAX package's Pallas kernels run in interpret mode (as
``tests/test_kernels.py`` runs them) and against its jnp attention, in
fp32 within 1e-5.  The CUDA kernels themselves are held against the plain
versions by the ``cuda`` cases, which need a card and skip here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions vs the JAX package (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,dh,bk,nvalid", [(256, 64, 64, 239),
                                            (128, 32, 32, 1)])
def test_decode_matches_pallas_interpret(s, dh, bk, nvalid):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(s)
    q, k, v = _rand(rng, (6, dh)), _rand(rng, (6, s, dh)), _rand(rng, (6, s, dh))
    valid = np.broadcast_to(np.arange(s)[None] < nvalid, (6, s)).copy()
    want = jops.decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(valid), block_k=bk)
    got = ops.decode(_t(q), _t(k), _t(v), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_partial_matches_pallas_interpret():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(7)
    s, dh = 256, 32
    q, k, v = _rand(rng, (3, dh)), _rand(rng, (3, s, dh)), _rand(rng, (3, s, dh))
    valid = np.broadcast_to(np.arange(s)[None] < 200, (3, s)).copy()
    want = jops.decode_partial(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(valid),
                               block_k=32)
    got = ops.decode_partial(_t(q), _t(k), _t(v), _t(valid))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # partials over shards combine to the whole
    parts = [ops.decode_partial(_t(q), _t(k[:, sl]), _t(v[:, sl]),
                                _t(valid[:, sl]))
             for sl in (slice(0, 96), slice(96, s))]
    comb = ref.combine_partials(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1][:, 0] for p in parts]),
                                torch.stack([p[2][:, 0] for p in parts]))
    np.testing.assert_allclose(comb.numpy(), np.asarray(
        jops.decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(valid), block_k=32)), **TOL)


@pytest.mark.parametrize("g,lengths", [(1, [5, 40, 64]), (4, [64, 1, 33])])
def test_grouped_decode_matches_attention_module(g, lengths):
    """The grouped layout (G > 1 query heads per KV head, ragged valid
    lengths) against ``repro.models.attention.flash_decode``'s jnp path
    and its Pallas path (which broadcasts the cache to G copies)."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    rng = np.random.default_rng(g)
    b, s, kv, dh = 3, 64, 2, 32
    q = _rand(rng, (b, kv, g, dh))
    k, v = _rand(rng, (b, s, kv, dh)), _rand(rng, (b, s, kv, dh))
    valid = np.arange(s)[None] < np.asarray(lengths)[:, None]
    got = ops.decode_gqa(_t(q), _t(k), _t(v), _t(valid)).numpy()
    for impl in (None, "pallas"):
        want = jattn.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(valid), None,
                                  impl=impl)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_attention_matches_pallas_interpret(causal, window):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(11)
    s, dh = 128, 32
    q, k, v = (_rand(rng, (2, s, dh)) for _ in range(3))
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window, block_q=64,
                          block_k=64)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,g,window", [(77, 2, None), (77, 2, 32),
                                         (40, 1, None), (64, 4, 16)])
def test_grouped_attention_matches_chunked_attention(sq, g, window):
    """Odd lengths and G > 1 against the reference prefill attention."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    rng = np.random.default_rng(sq + g)
    b, kv, dh = 2, 2, 32
    q = _rand(rng, (b, sq, kv, g, dh))
    k, v = _rand(rng, (b, sq, kv, dh)), _rand(rng, (b, sq, kv, dh))
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, block_q=16,
                             block_k=16)
    got = ops.attention_gqa(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_rows_match_chunked_attention():
    """Sq > Sk with a window: rows 81..99 see no key at all, and both
    packages give them the mean of V over all Sk keys."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    rng = np.random.default_rng(100)
    q = _rand(rng, (1, 100, 2, 2, 32))
    k, v = _rand(rng, (1, 50, 2, 32)), _rand(rng, (1, 50, 2, 32))
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=32, block_q=20, block_k=10)
    got = ops.attention_gqa(_t(q), _t(k), _t(v), causal=True, window=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[0, 99, :, 0].numpy(), v[0].mean(0),
                               **TOL)


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    q, k, v = (_t(_rand(rng, (1, 8, 1, 1, 32))) for _ in range(3))
    ops.attention_gqa(q, k[:, :, :, 0], v[:, :, :, 0])
    pages = _t(_rand(rng, (3, 4, 1, 32)))
    tables = torch.zeros((1, 2), dtype=torch.int32)
    lengths = torch.tensor([5], dtype=torch.int32)
    ops.paged_decode(q[:, 0], pages, pages, tables, lengths)
    ops.paged_verify(q[:, :2], pages, pages, tables, lengths)
    w8 = torch.ones((32, 8), dtype=torch.int8)
    ops.quant_matmul(q[0, :, 0, 0], w8, torch.ones(8), 8)
    ops.matmul(q[0, :, 0, 0], torch.ones((32, 8)))
    ops.paged_decode(q[:, 0], pages, pages, tables, lengths, impl="gather")
    assert ops.LAUNCHES == {"flash_decode": 0, "flash_attention": 0,
                            "paged_flash_decode": 0,
                            "paged_flash_verify": 0,
                            "quantized_matmul": 0, "streamed_matmul": 0}


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="on the CPU or all on one CUDA device"):
        ops._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (card only)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,kv,g,dh", [(4, 160, 16, 1, 64),
                                         (2, 1000, 4, 8, 128),
                                         (3, 37, 2, 2, 32)])
def test_cuda_decode_matches_plain(cuda, b, s, kv, g, dh):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((b, kv, g, dh), generator=gen, device=cuda)
    k = torch.randn((b, s, kv, dh), generator=gen, device=cuda)
    v = torch.randn((b, s, kv, dh), generator=gen, device=cuda)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=cuda)
    valid = torch.arange(s, device=cuda)[None] < lens[:, None]
    before = ops.LAUNCHES["flash_decode"]
    got = ops.decode_gqa(q, k, v, valid)
    assert ops.LAUNCHES["flash_decode"] == before + 1
    want = ref.decode_gqa_ref(q, k, v, valid)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    qf = q.reshape(b * kv * g, dh)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(g, 1).reshape(-1, s, dh)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(g, 1).reshape(-1, s, dh)
    vb = valid.repeat_interleave(kv * g, 0)
    for a, w in zip(ops.decode_partial(qf, kf, vf, vb),
                    ref.decode_partial_ref(qf, kf, vf, vb)):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sq,kv,g,dh,window", [(128, 16, 1, 64, None),
                                               (77, 4, 2, 64, 32),
                                               (200, 2, 4, 128, None),
                                               (33, 2, 2, 32, 8)])
def test_cuda_attention_matches_plain(cuda, sq, kv, g, dh, window):
    gen = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((2, sq, kv, g, dh), generator=gen, device=cuda)
    k = torch.randn((2, sq, kv, dh), generator=gen, device=cuda)
    v = torch.randn((2, sq, kv, dh), generator=gen, device=cuda)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.attention_gqa(q, k, v, causal=True, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.attention_gqa_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_cuda_attention_fully_masked_rows(cuda):
    """Sq=100 > Sk=50 with window 32: the kernel walks every key tile for
    a block holding a row that sees no key, as the plain version does."""
    gen = torch.Generator(device=cuda).manual_seed(100)
    q = torch.randn((1, 100, 16, 1, 64), generator=gen, device=cuda)
    k = torch.randn((1, 50, 16, 64), generator=gen, device=cuda)
    v = torch.randn((1, 50, 16, 64), generator=gen, device=cuda)
    got = ops.attention_gqa(q, k, v, causal=True, window=32)
    want = ref.attention_gqa_ref(q, k, v, causal=True, window=32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _cuda_paged(cuda, seed, b, w, kv, g, dh, page, nb, lengths):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_pages = b * nb + 2
    kp = torch.randn((n_pages, page, kv, dh), generator=gen, device=cuda)
    vp = torch.randn((n_pages, page, kv, dh), generator=gen, device=cuda)
    shape = (b, kv, g, dh) if w is None else (b, w, kv, g, dh)
    q = torch.randn(shape, generator=gen, device=cuda)
    # ragged rows: live pages are distinct, padded entries point at page 0
    tables = torch.zeros((b, nb), dtype=torch.int32, device=cuda)
    perm = torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1
    for i, n in enumerate(lengths):
        used = -(-n // page)
        tables[i, :used] = perm[i * nb:i * nb + used].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("b,kv,g,dh,page,nb,lengths", [
    (4, 16, 1, 64, 16, 10, [129, 140, 150, 160]),
    (2, 4, 8, 128, 16, 8, [77, 128]),
    (3, 2, 2, 32, 1, 40, [1, 17, 40]),
    (3, 2, 2, 64, 5, 9, [3, 44, 45])])
def test_cuda_paged_decode_matches_plain(cuda, b, kv, g, dh, page, nb,
                                         lengths):
    args = _cuda_paged(cuda, page * nb, b, None, kv, g, dh, page, nb,
                       lengths)
    before = ops.LAUNCHES["paged_flash_decode"]
    got = ops.paged_decode(*args)
    assert ops.LAUNCHES["paged_flash_decode"] == before + 1
    torch.testing.assert_close(got, ref.paged_decode_ref(*args), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("b,w,kv,g,dh,page,nb,lengths", [
    (1, 64, 16, 1, 64, 16, 10, [128]),
    (2, 1, 4, 8, 128, 16, 8, [77, 128]),
    (3, 3, 2, 2, 32, 5, 9, [3, 44, 45]),
    (2, 70, 2, 2, 64, 1, 90, [70, 90])])
def test_cuda_paged_verify_matches_plain(cuda, b, w, kv, g, dh, page, nb,
                                         lengths):
    args = _cuda_paged(cuda, page * nb + w, b, w, kv, g, dh, page, nb,
                       lengths)
    before = ops.LAUNCHES["paged_flash_verify"]
    got = ops.paged_verify(*args)
    assert ops.LAUNCHES["paged_flash_verify"] == before + 1
    torch.testing.assert_close(got, ref.paged_verify_ref(*args), atol=1e-4,
                               rtol=1e-4)
    if w == 1:
        torch.testing.assert_close(
            got[:, 0], ops.paged_decode(args[0][:, 0].contiguous(),
                                        *args[1:]), atol=1e-4, rtol=1e-4)


def test_cuda_kernels_reject_other_dtypes(cuda):
    """float32, float16 and bfloat16 are taken; float64 still raises (no
    fallback), as do mixed types."""
    q = torch.zeros((1, 1, 1, 64), device=cuda, dtype=torch.float64)
    kc = torch.zeros((1, 8, 1, 64), device=cuda, dtype=torch.float64)
    valid = torch.ones((1, 8), device=cuda, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32, float16 and bfloat16"):
        ops.decode_gqa(q, kc, kc, valid)
    with pytest.raises(TypeError, match="float32, float16 and bfloat16"):
        ops.matmul(q[0, 0], kc[0, :, 0].T.contiguous())
    with pytest.raises(TypeError, match="one dtype"):
        ops.decode_gqa(q.half(), kc.float(), kc.float(), valid)
    w8 = torch.ones((64, 8), device=cuda, dtype=torch.int8)
    with pytest.raises(TypeError, match="float16 or"):
        ops.quant_matmul(q[0, 0], w8, torch.ones(8, device=cuda), 8)


def _cuda_quant(cuda, seed, m, k, n, bits):
    """x (M, K) and a random int8 / packed-int4 weight with per-column
    scales, on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=cuda)
    rows = k if bits == 8 else (k + 1) // 2
    if bits == 8:
        w_q = torch.randint(-127, 128, (rows, n), generator=gen, device=cuda,
                            dtype=torch.int8)
    else:
        w_q = torch.randint(0, 256, (rows, n), generator=gen, device=cuda,
                            dtype=torch.uint8)
    scale = torch.rand((n,), generator=gen, device=cuda) / 64
    return x, w_q, scale


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 1024), (4, 1024, 4096),
                                   (4, 4096, 1024), (3, 1024, 51200),
                                   (128, 1024, 1024), (128, 4096, 1024),
                                   (2, 200, 40), (7, 66, 33), (5, 1, 16)])
def test_cuda_quant_matmul_matches_plain(cuda, m, k, n, bits):
    """The main path's shapes (decode M <= 4, prefill M = 128) and ragged
    ones (N not a multiple of 16, odd K, M between the two kernels)."""
    x, w_q, scale = _cuda_quant(cuda, m * k + n, m, k, n, bits)
    before = ops.LAUNCHES["quantized_matmul"]
    got = ops.quant_matmul(x, w_q, scale, bits)
    assert ops.LAUNCHES["quantized_matmul"] == before + 1
    want = ref.quant_matmul_ref(x, w_q, scale, bits=bits)
    tol = 1e-4 * want.abs().max().item()     # 1e-4 of the output's scale
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def test_cuda_quant_matmul_rejects_what_it_does_not_take(cuda):
    x, w_q, scale = _cuda_quant(cuda, 0, 2, 64, 32, 8)
    with pytest.raises(TypeError, match="int8"):
        ops.quant_matmul(x, w_q.view(torch.uint8), scale, 8)
    with pytest.raises(ValueError, match="do not match"):
        ops.quant_matmul(x, w_q.view(torch.uint8), scale, 4)
    with pytest.raises(ValueError, match="on the CPU or all on one CUDA"):
        ops.quant_matmul(x.cpu(), w_q, scale, 8)


# ---------------------------------------------------------------------------
# fp16 / bf16 and head_dim 256 (card only).  Tolerance, kernel against its
# plain version on the same inputs: fp32 1e-4 absolute; fp16 2e-3 and bf16
# 1.6e-2 of the output's largest magnitude (both round an fp32 result once
# to the storage type, so they differ by at most a unit or two in its
# last place where the fp32 sums' order differs).
# ---------------------------------------------------------------------------
HALF_RTOL = {torch.float16: 2e-3, torch.bfloat16: 1.6e-2}


def _close(got, want, dtype=None):
    assert got.dtype == want.dtype
    if dtype is None or dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    tol = HALF_RTOL[dtype] * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("b,s,kv,g,dh", [(2, 72, 16, 1, 256),
                                         (4, 160, 16, 1, 64),
                                         (2, 1000, 4, 8, 128)])
def test_cuda_decode_half(cuda, dtype, b, s, kv, g, dh):
    gen = torch.Generator(device=cuda).manual_seed(s + dh)
    q = torch.randn((b, kv, g, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, s, kv, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, s, kv, dh), generator=gen, device=cuda).to(dtype)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=cuda)
    valid = torch.arange(s, device=cuda)[None] < lens[:, None]
    _close(ops.decode_gqa(q, k, v, valid),
           ref.decode_gqa_ref(q, k, v, valid), dtype)
    qf = q.reshape(b * kv * g, dh)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(g, 1).reshape(-1, s, dh)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(g, 1).reshape(-1, s, dh)
    vb = valid.repeat_interleave(kv * g, 0)
    o, m, l = ops.decode_partial(qf, kf, vf, vb)
    ro, rm, rl = ref.decode_partial_ref(qf, kf, vf, vb)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(o / l, ro / rl, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("sq,kv,g,dh,causal,window", [
    (64, 16, 1, 256, True, None),       # gpt_j prefill
    (197, 16, 1, 64, False, None),      # vit_large, non-causal
    (77, 4, 2, 256, True, 32),
    (100, 2, 2, 128, True, None)])
def test_cuda_attention_half_and_dh256(cuda, dtype, sq, kv, g, dh, causal,
                                       window):
    gen = torch.Generator(device=cuda).manual_seed(sq + dh)
    q = torch.randn((2, sq, kv, g, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, sq, kv, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, sq, kv, dh), generator=gen, device=cuda).to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.attention_gqa(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    _close(got, ref.attention_gqa_ref(q, k, v, causal=causal,
                                      window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("w,kv,g,dh,page,nb,lengths", [
    (None, 16, 1, 256, 16, 5, [65, 72]),
    (None, 4, 8, 128, 16, 8, [77, 128]),
    (64, 16, 1, 256, 16, 5, [64, 72]),
    (3, 2, 2, 64, 5, 9, [3, 44])])
def test_cuda_paged_half_and_dh256(cuda, dtype, w, kv, g, dh, page, nb,
                                   lengths):
    args = _cuda_paged(cuda, page * nb, len(lengths), w, kv, g, dh, page,
                       nb, lengths)
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    if w is None:
        _close(ops.paged_decode(*args), ref.paged_decode_ref(*args), dtype)
        # the gather route: pages to a dense cache, then flash decoding
        before = ops.LAUNCHES["flash_decode"]
        _close(ops.paged_decode(*args, impl="gather"),
               ref.paged_decode_ref(*args), dtype)
        assert ops.LAUNCHES["flash_decode"] == before + 1
    else:
        _close(ops.paged_verify(*args), ref.paged_verify_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 16384), (64, 4096, 4096),
                                   (3, 66, 33)])
def test_cuda_quant_matmul_half(cuda, dtype, bits, m, k, n):
    x, w_q, scale = _cuda_quant(cuda, m + k + n, m, k, n, bits)
    x = x.to(dtype)
    got = ops.quant_matmul(x, w_q, scale, bits)
    _close(got, ref.quant_matmul_ref(x, w_q, scale, bits=bits), dtype)


def _matmul_tol(want, dtype):
    """fp32: 1e-4 of the output's scale (TF32 off); fp16 / bf16 as
    ``HALF_RTOL``."""
    return {torch.float32: 1e-4}.get(dtype, HALF_RTOL.get(dtype)) * (
        want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_cuda_streamed_matmul_every_candidate_tile(cuda, dtype):
    """gpt2_base's autotune shape (256 tokens x d_model @ d_model x d_ff)
    at every tile the sweep times: each launches the kernel once."""
    from repro_torch.kernels.autotune import _tile_candidates
    m, k, n = 256, 1024, 4096
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    want = ref.matmul_ref(x, w)
    tol = _matmul_tol(want, dtype)
    tiles = _tile_candidates(m, k, n, None)
    assert len(tiles) == 27
    for bm, bn, bk in tiles:
        before = ops.LAUNCHES["streamed_matmul"]
        got = ops.matmul(x, w, block_m=bm, block_n=bn, block_k=bk)
        assert ops.LAUNCHES["streamed_matmul"] == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128), (256, 128, 512, 128, 128, 128),
    (384, 512, 256, 128, 128, 256), (8, 64, 128, 256, 256, 512),
    (100, 70, 30, 100, 30, 70), (192, 300, 96, 192, 96, 300)])
def test_cuda_streamed_matmul_sweep(cuda, dtype, m, k, n, bm, bn, bk):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    want = ref.matmul_ref(x, w)
    got = ops.matmul(x, w, block_m=bm, block_n=bn, block_k=bk)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=_matmul_tol(want, dtype), rtol=0)
    with pytest.raises(ValueError, match="do not divide"):
        ops.matmul(x, w, block_m=m - 1 if m > 2 else 3)


@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_quant_matmul_every_candidate_tile(cuda, bits):
    """The tiled path (M > 4) at every tile autotune times for it: each
    selects its own output region, register tile and K stage."""
    from repro_torch.kernels.autotune import _tile_candidates
    m, k, n = 128, 1024, 1024
    x, w_q, scale = _cuda_quant(cuda, bits, m, k, n, bits)
    want = ref.quant_matmul_ref(x, w_q, scale, bits=bits)
    tol = 1e-4 * want.abs().max().item()
    for bm, bn, bk in _tile_candidates(m, k, n, bits):
        got = ops.quant_matmul(x, w_q, scale, bits, block_m=bm, block_n=bn,
                               block_k=bk)
        torch.testing.assert_close(got, want, atol=tol, rtol=0)


def test_cuda_autotune_sweep(cuda, tmp_path):
    """On the card the sweep times each candidate with CUDA events: one
    warm-up and ``reps`` timed launches each, keyed by ``sm<major><minor>``;
    a cache hit launches nothing."""
    from repro_torch.kernels import autotune
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    arch = autotune.device_arch(cuda)
    major, minor = torch.cuda.get_device_capability(cuda)
    assert arch == f"sm{major}{minor}"
    try:
        ops.reset_launches()
        entry = autotune.tune_matmul(64, 256, 512, cache=cache, reps=2,
                                     device=cuda)
        cands = autotune._tile_candidates(64, 256, 512, None)
        assert ops.LAUNCHES["streamed_matmul"] == len(cands) * 3
        assert entry["t_us"] > 0
        assert cache.get("matmul", arch=arch, dtype="float32") == entry
        ops.reset_launches()
        autotune.tune_matmul(64, 256, 512, cache=cache, reps=2, device=cuda)
        assert ops.LAUNCHES["streamed_matmul"] == 0
        q8 = autotune.tune_matmul(64, 256, 512, bits=8, dtype="int8",
                                  cache=cache, reps=1, device=cuda)
        assert ops.LAUNCHES["quantized_matmul"] == 2 * len(
            autotune._tile_candidates(64, 256, 512, 8))
        assert q8["shape"] == [64, 256, 512]
        paged = autotune.tune_paged_decode(16, head_dim=64, cache=cache,
                                           reps=1, device=cuda)
        assert paged["impl"] in ops.PAGED_IMPLS
        assert ops.LAUNCHES["paged_flash_decode"] == 2
        assert ops.LAUNCHES["flash_decode"] == 2
    finally:
        ops.set_tuned()


# ---------------------------------------------------------------------------
# The tensor-core matmul body (csrc/mm_tiles.cuh): its K-split plan and the
# operand splits it relies on, checked on the CPU; its K-split shapes on the
# card.
# ---------------------------------------------------------------------------
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@given(st.integers(5, 1024), st.integers(1, 16384), st.integers(1, 16384),
       st.sampled_from([(64, 64), (64, 128), (128, 64), (128, 128),
                        (256, 256), (100, 30)]),
       st.sampled_from([8, 16, 32]))
@example(128, 4096, 1024, (64, 64), 32)      # quant prefill, DEFAULT_CTA
@example(128, 1024, 1024, (64, 64), 32)
@example(128, 1024, 4096, (64, 64), 32)
@example(64, 8192, 512, (64, 64), 32)
@example(256, 1024, 4096, (256, 256), 32)    # autotune's widest region
@example(64, 4096, 16384, (64, 64), 32)      # gpt_j's MLP: no split
@settings(max_examples=300, deadline=None)
def test_tile_k_split_plan(m, k, n, region, kc):
    """The tiled body's K split: whole stages (so even logical rows for
    int4), K covered exactly once with no empty split, within the caps;
    one split when the regions already fill the SMs; the SM target reached
    whenever some whole-stage split count within the caps reaches it."""
    from repro_torch.kernels import streamed_matmul as sm
    rm, rn = region
    splits, per = sm.tile_k_splits(m, k, n, rm, rn, kc)
    ks = 2 * kc
    assert splits >= 1 and per % ks == 0 and per % 2 == 0
    assert (splits - 1) * per < k <= splits * per
    regions = -(-m // rm) * -(-n // rn)
    stages = -(-k // ks)
    if regions >= sm.SMS:
        assert splits == 1
    if splits > 1:
        assert splits <= sm.MAX_SPLITS
        assert 4 * splits * m * n <= sm.MAX_PART_BYTES
        assert regions <= sm.N_COUNTERS
    cap = min(sm.MAX_SPLITS, sm.MAX_PART_BYTES // (4 * m * n), stages)
    reachable = [-(-stages // p) for p in range(1, stages + 1)
                 if sm.SMS <= regions * -(-stages // p)
                 and -(-stages // p) <= cap]
    if regions < sm.SMS and reachable:
        assert regions * splits >= sm.SMS


@pytest.mark.parametrize("m,k,n", [(128, 4096, 1024), (128, 1024, 1024)])
def test_quant_prefill_plan_fills_the_card(m, k, n):
    """At the quant paths' prefill shapes the default launch reaches the
    H100's 132 SMs by splitting K (unsplit, it runs 32 blocks there)."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import streamed_matmul as sm
    for bits in (8, 4):
        splits, per, cta = qm._plan(m, k, n, bits, None)
        assert cta == qm.DEFAULT_CTA and splits > 1
        regions = -(-m // cta[0]) * -(-n // cta[1])
        assert regions * splits >= sm.SMS
        assert splits * m * n * 4 <= 4 * 2**20    # the workspace


def _bf16_split(x):
    """fp32 -> (hi, mid, lo), each a bf16 value held in fp32, by
    truncation to the top 16 bits, as csrc/mm_tiles.cuh::split3 does."""
    trunc = lambda a: (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(  # noqa
        np.float32)
    hi = trunc(x)
    mid = trunc(x - hi)
    lo = trunc(x - hi - mid)
    return hi, mid, lo


def _tf32_split(a):
    """fp32 -> (hi, lo), TF32 values (the low 13 mantissa bits 0) held in
    fp32, as csrc/mm_tiles.cuh::split_tf32 does."""
    trunc = lambda v: (v.view(np.uint32) & np.uint32(0xFFFFE000)).view(  # noqa
        np.float32)
    hi = trunc(a)
    return hi, trunc(a - hi)


def test_bf16_split_is_exact():
    """x = hi + mid + lo exactly, each part a bf16 (its low 16 bits 0),
    for fp32 values from 2^-100 to the largest: their remainders stay
    normal (below ~2^-110 a remainder may fall under fp32's normal range
    and lose bits, an error under 2^-133)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096)
         * 2.0 ** rng.integers(-100, 100, 4096)).astype(np.float32)
    x = np.concatenate([x, np.float32([1.0, -1.0, 3.0e38, 2.0 ** -100,
                                       np.pi, 1 / 3])]).astype(np.float32)
    hi, mid, lo = _bf16_split(x)
    for part in (hi, mid, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0xFFFF))
    np.testing.assert_array_equal(
        hi.astype(np.float64) + mid + lo, x.astype(np.float64))
    np.testing.assert_array_equal((hi + mid) + lo, x)


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_three_pass_product_matches_jax(bits):
    """fp32 x against an int8 / int4 weight as the kernel computes it:
    three bf16 passes (x = hi + mid + lo) against the integer weight, exact
    in bf16, accumulated in fp32, the scale applied to the sum; within
    1e-5 of the output's scale of JAX's quantized_matmul (interpret mode)
    and of ref.quant_matmul_ref."""
    import jax.numpy as jnp
    from repro.checkpoint import quant as jqz
    from repro.kernels import ops as jops
    m, k, n = 32, 256, 48
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qt = jqz.quantize_array(rng.standard_normal((k, n)).astype(np.float32),
                            f"int{bits}")
    w_q, scale = np.asarray(qt.q), np.asarray(qt.scale)
    xt, wt, st_ = (torch.from_numpy(a) for a in (x, w_q, scale))
    q = ref.dequant_ref(wt, torch.ones_like(st_), bits=bits)[:k]
    assert torch.equal(q, q.to(torch.bfloat16).float())   # exact in bf16
    acc = torch.zeros((m, n))
    for part in reversed(_bf16_split(x)):                 # lo, mid, hi
        acc += torch.from_numpy(part) @ q
    got = (acc * st_).numpy()
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                        jnp.asarray(scale), bits=bits,
                                        block_m=32, block_n=48,
                                        block_k=128))
    plain = ref.quant_matmul_ref(xt, wt, st_, bits=bits).numpy()
    tol = 1e-5 * np.abs(plain).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, plain, atol=tol, rtol=0)


def test_3xtf32_product_matches_jax():
    """fp32 x @ fp32 w as the streamed kernel computes it: 3xTF32 (TF32
    emulated by zeroing the low 13 mantissa bits), acc = al bh + ah bl +
    ah bh in fp32; within 1e-5 of the output's scale of JAX's
    streamed_matmul (interpret mode), and inside the source note's error
    budget of 2^-19 of sum |a| |b| per output."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    m, k, n = 64, 512, 96
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    (ah, al), (bh, bl) = _tf32_split(x), _tf32_split(w)
    got = (torch.from_numpy(al) @ torch.from_numpy(bh)
           + torch.from_numpy(ah) @ torch.from_numpy(bl)
           + torch.from_numpy(ah) @ torch.from_numpy(bh)).numpy()
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w),
                                  block_m=64, block_n=96, block_k=128))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    budget = 2.0 ** -19 * (np.abs(x).astype(np.float64) @ np.abs(w)) + (
        k * 2.0 ** -24 * np.abs(exact).max())
    assert np.all(np.abs(got - exact) <= budget)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(128, 4096, 1024), (64, 8192, 512)])
def test_cuda_quant_matmul_k_split(cuda, m, k, n, bits, dtype):
    """The tiled path at shapes whose launch splits K across blocks: the
    plain version's result (fp32 1e-4 of the output's scale, bf16 as
    HALF_RTOL), and the same bits on a second call (the splits are added
    in a fixed order)."""
    from repro_torch.kernels import quant_matmul as qm
    assert qm._plan(m, k, n, bits, None)[0] > 1
    x, w_q, scale = _cuda_quant(cuda, m + k + n + bits, m, k, n, bits)
    x = x.to(dtype)
    got = ops.quant_matmul(x, w_q, scale, bits)
    want = ref.quant_matmul_ref(x, w_q, scale, bits=bits)
    if dtype == torch.float32:
        tol = 1e-4 * want.abs().max().item()
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    else:
        _close(got, want, dtype)
    assert torch.equal(ops.quant_matmul(x, w_q, scale, bits), got)

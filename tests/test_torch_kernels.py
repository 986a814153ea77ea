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
    assert ops.LAUNCHES == {"flash_decode": 0, "flash_attention": 0,
                            "paged_flash_decode": 0,
                            "paged_flash_verify": 0,
                            "quantized_matmul": 0}


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
    q = torch.zeros((1, 1, 1, 64), device=cuda, dtype=torch.bfloat16)
    kc = torch.zeros((1, 8, 1, 64), device=cuda, dtype=torch.bfloat16)
    valid = torch.ones((1, 8), device=cuda, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32"):
        ops.decode_gqa(q, kc, kc, valid)


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

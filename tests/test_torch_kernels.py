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


@pytest.mark.parametrize("dqk,dv,sq,g", [(48, 32, 11, 1), (96, 64, 32, 1),
                                         (96, 64, 40, 2)])
def test_attention_dv_below_dqk_matches_chunked_attention(dqk, dv, sq, g):
    """MLA's prefill heads: q / k wider than v (reduced minicpm3_4b's 48 /
    32 and the full model's 96 / 64) against the reference prefill
    attention."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    rng = np.random.default_rng(dqk + sq)
    b, kv = 2, 3
    q = _rand(rng, (b, sq, kv, g, dqk))
    k, v = _rand(rng, (b, sq, kv, dqk)), _rand(rng, (b, sq, kv, dv))
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, block_q=16, block_k=16)
    got = ops.attention_gqa(_t(q), _t(k), _t(v), causal=True)
    assert tuple(got.shape) == (b, sq, kv, g, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dc,dr,lengths", [(32, 16, [5, 16, 9]),
                                           (256, 32, [40, 1, 33])])
def test_latent_decode_matches_attention_module(dc, dr, lengths):
    """MLA's absorbed decode over the latent cache (key rows [c, kr], value
    rows c, one virtual KV head for every query head) against
    ``repro.models.attention.flash_decode`` over ``concat(c, kr)``, the
    call ``mla_decode`` makes (its jnp path: the Pallas kernel needs K and
    V of one width)."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    rng = np.random.default_rng(dc)
    b, s, g = 3, 40, 5
    q = _rand(rng, (b, 1, g, dc + dr))
    c, kr = _rand(rng, (b, s, dc)), _rand(rng, (b, s, dr))
    valid = np.arange(s)[None] < np.asarray(lengths)[:, None]
    got = ops.decode_latent(_t(q), _t(c), _t(kr), _t(valid))
    assert tuple(got.shape) == (b, 1, g, dc)
    k = np.concatenate([c, kr], -1)[:, :, None]
    for impl in (None, "pallas"):
        want = jattn.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(c[:, :, None]),
                                  jnp.asarray(valid), None, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    ops.decode_latent(torch.zeros((1, 1, 2, 48)), torch.zeros((1, 8, 32)),
                      torch.zeros((1, 8, 16)),
                      torch.ones((1, 8), dtype=torch.bool))
    qa = torch.zeros((1, 4, 1, 2, 32))
    ka = torch.zeros((1, 4, 1, 32))
    out, lse = ops.attention_gqa_lse(qa, ka, ka)
    ops.attention_gqa_bwd(qa, ka, ka, out, lse, torch.ones_like(out))
    ops.quant_matmul_heads(torch.zeros((2, 2, 32)), w8, torch.ones(8), 8, 4)
    assert ops.LAUNCHES == {"flash_decode": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0,
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
    (2, 70, 2, 2, 64, 1, 90, [70, 90]),
    # a speculative serving round at depth 4: W = 5 per row
    (4, 5, 16, 1, 64, 16, 11, [133, 140, 152, 164])])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,sq,h,g", [(1, 32, 40, 1),   # minicpm3_4b prefill
                                      (2, 77, 4, 2), (1, 130, 3, 1)])
def test_cuda_attention_qk96_v64(cuda, dtype, b, sq, h, g):
    """MLA's prefill: q / k rows of 96, v rows of 64, causal."""
    gen = torch.Generator(device=cuda).manual_seed(sq + h)
    q = torch.randn((b, sq, h, g, 96), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, sq, h, 96), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, sq, h, 64), generator=gen, device=cuda).to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.attention_gqa(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert tuple(got.shape) == (b, sq, h, g, 64)
    _close(got, ref.attention_gqa_ref(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,s,g", [(2, 40, 40),     # minicpm3_4b decode
                                   (3, 1000, 40), (2, 37, 1), (4, 200, 12)])
def test_cuda_latent_decode(cuda, dtype, b, s, g):
    """MLA's decode on the latent cache: q (B, 1, G, 288), c (B, S, 256),
    kr (B, S, 32), ragged valid lengths; one launch per call."""
    gen = torch.Generator(device=cuda).manual_seed(s + g)
    q = torch.randn((b, 1, g, 288), generator=gen, device=cuda).to(dtype)
    c = torch.randn((b, s, 256), generator=gen, device=cuda).to(dtype)
    kr = torch.randn((b, s, 32), generator=gen, device=cuda).to(dtype)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=cuda)
    valid = torch.arange(s, device=cuda)[None] < lens[:, None]
    before = ops.LAUNCHES["flash_decode"]
    got = ops.decode_latent(q, c, kr, valid)
    assert ops.LAUNCHES["flash_decode"] == before + 1
    _close(got, ref.decode_latent_ref(q, c, kr, valid), dtype)


def test_cuda_attention_and_latent_decode_refuse_other_widths(cuda):
    q = torch.zeros((1, 8, 2, 1, 96), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        ops.attention_gqa(q, q[:, :, :, 0], q[:, :, :, 0])
    with pytest.raises(ValueError, match="head dims"):
        ops.attention_gqa(torch.zeros((1, 8, 2, 1, 64), device=cuda),
                          torch.zeros((1, 8, 2, 64), device=cuda),
                          torch.zeros((1, 8, 2, 32), device=cuda))
    c = torch.zeros((1, 8, 128), device=cuda)
    valid = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="latent shapes"):
        ops.decode_latent(torch.zeros((1, 1, 4, 160), device=cuda), c,
                          torch.zeros((1, 8, 32), device=cuda), valid)


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


# ---------------------------------------------------------------------------
# The attention bodies (csrc/attn_tiles.cuh): the decode split plan and the
# attention block plan, and the arithmetic of the tensor-core attention and
# of the in-launch split merge, emulated in torch on the CPU; one launch
# per decode call and every block-rows plan on the card.
# ---------------------------------------------------------------------------
@given(st.integers(1, 64), st.integers(1, 64), st.integers(1, 20),
       st.integers(1, 32768), st.sampled_from([32, 64, 80, 128, 256]))
@example(4, 16, 1, 160, 64)        # the dense path's decode batch
@example(1, 1, 1, 32768, 128)      # the split count's cap
@example(4, 16, 1, 72, 256)
@example(64, 1, 1, 512, 64)        # the BH-flat partials
@example(4, 4, 8, 1024, 128)       # GQA, one head group per kv head
@example(1, 1, 1, 1, 64)
@settings(max_examples=200, deadline=None)
def test_decode_split_plan(b, kv, g, s, dh):
    """Every slot is walked once (splits of whole warp tiles, each warp a
    contiguous run); the fewest splits that bring the blocks to
    TARGET_BLOCKS where some whole-tile split count within the caps (split
    count, workspace bytes) does; partials within the cap and the counters
    within their buffer."""
    from repro_torch.kernels import flash_decode as fd
    n_split, chunk = fd.splits(b, kv, g, s, dh)
    unit = fd.WARPS * fd.WARP_TILE
    assert n_split >= 1 and chunk % unit == 0
    kpw = chunk // fd.WARPS
    walked = [key for sp in range(n_split) for w in range(fd.WARPS)
              for key in range(sp * chunk + w * kpw,
                               min(s, sp * chunk + (w + 1) * kpw))]
    assert walked == list(range(s))
    assert (n_split - 1) * chunk < s                 # no empty split
    assert n_split <= fd.MAX_SPLITS
    if n_split > 1:
        assert fd.work_bytes(b, kv, g, dh, n_split) <= fd.MAX_WORK_BYTES
    columns = b * kv * fd.head_groups(g)
    target = -(-fd.TARGET_BLOCKS // columns)
    n_units = -(-s // unit)
    cap = max(1, min(fd.MAX_SPLITS,
                     fd.MAX_WORK_BYTES // fd.work_bytes(b, kv, g, dh)))
    counts = {-(-n_units // per) for per in range(1, n_units + 1)}
    if any(target <= c <= cap for c in counts):
        assert columns * n_split >= fd.TARGET_BLOCKS
        assert n_split == min(c for c in counts if c >= target)
    if n_split > 1:
        work, cnt = fd.workspace(torch.device("cpu"), 0, b, kv, g, dh,
                                 n_split)
        assert work.numel() * 4 >= fd.work_bytes(b, kv, g, dh, n_split)
        assert cnt.numel() >= columns and not cnt.any()


@given(st.integers(1, 4096), st.integers(1, 512))
@example(128, 16)      # the dense path's prefill: 16 rows, 128 blocks
@example(64, 16)       # gpt_j's prefill
@example(197, 32)      # vit_large, 2 x 16 heads: 64 rows, 128 blocks
@example(64, 64)       # the chunked rounds' verify (W = 64, B = 4, KV = 16)
@settings(max_examples=200, deadline=None)
def test_attention_block_plan(rows, columns):
    """Rows per block are 16 or 64 (of the kernel's 16, 32 and 64), the
    blocks cover every query row once, and they reach FILL_BLOCKS (128 of
    the 132 SMs) wherever 16-row blocks do: 64-row blocks when those alone
    fill the card, else 16-row blocks."""
    from repro_torch.kernels import flash_attention as fa
    r = fa.block_rows(rows, columns)
    assert r in (16, 64)
    n = -(-rows // r)
    covered = [i for x in range(n) for i in range(x * r, min(rows,
                                                             (x + 1) * r))]
    assert covered == list(range(rows))
    if -(-rows // 16) * columns >= fa.FILL_BLOCKS:
        assert n * columns >= fa.FILL_BLOCKS
    assert (r == 64) == (-(-rows // 64) * columns >= fa.FILL_BLOCKS)


@given(st.integers(1, 16), st.integers(1, 4096), st.integers(1, 4096),
       st.integers(1, 64), st.sampled_from([1, 2, 4, 6, 8, 40]),
       st.sampled_from([(32, 32), (64, 64), (128, 128), (256, 256),
                        (96, 64)]), st.sampled_from([2, 4]))
@example(1, 32, 32, 4, 8, (128, 128), 2)      # qwen3_moe's prefill
@example(1, 512, 512, 4, 8, (128, 128), 2)    # qwen3_moe, training length
@example(2, 256, 256, 4, 4, (128, 128), 4)    # the windowed GQA case
@example(8, 256, 256, 16, 1, (64, 64), 4)     # gpt2_base's training batch
@example(2, 197, 197, 16, 1, (64, 64), 2)     # vit_large
@settings(max_examples=200, deadline=None)
def test_attention_bwd_plan(b, sq, sk, kv, g, dims, itemsize):
    """The backward's slices: one where the key tiles alone reach the 132
    SMs, else the fewest that do, unless each slice is down to one
    (query head, query tile) step or the fp32 partials reach their cap;
    the slices cut a key tile's steps into runs that cover each step
    once."""
    from repro_torch.kernels import flash_attention_bwd as fab
    slices, blocks = fab.plan(b, sq, sk, kv, g, *dims, itemsize)
    base = -(-sk // fab.key_rows(*dims)) * kv * b
    steps = g * -(-sq // fab.query_rows(*dims, itemsize))
    assert 1 <= slices and blocks == base * slices
    if base >= fab.SMS:
        assert slices == 1
    part = 4 * b * sk * kv * sum(dims)
    if slices > 1:
        assert slices <= steps and slices * part <= fab.MAX_PART_BYTES
        assert (slices - 1) * base < fab.SMS
    if blocks < fab.SMS:
        assert slices == steps or (slices + 1) * part > fab.MAX_PART_BYTES
    for n in range(steps + 1):      # the kernel's runs, at any step count
        runs = [(s * n // slices, (s + 1) * n // slices)
                for s in range(slices)]
        assert runs[0][0] == 0 and runs[-1][1] == n
        assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))
    assert fab.plan(1, 512, 512, 4, 8, 128, 128, 2)[1] >= fab.SMS
    assert fab.plan(2, 197, 197, 16, 1, 64, 64, 2)[1] >= fab.SMS


@given(st.integers(1, 4096), st.integers(1, 4096), st.integers(1, 64))
@example(64, 256, 40)     # minicpm3_4b's W_uv, int8
@example(64, 128, 40)     # int4
@example(64, 256, 4)      # fewer heads: K split across blocks
@settings(max_examples=200, deadline=None)
def test_quant_heads_split_plan(n, rows, heads):
    """The batched skinny launch's K splits cover each head's stored rows
    once with no empty split, reach the 132 SMs where the rows allow, and
    stay one split where the heads' column tiles fill the card; at
    minicpm3_4b's absorbed products (M = 2, 40 heads) every batched launch
    runs at least 132 blocks."""
    from repro_torch.kernels import quant_matmul as qm
    splits, per = qm.head_k_splits(n, rows, heads)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < rows <= splits * per
    tiles = heads * -(-n // qm.HEAD_BLOCK_N)
    if tiles >= qm.SMS:
        assert splits == 1
    elif tiles * rows >= qm.SMS:
        assert tiles * splits >= qm.SMS
    for bits in (8, 4):
        # W_uv (256 -> 64): 16-column blocks of each head, K split where
        # needed; W_uk (64 -> 256): 32 stored rows a block (csrc kTransRows)
        uv = 40 * -(-64 // qm.HEAD_BLOCK_N) * qm.head_k_splits(
            64, qm.stored_rows(256, bits), 40)[0]
        uk = 40 * -(-qm.stored_rows(256, bits) // 32)
        assert uv >= qm.SMS and uk >= qm.SMS


def _attention_emulated(q, k, v, causal, window, p_dtype=None, kw=16,
                        n_kw=4):
    """The tile body's arithmetic on BH-flat fp32 inputs: runs of ``kw``
    keys dealt round-robin to ``n_kw`` key warps, each with its own online
    softmax (masked scores -1e30), merged in key-warp order at the end;
    fp32 inputs as 3xTF32 in both products (ah bh + (ah bl + al bh) for
    the scores), or with ``p_dtype`` P rounded to that type for P V
    (16-bit inputs)."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    scale = 1.0 / dh ** 0.5

    def split(a):
        hi, lo = _tf32_split(a.contiguous().numpy())
        return torch.from_numpy(hi), torch.from_numpy(lo)

    def prod(a, b):             # a @ b as the body computes it
        if p_dtype is not None:
            return a @ b
        (ah, al), (bh_, bl) = split(a), split(b)
        return ah @ bh_ + (ah @ bl + al @ bh_)

    rows = torch.arange(sq)[:, None]
    parts = []
    for w in range(n_kw):
        m = torch.full((bh, sq, 1), -1e30)
        l = torch.zeros((bh, sq, 1))
        o = torch.zeros((bh, sq, dh))
        for k0 in range(w * kw, sk, n_kw * kw):
            keys = torch.arange(k0, min(sk, k0 + kw))[None, :]
            s = prod(q, k[:, k0:k0 + kw].transpose(1, 2)) * scale
            ok = torch.ones_like(keys <= rows)
            if causal:
                ok &= keys <= rows
            if window is not None:
                ok &= keys > rows - window
            s = torch.where(ok, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = p if p_dtype is None else p.to(p_dtype).float()
            o = o * corr + prod(pv, v[:, k0:k0 + kw])
            m = m_new
        parts.append((m, l, o))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(pl * torch.exp(pm - m) for pm, pl, _ in parts)
    o = sum(po * torch.exp(pm - m) for pm, _, po in parts)
    return o / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)],
                         ids=["causal", "non-causal", "window"])
def test_3xtf32_attention_matches_jax(causal, window):
    """fp32 attention as the tensor-core body computes it (3xTF32 in both
    products, an online softmax per key warp, key warps merged) within 1e-5 of the output's scale
    of JAX's Pallas flash_attention (interpret mode) and of
    ref.attention_gqa_ref."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(23)
    s, dh = 160, 64
    q, k, v = (_rand(rng, (2, s, dh)) for _ in range(3))
    got = _attention_emulated(_t(q), _t(k), _t(v), causal, window).numpy()
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, block_q=32, block_k=32))
    plain = ref.attention_gqa_ref(_t(q)[:, :, None, None], _t(k)[:, :, None],
                                  _t(v)[:, :, None], causal=causal,
                                  window=window)[:, :, 0, 0].numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, plain, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_attention_p_rounding_matches_jax(dtype):
    """fp16 / bf16 attention as the body computes it (fp32 scores from the
    16-bit inputs, P rounded to the input type for P V) within HALF_RTOL
    of the output's scale of the Pallas kernel in interpret mode at that
    type."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(29)
    s, dh = 128, 64
    q, k, v = (torch.from_numpy(_rand(rng, (2, s, dh))).to(tdt)
               for _ in range(3))
    got = _attention_emulated(q.float(), k.float(), v.float(), True, None,
                              p_dtype=tdt).to(tdt)
    jd = getattr(jnp, dtype)
    want = jops.attention(*(jnp.asarray(x.float().numpy()).astype(jd)
                            for x in (q, k, v)), causal=True, block_q=64,
                          block_k=64)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tol = HALF_RTOL[tdt] * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


def test_decode_split_merge_matches_jax():
    """Decode as the one-launch body computes it: fp32 partials of each
    warp's contiguous run of each split (``flash_decode.splits``), merged
    warp by warp and then split by split in order, within 1e-6 of JAX's
    Pallas flash_decode (interpret mode), normalised and unnormalised."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.kernels import flash_decode as fd
    rng = np.random.default_rng(31)
    bh, s, dh = 8, 256, 64
    q, k, v = _rand(rng, (bh, dh)), _rand(rng, (bh, s, dh)), _rand(rng, (bh, s, dh))
    valid = np.arange(s)[None] < rng.integers(1, s + 1, (bh, 1))
    valid[0, :] = False                      # a row with every key masked
    n_split, chunk = fd.splits(bh, 1, 1, s, dh)
    assert n_split > 1
    kpw = chunk // fd.WARPS

    def partial(lo, hi):
        if lo >= hi:                         # no key: weighs exactly 0
            return (torch.zeros(bh, dh), torch.full((bh,), -1e30),
                    torch.zeros(bh))
        o, m, l = ref.decode_partial_ref(_t(q), _t(k[:, lo:hi]),
                                         _t(v[:, lo:hi]),
                                         _t(valid[:, lo:hi]))
        return o, m[:, 0], l[:, 0]

    def merge(parts):                        # in order, as the kernel does
        m = torch.stack([p[1] for p in parts]).amax(0)
        l = torch.zeros(bh)
        o = torch.zeros(bh, dh)
        for po, pm, pl in parts:
            c = torch.exp(pm - m)
            l = l + pl * c
            o = o + po * c[:, None]
        return o, m, l

    splits = [merge([partial(sp * chunk + w * kpw,
                             min(s, sp * chunk + (w + 1) * kpw))
                     for w in range(fd.WARPS)]) for sp in range(n_split)]
    o, m, l = merge(splits)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(valid))
    want = np.asarray(jops.decode(*args, block_k=64))
    np.testing.assert_allclose((o / l[:, None]).numpy(), want, atol=1e-6,
                               rtol=1e-6)
    wo, wm, wl = (np.asarray(x) for x in jops.decode_partial(*args,
                                                             block_k=64))
    np.testing.assert_allclose(m.numpy(), wm[:, 0], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose((o / l[:, None]).numpy(), wo / wl, atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalize", "partial"])
def test_cuda_decode_one_launch(cuda, normalize):
    """At the dense path's decode shape (split across blocks) a call is
    one kernel, normalised or not, and two calls give the same bits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_decode as fd
    b, s, kv, g, dh = 4, 160, 16, 1, 64
    assert fd.splits(b, kv, g, s, dh)[0] > 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((b, kv, g, dh), generator=gen, device=cuda)
    k = torch.randn((b, s, kv, dh), generator=gen, device=cuda)
    v = torch.randn((b, s, kv, dh), generator=gen, device=cuda)
    valid = torch.arange(s, device=cuda)[None] < torch.tensor(
        [[160], [1], [77], [129]], device=cuda)
    run = lambda: fd.flash_decode_gqa(q, k, v, valid,  # noqa: E731
                                      normalize=normalize)
    first = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            second = run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert 1 <= len(kernels) <= 10
    assert len({e.name for e in kernels}) == 1
    outs = (first,) if normalize else first
    for a, b_ in zip(outs, (second,) if normalize else second):
        assert torch.equal(a, b_)
    want = (ref.decode_gqa_ref(q, k, v, valid) if normalize
            else ref.decode_gqa_partial_ref(q, k, v, valid))
    if normalize:
        torch.testing.assert_close(first, want, atol=1e-4, rtol=1e-4)
    else:
        (o, m, l), (ro, rm, rl) = first, want
        torch.testing.assert_close(o / l[..., None], ro / rl[..., None],
                                   atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,sq,kv,g,dh,window,rows", [
    (1, 128, 16, 1, 64, None, 16),        # the dense path's prefill
    (2, 197, 16, 1, 64, None, 64),        # vit_large's shape
    (2, 512, 8, 2, 64, None, 64),
    (1, 300, 4, 2, 128, 64, 16),
    (2, 300, 8, 1, 256, None, 16),
    (4, 512, 8, 1, 256, 100, 64)])
def test_cuda_attention_block_rows(cuda, b, sq, kv, g, dh, window, rows):
    """The plan's 16 and 64 query rows per block (a 16-row block's four
    warps split each key tile), each against the plain version in fp32 at
    the 1e-4 tolerance."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.block_rows(sq, b * kv * g) == rows
    gen = torch.Generator(device=cuda).manual_seed(sq + rows)
    q = torch.randn((b, sq, kv, g, dh), generator=gen, device=cuda)
    k = torch.randn((b, sq, kv, dh), generator=gen, device=cuda)
    v = torch.randn((b, sq, kv, dh), generator=gen, device=cuda)
    got = ops.attention_gqa(q, k, v, causal=True, window=window)
    want = ref.attention_gqa_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sq,sk,kv,g,dqk,dv,causal,window,dtype", [
    (128, 128, 4, 1, 64, 64, True, None, torch.float32),
    (77, 77, 2, 3, 128, 128, True, 32, torch.float32),
    (40, 40, 2, 1, 96, 64, True, None, torch.float32),
    (50, 50, 1, 2, 256, 256, False, None, torch.float32),
    (64, 64, 2, 2, 32, 32, True, None, torch.float16),
    (64, 64, 3, 1, 96, 64, True, None, torch.bfloat16),
    (32, 32, 4, 8, 128, 128, True, None, torch.float16),    # qwen3_moe
    (77, 77, 2, 2, 64, 64, True, None, torch.float16),      # ragged tiles
    (45, 109, 2, 4, 64, 64, True, 40, torch.float32),       # q_offset 64
    (40, 72, 1, 3, 256, 256, True, None, torch.bfloat16),   # q_offset 32
    (200, 200, 4, 6, 128, 128, False, None, torch.bfloat16)])
def test_cuda_attention_bwd_matches_plain(cuda, sq, sk, kv, g, dqk, dv,
                                          causal, window, dtype):
    """The forward's lse output and the backward kernel's (dq, dk, dv)
    against ``attention_gqa_lse_ref`` / ``attention_gqa_bwd_ref`` on the
    same saved tensors, the queries the last Sq of Sk positions (q_offset
    Sk - Sq): fp32 within 1e-4, fp16 / bf16 within 2e-3 / 1.6e-2 of each
    gradient's largest magnitude.  dq's atomics add in no fixed order, so
    its bits may vary from call to call within these tolerances."""
    gen = torch.Generator(device=cuda).manual_seed(sq + dqk)
    q = torch.randn((2, sq, kv, g, dqk), generator=gen, device=cuda)
    k = torch.randn((2, sk, kv, dqk), generator=gen, device=cuda)
    v = torch.randn((2, sk, kv, dv), generator=gen, device=cuda)
    d_out = torch.randn((2, sq, kv, g, dv), generator=gen, device=cuda)
    q, k, v, d_out = (t.to(dtype) for t in (q, k, v, d_out))
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    before = dict(ops.LAUNCHES)
    out, lse = ops.attention_gqa_lse(q, k, v, **kw)
    grads = ops.attention_gqa_bwd(q, k, v, out, lse, d_out, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert (ops.LAUNCHES["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    _, want_lse = ref.attention_gqa_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    want = ref.attention_gqa_bwd_ref(q, k, v, out, lse, d_out, **kw)
    rtol = {torch.float32: 1e-4, torch.float16: 2e-3,
            torch.bfloat16: 1.6e-2}[dtype]
    for got, w in zip(grads, want):
        assert got.dtype == dtype
        lim = rtol * w.float().abs().max().item() if dtype != torch.float32 \
            else 1e-4
        assert (got.float() - w.float()).abs().max().item() <= lim


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_cuda_attention_bwd_repeats(cuda, dtype):
    """Two back-to-back calls on the same inputs at a grid that slices each
    key tile's steps (qwen3_moe's 8 heads on 4 KV heads at 512 tokens): dk
    and dv are the same bits (the slices' partials summed in order) and dq
    differs at most by the atomics' order, within the stated tolerance of
    the plain version's largest magnitude (fp32 1e-4; fp16 2e-3)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    b, s, kv, g, dh = 1, 512, 4, 8, 128
    assert fab.plan(b, s, s, kv, g, dh, dh, dtype.itemsize)[0] > 1
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((b, s, kv, g, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, s, kv, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, s, kv, dh), generator=gen, device=cuda).to(dtype)
    d_out = torch.randn((b, s, kv, g, dh), generator=gen,
                        device=cuda).to(dtype)
    out, lse = ops.attention_gqa_lse(q, k, v)
    first = ops.attention_gqa_bwd(q, k, v, out, lse, d_out)
    second = ops.attention_gqa_bwd(q, k, v, out, lse, d_out)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    want = ref.attention_gqa_bwd_ref(q, k, v, out, lse, d_out)[0].float()
    lim = 1e-4 if dtype == torch.float32 else 2e-3 * want.abs().max().item()
    assert (first[0].float() - second[0].float()).abs().max().item() <= lim
    for got in (first[0], second[0]):
        assert (got.float() - want).abs().max().item() <= lim


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [2, 5, 1, 3, 4])
def test_cuda_quant_matmul_heads_matches_plain(cuda, m, bits, trans):
    """MLA's absorbed products at minicpm3_4b's widths (40 heads, latent
    256, head 64), one launch for all heads, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(m * bits)
    h, k, n = (40, 64, 256) if trans else (40, 256, 64)
    rows = (n if trans else k) if bits == 8 else -(-(n if trans else k) // 2)
    cols = h * (k if trans else n)
    if bits == 8:
        w_q = torch.randint(-127, 128, (rows, cols), generator=gen,
                            device=cuda, dtype=torch.int8)
    else:
        w_q = torch.randint(0, 256, (rows, cols), generator=gen, device=cuda,
                            dtype=torch.uint8)
    scale = torch.rand((cols,), generator=gen, device=cuda) / 64
    x = torch.randn((m, h, k), generator=gen, device=cuda)
    before = ops.LAUNCHES["quantized_matmul"]
    got = ops.quant_matmul_heads(x, w_q, scale, bits, n, trans)
    assert ops.LAUNCHES["quantized_matmul"] == before + 1
    want = ref.quant_matmul_batched_ref(x, w_q, scale, n, bits=bits,
                                        trans=trans)
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(),
                               rtol=0)


@pytest.mark.parametrize("m,bits,trans,h,k,n", [
    (3, 4, False, 40, 255, 64),    # odd K: the padding nibble meets x = 0
    (2, 8, False, 8, 200, 48),
    (2, 4, False, 6, 256, 40),     # N % 16 != 0: byte-wise weight reads
    (5, 4, False, 4, 129, 64),
    (1, 4, True, 40, 64, 255),     # odd N, packed along N
    (4, 8, True, 8, 40, 72),       # K % 16 != 0: byte-wise row reads
    (5, 8, True, 4, 96, 33)])
def test_cuda_quant_matmul_heads_ragged(cuda, m, bits, trans, h, k, n):
    """The batched products at widths the absorption never uses (odd K for
    int4, N and K off the 16-byte vectors, M past the skinny rows) against
    the plain version, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    logical = n if trans else k
    rows = logical if bits == 8 else -(-logical // 2)
    cols = h * (k if trans else n)
    if bits == 8:
        w_q = torch.randint(-127, 128, (rows, cols), generator=gen,
                            device=cuda, dtype=torch.int8)
    else:
        w_q = torch.randint(0, 256, (rows, cols), generator=gen, device=cuda,
                            dtype=torch.uint8)
    scale = torch.rand((cols,), generator=gen, device=cuda) / 64
    x = torch.randn((m, h, k), generator=gen, device=cuda)
    before = ops.LAUNCHES["quantized_matmul"]
    got = ops.quant_matmul_heads(x, w_q, scale, bits, n, trans)
    assert ops.LAUNCHES["quantized_matmul"] == before + 1
    want = ref.quant_matmul_batched_ref(x, w_q, scale, n, bits=bits,
                                        trans=trans)
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(),
                               rtol=0)

"""The port's paged-KV bookkeeping and paged attention against the JAX
package's: PagePool / PrefixTree / BlockTable op sequences, the paged
decode and verify plain versions against the Pallas kernels (interpret
mode), and the engine's page-granular single-request generation.

The CUDA kernels themselves are held against the plain versions by the
``cuda`` cases in ``tests/test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import PipeloadEngine as JaxEngine
from repro.core import kv_pages as jkv
from repro.core.engine import _Ledger as JaxLedger
from repro.kernels import ops as jops
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import PipeloadEngine
from repro_torch.core import kv_pages as tkv
from repro_torch.core.engine import _Ledger
from repro_torch.kernels import ops, ref

# reduced gpt2_base, as tests/test_kv_pages.py cuts it
GEOM = dict(num_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=300, vocab_pad_to=4, remat=False)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def gpt2s(tmp_path_factory):
    jcfg = get_config("gpt2_base").with_(**GEOM)
    tcfg = torch_get("gpt2_base").with_(**GEOM)
    path = tmp_path_factory.mktemp("ckpt") / "gpt2s"
    partition_and_save(jax_init(jax.random.PRNGKey(0), jcfg), jcfg, path)
    return jcfg, tcfg, path


# ---------------------------------------------------------------------------
# bookkeeping: the same op sequence through both packages
# ---------------------------------------------------------------------------
class _Side:
    """One package's pool + prefix tree + live tables, driven by ops."""

    def __init__(self, mod, ledger, page_size):
        self.mod = mod
        self.ledger = ledger
        self.pool = mod.PagePool(page_size, 10, ledger)
        self.spaces = mod.PrefixNamespaces(page_size)
        self.tree = self.spaces.tree("default")
        self.live = {}

    def apply(self, op, key, arg):
        if op == "admit":
            self.live[key] = self.mod.BlockTable(
                *self.tree.insert(arg, self.pool))
        elif op == "grow":
            self.live[key].pages.append(self.pool.alloc())
        elif op == "cow":
            t = self.live[key]
            return t.cow(arg % len(t.pages), self.pool) if t.pages else None
        elif op == "branch":                 # arg: the branch's own key
            self.live[arg] = self.live[key].branch(self.pool)
        elif op == "rollback":
            return self.live[key].rollback(self.pool, arg, self.tree)
        elif op == "retire":
            return self.live.pop(key).release_all(self.pool, self.tree)
        return None

    def state(self):
        p = self.pool
        return dict(
            tables={str(k): (list(t.pages), t.n_shared)
                    for k, t in self.live.items()},
            refs={pid: p.refcount(pid) for t in self.live.values()
                  for pid in t.pages},
            resident=self.ledger.resident, peak=self.ledger.peak,
            mapped=p.mapped_pages, capacity=p.capacity,
            mapped_peak=p.mapped_peak, stats=vars(p.stats).copy(),
            hits=self.spaces.hits, misses=self.spaces.misses)


def _ops_sequence(rng, n_ops):
    seq, keys = [], []
    for step in range(n_ops):
        op = ["admit", "grow", "cow", "branch", "rollback",
              "retire"][int(rng.integers(0, 6))]
        if op == "admit" or not keys:
            toks = rng.integers(0, 3, int(rng.integers(1, 10))).tolist()
            seq.append(("admit", step, toks))
            keys.append(step)
            continue
        key = keys[int(rng.integers(0, len(keys)))]
        if op == "retire":
            keys.remove(key)
        if op == "branch":
            keys.append(step)
            seq.append((op, key, step))
            continue
        seq.append((op, key, int(rng.integers(0, 4))))
    return seq


@pytest.mark.parametrize("seed,page_size", [(0, 1), (1, 2), (2, 4), (3, 5)])
def test_bookkeeping_matches_jax(seed, page_size):
    """Identical page ids, refcounts, ledger bytes and tree hits after
    every op of a random admit / grow / COW / branch / rollback / retire
    sequence; both drain to zero."""
    rng = np.random.default_rng(seed)
    jside = _Side(jkv, JaxLedger(None), page_size)
    tside = _Side(tkv, _Ledger(None), page_size)
    for op, key, arg in _ops_sequence(rng, 60):
        if op != "admit" and key not in tside.live:
            continue
        assert tside.apply(op, key, arg) == jside.apply(op, key, arg)
        assert tside.state() == jside.state()
    for side in (jside, tside):
        for t in list(side.live.values()):
            t.release_all(side.pool, side.tree)
    assert tside.pool.mapped_pages == jside.pool.mapped_pages == 0
    assert tside.ledger.resident == 0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("page_size", [1, 2, 4])
def test_pool_interleaving_property(seed, page_size):
    """Any alloc/share/free interleaving keeps the ledger exact, drains to
    zero, and the pool's capacity is its high-water mark of mapped pages
    (sampled after every op)."""
    rng = np.random.default_rng(seed)
    n_reqs = int(rng.integers(1, 7))
    led = _Ledger(None)
    pool = tkv.PagePool(page_size, 10, led)
    tree = tkv.PrefixTree(page_size)
    live = {}
    hw = 0
    for step in range(40):
        op = rng.integers(0, 3)
        if op == 0 and len(live) < n_reqs:             # admit
            toks = rng.integers(0, 3, rng.integers(1, 10)).tolist()
            live[step] = tkv.BlockTable(*tree.insert(toks, pool))
        elif op == 1 and live:                          # grow one page
            t = live[rng.choice(list(live))]
            t.pages.append(pool.alloc())
        elif op == 2 and live:                          # retire
            k = rng.choice(list(live))
            live.pop(k).release_all(pool, tree)
        hw = max(hw, pool.mapped_pages)
        assert led.resident == pool.mapped_bytes       # ledger exact
        assert pool.capacity == hw                     # high-water
    for t in list(live.values()):
        t.release_all(pool, tree)
    assert pool.mapped_pages == 0 and led.resident == 0  # exact drain
    assert pool.capacity == hw


def test_pages_for_and_pool_errors():
    for tokens, ps in [(0, 4), (1, 4), (4, 4), (5, 4), (17, 5)]:
        assert tkv.pages_for(tokens, ps) == jkv.pages_for(tokens, ps)
    pool = tkv.PagePool(4, 1)
    with pytest.raises(KeyError):
        pool.release(0)
    with pytest.raises(KeyError):
        pool.share(7)
    with pytest.raises(ValueError):
        tkv.PagePool(0, 1)


# ---------------------------------------------------------------------------
# plain paged decode / verify vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
PAGES = [(1, 7), (2, 5), (4, 3), (5, 4), (8, 4), (16, 2), (64, 2)]


def _paged_inputs(page, nb, w, min_len=1, seed=0):
    rng = np.random.default_rng(seed * 1000 + page * 10 + nb)
    b, kv, g, dh, n_pages = 3, 2, 2, 32, 2 * nb + 3
    kp = rng.standard_normal((n_pages, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kv, dh)).astype(np.float32)
    shape = (b, kv, g, dh) if w is None else (b, w, kv, g, dh)
    q = rng.standard_normal(shape).astype(np.float32)
    tables = rng.integers(0, n_pages, (b, nb)).astype(np.int32)
    lengths = rng.integers(min_len, nb * page + 1, (b,)).astype(np.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("page,nb", PAGES)
def test_paged_decode_matches_pallas_interpret(page, nb):
    args = _paged_inputs(page, nb, None)
    want = jops.paged_decode(*(jnp.asarray(a) for a in args))
    got = ops.paged_decode(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("w", [1, 3, 16])
@pytest.mark.parametrize("page,nb", PAGES)
def test_paged_verify_matches_pallas_interpret(page, nb, w):
    # the table must hold the W stacked queries' slots
    args = _paged_inputs(page, max(nb, -(-w // page)), w, min_len=w)
    want = jops.paged_verify(*(jnp.asarray(a) for a in args))
    got = ops.paged_verify(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("page,nb", [(1, 7), (5, 4), (16, 2)])
def test_paged_verify_w1_equals_decode(page, nb):
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in
                                  _paged_inputs(page, nb, 1))
    got = ref.paged_verify_ref(q, kp, vp, tables, lengths)[:, 0]
    want = ref.paged_decode_ref(q[:, 0], kp, vp, tables, lengths)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# engine: page-granular single-request generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page_size", [2, 5])
def test_engine_paged_generate_matches_jax(gpt2s, page_size):
    """Same tokens as the reference and as the port's dense run, and the
    reference's page-granular ledger peak to the byte, with the same
    per-page cache_reserve events.  The budget is the decode floor for
    the final pages (15 slots cover 14 tokens at both page sizes): one
    streaming layer at a time, so the peak does not depend on how far
    the loaders run ahead."""
    jcfg, tcfg, path = gpt2s
    man = load_manifest(path)
    layer_b = man["layer_bytes"] // jcfg.num_layers
    other = man["total_bytes"] - man["layer_bytes"]
    budget = other + jcfg.num_layers * jcfg.cache_bytes(1, 15) + layer_b
    assert jcfg.num_layers * jcfg.cache_bytes(1, 15) < layer_b
    p = np.random.default_rng(9).integers(0, 300, (1, 6))
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget,
              page_size=page_size)
    with JaxEngine(path, jcfg, **kw) as je:
        jout, jst = je.run_generate(p, 8, kv_cache=True)
    with PipeloadEngine(path, tcfg, device="cpu", **kw) as te:
        tout, tst = te.run_generate(p, 8, kv_cache=True)
    kw["page_size"] = None
    with PipeloadEngine(path, tcfg, device="cpu", **kw) as te:
        dout, _ = te.run_generate(p, 8, kv_cache=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tout.numpy(), dout.numpy())
    assert tst.peak_bytes == jst.peak_bytes
    assert tst.cache_bytes == jst.cache_bytes
    assert tst.peak_breakdown == jst.peak_breakdown
    reserves = [[e[1:] for e in st.event_log(["cache_reserve"])]
                for st in (tst, jst)]
    assert reserves[0] == reserves[1] and len(reserves[0]) > 1


def test_engine_paged_budget_floor_still_enforced(gpt2s):
    _, tcfg, path = gpt2s
    man = load_manifest(path)
    layer_b = man["layer_bytes"] // tcfg.num_layers
    other = man["total_bytes"] - man["layer_bytes"]
    with PipeloadEngine(path, tcfg, mode="pipeload", num_agents=2,
                        budget_bytes=other + layer_b, page_size=4,
                        device="cpu") as te:
        with pytest.raises(ValueError, match="KV decode floor"):
            te.run_generate(np.arange(6)[None], 4, kv_cache=True)

"""Hermes framework facade (paper §IV): Layer Profiler -> Pipeline Planner
-> Execution Engine, wired together.  PyTorch port of
``repro/core/hermes.py``.

    hermes = Hermes(ckpt_dir, cfg, device="cuda")
    profile = hermes.profile()                  # §IV-1
    schedule = hermes.plan([b1, b2, None])      # §IV-2
    sched = hermes.scheduler(budget_bytes=b1)   # continuous batching
    h8 = hermes.quantized("int8")               # sibling int8 checkpoint
    g = hermes.plan_generate([b1], quants=("fp32", "int8", "int4"))[0]
    engine = hermes.quantized(g.dtype).engine(...)   # g.dtype = winner
    sel = hermes.autotune(page_size=16)         # kernel tiles / routes
    spec = hermes.scheduler(budget_bytes=b1, page_sizes=(16,),
                            draft=DraftModel(draft_dir, draft_cfg),
                            spec_depth=4)       # speculative serving
    tier = hermes.scheduler(budget_bytes=b1, page_sizes=(16,),
                            slo_ttft_s=2.0)     # SLO in plan rounds
    stats = hermes.execute(tokens, generate=32, kv_cache=True,
                           budget_bytes=b1)     # §IV-3, the planned run

The profile is cached in the checkpoint directory as
``profile_torch_<device>.json``, so it never collides with the JAX
package's ``profile.json`` for the same checkpoint, nor with another
device's timings.

Budgets given to the facade are device budgets: on the card the planner
and the engine's ledger take ``ledger_budget(b)``, the budget less the
cuBLAS workspace PyTorch keeps beside the ledger (the reference's budget
is the ledger's; on the CPU the two are equal).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.checkpoint.partition import ensure_quantized
from repro_torch.core.engine import (DraftModel, PipeloadEngine, RunStats,
                                     blas_workspace_bytes, resolve_device)
from repro_torch.core.planner import (GenPlanEntry, PlanEntry, plan,
                                      plan_generate)
from repro_torch.core.profiler import (load_profile, profile_model,
                                       save_profile)
from repro_torch.models.config import ModelConfig

# planner label for "no quantization: stream shards at the ckpt dtype"
FP_LABEL = "fp32"


def spec_plan_kw(draft: DraftModel, spec_depth: Optional[int],
                 total_len: int, acceptance: float = 0.8) -> Dict:
    """``plan_generate``'s speculative keywords for ``draft``: a fixed
    ``spec_depth`` is searched beside plain decoding, none searches {1,
    2, 4}, at the modelled ``acceptance``.  Each request's draft cache
    row spans ``total_len`` plus the deepest window."""
    depths = (spec_depth,) if spec_depth else (1, 2, 4)
    return dict(spec_depths=depths,
                spec_draft=dict(bytes=draft.total_bytes,
                                cache_bytes=draft.cache_bytes(
                                    1, total_len + max(depths)),
                                acceptance=acceptance))


class Hermes:
    def __init__(self, ckpt_dir, cfg: ModelConfig, *, device="cuda"):
        self.dir = Path(ckpt_dir)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._profile: Optional[Dict] = None
        self._variants: Dict[str, "Hermes"] = {}

    # ---- Telemetry (core/telemetry.py) ---------------------------------
    def telemetry(self):
        """The process-wide telemetry handle: ``.enable()`` turns on span
        tracing across every PIPELOAD subsystem, ``.metrics`` is the
        always-on registry, ``.export_chrome_trace(path)`` writes a
        Perfetto-loadable timeline of the runs since ``enable()``."""
        from repro_torch.core.telemetry import telemetry
        return telemetry()

    # ---- Layer Profiler ------------------------------------------------
    def profile_path(self) -> Path:
        return self.dir / f"profile_torch_{self.device.type}.json"

    def profile(self, *, batch: int = 1, seq: int = 128,
                force: bool = False) -> Dict:
        cache = self.profile_path()
        if not force and self._profile is not None:
            return self._profile
        if not force and cache.exists():
            self._profile = load_profile(cache)
            return self._profile
        self._profile = profile_model(self.dir, self.cfg, batch=batch,
                                      seq=seq, device=self.device)
        save_profile(self._profile, cache)
        return self._profile

    # ---- Kernel autotune (kernels/autotune.py) -------------------------
    def autotune(self, *, page_size: Optional[int] = None,
                 quant: Optional[str] = None, tokens: int = 256,
                 force: bool = False, cache_path=None) -> Dict:
        """Per-device kernel tile / route selection, seeded by this
        checkpoint's (or its ``quant`` variant's) Layer Profiler run and
        cached to disk (repeat runs skip the timing sweep).  Applies the
        winners as the kernel wrappers' process-wide defaults and returns
        them."""
        from repro_torch.kernels.autotune import tune_for_model
        host = self.quantized(quant) if quant else self
        return tune_for_model(self.cfg, host.profile(),
                              page_size=page_size, quant=quant,
                              tokens=tokens, force=force,
                              cache_path=cache_path, device=self.device)

    # ---- Quantized checkpoint variants ---------------------------------
    def quantized(self, quant: Optional[str]) -> "Hermes":
        """Hermes over the ``quant`` variant of this checkpoint.  The
        sibling directory ``<dir>-<quant>`` is transcoded once and reused,
        with its own cached profile, and transcoded again if the source
        changed underneath it (``checkpoint.ensure_quantized``)."""
        if quant in (None, FP_LABEL):
            return self
        if quant not in self._variants:
            dst = self.dir.parent / f"{self.dir.name}-{quant}"
            ensure_quantized(self.dir, dst, quant)
            self._variants[quant] = Hermes(dst, self.cfg,
                                           device=self.device)
        return self._variants[quant]

    def _profiles(self, quants: Optional[Sequence[Optional[str]]]):
        """The profile argument the planner takes: one profile, or
        ``{dtype: profile}`` (one Layer Profiler run per shard dtype, each
        on its own checkpoint variant, all at the profiler's default
        shape) when a dtype search was asked for."""
        if quants is None:
            return self.profile()
        labels = [q or FP_LABEL for q in quants]
        return {lb: self.quantized(lb).profile() for lb in labels}

    # ---- Pipeline Planner ----------------------------------------------
    def ledger_budget(self, budget: Optional[int]) -> Optional[int]:
        """The ledger's share of a device budget: ``budget`` less the
        BLAS workspace the process holds beside the ledger on this device
        (``engine.blas_workspace_bytes``; 0 on the CPU).  The planner and
        the engine both take it, so weights, caches and the draft never
        fill the bytes cuBLAS keeps."""
        if budget is None:
            return None
        return budget - blas_workspace_bytes(self.device)

    def plan(self, budgets: List[Optional[int]],
             max_agents: Optional[int] = None,
             quants: Optional[Sequence[Optional[str]]] = None
             ) -> List[PlanEntry]:
        return plan(self._profiles(quants),
                    [self.ledger_budget(b) for b in budgets], max_agents)

    def best_agents(self, budget_bytes: Optional[int]) -> int:
        return self.plan([budget_bytes])[0].num_agents

    def plan_generate(self, budgets: List[Optional[int]], *,
                      batch: int = 1, prompt_len: int = 128,
                      new_tokens: int = 32,
                      max_agents: Optional[int] = None,
                      max_pin: Optional[int] = None,
                      max_inflight: int = 1,
                      quants: Optional[Sequence[Optional[str]]] = None,
                      page_sizes: Sequence[int] = (),
                      shared_prefix_len: int = 0,
                      spec_depths: Sequence[int] = (),
                      spec_draft: Optional[Dict] = None,
                      slo_ttft_s: Optional[float] = None,
                      slo_tpot_s: Optional[float] = None,
                      chunk_prefill: int = 0) -> List[GenPlanEntry]:
        """Generation-aware schedule: joint (num_agents, pin_window) with
        KV-cache bytes charged against the budget; ``max_inflight > 1``
        also searches the continuous-batching in-flight count,
        ``page_sizes`` the paged KV reservations (``shared_prefix_len``
        leading prompt tokens shared across requests are charged once),
        ``spec_depths`` + ``spec_draft`` the speculative verify depths (a
        pinned draft's bytes, cache row and acceptance rate; see
        ``planner.plan_generate``), ``slo_ttft_s`` / ``slo_tpot_s`` gate the
        capacity-first search on predicted TTFT / TPOT, and
        ``chunk_prefill`` models chunk-joined prefill rounds;
        ``quants`` widens the search over shard dtype (KV pages keep the
        model dtype, so the cache bytes are shared)."""
        cb = self.cfg.cache_bytes(batch, prompt_len + new_tokens)
        return plan_generate(self._profiles(quants),
                             [self.ledger_budget(b) for b in budgets],
                             new_tokens=new_tokens,
                             cache_bytes_per_layer=cb, max_agents=max_agents,
                             max_pin=max_pin, max_inflight=max_inflight,
                             page_sizes=tuple(page_sizes),
                             total_len=prompt_len + new_tokens,
                             shared_prefix_len=shared_prefix_len,
                             spec_depths=tuple(spec_depths),
                             spec_draft=spec_draft,
                             slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
                             chunk_prefill=chunk_prefill)

    # ---- Execution Engine ----------------------------------------------
    def engine(self, *, mode: str = "pipeload",
               budget_bytes: Optional[int] = None,
               num_agents: Optional[int] = None,
               pin_window: int = 0,
               attn_impl: Optional[str] = "auto",
               expert_cache_bytes: Optional[int] = None,
               page_size: Optional[int] = None) -> PipeloadEngine:
        if num_agents is None and mode == "pipeload":
            num_agents = self.best_agents(budget_bytes)
        return PipeloadEngine(self.dir, self.cfg, mode=mode,
                              num_agents=num_agents or 1,
                              budget_bytes=self.ledger_budget(budget_bytes),
                              pin_window=pin_window, attn_impl=attn_impl,
                              expert_cache_bytes=expert_cache_bytes,
                              page_size=page_size, device=self.device)

    def scheduler(self, *, budget_bytes: Optional[int] = None,
                  max_inflight: int = 4, prompt_len: int = 128,
                  new_tokens: int = 32,
                  num_agents: Optional[int] = None,
                  pin_window: Optional[int] = None,
                  max_total_len: Optional[int] = None,
                  page_sizes: Sequence[int] = (),
                  shared_prefix_len: int = 0,
                  prefix_cache: bool = True,
                  seed: Optional[int] = None,
                  chunk_prefill: int = 0,
                  attn_impl: Optional[str] = "auto",
                  quants: Optional[Sequence[Optional[str]]] = None,
                  autotune: bool = False,
                  draft: Optional[DraftModel] = None,
                  spec_depth: Optional[int] = None,
                  draft_acceptance: float = 0.8,
                  slo=None,
                  slo_ttft_s: Optional[float] = None,
                  slo_tpot_s: Optional[float] = None):
        """Continuous-batching serving facade: plan the (num_agents,
        pin_window, inflight) triple for the budget, build the engine and
        wrap it in a ``BatchScheduler`` ready for ``submit()``/``run()``.
        ``prompt_len``/``new_tokens`` describe the typical request.
        ``page_sizes`` widens the plan over paged KV reservations
        (``shared_prefix_len`` models the workload's common prompt
        prefix, ``prefix_cache`` turns its sharing on) and the engine and
        scheduler take the winning page size; ``chunk_prefill`` (needs
        ``page_sizes``) joins long prompts into decode rounds; ``quants``
        widens the plan over shard dtype and the engine is built on the
        winning checkpoint variant; ``autotune`` tunes the kernels for the
        winning (dtype, page size) after planning (``Hermes.autotune``).
        A ``draft`` (a ``DraftModel`` on this device) adds the
        SPECULATIVE dimension: ``spec_depth`` fixes the verify depth
        (None searches {1, 2, 4}) jointly at the modelled
        ``draft_acceptance``, and the winning depth, 0 when speculation
        does not pay at this budget, drives the scheduler's
        draft-and-verify rounds.  ``slo`` (a rounds-based
        ``scheduler.SLO``) arms the serving tier's accounting and shedding;
        ``slo_ttft_s`` / ``slo_tpot_s`` gate the planner's search, and when
        only they are given, the winning schedule's predicted round
        latency turns them into the rounds-based ``SLO``."""
        from repro_torch.core.scheduler import SLO, BatchScheduler
        if chunk_prefill and draft is not None:
            raise ValueError("chunk_prefill is incompatible with a draft "
                             "model (speculative rounds own the verify "
                             "window)")
        if chunk_prefill and not page_sizes:
            raise ValueError("chunk_prefill requires page_sizes (chunk "
                             "rounds write through the paged KV kernel)")
        spec_kw = ({} if draft is None else spec_plan_kw(
            draft, spec_depth, max_total_len or prompt_len + new_tokens,
            draft_acceptance))
        g = self.plan_generate([budget_bytes], prompt_len=prompt_len,
                               new_tokens=new_tokens,
                               max_inflight=max_inflight, quants=quants,
                               page_sizes=page_sizes,
                               # sharing off -> every page is private; the
                               # plan must not assume prefix hits
                               shared_prefix_len=(shared_prefix_len
                                                  if prefix_cache else 0),
                               slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
                               chunk_prefill=chunk_prefill, **spec_kw)[0]
        if not g.feasible:
            raise ValueError(
                f"no feasible serving schedule for budget {budget_bytes}: "
                f"best candidate predicts peak {g.predicted_peak_bytes} "
                f"bytes ({g.cache_bytes} of KV cache at inflight="
                f"{g.inflight}); raise the budget or shrink "
                f"prompt/new_tokens")
        host = self.quantized(g.dtype) if quants is not None else self
        if autotune:
            # after planning: the winning (dtype, page size) keys the
            # autotune cache, so the kernels are tuned for what serves
            self.autotune(page_size=g.page_size or None,
                          quant=(g.dtype if quants is not None
                                 and g.dtype != FP_LABEL else None))
        eng = host.engine(mode="pipeload", budget_bytes=budget_bytes,
                          num_agents=(num_agents if num_agents is not None
                                      else g.num_agents),
                          pin_window=(pin_window if pin_window is not None
                                      else g.pin_window),
                          attn_impl=attn_impl,
                          expert_cache_bytes=g.expert_cache_bytes or None,
                          page_size=g.page_size or None)
        if slo is None and (slo_ttft_s or slo_tpot_s):
            # seconds -> the scheduler's rounds clock, through the winning
            # schedule's predicted round latency
            rl = g.predicted_per_token_s
            if rl and rl > 0:
                slo = SLO(ttft_rounds=(max(int(slo_ttft_s / rl), 1)
                                       if slo_ttft_s else None),
                          tpot_rounds=((slo_tpot_s / rl)
                                       if slo_tpot_s else None))
        return BatchScheduler(eng, max_inflight=g.inflight,
                              max_total_len=(max_total_len
                                             or prompt_len + new_tokens),
                              prefix_cache=prefix_cache, seed=seed,
                              draft=(draft if g.spec_depth else None),
                              spec_depth=g.spec_depth,
                              chunk_prefill=(chunk_prefill
                                             if g.page_size else 0),
                              slo=slo)

    def execute(self, tokens, *, generate: int = 0, mode: str = "pipeload",
                budget_bytes: Optional[int] = None,
                num_agents: Optional[int] = None,
                pin_window: Optional[int] = None,
                kv_cache: bool = False) -> RunStats:
        """The planned run (paper §IV-3): ``run_single`` on ``tokens``, or
        ``run_generate`` of ``generate`` tokens.  A pipelined KV-cache
        generation with the schedule left open takes the generation-aware
        plan's (num_agents, pin_window) and, for expert-split MoE, its
        expert cache size.  ``budget_bytes`` is a device budget
        (``ledger_budget``).  Returns the run's ``RunStats``."""
        expert_cache = None
        if (kv_cache and generate and mode == "pipeload"
                and (num_agents is None or pin_window is None)):
            b, s0 = tokens.shape
            g = self.plan_generate([budget_bytes], batch=b, prompt_len=s0,
                                   new_tokens=generate)[0]
            if not g.feasible:
                raise ValueError(
                    f"no feasible generation schedule for budget "
                    f"{budget_bytes}: best candidate predicts peak "
                    f"{g.predicted_peak_bytes} bytes ({g.cache_bytes} of "
                    f"KV cache); raise the budget or shrink "
                    f"batch/prompt/new_tokens")
            num_agents = g.num_agents if num_agents is None else num_agents
            pin_window = g.pin_window if pin_window is None else pin_window
            expert_cache = g.expert_cache_bytes or None
        with self.engine(mode=mode, budget_bytes=budget_bytes,
                         num_agents=num_agents, pin_window=pin_window or 0,
                         expert_cache_bytes=expert_cache) as eng:
            if generate:
                _, stats = eng.run_generate(tokens, generate,
                                            kv_cache=kv_cache)
            else:
                _, stats = eng.run_single(tokens)
        return stats

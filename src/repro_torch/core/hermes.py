"""Hermes framework facade (paper §IV): Layer Profiler -> Pipeline Planner
-> Execution Engine, wired together.  PyTorch port of
``repro/core/hermes.py`` (full-precision checkpoints).

    hermes = Hermes(ckpt_dir, cfg, device="cuda")
    profile = hermes.profile()                  # §IV-1
    schedule = hermes.plan([b1, b2, None])      # §IV-2
    sched = hermes.scheduler(budget_bytes=b1)   # continuous batching

The profile is cached in the checkpoint directory as
``profile_torch_<device>.json``, so it never collides with the JAX
package's ``profile.json`` for the same checkpoint, nor with another
device's timings.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.core.engine import PipeloadEngine, resolve_device
from repro_torch.core.planner import (GenPlanEntry, PlanEntry, plan,
                                      plan_generate)
from repro_torch.core.profiler import (load_profile, profile_model,
                                       save_profile)
from repro_torch.models.config import ModelConfig

# planner label for "no quantization: stream shards at the ckpt dtype"
FP_LABEL = "fp32"


class Hermes:
    def __init__(self, ckpt_dir, cfg: ModelConfig, *, device="cuda"):
        self.dir = Path(ckpt_dir)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._profile: Optional[Dict] = None

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

    def _profiles(self, quants: Optional[Sequence[Optional[str]]]):
        """The profile argument the planner takes: one profile, or
        ``{dtype: profile}`` when a dtype search was asked for (only the
        checkpoint's own precision is ported)."""
        if quants is None:
            return self.profile()
        labels = [q or FP_LABEL for q in quants]
        if any(lb != FP_LABEL for lb in labels):
            raise NotImplementedError("quantized shard streaming is not yet "
                                      "ported in repro_torch")
        return {FP_LABEL: self.profile()}

    # ---- Pipeline Planner ----------------------------------------------
    def plan(self, budgets: List[Optional[int]],
             max_agents: Optional[int] = None,
             quants: Optional[Sequence[Optional[str]]] = None
             ) -> List[PlanEntry]:
        return plan(self._profiles(quants), budgets, max_agents)

    def best_agents(self, budget_bytes: Optional[int]) -> int:
        return self.plan([budget_bytes])[0].num_agents

    def plan_generate(self, budgets: List[Optional[int]], *,
                      batch: int = 1, prompt_len: int = 128,
                      new_tokens: int = 32,
                      max_agents: Optional[int] = None,
                      max_pin: Optional[int] = None,
                      max_inflight: int = 1,
                      quants: Optional[Sequence[Optional[str]]] = None
                      ) -> List[GenPlanEntry]:
        """Generation-aware schedule: joint (num_agents, pin_window) with
        KV-cache bytes charged against the budget; ``max_inflight > 1``
        also searches the continuous-batching in-flight count."""
        cb = self.cfg.cache_bytes(batch, prompt_len + new_tokens)
        return plan_generate(self._profiles(quants), budgets,
                             new_tokens=new_tokens,
                             cache_bytes_per_layer=cb, max_agents=max_agents,
                             max_pin=max_pin, max_inflight=max_inflight,
                             total_len=prompt_len + new_tokens)

    # ---- Execution Engine ----------------------------------------------
    def engine(self, *, mode: str = "pipeload",
               budget_bytes: Optional[int] = None,
               num_agents: Optional[int] = None,
               pin_window: int = 0,
               attn_impl: Optional[str] = "auto") -> PipeloadEngine:
        if num_agents is None and mode == "pipeload":
            num_agents = self.best_agents(budget_bytes)
        return PipeloadEngine(self.dir, self.cfg, mode=mode,
                              num_agents=num_agents or 1,
                              budget_bytes=budget_bytes,
                              pin_window=pin_window, attn_impl=attn_impl,
                              device=self.device)

    def scheduler(self, *, budget_bytes: Optional[int] = None,
                  max_inflight: int = 4, prompt_len: int = 128,
                  new_tokens: int = 32,
                  num_agents: Optional[int] = None,
                  pin_window: Optional[int] = None,
                  max_total_len: Optional[int] = None,
                  seed: Optional[int] = None,
                  attn_impl: Optional[str] = "auto"):
        """Continuous-batching serving facade: plan the (num_agents,
        pin_window, inflight) triple for the budget, build the engine and
        wrap it in a ``BatchScheduler`` ready for ``submit()``/``run()``.
        ``prompt_len``/``new_tokens`` describe the typical request."""
        from repro_torch.core.scheduler import BatchScheduler
        g = self.plan_generate([budget_bytes], prompt_len=prompt_len,
                               new_tokens=new_tokens,
                               max_inflight=max_inflight)[0]
        if not g.feasible:
            raise ValueError(
                f"no feasible serving schedule for budget {budget_bytes}: "
                f"best candidate predicts peak {g.predicted_peak_bytes} "
                f"bytes ({g.cache_bytes} of KV cache at inflight="
                f"{g.inflight}); raise the budget or shrink "
                f"prompt/new_tokens")
        eng = self.engine(mode="pipeload", budget_bytes=budget_bytes,
                          num_agents=(num_agents if num_agents is not None
                                      else g.num_agents),
                          pin_window=(pin_window if pin_window is not None
                                      else g.pin_window),
                          attn_impl=attn_impl)
        return BatchScheduler(eng, max_inflight=g.inflight,
                              max_total_len=(max_total_len
                                             or prompt_len + new_tokens),
                              seed=seed)

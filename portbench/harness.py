"""One cell of the port's benchmark: build, warm up, measure, judge.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<config>.json``: the sizes as run, in the source's keys, with the
program's arch and runtime), a traffic mix (``traffic/<mix>.json``, read by
``traffic/<kind>.py``) and has a file of its own, ``cells/<workload>.json``:
the job's ``clients`` (requests it keeps in the engine), the engine's
``max_batch``, how many finished requests the reference judges, the routing
margin below which a position is not judged (``routing_margin``) and the
limits of the numbers compared.  Metrics are read by
``metrics/<metric>.py``, one file each.  Nothing here needs an edit for a
new cell, mix, configuration or metric.

The program is ``repro_torch``'s ``ServeEngine`` on ``DecoderLM``.  The
harness builds it, fills its parameters with weights drawn from the seed
(:mod:`portbench.weights`), warms up one cycle of its waves, then runs the
closed loop: the job submits ``clients`` requests and, whenever the engine
has finished one, submits its next, until ``seconds`` have passed and the
traffic's cycle is whole; the engine forms its waves from its queue and the
window ends when it has drained it.  A thin proxy around the model sees
each call the engine makes: it notes the host time of each prefill (the
engine's ``wave_stats`` time the prefill to its first token on the host),
keeps each prefill's tokens and last-position logits for the judge, and
lets the job collect finished requests.  After the window the program is
freed and the plain reference judges a sample of the finished requests.

What depends on the architecture comes from the configuration's reference
module (``reference/<name>.py``, named by the file's ``"reference"`` key,
``decoder`` without it; see :mod:`portbench.reference`): the parameters'
shapes and dtypes, the keys that must equal the program's, the parts it
does not compute, and the reference itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import reference
from .trace import WINDOW
from .weights import draw

__all__ = ["ROOT", "BENCH", "Cell", "load_cell", "build_program", "Run", "judge",
           "checks", "passes", "read_metrics", "FORBIDDEN_MODULES", "forbidden_modules"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (``repro``; ``repro_torch`` is another name)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # configs/<config>.json
    mix: Dict             # traffic/<mix>.json
    spec: Dict            # cells/<workload>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, bench: Optional[Dict] = None, root: Path = ROOT) -> Cell:
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; choose from {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=workload, chips=w["chips"],
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        mix=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        spec=json.loads((BENCH / "cells" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _generator(cell: Cell):
    return _load(BENCH / "traffic" / f"{cell.mix['kind']}.py")


def traffic(cell: Cell, seed: int, stream_start: int = 0):
    """The job's requests, (prompt tokens, output length), in order."""
    return _generator(cell).requests(cell.mix, cell.spec["max_batch"], seed,
                                     cell.config["vocab_size"], stream_start)


def read_metrics(metrics: List[Dict], rec: Dict) -> Dict:
    """{name: {"value", "unit"}} of the metrics whose reader finds something."""
    out = {}
    for m in metrics:
        value = _load(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------- program


def program_config(config: Dict, base: Callable):
    """The program's ModelConfig for ``config``: its arch at the file's
    depth with the file's runtime keys that are ModelConfig fields; refused
    where a key of the reference module's ``CONFIG_KEYS`` differs from the
    program's field, or where the program has parts the module ``lacks``."""
    ref = reference.module(config)
    mc = base(config["arch"])
    fields = {f.name for f in dataclasses.fields(mc)}
    mc = dataclasses.replace(mc, n_layers=config["num_hidden_layers"],
                             **{k: v for k, v in config["runtime"].items() if k in fields})
    wrong = {}
    for key, field in ref.CONFIG_KEYS.items():
        value = getattr(mc, field) if isinstance(field, str) else field(mc)
        if config[key] != value:
            wrong[key] = (config[key], value)
    parts = ref.lacks(mc)
    if parts:
        wrong["architecture"] = ("the program's config has parts the reference lacks: "
                                 + ", ".join(parts))
    if wrong:
        raise ValueError(f"{config['arch']}: file and program differ: {wrong}")
    return mc


def runtime_config(config: Dict):
    from repro_torch.models import RuntimeConfig
    fields = {f.name for f in dataclasses.fields(RuntimeConfig)}
    return RuntimeConfig(
        param_dtype=_DTYPES[config["param_dtype"]],
        compute_dtype=_DTYPES[config["compute_dtype"]],
        max_cache_len=config["cache_len"],
        **{k: v for k, v in config["runtime"].items() if k in fields})


def build_program(config: Dict, seed: int, device, base: Optional[Callable] = None):
    """The program's model with the benchmark's weights of ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    mc = program_config(config, base or get_config)
    model = build_model(mc, runtime_config(config), device=device, seed=0)
    fill_weights(model, config, seed)
    return model


@torch.no_grad()
def fill_weights(model, config: Dict, seed: int) -> None:
    ref = reference.module(config)
    shapes = ref.param_shapes(config)
    named = dict(model.named_parameters())
    if set(named) != set(shapes):
        raise ValueError(f"the program's parameters differ from the benchmark's: "
                         f"{sorted(set(named) ^ set(shapes))[:8]}")
    for name, p in named.items():
        draw(seed, name, shapes[name], ref.param_dtype(config, name), p.device,
             config["norm"], out=p.data)


class _Seen:
    """The model as the engine sees it.  Per prefill (the engine's waves,
    in order) it keeps the host time of the call, the tokens and the
    last-position logits (on the device as they are: no copy, no wait);
    before each call it lets the job collect what has finished."""

    def __init__(self, model, collect: Callable[[], None]):
        self._model = model
        self._collect = collect
        self.prefills: List[Tuple[float, torch.Tensor, torch.Tensor]] = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, tokens, *args, **kwargs):
        t = time.perf_counter()
        self._collect()
        out = self._model.prefill(tokens, *args, **kwargs)
        self.prefills.append((t, tokens, out[0][:, -1]))
        return out

    def decode_step(self, *args, **kwargs):
        self._collect()
        return self._model.decode_step(*args, **kwargs)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """The program serving one cell's traffic."""

    def __init__(self, cell: Cell, model, seed: int):
        from repro_torch.serve.engine import ServeEngine
        self.cell, self.seed, self.device = cell, seed, model.device
        spec = cell.spec
        self.clients = spec["clients"]
        self.cycle = spec["max_batch"] * int(cell.mix.get("cycle_waves", 1))
        self.model = _Seen(model, self._collect)
        self.engine = ServeEngine(self.model, max_batch=spec["max_batch"], pad_id=0,
                                  seed=seed)
        self.requests: List[Dict] = []          # finished in the window, in order
        self._stream = traffic(cell, seed)
        self._open: Dict[int, Dict] = {}        # submitted, not yet collected
        self._close_at: Optional[float] = None  # while None, nothing is submitted
        self._submitted = 0

    def _submit(self) -> None:
        prompt, m = next(self._stream)
        t = time.perf_counter()
        rid = self.engine.submit(prompt, max_new_tokens=m, temperature=0.0)
        self._open[rid] = {"prompt": prompt, "max_new": m, "t_submit": t}
        self._submitted += 1

    def _collect(self) -> None:
        """Takes the finished requests; each one's client submits its next
        while the window is open, and after it until the cycle is whole."""
        for rid in list(self._open):
            try:
                r = self.engine.result(rid)
            except KeyError:
                continue
            rec = self._open.pop(rid)
            rec.update(output=list(r.output), wave=r.wave,
                       failed=not r.done or r.wave < 0 or len(r.output) != rec["max_new"])
            self.requests.append(rec)
            if self._close_at is not None and (
                    time.perf_counter() < self._close_at or self._submitted % self.cycle):
                self._submit()

    def warm_up(self) -> None:
        """One cycle of the cell's waves (every padded shape the window
        prefills), a few decode steps each, from a stream the window never
        draws."""
        gen = _generator(self.cell)
        stream = traffic(self.cell, self.seed, gen.WARMUP_STREAM)
        for _ in range(self.cycle):
            prompt, m = next(stream)
            self.engine.submit(prompt, max_new_tokens=min(m, 3), temperature=0.0)
        self.engine.run()
        _sync(self.device)

    def window(self, seconds: float, traced: bool = False) -> Dict:
        """The closed loop for ``seconds`` (marked for the trace when
        ``traced``), until the cycle is whole and the engine has drained
        its queue; returns the window's records."""
        first_wave, first_request = len(self.engine.wave_stats), len(self.requests)
        mark = torch.profiler.record_function(WINDOW) if traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        self._close_at = t0 + seconds
        with mark:
            for _ in range(self.clients):
                self._submit()
            while self._open:
                self.engine.run()
                self._collect()
            _sync(self.device)
        window_s = time.perf_counter() - t0
        self._close_at = None
        stats = self.engine.wave_stats
        requests = self.requests[first_request:]
        in_wave: Dict[int, List[Dict]] = {}
        for r in requests:
            # the first token is on the host when the wave's prefill ends
            w = r["wave"]
            r["ttft_s"] = (self.model.prefills[w][0] + stats[w]["prefill_s"] - r["t_submit"]
                           if w >= first_wave else window_s)
            in_wave.setdefault(w, []).append(r)
        waves = [dict(stats[i], t_prefill=self.model.prefills[i][0])
                 for i in range(first_wave, len(stats))]
        for i, w in enumerate(waves):
            _output_lens(w, in_wave.get(first_wave + i, []))
        return {"window_s": window_s, "waves": waves, "requests": requests}


def _output_lens(wave: Dict, requests: List[Dict]) -> None:
    """The wave's output lengths, row for row with its ``prompt_lens``."""
    by_len: Dict[int, List[int]] = {}
    for r in requests:
        by_len.setdefault(len(r["prompt"]), []).append(len(r["output"]))
    wave["output_lens"] = [by_len[n].pop() if by_len.get(n) else 0
                           for n in wave["prompt_lens"]]


# ---------------------------------------------------------------- judging


def sample(requests: List[Dict], n: int, seed: int) -> List[Dict]:
    """``n`` finished requests drawn from the seed, the longest among them."""
    sizes = [len(r["prompt"]) + len(r["output"]) for r in requests]
    longest = int(np.argmax(sizes))
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    rest = [i for i in range(len(requests)) if i != longest]
    picked = [longest] + list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return [requests[i] for i in picked]


def prefill_logits(prefills: List[Tuple], request: Dict) -> torch.Tensor:
    """The logits the program's prefill gave ``request``'s last prompt
    position: the row of its wave that holds its prompt, left-padded."""
    _, tokens, logits = prefills[request["wave"]]
    prompt = torch.as_tensor(request["prompt"]).long()
    tail = tokens[:, tokens.shape[1] - len(prompt):].long().cpu()
    rows = torch.nonzero((tail == prompt).all(1)).flatten()
    if len(rows) != 1:
        raise RuntimeError(f"{len(rows)} rows of wave {request['wave']} hold the prompt")
    return logits[int(rows[0])]


def _logit_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative error of ``got`` (one position's logits) against
    ``want``, both centred (a softmax does not see a constant): the norm of
    the difference over the norm of ``want``."""
    got, want = got.float(), want.float()
    got, want = got - got.mean(), want - want.mean()
    return float((got - want).norm() / want.norm())


def _readings(gaps: List[torch.Tensor], got: List[torch.Tensor], served: List[torch.Tensor],
              ref: List[torch.Tensor], margins: List[torch.Tensor], tau: float) -> Dict:
    """The numbers of one side (the program, or the control in its place),
    and its widest gaps and logit errors with their routing margins."""
    gap, margin = torch.cat(gaps).cpu(), torch.cat(margins)
    clear = margin >= tau
    errors = torch.tensor([_logit_error(g.to(r.device), r[0]) for g, r in zip(got, ref)])
    first = torch.stack([m[0] for m in margins])
    worst = torch.argsort(gap, descending=True)[:WORST]
    worst_errors = torch.argsort(errors, descending=True)[:WORST]
    return {
        "max_logit_gap_clear": float(gap[clear].max()) if clear.any() else None,
        "mean_logit_gap": float(gap.mean()),
        "logit_error_max_clear": (float(errors[first >= tau].max()) if (first >= tau).any()
                                  else None),
        "served_not_best_of_own_logits": sum(int(g.argmax()) != int(s[0])
                                             for g, s in zip(got, served)),
        "max_logit_gap": float(gap.max()),
        "logit_error_median": float(errors.median()),
        "logit_error_max": float(errors.max()),
        "off_best_share": float((gap > 0).float().mean()),
        "worst_gaps": [[float(gap[i]), float(margin[i])] for i in worst],
        "worst_errors": [[float(errors[i]), float(first[i])] for i in worst_errors],
        "by_margin": {str(t): [float(gap[margin >= t].max()) if (margin >= t).any() else None,
                               float(errors[first >= t].max()) if (first >= t).any() else None,
                               float((margin >= t).float().mean())]
                      for t in MARGINS},
    }


# how many of the widest gaps and logit errors a verdict lists, and the
# routing margins at which it gives the widest clear gap, the largest clear
# logit error and the share of positions clear (for setting the cell's)
WORST = 12
MARGINS = (0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15)


def judge(cell: Cell, requests: List[Dict], prefills: List[Tuple], seed: int, device,
          control: bool = False) -> Tuple[Dict, Optional[Dict]]:
    """The served requests against the reference, over a sample of the
    finished ones, and with ``control`` the float8 control's readings on the
    same prompts and tokens (its logits and first choices in the program's
    place).  Per judged position: how far below the reference's best the
    served token's reference logit lies; per request, the relative error of
    the logits the program's prefill returned at the prompt's last position.
    Only positions whose reference routing is clear of a tie (its k-th
    router logit above the (k+1)-th by ``routing_margin`` or more in every
    layer) count for the ``_clear`` numbers: nearer a tie, rounding alone may
    flip an expert."""
    picked = sample(requests, cell.spec["judge_requests"], seed)
    seqs, positions, served = [], [], []
    for r in picked:
        out = r["output"]
        seqs.append(torch.as_tensor(np.concatenate([r["prompt"], np.asarray(out[:-1],
                                                                            np.int32)])))
        n = len(r["prompt"])
        positions.append(torch.arange(n - 1, n - 1 + len(out)))
        served.append(torch.as_tensor(out))
    vocab = cell.config["vocab_size"]
    got = [prefill_logits(prefills, r)[:vocab] for r in picked]
    ref_module = reference.module(cell.config)
    fp32 = ref_module.Reference(cell.config, seed, device, margins=True)
    ref = fp32.logits(seqs, positions)
    margins = [m.cpu() for m in fp32.margins]
    tau = cell.spec["routing_margin"]

    def gaps(tokens):
        return [lg.max(-1).values - lg.gather(-1, s.to(lg.device)[:, None].long())[:, 0]
                for lg, s in zip(ref, tokens)]

    verdict = dict(_readings(gaps(served), got, served, ref, margins, tau),
                   clear_share=float((torch.cat(margins) >= tau).float().mean()),
                   judged_tokens=sum(len(s) for s in served), judged_requests=len(picked))
    if not control:
        return verdict, None
    low = ref_module.Reference(cell.config, seed, device, "fp8").logits(seqs, positions)
    low_served = [lg.argmax(-1).cpu() for lg in low]
    return verdict, _readings(gaps(low_served), [lg[0] for lg in low], low_served, ref,
                              margins, tau)


def checks(cell: Cell, failed: int, verdict: Dict) -> Dict:
    """Each number compared, with its limit (the cell file's ``limits``)."""
    out = {"failed_requests": {"value": failed, "limit": 0}}
    for name, limit in cell.spec["limits"].items():
        out[name] = {"value": verdict[name], "limit": limit}
    return out


def passes(compared: Dict) -> bool:
    """Every number at or under its limit (a number that could not be read
    fails)."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in compared.values())

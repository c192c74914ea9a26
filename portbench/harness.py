"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the reading of its metrics, and the check that decides ``correct``.

Everything that belongs to one cell is found by name:

* the configuration: the file its ``configs`` entry names;
* the traffic: ``portbench/traffic/<traffic>.json``, whose ``driver`` key
  names ``portbench/drivers/<driver>.py`` (how a request drives the
  program, and the check of its answers against ``portbench/reference``);
* each metric: ``portbench/metrics/<name>.py``, a ``read(rec)`` that gives
  a number, or ``None`` where it finds nothing to read.

A run: the driver's ``prepare``, the corpus from the seed where the
configuration names a ``corpus`` (else the driver draws its own inputs
from the seed it is given), the driver's ``setup`` (the program builds
what it serves), ``warmup`` requests from their own stream, and what
set-up left frozen out of the garbage collector; then the window, a
closed loop of requests until ``seconds`` have passed.  With ``trace``
the window's first half runs under ``torch.profiler`` with the program's
spans on, and its second half as an untraced window does (its length
and totals kept as ``untraced``).  Then the
program's state is freed and the driver holds the kept outputs against
the reference.  Beside the metrics, each run reports its host's speed
(``_HostWatch``), which sets the host-bound cells' spread.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

from portbench import corpus as corpus_lib
from portbench import generator, trace_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def load_module(path: str):
    """The module in the file ``path`` (its name may hold dots)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {os.path.relpath(path, ROOT)}")
    name = "portbench._found." + os.path.relpath(path, BENCH).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(e["name"] for e in entries)
    raise KeyError(f"unknown {what} {name!r}; known: {known}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object          # the driver's module
    metrics: dict           # end_to_end entries by name
    per_layer: dict         # per_layer entries by name
    readers: dict           # metric name -> module with read(rec)


def cell_metrics(spec: dict, name: str) -> tuple:
    """The end-to-end and per-layer entries that cell ``name`` reports: an
    entry with ``workloads`` where it names the cell, a per-layer entry
    without them where the cell reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def resolve(name: str, spec: dict = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` (default: ``BENCHMARK.json``) with its
    files loaded; raises on an unknown name or a missing file."""
    if spec is None:
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
    w = _named(spec["workloads"], name, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    config = load_json(os.path.join(root, c["file"]))
    bench = os.path.join(root, "portbench")
    traffic = load_json(os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    driver = load_module(os.path.join(bench, "drivers",
                                      f"{traffic['driver']}.py"))
    e2e, layer = cell_metrics(spec, name)
    readers = {m["name"]: load_module(os.path.join(bench, "metrics",
                                                   f"{m['name']}.py"))
               for m in e2e + layer}
    return Cell(name, w["chips"], config, traffic, driver,
                {m["name"]: m for m in e2e}, {m["name"]: m for m in layer},
                readers)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that no run may load: JAX and
    the JAX package (``repro``, compared whole: ``repro_torch`` is the
    program) and its CPU benchmarks."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN)


# --------------------------------------------------------------------------- #
# the window
# --------------------------------------------------------------------------- #


def requests(drv, seed: int, stream: int, cell: Cell):
    """The request stream ``stream`` of ``seed``: the driver's own where it
    defines ``requests``, else the generator's over the configuration's
    ``n_lists`` lists."""
    if hasattr(drv, "requests"):
        return drv.requests(seed, stream)
    return generator.requests(seed, stream, cell.traffic,
                              cell.config["n_lists"])


def make_corpus(cell: Cell, seed: int):
    """The benchmark's corpus where the configuration names one, else
    None (the driver makes its own inputs from the seed)."""
    if "corpus" not in cell.config:
        return None
    return corpus_lib.make_corpus(cell.config, seed)


class _Window:
    """The closed loop over one request stream: each request timed by the
    host clock, and what the driver ``keep``s of it held for the check
    (all of the first request, a sample drawn from the seed of the rest),
    left where the program put it until the window has closed."""

    def __init__(self, drv, seed: int, cell: Cell):
        self.drv, self.unit = drv, cell.driver.ATTEMPTED
        self.stream = requests(drv, seed, generator.WINDOW, cell)
        self.sample = generator.rng(seed, generator.SAMPLE)
        self.share = cell.traffic.get("check_share", 1.0)
        self.kept = []
        self.attempted = 0

    def run(self, seconds: float) -> tuple:
        """(seconds from the part's start to the last answer, [{host_s,
        t0, t1, <units>}]) of the requests served until ``seconds`` passed
        (``t0``, ``t1``: the request's ends on the ``time.monotonic``
        clock, which the program's spans use)."""
        reqs = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            r = next(self.stream)
            m0, ts = time.monotonic(), time.perf_counter()
            ans = self.drv.serve(r)
            te, m1 = time.perf_counter(), time.monotonic()
            units = self.drv.units(r)
            self.attempted += units[self.unit]
            reqs.append({"host_s": te - ts, "t0": m0, "t1": m1, **units})
            self.kept += self.drv.keep(r, ans, self.sample, self.share,
                                       whole=len(self.kept) == 0)
            del ans
            if te >= deadline:
                return te - t0, reqs


def _gc_pauses():
    """A ``gc.callbacks`` entry that counts the full (generation 2)
    collections from now on and their seconds (``.n``, ``.seconds``)."""
    t0 = [0.0]

    def pause(phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            pause.n += 1
            pause.seconds += time.perf_counter() - t0[0]

    pause.n, pause.seconds = 0, 0.0
    gc.callbacks.append(pause)
    return pause


def _totals(reqs: list) -> dict:
    out = {}
    for row in reqs:
        for k, v in row.items():
            if k not in ("t0", "t1"):
                out[k] = out.get(k, 0) + v
    return out


def _profiled_part(win: _Window, seconds: float, device) -> dict:
    """Part of a traced window under ``torch.profiler``, the program's
    spans on and unfenced.  The device's idle gaps are named by the
    innermost program span open, else by whether the host was inside a
    request."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.obs.trace import enable_tracing
    tracer = enable_tracing(True, fenced=False)
    tracer.clear()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        anchor = time.monotonic()
        with record_function(trace_read.ANCHOR):
            dur, reqs = win.run(seconds)
        torch.cuda.synchronize(device)
    spans = trace_read.span_rows(tracer.spans())
    enable_tracing(False)
    tracer.clear()
    spans += [(trace_read.IN_REQUEST, r["t0"], r["t1"], 0, 0, {})
              for r in reqs]
    rec = trace_read.summarize(trace_read.raw_events(prof), anchor, dur,
                               spans)
    rec.update(requests=len(reqs), totals=_totals(reqs))
    return rec


# --------------------------------------------------------------------------- #
# the host's own speed, beside each run
# --------------------------------------------------------------------------- #


def dispatch_probe_ms() -> float:
    """A fixed piece of host work, timed: 20,000 in-place adds on a small
    CPU tensor, the framework's dispatch without the device (the median of
    five).  The cells' rates are host-bound, so this reads the host's
    speed beside them."""
    import torch
    x = torch.zeros(16)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(20_000):
            x.add_(1)
        times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times)[2]


class _HostWatch:
    """The host's speed over the window: the probe before and after it,
    and this process's CPU seconds over its wall seconds."""

    def __init__(self):
        self.before_ms = dispatch_probe_ms()
        self.cpu, self.wall = time.process_time(), time.perf_counter()

    def close(self) -> dict:
        cpu, wall = time.process_time(), time.perf_counter()
        return {"probe_ms_before": self.before_ms,
                "process_cpu_per_wall": (cpu - self.cpu) / (wall - self.wall),
                "probe_ms_after": dispatch_probe_ms()}


# --------------------------------------------------------------------------- #
# one run
# --------------------------------------------------------------------------- #


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=None) -> dict:
    """One run of ``cell``; returns the result (its keys in the order of
    the result line) with the numbers compared under ``checks``, last.
    ``t_start``: the process's start on the ``time.perf_counter`` clock."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = device.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    drv = cell.driver.Driver(cfg, traffic, device, log, seed)
    drv.prepare()
    corpus = make_corpus(cell, seed)
    corpus_s = time.perf_counter() - t_start
    if corpus is not None:
        log(f"corpus {cfg['corpus']} at {cfg['n_docs']} docs: "
            f"{corpus_s:.2f} s")
    drv.setup(corpus)
    warm = requests(drv, seed, generator.WARMUP, cell)
    for _ in range(traffic.get("warmup", 1)):
        drv.serve(next(warm))
    # what set-up left (the corpus, the program's host objects) is frozen
    # out of the collector, so a full collection in the window scans only
    # what the window makes, as in a server past its start
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.2f} s")

    watch = _HostWatch()
    win = _Window(drv, seed, cell)
    rec = {"setup_s": setup_s, "fixed": drv.fixed()}
    gc_pauses = _gc_pauses()
    if trace:
        half = seconds / 2
        rec["profiled"] = _profiled_part(win, half, device)
        dur, reqs = win.run(seconds - half)
        rec["untraced"] = {"window_s": dur, "totals": _totals(reqs)}
    else:
        rec["window_s"], rec["requests"] = win.run(seconds)
        rec["totals"] = _totals(rec["requests"])
    peak = 0
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, rec["peak_bytes"])
    gc.callbacks.remove(gc_pauses)
    gc.unfreeze()
    host = {"corpus_s": corpus_s, **watch.close()}
    log(f"window: {win.attempted} {cell.driver.ATTEMPTED}; {gc_pauses.n} "
        f"full collections took {gc_pauses.seconds:.3f} s")
    log("host: " + json.dumps(host))
    if "requests" in rec and len(rec["requests"]) <= 64:
        log("request seconds: " + " ".join(
            f"{r['host_s']:.3f}" for r in rec["requests"]))

    wanted = cell.per_layer if trace else cell.metrics
    metrics = {}
    for name, entry in wanted.items():
        value = cell.readers[name].read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}

    attempted = win.attempted
    kept = win.kept
    drv.teardown()
    del drv, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checker = cell.driver.Driver(cfg, traffic, device, log, seed)
    numbers = checker.check(corpus, kept)
    del kept
    log(f"check: {time.perf_counter() - t0:.2f} s")
    out = result(cell.driver, numbers, attempted, metrics, rec, device, peak)
    out = {**{k: v for k, v in out.items() if k != "checks"}, "host": host,
           "checks": out["checks"]}
    return out


def result(driver, numbers: dict, attempted: int, metrics: dict, rec: dict,
           device, peak: int) -> dict:
    """The result line's object: ``checks`` last, each number compared
    beside its limit (``at_most`` a wrong count, ``at_least`` the count
    checked)."""
    import torch
    checks = {k: {"value": numbers[k], "at_most": lim}
              for k, lim in driver.LIMITS.items()}
    checks[driver.CHECKED] = {"value": numbers[driver.CHECKED], "at_least": 1}
    correct = all(c["value"] <= c["at_most"] for c in checks.values()
                  if "at_most" in c) and numbers[driver.CHECKED] >= 1
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": numbers[driver.FAILED], "metrics": metrics, "device": dev}
    prof = rec.get("profiled")
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = {
            "device_ops": trace_read.top(prof["kernels"], key=lambda v: v[1]),
            "idle_gaps": trace_read.top(prof["idle_by_host"])}
    out["checks"] = checks
    return out

"""The benchmark harness: one cell of ``BENCHMARK.json`` per run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in the file
that ``BENCHMARK.json`` gives (sizes, JSON) with the configuration's
work, reference and control beside it (``<file>.py``); its traffic mix
in ``bench/traffic/<mix>.json``, which the one generator
(``bench/generator.py``) reads; each per-layer metric's reader in
``bench/metrics/<metric>.py``; the device's peaks in
``bench/peaks.json``.  A new cell, configuration, mix or metric is new
files and new entries, never an edit.

A run: refuse anything but the cell's GPUs; set up (compile cache in
the checkout, inputs from the seed, the cell's own programs warmed
up); drive the mix in a closed loop for ``--seconds``; read the
device's peak memory; with ``--trace 1`` trace the first steps of the
window and reduce the trace; free the program's state; compare the
window's answers with the float64 reference; print the compared numbers
beside their limits as the last lines of standard error, and one JSON
line as the last line of standard output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRACE_STEPS = 32      # steps traced at the start of a --trace 1 window
TRACE_MAX_S = 5.0     # ... or fewer, if they take longer than this
COPY_BYTES = 1 << 30  # the same-run device copy of a traced run


def say(*a):
    print(*a, file=sys.stderr, flush=True)


class Refused(SystemExit):
    """The run cannot measure what the cell asks for."""

    def __init__(self, why):
        say(f"refused: {why}")
        super().__init__(2)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _path(self, *parts):
        return os.path.join(self.root, *parts)

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def _config_file(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return self._path(c["file"])
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def config(self, name):
        with open(self._config_file(name)) as f:
            return json.load(f)

    def config_module(self, name):
        return _load_module(os.path.splitext(self._config_file(name))[0]
                            + ".py", f"bench_config_{name}")

    def traffic(self, name):
        with open(self._path("bench", "traffic", name + ".json")) as f:
            return json.load(f)

    def reader(self, metric):
        return _load_module(self._path("bench", "metrics", metric + ".py"),
                            "bench_metric_" + metric.replace(".", "_")).read

    def peaks(self):
        with open(self._path("bench", "peaks.json")) as f:
            return json.load(f)

    def metrics_for(self, kind, cell):
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------

def outputs_of(mix) -> set:
    names = set(mix.get("after", {}))
    for c in mix["calls"]:
        a = c.get("as")
        names.update([a] if isinstance(a, str) else a or [])
    return names


def pick(mix, answer: dict) -> dict:
    """The part of a full answer that the mix returns."""
    return {k: v for k, v in answer.items() if k in outputs_of(mix)}


def sample_of(cfg, seed) -> int:
    """The pool image, drawn from the seed, whose steps' norms are
    compared."""
    return int(np.random.default_rng(seed).integers(cfg["pool"]))


def check_plan(cfg, seed, n_steps) -> dict:
    """Which of the window's answers are compared: every ``norm1`` of
    the steps that read the pool image drawn from the seed, and every
    answer of the last step."""
    pool = cfg["pool"]
    sample = sample_of(cfg, seed)
    last = n_steps - 1
    steps = sorted({k for k in range(n_steps) if k % pool == sample} | {last})
    return {"sample": sample, "last": last, "steps": steps}


def references(cfg, mod, pool, plan) -> dict:
    """The float64 reference of each pool image the plan compares."""
    n = cfg["pool"]
    want = {plan["last"] % n: True}
    want.setdefault(plan["sample"], False)
    return {i: mod.reference(cfg, pool[i], image=img) for i, img in want.items()}


def _rel_max(dev, ref):
    d = np.asarray(dev, np.float64)
    r = np.asarray(ref, np.float64)
    if d.shape != r.shape or not np.isfinite(d).all():
        return float("inf")
    return float(np.abs(d - r).max()) / (float(np.abs(r).max()) or 1.0)


def compare(cfg, refs, outs, plan) -> dict:
    """``{name: {"value", "limit"}}`` for each number compared.

    ``norm1_rel_err``: the largest relative error of a compared step's
    norm; ``image_rel_err``: max |image - reference| over max
    |reference| of the last step's image; ``coeffs_rel_err``: the same
    per subband of its thresholded coefficients, the largest."""
    import jax

    n = cfg["pool"]
    lim = cfg["limits"]
    checks = {}
    last = outs[plan["last"]]
    ref_last = refs[plan["last"] % n]
    if "coeffs" in last:
        leaves = jax.tree_util.tree_leaves(last["coeffs"])
        checks["coeffs_rel_err"] = (
            max(_rel_max(d, r) for d, r in zip(leaves, ref_last["coeffs"]))
            if len(leaves) == len(ref_last["coeffs"]) else float("inf"))
    if "image" in last:
        checks["image_rel_err"] = _rel_max(last["image"], ref_last["image"])
    norms = [abs(float(o["norm1"]) - refs[k % n]["norm1"])
             / abs(refs[k % n]["norm1"])
             for k, o in outs.items() if "norm1" in o]
    if norms:
        checks["norm1_rel_err"] = max(norms) if np.isfinite(norms).all() \
            else float("inf")
    return {k: {"value": v, "limit": lim[k]} for k, v in checks.items()}


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def card_line() -> str:
    """Name and power limit of the cards, read by nvidia-smi in a child
    process (which never imports JAX)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return " | ".join(r.stdout.split("\n")).strip(" |")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def copy_bandwidth(device) -> float:
    """Bytes per second that a large device copy (read + write) reaches
    on ``device``: the median of 10 runs of ``x + 1`` on 1 GiB."""
    import jax
    import jax.numpy as jnp

    x = jax.device_put(jnp.zeros(COPY_BYTES // 4, jnp.float32), device)
    f = jax.jit(lambda v: v + 1.0)
    f(x).block_until_ready()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return 2 * COPY_BYTES / float(np.median(ts))


class _Listener:
    """Counts compilations and sums compile and cache-load seconds."""

    def __init__(self):
        import jax

        self.compiles = 0
        self.compile_s = 0.0
        self.cache_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self)

    def __call__(self, name, secs, **_):
        if name == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1
            self.compile_s += secs
        elif "cache_retrieval" in name:
            self.cache_s += secs


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv, *, root=ROOT, t_start=None, allow_cpu=False, shape=None,
        cache=True, trace_dir=None):
    """One run; returns the result line's object.  ``allow_cpu``,
    ``shape``, ``cache=False`` and ``trace_dir`` exist for the CPU tests
    only: they let a run go on without a GPU, at a smaller image, with
    no compile cache, tracing into a directory of the test's own."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = Bench(root)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mod = bench.config_module(cell["config"])
    mix = bench.traffic(cell["traffic"])
    if shape is not None:
        cfg["shape"] = list(shape)

    import jax

    from bench import generator
    from bench import trace as tr

    devices = jax.devices()
    dev = devices[0]
    peaks = bench.peaks().get(dev.device_kind)
    if not allow_cpu:
        if dev.platform != "gpu":
            raise Refused(f"needs a GPU; JAX found platform {dev.platform!r}")
        if len(devices) < cell["chips"]:
            raise Refused(f"needs {cell['chips']} GPUs, found {len(devices)}")
        if peaks is None:
            raise Refused(f"no peaks for {dev.device_kind!r} in peaks.json")
    used = devices[:cell["chips"]]
    if cache:
        path = os.path.join(root, "bench", ".jax_cache")
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    listen = _Listener()
    t_jax = time.perf_counter()

    pool = generator.make_pool(cfg, mix, args.seed)
    t_pool = time.perf_counter()
    caller = generator.Caller(cfg, mix, pool)
    for k in range(2):
        out = caller.step(k)
    del out
    t_warm = time.perf_counter()
    compiles0 = listen.compiles
    say(f"card: {card_line()}")
    say(f"set-up: jax start {t_jax - t_start:.3f} s, inputs "
        f"{t_pool - t_jax:.3f} s, facade and warm-up {t_warm - t_pool:.3f} s "
        f"(compiled {listen.compiles} programs in {listen.compile_s:.3f} s, "
        f"cache loads {listen.cache_s:.3f} s)")

    # ---- the measured window ----
    trace_dir = trace_dir or os.path.join(root, "bench", ".trace",
                                          args.workload)
    tracing = bool(args.trace)
    if tracing:
        shutil.rmtree(trace_dir, ignore_errors=True)
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0
        jax.profiler.start_trace(trace_dir, profiler_options=opts)
    plan_pool = cfg["pool"]
    sample = sample_of(cfg, args.seed)
    kept, lat = {}, []
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    k, t1, out = 0, t0, None
    while k == 0 or t1 < deadline:
        out = None  # a caller drops the last answer before the next call
        s = time.perf_counter()
        out = caller.step(k)
        t1 = time.perf_counter()
        lat.append(t1 - s)
        if k % plan_pool == sample and "norm1" in out:
            kept[k] = {"norm1": out["norm1"]}
        k += 1
        if tracing and (k >= TRACE_STEPS or t1 - t0 >= TRACE_MAX_S):
            jax.profiler.stop_trace()
            tracing = False
            traced = k
    if tracing:
        jax.profiler.stop_trace()
        traced = k
    n = k
    window = t1 - t0
    say(f"window: {n} steps in {window:.3f} s; compiles in window: "
        f"{listen.compiles - compiles0}")

    peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in used)
    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(used), "memory_peak_bytes": peak}}

    if args.trace:
        red = tr.reduce(tr.find(trace_dir))
        shutil.rmtree(trace_dir, ignore_errors=True)
        say(f"traced: {traced} steps, {len(red.steps) if red else 0} in "
            f"the trace")
        # what a per-layer metric reader gets
        ctx = SimpleNamespace(trace=red, work=mod.work(cfg), peaks=peaks,
                              cfg=cfg, mix=mix)
        for m in bench.metrics_for("per_layer", args.workload):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if red is not None and red.devices:
            result["device"]["busy_s"] = red.busy_ns() / 1e9
            result["device"]["window_s"] = red.window_ns / 1e9
            result["breakdown"] = {"device_ops": red.top_ops(),
                                   "idle_gaps": red.idle_gaps()}
    else:
        mpix = float(np.prod(cfg["shape"])) / 1e6
        e2e = {"mpix_s": mpix * n / window,
               "io_mpix_s": mpix * n / window,
               "step_p95_ms": float(np.percentile(lat, 95)) * 1e3,
               "peak_mem_gb": peak / 1e9,
               "setup_s": t0 - t_start}
        for m in bench.metrics_for("end_to_end", args.workload):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}

    # ---- the answers, then the program's state is freed ----
    kept[n - 1] = out
    outs = {}
    for step, o in kept.items():
        outs[step] = {name: jax.device_get(v) for name, v in o.items()}
    plan = check_plan(cfg, args.seed, n)
    host_pool = {i: np.asarray(pool[i]) for i in
                 {plan["sample"], plan["last"] % plan_pool}}
    del out, kept, caller, pool
    if args.trace and not allow_cpu:
        bw = copy_bandwidth(used[0])
        say(f"device copy: {bw:.6e} B/s ({COPY_BYTES} B read and written, "
            f"median of 10) on {card_line()}")

    t_ref = time.perf_counter()
    refs = references(cfg, mod, host_pool, plan)
    checks = compare(cfg, refs, outs, plan)
    bad = [name for name, c in checks.items() if not c["value"] <= c["limit"]]
    result["correct"] = not bad
    norm_lim = cfg["limits"].get("norm1_rel_err", 0.0)
    norm_bad = sum(1 for s, o in outs.items() if "norm1" in o and not abs(
        float(o["norm1"]) - refs[s % plan_pool]["norm1"])
        <= norm_lim * abs(refs[s % plan_pool]["norm1"]))
    result["failed"] = norm_bad + (1 if set(bad) - {"norm1_rel_err"} else 0)
    say(f"reference: {time.perf_counter() - t_ref:.3f} s for "
        f"{len(refs)} pool images; compared steps {len(outs)}")
    for name, c in checks.items():
        say(f"check {name} {c['value']:.6e} limit {c['limit']:.1e} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    result["checks"] = checks
    return result


def main(argv=None, t_start=None) -> int:
    result = run(argv, t_start=t_start)
    print(json.dumps(result), flush=True)
    return 0

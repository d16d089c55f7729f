"""Headline benchmark of the port (counterpart of the JAX package's
``bench.py``): prints ONE JSON line, always.

    python -m mpi4dl_tpu_torch.bench [--telemetry-dir DIR] [--measured PATH]

Metric: AmoebaNet-D(18, 416) training throughput (images/sec) on one card at
the reference's flagship 1024², batch 1 (bf16 compute over fp32
parameters, SGD lr 0.001), against the reference's published GPU-cluster
figures (``BASELINE_*``: ≈2.1 img/s for SP square + halo-D2 over five GPUs).

- **Rungs**, each in a subprocess (``--inner ...``) so that a CUDA OOM
  cannot kill the benchmark, and the next attempt starts in a fresh
  process: the 1024² bs1 headline without remat, cell remat the fallback
  (then 512² bs1, not comparable); then the 2048² bs1 and bs2 rungs, the
  1024² bs2 / bs4 / bs8 rungs (no remat, cell remat on OOM), ResNet-110 v2
  at 1024² and 2048² (sqrt remat; 2048² retried with
  ``MPI4DL_REMAT_OPS=1`` on OOM), and ``max_trainable_px``: the largest
  square image whose bs1 step completes with fine remat, by a doubling
  ladder, a probe at the cap and a /64-aligned bisection (``--probe PX``,
  a subprocess each).
- **Timing.**  The step's FLOPs come from ``obs.costs.counting`` on one
  step (the hand kernels' included) and the peak from
  ``obs.costs.peak_flops``.  ``async_chain``: the steps run back to back,
  then ``torch.cuda.synchronize()`` and one ``.item()`` on the loss.  A
  measured MFU above 1 is impossible: the rung re-measures with
  ``.item()`` after every step (``per_step_blocked``), and an MFU still
  above 1 is an ``error``.  ``scan_steps_per_dispatch`` is always 1.
  Warm-up counts calls; the first includes the kernels' first use and
  cuDNN's algorithm search.
- **No card.**  A card preflight (a subprocess reading
  ``torch.cuda.get_device_name(0)`` under a time limit) gates every rung;
  without a card the line carries ``value: 0``, ``platform: "none"`` and
  the error, and no CPU figure stands in.  ``--device cpu`` (tests) runs
  the JAX package's CPU smoke rung instead (128², AmoebaNet-D(3, 64)),
  ``comparable: false``.
- **Evidence.**  Nothing is written into the repository: ``--measured
  PATH`` banks each rung and each passed probe into PATH (merged under a
  lock), and only then seeds the resolution ladder from it.
  ``--telemetry-dir`` mirrors each rung into a RunLog ``summary`` plus its
  ``.prom``.  ``MPI4DL_PALLAS_CONV=1`` routes the convs through the
  hand-written kernels (K1/K2); the rung's K1/K2 launches a step are
  printed on its stderr.  ``BENCH_DEADLINE_S`` bounds the whole run;
  ``BENCH_SKIP_MEMORY_RUNGS=1`` stops after the headline.

The first stderr line is the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``), which the JSON carries as ``device_kind``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

BASELINE_CLUSTER = 2.1   # reference: AmoebaNet-D 1024² bs1, SP square + D2, 5 GPUs
BASELINE_DEVICES = 5
BASELINE_2048 = 2.85     # reference: AmoebaNet-D 2048² bs1, SP vertical + D2, 5 GPUs
BASELINE_2048_BS2 = 5.0  # reference: AmoebaNet-D 2048² bs2, its best chart point
BASELINE_1024_BS2 = 2.95  # reference: AmoebaNet-D 1024² bs2, SP square + D2, 5 GPUs
BASELINE_RESNET_1024 = 2.55  # reference: ResNet-110-v2 1024² bs1, SP best, 5 GPUs
BASELINE_RESNET_2048 = 0.99  # reference: ResNet-110-v2 2048² bs1, SP, 5 GPUs

# (name, platform, image_size, num_layers, num_filters, warmup, iters,
#  timeout_s, comparable, remat, batch).  The headline runs without remat,
#  cell remat is its OOM fallback; warmup counts calls.
LADDER = [
    ("gpu_1024_noremat", "gpu", 1024, 18, 416, 1, 18, 1800, True, "none", 1),
    ("gpu_1024", "gpu", 1024, 18, 416, 1, 18, 1800, True, "cell", 1),
    ("gpu_512", "gpu", 512, 18, 416, 1, 12, 900, False, "cell", 1),
]
CPU_SMOKE = ("cpu_smoke", "cpu", 128, 3, 64, 1, 3, 600, False, "cell", 1)

_REMAT = {"none": False, "cell": True, "fine": "fine", "sqrt": "sqrt"}

PROBE_TIMEOUT_S = 1800
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "3600"))
_T0 = time.monotonic()

# Where rungs and passed probes are banked; None: nowhere (``--measured``).
MEASURED_PATH = None

_OOM_RE = r"CUDA out of memory|OutOfMemoryError|Ran out of memory|RESOURCE_EXHAUSTED|Out of memory"
_HATCHES = ("MPI4DL_REMAT_OPS", "MPI4DL_PALLAS_CONV")


def _time_left() -> float:
    return DEADLINE_S - (time.monotonic() - _T0)


def _record_measured(name: str, entry: dict) -> None:
    """Merge one rung (or passed probe) into ``MEASURED_PATH`` under a lock;
    never raises, and does nothing without ``--measured``."""
    if MEASURED_PATH is None:
        return
    try:
        import fcntl

        with open(MEASURED_PATH + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            data = {}
            if os.path.exists(MEASURED_PATH):
                with open(MEASURED_PATH) as f:
                    data = json.load(f)
            entry = dict(entry, captured_unix=int(time.time()))
            data.setdefault("rungs", {})[name] = entry
            data["updated_unix"] = int(time.time())
            tmp = MEASURED_PATH + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, MEASURED_PATH)
    except Exception as e:  # noqa: BLE001 — evidence must not break the benchmark
        print(f"[bench] measured-record failed: {e}", file=sys.stderr)


def _load_measured():
    if MEASURED_PATH is None:
        return None
    try:
        with open(MEASURED_PATH) as f:
            return json.load(f)
    except Exception:  # noqa: BLE001
        return None


def card_line():
    """``nvidia-smi``'s name and power limit of the visible cards (None
    without ``nvidia-smi``)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _build_step(image_size: int, num_layers: int, num_filters: int, batch: int = 1,
                remat="cell", arch: str = "amoeba", device: str = "cuda"):
    """(step, state) of the single-device training step of a rung: bf16
    compute over fp32 parameters, SGD lr 0.001, weights from seed 0."""
    import torch

    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    shape = (batch, image_size, image_size, 3)
    if arch == "resnet":
        # The JAX rung's remat grouping for the deep-thin model.
        os.environ.setdefault("MPI4DL_SQRT_GROUPS", "16")
        from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

        model = get_resnet_v2(shape, depth=num_layers, num_classes=1000, device=device,
                              seed=0)
    else:
        from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

        model = amoebanetd(shape, num_classes=1000, num_layers=num_layers,
                           num_filters=num_filters, device=device, seed=0)
    opt = Optimizer("sgd", lr=0.001)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, remat=_REMAT[remat],
                           pallas_conv=os.environ.get("MPI4DL_PALLAS_CONV") == "1")
    return step, TrainState.create(model, opt)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(step, state, xs, ys, iters: int, blocked: bool, dev):
    """Time ``iters`` steps cycling through the inputs: ``async_chain``
    (blocked False) synchronizes and reads the loss once at the end;
    ``per_step_blocked`` reads the loss to the host after every step."""
    n = len(xs)
    t0 = time.perf_counter()
    metrics = None
    for i in range(iters):
        state, metrics = step(state, xs[i % n], ys[i % n])
        if blocked:
            metrics["loss"].item()
    _sync(dev)
    metrics["loss"].item()
    return time.perf_counter() - t0, state


def _kernel_launches():
    from mpi4dl_tpu_torch.ops import halo_conv

    return {"K1": halo_conv.LAUNCHES["halo_conv2d"],
            "K2": halo_conv.LAUNCHES["halo_conv2d_stats"]}


def _inner(platform: str, image_size: int, num_layers: int, num_filters: int,
           warmup: int, iters: int, comparable: bool, remat="cell", batch: int = 1,
           arch: str = "amoeba") -> dict:
    """One rung in this process; prints and returns its JSON."""
    import torch

    from mpi4dl_tpu_torch.obs.costs import counting, peak_flops

    if platform == "gpu" and not torch.cuda.is_available():
        print("[bench] wanted a card, found none — bail", file=sys.stderr)
        sys.exit(3)
    dev = torch.device("cuda", 0) if platform == "gpu" else torch.device("cpu")
    kind = (card_line() or torch.cuda.get_device_name(dev)) if platform == "gpu" else "cpu"
    print(f"[bench] platform={platform} device={dev} kind={kind}", file=sys.stderr)
    step, state = _build_step(image_size, num_layers, num_filters, batch, remat, arch,
                              device=dev)
    n_inputs = min(4, max(2, iters))
    shp = (batch, image_size, image_size, 3)
    gens = [torch.Generator(device=dev).manual_seed(100 + i) for i in range(n_inputs)]
    xs = [torch.randn(shp, generator=g, device=dev, dtype=torch.bfloat16) for g in gens]
    ys = [torch.full((batch,), i % 1000, dtype=torch.int64, device=dev)
          for i in range(n_inputs)]

    t_c = time.perf_counter()
    with counting() as cost:
        state, metrics = step(state, xs[0], ys[0])
    _sync(dev)
    flops = float(cost["flops"]) if cost["error"] is None and cost["flops"] > 0 else None
    if cost["error"] is not None:
        print(f"[bench] counting failed: {cost['error']}", file=sys.stderr)
    peak, peak_source = peak_flops(dev, allow_cpu_nominal=platform == "cpu")
    for i in range(warmup):
        state, metrics = step(state, xs[i % n_inputs], ys[i % n_inputs])
    _sync(dev)
    metrics["loss"].item()
    print(f"[bench] counted step + warmup {time.perf_counter() - t_c:.1f}s; "
          f"flops/step={flops}", file=sys.stderr)

    def mfu_of(dt: float, n: int):
        if flops is None or peak is None:
            return None
        return (flops * n / dt) / peak

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _kernel_launches()
    mode = "async_chain"
    dt, state = _measure(step, state, xs, ys, iters, False, dev)
    mfu = mfu_of(dt, iters)
    launched = {k: v - before[k] for k, v in _kernel_launches().items()}
    error = None
    if mfu is not None and mfu > 1.0:
        print(f"[bench] mfu={mfu:.2f} > 1 under async timing — falling back to "
              "per-step blocking", file=sys.stderr)
        mode = "per_step_blocked"
        iters *= 2
        dt, state = _measure(step, state, xs, ys, iters, True, dev)
        mfu = mfu_of(dt, iters)
        if mfu is not None and mfu > 1.0:
            error = (f"measurement failed: mfu={mfu:.2f} > 1 even with a loss read "
                     "after every step")
    steps_timed = iters if mode == "async_chain" else iters // 2
    per_step = {k: v / steps_timed for k, v in launched.items()}
    print(f"[bench] K1/K2 launches a step: K1 {per_step['K1']:g} K2 {per_step['K2']:g}",
          file=sys.stderr)
    img_per_sec = batch * iters / dt
    achieved = flops * iters / dt if flops else None
    ok = error is None
    model_tag = "resnet110v2" if arch == "resnet" else "amoebanetd"
    out = {
        "metric": f"{model_tag}_{image_size}px_bs{batch}_train_img_per_sec"
                  "_single_chip_vs_5gpu_cluster_baseline",
        "value": round(img_per_sec, 4),
        "unit": "images/sec",
        "vs_baseline": round(img_per_sec / BASELINE_CLUSTER, 4) if (comparable and ok) else None,
        "vs_baseline_per_device": (
            round(img_per_sec / (BASELINE_CLUSTER / BASELINE_DEVICES), 4)
            if (comparable and ok) else None),
        "baseline_img_per_sec_cluster": BASELINE_CLUSTER,
        "baseline_devices": BASELINE_DEVICES,
        "comparable": comparable,
        "platform": platform,
        "device_kind": kind,
        "timing_mode": mode,
        "iters": iters,
        "scan_steps_per_dispatch": 1,
        "ms_per_step": round(dt / iters * 1e3, 3),
        "flops_per_step": flops,
        "achieved_tflops": round(achieved / 1e12, 2) if achieved else None,
        "peak_tflops": round(peak / 1e12, 1) if peak else None,
        "peak_source": peak_source,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "kernel_launches_per_step": per_step,
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
                            if dev.type == "cuda" else None),
    }
    if error:
        out["error"] = error
    tdir = os.environ.get("BENCH_TELEMETRY_DIR")
    if tdir:
        try:
            from mpi4dl_tpu_torch.obs import RunLog
            from mpi4dl_tpu_torch.obs.metrics import write_metrics_file
            from mpi4dl_tpu_torch.obs.runlog import read_runlog

            with RunLog.create(tdir, prefix=f"bench-{model_tag}") as rl:
                rl.write_meta(config={"image_size": image_size, "num_layers": num_layers,
                                      "num_filters": num_filters, "batch": batch,
                                      "remat": remat, "arch": arch, "platform": platform},
                              family="bench")
                rl.write("summary", **out)
            prom = os.path.splitext(rl.path)[0] + ".prom"
            write_metrics_file(read_runlog(rl.path), prom)
            print(f"[bench] telemetry -> {rl.path} (+ {prom})", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — telemetry must not kill the bench
            print(f"[bench] telemetry failed: {e}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


def _inner_probe(image_size: int) -> None:
    """Train ONE bs1 step at ``image_size`` with fine remat on the card;
    print a small JSON on success.  An OOM kills the process: the outer
    process reads the death as "does not fit"."""
    import torch

    if not torch.cuda.is_available():
        sys.exit(3)
    dev = torch.device("cuda", 0)
    step, state = _build_step(image_size, 18, 416, 1, remat="fine", device=dev)
    x = torch.randn((1, image_size, image_size, 3), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    y = torch.zeros((1,), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    state, metrics = step(state, x, y)
    loss = metrics["loss"].item()
    print(json.dumps({"ok": bool(loss == loss), "image_size": image_size,
                      "first_step_s": round(time.perf_counter() - t0, 1),
                      "peak_memory_gib": round(torch.cuda.max_memory_allocated(dev) / 2**30,
                                               3)}))


def _stderr_gist(stderr: str) -> str:
    """The most informative failure line (OOM and compile errors name
    themselves mid-log; a raw tail often lands on a traceback fragment).
    The card's own OOM wins over any later error line: an OOM inside a
    checkpointed region can be followed by an error of the unwinding."""
    lines = list(reversed((stderr or "").splitlines()))
    for line in lines:
        if re.search(r"CUDA out of memory|OutOfMemoryError", line):
            return line.strip()[:300]  # the request and the free bytes come first
    for line in lines:
        if re.search(r"Ran out of memory|RESOURCE_EXHAUSTED|Out of memory|XLA:TPU compile|"
                     r"UNAVAILABLE|\w*Error\b|error:", line):
            return line.strip()[-300:]
    return (stderr or "")[-300:]


def _run_sub(argv_tail, timeout_s, platform="gpu"):
    """``python -m mpi4dl_tpu_torch.bench <argv_tail>`` in a subprocess:
    (its last JSON line, None) or (None, the failure)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "mpi4dl_tpu_torch.bench"] + list(argv_tail)
    try:
        proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        tail = (e.stderr or "")[-300:] if isinstance(e.stderr, str) else ""
        return None, f"timeout after {timeout_s}s; stderr tail: {tail}"
    sys.stderr.write(proc.stderr[-2000:] if proc.stderr else "")
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line), None
            except json.JSONDecodeError:
                continue
    return None, f"rc={proc.returncode}; stderr: {_stderr_gist(proc.stderr)}"


def _try_rung(name, platform, image_size, num_layers, num_filters, warmup, iters,
              timeout_s, comparable, remat="cell", batch=1, arch="amoeba"):
    tail = ["--inner", platform, str(image_size), str(num_layers), str(num_filters),
            str(warmup), str(iters), "1" if comparable else "0", remat, str(batch), arch]
    result, err = _run_sub(tail, timeout_s, platform)
    if err:
        err = f"{name}: {err}"
    if result is not None:
        result["remat"] = remat
        result["rung_config"] = {
            "arch": arch, "image_size": image_size, "num_layers": num_layers,
            "num_filters": num_filters, "batch": batch, "scan_steps": 1, "remat": remat,
            "iters": iters, "input_dtype": "bfloat16", "compute_dtype": "bfloat16",
            "optimizer": "sgd",
        }
        for hatch in _HATCHES:
            if os.environ.get(hatch) == "1":
                result["rung_config"][hatch] = "1"
        if os.environ.get("MPI4DL_SQRT_GROUPS"):
            result["rung_config"]["MPI4DL_SQRT_GROUPS"] = os.environ["MPI4DL_SQRT_GROUPS"]
        if result.get("platform") == "gpu":
            _record_measured(name, {k: result.get(k) for k in (
                "value", "mfu", "achieved_tflops", "timing_mode", "platform",
                "device_kind", "rung_config", "error")})
    return result, err


def _rung_summary(result, err, baseline, baseline_key):
    """The per-rung summary of the ``rungs`` section."""
    if result is None:
        return {"error": (err or "")[-200:]}
    return {
        "img_per_sec": result["value"],
        "mfu": result.get("mfu"),
        "timing_mode": result.get("timing_mode"),
        "remat": result.get("remat"),
        "rung_config": result.get("rung_config"),
        baseline_key: (round(result["value"] / baseline, 4)
                       if (baseline and not result.get("error")) else None),
    }


def _max_trainable_px(start: int = 2048, cap: int = 8192, known_fit: int = 0,
                      gate=None, note_ok=None):
    """Largest square image whose bs1 step completes on the card: a doubling
    ladder from ``start``, a probe at the cap when the ladder overshoots it,
    then a bisection of [last fit, first failure) on /64-aligned values.
    Every attempt is a subprocess; any death (OOM, crash, time limit) reads
    as "does not fit".  ``known_fit`` seeds the ladder with a resolution
    already proved; ``gate`` is checked before each probe."""
    attempts = {}

    def fits(px: int) -> bool:
        if gate is not None and not gate():
            attempts[str(px)] = {"ok": False, "error": "skipped (card preflight negative)"}
            return False
        budget = min(PROBE_TIMEOUT_S, max(0, _time_left() - 60))
        if budget < 120:
            attempts[str(px)] = {"ok": False, "error": "bench deadline reached"}
            return False
        result, err = _run_sub(["--probe", str(px)], budget)
        ok = bool(result and result.get("ok"))
        if note_ok is not None and (ok or re.search(_OOM_RE, err or "")):
            note_ok()  # an OOM proves the card answered as much as a fit does
        attempts[str(px)] = (
            {"ok": True, "first_step_s": result.get("first_step_s"),
             "peak_memory_gib": result.get("peak_memory_gib")} if ok
            else {"ok": False, "error": (err or "no output")[-300:]})
        if ok:
            _record_measured(f"probe_{px}", {
                "ok": True, "first_step_s": result.get("first_step_s"), "platform": "gpu",
                "rung_config": {"image_size": px, "remat": "fine", "batch": 1,
                                "scan_steps": 1}})
        print(f"[bench] probe {px}px: {'fits' if ok else 'FAILS'}", file=sys.stderr)
        return ok

    best, px, fail_at = known_fit, max(start, known_fit * 2), None
    while px <= cap:
        if not fits(px):
            fail_at = px
            break
        best, px = px, px * 2
    if fail_at is None and best < cap and px > cap:
        # A seed that is no power of two overshoots the cap unprobed.
        if fits(cap):
            best = cap
        else:
            fail_at = cap
    if best and (fail_at or best < cap):
        lo, hi = best, (fail_at or cap)
        while hi - lo >= 512:
            mid = ((lo + hi) // 2) - (((lo + hi) // 2) % 64)
            if mid <= lo or mid >= hi:
                break
            if fits(mid):
                lo = mid
            else:
                hi = mid
        best = lo
    return best, attempts


NO_CARD = "no CUDA device"


def _card_preflight(timeout_s: int = 240):
    """The card's name from a subprocess; :data:`NO_CARD` when torch sees
    no CUDA device; None when CUDA does not answer within ``timeout_s`` or
    fails."""
    argv = [sys.executable, "-c",
            "import torch\n"
            f"print(torch.cuda.get_device_name(0) if torch.cuda.is_available() else {NO_CARD!r})"]
    try:
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None
    lines = (proc.stdout or "").strip().splitlines()
    return lines[-1] if proc.returncode == 0 and lines else None


def _note_health(health, result, err) -> None:
    """An OOM death proves the card answered, as a parsed result does."""
    if result is not None or re.search(_OOM_RE, err or ""):
        health.note_success()
    else:
        health.note_rung_failure()


class _CardHealth:
    """Card reachability before each rung group: a recent success (a passed
    preflight or a rung that produced a number) is trusted for ``FRESH_S``;
    after a failed rung the next check runs the preflight again."""

    FRESH_S = 300.0

    def __init__(self):
        self._last_ok = None
        self.consec_fail = 0
        self.absent = False  # torch saw no CUDA device: no later check can pass

    def note_success(self) -> None:
        self._last_ok = time.monotonic()
        self.consec_fail = 0

    def note_rung_failure(self) -> None:
        self._last_ok = None

    def check(self) -> bool:
        if self._last_ok is not None and time.monotonic() - self._last_ok < self.FRESH_S:
            return True
        if self.absent or _time_left() <= 90:
            return False
        budget = min(240, max(60, int(_time_left() / 4)))
        name = _card_preflight(budget)
        if name is None and self.consec_fail == 0 and _time_left() > 240:
            name = _card_preflight(budget)  # one retry, on the first failure
        self.absent = name == NO_CARD
        ok = name is not None and not self.absent
        if ok:
            self.note_success()
        else:
            self.consec_fail += 1
        return ok


def _remat_ladder(name, px, tries, iters, batch, timeout_cap, health):
    """Walk ``tries`` (remat levels) until one fits; only an OOM justifies
    the next.  (result or None, the joined errors)."""
    r, errs = None, []
    for rm in tries:
        if _time_left() < 300:
            errs.append(f"{rm}: skipped (bench deadline reached)")
            break
        r, e = _try_rung(name, "gpu", px, 18, 416, 1, iters,
                         min(timeout_cap, max(300, _time_left() - 300)), False, rm, batch)
        if r is not None:
            health.note_success()
            break
        errs.append(f"{rm}: {e}")
        _note_health(health, r, e)
        if not re.search(_OOM_RE, e or ""):
            break
    return r, "; ".join(errs)


def _extra_rungs(headline, health) -> None:
    """The memory and batch rungs, ResNet-110 v2 and ``max_trainable_px``,
    into ``headline``."""

    def gate(rname: str) -> bool:
        if health.check():
            return True
        headline["rungs"][rname] = {"error": "skipped (card preflight negative)"}
        return False

    headline["rungs"] = {}
    r2048, err = None, "skipped"
    if gate("2048"):
        print("[bench] 2048px memory rung", file=sys.stderr)
        r2048, err = _try_rung("gpu_2048", "gpu", 2048, 18, 416, 1, 4,
                               min(1800, max(300, _time_left() - 300)), False, "cell", 1)
        _note_health(health, r2048, err)
        headline["rungs"]["2048"] = _rung_summary(r2048, err, BASELINE_2048,
                                                  "vs_baseline_cluster_2048")
    if gate("2048_bs2"):
        print("[bench] 2048px bs2 rung", file=sys.stderr)
        r, errs = _remat_ladder("gpu_2048_bs2", 2048, ["cell", "fine"], 4, 2, 1500, health)
        headline["rungs"]["2048_bs2"] = _rung_summary(r, errs, BASELINE_2048_BS2,
                                                      "vs_baseline_cluster_2048_bs2")
    for bname, bs in (("1024_bs2", 2), ("1024_bs4", 4), ("1024_bs8", 8)):
        if not gate(bname):
            continue
        print(f"[bench] 1024px bs{bs} rung", file=sys.stderr)
        r, errs = _remat_ladder(f"gpu_{bname}", 1024, ["none", "cell"], 2 * bs, bs, 1200,
                                health)
        headline["rungs"][bname] = _rung_summary(
            r, errs, BASELINE_1024_BS2 if bs == 2 else None,
            "vs_baseline_cluster_1024_bs2" if bs == 2 else "vs_baseline")
    for rname, rpx, rbase in (("resnet_1024", 1024, BASELINE_RESNET_1024),
                              ("resnet_2048", 2048, BASELINE_RESNET_2048)):
        if _time_left() < 300:
            headline["rungs"][rname] = {"error": "bench deadline reached"}
            continue
        if not gate(rname):
            continue
        print(f"[bench] {rname} rung", file=sys.stderr)
        args = (f"gpu_{rname}", "gpu", rpx, 110, 0, 1, 4)
        r, e = _try_rung(*args, min(1200, max(300, _time_left() - 300)), False, "sqrt", 1,
                         "resnet")
        if (r is None and rname == "resnet_2048" and re.search(_OOM_RE, e or "")
                and os.environ.get("MPI4DL_REMAT_OPS") != "1" and _time_left() >= 300):
            print("[bench] resnet_2048 OOM — retrying with MPI4DL_REMAT_OPS=1",
                  file=sys.stderr)
            os.environ["MPI4DL_REMAT_OPS"] = "1"
            try:
                r2, e2 = _try_rung(*args, min(1200, max(300, _time_left() - 300)), False,
                                   "sqrt", 1, "resnet")
            finally:
                os.environ.pop("MPI4DL_REMAT_OPS", None)
            r, e = (r2, None) if r2 is not None else (None, f"{e}; remat_ops retry: {e2}")
        _note_health(health, r, e)
        headline["rungs"][rname] = _rung_summary(r, e, rbase, f"vs_baseline_cluster_{rname}")
    print("[bench] max-resolution probe", file=sys.stderr)
    rung_ok = bool(r2048 is not None and not r2048.get("error"))
    known = 2048 if rung_ok else 0
    for k, v in ((_load_measured() or {}).get("rungs") or {}).items():
        if k.startswith("probe_") and v.get("ok"):
            try:
                known = max(known, int(k.split("_", 1)[1]))
            except ValueError:
                pass
    best, attempts = _max_trainable_px(start=1024 if not known else 2048, known_fit=known,
                                       gate=health.check, note_ok=health.note_success)
    headline["max_trainable_px"] = best
    headline["max_trainable_px_attempts"] = attempts


def _parse(argv):
    """``(options, rest)``: ``--telemetry-dir``, ``--measured``,
    ``--device`` taken out of ``argv``."""
    opts, rest, i = {}, [], 0
    while i < len(argv):
        if argv[i] in ("--telemetry-dir", "--measured", "--device"):
            if i + 1 >= len(argv):
                raise SystemExit(f"[bench] {argv[i]} needs a value")
            opts[argv[i][2:]] = argv[i + 1]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    return opts, rest


def main(argv=None) -> int:
    global MEASURED_PATH
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, rest = _parse(argv)
    if "telemetry-dir" in opts:
        os.environ["BENCH_TELEMETRY_DIR"] = opts["telemetry-dir"]  # the rungs inherit it
    if "measured" in opts:
        MEASURED_PATH = os.path.abspath(opts["measured"])
    if rest[:1] == ["--inner"]:
        platform, image_size, num_layers, num_filters, warmup, iters, comp = rest[1:8]
        remat = rest[8] if len(rest) > 8 else "cell"
        batch = int(rest[9]) if len(rest) > 9 else 1
        arch = rest[10] if len(rest) > 10 else "amoeba"
        _inner(platform, int(image_size), int(num_layers), int(num_filters), int(warmup),
               int(iters), comp == "1", remat, batch, arch)
        return 0
    if rest[:1] == ["--probe"]:
        _inner_probe(int(rest[1]))
        return 0
    if opts.get("device", "cuda") == "cpu":
        # Tests only: the JAX package's CPU smoke rung, in this process.
        _inner(*CPU_SMOKE[1:7], *CPU_SMOKE[8:])
        return 0

    card = card_line()
    print(f"[bench] card: {card}", file=sys.stderr, flush=True)
    failures, headline, health = [], None, _CardHealth()
    for rung in LADDER:
        left = _time_left()
        if left < 390:
            failures.append(f"{rung[0]}: skipped (deadline leaves <300s budget)")
            continue
        if not health.check():
            why = NO_CARD if health.absent else "card preflight negative"
            failures.append(f"{rung[0]}: skipped ({why})")
            print(f"[bench] skipping {rung[0]} — {why}", file=sys.stderr)
            continue
        if _time_left() - 60 < 300:
            failures.append(f"{rung[0]}: skipped (deadline leaves <300s budget)")
            continue
        rung = (*rung[:7], min(rung[7], int(_time_left() - 60)), *rung[8:])
        print(f"[bench] trying rung {rung[0]}", file=sys.stderr)
        result, err = _try_rung(*rung)
        if result is not None:
            headline = dict(result, rung=rung[0])
            health.note_success()
            break
        health.note_rung_failure()
        failures.append(err)
        print(f"[bench] rung failed: {err}", file=sys.stderr)
    if headline is None:
        headline = {
            "metric": "amoebanetd_train_img_per_sec_single_chip",
            "value": 0, "unit": "images/sec", "vs_baseline": None,
            "platform": "none", "device_kind": card,
            "error": "; ".join(f for f in failures if f)[-500:] or "no rung ran",
        }
    elif os.environ.get("BENCH_SKIP_MEMORY_RUNGS") != "1" and _time_left() >= 300:
        _extra_rungs(headline, health)
    if failures:
        headline["ladder_failures"] = [f for f in failures if f][-6:]
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

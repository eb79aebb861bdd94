"""Failure flight recorder (the port's copy of the JAX package's
``runtime/flight.py``): every fatal failure leaves a self-contained
diagnostics bundle.

The reference debugs production faults with the CUPTI fault-injection
tool plus NVTX timelines — but those require a live repro. A serving
stack needs the post-mortem form: when a task dies, the process must
leave behind everything a remote engineer needs, without anyone
re-running anything. This module is that recorder. Arm it with::

    SPARK_JNI_TPU_FLIGHT=/var/log/sprt_flight

and a ``RetryOOMError`` (recorded at raise time,
``resource._retry_oom``), a ``CapacityExceededError`` or ANY other
exception escaping a ``resource.task`` scope (recorded by the scope's
exception hook) atomically writes one bundle directory::

    flight_<UTC stamp>_p<pid>_<seq>[_task<id>]/
        MANIFEST.json        what/when/why + file list
        error.json           exception type/message/traceback + the
                             task's TaskMetrics (attempt trail capped)
        span_stack.json      the ACTIVE causal span stack at failure
                             (runtime/spans.py) — where the program was
        journal_tail.jsonl   last <=JOURNAL_TAIL events, schema-v2
                             lines (includes the fault/overflow trail)
        metrics.json         full registry snapshot (counters/gauges/
                             timers)
        plan_cache.json      pipeline plan-cache table: chain
                             signatures, static plans, hit counts
        devices.json         device topology (id/platform/kind/process)
        env.json             SPARK_JNI_TPU_* / CUDA_* / TORCH_* config
                             + interpreter and torch versions
        sampler.txt          the span-stack sampler's collapsed stacks
                             (runtime/sampler.py: the last capture,
                             else the cumulative table; empty when the
                             sampler never ran)

Crash-safety and bounds: the bundle is staged under a dot-tmp name and
``os.replace``d into place (a reader never sees a half bundle); the
journal tail is capped at ``JOURNAL_TAIL`` events and the TaskMetrics
attempt trail at ``MAX_ATTEMPTS``; only the newest ``MAX_BUNDLES``
bundles are kept (older ones are pruned). Recording NEVER raises into
the failing workload — any internal error degrades to one warning —
and each exception records at most once (``maybe_record`` marks the
exception object), so the raise-site hook and the scope-escape hook
cannot double-write.

Slow-job trigger (ISSUE 17): a bundle is not only for failures. With::

    SPARK_JNI_TPU_SLO_FLIGHT=<multiplier>      # e.g. 3.0

armed (alongside ``SPARK_JNI_TPU_FLIGHT``), the serving driver calls
``record_slow_job`` for a job whose e2e wall exceeded ``multiplier`` ×
its admission-time latency estimate, or its own ``deadline_s`` — the
job SUCCEEDED, but outside its SLO, and the tail-latency outlier must
be diagnosable after the fact. The bundle has the same layout plus one
extra file, ``slo.json``: the job's identity, its time-in-state
breakdown (queued / dispatch / device / retire ms), and its resolved
span tree (the job span and every slice under it). The serving driver
records at most one bundle per job, so a persistently slow tenant
cannot flood the recorder past ``MAX_BUNDLES``.

With the env var unset the cost is one ``os.environ.get`` per recorded
failure path — nothing on the happy path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import shutil
import sys
import threading
import time
import traceback
from typing import Optional

_ENV_VAR = "SPARK_JNI_TPU_FLIGHT"
_LOG = logging.getLogger("spark_rapids_jni_tpu_torch.flight")

JOURNAL_TAIL = 2048  # events kept in the bundle's journal tail
MAX_ATTEMPTS = 50  # TaskMetrics attempt records kept in error.json
MAX_BUNDLES = 8  # newest bundles kept under the flight dir

# opt-in declaration (scalars are not container state, but the bundle
# sequence must stay collision-free across threads — ISSUE 11 makes
# the lock association machine-checked)
# sprtcheck: guarded-by=_seq_lock
_seq = 0
_seq_lock = threading.Lock()


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def flight_dir() -> Optional[str]:
    """The armed flight directory, or None when recording is off."""
    d = os.environ.get(_ENV_VAR, "").strip()
    return d or None


SLO_ENV_VAR = "SPARK_JNI_TPU_SLO_FLIGHT"


def slo_multiplier() -> Optional[float]:
    """The slow-job trigger's arming: ``SPARK_JNI_TPU_SLO_FLIGHT`` as
    a positive float multiplier over the job's admission-time latency
    estimate. None when unset, disabled, or unparseable (a typo must
    not arm the trigger with a garbage threshold)."""
    raw = os.environ.get(SLO_ENV_VAR, "").strip()
    if not raw or raw.lower() in ("off", "false", "none", "no", "0"):
        return None
    try:
        v = float(raw)
    except ValueError:
        _LOG.warning(
            "unparseable %s value %r (expected a multiplier); slow-job "
            "trigger stays off", SLO_ENV_VAR, raw,
        )
        return None
    return v if v > 0 else None


class SlowJobSLO(Exception):
    """The slow-job trigger's synthetic bundle reason: the job
    COMPLETED, but outside its SLO. Never raised — it exists so the
    bundle's error.json/MANIFEST name the violation the way every
    other bundle names its exception."""


def record_slow_job(
    *,
    session: str,
    job_id: int,
    e2e_ms: float,
    threshold_ms: float,
    reason: str,
    breakdown: dict,
    span_tree: list,
    task=None,
) -> Optional[str]:
    """Record one slow-job bundle (armed via ``SPARK_JNI_TPU_FLIGHT``
    like every bundle): the ordinary layout plus ``slo.json`` carrying
    the job's time-in-state ``breakdown`` and its resolved
    ``span_tree``. The caller (serving/server.py) guarantees at most
    one call per job; this function never raises."""
    root = flight_dir()
    if root is None:
        return None
    exc = SlowJobSLO(
        f"job {job_id} (session {session!r}) e2e {e2e_ms:.1f} ms "
        f"exceeded its {reason} threshold {threshold_ms:.1f} ms"
    )
    try:
        path = _write_bundle(exc, task, root, extra={
            "slo.json": {
                "session": session,
                "job": job_id,
                "e2e_ms": round(float(e2e_ms), 3),
                "threshold_ms": round(float(threshold_ms), 3),
                "reason": reason,
                "breakdown": breakdown,
                "span_tree": span_tree,
            },
        })
    except Exception as e:  # noqa: BLE001 — never fail the workload
        _LOG.warning("flight recorder failed to write a bundle: %s", e)
        return None
    from . import metrics as _metrics

    _metrics.counter("flight.bundles").inc()
    _LOG.warning("flight recorder: slow job -> %s", path)
    return path


def maybe_record(exc: BaseException, task=None) -> Optional[str]:
    """Record ``exc`` into a bundle if the recorder is armed and this
    exception was not already recorded (the raise-site hook runs before
    the scope-escape hook for the same exception). Returns the bundle
    path, the previously recorded path, or None. Never raises."""
    root = flight_dir()
    if root is None:
        return None
    prev = getattr(exc, "_sprt_flight_bundle", None)
    if prev is not None:
        # a RetryOOMError records at RAISE time, before __traceback__
        # exists; when the same exception reaches the scope-escape
        # hook carrying real frames, refresh the bundle's error.json
        # so the mailed artifact has the promised full traceback
        _maybe_refresh_error(prev, exc, task)
        return prev
    try:
        path = _write_bundle(exc, task, root)
    except Exception as e:  # noqa: BLE001 — never fail the workload
        _LOG.warning("flight recorder failed to write a bundle: %s", e)
        return None
    with contextlib.suppress(Exception):  # exceptions with __slots__
        exc._sprt_flight_bundle = path
    from . import metrics as _metrics

    _metrics.counter("flight.bundles").inc()
    _LOG.error(
        "flight recorder: %s -> %s", type(exc).__name__, path
    )
    return path


def _dump(d: str, name: str, obj) -> None:
    with open(os.path.join(d, name), "w") as f:
        json.dump(obj, f, indent=2, default=str)
        f.write("\n")


def _error_payload(exc: BaseException, task) -> dict:
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": traceback.format_exception(
            type(exc), exc, exc.__traceback__
        ),
        "task_id": getattr(task, "task_id", None),
        "task_metrics": _task_metrics_dict(task),
    }


def _maybe_refresh_error(bundle: str, exc: BaseException, task) -> None:
    """Atomically rewrite an existing bundle's error.json once ``exc``
    has a populated traceback (it had none at the raise-time record).
    Never raises."""
    if exc.__traceback__ is None:
        return
    try:
        path = os.path.join(bundle, "error.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_error_payload(exc, task), f, indent=2, default=str)
            f.write("\n")
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — refresh is best-effort
        pass


def _task_metrics_dict(task) -> Optional[dict]:
    m = getattr(task, "metrics", None)
    if m is None:
        return None
    try:
        d = dataclasses.asdict(m)
    except Exception:  # noqa: BLE001
        return {"repr": repr(m)}
    attempts = d.get("attempts") or []
    if len(attempts) > MAX_ATTEMPTS:
        d["attempts_truncated"] = len(attempts) - MAX_ATTEMPTS
        d["attempts"] = attempts[-MAX_ATTEMPTS:]
    return d


def _device_topology() -> list:
    import torch

    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu", "process_index": 0}]
    return [
        {
            "id": i,
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(i),
            "process_index": 0,
        }
        for i in range(torch.cuda.device_count())
    ]


def _env_config() -> dict:
    cfg = {
        k: v
        for k, v in sorted(os.environ.items())
        if k.startswith(("SPARK_JNI_TPU", "SRJT_", "CUDA_", "TORCH_", "PYTORCH_"))
        or k == "FAULT_INJECTOR_CONFIG_PATH"
    }
    cfg["python"] = sys.version
    try:
        import torch

        cfg["torch"] = torch.__version__
        cfg["torch_cuda"] = torch.version.cuda
    except Exception:  # noqa: BLE001
        pass
    return cfg


def _write_bundle(
    exc: BaseException, task, root: str, extra: Optional[dict] = None
) -> str:
    seq = _next_seq()
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp_{os.getpid()}_{seq}")
    # sprtcheck: acquires=tmp-staging-dir release=rmtree,_fill_and_commit
    os.makedirs(tmp, exist_ok=True)
    try:
        return _fill_and_commit(tmp, exc, task, root, seq, extra)
    except BaseException:
        # a half-written staging dir (ENOSPC is LIKELY under the very
        # failures this records) must not leak — _prune only manages
        # flight_* names
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _fill_and_commit(
    tmp: str,
    exc: BaseException,
    task,
    root: str,
    seq: int,
    extra: Optional[dict] = None,
) -> str:
    from . import events as _events
    from . import metrics as _metrics
    from . import spans as _spans

    task_id = getattr(task, "task_id", None)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    final_name = f"flight_{stamp}_p{os.getpid()}_{seq}"
    if task_id is not None:
        final_name += f"_task{task_id}"

    # the failure itself + where the program was
    _dump(tmp, "error.json", _error_payload(exc, task))
    _dump(tmp, "span_stack.json", _spans.active_stack())

    # where the process was SPENDING ITS TIME: the sampling profiler's
    # collapsed stacks (runtime/sampler.py: last capture, else the
    # cumulative table; empty when the sampler never ran). A mailed-in
    # bundle answers "where was it stuck" as well as "what failed".
    try:
        from . import sampler as _sampler

        with open(os.path.join(tmp, "sampler.txt"), "w") as f:
            f.write(_sampler.flight_text())
    except Exception as e:  # noqa: BLE001 — recording never raises
        with open(os.path.join(tmp, "sampler.txt"), "w") as f:
            f.write(f"# sampler read failed: {e}\n")

    # journal tail: schema lines, crash-ordered, bounded
    tail = _events.recent(JOURNAL_TAIL)
    with open(os.path.join(tmp, "journal_tail.jsonl"), "w") as f:
        for rec in tail:
            f.write(json.dumps(rec, default=str) + "\n")

    _dump(tmp, "metrics.json", _metrics.snapshot())

    # plan cache: which fused chains were live, with what static
    # knobs, how hot, and each plan's capacity-feedback state
    # (observed sizes / buckets / tighten-widen counts — ISSUE 10)
    # (runtime/pipeline.py plan_cache_table)
    try:
        from . import pipeline as _pipeline  # late: avoids import cycle

        _dump(tmp, "plan_cache.json", _pipeline.plan_cache_table())
    except Exception as e:  # noqa: BLE001
        _dump(tmp, "plan_cache.json", {"error": str(e)})

    # explain.txt (ISSUE 20): the rendered EXPLAIN of every plan the
    # FAILING TASK touched (its scope accumulated the signature hashes
    # at plan-cache lookup time), falling back to every live plan when
    # the failure has no task scope — "a user mails you a bundle" must
    # resolve the plan-shaped failures without a live process
    try:
        from . import pipeline as _pipeline  # late: avoids import cycle

        rows = _pipeline.plan_cache_table()
        touched = getattr(task, "plans_touched", None)
        if touched:
            mine = [r for r in rows if r["sig"] in touched]
            rows = mine or rows  # evicted-plan fallback: show all
        header = (
            f"# plans touched by task {task_id}\n" if touched
            else "# no task scope: all live plans\n"
        )
        with open(os.path.join(tmp, "explain.txt"), "w") as f:
            f.write(header + _pipeline.render_plan_rows(rows))
    except Exception as e:  # noqa: BLE001
        with open(os.path.join(tmp, "explain.txt"), "w") as f:
            f.write(f"# explain render failed: {e}\n")

    # executor-side planner state, next to the chain plans: the
    # feedback memo rows (what size each (op, site) converged to) and
    # the warm program cache (which jitted executor wrappers were
    # live, their hit counts and build walls — ISSUE 14)
    try:
        from . import resource as _resource  # late: avoids import cycle

        _dump(tmp, "exec_plans.json", {
            "exec_feedback": _resource.exec_feedback_table(),
            "exec_programs": _resource.program_cache_table(),
        })
    except Exception as e:  # noqa: BLE001
        _dump(tmp, "exec_plans.json", {"error": str(e)})

    try:
        _dump(tmp, "devices.json", _device_topology())
    except Exception as e:  # noqa: BLE001
        _dump(tmp, "devices.json", {"error": str(e)})

    _dump(tmp, "env.json", _env_config())

    # trigger-specific payload (the slow-job trigger's slo.json):
    # written before the MANIFEST so the files list covers it
    for name, obj in (extra or {}).items():
        _dump(tmp, name, obj)

    files = sorted(os.listdir(tmp))
    _dump(tmp, "MANIFEST.json", {
        "bundle_schema": 1,
        "created_unix": time.time(),
        "created_utc": stamp,
        "reason": type(exc).__name__,
        "message": str(exc)[:500],
        "task_id": task_id,
        "journal_tail_events": len(tail),
        "journal_dropped": _events.dropped(),
        "files": files + ["MANIFEST.json"],
    })

    final = os.path.join(root, final_name)
    if os.path.exists(final):  # same second + pid collision: suffix
        final = f"{final}b"
    os.replace(tmp, final)
    _prune(root)
    return final


# --------------------------------------------------------------------
# bundle index: the ONE reader of a flight dir's bundle listing,
# shared by the CLI table below and the diag /flight endpoint
# (runtime/diag.py) so the two cannot drift


def _bundle_row(path: str) -> dict:
    row = {
        "bundle": os.path.basename(path),
        "mtime": os.path.getmtime(path),
        "reason": "?",
        "message": None,
        "task_id": None,
        "created_utc": None,
        "spans": 0,
    }
    try:
        with open(os.path.join(path, "MANIFEST.json")) as f:
            man = json.load(f)
        row["reason"] = man.get("reason", "?")
        row["message"] = man.get("message")
        row["task_id"] = man.get("task_id")
        row["created_utc"] = man.get("created_utc")
    except (OSError, json.JSONDecodeError):
        pass
    try:
        with open(os.path.join(path, "span_stack.json")) as f:
            row["spans"] = len(json.load(f))
    except (OSError, json.JSONDecodeError):
        pass
    return row


def bundle_index(root: Optional[str] = None) -> list:
    """Newest-first rows (bundle, mtime, reason, message, task_id,
    created_utc, spans) for every flight_* bundle under ``root``
    (default: the armed dir). Empty when unarmed/missing."""
    root = root if root is not None else flight_dir()
    if root is None or not os.path.isdir(root):
        return []
    rows = []
    for n in os.listdir(root):
        if not n.startswith("flight_"):
            continue
        try:
            rows.append(_bundle_row(os.path.join(root, n)))
        except OSError:
            # pruned by a recording process between listdir and stat —
            # list the survivors, never raise into a reader
            continue
    return sorted(rows, key=lambda r: -r["mtime"])


# --------------------------------------------------------------------
# CLI: ``python -m spark_rapids_jni_tpu_torch.flight ls|show <bundle>`` —
# the "a user mailed you a bundle dir" reader (the traceview CLI's
# convention: rc 2 on a missing/empty input, rc 0 otherwise)


def _cli_ls(root: str) -> int:
    if not os.path.isdir(root):
        print(f"error: flight dir {root} does not exist", file=sys.stderr)
        return 2
    rows = bundle_index(root)
    if not rows:
        print(f"error: no flight_* bundles under {root}", file=sys.stderr)
        return 2
    w_name = max(len(r["bundle"]) for r in rows)
    w_reason = max(len("error"), max(len(str(r["reason"])) for r in rows))
    print(f"{'bundle':<{w_name}}  {'time (utc)':<15}  "
          f"{'error':<{w_reason}}  {'task':>5}  {'spans':>5}")
    for r in rows:
        stamp = time.strftime(
            "%m-%dT%H:%M:%SZ", time.gmtime(r["mtime"])
        )
        task = "-" if r["task_id"] is None else str(r["task_id"])
        print(f"{r['bundle']:<{w_name}}  {stamp:<15}  "
              f"{str(r['reason']):<{w_reason}}  {task:>5}  {r['spans']:>5}")
    return 0


def _cli_show(root: str, bundle: str) -> int:
    path = bundle if os.path.isdir(bundle) else os.path.join(root, bundle)
    if not os.path.isdir(path):
        print(f"error: no such bundle: {bundle}", file=sys.stderr)
        return 2

    def load(name):
        try:
            with open(os.path.join(path, name)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return {"error": str(e)}

    man = load("MANIFEST.json")
    print(f"== {os.path.basename(path)} ==")
    print(json.dumps(man, indent=2, default=str))
    err = load("error.json")
    print("\n-- error --")
    print(f"{err.get('type')}: {err.get('message')}")
    tb = err.get("traceback") or []
    if tb:
        print("".join(tb[-8:]).rstrip())
    m = err.get("task_metrics")
    if m:
        print(f"task {err.get('task_id')}: retries={m.get('retries')} "
              f"injected_ooms={m.get('injected_ooms')} "
              f"peak_bytes={m.get('peak_bytes')}")
    print("\n-- span stack at failure --")
    for s in load("span_stack.json") or []:
        if isinstance(s, dict):
            print(f"  {s.get('kind')}: {s.get('name')} "
                  f"(span {s.get('sid')}, task {s.get('task_id')})")
    print("\n-- journal tail --")
    counts: dict = {}
    last = []
    try:
        with open(os.path.join(path, "journal_tail.jsonl")) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                counts[rec.get("event")] = counts.get(rec.get("event"), 0) + 1
                last.append(rec)
    except OSError as e:
        print(f"  (unreadable: {e})")
    for ev, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"  {ev:<20} {n}")
    for rec in last[-5:]:
        print(f"  ... {rec.get('event')} op={rec.get('op')} "
              f"span={rec.get('span_id')} attrs={rec.get('attrs')}")
    samp = os.path.join(path, "sampler.txt")
    if os.path.exists(samp):
        with open(samp) as f:
            txt = f.read().strip()
        print("\n-- sampler (where it was stuck) --")
        if txt:
            for line in txt.splitlines()[:5]:
                print(f"  {line}")
        else:
            print("  (sampler was not armed)")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.flight",
        description="Read failure flight-recorder bundles "
        "(docs/OBSERVABILITY.md): ls the bundle dir, show one bundle.",
    )
    ap.add_argument("cmd", choices=["ls", "show"])
    ap.add_argument(
        "bundle", nargs="?", default=None,
        help="bundle name or path (show); optional dir override (ls)",
    )
    ap.add_argument(
        "--dir", default=None,
        help=f"flight dir (default: ${_ENV_VAR})",
    )
    args = ap.parse_args(argv)
    root = args.dir or (args.bundle if args.cmd == "ls" and args.bundle
                        else None) or flight_dir() or ""
    if args.cmd == "ls":
        if not root:
            print(f"error: no flight dir ({_ENV_VAR} unset; pass a dir)",
                  file=sys.stderr)
            return 2
        return _cli_ls(root)
    if args.bundle is None:
        print("error: show needs a bundle name or path", file=sys.stderr)
        return 2
    if not root and not os.path.isdir(args.bundle):
        print(f"error: no flight dir ({_ENV_VAR} unset; pass a path)",
              file=sys.stderr)
        return 2
    return _cli_show(root, args.bundle)


def _prune(root: str) -> None:
    """Keep THIS process's newest MAX_BUNDLES bundles (sequence
    order), and sweep stale ``.tmp_*`` staging dirs (>10 min old:
    other processes' crashed half-writes — a LIVE staging dir is
    seconds old).

    Per-process-safe (ISSUE 16 satellite): pruning only our own
    ``_p<pid>_`` bundles means a chaos storm of N concurrent failing
    workers leaves each failure's bundle resolvable — a global
    newest-8 policy would let one noisy process clobber every other
    tenant's evidence. Ordering uses the monotonic per-process ``_seq``
    baked into the name, not mtime: two of our bundles can share an
    mtime tick, and a concurrent writer replacing entries mid-scan
    would make getmtime raise inside sorted()."""
    me = f"_p{os.getpid()}_"

    def _seq_of(name: str) -> int:
        try:
            return int(name.split(me, 1)[1].split("_", 1)[0])
        except (IndexError, ValueError):
            return -1

    # noqa-SIM105 below: the GC sweep is a multi-branch body with its
    # own inner per-entry handling — a suppress() wrapper would hide
    # which step the best-effort contract actually covers
    try:  # noqa: SIM105
        mine = sorted(
            (n for n in os.listdir(root)
             if n.startswith("flight_") and me in n),
            key=_seq_of,
        )
        for old in mine[: max(0, len(mine) - MAX_BUNDLES)]:
            shutil.rmtree(os.path.join(root, old), ignore_errors=True)
        now = time.time()
        for n in os.listdir(root):
            if n.startswith(".tmp_"):
                p = os.path.join(root, n)
                try:
                    stale = now - os.path.getmtime(p) > 600
                    # a foreign process's live staging dir: never touch
                    if stale:
                        shutil.rmtree(p, ignore_errors=True)
                except OSError:
                    continue  # racing writer committed it already
    except OSError:
        pass

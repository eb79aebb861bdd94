"""Closed-loop executor tasks, the one traffic generator.

``tasks`` threads run at once, as a Spark executor's concurrent GPU tasks
do, each on a CUDA stream of its own. A pass is one query over the
configuration's batches: task k takes batches k, k + tasks, ... of the
pass and calls the entry once per batch; its next call comes only after
the result is on the host. When every task has finished its share, the
next pass begins. A query with a first stage of its own in each pass
(``query.begin_pass()``: q5's broadcast build side) runs it before any
task takes a batch of the pass, on the stream of the last task to arrive
at the pass's start, and the tasks wait for it: it is part of the pass,
and of the window's time. Each finished pass's partial results go through the
query's final merge (Spark's final aggregate and ORDER BY) once the
tasks have stopped, outside the timed window (the last pass and two
more drawn from the seed, since every pass merges the same batches): on the card q1's merge is
host-bound and its time varied 120-157 ms from run to run, against a
steady 46.6 ms a batch, so on the tasks' path it set the rate's spread
(1-4 %), and beside them the batch tail's (6-11 %). The merges' answers
are held to the reference like the batches'.

A traffic mix's file (``traffic/<mix>.json``) gives ``tasks``,
``batch_rows`` (read by the configuration's side), ``entry`` (which of
the query's entries the tasks call) and ``profile_batches`` (the batches
of a traced run's profiled slice).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

# a task waits this long for the others at the end of a pass
BARRIER_TIMEOUT_S = 600.0


class Log:
    """What a drive saw: one record per batch call (pass, batch index,
    rows, host-clock start and end, the answer on the host or the
    error), one per pass's first stage (pass, start, end) and one per
    final merge (pass, the batch indices merged, start, end, answer or
    error)."""

    def __init__(self):
        self.batches = []
        self.stages = []
        self.finals = []


def warm_schedule(batches, n_tasks: int) -> list:
    """One pass that gives every task one batch of each distinct size:
    task k's share of it is batch k and the last batch."""
    # drive deals the pass's list[k::n_tasks] to task k
    return [k % len(batches) for k in range(n_tasks)] + [len(batches) - 1] * n_tasks


def drive(query, entry, n_tasks: int, pass_batches, *, passes=None, deadline=None,
          streams=None, merge=True, pick=None, begin=True) -> Log:
    """Run passes over ``pass_batches`` (batch indices) with ``n_tasks``
    tasks (task k on ``streams[k]``; None on the CPU): ``passes`` of
    them, or until ``deadline`` on ``time.perf_counter``. Each pass
    starts with the query's first stage, if it has one and ``begin``
    holds (False: the pass reuses the last one's). A task that finds the
    deadline passed starts no further batch; a pass cut by the deadline
    is not merged. Then the merges of the finished passes, in order, or
    of those that ``pick(finished passes)`` returns. A first stage that
    raises ends the drive with the error."""
    clock = time.perf_counter
    log = Log()
    lock = threading.Lock()
    state = {"pass": 0, "stop": False, "parts": {}}
    finished = []  # (pass, its batch indices, their results) of every finished pass
    errors = []

    def begin_pass():
        if not begin or not hasattr(query, "begin_pass"):
            return
        t0 = clock()
        try:
            query.begin_pass()
            if streams:
                # the other tasks' streams read what it made
                torch.cuda.current_stream().synchronize()
        except Exception as e:
            errors.append(f"pass {state['pass']}'s first stage: {type(e).__name__}: {e}")
            raise
        log.stages.append({"pass": state["pass"], "start": t0, "end": clock()})

    def end_of_pass():
        parts, p = state["parts"], state["pass"]
        state["parts"] = {}
        state["pass"] = p + 1
        if merge and set(parts) == set(pass_batches) and (deadline is None or clock() < deadline):
            finished.append((p, sorted(parts), [parts[i] for i in sorted(parts)]))
        # the tasks read this after the barrier, all alike
        state["stop"] = ((passes is not None and state["pass"] >= passes)
                         or (deadline is not None and clock() >= deadline))

    starts = threading.Barrier(n_tasks, action=begin_pass)
    ends = threading.Barrier(n_tasks, action=end_of_pass)

    def wait(barrier, k) -> bool:
        try:
            barrier.wait(timeout=BARRIER_TIMEOUT_S)
            return True
        except threading.BrokenBarrierError:
            errors.append(f"task {k}: a pass's barrier broke")
        except Exception:  # noqa: BLE001 -- the first stage's error, in errors already
            pass
        return False

    def task(k):
        ctx = torch.cuda.stream(streams[k]) if streams else contextlib.nullcontext()
        with ctx:
            while True:
                if not wait(starts, k):
                    return
                p = state["pass"]
                for i in pass_batches[k::n_tasks]:
                    if deadline is not None and clock() >= deadline:
                        break
                    t0 = clock()
                    try:
                        res = entry(i)
                        answer, error = query.answer(res), None
                    except Exception as e:  # noqa: BLE001 -- counted as a failed batch
                        res, answer, error = None, None, f"{type(e).__name__}: {e}"
                    t1 = clock()
                    with lock:
                        log.batches.append({"pass": p, "index": i,
                                            "rows": query.batch_rows(i), "start": t0,
                                            "end": t1, "answer": answer, "error": error})
                        if res is not None:
                            state["parts"][i] = res
                if not wait(ends, k) or state["stop"]:
                    return

    threads = [threading.Thread(target=task, args=(k,), name=f"task{k}")
               for k in range(n_tasks)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(BARRIER_TIMEOUT_S * 2)
    if any(th.is_alive() for th in threads) or errors:
        raise RuntimeError(f"the tasks did not end: {errors}")
    todo = finished if pick is None else pick(finished)
    del finished
    while todo:
        p, indices, results = todo.pop(0)
        t0 = clock()
        try:
            answer, error = query.merge(results), None
        except Exception as e:  # noqa: BLE001 -- an error is a failed answer
            answer, error = None, f"{type(e).__name__}: {e}"
        del results  # a pass's partials go once merged
        log.finals.append({"pass": p, "indices": indices, "start": t0, "end": clock(),
                           "answer": answer, "error": error})
    return log

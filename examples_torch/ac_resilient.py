"""Allen-Cahn under chaos: the end-to-end resilience demo (the JAX
package's ``examples/ac_resilient.py``).

One supervised training run survives an injected NaN divergence (rollback
-> remedy ladder -> retry) and an injected preemption (final checkpoint
flush -> in-process resume), completes its budget, and leaves a run log
whose report narrates every failure and every heal.  Then a serving leg
under an injected fault rate shows transient op failures healing behind
retry, the circuit breaker opening and closing around a sustained outage,
and no hung waiter.
"""

import os
import shutil
import tempfile

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import telemetry
from tensordiffeq_tpu_torch.resilience import (Chaos, ChaosFault,
                                               CircuitBreaker,
                                               CircuitOpenError,
                                               ResilientFit, RetryPolicy)
from tensordiffeq_tpu_torch.serving import RequestBatcher
from tensordiffeq_tpu_torch.telemetry import RunLogger, read_events


def main():
    args = example_args("Allen-Cahn resilience demo: chaos-injected "
                        "divergence + preemption + serving faults, all "
                        "recovered",
                        runs=("", "directory for the run log and the "
                                  "checkpoint (default: a temporary one)"))
    from ac_baseline import build_sa_solver

    n_f = scaled(args, 10_000, 512)
    nx, nt = (64, 16) if args.quick else (512, 201)
    widths = [16, 16] if args.quick else [64, 64, 64]
    tf_iter = scaled(args, 2_000, 40)
    chunk = scaled(args, 100, 10)
    ck_every = chunk
    nan_at = scaled(args, 500, 15)        # divergence mid-run
    preempt_at = scaled(args, 1_500, 25)  # preemption later in the run

    root = args.runs or tempfile.mkdtemp(prefix="ac_resilient_")
    run_dir = os.path.join(root, "ac_resilient")
    ck = os.path.join(root, "ac_resilient_ckpt")
    for d in (run_dir, ck, ck + ".old", ck + ".tmp"):
        shutil.rmtree(d, ignore_errors=True)

    solver = build_sa_solver(n_f, nx, nt, widths, verbose=not args.quick,
                             device=args.device)

    with RunLogger(run_dir, config={"n_f": n_f, "tf_iter": tf_iter,
                                    "nan_at": nan_at,
                                    "preempt_at": preempt_at}) as logger:
        with Chaos(nan_epoch=nan_at, preempt_epoch=preempt_at,
                   seed=0) as chaos:
            rf = ResilientFit(solver, ck, checkpoint_every=ck_every,
                              max_retries=3, telemetry=logger,
                              resume_on_preemption=True)
            rf.fit(tf_iter=tf_iter, newton_iter=0, chunk=chunk)
        print(f"\n[resilient] chaos fired: {chaos.fired}")
        print(f"[resilient] recoveries: {rf.recoveries}, "
              f"preemptions resumed: {rf.preemptions_resumed}")
        print(f"[resilient] trained {len(solver.losses)}/{tf_iter} epochs, "
              f"final loss {solver.losses[-1]['Total Loss']:.3e}")

        engine = solver.export_surrogate().engine(
            min_bucket=64, max_bucket=256 if args.quick else 1024)
        batcher = RequestBatcher(
            engine, max_batch=256, max_latency_s=0.005,
            retry=RetryPolicy(max_attempts=4, base_delay_s=1e-3,
                              max_delay_s=1e-2, seed=0),
            breaker=CircuitBreaker(failure_threshold=8, reset_timeout_s=0.05),
            request_timeout_s=5.0)
        rng = np.random.RandomState(0)
        n_req = scaled(args, 400, 60)
        with Chaos(serving_fail_rate=0.25, seed=1) as serving_chaos:
            for _ in range(n_req):
                n = int(rng.randint(1, 17))
                X = np.stack([rng.uniform(-1, 1, n),
                              rng.uniform(0, 1, n)], -1).astype(np.float32)
                try:
                    batcher.submit(X)
                    batcher.poll()
                except (ChaosFault, CircuitOpenError):
                    pass  # an injected fault past retries: in the stats
            try:
                batcher.flush()
            except (ChaosFault, CircuitOpenError):
                pass
        stats = batcher.stats()
        print(f"[resilient] serving: {stats['requests']} served, "
              f"{stats['retried_ok']} batches healed by retry, "
              f"{stats['failed']} failed, {stats['timed_out']} timed out, "
              f"{stats['rejected']} fast-failed by the breaker "
              f"({serving_chaos.fired['serving']} faults injected)")
        assert stats["timed_out"] == 0, "no waiter may hang"

    print()
    print(telemetry.report(run_dir))
    kinds = {e["kind"] for e in read_events(run_dir)}
    need = {"divergence", "rollback", "remedy", "checkpoint", "preempt",
            "resume"}
    missing = need - kinds
    assert not missing, f"run log missing {missing}"
    print(f"\n[resilient] the run log at {run_dir}/events.jsonl holds the "
          "trail: " + ", ".join(sorted(need)))
    if os.environ.get("TDQ_KEEP_RUNS") != "1":
        for d in (ck, ck + ".old", ck + ".tmp"):
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()

"""GreenFaaS online arrivals on the PyTorch/CUDA port: tasks stream in over
several arrival windows; the engine places each window against the live
endpoint timelines (one launch of the window kernel on the card a window)
and feeds monitored energy back into the profile store, so the placement
mix shifts as profiles accumulate mid-workload.

    PYTHONPATH=src python examples/torch_online_arrivals.py               # the card
    PYTHONPATH=src python examples/torch_online_arrivals.py --device cpu  # plain PyTorch
"""
import argparse

from repro_torch.core.endpoint import table1_testbed
from repro_torch.core.engine import OnlineEngine
from repro_torch.core.scheduler import TaskSpec
from repro_torch.core.testbed import SEBS_FUNCTIONS, TestbedSim

N_WINDOWS = 4
TASKS_PER_WINDOW = 140


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the window kernel runs (default: the CUDA "
                         "card; 'cpu' runs its plain PyTorch version)")
    args = ap.parse_args()
    endpoints = table1_testbed()
    backend = TestbedSim(endpoints, seed=0)
    engine = OnlineEngine(
        endpoints,
        backend,
        policy="mhra",          # any name from available_policies()
        alpha=0.2,              # favor runtime (paper Fig. 6 trade-off)
        window_s=30.0,          # arrival-window batcher
        max_batch=512,
        monitoring=True,        # learn from attributed energy, not truth
        device=args.device,
    )

    print(f"device: {engine.device}")
    print(f"{'window':>6} {'tasks':>6} {'sched_ms':>9} {'profiles':>9}  placements")
    for w in range(N_WINDOWS):
        for i in range(TASKS_PER_WINDOW):
            engine.submit(
                TaskSpec(id=f"w{w}t{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)])
            )
        res = engine.flush()
        confident = sum(1 for n, _, _ in engine.store.stats().values() if n > 0)
        placements = ", ".join(
            f"{ep}:{n}" for ep, n in sorted(res.placements.items())
        )
        print(f"{res.index:>6} {len(res.tasks):>6} "
              f"{res.scheduling_s * 1e3:>9.1f} {confident:>9}  {placements}")

    s = engine.summary()
    print(f"\n{s.tasks} tasks over {s.windows} windows")
    print(f"cumulative makespan : {s.makespan_s:8.1f} s")
    print(f"scheduled energy    : {s.energy_j / 1e3:8.1f} kJ "
          f"(attributed to tasks: {s.attributed_j / 1e3:.1f} kJ)")
    print(f"total scheduling    : {s.scheduling_s * 1e3:8.1f} ms "
          f"({s.scheduling_s / s.tasks * 1e3:.2f} ms/task)")


if __name__ == "__main__":
    main()

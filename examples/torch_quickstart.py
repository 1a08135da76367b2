"""GreenFaaS quickstart on the PyTorch/CUDA port: monitor, attribute, and
schedule a task batch across the paper's four-machine testbed — then print
the energy report (the user-facing feedback of the paper's §III-G).

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain PyTorch

Cluster MHRA (the default strategy) places a window of multi-task clusters
with the host SoA engine; single-task windows go to the window kernel on
``--device``.
"""
import argparse

from repro_torch.core.endpoint import table1_testbed
from repro_torch.core.executor import GreenFaaSExecutor
from repro_torch.core.report import text_report
from repro_torch.core.scheduler import TaskSpec
from repro_torch.core.testbed import SEBS_FUNCTIONS, TestbedSim


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the window kernel runs (default: the CUDA "
                         "card; 'cpu' runs its plain PyTorch version)")
    args = ap.parse_args(argv)
    endpoints = table1_testbed()
    backend = TestbedSim(endpoints, seed=0)

    # alpha trades energy (1.0) against runtime (0.0) — paper Fig. 6;
    # strategy is any registered policy name
    executor = GreenFaaSExecutor(
        endpoints, backend, alpha=0.2, strategy="cluster_mhra",
        device=args.device,
    )
    # seed online profiles (the paper builds them from prior monitoring)
    executor.warmup(list(SEBS_FUNCTIONS), per_endpoint=2)

    tasks = [
        TaskSpec(id=f"t{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)],
                 inputs=(("desktop", 1, 100e6, True),))
        for i in range(200)
    ]
    result = executor.run_batch(tasks)

    print(f"device        : {executor.device}")
    print(f"makespan      : {result.makespan_s:8.1f} s")
    print(f"energy        : {result.measured_energy_j / 1e3:8.1f} kJ "
          f"(attributed to tasks: {result.attributed_energy_j / 1e3:.1f} kJ)")
    print(f"transfer      : {result.transfer_j / 1e3:8.2f} kJ")
    print(f"scheduling in : {result.scheduling_s * 1e3:8.1f} ms "
          f"({result.scheduling_s / len(tasks) * 1e3:.2f} ms/task)")
    print(f"EDP           : {result.edp():8.3e}")
    print()
    print(text_report(executor.db, user="user0"))


if __name__ == "__main__":
    main()

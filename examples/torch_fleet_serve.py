"""Serve a model fleet through GreenFaaS on the PyTorch/CUDA port: a wave of
inference jobs (prefill and decode batches of three archs) is placed across
a heterogeneous fleet of simulated TPU endpoints by Cluster MHRA, then the
first placed job is served for real, batched greedy decoding on the card.

    PYTHONPATH=src python examples/torch_fleet_serve.py                # the card, reduced granite
    PYTHONPATH=src python examples/torch_fleet_serve.py --full-width   # granite-3-2b, full width and depth
    PYTHONPATH=src python examples/torch_fleet_serve.py --device cpu

The wave's estimated makespan and energy are for the simulated TPU fleet
(``tpu_fleet``'s v5e constants), not for the card.  Without ``--dryrun
DIR`` no dry-run costs are read and the wave is placed on the profile
store's priors.  The port's dry-run writes the wave's costs into DIR (its
three cells, counted on meta tensors on the host, ~5 s)::

    for cell in granite-3-2b:decode_32k qwen3-14b:prefill_32k zamba2-2.7b:decode_32k; do
        PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ${cell%:*} \
            --shape ${cell#*:} --out DIR
    done
"""
import argparse
from collections import Counter

from repro_torch.core.endpoint import tpu_fleet
from repro_torch.fleet.manager import FleetJob, FleetManager
from repro_torch.launch.serve import serve_batch


def wave() -> list[FleetJob]:
    """A mixed serving wave: chat decode, long-doc prefill, batch scoring."""
    jobs = []
    for i in range(6):
        jobs.append(FleetJob(id=f"chat{i}", arch="granite-3-2b",
                             shape="decode_32k", steps=200))
    for i in range(3):
        jobs.append(FleetJob(id=f"doc{i}", arch="qwen3-14b",
                             shape="prefill_32k", steps=50))
    for i in range(2):
        jobs.append(FleetJob(id=f"score{i}", arch="zamba2-2.7b",
                             shape="decode_32k", steps=400))
    return jobs


def main(argv=None) -> dict:
    """Returns the wave's placement (``schedule``), the per-endpoint load
    and the served job with its tokens, prefill and decode seconds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-width", action="store_true",
                    help="serve the placed job at its full width and depth")
    ap.add_argument("--dryrun", default=None, metavar="DIR",
                    help="a directory of *__single.json dry-run costs")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)

    mgr = FleetManager(tpu_fleet(), args.dryrun, alpha=0.3, device=args.device)
    jobs = wave()
    schedule = mgr.place(jobs)
    print("fleet placement (Cluster MHRA; simulated TPU fleet):")
    for job in jobs:
        print(f"  {job.id:8s} {job.arch:16s} {job.shape:12s} -> "
              f"{schedule.assignments[job.id]}")
    load = dict(Counter(schedule.assignments.values()))
    print(f"per-endpoint load: {load}")
    print(f"estimated makespan {schedule.makespan_s:.0f} s, "
          f"energy {schedule.energy_j/1e3:.0f} kJ (simulated TPU fleet)\n")

    # run one placed job for real
    job = jobs[0]
    print(f"running {job.id} ({job.arch}) on {mgr.device}, batched decode:")
    tokens, t_prefill, t_decode = serve_batch(
        arch=job.arch, reduced=not args.full_width, batch=4, prompt_len=32,
        gen_tokens=16, device=args.device)
    return {"schedule": schedule, "load": load,
            "served": {"job": job.id, "arch": job.arch, "endpoint": schedule.assignments[job.id],
                       "tokens": tokens, "prefill_s": t_prefill, "decode_s": t_decode}}


if __name__ == "__main__":
    main()

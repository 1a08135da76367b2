"""Train a language model through the GreenFaaS fleet layer on the
PyTorch/CUDA port: Cluster MHRA places the job on a heterogeneous fleet of
simulated TPU endpoints (one launch of the window kernel on the card), the
model trains for real on the card, its endpoint leaves half way, the job is
re-placed and resumes from its last checkpoint; each measured step feeds
the fleet's profiles (straggler detection).

    PYTHONPATH=src python examples/torch_fleet_train.py --steps 8             # the card
    PYTHONPATH=src python examples/torch_fleet_train.py --full-width --steps 4
    PYTHONPATH=src python examples/torch_fleet_train.py --device cpu --steps 4

By default the model is the reduced granite (b=8 x 128); ``--full-width``
trains granite-3-2b at its published widths with 2 of its 40 layers (b=8 x
4,096 in 4 microbatches).  The run keeps one learning-rate schedule over
all ``--steps`` and checkpoints every ``steps // 2`` steps: the endpoint
leaves after step ``steps // 2``, just after a checkpoint, and the resumed
run starts from there, so its losses are the uninterrupted run's.  The
placement's energy and makespan ("est") are estimates for the simulated TPU
fleet (``tpu_fleet``'s v5e constants), not for the card.  Without
``--dryrun DIR`` no dry-run costs are read and the job is placed on the
profile store's priors.  The port's dry-run writes the job's costs into
DIR (counted on meta tensors on the host, ~4 s)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
        --shape train_4k --out DIR
"""
import argparse
import tempfile

from repro_torch.core.endpoint import tpu_fleet
from repro_torch.fleet.manager import FleetJob, FleetManager
from repro_torch.launch.train import train

JOB = dict(id="lm-pretrain", arch="granite-3-2b", shape="train_4k", checkpoint_bytes=5e9)
REDUCED = dict(reduced=True, batch=8, seq=128, microbatches=1, model_dims=None)
# granite-3-2b at its published widths, 2 of its 40 layers
FULL_WIDTH = dict(reduced=False, batch=8, seq=4096, microbatches=4,
                  model_dims={"n_layers": 2})


class EndpointLeft(Exception):
    """Raised from a step's hook when the job's endpoint leaves the fleet."""


def main(argv=None) -> dict:
    """Returns the two placements (``schedules``, ``targets``), every step
    run with its endpoint, loss and seconds as fed to the profiles
    (``observed``), the losses before the leave and of the resumed run
    (``losses``), the resumed run's metrics (``run``: each step, the peak
    memory) and the manager's ``events``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full-width", action="store_true",
                    help="granite-3-2b's widths with 2 of its 40 layers")
    ap.add_argument("--dryrun", default=None, metavar="DIR",
                    help="a directory of *__single.json dry-run costs")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: a temporary directory, removed at the end")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2")
    half = args.steps // 2

    # --- 1. GreenFaaS decides WHERE the job runs -------------------------
    mgr = FleetManager(tpu_fleet(), args.dryrun, alpha=0.5, device=args.device)
    job = FleetJob(steps=args.steps, **JOB)
    schedule = mgr.place([job])
    target = schedule.assignments[job.id]
    print(f"[fleet] Cluster MHRA on {mgr.device} placed {job.id} on '{target}' "
          f"(E={schedule.energy_j/1e3:.0f} kJ est, C_max={schedule.makespan_s:.0f} s est, "
          f"simulated TPU fleet)")

    # --- 2. real training with checkpoints; the endpoint leaves half way --
    where = {"endpoint": target}
    observed = []

    def on_step(i, loss, dt):
        # feed the measured step time back into the GreenFaaS profiles
        observed.append({"endpoint": where["endpoint"], "step": i, "loss": loss,
                         "seconds": dt})
        if mgr.observe_step(job, where["endpoint"], dt, energy_j=dt * 100.0):
            print(f"[fleet] straggler flagged at step {i} — would re-place")
        if where["endpoint"] == target and i + 1 == half:
            raise EndpointLeft(target)

    with tempfile.TemporaryDirectory(prefix="fleet_ckpt_") as tmp:
        kw = dict(arch=job.arch, steps=args.steps, checkpoint_dir=args.checkpoint_dir or tmp,
                  checkpoint_every=half, on_step=on_step, log_every=20,
                  device=args.device, **(FULL_WIDTH if args.full_width else REDUCED))
        print(f"[fleet] training on '{target}'; it leaves after step {half}")
        try:
            train(**kw)
        except EndpointLeft:
            pass

        # --- 3. the endpoint leaves; re-place and RESUME -------------------
        mgr.endpoint_leave(target)
        new_schedule = mgr.place([job])
        where["endpoint"] = new_target = new_schedule.assignments[job.id]
        print(f"[fleet] endpoint '{target}' LEFT -> re-placed on '{new_target}', "
              f"resuming from checkpoint")
        losses, run = train(resume=True, **kw)[1:]
    first = [o["loss"] for o in observed if o["endpoint"] == target]
    print(f"[fleet] done: loss {first[0]:.3f} -> {losses[-1]:.3f}; events: {mgr.events}")
    return {"schedules": (schedule, new_schedule), "targets": (target, new_target),
            "observed": observed, "losses": (first, losses), "run": run,
            "events": list(mgr.events)}


if __name__ == "__main__":
    main()

"""Model search across LM ARCHITECTURES on mesh-slice executors.

The search space is (architecture × learning rate); each task trains its
config for a few steps on a mesh SLICE (executors = submeshes). Costs come
from the analytic profile (parameters × steps), the LPT scheduler balances
slices, and results STREAM off the pool's ``ExecutorBackend.submit``
iterator. In one process the two slices are logical executors sharing the
one device; under ``torchrun`` every slice is a process mesh of its own
ranks, each task tensor-parallel over them, and rank 0 prints:

    PYTHONPATH=src python -m repro_torch.examples.distributed_search --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.distributed_search --device cpu
"""
import argparse
import os

from repro_torch.core import MeshSliceExecutorPool, schedule
from repro_torch.device import default_device
from repro_torch.launch.search import lm_search_mesh, lm_search_tasks, lm_task_runner


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", 1))
    n_slices = min(2, world) if world > 1 else 2
    mesh, say = lm_search_mesh(n_slices, world // n_slices if world > 1 else 1,
                               default_device(args.device or "cuda"))

    tasks = lm_search_tasks("qwen2_1_5b,tinyllama_1_1b,internvl2_1b", args.steps)
    assignment = schedule(tasks, n_slices, policy="lpt")
    say(f"{len(tasks)} tasks → {n_slices} mesh slices "
        f"(estimated makespan {assignment.estimated_makespan:.2e} cost units)")
    pool = MeshSliceExecutorPool(mesh, n_slices, lm_task_runner(args.steps))
    say("results stream in as each slice finishes a task:")
    results = []
    for r in pool.submit(assignment, None):
        mark = f"loss={r.model:.4f}" if r.ok else f"ERROR: {r.error}"
        say(f"  slice {r.executor_id}  {r.task.key():42s} {mark}")
        results.append(r)
    ranked = sorted((r for r in results if r.ok), key=lambda r: r.model)
    if ranked:
        say(f"fastest learner at its lr after {args.steps} steps: "
            f"{ranked[0].task.key()} (loss={ranked[0].model:.4f})")
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

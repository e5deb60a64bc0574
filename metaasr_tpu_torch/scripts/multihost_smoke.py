"""FOMAML on the task mesh in several processes against one (counterpart of
the reference's ``scripts/multihost_smoke.py``).

    python -m metaasr_tpu_torch.scripts.multihost_smoke \
        [--procs 2] [--mesh-tasks 1] [--device cuda|cpu]

The reference's constants: a global meta-batch of 8 tasks x (4 + 4) shots,
4,800 samples and 8 tokens a shot, vocabulary 12, numpy seed 7; d 32, 2
heads, d_ff 64, 2 + 2 layers, dropout 0, SpecAugment off; Adam at 1e-3,
inner lr 1e-2, 2 inner steps, first order; 2 steps on the same batch and
seed. ``--procs`` W processes start with torchrun's environment
(``MASTER_ADDR=localhost``, a free ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) and lay themselves out as ``--mesh-tasks`` N task
groups of W / N ranks (``parallel.make_mesh``): by default one group of two
ranks that split each task's 4 shots, the reference's data axis of 2. Each
rank takes its task group's tasks and its shots of the global batch
(``Mesh.local_batch``); one process runs the whole batch beside them. It
prints both pairs of ``meta_loss`` values and exits 0 where they agree
within 1e-5 (the reference's bar), 1 otherwise or where a process fails.

``--device cpu`` meets over gloo; ``--device cuda`` (the default) puts rank
r on card r mod C of the machine's C cards, over NCCL where C >= W and
over gloo where ranks share a card. On the card every side runs strict
fp32 (TF32 off) under deterministic algorithms, as the reference's smoke
runs fp32 on the CPU: under the port's defaults two runs of one process
there part by more than the bar. ``run`` is importable: it is what a rank
and the one process each compute.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

M_TASKS = 8          # global accent tasks
K_SHOT = 4           # divisible by the data axis
NUM_SAMPLES, NUM_TOKENS, VOCAB = 4800, 8, 12
SEED = 7
STEP_SEED = 1        # every step's seed, as the reference's one key
STEPS = 2
TOL = 1e-5


def global_batch() -> dict:
    """The whole meta-batch, the same in every process (numpy seed 7, in
    the reference's order: support, then query)."""
    rng = np.random.default_rng(SEED)

    def part():
        return {
            "audio": (0.1 * rng.standard_normal(
                (M_TASKS, K_SHOT, NUM_SAMPLES))).astype(np.float32),
            "audio_lens": np.full((M_TASKS, K_SHOT), NUM_SAMPLES, np.int32),
            "tokens": rng.integers(
                1, VOCAB - 1, (M_TASKS, K_SHOT, NUM_TOKENS)).astype(np.int32),
            "token_lens": np.full((M_TASKS, K_SHOT), NUM_TOKENS, np.int32),
        }

    return {"support": part(), "query": part()}


def smoke_config():
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.arch, m.vocab_size = "transformer", VOCAB
    m.d_model, m.num_heads, m.d_ff = 32, 2, 64
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dtype, m.dropout = "float32", 0.0
    cfg.specaug.enabled = False
    o = cfg.optimizer
    o.name, o.schedule, o.lr = "adam", "constant", 1e-3
    return cfg


def run(device, group=None, mesh_tasks: int | None = None) -> list[float]:
    """``STEPS`` FOMAML steps (the meta-gradient, then Adam) on this rank's
    part of ``global_batch()`` -> the ``meta_loss`` of each step (every
    task's, the same on every rank)."""
    import torch

    from metaasr_tpu_torch import device as policy
    from metaasr_tpu_torch.meta.maml import MetaAlgoConfig, maml_grads
    from metaasr_tpu_torch.parallel import make_mesh
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.optimizer import (
        apply_updates,
        make_optimizer,
    )

    if torch.device(device).type == "cuda":
        policy.ALLOW_TF32 = False
        # read when the process makes its cuBLAS handle, at its first product
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = smoke_config()
    task = ASRTask(cfg, VOCAB - 1, device=device)
    grad_fn = maml_grads(task.loss_fn, MetaAlgoConfig(
        inner_lr=1e-2, inner_steps=2, first_order=True), task.preprocess)
    opt = make_optimizer(cfg.optimizer, cfg.model.d_model)
    params = task.init_params(0)
    opt_state = opt.init(params)
    mesh = make_mesh(group, mesh_tasks)
    local = mesh.local_batch(global_batch())
    batch = {p: {k: torch.from_numpy(np.ascontiguousarray(v)).to(task.device)
                 for k, v in b.items()} for p, b in local.items()}
    offset = mesh.task_rows(M_TASKS).start
    losses = []
    for _ in range(STEPS):
        grads, metrics = grad_fn(params, batch, STEP_SEED, group=group,
                                 task_offset=offset, data=mesh.data)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(float(metrics["meta_loss"]))
    return losses


def _rank_device(device: str) -> tuple[str, str]:
    """(this rank's device, the backend) under torchrun's environment."""
    if device == "cpu":
        return "cpu", "gloo"
    import torch

    cards, world = torch.cuda.device_count(), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return f"cuda:{local % cards}", "nccl" if cards >= world else "gloo"


def worker(device: str, mesh_tasks: int) -> int:
    """A rank under torchrun's environment: prints its losses."""
    import torch.distributed as dist

    from metaasr_tpu_torch.parallel import initialize

    dev, backend = _rank_device(device)
    group = initialize(device=dev, backend=backend, timeout=300)
    try:
        losses = run(dev, group, mesh_tasks)
    finally:
        dist.destroy_process_group()
    print("LOSSES", *losses, flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(procs: int, mesh_tasks: int, device: str,
           timeout: float = 600.0) -> list[float]:
    """``procs`` fresh ranks of this script under torchrun's environment
    -> rank 0's losses. A rank that fails, or the time limit, stops the
    others and raises with that rank's output."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = _free_port()
    logs = [tempfile.TemporaryFile("w+") for _ in range(procs)]
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "metaasr_tpu_torch.scripts.multihost_smoke",
         "--worker", "--device", device, "--mesh-tasks", str(mesh_tasks)],
        cwd=repo, stdout=log, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                 MASTER_PORT=str(port), WORLD_SIZE=str(procs), RANK=str(r),
                 LOCAL_RANK=str(r)))
        for r, log in enumerate(logs)]

    def output(r: int) -> str:
        logs[r].seek(0)
        return logs[r].read()

    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in ranks]
            bad = [r for r, c in enumerate(codes) if c]
            if bad or time.monotonic() - t0 > timeout:
                r = bad[0] if bad else 0
                raise RuntimeError(
                    f"rank {r} of {procs} "
                    f"{'exited ' + str(codes[r]) if bad else 'late'}:\n"
                    f"{output(r)[-4000:]}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
        for line in output(0).splitlines():
            if line.startswith("LOSSES"):
                return [float(x) for x in line.split()[1:]]
        raise RuntimeError(f"no LOSSES line from rank 0:\n{output(0)}")
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()


def compare(one: list[float], multi: list[float],
            tol: float = TOL) -> tuple[float, bool]:
    """(largest absolute difference, whether both have ``STEPS`` losses
    and every difference is below ``tol``)."""
    if len(one) != STEPS or len(multi) != STEPS:
        return float("inf"), False
    worst = max(abs(a - b) for a, b in zip(one, multi))
    return worst, worst < tol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--mesh-tasks", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank under torchrun's environment")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.device, args.mesh_tasks)
    if args.procs < 1 or args.procs % args.mesh_tasks:
        raise SystemExit(f"--mesh-tasks {args.mesh_tasks} must divide "
                         f"--procs {args.procs}")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a card; pass --device cpu")
    multi = launch(args.procs, args.mesh_tasks, args.device)
    one = run("cpu" if args.device == "cpu" else "cuda:0")
    worst, ok = compare(one, multi)
    data = args.procs // args.mesh_tasks
    print(f"single-process losses:  {one}")
    print(f"{args.procs}-process losses:       {multi}  ({args.mesh_tasks} "
          f"task group(s) x a data axis of {data})")
    print(f"max diff: {worst:.2e}  ->  {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

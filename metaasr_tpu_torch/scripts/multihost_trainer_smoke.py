"""The CLI's meta-training in two processes against one, through a restart
(counterpart of the reference's ``scripts/multihost_trainer_smoke.py``).

    python -m metaasr_tpu_torch.scripts.multihost_trainer_smoke \
        [--device cuda|cpu] [--dir DIR]

Makes a synthetic corpus (5 accents x 8 utterances, ``tango`` held out) and
a config at the port tests' width (d 32, 2 heads, 2 + 2 layers, fp32; 4
tasks x (2 + 2), 2 inner steps; SpecAugment, dropout and dither on; a
checkpoint every step, a greedy held-out evaluation every 2 steps). Then
each side runs ``python -m metaasr_tpu_torch.cli --mode train`` to step 2
and, in fresh processes on the same workdir, resumes to step 4:

- one process, without ``--mesh-tasks``;
- two processes with ``--mesh-tasks 2`` and torchrun's environment
  (``MASTER_ADDR=localhost``, a free ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``).

It prints both ``meta_loss`` trajectories, read from rank 0's log, and
their largest difference, and exits 1 above 1e-5 (the reference's bar) or
when a process fails. ``--device cuda`` (the default) meets over NCCL and
needs a card for each rank; ``--device cpu`` meets over gloo. ``--dir``
keeps the corpus and workdirs there (default: a new temporary directory,
removed at the end). The functions are importable: ``train_argv``,
``trajectory`` and ``compare`` are what ``tests/test_torch_mesh_tasks.py``
holds its gloo ranks to, and it runs ``side`` at both world sizes on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

STEPS_A, STEPS_B = 2, 4    # the first run's checkpoint, the resumed run's end
WORLD = 2
TOL = 1e-5                 # the reference's bar on the loss trajectory
HELDOUT = "tango"


def smoke_config(data_dir: str):
    """The run's config: the port tests' width on ``data_dir``."""
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.arch, m.d_model, m.num_heads, m.d_ff = "transformer", 32, 2, 64
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dtype, m.dropout = "float32", 0.1
    cfg.specaug.enabled, cfg.frontend.dither = True, 1e-3
    o = cfg.optimizer
    o.name, o.schedule, o.lr = "adam", "constant", 1e-3
    mc = cfg.meta
    mc.algo, mc.tasks_per_batch = "fomaml", 4
    mc.k_support = mc.k_query = 2
    mc.inner_steps = mc.adapt_steps = 2
    d = cfg.data
    d.data_dir, d.heldout_accents = data_dir, (HELDOUT,)
    d.max_frames, d.max_tokens = 200, 16
    d.frame_buckets, d.token_buckets = (75, 100, 200), (8, 16)
    t = cfg.train
    t.log_every = t.ckpt_every = 1
    t.eval_every, t.eval_max_utts = 2, 2
    t.eval_decode_mode, t.eval_support_draws = "greedy", 1
    return cfg


def make_run(root: str) -> str:
    """The corpus under ``root/data`` and the config ``root/config.yaml``
    -> the config's path."""
    from metaasr_tpu_torch.config import save_config
    from metaasr_tpu_torch.data.synthetic import generate_dataset

    data = os.path.join(root, "data")
    generate_dataset(data, accents=("alpha", "bravo", "echo", "delta",
                                    HELDOUT),
                     utts_per_accent=8, words_per_utt=(1, 2), seed=0)
    path = os.path.join(root, "config.yaml")
    save_config(smoke_config(data), path)
    return path


def train_argv(config: str | None, workdir: str, steps: int, device: str,
               mesh_tasks: int = 0) -> list[str]:
    """The CLI's arguments for a training run to ``steps``; ``config``
    None: the workdir's recorded one (a resume)."""
    argv = ["--mode", "train", "--workdir", workdir, "--max-steps",
            str(steps), "--device", device]
    if config:
        argv += ["--config", config]
    if mesh_tasks:
        argv += ["--mesh-tasks", str(mesh_tasks)]
    return argv


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """What ``torchrun --nproc-per-node WORLD`` gives rank ``rank``."""
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank)}


def launch(argv: list[str], world: int, timeout: float = 900.0) -> str:
    """``world`` fresh processes of ``python -m metaasr_tpu_torch.cli
    argv`` (with torchrun's environment when ``world`` > 1) -> rank 0's
    output. A process that fails, or the time limit, stops the others and
    raises with that process's output."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metaasr_tpu_torch.cli", *argv], cwd=repo,
        env=dict(env, **(torchrun_env(r, world, port) if world > 1 else {})),
        stdout=log, stderr=subprocess.STDOUT, text=True)
        for r, log in enumerate(logs)]

    def output(r: int) -> str:
        logs[r].seek(0)
        return logs[r].read()

    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c]
            late = time.monotonic() - t0 > timeout
            if bad or late:
                r = bad[0] if bad else 0
                raise RuntimeError(
                    f"cli {' '.join(argv)}: rank {r} of {world} "
                    f"{'exited ' + str(codes[r]) if bad else 'late'}:\n"
                    f"{output(r)[-4000:]}")
            if all(c == 0 for c in codes):
                return output(0)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()


def trajectory(workdir: str, key: str = "meta_loss") -> list[float]:
    """``key`` of every logged training step in rank 0's
    ``logs/scalars.jsonl``, in step order."""
    with open(os.path.join(workdir, "logs", "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r[key] for r in sorted(recs, key=lambda r: r["step"])
            if key in r]


def compare(one: list[float], multi: list[float],
            tol: float = TOL) -> tuple[float, bool]:
    """(largest absolute difference, whether both trajectories have
    ``STEPS_B`` steps and every difference is below ``tol``)."""
    if len(one) != STEPS_B or len(multi) != STEPS_B:
        return float("inf"), False
    worst = max(abs(a - b) for a, b in zip(one, multi))
    return worst, worst < tol


def side(config: str, workdir: str, device: str, world: int) -> list[float]:
    """One side's run: to ``STEPS_A``, then fresh processes to
    ``STEPS_B`` under the recorded config -> its loss trajectory."""
    mesh = world if world > 1 else 0
    launch(train_argv(config, workdir, STEPS_A, device, mesh), world)
    launch(train_argv(None, workdir, STEPS_B, device, mesh), world)
    return trajectory(workdir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if cards < WORLD:
            raise SystemExit(f"--device cuda runs {WORLD} ranks, one card "
                             f"each; this machine has {cards}")
    root = args.dir or tempfile.mkdtemp(prefix="mh_trainer_")
    try:
        config = make_run(root)
        one = side(config, os.path.join(root, "wd_single"), args.device, 1)
        multi = side(config, os.path.join(root, "wd_multi"), args.device,
                     WORLD)
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)
    worst, ok = compare(one, multi)
    print(f"single-process trajectory: {one}")
    print(f"{WORLD}-process trajectory:      {multi}")
    print(f"max diff: {worst:.2e}  ->  {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

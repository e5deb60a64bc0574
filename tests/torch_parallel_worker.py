"""The port's data-parallel meta-step on gloo processes, for
``tests/test_torch_parallel.py``.

Run as ``python -m tests.torch_parallel_worker RANK WORLD DIR`` from the
repo root: the process joins a gloo group of WORLD processes through a
``FileStore`` in DIR, runs the jobs listed in ``DIR/jobs.json`` on the CPU
and writes its results to ``DIR/rank<RANK>.pt``. The test runs the same
functions in its own process without a group, so both sides share the
configurations, batches and weights made here from seeds. A ``cli`` job
runs ``cli.main`` under that group (``tests/test_torch_mesh_tasks.py``)
and records what the rank trained, wrote and read; a ``mismatch`` job
hands ``broadcast_state`` states that differ across ranks, and a
``cli_error`` job records what each rank raised from a run that fails. A
``scenario`` job with ``num_task`` N below WORLD runs on the task mesh's
data axis (``tests/test_torch_mesh_data.py``). This module imports
torch and the port only: no ``jax``, no ``metaasr_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 30
M_TASKS, K = 4, 2

# name -> (MetaAlgoConfig keywords, SpecAugment + dropout + dither on,
# Adam steps); the steps' batches come from seeds 0, 1, ...
SCENARIOS = {
    "fomaml": ({"inner_lr": 0.05, "inner_steps": 2}, True, 2),
    "maml": ({"inner_lr": 0.05, "inner_steps": 2, "first_order": False},
             True, 1),
    "reptile": ({"inner_lr": 0.05, "inner_steps": 2}, True, 1),
    "fomaml_bf16": ({"inner_lr": 0.05, "inner_steps": 2,
                     "grad_dtype": "bfloat16"}, True, 1),
    # the inner clip's global norm is below every inner gradient's
    "fomaml_clip": ({"inner_lr": 0.05, "inner_steps": 2,
                     "inner_clip": 0.05}, True, 1),
    # against the reference: SpecAugment off, dropout 0, dither 0
    "fomaml_plain": ({"inner_lr": 0.05, "inner_steps": 2}, False, 1),
}


def small_cfg(noisy: bool):
    """The port tests' width (d 32, 2 heads, d_ff 64, 2 + 2 layers, fp32);
    ``noisy``: SpecAugment, dropout 0.1 and dither, so every consumer of a
    task's seed draws."""
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.arch, m.vocab_size = "transformer", VOCAB
    m.d_model, m.num_heads, m.d_ff = 32, 2, 64
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dtype = "float32"
    m.dropout = 0.1 if noisy else 0.0
    cfg.specaug.enabled = noisy
    cfg.frontend.dither = 1e-3 if noisy else 0.0
    o = cfg.optimizer
    o.name, o.schedule, o.lr = "adam", "constant", 1e-3
    return cfg


def meta_batch(seed: int) -> dict:
    """{"support", "query"}: [M, K, ...] numpy arrays, audio of 5,000-8,000
    samples (row 0 of each task full), 2-6 tokens."""
    rng = np.random.default_rng(seed)

    def part():
        lens = rng.integers(5000, 8001, (M_TASKS, K)).astype(np.int32)
        lens[:, 0] = 8000
        audio = (0.1 * rng.standard_normal((M_TASKS, K, 8000))).astype(
            np.float32)
        audio *= np.arange(8000)[None, None, :] < lens[..., None]
        tok_lens = rng.integers(2, 7, (M_TASKS, K)).astype(np.int32)
        tokens = rng.integers(1, VOCAB - 1, (M_TASKS, K, 6)).astype(np.int32)
        tokens *= np.arange(6)[None, None, :] < tok_lens[..., None]
        return {"audio": audio, "audio_lens": lens, "tokens": tokens,
                "token_lens": tok_lens}

    return {"support": part(), "query": part()}


def rows_of(batch: dict, rows: slice) -> dict:
    return {p: {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                for k, v in batch[p].items()} for p in batch}


def _numpy(tree: dict) -> dict:
    from metaasr_tpu_torch.utils.tree import flatten

    return {k: v.detach().float().numpy().copy()
            for k, v in flatten(tree).items()}


def run_scenario(name: str, group=None, num_task: int | None = None) -> dict:
    """The scenario's meta-steps (``maml_grads`` or ``reptile_grads``, then
    the trainer's clip + Adam) on this rank's part of each step's batch
    (its task group's tasks of ``num_task`` = N groups, N = WORLD by
    default, and on the data axis under first order its shots) -> {"grads":
    step 1's outer gradient, "metrics": per step, "grad_norm": per step,
    "params": after the last step, "adapted": the parameters step 1's
    first task's loss was called with, in order (its inner steps', then
    the query's), "all_reduces": the group's gradient all-reduces,
    "inner_reduces": the data axis's inner-step all-reduces}."""
    from metaasr_tpu_torch.meta import maml
    from metaasr_tpu_torch.parallel import (
        make_mesh,
        reduce_inner,
        reduce_outer,
    )
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.optimizer import (
        apply_updates,
        global_norm,
        make_optimizer,
    )

    algo, noisy, steps = SCENARIOS[name]
    cfg = small_cfg(noisy)
    task = ASRTask(cfg, VOCAB - 1, device="cpu")
    meta_cfg = maml.MetaAlgoConfig(**algo)
    seen = []

    def loss_fn(params, batch, generator, train):
        if len(seen) <= meta_cfg.inner_steps:
            seen.append(_numpy(params))
        return task.loss_fn(params, batch, generator, train)

    make = maml.reptile_grads if name == "reptile" else maml.maml_grads
    grad_fn = make(loss_fn, meta_cfg, task.preprocess)
    opt = make_optimizer(cfg.optimizer, cfg.model.d_model)
    params = task.init_params(0)
    opt_state = opt.init(params)
    mesh = make_mesh(group, num_task)
    rows = mesh.task_rows(M_TASKS)
    before = reduce_outer.all_reduces, reduce_inner.all_reduces
    out = {"metrics": [], "grad_norm": []}
    for step in range(steps):
        local = mesh.local_batch(meta_batch(step), meta_cfg.first_order)
        grads, metrics = grad_fn(params, rows_of(local, slice(None)),
                                 maml.fold_in(7, step), group=group,
                                 task_offset=rows.start, data=mesh.data)
        if step == 0:
            out["grads"] = _numpy(grads)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["grad_norm"].append(float(global_norm(grads)))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    out["params"] = _numpy(params)
    out["adapted"] = seen
    out["all_reduces"] = reduce_outer.all_reduces - before[0]
    out["inner_reduces"] = reduce_inner.all_reduces - before[1]
    return out


def trainer_cfg(data_dir: str):
    """``MetaASRTrainer`` at the tests' width on the synthetic corpus: 4
    training accents, 4 tasks x (2 + 2), 2 inner steps, SpecAugment,
    dropout and dither on, the resident store asked for, a greedy
    held-out evaluation at step 2 and a checkpoint every step."""
    cfg = small_cfg(True)
    mc = cfg.meta
    mc.k_support = mc.k_query = 2
    mc.tasks_per_batch = M_TASKS
    mc.inner_steps, mc.adapt_steps = 2, 2
    d = cfg.data
    d.data_dir, d.heldout_accents = data_dir, ("tango",)
    d.max_frames, d.max_tokens = 200, 16
    d.frame_buckets, d.token_buckets = (75, 100, 200), (8, 16)
    d.resident = "on"
    t = cfg.train
    t.log_every = t.ckpt_every = 1
    t.eval_every, t.eval_max_utts = 2, 2
    t.eval_decode_mode, t.eval_support_draws = "greedy", 1
    return cfg


def run_trainer(data_dir: str, workdir: str, group=None) -> dict:
    """``MetaASRTrainer.meta_train(max_steps=2)`` -> the final state's
    parameters and best metric, the logged records (rank 0), whether a
    resident store was built, what the workdir holds."""
    from metaasr_tpu_torch import cli

    tr = cli.make_trainer(trainer_cfg(data_dir), workdir, "cpu", group)[0]
    state = tr.meta_train(max_steps=2)
    logs = os.path.join(workdir, "logs", "scalars.jsonl")
    recs = []
    if os.path.exists(logs):
        with open(logs) as f:
            recs = [json.loads(line) for line in f]
    return {"params": _numpy(state["params"]), "step": state["step"],
            "best_metric": state["best_metric"], "records": recs,
            "store_built": tr._store is not None,
            "workdir": sorted(os.listdir(workdir))
            if os.path.isdir(workdir) else []}


_AUDIT = {"root": None, "events": [], "hooked": False}


def _audit(event: str, args) -> None:
    """An audit hook: ("write" | "read" | "os.mkdir" | "os.rename" |
    "os.remove", path relative to the root) for every file event under
    ``_AUDIT["root"]``. ``torch.save`` writes a path from C++, unseen, but
    the checkpoints' rename into place is seen."""
    root = _AUDIT["root"]
    if root is None or event not in ("open", "os.mkdir", "os.rename",
                                     "os.remove"):
        return
    path = args[1] if event == "os.rename" else args[0]
    if not isinstance(path, (str, bytes, os.PathLike)):
        return
    path = os.path.abspath(os.fsdecode(path))
    if not path.startswith(root + os.sep):
        return
    kind = event
    if event == "open":
        mode, flags = args[1], args[2] or 0
        kind = ("write" if (isinstance(mode, str)
                            and any(c in mode for c in "wax+"))
                or flags & (os.O_WRONLY | os.O_RDWR) else "read")
    _AUDIT["events"].append((kind, os.path.relpath(path, root)))


def cli_job(argv: list, audit_root: str | None = None) -> dict:
    """``cli.main(argv)`` in the rank's group (its ``initialize()`` returns
    the one ``main`` made) -> what the rank did: its exit code; the state
    right after each ``broadcast_state`` (flat, on the cpu); the final
    state's parameters, step, best metric and stale count; the config it
    trained; the trainer's and the task's device; the file events under
    ``audit_root`` (none recorded without one); the group's gradient
    all-reduces (outer and, on the data axis, inner) and broadcasts."""
    from metaasr_tpu_torch import cli
    from metaasr_tpu_torch.config import to_dict
    from metaasr_tpu_torch.parallel import (
        broadcast_state,
        reduce_inner,
        reduce_outer,
    )
    from metaasr_tpu_torch.train import meta_train
    from metaasr_tpu_torch.utils.tree import flatten

    if audit_root is not None:
        if not _AUDIT["hooked"]:
            sys.addaudithook(_audit)
            _AUDIT["hooked"] = True
        _AUDIT["root"] = os.path.abspath(audit_root)
    _AUDIT["events"] = []
    out = {"broadcasts": [], "trainers": []}

    def spy_broadcast(state, g):
        state = broadcast_state(state, g)
        out["broadcasts"].append({
            k: v.detach().cpu().clone() if torch.is_tensor(v) else v
            for k, v in flatten(state).items()})
        return state

    def spy_meta_train(self, *a, **k):
        state = plain_meta_train(self, *a, **k)
        out["trainers"].append({
            "params": _numpy(state["params"]), "step": state["step"],
            "best_metric": state["best_metric"],
            "stale_evals": state["stale_evals"], "cfg": to_dict(self.cfg),
            "devices": (str(self.device), str(self.task.device))})
        return state

    plain_meta_train = meta_train.MetaASRTrainer.meta_train
    meta_train.broadcast_state = spy_broadcast
    meta_train.MetaASRTrainer.meta_train = spy_meta_train
    calls, reduces = broadcast_state.calls, reduce_outer.all_reduces
    inner = reduce_inner.all_reduces
    try:
        out["rc"] = cli.main(argv)
    finally:
        meta_train.broadcast_state = broadcast_state
        meta_train.MetaASRTrainer.meta_train = plain_meta_train
        _AUDIT["root"] = None
    out["events"] = list(_AUDIT["events"])
    out["broadcast_calls"] = broadcast_state.calls - calls
    out["all_reduces"] = reduce_outer.all_reduces - reduces
    out["inner_reduces"] = reduce_inner.all_reduces - inner
    return out


def broadcast_mismatch(group) -> dict:
    """``broadcast_state`` where rank 1's state holds a tensor of another
    shape than rank 0's -> {"error": what this rank raised, or None}."""
    from metaasr_tpu_torch.parallel import broadcast_state, rank

    state = {"params": {"w": torch.zeros(3 if rank(group) == 1 else 2)},
             "step": 0}
    try:
        broadcast_state(state, group)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def cli_error(argv: list) -> dict:
    """``cli.main(argv)`` that is to fail -> {"error": "<type>: <message>"
    of what this rank raised, or None}."""
    from metaasr_tpu_torch import cli

    try:
        cli.main(argv)
    except (Exception, SystemExit) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return {"error": None}


def main(rank: int, world: int, out: str) -> None:
    from metaasr_tpu_torch.parallel import initialize

    torch.set_num_threads(1)
    with open(os.path.join(out, "jobs.json")) as f:
        jobs = json.load(f)
    group = initialize(init_method=f"file://{out}/rdzv", world_size=world,
                       rank=rank, backend="gloo", device="cpu", timeout=120)
    results = {}
    for job in jobs:
        if job["kind"] == "scenario":
            results[job.get("key", job["name"])] = run_scenario(
                job["name"], group, job.get("num_task"))
        elif job["kind"] == "cli":
            results[job["name"]] = cli_job(job["argv"], job["audit_root"])
        elif job["kind"] == "mismatch":
            results[job["name"]] = broadcast_mismatch(group)
        elif job["kind"] == "cli_error":
            results[job["name"]] = cli_error(job["argv"])
        else:
            results["trainer"] = run_trainer(
                job["data_dir"], os.path.join(out, f"wd{rank}"), group)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


class Ranks:
    """``world`` worker processes running ``jobs`` in ``out``; ``results()``
    waits for them (killing every one as soon as one fails) and returns
    each rank's results."""

    def __init__(self, world: int, out: str, jobs: list,
                 timeout: float = 600.0):
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "jobs.json"), "w") as f:
            json.dump(jobs, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.out, self.timeout, self._results = out, timeout, None
        self.procs = []
        for r in range(world):
            with open(self._log(r), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_parallel_worker",
                     str(r), str(world), out], cwd=REPO, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        self.t0 = time.monotonic()

    def _log(self, r: int) -> str:
        return os.path.join(self.out, f"rank{r}.log")

    def _tail(self, r: int) -> str:
        with open(self._log(r)) as f:
            return f.read()[-4000:]

    def results(self) -> list[dict]:
        if self._results is not None:
            return self._results
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c]
                if bad:
                    raise RuntimeError(f"rank {bad[0]} exited "
                                       f"{codes[bad[0]]}:\n"
                                       + self._tail(bad[0]))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() - self.t0 > self.timeout:
                    raise RuntimeError(f"ranks running after {self.timeout} "
                                       "s:\n" + self._tail(0))
                time.sleep(0.05)
        finally:
            self.close()
        self._results = [torch.load(os.path.join(self.out, f"rank{r}.pt"),
                                    weights_only=False)
                         for r in range(len(self.procs))]
        return self._results

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

"""Ranks of the port for the CPU tests: a pool of gloo worker processes,
started once per test module, and the scenarios they run.

`RankPool(world, model=1, pipe=1)` starts `world` Python processes running
this file; each joins a gloo process group on a grid of `pipe` stages of
world / (model * pipe) data rows of `model` ranks
(`openasr_torch.parallel.new_group`, a free port) and then serves
scenarios sent over a local socket: `pool.run(name, *args)` calls the
scenario `name(grid, *args)` on every rank and returns the ranks' results
(in rank order, rank = p * D * model + d * model + m), or raises with the
failing rank's traceback.  Every call has a timeout, so a hung rank fails
its test instead of the run.  The ranks of a model group, and those of a
pipe group, load the same rows: a scenario cuts its rows by the grid's
data index.

The scenarios import the port only (never jax), so a worker starts in a
couple of seconds.  A global batch is cut into the ranks' contiguous rows
and each rank's rows are trimmed to their own natural extents (`natural`),
as each rank's collate pads its own slice, so that a rank that did not
reconcile its shapes with the others computes otherwise than the
one-process run.

  python tests/torch_parallel_ranks.py <host> <port> <rank> <world> <gloo port> [<model> [<pipe>]]
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import traceback
from multiprocessing.connection import Client, Listener

AUTHKEY = b"openasr-torch-ranks"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LENGTH_OF = {"feats": "feat_lengths", "waves": "wave_lengths", "phones": "phone_lengths",
             "unpaired_phones": "unpaired_phone_lengths",
             "unpaired_text": "unpaired_text_lengths", "tokens": "token_lengths"}


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RankPool:
    def __init__(self, world: int, timeout: float = 120.0, model: int = 1, pipe: int = 1):
        self.world, self.timeout, self.model, self.pipe = world, timeout, model, pipe
        self.listener = Listener(("localhost", 0), authkey=AUTHKEY)
        self.listener._listener._socket.settimeout(timeout)
        host, port = self.listener.address
        gloo = free_port()
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), host, str(port),
                              str(r), str(world), str(gloo), str(model), str(pipe)],
                             env=env, cwd=ROOT)
            for r in range(world)
        ]
        self.conns = {}
        try:
            for _ in range(world):
                conn = self.listener.accept()
                self.conns[conn.recv()] = conn
        except BaseException:
            self.close()
            raise

    def run(self, name: str, *args):
        for r in range(self.world):
            self.conns[r].send((name, args))
        out = []
        for r in range(self.world):
            conn = self.conns[r]
            if not conn.poll(self.timeout):
                self.close()
                raise TimeoutError(f"rank {r} gave no result of {name} in {self.timeout} s")
            status, value = conn.recv()
            if status != "ok":
                raise RuntimeError(f"rank {r} failed in {name}:\n{value}")
            out.append(value)
        return out

    def close(self) -> None:
        for conn in self.conns.values():
            try:
                conn.send(None)
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
        self.listener.close()


# ------------------------------------------------------------ batches

def natural(batch: dict) -> dict:
    """`batch` with every padded dimension cut to its rows' extent: the
    time of each field with a lengths field, and the labels (`ids`,
    `labels`, `paddings`) to the most unpadded positions of a row."""
    out = dict(batch)
    for key, lkey in LENGTH_OF.items():
        if key in batch and lkey in batch:
            out[key] = batch[key][:, :max(int(batch[lkey].max()), 1)]
    if "paddings" in batch:
        u = max(int((batch["paddings"] < 0.5).sum(axis=1).max()), 1)
        for key in ("ids", "labels", "paddings"):
            out[key] = batch[key][:, :u]
    return out


def rows(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s contiguous rows of a global batch, trimmed
    (`natural`)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // world
        out[k] = v[rank * b:(rank + 1) * b]
    return natural(out)


# ------------------------------------------------------------ scenarios

def _model(spec, device="cpu"):
    import torch

    from openasr_torch.models import get_model_class

    model = get_model_class(spec["model_type"]).create_model(
        spec["model_cfg"], device=device,
        generator=torch.Generator().manual_seed(spec.get("seed", 0)))
    if spec.get("pkg") is not None:
        model.restore(spec["pkg"])
    return model


def train(grid, spec: dict) -> dict:
    """Train the spec's model over `spec["loaders"]` (name -> list of global
    batches; "tr" the train loader, others solver keywords such as the
    GAN's `phone_loader`) through the solver's epoch loop; with
    `spec["restore"]` a package's solver and optimizer state first; with
    `spec["draws"]` (global arrays, in the order of the draws) the per-row
    host draws (`TrainRNG.rand_rows`) are this rank's rows of those, so
    that a test can give the port the JAX package's draws.
    Returns the steps' total losses and MoE auxiliaries (summed over the
    ranks), the full first moment after the first update (SGD's trace, the
    clipped gradient; Adam's mu, (1 - b1) times it), the collectives of the
    second step (calls and bytes, on the data group; `model_calls` and
    `model_bytes` on the model group, `pipe_calls` and `pipe_bytes` on the
    pipe group), the optimizer's shard shapes, the
    replicated parameters and the final package.  `grid` is the `Grid` of
    ranks."""
    import torch

    from openasr_torch.solvers import get_solver_class

    torch.manual_seed(0)
    group = grid.data
    model = _model(spec, group.device)
    loaders = {k: [rows(b, group.rank, group.world) for b in v]
               for k, v in spec["loaders"].items()}
    tr = loaders.pop("tr")
    solver = get_solver_class(spec["model_type"])(
        model, dict(spec["training"]), tr, [], device=group.device, group=grid, **loaders)
    if spec.get("restore") is not None:
        solver.restore(spec["restore"])
    draws = [torch.tensor(d) for d in spec.get("draws") or []]
    if "draws" in spec:
        def fed_rows(shape, dim=0):
            u, b = draws.pop(0), shape[dim]
            assert u.shape[dim] == b * group.world, (tuple(u.shape), tuple(shape))
            u = u.narrow(dim, group.rank * b, b)
            assert tuple(u.shape) == tuple(shape), (tuple(u.shape), tuple(shape))
            return u

        solver.rng.rand_rows = fed_rows
    shares, aux, calls, state = [], [], [], {}
    grad_step, apply_update = solver.grad_step, solver.apply_update

    counters = {"calls": (group, "calls"), "bytes": (group, "bytes"),
                "model_calls": (grid.model, "calls"), "model_bytes": (grid.model, "bytes"),
                "pipe_calls": (grid.pipe, "calls"), "pipe_bytes": (grid.pipe, "bytes")}

    def counted(fn, *args):
        before = {k: dict(getattr(g, a)) for k, (g, a) in counters.items()}
        out = fn(*args)
        for k, (g, a) in counters.items():
            for name, v in getattr(g, a).items():
                if v != before[k].get(name, 0):
                    calls[-1][k][name] = calls[-1][k].get(name, 0) + v - before[k].get(name, 0)
        return out

    def recording_grad_step(batch, empty_rows):
        calls.append({k: {} for k in counters})
        losses = counted(grad_step, batch, empty_rows)
        shares.append(solver.total_loss(solver.global_counts(losses)).detach())
        aux.append(losses.get("moe_aux_loss", torch.zeros(())).detach())
        return losses

    def recording_apply_update():
        counted(apply_update)
        if "g1" not in state:
            full = solver.dp.full_state(solver.optimizer.state_dict())
            state["g1"] = full["trace"] if "trace" in full else full.get("mu")

    solver.grad_step, solver.apply_update = recording_grad_step, recording_apply_update
    solver.iter_one_epoch()
    assert not draws, f"{len(draws)} of the draws given were not drawn"
    losses = group.all_reduce(torch.stack(shares + aux)).tolist() if shares else []
    pkg = solver.package()
    replicated = {n: p.detach().numpy().copy() for n, p in solver.params.items()
                  if n not in solver.tp_specs}
    return {
        "losses": losses[:len(shares)], "aux": losses[len(shares):], "g1": state.get("g1"),
        **{k: calls[1][k] if len(calls) > 1 else {} for k in counters},
        "step": solver.step, "pkg": pkg, "replicated": replicated,
        "shards": {n: tuple(p.shape) for n, p in zip(solver.optimizer.names,
                                                      solver.optimizer.params)},
    }


def reconcile(grid, batches: list) -> list:
    """This rank's rows of each global batch, reconciled."""
    from openasr_torch.parallel import reconcile_batch

    group = grid.data
    return [reconcile_batch(group, rows(b, group.rank, group.world)) for b in batches]


def preempt(grid, spec: dict, signal_at: int) -> dict:
    """Rank 0 alone gets SIGTERM while loading batch `signal_at`; train()
    stops every rank and writes last.pkg.  Returns the step and epoch each
    rank stopped at."""
    from openasr_torch.solvers import get_solver_class

    group = grid.data
    model = _model(spec, group.device)
    local = [rows(b, group.rank, group.world) for b in spec["loaders"]["tr"]]

    class Loader(list):
        def __iter__(self):
            for i, b in enumerate(list.__iter__(self), start=1):
                if grid.rank == 0 and i == signal_at:
                    signal.raise_signal(signal.SIGTERM)
                yield b

    solver = get_solver_class(spec["model_type"])(
        model, dict(spec["training"]), Loader(local), [], device=group.device, group=grid)
    solver.train()
    return {"step": solver.step, "epoch": solver.epoch, "stopped": solver._stop_requested}


def coords(grid) -> dict:
    """This rank's (pipe, data, model) indices and its groups' sizes."""
    return {"pdm": (grid.pipe.rank, grid.data.rank, grid.model.rank),
            "sizes": {k: g.world for k, g in grid.groups().items() if k != "everyone"}}


def gpipe(grid, spec: dict) -> dict:
    """`gpipe_apply` of this stage's layers of `spec["layers"]` (per-layer
    JAX trees of a relu TransformerEncoderLayer of `spec["dims"]` (d_model,
    heads, FFN width), dropout 0) on this data row's rows of `spec["x"]`
    (key lengths `spec["lengths"]`, `spec["m"]` microbatches), then the
    backward of sum(out * spec["cot"]): -> this rank's output rows, the
    input's gradient, its stage's layers' gradients summed over the data
    group (keyed `layer{i}.<torch name>`, i global) and the pipe group's
    collectives."""
    import torch

    from openasr_torch.convert import subtree_to_state_dict
    from openasr_torch.models.layers import TransformerEncoderLayer
    from openasr_torch.parallel.pipeline import gpipe_apply, stage_layers

    pipe, data = grid.pipe, grid.data
    held = stage_layers(len(spec["layers"]), pipe.rank, pipe.world)
    layers = []
    for i in held:
        layer = TransformerEncoderLayer(*spec["dims"], "relu", 0.0)
        layer.load_state_dict(subtree_to_state_dict(spec["layers"][i]))
        layers.append(layer)
    b = spec["x"].shape[0] // data.world
    mine = slice(data.rank * b, (data.rank + 1) * b)
    x = torch.tensor(spec["x"][mine], requires_grad=True)
    pipe.reset_counts()
    out = gpipe_apply(lambda layer, h, aux, rng: layer(h, kv_lengths=aux["lengths"]), layers,
                      x, {"lengths": torch.tensor(spec["lengths"][mine])}, pipe, spec["m"],
                      remat=spec.get("remat", False), first=held.start)
    (out * torch.tensor(spec["cot"][mine])).sum().backward()
    grads = {f"layer{i}.{n}": data.all_reduce(p.grad.clone()).numpy()
             for i, layer in zip(held, layers) for n, p in layer.named_parameters()}
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(), "grads": grads,
            "calls": dict(pipe.calls), "bytes": dict(pipe.bytes)}


def worker_main(argv) -> None:
    host, port, rank, world, gloo = argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5]
    model = int(argv[6]) if len(argv) > 6 else 1
    pipe = int(argv[7]) if len(argv) > 7 else 1
    sys.path[:0] = [ROOT, HERE]
    import torch

    torch.set_num_threads(1)
    from openasr_torch.parallel import new_group
    from openasr_torch.parallel.mesh import destroy

    conn = Client((host, port), authkey=AUTHKEY)
    conn.send(rank)
    group = new_group(rank, world, f"tcp://localhost:{gloo}", "gloo", "cpu", model, pipe=pipe)
    scenarios = sys.modules[__name__]
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, args = msg
            try:
                conn.send(("ok", getattr(scenarios, name)(group, *args)))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        destroy(group)


if __name__ == "__main__":
    worker_main(sys.argv)

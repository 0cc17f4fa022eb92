"""Worker side of tests/test_torch_tp.py and of ``chip_smoke.py`` phase 24a:
runs the port's tensor-parallel pieces (``parallel/tp.py``) in a gloo process
group over a ``(data, model)`` mesh, one process a rank, on the CPU or with
every rank's tensors on the one card. Imports numpy, torch and the port only
(no JAX).

``run(rank, world, port, job_file, out_dir, device, data, model)`` joins the
group, reads the jobs that the caller wrote with ``torch.save`` and writes
each job's result to ``<out_dir>/rank<r>.pt``; ``ddp_worker.spawn_ranks``
starts the ranks (``target=run``).
"""

import contextlib
import copy
import os
import time

import torch

import ddp_worker
from recondet3d_torch.ops import attention, fps
from recondet3d_torch.parallel import Mesh, da3_param_shardings, init_distributed, local_mesh_context, make_mesh, \
    shard_params
from recondet3d_torch.parallel.tp import gather_full, param_layouts
from recondet3d_torch.train import Trainer
from recondet3d_torch.train.checkpoints import latest_checkpoint, save_checkpoint


def full_grads(model, group):
    """Every gradient of ``model`` as the whole tensor (the shards gathered over the model group)."""
    layouts = param_layouts(model)
    return {n: gather_full(p.grad, layouts[n], group) if n in layouts else p.grad.clone()
            for n, p in model.named_parameters() if p.grad is not None}


def forward(mesh, job):
    """A module's forward (no graph) on the global input after ``shard_params``; the layout it got."""
    model = copy.deepcopy(job["module"])
    specs = da3_param_shardings(model, mesh)
    shard_params(model, mesh)
    with torch.no_grad():
        out = model(job["x"])
    return dict(out=out, specs=specs, local_shapes={n: tuple(p.shape) for n, p in model.named_parameters()})


def trainer_step(mesh, job):
    """``Trainer`` steps on ``mesh`` from the job's module (each data rank takes its shard of the global batch):
    the metrics of every step (the ``warmup`` steps' first), the state after them with full tensors, the last step's
    full gradients, the flash launches by shape in the steps after the warm-up, and, with a ``checkpoint_dir``, the
    checkpoint it saved there. ``time_steps``: also the all-reduces' host time and the peak memory. ``lean``:
    instead of the state and gradients, the trained parameters (whole, on rank 0) after the warm-up, or after the
    steps without one, and every rank's checksum of its replicated parameters and floating
    buffers after the steps."""
    model = copy.deepcopy(job["module"])
    trainer = Trainer(model=model, mesh=mesh, **job["trainer"])
    state = trainer.init_state()
    warm = job.get("warmup", 0)
    warm_history, after_warmup = [], None
    if warm:
        state, warm_history = trainer.run(state, iter([job["batch"]] * warm))
        if job.get("lean"):
            after_warmup = _trained(model, trainer, mesh)
    attention.reset_launch_counts()
    fps.reset_launch_counts()
    timer = _ReduceTimer() if job.get("time_steps") else None
    cuda = next(model.parameters()).device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step_ms, history = [], []
    for _ in range(job["steps"]):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer if timer is not None else contextlib.nullcontext():
            state, h = trainer.run(state, iter([job["batch"]]))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history += h
    launches = {k: dict(getattr(attention, f).launches_by_shape) for k, f in (
        ("fwd", "flash_attention_fwd"), ("dq", "flash_attention_bwd_dq"), ("dkv", "flash_attention_bwd_dkv"))}
    launches["fps"] = dict(fps.furthest_point_sample_cuda.launches_by_shape)
    out = dict(history=warm_history + history, names=list(trainer.optimizer.names), launches=launches, step_ms=step_ms,
               local_shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    if job.get("lean"):
        # every rank's checksum of what must be the same bits on all of them: the replicated trained parameters
        # and the floating buffers (the shards differ by design)
        layouts, trained = param_layouts(model), set(trainer.optimizer.names)
        out["digest"] = {n: _digest(p.detach()) for n, p in model.named_parameters() if n in trained
                         and n not in layouts}
        out["digest"].update({n: _digest(b) for n, b in model.named_buffers() if b.is_floating_point()})
        out["params"] = after_warmup if warm else _trained(model, trainer, mesh)  # a collective: every rank or none
    else:
        out.update(state=state.state_dict(), grads=full_grads(model, mesh.model_group))
    if timer is not None:
        out["reduce_ms"] = timer.ms
        out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    if job.get("checkpoint_dir"):  # not the Trainer's work_dir, whose TensorBoard writer takes seconds to import
        save_checkpoint(job["checkpoint_dir"], state)
        out["checkpoint"] = latest_checkpoint(job["checkpoint_dir"])
    return out


def _trained(model, trainer, mesh):
    """The trained parameters, whole (gathered over the model group: every rank takes part), as fp32 on the host on
    global rank 0 and None elsewhere."""
    layouts, trained = param_layouts(model), set(trainer.optimizer.names)
    full = {n: gather_full(p.detach(), layouts[n], mesh.model_group) if n in layouts else p.detach()
            for n, p in model.named_parameters() if n in trained}
    return {n: v.to("cpu", torch.float32, copy=True) for n, v in full.items()} if torch.distributed.get_rank() == 0 \
        else None


def _digest(t):
    """A checksum of a tensor's bits (position-weighted; int64 sums wrap the same way in any order)."""
    bits = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).flatten().to(torch.int64)
    return int((bits * torch.arange(1, bits.numel() + 1, device=bits.device).remainder(65521)).sum())


class _ReduceTimer:
    """Host time spent in ``torch.distributed.all_reduce`` while active (gloo's all-reduce of CUDA tensors waits for
    the stream and copies through the host, so its host time is its cost)."""

    def __init__(self):
        self.ms = 0.0

    def __enter__(self):
        self._orig = torch.distributed.all_reduce

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return self._orig(*a, **k)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3

        torch.distributed.all_reduce = timed
        return self

    def __exit__(self, *a):
        torch.distributed.all_reduce = self._orig
        return False


def one_process(mesh, job):
    """The same steps in this process alone (a ``Mesh(1, 1)``: no collective, the whole global batch), run by global
    rank 0 after the group's jobs: history, state and gradients, as ``one_process_step`` would give them. The
    workers run torch alone, which is many times faster than a process that has imported JAX."""
    if torch.distributed.get_rank() != 0:
        return {}
    model = copy.deepcopy(job["module"])
    trainer = Trainer(model=model, mesh=Mesh(1, 1), **job["trainer"])
    _, history = trainer.run(trainer.init_state(), iter([job["batch"]] * job["steps"]))
    return dict(history=history, state=model.state_dict(), names=list(trainer.optimizer.names),
                grads={n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})


def batch_stats(mesh, job):
    """ddp_worker's batch-global statistics jobs on this mesh (each data rank its shard)."""
    with local_mesh_context(mesh):
        return {name: ddp_worker.JOBS[name](mesh, j) for name, j in job["jobs"].items()}


JOBS = dict(forward=forward, trainer_step=trainer_step, one_process=one_process, batch_stats=batch_stats)


def run(rank, world, port, job_file, out_dir, device="cpu", data=1, model=2):
    """One rank of a ``data x model`` mesh. On CUDA every rank uses the current card (gloo). Each job's result
    carries its wall ``seconds``."""
    torch.set_num_threads(2)
    if torch.device(device).type == "cuda":
        os.environ["LOCAL_RANK"] = "0"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_distributed(device, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, backend="gloo")
    try:
        jobs = torch.load(job_file, weights_only=False)
        mesh = make_mesh(data=data, model=model)
        results = {}
        for name, job in jobs.items():
            t0 = time.perf_counter()
            results[name] = dict(JOBS[job["kind"]](mesh, job), seconds=time.perf_counter() - t0)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()

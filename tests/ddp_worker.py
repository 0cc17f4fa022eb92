"""Worker side of tests/test_torch_ddp.py and of ``chip_smoke.py`` phase 22b:
runs the port's data-parallel pieces in a gloo process group, one process a
rank, on the CPU or with every rank's tensors on the one card. It imports
numpy, torch and the port only (no JAX), so that each rank starts quickly.

``run(rank, world, port, job_file, out_dir, device)`` joins the group, reads
the jobs that the caller wrote with ``torch.save`` (modules and global
inputs, on ``device``), runs each on this rank's share of the global batch
and writes what it got to ``<out_dir>/rank<r>.pt``.
``spawn_ranks`` starts the ranks; ``compare_with_one_process`` holds a
two-rank ``Trainer`` step to the same step in one process at the global batch.
"""

import copy
import os
import socket
import time

import numpy as np
import torch

from recondet3d_torch.ops import attention, fps
from recondet3d_torch.parallel import init_distributed, local_mesh_context, make_mesh, shard_batch
from recondet3d_torch.train import Trainer
from recondet3d_torch.utils import alignment


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}


def masked_bn(mesh, job):
    bn = copy.deepcopy(job["module"]).train()
    x = shard_batch(mesh, job["x"]).clone().requires_grad_(True)
    y = bn(x, shard_batch(mesh, job["mask"]))
    (y * shard_batch(mesh, job["w"])).sum().backward()
    return dict(y=y.detach(), x_grad=x.grad, grads=_grads(bn), running_mean=bn.running_mean,
                running_var=bn.running_var)


def flax_bn(mesh, job):
    bn = copy.deepcopy(job["module"]).train()
    x = shard_batch(mesh, job["x"]).clone().requires_grad_(True)
    y = bn(x)
    (y * shard_batch(mesh, job["w"])).sum().backward()
    return dict(y=y.detach(), x_grad=x.grad, grads=_grads(bn), running_mean=bn.running_mean,
                running_var=bn.running_var)


def centerhead(mesh, job):
    preds = [{k: v.clone().requires_grad_(True) for k, v in shard_batch(mesh, p).items()} for p in job["preds"]]
    losses = job["module"].loss(preds, shard_batch(mesh, job["targets"]))
    sum(losses.values()).backward()
    return dict(losses={k: v.detach() for k, v in losses.items()},
                grads=[{k: v.grad for k, v in p.items()} for p in preds])


def alignment_fns(mesh, job):
    x, a, b = (shard_batch(mesh, job[k]).clone().requires_grad_(True) for k in ("x", "a", "b"))
    mask = shard_batch(mesh, job["mask"])
    q50 = alignment.masked_quantile(x, mask, 0.5)
    q99 = alignment.masked_quantile(x, mask, 0.99)
    scale = alignment.least_squares_scale_scalar(a, b, mask=mask)
    (q50 + 2 * q99 + 3 * scale).backward()
    return dict(q50=q50.detach(), q99=q99.detach(), scale=scale.detach(), x_grad=x.grad, a_grad=a.grad,
                b_grad=b.grad)


def nested(mesh, job):
    with torch.no_grad():
        out = job["module"](shard_batch(mesh, job["x"]))
    return {k: out[k] for k in job["keys"]}


def trainer_step(mesh, job):
    """Steps of ``Trainer`` over the global batch (each rank takes its shard); the mesh is the Trainer's own. The
    kernels' launches (on CUDA tensors) are counted from 0 over the steps."""
    model = copy.deepcopy(job["module"])
    trainer = Trainer(model=model, **job["trainer"])
    attention.reset_launch_counts()
    fps.reset_launch_counts()
    state, history = trainer.run(trainer.init_state(), iter([job["batch"]] * job["steps"]))
    launches = dict(fwd=dict(attention.flash_attention_fwd.launches_by_shape),
                    fps=dict(fps.furthest_point_sample_cuda.launches_by_shape))
    return dict(history=history, state=model.state_dict(), names=list(trainer.optimizer.names), grads=_grads(model),
                frozen_requires_grad=[n for n, p in model.named_parameters() if p.requires_grad and ".da3." in n],
                launches=launches,
                valid_counts={k: [int(c) for c in v] for k, v in getattr(
                    model.reconstruction_backbone, "last_stage_counts", {}).items()})


def gather_probe(mesh, job):
    """Whether ``all_gather`` takes this device's tensors on the group's backend (gloo has no all-gather of CUDA
    tensors in some builds)."""
    x = torch.full((3,), float(mesh.data_index), device=job["device"])
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    try:
        torch.distributed.all_gather(parts, x, group=mesh.group)
    except RuntimeError as e:
        return dict(ok=False, error=str(e)[:300])
    return dict(ok=all(bool((p == i).all()) for i, p in enumerate(parts)), error=None)


JOBS = dict(masked_bn=masked_bn, flax_bn=flax_bn, centerhead=centerhead, alignment_fns=alignment_fns, nested=nested,
            trainer_step=trainer_step, gather_probe=gather_probe)


def run(rank, world, port, job_file, out_dir, device="cpu"):
    """One rank. On CUDA every rank uses the current card (gloo: NCCL takes one rank a device)."""
    torch.set_num_threads(2)
    if torch.device(device).type == "cuda":
        os.environ["LOCAL_RANK"] = "0"
        # the modules arrive pickled, not built: TF32 off as the package's builders turn it (presets.materialize_),
        # else cuDNN's fp32 convolutions round the DA3 heads' depth apart from the caller's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_distributed(device, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, backend="gloo")
    try:
        jobs = torch.load(job_file, weights_only=False)
        mesh = make_mesh()
        results = {}
        for name, job in jobs.items():
            if name == "trainer_step":
                results[name] = trainer_step(mesh, job)
                continue
            with local_mesh_context(mesh):
                results[name] = JOBS[name](mesh, job)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(world, job_file, out_dir, device="cpu", timeout=600.0, target=None, extra=()):
    """Run ``target(rank, world, port, job_file, out_dir, device, *extra)`` (default ``run``) in ``world`` fresh
    processes (a free localhost port for their group) and return each rank's results; raises if a rank fails, and
    stops them all if they have not ended within ``timeout`` seconds."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    context = torch.multiprocessing.spawn(target or run, args=(world, port, job_file, out_dir, device, *extra),
                                          nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not context.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in context.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not end within {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def tree_close(got, ref, rel, floor):
    """Leaf by leaf: max |got - ref| <= rel * max |ref leaf| + floor * max |ref tree| (numpy dicts); the leaves
    that fail, as (name, max |difference|, max |ref leaf|)."""
    top = max(np.abs(r).max() for r in ref.values())
    return [(k, float(np.abs(got[k] - r).max()), float(np.abs(r).max())) for k, r in ref.items()
            if np.abs(got[k] - r).max() > rel * np.abs(r).max() + floor * top]


def compare_with_one_process(got, model, history, lr):
    """A two-rank ``trainer_step`` result (``got``: rank 0's, with the other rank's state under ``other_state``)
    against ``model`` and ``history`` after the same step in one process at the global batch. The gates of
    tests/test_torch_ddp.py: metrics rtol 1e-6; gradients leaf by leaf within 1e-4 of the leaf's largest + 1e-6 of
    the tree's; parameters and batch statistics after the step rtol 1e-5 / atol 1e-7, but for elements whose
    gradient is rounding noise (below 1e-5 of the tree's largest), which Adam's first update moves by up to lr either
    way (2 * lr apart); the two ranks' states bit-identical. Returns a dict of findings; ``ok`` says whether all
    hold."""
    f32 = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    h, oh = got["history"][0], history[0]
    metric_err = {k: abs(h[k] - oh[k]) / max(abs(oh[k]), 1e-30) for k in oh if k != "steps_per_sec"}
    grads = {n: f32(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    bad_grads = tree_close({n: f32(g) for n, g in got["grads"].items()}, grads, 1e-4, 1e-6) \
        if set(got["grads"]) == set(grads) else [("names", sorted(set(got["grads"]) ^ set(grads)))]
    noise = 1e-5 * max(np.abs(g).max() for g in grads.values())
    ref = model.state_dict()
    bad_state, replicas_equal, noise_elements = [], True, 0
    for k, v in ref.items():
        a = got["state"][k]
        replicas_equal &= bool(torch.equal(a.cpu(), got["other_state"][k].cpu()))
        if not v.is_floating_point():
            if not torch.equal(a.cpu(), v.cpu()):
                bad_state.append(k)
            continue
        diff = np.abs(f32(a) - f32(v))
        ok = diff <= 1e-7 + 1e-5 * np.abs(f32(v))
        if k in grads:
            exempt = (np.abs(grads[k]) < noise) & (diff <= 2 * lr)
            noise_elements += int((exempt & ~ok).sum())
            ok |= exempt
        if not ok.all():
            bad_state.append((k, int((~ok).sum()), float(diff.max())))
    res = dict(metric_rel_err=metric_err, bad_grads=bad_grads, bad_state=bad_state, replicas_equal=replicas_equal,
               noise_elements_past_rtol=noise_elements, no_module_prefix=not any(k.startswith("module.") for k in
                                                                                 got["state"]))
    res["ok"] = (all(e <= 1e-6 for e in metric_err.values()) and not bad_grads and not bad_state and replicas_equal
                 and res["no_module_prefix"])
    return res

"""One rank of tests/test_torch_graphshard.py's process group, and the
inputs of its collective cases.

Run as a script (the test starts one process per rank):

    python tests/_torch_graphshard_worker.py RANK WORLD DIR

Each of the WORLD (4) ranks joins a gloo group through a FileStore in
DIR, reads the inputs the test wrote there (``inputs.pt``: the two
geometries, the JAX package's parameters as numpy, the driver's
configurations and parameters), and runs on a graph axis over ranks
{0, 1} (D = 2; ranks 2 and 3 sit it out) and over all four (D = 4):

- every collective forward and backward on rank-dependent inputs
  (``collective_inputs``) and ``sum_gradients_``;
- both sharded forwards, with and without ring attention, on both
  geometries: the energy, this rank's rows of -dE/dpos and the summed
  parameter gradients;
- at D = 2, three of the driver's train steps in both schemes: losses
  and the parameters after them.

It writes what it saw to ``out<RANK>.pt``, with the jax modules it found
loaded (none: it imports torch and the port only, never jax, the JAX
package or the tests' conftest).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CUTOFF = 2.5  # tests/test_graphshard.py's model
NG = 12
LAYERS = 2
HIDDEN = 16
IN_DIM = 4
SCHEMES = ("gather", "halo")


def collective_inputs(index, size):
    """Rank ``index``'s inputs (numpy f32) of the collective cases: the
    all-gather's [3, 2] block and its output weight [3 D, 2]; the
    reduce-scatter's [3 D, 2] input and its output weight [3, 2]; the
    ring shift's [3, 2] block and weight; the psum's scalar."""
    import numpy as np

    base = np.arange(6 * size, dtype=np.float32).reshape(3 * size, 2)
    return {
        "ag_x": (index + 1.0) * base[:3] + 0.5,
        "ag_w": np.cos(base * (index + 1.0)).astype(np.float32),
        "rs_x": np.sin(base + index).astype(np.float32),
        "rs_w": (index - 0.5) * base[:3],
        "pp_x": (index + 2.0) * base[:3],
        "pp_w": np.cos(base[:3] - index).astype(np.float32),
        "psum_x": np.float32(index + 1.5),
    }


def _t(a):
    import torch

    return torch.tensor(a).requires_grad_()


def case_collectives(mesh):
    """Forward outputs and input gradients of every collective on this
    rank; ``ppermute`` by +1 and by -1 (and by +2 at D = 4)."""
    import torch

    from hydragnn_tpu_torch.parallel import graphshard as gs

    inp = collective_inputs(mesh.index, mesh.size)
    out = {}
    x = _t(inp["ag_x"])
    y = gs.all_gather(mesh, x)
    (y * torch.tensor(inp["ag_w"])).sum().backward()
    out["all_gather"] = (y.detach().numpy(), x.grad.numpy())
    x = _t(inp["rs_x"])
    y = gs.reduce_scatter(mesh, x)
    (y * torch.tensor(inp["rs_w"])).sum().backward()
    out["reduce_scatter"] = (y.detach().numpy(), x.grad.numpy())
    for shift in (1, -1) + ((2,) if mesh.size == 4 else ()):
        x = _t(inp["pp_x"])
        (y,) = gs.ppermute(mesh, shift, x)
        (y * torch.tensor(inp["pp_w"])).sum().backward()
        out[f"ppermute{shift:+d}"] = (y.detach().numpy(), x.grad.numpy())
    x = _t(inp["psum_x"])
    y = gs.psum(mesh, x)
    y.backward()
    out["psum"] = (float(y), float(x.grad))
    params = {"a": {"w": _t(inp["ag_x"])}, "b": _t(inp["pp_x"][0])}
    for p in gs.param_leaves(params):
        p.grad = p.detach() * 2.0
    gs.sum_gradients_(params, mesh)
    out["sum_gradients"] = {k: t.grad.numpy() for k, t in gs.param_items(params)}
    out["stats"] = {k: v[0] for k, v in mesh.stats.items()}
    return out


def case_forward(mesh, geom, scheme, heads, params_np):
    """The energy, this rank's rows of -dE/dpos and the summed parameter
    gradients of one sharded forward."""
    import dataclasses

    from hydragnn_tpu_torch.parallel import graphshard as gs

    x, pos, ei = geom
    if scheme == "gather":
        shards = gs.GraphShards.build(x, pos, ei, mesh.size).local(mesh, "cpu")
        fwd = gs.sharded_mpnn_forward
    else:
        shards = gs.HaloShards.build(x, pos, ei, mesh.size).local(mesh, "cpu")
        fwd = gs.halo_mpnn_forward
    pos_l = shards.pos.clone().requires_grad_()
    params = gs.params_from_jax(params_np)
    e = fwd(params, dataclasses.replace(shards, pos=pos_l), mesh, cutoff=CUTOFF,
            num_gaussians=NG, num_layers=LAYERS, attn_heads=heads)
    e.backward()
    gs.sum_gradients_(params, mesh)
    return {"e": float(e), "forces": -pos_l.grad.numpy(),
            "grads": {k: t.grad.numpy() for k, t in gs.param_items(params)}}


def case_driver(mesh, drv):
    """Three of the driver's train steps per scheme from the JAX
    package's parameters: losses, then every parameter."""
    from hydragnn_tpu_torch.drivers import giant_graph as gg
    from hydragnn_tpu_torch.parallel import graphshard as gs

    configs, edge_cap = drv["configs"], drv["edge_cap"]
    kw = dict(cutoff=drv["cutoff"], num_gaussians=gg.NUM_GAUSSIANS,
              num_layers=gg.NUM_LAYERS, attn_heads=drv["heads"])
    out = {}
    for scheme in SCHEMES:
        host = gg.shard_configs(configs, edge_cap, mesh.size, halo=scheme == "halo")
        params = gs.params_from_jax(drv["params"])
        opt = gg.make_optimizer(params)
        fwd = gg.forward_for(scheme == "halo")
        losses = []
        for i in range(3):
            loss, _ = gg.train_step(fwd, params, opt, host[i].local(mesh, "cpu"), mesh,
                                    configs[i][2], drv["e_mean"], drv["e_std"], **kw)
            losses.append(float(loss))
        out[scheme] = (losses, {k: t.detach().numpy() for k, t in gs.param_items(params)})
    return out


def main(rank: int, world: int, work: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch.distributed as dist

    from hydragnn_tpu_torch.drivers import giant_graph  # noqa: F401
    from hydragnn_tpu_torch.parallel.mesh import make_mesh

    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    meshes = {2: make_mesh({"graph": 2}, ranks=[0, 1]), 4: make_mesh({"graph": 4})}
    out = {"index": {d: m.index for d, m in meshes.items()}, "collectives": {},
           "forward": {}}
    for d, mesh in meshes.items():
        if mesh.index < 0:
            continue
        out["collectives"][d] = case_collectives(mesh)
        for geom in sorted(inp["geoms"]):
            for scheme in SCHEMES:
                for heads in (0, 2):
                    out["forward"][(geom, scheme, d, heads)] = case_forward(
                        mesh, inp["geoms"][geom], scheme, heads, inp["params"][heads])
        if d == 2:
            out["driver"] = case_driver(mesh, inp["driver"])
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                       "hydragnn_tpu"))
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

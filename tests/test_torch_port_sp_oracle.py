"""Which JAX step the port's point-sharded train step's gradients are held
to: a script, with no tests of its own. Run it from the repository root on
the CPU:

    python -m tests.test_torch_port_sp_oracle

At ``test_train_step_parity``'s setup (``tests/test_parallel.py``: 2 clouds
of 256 points, K 4, decimation 2, layers [4, 8, 16, 32], dropout key 7) it
prints, for each pair of steps, the loss of each and the largest ratio over
the gradients of |Δg| to the test's gradient tolerance, 5e-4 + 5e-3·|g|
(above 1: the pair fails it). The steps: JAX's single-device step run
op-by-op (as JAX's test runs it) and jitted, JAX's ``point_sharded_model``
step on 8, 4 and 2 devices, and the port's step over 4 CPU ranks. Then the
searches' neighbour margins: the smallest gap between the 4th and 5th
squared distance at each level, and between the 1st and 2nd of each decoder
upsample (float64 distances of the float32 clouds).
"""

import numpy as np


def _steps():
    import jax
    import jax.numpy as jnp
    import torch

    from recognizer3d_tpu.models.randlanet import RandLANet
    from recognizer3d_tpu.models.settings import RandLANetSettings
    from recognizer3d_tpu.parallel.ring_knn import point_sharded_mesh
    from recognizer3d_tpu.parallel.sp_model import SPBackend, point_sharded_model
    from recognizer3d_tpu.training.losses import get_loss
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch import RandLANetSettings as PortSettings
    from recognizer3d_tpu_torch.models.weights import from_flax_variables
    from recognizer3d_tpu_torch.parallel import mesh
    from recognizer3d_tpu_torch.training import data_parallel
    from tests.test_torch_port_sp_train import DROPOUT_KEY, SETTINGS, _case

    variables, inputs, perm, labels, kept = _case()
    criterion = get_loss("dice")

    def step(net, v, x):
        def loss_fn(params):
            logits, upd = net.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                    jnp.asarray(perm), train=True, rngs={"dropout": DROPOUT_KEY},
                                    mutable=["batch_stats"])
            return criterion(logits, jnp.asarray(labels)), upd["batch_stats"]

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return loss, grads

    def host(result):
        loss, grads = jax.device_get(result)
        return float(loss), from_flax_variables({"params": jax.tree.map(np.asarray, grads)})

    single = RandLANet(RandLANetSettings(**SETTINGS))
    x = jnp.asarray(inputs)
    out = {"JAX single, op-by-op": host(step(single, variables, x)),
           "JAX single, jitted": host(jax.jit(lambda v, xx: step(single, v, xx))(variables, x))}
    for n in (8, 4, 2):
        jmesh = point_sharded_mesh(n)
        net = point_sharded_model(RandLANetSettings(**SETTINGS), jmesh)
        out[f"JAX point-sharded, {n} devices"] = host(jax.jit(lambda v, xx: step(net, v, xx))(
            variables, SPBackend(jmesh).shard_inputs(x)))
    model = Model(PortSettings(**SETTINGS), weights=from_flax_variables(variables), device="cpu")
    p = torch.from_numpy(perm).long()
    with mesh.RankPool(["cpu"] * 4) as pool:
        pool.run(data_parallel.adopt, "oracle", data_parallel.payload(model, "dice"))
        got = pool.run(data_parallel.step, "oracle", torch.from_numpy(inputs)[:, p],
                       torch.from_numpy(labels).long()[:, p], None,
                       torch.from_numpy(kept)[:, p], axis=1)[0]
    out["port point-sharded, 4 ranks"] = (got[0], got[1])
    return out, inputs, perm


def _ratio(a, b) -> float:
    return max(float(np.max(np.abs(a[k].numpy() - b[k].numpy())
                            / (5e-4 + 5e-3 * np.abs(b[k].numpy())))) for k in b)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    out, inputs, perm = _steps()
    names = list(out)
    for name in names:
        print(f"{name}: loss {out[name][0]:.9g}")
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(f"{a} vs {b}: max |dg| / (5e-4 + 5e-3 |g|) = {_ratio(out[a][1], out[b][1]):.4g}")
    xyz = inputs[:, perm].astype(np.float64)
    sizes = [256 // 2 ** i for i in range(5)]
    for level, n in enumerate(sizes[:4]):
        c = xyz[:, :n]
        d = np.sort(((c[:, :, None] - c[:, None]) ** 2).sum(-1), -1)
        gap = (d[..., 4] - d[..., 3]).min()
        print(f"level {level} ({n} points), K = 4: smallest d2 gap 4th/5th {gap:.3e}")
    for level in range(1, 5):
        q, s = xyz[:, :sizes[level - 1]], xyz[:, :sizes[level]]
        d = np.sort(((q[:, :, None] - s[:, None]) ** 2).sum(-1), -1)
        gap = (d[..., 1] - d[..., 0]).min()
        print(f"upsample {level} -> {level - 1}: smallest d2 gap 1st/2nd {gap:.3e}")


if __name__ == "__main__":
    main()

"""Write ``model_fixture.npz``: golden outputs of the last flax DSTD-GCN.

The functional model (``dstdgcn_tpu/models``) replaced a flax.linen one
with the same parameter-tree paths.  This script ran once against a
checkout of the flax-era tree (commit 7af46d5) and recorded, for
{dstdgcn, dstdgcn_fast} x {h36m, cmu, 3dpw} at small widths:

  * perturbed parameters and moved batch statistics (so every gate,
    alpha and BatchNorm affine is exercised);
  * the input, the eval-mode output;
  * the train-mode output (dropout 0) and the updated batch statistics;
  * gradients of ``mean(sin(train_out))`` w.r.t. every parameter.

Usage (needs flax; run from anywhere)::

    git archive 7af46d5 | tar -x -C OLD
    python tests/fixtures/make_model_fixture.py --src OLD \
        --out tests/fixtures/model_fixture.npz
"""

import argparse
import sys

import numpy as np

CASES = [(name, layout, v) for name in ("dstdgcn", "dstdgcn_fast")
         for layout, v in (("h36m", 22), ("cmu", 25), ("3dpw", 23))]
WIDTHS = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
              st_gcnn_dropout=0.0, num_feature=4, num_layers=1)


def _leaves(prefix, tree):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(f"{prefix}/{k}", v)
        else:
            yield prefix + "/" + k, np.asarray(v, np.float32)


def _pack(key, tree, out):
    """One flat float32 vector per tree plus an index of
    ``path|d0,d1,...`` strings in leaf order (few zip members)."""
    leaves = list(_leaves("", tree))
    out[key] = np.concatenate([a.ravel() for _, a in leaves])
    out[key + "_index"] = np.asarray(
        [f"{p[1:]}|{','.join(map(str, a.shape))}" for p, a in leaves])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from dstdgcn_tpu.models import get_model

    out = {}
    for i, (name, layout, v) in enumerate(CASES):
        case = f"{name}_{layout}"
        model = get_model(name, **{name: dict(WIDTHS, joints_to_consider=v,
                                              layout=layout)})
        rng = np.random.RandomState(i)
        x = jnp.asarray(rng.randn(2, 8, v, 3), jnp.float32)
        with jax.default_matmul_precision("highest"):
            variables = model.init({"params": jax.random.key(i)}, x,
                                   train=False)
            leaves, tdef = jax.tree_util.tree_flatten(variables["params"])
            keys = jax.random.split(jax.random.key(100 + i), len(leaves))
            params = jax.tree_util.tree_unflatten(tdef, [
                l + 0.05 * jax.random.normal(k, l.shape, l.dtype)
                for l, k in zip(leaves, keys)])
            _, upd = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x * 1.5 + 0.2, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(0)})
            stats = upd["batch_stats"]
            variables = {"params": params, "batch_stats": stats}
            eval_out = model.apply(variables, x, train=False)
            train_out, upd = model.apply(
                variables, x, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(0)})

            def loss(p):
                o, _ = model.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.key(0)})
                return jnp.mean(jnp.sin(o))

            grads = jax.grad(loss)(params)
        out[f"{case}/x"] = np.asarray(x)
        out[f"{case}/eval_out"] = np.asarray(eval_out)
        out[f"{case}/train_out"] = np.asarray(train_out)
        _pack(f"{case}/params", jax.device_get(params), out)
        _pack(f"{case}/batch_stats", jax.device_get(stats), out)
        _pack(f"{case}/train_stats", jax.device_get(upd["batch_stats"]), out)
        _pack(f"{case}/grads", jax.device_get(grads), out)
    np.savez_compressed(args.out, **out)
    print(f"wrote {len(out)} arrays to {args.out}")


if __name__ == "__main__":
    main()

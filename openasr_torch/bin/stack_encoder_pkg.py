"""Convert a checkpoint package between the per-layer encoder layout and
the stacked one.

Counterpart of tools/stack_encoder_pkg.py, with the same flags and output,
importing nothing of the JAX package.  The per-layer layout (`layer{i}`
children, the default) and the stacked one (`stack/stacked_layers`, one
layer tree with a leading [L] on every leaf) that `encoder.pipeline: true`
reads (parallel/pipeline.py):

  python -m openasr_torch.bin.stack_encoder_pkg in.pkg out.pkg            # stack
  python -m openasr_torch.bin.stack_encoder_pkg in.pkg out.pkg --unstack  # inverse
  ... --component encoder   (default; repeatable, a dotted path such as G.encoder)

The optimizer state is dropped (its moment trees mirror the old layout);
continuing from a converted package starts a fresh optimizer.
"""

from __future__ import annotations

import argparse

import numpy as np

from openasr_torch.parallel.pipeline import stack_layer_params, unstack_layer_params
from openasr_torch.utils.checkpoint import load_package, save_package


def _get_component(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _set_component(tree: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def convert_encoder(enc: dict, unstack: bool) -> dict:
    if unstack:
        if "stack" not in enc or "stacked_layers" not in enc["stack"]:
            raise SystemExit("package has no stacked layer group to unstack")
        stacked = enc["stack"]["stacked_layers"]
        out = {k: v for k, v in enc.items() if k != "stack"}
        out.update(unstack_layer_params(stacked, int(_first_leaf(stacked).shape[0])))
        return out
    stacked, n = stack_layer_params(enc)
    out = {k: v for k, v in enc.items() if not (k.startswith("layer") and k[5:].isdigit())}
    out["stack"] = {"stacked_layers": stacked}
    print(f"stacked {n} layers")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--unstack", action="store_true")
    ap.add_argument("--component", action="append", default=None,
                    help="dotted component path(s), default: encoder")
    args = ap.parse_args(argv)

    pkg = load_package(args.input)
    components = pkg["model"]["components"]
    for comp in args.component or ["encoder"]:
        _set_component(components, comp,
                       convert_encoder(_get_component(components, comp), args.unstack))
    if pkg.get("optim_state") is not None:
        print("note: optimizer state dropped (layout changed); resume "
              "starts a fresh optimizer")
        pkg["optim_state"] = None
    save_package(pkg, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()

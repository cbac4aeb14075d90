#!/usr/bin/env python3
"""Replay the cross-check of a train step that ``chip_smoke.py`` makes (one
step on the card against the same step on the CPU in bf16 and in f32, same
weights, batch and draws) from saved weights, and break each model's
gradient down by parameter.  Needs one CUDA card.

    python3 chip_xcheck.py save FAMILY STATE [--init]
    python3 chip_xcheck.py check FAMILY STATE

``save`` trains FAMILY (kpcn, lbmc or sbmc) as ``chip_smoke.py``'s train
phase does and saves the weights, the batch and the state of the draws'
generator that its cross-check starts from (with ``--init``, the seeded
initial weights instead).  ``check`` runs ``chip_smoke.py``'s cross-check
from STATE with the code of the tree it is run from (copy this file to the
root of another checkout to hold that checkout's code against the same
weights) and prints one JSON line: the check's readings, or its failure,
and for each model the norm of its gradient on the card, on the CPU in
bf16 and in f32, and of each difference."""

from __future__ import annotations

import argparse
import json
import sys


def save(torch, cs, family, path, init):
    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.train.factory import init_interfaces

    def keep(torch_, iface, batch, family_):
        torch.save({"models": {n: m.state_dict() for n, m in iface.models.items()},
                    "batch": {k: v.cpu() for k, v in batch.items()},
                    "generator": iface.generator.get_state()}, path)
        return {}

    dev = torch.device("cuda", 0)
    if init:
        import numpy as np

        batch = synthetic_batch(np.random.default_rng(cs.SEED), family, 8, 128, 8, True)
        iface = init_interfaces(cs.train_config(family), device=dev)[0]
        iface.to_train_mode()
        keep(torch, iface, {k: v[:2].to(dev) for k, v in batch.items()}, family)
    else:
        cs.train_phase(torch, dev, family, check=keep)


def grads(iface, batch, draws):
    iface.preprocess(batch)
    iface.train_batch(batch, grad_hook_mode=True, draws=draws)
    return {n: {pn: p.grad.detach().double().cpu().clone() for pn, p in m.named_parameters()}
            for n, m in iface.models.items()}


def check(torch, cs, family, path):
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.train.factory import init_interfaces

    state = torch.load(path, weights_only=False)
    dev = torch.device("cuda", 0)
    iface = init_interfaces(cs.train_config(family), device=dev)[0]
    for name, m in iface.models.items():
        m.load_state_dict(state["models"][name])
    iface.to_train_mode()
    batch = {k: v.to(dev) for k, v in state["batch"].items()}
    iface.generator.set_state(state["generator"])
    draws = cs.step_draws(iface, batch, family)
    iface.generator.set_state(state["generator"])
    out = {"family": family}
    try:
        out["cross_check"] = cs.cross_check(torch, iface, batch, family)
    except AssertionError as exc:
        out["cross_check_failed"] = str(exc)
    # per parameter: the card step, and the CPU steps in bf16 and in f32
    steps = {"card": grads(iface, batch, draws)}
    host = {k: v.cpu() for k, v in batch.items()}
    for dtype in ("bfloat16", "float32"):
        ref = init_interfaces(cs.train_config(family, compute_dtype=dtype), device="cpu")[0]
        for name, m in iface.models.items():
            convert.load_flax_params(ref.models[name], convert.to_flax(m))
        ref.to_train_mode()
        steps[dtype] = grads(ref, host, draws)
    out["norms"] = {}
    for model in steps["card"]:
        flat = {k: torch.cat([g.flatten() for g in steps[k][model].values()]) for k in steps}
        out["norms"][model] = {
            "card": flat["card"].norm().item(), "bf16": flat["bfloat16"].norm().item(),
            "f32": flat["float32"].norm().item(),
            "card-bf16": (flat["card"] - flat["bfloat16"]).norm().item(),
            "card-f32": (flat["card"] - flat["float32"]).norm().item(),
            "bf16-f32": (flat["bfloat16"] - flat["float32"]).norm().item()}
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("action", choices=("save", "check"))
    parser.add_argument("family", choices=("kpcn", "lbmc", "sbmc"))
    parser.add_argument("state")
    parser.add_argument("--init", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_xcheck: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.action == "save":
        save(torch, cs, args.family, args.state, args.init)
    else:
        check(torch, cs, args.family, args.state)
    return 0


if __name__ == "__main__":
    sys.exit(main())

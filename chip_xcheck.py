#!/usr/bin/env python3
"""Replay the cross-check of a train step that ``chip_smoke.py`` makes (one
step on the card against the same step on the CPU in bf16 and in f32, same
weights, batch and draws) from saved weights.  Needs one CUDA card.

    python3 chip_xcheck.py save FAMILY STATE [--init]
    python3 chip_xcheck.py check FAMILY STATE

``save`` trains FAMILY (kpcn, lbmc or sbmc) as ``chip_smoke.py``'s train
phase does and saves the weights, the batch and the state of the draws'
generator that its cross-check starts from (with ``--init``, the seeded
initial weights instead).  ``check`` runs ``chip_smoke.py``'s cross-check
from STATE with the code of the tree it is run from (copy this file and
``chip_smoke.py`` to the root of another checkout to hold that checkout's
code against the same weights and the same decision) and prints one JSON
line: the check's record, passed or failed (per model and loss the
decision's terms: n = |g_b - g_f|, |g_c - g_b| and |g_c - g_f| beside their
limits), and for each model the norm of its gradient on the card, on the
CPU in bf16 and in f32, and of each difference."""

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


def check(torch, cs, family, path):
    from wcmc_tpu_torch.train.factory import init_interfaces

    state = torch.load(path, weights_only=False)
    dev = torch.device("cuda", 0)
    iface = init_interfaces(cs.train_config(family), device=dev)[0]
    for name, m in iface.models.items():
        m.load_state_dict(state["models"][name])
    iface.to_train_mode()
    batch = {k: v.to(dev) for k, v in state["batch"].items()}
    iface.generator.set_state(state["generator"])
    out = {"family": family}
    try:
        record = out["cross_check"] = cs.cross_check(torch, iface, batch, family)
    except AssertionError as exc:
        record = out["cross_check_failed"] = exc.record
    # per model: the norms of the card's, the CPU bf16 and f32 gradients
    # and of each difference, from the check's record
    out["norms"] = {}
    for model in record["float32"]["grads"]:
        t = record["decision"][model]
        card = record["float32"]["grads"][model]["norm_ratio"] * t["f32"]
        out["norms"][model] = {
            "card": card, "bf16": card / record["bfloat16"]["grads"][model]["norm_ratio"],
            "f32": t["f32"], "card-bf16": t["card-bf16"], "card-f32": t["card-f32"],
            "bf16-f32": t["n"]}
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

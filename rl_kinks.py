#!/usr/bin/env python3
"""How far the card's PPO update parts from the CPU's, and whether
``chip_smoke.py``'s card check tells that from TF32's.

    python3 rl_kinks.py [--device cuda|cpu] [--config pixel|cartpole]
                        [--updates N] [--jsonl PATH]

The PPO config of ``chip_smoke.py``'s phase 17 (pixel) or 16 (cartpole)
is built on ``--device`` and trained for four iterations, the state at
which those phases hold their update. Then, on each of N fresh rollouts
(one more iteration apart), one update runs from the learner's state with
its branches recorded (``chip_smoke._Branches``), and a CPU twin runs the
same update from the same state twice: plainly, and taking the recorded
branches; then the update runs once more on ``--device`` with TF32 on
(``chip_smoke.tf32_in_ppo_updates``). Each line gives the whole update's
step difference (``chip_smoke._rel_step``) of the plain, the aligned and
the TF32 comparison, the worst single tensor's aligned one, the decisions
the twin would have made otherwise and the worst such one's distance from
its kink over its tensor's RMS. With ``--device cpu`` the recorded update
is a CPU learner's whose parameters were moved by 1e-7 in relative terms
(a seeded draw each update): the CPU against itself, a rate of jumps with
no device in it (TF32 does not apply there).

Exits non-zero if an aligned step differs by more than
``chip_smoke.RL_STEP_TOL``, a TF32 one by no more than it (on the card),
or a decision differs further than ``chip_smoke.KINK_TOL`` from its kink.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--config", default="pixel",
                    choices=("pixel", "cartpole"))
    ap.add_argument("--updates", type=int, default=40)
    ap.add_argument("--jsonl")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rl_kinks: no CUDA device", file=sys.stderr)
        return 1
    algo = (cs.pixel_ppo_config if args.config == "pixel"
            else cs.ppo_config)(args.device).build()
    for _ in range(4):
        algo.train()
    learner = algo.learner
    twin = type(learner)(learner.module, {**learner.config, "device": "cpu"})
    rows = []
    for i in range(args.updates):
        batch = algo._concat_time_major(algo.env_runner_group.sample())
        state = start = learner.get_state()
        perms = learner.permutations(batch["rewards"].size)
        if args.device == "cpu":
            start = copy.deepcopy(state)
            gen = torch.Generator().manual_seed(i)
            for k, v in start["params"].items():
                start["params"][k] = v * (1 + 1e-7 * torch.randn(
                    v.shape, generator=gen))
            learner.set_state(start)
        before = start["params"]
        with cs._Branches() as recorded:
            learner.update(batch, perms)
        after = learner.get_weights()
        row = {"update": i}
        for how, replay in (("plain", None), ("aligned", recorded.taken)):
            twin.set_state(state)
            with cs._Branches(replay) as branches:
                twin.update(batch, perms)
            want = {k: v - state["params"][k]
                    for k, v in twin.get_weights().items()}
            row[how] = cs._rel_step(after, before, want)
        learner.set_state(start)
        with cs.tf32_in_ppo_updates():
            learner.update(batch, perms)
        row["tf32"] = cs._rel_step(learner.get_weights(), before, want)
        rel = cs._rel_steps(after, before, want)
        row["worst_tensor"] = max(rel, key=rel.get)
        row["worst_tensor_aligned"] = rel[row["worst_tensor"]]
        row["differing"] = branches.differing
        row["margin"] = branches.worst_margin
        rows.append(row)
        print(json.dumps(row), flush=True)
        learner.set_state(state)
        algo.training_step()
    algo.stop()
    summary = {
        "device": args.device, "config": args.config, "updates": len(rows),
        "card": torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu",
        "plain_max": max(r["plain"] for r in rows),
        "plain_over_tol": sum(r["plain"] > cs.RL_STEP_TOL for r in rows),
        "aligned_max": max(r["aligned"] for r in rows),
        "aligned_max_first_half": max(
            r["aligned"] for r in rows[:max(1, len(rows) // 2)]),
        "aligned_over_tol": sum(r["aligned"] > cs.RL_STEP_TOL
                                for r in rows),
        "tf32_min": min(r["tf32"] for r in rows),
        "tf32_within_tol": sum(r["tf32"] <= cs.RL_STEP_TOL for r in rows),
        "worst_tensor_aligned_max": max(r["worst_tensor_aligned"]
                                        for r in rows),
        "with_differing": sum(r["differing"] > 0 for r in rows),
        "margin_max": max(r["margin"] for r in rows)}
    print(json.dumps(summary))
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            f.write(json.dumps({"summary": summary, "rows": rows}) + "\n")
    return int(summary["aligned_over_tol"] > 0
               or summary["margin_max"] > cs.KINK_TOL
               or (args.device == "cuda" and summary["tf32_within_tol"] > 0))


if __name__ == "__main__":
    sys.exit(main())

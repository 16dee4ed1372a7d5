"""Train the tiny chat LM by self-distillation (see policies/chat_lm.py).

The template composer (server/chat.py) plays teacher over simulated oracle
rooms; the transformer learns context -> reply next-char prediction on the
device.

    python -m game_engine_tpu.train.chat_lm --steps 3000 \
        --out docs/checkpoints/chat_lm.npz

Deterministic end to end: the corpus, shuffling and init all derive from
--seed, so a retrain reproduces the shipped checkpoint bit-for-bit on the
same jax version.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from game_engine_tpu.policies import chat_lm as C


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-pairs", type=int, default=50000)
    ap.add_argument("--games", default="werewolf,two-truths-and-a-lie",
                    help="comma list of catalog games for the corpus "
                         "(per-game quota of --max-pairs)")
    ap.add_argument("--seeds", type=int, default=260,
                    help="rooms simulated per game for the corpus")
    ap.add_argument("--d-model", type=int, default=160)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=576)
    ap.add_argument("--out", default="chat_lm.npz")
    ap.add_argument("--cpu", action="store_true", help="force CPU (tests)")
    ap.add_argument("--lr-decay", action="store_true",
                    help="cosine-decay lr to lr/10 over --steps (the long "
                         "runs need it: constant 3e-4 plateaus ~0.14/char, "
                         "too hot for exact-match greedy decoding)")
    ap.add_argument("--eval-ckpt", default=None, metavar="CKPT_NPZ",
                    help="skip training: load this checkpoint and run only "
                         "the held-out evaluation block (metrics written "
                         "next to the checkpoint). --seeds MUST match the "
                         "training run's value — the eval rooms are seeds "
                         "[seeds, seeds+25), so a mismatch evaluates on "
                         "TRAINING rooms and reports memorization")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    if args.eval_ckpt:
        params, cfg = C.load(args.eval_ckpt)
        args.out = args.eval_ckpt
        _evaluate(args, params, cfg)
        return

    # grounded=True: the corpus includes field Q&A conditioned on the G=
    # fact segment, so the shipped checkpoint may serve state questions
    # (server.chat.lm_may_serve; commit_reply verifies each decode)
    cfg = C.LMConfig(d_model=args.d_model, n_layers=args.layers,
                     max_len=args.max_len, grounded=True, personas=True,
                     kinds2=True, sus2=True)
    t0 = time.time()
    pairs = C.build_corpus(games=tuple(args.games.split(",")),
                           seeds=range(args.seeds), max_pairs=args.max_pairs)
    # drop pairs encode_pair would truncate: a clipped reply has no EOS, so
    # training on it teaches run-on decodes. Loud — a growing count means
    # the context format outgrew max_len again (it did at 448 when the
    # grounded G= and persona Pe= segments landed).
    fit = [(c, r) for c, r in pairs if C.pair_fits(c, r, cfg)]
    if len(fit) < len(pairs):
        print(f"WARNING: dropped {len(pairs) - len(fit)} of {len(pairs)} "
              f"pairs that overflow max_len={cfg.max_len}")
    pairs = fit
    toks, masks = zip(*(C.encode_pair(c, r, cfg) for c, r in pairs))
    toks = np.stack(toks)
    masks = np.stack(masks)
    print(f"corpus: {len(pairs)} pairs in {time.time() - t0:.1f}s "
          f"(mean reply {np.mean([len(r) for _, r in pairs]):.1f} chars)")

    params = C.init_params(jax.random.PRNGKey(args.seed), cfg)
    if args.lr_decay:
        sched = optax.cosine_decay_schedule(args.lr, args.steps,
                                            alpha=0.1)
        tx = optax.adam(sched)
    else:
        tx = optax.adam(args.lr)
    opt = tx.init(params)

    @jax.jit
    def train_step(params, opt, tok, mask):
        loss, grads = jax.value_and_grad(C.loss_fn)(params, tok, mask, cfg)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    rng = np.random.default_rng(args.seed)
    n = len(toks)
    t0 = time.time()
    for step in range(args.steps):
        idx = rng.integers(0, n, size=args.batch)
        params, opt, loss = train_step(params, opt,
                                       jnp.asarray(toks[idx]),
                                       jnp.asarray(masks[idx]))
        if step % 200 == 0 or step == args.steps - 1:
            print(json.dumps({"step": step, "loss": round(float(loss), 4),
                              "wall_s": round(time.time() - t0, 1)}))

    C.save(args.out, params, cfg)
    # smoke-decode two corpus contexts so the artifact is demonstrably live
    for ctx, ref in pairs[:2]:
        print("CTX ", ctx)
        print("LM  ", C.greedy_reply(params, cfg, ctx))
        print("REF ", ref)
    _evaluate(args, params, cfg)


def _evaluate(args, params, cfg) -> None:
    # held-out evaluation on UNSEEN seeds (rooms, rosters, senders): exact
    # match vs the teacher composer, plus name-copy faithfulness — every
    # roster name the reference reply quotes must appear verbatim in the
    # decode (the round-2 garble metric). Published in docs/PERF.md.
    import re as _re

    from game_engine_tpu.server.chat import grounded_reply_ok

    eval_pairs = C.build_corpus(seeds=range(args.seeds, args.seeds + 25),
                                max_pairs=700)
    em = 0
    name_oblig = name_met = 0
    g_total = g_em = g_faithful = 0
    v2_total = v2_em = v2_faithful = 0
    by_kind: dict = {}  # kind -> [total, exact]

    def fold(s):
        # the exact target is the tokenizer's ENCODABLE projection of the
        # reference (em-dashes/smart quotes fold to ASCII, everything
        # outside the byte vocab — the composer's clip ellipsis "…" — is
        # dropped): the student is scored on what it could possibly emit.
        # Scoring against the raw reference mislabeled every clipped rules
        # digest as a miss (r4b first-eval artifact: rules EM 0.02).
        return C.decode_tokens(C.encode_text(s))

    for ctx, ref in eval_pairs:
        out = C.greedy_reply(params, cfg, ctx)
        em += int(fold(out) == fold(ref))
        kind = ctx.split("|", 1)[0][2:]  # "K=<kind>|…"
        row = by_kind.setdefault(kind, [0, 0])
        row[0] += 1
        row[1] += int(fold(out) == fold(ref))
        gm = _re.search(r"\|G=([^|;]*);([^|;]*);([^|;]*);(h|p)(s|o)", ctx)
        if gm:  # grounded field question: the round-4 faithfulness metric
            g_total += 1
            g_em += int(fold(out) == fold(ref))
            g_faithful += int(grounded_reply_ok(fold(out), {
                "fname": gm.group(2), "val": gm.group(3) or None,
                "hidden": gm.group(4) == "h"}))
        vm = _re.search(r"\|(Gd|Hn)=([^|]+)", ctx)
        if vm or "|Wt=" in ctx:  # v2 intent (rules/history/advice)
            # faithfulness: when the context carries a quoted segment
            # (non-empty Gd=/Hn=), the decode must contain it verbatim —
            # the serving gate (hook.kinds2) has no per-reply verifier for
            # these, so the promotion bar lives here
            v2_total += 1
            v2_em += int(fold(out) == fold(ref))
            v2_faithful += int(
                fold(vm.group(2)) in fold(out) if vm
                else fold(out) == fold(ref))
        m = _re.search(r"\|Ns=([^|]*)", ctx)
        roster = [e.split(":", 1)[1] for e in m.group(1).split(",")
                  if ":" in e] if m else []
        for nm in roster:
            if len(nm) >= 3 and _re.search(rf"\b{_re.escape(nm)}\b", ref):
                name_oblig += 1
                name_met += int(_re.search(rf"\b{_re.escape(nm)}\b", out)
                                is not None)
    metrics = {
        # provenance: which rooms this eval used (seeds [start, start+25));
        # a reader can check it against the training run's --seeds
        "eval_seed_start": args.seeds,
        "eval_pairs": len(eval_pairs),
        "exact_match": round(em / max(1, len(eval_pairs)), 4),
        "name_copy_obligations": name_oblig,
        "name_copy_rate": round(name_met / max(1, name_oblig), 4),
        "grounded_pairs": g_total,
        "grounded_exact_match": round(g_em / max(1, g_total), 4),
        "grounded_faithful_rate": round(g_faithful / max(1, g_total), 4),
        "v2_pairs": v2_total,
        "v2_exact_match": round(v2_em / max(1, v2_total), 4),
        "v2_faithful_rate": round(v2_faithful / max(1, v2_total), 4),
        # which intent family fails (if any) decides what to fix, not
        # whether to promote — the bars above are the promotion gate
        "by_kind_exact_match": {
            k: [n, round(e / max(1, n), 4)]
            for k, (n, e) in sorted(by_kind.items())},
    }
    print("HELD-OUT", json.dumps(metrics))
    with open(args.out.replace(".npz", "") + ".metrics.json", "w") as f:
        json.dump(metrics, f)
    print("saved", args.out)


if __name__ == "__main__":
    main()

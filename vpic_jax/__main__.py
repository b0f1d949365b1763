"""CLI front-end (the bin/vpic deck-runner analogue, deck/main.cc):

    python -m vpic_jax DECK.py [deck args...] [--restore FBASE.TAG]
                               [--modify FILE] [--num-step N]
                               [--energies FILE] [--checkpt BASE[:INTERVAL]]

DECK.py must define ``build(argv) -> Simulation`` (or ``build()``).
The reference compiles decks into the binary; here the deck is imported and
its Simulation driven by Simulation.run().
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vpic_jax")
    ap.add_argument("deck", help="deck .py defining build() -> Simulation, "
                    "or a built-in model name (harris, weibel, beam_plas, "
                    "lpi, reconnection)")
    ap.add_argument("--restore", default=None,
                    help="checkpoint fbase.tag to restore from")
    ap.add_argument("--remap", action="store_true",
                    help="with --restore: re-decompose the checkpoint "
                    "onto this deck's topology (restart_remap analogue)")
    ap.add_argument("--modify", default=None,
                    help="ASCII overrides file (num_step, intervals)")
    ap.add_argument("--num-step", type=int, default=None)
    ap.add_argument("--energies", default=None, help="energies dump file")
    ap.add_argument("--checkpt", default=None,
                    help="BASE[:INTERVAL] interval checkpointing")
    ap.add_argument("--quota", type=float, default=None,
                    help="wall-clock quota in seconds (checkpoints + stops)")
    args, deck_args = ap.parse_known_args(argv)

    if args.deck.endswith(".py"):
        spec = importlib.util.spec_from_file_location("deck", args.deck)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        try:
            mod = importlib.import_module(f"vpic_jax.models.{args.deck}")
        except ModuleNotFoundError:
            from . import models as _m
            known = ", ".join(sorted(m for m in dir(_m)
                                     if not m.startswith("_")))
            ap.error(f"unknown deck {args.deck!r} (built-ins: {known})")

    import inspect
    params = inspect.signature(mod.build).parameters
    first = next(iter(params.values()), None)
    if first is not None and first.annotation in (list, "list") or \
            (first is not None and first.name in ("argv", "args")):
        sim = mod.build(deck_args)
    else:
        sim = mod.build()

    from . import checkpoint as ck
    if args.modify:
        ck.modify(sim, args.modify)

    if args.restore and args.remap:
        state = ck.remap(args.restore, sim)
    elif args.restore:
        state = ck.restore(args.restore, sim=sim)
    else:
        state = None
    base, interval = None, 0
    if args.checkpt:
        parts = args.checkpt.split(":")
        base = parts[0]
        interval = int(parts[1]) if len(parts) > 1 else 0
    state = sim.run(state, num_step=args.num_step,
                    energies_file=args.energies, checkpt_base=base,
                    checkpt_interval=interval, quota_s=args.quota)
    return state


if __name__ == "__main__":
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()

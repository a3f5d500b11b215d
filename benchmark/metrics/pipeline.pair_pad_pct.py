"""pipeline.pair_pad_pct: the share (%) of the ligand x receptor pair slots
the window's docks ran that are padding, from the program's counts
(``DockingResult.timings``): ``pair_real`` (real ligand atoms x residues)
and ``pair_slots`` (the padded bucket's), each times the poses of every
pose batch the dock ran."""


def read(ctx):
    real = slots = 0
    for r in ctx.records:
        rec = getattr(r.result, "timings", None)
        if rec is not None:
            real += rec.counts.get("pair_real", 0)
            slots += rec.counts.get("pair_slots", 0)
    return 100.0 * (1.0 - real / slots) if slots else None

"""pipeline.pad_pct: the share (%) of the ligand x receptor pair slots the
window's docks ran that are padding, weighted by poses; each complex's
slots are its bucket's (``DockingPipeline.dock_bucket``), its pairs its
real atoms times residues."""


def read(ctx):
    real = sum(ctx.poses * ctx.cycle[r.complex][0] * ctx.cycle[r.complex][1] for r in ctx.records)
    slots = sum(ctx.poses * ctx.buckets[r.complex][0] * ctx.buckets[r.complex][1] for r in ctx.records)
    return 100.0 * (1.0 - real / slots) if slots else None

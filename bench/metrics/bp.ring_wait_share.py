"""bp.ring_wait_share (%): the share of the back-projection kernel's
(warp, projection) steps at which the warp found the projection's stage
of its ring not yet full (its copies or terms had not landed), over the
window's launches: the kernel's own count, which the program reads at
each traced ``engine.batched`` fence into the span's ``ring_waits`` arg,
over 32 warps times its ``tile_pairs``. Nothing is read where no span
carries ``ring_waits``: a program whose kernel has no ring, or the CPU,
which runs the kernel's plain version and counts nothing."""

WARPS = 32    # warps a block of the kernel runs, each through every step


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    waits = pairs = 0
    seen = False
    for e in get_tracer().spans("engine.batched"):
        args = e.get("args", {})
        if "ring_waits" not in args:
            continue
        seen = True
        waits += args["ring_waits"]
        pairs += args.get("tile_pairs", 0)
    return 100.0 * waits / (WARPS * pairs) if seen and pairs else None

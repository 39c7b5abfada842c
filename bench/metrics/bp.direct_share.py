"""bp.direct_share (%): the share of the back-projection kernel's (tile,
projection) pairs whose footprint boxes missed its shared-memory staging
buffer and were gathered from global memory, over the window's launches:
the kernel's own count, which the program reads at each traced
``engine.batched`` fence into the span's ``direct_pairs`` and
``tile_pairs`` args. Nothing is read where no span carries them (the CPU
runs the kernel's plain version, which counts nothing)."""


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    direct = pairs = 0
    for e in get_tracer().spans("engine.batched"):
        args = e.get("args", {})
        direct += args.get("direct_pairs", 0)
        pairs += args.get("tile_pairs", 0)
    return 100.0 * direct / pairs if pairs else None

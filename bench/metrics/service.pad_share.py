"""service.pad_share (%): pad lanes over all lanes the traced window's
buckets ran, from the service's `service.padded_lanes` and
`service.scans.served` counters. Each pad lane costs a whole
reconstruction, as the batched engine runs its lanes in series."""


def read(ctx):
    pads, served = ctx.service["padded_lanes"], ctx.service["served"]
    if not pads + served:
        return None
    return 100.0 * pads / (pads + served)

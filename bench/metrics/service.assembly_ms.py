"""service.assembly_ms (ms): mean bucket assembly time over the traced
window, from the service's own `service.bucket_assembly_seconds`
histogram: each lane made a device tensor (a host to card copy on the
serving thread where scans arrive in host memory), the pad lanes and the
stack. It reads `service.assembly_ms.device` (scans already on the card)
and `service.assembly_ms.host` (scans in host memory), one name for each
end-to-end metric it moves."""


def read(ctx):
    n = ctx.service["buckets_assembled"]
    if not n:
        return None
    return 1e3 * ctx.service["assembly_seconds"] / n

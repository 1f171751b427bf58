"""Host entropy coding per batch, ms: the thread pool's z and y encodes
(``ChannelCoder._pool_map``, one call per compress) and the z decodes
(``FactorizedCoder.decode_symbols``, one per image) on the host clock,
summed over the window and divided by its roundtrips."""


def read(rec):
    pool, z = rec.host_s.get("host_coding"), rec.host_s.get("z_decode")
    n = rec.values.get("passes")
    if not pool or not n:
        return None
    return 1e3 * (sum(pool) + sum(z or ())) / n

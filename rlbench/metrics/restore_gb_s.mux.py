"""Host-to-device rate of the host cache's warm-start restores in the
window: their bytes over the seconds between the CUDA events around each
restore's copies."""


def read(obs):
    rs = obs.get("restores") or []
    secs = sum(s for _, s in rs)
    return sum(n for n, _ in rs) / secs / 1e9 if secs > 0 else None

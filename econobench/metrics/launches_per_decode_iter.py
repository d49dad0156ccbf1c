"""Engine loop: device kernels and copies launched inside ``engine.decode``
per decode iteration of the traced slice, the iterations counted on the
device (paged decode launches / attention layers: a megastep window runs
its iterations in one host step)."""


def read(s):
    iters = s.prof.kernel_n.get("decode", 0) / s.cfg["attn_layers"]
    k = s.prof.span_launches["engine.decode"]
    return k / iters if iters and k else None

"""Model: device ms owned by ``engine.decode`` (the aten kernels launched
inside it and the paged decode kernel) per decode iteration of the traced
slice, the iterations counted on the device (paged decode launches /
attention layers)."""


def read(s):
    iters = s.prof.kernel_n.get("decode", 0) / s.cfg["attn_layers"]
    t = s.prof.span_s["engine.decode"]
    return 1e3 * t / iters if iters and t else None

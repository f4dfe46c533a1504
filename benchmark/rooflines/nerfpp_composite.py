"""The NeRF++ composite of every level: fg and bg rgb, density and t read
once per sample (the ray's direction and sphere exit once per ray), the
weights written once per sample and the ray's 12 outputs once, float32."""

KERNELS = (r"composite_nerfpp_kernel",)


def least_bytes(w):
    total = 0
    for count, rays, s_fg, s_bg in w.all_levels():
        per_ray = 5 * (s_fg + s_bg) + 4 + (s_fg + s_bg) + 12
        total += count * rays * per_ray * 4
    return total

"""The plain layout of `primitives3.json`'s scene, upstream's primitives3
(examples3d/primitives3.rs:13-60): a fixed ground cuboid (100.1, 2.1, 100.1)
at y = -2.1, then `num_layers` layers of `grid` x `grid` bodies of radius
`rad`, 3 rad apart, layer j at y = 3 rad j + 1.5 rad + 3 and shifted by
-0.05 rad (grid - 1) in x and z a layer (the start offset, centred on the
origin, is assumed); capsule_y(rad, rad), ball(rad),
round_cylinder(rad, rad, rad / 10), cone(rad, rad), capsule_y(rad, rad)
by j % 5."""

from port_bench.reference.masses import BALL, CONE, CUBOID, ROUND_CYLINDER, capsule_y, with_masses


def layout(num_layers: int, grid: int, rad: float):
    shift = 3.0 * rad
    center = shift * (grid // 2)
    kinds = [capsule_y(rad, rad), (BALL, (rad,)), (ROUND_CYLINDER, (rad, rad, rad / 10.0)),
             (CONE, (rad, rad)), capsule_y(rad, rad)]
    out = [dict(pos=(0.0, -2.1, 0.0), shape=CUBOID, params=(100.1, 2.1, 100.1), dynamic=False)]
    offset = 0.0
    for j in range(num_layers):
        y = j * shift + shift / 2.0 + 3.0
        for i in range(grid):
            for k in range(grid):
                shape, prm = kinds[j % 5]
                out.append(dict(pos=(i * shift - center + offset, y, k * shift - center + offset),
                                shape=shape, params=prm, dynamic=True))
        offset -= 0.05 * rad * (grid - 1)
    return with_masses(out)

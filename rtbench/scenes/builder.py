"""A scene described instance by instance, built by the port's
``models/builder.SceneBuilder`` from the configuration's description; the
meshes' vertices come from ``rtbench/reference/scene.mesh_data``, so the
port and the reference start from the same data."""

from __future__ import annotations

from rtbench.reference.scene import mesh_data


def _material(builder, m: dict):
    return builder.Material(tuple(m["albedo"]), float(m["reflectance"]), float(m["diffuse"]),
                            float(m["specular"]), float(m["specular_power"]),
                            float(m["step_scale"]))


def build(cfg: dict, device):
    from gpuraytracer_tpu_torch.core.camera import Camera
    from gpuraytracer_tpu_torch.models import builder

    desc = cfg["scene"]
    b = builder.SceneBuilder()
    cam = desc["camera"]
    b.camera = Camera(eye=tuple(cam["eye"]), at=tuple(cam["at"]),
                      initial_y_rotation_deg=float(cam["initial_y_rotation_deg"]))
    light = desc["light"]
    b.light_position = tuple(light["position"])
    b.light_ambient = tuple(light["ambient"])
    b.light_diffuse = tuple(light["diffuse"])
    b.blas_offset = tuple(desc["blas_offset"])
    if desc.get("plane") is None:
        b.without_plane()
    else:
        b.plane_material = _material(builder, desc["plane"]["material"])
        b.plane_origin = tuple(desc["plane"]["origin"])
        b.plane_size = tuple(desc["plane"]["size"])
    for inst in desc["instances"]:
        common = dict(aabb_min=tuple(inst["aabb_min"]), aabb_max=tuple(inst["aabb_max"]),
                      scale=tuple(inst["scale"]), rotates=bool(inst["rotates"]),
                      rotation_rate=float(inst["rotation_rate"]))
        if inst["kind"] == "TRIANGLE":
            positions, indices = mesh_data(inst["mesh"])
            b.add_mesh_instance(positions, indices, _material(builder, inst["material"]),
                                **common)
        else:
            b.add_instance(builder.InstanceSpec(
                kind=builder.IntersectorKind[inst["kind"]], prim_type=int(inst["prim_type"]),
                material=_material(builder, inst["material"]), **common))
    return b.build(cfg["width"] / cfg["height"], 0.0, device=device), b.animator()

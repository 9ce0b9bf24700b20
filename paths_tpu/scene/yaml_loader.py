"""YAML scene loader.

Parses the reference's scene schema (src/serde.rs) into SceneDescription.
Deliberately *lenient* where the reference's serde is strict, because two of
the bundled scenes predate schema changes and no longer parse upstream:

  - ``albedo: {r,g,b}`` without a ``type: Rgb`` tag (spheres_on_plane.yml,
    bokeh_demo.yml) is accepted as Rgb;
  - missing ``lights:`` / ``models:`` / gloss ``metalness`` default to
    [] / {} / 0.0.

The YAML itself is read by ``parse_yaml``, a parser for the subset the scene
schema uses (block maps and lists, flow maps and lists on one line, plain
and quoted scalars, comments), so loading a scene needs no third-party
package.
"""

from __future__ import annotations

import os
import re

from paths_tpu.scene import desc as D

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")
_SPECIAL = {"true": True, "True": True, "false": False, "False": False,
            "null": None, "Null": None, "~": None, "": None,
            ".inf": float("inf"), "-.inf": float("-inf"), ".nan": float("nan")}


def _scalar(text: str):
    text = text.strip()
    if text[:1] in "\"'":
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"unterminated quoted scalar: {text}")
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else \
            body.encode().decode("unicode_escape")
    if text in _SPECIAL:
        return _SPECIAL[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """'key: rest' -> (key, rest); None when the text is not a map entry."""
    quote = None
    depth = 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] == " "):
            return _scalar(text[:i]), text[i + 1:].strip()
    return None


def _flow(text: str, pos: int = 0):
    """Parse one flow value starting at text[pos]; returns (value, end)."""
    while text[pos] == " ":
        pos += 1
    if text[pos] in "[{":
        close = "]" if text[pos] == "[" else "}"
        out = [] if close == "]" else {}
        pos += 1
        while True:
            while text[pos] == " ":
                pos += 1
            if text[pos] == close:
                return out, pos + 1
            if close == "}":
                colon = text.index(":", pos)
                key = _scalar(text[pos:colon])
                val, pos = _flow(text, colon + 1)
                out[key] = val
            else:
                val, pos = _flow(text, pos)
                out.append(val)
            while text[pos] == " ":
                pos += 1
            if text[pos] == ",":
                pos += 1
            elif text[pos] != close:
                raise ValueError(f"expected ',' or '{close}' at {text[pos:]!r}")
    end = pos
    if text[pos] in "\"'":
        end = text.index(text[pos], pos + 1) + 1
    else:
        while end < len(text) and text[end] not in ",]}":
            end += 1
    return _scalar(text[pos:end]), end


def _value(text: str):
    if text[:1] in "[{":
        try:
            val, end = _flow(text)
        except IndexError:
            raise ValueError(f"unterminated flow value: {text!r}") from None
        if text[end:].strip():
            raise ValueError(f"trailing text after flow value: {text!r}")
        return val
    return _scalar(text)


def parse_yaml(text: str):
    """Parse the YAML subset used by scene files into dicts, lists and
    scalars (int, float, bool, None, str)."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"tab in indentation: {raw!r}")
        line = _strip_comment(raw)
        if line.strip() and line.strip() not in ("---", "..."):
            lines.append((len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[end][1]!r}")
    return value


def _block(lines, i, indent):
    """Parse the block starting at lines[i], whose entries sit at `indent`."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].strip()
            if not rest:
                item, i = _nested(lines, i + 1, indent)
            elif _split_key(rest) is not None and rest[:1] not in "[{":
                # "- key: v" opens a map whose further keys align with key.
                sub = [(indent + 2, rest)]
                j = i + 1
                while j < len(lines) and lines[j][0] > indent:
                    sub.append(lines[j])
                    j += 1
                item, end = _block(sub, 0, indent + 2)
                if end != len(sub):
                    raise ValueError(f"bad list item near: {rest!r}")
                i = j
            else:
                item, i = _value(rest), i + 1
            out.append(item)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        if rest:
            out[key], i = _value(rest), i + 1
        else:
            out[key], i = _nested(lines, i + 1, indent, allow_list_at=indent)
    return out, i


def _nested(lines, i, indent, allow_list_at=None):
    """Value of an empty 'key:' or '-': a deeper block, a list at the key's
    own indent, or null."""
    if i < len(lines):
        ind, text = lines[i]
        if ind > indent:
            return _block(lines, i, ind)
        if ind == allow_list_at and (text == "-" or text.startswith("- ")):
            return _block(lines, i, ind)
    return None, i


def _vec(d, default=(0.0, 0.0, 0.0)) -> D.Vec3D:
    if d is None:
        return D.Vec3D(*default)
    return D.Vec3D(float(d.get("x", 0.0)), float(d.get("y", 0.0)), float(d.get("z", 0.0)))


def _rot(d) -> D.RotationD:
    if d is None:
        return D.RotationD()
    return D.RotationD(
        float(d.get("pitch", 0.0)), float(d.get("yaw", 0.0)), float(d.get("roll", 0.0))
    )


def _colour(d, default=(0.0, 0.0, 0.0)) -> D.ColourD:
    if d is None:
        return D.ColourD(*default)
    return D.ColourD(float(d.get("r", 0.0)), float(d.get("g", 0.0)), float(d.get("b", 0.0)))


def _material_colour(d) -> D.MaterialColourD:
    if d is None:
        return D.MaterialColourD(colour=D.ColourD(1.0, 1.0, 1.0))
    tag = str(d.get("type", "Rgb")).lower()
    if tag == "vertex":
        return D.MaterialColourD(is_vertex=True)
    return D.MaterialColourD(colour=_colour(d))


def _material(d) -> D.MaterialD:
    if d is None:
        return D.MaterialD(kind="auto")
    kind = str(d.get("type", "Lambertian")).lower()
    if kind in ("cooktorrance", "cook_torrance"):
        kind = "cook_torrance"
    m = D.MaterialD(kind=kind)
    if kind == "lambertian":
        m.albedo = _material_colour(d.get("albedo"))
    elif kind == "gloss":
        m.albedo = _material_colour(d.get("albedo"))
        m.reflectance = float(d.get("reflectance", 0.0))
        m.metalness = float(d.get("metalness", 0.0))
    elif kind == "mirror":
        pass
    elif kind == "cook_torrance":
        m.albedo = _material_colour(d.get("albedo"))
        m.roughness = float(d.get("roughness", 0.5))
    elif kind == "fresnel":
        m.refractive_index = float(d.get("refractive_index", 1.5))
        m.diffuse = _material(d.get("diffuse"))
        m.specular = _material(d.get("specular"))
    elif kind == "auto":
        pass
    else:
        raise ValueError(f"Unknown material type: {d.get('type')}")
    return m


def _object(d) -> D.ObjectD:
    shape = d.get("shape", {})
    kind = str(shape.get("type", "Sphere")).lower()
    obj = D.ObjectD(material=_material(d.get("material")))
    if kind == "sphere":
        obj.shape_kind = "sphere"
        obj.sphere = D.SphereD(_vec(shape.get("center")), float(shape.get("radius", 1.0)))
    elif kind == "mesh":
        obj.shape_kind = "mesh"
        obj.mesh = D.MeshD(
            model=str(shape.get("model", "")),
            smooth_normals=bool(shape.get("smooth_normals", True)),
            translation=_vec(shape.get("translation")),
            rotation=_rot(shape.get("rotation")),
            scale=float(shape.get("scale", 1.0)),
        )
    else:
        raise ValueError(f"Unknown shape type: {shape.get('type')}")
    return obj


def _light(d) -> D.LightD:
    geom = d.get("geometry")
    if geom is None:
        # serde.rs:202-224: lights are a tagged `geometry` block.  A missing
        # block previously fell through to a Point light at the origin --
        # silently wrecking the scene (found authoring ct_demo.yml).
        raise ValueError(
            "light is missing its 'geometry:' block (expected e.g. "
            "geometry: {type: Sphere, center: {...}, radius: r})"
        )
    kind = str(geom.get("type", "Point")).lower()
    light = D.LightD(
        kind=kind,
        colour=_colour(d.get("colour"), (1.0, 1.0, 1.0)),
        intensity=float(d.get("intensity", 1.0)),
    )
    if kind == "point":
        # serde.rs:211: Point(VectorDescription) -- position inline.
        light.position = _vec(geom if "x" in geom else geom.get("position"))
    elif kind == "sphere":
        light.position = _vec(geom.get("center"))
        light.radius = float(geom.get("radius", 1.0))
    else:
        raise ValueError(f"Unknown light geometry: {geom.get('type')}")
    return light


def _skybox(d) -> D.SkyboxD:
    if d is None:
        return D.SkyboxD(kind="flat")
    kind = str(d.get("type", "Flat")).lower()
    sky = D.SkyboxD(kind=kind)
    if kind == "flat":
        sky.colour = _colour(d.get("colour"))
    elif kind == "gradient":
        sky.overhead_colour = _colour(d.get("overhead_colour"))
        sky.horizon_colour = _colour(d.get("horizon_colour"))
    elif kind == "hdri":
        sky.filename = str(d.get("filename", ""))
    else:
        raise ValueError(f"Unknown skybox type: {d.get('type')}")
    return sky


def _camera(d) -> D.CameraD:
    return D.CameraD(
        image_width=int(d.get("image_width", 720)),
        image_height=int(d.get("image_height", 480)),
        location=_vec(d.get("location")),
        orientation=_rot(d.get("orientation")),
        sensor_width=float(d.get("sensor_width", 0.036)),
        sensor_height=float(d.get("sensor_height", 0.024)),
        focal_length=float(d.get("focal_length", 0.05)),
        focus_distance=float(d.get("focus_distance", 10.0)),
        aperture=float(d.get("aperture", 8.0)),
    )


def parse_scene_dict(data: dict, base_dir: str = ".") -> D.SceneDescription:
    models = {
        str(name): str(m.get("file", "")) for name, m in (data.get("models") or {}).items()
    }
    return D.SceneDescription(
        camera=_camera(data.get("camera", {})),
        objects=[_object(o) for o in (data.get("objects") or [])],
        lights=[_light(l) for l in (data.get("lights") or [])],
        skybox=_skybox(data.get("skybox")),
        models=models,
        base_dir=base_dir,
    )


def load_scene_description(path: str) -> D.SceneDescription:
    """Load a scene YAML file.  Relative asset paths in the file are resolved
    the way the reference does: relative to the process CWD in the YAMLs
    (`./scenes/objects/...`), so we try both CWD-relative and
    scene-file-relative locations at model load time."""
    with open(path) as f:
        data = parse_yaml(f.read())
    return parse_scene_dict(data, base_dir=os.path.dirname(os.path.abspath(path)))

"""YAML scene loader (port of ``paths_tpu/scene/yaml_loader.py``).

Parses the reference's scene schema (src/serde.rs) into SceneDescription,
leniently where upstream's serde is strict: ``albedo: {r,g,b}`` without a
``type: Rgb`` tag is Rgb, and missing ``lights:`` / ``models:`` / gloss
``metalness`` default to [] / {} / 0.0.

The port needs no YAML package: ``parse_yaml`` reads the subset of YAML
that scene files use -- block mappings and ``- `` lists, flow mappings and
lists on one line (``{ x: 0.0, y: 1 }``, ``[]``), comments, and quoted or
plain scalars (numbers, booleans, null and strings, resolved as YAML 1.1's
core schema does) -- and raises on anything else, naming the line.
"""

from __future__ import annotations

import os
import re

from paths_tpu_torch.scene import desc as D


class YamlSubsetError(ValueError):
    """Syntax outside the subset of YAML that scene files use."""


# YAML 1.1 plain-scalar resolution (PyYAML's safe_load), decimal forms.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\", '"': '"',
            "/": "/", " ": " "}


def _plain(text: str):
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


class _Line:
    """One scene-file line: its number, indentation and content with the
    comment removed."""

    def __init__(self, no: int, text: str):
        self.no = no
        body = text.rstrip()
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise YamlSubsetError(f"line {no}: tab in indentation")
        self.indent = len(body) - len(stripped)
        self.text = _strip_comment(stripped)


def _strip_comment(text: str) -> str:
    """text without a '#' comment outside quotes."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                i += 1  # the escaped character
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    return text


class _Scanner:
    """Reads one scalar or flow collection from a string, from pos."""

    def __init__(self, text: str, no: int):
        self.text, self.pos, self.no = text, 0, no

    def error(self, what: str):
        return YamlSubsetError(f"line {self.no}: {what}: {self.text!r}")

    def skip_space(self):
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def value(self, flow: bool):
        """A node at pos: a flow collection, a quoted scalar or a plain
        scalar (in flow context, ended by ',', ']', '}' or ': ')."""
        self.skip_space()
        ch = self.peek()
        if ch == "{":
            return self.flow_mapping()
        if ch == "[":
            return self.flow_sequence()
        if ch in ("'", '"'):
            return self.quoted()
        if ch in ("&", "*", "!", "|", ">", "%", "@", "`") or (
                ch in ("-", "?") and self.text[self.pos + 1: self.pos + 2] in ("", " ")):
            raise self.error("unsupported YAML syntax")
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if flow and c in ",]}":
                break
            if c == ":" and self.text[self.pos + 1: self.pos + 2] in ("", " "):
                if flow:
                    break
                raise self.error("a mapping entry is not allowed here")
            self.pos += 1
        return _plain(self.text[start: self.pos].strip())

    def quoted(self) -> str:
        q = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise self.error("unterminated quoted string")
            c = self.text[self.pos]
            self.pos += 1
            if c == q:
                if q == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if c == "\\" and q == '"':
                esc = self.peek()
                if esc not in _ESCAPES:
                    raise self.error(f"unsupported escape \\{esc}")
                out.append(_ESCAPES[esc])
                self.pos += 1
                continue
            out.append(c)

    def expect(self, ch: str):
        self.skip_space()
        if self.peek() != ch:
            raise self.error(f"expected {ch!r}")
        self.pos += 1

    def flow_sequence(self) -> list:
        self.expect("[")
        out = []
        self.skip_space()
        if self.peek() == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.value(flow=True))
            self.skip_space()
            if self.peek() == "]":
                self.pos += 1
                return out
            self.expect(",")

    def flow_mapping(self) -> dict:
        self.expect("{")
        out = {}
        self.skip_space()
        if self.peek() == "}":
            self.pos += 1
            return out
        while True:
            key = self.value(flow=True)
            self.expect(":")
            out[key] = self.value(flow=True)
            self.skip_space()
            if self.peek() == "}":
                self.pos += 1
                return out
            self.expect(",")

    def rest(self):
        """The whole remainder as one node; nothing may follow it."""
        node = self.value(flow=False)
        self.skip_space()
        if self.pos != len(self.text):
            raise self.error("unexpected text after a value")
        return node


def _split_key(line: _Line):
    """'key: value' / 'key:' -> (key, value text), or None when the line is
    not a mapping entry."""
    sc = _Scanner(line.text, line.no)
    if sc.peek() in ("'", '"'):
        key = sc.quoted()
        m = re.match(r" *:(?: |$)", sc.text[sc.pos:])
        return None if m is None else (key, sc.text[sc.pos + m.end():].strip())
    m = re.search(r":(?: |$)", line.text)
    if m is None or line.text[:1] in "{[":
        return None
    return _plain(line.text[: m.start()].strip()), line.text[m.end():].strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: list, i: int, indent: int):
    """The block node whose first line is lines[i] at this indentation.
    Returns (node, next line index)."""
    node, i = (_sequence if _is_item(lines[i].text) else _mapping)(lines, i, indent)
    if i < len(lines) and lines[i].indent > indent:
        raise YamlSubsetError(f"line {lines[i].no}: unexpected indentation")
    return node, i


def _nested(lines: list, i: int, indent: int, seq_ok: bool):
    """The value of an entry whose text ended at lines[i-1]: a block on the
    following deeper lines (or a '- ' list at the same indentation after a
    mapping key), else null."""
    if i < len(lines) and lines[i].indent > indent:
        return _block(lines, i, lines[i].indent)
    if seq_ok and i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        return _block(lines, i, indent)
    return None, i


def _sequence(lines: list, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        line = lines[i]
        body = line.text[1:].lstrip(" ")
        if not body:
            node, i = _nested(lines, i + 1, indent, seq_ok=False)
        else:
            # The item's content starts a block at its own column: re-read
            # the line from there.
            lines[i] = _Line(line.no, " " * (indent + len(line.text) - len(body)) + body)
            if _is_item(body) or _split_key(lines[i]) is not None:
                node, i = _block(lines, i, lines[i].indent)
            else:
                node, i = _Scanner(body, line.no).rest(), i + 1
        out.append(node)
    return out, i


def _mapping(lines: list, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i].indent == indent and not _is_item(lines[i].text):
        line = lines[i]
        entry = _split_key(line)
        if entry is None:
            raise YamlSubsetError(f"line {line.no}: expected 'key: value': "
                                  f"{line.text!r}")
        key, rest = entry
        if rest:
            out[key], i = _Scanner(rest, line.no).rest(), i + 1
        else:
            out[key], i = _nested(lines, i + 1, indent, seq_ok=True)
    return out, i


def parse_yaml(text: str):
    """The document in ``text`` (a block mapping or list) as dicts, lists and
    scalars: what ``yaml.safe_load`` gives for the subset that scene files
    use."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = _Line(no, raw)
        if not line.text:
            continue
        if line.indent == 0 and line.text in ("---", "...") or line.text.startswith("%"):
            raise YamlSubsetError(f"line {no}: document markers and directives "
                                  "are not supported")
        lines.append(line)
    if not lines:
        return None
    if lines[0].indent != 0:
        raise YamlSubsetError(f"line {lines[0].no}: unexpected indentation")
    node, i = _block(lines, 0, 0)
    if i < len(lines):
        raise YamlSubsetError(f"line {lines[i].no}: unexpected text")
    return node


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
    """Load a scene YAML file; asset paths resolve relative to the scene
    file's directory."""
    with open(path) as f:
        data = parse_yaml(f.read())
    return parse_scene_dict(data, base_dir=os.path.dirname(os.path.abspath(path)))

"""The in-repo YAML subset parser (scene/yaml_loader.parse_yaml)."""

import glob
import os

import pytest

from paths_tpu.scene.yaml_loader import load_scene_description, parse_yaml

SCENES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "*.yml")))


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_bundled_scene_parses(path):
    with open(path) as f:
        data = parse_yaml(f.read())
    assert set(data) >= {"camera", "objects", "skybox"}
    assert data["camera"]["image_width"] == 720
    assert all(isinstance(o["shape"], dict) for o in data["objects"])
    sd = load_scene_description(path)
    assert sd.camera.image_height == 480
    assert len(sd.objects) == len(data["objects"])
    assert len(sd.lights) == len(data.get("lights") or [])


def test_subset_constructs():
    text = """
# full-line comment
a: 1   # trailing comment
b: "x # not a comment"
c: 'it''s'
d: { x: 1.5, y: -2e3, z: [1, 2, {q: 3}] }
e: []
f:
- k: 1
  m: 2
- plain
-
  n: 3
g:
  - [1, 2]
  - true
h: ~
i: 1e6
j: { type: Rgb, r: 0.5 }
"""
    assert parse_yaml(text) == {
        "a": 1, "b": "x # not a comment", "c": "it's",
        "d": {"x": 1.5, "y": -2000.0, "z": [1, 2, {"q": 3}]},
        "e": [], "f": [{"k": 1, "m": 2}, "plain", {"n": 3}],
        "g": [[1, 2], True], "h": None, "i": 1e6,
        "j": {"type": "Rgb", "r": 0.5},
    }


@pytest.mark.parametrize("bad", ["a: {x: 1", "a:\n\tb: 1", "- 1\nb: 2", "a: 'open"])
def test_malformed_input_raises(bad):
    with pytest.raises(ValueError):
        parse_yaml(bad)

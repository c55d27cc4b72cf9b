"""scene_build_s: seconds of the program's scene build in set-up, on the
host clock around parsing the configuration's scene and ``build_scene``
(the mesh parser, the BVH builder, the packers, the upload)."""


def read(obs):
    return obs.values.get("scene_build_s")

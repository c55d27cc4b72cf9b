"""native_load_s: seconds the program spent loading its native libraries
before the traced window (``native.load_library``: hashing the sources, a
compile where the library is not built, dlopen), its always-on total
``profiling.NATIVE_LOAD_S`` summed over the libraries; the compiles,
``NATIVE_BUILDS``, are printed beside it (``spans.py``)."""

from portbench import spans as S


def install(ctx):
    got = S.native_totals()
    if got is not None:
        ctx.obs.values["native_load_s"], ctx.obs.values["native_builds"] = got
    return []


def read(obs):
    return obs.values.get("native_load_s")

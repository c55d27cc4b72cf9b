"""env_device_pct.render: the environment light's share in % of the card's
profiled device time: the device time of the kernels launched while a
``paths_tpu_torch.env_nee`` span is open on the launching thread (matched
to their launch by correlation id alone), over the summed time of every
device event in the profiled span (``env_light.py``)."""

from portbench import env_light as EL
from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    got = EL.profiled_device(obs)
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]

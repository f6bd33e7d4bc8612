"""The port's frontend and config copies agree with the JAX package's."""

import pytest

from tacotronv2_wavernn_chinese_tpu import config as jcfg
from tacotronv2_wavernn_chinese_tpu import frontend as jfe
from tacotronv2_wavernn_chinese_tpu_torch import config as tcfg
from tacotronv2_wavernn_chinese_tpu_torch import frontend as tfe

SENTENCES = [
    "你好。",
    "今天天气很好，我们去公园散步吧！",
    "这是第3个测试句子。",
    "他在2023年花了12345元买了一台电脑。",
    "圆周率约等于3.14159。",
    "银行的行长走在行人道上，长长的队伍。",
    "我们重新开始，重要的事情说三遍。",
    "还是还钱吧，这个乐队的音乐很快乐。",
    "ni3 hao3，世界！",
    "中文和English混合的句子。",
    "“你好！”他说：“欢迎。”",
    "数量：100,000个；时间——下午三点……",
    "为什么？因为他为人民服务。",
    "小明的电话号码是110。",
    "长城很长，长江也很长。",
    "他着急地睡着了。",
    "这件衣服很便宜，但是不太方便。",
    "阿姨给了我一把钥匙。",
    "0.5加上0.25等于0.75。",
    "好好学习，天天向上！",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_g2p_and_symbols_match(text):
    jp, jn = jfe.get_pyin(text)
    tp, tn = tfe.get_pyin(text)
    assert (tp, tn) == (jp, jn)
    assert tfe.default_symbols().encode(tp) == jfe.default_symbols().encode(jp)


# JAX config fields the port does not have: the JAX trainers' K steps in
# one ``lax.scan`` dispatch (the port's loops run one step per batch)
JAX_ONLY = {"tacotron_train": ("steps_per_dispatch",), "wavernn_train": ("steps_per_dispatch",)}
# the port's sections the JAX package does not have: HiFi-GAN, a model only the port runs
PORT_ONLY = ("hifigan", "hifigan_train")


def _port_fields(jax_dict: dict) -> dict:
    return {sec: {k: v for k, v in val.items() if k not in JAX_ONLY[sec]} if sec in JAX_ONLY else val
            for sec, val in jax_dict.items()}


def _shared(port_dict: dict) -> dict:
    return {sec: val for sec, val in port_dict.items() if sec not in PORT_ONLY}


def test_default_config_matches():
    assert _shared(tcfg.default_config().to_dict()) == _port_fields(jcfg.default_config().to_dict())


def test_config_from_dict_round_trip():
    from tacotronv2_wavernn_chinese_tpu.serving.export import _config_from_dict as j_from

    cfg = tcfg.default_config().override("tacotron.max_iters=77,wavernn.upsample_factors=(2,2,5)")
    d = cfg.to_dict()
    assert tcfg._config_from_dict(d) == cfg
    assert _shared(tcfg._config_from_dict(d).to_dict()) == _port_fields(j_from(d).to_dict())


def test_jax_artifact_config_loads():
    """A JAX artifact's config.json, JAX-only fields set, loads into the
    port with every shared field kept."""
    d = jcfg.default_config().override(
        "tacotron_train.steps_per_dispatch=4,wavernn_train.steps_per_dispatch=2,tacotron.max_iters=77").to_dict()
    assert tcfg._config_from_dict(d) == tcfg.default_config().override("tacotron.max_iters=77")

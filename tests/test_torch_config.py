"""The port's config reader, NetConfig and LayerParam against the JAX
package's: the same config gives the same (name, value) pairs and the same
SaveNet bytes, and LayerParam's 328-byte record is the same both ways."""

import glob
import os
import struct

import numpy as np
import pytest

from cxxnet_tpu.layer import base as jbase
from cxxnet_tpu.layer import factory as jfactory
from cxxnet_tpu.nnet.config import NetConfig as JNetConfig
from cxxnet_tpu.utils import config as jconfig
from cxxnet_tpu.utils import serializer as jser
from cxxnet_tpu_torch.layer import base as tbase
from cxxnet_tpu_torch.layer import factory as tfactory
from cxxnet_tpu_torch.nnet.config import NetConfig as TNetConfig
from cxxnet_tpu_torch.utils import config as tconfig
from cxxnet_tpu_torch.utils import serializer as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = (["example/ImageNet/ImageNet.conf", "example/ImageNet/GoogLeNet.conf"]
         + sorted(os.path.relpath(p, REPO) for p in
                  glob.glob(os.path.join(REPO, "example/MNIST/*.conf"))))
ALL_CONFS = sorted(os.path.relpath(p, REPO) for p in
                   glob.glob(os.path.join(REPO, "example/*/*.conf")))


def _save_net(cls, ser, pairs):
    cfg = cls()
    cfg.configure(pairs)
    w = ser.Writer()
    cfg.save_net(w)
    return cfg, w.getvalue()


@pytest.mark.parametrize("conf", CONFS)
def test_save_net_bytes_match_jax(conf):
    text = open(os.path.join(REPO, conf)).read()
    jcfg, want = _save_net(JNetConfig, jser, jconfig.parse_config_string(text))
    tcfg, got = _save_net(TNetConfig, tser, tconfig.parse_config_string(text))
    assert got == want
    assert tcfg.node_names == jcfg.node_names
    assert tcfg.layercfg == jcfg.layercfg and tcfg.defcfg == jcfg.defcfg


@pytest.mark.parametrize("conf", CONFS)
def test_load_net_round_trip(conf):
    text = open(os.path.join(REPO, conf)).read()
    _, want = _save_net(JNetConfig, jser, jconfig.parse_config_string(text))
    cfg = TNetConfig()
    cfg.load_net(tser.Reader(want))
    w = tser.Writer()
    cfg.save_net(w)
    assert w.getvalue() == want


@pytest.mark.parametrize("conf", ALL_CONFS)
def test_config_reader_matches_jax(conf):
    text = open(os.path.join(REPO, conf)).read()
    assert tconfig.parse_config_string(text) == \
        jconfig.parse_config_string_py(text)


@pytest.mark.parametrize("text", ['a = "x y" b=c', "a='multi\nline'",
                                  'k = v # comment\nq = "esc\\"aped"'])
def test_config_reader_quoting_matches_jax(text):
    assert tconfig.parse_config_string(text) == \
        jconfig.parse_config_string_py(text)


@pytest.mark.parametrize("text", ['a = "open', "= b", "a b", 'a"x" = 1'])
def test_config_reader_errors_match_jax(text):
    with pytest.raises(jconfig.ConfigError):
        jconfig.parse_config_string_py(text)
    with pytest.raises(tconfig.ConfigError):
        tconfig.parse_config_string(text)


def test_unported_layer_types_parse_but_do_not_build():
    # every name of the JAX factory's table builds its layer in the port;
    # only the pairtest layers (not ported) and the shared layer (the
    # net's) are refused, each by name
    for name in ("pairtest-conv-conv", "share"):
        tid = tfactory.get_layer_type(name)
        assert tid == jfactory.get_layer_type(name)
        with pytest.raises(ValueError, match=name[:5]):
            tfactory.create_layer(tid)
    assert set(tfactory._NAME2TYPE) == set(jfactory._NAME2TYPE)
    for name in sorted(jfactory._NAME2TYPE):
        tid = tfactory.get_layer_type(name)
        assert tid == jfactory.get_layer_type(name)
        want = "extern" if name == "caffe" else name
        assert tfactory.create_layer(tid).type_name == want


def test_type_ids_match_jax():
    assert tfactory._NAME2TYPE == jfactory._NAME2TYPE
    assert tfactory.get_layer_type("pairtest-conv-fullc") == \
        jfactory.get_layer_type("pairtest-conv-fullc")
    with pytest.raises(ValueError, match="unknown layer type"):
        tfactory.get_layer_type("nosuch")


def _filled_param(mod):
    p = mod.LayerParam()
    for k, v in [("nhidden", "17"), ("init_sigma", "0.25"),
                 ("init_uniform", "0.5"), ("init_bias", "-1.5"),
                 ("nchannel", "64"), ("random_type", "kaiming"),
                 ("ngroup", "2"), ("kernel_height", "3"),
                 ("kernel_width", "5"), ("stride", "2"), ("pad_y", "1"),
                 ("pad_x", "2"), ("no_bias", "1"), ("temp_col_max", "3"),
                 ("silent", "1"), ("init_sparse", "7")]:
        p.set_param(k, v)
    p.num_input_channel, p.num_input_node = 12, 34
    return p


def test_layer_param_bytes_match_jax_both_ways():
    jw, tw = jser.Writer(), tser.Writer()
    _filled_param(jbase).save(jw)
    _filled_param(tbase).save(tw)
    assert tw.getvalue() == jw.getvalue()
    assert len(tw.getvalue()) == tbase.PARAM_BYTES == 328
    back = tbase.LayerParam()
    back.load(tser.Reader(jw.getvalue()))
    assert vars(back) == vars(_filled_param(jbase))
    fwd = jbase.LayerParam()
    fwd.load(jser.Reader(tw.getvalue()))
    assert vars(fwd) == vars(back)
    # the record is 18 packed fields then 64 zero ints
    assert tw.getvalue()[72:] == b"\x00" * 256
    assert struct.unpack("<i", tw.getvalue()[:4]) == (17,)


@pytest.mark.parametrize("random_type, key", [("gaussian", "init_sigma"),
                                              ("xavier", "init_uniform"),
                                              ("kaiming", "nhidden")])
def test_rand_init_weight_moments(random_type, key):
    import math
    import torch
    p = tbase.LayerParam()
    p.set_param("random_type", random_type)
    p.set_param(key, {"init_sigma": "0.05", "init_uniform": "0.2",
                      "nhidden": "50"}[key])
    w = p.rand_init_weight(torch.Generator().manual_seed(0), (200, 300),
                           300, 200).numpy()
    want_std = {"gaussian": 0.05, "xavier": 0.2 / math.sqrt(3.0),
                "kaiming": math.sqrt(2.0 / 50)}[random_type]
    assert w.dtype == np.float32 and w.shape == (200, 300)
    # 60k samples: the std estimate is within ~1% of its value
    assert abs(w.std() / want_std - 1.0) < 0.03
    assert abs(w.mean()) < 0.05 * want_std + 1e-3
    if random_type == "xavier":
        assert np.abs(w).max() <= 0.2

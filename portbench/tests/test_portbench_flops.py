"""The yardstick's flop and byte counts against numbers worked by hand."""
import importlib.util
from pathlib import Path

from portbench import flops
from portbench.cell import architecture, manifest, resolve
from portbench.readers import admitted, decode_rows
from portbench.serve import Step

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _arch(cell):
    return architecture(resolve(cell, manifest())["config"])


def _reader_module(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_qwen2_parameters():
    A = _arch("qwen2-7b.serve.conversation")
    per_layer = 3584 * (28 + 8) * 128 + 28 * 128 * 3584 + 3 * 3584 * 18944
    assert flops.layer_params(A) == per_layer == 233_046_016
    assert flops.active_params(A) == 28 * per_layer + 3584 * 152064
    A4 = _arch("qwen2-7b.train.s2048")
    assert A4["L"] == 4 and flops.active_params(A4) == 4 * per_layer + \
        3584 * 152064


def test_attention_and_train_flops():
    A = _arch("qwen2-7b.train.s2048")
    # 3 tokens: pairs 1 + 2 + 3 = 6; 4 flops x H x hd a pair; 4 layers
    assert flops.causal_attention_flops(A, 3) == 6 * 4 * 28 * 128 * 4
    assert flops.attention_flops_at(A, 2) == 3 * 4 * 28 * 128 * 4
    S = 2048
    want = 3 * (2 * flops.active_params(A) * S
                + 4 * 28 * 128 * S * (S + 1) / 2 * 4)
    assert flops.train_flops_per_sequence(A, S) == want


def test_serve_flops_adds_up_token_by_token():
    A = _arch("qwen2-7b.serve.conversation")
    P = 5
    per_tok = 2 * 28 * flops.layer_params(A)
    head = 2 * flops.head_params(A)
    brute = (P * per_tok + flops.causal_attention_flops(A, P) + head
             + sum(per_tok + flops.attention_flops_at(A, P + i - 1) + head
                   for i in range(1, 4)))
    assert flops.serve_flops(A, P, 0, 4) == brute
    # split across two steps, the parts add up to the whole
    assert flops.serve_flops(A, P, 0, 2) + flops.serve_flops(A, P, 2, 4) \
        == brute


def test_decode_attention_bytes():
    A = _arch("qwen2-7b.serve.conversation")
    mod = _reader_module("decode_attn_roofline.serve")
    # one request at 10 live rows: 11 K/V rows of 4 heads x 128 x bf16 x 2
    # (k and v), q read and o written (28 x 128 x bf16 each)
    assert mod.call_bytes(A, [10]) == 11 * 2 * 4 * 128 * 2 + 2 * 28 * 128 * 2
    # a request with a 7-token prompt admitted in a step of 8 ticks that
    # saw 5 tokens: 4 ticks at 8, 9, 10, 11 live rows
    st = Step(0.0, 0.0, 1.0, [(7, 0, 5), (3, 2, 4)])
    rows = list(decode_rows([st]))
    assert rows == [[8, 5], [9, 6], [10], [11]]
    assert list(admitted([st])) == [7]


def test_flash_roofline_per_launch():
    A = _arch("qwen2-7b.train.s2048")
    mod = _reader_module("flash_fwd_roofline.train")

    class T:
        def ops(self, contains):
            # 16 launches of 1 ms
            return [("flash_bf16_kernel", i * 10 ** 6, i * 10 ** 6 + 10 ** 6,
                     i) for i in range(16)]

    pl = {"trace": T(), "arch": A, "traffic": {"batch": 4, "seq": 2048},
          "workload": {"microbatches": 2}}
    per = 2 * 4 * 28 * 128 * 2048 * 2049 / 2
    want = 100 * 16 * per / 989e12 / 0.016
    assert abs(mod.read(pl) - want) < 1e-9 * want

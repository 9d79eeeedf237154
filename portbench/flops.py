"""Model flops from a configuration's shapes: the work the algorithm
needs, whatever implements it, so that a later kernel swap cannot move the
yardstick.  A multiply-add is 2 flops.  Only matrix products count: the
embedding lookup, norms, activations and bias adds are not counted.

``arch`` is the dict of ``portbench.cell.architecture``: ``L`` layers,
``D`` width, ``H`` / ``K`` query / key-value heads of ``hd``, ``F`` the
MLP width, ``V`` vocabulary, ``tied`` embeddings."""
from __future__ import annotations


def layer_params(arch: dict) -> int:
    """Matrix parameters one token multiplies through in one layer: the
    q, k, v and output projections and the gated MLP."""
    D, H, K, hd, F = (arch[k] for k in ("D", "H", "K", "hd", "F"))
    return D * (H + 2 * K) * hd + H * hd * D + 3 * D * F


def head_params(arch: dict) -> int:
    """The output projection (D x V), counted whether or not it is tied to
    the embedding: the lookup is no product, the head is."""
    return arch["D"] * arch["V"]


def active_params(arch: dict) -> int:
    """Parameters a token multiplies through: every layer and the head."""
    return arch["L"] * layer_params(arch) + head_params(arch)


def causal_attention_flops(arch: dict, length: int, layers: int = 0) -> float:
    """Forward flops of causal attention over one sequence of ``length``
    tokens: the Q.K^T and P.V products over the length x (length + 1) / 2
    (query, key) pairs of each of the H heads, in ``layers`` layers (0: all
    of the model's)."""
    n = layers or arch["L"]
    pairs = length * (length + 1) / 2
    return 4.0 * arch["H"] * arch["hd"] * pairs * n


def attention_flops_at(arch: dict, position: int) -> float:
    """Forward flops of one query at ``position`` (0-based) attending its
    position + 1 keys, in every layer."""
    return 4.0 * arch["H"] * arch["hd"] * (position + 1) * arch["L"]


def train_flops_per_sequence(arch: dict, length: int) -> float:
    """Forward and backward (3x the forward) flops of one training row of
    ``length`` tokens: 6 x the active parameters a token, with the head,
    and the causal attention's products.  Recomputation (remat) is not
    counted: it is the implementation's choice, not the model's need."""
    return 3.0 * (2.0 * active_params(arch) * length
                  + causal_attention_flops(arch, length))


def serve_flops(arch: dict, prompt_len: int, first: int, last: int) -> float:
    """Flops to serve output tokens ``first .. last - 1`` (0-based) of a
    request with a prompt of ``prompt_len`` tokens; ``first == 0`` includes
    the prompt's prefill.  Token i of the output needs the head once; every
    token fed through the layers (the prompt, then each output token but
    the newest) needs the layers and its causal attention."""
    per_layer = 2.0 * arch["L"] * layer_params(arch)
    head = 2.0 * head_params(arch)
    total = 0.0
    if first == 0 and last > 0:
        total += prompt_len * per_layer + causal_attention_flops(arch,
                                                                 prompt_len)
    for i in range(max(first, 1), last):
        # output token i comes from feeding output token i - 1, which sits
        # at position prompt_len + i - 1
        total += per_layer + attention_flops_at(arch, prompt_len + i - 1)
    return total + head * max(0, last - first)

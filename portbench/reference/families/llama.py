"""The dense decoder's feed-forward block (Llama, Mistral): SwiGLU."""


def ffn(dec, x, w, capacity: bool):
    """``x`` (t, d) → (t, d); ``capacity`` has no meaning here."""
    return dec.swiglu(x, w("layers/mlp/w_gate"), w("layers/mlp/w_up"),
                      w("layers/mlp/w_down"))

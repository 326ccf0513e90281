"""Safetensors I/O and the HF-layout Llama bridge (counterpart of
``tpu_docker_api/models/import_weights.py``).

The JAX package reads and writes safetensors through the ``safetensors``
package; the port has its own reader and writer, so its GPU hosts need
nothing beyond torch and numpy. The format: an 8-byte little-endian header
length, a JSON header (``{name: {"dtype", "shape", "data_offsets"}}``
and an optional ``"__metadata__"`` of strings), then the tensors' raw
little-endian bytes, offsets counted from the end of the header. The
reader memory-maps each file copy-on-write and hands out zero-copy
tensor views; ``BF16`` is read as raw 16-bit words viewed as
``torch.bfloat16`` (as ``models/convert.py`` carries bf16 across). The
training checkpoints (``train/checkpoint.py``) use the same writer and
reader, so a params-only restore opens only the params file.

Layout mapping of the HF bridge (HF name → port path; a torch Linear
stores ``(out, in)``, the port ``(in, out)``):

    model.embed_tokens.weight                  embed/tokens     as-is
    model.layers.{i}.self_attn.{q,k,v,o}_proj  layers/attn/w*   stack + .T
    model.layers.{i}.mlp.{gate,up,down}_proj   layers/mlp/w_*   stack + .T
    model.layers.{i}.input_layernorm           layers/attn_norm stack
    model.layers.{i}.post_attention_layernorm  layers/mlp_norm  stack
    model.norm.weight                          final_norm       as-is
    lm_head.weight                             lm_head          .T (absent ⇒
                                               tied: embed_tokens.T)

    python -m tpu_docker_api_torch.models.import_weights \
        --ckpt-dir CKPT --preset llama3-1b --out EXPORT [--tie] [--device cpu]

exports a training checkpoint of the port as ``model.safetensors`` and
``config.json``.

Int8 at load (``import_hf_llama(quantize=True)``) streams layer by
layer: each (out, in) tensor is read from the mapping, cast to the model
dtype, quantized on the device with ``ops.quant.quantize_weight``'s math
and written into preallocated stacked int8 and scale buffers, so no
float copy of a stacked projection is ever held whole (the lm_head is
read whole, then quantized, as in the JAX package). The cast comes first,
so int8 at load equals "import, then ``quantize_llama_params``" bit for
bit. ``Tokenizer`` and ``load_tokenizer`` are importable from here, as
in the JAX package; they live in ``models/tokenizer.py``.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct

import torch

from tpu_docker_api_torch.models.tokenizer import Tokenizer, load_tokenizer
from tpu_docker_api_torch.ops.quant import QuantizedLinear, quantize_weight

__all__ = [
    "SafeTensorsFile", "HFCheckpoint", "save_file", "hf_llama_config",
    "import_hf_llama", "export_hf_llama", "Tokenizer", "load_tokenizer",
]

#: safetensors dtype names ↔ torch dtypes the port reads and writes
_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
           "F32": torch.float32, "I8": torch.int8, "I32": torch.int32,
           "I64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 * 2**20  # the safetensors package's own bound


class SafeTensorsFile:
    """One ``.safetensors`` file, memory-mapped copy-on-write. ``tensor``
    returns a zero-copy CPU view (writing to it never reaches the file);
    the mapping lives as long as any view of it."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file "
                                 f"(shorter than its 8-byte header length)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{self.path}: header of {n} bytes")
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size else None)
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self._start = 8 + n
        self._entries = header
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                                 f"{e['dtype']}, which the port does not read")
            begin, end = e["data_offsets"]
            want = _numel(e["shape"]) * _itemsize(_DTYPES[e["dtype"]])
            if end - begin != want or self._start + end > size:
                raise ValueError(f"{self.path}: tensor {name!r} spans "
                                 f"{begin}..{end}, which does not hold "
                                 f"{e['dtype']}{e['shape']}")

    def keys(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def tensor(self, name: str) -> torch.Tensor:
        e = self._entry(name)
        dtype, shape = _DTYPES[e["dtype"]], tuple(e["shape"])
        count = _numel(shape)
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        offset = self._start + e["data_offsets"][0]
        if offset % _itemsize(dtype):  # unaligned: copy the bytes out
            raw = torch.frombuffer(self._mm, dtype=torch.uint8,
                                   count=count * _itemsize(dtype),
                                   offset=offset).clone()
            return raw.view(dtype).reshape(shape)
        return torch.frombuffer(self._mm, dtype=dtype, count=count,
                                offset=offset).reshape(shape)

    def _entry(self, name: str) -> dict:
        e = self._entries.get(name)
        if e is None:
            raise KeyError(f"{self.path} has no tensor {name!r}")
        return e


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def write_order(tensors: dict) -> list[str]:
    """The order ``save_file`` writes (and brings to the host) tensors
    in: falling element size, then name."""
    return sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike,
              metadata: dict[str, str] | None = None) -> int:
    """Write ``tensors`` (any device; each is brought to the host one at
    a time) as one safetensors file; returns the bytes written. Tensors
    are laid out by falling element size, then name, after a header
    padded to 8 bytes, so every tensor starts aligned to its element
    size. The file appears under ``path`` only once complete (a
    temporary name, fsync, then a rename)."""
    names = write_order(tensors)
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name the port writes")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    path = os.fspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach()
            if t.numel():
                host = t.contiguous().cpu().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return 8 + len(blob) + offset


class HFCheckpoint:
    """Tensor resolver over an HF checkpoint directory (or a bare
    ``.safetensors`` file): one ``model.safetensors``, shards named by a
    ``model.safetensors.index.json``, or every ``*.safetensors`` file in
    the directory. Each file is opened once, and only when a tensor of
    it is first asked for."""

    def __init__(self, path: str | os.PathLike):
        path = os.fspath(path)
        self.path = path
        self._files: dict[str, SafeTensorsFile] = {}
        if os.path.isfile(path):
            self.directory = os.path.dirname(path) or "."
            fname = os.path.basename(path)
            self._map = {n: fname for n in self._open(fname).keys()}
            return
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        self.directory = path
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                self._map = dict(json.load(f)["weight_map"])
        elif os.path.exists(os.path.join(path, "model.safetensors")):
            self._map = {n: "model.safetensors"
                         for n in self._open("model.safetensors").keys()}
        else:
            cands = sorted(f for f in os.listdir(path)
                           if f.endswith(".safetensors"))
            if not cands:
                raise FileNotFoundError(
                    f"{path}: no model.safetensors, index, or "
                    f"*.safetensors files")
            self._map = {n: fname for fname in cands
                         for n in self._open(fname).keys()}

    def _open(self, fname: str) -> SafeTensorsFile:
        f = self._files.get(fname)
        if f is None:
            f = SafeTensorsFile(os.path.join(self.directory, fname))
            self._files[fname] = f
        return f

    def names(self) -> list[str]:
        return sorted(self._map)

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def tensor(self, name: str) -> torch.Tensor:
        fname = self._map.get(name)
        if fname is None:
            raise KeyError(f"checkpoint {self.path} has no tensor {name!r}")
        return self._open(fname).tensor(name)


# ------------------------------------------------------------ HF bridge

#: (port group, leaf) → HF projection name, in the order of the tree
_PROJS = {("attn", "wq"): "self_attn.q_proj",
          ("attn", "wk"): "self_attn.k_proj",
          ("attn", "wv"): "self_attn.v_proj",
          ("attn", "wo"): "self_attn.o_proj",
          ("mlp", "w_gate"): "mlp.gate_proj",
          ("mlp", "w_up"): "mlp.up_proj",
          ("mlp", "w_down"): "mlp.down_proj"}
_NORMS = {"attn_norm": "input_layernorm",
          "mlp_norm": "post_attention_layernorm"}
_HF_DTYPE = {torch.bfloat16: "bfloat16", torch.float16: "float16",
             torch.float32: "float32"}


def hf_llama_config(path: str, **overrides):
    """LlamaConfig from an HF ``config.json`` (a directory or the file).
    Only llama-architecture checkpoints are accepted; a ``rope_scaling``
    block of type ``llama3`` is carried over (also under the old
    ``"type"`` key), ``"default"`` is no scaling, and every other type is
    refused rather than imported with wrong RoPE frequencies."""
    from tpu_docker_api_torch.models.llama import LlamaConfig
    from tpu_docker_api_torch.ops.rope import RopeScaling

    cfg_path = (os.path.join(path, "config.json")
                if os.path.isdir(path) else path)
    with open(cfg_path) as f:
        hf = json.load(f)
    archs = hf.get("architectures") or []
    if archs and not any("llama" in a.lower() for a in archs):
        raise ValueError(f"{cfg_path}: architectures {archs} is not a "
                         f"llama family checkpoint")
    fields = dict(
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        ffn_dim=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
    )
    rs = hf.get("rope_scaling")
    if rs:
        rtype = rs.get("rope_type") or rs.get("type")
        if rtype == "llama3":
            fields["rope_scaling"] = RopeScaling(
                factor=float(rs["factor"]),
                low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
                high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
                original_max_position_embeddings=int(
                    rs.get("original_max_position_embeddings", 8192)))
        elif rtype != "default":
            raise ValueError(
                f"{cfg_path}: rope_scaling type {rtype!r} is not supported "
                f"(implemented: 'llama3', 'default'); refusing to import "
                f"with wrong RoPE frequencies")
    head_dim = hf.get("head_dim")
    if head_dim and head_dim * fields["n_heads"] != fields["dim"]:
        raise ValueError(
            f"{cfg_path}: head_dim {head_dim} × heads {fields['n_heads']} "
            f"!= hidden_size {fields['dim']}; non-uniform head layouts are "
            f"not supported")
    fields.update(overrides)
    return LlamaConfig(**fields)


def import_hf_llama(path, cfg=None, *, device: str | torch.device = "cuda",
                    quantize: bool = False):
    """(cfg, params) from an HF-layout llama checkpoint, on ``device`` in
    the model dtype. ``cfg`` defaults to ``hf_llama_config(path)``; given
    explicitly, any tensor whose shape does not fit it raises with its
    name. Each stacked leaf is allocated once on the device and filled
    layer by layer from the file's mapping. With ``quantize`` every
    projection and the lm_head load straight to int8
    (``QuantizedLinear`` leaves; module docstring)."""
    device = torch.device(device)
    ckpt = path if isinstance(path, HFCheckpoint) else HFCheckpoint(path)
    if cfg is None:
        cfg = hf_llama_config(ckpt.directory)
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim

    def get(name: str, shape: tuple[int, ...]) -> torch.Tensor:
        t = ckpt.tensor(name)
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} != expected {shape} for "
                f"config (dim={d}, heads={cfg.n_heads}/{cfg.n_kv_heads}, "
                f"ffn={cfg.ffn_dim}, vocab={cfg.vocab_size})")
        return t.to(device)

    def new(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device=device)

    shapes = {("attn", "wq"): (d, cfg.n_heads * hd),
              ("attn", "wk"): (d, cfg.n_kv_heads * hd),
              ("attn", "wv"): (d, cfg.n_kv_heads * hd),
              ("attn", "wo"): (cfg.n_heads * hd, d),
              ("mlp", "w_gate"): (d, cfg.ffn_dim),
              ("mlp", "w_up"): (d, cfg.ffn_dim),
              ("mlp", "w_down"): (cfg.ffn_dim, d)}
    layers: dict = {"attn": {}, "mlp": {}}
    for key, suffix in _PROJS.items():
        fin, fout = shapes[key]
        if quantize:
            # int8 stored (out, in): QuantizedLinear's column-major layout
            w8 = torch.empty((L, fout, fin), dtype=torch.int8, device=device)
            sc = torch.empty((L, fout), dtype=torch.float32, device=device)
        else:
            buf = new(L, fin, fout)
        for i in range(L):
            w = get(f"model.layers.{i}.{suffix}.weight", (fout, fin)).T
            if quantize:
                q = quantize_weight(w.to(cfg.dtype))
                w8[i].copy_(q.w_int8.T)
                sc[i].copy_(q.scale)
            else:
                buf[i].copy_(w)
        layers[key[0]][key[1]] = (QuantizedLinear(w8.transpose(-1, -2), sc)
                                  if quantize else buf)
    for leaf, hf_name in _NORMS.items():
        buf = new(L, d)
        for i in range(L):
            buf[i].copy_(get(f"model.layers.{i}.{hf_name}.weight", (d,)))
        layers[leaf] = buf
    embed = new(cfg.vocab_size, d)
    embed.copy_(get("model.embed_tokens.weight", (cfg.vocab_size, d)))
    head = new(d, cfg.vocab_size)
    if "lm_head.weight" in ckpt:
        head.copy_(get("lm_head.weight", (cfg.vocab_size, d)).T)
    else:  # tied embeddings: the output projection is the table's .T
        head.copy_(embed.T)
    if quantize:
        head = quantize_weight(head)
    final = new(d)
    final.copy_(get("model.norm.weight", (d,)))
    params = {"embed": {"tokens": embed},
              "layers": {"attn_norm": layers["attn_norm"],
                         "mlp_norm": layers["mlp_norm"],
                         "attn": layers["attn"], "mlp": layers["mlp"]},
              "final_norm": final, "lm_head": head}
    return cfg, params


def export_hf_llama(params: dict, cfg, out_dir: str,
                    *, tie_embeddings: bool = False) -> str:
    """Write an (unfused) port param tree as an HF-layout checkpoint:
    ``model.safetensors`` and ``config.json`` under ``out_dir``; returns
    the safetensors path. The inverse of :func:`import_hf_llama`, bit for
    bit. ``tie_embeddings`` leaves lm_head out (readers rebuild it from
    the embedding)."""
    os.makedirs(out_dir, exist_ok=True)
    layers = params["layers"]
    tensors = {"model.embed_tokens.weight": params["embed"]["tokens"],
               "model.norm.weight": params["final_norm"]}
    if not tie_embeddings:
        tensors["lm_head.weight"] = params["lm_head"].T
    for (group, leaf), suffix in _PROJS.items():
        for i, w in enumerate(layers[group][leaf].unbind(0)):
            tensors[f"model.layers.{i}.{suffix}.weight"] = w.T
    for leaf, hf_name in _NORMS.items():
        for i, w in enumerate(layers[leaf].unbind(0)):
            tensors[f"model.layers.{i}.{hf_name}.weight"] = w
    path = os.path.join(out_dir, "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.ffn_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": tie_embeddings,
        "torch_dtype": _HF_DTYPE.get(cfg.dtype, "bfloat16"),
    }
    if cfg.rope_scaling is not None:
        hf_cfg["rope_scaling"] = {
            "rope_type": "llama3",
            **dataclasses.asdict(cfg.rope_scaling)}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return path


def _main(argv=None) -> None:
    """Export a training checkpoint of the port as an HF-layout
    checkpoint (params only; the optimizer files are never read)."""
    import argparse
    import time

    p = argparse.ArgumentParser(
        prog="python -m tpu_docker_api_torch.models.import_weights")
    p.add_argument("--ckpt-dir", required=True,
                   help="training checkpoint directory of the port")
    p.add_argument("--preset", required=True,
                   help="llama preset the checkpoint was trained at")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--tie", action="store_true",
                   help="omit lm_head (tied-embedding layout)")
    p.add_argument("--device", default="cuda",
                   help="device the params pass through; cuda (the "
                        "default) raises without a card")
    args = p.parse_args(argv)

    from tpu_docker_api_torch import resolve_device
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.train.checkpoint import restore_model_params

    device = resolve_device(args.device)
    _, cfg = resolve_preset(args.preset)
    t0 = time.perf_counter()
    params, step = restore_model_params(args.ckpt_dir, cfg, device)
    t1 = time.perf_counter()
    path = export_hf_llama(params, cfg, args.out, tie_embeddings=args.tie)
    t2 = time.perf_counter()
    print(json.dumps({"event": "exported", "step": step, "path": path,
                      "bytes": os.path.getsize(path),
                      "restore_s": t1 - t0, "write_s": t2 - t1}),
          flush=True)


if __name__ == "__main__":
    _main()

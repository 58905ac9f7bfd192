"""Ahead-of-time export of the decode paths for serving.

Counterpart of openasr_tpu/serving.py.  Where the JAX package serializes
`jax.export` StableHLO, the port saves a `torch.export` ExportedProgram per
bucket and platform: the graph calls the kernels as the registered
operators of kernels/ops.py (`torch.ops.openasr.*`), so a serving process
runs the whole decode (the encoder's flash attention and LayerNorms, the
beam, the LM's steps, the fbank of an online model) from the artifact,
with no model code and no retracing.  The JAX package's serving rules
hold:

  * the artifact holds no weights: the model's parameters, and the LM's,
    are inputs of the program (the model's modules are reached through
    `torch.func.functional_call`, never lifted into the program), so one
    artifact serves any checkpoint of the configuration;
  * every decode knob is baked in and recorded in `meta.json` under the
    JAX package's keys (beam, maxlen, cutoffs, hotword table, LM weight,
    compute dtype), with the ordered names, shapes and dtypes of the
    parameter inputs and the model's config, which the weight bridge needs;
  * the loaders check loudly: the artifact's format and kind, a bucket
    that fits, the LM either way, the streams' capacities;
  * no pickle of code: the artifact is a zip of `meta.json` and
    `exports/<platform>/<program>.pt2` (ExportedProgram archives, saved
    without their example inputs, which would be the weights).

Programs are exported per platform ("cuda", "cpu") with their inputs on
that platform's device: the hotword tables, the positional-encoding table
and the fbank's tables are constants of the program on that device.  The
attention beam runs all `max_decode_len` steps (no host read of the
finished flags; same result, ops/beam_search.py), the encoder takes no
empty-row path (`empty_rows=False`: a caller's row whose encoder length is
0 gets O = 0 from the flash kernel where the live path gives the JAX dense
value; the loader's filler rows are cut from the output).

  export_beam_decode(model, [(8, 512)], "decode.zip")
  dec = ExportedDecoder("decode.zip")        # on the card if it has one
  params = dec.prepare_params(load_package("last.pkg")["model"])
  preds, lens, scores = dec(params, feats, feat_lens)
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from openasr_torch import quant
from openasr_torch.kernels import ops  # noqa: F401  (the programs' operators)

FORMAT = "torch.export"
PLATFORMS = ("cuda", "cpu")


# ------------------------------------------------------------ the programs


def _device_of(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r} is not one of {PLATFORMS}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' needs a CUDA card: export with "
                           "platforms=('cpu',), or load with device='cpu'")
    return torch.device(platform)


def _check_platforms(platforms: Sequence[str]) -> list:
    platforms = [str(p) for p in platforms]
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, "
                         f"got {platforms}")
    return platforms


class _Program(nn.Module):
    """The root module that torch.export traces: fn(inputs), inputs a tuple.
    It registers no submodule, so the export lifts no parameter."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, inputs):
        return self.fn(*inputs)


class _Swap(nn.Module):
    """Holds the model's (and the LM's) modules, so that
    `torch.func.functional_call` puts the program's parameter inputs in
    place of their parameters while `body` runs."""

    def __init__(self, modules: dict, body):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)
        self.body = body

    def forward(self, *args):
        return self.body(*args)


def _clear_tensor_caches() -> None:
    """Empty the caches of device tensors (the positional-encoding table,
    the fbank's tables): a trace fills them with its own fake tensors."""
    from openasr_torch.kernels.fbank import device_matrices
    from openasr_torch.models.layers import _pe_on
    from openasr_torch.ops.fbank import _window_and_banks

    for cache in (_pe_on, device_matrices, _window_and_banks):
        cache.cache_clear()


def _export(fn, inputs: tuple) -> bytes:
    """torch.export of fn(*inputs) -> the .pt2 archive's bytes, without the
    example inputs (the weights)."""
    _clear_tensor_caches()
    try:
        with torch.no_grad():
            ep = torch.export.export(_Program(fn), (tuple(inputs),))
    finally:
        _clear_tensor_caches()
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _load_program(data: bytes):
    return torch.export.load(io.BytesIO(data)).module()


def _param_plan(module: nn.Module, state: dict) -> list:
    """The parameter inputs of a program: [(name, shape, dtype str)] in the
    module's parameter order, a quantized weight as two inputs
    `<name>#int8:q` and `<name>#int8:scale` (`state`: the bridged state,
    `quant.bridge_quantized` or a plain state dict), each in the dtype the
    program takes (the module's, int8 and f32 for a quantized one)."""
    plan = []
    for name, p in module.named_parameters():
        entry = state[name]
        if quant.is_quantized_leaf(entry):
            for key in (quant.Q_KEY, quant.SCALE_KEY):
                plan.append({"name": f"{name}#{key}", "shape": list(entry[key].shape),
                             "dtype": str(entry[key].dtype).removeprefix("torch.")})
        else:
            plan.append({"name": name, "shape": list(p.shape),
                         "dtype": str(p.dtype).removeprefix("torch.")})
    return plan


def _inputs_of(plan: list, state: dict, device) -> tuple:
    """The program's parameter inputs from a bridged state, checked against
    the plan's shapes, on `device`."""
    out = []
    for spec in plan:
        name, _, key = spec["name"].partition("#")
        if name not in state:
            raise ValueError(f"the checkpoint has no parameter {name!r} that the artifact takes")
        t = state[name][key] if key else state[name]
        if list(t.shape) != spec["shape"]:
            raise ValueError(f"parameter {spec['name']}: the checkpoint's shape "
                             f"{list(t.shape)} != the artifact's {spec['shape']}")
        out.append(t.to(device=device, dtype=getattr(torch, spec["dtype"])))
    return tuple(out)


def _weights_of(plan: list, params: tuple, dtypes: dict) -> dict:
    """Inside a program: the parameter inputs -> {name: weight}, a
    quantized one dequantized (q * scale in f32) and cast to its
    parameter's dtype."""
    state: dict = {}
    for spec, t in zip(plan, params):
        name, _, key = spec["name"].partition("#")
        if key:
            state.setdefault(name, {})[key] = t
        else:
            state[name] = t
    deq = quant.dequantize_params(state)
    return {name: w.to(dtypes[name]) for name, w in deq.items()}


def _bridged_state(model_type: str, components: dict, configs, int8: bool) -> dict:
    from openasr_torch.convert import jax_components_to_state_dict

    if int8:
        return quant.bridge_quantized(model_type, quant.quantize_params(components), configs)
    return jax_components_to_state_dict(model_type, components, configs=configs)


def _model_state(model, int8: bool) -> dict:
    pkg = model.package()
    return _bridged_state(pkg["model_type"], pkg["components"], model.configs.to_dict(), int8)


class _Parts:
    """The modules a program runs with their parameter inputs' plans:
    `net` (the model's module) and optionally `lm` (the LM's)."""

    def __init__(self, model=None, lm=None, int8: bool = False):
        self.modules, self.plans, self.dtypes, self.states = {}, {}, {}, {}
        for key, framework, q in (("net", model, int8), ("lm", lm, False)):
            if framework is None:
                continue
            module = framework.module
            self.modules[key] = module
            self.states[key] = _model_state(framework, q)
            self.plans[key] = _param_plan(module, self.states[key])
            self.dtypes[key] = {n: p.dtype for n, p in module.named_parameters()}

    def example_inputs(self, key, device) -> tuple:
        """The module's own weights as the program's parameter inputs."""
        return _inputs_of(self.plans[key], self.states[key], device)

    def run(self, body, weights: dict, *args):
        """body(*args) with every module's parameters replaced by
        `weights[key]` (its parameter inputs)."""
        swapped = {f"{key}.{name}": w
                   for key, params in weights.items()
                   for name, w in _weights_of(self.plans[key], params,
                                              self.dtypes[key]).items()}
        return torch.func.functional_call(_Swap(self.modules, body), swapped, args)

    def to(self, device):
        for module in self.modules.values():
            module.to(device)


def _write(path: str, meta: dict, programs: dict) -> None:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=1))
        for name, data in programs.items():
            zf.writestr(f"exports/{name}.pt2", data)


def _read(path: str, kind, device: Optional[str]):
    """(meta, the platform's device, {program name: bytes}) of an artifact,
    refusing another format or kind and a platform it was not exported
    for."""
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        fmt = meta.get("format")
        if fmt != FORMAT:
            if fmt is None and any(n.endswith(".stablehlo") for n in zf.namelist()):
                fmt = "jax.export (StableHLO)"
            raise ValueError(f"{path} is a {fmt} artifact, not a {FORMAT} one: "
                             f"export it with openasr_torch.serving")
        kinds = (kind,) if isinstance(kind, str) else kind
        if meta.get("kind") not in kinds:
            raise ValueError(f"{path} is not a {' or '.join(kinds)} artifact "
                             f"(kind={meta.get('kind')!r})")
        if device is None:
            device = ("cuda" if torch.cuda.is_available() and "cuda" in meta["platforms"]
                      else "cpu")
        if device not in meta["platforms"]:
            raise ValueError(f"{path} has no program for {device!r}; it was exported "
                             f"for {meta['platforms']}")
        prefix = f"exports/{device}/"
        data = {n[len(prefix):-len(".pt2")]: zf.read(n)
                for n in zf.namelist() if n.startswith(prefix)}
    return meta, _device_of(device), data


def _lm_meta(lm, lm_weight: float, use_lm: bool, parts: _Parts):
    if not use_lm:
        return None
    return {"model_type": getattr(lm, "model_type", ""), "lm_weight": float(lm_weight),
            "configs": lm.configs.to_dict(), "params": parts.plans["lm"]}


def _prepare(plan_meta: dict, model_pkg: dict, int8: bool, device) -> tuple:
    """A package's model part -> a program's parameter inputs."""
    components = model_pkg["components"] if "components" in model_pkg else model_pkg
    state = _bridged_state(plan_meta["model_type"], components, plan_meta["configs"], int8)
    return _inputs_of(plan_meta["params"], state, device)


def _check_lm(meta: dict, lm_params) -> None:
    if meta.get("lm") and lm_params is None:
        raise ValueError(
            f"this artifact was exported with {meta['lm']['model_type']} shallow "
            f"fusion (weight {meta['lm']['lm_weight']}): pass the LM "
            f"checkpoint's params as lm_params (prepare_lm_params)")
    if not meta.get("lm") and lm_params is not None:
        raise ValueError("this artifact was exported WITHOUT LM fusion; lm_params "
                         "would be silently ignored — re-export with lm= to fuse")


# ------------------------------------------------------- batch decode export


def export_beam_decode(
    model,
    buckets: Sequence[Tuple[int, int]],
    path: str,
    beam_size: int = 5,
    max_decode_len: int = 60,
    platforms: Sequence[str] = PLATFORMS,
    weights: str = "float32",
    compute: str = "float32",
    ctc_device_beam: bool = False,
    context_phrases=None,
    context_weight: float = 0.0,
    cutoff_top_n: int = 40,
    cutoff_logp: float = -20.0,
    lm=None,
    lm_weight: float = 0.0,
) -> None:
    """Export the model's decode for each (batch, frames) bucket and
    platform (openasr_tpu/serving.py:export_beam_decode).

    Attention models export the attention beam (`batch_beam_decode` ->
    preds, lens, scores: kind 'beam'); conv-ctc exports greedy decode plus
    log-probs (kind 'ctc' -> ids, id_lens, log_probs, len_logits) or, with
    `ctc_device_beam`, the device prefix beam (kind 'ctc_beam' -> n-best
    tokens, lens, scores).  A model with an fbank frontend takes waves
    [B, samples] (a bucket's frames are then samples), else features
    [B, frames, input_dim].

    weights="int8": the program takes `quant.quantize_params` weights (two
    inputs a quantized weight) and dequantizes them; the loader's
    `prepare_params` quantizes each checkpoint once.  `compute` records the
    dtype the model was built in.  `lm` / `lm_weight`: shallow fusion in
    the beam and ctc_beam kinds, the LM's weights a second input (always
    f32).  Hotwords (`context_phrases`, `context_weight`) and the device
    beam's cutoffs are baked in and recorded."""
    from openasr_torch.models.lm import make_lm_fusion
    from openasr_torch.ops.ctc_beam_device import build_context_tables, ctc_prefix_beam_device
    from openasr_torch.ops.ctc_decode import ctc_greedy_decode

    platforms = _check_platforms(platforms)
    input_dim = int(model.configs.encoder["input_dim"])
    waves = (model.configs.signal or {}).get("feature_type") == "fbank"
    is_ctc = not hasattr(model, "batch_beam_decode")
    if weights not in ("float32", "int8"):
        raise ValueError(f"weights must be float32 or int8, got {weights!r}")
    int8 = weights == "int8"
    use_lm = lm is not None and lm_weight != 0.0
    if use_lm and is_ctc and not ctc_device_beam:
        raise ValueError(
            "LM fusion in a CTC export needs ctc_device_beam=True (the kind 'ctc' "
            "greedy+log-probs artifact has no fusion hook — same rule as infer.py)")
    use_ctx = context_phrases is not None and context_weight != 0.0
    vocab = int(model.configs.decoder["vocab_size"])
    tables = build_context_tables(np.asarray(context_phrases), vocab) if use_ctx else None
    ctx_kw = {"context_tables": tables, "context_weight": float(context_weight)} if use_ctx else {}
    parts = _Parts(model, lm if use_lm else None, int8)
    kind = ("ctc_beam" if ctc_device_beam else "ctc") if is_ctc else "beam"

    def body(feats, lens):
        if kind == "beam":
            return model.batch_beam_decode(
                feats, lens, beam_size=beam_size, max_decode_len=max_decode_len,
                empty_rows=False, lm=lm if use_lm else None,
                lm_weight=float(lm_weight) if use_lm else 0.0,
                stop_when_finished=False, **ctx_kw)
        logits, len_logits = model.get_logits(feats, lens, empty_rows=False)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        if kind == "ctc":
            ids, id_lens = ctc_greedy_decode(logits, len_logits)
            return ids, id_lens, log_probs, len_logits
        lm_kw = {}
        if use_lm:
            bb = log_probs.shape[0] * beam_size
            # <= one LM token a frame, + the <sos>
            step_fn, cache = make_lm_fusion(lm, bb, max_len=log_probs.shape[1] + 1)
            lm_kw = {"lm_step_fn": step_fn, "init_lm_cache": cache,
                     "lm_weight": float(lm_weight)}
        return ctc_prefix_beam_device(
            log_probs, len_logits, blank=vocab - 1, beam=beam_size,
            cutoff_top_n=int(cutoff_top_n), cutoff_logp=float(cutoff_logp),
            **lm_kw, **ctx_kw)

    programs = {}
    home = next(model.module.parameters()).device
    try:
        for platform in platforms:
            device = _device_of(platform)
            parts.to(device)
            params = parts.example_inputs("net", device)
            lm_params = parts.example_inputs("lm", device) if use_lm else None
            for b, t in buckets:
                shape = (b, t) if waves else (b, t, input_dim)
                feats = torch.zeros(shape, dtype=torch.float32, device=device)
                lens = torch.full((b,), t, dtype=torch.int32, device=device)
                if use_lm:
                    fn = lambda p, lp, f, ln: parts.run(body, {"net": p, "lm": lp}, f, ln)  # noqa: E731
                    inputs = (params, lm_params, feats, lens)
                else:
                    fn = lambda p, f, ln: parts.run(body, {"net": p}, f, ln)  # noqa: E731
                    inputs = (params, feats, lens)
                programs[f"{platform}/{int(b)}x{int(t)}"] = _export(fn, inputs)
    finally:
        parts.to(home)

    meta = {
        "format": FORMAT,
        "model_type": getattr(model, "model_type", ""),
        "kind": kind,
        "beam_size": int(beam_size),
        "max_decode_len": int(max_decode_len),
        "input_dim": input_dim,
        "feature_type": "fbank" if waves else "offline",
        "platforms": platforms,
        "buckets": [[int(b), int(t)] for b, t in buckets],
        "weights": weights,
        "compute": compute,
        "cutoff_top_n": int(cutoff_top_n),
        "cutoff_logp": float(cutoff_logp),
        # derived from the same conditions that bake them into the
        # program: the meta never claims biasing or fusion the program lacks
        "context_weight": float(context_weight) if use_ctx else 0.0,
        "context_num_phrases": int(np.shape(context_phrases)[0]) if use_ctx else 0,
        "lm": _lm_meta(lm, lm_weight, use_lm, parts),
        "configs": model.configs.to_dict(),
        "params": parts.plans["net"],
    }
    _write(path, meta, programs)


class ExportedDecoder:
    """Serving-side loader of an `export_beam_decode` artifact: picks the
    fitting bucket with the least padded area, zero-pads the batch into it
    (filler rows get length 1), runs the program and trims the rows.
    `device`: "cuda" or "cpu" (default: the card when the artifact has a
    cuda program and there is one)."""

    def __init__(self, path: str, device: Optional[str] = None):
        self.meta, self.device, data = _read(path, ("beam", "ctc", "ctc_beam"), device)
        self._fns = {tuple(int(x) for x in name.split("x")): _load_program(blob)
                     for name, blob in data.items()}
        self.buckets = sorted(self._fns)

    def prepare_params(self, model_pkg: dict) -> tuple:
        """The program's parameter inputs from the model part of a package
        (`load_package(...)["model"]`, written by either package): bridged
        to the port's layouts, int8-quantized when the artifact takes int8,
        on the program's device.  Once per checkpoint, not per call."""
        return _prepare(self.meta, model_pkg, self.meta.get("weights") == "int8", self.device)

    def prepare_lm_params(self, lm_pkg: dict) -> tuple:
        """The LM's parameter inputs from the model part of an LM package."""
        if not self.meta.get("lm"):
            raise ValueError("this artifact was exported WITHOUT LM fusion")
        return _prepare(self.meta["lm"], lm_pkg, False, self.device)

    def _pick(self, b: int, t: int) -> Tuple[int, int]:
        # least padded area, not the first that fits: with buckets
        # [(8, 4096), (16, 128)] an (8, 100) request runs (16, 128)
        fitting = [(bb * bt, bb, bt) for bb, bt in self.buckets if bb >= b and bt >= t]
        if not fitting:
            raise ValueError(f"no exported bucket fits batch={b} frames={t}; "
                             f"available: {self.buckets}")
        _, bb, bt = min(fitting)
        return bb, bt

    def __call__(self, params, feats, lens, lm_params=None):
        """feats [B, T, D] features (or [B, samples] waves for an fbank
        model), lens [B]; NumPy or tensors.  -> tensors on the program's
        device: kind 'beam' (preds [B, beam, U], lens, scores [B, beam]),
        'ctc' (ids [B, T'], id_lens, log_probs [B, T', V], len_logits),
        'ctc_beam' (tokens [B, beam, T'], lens, scores)."""
        feats = torch.as_tensor(feats, dtype=torch.float32)
        lens = torch.as_tensor(lens)
        waves = self.meta.get("feature_type") == "fbank"
        if waves != (feats.dim() == 2) or (not waves and
                                           feats.shape[-1] != self.meta["input_dim"]):
            want = "[B, samples]" if waves else f"[B, T, {self.meta['input_dim']}]"
            raise ValueError(f"inputs {list(feats.shape)} are not the artifact's {want}")
        _check_lm(self.meta, lm_params)
        b, t = feats.shape[:2]
        bb, bt = self._pick(b, t)
        padded = torch.zeros((bb, bt) + tuple(feats.shape[2:]), dtype=torch.float32,
                             device=self.device)
        padded[:b, :t] = feats.to(self.device)
        plens = torch.ones((bb,), dtype=torch.int32, device=self.device)
        plens[:b] = lens.to(device=self.device, dtype=torch.int32)
        inputs = ((tuple(params), tuple(lm_params), padded, plens) if self.meta.get("lm")
                  else (tuple(params), padded, plens))
        out = self._fns[(bb, bt)](inputs)
        return tuple(o[:b] for o in out)


# ---------------------------------------------------- streaming tick export


def _tree_spec_meta(tree) -> dict:
    """{path: {shape, dtype}} of a nest of dicts of tensors: enough to
    rebuild a zeroed state with no model code."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = {"shape": list(node.shape),
                            "dtype": str(node.dtype).removeprefix("torch.")}

    walk(tree, "")
    return flat


def _tree_from_spec_meta(flat: dict, device=None) -> dict:
    out: dict = {}
    for path, spec in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.zeros(spec["shape"], dtype=getattr(torch, spec["dtype"]),
                                      device=device)
    return out


def export_streaming_step(
    model,
    batch_sizes: Sequence[int],
    path: str,
    platforms: Sequence[str] = PLATFORMS,
    max_frames: int = 5000,
) -> None:
    """Export the streaming executor's tick (streaming.py `_step_impl`),
    one program per stream batch size and platform
    (openasr_tpu/serving.py:export_streaming_step).  The meta records the
    state's shapes and dtypes per batch size, so a serving process builds
    the zero state and drives the loop with no model code; the model's
    parameters are an input.  An online (fbank) model's tick runs the fbank
    operator on its wave chunk."""
    from openasr_torch.streaming import StreamingRecognizer

    platforms = _check_platforms(platforms)
    parts = _Parts(model)
    programs, state_meta = {}, {}
    home = next(model.module.parameters()).device
    try:
        for platform in platforms:
            device = _device_of(platform)
            parts.to(device)
            rec = StreamingRecognizer(model, max_frames=max_frames)
            params = parts.example_inputs("net", device)
            for b in batch_sizes:
                b = int(b)
                state = rec.init_state(b)
                shape = (b, 4 * rec.chunk, rec.feat_dim) if rec.offline else (b, rec.chunk_samples)
                chunk = torch.zeros(shape, dtype=torch.float32, device=device)
                chunk_lens = torch.full((b,), shape[1], dtype=torch.int64, device=device)
                programs[f"{platform}/b{b}"] = _export(
                    lambda p, s, c, cl: parts.run(rec._step_impl, {"net": p}, s, c, cl),
                    (params, state, chunk, chunk_lens))
                state_meta[str(b)] = _tree_spec_meta(state)
    finally:
        parts.to(home)

    meta = {
        "format": FORMAT,
        "kind": "streaming_step",
        "model_type": getattr(model, "model_type", ""),
        "chunk": rec.chunk,
        "phase": int(rec.phase),
        "left_chunks": rec.left,
        "offline": bool(rec.offline),
        "feat_dim": int(rec.feat_dim),
        "chunk_input": [4 * rec.chunk, rec.feat_dim] if rec.offline else [rec.chunk_samples],
        "max_frames": int(max_frames),
        "platforms": platforms,
        "batch_sizes": [int(b) for b in batch_sizes],
        "state": state_meta,
        "configs": model.configs.to_dict(),
        "params": parts.plans["net"],
    }
    _write(path, meta, programs)


class ExportedStreamer:
    """Serving-side streaming loop over an `export_streaming_step` artifact:
    `init_state(b)` builds the zero state from the recorded shapes,
    `step(params, state, chunk[, chunk_lens])` runs the tick and returns
    (new state, {"enc", "valid", "logits"}).  Pad the streams up to an
    exported batch size (padded rows are silent streams)."""

    def __init__(self, path: str, device: Optional[str] = None):
        self.meta, self.device, data = _read(path, "streaming_step", device)
        self._fns = {int(name[1:]): _load_program(blob) for name, blob in data.items()}
        self.batch_sizes = sorted(self._fns)
        self.chunk = int(self.meta["chunk"])

    def prepare_params(self, model_pkg: dict) -> tuple:
        """The tick's parameter inputs from the model part of a package."""
        return _prepare(self.meta, model_pkg, False, self.device)

    def _check_batch(self, b: int) -> None:
        if b not in self._fns:
            raise ValueError(f"no exported program for batch_size={b}; available: "
                             f"{self.batch_sizes} (pad your streams up to a bucket)")

    def init_state(self, batch_size: int) -> dict:
        self._check_batch(batch_size)
        return _tree_from_spec_meta(self.meta["state"][str(batch_size)], self.device)

    def step(self, params, state, chunk, chunk_lens=None):
        chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
        b = chunk.shape[0]
        expected = [b] + self.meta["chunk_input"]
        if list(chunk.shape) != expected:
            raise ValueError(f"chunk shape {list(chunk.shape)} != exported {expected}")
        self._check_batch(b)
        if chunk_lens is None:
            chunk_lens = torch.full((b,), chunk.shape[1], dtype=torch.int64)
        chunk_lens = torch.as_tensor(chunk_lens).to(device=self.device, dtype=torch.int64)
        # the live step's positional-encoding guard (streaming.py), on the host
        cur = int(state["chunk_idx"])
        if (cur + 1) * self.chunk - int(self.meta["phase"]) > int(self.meta["max_frames"]):
            raise ValueError(
                f"stream exceeds exported positional-encoding capacity (max_frames="
                f"{self.meta['max_frames']}); re-export with a larger max_frames")
        return self._fns[b]((tuple(params), state, chunk, chunk_lens))


# --------------------------------------------- streaming prefix-beam export


def export_stream_beam(
    path: str,
    batch: int,
    beam: int,
    chunk: int,
    max_frames: int,
    vocab_size: int,
    blank: int,
    platforms: Sequence[str] = PLATFORMS,
    cutoff_top_n: int = 40,
    cutoff_logp: float = -20.0,
    lm=None,
    lm_weight: float = 0.0,
    context_phrases=None,
    context_weight: float = 0.0,
    sos_id: int = 1,
) -> None:
    """Export the streaming CTC prefix beam's tick
    (ops/ctc_beam_device.py:ctc_beam_stream_body) and its seeding, two
    programs a platform (openasr_tpu/serving.py:export_stream_beam):

      init: ([lm_params]) -> state   (the <sos> LM step makes it depend on
            the LM's weights, so it is a program too)
      tick: (state, log_probs [B, chunk, V], frame_valid [B, chunk]
            [, lm_params]) -> (new state, (tokens, lens, scores))

    Feed it the log-softmax of the logits a streaming-step artifact emits
    each tick.  Hotwords and the cutoffs are baked in; the LM's weights
    are an input.  Serve with `ExportedStreamBeam`."""
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import (
        build_context_tables,
        ctc_beam_stream_body,
        ctc_beam_stream_init,
    )

    platforms = _check_platforms(platforms)
    use_lm = lm is not None and lm_weight != 0.0
    use_ctx = context_phrases is not None and context_weight != 0.0
    tables = (build_context_tables(np.asarray(context_phrases), int(vocab_size))
              if use_ctx else None)
    n_phrases = int(tables["plen"].shape[0]) if use_ctx else 0
    parts = _Parts(lm=lm if use_lm else None)
    spec = make_lm_step_spec(lm) if use_lm else None

    def init_body(device):
        kw = {}
        if use_lm:
            kw = {"lm_step_fn": spec["step_fn"],
                  "init_lm_cache": spec["init_cache_fn"](batch * beam, max_frames + 1),
                  "sos_id": int(sos_id)}
        return ctc_beam_stream_init(int(batch), int(beam), int(max_frames),
                                    num_phrases=n_phrases, device=device, **kw)

    def tick_body(state, log_probs, frame_valid):
        kw = {"lm_step_fn": spec["step_fn"], "lm_weight": float(lm_weight)} if use_lm else {}
        if use_ctx:
            kw.update(context_tables=tables, context_weight=float(context_weight))
        return ctc_beam_stream_body(state, log_probs, frame_valid, blank=int(blank),
                                    beam=int(beam), cutoff_top_n=int(cutoff_top_n),
                                    cutoff_logp=float(cutoff_logp), **kw)

    programs = {}
    home = next(lm.module.parameters()).device if use_lm else None
    try:
        for platform in platforms:
            device = _device_of(platform)
            parts.to(device)
            log_probs = torch.zeros((batch, chunk, vocab_size), dtype=torch.float32,
                                    device=device)
            valid = torch.zeros((batch, chunk), dtype=torch.bool, device=device)
            if use_lm:
                lm_params = parts.example_inputs("lm", device)
                init = lambda lp: parts.run(lambda: init_body(device), {"lm": lp})  # noqa: E731
                state0 = init(lm_params)
                programs[f"{platform}/init"] = _export(init, (lm_params,))
                programs[f"{platform}/tick"] = _export(
                    lambda s, logp, fv, lmp: parts.run(tick_body, {"lm": lmp}, s, logp, fv),
                    (state0, log_probs, valid, lm_params))
            else:
                state0 = init_body(device)
                programs[f"{platform}/init"] = _export(lambda: init_body(device), ())
                programs[f"{platform}/tick"] = _export(tick_body, (state0, log_probs, valid))
    finally:
        if use_lm:
            parts.to(home)

    meta = {
        "format": FORMAT,
        "kind": "stream_beam",
        "batch": int(batch),
        "beam": int(beam),
        "chunk": int(chunk),
        "max_frames": int(max_frames),
        "vocab_size": int(vocab_size),
        "blank": int(blank),
        "cutoff_top_n": int(cutoff_top_n),
        "cutoff_logp": float(cutoff_logp),
        "platforms": platforms,
        "lm": _lm_meta(lm, lm_weight, use_lm, parts),
        "context_weight": float(context_weight) if use_ctx else 0.0,
        "context_num_phrases": n_phrases,
    }
    _write(path, meta, programs)


class ExportedStreamBeam:
    """Serving-side loader of an `export_stream_beam` artifact:
    `init_state([lm_params])` runs the seeding program, `step(state,
    log_probs, frame_valid[, lm_params])` one tick -> (new state, (tokens,
    lens, scores)), the running n-best.  It replays the live step's
    token-buffer guard on the host."""

    def __init__(self, path: str, device: Optional[str] = None):
        self.meta, self.device, data = _read(path, "stream_beam", device)
        self._init = _load_program(data["init"])
        self._tick = _load_program(data["tick"])

    def prepare_lm_params(self, lm_pkg: dict) -> tuple:
        """The LM's parameter inputs from the model part of an LM package."""
        if not self.meta.get("lm"):
            raise ValueError("artifact exported without LM fusion")
        return _prepare(self.meta["lm"], lm_pkg, False, self.device)

    def init_state(self, lm_params=None):
        if self.meta.get("lm"):
            if lm_params is None:
                raise ValueError("artifact exported with LM fusion: init_state needs the "
                                 "LM checkpoint's params")
            return self._init((tuple(lm_params),))
        if lm_params is not None:
            raise ValueError("artifact exported without LM fusion")
        return self._init(())

    def step(self, state, log_probs, frame_valid, lm_params=None):
        from openasr_torch.ops.ctc_beam_device import check_token_capacity

        log_probs = torch.as_tensor(log_probs, dtype=torch.float32).to(self.device)
        frame_valid = torch.as_tensor(frame_valid).to(device=self.device, dtype=torch.bool)
        b, ch = self.meta["batch"], self.meta["chunk"]
        if tuple(log_probs.shape) != (b, ch, self.meta["vocab_size"]):
            raise ValueError(f"log_probs shape {tuple(log_probs.shape)} != exported "
                             f"{(b, ch, self.meta['vocab_size'])}")
        check_token_capacity(state, frame_valid)
        if self.meta.get("lm"):
            if lm_params is None:
                raise ValueError("artifact exported with LM fusion: step needs the LM "
                                 "checkpoint's params")
            return self._tick((state, log_probs, frame_valid, tuple(lm_params)))
        return self._tick((state, log_probs, frame_valid))

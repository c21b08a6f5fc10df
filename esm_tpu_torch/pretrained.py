"""Checkpoint loading and model handles.

Port of esm_tpu/pretrained.py (reference semantics: esm/pretrained.py,
esm/esmfold/v1/pretrained.py) for the language models and ESMFold.
``load_model_and_alphabet_local`` reads a ``.pt`` and its co-located
``-contact-regression.pt``: an ``esm2*`` file takes the v2 path (the key
prefixes stripped), any other the fairseq-era v1 path (``upgrade_state_v1``:
args and keys lose their module prefixes, ESM-1b's ``<mask>`` embedding row
is zeroed, the MSA Transformer's row and column keys are swapped back, the
ESM-IF1 keys of older layouts are renamed). The state loads strictly into
the port's ``ESM2``, ``ESM1`` (ESM-1, ESM-1b, ESM-1v) or ``MSATransformer``
behind an ``LMHandle``, or into ``GVPTransformerModel`` (ESM-IF1) behind an
``IFHandle``. ``load_esmfold`` reads an esmfold ``.pt`` and its LM into an
``ESMFoldHandle``. A registry name resolves only from the local cache
(``ESM_TPU_CACHE``, default ``~/.cache/esm_tpu/checkpoints``): downloading
is not ported (there is no network). ``random_model_and_alphabet`` builds any registered model at
its released size with seeded random weights.

Device: every entry point runs on CUDA unless the caller passes
``device="cpu"``; with no GPU and no CPU request it raises. Nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
import warnings
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from .data.alphabet import Alphabet
from .io.export import _swap_row_column
from .models import esm1 as esm1_mod
from .models import esm2 as esm2_mod
from .models import inverse_folding as if_mod
from .models import msa_transformer as msa_mod
from .utils.validation import check_coords


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, which must exist; "cpu" must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' (or --nogpu) to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _has_regression_weights(model_name: str) -> bool:
    """(reference esm/pretrained.py:18-21)"""
    return not (
        "esm1v" in model_name
        or "esm_if" in model_name
        or "270K" in model_name
        or "500K" in model_name
    )


# ---------------------------------------------------------------------------
# Key upgrades (reference esm/pretrained.py:85-183)
# ---------------------------------------------------------------------------


def has_emb_layer_norm_before(model_state) -> bool:
    """ESM-1b-style checkpoints carry the pre-embedding LN (reference
    esm/pretrained.py:76-82)."""
    return any(k.startswith("emb_layer_norm_before") for k in model_state)


def _strip_through(key: str, marker: str, guard: str) -> str:
    """Drop everything up to and including the first ``marker`` in ``key``
    (and any later occurrence), when ``guard`` appears in the key; a key
    with ``guard`` but no ``marker`` maps to "" (the mapping of the
    reference's fairseq-era renames, esm/pretrained.py:91-108)."""
    if guard not in key:
        return key
    _, hit, tail = key.partition(marker)
    if not hit:
        return ""
    return tail.replace(marker, "")


def _rename_v1_args(args: Dict[str, Any], stem: str) -> Dict[str, Any]:
    """Argparse-namespace keys lose their ``{stem}_`` module prefix."""
    return {_strip_through(k, stem + "_", stem): v for k, v in args.items()}


def _rename_v1_state(state: Dict, stem: str) -> Dict:
    """State-dict keys lose the ``{stem}.sentence_encoder.`` / ``{stem}.``
    module paths (fairseq wrapped the model in an encoder/decoder shell)."""
    out = {}
    for k, v in state.items():
        k = _strip_through(k, "sentence_encoder.", "sentence_encoder")
        out[_strip_through(k, stem + ".", stem)] = v
    return out


# ESM-IF1 checkpoints predate the module layout the reference (and both
# packages) use: ordered substring renames, applied first to last
# (esm_tpu/pretrained.py:150-160; reference esm/pretrained.py:128-146).
_GVP_KEY_RENAMES: Tuple[Tuple[str, str], ...] = (
    ("W_v", "embed_graph.embed_node"),
    ("W_e", "embed_graph.embed_edge"),
    ("embed_scores.0", "embed_confidence"),
    ("embed_score.", "embed_graph.embed_confidence."),
    ("seq_logits_projection.", ""),
    ("embed_ingraham_features", "embed_dihedrals"),
    ("embed_gvp_in_local_frame.0", "embed_gvp_output"),
    ("embed_features_in_local_frame.0", "embed_gvp_input_features"),
)


def upgrade_state_v1(model_data) -> Tuple[Dict[str, Any], Dict, str]:
    """The fairseq-era upgrades, per architecture (esm_tpu/pretrained.py:163-197).
    Returns (args dict, canonical state, arch)."""
    arch = model_data["args"].arch
    state = model_data["model"]
    args = vars(model_data["args"])
    if arch == "roberta_large":  # ESM-1b / ESM-1v
        args = _rename_v1_args(args, "encoder")
        state = _rename_v1_state(state, "encoder")
        alphabet = Alphabet.from_architecture("ESM-1b")
        state["embed_tokens.weight"][alphabet.mask_idx].zero_()  # the token-dropout row
        args["emb_layer_norm_before"] = has_emb_layer_norm_before(state)
    elif arch == "protein_bert_base":  # ESM-1
        args = _rename_v1_args(args, "decoder")
        state = _rename_v1_state(state, "decoder")
    elif arch == "msa_transformer":
        args = _rename_v1_args(args, "encoder")
        state = _rename_v1_state({_swap_row_column(k): v for k, v in state.items()}, "encoder")
        if args.get("embed_positions_msa", False):
            args["embed_positions_msa_dim"] = state["msa_position_embedding"].size(-1)
    elif "invariant_gvp" in arch:
        renamed = {}
        for k, v in state.items():
            if "version" in k:
                continue
            for old, new in _GVP_KEY_RENAMES:
                k = k.replace(old, new)
            renamed[k] = v
        state = renamed
    else:
        raise ValueError(f"Unknown architecture {arch}")
    return args, state, arch


def upgrade_state_v2(state: Dict) -> Dict:
    """Strip 'encoder.sentence_encoder.' / 'encoder.' prefixes
    (reference esm/pretrained.py:164-174)."""
    pattern = re.compile("^" + "|".join(["encoder.sentence_encoder.", "encoder."]))
    return {pattern.sub("", k): v for k, v in state.items()}


# ---------------------------------------------------------------------------
# Language-model handles
# ---------------------------------------------------------------------------

_APPLY = {"esm2": esm2_mod.apply, "esm1": esm1_mod.apply, "msa": msa_mod.apply}


class LMHandle:
    """Callable handle exposing the reference forward contract
    ({"logits", "representations", "attentions", "contacts"}; the MSA
    Transformer's row and column attentions). Holds the module (``ESM2``,
    ``ESM1`` or ``MSATransformer``: ``kind`` "esm2", "esm1" or "msa"), the
    config whose execution options apply, the alphabet and the device."""

    def __init__(self, kind: str, cfg, model: torch.nn.Module, alphabet: Alphabet):
        if kind not in _APPLY:
            raise ValueError(f"unknown language-model kind {kind!r}: one of {sorted(_APPLY)}")
        self.kind = kind
        self.cfg = cfg
        self.model = model
        self.alphabet = alphabet

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim

    @property
    def attention_heads(self) -> int:
        return self.cfg.attention_heads

    def with_options(self, **kw) -> "LMHandle":
        """A handle on the same weights with execution options changed, e.g.
        ``model.with_options(compute_dtype=torch.bfloat16, use_flash=True)``
        (the MSA Transformer has no flash path: compute_dtype and
        max_tokens_per_msa)."""
        return LMHandle(self.kind, dataclasses.replace(self.cfg, **kw), self.model,
                        self.alphabet)

    def quantized(self, **kw) -> "LMHandle":
        """A weight-only int8 handle (esm_tpu_torch/quantization.py) on a
        quantized copy of the weights: the linears' weights at a quarter of
        their fp32 size, same API. ``kw``: ``quantize_params``' options."""
        from .quantization import quantize_params

        return LMHandle(self.kind, self.cfg, quantize_params(copy.deepcopy(self.model), **kw),
                        self.alphabet)

    @torch.no_grad()
    def __call__(
        self,
        tokens,
        repr_layers: Sequence[int] = (),
        need_head_weights: bool = False,
        return_contacts: bool = False,
    ):
        from .utils.validation import check_repr_layers, check_tokens

        tokens = check_tokens(tokens, self.alphabet, msa=self.kind == "msa")
        check_repr_layers(repr_layers, self.num_layers)
        tokens = torch.as_tensor(
            np.asarray(tokens) if not isinstance(tokens, torch.Tensor) else tokens
        ).to(device=self.device, dtype=torch.int64)
        apply = _APPLY[self.kind]
        if repr_layers and not (return_contacts and not need_head_weights):
            # only the requested layers are kept in the loop
            return apply(
                self.model, self.cfg, tokens,
                need_head_weights=need_head_weights,
                return_contacts=return_contacts,
                repr_layers=tuple(repr_layers),
            )
        out = apply(
            self.model, self.cfg, tokens,
            need_head_weights=need_head_weights,
            return_contacts=return_contacts,
            return_representations=bool(repr_layers),
        )
        if repr_layers:
            reps = out["representations"]
            n = reps.shape[0] - 1
            out["representations"] = {(i if i >= 0 else n + 1 + i): reps[i] for i in repr_layers}
        return out

    def predict_contacts(self, tokens):
        return self(tokens, return_contacts=True)["contacts"]


class IFHandle:
    """ESM-IF1 handle (esm_tpu/pretrained.py:303-335): ``sample``,
    ``score_sequence``, ``forward`` and ``get_encoder_output`` on the device
    the model was built on. Holds the config, the ``GVPTransformerModel``
    and the alphabet."""

    def __init__(self, cfg, model: torch.nn.Module, alphabet: Alphabet):
        self.cfg = cfg
        self.model = model
        self.alphabet = alphabet

    @property
    def device(self) -> torch.device:
        return self.model.device

    def sample(self, coords, **kw):
        """Sequence design (models/inverse_folding/model.py ``sample``)."""
        check_coords(coords)
        return if_mod.sample(self.model, self.alphabet, coords, **kw)

    def score_sequence(self, coords, seq: str):
        """(log-likelihood over the sequence, over the residues with coordinates)."""
        check_coords(coords)
        return if_mod.score_sequence(self.model, self.alphabet, coords, seq)

    def get_encoder_output(self, coords) -> torch.Tensor:
        check_coords(coords)
        return if_mod.get_encoder_output(self.model, self.alphabet, coords)

    @torch.no_grad()
    def forward(self, coords, padding_mask, confidence, prev_output_tokens):
        """Teacher-forced logits (B, V, T) of a converted batch."""
        check_coords(coords, batched=True)
        dev = self.device
        return self.model(torch.as_tensor(coords, device=dev),
                          torch.as_tensor(padding_mask, device=dev),
                          torch.as_tensor(confidence, device=dev),
                          torch.as_tensor(prev_output_tokens, device=dev, dtype=torch.int64))


def _build_if1_from_state(args, state, device) -> IFHandle:
    """GVPTransformerConfig from the (upgraded) args, then a strict load
    (esm_tpu/pretrained.py:503-526)."""
    alphabet = Alphabet.from_architecture("invariant_gvp")
    cfg = if_mod.GVPTransformerConfig.from_alphabet(
        alphabet, **{f.name: args[f.name] for f in dataclasses.fields(if_mod.GVPTransformerConfig)
                     if f.name.startswith(("encoder_", "decoder_", "gvp_"))})
    model = if_mod.GVPTransformerModel(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return IFHandle(cfg, model, alphabet)


def _esm2_alphabet() -> Alphabet:
    return Alphabet.from_architecture("ESM-1b")


def _build_lm_from_state(model_name, args, state, arch, regression_data, device) -> LMHandle:
    """Config and module from the (upgraded) args, then a strict load
    (esm_tpu/pretrained.py:411-486)."""
    from .io.convert import load_lm_state

    if regression_data is not None:
        state = dict(state)
        state.update(regression_data["model"])
    elif _has_regression_weights(model_name):
        warnings.warn(
            "Regression weights not found, predicting contacts will not produce "
            "correct results."
        )
    if arch == "esm2":
        alphabet = _esm2_alphabet()
        cfg = esm2_mod.ESM2Config.from_alphabet(
            alphabet,
            num_layers=args["encoder_layers"],
            embed_dim=args["encoder_embed_dim"],
            attention_heads=args["encoder_attention_heads"],
            token_dropout=args["token_dropout"],
        )
        kind, model = "esm2", esm2_mod.ESM2(cfg, device=device)
    elif arch in ("roberta_large", "protein_bert_base"):
        is_1b = arch == "roberta_large"
        alphabet = Alphabet.from_architecture("ESM-1b" if is_1b else "ESM-1")
        sizes = dict(num_layers=args["layers"], embed_dim=args["embed_dim"],
                     ffn_embed_dim=args["ffn_embed_dim"],
                     attention_heads=args["attention_heads"],
                     token_dropout=args.get("token_dropout", False))
        if is_1b:
            sizes.update(max_positions=args["max_positions"],
                         emb_layer_norm_before=args.get("emb_layer_norm_before", False))
        else:
            sizes.update(final_bias=args.get("final_bias", True))
        cfg = esm1_mod.ESM1Config.from_alphabet(
            alphabet, model_version="ESM-1b" if is_1b else "ESM-1", **sizes)
        kind, model = "esm1", esm1_mod.ESM1(cfg, device=device)
    elif arch == "msa_transformer":
        alphabet = Alphabet.from_architecture("msa_transformer")
        cfg = msa_mod.MSATransformerConfig.from_alphabet(
            alphabet,
            num_layers=args["layers"],
            embed_dim=args["embed_dim"],
            ffn_embed_dim=args["ffn_embed_dim"],
            attention_heads=args["attention_heads"],
            max_positions=args["max_positions"],
            embed_positions_msa=args.get("embed_positions_msa", False),
        )
        kind, model = "msa", msa_mod.MSATransformer(cfg, device=device)
    else:
        raise ValueError(f"Unknown architecture {arch}")
    load_lm_state(model, state)
    return LMHandle(kind, cfg, model, alphabet)


def load_model_and_alphabet_core(model_name, model_data, regression_data=None, device=None):
    """A model handle from loaded checkpoint data (esm_tpu/pretrained.py:
    489-529): an ``LMHandle``, or an ``IFHandle`` for ESM-IF1. Returns
    (handle, alphabet)."""
    device = resolve_device(device)
    if model_name.startswith("esm2"):
        ck = model_data["cfg"]["model"]
        args = {"encoder_layers": ck.encoder_layers,
                "encoder_embed_dim": ck.encoder_embed_dim,
                "encoder_attention_heads": ck.encoder_attention_heads,
                "token_dropout": ck.token_dropout}
        state, arch = upgrade_state_v2(model_data["model"]), "esm2"
    else:
        args, state, arch = upgrade_state_v1(model_data)
        if "invariant_gvp" in arch:
            handle = _build_if1_from_state(args, state, device)
            return handle, handle.alphabet
    handle = _build_lm_from_state(model_name, args, state, arch, regression_data, device)
    return handle, handle.alphabet


def load_model_and_alphabet_local(model_location, device=None):
    """Load ``<name>.pt`` and, when present, ``<name>-contact-regression.pt``."""
    device = resolve_device(device)
    model_location = Path(model_location)
    model_data = torch.load(str(model_location), map_location="cpu", weights_only=False)
    model_name = model_location.stem
    regression_data = None
    if _has_regression_weights(model_name):
        rloc = Path(str(model_location.with_suffix("")) + "-contact-regression.pt")
        if rloc.exists():
            regression_data = torch.load(str(rloc), map_location="cpu", weights_only=False)
    return load_model_and_alphabet_core(model_name, model_data, regression_data, device)


def cache_dir() -> Path:
    return Path(os.environ.get("ESM_TPU_CACHE", Path.home() / ".cache/esm_tpu/checkpoints"))


def load_model_and_alphabet_hub(model_name: str, device=None):
    """A registry name, from the local cache only: the port downloads
    nothing (esm_tpu's downloader, cli/download.py, is not ported)."""
    path = cache_dir() / f"{model_name}.pt"
    if not path.exists():
        raise FileNotFoundError(
            f"{model_name}: {path} is not in the local cache (ESM_TPU_CACHE), and "
            "downloading is not ported: the port reads checkpoints from the cache only"
        )
    return load_model_and_alphabet_local(path, device=device)


def load_model_and_alphabet(model_name: str, device=None):
    if model_name.endswith(".pt"):
        return load_model_and_alphabet_local(model_name, device=device)
    return load_model_and_alphabet_hub(model_name, device=device)


# The constructor without a suffix loads the first of the five ESM-1v models
# (esm_tpu/pretrained.py:607-608).
_ALIASES = {"esm1v_t33_650M_UR90S": "esm1v_t33_650M_UR90S_1"}


def random_model_and_alphabet(model_name: str, *, seed: int = 0, device=None, **options):
    """A model handle at a released size (``ESM2_SIZES``, ``ESM1_SIZES``,
    ``MSA_SIZES``, ``IF1_SIZES``) with seeded random weights, built on the
    device from a ``torch.Generator`` there. ``options`` are a language
    model's execution options (compute_dtype, use_flash); ESM-IF1 has none."""
    device = resolve_device(device)
    model_name = _ALIASES.get(model_name, model_name)
    gen = torch.Generator(device=device).manual_seed(seed)
    if model_name in esm2_mod.ESM2_SIZES:
        alphabet = _esm2_alphabet()
        cfg = esm2_mod.ESM2Config.from_alphabet(
            alphabet, **esm2_mod.ESM2_SIZES[model_name], **options)
        return LMHandle("esm2", cfg, esm2_mod.init(cfg, gen, device=device), alphabet), alphabet
    if model_name in esm1_mod.ESM1_SIZES:
        size = esm1_mod.ESM1_SIZES[model_name]
        alphabet = Alphabet.from_architecture(size["model_version"])
        cfg = esm1_mod.ESM1Config.from_alphabet(alphabet, **size, **options)
        return LMHandle("esm1", cfg, esm1_mod.init(cfg, gen, device=device), alphabet), alphabet
    if model_name in msa_mod.MSA_SIZES:
        alphabet = Alphabet.from_architecture("msa_transformer")
        cfg = msa_mod.MSATransformerConfig.from_alphabet(
            alphabet, **msa_mod.MSA_SIZES[model_name], **options)
        return LMHandle("msa", cfg, msa_mod.init(cfg, gen, device=device), alphabet), alphabet
    if model_name in if_mod.IF1_SIZES:
        if options:
            raise TypeError(f"ESM-IF1 takes no execution options, got {sorted(options)}")
        alphabet = Alphabet.from_architecture("invariant_gvp")
        cfg = if_mod.GVPTransformerConfig.from_alphabet(alphabet, **if_mod.IF1_SIZES[model_name])
        return IFHandle(cfg, if_mod.init(cfg, gen, device=device), alphabet), alphabet
    raise ValueError(f"unknown model {model_name!r}")


def _make_constructor(name, file_name=None):
    def ctor(device=None):
        return load_model_and_alphabet_hub(file_name or name, device=device)

    ctor.__name__ = name
    ctor.__doc__ = f"Load {file_name or name} from the local cache. Returns (model, alphabet)."
    return ctor


for _name in (*esm1_mod.ESM1_SIZES, *msa_mod.MSA_SIZES, *esm2_mod.ESM2_SIZES,
              *if_mod.IF1_SIZES):
    globals()[_name] = _make_constructor(_name)
for _name, _file in _ALIASES.items():
    globals()[_name] = _make_constructor(_name, _file)


# ---------------------------------------------------------------------------
# ESMFold (reference esm/esmfold/v1/pretrained.py)
# ---------------------------------------------------------------------------

ESM_REGISTRY_FOR_FOLD = {
    "esm2_8M": "esm2_t6_8M_UR50D_500K",
    "esm2_8M_270K": "esm2_t6_8M_UR50D",
    "esm2_35M": "esm2_t12_35M_UR50D_500K",
    "esm2_35M_270K": "esm2_t12_35M_UR50D",
    "esm2_150M": "esm2_t30_150M_UR50D_500K",
    "esm2_150M_270K": "esm2_t30_150M_UR50D_270K",
    "esm2_650M": "esm2_t33_650M_UR50D",
    "esm2_650M_270K": "esm2_t33_650M_270K_UR50D",
    "esm2_3B": "esm2_t36_3B_UR50D",
    "esm2_3B_270K": "esm2_t36_3B_UR50D_500K",
    "esm2_15B": "esm2_t48_15B_UR50D",
}
_FOLD_ALIASES = {"esmfold_v0": "esmfold_3B_v0", "esmfold_v1": "esmfold_3B_v1"}


def _check_lm_options(esm_cfg) -> None:
    if esm_cfg.use_flash and esm_cfg.compute_dtype == torch.float16:
        raise ValueError("the flash-attention kernel (K1) has no float16 path: use "
                         "lm_dtype=torch.bfloat16 with use_flash, or float16 without it")


class ESMFoldHandle:
    """ESMFold handle with the reference model's API (esm/esmfold/v1/esmfold.py:
    152, 281, 350, 354: infer / infer_pdb(s) / output_to_pdb / set_chunk_size).
    Holds the config whose execution options apply, the ``ESMFold`` module
    and the alphabet; unpacks as ``cfg, model, alphabet = handle``."""

    def __init__(self, cfg, model: torch.nn.Module, alphabet: Alphabet):
        _check_lm_options(cfg.esm)
        self.cfg = cfg
        self.model = model
        self.alphabet = alphabet

    def __iter__(self):
        return iter((self.cfg, self.model, self.alphabet))

    @property
    def device(self) -> torch.device:
        return self.model.device

    def infer(self, sequences, **kw):
        """``esmfold.infer``; with ``pair_spec`` set (``with_options``) pass
        ``mesh=`` to fold through ``esmfold.apply_sharded``."""
        from .models.esmfold import esmfold as ef

        return ef.infer(self.model, self.cfg, sequences, **kw)

    def infer_pdbs(self, seqs, **kw):
        from .models.esmfold import esmfold as ef

        return ef.infer_pdbs(self.model, self.cfg, seqs, **kw)

    def infer_pdb(self, seq, **kw):
        return self.infer_pdbs([seq], **kw)[0]

    @staticmethod
    def output_to_pdb(output):
        from .models.esmfold.protein import output_to_pdb

        return output_to_pdb(output)

    def set_chunk_size(self, chunk_size) -> None:
        """Chunked triangle attention, in place (reference esmfold.py:354-360):
        O(L) pair-stage memory at some speed."""
        self.cfg = dataclasses.replace(
            self.cfg, trunk=dataclasses.replace(self.cfg.trunk, chunk_size=chunk_size))

    def with_options(self, *, lm_dtype=None, use_flash=None, **trunk_updates) -> "ESMFoldHandle":
        """A handle on the same weights with execution options changed:
        ``lm_dtype`` and ``use_flash`` (kernel K1) for the LM, the rest
        trunk options (compute_dtype, use_flash_tri, chunk_size, and
        pair_spec, e.g. ("tp",), for the sharded fold: ``infer(...,
        mesh=mesh)``). float16 with flash raises: K1 has no float16 path."""
        cfg = self.cfg
        lm = {k: v for k, v in (("compute_dtype", lm_dtype), ("use_flash", use_flash))
              if v is not None}
        if lm:
            cfg = dataclasses.replace(cfg, esm=dataclasses.replace(cfg.esm, **lm))
        if trunk_updates:
            cfg = dataclasses.replace(cfg, trunk=dataclasses.replace(cfg.trunk, **trunk_updates))
        return ESMFoldHandle(cfg, self.model, self.alphabet)

    def quantized(self, **kw) -> "ESMFoldHandle":
        """Weight-only int8 LM and trunk on a quantized copy of the weights
        (esm-fold --int8)."""
        from .quantization import quantize_params

        return ESMFoldHandle(self.cfg, quantize_params(copy.deepcopy(self.model), **kw),
                             self.alphabet)


def _fast(cfg):
    """The serving preset of esm_tpu's ``load_esmfold(fast=True)``: bf16 LM
    with flash attention (K1), bf16 trunk with fused triangle attention (K6)."""
    return dataclasses.replace(
        cfg,
        esm=dataclasses.replace(cfg.esm, compute_dtype=torch.bfloat16, use_flash=True),
        trunk=dataclasses.replace(cfg.trunk, compute_dtype=torch.bfloat16, use_flash_tri=True),
    )


def load_esmfold(path_or_name: str, fast: bool = False, device=None) -> ESMFoldHandle:
    """Load an ESMFold checkpoint and its LM (esm_tpu/pretrained.py:618-701;
    reference esm/esmfold/v1/pretrained.py:13-38). The esmfold ``.pt`` holds
    ``{cfg, model}`` without the LM's ``esm.*`` keys; the LM is the checkpoint
    that ``ESM_REGISTRY_FOR_FOLD[cfg.esm_type]`` names, from the local cache.
    A name (``esmfold_v1``, ``esmfold_3B_v1``, ...) resolves from the local
    cache only. ``fast=True``: bf16 LM with K1, bf16 trunk with K6."""
    from .models.esmfold.esmfold import ESMFold, ESMFoldConfig
    from .models.esmfold.structure_module import StructureModuleConfig
    from .models.esmfold.trunk import FoldingTrunkConfig

    device = resolve_device(device)
    if str(path_or_name).endswith(".pt"):
        path = Path(path_or_name)
    else:
        name = _FOLD_ALIASES.get(path_or_name, path_or_name)
        path = cache_dir() / f"{name}.pt"
        if not path.exists():
            raise FileNotFoundError(f"{name}: {path} is not in the local cache, and "
                                    "downloading is not ported: the port reads "
                                    "checkpoints from the cache only")
    model_data = torch.load(str(path), map_location="cpu", weights_only=False)
    ck = model_data["cfg"]["model"]
    lm_handle, alphabet = load_model_and_alphabet_hub(ESM_REGISTRY_FOR_FOLD[ck.esm_type],
                                                      device=device)
    tc, smc = ck.trunk, ck.trunk.structure_module
    sm_keys = ("c_s", "c_z", "c_ipa", "c_resnet", "no_heads_ipa", "no_qk_points", "no_v_points",
               "no_blocks", "no_transition_layers", "no_resnet_blocks", "no_angles",
               "trans_scale_factor")
    cfg = ESMFoldConfig(
        esm=lm_handle.cfg,
        trunk=FoldingTrunkConfig(
            num_blocks=tc.num_blocks,
            sequence_state_dim=tc.sequence_state_dim,
            pairwise_state_dim=tc.pairwise_state_dim,
            sequence_head_width=tc.sequence_head_width,
            pairwise_head_width=tc.pairwise_head_width,
            position_bins=tc.position_bins,
            max_recycles=tc.max_recycles,
            structure_module=StructureModuleConfig(**{k: getattr(smc, k) for k in sm_keys}),
        ),
        use_esm_attn_map=getattr(ck, "use_esm_attn_map", False),
        lddt_head_hid_dim=getattr(ck, "lddt_head_hid_dim", 128),
        esm_type=ck.esm_type,
    )
    if fast:
        cfg = _fast(cfg)
    model = ESMFold(cfg, esm=lm_handle.model, device=device)
    state = {k: v for k, v in model_data["model"].items() if not k.startswith("esm.")}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.startswith("esm.")]
    if missing or unexpected:
        raise RuntimeError(f"{path}: missing keys {missing}, unexpected keys {unexpected}")
    return ESMFoldHandle(cfg, model, alphabet)


def esmfold_v0(fast: bool = False, device=None) -> ESMFoldHandle:
    return load_esmfold("esmfold_3B_v0", fast=fast, device=device)


def esmfold_v1(fast: bool = False, device=None) -> ESMFoldHandle:
    return load_esmfold("esmfold_3B_v1", fast=fast, device=device)


def random_esmfold(name: str = "esmfold_v1", *, seed: int = 0, device=None, fast: bool = False,
                   **options) -> ESMFoldHandle:
    """ESMFold v1 (or v0, which adds the LM attention-map features) at its
    released size, ESM2-3B LM and 48-block trunk, with seeded random
    weights built on the device (``init_esmfold``). ``fast`` as in
    :func:`load_esmfold`; ``options`` are execution options, as
    :meth:`ESMFoldHandle.with_options` takes them."""
    from .models.esmfold.esmfold import ESMFoldConfig
    from .models.esmfold.init import init_esmfold
    from .models.esmfold.trunk import FoldingTrunkConfig

    if name not in _FOLD_ALIASES:
        raise ValueError(f"unknown ESMFold {name!r}: one of {sorted(_FOLD_ALIASES)}")
    device = resolve_device(device)
    alphabet = _esm2_alphabet()
    cfg = ESMFoldConfig(
        esm=esm2_mod.ESM2Config.from_alphabet(alphabet, **esm2_mod.ESM2_SIZES["esm2_t36_3B_UR50D"]),
        trunk=FoldingTrunkConfig(),
        use_esm_attn_map=name == "esmfold_v0",
        esm_type="esm2_3B",
    )
    if fast:
        cfg = _fast(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    handle = ESMFoldHandle(cfg, init_esmfold(cfg, gen, device=device), alphabet)
    return handle.with_options(**options) if options else handle


# Structure-module-only ablations (esm_tpu/pretrained.py:712-731; reference
# esm/pretrained.py:422-553): ESMFold with a trunk of zero blocks over each
# ESM-2 size, from the local cache only.
SM_ONLY_SIZES = ("8M", "8M_270K", "35M", "35M_270K", "150M", "150M_270K", "650M", "650M_270K",
                 "3B", "3B_270K", "15B")


def _make_smonly(size):
    name = f"esmfold_structure_module_only_{size}"

    def ctor(fast: bool = False, device=None) -> ESMFoldHandle:
        return load_esmfold(name, fast=fast, device=device)

    ctor.__name__ = name
    ctor.__doc__ = (f"ESMFold's structure-module-only baseline over ESM-2 {size}, from the "
                    "local cache. Returns an ESMFoldHandle.")
    return ctor


for _size in SM_ONLY_SIZES:
    globals()[f"esmfold_structure_module_only_{_size}"] = _make_smonly(_size)

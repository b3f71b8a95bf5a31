"""Static-shape multimodal embedding splice.

The reference implementation splices vision features into the token stream
with a per-sample Python loop over dynamic-length tensors inside ``forward``
(reference: vcoder_llava/model/llava_arch.py:99-200,
vcoder_llava_arch.py:185-296, vcoder_ds_llava_arch.py:126-314). That pattern
cannot compile to a single XLA graph. Here the splice is split into:

1. :func:`build_splice_plan` — **host-side**, pure Python/numpy: walks the
   sentinel ids exactly like the reference loops and produces fixed-shape
   index/mask arrays (a :class:`SplicePlan`).
2. ``models/vcoder.py::assemble_embeddings`` — **on-device**: one gather from
   the text-embedding table + one gather from the concatenated vision-feature
   table + a select. Fully static shapes, fuses into the prefill graph.

Reference-fidelity notes (verified against the reference by simulation):

* ``tokenizer_seg_token`` puts the image sentinel *before* the seg sentinel
  (cluster ``[-200, -300]``), so the stream order is
  ``[text, image×N, seg×N, text]``.
* In the **DS** arch the seg-splice loop runs *before* the depth loop and
  appends only the seg features — never the text preceding the seg sentinel
  (vcoder_ds_llava_arch.py:238). With the standard cluster
  ``[-200, -400, -300]`` this silently consumes the depth sentinel, so
  **depth features never reach the LM** in the reference (training or
  inference). We reproduce this exactly by default
  (``ds_mode=True``); the depth loop is still implemented for the
  (reference-reachable) case of a ``-400`` appearing after the last
  ``-300``.
* Labels covering spliced feature spans become ``IGNORE_INDEX``; in DS mode
  the labels of the text preceding a seg sentinel are *dropped*
  (vcoder_ds_llava_arch.py:241), exactly like the reference.
* Rows without sentinels pass through as pure text (the reference's
  zero-width-feature DeepSpeed hack, llava_arch.py:121-133, is a no-op in
  functional JAX).

A copy of ``vcoder_tpu/multimodal.py`` for the PyTorch port, which imports nothing
of ``vcoder_tpu``; keep the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from vcoder_tpu_torch.constants import (
    DEPTH_TOKEN_INDEX,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    SEG_TOKEN_INDEX,
)

# Per-row vision-feature table layout: enabled modalities are concatenated in
# this fixed order; sentinel occurrence k of a modality maps to rows
# [base + k*num_patches, base + (k+1)*num_patches). Multi-occurrence prompts
# (e.g. two <image> sentinels) consume successive blocks, mirroring the
# reference's cur_image_idx += 1 walk (llava_arch.py:141-162).
_MODALITY_ORDER = ("image", "seg", "depth")


@dataclasses.dataclass
class SplicePlan:
    """Fixed-shape gather plan for one batch of multimodal prompts.

    All arrays have shape ``[B, T]`` where ``T`` is the (bucketed) expanded
    sequence length.
    """

    safe_ids: np.ndarray  # int32; sentinels/padding -> pad_id (embeddable)
    is_text: np.ndarray  # bool; True where the position is a text token
    vis_idx: np.ndarray  # int32; row index into the per-sample vision table
    attn_mask: np.ndarray  # bool; True over real content
    position_ids: np.ndarray  # int32; 0..len-1 over real content
    labels: Optional[np.ndarray]  # int32 with IGNORE_INDEX, or None
    seq_lens: np.ndarray  # int32 [B]; true expanded lengths
    # Static (trace-time) metadata:
    use_vcoder_emb: bool  # route text embeds through vcoder_lm_emb
    vis_table_size: int  # rows in the per-sample vision feature table
    # Occurrence counts the vision table is laid out for (blocks per
    # modality; the caller must supply this many feature blocks per row).
    n_image: int = 1
    n_seg: int = 0
    n_depth: int = 0

    @property
    def batch(self) -> int:
        return self.safe_ids.shape[0]

    @property
    def seq_len(self) -> int:
        return self.safe_ids.shape[1]


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def build_splice_plan(
    input_ids: Sequence[Sequence[int]],
    *,
    num_patches: int,
    has_image: bool = True,
    has_seg: bool = False,
    has_depth: bool = False,
    ds_mode: bool = False,
    it_mode: bool = False,
    is_depth_zero: Optional[Sequence[bool]] = None,
    is_seg_zero: Optional[Sequence[bool]] = None,
    labels: Optional[Sequence[Sequence[int]]] = None,
    pad_to: Optional[int] = None,
    pad_multiple: int = 128,
    pad_id: int = 0,
) -> SplicePlan:
    """Build the static splice plan for a batch of sentinel-bearing id rows.

    Args:
      input_ids: per-row *unpadded* token ids (sentinels are negative).
      num_patches: vision tokens per modality occurrence (576 in production).
      has_image/has_seg/has_depth: which feature tensors the caller will
        provide (mirrors ``images=/segs=/depths=`` being non-None).
      ds_mode: use the VCoder-DS splice asymmetry (seg loop emits no
        preceding text). False reproduces the plain VCoder / LLaVA loops.
      it_mode: VCoder-IT splice (reference: vcoder_it_llava_arch.py:164-240):
        llava-style passthrough condition (no image token), DS-style seg
        loop, per-row ``is_seg_zero`` skip, no depth.
      is_depth_zero: per-row flag for the all-black depth placeholder skip
        (reference: vcoder_ds_llava_arch.py:160-171). Defaults to all-True
        when no depth provided, all-False otherwise.
      is_seg_zero: per-row all-black seg skip (IT only,
        vcoder_it_llava_arch.py:148-162).
      labels: optional per-row label ids aligned with input_ids.
      pad_to: expanded sequence length; default rounds the max row up to
        ``pad_multiple`` (TPU lane alignment).

    Multi-occurrence prompts must group sentinels modality-major
    (all <image> before all <seg> before all <depth>, which is what the
    splice tokenizers emit): the loops consume modalities in that order,
    so an interleaved [img, seg, img, seg] layout swallows the first
    <seg> as text — bit-for-bit what the reference's loops do
    (vcoder_llava_arch.py:215-246).
    """
    batch = len(input_ids)
    if is_depth_zero is None:
        is_depth_zero = [not has_depth] * batch
    if is_seg_zero is None:
        is_seg_zero = [not has_seg] * batch

    # Vision-table layout: one block per sentinel OCCURRENCE. The block
    # count per modality is the batch-wide max (rows with fewer sentinels
    # simply never index the surplus blocks); the caller must provide
    # matching per-row feature stacks (models/vcoder.py::encode_vision
    # accepts [B, N, H, W, C]).
    def _max_occ(sentinel, enabled):
        if not enabled:
            return 0
        return max(
            (list(row).count(sentinel) for row in input_ids), default=0
        ) or 1  # modality features provided even if no row has a sentinel

    n_image = _max_occ(IMAGE_TOKEN_INDEX, has_image)
    n_seg = _max_occ(SEG_TOKEN_INDEX, has_seg)
    n_depth = _max_occ(DEPTH_TOKEN_INDEX, has_depth and ds_mode)
    vis_table_size = max(num_patches * (n_image + n_seg + n_depth), 1)
    base = {"image": 0}
    off = n_image * num_patches
    if has_seg:
        base["seg"] = off
        off += n_seg * num_patches
    if has_depth and ds_mode:
        base["depth"] = off

    rows = []
    for b in range(batch):
        row_labels = list(labels[b]) if labels is not None else None
        rows.append(
            _splice_row(
                list(input_ids[b]),
                row_labels,
                num_patches=num_patches,
                base=base,
                has_image=has_image,
                has_seg=has_seg,
                ds_mode=ds_mode,
                it_mode=it_mode,
                depth_zero=bool(is_depth_zero[b]),
                seg_zero=bool(is_seg_zero[b]),
            )
        )

    max_len = max(len(r[0]) for r in rows)
    if pad_to is None:
        pad_to = _round_up(max_len, pad_multiple)
    if pad_to < max_len:
        raise ValueError(f"pad_to={pad_to} < expanded length {max_len}")

    T = pad_to
    safe_ids = np.full((batch, T), pad_id, dtype=np.int32)
    is_text = np.zeros((batch, T), dtype=bool)
    vis_idx = np.zeros((batch, T), dtype=np.int32)
    attn = np.zeros((batch, T), dtype=bool)
    pos = np.zeros((batch, T), dtype=np.int32)
    lab = (
        np.full((batch, T), IGNORE_INDEX, dtype=np.int32)
        if labels is not None
        else None
    )
    seq_lens = np.zeros((batch,), dtype=np.int32)

    for b, (kinds, values, row_lab) in enumerate(rows):
        L = len(kinds)
        seq_lens[b] = L
        attn[b, :L] = True
        pos[b, :L] = np.arange(L, dtype=np.int32)
        k = np.asarray(kinds, dtype=bool)
        v = np.asarray(values, dtype=np.int32)
        is_text[b, :L] = k
        # Sentinels CAN survive _splice_row as text positions: the
        # pure-text passthrough path, seg_zero/depth_zero rows (the
        # reference leaves the token in and raw-embeds the negative id,
        # vcoder_it_llava_arch.py:230-231), and interleaved multi-pair
        # prompts whose later-modality sentinels the earlier loop
        # swallows (the reference's modality-major loops do the same).
        # Map them to pad_id: one attended junk position, like the
        # reference's wrapped embedding lookup.
        safe_ids[b, :L] = np.where(k & (v >= 0), v, pad_id)
        vis_idx[b, :L] = np.where(~k, v, 0)
        if lab is not None:
            lab[b, :L] = np.asarray(row_lab, dtype=np.int32)

    return SplicePlan(
        safe_ids=safe_ids,
        is_text=is_text,
        vis_idx=vis_idx,
        attn_mask=attn,
        position_ids=pos,
        labels=lab,
        seq_lens=seq_lens,
        use_vcoder_emb=has_seg,
        vis_table_size=vis_table_size,
        n_image=n_image,
        n_seg=n_seg,
        n_depth=n_depth,
    )


def validate_features(plan: SplicePlan, images, segs=None, depths=None):
    """Check the provided pixel stacks match the plan's table layout.

    The vision table's base offsets are computed from the batch-wide
    sentinel occurrence counts; a mismatch with the actual number of
    feature stacks ([B, N, H, W, C] -> N, [B, H, W, C] -> 1) would make
    the gather read the wrong blocks — fail loudly instead.
    """
    def n_of(x):
        return 0 if x is None else (x.shape[1] if x.ndim == 5 else 1)

    for name, need, have in (
        ("image", plan.n_image, n_of(images)),
        ("seg", plan.n_seg, n_of(segs)),
        ("depth", plan.n_depth, n_of(depths)),
    ):
        if need and need != have:
            raise ValueError(
                f"prompt batch needs {need} <{name}> feature stack(s) per "
                f"row but {have} were provided; pass pixels as "
                "[B, N, H, W, C] with N matching the max sentinel "
                "occurrence count"
            )
        if have and not need:
            # Provided but unplanned (e.g. depths on a non-DS model, or
            # segs with no <seg> sentinel): silently dropping the input
            # hides a caller bug — the reference's API can't even
            # express it (no depth argument on non-DS archs).
            raise ValueError(
                f"{name} features were provided but the plan has no "
                f"<{name}> blocks (wrong model_type, or the prompt has "
                "no sentinel for this modality)"
            )


def _splice_row(
    ids: List[int],
    labels: Optional[List[int]],
    *,
    num_patches: int,
    base: dict,
    has_image: bool,
    has_seg: bool,
    ds_mode: bool,
    depth_zero: bool,
    it_mode: bool = False,
    seg_zero: bool = False,
):
    """Replicate the reference splice loops for one row.

    Returns (kinds, values, labels_out) where kinds[i] is True for text and
    values[i] is the token id (text) or vision-table row (feature).
    """
    kinds: List[bool] = []
    values: List[int] = []
    lab_out: Optional[List[int]] = [] if labels is not None else None

    has_img_tok = IMAGE_TOKEN_INDEX in ids
    has_seg_tok = SEG_TOKEN_INDEX in ids
    # Reference hack-path conditions (pure-text passthrough):
    #   vcoder arch: no image OR no seg  (vcoder_llava_arch.py:187)
    #   ds arch:     no image AND no seg (vcoder_ds_llava_arch.py:181)
    #   it arch:     no image            (vcoder_it_llava_arch.py:169)
    #   llava arch:  no image            (llava_arch.py:121)
    if has_seg and not it_mode:
        if ds_mode:
            passthrough = not has_img_tok and not has_seg_tok
        else:
            passthrough = not has_img_tok or not has_seg_tok
    else:
        passthrough = not has_img_tok

    if passthrough:
        for i, t in enumerate(ids):
            kinds.append(True)
            values.append(t)
            if lab_out is not None:
                lab_out.append(labels[i])
        return kinds, values, lab_out

    def emit_text(tokens: List[int], labs: Optional[List[int]]):
        for j, t in enumerate(tokens):
            kinds.append(True)
            values.append(t)
            if lab_out is not None:
                lab_out.append(labs[j])

    occ = {"image": 0, "seg": 0, "depth": 0}

    def emit_features(modality: str):
        # Each occurrence consumes the NEXT feature block of its modality,
        # matching the reference's cur_image_idx += 1 walk
        # (llava_arch.py:141-162). The table is sized for the batch-wide
        # max occurrence count, so the block always exists.
        start = base[modality] + occ[modality] * num_patches
        occ[modality] += 1
        for p in range(num_patches):
            kinds.append(False)
            values.append(start + p)
            if lab_out is not None:
                lab_out.append(IGNORE_INDEX)

    cur = ids
    cur_lab = labels

    # --- image loop (llava_arch.py:141-162 / ds:217-231) ---
    # Gated on has_image: with no image features the table has ZERO
    # image blocks, so splicing would alias whatever modality owns
    # offset 0. A leftover <image> sentinel falls through to the tail
    # as an attended pad position — the stand-in for the reference's
    # raw embed of the negative id when images are absent.
    while has_image and IMAGE_TOKEN_INDEX in cur:
        i = cur.index(IMAGE_TOKEN_INDEX)
        emit_text(cur[:i], cur_lab[:i] if cur_lab is not None else None)
        emit_features("image")
        cur = cur[i + 1:]
        if cur_lab is not None:
            cur_lab = cur_lab[i + 1:]

    # --- seg loop ---
    if has_seg and not seg_zero:
        while SEG_TOKEN_INDEX in cur:
            i = cur.index(SEG_TOKEN_INDEX)
            if not (ds_mode or it_mode):
                # vcoder arch emits preceding text (vcoder_llava_arch.py:236)
                emit_text(cur[:i], cur_lab[:i] if cur_lab is not None else None)
            # ds/it archs drop the preceding text AND its labels
            # (vcoder_ds_llava_arch.py:238,241; vcoder_it_llava_arch.py:219)
            emit_features("seg")
            cur = cur[i + 1:]
            if cur_lab is not None:
                cur_lab = cur_lab[i + 1:]

    # --- depth loop (ds arch only; vcoder_ds_llava_arch.py:246-262) ---
    if ds_mode and not depth_zero and "depth" in base:
        while DEPTH_TOKEN_INDEX in cur:
            i = cur.index(DEPTH_TOKEN_INDEX)
            emit_text(cur[:i], cur_lab[:i] if cur_lab is not None else None)
            emit_features("depth")
            cur = cur[i + 1:]
            if cur_lab is not None:
                cur_lab = cur_lab[i + 1:]

    # --- tail ---
    emit_text(cur, cur_lab)
    return kinds, values, lab_out

"""Conversation state and prompt templating.

A copy of ``vcoder_tpu/conversation.py`` for the PyTorch port, which imports
nothing of ``vcoder_tpu``; keep the two in step. Message entries are
``[role, message]`` where a message is a string or the reference's 7-tuple
``(text, image, image_mode, seg, seg_mode, depth, depth_mode)``, prompts
render per :class:`SeparatorStyle` (reference:
vcoder_llava/vcoder_conversation.py), and the modality getters apply the
Pad/Default/Crop/Resize process modes plus the max-800/min-400 display
resize. The getters and :meth:`VCoderConversation.to_gradio_chatbot` are UI
helpers for the gradio demo: they import PIL when called (gradio depends on
it) and raise ``ImportError`` without it. ``_b64_png`` of a numpy array
needs no PIL: it encodes with the port's ``png.encode_png``.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Any, List, Optional, Tuple

from vcoder_tpu_torch.preprocess import BACKGROUND_COLOR


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


def _msg_text(message) -> str:
    return message[0] if isinstance(message, tuple) else message


@dataclasses.dataclass
class VCoderConversation:
    """Conversation history + prompt rendering."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        messages = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + _msg_text(message) + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + _msg_text(message) + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + _msg_text(message) + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:

            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    message = _msg_text(message)
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += _msg_text(message) + seps[i % 2]
            return ret
        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    # ---- modality getters -------------------------------------------------

    # tuple slot of each modality: (value_index, mode_index)
    _SLOTS = {"image": (1, 2), "seg": (3, 4), "depth": (5, 6)}

    def _get_modality(self, name: str, return_pil: bool):
        from PIL import Image
        import numpy as np

        val_i, mode_i = self._SLOTS[name]
        out = []
        for i, (_, msg) in enumerate(self.messages[self.offset :]):
            if i % 2 != 0 or not isinstance(msg, tuple):
                continue
            item, mode = msg[val_i], msg[mode_i]
            if item is None:
                continue
            if isinstance(item, np.ndarray):
                item = Image.fromarray(item)
            if mode == "Pad":
                item = _pil_expand2square(item)
            elif mode in ("Default", "Crop"):
                pass
            elif mode == "Resize":
                item = item.resize((336, 336))
            else:
                raise ValueError(f"Invalid image_process_mode: {mode}")
            item = _display_resize(item)
            if return_pil:
                out.append(item)
            else:
                out.append(_b64_png(item))
        return out

    def get_images(self, return_pil: bool = False):
        return self._get_modality("image", return_pil)

    def get_segs(self, return_pil: bool = False):
        return self._get_modality("seg", return_pil)

    def get_depths(self, return_pil: bool = False):
        return self._get_modality("depth", return_pil)

    def to_gradio_chatbot(self):
        ret = []
        for i, (_, msg) in enumerate(self.messages[self.offset :]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text = msg[0]
                    for name, sentinel in (
                        ("image", "<image>"),
                        ("seg", "<seg>"),
                        ("depth", "<depth>"),
                    ):
                        val_i, _ = self._SLOTS[name]
                        item = msg[val_i]
                        if item is None:
                            continue
                        b64 = _b64_jpeg(_display_resize(_as_pil(item)))
                        tag = (
                            f'<img src="data:image/png;base64,{b64}" '
                            f'alt="user upload {name}" />'
                        )
                        text = tag + text.replace(sentinel, "").strip()
                    ret.append([text, None])
                else:
                    ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def copy(self) -> "VCoderConversation":
        return VCoderConversation(
            system=self.system,
            roles=self.roles,
            messages=[[x, y] for x, y in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [
                [x, _msg_text(y) if isinstance(y, tuple) else y] for x, y in self.messages
            ],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


def _as_pil(item):
    from PIL import Image
    import numpy as np

    if isinstance(item, np.ndarray):
        return Image.fromarray(item)
    return item


def _pil_expand2square(pil_img, background_color=BACKGROUND_COLOR):
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    result.paste(
        pil_img, ((side - width) // 2, (side - height) // 2)
    )
    return result


def _display_resize(image):
    """The reference's max-800/min-400 shrink for UI transport
    (vcoder_conversation.py:128-139)."""
    max_hw, min_hw = max(image.size), min(image.size)
    aspect_ratio = max_hw / min_hw
    max_len, min_len = 800, 400
    shortest_edge = int(min(max_len / aspect_ratio, min_len, min_hw))
    longest_edge = int(shortest_edge * aspect_ratio)
    W, H = image.size
    if longest_edge != max(image.size):
        if H > W:
            H, W = longest_edge, shortest_edge
        else:
            H, W = shortest_edge, longest_edge
        image = image.resize((W, H))
    return image


def _b64_png(image) -> str:
    """A PIL image (saved by PIL) or a numpy ``uint8`` array (encoded by the
    port's ``png.encode_png``, so no PIL is needed) -> base64 PNG."""
    import base64
    from io import BytesIO

    import numpy as np

    if isinstance(image, np.ndarray):
        from vcoder_tpu_torch.png import encode_png

        return base64.b64encode(encode_png(image)).decode()
    buf = BytesIO()
    image.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _b64_jpeg(image) -> str:
    import base64
    from io import BytesIO

    buf = BytesIO()
    image.convert("RGB").save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


conv_vicuna_v1 = VCoderConversation(
    system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1 = VCoderConversation(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_plain = VCoderConversation(
    system="",
    roles=("", ""),
    version="plain",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="\n",
)

default_conversation = conv_vicuna_v1
conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_v1": conv_llava_v1,
    "plain": conv_llava_plain,
}

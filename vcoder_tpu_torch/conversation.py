"""Conversation state and prompt templating.

A copy of the prompt side of ``vcoder_tpu/conversation.py`` for the PyTorch
port, which imports nothing of ``vcoder_tpu``; keep the two in step. Message
entries are ``[role, message]`` where a message is a string or the reference's
7-tuple ``(text, image, image_mode, seg, seg_mode, depth, depth_mode)``, and
prompts render per :class:`SeparatorStyle` (reference:
vcoder_llava/vcoder_conversation.py). The picture getters and the gradio
rendering of the JAX module (PIL work for the UI) wait for the surfaces
slice.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Any, List, Optional, Tuple


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

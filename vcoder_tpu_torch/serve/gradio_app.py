"""Gradio web demo.

A port of ``vcoder_tpu/serve/gradio_app.py``. It mirrors the reference
app's behavior (reference: vcoder_llava/serve/gradio_app.py): RGB/seg/depth
upload boxes with per-input process-mode radios, sentinel injection on
submit, streaming responses from the in-process
:class:`vcoder_tpu_torch.serve.chat.Chat`, and vote/flag logging to JSON.

gradio is an optional dependency; the module raises a clear error at launch
when it is unavailable. The example rows read the repo's demo pictures as
data (``vcoder_tpu/serve/examples/``); nothing of ``vcoder_tpu`` is
imported. The model runs on ``--device`` (CUDA unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

from vcoder_tpu_torch.constants import (
    DEFAULT_DEPTH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_SEG_TOKEN,
    LOGDIR,
)
from vcoder_tpu_torch.conversation import SeparatorStyle, conv_templates
from vcoder_tpu_torch.utils import build_logger, server_error_msg, violates_moderation

logger = None
chat = None

no_change_btn = enable_btn = disable_btn = None

PROCESS_MODES = ["Crop", "Resize", "Pad", "Default"]

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "vcoder_tpu", "serve", "examples",
)


def _require_gradio():
    try:
        import gradio as gr

        return gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; install gradio to"
            " run the web demo (python -m vcoder_tpu_torch.serve.cli provides the"
            " terminal UI)."
        ) from e


def get_conv_log_filename():
    t = datetime.datetime.now()
    return os.path.join(
        LOGDIR, f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json"
    )


def vote_last_response(state, vote_type, request=None):
    with open(get_conv_log_filename(), "a") as fout:
        data = {
            "tstamp": round(time.time(), 4),
            "type": vote_type,
            "state": state.dict(),
        }
        fout.write(json.dumps(data) + "\n")


def add_text(
    state, text, image, image_mode, seg, seg_mode, depth, depth_mode,
    moderate=False,
):
    """Inject sentinels and append the user message (reference:
    gradio_app.py:91-122)."""
    gr = _require_gradio()
    if len(text) <= 0 and image is None:
        state.skip_next = True
        return (state, state.to_gradio_chatbot(), "") + (None,) * 3

    if moderate and violates_moderation(text):
        state.skip_next = True
        return (state, state.to_gradio_chatbot(), "moderation") + (None,) * 3

    text = text[:1536]  # hard cut-off
    if image is not None:
        text = text[:1200]
        if DEFAULT_IMAGE_TOKEN not in text:
            text = DEFAULT_IMAGE_TOKEN + "\n" + text
        if seg is not None and DEFAULT_SEG_TOKEN not in text:
            text = DEFAULT_SEG_TOKEN + "\n" + text
            if depth is not None and DEFAULT_DEPTH_TOKEN not in text:
                text = DEFAULT_DEPTH_TOKEN + "\n" + text
        text = (
            text, image, image_mode, seg, seg_mode, depth, depth_mode,
        )
        if len(state.get_images(return_pil=True)) > 0:
            state = conv_templates["llava_v1"].copy()
    state.append_message(state.roles[0], text)
    state.append_message(state.roles[1], None)
    state.skip_next = False
    return (state, state.to_gradio_chatbot(), "") + (None,) * 3


def http_bot(state, temperature, top_p, max_new_tokens):
    """Stream the reply from the in-process Chat (reference:
    gradio_app.py:124-192)."""
    if state.skip_next:
        yield (state, state.to_gradio_chatbot())
        return

    prompt = state.get_prompt()
    all_images = state.get_images()
    all_segs = state.get_segs()
    all_depths = state.get_depths()

    stop_str = (
        state.sep
        if state.sep_style in (SeparatorStyle.SINGLE, SeparatorStyle.MPT)
        else state.sep2
    )
    pload = {
        "prompt": prompt,
        "temperature": float(temperature),
        "top_p": float(top_p),
        "max_new_tokens": min(int(max_new_tokens), 1536),
        "stop": stop_str,
        "images": all_images,
        "segs": all_segs,
        "depths": all_depths,
    }

    state.messages[-1][-1] = "▌"
    yield (state, state.to_gradio_chatbot())

    try:
        for chunk in chat.generate_stream_gate(pload):
            if not chunk:
                continue
            data = json.loads(chunk.decode().rstrip("\0"))
            if data["error_code"] == 0:
                output = data["text"][len(prompt):].strip()
                state.messages[-1][-1] = output + "▌"
            else:
                output = data["text"]
                state.messages[-1][-1] = output
            yield (state, state.to_gradio_chatbot())
    except Exception:
        state.messages[-1][-1] = server_error_msg
        yield (state, state.to_gradio_chatbot())
        return

    state.messages[-1][-1] = state.messages[-1][-1].rstrip("▌")
    yield (state, state.to_gradio_chatbot())


def build_demo():
    gr = _require_gradio()

    with gr.Blocks(title="VCoder") as demo:
        state = gr.State(conv_templates["llava_v1"].copy())

        gr.Markdown("# VCoder: Versatile Vision Encoders")
        with gr.Row():
            with gr.Column(scale=3):
                imagebox = gr.Image(type="pil", label="Image")
                image_mode = gr.Radio(
                    PROCESS_MODES, value="Pad", label="Image preprocess"
                )
                segbox = gr.Image(type="pil", label="Segmentation map")
                seg_mode = gr.Radio(
                    PROCESS_MODES, value="Pad", label="Seg preprocess"
                )
                depthbox = gr.Image(type="pil", label="Depth map")
                depth_mode = gr.Radio(
                    PROCESS_MODES, value="Pad", label="Depth preprocess"
                )
                temperature = gr.Slider(0.0, 1.0, value=0.2, step=0.1,
                                        label="Temperature")
                top_p = gr.Slider(0.0, 1.0, value=0.7, step=0.1,
                                  label="Top P")
                max_output_tokens = gr.Slider(0, 1024, value=512, step=64,
                                              label="Max output tokens")
            with gr.Column(scale=8):
                chatbot = gr.Chatbot(label="VCoder Chatbot", height=550)
                textbox = gr.Textbox(
                    show_label=False,
                    placeholder="Enter text and press ENTER",
                )
                with gr.Row():
                    upvote_btn = gr.Button(value="👍 Upvote")
                    downvote_btn = gr.Button(value="👎 Downvote")
                    flag_btn = gr.Button(value="⚠️ Flag")
                    clear_btn = gr.Button(value="🗑️ Clear")

        # Demo example rows (reference: gradio_app.py:279-286; the
        # reference's demo images, kept once in the repo as data).
        ex = EXAMPLES_DIR
        count_q = "What objects can be seen in the image?"
        depth_q = (
            "Can you describe the depth order of the objects in this"
            " image, from closest to farthest?"
        )
        gr.Examples(
            examples=[
                [f"{ex}/people.jpg", f"{ex}/people_pan.png", None,
                 count_q, 0.9, 1.0],
                [f"{ex}/corgi.jpg", f"{ex}/corgi_pan.png", None,
                 count_q, 0.6, 0.7],
                [f"{ex}/suits.jpg", f"{ex}/suits_pan.png",
                 f"{ex}/suits_depth.jpeg", depth_q, 0.2, 0.5],
                [f"{ex}/depth.jpeg", f"{ex}/depth_pan.png",
                 f"{ex}/depth_depth.png", depth_q, 0.2, 0.5],
                [f"{ex}/friends.jpg", f"{ex}/friends_pan.png", None,
                 "What is happening in the image?", 0.8, 0.9],
                [f"{ex}/suits.jpg", f"{ex}/suits_pan.png", None,
                 count_q, 0.5, 0.5],
            ],
            inputs=[imagebox, segbox, depthbox, textbox, temperature,
                    top_p],
        )

        btn_list = [upvote_btn, downvote_btn, flag_btn]
        upvote_btn.click(
            lambda s: vote_last_response(s, "upvote"), [state], []
        )
        downvote_btn.click(
            lambda s: vote_last_response(s, "downvote"), [state], []
        )
        flag_btn.click(lambda s: vote_last_response(s, "flag"), [state], [])
        clear_btn.click(
            lambda: (conv_templates["llava_v1"].copy(), [], ""),
            [],
            [state, chatbot, textbox],
        )
        textbox.submit(
            add_text,
            [state, textbox, imagebox, image_mode, segbox, seg_mode,
             depthbox, depth_mode],
            [state, chatbot, textbox, imagebox, segbox, depthbox],
        ).then(
            http_bot,
            [state, temperature, top_p, max_output_tokens],
            [state, chatbot],
        )
    return demo


def main():
    global chat, logger
    from vcoder_tpu_torch.serve.chat import Chat

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument(
        "--model-path", type=str, default="shi-labs/vcoder_ds_llava-v1.5-7b"
    )
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--concurrency-count", type=int, default=10)
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--moderate", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()

    logger = build_logger("gradio_web_server", "gradio_web_server.log")
    chat = Chat(
        args.model_path,
        model_base=args.model_base,
        load_8bit=args.load_8bit,
        load_4bit=args.load_4bit,
        device=args.device,
    )
    demo = build_demo()
    demo.queue(max_size=10).launch(
        server_name=args.host, server_port=args.port, share=args.share
    )


if __name__ == "__main__":
    main()

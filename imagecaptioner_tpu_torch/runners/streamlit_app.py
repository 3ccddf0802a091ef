"""Teacher-vs-student demo of the port (the twin of the root
``streamlit_app.py``).

As in the JAX package's demo:
  * the demo "student" is the teacher reused with temperature sampling
    unless ``--student-checkpoint`` (or ``IC_DEMO_STUDENT``) names a real
    distilled student, rebuilt from its checkpoint's ``model_type``; the
    student column samples at temperature 1.1;
  * temperature 1.0 gives the teacher's beam-search caption and the
    student's greedy one; any other temperature samples;
  * the vocabulary comes from the saved ``vocab.json``.

Without streamlit, ``demo_caption_image`` gives the same captions
programmatically, and the one-shot CLI prints them:

  python -m imagecaptioner_tpu_torch.runners.streamlit_app IMAGE \\
      [--student-checkpoint PATH] [--device cuda|cpu]

A binary PPM is read and resized with numpy (bit for bit as PIL), so the
CLI runs on a machine without PIL; other formats, and the streamlit UI's
uploads, go through PIL.  Runs on ``--device`` (default ``cuda``): without
a card it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.dataset import (decode_image_file,
                                                   resize_bilinear)
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary
from imagecaptioner_tpu_torch.eval.serve import load_student
from imagecaptioner_tpu_torch.models import teacher as TM
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.ops import decode as D

DEFAULT_CKPT = "saved_models/best_teacher_model.npz"
DEFAULT_VOCAB = "saved_models/vocab.json"


def load_models_and_vocab(checkpoint_path: str = DEFAULT_CKPT,
                          vocab_path: str = DEFAULT_VOCAB,
                          student_checkpoint: Optional[str] = None,
                          device="cuda"):
    """``(teacher, student, vocab)``, each model a ``(module in eval mode,
    cfg)`` pair in float32 on ``device``.  Without ``student_checkpoint``
    (or ``IC_DEMO_STUDENT``) the student is the teacher, as in the
    reference demo."""
    device = resolve_device(device)
    vocab = Vocabulary.load(vocab_path)
    teacher = TM.load_teacher(checkpoint_path, device)
    student_checkpoint = student_checkpoint or os.environ.get(
        "IC_DEMO_STUDENT") or None
    student = (load_student(student_checkpoint, device)
               if student_checkpoint else teacher)
    return teacher, student, vocab


def preprocess_image(img, image_size: int = 224, device="cpu"
                     ) -> torch.Tensor:
    """A PIL image or a uint8 (H, W, 3) array -> normalized float32 (1, 3,
    S, S) on ``device``, resized bilinearly as PIL resizes."""
    if isinstance(img, np.ndarray):
        arr = resize_bilinear(img, image_size, image_size)
    else:
        from PIL import Image

        arr = np.asarray(img.convert("RGB").resize(
            (image_size, image_size), Image.BILINEAR), np.uint8)
    return T.normalize(torch.from_numpy(np.array(arr, np.uint8))[None]
                       .to(device))


@torch.inference_mode()
def generate_caption_with_temperature(model, image_nchw: torch.Tensor,
                                      vocab: Vocabulary, *,
                                      temperature: float = 1.0,
                                      max_length: int = 25,
                                      seed: int = 0) -> str:
    """One image's caption.  The teacher: beam search at temperature 1.0,
    multinomial sampling otherwise.  A real student: its greedy decode at
    1.0 (the student has no beam search), sampling otherwise."""
    module, cfg = model
    dev = image_nchw.device
    rng = (None if temperature == 1.0
           else torch.Generator(device=dev).manual_seed(seed))
    if isinstance(module, Student):
        _, refined = module.encode_image(image_nchw)
        toks = D.best_greedy_decode_student(
            module, refined, cfg, max_length=max_length,
            temperature=temperature, rng=rng)
        return D.tokens_to_caption(toks[0].cpu().numpy(), vocab)
    memory = module.encode_image(image_nchw)
    if temperature == 1.0:
        seqs, scores, _ = D.beam_search_teacher(module, memory,
                                                max_length=max_length)
        outs = D.beam_result_to_captions(seqs.cpu(), scores.cpu(), vocab, 1)
        return outs[0] if outs else ""
    toks = D.greedy_decode_teacher(module, memory, max_length=max_length,
                                   temperature=temperature, sample=True,
                                   rng=rng)
    return D.tokens_to_caption(toks[0].cpu().numpy(), vocab)


def demo_caption_image(image_path: str, *, checkpoint_path: str = DEFAULT_CKPT,
                       vocab_path: str = DEFAULT_VOCAB, seed: int = 0,
                       student_checkpoint: Optional[str] = None,
                       device="cuda") -> dict:
    """``{"teacher": beam caption, "student": caption at temperature
    1.1}`` of one image file."""
    teacher, student, vocab = load_models_and_vocab(
        checkpoint_path, vocab_path, student_checkpoint=student_checkpoint,
        device=device)
    size = teacher[1].image_size
    image = preprocess_image(decode_image_file(image_path, size), size,
                             device=next(teacher[0].parameters()).device)
    return {
        "teacher": generate_caption_with_temperature(
            teacher, image, vocab, temperature=1.0),
        "student": generate_caption_with_temperature(
            student, image, vocab, temperature=1.1, seed=seed),
    }


# ---------------------------------------------------------------------------
# Streamlit UI: three columns and the session-state machine
# ---------------------------------------------------------------------------


_SESSION_KEYS = ("generate_both", "student_done", "teacher_done",
                 "teacher_generating", "student_caption_result",
                 "teacher_caption_result")


def _model_info_lines(name: str, model) -> List[str]:
    module, cfg = model
    if name == "teacher":
        return ["**Architecture:** Vision Transformer",
                f"**Parameters:** ~{TM.count_parameters(module) / 1e6:.0f}M",
                "**Encoder:** ViT-Small",
                "**Decoder:** 4-layer Transformer"]
    if isinstance(module, Student):
        enc = {"full": "ResNet-50", "compact": "MobileNetV2",
               "enhanced": "EfficientNet-B3"}[cfg.variant]
        return [f"**Architecture:** CNN-LSTM ({cfg.variant} student)",
                f"**Parameters:** ~{TM.count_parameters(module) / 1e6:.1f}M",
                f"**Encoder:** {enc}",
                f"**Decoder:** {cfg.num_layers}-layer LSTM"]
    return ["**Architecture:** CNN-LSTM (demo: teacher @ T=1.1)",
            "**Parameters:** ~8M (3x smaller)",
            "**Encoder:** ResNet-50",
            "**Decoder:** 2-layer LSTM",
            "**Speed:** ~2-3x faster"]


def streamlit_main(device="cuda"):
    """The three-column session-state machine: generate_both /
    teacher_done / student_done, a spinner and ``st.rerun`` per column, the
    caption with its word count and a Model Info expander, and a Clear
    button that resets the state."""
    import streamlit as st

    st.set_page_config(
        page_title="Image Caption Generator - Teacher vs Student",
        page_icon="📸", layout="wide")
    st.title("📸 Image Caption Generator - Teacher vs Student Models")
    st.markdown("Upload an image and compare captions from both the Teacher "
                "(ViT-Transformer) and Student (CNN-LSTM) models!")

    @st.cache_resource
    def _load():
        try:
            # module globals read at call time (tests repoint them)
            return load_models_and_vocab(DEFAULT_CKPT, DEFAULT_VOCAB,
                                         device=device)
        except Exception:
            return None, None, None

    with st.spinner("Loading AI models..."):
        teacher, student, vocab = _load()
    if teacher is None and student is None:
        st.error("Failed to load any models. Please check if the model "
                 "files exist.")
        st.info("Make sure you have:")
        st.code(f"- {DEFAULT_CKPT}\n- {DEFAULT_VOCAB}")
        return
    dev = next(teacher[0].parameters()).device
    st.success(f"✅ Models loaded successfully! Running on: {dev.type}")

    col1, col2, col3 = st.columns([1, 1, 1])

    with col1:
        st.header("📷 Upload Image")
        uploaded = st.file_uploader(
            "Choose an image...", type=["jpg", "jpeg", "png", "bmp", "tiff"],
            help="Upload an image file (JPG, PNG, etc.)")
        if uploaded is not None:
            from PIL import Image

            pil_img = Image.open(uploaded)
            st.image(pil_img, caption="Uploaded Image",
                     use_container_width=True)
            st.info(f"📊 Size: {pil_img.size[0]} x {pil_img.size[1]} px")
            if st.button("🔮 Generate Captions", type="primary",
                         use_container_width=True):
                st.session_state.generate_both = True
                st.session_state.student_done = False
                st.session_state.teacher_done = False
                st.rerun()

    def render_model_column(name: str, model, temperature: float):
        """One column: generate when pending, replay the cached result when
        done, a hint otherwise."""
        done_key, result_key = f"{name}_done", f"{name}_caption_result"
        pending = (uploaded is not None
                   and st.session_state.get("generate_both", False)
                   and not st.session_state.get(done_key, False))

        def show(caption: str):
            st.success("✅ Caption Generated!")
            st.markdown("### 💬 Caption:")
            st.markdown(f'*"{caption}"*')
            st.info(f"📝 Words: {len(caption.split())}")
            with st.expander("📊 Model Info"):
                for line in _model_info_lines(name, model):
                    st.write(line)

        if pending:
            generated = False
            with st.spinner(f"{name.title()} generating..."):
                try:
                    image = preprocess_image(pil_img, model[1].image_size,
                                             device=dev)
                    caption = generate_caption_with_temperature(
                        model, image, vocab, temperature=temperature,
                        max_length=25)
                    if caption.strip():
                        show(caption)
                        st.session_state[result_key] = caption
                        generated = True
                    else:
                        st.warning("empty caption")
                    st.session_state[done_key] = True
                except Exception as e:
                    st.error(f"{name.title()} error: {e}")
                    st.session_state[done_key] = True
            if generated:
                # outside the try: st.rerun raises a control-flow exception
                # that the error handler must not swallow
                st.rerun()
        elif uploaded is not None and st.session_state.get(done_key, False):
            if result_key in st.session_state:
                show(st.session_state[result_key])
        elif st.session_state.get("generate_both", False):
            st.info(f"⏳ {name.title()} generating...")
        else:
            st.info("👈 Upload image and click generate")

    with col2:
        st.header("🎓 Teacher Model")
        st.markdown("**ViT-Transformer** "
                    f"(~{TM.count_parameters(teacher[0]) / 1e6:.0f}M params)")
        render_model_column("teacher", teacher, 1.0)

    with col3:
        st.header("🎒 Student Model")
        render_model_column("student", student, 1.1)

    if uploaded is not None:
        if st.button("🗑️ Clear Image"):
            for key in _SESSION_KEYS:
                st.session_state.pop(key, None)
            st.rerun()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Teacher-vs-student demo")
    ap.add_argument("image", nargs="?", default=None,
                    help="caption this image file and exit")
    ap.add_argument("--student-checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.image and os.path.exists(args.image):
        out = demo_caption_image(args.image, checkpoint_path=DEFAULT_CKPT,
                                 vocab_path=DEFAULT_VOCAB,
                                 student_checkpoint=args.student_checkpoint,
                                 device=args.device)
        print(f"Teacher (beam):        {out['teacher']}")
        print(f"Student (T=1.1 sample): {out['student']}")
        return 0
    try:
        streamlit_main(args.device)
    except ImportError:
        print("streamlit is not installed. Either install it and run\n"
              "  python -m imagecaptioner_tpu_torch.runners.run_app\n"
              "or pass an image path for a one-shot CLI demo:\n"
              "  python -m imagecaptioner_tpu_torch.runners.streamlit_app "
              "path/to/image.ppm")
        return 1
    return 0


if __name__ == "__main__":
    code = main()
    if code:
        sys.exit(code)

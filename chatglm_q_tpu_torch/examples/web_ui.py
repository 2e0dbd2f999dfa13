"""Streamlit chat UI over a checkpoint: the port's examples/web-ui.py.

    streamlit run chatglm_q_tpu_torch/examples/web_ui.py -- --model ../models/chatglm2-6b-int4g32

``streamlit`` is an optional dependency, not installed with the port:
without it ``main`` raises an ImportError that names it (``python -m
chatglm_q_tpu_torch.examples.cli_chat`` is the dependency-free chat).
"""
from __future__ import annotations

import argparse


def require_streamlit():
    """The ``streamlit`` module, or an ImportError naming the package."""
    try:
        import streamlit
    except ImportError as e:
        raise ImportError("web_ui needs the 'streamlit' package, which is not installed; "
                          "python -m chatglm_q_tpu_torch.examples.cli_chat is the terminal "
                          "chat") from e
    return streamlit


def main(argv=None) -> None:
    st = require_streamlit()
    from chatglm_q_tpu_torch.serving import GLMDecoder
    from chatglm_q_tpu_torch.serving.chat import chat_template

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="../models/chatglm2-6b-int4g32")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)
    st.set_page_config(page_title="ChatGLM2 (CUDA)", layout="wide")

    @st.cache_resource
    def load_decoder(model, device):
        return GLMDecoder.from_pretrained(model, device=device)

    decoder = load_decoder(args.model, args.device)
    with st.sidebar:
        st.title("Sampling")
        max_tokens = st.slider("max_tokens", 16, 2048, 400)
        temperature = st.slider("temperature", 0.0, 2.0, 1.0)
        top_p = st.slider("top_p", 0.1, 1.0, 0.8)
        top_k = st.slider("top_k", 1, 200, 100)
        if st.button("Clear history"):
            st.session_state.history = []
    if "history" not in st.session_state:
        st.session_state.history = []
    for role, text in st.session_state.history:
        with st.chat_message(role):
            st.write(text)
    if prompt := st.chat_input("说点什么…"):
        st.session_state.history.append(("user", prompt))
        with st.chat_message("user"):
            st.write(prompt)
        pairs = [(st.session_state.history[i][1], st.session_state.history[i + 1][1])
                 for i in range(0, len(st.session_state.history) - 1, 2)]
        with st.chat_message("assistant"):
            box, final = st.empty(), ""
            for partial in decoder.generate(chat_template(pairs, prompt),
                                            max_generated_tokens=max_tokens, top_k=top_k,
                                            top_p=top_p, temperature=temperature):
                final = partial
                box.write(partial)
        st.session_state.history.append(("assistant", final))


if __name__ == "__main__":
    main()

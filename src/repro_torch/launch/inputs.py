"""Shape constants of the modality stubs (copied from
``repro.launch.inputs``; the rest of that module, the dry-run's cell
planning, is not ported).

Whisper's conv frontend and Qwen2-VL's vision frontend are stubs: the
model takes precomputed frame embeddings and vision patch embeddings.  In
the reference's cells the post-conv frames take ``seq // STUB_DIV``
positions beside a ``WHISPER_DEC_LEN``-token decoder prompt, and the
vision block the first ``seq // STUB_DIV`` positions of the prompt.
The port's serving cells give Whisper a whole padded clip instead,
``WHISPER_FRAMES`` (not in the reference).
"""

#: Whisper's decoder text context (tokens)
WHISPER_DEC_LEN = 448

#: Whisper's encoder frames: every clip is padded to 30 s, 1500 frames
#: after the conv frontend
WHISPER_FRAMES = 1500

#: the encoder frames (Whisper) and the vision block (Qwen2-VL) take
#: ``seq // STUB_DIV`` positions
STUB_DIV = 4

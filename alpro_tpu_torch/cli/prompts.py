"""Prompt templates of the PEM/MPM entity prompter (the port's copy of
``alpro_tpu/cli/prompts.py``): 12 video and 12 image templates, filled with
each entity of the entity list."""

VIDEO_TEMPLATES = [
    "A footage of a {}.",
    "A footage of the {}.",
    "A footage of one {}.",
    "A video of a {}.",
    "A video of the {}.",
    "A video of one {}.",
    "A portrait of a {}.",
    "A portrait of the {}.",
    "A portrait of one {}.",
    "A video footage of a {}.",
    "A video footage of the {}.",
    "A video footage of one {}.",
]

IMAGE_TEMPLATES = [
    "A photo of a {}.",
    "A photo of the {}.",
    "A photo of one {}.",
    "A picture of a {}.",
    "A picture of the {}.",
    "A picture of one {}.",
    "A good photo of the {}.",
    "A good photo of a {}.",
    "A good photo of one {}.",
    "A good picture of the {}.",
    "A good picture of a {}.",
    "A good picture of one {}.",
]


def load_entities(path: str, num_entities: int):
    """The first word of each of the first ``num_entities`` non-empty lines
    of the entity file (``unigrams.txt``)."""
    with open(path) as f:
        ents = [line.strip().split()[0] for line in f if line.strip()]
    return ents[:num_entities]


def build_prompt_strings(entities, templates):
    """Template-major: template t fills rows [t·E, (t+1)·E), the layout the
    prompt bank averages over."""
    return [t.format(e) for t in templates for e in entities]

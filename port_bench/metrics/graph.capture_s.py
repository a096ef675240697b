"""Host seconds that the program spent capturing its CUDA graphs: the
seconds of `core/graph.Graph._capture` (warm-up runs included), summed
over the process's captures by the program's recorder; all of them fall
in set-up."""

from port_bench import spans


def read(layers):
    if layers.get('loop') not in ('train', 'single'):
        return None
    return spans.capture_s()

from aegis_tpu_torch.viz.piano_roll import (  # noqa: F401
    events_to_svg,
    midi_to_svg,
    render_piano_roll,
    html_midi_player_embed,
    tonejs_canvas_embed,
    webaudiofont_embed,
)

"""Intelligence dashboard — trending-scan metrics UI.

Covers the reference's aegis_intelligence_dashboard.py (SURVEY.md §2.5 #35):
a yt-dlp trending scan feeding metric cards, a genre-interest table and an
activity heatmap.  The reference fills its metrics/heatmap with *simulated*
values (aegis_intelligence_dashboard.py:107-159); this version does the same
— deterministically seeded so the dashboard is reproducible — and swaps in
real scan counts whenever yt-dlp is available.

UI only; scanning goes through ``aegis_tpu_torch.tools.collectors.BatchCollector``.
"""

from __future__ import annotations

import numpy as np

from aegis_tpu_torch.apps.common import require_streamlit
from aegis_tpu_torch.tools.collectors import BatchCollector, have_ytdlp

GENRES = ["rock", "blues", "metal", "jazz", "funk", "acoustic"]


def _simulated_trends(seed: int = 20260816):
    """Deterministic stand-in metrics (the reference simulates these too)."""
    rng = np.random.default_rng(seed)
    interest = {g: int(v) for g, v in
                zip(GENRES, rng.integers(40, 100, len(GENRES)))}
    heat = rng.random((7, 24)) * np.linspace(0.4, 1.0, 24)[None, :]
    return interest, heat


def main() -> None:
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Intelligence", layout="wide")
    st.title("🧠 Aegis TPU — Intelligence Dashboard")

    query = st.sidebar.text_input("Scan query", "guitar solo")
    limit = st.sidebar.slider("Scan size", 5, 50, 15)
    run = st.sidebar.button("🔍 Scan trends")

    results = []
    if run:
        if have_ytdlp():
            with st.status("Scanning…"):
                results = BatchCollector().search(query, limit)
        else:
            st.sidebar.warning("yt-dlp missing — showing simulated data only")

    interest, heat = _simulated_trends()
    cols = st.columns(4)
    cols[0].metric("Tracked genres", len(GENRES))
    cols[1].metric("Scan results", len(results))
    durations = [r["duration"] for r in results if r["duration"]]
    cols[2].metric("Avg duration",
                   f"{int(np.mean(durations))}s" if durations else "–")
    cols[3].metric("Interest peak", max(interest, key=interest.get))

    left, right = st.columns(2)
    with left:
        st.subheader("Genre interest")
        st.bar_chart(interest)
    with right:
        st.subheader("Activity heatmap (day × hour)")
        try:
            import pandas as pd

            st.dataframe(
                pd.DataFrame(
                    np.round(heat, 2),
                    index=["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"],
                    columns=[f"{h:02d}" for h in range(24)],
                ).style.background_gradient(axis=None),
                height=290,
            )
        except ImportError:
            st.write(np.round(heat, 2))

    if results:
        st.subheader("Scan results")
        for item in results:
            dur = (f"{item['duration'] // 60}:{item['duration'] % 60:02d}"
                   if item["duration"] else "–")
            st.write(f"· **{item['title']}** — {dur}")


if __name__ == "__main__":
    main()

"""Collector studio — the Streamlit collector-family UI.

One app, four modes, covering the reference's collector UIs (SURVEY.md §2.5):

  * "Search & Bake"  — metadata search + result card grid + bulk MP3 bake
                       (aegis_master_system.py:263-292).
  * "Artist folders" — password-gated per-artist folder collection with
                       normalized-title dedup (folder_audio_collector.py).
  * "Mega batch"     — multi-query batch with keyword blocklist + stats
                       (artist_mega_collector/app_mega_collector.py).
  * "Mobile"         — compact layout producing a ZIP download
                       (secure_mobile_collector/app.py:137-153).

All download logic lives in ``aegis_tpu_torch.tools.collectors`` (BatchCollector);
this module is UI only.  yt-dlp is optional — every mode degrades to a
clear "collector disabled" notice when it is absent.
"""

from __future__ import annotations

import os
import tempfile

from aegis_tpu_torch.apps.common import require_streamlit
from aegis_tpu_torch.tools.collectors import (BatchCollector, CollectorConfig,
                                              have_ytdlp, package_zip)

# The reference gates its folder/mobile collectors behind a hardcoded
# password (folder_audio_collector.py:14-30).  Keep the gate, but read the
# secret from the environment instead of the source.
GATE_ENV = "AEGIS_COLLECTOR_PASSWORD"


def _gate(st) -> bool:
    secret = os.environ.get(GATE_ENV)
    if not secret:
        st.info(f"Set ${GATE_ENV} to enable the password gate (open access).")
        return True
    if st.session_state.get("gate_ok"):
        return True
    pw = st.text_input("Access password", type="password")
    if pw and pw == secret:
        st.session_state["gate_ok"] = True
        st.rerun()
    elif pw:
        st.error("Wrong password")
    return False


def _ui_collector(st, config: CollectorConfig) -> BatchCollector:
    """BatchCollector with progress surfaced in the UI (the reference's
    Streamlit subclass pattern, app_mega_collector.py:30-137)."""

    class UICollector(BatchCollector):
        def on_progress(self, message: str) -> None:
            st.write(message)

        def on_item_done(self, path: str) -> None:
            st.toast(os.path.basename(path))

    return UICollector(config)


def _stats_cards(st, stats) -> None:
    cols = st.columns(4)
    cols[0].metric("Downloaded", stats.downloaded)
    cols[1].metric("Duplicates skipped", stats.skipped_duplicate)
    cols[2].metric("Blocklist skipped", stats.skipped_blocklist)
    cols[3].metric("Failed", stats.failed)


def _mode_search_bake(st, out_dir: str) -> None:
    query = st.text_input("Search query", placeholder="guitar solo tabs")
    limit = st.slider("Results", 3, 30, 10)
    if not query:
        return
    collector = _ui_collector(st, CollectorConfig(output_dir=out_dir))
    results = collector.search(query, limit)
    if not results:
        st.warning("No results (yt-dlp missing or search failed)")
        return
    picked = []
    for i, item in enumerate(results):
        cols = st.columns([5, 1, 1])
        cols[0].write(f"**{item['title']}**")
        cols[1].write(f"{item['duration'] // 60}:{item['duration'] % 60:02d}"
                      if item["duration"] else "–")
        if cols[2].checkbox("bake", key=f"bake{i}"):
            picked.append(item)
    if picked and st.button(f"🔥 Bake {len(picked)} MP3s"):
        with st.status("Baking…"):
            for item in picked:
                collector.download(item["url"])
        _stats_cards(st, collector.stats)


def _mode_artist_folders(st, out_dir: str) -> None:
    if not _gate(st):
        return
    artist = st.text_input("Artist")
    queries = st.text_area("Queries (one per line)",
                           placeholder="artist song 1\nartist song 2")
    per_query = st.slider("Downloads per query", 1, 10, 3)
    if artist and queries and st.button("Collect into artist folder"):
        collector = _ui_collector(st, CollectorConfig(output_dir=out_dir))
        with st.status(f"Collecting {artist}…"):
            stats = collector.collect(
                [q for q in queries.splitlines() if q.strip()],
                limit_per_query=per_query, artist=artist)
        _stats_cards(st, stats)


def _mode_mega_batch(st, out_dir: str) -> None:
    queries = st.text_area("Batch queries (one per line)")
    blocklist = st.text_input("Extra blocklist words (comma separated)", "")
    per_query = st.slider("Limit per query", 1, 20, 5)
    if queries and st.button("🚀 Run mega batch"):
        config = CollectorConfig(output_dir=out_dir)
        config.blocklist = config.blocklist + [
            w.strip().lower() for w in blocklist.split(",") if w.strip()]
        collector = _ui_collector(st, config)
        with st.status("Mega batch running…"):
            stats = collector.collect(
                [q for q in queries.splitlines() if q.strip()],
                limit_per_query=per_query)
        _stats_cards(st, stats)
        st.json(stats.as_dict())


def _mode_mobile(st, out_dir: str) -> None:
    if not _gate(st):
        return
    st.caption("Compact flow: one query → collect → ZIP download")
    query = st.text_input("Query")
    if query and st.button("Collect"):
        collector = _ui_collector(st, CollectorConfig(output_dir=out_dir))
        with st.status("Collecting…"):
            collector.collect([query], limit_per_query=3)
        _stats_cards(st, collector.stats)
    if os.path.isdir(out_dir) and any(os.scandir(out_dir)):
        zip_path = os.path.join(tempfile.gettempdir(), "aegis_collection.zip")
        package_zip(out_dir, zip_path)
        with open(zip_path, "rb") as f:
            st.download_button("⬇ Download collection ZIP", f.read(),
                               "aegis_collection.zip", "application/zip")


def main() -> None:
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Collector Studio", layout="wide")
    st.title("📡 Aegis TPU — Collector Studio")
    if not have_ytdlp():
        st.warning("yt-dlp is not installed — search/download disabled. "
                   "The UI below still renders for configuration.")
    out_dir = st.sidebar.text_input("Output folder", "collected_audio")
    mode = st.sidebar.radio(
        "Mode", ["Search & Bake", "Artist folders", "Mega batch", "Mobile"])
    {"Search & Bake": _mode_search_bake,
     "Artist folders": _mode_artist_folders,
     "Mega batch": _mode_mega_batch,
     "Mobile": _mode_mobile}[mode](st, out_dir)


if __name__ == "__main__":
    main()

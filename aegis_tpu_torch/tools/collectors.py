"""Audio data collectors (yt-dlp based side rail, SURVEY.md §2.5).  A copy
of ``aegis_tpu/tools/collectors.py`` (no JAX in it), held equal to it by
``tests/test_torch_side_tools.py``.

Covers the behaviors of the reference's collector family
(youtube_audio_extractor.py, terminal_collector.py, mega_batch_collector.py,
folder_audio_collector.py, secure_mobile_collector): search-or-URL download
to MP3, title normalization, duration filtering, normalized-title and
zero-byte dedup, keyword blocklists, per-artist folders, batch stats, and a
ZIP packaging helper.  yt-dlp is an optional dependency — everything gates
cleanly when it is absent (this framework's image has no network egress).
"""

from __future__ import annotations

import os
import re
import unicodedata
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from aegis_tpu_torch.utils.logging import get_logger

log = get_logger("Collector")


def have_ytdlp() -> bool:
    try:
        import yt_dlp  # noqa: F401

        return True
    except ImportError:
        return False


def normalize_title(title: str) -> str:
    """Filesystem-safe, dedup-stable title key."""
    title = unicodedata.normalize("NFKC", title)
    title = re.sub(r"[\[\(].*?[\]\)]", "", title)  # strip (official video) etc.
    title = re.sub(r"[^\w\s-]", "", title).strip().lower()
    return re.sub(r"[\s_-]+", "_", title)[:120] or "untitled"


@dataclass
class CollectorConfig:
    output_dir: str = "collected_audio"
    audio_format: str = "mp3"
    bitrate: str = "320"
    min_duration: float = 30.0
    max_duration: float = 330.0
    blocklist: List[str] = field(
        default_factory=lambda: ["cover", "live", "reaction", "tutorial",
                                 "lesson", "karaoke"]
    )
    per_artist_folders: bool = True


@dataclass
class CollectorStats:
    searched: int = 0
    downloaded: int = 0
    skipped_duplicate: int = 0
    skipped_blocklist: int = 0
    skipped_duration: int = 0
    failed: int = 0

    def as_dict(self) -> Dict[str, int]:
        return self.__dict__.copy()


class BatchCollector:
    """Search → filter → download pipeline with dedup."""

    def __init__(self, config: Optional[CollectorConfig] = None):
        self.config = config or CollectorConfig()
        self.stats = CollectorStats()
        os.makedirs(self.config.output_dir, exist_ok=True)

    # hooks (the reference's Streamlit subclass overrides these,
    # app_mega_collector.py:30-137)
    def on_progress(self, message: str) -> None:
        log.info(message)

    def on_item_done(self, path: str) -> None:
        pass

    # ------------------------------------------------------------------ logic

    def _existing_keys(self, folder: str) -> set:
        keys = set()
        if os.path.isdir(folder):
            for name in os.listdir(folder):
                path = os.path.join(folder, name)
                # zero/near-zero files are re-downloaded, not deduped
                if os.path.getsize(path) > 1024:
                    keys.add(normalize_title(os.path.splitext(name)[0]))
        return keys

    def _blocked(self, title: str) -> bool:
        low = title.lower()
        return any(word in low for word in self.config.blocklist)

    def search(self, query: str, limit: int = 10) -> List[Dict]:
        """Metadata-only search; [] when yt-dlp is unavailable."""
        if not have_ytdlp():
            log.warning("yt-dlp not installed; collector disabled")
            return []
        import yt_dlp

        opts = {"quiet": True, "extract_flat": True, "skip_download": True}
        with yt_dlp.YoutubeDL(opts) as ydl:
            info = ydl.extract_info(f"ytsearch{limit}:{query}", download=False)
        self.stats.searched += len(info.get("entries", []))
        return [
            {"title": e.get("title", ""), "url": e.get("url", ""),
             "duration": e.get("duration") or 0}
            for e in info.get("entries", [])
        ]

    def download(self, url_or_query: str, artist: Optional[str] = None) -> Optional[str]:
        """Download one item as MP3 with the android-client 403 workaround the
        reference uses (youtube_audio_extractor.py:38-43)."""
        if not have_ytdlp():
            log.warning("yt-dlp not installed; collector disabled")
            return None
        import yt_dlp

        folder = self.config.output_dir
        if artist and self.config.per_artist_folders:
            folder = os.path.join(folder, normalize_title(artist))
        os.makedirs(folder, exist_ok=True)

        opts = {
            "quiet": True,
            "format": "bestaudio/best",
            "outtmpl": os.path.join(folder, "%(title)s.%(ext)s"),
            "postprocessors": [{
                "key": "FFmpegExtractAudio",
                "preferredcodec": self.config.audio_format,
                "preferredquality": self.config.bitrate,
            }],
            "extractor_args": {"youtube": {"player_client": ["android"]}},
        }
        target = (url_or_query if url_or_query.startswith("http")
                  else f"ytsearch1:{url_or_query}")
        try:
            with yt_dlp.YoutubeDL(opts) as ydl:
                info = ydl.extract_info(target, download=True)
            if "entries" in info:
                info = info["entries"][0]
            self.stats.downloaded += 1
            path = os.path.join(
                folder, f"{info['title']}.{self.config.audio_format}")
            self.on_item_done(path)
            return path
        except Exception as e:
            self.stats.failed += 1
            log.warning(f"download failed: {e}")
            return None

    def collect(self, queries: List[str], limit_per_query: int = 5,
                artist: Optional[str] = None) -> CollectorStats:
        """Multi-query batch with blocklist / duration / dedup filtering."""
        folder = self.config.output_dir
        if artist and self.config.per_artist_folders:
            folder = os.path.join(folder, normalize_title(artist))
        seen = self._existing_keys(folder)

        for query in queries:
            self.on_progress(f"searching: {query}")
            for item in self.search(query, limit_per_query):
                title = item["title"]
                if self._blocked(title):
                    self.stats.skipped_blocklist += 1
                    continue
                if not (self.config.min_duration <= item["duration"]
                        <= self.config.max_duration):
                    self.stats.skipped_duration += 1
                    continue
                key = normalize_title(title)
                if key in seen:
                    self.stats.skipped_duplicate += 1
                    continue
                seen.add(key)
                self.on_progress(f"downloading: {title}")
                self.download(item["url"], artist=artist)
        return self.stats


def package_zip(folder: str, zip_path: str) -> str:
    """Bundle a collection folder into a ZIP (the mobile collector's
    download flow, secure_mobile_collector/app.py:137-153)."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(folder):
            for name in files:
                full = os.path.join(root, name)
                zf.write(full, os.path.relpath(full, folder))
    return zip_path


def main() -> None:
    """CLI: python -m aegis_tpu_torch.tools.collectors "query or URL" [artist]"""
    import sys

    if len(sys.argv) < 2:
        print(main.__doc__)
        return
    collector = BatchCollector()
    path = collector.download(sys.argv[1],
                              artist=sys.argv[2] if len(sys.argv) > 2 else None)
    print(path or "download unavailable (yt-dlp missing or failed)")
    print(collector.stats.as_dict())


if __name__ == "__main__":
    main()

"""The web viewer: `server` (render-from-pose over HTTP) and `live` (the
viewer beside a running trainer)."""

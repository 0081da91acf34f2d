"""Host-side data handling (numpy and scipy): WAV I/O (``data.audio``)."""

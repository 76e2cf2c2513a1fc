"""Host-side data: the CSV contract, a columnar table reader, features
and the saved preprocessing artifacts."""

"""CSV column contract shared by train, serve, and the synthetic generator.

Mirrors the reference's data contract (reference train.py:274-295,
database_setup.py:23-64): a reviews CSV keyed by (guest_id, hotel_id) and a
friendships CSV of undirected (user_id_1, user_id_2) pairs.
"""

RAW_USER_COL = "guest_id"
RAW_ITEM_COL = "hotel_id"
USER_COL = "user_id"
ITEM_COL = "item_id"
TARGET_COL = "was_booked"

CATEGORICAL_COLS = ("city", "hotel_type")

# Raw numerical columns present in the CSV.
RAW_NUMERICAL_COLS = (
    "price_rub",
    "stars",
    "user_reviews_count",
    "rating_overall",
    "rating_location",
    "rating_cleanliness",
    "rating_food",
    "rating_service",
)

# Engineered at ingest (shared train/serve featurizer — features.py).
ENGINEERED_COLS = ("price_per_star", "cleanliness_vs_service", "location_premium")

NUMERICAL_COLS = RAW_NUMERICAL_COLS + ENGINEERED_COLS

FRIEND_COLS = ("user_id_1", "user_id_2")

REVIEWS_CSV_COLUMNS = (
    RAW_USER_COL,
    RAW_ITEM_COL,
    "city",
    "hotel_type",
    "price_rub",
    "stars",
    "user_reviews_count",
    "rating_overall",
    "rating_location",
    "rating_cleanliness",
    "rating_food",
    "rating_service",
    TARGET_COL,
)
